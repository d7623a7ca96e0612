"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points refuse to run
quietly on the CPU when the caller asked for the card.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.interop, repro_torch.fed.simulator\n"
            "import repro_torch.fed.problems, repro_torch.kernels.ops\n"
            "import repro_torch.comm, repro_torch.exec.stages\n"
            "import repro_torch.kernels.plane_ops, repro_torch.sched\n"
            "import repro_torch.exec, repro_torch.sched.cohort\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_gpu(no_gpu):
    from repro_torch import resolve_device
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.prox import L1
    from repro_torch.exec import ArraySupplier, RoundEngine
    from repro_torch.fed import problems, simulator
    from repro_torch.models import logreg

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        problems.logreg_problem(n_clients=2, m=3, d=2)
    alg = simulator.DProxAlgorithm(L1(0.1), DProxConfig(1, 0.1, 2.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoundEngine(alg, logreg.make_grad_fn(), 2)
    params0 = {"w": torch.zeros(2, dtype=torch.float64),
               "b": torch.zeros((), dtype=torch.float64)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulator.run(alg, params0, logreg.make_grad_fn(),
                      lambda r, rng: None, 2, 1)
    arrays = {"a": np.zeros((2, 3, 2)), "y": np.zeros((2, 3))}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArraySupplier(arrays, 1, None, device_cache=True)
    assert resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA card")
    out = _run_smoke(ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
