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
        # the port carries its own copies of what it needs from PyTorch's
        # test helpers (the fake process group's backend, for one)
        assert not name.startswith("torch.testing"), (path, name)


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.interop, repro_torch.fed.simulator\n"
            "import repro_torch.fed.problems, repro_torch.kernels.ops\n"
            "import repro_torch.comm, repro_torch.exec.stages\n"
            "import repro_torch.kernels.plane_ops, repro_torch.sched\n"
            "import repro_torch.exec, repro_torch.sched.cohort\n"
            "import repro_torch.serving, repro_torch.models.transformer\n"
            "import repro_torch.kernels.flash_attention, repro_torch.configs\n"
            "import repro_torch.configs.registry, repro_torch.obs\n"
            "import repro_torch.core.baselines, repro_torch.models.cnn\n"
            "import repro_torch.data.mnist_like, repro_torch.core.prox\n"
            "import repro_torch.comm.wire, repro_torch.checkpoint.ckpt\n"
            "import repro_torch.obs.report, repro_torch.obs.trace\n"
            "import repro_torch.serving.delta, repro_torch.fed.runtime\n"
            "import repro_torch.tune, repro_torch.tune.__main__\n"
            "import repro_torch.roofline.analysis\n"
            "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
            "import repro_torch.launch.dryrun, repro_torch.tune.pairs\n"
            "import repro_torch.models.moe_ep, repro_torch.models.axes\n"
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArraySupplier(arrays, 1, 2, prefetch=True)
    from repro_torch.models import cnn

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_params(0)
    from repro_torch import tune
    from repro_torch.tune import __main__ as tune_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_main.main(["--budget", "1", "--dry"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.TrialRunner(tune.Workload()).measure(tune.TrialPoint())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.tune(tune.Workload(), budget=1, save=False)
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_entry_points_raise_without_a_gpu(no_gpu):
    """Meshes and the placed engine default to the card: without one they
    raise rather than building CPU ranks or running on the CPU."""
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.prox import L1
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import simulator
    from repro_torch.launch import mesh as M
    from repro_torch.models import logreg

    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_debug_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_production_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.real_world()

    class CpuMesh:
        device_type = "cpu"

    alg = simulator.DProxAlgorithm(L1(0.1), DProxConfig(1, 0.1, 2.0))
    cfg = EngineConfig(mesh=CpuMesh(), param_specs={"w": (), "b": ()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoundEngine(alg, logreg.make_grad_fn(), 2, cfg)
    # a mesh over CPU ranks with a card-less engine device is refused too
    with pytest.raises(ValueError, match="mesh is over cpu"):
        RoundEngine(alg, logreg.make_grad_fn(), 2, cfg, device="meta")


def test_runtime_entry_points_raise_without_a_gpu(no_gpu):
    """The runtime's roles default to the card: each raises before it
    binds or connects a socket; ``device="cpu"`` is the explicit way out."""
    from repro_torch.fed import runtime

    a = runtime.RuntimeArgs(clients=2, m=3, dim=2, tau=1, rounds=1,
                            chunk=1, timeout=1.0)
    assert a.device == "cuda"
    for role in (runtime.run_local, runtime.run_server,
                 lambda a: runtime.run_worker(a, rank=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            role(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.main(["--role", "local", "--clients", "2", "--m", "3",
                      "--dim", "2", "--rounds", "1"])


def test_serving_and_attention_need_a_gpu_or_the_cpu(no_gpu):
    """The serving engine runs on the card unless ``device="cpu"`` is
    passed; flash attention runs its kernel on CUDA tensors, its plain
    version on CPU tensors (no launch) and refuses other devices."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build, ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingEngine

    cfg = registry.get_smoke("stablelm_1_6b").with_overrides(
        n_layers=1, param_dtype=torch.float32)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    eng = ServingEngine(cfg, params, max_len=16, device="cpu")
    assert eng.generate(np.zeros((1, 4), np.int32),
                        max_new_tokens=2).tokens.shape == (1, 2)
    q = torch.zeros(1, 8, 4, 64)
    before = _build.COUNTS["flash_attentions"]
    assert ops.gqa_flash_attention(q, q, q).shape == q.shape
    assert _build.COUNTS["flash_attentions"] == before
    m = q.to("meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        ops.gqa_flash_attention(m, m, m)


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
