"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) and the
roofline's traced half (``repro_torch.roofline.analysis``), on a fake
512-rank world in subprocesses (a world is global to its process):

  * ``run_one`` on smoke configs of each step kind (train plan A and B,
    prefill, decode) on both production meshes writes a report with the
    reference's keys;
  * ``probe_costs``' linear fit equals the direct count of the full trace
    (the reference's linear model is exact for an eager trace).

The traced roofline itself and ``tune.pairs``: tests/test_torch_pairs.py.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(code, cwd, timeout=300, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(cwd))
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return out.stdout


REPORTS = r'''
import json, sys
from repro_torch.configs import registry
from repro_torch.launch import dryrun as D
out = "experiments/dryrun_torch"
runs = [("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "prefill_32k"),
        ("stablelm_1_6b", "decode_32k"), ("deepseek_v3_671b", "train_4k")]
for arch, shape in runs:
    for mesh in ("single", "multi"):
        if arch == "deepseek_v3_671b" and mesh == "multi":
            continue
        st, rep = D.run_one(arch, shape, mesh, tau=1, outdir=out,
                            cfg_override=registry.get_smoke(arch),
                            probes=False)
        assert st == "ok", (arch, shape, mesh, rep)
        print("REPORT", arch, shape, mesh, rep.flops_per_dev,
              rep.n_collectives)
'''


def test_run_one_writes_the_references_report_layout(tmp_path):
    from repro.roofline.analysis import RooflineReport

    stdout = _run(REPORTS, tmp_path)
    keys = {f.name for f in dataclasses.fields(RooflineReport)}
    files = sorted((tmp_path / "experiments" / "dryrun_torch").glob(
        "*.json"))
    assert len(files) == 7
    for f in files:
        rep = json.loads(f.read_text())
        assert keys <= set(rep), sorted(keys - set(rep))
        assert {"timing", "memory_analysis_raw"} <= set(rep)
        assert rep["n_chips"] == (512 if "_multi" in f.name else 256)
        assert rep["flops_per_dev"] > 0 and rep["bytes_per_dev"] > 0
        assert rep["dominant"] in ("compute", "memory", "collective")
        assert set(rep["memory_per_dev_gb"]) >= {"args", "out", "temp"}
    train = json.loads((tmp_path / "experiments" / "dryrun_torch" /
                        "stablelm_1_6b_train_4k_single.json").read_text())
    # the FL downlink (all-gather) and uplink (all-reduce) are in the trace
    assert {"all-gather", "all-reduce"} <= set(train["collective_breakdown"])
    assert stdout.count("REPORT") == 7


PROBES = r'''
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun as D
cfg = registry.get_smoke("stablelm_1_6b").with_overrides(n_layers=5)
for mesh_name, multi in (("multi", True),):
    mesh = D._mesh(multi)
    shape = SHAPES["train_4k"]
    direct = D._costs(D._compile(D.build_train, cfg, shape, mesh, multi,
                                 tau=3, micro=1))
    fit = D.probe_costs(cfg, shape, mesh, multi, 3, D.BUILDERS)
    assert fit == direct, (mesh_name, fit, direct)
    shape = SHAPES["prefill_32k"]
    direct = D._costs(D._compile(D.build_prefill, cfg, shape, mesh, multi))
    fit = D.probe_costs(cfg, shape, mesh, multi, 1, D.BUILDERS)
    assert fit == direct, (mesh_name, fit, direct)
print("PROBES_EXACT")
'''


def test_probe_fit_equals_the_direct_count(tmp_path):
    assert "PROBES_EXACT" in _run(PROBES, tmp_path)
