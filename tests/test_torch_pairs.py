"""The roofline's traced half (``repro_torch.roofline.analysis``) against
the reference's compiled half, and ``repro_torch.tune.pairs``:

  * a sharded matmul's per-device FLOPs equal the reference's
    ``cost_analysis_dict`` FLOPs for the same program on a forced-host
    mesh;
  * ``parse_collectives``' bytes moved equal the reference's on the same
    (op, result bytes, group size);
  * ``tune.pairs.run_pair`` on a smoke stand-in writes its variant reports
    and its table (a fake world in a subprocess: it is global to its
    process).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(code, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(cwd))
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return out.stdout


MATMUL_REF = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh_compat
from repro.roofline.analysis import cost_analysis_dict
mesh = make_mesh_compat((2, 4), ("data", "model"))
x = jax.ShapeDtypeStruct((64, 512), jnp.float32)
w = jax.ShapeDtypeStruct((512, 256), jnp.float32)
sx = NamedSharding(mesh, P("data", None))
sw = NamedSharding(mesh, P(None, "model"))
c = jax.jit(lambda a, b: a @ b, in_shardings=(sx, sw),
            out_shardings=NamedSharding(mesh, P("data", "model"))
            ).lower(x, w).compile()
print("FLOPS", int(cost_analysis_dict(c)["flops"]))
'''

MATMUL_PORT = r'''
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.roofline import analysis as roof
M.fake_world(8)
mesh = M.make_mesh((2, 4), ("data", "model"), "cpu")
with FakeTensorMode():
    x = S.place_abstract(torch.empty(64, 512), S.NamedSharding(
        mesh, S.PartitionSpec("data", None)))
    w = S.place_abstract(torch.empty(512, 256), S.NamedSharding(
        mesh, S.PartitionSpec(None, "model")))
    _, traced = roof.trace_step(lambda a, b: a @ b, x, w)
print("FLOPS", int(roof.cost_analysis_dict(traced)["flops"]))
print("COLL", len(traced.collectives))
M.close_world()
'''


def test_sharded_matmul_flops_equal_the_references(tmp_path):
    ref = _run(MATMUL_REF, tmp_path)
    port = _run(MATMUL_PORT, tmp_path)
    flops = [int(line.split()[1]) for line in (ref + port).splitlines()
             if line.startswith("FLOPS")]
    assert flops[0] == flops[1] == 2 * 32 * 512 * 64, flops
    assert "COLL 0" in port  # the placements need no communication


@pytest.mark.parametrize("op,hlo_shape,dtype_bytes,n,g", [
    ("all-gather", "bf16[1024,128]", 2, 1024 * 128, 16),
    ("all-reduce", "f32[256]", 4, 256, 4),
    ("reduce-scatter", "f32[2,64]", 4, 128, 8),
    ("all-to-all", "f32[16,8]", 4, 128, 4),
    ("collective-permute", "f32[4,4]", 4, 16, 2),
])
def test_parse_collectives_moves_the_references_bytes(op, hlo_shape,
                                                      dtype_bytes, n, g):
    from repro.roofline.analysis import parse_collectives as ref_parse

    from repro_torch.roofline.analysis import parse_collectives

    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    line = f"  %x = {hlo_shape} {op}(%y), replica_groups={groups}"
    (r_op, r_rb, r_g, r_moved), = ref_parse(line)
    (p_op, p_rb, p_g, p_moved), = parse_collectives(
        [(op, n * dtype_bytes, g)])
    assert (p_op, p_rb, p_g) == (r_op, r_rb, r_g)
    assert p_moved == r_moved


PAIRS = r'''
import pathlib
from functools import partial
from repro_torch.configs import registry
from repro_torch.launch import dryrun as dr
from repro_torch.tune import pairs
smoke = registry.get_smoke("stablelm_1_6b")
pairs.PAIRS["stand_in"] = lambda: ("stablelm_1_6b", "prefill_32k", [
    ("blocked", smoke.with_overrides(attn_impl="blocked"), None),
    ("lastonly", smoke,
     {"prefill": partial(dr.build_prefill, last_only=True)}),
])
pairs.run_pair("stand_in", outdir="out", baseline_cfg=smoke)
print("PAIR_DONE")
'''


def test_tune_pairs_writes_variant_reports_and_table(tmp_path):
    stdout = _run(PAIRS, tmp_path)
    assert "PAIR_DONE" in stdout
    for note in ("", "_blocked", "_lastonly"):
        assert (tmp_path / "out" /
                f"stablelm_1_6b_prefill_32k_single{note}.json").exists()
    table = (tmp_path / "experiments" / "perf_torch" /
             "stand_in.md").read_text()
    assert "| baseline |" in table and "| lastonly |" in table
