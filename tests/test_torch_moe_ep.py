"""The port's expert-parallel MoE (explicit all-to-alls) on several ``gloo``
ranks against the REFERENCE's dense ``moe`` on the same weights, at
tests/test_moe_ep.py's config (E 8, top-2, d 16, T 64, lossless capacity)
and tolerance (1e-4 on out and aux); ``CommDebugMode`` sees two
all-to-alls a call and no all-gather.  The ranks live in a subprocess that
spawns them (a process group is global to its process).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

RANKS = r'''
import socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def body(rank, world, port, inp, out, shape, axes, token_axes):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.tensor.debug import CommDebugMode
        from repro_torch.launch import mesh as M
        from repro_torch.models.layers import MoECfg
        from repro_torch.models.moe_ep import moe_expert_parallel

        mesh = M.make_mesh(shape, axes, "cpu")
        z = np.load(inp)
        cfg = MoECfg(num_experts=8, top_k=2, d_ff_expert=32,
                     capacity_factor=8.0 / 2 + 0.5)  # lossless
        p = {k: torch.from_numpy(z[k]) for k in
             ("router", "w_gate", "w_up", "w_down")}
        x = torch.from_numpy(z["x"])
        comm = CommDebugMode()
        with comm:
            y, aux = moe_expert_parallel(p, cfg, x, mesh, act="swiglu",
                                         token_axes=token_axes)
        counts = {str(k).split(".")[-1]: v
                  for k, v in comm.get_comm_counts().items()}
        full = y.full_tensor()
        if rank == 0:
            np.savez(out, out=full.numpy(), aux=float(aux),
                     a2a=counts.get("all_to_all_single", 0),
                     ag=counts.get("all_gather_into_tensor", 0))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    shape = tuple(int(s) for s in sys.argv[3].split(","))
    axes = tuple(sys.argv[4].split(","))
    token_axes = tuple(sys.argv[5].split(","))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    world = int(np.prod(shape))
    mp.spawn(body, args=(world, port, sys.argv[1], sys.argv[2], shape, axes,
                         token_axes), nprocs=world)
    print("MOE_EP_RANKS_OK")
'''


def _reference():
    """The reference test's weights, tokens and dense output."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import MoECfg, init_moe, moe

    cfg = MoECfg(num_experts=8, top_k=2, d_ff_expert=32,
                 capacity_factor=8.0 / 2 + 0.5)
    d, T = 16, 64
    p, _ = init_moe(jax.random.PRNGKey(0), cfg, d, jnp.float32)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(T, d)) * 0.5, jnp.float32)
    ref, aux_ref = moe(p, cfg, x[None], act="swiglu")
    arrays = {k: np.asarray(v) for k, v in p.items()}
    arrays["x"] = np.asarray(x)
    return arrays, np.asarray(ref[0]), float(aux_ref)


@pytest.mark.parametrize("shape,axes,token_axes", [
    ("4", "model", "model"),
    ("2,4", "data,model", "data,model"),
], ids=["4_ranks", "8_ranks_data_model"])
def test_expert_parallel_matches_the_reference_dense_moe(tmp_path, shape,
                                                         axes, token_axes):
    arrays, ref, aux_ref = _reference()
    inp = tmp_path / "in.npz"
    np.savez(inp, **arrays)
    script = tmp_path / "ranks.py"
    script.write_text(RANKS)
    out = tmp_path / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, str(script), str(inp), str(out), shape, axes,
         token_axes], env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "MOE_EP_RANKS_OK" in run.stdout
    got = np.load(out)
    err = float(np.abs(got["out"] - ref).max())
    assert err < 1e-4, err
    assert abs(float(got["aux"]) - aux_ref) < 1e-4
    # the explicit round trip, and no activation replicated
    assert int(got["a2a"]) == 2
    assert int(got["ag"]) == 0


def test_one_rank_expert_parallel_is_the_dense_layer():
    """On one rank the send buffer is the dense dispatch's (E, C, d), so
    the expert-parallel layer is :func:`repro_torch.models.layers.moe`'s
    arithmetic: bitwise at lossless capacity."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.models.layers import MoECfg, init_moe, moe
    from repro_torch.models.moe_ep import moe_expert_parallel

    cfg = MoECfg(num_experts=8, top_k=2, d_ff_expert=32,
                 capacity_factor=8.0 / 2 + 0.5)
    p = init_moe(torch.Generator().manual_seed(0), cfg, 16, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 16))
                         .astype(np.float32) * 0.5)
    ref, aux_ref = moe(p, cfg, x[None])
    M.real_world("cpu")
    try:
        mesh = M.make_mesh((1,), ("model",), "cpu")
        out, aux = moe_expert_parallel(p, cfg, x, mesh)
        assert torch.equal(out.full_tensor(), ref[0])
        assert torch.equal(aux, aux_ref)
    finally:
        dist.destroy_process_group()
