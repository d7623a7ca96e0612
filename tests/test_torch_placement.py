"""The port's placement stage (``EngineConfig(mesh=...)``) against the
unplaced engine and against the JAX reference's inline engine.

  * one ``gloo`` rank on a (1, 1) CPU mesh: every algorithm of
    tests/test_exec.py placed equals inline at that file's rtol 1e-12 /
    atol 1e-14 (the placed round is the inline one's arithmetic, so it is
    bitwise in fact), with the state held as DTensors;
  * four ``gloo`` ranks (a subprocess spawning them) on a (2, 2) mesh:
    x_bar within 1e-12 of the REFERENCE's inline engine on
    tests/test_exec.py's multi-device data, seed and param_specs; and a
    placed global top-k + asynchrony run on the plane bitwise the unplaced
    one.

A process group is global to its process: the one-rank group is opened
and destroyed inside one module fixture, the multi-rank runs live in
their own processes.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PSPECS = {"w": ("mlp",), "b": ()}


@pytest.fixture(scope="module")
def cpu_mesh():
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    M.real_world("cpu")
    try:
        yield M.make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(n=6, m=30, d=10, seed=9, lam=0.01):
    """tests/test_exec.py's ``_problem`` in the port's terms."""
    from repro_torch.core.prox import L1
    from repro_torch.data.synthetic import logistic_heterogeneous
    from repro_torch.models import logreg

    data = logistic_heterogeneous(n_clients=n, m_per_client=m, d=d, alpha=5,
                                  beta=5, seed=seed)
    s = np.linalg.norm(data.features.reshape(-1, d), axis=1).max()
    data.features = (data.features / s).astype(np.float64)
    data.labels = data.labels.astype(np.float64)
    params0 = {"w": torch.zeros(d, dtype=torch.float64),
               "b": torch.zeros((), dtype=torch.float64)}
    return data, L1(lam=lam), logreg.make_grad_fn(), params0


def _supplier(data, tau, batch):
    from repro_torch.data.synthetic import make_round_batches

    return lambda r, rng: make_round_batches(
        data, tau, batch, np.random.default_rng(10_000 + r))


def _algorithms():
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.baselines import (FastFedDA, FedAvg, FedDA, FedMid,
                                            FedProx, Scaffold)
    from repro_torch.fed.simulator import DProxAlgorithm

    return {
        "dprox": lambda reg: DProxAlgorithm(reg, DProxConfig(3, 0.05, 2.0)),
        "fedavg": lambda reg: FedAvg(tau=3, eta=0.05),
        "fedmid": lambda reg: FedMid(reg, tau=3, eta=0.05),
        "fedda": lambda reg: FedDA(reg, tau=3, eta=0.05, eta_g=2.0),
        "fast_fedda": lambda reg: FastFedDA(reg, tau=3, eta0=0.05),
        "scaffold": lambda reg: Scaffold(reg, tau=3, eta=0.05),
        "fedprox": lambda reg: FedProx(reg, tau=3, eta=0.05),
    }


@pytest.mark.parametrize("name", ["dprox", "fedavg", "fedmid", "fedda",
                                  "fast_fedda", "scaffold", "fedprox"])
def test_all_algorithms_placed_match_inline_one_rank(cpu_mesh, name):
    from torch.distributed.tensor import DTensor

    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.utils import tree as tu

    data, reg, grad_fn, params0 = _problem()
    supplier = _supplier(data, 3, 8)
    alg = _algorithms()[name](reg)
    e_in = RoundEngine(alg, grad_fn, data.n_clients,
                       EngineConfig(chunk_rounds=3), device="cpu")
    s_in, m_in = e_in.run(e_in.init(params0), supplier, 6, seed=0)
    e_pl = RoundEngine(alg, grad_fn, data.n_clients,
                       EngineConfig(chunk_rounds=3, mesh=cpu_mesh,
                                    param_specs=PSPECS, plan="A"),
                       device="cpu")
    assert e_pl.stack.names() == ("placement",)
    s_pl, m_pl = e_pl.run(e_pl.init(params0), supplier, 6, seed=0)
    assert all(isinstance(x, DTensor) for x in tu.tree_leaves(s_pl))
    for a, b in zip(tu.tree_leaves(e_in.global_params(s_in)),
                    tu.tree_leaves(e_pl.global_params(s_pl))):
        assert not isinstance(b, DTensor)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-14)
    assert m_pl["train_loss"] == m_in["train_loss"]
    assert len(m_pl["train_loss"]) == 6


def test_placed_stages_compose_one_rank(cpu_mesh):
    """Placement under the uplink, downlink and asynchrony stages on the
    plane: the same trajectory as unplaced, bitwise, with the stages'
    state held placed between rounds."""
    from torch.distributed.tensor import DTensor

    from repro_torch.comm import TopK
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.sched import StragglerClock
    from repro_torch.utils import tree as tu

    data, reg, grad_fn, params0 = _problem()
    supplier = _supplier(data, 3, 8)
    alg = _algorithms()["dprox"](reg)
    for kw in (dict(plane=True, transport=TopK(0.25, granularity="global")),
               dict(plane=True, transport=TopK(0.25, granularity="global"),
                    clock=StragglerClock(slowdown=4.0), buffer_size=3),
               dict(transport=TopK(0.5), downlink=TopK(0.5))):
        e_in = RoundEngine(alg, grad_fn, 6, EngineConfig(chunk_rounds=2,
                                                         **kw), device="cpu")
        s_in, m_in = e_in.run(e_in.init(params0), supplier, 4, seed=0)
        e_pl = RoundEngine(alg, grad_fn, 6, EngineConfig(
            chunk_rounds=2, mesh=cpu_mesh, param_specs=PSPECS, **kw),
            device="cpu")
        s_pl, m_pl = e_pl.run(e_pl.init(params0), supplier, 4, seed=0)
        assert e_pl.stack.names()[0] == "placement"
        for a, b in zip(tu.tree_leaves(s_in),
                        tu.tree_leaves(_gathered(s_pl))):
            assert torch.equal(a, b)
        assert m_pl.keys() == m_in.keys()
        for k in m_in:
            np.testing.assert_array_equal(np.asarray(m_pl[k]),
                                          np.asarray(m_in[k]))
        assert all(isinstance(x, DTensor)
                   for x in tu.tree_leaves(e_pl._extras["comm"]))


def _gathered(state):
    from repro_torch.launch import sharding as shd

    return shd.gather_tree(state)


def test_placement_config_validation(cpu_mesh):
    from repro_torch.comm import TopK
    from repro_torch.exec import EngineConfig, RoundEngine

    with pytest.raises(ValueError, match="param_specs"):
        EngineConfig(mesh=cpu_mesh).resolve()
    with pytest.raises(ValueError, match="placement"):
        EngineConfig(mesh=cpu_mesh, param_specs=PSPECS, cohort=2).resolve()
    with pytest.raises(ValueError, match="protocol"):
        EngineConfig(mesh=cpu_mesh, param_specs=PSPECS,
                     protocol=True).resolve()
    data, reg, grad_fn, params0 = _problem()
    eng = RoundEngine(_algorithms()["dprox"](reg), grad_fn, 6,
                      EngineConfig(mesh=cpu_mesh, param_specs=PSPECS,
                                   transport=TopK(0.5)), device="cpu")
    with pytest.raises(ValueError, match="placement"):
        eng.set_uplink_sink(lambda *a: None)


MULTI_RANK = r'''
import os, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def body(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.comm import TopK
        from repro_torch.core.algorithm import DProxConfig
        from repro_torch.core.prox import L1
        from repro_torch.data.synthetic import (logistic_heterogeneous,
                                                make_round_batches)
        from repro_torch.exec import EngineConfig, RoundEngine
        from repro_torch.fed.simulator import DProxAlgorithm
        from repro_torch.launch import mesh as M
        from repro_torch.launch import sharding as shd
        from repro_torch.models import logreg
        from repro_torch.sched import StragglerClock
        from repro_torch.utils import tree as tu

        data = logistic_heterogeneous(n_clients=8, m_per_client=30, d=10,
                                      alpha=5, beta=5, seed=0)
        data.features = data.features.astype(np.float64)
        data.labels = data.labels.astype(np.float64)
        reg = L1(lam=0.01)
        grad_fn = logreg.make_grad_fn()
        params0 = {"w": torch.zeros(10, dtype=torch.float64),
                   "b": torch.zeros((), dtype=torch.float64)}
        alg = DProxAlgorithm(reg, DProxConfig(tau=3, eta=0.02, eta_g=2.0))
        sup = lambda r, rng: make_round_batches(
            data, 3, 8, np.random.default_rng(10_000 + r))
        mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
        pspecs = {"w": ("mlp",), "b": ()}
        eng = RoundEngine(alg, grad_fn, 8, EngineConfig(
            chunk_rounds=2, mesh=mesh, param_specs=pspecs, plan="A"),
            device="cpu")
        st = eng.init(params0)
        # c: clients over 'data', w's mlp dim over 'model'
        assert tuple(st.c["w"].placements) == (Shard(0), Shard(1))
        assert tuple(st.c["w"].to_local().shape) == (4, 5)
        st, _ = eng.run(st, sup, 6, seed=0)
        xbar = st.x_bar["w"].full_tensor().numpy()

        kw = dict(plane=True, transport=TopK(0.25, granularity="global"),
                  clock=StragglerClock(slowdown=4.0), buffer_size=4)
        e_in = RoundEngine(alg, grad_fn, 8, EngineConfig(chunk_rounds=2,
                                                         **kw), device="cpu")
        s_in, m_in = e_in.run(e_in.init(params0), sup, 4, seed=0)
        e_pl = RoundEngine(alg, grad_fn, 8, EngineConfig(
            chunk_rounds=2, mesh=mesh, param_specs=pspecs, **kw),
            device="cpu")
        s_pl, m_pl = e_pl.run(e_pl.init(params0), sup, 4, seed=0)
        same = all(torch.equal(a, b) for a, b in zip(
            tu.tree_leaves(s_in), tu.tree_leaves(shd.gather_tree(s_pl))))
        comm = e_pl._extras["comm"]
        assert comm.placements[0] == Shard(0)
        # the plane kernels' boundary (their plain versions here): rows
        # divided over 'data', each rank on its rows, kernel 4's partial
        # sums all-reduced
        from repro_torch.kernels import plane_ops
        g = torch.Generator().manual_seed(3)
        plane = torch.randn(8, 16, generator=g, dtype=torch.float64)
        thr = plane.abs().median(dim=1).values
        u = torch.rand(8, 16, generator=g, dtype=torch.float64)
        w = torch.rand(8, generator=g, dtype=torch.float64)
        rows = shd.NamedSharding(mesh, shd.PartitionSpec("data", None))
        rows1 = shd.NamedSharding(mesh, shd.PartitionSpec("data"))
        pp, pu = shd.place(plane, rows), shd.place(u, rows)
        pt, pw = shd.place(thr, rows1), shd.place(w, rows1)
        kernels_ok = (
            torch.equal(plane_ops.threshold_select_2d(pp, pt).full_tensor(),
                        plane_ops.threshold_select_2d(plane, thr))
            and torch.equal(plane_ops.quantize_2d(
                pp, pu, shd.place(plane.abs().amax(1), rows1),
                255).full_tensor(),
                plane_ops.quantize_2d(plane, u, plane.abs().amax(1), 255))
            and torch.allclose(plane_ops.weighted_commit_2d(
                pp, pw).full_tensor(), plane_ops.weighted_commit_2d(
                plane, w), rtol=1e-14, atol=1e-14))
        if rank == 0:
            np.savez(out, xbar=xbar, async_same=same, kernels_ok=kernels_ok,
                     loss_same=(m_pl["train_loss"] == m_in["train_loss"]))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(body, args=(4, port, sys.argv[1]), nprocs=4)
    print("PLACED_RANKS_OK")
'''


def _reference_inline_xbar():
    """tests/test_exec.py's multi-device script, inline engine only."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.core.algorithm import DProxConfig
    from repro.core.prox import L1
    from repro.data.synthetic import (logistic_heterogeneous,
                                      make_round_batches)
    from repro.exec import EngineConfig, RoundEngine
    from repro.fed.simulator import DProxAlgorithm
    from repro.models import logreg

    data = logistic_heterogeneous(n_clients=8, m_per_client=30, d=10,
                                  alpha=5, beta=5, seed=0)
    data.features = data.features.astype(np.float64)
    data.labels = data.labels.astype(np.float64)
    alg = DProxAlgorithm(L1(lam=0.01), DProxConfig(tau=3, eta=0.02,
                                                   eta_g=2.0))
    sup = lambda r, rng: make_round_batches(  # noqa: E731
        data, 3, 8, np.random.default_rng(10_000 + r))
    params0 = {"w": jnp.zeros(10, jnp.float64),
               "b": jnp.zeros((), jnp.float64)}
    inline = RoundEngine(alg, logreg.make_grad_fn(), 8,
                         EngineConfig(chunk_rounds=2))
    s_in, _ = inline.run(inline.init(params0), sup, 6, seed=0)
    return np.asarray(s_in.x_bar["w"])


def test_four_gloo_ranks_match_the_reference_inline_engine(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(MULTI_RANK)
    out = tmp_path / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(script), str(out)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "PLACED_RANKS_OK" in run.stdout
    got = np.load(out)
    ref = _reference_inline_xbar()
    diff = float(np.abs(got["xbar"] - ref).max())
    assert diff < 1e-12, diff
    assert bool(got["async_same"]) and bool(got["loss_same"])
    assert bool(got["kernels_ok"])
