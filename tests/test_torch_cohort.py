"""The port's cohort-resident state (repro_torch.sched.cohort + the engine's
Cohort stage) against the JAX reference (repro.sched.cohort), plus torch
twins of the contracts of tests/test_cohort.py.  CPU only.

Tolerances:
  * cohort ids: numpy draws in both packages, EQUAL;
  * population stores: gather/scatter and the npz layout round-trip
    BITWISE, in both directions between the packages;
  * ``cohort == population`` against the port's dense engine: BITWISE, per
    stage combination; flat vs edge-tree selection under uniform weights:
    BITWISE;
  * the quickstart's cohort run (population 3,000, cohort 30, top-k 25%,
    chunk 16, 200 rounds, paper problem): the float32 loss of every round
    at rtol 1e-6 (the local steps differ from XLA's by FMA contraction and
    reduction order, tests/test_torch_algorithm.py) and the store's touched
    rows EQUAL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import sched as jsched
from repro.core.algorithm import DProxConfig as JConfig
from repro.data.synthetic import make_round_batches as j_make_round_batches
from repro.exec import EngineConfig as JEngineConfig
from repro.exec import RoundEngine as JRoundEngine
from repro.fed import simulator as jsim
from repro_torch import comm, sched
from repro_torch.core.algorithm import DProxConfig
from repro_torch.core.prox import L1
from repro_torch.data.synthetic import (logistic_heterogeneous,
                                        make_round_batches)
from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
from repro_torch.fed import problems
from repro_torch.fed import simulator as tsim
from repro_torch.models import logreg
from repro_torch.utils import tree as tu

N, D = 12, 8


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _problem(n=N, m=24, d=D, seed=0):
    data = logistic_heterogeneous(n_clients=n, m_per_client=m, d=d, alpha=5,
                                  beta=5, seed=seed)
    s = np.linalg.norm(data.features.reshape(-1, d), axis=1).max()
    data.features = (data.features / s).astype(np.float64)
    data.labels = data.labels.astype(np.float64)
    return data


def _alg():
    return tsim.DProxAlgorithm(L1(lam=0.01), DProxConfig(tau=2, eta=0.05,
                                                         eta_g=2.0))


def _params0(d=D):
    return {"w": torch.zeros(d, dtype=torch.float64),
            "b": torch.zeros((), dtype=torch.float64)}


def _run(data, cfg, rounds=6, sup_seed=3):
    eng = RoundEngine(_alg(), logreg.make_grad_fn(), data.n_clients, cfg,
                      device="cpu")
    sup = ArraySupplier.from_dataset(data, tau=2, batch_size=4, seed=sup_seed)
    state, metrics = eng.run(eng.init(_params0()), sup, rounds=rounds, seed=0)
    return eng, state, metrics


def _assert_bitwise(a, b):
    la, lb = tu.tree_leaves(a), tu.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# -- CohortSpec ---------------------------------------------------------------


def test_spec_sampling_matches_reference():
    for pop, coh, seed in [(100, 16, 4), (3000, 30, 0), (9, 9, 1), (7, 1, 2)]:
        t, j = sched.CohortSpec(pop, coh, seed), jsched.CohortSpec(pop, coh,
                                                                    seed)
        assert t.is_full == j.is_full
        for r in (0, 7, 16, 512):
            a = t.sample(r)
            np.testing.assert_array_equal(a, j.sample(r))
            assert a.dtype == np.int64 and np.all(np.diff(a) > 0)
    with pytest.raises(ValueError):
        sched.CohortSpec(10, 11).validate()
    with pytest.raises(ValueError):
        sched.CohortSpec(10, 0).validate()


# -- PopulationStore ----------------------------------------------------------


def test_store_lazy_defaults_and_roundtrip():
    store = sched.PopulationStore(population=1000)
    default = {"x": np.zeros((3,), np.float64),
               "k": np.full((), -1, np.int32)}
    store.add_entry("s", default)
    assert store.touched == 0
    got = store.gather("s", np.array([5, 900]))
    np.testing.assert_array_equal(got["x"], np.zeros((2, 3)))
    np.testing.assert_array_equal(got["k"], [-1, -1])
    rows = {"x": np.arange(6.0).reshape(2, 3), "k": np.array([7, 8],
                                                             np.int32)}
    store.scatter("s", np.array([5, 900]), rows)
    assert store.touched == 2
    back = store.gather("s", np.array([900, 5, 33]))
    np.testing.assert_array_equal(back["x"][0], [3.0, 4.0, 5.0])
    np.testing.assert_array_equal(back["x"][1], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(back["x"][2], np.zeros(3))
    assert store.nbytes < 4 * 1000 + 64 * (3 * 8 + 4)
    with pytest.raises(ValueError):
        store.add_entry("s", default)


def _fill(store, cls_rows):
    store.add_entry("alg", {"c": {"w": np.zeros(3), "b": np.zeros(())}})
    store.add_entry("sched", {"last_age": np.zeros((), np.int32),
                              "need_refresh": np.ones((), bool)})
    ids = np.array([4, 17, 42])
    rng = np.random.default_rng(0)
    store.scatter("alg", ids, {"c": {"w": rng.normal(size=(3, 3)),
                                     "b": rng.normal(size=3)}})
    store.scatter("sched", ids, {"last_age": np.array([1, 2, 3], np.int32),
                                 "need_refresh": np.array([0, 1, 0], bool)})
    return ids


@pytest.mark.parametrize("direction", ["repro_to_port", "port_to_repro"])
def test_store_saved_by_one_package_loads_in_the_other(tmp_path, direction):
    src_cls, dst_cls = ((jsched.PopulationStore, sched.PopulationStore)
                        if direction == "repro_to_port" else
                        (sched.PopulationStore, jsched.PopulationStore))
    src = src_cls(population=50)
    _fill(src, None)
    p = tmp_path / "store.npz"
    src.save(p, metadata={"round": 12})
    dst = dst_cls(population=50)
    dst.add_entry("alg", {"c": {"w": np.zeros(3), "b": np.zeros(())}})
    dst.add_entry("sched", {"last_age": np.zeros((), np.int32),
                            "need_refresh": np.ones((), bool)})
    meta = dst.load(p)
    assert meta["round"] == 12 and meta["touched"] == 3
    assert dst.touched == 3
    everyone = np.arange(50)
    for name in ("alg", "sched"):
        _assert_bitwise(jax.tree_util.tree_map(np.asarray,
                                               dst.gather(name, everyone)),
                        jax.tree_util.tree_map(np.asarray,
                                               src.gather(name, everyone)))
    bad = dst_cls(population=51)
    with pytest.raises(ValueError, match="population"):
        bad.load(p)


def test_sched_client_axes_layouts():
    data = _problem()
    for q in (None, 2):
        eng, _, _ = _run(data, EngineConfig(
            chunk_rounds=2, clock=sched.StragglerClock(), buffer_size=4,
            queue_depth=q, staleness=sched.Staleness("poly", correct=True)),
            rounds=2)
        st = eng._sched_state
        axes = sched.sched_client_axes(st)
        assert set(axes) == set(st._fields)
        for f, a in axes.items():
            if a is None:
                continue
            for leaf in tu.tree_leaves(getattr(st, f)):
                assert leaf.shape[a] == N, (f, leaf.shape, a)


# -- cohort == population is the dense engine, bitwise ------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(transport="topk"),
    dict(transport="topk", plane=True),
    dict(clock=True, buffer_size=N // 2, staleness=sched.Staleness("poly")),
    dict(clock=True, buffer_size=N // 2, queue_depth=2, plane=True),
], ids=["inline", "topk", "topk_plane", "async", "queued_plane"])
def test_full_cohort_bitwise_parity(kw):
    kw = dict(kw)
    if kw.pop("transport", None):
        kw["transport"] = comm.TopK(ratio=0.3)
    if kw.pop("clock", None):
        kw["clock"] = sched.StragglerClock(slowdown=3.0)
    data = _problem()
    _, dense, m_d = _run(data, EngineConfig(chunk_rounds=2, **kw))
    eng, coh, m_c = _run(data, EngineConfig(chunk_rounds=2, population=N,
                                            cohort=N, **kw))
    _assert_bitwise(dense, coh)
    assert m_d["train_loss"] == m_c["train_loss"]
    assert eng.population_store.touched == N


def test_full_cohort_step_parity():
    data = _problem()
    sup = ArraySupplier.from_dataset(data, tau=2, batch_size=4, seed=3)
    grad = logreg.make_grad_fn()
    e_d = RoundEngine(_alg(), grad, N, EngineConfig(), device="cpu")
    e_c = RoundEngine(_alg(), grad, N, EngineConfig(cohort=N), device="cpu")
    sd, sc = e_d.init(_params0()), e_c.init(_params0())
    for r in range(3):
        b = sup.sample_round(r)
        sd, _ = e_d.step(sd, b)
        sc, _ = e_c.step(sc, b)
    _assert_bitwise(sd, sc)


def test_edges_bitwise_parity_uniform_weights_and_same_set():
    data = _problem()
    kw = dict(chunk_rounds=2, clock=sched.StragglerClock(slowdown=3.0),
              buffer_size=4)
    _, flat, m_f = _run(data, EngineConfig(**kw))
    _, tree, m_t = _run(data, EngineConfig(edges=3, **kw))
    _assert_bitwise(flat, tree)
    assert m_f["staleness_mean"] == m_t["staleness_mean"]
    _, flat, _ = _run(data, EngineConfig(staleness="poly", **kw))
    _, tree, _ = _run(data, EngineConfig(staleness="poly", edges=3, **kw))
    for x, y in zip(tu.tree_leaves(flat), tu.tree_leaves(tree)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-12,
                                   atol=1e-12)


# -- strict sub-cohorts -------------------------------------------------------


def test_sub_cohort_trains_and_bounds_store():
    data = _problem()
    eng, state, metrics = _run(
        data, EngineConfig(chunk_rounds=2, transport=comm.TopK(ratio=0.3),
                           population=N, cohort=4), rounds=6)
    assert eng.n_clients == 4 and eng.population == N
    assert np.all(np.isfinite(metrics["train_loss"]))
    store = eng.population_store
    assert 4 <= store.touched <= min(N, 3 * 4)
    assert set(store.entry_names) >= {"alg", "comm"}
    assert len(eng.cohort_ids) == 4
    sup = ArraySupplier.from_dataset(data, tau=2, batch_size=4, seed=3)
    eng.run(state, sup, rounds=4, seed=0, start_round=6)
    assert store.touched >= 4


def test_sub_cohort_async_carries_report_state():
    data = _problem()
    eng, _, metrics = _run(
        data, EngineConfig(chunk_rounds=2,
                           clock=sched.StragglerClock(slowdown=3.0),
                           buffer_size=3, population=N, cohort=6, edges=2,
                           plane=True), rounds=4)
    assert "sched" in eng.population_store.entry_names
    assert np.all(np.isfinite(metrics["train_loss"]))


def test_sub_cohort_step_uses_announced_ids():
    data = _problem()
    sup = ArraySupplier.from_dataset(data, tau=2, batch_size=4, seed=3)
    eng = RoundEngine(_alg(), logreg.make_grad_fn(), N,
                      EngineConfig(population=N, cohort=4), device="cpu")
    state = eng.init(_params0())
    for r in range(3):
        ids = eng.cohort_ids
        assert ids is not None and len(ids) == 4
        state, _ = eng.step(state, sup.sample_round(r, client_ids=ids))
    eng.flush_cohort(state)
    assert eng.population_store.touched == 4


def test_sub_cohort_requires_client_ids_supplier():
    data = _problem()
    sup = ArraySupplier.from_dataset(data, tau=2, batch_size=4, seed=3)
    cache = [sup.sample_round(r) for r in range(2)]
    eng = RoundEngine(_alg(), logreg.make_grad_fn(), N,
                      EngineConfig(chunk_rounds=2, cohort=4), device="cpu")
    with pytest.raises(ValueError, match="client_ids"):
        eng.run(eng.init(_params0()), lambda r, rng: cache[r % 2], rounds=2,
                seed=0)


def test_array_supplier_client_ids_match_reference():
    from repro.exec import ArraySupplier as JArraySupplier

    data = _problem()
    ids = np.array([1, 5, 11])
    for bs in (4, None):
        t = ArraySupplier.from_dataset(data, tau=2, batch_size=bs, seed=3)
        j = JArraySupplier.from_dataset(data, tau=2, batch_size=bs, seed=3)
        for got, exp in ((t.sample_round(2, client_ids=ids),
                          j.sample_round(2, client_ids=ids)),
                         (t.sample_chunk(2, 3, client_ids=ids),
                          j.sample_chunk(2, 3, client_ids=ids))):
            for k in ("a", "y"):
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(exp[k]))


def test_engine_store_checkpoint_roundtrip(tmp_path):
    data = _problem()
    cfg = EngineConfig(chunk_rounds=2, population=N, cohort=4)
    eng, _, _ = _run(data, cfg, rounds=6)
    p = tmp_path / "store.npz"
    eng.population_store.save(p, metadata={"round": 6})
    other, _, _ = _run(data, cfg, rounds=2)
    assert other.population_store.load(p)["round"] == 6
    ids = np.arange(N)
    for name in eng.population_store.entry_names:
        _assert_bitwise(eng.population_store.gather(name, ids),
                        other.population_store.gather(name, ids))


# -- validation ---------------------------------------------------------------


def test_cohort_config_validation_matches_reference():
    for kw, n in [(dict(population=10, cohort=20), None),
                  (dict(population=10, participation=0.5), None),
                  (dict(buffer_size=N + 5), N),
                  (dict(buffer_size=4, edges=5), N),
                  (dict(population=N, cohort=4, buffer_size=6,
                        clock="straggler"), N)]:
        with pytest.raises(ValueError) as je:
            JEngineConfig(**kw).validate(n)
        with pytest.raises(ValueError) as te:
            EngineConfig(**kw).validate(n)
        assert str(te.value).split(":")[0] == str(je.value).split(":")[0]
    with pytest.raises(ValueError, match="population"):
        RoundEngine(_alg(), logreg.make_grad_fn(), N,
                    EngineConfig(population=N + 1, cohort=2), device="cpu")
    assert EngineConfig(cohort=3).resolve().names() == ("cohort",)


# -- the quickstart's cohort run against the reference ------------------------


def test_quickstart_cohort_run_matches_reference():
    """``examples/quickstart.py:212-228``: DProx over a 3,000-client
    population, 30 resident, top-k 25% uplink, global client g trains on
    data stream g mod 30."""
    from benchmarks.common import logreg_problem as j_logreg_problem

    tau, rounds, population, cohort = 10, 200, 3000, 30
    data, reg, grad_fn, full_g, params0, L = j_logreg_problem()
    eta_g, eta_tilde = 15.0, 0.5 / L
    kw = dict(tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g)
    td, treg, tgrad, tfull, tp0, tL = problems.logreg_problem(device="cpu")

    def batches(mk, d):
        def fn(r, rng, *, client_ids=None):
            ids = (np.arange(population) if client_ids is None
                   else np.asarray(client_ids))
            full = mk(d, tau, None, rng)
            return {k: np.asarray(v)[ids % 30] for k, v in full.items()}
        return fn

    jalg = jsim.DProxAlgorithm(reg, JConfig(**kw))
    jeng = JRoundEngine(jalg, grad_fn, population, JEngineConfig(
        chunk_rounds=16, population=population, cohort=cohort,
        transport=jcomm.TopK(ratio=0.25)))
    js, jm = jeng.run(jeng.init(params0), batches(j_make_round_batches, data),
                      rounds, seed=0)
    talg = tsim.DProxAlgorithm(treg, DProxConfig(**kw))
    teng = RoundEngine(talg, tgrad, population, EngineConfig(
        chunk_rounds=16, population=population, cohort=cohort,
        transport=comm.TopK(ratio=0.25)), device="cpu")
    ts, tm = teng.run(teng.init(tp0), batches(make_round_batches, td),
                      rounds, seed=0)
    np.testing.assert_allclose(tm["train_loss"], jm["train_loss"], rtol=1e-6)
    assert teng.population_store.touched == jeng.population_store.touched
    assert teng.population_store.touched > cohort
    np.testing.assert_array_equal(teng.cohort_ids, jeng.cohort_ids)
    ids = np.asarray(teng.cohort_ids)
    t_rows = teng.population_store.gather("alg", ids)["c"]
    j_rows = jeng.population_store.gather("alg", ids)["c"]
    for k in ("w", "b"):
        np.testing.assert_allclose(t_rows[k], np.asarray(j_rows[k]),
                                   rtol=1e-6, atol=1e-9)
