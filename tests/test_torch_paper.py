"""The rest of the paper's experiment stack in the port against the JAX
reference: the Fig. 4 CNN (repro_torch.models.cnn), the procedural MNIST
split (repro_torch.data.mnist_like), Fig. 4's rounds through the simulator,
the protocol form of Algorithm 1 and the engine's ``protocol=True`` checks,
the remaining regularizers, and ``ArraySupplier(prefetch=True)``.  CPU only.

Tolerances:
  * the MNIST-like arrays and the split: bitwise (the same numpy code);
  * the CNN's logits and gradients, float32: rtol 1e-4, atol 1e-6 (the two
    libraries' convolutions and matmuls sum in different orders);
  * two Fig. 4 rounds (10 clients, tau 2, float32): max |dx| / max |x| over
    every leaf of x_bar <= 1e-4, the test accuracies at each eval within
    one image (a logit tie may break either way at float32 rounding);
  * the protocol form against the compact form: x_bar at rtol 1e-12, c at
    rtol 1e-10 (tests/test_exec.py:115), and against the reference's
    protocol form at rtol 1e-10 (tests/test_torch_algorithm.py);
  * the regularizers: the float64 ones (ElasticNet, LinfBall) at rtol
    1e-12; GroupL2 and Nuclear compute in float32 (the SVD too), rtol 1e-5,
    atol 1e-6;
  * prefetched chunks and the runs fed by them: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import prox as jprox
from repro.core.algorithm import DProxConfig as JConfig
from repro.core.baselines import FedDA as JFedDA
from repro.data import mnist_like as jmnist
from repro.data.synthetic import logistic_heterogeneous
from repro.exec import EngineConfig as JEngineConfig
from repro.exec import RoundEngine as JRoundEngine
from repro.fed import simulator as jsim
from repro.models import cnn as jcnn
from repro.models import logreg as jlogreg
from repro_torch import comm, interop
from repro_torch.core import prox as tprox
from repro_torch.core.algorithm import DProxConfig
from repro_torch.core.baselines import FedDA
from repro_torch.data import mnist_like
from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
from repro_torch.fed import simulator as tsim
from repro_torch.models import cnn, logreg
from repro_torch.utils import tree as tu


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def x32():
    """The reference in float32 whatever another test module set."""
    with jax.enable_x64(False):
        yield


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def jp0():
    """The reference's Fig. 4 params0 (float32), made once for the module."""
    with jax.enable_x64(False):
        return {k: np.asarray(v) for k, v in
                jax.jit(jcnn.init_params)(jax.random.PRNGKey(0)).items()}


def _rel_gap(got: dict, exp: dict) -> float:
    """max |got - exp| / max |exp| over every leaf."""
    num = max(float(np.max(np.abs(got[k].detach().cpu().numpy()
                                  - np.asarray(exp[k])))) for k in exp)
    den = max(float(np.max(np.abs(np.asarray(exp[k])))) for k in exp)
    return num / den


# ---------------------------------------------------------------------------
# the CNN and its data
# ---------------------------------------------------------------------------


def test_cnn_parameter_count_and_layout_are_the_references(jp0):
    """Section 4.2: d = 112,394; the reference's names and shapes, and the
    sorted-key leaf order (the fused kernel's leaf order)."""
    p = cnn.init_params(0, device="cpu")
    jp = jp0
    assert sum(int(v.numel()) for v in p.values()) == 112_394
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert [tuple(x.shape) for x in tu.tree_leaves(p)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)]
    assert all(v.dtype == torch.float32 for v in p.values())
    again = cnn.init_params(0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("seed", [0, 5])
def test_mnist_like_and_split_equal_the_reference_bitwise(seed):
    got = mnist_like.generate(n_train=300, n_test=60, seed=seed)
    exp = jmnist.generate(n_train=300, n_test=60, seed=seed)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    data = mnist_like.heterogeneous_split(*got, n_clients=10, seed=seed)
    jdata = jmnist.heterogeneous_split(*exp, n_clients=10, seed=seed)
    assert data.n_clients == jdata.n_clients == 10
    for a, b in zip(data.client_x + data.client_y,
                    jdata.client_x + jdata.client_y):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got_b = mnist_like.sample_round_batches(data, 3, 4,
                                            np.random.default_rng(seed))
    exp_b = jmnist.sample_round_batches(jdata, 3, 4,
                                        np.random.default_rng(seed))
    for k in ("x", "y"):
        assert got_b[k].dtype == exp_b[k].dtype
        assert np.array_equal(got_b[k], exp_b[k])


def _small_fig4(n_train=400, n_test=100):
    tx, ty, sx, sy = mnist_like.generate(n_train=n_train, n_test=n_test,
                                         seed=0)
    return mnist_like.heterogeneous_split(tx, ty, sx, sy, n_clients=10)


def test_cnn_forward_and_gradient_match_reference(x32, jp0):
    """The reference's params0 fed in through numpy; an NCHW flatten before
    fc1 would scramble fc1_w's rows and fail here."""
    jp = {k: jnp.asarray(v) for k, v in jp0.items()}
    p = interop.params_to_torch(jp0, "cpu")
    data = _small_fig4(200, 20)
    batch = {"x": data.client_x[3][:8], "y": data.client_y[3][:8]}
    np.testing.assert_allclose(
        cnn.forward(p, torch.from_numpy(batch["x"])).numpy(),
        np.asarray(jcnn.forward(jp, jnp.asarray(batch["x"]))),
        rtol=1e-4, atol=1e-6)
    loss, grads = cnn.make_grad_fn()(p, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    jloss, jgrads = jcnn.make_grad_fn()(jp, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in jgrads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert abs(cnn.accuracy(p, data.test_x, data.test_y) - jcnn.accuracy(
        jp, jnp.asarray(data.test_x), jnp.asarray(data.test_y))) <= (
            1 / len(data.test_y))


@pytest.mark.parametrize("name", ["dprox", "fedda"])
def test_fig4_rounds_match_reference(x32, jp0, name):
    """Two Fig. 4 rounds (the reduced set-up of
    tests/test_paper_experiments.py:43: L1 1e-4, eta 0.005, eta_g 1.5,
    b 10) at tau 2, 10 clients, through both simulators with Fig. 4's
    ``test_acc`` eval at every round."""
    tau, b, rounds = 2, 10, 2
    data = _small_fig4()
    p0 = interop.params_to_torch(jp0, "cpu")
    jp0 = {k: jnp.asarray(v) for k, v in jp0.items()}
    if name == "dprox":
        jalg = jsim.DProxAlgorithm(jprox.L1(1e-4), JConfig(tau, 0.005, 1.5))
        alg = tsim.DProxAlgorithm(tprox.L1(1e-4), DProxConfig(tau, 0.005,
                                                              1.5))
    else:
        jalg = JFedDA(jprox.L1(1e-4), tau, 0.005, 1.5)
        alg = FedDA(tprox.L1(1e-4), tau, 0.005, 1.5)
    sup = lambda r, rng: mnist_like.sample_round_batches(data, tau, b, rng)
    tx, ty = jnp.asarray(data.test_x), jnp.asarray(data.test_y)
    h = jsim.run(jalg, jp0, jcnn.make_grad_fn(), sup, 10, rounds,
                 eval_fn=lambda p: {"test_acc": jcnn.accuracy(p, tx, ty)},
                 eval_every=1)
    t = tsim.run(alg, p0, cnn.make_grad_fn(), sup, 10, rounds,
                 eval_fn=lambda p: {"test_acc": cnn.accuracy(
                     p, data.test_x, data.test_y)},
                 eval_every=1, device="cpu")
    assert len(t.extra["test_acc"]) == len(h.extra["test_acc"]) == rounds + 1
    np.testing.assert_allclose(t.extra["test_acc"], h.extra["test_acc"],
                               rtol=0, atol=1 / len(data.test_y))
    np.testing.assert_allclose(t.loss, h.loss, rtol=1e-4)
    gap = _rel_gap(t.extra["final_params"],
                   {k: np.asarray(v) for k, v in
                    h.extra["final_params"].items()})
    assert gap <= 1e-4, gap


# ---------------------------------------------------------------------------
# the protocol form
# ---------------------------------------------------------------------------


def _logreg(seed=1, n=6, m=30, d=10):
    data = logistic_heterogeneous(n_clients=n, m_per_client=m, d=d, alpha=5,
                                  beta=5, seed=seed)
    s = np.linalg.norm(data.features.reshape(-1, d), axis=1).max()
    data.features = (data.features / s).astype(np.float64)
    data.labels = data.labels.astype(np.float64)
    return data, {"w": np.zeros(d), "b": np.float64(0.0)}


def test_protocol_form_equals_compact_form_and_reference(x64):
    """The twin of tests/test_exec.py:115 (engine ``protocol=True`` against
    the chunked compact form), and the port's protocol round against the
    reference's."""
    data, p0 = _logreg()
    sup = ArraySupplier.from_dataset(data, 4, 8, seed=2)
    alg = tsim.DProxAlgorithm(tprox.L1(0.01), DProxConfig(4, 0.05, 2.0))
    params0 = interop.params_to_torch(p0, "cpu")
    out = {}
    for key, cfg in (("compact", EngineConfig(chunk_rounds=2)),
                     ("protocol", EngineConfig(protocol=True))):
        eng = RoundEngine(alg, logreg.make_grad_fn(), 6, cfg, device="cpu")
        assert eng.stack.names() == (("protocol",) if key == "protocol"
                                     else ())
        out[key], _ = eng.run(eng.init(params0), sup, 4, seed=0)
    for k in ("w", "b"):
        np.testing.assert_allclose(out["compact"].x_bar[k].numpy(),
                                   out["protocol"].x_bar[k].numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["compact"].c[k].numpy(),
                                   out["protocol"].c[k].numpy(),
                                   rtol=1e-10, atol=1e-12)
    jalg = jsim.DProxAlgorithm(jprox.L1(0.01), JConfig(4, 0.05, 2.0))
    jeng = JRoundEngine(jalg, jlogreg.make_grad_fn(), 6,
                        JEngineConfig(protocol=True))
    js, _ = jeng.run(jeng.init({k: jnp.asarray(v) for k, v in p0.items()}),
                     lambda r, rng: sup.sample_round(r), 4, seed=0)
    for k in ("w", "b"):
        np.testing.assert_allclose(out["protocol"].x_bar[k].numpy(),
                                   np.asarray(js.x_bar[k]), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(out["protocol"].c[k].numpy(),
                                   np.asarray(js.c[k]), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("kw,match", [
    (lambda c: {"participation": 0.5}, "partial participation"),
    (lambda c: {"plane": True}, "plane mode does not apply"),
    (lambda c: {"transport": c.TopK(ratio=0.5)}, "composes with no stages"),
    (lambda c: {"downlink": c.Dense()}, "composes with no stages"),
    (lambda c: {"buffer_size": 2}, "composes with no stages"),
    (lambda c: {"cohort": 3}, "does not apply to the protocol mode"),
], ids=["participation", "plane", "transport", "downlink", "async",
        "cohort"])
def test_protocol_config_checks_raise_as_the_references(kw, match):
    """``EngineConfig(protocol=True)`` refuses participation, the plane and
    every stage, with the reference's messages; an algorithm without a
    protocol form is refused by the engine (tests/test_exec.py:377)."""
    with pytest.raises(ValueError, match=match):
        JEngineConfig(protocol=True, **kw(jcomm)).validate()
    with pytest.raises(ValueError, match=match):
        EngineConfig(protocol=True, **kw(comm)).validate()
    assert EngineConfig(protocol=True).resolve().names() == ("protocol",)
    with pytest.raises(ValueError, match="has no protocol form"):
        RoundEngine(FedDA(tprox.L1(0.1), 2, 0.1, 2.0),
                    logreg.make_grad_fn(), 4, EngineConfig(protocol=True),
                    device="cpu")


# ---------------------------------------------------------------------------
# the remaining regularizers
# ---------------------------------------------------------------------------


_REGS = {
    "elastic_net": (dict(lam1=0.05, lam2=0.2), 1e-12, 1e-14),
    "group_l2": (dict(lam=0.1), 1e-5, 1e-6),
    "linf_ball": (dict(radius=0.7), 1e-12, 1e-14),
    "nuclear": (dict(lam=0.3), 1e-5, 1e-6),
}


def _cases():
    """The inputs of tests/test_prox.py (random (4, 6) and (3, 5) planes, a
    vector, a two-leaf tree, the group-l2 and box examples) and a float32
    matrix tree for the SVD."""
    rng = np.random.default_rng(0)
    return {
        "4x6": (rng.normal(size=(4, 6)), None),
        "3x5": (rng.normal(size=(3, 5)), None),
        "vector": (rng.normal(size=17), None),
        "tree": ({"a": np.arange(5.0), "b": np.ones((2, 2))}, None),
        "masked": ({"w": np.ones(4) * 0.05, "b": np.ones((2, 3)) * 0.05},
                   {"w": True, "b": False}),
        "groups": (np.array([[0.01, 0.01, 0.01], [3.0, 4.0, 0.0]]), None),
        "box": (np.array([-2.0, 0.3, 5.0]), None),
        "f32": ({"m": rng.normal(size=(8, 3)).astype(np.float32),
                 "v": rng.normal(size=(5,)).astype(np.float32),
                 "t": rng.normal(size=(2, 3, 4)).astype(np.float32)}, None),
    }


@pytest.mark.parametrize("case", list(_cases()))
@pytest.mark.parametrize("kind", list(_REGS))
def test_regularizer_matches_reference(x64, kind, case):
    kw, rtol, atol = _REGS[kind]
    x, mask = _cases()[case]
    jreg = jprox.make_regularizer(kind, **kw)
    treg = tprox.make_regularizer(kind, **kw)
    if mask is not None:
        jreg, treg = jreg.with_mask(mask), treg.with_mask(mask)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    tx = interop.params_to_torch(x, "cpu")
    np.testing.assert_allclose(float(treg.value(tx)), float(jreg.value(jx)),
                               rtol=max(rtol, 1e-6), atol=atol)
    for eta in (0.0, 0.5, 3.0):
        got = tu.tree_leaves(treg.prox(tx, eta))
        exp = jax.tree_util.tree_leaves(jreg.prox(jx, eta))
        for g, e in zip(got, exp):
            assert g.dtype == interop.params_to_torch(np.asarray(e),
                                                      "cpu").dtype
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=rtol,
                                       atol=atol)
    assert treg.subgrad_bound(tx) == pytest.approx(jreg.subgrad_bound(jx))


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_cache", [False, True],
                         ids=["host", "device_cache"])
def test_prefetched_chunks_equal_unprefetched_bitwise(device_cache):
    """Prefetch stages chunks ahead from the same per-round generators, so
    every chunk -- the staged ones, the cold first one and a remainder --
    and a run fed by them equal the unprefetched supplier's, bitwise."""
    data, p0 = _logreg(seed=3)
    kw = dict(seed=5, device_cache=device_cache, device="cpu")
    plain = ArraySupplier.from_dataset(data, 3, 8, **kw)
    pre = ArraySupplier.from_dataset(data, 3, 8, prefetch=True, **kw)
    for start, n in ((0, 4), (4, 4), (8, 4), (12, 3), (15, 4), (19, 4)):
        a, b = plain.sample_chunk(start, n), pre.sample_chunk(start, n)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
    pre.close()
    assert pre._executor is None
    alg = tsim.DProxAlgorithm(tprox.L1(0.01), DProxConfig(3, 0.05, 2.0))
    params0 = interop.params_to_torch(p0, "cpu")
    states = []
    for sup in (plain,
                ArraySupplier.from_dataset(data, 3, 8, prefetch=True, **kw)):
        eng = RoundEngine(alg, logreg.make_grad_fn(), 6,
                          EngineConfig(chunk_rounds=4), device="cpu")
        states.append(eng.run(eng.init(params0), sup, 10, seed=0)[0])
        if sup.prefetch:
            sup.close()
    for a, b in zip(tu.tree_leaves(states[0]), tu.tree_leaves(states[1])):
        assert torch.equal(a, b)
