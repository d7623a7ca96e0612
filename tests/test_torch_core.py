"""The port's core modules against the JAX reference: tree helpers, plane
layout, regularizers, synthetic data, the logistic-regression model and the
optimality metrics (repro_torch.* vs repro.*), on the CPU.

Tolerances: plane moves, prox operators and the numpy data generators are
held BITWISE (same operations, one rounding each).  Loss and gradients go
through different matrix-vector products (PyTorch vs XLA, other summation
orders), so they are held at rtol 1e-12 (with atol 1e-15 for coordinates
that cancel to ~0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import plane as jplane
from repro.core import prox as jprox
from repro.data import synthetic as jsyn
from repro.models import logreg as jlogreg
from repro.utils import tree as jtu
from repro_torch import interop
from repro_torch.core import metrics, plane, prox
from repro_torch.data import synthetic
from repro_torch.models import logreg
from repro_torch.utils import tree as tu


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _np_tree(seed, batch=()):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=batch + (13,)),
            "b": rng.normal(size=batch),
            "k": rng.normal(size=batch + (2, 3))}


def _t(tree):
    return interop.params_to_torch(tree, "cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    a, b = (np.ascontiguousarray(np.atleast_1d(x)) for x in (a, b))
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# -- tree helpers -------------------------------------------------------------

def test_tree_leaves_follow_jax_order():
    tree = _np_tree(0)
    assert [x.shape for x in tu.tree_leaves(_t(tree))] == [
        x.shape for x in jax.tree_util.tree_leaves(tree)]


def test_tree_reductions_match_reference():
    """Reductions run in float32, as the reference's do; the two libraries
    sum a leaf's elements in different orders, so rel 1e-6 (a few f32
    ulps)."""
    a, b = _np_tree(1), _np_tree(2)
    for got, exp in ((tu.tree_dot(_t(a), _t(b)), jtu.tree_dot(_j(a), _j(b))),
                     (tu.tree_norm(_t(a)), jtu.tree_norm(_j(a))),
                     (tu.tree_l1(_t(a)), jtu.tree_l1(_j(a)))):
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(exp), rel=1e-6)
    assert tu.tree_size(_t(a)) == jtu.tree_size(a) == 20
    s = tu.tree_lincomb([0.5, -2.0], [_t(a), _t(b)])
    e = jtu.tree_lincomb([0.5, -2.0], [_j(a), _j(b)])
    for k in a:
        _bitwise(s[k].numpy(), e[k])


def test_tree_broadcast_is_a_view_and_stack_inverts_index():
    a = _t(_np_tree(3))
    bc = tu.tree_broadcast_axis0(a, 4)
    assert bc["w"].shape == (4, 13) and bc["w"].stride(0) == 0
    st = tu.tree_stack_axis0([tu.tree_index_axis0(bc, i) for i in range(4)])
    for k in a:
        assert torch.equal(st[k], bc[k])
    assert bool(tu.tree_isfinite(a))
    assert tu.tree_cast(a, torch.float32)["w"].dtype == torch.float32


# -- plane --------------------------------------------------------------------

@pytest.mark.parametrize("tile", [1, 128, 1024])
@pytest.mark.parametrize("batch", [(), (5,)])
def test_plane_spec_and_moves_match_reference(tile, batch):
    tree = _np_tree(4, batch)
    bd = len(batch)
    js = jplane.SegmentSpec.from_tree(_j(tree), batch_dims=bd, tile=tile)
    ts = plane.SegmentSpec.from_tree(_t(tree), batch_dims=bd, tile=tile)
    for f in ("shapes", "offsets", "sizes", "d", "d_pad", "batch_dims",
              "pad", "row_nbytes", "rows"):
        assert getattr(ts, f) == getattr(js, f), f
    assert str(ts.dtype).replace("torch.", "") == np.dtype(js.dtype).name
    jflat = jplane.flatten(js, _j(tree))
    tflat = plane.flatten(ts, _t(tree))
    _bitwise(tflat.numpy(), jflat)
    back = plane.unflatten(ts, tflat)
    for k in tree:
        _bitwise(back[k].numpy(), tree[k])
    assert ts.with_tile(256).d_pad == js.with_tile(256).d_pad


def test_plane_rows_and_param_plane():
    tree = _np_tree(5, (6,))
    flat = plane.flatten(plane.SegmentSpec.from_tree(_t(tree), batch_dims=1),
                         _t(tree))
    ids = np.array([4, 1])
    jflat = jnp.asarray(flat.numpy())
    _bitwise(plane.take_rows(flat, ids).numpy(), jplane.take_rows(jflat, ids))
    rows = torch.zeros(2, flat.shape[1], dtype=flat.dtype)
    _bitwise(plane.put_rows(flat, ids, rows).numpy(),
             jplane.put_rows(jflat, ids, jnp.asarray(rows.numpy())))
    pp = plane.ParamPlane.from_tree(_t(tree), batch_dims=1)
    assert torch.equal(pp.data, flat)
    leaves, spec = tu.tree_flatten(pp)
    assert len(leaves) == 1 and leaves[0] is pp.data
    assert torch.equal(pp.tree["w"], _t(tree)["w"])
    assert plane.zeros(pp.spec, 6).shape == flat.shape


def test_plane_rejects_mixed_dtypes():
    bad = {"w": torch.zeros(3), "b": torch.zeros((), dtype=torch.float64)}
    with pytest.raises(ValueError, match="one dtype"):
        plane.SegmentSpec.from_tree(bad)


# -- prox ---------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_l1_prox_and_value_match_reference(masked):
    tree = _np_tree(6)
    jreg, treg = jprox.L1(lam=0.37), prox.L1(lam=0.37)
    if masked:
        mask = {"w": True, "b": False, "k": True}
        jreg, treg = jreg.with_mask(mask), treg.with_mask(mask)
    for eta in (0.5, 2.25):
        got = treg.prox(_t(tree), eta)
        exp = jreg.prox(_j(tree), eta)
        for k in tree:
            _bitwise(got[k].numpy(), exp[k])
    assert float(treg.value(_t(tree))) == pytest.approx(
        float(jreg.value(_j(tree))), rel=1e-6)  # float32 sums
    assert treg.subgrad_bound(_t(tree)) == jreg.subgrad_bound(_j(tree))


def test_zero_prox_matches_reference():
    tree = _np_tree(7)
    got = prox.Zero().prox(_t(tree), 0.3)
    for k in tree:
        _bitwise(got[k].numpy(), jprox.Zero().prox(_j(tree), 0.3)[k])
    assert float(prox.Zero().value(_t(tree))) == 0.0
    assert prox.Zero().subgrad_bound(_t(tree)) == 0.0


def test_soft_threshold_matches_reference():
    x = np.random.default_rng(8).normal(size=1000)
    _bitwise(prox.soft_threshold(torch.from_numpy(x), 0.4).numpy(),
             jprox.soft_threshold(jnp.asarray(x), 0.4))


# -- data + model -------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_clients=7, m_per_client=33,
                                             d=101, alpha=1.0, beta=2.0,
                                             seed=3)])
def test_dataset_is_byte_identical(kw):
    a, b = synthetic.logistic_heterogeneous(**kw), jsyn.logistic_heterogeneous(**kw)
    _bitwise(a.features, b.features)
    _bitwise(a.labels, b.labels)
    for bs in (None, 4):
        ra, rb = np.random.default_rng(1), np.random.default_rng(1)
        x = synthetic.make_round_batches(a, 3, bs, ra)
        y = jsyn.make_round_batches(b, 3, bs, rb)
        for k in x:
            _bitwise(x[k], y[k])


def _logreg_data(d=10, m=40, seed=0):
    data = jsyn.logistic_heterogeneous(n_clients=1, m_per_client=m, d=d,
                                       alpha=5, beta=5, seed=seed)
    a = (data.features[0] / 10).astype(np.float64)
    return a, data.labels[0].astype(np.float64)


def test_loss_and_grad_match_reference():
    a, y = _logreg_data()
    rng = np.random.default_rng(9)
    params = {"w": rng.normal(size=10), "b": np.float64(0.3)}
    batch = {"a": a, "y": y}
    jl, jg = jlogreg.make_grad_fn()(_j(params), _j(batch))
    tl, tg = logreg.make_grad_fn()(_t(params), _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12)
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-12, atol=1e-15)
    # large margins: logaddexp is not softplus's thresholded form
    big = {"w": params["w"] * 200, "b": params["b"]}
    np.testing.assert_allclose(float(logreg.loss_fn(_t(big), _t(batch))),
                               float(jlogreg.loss_fn(_j(big), _j(batch))),
                               rtol=1e-12)


def test_full_gradient_and_accuracy_match_reference():
    data = jsyn.logistic_heterogeneous(n_clients=3, m_per_client=20, d=6,
                                       seed=2)
    feats = (data.features / 10).astype(np.float64)
    labels = data.labels.astype(np.float64)
    params = {"w": np.linspace(-1, 1, 6), "b": np.float64(-0.2)}
    jg = jlogreg.full_gradient_fn(feats, labels)(_j(params))
    tg = logreg.full_gradient_fn(feats, labels, device="cpu")(_t(params))
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-12, atol=1e-15)
    f2, l2 = feats.reshape(-1, 6), labels.reshape(-1)
    assert float(logreg.accuracy(_t(params), torch.from_numpy(f2),
                                 torch.from_numpy(l2))) == pytest.approx(
        float(jlogreg.accuracy(_j(params), f2, l2)), abs=1e-7)
    p0 = logreg.init_params(6, dtype=torch.float64, device="cpu")
    assert p0["w"].shape == (6,) and p0["b"].shape == ()


def test_metrics_match_reference():
    data = jsyn.logistic_heterogeneous(n_clients=3, m_per_client=20, d=6,
                                       seed=4)
    feats = (data.features / 10).astype(np.float64)
    labels = data.labels.astype(np.float64)
    params = {"w": np.array([0.5, 0.0, -0.2, 0.0, 0.0, 1.0]),
              "b": np.float64(0.1)}
    jfg = jlogreg.full_gradient_fn(feats, labels)
    tfg = logreg.full_gradient_fn(feats, labels, device="cpu")
    jreg, treg = jprox.L1(lam=0.01), prox.L1(lam=0.01)
    jn = float(jmetrics.prox_gradient_norm(jreg, jfg, _j(params), 0.7))
    tn = float(metrics.prox_gradient_norm(treg, tfg, _t(params), 0.7))
    assert tn == pytest.approx(jn, rel=1e-6)  # float32 norms, as the reference
    assert float(metrics.sparsity(_t(params))) == pytest.approx(
        float(jmetrics.sparsity(_j(params))))
    stack = _np_tree(10, (4,))
    anchor = _np_tree(11)
    assert float(metrics.client_drift(_t(stack), _t(anchor))) == pytest.approx(
        float(jmetrics.client_drift(_j(stack), _j(anchor))), rel=1e-6)
