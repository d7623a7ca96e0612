"""The port's kernel modules against the JAX reference (repro_torch.kernels
vs repro.kernels): the fused local-update + L1-prox step, and the flat-plane
threshold select, quantizer and weighted commit.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``).

Tolerances:
  * the plain version rounds like ``repro.kernels.ref.fused_local_update``
    (one rounding per operation, in the input dtype), so the two are held
    BITWISE in float32 and float64;
  * the Pallas kernel run by the interpreter contracts
    ``z_hat - eta*(g + c)`` into an FMA (one rounding fewer), so against it
    float32 is held to ``4 * eps32 * max(|z_hat|, |eta*(g+c)|)`` per element
    and bfloat16 (computed in float32, rounded once at each store by both)
    to one bfloat16 ulp plus that float32 term, which the soft threshold
    exposes where ``|z_hat'|`` is within a few float32 ulps of ``thresh``;
  * the plane kernels' plain versions spell out ``ref.plane_threshold_select``
    and ``ref.plane_quantize`` in the same dtype (float32, float64), so they
    are held BITWISE, NaN, +-0, +-inf and ``|x| == thresh`` included.  In
    bfloat16 the reference quantizes with every operation rounded to
    bfloat16, the port computes in float32 and rounds once: held to two
    quantization steps ``2*s/L`` (a level can move by one where a bfloat16
    rounding of ``y`` crosses an integer or ``u`` the fraction) plus two
    bfloat16 ulps of the output;
  * the weighted commit's plain version adds the rows in order in the
    plane's dtype, as ``ref.plane_weighted_commit``'s ``jnp.sum`` does on
    the CPU for at most 32 rows: held BITWISE there (float32, float64; NaN,
    +-0, +-inf and zero weights included).  Against the Pallas kernel run
    by the interpreter (weights cast to float32, float32 sums, possibly
    contracted into FMAs) float32 is held to ``n * eps32 * sum_i |w_i
    x_i|`` per column, and float64 to the same bound, since the Pallas
    kernel rounds a float64 plane to float32 first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.fused_prox import fused_local_update_2d as pallas_2d
from repro_torch.kernels import _build, fused_prox, ops, plane_ops

EPS32 = float(np.finfo(np.float32).eps)
ETA, THRESH = 0.37, 0.21


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view({4: np.uint32, 8: np.uint64, 2: np.uint16}[x.itemsize])


@pytest.mark.parametrize("shape", [(30, 21), (1, 21), (3, 1000), (7, 4097),
                                   (2, 112_395)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_plain_matches_ref_bitwise(shape, dtype):
    zh, g, c = _inputs(shape, dtype)
    exp_zh, exp_z = ref.fused_local_update(jnp.asarray(zh), jnp.asarray(g),
                                           jnp.asarray(c), ETA, THRESH)
    got_zh, got_z = fused_prox.fused_local_update_plain(
        *map(torch.from_numpy, (zh, g, c)), ETA, THRESH)
    np.testing.assert_array_equal(_bits(got_zh.numpy()),
                                  _bits(np.asarray(exp_zh)))
    np.testing.assert_array_equal(_bits(got_z.numpy()),
                                  _bits(np.asarray(exp_z)))


def test_plain_matches_pallas_within_fma_tolerance_f32():
    zh, g, c = _inputs((512, 128), np.float32, seed=1)
    p_zh, p_z = pallas_2d(jnp.asarray(zh), jnp.asarray(g), jnp.asarray(c),
                          ETA, THRESH, interpret=True, block_rows=256)
    got_zh, got_z = fused_prox.fused_local_update_2d(
        *map(torch.from_numpy, (zh, g, c)), ETA, THRESH)
    step = np.float32(ETA) * (g + c)
    atol = 4 * EPS32 * np.maximum(np.abs(zh), np.abs(step))
    assert np.all(np.abs(got_zh.numpy() - np.asarray(p_zh)) <= atol)
    assert np.all(np.abs(got_z.numpy() - np.asarray(p_z)) <= atol)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_plain_matches_pallas_within_one_ulp_bf16():
    zh, g, c = _inputs((512, 128), np.float32, seed=2)
    tz = [torch.from_numpy(x).to(torch.bfloat16) for x in (zh, g, c)]
    jz = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tz]
    p_zh, p_z = pallas_2d(*jz, ETA, THRESH, interpret=True, block_rows=256)
    got_zh, got_z = fused_prox.fused_local_update_2d(*tz, ETA, THRESH)
    assert got_zh.dtype == got_z.dtype == torch.bfloat16
    # where |z_hat'| ~ thresh the soft threshold cancels, and z' shows the
    # float32 FMA difference itself (e.g. -4.5e-8 vs -1.5e-8): add that term
    zh32, g32, c32 = (t.float().numpy() for t in tz)
    fma = 4 * EPS32 * np.maximum(np.abs(zh32),
                                 np.abs(np.float32(ETA) * (g32 + c32)))
    for got, exp in ((got_zh, p_zh), (got_z, p_z)):
        a = got.float().numpy()
        b = np.asarray(exp.astype(jnp.float32))
        ulp = _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
        assert np.all(np.abs(a - b) <= ulp + fma)


@pytest.mark.parametrize("n", [1, 127, 5000])
def test_ops_tree_matches_jax_ops_f32(n):
    rng = np.random.default_rng(n)
    tree = {"w": rng.normal(size=(n,)).astype(np.float32),
            "b": rng.normal(size=()).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in tree.items()}
    c = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in tree.items()}
    exp_zh, exp_z = jops.fused_local_update(
        *({k: jnp.asarray(v) for k, v in t.items()} for t in (tree, g, c)),
        ETA, THRESH, interpret=True, block_rows=8)
    got_zh, got_z = ops.fused_local_update(
        *({k: torch.from_numpy(v) for k, v in t.items()}
          for t in (tree, g, c)), ETA, THRESH)
    for k in tree:
        step = np.float32(ETA) * (g[k] + c[k])
        atol = 4 * EPS32 * np.maximum(np.abs(tree[k]), np.abs(step))
        assert got_zh[k].shape == tuple(tree[k].shape)
        assert np.all(np.abs(got_zh[k].numpy() - np.asarray(exp_zh[k]))
                      <= atol)
        assert np.all(np.abs(got_z[k].numpy() - np.asarray(exp_z[k]))
                      <= atol)


def test_ops_client_plane_is_one_call_over_all_clients():
    """batch_dims=1 lays a client-stacked tree out as one (n, d_pad)
    plane; the result equals the per-client update."""
    rng = np.random.default_rng(3)
    n, d = 5, 9
    mk = lambda: {"w": torch.from_numpy(rng.normal(size=(n, d))),
                  "b": torch.from_numpy(rng.normal(size=(n,)))}
    zh, g, c = mk(), mk(), mk()
    got_zh, got_z = ops.fused_local_update(zh, g, c, ETA, THRESH,
                                           batch_dims=1)
    for i in range(n):
        row = lambda t: {k: v[i] for k, v in t.items()}
        e_zh, e_z = ops.fused_local_update(row(zh), row(g), row(c), ETA,
                                           THRESH)
        for k in zh:
            assert torch.equal(got_zh[k][i], e_zh[k])
            assert torch.equal(got_z[k][i], e_z[k])


def test_ops_rejects_mixed_dtype_trees():
    tree = {"w": torch.zeros(3, dtype=torch.float32),
            "b": torch.zeros((), dtype=torch.float64)}
    with pytest.raises(ValueError, match="one dtype"):
        ops.fused_local_update(tree, tree, tree, ETA, THRESH)


def test_wrapper_checks_its_inputs():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="dtype"):
        fused_prox.fused_local_update_2d(a, a.double(), a, ETA, THRESH)
    with pytest.raises(ValueError, match="shape"):
        fused_prox.fused_local_update_2d(a, a[:2], a[:2], ETA, THRESH)
    with pytest.raises(ValueError, match="dtype"):
        fused_prox.fused_local_update_2d(*(a.int(),) * 3, ETA, THRESH)


def test_wrapper_raises_on_a_device_without_kernel():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises -- it never falls back."""
    m = torch.empty(4, 8, device="meta")
    before = fused_prox.fused_local_update_2d.launches
    with pytest.raises(ValueError, match="no fused_local_update kernel"):
        fused_prox.fused_local_update_2d(m, m, m, ETA, THRESH)
    assert fused_prox.fused_local_update_2d.launches == before


def test_cpu_calls_do_not_count_as_launches():
    a = torch.ones(2, 3)
    before = fused_prox.fused_local_update_2d.launches
    fused_prox.fused_local_update_2d(a, a, a, ETA, THRESH)
    assert fused_prox.fused_local_update_2d.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "FALLBACK_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_sources_and_flags(monkeypatch):
    srcs = _build._sources()
    assert [s.name for s in srcs] == ["flash_attention.cu",
                                      "flash_attention_bwd.cu",
                                      "fused_prox.cu", "plane_ops.cu"]
    flags = {s.name: _build.source_flags(s) for s in srcs}
    for f in flags.values():
        assert "arch=compute_90a,code=sm_90a" in f
    # the bitwise plane kernels never contract into an FMA; the flash
    # kernels (held to a tolerance) do, and report their registers and spills
    assert "-fmad=false" in flags["fused_prox.cu"]
    assert "-fmad=false" in flags["plane_ops.cu"]
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert "-fmad=true" in flags[name]
        assert "-fmad=false" not in flags[name]
        assert "-v" in flags[name]
    # the library name changes with the sources and with any source's flags
    digest = _build._digest(srcs)
    assert len(digest) == 16
    monkeypatch.setitem(_build.SOURCE_FLAGS, "flash_attention.cu",
                        ("-fmad=false",))
    assert _build._digest(srcs) != digest


def test_ptxas_report_is_parsed_per_kernel():
    text = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 197696 bytes smem, 960 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Function properties for _Z3barv
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 360 bytes cmem[0]
"""
    rep = _build.parse_ptxas(text)
    assert set(rep) == {"_Z3fooPf", "_Z3barv"}
    assert rep["_Z3fooPf"] == {"warnings": [], "stack": 0, "spill_stores": 0,
                               "spill_loads": 0, "registers": 168,
                               "smem": 197696}
    bar = rep["_Z3barv"]
    assert (bar["registers"], bar["smem"], bar["spill_stores"],
            bar["spill_loads"], bar["stack"]) == (40, 0, 12, 4, 8)
    assert bar["warnings"] and "C7508" in bar["warnings"][0]


def test_fused_step_is_a_drop_in_for_the_plain_step():
    """ops.fused_local_update_step == the plain step z_hat - eta*(g + c)
    followed by L1.prox at (t+1)*eta; a masked L1 is refused."""
    from repro_torch.core.prox import L1

    rng = np.random.default_rng(5)
    mk = lambda: {"w": torch.from_numpy(rng.normal(size=7)),
                  "b": torch.from_numpy(rng.normal(size=()))}
    zh, g, c = mk(), mk(), mk()
    reg = L1(lam=0.2)
    got = ops.fused_local_update_step(reg, 0.3, 2, zh, g, c)
    zh_next = {k: zh[k] - 0.3 * (g[k] + c[k]) for k in zh}
    exp = (zh_next, reg.prox(zh_next, 3 * 0.3))
    for a, b in zip(got, exp):
        for k in zh:
            assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="unmasked L1"):
        ops.fused_local_update_step(reg.with_mask({"w": True, "b": False}),
                                    0.3, 2, zh, g, c)


# ---------------------------------------------------------------------------
# flat-plane threshold select and quantizer
# ---------------------------------------------------------------------------

SPECIALS = [np.nan, -0.0, 0.0, np.inf, -np.inf]


def _plane_with_specials(shape, dtype, seed):
    """A plane of normals whose row 0 holds NaN, +-0, +-inf and, in every
    row, values exactly at +-thresh; returns (x, thresh)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(dtype)
    thresh = np.abs(rng.normal(size=shape[0])).astype(dtype)
    k = min(len(SPECIALS), shape[1])
    x[0, :k] = np.asarray(SPECIALS[:k], dtype)
    if shape[1] > k + 1:
        x[:, k] = thresh
        x[:, k + 1] = -thresh
    return x, thresh


@pytest.mark.parametrize("shape", [(30, 128), (1, 112_512), (4, 9), (3, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_threshold_select_plain_matches_ref_bitwise(shape, dtype):
    x, thresh = _plane_with_specials(shape, dtype, seed=shape[1])
    exp = np.asarray(ref.plane_threshold_select(jnp.asarray(x),
                                                jnp.asarray(thresh)))
    got = plane_ops.threshold_select_2d(torch.from_numpy(x),
                                        torch.from_numpy(thresh)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(exp))
    if shape[1] > 7:  # |x| == thresh is kept, NaN is dropped
        assert np.all(got[:, 5] == thresh) and np.all(got[:, 6] == -thresh)
    assert got[0, 0] == 0


def test_threshold_select_takes_thresh_in_x_dtype():
    """A float64 threshold is cast to x's dtype first, as ``ref.py`` does
    (the Pallas kernel casts it to float32, ROADMAP Queue 3)."""
    x = torch.tensor([[1.0, 1.0 + 2 ** -40]], dtype=torch.float64)
    t = torch.tensor([1.0 + 2 ** -41], dtype=torch.float64)
    got = plane_ops.threshold_select_2d(x, t)
    exp = np.asarray(ref.plane_threshold_select(jnp.asarray(x.numpy()),
                                                jnp.asarray(t.numpy())))
    np.testing.assert_array_equal(got.numpy(), exp)
    assert got[0, 0] == 0 and got[0, 1] == x[0, 1]


def _quant_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(dtype)
    x[0, :2] = [-0.0, 0.0]
    u = rng.uniform(size=shape).astype(dtype)
    scale = np.max(np.abs(x), axis=1)
    scale[-1] = 0.0  # a zero-scale row quantizes as scale 1
    return x, u, scale


@pytest.mark.parametrize("levels", [1, 15, 255])
@pytest.mark.parametrize("shape", [(30, 128), (1, 4097), (5, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_quantize_plain_matches_ref_bitwise(shape, dtype, levels):
    x, u, scale = _quant_inputs(shape, dtype, seed=levels)
    exp = np.asarray(ref.plane_quantize(jnp.asarray(x), jnp.asarray(u),
                                        jnp.asarray(scale), levels))
    got = plane_ops.quantize_2d(*map(torch.from_numpy, (x, u, scale)),
                                levels).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(exp))


def test_quantize_plain_matches_ref_bf16_within_two_levels():
    x, u, scale = _quant_inputs((30, 128), np.float32, seed=7)
    tx, tu_ = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, u))
    ts = torch.amax(torch.abs(tx), dim=1)
    ts[-1] = 0
    got = plane_ops.quantize_2d(tx, tu_, ts, 255)
    assert got.dtype == torch.bfloat16
    jx, ju, js = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tx, tu_, ts))
    exp = np.asarray(ref.plane_quantize(jx, ju, js, 255).astype(jnp.float32))
    s = ts.float().numpy()
    s[s == 0] = 1.0
    a = got.float().numpy()
    tol = 2 * s[:, None] / 255 + 2 * _bf16_ulp(np.maximum(np.abs(a),
                                                          np.abs(exp)))
    assert np.all(np.abs(a - exp) <= tol)


def test_plane_ops_match_pallas_interpret_f32():
    """In float32 the Pallas select (run by the interpreter) equals the
    plain version bitwise.  The interpreted quantizer rounds its divisions
    differently (1-2 float32 ulps of the output), so it is held to one
    quantization step ``s/L`` (where ``y - floor(y)`` sits at ``u``) plus
    four float32 ulps."""
    from repro.kernels import ops as kops

    x, thresh = _plane_with_specials((4, 1024), np.float32, seed=3)
    x[0, 0] = 0.5  # the interpreter's NaN handling is not the point here
    exp = kops.plane_threshold_select(jnp.asarray(x), jnp.asarray(thresh),
                                      interpret=True)
    got = ops.plane_threshold_select(torch.from_numpy(x),
                                     torch.from_numpy(thresh))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(exp)))
    x, u, scale = _quant_inputs((4, 1024), np.float32, seed=4)
    exp = kops.plane_quantize(jnp.asarray(x), jnp.asarray(u),
                              jnp.asarray(scale), 255, interpret=True)
    got = ops.plane_quantize(*map(torch.from_numpy, (x, u, scale)),
                             255).numpy()
    s = np.where(scale == 0, 1, scale)[:, None]
    exp = np.asarray(exp)
    tol = s / 255 + 4 * EPS32 * np.maximum(np.abs(got), np.abs(exp))
    assert np.all(np.abs(got - exp) <= tol)


def test_plane_wrappers_check_their_inputs():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="per-row"):
        plane_ops.threshold_select_2d(x, torch.zeros(4))
    with pytest.raises(ValueError, match="plane"):
        plane_ops.threshold_select_2d(torch.zeros(8), torch.zeros(1))
    with pytest.raises(ValueError, match="dtype"):
        plane_ops.threshold_select_2d(x.int(), torch.zeros(3))
    with pytest.raises(ValueError, match="draws"):
        plane_ops.quantize_2d(x, x.double(), torch.ones(3), 255)
    with pytest.raises(ValueError, match="levels"):
        plane_ops.quantize_2d(x, x, torch.ones(3), 0)


def test_plane_wrappers_raise_on_a_device_without_kernel():
    m = torch.empty(3, 8, device="meta")
    t = torch.empty(3, device="meta")
    before = (plane_ops.threshold_select_2d.launches,
              plane_ops.quantize_2d.launches)
    with pytest.raises(ValueError, match="no threshold_select kernel"):
        plane_ops.threshold_select_2d(m, t)
    with pytest.raises(ValueError, match="no quantize kernel"):
        plane_ops.quantize_2d(m, m, t, 255)
    x = torch.ones(3, 8)
    plane_ops.threshold_select_2d(x, torch.ones(3))
    plane_ops.quantize_2d(x, x * 0.5, torch.ones(3), 255)
    assert (plane_ops.threshold_select_2d.launches,
            plane_ops.quantize_2d.launches) == before


# ---------------------------------------------------------------------------
# the weighted commit (kernel 4)
# ---------------------------------------------------------------------------


def _commit_inputs(shape, dtype, seed=0, specials=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp(
        rng.uniform(-8, 8, (shape[0], 1)))).astype(dtype)
    w = rng.uniform(0.1, 2.0, shape[0])
    w[rng.random(shape[0]) < 0.3] = 0.0  # undelivered clients
    if specials and shape[1] >= 6:
        x[0, :5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
        x[:, 5] = -0.0  # a column of negative zeros sums to +0
    return x, w


@pytest.mark.parametrize("n", [1, 15, 30, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_weighted_commit_plain_matches_ref_bitwise(n, dtype):
    x, w = _commit_inputs((n, 128 * 3), dtype, seed=n)
    exp = ref.plane_weighted_commit(jnp.asarray(x), jnp.asarray(w, dtype))
    got = ops.plane_weighted_commit(torch.from_numpy(x),
                                    torch.from_numpy(w.astype(dtype)))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (384,)
    if n == 1:
        # XLA folds a one-row sum into the row itself, so a -0 product
        # stays -0 there; the loop starts from +0 and gives +0
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        return
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(exp)))


def test_weighted_commit_plain_computes_in_the_plane_dtype():
    """float64 sums in float64 with float64 weights (``ref.py``), where the
    Pallas kernel would round both to float32; bfloat16 sums in float32 and
    rounds once."""
    x = torch.tensor([[1.0, 3.0], [1e-12, 1.0]], dtype=torch.float64)
    w = torch.tensor([1.0, 1.0 / 3.0], dtype=torch.float64)
    got = plane_ops.weighted_commit_plain(x, w).numpy()
    exp = (np.float64(0) + 1.0 * x[0].numpy()) + (1.0 / 3.0) * x[1].numpy()
    np.testing.assert_array_equal(got, exp)
    assert got[0] != np.float32(1.0) + np.float32(1e-12) / np.float32(3.0)
    xb = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -8]],
                      dtype=torch.bfloat16)
    got = plane_ops.weighted_commit_plain(xb, torch.ones(3))
    # in bfloat16 each 2^-8 would round away (a tie to even at 1.0); in
    # float32 they add up first and the sum rounds once
    assert got.dtype == torch.bfloat16 and got.item() == 1.0 + 2.0 ** -7


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_weighted_commit_matches_pallas_interpret_at_f32_rounding(dtype):
    n = 30
    x, w = _commit_inputs((n, 1024), dtype, seed=5, specials=False)
    exp = np.asarray(jops.plane_weighted_commit(
        jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = ops.plane_weighted_commit(torch.from_numpy(x),
                                    torch.from_numpy(w)).numpy()
    tol = n * EPS32 * np.abs(w[:, None] * x.astype(np.float64)).sum(axis=0)
    assert np.all(np.abs(got.astype(np.float64) - exp) <= tol)


def test_weighted_commit_wrapper_checks_and_counts():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="per-row"):
        plane_ops.weighted_commit_2d(x, torch.zeros(4))
    with pytest.raises(ValueError, match="plane"):
        plane_ops.weighted_commit_2d(torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="dtype"):
        plane_ops.weighted_commit_2d(x.int(), torch.zeros(3))
    with pytest.raises(ValueError, match="no weighted_commit kernel"):
        plane_ops.weighted_commit_2d(torch.empty(3, 8, device="meta"),
                                     torch.empty(3, device="meta"))
    before = plane_ops.weighted_commit_2d.launches
    plane_ops.weighted_commit_2d(torch.ones(3, 8), torch.ones(3))
    assert plane_ops.weighted_commit_2d.launches == before  # CPU: plain
    assert "repro_weighted_commit" in (_build.CSRC / "plane_ops.cu").read_text()
