"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the kernel
has no CPU mode.  This file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch import comm
from repro_torch.core import plane as pln
from repro_torch.kernels import flash_attention, fused_prox, ops, plane_ops

ETA, THRESH = 0.37, 0.21
_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits_equal(a, b) -> bool:
    ity = _INT[a.element_size()]
    return torch.equal(a.view(ity), b.view(ity))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape", [(30, 21), (30, 112_395), (3, 4099)])
def test_kernel_matches_plain_bitwise_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    zh, g, c = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                for _ in range(3))
    zh[0, :4] = torch.tensor([float("nan"), -0.0, float("inf"), THRESH])
    before = fused_prox.fused_local_update_2d.launches
    k_zh, k_z = fused_prox.fused_local_update_2d(zh, g, c, ETA, THRESH)
    p_zh, p_z = fused_prox.fused_local_update_plain(zh, g, c, ETA, THRESH)
    torch.cuda.synchronize()
    assert fused_prox.fused_local_update_2d.launches == before + 1
    assert _bits_equal(k_zh, p_zh) and _bits_equal(k_z, p_z)


@pytest.mark.gpu
def test_unaligned_views_take_the_scalar_path(cuda):
    """A plane starting off a 16-byte boundary still equals the plain
    version (the kernel drops to scalar loads)."""
    base = torch.randn(3, 1001, device=cuda, dtype=torch.float64)
    zh, g, c = (base[i, 1:] for i in range(3))  # contiguous, 8 bytes off
    assert zh.is_contiguous() and zh.data_ptr() % 16 == 8
    k_zh, k_z = fused_prox.fused_local_update_2d(zh, g, c, ETA, THRESH)
    p_zh, p_z = fused_prox.fused_local_update_plain(zh, g, c, ETA, THRESH)
    assert _bits_equal(k_zh, p_zh) and _bits_equal(k_z, p_z)


@pytest.mark.gpu
def test_kernel_rejects_non_contiguous_input(cuda):
    a = torch.randn(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_prox.fused_local_update_2d(a.t(), a.t(), a.t(), ETA, THRESH)


@pytest.mark.gpu
def test_tree_update_is_one_launch_for_all_clients(cuda):
    n, d = 30, 21
    mk = lambda: {"w": torch.randn(n, d, device=cuda, dtype=torch.float64),
                  "b": torch.randn(n, device=cuda, dtype=torch.float64)}
    zh, g, c = mk(), mk(), mk()
    before = fused_prox.fused_local_update_2d.launches
    got_zh, got_z = ops.fused_local_update(zh, g, c, ETA, THRESH,
                                           batch_dims=1)
    assert fused_prox.fused_local_update_2d.launches == before + 1
    cpu = lambda t: {k: v.cpu() for k, v in t.items()}
    e_zh, e_z = ops.fused_local_update(cpu(zh), cpu(g), cpu(c), ETA, THRESH,
                                       batch_dims=1)
    for k in zh:  # float64 elementwise: CPU and card round alike
        assert torch.equal(got_zh[k].cpu(), e_zh[k])
        assert torch.equal(got_z[k].cpu(), e_z[k])


# ---------------------------------------------------------------------------
# flat-plane threshold select and quantizer
# ---------------------------------------------------------------------------

_SPECIALS = [float("nan"), -0.0, 0.0, float("inf"), -float("inf")]


def _plane(cuda, shape, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(shape, generator=gen, device=cuda, dtype=work).to(dtype)
    u = torch.rand(shape, generator=gen, device=cuda, dtype=work).to(dtype)
    return x, u


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape", [(30, 128), (30, 112_512), (1, 112_512),
                                   (3, 4099), (5, 3)])
def test_plane_kernels_match_plain_bitwise_on_card(cuda, dtype, shape):
    x, u = _plane(cuda, shape, dtype, seed=shape[1])
    k = min(len(_SPECIALS), shape[1])
    x[0, :k] = torch.tensor(_SPECIALS[:k], dtype=dtype)
    thresh = torch.quantile(x.abs().float().nan_to_num(0.0, 0.0, 0.0), 0.7,
                            dim=1).to(dtype)
    if shape[1] > k:
        x[:, k] = thresh  # |x| == thresh is kept
    before = (plane_ops.threshold_select_2d.launches,
              plane_ops.quantize_2d.launches)
    got = plane_ops.threshold_select_2d(x, thresh)
    exp = plane_ops.threshold_select_plain(x, thresh)
    scale = torch.amax(torch.abs(x), dim=1)
    scale[-1] = 0  # a zero-scale row quantizes as scale 1
    q = plane_ops.quantize_2d(x, u, scale, 255)
    q_exp = plane_ops.quantize_plain(x, u, scale, 255)
    torch.cuda.synchronize()
    assert (plane_ops.threshold_select_2d.launches,
            plane_ops.quantize_2d.launches) == (before[0] + 1, before[1] + 1)
    assert _bits_equal(got, exp) and _bits_equal(q, q_exp)


@pytest.mark.gpu
def test_plane_kernels_on_unaligned_views(cuda):
    """Planes starting off a 16-byte boundary take the scalar path and
    still equal the plain versions."""
    base, ubase = _plane(cuda, (4, 1001), torch.float64, seed=1)
    x = base.reshape(-1)[1:4001].reshape(4, 1000)  # contiguous, 8 bytes off
    u = ubase.reshape(-1)[1:4001].reshape(4, 1000)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    t = torch.full((4,), 0.5, device=cuda, dtype=torch.float64)
    assert _bits_equal(plane_ops.threshold_select_2d(x, t),
                       plane_ops.threshold_select_plain(x, t))
    s = torch.amax(torch.abs(x), dim=1)
    assert _bits_equal(plane_ops.quantize_2d(x, u, s, 15),
                       plane_ops.quantize_plain(x, u, s, 15))


@pytest.mark.gpu
def test_plane_kernels_reject_non_contiguous_input(cuda):
    a = torch.randn(8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        plane_ops.threshold_select_2d(a.t(), torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        plane_ops.quantize_2d(a.t(), a.t(), torch.ones(4, device=cuda), 15)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["topk", "quantize"])
def test_one_launch_per_global_compress_call(cuda, name):
    """A global compress on the card is one kernel launch, and equals the
    same compress on the CPU given the same draws (float64)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    msg = {"w": torch.randn(30, 112_394, generator=gen, device=cuda,
                            dtype=torch.float64),
           "b": torch.randn(30, generator=gen, device=cuda,
                            dtype=torch.float64)}
    spec = pln.SegmentSpec.from_tree(msg, batch_dims=1)
    tr = (comm.TopK(0.1, granularity="global") if name == "topk"
          else comm.Quantize(8, granularity="global"))
    pt = comm.PlaneTransport(tr, spec)
    flat = pln.flatten(spec, msg)
    state = pt.init_state(flat)
    counter = (plane_ops.threshold_select_2d if name == "topk"
               else plane_ops.quantize_2d)
    before = counter.launches
    hat, new_state = pt.compress(state, flat, comm.GeneratorDraws(0))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    hat_cpu, _ = pt.compress(state.cpu(), flat.cpu(), comm.GeneratorDraws(0))
    assert counter.launches == before + 1
    assert torch.equal(hat.cpu(), hat_cpu)
    assert torch.equal(new_state.cpu(), flat.cpu() - hat_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape", [(30, 128), (30, 112_512), (1, 112_512),
                                   (3, 4099), (5, 3)])
def test_weighted_commit_matches_plain_bitwise_on_card(cuda, dtype, shape):
    x, _ = _plane(cuda, shape, dtype, seed=shape[1] + 7)
    k = min(len(_SPECIALS), shape[1])
    x[0, :k] = torch.tensor(_SPECIALS[:k], dtype=dtype)
    w = torch.rand(shape[0], device=cuda, dtype=torch.float64) + 0.5
    w[::3] = 0.0  # undelivered clients
    before = plane_ops.weighted_commit_2d.launches
    got = plane_ops.weighted_commit_2d(x, w)
    exp = plane_ops.weighted_commit_plain(x, w)
    torch.cuda.synchronize()
    assert plane_ops.weighted_commit_2d.launches == before + 1
    assert got.shape == (shape[1],) and got.dtype == dtype
    assert _bits_equal(got, exp)


@pytest.mark.gpu
def test_weighted_commit_on_unaligned_views(cuda):
    """A plane off a 16-byte boundary, or rows of an odd width, take the
    scalar path and still equal the plain version."""
    base, _ = _plane(cuda, (4, 1001), torch.float64, seed=2)
    x = base.reshape(-1)[1:4001].reshape(4, 1000)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    w = torch.tensor([0.5, 0.0, 2.0, 1.0], device=cuda, dtype=torch.float64)
    assert _bits_equal(plane_ops.weighted_commit_2d(x, w),
                       plane_ops.weighted_commit_plain(x, w))
    y = base[:, :999].contiguous()
    assert _bits_equal(plane_ops.weighted_commit_2d(y, w),
                       plane_ops.weighted_commit_plain(y, w))
    with pytest.raises(ValueError, match="contiguous"):
        plane_ops.weighted_commit_2d(base.t(), torch.ones(1001, device=cuda))


@pytest.mark.gpu
def test_plane_async_commit_launches_the_commit_kernel(cuda):
    """A buffered async commit on the plane is one commit-kernel launch,
    and equals the same commits on the CPU given the same draws."""
    import numpy as np

    from repro_torch import sched
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.prox import L1
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import simulator
    from repro_torch.models import logreg

    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 3, 8, 10)) / 4
    y = np.sign(rng.standard_normal((6, 3, 8)))
    alg = simulator.DProxAlgorithm(L1(0.01), DProxConfig(3, 0.05, 2.0))
    out = {}
    for dev in ("cuda", "cpu"):
        eng = RoundEngine(alg, logreg.make_grad_fn(), 6, EngineConfig(
            plane=True, transport=comm.TopK(0.5, granularity="global"),
            clock=sched.StragglerClock(slowdown=3.0), buffer_size=3,
            staleness=sched.Staleness("poly", correct=True), queue_depth=2),
            device=dev, clock_draws=comm.GeneratorDraws(1, "cpu"))
        st = eng.init({"w": torch.zeros(10, dtype=torch.float64),
                       "b": torch.zeros((), dtype=torch.float64)})
        before = plane_ops.weighted_commit_2d.launches
        st, m = eng.run(st, lambda r, g: {"a": a, "y": y}, 5)
        out[dev] = (st, m, plane_ops.weighted_commit_2d.launches - before)
    assert out["cuda"][2] == 5 and out["cpu"][2] == 0
    assert out["cuda"][1]["staleness_mean"] == out["cpu"][1]["staleness_mean"]
    assert torch.allclose(out["cuda"][0].x_bar["w"].cpu(),
                          out["cpu"][0].x_bar["w"], rtol=1e-9, atol=1e-12)


# -- the redesigned commit (kernel 4) and leaf-table update (kernel 1) --------


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(30, 128), (30, 112_512), (7, 1001),
                                   (1, 4096), (300, 2048), (33, 16)])
@pytest.mark.parametrize("loads", [False, True], ids=["ring", "loads"])
def test_commit_weight_dtypes_and_ring_on_card(cuda, w_dtype, dtype, shape,
                                               loads):
    """The commit kernel in the caller's weight dtype, bitwise equal to the
    plain version (which casts first): the paper and wide planes, an odd
    width (scalar kernel), one row, 300 rows (the ring walked ten times, or
    ten passes of plain loads), 33 rows (a slot of one row); one launch,
    nothing else."""
    x, _ = _plane(cuda, shape, dtype, seed=shape[0] + shape[1])
    k = min(len(_SPECIALS), shape[1])
    x[shape[0] // 2, :k] = torch.tensor(_SPECIALS[:k], dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = (torch.rand(shape[0], generator=gen, device=cuda,
                    dtype=torch.float64) / 3 + 0.5).to(w_dtype)
    w[::4] = 0.0
    before = plane_ops.weighted_commit_2d.launches
    got = plane_ops.weighted_commit_2d(x, w, loads=loads)
    torch.cuda.synchronize()
    assert plane_ops.weighted_commit_2d.launches == before + 1
    assert _bits_equal(got, plane_ops.weighted_commit_plain(x, w))


@pytest.mark.gpu
def test_commit_reads_strided_and_offset_rows_on_card(cuda):
    base, _ = _plane(cuda, (30, 1040), torch.float64, seed=5)
    w = torch.rand(30, device=cuda, dtype=torch.float32)
    for x in (base[:, :1024], base[:, 16:1040], base[:, 1:1025],
              base[::3, :512]):
        assert _bits_equal(plane_ops.weighted_commit_2d(x, w[:x.shape[0]]),
                           plane_ops.weighted_commit_plain(x, w[:x.shape[0]]))
    with pytest.raises(ValueError, match="contiguous"):
        plane_ops.weighted_commit_2d(base[:, :64].t(), torch.ones(64,
                                                                 device=cuda))
    with pytest.raises(ValueError, match="per-row"):
        plane_ops.weighted_commit_2d(base, w[:3])
    with pytest.raises(ValueError, match="dtype"):
        plane_ops.weighted_commit_2d(base.int(), w)


def _leaf_tree(cuda, widths, n, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    t = {f"l{i:03d}": torch.randn((n, w), generator=gen, device=cuda,
                                  dtype=torch.float64).to(dtype)
         for i, w in enumerate(widths)}
    first = t["l000"]
    k = min(first.shape[1], 4)
    first[0, :k] = torch.tensor([float("nan"), -0.0, float("inf"), THRESH][:k])
    return t


def _tree_plain(zh, g, c):
    spec = pln.SegmentSpec.from_tree(zh, batch_dims=1, tile=1)
    planes = [pln.flatten(spec, t).contiguous() for t in (zh, g, c)]
    a, b = fused_prox.fused_local_update_plain(*planes, ETA, THRESH)
    return pln.unflatten(spec, a), pln.unflatten(spec, b)


def _one_launch_equals_plain(zh, g, c):
    before = (fused_prox.fused_local_update_2d.launches,
              fused_prox.fused_local_update_2d.copies)
    got = ops.fused_local_update(zh, g, c, ETA, THRESH, batch_dims=1)
    exp = _tree_plain(zh, g, c)
    torch.cuda.synchronize()
    assert (fused_prox.fused_local_update_2d.launches,
            fused_prox.fused_local_update_2d.copies) == (before[0] + 1,
                                                         before[1])
    for a, b in zip(got, exp):
        for k in b:
            assert _bits_equal(a[k], b[k]), k
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("widths", [(20, 1), (112_394, 1), (3, 7, 1, 4099),
                                    tuple((i * 7) % 13 + 1
                                          for i in range(200))],
                         ids=["paper", "wide", "ragged", "200 leaves"])
def test_leaf_table_update_is_one_launch_on_card(cuda, dtype, widths):
    """Contiguous leaves, then views of the previous output planes with c
    broadcast from one row (the tau loop): one launch, no copy, bitwise."""
    zh, g, c = (_leaf_tree(cuda, widths, 30, dtype, s) for s in range(3))
    zh2, _ = _one_launch_equals_plain(zh, g, c)
    c_row = {k: v[5] for k, v in c.items()}
    cb = {k: v[None].expand(30, *v.shape) for k, v in c_row.items()}
    _one_launch_equals_plain(zh2, g, cb)


@pytest.mark.gpu
def test_leaf_table_unaligned_segments_on_card(cuda):
    """Leaves starting 8 bytes off 16 and rows of an odd stride take the
    scalar path; still one launch and bitwise."""
    base = torch.randn(30, 1027, device=cuda, dtype=torch.float64)
    zh = {"a": base[:, 1:1001], "b": base[:, 1001:1004],
          "c": base[:, 1004:1027]}
    g = {k: torch.randn_like(v) for k, v in zh.items()}
    c = {k: torch.randn_like(v) for k, v in zh.items()}
    _one_launch_equals_plain(zh, g, c)


@pytest.mark.gpu
def test_leaf_table_refuses_what_it_does_not_take(cuda):
    a = {"w": torch.zeros(3, 4, device=cuda)}
    with pytest.raises(ValueError, match="different devices"):
        ops.fused_local_update(a, {"w": torch.zeros(3, 4)}, a, ETA, THRESH)
    with pytest.raises(ValueError, match="dtype"):
        ops.fused_local_update({"w": a["w"].int()}, a, a, ETA, THRESH)
    with pytest.raises(ValueError, match="does not match"):
        ops.fused_local_update(a, {"w": torch.zeros(3, 5, device=cuda)}, a,
                               ETA, THRESH, batch_dims=1)


# -- flash attention ----------------------------------------------------------

_FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}


def _flash_inputs(cuda, b, s, h, kh, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randn((b, s, n, d), generator=gen, device=cuda) * 0.5)
            .to(dtype) for n in (h, kh, kh)]


def _flash_plain(q, k, v, **kw):
    rep = q.shape[2] // k.shape[2]
    return flash_attention.flash_attention_plain(
        q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
        v.repeat_interleave(rep, 2).transpose(1, 2), **kw).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,h,kh,causal,window,softcap", [
    (200, 4, 2, True, None, None),      # GQA, S not a multiple of a tile
    (333, 4, 1, True, 70, 50.0),        # MQA, window + softcap
    (130, 2, 2, False, None, None),     # not causal
    (64, 8, 4, True, 1, None),          # window 1: the diagonal only
])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, d, s, h, kh, causal,
                                            window, softcap):
    q, k, v = _flash_inputs(cuda, 2, s, h, kh, d, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.flash_attention_bshd.launches
    got = flash_attention.flash_attention_bshd(q, k, v, **kw)
    exp = _flash_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bshd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - exp.float()).abs().max())
    assert err <= _FLASH_TOL[dtype], err


# the check above cannot see a dropped softcap or a shifted window: at inputs
# x 0.5 the logits are ~0.25, so the softcap never bends them and the softmax
# is near uniform.  Here q and k give scaled logits of std 16 (sd * sd) and
# each output row is held to its own size against the plain version in
# float32: ||got - exp|| / ||exp||.  bf16 / f16 round the probabilities and
# the output (2^-8 / 2^-11 each); f32 differs by summation order only.
_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _row_rel_err(got, exp):
    g, e = got.float().flatten(0, 2), exp.float().flatten(0, 2)
    return float(((g - e).norm(dim=1) / e.norm(dim=1)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,h,kh,causal,window,softcap", [
    (333, 4, 1, True, 70, 20.0),        # MQA, window + softcap
    (200, 4, 2, True, None, 20.0),      # GQA, softcap, ragged S
    (130, 2, 2, False, None, None),     # not causal
])
def test_flash_kernel_matches_plain_at_large_logits(cuda, dtype, d, s, h, kh,
                                                    causal, window, softcap):
    """Logits large enough that the softcap bends them and the softmax is
    peaked; controls (softcap dropped, window moved by 32 keys, causal
    flipped) move the plain version by 10x the tolerance, so a kernel
    without the feature would fail."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(3)
    sd = 4.0
    q, k, v = [(torch.randn((2, s, n, d), generator=gen, device=cuda) * f)
               .to(dtype) for n, f in ((h, sd), (kh, sd), (kh, 1.0))]
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention.flash_attention_bshd(q, k, v, **kw)
    q, k, v = q.float(), k.float(), v.float()
    exp = _flash_plain(q, k, v, **kw)
    assert _row_rel_err(got, exp) <= _ROW_TOL[dtype]
    controls = [dict(kw, causal=not causal)]
    if softcap is not None:
        controls.append(dict(kw, softcap=None))
    if window is not None:
        controls += [dict(kw, window=w) for w in (window - 32, window + 32)]
    for ckw in controls:
        diff = _row_rel_err(_flash_plain(q, k, v, **ckw), exp)
        assert diff >= 10 * _ROW_TOL[dtype], (ckw, diff)


# The tensor-core kernel's tiling: 128-row blocks of two 64-row warpgroups,
# kv tiles of BK = 80 keys at D = 256 and 128 below. S below one tile, at
# and around the tile edges and ragged; windows of 1, 33, BK - 1, BK, BK + 1
# and beyond S; groups of 1-16 query heads per kv head; B = 3; q, k, v cut
# as strided views from one fused (B, S, H + 2K, D) projection. Each case at
# the reference's tolerance and at the large-logit row tolerance with its
# controls (those that change the mask or the logits).
_BF, _F16 = torch.bfloat16, torch.float16
_TILING_CASES = [
    # s, d, group, kh, causal, window, softcap, dtype
    (1, 64, 1, 1, True, None, None, _BF),
    (17, 256, 2, 2, True, None, 50.0, _BF),
    (63, 128, 4, 1, True, None, None, _F16),
    (64, 64, 8, 1, True, None, None, _BF),
    (65, 256, 1, 2, True, None, 30.0, _F16),
    (127, 128, 2, 1, True, None, None, _BF),
    (128, 256, 16, 1, True, None, 50.0, _BF),
    (129, 64, 4, 2, False, None, None, _BF),
    (1000, 128, 8, 1, True, None, None, _BF),
    (4609, 256, 2, 1, True, None, 50.0, _BF),
    *[(300, 256, 2, 1, True, w, 50.0, _BF) for w in (1, 33, 79, 80, 81, 305)],
    *[(300, 128, 2, 1, True, w, None, _F16) for w in (1, 33, 127, 128, 129,
                                                       305)],
    *[(200, 128, g, 2, g != 4, None, None, _BF) for g in (1, 2, 4, 8, 16)],
]


def _flash_views(cuda, b, s, h, kh, d, dtype, qk_scale, v_scale, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, s, h + 2 * kh, d), generator=gen, device=cuda)
    x[:, :, :h + kh] *= qk_scale
    x[:, :, h + kh:] *= v_scale
    x = x.to(dtype)
    return x[:, :, :h], x[:, :, h:h + kh], x[:, :, h + kh:]


def _mask(s, causal, window):
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    if not causal:
        return torch.ones(s, s, dtype=torch.bool)
    ok = j <= i
    return ok & (j > i - window) if window is not None else ok


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,group,kh,causal,window,softcap,dtype",
                         _TILING_CASES, ids=lambda x: str(x).replace(
                             "torch.", ""))
def test_flash_kernel_tiling_on_card(cuda, s, d, group, kh, causal, window,
                                     softcap, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h = 3, kh * group
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _flash_views(cuda, b, s, h, kh, d, dtype, 0.5, 0.5, seed=s)
    assert not q.is_contiguous() and not k.is_contiguous()
    before = flash_attention.flash_attention_bshd.launches
    got = flash_attention.flash_attention_bshd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bshd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - _flash_plain(q, k, v, **kw).float())
                .abs().max())
    assert err <= _FLASH_TOL[dtype], err

    q, k, v = _flash_views(cuda, b, s, h, kh, d, dtype, 4.0, 1.0, seed=s + 1)
    got = flash_attention.flash_attention_bshd(q, k, v, **kw)
    q, k, v = q.float(), k.float(), v.float()
    exp = _flash_plain(q, k, v, **kw)
    assert _row_rel_err(got, exp) <= _ROW_TOL[dtype]
    mask = _mask(s, causal, window)
    controls = [dict(kw, causal=not causal)]
    if softcap is not None:
        controls.append(dict(kw, softcap=None))
    if window is not None:
        controls += [dict(kw, window=w) for w in (window - 32, window + 32)
                     if w >= 1]
    one_key = bool((mask.sum(1) == 1).all())  # softmax of one logit: 1
    checked = 0
    for ckw in controls:
        same_mask = torch.equal(_mask(s, ckw["causal"], ckw["window"]), mask)
        if same_mask and (ckw["softcap"] == softcap or one_key):
            continue  # the same function: nothing to see
        diff = _row_rel_err(_flash_plain(q, k, v, **ckw), exp)
        assert diff >= 10 * _ROW_TOL[dtype], (ckw, diff)
        checked += 1
    assert checked or s == 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_kernel_tile_plan_is_the_python_plan(cuda, d):
    """The compiled kernel's tile sizes and its kv_tiles / tile_masked, run
    on the host, give the plan that tests/test_torch_flash.py holds against
    a brute-force mask: an edit to either side shows here."""
    bk = flash_attention.block_k(d)
    for s in (1, 17, 64, 65, 127, 128, 129, 1000, 4608, 4609):
        for causal in (True, False):
            for window in (None, 1, 33, bk - 1, bk, bk + 1, 4096, s + 1):
                kw = dict(causal=causal, window=window)
                assert flash_attention.kernel_tile_plan(s, d, **kw) == \
                    flash_attention.warpgroup_plan(s, d, **kw), (s, kw)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views of one fused (B, S, H + 2K, D) projection: read in
    place through their strides."""
    b, s, h, kh, d = 2, 150, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = (torch.randn((b, s, h + 2 * kh, d), generator=gen, device=cuda)
           * 0.5).to(torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    assert not q.is_contiguous()
    got = ops.gqa_flash_attention(q, k, v, causal=True, softcap=30.0)
    exp = _flash_plain(q, k, v, causal=True, softcap=30.0)
    assert float((got.float() - exp.float()).abs().max()) <= 3e-2


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_bshd(q, q, q)
    q = torch.zeros(1, 16, 2, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_bshd(q, q, q)
    base = torch.zeros(1, 16, 2, 65, device=cuda, dtype=torch.bfloat16)
    q = base[..., 1:]  # off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention_bshd(q, q, q)


@pytest.mark.gpu
def test_serving_on_card_launches_the_kernel_per_layer(cuda):
    """Prefill on the card takes the flash kernel once per layer, greedy
    serve equals sequential generate, and the logits match the CPU run."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.utils import tree as tu

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = registry.get_smoke("gemma2_9b")  # head_dim 32: not a kernel width
    cfg = smoke.with_overrides(param_dtype=torch.float32,
                               attn=dataclasses.replace(smoke.attn,
                                                        head_dim=64))
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    params_cuda = tu.tree_map(lambda x: x.to(cuda), params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 80))
    before = flash_attention.flash_attention_bshd.launches
    lg, _, _ = T.prefill(params_cuda, cfg,
                         {"tokens": torch.as_tensor(toks, device=cuda)},
                         max_len=96)
    assert flash_attention.flash_attention_bshd.launches == before + 2
    exp, _, _ = T.prefill(params, cfg, {"tokens": torch.as_tensor(toks)},
                          max_len=96)
    tol = 1e-4 * float(exp.abs().max())
    assert float((lg.cpu() - exp).abs().max()) <= tol
    eng = ServingEngine(cfg, params_cuda, max_len=96, device=cuda)
    reqs = [Request(id=i, prompt=toks[i % 2, :40 + 20 * i],
                    max_new_tokens=6) for i in range(3)]
    for r in eng.serve(reqs, slots=2, segment=4):
        seq = eng.generate(reqs[r.id].prompt[None], max_new_tokens=6)
        np.testing.assert_array_equal(r.tokens, seq.tokens[0])


# ---------------------------------------------------------------------------
# the Fig. 4 CNN
# ---------------------------------------------------------------------------


def _cnn_tree(cuda, n, seed):
    """The CNN's 10 leaves (2-D to 5-D, 10 to 100,352 floats a client) with a
    leading client axis of ``n``, float32, NaN / -0 / inf / THRESH
    injected."""
    from repro_torch.models import cnn

    gen = torch.Generator(device=cuda).manual_seed(seed)
    t = {k: torch.randn((n,) + tuple(v.shape), generator=gen, device=cuda)
         for k, v in cnn.init_params(0, device="cpu").items()}
    t["conv1_b"][0, :4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                        THRESH])
    t["fc3_b"][1, :2] = torch.tensor([-float("inf"), 0.0])
    return t


@pytest.mark.gpu
def test_fused_update_on_the_cnn_tree_is_one_launch_on_card(cuda):
    """Kernel 1 on Fig. 4's tree (10 clients, d = 112,394, float32): from
    contiguous leaves, then from views of the previous output planes with c
    broadcast from one row: one launch, no copy, bitwise."""
    zh, g, c = (_cnn_tree(cuda, 10, s) for s in range(3))
    assert sum(v[0].numel() for v in zh.values()) == 112_394
    zh2, _ = _one_launch_equals_plain(zh, g, c)
    cb = {k: v[3][None].expand_as(v) for k, v in c.items()}
    _one_launch_equals_plain(zh2, g, cb)


@pytest.mark.gpu
def test_cnn_on_card_runs_without_tf32_and_matches_the_cpu(cuda):
    """The CNN's forward and gradient on the card equal the CPU's within
    float32 summation order: its convolutions run with TF32 off (cuDNN
    allows TF32 by default), and the global setting comes back after."""
    import numpy as np

    from repro_torch.data import mnist_like
    from repro_torch.models import cnn

    assert torch.backends.cudnn.allow_tf32  # PyTorch's default
    with cnn.full_fp32():
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cudnn.allow_tf32
    tx, ty, _, _ = mnist_like.generate(n_train=100, n_test=10, seed=0)
    p_cpu = cnn.init_params(0, device="cpu")
    p = {k: v.to(cuda) for k, v in p_cpu.items()}
    batch = {"x": torch.from_numpy(tx[:64]), "y": torch.from_numpy(ty[:64])}
    got = cnn.forward(p, batch["x"].to(cuda)).cpu()
    exp = cnn.forward(p_cpu, batch["x"])
    assert float((got - exp).abs().max()) <= 1e-5 * float(exp.abs().max())
    loss, grads = cnn.make_grad_fn()(p, {k: v.to(cuda)
                                         for k, v in batch.items()})
    e_loss, e_grads = cnn.make_grad_fn()(p_cpu, batch)
    assert abs(float(loss) - float(e_loss)) <= 1e-5 * abs(float(e_loss))
    for k in grads:
        scale = float(e_grads[k].abs().max())
        assert float((grads[k].cpu() - e_grads[k]).abs().max()) <= \
            1e-4 * scale, k
    assert cnn.accuracy(p, tx, ty) == cnn.accuracy(p_cpu, tx, ty)
    assert np.isfinite(float(loss))


@pytest.mark.gpu
@pytest.mark.parametrize("device_cache", [False, True],
                         ids=["pinned", "device_cache"])
def test_prefetched_chunks_on_card_equal_unprefetched(cuda, device_cache):
    """Chunks staged on the side stream (pinned host gather + copy, or the
    device gather) equal the unprefetched supplier's, bitwise."""
    import numpy as np

    from repro_torch.exec import ArraySupplier

    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(30, 100, 20)),
              "y": rng.normal(size=(30, 100))}
    plain = ArraySupplier(arrays, 10, 16, seed=2, device_cache=device_cache,
                          device=cuda)
    pre = ArraySupplier(arrays, 10, 16, seed=2, device_cache=device_cache,
                        prefetch=True, device=cuda)
    try:
        for start, n in ((0, 8), (8, 8), (16, 8), (24, 5), (29, 8)):
            a, b = plain.sample_chunk(start, n), pre.sample_chunk(start, n)
            for k in a:
                assert b[k].is_cuda
                assert torch.equal(torch.as_tensor(a[k], device=cuda), b[k])
    finally:
        pre.close()


@pytest.mark.gpu
def test_overlapped_sender_fetches_a_chunk_while_the_next_runs(cuda):
    """The runtime sender's stream hand-off: a chunk recorded on the
    compute stream and fetched on the side stream, while the compute stream
    already runs the next chunk's work, has the bytes the blocking fetch
    reads after a full synchronise."""
    from repro_torch.fed.runtime import _UplinkSender

    sender = _UplinkSender(None, 0, None, None, "dense", "overlapped", 4,
                           None, cuda)
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        a = torch.randn(2048, 2048, generator=gen, device=cuda,
                        dtype=torch.float64)
        msgs = torch.empty(4, 30, 4096, device=cuda, dtype=torch.float64)
        # the chunk is written by long work just before the hand-off ...
        for _ in range(4):
            a = a @ a / a.norm()
        msgs.copy_(a.reshape(-1)[:msgs.numel()].reshape(msgs.shape))
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(cuda))
        # ... and the next chunk's work is queued behind it
        nxt = a
        for _ in range(8):
            nxt = nxt @ nxt / nxt.norm()
        host = sender._fetch({"m": msgs, "x": msgs[0, 0]}, ready)
        torch.cuda.synchronize()
        assert host["m"].tobytes() == msgs.cpu().numpy().tobytes()
        assert host["x"].tobytes() == msgs[0, 0].cpu().numpy().tobytes()
        assert bool(torch.isfinite(nxt).all())
    finally:
        sender.finish()


@pytest.mark.gpu
def test_runtime_overlapped_equals_blocking_on_card(cuda):
    """Server (thread) and worker on the card at a small width: the
    overlapped mode's server fields and bytes are the blocking mode's, and
    both are the single-process run's, bitwise."""
    import threading

    from repro_torch.fed import runtime as rt

    def pair(mode):
        a = rt.RuntimeArgs(clients=8, m=16, dim=4096, tau=2, rounds=8,
                           chunk=2, mode=mode, timeout=30.0, plane=True,
                           transport="topk", ratio=0.1)
        box, ready = {}, threading.Event()

        def srv():
            box["server"] = rt.run_server(
                a, ready_cb=lambda p: (box.update(port=p), ready.set()))

        t = threading.Thread(target=srv, daemon=True)
        t.start()
        assert ready.wait(30)
        a.port = box["port"]
        box["worker"] = rt.run_worker(a, rank=0)
        t.join(30)
        return a, box

    a, b = pair("blocking")
    _, o = pair("overlapped")
    local = rt.run_local(a)
    assert rt._fields_bitwise(b["server"]["fields"], o["server"]["fields"])
    assert rt._fields_bitwise(local["fields"], o["server"]["fields"])
    assert b["worker"]["bytes_sent"] == o["worker"]["bytes_sent"]
    assert o["server"]["max_replay_drift"] <= 1e-12


# -- the flash-attention backward (kernel 5b) and LM training -----------------

# dq, dk, dv against the plain backward in float64, each within
# _BWD_TOL x its max |.| (summation order in float32; measured <= 1.3e-5 at
# logits of std 16 in chip_smoke phase 15)
_BWD_TOL = 1e-4


def _bwd_rel(got, exp):
    return max(float((g.double() - e).abs().max() / e.abs().max())
               for g, e in zip(got, exp))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,h,kh,causal,window,softcap", [
    (333, 4, 1, True, 70, 20.0),        # MQA, window + softcap, ragged S
    (200, 4, 2, True, None, None),      # GQA
    (130, 2, 2, False, None, 20.0),     # not causal
    (64, 8, 4, True, 1, None),          # window 1: the diagonal only
])
def test_flash_backward_kernel_matches_plain_on_card(cuda, d, s, h, kh,
                                                     causal, window,
                                                     softcap):
    gen = torch.Generator(device=cuda).manual_seed(d + s)
    q, k, v = (torch.randn((2, s, n, d), generator=gen, device=cuda) * f
               for n, f in ((h, 2.0), (kh, 2.0), (kh, 1.0)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.flash_attention_bshd.launches
    out, lse = flash_attention.flash_attention_bshd(q, k, v, with_lse=True,
                                                    **kw)
    assert flash_attention.flash_attention_bshd.launches == before + 1
    f64 = [t.double() for t in (q, k, v)]
    assert float((lse.double() - flash_attention.lse_plain(*f64[:2], **kw))
                 .abs().max()) <= 1e-4
    do = torch.randn(out.shape, generator=gen, device=cuda)
    before = flash_attention.flash_attention_bwd.launches
    got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd.launches == before + 1
    exp = flash_attention.flash_attention_backward_plain(
        *f64, out.double(), do.double(), **kw)
    if window == 1:
        # each row attends to itself alone: p = 1 and dp = delta, so dq and
        # dk are 0 up to the float32 rounding of dp - delta
        assert _bwd_rel(got[2:], exp[2:]) <= _BWD_TOL
        scale = float(exp[2].abs().max())
        assert all(float(g.abs().max()) <= 1e-5 * scale for g in got[:2])
    else:
        assert _bwd_rel(got, exp) <= _BWD_TOL


# the float32 kernels' tiles are 64 query rows (128 at D = 128) by 64 keys
# (32 at D = 256), dK/dV blocks of 64 keys (32 at D = 256): a ragged S of
# 200 with GQA group 4 and windows that end just inside, on and just past a
# 64-key tile edge, so tiles meet the diagonal, the window's lower edge and
# S at every offset
_F32_EDGES = [(d, w) for d in (64, 128, 256) for w in (63, 64, 65)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,window", _F32_EDGES)
def test_flash_f32_kernels_at_tile_edges_on_card(cuda, d, window):
    gen = torch.Generator(device=cuda).manual_seed(d + window)
    b, s, h, kh = 2, 200, 8, 2
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=cuda) * f
               for n, f in ((h, 2.0), (kh, 2.0), (kh, 1.0)))
    kw = dict(causal=True, window=window, softcap=None)
    out, lse = flash_attention.flash_attention_bshd(q, k, v, with_lse=True,
                                                    **kw)
    f64 = [t.double() for t in (q, k, v)]
    assert _row_rel_err(out, _flash_plain(*f64, **kw)) <= _ROW_TOL[
        torch.float32]
    exp_lse = flash_attention.lse_plain(*f64[:2], **kw)
    assert float((lse.double() - exp_lse).abs().max()
                 / exp_lse.abs().max()) <= _LSE_RTOL
    do = torch.randn(out.shape, generator=gen, device=cuda)
    got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    exp = flash_attention.flash_attention_backward_plain(
        *f64, out.double(), do.double(), **kw)
    assert _bwd_rel(got, exp) <= _BWD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_f32_kernels_are_deterministic_on_card(cuda, d):
    """No atomics: two calls of the forward (output and lse) and of the
    backward (dq, dk, dv) on the same inputs are equal bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, 333, n, d), generator=gen, device=cuda)
               for n in (8, 2, 2))
    kw = dict(causal=True, window=100, softcap=30.0)
    first = flash_attention.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    second = flash_attention.flash_attention_bshd(q, k, v, with_lse=True,
                                                  **kw)
    assert all(_bits_equal(x, y) for x, y in zip(first, second))
    do = torch.randn(first[0].shape, generator=gen, device=cuda)
    grads = [flash_attention.flash_attention_bwd(q, k, v, *first[:1], do,
                                                 first[1], **kw)
             for _ in range(2)]
    assert all(_bits_equal(x, y) for x, y in zip(*grads))


# the float32 kernel's row log-sum-exp against lse_plain (float64), max
# |error| over max |lse|: the logits' summation order, at logits of std 16
_LSE_RTOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,h,kh,causal,window,softcap", [
    (333, 4, 1, True, 70, 20.0),        # MQA, window + softcap, ragged S
    (200, 8, 2, True, None, None),      # GQA group 4
    (130, 2, 2, False, None, 20.0),     # not causal
])
def test_flash_lse_matches_lse_plain_on_card(cuda, d, s, h, kh, causal,
                                             window, softcap):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k = (torch.randn((2, s, n, d), generator=gen, device=cuda) * 4.0
            for n in (h, kh))
    v = torch.randn((2, s, kh, d), generator=gen, device=cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, lse = flash_attention.flash_attention_bshd(q, k, v, with_lse=True,
                                                  **kw)
    exp = flash_attention.lse_plain(q.double(), k.double(), **kw)
    assert float((lse.double() - exp).abs().max()
                 / exp.abs().max()) <= _LSE_RTOL


@pytest.mark.gpu
def test_flash_backward_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="float32"):
        flash_attention.flash_attention_bwd(q, q, q, q, q, lse)
    q = torch.zeros(1, 16, 2, 320, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_bwd(q, q, q, q, q, lse)
    q = torch.zeros(1, 16, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_attention.flash_attention_bwd(q, q, q, q, q, lse[:, :1])


@pytest.mark.gpu
def test_vmap_of_grad_folds_clients_into_one_launch_on_card(cuda):
    """``vmap(grad_and_value)`` over 3 clients: one forward and one
    backward launch for all of them, each client's gradient equal to its
    own ``backward()`` (the same kernels on the same rows)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = {"q": torch.randn(3, 2, 64, 4, 64, generator=gen, device=cuda),
         "k": torch.randn(3, 2, 64, 2, 64, generator=gen, device=cuda),
         "v": torch.randn(3, 2, 64, 2, 64, generator=gen, device=cuda)}

    def f(p):
        out = ops.gqa_flash_attention(p["q"], p["k"], p["v"], window=9,
                                      softcap=5.0)
        return torch.sum(out * out)

    before = (flash_attention.flash_attention_bshd.launches,
              flash_attention.flash_attention_bwd.launches)
    grads, loss = torch.func.vmap(torch.func.grad_and_value(f))(p)
    assert (flash_attention.flash_attention_bshd.launches,
            flash_attention.flash_attention_bwd.launches) == (
                before[0] + 1, before[1] + 1)
    for i in range(3):
        pi = {k: v[i].clone().requires_grad_() for k, v in p.items()}
        f(pi).backward()
        for name in "qkv":
            torch.testing.assert_close(grads[name][i], pi[name].grad,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_lm_rounds_on_card_match_the_cpu(cuda):
    """The trainer's set-up (``launch.train.build``) with the smoke
    stablelm (head_dim 64), 2 clients, tau 2, 2 rounds: the card's losses
    and x_bar equal the CPU port's (rtol 1e-5; 1e-4 x max |x_bar|), kernels
    5 and 5b launched once per layer and local step, kernel 1 once per
    local step, no copy before it."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree as tu

    smoke = registry.get_smoke("stablelm_1_6b")
    cfg = smoke.with_overrides(param_dtype=torch.float32, attn=dataclasses
                               .replace(smoke.attn, head_dim=64))
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    res = {}
    for device in ("cuda", "cpu"):
        args = TR.parser().parse_args(["--device", device, "--clients", "2",
                                       "--tau", "2", "--rounds", "2"])
        run = TR.build(args, cfg=cfg, params=params)
        counts = (flash_attention.flash_attention_bshd.launches,
                  flash_attention.flash_attention_bwd.launches,
                  fused_prox.fused_local_update_2d.launches,
                  fused_prox.fused_local_update_2d.copies)
        state, m = run.engine.run(run.state, run.supplier, 2,
                                  rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        after = (flash_attention.flash_attention_bshd.launches,
                 flash_attention.flash_attention_bwd.launches,
                 fused_prox.fused_local_update_2d.launches,
                 fused_prox.fused_local_update_2d.copies)
        moved = tuple(a - b for a, b in zip(after, counts))
        assert moved == ((8, 8, 4, 0) if device == "cuda" else (0, 0, 0, 0))
        res[device] = (m["train_loss"], tu.tree_leaves(state.x_bar))
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    xmax = max(float(x.abs().max()) for x in res["cpu"][1])
    for a, b in zip(*(res[d][1] for d in ("cuda", "cpu"))):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * xmax


# -- kernels 5 and 5b at the head dims the kernels are not built at -------------
# hubert's 80 (bidirectional), MLA's Dk 192 with Dv 128 (causal), the smoke
# configs' 24 / 16 and 40: the wrapper pads q, k and v to the next kernel
# width (128, 256, 64) with the true 1/sqrt(Dk) scale and slices the output
# and gradients back.  One launch a call, and the tolerances of the kernel's
# own head dims.
_NEW_DIMS = [(80, 80, 4, 2, False), (80, 80, 4, 4, True),
             (192, 128, 4, 4, True), (24, 16, 4, 4, True),
             (40, 40, 4, 2, True)]


def _new_dim_inputs(cuda, s, h, kh, dk, dv, dtype, sd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randn((2, s, n, d), generator=gen, device=cuda) * f)
            .to(dtype) for n, d, f in ((h, dk, sd), (kh, dk, sd), (kh, dv, 1.0))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("s", [129, 200])
@pytest.mark.parametrize("dk,dv,h,kh,causal", _NEW_DIMS)
def test_flash_kernel_at_new_head_dims_matches_plain_on_card(
        cuda, dtype, s, dk, dv, h, kh, causal):
    """The reference's check (inputs x 0.5, max abs error) and the sharp one
    (logits of std 16, each row against its own size, a softcap of 20 that
    bends them), with the causal flag flipped as the control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _new_dim_inputs(cuda, s, h, kh, dk, dv, dtype, 0.5, s + dk)
    kw = dict(causal=causal)
    before = flash_attention.flash_attention_bshd.launches
    got = flash_attention.flash_attention_bshd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bshd.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, s, h, dv)
    exp = _flash_plain(q, k, v, **kw)
    assert float((got.float() - exp.float()).abs().max()) <= _FLASH_TOL[dtype]
    q, k, v = _new_dim_inputs(cuda, s, h, kh, dk, dv, dtype, 4.0, s + dk + 1)
    kw = dict(causal=causal, softcap=20.0)
    got = flash_attention.flash_attention_bshd(q, k, v, **kw)
    q, k, v = q.float(), k.float(), v.float()
    exp = _flash_plain(q, k, v, **kw)
    assert _row_rel_err(got, exp) <= _ROW_TOL[dtype]
    for ckw in (dict(kw, causal=not causal), dict(kw, softcap=None)):
        diff = _row_rel_err(_flash_plain(q, k, v, **ckw), exp)
        assert diff >= 10 * _ROW_TOL[dtype], (ckw, diff)


@pytest.mark.gpu
@pytest.mark.parametrize("dk,dv,h,kh,causal,window", [
    c + (w,) for c in _NEW_DIMS for w in ((None, 63, 64, 65) if c[-1]
                                          else (None,))])
def test_flash_f32_kernels_at_new_head_dims_on_card(cuda, dk, dv, h, kh,
                                                    causal, window):
    """Kernel 5 in float32 with the row log-sum-exp and kernel 5b at a
    ragged S of 200, windows at the 64-key tile edges (causal only),
    against the plain versions in float64; one launch of each."""
    gen = torch.Generator(device=cuda).manual_seed(dk + (window or 0))
    q, k, v = (torch.randn((2, 200, n, d), generator=gen, device=cuda) * f
               for n, d, f in ((h, dk, 2.0), (kh, dk, 2.0), (kh, dv, 1.0)))
    kw = dict(causal=causal, window=window, softcap=30.0)
    before = (flash_attention.flash_attention_bshd.launches,
              flash_attention.flash_attention_bwd.launches)
    out, lse = flash_attention.flash_attention_bshd(q, k, v, with_lse=True,
                                                    **kw)
    f64 = [t.double() for t in (q, k, v)]
    assert _row_rel_err(out, _flash_plain(*f64, **kw)) <= _ROW_TOL[
        torch.float32]
    exp_lse = flash_attention.lse_plain(*f64[:2], **kw)
    assert float((lse.double() - exp_lse).abs().max()
                 / exp_lse.abs().max()) <= _LSE_RTOL
    do = torch.randn(out.shape, generator=gen, device=cuda)
    got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_bshd.launches,
            flash_attention.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in
                                             (q, k, v)]
    exp = flash_attention.flash_attention_backward_plain(
        *f64, out.double(), do.double(), **kw)
    assert _bwd_rel(got, exp) <= _BWD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dk,dv", [(80, 80), (192, 128)])
def test_flash_f32_kernels_at_new_head_dims_are_deterministic(cuda, dk, dv):
    gen = torch.Generator(device=cuda).manual_seed(dk)
    q, k, v = (torch.randn((2, 333, n, d), generator=gen, device=cuda)
               for n, d in ((8, dk), (2, dk), (2, dv)))
    kw = dict(causal=True, window=100, softcap=30.0)
    first = flash_attention.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    second = flash_attention.flash_attention_bshd(q, k, v, with_lse=True,
                                                  **kw)
    assert all(_bits_equal(x.contiguous(), y.contiguous())
               for x, y in zip(first, second))
    do = torch.randn(first[0].shape, generator=gen, device=cuda)
    grads = [flash_attention.flash_attention_bwd(q, k, v, first[0], do,
                                                 first[1], **kw)
             for _ in range(2)]
    assert all(_bits_equal(x.contiguous(), y.contiguous())
               for x, y in zip(*grads))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_26b",
                                  "grok_1_314b", "deepseek_v3_671b"])
def test_zoo_smoke_models_on_card_match_the_cpu(cuda, arch):
    """The four smoke configs at their own head dims (32; MLA 24 / 16) in
    float32: the card's prefill logits (hubert: the encoder's, every
    frame) within 1e-4 x max |logit| of the CPU port's, one launch of
    kernel 5 per attention layer; then one vmapped gradient over two
    clients, kernel 5b once per attention layer, the loss at rtol 1e-5."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.device import full_fp32
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree as tu

    cfg = registry.get_smoke(arch).with_overrides(param_dtype=torch.float32)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    n_attn = cfg.n_layers
    batch = specs.example(cfg, 2, 40, seed=1, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        p = tu.tree_map(lambda x: x.to(device), params)
        b = tu.tree_map(lambda x: x.to(device), batch)
        before = flash_attention.flash_attention_bshd.launches
        with full_fp32():
            logits, _, _ = T.prefill(p, cfg, b)
        moved = flash_attention.flash_attention_bshd.launches - before
        assert moved == (n_attn if device == "cuda" else 0)
        two = tu.tree_map(lambda x: torch.stack([x, x.flip(0)]), b)
        before = flash_attention.flash_attention_bwd.launches
        loss, _ = torch.func.vmap(T.make_grad_fn(cfg), in_dims=(None, 0))(
            p, two)
        moved = flash_attention.flash_attention_bwd.launches - before
        assert moved == (n_attn if device == "cuda" else 0)
        out[device] = (logits.float().cpu(), loss.cpu())
    tol = 1e-4 * float(out["cpu"][0].abs().max())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= tol
    np.testing.assert_allclose(out["cuda"][1].numpy(), out["cpu"][1].numpy(),
                               rtol=1e-5)
