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
from repro_torch.kernels import fused_prox, ops, plane_ops

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
