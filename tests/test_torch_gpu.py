"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the kernel
has no CPU mode.  This file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import fused_prox, ops

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
