"""The split-TF32 GEMM kernel (``csrc/split_gemm.cu``) on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: the kernel
has no CPU mode.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_split_gemm.py

Accuracy is held to cuBLAS's own float32 product, in each of the kernel's
variants (C, or C^T where only A is K-major: ``gemm.transposed``): at
every product the stablelm cell runs (4 clients, 512 tokens each, d_model
2,048, d_ff 5,632, the vocabulary of 100,352), forward, dX and dW, the
kernel's error against a float64 product must be at most twice
``torch.matmul``'s at ``"highest"`` (float32 on the CUDA cores) on the
same inputs.
"""
from collections import Counter

import pytest
import torch

from repro_torch.kernels import _build, gemm
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

CLIENTS, TOKENS, D, F, V = 4, 512, 2048, 5632, 100_352


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel(got, exp) -> float:
    got, exp = got.double(), exp.double()
    return float((got - exp).norm() / exp.norm())


def _highest(a, b):
    from repro_torch.device import full_fp32

    with full_fp32():
        return torch.matmul(a, b)


def _operands(case, m, k, n, dev, seed):
    """``(a, b)`` of one of the model's products as the autograd Function
    hands them to the kernel: ``fwd`` x W (A K-major, B N-major), ``head``
    x E^T (B K-major), ``dx`` dY W^T (both K-major), ``head_dx`` dL E (B
    N-major), ``dw`` X^T dY (A M-major, B N-major)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    if case == "fwd":
        return r(CLIENTS, m, k), r(CLIENTS, k, n)
    if case == "head":
        return r(CLIENTS, m, k), r(CLIENTS, n, k).mT
    if case == "dx":
        return r(CLIENTS, m, k), r(CLIENTS, n, k).mT
    if case == "head_dx":
        return r(CLIENTS, m, k), r(CLIENTS, k, n)
    if case == "dw":
        return r(CLIENTS, k, m).mT, r(CLIENTS, k, n)
    raise ValueError(case)


# (case, M, K, N): every product of a local step of the stablelm cell
MAIN_PATH = [
    ("fwd", TOKENS, D, D), ("fwd", TOKENS, D, F), ("fwd", TOKENS, F, D),
    ("head", TOKENS, D, V),
    ("dx", TOKENS, D, D), ("dx", TOKENS, F, D), ("dx", TOKENS, D, F),
    ("head_dx", TOKENS, V, D),
    ("dw", D, TOKENS, D), ("dw", D, TOKENS, F), ("dw", F, TOKENS, D),
    ("dw", V, TOKENS, D),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,m,k,n", MAIN_PATH,
                         ids=[f"{c}-{m}x{k}x{n}" for c, m, k, n in MAIN_PATH])
def test_error_within_twice_cublas_at_the_main_path_shapes(cuda, case, m, k,
                                                           n):
    a, b = _operands(case, m, k, n, cuda, seed=m + k + n)
    before = _build.COUNTS.copy()
    got = gemm.split_gemm(a, b)
    # one launch, every operand read in place; x W and the head's dX (A
    # K-major, B an N-major weight) compute C^T
    assert _build.COUNTS - before == Counter(
        split_gemms=1,
        split_gemms_transposed=int(case in ("fwd", "head_dx")))
    exp = torch.matmul(a.double(), b.double())
    err, lib = _rel(got, exp), _rel(_highest(a, b), exp)
    assert err <= 2 * lib, f"split TF32 {err:.3e} vs cuBLAS float32 {lib:.3e}"


# (A K-major?, B K-major?) with ragged M, N, K (tails of every tile)
LAYOUTS = [(True, False), (True, True), (False, False), (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("a_k,b_k", LAYOUTS)
@pytest.mark.parametrize("mkn", [(200, 300, 70), (129, 8, 257), (1, 1000, 4)])
def test_every_layout_and_ragged_edge(cuda, a_k, b_k, mkn):
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    a = r(3, m, k) if a_k else r(3, k, m).mT
    b = r(3, n, k).mT if b_k else r(3, k, n)
    got = gemm.split_gemm(a, b)
    exp = torch.matmul(a.double(), b.double())
    assert got.shape == (3, m, n)
    assert _rel(got, exp) <= max(2 * _rel(_highest(a, b), exp), 1e-6)
    # the kernel's arithmetic is the plain version's, summed in another order
    assert _rel(got, gemm.split_gemm_plain(a, b)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shared", ["a", "b"])
def test_batch_stride_zero_shares_an_operand(cuda, shared):
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(1 if shared == "a" else 4, 300, 256, generator=g,
                    device=cuda)
    b = torch.randn(1 if shared == "b" else 4, 256, 200, generator=g,
                    device=cuda)
    assert gemm._kernel_strides(a if shared == "a" else b)[0] == 0
    got = gemm.split_gemm(a, b)
    exp = torch.matmul(a.double(), b.double())
    assert got.shape == (4, 300, 200)
    for i in range(4):
        assert _rel(got[i], exp[i]) <= max(
            2 * _rel(_highest(a, b)[i], exp[i]), 1e-6)


# (M, K, N): one tile along M, 320 rows (three tiles, the serving
# prefill's), N and K off the tile multiples, M > N with one and with two
# tiles along N, a ragged N of 5 tiles over 2 of M
SHAPES = [(128, 300, 4100), (320, 1000, 2050), (385, 72, 1000),
          (1000, 200, 128), (1000, 520, 129), (256, 33, 520)]


@pytest.mark.gpu
@pytest.mark.parametrize("a_k,b_k", LAYOUTS)
@pytest.mark.parametrize("shared", [None, "a", "b"])
@pytest.mark.parametrize("mkn", SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n in SHAPES])
def test_each_variant_and_layout_within_twice_cublas(cuda, a_k, b_k, shared,
                                                     mkn):
    """Both variants (C, and C^T where only A is K-major), K-major and
    N-major B with M-major and K-major A, a batch-shared operand (batch
    stride 0): each launch counted in its variant, the error within twice
    cuBLAS float32's (both against float64; 1e-6 at the least, as the
    ragged-edge test)."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(m + 7 * k + n)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    na, nb = (1 if shared == "a" else 3), (1 if shared == "b" else 3)
    a = r(na, m, k) if a_k else r(na, k, m).mT
    b = r(nb, n, k).mT if b_k else r(nb, k, n)
    # an operand whose rows are off a 16-byte multiple is copied with its
    # last axis contiguous first (A then K-major, B N-major)
    sa, sb = gemm._kernel_strides(a), gemm._kernel_strides(b)
    a_km, b_km = sa is None or sa[2] == 1, sb is not None and sb[1] == 1
    before = _build.COUNTS.copy()
    got = gemm.split_gemm(a, b)
    assert _build.COUNTS - before == Counter(
        split_gemms=1, split_gemms_transposed=int(a_km and not b_km),
        split_gemm_copies=(sa is None) + (sb is None))
    assert got.shape == (3, m, n)
    exp = torch.matmul(a.double(), b.double())
    lib = _highest(a, b)
    for i in range(3):
        assert _rel(got[i], exp[i]) <= max(2 * _rel(lib[i], exp[i]), 1e-6)


@pytest.mark.gpu
def test_unaligned_operands_are_copied_and_counted(cuda):
    a = torch.randn(2, 33, 31, device=cuda)  # rows of 124 bytes
    b = torch.randn(2, 31, 17, device=cuda)
    copies = _build.COUNTS["split_gemm_copies"]
    got = gemm.split_gemm(a, b)
    assert _build.COUNTS["split_gemm_copies"] == copies + 2
    assert _rel(got, torch.matmul(a.double(), b.double())) < 1e-5


@pytest.mark.gpu
def test_vmap_over_four_clients_is_one_launch(cuda):
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(CLIENTS, 4, 128, 256, generator=g, device=cuda)
    w = torch.randn(CLIENTS, 256, 384, generator=g, device=cuda)
    before = _build.COUNTS["split_gemms"]
    got = torch.func.vmap(lambda x, w: gemm.matmuls(x, w)[0])(x, w)
    assert _build.COUNTS["split_gemms"] == before + 1
    exp = torch.einsum("cbsk,ckn->cbsn", x.double(), w.double())
    assert _rel(got, exp) < 1e-6
    # an unmapped weight is shared (batch stride 0), still one launch
    got = torch.func.vmap(lambda x, w: gemm.matmuls(x, w)[0],
                          in_dims=(0, None))(x, w[0])
    assert _build.COUNTS["split_gemms"] == before + 2
    assert _rel(got, torch.einsum("cbsk,kn->cbsn", x.double(),
                                  w[0].double())) < 1e-6


@pytest.mark.gpu
def test_grad_through_the_function_matches_the_plain_version(cuda):
    """``vmap(grad)`` over 4 clients, as the local step takes it: one launch
    a product and a gradient for all clients, the gradients autograd's of
    the plain float64 products."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(CLIENTS, 2, 64, 256, generator=g, device=cuda)
    w = torch.randn(CLIENTS, 256, 320, generator=g, device=cuda) * 0.05
    e = torch.randn(CLIENTS, 500, 256, generator=g, device=cuda) * 0.05

    def loss(w, e, x, mm):
        h = torch.tanh(mm(x, w))
        return torch.log_softmax(mm(h[..., :256], e.t()), -1).mean()

    before = _build.COUNTS["split_gemms"]
    got = torch.func.vmap(torch.func.grad(
        lambda w, e, x: loss(w, e, x, lambda a, b: gemm.matmuls(a, b)[0]),
        argnums=(0, 1)))(w, e, x)
    # two products, dW of the first (x takes no gradient), dA and dE of
    # the second
    assert _build.COUNTS["split_gemms"] == before + 5
    want = torch.func.vmap(torch.func.grad(
        lambda w, e, x: loss(w, e, x, torch.matmul), argnums=(0, 1)))(
            w.double(), e.double(), x.double())
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 1e-5
    assert got[1].is_contiguous()  # the tied weight's gradient, (V, D)


@pytest.mark.gpu
def test_bf16_logits_and_mlp_stay_on_torch_matmul(cuda):
    from repro_torch.configs import registry

    cfg = registry.get_smoke("stablelm_1_6b").with_overrides(
        param_dtype=torch.bfloat16)
    p = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    mp = {k: v[0] for k, v in p["stack"]["b0"]["mlp"].items()}
    # rows enough for the kernel: only the dtype keeps it off
    x = torch.randn(2, L.KERNEL_MIN_ROWS, cfg.d_model, device=cuda,
                    dtype=torch.bfloat16)
    before = _build.COUNTS["split_gemms"]
    logits = T._logits(p, cfg, x)
    y = L.mlp(mp, x)
    assert _build.COUNTS["split_gemms"] == before
    xn = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    assert torch.equal(logits, xn @ p["embed"].t())
    assert torch.equal(y, L.swiglu(x @ mp["w_gate"], x @ mp["w_up"])
                       @ mp["w_down"])


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [1, L.KERNEL_MIN_ROWS // 2 - 1,
                                 L.KERNEL_MIN_ROWS // 2, 160])
def test_float32_rows_below_one_tile_stay_on_torch_matmul(cuda, seq):
    """float32 on the card, a batch of 2 rows of ``seq`` tokens: the head
    and the MLP launch the kernel (1 + 3 launches) from
    ``KERNEL_MIN_ROWS`` rows (2 x seq) up; a decode step's 2 rows, and any
    other count below, stay on ``torch.matmul``.  Either way the result is
    float32's."""
    from repro_torch.configs import registry

    cfg = registry.get_smoke("stablelm_1_6b").with_overrides(
        param_dtype=torch.float32)
    p = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    mp = {k: v[0] for k, v in p["stack"]["b0"]["mlp"].items()}
    x = torch.randn(2, seq, cfg.d_model, device=cuda)
    before = _build.COUNTS["split_gemms"]
    logits = T._logits(p, cfg, x)
    y = L.mlp(mp, x)
    routed = 2 * seq >= L.KERNEL_MIN_ROWS
    assert _build.COUNTS["split_gemms"] == before + (4 if routed else 0)
    xd = {k: v.double() for k, v in mp.items()}
    xn = L.rms_norm(x.double(), p["final_norm"].double(), cfg.norm_eps)
    assert _rel(logits, xn @ p["embed"].double().t()) < 1e-6
    assert _rel(y, L.swiglu(x.double() @ xd["w_gate"], x.double() @ xd["w_up"])
                @ xd["w_down"]) < 1e-6
