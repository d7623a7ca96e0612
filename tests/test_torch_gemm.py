"""The split-TF32 GEMM's wrapper on the CPU (``kernels/gemm``) and the
model's routing of its products (``models/layers._dense``).

The kernel itself runs only on the card (``tests/test_torch_split_gemm.py``);
here: the plain version's arithmetic against a float64 product, the layouts
the kernel reads in place, the autograd Function's backward and vmap rule
against ``torch.einsum``, and the routing helper, which on CPU tensors must
give the expressions it replaced bitwise.
"""
from collections import Counter

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import _build, gemm
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _rel(got, exp) -> float:
    got, exp = got.detach().double(), exp.detach().double()
    return float((got - exp).norm() / exp.norm())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plain version -----------------------------------------------------------


def test_split_matches_the_kernels_rounding():
    """hi is x rounded to 10 mantissa bits (half away from zero), lo the
    rest as the tensor core reads it (its top 10 mantissa bits)."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3, 0.0, -0.0])
    hi, lo = gemm._split(x)
    assert hi.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                           -(1.0 + 2 ** -10), hi[4].item(), 0.0, -0.0]
    assert lo[0] == 0 and lo[1] == -(2 ** -11) and lo[3] == 2 ** -11
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = gemm._split(y)
    # hi + lo recovers x to ~2^-22 of it: what dropping lo's low bits costs
    assert ((hi + lo - y).abs() <= y.abs() * 2 ** -21).all()


@pytest.mark.parametrize("mkn", [(64, 96, 80), (33, 130, 7), (1, 512, 200)])
def test_plain_version_is_float32_accurate(mkn):
    m, k, n = mkn
    g = torch.Generator().manual_seed(sum(mkn))
    a = torch.randn(3, m, k, generator=g)
    b = torch.randn(3, k, n, generator=g)
    exp = torch.matmul(a.double(), b.double())
    got = gemm.split_gemm_plain(a, b)
    f32 = torch.matmul(a, b)
    assert got.dtype == torch.float32 and got.shape == (3, m, n)
    assert _rel(got, exp) < 4 * max(_rel(f32, exp), 1e-7)
    # a shared operand broadcasts as torch.matmul does
    assert torch.equal(gemm.split_gemm(a, b[:1]), gemm.split_gemm_plain(a, b[:1]))


# -- the layouts the kernel reads in place -------------------------------------------


@pytest.mark.parametrize("case", ["row", "column", "shared", "odd_rows",
                                  "strided", "size1", "offset"])
def test_kernel_strides(case):
    base = torch.zeros(4, 64, 40)
    t, want = {
        "row": (base, (64 * 40, 40, 1)),
        "column": (base.mT, (64 * 40, 1, 40)),
        "shared": (base[:1], (0, 40, 1)),
        "odd_rows": (torch.zeros(2, 8, 7), None),      # rows of 28 bytes
        "strided": (base[:, :, ::2], None),            # neither axis unit
        "size1": (torch.zeros(3, 1, 8)[:, :, :5], (8, 4, 1)),
        "offset": (base.reshape(-1)[1:1 + 4 * 64 * 39].reshape(4, 64, 39),
                   None),                              # 4 bytes off 16
    }[case]
    assert gemm._kernel_strides(t) == want


def test_split_gemm_checks_its_operands():
    with pytest.raises(ValueError, match=r"\(Bt, M, K\)"):
        gemm.split_gemm(torch.zeros(2, 3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="neither is 1"):
        gemm.split_gemm(torch.zeros(2, 3, 4), torch.zeros(3, 4, 5))
    with pytest.raises(ValueError, match=r"\(Bt, M, K\)"):
        gemm.split_gemm(torch.zeros(1, 3, 4), torch.zeros(1, 5, 5))


# -- the variant a product launches, by its operands' layouts -------------------------


@pytest.mark.parametrize("case,trans", [
    ("x W", True),          # A K-major, B an N-major weight: C^T = W^T x^T
    ("dL E", True),         # the head's dX: B the embedding, N-major
    ("x E^T", False),       # the head: both K-major
    ("dY W^T", False),      # dX: both K-major
    ("X^T dY", False),      # dW: neither K-major
    ("X^T W^T", False),     # A M-major, B K-major: B is split as it is
])
def test_the_k_major_operand_is_the_one_split(case, trans):
    """The kernel computes ``C^T`` exactly where A is K-major and B is not
    (each side of the rule: the four layouts), read off the strides the
    kernel takes them with."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 64, 96, generator=g)
    w = torch.randn(96, 80, generator=g)
    a, b = {"x W": (x, w[None]), "dL E": (x, w[None]),
            "x E^T": (x, w.t().contiguous().t()[None]),
            "dY W^T": (x, torch.randn(80, 96, generator=g).t()[None]),
            "X^T dY": (x.mT, torch.randn(4, 64, 80, generator=g)),
            "X^T W^T": (x.mT, torch.randn(80, 64, generator=g).t()[None]),
            }[case]
    (_, _, a_k), (_, b_k, _) = gemm._kernel_strides(a), gemm._kernel_strides(b)
    assert gemm.transposed(a_k == 1, b_k == 1) is trans


@pytest.mark.parametrize("a_k,b_k,trans", [
    (True, False, True), (True, True, False), (False, False, False),
    (False, True, False)])
def test_transposed_is_a_pure_rule_of_the_layouts(a_k, b_k, trans):
    assert gemm.transposed(a_k, b_k) is trans


def test_the_launch_takes_the_layouts_variant_and_counts_it(monkeypatch):
    """A fake card: each launch hands the kernel the variant
    :func:`gemm.transposed` picks (the argument before the stream), and
    ``_build.launch`` counts the launches with the transposed ones beside
    them."""
    seen = []
    lib = type("Lib", (), {"repro_split_gemm": staticmethod(
        lambda *args: seen.append(args) or 0)})
    monkeypatch.setattr(_build, "on_card", lambda name, t: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 7)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(gemm, "_sm_count", lambda index: 132)
    before = _build.COUNTS.copy()
    x, w = torch.zeros(4, 320, 64), torch.zeros(64, 2048)
    for a, b in ((x, w[None]), (x, w.t().contiguous().t()[None]),
                 (x.mT.contiguous().mT, w[None]), (x, w[None])):
        gemm.split_gemm(a, b)
    # x W, x E^T (B K-major), an M-major A times W, x W
    assert [args[-2:] for args in seen] == [(1, 7), (0, 7), (0, 7), (1, 7)]
    assert _build.COUNTS - before == Counter(split_gemms=4,
                                             split_gemms_transposed=2)


# -- the autograd Function -----------------------------------------------------------


def _einsum_grads(spec, a, b, dy):
    a, b = a.detach().double().requires_grad_(), b.detach().double().requires_grad_()
    y = torch.einsum(spec, a, b)
    y.backward(dy.double())
    return y.detach(), a.grad, b.grad


@pytest.mark.parametrize("case", ["plain", "weight_transposed"])
def test_function_and_its_backward_match_einsum(case):
    g = torch.Generator().manual_seed(1)
    a = torch.randn(12, 20, generator=g).requires_grad_()
    b = (torch.randn(20, 9, generator=g) if case == "plain"
         else torch.randn(9, 20, generator=g).t()).requires_grad_()
    (y,) = gemm.SplitGemm.apply(a, b)
    dy = torch.randn(y.shape, generator=g)
    y.backward(dy)
    ey, ea, eb = _einsum_grads("mk,kn->mn", a, b, dy)
    for got, exp in ((y, ey), (a.grad, ea), (b.grad, eb)):
        assert got.shape == exp.shape and _rel(got, exp) < 1e-6


@pytest.mark.parametrize("n", [2, 3])
def test_products_sharing_an_input_are_one_function(n, monkeypatch):
    """q, k and v (gate and up): one forward and one backward Function
    call, one launch a product and a gradient, ``dX`` the sum over the
    products."""
    calls = []
    real = gemm.split_gemm
    monkeypatch.setattr(gemm, "split_gemm",
                        lambda a, b: calls.append(1) or real(a, b))
    fold, folds = gemm._fold, []  # once in each Function's vmap rule
    monkeypatch.setattr(gemm, "_fold", lambda d, ts: folds.append(
        len(ts)) or fold(d, ts))
    g = torch.Generator().manual_seed(6)
    x = torch.randn(4, 3, 5, 16, generator=g)
    ws = [torch.randn(4, 16, 8 + i, generator=g) for i in range(n)]

    def loss(x, *ws, mm):
        return sum(torch.tanh(y).sum() * (i + 1)
                   for i, y in enumerate(mm(x, *ws)))

    argnums = tuple(range(n + 1))
    got = torch.func.vmap(torch.func.grad(
        lambda x, *ws: loss(x, *ws, mm=gemm.matmuls), argnums=argnums))(x, *ws)
    assert folds == [1 + n, 1 + 2 * n] and len(calls) == 3 * n
    want = torch.func.vmap(torch.func.grad(
        lambda x, *ws: loss(x, *ws, mm=lambda x, *ws: [x @ w for w in ws]),
        argnums=argnums))(x.double(), *(w.double() for w in ws))
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 1e-6


@pytest.mark.parametrize("act", [L.swiglu, L.gelu_mul], ids=["swiglu", "gelu"])
def test_the_mlp_is_one_function_and_matches_autograd(act, monkeypatch):
    """The gated MLP under ``vmap(grad)`` over 4 clients: one forward and
    one backward Function call, a launch a product and a gradient (3 + 6),
    gradients autograd's of the plain float64 MLP."""
    calls = []
    real = gemm.split_gemm
    monkeypatch.setattr(gemm, "split_gemm",
                        lambda a, b: calls.append(1) or real(a, b))
    fold, folds = gemm._fold, []
    monkeypatch.setattr(gemm, "_fold", lambda d, ts: folds.append(
        len(ts)) or fold(d, ts))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4, 2, 5, 16, generator=g)
    wg, wu = (torch.randn(4, 16, 24, generator=g) * 0.3 for _ in range(2))
    wd = torch.randn(4, 24, 16, generator=g) * 0.3

    def loss(x, wg, wu, wd, mlp):
        return torch.tanh(mlp(x, wg, wu, wd)).sum()

    argnums = (0, 1, 2, 3)
    got = torch.func.vmap(torch.func.grad(lambda *t: loss(
        *t, lambda x, wg, wu, wd: gemm.mlp(x, wg, wu, wd, act)),
        argnums=argnums))(x, wg, wu, wd)
    assert folds == [4, 7] and len(calls) == 9
    want = torch.func.vmap(torch.func.grad(lambda *t: loss(
        *t, lambda x, wg, wu, wd: act(x @ wg, x @ wu) @ wd),
        argnums=argnums))(*(t.double() for t in (x, wg, wu, wd)))
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 1e-6


def test_weight_grad_comes_out_in_the_weights_layout():
    """The tied head ``x @ embed.t()``: the embedding's gradient is computed
    as (V, D) directly, so it is contiguous like the embedding."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(6, 16, generator=g)
    e = torch.randn(40, 16, generator=g)
    grad = torch.func.grad(lambda e: gemm.matmuls(x, e.t())[0].square().sum())(e)
    assert grad.shape == e.shape and grad.is_contiguous()
    assert _rel(grad, 2 * ((x @ e.t()).t() @ x)) < 1e-6


@pytest.mark.parametrize("fn", ["matmuls", "mlp"])
@pytest.mark.parametrize("how", ["backward_of_vmap", "grad_of_vmap"])
def test_vmap_rule_refuses_autograd_from_outside_the_vmap(how, fn):
    """The vmap rules run the forwards themselves, which autograd cannot
    see through: a gradient asked from outside the vmap raises instead of
    coming out short; ``vmap(grad)`` and a vmap without autograd run."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(4, 5, 16, generator=g)
    w = torch.randn(4, 16, 8, generator=g)
    wd = torch.randn(4, 8, 16, generator=g)
    f = {"matmuls": lambda x, w: gemm.matmuls(x, w)[0].square().sum(),
         "mlp": lambda x, w: gemm.mlp(x, w, w, wd[0], L.swiglu).square().sum(),
         }[fn]
    torch.func.vmap(torch.func.grad(f, argnums=(0, 1)))(x, w)
    with torch.no_grad():
        torch.func.vmap(f)(x.requires_grad_(), w)
    with pytest.raises(RuntimeError, match="vmap"):
        if how == "backward_of_vmap":
            torch.func.vmap(f)(x.requires_grad_(), w).sum().backward()
        else:
            torch.func.grad(lambda x: torch.func.vmap(f)(x, w).sum())(
                x.detach())


@pytest.mark.parametrize("mapped", ["both", "x_only", "w_only"])
def test_vmap_of_grad_folds_the_clients_into_one_call(mapped, monkeypatch):
    """``vmap(grad)`` over 4 clients calls the wrapper once for the forward
    product and once for each gradient, the clients as the batch (an
    unmapped operand shared, not expanded), and matches einsum."""
    calls = []
    real = gemm.split_gemm

    def counting(a, b):
        calls.append((tuple(a.shape), a.stride(0), tuple(b.shape), b.stride(0)))
        return real(a, b)

    monkeypatch.setattr(gemm, "split_gemm", counting)
    g = torch.Generator().manual_seed(3)
    n, bsz, s, k, m = 4, 2, 5, 16, 24
    x = torch.randn(n, bsz, s, k, generator=g)
    w = torch.randn(n, k, m, generator=g)
    in_dims = {"both": (0, 0), "x_only": (0, None), "w_only": (None, 0)}[mapped]
    if in_dims[0] is None:
        x = x[0]
    if in_dims[1] is None:
        w = w[0]

    def loss(x, w):
        return torch.tanh(gemm.matmuls(x, w)[0]).sum()

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                          in_dims=in_dims)(x, w)
    assert len(calls) == 3
    assert {c[0][0] for c in calls} | {c[2][0] for c in calls} <= {1, n}
    assert any(c[0][0] == n or c[2][0] == n for c in calls)
    for a_shape, a_b, b_shape, b_b in calls:  # a shared operand: stride 0
        assert a_shape[0] == n or a_b == 0 or a_shape[0] == 1
        assert b_shape[0] == n or b_b == 0 or b_shape[0] == 1

    def ref(x, w):
        return torch.tanh(torch.einsum("bsk,km->bsm", x, w)).sum()

    want = torch.func.vmap(torch.func.grad(ref, argnums=(0, 1)),
                           in_dims=in_dims)(x.double(), w.double())
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 1e-6


# -- the model's routing -------------------------------------------------------------


def _stablelm(dtype=torch.float32):
    cfg = registry.get_smoke("stablelm_1_6b").with_overrides(param_dtype=dtype)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    return cfg, params


def test_routing_helper_gives_the_old_expressions_bitwise_on_cpu():
    """Each routed call site on CPU tensors against the expression it
    replaced: ``_qkv``'s einsums, the output projection, the MLP and the
    tied head."""
    cfg, p = _stablelm()
    mixer = {k: v[0] for k, v in p["stack"]["b0"]["mixer"].items()}
    mp = {k: v[0] for k, v in p["stack"]["b0"]["mlp"].items()}
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 7, cfg.d_model, generator=g)
    q, k, v = L._qkv(mixer, x)
    for got, w in ((q, "wq"), (k, "wk"), (v, "wv")):
        assert torch.equal(got, torch.einsum("bsd,dhk->bshk", x, mixer[w]))
    wo = mixer["wo"]
    out = torch.randn(2, 7, *wo.shape[:2], generator=g)
    (y,) = L._dense(out, (wo,), 2,
                    lambda: (torch.einsum("bshk,hkd->bsd", out, wo),))
    assert torch.equal(y, torch.einsum("bshk,hkd->bsd", out, wo))
    exp = L.swiglu(x @ mp["w_gate"], x @ mp["w_up"]) @ mp["w_down"]
    assert torch.equal(L.mlp(mp, x), exp)
    xn = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    assert torch.equal(T._logits(p, cfg, x), xn @ p["embed"].t())


class _Operand:
    """What the routing reads of a tensor: its device and dtype."""

    def __init__(self, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype


@pytest.mark.parametrize("rows,device,dtype,routed", [
    (2, "cuda", torch.float32, False),  # a decode step's batch
    (L.KERNEL_MIN_ROWS - 1, "cuda", torch.float32, False),
    (L.KERNEL_MIN_ROWS, "cuda", torch.float32, True),
    (512, "cuda", torch.float32, True),  # a client's batch in training
    (512, "cuda", torch.bfloat16, False),
    (512, "cpu", torch.float32, False),
])
def test_routing_takes_float32_cuda_products_of_enough_rows(rows, device,
                                                            dtype, routed):
    """The kernel's tiles are 128 rows: it takes float32 products on the
    card from ``KERNEL_MIN_ROWS`` rows (half a tile) up; fewer rows, bf16
    and the CPU keep their plain expressions."""
    x = _Operand(device, dtype)
    ws = (_Operand(device, dtype), _Operand(device, dtype))
    assert L._on_kernel(x, ws, rows) is routed


def test_routing_helper_keeps_the_plain_path_for_fake_and_bf16_tensors():
    """Only float32 operands on a CUDA device go to the kernel: bf16 on the
    CPU and the engine's shape-only pass take the plain expression."""
    calls = []
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    w = torch.randn(8, 5, dtype=torch.bfloat16)
    got = L._dense(x, (w,), 1, lambda: calls.append(1) or (x @ w,))
    assert calls == [1] and torch.equal(got[0], x @ w)


def test_grad_of_the_model_on_cpu_never_calls_the_wrapper(monkeypatch):
    """The smoke stablelm's per-client gradient under vmap on the CPU: the
    routing leaves every product to its plain expression."""
    monkeypatch.setattr(gemm, "split_gemm", None)  # any call would raise
    cfg, p = _stablelm()
    params = {"embed": p["embed"], "final_norm": p["final_norm"],
              "stack": p["stack"]}
    both = torch.func.vmap(T.make_grad_fn(cfg), in_dims=(None, 0))
    tok = torch.randint(0, cfg.vocab, (2, 2, 9),
                        generator=torch.Generator().manual_seed(5))
    loss, grads = both(params, {"tokens": tok})
    assert loss.shape == (2,) and torch.isfinite(loss).all()
    assert grads["embed"].shape == (2, *p["embed"].shape)
