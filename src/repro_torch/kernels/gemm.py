"""Float32 matrix products in split TF32 on the tensor cores: the CUDA
kernel's wrapper, its plain PyTorch version and the autograd Function the
model's products with its weights go through.

It replaces no TPU kernel: the JAX package leaves its products to XLA.  On
the card a float32 product would otherwise be cuBLAS's SIMT sgemm on the
CUDA cores (the model runs with TF32 off, :func:`repro_torch.device.
full_fp32`); the kernel (``csrc/split_gemm.cu``) takes it as three TF32
products on the tensor cores (``csrc/split_tf32.cuh``: x = hi + lo, lo hi
+ hi lo + hi hi, lo lo dropped) with each stage's sum added into a second
float32 accumulator rounding to nearest, which keeps float32's accuracy.

  * :func:`split_gemm_plain` -- the kernel's arithmetic in PyTorch: both
    operands split as the kernel splits them (hi by ``split_tf32``'s
    rounding, lo = x - hi as the tensor core reads it: its top 10 mantissa
    bits), the three products in float32;
  * :func:`split_gemm` -- ``C[b] = A[b] B[b]`` for ``(Bt, M, K)`` and
    ``(Bt, K, N)`` operands, a batch of 1 shared by all (batch stride 0).
    CUDA tensors launch the kernel, each operand read in place through its
    strides (rows or columns contiguous); an operand the kernel cannot read
    in place (neither axis contiguous, or a stride off a 16-byte multiple)
    is copied first.  :func:`transposed` picks, from the operands' layouts
    alone, whether the kernel computes ``C^T = B^T A^T``.  CPU tensors
    take the plain version;
  * :class:`SplitGemm` -- differentiable, for the products that share an
    input: ``apply(a, *bs)``, its backward the same kernel for ``dA =
    sum_i dC_i B_i^T`` and ``dB_i = A^T dC_i`` on transposed views
    (:class:`SplitGemmGrad`), and vmap rules that make the mapped (client)
    axis the kernel's batch, so ``torch.func.vmap`` over
    ``torch.func.grad`` makes one launch of each product for all clients;
  * :func:`matmuls` -- ``x @ w`` for ``x`` (..., K) and each of the ``w``
    (K, N), the model's entry (``models/layers._dense``); :func:`mlp`, the
    gated MLP's three products and its activation in one Function
    (:class:`SplitGemmMLP`), ``models/layers.mlp``'s.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import full_fp32
from repro_torch.kernels import _build

_ENCODE_FAILED = 1000  # csrc/split_gemm.cu: kEncodeFailed


def _split(x):
    """(hi, lo) of a float32 tensor as the kernel splits it: hi rounded to
    TF32 by ``split_tf32`` (add half an ulp of the 10-bit mantissa, clear
    the low 13 bits), lo = x - hi truncated to its top 10 mantissa bits, as
    the tensor core reads it."""
    bits = x.view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def split_gemm_plain(a, b):
    """``a @ b`` (``torch.matmul``'s broadcasting) in the kernel's
    arithmetic: ``lo_a hi_b + hi_a lo_b + hi_a hi_b``, each product in
    float32 (TF32 off), the small ones added first."""
    ah, al = _split(a.contiguous())
    bh, bl = _split(b.contiguous())
    with full_fp32():
        return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def transposed(a_k_major: bool, b_k_major: bool) -> bool:
    """Whether the kernel computes ``C^T = B^T A^T`` (and writes it
    transposed) rather than ``C = A B``: where A is read K-major and B is
    not (``x W`` and the head's ``dL E``, whose B is an N-major weight).
    The kernel splits its B operand into TF32 halves in shared memory, K-major
    as ``wgmma`` reads it; a K-major operand is split chunk for chunk, an
    N-major one transposed in the same pass, which takes the splitter warps
    longer than the tensor cores take for the stage.  So the K-major operand
    is the one split wherever there is one; dW (``X^T dY``, neither K-major)
    keeps the transposing pass."""
    return a_k_major and not b_k_major


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_strides(t):
    """``(batch, row, column)`` element strides under which the kernel reads
    the 3-D ``t`` in place -- one of row / column 1, the other and the
    batch's 16-byte multiples (an axis of size 1 takes any stride; a batch
    of 1 is shared, stride 0) -- or None if it cannot."""
    if t.data_ptr() % 16:
        return None
    nb, nr, nc = t.shape
    sb, sr, sc = t.stride()
    sb = 0 if nb == 1 else sb
    if sb % 4:
        return None
    if nc == 1 or sc == 1:
        if nr == 1 or sr % 4 == 0:
            return sb, (sr if nr > 1 else 4), 1
    if nr == 1 or sr == 1:
        if nc == 1 or sc % 4 == 0:
            return sb, 1, (sc if nc > 1 else 4)
    return None


def _in_place(t):
    """``(t, strides)`` for the kernel: ``t`` itself when it can be read in
    place, else a copy with its rows padded to a 16-byte multiple (counted
    as ``split_gemm_copies`` in ``_build.COUNTS``)."""
    st = _kernel_strides(t)
    if st is not None:
        return t, st
    nb, nr, nc = t.shape
    buf = t.new_zeros((nb, nr, -(-nc // 4) * 4))[..., :nc]
    buf.copy_(t)
    _build.count("split_gemm_copies")
    return buf, _kernel_strides(buf)


def _check(a, b):
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("split_gemm takes tensors")
    if a.device != b.device:
        raise ValueError(f"split_gemm: operands on different devices: "
                         f"{a.device}, {b.device}")
    if a.ndim != 3 or b.ndim != 3 or a.shape[2] != b.shape[1]:
        raise ValueError(f"split_gemm takes (Bt, M, K) and (Bt, K, N) "
                         f"operands; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] and 1 not in (a.shape[0], b.shape[0]):
        raise ValueError(f"split_gemm: batches {a.shape[0]} and {b.shape[0]} "
                         f"differ and neither is 1")


def split_gemm(a, b):
    """``C[i] = A[i] B[i]``: ``a`` (Bt, M, K), ``b`` (Bt, K, N) -> (Bt, M,
    N); an operand with a batch of 1 is shared by every entry.

    CPU tensors take :func:`split_gemm_plain`.  CUDA tensors launch the
    kernel, float32 only (anything else raises; nothing falls back), the
    output contiguous.
    """
    _check(a, b)
    if not _build.on_card("split_gemm", a):
        return split_gemm_plain(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"split_gemm kernel: float32 only, got {a.dtype}, "
                         f"{b.dtype}")
    bt = max(a.shape[0], b.shape[0])
    m, k, n = a.shape[1], a.shape[2], b.shape[2]
    c = torch.empty((bt, m, n), dtype=torch.float32, device=a.device)
    if k == 0:
        return c.zero_()
    if c.numel() == 0:
        return c
    a, (a_b, a_m, a_k) = _in_place(a)
    b, (b_b, b_k, b_n) = _in_place(b)
    trans = transposed(a_k == 1, b_k == 1)
    lib = _build.load_library()
    _build.launch(
        "split_gemm", lib.repro_split_gemm, a.device, a.data_ptr(),
        b.data_ptr(), c.data_ptr(), bt, m, n, k, a_b, a_m, a_k, b_b, b_k, b_n,
        m * n, n, _sm_count(a.device.index), int(trans),
        errors={_ENCODE_FAILED: "cuTensorMapEncodeTiled refused an "
                                "operand's layout"})
    if trans:
        _build.count("split_gemms_transposed")
    return c


def _mm(a, b):
    """``a @ b`` by :func:`split_gemm` for 2-D or 3-D operands (a 2-D one
    shared across the other's batch)."""
    out = split_gemm(a if a.ndim == 3 else a[None], b if b.ndim == 3 else b[None])
    return out if max(a.ndim, b.ndim) == 3 else out[0]


def _mm_like(t, x, y):
    """``x @ y`` laid out as ``t`` (its gradient): a transposed view of
    ``y^T x^T`` when ``t`` is column-major (a weight used as ``w.t()``), so
    a weight's gradient comes out in the weight's own layout."""
    if t.stride(-1) != 1 and t.stride(-2) == 1:
        return _mm(y.mT, x.mT).mT
    return _mm(x, y)


def _grads(needs, a, bs, dcs):
    """``(dA, dB...)`` of ``C_i = A B_i``: ``dA = sum_i dC_i B_i^T``, ``dB_i
    = A^T dC_i``, each in its operand's layout; None where ``needs`` is
    False."""
    da = None
    if needs[0]:
        for b, dc in zip(bs, dcs):
            g = _mm_like(a, dc, b.mT)
            da = g if da is None else da.add_(g)
    return (da, *(_mm_like(b, a.mT, dc) if need else None
                  for b, dc, need in zip(bs, dcs, needs[1:])))


def _fold(in_dims, ts):
    """A vmap rule's operands as one launch's: the mapped (client) axis
    first, the kernel's batch; an unmapped operand stays 2-D, shared by
    every client (batch stride 0), never expanded."""
    return [t if d is None else t.movedim(d, 0) for t, d in zip(ts, in_dims)]


def _out_dims(outs):
    return outs, tuple(None if o is None else 0 for o in outs)


class SplitGemm(torch.autograd.Function):
    """Differentiable :func:`split_gemm` for the products that share an
    input: ``apply(a, *bs) -> tuple(a @ b for b in bs)`` for ``a`` (M, K)
    and each ``b`` (K, N).  The backward is one :class:`SplitGemmGrad`
    call (``dA = sum_i dC_i B_i^T``, ``dB_i = A^T dC_i``).  Under one
    ``torch.func.vmap`` the mapped axis is the kernel's batch (an unmapped
    operand shared, never expanded), so each product is one launch for
    every client; the vmap rules run the forwards themselves, so they
    differentiate inside ``torch.func.grad`` only (``vmap(grad(f))``) and
    raise where autograd would have to see through them.  One Function
    for the products of one input (q, k and v; gate and up) because each
    Function call under ``vmap`` of ``grad`` costs the host far more than
    its launches (functorch's Python)."""

    @staticmethod
    def forward(a, *bs):
        return tuple(_mm(a, b) for b in bs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, *dcs):
        a, *bs = ctx.saved_tensors
        return SplitGemmGrad.apply(tuple(ctx.needs_input_grad), a, *bs, *dcs)

    @staticmethod
    def vmap(info, in_dims, a, *bs):
        _build.untracked("split_gemm", (a, *bs))
        return _out_dims(SplitGemm.forward(*_fold(in_dims, (a, *bs))))


class SplitGemmGrad(torch.autograd.Function):
    """``apply(needs, a, *bs, *dcs) -> (dA, *dBs)``, :class:`SplitGemm`'s
    backward (None where ``needs`` is False), with its own vmap rule (each
    client's gradients, the clients the kernel's batch).  Not
    differentiable itself."""

    @staticmethod
    def forward(needs, a, *rest):
        k = len(rest) // 2
        return _grads(needs, a, rest[:k], rest[k:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("split_gemm: no second derivative")

    @staticmethod
    def vmap(info, in_dims, needs, *ts):
        _build.untracked("split_gemm", ts)
        return _out_dims(SplitGemmGrad.forward(needs, *_fold(in_dims[1:], ts)))


class SplitGemmMLP(torch.autograd.Function):
    """The gated MLP ``act(x Wg, x Wu) Wd`` on :func:`split_gemm`, as one
    Function: ``apply(x, wg, wu, wd, act) -> (y, gate, up)`` for ``x`` (M,
    K) (``gate`` and ``up``, which the backward needs, are returned and
    take no gradient).  The backward is one :class:`SplitGemmMLPGrad`
    call, the activation's gradient PyTorch's own; the launches are the
    three products', as apart.  One call where :class:`SplitGemm` would
    take two, for the host's sake (see there)."""

    @staticmethod
    def forward(x, wg, wu, wd, act):
        gate, up = _mm(x, wg), _mm(x, wu)
        return _mm(act(gate, up), wd), gate, up

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, wg, wu, wd, ctx.act = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(x, wg, wu, wd, *output[1:])

    @staticmethod
    def backward(ctx, dy, _dgate, _dup):
        return (*SplitGemmMLPGrad.apply(tuple(ctx.needs_input_grad[:4]),
                                        ctx.act, *ctx.saved_tensors, dy), None)

    @staticmethod
    def vmap(info, in_dims, x, wg, wu, wd, act):
        _build.untracked("split_gemm", (x, wg, wu, wd))
        return _out_dims(SplitGemmMLP.forward(
            *_fold(in_dims[:4], (x, wg, wu, wd)), act))


class SplitGemmMLPGrad(torch.autograd.Function):
    """``apply(needs, act, x, wg, wu, wd, gate, up, dy) -> (dx, dwg, dwu,
    dwd)``, :class:`SplitGemmMLP`'s backward (None where ``needs`` is
    False), with its own vmap rule.  Not differentiable itself."""

    @staticmethod
    def forward(needs, act, x, wg, wu, wd, gate, up, dy):
        gate, up = gate.detach().requires_grad_(), up.detach().requires_grad_()
        with torch.enable_grad():
            h = act(gate, up)
        dg, du = torch.autograd.grad(h, (gate, up), _mm(dy, wd.mT))
        dwd = _mm_like(wd, h.detach().mT, dy) if needs[3] else None
        return (*_grads(needs[:3], x, (wg, wu), (dg, du)), dwd)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("split_gemm: no second derivative")

    @staticmethod
    def vmap(info, in_dims, needs, act, *ts):
        _build.untracked("split_gemm", ts)
        return _out_dims(SplitGemmMLPGrad.forward(
            needs, act, *_fold(in_dims[2:], ts)))


def mlp(x, wg, wu, wd, act):
    """``act(x @ wg, x @ wu) @ wd`` for ``x`` (..., K) through one
    :class:`SplitGemmMLP` call."""
    y = SplitGemmMLP.apply(x.reshape(-1, x.shape[-1]), wg, wu, wd, act)[0]
    return y.reshape(*x.shape[:-1], wd.shape[-1])


def matmuls(x, *ws):
    """``tuple(x @ w for w in ws)`` for ``x`` (..., K) and each ``w`` (K,
    N_i) through one :class:`SplitGemm` call: ``x``'s leading axes are the
    products' rows."""
    ys = SplitGemm.apply(x.reshape(-1, x.shape[-1]), *ws)
    return tuple(y.reshape(*x.shape[:-1], w.shape[-1]) for y, w in zip(ys, ws))
