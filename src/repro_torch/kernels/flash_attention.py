"""Causal GQA flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

The port of the Pallas TPU kernel ``repro/kernels/flash_attention.py:_kernel``
(``flash_attention``, wrapped by ``repro/kernels/ops.py:gqa_flash_attention``):
softmax attention with an optional causal mask, sliding ``window`` (applied
under causal only, as ``repro/kernels/ref.py:flash_attention`` and the
model's attention apply it) and tanh logit ``softcap`` after the
``1/sqrt(D)`` scale.

  * :func:`flash_attention_plain` -- ``ref.flash_attention`` in PyTorch on
    the ``(B, H, S, D)`` layout with as many kv heads as query heads:
    float32 logits, scale, softcap, mask at -1e30, softmax, probabilities
    cast to ``v``'s dtype before the PV product;
  * :func:`flash_attention_bshd` -- the model's ``(B, S, H, D)`` queries
    against ``(B, S, K, D)`` keys and values (``H % K == 0``, query head
    ``h`` reads kv head ``h // (H/K)``).  CUDA tensors launch the kernel
    (``csrc/flash_attention.cu``), which reads the kv heads in place and
    any S (its ragged tail masked); CPU tensors repeat the kv heads and run
    the plain version.

The gradient: :func:`flash_attention_backward_plain` computes it in
PyTorch from the output and the rows' log-sum-exp, which the float32
kernel writes beside the output (``with_lse=True``);
:func:`flash_attention_bwd` launches its kernel on the card
(``csrc/flash_attention_bwd.cu``, float32; the Pallas kernel has no
backward: the reference differentiates its jnp attention).  The
``torch.autograd.Function`` s :class:`FlashAttention` and
:class:`FlashAttentionBackward` tie the two together, each with a vmap rule
that folds the mapped (client) axis into B, so ``torch.func.vmap`` over
``torch.func.grad_and_value`` makes one launch of each for all clients.

Head dims: the kernels are built at D = 64, 128 and 256 (``HEAD_DIMS``),
with v as wide as q and k.  Any other head dims up to 256 -- hubert's 80,
MLA's Dk 192 with Dv 128, the smoke configs' 24 to 40 -- run at the next
of those widths: the wrapper zero-pads q, k and v to it
(:func:`kernel_width`), launches with the true ``1/sqrt(Dk)`` scale and
slices the output (and, backward, dq and dk to Dk, dv to Dv).  The zero
columns add nothing to a logit, and the padded output and gradient
columns are zero, so the result is the unpadded attention's; the pad costs
its copies and the wider products.

The kernel accumulates in float32 and keeps the running softmax statistics
in float32; bfloat16 and float16 run on the tensor cores (``wgmma``, TMA
loads, a producer warp feeding two consumer warpgroups) with the
probabilities rounded to the input dtype for the PV product; float32 runs
its products on the tensor cores too, in split TF32 (each operand split
into two TF32 parts, three TF32 products per float32 one: float32's
accuracy), as does the backward.  It is held to the plain version at the
reference's own tolerances (``tests/test_kernels.py``): 2e-5 in float32,
3e-2 in bfloat16.
:func:`tile_plan` is the bfloat16 / float16 kernel's tiling, which it
mirrors;
:func:`kernel_tile_plan` reads the compiled kernel's own, which the card
tests hold to it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2, torch.float16: 3}
_ENCODE_FAILED = 1000  # csrc/flash_attention.cu: kEncodeFailed
# the bfloat16 / float16 kernel's tiles (csrc/flash_attention.cu: Tile):
# query rows of a block and of each of its two consumer warpgroups
BLOCK_Q, WARPGROUP_Q = 128, 64


def block_k(d: int) -> int:
    """Keys of a kv tile of the bfloat16 / float16 kernel at head dim d."""
    return 80 if d == 256 else 128


def f32_tiles(d: int) -> tuple[int, int]:
    """``(bq, bk)`` of the float32 forward kernel at head dim ``d``: query
    rows of a block and keys of a kv tile (``csrc/flash_attention.cu:
    Tf32Tile``), walked by :func:`kv_tile_range`."""
    return (128 if d == 128 else 64), 32


def bwd_tiles(d: int) -> dict:
    """The backward kernels' ``(bq, bk)`` tiles at head dim ``d``, query
    rows and keys (``csrc/flash_attention_bwd.cu: BwdTile``): ``"dkv"``,
    the query tiles a dK/dV block of ``bk`` keys walks by
    :func:`q_tile_range`; ``"dq"``, the kv tiles a dQ block of ``bq`` rows
    walks by :func:`kv_tile_range`."""
    return {"dkv": (32, 32) if d == 256 else (64 if d == 128 else 32, 64),
            "dq": (128 if d == 128 else 64, 32)}


def kv_tile_range(s: int, q0: int, bq: int, bk: int, *, causal: bool,
                  window: int | None) -> tuple[int, int]:
    """The kv tiles ``[t0, t1)`` of ``bk`` keys that hold a key admitted for
    some query row in ``[q0, q0 + bq)`` (the kernel's ``kv_tiles``)."""
    lo, hi = 0, s
    if causal:
        hi = min(s, q0 + bq)
        if window is not None:
            lo = max(0, q0 - window + 1)
    return lo // bk, -(-hi // bk)


def q_tile_range(s: int, k0: int, bk: int, bq: int, *, causal: bool,
                 window: int | None) -> tuple[int, int]:
    """The query tiles ``[t0, t1)`` of ``bq`` rows that hold a row admitting
    some key in ``[k0, k0 + bk)`` (the backward kernel's ``q_tiles``, which
    walks them with :func:`bwd_tiles`' ``"dkv"`` sizes): key j is admitted
    by the rows ``j <= i < j + window``."""
    lo, hi = 0, s
    if causal:
        lo = k0
        if window is not None:
            hi = min(s, k0 + bk - 1 + window)
    return lo // bq, -(-hi // bq)


def tile_masked(s: int, q0: int, bq: int, k0: int, bk: int, *, causal: bool,
                window: int | None) -> bool:
    """Whether the kv tile ``[k0, k0 + bk)`` holds a pair (i, j), i in
    ``[q0, min(q0 + bq, s))``, that the mask refuses (the kernel's
    ``tile_masked``): it crosses S, the diagonal or the window's lower edge."""
    if k0 + bk > s:
        return True
    if not causal:
        return False
    if k0 + bk - 1 > q0:
        return True
    return window is not None and k0 <= min(q0 + bq, s) - 1 - window


def tile_plan(s: int, *, causal: bool = True, window: int | None = None,
              bq: int = BLOCK_Q, bk: int = 128) -> list:
    """The kernel's tile plan for a sequence of ``s``: for each ``bq``-row
    query block, ``(q0, t0, t1, masked)`` -- the kv tiles ``[t0, t1)`` it
    visits and, per tile, whether it takes the per-element mask (a full
    tile takes none).  The kernel walks a block's tiles by this plan with
    ``bq = BLOCK_Q``; each consumer warpgroup masks them by the same plan
    with ``bq = WARPGROUP_Q``, under which a tile of the block outside the
    warpgroup's own range is masked whole.  The window applies under causal
    only."""
    window = window if causal else None
    plan = []
    for q0 in range(0, s, bq):
        t0, t1 = kv_tile_range(s, q0, bq, bk, causal=causal, window=window)
        plan.append((q0, t0, t1, [
            tile_masked(s, q0, bq, t * bk, bk, causal=causal, window=window)
            for t in range(t0, t1)]))
    return plan


def warpgroup_plan(s: int, d: int, *, causal: bool = True,
                   window: int | None = None) -> tuple:
    """The bfloat16 / float16 kernel's walk at head dim ``d``, by
    :func:`tile_plan`: ``((BLOCK_Q, WARPGROUP_Q, BK), plan)`` with, per
    ``BLOCK_Q``-row block, ``(q0, t0, t1, masks)``, ``masks`` holding for
    each of its kv tiles whether consumer warpgroup 0 and 1 mask it.
    :func:`kernel_tile_plan` must return the same."""
    bk = block_k(d)
    window = window if causal else None
    plan = []
    for q0, t0, t1, _ in tile_plan(s, causal=causal, window=window,
                                   bq=BLOCK_Q, bk=bk):
        plan.append((q0, t0, t1, [
            tuple(tile_masked(s, q0 + w * WARPGROUP_Q, WARPGROUP_Q, t * bk,
                              bk, causal=causal, window=window)
                  for w in (0, 1)) for t in range(t0, t1)]))
    return (BLOCK_Q, WARPGROUP_Q, bk), plan


def kernel_tile_plan(s: int, d: int, *, causal: bool = True,
                     window: int | None = None) -> tuple:
    """The compiled kernel's own tile plan, in :func:`warpgroup_plan`'s
    form: its tile sizes and its ``kv_tiles`` / ``tile_masked`` run on the
    host (``csrc/flash_attention.cu: repro_flash_tile_plan``).  Needs the
    built library, so a machine with ``nvcc``."""
    import ctypes

    lib = _build.load_library()
    win = int(window) if (causal and window is not None) else 0
    sizes = (ctypes.c_int * 3)()
    n = lib.repro_flash_tile_plan(d, s, int(causal), win, sizes, None, None)
    if n < 0:
        raise ValueError(f"flash_attention kernel: no tile plan at head dim "
                         f"{d}")
    bq, wq, bk = sizes
    blocks = -(-s // bq)
    ranges = (ctypes.c_int * (2 * blocks))()
    masks = (ctypes.c_ubyte * max(n, 1))()
    lib.repro_flash_tile_plan(d, s, int(causal), win, sizes, ranges, masks)
    plan, at = [], 0
    for i in range(blocks):
        t0, t1 = ranges[2 * i], ranges[2 * i + 1]
        plan.append((i * bq, t0, t1, [
            (bool(masks[at + 2 * j]), bool(masks[at + 2 * j + 1]))
            for j in range(t1 - t0)]))
        at += 2 * (t1 - t0)
    return (bq, wq, bk), plan


def _mask(s: int, causal: bool, window, device):
    """(S, S) boolean mask of the admitted (query, key) pairs, or None."""
    if not causal:
        return None
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None):
    """``ref.flash_attention`` in PyTorch.  q, k, v: ``(B, H, S, D)``;
    returns ``(B, H, S, D)`` in ``v``'s dtype."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _mask(s, causal, window, q.device)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)


def _check(q, k, v, window):
    """q (B, S, H, Dk), k (B, S, K, Dk) and v (B, S, K, Dv), one device and
    dtype."""
    ts = (q, k, v)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash_attention takes tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"flash_attention: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if len({t.dtype for t in ts}) != 1:
        raise ValueError(f"flash_attention: inputs of different dtypes: "
                         f"{[str(t.dtype) for t in ts]}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention takes (B, S, H, Dk) q, (B, S, K, "
                         f"Dk) k and (B, S, K, Dv) v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} in B, S or Dk")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def kernel_width(dk: int, dv: int) -> int:
    """The head dim a (Dk, Dv) attention launches at: the smallest of
    :data:`HEAD_DIMS` that holds both.  Wider raises."""
    for w in HEAD_DIMS:
        if max(dk, dv) <= w:
            return w
    raise ValueError(f"flash_attention kernel: head dim must be at most "
                     f"{HEAD_DIMS[-1]}, got Dk {dk}, Dv {dv}")


def to_kernel_width(*ts):
    """``(padded tensors, width)``: each of ``ts`` (q, k, v and, backward,
    out and dout) with its head dim zero-padded to :func:`kernel_width` of
    q's and v's head dims (the third tensor is v); a tensor at that width
    already is passed on as it is.  What the launches take; on CPU tensors
    the tests call it through the plain versions."""
    width = kernel_width(ts[0].shape[-1], ts[2].shape[-1])
    return tuple(t if t.shape[-1] == width
                 else F.pad(t, (0, width - t.shape[-1])) for t in ts), width


def _check_kernel_layout(q, k, v):
    """What the kernel takes: float32/bfloat16/float16, q, k and v at one
    head dim of HEAD_DIMS, the head dim contiguous and every other stride
    and the base address at a 16-byte boundary.  Anything else raises:
    there is no fallback."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS or v.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention kernel: head dim must be one of "
                         f"{HEAD_DIMS} for q, k and v, got {q.shape[3]}, "
                         f"{v.shape[3]}")
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % per16 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention kernel: {name} needs a contiguous head dim "
                f"and 16-byte aligned rows; got strides {t.stride()}")


def _grouped_logits(q, k, causal, window, softcap, f, scale=None):
    """The logits in ``f`` on the grouped layout: q (B, S, H, D) as
    (B, S, K, H/K, D) against k (B, S, K, D) -> (B, K, H/K, S, S), after
    the scale (default ``1/sqrt(D)``) and the softcap; with the mask (or
    None)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.to(f).reshape(b, s, kh, h // kh, d)
    r = torch.einsum("bskrd,btkd->bkrst", qg, k.to(f))
    r = r * scale if scale is not None else r / (d ** 0.5)
    x = softcap * torch.tanh(r / softcap) if softcap is not None else r
    return x, _mask(s, causal, window, q.device)


def lse_plain(q, k, *, causal=True, window=None, softcap=None, scale=None):
    """Each query row's log-sum-exp of its admitted logits, ``(B, H, S)``,
    float64 for float64 inputs, else float32 (what the kernel's float32
    forward hands the backward)."""
    b, s, h, _ = q.shape
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    x, mask = _grouped_logits(q, k, causal, window, softcap, f, scale)
    if mask is not None:
        x = torch.where(mask, x, torch.full((), -torch.inf, device=x.device))
    return torch.logsumexp(x, dim=-1).reshape(b, h, s)


def flash_attention_backward_plain(q, k, v, out, dout, lse=None, *,
                                   causal=True, window=None, softcap=None,
                                   scale=None):
    """The gradient of :func:`flash_attention_bshd` in PyTorch: ``(dq, dk,
    dv)`` of ``(B, S, H, Dk)`` queries, ``(B, S, K, Dk)`` keys and ``(B, S,
    K, Dv)`` values, given the output ``out``, its gradient ``dout`` and the
    rows' log-sum-exp ``lse`` (``(B, H, S)``; computed here when None).
    With ``x`` the logits scaled by ``scale`` (default ``1/sqrt(Dk)``) and
    softcapped, ``p = exp(x - lse)`` where the mask admits the pair (else
    0)::

        dv = p^T dout,  dp = dout v^T,  ds = p (dp - rowsum(dout * out)),
        dr = ds (1 - (x / softcap)^2),  dq = scale dr k,  dk = scale dr^T q

    with dk, dv summed over each kv head's query heads.  Computes in
    float64 for float64 inputs, else in float32; returns the inputs'
    dtypes."""
    b, s, h, d = q.shape
    kh, dv = k.shape[2], v.shape[3]
    rep = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    x, mask = _grouped_logits(q, k, causal, window, softcap, f, scale)
    if lse is None:
        lse = lse_plain(q, k, causal=causal, window=window, softcap=softcap,
                        scale=scale)
    p = torch.exp(x - lse.to(f).reshape(b, kh, rep, s)[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=f, device=p.device))
    qg = q.to(f).reshape(b, s, kh, rep, d)
    og = out.to(f).reshape(b, s, kh, rep, dv)
    dog = dout.to(f).reshape(b, s, kh, rep, dv)
    dv = torch.einsum("bkrst,bskrd->btkd", p, dog)
    dp = torch.einsum("bskrd,btkd->bkrst", dog, v.to(f))
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)  # (B, K, H/K, S)
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1 - (x / softcap) ** 2)
    dq = torch.einsum("bkrst,btkd->bskrd", ds, k.to(f)) * scale
    dk = torch.einsum("bkrst,bskrd->btkd", ds, qg) * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bshd(q, k, v, *, causal=True, window=None, softcap=None,
                         with_lse=False):
    """Attention of ``(B, S, H, Dk)`` queries over ``(B, S, K, Dk)`` keys and
    ``(B, S, K, Dv)`` values, scaled by ``1/sqrt(Dk)``; returns ``(B, S, H,
    Dv)`` in the input dtype, and with ``with_lse`` also the rows'
    log-sum-exp ``(B, H, S)`` float32 (float32 inputs only: the tensor-core
    kernel writes none).

    CPU tensors take :func:`flash_attention_plain` after repeating the kv
    heads (and :func:`lse_plain`).  CUDA tensors launch the kernel (counted
    in ``flash_attention_bshd.launches``), at :func:`kernel_width` when the
    head dims are not one of its own, or raise; nothing falls back.
    """
    _check(q, k, v, window)
    b, s, h, dk = q.shape
    kh, dv = k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(dk)
    if with_lse and q.dtype != torch.float32:
        raise NotImplementedError(
            f"flash_attention: the row log-sum-exp (the backward's input) is "
            f"written by the float32 kernel only, not for {q.dtype}")
    if not _build.on_card("flash_attention", q):
        rep = h // kh
        kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
        vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
        out = flash_attention_plain(
            q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
            causal=causal, window=window, softcap=softcap).transpose(1, 2)
        if with_lse:
            return out, lse_plain(q, k, causal=causal, window=window,
                                  softcap=softcap)
        return out
    (q, k, v), d = to_kernel_width(q, k, v)
    _check_kernel_layout(q, k, v)
    lib = _build.load_library()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    win = int(window) if (causal and window is not None) else 0  # 0: none
    _build.launch(
        "flash_attention", lib.repro_flash_attention, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b, s, h, kh, d, int(causal), win, scale,
        float(softcap) if softcap is not None else 0.0,
        errors={_ENCODE_FAILED: "cuTensorMapEncodeTiled refused an "
                                "operand's layout"})
    flash_attention_bshd.launches += 1
    out = out[..., :dv] if d != dv else out
    return (out, lse) if with_lse else out


flash_attention_bshd.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=None,
                        softcap=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_bshd` at ``q, k, v`` given
    its output ``out``, the output's gradient ``dout`` and the rows'
    log-sum-exp ``lse`` (``(B, H, S)`` float32).

    CPU tensors take :func:`flash_attention_backward_plain`.  CUDA tensors
    launch the backward kernel (``csrc/flash_attention_bwd.cu``; counted in
    ``flash_attention_bwd.launches``), float32 only, the operands made
    contiguous and 16-byte aligned first and padded to :func:`kernel_width`
    (dq and dk sliced back to Dk, dv to Dv); anything else raises.
    """
    _check(q, k, v, window)
    if not _build.on_card("flash_attention backward", q):
        return flash_attention_backward_plain(
            q, k, v, out, dout, lse, causal=causal, window=window,
            softcap=softcap)
    if q.dtype != torch.float32:
        raise NotImplementedError(f"flash_attention backward kernel: "
                                  f"float32 only, got {q.dtype}")
    b, s, h, d_k = q.shape
    kh, d_v = k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(d_k)
    ov = (b, s, h, d_v)
    if out.shape != ov or dout.shape != ov \
            or lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)} must be {ov} "
                         f"and lse {tuple(lse.shape)} {lse.dtype} float32 "
                         f"{(b, h, s)}")
    (q, k, v, out, dout), d = to_kernel_width(q, k, v, out, dout)
    lib = _build.load_library()
    # contiguous, and at a 16-byte boundary: the kernels read rows with
    # 16-byte copies (a contiguous view can start anywhere in its storage)
    q, k, v, out, dout, lse = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (x.to(torch.float32).contiguous()
                  for x in (q, k, v, out, dout, lse)))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    win = int(window) if (causal and window is not None) else 0
    _build.launch(
        "flash_attention_bwd", lib.repro_flash_attention_bwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, kh, d, int(causal), win,
        scale, float(softcap) if softcap is not None else 0.0)
    flash_attention_bwd.launches += 1
    if d != d_k:
        dq, dk = dq[..., :d_k], dk[..., :d_k]
    return dq, dk, dv[..., :d_v] if d != d_v else dv


flash_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _fold(info, in_dims, tensors):
    """Batched operands with the mapped axis folded into B: each moved to
    axis 0 (or expanded there when unmapped) and merged with B."""
    n = info.batch_size
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(n * t.shape[1], *t.shape[2:]))
    return n, out


def _unfold(n, t):
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``apply(q, k, v, causal, window,
    softcap) -> (out, lse)``, ``lse`` the rows' log-sum-exp (float32 inputs;
    empty for others, whose gradient is not implemented).  The forward is
    :func:`flash_attention_bshd` (kernel 5 on the card); the backward is
    :class:`FlashAttentionBackward`.  Under ``torch.func.vmap`` the mapped
    axis is folded into B, so one launch covers every client."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap):
        if q.dtype == torch.float32:
            return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                        softcap=softcap, with_lse=True)
        out = flash_attention_bshd(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
        return out, q.new_empty((q.shape[0], q.shape[2], 0),
                                dtype=torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if q.dtype != torch.float32:
            raise NotImplementedError(f"flash_attention: no backward for "
                                      f"{q.dtype} (float32 only)")
        dq, dk, dv = FlashAttentionBackward.apply(q, k, v, out, dout, lse,
                                                  *ctx.mask)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap):
        n, (q, k, v) = _fold(info, in_dims[:3], (q, k, v))
        out, lse = FlashAttention.apply(q, k, v, causal, window, softcap)
        return (_unfold(n, out), _unfold(n, lse)), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """``apply(q, k, v, out, dout, lse, causal, window, softcap) -> (dq,
    dk, dv)``: :func:`flash_attention_bwd` (kernel 5b on the card), with its
    own vmap rule (the mapped axis folded into B: one launch).  Not
    differentiable itself."""

    @staticmethod
    def forward(q, k, v, out, dout, lse, causal, window, softcap):
        return flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                   window=window, softcap=softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention: no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, dout, lse, causal, window,
             softcap):
        n, ts = _fold(info, in_dims[:6], (q, k, v, out, dout, lse))
        grads = FlashAttentionBackward.apply(*ts, causal, window, softcap)
        return tuple(_unfold(n, g) for g in grads), (0, 0, 0)
