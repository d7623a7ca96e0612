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

The kernel accumulates in float32 and keeps the running softmax statistics
in float32; bfloat16 and float16 run on the tensor cores (``wgmma``, TMA
loads, a producer warp feeding two consumer warpgroups) with the
probabilities rounded to the input dtype for the PV product, float32 on the
CUDA cores.  It is held to the plain version at the reference's own
tolerances (``tests/test_kernels.py``): 2e-5 in float32, 3e-2 in bfloat16.
:func:`tile_plan` is the tensor-core kernel's tiling, which it mirrors;
:func:`kernel_tile_plan` reads the compiled kernel's own, which the card
tests hold to it.
"""
from __future__ import annotations

import torch

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

    from repro_torch.kernels import _build

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


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None):
    """``ref.flash_attention`` in PyTorch.  q, k, v: ``(B, H, S, D)``;
    returns ``(B, H, S, D)`` in ``v``'s dtype."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = torch.where(mask[None, None], logits,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)


def _check(q, k, v, window):
    ts = (q, k, v)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash_attention takes tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"flash_attention: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if len({t.dtype for t in ts}) != 1:
        raise ValueError(f"flash_attention: inputs of different dtypes: "
                         f"{[str(t.dtype) for t in ts]}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes (B, S, H, D) q and equal "
                         f"(B, S, K, D) k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} in B, S or D")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def _check_kernel_layout(q, k, v):
    """What the kernel takes: float32/bfloat16/float16, D in HEAD_DIMS, the
    head dim contiguous and every other stride and the base address at a
    16-byte boundary.  Anything else raises: there is no fallback."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim must be one of "
                         f"{HEAD_DIMS}, got {q.shape[3]}")
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % per16 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention kernel: {name} needs a contiguous head dim "
                f"and 16-byte aligned rows; got strides {t.stride()}")


def flash_attention_bshd(q, k, v, *, causal=True, window=None, softcap=None):
    """Attention of ``(B, S, H, D)`` queries over ``(B, S, K, D)`` keys and
    values; returns ``(B, S, H, D)`` in the input dtype.

    CPU tensors take :func:`flash_attention_plain` after repeating the kv
    heads.  CUDA tensors launch the kernel (counted in
    ``flash_attention_bshd.launches``) or raise; nothing falls back.
    """
    _check(q, k, v, window)
    b, s, h, d = q.shape
    kh = k.shape[2]
    if q.device.type == "cpu":
        rep = h // kh
        kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
        vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
        out = flash_attention_plain(
            q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
            causal=causal, window=window, softcap=softcap)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    _check_kernel_layout(q, k, v)
    from repro_torch.kernels import _build

    lib = _build.load_library()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    win = int(window) if (causal and window is not None) else 0  # 0: none
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], b, s, h, kh, d, int(causal),
            win, 1.0 / (d ** 0.5),
            float(softcap) if softcap is not None else 0.0, stream)
    if err == _ENCODE_FAILED:
        raise RuntimeError("flash_attention kernel: cuTensorMapEncodeTiled "
                           "refused an operand's layout")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
