"""Flat-plane kernels: the CUDA kernels' wrappers and their plain PyTorch
versions.

The port of the Pallas TPU kernels of ``repro/kernels/plane_ops.py``
(``_threshold_kernel`` / ``threshold_select_3d``, ``_quantize_kernel`` /
``quantize_3d`` and ``_commit_kernel`` / ``weighted_commit_3d``).  All run
over an ``(n_rows, d_pad)`` plane (contiguous for the select and the
quantizer; the commit reads strided rows) -- one row per client, or one
row for a broadcast -- with a per-row scalar:

  * :func:`threshold_select_2d` -- ``out = |x| >= thresh[row] ? x : 0``, the
    select half of global top-k once the per-row k-th magnitude is known;
  * :func:`quantize_2d` -- stochastic uniform quantization given the draws
    ``u`` and a per-row ``scale`` (0 quantizes as 1):
    ``y = x/s*L``, ``q = floor(y) + [u < y - floor(y)]``, ``out = q/L*s``;
  * :func:`weighted_commit_2d` -- ``out[j] = sum_i w[i] * x[i, j]``, added
    in row order: the client-axis reduction of the buffered commit's server
    half (``repro.sched.aggregator``).

The kernels are in ``csrc/plane_ops.cu``.  The select and the quantizer
make one grid-stride launch each over the whole plane.  The commit
stages each block's column segment of every row through shared memory with
bulk asynchronous copies and adds the rows in order; it reads the weights
in the caller's dtype (float32 or float64) and converts them in the kernel
as ``Tensor.to`` does, so the wrapper launches nothing else.  float32
computes in float32, float64 in float64, bfloat16 and float16 in float32
with one rounding at the store.  The plain versions
spell out the ``repro/kernels/ref.py`` expressions in that compute type, and
the kernels equal them bitwise on the card.  The thresholds take ``x``'s
dtype, as ``ref.plane_threshold_select`` casts them (the Pallas kernel
rounds them to float32 instead), and the quantizer computes float64 planes
in float64, as ``ref.plane_quantize`` does (the Pallas kernel computes in
float32 for every dtype).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_prox import _DTYPE_CODES

# the commit kernel's weight dtypes (csrc/plane_ops.cu: w_dtype)
_WEIGHT_CODES = {torch.float32: 0, torch.float64: 1}


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def threshold_select_plain(x, thresh):
    """The select kernel's function in plain PyTorch (``x`` passes through
    untouched where kept, ``+0`` elsewhere)."""
    keep = torch.abs(x) >= thresh.to(x.dtype)[:, None]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def quantize_plain(x, u, scale, levels: int):
    """The quantize kernel's function in plain PyTorch, in the kernel's
    compute type, rounding once to ``x``'s dtype at the end.

    ``levels`` divides as a tensor on ``x``'s device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead, which
    rounds differently from ``ref.py``'s (and the kernel's) true division.
    """
    dt = x.dtype
    work = _work_dtype(dt)
    s = scale.to(work)
    s = torch.where(s == 0, torch.ones_like(s), s)[:, None]
    L = torch.full((), levels, dtype=work, device=x.device)
    y = x.to(work) / s * L
    lo = torch.floor(y)
    q = lo + (u.to(work) < (y - lo)).to(work)
    return (q / L * s).to(dt)


def weighted_commit_plain(x, w):
    """The commit kernel's function in plain PyTorch: ``acc = acc + w[i] *
    x[i]`` over the rows in order, in the compute type, rounded once to
    ``x``'s dtype."""
    work = _work_dtype(x.dtype)
    wt = w.to(work)
    acc = torch.zeros(tuple(x.shape[1:]), dtype=work, device=x.device)
    for i in range(x.shape[0]):
        acc = acc + wt[i] * x[i].to(work)
    return acc.to(x.dtype)


def _check_plane(name: str, x, *others):
    ts = (x,) + others
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError(f"{name} takes tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{name} takes an (n_rows, d_pad) plane, got shape "
                         f"{tuple(x.shape)}")


def _check_rows(name: str, x, per_row):
    if tuple(per_row.shape) != (x.shape[0],):
        raise ValueError(f"{name}: per-row values of shape {(x.shape[0],)} "
                         f"expected, got {tuple(per_row.shape)}")


def threshold_select_2d(x, thresh):
    """Keep ``x[i, j]`` where ``|x[i, j]| >= thresh[i]``, else 0, over an
    ``(n_rows, d_pad)`` plane; ``thresh`` is ``(n_rows,)`` of any float
    dtype (it is cast to ``x``'s dtype first).

    CPU tensors take :func:`threshold_select_plain`.  CUDA tensors launch
    the kernel (counted in ``threshold_select_2d.launches``) or raise;
    nothing falls back.
    """
    _check_plane("threshold_select", x, thresh)
    _check_rows("threshold_select", x, thresh)
    if not _build.on_card("threshold_select", x):
        return threshold_select_plain(x, thresh)
    if not x.is_contiguous():
        raise ValueError("threshold_select_2d needs a contiguous plane")
    t = thresh.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    _build.launch("threshold_select",
                  _build.load_library().repro_threshold_select, x.device,
                  _DTYPE_CODES[x.dtype], x.data_ptr(), t.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[1])
    threshold_select_2d.launches += 1
    return out


threshold_select_2d.launches = 0


def quantize_2d(x, u, scale, levels: int):
    """Stochastic uniform quantization of an ``(n_rows, d_pad)`` plane to
    ``levels`` levels per sign, given uniform draws ``u`` (same shape and
    dtype as ``x``) and per-row ``scale`` magnitudes (``(n_rows,)``; 0 is
    taken as 1).

    CPU tensors take :func:`quantize_plain`.  CUDA tensors launch the
    kernel (counted in ``quantize_2d.launches``) or raise; nothing falls
    back.
    """
    _check_plane("quantize", x, u, scale)
    _check_rows("quantize", x, scale)
    if u.dtype != x.dtype or u.shape != x.shape:
        raise ValueError(
            f"quantize: draws must match the plane ({tuple(x.shape)}, "
            f"{x.dtype}); got {tuple(u.shape)}, {u.dtype}")
    levels = int(levels)
    if levels < 1:
        raise ValueError(f"quantize: levels must be >= 1, got {levels}")
    if not _build.on_card("quantize", x):
        return quantize_plain(x, u, scale, levels)
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("quantize_2d needs a contiguous plane and draws")
    s = scale.to(_work_dtype(x.dtype)).contiguous()
    out = torch.empty_like(x)
    _build.launch("quantize", _build.load_library().repro_quantize, x.device,
                  _DTYPE_CODES[x.dtype], x.data_ptr(), u.data_ptr(),
                  s.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                  levels)
    quantize_2d.launches += 1
    return out


quantize_2d.launches = 0


def weighted_commit_2d(x, w, *, loads: bool = False):
    """The weighted row sum ``sum_i w[i] * x[i]`` of an ``(n_rows, d_pad)``
    plane, rows added in order; ``w`` is ``(n_rows,)`` of any float dtype,
    converted to the compute type as ``Tensor.to`` converts it.  Returns
    ``(d_pad,)`` in ``x``'s dtype.  The plane's rows may be strided; its
    columns must be contiguous.

    CPU tensors take :func:`weighted_commit_plain`.  CUDA tensors launch
    the kernel (counted in ``weighted_commit_2d.launches``) or raise;
    nothing falls back.  float32 and float64 weights go to the kernel as
    they are; other weight dtypes are widened to float32 first (exact).
    ``loads=True`` reads an aligned plane with plain loads instead of the
    bulk-copy ring (``repro_weighted_commit_loads``): the same bits, a
    measured alternative that no path of the port takes.
    """
    _check_plane("weighted_commit", x, w)
    _check_rows("weighted_commit", x, w)
    if x.shape[0] < 1:
        raise ValueError("weighted_commit needs at least one row")
    if not _build.on_card("weighted_commit", x):
        return weighted_commit_plain(x, w)
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("weighted_commit_2d needs rows with contiguous "
                         "columns")
    if w.dtype not in _WEIGHT_CODES:
        w = w.to(torch.float32)
    if not w.is_contiguous():
        w = w.contiguous()
    out = torch.empty((x.shape[1],), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    entry = (lib.repro_weighted_commit_loads if loads
             else lib.repro_weighted_commit)
    _build.launch("weighted_commit", entry, x.device, _DTYPE_CODES[x.dtype],
                  _WEIGHT_CODES[w.dtype], x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[1], x.stride(0))
    weighted_commit_2d.launches += 1
    return out


weighted_commit_2d.launches = 0
