"""Fused local update + L1 proximal step: the CUDA kernel's wrapper and its
plain PyTorch version.

The port of the Pallas TPU kernel ``repro/kernels/fused_prox.py:_kernel``
(Algorithm 1, lines 9-10).  For each element of a contiguous plane:

    z_hat' = z_hat - eta * (grads + c)
    z'     = sign(z_hat') * max(|z_hat'| - thresh, 0)

The kernel (``csrc/fused_prox.cu``) reads ``z_hat``, ``grads`` and ``c``
once and writes ``z_hat'`` and ``z'`` once, over the whole plane in one
launch.  float32 computes in float32, float64 in float64, bfloat16 and
float16 in float32 with one rounding at each store.  It equals
:func:`fused_local_update_plain` bitwise on the card: no operation is
contracted into an FMA.  The plain version follows
``repro/kernels/ref.py:fused_local_update`` rounding, which the Pallas
interpreter does not (it contracts the update into an FMA).
"""
from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                torch.float16: 3}


def fused_local_update_plain(z_hat, grads, c, eta: float, thresh: float):
    """The kernel's function in plain PyTorch, with the kernel's rounding:
    each operation rounds in the compute type (float64 for float64 inputs,
    float32 otherwise) and the outputs round once to the input dtype."""
    dt = z_hat.dtype
    work = torch.float64 if dt == torch.float64 else torch.float32
    zh, g, cc = (x.to(work) for x in (z_hat, grads, c))
    upd = zh - eta * (g + cc)
    z = torch.sign(upd) * torch.clamp_min(torch.abs(upd) - thresh, 0.0)
    return upd.to(dt), z.to(dt)


def _check(z_hat, grads, c):
    ts = (z_hat, grads, c)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("fused_local_update_2d takes tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError(
            f"inputs on different devices: {[str(t.device) for t in ts]}")
    if len({t.dtype for t in ts}) != 1 or z_hat.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"inputs must share one dtype of {sorted(map(str, _DTYPE_CODES))}"
            f"; got {[str(t.dtype) for t in ts]}")
    if len({tuple(t.shape) for t in ts}) != 1:
        raise ValueError(
            f"inputs must share one shape; got {[tuple(t.shape) for t in ts]}")


def fused_local_update_2d(z_hat, grads, c, eta: float, thresh: float):
    """Fused update over a contiguous plane of any shape (the port takes
    the whole ``(n_clients, d_pad)`` plane, ``d_pad`` unpadded).

    CPU tensors take :func:`fused_local_update_plain`.  CUDA tensors launch
    the kernel (counted in ``fused_local_update_2d.launches``) or raise;
    nothing falls back.  ``eta`` and ``thresh`` are Python floats, passed to
    the kernel as doubles and rounded there to the compute type.
    """
    _check(z_hat, grads, c)
    dev = z_hat.device
    if dev.type == "cpu":
        return fused_local_update_plain(z_hat, grads, c, eta, thresh)
    if dev.type != "cuda":
        raise ValueError(f"no fused_local_update kernel for device {dev}")
    if not (z_hat.is_contiguous() and grads.is_contiguous()
            and c.is_contiguous()):
        raise ValueError("fused_local_update_2d needs contiguous inputs")
    from repro_torch.kernels import _build

    lib = _build.load_library()
    zh_out = torch.empty_like(z_hat)
    z_out = torch.empty_like(z_hat)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_fused_local_update(
            _DTYPE_CODES[z_hat.dtype], z_hat.data_ptr(), grads.data_ptr(),
            c.data_ptr(), zh_out.data_ptr(), z_out.data_ptr(), z_hat.numel(),
            float(eta), float(thresh), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_local_update kernel launch failed: cudaError {err}")
    fused_local_update_2d.launches += 1
    return zh_out, z_out


fused_local_update_2d.launches = 0
