"""Device selection for the port's entry points."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  A CUDA device without a usable GPU raises; the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU explicitly")
    return dev


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and float32 matmuls without TF32 inside the block
    (the previous settings come back after it): the models run in full
    float32 on the card, so their trajectories stay within float32
    rounding of the CPU's."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


def device_of(tree) -> torch.device:
    """The device of the first tensor leaf of ``tree``."""
    from repro_torch.utils.tree import tree_leaves

    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("tree holds no tensor leaf")


def to_device(tree, device):
    """Every leaf of ``tree`` as a tensor on ``device``: tensors are moved,
    numpy arrays (read-only broadcast views included) are copied over."""
    from repro_torch.utils.tree import tree_map

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        arr = np.asarray(x)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return tree_map(move, tree)


class _Spec:
    """Shape and dtype of one array leaf (a pytree leaf itself)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def eval_shape(fn, *args):
    """The shapes and dtypes of ``fn(*args)``, as ``meta`` tensors, with no
    data and no arithmetic (the counterpart of ``jax.eval_shape``).

    ``fn`` runs under PyTorch's fake-tensor mode on fake CPU copies of the
    array leaves of ``args``: the kernel wrappers see CPU tensors and take
    their plain versions, which compute nothing on fakes, so no kernel
    launches, no counter moves and no span is recorded."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.obs import trace
    from repro_torch.utils.tree import tree_map

    def spec(x):
        if isinstance(x, torch.Tensor):
            return _Spec(x.shape, x.dtype)
        if isinstance(x, np.ndarray):
            return _Spec(x.shape,
                         torch.from_numpy(np.empty(0, x.dtype)).dtype)
        return x

    def fake(s):
        return torch.empty(s.shape, dtype=s.dtype) if isinstance(
            s, _Spec) else s

    specs = [tree_map(spec, a) for a in args]
    with FakeTensorMode(), trace.paused():
        out = tree_map(spec, fn(*(tree_map(fake, sp) for sp in specs)))
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), out)
