"""The flat parameter plane: one contiguous d-vector for a whole pytree.

The counterpart of :mod:`repro.core.plane`, with the same layout: for the
same tree, ``batch_dims`` and ``tile``, :class:`SegmentSpec` holds the same
shapes, offsets, sizes, ``d`` and ``d_pad`` as the reference, leaves are
laid out in ``jax.tree_util`` order (sorted dict keys, see
:mod:`repro_torch.utils.tree`), and the padded tail is zero -- so planes move
across the two packages bitwise.

  * :class:`SegmentSpec` -- the static layout of a pytree inside one
    contiguous 1-D buffer: per-leaf offsets/shapes/dtype plus the padded
    length.  Leading batch axes (e.g. the client axis of an uplink message)
    are declared once on the spec and stay leading axes of the plane: a
    ``(clients, ...)`` tree becomes a ``(clients, d_pad)`` plane.
  * :func:`flatten` / :func:`unflatten` -- bitwise moves between the pytree
    view and the flat plane (one ``cat`` + zero pad; the inverse is slices +
    reshapes, i.e. views of the plane).
  * :class:`ParamPlane` -- a flat buffer paired with its spec, usable
    anywhere a pytree is.

One plane holds one dtype; mixing dtypes in a tree is a loud error.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from repro_torch.utils import tree as tu

# The reference's lane width, kept for layout parity (``SegmentSpec.rows``
# and the default ``tile``).  The CUDA kernels need no lane padding.
LANES = 128


@dataclass(frozen=True)
class SegmentSpec:
    """Static layout of a pytree inside one contiguous 1-D buffer.

    ``treedef``/``shapes`` describe the tree; ``offsets``/``sizes`` locate
    each leaf's segment inside the valid region ``[0, d)``; ``d_pad`` is the
    buffer length after padding to a multiple of ``tile``.  ``batch_dims``
    leading axes of every leaf are *batch* axes that stay leading axes of
    the plane instead of being flattened into it.
    """

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]  # per-leaf shapes, batch axes excluded
    dtype: torch.dtype                   # the single common leaf dtype
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    d: int        # valid elements (the paper's d)
    d_pad: int    # buffer length (d padded to a multiple of ``tile``)
    batch_dims: int = 0

    @classmethod
    def from_tree(cls, tree, *, batch_dims: int = 0,
                  tile: int = LANES) -> "SegmentSpec":
        """Build the layout of ``tree`` (tensors).

        ``batch_dims`` leading axes of every leaf are excluded from the
        flattened segments (they must agree across leaves and become the
        plane's leading axes).  ``tile`` sets the padding granularity;
        ``1`` means no padding.
        """
        leaves, treedef = tu.tree_flatten(tree)
        if not leaves:
            raise ValueError("cannot build a SegmentSpec from an empty tree")
        if tile < 1:
            raise ValueError(f"tile must be >= 1, got {tile}")
        dtypes = {l.dtype for l in leaves}
        if len(dtypes) != 1:
            raise ValueError(
                "a flat plane holds exactly one dtype; got "
                f"{sorted(str(d) for d in dtypes)} -- flatten per-dtype "
                "sub-trees separately (casting here would break the bitwise "
                "plane/pytree parity contracts)")
        batch_shape = None
        shapes, sizes, offsets = [], [], []
        off = 0
        for l in leaves:
            shape = tuple(int(s) for s in l.shape)
            if len(shape) < batch_dims:
                raise ValueError(
                    f"leaf shape {shape} has fewer than batch_dims="
                    f"{batch_dims} leading axes")
            b, s = shape[:batch_dims], shape[batch_dims:]
            if batch_shape is None:
                batch_shape = b
            elif b != batch_shape:
                raise ValueError(
                    f"inconsistent batch axes across leaves: {b} vs "
                    f"{batch_shape}")
            n = 1
            for x in s:
                n *= x
            shapes.append(s)
            sizes.append(n)
            offsets.append(off)
            off += n
        d = off
        d_pad = -(-max(d, 1) // tile) * tile
        return cls(treedef=treedef, shapes=tuple(shapes),
                   dtype=dtypes.pop(), offsets=tuple(offsets),
                   sizes=tuple(sizes), d=d, d_pad=d_pad,
                   batch_dims=batch_dims)

    @property
    def pad(self) -> int:
        """Zero-filled tail elements of the plane."""
        return self.d_pad - self.d

    @property
    def row_nbytes(self) -> int:
        """Bytes of one plane row (one client's padded d-vector)."""
        return self.d_pad * self.dtype.itemsize

    @property
    def rows(self) -> int:
        """Plane length in 128-lane rows."""
        return self.d_pad // LANES

    def with_tile(self, tile: int) -> "SegmentSpec":
        """The same layout re-padded to a multiple of ``tile``."""
        d_pad = -(-max(self.d, 1) // tile) * tile
        return replace(self, d_pad=d_pad)


def flatten(spec: SegmentSpec, tree) -> torch.Tensor:
    """Tree -> flat plane ``(*batch, d_pad)``; bitwise, zero-padded tail."""
    leaves = spec.treedef.flatten_up_to(tree)  # dict children match by key
    batch = None
    flat = []
    for l, shape in zip(leaves, spec.shapes):
        l = torch.as_tensor(l)
        b = tuple(l.shape[:l.ndim - len(shape)])
        if tuple(l.shape[l.ndim - len(shape):]) != shape:
            raise ValueError(
                f"leaf shape {tuple(l.shape)} does not match spec segment "
                f"{shape} (+{spec.batch_dims} batch axes)")
        if batch is None:
            batch = b
        elif b != batch:
            raise ValueError(
                f"inconsistent batch axes across leaves: {b} vs {batch}")
        flat.append(l.reshape(b + (-1,)))
    out = flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)
    if spec.pad:
        out = F.pad(out, (0, spec.pad))
    return out


def unflatten(spec: SegmentSpec, plane: torch.Tensor):
    """Flat plane ``(*batch, d_pad)`` -> tree (the inverse of
    :func:`flatten`; padding is dropped).  Every leaf is a view of the
    plane."""
    if plane.shape[-1] != spec.d_pad:
        raise ValueError(
            f"plane has trailing length {plane.shape[-1]}, spec expects "
            f"d_pad={spec.d_pad}")
    batch = tuple(plane.shape[:-1])
    leaves = [plane[..., off:off + size].reshape(batch + shape)
              for off, size, shape in zip(spec.offsets, spec.sizes,
                                          spec.shapes)]
    return tu.tree_unflatten(spec.treedef, leaves)


# ``view_as_tree`` is the reading-direction alias: the tree is a cheap view
# of the plane, not a copy you need to keep in sync.
view_as_tree = unflatten


def zeros(spec: SegmentSpec, *batch: int, device=None) -> torch.Tensor:
    """A zero plane ``(*batch, d_pad)`` in the spec's dtype."""
    return torch.zeros(tuple(batch) + (spec.d_pad,), dtype=spec.dtype,
                       device=device)


def take_rows(plane, ids, axis: int = 0) -> torch.Tensor:
    """Cohort-sliced copy of a population plane: rows ``ids`` along the
    client axis."""
    plane = torch.as_tensor(plane)
    ids = torch.as_tensor(ids, dtype=torch.long, device=plane.device)
    return torch.index_select(plane, axis, ids)


def put_rows(plane, ids, rows, axis: int = 0) -> torch.Tensor:
    """Scatter cohort rows back into a population plane (the inverse of
    :func:`take_rows` for unique ``ids``); returns an updated copy and
    leaves ``plane`` untouched, as the reference does."""
    out = torch.as_tensor(plane).clone()
    idx: list = [slice(None)] * out.ndim
    idx[axis] = torch.as_tensor(ids, dtype=torch.long, device=out.device)
    out[tuple(idx)] = torch.as_tensor(rows, dtype=out.dtype,
                                      device=out.device)
    return out


@dataclass(frozen=True)
class ParamPlane:
    """A flat buffer + its static layout, usable anywhere a pytree is.

    The buffer is the pytree leaf; the spec rides as the node's context.
    """

    data: torch.Tensor   # (*batch, d_pad)
    spec: SegmentSpec

    @classmethod
    def from_tree(cls, tree, *, batch_dims: int = 0,
                  tile: int = LANES) -> "ParamPlane":
        spec = SegmentSpec.from_tree(tree, batch_dims=batch_dims, tile=tile)
        return cls(flatten(spec, tree), spec)

    @property
    def tree(self):
        """The pytree view of the plane."""
        return unflatten(self.spec, self.data)

    def with_data(self, data) -> "ParamPlane":
        return ParamPlane(data, self.spec)


pytree.register_pytree_node(
    ParamPlane,
    lambda p: ([p.data], p.spec),
    lambda children, spec: ParamPlane(children[0], spec),
)
