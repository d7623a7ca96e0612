"""Fused local update + L1 proximal step: the CUDA kernel's wrappers, its
leaf table and its plain PyTorch version.

The port of the Pallas TPU kernel ``repro/kernels/fused_prox.py:_kernel``
(Algorithm 1, lines 9-10).  For each element of every leaf of a pytree:

    z_hat' = z_hat - eta * (grads + c)
    z'     = sign(z_hat') * max(|z_hat'| - thresh, 0)

One launch (``csrc/fused_prox.cu``) covers every leaf: it reads ``z_hat``,
``grads`` and ``c`` where they lie, leaf by leaf, and writes two output
planes whose leaves are views (:func:`repro_torch.core.plane.unflatten`).
What the launch covers is described by a table passed by value as the
kernel's parameter: a header, one entry per leaf (its three input
addresses, each input's row stride along the client axis, its width per
client, its column offset in the output planes, its chunking) and a block
map, one word per block naming its leaf and chunk (:func:`plan_leaves`
builds it, :func:`pack_table` packs it).  The output planes give each leaf
a segment that starts on a 16-byte boundary, so a leaf whose inputs are
aligned takes 16-byte vectors.

float32 computes in float32, float64 in float64, bfloat16 and float16 in
float32 with one rounding at each store.  The kernel equals
:func:`fused_local_update_plain` bitwise on the card: no operation is
contracted into an FMA.  The plain version follows
``repro/kernels/ref.py:fused_local_update`` rounding, which the Pallas
interpreter does not (it contracts the update into an FMA).  On CPU
tensors the wrappers run the plain version once per leaf, on the same
``torch.as_strided`` rows the table names, into the same output planes.

Whichever entry launched the kernel, ``_build.COUNTS`` counts its launches
(``fused_local_updates``) and the device copies the wrapper had to make
first (``fused_local_update_copies``: a leaf whose per-client part is not
contiguous, or whose dtype differs from ``z_hat``'s).
"""
from __future__ import annotations

import functools
import math
import struct
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.utils import tree as tu

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                torch.float16: 3}

# csrc/fused_prox.cu: Header, Leaf, the block map's uint32 words
HEADER_FMT = "<qqqqddiiq"       # zh_out, z_out, out_ld, n_rows, eta, thresh,
#                                 n_leaves, n_blocks, reserved
LEAF_FMT = "<qqqqqqqqiiiBB2x"   # zh, g, c, ld_zh, ld_g, ld_c, width, col,
#                                 chunk_rows, chunk_cols, chunks_per_row,
#                                 tpr_log2, vec
HEADER_BYTES = struct.calcsize(HEADER_FMT)   # 64
LEAF_BYTES = struct.calcsize(LEAF_FMT)       # 80
WORD_BYTES = 4
SMALL_TABLE, LARGE_TABLE = 4096, 32760  # the kernel parameter limit: before
#                                         and from CUDA 12.1 (32,764)
THREADS = 256           # a block
MIN_VECTORS = 4         # 16-byte vectors per thread in a chunk of a wide leaf
MIN_BLOCKS = 264        # two per SM: fewer blocks are not worth one launch


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


# ---------------------------------------------------------------------------
# the leaf table
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafChunks:
    """How one leaf of ``n_rows`` rows of ``width`` elements is cut into
    blocks: chunks of ``chunk_rows`` rows by ``chunk_cols`` columns,
    ``chunks_per_row`` across a row; ``2**tpr_log2`` threads over a row of
    a chunk.  ``col``: the leaf's column offset in the output planes."""

    width: int
    col: int
    chunk_rows: int
    chunk_cols: int
    chunks_per_row: int
    n_chunks: int
    tpr_log2: int


@dataclass(frozen=True)
class Table:
    """One launch: the leaves it covers (indices into the plan's leaves)
    and its block map (``chunk << 16 | position in leaves``)."""

    leaves: tuple
    words: tuple

    @functools.cached_property
    def block_map(self) -> bytes:
        return struct.pack(f"<{len(self.words)}I", *self.words)

    @property
    def nbytes(self) -> int:
        return (HEADER_BYTES + LEAF_BYTES * len(self.leaves)
                + WORD_BYTES * len(self.words))


@dataclass(frozen=True)
class LeafPlan:
    """The launches over a list of leaves: their chunking, the output
    planes' row stride and the tables, each within ``table_bytes``."""

    n_rows: int
    itemsize: int
    out_ld: int
    leaves: tuple
    tables: tuple
    table_bytes: int


def _vector(itemsize: int) -> int:
    return 16 // itemsize


def segment_offsets(widths, itemsize: int):
    """Each leaf's column offset in the output planes, every segment
    starting on a 16-byte boundary, and the planes' row length (a multiple
    of 16 bytes)."""
    n = _vector(itemsize)
    cols, at = [], 0
    for w in widths:
        cols.append(at)
        at += -(-w // n) * n
    return tuple(cols), max(at, n)


def _chunks(width: int, col: int, n_rows: int, itemsize: int,
            vectors: int) -> LeafChunks:
    n = _vector(itemsize)
    span = vectors * THREADS * n  # elements of a wide leaf's chunk
    if width == 0 or n_rows == 0:
        return LeafChunks(width, col, 1, 1, 1, 0, 0)
    if width > span:  # one row and `span` columns a block
        per_row = -(-width // span)
        return LeafChunks(width, col, 1, span, per_row, n_rows * per_row,
                          THREADS.bit_length() - 1)
    rows = min(n_rows, max(1, span // width))  # whole rows a block
    tpr = 1
    while tpr < min(-(-width // n), THREADS):
        tpr *= 2
    return LeafChunks(width, col, rows, width, 1, -(-n_rows // rows),
                      tpr.bit_length() - 1)


def plan_leaves(widths, n_rows: int, itemsize: int,
                table_bytes: int = LARGE_TABLE) -> LeafPlan:
    """The launches that update leaves of ``widths`` elements per row over
    ``n_rows`` rows.  Chunks of a wide leaf start at ``MIN_VECTORS`` vectors
    per thread and double while the blocks do not fit one table, would
    still number ``MIN_BLOCKS`` or more and some leaf has more than one
    chunk (doubling then cuts the blocks); then the leaves and their chunks
    fill tables of at most ``table_bytes`` in order, a leaf whose chunks
    do not fit the rest of a table continuing in the next (one launch
    each)."""
    cols, out_ld = segment_offsets(widths, itemsize)
    vectors = MIN_VECTORS
    while True:
        leaves = tuple(_chunks(w, c, n_rows, itemsize, vectors)
                       for w, c in zip(widths, cols))
        blocks = sum(l.n_chunks for l in leaves)
        busy = sum(1 for l in leaves if l.n_chunks)
        need = HEADER_BYTES + LEAF_BYTES * busy + WORD_BYTES * blocks
        if (need <= table_bytes or blocks // 2 < MIN_BLOCKS
                or blocks == busy):
            break
        vectors *= 2
    if HEADER_BYTES + LEAF_BYTES + WORD_BYTES > table_bytes:
        raise ValueError(f"a table of {table_bytes} bytes holds no leaf")
    tables, cur_leaves, cur_words = [], [], []
    used = HEADER_BYTES

    def flush():
        nonlocal cur_leaves, cur_words, used
        if cur_words:
            tables.append(Table(tuple(cur_leaves), tuple(cur_words)))
        cur_leaves, cur_words, used = [], [], HEADER_BYTES

    for i, leaf in enumerate(leaves):
        done = 0
        while done < leaf.n_chunks:
            if used + LEAF_BYTES + WORD_BYTES > table_bytes:
                flush()
            pos = len(cur_leaves)
            cur_leaves.append(i)
            used += LEAF_BYTES
            take = min(leaf.n_chunks - done, (table_bytes - used) // WORD_BYTES)
            cur_words += [(done + k) << 16 | pos for k in range(take)]
            used += WORD_BYTES * take
            done += take
    flush()
    # every chunk index fits the word's 16 bits: a plan that fits one table
    # has fewer than 8,190 blocks, one that does not fewer than 2 * MIN_BLOCKS
    # or one chunk a leaf
    return LeafPlan(n_rows, itemsize, out_ld, leaves, tuple(tables),
                    table_bytes)


def pack_table(plan: LeafPlan, table: Table, outs, inputs, eta: float,
               thresh: float) -> bytes:
    """The launch parameter of one table: ``outs`` the two output planes'
    addresses; ``inputs[i]`` = ``(addresses (zh, g, c), row strides
    (zh, g, c) in elements, vec)`` of leaf ``i`` of the plan."""
    parts = [struct.pack(HEADER_FMT, outs[0], outs[1], plan.out_ld,
                         plan.n_rows, float(eta), float(thresh),
                         len(table.leaves), len(table.words), 0)]
    for i in table.leaves:
        (zh, g, c), (lz, lg, lc), vec = inputs[i]
        l = plan.leaves[i]
        parts.append(struct.pack(LEAF_FMT, zh, g, c, lz, lg, lc, l.width,
                                 l.col, l.chunk_rows, l.chunk_cols,
                                 l.chunks_per_row, l.tpr_log2, vec))
    parts.append(table.block_map)
    return b"".join(parts)


def _update_plain(plan: LeafPlan, leaves, outs, eta: float, thresh: float):
    """The CPU path: per leaf, its ``(n_rows, width)`` rows in each input
    (``as_strided`` by the input's row stride), the plain version, and the
    result written into the leaf's segment of the output planes."""
    for trio, leaf in zip(leaves, plan.leaves):
        if not leaf.n_chunks:
            continue
        size = (plan.n_rows, leaf.width)
        ins = [torch.as_strided(t, size, (ld, 1), t.storage_offset())
               for t, ld in trio]
        for out, val in zip(outs, fused_local_update_plain(*ins, eta,
                                                           thresh)):
            torch.as_strided(out, size, (plan.out_ld, 1),
                             out.storage_offset() + leaf.col).copy_(val)


def table_bytes(device) -> int:
    """The table size the kernels take on ``device``'s toolkit (the
    library's ``repro_fused_table_bytes``); CPU tensors plan as for a
    toolkit from CUDA 12.1."""
    if device.type == "cpu":
        return LARGE_TABLE
    return _library_table_bytes()


@functools.lru_cache(maxsize=None)
def _library_table_bytes() -> int:
    return int(_build.load_library().repro_fused_table_bytes())


def _update(plan: LeafPlan, leaves, outs, eta: float, thresh: float):
    """Launch the kernel on ``leaves`` (per leaf: ``(tensor, row stride)``
    of z_hat, grads and c) into the output planes ``outs``: one launch per
    table of the plan."""
    item = plan.itemsize
    inputs = []
    for trio in leaves:
        ptrs = tuple(t.data_ptr() for t, _ in trio)
        lds = tuple(ld for _, ld in trio)
        vec = all(p % 16 == 0 for p in ptrs) and (
            plan.n_rows == 1 or all(ld * item % 16 == 0 for ld in lds))
        inputs.append((ptrs, lds, int(vec)))
    out_ptrs = (outs[0].data_ptr(), outs[1].data_ptr())
    entry = _build.load_library().repro_fused_local_update
    code = _DTYPE_CODES[outs[0].dtype]
    for table in plan.tables:
        raw = pack_table(plan, table, out_ptrs, inputs, eta, thresh)
        _build.launch("fused_local_update", entry, outs[0].device, code, raw,
                      len(raw))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


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


@functools.lru_cache(maxsize=64)
def _plane_plan(numel: int, itemsize: int, nbytes: int) -> LeafPlan:
    return plan_leaves((numel,), 1, itemsize, nbytes)


def fused_local_update_2d(z_hat, grads, c, eta: float, thresh: float):
    """Fused update over a contiguous plane of any shape: the one-leaf
    case of the leaf table (one row of ``numel`` elements).

    CPU tensors take :func:`fused_local_update_plain`.  CUDA tensors
    launch the kernel or raise; nothing falls back.  ``eta`` and
    ``thresh`` are Python floats, passed to the kernel as doubles and
    rounded there to the compute type.
    """
    _check(z_hat, grads, c)
    if not _build.on_card("fused_local_update", z_hat):
        return fused_local_update_plain(z_hat, grads, c, eta, thresh)
    if not (z_hat.is_contiguous() and grads.is_contiguous()
            and c.is_contiguous()):
        raise ValueError("fused_local_update_2d needs contiguous inputs")
    plan = _plane_plan(z_hat.numel(), z_hat.element_size(),
                       table_bytes(z_hat.device))
    outs = (torch.empty_like(z_hat), torch.empty_like(z_hat))
    _update(plan, [((z_hat, 0), (grads, 0), (c, 0))], outs, eta, thresh)
    return outs


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for x in reversed(shape):
        out.append(n)
        n *= x
    return tuple(reversed(out))


@dataclass(frozen=True)
class _TreeLayout:
    """A tree's output planes ``(*batch, out_ld)``: the launch plan, and
    per leaf its full shape, the contiguous strides of one client's part
    (what an input leaf is checked against) and the strides and offset of
    its view in an output plane."""

    batch: tuple
    plan: LeafPlan
    shapes: tuple
    client_strides: tuple
    view_strides: tuple
    cols: tuple


def _tree_layout(shapes, dtype, batch_dims: int, nbytes: int) -> _TreeLayout:
    batch = shapes[0][:batch_dims]
    if any(len(s) < batch_dims or s[:batch_dims] != batch for s in shapes):
        raise ValueError(f"every leaf needs the same {batch_dims} leading "
                         f"batch axes; got shapes {list(shapes)}")
    client = tuple(s[batch_dims:] for s in shapes)
    plan = plan_leaves([math.prod(s) for s in client], math.prod(batch),
                       dtype.itemsize, nbytes)
    batch_strides = tuple(plan.out_ld * math.prod(batch[j + 1:])
                          for j in range(batch_dims))
    cstrides = tuple(_contiguous_strides(s) for s in client)
    return _TreeLayout(batch, plan, tuple(tuple(s) for s in shapes), cstrides,
                       tuple(batch_strides + c for c in cstrides),
                       tuple(l.col for l in plan.leaves))


_LAYOUTS: dict = {}


def _rows(t, batch_dims: int, shape):
    """``(tensor, row stride)``: ``t`` as rows of one contiguous run per
    client (``batch_dims`` leading axes merged into the rows), made
    contiguous first (and counted) when it is not."""
    if tuple(t.shape[batch_dims:]) != shape:
        raise ValueError(f"leaf shape {tuple(t.shape)} does not match "
                         f"{shape} (+{batch_dims} batch axes)")
    sizes, strides = t.shape, t.stride()
    expect, ok = 1, True
    for size, stride in zip(reversed(sizes[batch_dims:]),
                            reversed(strides[batch_dims:])):
        if size != 1 and stride != expect:
            ok = False
        expect *= size
    ld, outer = 0, None  # the innermost batch axis of more than one row
    for size, stride in zip(reversed(sizes[:batch_dims]),
                            reversed(strides[:batch_dims])):
        if size == 1:
            continue
        if outer is None:
            ld = stride
        elif stride != outer[1] * outer[0]:
            ok = False
        outer = (size, stride)
    if ok:
        return t, ld
    _build.count("fused_local_update_copies")
    return t.contiguous(), (expect if batch_dims else 0)


def _update_placed(zl, gl, cl, treedef, eta, thresh, batch_dims):
    """:func:`fused_local_update` on ``DTensor`` leaves, on local shards."""
    from torch.distributed.tensor import DTensor

    def like(t, z):
        if not _build.is_dtensor(t):
            raise TypeError("fused_local_update: a placed z_hat needs placed "
                            "grads and c")
        if t.device_mesh != z.device_mesh or t.placements != z.placements:
            t = t.redistribute(z.device_mesh, z.placements)
        return t.to_local()

    zh_out, z_out = [], []
    for z, g, cc in zip(zl, gl, cl):
        # leaf by leaf: a placed tree may mix dtypes (bf16 weights, f32
        # norms), which one plane cannot hold
        a, b = fused_local_update(z.to_local(), like(g, z), like(cc, z), eta,
                                  thresh, batch_dims=batch_dims)
        for out, acc in ((a, zh_out), (b, z_out)):
            acc.append(DTensor.from_local(
                out, z.device_mesh, z.placements, run_check=False,
                shape=z.shape, stride=z.stride()))
    return (tu.tree_unflatten(treedef, zh_out),
            tu.tree_unflatten(treedef, z_out))


def fused_local_update(z_hat, grads, c, eta: float, thresh: float, *,
                       batch_dims: int = 0):
    """Fused Algorithm-1 local update + L1 prox over a whole pytree, in one
    launch on the card (:func:`plan_leaves` splits a tree whose table
    exceeds the toolkit's parameter limit).

    ``batch_dims`` leading axes of every leaf are client rows.  Returns
    ``(z_hat_next, z_next)`` with the structure, shapes and dtype of
    ``z_hat``; each leaf is a view of one of two output planes
    ``(*batch, out_ld)``, as :func:`repro_torch.core.plane.unflatten`
    would give with the 16-byte aligned offsets of :func:`segment_offsets`.
    ``grads`` and ``c`` leaves of another dtype are cast first, and a leaf
    whose per-client part is not contiguous is made so: each such copy is
    counted as ``fused_local_update_copies`` in ``_build.COUNTS``.

    ``DTensor`` leaves (a placed tree) are updated shard by shard: the
    update is elementwise, so each rank runs it on its local blocks (the
    kernel on the card) once ``grads`` and ``c`` are laid out as
    ``z_hat`` (a redistribute, whose collectives are DTensor's), and the
    results are wrapped back with ``z_hat``'s placements.
    """
    zl, treedef = tu.tree_flatten(z_hat)
    gl, gdef = tu.tree_flatten(grads)
    cl, cdef = tu.tree_flatten(c)
    if gdef != treedef or cdef != treedef:
        raise ValueError("grads and c must have z_hat's tree structure")
    if not zl:
        raise ValueError("cannot update an empty tree")
    if _build.is_dtensor(zl[0]):
        return _update_placed(zl, gl, cl, treedef, eta, thresh, batch_dims)
    dtype, device = zl[0].dtype, zl[0].device
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype must be one of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {dtype}")
    if any(l.dtype != dtype for l in zl):
        raise ValueError("a flat plane holds exactly one dtype; got "
                         f"{sorted({str(l.dtype) for l in zl})}")
    card = _build.on_card("fused_local_update", zl[0])
    if any(l.device != device for l in (*zl, *gl, *cl)):
        raise ValueError("fused_local_update: leaves on different devices")
    key = (treedef, batch_dims, dtype, card, tuple(l.shape for l in zl))
    lay = _LAYOUTS.get(key)
    if lay is None:
        if len(_LAYOUTS) >= 64:
            _LAYOUTS.clear()
        lay = _LAYOUTS[key] = _tree_layout(
            key[4], dtype, batch_dims, table_bytes(device))
    leaves = []
    for z, g, cc, full, cst in zip(zl, gl, cl, lay.shapes,
                                   lay.client_strides):
        trio = []
        for t in (z, g, cc):
            if t.dtype != dtype:
                _build.count("fused_local_update_copies")
                t = t.to(dtype)
            st = t.stride()
            if batch_dims <= 1 and t.shape == full and st[batch_dims:] == cst:
                trio.append((t, st[0] if batch_dims else 0))
            else:
                trio.append(_rows(t, batch_dims, full[batch_dims:]))
        leaves.append(trio)
    shape = lay.batch + (lay.plan.out_ld,)
    outs = (torch.empty(shape, dtype=dtype, device=device),
            torch.empty(shape, dtype=dtype, device=device))
    if card:
        _update(lay.plan, leaves, outs, eta, thresh)
    else:
        _update_plain(lay.plan, leaves, outs, eta, thresh)
    return tuple(
        tu.tree_unflatten(treedef, [
            torch.as_strided(out, full, st, col) for full, st, col in
            zip(lay.shapes, lay.view_strides, lay.cols)])
        for out in outs)
