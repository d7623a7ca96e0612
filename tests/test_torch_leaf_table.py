"""The fused local update's leaf table and the shared launch path, on the CPU.

Kernel 1 (``csrc/fused_prox.cu``) updates every leaf of a pytree in one
launch from a table passed by value: a header, one entry per leaf and a
block map (``repro_torch.kernels.fused_prox``).  Here:

  * the table planner: segment offsets on 16-byte boundaries, the chunking
    (every element of every leaf covered by exactly one block, up to 2,000
    leaves), the packed bytes (addresses, row strides, vector choices) and
    the split into tables of 4,096 bytes for a toolkit before CUDA 12.1;
  * the CPU path of ``ops.fused_local_update`` (the plain version once per
    leaf), a walk of the table block by block (``torch.as_strided`` per
    chunk and the plain version) and a walk of the PACKED bytes through the
    addresses they hold, which stands in for the kernel: all bitwise equal
    to the plain version on a flattened plane (what
    ``ops.fused_local_update`` computed before the table), to
    ``repro.kernels.ref.fused_local_update`` in float64, and to the Pallas
    kernel run by the interpreter within
    ``4 * eps32 * max(|z_hat|, |eta*(g + c)|)`` in float32 (it contracts
    the update into an FMA);
  * kernel 4 (``csrc/plane_ops.cu``): float32 weights on a float64
    plane go to the kernel as they are (no cast launch) and give the bits
    of weights cast first;
  * the launch path with a mocked library: one launch per call, the
    counters, and a refused launch raising;
  * importing the port decides nothing about a card.
"""
import ctypes
import math
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import _build, fused_prox, ops, plane_ops
from repro_torch.utils import tree as tu

EPS32 = float(np.finfo(np.float32).eps)
ETA, THRESH = 0.37, 0.21


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view({4: np.uint32, 8: np.uint64, 2: np.uint16}[x.itemsize])


def _tree(shapes, n, dtype, seed, specials=True):
    """{leaf_i: (n, *shape)} of normals, with NaN / +-0 / +-inf / thresh in
    the first leaf."""
    rng = np.random.default_rng(seed)
    t = {f"l{i:03d}": rng.normal(size=(n,) + s).astype(dtype)
         for i, s in enumerate(shapes)}
    if specials:
        first = t["l000"].reshape(n, -1)
        k = min(first.shape[1], 6)
        first[0, :k] = [np.nan, -0.0, np.inf, -np.inf, THRESH, 0.0][:k]
    return t


def _torch(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def _flat_reference(zh, g, c, batch_dims):
    """What ``ops.fused_local_update`` computed before the table: flatten
    the three trees to one plane each, the plain version, unflatten."""
    from repro_torch.core import plane as pln

    spec = pln.SegmentSpec.from_tree(zh, batch_dims=batch_dims, tile=1)
    planes = [pln.flatten(spec, t).contiguous() for t in (zh, g, c)]
    a, b = fused_prox.fused_local_update_plain(*planes, ETA, THRESH)
    return pln.unflatten(spec, a), pln.unflatten(spec, b)


def _assert_trees_bitwise(got, exp):
    for k in exp:
        assert tuple(got[k].shape) == tuple(exp[k].shape), k
        np.testing.assert_array_equal(_bits(got[k].numpy().copy()),
                                      _bits(exp[k].numpy().copy()), err_msg=k)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def test_segment_offsets_start_on_16_bytes():
    cols, ld = fused_prox.segment_offsets((20, 1, 7, 0, 3), 8)
    assert cols == (0, 20, 22, 30, 30) and ld == 34
    cols, ld = fused_prox.segment_offsets((20, 1, 7), 4)
    assert cols == (0, 20, 24) and ld == 32
    cols, ld = fused_prox.segment_offsets((1,), 2)
    assert cols == (0,) and ld == 8


def _chunk_rect(plan, leaf, chunk: int):
    """``(r0, r1, c0, c1)``: the rows and columns of a leaf that a chunk
    covers (the kernel's arithmetic)."""
    rc, cc = divmod(chunk, leaf.chunks_per_row)
    r0 = rc * leaf.chunk_rows
    c0 = cc * leaf.chunk_cols
    return (r0, min(r0 + leaf.chunk_rows, plan.n_rows), c0,
            min(c0 + leaf.chunk_cols, leaf.width))


def _assert_tiled(plan):
    """Every (row, column) of every leaf lies in exactly one block's chunk,
    and every table fits its size."""
    spans = [[[] for _ in range(plan.n_rows)] for _ in plan.leaves]
    for table in plan.tables:
        assert table.nbytes <= plan.table_bytes
        for word in table.words:
            i = table.leaves[word & 0xFFFF]
            r0, r1, c0, c1 = _chunk_rect(plan, plan.leaves[i], word >> 16)
            assert 0 <= r0 < r1 <= plan.n_rows and 0 <= c0 < c1
            for r in range(r0, r1):
                spans[i][r].append((c0, c1))
    for leaf, rows in zip(plan.leaves, spans):
        for row in rows:
            at = 0
            for c0, c1 in sorted(row):
                assert c0 == at
                at = c1
            assert at == leaf.width


@pytest.mark.parametrize("widths,n_rows,itemsize", [
    ((20, 1), 30, 8),             # the paper tree
    ((112_394, 1), 30, 8),        # the wide tree
    ((4_194_304,), 30, 4),        # a wide plane, one leaf per row
    ((125_829_120,), 1, 2),       # (30, 4,194,304) bf16 as one row
    ((5,) * 200, 30, 8),          # 200 narrow leaves
    ((5,) * 600, 30, 8),          # one chunk a leaf, more than one table
    ((5,) * 2000, 30, 8),
    ((3, 0, 4097, 1, 256), 7, 4),  # an empty leaf, ragged widths
])
@pytest.mark.parametrize("nbytes", [fused_prox.LARGE_TABLE,
                                    fused_prox.SMALL_TABLE])
def test_block_map_covers_every_element_once(widths, n_rows, itemsize,
                                             nbytes):
    plan = fused_prox.plan_leaves(widths, n_rows, itemsize, nbytes)
    _assert_tiled(plan)
    for leaf in plan.leaves:
        n = 16 // itemsize
        assert leaf.col % n == 0 and plan.out_ld % n == 0
        if leaf.chunks_per_row > 1:  # chunks of a row start 16-byte aligned
            assert leaf.chunk_rows == 1 and leaf.chunk_cols % n == 0
            assert leaf.tpr_log2 == 8
        elif leaf.n_chunks:  # the threads of a row cover its vectors
            assert 2 ** leaf.tpr_log2 >= min(-(-leaf.width // n), 256)
    assert sum(len(t.words) for t in plan.tables) == sum(
        l.n_chunks for l in plan.leaves)


def test_one_table_on_the_main_path_and_the_4kb_split():
    paper = fused_prox.plan_leaves((20, 1), 30, 8)
    assert len(paper.tables) == 1 and paper.tables[0].words == (0, 1)
    assert [l.n_chunks for l in paper.leaves] == [1, 1]
    wide = fused_prox.plan_leaves((112_394, 1), 30, 8)
    assert len(wide.tables) == 1  # one launch per step from CUDA 12.1
    assert fused_prox.SMALL_TABLE < wide.tables[0].nbytes
    assert wide.tables[0].nbytes <= fused_prox.LARGE_TABLE
    # before CUDA 12.1: the wide leaf's chunks widen until they fit 4 KB
    small = fused_prox.plan_leaves((112_394, 1), 30, 8,
                                   fused_prox.SMALL_TABLE)
    assert len(small.tables) == 1
    assert small.leaves[0].chunk_cols > wide.leaves[0].chunk_cols
    # 200 leaves cannot share 4 KB: several launches, each within it
    many = fused_prox.plan_leaves((5,) * 200, 30, 8, fused_prox.SMALL_TABLE)
    assert len(many.tables) == 5
    assert all(t.nbytes <= fused_prox.SMALL_TABLE for t in many.tables)
    assert sorted(i for t in many.tables for i in t.leaves) == list(
        range(200))
    assert len(fused_prox.plan_leaves((5,) * 200, 30, 8).tables) == 1
    # a leaf whose chunks overflow a table continues in the next one
    split = fused_prox.plan_leaves((100,) * 40 + (2_000_000,), 30, 8,
                                   fused_prox.SMALL_TABLE)
    owners = [t.leaves for t in split.tables if 40 in t.leaves]
    assert len(owners) >= 2
    # leaves of one chunk each that no table holds: one launch per table
    for n, nbytes, tables in ((600, fused_prox.LARGE_TABLE, 2),
                              (2000, fused_prox.LARGE_TABLE, 6),
                              (600, fused_prox.SMALL_TABLE, 13)):
        plan = fused_prox.plan_leaves((5,) * n, 30, 8, nbytes)
        assert [l.n_chunks for l in plan.leaves] == [1] * n
        assert len(plan.tables) == tables


def test_packed_table_layout():
    plan = fused_prox.plan_leaves((20, 1), 30, 8)
    inputs = [((1024, 2048, 4096), (22, 20, 0), 1),
              ((8, 16, 24), (22, 1, 1), 0)]
    raw = fused_prox.pack_table(plan, plan.tables[0], (111, 222), inputs,
                                ETA, THRESH)
    assert len(raw) == plan.tables[0].nbytes == 64 + 2 * 80 + 2 * 4
    head = struct.unpack_from(fused_prox.HEADER_FMT, raw, 0)
    assert head == (111, 222, 22, 30, ETA, THRESH, 2, 2, 0)
    leaf0 = struct.unpack_from(fused_prox.LEAF_FMT, raw, 64)
    assert leaf0 == (1024, 2048, 4096, 22, 20, 0, 20, 0, 30, 20, 1, 4, 1)
    leaf1 = struct.unpack_from(fused_prox.LEAF_FMT, raw, 144)
    assert leaf1 == (8, 16, 24, 22, 1, 1, 1, 20, 30, 1, 1, 0, 0)
    assert struct.unpack_from("<2I", raw, 224) == (0, 1)


# ---------------------------------------------------------------------------
# the walks against the reference
# ---------------------------------------------------------------------------

_TREES = {
    "paper": [(20,), ()],
    "ragged": [(3, 5), (7,), (), (1, 4, 2)],
    "200 leaves": [((i * 7) % 13 + 1,) for i in range(200)],
}
_MANY = [((i * 7) % 13 + 1,) for i in range(600)]  # more than one table


@pytest.mark.parametrize("tree", sorted(_TREES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_cpu_update_equals_the_flattened_plane(tree, dtype):
    zh, g, c = (_tree(_TREES[tree], 30, dtype, seed=s, specials=s == 0)
                for s in range(3))
    got = ops.fused_local_update(_torch(zh), _torch(g), _torch(c), ETA,
                                 THRESH, batch_dims=1)
    exp = _flat_reference(_torch(zh), _torch(g), _torch(c), 1)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


@pytest.mark.parametrize("tree", sorted(_TREES))
def test_cpu_update_equals_the_reference_f64(tree):
    # specials in z_hat only: where g + c is inf - inf both give a NaN, but
    # XLA and PyTorch set its sign bit differently
    zh, g, c = (_tree(_TREES[tree], 30, np.float64, seed=s, specials=s == 0)
                for s in range(3))
    got_zh, got_z = ops.fused_local_update(_torch(zh), _torch(g), _torch(c),
                                           ETA, THRESH, batch_dims=1)
    for k in zh:
        e_zh, e_z = ref.fused_local_update(jnp.asarray(zh[k]),
                                           jnp.asarray(g[k]),
                                           jnp.asarray(c[k]), ETA, THRESH)
        np.testing.assert_array_equal(_bits(got_zh[k].numpy().copy()),
                                      _bits(np.asarray(e_zh)))
        np.testing.assert_array_equal(_bits(got_z[k].numpy().copy()),
                                      _bits(np.asarray(e_z)))


@pytest.mark.parametrize("tree", ["paper", "ragged"])
def test_cpu_update_matches_pallas_interpret_f32(tree):
    """Unbatched trees (the Pallas path flattens one plane per tree)."""
    zh, g, c = ({k: np.ascontiguousarray(v[0]) for k, v in _tree(
        _TREES[tree], 1, np.float32, seed=s, specials=False).items()}
                for s in range(3))
    exp_zh, exp_z = jops.fused_local_update(
        *({k: jnp.asarray(v) for k, v in t.items()} for t in (zh, g, c)),
        ETA, THRESH, interpret=True, block_rows=8)
    got_zh, got_z = ops.fused_local_update(_torch(zh), _torch(g), _torch(c),
                                           ETA, THRESH)
    for k in zh:
        atol = 4 * EPS32 * np.maximum(np.abs(zh[k]),
                                      np.abs(np.float32(ETA) * (g[k] + c[k])))
        assert np.all(np.abs(got_zh[k].numpy() - np.asarray(exp_zh[k]))
                      <= atol)
        assert np.all(np.abs(got_z[k].numpy() - np.asarray(exp_z[k]))
                      <= atol)


def test_600_leaves_equal_the_flattened_plane():
    zh, g, c = (_torch(_tree(_MANY, 30, np.float64, seed=s))
                for s in range(3))
    got = ops.fused_local_update(zh, g, c, ETA, THRESH, batch_dims=1)
    exp = _flat_reference(zh, g, c, 1)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


def _walk_table(plan, leaves, outs):
    """The kernel's work walked block by block on the CPU: per block word,
    ``as_strided`` views of its chunk in each input and output, and the
    plain version."""
    for table in plan.tables:
        for word in table.words:
            i = table.leaves[word & 0xFFFF]
            leaf = plan.leaves[i]
            r0, r1, c0, c1 = _chunk_rect(plan, leaf, word >> 16)
            size = (r1 - r0, c1 - c0)
            views = [torch.as_strided(t, size, (ld, 1),
                                      t.storage_offset() + r0 * ld + c0)
                     for t, ld in leaves[i]]
            vals = fused_prox.fused_local_update_plain(*views, ETA, THRESH)
            for out, val in zip(outs, vals):
                torch.as_strided(out, size, (plan.out_ld, 1),
                                 out.storage_offset() + r0 * plan.out_ld
                                 + leaf.col + c0).copy_(val)


@pytest.mark.parametrize("tree", sorted(_TREES) + ["600 leaves"])
@pytest.mark.parametrize("nbytes", [fused_prox.LARGE_TABLE,
                                    fused_prox.SMALL_TABLE])
def test_table_walk_equals_the_cpu_update(tree, nbytes):
    shapes = _MANY if tree == "600 leaves" else _TREES[tree]
    zh, g, c = (_torch(_tree(shapes, 30, np.float64, seed=s,
                             specials=s == 0)) for s in range(3))
    got = ops.fused_local_update(zh, g, c, ETA, THRESH, batch_dims=1)
    keys = sorted(zh)  # the trees' leaf order
    widths = [math.prod(zh[k].shape[1:]) for k in keys]
    plan = fused_prox.plan_leaves(widths, 30, 8, nbytes)
    leaves = [[(t[k], w) for t in (zh, g, c)] for k, w in zip(keys, widths)]
    outs = [torch.full((30, plan.out_ld), np.nan, dtype=torch.float64)
            for _ in range(2)]
    _walk_table(plan, leaves, outs)
    for out, tree_out in zip(outs, got):
        for k, w, leaf in zip(keys, widths, plan.leaves):
            np.testing.assert_array_equal(
                _bits(out[:, leaf.col:leaf.col + w].numpy().copy()),
                _bits(tree_out[k].reshape(30, -1).numpy().copy()), err_msg=k)


def test_strided_views_are_read_in_place():
    """z_hat as views of a previous output plane (the tau loop), c as a
    broadcast of one row (the first round), grads contiguous: no copy, and
    the same bits as the flattened plane."""
    zh0, g, c1 = (_tree(_TREES["paper"], 30, np.float64, seed=s)
                  for s in range(3))
    zh, _ = ops.fused_local_update(_torch(zh0), _torch(g), _torch(c1), ETA,
                                   THRESH, batch_dims=1)
    assert zh["l000"].stride() == (22, 1) and not zh["l000"].is_contiguous()
    c = tu.tree_broadcast_axis0({k: v[3] for k, v in _torch(c1).items()}, 30)
    assert c["l000"].stride() == (0, 1)
    before = _build.COUNTS["fused_local_update_copies"]
    got = ops.fused_local_update(zh, _torch(g), c, ETA, THRESH, batch_dims=1)
    assert _build.COUNTS["fused_local_update_copies"] == before
    exp = _flat_reference(zh, _torch(g), c, 1)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


def test_non_contiguous_leaves_are_copied_and_counted():
    zh, g, c = (_torch(_tree([(4, 6)], 5, np.float64, seed=s))
                for s in range(3))
    g_t = {"l000": g["l000"].transpose(1, 2).contiguous().transpose(1, 2)}
    assert not g_t["l000"][0].is_contiguous()
    c32 = {"l000": c["l000"].float()}
    before = _build.COUNTS["fused_local_update_copies"]
    got = ops.fused_local_update(zh, g_t, c32, ETA, THRESH, batch_dims=1)
    assert _build.COUNTS["fused_local_update_copies"] == before + 2
    exp = _flat_reference(zh, g, {"l000": c32["l000"].double()}, 1)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


def test_two_batch_axes_merge_into_client_rows():
    """batch_dims=2: leading axes that merge into one row stride are read
    in place; batch axes that do not (a transposed pair) are copied."""
    rng = np.random.default_rng(6)
    mk = lambda: {"w": torch.from_numpy(rng.normal(size=(3, 4, 5))),
                  "b": torch.from_numpy(rng.normal(size=(3, 4)))}
    zh, g, c = mk(), mk(), mk()
    before = _build.COUNTS["fused_local_update_copies"]
    got = ops.fused_local_update(zh, g, c, ETA, THRESH, batch_dims=2)
    assert _build.COUNTS["fused_local_update_copies"] == before
    exp = _flat_reference(zh, g, c, 2)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)
    g_t = {"w": g["w"].transpose(0, 1).contiguous().transpose(0, 1),
           "b": g["b"]}
    got = ops.fused_local_update(zh, g_t, c, ETA, THRESH, batch_dims=2)
    assert _build.COUNTS["fused_local_update_copies"] == before + 1
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


def test_tree_entry_checks_its_inputs():
    a = {"w": torch.zeros(3, 4), "b": torch.zeros(3)}
    with pytest.raises(ValueError, match="tree structure"):
        ops.fused_local_update(a, {"w": a["w"]}, a, ETA, THRESH)
    with pytest.raises(ValueError, match="does not match"):
        ops.fused_local_update(a, {"w": torch.zeros(3, 5), "b": a["b"]}, a,
                               ETA, THRESH, batch_dims=1)
    with pytest.raises(ValueError, match="batch axes"):
        ops.fused_local_update({"w": torch.zeros(3, 4),
                                "b": torch.zeros(2)}, a, a, ETA, THRESH,
                               batch_dims=1)
    m = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="no fused_local_update kernel"):
        ops.fused_local_update(m, m, m, ETA, THRESH)


# ---------------------------------------------------------------------------
# the launch path, with a mocked library
# ---------------------------------------------------------------------------


def _read(addr: int, count: int, dtype) -> np.ndarray:
    buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(
        addr)
    return np.frombuffer(buf, dtype=dtype)


def _run_packed(raw: bytes, dtype) -> None:
    """The kernel's work, read from the packed table alone: per block word,
    each row of its chunk through the addresses and strides the table
    holds, the plain version, the results written where the table says."""
    (zo, z2o, out_ld, n_rows, eta, thresh, n_leaves,
     n_blocks, _) = struct.unpack_from(fused_prox.HEADER_FMT, raw, 0)
    leaves = [struct.unpack_from(fused_prox.LEAF_FMT, raw,
                                 64 + 80 * i) for i in range(n_leaves)]
    words = struct.unpack_from(f"<{n_blocks}I", raw, 64 + 80 * n_leaves)
    item = np.dtype(dtype).itemsize
    for word in words:
        (a, b, c, la, lb, lc, width, col, crows, ccols, cpr, _tpr,
         _vec) = leaves[word & 0xFFFF]
        rc, cc = divmod(word >> 16, cpr)
        c0 = cc * ccols
        nc = min(ccols, width - c0)
        for r in range(rc * crows, min(rc * crows + crows, n_rows)):
            ins = [torch.from_numpy(_read(base + (r * ld + c0) * item, nc,
                                          dtype).copy())
                   for base, ld in ((a, la), (b, lb), (c, lc))]
            u, z = fused_prox.fused_local_update_plain(*ins, eta, thresh)
            for out, val in ((zo, u), (z2o, z)):
                _read(out + (r * out_ld + col + c0) * item, nc,
                      dtype)[:] = val.numpy()


class _FakeLibrary:
    """The entries the wrappers call, returning ``rc``; with ``run`` the
    fused entry does the kernel's work from the packed table."""

    def __init__(self, rc=0, run=True, dtype=np.float64):
        self.rc, self.run, self.dtype, self.calls = rc, run, dtype, []

    def repro_fused_local_update(self, code, raw, nbytes, stream):
        self.calls.append(("fused", code, raw, nbytes, stream))
        if self.rc == 0 and self.run:
            _run_packed(raw, self.dtype)
        return self.rc

    def repro_weighted_commit(self, *args):
        self.calls.append(("commit",) + args)
        return self.rc

    def repro_weighted_commit_loads(self, *args):
        self.calls.append(("commit loads",) + args)
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the card's path into a fake library."""
    def install(lib):
        monkeypatch.setattr(_build, "on_card", lambda name, t: True)
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        monkeypatch.setattr(_build, "stream_handle", lambda index: 7)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
        return lib
    return install


@pytest.mark.parametrize("tree", sorted(_TREES))
def test_one_launch_per_call_from_the_packed_table(fake_card, tree):
    lib = fake_card(_FakeLibrary())
    zh, g, c = (_torch(_tree(_TREES[tree], 30, np.float64, seed=s))
                for s in range(3))
    before = _build.COUNTS["fused_local_updates"]
    got = ops.fused_local_update(zh, g, c, ETA, THRESH, batch_dims=1)
    assert _build.COUNTS["fused_local_updates"] == before + 1
    (kind, code, raw, nbytes, stream), = lib.calls
    assert (kind, code, nbytes, stream) == ("fused", 1, len(raw), 7)
    exp = _flat_reference(zh, g, c, 1)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


@pytest.mark.parametrize("nbytes,tables", [(fused_prox.LARGE_TABLE, 2),
                                           (fused_prox.SMALL_TABLE, 13)])
def test_600_leaves_launch_once_per_table(fake_card, monkeypatch, nbytes,
                                          tables):
    lib = fake_card(_FakeLibrary())
    monkeypatch.setattr(fused_prox, "table_bytes", lambda device: nbytes)
    monkeypatch.setattr(fused_prox, "_LAYOUTS", {})  # planned anew
    zh, g, c = (_torch(_tree(_MANY, 30, np.float64, seed=s))
                for s in range(3))
    before = _build.COUNTS["fused_local_updates"]
    got = ops.fused_local_update(zh, g, c, ETA, THRESH, batch_dims=1)
    assert _build.COUNTS["fused_local_updates"] == before + tables
    assert len(lib.calls) == tables
    assert all(nbytes_ <= nbytes for *_, nbytes_, _ in lib.calls)
    exp = _flat_reference(zh, g, c, 1)
    for a, b in zip(got, exp):
        _assert_trees_bitwise(a, b)


def test_packed_table_names_the_inputs_in_place(fake_card):
    lib = fake_card(_FakeLibrary(run=False))
    base = torch.zeros(30, 23, dtype=torch.float64)
    zh = {"w": base[:, 1:21], "b": base[:, 22]}  # 8 bytes off 16
    g = {"w": torch.ones(30, 20, dtype=torch.float64),
         "b": torch.ones(30, dtype=torch.float64)}
    c = tu.tree_broadcast_axis0({"w": torch.ones(20, dtype=torch.float64),
                                 "b": torch.ones((), dtype=torch.float64)},
                                30)
    out_zh, out_z = ops.fused_local_update(zh, g, c, ETA, THRESH,
                                           batch_dims=1)
    raw = lib.calls[0][2]
    head = struct.unpack_from(fused_prox.HEADER_FMT, raw, 0)
    assert head[:4] == (out_zh["b"].data_ptr(), out_z["b"].data_ptr(), 22, 30)
    b, w = (struct.unpack_from(fused_prox.LEAF_FMT, raw, 64 + 80 * i)
            for i in range(2))  # jax order: b, w
    assert b[:8] == (zh["b"].data_ptr(), g["b"].data_ptr(),
                     c["b"].data_ptr(), 23, 1, 0, 1, 0)
    assert w[:8] == (zh["w"].data_ptr(), g["w"].data_ptr(),
                     c["w"].data_ptr(), 23, 20, 0, 20, 2)
    assert w[-1] == 0 and b[-1] == 0  # 23 * 8 bytes: rows off 16
    assert out_zh["w"].data_ptr() == out_zh["b"].data_ptr() + 2 * 8
    aligned = {"w": torch.zeros(30, 20, dtype=torch.float64),
               "b": torch.zeros(30, 2, dtype=torch.float64)[:, 0]}
    ops.fused_local_update(aligned, g, c, ETA, THRESH, batch_dims=1)
    raw = lib.calls[1][2]
    b, w = (struct.unpack_from(fused_prox.LEAF_FMT, raw, 64 + 80 * i)
            for i in range(2))
    assert w[-1] == 1 and b[-1] == 0  # b: g's rows are 8 bytes apart


def test_plane_entry_is_the_one_leaf_case(fake_card):
    lib = fake_card(_FakeLibrary(dtype=np.float32))
    rng = np.random.default_rng(4)
    zh, g, c = (torch.from_numpy(rng.normal(size=(7, 1001)).astype(
        np.float32)) for _ in range(3))
    before = _build.COUNTS["fused_local_updates"]
    got = fused_prox.fused_local_update_2d(zh, g, c, ETA, THRESH)
    assert _build.COUNTS["fused_local_updates"] == before + 1
    raw = lib.calls[0][2]
    head = struct.unpack_from(fused_prox.HEADER_FMT, raw, 0)
    assert head[3] == 1 and head[6] == 1  # one row, one leaf
    exp = fused_prox.fused_local_update_plain(zh, g, c, ETA, THRESH)
    for a, b in zip(got, exp):
        assert a.shape == (7, 1001) and a.is_contiguous()
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


def test_refused_launch_raises_and_is_not_counted(fake_card):
    fake_card(_FakeLibrary(rc=700))
    zh = {"w": torch.ones(3, 4, dtype=torch.float64)}
    before = (_build.COUNTS["fused_local_updates"],
              _build.COUNTS["weighted_commits"])
    with pytest.raises(RuntimeError, match="fused_local_update kernel launch "
                       "failed: cudaError 700"):
        ops.fused_local_update(zh, zh, zh, ETA, THRESH, batch_dims=1)
    with pytest.raises(RuntimeError, match="weighted_commit kernel launch "
                       "failed: cudaError 700"):
        plane_ops.weighted_commit_2d(torch.ones(3, 8, dtype=torch.float64),
                                     torch.ones(3, dtype=torch.float32))
    assert (_build.COUNTS["fused_local_updates"],
            _build.COUNTS["weighted_commits"]) == before


# ---------------------------------------------------------------------------
# kernel 4: the weights' dtype
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane,weights", [(torch.float64, torch.float32),
                                           (torch.float32, torch.float64),
                                           (torch.bfloat16, torch.float64)],
                         ids=str)
def test_commit_weights_in_their_own_dtype_give_the_cast_bits(plane,
                                                              weights):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(30, 128)) * np.exp(
        rng.uniform(-6, 6, (30, 1)))).to(plane)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, 30) / 3.0).to(weights)
    w[::4] = 0
    work = torch.float64 if plane == torch.float64 else torch.float32
    got = plane_ops.weighted_commit_2d(x, w)
    exp = plane_ops.weighted_commit_2d(x, w.to(work))
    assert got.dtype == plane
    np.testing.assert_array_equal(_bits(got.view(torch.int16).numpy()
                                        if plane == torch.bfloat16
                                        else got.numpy()),
                                  _bits(exp.view(torch.int16).numpy()
                                        if plane == torch.bfloat16
                                        else exp.numpy()))


def test_commit_wrapper_passes_the_weights_as_they_are(fake_card):
    lib = fake_card(_FakeLibrary())
    x = torch.ones(30, 128, dtype=torch.float64)[:, :112]  # strided rows
    w = torch.ones(30, dtype=torch.float32)
    before = _build.COUNTS["weighted_commits"]
    out = plane_ops.weighted_commit_2d(x, w)
    assert _build.COUNTS["weighted_commits"] == before + 1
    (_, code, w_code, xp, wp, op, n_rows, n_cols, ld, stream), = lib.calls
    assert (code, w_code, n_rows, n_cols, ld, stream) == (1, 0, 30, 112, 128,
                                                          7)
    assert (xp, wp, op) == (x.data_ptr(), w.data_ptr(), out.data_ptr())
    plane_ops.weighted_commit_2d(x, w.to(torch.float16))  # widened first
    assert lib.calls[1][2] == 0
    plane_ops.weighted_commit_2d(x, w, loads=True)  # the plain-load entry
    assert lib.calls[2][0] == "commit loads" and lib.calls[2][1:3] == (1, 0)
    assert _build.COUNTS["weighted_commits"] == before + 3
    with pytest.raises(ValueError, match="contiguous"):
        plane_ops.weighted_commit_2d(torch.ones(8, 30).t(), w)


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def test_importing_the_port_asks_nothing_of_a_card():
    """Every module of the port imports with torch.cuda's queries made to
    fail: nothing at import time decides whether a card exists."""
    code = """
import torch
def boom(*a, **k):
    raise AssertionError("a card was queried at import time")
for name in ("is_available", "device_count", "current_device",
             "get_device_name", "current_stream", "init"):
    setattr(torch.cuda, name, boom)
import pkgutil, importlib, repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
