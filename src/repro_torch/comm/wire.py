"""The wire format: length-prefixed, bitwise serialization of uplink trees.

The counterpart of :mod:`repro.comm.wire`: for the same tree the frames are
byte-identical to the reference's, and each package decodes the other's.
Two hard contracts:

  * **bitwise round-trip** -- ``decode(encode(tree))`` reproduces every
    array leaf bit for bit (dtype, shape, contents, including ``-0.0`` and
    NaN payloads).  The runtime's parity pin (worker trajectory ==
    single-process engine) rests on this;
  * **loud failure** -- a truncated stream, a flipped bit, or a foreign
    protocol on the port raises :class:`WireError`; nothing deserializes
    garbage.

Frame layout (big-endian)::

    MAGIC 'RPW1' | u8 version | u8 type | u16 reserved
    | u32 crc32(payload) | u64 payload length | payload

Payload layout: ``u32 header length | JSON header | binary blob``.  The
JSON header is the recursive structure of the tree (dicts / lists / tuples
/ scalars / ``None``); array leaves carry ``(dtype, shape, offset,
nbytes)`` and their raw bytes live contiguously in the blob.  The encoder
keeps a dict's insertion order, as the reference's does: a caller that
wants the reference's bytes for a tree JAX would have rebuilt (anything out
of ``jax.tree_util`` or ``jax.eval_shape``, whose dicts come back with
sorted keys) sorts it first (:func:`repro_torch.utils.tree.canonical`).

Leaves, in the port's terms:

  * a tensor is fetched with ``.detach().cpu()`` (THE host sync of a send)
    and written under its numpy dtype name (``torch.float64`` ->
    ``"float64"``).  ``bfloat16``, which numpy lacks here, ships as its raw
    2-byte pattern under the name ``"bfloat16"`` -- the bytes the
    reference's ``ml_dtypes`` arrays carry -- and decodes to a CPU
    ``torch.bfloat16`` tensor; every other dtype decodes to a numpy array;
  * a ``meta`` tensor (what :func:`repro_torch.device.eval_shape` returns)
    is a spec: it encodes as the reference's ``"sds"`` node (its
    ``ShapeDtypeStruct``) and an ``"sds"`` node decodes to a meta tensor.

The decoder is stricter than the reference's in one place: it refuses a
frame whose type byte is not a known frame type or whose reserved field is
not zero (the CRC covers only the payload; the reference reads neither
field), and ``expect=`` refuses a valid frame of another type.

Compressed planes get *real* small frames, not dense arrays of zeros
(:func:`pack_plane`): ``"sparse"`` (nonzero (index, value) pairs, by bit
pattern, so a surviving ``-0.0`` survives) and ``"palette"`` (per-row value
table + small integer codes; dense when a table would not shrink the
frame).  Both are bitwise re-encodings.  Socket helpers
(:func:`send_frame` / :func:`recv_frame`) are plain blocking
``sendall``/``recv`` over any stream socket.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.obs import trace as _trace

MAGIC = b"RPW1"
VERSION = 1

# MAGIC | version | type | reserved | crc32 | payload length
_HEADER = struct.Struct(">4sBBHIQ")
HEADER_BYTES = _HEADER.size

# frame types of the federation runtime (repro_torch.fed.runtime)
T_HELLO = 1   # worker -> server: shard geometry + message/aux specs
T_CHUNK = 2   # worker -> server: one chunk of compressed uplink messages
T_ACK = 3     # server -> worker: receipt (commit version, arrival time)
T_MODEL = 4   # server -> worker: global server-role fields
T_BYE = 5     # either direction: orderly shutdown
T_RESULT = 6  # server: final result artifact (also the on-disk format)
T_SNAP = 7    # server -> replica: one serving-snapshot delta or keyframe

FRAME_TYPES = {T_HELLO: "hello", T_CHUNK: "chunk", T_ACK: "ack",
               T_MODEL: "model", T_BYE: "bye", T_RESULT: "result",
               T_SNAP: "snap"}

# refuse absurd lengths before allocating: a foreign protocol's first 8
# bytes interpreted as a length must not OOM the receiver
MAX_PAYLOAD = 1 << 38  # 256 GB


class WireError(Exception):
    """A frame failed to parse: truncation, corruption, or foreign bytes."""


# ---------------------------------------------------------------------------
# dtypes and host leaves
# ---------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """The wire (numpy) name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _numpy_dtype(name: str) -> Optional[np.dtype]:
    """The numpy dtype of a wire name, ``None`` for one numpy lacks (also
    where ``ml_dtypes``, if some other package imported it, has taught
    numpy the name: the port's decoding does not depend on that)."""
    try:
        dt = np.dtype(name)
    except TypeError:
        return None
    return None if dt.kind == "V" else dt


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise WireError(f"unknown dtype on the wire: {name!r}")
    return dt


def _uint(itemsize: int) -> np.dtype:
    return np.dtype(f"u{itemsize}")


def _to_host(x):
    """A leaf as a contiguous host array: numpy for the dtypes numpy has, a
    CPU tensor for the others (bfloat16).  On a CUDA tensor this is the
    send's host sync; callers that overlap comm with compute fetch on the
    sender thread."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if _numpy_dtype(dtype_name(t.dtype)) is None:
            return t.contiguous()
        a = t.resolve_conj().resolve_neg().numpy()
    else:
        a = np.asarray(x)
    # NB ascontiguousarray promotes 0-d to 1-d; 0-d is already contiguous
    if a.ndim and not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a)
    return a


def _bits(h) -> tuple:
    """(unsigned-integer view of a host leaf's bits, its wire dtype name)."""
    if isinstance(h, torch.Tensor):
        size = h.element_size()
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[size]
        return (h.contiguous().view(ints).numpy().view(_uint(size)),
                dtype_name(h.dtype))
    if h.dtype.itemsize not in (1, 2, 4, 8):
        raise WireError(f"no bit view for dtype {h.dtype}")
    return h.view(_uint(h.dtype.itemsize)), h.dtype.name


def _from_bits(u: np.ndarray, name: str):
    """Inverse of :func:`_bits`: a numpy array, or a CPU tensor for a dtype
    numpy lacks (sharing ``u``'s memory either way)."""
    dt = _numpy_dtype(name)
    if dt is not None:
        return u.view(dt)
    tdt = torch_dtype(name)
    signed = np.dtype(f"i{u.dtype.itemsize}")
    if not u.flags["C_CONTIGUOUS"]:
        u = np.ascontiguousarray(u)
    return torch.from_numpy(u.view(signed)).view(tdt)


def _host_nbytes(h) -> int:
    return (h.numel() * h.element_size() if isinstance(h, torch.Tensor)
            else h.nbytes)


# ---------------------------------------------------------------------------
# tree codec
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    """A shape-and-dtype leaf: a meta tensor, or a ``ShapeDtypeStruct``."""
    if isinstance(x, torch.Tensor):
        return x.device.type == "meta"
    return type(x).__name__ == "ShapeDtypeStruct" and hasattr(x, "dtype")


def _enc(x, blob: bytearray):
    if x is None:
        return {"k": "none"}
    if isinstance(x, bool) or isinstance(x, np.bool_):
        return {"k": "bool", "v": bool(x)}
    if isinstance(x, int):
        return {"k": "int", "v": x}
    if isinstance(x, float):
        # json emits repr, which round-trips float64 exactly
        return {"k": "float", "v": x}
    if isinstance(x, str):
        return {"k": "str", "v": x}
    if isinstance(x, (bytes, bytearray)):
        off = len(blob)
        blob += x
        return {"k": "bytes", "off": off, "nb": len(x)}
    if isinstance(x, dict):
        keys = list(x.keys())
        if not all(isinstance(k, str) for k in keys):
            raise WireError(
                f"wire dicts need str keys, got {[type(k).__name__ for k in keys]}")
        return {"k": "dict", "keys": keys,
                "ch": [_enc(x[k], blob) for k in keys]}
    if isinstance(x, tuple):
        return {"k": "tuple", "ch": [_enc(v, blob) for v in x]}
    if isinstance(x, list):
        return {"k": "list", "ch": [_enc(v, blob) for v in x]}
    if _is_spec(x):
        return {"k": "sds", "dtype": dtype_name(x.dtype),
                "shape": [int(s) for s in x.shape]}
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)) or hasattr(
            x, "__array__"):
        h = _to_host(x)
        u, name = _bits(h)
        raw = u.tobytes()
        off = len(blob)
        blob += raw
        return {"k": "arr", "dtype": name,
                "shape": [int(s) for s in h.shape], "off": off,
                "nb": len(raw)}
    raise WireError(f"unsupported value on the wire: {type(x).__name__}")


def _dec(node, blob: memoryview):
    try:
        kind = node["k"]
    except (TypeError, KeyError) as e:
        raise WireError(f"malformed wire header node: {node!r}") from e
    if kind == "none":
        return None
    if kind in ("bool", "int", "float", "str"):
        return node["v"]
    if kind == "bytes":
        off, nb = node["off"], node["nb"]
        if off + nb > len(blob):
            raise WireError("wire blob truncated: bytes leaf out of range")
        return bytes(blob[off:off + nb])
    if kind == "dict":
        return {k: _dec(c, blob) for k, c in zip(node["keys"], node["ch"])}
    if kind == "tuple":
        return tuple(_dec(c, blob) for c in node["ch"])
    if kind == "list":
        return [_dec(c, blob) for c in node["ch"]]
    if kind == "sds":
        return torch.empty(tuple(node["shape"]),
                           dtype=torch_dtype(node["dtype"]), device="meta")
    if kind == "arr":
        name = node["dtype"]
        dt = _numpy_dtype(name)
        itemsize = (dt.itemsize if dt is not None
                    else torch.empty(0, dtype=torch_dtype(name)).element_size())
        shape = tuple(node["shape"])
        off, nb = node["off"], node["nb"]
        want = int(np.prod(shape, dtype=np.int64)) * itemsize
        if nb != want:
            raise WireError(
                f"array leaf claims {nb} bytes but {shape}/{name} "
                f"needs {want}")
        if off + nb > len(blob):
            raise WireError("wire blob truncated: array leaf out of range")
        u = np.frombuffer(blob[off:off + nb], dtype=_uint(itemsize))
        return _from_bits(u.reshape(shape).copy(), name)
    raise WireError(f"unknown wire node kind {kind!r}")


def encode(tree) -> bytes:
    """Tree (dicts/lists/tuples/scalars/None/arrays/tensors) -> payload
    bytes.  Array leaves are stored raw -- the round trip is bitwise."""
    blob = bytearray()
    hdr = _enc(tree, blob)
    hj = json.dumps(hdr, separators=(",", ":")).encode("utf-8")
    return struct.pack(">I", len(hj)) + hj + bytes(blob)


def decode(payload: bytes):
    """Inverse of :func:`encode`; raises :class:`WireError` on anything
    malformed."""
    if len(payload) < 4:
        raise WireError(f"payload too short for a header: {len(payload)} bytes")
    (hlen,) = struct.unpack_from(">I", payload)
    if 4 + hlen > len(payload):
        raise WireError(
            f"payload header claims {hlen} bytes, only "
            f"{len(payload) - 4} present")
    try:
        hdr = json.loads(payload[4:4 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparseable wire header: {e}") from e
    return _dec(hdr, memoryview(payload)[4 + hlen:])


def payload_nbytes(tree) -> int:
    """Measured wire bytes of ``tree`` (header + blob, framing excluded)."""
    return len(encode(tree))


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def encode_frame(ftype: int, tree) -> bytes:
    """One self-delimiting frame: header + checksummed payload."""
    payload = encode(tree)
    return _HEADER.pack(MAGIC, VERSION, ftype, 0,
                        zlib.crc32(payload) & 0xFFFFFFFF,
                        len(payload)) + payload


def _check_header(magic, version, ftype, reserved, length, expect) -> None:
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}: not a repro wire frame")
    if version != VERSION:
        raise WireError(f"wire version {version}, this build speaks {VERSION}")
    if ftype not in FRAME_TYPES:
        raise WireError(f"unknown frame type {ftype}")
    if reserved != 0:
        raise WireError(f"reserved header field is {reserved:#06x}, not 0")
    if expect is not None and ftype not in (
            expect if isinstance(expect, tuple) else (expect,)):
        raise WireError(f"expected frame type {expect}, got "
                        f"{FRAME_TYPES[ftype]} ({ftype})")
    if length > MAX_PAYLOAD:
        raise WireError(f"frame claims {length} payload bytes (> MAX_PAYLOAD)")


def decode_frame(buf: bytes, expect=None) -> tuple[int, Any, int]:
    """Parse one frame from ``buf``; returns (type, tree, bytes_consumed).

    Raises :class:`WireError` on a short buffer, bad magic, version skew,
    an unknown type, a nonzero reserved field, a type other than
    ``expect`` (one type or a tuple of types, if given), or a checksum
    mismatch.
    """
    if len(buf) < HEADER_BYTES:
        raise WireError(
            f"truncated frame: {len(buf)} bytes, header needs {HEADER_BYTES}")
    magic, version, ftype, res, crc, length = _HEADER.unpack_from(buf)
    _check_header(magic, version, ftype, res, length, expect)
    end = HEADER_BYTES + length
    if len(buf) < end:
        raise WireError(
            f"truncated frame: payload needs {length} bytes, "
            f"{len(buf) - HEADER_BYTES} present")
    payload = bytes(buf[HEADER_BYTES:end])
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise WireError("frame checksum mismatch: payload corrupted in flight")
    return ftype, decode(payload), end


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise WireError(
                f"connection closed mid-frame: wanted {n} bytes, got {got}")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def send_frame(sock, ftype: int, tree) -> int:
    """Serialize + send one frame; returns bytes written."""
    with _trace.span("wire/encode", "wire",
                     ftype=FRAME_TYPES.get(ftype, ftype)) as sp:
        buf = encode_frame(ftype, tree)
        sp.set(nbytes=len(buf))
    with _trace.span("wire/send", "wire",
                     ftype=FRAME_TYPES.get(ftype, ftype), nbytes=len(buf)):
        sock.sendall(buf)
    return len(buf)


def recv_frame(sock, expect=None) -> tuple[int, Any]:
    """Blocking receive of exactly one frame; returns (type, tree)."""
    with _trace.span("wire/recv", "wire") as sp:
        hdr = _recv_exact(sock, HEADER_BYTES)
        magic, version, ftype, res, crc, length = _HEADER.unpack(hdr)
        _check_header(magic, version, ftype, res, length, expect)
        payload = _recv_exact(sock, length)
        sp.set(ftype=FRAME_TYPES.get(ftype, ftype),
               nbytes=HEADER_BYTES + length)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise WireError("frame checksum mismatch: payload corrupted in flight")
    with _trace.span("wire/decode", "wire",
                     ftype=FRAME_TYPES.get(ftype, ftype)):
        return ftype, decode(payload)


# ---------------------------------------------------------------------------
# SegmentSpec <-> wire (the plane layout travels with the first frame)
# ---------------------------------------------------------------------------


def spec_to_wire(spec) -> dict:
    """A :class:`repro_torch.core.plane.SegmentSpec` as a wire-able dict.
    The treedef travels as its skeleton (the tree with leaf indices as
    leaves, dicts in sorted-key order), so the receiver rebuilds an
    identical layout without any template."""
    from repro_torch.utils import tree as tu

    skeleton = tu.tree_unflatten(spec.treedef, list(range(len(spec.sizes))))
    return {
        "skeleton": skeleton,
        "shapes": [list(s) for s in spec.shapes],
        "dtype": dtype_name(spec.dtype),
        "offsets": list(spec.offsets),
        "sizes": list(spec.sizes),
        "d": spec.d,
        "d_pad": spec.d_pad,
        "batch_dims": spec.batch_dims,
    }


def spec_from_wire(d: dict):
    """Inverse of :func:`spec_to_wire`."""
    from repro_torch.core.plane import SegmentSpec
    from repro_torch.utils import tree as tu

    _, treedef = tu.tree_flatten(d["skeleton"])
    return SegmentSpec(
        treedef=treedef,
        shapes=tuple(tuple(int(x) for x in s) for s in d["shapes"]),
        dtype=torch_dtype(d["dtype"]),
        offsets=tuple(int(x) for x in d["offsets"]),
        sizes=tuple(int(x) for x in d["sizes"]),
        d=int(d["d"]), d_pad=int(d["d_pad"]),
        batch_dims=int(d["batch_dims"]))


# ---------------------------------------------------------------------------
# compressed plane encodings (bitwise, verified)
# ---------------------------------------------------------------------------

PLANE_ENCODINGS = ("dense", "sparse", "palette")


def pack_plane(plane, encoding: str = "dense") -> dict:
    """A (possibly compressed) array as its small wire dict.

    ``encoding`` picks the re-encoding (see module docstring); every choice
    round-trips bitwise through :func:`unpack_plane`, and ``"palette"``
    verifies itself and falls back to dense rather than ship a lossy frame.
    The nonzero scan and the palette's tables key on the BIT PATTERN, so
    -0.0 and NaN payloads cross exactly.
    """
    a = _to_host(plane)
    if encoding not in PLANE_ENCODINGS:
        raise WireError(
            f"unknown plane encoding {encoding!r}; one of {PLANE_ENCODINGS}")
    shape = list(a.shape)
    size = int(np.prod(shape, dtype=np.int64))
    if encoding == "dense" or len(shape) == 0 or size == 0:
        return {"enc": "dense", "data": a}
    u, name = _bits(a)
    flat = u.reshape(-1, shape[-1]) if len(shape) > 1 else u.reshape(1, -1)
    nbytes = _host_nbytes(a)
    if encoding == "sparse":
        nz = np.flatnonzero(flat)
        idx_dtype = np.int32 if flat.size < (1 << 31) else np.int64
        # a near-dense plane (e.g. top-k at ratio 1.0) ships smaller raw:
        # (index, value) pairs only pay once they drop enough coordinates
        if nz.size * (np.dtype(idx_dtype).itemsize + flat.itemsize) \
                >= nbytes:
            return {"enc": "dense", "data": a}
        return {"enc": "sparse", "shape": shape, "dtype": name,
                "idx": nz.astype(idx_dtype),
                "vals": _from_bits(flat.ravel()[nz], name)}
    # palette: per-row value table + integer codes.  Quantized rows have
    # <= 2^(bits+1)-1 distinct values, so codes fit u8/u16; a row whose
    # table would NOT shrink the frame falls back to dense for the whole
    # plane (correct first, small second).
    tables, codes = [], np.empty(flat.shape, np.uint16)
    for r in range(flat.shape[0]):
        tab_u, inv = np.unique(flat[r], return_inverse=True)
        if len(tab_u) > 0xFFFF:
            return {"enc": "dense", "data": a}
        tables.append(tab_u)
        codes[r] = inv.astype(np.uint16)
    lens = np.asarray([len(t) for t in tables], np.int32)
    out = {"enc": "palette", "shape": shape, "dtype": name,
           "tables": _from_bits(np.concatenate(tables), name), "lens": lens,
           "codes": codes if lens.max(initial=0) > 0xFF
           else codes.astype(np.uint8)}
    if payload_nbytes(out) >= nbytes:
        return {"enc": "dense", "data": a}
    return out


def unpack_plane(d: dict):
    """Inverse of :func:`pack_plane` (a host array -- a CPU tensor for a
    dtype numpy lacks -- bitwise)."""
    try:
        enc = d["enc"]
    except (TypeError, KeyError) as e:
        raise WireError(f"not a packed plane: {d!r}") from e
    if enc not in PLANE_ENCODINGS:
        raise WireError(f"unknown plane encoding {enc!r}")
    if enc == "dense":
        return _to_host(d["data"])
    shape = tuple(d["shape"])
    name = d["dtype"]
    n_last = shape[-1] if shape else 1
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    if enc == "sparse":
        idx = np.asarray(d["idx"])
        vals, vname = _bits(_to_host(d["vals"]))
        if vname != name:
            raise WireError(f"sparse plane: values are {vname}, not {name}")
        flat = np.zeros(rows * n_last, vals.dtype)
        if idx.shape != vals.shape:
            raise WireError("sparse plane: idx/vals length mismatch")
        if idx.size and (idx.max() >= flat.size or idx.min() < 0):
            raise WireError("sparse plane: index out of range")
        flat[idx] = vals
        return _from_bits(flat.reshape(shape), name)
    if enc == "palette":
        tables, tname = _bits(_to_host(d["tables"]))
        if tname != name:
            raise WireError(f"palette plane: tables are {tname}, not {name}")
        lens = np.asarray(d["lens"])
        codes = np.asarray(d["codes"]).reshape(rows, n_last)
        if lens.sum() != tables.size or len(lens) != rows:
            raise WireError("palette plane: table geometry mismatch")
        out = np.empty((rows, n_last), tables.dtype)
        off = 0
        for r in range(rows):
            tab = tables[off:off + lens[r]]
            if codes[r].size and codes[r].max() >= lens[r]:
                raise WireError("palette plane: code out of table range")
            out[r] = tab[codes[r]]
            off += lens[r]
        return _from_bits(out.reshape(shape), name)
    raise WireError(f"unknown plane encoding {enc!r}")


def pack_message(msg, encoding: str = "dense") -> dict:
    """A whole uplink message tree, each array leaf packed, leaves and the
    skeleton in ``jax.tree_util`` order (sorted dict keys).  The flat plane
    of ``EngineConfig(plane=True)`` is a single leaf, so this is the
    one-buffer fast path; per-leaf layouts pack leaf by leaf."""
    from repro_torch.utils import tree as tu

    leaves, treedef = tu.tree_flatten(msg)
    skeleton = tu.tree_unflatten(treedef, list(range(len(leaves))))
    return {"skeleton": skeleton,
            "leaves": [pack_plane(l, encoding) for l in leaves]}


def unpack_message(d: dict):
    """Inverse of :func:`pack_message` (host-array leaves)."""
    from repro_torch.utils import tree as tu

    _, treedef = tu.tree_flatten(d["skeleton"])
    leaves = [unpack_plane(l) for l in d["leaves"]]
    if treedef.num_leaves != len(leaves):
        raise WireError("packed message: leaf count mismatch")
    return tu.tree_unflatten(treedef, leaves)
