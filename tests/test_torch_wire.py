"""The port's wire codec against the JAX reference's (repro_torch.comm.wire
vs repro.comm.wire).

For the same numpy trees the port's frames are byte-identical to the
reference's -- the tree codec, framing, the three plane encodings, whole
packed messages and plane specs -- and each package decodes the other's
bytes back bitwise (bfloat16 included: the reference's ``ml_dtypes``
arrays on one side, ``torch.bfloat16`` tensors on the other).  Tensors,
CUDA-resident or not, encode as the numpy arrays they hold; meta tensors
encode as the reference's ``ShapeDtypeStruct`` spec nodes.  Any single
flipped bit of a frame raises, header bytes 5-7 included (the port's
decoder checks the type byte and the reserved field, which the
reference's does not read).
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as jwire
from repro.core import plane as jpln
from repro_torch.comm import wire
from repro_torch.core import plane as pln


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 5))
    w[0, :3] = [np.nan, -0.0, np.inf]
    return {"w": w, "b": np.float64(0.25), "step": np.int64(7),
            "meta": [1, 2.5, None, "tag", b"\x00\x01", True],
            "pair": (rng.integers(0, 9, size=4).astype(np.int32),
                     np.zeros((0, 2), np.float32)),
            "mask": rng.random(6) > 0.5}


def _as_torch(tree):
    """The same tree with its numpy arrays (not scalars) as tensors."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _bits(x):
    h = wire._to_host(x)
    return wire._bits(h)[1], tuple(h.shape), wire._bits(h)[0].tobytes()


def _bf16_pair(shape, seed=0):
    """One array in both bf16 forms: ml_dtypes (reference), torch (port)."""
    x = np.random.default_rng(seed).standard_normal(shape)
    ref = np.asarray(jnp.asarray(x, jnp.bfloat16))
    port = torch.from_numpy(x).to(torch.bfloat16)
    assert ref.view(np.int16).tobytes() == port.view(torch.int16).numpy().tobytes()
    return ref, port


# -- the tree codec ----------------------------------------------------------


def test_encode_is_the_references_bytes():
    tree = _tree()
    assert wire.encode(tree) == jwire.encode(tree)
    assert wire.encode(_as_torch(tree)) == jwire.encode(tree)
    assert wire.payload_nbytes(tree) == jwire.payload_nbytes(tree)


@pytest.mark.parametrize("ftype", sorted(jwire.FRAME_TYPES))
def test_encode_frame_is_the_references_bytes(ftype):
    tree = _tree(ftype)
    assert wire.encode_frame(ftype, _as_torch(tree)) == \
        jwire.encode_frame(ftype, tree)


def test_each_package_decodes_the_others_frames():
    tree = _tree(3)
    for enc, dec in ((jwire, wire), (wire, jwire)):
        ftype, out, n = dec.decode_frame(enc.encode_frame(jwire.T_CHUNK,
                                                          tree))
        assert ftype == jwire.T_CHUNK
        assert out["meta"] == [1, 2.5, None, "tag", b"\x00\x01", True]
        assert isinstance(out["pair"], tuple)
        for k in ("w", "b", "step", "mask"):
            assert _bits(out[k]) == _bits(tree[k]), k
        assert _bits(out["pair"][0]) == _bits(tree["pair"][0])
        assert out["pair"][1].shape == (0, 2)


def test_bfloat16_crosses_both_ways_bitwise():
    ref, port = _bf16_pair((4, 7))
    assert wire.encode({"x": port}) == jwire.encode({"x": ref})
    got = wire.decode(jwire.encode({"x": ref}))["x"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), port.view(torch.int16))
    back = jwire.decode(wire.encode({"x": port}))["x"]
    assert back.dtype.name == "bfloat16"
    assert back.view(np.int16).tobytes() == ref.view(np.int16).tobytes()
    # and a port round trip alone
    again = wire.decode(wire.encode({"x": port}))["x"]
    assert torch.equal(again.view(torch.int16), port.view(torch.int16))


def test_meta_tensors_are_the_references_spec_nodes():
    specs = {"avg_grad": {"b": jax.ShapeDtypeStruct((8,), jnp.float64),
                          "w": jax.ShapeDtypeStruct((8, 24), jnp.float64)},
             "h": jax.ShapeDtypeStruct((2, 3), jnp.bfloat16),
             "round": jax.ShapeDtypeStruct((8,), jnp.int32)}
    meta = {"avg_grad": {"b": torch.empty(8, dtype=torch.float64,
                                          device="meta"),
                         "w": torch.empty(8, 24, dtype=torch.float64,
                                          device="meta")},
            "h": torch.empty(2, 3, dtype=torch.bfloat16, device="meta"),
            "round": torch.empty(8, dtype=torch.int32, device="meta")}
    assert wire.encode(meta) == jwire.encode(specs)
    out = wire.decode(jwire.encode(specs))
    assert out["h"].device.type == "meta" and out["h"].dtype == torch.bfloat16
    assert tuple(out["avg_grad"]["w"].shape) == (8, 24)
    assert out["round"].dtype == torch.int32
    back = jwire.decode(wire.encode(meta))
    assert back["avg_grad"]["w"] == specs["avg_grad"]["w"]


def test_unsupported_leaves_and_keys_raise():
    with pytest.raises(wire.WireError, match="str keys"):
        wire.encode({1: np.zeros(2)})
    with pytest.raises(wire.WireError, match="unsupported"):
        wire.encode({"f": object()})


# -- framing -------------------------------------------------------------------


def _frame():
    return wire.encode_frame(wire.T_CHUNK, {"w": np.arange(6.0),
                                            "k": "x"})


@pytest.mark.parametrize("pos", range(wire.HEADER_BYTES))
def test_any_flipped_header_bit_raises(pos):
    buf = _frame()
    for bit in range(8):
        bad = bytearray(buf)
        bad[pos] ^= 1 << bit
        with pytest.raises(wire.WireError):
            wire.decode_frame(bytes(bad), expect=wire.T_CHUNK)


@pytest.mark.parametrize("bit", range(8))
def test_any_flipped_payload_bit_raises(bit):
    buf = _frame()
    for pos in range(wire.HEADER_BYTES, len(buf)):
        bad = bytearray(buf)
        bad[pos] ^= 1 << bit
        with pytest.raises(wire.WireError):
            wire.decode_frame(bytes(bad))


def test_reserved_and_type_checks_are_the_ports_own():
    buf = bytearray(_frame())
    buf[6] ^= 0x01  # reserved field: the reference reads nothing here
    jwire.decode_frame(bytes(buf))
    with pytest.raises(wire.WireError, match="reserved"):
        wire.decode_frame(bytes(buf))
    buf = bytearray(_frame())
    buf[5] = 0x42
    with pytest.raises(wire.WireError, match="unknown frame type"):
        wire.decode_frame(bytes(buf))
    with pytest.raises(wire.WireError, match="expected frame type"):
        wire.decode_frame(_frame(), expect=(wire.T_ACK, wire.T_BYE))


def test_truncation_magic_version_and_length():
    buf = _frame()
    for cut in (0, 5, wire.HEADER_BYTES, len(buf) - 1):
        with pytest.raises(wire.WireError, match="truncated"):
            wire.decode_frame(buf[:cut])
    with pytest.raises(wire.WireError, match="magic"):
        wire.decode_frame(b"HTTP" + buf[4:])
    skew = bytearray(buf)
    skew[4] = wire.VERSION + 1
    with pytest.raises(wire.WireError, match="version"):
        wire.decode_frame(bytes(skew))
    hdr = struct.pack(">4sBBHIQ", wire.MAGIC, wire.VERSION, wire.T_CHUNK, 0,
                      0, wire.MAX_PAYLOAD + 1)
    with pytest.raises(wire.WireError, match="MAX_PAYLOAD"):
        wire.decode_frame(hdr)


def test_socket_round_trip_and_closed_stream():
    import socket

    a, b = socket.socketpair()
    try:
        tree = _as_torch(_tree(5))
        n = wire.send_frame(a, wire.T_RESULT, tree)
        assert n == len(jwire.encode_frame(jwire.T_RESULT, _tree(5)))
        ftype, out = wire.recv_frame(b, expect=wire.T_RESULT)
        assert ftype == wire.T_RESULT
        assert _bits(out["w"]) == _bits(tree["w"])
        a.sendall(_frame()[:10])
        a.close()
        with pytest.raises(wire.WireError, match="closed mid-frame"):
            wire.recv_frame(b)
    finally:
        b.close()


# -- compressed planes ---------------------------------------------------------


def _plane(kind, shape=(4, 300), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if kind == "sparse":
        keep = rng.random(shape) < 0.1
        x = np.where(keep, x, 0.0)
        x.reshape(-1)[:3] = [-0.0, np.nan, np.inf]
    elif kind == "palette":
        x = np.round(x * 4) / 4  # a few lattice values per row
        x.reshape(-1)[0] = -0.0
    return x


@pytest.mark.parametrize("encoding", ["dense", "sparse", "palette"])
@pytest.mark.parametrize("kind", ["dense", "sparse", "palette"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_pack_plane_is_the_references_bytes(encoding, kind, dtype):
    x = _plane(kind)
    if dtype == "bfloat16":
        # the same bits on both sides (the two casts round NaN apart)
        ref = np.asarray(jnp.asarray(x, jnp.bfloat16))
        port = torch.from_numpy(ref.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        ref = x.astype(dtype)
        port = torch.from_numpy(ref.copy())
    pj, pt = jwire.pack_plane(ref, encoding), wire.pack_plane(port, encoding)
    assert pj["enc"] == pt["enc"]
    assert wire.encode(pt) == jwire.encode(pj)
    # each side unpacks the other's frame bitwise
    assert _bits(wire.unpack_plane(wire.decode(jwire.encode(pj)))) == \
        _bits(port)
    assert _bits(jwire.unpack_plane(jwire.decode(wire.encode(pt)))) == \
        _bits(ref)


def test_the_encodings_actually_shrink():
    for kind, enc in (("sparse", "sparse"), ("palette", "palette")):
        x = torch.from_numpy(_plane(kind, (8, 4096)))
        packed = wire.pack_plane(x, enc)
        assert packed["enc"] == enc
        assert wire.payload_nbytes(packed) < 0.5 * x.numel() * 8
    dense = torch.from_numpy(_plane("dense", (8, 4096)))
    assert wire.pack_plane(dense, "sparse")["enc"] == "dense"


def test_unpack_plane_refuses_garbage():
    pt = wire.pack_plane(torch.from_numpy(_plane("sparse")), "sparse")
    pt["idx"] = pt["idx"].copy()
    pt["idx"][0] = 10 ** 6
    with pytest.raises(wire.WireError, match="out of range"):
        wire.unpack_plane(pt)
    with pytest.raises(wire.WireError, match="unknown plane encoding"):
        wire.pack_plane(torch.zeros(3), "lz4")
    with pytest.raises(wire.WireError, match="not a packed plane"):
        wire.unpack_plane([1])


@pytest.mark.parametrize("encoding", ["dense", "sparse", "palette"])
def test_pack_message_is_the_references_bytes(encoding):
    rng = np.random.default_rng(1)
    msg = {"w": np.where(rng.random((8, 24)) < 0.2,
                         rng.standard_normal((8, 24)), 0.0),
           "b": np.round(rng.standard_normal(8))}
    # the port's message dicts come in insertion order; the skeleton is
    # sorted as jax.tree_util's is
    port = {"w": torch.from_numpy(msg["w"]), "b": torch.from_numpy(msg["b"])}
    pj, pt = jwire.pack_message(msg, encoding), wire.pack_message(port,
                                                                 encoding)
    assert wire.encode(pt) == jwire.encode(pj)
    out = wire.unpack_message(wire.decode(jwire.encode(pj)))
    assert list(out) == ["b", "w"]
    assert all(_bits(out[k]) == _bits(msg[k]) for k in msg)
    back = jwire.unpack_message(jwire.decode(wire.encode(pt)))
    assert all(_bits(back[k]) == _bits(msg[k]) for k in msg)


def test_spec_to_wire_is_the_references():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((8, 24)), "b": rng.standard_normal(8),
            "z": {"k": rng.standard_normal((8, 2, 3))}}
    jspec = jpln.SegmentSpec.from_tree(jax.tree_util.tree_map(jnp.asarray,
                                                              tree),
                                       batch_dims=1)
    spec = pln.SegmentSpec.from_tree(
        {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
             else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in tree.items()}, batch_dims=1)
    assert wire.encode(wire.spec_to_wire(spec)) == \
        jwire.encode(jwire.spec_to_wire(jspec))
    back = wire.spec_from_wire(wire.decode(jwire.encode(
        jwire.spec_to_wire(jspec))))
    assert back == spec
    jback = jwire.spec_from_wire(jwire.decode(wire.encode(
        wire.spec_to_wire(spec))))
    assert jback == jspec
