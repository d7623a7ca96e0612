"""The port's snapshot delta publication against the JAX reference's
(repro_torch.serving.delta vs repro.serving.delta).

For the same snapshot sequence the port's T_SNAP frames are byte-identical
to the reference's (keyframes and XOR deltas, sparse and dense, float64 and
bfloat16 leaves), a replica of either package applies the other's frames
and proves the reconstruction bitwise, and the replica's contract holds: a
mid-stream joiner skips to the next keyframe, a wrong base raises
``SnapshotGap``, a corrupted delta fails its digest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import wire as jwire
from repro.serving import delta as jdelta
from repro.serving.snapshot import ServingSnapshot as JSnap
from repro_torch.comm import wire
from repro_torch.serving import delta
from repro_torch.serving.snapshot import ServingSnapshot, SnapshotStore


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _sequence(n=6, d=40, seed=0, bf16=False):
    """Server-field snapshots that change a few coordinates per version,
    as numpy (the reference's side) and as tensors (the port's)."""
    rng = np.random.default_rng(seed)
    w, b = rng.standard_normal(d), np.float64(0.5)
    out = []
    for v in range(1, n + 1):
        w = w.copy()
        w[rng.choice(d, size=3, replace=False)] += rng.standard_normal(3)
        if v == 3:
            w[0] = -0.0
        b = np.float64(b + 0.25)
        jw = np.asarray(jnp.asarray(w, jnp.bfloat16)) if bf16 else w
        tw = (torch.from_numpy(jw.view(np.int16).copy()).view(torch.bfloat16)
              if bf16 else torch.from_numpy(w.copy()))
        out.append((v, {"x_bar": {"w": jw, "b": np.asarray(b)}},
                    {"x_bar": {"w": tw, "b": torch.tensor(b)}}))
    return out


@pytest.mark.parametrize("encoding", ["sparse", "dense"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("keyframe_every", [1, 2, 4])
def test_snap_frames_are_the_references_bytes(encoding, bf16,
                                              keyframe_every):
    jpub = jdelta.DeltaPublisher(keyframe_every, encoding)
    tpub = delta.DeltaPublisher(keyframe_every, encoding)
    jrep, trep = jdelta.DeltaReplica(), delta.DeltaReplica()
    for v, jval, tval in _sequence(bf16=bf16):
        jf = jpub.encode(JSnap(version=v, round=4 * v, value=jval))
        tf = tpub.encode(ServingSnapshot(version=v, round=4 * v, value=tval))
        assert wire.encode_frame(wire.T_SNAP, tf) == \
            jwire.encode_frame(jwire.T_SNAP, jf)
        # each replica applies the OTHER package's frame, off the wire
        trep.apply(wire.decode_frame(jwire.encode_frame(jwire.T_SNAP, jf))[1])
        jrep.apply(jwire.decode_frame(wire.encode_frame(wire.T_SNAP, tf))[1])
        assert delta.tree_digest(trep.plane) == jdelta.tree_digest(jval)
        assert jdelta.tree_digest(jrep.plane) == delta.tree_digest(tval)
    assert trep.version == jrep.version == 6


def test_xor_delta_is_exact_and_an_involution():
    a = torch.tensor([1.5, -0.0, float("nan"), 3.0], dtype=torch.float64)
    b = torch.tensor([1.5, 0.0, 2.0, -3.0], dtype=torch.float64)
    d = delta.xor_delta({"p": a}, {"p": b})
    assert np.count_nonzero(d["p"].view(np.uint64)) == 3
    back = delta.apply_delta({"p": b}, d)["p"]
    assert back.tobytes() == a.numpy().tobytes()
    np.testing.assert_array_equal(
        d["p"].view(np.uint64),
        jdelta.xor_delta({"p": a.numpy()}, {"p": b.numpy()})["p"].view(
            np.uint64))
    with pytest.raises(ValueError, match="mismatched"):
        delta.xor_delta({"p": a}, {"p": b.float()})


def test_replica_contract():
    seq = _sequence()
    pub = delta.DeltaPublisher(keyframe_every=4)
    frames = [pub.encode(ServingSnapshot(v, v, t)) for v, _, t in seq]
    assert [f["kind"] for f in frames] == ["key", "delta", "delta", "key",
                                           "delta", "delta"]
    late = delta.DeltaReplica(store=SnapshotStore())
    assert late.apply(frames[1]) is None and late.skipped == 1
    assert late.apply(frames[3]).version == 4  # locks on at the keyframe
    assert late.store.version == 1
    fresh = delta.DeltaReplica()
    fresh.apply(frames[0])
    with pytest.raises(delta.SnapshotGap):
        fresh.apply(frames[2])
    bad = dict(frames[1], digest=frames[1]["digest"] ^ 1)
    with pytest.raises(wire.WireError, match="digest"):
        fresh.apply(bad)
    with pytest.raises(ValueError):
        delta.DeltaPublisher(keyframe_every=0)
    with pytest.raises(ValueError, match="encoding"):
        delta.DeltaPublisher(encoding="lz4")
