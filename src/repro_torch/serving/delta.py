"""Bitwise delta publication of serving snapshots to replicas.

The counterpart of :mod:`repro.serving.delta`; for the same snapshot
sequence its T_SNAP frames are the reference's, byte for byte.  A publisher
keeps ``DownlinkCompressor``-style shadow state -- the last plane each
replica holds -- and ships the **XOR of bit patterns** per leaf:

    delta = new.view(uint) ^ shadow.view(uint)

Unlike a float difference (``shadow + (new - shadow)`` is not bitwise
``new``), XOR is exact by construction: applying the delta to the shadow
reproduces the new plane bit for bit, NaN payloads and ``-0.0`` included.
Unchanged coordinates XOR to *exactly zero bits*, so the delta is sparse
in precisely the sense :func:`repro_torch.comm.wire.pack_plane`'s
``"sparse"`` encoding exploits.  Every ``keyframe_every``-th version ships
as a dense keyframe instead, which bounds how long a late-joining replica
waits before it can reconstruct.

This is host work: snapshot leaves (tensors on any device, or numpy
arrays) are fetched once per frame, and trees are handled in
``jax.tree_util`` order (sorted dict keys), as the reference does.  Each
frame carries a CRC digest of the full plane so a replica *proves* the
bitwise reconstruction instead of trusting it.
"""
from __future__ import annotations

import zlib
from typing import Optional

from repro_torch.comm import wire
from repro_torch.obs import trace as _trace
from repro_torch.serving.snapshot import ServingSnapshot, SnapshotStore
from repro_torch.utils import tree as tu


class SnapshotGap(Exception):
    """A delta arrived whose base version the replica does not hold (e.g.
    it joined mid-stream); recover by waiting for the next keyframe."""


def _to_host_tree(tree):
    return tu.canonical(tu.tree_map(wire._to_host, tree))


def xor_delta(new, shadow):
    """Per-leaf XOR of bit patterns; leaves keep their original dtype.
    ``apply_delta(shadow, xor_delta(new, shadow))`` is bitwise ``new``."""
    def one(n, s):
        (nb, nname), (sb, sname) = (wire._bits(wire._to_host(n)),
                                    wire._bits(wire._to_host(s)))
        if nb.shape != sb.shape or nname != sname:
            raise ValueError(
                f"delta over mismatched leaves: {nb.shape}/{nname} vs "
                f"{sb.shape}/{sname}")
        return wire._from_bits(nb ^ sb, nname)

    return tu.canonical(tu.tree_map(one, new, shadow))


def apply_delta(shadow, delta):
    """Inverse of :func:`xor_delta` (XOR is an involution)."""
    return xor_delta(delta, shadow)


def tree_digest(tree) -> int:
    """CRC32 over every leaf's raw bytes, in ``jax.tree_util`` leaf order:
    the cheap bitwise fingerprint each frame carries."""
    crc = 0
    for leaf in tu.tree_leaves(_to_host_tree(tree)):
        crc = zlib.crc32(wire._bits(leaf)[0].tobytes(), crc)
    return crc & 0xFFFFFFFF


class DeltaPublisher:
    """The sending half: shadow state + frame construction.

    One publisher per replica connection (each replica's shadow advances
    with what was actually shipped to *it*).
    """

    def __init__(self, keyframe_every: int = 8, encoding: str = "sparse"):
        if keyframe_every < 1:
            raise ValueError("keyframe_every must be >= 1")
        if encoding not in wire.PLANE_ENCODINGS:
            raise ValueError(f"unknown encoding {encoding!r}")
        self.keyframe_every = keyframe_every
        self.encoding = encoding
        self._shadow = None
        self._shadow_version = 0

    def encode(self, snap: ServingSnapshot) -> dict:
        """Build the wire frame for ``snap`` against this replica's shadow
        and advance the shadow.  Keyframes (first frame, and every
        ``keyframe_every``-th version) ship the dense plane."""
        value = _to_host_tree(snap.value)
        key = (self._shadow is None
               or snap.version % self.keyframe_every == 0)
        with _trace.span("serve/delta_encode", "serve",
                         version=snap.version,
                         kind="key" if key else "delta"):
            if key:
                payload = wire.pack_message(value, "dense")
            else:
                payload = wire.pack_message(
                    xor_delta(value, self._shadow), self.encoding)
            frame = {
                "version": snap.version,
                "round": snap.round,
                "kind": "key" if key else "delta",
                "base_version": 0 if key else self._shadow_version,
                "digest": tree_digest(value),
                "payload": payload,
            }
        self._shadow = value
        self._shadow_version = snap.version
        return frame


class DeltaReplica:
    """The receiving half: applies frames, proves bitwise reconstruction,
    and (optionally) republishes into a local :class:`SnapshotStore` so a
    replica-side serving engine hot-swaps exactly like the primary."""

    def __init__(self, store: Optional[SnapshotStore] = None):
        self.store = store
        self.plane = None
        self.version = 0
        self.applied = 0
        self.skipped = 0   # deltas dropped while waiting for a keyframe

    def apply(self, frame: dict) -> Optional[ServingSnapshot]:
        """Apply one publisher frame; returns the reconstructed snapshot.

        Returns None for a delta this replica has no base for (mid-stream
        join) -- callers just keep feeding frames; raises
        :class:`SnapshotGap` if the base version *should* match but does
        not, and :class:`~repro_torch.comm.wire.WireError` on a digest
        mismatch (the reconstruction is checked, not assumed).
        """
        kind = frame["kind"]
        with _trace.span("serve/delta_apply", "serve",
                         version=frame["version"], kind=kind):
            if kind == "key":
                plane = wire.unpack_message(frame["payload"])
            else:
                if self.plane is None:
                    self.skipped += 1
                    return None
                if frame["base_version"] != self.version:
                    raise SnapshotGap(
                        f"delta v{frame['version']} expects base "
                        f"v{frame['base_version']}, replica holds "
                        f"v{self.version}")
                plane = apply_delta(self.plane,
                                    wire.unpack_message(frame["payload"]))
            got = tree_digest(plane)
            if got != frame["digest"]:
                raise wire.WireError(
                    f"snapshot v{frame['version']} reconstruction digest "
                    f"mismatch: {got:#x} != {frame['digest']:#x}")
        self.plane = plane
        self.version = frame["version"]
        self.applied += 1
        if self.store is not None:
            self.store.publish(plane, round=frame["round"])
        return ServingSnapshot(version=frame["version"],
                               round=frame["round"], value=plane,
                               published_at=_trace.now())
