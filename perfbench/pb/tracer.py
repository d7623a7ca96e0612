"""The program's own tracer, read once a traced window has closed.

``Trace`` holds the host spans' names and times.  The device intervals of
the program's stage spans, and the counters on its ``exec/chunk`` spans,
stay in the tracer that the window installed, which
``repro_torch.obs.trace.latest()`` still returns after the window.  It is
taken for the window's only if its ``exec/chunk`` spans are the window's:
as many, of the same lengths.  A program with no device track, no chunk
counters or no ``latest`` gives ``None``.
"""
from __future__ import annotations

import json

CHUNK = "exec/chunk"
DEVICE_TRACK = "cuda:"  # the thread label of a device track
_SAME_S = 1e-6


def window_records(tr):
    """``(device, chunks)`` of the traced window ``tr``: the device track's
    spans as (name, start, end), in seconds from the window's start, and
    the args of each ``exec/chunk`` span; ``None`` when the program's
    tracer holds no such window."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    latest = getattr(trace, "latest", None)
    tracer = latest() if latest is not None else None
    if tracer is None:
        return None
    wire = tracer.export_wire(device=True)
    names, tids = wire["names"], wire["tids"]
    args = json.loads(wire["args_json"])
    device, chunks = [], []
    for i, (n, t, a, b) in enumerate(zip(wire["name_ix"], wire["tid_ix"],
                                         wire["t0"], wire["t1"])):
        if str(tids[t]).startswith(DEVICE_TRACK):
            device.append((names[n], float(a), float(b)))
        elif names[n] == CHUNK:
            chunks.append((float(a), float(b), args[i] or {}))
    ours = [(a, b) for n, a, b in tr.spans if n == CHUNK]
    if not ours or len(ours) != len(chunks) or any(
            abs((b - a) - (cb - ca)) > _SAME_S
            for (a, b), (ca, cb, _) in zip(ours, chunks)):
        return None
    base = chunks[0][0] - ours[0][0]
    return ([(n, a - base, b - base) for n, a, b in device],
            [c for _, _, c in chunks])


def device_ms_per_round(tr, names) -> float | None:
    """Device milliseconds a round inside the spans called ``names``."""
    got = window_records(tr)
    if got is None or not tr.rounds:
        return None
    spans = [(a, b) for n, a, b in got[0] if n in names]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / tr.rounds


def chunk_count_per_round(tr, key: str) -> float | None:
    """A chunk counter ``key`` summed over the window's chunks, a round."""
    got = window_records(tr)
    if got is None or not tr.rounds:
        return None
    values = [c[key] for c in got[1] if key in c]
    if not values or len(values) != len(got[1]):
        return None
    return sum(values) / tr.rounds
