"""Overlap attribution: measured compute/wire occupancy per chunk, from a
trace, diffed against the roofline wire model.

The counterpart of :mod:`repro.obs.report`, computed from the spans every
traced runtime run emits (``exec/chunk`` on the compute thread,
``uplink/wait`` where the compute thread handed a chunk to the sender,
``uplink/ship`` for fetch + pack + sendall + pacing + ACK):

  * per chunk: pure compute seconds (the ``exec/chunk`` span minus the
    uplink wait/ship time that lands on the compute thread -- in blocking
    mode the inline send is inside the chunk span, in overlapped mode only
    the queue backpressure is), wire seconds (the ``uplink/ship`` span),
    and shipped bytes;
  * aggregate: the hidden fraction

        hidden = (sum_compute + sum_wire - wall) / sum_wire

    clamped to [0, 1] -- the share of wire time that did NOT extend the
    wall clock.  ``steady`` drops each worker's first chunk (which carries
    the warm-up) before aggregating;
  * model diff: with a :class:`repro_torch.roofline.analysis.WireModel`,
    each chunk's measured wire seconds sit next to ``model.seconds(nbytes)``
    and the aggregate next to ``roofline.chunk_times`` -- measurement vs
    prediction in one table.

Input is a merged Chrome trace-event document (what
:func:`repro_torch.obs.trace.to_chrome` writes); chunk and ship spans pair
up by their ``start_round`` arg.  stdlib only (the roofline import is lazy).

CLI: ``python -m repro_torch.obs.report trace.json [--bw B/s] [--latency S]
[--compute-ref S]``.
"""
from __future__ import annotations

import json
from typing import Optional

__all__ = ["spans_of", "overlap_report", "hidden_fraction",
           "format_report"]

CHUNK_NAME = "exec/chunk"
SHIP_NAME = "uplink/ship"
WAIT_NAME = "uplink/wait"


def spans_of(doc: dict, name: Optional[str] = None) -> list:
    """Complete-events of a Chrome trace doc as dicts with seconds floats:
    ``{"name", "pid", "tid", "t0", "t1", "args"}`` (ts back in seconds)."""
    out = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        if name is not None and ev.get("name") != name:
            continue
        t0 = float(ev["ts"]) / 1e6
        out.append({"name": ev["name"], "pid": ev["pid"], "tid": ev["tid"],
                    "t0": t0, "t1": t0 + float(ev.get("dur", 0)) / 1e6,
                    "args": ev.get("args", {})})
    return out


def _contained(inner: dict, outer: dict) -> bool:
    eps = 1e-9
    return inner["t0"] >= outer["t0"] - eps and inner["t1"] <= outer["t1"] + eps


def _union_seconds(spans: list) -> float:
    """Total covered time of possibly-nested/overlapping intervals (in
    blocking mode ``uplink/wait`` wraps the inline ``uplink/ship`` on the
    same thread -- summing durations would double count)."""
    total, end = 0.0, float("-inf")
    for s in sorted(spans, key=lambda s: s["t0"]):
        if s["t1"] <= end:
            continue
        total += s["t1"] - max(s["t0"], end)
        end = s["t1"]
    return total


def _totals(chunks: list) -> dict:
    if not chunks:
        return {"chunks": 0, "compute_s": 0.0, "wire_s": 0.0, "wall_s": 0.0,
                "blocking_s": 0.0, "hidden_fraction": None}
    lo = min(c["t0"] for c in chunks)
    hi = max(max(c["t1"], c.get("ship_t1", c["t1"])) for c in chunks)
    compute = sum(c["compute_s"] for c in chunks)
    wired = sum(c["wire_s"] for c in chunks)
    wall = hi - lo
    hidden = None
    if wired > 0:
        hidden = max(0.0, min(1.0, (compute + wired - wall) / wired))
    return {"chunks": len(chunks), "compute_s": compute, "wire_s": wired,
            "wall_s": wall, "blocking_s": compute + wired,
            "hidden_fraction": hidden}


def overlap_report(doc: dict, *, model=None,
                   compute_ref_s: Optional[float] = None) -> dict:
    """Per-chunk + aggregate overlap attribution from a merged trace.

    ``model`` (a ``roofline.analysis.WireModel``) adds predicted wire
    seconds per chunk and a roofline ``chunk_times`` comparison on the
    steady aggregate.  Only worker pids contribute (the pids owning
    ``exec/chunk`` spans); multiple workers aggregate jointly.

    ``compute_ref_s`` is an UNCONTENDED per-chunk compute reference (e.g.
    from a wire-free run of the same problem).  Concurrent uplink work --
    the sender thread's host fetch + pack holds the GIL while the chunk
    runs -- dilates the chunk spans, so trace-derived compute overstates
    pure compute and ``hidden_fraction`` overstates hiding.  With a
    reference the steady aggregate also carries ``hidden_fraction_ref``,
    which charges that dilation to the wire:

        hidden_ref = (n_chunks * ref + wire - wall) / wire.
    """
    chunk_spans = spans_of(doc, CHUNK_NAME)
    ships = spans_of(doc, SHIP_NAME)
    waits = spans_of(doc, WAIT_NAME)

    by_key = {}
    for s in ships:
        key = (s["pid"], s["args"].get("start_round"))
        by_key[key] = s

    rows = []
    for c in sorted(chunk_spans, key=lambda s: s["t0"]):
        start = c["args"].get("start_round")
        dur = c["t1"] - c["t0"]
        # uplink time charged to the compute thread: wait (backpressure)
        # and any inline ship on the SAME thread inside the chunk span --
        # subtracting it leaves pure compute in both runtime modes
        inline = _union_seconds([
            s for s in waits + ships
            if s["pid"] == c["pid"] and s["tid"] == c["tid"]
            and _contained(s, c)])
        ship = by_key.get((c["pid"], start))
        row = {"pid": c["pid"], "start_round": start,
               "rounds": c["args"].get("rounds"),
               "t0": c["t0"], "t1": c["t1"],
               "compute_s": max(dur - inline, 0.0),
               "wire_s": (ship["t1"] - ship["t0"]) if ship else 0.0,
               "nbytes": ship["args"].get("nbytes") if ship else None}
        if ship:
            row["ship_t1"] = ship["t1"]
            if model is not None and row["nbytes"] is not None:
                row["wire_model_s"] = model.seconds(row["nbytes"])
        rows.append(row)

    totals = _totals(rows)
    # steady state: drop each pid's first chunk -- it carries the warm-up
    # (the kernels' first launches, and its ship)
    first = {}
    for r in rows:
        if r["pid"] not in first or r["t0"] < first[r["pid"]]["t0"]:
            first[r["pid"]] = r
    steady_rows = [r for r in rows if first.get(r["pid"]) is not r]
    steady = _totals(steady_rows)
    if compute_ref_s is not None and steady["chunks"] and steady["wire_s"]:
        steady["compute_ref_s"] = compute_ref_s * steady["chunks"]
        steady["hidden_fraction_ref"] = max(0.0, min(1.0, (
            steady["compute_ref_s"] + steady["wire_s"] - steady["wall_s"])
            / steady["wire_s"]))

    out = {"chunks": rows, "totals": totals, "steady": steady}
    if model is not None and steady["chunks"]:
        from repro_torch.roofline.analysis import chunk_times

        per_compute = steady["compute_s"] / steady["chunks"]
        per_wire = steady["wire_s"] / steady["chunks"]
        pred = chunk_times(per_compute, per_wire)
        out["roofline"] = {
            "per_chunk_compute_s": per_compute,
            "per_chunk_wire_s": per_wire,
            "predicted": pred,
            "measured_wall_per_chunk_s": steady["wall_s"] / steady["chunks"],
            "predicted_wire_s_total": sum(
                r.get("wire_model_s", 0.0) for r in steady_rows),
        }
    return out


def hidden_fraction(doc: dict) -> float:
    """Steady-state wire-hidden fraction of a merged trace doc, as one
    float in [0, 1] (0.0 when the trace has no steady chunks or no wire).

    The scalar the autotuner folds into its objective: of the bytes the
    workers shipped, what fraction of the wire time hid behind compute.
    """
    steady = overlap_report(doc)["steady"]
    h = steady.get("hidden_fraction")
    return float(h) if h is not None else 0.0


def format_report(rep: dict) -> str:
    """The report as an aligned text table (what the CLI prints)."""
    lines = [f"{'chunk':>6} {'rounds':>6} {'compute_s':>10} {'wire_s':>10} "
             f"{'bytes':>10} {'model_s':>9}"]
    for r in rep["chunks"]:
        lines.append(
            f"{str(r['start_round']):>6} {str(r['rounds']):>6} "
            f"{r['compute_s']:>10.4f} {r['wire_s']:>10.4f} "
            f"{str(r['nbytes']):>10} "
            + (f"{r['wire_model_s']:>9.4f}" if "wire_model_s" in r
               else f"{'-':>9}"))
    for key in ("totals", "steady"):
        t = rep[key]
        h = ("n/a" if t["hidden_fraction"] is None
             else f"{t['hidden_fraction']:.1%}")
        line = (f"{key}: chunks={t['chunks']} compute={t['compute_s']:.4f}s "
                f"wire={t['wire_s']:.4f}s wall={t['wall_s']:.4f}s hidden={h}")
        if "hidden_fraction_ref" in t:
            line += f" hidden_ref={t['hidden_fraction_ref']:.1%}"
        lines.append(line)
    if "roofline" in rep:
        rf = rep["roofline"]
        lines.append(
            f"roofline: predicted hidden="
            f"{rf['predicted']['hidden_fraction']:.1%} "
            f"overlapped={rf['predicted']['overlapped']:.4f}s/chunk "
            f"measured wall={rf['measured_wall_per_chunk_s']:.4f}s/chunk")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="overlap attribution from a merged trace")
    ap.add_argument("path")
    ap.add_argument("--bw", type=float, default=None,
                    help="wire bandwidth (B/s) for the roofline diff")
    ap.add_argument("--latency", type=float, default=0.0)
    ap.add_argument("--compute-ref", type=float, default=None,
                    help="uncontended compute seconds per chunk (adds "
                         "hidden_fraction_ref to the steady aggregate)")
    ns = ap.parse_args(argv)
    with open(ns.path) as f:
        doc = json.load(f)
    model = None
    if ns.bw:
        from repro_torch.roofline.analysis import WireModel

        model = WireModel(bw=ns.bw, latency_s=ns.latency)
    print(format_report(overlap_report(doc, model=model,
                                       compute_ref_s=ns.compute_ref)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
