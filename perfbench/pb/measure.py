"""Timing the window, and reading the traced sub-window.

The window calls ``RoundEngine.run`` one chunk at a time until the
seconds have passed; its time runs on the host clock from before the
first chunk to a ``synchronize()`` after the last, so every round it
counts is finished on the device.

The traced run profiles a shorter sub-window (whole chunks, at least
``TRACE_S`` seconds or the whole ``--seconds``, whichever is less) with
``torch.profiler`` in memory (nothing is written to disk), and the
program's own spans (``repro_torch.obs.trace``) on: kernels by name and
interval, and the spans on the host clock, both from the window's start
(a marker kernel on the device, the host clock's reading just before it
is launched).
"""
from __future__ import annotations

import dataclasses
import time

import torch

TRACE_S = 2.0
MARK = "spin_kernel"  # the marker's kernel


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(prog, seconds: float, device) -> dict:
    """The window's seconds, rounds and losses, and each chunk's host
    seconds (for the log)."""
    losses, rounds, chunks = [], 0, []
    sync(device)
    t0 = t = time.perf_counter()
    while True:
        losses += prog.rounds(prog.traffic["chunk"])
        rounds += prog.traffic["chunk"]
        now = time.perf_counter()
        chunks.append(now - t)
        t = now
        if now - t0 >= seconds:
            break
    sync(device)
    return {"seconds": time.perf_counter() - t0, "rounds": rounds,
            "losses": losses, "chunks": chunks}


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads.  Times in seconds from the start of
    the traced window; ``kernels`` are the device's operations (kernels,
    copies, fills) as (name, start, end), ``spans`` the program's as
    (name, start, end)."""

    window_s: float
    rounds: int
    kernels: list
    spans: list
    costs: dict

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window."""
        out = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(a, 0.0), min(b, self.window_s)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, fragments) -> float:
        """Device seconds of the operations whose name holds a fragment."""
        return sum(b - a for n, a, b in self.kernels
                   if any(f in n for f in fragments))


def _marker():
    """A kernel that marks the window's start on the device's timeline
    (``torch.cuda._sleep``'s spin kernel, a few cycles long)."""
    torch.cuda._sleep(1)


def traced_window(prog, seconds: float, device) -> tuple:
    """(Trace, losses) of a profiled sub-window.  Only the device is
    profiled (its kernels, copies and fills): recording every host
    operation as well would slow the host path the cells measure."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as otrace

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    limit = min(seconds, TRACE_S)
    tracer = otrace.install("perfbench")
    losses, rounds = [], 0
    try:
        sync(device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if cuda:
                _marker()
            while True:
                losses += prog.rounds(prog.traffic["chunk"])
                rounds += prog.traffic["chunk"]
                if time.perf_counter() - t0 >= limit:
                    break
            sync(device)
            t1 = time.perf_counter()
    finally:
        otrace.uninstall()
    wire = tracer.export_wire()
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [a for n, a, _ in ops if MARK in n]
    if cuda and not marks:
        raise RuntimeError(f"no {MARK!r} among the traced kernels: "
                           f"{sorted({n for n, _, _ in ops})[:20]}")
    base = min(marks) if marks else 0.0
    kernels = [(n, (a - base) / 1e6, (b - base) / 1e6) for n, a, b in ops
               if MARK not in n]
    spans = [(wire["names"][i], a - t0, b - t0) for i, a, b in
             zip(wire["name_ix"], wire["t0"], wire["t1"]) if a >= t0]
    tr = Trace(window_s=t1 - t0, rounds=rounds, kernels=kernels,
               spans=spans, costs=prog.costs)
    return tr, losses


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost program span open at its middle
    (``none`` when the host was in none)."""
    by_name: dict = {}
    for n, a, b in tr.kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = tr.busy_intervals()
    edges = [0.0] + [x for iv in busy for x in iv] + [tr.window_s]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        open_ = [s for s in tr.spans if s[1] <= mid <= s[2]]
        label = max(open_, key=lambda s: s[1])[0] if open_ else "none"
        named.append([label, b - a])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": named}
