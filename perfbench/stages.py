"""Where a cell's chunks spend their time, stage by stage, from the
program's own spans (the benchmark's runs do not run this):

  * windows of ``--seconds`` each, alternately with no tracer and with the
    program's tracer installed (spans, device intervals and chunk
    counters; no profiler): each window's seconds a round, and for every
    chunk of a traced window its wall time, each stage's host and device
    seconds and its counters.  A chunk over 1.05 times its window's median
    is listed as stalled;
  * then one profiled sub-window as the benchmark's traced run takes it,
    read against the device track: the share of the device's busy time the
    stages cover, how far each ``local/grad`` interval starts from the
    first kernel inside it, and how far each device interval ends after
    its host span.

    python3 perfbench/stages.py --workload NAME --seed N --seconds S \\
        --windows K --out FILE
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
STALL = 1.05


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def chunk_table(wire) -> list:
    """Per ``exec/chunk`` span: its wall seconds, args, and the host and
    device seconds of every span inside it, by name."""
    names, tids = wire["names"], wire["tids"]
    args = json.loads(wire["args_json"])
    recs = [(names[n], str(tids[t]).startswith("cuda:"), float(a), float(b),
             args[i]) for i, (n, t, a, b) in enumerate(
                 zip(wire["name_ix"], wire["tid_ix"], wire["t0"],
                     wire["t1"]))]
    rows = []
    for name, dev, a, b, arg in recs:
        if name != "exec/chunk" or dev:
            continue
        host, device = {}, {}
        for n, d, x, y, _ in recs:
            if n != "exec/chunk" and a <= x and y <= b:
                side = device if d else host
                side[n] = side.get(n, 0.0) + (y - x)
        rows.append({"t0": a, "wall_s": b - a, "args": arg, "host_s": host,
                     "device_s": device})
    return rows


def windows(prog, k: int, seconds: float, device) -> list:
    from pb import measure

    from repro_torch.obs import trace

    out = []
    for w in range(k):
        traced = w % 2 == 1
        tracer = trace.install(f"window{w}") if traced else None
        try:
            got = measure.window(prog, seconds, device)
        finally:
            if traced:
                trace.uninstall()
        row = {"traced": traced, "round_s": got["seconds"] / got["rounds"],
               "rounds": got["rounds"]}
        if traced:
            chunks = chunk_table(tracer.export_wire(device=True))
            med = statistics.median(c["wall_s"] for c in chunks)
            row["median_chunk_s"] = med
            row["chunks"] = chunks
            row["stalled"] = [c for c in chunks if c["wall_s"] > STALL * med]
        else:
            med = statistics.median(got["chunks"])
            row["median_chunk_s"] = med
            row["stalled_walls_s"] = [c for c in got["chunks"]
                                      if c > STALL * med]
        print(json.dumps({key: v for key, v in row.items()
                          if key != "chunks"}), flush=True)
        out.append(row)
    return out


def profiled(prog, device) -> dict:
    """The benchmark's traced sub-window, read against the device track."""
    from pb import measure, tracer

    from repro_torch.obs import trace

    # the window's marker kernel inside a device span: where it ran on the
    # program's clock, against the host clock reading the benchmark's
    # alignment takes for its start.  The window installs this tracer
    # (``install`` keeps one already installed), its events made and
    # recorded once before, so the span adds no event creation
    warm = trace.install("profiled")
    with warm.span("warm", "window", device=True):
        pass
    measure.sync(device)
    warm.settle()
    mark = measure._marker

    def marker():
        with trace.span("window/marker", "window", device=True):
            mark()

    measure._marker = marker
    try:
        tr, _ = measure.traced_window(prog, measure.TRACE_S, device)
    finally:
        measure._marker = mark
    busy = tr.busy_intervals()
    busy_s = sum(b - a for a, b in busy)
    dev, _chunks = tracer.window_records(tr)
    per = {n: 1e3 * sum(b - a for m, a, b in dev if m == n) / tr.rounds
           for n in sorted({m for m, _, _ in dev})}
    stages = (per.get("local/grad", 0.0) + per.get("local/update", 0.0)
              + sum(per.get(n, 0.0) for n in ("exec/compress", "exec/server",
                                              "exec/broadcast")))
    # busy time inside the union of the device track's intervals
    union = []
    for _, a, b in sorted(dev, key=lambda r: r[1]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    covered = sum(max(0.0, min(b, d) - max(a, c))
                  for a, b in busy for c, d in union)
    # one clock: each local/grad interval against the kernels inside it
    # (first start, last end) on the benchmark's marker-aligned timeline,
    # with the gap on the device between the first and the kernel before
    # it: on one clock the interval starts inside that gap
    grads = []
    for n, a, b in dev:
        if n != "local/grad":
            continue
        inside = [(x, y) for _, x, y in tr.kernels if a <= (x + y) / 2 <= b]
        if inside:
            first = min(x for x, _ in inside)
            prev = max((y for _, x, y in tr.kernels if x < first),
                       default=first)
            last = max(y for _, y in inside)
            after = min((x for _, x, y in tr.kernels if x >= last),
                        default=last)
            grads.append({"start_ms": 1e3 * (first - a),
                          "end_ms": 1e3 * (b - last),
                          "gap_before_ms": 1e3 * (first - prev),
                          "gap_after_ms": 1e3 * (after - last)})
    # each device interval's end after its host span's (k-th with k-th)
    wire = trace.latest().export_wire(device=True)
    names, tids = wire["names"], wire["tids"]
    args = json.loads(wire["args_json"])
    host, device_ends, errs = {}, {}, []
    for i, (n, t, _a, b) in enumerate(zip(wire["name_ix"], wire["tid_ix"],
                                          wire["t0"], wire["t1"])):
        if str(tids[t]).startswith("cuda:"):
            device_ends.setdefault(names[n], []).append(float(b))
            errs.append(args[i]["anchor_err_us"])
        else:
            host.setdefault(names[n], []).append(float(b))
    lead = [1e3 * (d - h) for n, ds in device_ends.items()
            for d, h in zip(ds, host.get(n, []))]
    return {"raw": {"kernels": tr.kernels, "spans": tr.spans,
                    "device": dev},
            "rounds": tr.rounds, "window_s": tr.window_s,
            "busy_ms_per_round": 1e3 * busy_s / tr.rounds,
            "device_ms_per_round": per,
            "stages_share_of_busy": stages / (1e3 * busy_s / tr.rounds),
            "union_share_of_busy": covered / busy_s,
            "marker_span_ms": [1e3 * x for n, a, b in dev
                               if n == "window/marker" for x in (a, b)],
            "local_grad_against_kernels": grads,
            "device_end_after_host_end_ms": {
                "n": len(lead), "min": min(lead), "median":
                statistics.median(lead)},
            "anchor_err_us": {"min": min(errs), "max": max(errs)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from pb import cli, spec

    cell = spec.cell(args.workload)
    cli.set_environment(cell)
    sys.path.insert(0, str(spec.ROOT / "src"))
    from pb import bench, program, traffic

    device = "cuda"
    fam = bench.family(cell.config["family"])
    prog = program.Program(
        cell, fam, fam.init_params(cell.config, args.seed, device),
        traffic.make(cell.traffic, cell.config, args.seed), args.seed,
        device)
    prog.check_rounds(lambda: fam.init_params(cell.config, args.seed,
                                              device))
    t0 = time.perf_counter()
    result = {"workload": cell.name, "seed": args.seed, "card": card(),
              "windows": windows(prog, args.windows, args.seconds, device)}
    result["profiled"] = profiled(prog, device)
    result["seconds"] = time.perf_counter() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
