"""The readings the limits of ``correct`` are set from, for one cell, on
many seeds in one process (the benchmark's own runs do not run this):

  * ``program``: the program's checked rounds (round 1, then one chunk)
    against the reference (the lower readings);
  * ``control``: the reference in TF32, the nearest precision below the
    configuration's float32, put in the program's place (an upper reading);
  * ``half_batch``: the reference with half of every batch left out, the
    mean taken over the rest (a fault a training step can have).

A state left unchanged reads 1 by ``dx_gap`` and needs no run.

    python3 perfbench/calibrate.py --workload NAME --seeds 11 22 33 [--out F]
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def half(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def readings(cell, seed: int, device) -> dict:
    """Every reading of one seed, each as the numbers of ``check.gaps``
    against the reference, and the readings themselves (``raw``: the norms
    by leaf) for statistics chosen later."""
    from pb import bench, check, program, spec, traffic

    fam = bench.family(cell.config["family"])
    data = traffic.make(cell.traffic, cell.config, seed)
    prog = program.Program(cell, fam,
                           fam.init_params(cell.config, seed, device), data,
                           seed, device)
    got = prog.check_rounds(lambda: fam.init_params(cell.config, seed, device))
    del got["peak"]
    batches = prog.feed.reference_batches(spec.checked_rounds(cell.traffic))
    prog.close()
    ref = bench.reference_readings(cell, fam, batches, seed, device)
    tf32 = bench.reference_readings(cell, fam, batches, seed, device,
                                    precision="tf32")
    lg = fam.reference_loss_and_grad(cell.config, "exact")
    faulty = bench.reference_readings(
        cell, fam, batches, seed, device,
        loss_and_grad=lambda p, b: lg(p, half(b)))
    rounds = cell.traffic.get("loss_rounds")
    return {"seed": seed, "program": check.gaps(got, ref, rounds),
            "control": check.gaps(tf32, ref, rounds),
            "half_batch": check.gaps(faulty, ref, rounds),
            "loss_by_round": {"program": check.loss_gaps(got, ref),
                              "control": check.loss_gaps(tf32, ref),
                              "half_batch": check.loss_gaps(faulty, ref)},
            "raw": {"program": got, "reference": ref, "control": tf32,
                    "half_batch": faulty}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from pb import cli, spec

    cell = spec.cell(args.workload)
    cli.set_environment(cell)
    sys.path.insert(0, str(spec.ROOT / "src"))
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = readings(cell, seed, args.device)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {}
    for kind in ("program", "control", "half_batch"):
        for name in rows[0][kind]:
            vals = [r[kind][name] for r in rows]
            summary[f"{kind}.{name}"] = {"min": min(vals), "max": max(vals)}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": cell.name, "rows": rows, "summary": summary},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
