"""``python3 perfbench/run.py --workload NAME --seed N --seconds S --trace
0|1``: one run of one cell on the card this process is started on.

The last line of standard output is the result, one JSON object; the
numbers compared for ``correct`` are also the last lines of standard
error, each beside its limit.  Without a CUDA card (or with fewer than the
cell asks for), or with JAX or the JAX package loaded once the window has
closed, the run prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from pb import spec

#: top-level module names that must not be loaded in the process that
#: prints the result (whole names: the program's begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_environment(cell) -> None:
    """Before PyTorch is imported: one thread for the host's numeric
    libraries (the load comes from one process), and the allocator's
    settings a configuration states."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    alloc = cell.config.get("allocator")
    if alloc:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    set_environment(cell)
    sys.path.insert(0, str(spec.ROOT / "src"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from pb import bench

    result, log = bench.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print(f"perfbench: {cell.name} seed {args.seed} on "
          f"{result['device']['kind']}: {json.dumps(log)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = {k: {kk: _finite(vv) for kk, vv in v.items()}
                        for k, v in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
