"""The benchmark's entry point: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout; it measures the PyTorch port under
``src/`` on the CUDA card it is started on (see ``pb/cli.py``)."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from pb import cli

    sys.exit(cli.main(sys.argv[1:], T_START))
