"""Run one cell of BENCHMARK.json on this machine's first card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's result as the last line of
standard output; the numbers the check compared, each beside its limit, go
last on standard error. Exits non-zero, printing no result, without a card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# kernel caches at fixed places inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(HERE / "_cache" / "nv"))
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / "_cache" / "triton"))
sys.path.insert(0, str(HERE))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
