#!/usr/bin/env python3
"""The benchmark of the PyTorch port (``bloomscene_tpu_torch``) on one
CUDA card: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints progress and, as its last lines, each compared number beside its
limit on standard error, and one JSON object as the last line of standard
output. Without a CUDA device it exits with 3 and prints no result.
"""
import time

_T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], _T_START))
