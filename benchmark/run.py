"""
Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, metrics and limits are found by
name from BENCHMARK.json (benchlib/spec.py). The program measured is
audio_analysis_tpu_torch on a CUDA card; the run fails, and prints no
result, without the card or the native decoder.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
