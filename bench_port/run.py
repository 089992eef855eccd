"""The benchmark's one command: one run of one cell on the card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds bayesian_optimization_tpu_torch.
It loads and warms up the cell (set-up), runs the cell's closed ask/tell
loop for --seconds, checks what the loop produced against the plain
reference, and prints one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones, read from a profiled part of the window),
`device`, with --trace 1 `breakdown`, and last `checks`, each number
compared with its limit (also the last lines on standard error). It exits
with 2 and prints no result without the CUDA devices the cell asks for, and
with 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for the BLAS and OpenMP pools: the host's share of an
# iteration is single-threaded Python, and idle pools only add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
