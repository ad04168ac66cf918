"""The port's benchmark, one cell a run:

    python3 stembench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the cell's metrics as the last line of standard output (one JSON
object) and the numbers that decided ``correct`` as the last lines of
standard error. Needs as many CUDA devices as the cell names.
"""
import time

T0 = time.perf_counter()    # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths; the
# port's own nvcc builds land in build/repro_torch/
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# the script's own directory would shadow the standard library's modules
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from stembench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
