"""Runs one cell of the port's benchmark once and prints its result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout, on a machine with a card. See README.md.
"""

import time

STARTED = time.perf_counter()  # set-up runs from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every cache of the program lives at a fixed place inside the checkout,
# so that only a checkout's first run of a cell builds or compiles.
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".portbench_cache",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
# The package is imported as ``portbench``, from the checkout's root; its
# own folder leaves the path, so that its modules shadow nothing.
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
