#!/usr/bin/env python3
"""Serve one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
The last line of standard output is the result as one JSON object; the
last lines of standard error are the numbers compared, each with its
limit.  Without the cards it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "build" / "portbench_cache"  # fixed, inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)
sys.path[0] = str(REPO)  # the checkout's root, not this folder, leads the search

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
