#!/usr/bin/env python3
"""The benchmark of ``kma_tpu_torch``, the PyTorch and CUDA port of KMA's
device path: ``python3 kmabench/run.py --workload NAME --seed N
--seconds S --trace 0|1`` from the root of a checkout, one run of one
cell of ``BENCHMARK.json`` (``kmabench/harness.py`` says what a run
does).  Needs a CUDA card and the port beside it; exits non-zero with
no result without either."""

import os
import sys
import time

T_PROC = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from kmabench import harness
    sys.exit(harness.main(sys.argv[1:], t_proc=T_PROC))
