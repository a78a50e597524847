"""The benchmark of rtvb_tpu_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (README.md beside this file says more).
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)                     # rtvbbench, reference
sys.path.insert(1, os.path.dirname(HERE))    # the port, rtvb_tpu_torch

if __name__ == "__main__":
    from rtvbbench.cli import main
    sys.exit(main(sys.argv[1:], T_START))
