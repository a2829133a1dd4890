"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the GPUs the cell asks for.
The cells, metrics and bounds are in BENCHMARK.json at the root.
"""

import time

T0 = time.monotonic()  # set-up counts from here: imports, CUDA, build, warm-up

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's bytecode cache, at a fixed path inside the checkout, before any
# import of weight: a run loads what an earlier run in the checkout
# compiled, also where bytecode writing is turned off
# (PYTHONDONTWRITEBYTECODE) or the installation ships no .pyc files.
# Without it every run compiles torch's ~1,100 modules from source, which
# is most of the set-up and of its spread.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")

import argparse  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Build caches live at fixed paths inside the checkout, so that only
    # the first run in a checkout builds.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)
    from benchmark.harness import core

    return core.main(args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
