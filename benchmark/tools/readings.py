"""The readings that the check's limits are set from, in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 101,102,103] [--seconds 2] [--out FILE]

For each seed, one run of the cell's window (short) and the numbers its
check compares; then the same for the controls (the program's INT8 path,
and for the closed loops the reference in fp8 in the program's place),
which have to come out above the limits. Prints one JSON line.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import controls, core, spec

    cell = spec.load_cell(args.workload)
    out = {"workload": args.workload, "program": {}, "int8": {}, "fp8_reference": {}}

    def numbers(seed, factory=None):
        r = core.run_cell(cell, seed, args.seconds, False, time.monotonic(),
                          program_factory=factory)
        n = r["_numbers"]
        n["failed"] = r["failed"]
        core.log(f"{args.workload} seed {seed} {'program' if factory is None else factory}: {n}")
        return n

    for s in (int(x) for x in args.seeds.split(",")):
        out["program"][s] = numbers(s)
    for s in (int(x) for x in args.control_seeds.split(",") if x):
        out["int8"][s] = numbers(s, controls.Int8Program)
        if cell.traffic["loop"] == "closed":
            out["fp8_reference"][s] = numbers(s, controls.ReferenceProgram)
    out["forbidden_modules"] = core.forbidden_modules()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
