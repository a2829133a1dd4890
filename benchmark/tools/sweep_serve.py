"""The sweep that finds an open-loop cell's knee, in one process.

    python3 benchmark/tools/sweep_serve.py --workload <cell> --streams 60,70,80 \
        [--seconds 10] [--seed N] [--out FILE]

Runs the cell's open loop at each stream count (the traffic file's other
parameters as they are) and prints, per rate, the offered and completed
frames a second, their ratio, the latency percentiles and the generator's
lateness in the first and second half of the window. The knee is the
highest rate that completes at least 99% of the frames due, with no
backlog and no lateness that grows.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--streams", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import core, spec

    rows = []
    for n in (int(x) for x in args.streams.split(",")):
        cell = spec.load_cell(args.workload)
        cell.traffic = dict(cell.traffic, streams=n)
        r = core.run_cell(cell, args.seed, args.seconds, False, time.monotonic())
        m = {k: v["value"] for k, v in r["metrics"].items()}
        offered = n * float(cell.traffic["fps"])
        row = {"streams": n, "offered": offered, "completed_share": m["frames_per_s"] / offered,
               "failed": r["failed"], "correct": r["correct"], **m, "notes": r["_notes"]}
        core.log(json.dumps(row))
        rows.append(row)
    line = json.dumps({"workload": args.workload, "rows": rows})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
