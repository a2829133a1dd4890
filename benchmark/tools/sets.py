"""Runs of one cell, each a process of its own as the check makes them, and
the spread of each metric.

    python3 benchmark/tools/sets.py --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--trace 0|1] [--out FILE]

Each run is `benchmark/run.py` with one seed, one after another. Prints
each run's result line, then per metric the median and the spread (the
distance between the first and the third quartile over the median,
`statistics.quantiles(values, n=4)`), as one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds", str(seconds), "--trace",
               str(args.trace)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        tail = proc.stderr.strip().splitlines()[-8:]
        lines = proc.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        runs.append({"seed": int(seed), "rc": proc.returncode, "result": result,
                     "stderr_tail": tail})
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    ok = [r["result"] for r in runs if r["result"]]
    for name in sorted({m for r in ok for m in r["metrics"]}):
        vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
        row = {"values": vals, "median": statistics.median(vals)}
        if len(vals) >= 2:
            q1, med, q3 = statistics.quantiles(vals, n=4)
            row["spread"] = (q3 - q1) / med if med else None
        summary[name] = row
    line = json.dumps({"workload": args.workload, "correct": [r["correct"] for r in ok],
                       "rcs": [r["rc"] for r in runs], "metrics": summary})
    if args.out:
        with open(args.out, "a") as f:
            for r in runs:
                f.write(json.dumps(r) + "\n")
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
