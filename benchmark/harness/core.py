"""One run of one cell: set-up, the window, the check, the result line.

The result line is the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and last `check`: each number compared beside its
limit. The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import types
from typing import Callable, Optional

import torch

from benchmark.harness import cost as cost_mod
from benchmark.harness import check, spec, traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "shadernn_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", program_factory: Optional[Callable] = None,
             root: str = spec.ROOT) -> dict:
    """Run the cell once; returns the result object (without printing)."""
    from benchmark.harness.program import Program

    config, traffic = cell.config, cell.traffic
    model = spec.model(config, root)
    batch = int(traffic["batch"])
    make = program_factory or Program
    t_begin = time.monotonic()
    program = make(root, config, batch, device)
    t_built = time.monotonic()
    window = traffic_mod.drive(program, config, traffic, seed, seconds, trace)
    setup_s = window.t_start - t0
    dev = program.device
    cuda = dev.type == "cuda"
    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
    program.close()
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    _, peaks = cost_mod.peaks_for(kind)
    step_cost = cost_mod.step_cost(model, config, batch)
    least_s, bound = cost_mod.least_time_s(step_cost, config["precision"], peaks)
    record = types.SimpleNamespace(
        cell=cell.name, config=config, traffic=traffic, batch=batch, setup_s=setup_s,
        window=window, trace=window.trace, cost=step_cost, least_time_s=least_s, bound=bound,
        peak_ops=cost_mod.peak_ops(config["precision"], peaks))
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = check.reference_model(root, config, model, dev)
    numbers = check.compare(ref, window.answers, dev, config, model)
    compared = {k: {"value": numbers.get(k, float("inf")), "limit": lim}
                for k, lim in sorted(cell.limits.items())}
    correct = (window.failed == 0 and bool(numbers) and bool(compared)
               and all(c["value"] <= c["limit"] for c in compared.values()))
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(mem)}
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": device_info}
    if trace and window.trace:
        t = window.trace
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        ops = sorted(t["rows"].items(), key=lambda kv: -kv[1]["us"])[:10]
        result["breakdown"] = {"device_ops": [[k, r["us"] * 1e-6] for k, r in ops],
                               "idle_gaps": [[k, s] for k, s in t["gaps"]]}
    result["check"] = compared
    result["_notes"] = window.notes + [
        f"[setup] {setup_s:.3f} s: imports and the cell's files {t_begin - t0:.3f} s, the "
        f"program (CUDA, kernels, artifact) {t_built - t_begin:.3f} s, frames and warm-up "
        f"{window.t_start - t_built:.3f} s",
        f"[check] {numbers.get('frames', 0)} frames against the plain reference; least time of a "
        f"step {least_s * 1e3:.6f} ms ({bound}-bound: {step_cost['ops']} ops, "
        f"{step_cost['bytes']} bytes)"]
    result["_numbers"] = numbers
    return result


def main(workload: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    cell = spec.load_cell(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no CUDA device for {workload} (needs {cell.chips}; available: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}); no result")
        return 2
    result = run_cell(cell, seed, seconds, trace, t0)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark must not load JAX or the JAX package")
        return 3
    notes, _ = result.pop("_notes"), result.pop("_numbers")
    notes.append(f"[device] {_power_limit()}")
    for line in notes:
        log(line)
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    if not result["check"]:
        log("check: no limits for this cell")
    print(json.dumps(result), flush=True)
    return 0
