"""The cells of `BENCHMARK.json` and the files each names.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name: `configs/<config>.json`, `traffic/<traffic>.json`,
`metrics/<metric>.py` (a reader, `read(record)`; a metric split by a
suffix shares the reader of its stem), `limits/<cell>.json`
(the limit of each number the check compares) and
`reference/<family>.py` (the plain reference's layers). Adding a cell, a
mix or a metric adds files and entries; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def load_cell(name: str, bench: Optional[dict] = None, root: str = ROOT) -> Cell:
    bench = bench if bench is not None else _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, entry["file"]))
    traffic = _json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    limits_path = os.path.join(root, "benchmark", "limits", f"{name}.json")
    limits = _json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, limits)


def reader(metric: str, root: str = ROOT) -> Callable:
    """The `read(record)` of `metrics/<metric>.py`. A name split by a suffix
    (`step_mfu.b1`) falls back to the reader of the name without it
    (`metrics/step_mfu.py`) where it has no file of its own."""
    name = metric
    while True:
        path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
        if os.path.exists(path) or "." not in name:
            break
        name = name.rsplit(".", 1)[0]
    return _module(path, "_bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def family(name: str, root: str = ROOT):
    """`reference/<family>.py`: its `layers(config)`, and the `OPS` and
    `ACTS` of its own where it has any."""
    path = os.path.join(root, "benchmark", "reference", f"{name}.py")
    return _module(path, "_bench_family_" + name.replace("-", "_"))


def model(config: dict, root: str = ROOT):
    """The configuration's layers with the tables they dispatch through
    (`reference.plain.Model`)."""
    from benchmark.reference import plain

    return plain.model(family(config["family"], root), config)
