"""Deployment artifacts: an engine saved after planning, loaded without the
model code (counterpart of shadernn_tpu/engine/deploy.py, which saves the
jitted step as StableHLO plus the weight pytree).

The port has no serialized program: its step is the forward that
`compile_graph` plans from a graph. So `export_engine` saves the graph as
the engine runs it, after fusion, shape inference, quantization and
calibration, and `ExportedEngine` rebuilds that graph with the IR's own
constructors and plans it again on the card. No parser, builder, fusion,
quantization or calibration runs at load, and the rebuilt plans must equal
the recorded ones. The kernels come from `build/kernels/`, as everywhere
else (kernels/_build.py).

    exported/
      graph.json   nodes in topological order: op, inputs, attributes,
                   output spec (calibrated scales are attributes)
      params.npz   weights, "node|param" keys (the JAX export's format)
      meta.json    inputs, outputs, precision, the EngineOptions fields and
                   the plans (chain_plan, block_plan, single_conv_plan,
                   kernel_conv_plan, kernel_dense_plan)
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Dict

import numpy as np

from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision, ShardingOptions
from shadernn_tpu_torch.engine.compile import compile_graph
from shadernn_tpu_torch.engine.engine import Engine
from shadernn_tpu_torch.graph.ir import Graph, Node, TensorSpec
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.deploy")

PLANS = ("chain_plan", "block_plan", "single_conv_plan", "kernel_conv_plan",
         "kernel_dense_plan")


def _encode(v):
    """A JSON value of an attribute, with tuples and arrays tagged so that
    they come back as they were."""
    if isinstance(v, enum.Enum):
        return _encode(v.value)
    if isinstance(v, ShardingOptions):
        return dataclasses.asdict(v)
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return {"__tuple__": [_encode(x) for x in v]}
    if isinstance(v, list):
        return [_encode(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _encode(x) for k, x in v.items()}
    return v


def _decode(v):
    if isinstance(v, dict):
        if "__tuple__" in v:
            return tuple(_decode(x) for x in v["__tuple__"])
        if "__ndarray__" in v:
            return np.asarray(v["__ndarray__"], dtype=v["dtype"])
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


def _plans(forward) -> dict:
    return {k: _encode(getattr(forward, k)) for k in PLANS}


def export_engine(engine, path: str) -> str:
    """Save the engine's planned graph, weights and options to `path` (a
    single-device engine's: a sharded one is rebuilt over its mesh)."""
    if getattr(engine.model, "mesh", None) is not None:
        raise ValueError("export_engine takes a single-device engine, not a sharded one")
    os.makedirs(path, exist_ok=True)
    graph = engine.graph
    nodes = [
        {"name": n.name, "op": n.op, "inputs": list(n.inputs), "attrs": _encode(n.attrs),
         "out_spec": {"shape": list(n.out_spec.shape), "dtype": n.out_spec.dtype}}
        for n in graph.toposort()
    ]
    with open(os.path.join(path, "graph.json"), "w") as f:
        json.dump({"name": graph.name, "input_names": graph.input_names,
                   "output_names": graph.output_names, "meta": _encode(graph.meta),
                   "nodes": nodes}, f, indent=1)

    flat = {
        f"{node}|{pname}": t.detach().cpu().numpy()
        for node, d in engine.model.params.items()
        for pname, t in d.items()
    }
    np.savez(os.path.join(path, "params.npz"), **flat)

    options = {f.name: _encode(getattr(engine.options, f.name))
               for f in dataclasses.fields(EngineOptions)}
    meta = {
        "graph": graph.name,
        "inputs": {n: list(graph.nodes[n].out_spec.shape) for n in graph.input_names},
        "outputs": graph.output_names,
        "precision": engine.options.precision.value,
        "options": options,
        "plans": _plans(engine.model.forward),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info("exported %s -> %s (%d weight tensors)", graph.name, path, len(flat))
    return path


def _options(recorded: dict, device: str) -> EngineOptions:
    # An option that an older export recorded and EngineOptions no longer has is dropped.
    names = {f.name for f in dataclasses.fields(EngineOptions)}
    kw = {k: v for k, v in _decode(recorded).items() if k in names}
    kw["precision"] = Precision(kw["precision"])
    kw["backend"] = BackendKind(kw["backend"])
    if kw.get("backend_overrides"):
        kw["backend_overrides"] = {k: BackendKind(v) for k, v in kw["backend_overrides"].items()}
    kw["sharding"] = ShardingOptions(**kw.get("sharding", {}))
    kw["device"] = device
    return EngineOptions(**kw)


class ExportedEngine(Engine):
    """An engine loaded from `export_engine`'s directory and planned again
    on `device` (the card unless the caller asks for the CPU): no model
    code runs. It is an `Engine` (run, run_single, benchmark, ...), and so a
    `StreamingEngine` serves it."""

    def __init__(self, path: str, device: str = "cuda"):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        options = _options(self.meta["options"], device)
        with open(os.path.join(path, "graph.json")) as f:
            saved = json.load(f)
        npz = np.load(os.path.join(path, "params.npz"))
        params: Dict[str, Dict[str, np.ndarray]] = {}
        for key in npz.files:
            node, pname = key.split("|", 1)
            params.setdefault(node, {})[pname] = npz[key]
        graph = Graph(saved["name"])
        for rec in saved["nodes"]:
            spec = rec["out_spec"]
            graph.add(Node(rec["name"], rec["op"], list(rec["inputs"]), _decode(rec["attrs"]),
                           params.get(rec["name"], {}),
                           TensorSpec(tuple(spec["shape"]), spec["dtype"])))
        graph.input_names = list(saved["input_names"])
        graph.output_names = list(saved["output_names"])
        graph.meta = _decode(saved["meta"])
        super().__init__(compile_graph(graph, options))
        got = _plans(self.model.forward)
        if json.loads(json.dumps(got)) != self.meta["plans"]:
            raise ValueError(f"the plans rebuilt from {path} differ from the recorded ones: "
                             f"{got} != {self.meta['plans']}")

    def __call__(self, inputs: Dict[str, np.ndarray]):
        return self.run(inputs)
