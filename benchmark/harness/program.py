"""The program under test, shadernn_tpu_torch, as the windows drive it.

The only module of the benchmark that imports the program. It builds the
engine of a configuration (`Engine.from_json` of the trained artifact at the
configuration's precision and the traffic's batch) and hands out the three
entries the windows drive: `Engine.dispatch` after the on-device ingest
(offline), the ingest step fused with the model (`make_ingest_fn`, one
frame in flight), and the continuous-batching service (`StreamingEngine`).

A configuration may name its ``outputs`` (graph nodes): they become the
parsed artifact's outputs before the engine is planned (`Engine.from_graph`),
and each entry returns a dict of them. Without them the engine is
`Engine.from_json` of the artifact, and an entry returns the graph's first
output.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch


class Program:
    def __init__(self, root: str, config: dict, batch: int, device: str = "cuda",
                 precision: Optional[str] = None):
        from shadernn_tpu_torch import Engine, EngineOptions, Precision

        inp = config["input"]
        self._prec = Precision(precision or config["precision"])
        self._opts = EngineOptions(precision=self._prec, batch_size=batch, device=device)
        path, hw = os.path.join(root, config["artifact"]), (inp["height"], inp["width"])
        self.out_names = [o["name"] for o in config.get("outputs", [])]
        if self.out_names:
            from shadernn_tpu_torch.graph.parser import parse_model_file

            graph = parse_model_file(path, input_hw=hw)
            graph.output_names = list(self.out_names)
            self.engine = Engine.from_graph(graph, self._opts)
        else:
            self.engine = Engine.from_json(path, self._opts, input_hw=hw)
        self.in_name = self.engine.graph.input_names[0]
        self.out_name = self.engine.graph.output_names[0]
        self.means = tuple(config["ingest"]["means"])
        self.norms = tuple(config["ingest"]["norms"])
        self.device = self.engine.model.device

    def calibrate(self, raw: torch.Tensor) -> None:
        """The INT8 path switched on in full: activation scales from `raw`
        (absolute max), then the engine planned again with int8 activations
        where the program takes them."""
        from shadernn_tpu_torch import Engine
        from shadernn_tpu_torch.image.ingest import ingest_frames
        from shadernn_tpu_torch.quant.calibrate import calibrate_activations

        x = ingest_frames(raw, means=self.means, norms=self.norms, dtype_name="float32")
        calibrate_activations(self.engine, [{self.in_name: x.cpu().numpy()}], percentile=None)
        self.engine = Engine.from_graph(self.engine.graph, self._opts, optimize=False)

    def pick(self, outs: dict):
        """The step's answer from the engine's outputs: the named outputs'
        dict, or the first output."""
        if self.out_names:
            return {k: outs[k] for k in self.out_names}
        return outs[self.out_name]

    def step(self, entry: str) -> Callable[[torch.Tensor], torch.Tensor]:
        """uint8 frames on the device -> the step's answer (`pick`; not
        waited for)."""
        from shadernn_tpu_torch.image.ingest import ingest_frames, make_ingest_fn

        eng, name, pick = self.engine, self.in_name, self.pick
        if entry == "dispatch":
            means, norms = self.means, self.norms

            def run(raw):
                x = ingest_frames(raw, means=means, norms=norms, dtype_name="float32")
                return pick(eng.dispatch({name: x})[0])

            return run
        if entry == "ingest_step":
            fn = make_ingest_fn(eng, means=self.means, norms=self.norms)
            return lambda raw: pick(fn(raw))
        raise ValueError(f"unknown entry {entry!r}")

    def service(self, on_result, batch_window_s: float, max_inflight: int, queue_capacity: int):
        from shadernn_tpu_torch.engine.streaming import StreamingEngine

        return StreamingEngine(self.engine, on_result=on_result, queue_capacity=queue_capacity,
                               batch_window_s=batch_window_s, max_inflight=max_inflight,
                               ingest={"means": self.means, "norms": self.norms})

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        self.engine = None

