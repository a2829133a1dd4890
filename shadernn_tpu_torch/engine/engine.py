"""High-level inference engine (counterpart of shadernn_tpu/engine/engine.py):
load a model artifact, optimize and compile it, then run frames with
timing statistics.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from shadernn_tpu_torch.config import EngineOptions
from shadernn_tpu_torch.engine.compile import CompiledModel, compile_graph, resolve_device
from shadernn_tpu_torch.graph import fusion
from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.utils import TimingStats, get_logger

logger = get_logger("snn_torch.engine")


class Engine:
    """Load -> optimize -> compile -> run.

    Usage:
        eng = Engine.from_graph(graph, EngineOptions(precision=Precision.BF16))
        out = eng.run({"input": frames})     # frames: (N, H, W, C)
    """

    def __init__(self, model: CompiledModel):
        self.model = model
        self.stats = TimingStats()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_graph(
        cls,
        graph: Graph,
        options: Optional[EngineOptions] = None,
        optimize: bool = True,
    ) -> "Engine":
        options = options or EngineOptions()
        resolve_device(options)  # fail before touching the graph
        if optimize:
            counts = fusion.optimize(graph, fold_bn=options.fold_batchnorm)
            logger.info("graph optimize: %s", counts)
        graph.infer_shapes(batch_size=options.batch_size)
        logger.info("\n%s", graph.summary())
        return cls(compile_graph(graph, options))

    @classmethod
    def from_json(
        cls,
        path: Union[str, os.PathLike],
        options: Optional[EngineOptions] = None,
        input_hw: Optional[tuple] = None,
    ) -> "Engine":
        """Load a ShaderNN-format model artifact (JSON or _layers.json +
        _weights.bin pair). `input_hw` re-targets the artifact to another
        frame size (the weights are size-agnostic)."""
        from shadernn_tpu_torch.graph.parser import parse_model_file

        return cls.from_graph(parse_model_file(path, input_hw=input_hw), options)

    # -- execution ---------------------------------------------------------
    @property
    def graph(self) -> Graph:
        return self.model.graph

    @property
    def options(self) -> EngineOptions:
        return self.model.options

    def _check_inputs(self, inputs: Dict[str, object]) -> None:
        """Fail loudly on wrong frame shapes: per-frame dims (H, W, C) must
        match the compiled specs exactly; the batch size may differ."""
        for name, spec in self.model.input_specs.items():
            if name not in inputs:
                raise KeyError(
                    f"missing input '{name}'; expected inputs "
                    f"{sorted(self.model.input_specs)}"
                )
            got = tuple(np.shape(inputs[name]))
            if len(got) != len(spec) or got[1:] != tuple(spec[1:]):
                raise ValueError(
                    f"input '{name}' has shape {got}, but the engine was "
                    f"compiled for (N, *{tuple(spec[1:])}); rebuild the "
                    f"graph (e.g. build_model(..., h=, w=)) for other sizes"
                )

    def _to_device(self, inputs: Dict[str, object]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in inputs.items():
            t = torch.as_tensor(v)
            if t.dtype == torch.float64:
                t = t.float()
            out[k] = t.to(self.model.device)
        return out

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self, inputs: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """One engine step over a batch of frames, timed on the host clock,
        including the host->device transfer and waiting for the result."""
        self._check_inputs(inputs)
        self.stats.total.start()
        outs = self.model(self._to_device(inputs))
        self._sync()
        self.stats.total.stop()
        return outs

    def run_single(self, x) -> torch.Tensor:
        (in_name,) = self.graph.input_names
        return self.run({in_name: x})[self.graph.output_names[0]]

    # -- reporting ---------------------------------------------------------
    def time_report(self) -> str:
        return self.stats.report(warmup=self.options.warmup_loops)

    def benchmark(self, inputs: Dict[str, object], loops: int = 20) -> dict:
        """Run `loops` steps on inputs already on the device; mean/p50
        latency and frames/s excluding the first `warmup_loops`. On the card
        each step is timed with CUDA events; on the CPU with the host
        clock."""
        self._check_inputs(inputs)
        dev_inputs = self._to_device(inputs)
        cuda = self.model.device.type == "cuda"
        times = []
        for _ in range(loops):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                self.model(dev_inputs)
                t1.record()
                times.append((t0, t1))
            else:
                s = time.perf_counter()
                self.model(dev_inputs)
                times.append(time.perf_counter() - s)
        self._sync()
        secs = [a.elapsed_time(b) / 1e3 for a, b in times] if cuda else times
        warmup = min(self.options.warmup_loops, max(loops - 1, 0))
        self.stats.total.samples.extend(secs)
        t = sorted(secs[warmup:])
        mean = sum(t) / len(t) if t else 0.0
        batch = next(iter(dev_inputs.values())).shape[0]
        return {
            "mean_ms": 1e3 * mean,
            "p50_ms": 1e3 * t[len(t) // 2] if t else 0.0,
            "min_ms": 1e3 * t[0] if t else 0.0,
            "frames_per_sec": batch / mean if mean else 0.0,
            "loops": len(t),
            "batch": batch,
            "clock": "cuda_events" if cuda else "host",
        }
