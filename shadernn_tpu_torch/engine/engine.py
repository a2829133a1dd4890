"""High-level inference engine (counterpart of shadernn_tpu/engine/engine.py):
load a model artifact, optimize and compile it, then run frames with
timing statistics.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Dict, List, Optional, Union

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

    With `mesh=` (parallel/mesh.py) and `EngineOptions.sharding` the engine
    is sharded over the mesh's devices (parallel/spmd.py): the entry points
    take the global frames, split them across the shards, and return the
    assembled global outputs on the mesh's first device.
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
        mesh=None,
        optimize: bool = True,
    ) -> "Engine":
        options = options or EngineOptions()
        resolve_device(options)  # fail before touching the graph
        if optimize:
            counts = fusion.optimize(graph, fold_bn=options.fold_batchnorm)
            logger.info("graph optimize: %s", counts)
        graph.infer_shapes(batch_size=options.batch_size)
        if options.precision.is_quantized:
            from shadernn_tpu_torch.quant.quantize import quantize_graph_weights

            quantize_graph_weights(graph)
        logger.info("\n%s", graph.summary())
        return cls(compile_graph(graph, options, mesh=mesh))

    @classmethod
    def from_json(
        cls,
        path: Union[str, os.PathLike],
        options: Optional[EngineOptions] = None,
        mesh=None,
        input_hw: Optional[tuple] = None,
    ) -> "Engine":
        """Load a ShaderNN-format model artifact (JSON or _layers.json +
        _weights.bin pair). `input_hw` re-targets the artifact to another
        frame size (the weights are size-agnostic)."""
        from shadernn_tpu_torch.graph.parser import parse_model_file

        return cls.from_graph(parse_model_file(path, input_hw=input_hw), options, mesh=mesh)

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

    def _cuda_devices(self) -> List[torch.device]:
        """The engine's CUDA devices: every device of its mesh, once each."""
        mesh = getattr(self.model, "mesh", None)
        devs = mesh.local_devices if mesh is not None else [self.model.device]
        return [d for d in dict.fromkeys(devs) if d.type == "cuda"]

    def _sync(self) -> None:
        """Wait for the engine's devices: every device of its mesh."""
        for dev in self._cuda_devices():
            torch.cuda.synchronize(dev)

    def dispatch(self, inputs: Dict[str, object]):
        """Queue one engine step without waiting for the device: its outputs,
        and an event recorded after it on the current stream of each CUDA
        device it used. The upload of host inputs copies from pageable
        memory, so it waits for work already queued on the stream. Where
        CUDA graphs engage (engine/graphs.py `run_dispatch`: an unsharded
        CUDA model whose plan runs more than one entry), the step is one
        graph replay from its second call with those input shapes."""
        from shadernn_tpu_torch.engine.graphs import run_dispatch

        self._check_inputs(inputs)
        outs = run_dispatch(self.model, self._to_device(inputs))
        events = []
        for dev in self._cuda_devices():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return outs, events

    def run(self, inputs: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """One engine step over a batch of frames, timed on the host clock,
        including the host->device transfer and waiting for the result."""
        self.stats.total.start()
        outs, _ = self.dispatch(inputs)
        self._sync()
        self.stats.total.stop()
        return outs

    def run_single(self, x) -> torch.Tensor:
        (in_name,) = self.graph.input_names
        return self.run({in_name: x})[self.graph.output_names[0]]

    def classify(self, x) -> np.ndarray:
        """Argmax postprocess of the first output (reference CLASSIFICATION
        path, core.cpp:228), on the host."""
        return torch.argmax(self.run_single(x), dim=-1).cpu().numpy()

    def device_benchmark(self, inputs: Dict[str, object], iters: int = 50,
                         repeats: int = 3) -> dict:
        """Device throughput: `iters` steps queued back to back on inputs
        already on the device, one window of CUDA events around them and one
        sync (the host clock on the CPU), `repeats` windows after one warm
        step. Eager PyTorch does not merge repeated steps, so the inputs are
        not perturbed as the JAX package's fori_loop must. Host dispatch can
        still bound a small model here: the window ends when the last step
        ends, and if the host queues steps slower than the card runs them,
        the card waits. A CUDA graph of the step is ROADMAP A1."""
        self._check_inputs(inputs)
        dev_inputs = self._to_device(inputs)
        cuda = self.model.device.type == "cuda"
        self.model(dev_inputs)  # warm: prepared operands, the kernels' first launch
        self._sync()
        times = []
        for _ in range(repeats):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(iters):
                    self.model(dev_inputs)
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1) / 1e3)
            else:
                s = time.perf_counter()
                for _ in range(iters):
                    self.model(dev_inputs)
                times.append(time.perf_counter() - s)
        batch = next(iter(dev_inputs.values())).shape[0]
        per_iter = min(times) / iters
        p50 = sorted(times)[len(times) // 2] / iters
        return {
            "mean_ms": 1e3 * per_iter,
            "p50_ms": 1e3 * p50,
            "p50_ms_per_frame": 1e3 * p50 / batch,
            "frames_per_sec": batch / per_iter,
            "iters": iters,
            "batch": batch,
        }

    def trace_benchmark(self, inputs: Dict[str, object], steps: int = 20) -> dict:
        """In-situ device time per step from a torch.profiler run of `steps`
        steps queued back to back (utils/trace_profile.py): the sum of the
        device's own events, the busy time per step. The parsed per-kernel
        report is under "report"."""
        from shadernn_tpu_torch.utils.trace_profile import trace_report

        self._check_inputs(inputs)
        report = trace_report(self, inputs, steps=steps)
        batch = next(iter(inputs.values())).shape[0]
        ms = report.e2e_us / 1e3
        return {
            "device_ms_per_step": ms,
            "device_ms_per_frame": ms / batch,
            "frames_per_sec": batch / (ms / 1e3) if ms else 0.0,
            "steps": report.steps,
            "batch": batch,
            "report": report,
        }

    # -- reporting ---------------------------------------------------------
    def time_report(self) -> str:
        """The reference's timing table (core.cpp:436-460): a row per layer of
        this engine from the `snn.layer` spans recorded while tracing was on
        (utils/timer.py), the whole step's host time, and the counters."""
        return self.stats.report(warmup=self.options.warmup_loops, nodes=self.graph.nodes)

    def benchmark(self, inputs: Dict[str, object], loops: int = 20) -> dict:
        """Run `loops` steps on inputs already on the device; mean/p50/min
        latency, its standard deviation and frames/s excluding the first
        `warmup_loops`. On the card each step is timed with CUDA events; on
        the CPU with the host clock."""
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
        stdev = statistics.stdev(t) if len(t) > 1 else 0.0
        return {
            "mean_ms": 1e3 * mean,
            "p50_ms": 1e3 * t[len(t) // 2] if t else 0.0,
            "min_ms": 1e3 * t[0] if t else 0.0,
            "stdev_ms": 1e3 * stdev,
            "frames_per_sec": batch / mean if mean else 0.0,
            "loops": len(t),
            "batch": batch,
        }
