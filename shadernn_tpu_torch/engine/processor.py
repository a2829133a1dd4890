"""InferenceProcessor: the reference-compatible embedding API (counterpart
of shadernn_tpu/engine/processor.py).

Mirrors `snn::InferenceProcessor` (demo/common/inferenceProcessor.h:32-92):
`initialize(params)` builds the engine, `preProcess` stages input frames on
the device, `process` runs `max_loops` iterations and collects benchmark
stats with the first `NUM_EXCLUDE_FIRST_LOOPS`=5 excluded
(inferenceProcessor.cpp:90).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
from shadernn_tpu_torch.engine.engine import Engine

NUM_EXCLUDE_FIRST_LOOPS = 5  # reference inferenceProcessor.cpp:90


@dataclasses.dataclass
class InitializationParameters:
    """Reference InferenceProcessor::InitializationParameters
    (inferenceProcessor.h:34-45), with the JAX package's field names:
    half precision -> BF16; `use_pallas` picks the backend, True the
    hand-written CUDA kernels (`BackendKind.KERNEL`), False plain PyTorch
    ops (`BackendKind.TORCH`). `device` is the engine's (EngineOptions)."""

    model_path: str = ""
    precision: Precision = Precision.FP32
    batch_size: int = 1
    dump_outputs: bool = False
    use_pallas: bool = False
    model_type: str = "other"  # other | classification | detection
    max_loops: int = 10
    device: str = "cuda"


class InferenceProcessor:
    def __init__(self):
        self._engine: Optional[Engine] = None
        self._staged: Dict[str, torch.Tensor] = {}
        self._params: Optional[InitializationParameters] = None

    def initialize(self, cp: InitializationParameters, graph=None) -> None:
        options = EngineOptions(
            precision=cp.precision,
            backend=BackendKind.KERNEL if cp.use_pallas else BackendKind.TORCH,
            batch_size=cp.batch_size,
            dump_outputs=cp.dump_outputs,
            device=cp.device,
        )
        if graph is not None:
            self._engine = Engine.from_graph(graph, options)
        else:
            self._engine = Engine.from_json(cp.model_path, options)
        self._params = cp

    @property
    def engine(self) -> Engine:
        if self._engine is None:
            raise RuntimeError("initialize() first")
        return self._engine

    def pre_process(self, inputs: Dict[str, np.ndarray]) -> None:
        """Stage input frames on the device (analog of binding client
        textures, inferenceProcessor.cpp preProcess)."""
        self.engine._check_inputs(inputs)
        self._staged = self.engine._to_device(inputs)
        self.engine._sync()

    # camelCase alias for drop-in familiarity with the reference API
    preProcess = pre_process

    def process(self) -> dict:
        """Run max_loops iterations on the staged inputs; returns outputs and
        benchmark stats (mean/stdev excluding the first 5 loops). On the card
        each loop is timed with CUDA events, on the CPU with the host
        clock."""
        if not self._staged:
            raise RuntimeError("pre_process() first")
        eng = self.engine
        cuda = eng.model.device.type == "cuda"
        outs, marks = None, []
        for _ in range(self._params.max_loops):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                outs = eng.model(self._staged)
                t1.record()
                marks.append((t0, t1))
            else:
                s = time.perf_counter()
                outs = eng.model(self._staged)
                marks.append(time.perf_counter() - s)
        eng._sync()
        start = eng.stats.total.count
        eng.stats.total.samples.extend([a.elapsed_time(b) / 1e3 for a, b in marks] if cuda
                                       else marks)
        t = eng.stats.total.excluding_warmup(start + NUM_EXCLUDE_FIRST_LOOPS)
        result = {
            "outputs": outs,
            "mean_ms": 1e3 * t.mean,
            "stdev_ms": 1e3 * t.stdev(),
            "loops": t.count,
        }
        first = outs[eng.graph.output_names[0]]
        if self._params.model_type == "classification":
            result["class_index"] = torch.argmax(first, dim=-1).cpu().numpy()
        elif self._params.model_type == "detection":
            result["detections"] = first.float().cpu().numpy()
        return result
