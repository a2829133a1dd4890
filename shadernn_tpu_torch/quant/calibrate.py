"""Activation-range calibration for int8 activations (counterpart of
shadernn_tpu/quant/calibrate.py).

Weight-only INT8 (quant/quantize.py) needs no calibration. Int8
activations do: `calibrate_activations` runs representative batches
through the engine's per-layer dump forward, on the engine's device, and
records a symmetric scale range/127 per layer (`attrs['act_scale']` on each
node and `graph.meta['act_scales']`). `propagate_input_scales`, which the
compile step calls before it plans, copies a producer's scale onto each
single-input Conv2D/Dense consumer with int8 weights as `in_act_scale`;
the chain planner (kernels/chain.py a8_scales), the block planner
(kernels/invres.py build_invres) and the TORCH path's A8W8
(ops/conv.py a8w8_engaged) read them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.calibrate")


def _percentile(a: torch.Tensor, q: float) -> float:
    """numpy's default ("linear") percentile of a flat tensor, on its
    device: the two order statistics around q/100 * (n - 1), interpolated."""
    v, _ = torch.sort(a.reshape(-1).float())
    pos = q / 100.0 * (v.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    a_lo, a_hi = float(v[lo]), float(v[hi])
    return a_lo + (a_hi - a_lo) * (pos - lo)


def calibrate_activations(
    engine,
    batches: Iterable[Dict[str, np.ndarray]],
    percentile: Optional[float] = 99.9,
) -> Dict[str, float]:
    """Run calibration batches, recording per-layer activation ranges.

    Returns {layer_name: scale} with scale = range/127 for symmetric int8,
    and stores them on each node (attrs['act_scale']) and in
    graph.meta['act_scales']. The model inputs are activations too (a chain
    head's or a first conv's int8 operand). percentile=None takes the
    absolute max."""
    from shadernn_tpu_torch.engine.compile import compile_graph

    graph: Graph = engine.graph
    model = compile_graph(graph, dataclasses.replace(engine.options, dump_outputs=True))
    ranges: Dict[str, float] = {}
    nbatches = 0
    for batch in batches:
        inputs = {k: torch.as_tensor(np.asarray(v, np.float32)).to(model.device)
                  for k, v in batch.items()}
        dumps = dict(model(inputs)["__dumps__"])
        dumps.update(inputs)
        for name, act in dumps.items():
            a = act.float().abs()
            r = _percentile(a, percentile) if percentile is not None else float(a.max())
            ranges[name] = max(ranges.get(name, 0.0), r)
        nbatches += 1
    logger.info("calibrated %d layers over %d batches", len(ranges), nbatches)

    scales = {}
    for name, r in ranges.items():
        scale = r / 127.0 if r > 0 else 1.0
        scales[name] = scale
        graph.nodes[name].attrs["act_scale"] = scale
    graph.meta["act_scales"] = scales
    return scales


def quantize_activation(x: np.ndarray, scale: float) -> np.ndarray:
    """The symmetric activation quantizer of the int8 paths, in numpy
    (clip to +/-127)."""
    return np.clip(np.round(np.asarray(x, np.float32) / scale), -127, 127).astype(np.int8)


def quantization_snr_db(x: np.ndarray, scale: float) -> float:
    """Signal-to-quantization-noise for a given scale (calibration QA)."""
    q = quantize_activation(x, scale).astype(np.float32) * scale
    err = np.mean((np.asarray(x, np.float32) - q) ** 2)
    sig = np.mean(np.asarray(x, np.float32) ** 2)
    if err == 0:
        return float("inf")
    return float(10 * np.log10(sig / err))


# Ops whose TORCH path can take an int8 input operand when the weights are
# int8 (A8W8). The depthwise SeparableConv2D stays float, as in the JAX
# package.
A8W8_OPS = ("Conv2D", "Dense")


def propagate_input_scales(graph: Graph) -> int:
    """Stamp each single-input Conv2D/Dense node with int8 weights with its
    producer's `act_scale` as `in_act_scale`. Multi-input nodes are skipped
    (their inputs carry different scales). Returns the number of nodes
    stamped."""
    count = 0
    for n in graph.nodes.values():
        if n.op not in A8W8_OPS or "weight_q" not in n.params or len(n.inputs) != 1:
            continue
        producer = graph.nodes.get(n.inputs[0])
        if producer is None:
            continue
        sa = producer.attrs.get("act_scale")
        if sa:
            n.attrs["in_act_scale"] = float(sa)
            count += 1
    return count
