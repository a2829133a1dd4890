"""The least time of a step's work, from a configuration's layer shapes.

Operations: each op's own count in the reference's table
(`reference/plain.py`: 2 * kh * kw * (Cin / groups) * Cout per output pixel
of a conv, per input pixel of a transposed conv; an op that no table holds
is an error); an f32 product counts once, whatever a kernel does to compute
it. Bytes: what any implementation must move once: the step's input
frames at their dtype (uint8), its outputs (each that the configuration
names; float32, as the engine returns them) and its parameters at the
configuration's precision. Intermediates are not counted.

Peaks are NVIDIA's data-sheet dense rates at the full power limit.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

from benchmark.reference.plain import inputs_of


class Peaks(NamedTuple):
    bytes_per_s: float
    bf16: float
    tf32: float
    int8: float


PEAKS = {
    "H100 SXM": Peaks(3.35e12, 989e12, 495e12, 1979e12),
    "H100 PCIe": Peaks(2.0e12, 756e12, 378e12, 1513e12),
}
# The peak of each precision: an f32 path is held to the TF32 tensor rate,
# so that no f32 path can read above its peak.
PRECISION_PEAK = {"bf16": "bf16", "fp16": "bf16", "fp32": "tf32", "int8": "int8"}
PARAM_BYTES = {"bf16": 2, "fp16": 2, "fp32": 4, "int8": 1}


def peaks_for(device_name: str) -> Tuple[str, Peaks]:
    key = "H100 PCIe" if "PCIe" in device_name else "H100 SXM"
    return key, PEAKS[key]


def frame_cost(model, h: int, w: int, c: int) -> Dict[str, int]:
    """Operations, parameters and output values of one frame of ``model``
    (a `reference.plain.Model`), each op counted by its own table entry. A
    layer's input shape is the previous layer's, or its ``"from"`` layers'
    (`plain.inputs_of`); the output values are those of the model's
    ``outputs``, or of its last layer."""
    ops = params = 0
    shape, shapes = (h, w, c), {}
    for layer in model.layers:
        op = model.op(layer)
        shape_in = inputs_of(layer, shape, shapes)
        shape = op.shape(layer, shape_in)
        ops += op.ops(layer, shape_in, shape)
        params += sum(math.prod(s) for s in op.weights(layer).values())
        shapes[layer["name"]] = shape
    outs = [shapes[name] for name in model.outputs] if model.outputs else [shape]
    return {"ops": ops, "params": params, "out_values": sum(math.prod(s) for s in outs)}


def step_cost(model, config: dict, batch: int) -> Dict[str, float]:
    """Operations and bytes of one step of `batch` frames."""
    inp = config["input"]
    f = frame_cost(model, inp["height"], inp["width"], inp["channels"])
    in_bytes = batch * inp["height"] * inp["width"] * inp["channels"]
    out_bytes = batch * f["out_values"] * 4
    par_bytes = f["params"] * PARAM_BYTES[config["precision"]]
    return {"ops": batch * f["ops"], "bytes": in_bytes + out_bytes + par_bytes}


def least_time_s(cost: Dict[str, float], precision: str, peaks: Peaks) -> Tuple[float, str]:
    """(seconds, "ops" or "bytes"): the larger of the two times."""
    t_ops = cost["ops"] / getattr(peaks, PRECISION_PEAK[precision])
    t_bytes = cost["bytes"] / peaks.bytes_per_s
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_ops(precision: str, peaks: Peaks) -> float:
    return getattr(peaks, PRECISION_PEAK[precision])
