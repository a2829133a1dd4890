"""INT8 weight-only quantization with per-output-channel scales (a copy of
shadernn_tpu/quant/quantize.py, numpy only, so that both packages quantize
a graph to the same bits).

Weights are stored as int8 plus a float32 scale per output channel; the
kernels take the int8 weight with the scale folded into their epilogue
(ops/conv.py folded_operands), the TORCH path dequantizes it in the
compute dtype (ops/conv.py get_weight).

Symmetric quantization: q = round(w / s), s = max|w| / 127 per out-channel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from shadernn_tpu_torch.graph.ir import Graph

# Ops whose "weight" param has the output channel on the trailing axis.
QUANTIZABLE_OPS = ("Conv2D", "SeparableConv2D", "Conv2DTranspose", "Dense")


def quantize_weight(w: np.ndarray, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8. Returns (q int8, scale float32) where
    scale broadcasts against w along `axis`."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def quantize_error(w: np.ndarray, axis: int = -1) -> float:
    q, s = quantize_weight(w, axis)
    return float(np.max(np.abs(dequantize(q, s) - w)))


def quantize_graph_weights(graph: Graph) -> int:
    """Replace float weights with int8+scale storage in place.

    Biases and BN vectors stay float (they are O(C), negligible). Returns
    the number of quantized tensors.
    """
    count = 0
    for n in graph.nodes.values():
        if n.op not in QUANTIZABLE_OPS or "weight" not in n.params:
            continue
        w = n.params.pop("weight")
        q, scale = quantize_weight(w, axis=-1)
        n.params["weight_q"] = q
        n.params["weight_scale"] = scale
        count += 1
    return count
