"""ESPCN super-resolution (2x), the reference's flagship benchmark model
(counterpart of shadernn_tpu/models/espcn.py):

  input Y-channel (1ch) -> Conv 5x5x16 relu -> Conv 3x3x16 relu
  -> Conv 3x3x(r^2) -> depth_to_space(r) -> tanh

Default input 540p (960x540). Seeded weights are bit-identical to the JAX
package's for the same seed.
"""

from __future__ import annotations

from typing import Optional

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph


def build_espcn(
    h: int = 540,
    w: int = 960,
    scale: int = 2,
    channels: int = 1,
    weights: Optional[dict] = None,
    seed: int = 7767517,
) -> Graph:
    """weights: optional dict {layer_name: {"weight": ..., "bias": ...}} with
    conv weights in HWIO; otherwise seeded-random init."""
    b = GraphBuilder(f"ESPCN_{scale}X_16_16_{scale**2 * channels}", seed=seed)

    def wb(name):
        if weights and name in weights:
            return weights[name].get("weight"), weights[name].get("bias")
        return None, None

    x = b.input(h, w, channels, name="input")
    w1, b1 = wb("conv_1")
    x = b.conv2d(x, 16, 5, activation="relu", weight=w1, bias=b1, name="conv_1")
    w2, b2 = wb("conv_2")
    x = b.conv2d(x, 16, 3, activation="relu", weight=w2, bias=b2, name="conv_2")
    w3, b3 = wb("conv_3")
    x = b.conv2d(x, scale**2 * channels, 3, weight=w3, bias=b3, name="conv_3")
    x = b.subpixel(x, scale, name="subpixel")
    b.activation(x, "tanh", name="tanh_out")
    return b.build()
