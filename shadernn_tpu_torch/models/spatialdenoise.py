"""Spatial denoiser (counterpart of shadernn_tpu/models/spatialdenoise.py;
the reference zoo's modelzoo/SpatialDenoise/spatialDenoise.json, runner
1080x1920 luma).

A residual denoise CNN on the luma plane; `merge_source` adds the
reference's Y+UV recombination: a second RGBA input whose chroma the
Calculate op merges with the denoised luma. Seeded weights are
bit-identical to the JAX package's for the same seed.
"""

from __future__ import annotations

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph, Node


def build_spatial_denoise(
    h: int = 1080, w: int = 1920, features: int = 16, depth: int = 4,
    merge_source: bool = False, seed: int = 7767517,
) -> Graph:
    b = GraphBuilder("spatialDenoise", seed=seed)
    y = b.input(h, w, 1, name="input")
    x = b.conv2d(y, features, 3, activation="relu", name="enc")
    for i in range(depth - 2):
        x = b.conv2d(x, features, 3, activation="relu", name=f"mid{i}")
    x = b.conv2d(x, 1, 3, name="residual")
    out = b.add([y, x], name="denoised_y")
    if merge_source:
        src = b.input(h, w, 4, name="source", index=1)
        b._add(Node("merge", "Calculate", [out, src], {"expr": "merge_y_uv"}))
    return b.build()
