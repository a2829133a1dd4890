"""AI pre-denoiser (counterpart of shadernn_tpu/models/aidenoise.py; the
reference's runAIDenoiser runner: 1080x1920 luma, 1/255 normalization).

The in-repo trained artifact (zoo.AIDENOISE_TRAINED) is what the default
(features, depth) = (16, 3) loads, retargeted to the frame size (it is
fully convolutional); other widths build the same architecture with
seeded weights: a stride-2 conv encoder, `depth` convs at quarter
resolution, a 4-channel conv into a 2x subpixel decoder and a global
residual add.
"""

from __future__ import annotations

import os

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph


def build_aidenoise(
    h: int = 1080, w: int = 1920, channels: int = 1, features: int = 16,
    depth: int = 3, seed: int = 7767517,
) -> Graph:
    from shadernn_tpu_torch.models.zoo import AIDENOISE_TRAINED

    if channels != 1:
        raise ValueError("AIDenoise runs on the luma plane (1 channel)")
    if os.path.exists(AIDENOISE_TRAINED) and (features, depth) == (16, 3):
        from shadernn_tpu_torch.graph.parser import parse_model_file

        return parse_model_file(AIDENOISE_TRAINED, input_hw=(h, w))
    b = GraphBuilder("eff_predenoise", seed=seed)
    y = b.input(h, w, 1, name="input")
    x = b.conv2d(y, features, 3, stride=2, activation="relu", name="down")
    for i in range(depth):
        x = b.conv2d(x, features, 3, activation="relu", name=f"core{i}")
    x = b.conv2d(x, 4, 3, name="expand")  # 4 = 2x2 subpixel to 1 channel
    x = b.subpixel(x, scale=2, name="up")
    b.add([y, x], name="denoised")
    return b.build()
