"""Fast neural style transfer, Johnson et al. (counterpart of
shadernn_tpu/models/styletransfer.py; the reference zoo's
modelzoo/StyleTransfer/{candy,mosaic,pointilism,rain-princess,udnie}-9
models, runner 224x224).

A 9x9 stem conv and two stride-2 convs, five residual blocks with
instance normalization, two stride-2 transposed convs and a 9x9 output
conv. Seeded weights are bit-identical to the JAX package's for the same
seed; the zoo's per-style names load the trained 512x512 artifacts
(models/zoo.py).
"""

from __future__ import annotations

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph


def _res_block(b: GraphBuilder, x: str, filters: int, name: str) -> str:
    y = b.conv2d(x, filters, 3, name=f"{name}_conv1")
    y = b.instancenorm(y, activation="relu", name=f"{name}_in1")
    y = b.conv2d(y, filters, 3, name=f"{name}_conv2")
    y = b.instancenorm(y, name=f"{name}_in2")
    return b.add([x, y], name=f"{name}_add")


def build_style_transfer(
    h: int = 224, w: int = 224, channels: int = 3, style: str = "candy",
    num_res_blocks: int = 5, seed: int = 7767517,
) -> Graph:
    b = GraphBuilder(f"styletransfer_{style}", seed=seed)
    x = b.input(h, w, channels, name="input")
    x = b.conv2d(x, 32, 9, name="stem_conv")
    x = b.instancenorm(x, activation="relu", name="stem_in")
    x = b.conv2d(x, 64, 3, stride=2, name="down1_conv")
    x = b.instancenorm(x, activation="relu", name="down1_in")
    x = b.conv2d(x, 128, 3, stride=2, name="down2_conv")
    x = b.instancenorm(x, activation="relu", name="down2_in")
    for i in range(num_res_blocks):
        x = _res_block(b, x, 128, f"res{i}")
    x = b.deconv(x, 64, 3, stride=2, padding="same", name="up1_conv")
    x = b.instancenorm(x, activation="relu", name="up1_in")
    x = b.deconv(x, 32, 3, stride=2, padding="same", name="up2_conv")
    x = b.instancenorm(x, activation="relu", name="up2_in")
    b.conv2d(x, channels, 9, name="head")
    return b.build()
