"""MobileNetV2 ImageNet classifier (counterpart of
shadernn_tpu/models/mobilenetv2.py; the reference zoo's
modelzoo/MobileNetV2/mobilenetV2.json, 224x224 input).

Standard inverted-residual architecture: expansion t, relu6 everywhere,
linear projections, residual adds on stride-1 same-width blocks. The same
seed gives weights bit-identical to the JAX package's.
"""

from __future__ import annotations

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph

# (expansion, out_channels, repeats, first_stride)
_INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _inv_res_block(b: GraphBuilder, x: str, t: int, cout: int, stride: int, name: str) -> str:
    cin = b.channels(x)
    y = x
    if t != 1:
        y = b.conv2d(y, cin * t, 1, use_bias=False, name=f"{name}_expand")
        y = b.batchnorm(y, activation="relu6", name=f"{name}_expand_bn")
    y = b.depthwise(y, 3, stride=stride, use_bias=False, name=f"{name}_dw")
    y = b.batchnorm(y, activation="relu6", name=f"{name}_dw_bn")
    y = b.conv2d(y, cout, 1, use_bias=False, name=f"{name}_project")
    y = b.batchnorm(y, name=f"{name}_project_bn")
    if stride == 1 and cin == cout:
        y = b.add([x, y], name=f"{name}_add")
    return y


def build_mobilenetv2(
    h: int = 224, w: int = 224, channels: int = 3, num_classes: int = 1000,
    width_mult: float = 1.0, seed: int = 7767517,
) -> Graph:
    def c(ch):
        # channel rounding to multiples of 8, standard for width multipliers
        return max(8, int(ch * width_mult + 4) // 8 * 8)

    b = GraphBuilder("mobilenetv2", seed=seed)
    x = b.input(h, w, channels, name="input")
    x = b.conv2d(x, c(32), 3, stride=2, use_bias=False, name="stem_conv")
    x = b.batchnorm(x, activation="relu6", name="stem_bn")
    idx = 0
    for t, ch, n, s in _INVERTED_RESIDUAL_CFG:
        for i in range(n):
            x = _inv_res_block(b, x, t, c(ch), s if i == 0 else 1, f"block{idx}")
            idx += 1
    x = b.conv2d(x, 1280, 1, use_bias=False, name="head_conv")
    x = b.batchnorm(x, activation="relu6", name="head_bn")
    x = b.adaptive_avgpool(x, 1, name="gap")
    x = b.flatten(x, name="flatten")
    b.dense(x, num_classes, activation="softmax", name="fc")
    return b.build()
