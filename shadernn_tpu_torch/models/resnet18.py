"""ResNet18, CIFAR-10 variant (counterpart of
shadernn_tpu/models/resnet18.py; the reference zoo's
modelzoo/Resnet18/resnet18_cifar10.json, 32x32 input).

CIFAR-style stem (3x3 conv, no initial maxpool), 4 stages x 2 basic
blocks (64/128/256/512), global average pool, fc10. The same seed gives
weights bit-identical to the JAX package's.
"""

from __future__ import annotations

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph


def _basic_block(b: GraphBuilder, x: str, filters: int, stride: int, name: str) -> str:
    y = b.conv2d(x, filters, 3, stride=stride, use_bias=False, name=f"{name}_conv1")
    y = b.batchnorm(y, activation="relu", name=f"{name}_bn1")
    y = b.conv2d(y, filters, 3, use_bias=False, name=f"{name}_conv2")
    y = b.batchnorm(y, name=f"{name}_bn2")
    if stride != 1 or b.channels(x) != filters:
        sc = b.conv2d(x, filters, 1, stride=stride, use_bias=False, name=f"{name}_down")
        sc = b.batchnorm(sc, name=f"{name}_downbn")
    else:
        sc = x
    return b.add([y, sc], activation="relu", name=f"{name}_out")


def build_resnet18_cifar10(
    h: int = 32, w: int = 32, channels: int = 3, num_classes: int = 10,
    seed: int = 7767517, base_filters: int = 64,
) -> Graph:
    """base_filters scales the stage widths (64/128/256/512 at the default);
    the trained artifact (zoo.RESNET18_TRAINED) uses 16 with the same
    topology."""
    f = base_filters
    b = GraphBuilder("resnet18_cifar10", seed=seed)
    x = b.input(h, w, channels, name="input")
    x = b.conv2d(x, f, 3, use_bias=False, name="stem_conv")
    x = b.batchnorm(x, activation="relu", name="stem_bn")
    for stage, (filters, stride) in enumerate([(f, 1), (2 * f, 2), (4 * f, 2), (8 * f, 2)]):
        for blk in range(2):
            x = _basic_block(b, x, filters, stride if blk == 0 else 1, f"s{stage}b{blk}")
    x = b.adaptive_avgpool(x, 1, name="gap")
    x = b.flatten(x, name="flatten")
    b.dense(x, num_classes, activation="softmax", name="fc")
    return b.build()
