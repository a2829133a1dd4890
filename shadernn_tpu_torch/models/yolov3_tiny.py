"""YOLOv3-tiny detector (counterpart of shadernn_tpu/models/yolov3_tiny.py;
the reference zoo's modelzoo/Yolov3-tiny/yolov3-tiny_finetuned.json, runner
416x416).

The tiny backbone (six conv + BatchNorm + leaky stages with max pools, the
last pool stride 1), two detection heads at strides 32 and 16 joined by
an upsample + concat route, and the YOLO node, which decodes and runs NMS
on the device. Seeded weights are bit-identical to the JAX package's for
the same seed.
"""

from __future__ import annotations

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph


def _cbl(b: GraphBuilder, x: str, filters: int, k: int, name: str, stride: int = 1) -> str:
    """conv + batchnorm + leaky, the darknet building block."""
    x = b.conv2d(x, filters, k, stride=stride, use_bias=False, name=f"{name}_conv")
    return b.batchnorm(x, activation="leaky_relu", name=f"{name}_bn")


def build_yolov3_tiny(
    h: int = 416, w: int = 416, channels: int = 3, num_classes: int = 1,
    max_detections: int = 100, seed: int = 7767517,
) -> Graph:
    b = GraphBuilder("yolov3_tiny", seed=seed)
    x = b.input(h, w, channels, name="input")
    x = _cbl(b, x, 16, 3, "l0")
    x = b.maxpool(x, 2, 2, name="pool0")
    x = _cbl(b, x, 32, 3, "l1")
    x = b.maxpool(x, 2, 2, name="pool1")
    x = _cbl(b, x, 64, 3, "l2")
    x = b.maxpool(x, 2, 2, name="pool2")
    x = _cbl(b, x, 128, 3, "l3")
    x = b.maxpool(x, 2, 2, name="pool3")
    route = _cbl(b, x, 256, 3, "l4")  # the stride-16 feature, routed to head 2
    x = b.maxpool(route, 2, 2, name="pool4")
    x = _cbl(b, x, 512, 3, "l5")
    x = b.maxpool(x, 2, 1, padding="same", name="pool5")  # stride-1 pool
    x = _cbl(b, x, 1024, 3, "l6")
    neck = _cbl(b, x, 256, 1, "l7")

    no = 3 * (5 + num_classes)
    h1 = _cbl(b, neck, 512, 3, "h1")
    head1 = b.conv2d(h1, no, 1, name="head1")  # stride 32

    y = _cbl(b, neck, 128, 1, "l8")
    y = b.upsample(y, 2, "nearest", name="up")
    y = b.concat([y, route], name="route_concat")
    h2 = _cbl(b, y, 256, 3, "h2")
    head2 = b.conv2d(h2, no, 1, name="head2")  # stride 16

    b.yolo([head1, head2], num_classes=num_classes, net_hw=(h, w),
           max_detections=max_detections, name="yolo")
    # darknet's leaky alpha is 0.1, not ShaderNN's default 0.3
    for n in b.graph.nodes.values():
        if n.attr("activation") == "leaky_relu":
            n.attrs["leaky_alpha"] = 0.1
    return b.build()
