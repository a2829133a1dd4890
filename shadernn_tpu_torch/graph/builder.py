"""Programmatic graph construction (counterpart of
shadernn_tpu/graph/builder.py, for the ops this package registers).

Weight placeholders are drawn exactly as the JAX package draws them
(numpy `default_rng(seed)`, `_rand` below), so one seed gives bit-identical
weights in both packages. Conv and deconv weights are HWIO, depthwise
HW1(C*m), dense (in, units).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from shadernn_tpu_torch.graph.ir import Graph, Node, TensorSpec


class GraphBuilder:
    """Builds a Graph, propagating shapes eagerly (each layer's out_spec is
    known at build time with a placeholder batch of 1; `build()` re-infers
    with the real batch size)."""

    def __init__(self, name: str = "model", seed: int = 7767517):
        self.graph = Graph(name)
        self.rng = np.random.default_rng(seed)
        self._counter = 0

    def _add(self, node: Node) -> str:
        """Add + eager shape inference so later layers can query shapes."""
        from shadernn_tpu_torch.ops import get_op

        self.graph.add(node)
        if node.op == "InputLayer":
            h, w, c = (int(node.attrs[k]) for k in ("height", "width", "channels"))
            node.out_spec = TensorSpec((1, h, w, c))
        else:
            in_specs = [self.graph.node(i).out_spec for i in node.inputs]
            node.out_spec = get_op(node.op).infer(node, in_specs)
        return node.name

    def spec(self, x: str) -> TensorSpec:
        return self.graph.node(x).out_spec

    def channels(self, x: str) -> int:
        return self.graph.node(x).out_spec.c

    def _name(self, prefix: str, name: Optional[str]) -> str:
        if name:
            return name
        self._counter += 1
        return f"{prefix}_{self._counter}"

    def _rand(self, *shape, scale: float = None) -> np.ndarray:
        fan_in = int(np.prod(shape[:-1])) or 1
        s = scale if scale is not None else (1.0 / np.sqrt(fan_in))
        return self.rng.normal(0.0, s, size=shape).astype(np.float32)

    # -- layers ------------------------------------------------------------
    def input(self, h: int, w: int, c: int, name: str = "input", index: int = 0) -> str:
        return self._add(
            Node(name, "InputLayer", [], {"height": h, "width": w, "channels": c, "index": index})
        )

    def conv2d(
        self,
        x: str,
        filters: int,
        kernel_size: int,
        stride: int = 1,
        padding: Union[str, int, Sequence[int]] = "same",
        activation: str = "linear",
        use_bias: bool = True,
        leaky_alpha: float = 0.3,
        weight: Optional[np.ndarray] = None,
        bias: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> str:
        name = self._name("conv", name)
        cin = self.channels(x)
        params = {
            "weight": weight
            if weight is not None
            else self._rand(kernel_size, kernel_size, cin, filters)
        }
        if use_bias:
            params["bias"] = bias if bias is not None else np.zeros(filters, np.float32)
        return self._add(
            Node(
                name,
                "Conv2D",
                [x],
                {
                    "kernel_size": kernel_size,
                    "stride": stride,
                    "padding": padding,
                    "activation": activation,
                    "use_bias": use_bias,
                    "leaky_alpha": leaky_alpha,
                    "out_channels": filters,
                },
                params,
            )
        )

    def depthwise(
        self,
        x: str,
        kernel_size: int,
        stride: int = 1,
        padding="same",
        multiplier: int = 1,
        activation: str = "linear",
        use_bias: bool = True,
        weight: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> str:
        name = self._name("dwconv", name)
        cin = self.channels(x)
        params = {
            "weight": weight
            if weight is not None
            else self._rand(kernel_size, kernel_size, 1, cin * multiplier)
        }
        if use_bias:
            params["bias"] = np.zeros(cin * multiplier, np.float32)
        return self._add(
            Node(
                name,
                "SeparableConv2D",
                [x],
                {
                    "kernel_size": kernel_size,
                    "stride": stride,
                    "padding": padding,
                    "multiplier": multiplier,
                    "activation": activation,
                    "use_bias": use_bias,
                },
                params,
            )
        )

    def deconv(
        self,
        x: str,
        filters: int,
        kernel_size: int,
        stride: int = 1,
        padding="same",
        activation: str = "linear",
        use_bias: bool = True,
        weight: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> str:
        name = self._name("deconv", name)
        cin = self.channels(x)
        params = {
            "weight": weight
            if weight is not None
            else self._rand(kernel_size, kernel_size, cin, filters)
        }
        if use_bias:
            params["bias"] = np.zeros(filters, np.float32)
        return self._add(
            Node(
                name,
                "Conv2DTranspose",
                [x],
                {
                    "kernel_size": kernel_size,
                    "stride": stride,
                    "padding": padding,
                    "activation": activation,
                    "use_bias": use_bias,
                    "out_channels": filters,
                },
                params,
            )
        )

    def maxpool(self, x: str, pool: int, stride: Optional[int] = None, padding="valid", name=None) -> str:
        return self._add(
            Node(self._name("maxpool", name), "MaxPooling2D", [x],
                 {"kernel_size": pool, "stride": stride or pool, "padding": padding}))

    def avgpool(self, x: str, pool: int, stride: Optional[int] = None, padding="valid", name=None) -> str:
        return self._add(
            Node(self._name("avgpool", name), "AveragePooling2D", [x],
                 {"kernel_size": pool, "stride": stride or pool, "padding": padding}))

    def adaptive_avgpool(self, x: str, output_size: int = 1, name=None) -> str:
        return self._add(
            Node(self._name("adpool", name), "AdaptiveAvgPool2d", [x],
                 {"output_height": output_size, "output_width": output_size}))

    def batchnorm(self, x: str, gamma=None, beta=None, mean=None, variance=None,
                  epsilon: float = 1e-3, activation: str = "linear", name=None) -> str:
        c = self.channels(x)
        params = {
            "gamma": np.ones(c, np.float32) if gamma is None else np.asarray(gamma, np.float32),
            "beta": np.zeros(c, np.float32) if beta is None else np.asarray(beta, np.float32),
            "mean": np.zeros(c, np.float32) if mean is None else np.asarray(mean, np.float32),
            "variance": np.ones(c, np.float32) if variance is None else np.asarray(variance, np.float32),
        }
        return self._add(
            Node(self._name("bn", name), "BatchNormalization", [x],
                 {"epsilon": epsilon, "activation": activation}, params))

    def instancenorm(self, x: str, gamma=None, beta=None, epsilon: float = 1e-5,
                     activation: str = "linear", name=None) -> str:
        c = self.channels(x)
        params = {
            "gamma": np.ones(c, np.float32) if gamma is None else np.asarray(gamma, np.float32),
            "beta": np.zeros(c, np.float32) if beta is None else np.asarray(beta, np.float32),
        }
        return self._add(
            Node(self._name("in", name), "InstanceNormalization", [x],
                 {"epsilon": epsilon, "activation": activation}, params))

    def add(self, xs: Sequence[str], activation: str = "linear", name=None) -> str:
        return self._add(
            Node(self._name("add", name), "Add", list(xs), {"activation": activation}))

    def concat(self, xs: Sequence[str], name=None) -> str:
        return self._add(Node(self._name("concat", name), "Concatenate", list(xs), {}))

    def activation(self, x: str, kind: str, alpha: float = 0.3, name=None) -> str:
        return self._add(
            Node(self._name("act", name), "Activation", [x],
                 {"activation": kind, "leaky_alpha": alpha}))

    def unary(self, x: str, op_type: str, op_value: float = 1.0, name=None) -> str:
        return self._add(
            Node(self._name("unary", name), "Unary", [x],
                 {"op_type": op_type, "op_value": op_value}))

    def upsample(self, x: str, scale: int = 2, interpolation: str = "nearest", name=None) -> str:
        return self._add(
            Node(self._name("upsample", name), "UpSampling2D", [x],
                 {"scale": scale, "interpolation": interpolation}))

    def pad(self, x: str, t: int, b: int, l: int, r: int, mode="constant", value=0.0, name=None) -> str:
        return self._add(
            Node(self._name("pad", name), "ZeroPadding2D", [x],
                 {"pad_top": t, "pad_bottom": b, "pad_left": l, "pad_right": r,
                  "mode": mode, "value": value}))

    def subpixel(self, x: str, scale: int = 2, name=None) -> str:
        return self._add(Node(self._name("subpixel", name), "Subpixel", [x], {"scale": scale}))

    def flatten(self, x: str, name=None) -> str:
        return self._add(Node(self._name("flatten", name), "Flatten", [x], {}))

    def dense(self, x: str, units: int, activation: str = "linear", use_bias: bool = True,
              weight=None, bias=None, name=None) -> str:
        name = self._name("dense", name)
        if weight is None:
            in_features = int(np.prod(self.spec(x).shape[1:]))
            weight = self._rand(in_features, units)
        params = {"weight": weight}
        if use_bias:
            params["bias"] = np.zeros(units, np.float32) if bias is None else bias
        return self._add(
            Node(name, "Dense", [x],
                 {"units": units, "activation": activation, "use_bias": use_bias}, params))

    def yolo(self, xs: Sequence[str], num_classes: int = 1, net_hw=(416, 416),
             max_detections: int = 100, anchors=None, masks=None, name=None) -> str:
        from shadernn_tpu_torch.ops.yolo import YOLOV3_TINY_ANCHORS, YOLOV3_TINY_MASKS

        return self._add(
            Node(self._name("yolo", name), "YOLO", list(xs),
                 {"num_classes": num_classes, "net_hw": net_hw,
                  "max_detections": max_detections,
                  "anchors": anchors or YOLOV3_TINY_ANCHORS,
                  "masks": masks or YOLOV3_TINY_MASKS}))

    # -- finish ------------------------------------------------------------
    def build(self, outputs: Optional[Sequence[str]] = None, batch_size: int = 1) -> Graph:
        self.graph.finalize(outputs)
        self.graph.infer_shapes(batch_size=batch_size)
        return self.graph
