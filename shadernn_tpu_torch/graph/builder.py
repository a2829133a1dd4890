"""Programmatic graph construction (counterpart of
shadernn_tpu/graph/builder.py, for the ops this package registers).

Weight placeholders are drawn exactly as the JAX package draws them
(numpy `default_rng(seed)`, `_rand` below), so one seed gives bit-identical
weights in both packages. Conv weights are HWIO.
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

    def add(self, xs: Sequence[str], activation: str = "linear", name=None) -> str:
        return self._add(
            Node(self._name("add", name), "Add", list(xs), {"activation": activation}))

    def activation(self, x: str, kind: str, alpha: float = 0.3, name=None) -> str:
        return self._add(
            Node(self._name("act", name), "Activation", [x],
                 {"activation": kind, "leaky_alpha": alpha}))

    def pad(self, x: str, t: int, b: int, l: int, r: int, mode="constant", value=0.0, name=None) -> str:
        return self._add(
            Node(self._name("pad", name), "ZeroPadding2D", [x],
                 {"pad_top": t, "pad_bottom": b, "pad_left": l, "pad_right": r,
                  "mode": mode, "value": value}))

    def subpixel(self, x: str, scale: int = 2, name=None) -> str:
        return self._add(Node(self._name("subpixel", name), "Subpixel", [x], {"scale": scale}))

    # -- finish ------------------------------------------------------------
    def build(self, outputs: Optional[Sequence[str]] = None, batch_size: int = 1) -> Graph:
        self.graph.finalize(outputs)
        self.graph.infer_shapes(batch_size=batch_size)
        return self.graph
