"""Graph intermediate representation.

TPU-native analog of the reference's `InferenceGraph`
(core/inc/snn/inferencegraph.h:30-99) and the graph-building half of
`dp.cpp`: a model is a DAG of `Node`s, topologically sorted (Kahn's
algorithm, mirroring `topologicalSort2`, core/src/ic2/dp.cpp:389-429) with
shapes propagated through per-op `Transform`s exactly as
`GenericModelLayer::getOutputDims` does (core/src/ic2/genericlayer.cpp:63-90):

    out_dim = floor(scale * in_dim + translate),  max over all inputs.

Unlike the reference (single image, no batch dim), tensors here are NHWC
with an explicit leading batch dimension; "depth/planes" in the reference
maps to the trailing C dimension (no C4 texture packing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Static shape+dtype of one value flowing through the graph.

    `shape` is (N, H, W, C) for image tensors or (N, F) after a Flatten
    (the reference marks this as the "flatten boundary", dp.cpp:356-370).
    """

    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def is_image(self) -> bool:
        return self.rank == 4

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def h(self) -> int:
        assert self.is_image
        return self.shape[1]

    @property
    def w(self) -> int:
        assert self.is_image
        return self.shape[2]

    @property
    def c(self) -> int:
        return self.shape[-1]

    def with_shape(self, shape: Sequence[int]) -> "TensorSpec":
        return TensorSpec(tuple(int(s) for s in shape), self.dtype)

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape))


@dataclasses.dataclass(frozen=True)
class Transform:
    """Spatial shape transform of one layer.

    Mirror of `InferenceGraph::Transform` (inferencegraph.h:50-68). Either a
    (scale, translate) pair per spatial dim, or a fixed output size.
    """

    scale_w: float = 1.0
    scale_h: float = 1.0
    translate_w: float = 0.0
    translate_h: float = 0.0
    fixed: Optional[Tuple[int, int]] = None  # (h, w) if the op pins its output size

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    def apply(self, h: int, w: int) -> Tuple[int, int]:
        """floor(scale*dim + translate) — float truncation as in
        genericlayer.cpp:76-77 (float assigned to uint32_t)."""
        if self.fixed is not None:
            return self.fixed
        return (
            int(self.scale_h * h + self.translate_h),
            int(self.scale_w * w + self.translate_w),
        )


@dataclasses.dataclass
class Node:
    """One layer instance.

    Analog of `InferenceGraph::Layer` (inferencegraph.h:71-99) +
    `CommonLayerDesc` (genericlayer.h:37-58), but decoupled from execution:
    a Node is pure data; the op registry supplies shape inference and the
    compute body keyed on `op`.
    """

    name: str
    op: str  # op type, same vocabulary as the model JSON "type" field
    inputs: List[str] = dataclasses.field(default_factory=list)
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    params: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    out_spec: Optional[TensorSpec] = None

    def attr(self, key: str, default=None):
        return self.attrs.get(key, default)

    def __repr__(self) -> str:  # keep params out of repr (can be huge)
        return (
            f"Node({self.name!r}, op={self.op!r}, inputs={self.inputs}, "
            f"attrs={self.attrs}, out={self.out_spec.shape if self.out_spec else None})"
        )


class GraphError(ValueError):
    pass


class Graph:
    """A static CNN inference DAG.

    Nodes are stored in insertion order; `toposort()` re-orders them with
    Kahn's algorithm (multi-input aware, like topologicalSort2 in
    dp.cpp:389-429). `infer_shapes` walks the sorted order propagating
    `TensorSpec`s via the op registry.
    """

    def __init__(self, name: str = "model"):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.input_names: List[str] = []
        self.output_names: List[str] = []
        # Model-level metadata (reference model JSON top-level properties:
        # inputRange, upscale/subpixel flags — modelparser.cpp:31-36).
        self.meta: Dict[str, object] = {}

    # -- construction ------------------------------------------------------
    def add(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise GraphError(f"duplicate node name {node.name!r}")
        for inp in node.inputs:
            if inp not in self.nodes:
                raise GraphError(
                    f"node {node.name!r} references unknown input {inp!r} "
                    "(add producers before consumers)"
                )
        self.nodes[node.name] = node
        if node.op == "InputLayer":
            self.input_names.append(node.name)
        return node

    def node(self, name: str) -> Node:
        return self.nodes[name]

    def consumers(self, name: str) -> List[Node]:
        return [n for n in self.nodes.values() if name in n.inputs]

    def finalize(self, outputs: Optional[Sequence[str]] = None) -> None:
        """Mark outputs (default: all sink nodes) and topo-sort."""
        if outputs is not None:
            missing = [o for o in outputs if o not in self.nodes]
            if missing:
                raise GraphError(f"unknown output nodes {missing}")
            self.output_names = list(outputs)
        else:
            consumed = {i for n in self.nodes.values() for i in n.inputs}
            self.output_names = [n for n in self.nodes if n not in consumed]
        self.nodes = {n.name: n for n in self.toposort()}

    # -- analysis ----------------------------------------------------------
    def toposort(self) -> List[Node]:
        """Kahn's algorithm over the DAG (dp.cpp:389-429)."""
        indeg = {name: len(set(n.inputs)) for name, n in self.nodes.items()}
        ready = [n for n in self.nodes.values() if indeg[n.name] == 0]
        order: List[Node] = []
        edges: Dict[str, List[str]] = {name: [] for name in self.nodes}
        for n in self.nodes.values():
            # dict.fromkeys = ORDER-PRESERVING dedup: set() would make the
            # edge lists, and so the emission order, vary run to run with
            # Python's hash randomization.
            for inp in dict.fromkeys(n.inputs):
                edges[inp].append(n.name)
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for succ in edges[cur.name]:
                indeg[succ] -= 1
                if indeg[succ] == 0:
                    ready.append(self.nodes[succ])
        if len(order) != len(self.nodes):
            cyclic = [n for n in self.nodes if indeg[n] > 0]
            raise GraphError(f"graph has a cycle through {cyclic}")
        return order

    def infer_shapes(self, batch_size: int = 1, dtype: str = "float32") -> None:
        """Propagate shapes through the sorted graph.

        Input nodes get (batch, H, W, C) from their attrs; every other node
        asks its op's shape function (usually Transform-based, matching
        getOutputDims semantics in genericlayer.cpp:63-90).
        """
        from shadernn_tpu_torch.ops import get_op

        for n in self.toposort():
            if n.op == "InputLayer":
                h, w, c = (int(n.attrs[k]) for k in ("height", "width", "channels"))
                n.out_spec = TensorSpec((batch_size, h, w, c), dtype)
                continue
            in_specs = [self.nodes[i].out_spec for i in n.inputs]
            if any(s is None for s in in_specs):
                raise GraphError(f"input of {n.name!r} has no spec; not topo-sorted?")
            n.out_spec = get_op(n.op).infer(n, in_specs)

    def transform_output_dims(
        self, t: Transform, in_specs: Sequence[TensorSpec]
    ) -> Tuple[int, int]:
        return transform_output_dims(t, in_specs)

    # -- reporting ---------------------------------------------------------
    def summary(self) -> str:
        """Model table like the one dp.cpp prints at graph build."""
        lines = [f"=== {self.name} ({len(self.nodes)} layers) ==="]
        for i, n in enumerate(self.nodes.values()):
            shape = "?" if n.out_spec is None else "x".join(map(str, n.out_spec.shape))
            nparam = sum(int(np.prod(p.shape)) for p in n.params.values())
            lines.append(
                f"  [{i:02d}] {n.name:<28} {n.op:<18} out={shape:<20} "
                f"in={','.join(n.inputs) or '-'}{f' params={nparam}' if nparam else ''}"
            )
        return "\n".join(lines)

    @property
    def num_params(self) -> int:
        return sum(
            int(np.prod(p.shape)) for n in self.nodes.values() for p in n.params.values()
        )


def transform_output_dims(t: Transform, in_specs: Sequence[TensorSpec]) -> Tuple[int, int]:
    """Accumulate one Transform over multiple inputs: per-dim max, as in
    genericlayer.cpp:68-78."""
    best_h = best_w = 0
    for s in in_specs:
        if not s.is_image:
            continue
        h, w = t.apply(s.h, s.w)
        best_h, best_w = max(best_h, h), max(best_w, w)
    return best_h, best_w
