"""Op registry: op-type string -> OpDef.

The op-type vocabulary matches the model-JSON "type" field (and the JAX
package's registry, shadernn_tpu/ops/registry.py) so zoo artifacts parse
directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

from shadernn_tpu_torch.graph.ir import Node, TensorSpec


@dataclasses.dataclass
class RunCtx:
    """Per-compilation context handed to op bodies."""

    precision: object = None  # shadernn_tpu_torch.config.Precision
    backend: object = None  # BackendKind for this node


class OpDef:
    """One operator definition.

    Subclasses implement:
      infer(node, in_specs) -> TensorSpec   (shape propagation)
      run(node, xs, ctx) -> torch.Tensor    (compute body; NHWC tensors in
                                             node.inputs order)
    """

    op_name: str = ""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        raise NotImplementedError

    def run(self, node: Node, xs: List, ctx: RunCtx):
        raise NotImplementedError


_REGISTRY: Dict[str, OpDef] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, *aliases: str) -> Callable:
    """Class decorator: instantiate and register under `name` (+aliases)."""

    def deco(cls):
        cls.op_name = name
        _REGISTRY[name] = cls()
        for a in aliases:
            _ALIASES[a] = name
        return cls

    return deco


def get_op(name: str) -> OpDef:
    canonical = _ALIASES.get(name, name)
    if canonical not in _REGISTRY:
        raise KeyError(
            f"unknown op type {name!r}; registered: {sorted(_REGISTRY)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return _REGISTRY[canonical]
