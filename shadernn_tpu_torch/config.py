"""Engine-level configuration of the PyTorch/CUDA port.

Mirrors `shadernn_tpu/config.py`: `Precision` picks the activation dtype,
`BackendKind` picks, per layer, between plain PyTorch ops (TORCH, the
analog of the JAX package's XLA path) and the hand-written CUDA kernels
(KERNEL, the analog of its Pallas path), and `EngineOptions` carries the
creation-time options that the compile step reads. Sharding, layout and
buffer-donation options belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Precision(enum.Enum):
    """Compute/storage precision policy (FP32 -> float32, BF16 -> bfloat16)."""

    FP32 = "fp32"
    BF16 = "bf16"
    INT8 = "int8"

    @property
    def activation_dtype(self) -> torch.dtype:
        if self is Precision.INT8:
            raise NotImplementedError("INT8 comes in a later slice")
        return torch.float32 if self is Precision.FP32 else torch.bfloat16


class BackendKind(enum.Enum):
    """Which compute path implements a layer."""

    TORCH = "torch"  # plain PyTorch ops (cuDNN on the card)
    KERNEL = "kernel"  # hand-written CUDA kernel (shadernn_tpu_torch/csrc)
    AUTO = "auto"  # per layer: the kernel where the chain gate admits it


CHAIN_FORMATS = ("auto", "packed", "im2col")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Creation-time options for `Engine`.

    `device` names where the engine runs: "cuda" (the default) needs a
    CUDA device and `Engine.from_graph` raises `RuntimeError` without one;
    "cpu" runs every kernel's plain PyTorch version and is meant for tests.
    """

    precision: Precision = Precision.FP32
    backend: BackendKind = BackendKind.AUTO
    # Per-layer backend override: node name -> BackendKind.
    backend_overrides: Optional[dict] = None
    batch_size: int = 1
    # Which entry point a planned conv chain goes through: "auto"/"packed"
    # take `fused_conv_chain_packed` for c1/d2s2 tails and `fused_conv_chain`
    # otherwise; "im2col" always takes `fused_conv_chain`. On Hopper both
    # entry points launch the same kernel (kernels/chain.py).
    chain_format: str = "auto"
    # Fold BatchNorm into the preceding conv weights at load.
    fold_batchnorm: bool = True
    # Return every layer's output under "__dumps__" (disables chain fusion
    # so intermediates are observable).
    dump_outputs: bool = False
    # "float32" (default) or "activation" (keep the compute dtype).
    output_dtype: Optional[str] = "float32"
    # Benchmark bookkeeping: leading loops excluded from the stats.
    warmup_loops: int = 5
    device: str = "cuda"

    def __post_init__(self):
        self.precision.activation_dtype  # raises for INT8
        if self.chain_format not in CHAIN_FORMATS:
            raise ValueError(
                f"chain_format {self.chain_format!r} not in {CHAIN_FORMATS}"
            )

    def backend_for(self, node_name: str) -> BackendKind:
        if self.backend_overrides and node_name in self.backend_overrides:
            return self.backend_overrides[node_name]
        return self.backend
