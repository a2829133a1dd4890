"""Engine-level configuration of the PyTorch/CUDA port.

Mirrors `shadernn_tpu/config.py`: `Precision` picks the activation dtype,
`BackendKind` picks, per layer, between plain PyTorch ops (TORCH, the
analog of the JAX package's XLA path) and the hand-written CUDA kernels
(KERNEL, the analog of its Pallas path), `ShardingOptions` lays a model
over a (data, model, spatial) mesh of devices (parallel/), and
`EngineOptions` carries the creation-time options that the compile step
reads. The JAX package's XLA-only layout and buffer-donation options have
no counterpart here (`EngineOptions` says why).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Precision(enum.Enum):
    """Compute/storage precision policy (FP32 -> float32 activations; BF16
    and INT8 -> bfloat16 activations, INT8 with int8 weights and
    per-output-channel scales, quant/quantize.py)."""

    FP32 = "fp32"
    BF16 = "bf16"
    INT8 = "int8"

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.float32 if self is Precision.FP32 else torch.bfloat16

    @property
    def is_quantized(self) -> bool:
        return self is Precision.INT8


class BackendKind(enum.Enum):
    """Which compute path implements a layer."""

    TORCH = "torch"  # plain PyTorch ops (cuDNN on the card)
    KERNEL = "kernel"  # hand-written CUDA kernel (shadernn_tpu_torch/csrc)
    AUTO = "auto"  # per layer: the kernel where the chain gate admits it


CHAIN_FORMATS = ("auto", "packed", "im2col")
CHAIN_A8 = ("auto", "off")
SPMD_MODES = ("shard_map", "gspmd")


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    """How to lay the model out over a device mesh (parallel/mesh.py):
    `data` for batch/frame parallelism, `model` for channel (tensor)
    parallelism and `spatial` for H partitioning with halo exchange. Each
    count is the number of ways that axis is cut; 1 = off."""

    data_axis: str = "data"
    model_axis: str = "model"
    spatial_axis: str = "spatial"
    data: int = 1
    model: int = 1
    spatial: int = 1

    @property
    def total_devices(self) -> int:
        return self.data * self.model * self.spatial

    @property
    def is_sharded(self) -> bool:
        return self.total_devices > 1


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Creation-time options for `Engine`.

    `device` names where the engine runs: "cuda" (the default) needs a
    CUDA device and `Engine.from_graph` raises `RuntimeError` without one;
    "cpu" runs every kernel's plain PyTorch version and is meant for tests.

    The JAX package's `auto_output_layout`, `auto_input_layout` and
    `donate_input` have no counterpart. The first two let XLA choose the
    device layout of a jitted step's outputs and inputs, and the third lets
    it reuse the input buffer for an output; an eager PyTorch step has no
    compiler to hand either choice to (tensors here are NHWC, contiguous,
    as the kernels take them), and the caching allocator reuses a freed
    input's memory without being told.
    """

    precision: Precision = Precision.FP32
    backend: BackendKind = BackendKind.AUTO
    # Per-layer backend override: node name -> BackendKind.
    backend_overrides: Optional[dict] = None
    batch_size: int = 1
    sharding: ShardingOptions = dataclasses.field(default_factory=ShardingOptions)
    # How a sharded graph runs (parallel/sharding.py): "shard_map", the
    # explicit SPMD executor with the kernels kept per shard; or "gspmd",
    # the same executor under the two restrictions XLA's auto-partitioner
    # puts on the JAX package's result (TORCH on every shard, no TP under
    # SP).
    spmd_mode: str = "shard_map"
    # Which entry point a planned conv chain goes through: "auto"/"packed"
    # take `fused_conv_chain_packed` for c1/d2s2 tails and `fused_conv_chain`
    # otherwise; "im2col" always takes `fused_conv_chain`. On Hopper both
    # entry points launch the same kernel (kernels/chain.py).
    chain_format: str = "auto"
    # Under INT8: "auto" runs a packed chain layer's dot int8 x int8 where
    # its input range is bounded (the JAX package's a8 rule,
    # kernels/chain.py a8_scales); "off" keeps every chain dot on bf16.
    chain_a8: str = "auto"
    # Fold BatchNorm into the preceding conv weights at load.
    fold_batchnorm: bool = True
    # Return every layer's output under "__dumps__" (disables chain fusion
    # so intermediates are observable).
    dump_outputs: bool = False
    # Where tools/dump_reader.py's dump_layers writes them by default.
    dump_dir: str = "layer_dumps"
    # "float32" (default) or "activation" (keep the compute dtype).
    output_dtype: Optional[str] = "float32"
    # Benchmark bookkeeping: leading loops excluded from the stats.
    warmup_loops: int = 5
    device: str = "cuda"

    def __post_init__(self):
        if self.chain_format not in CHAIN_FORMATS:
            raise ValueError(
                f"chain_format {self.chain_format!r} not in {CHAIN_FORMATS}"
            )
        if self.chain_a8 not in CHAIN_A8:
            raise ValueError(f"chain_a8 {self.chain_a8!r} not in {CHAIN_A8}")
        if self.spmd_mode not in SPMD_MODES:
            raise ValueError(f"spmd_mode {self.spmd_mode!r} not in {SPMD_MODES}")

    def backend_for(self, node_name: str) -> BackendKind:
        if self.backend_overrides and node_name in self.backend_overrides:
            return self.backend_overrides[node_name]
        return self.backend
