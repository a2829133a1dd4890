"""Fused stride-1 conv chain: the hand-written CUDA kernel
(csrc/conv_chain.cu), its wrapper, its plan and its plain PyTorch version.

One kernel ports the two TPU chain kernels of the JAX package, which
compute the same function in two TPU layouts:
`shadernn_tpu/kernels/chain_packed_pallas.py` (`_packed_kernel`, entry
point `fused_conv_chain_packed`) and `shadernn_tpu/kernels/chain_pallas.py`
(`_chain_kernel`, entry point `fused_conv_chain`). Both entry points are
kept under their JAX names and launch the one kernel.

The function, at the tensor boundary: NHWC input (float32 or bfloat16,
cast to the compute dtype), per layer an HWIO weight in the compute dtype,
a float32 accumulation and `act(acc * scale + offset)` in float32, each
intermediate zero outside the image and rounded to the compute dtype.
Tails: "none" -> (N,H,W,o); "c1" (o=1) -> (N,H,W,1); "d2s2" (o=4) ->
(N,2H,2W,1) through depth_to_space(2) in TF channel order.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
(tests) it runs `conv_chain_reference`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import conv2d_nhwc_f32, epilogue_scale_offset
from shadernn_tpu_torch.ops.shape_ops import depth_to_space

# Final-output pixels per CTA (rows, columns) and the kernel's limits; they
# must agree with csrc/conv_chain.cu.
TILE_H, TILE_W = 16, 32
MAX_LAYERS = 8
MAX_K = 9
MAX_O = 32
MAX_SMEM_BYTES = 232448  # 227 KB, what one block may use on Hopper
ACT_CODES = {
    "linear": 0, "": 0, "none": 0, "identity": 0,
    "relu": 1, "relu6": 2,
    "leaky_relu": 3, "leakyrelu": 3, "leaky relu": 3,
    "tanh": 4, "sigmoid": 5, "silu": 6, "swish": 6, "gelu": 7,
}
TAILS = {"none": 0, "c1": 1, "d2s2": 2}

# Kernel launches per entry point since import (a caller may reset them).
launches = {"fused_conv_chain_packed": 0, "fused_conv_chain": 0}


@dataclasses.dataclass(frozen=True)
class ChainLayerSpec:
    """Static description of one conv of the chain."""

    k: int
    c: int  # input channels
    o: int  # output channels
    pt: int
    pb: int
    pl: int
    pr: int
    activation: str
    alpha: float


def _round4(v: int) -> int:
    return (v + 3) & ~3


def smem_bytes(specs: Sequence[ChainLayerSpec], tile_h: int = TILE_H,
               tile_w: int = TILE_W) -> int:
    """Dynamic shared memory one CTA needs (the layout of conv_chain.cu):
    staged weights and scale/offset, then two ping-pong region buffers."""
    n = len(specs)
    a = [0] * (n + 1)
    b = [0] * (n + 1)
    lft = [0] * (n + 1)
    rgt = [0] * (n + 1)
    for l in range(n - 1, -1, -1):
        s = specs[l]
        a[l] = a[l + 1] + s.pt
        b[l] = b[l + 1] + s.k - 1 - s.pt
        lft[l] = lft[l + 1] + s.pl
        rgt[l] = rgt[l + 1] + s.k - 1 - s.pl
    floats = 0
    buf = [0, 0]
    for l, s in enumerate(specs):
        ch = 8 if s.o > 4 else (4 if s.o > 1 else 1)
        o_pad = -(-s.o // ch) * ch
        floats += _round4(o_pad * s.k * s.k * s.c) + _round4(2 * o_pad)
        region = s.c * (tile_h + a[l] + b[l]) * (tile_w + lft[l] + rgt[l])
        buf[l % 2] = max(buf[l % 2], region)
    return 4 * (floats + _round4(buf[0]) + _round4(buf[1]))


def build_chain_specs(
    views,
    in_channels: int,
    act_dtype: torch.dtype,
    act_override: Optional[Tuple[str, float]] = None,
    tail: str = "none",
) -> Optional[List[ChainLayerSpec]]:
    """Plan a run of Conv2D nodes for the kernel, or None where the kernel
    cannot take it: stride != 1, k > 9, o > 32, int8 weight storage (the
    JAX kernel's int8 `in_q` dots come with the INT8 slice), an activation
    outside the kernel's epilogue, more than 8 layers, or shared memory
    over 227 KB. `act_override` = (name, alpha) replaces the last layer's
    activation with a folded one (e.g. ESPCN's post-subpixel tanh)."""
    if act_dtype not in (torch.float32, torch.bfloat16) or tail not in TAILS:
        return None
    if not 1 <= len(views) <= MAX_LAYERS:
        return None
    specs: List[ChainLayerSpec] = []
    c = in_channels
    for idx, node in enumerate(views):
        if int(node.attr("stride", 1)) != 1 or "weight_q" in node.params:
            return None
        k = int(node.attr("kernel_size"))
        o = int(node.attr("out_channels"))
        if k > MAX_K or o > MAX_O:
            return None
        act = str(node.attr("activation", "linear"))
        alpha = float(node.attr("leaky_alpha", 0.3))
        if act_override is not None and idx == len(views) - 1:
            act, alpha = act_override
        if act.lower() not in ACT_CODES:
            return None
        pt, pb, pl, pr = padding_offsets(node.attr("padding", "same"), k)
        specs.append(ChainLayerSpec(k, c, o, pt, pb, pl, pr, act.lower(), alpha))
        c = o
    if (tail == "c1" and c != 1) or (tail == "d2s2" and c != 4):
        return None
    if smem_bytes(specs) > MAX_SMEM_BYTES:
        return None
    return specs


def chain_operands(views, compute_dtype: torch.dtype) -> List[dict]:
    """Per-layer kernel operands: weight "w" (HWIO, compute dtype) and the
    folded float32 "scale"/"offset" (bias, BatchNorm)."""
    out = []
    for node in views:
        scale, offset = epilogue_scale_offset(node)
        w = torch.as_tensor(node.params["weight"]).to(compute_dtype)
        out.append({"w": w, "scale": scale, "offset": offset})
    return out


def _out_hw(h: int, w: int, specs: Sequence[ChainLayerSpec]) -> Tuple[int, int]:
    for s in specs:
        h = h + s.pt + s.pb - s.k + 1
        w = w + s.pl + s.pr - s.k + 1
    return h, w


def _compute_dtype(x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    if compute_dtype is not None:
        return compute_dtype
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def conv_chain_reference(
    x: torch.Tensor,
    layer_params: List[dict],
    specs: Sequence[ChainLayerSpec],
    tail: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, layer by layer over the whole
    image. Zero-padding each layer's input (inside conv2d_nhwc_f32) is the
    kernel's mask of its halo outside the image."""
    dt = _compute_dtype(x, compute_dtype)
    v = x.to(dt)
    for p, s in zip(layer_params, specs):
        acc = conv2d_nhwc_f32(v, p["w"].to(dt), (s.pt, s.pb, s.pl, s.pr))
        y = acc * p["scale"].float() + p["offset"].float()
        v = apply_activation(y, s.activation, s.alpha).to(dt)
    if tail == "d2s2":
        v = depth_to_space(v, 2)
    return v.contiguous()


def _launch(x, layer_params, specs, tail, dt, entry) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv chain input must be float32 or bfloat16, got {x.dtype}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv chain compute dtype must be float32 or bfloat16, got {dt}")
    if x.dim() != 4 or x.shape[-1] != specs[0].c:
        raise ValueError(f"conv chain input must be NHWC with C={specs[0].c}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("conv chain input must be contiguous")
    if len(layer_params) != len(specs):
        raise ValueError("one operand dict per layer spec")
    flat = []
    for p, s in zip(layer_params, specs):
        if tuple(p["w"].shape) != (s.k, s.k, s.c, s.o):
            raise ValueError(f"weight shape {tuple(p['w'].shape)} != {(s.k, s.k, s.c, s.o)}")
        for t in (p["w"], p["scale"], p["offset"]):
            if t.device != x.device:
                raise ValueError(f"operand on {t.device}, input on {x.device}")
        flat += [p["w"].to(dt).float().reshape(-1), p["scale"].float().reshape(-1),
                 p["offset"].float().reshape(-1)]
    params = torch.cat(flat).contiguous()
    n, h, w, _ = x.shape
    ho, wo = _out_hw(h, w, specs)
    shape = (n, 2 * ho, 2 * wo, 1) if tail == "d2s2" else (n, ho, wo, specs[-1].o)
    y = torch.empty(shape, dtype=dt, device=x.device)
    if n == 0:
        return y
    lib = kernel_lib()
    ints = (ctypes.c_int * (8 * len(specs)))(*[
        v for s in specs
        for v in (s.k, s.c, s.o, s.pt, s.pb, s.pl, s.pr, ACT_CODES[s.activation])
    ])
    alphas = (ctypes.c_float * len(specs))(*[s.alpha for s in specs])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.snn_conv_chain(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
        params.data_ptr(), ints, alphas, len(specs), n, h, w,
        int(dt == torch.bfloat16), TAILS[tail], TILE_H, TILE_W, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv_chain launch failed ({rc}): {lib.snn_error_string(rc).decode()}"
        )
    launches[entry] += 1
    return y


def _conv_chain(x, layer_params, specs, tail, compute_dtype, entry):
    if tail not in TAILS:
        raise ValueError(f"tail {tail!r} not in {tuple(TAILS)}")
    dt = _compute_dtype(x, compute_dtype)
    if x.device.type == "cuda":
        return _launch(x, layer_params, specs, tail, dt, entry)
    if x.device.type == "cpu":
        return conv_chain_reference(x, layer_params, specs, tail, dt)
    raise ValueError(f"no conv chain for device {x.device}")


def fused_conv_chain_packed(
    x: torch.Tensor,
    layer_params: List[dict],
    specs: Sequence[ChainLayerSpec],
    *,
    tail: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Counterpart of chain_packed_pallas.fused_conv_chain_packed: the CUDA
    kernel for a CUDA tensor (no fallback), `conv_chain_reference` for a
    CPU tensor."""
    return _conv_chain(x, layer_params, specs, tail, compute_dtype,
                       "fused_conv_chain_packed")


def fused_conv_chain(
    x: torch.Tensor,
    layer_params: List[dict],
    specs: Sequence[ChainLayerSpec],
    *,
    tail: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Counterpart of chain_pallas.fused_conv_chain: the same kernel as
    `fused_conv_chain_packed`, counted under its own name."""
    return _conv_chain(x, layer_params, specs, tail, compute_dtype,
                       "fused_conv_chain")
