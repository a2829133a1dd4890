"""Single stride-1 convolution: the hand-written CUDA kernel
(csrc/conv_single.cu), its wrapper and its plain PyTorch version.

The kernel ports `_haloed_kernel` of the JAX package
(`shadernn_tpu/kernels/conv_pallas.py`, entry point `fused_conv2d_haloed`,
reached through `shadernn_tpu/ops/conv.py` `conv_run_pallas_chain`). The
entry point keeps its JAX name. The haloed NHCW layout and the C=1 row
packing are TPU layouts and are not carried over: the function is taken
at the tensor boundary, NHWC in and NHWC out.

The function: x (N,H,W,C) cast to the compute dtype, an HWIO weight
(kh,kw,C,O), rectangular kernels allowed, in the compute dtype, a float32
sum, `act(acc * scale + offset)` in float32 with zero padding (pt, pb, pl,
pr), the result rounded to the compute dtype. The engine runs on it every
conv that AUTO gives the kernel but no chain takes: a chain of one, or the
convs of a chain that the chain kernel's gate declines.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor (tests) it runs `conv2d_haloed_reference`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from shadernn_tpu_torch.kernels.chain import ACT_CODES, MAX_SMEM_BYTES
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import (
    conv2d_nhwc_f32, folded_operands, kernel_chain_supported,
)

# Kernel launches since import (a caller may reset them).
launches = {"fused_conv2d_haloed": 0}


def conv2d_haloed_reference(
    x: torch.Tensor,
    w_hwio: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    pads: Sequence[int] = (0, 0, 0, 0),
    activation: str = "linear",
    alpha: float = 0.3,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    dt = compute_dtype or x.dtype
    acc = conv2d_nhwc_f32(x.to(dt), w_hwio.to(dt), tuple(pads))
    y = acc * scale.float() + offset.float()
    return apply_activation(y, activation, alpha).to(dt).contiguous()


def _launch(x, w_hwio, scale, offset, pads, activation, alpha, dt) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv input must be float32 or bfloat16, got {x.dtype}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv compute dtype must be float32 or bfloat16, got {dt}")
    if x.dim() != 4 or w_hwio.dim() != 4 or w_hwio.shape[2] != x.shape[-1]:
        raise ValueError(
            f"conv needs NHWC x and HWIO w with matching C, got {tuple(x.shape)} "
            f"and {tuple(w_hwio.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("conv input must be contiguous")
    kh, kw, c, o = (int(v) for v in w_hwio.shape)
    for name, t, numel in (("scale", scale, o), ("offset", offset, o)):
        if t.numel() != numel:
            raise ValueError(f"{name} has {t.numel()} values, want {numel}")
    for t in (w_hwio, scale, offset):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, input on {x.device}")
    if activation.lower() not in ACT_CODES:
        raise ValueError(f"activation {activation!r} is not in the kernel's epilogue")
    pt, pb, pl, pr = (int(p) for p in pads)
    n, h, w, _ = x.shape
    y = torch.empty((n, h + pt + pb - kh + 1, w + pl + pr - kw + 1, o), dtype=dt,
                    device=x.device)
    if n == 0:
        return y
    wf = w_hwio.to(dt).contiguous()
    sf = scale.float().contiguous()
    of = offset.float().contiguous()
    lib = kernel_lib()
    rc = lib.snn_conv_single(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(), wf.data_ptr(),
        sf.data_ptr(), of.data_ptr(), n, h, w, c, kh, kw, o, pt, pb, pl, pr,
        ACT_CODES[activation.lower()], float(alpha), int(dt == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv_single launch failed ({rc}): {lib.snn_conv_single_error(rc).decode()}"
        )
    launches["fused_conv2d_haloed"] += 1
    return y


def fused_conv2d_haloed(
    x: torch.Tensor,
    w_hwio: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    pads: Sequence[int] = (0, 0, 0, 0),
    activation: str = "linear",
    alpha: float = 0.3,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Counterpart of conv_pallas.fused_conv2d_haloed, NHWC in and out: the
    CUDA kernel for a CUDA tensor (no fallback), `conv2d_haloed_reference`
    for a CPU tensor."""
    dt = compute_dtype or (torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32)
    if x.device.type == "cuda":
        return _launch(x, w_hwio, scale, offset, pads, activation, alpha, dt)
    if x.device.type == "cpu":
        return conv2d_haloed_reference(x, w_hwio, scale, offset, pads, activation, alpha, dt)
    raise ValueError(f"no single-conv kernel for device {x.device}")


def smem_bytes(kh: int, kw: int, o: int) -> int:
    """Shared memory of one CTA at one input channel per chunk, the least
    the kernel needs (the tile rule of csrc/conv_single.cu)."""
    ch = 8 if o > 4 else (4 if o > 1 else 1)
    ob = min(-(-o // ch) * ch, 32)
    tile_w = 16 if 256 // (ob // ch) >= 128 else 8
    tile_h = 256 // (ob // ch) // tile_w
    return 4 * (((tile_h + kh - 1) * (tile_w + kw - 1) + 3) // 4 * 4 + kh * kw * ob)


def single_conv_supported(node, in_channels: int) -> bool:
    """Can the kernel run this Conv2D node? The chain gate's geometry
    (ops/conv.py kernel_chain_supported) plus an activation in its
    epilogue, float weights (int8 comes with the INT8 slice) and the
    shared memory of one input channel."""
    k = int(node.attr("kernel_size"))
    return (
        kernel_chain_supported(node, in_channels)
        and "weight_q" not in node.params
        and str(node.attr("activation", "linear")).lower() in ACT_CODES
        and smem_bytes(k, k, int(node.attr("out_channels"))) <= MAX_SMEM_BYTES
    )


def conv_run_kernel(node, x: torch.Tensor, compute_dtype: torch.dtype,
                    operands: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """A Conv2D node on the kernel (counterpart of ops/conv.py
    conv_run_pallas_chain); `operands` as ops/conv.py folded_operands gives them, where
    the caller has them prepared."""
    w, scale, offset = operands or folded_operands(node, compute_dtype)
    pads = padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size")))
    return fused_conv2d_haloed(
        x, w, scale, offset, pads,
        activation=str(node.attr("activation", "linear")),
        alpha=float(node.attr("leaky_alpha", 0.3)),
        compute_dtype=compute_dtype,
    )
