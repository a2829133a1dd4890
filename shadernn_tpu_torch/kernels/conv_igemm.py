"""Per-layer convolution as an implicit GEMM: the hand-written CUDA kernel
(csrc/conv_igemm.cu), its wrapper, its gate and its plain PyTorch version.

The kernel ports `_conv_kernel` of the JAX package
(`shadernn_tpu/kernels/conv_pallas.py`, entry points `fused_conv2d_nhcw`
and `conv2d_pallas_nhwc`, reached through `shadernn_tpu/ops/conv.py`
`Conv2D.run` when the backend is forced to the kernel and no chain takes
the conv: on one device, a multi-input Conv2D). `conv2d_kernel_nhwc` is
the counterpart of `conv2d_pallas_nhwc`. The NHCW transposes and the
channel and lane padding around the JAX kernel are TPU layout and are not
carried over: the function is taken at the tensor boundary, NHWC in and
NHWC out.

The function: x (N,H,W,C) float32 or bfloat16, an HWIO weight (kh,kw,C,O)
in x's dtype or int8 (upcast to bfloat16, which holds every int8 value;
the dequantisation scale arrives folded into `scale`), stride >= 1,
explicit zero pads (top, bottom, left, right), a float32 sum over
(dy, dx, c), `act(acc * scale + offset)` in float32, the result rounded
once to x's dtype. The JAX kernel runs stride 2 in interpret mode only and
its gate keeps stride 1; the kernel here takes any stride, the gate keeps
stride 1 so that both packages plan alike.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor (tests) it runs `conv2d_igemm_reference`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from shadernn_tpu_torch.kernels.chain import ACT_CODES
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import (
    conv2d_nhwc_f32, folded_operands, kernel_conv_supported,
)

# Kernel launches since import (a caller may reset them).
launches = {"conv2d_kernel_nhwc": 0}


def conv2d_igemm_reference(
    x: torch.Tensor,
    w_hwio: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    stride: int = 1,
    pads: Sequence[int] = (0, 0, 0, 0),
    activation: str = "linear",
    alpha: float = 0.3,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    wf = w_hwio.to(torch.bfloat16) if w_hwio.dtype == torch.int8 else w_hwio.to(x.dtype)
    acc = conv2d_nhwc_f32(x, wf, tuple(pads), stride)
    y = acc * scale.float() + offset.float()
    return apply_activation(y, activation, alpha).to(x.dtype).contiguous()


def _launch(x, w_hwio, scale, offset, stride, pads, activation, alpha) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv input must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or w_hwio.dim() != 4 or w_hwio.shape[2] != x.shape[-1]:
        raise ValueError(
            f"conv needs NHWC x and HWIO w with matching C, got {tuple(x.shape)} "
            f"and {tuple(w_hwio.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("conv input must be contiguous")
    kh, kw, c, o = (int(v) for v in w_hwio.shape)
    for name, t in (("scale", scale), ("offset", offset)):
        if t.numel() != o:
            raise ValueError(f"{name} has {t.numel()} values, want {o}")
    for t in (w_hwio, scale, offset):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, input on {x.device}")
    act = str(activation or "linear").lower()
    if act not in ACT_CODES:
        raise ValueError(f"activation {activation!r} is not in the kernel's epilogue")
    stride = int(stride)
    pt, pb, pl, pr = (int(p) for p in pads)
    n, h, w, _ = (int(v) for v in x.shape)
    if stride < 1 or min(pt, pb, pl, pr) < 0 or h + pt + pb < kh or w + pl + pr < kw:
        raise ValueError(f"conv geometry: stride {stride}, pads {tuple(pads)}, "
                         f"kernel {kh}x{kw} on {h}x{w}")
    y = torch.empty((n, (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1, o),
                    dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    wk = (w_hwio if w_hwio.dtype == torch.int8 else w_hwio.to(x.dtype)).contiguous()
    sf = scale.float().contiguous()
    of = offset.float().contiguous()
    lib = kernel_lib()
    rc = lib.snn_conv_igemm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wk.data_ptr(),
        int(wk.dtype == torch.int8), sf.data_ptr(), of.data_ptr(), y.data_ptr(),
        n, h, w, c, kh, kw, o, stride, pt, pb, pl, pr, ACT_CODES[act], float(alpha),
        sm_count(x.device.index), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv_igemm launch failed ({rc}): {lib.snn_conv_igemm_error(rc).decode()}"
        )
    launches["conv2d_kernel_nhwc"] += 1
    return y


def conv2d_kernel_nhwc(
    x: torch.Tensor,
    w_hwio: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    *,
    stride: int = 1,
    pads: Sequence[int] = (0, 0, 0, 0),
    activation: str = "linear",
    alpha: float = 0.3,
) -> torch.Tensor:
    """Counterpart of conv_pallas.conv2d_pallas_nhwc, NHWC in and out: the
    CUDA kernel for a CUDA tensor (no fallback), `conv2d_igemm_reference`
    for a CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x, w_hwio, scale, offset, stride, pads, activation, alpha)
    if x.device.type == "cpu":
        return conv2d_igemm_reference(x, w_hwio, scale, offset, stride, pads, activation, alpha)
    raise ValueError(f"no implicit-GEMM conv kernel for device {x.device}")


# What igemm_conv_supported asks, for the log line of a conv it declines.
GATE = ("implicit-GEMM kernel's gate (stride 1, c <= 128, o <= 128, k*k*c <= 4096, "
        "an elementwise activation)")


def igemm_conv_supported(node, in_channels: int) -> bool:
    """Can the kernel run this Conv2D node over `in_channels` (all inputs
    of a multi-input conv together)? The geometry gate
    (ops/conv.py kernel_conv_supported) and an activation in the kernel's
    epilogue (softmax would reduce over channels, which the TPU kernel does
    not compute either). Float and int8 weights alike: ops/conv.py
    folded_operands hands the kernel the int8 weight and the folded
    scale."""
    return (
        kernel_conv_supported(node, in_channels)
        and str(node.attr("activation", "linear")).lower() in ACT_CODES
    )


def conv_run_igemm(node, x: torch.Tensor,
                   operands: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """A Conv2D node on the kernel (counterpart of ops/conv.py
    _conv_run_pallas); `operands` as ops/conv.py folded_operands gives them, where the
    caller has them prepared."""
    w, scale, offset = operands or folded_operands(node, x.dtype)
    return conv2d_kernel_nhwc(
        x.contiguous(), w, scale, offset,
        stride=int(node.attr("stride", 1)),
        pads=padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size"))),
        activation=str(node.attr("activation", "linear")),
        alpha=float(node.attr("leaky_alpha", 0.3)),
    )
