"""Fused matmul of the Dense layers: the hand-written CUDA kernel
(csrc/matmul_fused.cu), its wrapper and its plain PyTorch version.

The kernel ports `_matmul_kernel` of the JAX package
(`shadernn_tpu/kernels/matmul_pallas.py`, entry point `fused_matmul`,
reached through `shadernn_tpu/ops/dense.py` when the backend is forced to
the kernel). The entry point keeps its JAX name.

The function: y = act((x @ W) * scale + offset) with x (M, K) float32 or
bfloat16, W (K, N) in x's dtype or int8 (upcast to bfloat16, which holds
every int8 value; the dequantisation scale arrives folded into `scale`), a
float32 sum and epilogue, the result rounded once to x's dtype.

softmax is taken over the N true columns of each row. The JAX kernel pads
N to its 128-column tile and applies the activation per padded tile, so
its softmax counts the padding as exp(0) and would run per tile for
N > 128; the port does not copy that, and is held against the JAX kernel
for the elementwise activations only.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor (tests) it runs `fused_matmul_reference`.
"""

from __future__ import annotations

import torch

from shadernn_tpu_torch.kernels.chain import ACT_CODES
from shadernn_tpu_torch.ops.common import apply_activation
from shadernn_tpu_torch.ops.conv import folded_operands

# Longest row whose softmax the matmul kernel takes itself; a longer row's
# float32 logits go through a scratch tensor to the kernel's row-softmax
# pass. It must agree with csrc/matmul_fused.cu.
SOFTMAX_FUSED_N = 32

# Kernel launches since import (a caller may reset them).
launches = {"fused_matmul": 0}


def matmul_supported(activation: str) -> bool:
    """Is the activation in the kernel's epilogue: an elementwise one, or
    softmax over the columns?"""
    act = str(activation or "linear").lower()
    return act == "softmax" or act in ACT_CODES


def fused_matmul_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    activation: str = "linear",
    alpha: float = 0.3,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    wf = w.to(torch.bfloat16) if w.dtype == torch.int8 else w.to(x.dtype)
    acc = x.float() @ wf.float()
    y = acc * scale.float() + offset.float()
    return apply_activation(y, activation, alpha).to(x.dtype)


def _launch(x, w, scale, offset, activation, alpha) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul input must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"matmul needs x (M, K) and w (K, N), got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("matmul input must be contiguous")
    m, k = (int(v) for v in x.shape)
    n = int(w.shape[1])
    for name, t in (("scale", scale), ("offset", offset)):
        if t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} values, want {n}")
    for t in (w, scale, offset):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, input on {x.device}")
    act = str(activation or "linear").lower()
    if not matmul_supported(act):
        raise ValueError(f"activation {activation!r} is not in the kernel's epilogue")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        raise ValueError("matmul over an empty K")
    wk = (w if w.dtype == torch.int8 else w.to(x.dtype)).contiguous()
    sf = scale.float().contiguous()
    of = offset.float().contiguous()
    lib = kernel_lib()
    softmax = act == "softmax"
    scratch = (torch.empty((m, n), dtype=torch.float32, device=x.device)
               if softmax and n > SOFTMAX_FUSED_N else None)
    rc = lib.snn_matmul_fused(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wk.data_ptr(),
        int(wk.dtype == torch.int8), sf.data_ptr(), of.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        m, k, n, 0 if softmax else ACT_CODES[act], float(alpha), int(softmax),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"matmul_fused launch failed ({rc}): {lib.snn_matmul_error(rc).decode()}"
        )
    launches["fused_matmul"] += 1
    return y


def fused_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    *,
    activation: str = "linear",
    alpha: float = 0.3,
) -> torch.Tensor:
    """Counterpart of matmul_pallas.fused_matmul: the CUDA kernel for a CUDA
    tensor (no fallback), `fused_matmul_reference` for a CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x, w, scale, offset, activation, alpha)
    if x.device.type == "cpu":
        return fused_matmul_reference(x, w, scale, offset, activation, alpha)
    raise ValueError(f"no matmul kernel for device {x.device}")


# What dense_supported asks, for the log line of a layer it declines.
GATE = "fused-matmul kernel's gate (float weights, an activation of its epilogue)"


def dense_supported(node) -> bool:
    """Can the kernel run this Dense node? Float weights (the engine's int8
    comes with the INT8 slice) and an activation of `matmul_supported`."""
    return "weight" in node.params and "weight_q" not in node.params and matmul_supported(
        node.attr("activation", "linear"))


def dense_run_kernel(node, x: torch.Tensor, operands=None) -> torch.Tensor:
    """A Dense node on the kernel (the PALLAS branch of the JAX op):
    inputs above 2-D are flattened; `operands` as ops/conv.py folded_operands
    gives them, where the caller has them prepared."""
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    w, scale, offset = operands or folded_operands(node, x.dtype)
    return fused_matmul(
        x.contiguous(), w, scale, offset,
        activation=str(node.attr("activation", "linear")),
        alpha=float(node.attr("leaky_alpha", 0.3)),
    )
