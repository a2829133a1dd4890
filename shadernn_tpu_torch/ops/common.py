"""Shared op helpers: padding arithmetic and activation functions.

Padding reproduces `Conv2DLayer::getPaddingOffset`
(core/src/ic2/conv2d.cpp:69-105), as `shadernn_tpu/ops/common.py` does:
the spec may be digit strings / ints (explicit), "valid"/"none" (zero), or
"same"-style keywords, with the reference's even-kernel asymmetry
(top/left get one less).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

PadSpec = Union[str, int, Sequence[int]]


def padding_offsets(padding: PadSpec, kernel_size: int) -> Tuple[int, int, int, int]:
    """Return (top, bottom, left, right) pad amounts.

      - explicit digits: taken as given
      - "valid"/"none": zero
      - otherwise ("same"): max(k//2, 1) on each side for k>1, and for even
        k the top/left side is reduced by one; k<=1 pads zero.
    """
    if isinstance(padding, (list, tuple)):
        if len(padding) == 2:  # (vertical, horizontal)
            t = b = int(padding[0])
            l = r = int(padding[1])
            return (t, b, l, r)
        if len(padding) == 4:
            return tuple(int(p) for p in padding)  # type: ignore[return-value]
        raise ValueError(f"bad padding tuple {padding}")
    if isinstance(padding, (int, float)):
        p = int(padding)
        return (p, p, p, p)
    s = str(padding)
    if s.isdigit():
        p = int(s)
        return (p, p, p, p)
    if s in ("valid", "none"):
        return (0, 0, 0, 0)
    k = kernel_size
    if k <= 1:
        return (0, 0, 0, 0)
    p = max(k // 2, 1)
    t, b_, l, r = p, p, p, p
    if k % 2 == 0:
        t -= 1
        l -= 1
    return (t, b_, l, r)


def is_same_padding(padding: PadSpec) -> bool:
    if isinstance(padding, str):
        return not padding.isdigit() and padding not in ("valid", "none")
    return False


def conv_output_hw(
    h: int, w: int, k: int, stride: int, pads: Tuple[int, int, int, int]
) -> Tuple[int, int]:
    t, b, l, r = pads
    return ((h + t + b - k) // stride + 1, (w + l + r - k) // stride + 1)


def apply_activation(x: torch.Tensor, kind: str, alpha: float = 0.3) -> torch.Tensor:
    """Fused activation epilogue; vocabulary and default leaky alpha (0.3)
    follow the reference. gelu is the tanh approximation (jax.nn.gelu's
    default)."""
    kind = (kind or "linear").lower()
    if kind in ("linear", "", "none", "identity"):
        return x
    if kind == "relu":
        return torch.relu(x)
    if kind == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if kind in ("leakyrelu", "leaky_relu", "leaky relu"):
        return torch.where(x >= 0, x, alpha * x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind in ("silu", "swish"):
        return x * torch.sigmoid(x)
    if kind == "softmax":
        return torch.softmax(x, dim=-1)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


ACTIVATIONS = (
    "linear relu relu6 leaky_relu tanh sigmoid silu swish softmax gelu".split()
)
