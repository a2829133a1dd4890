"""Plain model of the split-TF32 (3xTF32) arithmetic of the float32 forms
of the single-conv and block kernels (csrc/conv_single.cu,
csrc/invres_block.cu; the helpers in csrc/snn_mma.cuh).

The H100's tensor cores multiply TF32 (8 exponent bits, 10 mantissa bits)
with float32 sums. The kernels keep float32 accuracy, as the JAX package
runs float32 products at HIGHEST precision, by splitting each operand v
into hi = tf32(v) and lo = tf32(v - hi) (`cvt.rna.tf32.f32`: round to
nearest, ties away from zero) and summing a_hi b_lo + a_lo b_hi + a_hi b_hi
in float32; a_lo b_lo (2^-22 relative) is dropped, and an operand exact in
TF32 (an int8 weight, a bfloat16 input) has lo = 0, so its pass is skipped.
Each product of two TF32 values is exact in float32. The tests hold this
model against float32 and against the JAX package's HIGHEST-precision
products at the largest K the kernels' gates admit.
"""

from __future__ import annotations

from typing import Tuple

import torch

_LOW13 = 0x1FFF  # the mantissa bits TF32 drops


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as `cvt.rna.tf32.f32` rounds (to nearest, ties away
    from zero; the low 13 bits zero), on the bit pattern: (bits + 0x1000)
    & ~0x1FFF."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_LOW13).view(torch.float32)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32, with hi + lo = v within 2^-22 |v| (v - hi is
    exact in float32)."""
    v = v.to(torch.float32)
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, a_exact: bool = False,
                  b_exact: bool = False) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the kernels compute it: the passes' products
    summed in one float32 accumulator per output (the kernels interleave
    them k-step by k-step; the order differs). `a_exact` / `b_exact`: that
    operand is exact in TF32 and its lo pass is skipped, as in the kernels."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    lhs, rhs = [a_hi], [b_hi]
    if not b_exact:
        lhs.append(a_hi)
        rhs.append(b_lo)
    if not a_exact:
        lhs.append(a_lo)
        rhs.append(b_hi)
    return torch.cat(lhs, dim=1) @ torch.cat(rhs, dim=0)
