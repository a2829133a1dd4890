"""Plain model of the split-TF32 (3xTF32) arithmetic of the float32 forms
of the single-conv, block, chain and implicit-GEMM conv kernels
(csrc/conv_single.cu, csrc/invres_block.cu, csrc/conv_chain.cu,
csrc/conv_igemm.cu; the helpers in csrc/snn_mma.cuh).

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

from typing import Optional, Sequence, Tuple

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
    return matmul_split(a_hi, None if a_exact else a_lo, b_hi, None if b_exact else b_lo)


def matmul_split(a_hi: torch.Tensor, a_lo: Optional[torch.Tensor], b_hi: torch.Tensor,
                 b_lo: Optional[torch.Tensor]) -> torch.Tensor:
    """The product of operands that arrive split (the chain's regions are
    split by their producer, the weights on the host): a_hi b_lo + a_lo
    b_hi + a_hi b_hi in float32, a pass skipped where its lo is None."""
    lhs, rhs = [a_hi], [b_hi]
    if b_lo is not None:
        lhs.append(a_hi)
        rhs.append(b_lo)
    if a_lo is not None:
        lhs.append(a_lo)
        rhs.append(b_hi)
    return torch.cat(lhs, dim=1) @ torch.cat(rhs, dim=0)


def conv_3xtf32(a_hi: torch.Tensor, a_lo: Optional[torch.Tensor], w_hwio: torch.Tensor,
                stride: int = 1, pads: Sequence[int] = (0, 0, 0, 0)) -> torch.Tensor:
    """An NHWC convolution (no epilogue) as the f32 forms of the chain and
    the implicit-GEMM conv compute it, on an input that arrives split
    (a_lo None: exact in TF32, its pass skipped): per tap, the passes'
    products over C summed in float32 (the tap's sums), then added into the
    float32 sums tap by tap (the kernels promote per tap: the tensor cores'
    accumulation truncates). The weight is split here (int8 or any weight
    exact in TF32 has a zero lo; its pass is then skipped)."""
    n, h, w, c = a_hi.shape
    kh, kw, _, o = w_hwio.shape
    pt, pb, pl, pr = pads
    ho, wo = (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, pl, pr, pt, pb))  # noqa: E731
    xh = pad(a_hi.float())
    xl = pad(a_lo.float()) if a_lo is not None else None
    w_hi, w_lo = tf32_split(w_hwio.float())
    exact_w = not bool(w_lo.any())
    acc = torch.zeros((n * ho * wo, o), dtype=torch.float32)
    for dy in range(kh):
        for dx in range(kw):
            def patch(v):
                return v[:, dy:dy + (ho - 1) * stride + 1:stride,
                         dx:dx + (wo - 1) * stride + 1:stride].reshape(-1, c)
            acc = acc + matmul_split(patch(xh), patch(xl) if xl is not None else None,
                                     w_hi[dy, dx], None if exact_w else w_lo[dy, dx])
    return acc.reshape(n, ho, wo, o)
