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
tensor (tests) it runs `fused_matmul_reference`. The launch geometry is
this module's (`launch_geometry`: the column and row blocks, the K chunk,
the split of K over a cluster, the shared-memory layout), as are the
softmax's scratch (the logits, and one arrival counter per row block that
the kernel leaves at 0); the C entry point checks the geometry and
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from shadernn_tpu_torch.kernels import count_launch
from shadernn_tpu_torch.kernels.chain import ACT_CODES, MAX_SMEM_BYTES
from shadernn_tpu_torch.ops.common import apply_activation
from shadernn_tpu_torch.ops.conv import folded_operands


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


THREADS = 256  # as csrc/matmul_fused.cu SNN_MM_THREADS


@dataclasses.dataclass(frozen=True)
class MatmulLaunch:
    """Launch geometry of csrc/matmul_fused.cu, in the order of its MG_*
    fields; byte offsets, strides in elements."""

    bn: int       # columns per CTA: 16, 32 or 64
    mb: int       # rows per CTA (bf16: a multiple of 16 up to 64; f32: up to 16)
    bk: int       # K per staged chunk
    split: int    # CTAs of a cluster sharing the block, each a share of K
    xstride: int
    wstride: int
    xs_off: int   # two x chunks [mb][xstride]
    ws_off: int   # two W chunks [bk][wstride]
    red_off: int  # partial sums [K group][mb][bn], f32
    part_off: int  # the CTA's sums [mb][bn], f32
    so_off: int   # the block's scale and offset [2][bn], f32
    smem: int

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)

    def blocks(self, m: int, n: int) -> Tuple[int, int]:
        """(column blocks, row blocks) of the grid; a cluster per column block."""
        return -(-n // self.bn), -(-m // self.mb)

    def k_ranges(self, k: int):
        """[lo, hi) of K for each rank of a cluster, as the kernel cuts it."""
        kr = -(-(-(-k // self.split)) // 16) * 16
        return [(min(k, r * kr), min(k, r * kr + kr)) for r in range(self.split)]


def _layout(bn: int, mb: int, bk: int, split: int, bf16: bool) -> MatmulLaunch:
    esz = 2 if bf16 else 4
    xstride = bk + (8 if bf16 else 4)  # bf16 rows: an odd number of 16-byte units
    wstride = bn + 8 if bf16 else bn
    groups = 64 // bn if bf16 else THREADS // bn
    xs_off = 0
    ws_off = xs_off + 2 * mb * xstride * esz
    red_off = ws_off + 2 * bk * wstride * esz
    part_off = red_off + 4 * groups * mb * bn
    so_off = part_off + 4 * mb * bn
    return MatmulLaunch(bn, mb, bk, split, xstride, wstride, xs_off, ws_off, red_off, part_off,
                        so_off, so_off + 8 * bn)


@functools.lru_cache(maxsize=None)
def launch_geometry(m: int, k: int, n: int, bf16: bool, sms: int,
                    split: Optional[int] = None) -> MatmulLaunch:
    """The launch of one product (the kernel's only owner of it): column
    blocks of 16 where N <= 16, else 32 (more CTAs share a wide W); rows in
    blocks of 16 (bf16: one m-tile) or 1 (f32), except that a W of 1 MB
    or more is read once for up to 64 rows (bf16, four m-tiles) or 8
    (f32); K split
    over a cluster of 2-8 CTAs, doubled while a rank's share of K is over
    128 and the grid has fewer CTAs than the card has SMs; a rank's share
    in one chunk up to 256 (one round trip to memory), else chunks of 256
    (`split` forces it). Speed only: the result does not depend on it."""
    bn = 16 if n <= 16 else 32
    big_w = k * n * (2 if bf16 else 4) >= 1 << 20
    mb = (min(64, -(-m // 16) * 16) if big_w else 16) if bf16 else (min(8, m) if big_w else 1)
    if split is None:
        cols, rows = -(-n // bn), -(-m // mb)
        split = 1
        while split < 8 and split * 128 < k and cols * rows * split < sms:
            split *= 2
    kr = -(-(-(-k // split)) // 16) * 16  # a rank's share of K, as the kernel cuts it
    return _layout(bn, mb, min(256, kr), split, bf16)


# Per (device, stream): the row-block arrival counters of the softmax (int32,
# zero; the kernel sets each back to 0), grown as needed.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _softmax_counters(device: torch.device, stream: int, rows: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < rows:
        c = _counters[key] = torch.zeros(max(rows, 64), dtype=torch.int32, device=device)
    return c


def _launch(x, w, scale, offset, activation, alpha) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

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
    bf16 = x.dtype == torch.bfloat16
    geo = launch_geometry(m, k, n, bf16, sm_count(x.device.index))
    if geo.smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul {m}x{k}x{n} does not fit the kernel's shared memory")
    wk = (w if w.dtype == torch.int8 else w.to(x.dtype)).contiguous()
    sf = scale.float().contiguous()
    of = offset.float().contiguous()
    lib = kernel_lib()
    softmax = act == "softmax"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cols, rows = geo.blocks(m, n)
    logits = counters = None
    if softmax and cols > 1:
        logits = torch.empty(m * n + 2 * m * cols, dtype=torch.float32, device=x.device)
        counters = _softmax_counters(x.device, stream, rows)
    rc = lib.snn_matmul_fused(
        x.data_ptr(), int(bf16), wk.data_ptr(), int(wk.dtype == torch.int8), sf.data_ptr(),
        of.data_ptr(), y.data_ptr(), None if logits is None else logits.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, k, n, 0 if softmax else ACT_CODES[act], float(alpha), int(softmax), geo.array, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"matmul_fused launch failed ({rc}): {lib.snn_matmul_error(rc).decode()}"
        )
    count_launch("fused_matmul")
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
GATE = "fused-matmul kernel's gate (an activation of its epilogue)"


def dense_supported(node) -> bool:
    """Can the kernel run this Dense node? Float or int8 weights (ops/conv.py
    folded_operands hands the kernel the int8 weight and the folded scale)
    and an activation of `matmul_supported`."""
    return ("weight" in node.params or "weight_q" in node.params) and matmul_supported(
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
