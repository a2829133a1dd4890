"""Per-layer convolution as an implicit GEMM: the hand-written CUDA kernel
(csrc/conv_igemm.cu), its wrapper, its launch geometry, its gate and its
plain PyTorch version.

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
in x's dtype or int8 (upcast as the kernel stages it, exactly; the
dequantisation scale arrives folded into `scale`), stride >= 1, explicit
zero pads (top, bottom, left, right), a float32 sum over (dy, dx, c),
`act(acc * scale + offset)` in float32, the result rounded once to x's
dtype. The JAX kernel runs stride 2 in interpret mode only and its gate
keeps stride 1; the kernel here takes any stride, the gate keeps stride 1
so that both packages plan alike.

The kernel runs on the tensor cores: bf16 products with float32 sums for
a bf16 x; for a float32 x 3xTF32 (kernels/tf32.py is the plain model of
that arithmetic) on a weight this module lays out n-major and splits into
TF32 hi and lo (`nmajor_split`), which `prepare` does once for the caller
to keep. The launch geometry is this module's (`launch_geometry`): the C
entry point checks it and launches. On a CUDA tensor the wrapper launches
the kernel or raises; on a CPU tensor (tests) it runs
`conv2d_igemm_reference`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from shadernn_tpu_torch.kernels import count_launch
from shadernn_tpu_torch.kernels.chain import ACT_CODES, MAX_SMEM_BYTES
from shadernn_tpu_torch.kernels.conv import check_launch
from shadernn_tpu_torch.kernels.tf32 import tf32_split
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import (
    conv2d_nhwc_f32, folded_operands, kernel_conv_supported,
)


SMEM_PER_SM = 233472   # 228 KB; each resident CTA also takes 1 KB
CTAS_PER_SM = 2        # what __launch_bounds__(256, 2) holds the registers to


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


@dataclasses.dataclass(frozen=True)
class IgemmLaunch:
    """Launch geometry of csrc/conv_igemm.cu, in the order of its IG_*
    fields: strides in elements, offsets and sizes in bytes."""

    nt: int          # n8-tiles per warp (1, 2 or 4): the kernel's template
    wm: int          # warps along M; 8 / wm along N. A CTA: 32 * wm pixels x 8 * nt * (8 / wm) channels
    tile_h: int      # the output tile, tile_h * tile_w <= 32 * wm pixels of one image
    tile_w: int
    cc: int          # input channels per chunk (a multiple of 8)
    tg: int          # taps per stage
    bufs: int        # ring depth: stages staged ahead + 1
    in_stride: int   # elements per staged input position
    w_stride: int    # elements per staged weight row
    w_rows: int      # staged weight rows (bf16: k rows; f32: nb, n-major)
    tab_off: int
    in_off: int
    w_off: int
    out_off: int
    out_stride: int  # elements per pixel of the output tile
    smem: int
    grid: int        # persistent CTAs per channel block

    @property
    def nb(self) -> int:
        return 8 * self.nt * (8 // self.wm)

    @property
    def bm(self) -> int:
        return 32 * self.wm

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def out_hw(h: int, w: int, kh: int, kw: int, stride: int, pads) -> Tuple[int, int]:
    pt, pb, pl, pr = pads
    return (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1


def layout(c: int, kh: int, kw: int, stride: int, nt: int, wm: int, th: int, tw: int,
           cc: int, tg: int, bufs: int, f32: bool, mtiles: int, sms: int) -> IgemmLaunch:
    """The shared memory of a CTA: the table of unit offsets and the
    channel block's scale and offset, `bufs` input
    regions of a chunk, the weights of a stage (`bufs` slots where the
    conv takes several stages, else one, staged once), the output tile.
    Rows of 16-byte units padded to an odd count (ldmatrix without bank
    conflicts). bf16: regions of cc channels, weights k-major (tg * cc rows
    of nb); f32: regions of cc floats, weights n-major, nb rows of
    tg * cc floats, hi then lo. The grid: one wave of CTAs, at most
    CTAS_PER_SM a SM, no more than the tiles."""
    esz, epu = (4, 4) if f32 else (2, 8)
    nb = 8 * nt * (8 // wm)
    in_stride = cc + epu if (cc // epu) % 2 == 0 else cc
    if f32:
        w_stride, w_rows, w_buf = tg * cc + 4, nb, 2 * nb * (tg * cc + 4) * 4
    else:
        w_stride = nb + 8 if (nb // 8) % 2 == 0 else nb
        w_rows = _round_up(tg * cc, 16)
        w_buf = w_rows * w_stride * 2
    stages = -(-c // cc) * -(-(kh * kw) // tg)
    region = ((th - 1) * stride + kh) * ((tw - 1) * stride + kw)
    in_buf = _round_up(region * in_stride * esz, 16)
    tab = _round_up(4 * (kh * kw * (cc // 8) + 1), 16) + 8 * nb  # then the block's scale, offset
    in_off = _round_up(tab, 128)
    w_off = _round_up(in_off + bufs * in_buf, 128)
    out_off = _round_up(w_off + (bufs if stages > 1 else 1) * w_buf, 128)
    out_stride = nb + epu
    smem = out_off + 32 * wm * out_stride * esz
    per_sm = max(1, min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    return IgemmLaunch(nt, wm, th, tw, cc, tg, bufs, in_stride, w_stride, w_rows, 0, in_off,
                       w_off, out_off, out_stride, smem, max(1, min(mtiles, sms * per_sm)))


def _tile(bm: int, ho: int, wo: int) -> Tuple[int, int]:
    """A near-square 2-D tile of bm pixels (columns a power of two, at
    least 8), no wider or taller than the output needs."""
    tw = 8
    while tw * tw < bm:
        tw *= 2
    tw = min(tw, _pow2_at_least(wo))
    return min(bm // tw, ho), tw


@functools.lru_cache(maxsize=None)
def launch_geometry(n: int, h: int, w: int, c: int, kh: int, kw: int, o: int, stride: int,
                    pads: Tuple[int, int, int, int], f32: bool, sms: int) -> IgemmLaunch:
    """The launch of one conv (the kernel's only owner of it; `smem` over
    MAX_SMEM_BYTES means the conv does not fit). Channel blocks of 16
    output channels (8 where O <= 8), the warps' two m16 tiles making the
    pixel tile as large as the block allows (256 pixels: 16x16), halved
    (the warps spread over N, the block widening) while the grid would
    hold fewer than half as many CTAs as the card has SMs: a launch sweep
    on an H100 (tools/sweep_launch.py, PERF.md) put narrow blocks on large
    tiles first at the two-input conv and the ResNet-wide shapes. The tile
    is near square (16x16, 8x16, 8x8, 4x8). Every input channel and every
    tap in one stage, staged four deep where one stage holds the whole
    conv (its weights then staged once per CTA); until the stage fits in
    227 KB: two deep, then half the chunk while the input regions take
    over a quarter of it, else half the taps, then a shorter tile. Speed
    only: the result does not depend on it."""
    ho, wo = out_hw(h, w, kh, kw, stride, pads)
    nb0 = 8 if o <= 8 else 16
    for wm in (8, 4, 2, 1):
        nt = max(1, nb0 // (8 * (8 // wm)))
        th, tw = _tile(32 * wm, ho, wo)
        nblocks = -(-o // (8 * nt * (8 // wm)))
        if n * -(-ho // th) * -(-wo // tw) * nblocks >= sms / 2:
            break
    th, tw = _tile(32 * wm, ho, wo)
    cc, tg = _round_up(c, 8), kh * kw
    one_stage = cc >= c and tg == kh * kw
    bufs = 4 if one_stage else 2
    while True:
        mtiles = n * -(-ho // th) * -(-wo // tw)
        geo = layout(c, kh, kw, stride, nt, wm, th, tw, cc, tg, bufs, f32, mtiles, sms)
        if geo.smem <= MAX_SMEM_BYTES:
            return geo
        if bufs > 2:
            bufs = 2
        elif geo.w_off - geo.in_off > MAX_SMEM_BYTES // 4 and cc > 8:
            cc = _round_up(cc // 2, 8)
        elif tg > 1:
            tg = -(-tg // 2)
        elif th > 1:
            th = -(-th // 2)
        else:
            return geo


def nmajor_split(w_hwio: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The f32 form's weight: (O, kh*kw*C8), row o holding w[:, :, :, o] tap
    by tap with C zero-padded to a multiple of 8 (k contiguous: ldmatrix
    has no 32-bit transpose), as its TF32 hi and lo float32 parts; an int8
    weight stays int8 (exact in TF32, the kernel upcasts it) with no lo,
    and so does a float weight exact in TF32 (lo None: that pass is
    skipped)."""
    kh, kw, c, o = w_hwio.shape
    wn = torch.nn.functional.pad(w_hwio.permute(3, 0, 1, 2), (0, -c % 8)).reshape(o, -1)
    if w_hwio.dtype == torch.int8:
        return wn.contiguous(), None
    hi, lo = tf32_split(wn)
    return hi.contiguous(), lo.contiguous() if bool(lo.any()) else None


@dataclasses.dataclass(frozen=True)
class IgemmOperands:
    """A conv's operands as its launch reads them (`prepare`), for inputs
    of `dtype`: the HWIO weight as given (which the plain version reads),
    the weight the kernel stages (bf16: HWIO in bf16 or int8; f32:
    `nmajor_split`'s hi and lo) and the float32 scale and offset."""

    hwio: torch.Tensor
    w: torch.Tensor
    w_lo: Optional[torch.Tensor]
    scale: torch.Tensor
    offset: torch.Tensor
    dtype: torch.dtype


def prepare(w_hwio: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
            dtype: torch.dtype) -> IgemmOperands:
    """The launch's operands of one conv for inputs of `dtype`."""
    w_int8 = w_hwio.dtype == torch.int8
    if dtype == torch.float32:
        wk, w_lo = nmajor_split(w_hwio if w_int8 else w_hwio.float())
    else:
        wk, w_lo = (w_hwio if w_int8 else w_hwio.to(torch.bfloat16)).contiguous(), None
    return IgemmOperands(w_hwio, wk, w_lo, scale.float().contiguous(),
                         offset.float().contiguous(), dtype)


def _launch(x, ops: IgemmOperands, stride, pads, activation, alpha) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

    kh, kw, c, o = check_launch(x, ops.hwio, ops.scale, ops.offset, activation)
    if ops.dtype != x.dtype:
        raise ValueError(f"operands prepared for {ops.dtype} inputs, input is {x.dtype}")
    act = str(activation or "linear").lower()
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
    f32 = x.dtype == torch.float32
    w_int8 = ops.hwio.dtype == torch.int8
    geo = launch_geometry(n, h, w, c, kh, kw, o, stride, (pt, pb, pl, pr), f32,
                          sm_count(x.device.index))
    if geo.smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv k{kh}x{kw} {c}->{o} does not fit the kernel's shared memory")
    lib = kernel_lib()
    rc = lib.snn_conv_igemm(
        x.data_ptr(), int(not f32), ops.w.data_ptr(),
        ops.w_lo.data_ptr() if ops.w_lo is not None else None, int(w_int8),
        int(ops.w_lo is not None), ops.scale.data_ptr(), ops.offset.data_ptr(), y.data_ptr(),
        n, h, w, c, kh, kw, o, stride, pt, pb, pl, pr, ACT_CODES[act], float(alpha), geo.array,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv_igemm launch failed ({rc}): {lib.snn_conv_igemm_error(rc).decode()}"
        )
    count_launch("conv2d_kernel_nhwc")
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
    for a CPU tensor; the operands prepared on this call."""
    return run(x, prepare(w_hwio, scale, offset, x.dtype), stride=stride, pads=pads,
               activation=activation, alpha=alpha)


def run(x: torch.Tensor, ops: IgemmOperands, *, stride: int = 1,
        pads: Sequence[int] = (0, 0, 0, 0), activation: str = "linear",
        alpha: float = 0.3) -> torch.Tensor:
    """`conv2d_kernel_nhwc` on operands that `prepare` made."""
    if x.device.type == "cuda":
        return _launch(x, ops, stride, pads, activation, alpha)
    if x.device.type == "cpu":
        return conv2d_igemm_reference(x, ops.hwio, ops.scale, ops.offset, stride, pads,
                                      activation, alpha)
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
                   operands: Optional[IgemmOperands] = None) -> torch.Tensor:
    """A Conv2D node on the kernel (counterpart of ops/conv.py
    _conv_run_pallas); `operands`: `prepare`'s of ops/conv.py
    folded_operands where the caller keeps them, else made on this call."""
    operands = operands or prepare(*folded_operands(node, x.dtype), x.dtype)
    return run(
        x.contiguous(), operands,
        stride=int(node.attr("stride", 1)),
        pads=padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size"))),
        activation=str(node.attr("activation", "linear")),
        alpha=float(node.attr("leaky_alpha", 0.3)),
    )
