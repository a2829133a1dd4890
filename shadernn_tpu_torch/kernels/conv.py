"""Single stride-1 convolution: the hand-written CUDA kernel
(csrc/conv_single.cu), its wrapper and its plain PyTorch version.

The kernel ports `_haloed_kernel` of the JAX package
(`shadernn_tpu/kernels/conv_pallas.py`, entry point `fused_conv2d_haloed`,
reached through `shadernn_tpu/ops/conv.py` `conv_run_pallas_chain`). The
entry point keeps its JAX name. The haloed NHCW layout and the C=1 row
packing are TPU layouts and are not carried over: the function is taken
at the tensor boundary, NHWC in and NHWC out.

The function: x (N,H,W,C) cast to the compute dtype, an HWIO weight
(kh,kw,C,O), rectangular kernels allowed, in the compute dtype (or int8
under bfloat16: the kernel upcasts it as it stages it, exactly, and its
scale arrives folded into `scale`), a float32 sum, `act(acc * scale +
offset)` in float32 with zero padding (pt, pb, pl, pr), the result
rounded to the compute dtype. The engine runs on it every
conv that AUTO gives the kernel but no chain takes: a chain of one, or the
convs of a chain that the chain kernel's gate declines.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor (tests) it runs `conv2d_haloed_reference`. The launch geometry is
this module's (`launch_geometry`): the C entry point checks it and
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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


TC_PIXELS = 64        # output pixels per CTA of the bf16 form
SMEM_TARGET = 98304   # 96 KB: two CTAs per SM where a stage fits


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    """Launch geometry of one conv on csrc/conv_single.cu, in the order of
    its G_* fields; byte offsets and sizes, strides in elements."""

    tile_h: int
    tile_w: int
    imgs: int       # bf16: whole images per CTA (then the tile is the image)
    nb: int         # output channels per CTA
    cc: int         # input channels per chunk
    tg: int         # taps per stage (bf16)
    ch: int         # output channels per thread (f32)
    in_stride: int  # bf16 per staged input position
    w_stride: int   # bf16 per staged weight row
    w_rows: int     # staged weight rows per stage
    in_off: int
    in_bufs: int
    w_off: int
    w_bufs: int
    smem: int

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _f32_launch(kh: int, kw: int, c: int, o: int, cc: Optional[int] = None) -> ConvLaunch:
    """The f32 form: 256 threads of one output pixel and CH channels each
    (at most 32 channels per CTA), the largest input-channel chunk within
    96 KB (two CTAs per SM), else within 227 KB; `cc` forces the chunk."""
    ch = 8 if o > 4 else (4 if o > 1 else 1)
    ob = min(_round_up(o, ch), 32)
    pixels = 256 // (ob // ch)
    tile_w = 16 if pixels >= 128 else 8
    tile_h = pixels // tile_w
    rows, cols = tile_h + kh - 1, tile_w + kw - 1
    per_c = _round_up(rows * cols, 4) + kh * kw * ob  # floats of one channel
    budget = SMEM_TARGET // 4 if per_c <= SMEM_TARGET // 4 else MAX_SMEM_BYTES // 4
    if cc is None:
        cc = max(1, min(budget // per_c, c))
    w_off = 4 * _round_up(cc * rows * cols, 4)
    return ConvLaunch(tile_h, tile_w, 1, ob, cc, kh * kw, ch, 0, 0, 0, 0, 1, w_off, 1,
                      w_off + 4 * kh * kw * cc * ob)


def _tc_launch(c: int, kh: int, kw: int, th: int, tw: int, imgs: int, nb: int,
               cc: int, tg: int) -> ConvLaunch:
    """The bf16 form's shared memory: the input region(s) of a chunk, each
    followed by a zero row, then the weights of a stage; rows padded to an
    odd number of 16-byte units (ldmatrix without bank conflicts)."""
    in_stride = cc + 8 if (cc // 8) % 2 == 0 else cc
    w_stride = nb + 8 if (nb // 8) % 2 == 0 else nb
    w_rows = _round_up(tg * cc, 16)
    chunks, groups = -(-c // cc), -(-(kh * kw) // tg)
    in_bufs = 2 if chunks > 1 else 1
    w_bufs = 2 if chunks * groups > 1 else 1
    region = imgs * (th + kh - 1) * (tw + kw - 1)
    w_off = in_bufs * (region + 1) * in_stride * 2
    return ConvLaunch(th, tw, imgs, nb, cc, tg, 0, in_stride, w_stride, w_rows, 0, in_bufs,
                      w_off, w_bufs, w_off + w_bufs * w_rows * w_stride * 2)


@functools.lru_cache(maxsize=None)
def launch_geometry(n: int, h: int, w: int, c: int, kh: int, kw: int, o: int,
                    pads: Tuple[int, int, int, int], bf16: bool, sms: int) -> ConvLaunch:
    """The launch of one conv (the kernel's only owner of it; `smem` over
    MAX_SMEM_BYTES means the conv does not fit). bf16: 64 output pixels
    per CTA (an 8x8 tile, or as many whole images as fit when an image has
    at most 32 pixels); the smallest channel block of 16-128 that covers O,
    halved while the grid has fewer CTAs than the card has SMs; every
    input channel and every tap in one stage (a stage costs more than its
    products at these sizes). Until the stage fits in 227 KB: fewer images
    or a smaller chunk while the input region alone takes over a quarter
    of it, else tap groups halved; at one tap, a smaller tile. Speed only:
    the result does not depend on it."""
    if not bf16:
        return _f32_launch(kh, kw, c, o)
    pt, pb, pl, pr = pads
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    if ho * wo <= TC_PIXELS // 2:
        imgs, th, tw = TC_PIXELS // (ho * wo), ho, wo
    else:
        imgs, tw = 1, min(wo, 8)
        th = min(ho, TC_PIXELS // tw)
    nb = 16
    while nb < o:
        nb *= 2

    def mtiles():
        return -(-n // imgs) if imgs > 1 else n * -(-ho // th) * -(-wo // tw)

    while nb > 16 and mtiles() * -(-o // nb) < sms:
        nb //= 2
    cc, tg = _round_up(c, 8), kh * kw
    while True:
        geo = _tc_launch(c, kh, kw, th, tw, imgs, nb, cc, tg)
        if geo.smem <= MAX_SMEM_BYTES:
            return geo
        region_big = geo.w_off > MAX_SMEM_BYTES // 4
        if region_big and imgs > 1:
            imgs //= 2
        elif region_big and cc > 8:
            cc = _round_up(cc // 2, 8)
        elif tg > 1:
            tg = -(-tg // 2)
        elif th > 1:
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            return geo


def _launch(x, w_hwio, scale, offset, pads, activation, alpha, dt) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

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
    geo = launch_geometry(n, h, w, c, kh, kw, o, (pt, pb, pl, pr), dt == torch.bfloat16,
                          sm_count(x.device.index))
    if geo.smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv k{kh}x{kw} {c}->{o} does not fit the kernel's shared memory")
    w_int8 = w_hwio.dtype == torch.int8 and dt == torch.bfloat16
    wf = (w_hwio if w_int8 else w_hwio.to(dt)).contiguous()
    sf = scale.float().contiguous()
    of = offset.float().contiguous()
    lib = kernel_lib()
    rc = lib.snn_conv_single(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(), wf.data_ptr(), int(w_int8),
        sf.data_ptr(), of.data_ptr(), n, h, w, c, kh, kw, o, pt, pb, pl, pr,
        ACT_CODES[activation.lower()], float(alpha), int(dt == torch.bfloat16), geo.array,
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
    """Shared memory of one CTA of the f32 form at one input channel per
    chunk, the least it needs: the gate's term, the same for both dtypes
    (the bf16 form fits every conv the gate admits, tests/test_torch_conv.py)."""
    return _f32_launch(kh, kw, 1, o, cc=1).smem


def single_conv_supported(node, in_channels: int,
                          act_dtype: torch.dtype = torch.float32) -> bool:
    """Can the kernel run this Conv2D node at activation dtype `act_dtype`?
    The chain gate's geometry (ops/conv.py kernel_chain_supported) plus an
    activation in its epilogue, float weights or int8 weights under
    bfloat16 (the form that stages them; INT8 engines run bfloat16), and
    the shared memory of one input channel."""
    k = int(node.attr("kernel_size"))
    return (
        kernel_chain_supported(node, in_channels)
        and ("weight_q" not in node.params or act_dtype == torch.bfloat16)
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
