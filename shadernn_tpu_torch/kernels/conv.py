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
rounded to the compute dtype. Under float32 the kernel's products are
3xTF32 on the tensor cores (about float32's accuracy; kernels/tf32.py is
the plain model of that arithmetic) or, in the wide body's form on the CUDA
cores, exact float32. The engine runs on it every conv that AUTO gives the
kernel but no chain takes: a chain of one, or the convs of a chain that
the chain kernel's gate declines.

The kernel has two bodies, and `launch_geometry` picks one per conv: the
tile body (64 output pixels a CTA, the weights staged for each; the k3
convs; under float32 it reads the weight n-major, `nmajor_weight`, which
`prepare` makes once for the caller to keep) and, for kernels of
WIDE_TAPS taps or more (StyleTransfer's 9x9 stem and head), the wide body. Under bfloat16 that is
a persistent grid on the tensor cores whose CTAs stage their channel
block's whole weight once and walk 16x16 tiles through a double-buffered
ring, with an n8 channel block where O <= 8 and, where C < 8, K packed
across the taps of a row. Under float32 it is its form on the CUDA cores
(32-row tiles, a lane's row segment reused over the taps of a row), where
kw is in FMA_KW and the weight fits; any other float32 conv runs on the
tile body. tests/test_torch_conv.py holds plain models of both walks
(`wide_walk`, `fma_walk`).

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

from shadernn_tpu_torch.kernels import count_launch
from shadernn_tpu_torch.kernels.chain import ACT_CODES, MAX_SMEM_BYTES
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import (
    conv2d_nhwc_f32, folded_operands, kernel_chain_supported,
)


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


TC_PIXELS = 64        # output pixels per CTA


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    """Launch geometry of one conv on csrc/conv_single.cu, in the order of
    its G_* fields; byte offsets and sizes, strides in elements. `body`: 0
    the tile body, 1 the wide body on the tensor cores (bfloat16), 2 its
    f32 form on the CUDA cores."""

    tile_h: int
    tile_w: int
    imgs: int       # whole images per CTA (then the tile is the image)
    nb: int         # output channels per CTA
    cc: int         # input channels per chunk
    tg: int         # taps per stage
    in_stride: int  # elements per staged input position
    w_stride: int   # elements per staged weight row
    w_rows: int     # staged weight rows per stage (bf16: k rows; f32: nb, n-major)
    in_off: int
    in_bufs: int
    w_off: int
    w_bufs: int
    smem: int
    # The wide body (body 1; 2: its f32 form on the CUDA cores, fma_geometry):
    # cc is the values per staged position (2: channels per chunk), tg every
    # tap, in_bufs the ring's depth; the tile body (0) leaves these 0.
    body: int = 0
    packed: int = 0     # K packed across taps: a position holds its kw taps' (dx, c)
    wm: int = 0         # warps along M; a CTA computes 32 * wm pixels x nb channels
    tab_off: int = 0    # (2: the block's scale and offset)
    out_off: int = 0
    out_stride: int = 0  # elements per pixel of the output tile
    grid: int = 0        # persistent CTAs per channel block

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _stage_layout(c: int, kh: int, kw: int, th: int, tw: int, imgs: int, nb: int,
                  cc: int, tg: int, bf16: bool) -> ConvLaunch:
    """The shared memory of a CTA: the input region(s) of a chunk, each
    followed by a zero row, then the weights of a stage; rows padded to an
    odd number of 16-byte units (ldmatrix without bank conflicts). bf16:
    bf16 rows of cc channels (+ 8), weights k-major (tg * cc rows of nb).
    f32: f32 rows of cc channels (+ 4), weights n-major (nb rows of tg * cc
    floats, + 4), as ldmatrix has no 32-bit transpose."""
    esz, pad = (2, 8) if bf16 else (4, 4)
    in_stride = cc + pad if (cc // pad) % 2 == 0 else cc
    if bf16:
        w_stride = nb + 8 if (nb // 8) % 2 == 0 else nb
        w_rows = _round_up(tg * cc, 16)
    else:
        w_stride, w_rows = tg * cc + 4, nb
    chunks, groups = -(-c // cc), -(-(kh * kw) // tg)
    in_bufs = 2 if chunks > 1 else 1
    w_bufs = 2 if chunks * groups > 1 else 1
    region = imgs * (th + kh - 1) * (tw + kw - 1)
    w_off = in_bufs * (region + 1) * in_stride * esz
    return ConvLaunch(th, tw, imgs, nb, cc, tg, in_stride, w_stride, w_rows, 0, in_bufs,
                      w_off, w_bufs, w_off + w_bufs * w_rows * w_stride * esz)


WIDE_TAPS = 25         # kernels of at least this many taps run on the wide body
FMA_KW = (5, 7, 9)     # kernel widths of the wide body's f32 form on the CUDA cores
SMEM_PER_SM = 233472   # 228 KB; each resident CTA also takes 1 KB
CTAS_PER_SM = 2        # what the wide body's __launch_bounds__(256, 2) holds the registers to


@functools.lru_cache(maxsize=None)
def launch_geometry(n: int, h: int, w: int, c: int, kh: int, kw: int, o: int,
                    pads: Tuple[int, int, int, int], bf16: bool, sms: int) -> ConvLaunch:
    """The launch of one conv (the kernel's only owner of it; `smem` over
    MAX_SMEM_BYTES means the conv does not fit): the wide body where the
    kernel has at least WIDE_TAPS taps (there the tile body would stage the
    whole weight again for every 64 outputs; PERF.md), under float32 its
    form on the CUDA cores where that takes the conv, else the tile body.
    Speed only: the result does not depend on it."""
    if kh * kw >= WIDE_TAPS:
        if bf16:
            return wide_geometry(n, h, w, c, kh, kw, o, pads, sms)
        if kw in FMA_KW:
            geo = fma_geometry(n, h, w, c, kh, kw, o, pads, sms)
            if geo.smem <= MAX_SMEM_BYTES:
                return geo
    return tile_geometry(n, h, w, c, kh, kw, o, pads, bf16, sms)


@functools.lru_cache(maxsize=None)
def fma_geometry(n: int, h: int, w: int, c: int, kh: int, kw: int, o: int,
                 pads: Tuple[int, int, int, int], sms: int) -> ConvLaunch:
    """The wide body's f32 form on the CUDA cores (body 2): OB channels a
    lane (O itself up to 4, else 8) in g channel groups of warps (one, or
    up to 8 where O > 8), the 8 warps' other factor s segments of PX
    columns (4, or 8 at OB = 8): tiles of 32 rows x s*PX columns. The
    block's weight staged once ([group][dy][c][dx][OBP], OB padded to 4 or
    8); the input in chunks of cc channels, planes of rows padded to an odd
    number of 16-byte units, two buffers: cc as large as 8 while two CTAs
    still fit a SM. `smem` over MAX_SMEM_BYTES: the form does not take the
    conv (its weight too large). Speed only."""
    pt, pb, pl, pr = pads
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    ob = o if o <= 4 else 8
    g = 1
    while g * ob < o and g < 8:
        g *= 2
    px, obp = (8 if ob == 8 else 4), (4 if ob <= 4 else 8)
    s = 8 // g
    tw = s * px
    xn = _round_up(px + kw - 1, 4)
    cstride = _round_up(max(tw + kw - 1, (s - 1) * px + xn), 4)
    if (cstride // 4) % 2 == 0:
        cstride += 4
    rows = 32 + kh - 1
    w_rows, w_stride = g * kh * c, kw * obp
    w_off = _round_up(8 * g * ob, 128)
    in_off = _round_up(w_off + 4 * w_rows * w_stride, 128)
    mtiles = n * -(-ho // 32) * -(-wo // tw)
    cc, bufs = min(c, 8), 2
    while True:
        smem = in_off + bufs * _round_up(4 * cc * rows * cstride, 16)
        if cc > 1 and smem + 1024 > SMEM_PER_SM // 2:
            cc = -(-cc // 2)
        elif bufs == 2 and smem > MAX_SMEM_BYTES:
            bufs = 1
        else:
            break
    return ConvLaunch(32, tw, 1, g * ob, cc, kh * kw, cstride, w_stride, w_rows, in_off, bufs,
                      w_off, 1, smem, 2, 0, s, 0, 0, 0,
                      max(1, min(mtiles, sms * _ctas_per_sm(smem) // -(-o // (g * ob)))))


def _wide_layout(c: int, kh: int, kw: int, th: int, tw: int, nb: int, bufs: int,
                 packed: bool, mtiles: int, blocks: int, sms: int) -> ConvLaunch:
    """The wide body's shared memory (bf16): the table of unit offsets and
    the channel block's scale and offset, the block's whole weight (k-major,
    rows of nb), `bufs` input regions
    (positions of kp values: C, or packed kw*C, rounded up to 8), the
    output tile and, packed, the region's rows as NHWC holds them. Rows
    padded to an odd number of 16-byte units (ldmatrix without bank
    conflicts). Every warp on M up to 32 channels, then the warps spread
    over N. The grid: one wave, at most CTAS_PER_SM a SM, shared among the
    `blocks` channel blocks, no more than the tiles."""
    esz, epu = 2, 8
    wm = 8 if nb <= 32 else 256 // nb
    kp = _round_up(kw * c if packed else c, 8)
    units = (kh if packed else kh * kw) * (kp // 8)
    in_stride = kp + epu if (kp // epu) % 2 == 0 else kp
    w_rows, w_stride = _round_up(units * 8, 16), (nb + 8 if (nb // 8) % 2 == 0 else nb)
    region = (th + kh - 1) * (tw if packed else tw + kw - 1)
    tab = _round_up(4 * (units + 1), 16) + 8 * nb  # then the block's scale and offset
    w_off = _round_up(tab, 128)
    in_off = _round_up(w_off + w_rows * w_stride * esz, 128)
    out_off = _round_up(in_off + bufs * _round_up(region * in_stride * esz, 16), 128)
    out_stride = nb + epu
    smem = out_off + 32 * wm * out_stride * esz
    if packed:  # then the region's rows as NHWC holds them, expanded into positions
        smem = _round_up(smem, 16) + (th + kh - 1) * (tw + kw - 1) * c * esz
    return ConvLaunch(th, tw, 1, nb, kp, kh * kw, in_stride, w_stride, w_rows, in_off, bufs,
                      w_off, 1, smem, 1, int(packed), wm, 0, out_off, out_stride,
                      max(1, min(mtiles, sms * _ctas_per_sm(smem) // blocks)))


def _ctas_per_sm(smem: int) -> int:
    return max(1, min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024)))


def _wide_tile(bm: int, ho: int, wo: int) -> Tuple[int, int]:
    """A near-square tile of bm pixels (16x16, 8x16, 8x8, 4x8, ...; columns a
    power of two, at least 8), no wider or taller than the output needs."""
    tw = 8
    while tw * tw < bm:
        tw *= 2
    while tw > 8 and tw >= 2 * wo:
        tw //= 2
    return max(1, min(bm // tw, ho)), tw


@functools.lru_cache(maxsize=None)
def wide_geometry(n: int, h: int, w: int, c: int, kh: int, kw: int, o: int,
                  pads: Tuple[int, int, int, int], sms: int) -> ConvLaunch:
    """The wide body's launch (bf16): K packed across taps where C < 8; the
    smallest channel block of 8-128 that covers O (n8 where O <= 8), its
    whole weight staged once per CTA; tiles of 32 * wm pixels (16x16 up to
    32 channels) through a ring of two buffers, or of one where that lets
    two CTAs share a SM (tools/sweep_launch.py --only wide on an H100: the
    head's launch 0.305 ms at two CTAs with one buffer against 0.352 at one
    with two; the stem 0.174 packed against 0.267 not; PERF.md).
    Until it fits in 227 KB: half the tile, then a block of half the
    channels, then (C >= 8) K packed; at the last, smaller tiles at n8 with
    one buffer. Speed only: the result does not depend on it."""
    pt, pb, pl, pr = pads
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    nb0 = 8
    while nb0 < o:
        nb0 *= 2
    geos = []
    for packed in ((True,) if c < 8 else (False, True)):
        nb = nb0
        while True:
            wm = 8 if nb <= 32 else 256 // nb
            for bm in (32 * wm, 16 * wm):
                th, tw = _wide_tile(bm, ho, wo)
                geos = [_wide_layout(c, kh, kw, th, tw, nb, bufs, packed,
                                     n * -(-ho // th) * -(-wo // tw), -(-o // nb), sms)
                        for bufs in (2, 1)]
                fits = [geo for geo in geos if geo.smem <= MAX_SMEM_BYTES]
                if fits:  # the ring of two, unless one buffer lets more CTAs share a SM
                    return max(fits, key=lambda g: (_ctas_per_sm(g.smem), g.in_bufs))
            if nb == 8:
                break
            nb //= 2
    geo = geos[-1]  # packed, n8, one buffer
    th, tw = geo.tile_h, geo.tile_w
    while th * tw > 1:  # the last resort: smaller tiles
        th, tw = (th, -(-tw // 2)) if tw > th else (-(-th // 2), tw)
        geo = _wide_layout(c, kh, kw, th, tw, 8, 1, True,
                           n * -(-ho // th) * -(-wo // tw), -(-o // 8), sms)
        if geo.smem <= MAX_SMEM_BYTES:
            break
    return geo


@functools.lru_cache(maxsize=None)
def tile_geometry(n: int, h: int, w: int, c: int, kh: int, kw: int, o: int,
                  pads: Tuple[int, int, int, int], bf16: bool, sms: int) -> ConvLaunch:
    """The tile body's launch, one rule for both forms:
    64 output pixels per CTA (an 8x8 tile, or as many whole images as fit
    when an image has at most 32 pixels); the smallest channel block of
    16-128 that covers O, halved while the grid has fewer CTAs than the
    card has SMs (f32: and while the halved grid still runs in one wave,
    its larger stages holding fewer CTAs per SM: a sweep of the ResNet18
    convs on an H100, PERF.md); every input channel and every tap in one
    stage (a stage costs more than its products at these sizes). Until the
    stage fits in 227 KB: fewer images or a smaller chunk while the input
    region alone takes over a quarter of it, else tap groups halved; at
    one tap, a smaller tile. Speed only: the result does not depend on it."""
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

    def one_wave(nb_):  # f32: the grid of a block of nb_ channels runs in one wave
        smem = _stage_layout(c, kh, kw, th, tw, imgs, nb_, _round_up(c, 8), kh * kw, False).smem
        return mtiles() * -(-o // nb_) <= sms * max(1, MAX_SMEM_BYTES // smem)

    while nb > 16 and mtiles() * -(-o // nb) < sms and (bf16 or one_wave(nb // 2)):
        nb //= 2
    cc, tg = _round_up(c, 8), kh * kw
    while True:
        geo = _stage_layout(c, kh, kw, th, tw, imgs, nb, cc, tg, bf16)
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


def nmajor_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """The f32 tile body's weight: (O, kh*kw*C8) float32, row o holding
    w[:, :, :, o] tap by tap with C zero-padded to a multiple of 8 (k
    contiguous: ldmatrix has no 32-bit transpose)."""
    kh, kw, c, o = w_hwio.shape
    wn = torch.nn.functional.pad(w_hwio.float().permute(3, 0, 1, 2), (0, -c % 8))
    return wn.reshape(o, -1).contiguous()


@dataclasses.dataclass(frozen=True)
class ConvOperands:
    """A conv's operands as its launch reads them (`prepare`): the HWIO
    weight in the compute dtype (an int8 weight under bfloat16 as it is),
    under float32 also its n-major form (`nmajor_weight`, what the tile
    body reads), and the float32 scale and offset."""

    w: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    dtype: torch.dtype
    nmajor: Optional[torch.Tensor] = None


def prepare(w_hwio: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
            compute_dtype: torch.dtype) -> ConvOperands:
    """The launch's operands of one conv in the compute dtype's form."""
    bf16 = compute_dtype == torch.bfloat16
    w = (w_hwio if w_hwio.dtype == torch.int8 and bf16 else w_hwio.to(compute_dtype)).contiguous()
    return ConvOperands(w, scale.float().contiguous(), offset.float().contiguous(),
                        compute_dtype, None if bf16 else nmajor_weight(w))


def check_launch(x, w_hwio, scale, offset, activation) -> Tuple[int, int, int, int]:
    """What a launch of either conv kernel checks: x float32 or bfloat16,
    NHWC and contiguous; an HWIO weight over its C; O scales and offsets;
    every operand on x's device; an activation of the epilogue. Returns
    (kh, kw, c, o)."""
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
    if str(activation or "linear").lower() not in ACT_CODES:
        raise ValueError(f"activation {activation!r} is not in the kernel's epilogue")
    return kh, kw, c, o


def _launch(x, ops: ConvOperands, pads, activation, alpha) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

    dt = ops.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv compute dtype must be float32 or bfloat16, got {dt}")
    kh, kw, c, o = check_launch(x, ops.w, ops.scale, ops.offset, activation)
    pt, pb, pl, pr = (int(p) for p in pads)
    n, h, w, _ = x.shape
    y = torch.empty((n, h + pt + pb - kh + 1, w + pl + pr - kw + 1, o), dtype=dt,
                    device=x.device)
    if n == 0:
        return y
    bf16 = dt == torch.bfloat16
    geo = launch_geometry(n, h, w, c, kh, kw, o, (pt, pb, pl, pr), bf16, sm_count(x.device.index))
    if geo.smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv k{kh}x{kw} {c}->{o} does not fit the kernel's shared memory")
    # HWIO in the compute dtype (or int8); the tile body's f32: n-major
    wf = ops.w if bf16 or geo.body == 2 else ops.nmajor
    lib = kernel_lib()
    rc = lib.snn_conv_single(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(), wf.data_ptr(),
        int(ops.w.dtype == torch.int8), ops.scale.data_ptr(), ops.offset.data_ptr(),
        n, h, w, c, kh, kw, o, pt, pb, pl, pr,
        ACT_CODES[activation.lower()], float(alpha), int(bf16), geo.array,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv_single launch failed ({rc}): {lib.snn_conv_single_error(rc).decode()}"
        )
    count_launch("fused_conv2d_haloed", geo.body + 1 if geo.body else 0 if bf16 else 1)
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
    for a CPU tensor; the operands prepared on this call."""
    dt = compute_dtype or (torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32)
    return run(x, prepare(w_hwio, scale, offset, dt), pads, activation, alpha)


def run(x: torch.Tensor, ops: ConvOperands, pads: Sequence[int] = (0, 0, 0, 0),
        activation: str = "linear", alpha: float = 0.3) -> torch.Tensor:
    """`fused_conv2d_haloed` on operands that `prepare` made."""
    if x.device.type == "cuda":
        return _launch(x, ops, pads, activation, alpha)
    if x.device.type == "cpu":
        return conv2d_haloed_reference(x, ops.w, ops.scale, ops.offset, pads, activation, alpha,
                                       ops.dtype)
    raise ValueError(f"no single-conv kernel for device {x.device}")


def smem_bytes(kh: int, kw: int, o: int) -> int:
    """The gate's shared-memory term, the same for both forms: what the
    kernel's first f32 form (CUDA cores, one output pixel and 1, 4 or 8
    channels per thread, at most 32 channels per CTA) took at one input
    channel per chunk, kept as that formula so that the gate admits the
    convs it always admitted. Both forms fit every conv it admits
    (tests/test_torch_conv.py)."""
    ch = 8 if o > 4 else (4 if o > 1 else 1)
    ob = min(_round_up(o, ch), 32)
    tile_w = 16 if 256 // (ob // ch) >= 128 else 8
    tile_h = 256 // (ob // ch) // tile_w
    return 4 * (_round_up((tile_h + kh - 1) * (tile_w + kw - 1), 4) + kh * kw * ob)


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
                    operands: Optional[ConvOperands] = None) -> torch.Tensor:
    """A Conv2D node on the kernel (counterpart of ops/conv.py
    conv_run_pallas_chain); `operands`: `prepare`'s of ops/conv.py
    folded_operands where the caller keeps them, else made on this call."""
    operands = operands or prepare(*folded_operands(node, compute_dtype), compute_dtype)
    pads = padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size")))
    return run(x, operands, pads,
               str(node.attr("activation", "linear")), float(node.attr("leaky_alpha", 0.3)))
