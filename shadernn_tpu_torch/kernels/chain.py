"""Fused stride-1 conv chain: the hand-written CUDA kernel
(csrc/conv_chain.cu), its wrapper, its plan and its plain PyTorch version.

One kernel ports the two TPU chain kernels of the JAX package, which
compute the same function in two TPU layouts:
`shadernn_tpu/kernels/chain_packed_pallas.py` (`_packed_kernel`, entry
point `fused_conv_chain_packed`) and `shadernn_tpu/kernels/chain_pallas.py`
(`_chain_kernel`, entry point `fused_conv_chain`). Both entry points are
kept under their JAX names and launch the one kernel.

The function, at the tensor boundary: NHWC input (float32 or bfloat16,
cast to the compute dtype), per layer an HWIO weight in the compute dtype
or int8 (exact in both; its scale folded into `scale`), a float32
accumulation and `act(acc * scale + offset)` in float32, each
intermediate zero outside the image and rounded to the compute dtype.
Tails: "none" -> (N,H,W,o); "c1" (o=1) -> (N,H,W,1); "d2s2" (o=4) ->
(N,2H,2W,1) through depth_to_space(2) in TF channel order.

A8 (the JAX kernel's int8 `in_q` dots, bf16 form only): a layer with
`in_q > 0` takes an int8 input and int8 weights, sums int8 x int8 in
int32 (exact) and folds `in_q` into its float32 scale. Its producer
writes `clip(rint(y * (1/in_q)), +-127)` from the float32 value after the
activation (the layer before's epilogue, or the frame itself for the
head), rounding half to even with 1/in_q a float32 constant. `a8_scales`
is the plan: which layers get an `in_q`, and why the others do not.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
(tests) it runs `conv_chain_reference`. Both forms run on the tensor cores
with a launch geometry that this module owns (`launch_geometry` for bf16,
`f32_launch_geometry` for f32: the tile, the region strides, the
shared-memory layout, which layers pack their taps densely, whether the
weights stay resident) and weights packed here into the kernel's B images
(`pack_params`, `pack_params_f32`); the C entry point checks the geometry
and launches. The f32 form is 3xTF32 (kernels/tf32.py is the plain model
of that arithmetic): its B images come split into TF32 hi and lo, and
each layer's epilogue writes the next layer's input split. The gate's
shared-memory term (`smem_bytes`) is the layout of the first f32 form, on
the CUDA cores with a fixed 16 x 32 tile, kept as a formula so that the
gate admits what it always admitted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import List, Optional, Sequence, Tuple

import torch

from shadernn_tpu_torch.kernels import count_launch
from shadernn_tpu_torch.kernels.tf32 import tf32_split
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import (
    conv2d_nhwc_f32, conv2d_nhwc_int8, epilogue_scale_offset, quantize_act,
)
from shadernn_tpu_torch.ops.shape_ops import depth_to_space

# The tile of the gate's term (`smem_bytes`, rows, columns) and the
# kernel's limits; the limits must agree with csrc/conv_chain.cu.
TILE_H, TILE_W = 16, 32
MAX_LAYERS = 8
MAX_K = 9
MAX_O = 32
MAX_SMEM_BYTES = 232448  # 227 KB, what one block may use on Hopper
ACT_CODES = {
    "linear": 0, "": 0, "none": 0, "identity": 0,
    "relu": 1, "relu6": 2,
    "leaky_relu": 3, "leakyrelu": 3, "leaky relu": 3,
    "tanh": 4, "sigmoid": 5, "silu": 6, "swish": 6, "gelu": 7,
}
TAILS = {"none": 0, "c1": 1, "d2s2": 2}

@dataclasses.dataclass(frozen=True)
class ChainLayerSpec:
    """Static description of one conv of the chain."""

    k: int
    c: int  # input channels
    o: int  # output channels
    pt: int
    pb: int
    pl: int
    pr: int
    activation: str
    alpha: float
    # Dequantization scale of this layer's int8 input (x ~ x_q * in_q);
    # 0.0: the input stays in the compute dtype.
    in_q: float = 0.0


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _halo(specs: Sequence[ChainLayerSpec]):
    """Accumulated pads of the layers from l on: top, bottom, left, right
    (lists of len(specs) + 1)."""
    n = len(specs)
    a, b, lft, rgt = ([0] * (n + 1) for _ in range(4))
    for l in range(n - 1, -1, -1):
        s = specs[l]
        a[l] = a[l + 1] + s.pt
        b[l] = b[l + 1] + s.k - 1 - s.pt
        lft[l] = lft[l + 1] + s.pl
        rgt[l] = rgt[l + 1] + s.k - 1 - s.pl
    return a, b, lft, rgt


def smem_bytes(specs: Sequence[ChainLayerSpec], tile_h: int = TILE_H,
               tile_w: int = TILE_W) -> int:
    """The gate's shared-memory term for both forms: what one CTA of the
    first f32 form took (CUDA cores, channel-planar f32 regions, a 16 x 32
    tile): staged weights and scale/offset, then two ping-pong region
    buffers. Both tensor-core forms fit every chain it admits
    (tests/test_torch_chain.py)."""
    a, b, lft, rgt = _halo(specs)
    floats = 0
    buf = [0, 0]
    for l, s in enumerate(specs):
        ch = 8 if s.o > 4 else (4 if s.o > 1 else 1)
        o_pad = -(-s.o // ch) * ch
        floats += _round4(o_pad * s.k * s.k * s.c) + _round4(2 * o_pad)
        region = s.c * (tile_h + a[l] + b[l]) * (tile_w + lft[l] + rgt[l])
        buf[l % 2] = max(buf[l % 2], region)
    return 4 * (floats + _round4(buf[0]) + _round4(buf[1]))


def build_chain_specs(
    views,
    in_channels: int,
    act_dtype: torch.dtype,
    act_override: Optional[Tuple[str, float]] = None,
    tail: str = "none",
) -> Optional[List[ChainLayerSpec]]:
    """Plan a run of Conv2D nodes for the kernel, or None where the kernel
    cannot take it: stride != 1, k > 9, o > 32, an activation outside the
    kernel's epilogue, more than 8 layers, or shared memory over 227 KB.
    Float and int8 weights alike (`a8_scales` adds the int8 dots).
    `act_override` = (name, alpha) replaces the last layer's activation
    with a folded one (e.g. ESPCN's post-subpixel tanh)."""
    if act_dtype not in (torch.float32, torch.bfloat16) or tail not in TAILS:
        return None
    if not 1 <= len(views) <= MAX_LAYERS:
        return None
    specs: List[ChainLayerSpec] = []
    c = in_channels
    for idx, node in enumerate(views):
        if int(node.attr("stride", 1)) != 1:
            return None
        k = int(node.attr("kernel_size"))
        o = int(node.attr("out_channels"))
        if k > MAX_K or o > MAX_O:
            return None
        act = str(node.attr("activation", "linear"))
        alpha = float(node.attr("leaky_alpha", 0.3))
        if act_override is not None and idx == len(views) - 1:
            act, alpha = act_override
        if act.lower() not in ACT_CODES:
            return None
        pt, pb, pl, pr = padding_offsets(node.attr("padding", "same"), k)
        specs.append(ChainLayerSpec(k, c, o, pt, pb, pl, pr, act.lower(), alpha))
        c = o
    if (tail == "c1" and c != 1) or (tail == "d2s2" and c != 4):
        return None
    if smem_bytes(specs) > MAX_SMEM_BYTES:
        return None
    return specs


# The input range of a layer after each bounded activation (|y| <= 1 or
# 0 <= y <= 6): an int8 step that needs no calibration.
_BOUNDED_STEP = {"tanh": 1.0 / 127.0, "sigmoid": 1.0 / 127.0, "relu6": 6.0 / 127.0}


def a8_scales(views, specs: Sequence[ChainLayerSpec], head_from_frame: bool):
    """The JAX package's per-layer a8 rule (chain_packed_pallas.
    build_chain_packed(a8=True)): a layer's dot runs int8 x int8 where its
    weights are int8, its C is a multiple of 8 and its input range is
    bounded: the previous layer's tanh, sigmoid or relu6, else a calibrated
    `in_act_scale`, and for the head the model frame ([0, 1], step 1/127)
    when an InputLayer feeds it (`head_from_frame`). Unlike the JAX
    package, a head that a mid-graph value feeds gets no such step without
    calibration (its range is not the frame's). Returns (specs with
    `in_q` set, [(layer, in_q or 0.0, why)])."""
    out, notes = list(specs), []
    for l, (node, s) in enumerate(zip(views, specs)):
        calibrated = float(node.attr("in_act_scale", 0.0) or 0.0)
        if "weight_q" not in node.params:
            notes.append((node.name, 0.0, "float weights"))
            continue
        if s.c % 8:
            notes.append((node.name, 0.0, f"C = {s.c} is not a multiple of 8"))
            continue
        if l == 0:
            q = calibrated or (1.0 / 127.0 if head_from_frame else 0.0)
            why = ("calibrated in_act_scale" if calibrated else
                   "the model frame's range [0, 1]" if q else
                   "a mid-graph head without a calibrated in_act_scale")
        else:
            prev = specs[l - 1].activation
            q = _BOUNDED_STEP.get(prev, calibrated)
            why = (f"bounded by the previous {prev}" if prev in _BOUNDED_STEP else
                   "calibrated in_act_scale" if q else
                   f"input after {prev} without a calibrated in_act_scale")
        if q > 0.0:
            out[l] = dataclasses.replace(s, in_q=q)
        notes.append((node.name, q, why))
    return out, notes


def chain_operands(views, compute_dtype: torch.dtype,
                   specs: Optional[Sequence[ChainLayerSpec]] = None) -> List[dict]:
    """Per-layer kernel operands: weight "w" (HWIO, the compute dtype, or
    the int8 weight as it is) and the folded float32 "scale"/"offset" (the
    int8 scale, bias, BatchNorm; times `in_q` for a layer with an int8
    input)."""
    out = []
    for l, node in enumerate(views):
        scale, offset = epilogue_scale_offset(node)
        if specs is not None and specs[l].in_q > 0.0:
            scale = scale * specs[l].in_q
        if "weight_q" in node.params:
            w = torch.as_tensor(node.params["weight_q"])
        else:
            w = torch.as_tensor(node.params["weight"]).to(compute_dtype)
        out.append({"w": w, "scale": scale, "offset": offset})
    return out


def _out_hw(h: int, w: int, specs: Sequence[ChainLayerSpec]) -> Tuple[int, int]:
    for s in specs:
        h = h + s.pt + s.pb - s.k + 1
        w = w + s.pl + s.pr - s.k + 1
    return h, w


# ---------------------------------------------------------------- bf16 ----
# The tensor-core form: every layer an implicit GEMM (M = pixels of its
# output region, N = o padded to 8, K = taps x C) on mma.sync m16n8k16.

TC_THREADS = 256
SMEM_PER_SM = 233472  # 228 KB; each resident CTA also takes 1 KB


@dataclasses.dataclass(frozen=True)
class TcLayer:
    """The tile-independent layout of one layer in the bf16 form. A layer
    with a bf16 input runs m16n8k16 bf16 products; one with an int8 input
    (`q8`, an `in_q`) m16n8k32 s8 products."""

    dense: bool   # C < 8: taps packed densely, K = round16(k*k*C)
    cs: int       # per staged input position, in elements of the input (bf16,
                  # or int8 bytes): C (dense), or C padded to units of 16 bytes
                  # (8 bf16 or 16 int8) and to an odd number of units (ldmatrix rows)
    ksteps: int   # k16 (bf16) or k32 (int8) steps of K
    nt: int       # n8-tiles: o padded to 8
    ostride: int  # bf16: elements per B row (k-major B), nt * 8 padded to an odd
                  # number of 16-byte units; int8: bytes per B row (n-major B, K
                  # contiguous), 32 * ksteps plus one 16-byte unit
    q8: bool = False

    @property
    def esize(self) -> int:
        return 1 if self.q8 else 2

    @property
    def w_bytes(self) -> int:
        if self.q8:
            return 8 * self.nt * self.ostride
        return self.ksteps * 16 * self.ostride * 2

    @property
    def ktab_bytes(self) -> int:
        """The table of K offsets: one per K index (dense), else one per
        16-byte unit."""
        return (64 if self.dense else 8) * self.ksteps


def tc_layers(specs: Sequence[ChainLayerSpec]) -> List[TcLayer]:
    out = []
    for s in specs:
        nt = -(-s.o // 8)
        if s.in_q > 0.0:  # int8 input, C a multiple of 8: units of 16 channels
            units = -(-s.c // 16)
            ksteps = -(-(s.k * s.k * units) // 2)
            out.append(TcLayer(False, 16 * (units + 1 - units % 2), ksteps, nt,
                               32 * ksteps + 16, True))
            continue
        dense, units = s.c < 8, -(-s.c // 8)
        cs = s.c if dense else 8 * (units + 1 - units % 2)
        ksteps = -(-(s.k * s.k * s.c) // 16) if dense else -(-(s.k * s.k * units) // 2)
        ostride = 8 * nt + (8 if nt % 2 == 0 else 0)
        out.append(TcLayer(dense, cs, ksteps, nt, ostride))
    return out


def param_layout(specs: Sequence[ChainLayerSpec]) -> Tuple[List[Tuple[int, int]], int]:
    """Byte offsets of each layer's B image and scale|offset (f32, nt * 8
    each) in the packed parameters, and their total size."""
    offs, cur = [], 0
    for tl in tc_layers(specs):
        offs.append((cur, cur + tl.w_bytes))
        cur += tl.w_bytes + 64 * tl.nt
    return offs, cur


def regions(specs: Sequence[ChainLayerSpec], tile_h: int, tile_w: int):
    """(rows, cols) of each layer's input region for a tile of final
    outputs; layer l's output region is layer l + 1's input region."""
    a, b, lft, rgt = _halo(specs)
    return [(tile_h + a[l] + b[l], tile_w + lft[l] + rgt[l]) for l in range(len(specs) + 1)]


@dataclasses.dataclass(frozen=True)
class ChainLaunch:
    """Launch geometry of the bf16 form, in the order of the CG_* fields
    of csrc/conv_chain.cu, then CL_* per layer; byte offsets."""

    tile_h: int
    tile_w: int
    threads: int
    w_all: int        # 1: every layer's weights resident; 0: one buffer, staged per layer
    buf0: int         # ping-pong regions: layer l reads buf[l % 2], writes the other
    buf1: int
    smem: int
    param_bytes: int
    # (cs, ostride, w_off, ktab_off, pw, ps, q8) per layer
    layers: Tuple[Tuple[int, int, int, int, int, int, int], ...]

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = [self.tile_h, self.tile_w, self.threads, self.w_all, self.buf0, self.buf1,
                  self.smem, self.param_bytes] + [v for l in self.layers for v in l]
        return (ctypes.c_int * len(fields))(*fields)


def _align(v: int, m: int = 128) -> int:
    return -(-v // m) * m


def _tc_launch(specs: Sequence[ChainLayerSpec], tile_h: int, tile_w: int,
               w_all: bool, threads: int = TC_THREADS) -> ChainLaunch:
    """Shared memory: each layer's table of K offsets, the weights (each
    layer's, or one buffer of the largest), then the two region buffers."""
    tls = tc_layers(specs)
    regs = regions(specs, tile_h, tile_w)
    cur, ktab = 0, []
    for tl in tls:
        ktab.append(cur)
        cur += _align(tl.ktab_bytes, 16)
    cur = _align(cur)
    w_off = []
    for tl in tls:
        w_off.append(cur)
        if w_all:
            cur = _align(cur + tl.w_bytes)
    if not w_all:
        cur = _align(cur + max(tl.w_bytes for tl in tls))
    need = [0, 0]
    for l, tl in enumerate(tls):
        rows, cols = regs[l]
        need[l % 2] = max(need[l % 2], tl.esize * rows * cols * tl.cs)
    buf0 = cur
    buf1 = _align(buf0 + need[0])
    offs, pbytes = param_layout(specs)
    return ChainLaunch(
        tile_h, tile_w, threads, int(w_all), buf0, buf1, buf1 + need[1], pbytes,
        tuple((tl.cs, tl.ostride, w_off[l], ktab[l], *offs[l], int(tl.q8))
              for l, tl in enumerate(tls)))


def _tc_cost(specs: Sequence[ChainLayerSpec], geo: ChainLaunch, n: int, ho: int, wo: int,
             sms: int) -> float:
    """Modelled time of a launch: waves of CTAs times the work of the CTAs
    that share an SM (per m16 tile and k16 step, one A fragment and nt
    products; staging the input region), fewer than 16 resident warps per
    SM hiding less latency (fitted to tile sweeps on the card, PERF.md)."""
    tls = tc_layers(specs)
    regs = regions(specs, geo.tile_h, geo.tile_w)
    work = sum(-(-(regs[l + 1][0] * regs[l + 1][1]) // 16) * tl.ksteps * (tl.nt + 1)
               for l, tl in enumerate(tls))
    work += regs[0][0] * regs[0][1] * max(1, tls[0].cs // 8) / 8
    ctas = n * -(-ho // geo.tile_h) * -(-wo // geo.tile_w)
    per_sm = max(1, min(2, SMEM_PER_SM // (geo.smem + 1024)))
    waves = -(-ctas // (sms * per_sm))
    warps = per_sm * geo.threads // 32
    return waves * work * per_sm / min(1.0, warps / 16 + 0.25)


@functools.lru_cache(maxsize=None)
def launch_geometry(specs: Tuple[ChainLayerSpec, ...], n: int, h: int, w: int,
                    sms: int) -> ChainLaunch:
    """The bf16 launch of a chain (the kernel's only owner of it): the
    tile of least modelled time (`_tc_cost`) among tiles of 1-64 rows and
    8-128 columns, each cut to the output, whose shared memory fits with
    every layer's weights resident, else with the weights staged layer by
    layer; at worst a 1 x 1 tile. 256 threads, 512 where a tile's shared
    memory leaves room for one CTA per SM. Speed only: the result does
    not depend on it."""
    ho, wo = _out_hw(h, w, specs)
    tiles = {(min(th, ho), min(tw, wo)) for th in (1, 2, 4, 8, 16, 32, 64)
             for tw in (8, 16, 32, 64, 128) if th * tw <= 4096}
    for w_all in (True, False):
        fits = []
        for th, tw in tiles:
            g = _tc_launch(specs, th, tw, w_all)
            if g.smem + 1024 > SMEM_PER_SM // 2:  # one CTA per SM: twice the warps
                g = _tc_launch(specs, th, tw, w_all, 2 * TC_THREADS)
            if g.smem <= MAX_SMEM_BYTES:
                fits.append(g)
        if fits:
            return min(fits, key=lambda g: (_tc_cost(specs, g, n, ho, wo, sms),
                                            -g.tile_h * g.tile_w))
    return _tc_launch(specs, 1, 1, False)


def pack_params(layer_params: List[dict], specs: Sequence[ChainLayerSpec]) -> torch.Tensor:
    """The bf16 form's parameters as one byte tensor (`param_layout`): per
    layer the B image, then scale and offset (float32, zeros past o). A
    bf16 layer's B image has K rows in the kernel's order (tap-major; C
    padded to 8 per unit unless the layer packs its taps densely) padded to
    whole k16 steps, `ostride` columns, zeros past o; int8 weights become
    bf16 here, exactly. An int8 layer's B image is n-major (ldmatrix has no
    8-bit transpose): one row of `ostride` bytes per output channel, K in
    the kernel's order (tap-major, C padded to 16 per unit) padded to whole
    k32 steps, zero rows past o."""
    chunks = []
    pad = torch.nn.functional.pad
    for p, s, tl in zip(layer_params, specs, tc_layers(specs)):
        if tl.q8:
            if p["w"].dtype != torch.int8:
                raise TypeError(f"a layer with an int8 input takes int8 weights, "
                                f"got {p['w'].dtype}")
            w = pad(p["w"], (0, 0, 0, -s.c % 16)).reshape(-1, s.o)
            w = pad(w, (0, 0, 0, 32 * tl.ksteps - w.shape[0])).t()
            w = pad(w, (0, tl.ostride - w.shape[1], 0, 8 * tl.nt - s.o))
        else:
            w = p["w"].to(torch.bfloat16)
            if not tl.dense:
                w = pad(w, (0, 0, 0, -s.c % 8))
            w = w.reshape(-1, s.o)
            w = pad(w, (0, tl.ostride - s.o, 0, 16 * tl.ksteps - w.shape[0]))
        so = torch.zeros((2, 8 * tl.nt), dtype=torch.float32, device=w.device)
        so[0, :s.o] = p["scale"].float().reshape(-1)
        so[1, :s.o] = p["offset"].float().reshape(-1)
        chunks += [w.contiguous().view(torch.uint8).reshape(-1), so.view(torch.uint8).reshape(-1)]
    return torch.cat(chunks)


# ----------------------------------------------------------------- f32 ----
# The 3xTF32 form: the same implicit GEMM on mma.sync m16n8k8 tf32, every
# region held as its TF32 hi and lo parts, B n-major and split on the host.

F32_PASS = 2  # most n8-tiles of a pass (csrc/conv_chain.cu run_f32_layer NG)


@dataclasses.dataclass(frozen=True)
class F32Layer:
    """The tile-independent layout of one layer in the f32 form."""

    dense: bool   # C < 8: taps packed densely, K = round8(k*k*C)
    cs: int       # floats per staged input position: C (dense), or C padded to
                  # units of 8 plus 4 (an odd number of 16-byte units: ldmatrix rows)
    ksteps: int   # k8 steps of K
    nt: int       # n8-tiles: o padded to 8
    ostride: int  # floats per n-major B row: 8 * ksteps + 4 (an odd number of units)
    kp: int       # k8 steps whose products sum before they join the f32 sums:
                  # one tap (C / 8 units), dense 4 (32 K indices)

    @property
    def image_bytes(self) -> int:
        """One B image (hi or lo) of the whole layer."""
        return 8 * self.nt * self.ostride * 4

    @property
    def ktab_bytes(self) -> int:
        """The table of K offsets: one per K index (dense), else one per k8 step."""
        return 4 * (8 * self.ksteps if self.dense else self.ksteps)


def f32_layers(specs: Sequence[ChainLayerSpec]) -> List[F32Layer]:
    out = []
    for s in specs:
        units = -(-s.c // 8)
        dense = s.c < 8
        ksteps = -(-(s.k * s.k * s.c) // 8) if dense else s.k * s.k * units
        out.append(F32Layer(dense, s.c if dense else 8 * units + 4, ksteps, -(-s.o // 8),
                            8 * ksteps + 4, 4 if dense else units))
    return out


def f32_param_layout(specs: Sequence[ChainLayerSpec]) -> Tuple[List[Tuple[int, ...]], int]:
    """Byte offsets of each layer's B hi image, B lo image, B image of f32
    values and scale|offset (f32, nt * 8 each) in the f32 form's packed
    parameters, and their total size."""
    offs, cur = [], 0
    for fl in f32_layers(specs):
        offs.append(tuple(cur + i * fl.image_bytes for i in range(4)))
        cur += 3 * fl.image_bytes + 64 * fl.nt
    return offs, cur


def pack_params_f32(layer_params: List[dict], specs: Sequence[ChainLayerSpec]):
    """The f32 form's parameters as one byte tensor (`f32_param_layout`)
    and, per layer, whether its B lo image is read. A layer's B image is
    n-major: one row of `ostride` floats per output channel (zero rows past
    o), K in the kernel's order (tap-major; C padded to 8 per unit unless
    the layer packs its taps densely) padded to whole k8 steps, split into
    its TF32 hi and lo images (kernels/tf32.py), then the f32 values
    themselves (what a pass stages where hi and lo do not fit); int8
    weights become float32 exactly and have no lo (b_lo 0: the pass is
    skipped), as has any weight exact in TF32."""
    chunks, b_lo = [], []
    pad = torch.nn.functional.pad
    for p, s, fl in zip(layer_params, specs, f32_layers(specs)):
        w = p["w"].float()
        if not fl.dense:
            w = pad(w, (0, 0, 0, -s.c % 8))
        w = w.reshape(-1, s.o).t()
        w = pad(w, (0, fl.ostride - w.shape[1], 0, 8 * fl.nt - s.o))
        hi, lo = tf32_split(w)
        b_lo.append(int(bool(lo.any())))
        so = torch.zeros((2, 8 * fl.nt), dtype=torch.float32, device=w.device)
        so[0, :s.o] = p["scale"].float().reshape(-1)
        so[1, :s.o] = p["offset"].float().reshape(-1)
        chunks += [t.contiguous().view(torch.uint8).reshape(-1) for t in (hi, lo, w, so)]
    return torch.cat(chunks), tuple(b_lo)


@dataclasses.dataclass(frozen=True)
class ChainF32Launch:
    """Launch geometry of the f32 form, in the order of the CG_* fields of
    csrc/conv_chain.cu, then CF_* per layer; byte offsets."""

    tile_h: int
    tile_w: int
    threads: int
    w_all: int        # 1: every layer's B images resident; 0: one buffer, staged per pass
    buf0: int         # ping-pong regions (hi, then lo): layer l reads buf[l % 2]
    buf1: int
    smem: int
    param_bytes: int
    grid: int         # persistent CTAs: CTA b takes tiles b, b + grid, ...
    raw_off: int      # the frame buffer: the next tile's input, fetched while one computes
    # (cs, ostride, ng, w_off, ktab_off, pw, pw_lo, ps, reg, kp, b_raw, pw_raw) per
    # layer; ng: n8-tiles per pass, reg: bytes of the layer's hi input region
    # (its lo follows), b_raw: B staged as f32 values and split in registers
    layers: Tuple[Tuple[int, ...], ...]

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = [self.tile_h, self.tile_w, self.threads, self.w_all, self.buf0, self.buf1,
                  self.smem, self.param_bytes, self.grid, self.raw_off] + [
                      v for l in self.layers for v in l]
        return (ctypes.c_int * len(fields))(*fields)


def _f32_launch(specs: Sequence[ChainLayerSpec], tile_h: int, tile_w: int, w_all: bool,
                ng: int, threads: int = TC_THREADS, raw: bool = False) -> ChainF32Launch:
    """Shared memory: each layer's table of K offsets, the B images (each
    layer's hi and lo, or one buffer for the largest pass of `ng` n8-tiles,
    hi then lo, or (`raw`) its f32 values alone), the two region buffers,
    each holding its layers' hi and lo regions, then the frame buffer (the
    input region as it arrives, f32 or bf16). `grid` is set by
    `f32_launch_geometry`."""
    fls = f32_layers(specs)
    regs = regions(specs, tile_h, tile_w)
    cur, ktab = 0, []
    for fl in fls:
        ktab.append(cur)
        cur += _align(fl.ktab_bytes, 16)
    cur = _align(cur)
    w_off, ngs = [], [F32_PASS if w_all else min(ng, fl.nt) for fl in fls]
    for fl in fls:
        w_off.append(cur)
        if w_all:
            cur = _align(cur + 2 * fl.image_bytes)
    if not w_all:
        cur = _align(cur + max((1 if raw else 2) * 8 * g * fl.ostride * 4
                               for g, fl in zip(ngs, fls)))
    reg = [_align(4 * rows * cols * fl.cs, 16) for (rows, cols), fl in zip(regs, fls)]
    need = [0, 0]
    for l in range(len(fls)):
        need[l % 2] = max(need[l % 2], 2 * reg[l])
    buf0 = cur
    buf1 = _align(buf0 + need[0])
    raw_off = _align(buf1 + need[1])
    offs, pbytes = f32_param_layout(specs)
    return ChainF32Launch(
        tile_h, tile_w, threads, int(w_all), buf0, buf1,
        raw_off + 4 * regs[0][0] * regs[0][1] * specs[0].c, pbytes, 0, raw_off,
        tuple((fl.cs, fl.ostride, ngs[l], w_off[l], ktab[l], *offs[l][:2], offs[l][3], reg[l],
               fl.kp, int(raw), offs[l][2]) for l, fl in enumerate(fls)))


def _f32_cost(specs: Sequence[ChainLayerSpec], geo: ChainF32Launch, n: int, ho: int, wo: int,
              sms: int) -> float:
    """Modelled time of an f32 launch, as `_tc_cost`: per m16 tile and k8
    step three products per n8-tile, the A loads (hi and lo; a dense layer
    gathers eight values) once per pass and a B load per two n8-tiles; an
    epilogue per pixel and n8-tile; staging the input region."""
    fls = f32_layers(specs)
    regs = regions(specs, geo.tile_h, geo.tile_w)
    work = 0.0
    for l, (fl, lay) in enumerate(zip(fls, geo.layers)):
        passes = -(-fl.nt // lay[2])
        mt = -(-(regs[l + 1][0] * regs[l + 1][1]) // 16)
        work += mt * (fl.ksteps * (3 * fl.nt + passes * (8 if fl.dense else 2) + -(-fl.nt // 2))
                      + 8 * fl.nt)
    work += regs[0][0] * regs[0][1] * max(1, fls[0].cs // 8) / 2
    per_sm = _f32_per_sm(geo)
    waves = -(-(n * -(-ho // geo.tile_h) * -(-wo // geo.tile_w)) // (sms * per_sm))
    warps = per_sm * geo.threads // 32
    return waves * work * per_sm / min(1.0, warps / 16 + 0.25)


def _f32_per_sm(geo: ChainF32Launch) -> int:
    """CTAs of the f32 form an SM holds: by shared memory, and by registers
    (128 a thread under __launch_bounds__(512): 512 threads take them all)."""
    return max(1, min(2 if geo.threads <= 256 else 1, SMEM_PER_SM // (geo.smem + 1024)))


@functools.lru_cache(maxsize=None)
def f32_launch_geometry(specs: Tuple[ChainLayerSpec, ...], n: int, h: int, w: int,
                        sms: int) -> ChainF32Launch:
    """The f32 launch of a chain (the kernel's only owner of it): the tile
    of least modelled time (`_f32_cost`) among tiles of 1-64 rows and 8-128
    columns, each cut to the output, whose shared memory fits with every
    layer's B images resident, else staged pass by pass (two n8-tiles a
    pass, one where two do not fit, and where one does not fit either, as
    f32 values split in registers); at worst a 1 x 1 tile. 256 threads,
    512 where a tile's shared memory leaves room for one CTA per SM. The
    grid is one wave of persistent CTAs. Speed only: the result does not
    depend on it."""
    ho, wo = _out_hw(h, w, specs)
    tiles = {(min(th, ho), min(tw, wo)) for th in (1, 2, 4, 8, 16, 32, 64)
             for tw in (8, 16, 32, 64, 128) if th * tw <= 4096}
    for w_all, modes in ((True, ((F32_PASS, False),)),
                         (False, ((F32_PASS, False), (1, False), (1, True)))):
        fits = []
        for th, tw in tiles:
            for ng, raw in modes:
                g = _f32_launch(specs, th, tw, w_all, ng, TC_THREADS, raw)
                if g.smem + 1024 > SMEM_PER_SM // 2:  # one CTA per SM: twice the warps
                    g = _f32_launch(specs, th, tw, w_all, ng, 2 * TC_THREADS, raw)
                if g.smem <= MAX_SMEM_BYTES:
                    fits.append(g)
                    break
        if fits:
            best = min(fits, key=lambda g: (_f32_cost(specs, g, n, ho, wo, sms),
                                            -g.tile_h * g.tile_w))
            break
    else:
        best = _f32_launch(specs, 1, 1, False, 1, TC_THREADS, True)
    tiles = n * -(-ho // best.tile_h) * -(-wo // best.tile_w)
    return dataclasses.replace(best, grid=min(tiles, sms * _f32_per_sm(best)))


# Packed parameters, per first weight tensor (by id, while it lives) and
# form: rebuilt when any operand tensor is replaced or modified in place
# (its _version).
_PACKED: dict = {}


def _packed(layer_params: List[dict], form: str, make):
    tensors = [t for p in layer_params for t in (p["w"], p["scale"], p["offset"])]
    key = (id(tensors[0]), form)
    stamp = (tuple(id(t) for t in tensors), tuple(t._version for t in tensors))
    hit = _PACKED.get(key)
    if hit is None or hit[0] != stamp:
        if hit is None:
            weakref.finalize(tensors[0], _PACKED.pop, key, None)
        hit = _PACKED[key] = (stamp, tensors[1:], make())  # holds the others: ids stay theirs
    return hit[2]


def _compute_dtype(x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    if compute_dtype is not None:
        return compute_dtype
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def conv_chain_reference(
    x: torch.Tensor,
    layer_params: List[dict],
    specs: Sequence[ChainLayerSpec],
    tail: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, layer by layer over the whole
    image. Zero-padding each layer's input (inside the convolutions) is
    the kernel's mask of its halo outside the image. A layer with an int8
    input sums int8 x int8 exactly in int32 (ops/conv.py conv2d_nhwc_int8);
    its producer quantizes its float32 output (the frame, for the head)."""
    dt = _compute_dtype(x, compute_dtype)
    _check_a8(specs, dt)
    v = quantize_act(x, specs[0].in_q) if specs[0].in_q > 0.0 else x.to(dt)
    for l, (p, s) in enumerate(zip(layer_params, specs)):
        pads = (s.pt, s.pb, s.pl, s.pr)
        if s.in_q > 0.0:
            acc = conv2d_nhwc_int8(v, p["w"], pads).float()
        else:
            acc = conv2d_nhwc_f32(v, p["w"].to(dt), pads)
        y = apply_activation(acc * p["scale"].float() + p["offset"].float(), s.activation,
                             s.alpha)
        nq = specs[l + 1].in_q if l + 1 < len(specs) else 0.0
        v = quantize_act(y, nq) if nq > 0.0 else y.to(dt)
    if tail == "d2s2":
        v = depth_to_space(v, 2)
    return v.contiguous()


def _check_a8(specs: Sequence[ChainLayerSpec], dt: torch.dtype) -> None:
    for s in specs:
        if s.in_q > 0.0 and (dt != torch.bfloat16 or s.c % 8):
            raise ValueError(f"an int8 layer input (in_q) needs the bf16 form and C % 8 == 0: {s}")


def _launch(x, layer_params, specs, tail, dt, entry) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv chain input must be float32 or bfloat16, got {x.dtype}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv chain compute dtype must be float32 or bfloat16, got {dt}")
    if x.dim() != 4 or x.shape[-1] != specs[0].c:
        raise ValueError(f"conv chain input must be NHWC with C={specs[0].c}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("conv chain input must be contiguous")
    if len(layer_params) != len(specs):
        raise ValueError("one operand dict per layer spec")
    _check_a8(specs, dt)
    for p, s in zip(layer_params, specs):
        if tuple(p["w"].shape) != (s.k, s.k, s.c, s.o):
            raise ValueError(f"weight shape {tuple(p['w'].shape)} != {(s.k, s.k, s.c, s.o)}")
        for t in (p["w"], p["scale"], p["offset"]):
            if t.device != x.device:
                raise ValueError(f"operand on {t.device}, input on {x.device}")
    n, h, w, _ = x.shape
    ho, wo = _out_hw(h, w, specs)
    shape = (n, 2 * ho, 2 * wo, 1) if tail == "d2s2" else (n, ho, wo, specs[-1].o)
    y = torch.empty(shape, dtype=dt, device=x.device)
    if n == 0:
        return y
    lib = kernel_lib()
    ints = (ctypes.c_int * (8 * len(specs)))(*[
        v for s in specs
        for v in (s.k, s.c, s.o, s.pt, s.pb, s.pl, s.pr, ACT_CODES[s.activation])
    ])
    alphas = (ctypes.c_float * len(specs))(*[s.alpha for s in specs])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x_bf16 = int(x.dtype == torch.bfloat16)
    if dt == torch.bfloat16:
        geo = launch_geometry(tuple(specs), n, h, w, sm_count(x.device.index))
        params = _packed(layer_params, ("bf16",) + tuple(s.in_q > 0.0 for s in specs),
                         lambda: pack_params(layer_params, specs))
        # 1/in_q as float32, the constant the JAX kernel multiplies by.
        inv_q = (ctypes.c_float * len(specs))(*[1.0 / s.in_q if s.in_q > 0.0 else 0.0
                                                for s in specs])
        rc = lib.snn_conv_chain_tc(x.data_ptr(), x_bf16, y.data_ptr(), params.data_ptr(), ints,
                                   alphas, inv_q, len(specs), n, h, w, TAILS[tail], geo.array,
                                   stream)
    else:
        geo = f32_launch_geometry(tuple(specs), n, h, w, sm_count(x.device.index))
        params, b_lo = _packed(layer_params, "f32", lambda: pack_params_f32(layer_params, specs))
        rc = lib.snn_conv_chain_f32(x.data_ptr(), x_bf16, y.data_ptr(), params.data_ptr(), ints,
                                    alphas, (ctypes.c_int * len(specs))(*b_lo), len(specs), n,
                                    h, w, TAILS[tail], geo.array, stream)
    if rc != 0:
        raise RuntimeError(
            f"conv_chain launch failed ({rc}): {lib.snn_error_string(rc).decode()}"
        )
    count_launch(entry, 0 if dt == torch.bfloat16 else 1)
    return y


def _conv_chain(x, layer_params, specs, tail, compute_dtype, entry):
    if tail not in TAILS:
        raise ValueError(f"tail {tail!r} not in {tuple(TAILS)}")
    dt = _compute_dtype(x, compute_dtype)
    if x.device.type == "cuda":
        return _launch(x, layer_params, specs, tail, dt, entry)
    if x.device.type == "cpu":
        return conv_chain_reference(x, layer_params, specs, tail, dt)
    raise ValueError(f"no conv chain for device {x.device}")


def fused_conv_chain_packed(
    x: torch.Tensor,
    layer_params: List[dict],
    specs: Sequence[ChainLayerSpec],
    *,
    tail: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Counterpart of chain_packed_pallas.fused_conv_chain_packed: the CUDA
    kernel for a CUDA tensor (no fallback), `conv_chain_reference` for a
    CPU tensor."""
    return _conv_chain(x, layer_params, specs, tail, compute_dtype,
                       "fused_conv_chain_packed")


def fused_conv_chain(
    x: torch.Tensor,
    layer_params: List[dict],
    specs: Sequence[ChainLayerSpec],
    *,
    tail: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Counterpart of chain_pallas.fused_conv_chain: the same kernel as
    `fused_conv_chain_packed`, counted under its own name."""
    return _conv_chain(x, layer_params, specs, tail, compute_dtype,
                       "fused_conv_chain")
