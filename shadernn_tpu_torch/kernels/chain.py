"""Fused stride-1 conv chain: the hand-written CUDA kernel
(csrc/conv_chain.cu), its wrapper, its plan and its plain PyTorch version.

One kernel ports the two TPU chain kernels of the JAX package, which
compute the same function in two TPU layouts:
`shadernn_tpu/kernels/chain_packed_pallas.py` (`_packed_kernel`, entry
point `fused_conv_chain_packed`) and `shadernn_tpu/kernels/chain_pallas.py`
(`_chain_kernel`, entry point `fused_conv_chain`). Both entry points are
kept under their JAX names and launch the one kernel.

The function, at the tensor boundary: NHWC input (float32 or bfloat16,
cast to the compute dtype), per layer an HWIO weight in the compute dtype,
a float32 accumulation and `act(acc * scale + offset)` in float32, each
intermediate zero outside the image and rounded to the compute dtype.
Tails: "none" -> (N,H,W,o); "c1" (o=1) -> (N,H,W,1); "d2s2" (o=4) ->
(N,2H,2W,1) through depth_to_space(2) in TF channel order.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
(tests) it runs `conv_chain_reference`. The bf16 form runs on the tensor
cores with a launch geometry that this module owns (`launch_geometry`:
the tile, the region strides, the shared-memory layout, which layers pack
their taps densely) and weights packed here into the kernel's B images
(`pack_params`); the C entry point checks the geometry and launches. The
f32 form keeps its fixed 16 x 32 tile, whose shared memory is the gate's
term (`smem_bytes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import List, Optional, Sequence, Tuple

import torch

from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import conv2d_nhwc_f32, epilogue_scale_offset
from shadernn_tpu_torch.ops.shape_ops import depth_to_space

# Final-output pixels per CTA of the f32 form (rows, columns) and the
# kernel's limits; they must agree with csrc/conv_chain.cu.
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

# Kernel launches per entry point since import (a caller may reset them).
launches = {"fused_conv_chain_packed": 0, "fused_conv_chain": 0}


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
    """Dynamic shared memory one CTA of the f32 form needs (its layout in
    conv_chain.cu): staged weights and scale/offset, then two ping-pong
    region buffers. The gate's term for both forms."""
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
    cannot take it: stride != 1, k > 9, o > 32, int8 weight storage (the
    JAX kernel's int8 `in_q` dots come with the INT8 slice), an activation
    outside the kernel's epilogue, more than 8 layers, or shared memory
    over 227 KB. `act_override` = (name, alpha) replaces the last layer's
    activation with a folded one (e.g. ESPCN's post-subpixel tanh)."""
    if act_dtype not in (torch.float32, torch.bfloat16) or tail not in TAILS:
        return None
    if not 1 <= len(views) <= MAX_LAYERS:
        return None
    specs: List[ChainLayerSpec] = []
    c = in_channels
    for idx, node in enumerate(views):
        if int(node.attr("stride", 1)) != 1 or "weight_q" in node.params:
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


def chain_operands(views, compute_dtype: torch.dtype) -> List[dict]:
    """Per-layer kernel operands: weight "w" (HWIO, compute dtype) and the
    folded float32 "scale"/"offset" (bias, BatchNorm)."""
    out = []
    for node in views:
        scale, offset = epilogue_scale_offset(node)
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
    """The tile-independent layout of one layer in the bf16 form."""

    dense: bool   # C < 8: taps packed densely, K = round16(k*k*C)
    cs: int       # bf16 per staged input position: C (dense), or C padded to 8
                  # and to an odd number of 16-byte units (ldmatrix rows)
    ksteps: int   # k16 steps of K
    nt: int       # n8-tiles: o padded to 8
    ostride: int  # bf16 per B row: nt * 8, padded to an odd number of 16-byte units

    @property
    def w_bytes(self) -> int:
        return self.ksteps * 16 * self.ostride * 2

    @property
    def ktab_bytes(self) -> int:
        """The table of K offsets: one per K index (dense), else one per
        8-channel unit."""
        return (64 if self.dense else 8) * self.ksteps


def tc_layers(specs: Sequence[ChainLayerSpec]) -> List[TcLayer]:
    out = []
    for s in specs:
        dense, units = s.c < 8, -(-s.c // 8)
        cs = s.c if dense else 8 * (units + 1 - units % 2)
        ksteps = -(-(s.k * s.k * s.c) // 16) if dense else -(-(s.k * s.k * units) // 2)
        nt = -(-s.o // 8)
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
    layers: Tuple[Tuple[int, int, int, int, int, int], ...]  # (cs, ostride, w_off, ktab_off, pw, ps)

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
        need[l % 2] = max(need[l % 2], 2 * rows * cols * tl.cs)
    buf0 = cur
    buf1 = _align(buf0 + need[0])
    offs, pbytes = param_layout(specs)
    return ChainLaunch(
        tile_h, tile_w, threads, int(w_all), buf0, buf1, buf1 + need[1], pbytes,
        tuple((tl.cs, tl.ostride, w_off[l], ktab[l], *offs[l]) for l, tl in enumerate(tls)))


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
    layer the B image, K rows in the kernel's order (tap-major; C padded to
    8 per unit unless the layer packs its taps densely) padded to whole k16 steps,
    `ostride` columns, zeros past o; then scale and offset, zeros past o."""
    chunks = []
    for p, s, tl in zip(layer_params, specs, tc_layers(specs)):
        w = p["w"].to(torch.bfloat16)
        if not tl.dense:
            w = torch.nn.functional.pad(w, (0, 0, 0, -s.c % 8))
        w = w.reshape(-1, s.o)
        w = torch.nn.functional.pad(w, (0, tl.ostride - s.o, 0, 16 * tl.ksteps - w.shape[0]))
        so = torch.zeros((2, 8 * tl.nt), dtype=torch.float32, device=w.device)
        so[0, :s.o] = p["scale"].float().reshape(-1)
        so[1, :s.o] = p["offset"].float().reshape(-1)
        chunks += [w.contiguous().view(torch.uint8).reshape(-1), so.view(torch.uint8).reshape(-1)]
    return torch.cat(chunks)


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
    image. Zero-padding each layer's input (inside conv2d_nhwc_f32) is the
    kernel's mask of its halo outside the image."""
    dt = _compute_dtype(x, compute_dtype)
    v = x.to(dt)
    for p, s in zip(layer_params, specs):
        acc = conv2d_nhwc_f32(v, p["w"].to(dt), (s.pt, s.pb, s.pl, s.pr))
        y = acc * p["scale"].float() + p["offset"].float()
        v = apply_activation(y, s.activation, s.alpha).to(dt)
    if tail == "d2s2":
        v = depth_to_space(v, 2)
    return v.contiguous()


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
        params = _packed(layer_params, "bf16", lambda: pack_params(layer_params, specs))
        rc = lib.snn_conv_chain_tc(x.data_ptr(), x_bf16, y.data_ptr(), params.data_ptr(), ints,
                                   alphas, len(specs), n, h, w, TAILS[tail], geo.array, stream)
    else:
        params = _packed(layer_params, "f32", lambda: torch.cat([
            t.float().reshape(-1) for p in layer_params
            for t in (p["w"], p["scale"], p["offset"])]))
        rc = lib.snn_conv_chain(x.data_ptr(), x_bf16, y.data_ptr(), params.data_ptr(), ints,
                                alphas, len(specs), n, h, w, TAILS[tail], TILE_H, TILE_W,
                                stream)
    if rc != 0:
        raise RuntimeError(
            f"conv_chain launch failed ({rc}): {lib.snn_error_string(rc).decode()}"
        )
    launches[entry] += 1
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
