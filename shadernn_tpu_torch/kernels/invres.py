"""Fused inverted-residual block: the hand-written CUDA kernel
(csrc/invres_block.cu), its wrapper, its plan and its plain PyTorch
version.

The kernel ports `_invres_kernel` of the JAX package
(`shadernn_tpu/kernels/block_pallas.py`, entry point `fused_invres_block`):
[1x1 expand + act] -> 3x3 stride-1 SAME depthwise + act -> 1x1 project
[+ residual] -> act as one kernel, the expanded tensor kept on chip. The
planner (`match_invres_block`, `build_invres`) is the JAX package's,
without the TPU layout fields (b_tile, padded, row_chunk, wp, hp).

Numerics of the JAX kernel, which the plain version and the kernel share:
w1 and w2 in the compute dtype (the dtype of x), or int8, which the kernel
reads as int8 and upcasts as it stages them (exact); under float32 the
kernel's two products are 3xTF32 on the tensor cores, about float32's
accuracy (kernels/tf32.py is the plain model of that arithmetic); the depthwise taps
kept float32 (int8 taps upcast; the per-op TORCH path casts them to the
compute dtype, so under BF16 the two paths differ by design), every sum in
float32, e and d rounded to the compute dtype, out-of-image taps exact
zeros, the residual x added in float32 before the output activation. Every
int8 weight's scale is folded into its stage's float32 epilogue scale.

A8W8 (bf16 only, a calibrated INT8 engine): `ax1` quantizes the block
input for the expand product and `ax2` the depthwise output (after its
activation, rounded to bf16) for the project product, each symmetric int8
with a float32 1/ax, rounded half to even; those products are int8 x int8
with exact int32 sums, ax folded into s1 / s2 (the JAX kernel's `q8`).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor (tests) it runs `invres_block_reference`. The launch geometry is
this module's (`pick_launch`, `layout`): the C entry point checks it and
launches. `prepare_operands` checks and lays out a block's operands once
(the engine does so once per parameter set), so that a launch only checks
its input.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from shadernn_tpu_torch.kernels import count_launch
from shadernn_tpu_torch.kernels.chain import ACT_CODES, MAX_SMEM_BYTES
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import (
    conv2d_nhwc_f32, epilogue_scale_offset, int8_matmul, quantize_act,
)

# Limits of csrc/invres_block.cu: expanded channels per chunk, the largest
# tile (pixels), output width and CTAs of a cluster that split E.
CHUNK_E = 32
MAX_TILE = 8
MAX_COUT = 320
MAX_SPLIT = 8
MAX_E_A8W8 = 1024  # E of an A8W8 project; match_invres_block's E <= 1024 too


@dataclasses.dataclass(frozen=True)
class InvResSpec:
    """Static geometry of one fused block."""

    h: int
    w: int
    cin: int
    e: int  # expanded width (== cin when has_expand is False)
    cout: int
    has_expand: bool
    residual: bool
    act_expand: str
    act_dw: str
    act_out: str  # applied after the (optional) residual add
    alpha: float = 0.3
    # A8W8: the calibrated scales of the block input (expand product) and
    # of the depthwise output (project product); 0.0 keeps that product on
    # the compute dtype.
    ax1: float = 0.0
    ax2: float = 0.0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


ES = 40  # bf16 per row of the bf16 form's es, ds and w1 chunk: 32 + 8
ES_F32 = 36  # f32 per row of the f32 form's es, ds and staged w2: 32 + 4


@dataclasses.dataclass(frozen=True)
class InvResLaunch:
    """Launch geometry of one block on csrc/invres_block.cu, in the order
    of its G_* fields: the tile, the split of E over a cluster, the staged
    rows' strides (elements) and the shared-memory layout (bytes; `bufs`
    buffers of w1, the taps and vectors, and w2: two in the bf16 form, two
    or one in the f32 form; under ax1 it also holds the quantized input
    tile `xq`, rows of `q_stride` bytes)."""

    tile_h: int
    tile_w: int
    split: int
    xs_stride: int
    w2_stride: int
    xs_off: int
    es_off: int
    ds_off: int
    w1_off: int
    wd_off: int
    w2_off: int
    red_off: int
    w1_buf: int
    wd_buf: int
    w2_buf: int
    smem: int
    q_stride: int = 0
    xq_off: int = 0
    bufs: int = 2

    @functools.cached_property
    def array(self) -> ctypes.Array:
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)


Q_ROW = 48  # bytes per row of the int8 d chunk and of the staged int8 w2: 32 + 16


def layout(spec: InvResSpec, tile_h: int, tile_w: int, split: int = 1,
           bf16: bool = False, bufs: int = 2) -> InvResLaunch:
    """The shared memory of one CTA: the input tile with its halo, then the
    per-chunk buffers, then (ax1) the quantized input tile; the split-E
    partial sums overlay all but the input tile. The halo and pixel rows
    are padded to 16 (the tensor cores' tiles) and rows to an odd number of
    16-byte units (ldmatrix without bank conflicts). bf16: Cin padded to 16
    and Cout to 8, two buffers of each chunk's weights, w1 k-major. f32:
    Cin padded to 8, `bufs` buffers, w1 and w2 n-major (E rows of Cin, Cout
    rows of the chunk's 32: ldmatrix has no 32-bit transpose). The int8
    operands (ax1: the input tile and w1 n-major, rows of Cin padded to 32
    plus 16 bytes; ax2: w2 n-major, rows of the chunk's 32 bytes plus 16)
    take the same care."""
    hp, p = (tile_h + 2) * (tile_w + 2), tile_h * tile_w
    hp16, p16 = _round_up(hp, 16), _round_up(p, 16)
    cout8 = _round_up(spec.cout, 8)
    q_stride = xq = 0
    if bf16:
        assert bufs == 2, "the bf16 form double-buffers"
        cin16 = _round_up(spec.cin, 16)
        xs_stride = cin16 + 8
        w2_stride = cout8 + 8 if (cout8 // 8) % 2 == 0 else cout8
        if spec.ax1:
            q_stride = _round_up(spec.cin, 32) + 16
            xq = hp16 * q_stride
        w1_buf = (CHUNK_E * q_stride if spec.ax1 else cin16 * ES * 2) if spec.has_expand else 0
        bufs_b = (w1_buf, 13 * CHUNK_E * 4,
                  cout8 * Q_ROW if spec.ax2 else CHUNK_E * w2_stride * 2)
        sizes = (hp16 * xs_stride * 2, hp16 * ES * 2, p16 * ES * 2)
    else:
        xs_stride, w2_stride = _round_up(spec.cin, 8) + 4, ES_F32
        bufs_b = (CHUNK_E * xs_stride * 4 if spec.has_expand else 0, 13 * CHUNK_E * 4,
                  cout8 * ES_F32 * 4)
        sizes = (hp16 * xs_stride * 4, hp16 * ES_F32 * 4, p16 * ES_F32 * 4)
    offs = [0]
    for size in (*sizes, *(bufs * b for b in bufs_b), xq):
        offs.append(offs[-1] + size)
    red = p * spec.cout * 4 if split > 1 else 0
    return InvResLaunch(tile_h, tile_w, split, xs_stride, w2_stride, *offs[:6], offs[1], *bufs_b,
                        max(offs[7], offs[1] + red), q_stride, offs[6] if xq else 0, bufs)


def smem_bytes(spec: InvResSpec, tile_h: int, tile_w: int, split: int = 1,
               bf16: bool = False, bufs: int = 2) -> int:
    """Dynamic shared memory of one CTA (`layout`)."""
    return layout(spec, tile_h, tile_w, split, bf16, bufs).smem


def gate_smem_bytes(spec: InvResSpec, tile_h: int, tile_w: int) -> int:
    """The gate's shared-memory term at both dtypes: what the kernel's first
    f32 form (CUDA cores, unsplit, one buffer: the input tile and halo in
    rows of Cin rounded up to 4 floats, the expanded and depthwise chunks,
    w1, the taps and vectors and w2 of a chunk) took at a tile, kept as
    that formula so that the gate admits the blocks it always admitted and
    both dtypes plan alike. Every layout pick_launch gives fits wherever
    the gate admits (tests/test_torch_invres.py)."""
    hp, p = (tile_h + 2) * (tile_w + 2), tile_h * tile_w
    cin4 = _round_up(spec.cin, 4)
    return 4 * (hp * cin4 + (hp + p) * CHUNK_E + (cin4 * CHUNK_E if spec.has_expand else 0)
                + 13 * CHUNK_E + CHUNK_E * spec.cout)


def kernel_takes(spec: InvResSpec) -> bool:
    """Does the CUDA kernel take this block (activations in its epilogue,
    Cout <= 320, the gate's shared-memory term of the largest tile within
    227 KB: `gate_smem_bytes`)? The bf16 and f32 layouts fit wherever it
    admits, and the A8W8 layout at a 4x4 tile is checked too
    (tests/test_torch_invres.py)."""
    acts = (spec.act_expand, spec.act_dw, spec.act_out)
    return (
        all(str(a).lower() in ACT_CODES for a in acts)
        and spec.cout <= MAX_COUT
        and gate_smem_bytes(spec, min(MAX_TILE, spec.h), min(MAX_TILE, spec.w)) <= MAX_SMEM_BYTES
        and (not (spec.ax1 or spec.ax2)
             or smem_bytes(spec, min(4, spec.h), min(4, spec.w), 1, True) <= MAX_SMEM_BYTES)
        # the project's int32 chunk sums add up exactly in float32 while
        # E * 127^2 < 2^24 (csrc/invres_block.cu)
        and (not spec.ax2 or spec.e <= MAX_E_A8W8)
    )


def _weight(node) -> torch.Tensor:
    return torch.as_tensor(node.params["weight_q" if "weight_q" in node.params else "weight"])


def build_invres(views, in_spec, act_dtype: torch.dtype, in_act_scale: float = 0.0,
                 a8w8: bool = False):
    """(operands, InvResSpec) for a matched [expand?, dw, project, add?]
    run of nodes, or None where the kernel cannot take it (the JAX
    package's build_invres; its VMEM gate becomes the kernel's
    shared-memory and width gate). `views` give .params/.attr; operands is
    a dict: w1 (Cin,E) and w2 (E,Cout) in the compute dtype or int8, wd
    (9,E) float32 (int8 taps upcast), and the float32 epilogue vectors
    s1/o1, sd/od, s2/o2 with every int8 scale folded in.

    A8W8 as the JAX package sets it: `ax1` = `in_act_scale` (the block
    input's calibrated act_scale, which the caller passes under INT8 only)
    where w1 is int8; `ax2` = the depthwise node's `act_scale` where w2 is
    int8 and `a8w8` (an INT8 engine); each folded into s1 / s2."""
    expand, dw, project, add = views
    h, w, cin = in_spec.h, in_spec.w, in_spec.c
    ops: Dict[str, torch.Tensor] = {}
    ax1 = ax2 = 0.0
    if expand is not None:
        w1 = _weight(expand)  # (1, 1, Cin, E)
        e_ch = int(w1.shape[-1])
        ops["w1"] = w1.reshape(cin, e_ch)
        ops["s1"], ops["o1"] = epilogue_scale_offset(expand)
        if w1.dtype == torch.int8 and in_act_scale > 0:
            ax1 = float(in_act_scale)
            ops["s1"] = ops["s1"] * ax1  # the int32 sums carry 1/ax1
        elif w1.dtype != torch.int8:
            ops["w1"] = ops["w1"].to(act_dtype)
        act_expand = expand.attr("activation", "linear")
    else:
        e_ch = cin
        act_expand = "linear"
    wd = _weight(dw)  # (3, 3, 1, E)
    if tuple(wd.shape[:2]) != (3, 3) or int(wd.shape[-1]) != e_ch:
        return None
    ops["wd"] = wd.reshape(9, e_ch).float()
    ops["sd"], ops["od"] = epilogue_scale_offset(dw)
    w2 = _weight(project)  # (1, 1, E, Cout)
    cout = int(w2.shape[-1])
    ops["w2"] = w2.reshape(e_ch, cout)
    ops["s2"], ops["o2"] = epilogue_scale_offset(project)
    dw_scale = float(dw.attr("act_scale", 0.0) or 0.0) if a8w8 else 0.0
    if w2.dtype == torch.int8 and dw_scale > 0:
        ax2 = dw_scale
        ops["s2"] = ops["s2"] * ax2
    elif w2.dtype != torch.int8:
        ops["w2"] = ops["w2"].to(act_dtype)
    spec = InvResSpec(
        h=h, w=w, cin=cin, e=e_ch, cout=cout,
        has_expand=expand is not None,
        residual=add is not None,
        act_expand=act_expand,
        act_dw=dw.attr("activation", "linear"),
        act_out=(add.attr("activation", "linear") if add is not None
                 else project.attr("activation", "linear")),
        alpha=float(dw.attr("leaky_alpha", 0.3)),
        ax1=ax1, ax2=ax2,
    )
    if not kernel_takes(spec):
        return None
    return ops, spec


def match_invres_block(graph, dw_node) -> Optional[tuple]:
    """Match [expand?] -> dw(3x3, s1) -> project(1x1) [-> add] around a
    SeparableConv2D node; (expand, dw, project, add) with expand/add
    possibly None, or None. The JAX package's gates, kept for parity:
    single-consumer links, SAME padding, stride 1, multiplier 1, the
    residual adding the head's own input, E <= 1024 and H*W <= 784 (the
    last measured on the TPU; the card may want another)."""
    if dw_node.op != "SeparableConv2D":
        return None
    if int(dw_node.attr("kernel_size")) != 3 or int(dw_node.attr("stride", 1)) != 1:
        return None
    if int(dw_node.attr("multiplier", 1)) != 1:
        return None
    if padding_offsets(dw_node.attr("padding", "same"), 3) != (1, 1, 1, 1):
        return None
    if len(dw_node.inputs) != 1 or dw_node.name in graph.output_names:
        return None

    def sole_consumer(n):
        if n.name in graph.output_names:
            return None
        cons = graph.consumers(n.name)
        return cons[0] if len(cons) == 1 else None

    def is_1x1(n):
        return (
            n is not None
            and n.op == "Conv2D"
            and len(n.inputs) == 1
            and int(n.attr("kernel_size")) == 1
            and int(n.attr("stride", 1)) == 1
        )

    project = sole_consumer(dw_node)
    if not is_1x1(project):
        return None
    expand = graph.nodes[dw_node.inputs[0]]
    if not (is_1x1(expand) and sole_consumer(expand) is dw_node):
        expand = None
    head = expand if expand is not None else dw_node
    skip_name = head.inputs[0]
    add = sole_consumer(project)
    if not (
        add is not None
        and add.op == "Add"
        and len(add.inputs) == 2
        and set(add.inputs) == {skip_name, project.name}
        and graph.nodes[skip_name].out_spec.shape == project.out_spec.shape
    ):
        add = None
    if dw_node.out_spec.c > 1024:
        return None
    if dw_node.out_spec.h * dw_node.out_spec.w > 784:
        return None
    return (expand, dw_node, project, add)


def invres_block_reference(x: torch.Tensor, ops: Dict[str, torch.Tensor],
                           spec: InvResSpec) -> torch.Tensor:
    """Plain PyTorch version of the kernel over whole images. The A8W8
    products are int8 x int8 with exact int32 sums (ops/conv.py
    int8_matmul)."""
    dt = x.dtype
    n, h, w, _ = x.shape
    a = spec.alpha
    if (spec.ax1 or spec.ax2) and dt != torch.bfloat16:
        raise ValueError("the block's A8W8 form runs under bfloat16 activations")
    if spec.has_expand:
        x2 = x.reshape(-1, spec.cin)
        if spec.ax1:
            e = int8_matmul(quantize_act(x2, spec.ax1), ops["w1"]).float()
        else:
            e = x2.float() @ ops["w1"].to(dt).float()
        e = apply_activation(e * ops["s1"].float() + ops["o1"].float(), spec.act_expand, a)
        e = e.to(dt).reshape(n, h, w, spec.e)
    else:
        e = x
    acc = conv2d_nhwc_f32(e, ops["wd"].float().reshape(3, 3, 1, spec.e), (1, 1, 1, 1),
                          groups=spec.e)
    d = apply_activation(acc * ops["sd"].float() + ops["od"].float(), spec.act_dw, a).to(dt)
    d2 = d.reshape(-1, spec.e)
    if spec.ax2:
        y = int8_matmul(quantize_act(d2, spec.ax2), ops["w2"]).float()
    else:
        y = d2.float() @ ops["w2"].to(dt).float()
    y = (y * ops["s2"].float() + ops["o2"].float()).reshape(n, h, w, spec.cout)
    if spec.residual:
        y = y + x.float()
    return apply_activation(y, spec.act_out, a).to(dt).contiguous()


# SMs per GPC of a 132-SM H100 SXM as the f32 launch model assumes them:
# the CTAs of a cluster run inside one GPC, so how many clusters run at
# once depends on the GPCs' sizes. They vary from card to card; these fit
# a sweep of the f32 form on an H100 (PERF.md). Other SM counts: GPCs of
# about 16.
_GPCS_132 = (18, 18, 18, 18, 16, 16, 14, 14)
_F32_TILES = ((8, 8), (4, 8), (8, 4), (4, 4), (2, 8), (8, 2), (2, 4), (4, 2), (2, 2))


def _gpcs(sms: int) -> Tuple[int, ...]:
    if sms == 132:
        return _GPCS_132
    n = -(-sms // 16)
    return tuple(sms // n + (i < sms % n) for i in range(n))


def _f32_cost(spec: InvResSpec, n: int, sms: int, geo: InvResLaunch) -> float:
    """Modelled time of the f32 form at one launch: waves of clusters (as
    many run at once as the GPCs hold, at 2 CTAs per SM where shared memory
    and registers allow, 1 for the widest project) x the SM's share of
    CTAs^0.75 (two CTAs on an SM overlap little: a chunk's instructions,
    most of them hi/lo splits, fill the SM's issue slots) x the CTA's
    cost: its E chunks, each 16 + its pixels + 2 x (expand items per
    warp) x (Cin / 8), plus 128 (staging and the epilogue); one buffer
    costs 3% more. Fitted to a sweep of every tile, split and buffer count
    of the MobileNetV2 224 (b8) and trained cls10 (b64) blocks on an H100
    (tools/sweep_launch.py): its choices took 1.04x the best sum."""
    th, tw, split = geo.tile_h, geo.tile_w, geo.split
    p, hp = th * tw, (th + 2) * (tw + 2)
    warps_n = 8 // -(-p // 16)  # the project's warps over Cout
    nt = -(-(-(-spec.cout // 8)) // warps_n)
    per_sm = min(1 if nt > 8 else 2, MAX_SMEM_BYTES // geo.smem)
    clusters = n * -(-spec.h // th) * -(-spec.w // tw)
    cap = sms * per_sm if split == 1 else sum(g * per_sm // split for g in _gpcs(sms))
    waves = -(-clusters // cap)
    share = max(1.0, min(clusters, cap) * split / sms)
    items = -(-2 * -(-hp // 16) // 8) if spec.has_expand else 0
    chunk = 16 + p + 2 * items * _round_up(spec.cin, 8) / 8
    cost = waves * share ** 0.75 * (-(-spec.e // CHUNK_E // split) * chunk + 128)
    return cost * (1.03 if geo.bufs == 1 else 1.0)


@functools.lru_cache(maxsize=None)
def pick_launch(spec: InvResSpec, n: int, sms: int, bf16: bool = False) -> InvResLaunch:
    """The launch of one block (the kernel's only owner of it). Speed only:
    the tile does not change the result, the split only the order of the
    sum over E.

    bf16: the tile (8x8, 4x8 or 4x4) and split with the least modelled
    time, waves x per-CTA cost. A wave is two CTAs per SM, or one where the
    shared memory holds one; a CTA costs its E chunks, each about its
    pixels + 32 (a chunk is a chain of dependent phases, not of products),
    plus its cluster's reduction, pixels x Cout x split^2 / 1024. Fitted to
    a sweep of every tile and split of the MobileNetV2 224 blocks on an
    H100 (PERF.md).

    f32: the tile (8x8 down to 2x2), split and buffer count of the least
    `_f32_cost`."""
    chunks = -(-spec.e // CHUNK_E)
    best = None
    for bufs in ((2,) if bf16 else (2, 1)):
        for th, tw in (((8, 8), (4, 8), (4, 4)) if bf16 else _F32_TILES):
            th, tw = min(th, spec.h), min(tw, spec.w)
            p = th * tw
            ctas = n * -(-spec.h // th) * -(-spec.w // tw)
            for split in (1, 2, 4, 8):
                geo = layout(spec, th, tw, split, bf16, bufs)
                if split > chunks or geo.smem > MAX_SMEM_BYTES:
                    continue
                if bf16:
                    per_sm = min(2, MAX_SMEM_BYTES // geo.smem)
                    waves = -(-ctas * split // (per_sm * sms))
                    red = p * spec.cout * split * split / 1024 if split > 1 else 0
                    cost = waves * (-(-chunks // split) * (p + 32) + red)
                else:
                    cost = _f32_cost(spec, n, sms, geo)
                if best is None or cost < best[0]:
                    best = (cost, geo)
    if best is None:
        raise ValueError(f"no launch of the block kernel holds {spec} in 227 KB")
    return best[1]


_ORDER = ("w1", "s1", "o1", "wd", "sd", "od", "w2", "s2", "o2")


class InvResOperands(dict):
    """A block's operands checked against its spec and laid out for the
    kernel (w1, w2 in the compute dtype or int8, which the kernel upcasts
    as it stages them; under ax1 / ax2 int8 with their n-major copies w1q
    (E, Cin padded to 32) and w2q (Cout, E padded to 32) that the kernel
    reads instead; under float32 the n-major copies the f32 form reads:
    w1n (E, Cin padded to 8) and w2n (Cout, E padded to 32) float32, or
    w1q / w2q of an int8 weight; the rest float32; contiguous, on one
    device), with the kernel's pointer and activation arrays and `w8`, the
    int8 weights it upcasts (bit 0 w1, bit 1 w2)."""

    spec: InvResSpec
    dtype: torch.dtype
    device: torch.device
    ptrs: ctypes.Array
    acts: ctypes.Array
    w8: int


def prepare_operands(ops: Dict[str, torch.Tensor], spec: InvResSpec,
                     dtype: torch.dtype) -> InvResOperands:
    """`ops` (as build_invres gives them) checked and laid out for the
    kernel at compute dtype `dtype`; raises where the kernel cannot take
    them."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block compute dtype must be float32 or bfloat16, got {dtype}")
    if not kernel_takes(spec):
        raise ValueError(f"the block kernel does not take {spec}")
    if (spec.ax1 or spec.ax2) and dtype != torch.bfloat16:
        raise TypeError("the block's A8W8 form runs under bfloat16 activations")
    int8_keys = {k for k, on in (("w1", spec.ax1), ("w2", spec.ax2)) if on}
    shapes = {"wd": (9, spec.e), "sd": (spec.e,), "od": (spec.e,),
              "w2": (spec.e, spec.cout), "s2": (spec.cout,), "o2": (spec.cout,)}
    if spec.has_expand:
        shapes.update(w1=(spec.cin, spec.e), s1=(spec.e,), o1=(spec.e,))
    out = InvResOperands()
    for key, shape in shapes.items():
        t = ops[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"operand {key} has shape {tuple(t.shape)}, want {shape}")
        if key in int8_keys and t.dtype != torch.int8:
            raise TypeError(f"operand {key} of an A8W8 product must be int8, got {t.dtype}")
        if key in ("w1", "w2"):
            out[key] = (t if t.dtype == torch.int8 else t.to(dtype)).contiguous()
        else:
            out[key] = t.float().contiguous()
    pad = torch.nn.functional.pad
    f32 = dtype == torch.float32
    if spec.has_expand and (spec.ax1 or f32):  # E rows of Cin: 32 int8, 8 f32
        i8 = out["w1"].dtype == torch.int8
        out["w1q" if i8 else "w1n"] = pad(out["w1"].t(), (0, -spec.cin % (32 if i8 else 8))
                                          ).contiguous()
    if spec.ax2 or f32:  # Cout rows of E padded to 32
        out["w2q" if out["w2"].dtype == torch.int8 else "w2n"] = pad(
            out["w2"].t(), (0, -spec.e % 32)).contiguous()
    devices = {t.device for t in out.values()}
    if len(devices) != 1:
        raise ValueError(f"block operands on several devices: {sorted(map(str, devices))}")
    out.spec, out.dtype, out.device = spec, dtype, devices.pop()
    out.w8 = sum(bit for key, bit in (("w1", 1), ("w2", 2))
                 if key in out and key not in int8_keys and out[key].dtype == torch.int8)
    # The kernel reads the n-major copy of w1 / w2 where one was made.
    # Without expand it reads no w1/s1/o1: any valid pointer will do.
    kernel_keys = [next((c for c in (k + "q", k + "n") if c in out), k) for k in _ORDER]
    out.ptrs = (ctypes.c_void_p * 9)(*[out.get(k, out["wd"]).data_ptr() for k in kernel_keys])
    out.acts = (ctypes.c_int * 3)(*[ACT_CODES[str(a).lower()]
                                    for a in (spec.act_expand, spec.act_dw, spec.act_out)])
    return out


def _launch(x: torch.Tensor, ops: Dict[str, torch.Tensor], spec: InvResSpec) -> torch.Tensor:
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

    if not (isinstance(ops, InvResOperands) and ops.spec == spec and ops.dtype == x.dtype):
        ops = prepare_operands(ops, spec, x.dtype)
    if ops.device != x.device:
        raise ValueError(f"block operands on {ops.device}, input on {x.device}")
    if x.dim() != 4 or tuple(x.shape[1:]) != (spec.h, spec.w, spec.cin):
        raise ValueError(f"block input {tuple(x.shape)} != (N, {spec.h}, {spec.w}, {spec.cin})")
    if not x.is_contiguous():
        raise ValueError("block input must be contiguous")
    n = x.shape[0]
    y = torch.empty((n, spec.h, spec.w, spec.cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    bf16 = x.dtype == torch.bfloat16
    geo = pick_launch(spec, n, sm_count(x.device.index), bf16)
    lib = kernel_lib()
    rc = lib.snn_invres_block(
        x.data_ptr(), int(bf16), y.data_ptr(), ops.ptrs, n, spec.h, spec.w, spec.cin, spec.e,
        spec.cout, int(spec.has_expand), int(spec.residual), ops.acts, float(spec.alpha),
        # 1/ax as float32, the constant the JAX kernel multiplies by; 0: no A8W8
        1.0 / spec.ax1 if spec.ax1 else 0.0, 1.0 / spec.ax2 if spec.ax2 else 0.0, ops.w8,
        geo.array, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"invres_block launch failed ({rc}): {lib.snn_invres_error(rc).decode()}")
    count_launch("fused_invres_block", 0 if bf16 else 1)
    return y


def fused_invres_block(x: torch.Tensor, ops: Dict[str, torch.Tensor],
                       spec: InvResSpec) -> torch.Tensor:
    """Counterpart of block_pallas.fused_invres_block: NHWC (N,H,W,Cin) in
    the compute dtype -> (N,H,W,Cout). The CUDA kernel for a CUDA tensor
    (no fallback), `invres_block_reference` for a CPU tensor. `ops` as
    build_invres gives them, or as prepare_operands laid them out for the
    dtype of x (then they are not checked again)."""
    if x.device.type == "cuda":
        return _launch(x, ops, spec)
    if x.device.type == "cpu":
        return invres_block_reference(x, ops, spec)
    raise ValueError(f"no block kernel for device {x.device}")
