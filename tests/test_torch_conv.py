"""The port's single-conv module (shadernn_tpu_torch.kernels.conv) against
the JAX package's haloed conv kernel, reached through
`shadernn_tpu.ops.conv.conv_run_pallas_chain` in Pallas interpret mode, and
the compile step's use of it: singletons and the convs of a chain that the
chain kernel's gate declines. On the CPU the port's entry point runs the
kernel's plain version; the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.graph.builder import GraphBuilder as JBuilder
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.kernels.conv_pallas import from_haloed
from shadernn_tpu.ops.conv import conv_run_pallas_chain
from shadernn_tpu.ops.registry import RunCtx as JCtx

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.builder import GraphBuilder as PBuilder
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.kernels import conv

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}

# (n, h, w, c, k, o, padding, activation)
CASES = [
    (2, 12, 20, 1, 5, 16, "same", "relu"),          # C=1: the JAX side row-packs
    (2, 16, 16, 12, 2, 16, (1, 0, 1, 0), "relu6"),  # the folded MobileNetV2 stem
    (1, 11, 17, 8, 3, 12, (2, 1, 0, 3), "tanh"),    # asymmetric pads
    (2, 9, 14, 3, 4, 5, "same", "leaky_relu"),      # even k: top/left one less
]


def attrs(k, o, padding, act):
    return dict(kernel_size=k, out_channels=o, padding=padding, activation=act,
                stride=1, use_bias=True, leaky_alpha=0.3)


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"c{c[3]}k{c[4]}o{c[5]}")
def test_reference_matches_jax_haloed_kernel(rng, case, prec):
    n, h, w, c, k, o, padding, act = case
    x = rng.random((n, h, w, c), dtype=np.float32)
    params = {"weight": (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32),
              "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}
    tdt, jdt = DTYPES[prec]
    jnode = JNode("conv", "Conv2D", ["x"], attrs(k, o, padding, act),
                  {key: jnp.asarray(v) for key, v in params.items()})
    want = conv_run_pallas_chain(jnode, jnp.asarray(x, jdt), JCtx())
    want = np.asarray(from_haloed(want), np.float32)

    pnode = PNode("conv", "Conv2D", ["x"], attrs(k, o, padding, act),
                  {key: torch.from_numpy(v) for key, v in params.items()})
    assert conv.single_conv_supported(pnode, c)
    before = dict(conv.launches)
    got = conv.conv_run_kernel(pnode, torch.from_numpy(x).to(tdt), tdt)
    assert conv.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def test_gate():
    def node(k, c_out, act="relu", padding="same", **params):
        return PNode("n", "Conv2D", ["x"], attrs(k, c_out, padding, act),
                     params or {"weight": np.zeros((k, k, 1, c_out), np.float32)})

    assert conv.single_conv_supported(node(3, 128), 128)
    assert not conv.single_conv_supported(node(3, 129), 16)     # o > 128
    assert not conv.single_conv_supported(node(3, 16), 512)     # k*k*c > 4096
    assert not conv.single_conv_supported(node(3, 8, "softmax"), 4)
    assert not conv.single_conv_supported(node(3, 8, weight_q=np.zeros(1)), 4)
    # int8 weights: under bfloat16 activations only (INT8 engines run bf16).
    assert not conv.single_conv_supported(node(3, 8, weight_q=np.zeros(1)), 4, torch.float32)
    assert conv.single_conv_supported(node(3, 8, weight_q=np.zeros(1)), 4, torch.bfloat16)
    # The gate's term: the f32 form at one channel per chunk (16x8 tile,
    # 9x17 staged, 2x2 taps x 16 channels), at both dtypes.
    assert conv.smem_bytes(2, 2, 16) == 4 * ((9 * 17 + 3) // 4 * 4 + 4 * 16)
    assert conv.smem_bytes(48, 48, 64) > conv.MAX_SMEM_BYTES
    # The bf16 form at the folded MobileNetV2 stem (b64, 16x16, 12->16, k2):
    # an 8x8 tile with a 9x9 region of 16 channels (rows of 24 bf16) and a
    # zero row, one stage of 4 taps x 16 channels (rows of 24 bf16).
    stem = conv.launch_geometry(64, 16, 16, 12, 2, 2, 16, (1, 0, 1, 0), True, 132)
    assert (stem.tile_h, stem.tile_w, stem.imgs, stem.nb, stem.cc, stem.tg) == (8, 8, 1, 16, 16, 4)
    assert stem.smem == (9 * 9 + 1) * 24 * 2 + 64 * 24 * 2


def _gate_before(k: int, o: int) -> int:
    """The single-conv gate's shared-memory term as the kernel had it
    before the bf16 form (one formula in csrc/conv_single.cu)."""
    ch = 8 if o > 4 else (4 if o > 1 else 1)
    ob = min(-(-o // ch) * ch, 32)
    tile_w = 16 if 256 // (ob // ch) >= 128 else 8
    tile_h = 256 // (ob // ch) // tile_w
    return 4 * (((tile_h + k - 1) * (tile_w + k - 1) + 3) // 4 * 4 + k * k * ob)


def test_gate_admits_what_it_did_and_every_admitted_conv_fits():
    """The gate's answers are the same as before the bf16 form, and the
    launch of both forms (bf16; f32, whose staged rows are twice as wide
    and whose weights are n-major) fits 227 KB for every conv the gate
    admits (any k, C, O within the limits; small and large outputs,
    several images per CTA), so that both dtypes plan alike."""
    admitted = 0
    for k in range(1, 65):
        for o in (1, 3, 5, 8, 10, 16, 24, 33, 64, 100, 128):
            assert conv.smem_bytes(k, k, o) == _gate_before(k, o), (k, o)
            if conv.smem_bytes(k, k, o) > conv.MAX_SMEM_BYTES:
                continue
            for c in sorted({1, 2, 3, 8, 12, 16, 24, 64, 128, 4096 // (k * k)}):
                if c < 1 or c > 128 or k * k * c > 4096:
                    continue
                for out in (1, 4, 7, 33):
                    for bf16 in (True, False):
                        geo = conv.launch_geometry(3, out + k - 1, out + k - 1, c, k, k, o,
                                                   (0, 0, 0, 0), bf16, 132)
                        assert geo.smem <= conv.MAX_SMEM_BYTES, (k, c, o, out, bf16, geo)
                    admitted += 1
    assert admitted > 1000


def _tile_map(geo: conv.ConvLaunch, n, ho, wo, o):
    """How often the kernel writes each output element, from its launch
    geometry: the CTA -> (pixels, channels) map of csrc/conv_single.cu, the
    same in both forms: grid (M tiles, channel blocks), a CTA holding 64
    pixel rows."""
    count = np.zeros((n, ho, wo, o), np.int32)
    tiles_x, tiles_y = -(-wo // geo.tile_w), -(-ho // geo.tile_h)
    m_tiles = -(-n // geo.imgs) if geo.imgs > 1 else n * tiles_x * tiles_y
    ctas = [(bx, by) for bx in range(m_tiles) for by in range(-(-o // geo.nb))]
    tile_px = geo.tile_h * geo.tile_w
    for bx, by in ctas:
        if geo.imgs > 1:
            n0, ty0, tx0 = bx * geo.imgs, 0, 0
        else:
            n0, t = divmod(bx, tiles_x * tiles_y)
            ty0, tx0 = (t // tiles_x) * geo.tile_h, (t % tiles_x) * geo.tile_w
        for p in range(geo.imgs * tile_px):
            il, rem = divmod(p, tile_px)
            gy, gx = ty0 + rem // geo.tile_w, tx0 + rem % geo.tile_w
            if n0 + il < n and gy < ho and gx < wo:
                count[n0 + il, gy, gx, by * geo.nb:(by + 1) * geo.nb] += 1
    return count


def _planned_convs():
    """(n, h, w, c, k, o, pads) of every single conv the engines plan: both
    forced-KERNEL ResNet18 paths (zoo width b8, trained b64) and the
    trained MobileNetV2's folded stem (b64)."""
    from shadernn_tpu_torch.models.resnet18 import build_resnet18_cifar10
    from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED, RESNET18_TRAINED
    from shadernn_tpu_torch.ops.common import padding_offsets

    kernel = dict(device="cpu", backend=P.BackendKind.KERNEL)
    engines = [
        (8, P.Engine.from_graph(build_resnet18_cifar10(), P.EngineOptions(batch_size=8, **kernel))),
        (64, P.Engine.from_json(RESNET18_TRAINED, P.EngineOptions(batch_size=64, **kernel))),
        (64, P.Engine.from_json(MOBILENETV2_TRAINED, P.EngineOptions(device="cpu", batch_size=64))),
    ]
    convs = set()
    for n, eng in engines:
        for name in eng.model.forward.single_conv_plan:
            node = eng.graph.nodes[name]
            s = eng.graph.nodes[node.inputs[0]].out_spec
            k = int(node.attr("kernel_size"))
            convs.add((n, s.h, s.w, s.c, k, int(node.attr("out_channels")),
                       padding_offsets(node.attr("padding", "same"), k)))
    return sorted(convs)


def test_launch_geometry_of_every_planned_conv_fits_and_covers_the_output():
    """At both dtypes, the wrapper's launch of every planned single conv
    (and the edges chip_smoke.py adds: O = 10, images that do not fill a
    multi-image CTA, C = 3) fits 227 KB and writes each output element
    exactly once."""
    planned = _planned_convs()
    # zoo width: stem, 64->64 at 32x32, 128->128 at 16x16; trained: stem and
    # 32/64/128 channels at 16x16, 8x8, 4x4; the MobileNetV2 stem.
    assert len(planned) == 3 + 4 + 1, planned
    edges = [(2, 10, 12, 24, 3, 10, (1, 1, 1, 1)), (3, 4, 4, 128, 3, 128, (1, 1, 1, 1)),
             (8, 32, 32, 3, 3, 64, (1, 1, 1, 1)), (2, 30, 41, 128, 3, 128, (3, 0, 1, 2))]
    multi = 0
    for n, h, w, c, k, o, pads in planned + edges:
        ho, wo = h + pads[0] + pads[1] - k + 1, w + pads[2] + pads[3] - k + 1
        for bf16 in (True, False):
            geo = conv.launch_geometry(n, h, w, c, k, k, o, pads, bf16, 132)
            assert geo.smem <= conv.MAX_SMEM_BYTES, geo
            count = _tile_map(geo, n, ho, wo, o)
            assert count.min() == 1 and count.max() == 1, (n, h, w, c, k, o, bf16, geo)
            multi += geo.imgs > 1
    assert multi >= 2  # the 4x4 convs: several whole images per CTA


def test_f32_stage_layout():
    """The f32 form's shared memory: the input region as f32 rows of the
    chunk's channels plus 4 floats and a zero row, then the weights n-major,
    NB rows of (taps per stage x chunk) floats plus 4; every row an odd
    number of 16-byte units. At the zoo-width ResNet18's 128->128 conv
    (b8, 16x16): an 8x8 tile, one stage of every channel and tap, and 32
    channels per CTA: 128 CTAs of 197 KB, one wave; the bf16 form's 16
    (256 CTAs) would take two waves at one CTA per SM."""
    geo = conv.launch_geometry(8, 16, 16, 128, 3, 3, 128, (1, 1, 1, 1), False, 132)
    assert (geo.tile_h, geo.tile_w, geo.imgs, geo.nb, geo.cc, geo.tg) == (8, 8, 1, 32, 128, 9)
    assert (geo.in_stride, geo.w_stride, geo.w_rows) == (132, 9 * 128 + 4, 32)
    assert geo.w_off == (10 * 10 + 1) * 132 * 4
    assert geo.smem == geo.w_off + 32 * (9 * 128 + 4) * 4 <= conv.MAX_SMEM_BYTES
    assert conv.launch_geometry(8, 16, 16, 128, 3, 3, 128, (1, 1, 1, 1), True, 132).nb == 16
    for n, h, w, c, k, o, pads in _planned_convs():
        geo = conv.launch_geometry(n, h, w, c, k, k, o, pads, False, 132)
        assert geo.w_rows == geo.nb and geo.cc % 8 == 0 and geo.w_stride >= geo.tg * geo.cc
        for stride in (geo.in_stride, geo.w_stride):
            assert (stride * 4) % 16 == 0 and (stride * 4 // 16) % 2 == 1, geo


def test_nmajor_weight_is_made_once_per_weight_tensor():
    """The f32 form reads the weight n-major: row o holds w[:, :, :, o] tap
    by tap with C zero-padded to 8. It is made once per weight tensor and
    made again when the tensor is modified in place."""
    w = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(2, 3, 5, 4)
    wn = conv.nmajor_weight(w)
    assert wn.shape == (4, 2 * 3 * 8) and wn.dtype == torch.float32 and wn.is_contiguous()
    rows = wn.reshape(4, 2, 3, 8)
    assert torch.equal(rows[..., :5], w.permute(3, 0, 1, 2))
    assert not rows[..., 5:].any()
    assert conv.nmajor_weight(w) is wn
    w[0, 0, 0, 0] = -1.0
    again = conv.nmajor_weight(w)
    assert again is not wn and again[0, 0].item() == -1.0
    wb = w.to(torch.bfloat16)  # a bf16 weight under f32: its values, as f32
    assert torch.equal(conv.nmajor_weight(wb), again.to(torch.bfloat16).float())


def test_entry_point_rejects_other_devices():
    w, s = torch.zeros((3, 3, 4, 8)), torch.ones(8)
    with pytest.raises(ValueError):
        conv.fused_conv2d_haloed(torch.zeros((1, 8, 8, 4), device="meta"), w, s, s)


def _declined_chain(builder_cls):
    """ESPCN-shaped, but an 11x11 head: AUTO gives each conv the kernel, the
    chain kernel's gate (k <= 9) declines the chain."""
    b = builder_cls("wide_head", seed=9)
    x = b.input(14, 18, 1)
    x = b.conv2d(x, 16, 11, activation="relu", name="conv_1")
    x = b.conv2d(x, 16, 3, activation="relu", name="conv_2")
    x = b.conv2d(x, 4, 3, name="conv_3")
    x = b.subpixel(x, 2, name="subpixel")
    b.activation(x, "tanh", name="tanh_out")
    return b.build(batch_size=2)


@pytest.mark.parametrize("prec", list(TOL))
def test_declined_chain_runs_convs_on_the_kernel(monkeypatch, rng, prec):
    """The chain the gate declines runs conv by conv on the single-conv
    kernel (no longer on TORCH), then the Subpixel and tanh as ops, as the
    JAX package falls back to its haloed kernel; a conv of one does too."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    x = rng.random((2, 14, 18, 1), dtype=np.float32)
    opts = dict(precision=getattr(P.Precision, prec.upper()), batch_size=2)
    want = np.asarray(J.Engine.from_graph(
        _declined_chain(JBuilder), J.EngineOptions(precision=getattr(J.Precision, prec.upper()),
                                                   batch_size=2)).run_single(x), np.float32)
    eng = P.Engine.from_graph(_declined_chain(PBuilder), P.EngineOptions(device="cpu", **opts))
    fwd = eng.model.forward
    assert fwd.chain_plan == {} and fwd.block_plan == {}
    assert fwd.single_conv_plan == ["conv_1", "conv_2", "conv_3"]
    got = eng.run_single(x).numpy()
    assert got.shape == want.shape == (2, 28, 36, 1)
    assert np.max(np.abs(got - want)) <= TOL[prec]
    torch_fwd = P.Engine.from_graph(
        _declined_chain(PBuilder),
        P.EngineOptions(device="cpu", backend=P.BackendKind.TORCH, **opts)).model.forward
    assert torch_fwd.single_conv_plan == []


def test_singleton_runs_on_the_kernel():
    b = PBuilder("one", seed=1)
    x = b.input(10, 12, 2)
    x = b.conv2d(x, 8, 3, activation="relu", name="k3")
    b.conv2d(x, 8, 1, name="pointwise")  # k=1 stays on TORCH under AUTO
    eng = P.Engine.from_graph(b.build(), P.EngineOptions(device="cpu"))
    assert eng.model.forward.single_conv_plan == ["k3"]
    assert eng.model.forward.chain_plan == {}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"c{c[3]}k{c[4]}o{c[5]}")
def test_int8_weights_match_jax_haloed_kernel(rng, case):
    """Int8 weights under bfloat16 (the INT8 engine's single convs): the
    JAX kernel dequantizes in-kernel, the port's kernel upcasts as it
    stages; folded_operands hands it the int8 weight and the folded scale.
    The plain version against the JAX kernel (Pallas interpret mode)."""
    from shadernn_tpu.quant.quantize import quantize_weight

    n, h, w, c, k, o, padding, act = case
    x = rng.random((n, h, w, c), dtype=np.float32)
    wf = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
    q, s = quantize_weight(wf)
    params = {"weight_q": q, "weight_scale": s,
              "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}
    jnode = JNode("conv", "Conv2D", ["x"], attrs(k, o, padding, act),
                  {key: jnp.asarray(v) for key, v in params.items()})
    want = np.asarray(from_haloed(conv_run_pallas_chain(
        jnode, jnp.asarray(x, jnp.bfloat16), JCtx())), np.float32)
    pnode = PNode("conv", "Conv2D", ["x"], attrs(k, o, padding, act),
                  {key: torch.from_numpy(v) for key, v in params.items()})
    assert conv.single_conv_supported(pnode, c, torch.bfloat16)
    assert not conv.single_conv_supported(pnode, c, torch.float32)
    ops = P.ops.conv.folded_operands(pnode, torch.bfloat16)
    assert ops[0].dtype == torch.int8
    got = conv.conv_run_kernel(pnode, torch.from_numpy(x).to(torch.bfloat16), torch.bfloat16, ops)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.max(np.abs(got.float().numpy() - want)) <= 0.1 * max(1.0, float(np.abs(want).max()))
