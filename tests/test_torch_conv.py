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
from shadernn_tpu_torch.kernels import conv, launch_counts

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}

# (n, h, w, c, k, o, padding, activation)
CASES = [
    (2, 12, 20, 1, 5, 16, "same", "relu"),          # C=1: the JAX side row-packs
    (2, 16, 16, 12, 2, 16, (1, 0, 1, 0), "relu6"),  # the folded MobileNetV2 stem
    (1, 11, 17, 8, 3, 12, (2, 1, 0, 3), "tanh"),    # asymmetric pads
    (2, 9, 14, 3, 4, 5, "same", "leaky_relu"),      # even k: top/left one less
]
# StyleTransfer's two 9x9 convs, narrowed (the wide body, K packed at C = 3,
# an n8 block at O = 3).
K9_CASES = [
    (2, 20, 24, 3, 9, 8, "same", "linear"),         # the stem's shape: C = 3, K packed
    (2, 20, 24, 32, 9, 3, "same", "linear"),        # the head's: O = 3 in an n8 block
]


def attrs(k, o, padding, act):
    return dict(kernel_size=k, out_channels=o, padding=padding, activation=act,
                stride=1, use_bias=True, leaky_alpha=0.3)


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", CASES + K9_CASES, ids=lambda c: f"c{c[3]}k{c[4]}o{c[5]}")
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
    before = launch_counts()
    got = conv.conv_run_kernel(pnode, torch.from_numpy(x).to(tdt), tdt)
    assert launch_counts() == before  # CPU tensors never launch the kernel
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
    geometry: the CTA -> (pixels, channels) map of csrc/conv_single.cu's
    tile body, the same in both forms: grid (M tiles, channel blocks), a
    CTA holding 64 pixel rows (one tile of an image, or `imgs` whole
    images)."""
    count = np.zeros((n, ho, wo, o), np.int32)
    blocks = range(0, o, geo.nb)
    if geo.imgs > 1:
        for n0 in range(0, n, geo.imgs):
            for ob0 in blocks:
                count[n0:n0 + geo.imgs, :geo.tile_h, :geo.tile_w, ob0:ob0 + geo.nb] += 1
        return count
    for ty0 in range(0, ho, geo.tile_h):
        for tx0 in range(0, wo, geo.tile_w):
            for ob0 in blocks:
                count[:, ty0:ty0 + geo.tile_h, tx0:tx0 + geo.tile_w, ob0:ob0 + geo.nb] += 1
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


# StyleTransfer 512x512 b4's two 9x9 convs: (n, h, w, c, k, o, pads).
STYLE_K9 = [(4, 512, 512, 3, 9, 32, (4, 4, 4, 4)), (4, 512, 512, 32, 9, 3, (4, 4, 4, 4))]


def _wide_tiles(geo: conv.ConvLaunch, n, ho, wo):
    """The wide body's persistent walk: CTA b of a channel block takes the
    tiles b, b + grid, ...; returns (tile -> (n0, oy0, ox0), tiles per CTA)."""
    tiles_x = -(-wo // geo.tile_w)
    tiles_img = tiles_x * -(-ho // geo.tile_h)
    mtiles = n * tiles_img
    walks = [list(range(b, mtiles, geo.grid)) for b in range(geo.grid)]
    origin = {}
    for tile in range(mtiles):
        n0, tt = divmod(tile, tiles_img)
        origin[tile] = (n0, (tt // tiles_x) * geo.tile_h, (tt % tiles_x) * geo.tile_w)
    return origin, walks


def _wide_counts(geo: conv.ConvLaunch, n, ho, wo, o):
    """How often the wide body writes each output element: every channel
    block's CTAs walk their tiles and copy out the pixels inside the image
    and the block's channels below O."""
    count = np.zeros((n, ho, wo, o), np.int32)
    origin, walks = _wide_tiles(geo, n, ho, wo)
    for ob0 in range(0, o, geo.nb):
        for walk in walks:
            for tile in walk:
                n0, oy0, ox0 = origin[tile]
                count[n0, oy0:oy0 + geo.tile_h, ox0:ox0 + geo.tile_w, ob0:ob0 + geo.nb] += 1
    return count


def wide_walk(x, w_hwio, scale, offset, pads, act, alpha, geo):
    """Plain model of the wide body's walk (csrc/conv_single.cu
    conv_single_wide_kernel, bfloat16) in PyTorch: the unit table (a tap's (dy, dx)
    shift, or packed a dy row), the block's whole weight as the kernel
    stages it (K index -> HWIO row, zero past C, kw*C and K; an int8 weight
    upcast), for each channel block and each persistent CTA's tiles the
    staged region as flat rows of in_stride values (a position's C channels
    or, packed, the kw*C values of its taps; zeros outside the image), the A
    rows at each pixel's first position plus the unit offsets, the products
    (in float32 from bf16 values), the epilogue and the masked copy-out.
    Returns the output and how often each element was written."""
    from shadernn_tpu_torch.ops.common import apply_activation

    dt = torch.bfloat16
    n, h, wd, c = x.shape
    kh, kw, _, o = w_hwio.shape
    pt, pb, pl, pr = pads
    ho, wo = h + pt + pb - kh + 1, wd + pl + pr - kw + 1
    th, tw, nb, kp, st = geo.tile_h, geo.tile_w, geo.nb, geo.cc, geo.in_stride
    assert geo.body == 1 and geo.tg == kh * kw and kp % 8 == 0
    kunits = kp // 8
    units = (kh if geo.packed else kh * kw) * kunits
    cols = tw if geo.packed else tw + kw - 1
    rows = th + kh - 1
    tab = []
    for i in range(units):
        r, u = divmod(i, kunits)
        pos = r * cols if geo.packed else (r // kw) * cols + r % kw
        tab.append(pos * st + 8 * u)
    w2 = (w_hwio.float() if w_hwio.dtype == torch.int8 else w_hwio.to(dt).float()).reshape(-1, o)
    wk = torch.zeros((units * 8, o))
    for k in range(units * 8):
        r, e = divmod(k // 8, kunits)
        e = e * 8 + k % 8
        if geo.packed and e < kw * c:
            wk[k] = w2[r * kw * c + e]
        elif not geo.packed and e < c:
            wk[k] = w2[r * c + e]
    xv = x.to(dt).float()
    # x in a frame padded far enough that every staged position lands inside it
    m = th + tw + kh + kw
    xp = torch.nn.functional.pad(xv, (0, 0, m, m, m, m))
    pix = torch.arange(32 * geo.wm)
    a_base = torch.where(pix < th * tw, ((pix // tw) * cols + pix % tw) * st, 0)
    a_idx = a_base[:, None] + torch.tensor([tab[k // 8] + k % 8 for k in range(units * 8)])[None]
    y = torch.full((n, ho, wo, o), float("nan"))
    count = torch.zeros((n, ho, wo, o), dtype=torch.int64)
    origin, walks = _wide_tiles(geo, n, ho, wo)
    for ob0 in range(0, o, nb):
        cnt = min(nb, o - ob0)
        for walk in walks:
            for tile in walk:
                n0, oy0, ox0 = origin[tile]
                iy0, ix0 = oy0 - pt + m, ox0 - pl + m
                reg = torch.zeros((rows * cols, st))
                for pos in range(rows * cols):
                    rr, cl = divmod(pos, cols)
                    if geo.packed:  # kw taps of C channels, contiguous in NHWC
                        vals = xp[n0, iy0 + rr, ix0 + cl:ix0 + cl + kw].reshape(-1)
                    else:
                        vals = xp[n0, iy0 + rr, ix0 + cl]
                    reg[pos, :vals.numel()] = vals
                a = reg.reshape(-1)[a_idx]  # (32 * wm, K)
                acc = a @ wk[:, ob0:ob0 + cnt]
                out = apply_activation(acc * scale[ob0:ob0 + cnt].float()
                                       + offset[ob0:ob0 + cnt].float(), act, alpha).to(dt)
                for p in range(th * tw):
                    gy, gx = oy0 + p // tw, ox0 + p % tw
                    if gy < ho and gx < wo:
                        y[n0, gy, gx, ob0:ob0 + cnt] = out[p].float()
                        count[n0, gy, gx, ob0:ob0 + cnt] += 1
    return y, count


# (n, h, w, c, kh, kw, o, pads, activation): the two k9 convs narrowed, O = 1
# and O = 9 around the n8 block, a block of 64 over O = 40, a rectangular
# kernel, tiles that do not divide the output, more tiles than CTAs.
WALK_CASES = [
    (2, 19, 21, 3, 9, 9, 8, (4, 4, 4, 4), "linear"),
    (1, 18, 20, 32, 9, 9, 3, (4, 4, 4, 4), "tanh"),
    (1, 17, 19, 5, 9, 9, 1, (4, 4, 4, 4), "relu"),
    (1, 17, 19, 12, 9, 9, 9, (4, 4, 4, 4), "leaky_relu"),
    (1, 12, 14, 3, 5, 5, 40, (1, 3, 0, 4), "relu6"),
    (1, 14, 17, 4, 5, 9, 16, (2, 2, 4, 4), "gelu"),
]


@pytest.mark.parametrize("form", ["bf16", "bf16 x f32", "int8 w", "int8 w x f32"])
@pytest.mark.parametrize("case", WALK_CASES, ids=lambda c: f"c{c[3]}k{c[4]}x{c[5]}o{c[6]}")
def test_wide_walk_model_matches_reference(rng, case, form):
    """The plain model of the wide body's walk, at the wrapper's bfloat16
    geometry for a card of one SM (at most two CTAs, so that each walks
    several tiles), from a bf16 and an f32 input, bf16 and int8 weights,
    equals the plain version: each output element written once, within the
    conftest tolerance (bf16 products rounded alike, sums in another
    order)."""
    n, h, w, c, kh, kw, o, pads, act = case
    dt = torch.bfloat16
    x_dt = torch.float32 if form.endswith("x f32") else dt
    x = torch.from_numpy(rng.random((n, h, w, c), dtype=np.float32)).to(x_dt)
    wf = (rng.standard_normal((kh, kw, c, o)) / np.sqrt(kh * kw * c)).astype(np.float32)
    wt = (torch.from_numpy(np.clip(np.round(wf * 400), -127, 127).astype(np.int8))
          if form.startswith("int8") else torch.from_numpy(wf))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(o)).astype(np.float32))
    if form.startswith("int8"):
        sc = sc / 400
    of = torch.from_numpy((0.1 * rng.standard_normal(o)).astype(np.float32))
    geo = conv.launch_geometry(n, h, w, c, kh, kw, o, pads, True, 1)
    assert geo == conv.wide_geometry(n, h, w, c, kh, kw, o, pads, 1)
    assert geo.body == 1 and geo.grid <= 2
    assert geo.packed == (c < 8) and geo.nb == max(8, 1 << (o - 1).bit_length())
    got, count = wide_walk(x, wt, sc, of, pads, act, 0.3, geo)
    want = conv.conv2d_haloed_reference(x, wt, sc, of, pads, act, 0.3, dt)
    assert count.min() == 1 and count.max() == 1
    tol = TOL["bf16"] * max(1.0, want.float().abs().max().item())
    assert (got - want.float()).abs().max().item() <= tol


def fma_walk(x, w_hwio, scale, offset, pads, act, alpha, geo):
    """Plain model of the wide body's f32 form on the CUDA cores
    (conv_single_fma_kernel): channel blocks of nb = g * OB channels, each
    persistent CTA's tiles of 32 rows x tile_w columns, the region in
    chunks of cc channels (zeros outside the image and past C), each
    output's float32 sum taken in the kernel's order (chunk by chunk, then
    channel, dy, dx), the epilogue and the masked copy-out. Returns the
    output and how often each element was written."""
    from shadernn_tpu_torch.ops.common import apply_activation

    n, h, wd, c = x.shape
    kh, kw, _, o = w_hwio.shape
    pt, pb, pl, pr = pads
    ho, wo = h + pt + pb - kh + 1, wd + pl + pr - kw + 1
    th, tw, nb, cc = geo.tile_h, geo.tile_w, geo.nb, geo.cc
    assert geo.body == 2 and th == 32 and kw in conv.FMA_KW
    m = th + tw + kh + kw
    xp = torch.nn.functional.pad(x.float(), (0, 0, m, m, m, m))
    wt = w_hwio.float()
    y = torch.full((n, ho, wo, o), float("nan"))
    count = torch.zeros((n, ho, wo, o), dtype=torch.int64)
    origin, walks = _wide_tiles(geo, n, ho, wo)
    for ob0 in range(0, o, nb):
        cnt = min(nb, o - ob0)
        for walk in walks:
            for tile in walk:
                n0, oy0, ox0 = origin[tile]
                reg = xp[n0, oy0 - pt + m:oy0 - pt + m + th + kh - 1,
                         ox0 - pl + m:ox0 - pl + m + tw + kw - 1]
                acc = torch.zeros((th, tw, cnt))
                for c0 in range(0, c, cc):
                    for ci in range(c0, min(c, c0 + cc)):
                        for dy in range(kh):
                            for dx in range(kw):
                                acc += reg[dy:dy + th, dx:dx + tw, ci, None] * wt[dy, dx, ci,
                                                                                 ob0:ob0 + cnt]
                out = apply_activation(acc * scale[ob0:ob0 + cnt].float()
                                       + offset[ob0:ob0 + cnt].float(), act, alpha)
                hh, ww = min(th, ho - oy0), min(tw, wo - ox0)
                y[n0, oy0:oy0 + hh, ox0:ox0 + ww, ob0:ob0 + cnt] = out[:hh, :ww]
                count[n0, oy0:oy0 + hh, ox0:ox0 + ww, ob0:ob0 + cnt] += 1
    return y, count


@pytest.mark.parametrize("x_dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", [c for c in WALK_CASES if c[5] in conv.FMA_KW],
                         ids=lambda c: f"c{c[3]}k{c[4]}x{c[5]}o{c[6]}")
def test_fma_walk_model_matches_reference(rng, case, x_dt):
    """The wrapper's float32 launch of these convs is the CUDA-core form
    (its weight fits); the plain model of its walk, for a card of one SM,
    equals the plain version, each output element written once."""
    n, h, w, c, kh, kw, o, pads, act = case
    x = torch.from_numpy(rng.random((n, h, w, c), dtype=np.float32))
    x = x.to(torch.bfloat16) if x_dt == "bf16" else x
    wt = torch.from_numpy((rng.standard_normal((kh, kw, c, o)) / np.sqrt(kh * kw * c))
                          .astype(np.float32))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(o)).astype(np.float32))
    of = torch.from_numpy((0.1 * rng.standard_normal(o)).astype(np.float32))
    geo = conv.launch_geometry(n, h, w, c, kh, kw, o, pads, False, 1)
    assert geo.body == 2 and geo.grid <= 2 and geo.smem <= conv.MAX_SMEM_BYTES
    assert geo.nb == (o if o <= 4 else 8 * min(8, 1 << (-(-o // 8) - 1).bit_length()))
    got, count = fma_walk(x, wt, sc, of, pads, act, 0.3, geo)
    want = conv.conv2d_haloed_reference(x, wt, sc, of, pads, act, 0.3, torch.float32)
    assert count.min() == 1 and count.max() == 1
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_body_of_every_planned_conv_is_pinned():
    """The rule: the wide body for kernels of at least 25 taps, the tile
    body below; under float32 the wide body's form on the CUDA cores where
    kw is 5, 7 or 9, the tile body for the other widths. Every planned single conv of the ResNet18 and MobileNetV2
    paths (k3, k2) stays on the tile body at both dtypes, StyleTransfer's
    stem and head take the wide body: packed K at the stem (C = 3: a
    staged position holds 9 taps x 3 channels, 27 -> 32), an n8 block at
    the head (O = 3); 16x16 tiles, two CTAs a SM (the head's with one
    buffer: its 41 KB weight beside two would leave one); a grid of one
    wave. Under float32
    both take the form on the CUDA cores: 32-row tiles, the stem's 32
    channels as 4 groups of 8 (16 columns), the head's 3 channels in one
    (32 columns, 4 channels a chunk), two CTAs a SM."""
    assert conv.WIDE_TAPS == 25 and conv.FMA_KW == (5, 7, 9)
    for k in range(1, 10):
        for kw in range(1, 10):
            geo = conv.launch_geometry(2, 40, 40, 8, k, kw, 16, (0, 0, 0, 0), True, 132)
            assert geo.body == (k * kw >= 25), (k, kw)
            geo = conv.launch_geometry(2, 40, 40, 8, k, kw, 16, (0, 0, 0, 0), False, 132)
            assert geo.body == (2 if k * kw >= 25 and kw in conv.FMA_KW else 0), (k, kw)
    for n, h, w, c, k, o, pads in _planned_convs():
        for bf16 in (True, False):
            assert conv.launch_geometry(n, h, w, c, k, k, o, pads, bf16, 132).body == 0
    want = {  # (bf16, conv): (body, packed, cc, nb, tile, bufs, grid)
        (True, 3): (1, 1, 32, 32, (16, 16), 2, 264), (True, 32): (1, 0, 32, 8, (16, 16), 1, 264),
        (False, 3): (2, 0, 3, 32, (32, 16), 2, 264), (False, 32): (2, 0, 4, 3, (32, 32), 2, 264),
    }
    for n, h, w, c, k, o, pads in STYLE_K9:
        for bf16 in (True, False):
            geo = conv.launch_geometry(n, h, w, c, k, k, o, pads, bf16, 132)
            assert (geo.body, geo.packed, geo.cc, geo.nb, (geo.tile_h, geo.tile_w), geo.in_bufs,
                    geo.grid) == want[(bf16, c)], (bf16, c, geo)


# Float32 convs of 25 taps or more that the CUDA-core form does not take:
# (n, h, w, c, kh, kw, o, pads). kw outside FMA_KW (11, 6, a 9x3 kernel), or
# a block weight past its shared memory (k9 32->128, k7 64->64, k5 128->128).
F32_TILE_CASES = [
    (2, 30, 34, 3, 11, 11, 16, (5, 5, 5, 5)),
    (1, 40, 44, 32, 11, 11, 3, (5, 5, 5, 5)),
    (2, 33, 35, 8, 9, 3, 16, (4, 4, 1, 1)),
    (2, 20, 21, 16, 6, 6, 24, (2, 3, 3, 2)),
    (2, 48, 40, 32, 9, 9, 128, (4, 4, 4, 4)),
    (1, 24, 30, 64, 7, 7, 64, (3, 3, 3, 3)),
    (2, 16, 18, 128, 5, 5, 128, (2, 2, 2, 2)),
]


@pytest.mark.parametrize("case", F32_TILE_CASES, ids=lambda c: f"c{c[3]}k{c[4]}x{c[5]}o{c[6]}")
def test_f32_convs_the_cuda_core_form_declines_run_on_the_tile_body(case):
    """Under float32 a conv of 25 taps or more that the wide body's CUDA-core
    form does not take (kw not 5, 7 or 9, or its weight too large) runs on
    the tile body's 3xTF32 form, as every conv did before the wide body: the
    wrapper's launch is `tile_geometry`'s, fits 227 KB and writes each
    output element once. Under bfloat16 the same conv takes the wide body."""
    n, h, w, c, kh, kw, o, pads = case
    assert kh * kw >= conv.WIDE_TAPS and kh * kw * c <= 4096
    if kw in conv.FMA_KW:
        assert conv.fma_geometry(n, h, w, c, kh, kw, o, pads, 132).smem > conv.MAX_SMEM_BYTES
    geo = conv.launch_geometry(n, h, w, c, kh, kw, o, pads, False, 132)
    assert geo.body == 0 and geo == conv.tile_geometry(n, h, w, c, kh, kw, o, pads, False, 132)
    assert geo.smem <= conv.MAX_SMEM_BYTES, geo
    ho, wo = h + pads[0] + pads[1] - kh + 1, w + pads[2] + pads[3] - kw + 1
    count = _tile_map(geo, n, ho, wo, o)
    assert count.min() == 1 and count.max() == 1, geo
    assert conv.launch_geometry(n, h, w, c, kh, kw, o, pads, True, 132).body == 1


@pytest.mark.parametrize("body", ["tile", "wide", "wide f32 on the CUDA cores"])
def test_both_bodies_fit_and_cover_every_planned_conv(body):
    """Either body can run every planned conv and StyleTransfer's two k9
    convs at 512x512 b4 (the wide body: bfloat16; its CUDA-core form:
    float32, the k9 convs; the tile body: both dtypes): its launch fits
    227 KB and its walk (the tile body's grid;
    the wide body's persistent CTAs over the tiles of each channel block)
    writes each output element exactly once."""
    counts = _tile_map if body == "tile" else _wide_counts
    for n, h, w, c, k, o, pads in _planned_convs() + STYLE_K9:
        ho, wo = h + pads[0] + pads[1] - k + 1, w + pads[2] + pads[3] - k + 1
        for bf16 in (True, False):
            if body == "tile":
                geo = conv.tile_geometry(n, h, w, c, k, k, o, pads, bf16, 132)
            elif body == "wide":
                if not bf16:
                    continue
                geo = conv.wide_geometry(n, h, w, c, k, k, o, pads, 132)
            else:
                if bf16 or k not in conv.FMA_KW:
                    continue
                geo = conv.fma_geometry(n, h, w, c, k, k, o, pads, 132)
            assert geo.smem <= conv.MAX_SMEM_BYTES, geo
            count = counts(geo, n, ho, wo, o)
            assert count.min() == 1 and count.max() == 1, (n, h, w, c, k, o, bf16, geo)


def test_wide_layout_of_the_k9_convs():
    """The wide body's shared memory at StyleTransfer's head, bf16: the unit
    table (81 taps x 4 units + the padding entry) and the block's scale and
    offset, the whole weight k-major (2592 rows of 8 bf16: one 16-byte unit,
    odd), one 24x24 region of 32 channels (rows of 40 bf16, five units),
    the output tile (256 pixels x 16); every row an odd number of 16-byte
    units where ldmatrix reads it."""
    geo = conv.launch_geometry(*STYLE_K9[1][:5], 9, 3, STYLE_K9[1][6], True, 132)
    assert (geo.w_rows, geo.w_stride, geo.in_stride, geo.out_stride) == (2592, 8, 40, 16)
    assert geo.w_off == -(-((4 * (81 * 4 + 1) + 15) // 16 * 16 + 8 * 8) // 128) * 128
    assert geo.in_off == -(-(geo.w_off + 2592 * 8 * 2) // 128) * 128
    assert geo.in_bufs == 1 and geo.out_off == -(-(geo.in_off + 24 * 24 * 40 * 2) // 128) * 128
    assert geo.smem == geo.out_off + 256 * 16 * 2
    for n, h, w, c, k, o, pads in STYLE_K9:
        geo = conv.wide_geometry(n, h, w, c, k, k, o, pads, 132)
        for stride in (geo.in_stride, geo.w_stride):
            assert (stride * 2) % 16 == 0 and (stride * 2 // 16) % 2 == 1, geo
        # the CUDA-core form (float32): planes' rows of odd 16-byte units
        geo = conv.fma_geometry(n, h, w, c, k, k, o, pads, 132)
        assert geo.in_stride % 4 == 0 and (geo.in_stride // 4) % 2 == 1, geo
        assert geo.smem + 1024 <= conv.SMEM_PER_SM // 2, geo  # two CTAs a SM
