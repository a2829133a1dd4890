"""The port's implicit-GEMM conv module
(shadernn_tpu_torch.kernels.conv_igemm) against the JAX package's per-layer
conv kernel (`conv2d_pallas_nhwc`, which reaches `fused_conv2d_nhcw`, in
Pallas interpret mode), and the engine path that carries it: a Conv2D the
caller gives to KERNEL and no chain takes, here the two-input conv. On the
CPU the port's entry point runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.graph.ir import Graph as JGraph
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.kernels.conv_pallas import conv2d_pallas_nhwc

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.compile import OperandStore
from shadernn_tpu_torch.graph.ir import Graph as PGraph
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.kernels import conv_igemm, launch_counts
from shadernn_tpu_torch.ops import get_op as p_op
from shadernn_tpu_torch.ops.conv import kernel_conv_supported
from shadernn_tpu_torch.ops.registry import RunCtx as PCtx

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


# (n, h, w, c, k, o, stride, pads, activation, int8 weights)
CASES = [
    (2, 12, 20, 8, 3, 16, 1, (1, 1, 1, 1), "relu", False),
    (1, 10, 16, 1, 5, 16, 1, (2, 2, 2, 2), "tanh", False),      # C=1: the JAX side pads channels
    (2, 9, 14, 3, 4, 5, 1, (1, 2, 1, 2), "leaky_relu", False),  # even k: top/left one less
    (1, 11, 17, 8, 3, 12, 1, (2, 1, 0, 3), "sigmoid", False),   # asymmetric pads
    (2, 8, 8, 16, 1, 24, 1, (0, 0, 0, 0), "linear", False),
    (1, 12, 16, 8, 3, 16, 1, (1, 1, 1, 1), "relu", True),
    (2, 12, 20, 8, 3, 8, 2, (1, 1, 1, 1), "relu", False),       # stride 2: interpret mode only in JAX
    (1, 12, 12, 4, 4, 4, 2, (1, 2, 1, 2), "linear", False),
]


def operands(rng, c, k, o, int8):
    if int8:
        w = rng.integers(-127, 128, (k, k, c, o)).astype(np.int8)
        scale = (0.02 / np.sqrt(k * k * c) * (1 + 0.1 * rng.standard_normal(o))).astype(np.float32)
    else:
        w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
        scale = (rng.random(o) + 0.5).astype(np.float32)
    return w, scale, (0.3 * rng.standard_normal(o)).astype(np.float32)


def case_id(c):
    return f"c{c[3]}k{c[4]}o{c[5]}s{c[6]}" + ("_int8" if c[9] else "")


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_matches_jax_kernel(rng, case, prec):
    n, h, w, c, k, o, stride, pads, act, int8 = case
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt, scale, offset = operands(rng, c, k, o, int8)
    tdt, jdt = DTYPES[prec]
    want = np.asarray(conv2d_pallas_nhwc(
        jnp.asarray(x, jdt), jnp.asarray(wt) if int8 else jnp.asarray(wt, jdt),
        jnp.asarray(scale), jnp.asarray(offset), stride=stride, pads=pads, activation=act,
        interpret=True), np.float32)
    before = launch_counts()
    got = conv_igemm.conv2d_kernel_nhwc(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wt) if int8 else torch.from_numpy(wt).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(offset), stride=stride, pads=pads,
        activation=act)
    assert launch_counts() == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def conv_node(node_cls, k, o, act="relu", stride=1, **params):
    return node_cls("n", "Conv2D", ["x"],
                    dict(kernel_size=k, out_channels=o, padding="same", activation=act,
                         stride=stride, use_bias=False),
                    params or {"weight": np.zeros((k, k, 1, o), np.float32)})


@pytest.mark.parametrize("k,o,stride,c", [
    (3, 128, 1, 128), (3, 129, 1, 16), (3, 16, 1, 129), (5, 8, 1, 128), (6, 8, 1, 113),
    (3, 8, 2, 8), (17, 4, 1, 14), (19, 4, 1, 11),
])
def test_gate_is_the_jax_gate(k, o, stride, c):
    from shadernn_tpu.ops.conv import pallas_conv_supported

    assert kernel_conv_supported(conv_node(PNode, k, o, stride=stride), c) == \
        pallas_conv_supported(conv_node(JNode, k, o, stride=stride), (1, 8, 8, c))


def test_gate_declines_softmax_and_int8_storage():
    """Softmax stays declined; int8 weight storage is taken (the kernel
    reads int8, the scale arrives folded)."""
    assert conv_igemm.igemm_conv_supported(conv_node(PNode, 3, 8), 4)
    assert not conv_igemm.igemm_conv_supported(conv_node(PNode, 3, 8, "softmax"), 4)
    assert conv_igemm.igemm_conv_supported(
        conv_node(PNode, 3, 8, weight_q=np.zeros(1, np.int8)), 4)
    w, s = torch.zeros((3, 3, 4, 8)), torch.ones(8)
    with pytest.raises(ValueError):
        conv_igemm.conv2d_kernel_nhwc(torch.zeros((1, 8, 8, 4), device="meta"), w, s, s)


def two_input_graph(graph_cls, node_cls, rng, h=10, w=12):
    """The reference's use_multi_inputs conv: inputs of 3 and 5 channels,
    one k3 conv over both, 8 -> 16, bias and relu."""
    g = graph_cls()
    g.add(node_cls("a", "InputLayer", [], {"height": h, "width": w, "channels": 3}))
    g.add(node_cls("b", "InputLayer", [], {"height": h, "width": w, "channels": 5, "index": 1}))
    g.add(node_cls("conv", "Conv2D", ["a", "b"],
                   {"kernel_size": 3, "stride": 1, "padding": "same", "out_channels": 16,
                    "use_multi_inputs": True, "use_bias": True, "activation": "relu"},
                   {"weight": (rng.standard_normal((3, 3, 8, 16)) * 0.3).astype(np.float32),
                    "bias": (rng.standard_normal(16) * 0.3).astype(np.float32)}))
    g.finalize()
    g.infer_shapes(batch_size=2)
    return g


@pytest.mark.parametrize("prec", list(TOL))
def test_two_input_conv_under_kernel_matches_jax(prec):
    """Forced to the kernel, the two-input conv is what no chain takes: the
    JAX package runs it on `_conv_kernel`, the port plans it for the
    implicit-GEMM kernel."""
    seed = 7767517
    xa = np.random.default_rng(1).random((2, 10, 12, 3), dtype=np.float32)
    xb = np.random.default_rng(2).random((2, 10, 12, 5), dtype=np.float32)
    jg = two_input_graph(JGraph, JNode, np.random.default_rng(seed))
    jmodel = J.engine.compile.compile_graph(jg, J.EngineOptions(
        precision=getattr(J.Precision, prec.upper()), backend=J.BackendKind.PALLAS, batch_size=2))
    assert jmodel.forward.chain_plan == {}
    want = np.asarray(jmodel({"a": xa, "b": xb})["conv"], np.float32)

    calls = []
    real = conv_igemm.run

    def counted(x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(x, *a, **kw)

    pg = two_input_graph(PGraph, PNode, np.random.default_rng(seed))
    eng = P.Engine.from_graph(pg, P.EngineOptions(
        device="cpu", precision=getattr(P.Precision, prec.upper()),
        backend=P.BackendKind.KERNEL, batch_size=2))
    fwd = eng.model.forward
    assert fwd.kernel_conv_plan == ["conv"]
    assert fwd.chain_plan == {} and fwd.single_conv_plan == [] and fwd.kernel_dense_plan == []
    conv_igemm.run = counted
    try:
        got = eng.run({"a": xa, "b": xb})["conv"].numpy()
    finally:
        conv_igemm.run = real
    assert calls == [(2, 10, 12, 8)]
    assert got.shape == want.shape == (2, 10, 12, 16)
    assert np.max(np.abs(got - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))
    # Under AUTO nothing gives a two-input conv to the kernel.
    auto = P.Engine.from_graph(two_input_graph(PGraph, PNode, np.random.default_rng(seed)),
                               P.EngineOptions(device="cpu", batch_size=2)).model.forward
    assert auto.kernel_conv_plan == []


def test_conv_op_honours_the_kernel_backend(rng, caplog):
    """Conv2D.run under KERNEL: concat, then the kernel where the gate
    holds, TORCH with a log line that names the gate where it does not
    (stride 2)."""
    calls = []
    real = conv_igemm.run

    def counted(x, *a, **kw):
        calls.append(kw["stride"])
        return real(x, *a, **kw)

    conv_igemm.run = counted
    try:
        for stride in (1, 2):
            node = conv_node(PNode, 3, 6, stride=stride, weight=torch.from_numpy(
                (rng.standard_normal((3, 3, 5, 6)) / 7).astype(np.float32)))
            xs = [torch.from_numpy(rng.standard_normal((1, 8, 9, c)).astype(np.float32))
                  for c in (2, 3)]
            got = p_op("Conv2D").run(node, xs, PCtx(backend=P.BackendKind.KERNEL))
            want = p_op("Conv2D").run(node, xs, PCtx(backend=P.BackendKind.TORCH))
            assert (got - want).abs().max().item() <= 1e-5
    finally:
        conv_igemm.run = real
    assert calls == [1]
    assert caplog.text.count("conv n given to KERNEL runs on TORCH: outside the implicit-GEMM") == 1


def test_two_input_conv_int8_under_kernel_matches_jax():
    """Under INT8 the two-input conv's weights are int8 and the kernel's
    gate takes them: folded_operands hands the implicit-GEMM kernel the
    int8 weight and the folded scale, as the JAX package hands its
    `_conv_kernel` (Pallas interpret mode) the int8 weight."""
    seed = 7767517
    xa = np.random.default_rng(1).random((2, 10, 12, 3), dtype=np.float32)
    xb = np.random.default_rng(2).random((2, 10, 12, 5), dtype=np.float32)
    jeng = J.Engine.from_graph(two_input_graph(JGraph, JNode, np.random.default_rng(seed)),
                               J.EngineOptions(precision=J.Precision.INT8,
                                               backend=J.BackendKind.PALLAS, batch_size=2),
                               optimize=False)
    want = np.asarray(jeng.run({"a": xa, "b": xb})["conv"], np.float32)
    seen = []
    real = conv_igemm.run

    def counted(x, ops, *a, **kw):
        seen.append(ops.w.dtype)
        return real(x, ops, *a, **kw)

    eng = P.Engine.from_graph(two_input_graph(PGraph, PNode, np.random.default_rng(seed)),
                              P.EngineOptions(device="cpu", precision=P.Precision.INT8,
                                              backend=P.BackendKind.KERNEL, batch_size=2),
                              optimize=False)
    assert "weight_q" in eng.graph.nodes["conv"].params
    assert eng.model.forward.kernel_conv_plan == ["conv"]
    conv_igemm.run = counted
    try:
        got = eng.run({"a": xa, "b": xb})["conv"].numpy()
    finally:
        conv_igemm.run = real
    assert seen == [torch.int8]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 0.1 * max(1.0, float(np.abs(want).max()))


# -- The tensor-core kernel's launch geometry, packed weights and arithmetic ----
# The CUDA kernel is held against its plain version on the card
# (chip_smoke.py); here its geometry is held to what csrc/conv_igemm.cu
# checks, and a model of its walk (the staged regions with their halo and
# stride, the table of unit offsets, the staged weights, the channel blocks,
# the persistent order of the tiles, the masked copy-out) to the plain
# version and the JAX kernel.

from shadernn_tpu_torch.kernels.tf32 import matmul_split, tf32_split  # noqa: E402


def _holds(geo, c, kh, kw, o, stride, f32):
    """csrc/conv_igemm.cu run's checks, and the layout it derives."""
    esz, epu = (4, 4) if f32 else (2, 8)
    nb = geo.nb
    assert geo.nt in (1, 2, 4) and geo.wm in (1, 2, 4, 8)
    assert 1 <= geo.tile_h and 1 <= geo.tile_w and geo.tile_h * geo.tile_w <= 32 * geo.wm
    assert geo.cc >= 8 and geo.cc % 8 == 0 and 1 <= geo.tg <= kh * kw and 2 <= geo.bufs <= 4
    assert geo.in_stride >= geo.cc and geo.in_stride % epu == 0
    assert (geo.in_stride // epu) % 2 == 1  # an odd number of 16-byte units: ldmatrix rows
    if f32:
        assert geo.w_stride >= geo.tg * geo.cc and geo.w_stride % 4 == 0 and geo.w_rows == nb
        w_buf = geo.w_rows * geo.w_stride * 4 * 2
    else:
        assert geo.w_stride >= nb and geo.w_stride % 8 == 0
        assert geo.w_rows >= geo.tg * geo.cc and geo.w_rows % 16 == 0
        w_buf = geo.w_rows * geo.w_stride * 2
    assert geo.out_stride >= nb and geo.out_stride % epu == 0
    stages = -(-c // geo.cc) * -(-(kh * kw) // geo.tg)
    region = ((geo.tile_h - 1) * stride + kh) * ((geo.tile_w - 1) * stride + kw)
    in_buf = -(-region * geo.in_stride * esz // 16) * 16
    so_off = -(-4 * (kh * kw * geo.cc // 8 + 1) // 16) * 16
    ivs = [(geo.tab_off, so_off + 8 * nb), (geo.in_off, geo.bufs * in_buf),
           (geo.w_off, (geo.bufs if stages > 1 else 1) * w_buf),
           (geo.out_off, 32 * geo.wm * geo.out_stride * esz)]
    assert geo.smem <= conv_igemm.MAX_SMEM_BYTES
    for i, (off, size) in enumerate(ivs):
        assert off % 16 == 0 and 0 <= off and off + size <= geo.smem, (i, geo)
        for off2, size2 in ivs[:i]:
            assert off >= off2 + size2 or off2 >= off + size, (geo, ivs)


def _covers_once(geo, n, ho, wo, o):
    """Each output pixel and channel exactly once: the channel blocks, and in
    each the persistent CTAs b = 0 .. grid-1 taking tiles b, b + grid, ...
    of tile_h x tile_w."""
    tiles_x, tiles_y = -(-wo // geo.tile_w), -(-ho // geo.tile_h)
    mtiles = n * tiles_x * tiles_y
    assert 1 <= geo.grid <= mtiles
    hits = np.zeros((n, ho, wo, o), np.int32)
    for ob0 in range(0, o, geo.nb):
        for b in range(geo.grid):
            for tile in range(b, mtiles, geo.grid):
                n0, tt = divmod(tile, tiles_x * tiles_y)
                oy0, ox0 = (tt // tiles_x) * geo.tile_h, (tt % tiles_x) * geo.tile_w
                hits[n0, oy0:oy0 + geo.tile_h, ox0:ox0 + geo.tile_w, ob0:ob0 + geo.nb] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 11])
def test_geometry_of_admitted_convs_fits_and_covers_each_output_once(k, f32):
    """Every C and O at the gate's unit edges (c <= 128, o <= 128,
    k*k*c <= 4096), planes from 1x1 to 540p, batches 1-8, strides 1 and 2
    (the kernel's function; the gate keeps 1): the launch fits 227 KB with
    the layout the kernel checks and covers each output once."""
    rng = np.random.default_rng(100 + k + 50 * f32)
    for c in (1, 3, 8, 9, 16, 24, 64, 128):
        for o in (1, 8, 10, 16, 17, 40, 64, 128):
            if k * k * c > 4096:
                continue
            n = int(rng.choice([1, 2, 8]))
            h, w = (int(v) for v in rng.choice([1, 4, 7, 16, 33, 540], 2))
            stride = int(rng.choice([1, 2]))
            pads = tuple(int(v) for v in rng.integers(0, k, 4))
            if h + pads[0] + pads[1] < k or w + pads[2] + pads[3] < k:
                continue
            geo = conv_igemm.launch_geometry(n, h, w, c, k, k, o, stride, pads, f32, 132)
            _holds(geo, c, k, k, o, stride, f32)
            ho, wo = conv_igemm.out_hw(h, w, k, k, stride, pads)
            if n * ho * wo * o <= 2_000_000:
                _covers_once(geo, n, ho, wo, o)


def test_geometry_of_the_main_path_conv():
    """The two-input graph's conv (8x540x960, 8 -> 16, k3): 256-pixel 16x16
    tiles, every channel in one block, every tap and channel in one stage
    (weights staged once per CTA), four stages deep, one wave of two CTAs
    per SM."""
    for f32 in (False, True):
        geo = conv_igemm.launch_geometry(8, 540, 960, 8, 3, 3, 16, 1, (1, 1, 1, 1), f32, 132)
        assert (geo.nt, geo.wm, geo.tile_h, geo.tile_w, geo.cc, geo.tg, geo.bufs) == (
            2, 8, 16, 16, 8, 9, 4)
        assert geo.nb == 16 and geo.grid == 264
        _holds(geo, 8, 3, 3, 16, 1, f32)


@pytest.mark.parametrize("c,k,o", [(8, 3, 16), (3, 5, 10), (64, 8, 128), (13, 2, 7)])
def test_nmajor_split_follows_the_kernel_k_order(rng, c, k, o):
    """The f32 form's weight: row n holds output channel n's weights tap by
    tap, C padded to 8; hi + lo is the HWIO weight within 2^-22, both TF32.
    An int8 weight stays int8 (exact in TF32: no lo); so does a weight
    exact in TF32 keep no lo."""
    w = torch.from_numpy(rng.standard_normal((k, k, c, o)).astype(np.float32))
    hi, lo = conv_igemm.nmajor_split(w)
    c8 = -(-c // 8) * 8
    assert hi.shape == (o, k * k * c8) and lo is not None
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    full = (hi.double() + lo.double()).reshape(o, k, k, c8)
    assert not full[..., c:].any()
    want = w.double().permute(3, 0, 1, 2)
    assert torch.all((full[..., :c] - want).abs() <= 2.0 ** -22 * want.abs())
    # once per weight tensor: `prepare` splits it, the model's store keeps it
    ones, store = torch.ones(o), OperandStore()
    store.sync({"conv": {"weight": w}})
    ops = store.get("conv", lambda: conv_igemm.prepare(w, ones, ones, torch.float32))
    assert torch.equal(ops.w, hi) and torch.equal(ops.w_lo, lo) and ops.hwio is w
    assert store.get("conv", None) is ops
    w8 = torch.from_numpy(rng.integers(-127, 128, (k, k, c, o)).astype(np.int8))
    q, no_lo = conv_igemm.nmajor_split(w8)
    assert q.dtype == torch.int8 and no_lo is None
    assert torch.equal(q.reshape(o, k, k, c8)[..., :c], w8.permute(3, 0, 1, 2))
    exact = hi.reshape(o, k, k, c8)[..., :c].permute(1, 2, 3, 0).contiguous()
    assert conv_igemm.nmajor_split(exact)[1] is None


def emulate(x, w, scale, offset, stride, pads, act, geo):
    """The kernel's walk in PyTorch: for each channel block and each
    persistent CTA's tiles, the staged input region of each chunk (its
    halo, its stride, zeros outside the image and past C), per tap group
    the A rows at each pixel's first position plus the unit's table offset
    and the staged weights (bf16: k-major from HWIO, int8 upcast; f32:
    n-major hi and lo, int8 upcast with no lo), products in the form's
    arithmetic (f32: 3xTF32 per tap, kernels/tf32.py), then the epilogue
    and the masked copy-out. Returns the output and each tile's visits."""
    f32 = x.dtype == torch.float32
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    pt, pb, pl, pr = pads
    ho, wo = conv_igemm.out_hw(h, wd, kh, kw, stride, pads)
    nb, th, tw, cc, tg = geo.nb, geo.tile_h, geo.tile_w, geo.cc, geo.tg
    taps, cunits = kh * kw, cc // 8
    rows, cols = (th - 1) * stride + kh, (tw - 1) * stride + kw
    tiles_x = -(-wo // tw)
    tiles_img = tiles_x * -(-ho // th)
    mtiles = n * tiles_img
    tab = [((tap // kw) * cols + tap % kw) * geo.in_stride + 8 * u
           for tap in range(taps) for u in range(cunits)] + [0]
    px = torch.arange(geo.bm)
    a_base = torch.where(px < th * tw, ((px // tw) * cols + px % tw) * stride * geo.in_stride, 0)
    xp = torch.nn.functional.pad(x.float(), (0, cc, pl + tw * stride + kw, pr + tw * stride + kw,
                                             pt + th * stride + kh, pb + th * stride + kh))
    if f32:
        wn, wlo = conv_igemm.nmajor_split(w if w.dtype == torch.int8 else w.float())
        wn = wn.float()
        wlo = torch.zeros_like(wn) if wlo is None else wlo
        c8 = -(-c // 8) * 8
    else:
        wk = w.to(torch.bfloat16).float()
    y = torch.full((n, ho, wo, o), float("nan"))
    visits = torch.zeros(mtiles, dtype=torch.int64)
    for ob0 in range(0, o, nb):
        cnt = min(nb, o - ob0)
        for b in range(geo.grid):
            for tile in range(b, mtiles, geo.grid):
                visits[tile] += 1
                n0, tt = divmod(tile, tiles_img)
                oy0, ox0 = (tt // tiles_x) * th, (tt % tiles_x) * tw
                acc = torch.zeros((geo.bm, nb))
                for ci in range(-(-c // cc)):
                    c0 = ci * cc
                    iy0 = oy0 * stride - pt + pt + th * stride + kh  # into xp's padded frame
                    ix0 = ox0 * stride - pl + pl + tw * stride + kw
                    reg = torch.zeros((rows * cols, geo.in_stride))
                    chans = xp[n0, iy0:iy0 + rows, ix0:ix0 + cols, c0:c0 + cc].clone()
                    chans[..., max(0, c - c0):] = 0
                    reg[:, :cc] = chans.reshape(rows * cols, cc)
                    flat = reg.reshape(-1)
                    for grp in range(-(-taps // tg)):
                        ntap = min(tg, taps - grp * tg)
                        for tap_l in range(ntap):
                            tap = grp * tg + tap_l
                            cols_k = [flat[a_base + tab[tap * cunits + u] + e]
                                      for u in range(cunits) for e in range(8)]
                            a = torch.stack(cols_k, 1)  # (bm, cc): the tap's A rows
                            ch = torch.arange(c0, c0 + cc)
                            if f32:
                                k0 = tap * c8
                                sel = (ch < c8).float()[:, None]
                                rows_w = torch.clamp(ch, max=c8 - 1) + k0
                                bh = torch.zeros((cc, nb))
                                bl = torch.zeros((cc, nb))
                                bh[:, :cnt] = wn[ob0:ob0 + cnt, rows_w].t() * sel
                                bl[:, :cnt] = wlo[ob0:ob0 + cnt, rows_w].t() * sel
                                ah, al = tf32_split(a)
                                acc = acc + matmul_split(ah, al, bh, bl)
                            else:
                                bk = torch.zeros((cc, nb))
                                ok = ch < c
                                bk[ok, :cnt] = wk[tap // kw, tap % kw][ch[ok]][:, ob0:ob0 + cnt]
                                acc = acc + a @ bk
                v = apply_act_(acc[:, :cnt] * scale[ob0:ob0 + cnt].float()
                               + offset[ob0:ob0 + cnt].float(), act)
                for p in range(th * tw):
                    gy, gx = oy0 + p // tw, ox0 + p % tw
                    if gy < ho and gx < wo:
                        y[n0, gy, gx, ob0:ob0 + cnt] = v[p]
    return y.to(x.dtype), visits


def apply_act_(v, act):
    from shadernn_tpu_torch.ops.common import apply_activation

    return apply_activation(v, act, 0.3)


# (n, h, w, c, k, o, stride, pads, activation, int8 weights, forced (cc, tg, grid) or None)
EMULATED = [
    (2, 12, 20, 8, 3, 16, 1, (1, 1, 1, 1), "relu", False, None),
    (1, 11, 17, 8, 3, 12, 1, (2, 1, 0, 3), "sigmoid", False, None),     # asymmetric pads
    (2, 12, 20, 8, 3, 8, 2, (1, 1, 1, 1), "relu", False, None),         # stride 2
    (1, 12, 12, 4, 4, 4, 2, (1, 2, 1, 2), "linear", False, None),       # stride 2, even k
    (2, 9, 14, 3, 4, 10, 1, (1, 2, 1, 2), "leaky_relu", False, None),   # C = 3, O = 10
    (1, 12, 16, 16, 3, 16, 1, (1, 1, 1, 1), "relu", True, None),        # int8 weights
    (1, 10, 9, 24, 3, 40, 1, (1, 1, 1, 1), "tanh", False, (8, 4, 3)),   # chunks, tap groups
    (2, 6, 7, 20, 5, 36, 1, (2, 2, 2, 2), "linear", True, (16, 2, 2)),  # and int8
]


def emul_id(c):
    return (f"c{c[3]}k{c[4]}o{c[5]}s{c[6]}" + ("_int8" if c[9] else "")
            + ("_staged" if c[10] else ""))


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", EMULATED, ids=emul_id)
def test_kernel_walk_matches_plain_and_jax(rng, case, prec):
    """The model of the kernel's walk, at its own launch geometry (or one
    forced to several chunks, tap groups and persistent CTAs), against the
    plain version (chip_smoke.py's tolerances: f32 1e-4, bf16 0.03, times
    max(1, max|plain|)) and the JAX kernel in Pallas interpret mode (the
    conftest thresholds); each tile of each channel block visited once."""
    n, h, w, c, k, o, stride, pads, act, int8, forced = case
    tdt, jdt = DTYPES[prec]
    f32 = prec == "fp32"
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt, scale, offset = operands(rng, c, k, o, int8)
    xt = torch.from_numpy(x).to(tdt)
    wtt = torch.from_numpy(wt) if int8 else torch.from_numpy(wt).to(tdt)
    st, ot = torch.from_numpy(scale), torch.from_numpy(offset)
    geo = conv_igemm.launch_geometry(n, h, w, c, k, k, o, stride, pads, f32, 132)
    if forced is not None:
        cc, tg, grid = forced
        ho, wo = conv_igemm.out_hw(h, w, k, k, stride, pads)
        mt = n * -(-ho // geo.tile_h) * -(-wo // geo.tile_w)
        geo = conv_igemm.layout(c, k, k, stride, geo.nt, geo.wm, geo.tile_h, geo.tile_w, cc, tg,
                                2, f32, mt, 1)
        geo = dataclasses.replace(geo, grid=min(grid, mt))
    _holds(geo, c, k, k, o, stride, f32)
    got, visits = emulate(xt, wtt, st, ot, stride, pads, act, geo)
    assert (visits == -(-o // geo.nb)).all()
    plain = conv_igemm.conv2d_igemm_reference(xt, wtt, st, ot, stride, pads, act)
    assert got.shape == plain.shape and got.dtype == plain.dtype
    scale_ = max(1.0, plain.float().abs().max().item())
    assert (got.float() - plain.float()).abs().max().item() <= (1e-4 if f32 else 0.03) * scale_
    want = np.asarray(conv2d_pallas_nhwc(
        jnp.asarray(x, jdt), jnp.asarray(wt) if int8 else jnp.asarray(wt, jdt),
        jnp.asarray(scale), jnp.asarray(offset), stride=stride, pads=pads, activation=act,
        interpret=True), np.float32)
    assert np.max(np.abs(got.float().numpy() - want)) <= TOL[prec] * max(1.0, np.abs(want).max())
