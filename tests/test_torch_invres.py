"""The port's inverted-residual block module (shadernn_tpu_torch.kernels.
invres) against the JAX package's block kernel, run in Pallas interpret
mode as tests/test_invres_block.py runs it, and the block planner against
the JAX planner node for node. On the CPU the port's entry point runs the
kernel's plain version; the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadernn_tpu.graph import fusion as jfusion
from shadernn_tpu.graph.parser import parse_model_file as jparse
from shadernn_tpu.kernels.block_pallas import InvResSpec as JSpec
from shadernn_tpu.kernels.block_pallas import build_invres as j_build
from shadernn_tpu.kernels.block_pallas import fused_invres_block as j_block
from shadernn_tpu.kernels.block_pallas import match_invres_block as j_match

from shadernn_tpu_torch.graph import fusion as pfusion
from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
from shadernn_tpu_torch.kernels import invres, launch_counts
from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}

# (n, h, w, cin, e, cout, has_expand, residual); ragged planes and E that is
# not a multiple of the kernel's 32-channel chunk.
GEOMETRIES = [
    (2, 9, 13, 16, 40, 16, True, True),
    (1, 7, 7, 24, 72, 32, True, False),
    (2, 8, 8, 16, 16, 16, False, True),
    (1, 6, 10, 24, 24, 8, False, False),
]


def random_block(rng, n, h, w, cin, e, cout, has_expand):
    e = e if has_expand else cin
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    ops = {}
    if has_expand:
        ops.update(w1=f(cin, e, scale=cin ** -0.5), s1=1 + f(e, scale=0.1), o1=f(e, scale=0.1))
    ops.update(wd=f(9, e, scale=1 / 3), sd=1 + f(e, scale=0.1), od=f(e, scale=0.1),
               w2=f(e, cout, scale=e ** -0.5), s2=1 + f(cout, scale=0.1), o2=f(cout, scale=0.1))
    return f(n, h, w, cin), ops


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g[:6])) + (
    "_expand" if g[6] else "_t1") + ("_res" if g[7] else ""))
def test_reference_matches_jax_kernel(rng, geom, prec):
    n, h, w, cin, e, cout, has_expand, residual = geom
    x, ops = random_block(rng, *geom[:7])
    e_ch = e if has_expand else cin
    tdt, jdt = DTYPES[prec]
    acts = ("relu6" if has_expand else "linear", "relu6", "linear")
    jspec = JSpec(h=h, w=w, cin=cin, e=e_ch, cout=cout, has_expand=has_expand,
                  residual=residual, act_expand=acts[0], act_dw=acts[1], act_out=acts[2])
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    for k in ("w1", "w2"):  # build_invres casts the 1x1 weights, not the taps
        if k in j:
            j[k] = j[k].astype(jdt)
    want = j_block(jnp.asarray(x, jdt), j.get("w1"), j.get("s1"), j.get("o1"), j["wd"],
                   j["sd"], j["od"], j["w2"], j["s2"], j["o2"], jspec, interpret=True)
    want = np.asarray(want, np.float32)

    spec = invres.InvResSpec(h, w, cin, e_ch, cout, has_expand, residual, *acts)
    tops = {k: torch.from_numpy(v) for k, v in ops.items()}
    for k in ("w1", "w2"):
        if k in tops:
            tops[k] = tops[k].to(tdt)
    before = launch_counts()
    got = invres.fused_invres_block(torch.from_numpy(x).to(tdt), tops, spec)
    assert launch_counts() == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (n, h, w, cout)
    tol = TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def test_bf16_taps_stay_float32(rng):
    """The kernel's depthwise taps are float32 under BF16 (not rounded to
    bf16 as the per-op path rounds them)."""
    x, ops = random_block(rng, 1, 6, 6, 8, 8, 8, False)
    spec = invres.InvResSpec(6, 6, 8, 8, 8, False, False, "linear", "linear", "linear")
    tops = {k: torch.from_numpy(v) for k, v in ops.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = invres.invres_block_reference(xb, tops, spec)
    rounded = dict(tops, wd=tops["wd"].to(torch.bfloat16).float())
    assert not torch.equal(got, invres.invres_block_reference(xb, rounded, spec))


def _cls10(parse, fusion):
    g = parse(MOBILENETV2_TRAINED)
    fusion.optimize(g)
    g.infer_shapes(batch_size=8)
    return g


def test_match_and_build_match_jax_on_cls10_graph():
    """match_invres_block and build_invres give the JAX planner's nodes,
    geometry and operands at every depthwise conv of the trained model."""
    pg, jg = _cls10(pparse, pfusion), _cls10(jparse, jfusion)
    names = lambda m: None if m is None else tuple(None if n is None else n.name for n in m)  # noqa: E731
    matched = 0
    for name, node in pg.nodes.items():
        if node.op != "SeparableConv2D":
            continue
        pm, jm = invres.match_invres_block(pg, node), j_match(jg, jg.nodes[name], None)
        assert names(pm) == names(jm), name
        if pm is None:
            continue
        matched += 1
        head = pm[0] if pm[0] is not None else pm[1]
        for tdt, jdt in DTYPES.values():
            ops, spec = invres.build_invres(pm, pg.nodes[head.inputs[0]].out_spec, tdt)
            jops, jspec = j_build(jm, jg.nodes[head.inputs[0]].out_spec, jdt, batch=8)
            for field in ("h", "w", "cin", "e", "cout", "has_expand", "residual",
                          "act_expand", "act_dw", "act_out", "alpha"):
                assert getattr(spec, field) == getattr(jspec, field), (name, field)
            for key, jv in zip(("w1", "s1", "o1", "wd", "sd", "od", "w2", "s2", "o2"), jops):
                if jv is None:
                    assert key not in ops
                    continue
                assert ops[key].dtype == (tdt if key in ("w1", "w2") else torch.float32), key
                np.testing.assert_array_equal(ops[key].float().numpy(),
                                              np.asarray(jv, np.float32), err_msg=key)
    assert matched == 13


def test_kernel_gates():
    """Geometry the kernel declines at plan time: Cout > 320, shared memory
    of the 8x8 tile over 227 KB, an activation outside its epilogue."""
    ok = invres.InvResSpec(7, 7, 160, 960, 320, True, False, "relu6", "relu6", "linear")
    assert invres.kernel_takes(ok)
    assert invres.smem_bytes(ok, 7, 7) < invres.MAX_SMEM_BYTES
    assert not invres.kernel_takes(invres.InvResSpec(7, 7, 160, 960, 352, True, False,
                                                     "relu6", "relu6", "linear"))
    assert not invres.kernel_takes(invres.InvResSpec(28, 28, 512, 1024, 256, True, False,
                                                     "relu6", "relu6", "linear"))
    assert not invres.kernel_takes(invres.InvResSpec(7, 7, 16, 32, 16, True, False,
                                                     "softmax", "relu6", "linear"))


def test_launch_choice_fills_the_card():
    """Both forms: the tile and split of least modelled time. bf16: two
    CTAs per SM where the shared memory holds them, E chunks per CTA, the
    cluster's reduction. f32: waves of clusters as the GPCs hold them, the
    SM's share of CTAs, E chunks per CTA and the expand's items per warp
    (kernels/invres.py _f32_cost); one buffer where that is cheaper."""
    def choice(spec, n, bf16=False):
        geo = invres.pick_launch(spec, n, 132, bf16)
        assert geo.smem == invres.smem_bytes(spec, geo.tile_h, geo.tile_w, geo.split, bf16,
                                             geo.bufs)
        assert geo.smem <= invres.MAX_SMEM_BYTES
        return geo.tile_h, geo.tile_w, geo.split

    spec = invres.InvResSpec(7, 7, 160, 960, 160, True, True, "relu6", "relu6", "linear")
    assert choice(spec, 8) == (4, 7, 8) and invres.pick_launch(spec, 8, 132).bufs == 1
    assert choice(spec, 256) == (7, 7, 1)
    mid = invres.InvResSpec(14, 14, 64, 384, 64, True, True, "relu6", "relu6", "linear")
    assert choice(mid, 8) == (8, 8, 4)
    big = invres.InvResSpec(28, 28, 32, 192, 32, True, True, "relu6", "relu6", "linear")
    assert choice(big, 8) == (8, 8, 2)
    small_e = invres.InvResSpec(4, 4, 16, 48, 16, True, True, "relu6", "relu6", "linear")
    assert choice(small_e, 1) == (2, 2, 2)  # no more splits than chunks
    # bf16 on the MobileNetV2 224 b8 blocks: 256 CTAs each, a wide Cout
    # (320) splits less (its cluster reduction costs more), and a big batch
    # needs no split.
    assert choice(big, 8, True) == (8, 8, 2)
    assert choice(mid, 8, True) == (4, 8, 4)
    assert choice(spec, 8, True) == (4, 4, 8)
    wide = invres.InvResSpec(7, 7, 160, 960, 320, True, False, "relu6", "relu6", "linear")
    assert choice(wide, 8, True) == (4, 4, 4)
    assert choice(spec, 256, True)[2] == 1
    assert choice(small_e, 1, True)[2] <= 2


def test_bf16_layout_fits_wherever_the_gate_admits():
    """The gate's shared-memory term is the f32 layout's at both dtypes;
    wherever it admits a block, the bf16 layout of the largest tile fits
    too, unsplit and at every split pick_launch may take."""
    admitted = 0
    for cin in (1, 3, 8, 16, 24, 40, 96, 160, 256, 320, 400, 512):
        for e in (cin, 4 * cin, 6 * cin, 1024):
            for cout in (1, 8, 24, 96, 160, 320):
                for has_expand in (True, False):
                    if not has_expand and e != cin:
                        continue
                    spec = invres.InvResSpec(8, 8, cin, e, cout, has_expand, False,
                                             "relu6", "relu6", "linear")
                    if not invres.kernel_takes(spec):
                        continue
                    admitted += 1
                    for split in (1, 2, 4, 8):
                        assert invres.smem_bytes(spec, 8, 8, split, True) <= invres.MAX_SMEM_BYTES
                    assert invres.pick_launch(spec, 8, 132, True).smem <= invres.MAX_SMEM_BYTES
    assert admitted > 100


def _gate_before(spec, tile_h, tile_w):
    """The block gate's shared-memory term as the kernel's first f32 form
    laid it out (CUDA cores, one buffer; kernels/invres.py layout before
    the f32 form moved to the tensor cores)."""
    hp, p = (tile_h + 2) * (tile_w + 2), tile_h * tile_w
    xs_stride = -(-spec.cin // 4) * 4
    sizes = (hp * xs_stride * 4, hp * 32 * 4, p * 32 * 4,
             xs_stride * 32 * 4 if spec.has_expand else 0, 13 * 32 * 4, 32 * spec.cout * 4)
    return sum(sizes)


def _gate_grid():
    for cin in (1, 3, 8, 16, 24, 40, 96, 160, 256, 300, 320, 400, 512):
        for e in sorted({cin, 2 * cin, 4 * cin, 6 * cin, 1024}):
            for cout in (1, 8, 24, 96, 160, 320):
                for has_expand in (True, False):
                    if not has_expand and e != cin:
                        continue
                    for h, w in ((8, 8), (7, 7), (28, 28), (1, 1), (3, 13)):
                        yield invres.InvResSpec(h, w, cin, e, cout, has_expand, False,
                                                "relu6", "relu6", "linear")


def test_gate_admits_what_it_did():
    """The gate's shared-memory term is the first f32 layout's, kept as a
    formula: kernel_takes admits exactly the blocks it admitted before the
    f32 form moved to the tensor cores."""
    admitted = declined = 0
    for spec in _gate_grid():
        th, tw = min(8, spec.h), min(8, spec.w)
        assert invres.gate_smem_bytes(spec, th, tw) == _gate_before(spec, th, tw), spec
        before = spec.cout <= 320 and _gate_before(spec, th, tw) <= invres.MAX_SMEM_BYTES
        assert invres.kernel_takes(spec) == before, spec
        admitted += before
        declined += not before
    assert admitted > 300 and declined > 20


def _f32_layout_holds(spec, geo):
    """csrc/invres_block.cu layout_holds for the f32 form: each buffer
    16-byte aligned inside `smem`, no overlaps but the split-E partial sums
    over the chunk buffers."""
    hp16 = -(-(geo.tile_h + 2) * (geo.tile_w + 2) // 16) * 16
    p16 = -(-geo.tile_h * geo.tile_w // 16) * 16
    cout8 = -(-spec.cout // 8) * 8
    assert geo.xs_stride == -(-spec.cin // 8) * 8 + 4 and geo.w2_stride == 36
    assert geo.w1_buf >= (32 * geo.xs_stride * 4 if spec.has_expand else 0)
    assert geo.wd_buf >= 13 * 32 * 4 and geo.w2_buf >= cout8 * 36 * 4
    regions = [(geo.xs_off, hp16 * geo.xs_stride * 4), (geo.es_off, hp16 * 36 * 4),
               (geo.ds_off, p16 * 36 * 4), (geo.w1_off, geo.bufs * geo.w1_buf),
               (geo.wd_off, geo.bufs * geo.wd_buf), (geo.w2_off, geo.bufs * geo.w2_buf)]
    if geo.split > 1:
        regions.append((geo.red_off, geo.tile_h * geo.tile_w * spec.cout * 4))
    for i, (off, size) in enumerate(regions):
        assert off % 16 == 0 and off + size <= geo.smem <= invres.MAX_SMEM_BYTES, (spec, geo)
        for j, (o2, s2) in enumerate(regions[:i]):
            overlay = i == 6 and j > 0
            assert overlay or not size or not s2 or off >= o2 + s2 or o2 >= off + size, geo


def test_f32_layout_fits_wherever_the_gate_admits():
    """Every block the gate admits has an f32 launch (tensor-core tiles,
    n-major weights) whose layout holds its buffers in 227 KB: two buffers
    of the chunk weights where a tile holds them, else one; at the batches
    of the paths and at b1."""
    one_buffer = admitted = 0
    for spec in _gate_grid():
        if not invres.kernel_takes(spec):
            continue
        admitted += 1
        for n in (1, 8, 64):
            geo = invres.pick_launch(spec, n, 132, False)
            _f32_layout_holds(spec, geo)
            assert geo.bufs in (1, 2) and geo.tile_h * geo.tile_w <= 64
            one_buffer += geo.bufs == 1
    assert admitted > 300 and one_buffer > 0


def test_f32_prepared_operands_are_n_major(rng):
    """Under float32 prepare_operands makes the n-major copies the f32 form
    reads (w1n: E rows of Cin padded to 8; w2n: Cout rows of E padded to
    32), and for int8 weights the int8 ones of the A8W8 layout (w1q, w2q,
    flagged in w8); the kernel's pointers are theirs."""
    _, ops = random_block(rng, 1, 4, 4, 12, 40, 20, True)
    spec = invres.InvResSpec(4, 4, 12, 40, 20, True, False, "relu6", "relu6", "linear")
    tops = {k: torch.from_numpy(v) for k, v in ops.items()}
    prep = invres.prepare_operands(tops, spec, torch.float32)
    assert prep["w1n"].shape == (40, 16) and prep["w2n"].shape == (20, 64)
    assert torch.equal(prep["w1n"][:, :12], tops["w1"].t()) and not prep["w1n"][:, 12:].any()
    assert torch.equal(prep["w2n"][:, :40], tops["w2"].t()) and not prep["w2n"][:, 40:].any()
    assert prep.ptrs[0] == prep["w1n"].data_ptr() and prep.ptrs[6] == prep["w2n"].data_ptr()
    assert prep.w8 == 0
    q = lambda *s: torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))  # noqa: E731
    prep8 = invres.prepare_operands(dict(tops, w1=q(12, 40), w2=q(40, 20)), spec, torch.float32)
    assert prep8["w1q"].shape == (40, 32) and prep8["w2q"].shape == (20, 64)
    assert prep8["w1q"].dtype == prep8["w2q"].dtype == torch.int8 and prep8.w8 == 3
    assert prep8.ptrs[0] == prep8["w1q"].data_ptr() and prep8.ptrs[6] == prep8["w2q"].data_ptr()
    bf = invres.prepare_operands(tops, spec, torch.bfloat16)  # the bf16 form: k-major w1, w2
    assert not {"w1n", "w2n", "w1q", "w2q"} & set(bf) and bf.ptrs[0] == bf["w1"].data_ptr()


def _tile_map(spec, geo, n):
    """How often the kernel writes each output element, from its launch
    geometry: grid (tiles, images, split); without a split a CTA finishes
    its tile's pixels in the image x every channel, with one the CTA of rank
    r finishes the tile's elements i = r, r + split, ... (csrc/invres_block.cu)."""
    count = np.zeros((n, spec.h, spec.w, spec.cout), np.int32)
    tiles_x = -(-spec.w // geo.tile_w)
    p = geo.tile_h * geo.tile_w
    for t in range(tiles_x * -(-spec.h // geo.tile_h)):
        ty0, tx0 = (t // tiles_x) * geo.tile_h, (t % tiles_x) * geo.tile_w
        for img in range(n):
            for rank in range(geo.split):
                for i in range(rank, p * spec.cout, geo.split):
                    q, co = divmod(i, spec.cout)
                    gy, gx = ty0 + q // geo.tile_w, tx0 + q % geo.tile_w
                    if gy < spec.h and gx < spec.w:
                        count[img, gy, gx, co] += 1
    return count


def test_launch_geometry_of_every_planned_block_fits_and_covers_the_output():
    """At both dtypes, the launch of every block the planner fuses on
    MobileNetV2 224 (b8) and the trained cls10 model (b64), and of a ragged
    13x9 block (b3), fits 227 KB and writes each output element exactly
    once."""
    from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2

    specs = set()
    for graph, n in ((build_mobilenetv2(), 8), (pparse(MOBILENETV2_TRAINED), 64)):
        pfusion.optimize(graph)
        graph.infer_shapes(batch_size=n)
        for node in graph.toposort():
            m = invres.match_invres_block(graph, node) if node.op == "SeparableConv2D" else None
            if m is not None:
                head = m[0] if m[0] is not None else m[1]
                _, spec = invres.build_invres(m, graph.nodes[head.inputs[0]].out_spec,
                                              torch.float32)
                specs.add((spec, n))
    specs.add((invres.InvResSpec(13, 9, 24, 144, 24, True, True, "relu6", "relu6", "linear"), 3))
    assert len(specs) == 15  # 6 at 224, 8 on cls10 (two differ only in activation), ragged
    splits = set()
    for spec, n in specs:
        for bf16 in (True, False):
            geo = invres.pick_launch(spec, n, 132, bf16)
            assert geo.smem <= invres.MAX_SMEM_BYTES and geo.tile_h * geo.tile_w <= 64
            count = _tile_map(spec, geo, min(n, 2))  # every image has the same tiles
            assert count.min() == 1 and count.max() == 1, (spec, geo)
            splits.add(geo.split)
    assert splits >= {1, 2, 4, 8}


def test_entry_point_rejects_other_devices(rng):
    x, ops = random_block(rng, 1, 4, 4, 8, 16, 8, True)
    spec = invres.InvResSpec(4, 4, 8, 16, 8, True, False, "relu6", "relu6", "linear")
    with pytest.raises(ValueError):
        invres.fused_invres_block(torch.zeros((1, 4, 4, 8), device="meta"),
                                  {k: torch.from_numpy(v) for k, v in ops.items()}, spec)


@pytest.mark.parametrize("prec", list(TOL))
def test_prepared_operands_give_the_same_block(rng, prec):
    """prepare_operands lays the operands out once (w1, w2 in the compute
    dtype, the rest float32, contiguous); the entry point gives the same
    result from them as from build_invres's dict."""
    tdt, _ = DTYPES[prec]
    x, ops = random_block(rng, 2, 9, 13, 16, 40, 16, True)
    spec = invres.InvResSpec(9, 13, 16, 40, 16, True, True, "relu6", "relu6", "linear")
    tops = {k: torch.from_numpy(v) for k, v in ops.items()}
    prepared = invres.prepare_operands(tops, spec, tdt)
    assert prepared.spec == spec and prepared.dtype == tdt and prepared.device.type == "cpu"
    for k, t in prepared.items():
        assert t.dtype == (tdt if k in ("w1", "w2") else torch.float32), k
        assert t.is_contiguous(), k
    assert prepared.w8 == 0
    assert len(prepared.ptrs) == 9 and list(prepared.acts) == [2, 2, 0]
    xt = torch.from_numpy(x).to(tdt)
    assert torch.equal(invres.fused_invres_block(xt, prepared, spec),
                       invres.fused_invres_block(xt, tops, spec))


def test_prepare_operands_rejects_what_the_kernel_cannot_take(rng):
    _, ops = random_block(rng, 1, 4, 4, 8, 16, 8, True)
    tops = {k: torch.from_numpy(v) for k, v in ops.items()}
    spec = invres.InvResSpec(4, 4, 8, 16, 8, True, False, "relu6", "relu6", "linear")
    with pytest.raises(ValueError, match="operand w2"):
        invres.prepare_operands(dict(tops, w2=tops["w2"][:, :4]), spec, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        invres.prepare_operands(tops, dataclasses.replace(spec, act_out="softmax"), torch.float32)
    with pytest.raises(TypeError):
        invres.prepare_operands(tops, spec, torch.float16)


# -- INT8: int8 weights and A8W8 -----------------------------------------------

A8W8_MODES = {"weight_only": (0.0, 0.0), "ax1": (0.02, 0.0), "ax2": (0.0, 0.03),
              "ax1_ax2": (0.02, 0.03)}


def int8_block(rng, n, h, w, cin, e, cout, has_expand):
    """A block's operands as build_invres gives them after quantization:
    int8 w1, w2 and taps (the taps upcast to float32), float32 vectors."""
    x, ops = random_block(rng, n, h, w, cin, e, cout, has_expand)
    q = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    e = e if has_expand else cin
    if has_expand:
        ops.update(w1=q(cin, e), s1=ops["s1"] / 127 / np.sqrt(cin))
    ops.update(wd=q(9, e).astype(np.float32), sd=ops["sd"] / 127 / 3, w2=q(e, cout),
               s2=ops["s2"] / 127 / np.sqrt(e))
    return x, ops


@pytest.mark.parametrize("mode", list(A8W8_MODES))
@pytest.mark.parametrize("geom", GEOMETRIES[:2] + GEOMETRIES[3:], ids=lambda g: "x".join(
    map(str, g[:6])) + ("_expand" if g[6] else "_t1") + ("_res" if g[7] else ""))
def test_int8_reference_matches_jax_kernel(rng, geom, mode):
    """Int8 w1/w2/taps (weight-only) and the A8W8 products (ax1 quantizes
    the block input for the expand, ax2 the depthwise output for the
    project; the scales folded into s1/s2): the plain version against the
    JAX kernel (Pallas interpret mode) at bf16."""
    n, h, w, cin, e, cout, has_expand, residual = geom
    ax1, ax2 = A8W8_MODES[mode]
    ax1 = ax1 if has_expand else 0.0
    x, ops = int8_block(rng, *geom[:7])
    if ax1:
        ops["s1"] = ops["s1"] * np.float32(ax1)
    if ax2:
        ops["s2"] = ops["s2"] * np.float32(ax2)
    e_ch = e if has_expand else cin
    acts = ("relu6" if has_expand else "linear", "relu6", "linear")
    jspec = JSpec(h=h, w=w, cin=cin, e=e_ch, cout=cout, has_expand=has_expand, residual=residual,
                  act_expand=acts[0], act_dw=acts[1], act_out=acts[2], ax1=ax1, ax2=ax2)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    want = j_block(jnp.asarray(x, jnp.bfloat16), j.get("w1"), j.get("s1"), j.get("o1"), j["wd"],
                   j["sd"], j["od"], j["w2"], j["s2"], j["o2"], jspec, interpret=True)
    want = np.asarray(want, np.float32)
    spec = invres.InvResSpec(h, w, cin, e_ch, cout, has_expand, residual, *acts, ax1=ax1, ax2=ax2)
    assert invres.kernel_takes(spec)
    tops = {k: torch.from_numpy(v) for k, v in ops.items()}
    prepared = invres.prepare_operands(tops, spec, torch.bfloat16)
    # The int8 weights reach the kernel as int8: it upcasts those outside
    # the s8 products (bits of w8) as it stages them.
    assert all(prepared[k].dtype == torch.int8 for k in ("w1", "w2") if k in prepared)
    assert prepared.w8 == (1 if has_expand and not ax1 else 0) + (0 if ax2 else 2)
    if ax1:  # the kernel's n-major copy: E rows of Cin padded to 32
        assert prepared["w1q"].shape == (e_ch, -(-cin // 32) * 32)
    got = invres.fused_invres_block(torch.from_numpy(x).to(torch.bfloat16), prepared, spec)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    tol = 0.1 * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def _quantized_cls10(parse, fusion, quantize, calibrated: bool):
    g = _cls10(parse, fusion)
    quantize(g)
    if calibrated:  # one fixed act_scale per node, as calibrate_activations stamps them
        for i, node in enumerate(g.toposort()):
            node.attrs["act_scale"] = 0.01 + 0.001 * i
    return g


@pytest.mark.parametrize("calibrated", [False, True], ids=["weight_only", "calibrated"])
def test_build_matches_jax_on_quantized_cls10_graph(calibrated):
    """On the trained model quantized as both packages quantize it (and, when
    calibrated, one act_scale per node), build_invres gives the JAX
    planner's ax1/ax2 and operands at every block, INT8 and not."""
    from shadernn_tpu.quant.quantize import quantize_graph_weights as j_quantize

    from shadernn_tpu_torch.quant.quantize import quantize_graph_weights as p_quantize

    pg = _quantized_cls10(pparse, pfusion, p_quantize, calibrated)
    jg = _quantized_cls10(jparse, jfusion, j_quantize, calibrated)
    seen = set()
    for name, node in pg.nodes.items():
        pm = invres.match_invres_block(pg, node) if node.op == "SeparableConv2D" else None
        if pm is None:
            continue
        jm = j_match(jg, jg.nodes[name], None)
        head = pm[0] if pm[0] is not None else pm[1]
        in_node = pg.nodes[head.inputs[0]]
        for int8 in (False, True):
            scale = float(in_node.attrs.get("act_scale", 0.0)) if int8 else 0.0
            ops, spec = invres.build_invres(pm, in_node.out_spec, torch.bfloat16, scale, int8)
            jops, jspec = j_build(jm, jg.nodes[head.inputs[0]].out_spec, jnp.bfloat16, batch=8,
                                  in_act_scale=scale, a8w8=int8)
            assert (spec.ax1, spec.ax2) == (jspec.ax1, jspec.ax2), name
            seen.add((bool(spec.ax1), bool(spec.ax2)))
            for key, jv in zip(("w1", "s1", "o1", "wd", "sd", "od", "w2", "s2", "o2"), jops):
                if jv is None:
                    continue
                # int8 w1/w2 stay int8 (the JAX ones too); the taps are upcast here,
                # in the JAX entry point there
                assert ops[key].dtype == (torch.int8 if key in ("w1", "w2") else torch.float32)
                np.testing.assert_array_equal(ops[key].float().numpy(),
                                              np.asarray(jv, np.float32), err_msg=key)
    assert seen == ({(False, False), (True, True), (False, True)} if calibrated
                    else {(False, False)})


def _planned_specs():
    """Every block the planner fuses on MobileNetV2 224 (b8) and the trained
    cls10 model (b64), as (spec, batch)."""
    from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2

    specs = set()
    for graph, n in ((build_mobilenetv2(), 8), (pparse(MOBILENETV2_TRAINED), 64)):
        pfusion.optimize(graph)
        graph.infer_shapes(batch_size=n)
        for node in graph.toposort():
            m = invres.match_invres_block(graph, node) if node.op == "SeparableConv2D" else None
            if m is not None:
                head = m[0] if m[0] is not None else m[1]
                _, spec = invres.build_invres(m, graph.nodes[head.inputs[0]].out_spec,
                                              torch.float32)
                specs.add((spec, n))
    return specs


def test_s8_launch_of_every_mobilenetv2_block_fits_and_covers_the_output():
    """Under A8W8 (ax1 where the block expands, ax2) and weight-only int8,
    pick_launch gives every block of both MobileNetV2s a launch whose
    layout (the int8 input tile, n-major int8 w1/w2 buffers) fits 227 KB
    and which writes each output element exactly once."""
    specs = _planned_specs()
    assert len(specs) == 14
    for spec, n in specs:
        for ax1, ax2 in A8W8_MODES.values():
            s8 = dataclasses.replace(spec, ax1=ax1 if spec.has_expand else 0.0, ax2=ax2)
            assert invres.kernel_takes(s8)
            geo = invres.pick_launch(s8, n, 132, True)
            assert geo.smem == invres.smem_bytes(s8, geo.tile_h, geo.tile_w, geo.split, True)
            assert geo.smem <= invres.MAX_SMEM_BYTES and geo.tile_h * geo.tile_w <= 64
            if s8.ax1:
                assert geo.q_stride == -(-spec.cin // 32) * 32 + 16 and geo.xq_off > 0
                assert (geo.q_stride // 16) % 2 == 1
            count = _tile_map(s8, geo, min(n, 2))
            assert count.min() == 1 and count.max() == 1, (s8, geo)


def test_s8_layout_fits_wherever_the_gate_admits():
    """Every A8W8 block the gate admits has a layout that holds its buffers
    without overlaps (the partial sums may overlay all but the input tile),
    at every split pick_launch may take; E over 1024 is declined under ax2
    (the project's sums would pass 2^24)."""
    admitted = 0
    for cin in (8, 16, 24, 40, 96, 160, 320):
        for e in (cin, 6 * cin, 1024):
            for cout in (8, 24, 160, 320):
                spec = invres.InvResSpec(8, 8, cin, e, cout, True, False, "relu6", "relu6",
                                         "linear", ax1=0.02, ax2=0.03)
                if not invres.kernel_takes(spec):
                    continue
                admitted += 1
                geo = invres.pick_launch(spec, 8, 132, True)
                hp16 = -(-100 // 16) * 16 if geo.tile_h == 8 else None
                regions = [(geo.xs_off, geo.es_off), (geo.es_off, geo.ds_off),
                           (geo.ds_off, geo.w1_off), (geo.w1_off, geo.wd_off),
                           (geo.wd_off, geo.w2_off), (geo.w2_off, geo.xq_off),
                           (geo.xq_off, geo.xq_off + -(-(geo.tile_h + 2) * (geo.tile_w + 2)
                                                         // 16) * 16 * geo.q_stride)]
                assert all(a % 16 == 0 and a <= b <= geo.smem for a, b in regions), geo
                assert geo.w1_buf >= 32 * geo.q_stride and geo.w2_buf >= -(-cout // 8) * 8 * 48
                del hp16
    assert admitted > 40
    assert not invres.kernel_takes(invres.InvResSpec(1, 1, 320, 1280, 320, True, False, "relu6",
                                                     "relu6", "linear", ax2=0.03))


def test_launch_sweep_tool_needs_a_card():
    """The sweep behind the f32 launch model (tools/sweep_launch.py) runs on
    the card only: without one it says so and returns 2."""
    from shadernn_tpu_torch.tools import sweep_launch

    assert sweep_launch.main([]) == 2
