"""The port's conv-chain module (shadernn_tpu_torch.kernels.chain) against
the JAX package's two chain kernels, run in Pallas interpret mode as
tests/test_chain_packed.py runs them. On the CPU the port's entry points
run the kernel's plain version; the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadernn_tpu.kernels.chain_packed_pallas import build_chain_packed
from shadernn_tpu.kernels.chain_packed_pallas import fused_conv_chain_packed as j_packed
from shadernn_tpu.kernels.chain_pallas import build_chain
from shadernn_tpu.kernels.chain_pallas import fused_conv_chain as j_chain
from shadernn_tpu.kernels.conv_pallas import from_haloed

from shadernn_tpu_torch.kernels import chain, launch_counts
from shadernn_tpu_torch.kernels.tf32 import tf32_split

ESPCN_BODY = [(5, 16, "relu"), (3, 16, "relu"), (3, 4, "linear")]


class FakeNode:
    def __init__(self, k, o, act, w, b, padding="same", stride=1):
        self._a = dict(kernel_size=k, out_channels=o, activation=act,
                       padding=padding, stride=stride, use_bias=True)
        self.params = dict(weight=w, bias=b)

    def attr(self, key, d=None):
        return self._a.get(key, d)


def make_nodes(rng, cfg, cin, **kw):
    nodes, c = [], cin
    for k, o, act in cfg:
        w = (rng.standard_normal((k, k, c, o)) * 0.25).astype(np.float32)
        b = (rng.standard_normal(o) * 0.1).astype(np.float32)
        nodes.append(FakeNode(k, o, act, w, b, **kw))
        c = o
    return nodes


def port_chain(entry, nodes, cin, x, dtype, tail, act_override=None):
    specs = chain.build_chain_specs(nodes, cin, dtype, act_override=act_override, tail=tail)
    assert specs is not None
    ops = chain.chain_operands(nodes, dtype)
    before = launch_counts()
    y = entry(torch.from_numpy(x), ops, specs, tail=tail, compute_dtype=dtype)
    assert launch_counts() == before  # CPU tensors never launch the kernel
    return y.float().numpy()


def test_d2s2_bf16_matches_jax_packed_kernel(rng, fp16_threshold):
    """ESPCN-shaped 1->16->16->4 chain, tanh folded, depth_to_space tail."""
    nodes = make_nodes(rng, ESPCN_BODY, 1)
    x = rng.random((2, 24, 40, 1), dtype=np.float32)
    lp, specs = build_chain_packed(nodes, 1, jnp.bfloat16, act_override=("tanh", 0.3),
                                   width=40, tail="d2s2")
    want = np.asarray(j_packed(jnp.asarray(x), lp, specs, interpret=True, tail="d2s2",
                               compute_dtype=jnp.bfloat16), np.float32)
    got = port_chain(chain.fused_conv_chain_packed, nodes, 1, x, torch.bfloat16, "d2s2",
                     act_override=("tanh", 0.3))
    assert got.shape == want.shape == (2, 48, 80, 1)
    assert np.max(np.abs(got - want)) <= fp16_threshold


@pytest.mark.parametrize("cfg,tail", [
    (ESPCN_BODY, "none"),
    ([(5, 16, "relu"), (3, 8, "relu"), (3, 1, "sigmoid")], "c1"),
])
def test_fp32_matches_jax_im2col_kernel(rng, fp32_threshold, cfg, tail):
    nodes = make_nodes(rng, cfg, 1)
    x = rng.random((2, 24, 40, 1), dtype=np.float32)
    lp, specs = build_chain(nodes, 1, jnp.float32)
    want = j_chain(jnp.asarray(x), lp, specs, interpret=True, tail=tail)
    want = np.asarray(from_haloed(want) if tail == "none" else want, np.float32)
    got = port_chain(chain.fused_conv_chain, nodes, 1, x, torch.float32, tail)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= fp32_threshold


def test_reference_matches_float64_oracle_on_even_kernel(rng):
    """Even k (asymmetric 'same' pads: top/left one less) and a ragged
    frame, against a float64 numpy loop."""
    nodes = make_nodes(rng, [(4, 6, "leaky_relu"), (2, 3, "gelu")], 2)
    x = rng.random((3, 13, 17, 2), dtype=np.float32)
    got = port_chain(chain.fused_conv_chain, nodes, 2, x, torch.float32, "none")
    ref = x.astype(np.float64)
    for node in nodes:
        k, w, b = node.attr("kernel_size"), node.params["weight"], node.params["bias"]
        t = k // 2 - (1 - k % 2)  # even k: the top/left pad is one less
        xp = np.pad(ref, ((0, 0), (t, k - 1 - t), (t, k - 1 - t), (0, 0)))
        n, h, wd, _ = ref.shape
        y = sum(np.einsum("nhwc,co->nhwo", xp[:, dy:dy + h, dx:dx + wd], w[dy, dx])
                for dy in range(k) for dx in range(k)) + b
        act = node.attr("activation")
        if act == "leaky_relu":
            y = np.where(y >= 0, y, 0.3 * y)
        else:
            y = 0.5 * y * (1 + np.tanh(np.sqrt(2 / np.pi) * (y + 0.044715 * y ** 3)))
        ref = y
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_plan_declines_what_the_kernel_cannot_take(rng):
    """The gate declines at planning time: stride 2, k > 9, o > 32, a
    non-elementwise activation, a tail that does not fit, too much shared
    memory."""
    ok = make_nodes(rng, ESPCN_BODY, 1)
    assert chain.build_chain_specs(ok, 1, torch.bfloat16, tail="d2s2") is not None
    assert chain.build_chain_specs(ok, 1, torch.float32, tail="c1") is None
    assert chain.build_chain_specs(make_nodes(rng, ESPCN_BODY, 1, stride=2), 1, torch.float32) is None
    assert chain.build_chain_specs(make_nodes(rng, [(11, 4, "relu")], 1), 1, torch.float32) is None
    assert chain.build_chain_specs(make_nodes(rng, [(3, 48, "relu")], 1), 1, torch.float32) is None
    assert chain.build_chain_specs(make_nodes(rng, [(3, 8, "softmax")], 1), 1, torch.float32) is None
    wide = make_nodes(rng, [(9, 32, "relu")] * 3, 32)
    assert chain.smem_bytes(
        [chain.ChainLayerSpec(9, 32, 32, 4, 4, 4, 4, "relu", 0.3)] * 3
    ) > chain.MAX_SMEM_BYTES
    assert chain.build_chain_specs(wide, 32, torch.float32) is None


def test_espcn_shared_memory_fits_two_ctas_per_sm():
    """The gate's term (the first f32 form's layout) fits two CTAs per SM; the
    bf16 form at ESPCN 540p b8 keeps 16 warps per SM: its 32 x 32 tile
    leaves room for one CTA, which then has 512 threads."""
    specs = [chain.ChainLayerSpec(5, 1, 16, 2, 2, 2, 2, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 16, 1, 1, 1, 1, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 4, 1, 1, 1, 1, "tanh", 0.3)]
    # weights 432 + 2336 + 584 floats; ping-pong regions 16*18*34 and 16*20*36
    assert chain.smem_bytes(specs) == 4 * (432 + 2336 + 584 + 9792 + 11520)
    assert 2 * chain.smem_bytes(specs) < 228 * 1024
    geo = chain.launch_geometry(tuple(specs), 8, 540, 960, 132)
    assert (geo.tile_h, geo.tile_w, geo.threads, geo.w_all) == (32, 32, 512, 1)
    # The head packs its 25 taps into 2 k-steps; 16 channels pad to a pitch
    # of 24 (3 units); regions 40x40x1 (layer 0) and 34x34x24 (layer 2) in
    # buffer 0, 36x36x24 (layer 1) in buffer 1.
    tls = chain.tc_layers(specs)
    assert [(t.dense, t.cs, t.ksteps, t.nt, t.ostride) for t in tls] == [
        (True, 1, 2, 2, 24), (False, 24, 9, 2, 24), (False, 24, 9, 1, 8)]
    assert chain.regions(specs, 32, 32) == [(40, 40), (36, 36), (34, 34), (32, 32)]
    assert geo.buf1 - geo.buf0 >= 2 * max(40 * 40 * 1, 34 * 34 * 24)
    assert geo.smem - geo.buf1 == 2 * 36 * 36 * 24
    assert geo.smem + 1024 > chain.SMEM_PER_SM // 2 and geo.smem <= chain.MAX_SMEM_BYTES


def test_entry_points_reject_other_devices(rng):
    nodes = make_nodes(rng, ESPCN_BODY, 1)
    specs = chain.build_chain_specs(nodes, 1, torch.float32)
    ops = chain.chain_operands(nodes, torch.float32)
    x = torch.zeros((1, 8, 8, 1), device="meta")
    with pytest.raises(ValueError):
        chain.fused_conv_chain(x, ops, specs)
    with pytest.raises(ValueError):
        chain.fused_conv_chain_packed(torch.zeros((1, 8, 8, 1)), ops, specs, tail="bogus")


# The bf16 tensor-core form's launch geometry and packed weights. The kernel
# itself is held against its plain version on the card (chip_smoke.py); here
# the geometry is held to what csrc/conv_chain.cu checks and to covering each
# final output once, for chains that the gate admits.

ACTS = ["relu", "linear", "tanh", "sigmoid", "leaky_relu", "gelu", "relu6", "silu"]


def _random_admitted(rng, cin, depth, tail):
    """A chain of `depth` layers from `cin` channels that the gate admits
    (k 1-9, o 1-32; the last o fixed by the tail), with random pads; None
    when the gate declines it."""
    nodes, c = [], cin
    kmax, omax = int(rng.choice([3, 5, 9])), int(rng.choice([8, 16, 32]))
    for i in range(depth):
        k = int(rng.integers(1, kmax + 1))
        o = int(rng.integers(1, omax + 1))
        if i == depth - 1 and tail != "none":
            o = 1 if tail == "c1" else 4
        pad = "same" if rng.random() < 0.7 else "valid"
        w = np.zeros((k, k, c, o), np.float32)
        nodes.append(FakeNode(k, o, ACTS[int(rng.integers(len(ACTS)))], w, np.zeros(o, np.float32),
                              padding=pad))
        c = o
    return chain.build_chain_specs(nodes, cin, torch.bfloat16, tail=tail)


def _holds(geo, specs):
    """csrc/conv_chain.cu run_tc's checks: strides, parameter offsets, every
    buffer 16-byte aligned within the shared memory asked for, and no two
    overlapping unless they take turns (one ping-pong buffer's regions, the
    weights when staged layer by layer)."""
    assert geo.smem <= chain.MAX_SMEM_BYTES and geo.threads % 32 == 0
    regs = chain.regions(specs, geo.tile_h, geo.tile_w)
    ivs = []
    for l, (s, tl, lay) in enumerate(zip(specs, chain.tc_layers(specs), geo.layers)):
        cs, ostride, w_off, ktab_off, pw, ps, q8 = lay
        assert q8 == int(s.in_q > 0)
        if q8:  # int8 input: 16-channel units, n-major B rows of k32 steps
            assert not tl.dense and s.c % 8 == 0 and cs == 16 * (-(-s.c // 16) | 1)
            assert ostride >= 32 * tl.ksteps and ostride % 16 == 0 and (ostride // 16) % 2 == 1
            assert tl.w_bytes == 8 * tl.nt * ostride
        else:
            assert tl.dense == (s.c < 8) and cs == (s.c if s.c < 8 else 8 * (-(-s.c // 8) | 1))
            assert ostride >= 8 * tl.nt and ostride % 8 == 0 and (ostride // 8) % 2 == 1
        assert pw % 16 == 0 and pw + tl.w_bytes <= geo.param_bytes
        assert ps % 16 == 0 and ps + 64 * tl.nt <= geo.param_bytes
        rows, cols = regs[l]
        ivs.append(((geo.buf1 if l % 2 else geo.buf0), tl.esize * rows * cols * cs, l % 2))
        ivs.append((w_off, tl.w_bytes, 10 + l if geo.w_all else 2))
        ivs.append((ktab_off, tl.ktab_bytes, 20 + l))
    for i, (off, size, slot) in enumerate(ivs):
        assert off % 16 == 0 and 0 <= off and off + size <= geo.smem, (i, off, size, geo.smem)
        for off2, size2, slot2 in ivs[:i]:
            assert slot == slot2 or off >= off2 + size2 or off2 >= off + size, (geo, ivs)


def _covers_once(geo, specs, n, h, w):
    ho, wo = chain._out_hw(h, w, specs)
    hits = np.zeros((ho, wo), np.int32)
    for by in range(-(-ho // geo.tile_h)):
        for bx in range(-(-wo // geo.tile_w)):
            hits[by * geo.tile_h:(by + 1) * geo.tile_h, bx * geo.tile_w:(bx + 1) * geo.tile_w] += 1
    assert (hits == 1).all() and geo.tile_h <= ho and geo.tile_w <= wo


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("tail", list(chain.TAILS))
def test_tc_geometry_of_admitted_chains_fits_and_covers_each_output_once(depth, tail):
    """k 1-9, C 1-32, o 1-32, random pads, every tail, images from 1x1 up to
    540p and batches 1-64: the bf16 launch fits 227 KB with the layout the
    kernel checks, and its tiles write each final output exactly once."""
    rng = np.random.default_rng(1000 * depth + chain.TAILS[tail])
    seen = 0
    while seen < 25:
        cin = int(rng.integers(1, 33))
        specs = _random_admitted(rng, cin, depth, tail)
        if specs is None:
            continue
        n = int(rng.choice([1, 3, 8, 64]))
        h, w = (int(v) for v in rng.choice([1, 2, 5, 17, 32, 64, 101, 540], 2))
        h += sum(s.k - 1 - s.pt - s.pb for s in specs)  # "valid" layers shrink the image
        w += sum(s.k - 1 - s.pl - s.pr for s in specs)
        geo = chain.launch_geometry(tuple(specs), n, h, w, 132)
        _holds(geo, specs)
        _covers_once(geo, specs, n, h, w)
        seen += 1


def test_tc_geometry_at_the_gate_limits():
    """The chains the gate admits with the most weights or the widest
    regions still fit the bf16 form (weights staged layer by layer where
    they do not all fit beside the regions)."""
    for specs in (
        [chain.ChainLayerSpec(5, 32, 32, 2, 2, 2, 2, "relu", 0.3)],
        [chain.ChainLayerSpec(9, 1, 32, 4, 4, 4, 4, "relu", 0.3),
         chain.ChainLayerSpec(9, 32, 1, 4, 4, 4, 4, "relu", 0.3)],
        [chain.ChainLayerSpec(3, 32, 32, 1, 1, 1, 1, "relu", 0.3)] * 2,
        [chain.ChainLayerSpec(9, 8, 8, 4, 4, 4, 4, "relu", 0.3)] * 8,
    ):
        if chain.smem_bytes(specs) > chain.MAX_SMEM_BYTES:
            continue
        for n, h, w in ((8, 540, 960), (1, 3, 3), (64, 32, 32)):
            geo = chain.launch_geometry(tuple(specs), n, h, w, 132)
            _holds(geo, specs)
            _covers_once(geo, specs, n, h, w)


@pytest.mark.parametrize("c", range(1, 33))
def test_dense_taps_for_fewer_than_8_channels(c):
    """C < 8 packs taps densely into K (ESPCN's head: 25 taps in 2 k16
    steps, not 13); C >= 8 walks units of 8 channels, C padded to 8."""
    for k in (1, 3, 5, 9):
        tl = chain.tc_layers([chain.ChainLayerSpec(k, c, 16, 0, k - 1, 0, k - 1, "relu", 0.3)])[0]
        assert tl.dense == (c < 8)
        want = -(-(k * k * c) // 16) if c < 8 else -(-(k * k * -(-c // 8)) // 2)
        assert tl.ksteps == want
    if c == 1:
        assert chain.tc_layers([chain.ChainLayerSpec(5, 1, 16, 2, 2, 2, 2, "relu", 0.3)])[0].ksteps == 2


@pytest.mark.parametrize("c,o,k", [(1, 16, 5), (3, 20, 3), (16, 16, 3), (12, 4, 2), (32, 32, 1), (24, 9, 4)])
def test_packed_weights_follow_the_kernel_k_order(rng, c, o, k):
    """pack_params lays out each layer's B image in the K order the kernel
    walks (tap-major; channels padded to 8 unless C < 8), so that im2col
    rows in that order times the image are the convolution, and scale and
    offset sit behind it, zeros past o."""
    spec = chain.ChainLayerSpec(k, c, o, (k - 1) // 2, k // 2, (k - 1) // 2, k // 2, "linear", 0.3)
    p = {"w": torch.from_numpy(rng.standard_normal((k, k, c, o)).astype(np.float32)),
         "scale": torch.from_numpy(rng.standard_normal(o).astype(np.float32)),
         "offset": torch.from_numpy(rng.standard_normal(o).astype(np.float32))}
    tl = chain.tc_layers([spec])[0]
    packed = chain.pack_params([p], [spec])
    [(pw, ps)], total = chain.param_layout([spec])
    assert packed.numel() == total
    img = packed[pw:pw + tl.w_bytes].view(torch.bfloat16).float().reshape(16 * tl.ksteps, tl.ostride)
    so = packed[ps:ps + 64 * tl.nt].view(torch.float32).reshape(2, 8 * tl.nt)
    assert torch.equal(so[0, :o], p["scale"]) and not so[:, o:].any() and not img[:, o:].any()
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, c)).astype(np.float32)).to(torch.bfloat16).float()
    xp = torch.nn.functional.pad(x, (0, 0, spec.pl, spec.pr, spec.pt, spec.pb))
    cols = []
    for dy in range(k):
        for dx in range(k):
            patch = xp[0, dy:dy + 6, dx:dx + 7, :]
            if not tl.dense:
                patch = torch.nn.functional.pad(patch, (0, -c % 8))
            cols.append(patch.reshape(42, -1))
    a = torch.cat(cols, 1)
    a = torch.nn.functional.pad(a, (0, 16 * tl.ksteps - a.shape[1]))
    got = (a.double() @ img.double()[:, :o]).reshape(1, 6, 7, o)
    wb = p["w"].to(torch.bfloat16).double()
    ref = sum(torch.einsum("hwc,co->hwo", xp[0, dy:dy + 6, dx:dx + 7].double(), wb[dy, dx])
              for dy in range(k) for dx in range(k))
    assert torch.allclose(got[0], ref, atol=1e-9)


# -- INT8: int8 weights and the a8 dots ----------------------------------------

class QNode(FakeNode):
    """A conv node after quantize_graph_weights (int8 weight, per-channel
    scale), with a calibrated input scale where one is given."""

    def __init__(self, name, k, o, act, w, b, in_act_scale=0.0):
        from shadernn_tpu.quant.quantize import quantize_weight

        super().__init__(k, o, act, w, b)
        self.name = name
        q, s = quantize_weight(w)
        self.params = dict(weight_q=q, weight_scale=s, bias=b)
        if in_act_scale:
            self._a["in_act_scale"] = in_act_scale


def make_qnodes(rng, cfg, cin, scales):
    return [QNode(f"l{i}", n.attr("kernel_size"), n.attr("out_channels"), n.attr("activation"),
                  n.params["weight"], n.params["bias"], s)
            for i, (n, s) in enumerate(zip(make_nodes(rng, cfg, cin), scales))]


# (cfg, cin, tail, act_override, calibrated in_act_scale per layer): ESPCN's
# body (the head's C = 1 keeps bf16; layers 2-3 take calibrated scales) and a
# chain whose head takes the frame as int8 (step 1/127) and whose last layer
# follows a tanh (step 1/127).
A8_CHAINS = {
    "espcn": (ESPCN_BODY, 1, "d2s2", ("tanh", 0.3), [0.0, 0.03, 0.05]),
    "int8_head": ([(3, 16, "relu"), (3, 8, "tanh"), (3, 1, "linear")], 8, "c1", None,
                  [0.0, 0.02, 0.0]),
}


@pytest.mark.parametrize("a8", [False, True], ids=["weight_only", "a8"])
@pytest.mark.parametrize("case", list(A8_CHAINS))
def test_int8_chain_matches_jax_packed_kernel(rng, case, a8):
    """Int8 weights (weight-only) and the a8 int8 x int8 dots: the plan's
    in_q per layer equals build_chain_packed(a8=True)'s, and the plain
    version is within the int8 tolerance of the JAX kernel (Pallas
    interpret mode) on the same int8 weights and frames."""
    cfg, cin, tail, act_override, scales = A8_CHAINS[case]
    nodes = make_qnodes(rng, cfg, cin, scales)
    x = rng.random((2, 16, 24, cin), dtype=np.float32)
    lp, jspecs = build_chain_packed(nodes, cin, jnp.bfloat16, act_override=act_override,
                                    width=24, tail=tail, a8=a8)
    want = np.asarray(j_packed(jnp.asarray(x), lp, jspecs, interpret=True, tail=tail,
                               compute_dtype=jnp.bfloat16), np.float32)
    specs = chain.build_chain_specs(nodes, cin, torch.bfloat16, act_override=act_override,
                                    tail=tail)
    if a8:
        specs, notes = chain.a8_scales(nodes, specs, head_from_frame=True)
        assert [n[1] for n in notes] == [s.in_q for s in specs]
    assert [s.in_q for s in specs] == [s.in_q for s in jspecs]
    assert any(s.in_q for s in specs) == a8
    ops = chain.chain_operands(nodes, torch.bfloat16, specs)
    assert all(p["w"].dtype == torch.int8 for p in ops)
    got = chain.fused_conv_chain_packed(torch.from_numpy(x), ops, specs, tail=tail,
                                        compute_dtype=torch.bfloat16).float().numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 0.1 * max(1.0, float(np.abs(want).max()))


def test_a8_rule_matches_jax_but_not_its_mid_graph_head_fallback(rng):
    """a8_scales is build_chain_packed's rule: bounded previous activations
    (tanh, sigmoid: 1/127; relu6: 6/127), else a calibrated scale; float
    weights and C % 8 != 0 keep bf16. A head without a calibrated scale
    takes the frame's 1/127 only when an InputLayer feeds it (the JAX
    package gives it to any head, ROADMAP C1)."""
    cfg = [(3, 16, "relu6"), (3, 16, "sigmoid"), (3, 12, "relu"), (3, 8, "relu"), (3, 8, "relu"),
           (3, 1, "tanh")]
    nodes = make_qnodes(rng, cfg, 16, [0.0, 0.0, 0.0, 0.0, 0.04, 0.0])
    _, jspecs = build_chain_packed(nodes, 16, jnp.bfloat16, width=32, tail="c1", a8=True)
    specs = chain.build_chain_specs(nodes, 16, torch.bfloat16, tail="c1")
    frame, _ = chain.a8_scales(nodes, specs, head_from_frame=True)
    mid, notes = chain.a8_scales(nodes, specs, head_from_frame=False)
    assert [s.in_q for s in frame] == [s.in_q for s in jspecs]
    assert [s.in_q for s in frame] == [1 / 127, 6 / 127, 1 / 127, 0.0, 0.04, 0.0]
    assert [s.in_q for s in mid] == [0.0, 6 / 127, 1 / 127, 0.0, 0.04, 0.0]
    assert "mid-graph head" in notes[0][2] and "C = 12" in notes[3][2]
    assert "calibrated" in notes[4][2] and "without a calibrated" in notes[5][2]
    floats = make_nodes(rng, cfg, 16)
    for n in floats:
        n.name = "f"
    fspecs = chain.build_chain_specs(floats, 16, torch.bfloat16, tail="c1")
    assert not any(s.in_q for s in chain.a8_scales(floats, fspecs, True)[0])


def test_a8_needs_the_bf16_form(rng):
    nodes = make_qnodes(rng, ESPCN_BODY, 1, [0.0, 0.03, 0.05])
    specs = chain.a8_scales(nodes, chain.build_chain_specs(nodes, 1, torch.float32), True)[0]
    ops = chain.chain_operands(nodes, torch.float32, specs)
    with pytest.raises(ValueError, match="bf16 form"):
        chain.fused_conv_chain(torch.zeros((1, 8, 8, 1)), ops, specs, compute_dtype=torch.float32)


def _random_a8(rng, depth, tail):
    """An admitted chain with int8 inputs (in_q) on a random subset of the
    layers whose C is a multiple of 8."""
    while True:
        cin = int(rng.choice([1, 8, 16, 24, 32]))
        specs = _random_admitted(rng, cin, depth, tail)
        if specs is None:
            continue
        specs = [dataclasses.replace(s, in_q=0.01) if s.c % 8 == 0 and rng.random() < 0.7 else s
                 for s in specs]
        if any(s.in_q for s in specs):
            return specs


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 8])
def test_a8_geometry_fits_and_covers_each_output_once(depth):
    """The launch of chains with int8 layer inputs (16-channel units, n-major
    B rows of k32 steps) fits 227 KB with the layout the kernel checks and
    writes each final output once, from 1x1 images up to 540p."""
    rng = np.random.default_rng(77 + depth)
    for i in range(20):
        tail = list(chain.TAILS)[i % 3]
        specs = _random_a8(rng, depth, tail)
        n = int(rng.choice([1, 3, 8, 64]))
        h, w = (int(v) for v in rng.choice([1, 2, 5, 17, 32, 101, 540], 2))
        h += sum(s.k - 1 - s.pt - s.pb for s in specs)
        w += sum(s.k - 1 - s.pl - s.pr for s in specs)
        geo = chain.launch_geometry(tuple(specs), n, h, w, 132)
        _holds(geo, specs)
        _covers_once(geo, specs, n, h, w)
    espcn = [chain.ChainLayerSpec(5, 1, 16, 2, 2, 2, 2, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 16, 1, 1, 1, 1, "relu", 0.3, 0.03),
             chain.ChainLayerSpec(3, 16, 4, 1, 1, 1, 1, "tanh", 0.3, 0.05)]
    geo = chain.launch_geometry(tuple(espcn), 8, 540, 960, 132)
    _holds(geo, espcn)
    _covers_once(geo, espcn, 8, 540, 960)
    # int8 regions of 16 channels are one 16-byte unit a pixel; k32 steps.
    assert [(t.q8, t.cs, t.ksteps, t.ostride) for t in chain.tc_layers(espcn)[1:]] == [
        (True, 16, 5, 176), (True, 16, 5, 176)]


@pytest.mark.parametrize("c,o,k", [(8, 16, 3), (16, 16, 3), (16, 4, 3), (24, 9, 5), (32, 32, 1)])
def test_q8_packed_weights_follow_the_kernel_k_order(rng, c, o, k):
    """An int8 layer's B image is n-major: row n holds output channel n's
    weights in the kernel's K order (tap-major, C padded to 16), so that an
    im2col in that order times its transpose is the convolution; rows past
    o and K past the taps are zero."""
    spec = chain.ChainLayerSpec(k, c, o, (k - 1) // 2, k // 2, (k - 1) // 2, k // 2, "linear",
                                0.3, 0.02)
    p = {"w": torch.from_numpy(rng.integers(-127, 128, (k, k, c, o)).astype(np.int8)),
         "scale": torch.from_numpy(rng.standard_normal(o).astype(np.float32)),
         "offset": torch.from_numpy(rng.standard_normal(o).astype(np.float32))}
    tl = chain.tc_layers([spec])[0]
    assert tl.q8 and tl.ksteps == -(-(k * k * -(-c // 16)) // 2)
    packed = chain.pack_params([p], [spec])
    [(pw, ps)], total = chain.param_layout([spec])
    assert packed.numel() == total
    img = packed[pw:pw + tl.w_bytes].view(torch.int8).reshape(8 * tl.nt, tl.ostride)
    assert not img[o:].any() and not img[:, 32 * tl.ksteps:].any()
    so = packed[ps:ps + 64 * tl.nt].view(torch.float32).reshape(2, 8 * tl.nt)
    assert torch.equal(so[1, :o], p["offset"])
    x = torch.from_numpy(rng.integers(-127, 128, (1, 6, 7, c)).astype(np.int8))
    xp = torch.nn.functional.pad(x, (0, -c % 16, spec.pl, spec.pr, spec.pt, spec.pb))
    a = torch.cat([xp[0, dy:dy + 6, dx:dx + 7, :].reshape(42, -1)
                   for dy in range(k) for dx in range(k)], 1).long()
    got = a @ img[:o, :a.shape[1]].long().t()
    want = chain.conv2d_nhwc_int8(x, p["w"], (spec.pt, spec.pb, spec.pl, spec.pr))
    assert torch.equal(got.int(), want.reshape(42, o))


# -- The f32 form (3xTF32) -------------------------------------------------------
# Its launch geometry, its gate, its packed weights and a plain model of its
# arithmetic. The kernel itself is held against its plain version on the card
# (chip_smoke.py).

# (chain, C in, (k, o) per layer, tail, admitted, smem_bytes): what
# build_chain_specs admitted at the commit before the f32 form's redesign,
# at both dtypes; the gate's term is unchanged.
GATE_TABLE = [
    ("espcn", 1, [(5, 16), (3, 16), (3, 4)], "d2s2", True, 98656),
    ("espcn none", 1, [(5, 16), (3, 16), (3, 4)], "none", True, 98656),
    ("k9 c16 o32", 16, [(9, 32)], "none", True, 227584),
    ("k9 c16 o33", 16, [(9, 33)], "none", False, None),
    ("k9 c32 o8", 32, [(9, 8)], "none", True, 205888),
    ("k9 c32 o9", 32, [(9, 9)], "none", False, None),
    ("k9 c32 o16", 32, [(9, 16)], "none", False, None),
    ("k7 c32 o16", 32, [(7, 16)], "none", True, 207488),
    ("k7 c32 o32", 32, [(7, 32)], "none", False, None),
    ("k5 c32 o32", 32, [(5, 32)], "none", True, 194816),
    ("k5 c32 o32 x2", 32, [(5, 32)] * 2, "none", False, None),
    ("k3 c32 o32 x3", 32, [(3, 32)] * 3, "none", False, None),
    ("k3 c32 o32 x8", 32, [(3, 32)] * 8, "none", False, None),
    ("k9 c8 o8 x8", 8, [(9, 8)] * 8, "none", False, None),
    ("k3 c8 o8 x8", 8, [(3, 8)] * 8, "none", True, 112256),
    ("C1 k9 o32, k9 o1", 1, [(9, 32), (9, 1)], "c1", True, 150032),
    ("C1 k9 o32, k9 o4", 1, [(9, 32), (9, 4)], "d2s2", True, 181152),
    ("9 layers", 1, [(9, 8)] * 9, "none", False, None),
    ("k10", 1, [(10, 8)], "none", False, None),
    ("c1 tail, o 2", 4, [(3, 8), (3, 2)], "c1", False, None),
    ("resnet18 16->16->16", 16, [(3, 16), (3, 16)], "none", True, 103936),
    ("k1 c32 o32 x8", 32, [(1, 32)] * 8, "none", True, 165888),
    ("k9 c24 o24", 24, [(9, 24)], "none", False, None),
    ("k9 c24 o16", 24, [(9, 16)], "none", True, 216704),
]


@pytest.mark.parametrize("case", GATE_TABLE, ids=lambda c: c[0])
def test_gate_admits_and_declines_what_it_did(case):
    """The gate (build_chain_specs, its term smem_bytes) is untouched by the
    f32 form's redesign: the same chains in, the same out, at both dtypes."""
    _name, cin, cfg, tail, admitted, smem = case
    for dt in (torch.float32, torch.bfloat16):
        nodes = [FakeNode(k, o, "relu", None, None) for k, o in cfg]
        specs = chain.build_chain_specs(nodes, cin, dt, tail=tail)
        assert (specs is not None) == admitted
        if admitted:
            assert chain.smem_bytes(specs) == smem


def _holds_f32(geo, specs):
    """csrc/conv_chain.cu run_f32's checks: strides, passes, parameter
    offsets, regions big enough, every buffer 16-byte aligned within the
    shared memory asked for, and no two overlapping unless they take turns
    (one ping-pong buffer's regions, the weights when staged pass by pass)."""
    assert geo.smem <= chain.MAX_SMEM_BYTES and geo.threads % 32 == 0 and geo.threads <= 512
    regs = chain.regions(specs, geo.tile_h, geo.tile_w)
    ivs = []
    for l, (s, fl, lay) in enumerate(zip(specs, chain.f32_layers(specs), geo.layers)):
        cs, ostride, ng, w_off, ktab_off, pw, pw_lo, ps, reg, kp, b_raw, pw_raw = lay
        units = -(-s.c // 8)
        assert fl.dense == (s.c < 8)
        if fl.dense:
            assert cs == s.c and fl.ksteps == -(-(s.k * s.k * s.c) // 8)
        else:
            assert cs >= 8 * units and cs % 4 == 0 and (cs // 4) % 2 == 1
            assert fl.ksteps == s.k * s.k * units
        assert ostride >= 8 * fl.ksteps and ostride % 4 == 0 and (ostride // 4) % 2 == 1
        assert 1 <= ng <= 2 and kp >= 1
        image = 8 * fl.nt * ostride * 4
        assert not (b_raw and geo.w_all)
        for off in (pw, pw_lo, pw_raw):
            assert off % 16 == 0 and 0 <= off and off + image <= geo.param_bytes
        assert ps % 16 == 0 and ps + 64 * fl.nt <= geo.param_bytes
        rows, cols = regs[l]
        assert reg % 16 == 0 and reg >= 4 * rows * cols * cs
        w_lo = image if geo.w_all else 8 * ng * ostride * 4
        ivs.append((geo.buf1 if l % 2 else geo.buf0, 2 * reg, l % 2))
        ivs.append((w_off, (1 if b_raw else 2) * w_lo, 10 + l if geo.w_all else 2))
        ivs.append((ktab_off, fl.ktab_bytes, 20 + l))
    rows, cols = regs[0]
    ivs.append((geo.raw_off, 4 * rows * cols * specs[0].c, 30))  # the frame buffer
    for i, (off, size, slot) in enumerate(ivs):
        assert off % 16 == 0 and 0 <= off and off + size <= geo.smem, (i, off, size, geo.smem)
        for off2, size2, slot2 in ivs[:i]:
            assert slot == slot2 or off >= off2 + size2 or off2 >= off + size, (geo, ivs)


def _covers_once_persistent(geo, specs, n, h, w):
    """Every tile once: CTA b of the persistent grid takes tiles b, b +
    grid, ..., and the tiles write each final output once."""
    _covers_once(geo, specs, n, h, w)
    ho, wo = chain._out_hw(h, w, specs)
    tiles = n * -(-ho // geo.tile_h) * -(-wo // geo.tile_w)
    assert 1 <= geo.grid <= tiles
    seen = sorted(t for b in range(geo.grid) for t in range(b, tiles, geo.grid))
    assert seen == list(range(tiles))


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("tail", list(chain.TAILS))
def test_f32_geometry_of_admitted_chains_fits_and_covers_each_output_once(depth, tail):
    """k 1-9, C 1-32, o 1-32, random pads, every tail, images from 1x1 up to
    540p and batches 1-64: the f32 launch fits 227 KB with the layout the
    kernel checks, and its tiles write each final output exactly once."""
    rng = np.random.default_rng(5000 + 1000 * depth + chain.TAILS[tail])
    seen = 0
    while seen < 12:
        cin = int(rng.integers(1, 33))
        specs = _random_admitted(rng, cin, depth, tail)
        if specs is None:
            continue
        n = int(rng.choice([1, 3, 8, 64]))
        h, w = (int(v) for v in rng.choice([1, 2, 5, 17, 32, 64, 101, 540], 2))
        h += sum(s.k - 1 - s.pt - s.pb for s in specs)
        w += sum(s.k - 1 - s.pl - s.pr for s in specs)
        geo = chain.f32_launch_geometry(tuple(specs), n, h, w, 132)
        _holds_f32(geo, specs)
        _covers_once_persistent(geo, specs, n, h, w)
        seen += 1


# Chains at the gate's edges: the largest single layers it admits (their hi
# and lo weights do not fit beside the regions: staged pass by pass), 8
# layers, o = 32, k = 9, a C = 1 dense head, each tail.
F32_EDGES = {
    "k9 c16 o32": ([(9, 32)], 16, "none"),
    "k9 c32 o8": ([(9, 8)], 32, "none"),
    "k7 c32 o16": ([(7, 16)], 32, "none"),
    "k5 c32 o32": ([(5, 32)], 32, "none"),
    "k9 c24 o16": ([(9, 16)], 24, "none"),
    "8 layers k3 c8": ([(3, 8)] * 8, 8, "none"),
    "8 layers k1 o32": ([(1, 32)] * 8, 32, "none"),
    "C1 k9 head, c1": ([(9, 32), (9, 1)], 1, "c1"),
    "C1 k9 head, d2s2": ([(9, 32), (9, 4)], 1, "d2s2"),
    "espcn": ([(5, 16), (3, 16), (3, 4)], 1, "d2s2"),
}


@pytest.mark.parametrize("name", list(F32_EDGES))
def test_f32_geometry_at_the_gate_limits(name):
    cfg, cin, tail = F32_EDGES[name]
    nodes = [FakeNode(k, o, "relu", None, None) for k, o in cfg]
    specs = chain.build_chain_specs(nodes, cin, torch.float32, tail=tail)
    assert specs is not None
    for n, h, w in ((8, 540, 960), (1, 3, 3), (64, 32, 32), (2, 37, 101)):
        geo = chain.f32_launch_geometry(tuple(specs), n, h, w, 132)
        _holds_f32(geo, specs)
        _covers_once_persistent(geo, specs, n, h, w)
    if name.startswith("k9 c16"):  # 2 x 166 KB of B: one pass at a time
        assert not chain.f32_launch_geometry(tuple(specs), 8, 540, 960, 132).w_all


@pytest.mark.parametrize("k", range(1, 10))
def test_f32_geometry_of_every_admitted_single_layer(k):
    """One layer of every k, C and o the gate admits (C and o at the unit
    edges): the f32 launch fits and covers each output once."""
    for c in (1, 2, 3, 7, 8, 9, 16, 24, 32):
        for o in (1, 4, 8, 9, 16, 17, 24, 32):
            spec = [chain.ChainLayerSpec(k, c, o, (k - 1) // 2, k // 2, (k - 1) // 2, k // 2,
                                         "relu", 0.3)]
            if chain.smem_bytes(spec) > chain.MAX_SMEM_BYTES:
                continue
            for n, h, w in ((8, 540, 960), (2, 5, 7)):
                geo = chain.f32_launch_geometry(tuple(spec), n, h, w, 132)
                _holds_f32(geo, spec)
                _covers_once_persistent(geo, spec, n, h, w)


def test_espcn_f32_geometry_keeps_every_weight_resident():
    """ESPCN 540p b8 (the FP32 main path): 3,280 weights, hi and lo, stay
    resident; the head packs its 25 taps into 4 k8 steps (K = 32, not 25
    x 8); 16 channels pad to a pitch of 20 floats (5 units)."""
    specs = [chain.ChainLayerSpec(5, 1, 16, 2, 2, 2, 2, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 16, 1, 1, 1, 1, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 4, 1, 1, 1, 1, "linear", 0.3)]
    fls = chain.f32_layers(specs)
    assert [(f.dense, f.cs, f.ksteps, f.nt, f.ostride, f.kp) for f in fls] == [
        (True, 1, 4, 2, 36, 4), (False, 20, 18, 2, 148, 2), (False, 20, 18, 1, 148, 2)]
    geo = chain.f32_launch_geometry(tuple(specs), 8, 540, 960, 132)
    assert geo.w_all == 1
    _holds_f32(geo, specs)


@pytest.mark.parametrize("c,o,k,int8", [(1, 16, 5, False), (3, 20, 3, False), (16, 16, 3, False),
                                        (12, 4, 2, False), (32, 32, 1, False), (24, 9, 4, False),
                                        (16, 16, 3, True), (1, 16, 5, True)])
def test_f32_packed_weights_follow_the_kernel_k_order(rng, c, o, k, int8):
    """pack_params_f32 lays out each layer's B images n-major in the K order
    the kernel walks (tap-major; channels padded to 8 unless C < 8): hi +
    lo is the HWIO weight within 2^-22, both TF32, so that im2col rows in
    that order times (hi + lo) is the convolution; scale and offset sit
    behind them, zeros past o. An int8 weight has no lo (its pass is
    skipped)."""
    spec = chain.ChainLayerSpec(k, c, o, (k - 1) // 2, k // 2, (k - 1) // 2, k // 2, "linear", 0.3)
    if int8:
        w = torch.from_numpy(rng.integers(-127, 128, (k, k, c, o)).astype(np.int8))
    else:
        w = torch.from_numpy(rng.standard_normal((k, k, c, o)).astype(np.float32))
    p = {"w": w, "scale": torch.from_numpy(rng.standard_normal(o).astype(np.float32)),
         "offset": torch.from_numpy(rng.standard_normal(o).astype(np.float32))}
    fl = chain.f32_layers([spec])[0]
    packed, b_lo = chain.pack_params_f32([p], [spec])
    [(pw, pw_lo, pw_raw, ps)], total = chain.f32_param_layout([spec])
    assert packed.numel() == total and b_lo == (0 if int8 else 1,)
    img = lambda off: packed[off:off + fl.image_bytes].view(torch.float32).reshape(  # noqa: E731
        8 * fl.nt, fl.ostride)
    hi, lo = img(pw), img(pw_lo)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0  # TF32
    assert not hi[o:].any() and not hi[:, 8 * fl.ksteps:].any() and (int8 or lo.any())
    assert torch.equal(img(pw_raw), hi + lo) if int8 else torch.equal(tf32_split(img(pw_raw))[0], hi)
    so = packed[ps:ps + 64 * fl.nt].view(torch.float32).reshape(2, 8 * fl.nt)
    assert torch.equal(so[1, :o], p["offset"]) and not so[:, o:].any()
    wf = w.double()
    per_tap = c if fl.dense else 8 * -(-c // 8)
    b = torch.zeros((8 * fl.ksteps, o), dtype=torch.float64)
    for tap in range(k * k):
        b[tap * per_tap:tap * per_tap + c] = wf[tap // k, tap % k]
    full = (hi.double() + lo.double())[:o, :8 * fl.ksteps].t()
    assert torch.all((full - b).abs() <= 2.0 ** -22 * b.abs())
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, c)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, spec.pl, spec.pr, spec.pt, spec.pb)).double()
    cols = []
    for dy in range(k):
        for dx in range(k):
            patch = xp[0, dy:dy + 6, dx:dx + 7, :]
            if not fl.dense:
                patch = torch.nn.functional.pad(patch, (0, -c % 8))
            cols.append(patch.reshape(42, -1))
    a = torch.cat(cols, 1)
    a = torch.nn.functional.pad(a, (0, 8 * fl.ksteps - a.shape[1]))
    ref = sum(torch.einsum("hwc,co->hwo", xp[0, dy:dy + 6, dx:dx + 7], wf[dy, dx])
              for dy in range(k) for dx in range(k))
    assert torch.allclose((a @ full).reshape(6, 7, o), ref, atol=1e-5)


def chain_3xtf32(x, layer_params, specs, tail):
    """A plain model of the f32 form's arithmetic, layer by layer
    (kernels/tf32.py): the frame split into TF32 hi and lo as it is staged
    (a bf16 frame is exact: no lo), every layer a conv in 3xTF32 promoted
    per tap, its epilogue in float32, its output zero outside the image and
    split by the producer into the next layer's hi and lo."""
    from shadernn_tpu_torch.kernels.tf32 import conv_3xtf32

    hi, lo = tf32_split(x.float())
    lo = None if x.dtype == torch.bfloat16 else lo
    for p, s in zip(layer_params, specs):
        acc = conv_3xtf32(hi, lo, p["w"].float(), 1, (s.pt, s.pb, s.pl, s.pr))
        y = chain.apply_activation(acc * p["scale"].float() + p["offset"].float(), s.activation,
                                   s.alpha)
        hi, lo = tf32_split(y)
    y = hi + lo  # the last layer writes y itself (hi + lo = y within 2^-22)
    return chain.depth_to_space(y, 2) if tail == "d2s2" else y


@pytest.mark.parametrize("x_bf16", [False, True], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("cfg,tail", [
    (ESPCN_BODY, "none"),
    ([(5, 16, "relu"), (3, 8, "relu"), (3, 1, "sigmoid")], "c1"),
    ([(3, 12, "tanh"), (9, 4, "linear")], "d2s2"),
])
def test_f32_arithmetic_model_matches_plain_and_jax(rng, fp32_threshold, cfg, tail, x_bf16):
    """The 3xTF32 model of the f32 form against the plain version
    (chip_smoke.py's f32 tolerance, 1e-4 x max(1, max|plain|)) and against
    the JAX im2col chain kernel in Pallas interpret mode (the fp32
    threshold); from a bf16 frame (exact in TF32: two passes in the head)
    against the plain version."""
    nodes = make_nodes(rng, cfg, 1)
    x = rng.random((2, 24, 40, 1), dtype=np.float32)
    xt = torch.from_numpy(x)
    if x_bf16:
        xt = xt.to(torch.bfloat16)
    specs = chain.build_chain_specs(nodes, 1, torch.float32, tail=tail)
    ops = chain.chain_operands(nodes, torch.float32)
    got = chain_3xtf32(xt, ops, specs, tail)
    plain = chain.conv_chain_reference(xt, ops, specs, tail, torch.float32)
    assert got.shape == plain.shape
    assert (got - plain).abs().max().item() <= 1e-4 * max(1.0, plain.abs().max().item())
    if x_bf16 or tail == "d2s2":
        return
    lp, jspecs = build_chain(nodes, 1, jnp.float32)
    want = j_chain(jnp.asarray(x), lp, jspecs, interpret=True, tail=tail)
    want = np.asarray(from_haloed(want) if tail == "none" else want, np.float32)
    assert np.max(np.abs(got.numpy() - want)) <= fp32_threshold
