"""The split-TF32 (3xTF32) arithmetic of the float32 forms of the
single-conv, block, chain and implicit-GEMM conv kernels
(shadernn_tpu_torch.kernels.tf32, the plain model of csrc/snn_mma.cuh's
split and product) against float32, float64 and the JAX package, which
runs float32 products at HIGHEST precision: at the largest K each
kernel's gate admits (the single conv: kh*kw*C = 4096 and 3200; the
block: E = 960 with Cin 160 and Cout 320; the implicit-GEMM conv: 4096;
the chain: k9 with C 16 and 32), at |x| ~ 1 and ~ 1e2; and the chain's
producer-side split, bit for bit the consumer's. The CUDA kernels
themselves are held against their plain versions on the card by
chip_smoke.py.

Tolerance: chip_smoke.py's TOL_FP32, 1e-4 x max(1, max|reference|), which
the kernels' float32 forms must hold; the model's error against float64
is held to a tenth of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.kernels.block_pallas import InvResSpec as JSpec
from shadernn_tpu.kernels.block_pallas import fused_invres_block as j_block
from shadernn_tpu.kernels.conv_pallas import from_haloed
from shadernn_tpu.ops.conv import conv_run_pallas_chain
from shadernn_tpu.ops.registry import RunCtx as JCtx

from shadernn_tpu_torch.kernels import conv, invres
from shadernn_tpu_torch.kernels.tf32 import conv_3xtf32, matmul_3xtf32, tf32_round, tf32_split
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.conv import conv2d_nhwc_f32

TOL_FP32 = 1e-4  # chip_smoke.py: the kernels' float32 forms against their plain versions


def within(got, want, tol=TOL_FP32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) <= tol * max(1.0, float(np.abs(want).max()))


def test_tf32_round_is_cvt_rna():
    """Round to nearest with ties away from zero, the low 13 bits zero."""
    ulp = 2.0 ** -10  # TF32's spacing at 1
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0, -0.0, 2.0 ** -130], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0, -0.0, 2.0 ** -130]
    got = tf32_round(v)
    assert got.tolist() == want
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    q = tf32_round(r)
    assert int((q.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.all((q - r).abs() <= 2.0 ** -11 * r.abs())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e2, 1e30])
def test_split_reconstructs_within_2_to_the_minus_22(scale):
    v = torch.from_numpy((np.random.default_rng(5).standard_normal(1 << 14) * scale)
                         .astype(np.float32))
    hi, lo = tf32_split(v)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - v.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * v.double().abs())


# (label, M, K, N): the largest K of each gate, as one matmul of the kernel.
PRODUCTS = [
    ("conv k8 c64->128 K=4096", 96, 4096, 128),
    ("conv k5 c128->128 K=3200", 96, 3200, 128),
    ("block expand Cin=160 E=960", 96, 160, 960),
    ("block project E=960 Cout=320", 96, 960, 320),
]


@pytest.mark.parametrize("mag", [1.0, 1e2], ids=["x~1", "x~1e2"])
@pytest.mark.parametrize("case", PRODUCTS, ids=lambda c: c[0].split()[0] + str(c[2]))
def test_3xtf32_product_holds_the_fp32_threshold(case, mag):
    """The three-pass product against float32, float64 and the JAX
    package's HIGHEST-precision product; two passes where B is exact in
    TF32 (int8 weights) stay as close."""
    _label, m, k, n = case
    rng = np.random.default_rng(k)
    a = (mag * rng.standard_normal((m, k))).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    got = matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    f64 = a.astype(np.float64) @ b.astype(np.float64)
    f32 = torch.from_numpy(a) @ torch.from_numpy(b)
    highest = jnp.dot(jnp.asarray(a), jnp.asarray(b), precision=jax.lax.Precision.HIGHEST)
    assert within(got, f32.numpy()) and within(got, np.asarray(highest))
    assert within(got, f64, TOL_FP32 / 10)
    # One pass of TF32 alone would not hold it: the split is what keeps f32.
    one_pass = (tf32_round(torch.from_numpy(a)) @ tf32_round(torch.from_numpy(b))).numpy()
    assert not within(one_pass, f64, TOL_FP32 / 10)
    b8 = rng.integers(-127, 128, (k, n)).astype(np.float32)
    got8 = matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b8), b_exact=True).numpy()
    assert within(got8, a.astype(np.float64) @ b8.astype(np.float64), TOL_FP32 / 10)


def _conv_3xtf32(x, w, pads, a_exact=False):
    """The single conv's f32 form as the model computes it: an im2col
    matmul in 3xTF32 (the kernel walks the same K tap by tap)."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    pt, pb, pl, pr = pads
    cols = F.unfold(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)), (kh, kw))
    ho, wo = h + pt + pb - kh + 1, wd + pl + pr - kw + 1
    a = cols.transpose(1, 2).reshape(-1, c * kh * kw)
    y = matmul_3xtf32(a, w.permute(2, 0, 1, 3).reshape(-1, o), a_exact=a_exact)
    return y.reshape(n, ho, wo, o)


@pytest.mark.parametrize("mag", [1.0, 1e2], ids=["x~1", "x~1e2"])
@pytest.mark.parametrize("k,c", [(8, 64), (5, 128)], ids=["k8c64", "k5c128"])
def test_conv_f32_form_model_matches_plain_and_jax(k, c, mag):
    """The largest-K convs the gate admits, o = 128: the 3xTF32 model
    against the plain version and the JAX package's haloed kernel
    (Pallas interpret mode), float32; from a bf16 input (A exact: two
    passes) against the plain version."""
    rng = np.random.default_rng(11)
    o, pads = 128, padding_offsets("same", k)
    assert c * k * k <= 4096 and conv.smem_bytes(k, k, o) <= conv.MAX_SMEM_BYTES
    x = (mag * rng.standard_normal((1, 9, 10, c))).astype(np.float32)
    w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, bias))
    ones = torch.ones(o)
    got = (_conv_3xtf32(xt, wt, pads) + bt).numpy()
    plain = conv.conv2d_haloed_reference(xt, wt, ones, bt, pads, "linear", 0.3, torch.float32)
    jnode = JNode("conv", "Conv2D", ["x"],
                  dict(kernel_size=k, out_channels=o, padding="same", activation="linear",
                       stride=1, use_bias=True),
                  {"weight": jnp.asarray(w), "bias": jnp.asarray(bias)})
    want = np.asarray(from_haloed(conv_run_pallas_chain(jnode, jnp.asarray(x), JCtx())))
    assert within(got, plain.numpy()) and within(got, want)
    xb = xt.to(torch.bfloat16).float()
    got_b = (_conv_3xtf32(xb, wt, pads, a_exact=True) + bt).numpy()
    plain_b = conv.conv2d_haloed_reference(xb, wt, ones, bt, pads, "linear", 0.3, torch.float32)
    assert within(got_b, plain_b.numpy())


@pytest.mark.parametrize("mag", [1.0, 1e2], ids=["x~1", "x~1e2"])
def test_block_f32_form_model_matches_plain_and_jax(mag):
    """The widest block the planner fuses (MobileNetV2's 160 -> 960 -> 320
    at 7x7): both 1x1 products in 3xTF32, the depthwise in float32, against
    the plain version and the JAX kernel (Pallas interpret mode), float32,
    linear activations so that nothing clips the large inputs."""
    rng = np.random.default_rng(13)
    cin, e, cout = 160, 960, 320
    spec = invres.InvResSpec(7, 7, cin, e, cout, True, False, "linear", "linear", "linear")
    assert invres.kernel_takes(spec)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    ops = dict(w1=f(cin, e, scale=cin ** -0.5), s1=1 + f(e, scale=0.1), o1=f(e, scale=0.1),
               wd=f(9, e, scale=1 / 3), sd=1 + f(e, scale=0.1), od=f(e, scale=0.1),
               w2=f(e, cout, scale=e ** -0.5), s2=1 + f(cout, scale=0.1), o2=f(cout, scale=0.1))
    x = mag * f(1, 7, 7, cin)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    xt = torch.from_numpy(x)
    ev = matmul_3xtf32(xt.reshape(-1, cin), t["w1"]) * t["s1"] + t["o1"]
    dw = conv2d_nhwc_f32(ev.reshape(1, 7, 7, e), t["wd"].reshape(3, 3, 1, e), (1, 1, 1, 1),
                         groups=e)
    d = apply_activation(dw * t["sd"] + t["od"], "linear")
    got = (matmul_3xtf32(d.reshape(-1, e), t["w2"]) * t["s2"] + t["o2"]).reshape(1, 7, 7, cout)
    plain = invres.invres_block_reference(xt, t, spec)
    jspec = JSpec(h=7, w=7, cin=cin, e=e, cout=cout, has_expand=True, residual=False,
                  act_expand="linear", act_dw="linear", act_out="linear")
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    want = np.asarray(j_block(jnp.asarray(x), j["w1"], j["s1"], j["o1"], j["wd"], j["sd"],
                              j["od"], j["w2"], j["s2"], j["o2"], jspec, interpret=True))
    assert within(got.numpy(), plain.numpy()) and within(got.numpy(), want)


# -- The f32 forms of the chain (csrc/conv_chain.cu) and the implicit-GEMM conv
# (csrc/conv_igemm.cu): the producer-side split, and the largest K each gate
# admits.

def test_producer_split_gives_the_consumer_split_bits():
    """The chain's epilogue writes each value's TF32 hi and lo; a consumer
    splitting the value at its fragment load gets the same bits, and the
    parts split again are themselves (hi is TF32, lo is TF32): the product
    on the stored parts is bit for bit the product on the value."""
    rng = np.random.default_rng(21)
    y = torch.from_numpy((rng.standard_normal((2, 9, 11, 16)) * 10).astype(np.float32))
    hi, lo = tf32_split(y)
    assert torch.equal(tf32_split(hi)[0], hi) and not tf32_split(hi)[1].any()
    assert torch.equal(tf32_split(lo)[0], lo)
    w = torch.from_numpy(rng.standard_normal((3, 3, 16, 8)).astype(np.float32))
    stored = conv_3xtf32(hi, lo, w, 1, (1, 1, 1, 1))
    h2, l2 = tf32_split(y)
    assert torch.equal(stored, conv_3xtf32(h2, l2, w, 1, (1, 1, 1, 1)))


def _igemm_model(x, w, stride, pads):
    """csrc/conv_igemm.cu's f32 sums: per tap the a_hi b_hi products in an
    accumulator of their own, added into the f32 sums after the tap; the
    small passes (a_hi b_lo + a_lo b_hi) in a third sum over all of K,
    added at the epilogue."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    pt, pb, pl, pr = pads
    ho, wo = (h + pt + pb - kh) // stride + 1, (wd + pl + pr - kw) // stride + 1
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    w_hi, w_lo = tf32_split(w)
    acc = torch.zeros((n * ho * wo, o))
    small = torch.zeros((n * ho * wo, o))
    for dy in range(kh):
        for dx in range(kw):
            a = xp[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
            a_hi, a_lo = tf32_split(a.reshape(-1, c))
            acc = acc + a_hi @ w_hi[dy, dx]
            small = small + (a_hi @ w_lo[dy, dx] + a_lo @ w_hi[dy, dx])
    return (acc + small).reshape(n, ho, wo, o)


@pytest.mark.parametrize("mag", [1.0, 1e2], ids=["x~1", "x~1e2"])
@pytest.mark.parametrize("stride", [1, 2])
def test_igemm_f32_model_at_the_largest_k(mag, stride):
    """k8 c64 -> 128 (K = 4096, the implicit-GEMM gate's limit), strides 1
    and 2, asymmetric pads: the kernel's sums against float64 (a tenth of
    the tolerance), float32 and the JAX package's HIGHEST-precision conv."""
    rng = np.random.default_rng(31 + stride)
    k, c, o, pads = 8, 64, 128, (3, 4, 2, 5)
    x = (mag * rng.standard_normal((1, 11, 12, c))).astype(np.float32)
    w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
    got = _igemm_model(torch.from_numpy(x), torch.from_numpy(w), stride, pads).numpy()
    xd = F.pad(torch.from_numpy(x).double().permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]))
    f64 = F.conv2d(xd, torch.from_numpy(w).double().permute(3, 2, 0, 1), stride=stride)
    f64 = f64.permute(0, 2, 3, 1).numpy()
    plain = conv2d_nhwc_f32(torch.from_numpy(x), torch.from_numpy(w), pads, stride).numpy()
    highest = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        ((pads[0], pads[1]), (pads[2], pads[3])), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    assert got.shape == f64.shape
    assert within(got, f64, TOL_FP32 / 10) and within(got, plain)
    assert within(got, np.asarray(highest))


@pytest.mark.parametrize("k,c,o", [(9, 16, 32), (9, 32, 8)], ids=["k9c16o32", "k9c32o8"])
def test_chain_f32_model_at_the_largest_k(k, c, o):
    """The largest layers the chain's gate admits (K = 1296 and 2592), on
    an input split by its producer: the per-tap promoted 3xTF32 conv
    against float64 at |x| ~ 1e2 (a tenth of the tolerance) and the JAX
    package's HIGHEST-precision conv."""
    rng = np.random.default_rng(41 + c)
    pads = ((k - 1) // 2, k // 2, (k - 1) // 2, k // 2)
    x = (1e2 * rng.standard_normal((1, 10, 13, c))).astype(np.float32)
    w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x))
    got = conv_3xtf32(hi, lo, torch.from_numpy(w), 1, pads).numpy()
    f64 = conv2d_nhwc_f32(torch.from_numpy(x).double(), torch.from_numpy(w).double(), pads).numpy()
    highest = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((pads[0], pads[1]), (pads[2], pads[3])),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST)
    assert within(got, f64, TOL_FP32 / 10) and within(got, np.asarray(highest))
