"""The bfloat16 InstanceNormalization kernel's CPU side
(kernels/instnorm.py, ops/normalize.py `kernel_route`).

The route rule: bfloat16 on a CUDA device, 4-D contiguous NHWC with C a
multiple of 8, and no gradient wanted, takes the kernel; everything else
keeps the ATen route, and a CPU run launches nothing. The plain version of
the kernels' arithmetic (each thread's Welford run over its pixels less the
sample's first pixel, Chan's merges in the kernels' fixed trees) against
the op's two-pass ATen route, the JAX op and float64: StyleTransfer's
three shapes at reduced H and W, an input whose mean is 1e3 times its std,
each activation the kernel applies, gamma and beta present and absent, and
the grids of an H100 and of a two-SM card (longer Welford runs). The launch
geometry at the style cell's shapes, pinned, and its coverage elsewhere.
The kernels themselves run in tests/test_torch_instnorm_card.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.ops import get_op as jget_op
from shadernn_tpu.ops.registry import RunCtx as JCtx

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.compile import OperandStore
from shadernn_tpu_torch.graph.ir import Node
from shadernn_tpu_torch.kernels import instnorm as K
from shadernn_tpu_torch.kernels import launch_counts
from shadernn_tpu_torch.ops import normalize
from shadernn_tpu_torch.ops.registry import RunCtx, get_op
from shadernn_tpu_torch.utils import timer

BF16 = torch.bfloat16
# StyleTransfer's three instance-norm shapes (512/256/128 at 32/64/128
# channels) at an eighth of H and W, b2.
SHAPES = {"c32": (2, 64, 64, 32), "c64": (2, 32, 32, 64), "c128": (2, 16, 16, 128)}
ACTS = ("linear", "relu", "relu6", "leaky_relu")
# The grid on an H100, and on a card of 2 SMs: chunks of more pixels, so
# each thread's Welford run takes several steps.
SMS = (132, 2)


@pytest.fixture(autouse=True)
def clean_recorder():
    timer.reset()
    try:
        yield
    finally:
        timer.reset()


def inputs(shape, seed, offset=False):
    g = np.random.default_rng(seed)
    c = shape[-1]
    if offset:  # mean 1e3 x std
        x = 1000.0 + g.standard_normal(shape)
    else:
        x = g.standard_normal(shape) * 1.5 + g.standard_normal(c) * 0.5
    return (x.astype(np.float32), (g.standard_normal(c) * 0.5 + 1).astype(np.float32),
            (g.standard_normal(c) * 0.3).astype(np.float32))


def node(gamma=None, beta=None, act="linear"):
    params = {k: v for k, v in (("gamma", gamma), ("beta", beta)) if v is not None}
    return Node("in", "InstanceNormalization", ["x"], {"epsilon": 1e-5, "activation": act}, params)


def aten_route(x, gamma, beta, act="linear"):
    """The op's ATen route (the kernel route declined)."""
    return get_op("InstanceNormalization").run(node(gamma, beta, act), [x], RunCtx())


def jax_op(x, gamma, beta, act="linear"):
    params = {k: v for k, v in (("gamma", gamma), ("beta", beta)) if v is not None}
    jn = JNode("in", "InstanceNormalization", ["x"], {"epsilon": 1e-5, "activation": act}, params)
    return np.asarray(jget_op("InstanceNormalization").run(jn, [jnp.asarray(x)], JCtx()),
                      np.float32)


def float64_norm(x, gamma, beta):
    x64 = torch.as_tensor(x, dtype=torch.float64)
    mean = x64.mean((1, 2), keepdim=True)
    var = x64.var((1, 2), unbiased=False, keepdim=True)
    y = (x64 - mean) / torch.sqrt(var + 1e-5)
    if gamma is not None:
        y = y * torch.as_tensor(gamma, dtype=torch.float64)
    if beta is not None:
        y = y + torch.as_tensor(beta, dtype=torch.float64)
    return y, mean.flatten(1), var.flatten(1)


# --- the route ------------------------------------------------------------------

class Stub:
    """What `kernel_route` reads of a tensor, with the device a test names."""

    def __init__(self, shape=(2, 8, 8, 32), dtype=BF16, device="cuda", contiguous=True,
                 requires_grad=False, ptr=0):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)
        self.requires_grad, self._contiguous, self._ptr = requires_grad, contiguous, ptr

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


RULE = {
    "bf16_cuda": (dict(), True),
    "bf16_cuda1_c128": (dict(device="cuda:1", shape=(4, 16, 16, 128)), True),
    "bf16_cuda_c1024": (dict(shape=(1, 4, 4, 1024)), True),
    "f32_cuda": (dict(dtype=torch.float32), False),
    "f16_cuda": (dict(dtype=torch.float16), False),
    "bf16_cpu": (dict(device="cpu"), False),
    "autograd_input": (dict(requires_grad=True), False),
    "non_contiguous": (dict(contiguous=False), False),
    "unaligned": (dict(ptr=8), False),
    "c12": (dict(shape=(2, 8, 8, 12)), False),
    "c2048": (dict(shape=(1, 4, 4, 2048)), False),
    "3d": (dict(shape=(8, 8, 32)), False),
    "empty": (dict(shape=(0, 8, 8, 32)), False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_the_route(case):
    kw, want = RULE[case]
    assert normalize.kernel_route(Stub(**kw)) is want


def test_an_autograd_input_takes_the_kernel_where_no_gradient_is_wanted():
    x = Stub(requires_grad=True)
    assert not normalize.kernel_route(x)
    with torch.no_grad():
        assert normalize.kernel_route(x)


@pytest.mark.parametrize("precision", ["BF16", "FP32"])
def test_a_cpu_run_launches_nothing(precision):
    from shadernn_tpu_torch.models import zoo

    eng = P.Engine.from_json(zoo.STYLE512_TRAINED["candy"],
                             P.EngineOptions(precision=getattr(P.Precision, precision),
                                             batch_size=1, device="cpu"), input_hw=(32, 32))
    x = np.random.default_rng(1).random((1, 32, 32, 3), dtype=np.float32)
    y = eng.run_single(x)
    assert torch.isfinite(torch.as_tensor(np.asarray(y, np.float32))).all()
    assert launch_counts("kernel").get("instance_norm_stats_kernel", 0) == 0
    assert launch_counts()["instance_norm"] == 0


def test_the_wrapper_raises_on_a_cuda_input_it_does_not_take():
    with pytest.raises(ValueError, match="dtype"):
        K.run(Stub(dtype=torch.float32))
    with pytest.raises(ValueError, match="channels"):
        K.run(Stub(shape=(2, 8, 8, 12)))
    with pytest.raises(ValueError, match="non-contiguous"):
        K.run(Stub(contiguous=False))


# --- the plain version's arithmetic ---------------------------------------------

@pytest.mark.parametrize("affine", ["affine", "no_affine"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_against_the_aten_route_and_the_jax_op(shape, act, affine):
    x, gamma, beta = inputs(SHAPES[shape], seed=3)
    if affine == "no_affine":
        gamma = beta = None
    got, stats = K.plain(torch.from_numpy(x), None if gamma is None else torch.from_numpy(gamma),
                         None if beta is None else torch.from_numpy(beta), 1e-5, act, 0.3)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPES[shape]
    want = aten_route(torch.from_numpy(x), gamma, beta, act).numpy()
    # float32 statistics summed in other orders: the means agree to ~1e-7 of
    # their size, the variances to ~3e-7 (below), so y = (x - mean) * rstd *
    # gamma + beta, |y| <= ~10 here, within 1e-5 absolute and relative.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jax_op(x, gamma, beta, act), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", ["centred", "offset"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_statistics_against_float64(shape, sms, offset):
    x, gamma, beta = inputs(SHAPES[shape], seed=5, offset=offset == "offset")
    n, h, w, c = x.shape
    geo = K.launch_geometry(n, h * w, c, sms)
    got, stats = K.plain(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                         geometry=geo)
    y64, mean64, var64 = float64_norm(x, gamma, beta)
    # The mean within 1e-6 of its size and the std; the variance within 1e-6
    # relative: f32 Welford runs over exact shifted values and Chan's merges
    # (about 2e-7 seen), where f32 sum and sum of squares reads the offset
    # input's variance 20-50% off.
    mean, var = stats[:, 0].double(), stats[:, 1].double()
    assert ((mean - mean64).abs() <= 1e-6 * (mean64.abs() + var64.sqrt())).all()
    assert ((var - var64).abs() <= 1e-6 * var64).all()
    xf = torch.from_numpy(x)
    naive = (xf * xf).mean((1, 2)) - xf.mean((1, 2)) ** 2
    naive_off = ((naive.double() - var64).abs() / var64).max().item()
    assert naive_off > 0.05 if offset == "offset" else naive_off < 1e-4
    # y against float64: float32's rounding of the mean (half an ulp of
    # |mean|) carried through rstd and gamma, and a few ulps of |y|.
    slack = (2.0 ** -24 * mean64.abs() / torch.sqrt(var64 + 1e-5))[:, None, None, :] * (
        torch.as_tensor(gamma, dtype=torch.float64).abs())
    assert ((got.double() - y64).abs() <= 2 * slack + 1e-6 * (1 + y64.abs())).all()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_in_bf16_within_one_ulp_of_the_aten_route(shape, act):
    x, gamma, beta = inputs(SHAPES[shape], seed=7)
    xb = torch.from_numpy(x).to(BF16)
    got, _ = K.plain(xb, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5, act, 0.1)
    want = get_op("InstanceNormalization").run(
        Node("in", "InstanceNormalization", ["x"],
             {"epsilon": 1e-5, "activation": act, "leaky_alpha": 0.1},
             {"gamma": gamma, "beta": beta}), [xb], RunCtx())
    assert got.dtype == BF16
    g, r = got.float(), want.float()
    # One rounding to bfloat16 of float32 values that differ by ~1e-6: the
    # two round apart only across a tie, by one ulp (8 significant bits).
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()).clamp_min(torch.finfo(BF16).tiny))
    assert ((g - r).abs() <= torch.ldexp(torch.ones_like(g), e - 8) + 1e-5).all()
    assert (g != r).float().mean().item() < 1e-3


def test_run_on_the_cpu_is_the_plain_version_and_fills_the_statistics():
    x, gamma, beta = inputs((2, 8, 12, 16), seed=9)
    xt, gt, bt = (torch.from_numpy(a) for a in (x, gamma, beta))
    stats = torch.empty((2, 2, 16))
    y = K.run(xt, gt, bt, 1e-5, "relu", 0.3, stats=stats)
    want, want_stats = K.plain(xt, gt, bt, 1e-5, "relu", 0.3)
    assert torch.equal(y, want) and torch.equal(stats, want_stats)


ODD = {"c24_7x5": (1, 7, 5, 24), "c1024_9x11": (3, 9, 11, 1024), "c256_13x3": (2, 13, 3, 256),
       "c8_1x1": (2, 1, 1, 8)}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", sorted(ODD))
def test_plain_at_odd_widths_and_sizes(shape, sms):
    """Rows that do not fill a power of two, chunks of one row, C above a
    block's threads, a single pixel (variance 0)."""
    x, gamma, beta = inputs(ODD[shape], seed=11)
    n, h, w, c = x.shape
    got, stats = K.plain(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                         geometry=K.launch_geometry(n, h * w, c, sms))
    want = aten_route(torch.from_numpy(x), gamma, beta).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --- the launch geometry --------------------------------------------------------

# StyleTransfer 512 b4's three shapes on an H100: (threads, rows, chunks, pixels).
PINNED = {(4, 512 * 512, 32): (256, 64, 66, 4032), (4, 256 * 256, 64): (256, 32, 64, 1024),
          (4, 128 * 128, 128): (256, 16, 64, 256)}
GRIDS = [(4, 512 * 512, 32), (4, 256 * 256, 64), (4, 128 * 128, 128), (1, 35, 24), (3, 99, 1024),
         (1, 1, 8), (16, 4096, 256), (1, 2 ** 24 - 1, 8), (64, 49, 512)]


@pytest.mark.parametrize("key", sorted(PINNED))
def test_the_style_cells_grids(key):
    assert tuple(vars(K.launch_geometry(*key)).values()) == PINNED[key]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("grid", GRIDS)
def test_the_grid_covers_each_pixel_once_within_the_kernels_limits(grid, sms):
    n, hw, c = grid
    geo = K.launch_geometry(n, hw, c, sms)
    vecs = c // 8
    assert geo.threads == vecs * (K.THREADS // vecs) <= K.THREADS and geo.rows * vecs == geo.threads
    assert geo.pixels % geo.rows == 0 and geo.pixels >= geo.rows
    assert (geo.chunks - 1) * geo.pixels < hw <= geo.chunks * geo.pixels  # as C checks
    assert -(-geo.chunks // geo.rows) <= K.MERGE_STEPS
    assert n * geo.chunks <= max(n, sms * K.BLOCKS_PER_SM + n)


# --- the op's kernel branch, on the CPU -----------------------------------------

@pytest.mark.parametrize("act", ["relu", "linear", "tanh"])
def test_the_ops_kernel_branch(act, monkeypatch):
    """With the route held true, as for bfloat16 on a card: the op calls the
    wrapper (on the CPU, the plain version) with the activation where the
    kernel has it and applies any other after it, and makes gamma and beta
    once per parameter set through the engine's cache."""
    x, gamma, beta = inputs((2, 16, 16, 32), seed=13)
    xb = torch.from_numpy(x).to(BF16)
    calls, real = [], K.run

    def spy(*args, **kw):
        calls.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(normalize, "kernel_route", lambda x: True)
    monkeypatch.setattr(K, "run", spy)
    store = OperandStore()
    ctx = RunCtx(cache=functools.partial(store.get, "in"))
    nd = node(torch.from_numpy(gamma), torch.from_numpy(beta), act)
    outs = [get_op("InstanceNormalization").run(nd, [xb], ctx) for _ in range(2)]
    assert calls == [act if act != "tanh" else "linear"] * 2
    assert timer.counters().get("engine.operand_prepares", 0) == 1
    assert torch.equal(outs[0], outs[1]) and outs[0].dtype == BF16
    monkeypatch.setattr(normalize, "kernel_route", lambda x: False)
    want = get_op("InstanceNormalization").run(nd, [xb], RunCtx())
    diff = (outs[0].float() - want.float()).abs()
    assert diff.max().item() <= 2 ** -7 * max(1.0, want.float().abs().max().item())
    assert len(calls) == 2  # the ATen route called no kernel
