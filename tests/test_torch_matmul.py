"""The port's fused-matmul module (shadernn_tpu_torch.kernels.matmul)
against the JAX package's `fused_matmul` in Pallas interpret mode, and the
Dense op's KERNEL branch. On the CPU the port's entry point runs the
kernel's plain version; the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py.

The JAX kernel is the reference for the elementwise activations only: its
softmax counts the padded columns of its 128-wide tile (pinned below), so
the port's softmax is held against torch.softmax of the logits.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadernn_tpu.kernels.matmul_pallas import fused_matmul as j_fused_matmul

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.kernels import matmul, launch_counts
from shadernn_tpu_torch.ops import get_op as p_op
from shadernn_tpu_torch.ops.registry import RunCtx as PCtx

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


# (m, k, n, activation, int8 weights)
CASES = [
    (37, 100, 23, "sigmoid", False),   # ragged on every axis
    (8, 512, 10, "linear", False),     # ResNet18's fc, logits
    (5, 130, 129, "relu", False),      # one column past the JAX tile
    (4, 600, 12, "leaky_relu", False),  # two K tiles of the JAX kernel
    (9, 64, 40, "relu", True),
    (3, 100, 7, "tanh", True),
]


def operands(rng, m, k, n, int8):
    x = rng.standard_normal((m, k)).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        scale = (0.02 / np.sqrt(k) * (1 + 0.1 * rng.standard_normal(n))).astype(np.float32)
    else:
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        scale = (rng.random(n) + 0.5).astype(np.float32)
    return x, w, scale, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}_{c[3]}" + ("_int8" if c[4] else ""))
def test_reference_matches_jax_kernel(rng, case, prec):
    m, k, n, act, int8 = case
    x, w, scale, offset = operands(rng, m, k, n, int8)
    tdt, jdt = DTYPES[prec]
    want = np.asarray(j_fused_matmul(
        jnp.asarray(x, jdt), jnp.asarray(w) if int8 else jnp.asarray(w, jdt),
        jnp.asarray(scale), jnp.asarray(offset), activation=act, interpret=True), np.float32)
    before = launch_counts()
    got = matmul.fused_matmul(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w) if int8 else torch.from_numpy(w).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(offset), activation=act)
    assert launch_counts() == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (m, n)
    tol = TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def test_softmax_is_over_the_true_columns_unlike_the_jax_kernel(rng):
    """The JAX kernel pads N = 10 to its 128-column tile and takes the
    softmax of the padded tile, so the 118 padded columns enter as exp(0)
    and its rows do not sum to 1 (the argmax is unchanged, which is why the
    accuracy tests pass). The port's softmax is over the 10 true columns."""
    x, w, scale, offset = operands(rng, 8, 128, 10, False)
    jax_out = np.asarray(j_fused_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(offset),
        activation="softmax", interpret=True))
    logits = (torch.from_numpy(x) @ torch.from_numpy(w)) * torch.from_numpy(scale) \
        + torch.from_numpy(offset)
    want = torch.softmax(logits, dim=-1).numpy()
    got = matmul.fused_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
                              torch.from_numpy(offset), activation="softmax").numpy()
    assert np.all(jax_out.sum(-1) < 0.9)
    assert np.max(np.abs(jax_out - want)) > 0.1
    np.testing.assert_array_equal(jax_out.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("prec", list(TOL))
def test_softmax_over_many_columns(rng, prec):
    """1000 columns (MobileNetV2's head): eight 128-column tiles in the JAX
    kernel, one softmax per row here."""
    x, w, scale, offset = operands(rng, 8, 96, 1000, False)
    tdt = DTYPES[prec][0]
    got = matmul.fused_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                              torch.from_numpy(scale), torch.from_numpy(offset),
                              activation="softmax")
    logits = (torch.from_numpy(x).to(tdt).float() @ torch.from_numpy(w).to(tdt).float()) \
        * torch.from_numpy(scale) + torch.from_numpy(offset)
    assert got.dtype == tdt
    assert torch.allclose(got.float().sum(-1), torch.ones(8), atol=1e-5 if prec == "fp32" else 1e-2)
    assert (got.float() - torch.softmax(logits, -1)).abs().max().item() <= TOL[prec] * 1e-2


def test_gate_and_entry_point():
    assert matmul.matmul_supported("softmax") and matmul.matmul_supported("gelu")
    assert matmul.matmul_supported(None) and not matmul.matmul_supported("hard_swish")
    node = PNode("fc", "Dense", ["x"], dict(units=3, activation="relu"),
                 {"weight": torch.zeros(4, 3)})
    assert matmul.dense_supported(node)
    node.params["weight_q"] = torch.zeros(4, 3, dtype=torch.int8)
    assert matmul.dense_supported(node)  # int8 storage is taken
    del node.params["weight"]
    assert matmul.dense_supported(node)
    node.attrs["activation"] = "hard_swish"
    assert not matmul.dense_supported(node)
    s = torch.ones(3)
    with pytest.raises(ValueError):
        matmul.fused_matmul(torch.zeros((2, 4), device="meta"), torch.zeros(4, 3), s, s)


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("act", ["softmax", "relu"])
def test_dense_on_the_kernel_backend_matches_torch(rng, act, prec):
    """Dense.run honours KERNEL: it flattens, folds the bias into the
    float32 epilogue and calls fused_matmul; the result matches the TORCH
    body, which adds the bias after rounding."""
    tdt = DTYPES[prec][0]
    params = {"weight": torch.from_numpy((rng.standard_normal((24, 7)) / 4).astype(np.float32)),
              "bias": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}
    node = PNode("fc", "Dense", ["x"], dict(units=7, activation=act, use_bias=True), params)
    x = torch.from_numpy(rng.standard_normal((3, 2, 2, 6)).astype(np.float32)).to(tdt)
    calls = []
    real = matmul.fused_matmul

    def counted(*a, **kw):
        calls.append(kw["activation"])
        return real(*a, **kw)

    matmul.fused_matmul = counted
    try:
        got = p_op("Dense").run(node, [x], PCtx(backend=P.BackendKind.KERNEL))
        want = p_op("Dense").run(node, [x], PCtx(backend=P.BackendKind.TORCH))
    finally:
        matmul.fused_matmul = real
    assert calls == [act]
    assert got.dtype == want.dtype == tdt and tuple(got.shape) == (3, 7)
    assert (got.float() - want.float()).abs().max().item() <= TOL[prec] * max(
        1.0, want.float().abs().max().item())


def _holds(geo, m, k, n, bf16):
    """csrc/matmul_fused.cu's checks of the launch geometry."""
    esz = 2 if bf16 else 4
    assert geo.bn in (16, 32, 64) and geo.bk % 16 == 0 and geo.split in (1, 2, 4, 8)
    if bf16:
        assert 16 <= geo.mb <= 64 and geo.mb % 16 == 0
    else:
        assert 1 <= geo.mb <= 16 and matmul.THREADS % geo.bn == 0
    assert geo.xstride >= geo.bk and geo.wstride >= geo.bn
    assert (geo.xstride * esz) % 16 == 0 and (geo.wstride * esz) % 16 == 0
    groups = 64 // geo.bn if bf16 else matmul.THREADS // geo.bn
    ends = [(geo.xs_off, geo.xs_off + 2 * geo.mb * geo.xstride * esz),
            (geo.ws_off, geo.ws_off + 2 * geo.bk * geo.wstride * esz),
            (geo.red_off, geo.red_off + 4 * groups * geo.mb * geo.bn),
            (geo.part_off, geo.part_off + 4 * geo.mb * geo.bn),
            (geo.so_off, geo.so_off + 8 * geo.bn)]
    prev = 0
    for lo, hi in ends:
        assert lo % 16 == 0 and lo >= prev
        prev = hi
    assert prev <= geo.smem <= matmul.MAX_SMEM_BYTES


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (8, 512, 10), (64, 128, 10), (8, 1280, 1000), (1, 300, 7), (5, 77, 1001),
    (9, 1, 40), (33, 70, 130), (130, 1500, 2100), (1, 1500, 2100), (130, 1, 7), (65, 700, 64),
    (17, 33, 1001), (16, 16, 16), (100, 1024, 33),
])
def test_geometry_covers_every_output_once(m, k, n, bf16):
    """M 1-130, K 1-1500, N 1-2100, at the chosen split and at every other:
    the grid's row and column blocks hold each (row, column) once, the
    cluster's ranks cut K into disjoint ranges that cover it, the layout
    holds its buffers within 227 KB, and a softmax whose row spans several
    column blocks (N = 2100: 33 of them) is the one that takes the scratch."""
    chosen = matmul.launch_geometry(m, k, n, bf16, 132)
    for split in sorted({chosen.split, 1, 2, 4, 8}):
        geo = matmul.launch_geometry(m, k, n, bf16, 132, split)
        _holds(geo, m, k, n, bf16)
        cols, rows = geo.blocks(m, n)
        hits = np.zeros((m, n), np.int32)
        for rb in range(rows):
            for cb in range(cols):
                hits[rb * geo.mb:(rb + 1) * geo.mb, cb * geo.bn:(cb + 1) * geo.bn] += 1
        assert (hits == 1).all()
        covered = np.zeros(k, np.int32)
        for lo, hi in geo.k_ranges(k):
            assert 0 <= lo <= hi <= k and (lo % 16 == 0 or lo == k)
            covered[lo:hi] += 1
        assert (covered == 1).all()
        assert (cols > 1) == (n > geo.bn)
    cols, rows = chosen.blocks(m, n)
    assert chosen.split == 1 or (cols * rows * chosen.split // 2 < 132
                                 and (chosen.split // 2) * chosen.bk < k)


@pytest.mark.parametrize("act", ["relu", "linear"])
def test_int8_dense_on_the_kernel_matches_jax(rng, act):
    """A quantized Dense (weight_q, weight_scale, no float weight) under
    KERNEL at bf16: the gate takes it, folded_operands hands the fused
    matmul the int8 W with the scale folded in; against the JAX op under
    PALLAS (fused_matmul in interpret mode; no softmax: C3)."""
    from shadernn_tpu.graph.ir import Node as JNode
    from shadernn_tpu.ops.registry import RunCtx as JCtx
    from shadernn_tpu.ops.registry import get_op as j_op
    from shadernn_tpu.quant.quantize import quantize_weight

    import shadernn_tpu as J

    wq, ws = quantize_weight((rng.standard_normal((96, 10)) / 10).astype(np.float32))
    params = {"weight_q": wq, "weight_scale": ws,
              "bias": (rng.standard_normal(10) * 0.1).astype(np.float32)}
    attrs = dict(units=10, activation=act, use_bias=True)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    want = np.asarray(j_op("Dense").run(
        JNode("fc", "Dense", ["x"], attrs, {k: jnp.asarray(v) for k, v in params.items()}),
        [jnp.asarray(x, jnp.bfloat16)], JCtx(backend=J.BackendKind.PALLAS)), np.float32)
    node = PNode("fc", "Dense", ["x"], attrs, {k: torch.from_numpy(v) for k, v in params.items()})
    assert matmul.dense_supported(node)
    got = p_op("Dense").run(node, [torch.from_numpy(x).to(torch.bfloat16)],
                            PCtx(backend=P.BackendKind.KERNEL))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.max(np.abs(got.float().numpy() - want)) <= 0.1 * max(1.0, float(np.abs(want).max()))
