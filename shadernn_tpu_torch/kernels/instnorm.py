"""InstanceNormalization of bfloat16 NHWC activations in two launches: the
hand-written CUDA kernels (csrc/instance_norm.cu), their wrapper and a
plain PyTorch version of their arithmetic.

The kernel replaces no TPU kernel: the JAX op (shadernn_tpu/ops/normalize.py)
is plain jnp, which XLA fuses; on the card the TORCH op's ATen passes over
float32 copies took most of StyleTransfer's step. It is bound by bytes: each
value is read twice and written once.

`instance_norm_stats_kernel` gives each (sample, chunk of `pixels` pixels)
a block of `threads` threads, 8 channels (16 bytes) a thread and `rows`
pixels a pass; each thread runs Welford's update over its pixels less the
sample's first pixel (exact for bfloat16 values, so that |mean| >> std
costs no precision), the block
merges its rows by Chan's formula in a fixed tree and writes the chunk's
means and M2s. `instance_norm_apply_kernel` merges a sample's chunks in a
fixed order in every block (row r of the block walks chunks r, r + rows,
..., then the same tree over the rows), then
normalises its chunk, applies gamma and beta in float32, rounds once to
bfloat16 and applies the activation. `launch_geometry` decides the grid
and C checks it. No atomics: two calls are bit-equal.

On a CUDA tensor `run` launches the kernels or raises; on the CPU it runs
`plain`, which repeats the kernels' arithmetic op by op (the same chunks,
rows, Welford steps and merge trees; each op rounded, none contracted).
ops/normalize.py decides which InstanceNormalization calls take it
(`kernel_route`). The launches count under `KERNELS["instance_norm"]`, both
kernels once a call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from shadernn_tpu_torch.kernels import count_launch
from shadernn_tpu_torch.kernels.chain import ACT_CODES

THREADS = 256  # at most, a block
BLOCKS_PER_SM = 2  # the grid: one wave of this many blocks an SM
MERGE_STEPS = 16  # chunk partials a thread of the apply kernel merges, at most
MAX_C = 1024
H100_SMS = 132  # the geometry `plain` models on the CPU


@dataclasses.dataclass(frozen=True)
class Geometry:
    threads: int  # a block: (C / 8) x rows
    rows: int  # pixels a pass of the block
    chunks: int  # blocks a sample
    pixels: int  # pixels a chunk (the last may hold fewer), a multiple of rows


def launch_geometry(n: int, hw: int, c: int, sms: int = H100_SMS) -> Geometry:
    """The grid of both launches for `n` samples of `hw` pixels of `c`
    channels: about BLOCKS_PER_SM blocks an SM, fewer where a thread of the
    apply kernel would merge more than MERGE_STEPS chunk partials or a chunk
    hold less than a pass."""
    vecs = c // 8
    threads = vecs * (THREADS // vecs)
    rows = threads // vecs
    chunks = max(1, min(-(-sms * BLOCKS_PER_SM // n), MERGE_STEPS * rows, -(-hw // rows)))
    pixels = -(-(-(-hw // chunks)) // rows) * rows
    return Geometry(threads, rows, -(-hw // pixels), pixels)


def refusal(x) -> Optional[str]:
    """Why the kernel does not take `x`, or None where it does: contiguous
    4-D NHWC bfloat16 on a CUDA device, 16-byte aligned, C a multiple of 8
    in [8, MAX_C], 1 <= N and 1 <= H * W < 2^24."""
    if x.device.type != "cuda":
        return f"device {x.device}"
    if x.dtype != torch.bfloat16:
        return f"dtype {x.dtype}"
    if x.dim() != 4:
        return f"shape {tuple(x.shape)}: not 4-D NHWC"
    n, h, w, c = x.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        return "a non-contiguous or unaligned input"
    if c % 8 or not 8 <= c <= MAX_C:
        return f"{c} channels: not a multiple of 8 in [8, {MAX_C}]"
    if n < 1 or not 1 <= h * w < 2 ** 24:
        return f"shape {tuple(x.shape)}: empty, or H * W of 2^24 or more"
    return None


def act_code(activation: str) -> Optional[int]:
    """The kernel's code of an activation (linear, relu, relu6, leaky relu:
    chain.py's ACT_CODES 0-3), None for one it does not apply."""
    code = ACT_CODES.get((activation or "linear").lower())
    return code if code is not None and code <= 3 else None


def _affine(t: Optional[torch.Tensor], x: torch.Tensor, name: str) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
            or t.numel() != x.shape[-1]):
        raise ValueError(f"instance norm {name}: {t.numel()} contiguous float32 values on "
                         f"{t.device}, want {x.shape[-1]} on {x.device}")
    return t


def run(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
        beta: Optional[torch.Tensor] = None, eps: float = 1e-5, activation: str = "linear",
        alpha: float = 0.3, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, C) -> act(((x - mean) * rsqrt(var + eps) * gamma + beta)
    rounded to x's dtype), gamma and beta float32 (C) or None; `stats`, where
    given, an (N, 2, C) float32 tensor that receives each channel's mean and
    variance. On the CPU `plain`; on a CUDA device the kernels or raises."""
    if x.device.type == "cpu":
        y, st = plain(x, gamma, beta, eps, activation, alpha)
        if stats is not None:
            stats.copy_(st)
        return y
    why = refusal(x)
    if why:
        raise ValueError(f"no instance-norm kernel for {why}")
    act = act_code(activation)
    if act is None:
        raise ValueError(f"no instance-norm kernel for activation {activation!r}")
    gamma, beta = _affine(gamma, x, "gamma"), _affine(beta, x, "beta")
    n, h, w, c = x.shape
    if stats is not None and (tuple(stats.shape) != (n, 2, c) or stats.dtype != torch.float32
                              or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"instance norm stats {tuple(stats.shape)} {stats.dtype}, "
                         f"want ({n}, 2, {c}) float32 on {x.device}")
    from shadernn_tpu_torch.kernels._build import kernel_lib, sm_count

    geo = launch_geometry(n, h * w, c, sm_count(x.device.index))
    part = torch.empty((n * geo.chunks, 2, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    lib = kernel_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.snn_instance_norm(x.data_ptr(), y.data_ptr(), part.data_ptr(), ptr(gamma),
                               ptr(beta), ptr(stats), n, h * w, c, geo.threads, geo.chunks,
                               geo.pixels, float(eps), act, float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"instance_norm launch failed ({rc}): "
                           f"{lib.snn_instance_norm_error(rc).decode()}")
    count_launch("instance_norm", 0)
    count_launch("instance_norm", 1)
    return y


def _half(cur: int) -> int:
    """pow2ceil(cur) / 2: the kernels' tree hands entries [half, cur) to
    [0, cur - half)."""
    return 1 << ((cur - 1).bit_length() - 1)


def chan(na, ma, m2a, nb, mb, m2b):
    """Chan's merge of (nb, mb, m2b) into (na, ma, m2a), float32 tensors
    (counts broadcast over channels), in the kernel's op order; an empty side
    takes the other as it is."""
    n = na + nb
    d = mb - ma
    f = nb / n
    mean = ma + d * f
    m2 = (m2a + m2b) + ((d * d) * na) * f
    keep, take = nb == 0, na == 0
    return (torch.where(keep, na, n),
            torch.where(keep, ma, torch.where(take, mb, mean)),
            torch.where(keep, m2a, torch.where(take, m2b, m2)))


def _tree(cnt, mean, m2, dim: int):
    """The kernels' fixed tree over `dim` of (cnt, mean, m2): entry 0 holds
    the merge of all."""
    def sel(t, lo, hi=None):
        return t[(slice(None),) * dim + (slice(lo, hi),)]

    cur = mean.shape[dim]
    while cur > 1:
        half = _half(cur)
        merged = chan(sel(cnt, 0, cur - half), sel(mean, 0, cur - half), sel(m2, 0, cur - half),
                      sel(cnt, half, cur), sel(mean, half, cur), sel(m2, half, cur))
        cnt, mean, m2 = (torch.cat([a, sel(t, cur - half)], dim)
                         for a, t in zip(merged, (cnt, mean, m2)))
        cur = half
    return (sel(t, 0, 1).squeeze(dim) for t in (cnt, mean, m2))


def plain(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
          beta: Optional[torch.Tensor] = None, eps: float = 1e-5, activation: str = "linear",
          alpha: float = 0.3, geometry: Optional[Geometry] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' arithmetic in PyTorch, on any device and for float32 or
    bfloat16 x (N, H, W, C): (y in x's dtype, the (N, 2, C) float32 means and
    variances). `geometry` defaults to `launch_geometry` on an H100."""
    from shadernn_tpu_torch.ops.common import apply_activation

    n, h, w, c = x.shape
    hw = h * w
    geo = geometry or launch_geometry(n, hw, c)
    rows, chunks, pixels = geo.rows, geo.chunks, geo.pixels
    f32 = dict(dtype=torch.float32, device=x.device)
    xf = x.reshape(n, hw, c).float()
    # 1. Each thread's Welford run: pixel start + r + k * rows of its chunk,
    # less the sample's first pixel.
    shift = xf[:, :1]
    xp = torch.zeros((n, chunks * pixels, c), **f32)
    xp[:, :hw] = xf - shift
    steps = pixels // rows
    xs = xp.view(n, chunks, steps, rows, c)
    valid = (torch.arange(chunks * pixels, device=x.device) < hw).view(chunks, steps, rows, 1)
    cnt = torch.zeros((1, chunks, rows, 1), **f32)
    mean = torch.zeros((n, chunks, rows, c), **f32)
    m2 = torch.zeros_like(mean)
    for k in range(steps):
        v, ok = xs[:, :, k], valid[:, k]
        cnt = cnt + ok
        rn = 1.0 / torch.where(ok, cnt, torch.ones_like(cnt))
        d = v - mean
        new_mean = mean + d * rn
        new_m2 = m2 + d * (v - new_mean)
        mean, m2 = torch.where(ok, new_mean, mean), torch.where(ok, new_m2, m2)
    # 2. The block's tree over its rows: the chunk's partial.
    cnt, mean, m2 = _tree(cnt, mean, m2, 2)
    # 3. Each block's merge of the chunks: row r walks chunks r, r + rows, ...,
    # then the tree over the rows.
    sub = rows
    counts = (torch.clamp((torch.arange(chunks, **f32) + 1) * pixels, max=hw)
              - torch.arange(chunks, **f32) * pixels).view(chunks, 1)
    na = torch.zeros((1, sub, 1), **f32)
    ma = torch.zeros((n, sub, c), **f32)
    m2a = torch.zeros_like(ma)
    for t in range(-(-chunks // sub)):
        ks = torch.arange(sub, device=x.device) + t * sub
        ok = (ks < chunks).view(1, sub, 1)
        kc = ks.clamp(max=chunks - 1)
        nb = torch.where(ok, counts[kc].view(1, sub, 1), torch.zeros_like(na))
        na, ma, m2a = chan(na, ma, m2a, nb, mean[:, kc], m2[:, kc])
    na, ma, m2a = _tree(na, ma, m2a, 1)
    ma = shift[:, 0] + ma
    var = m2a / na
    rstd = 1.0 / torch.sqrt(var + eps)
    # 4. The affine in float32, one rounding, the activation on the rounded value.
    y = (xf - ma[:, None]) * rstd[:, None]
    if gamma is not None:
        y = y * gamma.to(x.device, torch.float32).reshape(-1)
    if beta is not None:
        y = y + beta.to(x.device, torch.float32).reshape(-1)
    y = apply_activation(y.to(x.dtype), activation, alpha)
    return y.reshape(n, h, w, c), torch.stack([ma, var], 1)
