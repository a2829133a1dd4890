"""On-device frame ingest (counterpart of shadernn_tpu/image/ingest.py).

The reference keeps camera frames on the GPU from capture to inference
(README.md:11, imageTexture.h attach/upload). Here raw uint8 frames are
copied to the card once, and all preprocessing (dtype conversion, YUV to
RGB, normalization, resize) runs there on the tensors' own device, in the
same stream as the model that consumes them: no host round trip between
ingest and inference. These are plain PyTorch ops, as the JAX package
leaves them to XLA; a fused ingest kernel is speed work (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from shadernn_tpu_torch.utils import timer

# BT.601 limited-range YUV -> RGB (matches image/color.py host version).
_YUV_M = ((1.164, 0.0, 1.596), (1.164, -0.392, -0.813), (1.164, 2.017, 0.0))


def _const(values, device) -> torch.Tensor:
    """A small float32 constant on `device`. On the card it is copied from
    pinned memory without waiting: a copy from pageable memory may wait
    for every step queued on the stream before it, and so serialize a
    pipeline of batches. Counted in `ingest.consts`."""
    timer.count("ingest.consts")
    t = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def nv12_to_rgb_device(y_plane, uv_plane, nv21: bool = False) -> torch.Tensor:
    """(N,H,W) uint8 Y + (N,H/2,W/2,2) uint8 UV -> (N,H,W,3) float32 RGB in
    [0,255], on the planes' device."""
    y_plane, uv_plane = torch.as_tensor(y_plane), torch.as_tensor(uv_plane)
    y = y_plane.float() - 16.0
    uv = uv_plane.float() - 128.0
    u = uv[..., 1] if nv21 else uv[..., 0]
    v = uv[..., 0] if nv21 else uv[..., 1]
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yuv = torch.stack([y, u, v], dim=-1)
    m = _const(_YUV_M, yuv.device)
    return torch.clamp(yuv @ m.T, 0.0, 255.0)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """The nearest source index of each of n outputs from m inputs, as
    jax.image.resize defines it: floor((i + 0.5) * m / n), here in exact
    integer arithmetic. (JAX computes the quotient in float32; on the CPU
    its division can land an ulp under an exact integer quotient and take
    the pixel before it there.)"""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return torch.div((2 * i + 1) * m, 2 * n, rounding_mode="floor")


def ingest_frames(
    frames,  # (N, H, W, C) uint8 (or float)
    target_hw: Optional[Tuple[int, int]] = None,
    means: Tuple[float, ...] = (0.0,),
    norms: Tuple[float, ...] = (1 / 255.0,),
    dtype_name: str = "bfloat16",
    resize_method: str = "linear",
) -> torch.Tensor:
    """uint8 frames -> normalized NHWC model input, on the frames' device.

    means/norms follow RawImage::normalize: y = (x - mean) * norm, per
    channel, repeated over the channels. A resize to `target_hw` follows
    jax.image.resize: "linear" is its antialiased bilinear (a triangle
    kernel widened by the scale when downsampling), anything else its
    nearest. Its host time is the span `snn.ingest`."""
    if not timer.tracing():
        return _ingest(frames, target_hw, means, norms, dtype_name, resize_method)
    with timer.span("snn.ingest"):
        return _ingest(frames, target_hw, means, norms, dtype_name, resize_method)


def _ingest(frames, target_hw, means, norms, dtype_name, resize_method) -> torch.Tensor:
    x = torch.as_tensor(frames).float()
    c = x.shape[-1]
    mean = _const((list(means) * c)[:c], x.device)
    norm = _const((list(norms) * c)[:c], x.device)
    x = (x - mean) * norm
    if target_hw is not None and tuple(target_hw) != tuple(x.shape[1:3]):
        h, w = (int(v) for v in target_hw)
        if resize_method == "nearest":
            x = x.index_select(1, _nearest_index(x.shape[1], h, x.device))
            x = x.index_select(2, _nearest_index(x.shape[2], w, x.device))
        else:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return x.to(getattr(torch, dtype_name)).contiguous()


def make_ingest_fn(
    engine,
    means: Sequence[float] = (0.0,),
    norms: Sequence[float] = (1 / 255.0,),
    resize_from: Optional[Tuple[int, int]] = None,
):
    """(uint8 frames) -> model outputs: the frames go to the engine's device
    (no copy if they are there already), are ingested there and run through
    `engine.model`, with no host round trip in between. With `resize_from`
    the frames are resized to the engine's input size."""
    graph = engine.graph
    (in_name,) = graph.input_names
    spec = graph.nodes[in_name].out_spec
    target_hw = (spec.h, spec.w) if resize_from else None
    device = engine.model.device

    def step(raw_frames):
        raw = torch.as_tensor(raw_frames).to(device, non_blocking=True)
        x = ingest_frames(raw, target_hw=target_hw, means=tuple(means), norms=tuple(norms),
                          dtype_name="float32")
        return engine.model({in_name: x})

    return step
