"""Color formats and conversions (a numpy copy of shadernn_tpu/image/color.py).

Counterpart of the reference's color system (core/inc/snn/color.h:22-40
ColorFormat + ColorFormatDesc table) and its CPU converters
(core/src/image.cpp:369-791 toRgba32f/toR32f/..., libyuv NV12/NV21
paths). Host-side conversions are numpy; the on-device versions live in
image/ingest.py so frames stay on the card.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ColorFormat(enum.Enum):
    """Mirror of snn::ColorFormat (color.h:22-40), minus GL-specific
    compressed formats."""

    NONE = "none"
    RGBA32F = "rgba32f"
    RGB32F = "rgb32f"
    RGBA16F = "rgba16f"
    R32F = "r32f"
    RGBA8 = "rgba8"
    RGB8 = "rgb8"
    SRGB8 = "srgb8"
    SRGB8_A8 = "srgb8_a8"
    R8 = "r8"
    RG8 = "rg8"
    NV12 = "nv12"
    NV21 = "nv21"


@dataclasses.dataclass(frozen=True)
class ColorFormatDesc:
    """Per-format layout description (color.h ColorFormatDesc analog)."""

    channels: int
    bytes_per_pixel: float  # fractional for subsampled YUV
    dtype: object
    planar: bool = False


FORMAT_DESC = {
    ColorFormat.RGBA32F: ColorFormatDesc(4, 16, np.float32),
    ColorFormat.RGB32F: ColorFormatDesc(3, 12, np.float32),
    ColorFormat.RGBA16F: ColorFormatDesc(4, 8, np.float16),
    ColorFormat.R32F: ColorFormatDesc(1, 4, np.float32),
    ColorFormat.RGBA8: ColorFormatDesc(4, 4, np.uint8),
    ColorFormat.RGB8: ColorFormatDesc(3, 3, np.uint8),
    ColorFormat.SRGB8: ColorFormatDesc(3, 3, np.uint8),
    ColorFormat.SRGB8_A8: ColorFormatDesc(4, 4, np.uint8),
    ColorFormat.R8: ColorFormatDesc(1, 1, np.uint8),
    ColorFormat.RG8: ColorFormatDesc(2, 2, np.uint8),
    ColorFormat.NV12: ColorFormatDesc(3, 1.5, np.uint8, planar=True),
    ColorFormat.NV21: ColorFormatDesc(3, 1.5, np.uint8, planar=True),
}

# BT.601 limited-range YUV->RGB coefficients (what libyuv NV12ToRGB uses).
_YUV_M = np.array(
    [[1.164, 0.0, 1.596], [1.164, -0.392, -0.813], [1.164, 2.017, 0.0]],
    np.float32,
)


def nv12_to_rgb(data: np.ndarray, height: int, width: int, nv21: bool = False) -> np.ndarray:
    """Decode an NV12/NV21 byte buffer (Y plane + interleaved UV half-res
    plane) to HxWx3 uint8 RGB. Reference analog: libyuv conversion used by
    the Android camera path (demo upload2GpuProcessor)."""
    data = np.asarray(data, np.uint8).reshape(-1)
    y = data[: height * width].reshape(height, width).astype(np.float32)
    uv = data[height * width : height * width + (height // 2) * (width // 2) * 2]
    uv = uv.reshape(height // 2, width // 2, 2).astype(np.float32)
    if nv21:
        u, v = uv[..., 1], uv[..., 0]
    else:
        u, v = uv[..., 0], uv[..., 1]
    u = np.repeat(np.repeat(u, 2, 0), 2, 1)[:height, :width]
    v = np.repeat(np.repeat(v, 2, 0), 2, 1)[:height, :width]
    yuv = np.stack([y - 16.0, u - 128.0, v - 128.0], axis=-1)
    rgb = yuv @ _YUV_M.T
    return np.clip(rgb, 0, 255).astype(np.uint8)


def rgb_to_y(rgb: np.ndarray) -> np.ndarray:
    """RGB -> BT.601 luma channel (the ESPCN/denoise models run on Y —
    demo/modelInferenceESPCN.py preprocessImage)."""
    rgb = np.asarray(rgb, np.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def convert(pixels: np.ndarray, src: ColorFormat, dst: ColorFormat) -> np.ndarray:
    """Host-side format conversion (image.cpp toRgba32f family)."""
    if src == dst:
        return pixels
    f32 = _to_float(pixels, src)
    return _from_float(f32, dst)


def _to_float(p: np.ndarray, fmt: ColorFormat) -> np.ndarray:
    d = FORMAT_DESC[fmt]
    if d.dtype == np.uint8:
        return p.astype(np.float32) / 255.0
    return p.astype(np.float32)


def _from_float(p: np.ndarray, fmt: ColorFormat) -> np.ndarray:
    d = FORMAT_DESC[fmt]
    c = d.channels
    cur = p.shape[-1] if p.ndim == 3 else 1
    if p.ndim == 2:
        p = p[..., None]
    if cur < c:  # broaden: grey->rgb(a), rgb->rgba (alpha=1)
        reps = [p[..., min(i, cur - 1)] for i in range(min(c, 3))]
        while len(reps) < c:
            reps.append(np.ones_like(p[..., 0]))
        p = np.stack(reps, axis=-1)
    elif cur > c:
        p = p[..., :c]
    if d.dtype == np.uint8:
        return np.clip(p * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return p.astype(d.dtype)
