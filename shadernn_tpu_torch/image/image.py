"""CPU-side image container and file I/O (a copy of
shadernn_tpu/image/image.py).

Counterpart of the reference's RawImage/ManagedRawImage
(core/inc/snn/image.h:492,624) and its loaders/savers
(core/src/image.cpp:149-246 loadFromFile/saveToPNG/saveToBIN). Numpy-backed
HWC storage; PNG/JPEG via PIL; the reference's raw `.BIN` dump format is a
bare float32 stream (matching its texture dumps consumed by
tools/misc/readTextureDump.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from shadernn_tpu_torch.image.color import ColorFormat, FORMAT_DESC, convert, rgb_to_y


@dataclasses.dataclass
class Image:
    """HWC image with explicit color format."""

    pixels: np.ndarray  # (H, W, C)
    format: ColorFormat = ColorFormat.RGBA8

    def __post_init__(self):
        if self.pixels.ndim == 2:
            self.pixels = self.pixels[..., None]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def channels(self) -> int:
        return self.pixels.shape[2]

    # -- constructors ------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Image":
        """PNG/JPEG/BIN loader (image.cpp:149-246). `.bin`/`.BIN` files need
        a sibling usage or explicit reshape by the caller."""
        path = os.fspath(path)
        ext = os.path.splitext(path)[1].lower()
        if ext in (".png", ".jpg", ".jpeg", ".bmp"):
            from PIL import Image as PILImage

            img = PILImage.open(path)
            arr = np.asarray(img)
            fmt = {1: ColorFormat.R8, 2: ColorFormat.RG8, 3: ColorFormat.RGB8,
                   4: ColorFormat.RGBA8}[arr.shape[-1] if arr.ndim == 3 else 1]
            return cls(arr, fmt)
        if ext == ".bin":
            data = np.fromfile(path, "<f4")
            return cls(data.reshape(1, -1, 1), ColorFormat.R32F)
        raise ValueError(f"unsupported image extension {ext!r}")

    # -- conversions -------------------------------------------------------
    def to_format(self, fmt: ColorFormat) -> "Image":
        return Image(convert(self.pixels, self.format, fmt), fmt)

    def to_float(self) -> "Image":
        """-> RGBA32F-style float32 in [0,1] (convertToRGBA32FAndNormalize
        first half, imageTexture.cpp:51-227)."""
        target = {1: ColorFormat.R32F, 3: ColorFormat.RGB32F}.get(
            self.channels, ColorFormat.RGBA32F
        )
        return self.to_format(target)

    def luma(self) -> "Image":
        """Y channel in [0,1] (the ESPCN/denoise input path)."""
        f = self.to_float()
        if f.channels == 1:
            return f
        y = rgb_to_y(self.pixels.astype(np.float32))
        if self.pixels.dtype == np.uint8:
            y = y / 255.0
        return Image(y[..., None].astype(np.float32), ColorFormat.R32F)

    def normalized(self, means: Sequence[float], norms: Sequence[float]) -> "Image":
        """(x - mean) * norm per channel — RawImage::normalize semantics
        (image.cpp normalize(means, norms))."""
        p = self.to_float().pixels
        c = p.shape[-1]
        means = np.asarray(list(means)[:c], np.float32)
        norms = np.asarray(list(norms)[:c], np.float32)
        return Image((p - means) * norms, self.format)

    def resized(self, height: int, width: int, method: str = "bilinear") -> "Image":
        from PIL import Image as PILImage

        resample = PILImage.BILINEAR if method == "bilinear" else PILImage.NEAREST
        p = self.pixels
        squeeze = p.shape[-1] == 1
        img = PILImage.fromarray(p[..., 0] if squeeze else p)
        out = np.asarray(img.resize((width, height), resample))
        if squeeze:
            out = out[..., None]
        return Image(out, self.format)

    # -- batching ----------------------------------------------------------
    def as_batch(self, batch: int = 1) -> np.ndarray:
        """-> (batch, H, W, C) float32 NHWC, replicated."""
        p = self.to_float().pixels[None]
        return np.repeat(p, batch, axis=0).astype(np.float32)

    # -- savers ------------------------------------------------------------
    def save(self, path: str) -> None:
        path = os.fspath(path)
        ext = os.path.splitext(path)[1].lower()
        if ext == ".bin":
            self.pixels.astype("<f4").tofile(path)
            return
        from PIL import Image as PILImage

        p = self.pixels
        if p.dtype != np.uint8:
            p = np.clip(p * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if p.shape[-1] == 1:
            p = p[..., 0]
        PILImage.fromarray(p).save(path)


def load_and_preprocess(
    path: str,
    height: int,
    width: int,
    means: Sequence[float] = (0, 0, 0, 0),
    norms: Sequence[float] = (1, 1, 1, 1),
    luma_only: bool = False,
    batch: int = 1,
) -> np.ndarray:
    """The reference's canonical input path: loadFromFile ->
    convertToRGBA32FAndNormalize -> upload (demo/common/modelInference.cpp:26-60
    loadAndPreprocessImage), returning an NHWC batch ready for the engine."""
    img = Image.load(path)
    if (img.height, img.width) != (height, width):
        img = img.resized(height, width)
    img = img.luma() if luma_only else img.to_float()
    img = img.normalized(means, norms)
    return img.as_batch(batch)
