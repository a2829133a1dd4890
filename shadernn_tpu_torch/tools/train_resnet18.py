"""The 10-class procedural image task that the repo's classifiers are
trained and scored on (a copy of `synth_cls` and `N_CLASSES` from
shadernn_tpu/tools/train_resnet18.py, so that the port scores a trained
model without importing the JAX package). Training itself is not ported.

The same generator state gives bit-identical images and labels in both
packages.
"""

from __future__ import annotations

import numpy as np

N_CLASSES = 10


def synth_cls(rng: np.random.Generator, n: int, s: int = 32):
    """n procedural (s, s, 3) images in [0,1] + labels.

    10 classes: 0 disc, 1 square, 2 triangle, 3 cross, 4 h-stripes,
    5 v-stripes, 6 checkerboard, 7 ring, 8 diagonal bar, 9 dot field.
    Random fg/bg colors, position/scale jitter, additive noise."""
    yy, xx = np.mgrid[0:s, 0:s] / float(s)
    imgs = np.empty((n, s, s, 3), np.float32)
    labels = rng.integers(0, N_CLASSES, n)
    for i in range(n):
        k = labels[i]
        bg = rng.uniform(0.0, 0.6, 3)
        fg = rng.uniform(0.4, 1.0, 3)
        while np.abs(fg - bg).sum() < 0.6:  # keep figure visible
            fg = rng.uniform(0.0, 1.0, 3)
        cx, cy = rng.uniform(0.3, 0.7, 2)
        r = rng.uniform(0.15, 0.3)
        m = np.zeros((s, s), bool)
        if k == 0:
            m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        elif k == 1:
            m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
        elif k == 2:
            m = (yy > cy - r) & (yy < cy + r) & (
                np.abs(xx - cx) < (yy - (cy - r)) / 2
            )
        elif k == 3:
            w = r / 2.5
            m = ((np.abs(xx - cx) < w) & (np.abs(yy - cy) < r)) | (
                (np.abs(yy - cy) < w) & (np.abs(xx - cx) < r)
            )
        elif k == 4:
            f = rng.integers(3, 6)
            m = (np.floor(yy * f * 2) % 2).astype(bool)
        elif k == 5:
            f = rng.integers(3, 6)
            m = (np.floor(xx * f * 2) % 2).astype(bool)
        elif k == 6:
            f = rng.integers(2, 4)
            m = ((np.floor(xx * f * 2) + np.floor(yy * f * 2)) % 2).astype(bool)
        elif k == 7:
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            m = (d2 < r * r) & (d2 > (r * 0.55) ** 2)
        elif k == 8:
            th = rng.uniform(np.pi / 6, np.pi / 3) * rng.choice([-1, 1])
            d = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            m = np.abs(d) < r / 3
        else:
            for _ in range(12):
                px, py = rng.uniform(0.1, 0.9, 2)
                m |= (xx - px) ** 2 + (yy - py) ** 2 < 0.002
        img = np.where(m[..., None], fg, bg)
        img += rng.normal(0, 0.05, img.shape)
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels.astype(np.int32)
