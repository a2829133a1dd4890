"""The detection scenes that the repo's YOLOv3-tiny artifact is trained
and scored on (copies of `NUM_CLASSES`, `HW` and `synth_scenes` from
shadernn_tpu/tools/train_yolo.py, so that the port scores the trained
detector without importing the JAX package). Training itself is not
ported.

The same generator state gives bit-identical scenes and boxes in both
packages.
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 3  # disc, square, triangle
HW = 256


def synth_scenes(rng: np.random.Generator, n: int, s: int = HW):
    """n scene images (s,s,3) in [0,1] with 1-3 shapes; ground truth rows
    [class, x, y, w, h] normalized top-left (utils/metrics.py format)."""
    yy, xx = np.mgrid[0:s, 0:s] / float(s)
    imgs = np.empty((n, s, s, 3), np.float32)
    gts = []
    for i in range(n):
        bg = rng.uniform(0.0, 0.5, 3)
        img = np.tile(bg[None, None, :], (s, s, 1)).astype(np.float32)
        rows = []
        for _ in range(rng.integers(1, 4)):
            k = int(rng.integers(0, NUM_CLASSES))
            fg = rng.uniform(0.4, 1.0, 3)
            while np.abs(fg - bg).sum() < 0.7:
                fg = rng.uniform(0.0, 1.0, 3)
            r = rng.uniform(0.1, 0.25)
            cx, cy = rng.uniform(r, 1 - r, 2)
            if k == 0:
                m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
                x0, y0, bw, bh = cx - r, cy - r, 2 * r, 2 * r
            elif k == 1:
                m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
                x0, y0, bw, bh = cx - r, cy - r, 2 * r, 2 * r
            else:
                m = (yy > cy - r) & (yy < cy + r) & (
                    np.abs(xx - cx) < (yy - (cy - r)) / 2
                )
                x0, y0, bw, bh = cx - r, cy - r, 2 * r, 2 * r
            img = np.where(m[..., None], fg, img).astype(np.float32)
            rows.append([k, x0, y0, bw, bh])
        img += rng.normal(0, 0.03, img.shape)
        imgs[i] = np.clip(img, 0, 1)
        gts.append(np.asarray(rows, np.float32))
    return imgs, gts
