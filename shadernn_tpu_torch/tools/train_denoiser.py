"""The noisy/clean luma pairs the repo's denoisers are trained and scored
on (copies of `synth_hr` from shadernn_tpu/tools/train_espcn.py and of
`NOISE` and `noisy_pairs` from shadernn_tpu/tools/train_denoiser.py, so
that the port scores a trained denoiser without importing the JAX
package). Training itself is not ported.

The same generator state gives bit-identical pairs in both packages.
"""

from __future__ import annotations

import numpy as np

NOISE = (0.04, 0.12)  # sigma range of the degradation model


def synth_hr(rng: np.random.Generator, n: int, s: int) -> np.ndarray:
    """n synthetic luma patches (s x s x 1) in [0, 1]: two low-frequency
    gratings under hard-edged discs and rotated bars and thin lines."""
    yy, xx = np.mgrid[0:s, 0:s] / float(s)
    out = np.empty((n, s, s, 1), np.float32)
    for i in range(n):
        img = np.zeros((s, s), np.float64)
        for _ in range(2):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            img += rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        for _ in range(10):  # hard-edged discs
            cx, cy = rng.uniform(0.0, 1.0, 2)
            r = rng.uniform(0.02, 0.2)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] += rng.uniform(-0.7, 0.7)
        for _ in range(8):  # rotated bars / thin lines
            th = rng.uniform(0, np.pi)
            d = (xx - rng.uniform(0, 1)) * np.cos(th) + (yy - rng.uniform(0, 1)) * np.sin(th)
            img[np.abs(d) < rng.uniform(0.004, 0.05)] += rng.uniform(-0.7, 0.7)
        lo, hi = img.min(), img.max()
        out[i, :, :, 0] = ((img - lo) / (hi - lo + 1e-6)).astype(np.float32)
    return out


def noisy_pairs(rng: np.random.Generator, n: int, s: int):
    """(noisy, clean): `synth_hr` patches plus Gaussian noise of a sigma
    drawn per patch from NOISE, clipped to [0, 1]."""
    clean = synth_hr(rng, n, s)
    sigma = rng.uniform(*NOISE, (n, 1, 1, 1)).astype(np.float32)
    noisy = clean + rng.normal(0, 1, clean.shape).astype(np.float32) * sigma
    return np.clip(noisy, 0, 1), clean
