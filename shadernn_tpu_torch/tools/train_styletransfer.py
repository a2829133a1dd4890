"""The content images and the procedural stylizations that the repo's
StyleTransfer artifacts are trained and scored on (copies of
`synth_imgs`, `STYLES` and `style_target` from
shadernn_tpu/tools/train_styletransfer.py, so that the port scores a
trained model without importing the JAX package). Training itself is not
ported.

The same generator state gives bit-identical images and targets in both
packages.
"""

from __future__ import annotations

import numpy as np

from shadernn_tpu_torch.tools.train_resnet18 import synth_cls


def synth_imgs(rng: np.random.Generator, n: int, s: int = 64) -> np.ndarray:
    """Structured content images in [0,1]: the classifier task's shapes /
    stripes / textures over a random global color gradient."""
    imgs, _ = synth_cls(rng, n, s=s)
    yy, xx = np.mgrid[0:s, 0:s] / float(s)
    for i in range(n):
        ca, cb = rng.uniform(0, 1, (2, 3))
        th = rng.uniform(0, 2 * np.pi)
        t = (xx * np.cos(th) + yy * np.sin(th) + 1) / 2
        grad = ca + (cb - ca) * t[..., None]
        a = rng.uniform(0.3, 0.7)
        imgs[i] = np.clip(a * imgs[i] + (1 - a) * grad, 0, 1)
    return imgs.astype(np.float32)


# Per-style fixed stylizations (the reference ships candy/mosaic/... as
# per-style trained weights over ONE architecture): a full-rank color
# mixing matrix + offset, tone compressed through tanh, Sobel-edge
# darkening (candy's dark strokes), and for mosaic a soft color
# posterization (tile-like flat color fields). All components are
# pointwise or local-edge functions — translation-equivariant, so a CNN
# can actually fit them (an absolute-position pattern could not be learned
# by a padding-agnostic conv net). Deterministic; doubles as ground truth.
STYLES = {
    "candy": dict(
        mix=np.array(
            [[0.9, 0.4, -0.1], [-0.2, 1.0, 0.3], [0.3, -0.3, 0.9]],
            np.float32,
        ),
        off=np.array([0.05, -0.05, 0.1], np.float32),
        tone=2.5,
        edge=0.6,
        posterize=0,
    ),
    "mosaic": dict(
        mix=np.array(
            [[1.1, -0.2, 0.2], [0.1, 0.8, 0.2], [-0.1, 0.4, 0.8]],
            np.float32,
        ),
        off=np.array([-0.02, 0.08, 0.02], np.float32),
        tone=3.5,
        edge=0.35,
        posterize=5,  # soft-quantized color fields = the tesserae look
    ),
    "pointilism": dict(  # saturated dabs: strong quantization, light edges
        mix=np.array(
            [[1.2, 0.1, -0.2], [-0.1, 1.1, 0.1], [0.1, -0.2, 1.2]],
            np.float32,
        ),
        off=np.array([0.02, 0.0, 0.04], np.float32),
        tone=3.0,
        edge=0.15,
        posterize=7,
    ),
    "rain-princess": dict(  # warm, soft tonal palette, painterly strokes
        mix=np.array(
            [[1.15, 0.25, -0.05], [0.1, 0.95, 0.1], [-0.05, 0.15, 0.8]],
            np.float32,
        ),
        off=np.array([0.08, 0.02, -0.04], np.float32),
        tone=1.8,
        edge=0.45,
        posterize=0,
    ),
    "udnie": dict(  # desaturated, high-contrast fauvist look
        mix=np.array(
            [[0.65, 0.45, 0.15], [0.35, 0.55, 0.25], [0.25, 0.35, 0.5]],
            np.float32,
        ),
        off=np.array([-0.05, -0.02, 0.05], np.float32),
        tone=3.2,
        edge=0.5,
        posterize=0,
    ),
}

def style_target(x: np.ndarray, style: str = "candy") -> np.ndarray:
    """x (N,H,W,3) in [0,1] -> stylized target in [0,1]."""
    p = STYLES[style]
    y = x @ p["mix"].T + p["off"]
    y = 0.5 + 0.5 * np.tanh(p["tone"] * (y - 0.5))  # painterly tone curve
    if p["posterize"]:
        # smooth staircase: sum of tanh steps — flat color fields with
        # soft transitions (fittable by the network, unlike a hard floor)
        L = p["posterize"]
        steps = np.zeros_like(y)
        for k in range(1, L):
            steps += 0.5 * (1.0 + np.tanh(12.0 * (y - k / L)))
        y = steps / (L - 1)
    luma = x @ np.array([0.299, 0.587, 0.114], np.float32)
    gx = np.zeros_like(luma)
    gy = np.zeros_like(luma)
    gx[:, :, 1:-1] = luma[:, :, 2:] - luma[:, :, :-2]
    gy[:, 1:-1, :] = luma[:, 2:, :] - luma[:, :-2, :]
    edges = np.minimum(np.sqrt(gx**2 + gy**2) * 2.5, 1.0)
    y = y * (1.0 - p["edge"] * edges[..., None])
    return np.clip(y, 0, 1).astype(np.float32)
