"""Train the style-transfer network to a fixed procedural stylization and
export it (counterpart of shadernn_tpu/tools/train_styletransfer.py).

With no VGG for a perceptual loss and no style images, the network is fit
to a deterministic procedural target per style (`style_target`: a color
remap, a tanh tone curve, Sobel-edge strokes and, for some styles, a soft
posterization), which doubles as the ground truth of a true metric:
output-vs-target PSNR on held-out images, which must beat the identity.
Training runs through the port's FP32 TORCH forward (instance norm,
stride-2 transposed convs, the residual chain) with the JAX trainer's
recipe: the MSE loss, Adam under warmup_cosine(peak_lr, min(30, steps //
4), steps) with a global-norm clip of 1.0, every parameter trained, an
optional warm start from an artifact read by the port's own parser. The
network is fully convolutional: `export` rebuilds it at the serving size.

`synth_imgs`, `STYLES` and `style_target` are copies of the JAX ones: the
same generator state gives bit-identical images and targets in both
packages.

Usage: python -m shadernn_tpu_torch.tools.train_styletransfer [--steps 400]
       [--style candy] [--hw 64] [--batch 32] [--export-hw N] [--name NAME]
       [--init-from PATH] [--peak-lr 1e-3] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from shadernn_tpu_torch.tools.train_espcn import mse_loss
from shadernn_tpu_torch.tools.train_resnet18 import OUT_DIR, synth_cls


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


def build_trainable(batch: int, hw: int = 64, device: str = "cuda"):
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.compile import compile_graph
    from shadernn_tpu_torch.models.zoo import build_model

    graph = build_model("styletransfer", h=hw, w=hw)
    m = compile_graph(graph, EngineOptions(precision=Precision.FP32, backend=BackendKind.TORCH,
                                           batch_size=batch, device=device))
    return graph, m


def warm_start(params, path: str) -> int:
    """Copy every tensor of `params` that the artifact at `path` has (the
    weights are resolution-independent). Returns the number copied."""
    import torch

    from shadernn_tpu_torch.graph.parser import parse_model_file

    src = parse_model_file(path)
    loaded = 0
    with torch.no_grad():
        for name, d in params.items():
            if name in src.nodes:
                for k, t in d.items():
                    if k in src.nodes[name].params:
                        t.copy_(torch.as_tensor(np.asarray(src.nodes[name].params[k], np.float32)))
                        loaded += 1
    return loaded


def setup(steps: int = 400, batch: int = 32, hw: int = 64, style: str = "candy",
          init_from: str = None, peak_lr: float = 1e-3, device: str = "cuda", log=print):
    from shadernn_tpu_torch.tools.optim import Setup, TrainState, warmup_cosine

    graph, m = build_trainable(batch, hw, device)
    if init_from:
        # warm start from an existing artifact (a sibling style or a
        # lower-resolution fit): skips the slow climb out of the identity basin
        log(f"warm-start: {warm_start(m.params, init_from)} tensors from {init_from}")
    state = TrainState(m.params, warmup_cosine(peak_lr, min(30, steps // 4), steps), clip=1.0)

    def one_batch(rng):
        x = synth_imgs(rng, batch, s=hw)
        return x, style_target(x, style=style)

    return Setup(graph, m, mse_loss(m, graph), state, one_batch)


def train(steps: int = 400, batch: int = 32, seed: int = 0, log=print, hw: int = 64,
          style: str = "candy", init_from: str = None, peak_lr: float = 1e-3,
          device: str = "cuda", stats=None):
    from shadernn_tpu_torch.tools.optim import fit

    s = setup(steps, batch, hw, style, init_from, peak_lr, device, log)
    fit(s, steps, np.random.default_rng(seed), log, every=25, metric="mse", fmt=".5f",
        stats=stats)
    return s.graph, s.model, s.params


def evaluate(graph, m, params, n=64, seed=777, batch=32, hw: int = 64, style: str = "candy"):
    """Held-out PSNR of (network output vs style target), and of the
    identity mapping (input vs target) as the must-beat floor."""
    import torch

    from shadernn_tpu_torch.utils.metrics import psnr

    rng = np.random.default_rng(seed)
    net_db, id_db = [], []
    for _ in range(max(n // batch, 1)):
        x = synth_imgs(rng, batch, s=hw)
        t = style_target(x, style=style)
        with torch.no_grad():
            out = m.forward(params, {graph.input_names[0]: torch.from_numpy(x).to(m.device)})
        y = out[graph.output_names[0]].float().cpu().numpy()
        net_db.append(psnr(np.clip(y, 0, 1), t))
        id_db.append(psnr(x, t))
    return float(np.mean(net_db)), float(np.mean(id_db))


def export(graph, params, out_dir: str, hw: int = 224, log=print,
           name: str = "styletransfer_trained"):
    """Re-build at the serving input size (fully convolutional, instance
    norm: the weights are resolution-independent) with the trained weights."""
    from shadernn_tpu_torch.graph.serialize import save_model
    from shadernn_tpu_torch.models.zoo import build_model
    from shadernn_tpu_torch.tools.optim import write_back

    g_out = build_model("styletransfer", h=hw, w=hw)
    write_back(g_out, params)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    save_model(g_out, path, decouple=True)
    log(f"saved {path} (+ _layers.json/_weights.bin)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--style", default="candy", choices=sorted(STYLES))
    ap.add_argument("--hw", type=int, default=64,
                    help="train and gate resolution: the learned mapping does not "
                    "transfer across scales (instance-norm statistics are "
                    "content-scale dependent), so train at the serving resolution")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--export-hw", type=int, default=None,
                    help="artifact input size (default: 224 for the candy@64 "
                    "artifact, else --hw)")
    ap.add_argument("--name", default=None,
                    help="artifact base name (default: styletransfer_trained for "
                    "candy@64, else styletransfer_<style><hw>_trained)")
    ap.add_argument("--init-from", default=None,
                    help="warm-start weights from an existing artifact (_layers.json path)")
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    args = ap.parse_args(argv)
    graph, m, params = train(args.steps, batch=args.batch, hw=args.hw, style=args.style,
                             init_from=args.init_from, peak_lr=args.peak_lr,
                             device=args.device)
    net_db, id_db = evaluate(graph, m, params, batch=args.batch, hw=args.hw, style=args.style)
    print(f"held-out PSNR vs target ({args.style}@{args.hw}): "
          f"net {net_db:.2f} dB, identity {id_db:.2f} dB")
    name = args.name or (
        "styletransfer_trained" if (args.style, args.hw) == ("candy", 64)
        else f"styletransfer_{args.style}{args.hw}_trained"
    )
    export_hw = args.export_hw or (224 if name == "styletransfer_trained" else args.hw)
    export(graph, params, args.out, hw=export_hw, name=name)


if __name__ == "__main__":
    main()
