"""Train a denoiser on procedural noisy/clean luma pairs and export it
(counterpart of shadernn_tpu/tools/train_denoiser.py): SpatialDenoise
(features 16, depth 4), U-Net (base_filters 8, depth 3) or AIDenoise
(features 16, depth 3).

Training runs through the port's FP32 TORCH forward with the JAX
trainer's recipe: the MSE loss, Adam under warmup_cosine(1e-3, 30, steps)
with a global-norm clip of 1.0, every parameter trained
(tools/optim.py). The gate is a true denoising PSNR: the model must beat
the noisy input (the identity). `noisy_pairs` is a copy of the JAX
generator: the same generator state gives bit-identical pairs in both
packages.

Usage: python -m shadernn_tpu_torch.tools.train_denoiser [--steps 500]
       [--model spatialdenoise|unet|aidenoise] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from shadernn_tpu_torch.tools.train_espcn import mse_loss, psnr, synth_hr
from shadernn_tpu_torch.tools.train_resnet18 import OUT_DIR

NOISE = (0.04, 0.12)  # sigma range of the degradation model
MODELS = ("spatialdenoise", "unet", "aidenoise")


def noisy_pairs(rng: np.random.Generator, n: int, s: int):
    """(noisy, clean): `synth_hr` patches plus Gaussian noise of a sigma
    drawn per patch from NOISE, clipped to [0, 1]."""
    clean = synth_hr(rng, n, s)
    sigma = rng.uniform(*NOISE, (n, 1, 1, 1)).astype(np.float32)
    noisy = clean + rng.normal(0, 1, clean.shape).astype(np.float32) * sigma
    return np.clip(noisy, 0, 1), clean


def build_graph(model: str, size: int):
    from shadernn_tpu_torch.models.zoo import build_model

    if model == "unet":
        # width-8 depth-3 variant; the full topology (enc/pool/deconv/
        # skip-concat) is exercised unchanged
        return build_model("unet", h=size, w=size, base_filters=8, depth=3)
    if model == "aidenoise":
        return build_model("aidenoise", h=size, w=size, features=16, depth=3)
    return build_model(model, h=size, w=size, features=16, depth=4)


def setup(steps: int = 500, model: str = "spatialdenoise", batch: int = 16,
          size: int = 64, device: str = "cuda"):
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.compile import compile_graph
    from shadernn_tpu_torch.tools.optim import Setup, TrainState, warmup_cosine

    graph = build_graph(model, size)
    m = compile_graph(graph, EngineOptions(precision=Precision.FP32, backend=BackendKind.TORCH,
                                           batch_size=batch, device=device))
    state = TrainState(m.params, warmup_cosine(1e-3, 30, steps), clip=1.0)
    return Setup(graph, m, mse_loss(m, graph), state, lambda rng: noisy_pairs(rng, batch, size))


def train(steps: int = 500, model: str = "spatialdenoise", batch: int = 16,
          size: int = 64, seed: int = 0, log=print, device: str = "cuda", stats=None):
    from shadernn_tpu_torch.tools.optim import fit

    s = setup(steps, model, batch, size, device)
    fit(s, steps, np.random.default_rng(seed), log, every=50, metric="mse", fmt=".5f",
        stats=stats)
    return s.graph, s.model, s.params


def evaluate(graph, m, params, n=16, size=128, seed=777):
    """(PSNR of the model's output, PSNR of the noisy input), both against
    the clean frames. The forward takes any frame size."""
    import torch

    rng = np.random.default_rng(seed)
    x, y = noisy_pairs(rng, n, size)
    with torch.no_grad():
        out = m.forward(params, {graph.input_names[0]: torch.from_numpy(x).to(m.device)})
    pred = out[graph.output_names[0]].float().cpu().numpy()
    return psnr(pred, y), psnr(x, y)


def export(graph, params, out_dir: str, model: str = "spatialdenoise", log=print):
    from shadernn_tpu_torch.graph.serialize import save_model
    from shadernn_tpu_torch.tools.optim import write_back

    write_back(graph, params)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{model}_trained.json")
    save_model(graph, path, decouple=True)
    log(f"saved {path} (+ _layers.json/_weights.bin)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--model", default="spatialdenoise", choices=list(MODELS))
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    graph, m, params = train(args.steps, model=args.model, device=args.device)
    p_model, p_noisy = evaluate(graph, m, params)
    print(f"held-out PSNR: denoised {p_model:.2f} dB vs noisy {p_noisy:.2f} dB")
    export(graph, params, args.out, model=args.model)


if __name__ == "__main__":
    main()
