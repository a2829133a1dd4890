"""Train the ResNet18-CIFAR classifier on the 10-class procedural image
task and export it (counterpart of shadernn_tpu/tools/train_resnet18.py).

Training runs through the port's own differentiable forward
(engine/compile.py `compile_graph` on the TORCH backend at FP32, BatchNorm
unfolded), as the JAX trainer differentiates its XLA forward, with the JAX
trainer's recipe: each block's `_bn2` gamma zero at init, BatchNorm
statistics frozen (gamma and beta train), loss -mean(log(clip(softmax,
1e-8)))[y], Adam under warmup_cosine(2e-3, 50, steps) with the gradient
clipped to a global norm of 1.0 (tools/optim.py). `synth_cls` is a copy of
the JAX generator: the same generator state gives bit-identical images and
labels in both packages.

`--out` defaults to build/trained/ (git-ignored); a trainer never writes
into the JAX package's artifacts.

Usage: python -m shadernn_tpu_torch.tools.train_resnet18 [--steps 600]
       [--base_filters 16] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "trained")

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


def build_trainable(base_filters: int, batch: int, device: str = "cuda"):
    """The zoo graph at `base_filters` and its FP32 TORCH forward with
    BatchNorm unfolded."""
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.compile import compile_graph
    from shadernn_tpu_torch.models.zoo import build_model

    graph = build_model("resnet18", base_filters=base_filters)
    m = compile_graph(graph, EngineOptions(
        precision=Precision.FP32, backend=BackendKind.TORCH, batch_size=batch,
        fold_batchnorm=False, device=device))
    return graph, m


def classifier_loss(m, graph):
    """-mean(log(clip(softmax, 1e-8))) at the labels, over the softmax
    head's output."""
    import torch

    (in_name,) = graph.input_names
    out_name = graph.output_names[0]

    def loss(p, x, y):
        probs = m.forward(p, {in_name: x})[out_name]
        logp = torch.log(torch.clamp(probs, min=1e-8))
        return -logp[torch.arange(y.shape[0], device=y.device), y.long()].mean()

    return loss


def setup(steps: int = 600, base_filters: int = 16, batch: int = 128,
          device: str = "cuda"):
    from shadernn_tpu_torch.tools.optim import FROZEN_BN, Setup, TrainState, warmup_cosine

    graph, m = build_trainable(base_filters, batch, device)
    # Zero-init-residual: with BN statistics frozen, residual adds double
    # the signal variance every block; zeroing each block's second BN gamma
    # makes blocks identity at init.
    for name, d in m.params.items():
        if name.endswith("_bn2") and "gamma" in d:
            d["gamma"].zero_()
    state = TrainState(m.params, warmup_cosine(2e-3, 50, steps), clip=1.0, frozen=FROZEN_BN)
    return Setup(graph, m, classifier_loss(m, graph), state,
                 lambda rng: synth_cls(rng, batch))


def train(steps: int = 600, base_filters: int = 16, batch: int = 128,
          seed: int = 0, log=print, device: str = "cuda", stats=None):
    from shadernn_tpu_torch.tools.optim import fit

    s = setup(steps, base_filters, batch, device)
    fit(s, steps, np.random.default_rng(seed), log, every=50, stats=stats)
    return s.graph, s.model, s.params


def count_correct(m, graph, params, x, y) -> int:
    """Images of the batch `x` whose argmax is their label `y`."""
    import torch

    (in_name,) = graph.input_names
    with torch.no_grad():
        probs = m.forward(params, {in_name: torch.from_numpy(x).to(m.device)})
    return int((probs[graph.output_names[0]].argmax(-1).cpu().numpy() == y).sum())


def evaluate(graph, m, params, n=512, seed=777, batch=128):
    """Held-out top-1 over fresh batches, counted as the JAX trainer counts
    it: ceil(n / batch) batches over n // batch * batch images."""
    rng = np.random.default_rng(seed)
    correct = 0
    for _ in range(0, n, batch):
        x, y = synth_cls(rng, batch)
        correct += count_correct(m, graph, params, x, y)
    return correct / (n // batch * batch)


def export(graph, params, out_dir: str, log=print):
    from shadernn_tpu_torch.graph.serialize import save_model
    from shadernn_tpu_torch.tools.optim import write_back

    write_back(graph, params)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "resnet18_cls10_trained.json")
    save_model(graph, path, decouple=True)
    log(f"saved {path} (+ _layers.json/_weights.bin)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--base_filters", type=int, default=16)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    graph, m, params = train(args.steps, args.base_filters, device=args.device)
    acc = evaluate(graph, m, params)
    print(f"held-out top-1: {acc:.3f}")
    export(graph, params, args.out)


if __name__ == "__main__":
    main()
