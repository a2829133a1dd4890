"""Train MobileNetV2 on the 10-class procedural image task and export it
(counterpart of shadernn_tpu/tools/train_mobilenetv2.py).

The recipe is the ResNet18 trainer's (tools/train_resnet18.py): the
port's FP32 TORCH forward with BatchNorm unfolded and its statistics
frozen, the clipped-softmax loss, Adam under warmup_cosine(2e-3, 50,
steps) with a global-norm clip of 1.0. Each residual block's
`{block}_project_bn` gamma starts at zero, so that every block is the
identity at init.

Usage: python -m shadernn_tpu_torch.tools.train_mobilenetv2 [--steps 700]
       [--width_mult 0.5] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from shadernn_tpu_torch.tools.train_resnet18 import (
    OUT_DIR, classifier_loss, count_correct, synth_cls,
)


def build_trainable(width_mult: float, batch: int, hw: int = 32, device: str = "cuda"):
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.compile import compile_graph
    from shadernn_tpu_torch.models.zoo import build_model

    graph = build_model("mobilenetv2", h=hw, w=hw, num_classes=10, width_mult=width_mult)
    m = compile_graph(graph, EngineOptions(
        precision=Precision.FP32, backend=BackendKind.TORCH, batch_size=batch,
        fold_batchnorm=False, device=device))
    return graph, m


def setup(steps: int = 700, width_mult: float = 0.5, batch: int = 128, hw: int = 32,
          device: str = "cuda"):
    from shadernn_tpu_torch.tools.optim import FROZEN_BN, Setup, TrainState, warmup_cosine

    graph, m = build_trainable(width_mult, batch, hw, device)
    # Identity-at-init residual blocks: the project-BN gamma of every block
    # that ends in an Add starts at zero.
    residual_blocks = {n.name.rsplit("_add", 1)[0]
                       for n in graph.nodes.values() if n.name.endswith("_add")}
    for blk in residual_blocks:
        bn = m.params.get(f"{blk}_project_bn", {})
        if "gamma" in bn:
            bn["gamma"].zero_()
    state = TrainState(m.params, warmup_cosine(2e-3, 50, steps), clip=1.0, frozen=FROZEN_BN)
    return Setup(graph, m, classifier_loss(m, graph), state,
                 lambda rng: synth_cls(rng, batch, s=hw))


def train(steps: int = 700, width_mult: float = 0.5, batch: int = 128,
          seed: int = 0, log=print, device: str = "cuda", stats=None):
    from shadernn_tpu_torch.tools.optim import fit

    s = setup(steps, width_mult, batch, device=device)
    fit(s, steps, np.random.default_rng(seed), log, every=50, stats=stats)
    return s.graph, s.model, s.params


def evaluate(graph, m, params, n=512, seed=777, batch=128):
    rng = np.random.default_rng(seed)
    correct = 0
    for _ in range(n // batch):
        x, y = synth_cls(rng, batch)
        correct += count_correct(m, graph, params, x, y)
    return correct / (n // batch * batch)


def export(graph, params, out_dir: str, log=print):
    from shadernn_tpu_torch.graph.serialize import save_model
    from shadernn_tpu_torch.tools.optim import write_back

    write_back(graph, params)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mobilenetv2_cls10_trained.json")
    save_model(graph, path, decouple=True)
    log(f"saved {path} (+ _layers.json/_weights.bin)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--width_mult", type=float, default=0.5)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    graph, m, params = train(args.steps, args.width_mult, device=args.device)
    acc = evaluate(graph, m, params)
    print(f"held-out top-1: {acc:.3f}")
    export(graph, params, args.out)


if __name__ == "__main__":
    main()
