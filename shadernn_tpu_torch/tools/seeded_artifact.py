"""YOLOv3-tiny at darknet's published widths (cfg/yolov3-tiny.cfg: 80
classes, 416x416) as a ShaderNN artifact with weights drawn from a seed.

    python -m shadernn_tpu_torch.tools.seeded_artifact [--seed N] [--out DIR]

writes `yolov3_tiny_coco80_seeded_layers.json` and `_weights.bin` into DIR
(default: the port's `models/artifacts/`, where the committed pair lives).

Layers: the trained artifact's list (`models/zoo.py` `YOLOV3_TINY_TRAINED`:
Conv2D layers with a bias and darknet's leaky 0.1, BatchNorm folded into
the bias, as ShaderNN deploys the model), with both heads at 3 x (5 + 80)
= 255 channels, the YOLO layer at 80 classes, and the frame and `net_hw`
at 416x416; darknet's anchors and masks ([[3, 4, 5], [1, 2, 3]]).

Weights: one `torch.Generator` seeded with N draws, layer by layer in the
order of the weight stream, each conv's kernel (O, I, k, k) He-normal for a
leaky slope of 0.1, std sqrt(2 / ((1 + 0.1^2) * I * k * k)), then its bias,
normal with std `BIAS_STD`. Untrained weights do the work of trained ones
for speed and for agreement with a reference: every width is darknet's,
and the decode and NMS run fixed shapes (the 100 best of 13^2 * 3 + 26^2 * 3
= 2,535 candidates a frame).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

SEED = 416
CLASSES = 80
HW = 416
BIAS_STD = 0.01
LEAKY = 0.1
STEM = "yolov3_tiny_coco80_seeded"
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models", "artifacts")
LAYERS_JSON = os.path.join(OUT_DIR, f"{STEM}_layers.json")
WEIGHT_VALUES = 8_849_182


def layers() -> dict:
    """The artifact's layer list: the trained artifact's at darknet's widths."""
    from shadernn_tpu_torch.models import zoo

    with open(zoo.YOLOV3_TINY_TRAINED) as f:
        model = json.load(f)
    no = 3 * (5 + CLASSES)
    for i in range(int(model["numLayers"]["count"])):
        layer = model[f"Layer_{i}"]
        if layer["type"] == "InputLayer":
            layer["Input Width"] = layer["Input Height"] = HW
        elif layer["name"] in ("head1", "head2"):
            layer["outputPlanes"] = no
        elif layer["type"] == "YOLO":
            layer["num_classes"] = CLASSES
            layer["net_hw"] = [HW, HW]
    return model


def conv_shapes(model: dict):
    """(O, I, k, k) of each Conv2D layer, in stream order."""
    for i in range(int(model["numLayers"]["count"])):
        layer = model[f"Layer_{i}"]
        if layer["type"] == "Conv2D":
            k = int(layer["kernel_size"])
            yield int(layer["outputPlanes"]), int(layer["inputPlanes"]), k, k


def weights(model: dict, seed: int = SEED) -> np.ndarray:
    """The weight stream: per conv its He-normal kernel, then its bias."""
    g = torch.Generator().manual_seed(seed)
    parts = []
    for o, i, kh, kw in conv_shapes(model):
        std = math.sqrt(2.0 / ((1.0 + LEAKY ** 2) * i * kh * kw))
        parts.append(torch.randn((o, i, kh, kw), generator=g, dtype=torch.float32) * std)
        parts.append(torch.randn((o,), generator=g, dtype=torch.float32) * BIAS_STD)
    return torch.cat([p.flatten() for p in parts]).numpy().astype("<f4")


def write(out_dir: str = OUT_DIR, seed: int = SEED) -> Tuple[str, str]:
    """Write the pair into `out_dir`; returns (layers path, weights path)."""
    os.makedirs(out_dir, exist_ok=True)
    model = layers()
    flat = weights(model, seed)
    if flat.size != WEIGHT_VALUES:
        raise AssertionError(f"{flat.size} weight values, want {WEIGHT_VALUES}")
    lpath = os.path.join(out_dir, f"{STEM}_layers.json")
    wpath = os.path.join(out_dir, f"{STEM}_weights.bin")
    with open(lpath, "w") as f:
        json.dump(model, f, indent=1)
        f.write("\n")
    flat.tofile(wpath)
    return lpath, wpath


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)
    lpath, wpath = write(args.out, args.seed)
    print(json.dumps({"layers": lpath, "weights": wpath}))


if __name__ == "__main__":
    main()
