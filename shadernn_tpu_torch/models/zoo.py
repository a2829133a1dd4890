"""Model zoo registry of the port (counterpart of shadernn_tpu/models/zoo.py):
the eight model families and the five per-style StyleTransfer models, and
the paths of the trained artifacts."""

from __future__ import annotations

import os
from typing import Callable, Dict

from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.models import (
    aidenoise, espcn, mobilenetv2, resnet18, spatialdenoise, styletransfer, unet, yolov3_tiny,
)

# Trained artifacts live with the JAX package; the port reads the files
# only (no import).
ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "shadernn_tpu", "models", "artifacts",
)


def _artifact(stem: str) -> str:
    return os.path.join(ARTIFACTS, f"{stem}_trained_layers.json")


ESPCN_TRAINED = _artifact("espcn_2x")
# MobileNetV2 trained on the 10-class synthetic task of
# tools/train_resnet18.synth_cls (32x32x3 input).
MOBILENETV2_TRAINED = _artifact("mobilenetv2_cls10")
# ResNet18 at base_filters=16 trained on the same task.
RESNET18_TRAINED = _artifact("resnet18_cls10")
# The denoisers, trained on tools/train_denoiser.noisy_pairs: SpatialDenoise
# (features 16, depth 4), AIDenoise (features 16, depth 3) and U-Net
# (base_filters 8, depth 3).
SPATIALDENOISE_TRAINED = _artifact("spatialdenoise")
AIDENOISE_TRAINED = _artifact("aidenoise")
UNET_TRAINED = _artifact("unet")
# StyleTransfer fit to tools/train_styletransfer.style_target: the default
# candy mapping at 64x64, and one artifact per style at 512x512.
STYLETRANSFER_TRAINED = _artifact("styletransfer")
STYLES = ("candy", "mosaic", "pointilism", "rain-princess", "udnie")
STYLE512_TRAINED = {style: _artifact(f"styletransfer_{style}512") for style in STYLES}
# YOLOv3-tiny (3 classes, 256x256) trained on tools/train_yolo.synth_scenes.
YOLOV3_TINY_TRAINED = _artifact("yolov3_tiny")

_BUILDERS: Dict[str, Callable[..., Graph]] = {
    "espcn": espcn.build_espcn,
    "mobilenetv2": mobilenetv2.build_mobilenetv2,
    "resnet18": resnet18.build_resnet18_cifar10,
    "unet": unet.build_unet,
    "styletransfer": styletransfer.build_style_transfer,
    "yolov3-tiny": yolov3_tiny.build_yolov3_tiny,
    "spatialdenoise": spatialdenoise.build_spatial_denoise,
    "aidenoise": aidenoise.build_aidenoise,
}


def _style_builder(style: str, seed: int) -> Callable[..., Graph]:
    """The reference zoo's per-style models: one architecture, per-style
    weights. The style's 512x512 artifact, retargeted to the requested
    frame size (the network is fully convolutional), where it exists; else
    the architecture with the style's own seed."""
    path = STYLE512_TRAINED[style]

    def build(h: int = 224, w: int = 224, **kw) -> Graph:
        if os.path.exists(path):
            from shadernn_tpu_torch.graph.parser import parse_model_file

            return parse_model_file(path, input_hw=(h, w))
        return styletransfer.build_style_transfer(h=h, w=w, style=style, seed=seed, **kw)

    return build


for _i, _style in enumerate(STYLES):
    _BUILDERS[f"styletransfer-{_style}"] = _style_builder(_style, 7767517 + _i)


def register_model(name: str):
    """Decorator: add a builder to the zoo under `name`."""

    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


def build_model(name: str, **kwargs) -> Graph:
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_BUILDERS)}")
    return _BUILDERS[name](**kwargs)


def list_models():
    return sorted(_BUILDERS)
