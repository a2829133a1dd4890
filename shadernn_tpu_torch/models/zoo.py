"""Model zoo registry of the port (ESPCN, MobileNetV2 and ResNet18 so far)."""

from __future__ import annotations

import os
from typing import Callable, Dict

from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.models.espcn import build_espcn
from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2
from shadernn_tpu_torch.models.resnet18 import build_resnet18_cifar10

_BUILDERS: Dict[str, Callable[..., Graph]] = {
    "espcn": build_espcn,
    "mobilenetv2": build_mobilenetv2,
    "resnet18": build_resnet18_cifar10,
}

# Trained artifacts live with the JAX package; the port reads the files
# only (no import).
ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "shadernn_tpu", "models", "artifacts",
)
ESPCN_TRAINED = os.path.join(ARTIFACTS, "espcn_2x_trained_layers.json")
# MobileNetV2 trained on the 10-class synthetic task of
# tools/train_resnet18.synth_cls (32x32x3 input).
MOBILENETV2_TRAINED = os.path.join(ARTIFACTS, "mobilenetv2_cls10_trained_layers.json")
# ResNet18 at base_filters=16 trained on the same task.
RESNET18_TRAINED = os.path.join(ARTIFACTS, "resnet18_cls10_trained_layers.json")


def build_model(name: str, **kwargs) -> Graph:
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_BUILDERS)}")
    return _BUILDERS[name](**kwargs)


def list_models():
    return sorted(_BUILDERS)
