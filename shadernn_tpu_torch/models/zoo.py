"""Model zoo registry of the port (ESPCN only in this slice)."""

from __future__ import annotations

import os
from typing import Callable, Dict

from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.models.espcn import build_espcn

_BUILDERS: Dict[str, Callable[..., Graph]] = {"espcn": build_espcn}

# Trained artifacts live with the JAX package; the port reads the files
# only (no import).
ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "shadernn_tpu", "models", "artifacts",
)
ESPCN_TRAINED = os.path.join(ARTIFACTS, "espcn_2x_trained_layers.json")


def build_model(name: str, **kwargs) -> Graph:
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_BUILDERS)}")
    return _BUILDERS[name](**kwargs)


def list_models():
    return sorted(_BUILDERS)
