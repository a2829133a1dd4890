"""Carry parameters across from the JAX package (or any numpy source).

`params_from_numpy` takes the dict that
`shadernn_tpu.engine.compile.extract_params(graph)` returns — node name ->
{param name: numpy array}, conv weights HWIO — and returns the port's
tensors on `device`, ready for `CompiledModel.load_params`. The port keeps
HWIO at this boundary; only the convolutions convert it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(params: Dict[str, Dict[str, np.ndarray]], device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        name: {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}
        for name, d in params.items()
    }
