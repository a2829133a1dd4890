"""The comparison that decides `correct`: every output kept from the
timed path against the plain reference (`reference/plain.py`) run on the
same uint8 frames, one frame at a time, in float32 with TF32 off.

Numbers compared (each has its limit in `limits/<cell>.json`):

- ``rel_rms_err``: over the compared frames, the largest
  ||program - reference||_2 / ||reference||_2 of one frame;
- ``max_abs_err``: the largest |program - reference| of any value.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.reference import plain


def reference_model(root: str, config: dict, model: plain.Model, device):
    params = plain.to_device(plain.read_weights(model, plain.artifact_weights(root, config)),
                             device)
    ing = config["ingest"]

    def run(raw: torch.Tensor, quantize: Optional[Callable] = None) -> torch.Tensor:
        x = plain.ingest(raw.to(device), ing["means"], ing["norms"])
        return plain.forward(model, params, x, quantize)

    return run


def _number(x: float) -> float:
    return float("inf") if x != x else x  # NaN fails every limit


def compare(ref, answers, device) -> Dict[str, float]:
    rel = mx = 0.0
    frames = 0
    with torch.no_grad():
        for raw, out in answers:
            for i in range(raw.shape[0]):
                r = ref(raw[i:i + 1]).double()
                y = torch.as_tensor(out[i:i + 1]).to(device).double().reshape(r.shape)
                d = y - r
                rel = max(rel, _number((d.norm() / r.norm()).item()))
                mx = max(mx, _number(d.abs().max().item()))
                frames += 1
    if not frames:
        return {}
    return {"rel_rms_err": rel, "max_abs_err": mx, "frames": frames}
