"""The comparison that decides `correct`: every output kept from the
timed path against the plain reference (`reference/plain.py`) run on the
same uint8 frames, one frame at a time, in float32 with TF32 off.

Numbers compared (each has its limit in `limits/<cell>.json`):

- ``rel_rms_err``: over the compared frames, the largest
  ||program - reference||_2 / ||reference||_2 of one frame;
- ``max_abs_err``: the largest |program - reference| of any value.

A configuration that names its ``outputs`` (``[{"name": <graph node>,
"compare": "dense" | "detections"}]``) has each compared by its kind: the
two numbers above over its ``dense`` outputs, the worst of them; a
``detections`` output row to row (`harness/detections.py`) against the
reference's layer of that name run on the program's own values of its
inputs, which have to be ``dense`` outputs too. Both sides then decide from
the same numbers: ``det_score_err``, ``det_box_err`` and ``det_unmatched``
(rows of either side left without a pair of their class).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.harness import detections
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


def compare(ref, answers, device, config: Optional[dict] = None,
            model: Optional[plain.Model] = None) -> Dict[str, float]:
    if config and config.get("outputs"):
        return compare_outputs(ref, answers, device, config, model)
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


def compare_outputs(ref, answers, device, config: dict, model: plain.Model) -> Dict[str, float]:
    """`compare` of a configuration's named outputs: ``answers`` hold a dict
    of them for each batch, and the reference returns the same names."""
    dense = [o["name"] for o in config["outputs"] if o["compare"] == "dense"]
    boxes = [o["name"] for o in config["outputs"] if o["compare"] == "detections"]
    inputs = {name: model.layer(name).get("from", []) for name in boxes}
    for name, srcs in inputs.items():
        if not srcs or not set(srcs) <= set(dense):
            raise ValueError(f"detections {name!r}: its inputs {srcs} are not all dense outputs")
    numbers: Dict[str, float] = {}
    frames = 0
    with torch.no_grad():
        for raw, out in answers:
            for i in range(raw.shape[0]):
                r = ref(raw[i:i + 1])
                got = {k: torch.as_tensor(v[i:i + 1]).to(device) for k, v in out.items()}
                for name in dense:
                    want = r[name].double()
                    d = got[name].double().reshape(want.shape) - want
                    numbers["rel_rms_err"] = max(numbers.get("rel_rms_err", 0.0),
                                                 _number((d.norm() / want.norm()).item()))
                    numbers["max_abs_err"] = max(numbers.get("max_abs_err", 0.0),
                                                 _number(d.abs().max().item()))
                for name in boxes:
                    want = plain.layer_forward(model, name, [got[k] for k in inputs[name]])
                    det = detections.compare(got[name].float().cpu().numpy(),
                                             want.float().cpu().numpy())
                    for k in ("det_score_err", "det_box_err"):
                        numbers[k] = max(numbers.get(k, 0.0), _number(det[k]))
                    for k in ("det_unmatched", "det_rows"):
                        numbers[k] = numbers.get(k, 0) + det[k]
                frames += 1
    if not frames:
        return {}
    return {**numbers, "frames": frames}
