"""The precision controls of the check: what must come out not correct.

- `Int8Program`: the program with its own INT8 path switched on in full
  (int8 weights, activation scales calibrated by absolute max on seeded
  frames, int8 products where the program takes them), the nearest
  precision below the configurations' BF16.
- `ReferenceProgram` with `fp8`: the plain reference in the program's
  place, every weight and every conv input rounded to float8 e4m3 with a
  per-tensor scale (products of fp8 values, float32 sums).
"""

from __future__ import annotations

import torch

from benchmark.harness import check, spec
from benchmark.harness.program import Program
from benchmark.harness.traffic import device_frames

CALIBRATION_SEED = 7


class Int8Program(Program):
    def __init__(self, root, config, batch, device="cuda"):
        super().__init__(root, config, batch, device, precision="int8")
        inp = config["input"]
        self.calibrate(device_frames(CALIBRATION_SEED, batch, inp["height"], inp["width"],
                                     inp["channels"], self.device))


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / t.abs().max().clamp(min=1e-12)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class ReferenceProgram:
    """The plain reference in fp8 behind the closed loops' entries."""

    def __init__(self, root, config, batch, device="cuda"):
        self.device = torch.device(device)
        self._ref = check.reference_model(root, config, spec.model(config, root), self.device)
        self.out_name = "output"

    def step(self, entry):
        return lambda raw: self._ref(raw, fp8)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self):
        self._ref = None
