"""Accuracy metrics (counterparts of shadernn_tpu/utils/metrics.py):
PSNR, the super-resolution gate, and the precision-delta report that holds
a low-precision engine against an FP32 one on the same inputs."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def psnr(a, b, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (super-resolution gate)."""
    mse = float(np.mean((_np(a).astype(np.float64) - _np(b).astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def agreement_rate(logits_a, logits_b) -> float:
    """Fraction of identical argmax decisions between two precision modes."""
    return float(np.mean(np.argmax(_np(logits_a), -1) == np.argmax(_np(logits_b), -1)))


def precision_delta_report(engine_fp32, engine_low, inputs: Dict[str, np.ndarray],
                           kind: str = "classification") -> dict:
    """Compare two precision modes on the same inputs: max-abs-diff, and
    top-1 agreement (classification) or PSNR (kind="sr")."""
    x = next(iter(inputs.values()))
    a = _np(engine_fp32.run_single(x))
    b = _np(engine_low.run_single(x))
    rep = {"max_abs_diff": float(np.max(np.abs(a - b)))}
    if kind == "classification":
        rep["top1_agreement"] = agreement_rate(a, b)
    elif kind == "sr":
        rep["psnr_db"] = psnr(a, b)
    return rep
