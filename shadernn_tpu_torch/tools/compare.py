"""Image / dump comparison (counterpart of shadernn_tpu/tools/compare.py).

Counterpart of tools/misc/imageComparison.py (pixel-diff two PNGs, used by
the reference's end-to-end test test_espcn.sh:45-57) and of the per-layer
CompareMat discipline (testutil.h:1194-1195 thresholds).

CLI:  python -m shadernn_tpu_torch.tools.compare a.png b.png [--threshold 0.01]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_any(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".bin"):
        return np.fromfile(path, "<f4")
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(path)).astype(np.float32) / 255.0


def compare_arrays(a: np.ndarray, b: np.ndarray) -> dict:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    mse = float(np.mean(diff**2))
    return {
        "max_abs_diff": float(diff.max()) if diff.size else 0.0,
        "mean_abs_diff": float(diff.mean()) if diff.size else 0.0,
        "mse": mse,
        "psnr_db": float(10 * np.log10(1.0 / mse)) if mse > 0 else float("inf"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--threshold", type=float, default=0.01,
                    help="max-abs-diff gate (reference FP32 tolerance)")
    args = ap.parse_args(argv)
    stats = compare_arrays(load_any(args.a), load_any(args.b))
    for k, v in stats.items():
        print(f"{k}: {v:.6f}")
    ok = stats["max_abs_diff"] <= args.threshold
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
