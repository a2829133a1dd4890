"""Layer-dump reader/writer: observe intermediate activations (counterpart
of shadernn_tpu/tools/dump_reader.py, in its file layout: each package
reads the other's dumps).

Counterpart of the reference's dump tooling: --dump_outputs writes every
layer's output as binary dumps (openGLRenderpass.cpp:764-899,
core/inferenceCoreDump/<model>/<layer> pass[N].dump) consumed by
tools/misc/readTextureDump.py (binary -> PNG with normalization options)
and readWeightDump.py.

Our dump format: one .npy per layer (exact NHWC float32) written by
`dump_layers`, plus `.bin` raw float32 export for parity with the
reference's dump stream, and `to_png` for visual inspection.

CLI:  python -m shadernn_tpu_torch.tools.dump_reader file.npy [-o out.png]
          [--normalize minmax|255|none] [--channel N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np


def layer_outputs(engine, inputs: Dict[str, object]) -> Dict[str, "torch.Tensor"]:
    """Every layer's output (float32, on the engine's device) of one
    forward of the engine's graph planned with `dump_outputs`: no chains
    and no blocks, so each eligible conv runs alone on the single-conv
    kernel."""
    import torch

    from shadernn_tpu_torch.engine.compile import compile_graph

    opts = dataclasses.replace(engine.options, dump_outputs=True)
    model = compile_graph(engine.graph, opts)
    with torch.no_grad():
        return model(engine._to_device(inputs))["__dumps__"]


def to_host(dumps: Dict[str, "torch.Tensor"]) -> Dict[str, np.ndarray]:
    """The dumped tensors as float32 numpy arrays, moved to the host in one
    copy (one wait for the device, not one per layer)."""
    import torch

    if not dumps:
        return {}
    flat = torch.cat([t.reshape(-1) for t in dumps.values()]).cpu().numpy()
    out, at = {}, 0
    for name, t in dumps.items():
        out[name] = flat[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    return out


def dump_layers(engine, inputs: Dict[str, np.ndarray], out_dir: Optional[str] = None,
                raw_bin: bool = False) -> Dict[str, str]:
    """Run once with per-layer capture and write one file per layer into
    `out_dir` (default: the engine's `options.dump_dir`).

    Returns {layer_name: path}. Mirrors the reference's
    core/inferenceCoreDump layout: <out_dir>/<model>/<layer>.npy
    """
    dumps = to_host(layer_outputs(engine, inputs))
    model_dir = os.path.join(out_dir or engine.options.dump_dir, engine.graph.name)
    os.makedirs(model_dir, exist_ok=True)
    paths = {}
    for name, arr in dumps.items():
        safe = name.replace("/", "_")
        if raw_bin:
            p = os.path.join(model_dir, f"{safe}.bin")
            arr.astype("<f4").tofile(p)
            with open(p + ".meta.json", "w") as f:
                json.dump({"shape": list(arr.shape), "dtype": "float32"}, f)
        else:
            p = os.path.join(model_dir, f"{safe}.npy")
            np.save(p, arr)
        paths[name] = p
    return paths


def dump_weights(graph, out_dir: str) -> Dict[str, str]:
    """Write every layer's weight tensors (readWeightDump.py parity:
    observe exactly what the engine will compute with, post BN-folding /
    quantization)."""
    model_dir = os.path.join(out_dir, graph.name, "weights")
    os.makedirs(model_dir, exist_ok=True)
    paths = {}
    for node in graph.nodes.values():
        for pname, arr in node.params.items():
            safe = f"{node.name}.{pname}".replace("/", "_")
            p = os.path.join(model_dir, safe + ".npy")
            np.save(p, np.asarray(arr))
            paths[f"{node.name}.{pname}"] = p
    return paths


def read_dump(path: str, shape=None) -> np.ndarray:
    """Read a .npy or raw .bin dump (with sibling .meta.json or explicit
    shape, matching readTextureDump.py's usage)."""
    if path.endswith(".npy"):
        return np.load(path)
    meta = path + ".meta.json"
    data = np.fromfile(path, "<f4")
    if shape is None and os.path.exists(meta):
        shape = json.load(open(meta))["shape"]
    return data.reshape(shape) if shape else data


def to_png(arr: np.ndarray, out_path: str, normalize: str = "minmax",
           channel: Optional[int] = None, batch_index: int = 0) -> None:
    """Dump tensor -> PNG (readTextureDump.py's normalization options:
    min-max rescale, fixed /255, or raw clip)."""
    from PIL import Image as PILImage

    a = np.asarray(arr, np.float32)
    if a.ndim == 4:
        a = a[batch_index]
    if channel is not None:
        a = a[..., channel : channel + 1]
    if a.shape[-1] not in (1, 3):
        a = a[..., :1]
    if normalize == "minmax":
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / (hi - lo + 1e-12)
    elif normalize == "255":
        a = a / 255.0
    img = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.shape[-1] == 1:
        img = img[..., 0]
    PILImage.fromarray(img).save(out_path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dump", help=".npy or .bin dump file")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--normalize", default="minmax", choices=["minmax", "255", "none"])
    ap.add_argument("--channel", type=int, default=None)
    ap.add_argument("--shape", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    arr = read_dump(args.dump, tuple(args.shape) if args.shape else None)
    out = args.output or os.path.splitext(args.dump)[0] + ".png"
    to_png(arr, out, args.normalize, args.channel)
    print(f"{args.dump}: shape={arr.shape} min={arr.min():.4f} "
          f"max={arr.max():.4f} -> {out}")


if __name__ == "__main__":
    main()
