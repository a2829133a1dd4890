"""ESPCN (the architecture of Shi et al., arXiv:1609.05158) as ShaderNN's
model zoo ships it (modelzoo/ESPCN/ESPCN_2X_16_16_4.json): convs with
``kernels`` and ``widths``, the last one to channels * scale**2, each but
the last with ``activation``; depth-to-space by ``scale``; then
``output_activation``."""

from __future__ import annotations


def layers(cfg: dict) -> list:
    c, r = cfg["channels"], cfg["scale"]
    widths = list(cfg["widths"]) + [c * r * r]
    ins = [c] + list(cfg["widths"])
    out = []
    for i, (k, ci, co) in enumerate(zip(cfg["kernels"], ins, widths)):
        last = i == len(widths) - 1
        out.append({"name": f"conv_{i + 1}", "op": "conv", "k": k, "cin": ci, "cout": co,
                    "stride": 1, "act": "linear" if last else cfg["activation"]})
    out.append({"name": "subpixel", "op": "depth_to_space", "scale": r})
    out.append({"name": "output", "op": "act", "act": cfg["output_activation"]})
    return out
