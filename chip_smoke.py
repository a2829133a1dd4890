#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, an H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. env      torch / CUDA / nvcc versions, the card's name and power limit
  2. build    nvcc builds shadernn_tpu_torch/csrc/*.cu from the checkout
  3. kernel   the conv-chain kernel through both entry points against its
              plain PyTorch version on the card, at the main path's shapes
              and at edge geometries
  4. main     ESPCN 2x at 540p, trained weights, batch 8, through
              Engine.from_json at BF16 and at FP32, 5 steps each; every
              step must launch the kernel once; the output is checked
              against the port's plain (TORCH backend) forward on the card
  5. timing   kernel, plain version, a cuDNN yardstick and the bound
Prints the `kernels` JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Imports no JAX and nothing of
the JAX package. Exits non-zero without printing a result when no CUDA
device is present or when the port's package is not beside this script.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
TOL_FP32 = 1e-4  # summation order only
# bf16: another summation order can flip one bf16 rounding of an
# intermediate (2^-8 at |y| ~ 1), carried through two layers.
TOL_BF16 = 0.03
ENGINE_TOL = {"bf16": 0.1, "fp32": 0.01}  # tests/conftest.py thresholds

# Published peaks (dense) per card: bytes/s, bf16 FLOP/s, f32 FLOP/s
# (CUDA cores; TF32 is not an fp32-exact path).
PEAKS = {
    "H100 SXM": (3.35e12, 989e12, 67e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return key, PEAKS[key]


class _Node:
    """A Conv2D node as the chain planner reads it."""

    def __init__(self, k, o, act, w, b, padding="same"):
        self.attrs = dict(kernel_size=k, out_channels=o, activation=act,
                          padding=padding, stride=1, use_bias=True)
        self.params = dict(weight=w, bias=b)

    def attr(self, key, default=None):
        return self.attrs.get(key, default)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "shadernn_tpu_torch")):
        print("chip_smoke: shadernn_tpu_torch/ not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.config import BackendKind
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import _build, chain
    from shadernn_tpu_torch.models.zoo import ESPCN_TRAINED
    from shadernn_tpu_torch.ops.conv import full_precision
    from shadernn_tpu_torch.ops.shape_ops import depth_to_space

    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32

    # 1. env ---------------------------------------------------------------
    card = smi()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc}'")
    log(f"[env] {card} | devices {torch.cuda.device_count()}")
    peak_key, (peak_bw, peak_bf16, peak_f32) = peaks_for(name)

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _, build_log = _build.build(force=True)
    log(f"[build] nvcc {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    _build.kernel_lib()

    # 3. kernel vs plain ---------------------------------------------------
    rng = np.random.default_rng(7767517)
    trained = parse_model_file(ESPCN_TRAINED)
    espcn_nodes = [trained.nodes[n] for n in ("conv_1", "conv_2", "conv_3")]

    def on_dev(ops):
        return [{k: v.to(dev) for k, v in d.items()} for d in ops]

    def random_chain(cfg, cin):
        nodes, c = [], cin
        for k, o, act in cfg:
            w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
            b = (rng.standard_normal(o) * 0.1).astype(np.float32)
            nodes.append(_Node(k, o, act, w, b))
            c = o
        return nodes

    def case(label, nodes, cin, dt, tail, shape, entry, act_override=None):
        specs = chain.build_chain_specs(nodes, cin, dt, act_override=act_override, tail=tail)
        assert specs is not None, f"{label}: the kernel's gate declined the chain"
        ops = on_dev(chain.chain_operands(nodes, dt))
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        got = getattr(chain, entry)(x, ops, specs, tail=tail, compute_dtype=dt)
        torch.cuda.synchronize()
        want = chain.conv_chain_reference(x, ops, specs, tail, dt)
        assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        tol = (TOL_BF16 if dt == bf16 else TOL_FP32) * scale
        ok = err <= tol and torch.isfinite(got.float()).all().item()
        log(f"[kernel] {label:<34} {entry:<24} max_abs_diff {err:.3e} tol {tol:.1e} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, f"{label}: kernel disagrees with its plain version"
        return err

    errs = {}
    tanh = ("tanh", 0.3)
    for nb in (1, 8):
        errs[("bf16", nb)] = case(f"espcn bf16 d2s2 540x960 b{nb}", espcn_nodes, 1, bf16,
                                  "d2s2", (nb, 540, 960, 1), "fused_conv_chain_packed", tanh)
        errs[("fp32", nb)] = case(f"espcn fp32 none 540x960 b{nb}", espcn_nodes, 1, f32,
                                  "none", (nb, 540, 960, 1), "fused_conv_chain")
    c1 = random_chain([(3, 8, "relu"), (3, 1, "linear")], 4)
    case("c1 two-layer 64x96 b2", c1, 4, f32, "c1", (2, 64, 96, 4), "fused_conv_chain_packed")
    case("c1 two-layer 64x96 b2", c1, 4, bf16, "c1", (2, 64, 96, 4), "fused_conv_chain")
    k4 = random_chain([(4, 16, "leaky_relu"), (4, 8, "sigmoid"), (3, 4, "gelu")], 2)
    case("even k=4 chain 50x70 b2", k4, 2, f32, "none", (2, 50, 70, 2), "fused_conv_chain")
    case("even k=4 chain 50x70 b2", k4, 2, bf16, "d2s2", (2, 50, 70, 2), "fused_conv_chain_packed")
    case("ragged espcn 37x101 b3", espcn_nodes, 1, bf16, "d2s2", (3, 37, 101, 1),
         "fused_conv_chain_packed", tanh)
    case("ragged espcn 37x101 b3", espcn_nodes, 1, f32, "none", (3, 37, 101, 1),
         "fused_conv_chain")

    # 4. main path -----------------------------------------------------------
    frames = rng.random((8, 540, 960, 1), dtype=np.float32)
    main_stats = {}
    for prec, entry in ((Precision.BF16, "fused_conv_chain_packed"),
                        (Precision.FP32, "fused_conv_chain")):
        opts = EngineOptions(precision=prec, batch_size=8)
        eng = Engine.from_json(ESPCN_TRAINED, opts, input_hw=(540, 960))
        for k in chain.launches:
            chain.launches[k] = 0
        outs = [eng.run_single(frames) for _ in range(STEPS)]
        counts = dict(chain.launches)
        y = outs[-1]
        assert tuple(y.shape) == (8, 1080, 1920, 1), y.shape
        assert torch.isfinite(y).all().item() and y.abs().max().item() <= 1.0
        assert counts[entry] == STEPS, counts
        assert sum(counts.values()) == STEPS, counts
        plain = Engine.from_json(
            ESPCN_TRAINED,
            EngineOptions(precision=prec, batch_size=8, backend=BackendKind.TORCH),
            input_hw=(540, 960),
        ).run_single(frames)
        err = (y - plain).abs().max().item()
        tol = ENGINE_TOL[prec.value]
        step_ms = [1e3 * s for s in eng.stats.total.samples[1:]]
        bench = eng.benchmark({"input": frames}, loops=20)
        log(f"[main] {prec.value} plan {eng.model.forward.chain_plan} launches {counts} "
            f"vs TORCH forward max_abs_diff {err:.3e} tol {tol} "
            f"run() host ms {['%.3f' % s for s in step_ms]} "
            f"device step p50 {bench['p50_ms']:.3f} ms")
        assert err <= tol, f"{prec.value}: engine output disagrees with the plain forward"
        main_stats[entry] = {"launches": counts[entry], "max_abs_err": err,
                             "engine_p50_ms": bench["p50_ms"]}
        del eng, outs, y, plain

    # 5. timings -------------------------------------------------------------
    def time_ms(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in evs)

    macs_px = sum(int(np.prod(n.params["weight"].shape)) for n in espcn_nodes)
    rows = {}
    for dt, entry, tail in ((bf16, "fused_conv_chain_packed", "d2s2"),
                            (f32, "fused_conv_chain", "none")):
        act = tanh if tail == "d2s2" else None
        specs = chain.build_chain_specs(espcn_nodes, 1, dt, act_override=act, tail=tail)
        ops = on_dev(chain.chain_operands(espcn_nodes, dt))
        w_lib = [n.params["weight"] for n in espcn_nodes]
        w_lib = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(dev, dt)
                 .contiguous(memory_format=torch.channels_last) for w in w_lib]
        b_lib = [torch.from_numpy(n.params["bias"]).to(dev, dt) for n in espcn_nodes]
        for nb in (1, 8):
            x = torch.from_numpy(frames[:nb]).to(dev)
            xl = x.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=torch.channels_last)

            def library():
                with full_precision():
                    y = F.conv2d(xl, w_lib[0], b_lib[0], padding=2).relu_()
                    y = F.conv2d(y, w_lib[1], b_lib[1], padding=1).relu_()
                    y = F.conv2d(y, w_lib[2], b_lib[2], padding=1)
                y = y.permute(0, 2, 3, 1)
                return torch.tanh(depth_to_space(y, 2)) if tail == "d2s2" else y.contiguous()

            k_ms = time_ms(lambda: getattr(chain, entry)(x, ops, specs, tail=tail, compute_dtype=dt))
            p_ms = time_ms(lambda: chain.conv_chain_reference(x, ops, specs, tail, dt))
            l_ms = time_ms(library)
            flops = 2.0 * nb * 540 * 960 * macs_px
            out_bytes = nb * 540 * 960 * 4 * (2 if dt == bf16 else 4)
            nbytes = x.numel() * 4 + out_bytes + sum(
                p["w"].numel() * p["w"].element_size() + 8 * p["scale"].numel() for p in ops)
            t_ops = flops / (peak_bf16 if dt == bf16 else peak_f32) * 1e3
            t_bytes = nbytes / peak_bw * 1e3
            rows[(entry, nb)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                     bound_ms=max(t_ops, t_bytes),
                                     bound_by="operations" if t_ops >= t_bytes else "bytes")
            r = rows[(entry, nb)]
            log(f"[timing] {entry:<24} {'bf16 d2s2' if dt == bf16 else 'fp32 none'} 540x960 "
                f"b{nb}: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms cudnn {l_ms:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB, {peak_key} peaks) | {card}")

    kernels = []
    for entry, replaces, prec in (
        ("fused_conv_chain_packed", "shadernn_tpu/kernels/chain_packed_pallas.py:121", "bf16"),
        ("fused_conv_chain", "shadernn_tpu/kernels/chain_pallas.py:79", "fp32"),
    ):
        r = rows[(entry, 8)]
        kernels.append({
            "name": f"conv_chain.{entry}",
            "route": "cuda",
            "source": "shadernn_tpu_torch/csrc/conv_chain.cu",
            "replaces": replaces,
            "launches": main_stats[entry]["launches"],
            "max_abs_err": errs[(prec, 8)],
            "max_abs_diff": errs[(prec, 8)],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"{prec} 8x540x960x1",
            "engine_step_p50_ms": main_stats[entry]["engine_p50_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
