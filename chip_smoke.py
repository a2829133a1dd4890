#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, an H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. env      torch / CUDA / nvcc versions, the card's name and power limit
  2. build    nvcc builds shadernn_tpu_torch/csrc/*.cu from the checkout,
              one process per source
  3. kernel   each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at edge geometries: the conv-chain
              kernel through both entry points, and at every chain of the
              trained ResNet18's plan (b64), each bf16 case from an f32 and
              from a bf16 input; its edges: a dense-tap head at k9 (C = 1)
              and at C = 3, o = 32, 8 layers, an image smaller than one
              tile at b1; the chain's fp32 form (3xTF32) at every chain
              of the FP32 plans read from the engines (ESPCN 540p b8, the
              trained ResNet18's two at b64), every fp32 case also from a
              bf16 input, the largest layer the gate admits (k9 C16 o32,
              weights staged pass by pass), a k9 C32 head whose weights are
              staged as f32 values and split in registers, 8 layers up to
              o = 32, int8 weights (two passes) and |x| ~ 1e2 through a
              linear chain with its error against float64; the inverted-residual block
              kernel at every block geometry of MobileNetV2 224 (b8), every
              block geometry of the trained model at its batch (b64) and a
              ragged 13x9 block, bf16 and fp32; the single-conv kernel at the
              trained model's folded stem, k5 c1->16, k3 c128->128 with
              asymmetric pads, every distinct geometry of the single-conv
              plans of both ResNet18 paths at their batch (b8, b64) with the
              models' folded weights, and the edges of its bf16 form (O = 10,
              a multi-image tile the batch does not fill, C = 3, taps in
              several stages, k11) and the largest K the gate admits (k8
              c64), bf16 from f32 and from bf16 inputs, fp32 (3xTF32) from
              f32 inputs at |x| ~ 1 and ~ 1e2 and from bf16 inputs; the
              block's fp32 edges: |x| ~ 1e2 through the widest block
              (160->960->320, linear) and the ragged one, int8 weights
              (the f32 form's two-pass instantiation), a block whose
              weights fit one buffer; the implicit-GEMM conv
              kernel (bf16 and 3xTF32 on the tensor cores) at the
              ResNet-wide shapes, 540p frames, even k with asymmetric
              pads, stride 2 (also with asymmetric pads), C = 3 with O = 10,
              K = 4096, channel blocks whose last is partial, int8
              weights, and the two-input graph's conv in all
              four operand forms (x f32 or bf16, w float or int8); the fused-matmul
              kernel at the classifier heads (softmax rows must sum to 1),
              a ragged shape, int8 weights (bf16 x too), M = 1, N = 1001,
              K = 1, many row and column blocks, and two softmax launches
              back to back on the same arrival counters; the YOLO NMS
              kernel at the 416 b8 shapes (8 x 2,535 candidates, the 100
              best) bit for bit against nms_fixed, one launch a call, an
              IoU threshold of 0.55 as a planted fault
  4. main     ESPCN 2x at 540p, trained weights, batch 8, through
              Engine.from_json at BF16 and at FP32, 5 steps each; every
              step must launch the chain kernel once. MobileNetV2 224
              (seeded weights and BatchNorm statistics), batch 8, through
              Engine.from_graph at BF16 and FP32, 5 steps each: every step
              launches the block kernel 11 times and no other kernel; a
              block with a planted fault must fail the logits check; device
              busy split into the hand-written kernels and the rest. The
              trained MobileNetV2 (10
              classes) through Engine.from_json at b64: 13 blocks and one
              single conv per step, top-1 >= 0.9 on 256 images of its task.
              With every node forced to KERNEL: ResNet18 at the zoo width
              (seeded weights and BatchNorm statistics, b8) and the trained
              ResNet18 (b64, top-1 >= 0.95 at FP32, BF16 within 0.03 of it),
              each step launching the fused matmul once and the chain and
              single-conv kernels as planned; a two-input conv graph at 540p
              b8, each step launching the implicit-GEMM conv kernel once; a
              zeroed classifier, a zeroed single conv of the trained ResNet18
              and a dropped conv tap must fail the checks.
              Outputs are checked against the port's plain (TORCH backend)
              forward on the card (the classifiers on probabilities and
              logits)
  3b/4b int8  every configuration above (ESPCN, MobileNetV2 224 with a
              linear head, the trained MobileNetV2, the trained ResNet18
              under AUTO with a linear head; forced to KERNEL the zoo-width
              ResNet18 and the two-input graph) under Precision.INT8,
              weight-only, and (but the last two) calibrated on the card over
              a batch drawn from seed 7 (absolute-max ranges, as the JAX
              package's INT8 gates calibrate). [kernel] cases of every int8 form at
              the plans' geometries with the models' quantized weights: the
              chain with int8 weights (ESPCN, the trained ResNet18's chains)
              and with a8 layers (ESPCN's plan; a chain whose head quantizes
              the frame), every block of both MobileNetV2s weight-only and
              A8W8, the single convs of the trained ResNet18 and the trained
              MobileNetV2's stem, the two-input conv and both ResNet18 heads
              with int8 weights; planted faults (a chain layer's in_q
              halved, a block's ax2 doubled, a single conv's weight_scale
              zeroed) must be caught. Each path: launches per step held to
              its plans, outputs to the port's TORCH INT8 forward; ESPCN's
              weight-only PSNR against FP32 > 30 dB and a8 within 0.1 of
              weight-only; both trained classifiers' top-1 >= their FP32
              top-1 - 0.05; ResNet18 with >= 5 nodes stamped
  5. timing   kernel, plain version and a library yardstick (cuDNN, cuBLAS),
              each from CUDA events around back-to-back calls and as device time from
              torch.profiler; the bound. The chain at ESPCN 540p (b1, b8) and at
              the trained ResNet18's chain (b64); per-step sums: the 11 block
              launches of a MobileNetV2 224 b8 step, the 8 single-conv launches of
              a ResNet18 zoo-width b8 step; the fused matmul at the three heads,
              each call's device work held to one kernel. INT8: the chain at
              ESPCN 540p b8 with int8 weights and with a8 layers, the 11 blocks
              of a MobileNetV2 224 b8 step weight-only and A8W8, the
              single-conv launches of an INT8 step of each trained
              classifier (b64), each beside its bf16 form, bound at the int8
              peak for s8 products; int8 weights in the chain's im2col entry
              at the trained ResNet18's chain (b64), the implicit-GEMM conv
              at the two-input graph (b8; also its fp32 form on the int8
              weights) and the fused matmul at both
              ResNet18 heads, each beside its plain version and the library
              call on the weights cast to bf16. Every fp32 line also prints
              the bound in 3xTF32 (a third of the TF32 peak)
  6. zoo      the rest of the model zoo through Engine.from_json, each trained
              artifact at full width and depth (zoo_phase): SpatialDenoise
              and AIDenoise at 1080x1920 b2 (BF16, FP32, INT8 weight-only;
              one chain per step), U-Net 256 b8 (BF16, FP32; three chains and
              one single conv), the five StyleTransfer styles at 512 b4 (FP32,
              candy also BF16; two single convs), YOLOv3-tiny 256 b8 (FP32,
              BF16; one single conv; head features and detections), each
              against the TORCH forward with its launches held to its plans;
              the JAX package's accuracy gates (denoiser PSNR at 96, style
              PSNR at 64 and 512, YOLO mAP); [kernel] cases at every chain and
              single conv of these plans with the models' weights; the
              single-conv kernel's wide body (StyleTransfer's k9 stem and
              head) at its edges (O = 1, 8, 9, 40; int8 weights; f32 and bf16
              inputs; ragged tiles; b1; a 9x3 kernel, which fp32 runs on the
              tile body); the packed bf16 stem launched 100 more times, each
              output equal to the first bit for bit; planted faults (U-Net's
              transposed-conv kernel flipped; the stem's weight mirrored
              along W through the wide body); [timing] rows of each new launch shape, the wide body's
              beside the tile body (the parent's launch)
  7. serve    the serving layer (serve_phase): ESPCN 2x (trained) at 540p b8
              BF16 under StreamingEngine, 4 producer threads x 64 frames of
              raw uint8 luma through the on-device ingest and the same
              frames as float32, each at max_inflight 1 and 4: stats()
              (throughput, p50/p99 latency, fetch ms, fill, padding) beside
              the step-only rate and one batch's download alone; every
              served frame against Engine.run of the same normalized frame,
              one chain launch per served batch, the overlap from the
              batches' timestamps, two frames' outputs swapped as a planted
              fault. YOLOv3-tiny (trained) 256x256 b8 BF16 served: 32 scenes,
              detections box to box against Engine.run, mAP >= 0.45, one
              single-conv launch per batch. ExportedEngine (ESPCN BF16 and
              FP32 b8: outputs, plans, launches; the BF16 one served for 64
              frames, "ready in"), InferenceProcessor and Engine.classify
              against Engine.run, trace_benchmark within 5% of phase 4's
              busy time, device_benchmark, the per-layer report at the
              card's peaks, NV12 and 1080p -> 540p ingest on the card,
              run_model(image_path=) where Pillow is installed
  8. io       model I/O and the demo CLI (io_phase): the trained ESPCN 540p
              b8 (BF16, FP32), MobileNetV2 cls10 b64 BF16 and ResNet18 cls10
              b64 BF16 forced to KERNEL through export_onnx -> parse_onnx ->
              convert_onnx_graph -> Engine.from_graph, and those four and
              StyleTransfer-candy 512 b4 FP32 through save_model (inline and
              decoupled) -> Engine.from_json, each held to the native engine:
              the same launches per step, the output bit-equal where the
              weights are, else within ENGINE_TOL; step p50 of both and the
              imported step's device ms per launch. ESPCN's layer dumps at
              540p b8 (BF16, FP32): 3 single-conv launches a step and no
              chain, every layer against the TORCH backend's dump, a
              perturbed layer as a planted fault, the dump-mode step beside
              the chained one; run_model(dump_dir=) files read back equal
              and reported equal by tools/compare.py. The demo CLI on the
              card: `list` as a subprocess; run, profile, stream and serve
              (cold export, then a warm start) through main()
  9. train    the six trainers (tools/train_*.py) at the JAX defaults
              (train_phase): ResNet18 base 16 b128, MobileNetV2 w0.5 32x32
              b128, the three denoisers 64 b16, StyleTransfer 64 b32,
              YOLOv3-tiny 256 b16, ESPCN patch 64 b32. Step 0's loss and
              every gradient on the card (TF32 off) against the same step
              on the CPU, each tensor within 1e-4 of the largest, a scaled
              gradient as a planted fault, TF32 in the backward printed
              beside it; 5 steps with finite losses, step ms apart from the
              host's batch-making, no hand-written kernel launched. ResNet18's
              whole run (600 steps) to held-out top-1 >= 0.95, exported to
              build/trained/ and reloaded at BF16 AUTO b64: launches held to
              its plans, output within ENGINE_TOL of the TORCH forward
 10. accuracy the port's accuracy report on the card (accuracy_phase) into
              build/accuracy/Accuracy.md: exit 0, every row held to
              docs/Accuracy.md (trained rows within 0.1 dB / 0.02 top-1 /
              0.03 mAP, zoo rows above the JAX gates), the chain kernel in
              both forms, the single-conv and the block kernels launched
 11. parallel the sharded engines (parallel_phase) on logical meshes of the
              card: ESPCN 2x (trained) 540p b8 AUTO at BF16 (2,2,2) and
              (1,2,4), FP32 and INT8 weight-only (2,2,2), 24 implicit-GEMM
              conv launches a step (one per shard and kernel conv), within
              ENGINE_TOL of the single-device engine and of the
              TORCH-sharded run; MobileNetV2 224 b8 (2,4,1) and (1,2,2),
              ResNet18 zoo b8 (1,1,4), StyleTransfer-candy 512 b4 (1,1,4),
              YOLOv3-tiny 256 b8 FP32 (1,1,2) against their single-device
              engines; [kernel] cases at every sharded launch shape; a
              wrong halo fill and a reversed TP gather must be caught; the
              2-process multihost smoke on the card; the executor's
              overhead over 1-8 logical shards; [timing] rows
 12. pipeline the last modules (pipeline_phase): the native host runtime
              built from the checkout by the host compiler, each function
              bit-equal to its numpy version on the trained ESPCN's and
              MobileNetV2's weight streams and a 1080p NV12/NV21 frame,
              1,000 frames through its ring across two threads, the trained
              ESPCN loaded through it; PipelinedEngine (one CUDA stream per
              stage): ESPCN 2x (trained) 540p b8 AUTO at BF16 and FP32, 4
              stages on [cuda:0] * 4, micro_batch 2, 12 implicit-GEMM conv
              launches a step, within ENGINE_TOL of Engine.run and of a
              TORCH pipeline; PP x DP (2 stages of [cuda:0, cuda:0]); U-Net
              256 b8 (skips cross stages); throughput_stats and the dry
              run's overlap gate; reversed micro-batches as a planted fault;
              ElasticEngine (ESPCN 540p b8 BF16, data 4 on [cuda:0] * 4): an
              injected failure on entry 3 (data 4 -> 2, B5 12 -> 6 per
              engine step), shrunk to one entry (the chain kernel once per
              bucket), and real device-side hangs (torch.cuda._sleep, watchdog
              0.2 s): ~1 s surfaced as StepTimeout, then a completed step; ~1 s
              recovered inside run(); one that outlasts every deadline, where
              run() must give up in bounded time); [kernel]
              cases at every B5 and B1 launch shape of these paths; [timing]
              rows (the pipelined step beside the single-device one, device
              busy, idle share; B5 at the pipeline's shapes)
Prints the `kernels` JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Imports no JAX and nothing of
the JAX package. Exits non-zero without printing a result when no CUDA
device is present or when the port's package is not beside this script.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
TOL_FP32 = 1e-4  # summation order only
# bf16: another summation order can flip one bf16 rounding of an
# intermediate (2^-8 at |y| ~ 1), carried through two layers.
TOL_BF16 = 0.03
ENGINE_TOL = {"bf16": 0.1, "fp32": 0.01}  # tests/conftest.py thresholds

def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    from shadernn_tpu_torch.graph import fusion
    from shadernn_tpu_torch.graph.ir import Graph, Node
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import (
        _build, chain, conv, conv_igemm, invres, launch_counts, matmul,
    )
    from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2
    from shadernn_tpu_torch.models.resnet18 import build_resnet18_cifar10
    from shadernn_tpu_torch.models.zoo import (
        ESPCN_TRAINED, MOBILENETV2_TRAINED, RESNET18_TRAINED,
    )
    from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
    from shadernn_tpu_torch.ops.conv import a8w8_engaged, folded_operands, full_precision
    from shadernn_tpu_torch.ops.registry import RunCtx
    from shadernn_tpu_torch.ops.shape_ops import depth_to_space
    from shadernn_tpu_torch.quant.calibrate import calibrate_activations
    from shadernn_tpu_torch.tools.train_resnet18 import synth_cls
    from shadernn_tpu_torch.utils.metrics import psnr
    from shadernn_tpu_torch.utils.profiler import peaks_for
    from shadernn_tpu_torch.utils.trace_profile import HAND_WRITTEN, device_profile

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
    # The card's published dense peaks (utils/profiler.py PEAKS). The fp32
    # forms of the kernels run 3xTF32 (three TF32 products per f32 product,
    # about f32's accuracy): their work is bounded at a third of the TF32
    # peak, printed beside the CUDA-core bound.
    peak_key, (peak_bw, peak_bf16, peak_f32, peak_tf32, peak_int8) = peaks_for(name)

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _, build_log = _build.build(force=True)
    log(f"[build] nvcc {time.perf_counter() - t0:.1f} s")
    def kernel_of(line):
        """(kernel name, the mangled rest) of a ptxas 'Compiling entry' line:
        the name is the length-prefixed identifier ending in _kernel (the
        length's digits may follow a hash's)."""
        mangled = line.split("'")[1] if "'" in line else line
        for m in re.finditer(r"\d+", mangled):
            for j in range(len(m.group())):
                size = int(m.group()[j:])
                ident = mangled[m.end():m.end() + size]
                if len(ident) == size and re.fullmatch(r"[a-z_][a-z0-9_]*_kernel", ident):
                    return ident, mangled[m.end() + size:]
        return "", ""

    kernel_name = ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:  # the mangled name: kernel and template arguments
            ident, rest = kernel_of(line)
            args = rest.split("Ev", 1)[0] if rest.startswith("I") else ""
            targs = re.findall(r"Li(\d+)E", args) + (
                ["bf16"] if "bfloat16" in args else
                ["f32"] if re.search(r"(?:^I|E)f(?:E|L)", args) else [])
            if ident == "conv_igemm_tc_kernel":  # <NT, F32>
                targs.append("f32" if "Lb1E" in args else "bf16")
            elif "Lb1E" in args:
                targs.append("int8")
            kernel_name = ident + (f"<{','.join(targs)}>" if targs else "")
        elif "registers" in line or "spill" in line:
            log(f"[build] {kernel_name:<32} {line.strip()}")
    _build.kernel_lib()

    # 3. kernel vs plain ---------------------------------------------------
    rng = np.random.default_rng(7767517)
    trained = parse_model_file(ESPCN_TRAINED)
    espcn_nodes = [trained.nodes[n] for n in ("conv_1", "conv_2", "conv_3")]

    def on_dev(ops):
        return [{k: v.to(dev) for k, v in d.items()} for d in ops]

    def held(label, entry, got, want, dt):
        """Kernel output against its plain version: max-abs-diff within
        TOL * max(1, max|plain|), finite, same shape and dtype."""
        assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        tol = (TOL_BF16 if dt == bf16 else TOL_FP32) * scale
        ok = err <= tol and torch.isfinite(got.float()).all().item()
        log(f"[kernel] {label:<34} {entry:<24} max_abs_diff {err:.3e} tol {tol:.1e} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, f"{label}: kernel disagrees with its plain version"
        return err

    def random_chain(cfg, cin):
        nodes, c = [], cin
        for k, o, act in cfg:
            w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
            b = (rng.standard_normal(o) * 0.1).astype(np.float32)
            nodes.append(_Node(k, o, act, w, b))
            c = o
        return nodes

    def case(label, nodes, cin, dt, tail, shape, entry, act_override=None):
        """One chain against its plain version, from an f32 input (bf16:
        rounded on staging) and from a bf16 input (the bf16 engine's; the
        fp32 form takes it exact in TF32, without its lo pass)."""
        specs = chain.build_chain_specs(nodes, cin, dt, act_override=act_override, tail=tail)
        assert specs is not None, f"{label}: the kernel's gate declined the chain"
        ops = on_dev(chain.chain_operands(nodes, dt))
        err = 0.0
        for x_dt in (f32, bf16):
            x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, x_dt)
            got = getattr(chain, entry)(x, ops, specs, tail=tail, compute_dtype=dt)
            torch.cuda.synchronize()
            tag = f" {'bf16' if dt == bf16 else 'fp32'} x {'bf16' if x_dt == bf16 else 'f32'}"
            err = max(err, held(label + tag, entry, got,
                                chain.conv_chain_reference(x, ops, specs, tail, dt), dt))
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
    # Edges of the bf16 form: a dense-tap head at k9 (C = 1) and at C = 3,
    # o = 32 with C padded to 24 and 32, 8 layers (every unit stride and
    # both dense layers), an image smaller than one tile at b1.
    for label, cfg, cin, tail, shape in (
        ("C1 k9 40x50 b2", [(9, 8, "relu"), (3, 1, "sigmoid")], 1, "c1", (2, 40, 50, 1)),
        ("C3 33x45 b2", [(3, 20, "gelu"), (3, 4, "linear")], 3, "d2s2", (2, 33, 45, 3)),
        ("o32 C24 30x41 b2", [(3, 32, "relu"), (1, 32, "leaky_relu"), (3, 12, "relu6")], 24,
         "none", (2, 30, 41, 24)),
        ("8 layers 29x37 b2", [(3, 8, "relu"), (3, 12, "silu"), (1, 16, "relu"), (3, 9, "tanh"),
                               (2, 17, "relu"), (3, 16, "relu"), (3, 5, "sigmoid"),
                               (3, 4, "gelu")], 2, "none", (2, 29, 37, 2)),
        ("smaller than a tile 5x7 b1", [(3, 16, "relu"), (3, 4, "linear")], 1, "d2s2",
         (1, 5, 7, 1)),
    ):
        nodes = random_chain(cfg, cin)
        for dt in (bf16, f32):
            case(label, nodes, cin, dt, tail, shape, "fused_conv_chain")

    # The chain's fp32 form (3xTF32): the ESPCN FP32 engine's own plan (its
    # optimized graph folds the tanh into the last layer), with its launch
    # geometry; the trained ResNet18's two chains run above. Then the
    # form's edges: the largest layer the gate admits (its hi and lo weights
    # staged pass by pass), a k9 C32 head under two more layers (its pass
    # staged as f32 values, B split in registers), 8 layers up to o = 32, a
    # C = 1 k5 head with a c1 tail, and inputs at |x| ~ 1e2 through a linear
    # chain, whose error against float64 is printed beside the plain
    # version's.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def f32_geometry(label, specs, shape):
        g = chain.f32_launch_geometry(tuple(specs), *shape[:3], sms)
        log(f"[kernel] {label}: f32 launch tile {g.tile_h}x{g.tile_w}, {g.threads} threads, "
            f"{'weights resident' if g.w_all else 'weights staged per pass'}"
            f"{' (f32 values, split in registers)' if any(l[10] for l in g.layers) else ''}, "
            f"{g.grid} persistent CTAs, {g.smem} B shared memory")
        return g

    espcn_fp32 = Engine.from_json(ESPCN_TRAINED, EngineOptions(precision=Precision.FP32,
                                                               batch_size=8), input_hw=(540, 960))
    fwd = espcn_fp32.model.forward
    assert list(fwd.chain_plan) == ["conv_1"], fwd.chain_plan
    plan_specs = fwd.chain_specs["conv_1"]
    plan_ops = on_dev(chain.chain_operands(
        [espcn_fp32.graph.nodes[m] for m in fwd.chain_plan["conv_1"]], f32, plan_specs))
    f32_geometry("espcn FP32 plan 540x960 b8", plan_specs, (8, 540, 960, 1))
    f32_err = {"edges": 0.0, "espcn_plan": 0.0}
    for x_dt in (f32, bf16):
        x = torch.from_numpy(rng.random((8, 540, 960, 1), dtype=np.float32)).to(dev, x_dt)
        got = chain.fused_conv_chain(x, plan_ops, plan_specs, compute_dtype=f32)
        torch.cuda.synchronize()
        f32_err["espcn_plan"] = max(f32_err["espcn_plan"], held(
            f"espcn FP32 plan (tanh folded) 540x960 b8 fp32 x {'bf16' if x_dt == bf16 else 'f32'}",
            "fused_conv_chain", got,
            chain.conv_chain_reference(x, plan_ops, plan_specs, "none", f32), f32))
    del espcn_fp32, fwd
    for label, cfg, cin, tail, shape in (
        ("largest layer k9 C16 o32 40x50 b2", [(9, 32, "relu")], 16, "none", (2, 40, 50, 16)),
        ("k9 C32 head, f32 B split in registers 30x40 b2",
         [(9, 4, "relu"), (3, 8, "tanh"), (3, 4, "linear")], 32, "none", (2, 30, 40, 32)),
        ("8 layers to o32 29x37 b2", [(3, 8, "relu"), (3, 12, "silu"), (1, 16, "relu"),
                                      (3, 9, "tanh"), (2, 17, "relu"), (3, 32, "relu"),
                                      (3, 5, "sigmoid"), (3, 4, "gelu")], 2, "none",
         (2, 29, 37, 2)),
        ("C1 k5 head c1 tail 41x57 b2", [(5, 16, "relu"), (3, 8, "relu"), (3, 1, "sigmoid")], 1,
         "c1", (2, 41, 57, 1)),
    ):
        nodes = random_chain(cfg, cin)
        specs = chain.build_chain_specs(nodes, cin, f32, tail=tail)
        assert specs is not None, label
        f32_geometry(label, specs, shape)
        f32_err["edges"] = max(f32_err["edges"], case(label, nodes, cin, f32, tail, shape,
                                                      "fused_conv_chain"))

    def chain_f64(x, ops, specs):
        """A linear chain's output in float64 on the card."""
        y = x.double()
        for p, sp in zip(ops, specs):
            yd = F.pad(y.permute(0, 3, 1, 2), (sp.pl, sp.pr, sp.pt, sp.pb))
            y = F.conv2d(yd, p["w"].double().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
            y = y * p["scale"].double() + p["offset"].double()
        return y

    lin = random_chain([(5, 16, "linear"), (3, 16, "linear"), (3, 4, "linear")], 1)
    lin_specs = chain.build_chain_specs(lin, 1, f32)
    lin_ops = on_dev(chain.chain_operands(lin, f32))
    x = torch.from_numpy((100.0 * rng.standard_normal((2, 64, 96, 1))).astype(np.float32)).to(dev)
    got = chain.fused_conv_chain(x, lin_ops, lin_specs, compute_dtype=f32)
    torch.cuda.synchronize()
    want = chain.conv_chain_reference(x, lin_ops, lin_specs, "none", f32)
    f32_err["x1e2"] = held("espcn-shaped linear |x|~1e2 64x96 b2 fp32", "fused_conv_chain", got,
                           want, f32)
    exact = chain_f64(x, lin_ops, lin_specs)
    scale = max(1.0, exact.abs().max().item())
    chain_f64_errs = {k: (v.double() - exact).abs().max().item() / scale
                      for k, v in (("kernel", got), ("plain", want))}
    log(f"[kernel] espcn-shaped linear |x|~1e2 fp32: against float64, relative to max(1, "
        f"max|y|): kernel {chain_f64_errs['kernel']:.2e}, plain {chain_f64_errs['plain']:.2e}")

    def seeded_batchnorm(g, gamma, seed=11):
        """BatchNorm statistics drawn from `seed` around `gamma`, as the
        tests draw them: under the builders' identity BatchNorm the logits
        are too small to hold anything; under these they are O(1)."""
        bn_rng = np.random.default_rng(seed)
        for n in g.nodes.values():
            if n.op == "BatchNormalization":
                c = n.params["gamma"].shape[0]
                n.params.update(
                    gamma=(gamma + 0.2 * bn_rng.standard_normal(c)).astype(np.float32),
                    beta=(0.2 * bn_rng.standard_normal(c)).astype(np.float32),
                    mean=(0.1 * bn_rng.standard_normal(c)).astype(np.float32),
                    variance=(1 + 0.1 * np.abs(bn_rng.standard_normal(c))).astype(np.float32))
        return g

    def mobilenetv2_224():
        """MobileNetV2 224 with seeded weights and BatchNorm statistics."""
        return seeded_batchnorm(build_mobilenetv2(), 1.5)

    # Inverted-residual blocks as the planner builds them (BatchNorm
    # folded), one case per distinct geometry at the batch of the path that
    # runs it: every block of MobileNetV2 224 (b8), every block of the
    # trained model (b64); and a ragged block.
    def planned_blocks(graph, batch):
        """[(label, InvResSpec, float32 operands on the card)] for every
        block the engine's planner would fuse, in graph order."""
        fusion.optimize(graph)
        graph.infer_shapes(batch_size=batch)
        out = []
        for node in graph.toposort():
            if node.op != "SeparableConv2D":
                continue
            m = invres.match_invres_block(graph, node)
            if m is None:
                continue
            head = m[0] if m[0] is not None else m[1]
            ops, spec = invres.build_invres(m, graph.nodes[head.inputs[0]].out_spec, f32)
            out.append((head.name, spec, {k: v.to(dev) for k, v in ops.items()}))
        return out

    def geometry(spec):
        return (f"{spec.h}x{spec.w} {spec.cin}->{spec.e}->{spec.cout}"
                + (" res" if spec.residual else "") + ("" if spec.has_expand else " t=1"))

    def int8_tensor(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    mnv2_blocks = planned_blocks(mobilenetv2_224(), 8)
    assert len(mnv2_blocks) == 11, [b[0] for b in mnv2_blocks]
    assert geometry(mnv2_blocks[-1][1]) == "7x7 160->960->320", geometry(mnv2_blocks[-1][1])
    trained_graph = parse_model_file(MOBILENETV2_TRAINED)
    trained_blocks = planned_blocks(trained_graph, 64)
    assert len(trained_blocks) == 13 and sum(not b[1].has_expand for b in trained_blocks) == 1
    ragged_spec = invres.InvResSpec(13, 9, 24, 144, 24, True, True, "relu6", "relu6", "linear")
    rops = {"w1": rng.standard_normal((24, 144)) / 5, "s1": 1 + 0.1 * rng.standard_normal(144),
            "o1": 0.1 * rng.standard_normal(144), "wd": rng.standard_normal((9, 144)) / 3,
            "sd": 1 + 0.1 * rng.standard_normal(144), "od": 0.1 * rng.standard_normal(144),
            "w2": rng.standard_normal((144, 24)) / 12, "s2": 1 + 0.1 * rng.standard_normal(24),
            "o2": 0.1 * rng.standard_normal(24)}
    rops = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in rops.items()}
    geoms = {}
    for _head, spec, ops in mnv2_blocks:
        geoms.setdefault(geometry(spec), (spec, ops, 8))
    assert len(geoms) == 6, sorted(geoms)
    trained_geoms = {}
    for _head, spec, ops in trained_blocks:
        trained_geoms.setdefault(geometry(spec) + " (trained)", (spec, ops, 64))
    block_cases = list(geoms.items()) + list(trained_geoms.items()) + [
        (geometry(ragged_spec) + " (ragged)", (ragged_spec, rops, 3)),
    ]
    launch_cfgs = {
        pname: sorted({(g.tile_h, g.tile_w, g.split) for g in (
            invres.pick_launch(spec, nb, sms, pname == "bf16") for _l, (spec, _o, nb) in block_cases)})
        for pname in ("bf16", "fp32")}
    log(f"[kernel] block cases: {len(block_cases)} geometries, launch configurations "
        f"(tile_h, tile_w, split) bf16 {launch_cfgs['bf16']} fp32 {launch_cfgs['fp32']}")
    block_err = 0.0
    for label, (spec, ops, nb) in block_cases:
        for dt in (bf16, f32):
            x = torch.from_numpy(rng.standard_normal(
                (nb, spec.h, spec.w, spec.cin)).astype(np.float32)).to(dev, dt)
            ops_dt = {k: (v.to(dt) if k in ("w1", "w2") else v) for k, v in ops.items()}
            got = invres.fused_invres_block(x, ops_dt, spec)
            torch.cuda.synchronize()
            block_err = max(block_err, held(
                f"{label} b{nb} {'bf16' if dt == bf16 else 'fp32'}", "fused_invres_block",
                got, invres.invres_block_reference(x, ops_dt, spec), dt))
    # Edges of the fp32 form (3xTF32): inputs at |x| ~ 1e2 through the
    # widest block (160 -> 960 -> 320 at 7x7, b8; linear activations, so
    # that nothing clips them) and the ragged one; int8 weights (the f32 W8
    # instantiation, two passes); a block whose weights fit one buffer only.
    def random_block_ops(cin, e, cout, int8=False):
        ops = {"w1": rng.standard_normal((cin, e)) / np.sqrt(cin),
               "s1": 1 + 0.1 * rng.standard_normal(e), "o1": 0.1 * rng.standard_normal(e),
               "wd": rng.standard_normal((9, e)) / 3, "sd": 1 + 0.1 * rng.standard_normal(e),
               "od": 0.1 * rng.standard_normal(e), "w2": rng.standard_normal((e, cout)) / np.sqrt(e),
               "s2": 1 + 0.1 * rng.standard_normal(cout), "o2": 0.1 * rng.standard_normal(cout)}
        ops = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in ops.items()}
        if int8:  # int8 w1 / w2, their scales folded into s1 / s2
            ops.update(w1=int8_tensor((cin, e)), w2=int8_tensor((e, cout)),
                       s1=ops["s1"] / 127 / np.sqrt(cin), s2=ops["s2"] / 127 / np.sqrt(e))
        return ops

    wide_lin = invres.InvResSpec(7, 7, 160, 960, 320, True, False, "linear", "linear", "linear")
    one_buf = invres.InvResSpec(8, 8, 300, 600, 320, True, False, "relu6", "relu6", "linear")
    assert invres.pick_launch(one_buf, 2, sms).bufs == 1
    for label, spec, ops, nb, mag in (
        ("7x7 160->960->320 linear |x|~1e2", wide_lin, random_block_ops(160, 960, 320), 8, 100.0),
        ("ragged 13x9 24->144->24 res |x|~1e2", ragged_spec, rops, 3, 100.0),
        ("7x7 160->960->320 int8 w", mnv2_blocks[-1][1], random_block_ops(160, 960, 320, True),
         8, 1.0),
        ("ragged 13x9 24->144->24 res int8 w", ragged_spec, random_block_ops(24, 144, 24, True),
         3, 1.0),
        ("one buffer 8x8 300->600->320", one_buf, random_block_ops(300, 600, 320), 2, 1.0),
    ):
        x = torch.from_numpy((mag * rng.standard_normal((nb, spec.h, spec.w, spec.cin)))
                             .astype(np.float32)).to(dev)
        got = invres.fused_invres_block(x, ops, spec)
        torch.cuda.synchronize()
        block_err = max(block_err, held(f"{label} b{nb} fp32", "fused_invres_block", got,
                                        invres.invres_block_reference(x, ops, spec), f32))

    # Single convs: the trained model's folded stem (12->16, k2, pads from
    # fold_stride2_convs) at its main-path batch 64 and at 8, and two edges.
    stem = trained_graph.nodes["stem_conv"]
    assert int(stem.attr("kernel_size")) == 2 and trained_graph.nodes[stem.inputs[0]].op == "SpaceToDepth"
    stem_pads = padding_offsets(stem.attr("padding"), 2)
    stem_ops = tuple(t.to(dev) for t in folded_operands(stem, f32))
    conv_cases = [("stem 16x16 12->16 k2", 64, 16, 16, stem_ops, stem_pads, str(stem.attr("activation"))),
                  ("stem 16x16 12->16 k2", 8, 16, 16, stem_ops, stem_pads, str(stem.attr("activation")))]
    for label, nb, h, w, c, k, o, pads, act in (
        ("k5 c1->16 64x96", 2, 64, 96, 1, 5, 16, (2, 2, 2, 2), "relu"),
        ("k3 c128->128 asym pads 30x41", 2, 30, 41, 128, 3, 128, (3, 0, 1, 2), "tanh"),
        # What forced-KERNEL ResNet18 at the zoo width launches (stages 0 and 1).
        ("resnet k3 c64->64 32x32", 8, 32, 32, 64, 3, 64, (1, 1, 1, 1), "relu"),
        ("resnet k3 c128->128 16x16", 8, 16, 16, 128, 3, 128, (1, 1, 1, 1), "relu"),
        # Edges of the bf16 form: O not a multiple of 8; images that do not
        # fill a multi-image CTA; C = 3; taps in several stages; a k11 head.
        ("k3 c24->10 10x12", 2, 10, 12, 24, 3, 10, (1, 1, 1, 1), "tanh"),
        ("k3 c128->128 4x4 (3 of 4 images)", 3, 4, 4, 128, 3, 128, (1, 1, 1, 1), "relu"),
        ("k3 c3->64 32x32", 8, 32, 32, 3, 3, 64, (1, 1, 1, 1), "relu"),
        ("k5 c128->128 20x20 (tap groups)", 2, 20, 20, 128, 5, 128, (2, 2, 2, 2), "relu"),
        ("k11 c1->16 20x24", 2, 20, 24, 1, 11, 16, (5, 5, 5, 5), "relu"),
        # The largest K the gate admits (kh*kw*C = 4096), even k.
        ("k8 c64->128 24x24 (K 4096)", 2, 24, 24, 64, 8, 128, (3, 4, 3, 4), "linear"),
    ):
        wts = torch.from_numpy((rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c))
                               .astype(np.float32)).to(dev)
        sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(o)).astype(np.float32)).to(dev)
        of = torch.from_numpy((0.1 * rng.standard_normal(o)).astype(np.float32)).to(dev)
        conv_cases.append((label, nb, h, w, (wts, sc, of), pads, act))

    # What the forced-KERNEL ResNet18 paths launch, read from the plans the
    # engine makes: every chain, and one single conv per distinct geometry,
    # with the model's own folded weights at the path's batch.
    def planned_resnet(graph, batch, tag):
        eng = Engine.from_graph(graph, EngineOptions(precision=Precision.FP32, batch_size=batch,
                                                     backend=BackendKind.KERNEL))
        g, fwd = eng.graph, eng.model.forward
        singles, step = {}, []
        for name_ in fwd.single_conv_plan:
            node = g.nodes[name_]
            s = g.nodes[node.inputs[0]].out_spec
            k, o = int(node.attr("kernel_size")), int(node.attr("out_channels"))
            act = str(node.attr("activation", "linear"))
            pads = padding_offsets(node.attr("padding", "same"), k)
            conv_case = (batch, s.h, s.w, tuple(t.to(dev) for t in folded_operands(node, f32)),
                         pads, act)
            singles.setdefault(f"{tag} k{k} c{s.c}->{o} {s.h}x{s.w} {act}", conv_case)
            step.append(conv_case)
        chains = []
        for head, members in fwd.chain_plan.items():
            nodes = [g.nodes[m] for m in members]
            assert all(n.op == "Conv2D" for n in nodes), members
            s = g.nodes[nodes[0].inputs[0]].out_spec
            chains.append((f"{tag} chain {head} {'->'.join(str(n.attr('out_channels')) for n in nodes)}"
                           f" {s.h}x{s.w} b{batch}", nodes, s.c, (batch, s.h, s.w, s.c)))
        return singles, chains, step

    zoo_singles, zoo_chains, zoo_step = planned_resnet(
        seeded_batchnorm(build_resnet18_cifar10(), 1.2), 8, "resnet18")
    cls_singles, cls_chains, _ = planned_resnet(parse_model_file(RESNET18_TRAINED), 64,
                                                "resnet18 cls10")
    assert len(zoo_step) == 8, len(zoo_step)
    # Zoo width: stem, 64->64 at 32x32 (relu and linear), 128->128 at 16x16
    # (both); trained: stem and 32/64/128 channels at 16x16, 8x8, 4x4 (both).
    assert len(zoo_singles) == 5 and zoo_chains == [], (sorted(zoo_singles), zoo_chains)
    assert len(cls_singles) == 7 and len(cls_chains) == 2, (sorted(cls_singles), cls_chains)
    for label, (nb, h, w, ops, pads, act) in (*zoo_singles.items(), *cls_singles.items()):
        conv_cases.append((label, nb, h, w, ops, pads, act))
    chain_resnet_err = 0.0
    for label, nodes, cin, shape in cls_chains:  # tail "none": the engine's entry
        for dt in (bf16, f32):
            chain_resnet_err = max(chain_resnet_err, case(
                label, nodes, cin, dt, "none", shape, "fused_conv_chain"))
    def conv_f64(x, wts, sc, of, pads):
        """A linear conv's output in float64 on the card."""
        pt, pb, pl, pr = pads
        xd = F.pad(x.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
        acc = F.conv2d(xd, wts.double().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        return acc * sc.double() + of.double()

    conv_err, conv_f64_errs = 0.0, {"kernel": 0.0, "plain": 0.0}
    for label, nb, h, w, (wts, sc, of), pads, act in conv_cases:
        # bf16 from an f32 input (rounded on staging) and from a bf16 input
        # (the engine's; 16-byte asynchronous copies where C allows); fp32
        # (3xTF32), from an f32 input, from a bf16 input (exact in TF32: two
        # passes) and at |x| ~ 1e2. That one runs the epilogue linear: the
        # tolerance scales with max|plain|, and a saturating activation
        # would hold pre-activations of ~1e2 to 1e-4 absolute, finer than
        # the plain version's own float32 sums reach (against float64,
        # printed beside it).
        for dt, x_dt, tag, mag in ((bf16, f32, "bf16", 1.0), (bf16, bf16, "bf16 x bf16", 1.0),
                                   (f32, f32, "fp32", 1.0), (f32, bf16, "fp32 x bf16", 1.0),
                                   (f32, f32, "fp32 |x|~1e2 linear", 100.0)):
            act_ = "linear" if mag > 1 else act
            x = torch.from_numpy(mag * rng.random((nb, h, w, wts.shape[2]), dtype=np.float32)
                                 ).to(dev, x_dt)
            got = conv.fused_conv2d_haloed(x, wts, sc, of, pads, act_, 0.3, dt)
            torch.cuda.synchronize()
            want = conv.conv2d_haloed_reference(x, wts, sc, of, pads, act_, 0.3, dt)
            conv_err = max(conv_err, held(f"{label} b{nb} {tag}", "fused_conv2d_haloed",
                                          got, want, dt))
            if mag > 1:
                exact = conv_f64(x, wts, sc, of, pads)
                scale = max(1.0, exact.abs().max().item())
                f64_err = {k: (v.double() - exact).abs().max().item() / scale
                           for k, v in (("kernel", got), ("plain", want))}
                log(f"[kernel] {label} b{nb} {tag}: against float64, relative to max(1, "
                    f"max|y|): kernel {f64_err['kernel']:.2e}, plain {f64_err['plain']:.2e}")
                for k, v in f64_err.items():
                    conv_f64_errs[k] = max(conv_f64_errs[k], v)

    def tensor(a, dt=f32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    # The implicit-GEMM conv: the ResNet-wide shapes, 540p frames (k5 and
    # the two-input graph's conv, its main-path shape), even k with
    # asymmetric pads, stride 2, int8 weights.
    TWO_INPUT = (8, 540, 960, 8, 3, 16)  # n, h, w, c (3 + 5), k, o
    igemm_err = 0.0
    for label, nb, h, w, c, k, o, stride, pads, act, w_int8 in (
        ("k3 c64->64 32x32", 8, 32, 32, 64, 3, 64, 1, (1, 1, 1, 1), "relu", False),
        ("k3 c128->128 16x16", 8, 16, 16, 128, 3, 128, 1, (1, 1, 1, 1), "relu", False),
        ("k1 c64->128 16x16", 8, 16, 16, 64, 1, 128, 1, (0, 0, 0, 0), "linear", False),
        ("k5 c3->16 540x960", 2, 540, 960, 3, 5, 16, 1, (2, 2, 2, 2), "tanh", False),
        ("k4 c7->20 asym pads 30x41", 2, 30, 41, 7, 4, 20, 1, (1, 2, 1, 2), "leaky_relu", False),
        ("two-input k3 c8->16 540x960", *TWO_INPUT, 1, (1, 1, 1, 1), "relu", False),
        ("stride 2 k3 c24->40 33x35", 4, 33, 35, 24, 3, 40, 2, (1, 1, 1, 1), "relu6", False),
        ("int8 w k3 c16->32 20x22", 2, 20, 22, 16, 3, 32, 1, (1, 1, 1, 1), "relu", True),
        # The tensor-core form's edges: the two-input conv with int8 weights
        # (with the float rows above, all four operand forms), stride 2 with
        # asymmetric pads, C = 3 and O = 10 (padding in K and N), the largest
        # K the gate admits (kh*kw*C = 4096: chunks and tap groups in f32).
        ("int8 w two-input k3 c8->16 540x960", *TWO_INPUT, 1, (1, 1, 1, 1), "relu", True),
        ("stride 2 asym pads k3 c16->24 31x29", 2, 31, 29, 16, 3, 24, 2, (0, 2, 1, 1), "gelu",
         False),
        ("C3 O10 k3 30x41", 2, 30, 41, 3, 3, 10, 1, (1, 1, 1, 1), "tanh", False),
        ("k8 c64->128 24x24 (K 4096)", 2, 24, 24, 64, 8, 128, 1, (3, 4, 3, 4), "linear", False),
        # 16-channel blocks whose last is partial: 40 = 16 + 16 + 8 (16-byte
        # output pieces) and 20 = 16 + 4 (single elements).
        ("k3 c16->40 64x96 (blocks 16, 16, 8)", 8, 64, 96, 16, 3, 40, 1, (1, 1, 1, 1), "relu",
         False),
        ("k3 c8->20 64x96 (blocks 16, 4)", 8, 64, 96, 8, 3, 20, 1, (1, 1, 1, 1), "sigmoid", False),
    ):
        for dt in (bf16, f32):
            x = tensor(rng.standard_normal((nb, h, w, c)), dt)
            if w_int8:
                wts = int8_tensor((k, k, c, o))
                sc = tensor(0.02 / np.sqrt(k * k * c) * (1 + 0.1 * rng.standard_normal(o)))
            else:
                wts = tensor(rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c), dt)
                sc = tensor(1 + 0.1 * rng.standard_normal(o))
            of = tensor(0.1 * rng.standard_normal(o))
            got = conv_igemm.conv2d_kernel_nhwc(x, wts, sc, of, stride=stride, pads=pads,
                                                activation=act)
            torch.cuda.synchronize()
            igemm_err = max(igemm_err, held(
                f"{label} b{nb} {'bf16' if dt == bf16 else 'fp32'}", "conv2d_kernel_nhwc",
                got, conv_igemm.conv2d_igemm_reference(x, wts, sc, of, stride, pads, act), dt))

    # The fused matmul: the classifier heads (ResNet18 at the zoo width and
    # trained, MobileNetV2's), a ragged shape, int8 weights. A softmax row
    # must sum to 1: within 1e-5 in fp32; in bf16 each probability is
    # rounded once (relative 2^-9), so the sum is held to 2^-8.
    matmul_err = 0.0
    for label, m, k, n, act, w_int8 in (
        ("resnet18 fc 8x512x10", 8, 512, 10, "softmax", False),
        ("trained fc 64x128x10", 64, 128, 10, "softmax", False),
        ("mobilenetv2 fc 8x1280x1000", 8, 1280, 1000, "softmax", False),
        ("ragged 37x100x23", 37, 100, 23, "sigmoid", False),
        ("int8 w 33x70x130", 33, 70, 130, "relu", True),
        ("int8 w 8x1280x1000", 8, 1280, 1000, "softmax", True),
        ("M=1 1x300x7", 1, 300, 7, "relu", False),
        ("N=1001 5x77x1001", 5, 77, 1001, "softmax", False),
        ("K=1 9x1x40", 9, 1, 40, "tanh", False),
        ("many row and column blocks 130x1500x2100", 130, 1500, 2100, "softmax", False),
    ):
        for dt in (bf16, f32):
            x = tensor(rng.standard_normal((m, k)), dt)
            if w_int8:
                wts = int8_tensor((k, n))
                sc = tensor(0.02 / np.sqrt(k) * (1 + 0.1 * rng.standard_normal(n)))
            else:
                wts = tensor(rng.standard_normal((k, n)) / np.sqrt(k), dt)
                sc = tensor(1 + 0.1 * rng.standard_normal(n))
            of = tensor(0.1 * rng.standard_normal(n))
            got = matmul.fused_matmul(x, wts, sc, of, activation=act)
            torch.cuda.synchronize()
            pname = "bf16" if dt == bf16 else "fp32"
            matmul_err = max(matmul_err, held(
                f"{label} {act} {pname}", "fused_matmul", got,
                matmul.fused_matmul_reference(x, wts, sc, of, act), dt))
            if act == "softmax":
                off = (got.float().sum(-1) - 1).abs().max().item()
                lim = 2.0 ** -8 if dt == bf16 else 1e-5
                log(f"[kernel] {label} {pname}: softmax rows sum to 1 within {off:.2e} "
                    f"(limit {lim:.1e})")
                assert off <= lim, f"{label}: softmax rows do not sum to 1"
    # Two softmax launches back to back on the same arrival counters (the
    # kernel sets each back to 0; no memset between them), different inputs.
    for dt in (bf16, f32):
        pname = "bf16" if dt == bf16 else "fp32"
        wts = tensor(rng.standard_normal((1280, 1000)) / np.sqrt(1280), dt)
        sc, of = tensor(np.ones(1000)), tensor(np.zeros(1000))
        xs = [tensor(rng.standard_normal((8, 1280)), dt) for _ in range(2)]
        outs = [matmul.fused_matmul(x, wts, sc, of, activation="softmax") for x in xs]
        torch.cuda.synchronize()
        for i, (x, got) in enumerate(zip(xs, outs)):
            matmul_err = max(matmul_err, held(
                f"back-to-back softmax #{i + 1} 8x1280x1000 {pname}", "fused_matmul", got,
                matmul.fused_matmul_reference(x, wts, sc, of, "softmax"), dt))

    # The YOLO head's suppression in one launch (kernels/nms.py) at the
    # 416 b8 cell's shapes: 8 frames of 13²·3 + 26²·3 = 2,535 candidates,
    # the 100 best, 80 classes (decode_grid of seeded 255-channel heads) and
    # crowded boxes of 3 classes (`nms_inputs`); bit for bit against `nms_fixed`, one launch
    # counted a call, and an IoU threshold of 0.55 as a planted fault.
    from shadernn_tpu_torch.kernels import nms as nms_kernel
    from shadernn_tpu_torch.ops.yolo import (
        YOLOV3_TINY_ANCHORS, YOLOV3_TINY_MASKS, decode_grid, nms_fixed, top_candidates,
    )

    def nms_inputs(kind):
        """Drawn on the host (torch's CPU generator), then moved to the card.
        "decoded": heads whose class logits favour 3 of the 80 classes, so
        that same-class boxes meet as in the cell (a few rows of 800
        suppressed); "crowded": boxes crowded into the frame, 3 classes."""
        g = torch.Generator().manual_seed(416 if kind == "decoded" else 417)
        if kind == "decoded":
            parts = []
            for hw, mask in ((13, YOLOV3_TINY_MASKS[0]), (26, YOLOV3_TINY_MASKS[1])):
                feat = torch.randn((8, hw, hw, 3, 85), generator=g)
                feat[..., 5:8] += 6.0
                parts.append(decode_grid(feat.reshape(8, hw, hw, 255),
                                         [YOLOV3_TINY_ANCHORS[m] for m in mask], (416, 416), 80))
            return tuple(torch.cat(p_, dim=1).to(dev) for p_ in zip(*parts))
        xy = torch.rand((8, 2535, 2), generator=g) * 0.6
        wh = 0.05 + torch.rand((8, 2535, 2), generator=g) * 0.3
        return (torch.cat([xy, wh], -1).to(dev), torch.rand((8, 2535), generator=g).to(dev),
                torch.randint(0, 3, (8, 2535), generator=g).to(dev))

    nms_rows = {}
    for kind in ("decoded", "crowded"):
        boxes, scores, classes = nms_inputs(kind)
        assert boxes.shape == (8, 2535, 4), boxes.shape
        b_, c_, top, idx = top_candidates(boxes, scores, classes, 0.35, 100)
        before = launch_counts().get("nms_fixed", 0)
        got = nms_kernel.suppress(b_, c_, top, idx, 0.45)
        launched = launch_counts().get("nms_fixed", 0) - before
        want = nms_fixed(boxes, scores, classes, 0.45, 0.35, 100)
        planted = nms_kernel.suppress(b_, c_, top, idx, 0.55)
        torch.cuda.synchronize()
        equal, kept = torch.equal(got, want), int((want[..., 1] > 0).sum())
        sees_fault = not torch.equal(planted, want)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(200):
            nms_kernel.suppress(b_, c_, top, idx, 0.45)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 200
        log(f"[kernel] nms {kind} 8x2535 k100          {'nms_fixed':<24} bit-equal {equal}, "
            f"{kept} of {int((top > 0).sum())} rows kept, {launched} launch, IoU 0.55 planted "
            f"fault seen {sees_fault}; event ms {ms:.4f} {'ok' if equal else 'FAIL'}")
        assert equal and launched == 1 and sees_fault, (kind, equal, launched, sees_fault)
        assert 0 < kept < int((top > 0).sum()), (kind, kept)
        nms_rows[kind] = {"bit_equal": equal, "launches": launched, "kept_rows": kept,
                          "planted_fault_seen": sees_fault, "event_ms": ms}

    # 4. main path -----------------------------------------------------------
    # Each path runs with every kernel's count set to 0 just before it and
    # read just after: the launches counted since `reset_counts`, by entry
    # point (`kernels.launch_counts`).
    counted_before = {}

    def reset_counts():
        counted_before.update(launch_counts())

    def read_counts():
        return {k: v - counted_before.get(k, 0) for k, v in launch_counts().items()}

    def device_busy(eng, inputs, steps=5):
        """Device time per engine step (inputs already on the card) and the
        top device events by it."""
        dev_inputs = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        return device_profile(lambda: eng.model(dev_inputs), steps)


    def busy_text(eng, inputs, p50):
        """Device time per step, the hand-written kernels' share of it and
        a line that splits it into those and the rest (the TORCH layers:
        cuDNN, the int8 im2col and torch._int_mm, quantization, casts) and
        names the top events."""
        busy_ms, top_kernels = device_busy(eng, inputs)
        idle = f"{1 - busy_ms / p50:.3f}" if busy_ms else "not measured"
        ported = sum(v for k, v in top_kernels if HAND_WRITTEN.search(k))
        return busy_ms, ported, (f"torch.profiler: device busy {busy_ms:.3f} ms per step (hand-written "
                         f"kernels {ported:.3f} ms, TORCH layers and the rest "
                         f"{busy_ms - ported:.3f} ms), idle share {idle} of the p50 step; top "
                         "kernels " + "; ".join(f"{k[:60]} {v:.3f} ms"
                                                for k, v in top_kernels[:6]))

    frames = rng.random((8, 540, 960, 1), dtype=np.float32)
    main_stats = {}
    for prec, entry in ((Precision.BF16, "fused_conv_chain_packed"),
                        (Precision.FP32, "fused_conv_chain")):
        opts = EngineOptions(precision=prec, batch_size=8)
        eng = Engine.from_json(ESPCN_TRAINED, opts, input_hw=(540, 960))
        reset_counts()
        outs = [eng.run_single(frames) for _ in range(STEPS)]
        counts = read_counts()
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
        busy_ms, top_kernels = device_busy(eng, {"input": frames})
        idle = f"{1 - busy_ms / bench['p50_ms']:.3f}" if busy_ms else "not measured"
        log(f"[main] espcn 540p b8 {prec.value} torch.profiler: device busy {busy_ms:.3f} ms per "
            f"step, idle share {idle} of the p50 step; top kernels "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top_kernels[:6]))
        assert err <= tol, f"{prec.value}: engine output disagrees with the plain forward"
        main_stats[entry] = {"launches": counts[entry], "max_abs_err": err,
                             "engine_p50_ms": bench["p50_ms"], "device_busy_ms": busy_ms}
        del eng, outs, y, plain

    # MobileNetV2 224, seeded weights and BatchNorm, batch 8: 11 blocks per step.
    images = rng.random((8, 224, 224, 3), dtype=np.float32)
    mnv2_stats = {}
    for prec in (Precision.BF16, Precision.FP32):
        tol = ENGINE_TOL[prec.value]

        def engine(linear_head, backend=BackendKind.AUTO, zeroed=None):
            g = mobilenetv2_224()
            if linear_head:
                g.nodes["fc"].attrs["activation"] = "linear"
            if zeroed is not None:  # a planted fault
                g.nodes[zeroed].params["weight"] = np.zeros_like(g.nodes[zeroed].params["weight"])
            return Engine.from_graph(g, EngineOptions(precision=prec, batch_size=8,
                                                      backend=backend))

        eng = engine(False)
        assert len(eng.model.forward.block_plan) == 11, eng.model.forward.block_plan
        reset_counts()
        outs = [eng.run_single(images) for _ in range(STEPS)]
        counts = read_counts()
        y = outs[-1]
        assert tuple(y.shape) == (8, 1000) and torch.isfinite(y).all().item(), y.shape
        assert torch.allclose(y.sum(-1), torch.ones(8, device=dev), atol=0.05)
        assert counts["fused_invres_block"] == 11 * STEPS, counts
        assert sum(counts.values()) == 11 * STEPS, counts
        err = (y - engine(False, BackendKind.TORCH).run_single(images)).abs().max().item()
        logits = engine(True).run_single(images)
        logits_plain = engine(True, BackendKind.TORCH).run_single(images)
        top = logits_plain.abs().max().item()
        scale = max(1.0, top)
        err_logits = (logits - logits_plain).abs().max().item()
        # A planted fault in one block on the kernel (the first residual
        # block's project conv zeroed, so that the block passes on its input
        # plus a bias) must move the logits past the tolerance.
        plan = eng.model.forward.block_plan
        faulty = next(m for m in plan.values() if m[-1].endswith("_add"))
        zeroed = next(name for name in faulty if name.endswith("_project"))
        err_fault = (engine(True, zeroed=zeroed).run_single(images) - logits_plain).abs().max().item()
        bench = eng.benchmark({"input": images}, loops=20)
        log(f"[main] mobilenetv2 224 b8 {prec.value} blocks {len(eng.model.forward.block_plan)} "
            f"launches {counts} vs TORCH forward: probabilities max_abs_diff {err:.3e} "
            f"tol {tol}; logits max_abs_diff {err_logits:.3e} tol {tol * scale:.3g} "
            f"(max|logit| {top:.3e}, relative {err_logits / top:.3e}); planted fault "
            f"({zeroed} zeroed) moves the logits by {err_fault:.3e} "
            f"device step p50 {bench['p50_ms']:.3f} ms")
        busy_ms, kernels_ms, text = busy_text(eng, {"input": images}, bench["p50_ms"])
        log(f"[main] mobilenetv2 224 b8 {prec.value} {text}")
        assert err <= tol, f"{prec.value}: MobileNetV2 probabilities disagree with TORCH"
        assert err_logits <= tol * scale, f"{prec.value}: MobileNetV2 logits disagree with TORCH"
        assert top >= 1.0, f"{prec.value}: logits of {top:.3e} would hold nothing"
        assert err_fault > tol * scale, f"{prec.value}: the logits check misses a zeroed block"
        mnv2_stats[prec.value] = {"launches": counts["fused_invres_block"],
                                  "engine_p50_ms": bench["p50_ms"],
                                  "device_busy_ms": busy_ms,
                                  "kernels_device_ms": kernels_ms,
                                  "logits_max_abs_diff": err_logits,
                                  "planted_fault_logits_diff": err_fault}
        del eng, outs, y, logits, logits_plain

    # The trained MobileNetV2 (10 classes, 32x32) at b64: 13 blocks and the
    # folded stem on the single-conv kernel per step; top-1 on its task.
    cls_x, cls_y = synth_cls(np.random.default_rng(424242), 256)
    trained_stats = {}
    for prec in (Precision.BF16, Precision.FP32):
        eng = Engine.from_json(MOBILENETV2_TRAINED, EngineOptions(precision=prec, batch_size=64))
        fwd = eng.model.forward
        assert len(fwd.block_plan) == 13 and fwd.single_conv_plan == ["stem_conv"], (
            fwd.block_plan, fwd.single_conv_plan)
        reset_counts()
        preds = [eng.run_single(cls_x[i:i + 64]) for i in range(0, 256, 64)]
        counts = read_counts()
        steps = len(preds)
        probs = torch.cat(preds)
        assert torch.isfinite(probs).all().item() and tuple(probs.shape) == (256, 10)
        top1 = float((probs.argmax(-1).cpu().numpy() == cls_y).mean())
        assert counts["fused_invres_block"] == 13 * steps, counts
        assert counts["fused_conv2d_haloed"] == steps, counts
        assert sum(counts.values()) == 14 * steps, counts
        bench = eng.benchmark({"input": cls_x[:64]}, loops=20)
        log(f"[main] mobilenetv2 cls10 trained b64 {prec.value} launches {counts} in "
            f"{steps} steps top-1 {top1:.4f} (gate 0.9) device step p50 "
            f"{bench['p50_ms']:.3f} ms")
        assert top1 >= 0.9, f"{prec.value}: trained MobileNetV2 top-1 {top1} < 0.9"
        trained_stats[prec.value] = {"launches": counts["fused_conv2d_haloed"],
                                     "invres_launches": counts["fused_invres_block"],
                                     "top1": top1, "engine_p50_ms": bench["p50_ms"]}
        del eng, preds, probs

    # Every node forced to KERNEL: the launches of a step are what the
    # forward's plans say, kernel by kernel.
    def held_to_plans(fwd, counts, steps):
        got = dict(counts)
        got["chains"] = got.pop("fused_conv_chain") + got.pop("fused_conv_chain_packed")
        want = {"chains": len(fwd.chain_plan),
                "fused_conv2d_haloed": len(fwd.single_conv_plan),
                "fused_invres_block": len(fwd.block_plan),
                "conv2d_kernel_nhwc": len(fwd.kernel_conv_plan),
                "fused_matmul": len(fwd.kernel_dense_plan),
                "nms_fixed": len(fwd.nms_plan)}
        assert got == {k: v * steps for k, v in want.items()}, (got, want, steps)
        return want

    forced = BackendKind.KERNEL
    # ResNet18 at the zoo width (64/128/256/512, 32x32x3, 10 classes), seeded
    # weights and BatchNorm statistics, batch 8.
    images32 = rng.random((8, 32, 32, 3), dtype=np.float32)
    resnet_stats = {}
    for prec in (Precision.BF16, Precision.FP32):
        tol = ENGINE_TOL[prec.value]

        def engine(linear_head, backend=forced, zero_fc=False):
            g = seeded_batchnorm(build_resnet18_cifar10(), 1.2)
            if linear_head:
                g.nodes["fc"].attrs["activation"] = "linear"
            if zero_fc:  # a planted fault
                g.nodes["fc"].params["weight"] = np.zeros_like(g.nodes["fc"].params["weight"])
            return Engine.from_graph(g, EngineOptions(precision=prec, batch_size=8,
                                                      backend=backend))

        eng = engine(False)
        fwd = eng.model.forward
        assert fwd.kernel_dense_plan == ["fc"] and fwd.kernel_conv_plan == [], (
            fwd.kernel_dense_plan, fwd.kernel_conv_plan)
        assert fwd.chain_plan == {} and len(fwd.single_conv_plan) == 8, (
            fwd.chain_plan, fwd.single_conv_plan)
        reset_counts()
        outs = [eng.run_single(images32) for _ in range(STEPS)]
        counts = read_counts()
        per_step = held_to_plans(fwd, counts, STEPS)
        y = outs[-1]
        assert tuple(y.shape) == (8, 10) and torch.isfinite(y).all().item(), y.shape
        row_off = (y.sum(-1) - 1).abs().max().item()
        assert row_off <= (2.0 ** -8 if prec == Precision.BF16 else 1e-5), row_off
        err = (y - engine(False, BackendKind.TORCH).run_single(images32)).abs().max().item()
        logits = engine(True).run_single(images32)
        logits_plain = engine(True, BackendKind.TORCH).run_single(images32)
        top = logits_plain.abs().max().item()
        scale = max(1.0, top)
        err_logits = (logits - logits_plain).abs().max().item()
        # A planted fault on the kernel path (fc's weight zeroed, so that the
        # fused matmul gives the bias alone) must move the logits past the
        # tolerance.
        err_fault = (engine(True, zero_fc=True).run_single(images32)
                     - logits_plain).abs().max().item()
        bench = eng.benchmark({"input": images32}, loops=20)
        log(f"[main] resnet18 zoo width b8 {prec.value} KERNEL launches per step {per_step} "
            f"({STEPS} steps) vs TORCH forward: probabilities max_abs_diff {err:.3e} tol {tol}, "
            f"rows sum to 1 within {row_off:.1e}; logits max_abs_diff {err_logits:.3e} tol "
            f"{tol * scale:.3g} (max|logit| {top:.3e}); planted fault (fc zeroed) moves the "
            f"logits by {err_fault:.3e}; device step p50 {bench['p50_ms']:.3f} ms")
        busy_ms, kernels_ms, text = busy_text(eng, {"input": images32}, bench["p50_ms"])
        log(f"[main] resnet18 zoo width b8 {prec.value} {text}")
        assert err <= tol, f"{prec.value}: ResNet18 probabilities disagree with TORCH"
        assert err_logits <= tol * scale, f"{prec.value}: ResNet18 logits disagree with TORCH"
        assert top >= 1.0, f"{prec.value}: logits of {top:.3e} would hold nothing"
        assert err_fault > tol * scale, f"{prec.value}: the logits check misses a zeroed fc"
        resnet_stats[prec.value] = {"launches": counts["fused_matmul"], "per_step": per_step,
                                    "engine_p50_ms": bench["p50_ms"], "device_busy_ms": busy_ms,
                                    "kernels_device_ms": kernels_ms,
                                    "logits_max_abs_diff": err_logits,
                                    "planted_fault_logits_diff": err_fault}
        del eng, outs, y, logits, logits_plain

    # The trained ResNet18 (base 16, 10 classes, 32x32) at b64, scored on the
    # task it was trained on: top-1 >= 0.95 at FP32, BF16 within 0.03 of it.
    resnet_trained = {}
    for prec in (Precision.FP32, Precision.BF16):

        def logits_engine(backend=forced, zeroed=None):
            """The trained model with fc set to linear (and a conv's weight
            zeroed: a planted fault)."""
            g = parse_model_file(RESNET18_TRAINED)
            g.nodes["fc"].attrs["activation"] = "linear"
            if zeroed is not None:
                g.nodes[zeroed].params["weight"] = np.zeros_like(g.nodes[zeroed].params["weight"])
            return Engine.from_graph(g, EngineOptions(precision=prec, batch_size=64,
                                                      backend=backend))

        eng = Engine.from_json(RESNET18_TRAINED, EngineOptions(precision=prec, batch_size=64,
                                                               backend=forced))
        fwd = eng.model.forward
        on_kernel = {n for m in fwd.chain_plan.values() for n in m} | set(fwd.single_conv_plan)
        stride1 = {n.name for n in eng.graph.nodes.values()
                   if n.op == "Conv2D" and int(n.attr("stride", 1)) == 1}
        assert fwd.kernel_dense_plan == ["fc"] and on_kernel == stride1, (fwd.chain_plan,
                                                                         fwd.single_conv_plan)
        reset_counts()
        preds = [eng.run_single(cls_x[i:i + 64]) for i in range(0, 256, 64)]
        counts = read_counts()
        per_step = held_to_plans(fwd, counts, len(preds))
        probs = torch.cat(preds)
        assert torch.isfinite(probs).all().item() and tuple(probs.shape) == (256, 10)
        top1 = float((probs.argmax(-1).cpu().numpy() == cls_y).mean())
        plain = Engine.from_json(RESNET18_TRAINED, EngineOptions(
            precision=prec, batch_size=64, backend=BackendKind.TORCH)).run_single(cls_x[:64])
        err = (preds[0] - plain).abs().max().item()
        tol = ENGINE_TOL[prec.value]
        # The logits too, and a planted fault on a single conv of the kernel
        # path (the 128->128 conv at 4x4, whose pixel tiles are ragged, with
        # its weight zeroed) that the logits check must catch.
        logits = logits_engine().run_single(cls_x[:64])
        logits_plain = logits_engine(BackendKind.TORCH).run_single(cls_x[:64])
        top = logits_plain.abs().max().item()
        scale = max(1.0, top)
        err_logits = (logits - logits_plain).abs().max().item()
        zeroed = "s3b0_conv2"
        assert zeroed in fwd.single_conv_plan, fwd.single_conv_plan
        err_fault = (logits_engine(zeroed=zeroed).run_single(cls_x[:64])
                     - logits_plain).abs().max().item()
        bench = eng.benchmark({"input": cls_x[:64]}, loops=20)
        log(f"[main] resnet18 cls10 trained b64 {prec.value} KERNEL launches per step "
            f"{per_step} ({len(preds)} steps) top-1 {top1:.4f} vs TORCH forward "
            f"probabilities max_abs_diff {err:.3e} tol {tol}; logits max_abs_diff "
            f"{err_logits:.3e} tol {tol * scale:.3g} (max|logit| {top:.3e}); planted fault "
            f"({zeroed} zeroed) moves the logits by {err_fault:.3e}; device step p50 "
            f"{bench['p50_ms']:.3f} ms")
        assert err <= tol, f"{prec.value}: trained ResNet18 disagrees with TORCH"
        assert err_logits <= tol * scale, f"{prec.value}: trained ResNet18 logits disagree with TORCH"
        assert err_fault > tol * scale, f"{prec.value}: the logits check misses a zeroed conv"
        resnet_trained[prec.value] = {"launches": counts["fused_matmul"], "top1": top1,
                                      "per_step": per_step, "engine_p50_ms": bench["p50_ms"],
                                      "logits_max_abs_diff": err_logits,
                                      "planted_fault_logits_diff": err_fault}
        del eng, preds, probs, logits, logits_plain
    assert resnet_trained["fp32"]["top1"] >= 0.95, resnet_trained
    assert resnet_trained["bf16"]["top1"] >= resnet_trained["fp32"]["top1"] - 0.03, resnet_trained

    # A two-input conv graph at 540p, batch 8 (the reference's
    # use_multi_inputs): no chain takes it, so forced to KERNEL it runs on the
    # implicit-GEMM conv kernel, one launch per step.
    def two_input_graph(drop_tap=False):
        nb, h, w, c, k, o = TWO_INPUT
        g = Graph("two_input")
        g.add(Node("a", "InputLayer", [], {"height": h, "width": w, "channels": 3}))
        g.add(Node("b", "InputLayer", [], {"height": h, "width": w, "channels": c - 3,
                                           "index": 1}))
        w_rng = np.random.default_rng(7767517)
        wt = (w_rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
        bias = (0.1 * w_rng.standard_normal(o)).astype(np.float32)
        if drop_tap:  # a planted fault: the centre tap contributes nothing
            wt[k // 2, k // 2] = 0
        g.add(Node("conv", "Conv2D", ["a", "b"],
                   {"kernel_size": k, "stride": 1, "padding": "same", "out_channels": o,
                    "use_multi_inputs": True, "use_bias": True, "activation": "relu"},
                   {"weight": wt, "bias": bias}))
        g.finalize()
        return g

    nb, h, w, c, k, o = TWO_INPUT
    pair = {"a": rng.random((nb, h, w, 3), dtype=np.float32),
            "b": rng.random((nb, h, w, c - 3), dtype=np.float32)}
    two_stats = {}
    for prec in (Precision.BF16, Precision.FP32):
        tol = ENGINE_TOL[prec.value]

        def engine(backend=forced, drop_tap=False):
            return Engine.from_graph(two_input_graph(drop_tap), EngineOptions(
                precision=prec, batch_size=nb, backend=backend))

        eng = engine()
        fwd = eng.model.forward
        assert fwd.kernel_conv_plan == ["conv"] and fwd.chain_plan == {}, fwd.kernel_conv_plan
        reset_counts()
        for _ in range(STEPS):
            y = eng.run(pair)["conv"]
        counts = read_counts()
        per_step = held_to_plans(fwd, counts, STEPS)
        assert tuple(y.shape) == (nb, h, w, o) and torch.isfinite(y).all().item(), y.shape
        plain = engine(BackendKind.TORCH).run(pair)["conv"]
        scale = max(1.0, plain.abs().max().item())
        err = (y - plain).abs().max().item()
        err_fault = (engine(drop_tap=True).run(pair)["conv"] - plain).abs().max().item()
        bench = eng.benchmark(pair, loops=20)
        log(f"[main] two-input conv 540x960 b8 {prec.value} KERNEL launches per step "
            f"{per_step} ({STEPS} steps) vs TORCH forward max_abs_diff {err:.3e} tol "
            f"{tol * scale:.3g}; planted fault (centre tap dropped) moves the output by "
            f"{err_fault:.3e}; device step p50 {bench['p50_ms']:.3f} ms")
        busy_ms, _, text = busy_text(eng, pair, bench["p50_ms"])
        log(f"[main] two-input conv 540x960 b8 {prec.value} {text}")
        assert err <= tol * scale, f"{prec.value}: the two-input conv disagrees with TORCH"
        assert err_fault > tol * scale, f"{prec.value}: the check misses a dropped tap"
        two_stats[prec.value] = {"launches": counts["conv2d_kernel_nhwc"],
                                 "engine_p50_ms": bench["p50_ms"], "device_busy_ms": busy_ms,
                                 "max_abs_diff": err, "planted_fault_diff": err_fault}
        del eng, y, plain

    # 3b/4b. INT8 ------------------------------------------------------------
    # Each configuration weight-only (int8 weights, per-channel scales) and
    # calibrated (int8 activations where the plans set them), calibration on
    # the card over a batch drawn from seed 7, disjoint from the evaluation
    # inputs. Every path is held against the port's TORCH INT8 forward of
    # the same quantized (and calibrated) graph; its launches to its plans.
    I8 = Precision.INT8

    def int8_engines(graph, batch, calib, backend=BackendKind.AUTO):
        """((weight-only engine, its TORCH forward), (calibrated engine, its
        TORCH forward) or None). The calibrated pair runs on a copy of the
        graph: calibration stamps scales on the graph it reads."""
        opts = EngineOptions(precision=I8, batch_size=batch, backend=backend)
        plain = EngineOptions(precision=I8, batch_size=batch, backend=BackendKind.TORCH)
        w = Engine.from_graph(graph, opts)
        pair_w = (w, Engine.from_graph(w.graph, plain, optimize=False))
        if calib is None:
            return pair_w, None
        src = types.SimpleNamespace(graph=copy.deepcopy(w.graph), options=opts)
        # Absolute-max ranges, as the JAX package's INT8 gates calibrate.
        calibrate_activations(src, calib, percentile=None)
        return pair_w, (Engine.from_graph(src.graph, opts, optimize=False),
                        Engine.from_graph(src.graph, plain, optimize=False))

    def int8_block_cases(eng, batch, tag):
        """(label, spec, ops, batch) of every block of an INT8 engine's plan,
        built from its graph as its forward builds them."""
        out = []
        act_scale = lambda n: float(n.attrs.get("act_scale", 0.0) or 0.0)  # noqa: E731
        for head, spec in eng.model.forward.block_specs.items():
            node = eng.graph.nodes[head]
            m = invres.match_invres_block(eng.graph, node if node.op == "SeparableConv2D" else
                                          eng.graph.consumers(head)[0])
            in_node = eng.graph.nodes[m[0].inputs[0] if m[0] is not None else m[1].inputs[0]]
            ops, built = invres.build_invres(m, in_node.out_spec, bf16, act_scale(in_node), True)
            assert built == spec, (built, spec)
            form = ("a8w8" if spec.ax1 or spec.ax2 else "w8") + (
                f" ax1 {spec.ax1:.4g}" if spec.ax1 else "") + (
                f" ax2 {spec.ax2:.4g}" if spec.ax2 else "")
            out.append((f"{tag} {head} {geometry(spec)} {form}", spec,
                        {k: v.to(dev) for k, v in ops.items()}, batch))
        return out

    calib_rng = np.random.default_rng(7)
    i8_frames_cal = [{"input": calib_rng.random((8, 540, 960, 1), dtype=np.float32)}]
    i8_images_cal = [{"input": calib_rng.random((8, 224, 224, 3), dtype=np.float32)}]
    i8_cls_cal = [{"input": synth_cls(np.random.default_rng(7), 64)[0]}]

    def linear_head(g):
        g.nodes["fc"].attrs["activation"] = "linear"
        return g

    espcn_i8 = int8_engines(parse_model_file(ESPCN_TRAINED, input_hw=(540, 960)), 8,
                            i8_frames_cal)
    # The classifiers with a linear head: held to the TORCH forward on their
    # logits (0.1 x max|logit|), scored on the logits' argmax.
    mnv2_i8 = int8_engines(linear_head(mobilenetv2_224()), 8, i8_images_cal)
    cls10_i8 = int8_engines(linear_head(parse_model_file(MOBILENETV2_TRAINED)), 64, i8_cls_cal)
    r18_i8 = int8_engines(linear_head(parse_model_file(RESNET18_TRAINED)), 64, i8_cls_cal)
    r18zoo_i8, _ = int8_engines(linear_head(seeded_batchnorm(build_resnet18_cifar10(), 1.2)), 8,
                                None, forced)
    two_i8, _ = int8_engines(two_input_graph(), TWO_INPUT[0], None, forced)

    # [kernel] cases of the INT8 forms at the paths' own geometries, from
    # their plans and their quantized weights.
    i8_err = {"chain_w8": 0.0, "chain_a8": 0.0, "block_w8": 0.0, "block_a8w8": 0.0,
              "single_w8": 0.0, "igemm_w8": 0.0, "matmul_w8": 0.0}

    def chain_held(label, eng, head, shape, x_dts=(f32, bf16), entry="fused_conv_chain_packed",
                   tail="d2s2"):
        fwd = eng.model.forward
        specs = fwd.chain_specs[head]
        conv_nodes = [eng.graph.nodes[n] for n in fwd.chain_plan[head]
                      if eng.graph.nodes[n].op == "Conv2D"]
        ops = on_dev(chain.chain_operands(conv_nodes, bf16, specs))
        assert all(p["w"].dtype == torch.int8 for p in ops)
        err = 0.0
        for x_dt in x_dts:
            x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, x_dt)
            got = getattr(chain, entry)(x, ops, specs, tail=tail, compute_dtype=bf16)
            torch.cuda.synchronize()
            tag = f" x {'bf16' if x_dt == bf16 else 'f32'}"
            err = max(err, held(label + tag, entry, got,
                                chain.conv_chain_reference(x, ops, specs, tail, bf16), bf16))
        return err, specs, ops

    (espcn_w, _), (espcn_c, _) = espcn_i8
    assert not any(s.in_q for s in espcn_w.model.forward.chain_specs["conv_1"])
    espcn_in_q = [s.in_q for s in espcn_c.model.forward.chain_specs["conv_1"]]
    assert espcn_in_q[0] == 0 and all(espcn_in_q[1:]), espcn_in_q  # C = 1 head: bf16
    i8_err["chain_w8"], espcn_w8_specs, espcn_w8_ops = chain_held(
        "int8 w espcn 540x960 b8", espcn_w, "conv_1", (8, 540, 960, 1))
    # The chain's fp32 form on the same int8 weights (exact in TF32: no lo,
    # two passes).
    x = torch.from_numpy(rng.random((8, 540, 960, 1), dtype=np.float32)).to(dev)
    got = chain.fused_conv_chain(x, espcn_w8_ops, espcn_w8_specs, tail="d2s2", compute_dtype=f32)
    torch.cuda.synchronize()
    i8_err["chain_f32_w8"] = held(
        "int8 w espcn 540x960 b8 fp32 (two passes)", "fused_conv_chain", got,
        chain.conv_chain_reference(x, espcn_w8_ops, espcn_w8_specs, "d2s2", f32), f32)
    i8_err["chain_a8"], espcn_a8_specs, espcn_a8_ops = chain_held(
        f"a8 in_q {[round(q, 5) for q in espcn_in_q]} espcn 540x960 b8", espcn_c, "conv_1",
        (8, 540, 960, 1))
    # A chain whose head takes the frame as int8 (ESPCN's head never does).
    head_nodes = random_chain([(3, 16, "relu6"), (3, 8, "tanh"), (3, 1, "linear")], 8)
    for n in head_nodes:
        n.name = "n"
        n.params = {"weight_q": np.clip(np.round(n.params["weight"] / (np.abs(
            n.params["weight"]).max((0, 1, 2), keepdims=True) / 127)), -127, 127).astype(np.int8),
            "weight_scale": (np.abs(n.params["weight"]).max((0, 1, 2), keepdims=True) / 127
                             ).astype(np.float32), "bias": n.params["bias"]}
    head_specs = chain.a8_scales(head_nodes, chain.build_chain_specs(
        head_nodes, 8, bf16, tail="c1"), head_from_frame=True)[0]
    assert [s.in_q for s in head_specs] == [1 / 127, 6 / 127, 1 / 127], head_specs
    head_ops = on_dev(chain.chain_operands(head_nodes, bf16, head_specs))
    for shape in ((2, 47, 61, 8), (1, 5, 7, 8)):
        for x_dt in (f32, bf16):
            x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, x_dt)
            got = chain.fused_conv_chain_packed(x, head_ops, head_specs, tail="c1",
                                                compute_dtype=bf16)
            torch.cuda.synchronize()
            i8_err["chain_a8"] = max(i8_err["chain_a8"], held(
                f"a8 int8 head C8 {shape[1]}x{shape[2]} b{shape[0]} x "
                f"{'bf16' if x_dt == bf16 else 'f32'}", "fused_conv_chain_packed", got,
                chain.conv_chain_reference(x, head_ops, head_specs, "c1", bf16), bf16))
    # The trained ResNet18's chains (tail none, the im2col entry: int8
    # weights, no a8), its single convs and the trained MobileNetV2's stem
    # with int8 weights; every block of both MobileNetV2s weight-only and
    # A8W8; the two-input conv and both ResNet18 heads with int8 weights.
    (r18_w, _), (r18_c, _) = r18_i8
    r18_chains_i8 = []
    for head in r18_c.model.forward.chain_plan:
        s = r18_c.graph.nodes[r18_c.graph.nodes[head].inputs[0]].out_spec
        err, specs_, ops_ = chain_held(f"int8 w resnet18 cls10 chain {head} {s.h}x{s.w} b64",
                                       r18_c, head, (64, s.h, s.w, s.c), (bf16,),
                                       "fused_conv_chain", "none")
        i8_err["chain_w8"] = max(i8_err["chain_w8"], err)
        r18_chains_i8.append((specs_, ops_, (64, s.h, s.w, s.c)))
    i8_single_cases = {}
    (cls10_w, _), (cls10_c, _) = cls10_i8
    for tag, eng, nb in (("resnet18 cls10", r18_c, 64), ("mobilenetv2 cls10", cls10_c, 64)):
        for name_ in eng.model.forward.single_conv_plan:
            node = eng.graph.nodes[name_]
            s = eng.graph.nodes[node.inputs[0]].out_spec
            k, o = int(node.attr("kernel_size")), int(node.attr("out_channels"))
            act = str(node.attr("activation", "linear"))
            ops = tuple(t.to(dev) for t in folded_operands(node, bf16))
            assert ops[0].dtype == torch.int8
            i8_single_cases.setdefault(f"int8 w {tag} k{k} c{s.c}->{o} {s.h}x{s.w} {act}", (
                nb, s.h, s.w, ops, padding_offsets(node.attr("padding", "same"), k), act))
    for label, (nb, h, w, (wts, sc, of), pads, act) in i8_single_cases.items():
        for x_dt in (f32, bf16):
            x = torch.from_numpy(rng.random((nb, h, w, wts.shape[2]), dtype=np.float32)
                                 ).to(dev, x_dt)
            got = conv.fused_conv2d_haloed(x, wts, sc, of, pads, act, 0.3, bf16)
            torch.cuda.synchronize()
            i8_err["single_w8"] = max(i8_err["single_w8"], held(
                f"{label} b{nb} x {'bf16' if x_dt == bf16 else 'f32'}", "fused_conv2d_haloed",
                got, conv.conv2d_haloed_reference(x, wts, sc, of, pads, act, 0.3, bf16), bf16))
    (mnv2_w, _), (mnv2_c, _) = mnv2_i8
    i8_blocks = {}
    for eng, nb, tag in ((mnv2_w, 8, "mnv2 224"), (mnv2_c, 8, "mnv2 224"),
                         (cls10_w, 64, "cls10"), (cls10_c, 64, "cls10")):
        cases = int8_block_cases(eng, nb, tag)
        assert len(cases) == (11 if nb == 8 else 13), len(cases)
        i8_blocks[(tag, eng is mnv2_c or eng is cls10_c)] = cases
        for label, spec, ops, nb_ in cases:
            x = torch.from_numpy(rng.standard_normal((nb_, spec.h, spec.w, spec.cin))
                                 .astype(np.float32)).to(dev, bf16)
            got = invres.fused_invres_block(x, ops, spec)
            torch.cuda.synchronize()
            key = "block_a8w8" if spec.ax1 or spec.ax2 else "block_w8"
            i8_err[key] = max(i8_err[key], held(
                f"{label} b{nb_}", "fused_invres_block", got,
                invres.invres_block_reference(x, ops, spec), bf16))
    for tag, n_ax1 in (("mnv2 224", 11), ("cls10", 12)):  # cls10's t=1 block has no expand
        planned = [s for _l, s, _o, _n in i8_blocks[(tag, True)]]
        assert all(s.ax2 for s in planned) and sum(bool(s.ax1) for s in planned) == n_ax1, planned
        assert not any(s.ax1 or s.ax2 for _l, s, _o, _n in i8_blocks[(tag, False)])
    two_node = two_i8[0].graph.nodes["conv"]
    two_ops = tuple(t.to(dev) for t in folded_operands(two_node, bf16))
    assert two_ops[0].dtype == torch.int8
    x = tensor(rng.random(TWO_INPUT[:3] + (TWO_INPUT[3],)), bf16)
    got = conv_igemm.conv2d_kernel_nhwc(x, *two_ops, stride=1, pads=(1, 1, 1, 1), activation="relu")
    torch.cuda.synchronize()
    i8_err["igemm_w8"] = held("int8 w two-input k3 c8->16 540x960 b8", "conv2d_kernel_nhwc", got,
                              conv_igemm.conv2d_igemm_reference(x, *two_ops, 1, (1, 1, 1, 1),
                                                                "relu"), bf16)
    for tag, eng, m in (("resnet18 zoo fc", r18zoo_i8[0], 8), ("resnet18 cls10 fc", r18_c, 64)):
        fc = eng.graph.nodes["fc"]
        fc_ops = tuple(t.to(dev) for t in folded_operands(fc, bf16))
        assert fc_ops[0].dtype == torch.int8
        x = tensor(rng.standard_normal((m, fc_ops[0].shape[0])), bf16)
        for act in ("linear", "softmax"):
            got = matmul.fused_matmul(x, *fc_ops, activation=act)
            torch.cuda.synchronize()
            i8_err["matmul_w8"] = max(i8_err["matmul_w8"], held(
                f"int8 w {tag} {m}x{fc_ops[0].shape[0]}x{fc_ops[0].shape[1]} {act}",
                "fused_matmul", got, matmul.fused_matmul_reference(x, *fc_ops, act), bf16))

    # Planted faults the [kernel] checks must catch: a chain layer's in_q
    # halved (the kernel quantizes by 2/in_q, the epilogue keeps in_q), one
    # block's ax2 doubled.
    def caught(label, entry, got, want):
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL_BF16 * max(1.0, want.float().abs().max().item())
        log(f"[kernel] planted fault: {label:<40} {entry:<24} max_abs_diff {err:.3e} tol "
            f"{tol:.1e} {'caught' if err > tol else 'MISSED'}")
        assert err > tol, f"planted fault missed: {label}"
        return err

    x = torch.from_numpy(frames).to(dev)
    bad = list(espcn_a8_specs)
    bad[1] = dataclasses.replace(bad[1], in_q=bad[1].in_q / 2)
    fault_errs = {"chain_in_q_halved": caught(
        "espcn layer 2 in_q halved 540x960 b8", "fused_conv_chain_packed",
        chain.fused_conv_chain_packed(x, espcn_a8_ops, bad, tail="d2s2", compute_dtype=bf16),
        chain.conv_chain_reference(x, espcn_a8_ops, espcn_a8_specs, "d2s2", bf16))}
    label, spec, ops, nb_ = i8_blocks[("mnv2 224", True)][0]
    x = torch.from_numpy(rng.standard_normal((nb_, spec.h, spec.w, spec.cin))
                         .astype(np.float32)).to(dev, bf16)
    fault_errs["block_ax2_doubled"] = caught(
        f"mnv2 224 {label.split()[2]} ax2 doubled", "fused_invres_block",
        invres.fused_invres_block(x, ops, dataclasses.replace(spec, ax2=2 * spec.ax2)),
        invres.invres_block_reference(x, ops, spec))

    # The INT8 main paths.
    def torch_a8w8_layers(graph):
        """The Conv2D/Dense nodes that the TORCH INT8 forward of a graph runs
        A8W8 (ops/conv.py a8w8_engaged); the others take their int8 weights
        dequantized to bf16 and bf16 activations."""
        out, ctx = [], RunCtx(precision=I8)
        for n in graph.nodes.values():
            if n.op not in ("Conv2D", "Dense") or "weight_q" not in n.params:
                continue
            w = n.params["weight_q"]
            k, cin = (int(n.attr("kernel_size")), w.shape[2]) if n.op == "Conv2D" else (1, w.shape[0])
            if a8w8_engaged(n, ctx, k, cin, w.shape[-1]):
                out.append(n.name)
        return out

    def run_path(label, pair_, inputs, steps=STEPS, key=None, batches=None):
        """Run an INT8 path `steps` times with the counts set to 0 just
        before and read just after; hold its launches to its plans and its
        outputs to its TORCH INT8 forward (logits or frames; 0.1 x
        max(1, max|TORCH|)). Returns (outputs, per-step launches, error)."""
        eng, ref = pair_
        fwd = eng.model.forward
        feeds = batches or [inputs] * steps
        reset_counts()
        outs = [eng.run(f) for f in feeds]
        counts = read_counts()
        per_step = held_to_plans(fwd, counts, len(feeds))
        key = key or eng.graph.output_names[0]
        err, scale = 0.0, 1.0
        for f, out in zip(feeds[:2], outs[:2]):
            want = ref.run(f)[key]
            scale = max(scale, want.abs().max().item())
            err = max(err, (out[key] - want).abs().max().item())
        tol = ENGINE_TOL["bf16"] * scale
        p50 = eng.benchmark(feeds[0], loops=20)["p50_ms"]
        busy_ms, _, text = busy_text(eng, feeds[0], p50)
        a8 = torch_a8w8_layers(ref.graph)
        log(f"[main] int8 {label}: launches per step {per_step} ({len(feeds)} steps) vs TORCH "
            f"INT8 forward ({len(a8)} layers A8W8: {a8}; the rest int8 weights on bf16 "
            f"activations) max_abs_diff {err:.3e} tol {tol:.3g}; device step p50 {p50:.3f} ms; "
            f"{text}")
        assert all(torch.isfinite(o[key]).all().item() for o in outs), label
        assert err <= tol, f"int8 {label}: disagrees with the TORCH INT8 forward"
        i8_steps[label] = {"p50_ms": p50, "device_busy_ms": busy_ms}
        return [o[key] for o in outs], per_step, err

    i8_main, i8_steps = {}, {}
    fp32_frames = Engine.from_json(ESPCN_TRAINED, EngineOptions(precision=Precision.FP32,
                                                                batch_size=8),
                                   input_hw=(540, 960)).run_single(frames)
    espcn_out = {}
    for variant, pair_ in (("weight-only", espcn_i8[0]), ("a8", espcn_i8[1])):
        outs, per_step, err = run_path(f"espcn 540x960 b8 {variant}", pair_, {"input": frames})
        assert per_step["chains"] == 1 and sum(per_step.values()) == 1, per_step
        assert outs[-1].abs().max().item() <= 1.0
        espcn_out[variant] = outs[-1]
        i8_main[f"espcn {variant}"] = {"per_step": per_step, "max_abs_diff": err,
                                       "psnr_vs_fp32_db": psnr(outs[-1], fp32_frames)}
    # Each ESPCN engine against the chain's plain version at the kernel's
    # tolerance, run with the plan and operands made here from its graph by
    # the JAX rule (the TORCH INT8 forward runs no int8 activations in
    # ESPCN: a8w8_profitable declines every layer); the engine's plan equal
    # to that one. A planted fault: one in_q halved in an engine's plan
    # after it prepared its operands.
    x_frames = torch.from_numpy(frames).to(dev)

    def espcn_plain(eng):
        names = eng.model.forward.chain_plan["conv_1"]
        nodes = [eng.graph.nodes[n] for n in names if eng.graph.nodes[n].op == "Conv2D"]
        last = eng.graph.nodes[names[-1]]  # an Activation folded after the Subpixel, if any
        override = ((str(last.attr("activation", last.attr("kind", "relu"))),
                     float(last.attr("leaky_alpha", 0.3))) if last.op == "Activation" else None)
        assert any(eng.graph.nodes[n].op == "Subpixel" for n in names), names
        specs = chain.build_chain_specs(nodes, 1, bf16, act_override=override, tail="d2s2")
        specs = chain.a8_scales(nodes, specs, head_from_frame=True)[0]
        assert eng.model.forward.chain_specs["conv_1"] == specs, eng.model.forward.chain_specs
        return chain.conv_chain_reference(x_frames, on_dev(chain.chain_operands(nodes, bf16, specs)),
                                          specs, "d2s2", bf16)

    for variant, (eng, _ref) in (("weight-only", espcn_i8[0]), ("a8", espcn_i8[1])):
        want = espcn_plain(eng)
        tol = TOL_BF16 * max(1.0, want.float().abs().max().item())
        err = (eng.run({"input": frames})[eng.graph.output_names[0]].float() - want.float()).abs().max().item()
        log(f"[main] int8 espcn 540x960 b8 {variant} engine vs the plain chain on its plan "
            f"(in_q {[round(s.in_q, 5) for s in eng.model.forward.chain_specs['conv_1']]}): "
            f"max_abs_diff {err:.3e} tol {tol:.3g}")
        assert err <= tol, f"int8 espcn {variant}: the engine disagrees with the plain chain"
        i8_main[f"espcn {variant}"]["engine_vs_plain_max_abs_diff"] = err
    faulty = Engine.from_graph(espcn_i8[1][0].graph, EngineOptions(precision=I8, batch_size=8),
                               optimize=False)
    faulty.run({"input": frames})  # its operands prepared for the right plan
    plan = faulty.model.forward.chain_specs["conv_1"]
    plan[1] = dataclasses.replace(plan[1], in_q=plan[1].in_q / 2)
    err_fault = (faulty.run({"input": frames})[faulty.graph.output_names[0]].float() - want.float()).abs().max().item()
    log(f"[main] int8 espcn 540x960 b8 planted fault (layer 2 in_q halved in the engine's plan) "
        f"moves the frames by {err_fault:.3e} (tol {tol:.3g}) "
        f"{'caught' if err_fault > tol else 'MISSED'}")
    assert err_fault > tol, "the ESPCN engine check misses an in_q halved in the plan"
    fault_errs["engine_in_q_halved"] = err_fault
    del faulty, want, x_frames
    d_a8 = (espcn_out["a8"] - espcn_out["weight-only"]).abs().max().item()
    log(f"[main] int8 espcn 540x960 b8: PSNR vs FP32 weight-only "
        f"{i8_main['espcn weight-only']['psnr_vs_fp32_db']:.2f} dB (gate 30), a8 "
        f"{i8_main['espcn a8']['psnr_vs_fp32_db']:.2f} dB; a8 vs weight-only max_abs_diff "
        f"{d_a8:.3e} (gate 0.1)")
    assert i8_main["espcn weight-only"]["psnr_vs_fp32_db"] > 30.0, i8_main
    assert d_a8 < 0.1, d_a8
    del fp32_frames, espcn_out
    for variant, pair_ in (("weight-only", mnv2_i8[0]), ("A8W8", mnv2_i8[1])):
        _, per_step, err = run_path(f"mobilenetv2 224 b8 {variant} (logits)", pair_,
                                    {"input": images})
        assert per_step["fused_invres_block"] == 11 and sum(per_step.values()) == 11, per_step
        i8_main[f"mobilenetv2 224 {variant}"] = {"per_step": per_step, "max_abs_diff": err}
    cls_batches = [{"input": cls_x[i:i + 64]} for i in range(0, 256, 64)]
    for tag, pairs, fp32_top1 in (
        ("mobilenetv2 cls10 b64 (logits)", cls10_i8, trained_stats["fp32"]["top1"]),
        ("resnet18 cls10 b64 (logits)", r18_i8, resnet_trained["fp32"]["top1"]),
    ):
        for variant, pair_ in (("weight-only", pairs[0]), ("calibrated", pairs[1])):
            outs, per_step, err = run_path(f"{tag} {variant}", pair_, None, batches=cls_batches)
            top1 = float((torch.cat(outs).argmax(-1).cpu().numpy() == cls_y).mean())
            log(f"[main] int8 {tag} {variant}: top-1 {top1:.4f} (gate FP32 {fp32_top1:.4f} - 0.05)")
            assert top1 >= fp32_top1 - 0.05, f"int8 {tag} {variant}: top-1 {top1}"
            i8_main[f"{tag} {variant}"] = {"per_step": per_step, "max_abs_diff": err,
                                           "top1": top1}
    assert i8_main["mobilenetv2 cls10 b64 (logits) weight-only"]["per_step"][
        "fused_invres_block"] == 13
    stamped = [n for n, v in r18_c.graph.nodes.items() if "in_act_scale" in v.attrs]
    log(f"[main] int8 resnet18 cls10 calibrated: {len(stamped)} nodes stamped with in_act_scale")
    assert len(stamped) >= 5, stamped
    # A planted fault on the INT8 path: one single conv's weight_scale zeroed.
    fault_graph = copy.deepcopy(r18_c.graph)
    zeroed = r18_c.model.forward.single_conv_plan[-1]
    fault_graph.nodes[zeroed].params["weight_scale"] = np.zeros_like(
        fault_graph.nodes[zeroed].params["weight_scale"])
    fault_eng = Engine.from_graph(fault_graph, EngineOptions(precision=I8, batch_size=64),
                                  optimize=False)
    want = r18_i8[1][1].run(cls_batches[0])["fc"]
    err_fault = (fault_eng.run(cls_batches[0])["fc"] - want).abs().max().item()
    tol_fault = ENGINE_TOL["bf16"] * max(1.0, want.abs().max().item())
    log(f"[main] int8 resnet18 cls10 planted fault ({zeroed} weight_scale zeroed) moves the "
        f"logits by {err_fault:.3e} (tol {tol_fault:.3g}) "
        f"{'caught' if err_fault > tol_fault else 'MISSED'}")
    assert err_fault > tol_fault, "the INT8 logits check misses a zeroed weight_scale"
    fault_errs["weight_scale_zeroed"] = err_fault
    del fault_eng, fault_graph
    _, per_step, err = run_path("resnet18 zoo width b8 KERNEL weight-only (logits)", r18zoo_i8,
                                {"input": images32})
    assert per_step["fused_matmul"] == 1 and per_step["fused_conv2d_haloed"] == 8, per_step
    i8_main["resnet18 zoo KERNEL weight-only"] = {"per_step": per_step, "max_abs_diff": err}
    _, per_step, err = run_path("two-input conv 540x960 b8 KERNEL weight-only", two_i8, pair)
    assert per_step["conv2d_kernel_nhwc"] == 1 and sum(per_step.values()) == 1, per_step
    i8_main["two-input KERNEL weight-only"] = {"per_step": per_step, "max_abs_diff": err}

    # 5. timings -------------------------------------------------------------
    def time_ms(fn, reps=20, warm=3, rounds=3):
        """Median over `rounds` of the mean time of `reps` back-to-back
        calls between two CUDA events: the queue stays full, so a call's
        host overhead hides behind the device work before it."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) / reps for a, b in evs)

    def timed(fns):
        """{name: (event ms, device ms)} for each of kernel / plain / library:
        CUDA events around back-to-back calls (a small kernel's host time
        per call can exceed its device time) and the profiler's device
        time per call (the device's work alone)."""
        return {k: (time_ms(fn), device_profile(fn)[0]) for k, fn in fns.items()}

    def timing_keys(t):
        return dict(ms=t["kernel"][0], plain_ms=t["plain"][0], library_ms=t["library"][0],
                    device_ms=t["kernel"][1], plain_device_ms=t["plain"][1],
                    library_device_ms=t["library"][1])

    def timing_text(t):
        return (f"kernel {t['kernel'][0]:.4f} ms (device {t['kernel'][1]:.4f}) "
                f"plain {t['plain'][0]:.4f} ms (device {t['plain'][1]:.4f}) "
                f"cudnn {t['library'][0]:.4f} ms (device {t['library'][1]:.4f})")

    def tf32(flops, nbytes, dt):
        """fp32 work only: the bound in 3xTF32 (three TF32 products per f32
        product) as a dict entry and a text, beside the CUDA-core bound."""
        if dt == bf16:
            return {}, ""
        b = max(3 * flops / peak_tf32, nbytes / peak_bw) * 1e3
        return {"bound_3xtf32_ms": b}, f"; 3xTF32 bound {b:.5f} ms"

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
        prep = chain.prepare(ops, specs, dt)  # packed once: the timed call launches alone
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

            t = timed({
                "kernel": lambda: getattr(chain, entry)(x, prep, specs, tail=tail,
                                                        compute_dtype=dt),
                "plain": lambda: chain.conv_chain_reference(x, ops, specs, tail, dt),
                "library": library,
            })
            flops = 2.0 * nb * 540 * 960 * macs_px
            out_bytes = nb * 540 * 960 * 4 * (2 if dt == bf16 else 4)
            nbytes = x.numel() * 4 + out_bytes + sum(
                p["w"].numel() * p["w"].element_size() + 8 * p["scale"].numel() for p in ops)
            t_ops = flops / (peak_bf16 if dt == bf16 else peak_f32) * 1e3
            t_bytes = nbytes / peak_bw * 1e3
            b3, b3_text = tf32(flops, nbytes, dt)
            rows[(entry, nb)] = dict(**timing_keys(t), bound_ms=max(t_ops, t_bytes),
                                     bound_by="operations" if t_ops >= t_bytes else "bytes", **b3)
            r = rows[(entry, nb)]
            log(f"[timing] {entry:<24} {'bf16 d2s2' if dt == bf16 else 'fp32 none'} 540x960 "
                f"b{nb}: {timing_text(t)} "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB, {peak_key} peaks{b3_text}) | {card}")

    cl = torch.channels_last

    def bound(flops, nbytes, dt):
        t_ops = flops / (peak_bf16 if dt == bf16 else peak_f32) * 1e3
        t_bytes = nbytes / peak_bw * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    def chain_library(x, ops, specs, tail, dt):
        """cuDNN yardstick of a chain: F.conv2d on channels_last tensors with
        the weights (float, or int8 cast exactly) and the folded epilogue in
        the compute dtype, then the tail. Timed only; the port never calls
        it."""
        xl = x.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=cl)
        lib_ops = [(p["w"].to(dt).permute(3, 2, 0, 1).contiguous(memory_format=cl),
                    p["scale"].to(dt).reshape(1, -1, 1, 1),
                    p["offset"].to(dt).reshape(1, -1, 1, 1), sp) for p, sp in zip(ops, specs)]

        def conv_(y, w_, sp):  # asymmetric pads (a folded stride-2 head) padded first
            if sp.pt == sp.pb and sp.pl == sp.pr:
                return F.conv2d(y, w_, padding=(sp.pt, sp.pl))
            return F.conv2d(F.pad(y, (sp.pl, sp.pr, sp.pt, sp.pb)), w_)

        def run():
            y = xl
            with full_precision():
                for w_, sc_, of_, sp in lib_ops:
                    y = apply_activation(conv_(y, w_, sp) * sc_ + of_, sp.activation, sp.alpha)
            y = y.permute(0, 2, 3, 1)
            return depth_to_space(y, 2) if tail == "d2s2" else y
        return run

    # The trained ResNet18's chains (stage 0: 16->16->16, k3, at 32x32) at
    # its batch, 64; under BF16 the engine runs them on the bf16 form through
    # fused_conv_chain. Library: the same convs on cuDNN, channels_last.
    chain_resnet_rows = {}
    label, nodes, cin, shape = cls_chains[0]
    for dt in (bf16, f32):
        pname = "bf16" if dt == bf16 else "fp32"
        specs = chain.build_chain_specs(nodes, cin, dt, tail="none")
        ops = on_dev(chain.chain_operands(nodes, dt))
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, dt)
        prep = chain.prepare(ops, specs, dt)
        t = timed({
            "kernel": lambda: chain.fused_conv_chain(x, prep, specs, compute_dtype=dt),
            "plain": lambda: chain.conv_chain_reference(x, ops, specs, "none", dt),
            "library": chain_library(x, ops, specs, "none", dt),
        })
        n_, h_, w_, _ = shape
        flops = 2.0 * n_ * h_ * w_ * sum(sp.k * sp.k * sp.c * sp.o for sp in specs)
        isz = 2 if dt == bf16 else 4
        nbytes = (x.numel() + n_ * h_ * w_ * specs[-1].o) * isz + sum(
            p["w"].numel() * isz + 8 * p["scale"].numel() for p in ops)
        b_ms, b_by = bound(flops, nbytes, dt)
        b3, b3_text = tf32(flops, nbytes, dt)
        chain_resnet_rows[pname] = dict(**timing_keys(t), bound_ms=b_ms, bound_by=b_by, **b3)
        log(f"[timing] fused_conv_chain {pname} {label}: {timing_text(t)} bound {b_ms:.5f} ms "
            f"({b_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB{b3_text}) | {card}")

    def block_library(spec, ops, dt):
        """cuDNN yardstick of one block: 1x1, depthwise and 1x1 F.conv2d on
        channels_last tensors with the epilogues and the residual, in the
        compute dtype. Timed only; the port never calls it."""
        e, a = spec.e, spec.alpha
        vec = {k: v.to(dt).reshape(1, -1, 1, 1) for k, v in ops.items() if v.dim() == 1}
        wd = ops["wd"].to(dt).t().reshape(e, 1, 3, 3).contiguous(memory_format=cl)
        w2 = ops["w2"].to(dt).t().reshape(spec.cout, e, 1, 1).contiguous(memory_format=cl)
        w1 = (ops["w1"].to(dt).t().reshape(e, spec.cin, 1, 1).contiguous(memory_format=cl)
              if spec.has_expand else None)

        def run(xl):
            with full_precision():
                h = xl
                if w1 is not None:
                    h = apply_activation(F.conv2d(h, w1) * vec["s1"] + vec["o1"], spec.act_expand, a)
                h = apply_activation(F.conv2d(h, wd, padding=1, groups=e) * vec["sd"] + vec["od"],
                                     spec.act_dw, a)
                y = F.conv2d(h, w2) * vec["s2"] + vec["o2"]
                if spec.residual:
                    y = y + xl
                return apply_activation(y, spec.act_out, a)
        return run

    def block_work(spec, nb, dt):
        isz = 2 if dt == bf16 else 4
        mac_w = (spec.cin * spec.e if spec.has_expand else 0) + spec.e * spec.cout
        flops = 2.0 * nb * spec.h * spec.w * (mac_w + 9 * spec.e)
        vec = (2 * spec.e if spec.has_expand else 0) + 2 * spec.e + 2 * spec.cout
        nbytes = nb * spec.h * spec.w * (spec.cin + spec.cout) * isz + mac_w * isz + (9 * spec.e + vec) * 4
        return flops, nbytes

    def block_inputs(spec, ops, nb, dt):
        """An input and the block's operands laid out once for the kernel
        (prepare_operands, as the engine does once per parameter set)."""
        x = torch.from_numpy(rng.standard_normal((nb, spec.h, spec.w, spec.cin))
                             .astype(np.float32)).to(dev, dt)
        return x, invres.prepare_operands(
            {k: (v.to(dt) if k in ("w1", "w2") else v) for k, v in ops.items()}, spec, dt)

    block_rows = {}
    for dt in (bf16, f32):
        pname = "bf16" if dt == bf16 else "fp32"
        for label, (spec, ops, nb) in block_cases[:6]:
            x, ops_dt = block_inputs(spec, ops, nb, dt)
            lib = block_library(spec, ops_dt, dt)
            xl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
            t = timed({"kernel": lambda: invres.fused_invres_block(x, ops_dt, spec),
                       "plain": lambda: invres.invres_block_reference(x, ops_dt, spec),
                       "library": lambda: lib(xl)})
            flops, nbytes = block_work(spec, nb, dt)
            b_ms, b_by = bound(flops, nbytes, dt)
            log(f"[timing] fused_invres_block {pname} {label} b{nb}: {timing_text(t)} "
                f"bound {b_ms:.5f} ms ({b_by}; "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB{tf32(flops, nbytes, dt)[1]}) "
                f"| {card}")
        # The 11 launches of one MobileNetV2 224 b8 step, back to back.
        step = [(spec, *block_inputs(spec, ops, 8, dt)) for _name, spec, ops in mnv2_blocks]
        libs = [(block_library(spec, ops_dt, dt), x.permute(0, 3, 1, 2))
                for spec, x, ops_dt in step]
        t = timed({"kernel": lambda: [invres.fused_invres_block(x, o, sp) for sp, x, o in step],
                   "plain": lambda: [invres.invres_block_reference(x, o, sp) for sp, x, o in step],
                   "library": lambda: [fn(xl) for fn, xl in libs]})
        work = [block_work(spec, 8, dt) for spec, _x, _o in step]
        # The step's bound is the sum of the blocks' bounds; it is "bound by"
        # the resource that bounds the larger share of that sum.
        share = {"operations": 0.0, "bytes": 0.0}
        for f, b in work:
            t_b, by = bound(f, b, dt)
            share[by] += t_b
        b_ms = sum(share.values())
        b_by = max(share, key=share.get)
        b3 = ({"bound_3xtf32_ms": sum(tf32(f, b, dt)[0]["bound_3xtf32_ms"] for f, b in work)}
              if dt == f32 else {})
        b3_text = f"; 3xTF32 bound {b3['bound_3xtf32_ms']:.5f} ms" if b3 else ""
        block_rows[pname] = dict(**timing_keys(t), bound_ms=b_ms, bound_by=b_by, **b3)
        log(f"[timing] fused_invres_block {pname} MobileNetV2 224 b8, sum of the 11 launches "
            f"of one step: {timing_text(t)} "
            f"bound {b_ms:.5f} ms (operations-bound blocks {share['operations']:.5f} ms, "
            f"bytes-bound {share['bytes']:.5f} ms; {sum(f for f, _ in work) / 1e9:.3f} "
            f"GFLOP, {sum(b for _, b in work) / 1e6:.3f} MB, {peak_key} peaks{b3_text}) | {card}")

    def conv_yardstick(x, wts, sc, of, pads, act, dt):
        """cuDNN yardstick of one stride-1 conv: F.conv2d on channels_last
        tensors and the epilogue in the compute dtype. Timed only; the port
        never calls it."""
        pt, pb, pl, pr = pads
        xl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        w_lib = wts.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=cl)
        sc_lib, of_lib = (v.to(dt).reshape(1, -1, 1, 1) for v in (sc, of))
        even = pt == pb and pl == pr

        def run():
            with full_precision():
                y = (F.conv2d(xl, w_lib, padding=(pt, pl)) if even
                     else F.conv2d(F.pad(xl, (pl, pr, pt, pb)), w_lib))
            return apply_activation(y * sc_lib + of_lib, act)
        return run

    def time_conv(entry, label, kernel, plain, nb, h, w, wts, sc, of, pads, act, dt):
        """One [timing] line of a stride-1 conv kernel at x (nb,h,w,c);
        `kernel` and `plain` take (x, wts, sc, of, pads, act), `kernel`
        returning the launch on operands it prepared."""
        kh, kw, c, o = wts.shape
        pname = "bf16" if dt == bf16 else "fp32"
        x = tensor(rng.standard_normal((nb, h, w, c)), dt)
        wts = wts.to(dt)
        t = timed({"kernel": kernel(x, wts, sc, of, pads, act),
                   "plain": lambda: plain(x, wts, sc, of, pads, act),
                   "library": conv_yardstick(x, wts, sc, of, pads, act, dt)})
        ho, wo = h + pads[0] + pads[1] - kh + 1, w + pads[2] + pads[3] - kw + 1
        isz = 2 if dt == bf16 else 4
        flops = 2.0 * nb * ho * wo * kh * kw * c * o
        nbytes = (x.numel() + nb * ho * wo * o + wts.numel()) * isz + 2 * o * 4
        b_ms, b_by = bound(flops, nbytes, dt)
        b3, b3_text = tf32(flops, nbytes, dt)
        log(f"[timing] {entry} {pname} {label} b{nb}: {timing_text(t)} bound {b_ms:.5f} ms "
            f"({b_by}; {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB{b3_text}) | {card}")
        return dict(**timing_keys(t), bound_ms=b_ms, bound_by=b_by, **b3)

    def random_conv(c, k, o):
        return (tensor(rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)),
                tensor(1 + 0.1 * rng.standard_normal(o)), tensor(0.1 * rng.standard_normal(o)))

    # Both per-layer conv kernels at the wide ResNet18 shapes (b8): the
    # single-conv kernel launches them on the ResNet18 path, the
    # implicit-GEMM form is meant for them. Then each at its own main-path
    # shape: the trained MobileNetV2's stem (b64), the two-input conv (b8).
    # `single` and `igemm` prepare the operands once and return the launch,
    # so that a timed call launches the kernel alone.
    def single(x, wts, sc, of, pads, act):
        ops = conv.prepare(wts, sc, of, x.dtype)
        return lambda: conv.run(x, ops, pads, act, 0.3)

    def single_plain(x, wts, sc, of, pads, act):
        return conv.conv2d_haloed_reference(x, wts, sc, of, pads, act, 0.3, x.dtype)

    def igemm(x, wts, sc, of, pads, act):
        ops = conv_igemm.prepare(wts, sc, of, x.dtype)
        return lambda: conv_igemm.run(x, ops, stride=1, pads=pads, activation=act)

    def igemm_plain(x, wts, sc, of, pads, act):
        return conv_igemm.conv2d_igemm_reference(x, wts, sc, of, 1, pads, act)

    conv_rows, igemm_rows = {}, {}
    same3 = (1, 1, 1, 1)
    for dt in (bf16, f32):
        pname = "bf16" if dt == bf16 else "fp32"
        for label, hw, c in (("k3 c64->64 32x32", 32, 64), ("k3 c128->128 16x16", 16, 128)):
            ops = random_conv(c, 3, c)
            conv_rows[(label, pname)] = time_conv(
                "fused_conv2d_haloed", label, single, single_plain, 8, hw, hw, *ops, same3,
                "relu", dt)
            igemm_rows[(label, pname)] = time_conv(
                "conv2d_kernel_nhwc", label, igemm, igemm_plain, 8, hw, hw, *ops, same3,
                "relu", dt)
        conv_rows[pname] = time_conv(
            "fused_conv2d_haloed", "stem 16x16 12->16 k2", single, single_plain, 64, 16, 16,
            *stem_ops, stem_pads, str(stem.attr("activation")), dt)
        # The 8 single-conv launches of one forced-KERNEL ResNet18 step at the
        # zoo width (b8), with the model's folded weights, back to back; the
        # same convs on cuDNN beside them.
        step = [(tensor(rng.standard_normal((nb, h, w, wts.shape[2])), dt), wts.to(dt), sc, of,
                 pads, act) for nb, h, w, (wts, sc, of), pads, act in zoo_step]
        libs = [conv_yardstick(*args, dt) for args in step]
        launches = [single(*args) for args in step]
        t = timed({"kernel": lambda: [fn() for fn in launches],
                   "plain": lambda: [single_plain(*args) for args in step],
                   "library": lambda: [fn() for fn in libs]})
        share, work, step_work = {"operations": 0.0, "bytes": 0.0}, [0.0, 0.0], []
        for x, wts, _sc, _of, (pt, pb, pl, pr), _act in step:
            kh, kw, c, o = wts.shape
            ho, wo = x.shape[1] + pt + pb - kh + 1, x.shape[2] + pl + pr - kw + 1
            flops = 2.0 * x.shape[0] * ho * wo * kh * kw * c * o
            nbytes = (x.numel() + x.shape[0] * ho * wo * o + wts.numel()) * x.element_size() + 8 * o
            t_b, by = bound(flops, nbytes, dt)
            share[by] += t_b
            work[0] += flops
            work[1] += nbytes
            step_work.append((flops, nbytes))
        b_ms, b_by = sum(share.values()), max(share, key=share.get)
        b3 = ({"bound_3xtf32_ms": sum(tf32(f, b, dt)[0]["bound_3xtf32_ms"] for f, b in step_work)}
              if dt == f32 else {})
        b3_text = f"; 3xTF32 bound {b3['bound_3xtf32_ms']:.5f} ms" if b3 else ""
        conv_rows[("resnet18 zoo width b8, sum of the 8 launches of one step", pname)] = dict(
            **timing_keys(t), bound_ms=b_ms, bound_by=b_by, **b3)
        log(f"[timing] fused_conv2d_haloed {pname} ResNet18 zoo width b8, sum of the 8 launches "
            f"of one step: {timing_text(t)} bound {b_ms:.5f} ms (operations-bound convs "
            f"{share['operations']:.5f} ms, bytes-bound {share['bytes']:.5f} ms; "
            f"{work[0] / 1e9:.3f} GFLOP, {work[1] / 1e6:.3f} MB, {peak_key} peaks{b3_text}) | {card}")
        nb, h, w, c, k, o = TWO_INPUT
        igemm_rows[pname] = time_conv(
            "conv2d_kernel_nhwc", "two-input k3 c8->16 540x960", igemm, igemm_plain, nb, h, w,
            *random_conv(c, k, o), same3, "relu", dt)

    def library_text(t, name):
        return timing_text(t).replace("cudnn", name)

    # The fused matmul at the classifier heads of the main paths (and
    # MobileNetV2's, the widest softmax); library: one addmm with the scale
    # folded into W, then the softmax.
    matmul_rows = {}
    for label, m, k, n in (("resnet18 fc 8x512x10", 8, 512, 10),
                           ("trained fc 64x128x10", 64, 128, 10),
                           ("mobilenetv2 fc 8x1280x1000", 8, 1280, 1000)):
        for dt in (bf16, f32):
            pname = "bf16" if dt == bf16 else "fp32"
            x = tensor(rng.standard_normal((m, k)), dt)
            wts = tensor(rng.standard_normal((k, n)) / np.sqrt(k), dt)
            sc = tensor(1 + 0.1 * rng.standard_normal(n))
            of = tensor(0.1 * rng.standard_normal(n))
            w_lib, of_lib = (wts.float() * sc).to(dt), of.to(dt)
            t = timed({
                "kernel": lambda: matmul.fused_matmul(x, wts, sc, of, activation="softmax"),
                "plain": lambda: matmul.fused_matmul_reference(x, wts, sc, of, "softmax"),
                "library": lambda: torch.softmax(torch.addmm(of_lib, x, w_lib), dim=-1),
            })
            # One launch at every N: the call's only device work is the kernel.
            events = [k_ for k_, _ in device_profile(
                lambda: matmul.fused_matmul(x, wts, sc, of, activation="softmax"))[1]]
            assert len(events) == 1 and "matmul_fused_kernel" in events[0], events
            isz = 2 if dt == bf16 else 4
            flops = 2.0 * m * k * n
            nbytes = (m * k + k * n + m * n) * isz + 2 * n * 4
            b_ms, b_by = bound(flops, nbytes, dt)
            b3, b3_text = tf32(flops, nbytes, dt)
            matmul_rows[(label, pname)] = dict(**timing_keys(t), bound_ms=b_ms, bound_by=b_by, **b3)
            log(f"[timing] fused_matmul {pname} {label} softmax: {library_text(t, 'addmm+softmax')} "
                f"bound {b_ms:.6f} ms ({b_by}; {flops / 1e6:.3f} MFLOP, {nbytes / 1e3:.1f} KB"
                f"{b3_text}) | {card}")

    # INT8 timings: each form beside its plain version and the bf16 form of
    # the same kernel in this run; the bound at the int8 peak for the s8
    # products and at the bf16 peak for the rest. The weight-only forms have
    # a library yardstick: cuDNN on the int8 weights cast to bf16 (exact)
    # with the folded f32 scale in the epilogue, the same function. No
    # library call computes the a8 / A8W8 forms (cuDNN takes no int8
    # activations there): library null.

    def timing_keys_i8(t):
        lib = t.get("library", (None, None))
        return dict(ms=t["kernel"][0], plain_ms=t["plain"][0], library_ms=lib[0],
                    device_ms=t["kernel"][1], plain_device_ms=t["plain"][1],
                    library_device_ms=lib[1])

    def text_i8(t):
        lib = (f" cudnn {t['library'][0]:.4f} ms (device {t['library'][1]:.4f})"
               if "library" in t else "")
        return (f"kernel {t['kernel'][0]:.4f} ms (device {t['kernel'][1]:.4f}) "
                f"plain {t['plain'][0]:.4f} ms (device {t['plain'][1]:.4f}){lib}")


    def bound_i8(flops_bf16, flops_int8, nbytes):
        t_ops = (flops_bf16 / peak_bf16 + flops_int8 / peak_int8) * 1e3
        t_bytes = nbytes / peak_bw * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    i8_rows = {}
    x = torch.from_numpy(frames).to(dev)
    for form, specs, ops in (("int8 weights", espcn_w8_specs, espcn_w8_ops),
                             ("a8", espcn_a8_specs, espcn_a8_ops)):
        prep = chain.prepare(ops, specs, bf16)
        fns = {"kernel": lambda: chain.fused_conv_chain_packed(
                   x, prep, specs, tail="d2s2", compute_dtype=bf16),
               "plain": lambda: chain.conv_chain_reference(x, ops, specs, "d2s2", bf16)}
        if not any(sp.in_q for sp in specs):
            fns["library"] = chain_library(x, ops, specs, "d2s2", bf16)
        t = timed(fns)
        per_layer = [2.0 * 8 * 540 * 960 * sp.k * sp.k * sp.c * sp.o for sp in specs]
        f_i8 = sum(f for f, sp in zip(per_layer, specs) if sp.in_q)
        nbytes = x.numel() * 4 + 8 * 1080 * 1920 * 2 + sum(
            p["w"].numel() + 8 * p["scale"].numel() for p in ops)
        b_ms, b_by = bound_i8(sum(per_layer) - f_i8, f_i8, nbytes)
        i8_rows[("chain", form)] = dict(**timing_keys_i8(t), bound_ms=b_ms, bound_by=b_by)
        bf = rows[("fused_conv_chain_packed", 8)]
        log(f"[timing] fused_conv_chain_packed {form} espcn 540x960 b8 (in_q "
            f"{[round(sp.in_q, 5) for sp in specs]}): {text_i8(t)} bound {b_ms:.4f} ms ({b_by}; "
            f"{f_i8 / 1e9:.2f} of {sum(per_layer) / 1e9:.2f} GFLOP at the int8 peak); the bf16 "
            f"form (float weights): kernel {bf['ms']:.4f} ms (device {bf['device_ms']:.4f}) | "
            f"{card}")
    for variant, calibrated in (("int8 weights", False), ("A8W8", True)):
        cases = i8_blocks[("mnv2 224", calibrated)]
        step = []
        for _label, spec, ops, nb_ in cases:
            xb = torch.from_numpy(rng.standard_normal((nb_, spec.h, spec.w, spec.cin))
                                  .astype(np.float32)).to(dev, bf16)
            step.append((spec, xb, invres.prepare_operands(ops, spec, bf16)))
        fns = {"kernel": lambda: [invres.fused_invres_block(xb, o, sp) for sp, xb, o in step],
               "plain": lambda: [invres.invres_block_reference(xb, o, sp) for sp, xb, o in step]}
        if not calibrated:  # int8 w1 / w2 cast to bf16 in the yardstick
            libs = [(block_library(sp, o, bf16), xb.permute(0, 3, 1, 2)) for sp, xb, o in step]
            fns["library"] = lambda: [fn(xl) for fn, xl in libs]
        t = timed(fns)
        f16 = f8 = nbytes = 0.0
        for spec, _xb, _o in step:
            px = 8 * spec.h * spec.w
            f1 = 2.0 * px * spec.cin * spec.e if spec.has_expand else 0.0
            f2 = 2.0 * px * spec.e * spec.cout
            f16 += 2.0 * px * 9 * spec.e + (0 if spec.ax1 else f1) + (0 if spec.ax2 else f2)
            f8 += (f1 if spec.ax1 else 0) + (f2 if spec.ax2 else 0)
            nbytes += px * (spec.cin + spec.cout) * 2 + (spec.cin * spec.e + spec.e * spec.cout) \
                + (9 * spec.e + 4 * spec.e + 2 * spec.cout) * 4
        b_ms, b_by = bound_i8(f16, f8, nbytes)
        i8_rows[("block", variant)] = dict(**timing_keys_i8(t), bound_ms=b_ms, bound_by=b_by)
        bf = block_rows["bf16"]
        log(f"[timing] fused_invres_block {variant} MobileNetV2 224 b8, sum of the 11 launches of "
            f"one step: {text_i8(t)} bound {b_ms:.5f} ms ({b_by}; {f8 / 1e9:.3f} GFLOP at the "
            f"int8 peak, {f16 / 1e9:.3f} at bf16); the bf16 form: kernel {bf['ms']:.4f} ms "
            f"(device {bf['device_ms']:.4f}) | {card}")
    # The single-conv launches of one INT8 step of each trained classifier
    # (b64; under AUTO each has one, its stem), int8 weights, beside the
    # bf16 form on the same geometries (weights dequantized to bf16).
    for tag, eng in (("ResNet18 cls10", r18_c), ("MobileNetV2 cls10", cls10_c)):
        step_i8, step_bf = [], []
        for name_ in eng.model.forward.single_conv_plan:
            node = eng.graph.nodes[name_]
            s_ = eng.graph.nodes[node.inputs[0]].out_spec
            wq, sc, of = (t_.to(dev) for t_ in folded_operands(node, bf16))
            pads = padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size")))
            act = str(node.attr("activation", "linear"))
            xb = tensor(rng.standard_normal((64, s_.h, s_.w, s_.c)), bf16)
            step_i8.append((xb, wq, sc, of, pads, act))
            step_bf.append((xb, wq.to(bf16), sc, of, pads, act))
        libs = [conv_yardstick(*a, bf16) for a in step_i8]  # int8 weights cast to bf16
        launches_i8, launches_bf = ([single(*a) for a in step] for step in (step_i8, step_bf))
        t = timed({"kernel": lambda: [fn() for fn in launches_i8],
                   "plain": lambda: [single_plain(*a) for a in step_i8],
                   "library": lambda: [fn() for fn in libs]})
        t_bf = timed({"bf16": lambda: [fn() for fn in launches_bf]})["bf16"]
        flops = nbytes = 0.0
        for xb, wq, _sc, _of, (pt, pb, pl, pr), _act in step_i8:
            kh, kw, c_, o_ = wq.shape
            ho, wo = xb.shape[1] + pt + pb - kh + 1, xb.shape[2] + pl + pr - kw + 1
            flops += 2.0 * 64 * ho * wo * kh * kw * c_ * o_
            nbytes += (xb.numel() + 64 * ho * wo * o_) * 2 + wq.numel() + 8 * o_
        b_ms, b_by = bound_i8(flops, 0.0, nbytes)
        i8_rows[("single", tag)] = dict(**timing_keys_i8(t), bound_ms=b_ms, bound_by=b_by,
                                        bf16_form_ms=t_bf[0], bf16_form_device_ms=t_bf[1])
        log(f"[timing] fused_conv2d_haloed int8 weights {tag} b64, the {len(step_i8)} "
            f"single-conv launch(es) of one INT8 step: {text_i8(t)} bound {b_ms:.5f} ms "
            f"({b_by}; bf16 products); the bf16 form (float weights): kernel {t_bf[0]:.4f} ms "
            f"(device {t_bf[1]:.4f}) | {card}")

    # The int8-weight forms of B2 (the chain's im2col entry at the trained
    # ResNet18's first chain, b64), B5 (the two-input conv, b8) and B6 (both
    # ResNet18 heads), each beside its plain version and the library call
    # on the weights cast to bf16 (cuDNN; addmm with the scale folded, then
    # the softmax).
    specs_, ops_, shape = r18_chains_i8[0]
    x = tensor(rng.random(shape), bf16)
    prep = chain.prepare(ops_, specs_, bf16)
    t = timed({"kernel": lambda: chain.fused_conv_chain(x, prep, specs_, compute_dtype=bf16),
               "plain": lambda: chain.conv_chain_reference(x, ops_, specs_, "none", bf16),
               "library": chain_library(x, ops_, specs_, "none", bf16)})
    n_, h_, w_, _ = shape
    flops = 2.0 * n_ * h_ * w_ * sum(sp.k * sp.k * sp.c * sp.o for sp in specs_)
    nbytes = (x.numel() + n_ * h_ * w_ * specs_[-1].o) * 2 + sum(
        p["w"].numel() + 8 * p["scale"].numel() for p in ops_)
    b_ms, b_by = bound_i8(flops, 0.0, nbytes)
    i8_rows[("chain", "resnet18 int8 weights")] = dict(**timing_keys_i8(t), bound_ms=b_ms,
                                                       bound_by=b_by)
    bf = chain_resnet_rows["bf16"]
    log(f"[timing] fused_conv_chain int8 weights resnet18 cls10 chain "
        f"{'->'.join(str(sp.o) for sp in specs_)} {h_}x{w_} b{n_}: {text_i8(t)} bound "
        f"{b_ms:.5f} ms ({b_by}; bf16 products); the bf16 form (float weights): kernel "
        f"{bf['ms']:.4f} ms (device {bf['device_ms']:.4f}) | {card}")
    nb_, h_, w_, c_, k_, o_ = TWO_INPUT
    x = tensor(rng.random((nb_, h_, w_, c_)), bf16)
    t = timed({"kernel": igemm(x, *two_ops, same3, "relu"),
               "plain": lambda: conv_igemm.conv2d_igemm_reference(x, *two_ops, 1, same3, "relu"),
               "library": conv_yardstick(x, *two_ops, same3, "relu", bf16)})
    flops = 2.0 * nb_ * h_ * w_ * k_ * k_ * c_ * o_
    nbytes = (x.numel() + nb_ * h_ * w_ * o_) * 2 + two_ops[0].numel() + 8 * o_
    b_ms, b_by = bound_i8(flops, 0.0, nbytes)
    i8_rows[("igemm", "int8 weights")] = dict(**timing_keys_i8(t), bound_ms=b_ms, bound_by=b_by)
    bf = igemm_rows["bf16"]
    log(f"[timing] conv2d_kernel_nhwc int8 weights two-input k3 c8->16 540x960 b8: {text_i8(t)} "
        f"bound {b_ms:.5f} ms ({b_by}; bf16 products); the bf16 form (float weights): kernel "
        f"{bf['ms']:.4f} ms (device {bf['device_ms']:.4f}) | {card}")
    # The fp32 form on the same int8 weights (3xTF32, two passes): the
    # library call on the weights cast to f32 (exact).
    x = tensor(rng.random((nb_, h_, w_, c_)))
    t = timed({"kernel": igemm(x, *two_ops, same3, "relu"),
               "plain": lambda: conv_igemm.conv2d_igemm_reference(x, *two_ops, 1, same3, "relu"),
               "library": conv_yardstick(x, *two_ops, same3, "relu", f32)})
    nbytes = (x.numel() + nb_ * h_ * w_ * o_) * 4 + two_ops[0].numel() + 8 * o_
    b_ms, b_by = bound(flops, nbytes, f32)
    b3, b3_text = tf32(2 / 3 * flops, nbytes, f32)  # two passes of three
    i8_rows[("igemm", "int8 weights fp32")] = dict(**timing_keys_i8(t), bound_ms=b_ms,
                                                  bound_by=b_by, **b3)
    log(f"[timing] conv2d_kernel_nhwc fp32 with int8 weights two-input k3 c8->16 540x960 b8: "
        f"{text_i8(t)} bound {b_ms:.5f} ms ({b_by}{b3_text}, two passes) | {card}")
    for tag, eng, m in (("resnet18 zoo fc", r18zoo_i8[0], 8), ("resnet18 cls10 fc", r18_c, 64)):
        fc_ops = tuple(t_.to(dev) for t_ in folded_operands(eng.graph.nodes["fc"], bf16))
        wq, sc, of = fc_ops
        k_, n_ = wq.shape
        x = tensor(rng.standard_normal((m, k_)), bf16)
        w_lib, of_lib = (wq.float() * sc).to(bf16), of.to(bf16)
        t = timed({"kernel": lambda: matmul.fused_matmul(x, *fc_ops, activation="softmax"),
                   "plain": lambda: matmul.fused_matmul_reference(x, *fc_ops, "softmax"),
                   "library": lambda: torch.softmax(torch.addmm(of_lib, x, w_lib), dim=-1)})
        b_ms, b_by = bound_i8(2.0 * m * k_ * n_, 0.0, (m * k_ + m * n_) * 2 + k_ * n_ + 8 * n_)
        i8_rows[("matmul", tag)] = dict(**timing_keys_i8(t), bound_ms=b_ms, bound_by=b_by)
        log(f"[timing] fused_matmul int8 weights {tag} {m}x{k_}x{n_} softmax: "
            f"{text_i8(t).replace('cudnn', 'addmm+softmax')} bound {b_ms:.6f} ms ({b_by}; bf16 "
            f"products) | {card}")

    # What each entry ran beyond its BF16/FP32 forms: the INT8 forms, their
    # launches on the INT8 paths, their [kernel] errors and timings.
    def i8_launches(key, kind):
        return i8_main[key]["per_step"][kind] * (4 if "cls10" in key else STEPS)

    chain_int8 = {
        "fused_conv_chain_packed": {
            "forms": ["bf16 (ESPCN BF16)", "bf16 with int8 weights (ESPCN INT8 weight-only)",
                      "bf16 with a8 int8 x int8 layers (ESPCN INT8 calibrated)"],
            "int8": {"int8 weights": dict(**i8_rows[("chain", "int8 weights")],
                                          launches=i8_launches("espcn weight-only", "chains")),
                     "a8": dict(**i8_rows[("chain", "a8")],
                                launches=i8_launches("espcn a8", "chains"),
                                in_q=espcn_in_q,
                                psnr_vs_fp32_db=i8_main["espcn a8"]["psnr_vs_fp32_db"]),
                     "max_abs_err": {"int8 weights": i8_err["chain_w8"], "a8": i8_err["chain_a8"]},
                     "psnr_weight_only_vs_fp32_db": i8_main["espcn weight-only"]["psnr_vs_fp32_db"],
                     "engine_steps": {k: v for k, v in i8_steps.items() if "espcn" in k},
                     "planted_fault_in_q_halved_diff": fault_errs["chain_in_q_halved"]}},
        "fused_conv_chain": {
            "forms": ["fp32: 3xTF32 on mma.sync m16n8k8, a persistent grid, regions split into "
                      "TF32 hi and lo by their producer (conv_chain_tf32_kernel; ESPCN FP32, "
                      "trained ResNet18 FP32)",
                      "fp32 with int8 weights: two passes",
                      "bf16 (trained ResNet18 BF16)",
                      "bf16 with int8 weights (trained ResNet18 INT8)"],
            "fp32_edges_max_abs_diff": f32_err,
            "fp32_x1e2_vs_float64": chain_f64_errs,
            "fp32_int8_weights_max_abs_diff": i8_err["chain_f32_w8"],
            "int8": {"launches": i8_launches("resnet18 cls10 b64 (logits) calibrated", "chains"),
                     "max_abs_err": i8_err["chain_w8"],
                     "resnet18_trained_chain": i8_rows[("chain", "resnet18 int8 weights")]}},
    }
    # 6. zoo -------------------------------------------------------------------
    zoo_out = zoo_phase(types.SimpleNamespace(
        dev=dev, rng=rng, log=log, STEPS=STEPS, ENGINE_TOL=ENGINE_TOL, card=card, held=held,
        timed=timed, busy_text=busy_text, reset_counts=reset_counts, read_counts=read_counts,
        held_to_plans=held_to_plans, on_dev=on_dev, chain_library=chain_library,
        conv_yardstick=conv_yardstick, bound=bound, tf32=tf32, timing_keys=timing_keys,
        timing_text=timing_text))

    # 7. serve ----------------------------------------------------------------
    serve_out = serve_phase(types.SimpleNamespace(
        dev=dev, log=log, card=card, reset_counts=reset_counts, read_counts=read_counts,
        held_to_plans=held_to_plans,
        espcn_busy_ms=main_stats["fused_conv_chain_packed"]["device_busy_ms"]))

    # 8. io ---------------------------------------------------------------------
    io_out = io_phase(types.SimpleNamespace(
        dev=dev, log=log, card=card, reset_counts=reset_counts, read_counts=read_counts,
        held_to_plans=held_to_plans))
    # 9. train --------------------------------------------------------------------
    phase_h = types.SimpleNamespace(
        dev=dev, log=log, card=card, reset_counts=reset_counts, read_counts=read_counts,
        held_to_plans=held_to_plans)
    train_out = train_phase(phase_h)

    # 10. accuracy -------------------------------------------------------------------
    acc_out = accuracy_phase(phase_h)

    # 11. parallel ---------------------------------------------------------------------
    par_out = parallel_phase(types.SimpleNamespace(
        dev=dev, log=log, card=card, STEPS=STEPS, ENGINE_TOL=ENGINE_TOL, held=held,
        reset_counts=reset_counts, read_counts=read_counts, conv_yardstick=conv_yardstick,
        bound=bound, tf32=tf32, time_ms=time_ms, busy_text=busy_text))

    # 12. pipeline --------------------------------------------------------------------
    pipe_out = pipeline_phase(types.SimpleNamespace(
        dev=dev, log=log, card=card, STEPS=STEPS, ENGINE_TOL=ENGINE_TOL, held=held,
        reset_counts=reset_counts, read_counts=read_counts, conv_yardstick=conv_yardstick,
        bound=bound, tf32=tf32, time_ms=time_ms))

    def trained_rows(entry):
        """Where phases 9 and 10 launched this entry: the trained-on-the-card
        ResNet18 reloaded at BF16 AUTO, and the accuracy report's engines."""
        rows = {}
        r18 = train_out["resnet18"]
        if r18["reloaded_launches"].get(entry):
            rows["train"] = {
                "configuration": "ResNet18 (base 16) trained 600 steps on the card, exported "
                                 "and reloaded through Engine.from_json at BF16 AUTO b64, 4 steps",
                "launches": r18["reloaded_launches"][entry],
                "launches_per_step": r18["reloaded_launches"][entry] // r18["reloaded_steps"],
                "max_abs_diff_vs_torch": r18["reloaded_max_abs_diff"],
                "top1": r18["reloaded_top1"]}
        if acc_out["launches"].get(entry):
            rows["accuracy"] = {
                "configuration": "tools/accuracy_report.py main: the zoo at FP32/BF16/INT8 b1 and "
                                 "every trained artifact, AUTO (the ESPCN A8W8 row KERNEL)",
                "launches": acc_out["launches"][entry], "rc": acc_out["rc"]}
        return rows

    kernel_ids = {"fused_conv_chain_packed": "conv_chain", "fused_conv_chain": "conv_chain",
                  "fused_conv2d_haloed": "conv_single", "fused_invres_block": "invres",
                  "fused_matmul": "matmul_fused"}

    def io_rows(entry):
        """What the io phase ran on one entry: per path its launches per
        step and (ONNX-imported paths, the dump-mode forward) the device ms
        per launch from torch.profiler."""
        def ms_of(row):
            ms = {k: v for k, v in row.get("device_ms_per_launch", {}).items()
                  if k.startswith(kernel_ids[entry])}
            return next(iter(ms.values())) if len(ms) == 1 else ms or None

        rows = {}
        for kind in ("onnx", "serialize"):
            for label, row in io_out[kind].items():
                if row["launches_per_step"].get(entry):
                    rows[f"{kind} {label}"] = {
                        "launches_per_step": row["launches_per_step"][entry],
                        "max_abs_diff_vs_native": row["max_abs_diff"],
                        **({"device_ms_per_launch": ms_of(row),
                            "step_p50_ms": row["step_p50_ms"]} if kind == "onnx" else {})}
        if entry == "fused_conv2d_haloed":
            for prec, row in io_out["dumps"].items():
                if isinstance(row, dict):
                    rows[f"dump-mode espcn 540p b8 {prec}"] = {
                        "launches_per_step": 3, "device_ms_per_launch": ms_of(row),
                        "dump_step_p50_ms": row["dump_step_p50_ms"],
                        "chained_step_p50_ms": row["chained_step_p50_ms"]}
        return rows

    def zoo_rows(entry):
        """What the zoo phase ran on one entry: its launches per path (all
        steps), [kernel] errors per form and [timing] rows per shape."""
        return {"launches": {label: st["launches"][entry] for label, st in zoo_out["paths"].items()
                             if entry in st["launches"]},
                "max_abs_err": {k.split(" ", 1)[1]: v for k, v in zoo_out["max_abs_err"].items()
                                if k.split(" ", 1)[0] == entry},
                "timing": zoo_out["timing"].get(entry, {})}

    kernels = []
    for entry, replaces, prec in (
        ("fused_conv_chain_packed", "shadernn_tpu/kernels/chain_packed_pallas.py:121", "bf16"),
        ("fused_conv_chain", "shadernn_tpu/kernels/chain_pallas.py:79", "fp32"),
    ):
        r = rows[(entry, 8)]
        elastic = entry == "fused_conv_chain_packed"
        kernels.append({
            "name": f"conv_chain.{entry}",
            "route": "cuda",
            "source": "shadernn_tpu_torch/csrc/conv_chain.cu",
            "replaces": replaces,
            "launches": main_stats[entry]["launches"] + (
                pipe_out["launches"][entry] if elastic else 0),
            "max_abs_err": max(errs[(prec, 8)], pipe_out["max_abs_err"][entry] if elastic else 0),
            "max_abs_diff": errs[(prec, 8)],
            **r,
            "shape": f"{prec} 8x540x960x1",
            "resnet18_trained_chain": chain_resnet_rows[prec],
            "resnet18_trained_chains_max_abs_diff": chain_resnet_err,
            "engine_step_p50_ms": main_stats[entry]["engine_p50_ms"],
            "engine_device_busy_ms": main_stats[entry]["device_busy_ms"],
            **chain_int8[entry],
            "zoo": zoo_rows(entry),
            "io": io_rows(entry),
            **trained_rows(entry),
            **({"serve": {
                "launches_per_batch": 1,
                "configuration": "ESPCN 2x (trained) 540p b8 BF16 under StreamingEngine: 4 "
                                 "streams x 64 frames, uint8 ingest and float32, max_inflight "
                                 "1 and 4; the exported engine served for 64 frames",
                "runs": serve_out["espcn"]["rows"],
                "step_only_fps": serve_out["espcn"]["step_only_fps"],
                "download_ms": serve_out["espcn"]["download_ms"],
                "exported": serve_out["exported"]}} if entry == "fused_conv_chain_packed"
               else {}),
            **({"elastic": {
                "configuration": "phase 12: ElasticEngine shrunk to one entry of [cuda:0] * 4: a "
                                 "single-device engine, ESPCN 540p BF16 in buckets of 2; the "
                                 "hangs on a one-device ElasticEngine at b2; launches above "
                                 "include these",
                "launches_per_engine_step": 1,
                "runs": {k: v for k, v in pipe_out["elastic"].items()
                         if k not in ("data 4", "data 2")}}}
               if elastic else {}),
        })
    r = block_rows["bf16"]
    kernels.append({
        "name": "invres.fused_invres_block",
        "route": "cuda",
        "source": "shadernn_tpu_torch/csrc/invres_block.cu",
        "replaces": "shadernn_tpu/kernels/block_pallas.py:151",
        "launches": mnv2_stats["bf16"]["launches"],
        "max_abs_err": block_err,
        "max_abs_diff": block_err,
        **r,
        "shape": "bf16 MobileNetV2 224 b8: the 11 blocks of one step",
        "fp32": block_rows["fp32"],
        "engine_step_p50_ms": mnv2_stats["bf16"]["engine_p50_ms"],
        "engine_step_p50_ms_fp32": mnv2_stats["fp32"]["engine_p50_ms"],
        "engine_device_busy_ms": mnv2_stats["bf16"]["device_busy_ms"],
        "engine_device_busy_ms_fp32": mnv2_stats["fp32"]["device_busy_ms"],
        "engine_kernels_device_ms": {k: v["kernels_device_ms"] for k, v in mnv2_stats.items()},
        "engine_logits": {k: {"max_abs_diff": v["logits_max_abs_diff"],
                              "planted_fault_diff": v["planted_fault_logits_diff"]}
                          for k, v in mnv2_stats.items()},
        "forms": ["bf16", "fp32: 3xTF32 on mma.sync m16n8k8 (invres_tf32_kernel)",
                  "fp32 with int8 weights: 3xTF32, two passes (invres_tf32_kernel<NT, true>)",
                  "bf16 with int8 weights (MobileNetV2s INT8 weight-only)",
                  "bf16 A8W8: s8 expand (ax1) and project (ax2) (MobileNetV2s INT8 calibrated)"],
        "int8": {variant: dict(**i8_rows[("block", variant)], launches=i8_launches(
                     f"mobilenetv2 224 {key}", "fused_invres_block"))
                 for variant, key in (("int8 weights", "weight-only"), ("A8W8", "A8W8"))}
        | {"max_abs_err": {"int8 weights": i8_err["block_w8"], "A8W8": i8_err["block_a8w8"]},
           "planted_fault_ax2_doubled_diff": fault_errs["block_ax2_doubled"],
           "engine_steps": {k: v for k, v in i8_steps.items() if "mobilenetv2" in k},
           "top1": {k: v["top1"] for k, v in i8_main.items() if "mobilenetv2 cls10" in k}},
        "io": io_rows("fused_invres_block"),
        **trained_rows("fused_invres_block"),
    })
    r = conv_rows["bf16"]
    kernels.append({
        "name": "conv.fused_conv2d_haloed",
        "route": "cuda",
        "source": "shadernn_tpu_torch/csrc/conv_single.cu",
        "replaces": "shadernn_tpu/kernels/conv_pallas.py:283",
        "launches": trained_stats["bf16"]["launches"],
        "max_abs_err": conv_err,
        "max_abs_diff": conv_err,
        **r,
        "shape": "bf16 64x16x16x12 -> 64x16x16x16, k2 (the trained MobileNetV2's folded stem)",
        "fp32": conv_rows["fp32"],
        "fp32_x1e2_vs_float64": conv_f64_errs,
        "other_shapes": {" ".join(key): row for key, row in conv_rows.items()
                         if isinstance(key, tuple)},
        "resnet18_launches_per_step": resnet_stats["bf16"]["per_step"]["fused_conv2d_haloed"],
        "resnet18_engine": {k: {"step_p50_ms": v["engine_p50_ms"], "device_busy_ms": v["device_busy_ms"],
                                "kernels_device_ms": v["kernels_device_ms"]}
                            for k, v in resnet_stats.items()},
        "trained_top1": {k: v["top1"] for k, v in trained_stats.items()},
        "engine_step_p50_ms": trained_stats["bf16"]["engine_p50_ms"],
        "forms": ["bf16", "fp32: 3xTF32 on mma.sync m16n8k8 (conv_single_tf32_kernel; two "
                  "passes from a bf16 input)",
                  "bf16 with int8 weights (trained ResNet18 and MobileNetV2 INT8)",
                  "wide body for kernels of 25 taps or more (StyleTransfer's k9 stem and "
                  "head): bf16 and int8 weights on mma.sync m16n8k16 "
                  "(conv_single_wide_kernel), fp32 exact on the CUDA cores "
                  "(conv_single_fma_kernel) where kw is 5, 7 or 9, else the tile body"],
        "int8": dict(**i8_rows[("single", "MobileNetV2 cls10")], launches=i8_launches(
            "mobilenetv2 cls10 b64 (logits) calibrated", "fused_conv2d_haloed"),
            resnet18_cls10=dict(**i8_rows[("single", "ResNet18 cls10")], launches=i8_launches(
                "resnet18 cls10 b64 (logits) calibrated", "fused_conv2d_haloed")),
            max_abs_err=i8_err["single_w8"],
            top1={k: v["top1"] for k, v in i8_main.items() if "resnet18 cls10" in k},
            planted_fault_weight_scale_zeroed_diff=fault_errs["weight_scale_zeroed"]),
        "zoo": zoo_rows("fused_conv2d_haloed"),
        "wide_body": zoo_out["wide_body"],
        "io": io_rows("fused_conv2d_haloed"),
        **trained_rows("fused_conv2d_haloed"),
        "serve": {"launches_per_batch": 1,
                  "configuration": "YOLOv3-tiny (trained) 256x256 b8 BF16 under "
                                   "StreamingEngine, 32 scenes (seed 7)",
                  **serve_out["yolo"]},
    })
    r = igemm_rows["bf16"]
    paths = {k: v for k, v in pipe_out["pipeline"].items()
             if isinstance(v, dict) and "launches_per_step" in v}
    kernels.append({
        "name": "conv_igemm.conv2d_kernel_nhwc",
        "route": "cuda",
        "source": "shadernn_tpu_torch/csrc/conv_igemm.cu",
        "replaces": "shadernn_tpu/kernels/conv_pallas.py:58",
        "launches": (two_stats["bf16"]["launches"] + par_out["launches"]
                     + pipe_out["launches"]["conv2d_kernel_nhwc"]),
        "max_abs_err": max(igemm_err, par_out["max_abs_err"],
                           pipe_out["max_abs_err"]["conv2d_kernel_nhwc"]),
        "max_abs_diff": igemm_err,
        **r,
        "shape": "bf16 8x540x960x(3+5) -> 8x540x960x16, k3 (the two-input conv graph)",
        "fp32": igemm_rows["fp32"],
        "other_shapes": {" ".join(key): row for key, row in igemm_rows.items()
                         if isinstance(key, tuple)},
        "engine_step_p50_ms": two_stats["bf16"]["engine_p50_ms"],
        "engine_step_p50_ms_fp32": two_stats["fp32"]["engine_p50_ms"],
        "engine_device_busy_ms": two_stats["bf16"]["device_busy_ms"],
        "engine_device_busy_ms_fp32": two_stats["fp32"]["device_busy_ms"],
        "engine_check": {k: {"max_abs_diff": v["max_abs_diff"],
                             "planted_fault_diff": v["planted_fault_diff"]}
                         for k, v in two_stats.items()},
        "forms": ["bf16: mma.sync m16n8k16, a persistent grid (conv_igemm_tc_kernel<NT, false>)",
                  "fp32: 3xTF32 on mma.sync m16n8k8 (conv_igemm_tc_kernel<NT, true>)",
                  "bf16 with int8 weights, upcast as staged (two-input graph INT8)",
                  "fp32 with int8 weights, upcast as staged: two passes"],
        "fp32_int8": i8_rows[("igemm", "int8 weights fp32")],
        "int8": {"launches": i8_launches("two-input KERNEL weight-only", "conv2d_kernel_nhwc"),
                 "max_abs_err": i8_err["igemm_w8"],
                 **i8_rows[("igemm", "int8 weights")],
                 "engine_max_abs_diff": i8_main["two-input KERNEL weight-only"]["max_abs_diff"]},
        **trained_rows("conv2d_kernel_nhwc"),
        "parallel": {
            "configuration": "phase 11: sharded engines on logical meshes of the card (one "
                             "device per shard), B5 launched once per shard for each kernel "
                             "conv; launches above include these",
            "launches": par_out["launches"],
            "paths": par_out["paths"],
            "max_abs_err": par_out["max_abs_err"],
            "timing": par_out["timing"],
            "planted_faults_diff": par_out["faults"],
            "multihost": par_out["multihost"],
            "logical_shards": par_out["scaling"]},
        "pipeline": {
            "configuration": "phase 12: PipelinedEngine, one stream per stage on cuda:0, B5 at "
                             "each kernel conv of each micro-batch; launches above include "
                             "these",
            "launches_per_step": {k: v["launches_per_step"] for k, v in paths.items()},
            "paths": paths,
            "throughput_stats": pipe_out["pipeline"][
                "throughput_stats espcn 540p b8 bf16 4 stages"],
            "dryrun": pipe_out["pipeline"]["dryrun"],
            "planted_fault_reversed_diff": pipe_out["pipeline"]["planted_fault_reversed_diff"],
            "timing": pipe_out["timing"]},
        "elastic": {
            "configuration": "phase 12: ElasticEngine, ESPCN 540p b8 BF16, ShardingOptions(data=4) "
                             "on [cuda:0] * 4, then entry 3 failed (data 2)",
            "launches_per_engine_step": {k: v["launches_per_engine_step"]
                                         for k, v in pipe_out["elastic"].items()
                                         if "conv2d_kernel_nhwc" in v.get("launches", {})},
            "runs": {k: pipe_out["elastic"][k] for k in ("data 4", "data 2")}},
    })
    r = matmul_rows[("resnet18 fc 8x512x10", "bf16")]
    kernels.append({
        "name": "matmul.fused_matmul",
        "route": "cuda",
        "source": "shadernn_tpu_torch/csrc/matmul_fused.cu",
        "replaces": "shadernn_tpu/kernels/matmul_pallas.py:32",
        "launches": resnet_stats["bf16"]["launches"],
        "max_abs_err": matmul_err,
        "max_abs_diff": matmul_err,
        **r,
        "shape": "bf16 8x512 @ 512x10, softmax (ResNet18's fc at the zoo width)",
        "fp32": matmul_rows[("resnet18 fc 8x512x10", "fp32")],
        "other_shapes": {f"{label} {pname}": row for (label, pname), row in matmul_rows.items()
                         if not label.startswith("resnet18")},
        "launches_trained": {k: v["launches"] for k, v in resnet_trained.items()},
        "resnet18_launches_per_step": resnet_stats["bf16"]["per_step"],
        "resnet18_trained_launches_per_step": resnet_trained["bf16"]["per_step"],
        "trained_top1": {k: v["top1"] for k, v in resnet_trained.items()},
        "engine_step_p50_ms": resnet_stats["bf16"]["engine_p50_ms"],
        "engine_step_p50_ms_fp32": resnet_stats["fp32"]["engine_p50_ms"],
        "engine_device_busy_ms": resnet_stats["bf16"]["device_busy_ms"],
        "engine_device_busy_ms_fp32": resnet_stats["fp32"]["device_busy_ms"],
        "engine_step_p50_ms_trained": {k: v["engine_p50_ms"] for k, v in resnet_trained.items()},
        "engine_logits_trained": {k: {"max_abs_diff": v["logits_max_abs_diff"],
                                      "planted_fault_diff": v["planted_fault_logits_diff"]}
                                  for k, v in resnet_trained.items()},
        "engine_logits": {k: {"max_abs_diff": v["logits_max_abs_diff"],
                              "planted_fault_diff": v["planted_fault_logits_diff"]}
                          for k, v in resnet_stats.items()},
        "forms": ["bf16", "fp32", "bf16 with int8 weights (forced-KERNEL ResNet18 INT8)"],
        "int8": {"launches": i8_launches("resnet18 zoo KERNEL weight-only", "fused_matmul"),
                 "max_abs_err": i8_err["matmul_w8"],
                 **i8_rows[("matmul", "resnet18 zoo fc")],
                 "resnet18_cls10_fc": i8_rows[("matmul", "resnet18 cls10 fc")],
                 "engine_max_abs_diff": i8_main["resnet18 zoo KERNEL weight-only"]["max_abs_diff"]},
        "io": io_rows("fused_matmul"),
        **trained_rows("fused_matmul"),
    })
    kernels.append({
        "name": "nms.suppress",
        "route": "cuda",
        "source": "shadernn_tpu_torch/csrc/yolo_nms.cu",
        "replaces": "shadernn_tpu_torch/ops/yolo.py nms_fixed (no TPU kernel: lax.fori_loop)",
        "shape": "8 x 2,535 candidates, the 100 best (YOLOv3-tiny 416 b8)",
        "cases": nms_rows,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def zoo_phase(h) -> dict:
    """6. zoo: the rest of the model zoo through Engine.from_json on the
    card, each trained artifact at full width and depth. `h` carries main's
    helpers (held, timed, busy_text, held_to_plans, ...).

    Main paths (counts set to 0 just before each, read just after, held to
    the forward's plans): SpatialDenoise and AIDenoise at 1080x1920 b2
    (BF16, FP32, INT8 weight-only; one chain per step), U-Net at 256x256
    b8 (BF16, FP32; three chains and one single conv), the five 512x512
    StyleTransfer styles at b4 (FP32; candy also BF16; two single convs),
    YOLOv3-tiny at 256x256 b8 (FP32, BF16; one single conv; its raw head
    features and its detections). Each against the port's TORCH forward
    (0.01 fp32, 0.1 bf16/int8, times max(1, max|TORCH|); detections
    matched box to box, utils/metrics.py detections_agree). The JAX
    package's accuracy gates on the card: denoiser PSNR at 96x96,
    StyleTransfer PSNR (the 64x64 default artifact, each style at 512),
    YOLO mAP. [kernel] cases at every chain and single conv of these
    plans, with the models' weights, at the plans' forms, and at the edges
    of the single-conv kernel's wide body, its packed stem repeated bit for
    bit; planted faults (U-Net's up0
    transposed-conv kernel flipped; the stem's weight mirrored through the
    wide body); [timing] rows of each new launch shape (a wide-body launch
    also in the tile body, the parent's launch)."""
    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.config import BackendKind
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import chain, conv
    from shadernn_tpu_torch.models import zoo
    from shadernn_tpu_torch.ops.common import padding_offsets
    from shadernn_tpu_torch.ops.conv import folded_operands
    from shadernn_tpu_torch.tools.train_denoiser import noisy_pairs
    from shadernn_tpu_torch.tools.train_styletransfer import style_target, synth_imgs
    from shadernn_tpu_torch.tools.train_yolo import NUM_CLASSES, synth_scenes
    from shadernn_tpu_torch.utils.metrics import detections_agree, mean_average_precision, psnr

    dev, rng, log = h.dev, h.rng, h.log
    bf16, f32 = torch.bfloat16, torch.float32
    FP32, BF16, I8 = Precision.FP32, Precision.BF16, Precision.INT8
    t_phase = time.perf_counter()

    def engine(path, prec, batch, hw=None, backend=BackendKind.AUTO, outputs=None, edit=None):
        g = parse_model_file(path, input_hw=hw)
        if outputs:
            g.output_names = list(outputs)
        if edit:
            edit(g)
        return Engine.from_graph(g, EngineOptions(precision=prec, batch_size=batch,
                                                  backend=backend))

    def torch_forward(eng):
        """The plain forward of an engine's (optimized, quantized) graph."""
        return Engine.from_graph(eng.graph, EngineOptions(
            precision=eng.options.precision, batch_size=eng.options.batch_size,
            backend=BackendKind.TORCH), optimize=False)

    def tol_of(prec):
        return h.ENGINE_TOL["fp32" if prec == FP32 else "bf16"]

    # The plans' launches as [kernel] and [timing] cases: (form, label) ->
    # (kind, label, nodes, specs or None, tail, x shape, x dtype, compute
    # dtype); the first engine that plans a shape at a form gives it.
    cases = {}

    def collect(eng, tag):
        g, fwd = eng.graph, eng.model.forward
        dt = eng.options.precision.activation_dtype
        form = ("int8 w" if eng.options.precision == I8 else "bf16" if dt == bf16 else "fp32")
        for head, members in fwd.chain_plan.items():
            nodes = [g.nodes[m] for m in members if g.nodes[m].op == "Conv2D"]
            src = g.nodes[nodes[0].inputs[0]]
            tail = ("d2s2" if any(g.nodes[m].op == "Subpixel" for m in members)
                    else "c1" if int(nodes[-1].attr("out_channels")) == 1 else "none")
            shape = (eng.options.batch_size, src.out_spec.h, src.out_spec.w, src.out_spec.c)
            label = (f"{tag} chain {head} k{'/'.join(str(n.attr('kernel_size')) for n in nodes)} "
                     f"{src.out_spec.c}->{'->'.join(str(n.attr('out_channels')) for n in nodes)} "
                     f"{tail} {shape[1]}x{shape[2]} b{shape[0]}")
            cases.setdefault((form, label), ("chain", label, nodes, fwd.chain_specs[head], tail,
                                             shape, f32 if src.op == "InputLayer" else dt, dt))
        for name_ in fwd.single_conv_plan:
            node = g.nodes[name_]
            s_ = g.nodes[node.inputs[0]].out_spec
            shape = (eng.options.batch_size, s_.h, s_.w, s_.c)
            label = (f"{tag} {name_} k{node.attr('kernel_size')} {s_.c}->"
                     f"{node.attr('out_channels')} {shape[1]}x{shape[2]} b{shape[0]}")
            # The forward casts a model input to the compute dtype first.
            cases.setdefault((form, label), ("single", label, [node], None, None, shape, dt, dt))

    def drive(label, eng, feeds, want, ref=None):
        """One main path: the steps of `feeds` with the counts set to 0 just
        before and read just after, held to the plans (per step `want`, the
        kernels that launch) and to the TORCH forward on the first feed, on
        every output; step p50 and device busy. Returns (outputs, stats)."""
        fwd = eng.model.forward
        h.reset_counts()
        outs = [eng.run(f) for f in feeds]
        counts = h.read_counts()
        per_step = h.held_to_plans(fwd, counts, len(feeds))
        launched = {k: v for k, v in per_step.items() if v}
        ref = ref or torch_forward(eng)
        want_out = ref.run(feeds[0])
        errs, tols, dets = {}, {}, {}
        for key, w_ in want_out.items():
            if eng.graph.nodes[key].op == "YOLO":  # matched box to box, at every precision
                dets[key] = detections_agree(outs[0][key].cpu().numpy(), w_.cpu().numpy(),
                                             tol_of(eng.options.precision))
                if eng.options.precision != FP32:  # rows of near-equal scores may swap
                    continue
            errs[key] = (outs[0][key].float() - w_.float()).abs().max().item()
            tols[key] = tol_of(eng.options.precision) * max(1.0, w_.float().abs().max().item())
        bench = eng.benchmark(feeds[0], loops=20)
        busy_ms, kernels_ms, text = h.busy_text(eng, feeds[0], bench["p50_ms"])
        log(f"[zoo] {label}: launches per step {launched} ({len(feeds)} steps; plan "
            f"{ {k: len(v) for k, v in fwd.chain_plan.items()} } chains, singles "
            f"{fwd.single_conv_plan}) vs TORCH forward "
            + ", ".join(f"{k} max_abs_diff {errs[k]:.3e} tol {tols[k]:.3g}" for k in errs)
            + "".join(f", {k} detections matched box to box {v}" for k, v in dets.items())
            + f"; device step p50 {bench['p50_ms']:.3f} ms; {text}")
        assert launched == want, f"{label}: launches {launched}, want {want}"
        for o in outs:
            assert all(torch.isfinite(v).all().item() for v in o.values()), label
        for k in errs:
            assert errs[k] <= tols[k], f"{label}: {k} disagrees with the TORCH forward"
        return outs, {"launches_per_step": launched, "detections": dets,
                      "launches": {k: v for k, v in counts.items() if v}, "steps": len(feeds),
                      "max_abs_diff": errs, "step_p50_ms": bench["p50_ms"],
                      "device_busy_ms": busy_ms, "kernels_device_ms": kernels_ms}

    paths, gates = {}, {}

    # The denoisers at the runner's 1080x1920 luma, b2.
    frames = {"input": rng.random((2, 1080, 1920, 1), dtype=np.float32)}
    for name_, path in (("spatialdenoise", zoo.SPATIALDENOISE_TRAINED),
                        ("aidenoise", zoo.AIDENOISE_TRAINED)):
        for prec in (BF16, FP32, I8):
            eng = engine(path, prec, 2, (1080, 1920))
            label = f"{name_} 1080x1920 b2 {prec.value}" + (" weight-only" if prec == I8 else "")
            outs, st = drive(label, eng, [frames] * h.STEPS, {"chains": 1})
            assert tuple(outs[0][eng.graph.output_names[0]].shape) == (2, 1080, 1920, 1)
            paths[label] = st
            collect(eng, name_)
            del eng, outs

    # U-Net at 256x256 b8: a planted fault (up0's kernel flipped, as if the
    # transposed conv were computed without its flip) must fail the check.
    unet_x = {"input": rng.random((8, 256, 256, 1), dtype=np.float32)}
    for prec in (BF16, FP32):
        eng = engine(zoo.UNET_TRAINED, prec, 8, (256, 256))
        ref = torch_forward(eng)
        outs, st = drive(f"unet 256x256 b8 {prec.value}", eng, [unet_x] * h.STEPS,
                         {"chains": 3, "fused_conv2d_haloed": 1}, ref)
        collect(eng, "unet")

        def flip_up0(g):
            w_ = g.nodes["up0"].params["weight"]
            g.nodes["up0"].params["weight"] = np.ascontiguousarray(w_[::-1, ::-1])

        want = ref.run(unet_x)["head"]
        tol = tol_of(prec) * max(1.0, want.abs().max().item())
        faulty = engine(zoo.UNET_TRAINED, prec, 8, (256, 256), edit=flip_up0)
        err_fault = (faulty.run(unet_x)["head"] - want).abs().max().item()
        log(f"[zoo] unet 256x256 b8 {prec.value} planted fault (up0's kernel flipped) moves the "
            f"output by {err_fault:.3e} (tol {tol:.3g}) {'caught' if err_fault > tol else 'MISSED'}")
        assert err_fault > tol, "the U-Net check misses a flipped transposed-conv kernel"
        st["planted_fault_up0_flipped_diff"] = err_fault
        paths[f"unet 256x256 b8 {prec.value}"] = st
        del eng, ref, faulty, outs

    # StyleTransfer, each style's 512x512 artifact at b4 on the JAX gate's
    # images (synth_imgs from seed 99): PSNR against the style's target at
    # its floor and >= the identity's + 1 dB; candy's BF16 within 1 dB.
    floor_db = {"candy": 20.0, "mosaic": 16.0, "pointilism": 15.0, "rain-princess": 16.0,
                "udnie": 16.0}
    style_x = synth_imgs(np.random.default_rng(99), 4, s=512)
    for style in zoo.STYLES:
        target = style_target(style_x, style=style)
        for prec in (FP32, BF16) if style == "candy" else (FP32,):
            eng = engine(zoo.STYLE512_TRAINED[style], prec, 4)
            label = f"styletransfer-{style} 512x512 b4 {prec.value}"
            outs, st = drive(label, eng, [{"input": style_x}] * h.STEPS,
                             {"fused_conv2d_haloed": 2})
            y = np.clip(outs[-1]["head"].float().cpu().numpy(), 0, 1)
            st["psnr_db"], st["identity_psnr_db"] = psnr(y, target), psnr(style_x, target)
            paths[label] = st
            collect(eng, "styletransfer")
            del eng, outs
        db32 = paths[f"styletransfer-{style} 512x512 b4 fp32"]["psnr_db"]
        id_db = paths[f"styletransfer-{style} 512x512 b4 fp32"]["identity_psnr_db"]
        log(f"[zoo] gate styletransfer-{style} 512: PSNR {db32:.2f} dB (floor {floor_db[style]}, "
            f"identity {id_db:.2f} + 1)")
        assert db32 >= floor_db[style] and db32 >= id_db + 1.0, (style, db32, id_db)
        gates[f"styletransfer-{style} 512 fp32 psnr_db"] = db32
    db16 = paths["styletransfer-candy 512x512 b4 bf16"]["psnr_db"]
    db32 = gates["styletransfer-candy 512 fp32 psnr_db"]
    log(f"[zoo] gate styletransfer-candy 512 BF16: PSNR {db16:.2f} dB (FP32 {db32:.2f} - 1)")
    assert db16 >= db32 - 1.0, (db32, db16)
    gates["styletransfer-candy 512 bf16 psnr_db"] = db16

    # YOLOv3-tiny at 256x256 b8 on the JAX gate's 32 scenes (seed 424242),
    # four steps; the raw head features and the detections both held.
    scene_rng = np.random.default_rng(424242)
    scenes = [synth_scenes(scene_rng, 8) for _ in range(4)]
    feeds = [{"input": x_} for x_, _ in scenes]
    gts = [g_ for _, gt in scenes for g_ in gt]
    for prec in (FP32, BF16):
        eng = engine(zoo.YOLOV3_TINY_TRAINED, prec, 8, outputs=("head1", "head2", "yolo"))
        label = f"yolov3-tiny 256x256 b8 {prec.value}"
        outs, st = drive(label, eng, feeds, {"fused_conv2d_haloed": 1, "nms_fixed": 1})
        dets = [d[d[:, 1] > 0] for o in outs for d in o["yolo"].float().cpu().numpy()]
        st["map"] = mean_average_precision(dets, gts, NUM_CLASSES)
        log(f"[zoo] gate {label}: mAP {st['map']:.4f} on 32 scenes"
            + (" (gate 0.5)" if prec == FP32 else ""))
        paths[label] = st
        collect(eng, "yolov3-tiny")
        del eng, outs
    assert paths["yolov3-tiny 256x256 b8 fp32"]["map"] >= 0.5, paths["yolov3-tiny 256x256 b8 fp32"]
    gates["yolov3-tiny fp32 map"] = paths["yolov3-tiny 256x256 b8 fp32"]["map"]
    gates["yolov3-tiny bf16 map"] = paths["yolov3-tiny 256x256 b8 bf16"]["map"]

    # The denoisers' gates at 96x96 on noisy_pairs(seed 20260820): FP32 PSNR
    # over the noisy input's + 3 dB and over 26 dB; BF16 within 1 dB of it,
    # INT8 (weight-only) within 1.5 dB.
    x96, y96 = noisy_pairs(np.random.default_rng(20260820), 8, 96)
    p_noisy = psnr(x96, y96)
    for name_, path in (("spatialdenoise", zoo.SPATIALDENOISE_TRAINED),
                        ("unet", zoo.UNET_TRAINED), ("aidenoise", zoo.AIDENOISE_TRAINED)):
        db = {prec.value: psnr(engine(path, prec, 8, (96, 96)).run_single(x96), y96)
              for prec in (FP32, BF16, I8)}
        log(f"[zoo] gate {name_} 96x96: PSNR fp32 {db['fp32']:.2f} dB (noisy {p_noisy:.2f} + 3, "
            f"26), bf16 {db['bf16']:.2f} (fp32 - 1), int8 {db['int8']:.2f} (fp32 - 1.5)")
        assert db["fp32"] > p_noisy + 3.0 and db["fp32"] > 26.0, (name_, db, p_noisy)
        assert db["bf16"] > db["fp32"] - 1.0 and db["int8"] > db["fp32"] - 1.5, (name_, db)
        gates[f"{name_} 96 psnr_db"] = db
    gates["noisy input psnr_db"] = p_noisy

    # The default StyleTransfer artifact at 64x64, b4: PSNR over 8 images
    # (seed 424242) >= the identity's + 1 dB and >= 20 dB; BF16 within 1 dB
    # over the first 4.
    def style64(prec, n):
        eng = engine(zoo.STYLETRANSFER_TRAINED, prec, 4, (64, 64))
        img_rng = np.random.default_rng(424242)
        net, ident = [], []
        for _ in range(n // 4):
            x_ = synth_imgs(img_rng, 4, s=64)
            t_ = style_target(x_)
            net.append(psnr(np.clip(eng.run_single(x_).float().cpu().numpy(), 0, 1), t_))
            ident.append(psnr(x_, t_))
        return float(np.mean(net)), float(np.mean(ident))

    db32, id_db = style64(FP32, 8)
    db32_4, _ = style64(FP32, 4)
    db16_4, _ = style64(BF16, 4)
    log(f"[zoo] gate styletransfer 64x64: PSNR {db32:.2f} dB (identity {id_db:.2f} + 1, 20); "
        f"BF16 {db16_4:.2f} (FP32 {db32_4:.2f} - 1)")
    assert db32 >= id_db + 1.0 and db32 >= 20.0, (db32, id_db)
    assert db16_4 >= db32_4 - 1.0, (db32_4, db16_4)
    gates["styletransfer 64 psnr_db"] = {"fp32": db32, "identity": id_db, "bf16_4": db16_4,
                                         "fp32_4": db32_4}

    # [kernel]: every chain and single conv of the plans above, with the
    # models' weights, at the plans' forms: bf16 and int8 weights from an f32
    # and a bf16 input, fp32 likewise (3xTF32; exact bf16 input, two passes).
    errs = {}
    for (form, label), (kind, _l, nodes, specs, tail, shape, _x_dt, dt) in cases.items():
        for x_dt in (f32, bf16):
            x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, x_dt)
            tag = f"{label} {form} x {'bf16' if x_dt == bf16 else 'f32'}"
            if kind == "chain":
                ops = h.on_dev(chain.chain_operands(nodes, dt, specs))
                entry = "fused_conv_chain_packed" if tail in ("c1", "d2s2") else "fused_conv_chain"
                got = getattr(chain, entry)(x, ops, specs, tail=tail, compute_dtype=dt)
                torch.cuda.synchronize()
                want = chain.conv_chain_reference(x, ops, specs, tail, dt)
            else:
                node = nodes[0]
                wts, sc, of = (t_.to(dev) for t_ in folded_operands(node, dt))
                pads = padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size")))
                act, alpha = str(node.attr("activation", "linear")), float(node.attr("leaky_alpha", 0.3))
                entry = "fused_conv2d_haloed"
                got = conv.fused_conv2d_haloed(x, wts, sc, of, pads, act, alpha, dt)
                torch.cuda.synchronize()
                want = conv.conv2d_haloed_reference(x, wts, sc, of, pads, act, alpha, dt)
            errs[(entry, form)] = max(errs.get((entry, form), 0.0), h.held(tag, entry, got, want, dt))
    log(f"[zoo] {2 * len(cases)} [kernel] cases at the zoo plans' launches")

    # The single-conv kernel's wide body (kernels of 25 taps or more:
    # StyleTransfer's k9 stem and head) at its edges, each from an f32 and a
    # bf16 input, against the plain version: O = 1 and O = 8 / 9 around the
    # n8 block, C = 3 with K packed across taps, int8 weights at the two
    # StyleTransfer launches, tiles that do not divide the image, batch 1,
    # a rectangular kernel (9x3: at fp32 on the tile body, as kw is not 5,
    # 7 or 9), a block of 64 channels over O = 40; the full-size launches
    # walk more tiles than the grid has CTAs. At fp32 the form on the CUDA
    # cores.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wide_err, wide_cases = {}, 0

    def wide_case(label, n, ih, iw, c, kh, kw, o, pads, act, form):
        nonlocal wide_cases
        dt = f32 if form == "fp32" else bf16
        wf = (rng.standard_normal((kh, kw, c, o)) / np.sqrt(kh * kw * c)).astype(np.float32)
        if form == "int8 w":
            scale_w = float(np.abs(wf).max()) / 127
            wts = torch.from_numpy(np.clip(np.round(wf / scale_w), -127, 127).astype(np.int8))
        else:
            scale_w, wts = 1.0, torch.from_numpy(wf)
        wts = wts.to(dev)
        sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(o)).astype(np.float32) * scale_w).to(dev)
        of = torch.from_numpy((0.1 * rng.standard_normal(o)).astype(np.float32)).to(dev)
        geo = conv.launch_geometry(n, ih, iw, c, kh, kw, o, pads, dt == bf16, sms)
        assert geo.body == (1 if dt == bf16 else 2 if kw in conv.FMA_KW else 0), (label, geo)
        for x_dt in (f32, bf16):
            x = torch.from_numpy(rng.random((n, ih, iw, c), dtype=np.float32)).to(dev, x_dt)
            want = conv.conv2d_haloed_reference(x, wts, sc, of, pads, act, 0.3, dt)
            got = conv.fused_conv2d_haloed(x, wts, sc, of, pads, act, 0.3, dt)
            torch.cuda.synchronize()
            wide_err[form] = max(wide_err.get(form, 0.0), h.held(
                f"wide body {label} {form} x {'bf16' if x_dt == bf16 else 'f32'} (body "
                f"{geo.body}, tile {geo.tile_h}x{geo.tile_w}, nb {geo.nb}, grid {geo.grid})",
                "fused_conv2d_haloed", got, want, dt))
            wide_cases += 1

    p4 = (4, 4, 4, 4)
    for form in ("bf16", "fp32", "int8 w"):
        for label, shape in (
                ("styletransfer stem k9 3->32 512x512 b4", (4, 512, 512, 3, 9, 9, 32, p4, "linear")),
                ("styletransfer head k9 32->3 512x512 b4", (4, 512, 512, 32, 9, 9, 3, p4, "linear")),
                ("k9 5->1 37x45 b2", (2, 37, 45, 5, 9, 9, 1, p4, "relu")),
                ("k9 16->8 37x45 b2", (2, 37, 45, 16, 9, 9, 8, p4, "tanh")),
                ("k9 12->9 37x45 b2", (2, 37, 45, 12, 9, 9, 9, p4, "leaky_relu")),
                ("k9 2->3 5x7 b1", (1, 5, 7, 2, 9, 9, 3, p4, "sigmoid")),
                ("k5 3->40 asymmetric pads 23x29 b1", (1, 23, 29, 3, 5, 5, 40, (1, 3, 0, 4),
                                                       "relu6")),
                ("k9x3 8->16 33x35 b2", (2, 33, 35, 8, 9, 3, 16, (4, 4, 1, 1), "gelu"))):
            if form == "int8 w" and not label.startswith("styletransfer"):
                continue
            wide_case(label, *shape, form)
    log(f"[zoo] {wide_cases} [kernel] cases of the single-conv kernel's wide body")

    # Repeat launches of the packed bf16 stem (a ring of two buffers, the
    # region's rows unfolded in shared memory): a race between one tile's
    # unfold and the next tile's rows would show as outputs that differ
    # from launch to launch. Each must equal the first, bit for bit.
    x = torch.from_numpy(rng.random((4, 512, 512, 3), dtype=np.float32)).to(dev, bf16)
    wts = torch.from_numpy((rng.standard_normal((9, 9, 3, 32)) / 15.6).astype(np.float32)
                           ).to(dev, bf16)
    one, zero = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    geo = conv.launch_geometry(4, 512, 512, 3, 9, 9, 32, (4, 4, 4, 4), True, sms)
    assert geo.body == 1 and geo.packed and geo.in_bufs == 2, geo
    first = conv.fused_conv2d_haloed(x, wts, one, zero, (4, 4, 4, 4), "linear", 0.3, bf16)
    repeats = 100
    differ = sum(not torch.equal(first, conv.fused_conv2d_haloed(
        x, wts, one, zero, (4, 4, 4, 4), "linear", 0.3, bf16)) for _ in range(repeats))
    log(f"[zoo] the packed bf16 stem launched {repeats} more times: {differ} outputs differ "
        f"from the first")
    assert differ == 0, "the wide body's packed stem is not deterministic"

    # Planted fault: the stem's weight mirrored along W (dx -> 8 - dx, the
    # order of the packed taps) through the kernel, held against the plain
    # version of the true weight, must fail the check.
    faults = {}
    for dt in (bf16, f32):
        x = torch.from_numpy(rng.random((4, 512, 512, 3), dtype=np.float32)).to(dev, dt)
        wts = torch.from_numpy((rng.standard_normal((9, 9, 3, 32)) / 15.6).astype(np.float32)
                               ).to(dev, dt)
        one, zero = torch.ones(32, device=dev), torch.zeros(32, device=dev)
        want = conv.conv2d_haloed_reference(x, wts, one, zero, p4, "linear", 0.3, dt)
        got = conv.fused_conv2d_haloed(x, wts.flip(1).contiguous(), one, zero, p4, "linear",
                                       0.3, dt)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs().max().item()
        tol = (TOL_BF16 if dt == bf16 else TOL_FP32) * max(1.0, want.float().abs().max().item())
        pname = "bf16" if dt == bf16 else "fp32"
        log(f"[zoo] planted fault: the wide body at the stem ({pname}) with the weight mirrored "
            f"along W moves the output by {diff:.3e} (tol {tol:.3g}) "
            f"{'caught' if diff > tol else 'MISSED'}")
        assert diff > tol, "the wide body's check misses a mirrored weight"
        faults[f"stem {pname} weight mirrored along W"] = diff

    # [timing]: each launch shape at its form: kernel, plain version and the
    # library call (channels_last F.conv2d + epilogue, cuDNN), with the
    # bound from this run's shapes.
    rows = {}
    for (form, label), (kind, _l, nodes, specs, tail, shape, x_dt, dt) in cases.items():
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, x_dt)
        extra = {}
        if kind == "chain":
            ops = h.on_dev(chain.chain_operands(nodes, dt, specs))
            entry = "fused_conv_chain_packed" if tail in ("c1", "d2s2") else "fused_conv_chain"
            prep = chain.prepare(ops, specs, dt)
            t = h.timed({
                "kernel": lambda: getattr(chain, entry)(x, prep, specs, tail=tail,
                                                        compute_dtype=dt),
                "plain": lambda: chain.conv_chain_reference(x, ops, specs, tail, dt),
                "library": h.chain_library(x, ops, specs, tail, dt),
            })
            n_, h_, w_, _ = shape
            flops = 2.0 * n_ * h_ * w_ * sum(sp.k * sp.k * sp.c * sp.o for sp in specs)
            out_el = n_ * h_ * w_ * specs[-1].o  # d2s2: o = 4 values per input pixel
            nbytes = x.numel() * x.element_size() + out_el * (2 if dt == bf16 else 4) + sum(
                p["w"].numel() * p["w"].element_size() + 8 * p["scale"].numel() for p in ops)
        else:
            node = nodes[0]
            wts, sc, of = (t_.to(dev) for t_ in folded_operands(node, dt))
            pads = padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size")))
            act, alpha = str(node.attr("activation", "linear")), float(node.attr("leaky_alpha", 0.3))
            entry = "fused_conv2d_haloed"
            prep = conv.prepare(wts, sc, of, dt)

            def single_conv():
                return conv.run(x, prep, pads, act, alpha)

            t = h.timed({
                "kernel": single_conv,
                "plain": lambda: conv.conv2d_haloed_reference(x, wts, sc, of, pads, act, alpha, dt),
                "library": h.conv_yardstick(x, wts, sc, of, pads, act, dt),
            })
            kh, kw, c_, o_ = wts.shape
            geometry = conv.launch_geometry
            chosen = geometry(*shape, kh, kw, o_, pads, dt == bf16, sms)
            if chosen.body > 0:  # the wide body: the parent's launch (the tile body) beside it
                conv.launch_geometry = conv.tile_geometry
                try:
                    extra["parent_tile_body_ms"], extra["parent_tile_body_device_ms"] = h.timed(
                        {"kernel": single_conv})["kernel"]
                finally:
                    conv.launch_geometry = geometry
                extra["body"] = {1: "wide, tensor cores", 2: "wide, f32 on the CUDA cores"}[
                    chosen.body]
            n_, h_, w_, _ = shape
            ho, wo = h_ + pads[0] + pads[1] - kh + 1, w_ + pads[2] + pads[3] - kw + 1
            flops = 2.0 * n_ * ho * wo * kh * kw * c_ * o_
            nbytes = (x.numel() * x.element_size() + n_ * ho * wo * o_ * (2 if dt == bf16 else 4)
                      + wts.numel() * wts.element_size() + 8 * o_)
        b_ms, b_by = h.bound(flops, nbytes, dt)
        b3, b3_text = h.tf32(flops, nbytes, dt)
        row = dict(**h.timing_keys(t), bound_ms=b_ms, bound_by=b_by, **b3)
        extra_text = ""
        if extra:
            row.update(extra)
            extra_text = "; " + ", ".join(
                f"{k[:-3].replace('_', ' ')} {v:.4f} ms (device {extra[k[:-3] + '_device_ms']:.4f})"
                for k, v in extra.items() if k.endswith("_ms") and not k.endswith("device_ms"))
            extra_text += f"; kernel body: {extra['body']}"
        rows.setdefault(entry, {})[f"{label} {form}"] = row
        log(f"[timing] {entry} {form} {label}: {h.timing_text(t)}{extra_text} bound {b_ms:.5f} ms "
            f"({b_by}; {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB{b3_text}) | {h.card}")
    log(f"[zoo] phase {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "gates": gates, "timing": rows,
            "max_abs_err": {f"{e} {form}": v for (e, form), v in errs.items()},
            "kernel_cases": 2 * len(cases),
            "wide_body": {"max_abs_err": wide_err, "kernel_cases": wide_cases,
                          "planted_fault_diff": faults, "stem_repeats_differing": differ}}



def serve_phase(h) -> dict:
    """7. serve: the serving layer on the card. `h` carries main's helpers
    (log, reset_counts, read_counts, held_to_plans) and phase 4's device
    busy time of the ESPCN BF16 b8 engine.

    ESPCN 2x (trained) at 540p b8 BF16 under StreamingEngine: 4 producer
    threads x 64 frames, raw uint8 luma through ingest and the same frames
    as float32 without it, each at max_inflight 1 and 4. A timed run (the
    consumer drops each result) gives stats(); a checked run (the consumer
    keeps them) holds every served frame against Engine.run of the same
    normalized frame (TOL_BF16) and its chain launches to batches_run; two
    frames' outputs swapped in one batch must fail that check. Beside them:
    the step-only rate (8 / Engine.benchmark p50), one batch's download
    alone (CUDA events), and the overlap from the timeline (batch k+1
    dispatched before batch k drained). YOLOv3-tiny (trained) 256x256 b8
    BF16 under the service: 32 scenes (seed 7), detections box to box
    against Engine.run, mAP >= 0.45, one single-conv launch per batch.
    ExportedEngine: ESPCN BF16 and FP32 b8 exported and reloaded (output,
    plans, one chain launch per step), the BF16 one served for 64 frames
    ("ready in": load to first result). InferenceProcessor (use_pallas) and
    Engine.classify against Engine.run; trace_benchmark within 5% of phase
    4's busy time, device_benchmark, the per-layer report at the card's
    peaks; NV12 -> RGB and a 1080p -> 540p bilinear ingest on the card
    against the host and the CPU; run_model(image_path=) on a PNG where
    Pillow is installed."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.engine.deploy import ExportedEngine, export_engine
    from shadernn_tpu_torch.engine.processor import InferenceProcessor, InitializationParameters
    from shadernn_tpu_torch.engine.streaming import StreamingEngine
    from shadernn_tpu_torch.image import color
    from shadernn_tpu_torch.image.ingest import ingest_frames, nv12_to_rgb_device
    from shadernn_tpu_torch.kernels import chain, conv
    from shadernn_tpu_torch.models import zoo
    from shadernn_tpu_torch.tools.train_yolo import NUM_CLASSES, synth_scenes
    from shadernn_tpu_torch.utils.metrics import detections_agree, mean_average_precision
    from shadernn_tpu_torch.utils.profiler import print_report, profile_layers
    from shadernn_tpu_torch.utils.trace_profile import complete

    log, dev = h.log, h.dev
    rng = np.random.default_rng(20261017)
    BF16, FP32 = Precision.BF16, Precision.FP32
    t_phase = time.perf_counter()
    out = {}
    STOP_S = 300.0

    def served(svc, frames, keep=True, streams=4, producers=None):
        """Serve (stream, frame, data) from one producer thread per stream
        (or `producers` threads, frames dealt round robin); {(stream,
        frame): Result} if keep, else {} (the consumer drops each result),
        and the first result's monotonic time."""
        got, first = {}, []

        def on_result(r):
            if not first:
                first.append(time.monotonic())
            if keep:
                got[(r.stream_id, r.frame_id)] = r

        svc.on_result = on_result
        errors = []

        n_threads = producers or streams

        def produce(t):
            try:
                for j, (sid, fid, data) in enumerate(frames):
                    if (j if producers else sid) % n_threads == t:
                        svc.submit(sid, fid, data)
            except BaseException as e:  # re-raised below
                errors.append(e)

        svc.start()
        try:
            threads = [threading.Thread(target=produce, args=(t,)) for t in range(n_threads)]
            for p in threads:
                p.start()
            for p in threads:
                p.join(STOP_S)
                assert not p.is_alive(), "a producer did not finish"
        finally:
            svc.stop(drain=True, timeout=STOP_S)
        if errors:
            raise errors[0]
        assert svc.stats()["frames_done"] >= len(frames)
        return got, (first[0] if first else None)

    def overlap_share(svc):
        """The share of k for which batch k+1 was dispatched before batch k
        drained, and the host's mean ms per batch staging the frames into
        pinned memory and queuing the copies and the step."""
        tl = svc.timeline
        share = sum(tl[k + 1][2] < tl[k][3] for k in range(len(tl) - 1)) / max(len(tl) - 1, 1)
        return share, (1e3 * float(np.mean([h - s for s, h, _, _ in tl])),
                       1e3 * float(np.mean([d - h for _, h, d, _ in tl])))

    def stats_text(st):
        return (f"throughput {st['throughput_fps']:.1f} fps, latency p50 "
                f"{st['p50_latency_ms']:.3f} ms p99 {st['p99_latency_ms']:.3f} ms, mean fetch "
                f"{st['mean_fetch_ms']:.3f} ms, avg fill {st['avg_fill']:.2f}, padded "
                f"{st['padded_frames']}, batches {st['batches_run']}")

    # -- ESPCN 540p b8 BF16 under the service ------------------------------------
    eng = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(precision=BF16, batch_size=8))
    name_out = eng.graph.output_names[0]
    n_streams, per_stream = 4, 64
    raw = rng.integers(0, 256, (n_streams * per_stream, 540, 960, 1), dtype=np.uint8)
    norm = raw.astype(np.float32) * np.float32(1 / 255.0)  # ingest's arithmetic on the host
    ids = [(i % n_streams, i // n_streams) for i in range(len(raw))]
    index = {k: i for i, k in enumerate(ids)}
    eng.run_single(norm[:8])  # prepared operands, on the default stream
    bench = eng.benchmark({"input": norm[:8]}, loops=20)
    step_fps = 8 / (bench["p50_ms"] / 1e3)
    y = eng.run_single(norm[:8])
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host.copy_(y, non_blocking=True)
    t0.record()
    for _ in range(10):
        host.copy_(y, non_blocking=True)
    t1.record()
    t1.synchronize()
    download_ms = t0.elapsed_time(t1) / 10
    log(f"[serve] espcn 540p b8 bf16: step p50 {bench['p50_ms']:.4f} ms (step-only rate "
        f"{step_fps:.1f} fps); one batch's download alone (8x1080x1920x1 f32, "
        f"{y.numel() * 4 / 1e6:.1f} MB, device to pinned host) {download_ms:.4f} ms "
        f"({y.numel() * 4 / download_ms / 1e6:.1f} GB/s) | {h.card}")
    del y, host

    # The in-situ profile before the services: after them, a profile of this
    # engine recorded 19 of 20 launches of its kernel, three times in a row
    # (PERF.md section 7).
    tb = eng.trace_benchmark({"input": norm[:8]}, steps=20)
    db = eng.device_benchmark({"input": norm[:8]}, iters=50, repeats=3)
    busy4 = h.espcn_busy_ms
    rel = abs(tb["device_ms_per_step"] - busy4) / busy4
    log(f"[serve] trace_benchmark espcn bf16 b8: device {tb['device_ms_per_step']:.4f} ms per "
        f"step ({tb['frames_per_sec']:.1f} fps; every launch recorded: "
        f"{complete(tb['report'])}) against phase 4's busy {busy4:.4f} ms: "
        f"{100 * rel:.2f}% apart; device_benchmark mean {db['mean_ms']:.4f} ms p50 "
        f"{db['p50_ms']:.4f} ({db['frames_per_sec']:.1f} fps) | {h.card}")
    log(tb["report"].table(top=8))
    assert rel <= 0.05, "trace_benchmark disagrees with phase 4's busy time"
    log(print_report(profile_layers(eng, {"input": norm[:8]}, iters=10)))
    out["trace_benchmark"] = {k: v for k, v in tb.items() if k != "report"}
    out["device_benchmark"] = db

    def check(got, want_ids):
        """Max-abs-diff of every served frame against Engine.run of the same
        normalized frame, batch by batch in frame order."""
        err = 0.0
        for b in range(0, len(want_ids), 8):
            keys = want_ids[b:b + 8]
            ref = eng.run_single(norm[[index[k] for k in keys]])
            srv = torch.from_numpy(np.stack([got[k].outputs[name_out] for k in keys])).to(dev)
            err = max(err, (srv - ref).abs().max().item())
        return err

    serve_rows = {}
    for kind, ingest, data in (("uint8 ingest", {"means": (0.0,), "norms": (1 / 255.0,)}, raw),
                               ("float32", None, norm)):
        frames = [(s, f, data[index[(s, f)]]) for s, f in ids]
        # warm: the service's pinned host pool and the ingest step's first launches
        served(StreamingEngine(eng, ingest=ingest, max_inflight=4), frames, keep=False)
        for inflight in (1, 4):
            svc = StreamingEngine(eng, ingest=ingest, max_inflight=inflight)
            served(svc, frames, keep=False)
            st, (share, (stage_ms, queue_ms)) = svc.stats(), overlap_share(svc)
            svc = StreamingEngine(eng, ingest=ingest, max_inflight=inflight)
            h.reset_counts()
            got, _ = served(svc, frames, keep=True)
            counts = h.read_counts()
            chk = svc.stats()
            assert sorted(got) == sorted(ids), "a frame was lost or served twice"
            assert counts["fused_conv_chain_packed"] == chk["batches_run"], (counts, chk)
            assert sum(counts.values()) == chk["batches_run"], counts
            err = check(got, ids)
            label = f"{kind} inflight {inflight}"
            log(f"[serve] espcn 540p b8 bf16 {label}: {stats_text(st)}; host per batch: "
                f"staging {stage_ms:.3f} ms, queuing {queue_ms:.3f} ms; batch k+1 dispatched "
                f"before batch k drained for {share:.2f} of k | checked run: {len(got)} "
                f"frames vs Engine.run max_abs_diff {err:.3e} tol {TOL_BF16}, chain launches "
                f"{counts['fused_conv_chain_packed']} = batches {chk['batches_run']} | {h.card}")
            assert err <= TOL_BF16, f"{label}: a served frame disagrees with Engine.run"
            serve_rows[label] = dict(st, overlap_share=share, host_staging_ms=stage_ms,
                                     host_queuing_ms=queue_ms, max_abs_diff=err,
                                     launches=counts["fused_conv_chain_packed"],
                                     batches=chk["batches_run"])
            if kind == "uint8 ingest" and inflight == 4:
                assert share >= 0.5, f"no overlap at max_inflight=4: {share:.2f}"
                a, b = ids[0], ids[1]  # planted fault: two frames of one batch swapped
                ra, rb = got[a], got[b]
                got[a], got[b] = rb, ra
                fault = check(got, ids)
                log(f"[serve] planted fault (frames {a} and {b} swapped in one batch): "
                    f"max_abs_diff {fault:.3e} tol {TOL_BF16} "
                    f"{'caught' if fault > TOL_BF16 else 'MISSED'}")
                assert fault > TOL_BF16, "the swapped frames were not caught"
            del got
            if inflight == 4:
                # the same frames from one producer thread: the dispatcher
                # then shares the interpreter's lock with one thread, not four
                svc = StreamingEngine(eng, ingest=ingest, max_inflight=4)
                served(svc, frames, keep=False, producers=1)
                st1, (share1, (stage1, queue1)) = svc.stats(), overlap_share(svc)
                log(f"[serve] espcn 540p b8 bf16 {kind} inflight 4, one producer thread: "
                    f"{stats_text(st1)}; host per batch: staging {stage1:.3f} ms, queuing "
                    f"{queue1:.3f} ms; overlap {share1:.2f} | {h.card}")
                serve_rows[f"{kind} inflight 4, one producer"] = dict(
                    st1, overlap_share=share1, host_staging_ms=stage1, host_queuing_ms=queue1)
    out["espcn"] = {"rows": serve_rows, "step_p50_ms": bench["p50_ms"], "step_only_fps": step_fps,
                    "download_ms": download_ms}

    # -- ExportedEngine ------------------------------------------------------------
    exported = {}
    with tempfile.TemporaryDirectory(prefix="snn_export_") as tmp:
        for prec in (BF16, FP32):
            src = eng if prec is BF16 else Engine.from_json(
                zoo.ESPCN_TRAINED, EngineOptions(precision=FP32, batch_size=8))
            tol = TOL_BF16 if prec is BF16 else TOL_FP32
            path = export_engine(src, os.path.join(tmp, prec.value))
            exp = ExportedEngine(path)
            h.reset_counts()
            outs = [exp.run_single(norm[:8]) for _ in range(3)]
            counts = h.read_counts()
            want = src.run_single(norm[:8])
            err = (outs[-1] - want).abs().max().item()
            plans = {k: getattr(exp.model.forward, k) for k in ("chain_plan", "single_conv_plan")}
            assert plans["chain_plan"] == src.model.forward.chain_plan
            h.held_to_plans(exp.model.forward, counts, 3)
            assert sum(counts.values()) == 3 and err <= tol, (counts, err)
            log(f"[serve] exported espcn {prec.value} b8: vs its engine max_abs_diff {err:.3e} "
                f"(tol {tol}), plans equal {plans}, launches {counts} over 3 steps")
            row = {"max_abs_diff": err, "launches": counts, "plans": plans}
            del exp, outs
            if prec is BF16:
                t_load = time.monotonic()
                svc = StreamingEngine(ExportedEngine(path))
                frames = [(i % 4, i // 4, norm[i]) for i in range(64)]
                got, t_first = served(svc, frames)
                ready = t_first - t_load
                err_s = 0.0
                for b in range(0, 64, 8):
                    ref = src.run_single(norm[b:b + 8])
                    srv = np.stack([got[(i % 4, i // 4)].outputs[name_out] for i in range(b, b + 8)])
                    err_s = max(err_s, (torch.from_numpy(srv).to(dev) - ref).abs().max().item())
                row.update(ready_in_s=ready, served=svc.stats(), served_max_abs_diff=err_s)
                log(f"[serve] exported espcn bf16 served 64 frames: ready in {ready:.3f} s "
                    f"(load to first result), {stats_text(svc.stats())}, every frame vs "
                    f"Engine.run max_abs_diff {err_s:.3e} tol {TOL_BF16}")
                assert err_s <= TOL_BF16
            exported[prec.value] = row
    out["exported"] = exported

    # -- processor, classify, benchmarks ----------------------------------------
    proc = InferenceProcessor()
    proc.initialize(InitializationParameters(model_path=zoo.ESPCN_TRAINED, precision=BF16,
                                             batch_size=8, use_pallas=True, max_loops=10))
    proc.pre_process({"input": norm[:8]})
    res = proc.process()
    keng = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(
        precision=BF16, batch_size=8, backend=proc.engine.options.backend))
    perr = (res["outputs"][name_out] - keng.run_single(norm[:8])).abs().max().item()
    log(f"[serve] InferenceProcessor espcn bf16 b8 use_pallas: mean {res['mean_ms']:.4f} ms "
        f"(stdev {res['stdev_ms']:.4f}, {res['loops']} loops after 5), vs Engine.run "
        f"max_abs_diff {perr:.3e}")
    assert perr <= TOL_BF16, perr
    out["processor"] = {"mean_ms": res["mean_ms"], "max_abs_diff": perr}

    cls = Engine.from_json(zoo.MOBILENETV2_TRAINED, EngineOptions(precision=BF16, batch_size=64))
    xc = rng.random((64, 32, 32, 3), dtype=np.float32)
    agree = (cls.classify(xc) == torch.argmax(cls.run_single(xc), -1).cpu().numpy()).mean()
    log(f"[serve] Engine.classify trained MobileNetV2 b64 bf16: equal to argmax of run for "
        f"{agree:.4f} of the images")
    assert agree == 1.0
    out["classify_agree"] = float(agree)

    # -- YOLOv3-tiny under the service --------------------------------------------
    yolo = Engine.from_json(zoo.YOLOV3_TINY_TRAINED, EngineOptions(precision=BF16, batch_size=8))
    xs, gts = synth_scenes(np.random.default_rng(7), 32)
    yolo.run_single(xs[:8])
    h.reset_counts()
    svc = StreamingEngine(yolo)
    got, _ = served(svc, [(0, i, xs[i]) for i in range(len(xs))], streams=1)
    counts = h.read_counts()
    st = svc.stats()
    h.held_to_plans(yolo.model.forward, counts, st["batches_run"])
    assert counts["fused_conv2d_haloed"] == st["batches_run"] > 0, counts
    yname = yolo.graph.output_names[0]
    dets = np.stack([got[(0, i)].outputs[yname] for i in range(len(xs))])
    ref = np.concatenate([yolo.run_single(xs[b:b + 8]).float().cpu().numpy()
                          for b in range(0, len(xs), 8)])
    worst = detections_agree(dets, ref, ENGINE_TOL["bf16"], nms_iou=0.45)
    m = mean_average_precision([d[d[:, 1] > 0] for d in dets], gts, NUM_CLASSES)
    log(f"[serve] yolov3-tiny 256 b8 bf16 served 32 scenes: {stats_text(st)}; vs Engine.run "
        f"{worst}; mAP {m:.4f} (gate 0.45); single-conv launches {counts['fused_conv2d_haloed']}"
        f" = batches {st['batches_run']} | {h.card}")
    assert m >= 0.45, m
    out["yolo"] = {"stats": st, "map": m, "detections": worst,
                   "launches": counts["fused_conv2d_haloed"]}

    # -- device ingest --------------------------------------------------------------
    hh, ww = 1080, 1920
    yp = rng.integers(0, 256, (2, hh, ww), dtype=np.uint8)
    uv = rng.integers(0, 256, (2, hh // 2, ww // 2, 2), dtype=np.uint8)
    rgb = nv12_to_rgb_device(torch.from_numpy(yp).to(dev), torch.from_numpy(uv).to(dev))
    host_rgb = np.stack([color.nv12_to_rgb(np.concatenate([yp[i].reshape(-1), uv[i].reshape(-1)]),
                                           hh, ww) for i in range(2)])
    nv_err = float(np.abs(rgb.cpu().numpy() - host_rgb.astype(np.float32)).max())
    frames = rng.integers(0, 256, (2, hh, ww, 3), dtype=np.uint8)
    on_card = ingest_frames(torch.from_numpy(frames).to(dev), target_hw=(540, 960),
                            dtype_name="float32").cpu()
    on_cpu = ingest_frames(torch.from_numpy(frames), target_hw=(540, 960), dtype_name="float32")
    rs_err = (on_card - on_cpu).abs().max().item()
    log(f"[serve] device ingest: NV12 2x1080x1920 -> RGB vs host nv12_to_rgb max diff {nv_err:.4f} "
        f"levels (host truncates to uint8; limit 1); 2x1080x1920x3 uint8 -> 540x960 bilinear vs "
        f"the CPU max diff {rs_err:.3e} (limit 1e-4)")
    assert nv_err <= 1.0 + 1e-3 and rs_err <= 1e-4, (nv_err, rs_err)
    out["ingest"] = {"nv12_max_diff_levels": nv_err, "resize_max_diff": rs_err}

    # -- run_model(image_path=) ----------------------------------------------------
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    luma = rng.integers(0, 256, (540, 960, 1), dtype=np.uint8)
    if has_pil:
        from shadernn_tpu_torch.image.image import Image
        from shadernn_tpu_torch.models.runners import run_model

        with tempfile.TemporaryDirectory(prefix="snn_png_") as tmp:
            png = os.path.join(tmp, "frame.png")
            Image(luma, color.ColorFormat.R8).save(png)
            res = run_model("espcn", image_path=png, precision=BF16, inner_loops=3)
        log(f"[serve] run_model('espcn', image_path=<540x960 PNG>): output "
            f"{res['output_shape']}, p50 {res['stats']['p50_ms']:.4f} ms")
        assert res["output_shape"] == (1, 1080, 1920, 1)
        out["run_model_png"] = True
    else:
        log("[serve] Pillow is not installed on this machine: run_model(image_path=) and the "
            "PNG decode are not run here (the CPU tests cover them); the same 540x960 frame "
            "goes to ingest as a uint8 array instead")
        x1 = ingest_frames(torch.from_numpy(luma[None]).to(dev), dtype_name="float32")
        e1 = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(precision=BF16, batch_size=1))
        y1 = e1.run_single(x1)
        ref1 = e1.run_single(luma[None].astype(np.float32) * np.float32(1 / 255.0))
        assert tuple(y1.shape) == (1, 1080, 1920, 1) and (y1 - ref1).abs().max().item() == 0.0
        out["run_model_png"] = False
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def io_phase(h) -> dict:
    """8. io: model I/O and the demo CLI on the card. `h` carries main's
    helpers (log, reset_counts, read_counts, held_to_plans).

    ONNX round trip at full width: each trained model saved as ONNX by
    export_onnx, read back by parse_onnx and convert_onnx_graph, and run by
    Engine.from_graph beside the native engine (Engine.from_json of the
    artifact): ESPCN 2x 540p b8 at BF16 and FP32, MobileNetV2 cls10 b64 BF16,
    ResNet18 cls10 b64 BF16 with every node forced to KERNEL. The launches
    per step (counts set to 0 just before, read just after) equal the native
    engine's and its plans'; the output equals the native one bit for bit
    where the folded weights are the same, else within ENGINE_TOL times
    max(1, max|native|); the step p50 of both (Engine.benchmark: CUDA
    events, 20 steps after 5) and the imported step's device ms per kernel
    launch (torch.profiler). Serialization round trip: save_model inline and
    decoupled, Engine.from_json, held the same way, for the same four and
    StyleTransfer-candy 512 b4 FP32. Layer dumps: a dump-mode forward of the
    trained ESPCN 540p b8 (tools/dump_reader.py layer_outputs) at BF16 and
    FP32 launches the single-conv kernel 3 times a step and no chain; every
    layer within ENGINE_TOL of the TORCH backend's dump; a perturbed layer
    must fail; the dump-mode step's p50 beside the chained step's. Then
    run_model(dump_dir=) at b1 writes the files, read_dump reads them back
    equal to the in-memory dumps and compare.main reports them equal. The
    demo CLI: `list` as a subprocess; run, profile, stream and serve (an
    export on the first start, then a warm start on the same directory)
    in-process through main(), on cuda, their printed lines parsed."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.config import BackendKind
    from shadernn_tpu_torch.demo import main as demo_main
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.graph.serialize import save_model
    from shadernn_tpu_torch.models import zoo
    from shadernn_tpu_torch.models.runners import make_engine, run_model
    from shadernn_tpu_torch.tools import compare, dump_reader
    from shadernn_tpu_torch.tools.convert import convert_onnx_graph
    from shadernn_tpu_torch.tools.onnx_export import export_onnx
    from shadernn_tpu_torch.tools.onnx_reader import parse_onnx
    from shadernn_tpu_torch.utils.trace_profile import profile_steps

    log, dev, card = h.log, h.dev, h.card
    BF16, FP32 = Precision.BF16, Precision.FP32
    AUTO, KERNEL = BackendKind.AUTO, BackendKind.KERNEL
    rng = np.random.default_rng(20261018)
    t_phase = time.perf_counter()
    out = {"onnx": {}, "serialize": {}, "dumps": {}, "cli": {}}
    steps = 3

    frames = rng.random((8, 540, 960, 1), dtype=np.float32)
    images = rng.random((64, 32, 32, 3), dtype=np.float32)
    styles = rng.random((4, 512, 512, 3), dtype=np.float32)
    # label: (artifact, precision, backend, batch, input, launches per step)
    configs = {
        "espcn 540p b8 bf16": (zoo.ESPCN_TRAINED, BF16, AUTO, 8, frames,
                               {"fused_conv_chain_packed": 1}),
        "espcn 540p b8 fp32": (zoo.ESPCN_TRAINED, FP32, AUTO, 8, frames,
                               {"fused_conv_chain": 1}),
        "mobilenetv2 cls10 b64 bf16": (zoo.MOBILENETV2_TRAINED, BF16, AUTO, 64, images,
                                       {"fused_invres_block": 13, "fused_conv2d_haloed": 1}),
        "resnet18 cls10 b64 bf16 KERNEL": (zoo.RESNET18_TRAINED, BF16, KERNEL, 64, images,
                                           {"fused_conv_chain": 2, "fused_conv2d_haloed": 10,
                                            "fused_matmul": 1}),
        "styletransfer-candy 512 b4 fp32": (zoo.STYLE512_TRAINED["candy"], FP32, AUTO, 4, styles,
                                            {"fused_conv2d_haloed": 2}),
    }

    def options(label):
        _, prec, backend, batch, _, _ = configs[label]
        return EngineOptions(precision=prec, backend=backend, batch_size=batch)

    def counted(eng, x):
        """Per-step launches of `steps` steps (every count set to 0 just
        before them and read just after, held to the engine's plans), the
        first and the last step's output."""
        name = eng.graph.input_names[0]
        feed = {name: torch.from_numpy(x).to(dev)}
        eng.model(feed)  # the operands, prepared once
        torch.cuda.synchronize()
        h.reset_counts()
        ys = [eng.model(feed)[eng.graph.output_names[0]] for _ in range(steps)]
        torch.cuda.synchronize()
        counts = h.read_counts()
        h.held_to_plans(eng.model.forward, counts, steps)
        return {k: v // steps for k, v in counts.items() if v}, ys[0], ys[-1]

    def same_weights(a, b):
        pa = [t for d in a.model.params.values() for t in d.values()]
        pb = [t for d in b.model.params.values() for t in d.values()]
        return len(pa) == len(pb) and all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(pa, pb))

    natives = {}

    def native(label):
        if label not in natives:
            eng = Engine.from_json(configs[label][0], options(label))
            launches, y0, y = counted(eng, configs[label][4])
            natives[label] = (eng, launches, y, (y - y0).abs().max().item())
        return natives[label]

    def held(kind, label, other):
        """`other` (imported or reloaded) against the native engine: the
        launches per step, the output, bit for bit where the weights are the
        same (and the native engine repeats itself), else within the limit."""
        eng, want_launches, want, self_diff = native(label)
        launches, _, got = counted(other, configs[label][4])
        assert launches == want_launches == configs[label][5], (
            kind, label, launches, want_launches)
        err = (got.float() - want.float()).abs().max().item()
        bit = same_weights(eng, other) and self_diff == 0.0
        prec = configs[label][1].value
        tol = 0.0 if bit else ENGINE_TOL[prec] * max(1.0, want.float().abs().max().item())
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        log(f"[io] {kind} {label}: launches per step {launches} = native's; vs native "
            f"max_abs_diff {err:.3e} ({'bit-equal expected' if bit else f'tol {tol:.3e}'}; the "
            f"native engine's own steps differ by {self_diff:.3e}) {'ok' if ok else 'FAIL'}")
        assert ok, f"{kind} {label}: the output disagrees with the native engine's"
        return {"launches_per_step": launches, "max_abs_diff": err, "bit_equal_expected": bit,
                "native_step_to_step_diff": self_diff}

    # -- ONNX round trip at full width ----------------------------------------
    for label in list(configs)[:4]:
        g = parse_model_file(configs[label][0])
        g.infer_shapes()
        data = export_onnx(g)
        imported = convert_onnx_graph(parse_onnx(data))
        n_nodes = (len(g.nodes), len(imported.nodes))
        eng = Engine.from_graph(imported, options(label))
        row = held("onnx", label, eng)
        x = configs[label][4]
        p50 = {"native": [], "imported": []}
        for _ in range(2):  # alternated: the host's share of a step varies between calls
            for k, e in (("native", native(label)[0]), ("imported", eng)):
                p50[k].append(e.benchmark({e.graph.input_names[0]: x}, loops=25)["p50_ms"])
        feed = {eng.graph.input_names[0]: torch.from_numpy(x).to(dev)}
        rep = profile_steps(lambda: eng.model(feed), 5, dev)
        ms = {o.name: o.us / o.count / 1e3 for o in rep.ops if o.category == "hand-written"}
        log(f"[io] onnx {label}: {len(data) / 1e6:.2f} MB of ONNX, {n_nodes[0]} -> {n_nodes[1]} "
            f"nodes; step p50 (two calls each, alternated) native "
            f"{' / '.join(f'{v:.4f}' for v in p50['native'])} ms, imported "
            f"{' / '.join(f'{v:.4f}' for v in p50['imported'])} ms; "
            f"imported device ms per launch {ms} | {card}")
        out["onnx"][label] = dict(row, step_p50_ms=p50, device_ms_per_launch=ms,
                                  onnx_bytes=len(data), nodes=n_nodes)
        del eng

    # -- serialization round trip ----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="snn_io_") as tmp:
        for label in configs:
            for decouple in (False, True):
                path = os.path.join(tmp, f"m{len(out['serialize'])}.json")
                save_model(parse_model_file(configs[label][0]), path, decouple=decouple)
                saved = path[:-5] + "_layers.json" if decouple else path
                eng = Engine.from_json(saved, options(label))
                kind = "decoupled" if decouple else "inline"
                out["serialize"][f"{label} {kind}"] = held(f"save_model {kind}", label, eng)
                del eng
    for label in list(natives):
        del natives[label]
    torch.cuda.empty_cache()

    # -- layer dumps -------------------------------------------------------------
    for prec in (BF16, FP32):
        eng = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(precision=prec, batch_size=8))
        feed = {"input": frames}
        dump_reader.layer_outputs(eng, feed)  # operands prepared, kernels loaded
        torch.cuda.synchronize()
        h.reset_counts()
        for _ in range(steps):
            dumps = dump_reader.layer_outputs(eng, feed)
        torch.cuda.synchronize()
        counts = {k: v for k, v in h.read_counts().items() if v}
        assert counts == {"fused_conv2d_haloed": 3 * steps}, counts
        teng = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(
            precision=prec, batch_size=8, backend=BackendKind.TORCH))
        ref = dump_reader.layer_outputs(teng, feed)
        assert sorted(dumps) == sorted(ref) == ["conv_1", "conv_2", "conv_3", "subpixel"]

        def worst(d):
            """(layer, max_abs_diff, tol) of the layer furthest over its
            limit against the TORCH dump."""
            rows = []
            for k in ref:
                tol = ENGINE_TOL[prec.value] * max(1.0, ref[k].abs().max().item())
                rows.append((k, (d[k] - ref[k]).abs().max().item(), tol))
            return max(rows, key=lambda r: r[1] / r[2])

        layer, err, tol = worst(dumps)
        planted = dict(dumps)
        planted["conv_2"] = dumps["conv_2"].clone()
        planted["conv_2"][3, 200, 400, 7] += 4 * tol
        f_layer, f_err, f_tol = worst(planted)
        dump_eng = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(
            precision=prec, batch_size=8, dump_outputs=True))
        p50_dump = dump_eng.benchmark(feed, loops=25)["p50_ms"]
        p50_chain = eng.benchmark(feed, loops=25)["p50_ms"]
        dfeed = {"input": torch.from_numpy(frames).to(dev)}
        rep = profile_steps(lambda: dump_eng.model(dfeed), 3, dev)
        ms = {o.name: o.us / o.count / 1e3 for o in rep.ops if o.category == "hand-written"}
        log(f"[io] dumps espcn 540p b8 {prec.value}: single-conv launches {counts} over {steps} "
            f"dump forwards, no chain; every layer vs the TORCH dump: worst {layer} "
            f"max_abs_diff {err:.3e} tol {tol:.3e} {'ok' if err <= tol else 'FAIL'}; planted "
            f"fault (conv_2 perturbed by {4 * tol:.3e}): {f_layer} {f_err:.3e} "
            f"{'caught' if f_err > f_tol else 'MISSED'}; dump-mode step p50 {p50_dump:.4f} ms "
            f"(device ms per launch {ms}) against the chained step {p50_chain:.4f} ms | {card}")
        assert err <= tol, f"dump {prec.value}: {layer} disagrees with the TORCH dump"
        assert f_err > f_tol, "the perturbed dump was not caught"
        out["dumps"][prec.value] = {"launches_per_step": {"fused_conv2d_haloed": 3},
                                    "max_abs_diff": err, "worst_layer": layer,
                                    "planted_fault_diff": f_err, "dump_step_p50_ms": p50_dump,
                                    "chained_step_p50_ms": p50_chain,
                                    "device_ms_per_launch": ms}
        del dumps, ref, planted, eng, teng, dump_eng, dfeed
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="snn_dumps_") as tmp:
        res = run_model("espcn", dump_dir=tmp, batch_size=1)
        x1 = np.random.default_rng(7767517).random((1, 540, 960, 1), dtype=np.float32)
        mem = dump_reader.to_host(dump_reader.layer_outputs(make_engine("espcn"), {"input": x1}))
        assert sorted(res["dumps"]) == sorted(mem), (sorted(res["dumps"]), sorted(mem))
        rcs = {}
        for layer, path in res["dumps"].items():
            back = dump_reader.read_dump(path)
            assert back.dtype == np.float32 and np.array_equal(back, mem[layer]), layer
            np.save(os.path.join(tmp, f"mem_{layer}.npy"), mem[layer])
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rcs[layer] = compare.main([path, os.path.join(tmp, f"mem_{layer}.npy"),
                                           "--threshold", "0"])
            assert rcs[layer] == 0 and "PASS" in text.getvalue(), (layer, text.getvalue())
        log(f"[io] run_model('espcn', dump_dir=, batch_size=1): {len(res['dumps'])} files, "
            f"read_dump equal to the in-memory dumps, compare.main rc {rcs}")
        out["dumps"]["run_model_files"] = len(res["dumps"])

    # -- the demo CLI ---------------------------------------------------------------
    listed = subprocess.run([sys.executable, "-m", "shadernn_tpu_torch.demo", "list"], cwd=REPO,
                            capture_output=True, text=True, timeout=300, check=True).stdout
    assert "espcn" in listed and "540x960x1" in listed, listed
    device_line = f"device: cuda ({torch.cuda.get_device_name(0)})"

    def cli(argv):
        """One command through main(): its stdout, its launches (counts set
        to 0 just before, read just after) and its seconds."""
        buf = io.StringIO()
        h.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            demo_main(argv)
        torch.cuda.synchronize()
        text = buf.getvalue()
        assert device_line in text, (argv, text)
        return text, {k: v for k, v in h.read_counts().items() if v}, time.perf_counter() - t0

    def stats_of(text):
        return json.loads(text[text.index("{"):])

    text, counts, secs = cli(["run", "espcn", "--precision", "bf16", "--inner-loops", "5"])
    m = re.search(r"latency mean ([\d.]+) ms  p50 ([\d.]+) ms  throughput ([\d.]+) frames/s", text)
    assert m and counts.get("fused_conv_chain_packed", 0) >= 5, (text, counts)
    out["cli"]["run"] = {"p50_ms": float(m.group(2)), "launches": counts, "seconds": secs}
    log(f"[io] demo run espcn --precision bf16 --inner-loops 5: {m.group(0)}; launches {counts}; "
        f"{secs:.2f} s | {card}")
    text, counts, secs = cli(["profile", "espcn"])
    assert "Total GPU runtime" in text, text
    total = re.search(r"Total GPU runtime: ([\d.]+) ms", text).group(1)
    out["cli"]["profile"] = {"total_ms": float(total), "launches": counts, "seconds": secs}
    log(f"[io] demo profile espcn: per-layer table, total {total} ms; launches {counts}; "
        f"{secs:.2f} s")
    text, counts, secs = cli(["stream", "espcn", "--frames", "64", "--batch", "8"])
    st = stats_of(text)
    assert st["frames_done"] == 64 and counts == {"fused_conv_chain_packed": st["batches_run"]}, (
        st, counts)
    out["cli"]["stream"] = dict(st, launches=counts, seconds=secs)
    log(f"[io] demo stream espcn --frames 64 --batch 8: {st['frames_done']} frames, "
        f"{st['throughput_fps']:.1f} fps, p50 {st['p50_latency_ms']:.3f} ms; launches {counts}")
    with tempfile.TemporaryDirectory(prefix="snn_serve_") as tmp:
        for start in ("cold", "warm"):
            text, counts, secs = cli(["serve", "espcn", "--frames", "64", "--batch", "8",
                                      "--export-dir", os.path.join(tmp, "espcn")])
            ready = re.search(r"serving ready in ([\d.]+)s \(exported; model espcn, batch 8\)", text)
            st = stats_of(text)
            assert ready and ("exported engine to" in text) == (start == "cold"), (start, text)
            assert st["frames_done"] == 64, (start, st)
            assert counts.get("fused_conv_chain_packed", 0) == st["batches_run"] + 1, counts
            out["cli"][f"serve {start}"] = dict(st, ready_in_s=float(ready.group(1)),
                                                launches=counts, seconds=secs)
            log(f"[io] demo serve espcn --frames 64 --batch 8 ({start} start): "
                f"{ready.group(0)}; {st['frames_done']} frames done, "
                f"{st['throughput_fps']:.1f} fps; launches {counts} | {card}")
    log(f"[io] phase {time.perf_counter() - t_phase:.1f} s")
    return out

# Step 0's gradients, card against CPU: each tensor's max-abs-diff within
# this share of the model's largest gradient magnitude. fp32 sums in another
# order give up to 3e-5 (StyleTransfer 64 b32, whose InstanceNorm betas take
# their gradient as a small difference of large terms: 6e-3 of their own
# magnitude, the JAX package against the port on the CPU alike); TF32 in
# the backward gives about 1e-3 of a tensor's own magnitude.
GRAD_TOL = 1e-4


def train_phase(h) -> dict:
    """9. train: the six trainers (tools/train_*.py) on the card at the JAX
    defaults' width, batch and size. `h` carries main's helpers (log,
    reset_counts, read_counts, held_to_plans).

    For each: step 0's loss and every gradient on the card (TF32 off for
    the whole step, tools/optim.py no_tf32) against the same step of the
    port on the CPU from the same parameters and batch, each tensor within
    GRAD_TOL of the model's largest gradient magnitude (see GRAD_TOL; TF32
    in the backward is printed beside it); a planted fault (the largest
    gradient scaled by 1 + 10 GRAD_TOL) must fail that check. Then 5 optimizer steps on fresh batches with finite losses, the
    host's batch-making ms apart from the step ms (CUDA-synchronized), and
    no hand-written kernel launched (the trainers run on TORCH: cuDNN,
    cuBLAS). Then ResNet18's whole default run (600 steps, base 16, b128):
    held-out top-1 >= 0.95, exported into build/trained/ (git-ignored) and
    reloaded through Engine.from_json at BF16 AUTO, b64: launches per step
    held to its plans (counts set to 0 just before, read just after),
    output within ENGINE_TOL of the TORCH BF16 forward, top-1 >= 0.95."""
    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.config import BackendKind
    from shadernn_tpu_torch.tools import (
        train_denoiser, train_espcn, train_mobilenetv2, train_resnet18, train_styletransfer,
        train_yolo,
    )

    log, card, dev = h.log, h.card, str(h.dev)
    t_phase = time.perf_counter()
    out = {"trainers": {}}

    def sync():
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
    trainers = {
        "resnet18 base16 b128": lambda d: train_resnet18.setup(600, 16, 128, device=d),
        "mobilenetv2 w0.5 32x32 b128": lambda d: train_mobilenetv2.setup(700, 0.5, 128, device=d),
        "spatialdenoise 64 b16": lambda d: train_denoiser.setup(500, "spatialdenoise", 16, 64, d),
        "unet 64 b16": lambda d: train_denoiser.setup(500, "unet", 16, 64, d),
        "aidenoise 64 b16": lambda d: train_denoiser.setup(500, "aidenoise", 16, 64, d),
        "styletransfer 64 b32": lambda d: train_styletransfer.setup(400, 32, 64, device=d),
        "yolov3-tiny 256 b16": lambda d: train_yolo.setup(500, 16, 256, device=d),
        "espcn patch64 b32": lambda d: train_espcn.setup(3000, 32, 64, device=d),
    }

    def grad_error(got, want):
        """(worst tensor, its max-abs-diff over the model's largest gradient
        magnitude, the same over its own)."""
        gmax = max(float(g.abs().max()) for d in want.values() for g in d.values())
        diff = {f"{n}.{k}": (float((got[n][k].detach().cpu() - g).abs().max()),
                             float(g.abs().max()))
                for n, d in want.items() for k, g in d.items()}
        worst = max(diff, key=lambda t: diff[t][0])
        err, own = diff[worst]
        return worst, err / gmax, err / max(own, 1e-30)

    def tf32_backward_grads(s, batch):
        """Step 0's gradients with TF32 allowed in the backward (the forward's
        convs keep theirs off): what the trainer's no_tf32 keeps out."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                loss = s.loss(s.params, *batch)
                gs = torch.autograd.grad(loss, [t for _, _, t in s.state.trained])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        got = {}
        for (n, k, _), g in zip(s.state.trained, gs):
            got.setdefault(n, {})[k] = g
        return got

    for label, make in trainers.items():
        s, c = make(dev), make("cpu")
        with torch.no_grad():
            for n, d in s.params.items():
                for k, t in d.items():
                    c.params[n][k].copy_(t.cpu())
        rng = np.random.default_rng(7)
        t0 = time.perf_counter()
        batch = s.batch(rng)
        data_ms = (time.perf_counter() - t0) * 1e3
        h.reset_counts()
        dev_batch = s.to_device(batch)
        loss_g, g_g = s.state.grads(s.loss, *dev_batch)
        sync()
        t0 = time.perf_counter()
        loss_c, g_c = c.state.grads(c.loss, *c.to_device(batch))
        cpu_s = time.perf_counter() - t0
        loss_err = abs(float(loss_g) - float(loss_c)) / max(abs(float(loss_c)), 1e-12)
        worst, err, err_own = grad_error(g_g, g_c)
        # the planted fault: the largest gradient scaled by 1 + 10 GRAD_TOL
        n0, k0 = max(((n, k) for n, d in g_c.items() for k in d),
                     key=lambda nk: float(g_c[nk[0]][nk[1]].abs().max()))
        planted = {n: dict(d) for n, d in g_g.items()}
        planted[n0][k0] = g_g[n0][k0] * (1 + 10 * GRAD_TOL)
        _, planted_err, _ = grad_error(planted, g_c)
        tf32_worst, tf32_err, tf32_own = grad_error(tf32_backward_grads(s, dev_batch), g_c)
        ok = err <= GRAD_TOL and loss_err <= 1e-5 and planted_err > GRAD_TOL
        log(f"[train] {label}: step 0 loss card {float(loss_g):.6f} cpu {float(loss_c):.6f} "
            f"(rel {loss_err:.2e}); gradients of {len(s.state.trained)} tensors, worst {worst} "
            f"{err:.3e} of the largest gradient ({err_own:.3e} of its own; tol {GRAD_TOL:.0e}) "
            f"{'ok' if err <= GRAD_TOL else 'FAIL'}; planted fault ({n0}.{k0} scaled by "
            f"1 + {10 * GRAD_TOL:.0e}) {planted_err:.3e} "
            f"{'caught' if planted_err > GRAD_TOL else 'MISSED'}; with TF32 in the backward "
            f"{tf32_err:.3e} ({tf32_worst}, {tf32_own:.3e} of its own); the CPU step "
            f"{cpu_s:.2f} s")
        assert ok, f"{label}: step 0 on the card disagrees with the CPU, or the fault was missed"
        del c, g_c, g_g, planted
        losses, data, step = [], [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            b = s.to_device(s.batch(rng))
            t1 = time.perf_counter()
            losses.append(float(s.state.step(s.loss, *b)))
            sync()
            data.append((t1 - t0) * 1e3)
            step.append((time.perf_counter() - t1) * 1e3)
        counts = {k: v for k, v in h.read_counts().items() if v}
        step_ms = statistics.median(step[1:])
        log(f"[train] {label}: {STEPS} steps, losses {' '.join(f'{v:.5f}' for v in losses)}; "
            f"step {step_ms:.2f} ms (median of steps 2-{STEPS}, synchronized; the first "
            f"{step[0]:.1f}), host batch-making {statistics.median(data):.2f} ms a batch; "
            f"hand-written kernel launches {counts or 'none'} | {card}")
        assert all(np.isfinite(losses)), losses
        assert not counts, f"{label}: the trainer launched hand-written kernels: {counts}"
        out["trainers"][label] = {
            "step0_loss": float(loss_g), "step0_loss_rel_err": loss_err,
            "step0_grad_worst": worst, "step0_grad_rel_err": err, "step0_grad_own_err": err_own,
            "planted_fault_rel_err": planted_err, "tf32_backward_rel_err": tf32_err,
            "tf32_backward_own_err": tf32_own,
            "losses": losses, "step_ms": step_ms, "first_step_ms": step[0],
            "batch_ms": statistics.median(data), "first_batch_ms": data_ms,
            "cpu_step0_s": cpu_s}
        del s

    # ResNet18's whole default run, its export and the reload on the kernels.
    stats = {}
    t0 = time.perf_counter()
    graph, m, params = train_resnet18.train(
        device=dev, log=lambda msg: log(f"[train] resnet18 {msg}"), stats=stats)
    acc = train_resnet18.evaluate(graph, m, params)
    n_steps = stats["steps"]
    log(f"[train] resnet18 base16 b128: {n_steps} steps in {stats['wall_s']:.1f} s (host "
        f"batch-making {stats['data_s']:.1f} s, the rest "
        f"{1e3 * (stats['wall_s'] - stats['data_s']) / n_steps:.2f} ms a step); held-out top-1 "
        f"{acc:.4f} (gate 0.95) | {card}")
    assert acc >= 0.95, f"ResNet18 trained on the card: top-1 {acc} < 0.95"
    path = train_resnet18.export(graph, params, train_resnet18.OUT_DIR,
                                 log=lambda msg: log(f"[train] resnet18 {msg}"))
    layers = path[:-len(".json")] + "_layers.json"
    del m, params
    eng = Engine.from_json(layers, EngineOptions(precision=Precision.BF16, batch_size=64,
                                                 device=dev))
    ref = Engine.from_json(layers, EngineOptions(precision=Precision.BF16, batch_size=64,
                                                 backend=BackendKind.TORCH, device=dev))
    x, y = train_resnet18.synth_cls(np.random.default_rng(424242), 256)
    eng.run_single(x[:64])
    h.reset_counts()
    probs = [eng.run_single(x[i:i + 64]) for i in range(0, 256, 64)]
    counts = h.read_counts()
    per_step = h.held_to_plans(eng.model.forward, counts, 4)
    want = [ref.run_single(x[i:i + 64]) for i in range(0, 256, 64)]
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(probs, want))
    tol = ENGINE_TOL["bf16"] * max(1.0, max(b.float().abs().max().item() for b in want))
    top1 = float(np.mean(torch.cat(probs).argmax(-1).cpu().numpy() == y))
    log(f"[train] resnet18 exported to {os.path.relpath(layers, REPO)}, reloaded at BF16 AUTO "
        f"b64: launches per step {per_step} (held to its plans); vs the TORCH BF16 forward "
        f"max_abs_diff {err:.3e} tol {tol:.1e} {'ok' if err <= tol else 'FAIL'}; top-1 "
        f"{top1:.4f}")
    assert err <= tol and top1 >= 0.95, (err, tol, top1)
    out["resnet18"] = {"steps": n_steps, "wall_s": stats["wall_s"], "data_s": stats["data_s"],
                       "top1": acc, "reloaded_top1": top1, "reloaded_max_abs_diff": err,
                       "reloaded_launches_per_step": {k: v for k, v in per_step.items() if v},
                       "reloaded_launches": {k: v for k, v in counts.items() if v},
                       "reloaded_steps": 4,
                       "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase {out['seconds']:.1f} s")
    return out


def accuracy_phase(h) -> dict:
    """10. accuracy: the port's accuracy report (tools/accuracy_report.py
    main) on the card into build/accuracy/Accuracy.md (git-ignored), every
    count set to 0 just before and read just after. It must exit 0, and
    every row holds to docs/Accuracy.md (written by the JAX package on the
    CPU; accuracy_report.check_against: trained rows within 0.1 dB PSNR,
    0.02 top-1 and 0.03 mAP; zoo rows above the JAX gates, bf16 PSNR > 35
    dB and int8 > 30 dB, classifiers' probabilities within 0.1). The AUTO
    engines of the report launch the chain kernel in both forms, the
    single-conv kernel and the block kernel; each must launch."""
    import contextlib
    import io

    from shadernn_tpu_torch.tools import accuracy_report

    log, card = h.log, h.card
    t_phase = time.perf_counter()
    path = os.path.join(REPO, "build", "accuracy", "Accuracy.md")
    h.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = accuracy_report.main(["--out", path, "--device", str(h.dev)])
    counts = {k: v for k, v in h.read_counts().items() if v}
    got = open(path).read()
    want = open(os.path.join(REPO, "docs", "Accuracy.md")).read()
    g, w = accuracy_report.read_report(got), accuracy_report.read_report(want)
    for section, rows in w.items():
        log(f"[accuracy] {section}: " + "; ".join(
            f"{label} {g.get(section, {}).get(label)} (docs {vals})"
            for label, vals in rows.items()))
    bad = accuracy_report.check_against(got, want)
    secs = time.perf_counter() - t_phase
    log(f"[accuracy] main rc {rc}; rows off their limits: {bad or 'none'}; kernel launches "
        f"{counts}; phase {secs:.1f} s | {card}")
    assert rc == 0 and not bad, f"accuracy report: rc {rc}, {bad}"
    for entry in ("fused_conv_chain_packed", "fused_conv_chain", "fused_conv2d_haloed",
                  "fused_invres_block"):
        assert counts.get(entry), f"the report's engines never launched {entry}: {counts}"
    return {"rc": rc, "launches": counts, "seconds": secs, "rows": g}


def parallel_phase(h) -> dict:
    """11. parallel: the port's sharded engines (shadernn_tpu_torch/parallel/)
    on logical meshes of the card (one device named once per shard). Under a
    mesh the chain and block planners stay off, as in the JAX package, and
    each Conv2D that AUTO gives the kernel launches the implicit-GEMM conv
    (B5) once per shard, on halo-extended rows, O-sliced under TP.

    Main paths (counts set to 0 just before each, read just after): ESPCN 2x
    (trained) 540p b8 AUTO at BF16 (2,2,2) and (1,2,4), FP32 (2,2,2) and
    INT8 weight-only (2,2,2): 24 B5 launches a step and nothing else, the
    output within ENGINE_TOL of the single-device engine (the chain kernel)
    and of the TORCH-sharded run; MobileNetV2 224 b8 BF16 at (2,4,1) and
    (1,2,2) (dw_conv TP), ResNet18 zoo b8 at (1,1,4) (halo convs, gap),
    StyleTransfer-candy 512 b4 at (1,1,4) (instnorm; its k9 convs on B5),
    YOLOv3-tiny 256 b8 FP32 at (1,1,2) (pool_halo, the head's gather; its
    stem on B5; raw head features and detections box to box), each within
    ENGINE_TOL of its single-device engine and B5 launched
    shards x kernel convs a step. [kernel] cases at every distinct B5 launch
    of these paths against conv2d_igemm_reference; planted faults (a conv
    halo's edge fill 1.0 instead of the zero padding; a TP gather's shard
    order reversed) must be caught; run_multihost_smoke(2, "cuda") (two
    processes on the card, gloo for control only); measure_scaling over 1,
    2, 4, 8 logical shards: the executor's overhead on one card, not
    scaling; [timing] rows of the ESPCN sharded launch shapes."""
    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.config import BackendKind, ShardingOptions
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import conv_igemm
    from shadernn_tpu_torch.models import zoo
    from shadernn_tpu_torch.parallel import spmd
    from shadernn_tpu_torch.parallel.mesh import make_mesh
    from shadernn_tpu_torch.parallel.scaling import measure_scaling, run_multihost_smoke
    from shadernn_tpu_torch.utils.metrics import detections_agree
    from shadernn_tpu_torch.utils.trace_profile import complete, profile_steps

    dev, log, card = h.dev, h.log, h.card
    bf16, f32 = torch.bfloat16, torch.float32
    FP32, BF16, I8 = Precision.FP32, Precision.BF16, Precision.INT8
    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    out = {"paths": {}, "timing": {}, "max_abs_err": 0.0, "faults": {}}

    def tol_of(prec):
        return h.ENGINE_TOL["fp32" if prec == FP32 else "bf16"]

    def sharded(graph_fn, prec, batch, mesh, backend=BackendKind.AUTO):
        d, m, s = mesh
        sh = ShardingOptions(data=d, model=m, spatial=s)
        return Engine.from_graph(graph_fn(), EngineOptions(
            precision=prec, batch_size=batch, sharding=sh, backend=backend),
            mesh=make_mesh(sh, [dev] * (d * m * s)))

    def single(graph_fn, prec, batch):
        return Engine.from_graph(graph_fn(), EngineOptions(precision=prec, batch_size=batch))

    def step_p50(eng, x, n=10):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.run_single(x)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # Every distinct B5 launch of the main paths, kept once for the
    # [kernel] cases and the [timing] rows.
    shapes, path_of = {}, {}
    current = {"label": ""}
    real = conv_igemm.run  # what the engines' B5 launches go through, on prepared operands

    def recording(x, ops, *, stride=1, pads=(0, 0, 0, 0), activation="linear", alpha=0.3):
        w = ops.hwio
        key = (tuple(x.shape), tuple(w.shape), str(x.dtype).split(".")[-1],
               str(w.dtype).split(".")[-1], int(stride), tuple(int(p) for p in pads),
               str(activation))
        if key not in shapes:
            shapes[key] = (x.clone(), w.clone(), ops.scale.clone(), ops.offset.clone(), alpha)
            path_of[key] = current["label"]
        return real(x, ops, stride=stride, pads=pads, activation=activation, alpha=alpha)

    def drive(label, eng, x, want, torch_want=None, steps=h.STEPS):
        """One main path: `steps` steps with the counts set to 0 just before
        and read just after; B5 launched shards x kernel convs a step, the
        NMS kernel shards x YOLO nodes, and nothing else; every output against `want` (and `torch_want`), the
        outputs of the same engine unsharded: within ENGINE_TOL x max(1,
        max|want|), YOLO detections box to box (utils/metrics.py
        detections_agree; rows of near-equal score may swap)."""
        fwd = eng.model.forward
        mesh = eng.model.mesh
        tol = tol_of(eng.options.precision)
        eng.run({"input": x})  # warm: prepared operands
        current["label"] = label
        conv_igemm.run = recording
        try:
            h.reset_counts()
            ys = [eng.run({"input": x}) for _ in range(steps)]
            counts = {k: v for k, v in h.read_counts().items() if v}
        finally:
            conv_igemm.run = real
        per_step = mesh.size * len(fwd.kernel_conv_plan)
        nms_per_step = mesh.size * len(fwd.nms_plan)
        assert counts == {k: v * steps for k, v in (("conv2d_kernel_nhwc", per_step),
                                                    ("nms_fixed", nms_per_step)) if v}, (
            label, counts, per_step, nms_per_step)
        errs, ok = {}, True
        for name, w_ in want.items():
            y = ys[-1][name].float()
            assert bool(torch.isfinite(y).all()) and y.shape == w_.shape, (label, name, y.shape)
            if eng.graph.nodes[name].op == "YOLO":
                errs[f"{name} boxes"] = detections_agree(y.cpu().numpy(),
                                                         w_.float().cpu().numpy(), tol)
                continue
            scale = max(1.0, w_.float().abs().max().item())
            for ref_name, ref in (("single-device", want), ("torch-sharded", torch_want)):
                if ref is not None:
                    err = (y - ref[name].float()).abs().max().item()
                    errs[f"{name} vs {ref_name}"] = err
                    ok = ok and err <= tol * scale
        p50 = step_p50(eng, x)
        out["paths"][label] = {"launches": counts.get("conv2d_kernel_nhwc", 0),
                               "launches_per_step": per_step, "steps": steps,
                               "max_abs_diff": errs, "step_p50_ms": p50,
                               "plan": eng.model.spmd_plan.summary()}
        log(f"[parallel] {label}: B5 {per_step}/step ({mesh.size} shards x "
            f"{len(fwd.kernel_conv_plan)} convs), plan {eng.model.spmd_plan.summary()}, "
            f"max_abs_diff " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in errs.items())
            + f" (tol {tol} x max(1, max|out|)), step p50 {p50:.3f} ms "
            f"{'ok' if ok else 'FAIL'} | {card}")
        assert ok, f"{label}: sharded output disagrees"

    # ESPCN 2x (trained) 540p b8 ----------------------------------------------
    def espcn():
        return parse_model_file(zoo.ESPCN_TRAINED)

    x8 = rng.random((8, 540, 960, 1), dtype=np.float32)
    for prec, mesh in ((BF16, (2, 2, 2)), (BF16, (1, 2, 4)), (FP32, (2, 2, 2)), (I8, (2, 2, 2))):
        ref = single(espcn, prec, 8)
        want = ref.run({"input": x8})
        ref_p50 = step_p50(ref, x8)
        torch_eng = sharded(espcn, prec, 8, mesh, backend=BackendKind.TORCH)
        eng = sharded(espcn, prec, 8, mesh)
        assert sorted(eng.model.forward.kernel_conv_plan) == ["conv_1", "conv_2", "conv_3"]
        label = f"espcn 540p b8 {prec.value} {'x'.join(map(str, mesh))}"
        drive(label, eng, x8, want, torch_eng.run({"input": x8}))
        busy, ported, text = h.busy_text(eng, {"input": x8}, out["paths"][label]["step_p50_ms"])
        out["paths"][label].update(single_step_p50_ms=ref_p50, device_busy_ms=busy,
                                   b5_device_ms=ported)
        log(f"[parallel] {label}: single-device step p50 {ref_p50:.3f} ms (the chain kernel); "
            f"sharded {text} | {card}")
        if (prec, mesh) == (BF16, (2, 2, 2)):
            planted_eng, planted_want = eng, next(iter(want.values()))
        del ref, torch_eng, eng

    # The rest of the zoo, one mode each ----------------------------------------
    def mnv2():
        return zoo.build_model("mobilenetv2")

    def yolo():  # its raw head features as outputs too
        g = parse_model_file(zoo.YOLOV3_TINY_TRAINED)
        g.output_names = ["head1", "head2", "yolo"]
        return g

    # YOLOv3-tiny at FP32: at BF16 its head features reach |x| ~ 1e2, where
    # one bf16 rounding (0.5) moves a logit enough to move a box past the
    # detections' 0.1 (sharded or not: another summation order suffices).
    zoo_paths = (
        ("mobilenetv2 224 b8", BF16, mnv2, 8, (224, 224, 3), [(2, 4, 1), (1, 2, 2)]),
        ("resnet18 zoo b8", BF16, lambda: zoo.build_model("resnet18"), 8, (32, 32, 3),
         [(1, 1, 4)]),
        ("styletransfer-candy 512 b4", BF16,
         lambda: zoo.build_model("styletransfer-candy", h=512, w=512), 4, (512, 512, 3),
         [(1, 1, 4)]),
        ("yolov3-tiny 256 b8", FP32, yolo, 8, (256, 256, 3), [(1, 1, 2)]),
    )
    for name, prec, fn, batch, hwc, meshes in zoo_paths:
        x = rng.random((batch, *hwc), dtype=np.float32)
        want = single(fn, prec, batch).run({"input": x})
        for mesh in meshes:
            drive(f"{name} {prec.value} {'x'.join(map(str, mesh))}",
                  sharded(fn, prec, batch, mesh), x, want, steps=2)

    # [kernel]: every distinct B5 launch against its plain version -------------------
    for (xs, ws, xdt, wdt, st, pads, act), (x, w, sc, of, alpha) in shapes.items():
        label = f"B5 sharded {xs}->{ws[-1]} k{ws[0]} {xdt} w {wdt} pads {pads}"
        got = conv_igemm.conv2d_kernel_nhwc(x, w, sc, of, stride=st, pads=pads, activation=act,
                                            alpha=alpha)
        want = conv_igemm.conv2d_igemm_reference(x, w, sc, of, st, pads, act, alpha)
        out["max_abs_err"] = max(out["max_abs_err"], h.held(
            label, "conv2d_kernel_nhwc", got, want, bf16 if x.dtype == bf16 else f32))

    # Planted faults: each must be caught -----------------------------------------------
    tol = tol_of(BF16) * max(1.0, planted_want.float().abs().max().item())
    halo = spmd.Collectives.halo
    gather = spmd.Collectives.gather

    def wrong_fill(self, vals, axis, up, dn, fill=0.0):
        return halo(self, vals, axis, up, dn, 1.0 if fill == 0.0 else fill)

    def reversed_tp(self, vals, axis, dim):
        if axis != "model":
            return gather(self, vals, axis, dim)
        return self._reduce(vals, axis, lambda parts: torch.cat(parts[::-1], dim=dim))

    for fault, patch in (("halo edge fill 1.0", ("halo", wrong_fill)),
                         ("TP gather reversed", ("gather", reversed_tp))):
        setattr(spmd.Collectives, *patch)
        try:
            y = planted_eng.run_single(x8).float()
        finally:
            spmd.Collectives.halo, spmd.Collectives.gather = halo, gather
        diff = (y - planted_want.float()).abs().max().item()
        out["faults"][fault] = diff
        log(f"[parallel] planted fault ({fault}) on espcn 540p b8 bf16 2x2x2: max_abs_diff "
            f"{diff:.3e} > tol {tol:.1e}: {'caught' if diff > tol else 'MISSED'}")
        assert diff > tol, f"planted fault not caught: {fault}"

    # Multi-process hosts: 2 processes on the card ----------------------------------------
    t0 = time.perf_counter()
    rc = run_multihost_smoke(2, device="cuda", timeout=300)
    out["multihost"] = {"rc": rc, "seconds": time.perf_counter() - t0}
    log(f"[parallel] run_multihost_smoke(2, cuda): rc {rc}, "
        f"{out['multihost']['seconds']:.1f} s")
    assert rc == 0, "multihost smoke failed"

    # The executor's overhead on one card ---------------------------------------------------
    recs = measure_scaling("espcn", (1, 2, 4, 8), per_device_batch=2, precision=BF16,
                           iters=10, devices=[dev] * 8, build_kwargs={"h": 540, "w": 960})
    out["scaling"] = recs
    for r in recs:
        log(f"[parallel] logical shards {r['devices']} (one card; the executor's overhead, not "
            f"scaling): b{r['batch']} {r['mean_ms']:.3f} ms/step {r['frames_per_sec']:.1f} "
            f"frames/s, efficiency {r['efficiency']:.3f} | {card}")

    # [timing]: the ESPCN sharded launch shapes ---------------------------------------------
    # Device ms only from a profile that saw every launch (else None: "not
    # measured"); the event ms of back-to-back calls beside it.
    def timed(fns):
        res = {}
        for k, fn in fns.items():
            rep = profile_steps(fn, 10, dev)
            res[k] = (h.time_ms(fn), rep.e2e_us / 1e3 if complete(rep) else None)
        return res

    def ms_text(v):
        return "not measured" if v is None else f"{v:.4f}"

    for key, (x, w, sc, of, alpha) in shapes.items():
        xs, ws, xdt, wdt, st, pads, act = key
        if not path_of[key].startswith("espcn"):
            continue
        label = f"{'x'.join(map(str, xs))}->{ws[-1]} k{ws[0]} {xdt} w {wdt} ({path_of[key]})"
        dt = bf16 if x.dtype == bf16 else f32
        ops = conv_igemm.prepare(w, sc, of, x.dtype)
        t = timed({
            "kernel": lambda: real(x, ops, stride=st, pads=pads, activation=act),
            "plain": lambda: conv_igemm.conv2d_igemm_reference(x, w, sc, of, st, pads, act),
            "library": h.conv_yardstick(x, w.to(dt), sc, of, pads, act, dt)})
        n, hh, ww, c = xs
        kh, kw, _, o = ws
        ho, wo = hh + pads[0] + pads[1] - kh + 1, ww + pads[2] + pads[3] - kw + 1
        flops = 2.0 * n * ho * wo * kh * kw * c * o
        nbytes = x.numel() * x.element_size() + n * ho * wo * o * x.element_size() \
            + w.numel() * w.element_size() + 8 * o
        b_ms, b_by = h.bound(flops, nbytes, dt)
        b3, b3_text = h.tf32(flops, nbytes, dt)
        out["timing"][label] = dict(
            ms=t["kernel"][0], plain_ms=t["plain"][0], library_ms=t["library"][0],
            device_ms=t["kernel"][1], plain_device_ms=t["plain"][1],
            library_device_ms=t["library"][1], bound_ms=b_ms, bound_by=b_by, **b3)
        log(f"[timing] conv2d_kernel_nhwc sharded {label}: " + " ".join(
            f"{k if k != 'library' else 'cudnn'} {v[0]:.4f} ms (device {ms_text(v[1])})"
            for k, v in t.items())
            + f" bound {b_ms:.5f} ms ({b_by}; {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB"
            f"{b3_text}) | {card}")
    out["launches"] = sum(p["launches"] for p in out["paths"].values())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[parallel] phase {out['seconds']:.1f} s; B5 launches on the sharded paths "
        f"{out['launches']}")
    return out


def pipeline_phase(h) -> dict:
    """12. pipeline: the last modules of the port on the card. The native
    host runtime (shadernn_tpu_torch/native.py: its C++ built here by the
    host compiler), pipeline parallelism (parallel/pipeline.py) and elastic
    recovery (parallel/elastic.py). A pipeline stage runs the graph node by
    node on its own CUDA stream, each Conv2D that AUTO gives the kernel on
    the implicit-GEMM conv (B5); the elastic engine's sharded engines launch
    B5 once per shard and kernel conv, and once shrunk to one device the
    chain kernel (B1) once per bucket.

    native: each function bit-equal to its numpy version on the trained
    ESPCN's and the trained MobileNetV2's weight streams (the repacks,
    int8 quantization) and on a 1080p NV12/NV21 frame; 1,000 540p frames
    through the ring from a producer thread to a consumer thread, in order;
    write_dump's bytes; Engine.from_json of the trained ESPCN through the
    library. pipeline (counts set to 0 just before each path, read just
    after): ESPCN 2x (trained) 540p b8 AUTO at BF16 and FP32, 4 stages on
    [cuda:0] * 4, micro_batch 2: 12 B5 launches a step and nothing else,
    within ENGINE_TOL of the single-device Engine.run (the chain kernel) and
    of a TORCH-backend pipeline; PP x DP, 2 stages of [cuda:0, cuda:0] at
    micro_batch 4 (12 B5 a step); U-Net (trained) 256 b8 BF16, 4 stages
    (its skips cross stages), held to its engine; throughput_stats and the
    dry run's pipeline gate (parallel/dryrun.py pipeline_dryrun); a planted
    fault (micro-batches reassembled in reverse order) must be caught.
    elastic: ESPCN 540p b8 BF16 with ShardingOptions(data=4) on [cuda:0] *
    4 (12 B5 a step); inject_failure(device=3): the replayed step within
    ENGINE_TOL of Engine.run, data 4 -> 2, 6 B5 per engine step (12 for the
    8 frames in two buckets); entries 1 and 2 marked failed and one more
    failure: a single-device engine, one B1 per bucket; a real device-side
    hang (torch.cuda._sleep of about 1 s queued after the step, watchdog
    0.2 s): StepTimeout, the probe passes once the sleep drains, the leaked
    waiter is reaped and the next step completes; the same hang on a
    one-device ElasticEngine with the default max_rebuilds, recovered inside
    run() (the rebuild, under the watchdog, waits for the sleep); and a sleep
    longer than every deadline, where each rebuild's upload waits behind it:
    run() must raise StepTimeout or RuntimeWedged while the sleep still runs,
    within the step's deadline, a rebuild deadline per rebuild and one
    probe's, and every stuck thread returns once it ends. [kernel] cases at every
    distinct B5 and B1 launch of these paths; [timing] rows: the pipelined
    step p50 beside the single-device step, device busy, idle share, and B5
    at the pipeline's launch shapes."""
    import threading

    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision, native
    from shadernn_tpu_torch.config import BackendKind, ShardingOptions
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import chain, conv_igemm
    from shadernn_tpu_torch.models import zoo
    from shadernn_tpu_torch.parallel.dryrun import CUDA_GATE_HW, pipeline_dryrun
    from shadernn_tpu_torch.parallel.elastic import (
        ElasticEngine, RuntimeWedged, StepTimeout,
    )
    from shadernn_tpu_torch.parallel.pipeline import PipelinedEngine
    from shadernn_tpu_torch.utils.trace_profile import HAND_WRITTEN, device_profile

    dev, log, card = h.dev, h.log, h.card
    bf16, f32 = torch.bfloat16, torch.float32
    FP32, BF16 = Precision.FP32, Precision.BF16
    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    out = {"native": {}, "pipeline": {}, "elastic": {}, "timing": {}, "max_abs_err": {},
           "launches": {"conv2d_kernel_nhwc": 0, "fused_conv_chain_packed": 0}}

    def tol_of(prec):
        return h.ENGINE_TOL["fp32" if prec == FP32 else "bf16"]

    # native -------------------------------------------------------------------
    t0 = time.perf_counter()
    native.build(force=True)
    out["native"]["build_s"] = time.perf_counter() - t0
    streams = {"espcn": parse_model_file(zoo.ESPCN_TRAINED),
               "mobilenetv2": parse_model_file(zoo.MOBILENETV2_TRAINED)}
    checked = {"repack_oihw_to_hwio": 0, "repack_dw_to_hw1o": 0, "quantize_int8": 0}
    for g in streams.values():
        for node in g.nodes.values():
            w = node.params.get("weight")
            if w is None or np.ndim(w) != 4:
                continue
            w = np.asarray(w, np.float32)
            kh, kw, i, o = w.shape
            if node.op == "Conv2D":  # the artifact's OIHW stream
                flat = np.ascontiguousarray(w.transpose(3, 2, 0, 1)).reshape(-1)
                got = native.repack_oihw_to_hwio(flat, o, i, kh, kw)
                want = native.repack_oihw_to_hwio_plain(flat, o, i, kh, kw)
                name = "repack_oihw_to_hwio"
            else:  # depthwise: per output channel kh x kw
                flat = np.ascontiguousarray(w[:, :, 0, :].transpose(2, 0, 1)).reshape(-1)
                got = native.repack_dw_to_hw1o(flat, o, kh, kw)
                want = native.repack_dw_to_hw1o_plain(flat, o, kh, kw)
                name = "repack_dw_to_hw1o"
            assert np.array_equal(got, want) and np.array_equal(got, w), (name, node.name)
            q, s = native.quantize_int8(w)
            q_, s_ = native.quantize_int8_plain(w)
            assert np.array_equal(q, q_) and np.array_equal(s, s_), node.name
            checked[name] += 1
            checked["quantize_int8"] += 1
    fy = rng.integers(0, 256, (1080, 1920), dtype=np.uint8)
    fuv = rng.integers(0, 256, (540, 960, 2), dtype=np.uint8)
    for nv21 in (False, True):
        t0 = time.perf_counter()
        got = native.nv12_to_rgb(fy, fuv, nv21=nv21)
        ms = (time.perf_counter() - t0) * 1e3
        assert np.array_equal(got, native.nv12_to_rgb_plain(fy, fuv, nv21=nv21)), nv21
        out["native"][f"{'nv21' if nv21 else 'nv12'}_to_rgb_1080p_ms"] = ms
    checked["nv12_to_rgb"] = 2
    dump_dir = os.path.join(REPO, "build", "native")
    w_stream = np.asarray(streams["espcn"].nodes["conv_2"].params["weight"])
    for fn, name in ((native.write_dump, "dump.bin"), (native.write_dump_plain, "plain.bin")):
        fn(os.path.join(dump_dir, name), w_stream)
    with open(os.path.join(dump_dir, "dump.bin"), "rb") as a, \
            open(os.path.join(dump_dir, "plain.bin"), "rb") as b:
        assert a.read() == b.read() == w_stream.astype("<f4").tobytes()
    for name in ("dump.bin", "plain.bin"):
        os.remove(os.path.join(dump_dir, name))
    checked["write_dump"] = 1
    # The ring: 1,000 540p luma frames (the first 8 bytes carry the index).
    n_frames, slot = 1000, 540 * 960
    ring = native.NativeFrameRing(capacity=8, slot_bytes=slot)
    frames = rng.integers(0, 256, (16, slot), dtype=np.uint8)
    seen, bad = [], []

    def producer():
        for i in range(n_frames):
            f = frames[i % 16].copy()
            f[:8] = np.frombuffer(np.int64(i).tobytes(), np.uint8)
            while not ring.push(f):
                pass

    def consumer():
        while len(seen) < n_frames:
            f = ring.pop()
            if f is None:
                continue
            i = int(f[:8].view(np.int64)[0])
            seen.append(i)
            if f.size != slot or not np.array_equal(f[8:], frames[i % 16][8:]):
                bad.append(i)

    threads = [threading.Thread(target=consumer), threading.Thread(target=producer)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    ring_s = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads) and seen == list(range(n_frames)) and not bad
    ring.close()
    out["native"]["ring_frames_per_s"] = n_frames / ring_s
    calls = {"n": 0}
    real_repack = native.repack_oihw_to_hwio

    def counted_repack(*a):
        calls["n"] += 1
        return real_repack(*a)

    native.repack_oihw_to_hwio = counted_repack
    try:
        loaded = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(precision=BF16, batch_size=8))
    finally:
        native.repack_oihw_to_hwio = real_repack
    assert calls["n"] == 3, calls
    out["native"]["checked"] = checked
    log(f"[pipeline] native: built in {out['native']['build_s']:.1f} s "
        f"({native.LIB_PATH}); bit-equal to the numpy versions: {checked} (the trained "
        f"ESPCN's and MobileNetV2's weight streams; a 1080p frame: NV12 "
        f"{out['native']['nv12_to_rgb_1080p_ms']:.2f} ms, NV21 "
        f"{out['native']['nv21_to_rgb_1080p_ms']:.2f} ms); ring: {n_frames} 540p frames "
        f"from a producer thread to a consumer thread in order, "
        f"{out['native']['ring_frames_per_s']:.0f} frames/s; Engine.from_json of the trained "
        f"ESPCN through the library ({calls['n']} repacks) | {card}")

    # Every distinct B5 and B1 launch of the paths below, kept once for the
    # [kernel] cases and the [timing] rows.
    shapes, chains, path_of = {}, {}, {}
    current = {"label": ""}
    # The engines' B5 launches go through conv_igemm.run, on prepared operands.
    real_b5, real_b1 = conv_igemm.run, chain.fused_conv_chain_packed

    def recording_b5(x, ops, *, stride=1, pads=(0, 0, 0, 0), activation="linear", alpha=0.3):
        w = ops.hwio
        key = (tuple(x.shape), tuple(w.shape), str(x.dtype).split(".")[-1],
               str(w.dtype).split(".")[-1], int(stride), tuple(int(p) for p in pads),
               str(activation))
        if key not in shapes:
            shapes[key] = (x.clone(), w.clone(), ops.scale.clone(), ops.offset.clone(), alpha)
            path_of[key] = current["label"]
        return real_b5(x, ops, stride=stride, pads=pads, activation=activation, alpha=alpha)

    def recording_b1(x, layer_params, specs, *, tail="none", compute_dtype=None):
        key = (tuple(x.shape), str(x.dtype).split(".")[-1], tail)
        if key not in chains:
            chains[key] = (x.clone(), layer_params, specs, tail, compute_dtype)
            path_of[key] = current["label"]
        return real_b1(x, layer_params, specs, tail=tail, compute_dtype=compute_dtype)

    conv_igemm.run = recording_b5
    chain.fused_conv_chain_packed = recording_b1

    def counted(label, fn):
        """fn() with every kernel's count set to 0 just before and read just
        after: (its result, the counts launched)."""
        current["label"] = label
        h.reset_counts()
        res = fn()
        return res, {k: v for k, v in h.read_counts().items() if v}

    def err_of(label, y, want, prec):
        y = y.float()
        assert bool(torch.isfinite(y).all()) and y.shape == want.shape, (label, y.shape)
        tol = tol_of(prec) * max(1.0, want.float().abs().max().item())
        err = (y - want.float()).abs().max().item()
        assert err <= tol, f"{label}: max_abs_diff {err} > {tol}"
        return err, tol

    def p50_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    try:
        # pipeline: ESPCN 2x (trained) 540p b8 -----------------------------------
        def espcn():
            return parse_model_file(zoo.ESPCN_TRAINED)

        x8 = rng.random((8, 540, 960, 1), dtype=np.float32)
        x8_dev = torch.from_numpy(x8).to(dev)
        wants = {}
        for prec in (BF16, FP32):
            ref = Engine.from_graph(espcn(), EngineOptions(precision=prec, batch_size=8))
            want = wants[prec] = ref.run_single(x8_dev).float()
            tpipe = PipelinedEngine(espcn(), EngineOptions(precision=prec,
                                                           backend=BackendKind.TORCH),
                                    devices=[dev] * 4, micro_batch=2)
            torch_want = tpipe.run({"input": x8})[tpipe.graph.output_names[0]]
            pipe = PipelinedEngine(espcn(), EngineOptions(precision=prec), devices=[dev] * 4,
                                   micro_batch=2)
            name = pipe.graph.output_names[0]
            label = current["label"] = f"espcn 540p b8 {prec.value} 4 stages mb2"
            pipe.run({"input": x8})  # warm: the TORCH layers' weights
            ys, counts = counted(label, lambda: [pipe.run({"input": x8})
                                                 for _ in range(h.STEPS)])
            assert counts == {"conv2d_kernel_nhwc": 12 * h.STEPS}, (label, counts)
            err, tol = err_of(label, ys[-1][name], want, prec)
            err_t, _ = err_of(label, ys[-1][name], torch_want, prec)
            step = lambda: pipe.run({"input": x8_dev})  # noqa: E731
            p50, ref_p50 = p50_ms(step), p50_ms(lambda: ref.run_single(x8_dev))
            busy, top = device_profile(lambda: pipe._wait(pipe.dispatch({"input": x8_dev})), 5,
                                       dev)
            ported = sum(v for k, v in top if HAND_WRITTEN.search(k))
            out["pipeline"][label] = dict(
                launches=counts["conv2d_kernel_nhwc"], launches_per_step=12, steps=h.STEPS,
                stages=[[n.name for n in s.nodes] for s in pipe.stages],
                max_abs_diff_vs_engine=err, max_abs_diff_vs_torch_pipeline=err_t, tol=tol,
                step_p50_ms=p50, single_device_step_p50_ms=ref_p50, device_busy_ms=busy,
                b5_device_ms=ported, idle_share=1 - busy / p50 if busy else None)
            out["launches"]["conv2d_kernel_nhwc"] += counts["conv2d_kernel_nhwc"]
            log(f"[pipeline] {label}: stages {out['pipeline'][label]['stages']}, B5 12/step, "
                f"max_abs_diff vs Engine.run {err:.3e}, vs the TORCH pipeline {err_t:.3e} (tol "
                f"{tol:.1e}) ok | {card}")
            log(f"[timing] pipeline {label}: step p50 {p50:.3f} ms (inputs on the card, host "
                f"clock to a synchronize) against the single-device step {ref_p50:.3f} ms (the "
                f"chain kernel); device busy {busy:.3f} ms per step (B5 {ported:.3f} ms), idle "
                f"share {1 - busy / p50:.3f}; top " + "; ".join(
                    f"{k[:50]} {v:.3f} ms" for k, v in top[:4]) + f" | {card}")
            if prec == BF16:
                planted = (pipe, want, tol)
            del ref, tpipe

        # PP x DP: 2 stages, each a data sub-mesh of [cuda:0, cuda:0] ----------------
        pipe = PipelinedEngine(espcn(), EngineOptions(precision=BF16),
                               devices=[[dev, dev]] * 2, micro_batch=4)
        label = current["label"] = "espcn 540p b8 bf16 2 stages x [cuda:0, cuda:0] mb4"
        pipe.run({"input": x8})
        ys, counts = counted(label, lambda: [pipe.run({"input": x8}) for _ in range(h.STEPS)])
        assert counts == {"conv2d_kernel_nhwc": 12 * h.STEPS}, (label, counts)
        err, tol = err_of(label, ys[-1][pipe.graph.output_names[0]], wants[BF16], BF16)
        out["pipeline"][label] = dict(launches=counts["conv2d_kernel_nhwc"], launches_per_step=12,
                                      steps=h.STEPS, max_abs_diff_vs_engine=err, tol=tol)
        out["launches"]["conv2d_kernel_nhwc"] += counts["conv2d_kernel_nhwc"]
        log(f"[pipeline] {label}: B5 12/step (3 convs x 2 shards x 2 micro-batches), "
            f"max_abs_diff vs Engine.run {err:.3e} (tol {tol:.1e}) ok | {card}")
        del pipe

        # U-Net (trained) 256 b8: the skips cross stages --------------------------------
        def unet():
            return parse_model_file(zoo.UNET_TRAINED, input_hw=(256, 256))

        xu = rng.random((8, 256, 256, 1), dtype=np.float32)
        ref = Engine.from_graph(unet(), EngineOptions(precision=BF16, batch_size=8))
        want = ref.run_single(xu).float()
        pipe = PipelinedEngine(unet(), EngineOptions(precision=BF16), devices=[dev] * 4,
                               micro_batch=2)
        assert any(set(s.consumes) - {n.name for n in pipe.stages[s.index - 1].nodes}
                   for s in pipe.stages[1:]), "no U-Net value skips a stage"
        kernel_convs = sum(backend == BackendKind.KERNEL
                           for s in pipe.stages for _n, _v, backend, _k in s.steps[0])
        label = current["label"] = "unet 256 b8 bf16 4 stages mb2"
        pipe.run({"input": xu})
        ys, counts = counted(label, lambda: [pipe.run({"input": xu}) for _ in range(2)])
        assert counts == ({"conv2d_kernel_nhwc": kernel_convs * 4 * 2} if kernel_convs else {}), (
            label, counts, kernel_convs)
        err, tol = err_of(label, ys[-1][pipe.graph.output_names[0]], want, BF16)
        p50, ref_p50 = p50_ms(lambda: pipe.run({"input": xu})), p50_ms(lambda: ref.run_single(xu))
        out["pipeline"][label] = dict(launches=counts.get("conv2d_kernel_nhwc", 0),
                                      launches_per_step=kernel_convs * 4, steps=2,
                                      max_abs_diff_vs_engine=err, tol=tol, step_p50_ms=p50,
                                      single_device_step_p50_ms=ref_p50)
        out["launches"]["conv2d_kernel_nhwc"] += counts.get("conv2d_kernel_nhwc", 0)
        log(f"[pipeline] {label}: stages consume {[s.consumes for s in pipe.stages]}, B5 "
            f"{kernel_convs * 4}/step ({kernel_convs} kernel convs x 4 micro-batches), "
            f"max_abs_diff vs Engine.run {err:.3e} (tol {tol:.1e}) ok; step p50 {p50:.3f} ms "
            f"against {ref_p50:.3f} single-device (host clock, frames from the host) | {card}")
        del ref, pipe

        # throughput_stats on the card and the dry run's pipeline gate ---------------------
        pipe, want, tol = planted
        stats = [pipe.throughput_stats({"input": x8_dev}, iters=3) for _ in range(3)]
        out["pipeline"]["throughput_stats espcn 540p b8 bf16 4 stages"] = stats
        for st in stats:
            log(f"[pipeline] throughput_stats espcn 540p b8 bf16, 4 stages on one card, frames "
                f"on the card: "
                f"speedup {st['speedup']}, schedule_inversions {st['schedule_inversions']}, "
                f"dispatch_fraction {st['dispatch_fraction']}, serial {st['serial_s'] * 1e3:.3f} "
                f"ms, pipelined {st['pipelined_s'] * 1e3:.3f} ms, bubble model "
                f"{st['bubble_fraction_model']}, overlap_efficiency "
                f"{st['overlap_efficiency']} | {card}")
        current["label"] = "dry run"
        dry = pipeline_dryrun([dev] * 8)
        out["pipeline"]["dryrun"] = dry
        log(f"[pipeline] dry run (pipeline half, 8 logical devices: 4 stages x 2-device data "
            f"sub-meshes, ESPCN BF16 b16 mb2): at 16x32 {dry['16x32']}; the gate (speedup > "
            f"1.15 or schedule_inversions > 0) held at {'x'.join(map(str, CUDA_GATE_HW))}: "
            f"speedup {dry['speedup']}, schedule_inversions {dry['schedule_inversions']}, "
            f"dispatch_fraction {dry['dispatch_fraction']} | {card}")

        # Planted fault: micro-batches reassembled in reverse order ---------------------------
        inflight = pipe.dispatch({"input": x8})
        y = torch.cat([e[pipe.graph.output_names[0]].float() for e in reversed(inflight)])
        diff = (y - want).abs().max().item()
        out["pipeline"]["planted_fault_reversed_diff"] = diff
        log(f"[pipeline] planted fault (micro-batches reassembled in reverse order): "
            f"max_abs_diff {diff:.3e} > tol {tol:.1e}: {'caught' if diff > tol else 'MISSED'} "
            f"| {card}")
        assert diff > tol, "planted fault not caught: reversed micro-batches"
        del pipe, planted, inflight

        # elastic: ESPCN 540p b8 BF16, data=4 on [cuda:0] * 4 ---------------------------------
        want = wants[BF16]
        ee = ElasticEngine(espcn, EngineOptions(precision=BF16, batch_size=8,
                                                sharding=ShardingOptions(data=4)),
                           devices=[dev] * 4)
        name = ee.engine.graph.output_names[0]
        current["label"] = "elastic data 4"
        ee.run({"input": x8})  # warm

        def elastic_step(label, x=x8, w=want):
            res, counts = counted(label, lambda: ee.run({"input": x}))
            err, tol = err_of(label, res[name], w, BF16)
            for k, v in counts.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            return counts, err, tol

        rows = out["elastic"]
        counts, err, tol = elastic_step("elastic data 4")
        assert counts == {"conv2d_kernel_nhwc": 12}, counts
        rows["data 4"] = dict(data=4, launches=counts, launches_per_engine_step=12,
                              max_abs_diff=err)
        ee.inject_failure(device=3)
        counts, err, tol = elastic_step("elastic after inject_failure(device=3)")
        assert ee.data_parallel_degree == 2 and ee.excluded_ids == {3}, ee.excluded_ids
        assert counts == {"conv2d_kernel_nhwc": 12}, counts  # 2 buckets x 2 shards x 3 convs
        rows["data 2"] = dict(data=2, excluded=sorted(ee.excluded_ids), launches=counts,
                              launches_per_engine_step=6, buckets=2, max_abs_diff=err)
        ee.mark_failed(1)
        ee.mark_failed(2)
        ee.inject_failure()
        counts, err, tol = elastic_step("elastic, one entry left")
        assert ee.data_parallel_degree == 1 and ee.healthy_ids() == [0]
        assert counts == {"fused_conv_chain_packed": 4}, counts  # one B1 per bucket of 2
        rows["data 1"] = dict(data=1, excluded=sorted(ee.excluded_ids), launches=counts,
                              launches_per_engine_step=1, buckets=4, max_abs_diff=err)
        log(f"[pipeline] elastic espcn 540p b8 bf16 on [cuda:0] * 4: data 4 B5 12/step; "
            f"inject_failure(device=3) -> data 2, entry 3 excluded, B5 6 per engine step x 2 "
            f"buckets; entries 1, 2 failed + one failure -> one device, B1 once per bucket x 4; "
            f"max_abs_diff vs Engine.run "
            + ", ".join(f"{k} {v['max_abs_diff']:.3e}" for k, v in rows.items())
            + f" (tol {tol:.1e}) ok | {card}")

        # A real device-side hang: a ~1 s sleep queued after the step --------------------------
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        cycles_per_ms = 1e7 / a.elapsed_time(b)

        def hang_after_step(engine, ms):
            """Queue a sleep of `ms` after each step of `engine`, on the step's
            stream; the list gets an event recorded after each sleep."""
            forward, ends = engine.model.forward, []

            def hung(params, inputs):
                res = forward(params, inputs)
                torch.cuda._sleep(int(cycles_per_ms * ms))
                ends.append(torch.cuda.Event())
                ends[-1].record()
                return res

            engine.model.forward = hung
            return ends

        hang_after_step(ee.engine, 1000)
        ee.step_timeout_s, max_rebuilds = 0.2, ee._max_rebuilds
        ee._max_rebuilds = ee.rebuilds  # surface the timeout
        t0 = time.perf_counter()
        try:
            ee.run({"input": x8[:2]})
            raise AssertionError("the hung step was not caught")
        except StepTimeout as e:
            caught_s = time.perf_counter() - t0
            timeout_msg = str(e)
        leaked = len(ee._leaked)
        assert leaked == 1 and ee.healthy_ids() == [0], (leaked, ee.excluded_ids)
        ee._max_rebuilds = max_rebuilds
        t0 = time.perf_counter()
        counts, err, _ = elastic_step("elastic after the hang", x8[:2], want[:2])
        next_s = time.perf_counter() - t0
        assert not [th for th in ee._leaked if th.is_alive()], ee._leaked
        assert counts == {"fused_conv_chain_packed": 1}, counts
        rows["hang"] = dict(sleep_ms=1000.0, step_timeout_s=0.2, caught_after_s=caught_s,
                            leaked_waiters=leaked, next_step_s=next_s, max_abs_diff=err)
        log(f"[pipeline] elastic hang: torch.cuda._sleep(~1 s) after the step, watchdog 0.2 s: "
            f"StepTimeout ({timeout_msg}) raised {caught_s:.3f} s after the call (watchdog, "
            f"then the probe of entry 0 on a stream of its own: passed, no entry excluded), 1 "
            f"leaked waiter, ended by the next step; next step {next_s:.3f} s (the rebuild "
            f"included, under the watchdog: its upload waits for the sleep to drain), "
            f"max_abs_diff {err:.3e} ok | {card}")
        del ee

        # The same hang with recovery on (default max_rebuilds, one device): run() times the
        # step out, rebuilds under the watchdog (the upload waits for the sleep) and replays.
        x2, want2 = x8[:2], want[:2]
        ee = ElasticEngine(espcn, EngineOptions(precision=BF16, batch_size=2), devices=[dev],
                           step_timeout_s=0.2)
        ee.run({"input": x2})  # warm
        hang_after_step(ee.engine, 1000)
        t0 = time.perf_counter()
        res, counts = counted("elastic, a 1 s hang recovered", lambda: ee.run({"input": x2}))
        recovered_s = time.perf_counter() - t0
        err, _ = err_of("elastic, a 1 s hang recovered", res[name], want2, BF16)
        assert (ee.failures, ee.rebuilds, ee.excluded_ids) == (1, 1, set()), ee.excluded_ids
        assert counts == {"fused_conv_chain_packed": 2}, counts  # the hung step, the replay
        out["launches"]["fused_conv_chain_packed"] += 2
        rows["hang recovered"] = dict(sleep_ms=1000.0, step_timeout_s=0.2,
                                      max_rebuilds=ee._max_rebuilds, run_s=recovered_s,
                                      launches=counts, max_abs_diff=err)
        del ee

        # A hang that outlasts every deadline, default max_rebuilds: each rebuild's upload waits
        # behind it, so each rebuild times out too, and run() must give up in bounded time.
        ee = ElasticEngine(espcn, EngineOptions(precision=BF16, batch_size=2), devices=[dev],
                           step_timeout_s=0.2)
        ee.run({"input": x2})  # warm
        recovery = ee._recovery_deadline()
        # The longest path: the step's deadline, a rebuild deadline per rebuild, and one probe
        # that times out (it excludes the device, and run() gives up at once); 2 s for the host.
        bound_s = ee.step_timeout_s + (ee._max_rebuilds + 1) * recovery + 2.0
        sleep_s = bound_s + 3.0
        ends = hang_after_step(ee.engine, sleep_s * 1e3)
        t0 = time.perf_counter()
        try:
            ee.run({"input": x2})
            raise AssertionError("the endless hang was not caught")
        except (StepTimeout, RuntimeWedged) as e:
            gave_up_s, gave_up = time.perf_counter() - t0, type(e).__name__
        still_hung = not ends[0].query()
        stuck = len(ee._leaked)
        assert still_hung, "the sleep ended before run() gave up"
        assert gave_up_s < bound_s, (gave_up_s, bound_s)
        attempts = (ee.failures, ee.rebuilds)
        ends[0].synchronize()
        for th in ee._leaked:
            th.join(60)
        assert not [th for th in ee._leaked if th.is_alive()], "a stuck thread never returned"
        after = {}
        if ee.healthy_ids():  # the probes passed: the next step completes
            res, counts = counted("elastic after the endless hang",
                                  lambda: ee.run({"input": x2}))
            after = dict(launches=counts,
                         max_abs_diff=err_of("elastic after the endless hang", res[name],
                                             want2, BF16)[0])
            assert counts == {"fused_conv_chain_packed": 1}, counts
            out["launches"]["fused_conv_chain_packed"] += 1
        rows["endless hang"] = dict(sleep_s=sleep_s, step_timeout_s=0.2,
                                    recovery_deadline_s=recovery,
                                    max_rebuilds=ee._max_rebuilds, raised=gave_up,
                                    gave_up_after_s=gave_up_s, bound_s=bound_s,
                                    failures=attempts[0], rebuilds=attempts[1],
                                    stuck_threads=stuck, excluded=sorted(ee.excluded_ids),
                                    next_step=after)
        log(f"[pipeline] elastic hang recovered (default max_rebuilds {ee._max_rebuilds}, "
            f"one device): a ~1 s sleep after the step, watchdog 0.2 s; run() returned in "
            f"{recovered_s:.3f} s (a timeout, the probe, a rebuild under the watchdog, the "
            f"replay), B1 twice, max_abs_diff {rows['hang recovered']['max_abs_diff']:.3e} ok | "
            f"{card}")
        log(f"[pipeline] elastic endless hang: a {sleep_s:.1f} s sleep after the step, "
            f"watchdog 0.2 s, recovery deadline {recovery:.1f} s, max_rebuilds "
            f"{ee._max_rebuilds}: {gave_up} after {gave_up_s:.3f} s (bound {bound_s:.1f} s) "
            f"with the sleep still running, {attempts[0]} failures, {attempts[1]} rebuilds, "
            f"{stuck} stuck threads, all returned once the sleep ended; next step "
            f"{after or 'not run: the probe excluded the device'} | {card}")
        del ee
    finally:
        conv_igemm.run, chain.fused_conv_chain_packed = real_b5, real_b1

    # [kernel]: every distinct B5 and B1 launch of these paths against its plain version
    out["max_abs_err"] = {"conv2d_kernel_nhwc": 0.0, "fused_conv_chain_packed": 0.0}
    for (xs, ws, xdt, wdt, st, pads, act), (x, w, sc, of, alpha) in shapes.items():
        label = f"B5 {xs}->{ws[-1]} k{ws[0]} {xdt} w {wdt}"
        got = conv_igemm.conv2d_kernel_nhwc(x, w, sc, of, stride=st, pads=pads, activation=act,
                                            alpha=alpha)
        ref = conv_igemm.conv2d_igemm_reference(x, w, sc, of, st, pads, act, alpha)
        out["max_abs_err"]["conv2d_kernel_nhwc"] = max(
            out["max_abs_err"]["conv2d_kernel_nhwc"],
            h.held(label, "conv2d_kernel_nhwc", got, ref, bf16 if x.dtype == bf16 else f32))
    for (xs, xdt, tail), (x, ops, specs, tail, cdt) in chains.items():
        got = real_b1(x, ops, specs, tail=tail, compute_dtype=cdt)
        ref = chain.conv_chain_reference(x, getattr(ops, "layers", ops), specs, tail, cdt)
        out["max_abs_err"]["fused_conv_chain_packed"] = max(
            out["max_abs_err"]["fused_conv_chain_packed"],
            h.held(f"B1 {xs} {xdt} {tail}", "fused_conv_chain_packed", got, ref,
                   bf16 if cdt == bf16 else f32))

    # [timing]: B5 at the pipelines' launch shapes (ESPCN 540p, U-Net 256) ----------------------
    for key, (x, w, sc, of, alpha) in shapes.items():
        xs, ws, xdt, wdt, st, pads, act = key
        if not path_of[key].startswith(("espcn 540p b8", "unet")):
            continue
        dt = bf16 if x.dtype == bf16 else f32
        label = f"{'x'.join(map(str, xs))}->{ws[-1]} k{ws[0]} {xdt}"
        ops = conv_igemm.prepare(w, sc, of, x.dtype)
        t = {k: h.time_ms(fn) for k, fn in {
            "kernel": lambda: real_b5(x, ops, stride=st, pads=pads, activation=act),
            "plain": lambda: conv_igemm.conv2d_igemm_reference(x, w, sc, of, st, pads, act),
            "library": h.conv_yardstick(x, w.to(dt), sc, of, pads, act, dt)}.items()}
        n, hh, ww, c = xs
        kh, kw, _, o = ws
        ho, wo = hh + pads[0] + pads[1] - kh + 1, ww + pads[2] + pads[3] - kw + 1
        flops = 2.0 * n * ho * wo * kh * kw * c * o
        nbytes = x.numel() * x.element_size() + n * ho * wo * o * x.element_size() \
            + w.numel() * w.element_size() + 8 * o
        b_ms, b_by = h.bound(flops, nbytes, dt)
        b3, b3_text = h.tf32(flops, nbytes, dt)
        out["timing"][label] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                    library_ms=t["library"], bound_ms=b_ms, bound_by=b_by, **b3)
        log(f"[timing] conv2d_kernel_nhwc pipeline {label}: kernel {t['kernel']:.4f} ms plain "
            f"{t['plain']:.4f} ms cudnn {t['library']:.4f} ms bound {b_ms:.5f} ms ({b_by}; "
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB{b3_text}) | {card}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[pipeline] phase {out['seconds']:.1f} s; launches {out['launches']} | {card}")
    return out

if __name__ == "__main__":
    sys.exit(main())
