"""The accuracy report (counterpart of shadernn_tpu/tools/accuracy_report.py):
the precision-delta table of every zoo model and the quality of every
trained artifact, with the headings and rows of docs/Accuracy.md.

Each zoo model runs one seeded input through AUTO engines at FP32, BF16
and INT8 (int8 weights); each trained artifact of the JAX package's
`models/artifacts/` (read, never written) is scored on held-out data of
its task at each precision: ESPCN's PSNR against the bilinear baseline,
the classifiers' top-1, the denoisers' and the styles' PSNR, YOLOv3-tiny's
mAP@0.5 through decode and NMS. On the card the AUTO engines launch the
hand-written kernels their plans name.

Differences from the JAX report: the ESPCN A8W8 row runs
`BackendKind.KERNEL` where the JAX report runs PALLAS (the chain's head
reads the frame from the InputLayer, so C1 of ROADMAP.md does not apply);
`--out` defaults to a git-ignored path, never docs/Accuracy.md; a row that
fails is written as FAILED, as in the JAX report, and `main` then returns
1 (the process exits non-zero) where the JAX report carries on silently.

Usage: python -m shadernn_tpu_torch.tools.accuracy_report [--out FILE]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import traceback
from typing import Dict, List

import numpy as np

from shadernn_tpu_torch.models.zoo import ARTIFACTS

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "accuracy", "Accuracy.md")

# Model -> (metric kind, extra builder kwargs for a tractable geometry)
ZOO_KINDS: Dict[str, tuple] = {
    "espcn": ("sr", {}),
    "styletransfer": ("sr", {}),
    "spatialdenoise": ("sr", {}),
    "aidenoise": ("sr", {}),
    "unet": ("sr", {"base_filters": 32}),
    "mobilenetv2": ("classification", {}),
    "resnet18": ("classification", {}),
    "yolov3-tiny": ("detection", {}),
}


def _options(precision, batch, device, **kw):
    from shadernn_tpu_torch.config import EngineOptions

    return EngineOptions(precision=precision, batch_size=batch, device=device, **kw)


def _run(eng, x) -> np.ndarray:
    return eng.run_single(x).float().cpu().numpy()


def measure_model(name: str, kind: str, log=print, device: str = "cuda",
                  **kwargs) -> Dict[str, dict]:
    """{"bf16": report, "int8": report}: utils/metrics.py
    precision_delta_report of each precision's engine against FP32's on one
    seeded input (PSNR for "sr" and "detection", top-1 agreement for
    "classification")."""
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.models.zoo import build_model
    from shadernn_tpu_torch.utils.metrics import precision_delta_report

    engines = {prec: Engine.from_graph(build_model(name, **kwargs), _options(prec, 1, device))
               for prec in (Precision.FP32, Precision.BF16, Precision.INT8)}
    fp32 = engines[Precision.FP32]
    in_name = fp32.graph.input_names[0]
    x = np.random.default_rng(0).random((1, *fp32.model.input_specs[in_name][1:]),
                                        dtype=np.float32)
    rkind = "classification" if kind == "classification" else "sr"
    rows = {}
    for prec, label in ((Precision.BF16, "bf16"), (Precision.INT8, "int8")):
        rep = precision_delta_report(fp32, engines[prec], {in_name: x}, kind=rkind)
        rows[label] = rep
        log(f"{name} {label}: {rep}")
    return rows


def trained_espcn_section(log=print, device: str = "cuda") -> list:
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.config import BackendKind
    from shadernn_tpu_torch.quant.calibrate import calibrate_activations
    from shadernn_tpu_torch.tools.train_espcn import bilinear_up2, downsample2, psnr, synth_hr

    art = os.path.join(ARTIFACTS, "espcn_2x_trained_layers.json")
    if not os.path.exists(art):
        return ["(trained artifact not built — run "
                "`python -m shadernn_tpu_torch.tools.train_espcn`)"]
    rng = np.random.default_rng(123)
    hr = synth_hr(rng, 4, 128)
    lr = downsample2(hr)
    c = 8
    crop = (slice(None), slice(c, -c), slice(c, -c))
    base = psnr(bilinear_up2(lr)[crop], hr[crop])
    lines = [
        "| output | PSNR vs ground truth (dB) |",
        "|---|---|",
        f"| bilinear 2x baseline | {base:.2f} |",
    ]
    for prec, label in ((Precision.FP32, "fp32"), (Precision.BF16, "bf16"),
                        (Precision.INT8, "int8 (weight-only)")):
        eng = Engine.from_json(art, _options(prec, 4, device), input_hw=(64, 64))
        p = psnr(_run(eng, lr)[crop], hr[crop])
        log(f"trained espcn {label}: {p:.2f} dB (bilinear {base:.2f})")
        lines.append(f"| trained ESPCN, {label} | {p:.2f} |")
    # A8W8: calibrate the activation scales and rebuild; the chain kernel
    # then runs its calibrated layers int8 x int8 (a8).
    opts = _options(Precision.INT8, 4, device, backend=BackendKind.KERNEL)
    eng = Engine.from_json(art, opts, input_hw=(64, 64))
    calibrate_activations(eng, [{eng.graph.input_names[0]: lr}], percentile=None)
    eng_a8 = Engine.from_graph(eng.graph, opts)
    p = psnr(_run(eng_a8, lr)[crop], hr[crop])
    log(f"trained espcn a8w8: {p:.2f} dB (bilinear {base:.2f})")
    lines.append(f"| trained ESPCN, int8 A8W8 (calibrated, chain_a8) | {p:.2f} |")
    return lines


def _top1(eng, x, y, batch=64) -> float:
    correct = 0
    for i in range(0, len(x), batch):
        correct += int((_run(eng, x[i:i + batch]).argmax(-1) == y[i:i + batch]).sum())
    return correct / len(x)


def trained_resnet18_section(log=print, device: str = "cuda") -> list:
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.tools.train_resnet18 import synth_cls

    art = os.path.join(ARTIFACTS, "resnet18_cls10_trained_layers.json")
    if not os.path.exists(art):
        return ["(trained artifact not built — run "
                "`python -m shadernn_tpu_torch.tools.train_resnet18`)"]
    x, y = synth_cls(np.random.default_rng(424242), 256)
    lines = ["| precision | held-out top-1 |", "|---|---|"]
    for prec, label in ((Precision.FP32, "fp32"), (Precision.BF16, "bf16"),
                        (Precision.INT8, "int8 (weight-only)")):
        acc = _top1(Engine.from_json(art, _options(prec, 64, device)), x, y)
        log(f"trained resnet18 {label}: top-1 {acc:.3f}")
        lines.append(f"| {label} | {acc:.3f} |")
    return lines


def trained_denoiser_section(log=print, device: str = "cuda") -> list:
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.tools.train_denoiser import noisy_pairs
    from shadernn_tpu_torch.tools.train_espcn import psnr

    x, y = noisy_pairs(np.random.default_rng(20260820), 8, 96)
    lines = [
        "| output | PSNR vs clean (dB) |", "|---|---|",
        f"| noisy input (identity baseline) | {psnr(x, y):.2f} |",
    ]
    for model, label_model in (("spatialdenoise", "SpatialDenoise"), ("unet", "U-Net"),
                               ("aidenoise", "AIDenoise")):
        art = os.path.join(ARTIFACTS, f"{model}_trained_layers.json")
        if not os.path.exists(art):
            lines.append(f"| {label_model} | (artifact not built) |")
            continue
        for prec, label in ((Precision.FP32, "fp32"), (Precision.BF16, "bf16"),
                            (Precision.INT8, "int8 (weight-only)")):
            eng = Engine.from_json(art, _options(prec, 8, device), input_hw=(96, 96))
            p = psnr(_run(eng, x), y)
            log(f"trained {model} {label}: {p:.2f} dB")
            lines.append(f"| trained {label_model}, {label} | {p:.2f} |")
    return lines


def trained_mobilenetv2_section(log=print, device: str = "cuda") -> list:
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.quant.calibrate import calibrate_activations
    from shadernn_tpu_torch.tools.train_resnet18 import synth_cls

    art = os.path.join(ARTIFACTS, "mobilenetv2_cls10_trained_layers.json")
    if not os.path.exists(art):
        return ["(trained artifact not built — run "
                "`python -m shadernn_tpu_torch.tools.train_mobilenetv2`)"]
    x, y = synth_cls(np.random.default_rng(424242), 256)
    lines = ["| precision | held-out top-1 |", "|---|---|"]
    for prec, label in ((Precision.FP32, "fp32"), (Precision.BF16, "bf16"),
                        (Precision.INT8, "int8 (weight-only)")):
        acc = _top1(Engine.from_json(art, _options(prec, 64, device)), x, y)
        log(f"trained mobilenetv2 {label}: top-1 {acc:.3f}")
        lines.append(f"| {label} | {acc:.3f} |")
    # A8W8: calibrate (stamps the activation scales on the graph), rebuild
    # from the same graph so that the scales engage, score again
    opts = _options(Precision.INT8, 64, device)
    eng = Engine.from_json(art, opts)
    cal_x, _ = synth_cls(np.random.default_rng(7), 64)
    calibrate_activations(eng, [{"input": cal_x}], percentile=None)
    acc = _top1(Engine.from_graph(eng.graph, opts), x, y)
    log(f"trained mobilenetv2 a8w8: top-1 {acc:.3f}")
    lines.append(f"| int8 A8W8 (calibrated activations) | {acc:.3f} |")
    return lines


def trained_styletransfer_section(log=print, device: str = "cuda") -> list:
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.tools.train_styletransfer import style_target, synth_imgs
    from shadernn_tpu_torch.utils.metrics import psnr

    lines = ["| artifact | eval | net PSNR vs target (dB) "
             "| identity baseline (dB) |", "|---|---|---|---|"]

    def row(art, label, s, style, n=4):
        if not os.path.exists(art):
            lines.append(f"| {label} | — | (artifact not built) | |")
            return
        # a fresh generator per row: every style is scored on the same
        # held-out images
        rng = np.random.default_rng(99)
        eng = Engine.from_json(art, _options(Precision.FP32, n, device), input_hw=(s, s))
        x = synth_imgs(rng, n, s=s)
        t = style_target(x, style=style)
        y = np.clip(_run(eng, x), 0, 1)
        net, ident = psnr(y, t), psnr(x, t)
        log(f"trained styletransfer {label}: net {net:.2f} id {ident:.2f}")
        lines.append(f"| {label} | {s}x{s} | {net:.2f} | {ident:.2f} |")

    row(os.path.join(ARTIFACTS, "styletransfer_trained_layers.json"),
        "candy-equivalent (64-trained)", 64, "candy", n=4)
    for style in ("candy", "mosaic", "pointilism", "rain-princess", "udnie"):
        row(os.path.join(ARTIFACTS, f"styletransfer_{style}512_trained_layers.json"),
            f"{style} (512-trained)", 512, style)
    return lines


def trained_yolo_section(log=print, device: str = "cuda") -> list:
    from shadernn_tpu_torch import Engine, Precision
    from shadernn_tpu_torch.tools.train_yolo import NUM_CLASSES, synth_scenes
    from shadernn_tpu_torch.utils.metrics import mean_average_precision

    art = os.path.join(ARTIFACTS, "yolov3_tiny_trained_layers.json")
    if not os.path.exists(art):
        return ["(trained artifact not built — run "
                "`python -m shadernn_tpu_torch.tools.train_yolo`)"]
    lines = ["| precision | mAP@0.5 (full pipeline: backbone -> decode -> "
             "NMS) |", "|---|---|"]
    rng = np.random.default_rng(424242)
    batches = [synth_scenes(rng, 8) for _ in range(2)]
    for prec, label in ((Precision.FP32, "fp32"), (Precision.BF16, "bf16")):
        eng = Engine.from_json(art, _options(prec, 8, device))
        dets, gts = [], []
        for x, gt in batches:
            out = _run(eng, x)
            for b in range(8):
                d = out[b]
                dets.append(d[d[:, 1] > 0])
                gts.append(gt[b])
        m = mean_average_precision(dets, gts, NUM_CLASSES)
        log(f"trained yolo {label}: mAP {m:.3f}")
        lines.append(f"| {label} | {m:.3f} |")
    return lines


def fmt(rep: dict) -> str:
    """One cell of the precision-delta table."""
    if "top1_agreement" in rep:
        return f"top1 agree {rep['top1_agreement']:.2f}, maxdiff {rep['max_abs_diff']:.2e}"
    if "psnr_db" in rep:
        return f"psnr {rep['psnr_db']:.1f} dB, maxdiff {rep['max_abs_diff']:.2e}"
    return f"maxdiff {rep['max_abs_diff']:.2e}"


def read_report(text: str) -> Dict[str, Dict[str, List[float]]]:
    """The report's tables: {section heading: {row label: the numbers of
    its other cells}}, for holding one report against another. A FAILED row
    has no numbers."""
    out: Dict[str, Dict[str, List[float]]] = {}
    section, body = None, False
    for line in text.splitlines():
        if line.startswith("## "):
            section = out.setdefault(line[3:].strip(), {})
        if not line.startswith("|"):
            body = False
        elif line.startswith("|---"):
            body = True  # the rows below a table's header
        elif body and section is not None:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            section[cells[0]] = [float(v) for c in cells[1:]
                                 for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", c)]
    return out


# Limits for holding a report against the JAX package's (docs/Accuracy.md,
# written on the CPU): each trained row within these of its row (PSNR in
# dB, top-1, mAP@0.5); each zoo row of an image model above the JAX
# package's gates (tests/test_accuracy_trained.py:90-91: bf16 PSNR > 35 dB,
# int8 > 30 dB against FP32) and each classifier's probabilities within the
# bf16 threshold (0.1) of FP32's. A classifier row's top-1 agreement on its
# one seeded image is not held: MobileNetV2's 1000 probabilities of about
# 1e-3 round to many equal bf16 values, and its argmax is a tie-break.
TRAINED_TOL = {"psnr": 0.1, "top1": 0.02, "map": 0.03}
ZOO_PSNR_GATES = (35.0, 30.0)
ZOO_PROB_TOL = 0.1


def check_against(got: str, want: str) -> List[str]:
    """What in report `got` breaks the limits above against report `want`
    (both as text): a missing or FAILED row, a trained row off by more than
    TRAINED_TOL, a zoo row under the gates. Empty when `got` holds."""
    g, w = read_report(got), read_report(want)
    bad = []
    for section, rows in w.items():
        zoo = section.startswith("Precision deltas")
        tol = (TRAINED_TOL["top1"] if "classifier" in section
               else TRAINED_TOL["map"] if "YOLO" in section else TRAINED_TOL["psnr"])
        for label, want_vals in rows.items():
            got_vals = g.get(section, {}).get(label)
            if not got_vals or len(got_vals) != len(want_vals):
                bad.append(f"{section} | {label}: {got_vals} (want {want_vals})")
            elif zoo and ZOO_KINDS.get(label, ("sr",))[0] == "classification":
                if max(got_vals[1], got_vals[3]) > ZOO_PROB_TOL:
                    bad.append(f"{section} | {label}: maxdiff {got_vals} > {ZOO_PROB_TOL}")
            elif zoo:
                if not (got_vals[0] > ZOO_PSNR_GATES[0] and got_vals[2] > ZOO_PSNR_GATES[1]):
                    bad.append(f"{section} | {label}: PSNR {got_vals[0]}, {got_vals[2]} "
                               f"under the gates {ZOO_PSNR_GATES}")
            elif max(abs(a - b) for a, b in zip(got_vals, want_vals)) > tol + 1e-9:
                bad.append(f"{section} | {label}: {got_vals} vs {want_vals} (tol {tol})")
    return bad


def main(argv=None) -> int:
    """Write the report to --out. Returns 0, or 1 where a zoo model's row
    failed (written as FAILED)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    lines = [
        "# Accuracy",
        "",
        "Generated by `python -m shadernn_tpu_torch.tools.accuracy_report`.",
        "",
        "## Trained ESPCN (real weights)",
        "",
        "Artifact `models/artifacts/espcn_2x_trained*` — trained in-repo by",
        "`tools/train_espcn.py` (reference arch, demo/modelInferenceESPCN.py),",
        "evaluated on held-out synthetic SR data, 8px border crop. The gate",
        "(tests/test_accuracy_trained.py): beat bilinear by >0.8 dB in fp32,",
        "match keras.predict, and keep bf16/int8 within the delta bounds.",
        "",
        *trained_espcn_section(device=dev),
        "",
        "## Trained ResNet18 classifier (real weights)",
        "",
        "Artifact `models/artifacts/resnet18_cls10_trained*`"
        " (tools/train_resnet18.py): the zoo topology at base_filters=16,",
        "trained on a procedural 10-class task; true held-out top-1"
        " (gates in tests/test_accuracy_resnet18.py).",
        "",
        *trained_resnet18_section(device=dev),
        "",
        "## Trained SpatialDenoise (real weights)",
        "",
        "Artifact `models/artifacts/spatialdenoise_trained*`"
        " (tools/train_denoiser.py): true denoising PSNR vs the noisy",
        "identity baseline (gates in tests/test_accuracy_denoiser.py).",
        "",
        *trained_denoiser_section(device=dev),
        "",
        "## Trained MobileNetV2 classifier (real weights)",
        "",
        "Artifact `models/artifacts/mobilenetv2_cls10_trained*`"
        " (tools/train_mobilenetv2.py, width 0.5): true held-out top-1 per",
        "precision, incl. calibrated A8W8 (gates in",
        "tests/test_accuracy_mobilenetv2.py).",
        "",
        *trained_mobilenetv2_section(device=dev),
        "",
        "## Trained StyleTransfer (real weights)",
        "",
        "Per-style artifacts (tools/train_styletransfer.py): output-vs-",
        "procedural-target PSNR on held-out images; the network must beat",
        "the identity mapping (gates in tests/test_accuracy_styletransfer",
        ".py). candy/mosaic are trained AND evaluated at 512x512 (BASELINE",
        "configs[1]) — the r4 finding: instance-norm statistics are",
        "content-scale dependent, so training runs at the serving scale.",
        "",
        *trained_styletransfer_section(device=dev),
        "",
        "## Trained YOLOv3-tiny detector (real weights)",
        "",
        "Artifact `models/artifacts/yolov3_tiny_trained*`"
        " (tools/train_yolo.py): true mAP@0.5 through the FULL pipeline",
        "(backbone -> decode -> NMS; gates in tests/test_accuracy_yolo.py).",
        "",
        *trained_yolo_section(device=dev),
        "",
        "## Precision deltas across the zoo (seeded weights)",
        "",
        "Same seeded input through fp32/bf16/int8 engines. `psnr_db` is",
        "agreement between the two precisions' outputs (not image quality);",
        "`top1_agreement` is classification label agreement.",
        "",
        "| model | bf16 vs fp32 | int8 vs fp32 |",
        "|---|---|---|",
    ]
    failed = []
    for name, (kind, kw) in ZOO_KINDS.items():
        try:
            rows = measure_model(name, kind, device=dev, **kw)
            lines.append(f"| {name} | {fmt(rows['bf16'])} | {fmt(rows['int8'])} |")
        except Exception as e:  # keep the report going; record the failure
            traceback.print_exc()
            lines.append(f"| {name} | FAILED: {type(e).__name__}: {e} | |")
            failed.append(name)

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}")
    if failed:
        print(f"FAILED rows: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    import logging

    logging.disable(logging.INFO)
    sys.exit(main())
