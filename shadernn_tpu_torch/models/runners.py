"""Per-model runners (counterpart of shadernn_tpu/models/runners.py): the
reference's run{ESPCN,Resnet18,...} functions as data-driven configs
(input geometry and preprocessing) and one `run_model` entry point.

`run_model` runs an image (`image_path`, loaded and preprocessed at the
runner's geometry) or a seeded frame through `Engine.benchmark` and the
model's postprocess; with `dump_dir`, it also writes every layer's output
there (tools/dump_reader.py, the JAX package's layout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision, ShardingOptions
from shadernn_tpu_torch.engine.engine import Engine
from shadernn_tpu_torch.image.image import load_and_preprocess
from shadernn_tpu_torch.models.zoo import STYLES, build_model


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    model: str
    height: int
    width: int
    channels: int
    model_type: str = "other"  # other | classification | detection
    means: Tuple[float, ...] = (0.0,)
    norms: Tuple[float, ...] = (1.0,)
    luma_only: bool = False
    build_kwargs: dict = dataclasses.field(default_factory=dict)


# Input geometries of the reference runners: ESPCN 540p luma; ResNet18
# CIFAR 32x32; StyleTransfer 224; U-Net 256; YOLOv3-tiny 416; the
# denoisers 1080x1920 luma.
RUNNERS = {
    "espcn": RunnerConfig(
        "espcn", 540, 960, 1, means=(0.0,), norms=(1.0,), luma_only=True,
    ),
    "resnet18": RunnerConfig(
        "resnet18", 32, 32, 3, model_type="classification",
        means=(0.4914 * 255, 0.4822 * 255, 0.4465 * 255),
        norms=(1 / (0.2470 * 255), 1 / (0.2435 * 255), 1 / (0.2616 * 255)),
    ),
    "mobilenetv2": RunnerConfig(
        "mobilenetv2", 224, 224, 3, model_type="classification",
        means=(127.5, 127.5, 127.5), norms=(1 / 127.5,) * 3,
    ),
    "styletransfer": RunnerConfig(
        "styletransfer", 224, 224, 3, means=(0.0,), norms=(1.0,),
    ),
    "unet": RunnerConfig(
        "unet", 256, 256, 1, means=(0.0,), norms=(1 / 255.0,), luma_only=True,
    ),
    "yolov3-tiny": RunnerConfig(
        "yolov3-tiny", 416, 416, 3, model_type="detection",
        means=(0.0,), norms=(1 / 255.0,),
    ),
    "spatialdenoise": RunnerConfig(
        "spatialdenoise", 1080, 1920, 1, means=(0.0,), norms=(1 / 255.0,),
        luma_only=True,
    ),
    "aidenoise": RunnerConfig(
        "aidenoise", 1080, 1920, 1, means=(0.0,), norms=(1 / 255.0,),
        luma_only=True,
    ),
}
# The per-style models share the styletransfer runner's geometry.
for _style in STYLES:
    RUNNERS[f"styletransfer-{_style}"] = RunnerConfig(
        f"styletransfer-{_style}", 224, 224, 3, means=(0.0,), norms=(1.0,),
    )


def make_engine(
    name: str,
    precision: Precision = Precision.BF16,
    backend: BackendKind = BackendKind.AUTO,
    batch_size: int = 1,
    model_path: Optional[str] = None,
    device: str = "cuda",
    mesh=None,
) -> Engine:
    """The runner's engine: its model built at the runner's geometry, or
    the artifact at `model_path`; sharded over `mesh` (parallel/mesh.py)
    along its (data, model, spatial) shape where one is given."""
    cfg = RUNNERS[name]
    sharding = ShardingOptions()
    if mesh is not None:
        sharding = ShardingOptions(**mesh.shape)
        device = mesh.device_type
    options = EngineOptions(precision=precision, backend=backend, batch_size=batch_size,
                            device=device, sharding=sharding)
    if model_path:
        return Engine.from_json(model_path, options, mesh=mesh)
    graph = build_model(cfg.model, h=cfg.height, w=cfg.width, channels=cfg.channels,
                        **cfg.build_kwargs)
    return Engine.from_graph(graph, options, mesh=mesh)


def run_model(
    name: str,
    image_path: Optional[str] = None,
    precision: Precision = Precision.BF16,
    backend: BackendKind = BackendKind.AUTO,
    batch_size: int = 1,
    inner_loops: int = 10,
    dump_dir: Optional[str] = None,
    device: str = "cuda",
    mesh=None,
) -> dict:
    """Load -> preprocess -> run -> postprocess, like the reference's
    processModel flow (modelInference.cpp:26-60), on the image at
    `image_path` or, without one, a seeded random frame (the reference unit
    tests' RandomMat pattern): the benchmark's statistics, the output shape,
    and the class index (classifiers) or the detections with a positive
    score of the first frame (detectors); with `mesh`, sharded over its
    devices; with `dump_dir`, under "dumps" the
    path of each layer's dump (<dump_dir>/<model>/<layer>.npy)."""
    cfg = RUNNERS[name]
    eng = make_engine(name, precision, backend, batch_size, device=device, mesh=mesh)
    if image_path:
        x = load_and_preprocess(image_path, cfg.height, cfg.width, cfg.means, cfg.norms,
                                luma_only=cfg.luma_only, batch=batch_size)
    else:
        x = np.random.default_rng(7767517).random(
            (batch_size, cfg.height, cfg.width, cfg.channels), dtype=np.float32)
    stats = eng.benchmark({eng.graph.input_names[0]: x}, loops=inner_loops)
    out = eng.run_single(x).float().cpu().numpy()
    result = {"stats": stats, "output_shape": tuple(out.shape)}
    if cfg.model_type == "classification":
        result["class_index"] = np.argmax(out, axis=-1)
    elif cfg.model_type == "detection":
        dets = out[0]
        result["detections"] = dets[dets[:, 1] > 0]
    if dump_dir:
        from shadernn_tpu_torch.tools.dump_reader import dump_layers

        result["dumps"] = dump_layers(eng, {eng.graph.input_names[0]: x}, dump_dir)
    return result
