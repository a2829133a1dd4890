"""ShaderNN-TPU ported to PyTorch and CUDA (one NVIDIA H100).

The JAX package `shadernn_tpu` stays the reference; this package imports
`torch` and numpy, never `jax` and nothing of `shadernn_tpu`. Plain tensor
code is PyTorch; the hot conv chains run on a hand-written CUDA kernel
(csrc/conv_chain.cu, built with nvcc at first use). Entry points run on
the card unless `EngineOptions(device="cpu")` asks for the CPU, where each
kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision  # noqa: F401
from shadernn_tpu_torch.engine.engine import Engine  # noqa: F401
from shadernn_tpu_torch.engine.processor import InferenceProcessor  # noqa: F401
from shadernn_tpu_torch.graph.ir import Graph, Node, TensorSpec  # noqa: F401
from shadernn_tpu_torch.models.zoo import build_model, list_models  # noqa: F401
