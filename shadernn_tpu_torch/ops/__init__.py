"""Operator library of the port.

Each op registers a shape function and a compute body on NHWC tensors
(plain PyTorch); the conv chains, single convs and inverted-residual
blocks that the compile step plans run on the hand-written CUDA kernels in
shadernn_tpu_torch/kernels instead.
"""

# Import op modules for registration side effects.
from shadernn_tpu_torch.ops import registry  # noqa: F401
from shadernn_tpu_torch.ops import (  # noqa: F401
    conv, dense, elementwise, normalize, pool, shape_ops, yolo,
)

get_op = registry.get_op
