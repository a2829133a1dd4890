"""Operator library of the port.

Each op registers a shape function and a compute body on NHWC tensors
(plain PyTorch); the conv chains that the compile step plans run on the
hand-written CUDA kernel in shadernn_tpu_torch/kernels instead.
"""

# Import op modules for registration side effects.
from shadernn_tpu_torch.ops import registry  # noqa: F401
from shadernn_tpu_torch.ops import conv, elementwise, shape_ops  # noqa: F401

get_op = registry.get_op
