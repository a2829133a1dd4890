"""Hand-written CUDA kernels of the port (sources in ../csrc), each with a
plain PyTorch version beside it."""
