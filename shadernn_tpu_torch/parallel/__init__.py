"""Multi-device execution of the port (counterpart of shadernn_tpu/parallel/):
meshes, the explicit SPMD executor, halo exchange, multi-process hosts and
the scaling harness."""
