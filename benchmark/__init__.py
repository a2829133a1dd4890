"""The benchmark of shadernn_tpu_torch on NVIDIA GPUs (`python3 benchmark/run.py`)."""
