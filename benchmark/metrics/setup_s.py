"""Process start to the first measured frame: imports, CUDA, the kernels'
build (first run in a checkout), the artifact, the warm-up."""


def read(rec):
    return rec.setup_s
