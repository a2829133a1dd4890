from shadernn_tpu_torch.utils.logging import get_logger, log_every_n_sec, log_first_n  # noqa: F401
from shadernn_tpu_torch.utils.timer import Timer, TimingStats  # noqa: F401
