from shadernn_tpu_torch.utils.logging import get_logger  # noqa: F401
from shadernn_tpu_torch.utils.timer import ScopedTimer, Timer, TimingStats  # noqa: F401
