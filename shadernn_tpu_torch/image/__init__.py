from shadernn_tpu_torch.image.color import ColorFormat  # noqa: F401
from shadernn_tpu_torch.image.image import Image  # noqa: F401
from shadernn_tpu_torch.image.ingest import ingest_frames, make_ingest_fn  # noqa: F401
