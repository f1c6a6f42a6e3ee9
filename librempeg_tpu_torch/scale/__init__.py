"""Video scaling (libswscale analog): the planar YUV path."""
from librempeg_tpu_torch.scale.scaler import Scaler, get_scaler  # noqa: F401
