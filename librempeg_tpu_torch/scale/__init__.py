"""Video scaling and pixel-format conversion (libswscale analog)."""
from librempeg_tpu_torch.scale.scaler import Scaler, get_scaler  # noqa: F401
