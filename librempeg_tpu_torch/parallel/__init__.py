"""parallel layer of the port: the batched transcode step."""
from librempeg_tpu_torch.parallel.pipeline import transcode_step

__all__ = ["transcode_step"]
