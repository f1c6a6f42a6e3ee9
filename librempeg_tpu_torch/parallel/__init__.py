"""parallel layer of the port: meshes of shards, halo exchange, the
batched transcode step and its sharded form (see mesh.py for the device
model)."""
from librempeg_tpu_torch.parallel.mesh import (
    factor2,
    frame_sharding,
    make_mesh,
    replicated,
)
from librempeg_tpu_torch.parallel.pipeline import (
    make_sharded_step,
    transcode_step,
)

__all__ = ["factor2", "frame_sharding", "make_mesh", "replicated",
           "make_sharded_step", "transcode_step"]
