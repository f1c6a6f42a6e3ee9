"""Filter layer of the port (libavfilter analog): linear video chains
(null, scale, format) and audio chains (anull, aformat, aresample,
volume, atrim)."""
from librempeg_tpu_torch.filters.filter import (  # noqa: F401
    Filter,
    StreamProps,
    find_filter,
    register_filter,
)
from librempeg_tpu_torch.filters.graph import GraphRunner  # noqa: F401
