"""Filter layer of the port (libavfilter analog): null/scale chains."""
from librempeg_tpu_torch.filters.filter import (  # noqa: F401
    Filter,
    StreamProps,
    find_filter,
    register_filter,
)
from librempeg_tpu_torch.filters.graph import GraphRunner  # noqa: F401
