"""Filter layer of the port (libavfilter analog): the filter graph with
negotiation and framesync, the video filters (null, scale, format, crop,
pad, hflip, vflip, transpose, fps, trim, setpts, overlay, split), the
metrics (psnr, ssim) and the audio filters (anull, aformat, aresample,
volume, atrim)."""
from librempeg_tpu_torch.filters.filter import (  # noqa: F401
    Filter,
    SourceFilter,
    StreamProps,
    filters,
    find_filter,
    register_filter,
)
from librempeg_tpu_torch.filters.graph import (  # noqa: F401
    BufferSink,
    BufferSource,
    FilterGraph,
    GraphRunner,
)
from librempeg_tpu_torch.filters.parser import parse_description  # noqa: F401
