"""core layer of the port (see the package docstring): frames, packets,
rational time, formats, options, logging. Exports the names
librempeg_tpu/core/__init__.py exports."""
from librempeg_tpu_torch.core.rational import (  # noqa: F401
    NOPTS,
    Rational,
    Rounding,
    compare_ts,
    rescale,
    rescale_q,
    rescale_q_rnd,
    rescale_rnd,
)
from librempeg_tpu_torch.core.errors import (  # noqa: F401
    EndOfStream,
    InvalidData,
    MediaError,
    NotFound,
    TryAgain,
    Unsupported,
)
from librempeg_tpu_torch.core.frame import (  # noqa: F401
    AudioFrame,
    VideoFrame,
    stack_video,
    unstack_video,
)
from librempeg_tpu_torch.core.packet import Packet, PktFlags  # noqa: F401
from librempeg_tpu_torch.core import pixfmt, samplefmt  # noqa: F401
from librempeg_tpu_torch.core.options import (  # noqa: F401
    Option,
    OptionTable,
    OptionedObject,
    parse_opt_string,
)
