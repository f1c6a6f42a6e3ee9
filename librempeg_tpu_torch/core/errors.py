"""Error/status signaling for the push/pull codec and filter APIs.

The reference communicates flow control via errno-style returns
(AVERROR(EAGAIN), AVERROR_EOF — usage contract at
libavcodec/avcodec.h:95-151). In Python we use a small
exception pair with the same semantics:

* ``TryAgain``  — the component needs more input (or output must be drained)
                  before this call can succeed; retry after feeding/draining.
* ``EndOfStream`` — the stream is fully flushed; no more data will appear.

Both are cheap, contain no tracebacks of interest, and are part of the
public API contract of send_packet/receive_frame/read_frame etc.
"""
from __future__ import annotations


class MediaError(Exception):
    """Base class for framework errors."""


class TryAgain(MediaError):
    """AVERROR(EAGAIN): operation can't complete now; feed/drain and retry."""


class EndOfStream(MediaError):
    """AVERROR_EOF: no more data in this direction."""


class InvalidData(MediaError):
    """AVERROR_INVALIDDATA: corrupt or unparseable input."""


class NotFound(MediaError):
    """Decoder/demuxer/filter/stream not found."""


class Unsupported(MediaError):
    """Feature understood but not implemented (yet)."""
