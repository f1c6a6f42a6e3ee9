"""Container registry (allformats.c analog): importing this module
registers every demuxer and muxer the port has.

The list mirrors librempeg_tpu/formats/registry.py, cut to the port's
modules. There is no lenient mode: a module that fails to import is an
error, so a missing container never hides behind a warning.
"""
import importlib

_MODULES = (
    "librempeg_tpu_torch.formats.wav",
    "librempeg_tpu_torch.formats.rawvideo",
    "librempeg_tpu_torch.formats.rawes",
    "librempeg_tpu_torch.formats.lavfi",
    "librempeg_tpu_torch.formats.ogg",
    "librempeg_tpu_torch.formats.hls",
    "librempeg_tpu_torch.formats.rtp",
    "librempeg_tpu_torch.formats.rtsp",
    "librempeg_tpu_torch.formats.hlsdemux",
    "librempeg_tpu_torch.formats.adts",
    "librempeg_tpu_torch.formats.yuv4mpeg",
    "librempeg_tpu_torch.formats.image2",
    "librempeg_tpu_torch.formats.framehash",
    "librempeg_tpu_torch.formats.rawaudio",
    "librempeg_tpu_torch.formats.avi",
    "librempeg_tpu_torch.formats.matroska",
    "librempeg_tpu_torch.formats.mov",
    "librempeg_tpu_torch.formats.flac",
    "librempeg_tpu_torch.formats.mpegts",
    "librempeg_tpu_torch.formats.srt",
    "librempeg_tpu_torch.formats.gif",
    "librempeg_tpu_torch.formats.mp3",
    "librempeg_tpu_torch.formats.flv",
    "librempeg_tpu_torch.formats.ac3",
    # protocols registered on import
    "librempeg_tpu_torch.formats.http",
)

for _mod in _MODULES:
    importlib.import_module(_mod)
