"""Codec registry of the port (allcodecs.c analog): importing this
registers the port's decoders and encoders.

Port of librempeg_tpu/codecs/registry.py, cut to the codecs the port
has. Imports are explicit and failures are loud: a broken codec module
(or a stale native build) fails the caller, never silently shrinks the
codec set. There is no lenient mode.
"""
import importlib

_MODULES = (
    "librempeg_tpu_torch.codecs.pcm",
    "librempeg_tpu_torch.codecs.adpcm",
    "librempeg_tpu_torch.codecs.ac3.decoder",
    "librempeg_tpu_torch.codecs.ac3.encoder",
    "librempeg_tpu_torch.codecs.mpegaudio",
    "librempeg_tpu_torch.codecs.mp3dec",
    "librempeg_tpu_torch.codecs.vorbis.decoder",
    "librempeg_tpu_torch.codecs.opus.codec",
    "librempeg_tpu_torch.codecs.rawvideo",
    "librempeg_tpu_torch.codecs.jpeg.decoder",
    "librempeg_tpu_torch.codecs.jpeg.encoder",
    "librempeg_tpu_torch.codecs.mpeg4.encoder",
    "librempeg_tpu_torch.codecs.mpeg4._decoder",
    "librempeg_tpu_torch.codecs.aac.codec",
    "librempeg_tpu_torch.codecs.aac.decoder",
    "librempeg_tpu_torch.codecs.h264.codec",
    "librempeg_tpu_torch.codecs.mpeg12.decoder",
    "librempeg_tpu_torch.codecs.mpeg12.encoder",
    "librempeg_tpu_torch.codecs.hevc.decoder",
    "librempeg_tpu_torch.codecs.png.codec",
    "librempeg_tpu_torch.codecs.gif",
    "librempeg_tpu_torch.codecs.flac.codec",
    "librempeg_tpu_torch.codecs.subtitles",
)

for _mod in _MODULES:
    importlib.import_module(_mod)
