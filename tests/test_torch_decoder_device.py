"""Every decoder of the port runs on the card unless the caller asks for
the CPU (the port's device policy, librempeg_tpu_torch/device.py).

Each decoder in the port's registry is built through find_decoder with
no device: on a machine without a card that is a CUDA request, and it
must raise rather than return host frames. This holds the three host
video decoders that defaulted to numpy planes (HEVC, MPEG-1/2, MPEG-4)
to "cuda" like the rest, and covers the audio decoders (FLAC, AC-3,
MP2, MP3, Opus, Vorbis, the three ADPCM codecs). With device="cpu" each
builds. On a machine with a card the default builds on it.
"""
import pytest
import torch

import librempeg_tpu_torch.codecs.registry  # noqa: F401
from librempeg_tpu_torch.codecs.api import decoders, find_decoder
from librempeg_tpu_torch.formats.api import CodecParameters

NAMES = sorted(decoders())


def params(name):
    kind = find_decoder(name).INFO.codec_type
    return CodecParameters(codec_type=kind, codec_id=name, width=64,
                           height=64, pix_fmt="yuv420p", sample_rate=48000,
                           nb_channels=2, block_align=1024)


def test_the_registry_holds_every_decoder():
    assert {"h264", "hevc", "mpeg2video", "mpeg4", "mjpeg", "png",
            "rawvideo", "aac", "pcm_s16le", "flac", "ac3", "mp2", "mp3",
            "opus", "vorbis", "adpcm_ima_wav", "adpcm_ms",
            "adpcm_yamaha"} <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_decoder_defaults_to_the_card(name):
    cls = find_decoder(name)
    if torch.cuda.is_available():
        cls(params(name))
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            cls(params(name))
    cls(params(name), device="cpu")
