"""aresample's dither_method after a float decoder (the port's own
option: the JAX package's aresample has none).

The encoder's integer sample format is negotiated onto the dithering
aresample (GraphRunner's sample_fmt): its input is converted to that
format, as an aformat in front would, and its Swr requantises the
resampled samples through the ditherer (the noise shaper for
lipshitz). On the committed Opus stream (fltp), 1 s to pcm_s16le at
44.1 kHz: lipshitz now changes the bytes, and they equal the run with
an explicit aformat=sample_fmts=s16p in front; dither_method=none is
the undithered conversion as before; a dither_method before a float
encoder (aac) is refused. The md5s are of the written WAV files.
"""
import hashlib
import os

import pytest

from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.core.errors import Unsupported

OPUS = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                    "acodecs", "opus_hybrid.ogg")
CHAINS = {
    "none": "aresample=44100",
    "lipshitz": "aresample=44100:dither_method=lipshitz",
    "aformat": "aformat=sample_fmts=s16p,aresample=44100:"
               "dither_method=lipshitz",
}


@pytest.fixture(scope="module")
def md5s(tmp_path_factory):
    td = tmp_path_factory.mktemp("dither")
    out = {}
    for name, af in CHAINS.items():
        path = str(td / f"{name}.wav")
        assert tmain(["-i", OPUS, "-t", "1", "-af", af, "-c:a", "pcm_s16le",
                      "-device", "cpu", "-y", path]) == 0
        with open(path, "rb") as f:
            out[name] = hashlib.md5(f.read()).hexdigest()
    return out


def test_dither_changes_the_bytes_as_an_explicit_aformat(md5s):
    assert md5s["lipshitz"] != md5s["none"]
    assert md5s["lipshitz"] == md5s["aformat"] == \
        "64990fe2291439bceba6651bc329abd2"


def test_dither_none_is_unchanged(md5s):
    assert md5s["none"] == "f259afde729364c9125a404ec272669d"


def test_dither_without_an_integer_format_raises(tmp_path):
    with pytest.raises(Unsupported, match="dither_method=lipshitz"):
        tmain(["-i", OPUS, "-t", "0.1", "-af", CHAINS["lipshitz"], "-c:a",
               "aac", "-device", "cpu", "-y", str(tmp_path / "o.aac")])
