"""RIFF/WAVE format tags (the tables the AVI muxer maps audio codecs
through; the WAV container itself is not part of the port)."""
from __future__ import annotations

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
WAVE_FORMAT_ADPCM_MS = 0x0002
WAVE_FORMAT_ADPCM_IMA = 0x0011
WAVE_FORMAT_ADPCM_YAMAHA = 0x0020

_TAG_TO_CODEC = {
    (WAVE_FORMAT_PCM, 8): "pcm_u8",
    (WAVE_FORMAT_PCM, 16): "pcm_s16le",
    (WAVE_FORMAT_PCM, 24): "pcm_s24le",
    (WAVE_FORMAT_PCM, 32): "pcm_s32le",
    (WAVE_FORMAT_IEEE_FLOAT, 32): "pcm_f32le",
    (WAVE_FORMAT_IEEE_FLOAT, 64): "pcm_f64le",
    (WAVE_FORMAT_ALAW, 8): "pcm_alaw",
    (WAVE_FORMAT_MULAW, 8): "pcm_mulaw",
    (WAVE_FORMAT_ADPCM_MS, 4): "adpcm_ms",
    (WAVE_FORMAT_ADPCM_IMA, 4): "adpcm_ima_wav",
    (WAVE_FORMAT_ADPCM_YAMAHA, 4): "adpcm_yamaha",
}

_ADPCM_CODECS = ("adpcm_ms", "adpcm_ima_wav", "adpcm_yamaha")

_CODEC_TO_TAG = {
    "pcm_u8": (WAVE_FORMAT_PCM, 8),
    "pcm_s16le": (WAVE_FORMAT_PCM, 16),
    "pcm_s24le": (WAVE_FORMAT_PCM, 24),
    "pcm_s32le": (WAVE_FORMAT_PCM, 32),
    "pcm_f32le": (WAVE_FORMAT_IEEE_FLOAT, 32),
    "pcm_f64le": (WAVE_FORMAT_IEEE_FLOAT, 64),
    "pcm_alaw": (WAVE_FORMAT_ALAW, 8),
    "pcm_mulaw": (WAVE_FORMAT_MULAW, 8),
    "adpcm_ms": (WAVE_FORMAT_ADPCM_MS, 4),
    "adpcm_ima_wav": (WAVE_FORMAT_ADPCM_IMA, 4),
    "adpcm_yamaha": (WAVE_FORMAT_ADPCM_YAMAHA, 4),
}
