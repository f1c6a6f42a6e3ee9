"""ID3v2 metadata tags (read v2.2/v2.3/v2.4, write v2.3).

Analog of libavformat/id3v2.c (read) and
id3v2enc.c (write): text frames map to the same metadata keys the
reference uses (ff_id3v2_34_metadata_conv / ff_id3v2_4_metadata_conv).

A copy of librempeg_tpu/formats/id3v2.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

# frame-id -> metadata key (v2.3/2.4 four-char and v2.2 three-char)
_CONV_34 = {
    "TALB": "album", "TCOM": "composer", "TCON": "genre",
    "TCOP": "copyright", "TENC": "encoded_by", "TIT2": "title",
    "TLAN": "language", "TPE1": "artist", "TPE2": "album_artist",
    "TPE3": "performer", "TPOS": "disc", "TPUB": "publisher",
    "TRCK": "track", "TSSE": "encoder", "TYER": "date", "TDRC": "date",
    "TDRL": "date", "TIT1": "grouping", "TSOA": "album-sort",
    "TSOP": "artist-sort", "TSOT": "title-sort",
}
_CONV_22 = {
    "TAL": "album", "TCO": "genre", "TCP": "compilation",
    "TT2": "title", "TEN": "encoded_by", "TP1": "artist",
    "TP2": "album_artist", "TRK": "track", "TYE": "date",
}
_KEY_TO_ID3 = {v: k for k, v in _CONV_34.items() if k != "TDRC"}


def syncsafe(v: int) -> int:
    return ((v & 0x7F000000) >> 3) | ((v & 0x7F0000) >> 2) \
        | ((v & 0x7F00) >> 1) | (v & 0x7F)


def to_syncsafe(v: int) -> bytes:
    return bytes([(v >> 21) & 0x7F, (v >> 14) & 0x7F,
                  (v >> 7) & 0x7F, v & 0x7F])


def _decode_text(data: bytes) -> str:
    if not data:
        return ""
    enc = data[0]
    body = data[1:]
    try:
        if enc == 0:
            return body.decode("latin-1").rstrip("\x00")
        if enc == 1:
            return body.decode("utf-16").rstrip("\x00")
        if enc == 2:
            return body.decode("utf-16-be").rstrip("\x00")
        return body.decode("utf-8").rstrip("\x00")
    except UnicodeDecodeError:
        return body.decode("latin-1", "replace").rstrip("\x00")


def parse(io) -> dict[str, str]:
    """Parse an ID3v2 tag at the current position (or return {} if none);
    leaves the stream positioned after the tag."""
    head = io.peek(10)
    if len(head) < 10 or head[:3] != b"ID3":
        return {}
    ver = head[3]
    flags = head[5]
    size = syncsafe(struct.unpack(">I", head[6:10])[0])
    io.skip(10)
    body = io.read(size)
    if flags & 0x40 and ver >= 3:          # extended header
        if ver == 3:
            ext = struct.unpack(">I", body[:4])[0] + 4
        else:
            ext = syncsafe(struct.unpack(">I", body[:4])[0])
        body = body[ext:]
    if flags & 0x80:                        # unsynchronization (whole tag)
        body = body.replace(b"\xff\x00", b"\xff")
    meta: dict[str, str] = {}
    pos = 0
    while pos + (6 if ver == 2 else 10) <= len(body):
        if ver == 2:
            fid = body[pos:pos + 3].decode("latin-1", "replace")
            fsz = struct.unpack(">I", b"\0" + body[pos + 3:pos + 6])[0]
            hdr_len = 6
            conv = _CONV_22
        else:
            fid = body[pos:pos + 4].decode("latin-1", "replace")
            raw = struct.unpack(">I", body[pos + 4:pos + 8])[0]
            fsz = syncsafe(raw) if ver >= 4 else raw
            hdr_len = 10
            conv = _CONV_34
        if not fid.strip("\x00").strip():
            break                            # padding
        frame = body[pos + hdr_len:pos + hdr_len + fsz]
        pos += hdr_len + fsz
        key = conv.get(fid)
        if key and frame:
            meta[key] = _decode_text(frame)
        elif fid in ("COMM", "COM") and len(frame) > 4:
            # enc(1) lang(3) short desc \0 text
            txt = frame[4:]
            z = txt.find(b"\x00")
            meta["comment"] = _decode_text(frame[:1] + txt[z + 1:])
    return meta


def write(metadata: dict[str, str]) -> bytes:
    """Serialize metadata to an ID3v2.3 tag (latin-1/utf-16 as needed)."""
    frames = b""
    for key, val in metadata.items():
        fid = _KEY_TO_ID3.get(key)
        if fid is None:
            fid = "TXXX" if key != "comment" else None
        if key == "comment":
            body = b"\x00engcomment\x00" + val.encode("latin-1", "replace")
            frames += b"COMM" + struct.pack(">I", len(body)) + b"\0\0" + body
            continue
        if fid == "TXXX":
            body = (b"\x00" + key.encode("latin-1", "replace") + b"\x00"
                    + val.encode("latin-1", "replace"))
        else:
            try:
                body = b"\x00" + val.encode("latin-1")
            except UnicodeEncodeError:
                body = b"\x01" + val.encode("utf-16")
        frames += fid.encode() + struct.pack(">I", len(body)) + b"\0\0" + body
    if not frames:
        return b""
    return b"ID3\x03\x00\x00" + to_syncsafe(len(frames)) + frames
