"""Pipeline checkpoint/resume.

Port of librempeg_tpu/sched/checkpoint.py. `snapshot` captures a
running Transcoder between packets: the demuxer's resume position and
its scalar attributes, and each chain's encoder fields, resampler carry
and ditherer state; `restore` puts them into a fresh Transcoder made
from the same spec. The snapshot carries no decoder state but the
start skip an MPEG audio decoder still has to drop (an MP3's LAME tag
sets it on the packet at pts 0 only, so a resumed decode neither skips
again nor forgets what is left), so a video chain resumes exactly only
where the next packet is a keyframe that opens a closed GOP (an H.264
IDR), and an AC-3 decode resumes as a fresh decoder, its overlap at
zero and its dither generator at the seed, as after a -ss seek.

The format is data only (a JSON tree and an npz bundle of arrays,
loaded with allow_pickle=False), so restoring a tampered snapshot never
runs code. Tensors are fetched to numpy on save and uploaded to the
chains' device with their dtype on load.

Two states the JAX package's snapshot drops are carried here: the
ditherer's noise position, high-pass carry and shaper error history (a
resumed dithered output would restart its noise at sample 0), and a
demuxer's lists of ints (MP4's per-stream packet cursor; a resumed MP4
input would restart at its first packet).
"""
from __future__ import annotations

import io
import json
import struct
from typing import Any

import numpy as np
import torch

from librempeg_tpu_torch.device import resolve

_MAGIC = b"LTTORCHCKPT1\n"
_JAX_MAGIC = b"LTCKPT1\n"

#: encoder fields a snapshot carries (MPEG-4: reference recon, frame
#: index, next pts; AAC: MDCT overlap, pending samples, frame count)
_ENCODER_ATTRS = ("_ref", "_frame_idx", "_next_pts", "_frame_no", "_pend",
                  "_hist", "_total", "_total_in")
#: encoders whose state the snapshot does not capture (H.264's GOP,
#: frame_num and B-frame queue; MPEG-1/2's GOP index): a snapshot of a
#: chain that encodes to them would not resume, so it is refused
_UNCOVERED_ENCODERS = ("h264", "mpeg1video", "mpeg2video")
_RESAMPLER_ATTRS = ("_buf", "_buf_start", "_next_origin", "_out_count",
                    "_total_in", "_keep")
_DITHER_ATTRS = ("_pos", "_hp_last", "_err")
#: decoder fields a snapshot carries (MPEG audio: the start skip of a
#: LAME tag still to drop, which only the packet at pts 0 sets)
_DECODER_ATTRS = ("_pending_skip",)


def _encode(obj: Any, arrays: list) -> Any:
    """Lower a state tree to a JSON-safe tree; arrays go to `arrays`."""
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        arrays.append(obj.detach().cpu().numpy())
        return {"__tensor__": len(arrays) - 1}
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"__nd__": len(arrays) - 1}
    if isinstance(obj, tuple):
        return {"__tup__": [_encode(o, arrays) for o in obj]}
    if isinstance(obj, list):
        return [_encode(o, arrays) for o in obj]
    if isinstance(obj, dict):
        return {"__map__": [[_encode(k, arrays), _encode(v, arrays)]
                            for k, v in obj.items()]}
    if isinstance(obj, bytes):
        arrays.append(np.frombuffer(obj, np.uint8))
        return {"__bytes__": len(arrays) - 1}
    raise TypeError(f"checkpoint: unsupported state type {type(obj)!r}")


def _decode(obj: Any, arrays: dict, device) -> Any:
    if isinstance(obj, list):
        return [_decode(o, arrays, device) for o in obj]
    if isinstance(obj, dict):
        if "__tensor__" in obj:
            return torch.from_numpy(arrays[f"a{obj['__tensor__']}"]).to(device)
        if "__nd__" in obj:
            return arrays[f"a{obj['__nd__']}"]
        if "__bytes__" in obj:
            return arrays[f"a{obj['__bytes__']}"].tobytes()
        if "__tup__" in obj:
            return tuple(_decode(o, arrays, device) for o in obj["__tup__"])
        if "__map__" in obj:
            return {_decode(k, arrays, device): _decode(v, arrays, device)
                    for k, v in obj["__map__"]}
        raise ValueError("checkpoint: malformed node")
    return obj


def dumps_state(state: Any) -> bytes:
    arrays: list = []
    tree = json.dumps(_encode(state, arrays)).encode()
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
    return _MAGIC + struct.pack("<Q", len(tree)) + tree + buf.getvalue()


def loads_state(blob: bytes, device="cuda") -> Any:
    """Parse a snapshot; its tensors come back on `device` (the card
    unless the caller names another; without one it raises)."""
    device = resolve(device)
    if blob.startswith(_JAX_MAGIC):
        raise ValueError("checkpoint: a JAX package snapshot (LTCKPT1); "
                         "its state does not resume in this package")
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError("checkpoint: bad magic (not a snapshot of this "
                         "package)")
    off = len(_MAGIC)
    (tlen,) = struct.unpack_from("<Q", blob, off)
    off += 8
    tree = json.loads(blob[off:off + tlen].decode())
    arrays: dict = {}
    npz_bytes = blob[off + tlen:]
    if npz_bytes:
        with np.load(io.BytesIO(npz_bytes), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    return _decode(tree, arrays, device)


def _graph_nodes(chain) -> list:
    """The nodes of the chain's filter graph (none for a stream copy)."""
    graph = getattr(chain, "graph", None)
    return graph.graph.nodes if graph is not None else []


def _swr_state(swr) -> dict | None:
    if swr is None:
        return None
    state: dict[str, Any] = {}
    r = swr.resampler
    if r is not None:
        state["resampler"] = {a: getattr(r, a) for a in _RESAMPLER_ATTRS}
        if r._comp is not None:
            # the bank is rebuilt on restore from its rational
            state["resampler"]["_comp_pqr"] = (
                r._comp["p"], r._comp["q"], r._comp["remaining"])
    d = swr._ditherer
    if d is not None:
        state["ditherer"] = {a: getattr(d, a) for a in _DITHER_ATTRS}
    return state


def _int_list(v) -> bool:
    return isinstance(v, list) and all(
        isinstance(x, int) and not isinstance(x, bool) for x in v)


def snapshot(tc) -> bytes:
    """Capture a resumable snapshot of a Transcoder between packets.

    Each chain is drained first. A video chain's frames its decoder
    holds ahead (the H.264 decode-ahead queue on the card) go through
    the graph and the encoder, and the encode worker packs and muxes
    every dispatched frame; an audio chain writes the packet its encoder
    holds back (FLAC's newest). Only then are the encoder's fields read,
    so the snapshot covers every packet the demuxer has given out."""
    for idx, chain in tc.chains.items():
        enc = getattr(chain, "encoder", None)
        if enc is not None and enc.INFO.name in _UNCOVERED_ENCODERS:
            raise NotImplementedError(
                f"snapshot: stream {idx} encodes to {enc.INFO.name}, whose "
                "encoder state a snapshot does not hold")
    chains = {}
    for idx, chain in tc.chains.items():
        if hasattr(chain, "drain"):
            chain.drain(tc.mux)
        if hasattr(chain, "sync"):
            chain.sync()
        state: dict[str, Any] = {"frames_done": chain.frames_done}
        dec = getattr(chain, "decoder", None)
        if dec is not None:
            state["decoder"] = {a: getattr(dec, a) for a in _DECODER_ATTRS
                                if hasattr(dec, a)}
        enc = getattr(chain, "encoder", None)
        if enc is not None:
            state["encoder"] = {a: getattr(enc, a) for a in _ENCODER_ATTRS
                                if hasattr(enc, a)}
        state["swr"] = [_swr_state(getattr(n.filter, "_swr", None))
                        for n in _graph_nodes(chain)]
        chains[idx] = state
    # demuxer state: scalars (packet counters, offsets) and lists of
    # ints (per-stream cursors)
    demux_attrs = {k: v for k, v in vars(tc.demux).items()
                   if isinstance(v, (int, float, bool)) or _int_list(v)}
    return dumps_state({
        "demux_pos": tc.demux.tell_resume(),
        "demux_attrs": demux_attrs,
        "chains": chains,
    })


def _restore_swr(swr, state: dict) -> None:
    from librempeg_tpu_torch.resample.resampler import _bank_matrix

    rs = dict(state.get("resampler") or {})
    if rs and swr.resampler is not None:
        r = swr.resampler
        pqr = rs.pop("_comp_pqr", None)
        for attr, val in rs.items():
            setattr(r, attr, val)
        r._comp = None
        if pqr is not None:
            p2, q2, rem = pqr
            m2, L2, lp2 = _bank_matrix(
                p2, q2, r.taps, int(r._cutoff * 1e6),
                int(r.opts["kaiser_beta"] * 10), r.opts["window"])
            r._comp = {"m": torch.from_numpy(m2).to(r.device), "p": p2,
                       "q": q2, "L": L2, "lp": lp2, "remaining": rem}
    ds = state.get("ditherer")
    if ds and swr._ditherer is not None:
        for attr, val in ds.items():
            setattr(swr._ditherer, attr, val)


def restore(tc, blob: bytes) -> None:
    """Restore a snapshot into a freshly constructed Transcoder with the
    same spec. A chain's filters build their Swr on their first frame,
    so the Swr a snapshot names is built here, on the chain's device,
    from the frame format the graph negotiated."""
    device = resolve(tc.spec.device)
    state = loads_state(blob, device)
    tc.demux.io.seek(state["demux_pos"])
    for k, v in state.get("demux_attrs", {}).items():
        setattr(tc.demux, k, v)
    tc.demux.on_restore()  # drop read-ahead so reading resumes at the seek
    for idx, chst in state["chains"].items():
        chain = tc.chains.get(idx)
        if chain is None:
            continue
        chain.frames_done = chst["frames_done"]
        dec = getattr(chain, "decoder", None)
        for attr, val in chst.get("decoder", {}).items():
            setattr(dec, attr, val)
        enc = getattr(chain, "encoder", None)
        if enc is not None:
            for attr, val in chst.get("encoder", {}).items():
                setattr(enc, attr, val)
        for node, sw in zip(_graph_nodes(chain), chst.get("swr", [])):
            if sw is None:
                continue
            f = node.filter
            if f._swr is None:
                from librempeg_tpu_torch.resample import Swr

                f._swr = Swr(device=device, **f._swr_args)
            _restore_swr(f._swr, sw)
