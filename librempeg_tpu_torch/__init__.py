"""librempeg_tpu_torch — the PyTorch/CUDA port of librempeg_tpu.

The JAX package (``librempeg_tpu``) stays the reference; this package
runs the H.264 -> scale -> MPEG-4 transcode on an NVIDIA card, with the
four Pallas kernels of that path rewritten as hand-written CUDA kernels
(``csrc/``, bound in ``kernels/``). It imports neither JAX nor the JAX
package: the framework-free host modules it needs are carried as copies
(listed in CHANGES.md), and the native C++ sources are compiled by path
into ``build/``.

Layer map (mirrors the JAX package's names):

    cli/        ffmpeg-style CLI for the slice
    sched/      Transcoder (decode -> graph -> encode -> mux)
    filters/    null/scale graph
    formats/    raw H.264 demuxer, AVI muxer
    codecs/     H.264 decoder (host entropy + tensor P-frame recon),
                MPEG-4 encoder (tensor ME/DCT/quant + host VLC)
    scale/      planar YUV resize
    ops/        FIR GEMMs, 8x8 DCT, motion search, concealment
    kernels/    ctypes bindings + launch counters of the CUDA kernels
    csrc/       the CUDA C++ sources (sm_90a)
    core/       frames over tensors, packets, rational time, options
"""

__version__ = "0.1.0"

from librempeg_tpu_torch.core.rational import Rational  # noqa: F401
from librempeg_tpu_torch.core.frame import VideoFrame, AudioFrame  # noqa: F401
from librempeg_tpu_torch.core.packet import Packet  # noqa: F401
