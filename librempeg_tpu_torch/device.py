"""Device selection and numeric policy for the port.

Every entry point takes an explicit ``device`` (default ``"cuda"``). A
CUDA request on a machine without a usable card raises: the main path
never moves to the CPU on its own. Tests pass ``device="cpu"``.

TF32 is switched off for matrix products and cuDNN. The float paths
(the scale GEMMs, the MPEG-4 DCT) are held to the JAX package's float32
results at HIGHEST precision; TF32 keeps about ten mantissa bits, which
would move pixels across the floor(x + 0.5) rounding boundary far more
often than float32 reordering does.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' explicitly to run on the CPU")
    return d
