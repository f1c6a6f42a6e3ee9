"""Build and load the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each ``csrc/<name>.cu`` exports plain C entry points and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared`` into ``build/torch_kernels/<name>-<hash>.so`` under the
checkout; the hash covers the source, so an edited kernel rebuilds and
an unchanged one loads the existing library. Nothing here runs at
import time: the CPU tests import every module on machines with no
nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_OUT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only on a machine with the CUDA "
                           "toolkit")
    return found


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built from csrc/<name>.cu if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(_CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_OUT, f"{name}-{digest}.so")
        if not os.path.exists(so):
            os.makedirs(_OUT, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib


def check(name: str, err: int) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t, name: str, dtype, shape=None) -> None:
    """Device/dtype/shape/contiguity checks before a raw-pointer launch."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
