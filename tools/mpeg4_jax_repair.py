"""Run-time repair of the JAX package's MPEG-4 encoder reference.

The JAX encoder (librempeg_tpu/codecs/mpeg4/encoder.py) reconstructs its
in-loop reference with the float spec IDCT (`_idct_spec`), clamped but
never rounded, while its decoder reconstructs with the integer
simple_idct over int16 coefficient storage. Every P-VOP therefore
predicts from a picture the decoder never has, and the decode drifts
along the GOP. The port's encoder takes the decoder's reconstruction
(librempeg_tpu_torch/codecs/mpeg4/encoder.py `_idct_int`).

`repaired()` gives the JAX encoder the same reference for the duration
of a `with` block, without editing the JAX package: its `_idct_spec` is
replaced by the decoder's own `idct_simple` (through a host callback,
after the decoder's int16 wrap of the dequantised coefficients), so the
recon of an I-VOP is the decoded picture and that of a P-VOP the
integer prediction plus the decoded residual. Its `_fdct_spec` becomes
the port's form too: the DCT in float64, rounded once to float32 (with
an integer reference the residuals are integers, whose DCT often lands
exactly on a quantiser threshold; a float32 GEMM settles such a tie by
its summation order, so the card and the CPU would differ). JAX's
compiled programs are dropped on entry and exit, since the encoder's
jitted passes captured the functions they traced.

Used by tools/torch_port_goldens.py for every MPEG-4 golden, and by the
CPU parity tests that compare the port's MPEG-4 bytes with the JAX
encoder's.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from librempeg_tpu.codecs.mpeg12.decoder import idct_simple
from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.ops import dct8x8


def _decoder_idct(c: np.ndarray) -> np.ndarray:
    x = np.rint(np.asarray(c, np.float64)).astype(np.int64)
    x = ((x + 32768) & 65535) - 32768
    return idct_simple(x).astype(np.float32)


def idct_decoder(c):
    """The decoder's reconstruction of [..., 8, 8] dequantised
    coefficients, traceable under jit (a host callback)."""
    return jax.pure_callback(_decoder_idct,
                             jax.ShapeDtypeStruct(c.shape, jnp.float32),
                             c, vmap_method="sequential")


def _fdct64(x: np.ndarray) -> np.ndarray:
    c = dct8x8._ortho_basis()
    y = np.einsum("ij,...jk,lk->...il", c, np.asarray(x, np.float64), c)
    return (y * JE._spec_dct_scale().astype(np.float64)).astype(np.float32)


def fdct_rounded_once(x):
    """The spec DCT of [..., 8, 8] blocks in float64, rounded once to
    float32, traceable under jit (a host callback)."""
    return jax.pure_callback(_fdct64,
                             jax.ShapeDtypeStruct(x.shape, jnp.float32),
                             x, vmap_method="sequential")


@contextlib.contextmanager
def repaired():
    """The JAX MPEG-4 encoder with the decoder's reference (see the
    module docstring). Nests; restores the float32 DCT and IDCT on
    exit."""
    orig = JE._idct_spec, JE._fdct_spec
    if orig[0] is idct_decoder:
        yield
        return
    JE._idct_spec, JE._fdct_spec = idct_decoder, fdct_rounded_once
    jax.clear_caches()
    try:
        yield
    finally:
        JE._idct_spec, JE._fdct_spec = orig
        jax.clear_caches()
