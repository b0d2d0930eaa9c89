"""SPECK entropy-stage execution engines.

The dense stages (wavelets, quantization) run on the device; the bit-serial
SPECK entropy stage runs on the host.  Interchangeable engines produce
byte-identical streams:

  * NumpyEngine  — pure NumPy/Python reference engine (ground truth, slow)
  * NativeEngine — C++ engine (runtime/native), multithreaded across chunks

`default_engine()` is the native engine; its shared library is built on
first use, and a build failure raises rather than degrading to NumPy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..codec import speck_int_np as sp


class WaveEngine:
    """Wavefront engine (codec/speck_wave.py): vectorized per-bitplane passes
    for all of 1D/2D/3D.  Byte-identical streams; this is the array-oriented
    re-architecture whose pixel segments map 1:1 onto device vector ops."""

    name = "wave"

    def encode(self, ndim, mags, signs, dims, width, budget_bits) -> bytes:
        from ..codec import speck_wave as sw

        if ndim == 3:
            return sw.encode_3d(mags, signs, dims, budget_bits)
        if ndim == 2:
            return sw.encode_2d(mags, signs, dims[:2], budget_bits)
        return sw.encode_1d(mags, signs, dims[0], budget_bits)

    def decode(self, ndim, stream, dims, width) -> Tuple[np.ndarray, np.ndarray]:
        from ..codec import speck_wave as sw

        if ndim == 3:
            return sw.decode_3d(bytes(stream), dims)
        if ndim == 2:
            return sw.decode_2d(bytes(stream), dims[:2])
        return sw.decode_1d(bytes(stream), dims[0])

    def encode_1d(self, mags, signs, total_len, width) -> bytes:
        from ..codec import speck_wave as sw

        return sw.encode_1d(mags, signs, total_len, 0)

    def decode_1d(self, stream, total_len, width):
        from ..codec import speck_wave as sw

        return sw.decode_1d(bytes(stream), total_len)


class NumpyEngine:
    name = "numpy"

    def encode(self, ndim, mags, signs, dims, width, budget_bits) -> bytes:
        enc = sp.make_encoder(ndim, width)
        enc.set_dims(dims)
        enc.set_budget(budget_bits)
        enc.use_coeffs(mags, signs)
        enc.encode()
        return enc.encoded_bitstream()

    def decode(self, ndim, stream, dims, width) -> Tuple[np.ndarray, np.ndarray]:
        dec = sp.make_decoder(ndim, width)
        dec.set_dims(dims)
        dec.use_bitstream(stream)
        dec.decode()
        return dec.coeff, dec.signs

    def encode_1d(self, mags, signs, total_len, width) -> bytes:
        return self.encode(1, mags, signs, (total_len, 1, 1), width, 0)

    def decode_1d(self, stream, total_len, width):
        return self.decode(1, stream, (total_len, 1, 1), width)


_default: Optional[object] = None


def default_engine():
    global _default
    if _default is None:
        from .native import NativeEngine

        _default = NativeEngine()
    return _default


def set_default_engine(engine) -> None:
    global _default
    _default = engine
