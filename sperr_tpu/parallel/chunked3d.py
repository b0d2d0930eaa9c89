"""Chunk-parallel 3D volume compressor/decompressor (SPERR3D_OMP_* parity).

The volume is decomposed into independent chunks (preferred 256^3); each chunk
runs the full per-chunk pipeline.  Execution model:

  * host path (this module): a thread pool over chunks — the native C++
    SPECK engine releases the GIL, so chunks scale across host cores, which
    mirrors the reference's OpenMP loop.
  * device path (parallel/batched.py): equal-shaped chunks are stacked on a
    leading axis, the dense stages (DWT + quantization + outlier detect) run
    as one batched jit over a device mesh, and only the entropy stage comes
    back to the host.

Container output reproduces the reference stream layout byte-for-byte:
header || chunk_0 || chunk_1 || ... (ordered gather).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ..codec.speck_flt import SpeckFloatCodec
from ..errors import first_chunk_failure
from ..stream import tools
from ..utils.dims import chunk_volume, coarsened_resolutions, coarsened_resolutions_chunked


def _gather_chunk(vol: np.ndarray, c) -> np.ndarray:
    """vol shaped (nz, ny, nx); c = (x0, lx, y0, ly, z0, lz); f64 copy."""
    x0, lx, y0, ly, z0, lz = c
    return np.ascontiguousarray(
        vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx], dtype=np.float64
    )


def _scatter_chunk(vol: np.ndarray, small: np.ndarray, c) -> None:
    x0, lx, y0, ly, z0, lz = c
    vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx] = small.reshape(lz, ly, lx)


def _native_codec(precision: int = 64):
    try:
        from ..runtime.native import NativeChunkCodec

        return NativeChunkCodec(precision=precision)
    except Exception:
        return None


class Sperr3DCompressor:
    """Multi-chunk 3D compressor (reference: SPERR3D_OMP_C)."""

    def __init__(
        self,
        vol_dims: Tuple[int, int, int],
        chunk_dims: Tuple[int, int, int] = (256, 256, 256),
        num_threads: int = 0,
        engine=None,
        use_native: Optional[bool] = None,
        precision: int = 64,
    ):
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.chunk_dims = tuple(
            min(max(1, int(chunk_dims[i])), self.vol_dims[i]) for i in range(3)
        )
        self.num_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)
        self.engine = engine
        self.native = _native_codec(precision) if use_native in (None, True) else None
        if use_native and self.native is None:
            raise RuntimeError("native chunk codec unavailable")
        if precision != 64 and self.native is None:
            raise RuntimeError("precision=32 requires the native codec")

    def compress(self, vol: np.ndarray, mode: str, quality: float) -> bytes:
        """vol: array of shape (nz, ny, nx) or flat (x fastest); any float dtype."""
        nx, ny, nz = self.vol_dims
        is_float = np.asarray(vol).dtype == np.float32
        vol3 = np.asarray(vol).reshape(nz, ny, nx)
        chunks = chunk_volume(self.vol_dims, self.chunk_dims)

        if self.native is not None and self.engine is None:
            # strided native gather: the chunk block never exists as a
            # Python-side copy
            if vol3.dtype not in (np.float32, np.float64):
                vol3c = np.ascontiguousarray(vol3, dtype=np.float64)
            else:
                vol3c = np.ascontiguousarray(vol3)  # dtype-preserving

            def run(c):
                return self.native.compress_strided(vol3c, c, mode, quality)

        else:

            def run(c):
                codec = SpeckFloatCodec(3, (c[1], c[3], c[5]), engine=self.engine)
                return codec.compress(_gather_chunk(vol3, c), mode, quality)

        def run_i(i):
            try:
                return run(chunks[i])
            except Exception as e:  # noqa: BLE001 - reduced below
                return (i, e)

        if len(chunks) == 1:
            results = [run_i(0)]
        else:
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                results = list(pool.map(run_i, range(len(chunks))))
        first_chunk_failure(r for r in results if isinstance(r, tuple))
        streams = results

        header = tools.generate_header(
            self.vol_dims, self.chunk_dims, [len(s) for s in streams], is_float
        )
        return header + b"".join(streams)


class Sperr3DDecompressor:
    """Multi-chunk 3D decompressor (reference: SPERR3D_OMP_D)."""

    def __init__(
        self,
        num_threads: int = 0,
        engine=None,
        use_native: Optional[bool] = None,
        precision: int = 64,
    ):
        self.num_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)
        self.engine = engine
        self.precision = precision
        self.native = _native_codec(precision) if use_native in (None, True) else None
        self.header: Optional[tools.Sperr3DHeader] = None
        self.hierarchy: List[np.ndarray] = []

    def decompress(
        self, stream: bytes, multi_res: bool = False, out: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
        """Returns (volume shaped (nz, ny, nx) float64, vol_dims (nx, ny, nz)).

        `out`: optional preallocated (nz, ny, nx) C-contiguous array of the
        codec's output dtype — reusing a warm buffer avoids the OS page-fault
        cost of a fresh allocation per call (significant for large volumes)."""
        h = tools.parse_header(stream)
        self.header = h
        nx, ny, nz = h.vol_dims
        chunks = chunk_volume(h.vol_dims, h.chunk_dims)
        out_dtype = np.float64 if self.precision == 64 else np.float32
        if out is not None:
            if (
                out.shape != (nz, ny, nx)
                or out.dtype != out_dtype
                or not out.flags.c_contiguous
            ):
                raise ValueError(
                    f"out must be C-contiguous {(nz, ny, nx)} {out_dtype}; "
                    f"got {out.shape} {out.dtype}"
                )
            vol = out
        else:
            vol = np.empty((nz, ny, nx), dtype=out_dtype)

        vol_res = coarsened_resolutions_chunked(h.vol_dims, h.chunk_dims)
        chunk_res = coarsened_resolutions(h.chunk_dims)
        hierarchy: List[np.ndarray] = []
        hier_chunks = []
        if multi_res:
            for res in vol_res:
                hierarchy.append(np.empty((res[2], res[1], res[0]), dtype=np.float64))
            hier_chunks = [
                chunk_volume(vol_res[i], chunk_res[i]) for i in range(len(vol_res))
            ]

        use_native = self.native is not None and self.engine is None and not multi_res

        def run(i):
            c = chunks[i]
            off, ln = h.chunk_offsets[i * 2], h.chunk_offsets[i * 2 + 1]
            if use_native:
                # strided native scatter: writes land in `vol` directly
                self.native.decompress_strided(stream[off : off + ln], vol, c)
                return
            codec = SpeckFloatCodec(3, (c[1], c[3], c[5]), engine=self.engine)
            vals, hier = codec.decompress(stream[off : off + ln], multi_res=multi_res)
            _scatter_chunk(vol, vals, c)
            if multi_res:
                for lev in range(len(hier)):
                    _scatter_chunk(hierarchy[lev], hier[lev], hier_chunks[lev][i])

        def run_i(i):
            try:
                run(i)
            except Exception as e:  # noqa: BLE001 - reduced below
                return (i, e)

        if len(chunks) == 1:
            errs = [run_i(0)]
        else:
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                errs = list(pool.map(run_i, range(len(chunks))))
        first_chunk_failure(errs)

        self.hierarchy = hierarchy
        return vol, h.vol_dims
