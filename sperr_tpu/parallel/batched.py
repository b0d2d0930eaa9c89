"""Device-batched chunk pipeline: dense stages on device, entropy on host
or device.

This is the production execution engine.  Equal-shaped chunks are stacked on
a leading batch axis; one jitted program per chunk shape runs

    condition (means) -> DWT -> estimate q -> midtread quantize
    [PWE: inverse path + outlier detection]

for the whole batch, sharded across a `jax.sharding.Mesh` over the 'chunks'
axis, so chunk data-parallelism is SPMD over devices (the reference's OpenMP
loop reimagined across accelerators; see SPERR3D_OMP_C.cpp:94).  Only quantized
magnitudes/signs (and small per-chunk scalars) return to the host, where the
native SPECK engine encodes each chunk on a thread pool and the container is
gathered in chunk order.

Streams are format-identical to the reference; arithmetic runs at the device
compute dtype (f32 — see ops/cdf97_jax.py docstring).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec import outlier as outlier_mod
from ..codec import speck_int_np as sp
from ..ops import cdf97_jax as cdfj
from ..ops import condition as cond_host
from ..ops import quantize_jax as qzj
from ..errors import first_chunk_failure
from ..runtime.engine import default_engine
from ..stream import tools
from ..utils.dims import chunk_volume
from ..utils.packing import pack_8_booleans

_MODES = ("psnr", "pwe", "rate")
_WAVE_NEVER = 0x7FFF  # matches codec.speck_wave._NEVER
# Wave-path capacity ladder: (node_frac, evb_frac, out_frac) per tier —
# fractions of the partition-tree node count, the emission-matrix piece
# count, and the output byte bound (see _dense_encode_wave).  The last
# tier's node cap is exact and its piece/byte caps cover any realistic
# stream (~n/2 pieces, 8n bytes), so device coverage fails only for
# num_bp > num_bp_cap or truly pathological density (host fallback).
# Small chunks are dense per voxel (a 64^3 slice of a smooth field
# carries ~1.8 bits/voxel) while big chunks are sparse (~0.06 bpp at
# 256^3), so the first-tier fractions scale down with chunk size;
# mis-sizing only costs a batched retry, never bytes.
# The 4th element is the tier's BITPLANE cap: every emission matrix is
# [bp_cap, ...], so the whole stage scales linearly with it.  Error-bounded
# compression runs shallow ladders (num_bp ~ 9-14 at PWE 1e-2); chunks
# needing more bitplanes retry at a deeper tier (the 34 ceiling matches
# num_bp_cap, the host-fallback bound).
# The 5th element caps the exposed-pixel compaction (fraction of n);
# only exposed pixels (e < num_bp) emit LIP/refinement bits, so the
# emission matrices shrink to the exposed neighborhood.
DEFAULT_WAVE_TIERS = ((0.5, 0.5, 0.5, 16, 0.75), (1.0, 1.0, 1.0, 34, 1.0))
DEFAULT_WAVE_TIERS_BIG = (
    # calibrated on the 256^3 production regime (PWE 1e-2 smooth field:
    # num_bp 14, n_sig 84K of 2.4M nodes, 38K non-empty pieces, 517K
    # exposed pixels — occupancy counts, independent of the device)
    (1.0 / 20, 1.0 / 8, 1.0 / 24, 14, 1.0 / 20),
    (1.0 / 4, 1.0 / 4, 1.0 / 16, 22, 1.0 / 4),
    # dense/noisy regimes quantize to SHALLOW ladders (num_bp ~9-14 at
    # PWE with data/tol ~100-300) but expose most of the volume: a
    # half-caps then a full-caps 16-bitplane tier absorb them at ~1/2
    # the widest tier's emission-matrix cost; only genuinely deep data
    # (rate mode, tiny tolerances) reaches the 34 ladder
    (1.0 / 2, 1.0 / 2, 1.0 / 2, 16, 1.0),
    (1.0, 1.0, 1.0, 16, 1.0),
    (1.0, 1.0, 1.0, 34, 1.0),
)


def wave_tiers_for(n: int):
    """Default capacity ladder for an n-voxel chunk (see above)."""
    return DEFAULT_WAVE_TIERS if n < (1 << 21) else DEFAULT_WAVE_TIERS_BIG


def make_chunk_mesh(devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), axis_names=("chunks",))


# ---------------------------------------------------------------------------
# Device-side dense stages (jitted per chunk shape / mode).
# ---------------------------------------------------------------------------
def _encode_core(batch, mode: str, quality: float, cap: int, out_cap: int,
                 residual: str = "f32"):
    """Shared device stages: condition -> DWT -> q -> quantize -> sparse
    compaction [-> PWE outlier detection].  Returns (out dict, ll).

    `residual` (PWE only):
      "none"   — skip the on-device reconstruction/scan; the host computes
                 the outlier set against the exact f64 reconstruction
                 (bound certified for f64 decoders only);
      "dual"   — decoder-exact scan: simulate the f32 reconstruction the
                 shipped TpuDecompressor3D computes (same ops, same
                 composition as _dense_decode, including the +mean add) and
                 compact points with |vol - rec_dec| > tol - kappa, where
                 kappa is a small per-chunk guard window.  The host pairs
                 this with its exact f64 scan and certifies every
                 correction against BOTH decoders (strict mode,
                 TpuCompressor3D.pwe_strict=True);
      "f32"    — scan at threshold tol against the f32 reconstruction (fast
                 mode: bound tight only up to f32 roundoff);
      "margin" — scan at threshold tol - eta, where eta conservatively
                 bounds the f32-vs-f64 reconstruction discrepancy; chunks
                 whose eta exceeds tol/4 (f32 cannot certify) are flagged in
                 `margin_bad` and the host falls back to the exact residual
                 for those chunks only."""
    B = batch.shape[0]
    n = batch.shape[1] * batch.shape[2] * batch.shape[3]
    flat = batch.reshape(B, n)
    dt = batch.dtype

    v0 = flat[:, 0:1]
    is_const = jnp.all(flat == v0, axis=1)
    mean = jnp.mean(flat, axis=1)
    conditioned = flat - mean[:, None]

    coeffs = cdfj.dwt3d(conditioned.reshape(batch.shape)).reshape(B, n)

    if mode == "psnr":
        rng = jnp.max(conditioned, axis=1) - jnp.min(conditioned, axis=1)
        q = qzj.estimate_q_psnr_batched(coeffs, rng, quality)
    elif mode == "pwe":
        q = jnp.full((B,), quality * 1.5, dtype=dt)
    else:
        q = jnp.max(jnp.abs(coeffs), axis=1) / dt.type(qzj.RATE_MAX_MAG_DEVICE)

    ll = jnp.rint(coeffs * (1.0 / q)[:, None]).astype(jnp.int32)
    nnz = jnp.sum(ll != 0, axis=1).astype(jnp.int32)
    maxmag = jnp.max(jnp.abs(ll), axis=1)

    # Payload-carrying sort compaction, ONE FLAT sort over the whole batch
    # with composite keys b*(n+1)+idx instead of a batched/vmapped sort
    # (whether the flat form still wins on the GPU is an open measurement,
    # examples/prim_bench.py); since every chunk contributes exactly n
    # elements, chunk b's compacted prefix lands at fixed flat positions
    # [b*n, b*n+cap).
    def _compact_batch(flatv, valid):
        base = (jnp.arange(B, dtype=jnp.int32) * (n + 1))[:, None]
        key = jnp.where(valid, base + jnp.arange(n, dtype=jnp.int32)[None, :], base + n)
        key_s, val_s = jax.lax.sort(
            (key.reshape(-1), flatv.reshape(-1)), num_keys=1, is_stable=False
        )
        kk = key_s.reshape(B, n)[:, :cap] - base
        vv = val_s.reshape(B, n)[:, :cap]
        return kk, jnp.where(kk < n, vv, jnp.zeros_like(vv))

    if B * (n + 1) < 2**31:
        idx, vals = _compact_batch(ll, ll != 0)
    else:  # composite keys would overflow i32; fall back to the vmap form

        def compact(row):
            key = jnp.where(row != 0, jnp.arange(n, dtype=jnp.int32), n)
            key_s, val_s = jax.lax.sort(
                (key, row), num_keys=1, is_stable=False
            )
            idx = key_s[:cap]
            return idx, jnp.where(idx < n, val_s[:cap], 0)

        idx, vals = jax.vmap(compact)(ll)

    out = dict(
        is_const=is_const, v0=v0[:, 0], mean=mean, q=q,
        nnz=nnz, idx=idx, vals=vals, maxmag=maxmag,
        absmax=jnp.max(jnp.abs(flat), axis=1),
    )
    if mode == "pwe" and residual != "none":
        signs = ll >= 0
        mags = jnp.abs(ll)
        rec = qzj.midtread_inv_quantize_batched(mags, signs, q)
        rec = cdfj.idwt3d(rec.reshape(batch.shape)).reshape(B, n)
        if residual == "dual":
            # Decoder-exact residual: replicate _dense_decode's composition
            # (rec + mean, then compare against the f32 input) so the scan
            # sees the very error the shipped f32 decoder will produce.
            diff = flat - (rec + mean[:, None])
            # kappa: guard window below tol.  eta_sim bounds the residual
            # sim-vs-decoder discrepancy: the decoder runs the SAME XLA ops
            # as this simulation (zero divergence on a matching backend), so
            # eta only needs to absorb the decoder's f32 outlier-correction
            # add and a safety factor of per-op variation — all at the DATA
            # scale (absmax), not the coefficient scale: the f32-vs-f64
            # transform divergence is captured exactly by the two scans.
            # Decoders with a different f32 arithmetic (another compiler/
            # generation) are covered up to their reconstruction divergence;
            # the f64 interchange decoder is always certified.
            eps32 = jnp.asarray(np.finfo(np.float32).eps, dtype=dt)
            eta = dt.type(8.0) * eps32 * out["absmax"]
            kappa = jnp.minimum(
                dt.type(0.25 * quality),
                jnp.maximum(dt.type(0.05 * quality), 2.0 * eta),
            )
            out["eta_sim"] = eta
            out["kappa"] = kappa
            thr = (dt.type(quality) - kappa)[:, None]
        elif residual == "margin":
            diff = conditioned - rec
            # eta: conservative bound on |diff_f32 - diff_f64_decode| —
            # K * eps32 * the largest magnitude flowing through the inverse
            # transform (coefficient or data scale).  Detecting at tol - eta
            # keeps unflagged points within tol for an exact f64 decoder,
            # and flagged points' corrections retain >= tol/4 slack, so the
            # bound survives as long as eta <= tol/4 (margin_bad otherwise).
            eps32 = jnp.asarray(np.finfo(np.float32).eps, dtype=dt)
            scale = jnp.maximum(
                jnp.abs(q.astype(dt)) * maxmag.astype(dt),
                jnp.max(jnp.abs(conditioned), axis=1),
            )
            eta = dt.type(256.0) * eps32 * scale
            out["margin_bad"] = eta > dt.type(quality / 4.0)
            thr = jnp.maximum(
                dt.type(quality) - eta, dt.type(0.0)
            )[:, None]
        else:
            diff = conditioned - rec
            thr = dt.type(quality)
        omask = jnp.abs(diff) > thr
        n_out = jnp.sum(omask, axis=1).astype(jnp.int32)

        if B * (n + 1) < 2**31:
            base = (jnp.arange(B, dtype=jnp.int32) * (n + 1))[:, None]
            okey = jnp.where(
                omask, base + jnp.arange(n, dtype=jnp.int32)[None, :], base + n
            )
            k_s, d_s = jax.lax.sort(
                (okey.reshape(-1), diff.reshape(-1)), num_keys=1,
                is_stable=False,
            )
            oi = k_s.reshape(B, n)[:, :out_cap] - base
            ov = d_s.reshape(B, n)[:, :out_cap]
            out["n_out"] = n_out
            out["out_idx"] = oi
            out["out_vals"] = jnp.where(oi < n, ov, jnp.zeros_like(ov))
        else:

            def compact_out(m, d):
                key = jnp.where(m, jnp.arange(n, dtype=jnp.int32), n)
                key_s, d_s = jax.lax.sort(
                    (key, d), num_keys=1, is_stable=False
                )
                oi = key_s[:out_cap]
                return oi, jnp.where(oi < n, d_s[:out_cap], 0.0)

            out["n_out"], (out["out_idx"], out["out_vals"]) = (
                n_out, jax.vmap(compact_out)(omask, diff)
            )
    return out, ll


def _seq_rows(fn, batch):
    """Run a per-chunk program over a batch as lax.scan (chunk-sequential,
    one chunk's working set, and — decisively — IDENTICAL per-chunk f32
    arithmetic no matter how chunks are grouped into batches: XLA's
    shape-dependent fusion/FMA choices otherwise make a [8, n] front
    disagree with a [1, n] front in the last ulp, which breaks the
    cross-driver byte-equality contract)."""
    B = batch.shape[0]
    if B == 1:
        return fn(batch)

    def body(carry, row):
        o = fn(row[None])
        return carry, jax.tree_util.tree_map(lambda x: x[0], o)

    _, st = jax.lax.scan(body, jnp.int32(0), batch)
    return st


@partial(
    jax.jit,
    static_argnames=("mode", "quality", "cap", "out_cap", "residual", "seq"),
)
def _dense_encode_sparse(batch, mode: str, quality: float, cap: int, out_cap: int,
                         residual: str = "f32", seq: bool = False):
    """Device stages + on-device compaction of significant coefficients.

    Returns per chunk: indices (i32) and *signed* quantized values (i32) of
    the `nnz` nonzero coefficients (padded to `cap`), plus outlier positions/
    errors for PWE (padded to `out_cap`).  This keeps the device->host
    transfer proportional to the information content instead of the
    volume.

    ``seq``: per-chunk scan form (meshless drivers) — chunk-grouping-
    invariant arithmetic; False keeps the batched front (meshed drivers,
    SPMD over the chunk axis).
    """
    if seq:
        return _seq_rows(
            lambda b: _encode_core(b, mode, quality, cap, out_cap, residual)[0],
            batch,
        )
    out, _ = _encode_core(batch, mode, quality, cap, out_cap, residual)
    return out


def _encode_core_wave(batch, mode: str, quality: float, out_cap: int,
                      residual: str = "f32"):
    """Dense device stages for the wave path: condition -> DWT -> q ->
    quantize [-> PWE decoder-exact residual + TWO-LEVEL outlier
    compaction].  No nonzero compaction — the wave path's exposure
    compaction doubles as the sparse coefficient view — and the outlier
    compaction is the two-level form (ops/packemit.compact_flags_rows),
    removing the two n-scale flat sorts of the round-4 wave program."""
    from ..ops import packemit as pe

    B = batch.shape[0]
    n = batch.shape[1] * batch.shape[2] * batch.shape[3]
    flat = batch.reshape(B, n)
    dt = batch.dtype

    v0 = flat[:, 0:1]
    is_const = jnp.all(flat == v0, axis=1)
    mean = jnp.mean(flat, axis=1)
    conditioned = flat - mean[:, None]

    coeffs = cdfj.dwt3d(conditioned.reshape(batch.shape)).reshape(B, n)

    if mode == "psnr":
        rng = jnp.max(conditioned, axis=1) - jnp.min(conditioned, axis=1)
        q = qzj.estimate_q_psnr_batched(coeffs, rng, quality)
    elif mode == "pwe":
        q = jnp.full((B,), quality * 1.5, dtype=dt)
    else:
        q = jnp.max(jnp.abs(coeffs), axis=1) / dt.type(qzj.RATE_MAX_MAG_DEVICE)

    ll = jnp.rint(coeffs * (1.0 / q)[:, None]).astype(jnp.int32)
    maxmag = jnp.max(jnp.abs(ll), axis=1)

    out = dict(
        is_const=is_const, v0=v0[:, 0], mean=mean, q=q,
        maxmag=maxmag, absmax=jnp.max(jnp.abs(flat), axis=1),
    )
    if mode == "pwe" and residual != "none":
        signs = ll >= 0
        mags = jnp.abs(ll)
        rec = qzj.midtread_inv_quantize_batched(mags, signs, q)
        rec = cdfj.idwt3d(rec.reshape(batch.shape)).reshape(B, n)
        if residual == "dual":
            diff = flat - (rec + mean[:, None])
            eps32 = jnp.asarray(np.finfo(np.float32).eps, dtype=dt)
            eta = dt.type(8.0) * eps32 * out["absmax"]
            kappa = jnp.minimum(
                dt.type(0.25 * quality),
                jnp.maximum(dt.type(0.05 * quality), 2.0 * eta),
            )
            out["eta_sim"] = eta
            out["kappa"] = kappa
            thr = (dt.type(quality) - kappa)[:, None]
        elif residual == "margin":
            diff = conditioned - rec
            eps32 = jnp.asarray(np.finfo(np.float32).eps, dtype=dt)
            scale = jnp.maximum(
                jnp.abs(q.astype(dt)) * maxmag.astype(dt),
                jnp.max(jnp.abs(conditioned), axis=1),
            )
            eta = dt.type(256.0) * eps32 * scale
            out["margin_bad"] = eta > dt.type(quality / 4.0)
            thr = jnp.maximum(
                dt.type(quality) - eta, dt.type(0.0)
            )[:, None]
        else:
            diff = conditioned - rec
            thr = dt.type(quality)
        omask = jnp.abs(diff) > thr
        out["n_out"] = jnp.sum(omask, axis=1).astype(jnp.int32)
        oi, _ = pe.compact_flags_rows(omask, out_cap)
        ov = jnp.take_along_axis(
            diff, jnp.minimum(oi, n - 1), axis=1
        )
        out["out_idx"] = oi
        out["out_vals"] = jnp.where(oi < n, ov, jnp.zeros_like(ov))
    return out, ll


@partial(
    jax.jit,
    static_argnames=(
        "mode", "quality", "out_cap", "num_bp_cap", "dims3", "residual",
        "node_frac", "evb_frac", "out_frac", "bp_cap", "wexp_frac",
        "sparse_view", "seq",
    ),
)
def _dense_encode_wave(
    batch, mode: str, quality: float, out_cap: int, num_bp_cap: int,
    dims3: Tuple[int, int, int], residual: str = "f32",
    node_frac: float = 1.0, evb_frac: float = 1.0, out_frac: float = 1.0,
    bp_cap: int = 0, wexp_frac: float = 1.0, sparse_view: bool = True,
    seq: bool = False,
):
    """Device stages + the complete prefix-pack entropy stage
    (ops/wave_pack.py): dense [pass, position] emission matrices for
    LIP / LIS / refinement, packed by ops/packemit.masked_pack.  The whole
    SPECK bit computation runs on the device; the host only concatenates
    byte-aligned segments and writes headers.  Device->host traffic for
    the entropy stage is stream-sized.

    Tier fractions (static): ``node_frac`` of the partition-tree node
    count bounds significant sets; ``evb_frac`` of the piece count bounds
    non-empty 256-cell pieces; ``out_frac`` sizes the output buffer.  At
    1.0 the node cap is exact and the piece/byte caps are generous
    realistic bounds (~n/2 pieces, 8n bytes) — data dense beyond that
    falls back to the host engine.  ``bp_cap`` (<= num_bp_cap) sizes the
    emission matrices' bitplane axis; chunks with num_bp above it retry
    at a deeper tier."""
    from ..ops import speck_jax as sj
    from ..ops import speck_lis_jax as sl
    from ..ops import speck_virtual as svirt
    from ..ops import wave_pack as wp

    B = batch.shape[0]
    n = dims3[0] * dims3[1] * dims3[2]
    # index tiers: table-free virtual forest for power-of-two cubes (the
    # production chunk shape), pyramid-form schedule + table walk for other
    # dyadic dims, child-table segment reductions otherwise
    vfi = (
        svirt.virtual_lis_index(dims3)
        if svirt._is_pow2_cube(dims3)
        else None
    )
    pti = None
    ti = None
    if vfi is None:
        try:
            pti = sj.pyramid_index(dims3)
        except ValueError:
            pti = None
        ti = None if pti is not None else sj.tree_index(dims3)
    li = vfi if vfi is not None else sl.lis_index(dims3)

    nn = int(li.nn)
    node_cap = nn if node_frac >= 1.0 else max(2048, min(nn, int(nn * node_frac)))
    P = bp_cap if bp_cap else num_bp_cap
    # sparse_view=False (transfer="dense", the PCIe deployment shape):
    # the host fetches the dense quantized array instead of the
    # compacted coefficient view.  The exposure compaction itself always
    # runs per the tier (it is what keeps the emission matrices AND the
    # non-empty piece count at the exposed-neighborhood scale — a
    # full-width run was measured to blow the piece caps).
    wexp_cap = (
        0 if wexp_frac >= 1.0 else max(8192, min(n, int(n * wexp_frac)))
    )
    # static emission-matrix geometry (mirrors ops/wave_pack.wave_emit_3d)
    T = sl.lis_item_count(li, node_cap)
    Tp = -(-T // 128) * 128
    npad = -(-(wexp_cap or n) // 256) * 256
    cells = P * (2 * npad + 2 * Tp + npad)
    np_pieces = cells // 256
    # evb fractions are calibrated against the COMPACTED matrix geometry:
    # use the real compacted width when the compaction is active, and the
    # n/16 calibration surrogate for full-width tiers (so a wide-width
    # run doesn't inflate every cap-scaled cost downstream of the merge)
    np_cal = P * (3 * (npad if wexp_cap else -(-n // 16)) + 2 * Tp) // 256
    # widest tier: generous realistic bounds, not the astronomically padded
    # exact cell bound — truly pathological chunks (beyond ~8 n output
    # bytes or ~n/2 non-empty pieces) fall back to the host engine
    evb_wide = min(np_pieces, max(1 << 20, n // 2))
    out_wide = min(((cells // 8 + 3 * num_bp_cap) // 4 + 1) * 4, 8 * n)
    evb_cap = (
        evb_wide
        if evb_frac >= 1.0
        else max(8192, min(evb_wide, int(np_cal * evb_frac)))
    )
    out_cap_bytes = (
        out_wide
        if out_frac >= 1.0
        else max(16384, min(out_wide, (int(out_wide * out_frac) // 4) * 4))
    )

    def one(row, sgn_row):
        mags = jnp.abs(row).astype(jnp.uint32)
        pm = sj.msbp1_device(mags)
        num_bp = jnp.max(pm)
        if vfi is not None:
            s, e, nm = svirt.pixel_schedule_virtual(mags, vfi, num_bp)
        elif pti is not None:
            s, e, nm = sj.pixel_schedule_pyramid(mags, pti, num_bp)
        else:
            s, e, nm = sj.pixel_schedule(mags, ti, num_bp)
        node_s = jnp.where(nm > 0, num_bp - nm, _WAVE_NEVER).astype(jnp.int32)
        em = wp.wave_emit_3d(
            mags, sgn_row, s, e, node_s, num_bp, li, P,
            node_cap, evb_cap, out_cap_bytes, wexp_cap,
        )
        fits = (em.n_sig <= node_cap) & ~em.overflow & (em.num_bp <= P)
        return (
            em.num_bp, em.seg, em.counts, em.total_bytes, fits, em.n_sig,
            em.n_nz, em.exp_idx, em.exp_ll, em.n_exp,
        )

    def chunk_all(vol1):
        o, ll_c = _encode_core_wave(vol1, mode, quality, out_cap, residual)
        em = one(ll_c[0], (ll_c >= 0)[0])
        return o, ll_c, em

    if B == 1:
        out, ll, res1 = chunk_all(batch)
        res = tuple(x[None] for x in res1)
        if not sparse_view:
            out["ll"] = ll
    elif seq:
        # Fully per-chunk scan — the WHOLE pipeline (dense front included)
        # lives in the scan body: flat (unbatched) sorts, a one-chunk
        # working set (no [B, n] temporaries), and chunk-grouping-invariant
        # f32 arithmetic (see _seq_rows).  A 512^3 volume is ONE jitted
        # program.
        def body(carry, vol_row):
            o, ll_c, em = chunk_all(vol_row[None])
            o1 = {k: v[0] for k, v in o.items()}
            if not sparse_view:
                o1["ll"] = ll_c[0]
            return carry, (o1, em)

        _, (o_st, res) = jax.lax.scan(body, jnp.int32(0), batch)
        out = o_st
    else:
        # meshed drivers: BATCHED dense front (SPMD over the chunk axis —
        # and the same front the host-entropy driver runs, so the two
        # containers stay byte-identical under a mesh), entropy per chunk
        out, ll = _encode_core_wave(batch, mode, quality, out_cap, residual)
        if not sparse_view:
            out["ll"] = ll
        signs = ll >= 0

        def body(carry, xs):
            row, sgn_row = xs
            return carry, one(row, sgn_row)

        _, res = jax.lax.scan(body, jnp.int32(0), (ll, signs))
    out["wave"] = dict(
        num_bp=res[0], seg=res[1], counts=res[2], total_bytes=res[3],
        fits=res[4], n_sig=res[5], n_nz=res[6],
        exp_idx=res[7], exp_ll=res[8], n_exp=res[9],
    )
    return out


@partial(jax.jit, static_argnames=("mode", "quality", "residual", "seq"))
def _dense_encode(batch, mode: str, quality: float, residual: str = "f32",
                  seq: bool = False):
    """batch: (B, lz, ly, lx) device dtype. Returns per-chunk dense results.
    ``seq``: per-chunk scan form (see _dense_encode_sparse)."""
    if seq and batch.shape[0] > 1:
        return _seq_rows(
            lambda b: _dense_encode(b, mode, quality, residual), batch
        )
    B = batch.shape[0]
    n = batch.shape[1] * batch.shape[2] * batch.shape[3]
    flat = batch.reshape(B, n)
    dt = batch.dtype

    v0 = flat[:, 0:1]
    is_const = jnp.all(flat == v0, axis=1)
    mean = jnp.mean(flat, axis=1)
    conditioned = flat - mean[:, None]

    coeffs = cdfj.dwt3d(conditioned.reshape(batch.shape)).reshape(B, n)

    if mode == "psnr":
        rng = jnp.max(conditioned, axis=1) - jnp.min(conditioned, axis=1)
        q = qzj.estimate_q_psnr_batched(coeffs, rng, quality)
    elif mode == "pwe":
        q = jnp.full((B,), quality * 1.5, dtype=dt)
    else:  # rate: magnitudes must stay exactly representable at device precision
        q = jnp.max(jnp.abs(coeffs), axis=1) / dt.type(qzj.RATE_MAX_MAG_DEVICE)

    mags, signs, maxmag = qzj.midtread_quantize_batched(coeffs, q)

    out = dict(
        is_const=is_const, v0=v0[:, 0], mean=mean, q=q,
        mags=mags, signs=signs, maxmag=maxmag,
    )
    if mode == "pwe" and residual != "none":
        rec = qzj.midtread_inv_quantize_batched(mags, signs, q)
        rec = cdfj.idwt3d(rec.reshape(batch.shape)).reshape(B, n)
        if residual == "dual":
            # decoder-exact residual + guard window (see _encode_core)
            diff = flat - (rec + mean[:, None])
            eps32 = jnp.asarray(np.finfo(np.float32).eps, dtype=dt)
            eta = dt.type(8.0) * eps32 * jnp.max(jnp.abs(flat), axis=1)
            kappa = jnp.minimum(
                dt.type(0.25 * quality),
                jnp.maximum(dt.type(0.05 * quality), 2.0 * eta),
            )
            out["eta_sim"] = eta
            out["kappa"] = kappa
            thr = (dt.type(quality) - kappa)[:, None]
            out["outlier_mask"] = jnp.abs(diff) > thr
        else:
            diff = conditioned - rec
            out["outlier_mask"] = jnp.abs(diff) > dt.type(quality)
        out["diff"] = diff
    return out


@partial(jax.jit, static_argnames=("shape3",))
def _dense_decode(mags, signs, q, mean, shape3):
    B = mags.shape[0]
    coeffs = qzj.midtread_inv_quantize_batched(mags, signs, q)
    rec = cdfj.idwt3d(coeffs.reshape((B,) + shape3))
    return rec + mean[:, None, None, None].astype(rec.dtype)


@partial(jax.jit, static_argnames=("shape3",))
def _dense_decode_multires(mags, signs, q, mean, shape3):
    """Decode + multi-resolution hierarchy on device (SPERR3D_OMP_D.cpp:
    117-126 / CDF97.cpp:140-168).  Hierarchy levels are mean-conditioned
    like the full reconstruction (SPECK_FLT.cpp:592-603) but carry no
    outlier corrections (reference semantics)."""
    B = mags.shape[0]
    coeffs = qzj.midtread_inv_quantize_batched(mags, signs, q)
    rec, hier = cdfj.idwt3d_multi_res(coeffs.reshape((B,) + shape3))
    m = mean[:, None, None, None].astype(rec.dtype)
    return rec + m, tuple(h + m for h in hier)


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------
def _residual_outliers(ll, dims3, q, mean, orig, tol):
    """Strict-PWE outlier set: positions/errors where the exact f64 decode
    reconstruction misses `orig` by more than `tol` (ascending positions,
    the reference's scan order, SPECK_FLT.cpp:461-486), computed by the
    native engine (a build failure raises)."""
    from ..runtime.native import residual_outliers

    return residual_outliers(ll, dims3, q, mean, orig, tol)


def _sub_batches(groups, elem_budget: int, mesh: Optional[Mesh]):
    """Split each shape group into jit-call sub-batches of at most
    ``elem_budget`` elements PER DEVICE (at least one chunk each).  Under a
    mesh a full sub-batch holds a multiple of the device count, so every
    device holds a shard of it; only a group's remainder can be uneven."""
    ndev = 1 if mesh is None else mesh.devices.size
    parts: List[Tuple[Tuple[int, int, int], List[int]]] = []
    for shape, idxs in groups.items():
        n = shape[0] * shape[1] * shape[2]
        bmax = ndev * max(1, int(elem_budget // max(1, n)))
        for s0 in range(0, len(idxs), bmax):
            parts.append((shape, idxs[s0 : s0 + bmax]))
    return parts


def _place(arr, mesh: Optional[Mesh]):
    """Put a batch on the device(s) directly: split over the mesh's
    'chunks' axis when its leading dim divides evenly, else on the default
    device (an uneven remainder group)."""
    if mesh is not None and arr.shape[0] % mesh.devices.size == 0:
        return jax.device_put(arr, NamedSharding(mesh, P("chunks")))
    return jnp.asarray(arr)


def _sim_outlier_corr(e: float, tol: float, tol_dec: float) -> float:
    """Exact scalar simulation of outlier.encode_outliers followed by
    outlier.decode_outliers for one error value: quantize by `tol`, decode
    with the bias corrections against the decoder-visible tolerance
    `tol_dec` (= header q / 1.5).  Used by the dual certificate to check a
    candidate correction against both decoders' residuals."""
    nq = np.rint(e * (1.0 / tol))
    if nq == 0.0:
        return 0.0
    mag = 1.1 if abs(nq) == 1.0 else abs(nq) - 0.25
    sgn = 1.0 if nq >= 0.0 else -1.0
    return float(mag * (tol_dec * sgn))


def _certify_dual(pos64, errs64, pos32, errs32, tol: float, eta: float, q_hdr: float):
    """Merge the exact-f64 and decoder-exact-f32 residual scans into one
    certified outlier set.

    Inputs are (positions, error values) pairs from two scans over the SAME
    quantized coefficients, both at thresholds >= tol - kappa:
      (pos64, errs64): vol - IDWT_f64(q_hdr * ll) - mean, exact f64 — what
        an f64 decoder (ours, the native engine's, the reference's) sees;
      (pos32, errs32): vol - (IDWT_f32(invq) + mean) in the shipped device
        decoder's own f32 arithmetic (within eta, see _encode_core).

    Output set S = {|err64| > tol} ∪ {|err32| > tol - eta}; each point's fed
    error value is chosen so the simulated correction bounds BOTH residuals:
    |err64 - corr| <= tol and |err32 - corr| + eta <= tol.  Returns
    (positions, values, certified); certified=False when some point in S is
    missing one residual value (the guard window was narrower than the
    actual f32/f64 divergence) or no candidate passes — in that case the
    f64 contract still holds (err64 is fed) but the f32 device decoder is
    not certified for this chunk."""
    tol_dec = q_hdr / 1.5
    m64 = {int(p): float(e) for p, e in zip(pos64, errs64)}
    m32 = {int(p): float(e) for p, e in zip(pos32, errs32)}
    S = sorted(
        {p for p, e in m64.items() if abs(e) > tol}
        | {p for p, e in m32.items() if abs(e) > tol - eta}
    )
    pos, vals, ok = [], [], True
    for p in S:
        e64, e32 = m64.get(p), m32.get(p)
        if e64 is None:
            # no f64 value -> |err64| <= tol - kappa, so the f64 bound holds
            # WITHOUT a correction; feeding the (divergent) f32 value could
            # break it.  Drop the point and report the f32 side uncertified.
            ok = False
            continue
        if e32 is None:
            ok = False
            e = e64  # in S via the 64-branch, so |e64| > tol
        else:
            # prefer the exact f64 value whenever it certifies both decoders:
            # fed values then come from host arithmetic (sharding-invariant)
            # in all but boundary cases
            cands = (e64, e32)
            for e in cands:
                c = _sim_outlier_corr(e, tol, tol_dec)
                if c != 0.0 and abs(e64 - c) <= tol and abs(e32 - c) + eta <= tol:
                    break
            else:
                # no candidate certifies both decoders: keep the f64
                # contract intact (feed e64 only when f64 needs the
                # correction; otherwise drop) and flag the chunk.
                ok = False
                if abs(e64) <= tol:
                    continue
                e = e64
        pos.append(p)
        vals.append(e)
    return (
        np.asarray(pos, dtype=np.int64),
        np.asarray(vals, dtype=np.float64),
        ok,
    )


def _width_for(maxmag: int) -> int:
    if maxmag <= 0xFF:
        return 8
    if maxmag <= 0xFFFF:
        return 16
    if maxmag <= 0xFFFFFFFF:
        return 32
    return 64


def _condi_header(is_const: bool, v0: float, nval: int, mean: float, q: float) -> bytes:
    import struct

    if is_const:
        flags = pack_8_booleans([True, 0, 0, 0, 0, 0, 0, True])
        return struct.pack("<BQd", flags, nval, float(v0))
    flags = pack_8_booleans([True, 0, 0, 0, 0, 0, 0, False])
    return struct.pack("<Bdd", flags, float(mean), float(q))


class TpuCompressor3D:
    """Chunked 3D compressor with device-batched dense stages.

    `mesh`: optional jax Mesh with a 'chunks' axis; chunk batches are sharded
    over it.  `dtype`: device compute dtype (float32).
    """

    def __init__(
        self,
        vol_dims: Tuple[int, int, int],
        chunk_dims: Tuple[int, int, int] = (256, 256, 256),
        mesh: Optional[Mesh] = None,
        dtype=jnp.float32,
        engine=None,
        num_threads: Optional[int] = None,
        entropy: str = "host",
        pwe_strict: bool = True,
        transfer: str = "sparse",
    ):
        assert entropy in ("host", "wave")
        assert transfer in ("sparse", "dense")
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.chunk_dims = tuple(
            min(max(1, int(chunk_dims[i])), self.vol_dims[i]) for i in range(3)
        )
        self.mesh = mesh
        self.dtype = dtype
        self.engine = engine or default_engine()
        self.num_threads = num_threads
        # Per-chunk capacity (fraction of n) for the on-device significant-
        # coefficient compaction; overflow falls back to a dense fetch.
        self.sparse_cap_frac = 0.5
        # entropy="wave": the SPECK pixel bit-work also runs on device
        # (ops/speck_jax.py) and only stream-sized segments cross to the
        # host, which runs the set walk and stitches the stream.
        self.entropy = entropy
        self.num_bp_cap = 34
        # Wave-path capacity ladder: (node_frac, evb_frac, out_frac) per
        # tier (see _dense_encode_wave / wave_tiers_for).  Every data-
        # dependent movement in the prefix-pack entropy stage scales with
        # these caps; the first tier runs the whole batch and chunks that
        # overflow (exact device-side flags) retry batched at the wider
        # tiers.  None -> per-chunk-size defaults (wave_tiers_for).
        self.wave_tiers = None
        # Device-memory sub-batching budgets, in ELEMENTS per device per
        # jit call (see compress()): bounds the per-call device working
        # set.  The wave path's intermediates run ~40x the input bytes,
        # the dense paths ~6x.
        self.wave_elem_budget = 1 << 24
        self.dense_elem_budget = 1 << 28
        # transfer: how quantized coefficients reach the host entropy stage.
        #   "sparse" — on-device compaction of nonzero coefficients and
        #              outliers: device->host traffic ~ information content,
        #              at the cost of a large-array sort on the device.
        #   "dense"  — ship the dense quantized arrays; the host compacts at
        #              memcpy speed and the device encode core is the pure
        #              math.  entropy="host" only.
        self.transfer = transfer
        # pwe_strict: how the PWE bound is certified.
        #   True     — dual certification: the outlier set bounds the error
        #              of BOTH the exact f64 reconstruction (ours, the
        #              native engine's, and the reference binaries') and the
        #              f32 reconstruction the shipped TpuDecompressor3D
        #              actually computes.  The device runs a decoder-exact
        #              f32 residual scan, the host runs the exact f64 scan,
        #              and every correction is per-point certified against
        #              both residuals (_certify_dual).  Chunks that cannot
        #              be certified for f32 (guard window exceeded — only
        #              when tol is within ~1e2 ulps of the data scale) are
        #              counted in `last_uncertified_chunks`; their f64 bound
        #              still holds.
        #   "f64"    — reference semantics: outliers exactly where the f64
        #              reconstruction misses by > tol (SPECK_FLT.cpp:461-486)
        #              — certified for f64 decoders only.
        #   "device" — all-device scan at threshold tol - eta, where eta
        #              conservatively bounds the f32/f64 reconstruction
        #              discrepancy: the f64-decode bound still holds, and
        #              only chunks whose eta > tol/4 (f32 cannot certify)
        #              fall back to the host residual.
        #   False    — all-device scan at tol: fastest, bound tight only up
        #              to f32 roundoff (precision=32 native fast-mode
        #              contract).
        self.pwe_strict = pwe_strict
        # Per-compress observability (documented attribute contract, reset
        # by every compress/compress_chunks call):
        #   last_wave_chunks        — chunks encoded by the device entropy
        #                             path (vs host-entropy fallback);
        #   last_uncertified_chunks — PWE dual-certification failures: the
        #                             exact-f64 bound holds for these chunks
        #                             but the shipped f32 device decoder is
        #                             NOT certified;
        #   last_uncertified_ids    — their indices, in chunk order (the
        #                             reference's per-chunk error surface,
        #                             SPERR3D_OMP_C.cpp:132-135).
        #   last_batch_devices      — number of devices holding a shard
        #                             of each primary sub-batch, in order.
        self.last_wave_chunks = 0
        self.last_uncertified_chunks = 0
        self.last_uncertified_ids: List[int] = []
        self.last_batch_devices: List[int] = []

    def compress(self, vol: np.ndarray, mode: str, quality: float) -> bytes:
        assert mode in _MODES
        nx, ny, nz = self.vol_dims
        is_float = np.asarray(vol).dtype == np.float32
        vol3 = np.asarray(vol).reshape(nz, ny, nx)
        chunks = chunk_volume(self.vol_dims, self.chunk_dims)

        def loader(c):
            return vol3[
                c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]
            ]

        streams = self.compress_chunks(chunks, loader, mode, quality)
        header = tools.generate_header(
            self.vol_dims, self.chunk_dims, [len(s) for s in streams], is_float
        )
        return header + b"".join(streams)

    def compress_chunks(
        self, chunks, loader, mode: str, quality: float
    ) -> List[bytes]:
        """Device-batched compression of an explicit chunk list.

        ``loader(spec)`` returns a chunk's data shaped (lz, ly, lx); specs
        are (x0, lx, y0, ly, z0, lz) as produced by utils.dims.chunk_volume.
        Returns one SPECK_FLT stream per spec, in order — no container
        header.  This is the multi-host seam: parallel.distributed routes
        each process's owned chunks through this method on its local mesh
        (the reference's per-thread codec instances,
        SPERR3D_OMP_C.cpp:94-130, lifted to host scale)."""
        assert mode in _MODES

        # Group chunks by shape so each group is one batched jit invocation.
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        for i, c in enumerate(chunks):
            groups.setdefault((c[5], c[3], c[1]), []).append(i)

        streams: List[Optional[bytes]] = [None] * len(chunks)
        # per-compress observability: how many chunks used the device
        # entropy path vs the host fallback (caps overflow, dense data)
        wave_used = [0] * len(chunks)

        # PWE certification mode (see pwe_strict in __init__)
        if mode != "pwe" or self.pwe_strict is False:
            resid_mode = "f32"
        elif self.pwe_strict == "device":
            resid_mode = "margin"
        elif self.pwe_strict == "f64":
            resid_mode = "none"
        else:  # True: dual certification (f64 exact + shipped f32 decoder)
            resid_mode = "dual"
        dev_resid = resid_mode != "none"
        uncertified = [0] * len(chunks)

        # Memory-bounded sub-batching: one jit call per (shape, sub-batch).
        # The wave path keeps ~40x the input footprint in device
        # intermediates (event buffers, sort operands), the dense paths
        # ~6x — without a bound, a 512^3 volume at 64^3 chunk dims would
        # put thousands of chunks' working sets on the device at once.
        # Sub-batches reuse the compiled executable (same B); only the
        # final remainder compiles a second shape.
        elem_budget = (
            self.wave_elem_budget
            if self.entropy == "wave"
            else self.dense_elem_budget
        )
        self.last_batch_devices = []

        for shape, idxs in _sub_batches(groups, elem_budget, self.mesh):
            lz, ly, lx = shape
            n = lx * ly * lz
            batch = np.stack(
                [
                    np.ascontiguousarray(loader(c))
                    for c in (chunks[i] for i in idxs)
                ]
            ).astype(np.dtype(self.dtype))
            dev = _place(batch, self.mesh)
            self.last_batch_devices.append(len(dev.sharding.device_set))
            cap = max(1024, int(n * self.sparse_cap_frac))
            out_cap = max(256, n // 64)
            force_dense = self.transfer == "dense" and self.entropy != "wave"
            # dense-transfer wave: no device-side sparse coefficient view
            # (sparse_view=False — full-width emission, host fetches the
            # dense quantized array at memcpy/PCIe speed)
            dense_wave = (
                self.transfer == "dense" and self.entropy == "wave"
            )
            # meshless drivers run every device program in the per-chunk
            # scan form: chunk-grouping-invariant f32 arithmetic (the
            # cross-driver byte-equality contract) + one-chunk working
            # sets; meshed drivers keep batched fronts (SPMD over chunks)
            seq = self.mesh is None
            wave = None
            wave_alt: Dict[int, Tuple[dict, int]] = {}
            fb_sparse: Dict[int, dict] = {}
            fb_dense: Dict[int, dict] = {}
            # wave-program outlier cap: tiny (smooth PWE data has ~0
            # outliers; the two-level compaction's cost scales with it);
            # overflowing chunks re-run through the sparse program
            wave_out_cap = max(1024, n // 1024)

            def _trim_rows(arr_dev, counts, capn):
                m = int(counts.max()) if counts.size else 0
                m = min(capn, ((m + 1023) // 1024) * 1024) if m else 0
                if m == 0:
                    return np.zeros((arr_dev.shape[0], 0), dtype=np.int32)
                return np.asarray(jax.device_get(arr_dev[:, :m]))

            if self.entropy == "wave":
                from ..ops import speck_jax as sj
                from ..ops import speck_lis_jax as sl
                from ..ops import speck_virtual as svirt

                # build static indexes outside any jit trace (tracer
                # safety: their device constants are created eagerly, not
                # inside _dense_encode_wave's trace)
                if svirt._is_pow2_cube((lx, ly, lz)):
                    svirt.virtual_lis_index((lx, ly, lz))
                else:
                    try:
                        sj.pyramid_index((lx, ly, lz))
                    except ValueError:
                        sj.tree_index((lx, ly, lz))
                    sl.lis_index((lx, ly, lz))

                def _wexp_for(tier):
                    # must mirror _dense_encode_wave/wave_emit_3d exactly:
                    # the coefficient view exists only when the compaction
                    # is active (wexp_cap < n); dense_wave never fetches
                    # it (the host reads the dense quantized array)
                    if dense_wave:
                        return 0
                    wf = tier[4]
                    w = 0 if wf >= 1.0 else max(8192, min(n, int(n * wf)))
                    return w if w < n else 0

                def fetch_wave(wdev, bp_cap, wexp_cap):
                    # scalars first, then a total-trimmed fetch of the
                    # packed segment buffer: the device->host entropy
                    # traffic is stream-sized.  PWE additionally pulls
                    # the exposure-compacted coefficient view (~n_exp *
                    # 8 B) — it feeds the host's exact f64 residual scan,
                    # replacing the old nonzero compaction.
                    w = {
                        k: np.asarray(jax.device_get(wdev[k]))
                        for k in ("num_bp", "counts", "total_bytes",
                                  "fits", "n_sig", "n_nz")
                    }
                    w["bp_cap"] = bp_cap
                    tot = w["total_bytes"]
                    b = int(tot.max()) if tot.size else 0
                    b = min(b, wdev["seg"].shape[1])
                    w["seg"] = np.asarray(jax.device_get(wdev["seg"][:, :b]))
                    w["exp_idx"] = None
                    if mode == "pwe" and wexp_cap:
                        ne = np.asarray(jax.device_get(wdev["n_exp"]))
                        w["n_exp"] = ne
                        w["exp_idx"] = _trim_rows(
                            wdev["exp_idx"], np.minimum(ne, wexp_cap),
                            wexp_cap,
                        )
                        w["exp_ll"] = _trim_rows(
                            wdev["exp_ll"], np.minimum(ne, wexp_cap),
                            wexp_cap,
                        )
                    return w

                tiers = (
                    self.wave_tiers
                    if self.wave_tiers is not None
                    else wave_tiers_for(n)
                )
                res = _dense_encode_wave(
                    dev, mode, float(quality), wave_out_cap,
                    self.num_bp_cap, (lx, ly, lz), resid_mode, *tiers[0],
                    sparse_view=not dense_wave, seq=seq,
                )
                wave = fetch_wave(
                    res.pop("wave"), tiers[0][3], _wexp_for(tiers[0])
                )
                # retry ladder: chunks that overflowed a cap (exact device
                # flags) re-run BATCHED at the next, wider tier; only
                # num_bp > num_bp_cap ever falls back to host entropy (the
                # last tier's caps are exact bounds)
                for tier in tiers[1:]:
                    bad = [
                        k for k in range(len(idxs))
                        if not self._wave_fits(*wave_alt.get(k, (wave, k)))
                        and int(wave["num_bp"][k]) <= self.num_bp_cap
                    ]
                    if not bad:
                        break
                    # Sub-batch sizing: round DOWN to a power of two within
                    # the per-device memory budget so a padded retry batch
                    # never exceeds wave_elem_budget//4 per device; under
                    # a mesh, full retry batches span every device.
                    bmax_r = max(
                        1, (self.wave_elem_budget // 4) // max(1, n)
                    )
                    bmax_r = 1 << max(0, bmax_r.bit_length() - 1)
                    if self.mesh is not None:
                        bmax_r *= self.mesh.devices.size
                    for s0 in range(0, len(bad), bmax_r):
                        grp = bad[s0 : s0 + bmax_r]
                        Bp = 1 << (len(grp) - 1).bit_length()
                        sel = grp + [grp[0]] * (Bp - len(grp))
                        res_r = _dense_encode_wave(
                            _place(dev[jnp.asarray(sel)], self.mesh),
                            mode, float(quality),
                            wave_out_cap, self.num_bp_cap, (lx, ly, lz),
                            resid_mode, *tier, sparse_view=not dense_wave,
                            seq=seq,
                        )
                        wv = fetch_wave(
                            res_r.pop("wave"), tier[3], _wexp_for(tier)
                        )
                        for j, k in enumerate(grp):
                            wave_alt[k] = (wv, j)
            elif force_dense:
                res = _dense_encode(
                    dev, mode, float(quality), resid_mode, seq=seq
                )
            else:
                res = _dense_encode_sparse(
                    dev, mode, float(quality), cap, out_cap, resid_mode,
                    seq=seq,
                )
            # Pull small per-chunk scalars first.
            small_keys = ["is_const", "v0", "mean", "q", "maxmag"]
            if resid_mode == "dual":
                small_keys += ["eta_sim", "kappa"]
            small = {
                k: np.asarray(jax.device_get(res[k])) for k in small_keys
            }
            n_out = (
                np.asarray(jax.device_get(res["n_out"]))
                if mode == "pwe" and dev_resid and not force_dense
                else None
            )
            margin_bad = (
                np.asarray(jax.device_get(res["margin_bad"]))
                if resid_mode == "margin" and not force_dense
                else None
            )
            dense = None
            sparse = None
            nnz = None
            dense_ll = None
            wout_idx = wout_vals = None
            if wave is not None and dense_wave:
                # dense-transfer wave: bodies/fallbacks and the PWE f64
                # scan all read the dense quantized array (fetched once,
                # lazily); only outlier-cap overflow re-runs anything
                if mode == "pwe" and dev_resid:
                    wout_idx = _trim_rows(
                        res["out_idx"], np.minimum(n_out, wave_out_cap),
                        wave_out_cap,
                    )
                    wout_vals = _trim_rows(
                        res["out_vals"], np.minimum(n_out, wave_out_cap),
                        wave_out_cap,
                    )
                need_ll = mode == "pwe" or any(
                    not self._wave_fits(*wave_alt.get(k, (wave, k)))
                    for k in range(len(idxs))
                )
                if need_ll:
                    dense_ll = np.asarray(jax.device_get(res["ll"]))
                fbd = [
                    k for k in range(len(idxs))
                    if mode == "pwe"
                    and dev_resid
                    and n_out is not None
                    and int(n_out[k]) > wave_out_cap
                ]
                for s0 in range(0, len(fbd), 8):
                    grp = fbd[s0 : s0 + 8]
                    res_d = jax.device_get(
                        _dense_encode(
                            dev[jnp.asarray(grp)], mode, float(quality),
                            resid_mode, seq=seq,
                        )
                    )
                    for j, k in enumerate(grp):
                        fb_dense[k] = {
                            key: res_d[key][j] for key in res_d
                        }
            elif wave is not None:
                # Wave branch: the exposure compaction doubles as the
                # sparse coefficient view (PWE f64 scan) and the outlier
                # arrays come from the wave program's two-level
                # compaction; only chunks that fell off the device path —
                # cap overflow, num_bp too deep, outlier-cap overflow, or
                # a winning tier without exposure arrays when the host
                # needs coefficients — re-run through the sparse program.
                if mode == "pwe" and dev_resid:
                    wout_idx = _trim_rows(
                        res["out_idx"], np.minimum(n_out, wave_out_cap),
                        wave_out_cap,
                    )
                    wout_vals = _trim_rows(
                        res["out_vals"], np.minimum(n_out, wave_out_cap),
                        wave_out_cap,
                    )
                fb = set()
                for k in range(len(idxs)):
                    wv, wk = wave_alt.get(k, (wave, k))
                    if not self._wave_fits(wv, wk):
                        fb.add(k)
                        continue
                    if mode != "pwe":
                        continue
                    if (
                        dev_resid
                        and n_out is not None
                        and int(n_out[k]) > wave_out_cap
                    ):
                        fb.add(k)
                        continue
                    ll_needed = resid_mode in ("dual", "none") or (
                        resid_mode == "margin"
                        and margin_bad is not None
                        and bool(margin_bad[k])
                    )
                    if ll_needed and wv.get("exp_idx") is None:
                        fb.add(k)
                if fb:
                    fb_list = sorted(fb)
                    out_cap_sp = out_cap
                    bmax_s = max(
                        1, self.dense_elem_budget // (8 * max(1, n))
                    )
                    for s0 in range(0, len(fb_list), bmax_s):
                        grp = fb_list[s0 : s0 + bmax_s]
                        sel = jnp.asarray(grp)
                        res_s = _dense_encode_sparse(
                            dev[sel], mode, float(quality), cap,
                            out_cap_sp, resid_mode, seq=seq,
                        )
                        nnz_s = np.asarray(jax.device_get(res_s["nnz"]))
                        no_s = (
                            np.asarray(jax.device_get(res_s["n_out"]))
                            if mode == "pwe" and dev_resid
                            else None
                        )
                        if (nnz_s > cap).any() or (
                            no_s is not None and (no_s > out_cap_sp).any()
                        ):
                            res_d = jax.device_get(
                                _dense_encode(
                                    dev[sel], mode, float(quality),
                                    resid_mode, seq=seq,
                                )
                            )
                            for j, k in enumerate(grp):
                                fb_dense[k] = {
                                    key: res_d[key][j] for key in res_d
                                }
                        else:
                            sp = {
                                "idx": _trim_rows(res_s["idx"], nnz_s, cap),
                                "vals": _trim_rows(res_s["vals"], nnz_s, cap),
                            }
                            if no_s is not None:
                                sp["out_idx"] = _trim_rows(
                                    res_s["out_idx"], no_s, out_cap_sp
                                )
                                sp["out_vals"] = _trim_rows(
                                    res_s["out_vals"], no_s, out_cap_sp
                                )
                            for j, k in enumerate(grp):
                                fb_sparse[k] = {
                                    "nnz": int(nnz_s[j]),
                                    "idx": sp["idx"][j],
                                    "vals": sp["vals"][j],
                                    "n_out": (
                                        int(no_s[j]) if no_s is not None else 0
                                    ),
                                    "out_idx": sp.get(
                                        "out_idx", np.zeros(0, np.int32)
                                    )[j]
                                    if no_s is not None
                                    else None,
                                    "out_vals": sp.get(
                                        "out_vals", np.zeros(0, np.float32)
                                    )[j]
                                    if no_s is not None
                                    else None,
                                }
            elif force_dense:
                dense = jax.device_get(res)
            else:
                nnz = np.asarray(jax.device_get(res["nnz"]))
                if (nnz > cap).any() or (
                    n_out is not None and (n_out > out_cap).any()
                ):
                    dense = jax.device_get(
                        _dense_encode(dev, mode, float(quality), resid_mode)
                    )
                else:
                    # Slice the compacted arrays to the actual occupancy
                    # on the device before fetching: transfer ~ max(nnz)
                    sparse = {
                        "idx": _trim_rows(res["idx"], nnz, cap),
                        "vals": _trim_rows(res["vals"], nnz, cap),
                    }
                    if mode == "pwe" and dev_resid:
                        sparse["out_idx"] = _trim_rows(
                            res["out_idx"], n_out, out_cap
                        )
                        sparse["out_vals"] = _trim_rows(
                            res["out_vals"], n_out, out_cap
                        )

            budget = int(quality * n) if mode == "rate" else 0

            def encode_one(k: int) -> bytes:
                gi = idxs[k]
                if bool(small["is_const"][k]):
                    return _condi_header(True, float(small["v0"][k]), n, 0.0, 0.0)
                # strict/margin PWE store the reference's exact f64
                # q = 1.5*tol (SPECK_FLT.cpp:281): residual scan, header, and
                # decoder all agree on the same reconstruction scale.
                q = (
                    1.5 * float(quality)
                    if mode == "pwe" and resid_mode in ("none", "margin", "dual")
                    else float(small["q"][k])
                )
                mean = float(small["mean"][k])
                condi = _condi_header(False, 0.0, 0, mean, q)
                wv, wk = wave_alt.get(k, (wave, k))
                use_wave = wv is not None and self._wave_fits(wv, wk)
                if use_wave:
                    wave_used[gi] = 1
                    body = self._stitch_wave(wv, wk, (lx, ly, lz), budget)
                else:
                    width = _width_for(int(small["maxmag"][k]))
                    if dense is not None:
                        mags = dense["mags"][k]
                        signs = dense["signs"][k]
                    elif k in fb_dense:
                        mags = fb_dense[k]["mags"]
                        signs = fb_dense[k]["signs"]
                    elif dense_ll is not None:
                        mags = np.abs(dense_ll[k])
                        signs = dense_ll[k] >= 0
                    else:
                        mags = np.zeros(n, dtype=np.int32)
                        signs = np.ones(n, dtype=bool)
                        if sparse is not None:
                            m = int(nnz[k])
                            ki = sparse["idx"][k][:m]
                            kv = sparse["vals"][k][:m]
                        else:
                            f = fb_sparse[k]
                            m = f["nnz"]
                            ki, kv = f["idx"][:m], f["vals"][:m]
                        mags[ki] = np.abs(kv)
                        signs[ki] = kv >= 0
                    body = self.engine.encode(
                        3, mags, signs, (lx, ly, lz), width, budget
                    )
                out_stream = b""
                if mode == "pwe":
                    def _ll_row():
                        if dense is not None:
                            mg = dense["mags"][k].astype(np.int64)
                            return np.where(dense["signs"][k], mg, -mg)
                        if dense_ll is not None:
                            return dense_ll[k].astype(np.int64)
                        if k in fb_dense:
                            mg = fb_dense[k]["mags"].astype(np.int64)
                            return np.where(fb_dense[k]["signs"], mg, -mg)
                        ll = np.zeros(n, dtype=np.int64)
                        if sparse is not None:
                            m = int(nnz[k])
                            ll[sparse["idx"][k][:m]] = sparse["vals"][k][:m]
                        elif k in fb_sparse:
                            f = fb_sparse[k]
                            m = f["nnz"]
                            ll[f["idx"][:m]] = f["vals"][:m]
                        else:
                            # wave path: the exposure compaction's sparse
                            # coefficient view (nonzeros are a subset of
                            # the exposed pixels)
                            m = int(wv["n_exp"][wk])
                            ll[wv["exp_idx"][wk][:m]] = wv["exp_ll"][wk][:m]
                        return ll

                    def _orig_row():
                        return np.ascontiguousarray(
                            loader(chunks[gi]), dtype=np.float64
                        ).ravel()

                    def _dev_scan():
                        if dense is not None or k in fb_dense:
                            dd = dense if dense is not None else fb_dense[k]
                            mask = (
                                dd["outlier_mask"][k]
                                if dense is not None
                                else dd["outlier_mask"]
                            )
                            dv = dd["diff"][k] if dense is not None else dd["diff"]
                            p = np.flatnonzero(mask)
                            return p, np.asarray(dv[p], dtype=np.float64)
                        if sparse is not None:
                            m = int(n_out[k])
                            return (
                                sparse["out_idx"][k][:m],
                                np.asarray(
                                    sparse["out_vals"][k][:m],
                                    dtype=np.float64,
                                ),
                            )
                        if k in fb_sparse:
                            f = fb_sparse[k]
                            m = f["n_out"]
                            return (
                                f["out_idx"][:m],
                                np.asarray(
                                    f["out_vals"][:m], dtype=np.float64
                                ),
                            )
                        m = int(n_out[k])
                        return (
                            wout_idx[k][:m],
                            np.asarray(wout_vals[k][:m], dtype=np.float64),
                        )

                    host_resid = resid_mode == "none" or (
                        resid_mode == "margin"
                        and (dense is not None or bool(margin_bad[k]))
                    )
                    if resid_mode == "dual":
                        # union of the exact-f64 scan and the device's
                        # decoder-exact f32 scan, per-point certified for
                        # both decoders (see _certify_dual)
                        eta = float(small["eta_sim"][k])
                        kappa = float(small["kappa"][k])
                        pos64, errs64 = _residual_outliers(
                            _ll_row(), (lx, ly, lz), q, mean, _orig_row(),
                            float(quality) - kappa,
                        )
                        pos32, errs32 = _dev_scan()
                        pos, errs, cert_ok = _certify_dual(
                            pos64, errs64, pos32, errs32,
                            float(quality), eta, q,
                        )
                        if not (cert_ok and eta <= 0.125 * float(quality)):
                            uncertified[gi] = 1
                    elif host_resid:
                        # strict: exact f64 decoder-visible residual on host
                        pos, errs = _residual_outliers(
                            _ll_row(), (lx, ly, lz), q, mean, _orig_row(),
                            float(quality),
                        )
                    else:
                        pos, errs = _dev_scan()
                    if pos.size:
                        out_stream = outlier_mod.encode_outliers(
                            pos, errs, n, float(quality)
                        )
                return condi + body + out_stream

            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                for k, s in enumerate(pool.map(encode_one, range(len(idxs)))):
                    streams[idxs[k]] = s

        self.last_wave_chunks = sum(wave_used)
        # chunks whose f32-device-decode PWE bound could not be certified
        # (dual mode only; the exact-f64 bound still holds for them); the
        # ids let CLI/--print_stats name the affected chunks
        self.last_uncertified_chunks = sum(uncertified)
        self.last_uncertified_ids = [
            i for i, u in enumerate(uncertified) if u
        ]
        return streams

    def _wave_fits(self, wave, k: int) -> bool:
        """True when chunk row k's device emission fit every cap.

        The device computes the verdict itself (`fits` = node cap honored
        and no piece/byte overflow in masked_pack); num_bp > num_bp_cap
        additionally routes to the host engine (never to a wider tier)."""
        return bool(wave["fits"][k]) and int(
            wave["num_bp"][k]
        ) <= self.num_bp_cap

    def _stitch_wave(self, wave, k: int, dims3, budget: int) -> bytes:
        """Host half of the device-entropy path: pure per-pass concatenation
        of the device's packed LIP / LIS / refinement segments plus the
        stream header (byte-identical to the host engines) — the SPECK bits
        were all computed on the device."""
        from ..codec import speck_wave as sw

        num_bp = int(wave["num_bp"][k])
        if num_bp == 0:
            return sw._pack_stream(np.empty(0, np.uint8), 0, 0)

        # packed buffer layout (ops/wave_pack.py): CLASS-major rows — all
        # LIP passes, then LIS, then refinement — each row byte-aligned
        P = int(wave["bp_cap"])
        counts = wave["counts"][k].astype(np.int64)  # [3 * num_bp_cap]
        buf = wave["seg"][k]
        bc = (counts + 7) // 8
        offs = np.cumsum(bc) - bc

        def seg(p, c):
            b = c * P + p
            return np.unpackbits(
                buf[offs[b] : offs[b] + bc[b]], bitorder="little"
            )[: int(counts[b])]

        lip_segments = [seg(p, 0) for p in range(num_bp)]
        lis_segments = [seg(p, 1) for p in range(num_bp)]
        ref_segments = [seg(p, 2) for p in range(num_bp)]
        return sw.stitch_3d(
            None, None, None, dims3, num_bp,
            lip_segments, ref_segments, budget,
            lis_segments=lis_segments,
        )


@partial(jax.jit, static_argnames=("p_cap", "evw_cap"))
def _hybrid_mags_batched(spass, words, roff, ravail, nbp, p_cap: int,
                         evw_cap: int):
    """Device half of the hybrid SPECK decode (ops/wave_unpack) over a
    chunk batch: lax.scan over chunks, NOT vmap — each iteration traces
    the flat per-chunk compactions/gathers and the working set stays one
    chunk's.
    Returns (mags i32[B, n], overflow bool[B])."""
    from ..ops import wave_unpack as wup

    B = spass.shape[0]

    def one(sp, w, ro, ra, nb):
        return wup.reconstruct_mags(sp, w, ro, ra, nb, p_cap, evw_cap)

    if B == 1:
        m, ovf = one(spass[0], words[0], roff[0], ravail[0], nbp[0])
        return m[None], ovf[None]

    def body(carry, xs):
        sp, w, ro, ra, nb = xs
        return carry, one(sp, w, ro, ra, nb)

    _, (m, ovf) = jax.lax.scan(
        body, jnp.int32(0), (spass, words, roff, ravail, nbp)
    )
    return m, ovf


class TpuDecompressor3D:
    """Chunked 3D decompressor: host SPECK parse, device-batched
    reconstruction.

    ``hybrid``: how the per-chunk SPECK streams are consumed.
      None (auto) — on an accelerator backend, the host runs the native
        engine's CONTROL-ONLY parse (LIP/LIS bits walked, refinement
        segments skipped — their lengths are the LSP population) and the
        device distributes refinement bits + reconstructs magnitudes
        (ops/wave_unpack.reconstruct_mags), roughly halving the
        bit-serial host work per chunk (reference hot loop:
        SPECK_INT.cpp:166-228).  On the CPU backend the full host parse
        runs: there the "device" half competes for the parse's cores.
      True / False — force the split / the full host parse.
    Streams deeper than 32 bitplanes, engines without the control entry
    point, and chunks whose active-word count exceeds the device cap all
    fall back to the full host parse per chunk — outputs are identical
    either way (asserted in tests/test_wave_unpack.py and the driver
    equality tests)."""

    def __init__(self, mesh: Optional[Mesh] = None, dtype=jnp.float32, engine=None,
                 num_threads: Optional[int] = None,
                 hybrid: Optional[bool] = None):
        self.mesh = mesh
        self.dtype = dtype
        self.engine = engine or default_engine()
        self.num_threads = num_threads
        self.hybrid = hybrid
        self.hierarchy: List[np.ndarray] = []
        # per-decompress observability: chunks decoded via the hybrid
        # split vs the full host parse
        self.last_hybrid_chunks = 0

    def _hybrid_enabled(self) -> bool:
        if not hasattr(self.engine, "decode3d_control"):
            return False
        if self.hybrid is not None:
            return bool(self.hybrid)
        return jax.default_backend() != "cpu"

    def decompress(
        self,
        stream: bytes,
        to_host: bool = True,
        multi_res: bool = False,
        only: Optional[Sequence[int]] = None,
    ) -> Tuple[object, Tuple[int, int, int]]:
        """Decode a container stream.

        to_host=True returns a numpy volume.  to_host=False keeps the
        reconstruction device-resident and returns a dict
        {(z0,y0,x0,lz,ly,lx) -> jax.Array} of chunk blocks — for device-side
        consumers the decompressed field feeds device computation directly
        and never pays the device->host transfer.

        multi_res=True additionally assembles the coarse-resolution
        hierarchy (device-side partial IDWT, SPERR3D_OMP_D.cpp:117-126)
        into `self.hierarchy`, ordered coarsest-first to match
        utils.dims.coarsened_resolutions_chunked.  Requires to_host=True.

        `only`: optional chunk-id subset to decode (the multi-host seam:
        each process decodes the chunks it owns, parallel.distributed
        gathers/scatters — SPERR3D_OMP_D.cpp:101-127 across hosts).
        Use with to_host=False; with to_host=True the volume outside the
        selected chunks is uninitialized.
        """
        if multi_res and not to_host:
            raise ValueError("multi_res decode requires to_host=True")
        if multi_res and only is not None:
            raise ValueError("multi_res decode does not support `only`")
        from ..utils.dims import coarsened_resolutions, coarsened_resolutions_chunked

        h = tools.parse_header(stream)
        nx, ny, nz = h.vol_dims
        chunks = chunk_volume(h.vol_dims, h.chunk_dims)
        vol = np.empty((nz, ny, nx), dtype=np.dtype(self.dtype)) if to_host else {}

        hierarchy: List[np.ndarray] = []
        hier_chunks: List = []
        if multi_res:
            vol_res = coarsened_resolutions_chunked(h.vol_dims, h.chunk_dims)
            chunk_res = coarsened_resolutions(h.chunk_dims)
            hierarchy = [
                np.empty((r[2], r[1], r[0]), dtype=np.dtype(self.dtype))
                for r in vol_res
            ]
            hier_chunks = [
                chunk_volume(vol_res[i], chunk_res[i]) for i in range(len(vol_res))
            ]

        keep = None if only is None else set(int(i) for i in only)
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        for i, c in enumerate(chunks):
            if keep is not None and i not in keep:
                continue
            groups.setdefault((c[5], c[3], c[1]), []).append(i)

        # memory-bounded sub-batching (see TpuCompressor3D.compress): the
        # decode path keeps ~3x the chunk bytes on device per call
        self.last_hybrid_chunks = 0
        for shape, idxs in _sub_batches(groups, 1 << 28, self.mesh):
            lz, ly, lx = shape
            n = lx * ly * lz
            B = len(idxs)
            mags = np.zeros((B, n), dtype=np.int32)
            signs = np.ones((B, n), dtype=bool)
            qs = np.zeros(B, dtype=np.float64)
            means = np.zeros(B, dtype=np.float64)
            consts: List[Optional[float]] = [None] * B
            outliers: List = [None] * B
            hyb: List[Optional[tuple]] = [None] * B
            use_hybrid = self._hybrid_enabled()

            def decode_one(k: int):
                import struct

                gi = idxs[k]
                off, ln = h.chunk_offsets[gi * 2], h.chunk_offsets[gi * 2 + 1]
                cs = stream[off : off + ln]
                condi = cs[:17]
                if cond_host.is_constant(condi[0]):
                    _, val = struct.unpack_from("<Qd", condi, 1)
                    consts[k] = val
                    return
                qs[k] = cond_host.retrieve_q(condi)
                (means[k],) = struct.unpack_from("<d", condi, 1)
                if not (qs[k] > 0.0 and np.isfinite(qs[k]) and np.isfinite(means[k])):
                    raise tools.StreamError(f"invalid conditioner q={qs[k]}")
                pos = 17
                num_bp = cs[pos]
                width = sp.uint_width_for_num_bitplanes(num_bp)
                full_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
                speck_len = min(full_len, len(cs) - pos)
                sbuf = cs[pos : pos + speck_len]
                if use_hybrid and num_bp <= 32 and num_bp > 0:
                    # hybrid split: control-only parse here (refinement
                    # segments skipped), magnitudes reconstructed on
                    # device after the pool (_hybrid_mags_batched)
                    spass, sg, roff, ravail, nbp, _avail = (
                        self.engine.decode3d_control(
                            sbuf, (lx, ly, lz), width
                        )
                    )
                    signs[k] = sg
                    body = bytes(sbuf[9:])
                    hyb[k] = (spass, roff, ravail, nbp, body, sbuf)
                else:
                    m, g = self.engine.decode(
                        3, sbuf, (lx, ly, lz), width
                    )
                    mags[k] = m.astype(np.int32)
                    signs[k] = g
                pos += speck_len
                if pos + 9 <= len(cs):
                    o_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
                    if len(cs) - pos == o_len:
                        outliers[k] = outlier_mod.decode_outliers(
                            cs[pos : pos + o_len], n, qs[k] / 1.5
                        )

            def decode_i(k):
                try:
                    decode_one(k)
                except Exception as e:  # noqa: BLE001 - reduced below
                    return (idxs[k], e)

            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                first_chunk_failure(pool.map(decode_i, range(B)))

            orig_hyb = [k for k in range(B) if hyb[k] is not None]
            rec_m = None
            live: List[int] = []
            if orig_hyb:
                Bh = len(orig_hyb)
                evw_cap = max(1 << 16, n // 64)
                # bucket the pass-window width: most production streams
                # run <= 16 bitplanes, which halves the member-word arrays
                p_cap = 16 if max(hyb[k][3] for k in orig_hyb) <= 16 else 32
                spb = np.stack([hyb[k][0] for k in orig_hyb])
                rof = np.zeros((Bh, 32), np.int32)
                rav = np.zeros((Bh, 32), np.int32)
                nbps = np.zeros(Bh, np.int32)
                Wmax = 8
                for j, k in enumerate(orig_hyb):
                    _, roff, ravail, nbp, body, _ = hyb[k]
                    rof[j, :nbp] = roff.astype(np.int64)
                    rav[j, :nbp] = ravail.astype(np.int64)
                    nbps[j] = nbp
                    Wmax = max(Wmax, (len(body) + 11) // 4)
                wmat = np.zeros((Bh, Wmax), np.uint32)
                for j, k in enumerate(orig_hyb):
                    body = hyb[k][4]
                    wrd = np.frombuffer(
                        body + b"\0" * ((-len(body)) % 4 + 8), dtype="<u4"
                    )
                    wmat[j, : wrd.size] = wrd
                rec_m, ovf = _hybrid_mags_batched(
                    _place(spb, self.mesh),
                    _place(wmat, self.mesh),
                    _place(rof, self.mesh),
                    _place(rav, self.mesh),
                    _place(nbps, self.mesh),
                    p_cap, evw_cap,
                )
                ovf_np = np.asarray(jax.device_get(ovf))
                for j, k in enumerate(orig_hyb):
                    if bool(ovf_np[j]):
                        # active-word cap exceeded: full host parse for
                        # this chunk (identical output, just slower)
                        num_bp = hyb[k][3]
                        width = sp.uint_width_for_num_bitplanes(num_bp)
                        m, g = self.engine.decode(
                            3, hyb[k][5], (lx, ly, lz), width
                        )
                        mags[k] = m.astype(np.int32)
                        signs[k] = g
                        hyb[k] = None
                live = [k for k in orig_hyb if hyb[k] is not None]
                self.last_hybrid_chunks += len(live)

            if live and len(live) == B:
                dev_mags = rec_m
            elif live:
                # merge: host-parsed rows ship up, device rows stay put
                # (rec_m rows are in orig_hyb order)
                slots = [orig_hyb.index(k) for k in live]
                dev_mags = jnp.asarray(mags)
                dev_mags = dev_mags.at[jnp.asarray(live)].set(
                    rec_m[jnp.asarray(slots)]
                )
                dev_mags = _place(dev_mags, self.mesh)
            else:
                # Narrow the host->device transfer when magnitudes allow.
                if mags.size and mags.max() < 32768:
                    mags = mags.astype(np.int16)
                dev_mags = _place(mags, self.mesh)
            dev_signs = _place(signs, self.mesh)
            dt = np.dtype(self.dtype)
            hier_dev = None
            if multi_res:
                rec, hier_dev = _dense_decode_multires(
                    dev_mags, dev_signs,
                    jnp.asarray(qs, dtype=dt), jnp.asarray(means, dtype=dt),
                    (lz, ly, lx),
                )
            else:
                rec = _dense_decode(
                    dev_mags, dev_signs,
                    jnp.asarray(qs, dtype=dt), jnp.asarray(means, dtype=dt),
                    (lz, ly, lx),
                )

            if to_host:
                rech = np.array(jax.device_get(rec))
                hier_np = (
                    [np.asarray(jax.device_get(hl)) for hl in hier_dev]
                    if hier_dev is not None
                    else None
                )
                for k, gi in enumerate(idxs):
                    c = chunks[gi]
                    zz, yy, xx = (
                        slice(c[4], c[4] + c[5]),
                        slice(c[2], c[2] + c[3]),
                        slice(c[0], c[0] + c[1]),
                    )
                    if consts[k] is not None:
                        vol[zz, yy, xx] = consts[k]
                        if hier_np is not None:
                            for lev in range(len(hier_np)):
                                hc = hier_chunks[lev][gi]
                                hierarchy[lev][
                                    hc[4] : hc[4] + hc[5],
                                    hc[2] : hc[2] + hc[3],
                                    hc[0] : hc[0] + hc[1],
                                ] = consts[k]
                        continue
                    block = rech[k]
                    if outliers[k] is not None:
                        pos, corr = outliers[k]
                        flat = block.reshape(-1)
                        flat[pos] += corr.astype(flat.dtype)
                        block = flat.reshape(block.shape)
                    vol[zz, yy, xx] = block
                    if hier_np is not None:
                        for lev in range(len(hier_np)):
                            hc = hier_chunks[lev][gi]
                            hierarchy[lev][
                                hc[4] : hc[4] + hc[5],
                                hc[2] : hc[2] + hc[3],
                                hc[0] : hc[0] + hc[1],
                            ] = hier_np[lev][k]
            else:
                for k, gi in enumerate(idxs):
                    c = chunks[gi]
                    key = (c[4], c[2], c[0], c[5], c[3], c[1])
                    if consts[k] is not None:
                        vol[key] = jnp.full((c[5], c[3], c[1]), consts[k], dtype=dt)
                        continue
                    block = rec[k]
                    if outliers[k] is not None:
                        pos, corr = outliers[k]
                        flat = block.reshape(-1)
                        flat = flat.at[jnp.asarray(pos)].add(
                            jnp.asarray(corr, dtype=flat.dtype)
                        )
                        block = flat.reshape(block.shape)
                    vol[key] = block
        self.hierarchy = hierarchy
        return vol, h.vol_dims
