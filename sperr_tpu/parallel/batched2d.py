"""Device-batched 2D pipeline: many 2D fields as one device program.

The reference's 2D path (SPECK2D_FLT via sperr2d / sperr_comp_2d,
utilities/sperr2d.cpp:245-290) is strictly single-image, single-thread.
The device form batches B equal-shaped 2D fields (time steps, ensemble
members, z-slices) on a leading axis: condition -> 2D DWT -> q -> midtread
quantize [-> PWE dual residual scan] runs as ONE jitted program, shardable
over a `jax.sharding.Mesh` 'slices' axis.  Entropy:

  * "host": the native SPECK2D engine consumes the (compacted) quantized
    coefficients on a thread pool — stream-identical to the f32 device
    contract of the 3D driver.
  * "wave": the COMPLETE entropy stage on device — event-form LIP and
    refinement segments plus the quad/I-set walk
    (ops/speck_lis2_jax.lis2_segments_device); the host only concatenates
    byte-aligned segments (codec/speck_wave.stitch_2d with precomputed
    lis_segments).  Containers are byte-identical to "host", and the
    device->host entropy traffic is stream-sized.

PWE certification follows parallel/batched.py's dual scheme: the device
scans the residual of the decode program it ships (f32), the host scans
the exact f64 residual (the native 3D scanner with nz=1 — the reference's
wavelet-packet 3D transform of (nx, ny, 1) IS the 2D transform), and every
correction is certified against both.

Streams are reference-format 2D payloads: [10-byte header when requested]
‖ conditioner(17B) ‖ SPECK ‖ [outliers] (utilities/sperr2d.cpp:278-290).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec import outlier as outlier_mod
from ..codec import speck_int_np as sp
from ..ops import cdf97_jax as cdfj
from ..ops import condition as cond_host
from ..ops import quantize_jax as qzj
from ..runtime.engine import default_engine
from ..stream import tools
from .batched import (
    _certify_dual,
    _condi_header,
    _residual_outliers,
    _width_for,
)

_MODES = ("psnr", "pwe", "rate")
_WAVE_NEVER = 0x7FFF


def _encode_core2(batch, mode: str, quality: float, cap: int, out_cap: int,
                  residual: str):
    """2D analog of batched._encode_core; batch (B, ny, nx)."""
    B, ny, nx = batch.shape
    n = ny * nx
    flat = batch.reshape(B, n)
    dt = batch.dtype

    v0 = flat[:, 0:1]
    is_const = jnp.all(flat == v0, axis=1)
    mean = jnp.mean(flat, axis=1)
    conditioned = flat - mean[:, None]

    coeffs = cdfj.dwt2d(conditioned.reshape(batch.shape)).reshape(B, n)

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

    def compact(row):
        # payload-carrying sort compaction (see batched._encode_core)
        key = jnp.where(row != 0, jnp.arange(n, dtype=jnp.int32), n)
        key_s, val_s = jax.lax.sort((key, row), num_keys=1, is_stable=False)
        idx = key_s[:cap]
        return idx, jnp.where(idx < n, val_s[:cap], 0)

    idx, vals = jax.vmap(compact)(ll)
    out = dict(
        is_const=is_const, v0=v0[:, 0], mean=mean, q=q,
        nnz=nnz, idx=idx, vals=vals, maxmag=maxmag,
    )

    if mode == "pwe" and residual != "none":
        signs = ll >= 0
        mags = jnp.abs(ll)
        rec = qzj.midtread_inv_quantize_batched(mags, signs, q)
        rec = cdfj.idwt2d(rec.reshape(batch.shape)).reshape(B, n)
        if residual == "dual":
            # decoder-exact composition (see _dense_decode2) + guard window
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
        else:
            diff = conditioned - rec
            thr = dt.type(quality)
        omask = jnp.abs(diff) > thr
        out["n_out"] = jnp.sum(omask, axis=1).astype(jnp.int32)

        def compact_out(m, d):
            key = jnp.where(m, jnp.arange(n, dtype=jnp.int32), n)
            key_s, d_s = jax.lax.sort((key, d), num_keys=1, is_stable=False)
            oi = key_s[:out_cap]
            return oi, jnp.where(oi < n, d_s[:out_cap], 0.0)

        out["out_idx"], out["out_vals"] = jax.vmap(compact_out)(omask, diff)
    return out, ll


@partial(jax.jit, static_argnames=("mode", "quality", "cap", "out_cap", "residual"))
def _dense_encode2(batch, mode: str, quality: float, cap: int, out_cap: int,
                   residual: str = "dual"):
    out, _ = _encode_core2(batch, mode, quality, cap, out_cap, residual)
    return out


@partial(
    jax.jit,
    static_argnames=("mode", "quality", "cap", "out_cap", "num_bp_cap", "dims2",
                     "residual", "node_cap", "ev_cap", "wave_cap"),
)
def _dense_encode2_wave(batch, mode: str, quality: float, cap: int, out_cap: int,
                        num_bp_cap: int, dims2: Tuple[int, int],
                        residual: str = "dual", node_cap: int = 1024,
                        ev_cap: int = 4096, wave_cap: int = 0):
    """2D dense stages + the COMPLETE device entropy stage: event-form LIP
    and refinement segments (ops/speck_jax.pass_segments_events) plus the
    quad/I-set walk (ops/speck_lis2_jax.lis2_segments_device) all on the
    device; the host only concatenates byte-aligned segments.  Mirrors the
    3D _dense_encode_wave — device->host entropy traffic is stream-sized."""
    from ..ops import speck_jax as sj
    from ..ops import speck_lis2_jax as sl2
    from ..codec.speck_wave import build_tree2

    from ..ops import wave_pack as wp

    out, ll = _encode_core2(batch, mode, quality, cap, out_cap, residual)
    B, n = ll.shape
    nx, ny = dims2
    ti = sj.tree_index(dims2)
    li2 = sl2.lis2_index(dims2)
    tree2 = build_tree2(dims2)
    wave_cap = n if wave_cap <= 0 else min(wave_cap, n)
    cap_total = min(n, (2 * wave_cap * (num_bp_cap + 4)) // 8 + 8)
    # pixel classes (LIP + refinement) run the 3D path's prefix-pack form
    # (ops/wave_pack.wave_emit_2d_pixels); only the quad/I-set walk stays
    # event-form.  PX_BP bounds their bitplane axis — deeper fields fall
    # back to the host engine via the fits check.
    px_bp = min(num_bp_cap, 18)
    wexp_px = wave_cap if wave_cap < n else 0
    npad_px = -(-(wexp_px or n) // 256) * 256
    px_cells = px_bp * 3 * npad_px
    px_evb = px_cells // 256
    px_out = min(((px_cells // 8 + 2 * px_bp) // 4 + 1) * 4, 4 * n)

    def one(row, sgn_row):
        mags = jnp.abs(row).astype(jnp.uint32)
        pm = sj.msbp1_device(mags)
        num_bp = jnp.max(pm)
        s, e, nm = sj.pixel_schedule(mags, ti, num_bp)
        pxseg, px_c, px_total, px_over = wp.wave_emit_2d_pixels(
            mags, sgn_row, s, e, num_bp, px_bp, px_evb, px_out, wexp_px
        )
        px_over = px_over | (num_bp > px_bp)
        node_s = jnp.where(nm > 0, num_bp - nm, _WAVE_NEVER).astype(jnp.int32)
        iset_s = sl2.iset_significance_device(
            pm.reshape(ny, nx), tree2, num_bp
        )
        lis_buf, lis_c, lis_total, n_sig = sl2.lis2_segments_device(
            node_s, s, sgn_row, num_bp, iset_s, li2, num_bp_cap, node_cap,
            ev_cap, cap_total,
        )
        return (
            num_bp.astype(jnp.int32), pxseg, px_c, px_total,
            px_over, lis_buf, lis_c, lis_total, n_sig,
        )

    signs = ll >= 0
    if B == 1:
        res = tuple(x[None] for x in one(ll[0], signs[0]))
    else:
        # scan, not vmap: flat per-field sorts (see batched.py)
        def body(carry, xs):
            row, sgn_row = xs
            return carry, one(row, sgn_row)

        _, res = jax.lax.scan(body, jnp.int32(0), (ll, signs))
    out["wave"] = dict(
        num_bp=res[0], px=res[1], px_c=res[2], px_total=res[3],
        px_over=res[4],
        lis=res[5], lis_c=res[6], lis_total=res[7], n_sig=res[8],
    )
    return out


@partial(jax.jit, static_argnames=("shape2",))
def _dense_decode2(mags, signs, q, mean, shape2):
    B = mags.shape[0]
    coeffs = qzj.midtread_inv_quantize_batched(mags, signs, q)
    rec = cdfj.idwt2d(coeffs.reshape((B,) + shape2))
    return rec + mean[:, None, None].astype(rec.dtype)


@partial(jax.jit, static_argnames=("shape2",))
def _dense_decode2_multires(mags, signs, q, mean, shape2):
    B = mags.shape[0]
    coeffs = qzj.midtread_inv_quantize_batched(mags, signs, q)
    rec, hier = cdfj.idwt2d_multi_res(coeffs.reshape((B,) + shape2))
    m = mean[:, None, None].astype(rec.dtype)
    return rec + m, tuple(h + m for h in hier)


class TpuCompressor2D:
    """Device-batched 2D compressor over equal-shaped fields.

    `dims`: (nx, ny).  `compress(field)` handles one field;
    `compress_batch(fields)` runs B fields as one jitted program (the
    device widening of the reference's single-image 2D path)."""

    def __init__(
        self,
        dims: Tuple[int, int],
        mesh: Optional[Mesh] = None,
        dtype=jnp.float32,
        engine=None,
        num_threads: Optional[int] = None,
        entropy: str = "host",
        pwe_strict: bool = True,
        with_header: bool = False,
    ):
        assert entropy in ("host", "wave")
        self.dims = (int(dims[0]), int(dims[1]))
        self.mesh = mesh
        self.dtype = dtype
        self.engine = engine or default_engine()
        self.num_threads = num_threads
        self.entropy = entropy
        self.pwe_strict = pwe_strict
        self.with_header = with_header
        self.num_bp_cap = 34
        # exact capacities: 2D fields are small, so the compaction buffers
        # are sized to never overflow (production tolerances make most
        # coefficients significant — the 3D path's measured regime)
        self.sparse_cap_frac = 1.0
        # event-cap ladder (multiples of n); see TpuCompressor3D.  Tier 0
        # is sized for the smooth regime (~0.6 n events per class at tol
        # 1e-2); overflowing fields retry at the wider tiers.
        self.wave_event_tiers = (1.25, 3, 8)
        # device-memory sub-batch budget, in elements per jit call
        self.elem_budget = 1 << 25
        self.last_wave_chunks = 0

    def _wave_fits(self, wave, k: int, n: int) -> bool:
        """True when field row k's device emission fit every cap."""
        nc, evc, wc = wave["caps"]
        cap_total = min(n, (2 * wc * (self.num_bp_cap + 4)) // 8 + 8)
        return (
            int(wave["n_sig"][k]) <= nc
            and not bool(wave["px_over"][k])
            and int(wave["num_bp"][k]) <= min(self.num_bp_cap, 18)
            and int(wave["lis_total"][k]) <= cap_total
        )

    def compress(self, field: np.ndarray, mode: str, quality: float) -> bytes:
        return self.compress_batch(np.asarray(field)[None], mode, quality)[0]

    def compress_batch(
        self, fields: np.ndarray, mode: str, quality: float
    ) -> List[bytes]:
        assert mode in _MODES
        nx, ny = self.dims
        n = nx * ny
        B = fields.shape[0]
        # memory-bounded sub-batching (see TpuCompressor3D.compress): the
        # wave path keeps ~40x the input footprint in device intermediates
        bmax = max(1, self.elem_budget // max(1, n))
        if self.mesh is not None and bmax > self.mesh.devices.size:
            bmax -= bmax % self.mesh.devices.size
        if B > bmax:
            fields = np.asarray(fields).reshape(B, ny, nx)
            out: List[bytes] = []
            wave_total = 0
            for s0 in range(0, B, bmax):
                out.extend(
                    self.compress_batch(fields[s0 : s0 + bmax], mode, quality)
                )
                wave_total += self.last_wave_chunks
            self.last_wave_chunks = wave_total
            return out
        batch = np.ascontiguousarray(
            np.asarray(fields).reshape(B, ny, nx), dtype=np.dtype(self.dtype)
        )
        is_float = np.asarray(fields).dtype == np.float32
        dev = jnp.asarray(batch)
        if self.mesh is not None and B % self.mesh.devices.size == 0:
            dev = jax.device_put(
                dev, NamedSharding(self.mesh, P("slices", None, None))
            )
        cap = max(1024, min(n, int(n * self.sparse_cap_frac)))
        out_cap = n if self.sparse_cap_frac >= 1.0 else max(256, n // 16)

        if mode != "pwe" or self.pwe_strict is False:
            resid_mode = "f32"
        elif self.pwe_strict == "f64":
            resid_mode = "none"
        else:
            resid_mode = "dual"
        uncertified = [0] * B
        wave_used = [0] * B

        wave = None
        wave_alt: Dict[int, dict] = {}
        if self.entropy == "wave":
            from ..ops import speck_jax as sj
            from ..ops import speck_lis2_jax as sl2

            # build static indexes outside the trace
            sj.tree_index((nx, ny))
            li2 = sl2.lis2_index((nx, ny))
            node_cap = li2.nn  # exact: the walk never overflows on nodes

            def fetch_wave(wdev, caps):
                # counts first, then total-trimmed fetches of the
                # concatenated segment buffers: device->host entropy
                # traffic is stream-sized
                w = {
                    k: np.asarray(jax.device_get(wdev[k]))
                    for k in ("num_bp", "px_c", "px_total", "px_over",
                              "lis_c", "lis_total", "n_sig")
                }
                w["caps"] = caps
                ctot = min(n, (2 * caps[2] * (self.num_bp_cap + 4)) // 8 + 8)
                b = min(
                    int(w["px_total"].max()) if w["px_total"].size else 0,
                    int(wdev["px"].shape[1]),
                )
                w["px"] = np.asarray(jax.device_get(wdev["px"][:, :b]))
                b = min(
                    int(w["lis_total"].max()) if w["lis_total"].size else 0,
                    ctot,
                )
                w["lis"] = np.asarray(jax.device_get(wdev["lis"][:, :b]))
                return w

            # event-cap ladder: the first tier runs the whole batch; fields
            # that overflow retry one at a time at later tiers (noise-like
            # data emits up to num_bp bits/pixel); only exhausted tiers
            # fall back to host entropy
            tiers = [max(4096, int(t * n)) for t in self.wave_event_tiers]
            res = _dense_encode2_wave(
                dev, mode, float(quality), cap, out_cap, self.num_bp_cap,
                (nx, ny), resid_mode, node_cap, tiers[0], n,
            )
            wave = fetch_wave(res.pop("wave"), (node_cap, tiers[0], n))
            for tier_cap in tiers[1:]:
                bad = [
                    k for k in range(B)
                    if not self._wave_fits(
                        *((wave_alt[k], 0) if k in wave_alt else (wave, k)),
                        n,
                    )
                    and int(wave["num_bp"][k]) <= self.num_bp_cap
                ]
                if not bad:
                    break
                for k in bad:
                    res_r = _dense_encode2_wave(
                        dev[k : k + 1], mode, float(quality), cap, out_cap,
                        self.num_bp_cap, (nx, ny), resid_mode, node_cap,
                        tier_cap, n,
                    )
                    wave_alt[k] = fetch_wave(
                        res_r.pop("wave"), (node_cap, tier_cap, n)
                    )
        else:
            res = _dense_encode2(
                dev, mode, float(quality), cap, out_cap, resid_mode
            )

        nnz = np.asarray(jax.device_get(res["nnz"]))
        small_keys = ["is_const", "v0", "mean", "q", "maxmag"]
        if resid_mode == "dual":
            small_keys += ["eta_sim", "kappa"]
        small = {k: np.asarray(jax.device_get(res[k])) for k in small_keys}
        dev_resid = mode == "pwe" and resid_mode != "none"
        n_out = np.asarray(jax.device_get(res["n_out"])) if dev_resid else None

        if (nnz > cap).any() or (n_out is not None and (n_out > out_cap).any()):
            raise ValueError(
                "2D compaction capacity exceeded; raise sparse_cap_frac "
                f"(nnz max {int(nnz.max())} > cap {cap} or outliers "
                f"{int(n_out.max()) if n_out is not None else 0} > {out_cap})"
            )
        sparse = {
            "idx": np.asarray(jax.device_get(res["idx"])),
            "vals": np.asarray(jax.device_get(res["vals"])),
        }
        if dev_resid:
            sparse["out_idx"] = np.asarray(jax.device_get(res["out_idx"]))
            sparse["out_vals"] = np.asarray(jax.device_get(res["out_vals"]))

        budget = int(quality * n) if mode == "rate" else 0
        hdr = (
            tools.generate_2d_header(self.dims, is_float)
            if self.with_header
            else b""
        )

        def encode_one(k: int) -> bytes:
            if bool(small["is_const"][k]):
                return hdr + _condi_header(True, float(small["v0"][k]), n, 0.0, 0.0)
            q = (
                1.5 * float(quality)
                if mode == "pwe" and resid_mode in ("none", "dual")
                else float(small["q"][k])
            )
            mean = float(small["mean"][k])
            condi = _condi_header(False, 0.0, 0, mean, q)

            m = int(nnz[k])
            wv, wk = (wave_alt[k], 0) if k in wave_alt else (wave, k)
            use_wave = wv is not None and self._wave_fits(wv, wk, n)
            if use_wave:
                wave_used[k] = 1
                body = self._stitch_wave2(wv, wk, budget)
            else:
                mags = np.zeros(n, dtype=np.int32)
                sgn = np.ones(n, dtype=bool)
                ki, kv = sparse["idx"][k][:m], sparse["vals"][k][:m]
                mags[ki] = np.abs(kv)
                sgn[ki] = kv >= 0
                width = _width_for(int(small["maxmag"][k]))
                body = self.engine.encode(2, mags, sgn, (nx, ny, 1), width, budget)

            out_stream = b""
            if mode == "pwe":
                ll = np.zeros(n, dtype=np.int64)
                ll[sparse["idx"][k][:m]] = sparse["vals"][k][:m]
                orig = np.asarray(batch[k], dtype=np.float64).ravel()
                if resid_mode == "dual":
                    eta = float(small["eta_sim"][k])
                    kappa = float(small["kappa"][k])
                    pos64, errs64 = _residual_outliers(
                        ll, (nx, ny, 1), q, mean, orig, float(quality) - kappa
                    )
                    mo = int(n_out[k])
                    pos32 = sparse["out_idx"][k][:mo]
                    errs32 = np.asarray(
                        sparse["out_vals"][k][:mo], dtype=np.float64
                    )
                    pos, errs, cert_ok = _certify_dual(
                        pos64, errs64, pos32, errs32, float(quality), eta, q
                    )
                    if not (cert_ok and eta <= 0.125 * float(quality)):
                        uncertified[k] = 1
                elif resid_mode == "none":
                    pos, errs = _residual_outliers(
                        ll, (nx, ny, 1), q, mean, orig, float(quality)
                    )
                else:
                    mo = int(n_out[k])
                    pos = sparse["out_idx"][k][:mo]
                    errs = np.asarray(sparse["out_vals"][k][:mo], dtype=np.float64)
                if len(pos):
                    out_stream = outlier_mod.encode_outliers(
                        pos, errs, n, float(quality)
                    )
            return hdr + condi + body + out_stream

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            streams = list(pool.map(encode_one, range(B)))
        self.last_uncertified_chunks = sum(uncertified)
        self.last_wave_chunks = sum(wave_used)
        return streams

    def _stitch_wave2(self, wave, k: int, budget: int) -> bytes:
        """Host half of the 2D device-entropy path: pure per-pass
        concatenation of the device's packed LIP / LIS / refinement
        segments — the quad/I-set walk bits were computed on the device
        (ops/speck_lis2_jax.py)."""
        from ..codec import speck_wave as sw

        nx, ny = self.dims
        num_bp = int(wave["num_bp"][k])
        if num_bp == 0:
            return sw._pack_stream(np.empty(0, np.uint8), 0, 0)

        def unconcat(buf, bit_counts):
            bc = (bit_counts.astype(np.int64) + 7) // 8
            offs = np.cumsum(bc) - bc
            return [
                np.unpackbits(
                    buf[offs[p] : offs[p] + bc[p]], bitorder="little"
                )[: int(bit_counts[p])]
                for p in range(num_bp)
            ]

        # pixel classes come packed class-major (LIP rows then refinement
        # rows, P = the px bitplane cap) from wave_emit_2d_pixels
        P = min(self.num_bp_cap, 18)
        px_c = wave["px_c"][k].astype(np.int64)
        pbc = (px_c + 7) // 8
        poffs = np.cumsum(pbc) - pbc
        pbuf = wave["px"][k]

        def pseg(p, cls):
            b = cls * P + p
            return np.unpackbits(
                pbuf[poffs[b] : poffs[b] + pbc[b]], bitorder="little"
            )[: int(px_c[b])]

        lip_segments = [pseg(p, 0) for p in range(num_bp)]
        ref_segments = [pseg(p, 1) for p in range(num_bp)]
        lis_segments = unconcat(wave["lis"][k], wave["lis_c"][k])
        return sw.stitch_2d(
            None, None, None, (nx, ny), num_bp,
            lip_segments, ref_segments, budget,
            lis_segments=lis_segments,
        )


class TpuDecompressor2D:
    """Device-batched 2D decompressor (host entropy decode + device IDWT)."""

    def __init__(self, dims: Tuple[int, int], mesh: Optional[Mesh] = None,
                 dtype=jnp.float32, engine=None,
                 num_threads: Optional[int] = None):
        self.dims = (int(dims[0]), int(dims[1]))
        self.mesh = mesh
        self.dtype = dtype
        self.engine = engine or default_engine()
        self.num_threads = num_threads
        self.hierarchy: List[List[np.ndarray]] = []

    def decompress(
        self, stream: bytes, multi_res: bool = False, with_header: bool = False
    ) -> np.ndarray:
        return self.decompress_batch(
            [stream], multi_res=multi_res, with_header=with_header
        )[0]

    def decompress_batch(
        self, streams: List[bytes], multi_res: bool = False,
        with_header: bool = False,
    ) -> List[np.ndarray]:
        import struct

        nx, ny = self.dims
        n = nx * ny
        B = len(streams)
        mags = np.zeros((B, n), dtype=np.int32)
        signs = np.ones((B, n), dtype=bool)
        qs = np.zeros(B, dtype=np.float64)
        means = np.zeros(B, dtype=np.float64)
        consts: List[Optional[float]] = [None] * B
        outliers: List = [None] * B

        def decode_one(k: int):
            cs = bytes(streams[k])
            if with_header:
                (hx, hy), _ = tools.parse_2d_header(cs)
                assert (hx, hy) == (nx, ny), "2D header dims mismatch"
                cs = cs[10:]
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
            m, g = self.engine.decode(2, cs[pos : pos + speck_len], (nx, ny, 1), width)
            mags[k] = m.astype(np.int32)
            signs[k] = g
            pos += speck_len
            if pos + 9 <= len(cs):
                o_len = sp.speck_int_stream_full_len(cs[pos : pos + 9])
                if len(cs) - pos == o_len:
                    outliers[k] = outlier_mod.decode_outliers(
                        cs[pos : pos + o_len], n, qs[k] / 1.5
                    )

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            list(pool.map(decode_one, range(B)))

        if mags.size and mags.max() < 32768:
            mags = mags.astype(np.int16)
        dt = np.dtype(self.dtype)
        dev_mags = jnp.asarray(mags)
        dev_signs = jnp.asarray(signs)
        if self.mesh is not None and B % self.mesh.devices.size == 0:
            sh = NamedSharding(self.mesh, P("slices", None))
            dev_mags = jax.device_put(dev_mags, sh)
            dev_signs = jax.device_put(dev_signs, sh)
        if multi_res:
            rec, hier = _dense_decode2_multires(
                dev_mags, dev_signs, jnp.asarray(qs, dtype=dt),
                jnp.asarray(means, dtype=dt), (ny, nx),
            )
            hier_np = [np.asarray(jax.device_get(h)) for h in hier]
        else:
            rec = _dense_decode2(
                dev_mags, dev_signs, jnp.asarray(qs, dtype=dt),
                jnp.asarray(means, dtype=dt), (ny, nx),
            )
            hier_np = []
        rech = np.array(jax.device_get(rec))

        out: List[np.ndarray] = []
        self.hierarchy = []
        for k in range(B):
            if consts[k] is not None:
                out.append(np.full((ny, nx), consts[k], dtype=dt))
                self.hierarchy.append(
                    [np.full(h.shape[1:], consts[k], dtype=dt) for h in hier_np]
                )
                continue
            block = rech[k]
            if outliers[k] is not None:
                pos, corr = outliers[k]
                flat = block.reshape(-1)
                flat[pos] += corr.astype(flat.dtype)
                block = flat.reshape(ny, nx)
            out.append(block)
            self.hierarchy.append([h[k] for h in hier_np])
        return out
