"""Device SPECK emission via prefix-pack dense matrices (round-4 rebuild).

Replaces the event-list emission (ops/speck_jax.lip_events / ref_events /
events_to_segments_merged + the LIS interval expansion) with three dense
[pass, position] boolean matrices packed by ops/packemit.masked_pack:

  * LIP:        [P, 2n]  (decision, sign) cell pairs per pixel — a pixel
                emits a membership bit at every pass in (e, s] and its
                sign right after the decision that turns it significant
                (reference SPECK_INT.cpp:111-163 LIP walk);
  * LIS:        [P, 2T]  per walk-ordered item (entry membership bits /
                child-row decision + sign), straight from the set walk's
                sorted payload words (ops/speck_lis_jax.py);
  * refinement: [P, n]   magnitude bit (num_bp-1-p) for pixels with
                s < p (SPECK_INT.cpp:311-357).

Because SPECK's within-pass order is ascending position, row-major order
of each matrix IS stream order — the whole entropy stage needs no event
sort and no interval expansion; everything data-dependent runs at the
compressed-information scale inside masked_pack.  Output segments are
byte-aligned per (class, pass) row, class-major (all LIP passes, then
LIS, then refinement), byte-identical to the host engines after host
concatenation (parallel/batched.TpuCompressor3D._stitch_wave).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import packemit as pe

_NEVER = 0x7FFF


class WaveEmit(NamedTuple):
    num_bp: jnp.ndarray       # i32
    seg: jnp.ndarray          # u8[out_cap_bytes] packed class-major buffer
    counts: jnp.ndarray       # i32[3 * P], P = the num_bp_cap ARGUMENT
                              # passed to wave_emit_3d (the tier's bp_cap);
                              # consumers must index with that same P
    total_bytes: jnp.ndarray  # i32
    n_sig: jnp.ndarray        # i32 (poisoned past node_cap on overflow)
    overflow: jnp.ndarray     # bool (piece or byte cap exceeded)
    n_nz: jnp.ndarray         # i32 non-empty pieces (occupancy signal)
    # sparse coefficient view from the exposure compaction (wexp_cap > 0;
    # empty arrays otherwise): nonzero coefficients are a subset of the
    # exposed pixels, so these replace a separate nonzero compaction for
    # the host's PWE f64 residual scan.  idx ascending, sentinel n.
    exp_idx: jnp.ndarray      # i32[wexp_cap] pixel indices
    exp_ll: jnp.ndarray       # i32[wexp_cap] signed quantized values
    n_exp: jnp.ndarray        # i32 exposed-pixel count


def _pad_cols(a: jnp.ndarray, cols: int, fill) -> jnp.ndarray:
    have = a.shape[-1]
    if have == cols:
        return a
    pad = jnp.full(a.shape[:-1] + (cols - have,), fill, a.dtype)
    return jnp.concatenate([a, pad], axis=-1)


def _emit_words(masks_fn, P: int):
    """Packed (valid, bit) emission words [P, M//32] from per-cell pass
    masks: ``masks_fn(base)`` returns (mask_v, mask_b) u32[M] for the pass
    window [base, base+32) — bit (p - base) of cell i's mask is the cell's
    (valid, bit) value at pass p.  One 32x32 bit transpose per window
    replaces the [P, M] u8 cell matrices + matmul packs of the round-4 form:
    the construction cost is O(M) elementwise + ~10 relayout passes,
    independent of P."""
    vws, bws = [], []
    for base in range(0, P, 32):
        mv, mb = masks_fn(base)
        take = min(32, P - base)
        vws.append(pe.transpose_bits32(mv)[:take])
        bws.append(pe.transpose_bits32(mb)[:take])
    v = jnp.concatenate(vws) if len(vws) > 1 else vws[0]
    b = jnp.concatenate(bws) if len(bws) > 1 else bws[0]
    return v, b


def _emit_words_pair(masks_fn, P: int):
    """Pair-class variant: ``masks_fn(base)`` returns per-ITEM masks for
    the even (decision) and odd (sign) cell lanes (mvA, mbA, mvB, mbB);
    the interleaved cell stream transposes via
    packemit.transpose_bits32_pair without ever materializing a
    [M, 2]-minor interleave (the 64x layout trap)."""
    vws, bws = [], []
    for base in range(0, P, 32):
        mvA, mbA, mvB, mbB = masks_fn(base)
        take = min(32, P - base)
        vws.append(pe.transpose_bits32_pair(mvA, mvB)[:take])
        bws.append(pe.transpose_bits32_pair(mbA, mbB)[:take])
    v = jnp.concatenate(vws) if len(vws) > 1 else vws[0]
    b = jnp.concatenate(bws) if len(bws) > 1 else bws[0]
    return v, b


def wave_emit_3d(
    mags: jnp.ndarray,
    signs: jnp.ndarray,
    s: jnp.ndarray,
    e: jnp.ndarray,
    node_s: jnp.ndarray,
    num_bp: jnp.ndarray,
    li,
    num_bp_cap: int,
    node_cap: int,
    evb_cap: int,
    out_cap_bytes: int,
    wexp_cap: int = 0,
) -> WaveEmit:
    """Full SPECK bit emission for one chunk, prefix-pack form.

    Inputs are the per-pixel schedule (s, e from pixel_schedule*), the
    per-node significance passes (node_s), and the walk index ``li``
    (LisIndex / VirtualLisIndex).  All shapes static except data.

    ``wexp_cap`` > 0 compacts the EXPOSED pixels (e < num_bp — the only
    ones that ever emit LIP or refinement bits) before building the
    emission matrices: one flat 3-operand sort in ascending-index
    (emission) order shrinks the [P, n]-scale matrices to the exposed
    neighborhood (~2-6% of n at production tolerance on 256^3 chunks).
    Exposure overflow sets the overflow flag (tier retry).
    """
    from .speck_lis_jax import lis_segments_device

    n = mags.shape[0]
    P = num_bp_cap
    U0 = jnp.uint32(0)
    U1 = jnp.uint32(0xFFFFFFFF)
    uniform = getattr(li, "uniform_children", False)

    # Shared box-major pixel table: ONE relayout feeds the walk's child
    # value table AND the exposure compaction's value fetch.  Pixels pack
    # clip(s) | sign << 7 | mag << 8 (mag fits below bit 31 for bitplane
    # caps <= 23 — deeper tiers carry mags in a second relayout).
    pack_mag = P <= 23
    vtab = None
    pv_bm = mg_bm = None
    if uniform:
        s7 = jnp.clip(s, 0, 127)
        pv = s7 | (signs.astype(jnp.int32) << 7)
        if pack_mag:
            pv = pv | (
                jnp.minimum(mags.astype(jnp.int32), (1 << 23) - 1) << 8
            )
        pv_bm = li.box_major_pixels(pv)
        vtab = li.vtab_from(pv_bm, node_s)
        if not pack_mag and wexp_cap and wexp_cap < n:
            mg_bm = li.box_major_pixels(mags.astype(jnp.int32))

    # --- LIS items: the set walk, stopping at the walk-ordered payloads --
    pay_s, n_sig = lis_segments_device(
        node_s, s, signs, num_bp, li, num_bp_cap, node_cap,
        ev_cap=0, cap_total=0, return_events="items", vtab=vtab,
    )
    T = pay_s.shape[0]
    Tp = -(-T // 128) * 128
    pay_p = _pad_cols(pay_s[None, :], Tp, 0)[0]

    # (decision, sign) cell lanes as per-ITEM masks — the interleave
    # happens inside the paired transpose, never as a [T, 2] array
    is_ent = (pay_p & 1) == 1
    lo = (pay_p >> 1) & 63
    s6 = (pay_p >> 7) & 63
    sgn_i = (pay_p >> 13) & 1
    signow = (pay_p >> 14) & 1
    hs = (pay_p >> 15) & 1
    dec = (pay_p >> 16) & 1
    ok = (pay_p >> 17) & 1
    ent_hi = jnp.minimum(s6, num_bp - 1)

    def lis_masks(base):
        ent_v = jnp.where(ok == 1, pe.ones_span32(lo, ent_hi, base), U0)
        row_v0 = jnp.where(dec == 1, pe.bit_at32(lo, base), U0)
        mvA = jnp.where(is_ent, ent_v, row_v0)
        mbA = jnp.where(
            is_ent, pe.bit_at32(s6, base), jnp.where(signow == 1, U1, U0)
        )
        mvB = jnp.where(
            is_ent, U0, jnp.where(hs == 1, pe.bit_at32(lo, base), U0)
        )
        mbB = jnp.where(sgn_i == 1, U1, U0)
        return mvA, mbA, mvB, mbB

    # --- exposed-pixel compaction (optional) ------------------------------
    exp_over = jnp.zeros((), bool)
    exp_idx = jnp.zeros(0, jnp.int32)
    exp_ll = jnp.zeros(0, jnp.int32)
    n_exp = jnp.zeros((), jnp.int32)
    if wexp_cap and wexp_cap < n and uniform:
        # Exposure is a 2x2x2-BOX property in the uniform forest (every
        # pixel's parent is its aligned box, so e is box-constant):
        # compact exposed BOXES with the two-level form at n/8 scale,
        # row-gather their pixels from the SHARED box-major table (one
        # array when mags pack — bitplane caps <= 23), and restore
        # ascending-pixel emission order with one wexp-scale sort.
        N = li.dims[0]
        nbox = n // 8
        # e_cell = per-box exposure pass = box-min of s (NEVER boxes stay
        # NEVER): derived from s directly so the schedule's full-width e
        # broadcast is DEAD CODE in this program (XLA removes it)
        from .speck_virtual import box_reduce_min

        e_cell = box_reduce_min(
            jnp.where(s < _NEVER, s, _NEVER).reshape(N, N, N)
        ).reshape(-1)
        take_b = max(1, wexp_cap // 8)
        idx_box, n_box = pe.compact_flags_rows(
            (e_cell < num_bp)[None, :], take_b
        )
        idx_box = idx_box[0]
        n_exp = (8 * n_box[0]).astype(jnp.int32)
        exp_over = n_box[0] > take_b
        bok = idx_box < nbox
        bc = jnp.minimum(idx_box, nbox - 1)
        rows_p = pv_bm.reshape(-1, 8)[bc]     # [take_b, 8] row gathers
        eb = jnp.clip(jnp.where(bok, e_cell[bc], _NEVER), 0, 127)
        # linear pixel index per (box, slot): box (zb, yb, xb), slot dz dy dx
        lb = N.bit_length() - 2
        bz = bc >> (2 * lb)
        rem = bc & ((1 << (2 * lb)) - 1)
        by = rem >> lb
        bx = rem & ((1 << lb) - 1)
        slot8 = jnp.arange(8, dtype=jnp.int32)
        pz = (bz[:, None] << 1) + (slot8[None, :] >> 2)
        py = (by[:, None] << 1) + ((slot8[None, :] >> 1) & 1)
        px = (bx[:, None] << 1) + (slot8[None, :] & 1)
        lin = (pz * N + py) * N + px
        W8 = take_b * 8
        key = jnp.where(
            jnp.broadcast_to(bok[:, None], (take_b, 8)), lin, n
        ).reshape(W8)
        e8 = jnp.broadcast_to(eb[:, None], (take_b, 8)).reshape(W8)
        if pack_mag:
            key_s, pv_c, e_c = jax.lax.sort(
                (key, rows_p.reshape(W8), e8), num_keys=1, is_stable=False
            )
            mag_c = pv_c >> 8
        else:
            rows_m = mg_bm.reshape(-1, 8)[bc]
            key_s, pv_c, mag_c, e_c = jax.lax.sort(
                (key, rows_p.reshape(W8), rows_m.reshape(W8), e8),
                num_keys=1, is_stable=False,
            )
        npad = -(-wexp_cap // 256) * 256
        okm = jnp.arange(npad, dtype=jnp.int32) < n_exp
        pvp = _pad_cols(pv_c[None, :wexp_cap], npad, 0)[0]
        s_p = jnp.where(okm, pvp & 127, _NEVER)
        e_p = jnp.where(okm, _pad_cols(e_c[None, :wexp_cap], npad, 0)[0],
                        _NEVER)
        g_p = jnp.where(okm, (pvp >> 7) & 1, 0).astype(jnp.uint8)
        m_p = jnp.where(
            okm, _pad_cols(mag_c[None, :wexp_cap], npad, 0)[0], 0
        )
        # sparse coefficient view for the host (f64 residual scan): the
        # nonzero coefficients are a subset of the exposed pixels
        exp_idx = key_s[:wexp_cap]
        sgn_c = ((pvp >> 7) & 1) == 1
        exp_ll = jnp.where(okm, jnp.where(sgn_c, m_p, -m_p), 0)[:wexp_cap]
    elif wexp_cap and wexp_cap < n:
        exposed = e < num_bp
        key = jnp.where(exposed, jnp.arange(n, dtype=jnp.int32), n)
        pay = (
            jnp.clip(s, 0, 127)
            | (jnp.clip(e, 0, 127) << 7)
            | (signs.astype(jnp.int32) << 14)
        )
        key_s, pay_c, mag_c = jax.lax.sort(
            (key, pay, mags.astype(jnp.int32)), num_keys=1, is_stable=False
        )
        n_exp = jnp.sum(exposed).astype(jnp.int32)
        exp_over = n_exp > wexp_cap
        # 256-cell padding: every part's word count must be a multiple
        # of masked_pack's piece_words (the ref part is npad/32 words)
        npad = -(-wexp_cap // 256) * 256
        okm = jnp.arange(npad, dtype=jnp.int32) < n_exp
        pc = _pad_cols(pay_c[None, :wexp_cap], npad, 0)[0]
        s_p = jnp.where(okm, pc & 127, _NEVER)
        e_p = jnp.where(okm, (pc >> 7) & 127, _NEVER)
        g_p = jnp.where(okm, (pc >> 14) & 1, 0).astype(jnp.uint8)
        m_p = jnp.where(
            okm, _pad_cols(mag_c[None, :wexp_cap], npad, 0)[0], 0
        )
        exp_idx = key_s[:wexp_cap]
        sgn_c = ((pc >> 14) & 1) == 1
        exp_ll = jnp.where(okm, jnp.where(sgn_c, m_p, -m_p), 0)[:wexp_cap]
    else:
        npad = -(-n // 256) * 256
        s_p = _pad_cols(s[None, :], npad, _NEVER)[0]
        e_p = _pad_cols(e[None, :], npad, _NEVER)[0]
        g_p = _pad_cols(signs[None, :].astype(jnp.uint8), npad, 0)[0]
        m_p = _pad_cols(mags.astype(jnp.int32)[None, :], npad, 0)[0]

    # --- LIP masks (decision, sign cell lanes over npad items) -----------
    g_i = g_p.astype(jnp.int32)
    lip_hi = jnp.minimum(s_p, num_bp - 1)

    def lip_masks(base):
        mvA = pe.ones_span32(e_p + 1, lip_hi, base)
        mbA = pe.bit_at32(s_p, base)
        mvB = jnp.where(e_p < s_p, pe.bit_at32(s_p, base), U0)
        mbB = jnp.where(g_i == 1, U1, U0)
        return mvA, mbA, mvB, mbB

    # --- refinement masks (npad cells): bit p of the mask is magnitude
    # bit (num_bp-1-p), i.e. a bit reversal of m shifted to the ladder --
    mrev = pe.bitrev32(m_p.astype(jnp.uint32))
    nb_sh = (jnp.int32(32) - num_bp).astype(jnp.uint32)
    ref_bits = pe._safe_rsh(mrev, nb_sh)

    def ref_masks(base):
        mv = pe.ones_span32(s_p + 1, num_bp - 1, base)
        mb = (
            pe._safe_rsh(ref_bits, jnp.uint32(base))
            if base
            else ref_bits
        )
        return mv, mb

    parts = [
        _emit_words_pair(lip_masks, P),
        _emit_words_pair(lis_masks, P),
        _emit_words(ref_masks, P),
    ]
    res = pe.masked_pack(parts, evb_cap, out_cap_bytes)
    seg = pe.words_to_bytes(res.out_words)
    return WaveEmit(
        num_bp.astype(jnp.int32), seg, res.counts, res.total_bytes,
        n_sig, res.overflow | exp_over, res.n_nz,
        exp_idx, exp_ll, n_exp,
    )


def wave_emit_2d_pixels(
    mags: jnp.ndarray,
    signs: jnp.ndarray,
    s: jnp.ndarray,
    e: jnp.ndarray,
    num_bp: jnp.ndarray,
    px_bp_cap: int,
    evb_cap: int,
    out_cap_bytes: int,
    wexp_cap: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """LIP + refinement emission for the 2D path, prefix-pack form.

    The pixel-level classes are DIMENSION-INDEPENDENT (a pixel emits a
    membership bit per pass in (e, s], its sign at s, and magnitude bits
    below s — reference SPECK_INT.cpp:111-163/311-357 regardless of the
    set geometry), so this reuses the 3D machinery: per-item pass masks
    pivoted by the 32x32 bit transpose, packed by masked_pack.  Replaces
    the event-form pass_segments_events for the 2D driver.

    Returns (seg u8[out_cap_bytes], counts i32[2 * px_bp_cap] class-major
    LIP rows then refinement rows, total_bytes, overflow)."""
    n = mags.shape[0]
    P = px_bp_cap
    U0 = jnp.uint32(0)
    U1 = jnp.uint32(0xFFFFFFFF)

    exp_over = jnp.zeros((), bool)
    if wexp_cap and wexp_cap < n:
        exposed = e < num_bp
        key = jnp.where(exposed, jnp.arange(n, dtype=jnp.int32), n)
        pay = (
            jnp.clip(s, 0, 127)
            | (jnp.clip(e, 0, 127) << 7)
            | (signs.astype(jnp.int32) << 14)
        )
        key_s, pay_c, mag_c = jax.lax.sort(
            (key, pay, mags.astype(jnp.int32)), num_keys=1, is_stable=False
        )
        n_exp = jnp.sum(exposed).astype(jnp.int32)
        exp_over = n_exp > wexp_cap
        npad = -(-wexp_cap // 256) * 256
        okm = jnp.arange(npad, dtype=jnp.int32) < n_exp
        pc = _pad_cols(pay_c[None, :wexp_cap], npad, 0)[0]
        s_p = jnp.where(okm, pc & 127, _NEVER)
        e_p = jnp.where(okm, (pc >> 7) & 127, _NEVER)
        g_p = jnp.where(okm, (pc >> 14) & 1, 0)
        m_p = jnp.where(
            okm, _pad_cols(mag_c[None, :wexp_cap], npad, 0)[0], 0
        )
    else:
        npad = -(-n // 256) * 256
        s_p = _pad_cols(s[None, :], npad, _NEVER)[0]
        e_p = _pad_cols(e[None, :], npad, _NEVER)[0]
        g_p = _pad_cols(signs[None, :].astype(jnp.int32), npad, 0)[0]
        m_p = _pad_cols(mags.astype(jnp.int32)[None, :], npad, 0)[0]

    lip_hi = jnp.minimum(s_p, num_bp - 1)

    def lip_masks(base):
        mvA = pe.ones_span32(e_p + 1, lip_hi, base)
        mbA = pe.bit_at32(s_p, base)
        mvB = jnp.where(e_p < s_p, pe.bit_at32(s_p, base), U0)
        mbB = jnp.where(g_p == 1, U1, U0)
        return mvA, mbA, mvB, mbB

    mrev = pe.bitrev32(m_p.astype(jnp.uint32))
    nb_sh = (jnp.int32(32) - num_bp).astype(jnp.uint32)
    ref_bits = pe._safe_rsh(mrev, nb_sh)

    def ref_masks(base):
        mv = pe.ones_span32(s_p + 1, num_bp - 1, base)
        mb = (
            pe._safe_rsh(ref_bits, jnp.uint32(base)) if base else ref_bits
        )
        return mv, mb

    parts = [
        _emit_words_pair(lip_masks, P),
        _emit_words(ref_masks, P),
    ]
    res = pe.masked_pack(parts, evb_cap, out_cap_bytes)
    seg = pe.words_to_bytes(res.out_words)
    return seg, res.counts, res.total_bytes, res.overflow | exp_over


__all__ = ["wave_emit_3d", "wave_emit_2d_pixels", "WaveEmit"]
