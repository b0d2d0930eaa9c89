"""Device-side SPECK bitplane kernels (JAX).

Device complement to codec/speck_wave.py: the pixel-level parts of SPECK
encoding run as jitted array programs on the device —

  * ``pixel_schedule``: per-pixel msb+1 and exposure pass, via segment-max
    reductions over the static partition tree (the reference's Morton MSB
    deposit, SPECK3D_INT_ENC.cpp:142-159, as a device pyramid);
  * ``node_max``: per-set max msb+1 for every tree node (the set-significance
    oracle the host stitcher consumes — ships sparse, ~entropy-sized);
  * ``pass_segments``: for every bitplane pass, the packed LIP-walk and
    refinement-bit segments plus exact bit counts.

The host keeps only the set-partition walk (one decision bit per live set
per pass) and stitches ``LIP ‖ LIS ‖ refinement`` per pass — byte-identical
streams, with device→host traffic proportional to the compressed size, not
the volume.

All shapes are static per (dims, num_bp cap): jit-compatible, shardable over
a chunk-batch axis with vmap/shard_map.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.speck_wave import Tree, build_tree, build_tree2

_NEVER = 0x7FFF


class TreeIndex:
    """Static device-side index arrays derived from a codec Tree."""

    __slots__ = ("n", "nn", "depth_slices", "ch_vals_src", "ch_parent",
                 "px_linear", "px_parent")

    def __init__(self, tree):
        self.n = tree.n
        self.nn = tree.node_ch_start.size
        # For each depth (deepest first): the child-table slice, a gather
        # spec for child values, and the parent id per row.
        self.depth_slices = []
        for lo, hi in reversed(tree.node_depth_ranges):
            s0 = int(tree.node_ch_start[lo])
            s1 = int(tree.node_ch_start[hi - 1] + tree.node_ch_count[hi - 1])
            ispx = tree.ch_is_pixel[s0:s1]
            refs = tree.ch_ref[s0:s1]
            # child value = msbp1[px_linear[ref]] if pixel else node_max[ref]
            src_px = np.where(ispx, tree.px_linear[np.where(ispx, refs, 0)], 0)
            src_nd = np.where(ispx, 0, refs)
            parent_rows = np.repeat(
                np.arange(lo, hi), tree.node_ch_count[lo:hi]
            )
            self.depth_slices.append(
                (
                    jnp.asarray(ispx),
                    jnp.asarray(src_px),
                    jnp.asarray(src_nd),
                    jnp.asarray(parent_rows),
                    lo,
                    hi,
                )
            )
        self.px_linear = jnp.asarray(tree.px_linear)
        self.px_parent = jnp.asarray(tree.px_parent)


_INDEXES = {}


def tree_index(dims) -> TreeIndex:
    key = tuple(int(d) for d in dims)
    ti = _INDEXES.get(key)
    if ti is None:
        ti = TreeIndex(build_tree2(key) if len(key) == 2 else build_tree(key))
        _INDEXES[key] = ti
    return ti


def msbp1_device(mags: jnp.ndarray) -> jnp.ndarray:
    """msb position + 1 per element (0 for zero); int32 in, int32 out."""
    m = mags.astype(jnp.uint32)
    # 32 - clz by shifts (exact on every backend, no float exponent).
    out = jnp.zeros_like(m, dtype=jnp.int32)
    for shift in (16, 8, 4, 2, 1):
        big = m >= (jnp.uint32(1) << jnp.uint32(shift))
        out = out + jnp.where(big, shift, 0)
        m = jnp.where(big, m >> jnp.uint32(shift), m)
    return jnp.where(mags > 0, out + 1, 0)


def node_max(msbp1: jnp.ndarray, ti: TreeIndex) -> jnp.ndarray:
    """Max msb+1 per tree node — the set-significance oracle, computed as
    per-depth segment-max reductions with static index arrays."""
    nm = jnp.zeros(ti.nn, dtype=jnp.int32)
    for ispx, src_px, src_nd, parent_rows, lo, hi in ti.depth_slices:
        vals = jnp.where(ispx, msbp1[src_px], nm[src_nd])
        seg = jax.ops.segment_max(
            vals, parent_rows - lo, num_segments=hi - lo, indices_are_sorted=True
        )
        nm = jax.lax.dynamic_update_slice(nm, seg, (lo,))
    return nm


def pixel_schedule(
    mags: jnp.ndarray, ti: TreeIndex, num_bp: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-pixel (s, e) schedule in linear order plus per-node maxes.

    s = pass where the pixel becomes significant (NEVER for zero);
    e = pass where its parent set partitions, exposing it into LIP."""
    pm = msbp1_device(mags)
    nm = node_max(pm, ti)
    s = jnp.where(pm > 0, num_bp - pm, _NEVER).astype(jnp.int32)
    node_s = jnp.where(nm > 0, num_bp - nm, _NEVER).astype(jnp.int32)
    e = jnp.full((ti.n,), _NEVER, dtype=jnp.int32)
    e = e.at[ti.px_linear].set(node_s[ti.px_parent])
    return s, e, nm


@partial(jax.jit, static_argnames=("num_bp_cap",))
def pass_segments(
    mags: jnp.ndarray,
    signs: jnp.ndarray,
    s: jnp.ndarray,
    e: jnp.ndarray,
    num_bp: jnp.ndarray,
    num_bp_cap: int,
):
    """All LIP-walk and refinement segments, one row per bitplane pass.

    Returns (lip_bits u8[num_bp_cap, 2n], lip_counts i32[num_bp_cap],
             ref_bits u8[num_bp_cap, n], ref_counts i32[num_bp_cap]).
    Bit rows are left-compacted 0/1 values; count gives the valid prefix.
    Rows past num_bp are zero.  This is the device half of the wavefront
    encoder; the host stitches LIP ‖ LIS(sim) ‖ refinement per pass."""
    n = mags.shape[0]
    m64 = mags.astype(jnp.uint32)

    def one_pass(p):
        active = p < num_bp
        # --- LIP: members e < p <= s, ascending index; [dec, sign?] pairs
        memb = (e < p) & (s >= p) & active
        dec = memb & (s == p)
        pair_bits = jnp.stack([dec, signs & dec], axis=1)  # [n, 2] bool
        pair_valid = jnp.stack([memb, dec], axis=1)
        flat_bits = pair_bits.reshape(-1)
        flat_valid = pair_valid.reshape(-1)
        # left-compact: stable order by (!valid, position)
        order = jnp.argsort(~flat_valid, stable=True)
        lip_row = jnp.where(flat_valid[order], flat_bits[order], False)
        lip_count = jnp.sum(flat_valid)
        # --- refinement: members s < p, ascending index; plain binary digit
        rmemb = (s < p) & active
        shift = jnp.maximum(num_bp - 1 - p, 0).astype(jnp.uint32)
        rbit = ((m64 >> shift) & jnp.uint32(1)).astype(bool) & rmemb
        rorder = jnp.argsort(~rmemb, stable=True)
        ref_row = jnp.where(rmemb[rorder], rbit[rorder], False)
        ref_count = jnp.sum(rmemb)
        return (
            lip_row.astype(jnp.uint8),
            lip_count.astype(jnp.int32),
            ref_row.astype(jnp.uint8),
            ref_count.astype(jnp.int32),
        )

    return jax.vmap(one_pass)(jnp.arange(num_bp_cap))


_PACK_W_NP = None


def _pack_weight_np():
    """Constant (1024, 128) selector: W[i, i//8] = 2**(i%8), zeros elsewhere."""
    global _PACK_W_NP
    if _PACK_W_NP is None:
        w = np.zeros((1024, 128), np.float32)
        i = np.arange(1024)
        w[i, i // 8] = 1 << (i % 8)
        _PACK_W_NP = w
    return _PACK_W_NP


def _packbits_device(bits01: jnp.ndarray) -> jnp.ndarray:
    """Pack a 0/1 uint8 vector (length % 8 == 0) LSB-first into bytes.

    One bf16 matmul per 1024-bit row: rows of 1024 bits x a constant
    (1024, 128) selector-weight matrix give 128 exact byte values per row
    (bits and power-of-two weights are exact in bf16; 8-term sums <= 255
    are exact in the f32 accumulator).  Every operand keeps a 128-aligned
    minor dim instead of the natural ``(-1, 8) @ powers`` form (the
    packemit layout rule)."""
    nbits = bits01.shape[0]
    rows = -(-nbits // 1024)
    pad = rows * 1024 - nbits
    if pad:
        bits01 = jnp.concatenate(
            [bits01, jnp.zeros(pad, dtype=bits01.dtype)]
        )
    m = bits01.reshape(rows, 1024).astype(jnp.bfloat16)
    w = jnp.asarray(_pack_weight_np(), dtype=jnp.bfloat16)
    by = jax.lax.dot_general(
        m, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )
    return by.astype(jnp.uint8).reshape(-1)[: nbits // 8]


def cap_total_bytes(
    n: int, num_bp_cap: int, wave_cap: int, ev_caps
) -> int:
    """Per-class byte capacity for the merged segment buffer.

    A class's segment bytes are bounded by (its valid events + 7 pad bits
    per pass) / 8 — exceeding that implies an event-cap overflow, which
    already forces the host fallback, so sizing the buffer by the event
    caps (instead of the volume-scale worst case) loses nothing and cuts
    the 256^3 buffer ~4x."""
    worst = min(n, (2 * wave_cap * (num_bp_cap + 4)) // 8 + 8)
    ev_bound = (max(ev_caps) + 7 * num_bp_cap) // 8 + 16
    return min(worst, ev_bound)


def events_to_segments(p_key, sec_key, bits, num_bp_cap: int, cap_total: int):
    """Sort emission events by (pass, secondary order) into a byte-aligned
    concatenation of per-pass segments — scatter-free.

    p_key: i32 pass per event (>= num_bp_cap marks invalid); sec_key: i32
    within-pass order, or None when the events are ALREADY in within-pass
    order; bits: bool values.  Returns (buf u8[cap_total],
    counts i32[num_bp_cap], total_bytes i32).

    The byte alignment comes from PAD EVENTS, not a scatter: 7 zero-bit
    pad candidates per pass are appended with keys that sort immediately
    after that pass's real events, and exactly (-counts[p]) mod 8 of them
    keep a valid key (the rest sort past the end with the invalid reals).
    The sorted bit vector is then the final segment concatenation by
    construction — position IS the sort rank — eliminating the EV-scale
    scatter (the costliest XLA primitive here when this was designed).
    When (pass, pad flag, rank, bit) packs into 31 bits the sort runs as a
    single fused-key operand; otherwise a stable 1/2-key sort carries the
    bit payload.  Per-pass counts come from fused compare+reduce over the
    unsorted keys (bincount's 35-bin scatter-add serializes on conflicts;
    searchsorted on the sorted keys would add a num_bp_cap-wide gather)."""
    EV = p_key.shape[0]
    P = num_bp_cap
    NPAD = 7 * P
    pvals = jnp.arange(P, dtype=jnp.int32)
    counts = jnp.sum(
        p_key[None, :] == pvals[:, None], axis=1, dtype=jnp.int32
    )
    bc = (counts + 7) // 8
    boff = jnp.cumsum(bc) - bc
    total_bytes = jnp.sum(bc)
    needed = bc * 8 - counts  # pads per pass, in [0, 7]

    # combined key: reals at 2p, kept pads at 2p+1, everything else last
    big = jnp.int32(2 * P + 2)
    key_real = jnp.where(p_key < P, p_key * 2, big)
    pad_p = jnp.repeat(pvals, 7)
    pad_slot = jnp.tile(jnp.arange(7, dtype=jnp.int32), P)
    key_pad = jnp.where(pad_slot < needed[pad_p], pad_p * 2 + 1, big)
    key_all = jnp.concatenate([key_real, key_pad])
    bit_all = jnp.concatenate(
        [bits.astype(jnp.int32), jnp.zeros(NPAD, jnp.int32)]
    )

    TT = EV + NPAD
    jbits = max(1, (TT - 1).bit_length())
    if sec_key is None and (2 * P + 2).bit_length() + jbits + 1 <= 31:
        # one fused operand: (key, rank, bit) — rank keeps reals in their
        # original within-pass order and orders pads after them
        fused = (
            (key_all << (jbits + 1))
            | (jnp.arange(TT, dtype=jnp.int32) << 1)
            | bit_all
        )
        (srt,) = jax.lax.sort((fused,), num_keys=1, is_stable=False)
        bit_sorted = (srt & 1).astype(jnp.uint8)
    elif sec_key is None:
        key_sorted, bit_sorted = jax.lax.sort(
            (key_all, bit_all), num_keys=1, is_stable=True
        )
        bit_sorted = bit_sorted.astype(jnp.uint8)
    else:
        sec_all = jnp.concatenate(
            [sec_key, jnp.full(NPAD, 0x7FFFFFFF, jnp.int32)]
        )
        _, _, bit_sorted = jax.lax.sort(
            (key_all, sec_all, bit_all), num_keys=2, is_stable=True
        )
        bit_sorted = bit_sorted.astype(jnp.uint8)

    # Valid stream bits never exceed TT (every byte is a real event or a
    # kept pad), so pack only min(cap, TT)-rounded bits and zero-pad the
    # BYTES to the declared capacity — 8x cheaper than padding bits.
    k_bits = min(cap_total * 8, ((TT + 7) // 8) * 8)
    if k_bits > TT:
        bit_sorted = jnp.concatenate(
            [bit_sorted, jnp.zeros(k_bits - TT, jnp.uint8)]
        )
    else:
        bit_sorted = bit_sorted[:k_bits]
    # zero the junk past the stream (invalid reals / surplus pads)
    iota = jnp.arange(k_bits, dtype=jnp.int32)
    out01 = jnp.where(iota < total_bytes * 8, bit_sorted, 0).astype(jnp.uint8)
    packed = _packbits_device(out01)
    if cap_total > k_bits // 8:
        packed = jnp.concatenate(
            [packed, jnp.zeros(cap_total - k_bits // 8, jnp.uint8)]
        )
    return packed, counts, total_bytes


def _expand_fill(ln, words, ev_cap: int, widths=None):
    """Interval expansion by forward-fill: item k (in order) contributes
    ln_k consecutive events; each event receives the item's payload
    `words` (a list of i32[T]) plus its offset within the item's block.

    Returns (filled list of i32[ev_cap], rel i32[ev_cap] = event index
    within its item's block, ev_ok mask, ev_total).  No event-scale
    gathers anywhere (gathers were the most expensive XLA primitive in
    this stage when it was designed; docs/WAVEFRONT.md section 4).

    With `widths` (bit-width per payload word; every value MUST fit its
    declared width), the fill runs as cummax chains: each fill word packs
    (block start << pb | payload chunk) — block starts strictly increase
    over emitting items, so a running max both selects the latest start at
    or before j and carries the payload chunk with it.  ceil(total_width /
    pb) cummax passes replace the generic associative scan, which XLA
    expands into a log(ev_cap)-depth slice/concat network (~20 full-array
    passes); cummax lowers to the same single-pass scan as cumsum.
    Without `widths` (or when ev_cap leaves no
    payload bits) the associative-scan form runs instead."""
    T = ln.shape[0]
    off = jnp.cumsum(ln) - ln
    ev_total = jnp.sum(ln)
    pos = jnp.where(ln > 0, off, ev_cap)
    j = jnp.arange(ev_cap, dtype=jnp.int32)
    ev_ok = j < ev_total

    pb = 30 - max(1, (ev_cap - 1).bit_length()) if widths is not None else 0
    if pb >= 1:
        # chop payload words into pb-bit chunks; each chunk rides its own
        # cummax fill behind the (monotone) block-start field
        chunk_src = []  # (word index, low bit, take)
        for wi, wd in enumerate(widths):
            for lo in range(0, int(wd), pb):
                chunk_src.append((wi, lo, min(pb, int(wd) - lo)))
        fills = []
        for wi, lo, take in chunk_src:
            chunk = (words[wi] >> lo) & ((1 << take) - 1)
            v = (off << pb) | chunk
            buf = jnp.full(ev_cap, -1, jnp.int32).at[pos].set(v, mode="drop")
            fills.append(jax.lax.cummax(buf, axis=0))
        rel = j - (fills[0] >> pb)
        filled = [jnp.zeros(ev_cap, jnp.int32) for _ in words]
        for (wi, lo, take), f in zip(chunk_src, fills):
            filled[wi] = filled[wi] | ((f & ((1 << take) - 1)) << lo)
        return filled, rel, ev_ok, ev_total

    stack = jnp.stack(
        [jnp.ones(T, jnp.int32), off] + list(words), axis=1
    )  # [T, 2 + k]
    buf = jnp.zeros((ev_cap, stack.shape[1]), jnp.int32)
    buf = buf.at[pos, :].set(stack, mode="drop")

    def comb(a, b):
        return jnp.where(b[..., :1] > 0, b, a)

    filled = jax.lax.associative_scan(comb, buf, axis=0)
    rel = j - filled[:, 1]
    return [filled[:, 2 + i] for i in range(len(words))], rel, ev_ok, ev_total


def lip_events(
    sign_c: jnp.ndarray,
    s_c: jnp.ndarray,
    e_c: jnp.ndarray,
    num_bp: jnp.ndarray,
    num_bp_cap: int,
    ev_cap: int,
):
    """LIP emission events: pixel i emits a membership bit (value s==p) at
    every pass p in (e, s], plus its sign right after the decision when it
    turns significant; order within a pass is ascending pixel, decision
    before sign.  Events are generated in item order, so within-pass order
    is the event index itself.  Item payloads reach the events via
    forward-fill scans (_expand_fill), never event-scale gathers.

    Returns (p_key i32[ev_cap] — invalid events keyed num_bp_cap,
    bit bool[ev_cap], overflow bool)."""
    # The sign rides as one extra slot at the end of the interval when the
    # pixel turns significant inside the pass range.  Fields are packed
    # into one word: lo(6b) | hi(6b) | has_sign | sign.
    lo = jnp.minimum(e_c + 1, 63)
    hi_dec = jnp.minimum(s_c, num_bp - 1)
    has_sign = (s_c <= num_bp - 1) & (lo <= hi_dec)
    hi = hi_dec + has_sign.astype(jnp.int32)  # one extra event slot
    ln = jnp.where(lo <= hi, hi - lo + 1, 0)
    w = (
        lo
        | (jnp.clip(hi, 0, 63) << 6)
        | (has_sign.astype(jnp.int32) << 12)
        | (sign_c.astype(jnp.int32) << 13)
    )
    (wf,), rel, ev_ok, ev_total = _expand_fill(ln, [w], ev_cap, widths=[14])
    lo_e = wf & 63
    hi_e = (wf >> 6) & 63
    hs_e = (wf >> 12) & 1
    sg_e = (wf >> 13) & 1
    p_raw = lo_e + rel
    is_sign = (hs_e == 1) & (p_raw == hi_e)
    p_ev = jnp.where(is_sign, p_raw - 1, p_raw)  # sign shares the dec pass
    # decision value (s == p) <=> the event right before the sign slot
    bit_ev = jnp.where(is_sign, sg_e == 1, (hs_e == 1) & (p_raw == hi_e - 1))
    p_key = jnp.where(ev_ok, p_ev, num_bp_cap)
    return p_key, bit_ev, ev_total > ev_cap


def ref_events(
    mag_c: jnp.ndarray,
    s_c: jnp.ndarray,
    num_bp: jnp.ndarray,
    num_bp_cap: int,
    ev_cap: int,
):
    """Refinement emission events: magnitude bit num_bp-1-p at every pass
    p in [s+1, num_bp-1], ascending pixel within a pass.  Same event-form
    contract as lip_events."""
    m32 = mag_c.astype(jnp.int32)
    rlo = jnp.minimum(s_c + 1, 63)
    rhi = jnp.broadcast_to(num_bp - 1, rlo.shape)
    rln = jnp.where(rlo <= rhi, rhi - rlo + 1, 0)
    (rlo_f, m_f), rrel, rok, rtotal = _expand_fill(
        rln, [rlo, m32], ev_cap, widths=[6, 31]
    )
    rp = rlo_f + rrel
    shift = jnp.clip(num_bp - 1 - rp, 0, 31).astype(jnp.uint32)
    rbit = ((m_f.astype(jnp.uint32) >> shift) & jnp.uint32(1)).astype(bool)
    rp_key = jnp.where(rok, rp, num_bp_cap)
    return rp_key, rbit, rtotal > ev_cap


def events_to_segments_merged(p_keys, bits_list, num_bp_cap: int,
                              cap_total: int):
    """One (pass, class)-keyed sort packs EVERY emission class at once.

    `p_keys` / `bits_list`: per-class event arrays in STREAM ORDER (the
    SPECK pass layout LIP ‖ LIS ‖ refinement -> classes 0, 1, 2); each
    class's events must be in within-pass order (the event-form
    contract).  The merged bucket key b = p*C + c makes the sorted bit
    vector the full per-pass-per-class segment concatenation in one
    operation — one sort, one pad set, one packbits instead of C of
    each.

    Returns (buf u8[C*cap_total], counts i32[P*C] in bucket order,
    cls_bytes i32[C] — per-class byte totals (the old per-class buffer
    totals, for cap checks), total_bytes i32)."""
    C = len(p_keys)
    P = num_bp_cap
    NB = P * C
    pvals = jnp.arange(P, dtype=jnp.int32)
    counts_cls = [
        jnp.sum(pk[None, :] == pvals[:, None], axis=1, dtype=jnp.int32)
        for pk in p_keys
    ]
    counts = jnp.stack(counts_cls, axis=1).reshape(-1)  # bucket order
    bc = (counts + 7) // 8
    total_bytes = jnp.sum(bc)
    cls_bytes = jnp.stack(
        [jnp.sum((c + 7) // 8) for c in counts_cls]
    ).astype(jnp.int32)
    needed = bc * 8 - counts  # pads per bucket, in [0, 7]

    big = jnp.int32(2 * NB + 2)
    key_real = jnp.concatenate(
        [
            jnp.where(pk < P, (pk * C + c) * 2, big)
            for c, pk in enumerate(p_keys)
        ]
    )
    NPAD = 7 * NB
    pad_b = jnp.repeat(jnp.arange(NB, dtype=jnp.int32), 7)
    pad_slot = jnp.tile(jnp.arange(7, dtype=jnp.int32), NB)
    key_pad = jnp.where(pad_slot < needed[pad_b], pad_b * 2 + 1, big)
    key_all = jnp.concatenate([key_real, key_pad])
    bit_all = jnp.concatenate(
        [b.astype(jnp.int32) for b in bits_list]
        + [jnp.zeros(NPAD, jnp.int32)]
    )

    TT = key_all.shape[0]
    jbits = max(1, (TT - 1).bit_length())
    if (2 * NB + 2).bit_length() + jbits + 1 <= 31:
        fused = (
            (key_all << (jbits + 1))
            | (jnp.arange(TT, dtype=jnp.int32) << 1)
            | bit_all
        )
        (srt,) = jax.lax.sort((fused,), num_keys=1, is_stable=False)
        bit_sorted = (srt & 1).astype(jnp.uint8)
    else:
        _, bit_sorted = jax.lax.sort(
            (key_all, bit_all), num_keys=1, is_stable=True
        )
        bit_sorted = bit_sorted.astype(jnp.uint8)

    k_bits = min(C * cap_total * 8, ((TT + 7) // 8) * 8)
    if k_bits > TT:
        bit_sorted = jnp.concatenate(
            [bit_sorted, jnp.zeros(k_bits - TT, jnp.uint8)]
        )
    else:
        bit_sorted = bit_sorted[:k_bits]
    iota = jnp.arange(k_bits, dtype=jnp.int32)
    out01 = jnp.where(iota < total_bytes * 8, bit_sorted, 0).astype(jnp.uint8)
    packed = _packbits_device(out01)
    if C * cap_total > k_bits // 8:
        packed = jnp.concatenate(
            [packed, jnp.zeros(C * cap_total - k_bits // 8, jnp.uint8)]
        )
    return packed, counts, cls_bytes, total_bytes


def encode_3d_device(mags_np, signs_np, dims, budget_bits: int = 0) -> bytes:
    """Full 3D SPECK encode with the pixel work on the JAX device and the
    set walk + stitching on the host.  Byte-identical to the serial engines.

    This is the demonstration entry point; production chunk pipelines call
    pixel_schedule/pass_segments directly on device-resident coefficients and
    only the segment rows (≈ stream-sized) cross to the host."""
    from ..codec import speck_wave as sw

    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    ti = tree_index(dims)

    mags_np = np.ascontiguousarray(mags_np).reshape(n)
    signs_np = np.ascontiguousarray(signs_np).reshape(n).astype(bool)
    if int(mags_np.max(initial=0)) > 0xFFFFFFFF:
        raise ValueError(
            "device SPECK path works on uint32 magnitudes (device-quantized "
            "data is < 2^24); use a host engine for >32-bit magnitudes"
        )
    dev_mags = jnp.asarray(mags_np.astype(np.uint32))
    dev_signs = jnp.asarray(signs_np)

    pm = msbp1_device(dev_mags)
    num_bp = int(jnp.max(pm))
    if num_bp == 0:
        return sw._pack_stream(np.empty(0, np.uint8), 0, 0)
    s, e, nm = pixel_schedule(dev_mags, ti, jnp.int32(num_bp))
    lip_bits, lip_counts, ref_bits, ref_counts = pass_segments(
        dev_mags, dev_signs, s, e, jnp.int32(num_bp), num_bp
    )
    # device -> host: segments (stream-sized after count slicing) + node maxes
    lip_bits = np.asarray(lip_bits)
    lip_counts = np.asarray(lip_counts)
    ref_bits = np.asarray(ref_bits)
    ref_counts = np.asarray(ref_counts)
    node_maxes = np.asarray(nm)

    lip_segments = [lip_bits[p, : lip_counts[p]] for p in range(num_bp)]
    ref_segments = [ref_bits[p, : ref_counts[p]] for p in range(num_bp)]
    return sw.stitch_3d(
        np.asarray(pm).astype(np.int16),
        signs_np,
        node_maxes.astype(np.int16),
        dims,
        num_bp,
        lip_segments,
        ref_segments,
        budget_bits,
    )


class PyramidIndex:
    """Static device tables for the pyramid-form schedule (3D dyadic dims):
    per-axis slot tables, per-depth tree-order gathers, per-pixel parent
    depth masks.  O(n) total instead of the child-table's O(n) *rows*;
    every data-dependent op is a reshape/max or a regular gather."""

    __slots__ = ("dims", "levels", "ax_depth", "slots", "tree_perm",
                 "pd_masks", "nn")

    def __init__(self, dims):
        from . import pyramid as pm

        nx, ny, nz = (int(d) for d in dims)
        self.dims = (nx, ny, nz)
        pyr = pm.Pyramid((nx, ny, nz))
        tree = build_tree((nx, ny, nz))
        perm = pm._build_tree_perm(pyr, tree)  # raises for packet dims
        self.levels = pyr.levels
        self.ax_depth = (pyr.az.depth, pyr.ay.depth, pyr.ax.depth)
        self.slots = (
            jnp.asarray(pyr.az.slot), jnp.asarray(pyr.ay.slot),
            jnp.asarray(pyr.ax.slot),
        )
        self.nn = tree.node_ch_start.size
        self.tree_perm = {
            d: (jnp.asarray(ids), jnp.asarray(boxes))
            for d, (ids, boxes) in perm.items()
        }
        # static per-pixel parent depth (max over axes of the depth where the
        # interval reaches length 1), as per-depth boolean masks
        dz = pyr.az.d_single.astype(np.int16)
        dy = pyr.ay.d_single.astype(np.int16)
        dx = pyr.ax.d_single.astype(np.int16)
        pd = np.maximum.outer(np.maximum.outer(dz, dy), dx)
        self.pd_masks = [
            (d, jnp.asarray((pd == d).reshape(-1)))
            for d in range(int(pd.max()) + 1)
            if (pd == d).any()
        ]


_PYR_INDEXES = {}


def pyramid_index(dims):
    key = tuple(int(d) for d in dims)
    pi = _PYR_INDEXES.get(key)
    if pi is None:
        pi = PyramidIndex(key)
        _PYR_INDEXES[key] = pi
    return pi


def pixel_schedule_pyramid(mags: jnp.ndarray, pi: PyramidIndex, num_bp):
    """pixel_schedule via max-pool pyramids (3D dyadic dims): returns
    (s, e, node_max-in-tree-order), identical to the child-table version."""
    nz_d, ny_d, nx_d = pi.ax_depth
    nx, ny, nz = pi.dims
    pm = msbp1_device(mags)
    vol = pm.reshape(nz, ny, nx)
    deep = jnp.zeros((1 << nz_d, 1 << ny_d, 1 << nx_d), dtype=pm.dtype)
    zi, yi, xi = pi.slots
    deep = deep.at[zi[:, None, None], yi[None, :, None], xi[None, None, :]].set(vol)
    levels = [None] * (pi.levels + 1)
    levels[pi.levels] = deep
    cur = deep
    for d in range(pi.levels - 1, -1, -1):
        z2 = 2 if d < nz_d else 1
        y2 = 2 if d < ny_d else 1
        x2 = 2 if d < nx_d else 1
        sz, sy, sx = cur.shape
        cur = cur.reshape(sz // z2, z2, sy // y2, y2, sx // x2, x2).max(
            axis=(1, 3, 5)
        )
        levels[d] = cur

    nm = jnp.zeros(pi.nn, dtype=jnp.int32)
    for d, (ids, boxes) in pi.tree_perm.items():
        nm = nm.at[ids].set(levels[d].reshape(-1)[boxes].astype(jnp.int32))

    s = jnp.where(pm > 0, num_bp - pm, _NEVER).astype(jnp.int32)
    e = jnp.full((pi.dims[0] * pi.dims[1] * pi.dims[2],), _NEVER, jnp.int32)
    for d, mask in pi.pd_masks:
        pdep = max(d - 1, 0)
        ddz = min(pdep, nz_d)
        ddy = min(pdep, ny_d)
        ddx = min(pdep, nx_d)
        bz = zi >> (nz_d - ddz)
        by = yi >> (ny_d - ddy)
        bx = xi >> (nx_d - ddx)
        bm = levels[pdep][bz[:, None, None], by[None, :, None], bx[None, None, :]]
        ev = jnp.where(bm > 0, num_bp - bm.astype(jnp.int32), _NEVER)
        e = jnp.where(mask, ev.reshape(-1), e)
    return s, e, nm


def encode_2d_device(mags_np, signs_np, dims, budget_bits: int = 0) -> bytes:
    """2D analog of encode_3d_device: pixel bit-work on the JAX device, the
    quad/I-set walk and stitching on the host.  Byte-identical streams."""
    from ..codec import speck_wave as sw

    nx, ny = (int(d) for d in dims)
    n = nx * ny
    ti = tree_index((nx, ny))

    mags_np = np.ascontiguousarray(mags_np).reshape(n)
    signs_np = np.ascontiguousarray(signs_np).reshape(n).astype(bool)
    if int(mags_np.max(initial=0)) > 0xFFFFFFFF:
        raise ValueError("device SPECK path works on uint32 magnitudes")
    dev_mags = jnp.asarray(mags_np.astype(np.uint32))
    dev_signs = jnp.asarray(signs_np)

    pm = msbp1_device(dev_mags)
    num_bp = int(jnp.max(pm))
    if num_bp == 0:
        return sw._pack_stream(np.empty(0, np.uint8), 0, 0)
    s, e, nm = pixel_schedule(dev_mags, ti, jnp.int32(num_bp))
    lip_bits, lip_counts, ref_bits, ref_counts = pass_segments(
        dev_mags, dev_signs, s, e, jnp.int32(num_bp), num_bp
    )
    lip_bits = np.asarray(lip_bits)
    lip_counts = np.asarray(lip_counts)
    ref_bits = np.asarray(ref_bits)
    ref_counts = np.asarray(ref_counts)
    node_maxes = np.asarray(nm)
    pmsb_host = np.asarray(pm).astype(np.int16)

    lip_segments = [lip_bits[p, : lip_counts[p]] for p in range(num_bp)]
    ref_segments = [ref_bits[p, : ref_counts[p]] for p in range(num_bp)]
    return sw.stitch_2d(
        pmsb_host,
        signs_np,
        node_maxes.astype(np.int16),
        (nx, ny),
        num_bp,
        lip_segments,
        ref_segments,
        budget_bits,
    )


__all__ = [
    "TreeIndex",
    "tree_index",
    "msbp1_device",
    "node_max",
    "pixel_schedule",
    "pass_segments",
    "encode_3d_device",
]
