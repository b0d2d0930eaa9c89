"""Prefix-pack bit emission: masked bit streams without event sorts.

The round-3 entropy stage emitted SPECK bits by materializing event lists
(one i32 per bit) and sorting them into stream order — cap-sized sorts,
scatters and expansions that dominated the 256^3 stage.  This module
replaces that machinery with a packed-word pipeline whose only data-dependent movements are ONE multi-operand flat
sort at the non-empty-piece scale and ONE piece-sized scatter-add;
everything else is elementwise:

  1. The per-(class, pass) emission of LIP / LIS / refinement bits is a
     DENSE boolean matrix [rows, L] (valid, bit), constructed by
     broadcasting the per-pixel schedule against the pass index — the
     within-pass emission order of SPECK is ascending position
     (reference SPECK_INT.cpp:111-163), so row-major order IS stream
     order and no sort is ever needed for ordering.
  2. Rows pack 32 cells/word through bf16 matmuls against constant
     selector weights (halfword values, exact in the f32 accumulator);
     each word's valid bits compact in-register with a PEXT
     (sheep-and-goats) emulation — ~60 elementwise u32 ops, no data
     movement (examples/prim_bench.py measures it).
  3. Per-word popcounts turn into global bit offsets with one blocked
     cumsum; byte-aligned per-row bases fold in via equal-length-row
     reshapes (both gather-free).
  4. Words merge pairwise (static funnel-shift levels) into multi-word
     pieces; the non-empty pieces — the compressed-information scale —
     compact through one fused flat sort carrying the piece payload.
  5. Each piece funnel-shifts to its output alignment and scatter-adds
     its piece_words+1 aligned words; contributions to shared boundary
     words are bit-disjoint, so add == or.

LAYOUT RULE (tiled device layouts pad a small minor dimension — a
[1, 34, n, 2] u8 intermediate was seen to inflate 64x and run out of memory
at 256^3; whether the GPU needs the rule is an open measurement): every
array in this pipeline is either flat 1-D or has a LARGE minor dimension.  Pieces live
as lists of flat word arrays, never as [N, piece_words]; interleaved
(decision, sign) cell pairs are produced by stride-2 selector weights in
the packing matmul, never by a stack/reshape.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def pext32(x: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Parallel bit extract: compact the bits of ``x`` at the set positions
    of ``m`` toward the LSB, preserving order (Hacker's Delight 7-4,
    'compress').  u32 in / u32 out; ~60 elementwise ops, no movement."""
    x = x.astype(_U32) & m.astype(_U32)
    m = m.astype(_U32)
    mk = (~m) << jnp.uint32(1)
    for i in range(5):
        mp = mk ^ (mk << jnp.uint32(1))
        mp = mp ^ (mp << jnp.uint32(2))
        mp = mp ^ (mp << jnp.uint32(4))
        mp = mp ^ (mp << jnp.uint32(8))
        mp = mp ^ (mp << jnp.uint32(16))
        mv = mp & m
        sh = jnp.uint32(1 << i)
        m = (m ^ mv) | (mv >> sh)
        t = x & mv
        x = (x ^ t) | (t >> sh)
        mk = mk & ~mp
    return x


_TR_MASKS = (
    (16, 0x0000FFFF),
    (8, 0x00FF00FF),
    (4, 0x0F0F0F0F),
    (2, 0x33333333),
    (1, 0x55555555),
)


def transpose_bits32(x: jnp.ndarray) -> jnp.ndarray:
    """32x32 bit-matrix transpose over consecutive 32-element blocks.

    ``x``: flat u32[M] (M % 32 == 0) where x[i] bit p is cell (p, i).
    Returns u32[32, M // 32] planes: out[p, w] bit l == x[32w + l] bit p.

    This is THE bitplane<->position pivot of the codec: a per-item pass
    mask (one u32, bits = passes) becomes packed per-pass emission words
    without ever materializing a [P, M] cell matrix.  Hacker's Delight
    transpose32 vectorized over blocks; pairs (k, k+j) never cross a
    32-block, so the shifted operands are plain rolls of the flat array
    (wraparound lanes are always discarded by the in-block selector).
    ~5 stages x 8 elementwise ops; traffic ~10 passes over M words.
    """
    M = x.shape[0]
    assert M % 32 == 0
    x = _tr32_stages(x.astype(_U32))
    return x.reshape(M // 32, 32).T


def transpose_bits32_pair(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Transpose of the INTERLEAVED virtual cell array v[2i] = a[i],
    v[2i+1] = b[i] — without ever materializing it (a [M, 2]-minor
    relayout breaks the module layout rule).

    ``a``, ``b``: u32[M] (M % 16 == 0) per-item pass masks for the even
    (e.g. decision) and odd (e.g. sign) cell lanes.  Returns
    u32[32, 2M // 32] == transpose_bits32(interleave(a, b)).

    Derivation: stages j in {16, 8, 4, 2} of the 32-lane transpose pair
    SAME-parity virtual positions, i.e. act on a and b independently at
    HALF the positional distance (bit-shift distance unchanged); the
    final j = 1 stage pairs (a_i, b_i) in place.  The virtual reshape
    interleaves transposed ROWS, a cheap major-axis stack."""
    M = a.shape[0]
    assert M % 16 == 0
    a = a.astype(_U32)
    b = b.astype(_U32)
    lane = jnp.arange(M, dtype=jnp.int32) & 15
    for j, mval in _TR_MASKS[:-1]:
        h = j >> 1
        m = jnp.uint32(mval)
        sel = (lane & h) == 0
        outs = []
        for x in (a, b):
            fwd = jnp.roll(x, -h)
            t = ((x >> jnp.uint32(j)) ^ fwd) & m
            tb = jnp.roll(t, h)
            outs.append(jnp.where(sel, x ^ (t << jnp.uint32(j)), x ^ tb))
        a, b = outs
    m1 = jnp.uint32(0x55555555)
    t = ((a >> jnp.uint32(1)) ^ b) & m1
    a = a ^ (t << jnp.uint32(1))
    b = b ^ t
    ar = a.reshape(M // 16, 16).T
    br = b.reshape(M // 16, 16).T
    return jnp.stack([ar, br], axis=1).reshape(32, M // 16)


def untranspose_bits32(planes: jnp.ndarray) -> jnp.ndarray:
    """Inverse of transpose_bits32: u32[32, W] planes -> flat u32[32 * W]
    per-item words (item i's bit p == planes[p, i // 32] bit (i % 32))."""
    return _tr32_stages(planes.T.reshape(-1).astype(_U32))


def _tr32_stages(x: jnp.ndarray) -> jnp.ndarray:
    """The 5 masked-swap stages over flat u32[M] (blocks of 32): exchange
    element (l, p) with (l ^ j, p ^ j) when l bit j == 0, p bit j == 1."""
    lane = jnp.arange(x.shape[0], dtype=jnp.int32) & 31
    for j, mval in _TR_MASKS:
        m = jnp.uint32(mval)
        sel = (lane & j) == 0
        fwd = jnp.roll(x, -j)                        # x[i + j]
        t = ((x >> jnp.uint32(j)) ^ fwd) & m         # valid at sel positions
        tb = jnp.roll(t, j)                          # t[i - j]
        x = jnp.where(sel, x ^ (t << jnp.uint32(j)), x ^ tb)
    return x


def repeat2(x: jnp.ndarray) -> jnp.ndarray:
    """Each element twice, flat: out[2i] = out[2i+1] = x[i].  broadcast_to +
    reshape (a pure relayout), NOT jnp.repeat (lowers through a gather)."""
    n = x.shape[0]
    return jnp.broadcast_to(x[:, None], (n, 2)).reshape(2 * n)


def ones_low32(k: jnp.ndarray) -> jnp.ndarray:
    """(1 << k) - 1 for k in [0, 32] (u32-safe at k == 32)."""
    kc = jnp.clip(k, 0, 32)
    k1 = jnp.minimum(kc, 31).astype(_U32)
    base = (jnp.uint32(1) << k1) - jnp.uint32(1)
    return jnp.where(kc >= 32, jnp.uint32(0xFFFFFFFF), base)


def ones_span32(lo: jnp.ndarray, hi: jnp.ndarray, base: int = 0) -> jnp.ndarray:
    """u32 mask with bits [lo - base, hi - base] set (window-clipped);
    empty when hi < lo.  lo/hi are i32 arrays of arbitrary range."""
    return ones_low32(hi - base + 1) & ~ones_low32(lo - base)


def bit_at32(p: jnp.ndarray, base: int = 0) -> jnp.ndarray:
    """u32 with bit (p - base) set when in [0, 32), else 0."""
    r = p - base
    ok = (r >= 0) & (r < 32)
    return jnp.where(
        ok, jnp.uint32(1) << jnp.clip(r, 0, 31).astype(_U32), jnp.uint32(0)
    )


def bitrev32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 32 bits of each u32 element (classic swap ladder)."""
    x = x.astype(_U32)
    x = ((x >> jnp.uint32(1)) & jnp.uint32(0x55555555)) | (
        (x & jnp.uint32(0x55555555)) << jnp.uint32(1)
    )
    x = ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333)) | (
        (x & jnp.uint32(0x33333333)) << jnp.uint32(2)
    )
    x = ((x >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F)) | (
        (x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)
    )
    x = ((x >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)) | (
        (x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)
    )
    return (x >> jnp.uint32(16)) | (x << jnp.uint32(16))


_W16 = None
_W16I = None


def _half_weight() -> np.ndarray:
    """(1024, 64) selector: cell i -> halfword i//16, bit i%16."""
    global _W16
    if _W16 is None:
        w = np.zeros((1024, 64), np.float32)
        i = np.arange(1024)
        w[i, i // 16] = 1 << (i % 16)
        _W16 = w
    return _W16


def _half_weight_interleaved() -> Tuple[np.ndarray, np.ndarray]:
    """Stride-2 selectors: cells a_i, b_i -> halfword i//8, bits 2(i%8)
    and 2(i%8)+1 — the (decision, sign) interleave without ever
    materializing a [..., 2]-minor array."""
    global _W16I
    if _W16I is None:
        i = np.arange(1024)
        wa = np.zeros((1024, 128), np.float32)
        wb = np.zeros((1024, 128), np.float32)
        wa[i, i // 8] = 1 << (2 * (i % 8))
        wb[i, i // 8] = 1 << (2 * (i % 8) + 1)
        _W16I = (wa, wb)
    return _W16I


def _mm_pack(cells: jnp.ndarray, w_np: np.ndarray) -> jnp.ndarray:
    """[M] 0/1 u8 cells x (1024, K) selector -> flat i32 halfword values.

    Exact: bits and power-of-two weights are exact in bf16, halfword sums
    <= 0xFFFF are exact in the f32 accumulator."""
    M = cells.shape[0]
    rows = -(-M // 1024)
    pad = rows * 1024 - M
    if pad:
        cells = jnp.concatenate([cells, jnp.zeros(pad, cells.dtype)])
    m = cells.reshape(rows, 1024).astype(jnp.bfloat16)
    w = jnp.asarray(w_np, dtype=jnp.bfloat16)
    hv = jax.lax.dot_general(
        m, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )
    return hv.astype(jnp.int32).reshape(-1)


def _halves_to_words(h: jnp.ndarray, n_words: int) -> jnp.ndarray:
    """Flat i32 halfword values -> flat u32 words (little-endian halves)."""
    lo = jax.lax.slice(h, (0,), (2 * n_words,), (2,)).astype(_U32)
    hi = jax.lax.slice(h, (1,), (2 * n_words,), (2,)).astype(_U32)
    return lo | (hi << 16)


def pack_cells_flat(cells_u8: jnp.ndarray) -> jnp.ndarray:
    """Flat [M] 0/1 u8 cells -> flat [M//32] u32 words, LSB-first."""
    M = cells_u8.shape[0]
    assert M % 32 == 0, "pack_cells_flat drops trailing cells unless M % 32 == 0"
    h = _mm_pack(cells_u8, _half_weight())
    return _halves_to_words(h, M // 32)


def pack_cells_interleaved(a_u8: jnp.ndarray, b_u8: jnp.ndarray) -> jnp.ndarray:
    """Flat [M] cell pairs -> flat [2M//32] u32 words of the interleaved
    stream a_0 b_0 a_1 b_1 ..., via two stride-2 selector matmuls."""
    M = a_u8.shape[0]
    assert (2 * M) % 32 == 0, "pack_cells_interleaved requires 2M % 32 == 0"
    ha = _mm_pack(a_u8, _half_weight_interleaved()[0])
    hb = _mm_pack(b_u8, _half_weight_interleaved()[1])
    return _halves_to_words(ha + hb, 2 * M // 32)


def cells_to_words(cells_u8: jnp.ndarray) -> jnp.ndarray:
    """[..., L] 0/1 u8 cells (L % 32 == 0) -> [..., L//32] u32 words."""
    shape = cells_u8.shape
    w = pack_cells_flat(cells_u8.reshape(-1))
    return w.reshape(shape[:-1] + (shape[-1] // 32,))


def blocked_cumsum_excl(x: jnp.ndarray, block: int = 256) -> jnp.ndarray:
    """Exclusive cumsum of a flat i32 vector via within-block minor-axis
    cumsums + a tiny block-sum cumsum (examples/prim_bench.py compares
    it with a flat cumsum)."""
    n = x.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.concatenate([x, jnp.zeros(pad, x.dtype)]) if pad else x
    xb = xp.reshape(nb, block)
    incl = jnp.cumsum(xb, axis=1)
    bs = incl[:, -1]
    base = jnp.cumsum(bs) - bs
    excl = incl - xb + base[:, None]
    return excl.reshape(-1)[:n]


def compact_flags_rows(
    flags: jnp.ndarray, take: int, block: int = 256
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ascending indices of set flags per row, two-level form.

    ``flags``: bool[B, n] (n % block == 0).  Returns (idx i32[B, take]
    with sentinel n at unused slots, count i32[B]).  One batched
    [B*n/block, block] sort (short sorted rows) + take-scale
    gathers replace a flat n-scale sort — far less work when take << n.
    Rows whose count exceeds ``take`` return the first ``take`` indices
    (callers check count for overflow).
    """
    B, n = flags.shape
    pad = (-n) % block
    if pad:
        flags = jnp.concatenate(
            [flags, jnp.zeros((B, pad), flags.dtype)], axis=1
        )
    nb = (n + pad) // block
    fb = flags.reshape(B * nb, block)
    local = jnp.broadcast_to(
        jnp.arange(block, dtype=jnp.int32)[None, :], (B * nb, block)
    )
    fkey = jnp.where(fb, local, block)
    fs = jax.lax.sort((fkey,), dimension=1, num_keys=1, is_stable=False)[0]
    bcnt = jnp.sum(fb, axis=1).astype(jnp.int32).reshape(B, nb)
    boff = jnp.cumsum(bcnt, axis=1) - bcnt
    count = boff[:, -1] + bcnt[:, -1]
    # owner block per output slot: scatter-max of block start slots, then
    # a running max fills the runs
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, nb))
    bpos = jnp.where((bcnt > 0) & (boff < take), boff, take)
    flatpos = (rows * (take + 1) + bpos).reshape(-1)
    blk_ids = jnp.broadcast_to(
        jnp.arange(nb, dtype=jnp.int32)[None, :], (B, nb)
    ).reshape(-1)
    grid = (
        jnp.zeros(B * (take + 1), jnp.int32)
        .at[flatpos]
        .max(blk_ids, mode="drop")
        .reshape(B, take + 1)[:, :take]
    )
    bslot = jax.lax.cummax(grid, axis=1)
    it = jnp.broadcast_to(jnp.arange(take, dtype=jnp.int32)[None, :], (B, take))
    rel = it - jnp.take_along_axis(boff, bslot, axis=1)
    fsf = fs.reshape(-1)
    rowsb = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, take))
    gpos = (rowsb * nb + bslot) * block + jnp.clip(rel, 0, block - 1)
    lidx = fsf[gpos]
    wok = it < jnp.minimum(count, take)[:, None]
    idx = jnp.where(wok & (lidx < block), bslot * block + lidx, n)
    return idx, count


def _safe_rsh(x: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Logical x >> k with k allowed to reach 32 (yields 0 there)."""
    k1 = jnp.minimum(k, jnp.uint32(31)).astype(_U32)
    k2 = (k - k1).astype(_U32)  # 0 or 1
    return (x >> k1) >> k2


def _safe_lsh(x: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    k1 = jnp.minimum(k, jnp.uint32(31)).astype(_U32)
    k2 = (k - k1).astype(_U32)
    return (x << k1) << k2


def _even(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.slice(x, (0,), (x.shape[0],), (2,))


def _odd(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.slice(x, (1,), (x.shape[0],), (2,))


def _merge_level(
    words: List[jnp.ndarray], cnt: jnp.ndarray
) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
    """One pairwise funnel merge on transposed piece storage.

    ``words``: w flat u32 arrays — words[t][g] is word t of piece g, with
    each piece's valid bits packed at the LSB end of its word run and
    zeros above.  Returns 2w arrays over half as many pieces; piece
    2j+1's bit string is appended after piece 2j's cnt bits."""
    w = len(words)
    A = [_even(t) for t in words]
    B = [_odd(t) for t in words]
    ca = _even(cnt)
    cb = _odd(cnt)
    dw = (ca >> 5).astype(jnp.int32)   # whole-word offset, in [0, w]
    rho = (ca & 31).astype(_U32)

    bsh = []
    for t in range(w):
        prev = B[t - 1] if t > 0 else jnp.zeros_like(B[0])
        bsh.append(_safe_lsh(B[t], rho) | _safe_rsh(prev, jnp.uint32(32) - rho))
    ext = bsh + [_safe_rsh(B[w - 1], jnp.uint32(32) - rho)]  # w+1 entries

    out: List[jnp.ndarray] = []
    for t in range(2 * w):
        acc = A[t] if t < w else jnp.zeros_like(A[0])
        for d in range(max(0, t - w), min(t, w) + 1):
            acc = acc | jnp.where(dw == d, ext[t - d], jnp.uint32(0))
        out.append(acc)
    return out, ca + cb


class PackResult(NamedTuple):
    out_words: jnp.ndarray    # u32[out_cap_bytes // 4]  packed stream buffer
    counts: jnp.ndarray       # i32[nrows]  per-row bit counts (part order)
    total_bytes: jnp.ndarray  # i32  sum of per-row byte sizes
    overflow: jnp.ndarray     # bool  piece cap or byte cap exceeded
    n_nz: jnp.ndarray         # i32  non-empty pieces (tier-sizing signal)


def masked_pack(
    parts: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
    evb_cap: int,
    out_cap_bytes: int,
    piece_words: int = 8,
) -> PackResult:
    """Pack masked bits into byte-aligned per-row segments, stream order.

    ``parts``: per-class (valid_w, bit_w) u32 word arrays of shape
    [rows_c, Wc] (all rows of a class the same word length Wc, a multiple
    of piece_words — the equal lengths keep the row-base adjustments
    gather-free).  Rows concatenate across parts in order; each row's
    compacted bits start at the next byte boundary; bytes follow
    LSB-first bit order (np.unpackbits bitorder='little').

    ``evb_cap`` bounds the NON-EMPTY piece count (the compressed-
    information scale).  The returned buffer is valid only when
    ``overflow`` is False (drivers retry at a wider tier / fall back,
    like every other wave cap).
    """
    assert out_cap_bytes % 4 == 0
    assert piece_words in (2, 4, 8, 16)
    nlv = piece_words.bit_length() - 1

    # --- per-word compacted bits + counts -------------------------------
    cw_l: List[jnp.ndarray] = []
    c_l: List[jnp.ndarray] = []
    rows_l: List[int] = []
    Wc_l: List[int] = []
    for valid_w, bit_w in parts:
        assert valid_w.ndim == 2 and valid_w.shape == bit_w.shape
        assert valid_w.shape[1] % piece_words == 0
        cw_l.append(pext32(bit_w.reshape(-1), valid_w.reshape(-1)))
        c_l.append(
            jax.lax.population_count(valid_w.astype(_U32))
            .astype(jnp.int32)
            .reshape(-1)
        )
        rows_l.append(valid_w.shape[0])
        Wc_l.append(valid_w.shape[1])

    cflat = jnp.concatenate(c_l) if len(c_l) > 1 else c_l[0]
    S = blocked_cumsum_excl(cflat)  # global exclusive bit offsets, unaligned

    # --- per-row counts and byte-aligned bases ---------------------------
    counts = jnp.concatenate(
        [c.reshape(r, w).sum(axis=1) for c, r, w in zip(c_l, rows_l, Wc_l)]
    ).astype(jnp.int32)
    bc = (counts + 7) >> 3
    base_bytes = jnp.cumsum(bc) - bc
    total_bytes = jnp.sum(bc)
    base_bits = base_bytes << 3

    # per-word aligned offsets: S + per-row correction, via equal-row
    # reshapes per part (no gather)
    off_parts = []
    off = 0
    r0 = 0
    for r, w in zip(rows_l, Wc_l):
        sw = jax.lax.slice(S, (off,), (off + r * w,)).reshape(r, w)
        corr = base_bits[r0 : r0 + r] - sw[:, 0]
        off_parts.append((sw + corr[:, None]).reshape(-1))
        off += r * w
        r0 += r
    off_w = jnp.concatenate(off_parts) if len(off_parts) > 1 else off_parts[0]

    # --- merge words into pieces (transposed storage, all flat 1-D) ------
    cur_w: List[jnp.ndarray] = [
        jnp.concatenate(cw_l) if len(cw_l) > 1 else cw_l[0]
    ]
    cur_c = cflat
    for _ in range(nlv):
        cur_w, cur_c = _merge_level(cur_w, cur_c)
    pcnt = cur_c                                    # [Np]
    Nw = off_w.shape[0]
    pdest = jax.lax.slice(off_w, (0,), (Nw,), (piece_words,))  # [Np]

    # --- compact non-empty pieces ----------------------------------------
    # Two forms, chosen statically by occupancy regime:
    #   * sparse caps (take << padded piece count — the smooth production
    #     tiers): two-level index compaction + payload gathers; cost
    #     scales with the CAP, not the padded count;
    #   * dense caps (the widest/noisy tiers, take ~ Np): ONE fused flat
    #     sort carrying the piece payload — per-element sorting beats
    #     take-scale gathers once most pieces are live.
    # pdest <= the actual stream bit count (< 2^31 for any real chunk):
    # S accumulates VALID bits, not cells, so i32 offsets never overflow
    Np = pcnt.shape[0]
    take = min(evb_cap, Np)
    if take * 4 < Np:
        idx_r, n_nz_r = compact_flags_rows((pcnt > 0).reshape(1, Np), take)
        pok = idx_r[0] < Np
        idxc = jnp.minimum(idx_r[0], Np - 1)
        dest_c = jnp.where(pok, pdest.astype(jnp.int32)[idxc], 0)
        pw_c = [w[idxc] for w in cur_w]
        n_nz = n_nz_r[0]
    else:
        key = jnp.where(pcnt > 0, jnp.arange(Np, dtype=jnp.int32), Np)
        srt = jax.lax.sort(
            (key, pdest.astype(jnp.int32)) + tuple(cur_w),
            num_keys=1, is_stable=False,
        )
        pok = srt[0][:take] < Np
        dest_c = jnp.where(pok, srt[1][:take], 0)
        pw_c = [w[:take] for w in srt[2:]]
        n_nz = jnp.sum(pcnt > 0)
    overflow = (n_nz > take) | (total_bytes > out_cap_bytes)

    # --- align + scatter-add ---------------------------------------------
    out_wcap = out_cap_bytes // 4
    rho = (dest_c & 31).astype(_U32)
    basew = dest_c >> 5
    sh_list = []
    pos_list = []
    for t in range(piece_words + 1):
        cur = pw_c[t] if t < piece_words else jnp.zeros_like(pw_c[0])
        prev = pw_c[t - 1] if t > 0 else jnp.zeros_like(pw_c[0])
        sh = _safe_lsh(cur, rho) | _safe_rsh(prev, jnp.uint32(32) - rho)
        pos = jnp.where(pok, basew + t, out_wcap)
        sh_list.append(sh)
        pos_list.append(pos)
    buf = jnp.zeros(out_wcap, _U32)
    # contributions to a shared boundary word are bit-disjoint: add == or
    buf = buf.at[jnp.concatenate(pos_list)].add(
        jnp.concatenate(sh_list), mode="drop"
    )
    return PackResult(buf, counts, total_bytes, overflow, n_nz)


def words_to_bytes(out_words: jnp.ndarray) -> jnp.ndarray:
    """u32 word buffer -> u8 byte view (little-endian, LSB-first bits)."""
    b = jax.lax.bitcast_convert_type(out_words, jnp.uint8)
    return b.reshape(out_words.shape[:-1] + (-1,))


def masked_pack_reference(
    parts_np: Sequence[Tuple[np.ndarray, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy oracle for masked_pack: returns (bytes, per-row bit counts).
    parts: (valid, bits) 0/1 arrays of shape [rows, L] (cell granularity).
    """
    out_bits: List[np.ndarray] = []
    counts = []
    for valid, bits in parts_np:
        for r in range(valid.shape[0]):
            v = valid[r].astype(bool)
            row = bits[r][v].astype(np.uint8)
            counts.append(row.size)
            pad = (-row.size) % 8
            out_bits.append(np.concatenate([row, np.zeros(pad, np.uint8)]))
    allb = (
        np.concatenate(out_bits) if out_bits else np.zeros(0, np.uint8)
    )
    return np.packbits(allb, bitorder="little"), np.asarray(counts, np.int64)


__all__ = [
    "pext32",
    "cells_to_words",
    "pack_cells_flat",
    "pack_cells_interleaved",
    "blocked_cumsum_excl",
    "masked_pack",
    "words_to_bytes",
    "masked_pack_reference",
    "PackResult",
]
