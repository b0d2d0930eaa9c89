"""Device-side LIS emission: the SPECK set walk as on-device sorts (JAX).

Completes the wavefront encoder: with codec/speck_sorted.py's total order
over tree nodes, every LIS bit has a static sort key, so the set-partition
walk — the last host-side piece of SPECK encoding — becomes per-pass
``jnp.lexsort`` + scatter-pack on the device.  Combined with the LIP /
refinement segments (ops/speck_jax.py), the whole entropy stage runs on
the device; the host only concatenates byte-aligned segments.

Everything is int32 (no x64 requirement): path keys are 24
five-bit digits packed into four 30-bit words.  Per-chunk work is bounded
by `node_cap` significant sets (the compressed-information scale); the
driver falls back to the host stitcher on overflow, exactly like the other
caps.

Key layout mirrors codec/speck_sorted.py (see its module docstring for the
order's derivation); here roots are pre-assigned their per-level insertion
ranks so root/born anchors share one O scale.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.speck_wave import build_tree
from ..codec.speck_sorted import sorted_tree

_NEVER = 0x7FFF
_BIG = np.int32(2**31 - 1)


class LisIndex:
    """Static device arrays for the on-device set walk (cached per dims)."""

    __slots__ = (
        "nn", "n", "nrows", "max_ch", "depth_max", "nlev", "nroots",
        "parent", "level", "depth", "pw",            # per node
        "ch_start", "ch_count", "ctab", "px_linear",
        "root_ids", "root_levels", "O0", "off0", "root_from", "shallow",
    )

    def __init__(self, dims):
        tree = build_tree(tuple(int(d) for d in dims))
        st = sorted_tree(tree)
        nn = tree.node_ch_start.size
        self.nn = nn
        self.n = tree.n
        self.nrows = tree.ch_ref.size
        self.max_ch = int(tree.node_ch_count.max())
        self.depth_max = int(st.depth.max())
        lev = tree.node_level.astype(np.int32)
        self.nlev = int(lev.max()) + 1
        self.parent = jnp.asarray(st.parent.astype(np.int32))
        self.level = jnp.asarray(lev)
        self.depth = jnp.asarray(st.depth.astype(np.int32))
        # path digits (5 bits each, depth-indexed) re-packed from the host's
        # two 60-bit halves into four 30-bit words: digit d -> word d//6,
        # shift 5*(5 - d%6)
        hi, lo = st.path_hi, st.path_lo
        m30 = (1 << 30) - 1
        pw = np.stack(
            [(hi >> 30) & m30, hi & m30, (lo >> 30) & m30, lo & m30], axis=1
        ).astype(np.int32)
        self.pw = jnp.asarray(pw)
        self.ch_start = jnp.asarray(tree.node_ch_start.astype(np.int32))
        self.ch_count = jnp.asarray(tree.node_ch_count.astype(np.int32))
        # packed child table: one gather resolves (is_pixel, value index):
        # pixel rows store the linear pixel id, node rows store n + node id;
        # bit 0 is the pixel flag.  The combined (s ‖ node_s) value table in
        # lis_segments_device is indexed by the stored id directly.
        refs = tree.ch_ref
        ispx = tree.ch_is_pixel
        resolved = np.where(
            ispx, tree.px_linear[np.where(ispx, refs, 0)], tree.n + refs
        ).astype(np.int64)
        self.ctab = jnp.asarray(
            ((resolved << 1) | ispx.astype(np.int64)).astype(np.int32)
        )
        self.px_linear = jnp.asarray(tree.px_linear.astype(np.int32))
        # roots: pre-assigned per-level insertion ranks (they sit in their
        # lists from pass 0, in root_ids order) — O and the per-level append
        # offsets start after them
        rids = tree.root_ids.astype(np.int32)
        rlev = tree.root_levels.astype(np.int32)
        self.nroots = rids.size
        O0 = np.zeros(nn, dtype=np.int32)
        off0 = np.zeros(self.nlev, dtype=np.int32)
        for r, L in zip(rids, rlev):
            O0[r] = off0[L]
            off0[L] += 1
        self.root_ids = jnp.asarray(rids)
        self.root_levels = jnp.asarray(rlev)
        self.O0 = jnp.asarray(O0)
        self.off0 = jnp.asarray(off0)
        self.root_from = jnp.zeros(rids.size, dtype=np.int32)
        self.shallow = self.depth_max <= 10

    # -- walk interface (mirrored by speck_virtual.VirtualLisIndex) ---------
    def children(self, q, svalid, slot):
        """Resolve all child slots of compacted parents q via the child
        table: (cnt [C], rvalid, ispx, isnd [C,MC], vidx [C,MC]); vidx is
        the combined value index (pixel linear id, or n + node id)."""
        cnt = jnp.where(svalid, self.ch_count[q], 0)
        rvalid = slot[None, :] < cnt[:, None]
        ridx = jnp.minimum(
            self.ch_start[q][:, None] + slot[None, :], self.nrows - 1
        )
        crow = self.ctab[ridx]
        ispx = ((crow & 1) == 1) & rvalid
        isnd = ((crow & 1) == 0) & rvalid
        vidx = crow >> 1
        return cnt, rvalid, ispx, isnd, vidx

    def parents_of(self, ids):
        """Parent node id per node (-1 at roots)."""
        return self.parent[ids]

    def levels_of(self, ids):
        return self.level[ids]

    def paths_of(self, ids):
        pw = self.pw[ids]
        nw = 2 if self.shallow else 4
        return [pw[..., k] for k in range(nw)]

    def child_paths(self, q, rslot):
        """Child-slot path words: the parent's path with digit (slot+1) at
        the parent's depth."""
        dq = self.depth[q]
        word = dq // 6
        shift = 5 * (5 - dq % 6)
        dig = (rslot + 1) << shift
        pw = self.pw[q]
        nw = 2 if self.shallow else 4
        return [pw[..., k] + jnp.where(word == k, dig, 0) for k in range(nw)]

    def O0_full(self):
        return jnp.concatenate([self.O0, jnp.zeros(1, jnp.int32)])


def lis_item_count(li, node_cap: int) -> int:
    """Static item count (entries + child rows) of the walk's unified
    emission sort at a given node cap — the T dimension of the dense LIS
    emission matrices (ops/wave_pack.py) and of the walk's `pay_s`."""
    C = int(node_cap)
    MC = int(li.max_ch)
    R = C * MC
    if getattr(li, "uniform_children", False):
        CB = min(C, int(li.nn_inner)) * MC
    else:
        CB = min(R, int(li.nn))
    return CB + int(li.nroots) + R


def _bcast8(x: jnp.ndarray, mc: int) -> jnp.ndarray:
    """[C] -> [C * mc] flat broadcast (pure relayout, no gather)."""
    c = x.shape[0]
    return jnp.broadcast_to(x[:, None], (c, mc)).reshape(c * mc)


def _tiny_lookup(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for a TINY traced table (<= ~32 entries) by compare-sum —
    guaranteed elementwise, never a gather at idx scale."""
    out = jnp.zeros_like(idx)
    for k in range(int(table.shape[0])):
        out = out + jnp.where(idx == k, table[k].astype(jnp.int32), 0)
    return out


def _lis_items_virtual(node_s, s_lin, signs, num_bp, vf, node_cap,
                       vtab=None):
    """Walk-ordered emission items for the virtual (pow-2 cube) forest —
    the round-5 streamlined path behind return_events="items".

    Byte-order-identical to the generic walk below; the cost structure is
    rebuilt around the walk's gather and sort costs:
      * child values arrive as [C] ROW gathers from an 8-aligned table
        (ops/speck_virtual.build_vtab) instead of [C, 8] element gathers;
      * anchor string ranks skip the leaf levels (~3/4 of nn) and are
        gathered per PARENT, broadcast to rows;
      * the insertion-rank sort carries its payloads, so rank inversion,
        the O scatter, the walk-order lexsort and the bincount all vanish:
        w(entry) = suffix-level-total + O is arithmetic because per-level
        O ranks are dense (roots 0.., born off0..);
      * paths are single-word 4-bit keys (depth <= 6), shrinking the two
        big sorts to 4 and 3 operands.
    The one remaining nn-scale scatter maps born entries to their walk
    rank for anchor lookups (w_buf)."""
    nn = vf.nn
    MC = 8
    C = node_cap
    nlev = vf.nlev
    n_sig = jnp.sum(node_s < _NEVER).astype(jnp.int32)

    # ---- compacted significant parents ---------------------------------
    sig_key = jnp.where(node_s < _NEVER, jnp.arange(nn, dtype=jnp.int32), nn)
    (sid_s,) = jax.lax.sort((sig_key,), num_keys=1, is_stable=False)
    if C > nn:
        sid_s = jnp.concatenate([sid_s, jnp.full(C - nn, nn, jnp.int32)])
    sid = sid_s[:C]
    svalid = sid < nn
    q = jnp.minimum(sid, nn - 1)
    slot = jnp.arange(MC, dtype=jnp.int32)

    # pixel table values pack clip(s, 0, 127) | sign << 7 [| extra bits
    # above — e.g. the emitter's magnitudes ride bits 8.. so ONE
    # box-major relayout serves both the walk and the exposure
    # compaction]; node sections hold raw node_s
    if vtab is None:
        vtab = vf.build_vtab(
            jnp.clip(s_lin, 0, 127) | (signs.astype(jnp.int32) << 7),
            node_s,
        )
    cnt, rvalid, ispx, isnd, vidx, v = vf.children_rows(q, svalid, slot, vtab)
    rowpass = jnp.where(svalid, node_s[q], _NEVER)
    row_s = jnp.where(
        rvalid, jnp.where(ispx, v & 127, v & _NEVER), _NEVER
    )
    row_sign = ((v >> 7) & 1) == 1

    sig_now = (row_s == rowpass[:, None]) & rvalid
    prev_any = jnp.cumsum(sig_now, axis=1) - sig_now
    last = slot[None, :] == cnt[:, None] - 1
    emitted = ((prev_any > 0) | ~last) & rvalid

    # ---- anchors (dense, leaf levels unranked) --------------------------
    from . import speck_virtual as _svirt

    J_full, R_full = _svirt.dense_anchor_ranks(node_s, vf)
    anchor = jnp.where(svalid, J_full[q], q)           # [C]
    a_rank_par = R_full[jnp.minimum(anchor, nn - 1)]   # [C] gather
    alev_par = vf.levels_of(jnp.minimum(anchor, nn - 1))

    # ---- born rows (parent-form; compaction only when the cap bites) ----
    eligible = isnd[:, 0] & svalid
    C2 = min(C, int(vf.nn_inner))
    if C2 < C:
        key2 = jnp.where(eligible, jnp.arange(C, dtype=jnp.int32), C)
        key2_s, bn2_s, an_r, ar2_s, al2_s = jax.lax.sort(
            (key2, rowpass, anchor, a_rank_par, alev_par),
            num_keys=1, is_stable=False,
        )
        bok2 = key2_s[:C2] < C
        qidx = jnp.minimum(key2_s[:C2], C - 1)
        bid2 = (jnp.minimum(vidx, vf.n + nn - 1) - vf.n)[qidx]
        sval2 = (v & _NEVER)[qidx]
        bn2, ar2, al2 = bn2_s[:C2], ar2_s[:C2], al2_s[:C2]
    else:
        bok2 = eligible
        qidx = None
        bid2 = jnp.minimum(vidx, vf.n + nn - 1) - vf.n
        sval2 = v & _NEVER
        bn2, ar2, al2 = rowpass, a_rank_par, alev_par
    CB = C2 * MC
    bok = _bcast8(bok2.astype(jnp.int32), MC) == 1
    c_bid = jnp.where(bok, bid2.reshape(CB), nn)
    c_bn = jnp.where(bok, _bcast8(bn2, MC), _BIG)
    c_arank = jnp.where(bok, _bcast8(ar2, MC), 0)
    c_alev5 = jnp.where(bok, _bcast8(31 - al2, MC), 0)
    c_s = jnp.where(bok, sval2.reshape(CB), _NEVER)
    bidc = jnp.minimum(c_bid, nn - 1)
    c_lev = vf.levels_of(bidc)
    c_pw = vf.sort_paths_of(bidc)

    # ---- insertion ranks: ONE payload-carrying sort ---------------------
    k_lba = jnp.where(
        bok,
        (c_lev << 11) | (jnp.clip(c_bn, 0, 63) << 5) | c_alev5,
        _BIG,
    )
    ops_o = (k_lba, c_arank, *c_pw, c_bid, c_s)
    out_o = jax.lax.sort(ops_o, num_keys=len(ops_o) - 2, is_stable=False)
    k_s, bid_s, s_s = out_o[0], out_o[-2], out_o[-1]
    bok_s = k_s < _BIG
    iota_cb = jnp.arange(CB, dtype=jnp.int32)
    ls_lev = jnp.where(bok_s, k_s >> 11, nlev)
    newblk = jnp.concatenate(
        [jnp.ones(1, bool), ls_lev[1:] != ls_lev[:-1]]
    )
    bstart = jax.lax.cummax(jnp.where(newblk, iota_cb, 0), axis=0)
    lev_c = jnp.minimum(ls_lev, nlev - 1)
    o_val = _tiny_lookup(vf.off0, lev_c) + (iota_cb - bstart)

    # per-level totals -> suffix-above -> arithmetic walk ranks: O ranks
    # are DENSE per level (roots 0.., born off0..), so the walk position
    # (levels desc, O asc) is suffix_total(level) + O — no lexsort
    counts_lev = jnp.stack(
        [jnp.sum((ls_lev == L).astype(jnp.int32)) for L in range(nlev)]
    )
    totals = vf.off0.astype(jnp.int32) + counts_lev
    rev = jnp.cumsum(totals[::-1])
    suffix_above = jnp.concatenate(
        [rev[::-1][1:], jnp.zeros(1, jnp.int32)]
    )  # sum of totals at levels > L
    w_born = jnp.where(
        bok_s, _tiny_lookup(suffix_above, lev_c) + o_val, _BIG
    )
    rlev = vf.root_levels.astype(jnp.int32)
    w_roots = suffix_above[rlev] + vf.O0_head.astype(jnp.int32)

    # ---- anchor walk-rank lookup (the one nn-scale scatter) -------------
    w_buf = (
        jnp.full(nn + 1, _BIG, jnp.int32)
        .at[jnp.where(bok_s, bid_s, nn)]
        .set(w_born, mode="drop")
    )
    w_buf = w_buf.at[vf.root_ids].set(w_roots)
    w_top = _bcast8(w_buf[jnp.minimum(anchor, nn - 1)], MC)  # [C]->[R]

    # ---- items: entries (born sorted-order ++ roots) ++ child rows ------
    R = C * MC
    ent_id = jnp.concatenate([bid_s, vf.root_ids])
    ent_ok = jnp.concatenate([bok_s, jnp.ones(vf.nroots, bool)])
    ent_from = jnp.concatenate(
        [((k_s >> 5) & 63) + 1, vf.root_from]
    )
    ent_s = jnp.concatenate([s_s, node_s[vf.root_ids]])
    # paths from ids, arithmetic (roots are depth-0 -> empty words)
    ent_pw = vf.sort_paths_of(jnp.minimum(ent_id, nn - 1))
    kw_ent = jnp.concatenate([w_born, w_roots])

    qb = _bcast8(q, MC)
    slotb = jnp.broadcast_to(slot[None, :], (C, MC)).reshape(R)
    rp = vf.sort_child_paths(qb, slotb)
    rowpassf = _bcast8(rowpass, MC)
    sig_nowf = sig_now.reshape(R)
    emittedf = emitted.reshape(R)
    ispxf = ispx.reshape(R)
    row_signf = (row_sign & ispx).reshape(R)

    ent_lo = jnp.clip(ent_from, 0, 63)
    ent_s6 = jnp.clip(ent_s, 0, 63)
    pay_ent = (
        1
        | (ent_lo << 1)
        | (ent_s6 << 7)
        | (ent_ok.astype(jnp.int32) << 17)
    )
    row_hs = ispxf & sig_nowf
    pay_row = (
        (jnp.clip(rowpassf, 0, 63) << 1)
        | (row_signf.astype(jnp.int32) << 13)
        | (sig_nowf.astype(jnp.int32) << 14)
        | (row_hs.astype(jnp.int32) << 15)
        | (emittedf.astype(jnp.int32) << 16)
    )
    kw_all = jnp.concatenate([kw_ent, w_top])
    kpath = [
        jnp.concatenate([e_w, r_w]) for e_w, r_w in zip(ent_pw, rp)
    ]
    pay = jnp.concatenate([pay_ent, pay_row])
    ops = (kw_all, *kpath, pay)
    out = jax.lax.sort(ops, num_keys=len(ops) - 1, is_stable=False)
    return out[-1], n_sig


_LIS_INDEXES = {}


def lis_index(dims) -> LisIndex:
    key = tuple(int(d) for d in dims)
    li = _LIS_INDEXES.get(key)
    if li is None:
        li = LisIndex(key)
        _LIS_INDEXES[key] = li
    return li


def lis_segments_device(
    node_s: jnp.ndarray,
    s_lin: jnp.ndarray,
    signs: jnp.ndarray,
    num_bp: jnp.ndarray,
    li: LisIndex,
    num_bp_cap: int,
    node_cap: int,
    ev_cap: int,
    cap_total: int,
    return_events: bool = False,
    vtab=None,
):
    """All LIS bit segments on the device, event-form.

    Returns (buf u8[cap_total], counts i32[num_bp_cap], total_bytes i32,
    n_sig i32): `buf` is the byte-aligned concatenation of the per-pass
    segments (pass p occupies bytes [sum of earlier (counts+7)//8,
    +(counts[p]+7)//8)), bit-identical to
    codec.speck_sorted.lis_segments_sorted.  `ev_cap` bounds the total
    emitted-bit events (~ the LIS share of the stream); on overflow of the
    event or byte caps n_sig is raised past any node_cap so the driver
    falls back to the host stitcher.

    Cost shape (all device): two child-table gathers at R = sig-parents x
    max-children, ~log2(depth) rank-doubling sorts over the node table
    plus ONE insertion-rank sort over <= node-count
    rows, ONE payload-carrying item sort over born-entries + child rows,
    a forward-fill interval expansion (no event-scale gathers), and one
    stable pass sort + one scatter over the emitted bits.  `li` is either
    a table-backed LisIndex or a speck_virtual.VirtualLisIndex (arithmetic
    child/anchor/path resolution, no per-node tables)."""
    from .speck_jax import _expand_fill, events_to_segments

    if return_events == "items" and getattr(li, "uniform_children", False):
        return _lis_items_virtual(
            node_s, s_lin, signs, num_bp, li, node_cap, vtab=vtab
        )

    nn = li.nn
    MC = li.max_ch
    C = node_cap
    n_sig = jnp.sum(node_s < _NEVER).astype(jnp.int32)

    # ---- significant sets (the partitioned parents), compacted ------------
    # sort compaction: the key IS the node id, so one 1-operand sort
    # replaces nonzero's cumsum+scatter (no gathers)
    sig_key = jnp.where(
        node_s < _NEVER, jnp.arange(nn, dtype=jnp.int32), nn
    )
    (sid_s,) = jax.lax.sort((sig_key,), num_keys=1, is_stable=False)
    if C > nn:  # caps may exceed the node count; pad with invalid ids
        sid_s = jnp.concatenate(
            [sid_s, jnp.full(C - nn, nn, jnp.int32)]
        )
    sid = sid_s[:C]
    svalid = sid < nn
    q = jnp.minimum(sid, nn - 1)                     # [C]
    slot = jnp.arange(MC, dtype=jnp.int32)
    cnt, rvalid, ispx, isnd, vidx = li.children(q, svalid, slot)
    rowpass = jnp.where(svalid, node_s[q], _NEVER)   # [C] = children's birth

    # combined value table: one gather yields the child's significance pass
    # (s for pixels, node_s for sets) and the pixel sign in bit 15
    sval = jnp.concatenate(
        [s_lin | (signs.astype(jnp.int32) << 15), node_s]
    )
    v = sval[jnp.where(rvalid, vidx, 0)]
    row_s = jnp.where(rvalid, v & _NEVER, _NEVER)
    row_sign = ((v >> 15) & 1) == 1

    sig_now = (row_s == rowpass[:, None]) & rvalid
    prev_any = jnp.cumsum(sig_now, axis=1) - sig_now
    last = slot[None, :] == cnt[:, None] - 1
    emitted = ((prev_any > 0) | ~last) & rvalid

    # ---- anchors + transitive anchor ranks ---------------------------------
    # A node's chain anchor is its topmost ancestor reachable through nodes
    # partitioning at the SAME pass; born entries tie-break by the
    # lexicographic order of the chain's hop-word string
    #   u(z) = (0 | O0(z))                    for roots
    #        = (1 | bn(z) | 31 - lev(next(z))) for born nodes
    # with next(z) = J(parent(z)) (every intermediate path(a_i) is a prefix
    # of path(x), so comparing path(x) alone stays sign-identical; roots
    # order before born nodes at the same level exactly as their
    # pre-assigned O0 < every born rank).  Ranks are only ever compared
    # between anchors of the SAME level (the O-sort keys anchor level
    # first), which admits two executions:
    #   * virtual forest: dense per-depth/per-level computation
    #     (speck_virtual.dense_anchor_ranks) — parent->child propagation
    #     is a suffix slice + repeat, ranking is per-level sorts summing
    #     to nn; no nn-scale gathers (they dominated the 256^3 walk);
    #   * table-backed trees (non-pow2 remainder chunks): the original
    #     pointer-doubling (J = J[J]) + suffix-array doubling ladder.
    if getattr(li, "uniform_children", False):
        from . import speck_virtual as _svirt

        J_full, R_full = _svirt.dense_anchor_ranks(node_s, li)
        anchor = jnp.where(svalid, J_full[q], q)
        R_rank = jnp.concatenate([R_full, jnp.zeros(1, jnp.int32)])
    else:
        ids = jnp.arange(nn, dtype=jnp.int32)
        par = li.parents_of(ids)                    # -1 at roots
        is_root = par < 0
        par_c = jnp.maximum(par, 0)
        ns_par = node_s[par_c]
        J = jnp.where((~is_root) & (ns_par == node_s), par_c, ids)
        for _ in range(max(1, li.depth_max.bit_length())):
            J = J[J]
        anchor = jnp.where(svalid, J[q], q)

        nxt = jnp.where(is_root, nn, J[par_c])
        nxt = jnp.concatenate([nxt, jnp.full(1, nn, jnp.int32)])
        lev_all = li.levels_of(ids)
        lev_nxt = lev_all[jnp.minimum(nxt[:nn], nn - 1)]
        u = jnp.where(
            is_root,
            li.O0_full()[:nn],
            (1 << 11) | (jnp.clip(ns_par, 0, 63) << 5) | (31 - lev_nxt),
        )
        R_rank = jnp.concatenate([u, jnp.zeros(1, jnp.int32)])
        iota_n1 = jnp.arange(nn + 1, dtype=jnp.int32)
        for _ in range(max(1, li.depth_max.bit_length())):
            r1s, r2s, idx_s = jax.lax.sort(
                (R_rank, R_rank[nxt], iota_n1), num_keys=2, is_stable=False
            )
            diff = jnp.concatenate(
                [
                    jnp.zeros(1, jnp.int32),
                    ((r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])).astype(
                        jnp.int32
                    ),
                ]
            )
            R_rank = (
                jnp.zeros(nn + 1, jnp.int32).at[idx_s].set(jnp.cumsum(diff))
            )
            nxt = nxt[nxt]

    # ---- O: per-level insertion order of born nodes (roots pre-assigned) --
    R = C * MC
    bidf = jnp.where(isnd, vidx - li.n, nn).reshape(R)  # born ids (nn = inv)
    bnf = jnp.broadcast_to(rowpass[:, None], (C, MC)).reshape(R)
    anf = jnp.broadcast_to(anchor[:, None], (C, MC)).reshape(R)
    bornf = isnd.reshape(R)
    nlev = li.nlev

    # Compact the BORN rows once: only they receive insertion ranks (and
    # serve as list entries), and they number at most min(all child slots,
    # the node count).  If a reduced node_cap ever drops born rows, n_sig
    # is raised past the cap so the driver falls back to the host stitcher
    # instead of mis-ranking.
    if getattr(li, "uniform_children", False):
        # Parent-form: in a full-octant forest born-ness is a PARENT
        # property (children are uniformly nodes iff side >= 4), so one
        # 3-operand sort over the C parents replaces the 4-operand sort
        # over all R = C*MC child rows; eligible parents are bounded
        # exactly by li.nn_inner (the inner-node count), so under
        # n_sig <= C this compaction can never overflow.
        eligible = isnd[:, 0]
        C2 = min(C, int(li.nn_inner))
        key2 = jnp.where(eligible, jnp.arange(C, dtype=jnp.int32), C)
        key2_s, bn2_s, an2_s = jax.lax.sort(
            (key2, rowpass, anchor), num_keys=1, is_stable=False
        )
        bok2 = key2_s[:C2] < C
        qidx = jnp.minimum(key2_s[:C2], C - 1)
        bid2 = (jnp.minimum(vidx, li.n + nn - 1) - li.n)[qidx]  # [C2, MC]
        CB = C2 * MC
        bok = jnp.broadcast_to(bok2[:, None], (C2, MC)).reshape(CB)
        c_bid = jnp.where(bok, bid2.reshape(CB), nn)
        c_bn = jnp.where(
            bok,
            jnp.broadcast_to(bn2_s[:C2, None], (C2, MC)).reshape(CB),
            _BIG,
        )
        c_an = jnp.where(
            bok,
            jnp.broadcast_to(an2_s[:C2, None], (C2, MC)).reshape(CB),
            nn,
        )
        n_born = jnp.int32(0)  # cannot overflow (exact structural bound)
    else:
        CB = min(R, nn)
        n_born = jnp.sum(bornf).astype(jnp.int32)
        # payload-carrying sort compaction of the born rows (id, birth,
        # anchor)
        bkey = jnp.where(bornf, jnp.arange(R, dtype=jnp.int32), R)
        bkey_s, bid_s, bn_s, an_s = jax.lax.sort(
            (bkey, bidf, bnf, anf), num_keys=1, is_stable=False
        )
        bok = bkey_s[:CB] < R
        c_bid = jnp.where(bok, bid_s[:CB], nn)
        c_bn = jnp.where(bok, bn_s[:CB], _BIG)
        c_an = jnp.where(bok, an_s[:CB], nn)
    bidc = jnp.minimum(c_bid, nn - 1)
    c_lev = li.levels_of(bidc)
    c_pw = li.paths_of(bidc)                   # list of path words [CB]
    c_alev5 = 31 - li.levels_of(jnp.minimum(c_an, nn - 1))

    # Insertion ranks in ONE sort: O(x) within level = rank by (level,
    # birth pass, anchor level finer-first, TRANSITIVE anchor rank, path).
    # R_rank already encodes the whole O(anchor) recursion, so no
    # refinement sweeps are needed.  Level, birth and anchor-level pack
    # into one key word; paths use two words when the tree is shallow
    # enough (always, for production chunk dims).
    k_lba = jnp.where(
        bok,
        (c_lev << 11) | (jnp.clip(c_bn, 0, 63) << 5) | c_alev5,
        _BIG,
    )
    counts_lev = jnp.bincount(
        jnp.where(bok, c_lev, nlev), length=nlev + 1
    ).astype(jnp.int32)[:nlev]
    lstarts = jnp.cumsum(counts_lev) - counts_lev
    iota_cb = jnp.arange(CB, dtype=jnp.int32)

    a_rank = R_rank[jnp.minimum(c_an, nn)]
    ops_o = (k_lba, a_rank, *c_pw, iota_cb)
    out_o = jax.lax.sort(ops_o, num_keys=len(ops_o) - 1, is_stable=False)
    rankpos = jnp.zeros(CB, jnp.int32).at[out_o[-1]].set(iota_cb)
    o_val = li.off0[c_lev] + (rankpos - lstarts[c_lev])
    O_buf = li.O0_full().at[jnp.where(bok, c_bid, nn)].set(o_val, mode="drop")
    n_sig = jnp.maximum(n_sig, jnp.where(n_born > CB, _BIG, 0))

    # ---- w: global walk order over list entries (levels desc, O asc) ------
    nroots = li.nroots
    E = CB + nroots
    ent_id = jnp.concatenate([c_bid, li.root_ids])
    ent_ok = jnp.concatenate([bok, jnp.ones(nroots, bool)])
    ent_idc = jnp.minimum(ent_id, nn - 1)
    ent_lev = jnp.concatenate([c_lev, li.root_levels])
    ent_O = O_buf[ent_idc]
    worder = jnp.lexsort(
        (ent_O, -ent_lev, ~ent_ok)
    )  # valid first, levels desc, O asc
    w_sorted = jnp.arange(E, dtype=jnp.int32)
    w_of_ent = jnp.zeros(E, jnp.int32).at[worder].set(w_sorted)
    w_buf = (
        jnp.full(nn + 1, _BIG, jnp.int32)
        .at[jnp.where(ent_ok, ent_id, nn)]
        .set(w_of_ent, mode="drop")
    )

    ent_from = jnp.concatenate([c_bn + 1, li.root_from])
    ent_s = node_s[ent_idc]
    # entry path words: born entries reuse c_pw; roots have empty paths
    rz = jnp.zeros(nroots, jnp.int32)
    ent_pw = [jnp.concatenate([w, rz]) for w in c_pw]

    # ---- per-row static keys ----------------------------------------------
    w_top = jnp.broadcast_to(w_buf[anchor][:, None], (C, MC)).reshape(R)
    rp = li.child_paths(
        jnp.broadcast_to(q[:, None], (C, MC)).reshape(R),
        jnp.broadcast_to(slot[None, :], (C, MC)).reshape(R),
    )
    rowpassf = jnp.broadcast_to(rowpass[:, None], (C, MC)).reshape(R)
    sig_nowf = sig_now.reshape(R)
    emittedf = emitted.reshape(R)
    ispxf = ispx.reshape(R)
    row_signf = (row_sign & ispx).reshape(R)

    # ------------------------------------------------------------------
    # Unified emission items: list ENTRIES (one membership bit per pass in
    # [from, s], value s == p) ++ child ROWS (a decision bit at the
    # parent's partition pass when not skipped, plus the pixel sign right
    # after it when the pixel turns significant — the sign rides its own
    # row exactly like the LIP sign rides its interval).  One payload-
    # carrying sort puts items in walk order; forward-fill expansion and a
    # stable pass sort then reproduce the per-pass sequences.  This
    # replaces the old entries ++ decisions ++ signs triple (2x the rows)
    # plus 8 post-sort gathers.
    #
    # Payload bits: 0 is_ent | 1-6 lo | 7-12 s | 13 sign | 14 sig_now |
    # 15 has_sign | 16 dec_emitted | 17 ok.
    # ------------------------------------------------------------------
    T = E + R
    kw_all = jnp.concatenate([w_of_ent, w_top])
    kpath = [jnp.concatenate([e_w, r_w]) for e_w, r_w in zip(ent_pw, rp)]

    ent_lo = jnp.clip(ent_from, 0, 63)
    ent_s6 = jnp.clip(ent_s, 0, 63)
    pay_ent = (
        1
        | (ent_lo << 1)
        | (ent_s6 << 7)
        | (ent_ok.astype(jnp.int32) << 17)
    )
    row_hs = ispxf & sig_nowf
    pay_row = (
        (jnp.clip(rowpassf, 0, 63) << 1)
        | (row_signf.astype(jnp.int32) << 13)
        | (sig_nowf.astype(jnp.int32) << 14)
        | (row_hs.astype(jnp.int32) << 15)
        | (emittedf.astype(jnp.int32) << 16)
    )
    pay = jnp.concatenate([pay_ent, pay_row])

    ops = (kw_all, *kpath, pay)
    out = jax.lax.sort(ops, num_keys=len(ops) - 1, is_stable=False)
    pay_s = out[-1]

    if return_events == "items":
        # prefix-pack mode (ops/wave_pack.py): the caller builds dense
        # [pass, item] emission matrices straight from the walk-ordered
        # payloads — no interval expansion, no event sort.  Event-cap
        # overflow cannot occur (there is no event buffer); only the
        # node-cap/born overflows poison n_sig.
        return pay_s, n_sig

    is_ent_s = (pay_s & 1) == 1
    lo_s = (pay_s >> 1) & 63
    s6_s = (pay_s >> 7) & 63
    hs_s = (pay_s >> 15) & 1
    dec_s = (pay_s >> 16) & 1
    ok_s = (pay_s >> 17) & 1
    ent_hi = jnp.minimum(s6_s, num_bp - 1)
    ln = jnp.where(
        is_ent_s,
        jnp.where((ok_s == 1) & (lo_s <= ent_hi), ent_hi - lo_s + 1, 0),
        dec_s + hs_s,
    )

    (payf,), rel, ev_ok, ev_total = _expand_fill(
        ln, [pay_s], ev_cap, widths=[18]
    )
    is_ent_f = (payf & 1) == 1
    lo_f = (payf >> 1) & 63
    s6_f = (payf >> 7) & 63
    sign_f = (payf >> 13) & 1
    signow_f = (payf >> 14) & 1
    dec_f = (payf >> 16) & 1
    p_ev = jnp.where(is_ent_f, lo_f + rel, lo_f)
    is_sign_ev = (~is_ent_f) & (rel == dec_f)  # sign follows its decision
    bit_ev = jnp.where(
        is_ent_f,
        s6_f == p_ev,
        jnp.where(is_sign_ev, sign_f == 1, signow_f == 1),
    )
    p_key = jnp.where(ev_ok, p_ev, num_bp_cap)
    if return_events:
        # merged-pack mode: the caller feeds these to
        # speck_jax.events_to_segments_merged together with the LIP and
        # refinement classes; byte-cap checks happen there.  Event-cap
        # overflow still forces the host fallback via n_sig.
        n_sig = jnp.maximum(
            n_sig, jnp.where(ev_total > ev_cap, _BIG, 0)
        )
        return p_key, bit_ev, n_sig
    buf, counts, total_bytes = events_to_segments(
        p_key, None, bit_ev, num_bp_cap, cap_total
    )

    # overflow (event cap or byte cap) -> force the host fallback
    n_sig = jnp.maximum(
        n_sig,
        jnp.where((ev_total > ev_cap) | (total_bytes > cap_total), _BIG, 0),
    )
    return buf, counts, total_bytes, n_sig


__all__ = ["LisIndex", "lis_index", "lis_segments_device"]
