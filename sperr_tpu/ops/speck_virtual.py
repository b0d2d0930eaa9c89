"""Table-free SPECK partition forest for power-of-two cube dims.

The LIS set walk (ops/speck_lis_jax.py) consumes per-node quantities —
parent, level, path digits, child resolution — that the table-backed
``LisIndex`` gathers from host-built arrays: the child table alone is
O(n) rows (~76 MB at 256**3) and the tree build costs ~10 s of host time
per dims (docs/ROADMAP.md #2).  For power-of-two cube dims the forest is
perfectly regular, so every one of those quantities is arithmetic:

  * the roots are the wavelet subbands — ``big`` (the coarsest LLL cube)
    plus 7 octant complements per split level, all power-of-two cubes
    (codec/speck_wave._initial_sets, dyadic branch; reference
    SPECK3D_INT.cpp:22-97);
  * below a root every partition is a full octant split, so a node is
    identified by (root, depth, morton) where morton's 3-bit digits are
    the child slots along the path (x fastest, matching
    speck_wave._children_of's oct8 order);
  * the BFS node numbering of ``build_tree`` is depth-major, root-major,
    morton-minor — so ids convert to and from (root, depth, morton) with
    two tiny static tables (per-depth id bases and first contributing
    root), verified against the built tree in tests/test_speck_virtual.py.

``VirtualLisIndex`` exposes the same walk interface as ``LisIndex`` with
O(#roots) device constants, and ``pixel_schedule_virtual`` produces the
(s, e, node-max) schedule from plain max-pool pyramids with the per-depth
node ordering materialized by reshape/transpose morton interleaving — no
gather tables, no host tree build.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dims import can_use_dyadic

_NEVER = 0x7FFF


def _is_pow2_cube(dims) -> bool:
    nx, ny, nz = (int(d) for d in dims)
    return (
        nx == ny == nz
        and nx >= 2
        and (nx & (nx - 1)) == 0
        and can_use_dyadic((nx, ny, nz)) is not None
    )


class VirtualLisIndex:
    """Walk-interface index for power-of-two cube dims, no per-node tables.

    Static device constants are O(#roots): root origins / side logs /
    levels, per-depth id bases, and the root pre-assignment ranks.  The
    interface methods mirror LisIndex's (speck_lis_jax.py); ids are the
    partition tree's BFS numbering.
    """

    __slots__ = (
        "dims", "K", "n", "nn", "nn_inner", "nroots", "depth_max", "nlev",
        "max_ch", "shallow",
        # tiny device arrays
        "r_slog", "r_org", "r_level", "depth_base", "r0",
        "root_ids", "root_levels", "root_from", "off0", "O0_head",
        # host copies for schedule construction
        "h_slog", "h_org", "h_depth_base", "h_r0",
        # 8-aligned child value table geometry (children_rows/build_vtab)
        "h_A8", "A8", "nt", "h_slog_starts",
    )

    # every node's children are uniformly pixels or uniformly nodes (full
    # octant splits): enables the parent-form born compaction in the walk
    uniform_children = True

    def __init__(self, dims):
        nx, ny, nz = (int(d) for d in dims)
        if not _is_pow2_cube((nx, ny, nz)):
            raise ValueError("VirtualLisIndex requires power-of-two cube dims")
        N = nx
        K = N.bit_length() - 1
        xf = can_use_dyadic((N, N, N))
        self.dims = (N, N, N)
        self.K = K
        self.n = N * N * N

        # roots in morton-assignment order: levels finest-first, `big`
        # first within its level (speck_wave.build_tree:193-204)
        orgs: List[Tuple[int, int, int]] = [(0, 0, 0)]
        slogs: List[int] = [K - xf]
        levels: List[int] = [3 * xf]
        for i in range(xf - 1, -1, -1):
            h = N >> (i + 1)
            for k in range(1, 8):
                orgs.append(((k & 1) * h, ((k >> 1) & 1) * h, (k >> 2) * h))
                slogs.append(K - (i + 1))
                levels.append(3 * (i + 1))
        R = len(orgs)
        self.nroots = R
        slog = np.asarray(slogs, dtype=np.int32)
        org = np.asarray(orgs, dtype=np.int32)  # (x, y, z)
        rlev = np.asarray(levels, dtype=np.int32)
        # sides are nondecreasing in root order: depth-d nodes come from the
        # contiguous suffix of roots with side >= 2^(d+1)
        assert (np.diff(slog) >= 0).all()

        self.depth_max = max(int(slog.max()) - 1, 0)
        D = self.depth_max
        # id numbering: depth-major, then root-major, then morton.
        # depth_base[d] = first id at depth d; r0[d] = first contributing root
        r0 = np.empty(D + 2, dtype=np.int32)
        counts = np.empty(D + 2, dtype=np.int64)
        for d in range(D + 2):
            contrib = slog >= d + 1
            r0[d] = int(np.argmax(contrib)) if contrib.any() else R
            counts[d] = int(contrib.sum()) << (3 * d)
        depth_base = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.nn = int(depth_base[D + 1])
        assert self.nn < 2**31
        # nodes whose children are NODES (side >= 4): depth-d nodes from
        # roots with slog >= d+2.  Exact bound for the parent-form born
        # compaction in the LIS walk (children of a node are uniformly
        # pixels or nodes in this forest).
        self.nn_inner = int(
            sum(
                int((slog >= d + 2).sum()) << (3 * d) for d in range(D + 1)
            )
        )
        self.nlev = 3 * K + 1  # num_of_partitions(2^K) per axis = K

        # root pre-assignment: per-level insertion ranks in root order
        O0_head = np.zeros(R, dtype=np.int32)
        off0 = np.zeros(self.nlev, dtype=np.int32)
        for r in range(R):
            L = int(rlev[r])
            O0_head[r] = off0[L]
            off0[L] += 1

        self.max_ch = 8
        self.shallow = True
        assert D + 1 <= 12, "virtual path packing supports depth <= 12"

        self.h_slog = slog
        self.h_org = org
        self.h_depth_base = depth_base
        self.h_r0 = r0
        self.r_slog = jnp.asarray(slog)
        self.r_org = jnp.asarray(org)
        self.r_level = jnp.asarray(rlev)
        self.depth_base = jnp.asarray(depth_base.astype(np.int32))
        self.r0 = jnp.asarray(r0)
        self.root_ids = jnp.arange(R, dtype=jnp.int32)
        self.root_levels = jnp.asarray(rlev)
        self.root_from = jnp.zeros(R, dtype=jnp.int32)
        self.off0 = jnp.asarray(off0)
        self.O0_head = jnp.asarray(O0_head)

        # 8-aligned combined child-value table (build_vtab/children_rows):
        # [0, n) = pixel section in 2x2x2-box-major order (box slot order
        # dz dy dx, x fastest — children()'s slot order), then one node_s
        # section per depth, each 8-aligned so every child octet is ONE
        # table row — the [C, 8] element gathers of the walk become row
        # gathers.
        A8 = np.zeros(D + 2, dtype=np.int64)
        off = self.n
        for d in range(D + 1):
            cnt = int(depth_base[d + 1] - depth_base[d])
            A8[d] = off // 8
            off += cnt + ((-cnt) % 8)
        self.nt = int(off)
        self.h_A8 = A8
        self.A8 = jnp.asarray(A8.astype(np.int32))
        # slog[r] as a run-start sum: slog[r] = base + sum_v (r >= start_v)
        # over the <= K distinct slog run boundaries (slog nondecreasing) —
        # a tiny static loop instead of a root-table gather
        starts = []
        for v in range(int(slog[0]) + 1, int(slog[-1]) + 1):
            starts.append(int(np.argmax(slog >= v)))
        self.h_slog_starts = (int(slog[0]), tuple(starts))

    # -- id <-> (root, depth, morton) ---------------------------------------
    def _decode_sums(self, ids):
        """(d, depth_base[d], r0[d]) by static compare-sum over the tiny
        depth table — guaranteed elementwise (no gather lowering)."""
        db = self.h_depth_base
        r0 = self.h_r0
        d = jnp.zeros_like(ids)
        dbase = jnp.zeros_like(ids)
        rbase = jnp.full_like(ids, int(r0[0]))
        for k in range(1, self.depth_max + 2):
            ge = ids >= int(db[k])
            d = d + ge
            dbase = dbase + jnp.where(ge, jnp.int32(int(db[k] - db[k - 1])), 0)
            rbase = rbase + jnp.where(ge, jnp.int32(int(r0[k] - r0[k - 1])), 0)
        return d, dbase, rbase

    def decode(self, ids):
        """ids (any shape, values in [0, nn)) -> (r, d, m), elementwise."""
        d, dbase, rbase = self._decode_sums(ids)
        rem = ids - dbase
        r = rbase + (rem >> (3 * d))
        m = rem & ((jnp.int32(1) << (3 * d)) - 1)
        return r, d, m

    def slog_of_roots(self, r):
        """slog[r] elementwise via the static run-start sum (no gather)."""
        base, starts = self.h_slog_starts
        v = jnp.full_like(r, base)
        for s0 in starts:
            v = v + (r >= s0)
        return v

    def nid(self, r, d, m):
        """(r, d, m) -> id; d is clamped into range (callers mask misuse)."""
        dc = jnp.clip(d, 0, self.depth_max)
        return self.depth_base[dc] + ((r - self.r0[dc]) << (3 * dc)) + m

    def _unmorton(self, m):
        """3-bit-digit deinterleave: morton -> (bx, by, bz) box coords."""
        bx = jnp.zeros_like(m)
        by = jnp.zeros_like(m)
        bz = jnp.zeros_like(m)
        for t in range(self.depth_max + 1):
            bx = bx | (((m >> (3 * t)) & 1) << t)
            by = by | (((m >> (3 * t + 1)) & 1) << t)
            bz = bz | (((m >> (3 * t + 2)) & 1) << t)
        return bx, by, bz

    def _path_words(self, d, m):
        """Packed path-digit words (depth j digit at word j//6, shift
        5*(5 - j%6)), matching codec/speck_sorted.py's layout."""
        w0 = jnp.zeros_like(m)
        w1 = jnp.zeros_like(m)
        for j in range(self.depth_max + 1):
            # depth-j digit = slot+1 = ((m >> 3*(d-1-j)) & 7) + 1 for j < d
            sh = jnp.maximum(3 * (d - 1 - j), 0)
            dig = jnp.where(j < d, ((m >> sh) & 7) + 1, 0)
            if j < 6:
                w0 = w0 | (dig << (5 * (5 - j)))
            else:
                w1 = w1 | (dig << (5 * (11 - j)))
        return [w0, w1]

    # -- walk interface (mirrors LisIndex) ----------------------------------
    def children(self, q, svalid, slot):
        """Resolve all child slots of compacted parents q: returns
        (cnt [C], rvalid, ispx, isnd [C,MC], vidx [C,MC]) where vidx is the
        combined value index (pixel linear id, or n + node id)."""
        N = self.dims[0]
        r, d, m = self.decode(q)
        side_log = self.r_slog[r] - d
        cnt = jnp.where(svalid, 8, 0)
        rvalid = slot[None, :] < cnt[:, None]
        px_parent = side_log == 1  # children are pixels
        ispx = px_parent[:, None] & rvalid
        isnd = (~px_parent)[:, None] & rvalid
        mc = (m[:, None] << 3) + slot[None, :]
        cid = self.nid(r[:, None], (d + 1)[:, None], mc)
        # pixel linear ids: box origin + octant offset
        bx, by, bz = self._unmorton(m)
        ox = self.r_org[r, 0] + (bx << 1)
        oy = self.r_org[r, 1] + (by << 1)
        oz = self.r_org[r, 2] + (bz << 1)
        px = ox[:, None] + (slot[None, :] & 1)
        py = oy[:, None] + ((slot[None, :] >> 1) & 1)
        pz = oz[:, None] + (slot[None, :] >> 2)
        lin = (pz * N + py) * N + px
        vidx = jnp.where(ispx, lin, self.n + cid)
        return cnt, rvalid, ispx, isnd, vidx

    def org_of_roots(self, r):
        """Root origin (ox, oy, oz) elementwise (no table gather): split
        root r of split level i is octant k with h = N >> (i+1)."""
        N = self.dims[0]
        slog = self.slog_of_roots(r)
        xf = self.K - int(self.h_slog[0])
        i = self.K - slog - 1
        g0 = 1 + 7 * (xf - 1 - i)
        k = r - g0 + 1  # octant index runs 1..7 within a split level
        h = N >> jnp.clip(self.K - slog, 0, 30)
        ox = jnp.where(r > 0, (k & 1) * h, 0)
        oy = jnp.where(r > 0, ((k >> 1) & 1) * h, 0)
        oz = jnp.where(r > 0, (k >> 2) * h, 0)
        return ox, oy, oz

    def parents_of(self, ids):
        """Parent node id per node (-1 at roots), arithmetically."""
        r, d, m = self.decode(ids)
        pid = self.nid(r, jnp.maximum(d - 1, 0), m >> 3)
        return jnp.where(d > 0, pid, -1)

    def levels_of(self, ids):
        r, d, _ = self.decode(ids)
        return 3 * (self.K - self.slog_of_roots(r) + d)

    # -- streamlined walk support (ops/speck_lis_jax._lis_items_virtual) ----
    def box_major_pixels(self, pixel_vals):
        """Linear pixel array -> 2x2x2-box-major order (boxes by
        (zb, yb, xb), slots dz dy dx — children_rows' slot order)."""
        N = self.dims[0]
        Nh = N // 2
        return (
            pixel_vals.reshape(Nh, 2, Nh, 2, Nh, 2)
            .transpose(0, 2, 4, 1, 3, 5)
            .reshape(-1)
        )

    def vtab_from(self, pix_bm, node_s):
        """Combined 8-aligned child value table from an ALREADY box-major
        pixel section (shared with the exposure compaction) ++ per-depth
        node_s sections."""
        parts = [pix_bm]
        db = self.h_depth_base
        for d in range(self.depth_max + 1):
            lo, hi = int(db[d]), int(db[d + 1])
            seg = jax.lax.slice(node_s, (lo,), (hi,))
            pad = (-(hi - lo)) % 8
            if pad:
                seg = jnp.concatenate(
                    [seg, jnp.full(pad, _NEVER, node_s.dtype)]
                )
            parts.append(seg)
        return jnp.concatenate(parts)

    def build_vtab(self, pixel_vals, node_s):
        """Combined 8-aligned child value table: pixel section (2x2x2 boxes
        in box-major order) ++ per-depth node_s sections.  One relayout
        pass over n plus nn of slice copies."""
        return self.vtab_from(self.box_major_pixels(pixel_vals), node_s)

    def children_rows(self, q, svalid, slot, vtab):
        """Child resolution with the values fetched as ROW gathers from the
        8-aligned table: returns (cnt, rvalid, ispx, isnd, vidx, v) where
        v[c, k] is child k's table value (s|sign<<15 for pixels, node_s for
        sets)."""
        N = self.dims[0]
        Nh = N // 2
        D = self.depth_max
        r, d, m = self.decode(q)
        side_log = self.slog_of_roots(r) - d
        cnt = jnp.where(svalid, 8, 0)
        rvalid = slot[None, :] < cnt[:, None]
        px_parent = side_log == 1
        ispx = px_parent[:, None] & rvalid
        isnd = (~px_parent)[:, None] & rvalid
        # node child octet: table row A8[d+1] + (r - r0[d+1]) * 8^d + m
        dc = jnp.minimum(d + 1, D)
        A8c = jnp.zeros_like(d)
        r0c = jnp.zeros_like(d)
        for k in range(D + 1):
            hit = dc == k
            A8c = A8c + jnp.where(hit, jnp.int32(int(self.h_A8[k])), 0)
            r0c = r0c + jnp.where(hit, jnp.int32(int(self.h_r0[k])), 0)
        tb_node = A8c + ((r - r0c) << jnp.clip(3 * d, 0, 30)) + m
        # pixel octet: half-grid box row
        bx, by, bz = self._unmorton(m)
        ox, oy, oz = self.org_of_roots(r)
        oxh = (ox >> 1) + bx
        oyh = (oy >> 1) + by
        ozh = (oz >> 1) + bz
        tb_pix = (ozh * Nh + oyh) * Nh + oxh
        tb8 = jnp.where(svalid, jnp.where(px_parent, tb_pix, tb_node), 0)
        v = vtab.reshape(-1, 8)[tb8]
        # combined value index (pixel linear id or n + node id) — still
        # needed arithmetically for born ids; tiny tables resolved by
        # per-parent compare-sums (no gather lowering)
        mc = (m[:, None] << 3) + slot[None, :]
        d1 = d + 1
        db1 = jnp.zeros_like(d)
        r01 = jnp.zeros_like(d)
        for k in range(D + 2):
            hit = d1 == k
            db1 = db1 + jnp.where(
                hit, jnp.int32(int(self.h_depth_base[k])), 0
            )
            r01 = r01 + jnp.where(hit, jnp.int32(int(self.h_r0[k])), 0)
        cid = (
            db1[:, None]
            + ((r - r01)[:, None] << jnp.clip(3 * d1, 0, 30)[:, None])
            + mc
        )
        px = (oxh[:, None] << 1) + (slot[None, :] & 1)
        py = (oyh[:, None] << 1) + ((slot[None, :] >> 1) & 1)
        pz = (ozh[:, None] << 1) + (slot[None, :] >> 2)
        lin = (pz * N + py) * N + px
        vidx = jnp.where(ispx, lin, self.n + cid)
        return cnt, rvalid, ispx, isnd, vidx, v

    def sort_paths_of(self, ids):
        """Walk-key path words: a SINGLE 4-bit-digit word when the forest
        is shallow (depth_max <= 6, 28 bits) — digit values 1..8 compare
        identically to the 5-bit host layout, and one sort operand
        replaces two.  Falls back to the parity layout otherwise."""
        if self.depth_max > 6:
            return self.paths_of(ids)
        _, d, m = self.decode(ids)
        return [self._path_word4(d, m)]

    def _path_word4(self, d, m):
        S = self.depth_max + 1
        w = jnp.zeros_like(m)
        for j in range(S):
            sh = jnp.maximum(3 * (d - 1 - j), 0)
            dig = jnp.where(j < d, ((m >> sh) & 7) + 1, 0)
            w = w | (dig << (4 * (S - 1 - j)))
        return w

    def sort_child_paths(self, q, rslot):
        if self.depth_max > 6:
            return self.child_paths(q, rslot)
        _, d, m = self.decode(q)
        w = self._path_word4(d, m)
        S = self.depth_max + 1
        sh = (4 * (S - 1 - d)).astype(jnp.int32)
        return [w + ((rslot + 1) << sh)]

    def paths_of(self, ids):
        _, d, m = self.decode(ids)
        return self._path_words(d, m)

    def child_paths(self, q, rslot):
        """Path words of child slots: parent's path with digit (slot+1)
        appended at the parent's depth."""
        _, d, m = self.decode(q)
        pw = self._path_words(d, m)
        dig = rslot + 1
        out = []
        for k in range(2):
            lo_k, hi_k = 6 * k, 6 * k + 6
            sh = jnp.clip(5 * (5 - (d - 6 * k)), 0, 25)
            in_word = (d >= lo_k) & (d < hi_k)
            out.append(pw[k] + jnp.where(in_word, dig << sh, 0))
        return out

    def O0_full(self):
        """Dense O scratch [nn+1]: root pre-assignment ranks, zeros below."""
        return jnp.concatenate(
            [
                self.O0_head,
                jnp.zeros(self.nn + 1 - self.nroots, jnp.int32),
            ]
        )


def _repeat8(x: jnp.ndarray) -> jnp.ndarray:
    """Each element 8x, flat (parent slice -> child-aligned slice).

    broadcast_to + reshape, NOT jnp.repeat: repeat lowers through a
    gather while the broadcast form is a pure relayout pass."""
    n = x.shape[0]
    return jnp.broadcast_to(x[:, None], (n, 8)).reshape(8 * n)


def dense_anchor_ranks(
    node_s: jnp.ndarray, vf: VirtualLisIndex
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same-pass chain anchors and their string ranks, computed DENSELY on
    the forest's per-depth slices — no pointer-doubling.

    Replaces the walk's two suffix-doubling loops
    (ops/speck_lis_jax.py: J = J[J] and the R_rank two-key-sort ladder),
    whose nn-scale gathers/scatters dominated the 256^3 walk.  Here every
    parent->child propagation is a suffix-slice + repeat (pure reshape
    traffic), and the string ranking runs as per-LEVEL sorts whose sizes
    sum to nn:

      J(z)    = topmost ancestor reachable through nodes with the same
                node_s (the chain anchor);
      R(z)    = lexicographic rank, AMONG NODES OF z's LEVEL, of the
                hop-word string [u(z), u(next z), ...] with
                next(z) = J(parent(z)) — the exact order the walk's
                R_rank encodes.  Ranks are only ever compared within a
                level (the born-order sort keys anchor level first), and
                u embeds lev(next), so the per-level recursion
                key = (u(z), R(next z)) is well-founded: level(next) <
                level(z), equal u => equal next level.  Equal strings get
                equal ranks (ties must fall through to the path keys).

    Returns (J [nn] i32 node ids, R [nn] i32 per-level string ranks).
    """
    D = vf.depth_max
    db = vf.h_depth_base
    r0 = vf.h_r0
    R = vf.nroots
    rlev_np = np.asarray(vf.r_level)

    # --- structural passes, depth-major ---------------------------------
    s_d: List[jnp.ndarray] = []
    J_d: List[jnp.ndarray] = []
    AJL_d: List[jnp.ndarray] = []   # level of J(z)
    same_d: List[jnp.ndarray] = []
    u_d: List[jnp.ndarray] = []
    lev_np_d: List[np.ndarray] = []
    for d in range(D + 1):
        lo, hi = int(db[d]), int(db[d + 1])
        if hi <= lo:
            for lst in (s_d, J_d, AJL_d, same_d, u_d):
                lst.append(jnp.zeros(0, jnp.int32))
            lev_np_d.append(np.zeros(0, np.int64))
            continue
        sz = hi - lo
        sd = jax.lax.slice(node_s, (lo,), (hi,))
        own = lo + jnp.arange(sz, dtype=jnp.int32)
        lev_np = np.repeat(rlev_np[int(r0[d]) :], 8**d) + 3 * d
        lev = jnp.asarray(lev_np.astype(np.int32))
        if d == 0:
            same = jnp.zeros(sz, bool)
            J = own
            AJL = lev
            u = vf.O0_head.astype(jnp.int32)
        else:
            skip = (int(r0[d]) - int(r0[d - 1])) * 8 ** (d - 1)
            par_s = _repeat8(s_d[d - 1][skip:])
            par_J = _repeat8(J_d[d - 1][skip:])
            par_AJL = _repeat8(AJL_d[d - 1][skip:])
            same = par_s == sd
            J = jnp.where(same, par_J, own)
            AJL = jnp.where(same, par_AJL, lev)
            # u(z): non-root hop word — birth pass (parent's node_s) and
            # the level of next(z) = J(parent), matching the walk's u
            u = (
                (1 << 11)
                | (jnp.clip(par_s, 0, 63) << 5)
                | (31 - par_AJL)
            )
        s_d.append(sd)
        J_d.append(J)
        AJL_d.append(AJL)
        same_d.append(same)
        u_d.append(u)
        lev_np_d.append(lev_np)

    # --- per-level ranking, levels ascending ----------------------------
    # spans: level -> [(d, elem_lo, elem_hi)] within each depth slice;
    # root levels are contiguous runs, so spans are contiguous slices
    spans: Dict[int, List[Tuple[int, int, int]]] = {}
    for d in range(D + 1):
        lev_np = lev_np_d[d]
        if lev_np.size == 0:
            continue
        for L in np.unique(lev_np):
            idx = np.nonzero(lev_np == L)[0]
            spans.setdefault(int(L), []).append(
                (d, int(idx[0]), int(idx[-1]) + 1)
            )

    RSTR_d = [jnp.zeros(x.shape[0], jnp.int32) for x in s_d]
    ARV_d = [jnp.zeros(x.shape[0], jnp.int32) for x in s_d]
    for L in sorted(spans):
        # Leaf levels (side-2 nodes: slog - d == 1, i.e. K - L/3 == 1) are
        # never anchors of BORN rows (a born row's anchor is an ancestor of
        # an inner parent, hence inner) and their ARV is never propagated
        # (the skip slice drops leaf parents) — skipping their ranking
        # removes the dominant finest-level sorts (~3/4 of nn at 256^3).
        if vf.K - L // 3 == 1:
            continue
        sp = spans[L]
        u_parts, k2_parts = [], []
        for d, a, b in sp:
            u_parts.append(jax.lax.slice(u_d[d], (a,), (b,)))
            if d == 0:
                k2_parts.append(jnp.full(b - a, -1, jnp.int32))
            else:
                skip = (int(r0[d]) - int(r0[d - 1])) * 8 ** (d - 1)
                k2_parts.append(
                    _repeat8(ARV_d[d - 1][skip:])[a:b]
                )
        u_all = jnp.concatenate(u_parts) if len(u_parts) > 1 else u_parts[0]
        k2_all = jnp.concatenate(k2_parts) if len(k2_parts) > 1 else k2_parts[0]
        m = u_all.shape[0]
        iota = jnp.arange(m, dtype=jnp.int32)
        us, ks, idx_s = jax.lax.sort(
            (u_all, k2_all, iota), num_keys=2, is_stable=False
        )
        diff = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                ((us[1:] != us[:-1]) | (ks[1:] != ks[:-1])).astype(jnp.int32),
            ]
        )
        rank_s = jnp.cumsum(diff)
        # inverse permutation by a second sort instead of a scatter
        _, rank = jax.lax.sort((idx_s, rank_s), num_keys=1, is_stable=False)
        off = 0
        for d, a, b in sp:
            rpart = jax.lax.slice(rank, (off,), (off + (b - a),))
            RSTR_d[d] = jax.lax.dynamic_update_slice(RSTR_d[d], rpart, (a,))
            if d == 0:
                arv = rpart
            else:
                skip = (int(r0[d]) - int(r0[d - 1])) * 8 ** (d - 1)
                par_arv = _repeat8(ARV_d[d - 1][skip:])[a:b]
                arv = jnp.where(same_d[d][a:b], par_arv, rpart)
            ARV_d[d] = jax.lax.dynamic_update_slice(ARV_d[d], arv, (a,))
            off += b - a

    J_full = jnp.concatenate([x for x in J_d if x.shape[0]])
    R_full = jnp.concatenate([x for x in RSTR_d if x.shape[0]])
    return J_full, R_full


_VIRTUAL: Dict[Tuple[int, int, int], VirtualLisIndex] = {}


def virtual_lis_index(dims) -> VirtualLisIndex:
    key = tuple(int(d) for d in dims)
    vi = _VIRTUAL.get(key)
    if vi is None:
        vi = VirtualLisIndex(key)
        _VIRTUAL[key] = vi
    return vi


def box_reduce_max(vol: jnp.ndarray) -> jnp.ndarray:
    """(N, N, N) -> (N/2, N/2, N/2) max over aligned 2x2x2 boxes, as three
    single-axis reductions (each keeps a large contiguous minor)."""
    N = vol.shape[0]
    h = N // 2
    v = vol.reshape(N, N, h, 2).max(axis=3)
    v = v.reshape(N, h, 2, h).max(axis=2)
    return v.reshape(h, 2, h, h).max(axis=1)


def box_reduce_min(vol: jnp.ndarray) -> jnp.ndarray:
    """(N, N, N) -> (N/2, N/2, N/2) min over aligned 2x2x2 boxes."""
    N = vol.shape[0]
    h = N // 2
    v = vol.reshape(N, N, h, 2).min(axis=3)
    v = v.reshape(N, h, 2, h).min(axis=2)
    return v.reshape(h, 2, h, h).min(axis=1)


def _morton_flatten(box: jnp.ndarray, d: int) -> jnp.ndarray:
    """(L, L, L) cells, L = 2^d -> flat [L^3] in morton order (x fastest).

    LSB-first rounds with the already-interleaved digits riding as a
    GROWING trailing payload axis: every transpose after the first moves
    large contiguous blocks (the round-4 MSB-first form shrank the minor
    dims to 1 and paid pathological relayouts)."""
    L = box.shape[0]
    out = box.reshape(L, L, L, 1)
    P = 1
    for _ in range(d):
        h = L // 2
        v = out.reshape(h, 2, h, 2, h, 2, P)
        v = v.transpose(0, 2, 4, 1, 3, 5, 6)
        out = v.reshape(h, h, h, 8 * P)
        L, P = h, 8 * P
    return out.reshape(-1)


def pixel_schedule_virtual(mags: jnp.ndarray, vf: VirtualLisIndex, num_bp):
    """(s, e, node_max-in-BFS-id-order) for a power-of-two cube, from ONE
    morton pyramid — no gather tables, no host tree build.  Matches
    pixel_schedule / pixel_schedule_pyramid outputs exactly.

    Round-5 assembly: the 8 morton children of a cell are CONSECUTIVE in
    the finer grid's morton order, so the whole pyramid is one
    morton_flatten of the half-grid box maxima followed by contiguous
    reshape(-1, 8).max reductions; and every root's depth-d node block is
    a morton-ALIGNED subcube (origins are 0 or the root side), hence a
    CONTIGUOUS slice [k*8^d, (k+1)*8^d) of its grid's morton array, k the
    root's octant.  This replaces the per-(run, depth) flatten fragments
    with reductions + slices."""
    from .speck_jax import msbp1_device

    N = vf.dims[0]
    K = vf.K
    pm = msbp1_device(mags)
    vol = pm.reshape(N, N, N)
    # half-grid box maxima: feeds both the e schedule and the morton
    # pyramid root (nodes never live below grid K-1 — side-2 nodes are
    # its cells).  STAGED single-axis reductions: the one-shot
    # [h,2,h,2,h,2].max(1,3,5) form pays a pathological small-minor
    # relayout
    h = N // 2
    pmax = box_reduce_max(vol)

    M = [None] * K  # M[g] = morton-ordered grid-g maxima (g <= K-1)
    M[K - 1] = _morton_flatten(pmax, K - 1)
    for g in range(K - 2, -1, -1):
        M[g] = M[g + 1].reshape(-1, 8).max(axis=1)

    parts = []
    for d in range(vf.depth_max + 1):
        r = int(vf.h_r0[d])
        while r < vf.nroots:
            s_log = int(vf.h_slog[r])
            r_end = r
            while r_end < vf.nroots and int(vf.h_slog[r_end]) == s_log:
                r_end += 1
            g = K - (s_log - d)  # grid whose cells are the depth-d boxes
            blk = 1 << (3 * d)
            run = r_end - r
            # run of 8 = big + 7 finest octants (octants 0..7); run of 7
            # drops the (0,0,0) corner (it belongs to deeper roots); a
            # single big root (xf == 0) is octant 0 alone
            lo = blk if run == 7 else 0
            hi = 8 * blk if run in (7, 8) else blk
            parts.append(jax.lax.slice(M[g], (lo,), (hi,)))
            r = r_end
    nm = jnp.concatenate(parts).astype(jnp.int32)

    s = jnp.where(pm > 0, num_bp - pm, _NEVER).astype(jnp.int32)
    # every pixel's parent set is its aligned 2x2x2 box (all roots have
    # side >= 2): broadcast the box max back over its 8 pixels
    e_cell = jnp.where(pmax > 0, num_bp - pmax.astype(jnp.int32), _NEVER)
    e = jnp.broadcast_to(
        e_cell[:, None, :, None, :, None], (h, 2, h, 2, h, 2)
    ).reshape(-1)
    return s, e, nm


__all__ = [
    "VirtualLisIndex",
    "virtual_lis_index",
    "pixel_schedule_virtual",
    "_is_pow2_cube",
]
