"""Wavefront SPECK: vectorized per-bitplane 3D encoder (byte-identical).

This is the re-architecture promised in SURVEY.md §7 step 4: the reference's
bit-serial LIS recursion (reference src/SPECK_INT.cpp:111-163,
SPECK3D_INT.cpp:100-212) is replaced by per-bitplane *array* passes.

Key decomposition.  Every bit the serial coder emits falls in one of three
per-pass segments, in this order (SPECK_INT.cpp:146-158):

    [LIP walk] [LIS set walk (with embedded newly-exposed pixel bits)]
    [refinement pass]

and the *pixel-level* segments are pure functions of three static integers
per pixel:

    s  = num_bitplanes - msb(|coeff|)-1 .... pass where the pixel first
                                             becomes significant (inf if 0)
    e  = s(parent set)  .................... pass where the pixel is exposed
                                             into LIP (its enclosing set gets
                                             partitioned)
    sign

  * LIP-walk bits at pass p (ascending pixel index over members e < p <= s):
    decision (s == p), then the sign if significant.
  * Refinement bits at pass p (ascending index over pixels with s < p):
    plain binary digit (mag >> (num_bp-1-p)) & 1.

Both are emitted with numpy array ops (and map 1:1 onto device vector ops).
Only the set walk remains control flow: one decision bit per live set per
pass, where set significance is again static (s of the set = num_bp - msb of
the set max).  Live-set counts are proportional to the compressed
information, not the volume, and insignificant runs are emitted as batched
zero arrays.

The partition tree (morton layout, child tables) is a static function of the
dims — built once with vectorized BFS and cached.  It reproduces the
reference's dyadic / wavelet-packet initialization (SPECK3D_INT.cpp:22-97)
and x-fastest octant order (:214-326).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.dims import calc_approx_detail_len, can_use_dyadic, num_of_partitions, num_of_xforms

_NEVER = 0x7FFF  # "pass" value larger than any real pass (num_bp <= 64)


# ---------------------------------------------------------------------------
# Static partition tree
# ---------------------------------------------------------------------------
class Tree:
    """Static 3D SPECK partition forest for one `dims` (cached).

    Nodes are sets with >= 2 elements, plus the initial root sets (which may
    be single pixels for degenerate dims).  Every pixel appears exactly once
    as a singleton child in the child table.
    """

    __slots__ = (
        "dims", "n", "nlevels",
        # node arrays
        "node_level", "node_parent", "node_ch_start", "node_ch_count",
        "node_depth_ranges",
        # child table: parent-major, partition order
        "ch_is_pixel", "ch_ref",
        # pixel slots
        "px_linear", "px_parent",
        # roots, in the morton-assignment order (finest list first)
        "root_ids", "root_levels", "big_level", "big_pos",
    )


def _initial_sets(nx: int, ny: int, nz: int):
    """Replicates the reference's list initialization exactly
    (SPECK3D_INT.cpp:22-97): returns (sets, big, big_level) where `sets` is a
    list of (sx,sy,sz,lx,ly,lz,level) in push order and `big` is prepended to
    its level's list."""

    def split2(l):
        return l - l // 2, l // 2

    def part_xyz(s, lev):
        sx, sy, sz, lx, ly, lz = s
        ax, dx = split2(lx)
        ay, dy = split2(ly)
        az, dz = split2(lz)
        nl = lev + (dx != 0) + (dy != 0) + (dz != 0)
        x0, x1, y0, y1, z0, z1 = sx, sx + ax, sy, sy + ay, sz, sz + az
        subs = [
            (x0, y0, z0, ax, ay, az), (x1, y0, z0, dx, ay, az),
            (x0, y1, z0, ax, dy, az), (x1, y1, z0, dx, dy, az),
            (x0, y0, z1, ax, ay, dz), (x1, y0, z1, dx, ay, dz),
            (x0, y1, z1, ax, dy, dz), (x1, y1, z1, dx, dy, dz),
        ]
        return subs, nl

    pushed: List[Tuple] = []  # (set6, level) in push order
    big = (0, 0, 0, nx, ny, nz)
    cur = 0
    dy_lev = can_use_dyadic((nx, ny, nz))
    if dy_lev is not None:
        for _ in range(dy_lev):
            subs, nl = part_xyz(big, cur)
            big = subs[0]
            for k in range(1, 8):
                pushed.append((subs[k], nl))
            cur = nl
    else:
        xf_xy = num_of_xforms(min(nx, ny))
        xf_z = num_of_xforms(nz)
        xf = 0
        while xf < xf_xy and xf < xf_z:
            subs, nl = part_xyz(big, cur)
            big = subs[0]
            for k in range(1, 8):
                pushed.append((subs[k], nl))
            cur = nl
            xf += 1
        while xf < xf_xy:  # split X and Y only
            sx, sy, sz, lx, ly, lz = big
            ax, dx = split2(lx)
            ay, dy = split2(ly)
            nl = cur + (dx != 0) + (dy != 0)
            pushed.append(((sx + ax, sy, sz, dx, ay, lz), nl))
            pushed.append(((sx, sy + ay, sz, ax, dy, lz), nl))
            pushed.append(((sx + ax, sy + ay, sz, dx, dy, lz), nl))
            big = (sx, sy, sz, ax, ay, lz)
            cur = nl
            xf += 1
        while xf < xf_z:  # split Z only
            sx, sy, sz, lx, ly, lz = big
            az, dz = split2(lz)
            nl = cur + (dz != 0)
            pushed.append(((sx, sy, sz + az, lx, ly, dz), nl))
            big = (sx, sy, sz, lx, ly, az)
            cur = nl
            xf += 1
    return pushed, big, cur


def _children_of(sx, sy, sz, lx, ly, lz, morton, level):
    """Vectorized octant partition of a batch of nodes (x-fastest order).
    Returns per-child field arrays of shape [K, 8] plus nelem and level."""
    K = sx.size
    ax, dx = lx - lx // 2, lx // 2
    ay, dy = ly - ly // 2, ly // 2
    az, dz = lz - lz // 2, lz // 2

    def oct8(lo, hi_start, hi, axis):
        out = np.empty((K, 8), dtype=np.int32)
        if axis == 0:  # x fastest: pattern lo hi lo hi ...
            out[:, 0::2] = lo[:, None]
            out[:, 1::2] = hi[:, None]
        elif axis == 1:  # y: lo lo hi hi lo lo hi hi
            out[:, [0, 1, 4, 5]] = lo[:, None]
            out[:, [2, 3, 6, 7]] = hi[:, None]
        else:  # z: first 4 lo, last 4 hi
            out[:, :4] = lo[:, None]
            out[:, 4:] = hi[:, None]
        return out

    csx = oct8(sx, None, (sx + ax), 0)
    clx = oct8(ax, None, dx, 0)
    csy = oct8(sy, None, (sy + ay), 1)
    cly = oct8(ay, None, dy, 1)
    csz = oct8(sz, None, (sz + az), 2)
    clz = oct8(az, None, dz, 2)
    ne = (clx * cly).astype(np.int64) * clz
    clev = (level + (dx != 0) + (dy != 0) + (dz != 0)).astype(level.dtype)
    # morton: parent morton + exclusive prefix of child sizes (x-fastest)
    cm = morton[:, None] + np.cumsum(ne, axis=1) - ne
    return csx, csy, csz, clx, cly, clz, ne, cm, clev


_TREES: Dict[Tuple[int, int, int], Tree] = {}


def build_tree(dims: Tuple[int, int, int]) -> Tree:
    key = tuple(int(d) for d in dims)
    t = _TREES.get(key)
    if t is not None:
        return t
    nx, ny, nz = key
    n = nx * ny * nz

    pushed, big, big_level = _initial_sets(nx, ny, nz)
    nlevels = num_of_partitions(nx) + num_of_partitions(ny) + num_of_partitions(nz) + 1

    # Order the roots exactly as morton offsets are assigned in the encoder:
    # levels finest-first, pushed order within a level, `big` first in its own.
    per_level: List[List[Tuple]] = [[] for _ in range(nlevels)]
    for s, lev in pushed:
        per_level[lev].append(s)
    per_level[big_level].insert(0, big)
    roots: List[Tuple] = []
    root_levels: List[int] = []
    for lev in range(nlevels - 1, -1, -1):
        for s in per_level[lev]:
            roots.append(s)
            root_levels.append(lev)

    R = len(roots)
    ra = np.array(roots, dtype=np.int64).reshape(R, 6)
    rlev = np.array(root_levels, dtype=np.int16)
    rne = ra[:, 3] * ra[:, 4] * ra[:, 5]
    rmorton = np.cumsum(rne) - rne

    # BFS over depths; nodes appended in (depth, parent-order) order.
    node_level = [rlev]
    node_parent = [np.full(R, -1, dtype=np.int64)]
    depth_ranges: List[Tuple[int, int]] = [(0, R)]
    ch_is_pixel: List[np.ndarray] = []
    ch_ref: List[np.ndarray] = []
    ch_counts: List[np.ndarray] = []  # per node, in node order
    px_linear: List[np.ndarray] = []
    px_parent: List[np.ndarray] = []

    f_sx, f_sy, f_sz = ra[:, 0], ra[:, 1], ra[:, 2]
    f_lx, f_ly, f_lz = ra[:, 3], ra[:, 4], ra[:, 5]
    f_m, f_lev = rmorton, rlev
    f_ids = np.arange(R, dtype=np.int64)
    n_nodes = R
    n_px = 0

    f_sx = f_sx.astype(np.int32)
    f_sy = f_sy.astype(np.int32)
    f_sz = f_sz.astype(np.int32)
    f_lx = f_lx.astype(np.int32)
    f_ly = f_ly.astype(np.int32)
    f_lz = f_lz.astype(np.int32)
    while f_ids.size:
        K = f_ids.size
        # (a 1-elem root partitions into itself in slot 0; generic code works)
        csx, csy, csz, clx, cly, clz, ne, cm, clev = _children_of(
            f_sx, f_sy, f_sz, f_lx, f_ly, f_lz, f_m, f_lev
        )
        flat_ne = ne.ravel()
        fv = np.flatnonzero(flat_ne > 0)  # valid children, parent-major order
        ne_v = flat_ne[fv]
        px_mask = ne_v == 1
        rows_ref = np.empty(fv.size, dtype=np.int64)

        # pixel slots
        fpx = fv[px_mask]
        lin = (
            csz.ravel().take(fpx).astype(np.int64) * (nx * ny)
            + csy.ravel().take(fpx).astype(np.int64) * nx
            + csx.ravel().take(fpx)
        )
        pxpar = f_ids[fpx >> 3]
        npx_new = fpx.size
        rows_ref[px_mask] = n_px + np.arange(npx_new)
        px_linear.append(lin)
        px_parent.append(pxpar)
        n_px += npx_new

        # new nodes
        fnd = fv[~px_mask]
        nnd_new = fnd.size
        rows_ref[~px_mask] = n_nodes + np.arange(nnd_new)
        ch_is_pixel.append(px_mask)
        ch_ref.append(rows_ref)
        ch_counts.append((ne > 0).sum(axis=1))

        nf_sx, nf_sy, nf_sz = (
            csx.ravel().take(fnd), csy.ravel().take(fnd), csz.ravel().take(fnd),
        )
        nf_lx, nf_ly, nf_lz = (
            clx.ravel().take(fnd), cly.ravel().take(fnd), clz.ravel().take(fnd),
        )
        nf_m = cm.ravel().take(fnd)
        nf_lev = clev[fnd >> 3]
        nf_par = f_ids[fnd >> 3]

        node_level.append(nf_lev.astype(np.int16))
        node_parent.append(nf_par)
        depth_ranges.append((n_nodes, n_nodes + nnd_new))
        n_nodes += nnd_new

        f_sx, f_sy, f_sz, f_lx, f_ly, f_lz = nf_sx, nf_sy, nf_sz, nf_lx, nf_ly, nf_lz
        f_m, f_lev = nf_m, nf_lev
        f_ids = np.arange(n_nodes - nnd_new, n_nodes, dtype=np.int64)

    t = Tree()
    t.dims = key
    t.n = n
    t.nlevels = nlevels
    t.node_level = np.concatenate(node_level).astype(np.int16)
    t.node_parent = np.concatenate(node_parent)
    counts = np.concatenate(ch_counts)
    t.node_ch_count = counts
    t.node_ch_start = np.cumsum(counts) - counts
    t.node_depth_ranges = [r for r in depth_ranges if r[1] > r[0]]
    t.ch_is_pixel = np.concatenate(ch_is_pixel)
    t.ch_ref = np.concatenate(ch_ref)
    t.px_linear = np.concatenate(px_linear) if px_linear else np.empty(0, np.int64)
    t.px_parent = np.concatenate(px_parent) if px_parent else np.empty(0, np.int64)
    t.root_ids = np.arange(R, dtype=np.int64)
    t.root_levels = rlev
    t.big_level = big_level
    t.big_pos = 0
    _TREES[key] = t
    return t


# ---------------------------------------------------------------------------
# msb helpers
# ---------------------------------------------------------------------------
def msbp1(mags: np.ndarray) -> np.ndarray:
    """msb position + 1 per element (0 for zero), exact for uint64."""
    m = mags.astype(np.uint64, copy=False)
    hi = (m >> np.uint64(32)).astype(np.float64)
    lo = (m & np.uint64(0xFFFFFFFF)).astype(np.float64)
    out = np.where(
        hi > 0,
        32 + np.frexp(hi)[1],
        np.frexp(lo)[1],
    ).astype(np.int16)
    return out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
class _Bits:
    """Ordered collection of 0/1 bit runs (numpy arrays + scalars)."""

    def __init__(self):
        self.parts: List[np.ndarray] = []
        self.n = 0
        self._small: List[int] = []

    def bit(self, b: int):
        self._small.append(b)
        self.n += 1

    def arr(self, a: np.ndarray):
        if self._small:
            self.parts.append(np.array(self._small, dtype=np.uint8))
            self._small = []
        self.parts.append(a.astype(np.uint8, copy=False))
        self.n += a.size

    def zeros(self, k: int):
        if k > 0:
            self.arr(np.zeros(k, dtype=np.uint8))

    def concat(self) -> np.ndarray:
        if self._small:
            self.parts.append(np.array(self._small, dtype=np.uint8))
            self._small = []
        if not self.parts:
            return np.empty(0, dtype=np.uint8)
        return np.concatenate(self.parts)


class _EncWalk:
    """Shared encoder set-walk: LIS levels (zero-runs batched) + code_s
    recursion over the static child table.  Used by the 3D stitcher and the
    2D encoder (which adds the I-set hook)."""

    def __init__(self, tree, node_s, s_lin, signs):
        self.tree = tree
        self.node_s = node_s
        self.s_lin = s_lin
        self.signs = signs
        # 1D partition trees contain zero-length child sets: they emit their
        # decision bit once (at creation / first walk) and are then dropped,
        # mirroring the serial clean_lis (speck.cpp Codec1D).
        self.alive = getattr(tree, "node_alive", None)
        self.lists = [np.empty(0, dtype=np.int64) for _ in range(tree.nlevels)]
        self.born: List[List[int]] = [[] for _ in range(tree.nlevels)]

    def add_root(self, nid: int, level: int) -> None:
        self.lists[level] = np.append(self.lists[level], nid)

    def code_s(self, nid: int, p: int, bits: _Bits) -> None:
        t = self.tree
        s0 = t.node_ch_start[nid]
        cnt = t.node_ch_count[nid]
        counter = 0
        for k in range(cnt):
            decide = (counter != 0) or (k + 1 != cnt)
            r = int(t.ch_ref[s0 + k])
            if t.ch_is_pixel[s0 + k]:
                lin = int(t.px_linear[r])
                sig = self.s_lin[lin] == p
                if decide:
                    bits.bit(1 if sig else 0)
                if sig:
                    counter += 1
                    bits.bit(1 if self.signs[lin] else 0)
            else:
                sig = self.node_s[r] == p
                if decide:
                    bits.bit(1 if sig else 0)
                if sig:
                    counter += 1
                    self.code_s(r, p, bits)
                elif self.alive is None or self.alive[r]:
                    self.born[int(t.node_level[r])].append(r)

    def lis_pass(self, p: int, i_hook=None) -> np.ndarray:
        bits = _Bits()
        for t in range(self.tree.nlevels - 1, -1, -1):
            arr = self.lists[t]
            if self.born[t]:
                arr = np.concatenate(
                    [arr, np.array(self.born[t], dtype=np.int64)]
                )
                self.born[t].clear()
            if arr.size == 0:
                self.lists[t] = arr
                continue
            sp = self.node_s[arr]
            sig_pos = np.flatnonzero(sp == p)
            if sig_pos.size == 0:
                bits.zeros(arr.size)
            else:
                prev = 0
                for pos in sig_pos:
                    pos = int(pos)
                    bits.zeros(pos - prev)
                    bits.bit(1)
                    self.code_s(int(arr[pos]), p, bits)
                    prev = pos + 1
                bits.zeros(arr.size - prev)
            # survivors; this-pass appends stay in born[] until next visit
            keep = sp > p
            if self.alive is not None:
                keep &= self.alive[arr]
            self.lists[t] = arr[keep]
        if i_hook is not None:
            i_hook(p, bits)
        return bits.concat()


def _lip_segment(ce, cs, csign, p: int) -> np.ndarray:
    """Vectorized LIP-walk bits for pass p from the (e, s, sign) cohort:
    one decision per member, the sign interleaved after each 1."""
    memb = (ce < p) & (cs >= p)
    mi = np.flatnonzero(memb)
    dec = cs[mi] == p
    pair = np.empty((mi.size, 2), dtype=np.uint8)
    pair[:, 0] = dec
    pair[:, 1] = csign[mi]
    keep = np.empty((mi.size, 2), dtype=bool)
    keep[:, 0] = True
    keep[:, 1] = dec
    return pair.ravel()[keep.ravel()]


class _DecWalk:
    """Shared decoder state machine: zero-padded bit cursor, LIP walk, LIS
    walk (zero-runs batched), refinement slices, and the final vectorized
    value reconstruction (SPECK_INT.cpp:166-228 semantics).  Used by both
    the 3D and 2D decoders."""

    def __init__(self, tree, stream: bytes, n: int, num_bp: int):
        self.tree = tree
        self.num_bp = num_bp
        total_bits = int.from_bytes(stream[1:9], "little")
        self.avail = min((len(stream) - 9) * 8, total_bits)
        raw = np.unpackbits(
            np.frombuffer(stream, dtype=np.uint8, offset=9), bitorder="little"
        )[: self.avail].astype(np.uint8)
        # zero padding past avail: sorting passes read freely (progressive
        # access).  A valid stream never exceeds ~6 bits/pixel/pass; the
        # clamp bounds allocation against hostile total_bits values.
        pad = min(total_bits, 6 * n * num_bp) + 64
        self.bits = np.zeros(pad, dtype=np.uint8)
        m = min(self.avail, pad)
        self.bits[:m] = raw[:m]
        self.pos = 0
        self.s_lin = np.full(n, _NEVER, dtype=np.int32)
        self.contrib = np.zeros(n, dtype=np.int64)
        self.signs = np.ones(n, dtype=bool)
        self.lip = np.zeros(n, dtype=bool)
        self.alive = getattr(tree, "node_alive", None)
        self.lists = [np.empty(0, dtype=np.int64) for _ in range(tree.nlevels)]
        self.born: List[List[int]] = [[] for _ in range(tree.nlevels)]

    def add_root(self, nid: int, level: int) -> None:
        self.lists[level] = np.append(self.lists[level], nid)

    def next_one(self, start: int, limit: int) -> int:
        """First index in [start, limit) with a 1 bit, or -1; chunked scan so
        each bit region is visited O(1) times amortized."""
        CH = 4096
        i = start
        while i < limit:
            w = self.bits[i : min(i + CH, limit)]
            nz = np.flatnonzero(w)
            if nz.size:
                return i + int(nz[0])
            i += CH
        return -1

    def code_s(self, nid: int, p: int) -> None:
        t = self.tree
        s0 = t.node_ch_start[nid]
        cnt = t.node_ch_count[nid]
        counter = 0
        for k in range(cnt):
            decide = (counter != 0) or (k + 1 != cnt)
            r = int(t.ch_ref[s0 + k])
            if decide:
                sig = self.bits[self.pos]
                self.pos += 1
            else:
                sig = 1
            if t.ch_is_pixel[s0 + k]:
                lin = int(t.px_linear[r])
                if sig:
                    counter += 1
                    self.signs[lin] = bool(self.bits[self.pos])
                    self.pos += 1
                    self.s_lin[lin] = p
                else:
                    self.lip[lin] = True
            else:
                if sig:
                    counter += 1
                    self.code_s(r, p)
                elif self.alive is None or self.alive[r]:
                    self.born[int(t.node_level[r])].append(r)

    def lip_pass(self, p: int) -> None:
        mi = np.flatnonzero(self.lip)
        m = mi.size
        i = 0
        while i < m:
            j = self.next_one(self.pos, self.pos + (m - i))
            if j < 0:
                self.pos += m - i
                break
            j -= self.pos  # members i..i+j-1 stay; member i+j significant
            lin = int(mi[i + j])
            self.s_lin[lin] = p
            self.signs[lin] = bool(self.bits[self.pos + j + 1])
            self.lip[lin] = False
            self.pos += j + 2
            i += j + 1

    def lis_pass(self, p: int, i_hook=None) -> None:
        for t in range(self.tree.nlevels - 1, -1, -1):
            arr = self.lists[t]
            if self.born[t]:
                arr = np.concatenate(
                    [arr, np.array(self.born[t], dtype=np.int64)]
                )
                self.born[t].clear()
            if arr.size == 0:
                self.lists[t] = arr
                continue
            sig_at: List[int] = []
            i = 0
            nl0 = arr.size
            while i < nl0:
                j = self.next_one(self.pos, self.pos + (nl0 - i))
                if j < 0:
                    self.pos += nl0 - i
                    break
                j -= self.pos
                self.pos += j + 1
                sig_at.append(i + j)
                self.code_s(int(arr[i + j]), p)
                i += j + 1
            keep = np.ones(nl0, dtype=bool)
            if sig_at:
                keep[sig_at] = False
            if self.alive is not None:
                keep &= self.alive[arr]
            self.lists[t] = arr[keep]
        if i_hook is not None:
            i_hook(p)

    def refine_pass(self, p: int) -> bool:
        """Apply the refinement slice; returns False when decoding must stop
        (mid-pass exhaustion, SPECK_INT.cpp:360-469)."""
        old = np.flatnonzero(self.s_lin < p)
        k = min(old.size, self.avail - self.pos)
        seg = self.bits[self.pos : self.pos + k].astype(np.int64)
        thr_exp = self.num_bp - 1 - p  # T = 2**thr_exp
        if thr_exp >= 1:
            half = np.int64(1) << np.int64(thr_exp - 1)
            self.contrib[old[:k]] += np.where(seg == 1, half, -half)
        else:
            self.contrib[old[:k]] += seg
        self.pos += k
        return not (k < old.size or self.pos >= self.avail)

    def run(self, i_hook=None) -> None:
        for p in range(self.num_bp):
            self.lip_pass(p)
            self.lis_pass(p, i_hook)
            if self.pos >= self.avail:
                break
            if not self.refine_pass(p):
                break

    def reconstruct(self) -> Tuple[np.ndarray, np.ndarray]:
        """init 2T - T/2 - 1 at the discovery pass, +-T/2 per refinement."""
        found = self.s_lin < _NEVER
        sf = self.s_lin[found]
        T = np.int64(1) << (self.num_bp - 1 - sf).astype(np.int64)
        init = 2 * T - T // 2 - 1
        mags = np.zeros(self.s_lin.size, dtype=np.uint64)
        mags[found] = (init + self.contrib[found]).astype(np.uint64)
        return mags, self.signs


def encode_3d(
    mags: np.ndarray,
    signs: np.ndarray,
    dims: Tuple[int, int, int],
    budget_bits: int = 0,
) -> bytes:
    """Encode one 3D chunk; byte-identical to the serial engines.

    `mags`: uint magnitudes (any uint dtype), flat, x-fastest;
    `signs`: bool (True = non-negative); `budget_bits`: 0 = unlimited.
    """
    nx, ny, nz = (int(d) for d in dims)
    n = nx * ny * nz
    mags = np.ascontiguousarray(mags).reshape(n)
    signs = np.ascontiguousarray(signs).reshape(n).astype(bool)
    tree = build_tree((nx, ny, nz))

    pmsb = msbp1(mags)  # [n] linear
    num_bp = int(pmsb.max()) if n else 0
    if num_bp == 0:
        return _pack_stream(np.empty(0, np.uint8), 0, 0)
    node_max = compute_node_max(tree, pmsb)
    return stitch_3d(
        pmsb, signs, node_max, (nx, ny, nz), num_bp, None, None, budget_bits,
        mags=mags,
    )


def compute_node_max(tree, pmsb: np.ndarray) -> np.ndarray:
    """Max msb+1 per tree node via per-depth segmented max reductions
    (the reference's Morton MSB deposit as a pyramid).  Works for both the
    3D Tree and the 2D Tree2 (same child-table layout)."""
    nn = tree.node_ch_start.size
    node_max = np.zeros(nn, dtype=np.int16)
    px_msb = pmsb[tree.px_linear]  # per pixel slot
    for lo, hi in reversed(tree.node_depth_ranges):
        counts = tree.node_ch_count[lo:hi]
        s0 = tree.node_ch_start[lo]
        s1 = tree.node_ch_start[hi - 1] + counts[-1]
        if s1 == s0:  # depth of childless (zero-length 1D) nodes only
            continue
        refs = tree.ch_ref[s0:s1]
        ispx = tree.ch_is_pixel[s0:s1]
        vals = np.where(ispx, px_msb[np.where(ispx, refs, 0)],
                        node_max[np.where(ispx, 0, refs)])
        starts = (tree.node_ch_start[lo:hi] - s0).astype(np.int64)
        seg = np.maximum.reduceat(vals, np.minimum(starts, vals.size - 1))
        seg[counts == 0] = 0  # empty reduceat segments alias the next node
        node_max[lo:hi] = seg
    return node_max


def stitch_3d(
    pmsb: np.ndarray,
    signs: np.ndarray,
    node_max: np.ndarray,
    dims: Tuple[int, int, int],
    num_bp: int,
    lip_segments,
    ref_segments,
    budget_bits: int = 0,
    mags: np.ndarray = None,
    s_lin: np.ndarray = None,
    lis_segments=None,
) -> bytes:
    """Assemble the final stream from pixel schedules + set walk.

    `lip_segments` / `ref_segments` / `lis_segments`: optional per-pass 0/1
    arrays computed on a device (ops/speck_jax.py, ops/speck_lis_jax.py);
    when None they are computed here with numpy (requiring `pmsb`, and
    `mags` for the refinement bits).  With all three supplied the stitcher
    is a pure per-pass concatenation — no tree data needed at all."""
    nx, ny, nz = dims
    n = nx * ny * nz
    budget = (budget_bits + 7) // 8 * 8 if budget_bits else None

    if lip_segments is None or ref_segments is None or lis_segments is None:
        tree = build_tree(dims)
        node_s = np.where(node_max > 0, num_bp - node_max, _NEVER).astype(
            np.int32
        )

    # --- static per-pixel schedule (linear index order) -------------------
    if s_lin is None and (
        lip_segments is None or ref_segments is None or lis_segments is None
    ):
        s_lin = np.where(pmsb > 0, num_bp - pmsb, _NEVER).astype(np.int32)
    if lip_segments is None:
        e_lin = np.full(n, _NEVER, dtype=np.int32)
        e_lin[tree.px_linear] = node_s[tree.px_parent]
        # LIP cohort: exposed while still insignificant
        cand = np.flatnonzero((e_lin < num_bp) & (s_lin > e_lin))
        ce, cs = e_lin[cand], s_lin[cand]
        csign = signs[cand]
    if ref_segments is None:
        # refinement cohort: all nonzero pixels
        rnz = np.flatnonzero(s_lin < _NEVER)
        rs = s_lin[rnz]
        rmag = mags[rnz].astype(np.uint64)

    if lis_segments is None:
        # LIS bits: the set walk as a lexicographic sort
        # (codec/speck_sorted.py) — no recursion anywhere in the 3D encoder.
        from .speck_sorted import lis_segments_sorted

        lis_all = lis_segments_sorted(tree, node_s, s_lin, signs, num_bp)
    else:
        lis_all = lis_segments

    segments: List[np.ndarray] = []
    total = 0
    stop = False

    for p in range(num_bp):
        if lip_segments is not None:  # device-supplied or vectorized here
            lip_bits = lip_segments[p]
        else:
            lip_bits = _lip_segment(ce, cs, csign, p)
        lis_bits = lis_all[p]

        segments.append(lip_bits)
        segments.append(lis_bits)
        total += lip_bits.size + lis_bits.size
        if budget is not None and total >= budget:
            stop = True
        if not stop:
            # ---- refinement (vectorized or device-supplied) ----------------
            if ref_segments is not None:
                rbits = ref_segments[p]
            else:
                rm = rs < p
                rbits = (
                    (rmag[rm] >> np.uint64(num_bp - 1 - p)) & np.uint64(1)
                ).astype(np.uint8)
            segments.append(rbits)
            total += rbits.size
            if budget is not None and total >= budget:
                stop = True
        if stop:
            break

    allbits = np.concatenate(segments) if segments else np.empty(0, np.uint8)
    return _pack_stream(allbits, total, num_bp, budget)


def _pack_stream(
    bits: np.ndarray, total_bits: int, num_bp: int, budget=None
) -> bytes:
    """9-byte header {num_bitplanes u8, total_bits u64} + packed bits
    (bitstream_definition.txt:1-3); budget truncates packed bytes only."""
    emit = total_bits if budget is None else min(total_bits, budget)
    packed = np.packbits(bits[:emit], bitorder="little").tobytes()
    header = bytes([num_bp]) + int(total_bits).to_bytes(8, "little")
    return header + packed


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def decode_3d(
    stream: bytes, dims: Tuple[int, int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one 3D chunk stream (possibly truncated); returns
    (mags uint64, signs bool).

    Mirrors the serial decoder's observable semantics (SPECK_INT.cpp:166-228):
    sorting passes read from a zero-padded source (truncation appears as
    all-insignificant, the progressive-access property), refinement stops
    exactly at the available-bit mark mid-pass, and every refinement segment
    plus the final value reconstruction (init 2T - T/2 - 1, then +-T/2)
    applies as vectorized slices over the discovered per-pixel significance
    passes.  The only serial work is the set walk, batched over zero-runs."""
    nx, ny, nz = (int(d) for d in dims)
    n = nx * ny * nz
    tree = build_tree((nx, ny, nz))
    num_bp = stream[0]
    if num_bp == 0:
        return np.zeros(n, dtype=np.uint64), np.ones(n, dtype=bool)

    w = _DecWalk(tree, bytes(stream), n, num_bp)
    for rid in tree.root_ids:
        w.add_root(int(rid), int(tree.root_levels[rid]))
    w.run()
    return w.reconstruct()


# ===========================================================================
# 2D variant: quad partitions + the type-I "everything else" set
# (reference SPECK2D_INT.cpp:11-218).  Same decomposition as 3D — pixel bits
# (LIP + refinement) are vectorized from (e, s, sign); only the quad/I-set
# walk is control flow.  Per-pass segments: LIP ‖ LIS ‖ I-expansion ‖ refine.
# ===========================================================================
class Tree2:
    __slots__ = (
        "dims", "n", "nlevels", "xf",
        "node_level", "node_ch_start", "node_ch_count", "node_depth_ranges",
        "ch_is_pixel", "ch_ref", "px_linear", "px_parent",
        "root_id", "iset_groups",  # iset_groups[k] = list of node ids (k=xf..1)
        "iset_regions",  # [k] = (ax, ay) corner excluded from I at level k
    )


def _quad_children(s):
    """QccPack order: BR, BL, TR, TL (SPECK2D_INT.cpp:60-97)."""
    sx, sy, lx, ly = s
    ax, dx = lx - lx // 2, lx // 2
    ay, dy = ly - ly // 2, ly // 2
    return [
        (sx + ax, sy + ay, dx, dy),
        (sx, sy + ay, ax, dy),
        (sx + ax, sy, dx, ay),
        (sx, sy, ax, ay),
    ]


_TREES2: Dict[Tuple[int, int], "Tree2"] = {}


def build_tree2(dims: Tuple[int, int]) -> "Tree2":
    key = (int(dims[0]), int(dims[1]))
    t = _TREES2.get(key)
    if t is not None:
        return t
    nx, ny = key
    n = nx * ny
    xf = num_of_xforms(min(nx, ny))

    a_xf, _ = calc_approx_detail_len(nx, xf)
    b_xf, _ = calc_approx_detail_len(ny, xf)

    # roots: S0, then I-children groups for k = xf .. 1 (push order BR,TR,BL)
    roots = [((0, 0, a_xf, b_xf), xf)]
    iset_groups: List[List[int]] = [[] for _ in range(xf + 1)]
    iset_regions: List[Tuple[int, int]] = [(0, 0)] * (xf + 1)
    rid = 1
    for k in range(xf, 0, -1):
        ax, dx = calc_approx_detail_len(nx, k)
        ay, dy = calc_approx_detail_len(ny, k)
        iset_regions[k] = (ax, ay)
        for s in ((ax, ay, dx, dy), (ax, 0, dx, ay), (0, ay, ax, dy)):
            if s[2] * s[3] != 0:
                roots.append((s, k))
                iset_groups[k].append(rid)
                rid += 1

    R = len(roots)
    node_level = [np.array([lev for _, lev in roots], dtype=np.int16)]
    depth_ranges: List[Tuple[int, int]] = [(0, R)]
    ch_is_pixel: List[np.ndarray] = []
    ch_ref: List[np.ndarray] = []
    ch_counts: List[np.ndarray] = []
    px_linear: List[np.ndarray] = []
    px_parent: List[np.ndarray] = []

    f = np.array([s for s, _ in roots], dtype=np.int64).reshape(R, 4)
    f_lev = node_level[0].astype(np.int64)
    f_ids = np.arange(R, dtype=np.int64)
    n_nodes, n_px = R, 0

    while f_ids.size:
        K = f_ids.size
        sx, sy, lx, ly = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
        ax, dx = lx - lx // 2, lx // 2
        ay, dy = ly - ly // 2, ly // 2
        csx = np.stack([sx + ax, sx, sx + ax, sx], axis=1)
        csy = np.stack([sy + ay, sy + ay, sy, sy], axis=1)
        clx = np.stack([dx, ax, dx, ax], axis=1)
        cly = np.stack([dy, dy, ay, ay], axis=1)
        ne = clx * cly
        valid = ne > 0
        flat_valid = valid.ravel()
        is_px = (ne == 1).ravel()[flat_valid]
        rows_ref = np.empty(int(flat_valid.sum()), dtype=np.int64)

        lin = (csy * nx + csx).ravel()[flat_valid][is_px]
        pxpar = np.repeat(f_ids, 4).ravel()[flat_valid][is_px]
        rows_ref[is_px] = n_px + np.arange(lin.size)
        px_linear.append(lin)
        px_parent.append(pxpar)
        n_px += lin.size

        nd_mask = ~is_px
        nnd = int(nd_mask.sum())
        rows_ref[nd_mask] = n_nodes + np.arange(nnd)
        ch_is_pixel.append(is_px)
        ch_ref.append(rows_ref)
        ch_counts.append(valid.sum(axis=1))

        sel = (ne > 1).ravel()
        nf = np.stack(
            [csx.ravel()[sel], csy.ravel()[sel], clx.ravel()[sel], cly.ravel()[sel]],
            axis=1,
        )
        nf_lev = (np.repeat(f_lev, 4).ravel()[sel] + 1).astype(np.int64)
        node_level.append(nf_lev.astype(np.int16))
        depth_ranges.append((n_nodes, n_nodes + nnd))
        n_nodes += nnd
        f, f_lev = nf, nf_lev
        f_ids = np.arange(n_nodes - nnd, n_nodes, dtype=np.int64)

    t = Tree2()
    t.dims = key
    t.n = n
    t.xf = xf
    t.nlevels = num_of_partitions(max(nx, ny)) + 1
    t.node_level = np.concatenate(node_level).astype(np.int16)
    counts = np.concatenate(ch_counts)
    t.node_ch_count = counts
    t.node_ch_start = np.cumsum(counts) - counts
    t.node_depth_ranges = [r for r in depth_ranges if r[1] > r[0]]
    t.ch_is_pixel = np.concatenate(ch_is_pixel)
    t.ch_ref = np.concatenate(ch_ref)
    t.px_linear = np.concatenate(px_linear) if px_linear else np.empty(0, np.int64)
    t.px_parent = np.concatenate(px_parent) if px_parent else np.empty(0, np.int64)
    t.root_id = 0
    t.iset_groups = iset_groups
    t.iset_regions = iset_regions
    _TREES2[key] = t
    return t


def _iset_maxes(tree: Tree2, pmsb2d: np.ndarray) -> np.ndarray:
    """max msb+1 over the I region at each level k (1..xf); index 0 unused."""
    nx, ny = tree.dims
    out = np.zeros(tree.xf + 1, dtype=np.int16)
    for k in range(1, tree.xf + 1):
        ax, ay = tree.iset_regions[k]
        m = 0
        if ay < ny:
            m = int(pmsb2d[ay:, :].max()) if pmsb2d[ay:, :].size else 0
        if ax < nx and ay > 0:
            m2 = int(pmsb2d[:ay, ax:].max()) if pmsb2d[:ay, ax:].size else 0
            m = max(m, m2)
        out[k] = m
    return out


def encode_2d(
    mags: np.ndarray,
    signs: np.ndarray,
    dims: Tuple[int, int],
    budget_bits: int = 0,
) -> bytes:
    """2D wavefront encoder; byte-identical to the serial engines."""
    nx, ny = (int(d) for d in dims)
    n = nx * ny
    mags = np.ascontiguousarray(mags).reshape(n)
    signs = np.ascontiguousarray(signs).reshape(n).astype(bool)
    tree = build_tree2((nx, ny))

    pmsb = msbp1(mags)
    num_bp = int(pmsb.max()) if n else 0
    if num_bp == 0:
        return _pack_stream(np.empty(0, np.uint8), 0, 0)
    node_max = compute_node_max(tree, pmsb)
    return stitch_2d(
        pmsb, signs, node_max, (nx, ny), num_bp, None, None, budget_bits,
        mags=mags,
    )


def stitch_2d(
    pmsb: np.ndarray,
    signs: np.ndarray,
    node_max: np.ndarray,
    dims: Tuple[int, int],
    num_bp: int,
    lip_segments,
    ref_segments,
    budget_bits: int = 0,
    mags: np.ndarray = None,
    s_lin: np.ndarray = None,
    iset_max: np.ndarray = None,
    lis_segments=None,
) -> bytes:
    """2D analog of stitch_3d: assemble the stream from pixel schedules
    (device-supplied segments optional) plus the quad/I-set walk.  When
    all three segment families are supplied (the full device-entropy
    path, ops/speck_lis2_jax.py), this is pure concatenation."""
    nx, ny = dims
    n = nx * ny
    tree = build_tree2((nx, ny))
    budget = (budget_bits + 7) // 8 * 8 if budget_bits else None

    if lis_segments is None or lip_segments is None:
        node_s = np.where(node_max > 0, num_bp - node_max, _NEVER).astype(
            np.int32
        )
    if s_lin is None and pmsb is not None:
        s_lin = np.where(pmsb > 0, num_bp - pmsb, _NEVER).astype(np.int32)
    if lip_segments is None:
        e_lin = np.full(n, _NEVER, dtype=np.int32)
        e_lin[tree.px_linear] = node_s[tree.px_parent]
        cand = np.flatnonzero((e_lin < num_bp) & (s_lin > e_lin))
        ce, cs = e_lin[cand], s_lin[cand]
        csign = signs[cand]
    if ref_segments is None:
        rnz = np.flatnonzero(s_lin < _NEVER)
        rs = s_lin[rnz]
        rmag = mags[rnz].astype(np.uint64)

    if lis_segments is not None:
        lis_all = lis_segments
    else:
        if iset_max is None:
            iset_max = _iset_maxes(tree, pmsb.reshape(ny, nx))
        iset_s = np.where(
            iset_max > 0, num_bp - iset_max, _NEVER
        ).astype(np.int32)
        # LIS bits: the set walk (quad partitions + I-set) as a
        # lexicographic sort (codec/speck_sorted.py) — no recursion in the
        # 2D encoder either.
        from .speck_sorted import lis_segments_sorted_2d

        lis_all = lis_segments_sorted_2d(
            tree, node_s, s_lin, signs, num_bp, iset_s
        )

    segments: List[np.ndarray] = []
    total = 0
    stop = False
    for p in range(num_bp):
        if lip_segments is not None:
            lip_bits = lip_segments[p]
        else:
            lip_bits = _lip_segment(ce, cs, csign, p)
        lis_bits = lis_all[p]

        segments.append(lip_bits)
        segments.append(lis_bits)
        total += lip_bits.size + lis_bits.size
        if budget is not None and total >= budget:
            stop = True
        if not stop:
            if ref_segments is not None:
                rbits = ref_segments[p]
            else:
                rm = rs < p
                rbits = (
                    (rmag[rm] >> np.uint64(num_bp - 1 - p)) & np.uint64(1)
                ).astype(np.uint8)
            segments.append(rbits)
            total += rbits.size
            if budget is not None and total >= budget:
                stop = True
        if stop:
            break

    allbits = np.concatenate(segments) if segments else np.empty(0, np.uint8)
    return _pack_stream(allbits, total, num_bp, budget)


def decode_2d(
    stream: bytes, dims: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """2D wavefront decoder (full or truncated streams)."""
    nx, ny = (int(d) for d in dims)
    n = nx * ny
    tree = build_tree2((nx, ny))
    num_bp = stream[0]
    if num_bp == 0:
        return np.zeros(n, dtype=np.uint64), np.ones(n, dtype=bool)

    w = _DecWalk(tree, bytes(stream), n, num_bp)
    w.add_root(0, int(tree.node_level[0]))
    i_lev = tree.xf if tree.xf > 0 else 0

    def process_i(p: int, decide: bool = True) -> None:
        nonlocal i_lev
        if i_lev <= 0:
            return
        if decide:
            sig = w.bits[w.pos]
            w.pos += 1
        else:
            sig = 1
        if sig:
            code_i(p)

    def code_i(p: int) -> None:
        nonlocal i_lev
        k = i_lev
        i_lev -= 1
        counter = 0
        for nid in tree.iset_groups[k]:
            sig = w.bits[w.pos]
            w.pos += 1
            if sig:
                counter += 1
                w.code_s(nid, p)
            else:
                w.born[int(tree.node_level[nid])].append(nid)
        process_i(p, counter != 0)

    w.run(i_hook=process_i)
    return w.reconstruct()


# ===========================================================================
# 1D variant: binary interval partitions (reference SPECK1D_INT*.cpp).  The
# serial coder's position-inference optimization (first-significant-offset
# deciding both halves, SPECK1D_INT_ENC.cpp:74-95) only saves *computation*;
# the emitted bits follow the same last-child-skip rule the shared walks
# implement.  One 1D quirk: partitioning a length-1 set produces an empty
# second half that emits a single decision bit and is then dropped — modeled
# with the walks' node_alive mask.
# ===========================================================================
class Tree1:
    __slots__ = (
        "dims", "n", "nlevels",
        "node_level", "node_ch_start", "node_ch_count", "node_depth_ranges",
        "ch_is_pixel", "ch_ref", "px_linear", "px_parent",
        "root_ids", "root_levels", "node_alive",
    )


_TREES1: Dict[int, "Tree1"] = {}


def build_tree1(n: int) -> "Tree1":
    n = int(n)
    t = _TREES1.get(n)
    if t is not None:
        return t
    a = n - n // 2
    # roots at level 1: [0, a) and [a, n) — the latter may be empty (n == 1)
    roots = [(0, a), (a, n - a)]
    nlevels = num_of_partitions(n) + 2

    node_start = [np.array([r[0] for r in roots], dtype=np.int64)]
    node_len = [np.array([r[1] for r in roots], dtype=np.int64)]
    node_level = [np.full(len(roots), 1, dtype=np.int16)]
    depth_ranges = [(0, len(roots))]
    ch_is_pixel: List[np.ndarray] = []
    ch_ref: List[np.ndarray] = []
    ch_counts: List[np.ndarray] = []
    px_linear: List[np.ndarray] = []
    px_parent: List[np.ndarray] = []

    f_start, f_len = node_start[0], node_len[0]
    f_lev = node_level[0].astype(np.int64)
    f_ids = np.arange(len(roots), dtype=np.int64)
    n_nodes, n_px = len(roots), 0

    while f_ids.size:
        live = f_len > 0  # empty sets have no children
        K = f_ids.size
        ca = f_len - f_len // 2
        cst = np.stack([f_start, f_start + ca], axis=1)
        cln = np.stack([ca, f_len - ca], axis=1)
        # children exist only for parents with len >= 2 (pixels and empties
        # terminate); a len-1 parent still splits into [pixel, empty] halves
        has_kids = f_len >= 1
        ne = np.where(has_kids[:, None], cln, -1)  # -1 marks "no row"
        flat_ne = ne.ravel()
        fv = np.flatnonzero(flat_ne >= 0)
        ne_v = flat_ne[fv]
        px_mask = ne_v == 1
        dead_or_node = ~px_mask  # len 0 (dead) or len >= 2 (node)
        rows_ref = np.empty(fv.size, dtype=np.int64)

        fpx = fv[px_mask]
        lin = cst.ravel()[fpx]
        rows_ref[px_mask] = n_px + np.arange(fpx.size)
        px_linear.append(lin)
        px_parent.append(f_ids[fpx >> 1])
        n_px += fpx.size

        fnd = fv[dead_or_node]
        nnd = fnd.size
        rows_ref[dead_or_node] = n_nodes + np.arange(nnd)
        ch_is_pixel.append(px_mask)
        ch_ref.append(rows_ref)
        ch_counts.append(np.where(live, 2, 0).astype(np.int64))

        node_start.append(cst.ravel()[fnd])
        node_len.append(cln.ravel()[fnd])
        node_level.append((np.repeat(f_lev, 2)[fnd] + 1).astype(np.int16))
        depth_ranges.append((n_nodes, n_nodes + nnd))
        n_nodes += nnd

        f_start = cst.ravel()[fnd]
        f_len = cln.ravel()[fnd]
        f_lev = np.repeat(f_lev, 2)[fnd] + 1
        f_ids = np.arange(n_nodes - nnd, n_nodes, dtype=np.int64)

    t = Tree1()
    t.dims = (n, 1, 1)
    t.n = n
    t.nlevels = nlevels + 2  # slack for deep odd splits
    lv = np.concatenate(node_level).astype(np.int16)
    t.node_level = lv
    counts = np.concatenate(ch_counts)
    t.node_ch_count = counts
    t.node_ch_start = np.cumsum(counts) - counts
    t.node_depth_ranges = [r for r in depth_ranges if r[1] > r[0]]
    t.ch_is_pixel = np.concatenate(ch_is_pixel) if ch_is_pixel else np.empty(0, bool)
    t.ch_ref = np.concatenate(ch_ref) if ch_ref else np.empty(0, np.int64)
    t.px_linear = np.concatenate(px_linear) if px_linear else np.empty(0, np.int64)
    t.px_parent = np.concatenate(px_parent) if px_parent else np.empty(0, np.int64)
    t.root_ids = np.arange(len(roots), dtype=np.int64)
    t.root_levels = np.full(len(roots), 1, dtype=np.int16)
    alive = np.concatenate(node_len) > 0
    t.node_alive = alive
    if lv.max(initial=0) >= t.nlevels:
        t.nlevels = int(lv.max()) + 1
    _TREES1[n] = t
    return t


def encode_1d(
    mags: np.ndarray, signs: np.ndarray, n: int, budget_bits: int = 0
) -> bytes:
    """1D wavefront encoder; byte-identical to the serial engines."""
    n = int(n)
    mags = np.ascontiguousarray(mags).reshape(n)
    signs = np.ascontiguousarray(signs).reshape(n).astype(bool)
    tree = build_tree1(n)

    pmsb = msbp1(mags)
    num_bp = int(pmsb.max()) if n else 0
    if num_bp == 0:
        return _pack_stream(np.empty(0, np.uint8), 0, 0)
    budget = (budget_bits + 7) // 8 * 8 if budget_bits else None

    node_max = compute_node_max(tree, pmsb)
    node_s = np.where(
        (node_max > 0) & tree.node_alive, num_bp - node_max, _NEVER
    ).astype(np.int32)
    s_lin = np.where(pmsb > 0, num_bp - pmsb, _NEVER).astype(np.int32)
    e_lin = np.full(n, _NEVER, dtype=np.int32)
    e_lin[tree.px_linear] = node_s[tree.px_parent]
    cand = np.flatnonzero((e_lin < num_bp) & (s_lin > e_lin))
    ce, cs = e_lin[cand], s_lin[cand]
    csign = signs[cand]
    rnz = np.flatnonzero(pmsb > 0)
    rs = s_lin[rnz]
    rmag = mags[rnz].astype(np.uint64)

    # LIS bits via the sorted emission (codec/speck_sorted.py): the 1D tree's
    # zero-length sets are handled by the node_alive mask.
    from .speck_sorted import lis_segments_sorted

    lis_all = lis_segments_sorted(tree, node_s, s_lin, signs, num_bp)

    segments: List[np.ndarray] = []
    total = 0
    stop = False
    for p in range(num_bp):
        lip_bits = _lip_segment(ce, cs, csign, p)
        lis_bits = lis_all[p]
        segments.append(lip_bits)
        segments.append(lis_bits)
        total += lip_bits.size + lis_bits.size
        if budget is not None and total >= budget:
            stop = True
        if not stop:
            rm = rs < p
            rbits = (
                (rmag[rm] >> np.uint64(num_bp - 1 - p)) & np.uint64(1)
            ).astype(np.uint8)
            segments.append(rbits)
            total += rbits.size
            if budget is not None and total >= budget:
                stop = True
        if stop:
            break
    allbits = np.concatenate(segments) if segments else np.empty(0, np.uint8)
    return _pack_stream(allbits, total, num_bp, budget)


def decode_1d(stream: bytes, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """1D wavefront decoder (full or truncated streams)."""
    n = int(n)
    tree = build_tree1(n)
    num_bp = stream[0]
    if num_bp == 0:
        return np.zeros(n, dtype=np.uint64), np.ones(n, dtype=bool)
    w = _DecWalk(tree, bytes(stream), n, num_bp)
    for rid in tree.root_ids:
        w.add_root(int(rid), int(tree.root_levels[rid]))
    w.run()
    return w.reconstruct()


__all__ = [
    "encode_3d",
    "decode_3d",
    "encode_2d",
    "decode_2d",
    "stitch_2d",
    "encode_1d",
    "decode_1d",
    "stitch_3d",
    "compute_node_max",
    "build_tree",
    "build_tree2",
    "build_tree1",
    "msbp1",
]
