"""Bounded-memory (blockwise) suffix-array construction.

The role of the reference's KarkkainenBlockwiseSA + DifferenceCoverSample
(blockwise_sa.h:183; diff_sample.h:521): build the SA of a multi-Gbp
text without ever holding the whole SA (8 B/suffix) in memory.  The
scheme is re-derived for vectorized numpy rather than translated:

1. *Difference-cover sample* mod v (default 1024): positions whose
   residue lies in a cover set D (generated greedily here, not copied
   from the reference's Colbourn-Ling tables).  Sample suffixes are
   sorted to depth v with successive 64-bit packed 32-char keys, then
   completed by stride-v prefix doubling (the Larsson-Sadakane role,
   ls.h:43), giving every sample suffix a global rank.
   Memory ~ n * |D|/v * 16 B.
2. Suffixes are histogrammed by their first 8 chars (base-5 digits so
   a text end sorts high), buckets are grouped into chunks of at most
   `bmax` suffixes, and each chunk is collected by a streaming scan,
   sorted by successive 32-char keys to depth v, with groups still
   tied at depth v resolved by the difference-cover comparator
   (compare sample ranks at i+delta, j+delta where
   delta = delta_table[i%v, j%v] < v — Burkhardt-Karkkainen).
   Memory ~ bmax * 24 B per chunk.
3. Chunks are yielded left to right; the streaming index writer
   consumes them without materializing the SA.

Near-end suffixes (the last v+64 text positions) are excluded from all
vectorized sorts — 64-bit key windows would cross the text end, where
bowtie's order (a proper-prefix suffix sorts AFTER its extensions,
i.e. the implicit sentinel is the largest character) cannot be encoded
in 2-bit padding.  Those few suffixes are placed exactly with direct
python comparisons instead.

The produced SA is element-for-element the one `suffix_array` (SA-IS)
returns.  Host numpy only: the port runs this route as the JAX package
does, and `bowtie-build --jax-sa` leaves it without a device SA.  Spill
files go to a fresh directory under $TMPDIR and are removed as read.
"""
from __future__ import annotations

import functools
import os
import tempfile

import numpy as np

from .sa import suffix_array

V_DEFAULT = 1024
KEY_CHARS = 32            # chars per packed uint64 refinement key
BKT_CHARS = 8             # chars per top-level bucket key (base 5)


# ---------------------------------------------------------------------------
# Difference cover
# ---------------------------------------------------------------------------

def difference_cover(v: int) -> np.ndarray:
    """A set D with D - D covering Z_v, built greedily.  Within ~2x of
    the optimal sqrt(1.5 v) size — only affects sample memory."""
    covered = np.zeros(v, bool)
    covered[0] = True
    D = [0]
    Darr = np.array(D, np.int64)
    while not covered.all():
        best, best_gain = 1, -1
        for c in range(1, v):
            diffs = np.concatenate([(c - Darr) % v, (Darr - c) % v])
            gain = int((~covered[diffs]).sum())
            if gain > best_gain:
                best, best_gain = c, gain
        D.append(best)
        Darr = np.array(D, np.int64)
        diffs = np.concatenate([(best - Darr) % v, (Darr - best) % v])
        covered[diffs] = True
    return np.array(sorted(D), dtype=np.int64)


_DC_CACHE: dict = {}


def cached_cover(v: int) -> np.ndarray:
    if v not in _DC_CACHE:
        _DC_CACHE[v] = difference_cover(v)
    return _DC_CACHE[v]


def delta_table(v: int, D: np.ndarray) -> np.ndarray:
    """delta[a, b] = min k >= 0 with (a+k) % v in D and (b+k) % v in D
    (diff_sample.h lookup role).  int32 [v, v], always < v."""
    inD = np.zeros(v, bool)
    inD[D % v] = True
    out = np.empty((v, v), np.int32)
    b = np.arange(v)
    for a in range(v):
        ks = np.sort((D - a) % v)
        hit = inD[(b[:, None] + ks[None, :]) % v]
        assert hit.any(axis=1).all(), "not a difference cover"
        out[a] = ks[np.argmax(hit, axis=1)]
    return out


# ---------------------------------------------------------------------------
# Packed text keys
# ---------------------------------------------------------------------------

class PackedText:
    """2-bit packed text with vectorized 32-char big-endian key reads.
    key(p) orders exactly like chars s[p..p+31] (char 0 most
    significant).  Callers guarantee p + 32 <= n."""

    def __init__(self, codes: np.ndarray):
        self.n = len(codes)
        nw = (self.n + 31) // 32 + 2
        pad = np.zeros(nw * 32, np.uint8)
        pad[:self.n] = codes
        # chars big-endian within each byte, bytes big-endian per word
        by = ((pad[0::4] << 6) | (pad[1::4] << 4) |
              (pad[2::4] << 2) | pad[3::4]).astype(np.uint8)
        self.words = by.view(">u8").astype(np.uint64)
        self.codes = codes

    def keys(self, pos: np.ndarray) -> np.ndarray:
        # temporaries are kept to a minimum (in-place ops): this runs
        # over multi-GB position streams during bucket scans, and each
        # len(pos) temporary costs 8 B/entry of peak RSS
        w = pos >> 5
        out = self.words[w]                    # hi word (gather copy)
        w += 1
        lo = self.words[w]                     # lo word
        del w
        r = (pos & 31).astype(np.uint64)
        r <<= 1                                # 2*(pos%32)
        out <<= r
        nz = r > 0
        np.subtract(64, r, out=r)
        lo >>= r
        out[nz] |= lo[nz]
        return out


def suffix_cmp(codes: np.ndarray, a: int, b: int) -> int:
    """Exact bowtie-order suffix comparison (sentinel largest)."""
    n = len(codes)
    la, lb = n - a, n - b
    step = 4096
    off = 0
    lim = min(la, lb)
    while off < lim:
        e = min(off + step, lim)
        ca = codes[a + off:a + e]
        cb = codes[b + off:b + e]
        neq = np.flatnonzero(ca != cb)
        if len(neq):
            d = int(neq[0])
            return -1 if ca[d] < cb[d] else 1
        off = e
    if la == lb:
        return 0
    return 1 if la < lb else -1      # shorter (prefix) sorts LAST


def _refine_to_depth(pt: PackedText, pos: np.ndarray, v: int):
    """Sort `pos` (all with n - p >= v + 64) by their first `v` chars.
    Returns (sorted_pos, grp) where grp is nondecreasing and equal
    entries are tied at depth v."""
    order = np.argsort(pt.keys(pos), kind="stable")
    sp = pos[order]
    k = pt.keys(sp)
    grp = np.zeros(len(sp), np.int64)
    if len(sp) > 1:
        np.cumsum(k[1:] != k[:-1], out=grp[1:])
    depth = KEY_CHARS
    while depth < v:
        tied = np.zeros(len(sp), bool)
        if len(sp) > 1:
            same = grp[1:] == grp[:-1]
            tied[1:] = same
            tied[:-1] |= same
        if not tied.any():
            break
        idx = np.flatnonzero(tied)
        k = pt.keys(sp[idx] + depth)
        sub = np.lexsort((k, grp[idx]))
        sp[idx] = sp[idx][sub]
        k = k[sub]
        g = grp[idx]
        split = np.zeros(len(idx), bool)
        split[1:] = (g[1:] == g[:-1]) & (k[1:] != k[:-1])
        # renumber: global group ids from boundaries
        bound = np.zeros(len(sp), bool)
        bound[1:] = grp[1:] != grp[:-1]
        bound[idx[split]] = True
        grp = np.cumsum(bound)
        depth += KEY_CHARS
    return sp, grp


# ---------------------------------------------------------------------------
# Sample ranks
# ---------------------------------------------------------------------------

class DCSample:
    """Global ranks of every difference-cover sample suffix."""

    def __init__(self, pt: PackedText, v: int = V_DEFAULT,
                 D: np.ndarray | None = None):
        self.v = v
        self.pt = pt
        n = pt.n
        if D is None:
            D = cached_cover(v)
        self.D = D
        self.nD = len(D)
        self.rankInD = np.full(v, -1, np.int32)
        self.rankInD[D % v] = np.arange(self.nD, dtype=np.int32)
        self.delta = delta_table(v, D)
        nblocks = (n + v - 1) // v
        pos = (np.arange(nblocks, dtype=np.int64)[:, None] * v +
               D[None, :]).reshape(-1)
        self.pos = pos[pos < n]
        self.m = len(self.pos)
        self.rank = self._rank_sample()        # rank by sample index

    def index_of(self, p: np.ndarray):
        """Sample index of sample position(s) p.  Valid because the
        (block, D-rank) layout only drops trailing members of the
        final partial block."""
        return (p // self.v) * self.nD + \
            self.rankInD[p % self.v].astype(np.int64)

    def rank_at(self, p: int) -> int:
        return int(self.rank[int(self.index_of(np.int64(p)))])

    def _rank_sample(self) -> np.ndarray:
        pt, v, n = self.pt, self.v, self.pt.n
        cut = max(0, n - (v + 64))
        vec = self.pos[self.pos < cut]
        tail = self.pos[self.pos >= cut]
        sp, grp = _refine_to_depth(pt, vec.copy(), v)
        # insert near-end sample suffixes exactly (python, <= |D|+64)
        order = list(map(int, sp))
        grp_l = list(map(int, grp))
        cmp = functools.partial(suffix_cmp, pt.codes)
        for p in sorted(map(int, tail),
                        key=functools.cmp_to_key(cmp)):
            lo, hi = 0, len(order)
            while lo < hi:
                mid = (lo + hi) // 2
                if cmp(order[mid], p) < 0:
                    lo = mid + 1
                else:
                    hi = mid
            # distinct from both neighbours (suffixes are unique), so
            # give it a fresh group id strictly between
            order.insert(lo, p)
            gl = grp_l[lo - 1] if lo > 0 else -1
            grp_l.insert(lo, gl + 1)
            for t in range(lo + 1, len(grp_l)):
                grp_l[t] += 1
        sp = np.array(order, np.int64)
        grp = np.array(grp_l, np.int64)
        # dense renumber (tail insertion may leave gaps/dups intact)
        b2 = np.zeros(len(sp), np.int64)
        if len(sp) > 1:
            np.cumsum(grp[1:] != grp[:-1], out=b2[1:])
        grp = b2
        # stride-v prefix doubling over sample ranks
        rank_by_idx = np.zeros(self.m, np.int64)
        rank_by_idx[self.index_of(sp)] = grp
        stride = v
        BIG = np.int64(self.m + 2)
        while True:
            if len(sp) < 2 or (grp[1:] != grp[:-1]).all():
                break
            nxt = sp + stride
            inside = nxt < n
            r2 = np.where(
                inside,
                rank_by_idx[np.minimum(self.index_of(
                    np.where(inside, nxt, 0)), self.m - 1)],
                # past-end extension: shorter sorts LAST; among several,
                # longer first (smaller p first)
                BIG + sp)
            order2 = np.lexsort((r2, grp))
            sp = sp[order2]
            g = grp[order2]
            r2 = r2[order2]
            ng = np.zeros(len(sp), np.int64)
            np.cumsum((g[1:] != g[:-1]) | (r2[1:] != r2[:-1]),
                      out=ng[1:])
            grp = ng
            rank_by_idx[self.index_of(sp)] = grp
            stride *= 2
        rank_by_idx[self.index_of(sp)] = grp
        return rank_by_idx


# ---------------------------------------------------------------------------
# Blockwise SA
# ---------------------------------------------------------------------------

def _bucket_keys16(pt: "PackedText", lo: int, hi: int):
    """Base-4 first-8-char keys for vector-set suffixes [lo, hi)
    (guaranteed >= 8 chars before the text end)."""
    pos = np.arange(lo, hi, dtype=np.int64)
    return (pt.keys(pos) >> np.uint64(48)).astype(np.int64)


def _tail_key16(codes: np.ndarray, p: int) -> int:
    """Pad-with-T key for a near-end suffix: places it in the LAST
    bucket whose members share its (possibly short) prefix; exact
    position within the chunk is found by direct comparison."""
    n = len(codes)
    key = 0
    for j in range(BKT_CHARS):
        d = int(codes[p + j]) if p + j < n else 3
        key = key * 4 + min(d, 3)
    return key


def blockwise_sa_chunks(codes: np.ndarray, bmax: int | None = None,
                        dcv: int = V_DEFAULT, sample: DCSample = None):
    """Yield the SA of `codes` (+ final sentinel row) as ordered int64
    chunks, never materializing more than ~bmax suffixes at once."""
    n = len(codes)
    if bmax is None:
        bmax = max(1 << 20, n // 4)
    v = dcv
    pt = PackedText(codes)
    if sample is None:
        sample = DCSample(pt, v)
    dl = sample.delta
    rank = sample.rank
    cut = max(0, n - (v + 64))

    # near-end suffixes, exactly ordered (python)
    cmp = functools.partial(suffix_cmp, codes)
    tail_sorted = sorted(range(cut, n), key=functools.cmp_to_key(cmp))
    tail_keys = [_tail_key16(codes, p) for p in tail_sorted]

    # histogram of 16-bit bucket keys (one streaming pass); small scan
    # step bounds the keys()/argsort transients (~10 arrays x step)
    nbkt = 1 << (2 * BKT_CHARS)
    hist = np.zeros(nbkt, np.int64)
    step = 1 << 22
    for lo in range(0, cut, step):
        hi = min(cut, lo + step)
        hist += np.bincount(_bucket_keys16(pt, lo, hi),
                            minlength=nbkt)

    # group buckets into chunks <= bmax (single buckets may exceed)
    csum = np.cumsum(hist)
    bounds = [0]
    while bounds[-1] < nbkt:
        b0 = bounds[-1]
        base = csum[b0 - 1] if b0 > 0 else 0
        b1 = int(np.searchsorted(csum, base + bmax, side="right"))
        bounds.append(max(b1, b0 + 1))
    ti = 0                  # tail cursor

    # one partition pass -> per-chunk spill files (the disk analog of
    # blockwise_sa.h:235-266's <base>.<N>.sa worker spills)
    spill_dir = tempfile.mkdtemp(prefix="btw_sa_")
    nchunks = len(bounds) - 1
    barr = np.array(bounds[:-1], np.int64)
    files = [open(os.path.join(spill_dir, f"c{i}.bin"), "wb")
             for i in range(nchunks)]
    for lo in range(0, cut, step):
        hi = min(cut, lo + step)
        k = _bucket_keys16(pt, lo, hi)
        cid = np.searchsorted(barr, k, side="right") - 1
        order = np.argsort(cid, kind="stable")
        cs = cid[order]
        pos_s = np.arange(lo, hi, dtype=np.int64)[order]
        starts = np.flatnonzero(np.concatenate(
            [[True], cs[1:] != cs[:-1]]))
        starts = np.append(starts, len(cs))
        for s0, s1 in zip(starts[:-1], starts[1:]):
            files[int(cs[s0])].write(pos_s[s0:s1].tobytes())
    for f in files:
        f.close()

    for ci, (b0, b1) in enumerate(zip(bounds[:-1], bounds[1:])):
        path = os.path.join(spill_dir, f"c{ci}.bin")
        pos = np.fromfile(path, dtype=np.int64)
        os.unlink(path)
        if len(pos):
            sp, grp = _refine_to_depth(pt, pos, v)
            # resolve depth-v ties with the DC comparator
            if len(sp) > 1:
                same = grp[1:] == grp[:-1]
                if same.any():
                    tied = np.zeros(len(sp), bool)
                    tied[1:] = same
                    tied[:-1] |= same
                    bound = np.flatnonzero(~np.concatenate(
                        [[False], grp[1:] == grp[:-1]]))
                    bound = np.append(bound, len(sp))
                    for s0, s1 in zip(bound[:-1], bound[1:]):
                        if s1 - s0 < 2:
                            continue
                        seg = sp[s0:s1]

                        def dc_cmp(a, b):
                            d = int(dl[a % v, b % v])
                            ra = rank[int(sample.index_of(
                                np.int64(a + d)))]
                            rb = rank[int(sample.index_of(
                                np.int64(b + d)))]
                            return -1 if ra < rb else \
                                (1 if ra > rb else 0)
                        sp[s0:s1] = sorted(
                            map(int, seg),
                            key=functools.cmp_to_key(dc_cmp))
        else:
            sp = pos
        # merge in near-end suffixes belonging to this key range
        inserts = []
        while ti < len(tail_sorted) and tail_keys[ti] < b1:
            p = tail_sorted[ti]
            lo_i, hi_i = 0, len(sp)
            while lo_i < hi_i:
                mid = (lo_i + hi_i) // 2
                if suffix_cmp(codes, int(sp[mid]), p) < 0:
                    lo_i = mid + 1
                else:
                    hi_i = mid
            inserts.append((lo_i, p))
            ti += 1
        if inserts:
            # stable: ties on the insertion point keep tail order
            inserts.sort(key=lambda x: x[0])
            out = np.empty(len(sp) + len(inserts), np.int64)
            prev = 0
            woff = 0
            for at, p in inserts:
                out[woff:woff + (at - prev)] = sp[prev:at]
                woff += at - prev
                out[woff] = p
                woff += 1
                prev = at
            out[woff:] = sp[prev:]
            sp = out
        if len(sp):
            yield sp
    # any remaining tail suffixes (keys beyond the last bucket bound
    # can't happen — bounds cover the full key space), then sentinel
    while ti < len(tail_sorted):
        yield np.array([tail_sorted[ti]], np.int64)
        ti += 1
    try:
        os.rmdir(spill_dir)
    except OSError:
        pass
    yield np.array([n], np.int64)


def suffix_array_blockwise(codes: np.ndarray, bmax: int | None = None,
                           dcv: int = V_DEFAULT) -> np.ndarray:
    """Materialized blockwise SA (testing / small inputs)."""
    n = len(codes)
    if n < 4 * dcv:
        return suffix_array(codes)
    return np.concatenate(list(blockwise_sa_chunks(codes, bmax, dcv)))
