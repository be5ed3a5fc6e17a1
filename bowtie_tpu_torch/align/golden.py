"""NumPy oracle for FM-index search — the reference semantics in slow,
obviously-correct form.  A copy of bowtie_tpu/align/golden.py; the host
oracle (backtrack_oracle.py, drivers.py) runs on it.

Semantics mirror ebwt.h: countUpTo/countFwSide/countBwSide (rank with the
'$'-as-'A' correction, ebwt.h:2044-2052), mapLF (LF mapping), ftab jump
(ebwt_search_backtrack.h:254-257, calcFtabOff :1348), walk-left offset
resolution (reportChaseOne ebwt.h:2693-2755) and joinedToTextOff
(ebwt.h:2569-2629).
"""
from __future__ import annotations

import numpy as np

from ..index.arrays import OCC_BLOCK, build_dense_sa, build_occ_checkpoints
from ..index.ebwt_io import EbwtIndex


# below this genome size keep dense per-row rank/SA tables on host:
# O(1) rank/resolve instead of per-call block scans / walk-left loops —
# a large constant-factor win for the scalar engines
DENSE_HOST_LIMIT = 1 << 27


def build_full_rank(bwt_codes: np.ndarray) -> np.ndarray:
    """occ[i, c] = count of stored code c in rows [0, i) — full table."""
    n = len(bwt_codes)
    ck = np.zeros((n + 1, 4), dtype=np.int32)
    for c in range(4):
        np.cumsum(bwt_codes == c, out=ck[1:, c])
    return ck


class GoldenFM:
    """Scalar FM-index operations over a parsed EbwtIndex."""

    def __init__(self, idx: EbwtIndex, dense: bool | None = None):
        self.idx = idx
        self.occ = build_occ_checkpoints(idx.bwt)
        self.B = OCC_BLOCK
        self.ftab_hi, self.ftab_lo = idx.ftab_resolved()
        if dense is None:
            dense = idx.length <= DENSE_HOST_LIMIT
        self._occ_full = None
        self._sa_dense = None
        self._fchr_l = [int(x) for x in idx.fchr[:4]]
        self._zoff = int(idx.zoff)
        if dense and idx.offs is not None:
            self._occ_full = build_full_rank(idx.bwt)
            self._sa_dense = build_dense_sa(idx, "cpu").numpy()

    # -- rank ----------------------------------------------------------
    def rank(self, c: int, i: int) -> int:
        """Occ(c, i): occurrences of char c in BWT rows [0, i).

        The '$' row (zoff) is stored as an 'A' but is not an 'A'
        (ebwt.h:2044-2052): subtract it from A-counts when i > zoff.
        """
        idx = self.idx
        if self._occ_full is not None:
            cnt = int(self._occ_full[i, c])
            if c == 0 and i > idx.zoff:
                cnt -= 1
            return cnt
        k, r = divmod(i, self.B)
        cnt = int(self.occ[k, c]) + int(np.count_nonzero(
            idx.bwt[k * self.B: k * self.B + r] == c))
        if c == 0 and i > idx.zoff:
            cnt -= 1
        return cnt

    def rank4(self, i: int) -> np.ndarray:
        return np.array([self.rank(c, i) for c in range(4)], dtype=np.int64)

    # -- LF ------------------------------------------------------------
    def lf(self, i: int, c: int) -> int:
        """top'/bot' step: fchr[c] + Occ(c, i)  (ebwt.h mapLF(l, c))."""
        if self._occ_full is not None:
            cnt = self._occ_full[i, c].item()
            if c == 0 and i > self._zoff:
                cnt -= 1
            return self._fchr_l[c] + cnt
        return int(self.idx.fchr[c]) + self.rank(c, i)

    def lf4(self, i: int) -> list:
        """All four LF destinations of row i in one row read (the
        scalar-engine mapLFEx, ebwt.h:2334)."""
        if self._occ_full is None:
            return [self.lf(i, c) for c in range(4)]
        r = self._occ_full[i].tolist()
        f = self._fchr_l
        a = r[0] + f[0]
        if i > self._zoff:
            a -= 1                       # '$' stored as 'A' (zoff fix)
        return [a, r[1] + f[1], r[2] + f[2], r[3] + f[3]]

    def lf_row(self, i: int) -> int:
        """LF of a row via its own BWT char (ebwt.h mapLF(l)).

        Undefined at i == zoff (the '$' row); callers must stop there.
        """
        assert i != self.idx.zoff
        c = int(self.idx.bwt[i])
        return self.lf(i, c)

    # -- text reconstruction -------------------------------------------
    def restore(self) -> np.ndarray:
        """Rebuild the joined text by LF-walking from the last row
        (Ebwt::restore, ebwt.h:2763-2781)."""
        idx = self.idx
        n = idx.length
        s = np.zeros(n, dtype=np.uint8)
        i = n  # last row of the BWT
        jumps = 0
        while i != idx.zoff:
            s[n - jumps - 1] = idx.bwt[i]
            i = self.lf_row(i)
            jumps += 1
        assert jumps == n
        return s

    # -- ftab ------------------------------------------------------------
    def ftab_range(self, codes: np.ndarray) -> tuple[int, int]:
        """(top, bot) for the ftabChars-long word `codes` (leftmost char
        most significant), per calcFtabOff + ftabHi/ftabLo."""
        off = 0
        for c in codes:
            off = (off << 2) | int(c)
        return int(self.ftab_hi[off]), int(self.ftab_lo[off + 1])

    # -- backward search -------------------------------------------------
    def exact_range(self, codes: np.ndarray, use_ftab: bool = True
                    ) -> tuple[int, int]:
        """Backward-search the whole pattern; returns (top, bot).

        Consumes right-to-left.  If use_ftab and the pattern is long
        enough and N-free in its last ftabChars, jump-start via ftab.
        """
        idx = self.idx
        qlen = len(codes)
        pos = qlen
        top, bot = 0, idx.bwt_len
        fc = idx.ftab_chars
        if use_ftab and qlen >= fc and np.all(codes[qlen - fc:] < 4):
            top, bot = self.ftab_range(codes[qlen - fc:])
            pos = qlen - fc
        while pos > 0 and bot > top:
            pos -= 1
            c = int(codes[pos])
            if c > 3:
                return 0, 0
            top = self.lf(top, c)
            bot = self.lf(bot, c)
        return (top, bot) if bot > top else (0, 0)

    # -- offset resolution -------------------------------------------------
    def resolve_row(self, i: int) -> int:
        """Joined-text offset of the suffix at BWT row i
        (reportChaseOne walk-left, ebwt.h:2727-2746)."""
        idx = self.idx
        if self._sa_dense is not None:
            return int(self._sa_dense[i])
        mask = (1 << idx.off_rate) - 1
        jumps = 0
        while (i & mask) != 0 and i != idx.zoff:
            i = self.lf_row(i)
            jumps += 1
        if i == idx.zoff:
            return jumps
        return int(idx.offs[i >> idx.off_rate]) + jumps

    def joined_to_text_off(self, qlen: int, off: int, index_fw: bool = True
                           ) -> tuple[int, int, int] | None:
        """(refidx, refoff, reflen) or None if the hit spans fragments
        (joinedToTextOff, ebwt.h:2569-2629).  For the mirror index
        (index_fw=False) the fragment offset is flipped back into
        forward-text coordinates (ebwt.h:2607-2610)."""
        idx = self.idx
        starts = idx.rstarts[:, 0].astype(np.int64)
        elt = int(np.searchsorted(starts, off, side="right")) - 1
        upper = int(starts[elt + 1]) if elt + 1 < idx.nfrag else idx.length
        if off + qlen > upper:
            return None
        tidx = int(idx.rstarts[elt, 1])
        fragoff = off - int(starts[elt])
        if not index_fw:
            fraglen = upper - int(starts[elt])
            fragoff = fraglen - fragoff - 1 - (qlen - 1)
        textoff = fragoff + int(idx.rstarts[elt, 2])
        return tidx, textoff, int(idx.plen[tidx])
