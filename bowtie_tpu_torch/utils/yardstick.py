"""The yardstick that chip_smoke.py and the benches in scripts/ share: the
H100's rates, the bound model of an FM-index kernel, and the seeded read
mix they time the kernels on.  It imports numpy only, so that a bench
can load it by path from its own tree whatever tree it measures.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM: 132 SMs at the 1.98 GHz boost clock (Hopper architecture white
# paper); per SM and clock, 64 results of 32-bit integer add, shift and
# bitwise logic and 16 of population count (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
POPC_OPS_PER_S = 132 * 16 * 1.98e9
# The least instructions of one rank Occ(c, i) (fm.cuh rank1, lf_walk),
# counted from the words the function needs, not from the kernels' masked
# scans.  For each word that holds rows of the block before i (an LF step
# of the search: ceil((i mod 128) / 16) of an occ block, ops.fm
# words_needed; a walk step: ceil((i mod 64) / 16) of a walk-table entry,
# ops.fm.walk_words_needed; summed by the plain versions): one LOP3 for
# the lane match ~(w ^ pattern), one shift, one LOP3 folding m & (m >> 1)
# with the lane mask, one add, and one popc.  Per rank, 9 more integer
# ops: 2 to split the row into block and offset, 3 for the partial word's
# lane mask, 2 for the '$' correction, 2 adds (checkpoint, fchr).  A walk
# step (mapLF) first takes its own code from the block: 2 more.
# Per-strand set-up (the ftab offset, the LCG draw) is left out, which
# only lowers the bound.
INT_OPS_PER_WORD = 4
INT_OPS_PER_RANK = 9
INT_OPS_PER_WALK_STEP = 2
L2_BYTES = 50 * 2**20          # H100 L2
SECTOR = 32
# sectors one step touches: an LF step of the search reads an occ row and
# a word block; a walk step one 32-byte walk-table entry (fm.cuh lf_walk)
SECTORS_PER_LF_STEP = 2
SECTORS_PER_WALK_STEP = 1


def bounds(nbytes: int, ranks: int, walk_steps: int, words: int,
           sectors: int) -> dict:
    """The least time the card could take: the larger of `nbytes` (each
    input read once, each output written once) over the HBM rate and the
    operations of `ranks` ranks (`walk_steps` of them walk steps) that
    popcount `words` words in all, each class over its own rate (the
    integer and popc pipes may issue side by side, so the larger of the
    two).  sector_ms is the other yardstick: every 32-byte sector the
    kernel touches, re-reads included, over the HBM rate."""
    int_ops = (INT_OPS_PER_WORD * words + INT_OPS_PER_RANK * ranks
               + INT_OPS_PER_WALK_STEP * walk_steps)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * max(int_ops / INT32_OPS_PER_S, words / POPC_OPS_PER_S)
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, int_ops=int_ops,
                popc_ops=words, ranks=ranks,
                sector_ms=1e3 * SECTOR * sectors / HBM_BYTES_PER_S)


# ---------------------------------------------------------------- reads

READ_LEN = 36
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
KINDS = ("exact", "repeat", "mismatch", "n", "short", "random")
KIND_P = (0.60, 0.10, 0.10, 0.05, 0.05, 0.10)


def make_reads(rng, genome, rep_starts, seg_len: int, n: int, p=KIND_P):
    """n reads of READ_LEN (shorter for kind "short"), each kind of KINDS
    drawn with its share in `p`: codes [n, L] left-aligned (pad 4), lens,
    kind index, genome offset, strand (1 = reverse complement)."""
    L = READ_LEN
    kind = rng.choice(len(KINDS), size=n, p=p)
    pos = rng.integers(0, len(genome) - L, n)
    rep = kind == KINDS.index("repeat")
    pos[rep] = (rep_starts[rng.integers(0, len(rep_starts), rep.sum())]
                + rng.integers(0, seg_len - L, rep.sum()))
    codes = genome[pos[:, None] + np.arange(L)]
    strand = rng.integers(0, 2, n)
    rc = strand == 1
    codes[rc] = COMP[codes[rc, ::-1]]
    rows = np.arange(n)
    mm = kind == KINDS.index("mismatch")
    col = rng.integers(0, L, n)
    codes[rows[mm], col[mm]] = (codes[rows[mm], col[mm]]
                                + rng.integers(1, 4, mm.sum())) % 4
    nk = kind == KINDS.index("n")
    codes[rows[nk], col[nk]] = 4
    rnd = kind == KINDS.index("random")
    codes[rnd] = rng.integers(0, 4, (rnd.sum(), L))
    lens = np.full(n, L, dtype=np.int32)
    sh = kind == KINDS.index("short")
    lens[sh] = rng.integers(5, 10, sh.sum())
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return codes, lens, kind, pos, strand


def strand_matrix(codes, lens):
    """Both strands right-aligned, fw block then rc block: the layout
    ExactAligner hands the kernels.  -> (mat [2n, L], lens [2n])."""
    n, L = codes.shape
    j = np.arange(L)[None, :] - (L - lens[:, None])       # source column
    valid = j >= 0
    jc = np.clip(j, 0, L - 1)
    fw = np.where(valid, np.take_along_axis(codes, jc, 1), 4)
    src_rc = np.clip(lens[:, None] - 1 - j, 0, L - 1)
    rc = np.where(valid, COMP[np.take_along_axis(codes, src_rc, 1)], 4)
    return (np.concatenate([fw, rc]).astype(np.uint8),
            np.concatenate([lens, lens]).astype(np.int32))
