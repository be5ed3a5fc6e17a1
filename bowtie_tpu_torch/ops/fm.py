"""FM-index primitives (K1): plain PyTorch versions of csrc/fm.cuh.

These are the batched form of bowtie's hot loop:
- rank1/rank4      <-> countUpTo / countUpToEx + countFw/BwSide
                       (ebwt.h:1897,1963,2034,2136) — checkpoint + 2-bit
                       popcounts over one 8-word block instead of a side scan
- lf / lf4         <-> mapLF / mapLFEx (ebwt.h:2334-2560)
- ftab_jump        <-> ftabHi/ftabLo dispatch (ebwt.h:971-1034)
- bwt_char         <-> rowL (ebwt.h:1696)

On the card these are the `__device__` functions of csrc/fm.cuh, inlined
into the exact-search and resolve kernels; they have no launch of their
own.  Here they compute the same values with torch ops on int64 rows of
any shape, step for step, for the CPU path and as the reference the
kernels are held to.  They replace bowtie_tpu/ops/fm.py:99 rank1,
:126 rank4, :148 lf, :153 lf4, :158 bwt_char, :173 lf_row_compact and
:197 ftab_jump.
"""
from __future__ import annotations

import torch

from ..index.arrays import (FMIndexArrays, OCC_BLOCK, WORDS_PER_BLOCK, U32,
                            u32)

# XOR patterns turning "word has code c in lane j" into 0b00 in lane j
# (analog of c_table, ebwt.h:55-60): c * 0x55555555
_CHAR_PATTERNS = (0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF)
_LANE_EVEN = 0x55555555


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of uint32 values held in int64 (SWAR, as __popc)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def _count_matches_in_word(word: torch.Tensor, c: torch.Tensor,
                           nlanes: torch.Tensor) -> torch.Tensor:
    """# of lanes j < nlanes of `word` equal to code c (nlanes in [0,16])."""
    pat = torch.tensor(_CHAR_PATTERNS, dtype=torch.int64,
                       device=word.device)[c]
    m = ~(word ^ pat) & U32          # lane matches iff both bits zero
    hits = m & (m >> 1) & _LANE_EVEN
    # low 2*nlanes bits; 0 for nlanes 0
    keep = torch.bitwise_left_shift(torch.ones_like(nlanes), 2 * nlanes) - 1
    return _popcount32(hits & keep)


def _block_words(fm: FMIndexArrays, block: torch.Tensor) -> torch.Tensor:
    """The 8 words of checkpoint block `block`: [..., 8] uint32 values."""
    return u32(fm.bwt.view(-1, WORDS_PER_BLOCK)[block])


def _nlanes(rem: torch.Tensor) -> torch.Tensor:
    """Lanes of each of the block's 8 words that lie before `rem`."""
    lane0 = 16 * torch.arange(WORDS_PER_BLOCK, device=rem.device)
    return (rem[..., None] - lane0).clamp(0, 16)


def words_needed(i: torch.Tensor) -> torch.Tensor:
    """Words of its block that a rank at row i must popcount: those
    holding rows [block start, i), ceil((i mod 128) / 16).  The kernels
    scan all 8 with masks; this is the least work, for bounds."""
    return (i % OCC_BLOCK + 15) // 16


def _rows(fm: FMIndexArrays, i) -> torch.Tensor:
    return torch.as_tensor(i, dtype=torch.int64, device=fm.device)


def rank1_plain(fm: FMIndexArrays, c, i) -> torch.Tensor:
    """Occ(c, i): occurrences of code c in BWT rows [0, i).

    '$' correction per countFwSide (ebwt.h:2044-2052): the '$' row is
    stored as code 0; subtract it from A-counts when i > zoff."""
    i = _rows(fm, i)
    c = torch.as_tensor(c, dtype=torch.int64, device=fm.device) \
        .expand_as(i)
    corr = ((c == 0) & (i > fm.zoff)).long()
    block = i // OCC_BLOCK
    rem = i - block * OCC_BLOCK
    base = u32(fm.occ[block]).gather(-1, c[..., None])[..., 0]
    words = _block_words(fm, block)
    cnt = _count_matches_in_word(words, c[..., None], _nlanes(rem)).sum(-1)
    return base + cnt - corr


def rank4_plain(fm: FMIndexArrays, i) -> torch.Tensor:
    """Occ(c, i) for all four codes at once (countUpToEx analog):
    [..., 4]."""
    i = _rows(fm, i)
    block = i // OCC_BLOCK
    rem = i - block * OCC_BLOCK
    base = u32(fm.occ[block])
    words = _block_words(fm, block)[..., None, :]            # [..., 1, 8]
    pat = torch.tensor(_CHAR_PATTERNS, dtype=torch.int64,
                       device=i.device)[:, None]              # [4, 1]
    m = ~(words ^ pat) & U32
    hits = m & (m >> 1) & _LANE_EVEN                          # [..., 4, 8]
    nl = _nlanes(rem)[..., None, :]
    keep = torch.bitwise_left_shift(torch.ones_like(nl), 2 * nl) - 1
    cnts = _popcount32(hits & keep).sum(-1)
    corr = torch.zeros_like(base)
    corr[..., 0] = (i > fm.zoff).long()
    return base + cnts - corr


def lf_plain(fm: FMIndexArrays, i, c) -> torch.Tensor:
    """LF step for search arrows: fchr[c] + Occ(c, i)."""
    c = torch.as_tensor(c, dtype=torch.int64, device=fm.device)
    return fm.fchr[c] + rank1_plain(fm, c, i)


def lf4_plain(fm: FMIndexArrays, i) -> torch.Tensor:
    """All-4-chars LF (mapLFEx): [..., 4] next rows."""
    return fm.fchr[:4] + rank4_plain(fm, i)


def lf4pair_plain(fm: FMIndexArrays, top, bot
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The quartets of both range ends (mapLFEx at top and at bot,
    ebwt.h:2334): ([..., 4], [..., 4]), as bowtie_tpu/align/
    dfs_device.py:303 _lf4pair computes them through :261 _rank4 (one
    checkpoint row and one word block per end, the '$' correction on
    the A count).  The DFS machine's kernel inlines it as fm.cuh
    lf4pair."""
    r = lf4_plain(fm, torch.stack([_rows(fm, top), _rows(fm, bot)]))
    return r[0], r[1]


def bwt_char_plain(fm: FMIndexArrays, i) -> torch.Tensor:
    """The stored BWT code at row i (rowL); row zoff reads as 0."""
    i = _rows(fm, i)
    word = u32(fm.bwt[i // 16])
    return (word >> (2 * (i % 16))) & 3


def lf_row_compact_plain(fm: FMIndexArrays, i) -> torch.Tensor:
    """mapLF(l): LF of row i by its own char, which is read from the
    same word block the rank scan needs — the walk-left step
    (reportChaseOne, ebwt.h:2727-2746).  Undefined at zoff."""
    i = _rows(fm, i)
    block = i // OCC_BLOCK
    rem = i - block * OCC_BLOCK
    words = _block_words(fm, block)
    w = words.gather(-1, (rem // 16)[..., None])[..., 0]
    c = (w >> (2 * (rem % 16))) & 3
    base = u32(fm.occ[block]).gather(-1, c[..., None])[..., 0]
    cnt = base + _count_matches_in_word(words, c[..., None],
                                        _nlanes(rem)).sum(-1)
    corr = ((c == 0) & (i > fm.zoff)).long()
    return fm.fchr[c] + cnt - corr


def ftab_jump_plain(fm: FMIndexArrays, codes) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(top, bot) from the ftabChars codes (leftmost most significant).

    codes: [..., ftab_chars], all < 4.
    top = ftabHi(off), bot = ftabLo(off+1)  (ebwt_search_backtrack.h:256)."""
    codes = torch.as_tensor(codes, dtype=torch.int64, device=fm.device)
    weights = 4 ** torch.arange(fm.ftab_chars - 1, -1, -1,
                                device=fm.device)
    off = (codes * weights).sum(-1)
    return u32(fm.ftab_hi[off]), u32(fm.ftab_lo[off + 1])
