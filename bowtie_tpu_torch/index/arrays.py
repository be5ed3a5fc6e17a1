"""Device-resident FM-index arrays for the CUDA kernels.

Instead of bowtie's 64-byte interleaved "sides" (ebwt.h:164-180) we keep:

- ``bwt``     : words [(nblocks+1)*8] -- 2-bit codes, 16 per word, low
                bit-pair first ('$' stored as code 0 at row ``zoff``),
                8 words (32 bytes) per 128-row checkpoint block
- ``occ``     : [nblocks+1, 4]        -- rank checkpoints every
                ``OCC_BLOCK`` (=128) rows, counting *stored* codes;
                one 16-byte row per block
- ``ftab_hi/ftab_lo`` : [ftabLen]     -- escape-resolved k-mer jump table
- ``offs``    : [offsLen]             -- SA sample (row % 2^offRate == 0)
- ``sa``      : [bwt_len] or None     -- optional dense SA

One rank query is then one 16-byte checkpoint row plus one aligned
32-byte word block (countUpTo's side scan, ebwt.h:1897).  Those arrays
hold uint32 values, which torch keeps as int32 bit patterns: the kernels
read them as ``uint32_t``, and the plain versions widen them to int64
with ``u32``.  Rows are int64 in torch and ``uint32_t`` in CUDA, which
covers the reference's small index up to 2^32-1 rows (TIndexOffU,
btypes.h).  The last block gets its 8 words even when bwt_len is a
multiple of 128, so rank(bwt_len) needs no bounds test.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .ebwt_io import EbwtIndex
from ..utils.device import resolve_device

OCC_BLOCK = 128            # rows per checkpoint
WORDS_PER_BLOCK = OCC_BLOCK // 16
U32 = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return t.long() & U32


def _as_i32(a: np.ndarray) -> np.ndarray:
    """uint32-valued array -> int32 bit patterns (torch has no usable
    uint32 tensor type for indexing and arithmetic)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


@dataclass
class FMIndexArrays:
    bwt: torch.Tensor       # int32 [(nblocks+1)*8]
    occ: torch.Tensor       # int32 [nblocks+1, 4]
    fchr: torch.Tensor      # int64 [5]
    ftab_hi: torch.Tensor   # int32 [ftabLen]
    ftab_lo: torch.Tensor   # int32 [ftabLen]
    offs: torch.Tensor      # int32 [offsLen]
    zoff: int
    bwt_len: int
    ftab_chars: int = 10
    off_rate: int = 5
    # dense SA (sa[row] = joined text offset of the suffix at BWT row):
    # offset resolution becomes one gather instead of a walk-left
    sa: torch.Tensor | None = None   # int32 [bwt_len]
    # the CUDA kernels' view of these arrays (kernels.fm_view)
    kernel_view: object = field(default=None, repr=False, compare=False)
    # the walk table K3 and K4 walk on (align/exact.py walk_table), built
    # at first use; it depends on bwt, occ and zoff only
    walk: torch.Tensor | None = field(default=None, repr=False,
                                      compare=False)

    @property
    def device(self) -> torch.device:
        return self.bwt.device

    def nbytes(self) -> int:
        """Bytes the index holds on its device."""
        ts = [self.bwt, self.occ, self.fchr, self.ftab_hi, self.ftab_lo,
              self.offs] + [t for t in (self.sa, self.walk) if t is not None]
        return sum(t.numel() * t.element_size() for t in ts)


def pack_bwt_words(bwt_codes: np.ndarray) -> np.ndarray:
    """uint8 codes -> flat uint32 words, 16 codes/word, low bit-pair
    first, padded to whole blocks plus one spare block."""
    n = len(bwt_codes)
    nblocks = (n + OCC_BLOCK - 1) // OCC_BLOCK
    nwords = (nblocks + 1) * WORDS_PER_BLOCK
    padded = np.zeros(nwords * 16, dtype=np.uint32)
    padded[:n] = bwt_codes
    lanes = padded.reshape(nwords, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (lanes << shifts).sum(axis=1, dtype=np.uint32)


def build_occ_checkpoints(bwt_codes: np.ndarray,
                          block: int = OCC_BLOCK) -> np.ndarray:
    """occ[k, c] = count of stored code c in rows [0, k*block), uint32."""
    n = len(bwt_codes)
    nblocks = (n + block - 1) // block
    pad = nblocks * block - n
    padded = np.pad(bwt_codes, (0, pad), constant_values=0)
    onehot = padded.reshape(nblocks, block, 1) == np.arange(4, dtype=np.uint8)
    per_block = onehot.sum(axis=1, dtype=np.int64)
    ck = np.zeros((nblocks + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=ck[1:])
    ck[-1, 0] -= pad  # padding zeros are not 'A's
    return ck.astype(np.uint32)


def build_dense_sa(idx: EbwtIndex, device) -> torch.Tensor:
    """sa[row] = joined-text offset of the suffix at BWT row, for every
    row, as int32 bit patterns on `device` — built by pointer doubling
    over the LF permutation from the 2^offRate-sampled offs[] (the batch
    equivalent of walk-left: reportChaseOne, ebwt.h:2727-2746, amortized
    over all rows at once).  Plain torch ops, ~log2(max walk) rounds of
    two gathers each."""
    n1 = idx.length + 1
    bwt = torch.from_numpy(idx.bwt).to(device)
    rows = torch.arange(n1, dtype=torch.int64, device=device)
    # LF at each row's own char: fchr[c] + rank(c, row)
    lf = torch.empty(n1, dtype=torch.int64, device=device)
    for c in range(4):
        mask = bwt == c
        cs = torch.cumsum(mask, 0)      # count in [0, i]
        lf[mask] = int(idx.fchr[c]) + cs[mask] - 1
    # '$' stored as 'A' at zoff: A-rows after it over-counted by one
    lf[(bwt == 0) & (rows > idx.zoff)] -= 1
    # pointer doubling toward marked rows (row % 2^offRate == 0 or zoff)
    marked = (rows & ((1 << idx.off_rate) - 1)) == 0
    marked[idx.zoff] = True
    ptr = torch.where(marked, rows, lf)
    dist = (~marked).long()
    for _ in range(33):   # 2^33 exceeds any possible walk length
        if bool(marked[ptr].all()):
            break
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
    if not bool(marked[ptr].all()):
        raise RuntimeError("dense SA: LF walks did not reach marked rows")
    offs = torch.from_numpy(idx.offs.astype(np.int64)).to(device)
    base_off = torch.where(ptr == idx.zoff, 0, offs[ptr >> idx.off_rate])
    return (base_off + dist).to(torch.int32)


def from_ebwt(idx: EbwtIndex, device=None,
              dense_sa: bool = False) -> FMIndexArrays:
    """Convert a parsed host index into device arrays on `device`
    (default CUDA).  dense_sa=True also builds the per-row SA (4 B/row)
    so offset resolution is one gather."""
    dev = resolve_device(device)
    if idx.bwt_len > U32:
        raise ValueError(f"index has {idx.bwt_len} rows; the port holds "
                         f"rows as uint32 (at most {U32})")
    hi, lo = idx.ftab_resolved()

    def put(a):
        return torch.from_numpy(_as_i32(a)).to(dev)

    return FMIndexArrays(
        bwt=put(pack_bwt_words(idx.bwt)),
        occ=put(build_occ_checkpoints(idx.bwt)),
        fchr=torch.from_numpy(idx.fchr.astype(np.int64)).to(dev),
        ftab_hi=put(hi),
        ftab_lo=put(lo),
        offs=put(idx.offs),
        zoff=int(idx.zoff),
        bwt_len=int(idx.bwt_len),
        ftab_chars=idx.ftab_chars,
        off_rate=idx.off_rate,
        sa=build_dense_sa(idx, dev) if dense_sa else None,
    )


def from_jax_arrays(d: dict[str, np.ndarray], meta: dict,
                    device=None) -> FMIndexArrays:
    """The reference package's FMIndexArrays fields (as numpy arrays,
    keyed by field name) -> the port's arrays on `device`, so one index
    can feed both packages.  `meta` holds the static fields
    (ftab_chars, off_rate, occ_every).  The reference's tile-exact
    [rows, 128] BWT matrix is flattened and cut (or zero-padded) to
    this layout's (nblocks+1)*8 words."""
    if meta.get("occ_every", OCC_BLOCK) != OCC_BLOCK:
        raise ValueError("only the 128-row checkpoint layout is ported")
    dev = resolve_device(device)
    bwt_len = int(d["bwt_len"])
    nblocks = (bwt_len + OCC_BLOCK - 1) // OCC_BLOCK
    nwords = (nblocks + 1) * WORDS_PER_BLOCK
    words = np.zeros(nwords, dtype=np.uint32)
    flat = np.asarray(d["bwt"]).reshape(-1).view(np.uint32)[:nwords]
    words[:len(flat)] = flat

    def put(a):
        return torch.from_numpy(
            _as_i32(np.asarray(a).astype(np.int64) & U32)).to(dev)

    sa = d.get("sa")
    return FMIndexArrays(
        bwt=put(words),
        occ=put(np.asarray(d["occ"])),
        fchr=torch.from_numpy(
            np.asarray(d["fchr"]).astype(np.int64) & U32).to(dev),
        ftab_hi=put(d["ftab_hi"]),
        ftab_lo=put(d["ftab_lo"]),
        offs=put(d["offs"]),
        zoff=int(np.asarray(d["zoff"]).astype(np.int64) & U32),
        bwt_len=bwt_len,
        ftab_chars=int(meta["ftab_chars"]),
        off_rate=int(meta["off_rate"]),
        sa=None if sa is None else put(sa),
    )
