"""Host-side reader/writer for Bowtie-1 `.ebwt` index files.

File format (reference: ebwt.h readIntoMemory 2835-3445 and
writeFromMemory 3602-3663, small-index variant, little-endian):

``.1.ebwt`` (primary)::

    u32  endianness sentinel (== 1)
    u32  len            # joined text length (excl. $)
    i32  lineRate       # 2^lineRate bytes per line (6 -> 64B sides)
    i32  linesPerSide   # 1
    i32  offRate        # SA sample: every 2^offRate rows marked
    i32  ftabChars      # chars consumed by one ftab lookup (10)
    i32  -flags         # negative; -flags & 4 -> "entire reverse" index
    u32  nPat; u32 plen[nPat]
    u32  nFrag; u32 rstarts[3*nFrag]   # (joined off, refidx, ref off)
    u8   ebwt[ebwtTotLen]              # the BWT in "sides" (see below)
    u32  zOff                          # BWT row holding $ (stored as 'A')
    u32  fchr[5]                       # cumulative char counts (F column)
    u32  ftab[(4^ftabChars)+1]
    u32  eftab[2*ftabChars]
    char refnames[...]                 # '\n'-separated, NUL-terminated

``.2.ebwt`` (secondary)::

    u32  endianness sentinel (== 1)
    u32  offs[ceil((len+1)/2^offRate)]  # SA sample for marked rows

Side layout (ebwt.h:164-180, 2281-2294 and SideLocus:1418-1523): the BWT
is chopped into alternating 64-byte "backward" (even) and "forward" (odd)
sides.  Each side is 56 bytes of 2-bit chars (224 bp) + two u32 occ
counters.  Forward sides store chars in ascending byte/bit-pair order;
backward sides store them fully reversed (byte 55-b, bit-pair 3-p).  The
counters after a backward side hold cumulative [A],[C] counts and the
ones after the forward side of the same pair hold [G],[T] counts, both
counting BWT rows [0, pairStart+224) ('$' counted as 'A').

We parse this format exactly; index/arrays.py then converts it to the
flat device layout (2-bit-packed BWT words plus occ checkpoints).
"""
from __future__ import annotations

import copy
import io
import os
from dataclasses import dataclass, field

import numpy as np

SIDE_SZ = 64           # bytes per side (lineRate=6, linesPerSide=1)
SIDE_BWT_SZ = 56       # BWT payload bytes per side
SIDE_BWT_LEN = 224     # BWT chars per side
OFF_MASK32 = 0xFFFFFFFF

# 256-entry LUT: byte -> 4 codes (low bit-pair first), used for unpacking
_BYTE_TO_CODES = np.zeros((256, 4), dtype=np.uint8)
for _b in range(256):
    for _j in range(4):
        _BYTE_TO_CODES[_b, _j] = (_b >> (2 * _j)) & 3


@dataclass
class EbwtIndex:
    """A fully parsed Bowtie-1 index, in flat numpy form (host memory)."""

    # header
    length: int               # text length (excl. $); bwt has length+1 rows
    line_rate: int
    lines_per_side: int
    off_rate: int
    ftab_chars: int
    entire_reverse: bool
    # text metadata
    npat: int
    plen: np.ndarray          # [nPat] reference sequence lengths
    nfrag: int
    rstarts: np.ndarray       # [nFrag, 3] (joined off, refidx, off in ref)
    refnames: list[str] = field(default_factory=list)
    # search structures
    flags: int = 1            # negated stored value (1 | 4 entire-rev)
    zoff: int = 0             # row of '$' in the BWT
    fchr: np.ndarray = None   # [5] cumulative counts; fchr[c] = rows < char c
    ftab: np.ndarray = None   # raw ftab (may hold eftab escapes)
    eftab: np.ndarray = None
    offs: np.ndarray = None   # SA sample
    # the BWT itself, one code (0..3) per row, '$' stored as 0 at zoff
    bwt: np.ndarray = None    # uint8 [length+1]
    off_size: int = 4         # 4 = .ebwt (32-bit), 8 = .ebwtl (64-bit)

    # --- derived, built lazily ---
    _ftab_hi: np.ndarray = None   # resolved ftabHi for every slot
    _ftab_lo: np.ndarray = None
    _occ: np.ndarray = None       # [nck, 4] uint32 checkpoints

    OCC_BLOCK = 128  # rows per occ checkpoint in the flat layout

    @property
    def bwt_len(self) -> int:
        return self.length + 1

    def with_off_rate(self, off_rate: int) -> "EbwtIndex":
        """A copy whose SA sample keeps every 2^(off_rate - off_rate of
        self)-th entry (the Ebwt constructor's offRate override,
        ebwt.h:438-441); self is not changed."""
        t = copy.copy(self)
        t.offs = self.offs[::1 << (off_rate - self.off_rate)].copy()
        t.off_rate = off_rate
        return t

    def occ_checkpoints(self) -> np.ndarray:
        """occ[k, c] = count of stored code c in bwt[0 : k*OCC_BLOCK),
        uint32 [nblocks+1, 4].  Counts are over *stored* codes, i.e. the
        '$' at row zoff counts as an 'A'; rank queries must correct for
        it (see align/golden.py)."""
        if self._occ is None:
            from .arrays import build_occ_checkpoints
            self._occ = build_occ_checkpoints(self.bwt, self.OCC_BLOCK)
        return self._occ

    # ------------------------------------------------------------------
    # derived structures
    # ------------------------------------------------------------------
    def ftab_resolved(self) -> tuple[np.ndarray, np.ndarray]:
        """Resolve ftab escapes into dense (hi, lo) arrays.

        ftabHi/ftabLo semantics from ebwt.h:985-1034: entries > len are
        escapes into eftab; hi = eftab[2e+1], lo = eftab[2e].
        Search uses top = hi[i], bot = lo[i+1] (ebwt_search_backtrack.h:256).
        """
        if self._ftab_hi is None:
            mask = np.uint64(0xFFFFFFFFFFFFFFFF) if self.off_size == 8 \
                else np.uint32(OFF_MASK32)
            # compared unsigned: the 64-bit escapes of a .ebwtl index are
            # negative as int64 (bowtie_tpu's copy reads them as ranges)
            ft = self.ftab.astype(np.uint64)
            esc = ft > np.uint64(self.length)
            eidx = (self.ftab ^ mask).astype(np.int64)
            hi = np.where(esc, self.eftab[np.where(esc, eidx * 2 + 1, 0)], ft)
            lo = np.where(esc, self.eftab[np.where(esc, eidx * 2, 0)], ft)
            self._ftab_hi = hi.astype(np.uint64)
            self._ftab_lo = lo.astype(np.uint64)
        return self._ftab_hi, self._ftab_lo


def _read_exact(f: io.BufferedReader, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"expected {n} bytes, got {len(b)}")
    return b


def side_geometry(off_size: int) -> tuple[int, int, int]:
    """(side bytes, payload bytes, payload chars).

    Small indexes: 64-byte sides (lineRate=6), 2x4-byte counters.
    Large (.ebwtl): 128-byte sides (lineRate=7), 2x8-byte counters.
    """
    side_sz = 64 if off_size == 4 else 128
    side_bwt_sz = side_sz - 2 * off_size
    return side_sz, side_bwt_sz, side_bwt_sz * 4


def _unpack_sides(ebwt_bytes: np.ndarray, bwt_len: int,
                  off_size: int = 4) -> np.ndarray:
    """Extract the linear BWT (one uint8 code per row) from side format."""
    ssz, sbs, sbl = side_geometry(off_size)
    n_sides = len(ebwt_bytes) // ssz
    sides = ebwt_bytes.reshape(n_sides, ssz)
    payload = sides[:, :sbs]
    codes = _BYTE_TO_CODES[payload].reshape(n_sides, sbl)
    # even sides are "backward": chars stored fully reversed
    codes[0::2] = codes[0::2, ::-1]
    return codes.reshape(-1)[:bwt_len].copy()


def index_paths(basename: str) -> tuple[str, str, int]:
    """Resolve (.1, .2, off_size) — small `.ebwt` or large `.ebwtl`
    (the -l / BOWTIE_64BIT_INDEX variant, btypes.h)."""
    if os.path.exists(basename + ".1.ebwt"):
        return basename + ".1.ebwt", basename + ".2.ebwt", 4
    if os.path.exists(basename + ".1.ebwtl"):
        return basename + ".1.ebwtl", basename + ".2.ebwtl", 8
    # default to small-index naming for error messages
    return basename + ".1.ebwt", basename + ".2.ebwt", 4


def read_ebwt(basename: str, load_offs: bool = True) -> EbwtIndex:
    """Read a bowtie index (`.ebwt` small / `.ebwtl` large) into an
    EbwtIndex.  Mirrors Ebwt::readIntoMemory (ebwt.h:2835);
    little-endian only."""
    f1path, f2path, osz = index_paths(basename)
    side_sz, side_bwt_sz, _ = side_geometry(osz)
    with open(f1path, "rb") as f:
        sentinel = np.frombuffer(_read_exact(f, 4), dtype="<u4")[0]
        # endianness sentinel (ebwt.h:2923-2937): a byteswapped 1 means
        # the file was written big-endian; swap every numeric read
        if sentinel == 1:
            bo = "<"
        elif sentinel == 0x01000000:
            bo = ">"
        else:
            raise ValueError(f"{f1path}: bad endianness sentinel "
                             f"{sentinel:#x}")
        U = bo + ("u4" if osz == 4 else "u8")
        length = int(np.frombuffer(_read_exact(f, osz), dtype=U)[0])
        line_rate, lines_per_side, off_rate, ftab_chars, neg_flags = (
            int(x) for x in
            np.frombuffer(_read_exact(f, 20), dtype=bo + "i4"))
        flags = -neg_flags
        entire_reverse = bool(flags > 0 and (flags & 4))

        if (1 << line_rate) != side_sz or lines_per_side != 1:
            raise ValueError(f"unsupported side geometry lineRate={line_rate}")

        npat = int(np.frombuffer(_read_exact(f, osz), dtype=U)[0])
        plen = np.frombuffer(_read_exact(f, osz * npat), dtype=U).copy()
        nfrag = int(np.frombuffer(_read_exact(f, osz), dtype=U)[0])
        rstarts = np.frombuffer(
            _read_exact(f, 3 * osz * nfrag), dtype=U).reshape(nfrag, 3).copy()

        bwt_sz = length // 4 + 1
        n_side_pairs = (bwt_sz + 2 * side_bwt_sz - 1) // (2 * side_bwt_sz)
        ebwt_tot = n_side_pairs * 2 * side_sz
        ebwt_bytes = np.frombuffer(_read_exact(f, ebwt_tot), dtype=np.uint8)

        zoff = int(np.frombuffer(_read_exact(f, osz), dtype=U)[0])
        fchr = np.frombuffer(_read_exact(f, 5 * osz), dtype=U).copy()
        ftab_len = (1 << (2 * ftab_chars)) + 1
        ftab = np.frombuffer(_read_exact(f, osz * ftab_len), dtype=U).copy()
        eftab_len = 2 * ftab_chars
        eftab = np.frombuffer(_read_exact(f, osz * eftab_len), dtype=U).copy()

        refnames: list[str] = []
        tail = f.read()
        if tail:
            names = tail.split(b"\x00", 1)[0]
            refnames = [s.decode() for s in names.split(b"\n") if s]

    offs = None
    if load_offs:
        with open(f2path, "rb") as f:
            sentinel = np.frombuffer(_read_exact(f, 4), dtype="<u4")[0]
            if sentinel not in (1, 0x01000000):
                raise ValueError(f"{f2path}: bad endianness sentinel")
            U2 = ("<" if sentinel == 1 else ">") + \
                ("u4" if osz == 4 else "u8")
            offs_len = ((length + 1) + (1 << off_rate) - 1) >> off_rate
            offs = np.frombuffer(
                _read_exact(f, osz * offs_len), dtype=U2).copy()

    if bo == ">":   # normalize to native little-endian arrays
        nat = "u4" if osz == 4 else "u8"
        plen = plen.astype(nat)
        rstarts = rstarts.astype(nat)
        fchr = fchr.astype(nat)
        ftab = ftab.astype(nat)
        eftab = eftab.astype(nat)
        if offs is not None:
            offs = offs.astype(nat)

    bwt = _unpack_sides(ebwt_bytes, length + 1, osz)

    return EbwtIndex(
        length=length, line_rate=int(line_rate),
        lines_per_side=int(lines_per_side), off_rate=int(off_rate),
        ftab_chars=int(ftab_chars), entire_reverse=entire_reverse,
        flags=flags,
        npat=npat, plen=plen, nfrag=nfrag, rstarts=rstarts,
        refnames=refnames, zoff=zoff, fchr=fchr, ftab=ftab, eftab=eftab,
        offs=offs, bwt=bwt, off_size=osz,
    )


def read_embedded_occ(basename: str) -> np.ndarray:
    """Parse the per-side-pair occ counters embedded in `.1.ebwt`.

    Returns [nPairs, 4] counts of (A,C,G,T) in BWT rows [0, 224 + p*448)
    — used only for cross-checking recomputed checkpoints against
    bowtie-build's own counters (sanityCheckUpToSide, ebwt.h:1583).
    """
    idx = read_ebwt(basename, load_offs=False)
    with open(basename + ".1.ebwt", "rb") as f:
        data = f.read()
    # recompute where ebwt[] starts in the file
    hdr = 4 + 4 + 20 + 4 + 4 * idx.npat + 4 + 12 * idx.nfrag
    bwt_sz = idx.length // 4 + 1
    n_pairs = (bwt_sz + 2 * SIDE_BWT_SZ - 1) // (2 * SIDE_BWT_SZ)
    raw = np.frombuffer(data[hdr:hdr + n_pairs * 128], dtype=np.uint8)
    sides = raw.reshape(n_pairs * 2, SIDE_SZ)
    cnts = sides[:, SIDE_BWT_SZ:].copy().view("<u4")  # [2P, 2]
    out = np.zeros((n_pairs, 4), dtype=np.uint32)
    out[:, 0:2] = cnts[0::2]   # A, C after backward sides
    out[:, 2:4] = cnts[1::2]   # G, T after forward sides
    return out


def read_bitpair_reference(basename: str):
    """Read `<basename>.3.ebwt` (RefRecords) + `.4.ebwt` (packed bases),
    or `.3.ebwtl`/`.4.ebwtl` beside a large index, whose record fields
    are 64-bit.

    Format: reference.h:110-130 + ref_read.h RefRecord::write.
    Returns (records, packed) where records is a list of
    (off, len, first) runs and packed is the uint8 array of 2-bit
    bases, 4 per byte, low bit-pair first, 8-bit aligned per stretch
    boundary is NOT applied (bowtie packs contiguously; cumsz is
    per-stretch-rounded only for colorspace — plain DNA is contiguous).
    bowtie_tpu's reader opens `.3.ebwt` only, so it finds no reference
    beside an `.ebwtl` index (ROADMAP, queue 3); bowtie reads `.3.ebwtl`.
    """
    ext, osz = ".ebwt", 4
    if (not os.path.exists(basename + ".3.ebwt")
            and os.path.exists(basename + ".3.ebwtl")):
        ext, osz = ".ebwtl", 8
    with open(basename + ".3" + ext, "rb") as f:
        sentinel = np.frombuffer(_read_exact(f, 4), dtype="<u4")[0]
        if sentinel == 1:
            bo = "<"
        elif sentinel == 0x01000000:
            bo = ">"
        else:
            raise ValueError(f"bad sentinel in .3{ext}")
        U = bo + ("u4" if osz == 4 else "u8")
        sz = int(np.frombuffer(_read_exact(f, osz), dtype=U)[0])
        records = []
        for _ in range(sz):
            off, ln = np.frombuffer(_read_exact(f, 2 * osz), dtype=U)
            first = _read_exact(f, 1)[0] != 0
            records.append((int(off), int(ln), first))
    with open(basename + ".4" + ext, "rb") as f:
        packed = np.frombuffer(f.read(), dtype=np.uint8)
    return records, packed


def unpack_reference(records, packed, plen=None) -> list[np.ndarray]:
    """Expand (records, packed) into per-reference code arrays with Ns (=4).

    Mirrors BitPairReference::getBase (reference.h:386-416): each
    record contributes `off` leading ambiguous chars then `len`
    unambiguous 2-bit chars taken contiguously from the packed buffer.
    Zero-length records (trailing gaps, demoted all-ambiguous
    sequences) contribute nothing to any reference's length
    (reference.h:194-197: cumlen skips them).  With `plen` (the .1
    header lengths) each reference is N-padded out to its full plen —
    the getStretch view, which reads N past the stored stretches.
    """
    all_codes = _BYTE_TO_CODES[packed].reshape(-1)
    refs: list[np.ndarray] = []
    cur: list[np.ndarray] = []
    started = False
    buf_off = 0
    for off, ln, first in records:
        if first:
            if started:
                refs.append(np.concatenate(cur) if cur else
                            np.zeros(0, dtype=np.uint8))
            cur = []
            started = True
        if ln:
            if off:
                cur.append(np.full(off, 4, dtype=np.uint8))
            cur.append(all_codes[buf_off:buf_off + ln])
            buf_off += ln
    if started:
        refs.append(np.concatenate(cur) if cur else
                    np.zeros(0, dtype=np.uint8))
    if plen is not None:
        refs = [np.concatenate([r, np.full(int(pl) - len(r), 4,
                                           dtype=np.uint8)])
                if len(r) < int(pl) else r
                for r, pl in zip(refs, plen)]
    return refs
