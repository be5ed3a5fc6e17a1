"""bowtie-build equivalent: construct `.ebwt` index files, bit-exact.

Re-expresses Ebwt::buildToDisk (ebwt.h:3985-4388) + the ebwt_build.cpp
driver (302-484): FASTA -> RefRecords (.3/.4) -> joined text -> suffix
array -> BWT sides with embedded occ counters, fchr, ftab/eftab,
SA-sample offs -> .1/.2; then the mirror index over the per-fragment-
reversed text -> .rev.1/.rev.2.

Where the reference streams one SA element at a time through a packing
loop, everything here is vectorized numpy over the whole SA (built on
the host by SA-IS, build/sa.py).  The bounded-memory blockwise route is
not ported yet.
"""
from __future__ import annotations

import numpy as np

from .sa import suffix_array
from ..index.ebwt_io import side_geometry
from ..io.readers import parse_fasta
from ..utils.alphabet import seq_to_codes

OFF_MASK32 = 0xFFFFFFFF
OFF_SIZE = 4          # small index: 32-bit offsets, 64-byte sides
U = "<u4"


def kept_pattern_indices(seqs: list[np.ndarray]) -> list[int]:
    """Indices of sequences that become patterns: the reference drops
    empty sequences entirely and demotes all-ambiguous ones to bare
    gap records with no name/plen entry (`rec.first && rec.len == 0 ->
    rec.first = false`, ebwt.h:3900; verified against bowtie-build
    1.3.1 output)."""
    return [i for i, s in enumerate(seqs)
            if len(s) and not bool((np.asarray(s) > 3).all())]


def fasta_to_records(seqs: list[np.ndarray]):
    """Split each sequence into RefRecords (off=gap, len=run, first)
    exactly like fastaRefReadSizes (ref_read.cpp:206): ambiguous chars
    become gaps between unambiguous stretches (trailing gaps emit a
    zero-length record).  Vectorized run-length scan (a per-character
    python loop would take hours at Gbp scale).

    Fragment refidx counts only kept patterns (see
    kept_pattern_indices): all-ambiguous sequences contribute a
    first=False gap record but no pattern."""
    records = []   # (off, len, first)
    frags = []     # (refidx, ref_off, codes) per unambiguous stretch
    pat = 0        # pattern index among kept sequences
    for codes in seqs:
        n = len(codes)
        if n == 0:
            continue
        amb = codes > 3
        if amb.all():
            # all-ambiguous: bare gap record, first demoted, no pattern
            records.append((n, 0, False))
            continue
        ridx = pat
        pat += 1
        # run boundaries: positions where ambiguity flips
        flips = np.flatnonzero(np.diff(amb.astype(np.int8))) + 1
        bounds = np.concatenate([[0], flips, [n]])
        first = True
        k = 0
        nb = len(bounds) - 1
        while k < nb:
            b0 = int(bounds[k])
            gap = 0
            if amb[b0]:
                gap = int(bounds[k + 1]) - b0
                k += 1
                if k >= nb:
                    # trailing gap: zero-length record (first demoted)
                    records.append((gap, 0, False))
                    break
                b0 = int(bounds[k])
            runlen = int(bounds[k + 1]) - b0
            records.append((gap, runlen, first))
            if runlen:
                frags.append((ridx, b0, codes[b0:b0 + runlen]))
            first = False
            k += 1
    return records, frags


def write_ref_files(basename: str, records, frags):
    """Write `.3.ebwt` (records) and `.4.ebwt` (packed bases)."""
    with open(basename + ".3.ebwt", "wb") as f:
        f.write(np.array([1], dtype=U).tobytes())
        f.write(np.array([len(records)], dtype=U).tobytes())
        for off, ln, first in records:
            f.write(np.array([off, ln], dtype=U).tobytes())
            f.write(bytes([1 if first else 0]))
    joined = np.concatenate([f[2] for f in frags]) if frags else \
        np.zeros(0, np.uint8)
    nbytes = (len(joined) + 3) // 4
    padded = np.zeros(nbytes * 4, dtype=np.uint8)
    padded[:len(joined)] = joined
    shifts = (2 * np.arange(4, dtype=np.uint32))[None, :]
    packed = (padded.reshape(-1, 4).astype(np.uint32) << shifts) \
        .sum(axis=1).astype(np.uint8)
    with open(basename + ".4.ebwt", "wb") as f:
        f.write(packed.tobytes())


def _pack_sides(bwt: np.ndarray, occ_pairs: np.ndarray) -> np.ndarray:
    """Pack the linear BWT (padding included) + per-pair occ counters
    into the alternating bw/fw 64-byte side format."""
    ssz, sbs, sbl = side_geometry(OFF_SIZE)
    n_sides = len(bwt) // sbl
    codes = bwt.reshape(n_sides, sbl).copy()
    codes[0::2] = codes[0::2, ::-1]      # backward sides fully reversed
    shifts = (2 * np.arange(4, dtype=np.uint32))[None, :]
    by = (codes.reshape(n_sides, sbs, 4).astype(np.uint32)
          << shifts[None]).sum(axis=2).astype(np.uint8)
    sides = np.zeros((n_sides, ssz), dtype=np.uint8)
    sides[:, :sbs] = by
    ctr = sides[:, sbs:]
    ctr[0::2] = occ_pairs[:, 0:2].astype(U).view(np.uint8) \
        .reshape(-1, 2 * OFF_SIZE)
    ctr[1::2] = occ_pairs[:, 2:4].astype(U).view(np.uint8) \
        .reshape(-1, 2 * OFF_SIZE)
    return sides.reshape(-1)


def build_ftab(s: np.ndarray, sa: np.ndarray, ftab_chars: int,
               length: int):
    """ftab/eftab per buildToDisk (ebwt.h:4146-4370)."""
    fc = ftab_chars
    ftab_len = (1 << (2 * fc)) + 1
    n_rows = len(sa)
    sa_elt = sa
    is_long = (length - sa_elt) >= fc
    # word of each long suffix
    long_rows = np.flatnonzero(is_long)
    starts = sa_elt[long_rows]
    word = np.zeros(len(long_rows), dtype=np.int64)
    for i in range(fc):
        word = (word << 2) | s[starts + i].astype(np.int64)
    cnt = np.zeros(ftab_len, dtype=np.int64)
    np.add.at(cnt, word + 1, 1)
    # absorb: each short suffix is absorbed at the next long suffix's
    # word; trailing shorts go to ftab_len-1
    ab = np.zeros(ftab_len, dtype=np.int64)
    short_rows = np.flatnonzero(~is_long)
    if len(short_rows):
        nxt = np.searchsorted(long_rows, short_rows, side="right")
        words_of_next = np.where(nxt < len(long_rows),
                                 word[np.minimum(nxt, len(long_rows) - 1)],
                                 ftab_len - 1)
        np.add.at(ab, words_of_next, 1)
    return ftab_from_counts(cnt, ab, fc)


def ftab_from_counts(cnt, ab, fc):
    """Prefix sums + eftab escape encoding (ebwt.h:4146-4370):
    hi_i = cumsum(cnt+ab)[i]; lo_i = hi_i - ab_i."""
    hi = np.cumsum(cnt + ab)
    lo = hi - ab
    ftab = lo.copy()
    ftab[0] = 0
    eftab = np.zeros(2 * fc, dtype=np.int64)
    ecur = 0
    ftab_u = ftab.astype(np.uint64)
    for i in np.flatnonzero(ab[1:]) + 1:
        eftab[ecur * 2] = lo[i]
        eftab[ecur * 2 + 1] = hi[i]
        ftab_u[i] = np.uint64(ecur) ^ np.uint64(OFF_MASK32)
        ecur += 1
    return ftab_u.astype(np.uint32), eftab.astype(np.uint32)


def build_one(s: np.ndarray, rstarts: np.ndarray, plen: np.ndarray,
              refnames: list[str], out1: str, out2: str,
              off_rate: int = 5, ftab_chars: int = 10):
    """Build and write one index (.1 + .2) from joined text `s`."""
    length = len(s)
    sa = suffix_array(s)
    bwt_len = length + 1
    ssz, sbs, sbl = side_geometry(OFF_SIZE)

    # BWT + zoff
    prev = sa - 1
    zoff = int(np.flatnonzero(sa == 0)[0])
    bwt = np.where(sa > 0, s[np.maximum(prev, 0)], 0).astype(np.uint8)

    # pad out to whole side pairs; padding 'A's count toward occ
    bwt_sz = length // 4 + 1
    n_pairs = (bwt_sz + 2 * sbs - 1) // (2 * sbs)
    tot_chars = n_pairs * 2 * sbl
    padded = np.zeros(tot_chars, dtype=np.uint8)
    padded[:bwt_len] = bwt

    # occ counters at pair boundaries: counts over rows
    # [0, sbl + p*2*sbl), '$' excluded, padding included
    onehot = padded.reshape(-1, sbl, 1) == np.arange(4, dtype=np.uint8)
    per_side = onehot.sum(axis=1, dtype=np.int64)       # [2P, 4]
    cum = np.cumsum(per_side, axis=0)
    occ_pairs = cum[0::2].copy()                        # after bw side
    boundaries = np.arange(n_pairs, dtype=np.int64) * 2 * sbl + sbl
    occ_pairs[:, 0] -= (boundaries > zoff)              # '$' not an A
    sides = _pack_sides(padded, occ_pairs)

    # fchr: cumulative char counts of the text
    cc = np.bincount(s, minlength=4).astype(np.int64)
    fchr = np.zeros(5, dtype=np.int64)
    fchr[1:] = np.cumsum(cc)

    ftab, eftab = build_ftab(s, sa, ftab_chars, length)

    offs = sa[::1 << off_rate]

    with open(out1, "wb") as f:
        f.write(np.array([1], dtype=U).tobytes())
        f.write(np.array([length], dtype=U).tobytes())
        # lineRate 6 (64-byte sides), 1 line per side, flags -1
        f.write(np.array([6, 1, off_rate, ftab_chars, -1],
                         dtype="<i4").tobytes())
        f.write(np.array([len(plen)], dtype=U).tobytes())
        f.write(np.asarray(plen).astype(U).tobytes())
        f.write(np.array([len(rstarts)], dtype=U).tobytes())
        f.write(np.asarray(rstarts).astype(U).tobytes())
        f.write(sides.tobytes())
        f.write(np.array([zoff], dtype=U).tobytes())
        f.write(fchr.astype(U).tobytes())
        f.write(ftab.astype(U).tobytes())
        f.write(eftab.astype(U).tobytes())
        # each name is '\n'-terminated, then a final NUL
        f.write(b"".join(n.encode() + b"\n" for n in refnames) + b"\x00")
    with open(out2, "wb") as f:
        f.write(np.array([1], dtype=U).tobytes())
        f.write(np.asarray(offs).astype(U).tobytes())


def build_index(seqs, names, out_base: str, off_rate: int = 5,
                ftab_chars: int = 10, blockwise: bool = False):
    """bowtie-build of the small (32-bit) index: fw + mirror `.1/.2`
    plus the packed reference `.3/.4`, little-endian.

    seqs: list of uint8 code arrays (4 = ambiguous).  The reference's
    other build options (-l large index, --ntoa, --noref, --justref,
    --big, --new-reverse) and the bounded-memory blockwise route are
    not ported yet.
    """
    if blockwise:
        raise NotImplementedError("blockwise build not yet ported")
    records, frags = fasta_to_records(seqs)
    write_ref_files(out_base, records, frags)

    # empty / all-ambiguous sequences are not patterns (no plen entry,
    # no name) — they survive only as gap records in `.3`
    kept = kept_pattern_indices(seqs)
    names = [names[i] for i in kept]
    plen = np.array([len(seqs[i]) for i in kept], dtype=np.uint32)
    # rstarts: (joined off, refidx, offset within ref) per fragment
    rstarts = []
    joined_off = 0
    for ridx, roff, codes in frags:
        rstarts.append((joined_off, ridx, roff))
        joined_off += len(codes)
    rstarts = np.array(rstarts, dtype=np.uint32).reshape(-1, 3)
    joined = np.concatenate([f[2] for f in frags]) if frags else \
        np.zeros(0, np.uint8)
    build_one(joined, rstarts, plen, names, out_base + ".1.ebwt",
              out_base + ".2.ebwt", off_rate, ftab_chars)
    # mirror: each fragment reversed in place (REF_READ_REVERSE_EACH)
    rev = np.concatenate([f[2][::-1] for f in frags]) if frags else \
        np.zeros(0, np.uint8)
    build_one(rev, rstarts, plen, names, out_base + ".rev.1.ebwt",
              out_base + ".rev.2.ebwt", off_rate, ftab_chars)


def build_from_fasta(fasta_paths: list[str], out_base: str, **kw):
    seqs, names = [], []
    pending = ""
    for p in fasta_paths:
        for name, seq, _q in parse_fasta(p):
            if len(seq) == 0:
                # a zero-length record's name concatenates onto the
                # next sequence's name (fastaRefReadAppend keeps
                # appending into the same name buffer when a record
                # has no bases; verified vs bowtie-build 1.3.1)
                pending += name.decode()
                continue
            names.append(pending + name.decode())
            pending = ""
            seqs.append(seq_to_codes(seq))
    build_index(seqs, names, out_base, **kw)
    return names
