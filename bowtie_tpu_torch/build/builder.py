"""bowtie-build equivalent: construct `.ebwt` index files, bit-exact.

Re-expresses Ebwt::buildToDisk (ebwt.h:3985-4388) + the ebwt_build.cpp
driver (302-484): FASTA -> RefRecords (.3/.4) -> joined text -> suffix
array -> BWT sides with embedded occ counters, fchr, ftab/eftab,
SA-sample offs -> .1/.2; then the mirror index over the per-fragment-
reversed text -> .rev.1/.rev.2.

Where the reference streams one SA element at a time through a packing
loop, everything here is vectorized numpy over the whole SA (built on
the host by SA-IS, or on the card by prefix doubling: build/sa.py), or,
on the bounded-memory route, streamed from ordered SA chunks
(build/blockwise.py, `build_one_streaming`).
"""
from __future__ import annotations

import numpy as np

from .sa import suffix_array
from ..index.ebwt_io import side_geometry
from ..io.readers import parse_fasta
from ..native.build import load_sais
from ..utils.alphabet import seq_to_codes

OFF_MASK32 = 0xFFFFFFFF
OFF_MASK64 = 0xFFFFFFFFFFFFFFFF


def _udt(off_size: int, byteorder: str = "<") -> str:
    """numpy dtype of one index offset: u4 (.ebwt) or u8 (.ebwtl)."""
    return byteorder + ("u4" if off_size == 4 else "u8")


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


def reverse_ref_records(src):
    """reverseRefRecords (ref_read.cpp:154-179): the record list of the
    entire-reversed text — gaps and runs swap order, (off,0)+(0,len)
    neighbors merge back into (off,len) records."""
    cur = []
    n = len(src)
    for i in range(n - 1, -1, -1):
        first = (i == n - 1) or bool(src[i + 1][2])
        off, ln = src[i][0], src[i][1]
        if ln:
            cur.append((0, ln, first))
            first = False
        if off:
            cur.append((off, 0, first))
    dst = []
    i = 0
    while i < len(cur):
        if i < len(cur) - 1 and cur[i][0] != 0 and not cur[i + 1][2]:
            dst.append((cur[i][0], cur[i + 1][1], cur[i][2]))
            i += 2
        else:
            dst.append(cur[i])
            i += 1
    return dst


def szs_rstarts(records, plen, npat: int, entire_reverse: bool,
                off_size: int = 4):
    """rstarts rows from a record list (szsToDisk, ebwt.h:582-611):
    one (joined off, seq id, fw off) row per len>0 record; for the
    entire-reversed mirror the sequence ids invert and offsets flip to
    forward coordinates.  A demoted all-ambiguous gap folded into the
    next record's off makes fwoff go NEGATIVE in the reference too —
    its release build just writes the unsigned wraparound
    (assert_leq at ebwt.h:602 is compiled out), so we wrap
    identically."""
    mask = (1 << (8 * off_size)) - 1
    rst = []
    seq = 0
    off = 0
    totlen = 0
    for r_off, r_len, first in records:
        if r_len == 0:
            continue
        if first:
            off = 0
            seq += 1
        off += r_off
        seqm1 = seq - 1
        fwoff = off
        if entire_reverse:
            seqm1 = npat - seqm1 - 1
            fwoff = (int(plen[seqm1]) - (off + r_len)) & mask
        rst.append((totlen, seqm1, fwoff))
        totlen += r_len
        off += r_len
    dt = np.uint32 if off_size == 4 else np.uint64
    return np.array(rst, dtype=dt).reshape(-1, 3)


def write_ref_files(basename: str, records, frags, large: bool = False,
                    byteorder: str = "<"):
    """Write `.3.ebwt(l)` (records) and `.4.ebwt(l)` (packed bases)."""
    ext = ".ebwtl" if large else ".ebwt"
    U = _udt(8 if large else 4, byteorder)
    with open(basename + ".3" + ext, "wb") as f:
        f.write(np.array([1], dtype=byteorder + "u4").tobytes())
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
    with open(basename + ".4" + ext, "wb") as f:
        f.write(packed.tobytes())


def _pack_sides(bwt: np.ndarray, occ_pairs: np.ndarray,
                off_size: int = 4) -> np.ndarray:
    """Pack the linear BWT (padding included) + per-pair occ counters
    into the alternating bw/fw side format (64-byte sides, 128-byte for
    .ebwtl)."""
    ssz, sbs, sbl = side_geometry(off_size)
    U = _udt(off_size)
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
        .reshape(-1, 2 * off_size)
    ctr[1::2] = occ_pairs[:, 2:4].astype(U).view(np.uint8) \
        .reshape(-1, 2 * off_size)
    return sides.reshape(-1)


def build_ftab(s: np.ndarray, sa: np.ndarray, ftab_chars: int,
               length: int, off_size: int = 4):
    """ftab/eftab per buildToDisk (ebwt.h:4146-4370)."""
    fc = ftab_chars
    ftab_len = (1 << (2 * fc)) + 1
    is_long = (length - sa) >= fc
    # word of each long suffix
    long_rows = np.flatnonzero(is_long)
    starts = sa[long_rows]
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
    return ftab_from_counts(cnt, ab, fc, off_size)


def ftab_from_counts(cnt, ab, fc, off_size: int = 4):
    """Prefix sums + eftab escape encoding (ebwt.h:4146-4370):
    hi_i = cumsum(cnt+ab)[i]; lo_i = hi_i - ab_i.  An escaped entry is
    its eftab slot XOR the all-ones offset."""
    esc_mask = OFF_MASK32 if off_size == 4 else OFF_MASK64
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
        ftab_u[i] = np.uint64(ecur) ^ np.uint64(esc_mask)
        ecur += 1
    if off_size == 4:
        return ftab_u.astype(np.uint32), eftab.astype(np.uint32)
    return ftab_u, eftab.astype(np.uint64)


def _write_header(f, length: int, off_rate: int, ftab_chars: int,
                  neg_flags: int, plen, rstarts, off_size: int) -> None:
    """`.1` from the sentinel through rstarts (always little-endian: the
    reference writes `.1/.2` in the host's order whatever --big says,
    ebwt.h:361)."""
    U = _udt(off_size)
    line_rate = 6 if off_size == 4 else 7
    f.write(np.array([1], dtype="<u4").tobytes())
    f.write(np.array([length], dtype=U).tobytes())
    f.write(np.array([line_rate, 1, off_rate, ftab_chars, neg_flags],
                     dtype="<i4").tobytes())
    f.write(np.array([len(plen)], dtype=U).tobytes())
    f.write(np.asarray(plen).astype(U).tobytes())
    f.write(np.array([len(rstarts)], dtype=U).tobytes())
    f.write(np.asarray(rstarts).astype(U).tobytes())


def _write_tail(f, zoff: int, s: np.ndarray, ftab, eftab, refnames,
                off_size: int) -> None:
    """`.1` from zoff to the end: zoff, fchr, ftab, eftab, names."""
    U = _udt(off_size)
    f.write(np.array([zoff], dtype=U).tobytes())
    # fchr: cumulative char counts of the text
    cc = np.bincount(s, minlength=4).astype(np.int64)
    fchr = np.zeros(5, dtype=np.int64)
    fchr[1:] = np.cumsum(cc)
    f.write(fchr.astype(U).tobytes())
    f.write(ftab.astype(U).tobytes())
    f.write(eftab.astype(U).tobytes())
    # each name is '\n'-terminated, then a final NUL
    f.write(b"".join(n.encode() + b"\n" for n in refnames) + b"\x00")


def build_one(s: np.ndarray, rstarts: np.ndarray, plen: np.ndarray,
              refnames: list[str], out1: str, out2: str,
              off_rate: int = 5, ftab_chars: int = 10,
              sa_fn=suffix_array, off_size: int = 4, neg_flags: int = -1):
    """Build and write one index (.1 + .2) from joined text `s`, its SA
    from `sa_fn` (SA-IS on the host, or build/sa.suffix_array_doubling
    on the card)."""
    length = len(s)
    sa = sa_fn(s)
    bwt_len = length + 1
    ssz, sbs, sbl = side_geometry(off_size)

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
    sides = _pack_sides(padded, occ_pairs, off_size)

    ftab, eftab = build_ftab(s, sa, ftab_chars, length, off_size)
    offs = sa[::1 << off_rate]

    with open(out1, "wb") as f:
        _write_header(f, length, off_rate, ftab_chars, neg_flags, plen,
                      rstarts, off_size)
        f.write(sides.tobytes())
        _write_tail(f, zoff, s, ftab, eftab, refnames, off_size)
    with open(out2, "wb") as f:
        f.write(np.array([1], dtype="<u4").tobytes())
        f.write(np.asarray(offs).astype(_udt(off_size)).tobytes())


def build_index(seqs, names, out_base: str, off_rate: int = 5,
                ftab_chars: int = 10, sa_fn=suffix_array,
                both: bool = True, large: bool = False,
                ntoa: bool = False, write_ref: bool = True,
                just_ref: bool = False, byteorder: str = "<",
                blockwise: bool = False, bmax: int | None = None,
                bmax_divn: int = 4, dcv: int = 1024,
                auto_mem: bool = True, new_reverse: bool = False):
    """Full bowtie-build: fw + mirror indexes + packed reference.

    seqs: list of uint8 code arrays (4 = ambiguous).
    large=True writes the 64-bit `.ebwtl` variant (BOWTIE_64BIT_INDEX).
    ntoa converts ambiguous chars to A before splitting into records
    (ebwt_build.cpp --ntoa); write_ref=False skips `.3/.4` (-r/--noref);
    just_ref=True writes ONLY `.3/.4` (-3/--justref); byteorder ">"
    emits a big-endian `.3` file, matching the reference's quirky --big
    semantics exactly: only the RefRecord emission honors the flag
    (ebwt_build.cpp:379-383) while `.1/.2` are always written in the
    host's native byte order (ebwt.h:361 uses currentlyBigEndian()).
    blockwise=True takes the bounded-memory route (build/blockwise.py)
    for texts of at least 4*dcv characters; it computes its own SA, so
    `sa_fn` is not called there.  A MemoryError of the in-memory route
    retries on it unless auto_mem is False (the autoMem ladder); a CUDA
    out-of-memory error of `sa_fn` is not a MemoryError and propagates.
    """
    ext = ".ebwtl" if large else ".ebwt"
    osz = 8 if large else 4
    if ntoa:
        seqs = [np.where(s > 3, 0, s).astype(np.uint8) for s in seqs]
    records, frags = fasta_to_records(seqs)
    if write_ref or just_ref:
        write_ref_files(out_base, records, frags, large=large,
                        byteorder=byteorder)
    if just_ref:
        return

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

    def one(text, o1, o2, force_blockwise, rst=rstarts, neg_flags=-1):
        if force_blockwise and len(text) >= 4 * dcv:
            from .blockwise import blockwise_sa_chunks
            bm = bmax if bmax is not None else \
                max(1 << 20, len(text) // max(bmax_divn, 1))
            build_one_streaming(
                blockwise_sa_chunks(text, bmax=bm, dcv=dcv),
                text, rst, plen, names, o1, o2,
                off_rate, ftab_chars, off_size=osz,
                neg_flags=neg_flags)
            return
        try:
            build_one(text, rst, plen, names, o1, o2,
                      off_rate, ftab_chars, sa_fn, off_size=osz,
                      neg_flags=neg_flags)
        except MemoryError:
            # autoMem ladder (ebwt.h:700-799 analog): retry with the
            # bounded-memory blockwise path
            if not auto_mem:
                raise
            one(text, o1, o2, True, rst=rst, neg_flags=neg_flags)

    one(joined, out_base + ".1" + ext, out_base + ".2" + ext,
        blockwise)
    if both and new_reverse:
        # --new-reverse: mirror over the ENTIRE reversed joined text
        # (REF_READ_REVERSE, ebwt.h:653-663) — reversed record list,
        # fw-coordinate rstarts with inverted sequence ids, and the
        # EBWT_ENTIRE_REV flag in the header
        rrec = reverse_ref_records(records)
        rst_rev = szs_rstarts(rrec, plen, len(plen), True, off_size=osz)
        one(joined[::-1].copy(), out_base + ".rev.1" + ext,
            out_base + ".rev.2" + ext, blockwise,
            rst=rst_rev, neg_flags=-5)
    elif both:
        # mirror: each fragment reversed in place (REF_READ_REVERSE_EACH)
        rev = np.concatenate([f[2][::-1] for f in frags]) if frags else \
            np.zeros(0, np.uint8)
        one(rev, out_base + ".rev.1" + ext,
            out_base + ".rev.2" + ext, blockwise)


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


def _pack_text_words(s: np.ndarray) -> np.ndarray:
    """Pack the 2-bit text into big-endian uint64 words (base j of word
    w occupies bits [62-2j, 64-2j)), padded with two trailing all-A
    words so any k-mer window (k<=32) can be read with two gathers: the
    streaming writer's BWT char and ftab word of a suffix then cost two
    adjacent-word reads instead of ftab_chars+1 byte gathers."""
    n = len(s)
    nwords = n // 32 + 2
    pad = np.zeros(nwords * 32, np.uint8)
    pad[:n] = s
    shifts = (2 * (31 - np.arange(32))).astype(np.uint64)[None, :]
    out = np.empty(nwords, np.uint64)
    step = 1 << 22
    for w0 in range(0, nwords, step):
        blk = pad[w0 * 32:(w0 + min(step, nwords - w0)) * 32]
        out[w0:w0 + len(blk) // 32] = (
            blk.reshape(-1, 32).astype(np.uint64) << shifts
        ).sum(axis=1, dtype=np.uint64)
    return out


def build_one_streaming(sa_chunks, s: np.ndarray, rstarts, plen,
                        refnames, out1: str, out2: str,
                        off_rate: int = 5, ftab_chars: int = 10,
                        off_size: int = 4, neg_flags: int = -1):
    """Streaming buildToDisk (ebwt.h:3985-4388 never holds the BWT or
    SA in memory either): consume ordered SA chunks from
    `blockwise.blockwise_sa_chunks`, emitting side pairs / SA sample /
    ftab counts on the fly.  Byte-identical output to `build_one`.  Each
    chunk's BWT chars and ftab words come from native/sais.cpp's
    `stream_extract` over the packed text."""
    length = len(s)
    ssz, sbs, sbl = side_geometry(off_size)
    U = _udt(off_size)
    fc = ftab_chars
    ftab_len = (1 << (2 * fc)) + 1

    with open(out1, "wb") as f1, open(out2, "wb") as f2:
        _write_header(f1, length, off_rate, ftab_chars, neg_flags, plen,
                      rstarts, off_size)
        f2.write(np.array([1], dtype="<u4").tobytes())

        pair_chars = 2 * sbl
        carry = np.zeros(0, np.uint8)          # unpacked BWT chars pending
        cum = np.zeros(4, np.int64)            # counts of emitted chars
        emitted = 0                            # chars emitted (pairs only)
        zoff = -1
        row0 = 0                               # global row of chunk start
        cnt = np.zeros(ftab_len, np.int64)
        ab = np.zeros(ftab_len, np.int64)
        pending_shorts = 0
        omask = (1 << off_rate) - 1

        def flush_pairs(buf):
            nonlocal carry, cum, emitted
            npairs = len(buf) // pair_chars
            if npairs == 0:
                carry = buf
                return
            take = buf[:npairs * pair_chars]
            carry = buf[npairs * pair_chars:]
            onehot = take.reshape(npairs, pair_chars, 1) == \
                np.arange(4, dtype=np.uint8)
            per_pair = onehot.sum(axis=1, dtype=np.int64)
            # occ at each pair's boundary: chars [0, emitted + p*2*sbl+sbl)
            half = take.reshape(npairs, 2, sbl)[:, 0]
            oh_half = half[:, :, None] == np.arange(4, dtype=np.uint8)
            half_cnt = oh_half.sum(axis=1, dtype=np.int64)
            cum_pairs = cum[None, :] + np.cumsum(per_pair, axis=0) \
                - per_pair + half_cnt
            bounds = emitted + np.arange(npairs, dtype=np.int64) \
                * pair_chars + sbl
            if zoff >= 0:
                cum_pairs[:, 0] -= (bounds > zoff)
            f1.write(_pack_sides(take, cum_pairs, off_size).tobytes())
            cum += per_pair.sum(axis=0)
            emitted += npairs * pair_chars

        packed = _pack_text_words(s)
        lib = load_sais()

        for chunk in sa_chunks:
            sa = np.ascontiguousarray(chunk, np.int64)
            rows = row0 + np.arange(len(sa), dtype=np.int64)
            z = np.flatnonzero(sa == 0)
            if len(z):
                zoff = int(rows[z[0]])
            # BWT chars and ftab k-mer words (-1 for short suffixes)
            word_all = np.empty(len(sa), np.int64)
            bwt = np.empty(len(sa), np.uint8)
            lib.stream_extract(packed.ctypes.data, sa.ctypes.data, len(sa),
                               length, fc, bwt.ctypes.data,
                               word_all.ctypes.data)
            flush_pairs(np.concatenate([carry, bwt]))
            # SA sample
            sel = (rows & omask) == 0
            if sel.any():
                f2.write(sa[sel].astype(U).tobytes())
            # ftab counts
            is_long = word_all >= 0
            long_i = np.flatnonzero(is_long)
            if len(long_i):
                word = word_all[long_i]
                cnt += np.bincount(word + 1, minlength=ftab_len)
                ab[word[0]] += pending_shorts
                pending_shorts = 0
                short_i = np.flatnonzero(~is_long)
                if len(short_i):
                    nxt = np.searchsorted(long_i, short_i, side="right")
                    inside = nxt < len(long_i)
                    np.add.at(ab,
                              word[np.minimum(nxt[inside],
                                              len(long_i) - 1)], 1)
                    pending_shorts += int((~inside).sum())
            else:
                pending_shorts += len(sa)
            row0 += len(sa)

        ab[ftab_len - 1] += pending_shorts
        # final padding to whole side pairs ('A's count toward occ)
        bwt_sz = length // 4 + 1
        n_pairs = (bwt_sz + 2 * sbs - 1) // (2 * sbs)
        tot_chars = n_pairs * pair_chars
        pad = tot_chars - row0
        assert row0 == length + 1
        flush_pairs(np.concatenate([carry, np.zeros(pad, np.uint8)]))
        assert len(carry) == 0 and emitted == tot_chars

        ftab, eftab = ftab_from_counts(cnt, ab, fc, off_size)
        _write_tail(f1, zoff, s, ftab, eftab, refnames, off_size)
