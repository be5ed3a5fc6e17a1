"""bowtie-inspect equivalent (bowtie_inspect.cpp:1-533): decode an
index back to FASTA, print names or a summary.  Host numpy only."""
from __future__ import annotations

import sys

import numpy as np

from ..index.ebwt_io import (EbwtIndex, read_bitpair_reference, read_ebwt,
                             unpack_reference)
from ..utils.alphabet import codes_to_seq


def restore_via_lf(idx: EbwtIndex) -> np.ndarray:
    """Rebuild the joined text purely from the BWT by LF-walking
    (Ebwt::restore, ebwt.h:2763-2781; the `-e` path).  The LF of every
    row is computed at once — fchr[c] + Occ(c, row) from the occ
    checkpoints plus the count within the row's block, with the '$'-as-'A'
    correction of align/golden.py's rank — then the chain, which is
    sequential, is followed in a loop."""
    bwt = idx.bwt.astype(np.int64)
    n1 = len(bwt)
    B = idx.OCC_BLOCK
    occ = idx.occ_checkpoints().astype(np.int64)
    nb = (n1 + B - 1) // B
    blk = np.zeros(nb * B, dtype=np.int64)
    blk[:n1] = bwt
    blk = blk.reshape(nb, B)
    within = np.zeros((nb, B), dtype=np.int64)   # own char, earlier in block
    for c in range(4):
        m = blk == c
        within[m] = (np.cumsum(m, axis=1) - m)[m]
    rows = np.arange(n1)
    lf = (idx.fchr.astype(np.int64)[bwt] + occ[rows // B, bwt]
          + within.reshape(-1)[:n1])
    # '$' is stored as an 'A' at zoff: A-rows after it count one too many
    lf[(bwt == 0) & (rows > idx.zoff)] -= 1
    n = idx.length
    out = np.zeros(n, dtype=np.uint8)
    lf_l = lf.tolist()
    bwt_l = bwt.tolist()
    i = n
    for pos in range(n - 1, -1, -1):
        out[pos] = bwt_l[i]
        i = lf_l[i]
    assert i == idx.zoff
    return out


def inspect(basename: str, names_only: bool = False,
            summary: bool = False, across: int = 60,
            use_ebwt: bool = False, extra: bool = False, out=None):
    out = out or sys.stdout
    idx = read_ebwt(basename, load_offs=False)
    if names_only:
        for n in idx.refnames:
            out.write(n + "\n")
        return
    if summary:
        # print_index_summary (bowtie_inspect.cpp:352-404); the Flags
        # lines appear only with --extra
        if extra:
            rev = read_ebwt(basename + ".rev", load_offs=False)
            out.write(f"Flags\t{idx.flags}\n")
            out.write(f"Reverse flags\t{rev.flags}\n")
            er = rev.entire_reverse
            out.write(f"Concat then reverse\t{1 if er else 0}\n")
            out.write(f"Reverse then concat\t{0 if er else 1}\n")
            recs, _ = read_bitpair_reference(basename)
            # numRefs counts first-records; a ref is non-gap iff its
            # first record has len > 0 (reference.h:148-176)
            num_refs = sum(1 for r in recs if r[2])
            non_gap = sum(1 for r in recs if r[2] and r[1] > 0)
            out.write(f"nPat\t{idx.npat}\n")
            out.write(f"refnames.size()\t{len(idx.refnames)}\n")
            out.write(f"refs.numRefs()\t{num_refs}\n")
            out.write(f"refs.numNonGapRefs()\t{non_gap}\n")
        out.write(f"SA-Sample\t1 in {1 << idx.off_rate}\n")
        out.write(f"FTab-Chars\t{idx.ftab_chars}\n")
        for i, n in enumerate(idx.refnames):
            out.write(f"Sequence-{i + 1}\t{n}\t{idx.plen[i]}\n")
        if extra:
            out.write("RefRecords:\n")
            for off, ln, first in recs:
                out.write(f"{1 if first else 0}\t({off}, {ln})\n")
        return
    if use_ebwt:
        # split the joined text back into per-reference sequences with N
        # gaps restored, using rstarts/plen
        seqs = _joined_to_refs(idx, restore_via_lf(idx))
    else:
        recs, packed = read_bitpair_reference(basename)
        seqs = unpack_reference(recs, packed, plen=idx.plen)
    for i, codes in enumerate(seqs):
        name = idx.refnames[i] if i < len(idx.refnames) else str(i)
        out.write(f">{name}\n")
        s = codes_to_seq(codes)
        for j in range(0, len(s), across):
            out.write(s[j:j + across] + "\n")


def _joined_to_refs(idx: EbwtIndex, joined: np.ndarray):
    """Per-reference code arrays (N = 4 outside the fragments) from the
    joined text."""
    seqs = [np.full(int(idx.plen[ridx]), 4, dtype=np.uint8)
            for ridx in range(idx.npat)]
    starts = idx.rstarts
    for f in range(idx.nfrag):
        joff, ridx, roff = (int(starts[f, 0]), int(starts[f, 1]),
                            int(starts[f, 2]))
        end = int(starts[f + 1, 0]) if f + 1 < idx.nfrag else idx.length
        seqs[ridx][roff:roff + (end - joff)] = joined[joff:end]
    return seqs
