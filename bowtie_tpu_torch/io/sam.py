"""SAM output matching the reference byte-for-byte (sam.cpp:20-257).

Headers: @HD/@SQ/@RG/@PG.  Records: FLAG per mate/strand, POS 1-based,
MAPQ (--mapq, default 255), CIGAR always `<len>M` (ungapped aligner),
MD/NM from the mismatch list, XA:i:<stratum>, XM:i for maxed reads.
"""
from __future__ import annotations

from typing import IO

from ..align.types import Hit
from ..io.readers import ReadRecord

FLAG_PAIRED = 1
FLAG_MAPPED_PAIRED = 2
FLAG_UNMAPPED = 4
FLAG_MATE_UNMAPPED = 8
FLAG_QUERY_STRAND = 16
FLAG_MATE_STRAND = 32
FLAG_FIRST_IN_PAIR = 64
FLAG_SECOND_IN_PAIR = 128

VERSION = "1.3.1-tpu-torch0.1"


def _trunc_name(name: bytes, is_mate: bool, no_trunc: bool) -> bytes:
    if is_mate:
        name = name[:-2] if len(name) >= 2 else name
    if no_trunc:
        return name
    for i, ch in enumerate(name):
        if ch in b" \t\n\v\f\r":
            return name[:i]
    return name


def _ref_display(refname: str, full_ref: bool) -> str:
    return refname if full_ref else refname.split()[0] if refname else refname


class SamWriter:
    def __init__(self, out: IO[bytes], refnames: list[str], reflens,
                 mapq: int = 255, full_ref: bool = False,
                 no_qname_trunc: bool = False, sam_nohead: bool = False,
                 sam_nosq: bool = False, cmdline: str = "",
                 rgline: str | None = None, refidx: bool = False):
        self.out = out
        self.refnames = refnames
        self.mapq = mapq
        self.full_ref = full_ref
        self.no_qname_trunc = no_qname_trunc
        if not sam_nohead:
            self._headers(reflens, sam_nosq, cmdline, rgline)
        if refidx:
            # --refidx: records print reference INDICES while the @SQ
            # headers above keep the real names — the reference skips
            # name loading for the search (ebwt_search.cpp:1348
            # loadIntoMemory(-1, !noRefNames, ...)) but reads them
            # separately for header emission
            self.refnames = []

    def _headers(self, reflens, nosq, cmdline, rgline):
        w = self.out.write
        w(b"@HD\tVN:1.0\tSO:unsorted\n")
        if not nosq:
            for i, ln in enumerate(reflens):
                nm = (_ref_display(self.refnames[i], self.full_ref)
                      if i < len(self.refnames) else str(i))
                w(f"@SQ\tSN:{nm}\tLN:{ln}\n".encode())
        if rgline:
            w(f"@RG\t{rgline}\n".encode())
        w(f"@PG\tID:Bowtie\tVN:{VERSION}\tCL:\"{cmdline}\"\n".encode())

    # -- aligned record (SAMHitSink::append, sam.cpp:129) --------------
    def hit(self, h: Hit, xms: int = 0, mapq: int | None = None):
        name = _trunc_name(h.read.name, h.mate > 0, self.no_qname_trunc)
        flags = 0
        if h.mate == 1:
            flags |= FLAG_PAIRED | FLAG_FIRST_IN_PAIR | FLAG_MAPPED_PAIRED
        elif h.mate == 2:
            flags |= FLAG_PAIRED | FLAG_SECOND_IN_PAIR | FLAG_MAPPED_PAIRED
        if not h.fw:
            flags |= FLAG_QUERY_STRAND
        if h.mate > 0 and not h.mfw:
            flags |= FLAG_MATE_STRAND
        rname = (_ref_display(self.refnames[h.tidx], self.full_ref)
                 if h.tidx < len(self.refnames) else str(h.tidx))
        fields = [name.decode(), str(flags), rname, str(h.toff + 1),
                  str(self.mapq if mapq is None else mapq), f"{h.length}M"]
        if h.mate > 0:
            inslen = (-(h.toff - h.mtoff + h.length) if h.toff > h.mtoff
                      else h.mtoff - h.toff + h.mlen)
            fields += ["=", str(h.mtoff + 1), str(inslen)]
        else:
            fields += ["*", "0", "0"]
        fields.append(h.aligned_seq().decode())
        fields.append(h.aligned_quals().decode())
        fields.append(f"XA:i:{h.stratum}")
        fields.append("MD:Z:" + self._md(h))
        fields.append(f"NM:i:{len(h.mms)}")
        if xms > 0:
            fields.append(f"XM:i:{xms}")
        self.out.write(("\t".join(fields) + "\n").encode())

    def _md(self, h: Hit) -> str:
        """MD string: runs of matches between mismatched ref chars.
        Mismatch positions are 5'-relative; SAM wants reference order,
        so reverse iteration for minus-strand hits (sam.cpp:216-249)."""
        n = h.length
        mm = {pos: chr(ref).upper() for pos, ref in h.mms}
        order = range(n) if h.fw else range(n - 1, -1, -1)
        out, run = [], 0
        for i in order:
            if i in mm:
                out.append(f"{run}{mm[i]}")
                run = 0
            else:
                run += 1
        out.append(str(run))
        return "".join(out)

    # -- unaligned / maxed (SAMHitSink::reportUnOrMax, sam.cpp:56) -----
    def unaligned(self, read: ReadRecord, nhits: int = 0,
                  paired: bool = False, second: bool = False):
        name = _trunc_name(read.name, paired, self.no_qname_trunc)
        flags = FLAG_UNMAPPED
        if paired:
            flags |= (FLAG_PAIRED | FLAG_MATE_UNMAPPED |
                      (FLAG_SECOND_IN_PAIR if second else FLAG_FIRST_IN_PAIR))
        self.out.write(
            (f"{name.decode()}\t{flags}\t*\t0\t0\t*\t*\t0\t0\t"
             f"{read.seq.decode()}\t{read.qual.decode()}\t"
             f"XM:i:{nhits}\n").encode())
