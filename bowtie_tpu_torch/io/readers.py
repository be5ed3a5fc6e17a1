"""Read-input layer: FASTQ/FASTA/raw/tabbed/interleaved/command-line.

Re-design of bowtie's PatternSource hierarchy (pat.h:195-944).  The
reference uses a locked nextBatch + lock-free parse split to feed
dozens of threads; here the consumer is a single batched device
pipeline, so the reader is a simple generator of ReadRecord batches.

Formats (reference classes):
- FASTQ            FastqPatternSource    pat.h:672
- FASTA            FastaPatternSource    pat.h:459
- raw              RawPatternSource      pat.h:744
- cmdline (-c)     VectorPatternSource   pat.h:260
- FASTA continuous (-F k,i) FastaContinuousPatternSource pat.h:594
- tabbed (--12)    TabbedPatternSource   pat.h:536
- interleaved      FastqPatternSource(interleaved=true)
- paired -1/-2     DualPatternComposer   pat.cpp:134-229 (PairedReadSource)

Plain FASTQ files go through the native parser (native/fastio.cpp;
parse_fastq says when the pure-Python parser takes them), interleaved and
-1/-2 mates included.
"""
from __future__ import annotations

import bz2
import gzip
import io
import itertools
import sys
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..utils.alphabet import seq_to_codes, revcomp_codes
from ..utils.rng import gen_rand_seed


@dataclass
class ReadRecord:
    name: bytes
    seq: bytes            # ASCII, original (forward) orientation
    qual: bytes           # ASCII Phred+33 after conversion
    rdid: int = 0         # global read id
    mate: int = 0         # 0 = unpaired, 1/2 = mate
    orig: bytes = None    # raw input record (readOrigBuf, read.h:42) —
                          # captured only when dumps need it
    trimmed5: int = 0     # chars actually removed by -5 (read.h:42)
    trimmed3: int = 0     # chars actually removed by -3

    _codes_fw: np.ndarray = None
    _codes_rc: np.ndarray = None

    @property
    def codes_fw(self) -> np.ndarray:
        if self._codes_fw is None:
            self._codes_fw = seq_to_codes(self.seq)
        return self._codes_fw

    @property
    def codes_rc(self) -> np.ndarray:
        if self._codes_rc is None:
            self._codes_rc = revcomp_codes(self.codes_fw)
        return self._codes_rc

    _seed_cache: tuple = None

    def seed(self, global_seed: int) -> np.uint32:
        """Per-read RNG seed (genRandSeed, pat.cpp:21), cached."""
        if self._seed_cache is None or self._seed_cache[0] != global_seed:
            self._seed_cache = (global_seed, gen_rand_seed(
                self.codes_fw, self.qual, self.name, global_seed))
        return self._seed_cache[1]

    def __len__(self):
        return len(self.seq)


def _open(path: str):
    if path == "-":
        return io.BytesIO(sys.stdin.buffer.read())
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    return open(path, "rb")


def _apply_trim(seq: bytes, qual: bytes, trim5: int, trim3: int):
    """Returns (seq, qual, t5, t3) where t5/t3 are the amounts
    actually removed (Read.trimmed5/trimmed3, pat.cpp:620-622)."""
    if not (trim5 or trim3):
        return seq, qual, 0, 0
    t5 = min(trim5, len(seq))
    t3 = min(trim3, len(seq) - t5)
    end = len(seq) - t3
    return seq[t5:end], qual[t5:end], t5, t3


def _solexa_to_phred_table() -> np.ndarray:
    """Solexa-64 -> Phred mapping (qual.cpp solToPhred LUT semantics:
    phred = round(10*log10(10^(sol/10)+1)))."""
    sol = np.arange(-10, 256)
    ph = np.round(10.0 * np.log10(np.power(10.0, sol / 10.0) + 1.0))
    return np.clip(ph, 0, 255).astype(np.uint8)


_SOL2PHRED = _solexa_to_phred_table()


def convert_quals(qual: bytes, solexa: bool, phred64: bool,
                  integer_quals: bool) -> bytes:
    """Normalize qualities to Phred+33 (qual.h char conversions)."""
    if integer_quals:
        vals = [int(t) for t in qual.split()]
        arr = np.array(vals, dtype=np.int32)
        if solexa:
            arr = _SOL2PHRED[np.clip(arr, -10, 255) + 10].astype(np.int32)
        return (np.clip(arr, 0, 93) + 33).astype(np.uint8).tobytes()
    arr = np.frombuffer(qual, dtype=np.uint8).astype(np.int32)
    if solexa:
        arr = _SOL2PHRED[np.clip(arr - 64, -10, 255) + 10].astype(np.int32) + 33
    elif phred64:
        arr = arr - 64 + 33
    return np.clip(arr, 33, 126).astype(np.uint8).tobytes()


def _fix_mate_name(name: bytes, mate: int) -> bytes:
    """Append /1 or /2 unless already suffixed (Read::fixMateName,
    read.h:141-161).  Applied to every paired read whatever the input
    format: the per-read RNG seed derives from the fixed name."""
    sfx = b"/1" if mate == 1 else b"/2"
    return name if name[-2:] == sfx and len(name) >= 2 else name + sfx


def parse_fastq(path: str, keep_orig: bool = False, use_native: bool = True
                ) -> Iterator[tuple[bytes, bytes, bytes]]:
    """FASTQ records as (name, seq, qual), plus the raw 4-line record
    (readOrigBuf) when keep_orig is set.  A plain file is parsed by the
    native parser (native/fastio.cpp) unless use_native is False; the
    pure-Python parser takes compressed input, stdin, keep_orig (it keeps
    the raw records) and a file the native parser stops short in, as
    bowtie_tpu/io/readers.py:130-155 does."""
    if (use_native and not keep_orig and path != "-"
            and not path.endswith((".gz", ".bz2"))):
        from ..native.fastq_native import parse_fastq_bytes
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.strip():
            _not_fastq()
        res = parse_fastq_bytes(buf)
        if res is not None:
            yield from zip(*res)
            return
    with _open(path) as f:
        first = True
        while True:
            l1 = f.readline()
            if not l1:
                if first:
                    _not_fastq()
                return
            first = False
            l1 = l1.rstrip()
            if not l1:
                continue
            seq_raw = f.readline()
            plus_raw = f.readline()
            qual_raw = f.readline()
            seq = seq_raw.rstrip()
            qual = qual_raw.rstrip()
            if keep_orig:
                # readOrigBuf: the 4 lines verbatim, '\n'-terminated
                # (EOF interpreted as a final newline, pat.cpp:825-829)
                orig = (l1 + b"\n" + seq + b"\n" + plus_raw.rstrip() +
                        b"\n" + qual + b"\n")
                yield l1[1:], seq, qual, orig
            else:
                yield l1[1:], seq, qual


def _not_fastq():
    """Match the reference on an empty reads file (FastqPatternSource
    first-char check, pat.cpp)."""
    print("Error: reads file does not look like a FASTQ file",
          file=sys.stderr)
    raise SystemExit(1)


def parse_fasta(path: str, default_qual: int = 40 + 33,
                keep_orig: bool = False, first_line_only: bool = False,
                ) -> Iterator[tuple[bytes, bytes, bytes]]:
    """FASTA reads: quality = 'I' (Phred 40) like bowtie's FASTA mode.
    With keep_orig, also yields the raw record bytes ('>' through the
    char before the next '>', verbatim — pat.cpp:555-562).

    first_line_only replicates the READS-side parser exactly: bowtie's
    FastaPatternSource::parse consumes sequence only up to the FIRST
    newline (pat.cpp:606-618) — multi-line FASTA reads are silently
    truncated to their first line.  The index builder and -F k,i use
    the full multi-line sequence (ref_read.cpp streams all lines)."""
    name, chunks, raw = None, [], []
    with _open(path) as f:
        for rawline in f:
            line = rawline.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    seq = b"".join(chunks)
                    if keep_orig:
                        yield (name, seq, bytes([default_qual]) * len(seq),
                               b"".join(raw))
                    else:
                        yield name, seq, bytes([default_qual]) * len(seq)
                name, chunks, raw = line[1:], [], [rawline]
            else:
                if name is not None:
                    raw.append(rawline)
                if line and not (first_line_only and chunks):
                    chunks.append(line)
        if name is not None:
            seq = b"".join(chunks)
            if keep_orig:
                yield (name, seq, bytes([default_qual]) * len(seq),
                       b"".join(raw))
            else:
                yield name, seq, bytes([default_qual]) * len(seq)


def parse_raw(path: str, start_id: int = 0, keep_orig: bool = False,
              ) -> Iterator[tuple[bytes, bytes, bytes]]:
    """One sequence per line; read name = ordinal (RawPatternSource)."""
    with _open(path) as f:
        for i, line in enumerate(f):
            seq = line.strip()
            if seq:
                if keep_orig:
                    yield (str(start_id + i).encode(), seq,
                           b"I" * len(seq), seq + b"\n")
                else:
                    yield str(start_id + i).encode(), seq, b"I" * len(seq)


def parse_fasta_continuous(path: str, length: int, freq: int,
                           keep_orig: bool = False,
                           ) -> Iterator[tuple[bytes, bytes, bytes]]:
    """-F k,i: k-mer-ize a genome: every freq-th k-mer of each sequence
    (FastaContinuousPatternSource, pat.h:594).  Read names are
    <seqname>_<offset>.  The raw record is name\\tseq with NO newline
    (pat.cpp:710-723)."""
    for name, seq, _ in parse_fasta(path):
        short = name.split()[0]
        for start in range(0, len(seq) - length + 1, freq):
            sub = seq[start:start + length]
            nm = b"%s_%d" % (short, start)
            if keep_orig:
                yield nm, sub, b"I" * length, nm + b"\t" + sub
            else:
                yield nm, sub, b"I" * length


def parse_tabbed(path: str, keep_orig: bool = False) -> Iterator[tuple]:
    """--12 format: name\\tseq\\tqual (unpaired) or
    name\\tseq1\\tqual1\\tseq2\\tqual2 (paired).  With keep_orig the
    raw line (both mates) is appended: the reference's onePairFile dump
    writes it whole (hit.h:388-396)."""
    with _open(path) as f:
        for line in f:
            parts = line.rstrip(b"\n").split(b"\t")
            if len(parts) >= 5:
                out = (parts[0], parts[1], parts[2], parts[3], parts[4])
            elif len(parts) >= 3:
                out = (parts[0], parts[1], parts[2])
            else:
                continue
            yield out + (line.rstrip(b"\n") + b"\n",) if keep_orig else out


class ReadSource:
    """Unified read source mirroring PatternComposer semantics: assigns
    global read ids, applies trimming/qual conversion, yields device-
    sized batches."""

    def __init__(self, paths: list[str], fmt: str = "fastq",
                 trim5: int = 0, trim3: int = 0,
                 solexa: bool = False, phred64: bool = False,
                 integer_quals: bool = False,
                 upto: int | None = None, skip: int = 0,
                 cmdline_seqs: list[str] | None = None,
                 cont_params: tuple[int, int] | None = None,
                 keep_orig: bool = False):
        self.paths = paths
        self.fmt = fmt
        self.trim5, self.trim3 = trim5, trim3
        self.solexa, self.phred64 = solexa, phred64
        self.integer_quals = integer_quals
        self.upto, self.skip = upto, skip
        self.cmdline_seqs = cmdline_seqs
        self.cont_params = cont_params
        self.keep_orig = keep_orig

    def _records_raw(self) -> Iterator[tuple]:
        ko = self.keep_orig
        if self.fmt == "cmdline":
            for i, s in enumerate(self.cmdline_seqs or []):
                # -c accepts seq or seq:quals (VectorPatternSource
                # tokenizes on ':', pat.cpp:366-380)
                seq, _, q = s.partition(":")
                seq = seq.encode()
                q = q.encode() if q else b"I" * len(seq)
                nm = str(i).encode()
                if ko:
                    # raw record: ordinal\tseq\tquals, no newline
                    yield nm, seq, q, nm + b"\t" + seq + b"\t" + q
                else:
                    yield nm, seq, q
            return
        for path in self.paths:
            if self.fmt == "fastq":
                # integer quals are numbers separated by spaces, whose
                # byte length is not the sequence's: the native parser's
                # layout does not hold for them
                yield from parse_fastq(path, keep_orig=ko,
                                       use_native=not self.integer_quals)
            elif self.fmt == "fasta":
                yield from parse_fasta(path, keep_orig=ko,
                                       first_line_only=True)
            elif self.fmt == "raw":
                yield from parse_raw(path, keep_orig=ko)
            elif self.fmt == "fasta_cont":
                k, i = self.cont_params
                yield from parse_fasta_continuous(path, k, i,
                                                  keep_orig=ko)
            else:
                raise ValueError(f"unknown format {self.fmt}")

    def records(self) -> Iterator[ReadRecord]:
        it = self._records_raw()
        it = itertools.islice(it, self.skip,
                              None if self.upto is None
                              else self.skip + self.upto)
        for rdid, rec in enumerate(it):
            name, seq, qual = rec[:3]
            orig = rec[3] if len(rec) > 3 else None
            # convert BEFORE trimming: integer quals are a space-
            # separated string whose element count, not byte count,
            # must line up with the sequence
            qual = convert_quals(qual, self.solexa, self.phred64,
                                 self.integer_quals)
            seq, qual, t5, t3 = _apply_trim(seq, qual, self.trim5,
                                            self.trim3)
            if len(qual) < len(seq):   # pad like bowtie tolerates
                qual = qual + b"I" * (len(seq) - len(qual))
            yield ReadRecord(name=name, seq=seq, qual=qual[:len(seq)],
                             rdid=rdid, orig=orig,
                             trimmed5=t5, trimmed3=t3)

    def batches(self, batch_size: int) -> Iterator[list[ReadRecord]]:
        batch: list[ReadRecord] = []
        for rec in self.records():
            batch.append(rec)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


class PairedReadSource:
    """DualPatternComposer analog: parallel _1/_2 files (pat.cpp:134-229).
    Yields (mate1, mate2) ReadRecord pairs; also --12 tabbed files, whose
    unpaired records come as (read, None), and interleaved FASTQ."""

    def __init__(self, paths1, paths2, fmt="fastq", interleaved=False,
                 tabbed=False, upto=None, skip=0, keep_orig=False, **kw):
        self.paths1, self.paths2 = paths1, paths2
        self.fmt, self.interleaved, self.tabbed = fmt, interleaved, tabbed
        self.upto, self.skip = upto, skip
        self.keep_orig = keep_orig
        self.kw = kw

    def pairs(self) -> Iterator[tuple]:
        yield from itertools.islice(
            self._pairs_raw(), self.skip,
            None if self.upto is None else self.skip + self.upto)

    def _pairs_raw(self) -> Iterator[tuple]:
        ko = self.keep_orig
        if self.tabbed:
            rdid = 0
            for path in self.paths1:
                for parts in parse_tabbed(path, keep_orig=ko):
                    orig = parts[-1] if ko else None
                    if ko:
                        parts = parts[:-1]
                    if len(parts) == 5:
                        nm, s1, q1, s2, q2 = parts
                        # onePairFile: the whole raw line rides on mate 1
                        # (hit.h:388-396 dumps bufa only)
                        yield (self._mk(nm, s1, q1, rdid, 1, orig),
                               self._mk(nm, s2, q2, rdid, 2))
                    else:
                        # --12 files mix paired (5-column) and unpaired
                        # (3-column) records (TabbedPatternSource::parse,
                        # pat.cpp:1017-1100); a solo read keeps its name
                        nm, s1, q1 = parts
                        yield self._mk(nm, s1, q1, rdid, 0, orig), None
                    rdid += 1
            return
        if self.interleaved:
            rdid = 0
            for path in self.paths1:
                it = parse_fastq(
                    path, keep_orig=ko,
                    use_native=not self.kw.get("integer_quals", False))
                for r1, r2 in zip(it, it):
                    yield (self._mk(r1[0], r1[1], r1[2], rdid, 1,
                                    r1[3] if ko else None),
                           self._mk(r2[0], r2[1], r2[2], rdid, 2,
                                    r2[3] if ko else None))
                    rdid += 1
            return
        src1 = ReadSource(self.paths1, self.fmt, keep_orig=ko, **self.kw)
        src2 = ReadSource(self.paths2, self.fmt, keep_orig=ko, **self.kw)
        for r1, r2 in zip(src1.records(), src2.records()):
            r1.mate, r2.mate = 1, 2
            r1.name = _fix_mate_name(r1.name, 1)
            r2.name = _fix_mate_name(r2.name, 2)
            r2.rdid = r1.rdid
            yield r1, r2

    def _mk(self, name, seq, qual, rdid, mate, orig=None) -> ReadRecord:
        qual = convert_quals(qual, self.kw.get("solexa", False),
                             self.kw.get("phred64", False),
                             self.kw.get("integer_quals", False))
        seq, qual, t5, t3 = _apply_trim(seq, qual, self.kw.get("trim5", 0),
                                        self.kw.get("trim3", 0))
        if len(qual) < len(seq):
            qual = qual + b"I" * (len(seq) - len(qual))
        if mate:
            name = _fix_mate_name(name, mate)
        return ReadRecord(name=name, seq=seq, qual=qual[:len(seq)],
                          rdid=rdid, mate=mate, orig=orig, trimmed5=t5,
                          trimmed3=t3)

    def batches(self, batch_size: int):
        batch = []
        for pair in self.pairs():
            batch.append(pair)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch
