"""Default bowtie 8-column output (VerboseHitSink::append, hit.cpp:72-280).

Columns: name, +/-, refname, offset(+offBase), aligned seq, aligned
quals, oms, mismatch descriptors `pos:REF>QRY,...`; optional --suppress
of 1-based columns, --cost appends stratum+cost, --showseed appends the
per-read seed, --partition emits Hadoop-style keyed records.
"""
from __future__ import annotations

from typing import IO

from ..align.types import Hit


def _hadoop_pad(v: int, padding: int) -> str:
    """Leading-zero pad exactly like hit.cpp:135-146: `padding` zeros
    minus one per digit of v — which prints one EXTRA zero when v == 0
    (the digit loop never runs), e.g. partition 0 is 11 chars wide."""
    s = str(v)
    return "0" * (padding - (len(s) if v > 0 else 0)) + s


class VerboseWriter:
    def __init__(self, out: IO[bytes], refnames: list[str],
                 off_base: int = 0, full_ref: bool = False,
                 suppress: set[int] | None = None, cost: bool = False,
                 show_seed: bool = False, partition: int = 0,
                 global_seed: int = 0):
        self.out = out
        self.refnames = refnames
        self.off_base = off_base
        self.full_ref = full_ref
        self.suppress = suppress or set()   # 1-based field numbers
        self.cost = cost
        self.show_seed = show_seed
        self.partition = partition
        self.global_seed = global_seed

    def _refname(self, tidx: int) -> str:
        if tidx < len(self.refnames):
            nm = self.refnames[tidx]
            return nm if self.full_ref else nm.split()[0]
        return str(tidx)

    def _mm_string(self, h: Hit, dash_if_empty: bool) -> str:
        parts = []
        seq = h.aligned_seq()
        n = h.length
        for pos, ref in sorted(h.mms):
            qry = seq[pos] if h.fw else seq[n - pos - 1]
            parts.append(f"{pos}:{chr(ref).upper()}>{chr(qry)}")
        if not parts and dash_if_empty:
            return "-"
        return ",".join(parts)

    def hit(self, h: Hit):
        fields: list[str] = []
        fld = iter(range(1, 32))
        if self.partition != 0:
            self._partition_hit(h)
            return

        def add(v: str):
            if next(fld) not in self.suppress:
                fields.append(v)

        add(h.read.name.decode())
        add("+" if h.fw else "-")
        add(self._refname(h.tidx))
        add(str(h.toff + self.off_base))
        add(h.aligned_seq().decode())
        add(h.aligned_quals().decode())
        add(str(h.oms))
        add(self._mm_string(h, dash_if_empty=False))
        if self.cost:
            add(str(h.stratum))
            add(str(h.cost))
        if self.show_seed:
            add(str(int(h.read.seed(self.global_seed))))
        self.out.write(("\t".join(fields) + "\n").encode())

    def _partition_hit(self, h: Hit):
        """--partition <P>: key records by (ref, bin); reads spilling
        over a bin boundary are emitted once per bin (hit.cpp:84-170)."""
        pospart = abs(self.partition)
        off = h.toff + self.off_base
        pdiv, pmod = divmod(off, pospart)
        spills = [0]
        if self.partition > 0:
            s = 1
            while pmod + h.length >= pospart * (s + 1):
                spills.append(s)
                s += 1
        for spill in spills:
            fields: list[str] = []
            fld = iter(range(1, 32))

            def add(v: str):
                if next(fld) not in self.suppress:
                    fields.append(v)

            add(self._refname(h.tidx))
            add(_hadoop_pad(pdiv + spill, 10))
            add(_hadoop_pad(off, 9))
            add("+" if h.fw else "-")
            add(h.aligned_seq().decode())
            add(h.aligned_quals().decode())
            add(str(h.oms))
            add(self._mm_string(h, dash_if_empty=True))
            add(str(int(h.mate)))
            add(self._label(h.read.name))
            self.out.write(("\t".join(fields) + "\n").encode())

    @staticmethod
    def _label(name: bytes) -> str:
        """Print LB:<label> from the read name if present (hit.cpp:252)."""
        s = name.decode()
        for i in range(len(s) - 3):
            if s[i:i + 3] == "LB:" and (i == 0 or s[i - 1] == ";"):
                rest = s[i + 3:]
                return rest.split(";")[0]
        return s
