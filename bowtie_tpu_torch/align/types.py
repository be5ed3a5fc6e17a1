"""Alignment result record (the reference's Hit, hit.h:56-112, minus
the C++ plumbing)."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..io.readers import ReadRecord


@dataclass
class Hit:
    read: ReadRecord
    fw: bool                  # aligned to forward strand?
    tidx: int                 # reference index
    toff: int                 # 0-based reference offset
    oms: int                  # # other hits in range (bot-top-1)
    stratum: int = 0          # # mismatches in seed/whole read
    cost: int = 0             # stratum<<14 | qual penalty
    # mismatches: positions are 5'-relative indices into the READ
    # (hit.h mms FixedBitset semantics) with the reference char seen
    mms: list = field(default_factory=list)   # [(pos, ref_char_ascii)]
    # paired-end
    mate: int = 0             # 0 unpaired, 1, 2
    mfw: bool = True          # mate's strand
    mtidx: int = 0
    mtoff: int = 0
    mlen: int = 0

    @property
    def length(self) -> int:
        return len(self.read.seq)

    def aligned_seq(self) -> bytes:
        """SEQ in reference orientation (rc of read if minus-strand)."""
        if self.fw:
            return self.read.seq
        from ..utils.alphabet import codes_to_seq
        return codes_to_seq(self.read.codes_rc).encode()

    def aligned_quals(self) -> bytes:
        return self.read.qual if self.fw else self.read.qual[::-1]
