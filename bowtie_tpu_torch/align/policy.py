"""Reporting policy: -k / -a / -m / -M semantics on host.

Mirrors NGoodHitSinkPerThread (hit.h:937-992) + finishRead
(hit.h:741-787): hits stream in (fw strand first, search_exact.c order);
counting continues past -k when -m is set; exceeding -m marks the read
"maxed" and suppresses output (or samples one hit with -M,
hit.cpp:44-66).  ReadResult carries `sampled` and `nbuffered`, so
results compare field for field with bowtie_tpu/align/policy.py's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.rng import BtRandom

INF = 0xFFFFFFFF


@dataclass
class AlignStats:
    """End-of-run summary counters (HitSink::finish, hit.h:270-346)."""
    processed: int = 0
    aligned: int = 0
    failed: int = 0
    maxed: int = 0
    reported: int = 0          # unpaired/singleton alignments
    reported_pairs: int = 0    # paired-end alignments (pairs)


@dataclass
class ReadResult:
    hits: list            # reported hits (possibly empty)
    maxed: bool = False   # exceeded -m
    nvalid: int = 0       # total valid hits counted (for XM of maxed)
    sampled: bool = False  # -M sampling applied
    nbuffered: int = 0    # buffered hits at finish (xms for -M records)
    # --reportse: held single-end mate alignments, reported when no
    # paired alignment landed (PairedBWAlignerV2 SE sinks)
    se_hits: list = field(default_factory=list)


class KPolicy:
    """First-n-good policy; span strata (plain -v/-n modes)."""

    def __init__(self, khits: int = 1, mhits: int = INF,
                 sample_max: bool = False):
        self.n = khits
        self.max = mhits
        self.sample_max = sample_max  # -M: on maxed, sample 1 hit

    def want_all_rows(self) -> bool:
        """Whether the search must enumerate every row of each range
        (needed when -k>1, -a or -m/-M is active)."""
        return self.n > 1 or self.max != INF

    def stop_after(self, count: int) -> tuple[bool, bool]:
        """(stop_searching, maxed) after `count` valid hits."""
        if count > self.max:
            return True, True
        if count == self.n and (self.max == INF or self.max < self.n):
            return True, False
        return False, False

    def finish(self, buffered: list, count: int, seed: int) -> ReadResult:
        """The read's result from its buffered hits, its count of valid
        hits and its per-read seed (which only -M sampling reads)."""
        if count > self.max:
            if self.sample_max and buffered:
                # -M: report 1 alignment sampled uniformly from the
                # first (best) stratum of the buffered list, fresh RNG
                # seeded with the read seed; record gets MAPQ 0 and
                # XM:i:<len(buffered)+1> (SAMHitSink::reportMaxed,
                # sam.cpp:263-312)
                rand = BtRandom(seed)
                num = 1
                while (num < len(buffered) and
                       buffered[num].stratum == buffered[0].stratum):
                    num += 1
                h = buffered[rand.next_u32() % num]
                return ReadResult([h], maxed=True, nvalid=count,
                                  sampled=True, nbuffered=len(buffered))
            return ReadResult([], maxed=True, nvalid=count,
                              nbuffered=len(buffered))
        return ReadResult(buffered[: self.n], nvalid=count,
                          nbuffered=len(buffered))
