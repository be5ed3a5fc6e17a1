"""Reporting policy: -k / -a / -m / -M semantics on host.

Mirrors NGoodHitSinkPerThread (hit.h:937-992) + finishRead
(hit.h:741-787): hits stream in (fw strand first, search_exact.c order);
counting continues past -k when -m is set; exceeding -m marks the read
"maxed" and suppresses output.  -M sampling (hit.cpp:44-66) is not
ported yet: `finish` takes the reference's arguments (the read seed is
what -M samples with) and its ReadResult carries `sampled` (always False
here) and `nbuffered`, so results compare field for field with
bowtie_tpu/align/policy.py's.
"""
from __future__ import annotations

from dataclasses import dataclass

INF = 0xFFFFFFFF


@dataclass
class AlignStats:
    """End-of-run summary counters (HitSink::finish, hit.h:270-346)."""
    processed: int = 0
    aligned: int = 0
    failed: int = 0
    maxed: int = 0
    reported: int = 0          # alignments


@dataclass
class ReadResult:
    hits: list            # reported hits (possibly empty)
    maxed: bool = False   # exceeded -m
    nvalid: int = 0       # total valid hits counted (for XM of maxed)
    sampled: bool = False  # -M sampling applied (-M is not ported yet)
    nbuffered: int = 0    # buffered hits at finish (xms for -M records)


class KPolicy:
    """First-n-good policy; span strata (plain -v/-n modes)."""

    def __init__(self, khits: int = 1, mhits: int = INF):
        self.n = khits
        self.max = mhits

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
            return ReadResult([], maxed=True, nvalid=count,
                              nbuffered=len(buffered))
        return ReadResult(buffered[: self.n], nvalid=count,
                          nbuffered=len(buffered))
