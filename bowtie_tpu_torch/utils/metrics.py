"""Alignment metrics (--stats): the AlignerMetrics analog
(aligner_metrics.h:20-76): per-read search effort and read entropy with
Knuth running mean/variance.  A copy of bowtie_tpu/utils/metrics.py."""
from __future__ import annotations

import math
import sys
import time
from collections import Counter


class RunningStat:
    """Knuth online mean/stddev (aligner_metrics.h RunningStat)."""

    def __init__(self):
        self.n = 0
        self.m = 0.0
        self.s = 0.0

    def push(self, x: float):
        self.n += 1
        if self.n == 1:
            self.m, self.s = x, 0.0
        else:
            old_m = self.m
            self.m += (x - old_m) / self.n
            self.s += (x - old_m) * (x - self.m)

    def mean(self):
        return self.m if self.n else 0.0

    def stddev(self):
        return math.sqrt(self.s / (self.n - 1)) if self.n > 1 else 0.0


class AlignerMetrics:
    def __init__(self):
        self.t0 = time.time()
        self.reads = 0
        self.aligned = 0
        self.failed = 0
        self.maxed = 0
        self.hits = 0
        self.strata = Counter()
        self.entropy = RunningStat()
        self.read_len = RunningStat()

    def next_read(self, codes):
        self.reads += 1
        self.read_len.push(len(codes))
        # per-read base entropy (aligner_metrics.h:76 analog)
        if len(codes):
            c = Counter(int(x) for x in codes)
            n = len(codes)
            h = -sum((v / n) * math.log2(v / n) for v in c.values())
            self.entropy.push(h)

    def record_result(self, res):
        if res.maxed:
            self.maxed += 1
        elif res.hits:
            self.aligned += 1
            self.hits += len(res.hits)
            for h in res.hits:
                self.strata[h.stratum] += 1
        else:
            self.failed += 1

    def print(self, out=None, fallbacks: int | None = None):
        out = out or sys.stderr
        dt = time.time() - self.t0
        w = out.write
        w("AlignerMetrics:\n")
        w(f"  wall time: {dt:.2f}s ({self.reads/max(dt,1e-9):.0f} "
          f"reads/s)\n")
        w(f"  reads: {self.reads}  aligned: {self.aligned}  "
          f"failed: {self.failed}  maxed: {self.maxed}\n")
        if fallbacks is not None:
            w(f"  device-pool overflow fallbacks: {fallbacks} "
              f"({100.0 * fallbacks / max(1, self.reads):.3f}% of "
              f"reads re-run on the host oracle)\n")
        w(f"  alignments reported: {self.hits}\n")
        w(f"  read length: mean {self.read_len.mean():.1f} "
          f"sd {self.read_len.stddev():.2f}\n")
        w(f"  read entropy (bits/base): mean {self.entropy.mean():.3f} "
          f"sd {self.entropy.stddev():.3f}\n")
        for s in sorted(self.strata):
            w(f"  stratum {s}: {self.strata[s]} alignments\n")
