"""Kernel diagnostics: a machine launch's per-lane transitions, and
ptxas's report of a kernel.

K7 (csrc/dfs.cu) writes each lane's transitions into `steps`; a warp
runs as long as its longest lane, and a launch at least as long as its
slowest lane's chain of transitions.  `lane_stats` says how far those
two set the launch's time: chip_smoke.py phase dfs and
scripts/k7_bench.py print it beside the kernel's time.
"""
from __future__ import annotations

import numpy as np

WARP = 32


def lane_stats(steps, warp: int = WARP) -> dict:
    """steps: per-lane transitions, lane b on thread b of the launch
    (warp b // warp).  -> max, p50, p99 and mean transitions; the warp
    efficiency, sum of lane transitions / sum over warps of warp x the
    warp's max (1.0: every lane of a warp as long as its longest; a
    last, partial warp counts whole); the slowest lane and its warp's
    first lane; and a histogram of lanes by transitions, keyed by each
    bucket's least count (0, 1, 2, 4, 8, ...)."""
    s = np.asarray(steps, dtype=np.int64).ravel()
    if s.size == 0:
        return dict(lanes=0, max=0, p50=0.0, p99=0.0, mean=0.0, total=0,
                    warp_efficiency=1.0, slowest_lane=-1, slowest_warp=-1,
                    histogram={})
    if (s < 0).any():
        raise ValueError("negative transition count")
    pad = (-s.size) % warp
    wmax = np.concatenate([s, np.zeros(pad, np.int64)]).reshape(
        -1, warp).max(1)
    busy = warp * int(wmax.sum())
    slow = int(s.argmax())
    # bucket k >= 1 holds [2^(k-1), 2^k); bucket 0 the lanes with none
    bucket = np.where(s > 0, np.floor(np.log2(np.maximum(s, 1))) + 1, 0)
    keys, counts = np.unique(bucket.astype(np.int64), return_counts=True)
    hist = {str(0 if k == 0 else 1 << (int(k) - 1)): int(c)
            for k, c in zip(keys, counts)}
    return dict(lanes=int(s.size), max=int(s.max()),
                p50=float(np.percentile(s, 50)),
                p99=float(np.percentile(s, 99)), mean=float(s.mean()),
                total=int(s.sum()),
                warp_efficiency=float(s.sum() / busy) if busy else 1.0,
                slowest_lane=slow, slowest_warp=slow - slow % warp,
                histogram=hist)


def ptxas_entry(report: str, name: str) -> list:
    """The lines of ptxas's -v report (kernels.build keeps it in
    csrc/build/ptxas.txt) about each kernel whose mangled name holds
    `name`: its entry line, stack frame and spills, registers."""
    out, keep = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line or "bytes gmem" in line:
            keep = name in line
        if keep and line.strip():
            out.append(line.strip())
    return out
