"""-p/--threads for the host (pure-Python) engines.

A copy of bowtie_tpu/align/parallel_host.py.  The reference scales with
one OS thread per -p, each owning a full aligner object graph over the
shared read-only index (ebwt_search.cpp:1333-1484).  The card's engines
don't need this, since one batched pipeline owns the card, but the host
best-first engine is single-threaded Python, so -p maps to a fork-based
process pool over read batches: each worker inherits the aligner (and
its index tables) copy-on-write at fork time, aligns a contiguous slice,
and the parent reassembles results in read order, so output stays
byte-identical to -p 1.

The workers are forked, so they must never touch CUDA (a forked child
cannot use its parent's CUDA context).  The CLI wraps only the host
engines here (make_best_aligner / make_seeded_best_aligner), which run
on numpy arrays alone, never the card's aligners.
"""
from __future__ import annotations

import multiprocessing as mp
import os

# Set in the parent immediately before the pool forks; children inherit
# it copy-on-write, so the (large) dense FM tables are never pickled.
_WORKER_ALIGNER = None


def _worker(chunk):
    return _WORKER_ALIGNER.align_batch(chunk)


class ParallelHostAligner:
    """Wrap a host aligner's align_batch with a fork pool of `nprocs`."""

    def __init__(self, aligner, nprocs: int):
        global _WORKER_ALIGNER
        self.aligner = aligner
        self.nprocs = max(1, min(nprocs, os.cpu_count() or 1))
        self._pool = None
        if self.nprocs > 1 and hasattr(os, "fork"):
            _WORKER_ALIGNER = aligner
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(self.nprocs)

    def align_batch(self, batch):
        if self._pool is None or len(batch) < 2 * self.nprocs:
            return self.aligner.align_batch(batch)
        # ~4 chunks per worker for load balance (read costs vary a lot)
        nchunks = min(len(batch), self.nprocs * 4)
        size = -(-len(batch) // nchunks)
        chunks = [batch[i:i + size] for i in range(0, len(batch), size)]
        out = []
        for part in self._pool.map(_worker, chunks):
            out.extend(part)
        return out

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
