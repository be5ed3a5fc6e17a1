"""End-to-end batched alignment driver (-v 0 exact mode).

The batched replacement for exactSearch + exactSearchWorker
(ebwt_search.cpp:1333-1484): instead of per-thread readers pulling one
read at a time, we stream device-sized read batches, run the batched
search kernel over fw+rc strands at once, resolve the needed BWT rows
on the device, and apply reporting policy + output on host in
deterministic read order (the single-stream analog of --reorder).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..index.arrays import FMIndexArrays, U32
from ..index.ebwt_io import EbwtIndex
from .exact import (exact_ranges, exact_ranges_plain, resolve_rows,
                    resolve_rows_plain, right_align)
from .policy import KPolicy, ReadResult
from .types import Hit
from ..utils.rng import fill_seed_caches, next_u32

_LCG_A = 1664525
_LCG_C = 1013904223


class JoinedResolver:
    """joinedToTextOff, vectorized on host (ebwt.h:2569-2629)."""

    def __init__(self, idx: EbwtIndex):
        self.starts = idx.rstarts[:, 0].astype(np.int64)
        self.tidxs = idx.rstarts[:, 1].astype(np.int64)
        self.toffs = idx.rstarts[:, 2].astype(np.int64)
        self.plen = idx.plen.astype(np.int64)
        self.length = idx.length

    def __call__(self, offs: np.ndarray, qlens: np.ndarray):
        """-> (tidx, textoff, valid). Hits spanning fragment ends are
        invalid (tidx == -1)."""
        elt = np.searchsorted(self.starts, offs, side="right") - 1
        upper = np.where(elt + 1 < len(self.starts),
                         self.starts[np.minimum(elt + 1,
                                                len(self.starts) - 1)],
                         self.length)
        valid = offs + qlens <= upper
        tidx = np.where(valid, self.tidxs[elt], -1)
        textoff = self.toffs[elt] + (offs - self.starts[elt])
        return tidx, textoff, valid


def one_row_plain(fm: FMIndexArrays, mat: torch.Tensor, lens: torch.Tensor,
                  seeds2: torch.Tensor, work: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Exact search, then the per-strand pick top + r % spread with the
    first RandomSource::nextU32 draw of the strand's seed, then resolve:
    [3, B] int64 (spread, offset, ok).  As
    bowtie_tpu/align/pipeline.py:53 computes it; `work` ([2, B], if
    given) accumulates each lane's LF and walk steps and popcounted
    words, as exact_ranges_plain and resolve_rows_plain count them."""
    top, bot = exact_ranges_plain(fm, mat, lens, work)
    s1 = (_LCG_A * seeds2.long() + _LCG_C) & U32
    s2 = (_LCG_A * s1 + _LCG_C) & U32
    r1 = (s1 >> 16) ^ s2                 # RandomSource::nextU32
    spread = bot - top
    row = top + r1 % spread.clamp(min=1)
    off, ok = resolve_rows_plain(fm, torch.where(spread > 0, row, 0), work)
    return torch.stack([spread, off, ok.long()])


def one_row(fm: FMIndexArrays, mat: torch.Tensor, lens: torch.Tensor,
            seeds2: torch.Tensor) -> torch.Tensor:
    """K4: fused exact search + random-row pick + row resolve, ONE
    launch for the k-hits-without-enumeration path (the row pick is
    reportFullAlignment's first RNG draw,
    ebwt_search_backtrack.h:1536-1540).  mat uint8 [B, L], lens int32
    [B], seeds2 int64 [B] -> int64 [3, B] (spread, offset, ok)."""
    if kernels.on_cpu(fm, mat, lens, seeds2):
        return one_row_plain(fm, mat, lens, seeds2)
    kernels.check(mat, "mat", torch.uint8, 2, fm.device)
    kernels.check(lens, "lens", torch.int32, 1, fm.device)
    kernels.check(seeds2, "seeds2", torch.int64, 1, fm.device)
    n, L = mat.shape
    if lens.shape[0] != n or seeds2.shape[0] != n:
        raise ValueError("mat, lens and seeds2 disagree on the batch size")
    out = torch.empty((3, n), dtype=torch.int64, device=fm.device)
    if n:
        kernels.launch("one_row", "bt_one_row", kernels.fm_view(fm),
                       mat.data_ptr(), lens.data_ptr(), seeds2.data_ptr(),
                       n, L, int(fm.sa is not None), out.data_ptr(),
                       device=fm.device)
    return out


class ExactAligner:
    """-v 0 aligner over a device-resident index."""

    def __init__(self, fm: FMIndexArrays, idx: EbwtIndex,
                 policy: KPolicy, nofw: bool = False, norc: bool = False,
                 global_seed: int = 0):
        self.fm = fm
        self.policy = policy
        self.nofw, self.norc = nofw, norc
        self.global_seed = global_seed
        self.joined = JoinedResolver(idx)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.fm.device)

    def align_batch(self, reads: list) -> list[ReadResult]:
        if not self.policy.want_all_rows():
            return self._align_batch_one_row(reads)
        return self._align_batch_enum(reads)

    def _align_batch_one_row(self, reads: list) -> list[ReadResult]:
        """Vectorized path when only one random row per range is
        chased (-k without -a/-m enumeration): one fused kernel call,
        vectorized joinedToTextOff, and a slim per-read policy loop."""
        B = len(reads)
        fw = [r.codes_fw for r in reads]
        rc = [r.codes_rc for r in reads]
        mat, lens = right_align(fw + rc)
        seeds = fill_seed_caches(reads, self.global_seed)
        seeds2 = np.concatenate([seeds, seeds]).astype(np.int64)
        packed = one_row(self.fm, self._to_device(mat),
                         self._to_device(lens),
                         self._to_device(seeds2)).cpu().numpy()
        spread, offs, ok = packed[0], packed[1], packed[2]
        tidx, textoff, valid = self.joined(offs, lens.astype(np.int64))
        valid = valid & (ok > 0) & (spread > 0)
        spread_l = spread.tolist()
        tidx_l = tidx.tolist()
        toff_l = textoff.tolist()
        valid_l = valid.tolist()
        results = []
        strands = [s for s in (0, 1)
                   if not (s == 0 and self.nofw)
                   and not (s == 1 and self.norc)]
        finish = self.policy.finish
        stop_after = self.policy.stop_after
        seeds_l = seeds.tolist()
        for i, read in enumerate(reads):
            buffered: list[Hit] = []
            count = 0
            for strand in strands:
                j = i + strand * B
                if spread_l[j] <= 0 or not valid_l[j]:
                    continue
                count += 1
                stop, maxed = stop_after(count)
                if maxed:
                    break
                buffered.append(Hit(
                    read=read, fw=(strand == 0), tidx=tidx_l[j],
                    toff=toff_l[j], oms=spread_l[j] - 1, stratum=0,
                    cost=0))
                if stop:
                    break
            results.append(finish(buffered, count, seeds_l[i]))
        return results

    def _align_batch_enum(self, reads: list) -> list[ReadResult]:
        """Every row of each range (-k>1, -a, -m): exact search on the
        device, the chase order of every range on host, then one
        resolve launch over all the rows."""
        B = len(reads)
        fw = [r.codes_fw for r in reads]
        rc = [r.codes_rc for r in reads]
        mat, lens = right_align(fw + rc)
        top_d, bot_d = exact_ranges(self.fm, self._to_device(mat),
                                    self._to_device(lens))
        top = top_d.cpu().numpy()
        bot = bot_d.cpu().numpy()
        spread = bot - top

        seeds = fill_seed_caches(reads, self.global_seed)

        # Chase order per strand: start at top + rand % spread, wrap
        # (reportFullAlignment, ebwt_search_backtrack.h:1536-1540);
        # strands are laid out fw then rc for each read.
        _, rand1 = next_u32(seeds)   # first draw per strand attempt
        lane = np.arange(2 * B).reshape(2, B).T.reshape(-1)  # (i,fw),(i,rc)
        keep = spread[lane] > 0
        if self.nofw:
            keep &= lane >= B
        if self.norc:
            keep &= lane < B
        lane = lane[keep]
        sp = spread[lane]
        r0 = rand1[lane % B].astype(np.int64) % sp
        k = (np.arange(int(sp.sum()), dtype=np.int64)
             - np.repeat(np.cumsum(sp) - sp, sp))
        rows = np.repeat(top[lane], sp) + (np.repeat(r0, sp) + k) \
            % np.repeat(sp, sp)
        row_lane = np.repeat(lane, sp)

        if len(rows):
            offs_d, _ok = resolve_rows(self.fm, self._to_device(rows))
            offs = offs_d.cpu().numpy()
            qlens = lens[row_lane].astype(np.int64)
            tidx, textoff, valid = self.joined(offs, qlens)
        else:
            tidx = textoff = valid = np.zeros(0)
        tidx_l = tidx.tolist()
        toff_l = textoff.tolist()
        valid_l = valid.tolist()
        # rows of lane j occupy [first[j], first[j] + spread[j])
        first = np.zeros(2 * B, dtype=np.int64)
        first[lane] = np.cumsum(sp) - sp
        first_l = first.tolist()
        nrows = np.zeros(2 * B, dtype=np.int64)
        nrows[lane] = sp
        nrows_l = nrows.tolist()
        spread_l = spread.tolist()

        # Apply policy per read: fw strand first, stop rules per
        # NGoodHitSinkPerThread; fw stop skips rc (search_exact.c:17).
        results = []
        seeds_l = seeds.tolist()
        for i, read in enumerate(reads):
            buffered: list[Hit] = []
            count = 0
            stopped = False
            for strand in (0, 1):
                if stopped:
                    break
                j = i + strand * B
                for m in range(first_l[j], first_l[j] + nrows_l[j]):
                    if not valid_l[m]:
                        continue
                    count += 1
                    stop, maxed = self.policy.stop_after(count)
                    if maxed:
                        stopped = True
                        break
                    buffered.append(Hit(
                        read=read, fw=(strand == 0), tidx=tidx_l[m],
                        toff=toff_l[m], oms=spread_l[j] - 1, stratum=0,
                        cost=0))
                    if stop:
                        stopped = True
                        break
            results.append(self.policy.finish(buffered, count, seeds_l[i]))
        return results
