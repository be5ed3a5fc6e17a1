"""Paired-end alignment on the card (PairedBWAlignerV1,
aligner.h:606-1480).

A port of bowtie_tpu/align/pe_device.py.  The V1 engine interleaves four
per-(mate, strand) best-first anchor drivers with reference-window mate
rescue.  The driver streams do not interact (the interleave only decides
which ranges get chased and rescued, and when to stop), so the costly
part, the branch-and-bound search, batches:

0. EXACT (card, rec_cap 1 only): one launch of K12 (exact_ranges_cat)
   finds the whole-read exact range of every (pair, mate, orientation)
   lane, each on the index its first driver searches.  A lane of 4-255
   bases with a non-empty range records that range alone, as a one-row
   stream marked capped: the exact-reporting driver starts at cost 0 and
   every other driver at 1 << 14 or more, so the best-first search would
   report that range first.  Only the other lanes reach the machine.
1. RECORD (card): every (pair, mate, orientation) lane phase 0 leaves is
   one lane of the best-first machine in record mode, K10r
   (align/best_device.py run_machine with record=True): the lane appends
   its driver's ranges to its hit pool in emission order, with the
   driver's done-at-emission flag, until the driver is exhausted or
   rec_cap ranges are recorded.  The fw-DAG and the rc-DAG lanes run in
   ONE launch: the config tables are the two DAGs' tables one after
   another, and each lane reads its own through its cfg0f/cfg0o bases.
   K11 (best_pack) packs the recorded rows for one download.
2. INTERLEAVE (card; bowtie's default -k 1 without -m, as the reference's
   use_ilv gate takes it, pe_device.py:496-503, 882): K13
   (align/pe_ilv_device.py run_ilv) runs the interleave, the chases and
   the rescue scans of every pair whose mates are at most 64 bases, one
   warp per pair, and decides it or escalates it; _ilv_assemble builds
   a decided pair's result on the host as the host engine's
   _resolve_outstanding would.
3. REPLAY (host): the pairs K13 does not take (other policies, longer
   mates) run PairedBestAligner (align/best_paired.py) unchanged over
   ReplayDrivers that pop the recorded streams.  The interleave, the
   chase's RNG draws, the rescue scans and the sink calls happen as on the
   host engine, so the output is byte-identical.  The rescue windows of
   all live pairs are scored together, one wave at a time (_score_batch);
   with threads > 1 a fork pool splits the replay.

A pair whose interleave outruns a capped stream re-records its four
streams uncapped (round 2, with no phase 0; `escalations` counts them)
and runs K13 or the replay again; a pair K13 still escalates on uncapped
streams (its step budget, or a saturated count) re-runs on the live host
drivers.  A pair with an overflowing lane (the hit pool, the mismatch
slots, the step budget) or a mate the machine does not take (under 4 or
over 255 bases) re-runs on the live host drivers too (`fallbacks` counts
both), as the reference does; `synthesized` counts the lanes phase 0
settled, and `ilv_by_round` the pairs K13 decided and escalated and those
it left to the host replay, per round.

rec_cap is 1 with phase 0 for bowtie's default -k 1 without -m, the one
policy that stops at the first pair (the reference's policy with its
interleave on, pe_device.py:487-495), and None (uncapped) when the policy
needs every row (-k > 1, -a, -m, -M).  Left out: SynthStream,
_synth_streams and _exact_fm (no caller in the reference's recorder), the
shape buckets of phase 0's matrix and of K13's batch, the reference's one
packed K13 upload (init_from_packed), and dryrun_pe.  UnrecordedDriver is
left out too: it stands for a stream slot a recording skipped, and every
recording here (and the reference's after its phased design went)
records or synthesizes all four.
"""
from __future__ import annotations

import gc
import multiprocessing as mp
import os

import numpy as np
import torch

from .backtrack_oracle import QUAL_ROUNDS
from .best import FoundRange
from .best_device import (CFG_F, CFG_O, H_MAX, HIT_W, INF32, MM_SLOTS,
                          HostInit, best_pack, run_machine,
                          seeded_mode_configs, unpack_harvest,
                          v_mode_configs)
from .best_factories import make_paired_best_aligner
from .dfs_device import FMPair, _len_bucket, build_fmpair
from .exact import exact_ranges_plain, right_align
from .golden import GoldenFM
from .pe_ilv_device import (OUT_KEYS as ILV_OUT_KEYS, REC_W, IlvStatic,
                            init_state as ilv_init_state, run_ilv,
                            stack_out)
from .policy import INF, KPolicy
from .types import Hit
from .. import kernels
from ..utils.rng import fill_seed_caches


def exact_ranges_cat_plain(pair: FMPair, reads: torch.Tensor,
                           lens: torch.Tensor, efw: torch.Tensor,
                           work: torch.Tensor | None = None):
    """[N, L] right-aligned codes, [N] lens and [N] efw -> (top[N],
    bot[N]) int64, (0, 0) where the range is empty: lane j searched on
    pair.fw where efw[j] is non-zero, else on pair.bw
    (bowtie_tpu/align/pe_device.py:37 exact_ranges_cat).  Each index's
    lanes run K2's lockstep scan (align/exact.py exact_ranges_plain);
    lanes are independent, so the split changes no result.  If `work` is
    given ([2, N] int64), each lane's LF steps and popcounted words are
    added to it as exact_ranges_plain counts them."""
    n = reads.shape[0]
    top = torch.zeros(n, dtype=torch.int64, device=reads.device)
    bot = torch.zeros(n, dtype=torch.int64, device=reads.device)
    for fm, sel in ((pair.fw, efw != 0), (pair.bw, efw == 0)):
        j = torch.nonzero(sel).squeeze(1)
        if not j.numel():
            continue
        w = None if work is None else torch.zeros_like(work[:, j])
        top[j], bot[j] = exact_ranges_plain(fm, reads[j], lens[j], w)
        if work is not None:
            work[:, j] += w
    return top, bot


def exact_ranges_cat(pair: FMPair, reads: torch.Tensor, lens: torch.Tensor,
                     efw: torch.Tensor):
    """K12: (top[N], bot[N]) int64 whole-read exact ranges of the
    right-aligned uint8 reads [N, L] with int32 lengths [N], lane j on the
    forward index where the uint8 efw[j] is non-zero, else on the mirror;
    (0, 0) where a range is empty.  Launches csrc/exact.cu's
    exact_ranges_cat_kernel on CUDA tensors."""
    if kernels.on_cpu(pair.fw, reads, lens, efw):
        return exact_ranges_cat_plain(pair, reads, lens, efw)
    dev = pair.device
    kernels.check(reads, "reads", torch.uint8, 2, dev)
    kernels.check(lens, "lens", torch.int32, 1, dev)
    kernels.check(efw, "efw", torch.uint8, 1, dev)
    n, L = reads.shape
    if lens.shape[0] != n or efw.shape[0] != n:
        raise ValueError(f"lens/efw have {lens.shape[0]}/{efw.shape[0]} "
                         f"entries for {n} reads")
    top = torch.empty(n, dtype=torch.int64, device=dev)
    bot = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        kernels.launch("exact_ranges_cat", "bt_exact_ranges_cat",
                       kernels.fm_view(pair.fw), kernels.fm_view(pair.bw),
                       reads.data_ptr(), lens.data_ptr(), efw.data_ptr(),
                       n, L, top.data_ptr(), bot.data_ptr(), device=dev)
    return top, bot


class ReplayTruncated(Exception):
    """The interleave asked for a range past the recorded end of a
    rec_cap-truncated stream: the pair must be recorded again uncapped."""


class RecordedStream:
    """A lane's recorded range stream: the raw hit-record rows plus the
    per-driver strand tables needed to build each FoundRange lazily (many
    recorded ranges are never popped: the interleave stops as soon as the
    pair is decided)."""

    __slots__ = ("rows", "qlen", "o_fw", "o_efw", "capped")

    def __init__(self, rows, qlen, o_fw, o_efw):
        self.rows = rows            # np [n, HIT_W] hit records
        self.qlen = qlen
        self.o_fw = o_fw
        self.o_efw = o_efw
        # done column 2: the lane was frozen by rec_cap, the stream may
        # be truncated (best_device._record_range)
        self.capped = len(rows) > 0 and int(rows[-1][6]) == 2

    def __len__(self):
        return len(self.rows)

    def materialize(self, t):
        rec = self.rows[t]
        drv = int(rec[0])
        ne = int(rec[5])
        mms = [self.qlen - int(rec[8 + k]) - 1 for k in range(ne)]
        refcs = [int(rec[8 + MM_SLOTS + k]) for k in range(ne)]
        fr = FoundRange(
            top=int(rec[1]), bot=int(rec[2]), cost=int(rec[3]),
            stratum=int(rec[4]), num_mms=ne, fw=bool(self.o_fw[drv]),
            ebwt_fw=bool(self.o_efw[drv]), mms=mms, refcs=refcs)
        return fr, int(rec[6]) == 1


class ReplayDriver:
    """Feeds a recorded FoundRange stream through the BestDriver
    advance()/range()/done interface the paired interleave consumes."""

    __slots__ = ("_s", "_i", "_cur", "found_range", "done")

    def __init__(self, stream: RecordedStream):
        self._s = stream
        self._i = 0
        self._cur = None
        self.found_range = False
        # not done before its first advance, empty stream or not, as a
        # live driver (the reference's ReplayDriver starts an empty stream
        # done, which skips the other side's first chase; ROADMAP queue 3)
        self.done = False

    def advance(self, _until):
        if self._i < len(self._s):
            r, done = self._s.materialize(self._i)
            self._i += 1
            self._cur = r
            self.found_range = True
            # done-at-emission: the host CostAwareDriver.advance can set
            # done together with found_range (range_source.h:2262+);
            # otherwise done only once the stream is exhausted.  A capped
            # stream's machine was frozen early, so the end of the
            # recorded stream proves nothing: stay not-done and escalate
            # if the interleave advances again.
            self.done = bool(done) or (self._i >= len(self._s)
                                       and not self._s.capped)
        else:
            if self._s.capped:
                raise ReplayTruncated
            self.done = True

    def range(self):
        return self._cur


class _StrandMachine:
    """One strand's driver DAG for the recorder: the outer drivers, their
    HostInit and the machine's static switches (mate is per lane, through
    its query)."""

    def __init__(self, idx_fw, idx_bw, mode, v, seed_mms, seed_len,
                 qual_cutoff, fw, maq, qual_order, maxbts, max_steps):
        nofw, norc = (not fw), fw
        if mode == "n":
            self.outers = seeded_mode_configs(seed_mms, nofw, norc)
            self.qual_lim = qual_cutoff
            self.bt_on = seed_mms >= 2
            sl = seed_len
        else:
            self.outers = v_mode_configs(v, nofw, norc)
            self.qual_lim = INF32
            self.bt_on = False
            sl = 0
        self.has_seeded = mode == "n"
        self.hostinit = HostInit(self.outers, idx_fw, idx_bw, maq,
                                 qual_order, self.qual_lim, sl)
        self.qual_order = qual_order
        self.maxbts = maxbts
        self.max_steps = max_steps


def fused_host_init(machs, reads, grp, seeds, L):
    """HostInit.build's arrays for lanes of several driver DAGs in one
    run: lane j of `reads` takes DAG grp[j] (machs[grp[j]]'s HostInit)
    and its config bases cfg0f/cfg0o point at that DAG's block of the
    concatenated tables (pe_device.py:715-731).  seeds: the outer
    CostAware's seed of each lane, which for a paired lane is mate 1's
    (range_source.h:2084)."""
    B = len(reads)
    host = {}
    for g, mach in enumerate(machs):
        sel = np.flatnonzero(grp == g)
        if not len(sel):
            continue
        part = mach.hostinit.build([reads[j] for j in sel], L, seeds[sel])
        for kname, v in part.items():
            if kname not in host:
                host[kname] = np.zeros((B,) + v.shape[1:], v.dtype)
            host[kname][sel] = v
    host["cfg0f"] = grp * machs[0].hostinit.ndt
    host["cfg0o"] = grp * machs[0].hostinit.nd
    return host


def _score_batch(ra, ref_cat, ref_base, ref_len, reqs):
    """RefAlignerPy.score over many rescue requests at once.

    One request's window scan touches only ~250 x 35 cells, so the
    per-call cost is numpy's fixed overhead; batching all live pairs'
    scans into [n, NC, qlen] arrays saves most of it.  Byte-equivalent to
    per-request score(): the same zig-zag candidate order, the same
    validity rules.  reqs: list of (tidx, seq, qual, begin, end,
    seed_on_left)."""
    out = [None] * len(reqs)
    groups = {}
    for k, (tidx, seq, qual, begin, end, sol) in enumerate(reqs):
        seq = np.asarray(seq)
        if (seq > 3).any():
            continue            # Ns in query disqualify
        groups.setdefault((len(seq), bool(sol)), []).append(k)
    if len(reqs) < 48:
        # small waves (the tail where few pairs remain live): per-request
        # scoring is as fast as a padded batch
        for k, (tidx, seq, qual, begin, end, sol) in enumerate(reqs):
            base = ref_base[tidx]
            ref = ref_cat[base:base + ref_len[tidx]]
            out[k] = ra.score(ref, np.asarray(seq), qual, begin, end, sol)
        return out
    for (qlen, sol), ks in groups.items():
        n = len(ks)
        begin = np.array([reqs[k][3] for k in ks], np.int64)
        end = np.array([reqs[k][4] for k in ks], np.int64)
        tidxs = np.array([reqs[k][0] for k in ks], np.int64)
        qry = np.stack([np.asarray(reqs[k][1], np.uint8) for k in ks])
        reflen = ref_len[tidxs]
        if sol:
            qbegin, qend = begin, end - qlen
        else:
            qbegin, qend = begin + qlen, end
        lim = qend - qbegin
        halfway = qbegin + (lim >> 1)
        # one contiguous window per request ([n, W + qlen]) scored in
        # window order; the zig-zag order applies only when the (few)
        # valid candidates are extracted per request
        lo_zz = halfway - ((lim + 1) >> 1)
        lo_w = (lo_zz if sol else lo_zz - qlen)
        lo_w = np.maximum(lo_w, 0)
        span = int(lim.max()) + qlen + 2
        npos = span - qlen + 1
        widx = lo_w[:, None] + np.arange(span, dtype=np.int64)
        widx = np.minimum(widx, (reflen - 1)[:, None])
        win = ref_cat[ref_base[tidxs][:, None] + widx]   # [n, span]
        sw = np.lib.stride_tricks.sliding_window_view(win, qlen, axis=1)
        neq = sw != qry[:, None, :]                 # [n, npos, qlen]
        okn = ~(sw > 3).any(axis=2)
        if ra.v is not None:
            mmc = neq.sum(axis=2)
            okn &= mmc <= ra.v
            strat_all = mmc
            ham_all = np.zeros((n, npos), np.int64)
        else:
            slen = min(ra.seed_len, qlen)
            if sol:
                seedcols = np.arange(qlen) < slen
            else:
                seedcols = np.arange(qlen) >= qlen - slen
            seed_mm = (neq & seedcols[None, None, :]).sum(axis=2)
            quals = np.stack([np.frombuffer(reqs[k][2], np.uint8)
                              for k in ks]).astype(np.int32) - 33
            from .backtrack_oracle import QUAL_ROUNDS
            pens = QUAL_ROUNDS[quals] if ra.maq else quals
            ham_all = (pens[:, None, :] * neq).sum(axis=2)
            okn &= (seed_mm <= ra.seed_mms) & (ham_all <= ra.qual_max)
            strat_all = seed_mm
        NC = int(lim.max()) + 1
        i = np.arange(1, NC + 1, dtype=np.int64)
        for r, k in enumerate(ks):
            ri = np.where(i & 1, halfway[r] - (i >> 1),
                          halfway[r] + (i >> 1))[:lim[r] + 1]
            left = ri if sol else ri - qlen
            inb = (left >= 0) & (left + qlen <= reflen[r])
            off = left - lo_w[r]
            offc = np.clip(off, 0, npos - 1)
            jj = np.flatnonzero(inb & (off >= 0) & (off < npos) &
                                okn[r, offc])
            if len(jj):
                oj = off[jj]
                out[k] = (left[jj], strat_all[r, oj], ham_all[r, oj],
                          sw[r, oj].copy(), neq[r, oj])
    return out


# Set in the parent right before the replay pool forks; children inherit
# it copy-on-write.  It holds only host state (the host aligner, the
# reference, numpy streams): a forked child must never touch CUDA.
_PE_WORKER = None


def _pe_replay_worker(chunk):
    out = []
    for i, rd1, rd2, streams in chunk:
        res, esc = _PE_WORKER.replay(rd1, rd2, streams)
        out.append((i, res, esc))
    return out


class _ReplayState:
    """The replay's host state, which the fork pool's children inherit:
    the host V1 aligner whose driver factory pops installed streams (or
    builds live host drivers for pairs that fall back), and the reference
    concatenated for _score_batch."""

    def __init__(self, host):
        self._host = host
        self._live_factory = host.driver_factory
        host.driver_factory = self._factory
        self._streams = None        # per pair [d1f, d1r, d2f, d2r]
        refs = host.refs
        self.ref_cat = np.concatenate([np.asarray(r, np.uint8)
                                       for r in refs])
        lens = np.array([len(r) for r in refs], np.int64)
        self.ref_base = np.zeros(len(refs), np.int64)
        np.cumsum(lens[:-1], out=self.ref_base[1:])
        self.ref_len = lens

    def _factory(self, rd1, rd2):
        if self._streams is not None:
            return [ReplayDriver(s) for s in self._streams]
        return self._live_factory(rd1, rd2)

    def replay(self, rd1, rd2, streams):
        """Replay one pair (streams None: live host drivers); returns
        (result, escalate)."""
        self._streams = streams
        try:
            return self._host.align_pair(rd1, rd2), False
        except ReplayTruncated:
            return None, True
        finally:
            self._streams = None

    def replay_wave(self, pairs, items):
        """Advance every pair's interleave generator one rescue request
        at a time, scoring all pairs' rescue windows of a wave in one
        batch (_score_batch)."""
        host = self._host
        out = []
        live = {}
        results_for = {}
        for i, streams in items:
            if streams is None:
                out.append((i, *self.replay(*pairs[i], None)))
                continue
            drivers = [ReplayDriver(s) for s in streams]
            live[i] = host.align_pair_gen(*pairs[i], drivers)
            results_for[i] = None
        while live:
            reqs = []
            for i in list(live):
                g = live[i]
                try:
                    req = g.send(results_for.pop(i, None))
                except StopIteration as e:
                    out.append((i, e.value, False))
                    del live[i]
                    continue
                except ReplayTruncated:
                    out.append((i, None, True))
                    del live[i]
                    continue
                reqs.append((i, req))
            if reqs:
                scored = _score_batch(host.ra, self.ref_cat, self.ref_base,
                                      self.ref_len, [r for _, r in reqs])
                for (i, _), sc in zip(reqs, scored):
                    results_for[i] = sc
        return out


class DevicePairedBestAligner:
    """The paired V1 aligner with anchor streams recorded on `device`
    (default CUDA): align_batch(pairs) gives what
    make_paired_best_aligner's product gives.

    threads > 1 forks a pool for the host replay (the -p analog of the
    reference's per-thread aligner graphs, ebwt_search.cpp:1333).  The
    pool forks in the constructor, after the host state is built and
    before this aligner allocates anything on the card, and its children
    run only the host replay, on numpy.  It forks, as ParallelHostAligner
    and the reference do, so that the children inherit the host engine's
    index tables instead of building them again; close() stops it."""

    DENSE_LIMIT = 1 << 28

    def __init__(self, idx_fw, idx_bw, refs, policy: KPolicy,
                 mode: str = "n", v: int = 0, seed_mms: int = 2,
                 seed_len: int = 28, qual_cutoff: int = 70,
                 fw1: bool = True, fw2: bool = False,
                 min_insert: int = 0, max_insert: int = 250,
                 pairtries: int = 100, mixed_thresh: int = 4,
                 sym_ceiling: int = 0xFFFFFFFF, maq: bool = True,
                 better: bool = False, global_seed: int = 0,
                 maxbts: int = 800, max_steps: int = 60000,
                 compact: bool | None = None, threads: int = 1,
                 device=None):
        global _PE_WORKER
        if idx_fw.length >= (1 << 31):
            raise ValueError(
                f"the best-first machine compares rows as signed int32; "
                f"joined length {idx_fw.length:,} >= 2^31 routes to the "
                f"host engine")
        kw = dict(mode=mode, v=v, seed_mms=seed_mms, seed_len=seed_len,
                  qual_cutoff=qual_cutoff, maq=maq, qual_order=not better,
                  maxbts=maxbts, max_steps=max_steps)
        self.m_fw = _StrandMachine(idx_fw, idx_bw, fw=True, **kw)
        self.m_rc = _StrandMachine(idx_fw, idx_bw, fw=False, **kw)
        hf, hr = self.m_fw.hostinit, self.m_rc.hostinit
        assert (hf.nd, hf.ndt) == (hr.nd, hr.ndt)
        self.global_seed = global_seed
        self.fw1, self.fw2 = fw1, fw2
        self.fallbacks = 0
        self.escalations = 0
        self.synthesized = 0
        # -k 1 without -m: phase 0, then each lane stops after its first
        # recorded range; a pair whose interleave outruns a capped stream
        # re-records uncapped (pe_device.py:487-495).  -k > 1, -a, -m
        # and -M chase every range: uncapped there.
        self.rec_cap = None if policy.want_all_rows() else 1
        # K13 takes the pairs of the same policy, on fewer than 2^31 - 2
        # rows and within a 2,048-base insert (pe_device.py:496-503)
        self.use_ilv = (policy.n == 1 and policy.max == INF
                        and idx_fw.length < (1 << 31) - 2
                        and max_insert <= 2048)
        self.ilv_by_round = {f"round {r}": dict(decided=0, escalated=0,
                                                host=0) for r in (1, 2)}
        self._ilv_cache = {}
        self._replay_state = _ReplayState(make_paired_best_aligner(
            GoldenFM(idx_fw), GoldenFM(idx_bw), refs, policy,
            mode=mode, v=v, seed_mms=seed_mms, seed_len=seed_len,
            qual_cutoff=qual_cutoff, fw1=fw1, fw2=fw2,
            min_insert=min_insert, max_insert=max_insert,
            pairtries=pairtries, mixed_thresh=mixed_thresh,
            sym_ceiling=sym_ceiling, maq=maq, better=better,
            global_seed=global_seed, maxbts=maxbts))
        self.threads = max(1, min(threads, os.cpu_count() or 1))
        self._pool = None
        if self.threads > 1 and hasattr(os, "fork"):
            _PE_WORKER = self._replay_state
            gc.collect()       # no pending garbage a child could free
            self._pool = mp.get_context("fork").Pool(self.threads)
        if compact is None:
            compact = idx_fw.length > self.DENSE_LIMIT
        self.pair = build_fmpair(idx_fw, idx_bw, device,
                                 dense_sa=not compact)
        self._fcfg = {k: np.concatenate([hf.cfg[k], hr.cfg[k]])
                      for k in CFG_F + CFG_O}

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def ilv_decided(self):
        """The pairs K13 decided, both rounds."""
        return sum(c["decided"] for c in self.ilv_by_round.values())

    # -- replay ------------------------------------------------------------

    def _replay_all(self, pairs, items):
        """Replay (i, streams) items -> [(i, result, escalate)]: the
        interleave generators run in waves with batched rescue scoring;
        live-driver fallbacks (streams None) run per pair.  The fork pool
        (threads > 1) splits the items across processes."""
        if self._pool is not None and len(items) >= 2 * self.threads:
            work = [(i, pairs[i][0], pairs[i][1], streams)
                    for i, streams in items]
            nchunks = min(len(work), self.threads * 4)
            size = -(-len(work) // nchunks)
            chunks = [work[k:k + size] for k in range(0, len(work), size)]
            out = []
            for part in self._pool.map(_pe_replay_worker, chunks):
                out.extend(part)
            return out
        return self._replay_state.replay_wave(pairs, items)

    # -- the fused recording -----------------------------------------------

    def _record_all(self, plan, idxs, seeds, cap):
        """Record all four anchor streams of the pairs idxs (seeds: mate
        1's seed of each).  At cap 1, phase 0 first settles every lane
        with a whole-read exact range (_synthesize); the lanes left run
        in ONE machine run, each lane's cfg0f/cfg0o bases selecting the
        fw- or rc-DAG tables: K10r, then K11 and one download.  Lanes the
        machine does not take (under 4 or over 255 bases) overflow: their
        pairs re-run on the host drivers.  -> (streams {i: [4 streams]},
        overflowed {i: bool})."""
        sts = {i: [None] * 4 for i in idxs}
        ovd = {i: False for i in idxs}
        keep = None
        if cap == 1:
            keep = self._synthesize(plan, idxs, sts)
            self.synthesized += int((~keep).sum())
        lanes = self._lanes(plan, idxs, seeds, keep)
        n = len(lanes["need"])
        overflow = np.ones(n, bool)
        hits = np.zeros((n, H_MAX, HIT_W), np.int32)
        nh = np.zeros(n, np.int32)
        take = lanes["take"]
        if len(take):
            args = self._machine_args(lanes)
            out, _ = run_machine(*args["args"], **args["kw"], rec_cap=cap)
            h = unpack_harvest(best_pack(out).cpu().numpy(), len(take))
            overflow[take] = h["overflow"]
            hits[take] = h["hits"]
            nh[take] = h["nhits"]
        for j, (mach, read, slot, k) in enumerate(lanes["need"]):
            i = idxs[k]
            if overflow[j]:
                ovd[i] = True
                continue
            sts[i][slot] = RecordedStream(
                hits[j, :int(nh[j])], len(read.seq),
                mach.hostinit.cfg["o_fw"], mach.hostinit.cfg["o_chase_efw"])
        return sts, ovd

    def exact_inputs(self, plan, idxs):
        """Phase 0's K12 inputs on the pair's device: lane s*len(idxs) + k
        is plan section s's mate of pair idxs[k], oriented as the
        section's first driver reads it (fw or rc) and reversed when that
        driver searches the mirror index, which consumes the read
        forward; efw 1 for the forward index.  -> (reads [4n, L] uint8
        right-aligned, lens [4n] int32, efw [4n] uint8)."""
        codes, efw = [], []
        for mach, mates, _slot in plan:
            cfg = mach.outers[0].cfg
            assert cfg.report_exacts
            for i in idxs:
                b = mates[i].codes_fw if cfg.fw else mates[i].codes_rc
                codes.append(b if cfg.ebwt_fw else b[::-1])
                efw.append(int(cfg.ebwt_fw))
        mat, lens = right_align(codes)
        dev = self.pair.device
        return (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                torch.tensor(efw, dtype=torch.uint8).to(dev))

    def _synthesize(self, plan, idxs, sts):
        """Phase 0 (pe_device.py:652-691): one K12 launch and one download
        for every lane of the recording; a lane of 4-255 bases with a
        non-empty range gets a one-row stream in sts: driver 0, that
        range, cost 0, stratum 0, no mismatches, done column 2 (capped),
        qlen.  -> keep [4, len(idxs)] bool, the lanes left to record."""
        top, bot = exact_ranges_cat(self.pair, *self.exact_inputs(plan,
                                                                  idxs))
        tb = torch.stack([top, bot]).cpu().numpy().reshape(2, 4, len(idxs))
        keep = np.ones((4, len(idxs)), bool)
        for s, (mach, mates, slot) in enumerate(plan):
            o_fw = mach.hostinit.cfg["o_fw"]
            o_efw = mach.hostinit.cfg["o_chase_efw"]
            for k, i in enumerate(idxs):
                t, b = tb[:, s, k]
                qlen = len(mates[i].seq)
                if b > t and 4 <= qlen <= 255:
                    row = np.zeros((1, HIT_W), np.int64)
                    row[0, 1], row[0, 2] = t, b
                    row[0, 6] = 2           # capped
                    row[0, 7] = qlen
                    sts[i][slot] = RecordedStream(row, qlen, o_fw, o_efw)
                    keep[s, k] = False
        return keep

    def _lanes(self, plan, idxs, seeds, keep=None):
        """The lanes of one recording (keep[s, k]: record plan section s's
        mate of pair idxs[k]; default all): need[j] = (machine, read,
        stream slot, index into idxs), the fw-DAG's lanes first so that
        each lane's config base is monotone; take: the lanes the machine
        runs (4-255 bases).  Two seeds per lane: mate 1's (seeds) for the
        outer CostAware (its sort draws, the strandFix swap) and the
        lane's own read's for the range sources and the seeded drivers'
        inner CostAware, as the host drivers seed them
        (best_driver.CostAwareDriver.seed_read, best.BestRangeSource.
        set_query).  The reference's recorder seeds the latter with mate
        1's too (ROADMAP queue 3)."""
        need = []
        for s, (mach, mates, slot) in enumerate(plan):
            grp = 0 if mach is self.m_fw else 1
            need += [(grp, slot, k, mach, mates[i])
                     for k, i in enumerate(idxs)
                     if keep is None or keep[s, k]]
        need.sort(key=lambda t: t[:3])
        reads = [t[4] for t in need]
        return dict(
            need=[(t[3], t[4], t[1], t[2]) for t in need],
            grp=np.array([t[0] for t in need], np.int32),
            ca_seeds=seeds[np.array([t[2] for t in need], np.int64)],
            own_seeds=fill_seed_caches(reads, self.global_seed),
            take=np.array([j for j, r in enumerate(reads)
                           if 4 <= len(r.seq) <= 255], np.int64))

    def _machine_args(self, lanes):
        """run_machine's arguments (but rec_cap) for the lanes taken."""
        take = lanes["take"]
        reads = [lanes["need"][j][1] for j in take]
        L = _len_bucket(max(len(r.seq) for r in reads))
        host = fused_host_init((self.m_fw, self.m_rc), reads,
                               lanes["grp"][take], lanes["ca_seeds"][take], L)
        seeds = torch.from_numpy(lanes["own_seeds"][take].astype(np.int64))
        m = self.m_fw
        return dict(
            args=(self.pair, self._fcfg, host, seeds.to(self.pair.device)),
            kw=dict(L=L, nd=m.hostinit.nd, ndt=m.hostinit.ndt,
                    maxbts=m.maxbts, n_k=INF32, m_max=INF32, strata=False,
                    qual_lim=m.qual_lim, qual_order=m.qual_order,
                    bt_on=m.bt_on, has_seeded=m.has_seeded,
                    max_steps=m.max_steps, record=True))

    def record_inputs(self, pairs, cap):
        """run_machine's arguments (but rec_cap) for the machine's lanes
        of `pairs` as _record_all records them at `cap` (at cap 1, the
        lanes phase 0 leaves; else every lane): for holding K10r to its
        plain version.  -> dict(args=, kw=)."""
        idxs = list(range(len(pairs)))
        seeds = fill_seed_caches([p[0] for p in pairs], self.global_seed)
        plan = self.plan(pairs)
        keep = None
        if cap == 1:
            keep = self._synthesize(plan, idxs, {i: [None] * 4
                                                 for i in idxs})
        return self._machine_args(self._lanes(plan, idxs, seeds, keep))

    def plan(self, pairs):
        """The four (machine, mates, stream slot) sections of the
        recording: each mate in the pair's fw orientation, then in its rc
        orientation; slots in the driver factory's order [d1f, d1r, d2f,
        d2r]."""
        m1 = [p[0] for p in pairs]
        m2 = [p[1] for p in pairs]
        slotL = 0 if self.fw1 else 1          # mate1, fw orientation
        slotR = 2 if self.fw2 else 3          # mate2, fw orientation
        slotLb = 1 if self.fw1 else 0         # mate1, rc orientation
        slotRb = 3 if self.fw2 else 2
        machL = self.m_fw if self.fw1 else self.m_rc
        machR = self.m_fw if self.fw2 else self.m_rc
        machLb = self.m_rc if self.fw1 else self.m_fw
        machRb = self.m_rc if self.fw2 else self.m_fw
        return ((machL, m1, slotL), (machR, m2, slotR),
                (machLb, m1, slotLb), (machRb, m2, slotRb))

    # -- the interleave on the card (K13) ----------------------------------

    ILV_MAX_LEN = 64           # the longest mate K13 takes (Lq 40 or 64)

    def _ilv_static_consts(self, Lq):
        """IlvStatic for query width Lq and the tables every lane shares,
        on the pair's device (pe_device.py:772-812; cached per Lq)."""
        if Lq in self._ilv_cache:
            return self._ilv_cache[Lq]
        host = self._replay_state._host
        ra = host.ra
        nd = len(self.m_fw.hostinit.cfg["o_chase_efw"])
        efw_tab = np.zeros(4 * nd, np.int32)
        for slot in range(4):
            mach = self.m_fw if slot % 2 == 0 else self.m_rc
            efw_tab[slot * nd:(slot + 1) * nd] = mach.hostinit.cfg[
                "o_chase_efw"]
        S = IlvStatic(
            Lq=Lq, SPAN=((int(host.maxins) + Lq + 2 + 63) // 64) * 64,
            nfrag=self.pair.nfrag, nd=nd, dense=self.pair.dense,
            v=-1 if ra.v is None else int(ra.v), seed_mms=int(ra.seed_mms),
            seed_len=int(ra.seed_len), qual_max=int(ra.qual_max),
            attempt_lim=int(host.mixed_attempt_lim),
            sym_ceiling=int(host.sym_ceiling),
            dont_reconcile=bool(host.dont_reconcile),
            slot_l0=0 if self.fw1 else 1, slot_r0=2 if self.fw2 else 3,
            slot_l1=3 if self.fw2 else 2, slot_r1=1 if self.fw1 else 0)
        rs, dev = self._replay_state, self.pair.device
        consts = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("efw_tab", efw_tab), ("reflen", rs.ref_len),
            ("refcat", rs.ref_cat), ("refbase", rs.ref_base))}
        self._ilv_cache[Lq] = (S, consts)
        return S, consts

    def _ilv_lane_consts(self, pairs, lanes, Lq):
        """Each lane's outstanding-query tables by combo (pe_ilv_device
        _combo: 0 = (mate 1, fw1), 1 = (mate 1, !fw1), 2 = (mate 2, fw2),
        3 = (mate 2, !fw2)), vectorized (pe_device.py:814-867): the query
        as the outstanding mate's strand reads it, its penalties, lengths,
        N flags, strands, the wok flag and the trim-adjusted insert
        limits.  -> numpy arrays by name."""
        host = self._replay_state._host
        B = len(lanes)
        rds = [pairs[i] for i in lanes]
        l1 = np.fromiter((len(r.seq) for r, _ in rds), np.int32, B)
        l2 = np.fromiter((len(r.seq) for _, r in rds), np.int32, B)
        # _trim_adjusted_insert: -I/-X less each mate's outer trim
        minins = np.full(B, host.minins, np.int64)
        maxins = np.full(B, host.maxins, np.int64)
        for mate, fw in ((0, self.fw1), (1, not self.fw2)):
            t = np.fromiter((p[mate].trimmed5 if fw else p[mate].trimmed3
                             for p in rds), np.int64, B)
            minins = np.maximum(0, minins - t)
            maxins = np.maximum(0, maxins - t)
        q_c = np.zeros((B, 4, Lq), np.uint8)
        pen_c = np.zeros((B, 4, Lq), np.int32)
        qn_c = np.zeros((B, 4), np.int32)
        combos = ((0, self.fw1), (0, not self.fw1), (1, self.fw2),
                  (1, not self.fw2))
        for c, (mate, ofw) in enumerate(combos):
            lens = (l1 if mate == 0 else l2).astype(np.int64)
            rows = np.repeat(np.arange(B), lens)
            cols = np.arange(int(lens.sum())) - np.repeat(
                np.cumsum(lens) - lens, lens)
            codes = np.concatenate(
                [np.asarray(p[mate].codes_fw if ofw else p[mate].codes_rc,
                            np.uint8) for p in rds])
            quals = np.frombuffer(b"".join(
                p[mate].qual if ofw else p[mate].qual[::-1] for p in rds),
                np.uint8).astype(np.int32) - 33
            q_c[rows, c, cols] = codes
            pen_c[rows, c, cols] = QUAL_ROUNDS[quals] if host.ra.maq \
                else quals
            qn_c[np.unique(rows[codes > 3]), c] = 1
        qlen_c = np.stack([l1, l1, l2, l2], axis=1)
        alen_c = np.stack([l2, l2, l1, l1], axis=1)
        sol_c = np.tile(np.array([int(o) for _, o in combos], np.int32),
                        (B, 1))
        wok_c = (maxins[:, None] > np.maximum(qlen_c, alen_c)).astype(
            np.int32)
        return dict(q_c=q_c, pen_c=pen_c, qlen_c=qlen_c, alen_c=alen_c,
                    qn_c=qn_c, sol_c=sol_c, wok_c=wok_c,
                    minins=minins.astype(np.int32),
                    maxins=maxins.astype(np.int32))

    def ilv_inputs(self, pairs, items, seeds_all):
        """K13's inputs for (i, streams) items: the pairs whose mates are
        at most ILV_MAX_LEN bases become lanes, the others stay for the
        host replay.  seeds_all: mate 1's seed of every pair.  -> (S,
        init_state's lane state on the pair's device, lanes, host_items);
        S and the state are None without lanes."""
        lanes, host_items = [], []
        for i, streams in items:
            rd1, rd2 = pairs[i]
            (host_items if max(len(rd1.seq), len(rd2.seq))
             > self.ILV_MAX_LEN else lanes).append((i, streams))
        if not lanes:
            return None, None, lanes, host_items
        B = len(lanes)
        idx = [i for i, _ in lanes]
        Lq = 40 if max(max(len(pairs[i][0].seq), len(pairs[i][1].seq))
                       for i in idx) <= 40 else 64
        S, consts = self._ilv_static_consts(Lq)
        hits = np.zeros((B, 4, H_MAX, REC_W), np.int32)
        nrec = np.zeros((B, 4), np.int32)
        capped = np.zeros((B, 4), np.int32)
        for s in range(4):
            sls = [streams[s] for _, streams in lanes]
            ns = np.fromiter((len(x) for x in sls), np.int64, B)
            nrec[:, s] = ns
            capped[:, s] = [x.capped for x in sls]
            if ns.sum():
                rows = np.concatenate([np.asarray(x.rows, np.int64)
                                       for x in sls if len(x)])
                slot_i = np.arange(int(ns.sum())) - np.repeat(
                    np.cumsum(ns) - ns, ns)
                hits[np.repeat(np.arange(B), ns), s, slot_i] = rows
        dev = self.pair.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        seeds = t(seeds_all[np.asarray(idx, np.int64)].astype(np.int64))
        lane_consts = {k: t(v) for k, v in self._ilv_lane_consts(
            pairs, idx, Lq).items()}
        st = ilv_init_state(B, t(hits.reshape(B, -1)), t(nrec), t(capped),
                            seeds, {**lane_consts, **consts})
        return S, st, lanes, host_items

    def _ilv_run(self, pairs, items, seeds_all, rnd):
        """K13 over (i, streams) items (pe_device.py:869-968): -> (decided
        [(i, result)], escalated [i], host_items), counted in
        ilv_by_round["round <rnd>"]."""
        S, st, lanes, host_items = self.ilv_inputs(pairs, items, seeds_all)
        decided, escal = [], []
        if lanes:
            out, _ = run_ilv(self.pair, st, S)
            o = dict(zip(ILV_OUT_KEYS, stack_out(out).tolist()))
            for k, (i, streams) in enumerate(lanes):
                if o["escalate"][k]:
                    escal.append(i)
                else:
                    res = ({key: v[k] for key, v in o.items()}
                           if o["res_found"][k] else None)
                    decided.append((i, self._ilv_assemble(pairs[i], streams,
                                                          res)))
        c = self.ilv_by_round[f"round {rnd}"]
        c["decided"] += len(decided)
        c["escalated"] += len(escal)
        c["host"] += len(host_items)
        return decided, escal, host_items

    def _ilv_assemble(self, pair, streams, res):
        """The result of a pair K13 decided (pe_device.py:970-1031): res
        None, no pair; else the anchor's hit from its recorded range and
        the rescued mate's from the winning window position, as
        _resolve_outstanding's reporting tail builds them
        (best_paired.py), through the sink."""
        host = self._replay_state._host
        rd1, rd2 = pair
        sink = type(host.sink)(host.sink.policy, host.sink.global_seed)
        sink.reset(rd1, rd2)
        if res is None:
            return sink.finish()
        phase, side = res["res_phase"], res["res_side"]
        fr, _ = streams[res["res_slot"]].materialize(res["res_idx"])
        anchor_is_left = side > 0
        pair_fw = phase == 0
        fwL = self.fw1 if pair_fw else not self.fw2
        fwR = self.fw2 if pair_fw else not self.fw1
        out_is_1 = (not pair_fw) if anchor_is_left else pair_fw
        orr, ar = (rd1, rd2) if out_is_1 else (rd2, rd1)
        ofw = fwR if anchor_is_left else fwL
        tidx, toff, left = res["res_tidx"], res["res_toff"], res["res_left"]
        qlen = len(orr.seq)
        seq = np.asarray(orr.codes_fw if ofw else orr.codes_rc, np.uint8)
        seg = np.asarray(host.refs[tidx][left:left + qlen], np.uint8)
        mms = [(int(c), ord("ACGTN"[int(seg[c])]))
               for c in np.flatnonzero(seg != seq)]
        if not ofw:
            mms = [(qlen - 1 - p, ch) for p, ch in mms]
        oms = fr.bot - fr.top - 1
        a_mms = [(len(ar.seq) - pos - 1 if fr.ebwt_fw != fr.fw else pos,
                  ord("acgt"[refc])) for pos, refc in zip(fr.mms, fr.refcs)]
        anchor_hit = Hit(read=ar, fw=fr.fw, tidx=tidx, toff=toff, oms=oms,
                         stratum=fr.stratum, cost=fr.cost,
                         mms=sorted(a_mms), mate=2 if out_is_1 else 1)
        out_hit = Hit(read=orr, fw=ofw, tidx=tidx, toff=left, oms=oms,
                      stratum=res["res_strat"],
                      cost=(res["res_strat"] << 14) | res["res_ham"],
                      mms=sorted(mms), mate=1 if out_is_1 else 2)
        # match_right (anchor_is_left): the anchor is upstream
        up, dn = ((anchor_hit, out_hit) if anchor_is_left
                  else (out_hit, anchor_hit))
        up.mate = 1 if pair_fw else 2
        dn.mate = 2 if pair_fw else 1
        for h, o in ((up, dn), (dn, up)):
            h.mfw = o.fw
            h.mtidx = o.tidx
            h.mtoff = o.toff
            h.mlen = o.length
        sink.report_hit(up)
        sink.report_hit(dn)
        return sink.finish()

    def align_batch(self, pairs):
        """Record all four anchor streams of every pair, capped, in one
        launch; K13 decides the pairs it takes and the host replays the
        rest; then re-record uncapped the pairs that outran a capped
        stream and run K13 or the replay again.  Pairs with an
        overflowing lane, or that K13 escalates on uncapped streams,
        re-run on the live host drivers."""
        if not pairs:
            return []
        s1 = fill_seed_caches([p[0] for p in pairs], self.global_seed)
        plan = self.plan(pairs)
        results = [None] * len(pairs)

        def record_and_split(idxs, cap):
            sts, ovd = self._record_all(
                plan, idxs, s1[np.asarray(idxs, np.int64)], cap)
            items, fb_items = [], []
            for i in idxs:
                if ovd.get(i):
                    self.fallbacks += 1
                    fb_items.append((i, None))
                else:
                    items.append((i, sts[i]))
            for i, res, _ in self._replay_all(pairs, fb_items):
                results[i] = res
            return items

        def interleave(items, rnd):
            """K13 on what it takes: -> (items for the host replay, the
            pairs K13 escalated)."""
            if not self.use_ilv:
                return items, []
            decided, escal, items = self._ilv_run(pairs, items, s1, rnd)
            for i, res in decided:
                results[i] = res
            return items, escal

        # round 1: capped recordings, K13, the host replay of the rest
        items, escal = interleave(
            record_and_split(list(range(len(pairs))), self.rec_cap), 1)
        for i, res, esc in self._replay_all(pairs, items):
            if esc:
                escal.append(i)
            else:
                results[i] = res
        if escal:
            # round 2: the interleave outran a capped stream; re-record
            # those pairs to exhaustion and run them again
            escal.sort()
            self.escalations += len(escal)
            items, escal = interleave(record_and_split(escal, None), 2)
            # K13's budget or a saturated count: the live host drivers
            self.fallbacks += len(escal)
            items += [(i, None) for i in escal]
            for i, res, esc in self._replay_all(pairs, items):
                if esc:       # cannot happen on uncapped streams
                    self.fallbacks += 1
                    res, _ = self._replay_state.replay(*pairs[i], None)
                results[i] = res
        return results
