"""Paired --best and --pev2 on the card: bowtie's PairedBWAlignerV2
(aligner.h:1483-1998) with its merged driver stream recorded by K14.

A port of bowtie_tpu/align/pev2_device.py.  The V2 engine runs ONE
cost-merged CostAware driver over all (mate, strand) source groups; every
range it finds is chased and each resolved anchor row is mate-rescued in
reference space at once.  The merged driver is the best-first machine's
outer CostAware, so the card records the merged stream directly:

1. RECORD (card): one lane per pair runs K14, the best-first machine in
   paired record mode (align/best_device.py run_machine with record=True,
   paired=True; csrc/best.cu's paired instantiation), over a driver DAG
   that merges mate 1's groups and mate 2's (range_source.h:2084).  Each
   outer reads its own mate's length and seed (qlen_o, seed_o), the
   strandFix scan matches mates (range_source.h:2322-2327), and the mate
   elimination (range_source.h:2233) ends the stream where the host
   driver dies.  Each record carries the driver's min cost at the host's
   last pruning check before the emission (aligner.h:1638-1681) in slot
   MIN_SLOT: min cost never falls, so that one value decides the replay's
   pruning.  K11 (best_pack) packs the records for one download.
2. REPLAY (host, V2Replayer): the V2 control loop
   (best_paired.PairedBestAlignerV2.align_pair) over the recorded
   stream: the pruning by the recorded pre-advance min cost, then the
   chase and resolveOutstandingInRef tail of the host engine unchanged,
   so the output is byte-identical.  With threads > 1 a fork pool splits
   the replay and the host engine's re-runs.

A pair whose replay outruns a capped stream (rec_cap 8, for policies that
stop early) is recorded again uncapped (`escalations`).  A pair whose lane
overflows (the hit pool, the mismatch slots, the step budget), or with a
mate under 4 or over 255 bases, runs on the host V2 engine
(`fallbacks`), as does every pair under --reportse, whose removeMate
feedback changes the live driver's RNG sequence mid-run.

Left out: dryrun_pev2 (a multi-device dry run on files this port does not
ship), the _bucket lane padding, and run_compacting's chunk schedule and
lane compaction (each thread of K14 runs its own pair to the end); the
compact layout is a constructor argument, not BOWTIE_TPU_COMPACT.
"""
from __future__ import annotations

import gc
import multiprocessing as mp
import os

import numpy as np
import torch

from .best import FoundRange
from .best_device import (INF32, MM_SLOTS, PEX, HostInit,
                          _host_sort_actives, best_pack, run_machine,
                          seeded_mode_configs, unpack_harvest,
                          v_mode_configs)
from .best_factories import _pe_do_matrix, make_paired_best_aligner_v2
from .dfs_device import _len_bucket, build_fmpair
from .golden import GoldenFM
from .policy import KPolicy
from ..utils.rng import BtRandom, fill_seed_caches

REC_W = 8 + 2 * MM_SLOTS
MIN_SLOT = 8 + MM_SLOTS - 1     # the edit-depth pad slot: pre-advance min

# the per-flat-driver, per-outer and per-branch-slot host arrays that
# build_paired splices by mate
_NDT_KEYS = ("dqlen", "dd5", "dd3", "rows_qp", "drv_adj", "drv_done",
             "drv_found", "drv_min", "drv_nextid", "rr")
_ND_KEYS = ("od_done", "od_found", "od_min")
_P_KEYS = ("p_valid", "p_drv", "p_cost", "p_ham", "p_rdepth", "p_len",
           "p_top", "p_bot", "p_curt", "p_dly", "p_dlyf", "p_id",
           "p_ne", "p_d0", "p_d1", "p_d2", "p_d3")


class PairedV2Machine:
    """The merged-DAG record machine for one configuration, on `pair`'s
    device."""

    def __init__(self, pair, idx_fw, idx_bw, mode, v, seed_mms, seed_len,
                 qual_cutoff, maq, qual_order, maxbts, max_steps, nofw,
                 norc, fw1, fw2):
        self.pair = pair
        # drVec construction order (aligner_0mm.h:323-339 for -v;
        # aligner_seed_mm.h:700-703 for -n, whose four vectors alias
        # dr1FwVec)
        order = ([(True, True), (True, False), (False, True),
                  (False, False)] if mode != "n" else
                 [(True, True), (False, True), (True, False),
                  (False, False)])
        do = _pe_do_matrix(nofw, norc, fw1, fw2)
        outers = []
        self.o_mate1: list[bool] = []
        for mate1, fw in order:
            if not do[(mate1, fw)]:
                continue
            if mode == "n":
                grp = seeded_mode_configs(seed_mms, not fw, fw)
            else:
                grp = v_mode_configs(v, not fw, fw)
            outers.extend(grp)
            self.o_mate1 += [mate1] * len(grp)
        if mode == "n":
            self.qual_lim = qual_cutoff
            self.bt_on = seed_mms >= 2
            sl = seed_len
        else:
            self.qual_lim = INF32
            self.bt_on = False
            sl = 0
        self.has_seeded = mode == "n"
        self.hostinit = HostInit(outers, idx_fw, idx_bw, maq, qual_order,
                                 self.qual_lim, sl)
        # each outer's mate, for the strandFix scan and mate elimination
        self.hostinit.cfg["o_m1"] = np.array(
            [int(m1) for m1 in self.o_mate1], np.int32)
        # each flat driver's mate (the splice and rng_rs)
        flat_m1 = []
        for oc, m1 in zip(outers, self.o_mate1):
            flat_m1 += [m1] * (1 if oc.kind == "plain" else 1 + PEX)
        self.flat_m1 = np.array(flat_m1, bool)
        self.out_m1 = np.array(self.o_mate1, bool)
        # branch slot -> flat driver (HostInit.build's slot order)
        self.slot_flat = [f for f in range(len(self.hostinit.flat))
                          if not self.hostinit.cfg["is_ext"][f]]
        self.qual_order = qual_order
        self.maxbts = maxbts
        self.max_steps = max_steps

    def build_paired(self, reads1, reads2, L, seeds1, seeds2):
        """HostInit.build for the merged DAG: one build per mate over the
        same merged outer list, every per-driver table then spliced by its
        driver's mate; the initial sortActives run again on the merged
        outers with mate 1's seed (the paired CostAware's RNG,
        range_source.h:2084); each outer's read length and seed and each
        flat driver's RNG seed taken from its mate."""
        hi = self.hostinit
        h1 = hi.build(reads1, L, seeds1)
        h2 = hi.build(reads2, L, seeds1)
        B = len(reads1)
        nd, ndt = hi.nd, hi.ndt
        host = dict(h1)
        fm1, om1 = self.flat_m1, self.out_m1
        for k in _NDT_KEYS:
            sel = fm1.reshape((1, ndt) + (1,) * (h1[k].ndim - 2))
            host[k] = np.where(sel, h1[k], h2[k])
        for k in _ND_KEYS:
            host[k] = np.where(om1[None, :], h1[k], h2[k])
        slot_m1 = np.ones(h1["p_valid"].shape[1], bool)
        for s, f in enumerate(self.slot_flat):
            slot_m1[s] = fm1[f]
        for k in _P_KEYS:
            host[k] = np.where(slot_m1[None, :], h1[k], h2[k])
        act = np.tile(np.arange(nd, dtype=np.int32), (B, 1))
        act_n = np.full(B, nd, np.int32)
        act, act_n, rng_ca, ca_min = _host_sort_actives(
            act, act_n, host["od_done"], host["od_found"], host["od_min"],
            seeds1.astype(np.uint32).copy(), np.zeros(B, np.int32))
        host.update(act=act, act_n=act_n, rng_ca=rng_ca, ca_min=ca_min)
        q1 = h1["qlen"].astype(np.int32)
        q2 = h2["qlen"].astype(np.int32)
        host["qlen_o"] = np.where(om1[None, :], q1[:, None], q2[:, None])
        host["seed_o"] = np.where(om1[None, :], seeds1[:, None],
                                  seeds2[:, None]).astype(np.uint32)
        host["rng_rs"] = np.where(fm1[None, :], seeds1[:, None],
                                  seeds2[:, None]).astype(np.uint32)
        return host

    def record_inputs(self, pairs, seeds1, seeds2):
        """run_machine's arguments (but rec_cap) for the pairs the machine
        takes, those whose mates have 4-255 bases.  -> dict(args=, kw=,
        take=: their indexes into pairs)."""
        take = np.array([b for b, (r1, r2) in enumerate(pairs)
                         if 4 <= min(len(r1.seq), len(r2.seq))
                         and max(len(r1.seq), len(r2.seq)) <= 255],
                        np.int64)
        if not len(take):
            return dict(args=None, kw=None, take=take)
        sub = [pairs[b] for b in take]
        L = _len_bucket(max(max(len(r1.seq), len(r2.seq))
                            for r1, r2 in sub))
        host = self.build_paired([p[0] for p in sub], [p[1] for p in sub],
                                 L, seeds1[take], seeds2[take])
        seeds = torch.from_numpy(seeds1[take].astype(np.int64))
        hi = self.hostinit
        return dict(
            args=(self.pair, hi.cfg, host, seeds.to(self.pair.device)),
            kw=dict(L=L, nd=hi.nd, ndt=hi.ndt, maxbts=self.maxbts,
                    n_k=INF32, m_max=INF32, strata=False,
                    qual_lim=self.qual_lim, qual_order=self.qual_order,
                    bt_on=self.bt_on, has_seeded=self.has_seeded,
                    max_steps=self.max_steps, record=True, paired=True),
            take=take)

    def record(self, pairs, seeds1, seeds2, rec_cap=None):
        """Record the merged stream of every pair: one K14 launch, then
        K11 and one download.  -> (streams, overflow): streams[i] is an
        [n, REC_W] array of records, None where the lane overflowed or the
        machine does not take the pair (overflow True)."""
        B = len(pairs)
        overflow = np.ones(B, bool)
        streams = [None] * B
        a = self.record_inputs(pairs, seeds1, seeds2)
        take = a["take"]
        if len(take):
            out, _ = run_machine(*a["args"], **a["kw"], rec_cap=rec_cap)
            h = unpack_harvest(best_pack(out).cpu().numpy(), len(take))
            for j, b in enumerate(take.tolist()):
                overflow[b] = bool(h["overflow"][j])
                if not overflow[b]:
                    streams[b] = h["hits"][j, :int(h["nhits"][j])]
        return streams, overflow


# Set in the parent right before the replay pool forks; children inherit
# it copy-on-write.  It holds only host state (the V2 host engine, the
# merged outers' tables, numpy streams): a forked child must never touch
# CUDA.
_V2_WORKER = None


def _v2_replay_worker(chunk):
    return [(i, _V2_WORKER.replay(rd1, rd2, rows, capped))
            for i, rd1, rd2, rows, capped in chunk]


class V2Replayer:
    """The replay's host state, which the fork pool's children inherit:
    the V2 host engine, whose control loop runs over a recorded stream or,
    for a pair with none, live, and each merged outer's mate and
    strands."""

    def __init__(self, host, machine: PairedV2Machine, global_seed: int):
        cfg = machine.hostinit.cfg
        self.host = host
        self.o_mate1 = list(machine.o_mate1)
        self.o_fw = [bool(x) for x in cfg["o_fw"]]
        self.o_chase_efw = [bool(x) for x in cfg["o_chase_efw"]]
        self.global_seed = global_seed

    def materialize(self, rec, qlen_of):
        """A record -> the FoundRange the live merged driver gives."""
        drv = int(rec[0])
        mate1 = bool(self.o_mate1[drv])
        qlen = qlen_of(mate1)
        ne = int(rec[5])
        return FoundRange(top=int(rec[1]), bot=int(rec[2]),
                          cost=int(rec[3]), stratum=int(rec[4]),
                          num_mms=ne, fw=self.o_fw[drv],
                          ebwt_fw=self.o_chase_efw[drv],
                          mms=[qlen - int(rec[8 + k]) - 1
                               for k in range(ne)],
                          refcs=[int(rec[8 + MM_SLOTS + k])
                                 for k in range(ne)],
                          mate1=mate1)

    def replay(self, rd1, rd2, rows, capped):
        """The V2 control loop (PairedBestAlignerV2.align_pair) over the
        recorded stream `rows`, or the host engine whole when rows is
        None.  -> the pair's ReadResult, or None when the replay outran a
        capped stream (the caller records it again uncapped)."""
        host = self.host
        if rows is None:
            return host.align_pair(rd1, rd2)
        host.sink.reset(rd1, rd2)
        host.se1 = host.se2 = None
        if len(rd1.seq) < 4 or len(rd2.seq) < 4:
            return host._finish()
        host.rd1, host.rd2 = rd1, rd2
        host.rand = BtRandom(int(rd1.seed(self.global_seed)))
        host.donePe = host.doneSe1 = host.doneSe2 = False
        host.mixed_attempts = 0
        host.pairs_fw = set()
        host.pairs_rc = set()
        host.done = False
        host.driver = None

        def qlen_of(mate1):
            return len(rd1.seq) if mate1 else len(rd2.seq)

        n = len(rows)
        truncated = capped and n > 0 and int(rows[-1][6]) == 2
        for t in range(n):
            rec = rows[t]
            if t > 0:
                # minCost pruning between advances (aligner.h:1638-1681):
                # min cost never falls, so the last recorded pre-advance
                # value decides every check in between at once; with no
                # SE holds, donePe stops the pair
                host.donePe = host.sink.irrelevant_cost(int(rec[MIN_SLOT]))
                if host.donePe:
                    return host._finish()
            host._chase(self.materialize(rec, qlen_of))
            if host.done or int(rec[6]) == 1:     # the driver done at it
                return host._finish()
        if truncated:
            return None
        return host._finish()


class DevicePairedV2Aligner:
    """The paired V2 aligner with the merged stream recorded on `device`
    (default CUDA): align_batch(pairs) gives what
    make_paired_best_aligner_v2's product gives.

    threads > 1 forks a pool for the host replay and the host engine's
    re-runs (the -p analog of the reference's per-thread aligner graphs,
    ebwt_search.cpp:1333), as DevicePairedBestAligner does: the pool forks
    in the constructor, after the host state is built and before this
    aligner allocates anything on the card, and its children run only
    V2Replayer, on numpy; close() stops it."""

    DENSE_LIMIT = 1 << 28

    def __init__(self, idx_fw, idx_bw, refs, policy: KPolicy,
                 mode: str = "n", v: int = 0, seed_mms: int = 2,
                 seed_len: int = 28, qual_cutoff: int = 70,
                 fw1: bool = True, fw2: bool = False,
                 min_insert: int = 0, max_insert: int = 250,
                 pairtries: int = 100, nofw: bool = False,
                 norc: bool = False, maq: bool = True,
                 better: bool = False, report_se: bool = False,
                 best_sink: bool = True, global_seed: int = 0,
                 maxbts: int = 800, max_steps: int = 60000,
                 compact: bool | None = None, threads: int = 1,
                 device=None):
        global _V2_WORKER
        if idx_fw.length >= (1 << 31):
            raise ValueError(
                f"the best-first machine compares rows as signed int32; "
                f"joined length {idx_fw.length:,} >= 2^31 routes to the "
                f"host engine")
        # the machine's card tables come after the fork (self.pair)
        self.machine = PairedV2Machine(
            None, idx_fw, idx_bw, mode, v, seed_mms, seed_len,
            qual_cutoff, maq, not better, maxbts, max_steps, nofw, norc,
            fw1, fw2)
        self.global_seed = global_seed
        self.report_se = report_se
        self.replayer = V2Replayer(make_paired_best_aligner_v2(
            GoldenFM(idx_fw), GoldenFM(idx_bw), refs, policy, mode=mode,
            v=v, seed_mms=seed_mms, seed_len=seed_len,
            qual_cutoff=qual_cutoff, fw1=fw1, fw2=fw2,
            min_insert=min_insert, max_insert=max_insert,
            pairtries=pairtries, nofw=nofw, norc=norc, maq=maq,
            better=better, report_se=report_se, best_sink=best_sink,
            global_seed=global_seed, maxbts=maxbts), self.machine,
            global_seed)
        self.threads = max(1, min(threads, os.cpu_count() or 1))
        self._pool = None
        if self.threads > 1 and hasattr(os, "fork"):
            _V2_WORKER = self.replayer
            gc.collect()       # no pending garbage a child could free
            self._pool = mp.get_context("fork").Pool(self.threads)
        if compact is None:
            compact = idx_fw.length > self.DENSE_LIMIT
        self.pair = self.machine.pair = build_fmpair(
            idx_fw, idx_bw, device, dense_sa=not compact)
        self.fallbacks = 0
        self.escalations = 0
        # --reportse's removeMate feedback changes the live driver's RNG
        # sequence mid-run, which no recorded stream reproduces
        self.use_device = not report_se
        # the -k 1 replay usually consumes few ranges; a pair that
        # outruns the capped stream is recorded again uncapped
        self.rec_cap = None if policy.want_all_rows() else 8

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _replay_all(self, pairs, items):
        """Replay (i, rows, capped) items -> [(i, result)], in order; rows
        None runs the pair on the V2 host engine.  The fork pool (threads
        > 1) splits the items across processes."""
        if self._pool is not None and len(items) >= 2 * self.threads:
            work = [(i, *pairs[i], rows, capped)
                    for i, rows, capped in items]
            nchunks = min(len(work), self.threads * 4)
            size = -(-len(work) // nchunks)
            chunks = [work[k:k + size] for k in range(0, len(work), size)]
            out = []
            for part in self._pool.map(_v2_replay_worker, chunks):
                out.extend(part)
            return out
        return [(i, self.replayer.replay(*pairs[i], rows, capped))
                for i, rows, capped in items]

    def align_batch(self, pairs):
        if not pairs:
            return []
        if not self.use_device:
            return [r for _, r in self._replay_all(
                pairs, [(i, None, False) for i in range(len(pairs))])]
        s1 = fill_seed_caches([p[0] for p in pairs], self.global_seed)
        s2 = fill_seed_caches([p[1] for p in pairs], self.global_seed)
        results = [None] * len(pairs)
        streams, _ov = self.machine.record(pairs, s1, s2,
                                           rec_cap=self.rec_cap)
        # an overflowing lane's pair (rows None) runs on the host engine
        self.fallbacks += sum(rows is None for rows in streams)
        capped = self.rec_cap is not None
        escal = []
        for i, res in self._replay_all(
                pairs, [(i, rows, capped) for i, rows in enumerate(streams)]):
            if res is None:
                escal.append(i)
            else:
                results[i] = res
        if escal:
            self.escalations += len(escal)
            ix = np.asarray(escal, np.int64)
            streams, _ov = self.machine.record(
                [pairs[i] for i in escal], s1[ix], s2[ix], rec_cap=None)
            self.fallbacks += sum(rows is None for rows in streams)
            for i, res in self._replay_all(
                    pairs, [(i, rows, False)
                            for i, rows in zip(escal, streams)]):
                assert res is not None
                results[i] = res
        return results

    def align_pair_host(self, rd1, rd2):
        return self.replayer.replay(rd1, rd2, None, False)
