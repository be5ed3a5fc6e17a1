"""Per-read phase orchestration for -v 0/1/2/3 modes (oracle path).

Mirrors the full-index workers in ebwt_search.cpp:
- exactSearchWorker + search_exact.c               (-v 0)
- mismatchSearchWorkerFull + search_1mm_phase1/2.c (-v 1)
- twoOrThreeMismatchSearchWorkerFull + search_23mm_phase1/2/3.c (-v 2/3)

Each read runs its phases to completion against the fw and mirror
indexes, with a shared per-read sink implementing -k/-a/-m counting
(NGoodHitSinkPerThread semantics).  A copy of bowtie_tpu/align/drivers.py;
the DFS machine re-runs its overflowing lanes here.
"""
from __future__ import annotations

from .backtrack_oracle import GreedyDFS, INF32
from .golden import GoldenFM
from .policy import KPolicy, ReadResult
from .types import Hit


class OracleSink:
    """NGood/All hit-sink semantics for one read at a time
    (hit.h:937-992 + finishRead :741-787)."""

    def __init__(self, policy: KPolicy, global_seed: int = 0):
        self.policy = policy
        self.global_seed = global_seed
        self.reset(None)

    def reset(self, read):
        self.read = read
        self.count = 0
        self.buffered: list[Hit] = []
        self.stopped = False

    def report_hit(self, read, fw, ebwt_fw, qry, mms, refcs, num_mms,
                   tidx, toff, top, bot, stratum, cost, qlen) -> bool:
        """EbwtSearchParams::reportHit (ebwt.h:1287-1404) +
        NGoodHitSinkPerThread::reportHit (hit.h:969-985).
        Returns True iff the search should stop."""
        self.count += 1
        if self.count > self.policy.max:
            return True   # maxed: stop now, report nothing later
        # transform mismatch positions to 5'-of-original-read indices
        hit_mms = []
        for pos, refc in zip(mms[:num_mms], refcs[:num_mms]):
            off = qlen - pos - 1 if (ebwt_fw != fw) else pos
            hit_mms.append((off, ord("acgt"[refc])))
        self.buffered.append(Hit(
            read=read, fw=fw, tidx=tidx, toff=toff,
            oms=bot - top - 1, stratum=stratum, cost=cost,
            mms=sorted(hit_mms)))
        n, mx = self.policy.n, self.policy.max
        if self.count == n and (mx == INF32 or mx < n):
            return True
        return False

    def finished_with_stratum(self, stratum: int) -> bool:
        return False   # NGood/All never short-circuit (hit.h:989)

    def finish(self) -> ReadResult:
        seed = int(self.read.seed(self.global_seed)) if self.read else 0
        return self.policy.finish(self.buffered, self.count, seed)


def make_backtracker(fm: GoldenFM, ebwt_fw: bool, sink, joined=None,
                     **kw) -> GreedyDFS:
    return GreedyDFS(fm, ebwt_fw, sink, joined_resolver=joined, **kw)


def to_muts(pal, seq_codes, qual: bytes, maq: bool):
    """PartialAlignmentManager::toMutsString (ebwt_search_util.h:310):
    translate partial-alignment entries (search-query coords) into
    full-read mutations + the summed quality penalty already spent."""
    from .backtrack_oracle import mm_penalty
    plen = len(seq_codes)
    muts = []
    oldq = 0
    for pos, ch in pal.muts:
        tpos = plen - 1 - pos
        oldq += mm_penalty(maq, qual[tpos] - 33)
        muts.append((tpos, ch))
    return muts, oldq


class OracleAligner:
    """Slow-but-exact aligner driving the GreedyDFS oracle per read."""

    def __init__(self, fm_fw: GoldenFM, fm_bw: GoldenFM | None,
                 policy: KPolicy, mode: str = "v0", v: int = 0,
                 nofw: bool = False, norc: bool = False,
                 global_seed: int = 0, joined=None,
                 seed_mms: int = 2, seed_len: int = 28,
                 qual_thresh: int = 70, maxbts: int = 125,
                 maq_round: bool = True):
        self.fm_fw, self.fm_bw = fm_fw, fm_bw
        self.policy = policy
        self.mode, self.v = mode, v
        self.nofw, self.norc = nofw, norc
        self.sink = OracleSink(policy, global_seed)
        self.joined = joined
        self.seed_mms, self.seed_len = seed_mms, seed_len
        self.qual_thresh = qual_thresh
        self.maxbts = maxbts
        self.maq_round = maq_round

    def align_batch(self, reads) -> list[ReadResult]:
        return [self.align_read(r) for r in reads]

    def align_read(self, read) -> ReadResult:
        sink = self.sink
        sink.reset(read)
        if self.mode == "n":
            self._run_n(read, sink)
        elif self.v == 0:
            self._run_v0(read, sink)
        elif self.v == 1:
            self._run_v1(read, sink)
        else:
            self._run_v23(read, sink, two=(self.v == 2))
        return sink.finish()

    # -- search_seeded_phase1-4.c (-n mode) ------------------------------
    def _run_n(self, read, sink):
        n_mms, s = self.seed_mms, self.seed_len
        plen = len(read.seq)
        s3, s5 = s >> 1, (s >> 1) + (s & 1)
        qs = min(plen, s)
        qs3, qs5 = qs >> 1, (qs >> 1) + (qs & 1)
        qt, mb, mr = self.qual_thresh, self.maxbts, self.maq_round
        mk = make_backtracker

        # phase 1 gate: too short / too many seed Ns -> no alignments
        if plen < 4:
            return
        slen = min(plen, s)
        if int((read.codes_fw[:slen] == 4).sum()) > n_mms:
            return

        pam_rc: list = []
        pam_fw: list = []

        btf1 = mk(self.fm_fw, True, sink, consider_quals=False,
                  qual_thresh=qt, max_bts=mb, maq_penalty=mr)
        bt1 = mk(self.fm_fw, True, sink, consider_quals=True,
                 qual_thresh=qt, max_bts=mb, maq_penalty=mr)
        # phase 1
        if not self.nofw:
            btf1.set_query(read, True)
            btf1.set_offs(0, plen, plen, plen, plen, plen)
            if btf1.backtrack():
                return
        if not self.norc:
            bt1.set_query(read, False)
            if qs < s:
                bt1.set_offs(0, 0, qs5 if n_mms > 0 else qs,
                             qs5 if n_mms > 1 else qs,
                             qs5 if n_mms > 2 else qs,
                             qs5 if n_mms > 3 else qs)
            else:
                bt1.set_offs(0, 0, s5 if n_mms > 0 else s,
                             s5 if n_mms > 1 else s,
                             s5 if n_mms > 2 else s,
                             s5 if n_mms > 3 else s)
            if bt1.backtrack():
                return
        if self.nofw and sink.finished_with_stratum(0):
            return

        # phase 2 (mirror index)
        btf2 = mk(self.fm_bw, False, sink, consider_quals=True,
                  qual_thresh=qt, max_bts=mb, maq_penalty=mr,
                  report_exacts=False)
        if not self.nofw:
            btf2.set_query(read, True)
            if qs < s:
                btf2.set_offs(0, 0, qs5 if n_mms > 0 else qs,
                              qs5 if n_mms > 1 else qs,
                              qs5 if n_mms > 2 else qs,
                              qs5 if n_mms > 3 else qs)
            else:
                btf2.set_offs(0, 0, s5 if n_mms > 0 else s,
                              s5 if n_mms > 1 else s,
                              s5 if n_mms > 2 else s,
                              s5 if n_mms > 3 else s)
            if btf2.backtrack():
                return
            if sink.finished_with_stratum(0):
                return
        if n_mms == 0:
            return
        if not self.norc:
            btr2 = mk(self.fm_bw, False, sink, consider_quals=True,
                      qual_thresh=qt, max_bts=mb, maq_penalty=mr,
                      report_partials=n_mms, report_exacts=False,
                      partials_out=pam_rc)
            btr2.set_query(read, False)
            btr2.set_qlen(s)
            if qs < s:
                btr2.set_offs(0, 0, qs3,
                              qs3 if n_mms > 1 else qs,
                              qs3 if n_mms > 2 else qs,
                              qs3 if n_mms > 3 else qs)
            else:
                btr2.set_offs(0, 0, s3,
                              s3 if n_mms > 1 else s,
                              s3 if n_mms > 2 else s,
                              s3 if n_mms > 3 else s)
            btr2.backtrack()

        # phase 3: extend 4R partials on fw index; then rc half-and-half
        if not self.norc:
            btr3 = mk(self.fm_fw, True, sink, consider_quals=True,
                      qual_thresh=qt, max_bts=mb, maq_penalty=mr)
            btr3.set_query(read, False)
            done = False
            if pam_rc:
                if qs < s:
                    btr3.set_offs(0, 0, qs, qs, qs, qs)
                else:
                    btr3.set_offs(0, 0, s, s, s, s)
                for pal in pam_rc:
                    muts, oldq = to_muts(pal, read.codes_rc,
                                         read.qual[::-1], mr)
                    btr3.set_muts(muts)
                    done = btr3.backtrack(oldq)
                    btr3.set_muts(None)
                    if done:
                        return
            if n_mms >= 2:
                btr23 = mk(self.fm_fw, True, sink, consider_quals=True,
                           qual_thresh=qt, max_bts=mb, maq_penalty=mr,
                           half_and_half=True)
                btr23.set_query(read, False)
                if qs < s:
                    btr23.set_offs(qs5, qs, 0,
                                   qs5 if n_mms <= 2 else 0,
                                   qs if n_mms < 3 else qs5, qs)
                else:
                    btr23.set_offs(s5, s, 0,
                                   s5 if n_mms <= 2 else 0,
                                   s if n_mms < 3 else s5, s)
                if btr23.backtrack():
                    return
        if self.nofw:
            return
        # phase 3 tail: collect 4F partials on fw index (seed only)
        btf3 = mk(self.fm_fw, True, sink, consider_quals=True,
                  qual_thresh=qt, max_bts=mb, maq_penalty=mr,
                  report_partials=n_mms, partials_out=pam_fw)
        btf3.set_query(read, True)
        btf3.set_qlen(s)
        if qs < s:
            btf3.set_offs(0, 0, qs3,
                          qs3 if n_mms > 1 else qs,
                          qs3 if n_mms > 2 else qs,
                          qs3 if n_mms > 3 else qs)
        else:
            btf3.set_offs(0, 0, s3,
                          s3 if n_mms > 1 else s,
                          s3 if n_mms > 2 else s,
                          s3 if n_mms > 3 else s)
        btf3.backtrack()

        # phase 4: extend 4F partials on mirror index; fw half-and-half
        btf4 = mk(self.fm_bw, False, sink, consider_quals=True,
                  qual_thresh=qt, max_bts=mb, maq_penalty=mr)
        btf4.set_query(read, True)
        if pam_fw:
            if qs < s:
                btf4.set_offs(0, 0, qs, qs, qs, qs)
            else:
                btf4.set_offs(0, 0, s, s, s, s)
            for pal in pam_fw:
                muts, oldq = to_muts(pal, read.codes_fw[::-1],
                                     read.qual[::-1], mr)
                btf4.set_muts(muts)
                done = btf4.backtrack(oldq)
                btf4.set_muts(None)
                if done:
                    return
        if sink.finished_with_stratum(1):
            return
        if n_mms >= 2:
            btf24 = mk(self.fm_bw, False, sink, consider_quals=True,
                       qual_thresh=qt, max_bts=mb, maq_penalty=mr,
                       half_and_half=True)
            btf24.set_query(read, True)
            if qs < s:
                btf24.set_offs(qs5, qs, 0,
                               qs5 if n_mms <= 2 else 0,
                               qs if n_mms < 3 else qs5, qs)
            else:
                btf24.set_offs(s5, s, 0,
                               s5 if n_mms <= 2 else 0,
                               s if n_mms < 3 else s5, s)
            btf24.backtrack()

    # -- search_exact.c -------------------------------------------------
    def _run_v0(self, read, sink):
        bt = make_backtracker(self.fm_fw, True, sink, self.joined,
                              consider_quals=False)
        s = len(read.seq)
        if not self.nofw:
            bt.set_query(read, True)
            bt.set_offs(0, 0, s, s, s, s)
            if bt.backtrack():
                return
        if not self.norc:
            bt.set_query(read, False)
            bt.set_offs(0, 0, s, s, s, s)
            bt.backtrack()

    # -- search_1mm_phase1/2.c -------------------------------------------
    def _run_v1(self, read, sink):
        s = len(read.seq)
        s3 = s >> 1
        s5 = s3 + (s & 1)
        btF = make_backtracker(self.fm_fw, True, sink, self.joined,
                               consider_quals=False)
        # phase 1 (fw index)
        if not self.nofw:
            btF.set_query(read, True)
            btF.set_offs(0, 0, s, s, s, s)
            if btF.backtrack():
                return
        if not self.norc:
            btF.set_query(read, False)
            btF.set_offs(0, 0, s, s, s, s)
            if btF.backtrack():
                return
        if sink.finished_with_stratum(0):
            return
        btF.report_exacts = False
        if not self.norc:
            btF.set_query(read, False)
            btF.set_offs(0, 0, s5, s, s, s)
            if btF.backtrack():
                return
        if not self.nofw:
            btF.set_query(read, True)
            btF.set_offs(0, 0, s5, s, s, s)
            if btF.backtrack():
                return
        # phase 2 (mirror index)
        btB = make_backtracker(self.fm_bw, False, sink, self.joined,
                               consider_quals=False,
                               report_exacts=False)
        if not self.norc:
            btB.set_query(read, False)
            btB.set_offs(0, 0, s3, s, s, s)
            if btB.backtrack():
                return
        if not self.nofw:
            btB.set_query(read, True)
            btB.set_offs(0, 0, s3, s, s, s)
            if btB.backtrack():
                return

    # -- search_23mm_phase1/2/3.c ------------------------------------------
    def _run_v23(self, read, sink, two: bool):
        s = len(read.seq)
        s3 = s >> 1
        s5 = s3 + (s & 1)
        btr1 = make_backtracker(self.fm_fw, True, sink, self.joined,
                                consider_quals=False)
        # phase 1 (fw index)
        if not self.nofw:
            btr1.set_query(read, True)
            btr1.set_offs(0, 0, s, s, s, s)
            if btr1.backtrack():
                return
        if not self.norc:
            btr1.set_query(read, False)
            btr1.set_offs(0, 0, s5, s5, s if two else s5, s)
            if btr1.backtrack():
                return
        if self.nofw and sink.finished_with_stratum(0):
            return
        # phase 2 (mirror index)
        bt2 = make_backtracker(self.fm_bw, False, sink, self.joined,
                               consider_quals=False, report_exacts=False)
        if not self.nofw:
            bt2.set_query(read, True)
            bt2.set_offs(0, 0, s5, s5, s if two else s5, s)
            if bt2.backtrack():
                return
            if sink.finished_with_stratum(0):
                return
        if not self.norc:
            bt2.set_query(read, False)
            bt2.set_offs(0, 0, s3, s3, s if two else s3, s)
            if bt2.backtrack():
                return
        if self.nofw and sink.finished_with_stratum(1):
            return
        # phase 3 (fw index + half-and-half)
        bt3 = make_backtracker(self.fm_fw, True, sink, self.joined,
                               consider_quals=False, report_exacts=False)
        bthh3 = make_backtracker(self.fm_fw, True, sink, self.joined,
                                 consider_quals=False,
                                 half_and_half=True)
        if not self.nofw:
            bt3.set_query(read, True)
            bt3.set_offs(0, 0, s3, s3, s if two else s3, s)
            if bt3.backtrack():
                return
            if sink.finished_with_stratum(1):
                return
            bthh3.set_query(read, True)
            bthh3.set_offs(s3, s, 0, s3 if two else 0,
                           s if two else s3, s)
            done = bthh3.backtrack()
            bthh3.num_bts = 0
            if done:
                return
        if not self.norc:
            bthh3.set_query(read, False)
            bthh3.set_offs(s5, s, 0, s5 if two else 0,
                           s if two else s5, s)
            done = bthh3.backtrack()
            bthh3.num_bts = 0
            if done:
                return
