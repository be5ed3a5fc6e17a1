"""Stateful paired-end aligner (PairedBWAlignerV1, aligner.h:606-1480).

Anchor ranges stream best-first from four per-(mate,strand) drivers;
each resolved anchor row triggers a reference-space rescue of the
outstanding mate (RefAligner::find — zig-zag-from-the-middle window
scan, ref_aligner.h:204-212, with first-hit-wins and the upstream/
downstream dedup set, :441-460).

A copy of bowtie_tpu/align/best_paired.py: V1 (PairedBestAligner, whose
interleave align/pe_device.py replays over streams the card recorded)
and V2 (PairedBestAlignerV2, with the --reportse SEHoldSink), both on the
host drivers of align/best_driver.py.
"""
from __future__ import annotations

import numpy as np

from .backtrack_oracle import QUAL_ROUNDS
from .best import ADV_FOUND_RANGE, FoundRange
from .policy import INF, KPolicy, ReadResult
from .types import Hit
from ..utils.rng import BtRandom

INF32 = 0xFFFFFFFF


def _trim_adjusted_insert(minins, maxins, rd1, rd2, fw1, fw2):
    """-I/-X apply to the RAW reads: shrink the limits by the trimming
    applied to each mate's outer end (resolveOutstandingInRef,
    aligner.h:983-999)."""
    if fw1:
        minins = max(0, minins - rd1.trimmed5)
        maxins = max(0, maxins - rd1.trimmed5)
    else:
        minins = max(0, minins - rd1.trimmed3)
        maxins = max(0, maxins - rd1.trimmed3)
    if fw2:
        minins = max(0, minins - rd2.trimmed3)
        maxins = max(0, maxins - rd2.trimmed3)
    else:
        minins = max(0, minins - rd2.trimmed5)
        maxins = max(0, maxins - rd2.trimmed5)
    return minins, maxins


class RefAlignerPy:
    """RefAligner::find family: scan a window for the outstanding mate,
    zig-zag outward from the middle, first `num_to_find` hits win.

    -v modes (Exact/OneMM/TwoMM/ThreeMM): at most v mismatches, no
    quality budget, stratum = #mms.
    seeded (-n) modes (Seed0-3): at most n mismatches in the first
    seed_len 5'-bases AND total (rounded) penalty <= qual_max;
    stratum = seed mms.
    """

    def __init__(self, v: int | None = None, seed_mms: int = 2,
                 seed_len: int = 28, qual_max: int = 70,
                 maq_round: bool = True):
        self.v = v
        self.seed_mms, self.seed_len = seed_mms, seed_len
        self.qual_max = qual_max
        self.maq = maq_round

    def score(self, ref: np.ndarray, qry: np.ndarray, qual: bytes,
              begin: int, end: int, seed_on_left: bool):
        """Score every window position; returns the VALID candidates in
        the reference's zig-zag-from-the-middle order
        (ref_aligner.h:204-212) as (lefts, strats, hams, segs, neq) —
        the dedup/first-hit-wins pass happens in pick()."""
        qlen = len(qry)
        if (qry > 3).any():
            return None   # Ns in query disqualify (ref_aligner.h:322)
        if seed_on_left:
            qbegin, qend = begin, end - qlen
        else:
            qbegin, qend = begin + qlen, end
        lim = qend - qbegin
        halfway = qbegin + (lim >> 1)
        slen = min(self.seed_len, qlen) if self.v is None else qlen
        # zig-zag candidate order: i=1..lim+1 alternating lo/hi
        i = np.arange(1, lim + 2)
        ri = np.where(i & 1, halfway - (i >> 1), halfway + (i >> 1))
        left_all = ri if seed_on_left else ri - qlen
        ok = (left_all >= 0) & (left_all + qlen <= len(ref))
        lefts = left_all[ok]
        if len(lefts) == 0:
            return None
        lo_w, hi_w = int(lefts.min()), int(lefts.max()) + qlen
        win = ref[lo_w:hi_w]
        segs = np.lib.stride_tricks.sliding_window_view(win, qlen)
        segs = segs[lefts - lo_w]                    # [ncand, qlen]
        neq = segs != qry[None, :]
        valid = ~(segs > 3).any(axis=1)
        if self.v is not None:
            mmc = neq.sum(axis=1)
            valid &= mmc <= self.v
            strat_all = mmc
            ham_all = np.zeros(len(lefts), np.int64)
        else:
            if seed_on_left:
                seedcols = np.arange(qlen) < slen
            else:
                seedcols = np.arange(qlen) >= qlen - slen
            seed_mm = (neq & seedcols[None, :]).sum(axis=1)
            quals = np.frombuffer(qual, np.uint8).astype(np.int32) - 33
            pens = (QUAL_ROUNDS[quals] if self.maq else quals)
            ham_all = (pens[None, :] * neq).sum(axis=1)
            valid &= (seed_mm <= self.seed_mms) & \
                (ham_all <= self.qual_max)
            strat_all = seed_mm
        j = np.flatnonzero(valid)
        if len(j) == 0:
            return None
        return (lefts[j], strat_all[j], ham_all[j], segs[j], neq[j])

    @staticmethod
    def pick(scored, pairs: set, aoff: int, tidx: int,
             num_to_find: int = 1):
        """First-hit-wins over the zig-zag-ordered valid candidates
        with the (upstream, downstream) dedup set (ref_aligner.h:
        441-460)."""
        out = []
        if scored is None:
            return out
        lefts, strat_all, ham_all, segs, neq = scored
        qlen = segs.shape[1] if len(segs) else 0
        for j in range(len(lefts)):
            left = int(lefts[j])
            # dedup on (upstream, downstream) coordinates
            lo, hi2 = (left, aoff) if left < aoff else (aoff, left)
            key = ((tidx << 32) | lo, (tidx << 32) | hi2)
            if key in pairs:
                continue
            pairs.add(key)
            seg = segs[j]
            mms5 = []
            # seed_on_left is recoverable from the caller; encode it
            # via the neq row orientation handled there instead
            for c in np.flatnonzero(neq[j]):
                mms5.append((int(c), ord("ACGTN"[int(seg[c])])))
            out.append((left, mms5, int(strat_all[j]),
                        int(ham_all[j])))
            if len(out) == num_to_find:
                return out
        return out

    def find(self, ref: np.ndarray, qry: np.ndarray, qual: bytes,
             begin: int, end: int, pairs: set, aoff: int,
             seed_on_left: bool, tidx: int, num_to_find: int = 1):
        """Returns [(result_off, mms[(pos,refchr)], stratum, ham)].
        qry is in fw-reference orientation; for seed_on_left=False the
        mate's 5' seed sits at the RIGHT end of qry."""
        out = self.pick(self.score(ref, qry, qual, begin, end,
                                   seed_on_left),
                        pairs, aoff, tidx, num_to_find)
        if not seed_on_left:
            qlen = len(qry)
            out = [(left, sorted((qlen - 1 - p, ch) for p, ch in mms),
                    st, ham) for left, mms, st, ham in out]
        else:
            out = [(left, sorted(mms), st, ham)
                   for left, mms, st, ham in out]
        return out


class _PairCtx:
    """All per-pair mutable state of one align_pair_gen run — local to
    the generator so many pairs can run in lockstep."""

    __slots__ = ("rd1", "rd2", "sink", "rand", "pairs_fw", "pairs_rc",
                 "stopped")

    def __init__(self, rd1, rd2, sink, rand, pairs_fw, pairs_rc):
        self.rd1, self.rd2 = rd1, rd2
        self.sink = sink
        self.rand = rand
        self.pairs_fw, self.pairs_rc = pairs_fw, pairs_rc
        self.stopped = False


class PairedBestSink:
    """NGood semantics with mult=2 for pairs (createMult(2))."""

    def __init__(self, policy: KPolicy, global_seed: int = 0):
        self.policy = policy
        self.global_seed = global_seed
        self.reset(None, None)

    def reset(self, rd1, rd2):
        self.rd1, self.rd2 = rd1, rd2
        self.count = 0
        self.buffered: list[Hit] = []

    @property
    def n2(self):
        n = self.policy.n
        return n * 2 if n != INF else INF

    @property
    def max2(self):
        m = self.policy.max
        return m * 2 if m != INF else INF

    def report_hit(self, h: Hit) -> bool:
        self.count += 1
        if self.count > self.max2:
            return True
        self.buffered.append(h)
        if self.count == self.n2 and (self.max2 == INF or
                                      self.max2 < self.n2):
            return True
        return False

    def finish(self) -> ReadResult:
        maxed = self.count > self.max2
        if maxed:
            npairs = (self.count + 1) // 2
            if self.policy.sample_max and self.buffered:
                # sample one PAIR from the best stratum
                # (SAMHitSink::reportMaxed paired branch, sam.cpp:273-298)
                rand = BtRandom(int(self.rd1.seed(self.global_seed)))
                strat = [min(self.buffered[i].stratum,
                             self.buffered[i + 1].stratum)
                         for i in range(0, len(self.buffered) - 1, 2)]
                best = min(strat)
                num = sum(1 for s in strat if s == best)
                r = rand.next_u32() % num
                k = [i for i, s in enumerate(strat) if s == best][r]
                pair = self.buffered[2 * k: 2 * k + 2]
                return ReadResult(pair, maxed=True, nvalid=npairs,
                                  sampled=True,
                                  nbuffered=len(self.buffered) // 2)
            return ReadResult([], maxed=True, nvalid=npairs,
                              nbuffered=len(self.buffered) // 2)
        return ReadResult(self.buffered[: self.n2],
                          nvalid=(self.count + 1) // 2,
                          nbuffered=len(self.buffered) // 2)


class PairedBestAligner:
    """PairedBWAlignerV1 state machine, run to completion per pair."""

    def __init__(self, driver_factory, golden_fw, golden_bw, refs,
                 ref_aligner: RefAlignerPy, sink: PairedBestSink,
                 min_insert=0, max_insert=250, fw1=True, fw2=False,
                 mixed_thresh=4, mixed_attempt_lim=100,
                 sym_ceiling=INF32, dont_reconcile=True,
                 global_seed=0):
        self.driver_factory = driver_factory   # read1, read2 -> 4 drivers
        self.gfw, self.gbw = golden_fw, golden_bw
        self.refs = refs
        self.ra = ref_aligner
        self.sink = sink
        self.minins, self.maxins = min_insert, max_insert
        self.fw1, self.fw2 = fw1, fw2
        self.mixed_thresh = mixed_thresh
        self.mixed_attempt_lim = mixed_attempt_lim
        self.sym_ceiling = sym_ceiling
        self.dont_reconcile = dont_reconcile
        self.global_seed = global_seed

    def align_batch(self, pairs):
        return [self.align_pair(a, b) for a, b in pairs]

    def align_pair(self, rd1, rd2) -> ReadResult:
        """Synchronous driver of the generator interleave: answers each
        yielded rescue-scan request with an immediate score()."""
        gen = self.align_pair_gen(rd1, rd2)
        scored = None
        try:
            while True:
                tidx, seq, qual, begin, end, sol = gen.send(scored)
                scored = self.ra.score(self.refs[tidx], seq, qual,
                                       begin, end, sol)
        except StopIteration as e:
            return e.value

    def align_pair_gen(self, rd1, rd2, drivers=None):
        """The PairedBWAlignerV1 state machine as a GENERATOR: yields
        (tidx, seq, qual, begin, end, seed_on_left) rescue-scan
        requests and receives their score() results, so a scheduler
        can run many pairs in lockstep and score their rescue windows
        in one vectorized batch (pe_device._replay_all).  All per-pair
        state is local — generators for different pairs never share
        mutable state."""
        sink = type(self.sink)(self.sink.policy, self.sink.global_seed)
        sink.reset(rd1, rd2)
        if len(rd1.seq) < 4 or len(rd2.seq) < 4:
            return sink.finish()
        if drivers is None:
            drivers = self.driver_factory(rd1, rd2)
        d1f, d1r, d2f, d2r = drivers
        qlen1, qlen2 = len(rd1.seq), len(rd2.seq)
        ctx = _PairCtx(
            rd1=rd1, rd2=rd2, sink=sink,
            rand=BtRandom(int(rd1.seed(self.global_seed))),
            pairs_fw=set(), pairs_rc=set())
        # fw orientation: upstream (L) = mate1 in its fw1_ orientation
        fw_cfg = dict(
            drL=(d1f if self.fw1 else d1r), drR=(d2f if self.fw2 else d2r),
            fwL=self.fw1, fwR=self.fw2, Lis1=True,
            qlenL=qlen1, qlenR=qlen2, pair_fw=True)
        rc_cfg = dict(
            drL=(d2r if self.fw2 else d2f), drR=(d1r if self.fw1 else d1f),
            fwL=not self.fw2, fwR=not self.fw1, Lis1=False,
            qlenL=qlen2, qlenR=qlen1, pair_fw=False)
        for cfg in (fw_cfg, rc_cfg):
            yield from self._run_orientation(ctx, **cfg)
            if ctx.stopped:
                break
        return sink.finish()

    # -- one orientation of advanceOrientation (aligner.h:1092-1326) ----
    def _run_orientation(self, ctx, drL, drR, fwL, fwR, Lis1, qlenL,
                         qlenR, pair_fw):
        offsLsz = offsRsz = 0
        delayedL = delayedR = False
        delayed_rangeL = delayed_rangeR = None
        attempts = [0]

        def chase_and_rescue(dr, is_left, rng: FoundRange):
            """Chase all rows of rng; rescue opposite mate per row.
            Returns True (via StopIteration value) if the whole read
            is done (sink satisfied or pairtries exceeded)."""
            g = self.gfw if rng.ebwt_fw else self.gbw
            qlen = (qlenL if is_left else qlenR)
            spread = rng.bot - rng.top
            irow = rng.top + ctx.rand.next_u32() % spread
            row = irow
            while True:
                off = g.resolve_row(row)
                res = g.joined_to_text_off(qlen, off, rng.ebwt_fw)
                if res is not None:
                    tidx, toff, tlen = res
                    done = yield from self._resolve_outstanding(
                        ctx, rng, is_left, Lis1, fwL, fwR, pair_fw,
                        tidx, toff, tlen, qlenL, qlenR)
                    attempts[0] += 1
                    if done:
                        ctx.stopped = True
                        return True
                    if attempts[0] > self.mixed_attempt_lim:
                        return True
                row += 1
                if row == rng.bot:
                    row = rng.top
                if row == irow:
                    return False

        while not ctx.stopped:
            # search for more ranges for whichever mate has fewer
            # candidates (aligner.h:1190-1326)
            if (offsLsz < offsRsz or drR.done) and not drL.done:
                if drR.done and offsRsz == 0:
                    return
                if not drL.found_range:
                    drL.advance(ADV_FOUND_RANGE)
                if drL.found_range:
                    r = drL.range()
                    drL.found_range = False
                    offsLsz += r.bot - r.top
                    if offsRsz == 0 and (not self.dont_reconcile or
                                         offsLsz > 3):
                        delayedL, delayed_rangeL = True, r
                    else:
                        if offsLsz > self.sym_ceiling and \
                           offsRsz > self.sym_ceiling:
                            return
                        if delayedR and offsRsz < offsLsz:
                            delayedR = False
                            delayedL, delayed_rangeL = True, r
                            if (yield from chase_and_rescue(
                                    drR, False, delayed_rangeR)):
                                return
                            delayed_rangeR = None
                            if delayedL:
                                delayedL = False
                                if (yield from chase_and_rescue(
                                        drL, True, delayed_rangeL)):
                                    return
                        else:
                            if (yield from chase_and_rescue(drL, True, r)):
                                return
                            if delayedR:
                                delayedR = False
                                if (yield from chase_and_rescue(
                                        drR, False, delayed_rangeR)):
                                    return
            elif not drR.done:
                if drL.done and offsLsz == 0:
                    return
                if not drR.found_range:
                    drR.advance(ADV_FOUND_RANGE)
                if drR.found_range:
                    r = drR.range()
                    drR.found_range = False
                    offsRsz += r.bot - r.top
                    if offsLsz == 0 and (not self.dont_reconcile or
                                         offsRsz > 3):
                        delayedR, delayed_rangeR = True, r
                    else:
                        if offsLsz > self.sym_ceiling and \
                           offsRsz > self.sym_ceiling:
                            return
                        if delayedL and offsLsz < offsRsz:
                            delayedL = False
                            delayedR, delayed_rangeR = True, r
                            if (yield from chase_and_rescue(
                                    drL, True, delayed_rangeL)):
                                return
                            delayed_rangeL = None
                            if delayedR:
                                delayedR = False
                                if (yield from chase_and_rescue(
                                        drR, False, delayed_rangeR)):
                                    return
                        else:
                            if (yield from chase_and_rescue(drR, False, r)):
                                return
                            if delayedL:
                                delayedL = False
                                if (yield from chase_and_rescue(
                                        drL, True, delayed_rangeL)):
                                    return
            else:
                return

    # -- resolveOutstandingInRef (aligner.h:951-1087) --------------------
    def _resolve_outstanding(self, ctx, rng, anchor_is_left, Lis1, fwL,
                             fwR, pair_fw, tidx, toff, tlen, qlenL,
                             qlenR):
        # identify the outstanding mate
        out_is_1 = (not Lis1) if anchor_is_left else Lis1
        orr = ctx.rd1 if out_is_1 else ctx.rd2
        ar = ctx.rd2 if out_is_1 else ctx.rd1
        match_right = anchor_is_left
        ofw = fwR if anchor_is_left else fwL
        qlen = len(orr.seq)
        alen = len(ar.seq)
        minins, maxins = _trim_adjusted_insert(
            self.minins, self.maxins, ctx.rd1, ctx.rd2,
            self.fw1, self.fw2)
        if maxins <= max(qlen, alen):
            return False
        reflen = len(self.refs[tidx])
        insdiff = maxins - minins
        if match_right:
            end = toff + maxins
            begin = toff + 1
            if qlen < alen:
                begin += alen - qlen
            if end > insdiff + qlen:
                begin = max(begin, end - insdiff - qlen)
            end = min(reflen, end)
            begin = min(reflen, begin)
        else:
            begin = 0 if toff + alen < maxins else toff + alen - maxins
            mi = min(alen, qlen)
            end = toff + mi - 1
            end = min(end, toff + alen - minins + qlen - 1)
            if toff + alen + qlen < minins + 1:
                end = 0
        if end - begin < qlen:
            return False
        seq = orr.codes_fw if ofw else orr.codes_rc
        qual = orr.qual if ofw else orr.qual[::-1]
        pairs = ctx.pairs_fw if pair_fw else ctx.pairs_rc
        # the heavy window scoring is YIELDED so a scheduler can batch
        # it across pairs; dedup + first-hit-wins + the mismatch-
        # coordinate flip (find()'s tail) stay here
        scored = yield (tidx, seq, qual, begin, end, ofw)
        found = self.ra.pick(scored, pairs, toff, tidx, num_to_find=1)
        if not ofw:
            found = [(left, sorted((qlen - 1 - pp, ch)
                                   for pp, ch in mms), st, ham)
                     for left, mms, st, ham in found]
        else:
            found = [(left, sorted(mms), st, ham)
                     for left, mms, st, ham in found]
        for result, mms, stratum, ham in found:
            cost = (stratum << 14) | ham
            oms = rng.bot - rng.top - 1
            # anchor hit fields
            a_mms = []
            for pos, refc in zip(rng.mms, rng.refcs):
                p5 = len(ar.seq) - pos - 1 if (rng.ebwt_fw != rng.fw) \
                    else pos
                a_mms.append((p5, ord("acgt"[refc])))
            anchor_hit = Hit(read=ar, fw=rng.fw, tidx=tidx, toff=toff,
                             oms=oms, stratum=rng.stratum, cost=rng.cost,
                             mms=sorted(a_mms),
                             mate=(2 if out_is_1 else 1))
            out_hit = Hit(read=orr, fw=ofw, tidx=tidx, toff=result,
                          oms=oms, stratum=stratum, cost=cost, mms=mms,
                          mate=(1 if out_is_1 else 2))
            up, dn = ((anchor_hit, out_hit) if match_right
                      else (out_hit, anchor_hit))
            # mate field: upstream mate is mate1 iff pair_fw
            up.mate = 1 if pair_fw else 2
            dn.mate = 2 if pair_fw else 1
            for h, o in ((up, dn), (dn, up)):
                h.mfw = o.fw
                h.mtidx = o.tidx
                h.mtoff = o.toff
                h.mlen = o.length
            if ctx.sink.report_hit(up):
                return True
            if ctx.sink.report_hit(dn):
                return True
        return False


class PairedBestSinkV2:
    """The V2 paired sink with mult=2: NBestFirstStratHitSinkPerThread
    semantics for --best (best-first arrival, stratum backpressure via
    irrelevant_cost, oms fixed to pairs-1 at finish; hit.h:1039-1139)
    or NGoodHitSinkPerThread semantics otherwise (no fixup, no
    backpressure; hit.h:937-992) — createSinkFactory picks by flags
    (ebwt_search.cpp:992-1021)."""

    def __init__(self, policy: KPolicy, global_seed: int = 0,
                 best: bool = True):
        self.policy = policy
        self.global_seed = global_seed
        self.best = best
        self.reset(None, None)

    def reset(self, rd1, rd2):
        self.rd1, self.rd2 = rd1, rd2
        self.count = 0
        self.best_stratum = 999
        self.buffered: list[Hit] = []

    @property
    def n2(self):
        n = self.policy.n
        return n * 2 if n != INF else INF

    @property
    def max2(self):
        m = self.policy.max
        return m * 2 if m != INF else INF

    def report_hit(self, h: Hit) -> bool:
        self.count += 1
        if h.stratum < self.best_stratum:
            self.best_stratum = h.stratum
        if self.count > self.max2:
            return True
        self.buffered.append(h)
        if self.count == self.n2 and (self.max2 == INF or
                                      self.max2 < self.n2):
            return True
        return False

    def irrelevant_cost(self, cost: int) -> bool:
        if self.best and self.count:
            return (cost >> 14) > self.best_stratum
        return False

    def empty(self) -> bool:
        return not self.buffered

    def finish(self) -> ReadResult:
        maxed = self.count > self.max2
        if self.best:
            for h in self.buffered:
                h.oms = len(self.buffered) // 2 - 1
        if maxed:
            npairs = (self.count + 1) // 2
            if self.policy.sample_max and self.buffered:
                rand = BtRandom(int(self.rd1.seed(self.global_seed)))
                strat = [min(self.buffered[i].stratum,
                             self.buffered[i + 1].stratum)
                         for i in range(0, len(self.buffered) - 1, 2)]
                best = min(strat)
                num = sum(1 for s in strat if s == best)
                r = rand.next_u32() % num
                k = [i for i, s in enumerate(strat) if s == best][r]
                pair = self.buffered[2 * k: 2 * k + 2]
                return ReadResult(pair, maxed=True, nvalid=npairs,
                                  sampled=True,
                                  nbuffered=len(self.buffered) // 2)
            return ReadResult([], maxed=True, nvalid=npairs,
                              nbuffered=len(self.buffered) // 2)
        return ReadResult(self.buffered[: self.n2],
                          nvalid=(self.count + 1) // 2,
                          nbuffered=len(self.buffered) // 2)


class SEHoldSink:
    """mult=1 sink holding single-end alignments of one mate for
    --reportse (aligner.h reportSe holds, reported only if no paired
    alignment lands); NBestFirstStrat or NGood semantics by `best`."""

    def __init__(self, policy: KPolicy, best: bool = True):
        self.policy = policy
        self.best = best
        self.reset()

    def reset(self):
        self.count = 0
        self.best_stratum = 999
        self.buffered: list[Hit] = []

    def report_hit(self, h: Hit) -> bool:
        self.count += 1
        if h.stratum < self.best_stratum:
            self.best_stratum = h.stratum
        if self.count > self.policy.max:
            return True
        self.buffered.append(h)
        n = self.policy.n
        if self.count == n and (self.policy.max == INF or
                                self.policy.max < n):
            return True
        return False

    def irrelevant_cost(self, cost: int) -> bool:
        if self.best and self.count:
            return (cost >> 14) > self.best_stratum
        return False

    def finish(self) -> list[Hit]:
        """Reported SE hits (empty when maxed), oms fixed up."""
        if self.count > self.policy.max:
            return []
        if self.best:
            for h in self.buffered:
                h.oms = len(self.buffered) - 1
        n = self.policy.n
        return self.buffered[:n] if n != INF else self.buffered


class PairedBestAlignerV2:
    """PairedBWAlignerV2 (aligner.h:1483-1998): a single cost-merged
    driver stream over all four (mate, strand) source groups; every
    found range is chased and each resolved anchor row is immediately
    mate-rescued in reference space; optional --reportse SE holds."""

    def __init__(self, driver_factory, golden_fw, golden_bw, refs,
                 ref_aligner: RefAlignerPy, sink: PairedBestSinkV2,
                 se_policy: KPolicy | None = None,
                 min_insert=0, max_insert=250, fw1=True, fw2=False,
                 mixed_attempt_lim=100, global_seed=0):
        self.driver_factory = driver_factory   # (rd1, rd2) -> CostAware
        self.gfw, self.gbw = golden_fw, golden_bw
        self.refs = refs
        self.ra = ref_aligner
        self.sink = sink
        self.se_policy = se_policy             # not None -> --reportse
        self.minins, self.maxins = min_insert, max_insert
        self.fw1, self.fw2 = fw1, fw2
        self.mixed_attempt_lim = mixed_attempt_lim
        self.global_seed = global_seed

    def align_batch(self, pairs):
        return [self.align_pair(a, b) for a, b in pairs]

    def align_pair(self, rd1, rd2) -> ReadResult:
        self.sink.reset(rd1, rd2)
        best = self.sink.best
        self.se1 = SEHoldSink(self.se_policy, best) \
            if self.se_policy else None
        self.se2 = SEHoldSink(self.se_policy, best) \
            if self.se_policy else None
        if len(rd1.seq) < 4 or len(rd2.seq) < 4:
            return self._finish()
        driver = self.driver_factory(rd1, rd2)
        self.driver = driver
        self.rd1, self.rd2 = rd1, rd2
        self.rand = BtRandom(int(rd1.seed(self.global_seed)))
        self.donePe = self.doneSe1 = self.doneSe2 = False
        self.mixed_attempts = 0
        self.pairs_fw: set = set()
        self.pairs_rc: set = set()
        self.done = False

        while not self.done:
            if driver.found_range:
                r = driver.range()
                driver.found_range = False
                self._chase(r)
                if self.done:
                    break
                self.done = driver.done
                if self.done:
                    break
                continue
            if driver.done:
                break
            # minCost pruning (aligner.h:1638-1681)
            if not self.donePe:
                self.donePe = self.sink.irrelevant_cost(driver.min_cost)
                if self.donePe and (not self.sink.empty() or
                                    self.se1 is None):
                    break
                if self.donePe and self.se1 is not None:
                    if self.doneSe1:
                        driver.remove_mate(1)
                    if self.doneSe2:
                        driver.remove_mate(2)
            if self.se1 is not None:
                if not self.doneSe1:
                    self.doneSe1 = self.se1.irrelevant_cost(
                        driver.min_cost)
                    if self.doneSe1 and self.donePe:
                        driver.remove_mate(1)
                if not self.doneSe2:
                    self.doneSe2 = self.se2.irrelevant_cost(
                        driver.min_cost)
                    if self.doneSe2 and self.donePe:
                        driver.remove_mate(2)
                if not self.doneSe1:
                    self.doneSe1 = self.se1.irrelevant_cost(
                        driver.min_cost)
                    if self.doneSe1 and self.donePe:
                        driver.remove_mate(1)
                if self.donePe and self.doneSe1 and self.doneSe2:
                    break
            driver.advance(ADV_FOUND_RANGE)
            if driver.done and not driver.found_range:
                break
        return self._finish()

    def _finish(self) -> ReadResult:
        res = self.sink.finish()
        if self.se1 is not None:
            # finishRead returns 0 for maxed reads even when -M samples
            # one pair, so SE holds are reported in that case too
            reported_pe = bool(res.hits) and not res.maxed
            if not reported_pe:
                res.se_hits = [self.se1.finish(), self.se2.finish()]
        return res

    # -- chase + immediate rescue (advance() chase_ path) --------------
    def _chase(self, rng: FoundRange):
        g = self.gfw if rng.ebwt_fw else self.gbw
        qlen = len(self.rd1.seq) if rng.mate1 else len(self.rd2.seq)
        spread = rng.bot - rng.top
        irow = rng.top + self.rand.next_u32() % spread
        row = irow
        while True:
            off = g.resolve_row(row)
            res = g.joined_to_text_off(qlen, off, rng.ebwt_fw)
            if res is not None:
                tidx, toff, tlen = res
                self._resolve_outstanding((tidx, toff), tlen, rng)
                if self.done:
                    return
            row += 1
            if row == rng.bot:
                row = rng.top
            if row == irow:
                return

    def _resolve_outstanding(self, off, tlen, rng: FoundRange):
        """aligner.h:1834-1858."""
        if not self.donePe:
            ret = self._resolve_in_ref(off, tlen, rng)
            self.mixed_attempts += 1
            if self.mixed_attempts > self.mixed_attempt_lim or ret:
                self.donePe = True
                if self.se1 is not None:
                    if self.doneSe1:
                        self.driver.remove_mate(1)
                    if self.doneSe2:
                        self.driver.remove_mate(2)
                self.done = (self.donePe and
                             (not self.sink.empty() or
                              self.se1 is None or
                              (self.doneSe1 and self.doneSe2)))
        if not self.done and self.se1 is not None:
            done_se = self.doneSe1 if rng.mate1 else self.doneSe2
            if not done_se:
                self._report_se(rng, off, tlen)
            self.done = self.doneSe1 and self.doneSe2 and self.donePe

    def _report_se(self, rng: FoundRange, off, tlen):
        """reportSe (aligner.h:1796-1832): hold the anchor's SE hit."""
        buf = self.rd1 if rng.mate1 else self.rd2
        sink = self.se1 if rng.mate1 else self.se2
        qlen = len(buf.seq)
        mms = []
        for pos, refc in zip(rng.mms, rng.refcs):
            p5 = qlen - pos - 1 if (rng.ebwt_fw != rng.fw) else pos
            mms.append((p5, ord("acgt"[refc])))
        h = Hit(read=buf, fw=rng.fw, tidx=off[0], toff=off[1],
                oms=rng.bot - rng.top - 1, stratum=rng.stratum,
                cost=rng.cost, mms=sorted(mms), mate=0)
        if sink.report_hit(h):
            if rng.mate1:
                self.doneSe1 = True
            else:
                self.doneSe2 = True
            if self.donePe:
                self.driver.remove_mate(1 if rng.mate1 else 2)

    def _resolve_in_ref(self, off, tlen, rng: FoundRange) -> bool:
        """resolveOutstandingInRef (aligner.h:1871-1997)."""
        pair_fw = (rng.fw == self.fw1) if rng.mate1 else \
            (rng.fw == self.fw2)
        match_right = rng.mate1 if pair_fw else not rng.mate1
        fw = self.fw2 if rng.mate1 else self.fw1
        if not pair_fw:
            fw = not fw
        orr = self.rd2 if rng.mate1 else self.rd1
        ar = self.rd1 if rng.mate1 else self.rd2
        seq = orr.codes_fw if fw else orr.codes_rc
        qual = orr.qual if fw else orr.qual[::-1]
        qlen = len(orr.seq)
        alen = len(ar.seq)
        minins, maxins = _trim_adjusted_insert(
            self.minins, self.maxins, self.rd1, self.rd2,
            self.fw1, self.fw2)
        if maxins <= max(qlen, alen):
            return False
        tidx, toff = off
        reflen = len(self.refs[tidx])
        insdiff = maxins - minins
        if match_right:
            end = toff + maxins
            begin = toff + 1
            if qlen < alen:
                begin += alen - qlen
            if end > insdiff + qlen:
                begin = max(begin, end - insdiff - qlen)
            end = min(reflen, end)
            begin = min(reflen, begin)
        else:
            begin = 0 if toff + alen < maxins else toff + alen - maxins
            mi = min(alen, qlen)
            end = toff + mi - 1
            end = min(end, toff + alen - minins + qlen - 1)
            if toff + alen + qlen < minins + 1:
                end = 0
        if end - begin < qlen:
            return False
        pairs = self.pairs_fw if pair_fw else self.pairs_rc
        found = self.ra.find(self.refs[tidx], seq, qual, begin, end,
                             pairs, toff, fw, tidx)
        for result, mms, stratum, ham in found:
            cost = (stratum << 14) | ham
            oms = rng.bot - rng.top - 1
            a_mms = []
            for pos, refc in zip(rng.mms, rng.refcs):
                p5 = len(ar.seq) - pos - 1 if (rng.ebwt_fw != rng.fw) \
                    else pos
                a_mms.append((p5, ord("acgt"[refc])))
            anchor_hit = Hit(read=ar, fw=rng.fw, tidx=tidx, toff=toff,
                             oms=oms, stratum=rng.stratum,
                             cost=rng.cost, mms=sorted(a_mms),
                             mate=(2 if not rng.mate1 else 1))
            out_hit = Hit(read=orr, fw=fw, tidx=tidx, toff=result,
                          oms=oms, stratum=stratum, cost=cost, mms=mms,
                          mate=(1 if not rng.mate1 else 2))
            up, dn = ((anchor_hit, out_hit) if match_right
                      else (out_hit, anchor_hit))
            up.mate = 1 if pair_fw else 2
            dn.mate = 2 if pair_fw else 1
            for h, o in ((up, dn), (dn, up)):
                h.mfw = o.fw
                h.mtidx = o.tidx
                h.mtoff = o.toff
                h.mlen = o.length
            if self.sink.report_hit(up):
                return True
            if self.sink.report_hit(dn):
                return True
        return False
