"""Driver/aligner layer of the stateful best-first engine.

- BestDriver            <-> EbwtRangeSourceDriver + SingleRangeSourceDriver
                            (ebwt_search_backtrack.h:2670; range_source.h:1716)
- CostAwareDriver       <-> CostAwareRangeSourceDriver (range_source.h:2033)
- RangeChaser           <-> range_chaser.h:22 (random start row, wrap)
- BestSink variants     <-> NGood / NBestFirstStrat / All sinks (hit.h)
- UnpairedBestAligner   <-> UnpairedAlignerV2 (aligner.h:381)

A copy of bowtie_tpu/align/best_driver.py.  The paired engines
(align/best_paired.py) use CostAwareDriver's paired members:
set_query_paired, remove_mate, _mate_eliminated, the `paired` flag and
the `seed_read` override.
"""
from __future__ import annotations

from .best import (ADV_COST_CHANGES, BestRangeSource, FoundRange,
                   PathManager, cext_to_depth)
from .backtrack_oracle import mm_penalty
from .policy import INF, KPolicy, ReadResult
from .types import Hit
from ..utils.rng import BtRandom

INF32 = 0xFFFFFFFF


class BestDriver:
    """One strand/index range-source behind its own PathManager."""

    def __init__(self, rs: BestRangeSource, seed: bool, seed_len: int,
                 nudge_left: bool, pins: tuple, mate1: bool = True,
                 bt_cnt=None):
        self.rs = rs
        rs.mate1 = mate1
        self.seed = seed
        self.seed_len = seed_len
        self.nudge_left = nudge_left
        self.pins = pins               # (rev0, rev1, rev2, rev3) cexts
        self.mate1_flag = mate1
        self.pm = PathManager()
        self.done = True
        self.found_range = False
        self.min_cost = 0
        self.min_cost_adj = 0
        self.bt_cnt = bt_cnt

    def fw(self):
        return self.rs.fw

    def mate1(self):
        return self.mate1_flag

    def set_query(self, read, seed_range: FoundRange | None):
        self.done = False
        self.found_range = False
        self.pm = PathManager()
        self.rs.set_query(read, seed_range)
        self._init_range_source()
        if self.done:
            return
        if not self.rs.done:
            self.rs.init_branch(self.pm)
        icost = seed_range.cost if seed_range is not None else 0
        self.min_cost = max(icost, self.min_cost_adj)
        # done = rs.done ONLY (range_source.h:1766): a driver whose pm
        # is empty stays alive until its first advance marks it done —
        # while alive it participates in CostAware sortActives and
        # soaks tie-break RNG draws, which shifts the whole draw
        # sequence (observed: -v 3 --best --strata -M 1 strand order)
        self.done = self.rs.done
        self.found_range = self.rs.found_range

    def _init_range_source(self):
        """initRangeSource (ebwt_search_backtrack.h:2721-2805): resolve
        pins to depths, set qlen for seed drivers, compute the
        minCostAdjustment lower bound."""
        rs = self.rs
        length = len(rs.qry)
        qual = rs.qual
        s = min(self.seed_len, length) if self.seed_len > 0 else length
        s_left = s >> 1
        s_right = s >> 1
        if s & 1:
            if self.nudge_left:
                s_left += 1
            else:
                s_right += 1
        rev = [cext_to_depth(p, s_right, s, length) for p in self.pins]
        qlen = length
        if self.seed and length > s:
            rs.set_qlen(s)
            qlen = s
        min_cost = 0
        if rs.report_exacts:
            pass
        elif not rs.half_and_half and rev[0] < s:
            min_cost = 1 << 14
            if rs.qual_order:
                lo = min(qual[qlen - d - 1] for d in range(rev[0], s))
                min_cost += mm_penalty(rs.maq, lo - 33)
        elif rs.half_and_half and 0 < s_right < s - 1:
            min_cost = (3 if self.seed else 2) << 14
            if rs.qual_order:
                lo1 = min(qual[qlen - d - 1] for d in range(0, s_right))
                min_cost += mm_penalty(rs.maq, lo1 - 33)
                half2 = sorted(qual[qlen - d - 1]
                               for d in range(s_right, s))
                min_cost += mm_penalty(rs.maq, half2[0] - 33)
                if rs.half_and_half > 2 and len(half2) > 1:
                    min_cost += mm_penalty(rs.maq, half2[1] - 33)
        self.min_cost_adj = min_cost
        rs.set_offs(s_right, s, rev[0], rev[1], rev[2], rev[3])

    def advance(self, until):
        if self.done or self.pm.empty():
            self.done = True
            return
        self.rs.advance_branch(max(until, ADV_COST_CHANGES), self.min_cost,
                               self.pm, self.bt_cnt)
        self.done = self.pm.empty()
        if self.pm.min_cost != 0:
            self.min_cost = max(self.pm.min_cost, self.min_cost_adj)
        self.found_range = self.rs.found_range

    def range(self) -> FoundRange:
        return self.rs.cur_range


class CostAwareDriver:
    """Merge drivers best-first with random tie-breaks
    (range_source.h:2033-2400)."""

    def __init__(self, drivers: list[BestDriver], strand_fix: bool = True,
                 mixes_reads: bool = False, global_seed: int = 0):
        self.rss = drivers
        self.strand_fix = strand_fix
        self.global_seed = global_seed
        self.active: list[BestDriver] = []
        self.last_range = None
        self.delayed_range = None
        self.done = False
        self.found_range = False
        self.min_cost = 0
        self.paired = (any(d.mate1() for d in drivers) and
                       any(not d.mate1() for d in drivers))

    # Optional override: paired mode seeds every CostAware RNG with
    # mate1's seed (range_source.h:2084: rand_.init(bufa().seed))
    seed_read = None

    def set_query(self, read, seed_range=None):
        self.done = False
        self.found_range = False
        self.last_range = None
        self.delayed_range = None
        self.read = read
        sr = self.seed_read if self.seed_read is not None else read
        self.rand = BtRandom(int(sr.seed(self.global_seed)))
        if not self.rss:
            return
        for d in self.rss:
            d.set_query(read, seed_range)
        self.active = list(self.rss)
        self.min_cost = 0
        self._sort_actives()

    def add_source(self, d: BestDriver, seed_range):
        """CostAware addSource (range_source.h:2098-2113)."""
        self.found_range = False
        self.last_range = None
        self.delayed_range = None
        self.done = False
        d.set_query(self.read, seed_range)
        self.rss.append(d)
        self.active.append(d)
        self.paired = (any(x.mate1() for x in self.rss) and
                       any(not x.mate1() for x in self.rss))
        self.min_cost = 0
        self._sort_actives()

    def clear_sources(self):
        self.rss = []
        self.active = []
        self.paired = False

    def set_query_paired(self, rd1, rd2):
        """Paired set_query: each driver gets its own mate's read
        (PairedBWAlignerV2's single merged driver); the tie-break RNG
        seeds from mate1 (range_source.h:2084)."""
        self.done = False
        self.found_range = False
        self.last_range = None
        self.delayed_range = None
        self.read = rd1
        self.rand = BtRandom(int(rd1.seed(self.global_seed)))
        for d in self.rss:
            d.set_query(rd1 if d.mate1() else rd2, None)
        self.active = list(self.rss)
        self.paired = (any(d.mate1() for d in self.rss) and
                       any(not d.mate1() for d in self.rss))
        self.min_cost = 0
        self._sort_actives()

    def remove_mate(self, m: int):
        """CostAware removeMate (range_source.h:2233): mark every
        active driver of mate m done, then re-sort."""
        qmate1 = m == 1
        for d in self.active:
            if d.mate1() == qmate1:
                d.done = True
        self._sort_actives()

    def _mate_eliminated(self):
        if not self.paired:
            return False
        m1 = any(not d.done for d in self.active if d.mate1())
        m2 = any(not d.done for d in self.active if not d.mate1())
        return not m1 or not m2

    def _sort_actives(self):
        """Selection sort with random tie swaps (range_source.h:2367+),
        replicated literally for RNG-draw parity."""
        vec = self.active
        sz = len(vec)
        i = 0
        while i < sz:
            if vec[i].done and not vec[i].found_range:
                vec.pop(i)
                sz -= 1
                if sz == 0:
                    break
                continue
            min_cost = vec[i].min_cost
            min_off = i
            for j in range(i + 1, sz):
                if vec[j].done and not vec[j].found_range:
                    continue
                if vec[j].min_cost < min_cost:
                    min_cost = vec[j].min_cost
                    min_off = j
                elif vec[j].min_cost == min_cost:
                    if self.rand.next_u32() & 0x1000:
                        min_off = j
            if min_off != i:
                vec[i], vec[min_off] = vec[min_off], vec[i]
            i += 1
        if vec and self.delayed_range is None:
            # while a delayed range is pending, minCost stays at its
            # cost — the guard the reference applies at
            # range_source.h:2409-2413 (sortActives)
            self.min_cost = max(vec[0].min_cost, self.min_cost)

    def _found_first_range(self, r: FoundRange):
        self.found_range = True
        self.last_range = r
        if self.strand_fix:
            for i in range(1, len(self.active)):
                # quirk preserved from the reference (:2322-2327): the
                # mate/strand test reads rss_[i], the advance acts on
                # active_[i]
                if (i < len(self.rss) and
                        self.rss[i].mate1() == r.mate1 and
                        self.rss[i].fw() != r.fw):
                    p = self.active[i]
                    mc = max(self.min_cost, p.min_cost)
                    if mc > r.cost:
                        break
                    while not p.done and not p.found_range:
                        p.advance(ADV_COST_CHANGES)
                        if p.min_cost > mc:
                            break
                    if p.found_range:
                        self.delayed_range = p.range()
                        tot = ((self.delayed_range.bot -
                                self.delayed_range.top) +
                               (self.last_range.bot - self.last_range.top))
                        rq = self.rand.next_u32() % tot
                        if rq < (self.delayed_range.bot -
                                 self.delayed_range.top):
                            self.last_range, self.delayed_range = \
                                self.delayed_range, self.last_range
                        p.found_range = False
                    return True
        return False

    def rss_contains(self, d):
        return True

    def advance(self, until):
        until = max(until, ADV_COST_CHANGES)
        self.last_range = None
        self.found_range = False
        if self.delayed_range is not None:
            self.last_range = self.delayed_range
            self.delayed_range = None
            self.found_range = True
            if self.active:
                self.min_cost = max(self.active[0].min_cost, self.min_cost)
            else:
                self.done = True
            return
        if self._mate_eliminated() or not self.active:
            self.active = []
            self.done = True
            return
        p = self.active[0]
        precost = p.min_cost
        if not p.found_range:
            p.advance(until)
        needs_sort = False
        if p.found_range:
            needs_sort = self._found_first_range(p.range())
            p.found_range = False
        if p.done or precost != p.min_cost or needs_sort:
            self._sort_actives()
            if self._mate_eliminated() or not self.active:
                self.active = []
                self.done = self.delayed_range is None

    def range(self) -> FoundRange:
        return self.last_range


class SeededDriver:
    """EbwtSeededRangeSourceDriver (ebwt_search_backtrack.h:2935-3140):
    chains a seed-only partial-alignment generator with dynamically
    created full-extension drivers merged in an inner cost-aware
    driver."""

    def __init__(self, full_factory, seed_driver: BestDriver, fw: bool,
                 seed_len: int, mate1: bool = True, global_seed: int = 0):
        self.full_factory = full_factory   # () -> BestDriver
        self.rs_seed = seed_driver
        self.rs_full = CostAwareDriver([], strand_fix=False,
                                       mixes_reads=True,
                                       global_seed=global_seed)
        self.fw_flag = fw
        self.mate1_flag = mate1
        self.seed_len = seed_len
        self.done = True
        self.found_range = False
        self.min_cost = 0
        self.min_cost_adj = 0

    def fw(self):
        return self.fw_flag

    def mate1(self):
        return self.mate1_flag

    def set_query(self, read, seed_range=None):
        self.done = False
        self.found_range = False
        self.rs_seed.set_query(read, seed_range)
        self.min_cost_adj = max(self.rs_seed.min_cost_adj,
                                self.rs_seed.min_cost)
        self.min_cost = self.min_cost_adj
        self.rs_full.clear_sources()
        self.rs_full.set_query(read, seed_range)
        self.rs_full.min_cost = self.min_cost

    def advance(self, until):
        until = max(until, ADV_COST_CHANGES)
        rs_seed, rs_full = self.rs_seed, self.rs_full
        if (rs_seed.done and rs_full.done and
                not rs_seed.found_range and not rs_full.found_range):
            self.done = True
            return
        if rs_seed.done and not rs_seed.found_range:
            rs_seed.min_cost = 0xFFFF
            if rs_full.min_cost > self.min_cost:
                self.min_cost = rs_full.min_cost
                return
        if rs_full.done and not rs_full.found_range:
            rs_full.min_cost = 0xFFFF
            if rs_seed.min_cost > self.min_cost:
                self.min_cost = rs_seed.min_cost
                return
        do_full = rs_full.min_cost <= rs_seed.min_cost
        if not do_full:
            if not rs_seed.found_range:
                rs_seed.advance(until)
            if rs_seed.found_range:
                seed_range = rs_seed.range()
                rs_seed.found_range = False
                self.min_cost_adj = seed_range.cost
                partial = self.full_factory()
                partial.min_cost = seed_range.cost
                rs_full.min_cost = seed_range.cost
                rs_full.add_source(partial, seed_range)
                if rs_full.found_range:
                    self.found_range = True
                    rs_full.found_range = False
            if rs_seed.min_cost > self.min_cost:
                self.min_cost = rs_seed.min_cost
                if not rs_full.done:
                    self.min_cost = min(self.min_cost, rs_full.min_cost)
        else:
            old_full = rs_full.min_cost
            if not rs_full.found_range:
                rs_full.advance(until)
            if rs_full.found_range:
                self.found_range = True
                rs_full.found_range = False
            if rs_full.min_cost > old_full:
                self.min_cost = min(rs_full.min_cost, rs_seed.min_cost)

    def range(self) -> FoundRange:
        r = self.rs_full.range()
        r.fw = self.fw_flag
        r.mate1 = self.mate1_flag
        return r


class RangeChaser:
    """range_chaser.h:22: resolve a range's rows to reference loci in
    random-start wrap order.  Host-vectorizable; here row at a time to
    keep RNG/report interleaving identical."""

    def __init__(self, golden_fw, golden_bw):
        self.gfw, self.gbw = golden_fw, golden_bw

    def chase(self, r: FoundRange, qlen: int, rand: BtRandom):
        """Yield (tidx, toff) for each row of [top, bot) starting at a
        random row and wrapping; skips fragment-spanning rows."""
        g = self.gfw if r.ebwt_fw else self.gbw
        spread = r.bot - r.top
        irow = r.top + rand.next_u32() % spread
        row = irow
        while True:
            off = g.resolve_row(row)
            res = g.joined_to_text_off(qlen, off, r.ebwt_fw)
            if res is not None:
                yield res[0], res[1]
            row += 1
            if row == r.bot:
                row = r.top
            if row == irow:
                return


class BestSink:
    """NGood / All / NBestFirstStrat behavior selected by flags
    (createSinkFactory, ebwt_search.cpp:992-1021)."""

    def __init__(self, policy: KPolicy, strata: bool, all_hits: bool,
                 global_seed: int = 0):
        self.policy = policy
        self.strata = strata
        self.all_hits = all_hits
        self.global_seed = global_seed
        self.reset(None)

    def reset(self, read):
        self.read = read
        self.count = 0
        self.buffered: list[Hit] = []
        self.best_stratum = 999

    @property
    def n(self):
        return (INF32 // 2 if (self.strata and self.all_hits)
                else (INF if self.all_hits else self.policy.n))

    def report_hit(self, read, rng: FoundRange, tidx, toff, qlen) -> bool:
        self.count += 1
        if rng.stratum < self.best_stratum:
            self.best_stratum = rng.stratum
        if self.count > self.policy.max:
            return True
        mms = []
        for pos, refc in zip(rng.mms, rng.refcs):
            off = qlen - pos - 1 if (rng.ebwt_fw != rng.fw) else pos
            mms.append((off, ord("acgt"[refc])))
        self.buffered.append(Hit(
            read=read, fw=rng.fw, tidx=tidx, toff=toff,
            oms=rng.bot - rng.top - 1, stratum=rng.stratum,
            cost=rng.cost, mms=sorted(mms)))
        n = self.n
        if self.count == n and (self.policy.max == INF or
                                self.policy.max < n):
            return True
        return False

    def irrelevant_cost(self, cost) -> bool:
        """NBestFirstStrat::irrelevantCost (hit.h:1124-1131)."""
        if self.strata and self.count:
            return (cost >> 14) > self.best_stratum
        return False

    def finish(self) -> ReadResult:
        maxed = self.count > self.policy.max
        if self.strata:
            # oms fixup (NBestFirstStrat::finishReadImpl, hit.h:1100)
            for h in self.buffered:
                h.oms = len(self.buffered) - 1
        if maxed:
            if self.policy.sample_max and self.buffered:
                rand = BtRandom(int(self.read.seed(self.global_seed)))
                num = 1
                while (num < len(self.buffered) and
                       self.buffered[num].stratum ==
                       self.buffered[0].stratum):
                    num += 1
                h = self.buffered[rand.next_u32() % num]
                return ReadResult([h], maxed=True, nvalid=self.count,
                                  sampled=True,
                                  nbuffered=len(self.buffered))
            return ReadResult([], maxed=True, nvalid=self.count,
                              nbuffered=len(self.buffered))
        n = self.n
        return ReadResult(self.buffered[:n], nvalid=self.count,
                          nbuffered=min(len(self.buffered), n))


class UnpairedBestAligner:
    """UnpairedAlignerV2 loop (aligner.h:381-600), run to completion."""

    def __init__(self, driver_factory, chaser: RangeChaser,
                 sink: BestSink, global_seed: int = 0, maxbts=None):
        self.driver_factory = driver_factory
        self.chaser = chaser
        self.sink = sink
        self.global_seed = global_seed
        self.maxbts = maxbts
        self._driver = None    # graph built once, re-pointed per read
                               # via setQuery (aligner.h:45-84)

    def align_read(self, read) -> ReadResult:
        sink = self.sink
        sink.reset(read)
        if len(read.seq) < 4:
            return sink.finish()
        if self._driver is None:
            self._driver = self.driver_factory(read)
        driver = self._driver
        bt = getattr(driver, "bt_cell", None)
        if bt is not None:
            bt[0] = driver.bt_init   # *btCnt_ = maxBts_ per read
        rand = BtRandom(int(read.seed(self.global_seed)))
        qlen = len(read.seq)
        driver.set_query(read)
        done = driver.done
        while not done:
            if driver.found_range:
                r = driver.range()
                if sink.irrelevant_cost(r.cost):
                    driver.found_range = False
                    done = driver.done
                    continue
                stop = False
                for tidx, toff in self.chaser.chase(r, qlen, rand):
                    if sink.report_hit(read, r, tidx, toff, qlen):
                        stop = True
                        break
                    if sink.irrelevant_cost(r.cost):
                        break
                driver.found_range = False
                if stop:
                    break
                done = driver.done
            else:
                if sink.irrelevant_cost(driver.min_cost):
                    break
                driver.advance(ADV_COST_CHANGES)
                if driver.done and not driver.found_range:
                    done = True
        return sink.finish()

    def align_batch(self, reads):
        return [self.align_read(r) for r in reads]
