"""Stateful best-first search engine (bowtie's --best machinery).

Re-expresses the branch-and-bound engine used by --best/-M/-v 3/
--strata and all paired-end runs (ebwt_search.cpp:3001 forces it for
pairs):

- RangeState / Branch         range_source.h:314,517
- BranchQueue (CostCompare)   range_source.h:1103,1149
- PathManager                 range_source.h:1307
- EbwtRangeSource::initBranch/advanceBranch
                              ebwt_search_backtrack.h:1919,2060
- EbwtRangeSourceDriver pins  ebwt_search_backtrack.h:2670
- CostAwareRangeSourceDriver  range_source.h:2033 (random tie-break
                              sortActives + strandFix delayed range)
- UnpairedAlignerV2 + RangeChaser
                              aligner.h:381; range_chaser.h:22
- NBestFirstStratHitSink      hit.h:1039

Cost = (stratum << 14) | quality-penalty.  All three RandomSources
(per-RangeSource, CostAware-driver, aligner) are seeded with the same
per-read seed, and draws are consumed in the reference's order — this
is what makes tie-breaking bit-reproducible.

A copy of bowtie_tpu/align/best.py: the host best-first engine, which
re-runs the lanes that overflow the device machine (align/best_device.py)
and is its --sanity twin.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .backtrack_oracle import mm_penalty
from .golden import GoldenFM
from ..utils.rng import BtRandom

INF32 = 0xFFFFFFFF

# pin constants (ebwt_search_backtrack.h SearchConstraintExtent)
PIN_TO_BEGINNING = 0
PIN_TO_LEN = 1
PIN_TO_HI_HALF_EDGE = 2
PIN_TO_SEED_EDGE = 3


def cext_to_depth(cext, s_right, s, length):
    if cext == PIN_TO_SEED_EDGE:
        return s
    if cext == PIN_TO_HI_HALF_EDGE:
        return s_right
    if cext == PIN_TO_BEGINNING:
        return 0
    return length


class RangeState:
    __slots__ = ("tops", "bots", "mm_elim", "quallo", "eliminated")

    def __init__(self):
        self.tops = [0, 0, 0, 0]
        self.bots = [0, 0, 0, 0]
        self.mm_elim = [True, True, True, True]   # True = eliminated
        self.quallo = 127
        self.eliminated = True

    def pick_edit(self, pos, rand: BtRandom):
        """range_source.h:321-485: weighted random pick among
        non-eliminated substitutions.  Returns (chr, top, bot, last)."""
        cands = [j for j in range(4) if not self.mm_elim[j]]
        num = len(cands)
        if num > 1:
            tot = sum(self.bots[j] - self.tops[j] for j in cands)
            dart = rand.next_u32() % tot
            for j in cands:
                spread = self.bots[j] - self.tops[j]
                if dart < spread:
                    self.mm_elim[j] = True
                    return j, self.tops[j], self.bots[j], False
                dart -= spread
            raise AssertionError
        j = cands[0]
        self.eliminated = True
        return j, self.tops[j], self.bots[j], True


class Branch:
    __slots__ = ("id", "depth0", "depth1", "depth2", "depth3", "rdepth",
                 "len", "cost", "ham", "top", "bot", "ranges",
                 "nranges", "edits", "curtailed", "exhausted",
                 "delayed_cost", "delayed_increase")

    def __init__(self, bid, qlen, d0, d1, d2, d3, rdepth, blen, cost,
                 ham, top, bot, edits=None):
        self.id = bid
        self.depth0, self.depth1 = d0, d1
        self.depth2, self.depth3 = d2, d3
        self.rdepth = rdepth
        self.len = blen
        self.cost = cost
        self.ham = ham
        self.top, self.bot = top, bot
        self.nranges = max(0, qlen - rdepth)
        # RangeStates are created lazily on install: an absent entry is
        # an eliminated position (RangeState starts eliminated), and
        # skipped-over positions are unrevisitable (Branch::init :598).
        # This removes the dominant allocation cost of the host engine
        # (one RangeState per position per Branch).
        self.ranges = {}
        self.edits = list(edits) if edits else []   # [(pos, chr_int)]
        self.curtailed = False
        self.exhausted = False
        self.delayed_cost = 0
        self.delayed_increase = False

    def tip_depth(self):
        return self.rdepth + self.len

    def eliminated_at(self, i):
        if i <= self.len and i < self.nranges:
            r = self.ranges.get(i)
            return r.eliminated if r is not None else True
        return True

    def range_at(self, i):
        r = self.ranges.get(i)
        if r is None:
            r = RangeState()
            self.ranges[i] = r
        return r

    def heap_key(self):
        """CostCompare (range_source.h:1103): cost asc; extendable
        before curtailed; deeper tip first; smaller id first."""
        unext = self.curtailed or self.exhausted
        return (self.cost, unext, -self.tip_depth(), self.id)

    def curtail(self, seed_len, qual_order):
        """range_source.h:877-939."""
        if not self.ranges:
            self.exhausted = True
            self.curtailed = True
            return
        lowest = 0xFFFF
        i0 = max(0, self.depth0 - self.rdepth)
        hi = min(self.len, self.nranges - 1)
        for i in self.ranges:
            if i < i0 or i > hi:
                continue
            r = self.ranges[i]
            if r.eliminated:
                continue
            stratum = (1 << 14) if (self.rdepth + i < seed_len) else 0
            cost = (r.quallo if qual_order else 0) | stratum
            if cost < lowest:
                lowest = cost
        if lowest == 0xFFFF:
            self.exhausted = True
        elif lowest > 0:
            self.cost += lowest
        self.curtailed = True

    def split(self, next_id, rand: BtRandom, qlen, seed_len, qual_order):
        """splitBranch (range_source.h:644-773).  Returns new Branch."""
        tied = []          # up to 3, sliding window like the reference
        best_cost = 0xFFFF
        next_cost = 0xFFFF
        num_not_elim = 0
        i0 = max(0, self.depth0 - self.rdepth)
        hi = min(self.len, self.nranges - 1)
        for i in sorted(self.ranges):
            if i < i0 or i > hi:
                continue
            r = self.ranges[i]
            if r.eliminated:
                continue
            num_not_elim += 1
            stratum = (1 << 14) if (self.rdepth + i < seed_len) else 0
            cost = stratum | (r.quallo if qual_order else 0)
            if cost < best_cost:
                next_cost = best_cost
                best_cost = cost
                tied = [i]
            elif cost == best_cost:
                if len(tied) < 3:
                    tied.append(i)
                else:
                    tied = [tied[1], tied[2], i]
            elif cost < next_cost:
                next_cost = cost
        r = 0
        if len(tied) > 1:
            r = rand.next_u32() % len(tied)
        pos = tied[r]
        j, top, bot, last = self.ranges[pos].pick_edit(pos + self.rdepth,
                                                       rand)
        new_rdepth = self.rdepth + pos + 1
        hamadd = best_cost & ~0xC000
        depth = pos + self.rdepth
        nd0, nd1, nd2, nd3 = (self.depth0, self.depth1, self.depth2,
                              self.depth3)
        if depth < self.depth1:
            nd0 = self.depth1
        if depth < self.depth2:
            nd1 = self.depth2
        if depth < self.depth3:
            nd2 = self.depth3
        nb = Branch(next_id, qlen, nd0, nd1, nd2, nd3, new_rdepth, 0,
                    self.cost, self.ham + hamadd, top, bot,
                    edits=self.edits)
        nb.edits.append((depth, j))
        if num_not_elim == 1 and last:
            self.exhausted = True
        elif len(tied) == 1 and last:
            if best_cost != next_cost and next_cost != 0xFFFF:
                self.delayed_cost = self.cost - best_cost + next_cost
                self.delayed_increase = True
        return nb

    def install_ranges(self, c, q_allow, q):
        """installRanges (range_source.h:970-1023): mark which
        substitutions remain viable at position len."""
        r = self.range_at(self.len)
        r.eliminated = True
        r.mm_elim = [True] * 4
        r.quallo = q
        if q > q_allow:
            return
        for j in range(4):
            if j != c and r.bots[j] > r.tops[j]:
                r.eliminated = False
                r.mm_elim[j] = False

    def extend(self):
        self.len += 1


class PathManager:
    """range_source.h:1307: priority queue + id allocation.  Heap keys
    are frozen at push time, matching the reference's behavior (its
    std::priority_queue also only reorders on push/pop)."""

    def __init__(self):
        self.heap = []
        self.next_id = 0
        self.min_cost = 0

    def alloc_id(self):
        i = self.next_id
        self.next_id += 1
        return i

    def empty(self):
        return not self.heap

    def front(self) -> Branch:
        return self.heap[0][1]

    def push(self, b: Branch):
        heapq.heappush(self.heap, (b.heap_key(), b))
        self.min_cost = self.heap[0][1].cost

    def pop(self) -> Branch:
        _, b = heapq.heappop(self.heap)
        if self.heap:
            self.min_cost = self.heap[0][1].cost
        return b

    def curtail_front(self, seed_len, qual_order):
        """PathManager::curtail (range_source.h:1434-1455)."""
        br = self.front()
        orig = br.cost
        br.curtail(seed_len, qual_order)
        if br.exhausted:
            self.pop()
        elif br.cost != orig:
            self.pop()
            self.push(br)

    def split_and_prep(self, rand, qlen, seed_len, qual_order,
                       bt_cnt=None):
        """splitAndPrep (range_source.h:1459-1517).  Returns False on
        backtrack-limit abort."""
        if self.empty():
            return True
        if bt_cnt is not None and bt_cnt[0] == 0:
            return False
        f = self.front()
        while f.delayed_increase:
            self.pop()
            f.cost = f.delayed_cost
            f.delayed_increase = False
            f.delayed_cost = 0
            self.push(f)
            f = self.front()
        if f.curtailed:
            if bt_cnt is not None:
                bt_cnt[0] -= 1
                if bt_cnt[0] == 0:
                    return False
            nb = f.split(self.alloc_id(), rand, qlen, seed_len,
                         qual_order)
            if f.exhausted:
                self.pop()
            self.push(nb)
        return True


@dataclass
class FoundRange:
    top: int
    bot: int
    cost: int
    stratum: int
    num_mms: int
    fw: bool
    ebwt_fw: bool
    mms: list = field(default_factory=list)    # 5'-relative offsets
    refcs: list = field(default_factory=list)  # char ints
    mate1: bool = True


ADV_FOUND_RANGE = 0
ADV_COST_CHANGES = 1
ADV_STEP = 2


class BestRangeSource:
    """EbwtRangeSource re-expression (one strand, one index)."""

    def __init__(self, fm: GoldenFM, ebwt_fw: bool, fw: bool,
                 qual_lim=INF32, report_exacts=True, half_and_half=0,
                 seeded=False, maq_penalty=True, qual_order=True,
                 global_seed: int = 0):
        self.fm = fm
        self.ebwt_fw = ebwt_fw
        self.fw = fw
        self.global_seed = global_seed
        self.qual_lim = qual_lim
        self.report_exacts = report_exacts
        self.half_and_half = half_and_half
        self.seeded = seeded
        self.maq = maq_penalty
        self.qual_order = qual_order
        self.d5 = self.d3 = 0
        self.off0 = self.off1 = self.off2 = self.off3 = 0
        self.done = False
        self.found_range = False
        self.cur_range: FoundRange | None = None
        self.mate1 = True

    # -- setQuery (ebwt_search_backtrack.h:1831) -------------------------
    def set_query(self, read, seed_range: FoundRange | None = None):
        if self.ebwt_fw:
            qry = read.codes_fw if self.fw else read.codes_rc
            qual = read.qual if self.fw else read.qual[::-1]
        else:
            qry = (read.codes_fw if self.fw else read.codes_rc)[::-1]
            qual = read.qual[::-1] if self.fw else read.qual
        self.qry = qry.copy()
        self.qual = qual
        self.qlen = len(qry)
        self.seed_range = seed_range
        if seed_range is not None:
            for mm, rc in zip(seed_range.mms, seed_range.refcs):
                self.qry[self.qlen - mm - 1] = rc
        self.done = False
        self.found_range = False
        self.rand = BtRandom(int(read.seed(self.global_seed)))
        self.read = read

    def set_qlen(self, n):
        self.qlen = min(len(self.qry), n)

    def set_offs(self, d5, d3, o0, o1, o2, o3):
        self.d5, self.d3 = d5, d3
        self.off0, self.off1, self.off2, self.off3 = o0, o1, o2, o3

    def qual_at(self, off):
        return self.qual[off] - 33

    def _tally_ns(self):
        qlen, fc = self.qlen, self.fm.idx.ftab_chars
        ns_seed = ns_ftab = 0
        for i in range(min(self.off3, qlen)):
            if self.qry[qlen - i - 1] == 4:
                ns_seed += 1
                if (ns_seed == 1 and i < self.off0) or \
                   (ns_seed == 2 and i < self.off1) or \
                   (ns_seed == 3 and i < self.off2) or ns_seed > 3:
                    return None, 0
        for i in range(min(fc, qlen)):
            if self.qry[qlen - i - 1] == 4:
                ns_ftab += 1
        return ns_seed, ns_ftab

    # -- initBranch (:1919-2058) -----------------------------------------
    def init_branch(self, pm: PathManager):
        fm = self.fm
        fc = fm.idx.ftab_chars
        self.found_range = False
        if self.qlen < 4:
            maxmms = 0
            if self.off0 != self.off1:
                maxmms = 1
            if self.off1 != self.off2:
                maxmms = 2
            if self.off2 != self.off3:
                maxmms = 3
            if self.qlen <= maxmms:
                self.done = True
                return
        ns = self._tally_ns()
        if ns[0] is None:
            return
        _, ns_ftab = ns
        icost = self.seed_range.cost if self.seed_range else 0
        iham = (self.seed_range.cost & ~0xC000) \
            if (self.seed_range and self.qual_order) else 0
        m = min(self.off0, self.qlen)
        ftab_skips = (self.qlen == fc)
        skip_invalid_exact = (not self.report_exacts) and ftab_skips
        if ns_ftab == 0 and m >= fc and not skip_invalid_exact:
            off = 0
            for c in self.qry[self.qlen - fc: self.qlen]:
                off = (off << 2) | int(c)
            top = int(self.fm.ftab_hi[off])
            bot = int(self.fm.ftab_lo[off + 1])
            if self.qlen == fc and bot > top:
                self.cur_range = self._mk_range(top, bot, icost, [], [])
                self.found_range = True
                return
            elif bot > top:
                b = Branch(pm.alloc_id(), self.qlen, self.off0, self.off1,
                           self.off2, self.off3, 0, fc, icost, iham,
                           top, bot)
                pm.push(b)
        else:
            b = Branch(pm.alloc_id(), self.qlen, self.off0, self.off1,
                       self.off2, self.off3, 0, 0, icost, iham, 0, 0)
            pm.push(b)

    def _mk_range(self, top, bot, cost, edits_pos, edits_chr):
        """Build a FoundRange from branch edits.  Edit positions are
        search-depths (:2308: mms entry = qlen - pos - 1); seed-stage
        partial edits are lumped in per addPartialEdits (:2376)."""
        r = FoundRange(top=top, bot=bot, cost=cost, stratum=cost >> 14,
                       num_mms=len(edits_pos), fw=self.fw,
                       ebwt_fw=self.ebwt_fw,
                       mms=[self.qlen - p - 1 for p in edits_pos],
                       refcs=list(edits_chr), mate1=self.mate1)
        if self.seed_range is not None:
            r.mms += [self.qlen - m - 1 for m in self.seed_range.mms]
            r.refcs += list(self.seed_range.refcs)
            r.num_mms += len(self.seed_range.mms)
        return r

    # -- hh checks (:2397-2478) -------------------------------------------
    def _hh_check(self, b: Branch, depth, empty):
        nedits = len(b.edits)
        if depth == self.d5 - 1 and not empty:
            return nedits > 0
        elif depth == self.d3 - 1 and not empty:
            lo = hi = 0
            for pos, _ in b.edits:
                if pos < self.d5:
                    hi += 1
                elif pos < self.d3:
                    lo += 1
            invalid = lo == 0 or hi == 0
            return nedits >= self.half_and_half and not invalid
        return True

    def _hh_check_top(self, b: Branch, d):
        nedits = len(b.edits)
        if d == self.d5:
            if nedits == 0:
                return False
        elif d == self.d3:
            if nedits < self.half_and_half:
                return False
        return True

    # -- advanceBranch (:2060-2361) ----------------------------------------
    def advance_branch(self, until, min_cost, pm: PathManager,
                       bt_cnt=None):
        fm = self.fm
        self.found_range = False
        while True:
            br = pm.front()
            depth = br.tip_depth()
            cost = br.cost
            bailed = False

            if self.half_and_half and not self._hh_check_top(br, depth):
                pm.curtail_front(self.d3, self.qual_order)
                bailed = True
            else:
                cur = self.qlen - depth - 1
                if depth < self.qlen:
                    c = int(self.qry[cur])
                    q = mm_penalty(self.maq, self.qual_at(cur))
                    cur_is_alt = (depth >= br.depth0) and \
                                 (br.ham + q <= self.qual_lim)
                    pt, pb = br.top, br.bot
                    if c == 4 and depth > 0:
                        br.top = br.bot = 1
                    if br.top == 0 and br.bot == 0:
                        rs = br.range_at(br.len)
                        f = fm.idx.fchr
                        rs.tops = [int(f[0]), int(f[1]), int(f[2]),
                                   int(f[3])]
                        rs.bots = [int(f[1]), int(f[2]), int(f[3]),
                                   int(f[4])]
                        br.install_ranges(c, self.qual_lim - br.ham, q)
                        if c < 4:
                            br.top = rs.tops[c]
                            br.bot = rs.bots[c]
                    elif cur_is_alt and (pb > pt or c == 4):
                        rs = br.range_at(br.len)
                        rs.tops = fm.lf4(pt)
                        rs.bots = fm.lf4(pb)
                        br.install_ranges(c, self.qual_lim - br.ham, q)
                        if c < 4:
                            br.top = rs.tops[c]
                            br.bot = rs.bots[c]
                        else:
                            br.top = br.bot = 1
                    elif pb > pt:
                        # absent entry == eliminated; no state needed
                        if c < 4:
                            br.top = fm.lf(pt, c)
                            br.bot = fm.lf(pb, c)
                    else:
                        pass                 # absent == eliminated
                else:
                    cur = 0
                empty = br.top == br.bot
                hit = (cur == 0 and not empty)
                nedits = len(br.edits)
                invalid_exact = (hit and nedits == 0 and
                                 not self.report_exacts)
                if self.half_and_half and \
                        not self._hh_check(br, depth, empty):
                    pm.curtail_front(self.d3, self.qual_order)
                elif hit and not invalid_exact:
                    self.cur_range = self._mk_range(
                        br.top, br.bot, br.cost,
                        [p for p, _ in br.edits],
                        [jc for _, jc in br.edits])
                    self.found_range = True
                    pm.curtail_front(self.d3, self.qual_order)
                elif empty or cur == 0:
                    pm.curtail_front(self.d3, self.qual_order)
                else:
                    br.extend()

            if not pm.split_and_prep(self.rand, self.qlen, self.d3,
                                     self.qual_order, bt_cnt):
                pm.heap.clear()
                pm.min_cost = 0
            if pm.empty():
                break
            if until == ADV_COST_CHANGES and pm.front().cost != cost:
                break
            elif until == ADV_STEP:
                break
            if self.found_range:
                break
        _ = bailed
