"""Reference-semantics oracle for bowtie's greedy DFS backtracker.

This is a from-scratch Python re-expression of the search *semantics* of
GreedyDFSRangeSource (ebwt_search_backtrack.h:23-1787) — quality-aware,
randomized, depth-first mismatch search over an FM-index — used as:
  1. the executable spec the DFS machine (align/dfs_device.py) is
     tested against,
  2. the per-read host re-run of lanes that overflow the machine's
     fixed bounds.
A copy of bowtie_tpu/align/backtrack_oracle.py.

Faithfully reproduced details (needed for bit-identical output):
- visit order of the DFS, incl. the leftmost-eligible-position rule and
  the range-size-weighted random char choice (ebwt_search_backtrack.h:
  758-834) with bowtie's LCG consumed in the same order
- eligibility caching (el*/elignore) that decides when an RNG draw is
  skipped (:767)
- revisitability region tightening on recursion (:851-882)
- ftab jump-start rules at top level (:254) and mid-recursion (:908-952)
- half-and-half boundary constraints (hhCheckTop :1200, inline :664-718)
- partial-alignment reporting for seeded phases 3/4 (:637-651)
- report-time random range start + walk-left + fragment-spanning
  rejection (reportFullAlignment :1521; reportChaseOne ebwt.h:2693)
"""
from __future__ import annotations

import numpy as np

from .golden import GoldenFM
from ..utils.rng import BtRandom

INF32 = 0xFFFFFFFF

# Maq-style penalty rounding (qualRounds, qual.cpp:4: /10, round to
# nearest 10, saturate at 30)
QUAL_ROUNDS = np.zeros(256, dtype=np.uint8)
QUAL_ROUNDS[5:15] = 10
QUAL_ROUNDS[15:25] = 20
QUAL_ROUNDS[25:] = 30
_QUAL_ROUNDS_L = QUAL_ROUNDS.tolist()    # python ints: ~4x faster lookup


def mm_penalty(maq: bool, qual: int) -> int:
    return _QUAL_ROUNDS_L[qual] if maq else qual


class PartialAlignment:
    """A ≤3-mismatch seed prefix (ebwt_search_util.h:38-66 semantics,
    unpacked).  Entries are (pos_in_search_query, substituted_char)."""

    __slots__ = ("muts",)

    def __init__(self, muts):
        self.muts = tuple(muts)   # ((pos, newchar_int), ...)


class GreedyDFS:
    """One backtracker instance bound to one index (fw or mirror)."""

    def __init__(self, fm: GoldenFM, ebwt_fw: bool, sink,
                 qual_thresh: int = INF32, max_bts: int = INF32,
                 report_partials: int = 0, report_exacts: bool = True,
                 consider_quals: bool = True, half_and_half: bool = False,
                 maq_penalty: bool = True, partials_out: list | None = None,
                 joined_resolver=None):
        self.fm = fm
        self.ebwt_fw = ebwt_fw
        self.sink = sink
        self.qual_thresh = qual_thresh
        self.max_bts = max_bts
        self.report_partials = report_partials
        self.report_exacts = report_exacts
        self.consider_quals = consider_quals
        self.half_and_half = half_and_half
        self.maq = maq_penalty
        self.partials_out = partials_out if partials_out is not None else []
        self.joined = joined_resolver
        # per-query state
        self.qry = None
        self.qual = None
        self.muts = None
        self.rand = None
        self._partials_buf = []

    # -- setQuery (ebwt_search_backtrack.h:90-140) ----------------------
    def set_query(self, read, fw: bool):
        if self.ebwt_fw:
            self.qry = read.codes_fw if fw else read.codes_rc
            self.qual = read.qual if fw else read.qual[::-1]
        else:
            self.qry = (read.codes_fw if fw else read.codes_rc)[::-1]
            self.qual = read.qual[::-1] if fw else read.qual
        self.qry = self.qry.copy()
        self.read = read
        self.fw = fw
        self.qlen = len(self.qry)
        self.mms: list[int] = []
        self.refcs: list[int] = []
        self.chars = [0] * self.qlen
        self.rand = BtRandom(int(read.seed(self.sink.global_seed)))
        self.num_bts = 0
        self.bailed = False
        self._partials_buf = []

    def set_qlen(self, n: int):
        """Restrict the search to the first n chars of the query
        (setQlen; used to search only the seed in phases 2/3)."""
        self.qlen = min(len(self.qry), n)

    def set_offs(self, depth5, depth3, unrev, rev1, rev2, rev3):
        self.d5, self.d3 = depth5, depth3
        self.unrev, self.rev1, self.rev2, self.rev3 = unrev, rev1, rev2, rev3

    def set_muts(self, muts):
        """Apply seed-stage partial-alignment substitutions to the query
        (setMuts/applyPartialMutations, :165-...)."""
        if self.muts is not None:
            for pos, old, new in self.muts:
                self.qry[pos] = old
        self.muts = None
        if muts:
            applied = []
            for pos, newc in muts:
                applied.append((pos, int(self.qry[pos]), newc))
                self.qry[pos] = newc
            self.muts = applied

    def qual_at(self, off: int) -> int:
        return self.qual[off] - 33

    # -- top-level entry (:237-297) -------------------------------------
    def backtrack(self, ham: int = 0) -> bool:
        fm = self.fm
        fc = fm.idx.ftab_chars
        qlen = self.qlen
        ns_seed, ns_ftab = self._tally_ns()
        if ns_seed is None:
            return False
        m = min(self.unrev, qlen)
        if ns_ftab == 0 and m >= fc:
            top, bot = fm.ftab_range(self.qry[qlen - fc: qlen])
            if qlen == fc and bot > top:
                if self.report_partials > 0:
                    ret = self._bt(0, 0, self.unrev, self.rev1, self.rev2,
                                   self.rev3, 0, 0, ham, ham, False)
                else:
                    ret = self._report_alignment(0, top, bot, ham)
            elif bot > top:
                ret = self._bt(0, fc, self.unrev, self.rev1, self.rev2,
                               self.rev3, top, bot, ham, ham, ns_ftab > 0)
            else:
                ret = False
        else:
            ret = self._bt(0, 0, self.unrev, self.rev1, self.rev2,
                           self.rev3, 0, 0, ham, ham, ns_ftab > 0)
        if self._finalize():
            ret = True
        return ret

    def _finalize(self) -> bool:
        if self.report_partials > 0 and self._partials_buf:
            self.partials_out.extend(self._partials_buf)
            self._partials_buf = []
            return True
        return False

    def _tally_ns(self):
        """(nsInSeed, nsInFtab) or (None, _) if Ns already bust the
        budget (:1306-1343)."""
        qlen, fc = self.qlen, self.fm.idx.ftab_chars
        ns_seed = ns_ftab = 0
        for i in range(self.rev3):
            if i >= qlen:
                break
            if self.qry[qlen - i - 1] == 4:
                ns_seed += 1
                if ns_seed == 1 and i < self.unrev:
                    return None, 0
                if ns_seed == 2 and i < self.rev1:
                    return None, 0
                if ns_seed == 3 and i < self.rev2:
                    return None, 0
                if ns_seed > 3:
                    return None, 0
        for i in range(min(fc, qlen)):
            if self.qry[qlen - i - 1] == 4:
                ns_ftab += 1
        return ns_seed, ns_ftab

    # -- the recursion (:363-1091) --------------------------------------
    def _bt(self, stack_depth, depth, unrev, rev1, rev2, rev3,
            top, bot, ham, iham, disable_ftab) -> bool:
        fm = self.fm
        qlen = self.qlen
        qry = self.qry
        sink = self.sink

        if self.half_and_half:
            if self.max_bts > 0 and self.num_bts == self.max_bts:
                self.bailed = True
                return False
            self.num_bts += 1

        pairs = np.zeros((qlen, 8), dtype=np.int64)
        elims = np.zeros(qlen, dtype=np.uint8)
        alt_num = 0
        eligible_num = 0
        eligible_sz = 0
        eli = 0
        elignore = True
        eltop = elbot = 0
        elham = ham
        elchar = 0
        elcint = 0
        low_alt_qual = 0xFF

        d = depth
        cur = qlen - d - 1
        while cur >= 0:
            if self.half_and_half and not self._hh_check_top(
                    stack_depth, d):
                return False

            c = int(qry[cur])
            q = self.qual_at(cur)
            cur_is_alt = (d >= unrev) and (
                not self.consider_quals or
                ham + mm_penalty(self.maq, q) <= self.qual_thresh)
            cur_is_eligible = False
            cur_overrides = False
            if cur_is_alt:
                if self.consider_quals:
                    if q < low_alt_qual:
                        cur_is_eligible = cur_overrides = True
                    elif q == low_alt_qual:
                        cur_is_eligible = True
                else:
                    cur_is_eligible = True

            # Quartets must be computed from the range as it stood
            # BEFORE the N-hack below (the reference computes them from
            # SideLoci initialized on the previous iteration, :548).
            pt, pb = top, bot
            if c == 4 and d > 0:
                top = bot = 1   # force the "alternative" branch + empty
            # quartet computation
            if top == 0 and bot == 0:
                f = fm.idx.fchr
                pairs[d, 0:4] = f[0:4]
                pairs[d, 4:8] = f[1:5]
                if c < 4:
                    top, bot = int(pairs[d, c]), int(pairs[d, 4 + c])
            elif cur_is_alt:
                pairs[d, 0:4] = fm.lf4(pt)
                pairs[d, 4:8] = fm.lf4(pb)
                if c < 4:
                    top, bot = int(pairs[d, c]), int(pairs[d, 4 + c])
            else:
                if c < 4:
                    top, bot = fm.lf(pt, c), fm.lf(pb, c)
            # eliminate read char (or nothing for N) (:1186-1196)
            elims[d] = (1 << c) if c < 4 else 0

            if cur_is_alt:
                for i in range(4):
                    if i == c:
                        continue
                    spread = int(pairs[d, 4 + i] - pairs[d, i])
                    if spread == 0:
                        elims[d] |= (1 << i)
                    if spread > 0 and not (elims[d] & (1 << i)):
                        if cur_is_eligible:
                            if cur_overrides:
                                low_alt_qual = q
                                eligible_num = 0
                                eligible_sz = 0
                                cur_overrides = False
                                eli = d
                                eltop = int(pairs[d, i])
                                elbot = int(pairs[d, 4 + i])
                                elham = mm_penalty(self.maq, q)
                                elchar = i
                                elcint = i
                                elignore = False
                            eligible_sz += spread
                            eligible_num += 1
                        alt_num += 1

            backtrack_despite_match = False
            reported_partial = False
            if (cur == 0 and top < bot and
                    stack_depth < self.report_partials and
                    self.report_partials > 0):
                if alt_num > 0:
                    backtrack_despite_match = True
                if stack_depth > 0:
                    self._report_partial(stack_depth)
                    reported_partial = True

            invalid_exact = False
            if cur == 0 and stack_depth == 0 and bot > top and \
                    not self.report_exacts:
                invalid_exact = True
                backtrack_despite_match = True

            must_backtrack = False
            invalid_hh = False
            if self.half_and_half:
                if d == self.d5 - 1 and top < bot:
                    invalid_hh = stack_depth == 0
                    if stack_depth == 0 and alt_num > 0:
                        backtrack_despite_match = True
                        must_backtrack = True
                    elif stack_depth == 0:
                        return False
                elif d == self.d3 - 1 and top < bot:
                    lo = hi = 0
                    for i in range(stack_depth):
                        dd = qlen - self.mms[i] - 1
                        if dd < self.d5:
                            hi += 1
                        elif dd < self.d3:
                            lo += 1
                    invalid_hh = lo == 0 or hi == 0
                    if (stack_depth < 2 or invalid_hh) and alt_num > 0:
                        must_backtrack = True
                        backtrack_despite_match = True
                    elif stack_depth < 2:
                        return False

            if (cur == 0 and bot > top and not invalid_hh and
                    not invalid_exact and not reported_partial):
                if self._report_alignment(stack_depth, top, bot, ham):
                    return True
                top = bot

            # mismatch-with-alternatives loop (:743-1065)
            while (top == bot or backtrack_despite_match) and alt_num > 0:
                i = d
                j = 0
                bttop = btbot = 0
                btham = ham
                btcint = 0
                if eligible_num > 1 or elignore:
                    while i >= depth:
                        icur = qlen - i - 1
                        qi = self.qual_at(icur)
                        if (qi == low_alt_qual or
                                not self.consider_quals) and elims[i] != 15:
                            pos_sz = 0
                            for jj in range(4):
                                if not (elims[i] & (1 << jj)):
                                    pos_sz += int(pairs[i, 4 + jj] -
                                                  pairs[i, jj])
                            r = self.rand.next_u32() % pos_sz
                            for jj in range(4):
                                if not (elims[i] & (1 << jj)):
                                    spread = int(pairs[i, 4 + jj] -
                                                 pairs[i, jj])
                                    if r < spread:
                                        bttop = int(pairs[i, jj])
                                        btbot = int(pairs[i, 4 + jj])
                                        btham += mm_penalty(self.maq, qi)
                                        btcint = jj
                                        j = jj
                                        break
                                    r -= spread
                            break
                        i -= 1
                else:
                    i = eli
                    bttop, btbot = eltop, elbot
                    btham += elham
                    j = btcint = elcint
                icur = qlen - i - 1
                # tighten revisitability (:851-882)
                bt_unrev, bt_rev1, bt_rev2, bt_rev3 = (unrev, rev1, rev2,
                                                       rev3)
                if i < rev1:
                    bt_unrev, bt_rev1, bt_rev2 = rev1, rev2, rev3
                elif i < rev2:
                    bt_rev1, bt_rev2 = rev2, rev3
                elif i < rev3:
                    bt_rev2 = rev3
                # record mismatch
                if len(self.mms) <= stack_depth:
                    self.mms.append(icur)
                    self.refcs.append(j)
                else:
                    self.mms[stack_depth] = icur
                    self.refcs[stack_depth] = j
                self.chars[i] = j
                fc = fm.idx.ftab_chars
                if i + 1 == qlen:
                    ret = self._report_alignment(stack_depth + 1, bttop,
                                                 btbot, btham)
                elif (self.half_and_half and not disable_ftab and
                      self.rev2 == self.rev3 and i + 1 < fc and
                      fc <= self.d5):  # mid-recursion ftab (:908)
                    # mid-recursion ftab use (:908-952)
                    ftab_off = 0
                    for jj in range(fc, 0, -1):
                        if jj == fc:
                            ftab_off = int(qry[qlen - fc])
                        else:
                            ftab_off <<= 2
                            if qlen - jj == icur:
                                ftab_off |= btcint
                            else:
                                ftab_off |= int(qry[qlen - jj])
                    ft = int(self.fm.ftab_hi[ftab_off])
                    fb = int(self.fm.ftab_lo[ftab_off + 1])
                    if ft == fb:
                        ret = False
                    else:
                        # recursive calls default disableFtab=false
                        # (:940,959 omit the argument)
                        ret = self._bt(stack_depth + 1, fc, bt_unrev,
                                       bt_rev1, bt_rev2, bt_rev3,
                                       ft, fb, btham, iham, False)
                else:
                    ret = self._bt(stack_depth + 1, i + 1, bt_unrev,
                                   bt_rev1, bt_rev2, bt_rev3,
                                   bttop, btbot, btham, iham, False)
                if ret:
                    return True
                if self.bailed or (self.half_and_half and
                                   self.max_bts > 0 and
                                   self.num_bts >= self.max_bts):
                    self.bailed = True
                    return False
                # eliminate tried char, update counters (:984-1003)
                self.chars[i] = int(qry[icur])
                elims[i] |= (1 << j)
                eligible_sz -= (btbot - bttop)
                eligible_num -= 1
                elignore = True
                alt_num -= 1
                if alt_num == 0:
                    return False
                if eligible_num == 0 and self.consider_quals:
                    # re-scan for next eligible set (:1004-1058)
                    low_alt_qual = 0xFF
                    k = d
                    while k >= depth:
                        kcur = qlen - k - 1
                        kq = self.qual_at(kcur)
                        if k < unrev:
                            break
                        k_alt = (ham + mm_penalty(self.maq, kq) <=
                                 self.qual_thresh)
                        k_over = False
                        if k_alt:
                            if kq < low_alt_qual:
                                k_over = True
                            if kq <= low_alt_qual:
                                for l in range(4):
                                    if not (elims[k] & (1 << l)):
                                        spread = int(pairs[k, 4 + l] -
                                                     pairs[k, l])
                                        if k_over:
                                            low_alt_qual = kq
                                            k_over = False
                                            eligible_num = 0
                                            eligible_sz = 0
                                            eli = k
                                            eltop = int(pairs[k, l])
                                            elbot = int(pairs[k, 4 + l])
                                            elham = mm_penalty(self.maq,
                                                               kq)
                                            elchar = l
                                            elcint = l
                                            elignore = False
                                        eligible_num += 1
                                        eligible_sz += spread
                        k -= 1
            if must_backtrack or invalid_hh or invalid_exact:
                return False
            if top == bot and alt_num == 0:
                return False
            self.chars[d] = int(qry[cur])
            d += 1
            cur -= 1
        # consumed whole pattern (cur wrapped past 0, :1080-1090)
        if stack_depth >= self.report_partials:
            return self._report_alignment(stack_depth, top, bot, ham)
        return False

    # -- half-and-half top check (:1200-1275) ---------------------------
    def _hh_check_top(self, stack_depth, d) -> bool:
        if d == self.d5:
            if self.rev3 == self.rev2:
                if stack_depth == 0:
                    return False
            else:
                if stack_depth < 1:
                    return False
        elif d == self.d3:
            if self.rev3 == self.rev2:
                if stack_depth < 2:
                    return False
            else:
                lo = hi = 0
                for i in range(stack_depth):
                    dd = self.qlen - self.mms[i] - 1
                    if dd < self.d5:
                        hi += 1
                    elif dd < self.d3:
                        lo += 1
                if lo == 0:
                    return False
        return True

    # -- stratum (:1164-1181) -------------------------------------------
    def _calc_stratum(self, mms, stack_depth) -> int:
        stratum = 0
        for i in range(stack_depth):
            if mms[i] >= self.qlen - self.rev3:
                stratum += 1
        return stratum

    # -- partial reporting (:1600-1680 reportPartial) --------------------
    def _report_partial(self, stack_depth):
        muts = []
        for i in range(stack_depth):
            pos = self.mms[i]
            muts.append((pos, self.refcs[i]))
        self._partials_buf.append(PartialAlignment(muts))

    # -- full-alignment reporting (:1455-1565) ---------------------------
    def _report_alignment(self, stack_depth, top, bot, cost) -> bool:
        if self.report_partials > 0:
            if stack_depth > 0:
                self._report_partial(stack_depth)
            return False
        if stack_depth == 0 and not self.report_exacts:
            # exact hits already reported by an earlier phase (:1528)
            return False
        stratum = self._calc_stratum(self.mms, stack_depth) \
            if stack_depth > 0 else 0
        mms = list(self.mms[:stack_depth])
        refcs = list(self.refcs[:stack_depth])
        if self.muts is not None:
            # account for seed-stage mutations (:1489-1519): undo muts
            # on qry, promote them into the mm list, bump the stratum
            for pos, old, new in self.muts:
                mms.append(pos)
                refcs.append(new)
            stratum += len(self.muts)
        num_mms = len(mms)
        cost = cost | (stratum << 14)
        spread = bot - top
        r = top + self.rand.next_u32() % spread
        for i in range(spread):
            ri = r + i
            if ri >= bot:
                ri -= spread
            if self._report_chase_one(mms, refcs, num_mms, ri, top, bot,
                                      stratum, cost):
                return True
        return False

    def _report_chase_one(self, mms, refcs, num_mms, row, top, bot,
                          stratum, cost) -> bool:
        off = self.fm.resolve_row(row)
        res = self.fm.joined_to_text_off(self.qlen, off, self.ebwt_fw)
        if res is None:
            return False
        tidx, textoff, _tlen = res
        return self.sink.report_hit(
            read=self.read, fw=self.fw, ebwt_fw=self.ebwt_fw,
            qry=self.qry, mms=mms, refcs=refcs, num_mms=num_mms,
            tidx=tidx, toff=textoff, top=top, bot=bot,
            stratum=stratum, cost=cost, qlen=self.qlen)
