"""The best-first engine on the card: --best, --strata, -M, -v 3 and the
seeded -n --best modes.

A port of bowtie_tpu/align/best_device.py.  bowtie forces its
branch-and-bound engine for these modes (ebwt_search.cpp:852,877); the
host form of that engine is align/best.py + align/best_driver.py (driver
DAGs in align/best_factories.py).  Here a batch of reads runs as lanes of
one state machine whose state holds every lane's branch pool, driver
states and sink counters.

Faithfulness: every transition mirrors the host engine, including the
PathManager order (CostCompare: cost asc, extendable first, deeper tip,
smaller id; range_source.h:1103), curtail / splitBranch / pick_edit with
their RNG draws (range_source.h:644-939) and the shared --maxbts
ceiling, CostAware's selection-sort tie draws and the strandFix
delayed-range swap (range_source.h:2033-2400), the seeded driver's
generator/extender scheduling with extenders created per seed partial
(ebwt_search_backtrack.h:2935-3140), the RangeChaser's random first row
(range_chaser.h:22) and the NBestFirstStrat sink rules (hit.h:1039,1123).
A lane that exceeds a fixed bound (branch slots, edit slots, extender
slots, hit slots, the step budget) raises `overflow` and is re-run on the
host engine from scratch; the per-read RNG makes that bit-identical.

This module holds:

  host part   <- best_device.py:61-631, copied: the constants, the driver
                 DAGs (v_mode_configs, seeded_mode_configs), the initial
                 per-lane state (HostInit) and its CostAware sort draws.
  K10         <- best_device.py:638 _init_state_jit, :2224 run_chunk
                 (:2173 _machine_step): init_state + run_machine_plain,
                 the lockstep machine in torch ops, held array for array
                 to the reference, iteration count included; run_machine
                 launches csrc/best.cu's best_machine_kernel on the card.
  K11         <- best_device.py:2264 _harvest_small, :2270 _poll_all,
                 :2311 _gather_rows (:2278 _harvest_poll, :2344
                 _merge_out): best_pack packs the lanes' scalars and hit
                 rows into one buffer for one download.  The lane
                 compaction of the reference's driver (:2249 _compact,
                 :2353 run_compacting) has no counterpart: each thread of
                 K10 runs its own lane to the end and retires it.
  DeviceBestAligner <- best_device.py:2412: the exact gate on K2, K10, K11,
                 then the per-read results on the host.

The CUDA kernel of K10 runs one thread per lane through that lane's
transitions to M_DONE.  A sub-step reads and writes only its own lane, and
the lockstep's gating by start-of-iteration mode counts changes only when
a lane runs a sub-step, never what it computes; so a lane run alone ends
in the state the lockstep machine gives it.  Step budget: the plain
version stops after max_steps lockstep iterations; one iteration applies
each of _machine_step's 18 sub-steps at most once to a lane, so the
kernel gives each lane 18 * max_steps transitions, and a lane the
lockstep version finishes within budget also finishes in the kernel.  A
lane that only the lockstep version flags by budget gets the machine's
answer from the kernel and the host engine's from the plain version; the
two agree, so the CLI's bytes do.  (The reference's run_compacting cuts
max_steps to a boundary of its chunk schedule; the budget changes which
lanes fall back, never the output.)

Record mode (K10r, best_device.py:1030-1120), for the paired-end V1
engine (align/pe_device.py): a found range is appended to the lane's hit
pool in emission order (_record_range) instead of being chased, until the
lane's driver is exhausted or `rec_cap` ranges are recorded; one run holds
lanes of two driver DAGs through the per-lane config bases cfg0f/cfg0o
(_cfgF/_cfgO, :854-866), which every config read goes through.

Paired record mode (K14, `paired=True`), for the paired V2 engine
(align/pev2_device.py): one lane per pair runs the merged DAG of both
mates' drivers.  Each outer reads its own mate's length and seed
(qlen_o, seed_o, :675-681; the record's length column, the seeded
extender's dqlen and RNG seed, the chase's offset resolve), the strandFix
scan looks for the other strand of the same mate (o_m1, :1666-1673), and
the outer CostAware is done once either mate has no live outer (mate
elimination, :1141-1159).  In every other run qlen_o and seed_o are the
lane's qlen and seed and o_m1 is all ones, so those runs read what they
read before.  The kernel is instantiated for paired and other runs; both
size a lane's state by the run's nd outer and ndt flat drivers, up to the
config tables' 16 and 48 (csrc/best.cu), and launch in machine_shape's
blocks.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..index.arrays import OCC_BLOCK, u32
from ..index.ebwt_io import EbwtIndex
from ..ops.fm import lf4pair_plain, lf_row_compact_plain, words_needed
from ..utils.rng import fill_seed_caches
from .dfs_device import _len_bucket, build_fmpair
from .exact import exact_ranges, right_align

INF32 = 0x7FFFFFFF
COST_INF = 0xFFFF          # host engine's 16-bit "no cost" sentinel

# resource bounds (per lane); overflow -> host-engine fallback
NBR = 16                   # branch pool slots
E_MAX = 6                  # edits per branch
H_MAX = 16                 # buffered hit slots
MM_SLOTS = 8               # mismatch slots per stored hit record
PEX = 4                    # extender slots per seeded outer driver

# machine modes
(M_DONE, M_MAIN, M_CADV, M_OADV, M_DADV, M_EXT, M_SPP, M_DEND,
 M_ODEND, M_CPOST, M_SFX, M_SFXEND, M_SORT, M_CHASE,
 M_SD, M_SDGEN, M_SDFULL, M_ICADV, M_ICPOST) = range(19)

# phase: where a flat-driver advance (DADV..DEND) returns to
PH_OUTER, PH_GEN, PH_FULL = 0, 2, 3

# meta encoding: bits 0-3 mm_elim (1 = eliminated substitution),
# bit 4 eliminated (whole position), bits 5-11 quallo, bit 12
# "depth-0 quartet came from fchr" flag
META_ELIM = 1 << 4
META_ALL_DEAD = 0xF | META_ELIM | (127 << 5)
META_FCHR = 1 << 12

# pin constants (SearchConstraintExtent)
PIN_BEG, PIN_LEN, PIN_HI, PIN_SEED = 0, 1, 2, 3

_QR = np.zeros(256, dtype=np.int32)     # Maq rounding (qual.cpp:4)
_QR[5:15] = 10
_QR[15:25] = 20
_QR[25:] = 30


@dataclass(frozen=True)
class DriverCfg:
    """Static config of one flat range source (BestRangeSource +
    BestDriver)."""
    ebwt_fw: bool
    fw: bool
    pins: tuple           # 4 PIN_* constants
    report_exacts: bool
    hh: int               # half_and_half (0, 2 or 3)
    nudge_left: bool
    seed: bool = False    # truncate query to the seed (gen drivers)


@dataclass(frozen=True)
class OuterCfg:
    kind: str             # "plain" | "seeded"
    cfg: DriverCfg        # plain driver / generator
    ext: DriverCfg | None = None


def v_mode_configs(v: int, nofw: bool, norc: bool) -> list[OuterCfg]:
    """Driver DAGs of make_best_aligner (aligner_0mm/1mm/23mm.h
    factories; see best_factories.py for the host equivalents)."""
    out = []

    def plain(*a):
        out.append(OuterCfg("plain", DriverCfg(*a)))

    if v == 0:
        P = (PIN_LEN,) * 4
        if not nofw:
            plain(True, True, P, True, 0, True)
        if not norc:
            plain(True, False, P, True, 0, True)
    elif v == 1:
        P = (PIN_HI, PIN_LEN, PIN_LEN, PIN_LEN)
        if not nofw:
            plain(False, True, P, True, 0, False)
            plain(True, True, P, False, 0, True)
        if not norc:
            plain(True, False, P, True, 0, True)
            plain(False, False, P, False, 0, False)
    else:
        two = v == 2
        Pfull = (PIN_HI, PIN_HI, PIN_LEN if two else PIN_HI, PIN_LEN)
        Phalf = (PIN_BEG, PIN_HI, PIN_LEN if two else PIN_HI, PIN_LEN)
        Phalf3 = (PIN_BEG, PIN_HI, PIN_HI, PIN_LEN)
        if not nofw:
            plain(False, True, Pfull, True, 0, True)
            plain(True, True, Pfull, False, 0, False)
            plain(False, True, Phalf, False, 2, True)
            if not two:
                plain(True, True, Phalf3, False, 3, False)
        if not norc:
            plain(True, False, Pfull, True, 0, True)
            plain(False, False, Pfull, False, 0, False)
            plain(True, False, Phalf, False, 2, True)
            if not two:
                plain(False, False, Phalf3, False, 3, False)
    return out


def seeded_mode_configs(seed_mms: int, nofw: bool,
                        norc: bool) -> list[OuterCfg]:
    """Driver DAGs of make_seeded_best_aligner
    (aligner_seed_mm.h:80-532; best_factories.py
    seeded_best_driver_factory)."""
    SEED, HI, BEG = PIN_SEED, PIN_HI, PIN_BEG
    out = []
    n = seed_mms
    for fw in (True, False):
        if fw and nofw:
            continue
        if not fw and norc:
            continue
        efw_e = not fw          # exact-side index: mirror for fw reads
        efw_g = fw              # generator side: the opposite

        def plain(pins, exacts, hh=0):
            out.append(OuterCfg("plain", DriverCfg(
                efw_e, fw, pins, exacts, hh, True)))

        def seeded(gen_pins, gen_hh=0):
            gen = DriverCfg(efw_g, fw, gen_pins, False, gen_hh, False,
                            seed=True)
            ext = DriverCfg(efw_e, fw, (SEED,) * 4, True, 0, True)
            out.append(OuterCfg("seeded", gen, ext))

        if n == 0:
            plain((SEED,) * 4, True)
        elif n == 1:
            plain((HI, SEED, SEED, SEED), True)
            seeded((HI, SEED, SEED, SEED))
        elif n == 2:
            plain((HI, HI, SEED, SEED), True)
            seeded((HI, HI, SEED, SEED))
            plain((BEG, HI, SEED, SEED), False, hh=2)
        else:
            plain((HI, HI, HI, SEED), True)
            seeded((HI, HI, HI, SEED))
            seeded((BEG, HI, HI, SEED), gen_hh=3)
            plain((BEG, HI, HI, SEED), False, hh=2)
    return out


def _outer_min_cost(oc: OuterCfg, read, seed_len: int, maq: bool,
                    qual_order: bool) -> int:
    """Initial minCostAdjustment of one CostAware vec entry
    (BestDriver._init_range_source / initRangeSource,
    ebwt_search_backtrack.h:2721-2805) — pure arithmetic over the
    read's qualities, no search.  For seeded outers the SeededDriver's
    min_cost equals its generator's adjustment."""
    from .best_driver import cext_to_depth
    from .backtrack_oracle import mm_penalty
    cfg = oc.cfg
    length = len(read.seq)
    if cfg.ebwt_fw:
        qual = read.qual if cfg.fw else read.qual[::-1]
    else:
        qual = read.qual[::-1] if cfg.fw else read.qual
    s = min(seed_len, length) if seed_len > 0 else length
    s_right = s >> 1
    if s & 1 and not cfg.nudge_left:
        s_right += 1
    rev0 = cext_to_depth(cfg.pins[0], s_right, s, length)
    qlen = s if (cfg.seed and length > s) else length
    if cfg.report_exacts:
        return 0
    if not cfg.hh and rev0 < s:
        mc = 1 << 14
        if qual_order:
            lo = min(qual[qlen - d - 1] for d in range(rev0, s))
            mc += mm_penalty(maq, lo - 33)
        return mc
    if cfg.hh and 0 < s_right < s - 1:
        mc = (3 if cfg.seed else 2) << 14
        if qual_order:
            lo1 = min(qual[qlen - d - 1] for d in range(0, s_right))
            mc += mm_penalty(maq, lo1 - 33)
            half2 = sorted(qual[qlen - d - 1]
                           for d in range(s_right, s))
            mc += mm_penalty(maq, half2[0] - 33)
            if cfg.hh > 2 and len(half2) > 1:
                mc += mm_penalty(maq, half2[1] - 33)
        return mc
    return 0


def _emulate_sort_actives(costs: list, rand) -> list:
    """CostAware sortActives over the STATIC initial costs
    (range_source.h:2367+: selection sort, random swap on equal
    costs).  Returns the active order as construction indices."""
    vec = list(range(len(costs)))
    c = list(costs)
    sz = len(vec)
    i = 0
    while i < sz:
        mn, mo = c[i], i
        for j in range(i + 1, sz):
            if c[j] < mn:
                mn, mo = c[j], j
            elif c[j] == mn:
                if rand.next_u32() & 0x1000:
                    mo = j
        if mo != i:
            vec[i], vec[mo] = vec[mo], vec[i]
            c[i], c[mo] = c[mo], c[i]
        i += 1
    return vec


def flatten_outer(outers: list[OuterCfg]):
    """Flat sub-driver list + outer->flat maps."""
    flat: list[DriverCfg] = []
    o_kind, o_flat0, o_exbase = [], [], []
    for oc in outers:
        o_flat0.append(len(flat))
        if oc.kind == "plain":
            o_kind.append(0)
            o_exbase.append(-1)
            flat.append(oc.cfg)
        else:
            o_kind.append(1)
            flat.append(oc.cfg)            # generator at flat0
            o_exbase.append(len(flat))
            flat.extend([oc.ext] * PEX)    # extender slots
    return flat, np.array(o_kind, np.int32), \
        np.array(o_flat0, np.int32), np.array(o_exbase, np.int32)


def _host_rng_next(state):
    """Vectorized BtRandom.next_u32 on host (random_source.h:36-42)."""
    A, C = np.uint32(1664525), np.uint32(1013904223)
    s1 = (A * state + C).astype(np.uint32)
    ret = s1 >> np.uint32(16)
    s2 = (A * s1 + C).astype(np.uint32)
    return s2, (ret ^ s2).astype(np.uint32)


def cfg_arrays(flat: list[DriverCfg], outers: list[OuterCfg],
               o_kind, o_flat0, o_exbase):
    a = dict(
        ebwt_fw=np.array([c.ebwt_fw for c in flat], np.int32),
        fw=np.array([c.fw for c in flat], np.int32),
        exacts=np.array([c.report_exacts for c in flat], np.int32),
        hh=np.array([c.hh for c in flat], np.int32),
        same=np.array([c.ebwt_fw == c.fw for c in flat], np.int32),
        is_ext=np.zeros(len(flat), np.int32),
        o_kind=o_kind, o_flat0=o_flat0, o_exbase=o_exbase,
        o_fw=np.array([oc.cfg.fw for oc in outers], np.int32),
        # the index a CHASED range lives in: the plain driver's own
        # side, or the extender side for seeded outers
        o_chase_efw=np.array(
            [(oc.ext.ebwt_fw if oc.kind == "seeded" else
              oc.cfg.ebwt_fw) for oc in outers], np.int32),
        # per-outer mate flag: all ones for a single read's DAG; the
        # paired V2 machine (align/pev2_device.py) sets each merged
        # outer's mate, which the strandFix scan and mate elimination read
        o_m1=np.ones(len(outers), np.int32),
    )
    for oi, oc in enumerate(outers):
        if oc.kind == "seeded":
            a["is_ext"][o_exbase[oi]:o_exbase[oi] + PEX] = 1
    return a


class HostInit:
    """Vectorized numpy re-expression of set_query over the whole
    batch: per-flat-driver offsets/min-cost adjustments, N tallies,
    initial branches (incl. ftab jump-start and the dqlen==fc
    immediate-range case), outer/inner driver states and the initial
    sort_actives RNG draws."""

    def __init__(self, outers: list[OuterCfg], idx_fw, idx_bw,
                 maq: bool, qual_order: bool, qual_lim: int,
                 seed_len: int):
        self.outers = outers
        self.flat, o_kind, o_flat0, o_exbase = flatten_outer(outers)
        self.cfg = cfg_arrays(self.flat, outers, o_kind, o_flat0,
                              o_exbase)
        self.nd = len(outers)
        self.ndt = len(self.flat)
        self.maq = maq
        self.qual_order = qual_order
        self.qual_lim = qual_lim
        self.seed_len = seed_len
        self.fc = idx_fw.ftab_chars
        fh_fw, fl_fw = idx_fw.ftab_resolved()
        fh_bw, fl_bw = idx_bw.ftab_resolved()
        self.ftab_hi = (fh_fw, fh_bw)     # [0]=fw index, [1]=mirror
        self.ftab_lo = (fl_fw, fl_bw)

    def _derive_rows(self, c: DriverCfg, codes, qual, qlen, dq, L):
        """By-depth code/qual rows for one flat driver: pos(d) =
        dq-1-d if ebwt_fw == fw else qlen-dq+d; complement iff rc;
        depths beyond dq read N (BestRangeSource.set_query +
        set_qlen)."""
        di = np.arange(L)[None, :]
        in_q = di < dq[:, None]
        same = c.ebwt_fw == c.fw
        pos = np.where(in_q,
                       (dq[:, None] - 1 - di) if same
                       else (qlen[:, None] - dq[:, None] + di), 0)
        cd = np.take_along_axis(codes, pos, 1)
        if not c.fw:
            cd = np.where(cd < 4, 3 - cd, cd)
        qd = np.where(in_q, cd, 4)
        quald = np.where(in_q, np.take_along_axis(qual, pos, 1), 0)
        return qd, quald

    def build(self, reads, L: int, seeds: np.ndarray):
        B = len(reads)
        nd, ndt = self.nd, self.ndt
        qlen = np.array([len(r.seq) for r in reads], np.int32)
        codes = np.full((B, L), 4, np.int32)
        qual = np.zeros((B, L), np.int32)
        for b, r in enumerate(reads):
            n = len(r.seq)
            codes[b, :n] = np.asarray(r.codes_fw, np.int32)
            qual[b, :n] = np.frombuffer(bytes(r.qual), np.uint8)[:n] \
                .astype(np.int32) - 33
        pen = _QR[np.clip(qual, 0, 255)] if self.maq else qual.copy()

        st = dict(qlen=qlen, codes=codes, qual=qual, pen=pen)

        # --- per-flat-driver geometry --------------------------------
        sl = self.seed_len
        dqlen = np.zeros((B, ndt), np.int32)
        dd5 = np.zeros((B, ndt), np.int32)
        dd3 = np.zeros((B, ndt), np.int32)
        rev = np.zeros((B, ndt, 4), np.int32)
        for f, c in enumerate(self.flat):
            s = np.minimum(sl, qlen) if sl > 0 else qlen.copy()
            odd = (s & 1).astype(np.int32)
            d5 = (s >> 1) + (0 if c.nudge_left else odd)
            dq = s if c.seed else qlen
            dqlen[:, f] = dq
            dd5[:, f] = d5
            dd3[:, f] = s
            for k in range(4):
                pin = c.pins[k]
                rev[:, f, k] = (s if pin == PIN_SEED else
                                d5 if pin == PIN_HI else
                                0 if pin == PIN_BEG else qlen)
        st["dqlen"], st["dd5"], st["dd3"] = dqlen, dd5, dd3

        # static per-(lane, flat-driver) by-depth rows [qd | pend]:
        # the device machine one-hot-selects these instead of deriving
        # rows with gathers (see _derive_qd)
        rows_qp = np.zeros((B, ndt, 2 * L), np.int8)
        for f, c in enumerate(self.flat):
            qd_f, quald_f = self._derive_rows(c, codes, qual, qlen,
                                              dqlen[:, f], L)
            pend_f = _QR[np.clip(quald_f, 0, 255)] if self.maq \
                else quald_f
            rows_qp[:, f, :L] = np.clip(qd_f, -128, 127)
            rows_qp[:, f, L:] = np.clip(pend_f, 0, 127)
        st["rows_qp"] = rows_qp

        di = np.arange(L)[None, :]
        adj = np.zeros((B, ndt), np.int32)
        drv_dead = np.zeros((B, ndt), bool)
        drv_skip = np.zeros((B, ndt), bool)
        ns_ftab = np.zeros((B, ndt), np.int32)
        qd_all = {}
        for f, c in enumerate(self.flat):
            if self.cfg["is_ext"][f]:
                continue                    # created dynamically
            dq = dqlen[:, f]
            qd, quald = self._derive_rows(c, codes, qual, qlen, dq, L)
            qd_all[f] = qd
            pend = _QR[np.clip(quald, 0, 255)] if self.maq else quald
            in_q = di < dq[:, None]
            # min_cost_adj (best_driver.py _init_range_source)
            s = dd3[:, f]
            d5 = dd5[:, f]
            if not c.report_exacts:
                pe = np.where((di >= rev[:, f, 0:1]) & in_q, pend,
                              INF32)
                if not c.hh:
                    v_ = (1 << 14) + (self.qual_order * pe.min(axis=1))
                    adj[:, f] = np.where(rev[:, f, 0] < s, v_, 0)
                else:
                    base = (3 if c.seed else 2) << 14
                    lo1 = np.where((di < d5[:, None]) & in_q, pend,
                                   INF32).min(axis=1)
                    h2 = np.where((di >= d5[:, None]) &
                                  (di < s[:, None]) & in_q, pend,
                                  INF32)
                    h2s = np.sort(h2, axis=1)
                    v_ = np.full(B, base, np.int32)
                    if self.qual_order:
                        v_ = v_ + lo1 + h2s[:, 0]
                        if c.hh > 2:
                            v_ = v_ + np.where(h2s[:, 1] < INF32,
                                               h2s[:, 1], 0)
                    ok = (d5 > 0) & (d5 < s - 1)
                    adj[:, f] = np.where(ok, v_, 0)
            # N tallies (_tally_ns)
            lim = np.minimum(rev[:, f, 3], dq)
            isn = (qd == 4) & (di < lim[:, None])
            csum = np.cumsum(isn, axis=1)
            dead = np.zeros(B, bool)
            for k, col in ((1, 0), (2, 1), (3, 2)):
                at = isn & (csum == k)
                has = at.any(axis=1)
                p = np.argmax(at, axis=1)
                dead |= has & (p < rev[:, f, col])
            dead |= csum[:, -1] > 3
            # init_branch's dqlen < 4 early-out — the ONLY condition
            # that sets rs.done at setQuery (ebwt_search_backtrack.h:
            # 1935-1948); an N-killed source stays alive with nothing
            # pushed (tallyNs failure is a bare `return`, :1950-1955)
            # and participates in sortActives until first advanced
            maxmms = np.zeros(B, np.int32)
            for a_, b_ in ((0, 1), (1, 2), (2, 3)):
                maxmms = np.where(rev[:, f, a_] != rev[:, f, b_],
                                  a_ + 1, maxmms)
            skip = (dq < 4) & (dq <= maxmms)
            drv_skip[:, f] = skip
            drv_dead[:, f] = dead | skip
            ns_ftab[:, f] = ((qd[:, :self.fc] == 4) &
                             (di[:, :self.fc] < dq[:, None])) \
                .sum(axis=1)
        st["drv_adj"] = adj

        # --- init_branch per non-extender flat driver -----------------
        fc = self.fc
        zero = lambda *s_: np.zeros(s_, np.int32)
        P = dict(p_valid=zero(B, NBR), p_drv=zero(B, NBR),
                 p_cost=zero(B, NBR), p_ham=zero(B, NBR),
                 p_rdepth=zero(B, NBR), p_len=zero(B, NBR),
                 p_top=zero(B, NBR), p_bot=zero(B, NBR),
                 p_curt=zero(B, NBR), p_dly=zero(B, NBR),
                 p_dlyf=zero(B, NBR), p_id=zero(B, NBR),
                 p_ne=zero(B, NBR))
        p_d = np.zeros((B, NBR, 4), np.int32)
        drv_done = np.ones((B, ndt), np.int32)   # extenders start done
        drv_found = np.zeros((B, ndt), np.int32)
        drv_min = np.zeros((B, ndt), np.int32)
        nextid = np.zeros((B, ndt), np.int32)
        rr = np.zeros((B, ndt, 5), np.int32)
        slot_cursor = 0
        for f, c in enumerate(self.flat):
            if self.cfg["is_ext"][f]:
                continue
            dq = dqlen[:, f]
            qd = qd_all[f]
            off0 = rev[:, f, 0]
            m = np.minimum(off0, dq)
            ftab_skips = dq == fc
            skip_inv = (not c.report_exacts) & ftab_skips
            use_ftab = (ns_ftab[:, f] == 0) & (m >= fc) & ~skip_inv
            w = 2 * np.arange(fc)[None, :]
            qf = np.where(qd[:, :fc] > 3, 0, qd[:, :fc])
            foff = (qf << w).sum(axis=1)
            fh = self.ftab_hi[0 if c.ebwt_fw else 1]
            fl = self.ftab_lo[0 if c.ebwt_fw else 1]
            ft = fh[foff].astype(np.int64).astype(np.int32)
            fb = fl[foff + 1].astype(np.int64).astype(np.int32)
            nonempty = fb > ft
            alive = ~drv_dead[:, f]
            imm = alive & use_ftab & (dq == fc) & nonempty
            drv_found[:, f] = imm
            rr[imm, f, 0] = ft[imm]
            rr[imm, f, 1] = fb[imm]
            pushf = alive & use_ftab & (dq > fc) & nonempty
            push0 = alive & ~use_ftab
            pushed = pushf | push0
            slot = slot_cursor
            slot_cursor += 1
            P["p_valid"][pushed, slot] = 1
            P["p_drv"][:, slot] = f
            P["p_len"][pushf, slot] = fc
            P["p_top"][pushf, slot] = ft[pushf]
            P["p_bot"][pushf, slot] = fb[pushf]
            p_d[pushed, slot, :] = rev[pushed, f, :]
            nextid[pushed, f] = 1
            # done = rs.done only (range_source.h:1766): an alive
            # driver with an empty pool participates in sortActives
            # (soaking tie draws) until its first advance kills it in
            # _step_dadv — required for CostAware RNG-sequence parity
            drv_done[:, f] = drv_skip[:, f].astype(np.int32)
            drv_min[:, f] = adj[:, f]    # max(icost=0, adj)
        assert slot_cursor <= NBR
        st.update(P)
        st["p_d0"], st["p_d1"] = p_d[:, :, 0], p_d[:, :, 1]
        st["p_d2"], st["p_d3"] = p_d[:, :, 2], p_d[:, :, 3]

        # --- outer driver state --------------------------------------
        kind = self.cfg["o_kind"]
        flat0 = self.cfg["o_flat0"]
        od_done = np.zeros((B, nd), np.int32)
        od_found = np.zeros((B, nd), np.int32)
        od_min = np.zeros((B, nd), np.int32)
        for oi in range(nd):
            f = flat0[oi]
            if kind[oi] == 0:
                od_done[:, oi] = drv_done[:, f]
                od_found[:, oi] = drv_found[:, f]
                od_min[:, oi] = drv_min[:, f]
            else:
                # SeededDriver.set_query: done False,
                # min = max(gen adj, gen min)
                od_min[:, oi] = np.maximum(adj[:, f], drv_min[:, f])
        st.update(drv_done=drv_done, drv_found=drv_found,
                  drv_min=drv_min, drv_nextid=nextid, rr=rr,
                  od_done=od_done, od_found=od_found, od_min=od_min)

        # --- initial outer sort_actives ------------------------------
        rng_ca = seeds.astype(np.uint32).copy()
        act = np.tile(np.arange(nd, dtype=np.int32), (B, 1))
        act_n = np.full(B, nd, np.int32)
        act, act_n, rng_ca, ca_min = _host_sort_actives(
            act, act_n, od_done, od_found, od_min, rng_ca,
            np.zeros(B, np.int32))
        st.update(act=act, act_n=act_n, rng_ca=rng_ca, ca_min=ca_min)
        return st


def _host_sort_actives(act, act_n, done, found, minc, rng, ca_min):
    """sortActives (range_source.h:2367+) on host, vectorized over B,
    replicated draw-for-draw: selection sort with a draw per tie."""
    B, nd = act.shape
    act = act.copy()
    act_n = act_n.copy()
    i = np.zeros(B, np.int32)
    rows = np.arange(B)
    for _ in range(2 * nd):
        run = i < act_n
        if not run.any():
            break
        cur = np.take_along_axis(act, i[:, None].clip(0, nd - 1),
                                 1)[:, 0]
        rm = run & (done[rows, cur] > 0) & (found[rows, cur] == 0)
        if rm.any():
            cols = np.arange(nd)[None, :]
            shift = rm[:, None] & (cols >= i[:, None])
            src = np.clip(cols + 1, 0, nd - 1)
            act = np.where(shift, np.take_along_axis(act, src, 1), act)
            act_n = np.where(rm, act_n - 1, act_n)
        sel = run & ~rm
        if sel.any():
            min_cost = minc[rows, cur]
            min_off = i.copy()
            for joff in range(1, nd):
                j = i + joff
                vj = sel & (j < act_n)
                cj = np.take_along_axis(act, j[:, None].clip(0, nd - 1),
                                        1)[:, 0]
                skip = (done[rows, cj] > 0) & (found[rows, cj] == 0)
                cost_j = minc[rows, cj]
                ok = vj & ~skip
                less = ok & (cost_j < min_cost)
                tie = ok & (cost_j == min_cost)
                rng2, draw = _host_rng_next(rng)
                rng = np.where(tie, rng2, rng)
                take = less | (tie & ((draw & 0x1000) > 0))
                min_cost = np.where(less, cost_j, min_cost)
                min_off = np.where(take, j, min_off)
            do = sel & (min_off != i)
            if do.any():
                vi = np.take_along_axis(
                    act, i[:, None].clip(0, nd - 1), 1)[:, 0]
                vm = np.take_along_axis(
                    act, min_off[:, None].clip(0, nd - 1), 1)[:, 0]
                cols = np.arange(nd)[None, :]
                act = np.where(do[:, None] & (cols == i[:, None]),
                               vm[:, None], act)
                act = np.where(do[:, None] & (cols == min_off[:, None]),
                               vi[:, None], act)
            i = np.where(sel, i + 1, i)
    first = np.take_along_axis(act, np.zeros((B, 1), np.int32), 1)[:, 0]
    ca_min = np.where(act_n > 0,
                      np.maximum(minc[rows, first], ca_min), ca_min)
    return act, act_n, rng, ca_min


# ---------------------------------------------------------------------------
# K10 plain: the lockstep machine on [B] tensors
# ---------------------------------------------------------------------------
#
# The state is a dict of int64 tensors (overflow is bool), keyed and laid
# out as the reference's state (bowtie_tpu/align/best_device.py:647
# _init_state), the per-outer read length and seed qlen_o/seed_o included
# (the lane's qlen and seed unless the paired V2 machine gives them per
# mate): per-driver blocks are flat element-major [B, W*K] (element e of
# block k at column e*K + k), the pools [B, NBR, *], hits
# [B, H_MAX*HIT_W].  uint32 values (the RNG
# states, seeds) are held in int64.  Each _step_* below is the reference
# sub-step of the same name in torch ops: one-hot masked writes over the
# lanes in its mode, the same reads and the same RNG draws.

HIT_W = 8 + 2 * MM_SLOTS                 # hit record width

# what a run reads, counted as distinct items into `work` (for bounds):
# occ checkpoints and bwt blocks (128 rows each) that ranks and walk steps
# need, SA entries (dense SA, or the sampled SA) that the chase loads and
# ftab offsets (a hi and a lo word each) that extender set-ups read, all
# per index
TOUCHED = ("occ_entries", "bwt_blocks", "sa_entries", "ftab_entries")
WORK_KEYS = ("rank_ends", "rank_codes", "word_codes", "walk_steps",
             "sa_loads", "iterations") + TOUCHED
U32 = 0xFFFFFFFF
_LCG_A, _LCG_C = 1664525, 1013904223

# the host arrays init_state copies (HostInit.build's keys)
P_KEYS = ("p_valid", "p_drv", "p_cost", "p_ham", "p_rdepth", "p_len",
          "p_top", "p_bot", "p_curt", "p_dly", "p_dlyf", "p_id", "p_ne",
          "p_d0", "p_d1", "p_d2", "p_d3")


def _rng_next(state):
    """RandomSource::nextU32 (random_source.h:36-42) on uint32 values
    held in int64: (new state, value)."""
    s1 = (_LCG_A * state + _LCG_C) & U32
    s2 = (_LCG_A * s1 + _LCG_C) & U32
    return s2, (s1 >> 16) ^ s2


def init_state(B: int, L: int, nd: int, ndt: int, seeds: torch.Tensor,
               host: dict, maxbts: int, device) -> dict:
    """The machine's initial state (bowtie_tpu/align/best_device.py:647
    _init_state) on `device`: HostInit.build's arrays `host` (numpy, [B]
    leading) and the per-read seeds (uint32 values).  The paired V2
    machine's host arrays also give qlen_o/seed_o [B, nd] and rng_rs
    [B, ndt] (:660-681, :731); without them every outer reads the lane's
    qlen and seed."""
    dev = torch.device(device)

    def z(*s):
        return torch.zeros(s, dtype=torch.int64, device=dev)

    def h(k):
        return torch.from_numpy(np.asarray(host[k]).astype(np.int64)).to(dev)

    sd = torch.as_tensor(np.asarray(seeds).astype(np.int64) & U32,
                         device=dev)
    qlen_o = (h("qlen_o") if "qlen_o" in host
              else h("qlen")[:, None].repeat(1, nd))
    seed_o = (h("seed_o") & U32 if "seed_o" in host
              else sd[:, None].repeat(1, nd))
    st = dict(
        mode=torch.full((B,), M_MAIN, dtype=torch.int64, device=dev),
        overflow=torch.zeros(B, dtype=torch.bool, device=dev),
        result=z(B),
        # per-lane config-group bases of a fused multi-DAG run (zero for
        # a single DAG; see _cfgF/_cfgO)
        cfg0f=h("cfg0f") if "cfg0f" in host else z(B),
        cfg0o=h("cfg0o") if "cfg0o" in host else z(B),
        rng_al=sd.clone(), rng_ca=h("rng_ca") & U32,
        rng_rs=(h("rng_rs") & U32 if "rng_rs" in host
                else sd[:, None].repeat(1, ndt)), seed=sd.clone(),
        count=z(B), best_stratum=torch.full((B,), 999, dtype=torch.int64,
                                            device=dev),
        nhits=z(B), hits=z(B, H_MAX * HIT_W),
        qlen=h("qlen"), qlen_o=qlen_o, seed_o=seed_o, rows_qp=h("rows_qp"),
        dqlen=h("dqlen"), dd5=h("dd5"), dd3=h("dd3"),
        qp_cur=z(B, 2 * L), d5_cur=z(B), d3_cur=z(B), qlen_cur=z(B),
        bt=torch.full((B,), maxbts, dtype=torch.int64, device=dev),
        ca_done=z(B), ca_found=z(B), ca_min=h("ca_min"), act=h("act"),
        act_n=h("act_n"), cur=z(B), cur_o=z(B), precost=z(B), phase=z(B),
        octx=z(B), sfx_mc=z(B), adv_found=z(B), loop_cost=z(B),
        sdf_old=z(B), ic_pre=z(B), pre_min=z(B),
        ls_drv=z(B), ls_top=z(B), ls_bot=z(B), ls_cost=z(B),
        ls_strat=z(B), ls_ne=z(B), ls_ed=z(B, E_MAX), ls_ec=z(B, E_MAX),
        dl_valid=z(B), dl_drv=z(B), dl_top=z(B), dl_bot=z(B),
        dl_cost=z(B), dl_strat=z(B), dl_ne=z(B),
        dl_ed=z(B, E_MAX), dl_ec=z(B, E_MAX),
        ch_r=z(B), ch_k=z(B), r_row=z(B), r_jumps=z(B), r_walk=z(B),
        drv_done=h("drv_done"), drv_found=h("drv_found"),
        drv_min=h("drv_min"), drv_adj=h("drv_adj"), pm_min=z(B, ndt),
        drv_nextid=h("drv_nextid"),
        rr=h("rr").permute(0, 2, 1).reshape(B, -1).contiguous(),
        rr_ed=z(B, ndt * E_MAX), rr_ec=z(B, ndt * E_MAX),
        pm_m=z(B, ndt * 3), pm_c=z(B, ndt * 3), pm_n=z(B, ndt),
        ex_next=z(B, nd),
        od_done=h("od_done"), od_found=h("od_found"), od_min=h("od_min"),
        od_rr=z(B, nd * 5), od_ed=z(B, nd * E_MAX), od_ec=z(B, nd * E_MAX),
        ic_act=z(B, nd * PEX), ic_actn=z(B, nd), ic_found=z(B, nd),
        ic_done=z(B, nd), ic_min=z(B, nd),
        ic_rng=seed_o.clone(),
        il_top=z(B, nd), il_bot=z(B, nd), il_cost=z(B, nd),
        il_strat=z(B, nd), il_ne=z(B, nd),
        il_ed=z(B, nd * E_MAX), il_ec=z(B, nd * E_MAX),
        ptb_pool=z(B, NBR, 2 * L),
        meta=torch.full((B, NBR, L), META_ALL_DEAD, dtype=torch.int64,
                        device=dev),
        p_ed=z(B, NBR * E_MAX), p_ec=z(B, NBR * E_MAX),
    )
    for k in P_KEYS:
        st[k] = h(k)
    return st


# per-driver block widths of the flat element-major state
_BLK = {"rr": 5, "rr_ed": E_MAX, "rr_ec": E_MAX, "pm_m": 3, "pm_c": 3,
        "od_rr": 5, "od_ed": E_MAX, "od_ec": E_MAX, "il_ed": E_MAX,
        "il_ec": E_MAX, "ic_act": PEX}


_IOTA: dict = {}


def _iota(K, device):
    """torch.arange(K) on `device`, [1, K], built once."""
    key = (K, device)
    if key not in _IOTA:
        _IOTA[key] = torch.arange(K, device=device)[None, :]
    return _IOTA[key]


def _oh(idx, K):
    """[B, K] one-hot of per-lane column idx (all False out of range)."""
    return _iota(K, idx.device) == idx[:, None]


def _sel(a, idx):
    """a[b, idx[b]] for [B, K] a (0 where idx is out of range)."""
    return torch.where(_oh(idx, a.shape[1]), a, 0).sum(1)


def _w(st, name, mask, val):
    st[name] = torch.where(mask, val, st[name])


def _dw(st, name, mask, idx, val):
    """Masked write of column idx of [B, K] state `name`."""
    a = st[name]
    m = _oh(idx, a.shape[1]) & mask[:, None]
    st[name] = torch.where(m, val[:, None] if torch.is_tensor(val) else val,
                           a)


def _blk(a, slot, width):
    """Block `slot` -> [B, width] of flat element-major [B, width*K]."""
    B = a.shape[0]
    a3 = a.view(B, width, -1)
    return torch.where(_oh(slot, a3.shape[2])[:, None, :], a3, 0).sum(2)


def _blk_write(a, mask, slot, val, width):
    """Write block `slot` of flat element-major [B, width*K] where mask."""
    B = a.shape[0]
    a3 = a.view(B, width, -1)
    m = (_oh(slot, a3.shape[2]) & mask[:, None])[:, None, :]
    return torch.where(m, val[:, :, None], a3).reshape(B, -1)


def _dsel2(st, name, drv):
    return _blk(st[name], drv, _BLK[name])


def _dw2(st, name, mask, drv, val):
    st[name] = _blk_write(st[name], mask, drv, val, _BLK[name])


def _slot3(fs, B):
    """[B, NBR, 1] one-hot of each lane's pool slot fs."""
    return _oh(fs, NBR)[:, :, None]


def _irrelevant(st, cost, strata: bool):
    """NBestFirstStrat::irrelevantCost (hit.h:1124-1131)."""
    if not strata:
        return torch.zeros_like(cost, dtype=torch.bool)
    return (st["count"] > 0) & ((cost >> 14) > st["best_stratum"])


def _cfgF(st, cx, name, idx):
    """Flat-driver config `name` of each lane's driver idx, read through
    the lane's config-group base cfg0f (:854): a fused run holds the
    tables of several driver DAGs one after another."""
    return cx.cfg[name][idx + st["cfg0f"]]


def _cfgO(st, cx, name, idx):
    """Outer-driver config `name` through the lane's base cfg0o (:863)."""
    return cx.cfg[name][idx + st["cfg0o"]]


class _Ctx:
    """The static configuration of one plain run."""

    def __init__(self, pair, cfg, *, nd, ndt, L, nfrag, n_k, m_max, strata,
                 qual_lim, qual_order, bt_on, fc, has_seeded, record=False,
                 rec_cap=None, paired=False):
        self.pair, self.cfg = pair, cfg
        self.record, self.rec_cap, self.paired = record, rec_cap, paired
        self.nd, self.ndt, self.L, self.nfrag = nd, ndt, L, nfrag
        self.n_k, self.m_max, self.strata = n_k, m_max, strata
        self.qual_lim, self.qual_order, self.bt_on = (qual_lim, qual_order,
                                                      bt_on)
        self.fc, self.has_seeded = fc, has_seeded
        self.fchr = pair.fw.fchr
        self.work = None
        self.touched = {k: [] for k in TOUCHED}

    def by_index(self, efw, fn):
        """fn(fm) on both indexes, each lane taking its own (efw > 0:
        forward, else mirror)."""
        a, b = fn(self.pair.fw), fn(self.pair.bw)
        return torch.where((efw > 0).view(-1, *([1] * (a.dim() - 1))), a, b)

    def touch(self, kind, items, efw, mask):
        """Record the items of array `kind` that the lanes in `mask` read
        from their own index, when counting work."""
        if self.work is not None:
            self.touched[kind].append((items * 2 + (efw > 0).long())[mask])

    def lf4pair(self, efw, top, bot, need):
        """The quartets of both ends of each lane's range on its own
        index; `need` marks the lanes whose result is used (counted as
        work)."""
        if self.work is not None:
            w = self.work
            n = int(need.sum())
            w["rank_ends"] += 2 * n
            w["rank_codes"] += 8 * n
            w["word_codes"] += 4 * int((words_needed(top)
                                        + words_needed(bot))[need].sum())
            for row in (top, bot):
                self.touch("occ_entries", row // OCC_BLOCK, efw, need)
                self.touch("bwt_blocks", row // OCC_BLOCK, efw,
                           need & (words_needed(row) > 0))
        t, b = self.by_index(efw, lambda fm: torch.stack(
            lf4pair_plain(fm, top, bot), 1)).unbind(1)
        return t, b


def _front_select(st, cur):
    """PathManager front: argmin by CostCompare key (cost asc,
    extendable first, deeper tip, smaller id; range_source.h:1103)."""
    elig = (st["p_valid"] > 0) & (st["p_drv"] == cur[:, None])
    tip = st["p_rdepth"] + st["p_len"]
    key1 = (((st["p_cost"] * 2 + st["p_curt"]) << 8)
            | (255 - torch.clamp(tip, max=255)))
    key1 = torch.where(elig, key1, INF32)
    k1min = key1.min(1).values
    idk = torch.where(elig & (key1 == k1min[:, None]), st["p_id"], INF32)
    return idk.argmin(1), elig.any(1)


def _derive_qd(st, flat, L):
    """By-depth code/penalty rows of flat driver `flat`: the static rows
    of rows_qp with the driver's seed-stage premuts applied."""
    B = flat.shape[0]
    ndt = st["pm_n"].shape[1]
    qp = torch.where(_oh(flat, ndt)[:, :, None], st["rows_qp"], 0).sum(1)
    qd, pend = qp[:, :L], qp[:, L:]
    di = _iota(L, flat.device)
    npm = _sel(st["pm_n"], flat)
    pmm = _dsel2(st, "pm_m", flat)
    pmc = _dsel2(st, "pm_c", flat)
    for k in range(3):
        hit = (di == pmm[:, k:k + 1]) & (npm[:, None] > k)
        qd = torch.where(hit, pmc[:, k:k + 1], qd)
    return qd, pend


def _load_cur_rows(st, mask, flat, L):
    qd, pend = _derive_qd(st, flat, L)
    qp = torch.cat([qd, pend], 1)
    st["qp_cur"] = torch.where(mask[:, None], qp, st["qp_cur"])
    _w(st, "d5_cur", mask, _sel(st["dd5"], flat))
    _w(st, "d3_cur", mask, _sel(st["dd3"], flat))
    _w(st, "qlen_cur", mask, _sel(st["dqlen"], flat))


def _copy_outer_range(st, mask, prefix, cur_o):
    rrv = _dsel2(st, "od_rr", cur_o)
    _w(st, prefix + "drv", mask, cur_o)
    for k, f in enumerate(("top", "bot", "cost", "strat", "ne")):
        _w(st, prefix + f, mask, rrv[:, k])
    ed = _dsel2(st, "od_ed", cur_o)
    ec = _dsel2(st, "od_ec", cur_o)
    st[prefix + "ed"] = torch.where(mask[:, None], ed, st[prefix + "ed"])
    st[prefix + "ec"] = torch.where(mask[:, None], ec, st[prefix + "ec"])


def _sort_generic(m, act, act_n, done2, found2, min2, rng, K):
    """sortActives (range_source.h:2367+) over an id list `act` whose
    entries index the per-id arrays: selection sort with an RNG draw per
    tie.  -> (act, act_n, rng).  An outer round in which no lane runs
    changes nothing, and none runs after it, so the loop stops there."""
    cols = _iota(K, act.device)
    i = torch.zeros_like(act_n)
    for _t in range(2 * K):
        run = m & (i < act_n)
        if not bool(run.any()):
            break
        cur = _sel(act, i.clamp(0, K - 1))
        rm = run & (_sel(done2, cur) > 0) & (_sel(found2, cur) == 0)
        shift = rm[:, None] & (cols >= i[:, None])
        act_s1 = torch.cat([act[:, 1:], act[:, -1:]], 1)
        act = torch.where(shift, act_s1, act)
        act_n = torch.where(rm, act_n - 1, act_n)
        sel = run & ~rm
        min_cost = _sel(min2, cur)
        min_off = i
        for joff in range(1, K):
            j = i + joff
            vj = sel & (j < act_n)
            cj = _sel(act, j.clamp(0, K - 1))
            skip = (_sel(done2, cj) > 0) & (_sel(found2, cj) == 0)
            cost_j = _sel(min2, cj)
            okj = vj & ~skip
            less = okj & (cost_j < min_cost)
            tiej = okj & (cost_j == min_cost)
            rng2, draw = _rng_next(rng)
            rng = torch.where(tiej, rng2, rng)
            take = less | (tiej & ((draw & 0x1000) > 0))
            min_cost = torch.where(less, cost_j, min_cost)
            min_off = torch.where(take, j, min_off)
        do = sel & (min_off != i)
        vi = _sel(act, i.clamp(0, K - 1))
        vm = _sel(act, min_off.clamp(0, K - 1))
        act = torch.where(do[:, None] & (cols == i[:, None]), vm[:, None],
                          act)
        act = torch.where(do[:, None] & (cols == min_off[:, None]),
                          vi[:, None], act)
        i = torch.where(sel, i + 1, i)
    return act, act_n, rng


# -- aligner-level + outer CostAware steps -----------------------------------

def _step_main(st, cx):
    """UnpairedAlignerV2 loop head (:1030); in record mode a found range
    goes to _record_range instead of the chase."""
    m = st["mode"] == M_MAIN
    found = st["ca_found"] > 0
    if cx.record:
        _record_range(st, cx, m, found)
        return
    irrf = m & found & _irrelevant(st, st["ls_cost"], cx.strata)
    _w(st, "ca_found", irrf, 0)
    chase = m & found & ~irrf
    spread = torch.clamp(st["ls_bot"] - st["ls_top"], min=1)
    rng, v = _rng_next(st["rng_al"])
    _w(st, "rng_al", chase, rng)
    r0 = st["ls_top"] + v % spread
    _w(st, "ch_r", chase, r0)
    _w(st, "ch_k", chase, 0)
    _w(st, "r_walk", chase, 0)
    _w(st, "mode", chase, M_CHASE)
    nf = m & ~found
    ex = nf & ((st["ca_done"] > 0) | _irrelevant(st, st["ca_min"],
                                                 cx.strata))
    _w(st, "mode", ex, M_DONE)
    _w(st, "mode", nf & ~ex, M_CADV)


def _record_range(st, cx, m, found):
    """Record mode (:1064): append the found range to the hit pool as
    [drv, top, bot, cost, stratum, nedits, done, qlen, edit depths (the
    pad slot before last holds pre_min, the driver's min cost at the last
    check before this emission), edit chars], keep advancing the driver.
    The done column is the driver's done-at-emission flag, or 2 once the
    lane is frozen by rec_cap with its driver not exhausted: the replay
    then treats the stream as truncated.  The range is never chased."""
    B = m.shape[0]
    rec_on = m & found
    nmms = st["ls_ne"]
    done_col = st["ca_done"]
    if cx.rec_cap is not None:
        frz = (st["nhits"] + 1 >= cx.rec_cap) & (st["ca_done"] == 0)
        done_col = torch.where(frz, 2, done_col)
    zpad = torch.zeros((B, MM_SLOTS - E_MAX), dtype=torch.int64,
                       device=m.device)
    ed_p = torch.cat([st["ls_ed"], zpad], 1)
    ed_p = torch.cat([ed_p[:, :MM_SLOTS - 1], st["pre_min"][:, None]], 1)
    rec = torch.cat([torch.stack(
        [st["ls_drv"], st["ls_top"], st["ls_bot"], st["ls_cost"],
         st["ls_strat"], nmms, done_col, _sel(st["qlen_o"], st["ls_drv"])],
        -1),
        ed_p, torch.cat([st["ls_ec"], zpad], 1)], -1)
    over = rec_on & ((st["nhits"] >= H_MAX) | (nmms > MM_SLOTS))
    st["overflow"] = st["overflow"] | over
    _w(st, "mode", over, M_DONE)
    do_store = rec_on & ~over
    hm = _oh(st["nhits"], H_MAX) & do_store[:, None]
    st["hits"] = torch.where(hm.repeat_interleave(HIT_W, 1),
                             rec.repeat(1, H_MAX), st["hits"])
    _w(st, "nhits", do_store, st["nhits"] + 1)
    if cx.rec_cap is not None:
        _w(st, "mode", do_store & (st["nhits"] >= cx.rec_cap), M_DONE)
    _w(st, "ca_found", rec_on, 0)
    nf = m & ~found
    _w(st, "pre_min", nf, st["ca_min"])
    ex = nf & (st["ca_done"] > 0)
    _w(st, "mode", ex, M_DONE)
    _w(st, "mode", nf & ~ex, M_CADV)


def _step_cadv(st, cx):
    """Outer CostAwareRangeSourceDriver::advance entry (:1127)."""
    m = st["mode"] == M_CADV
    dv = m & (st["dl_valid"] > 0)
    for a, b in (("ls_drv", "dl_drv"), ("ls_top", "dl_top"),
                 ("ls_bot", "dl_bot"), ("ls_cost", "dl_cost"),
                 ("ls_strat", "dl_strat"), ("ls_ne", "dl_ne")):
        _w(st, a, dv, st[b])
    st["ls_ed"] = torch.where(dv[:, None], st["dl_ed"], st["ls_ed"])
    st["ls_ec"] = torch.where(dv[:, None], st["dl_ec"], st["ls_ec"])
    _w(st, "dl_valid", dv, 0)
    _w(st, "ca_found", dv, 1)
    if cx.paired:
        # mate elimination (:1141-1159): with no delayed range pending,
        # the merged driver is done once either mate has no not-done
        # outer left (pops remove only done-and-not-found entries, so
        # every not-done outer is still active)
        ii = _iota(cx.nd, m.device)
        o_m1 = cx.cfg["o_m1"][st["cfg0o"][:, None] + ii] > 0
        alive = st["od_done"] == 0
        elim = m & ~dv & ~((alive & o_m1).any(1) & (alive & ~o_m1).any(1))
        _w(st, "ca_done", elim, 1)
        _w(st, "mode", elim, M_MAIN)
        m = m & ~elim
    has_act = st["act_n"] > 0
    act0 = st["act"][:, 0]
    _w(st, "ca_min", dv & has_act,
       torch.maximum(_sel(st["od_min"], act0), st["ca_min"]))
    _w(st, "ca_done", dv & ~has_act, 1)
    _w(st, "mode", dv, M_MAIN)
    m = m & ~dv
    emp = m & ~has_act
    _w(st, "ca_done", emp, 1)
    _w(st, "mode", emp, M_MAIN)
    go = m & ~emp
    _w(st, "cur_o", go, act0)
    _w(st, "octx", go, 0)
    _w(st, "precost", go, _sel(st["od_min"], act0))
    pre = go & (_sel(st["od_found"], act0) > 0)
    _w(st, "mode", pre, M_CPOST)
    _w(st, "mode", go & ~pre, M_OADV)


def _step_oadv(st, cx):
    """Dispatch one outer-driver advance (:1180)."""
    m = st["mode"] == M_OADV
    cur_o = st["cur_o"]
    kind = _cfgO(st, cx, "o_kind", cur_o)
    pl = m & (kind == 0) if cx.has_seeded else m
    f0 = _cfgO(st, cx, "o_flat0", cur_o)
    _w(st, "cur", pl, f0)
    _w(st, "phase", pl, PH_OUTER)
    _load_cur_rows(st, pl, st["cur"], cx.L)
    _w(st, "mode", pl, M_DADV)
    if cx.has_seeded:
        _w(st, "mode", m & (kind == 1), M_SD)


def _step_sfx(st, cx):
    """strandFix inner-loop head (:1203)."""
    m = st["mode"] == M_SFX
    cur_o = st["cur_o"]
    stop = m & ((_sel(st["od_done"], cur_o) > 0)
                | (_sel(st["od_found"], cur_o) > 0))
    _w(st, "mode", stop, M_SFXEND)
    _w(st, "mode", m & ~stop, M_OADV)


def _step_dadv(st, cx):
    """BestDriver.advance entry (:1214)."""
    m = st["mode"] == M_DADV
    cur = st["cur"]
    has = ((st["p_valid"] > 0) & (st["p_drv"] == cur[:, None])).any(1)
    dd = m & ((_sel(st["drv_done"], cur) > 0) | ~has)
    _dw(st, "drv_done", dd, cur, 1)
    _w(st, "adv_found", m, 0)
    _w(st, "mode", dd, M_DEND)
    _w(st, "mode", m & ~dd, M_EXT)


def _meta_costs(st, meta_row, frd, flen, fd0, d3, qual_order):
    """Per-position curtail/split costs over a branch's meta row
    (:1228)."""
    B, L = meta_row.shape
    ii = _iota(L, meta_row.device)
    i0 = torch.clamp(fd0 - frd, min=0)
    elig = ((ii >= i0[:, None]) & (ii <= flen[:, None])
            & (ii < (st["qlen_cur"] - frd)[:, None])
            & ((meta_row & META_ELIM) == 0))
    quallo = (meta_row >> 5) & 0x7F
    strat = torch.where((frd[:, None] + ii) < d3[:, None], 1 << 14, 0)
    cost = (quallo if qual_order else torch.zeros_like(quallo)) | strat
    return elig, torch.where(elig, cost, COST_INF)


def _merged_edits(st, cur, ed_row, ec_row, fne):
    """Branch edits followed by the driver's seed-stage premuts
    (:1243)."""
    B = cur.shape[0]
    npm = _sel(st["pm_n"], cur)
    pmm = _dsel2(st, "pm_m", cur)
    pmc = _dsel2(st, "pm_c", cur)
    sl = _iota(E_MAX, cur.device)
    from_br = sl < fne[:, None]
    pidx = torch.clamp(sl - fne[:, None], 0, 2)
    ed = torch.where(from_br, ed_row, pmm.gather(1, pidx))
    ec = torch.where(from_br, ec_row, pmc.gather(1, pidx))
    return ed, ec, fne + npm


def _meta_row(st, fs):
    return torch.where(_slot3(fs, fs.shape[0]), st["meta"], 0).sum(1)


def _step_ext(st, cx):
    """advanceBranch part 1: consume one position of the front branch
    (:1263)."""
    m = st["mode"] == M_EXT
    B, L = m.shape[0], cx.L
    cur = st["cur"]
    efw = _cfgF(st, cx, "ebwt_fw", cur)
    hh = _cfgF(st, cx, "hh", cur)
    exacts = _cfgF(st, cx, "exacts", cur)
    d5, d3 = st["d5_cur"], st["d3_cur"]
    fs, _ = _front_select(st, cur)
    fcost, fham, frd, flen, ftop, fbot, fne, fd0 = (
        _sel(st[k], fs) for k in ("p_cost", "p_ham", "p_rdepth", "p_len",
                                  "p_top", "p_bot", "p_ne", "p_d0"))
    _w(st, "loop_cost", m, fcost)
    depth = frd + flen
    qlen = st["qlen_cur"]
    hhfail = m & (hh > 0) & (((depth == d5) & (fne == 0))
                             | ((depth == d3) & (fne < hh)))
    consume = m & ~hhfail & (depth < qlen)
    dsel = _oh(depth.clamp(0, L - 1), L)
    c = torch.where(dsel, st["qp_cur"][:, :L], 0).sum(1)
    q = torch.where(dsel, st["qp_cur"][:, L:], 0).sum(1)
    alt = (depth >= fd0) & (fham + q <= cx.qual_lim)
    pt, pb = ftop, fbot
    n4 = consume & (c == 4) & (depth > 0)
    tb_top = torch.where(n4, 1, ftop)
    tb_bot = torch.where(n4, 1, fbot)
    caseA = consume & (tb_top == 0) & (tb_bot == 0)
    caseB = consume & ~caseA & alt & ((pb > pt) | (c == 4))
    caseC = consume & ~caseA & ~caseB & (pb > pt)
    need_q = caseA | caseB | caseC
    tops, bots = cx.lf4pair(efw, torch.where(need_q, pt, 0),
                            torch.where(need_q, pb, 0), caseB | caseC)
    tops = torch.where(caseA[:, None], cx.fchr[None, :4], tops)
    bots = torch.where(caseA[:, None], cx.fchr[None, 1:5], bots)

    install = caseA | caseB
    dead = q > (cx.qual_lim - fham)
    jj = _iota(4, m.device)
    enabled = ((jj != c[:, None]) & (bots > tops) & ~dead[:, None]
               & install[:, None])
    elim_bits = (torch.where(enabled, 0, 1) << jj).sum(1)
    eliminated = ~enabled.any(1)
    meta_new = (elim_bits | torch.where(eliminated, META_ELIM, 0)
                | (torch.clamp(q, 0, 127) << 5)
                | torch.where(caseA, META_FCHR, 0))
    meta_new = torch.where(install, meta_new, META_ALL_DEAD)

    c3 = torch.clamp(c, 0, 3)
    qc = tops.gather(1, c3[:, None])[:, 0]
    qb = bots.gather(1, c3[:, None])[:, 0]
    abc = (caseA | caseB | caseC) & (c < 4)
    new_top = torch.where(abc, qc, tb_top)
    new_bot = torch.where(abc, qb, tb_bot)
    new_top = torch.where(caseA & (c == 4), 0, new_top)
    new_bot = torch.where(caseA & (c == 4), 0, new_bot)
    _dw(st, "p_top", consume, fs, new_top)
    _dw(st, "p_bot", consume, fs, new_bot)
    eff_top = torch.where(consume, new_top, ftop)
    eff_bot = torch.where(consume, new_bot, fbot)

    cur0 = depth >= (qlen - 1)
    empty = eff_top == eff_bot
    hit = m & ~hhfail & cur0 & ~empty
    invalid_exact = hit & (fne == 0) & (exacts == 0)
    ii = _iota(E_MAX, m.device)
    edm = ii < fne[:, None]
    ed_row = _blk(st["p_ed"], fs, E_MAX)
    hi_n = (edm & (ed_row < d5[:, None])).sum(1)
    lo_n = (edm & (ed_row >= d5[:, None]) & (ed_row < d3[:, None])).sum(1)
    hh2ok = torch.where(
        (depth == d5 - 1) & ~empty, fne > 0,
        torch.where((depth == d3 - 1) & ~empty,
                    (fne >= hh) & ~((lo_n == 0) | (hi_n == 0)),
                    torch.ones_like(m)))
    hh2fail = m & ~hhfail & (hh > 0) & ~hh2ok

    found = hit & ~invalid_exact & ~hh2fail
    extend = m & ~hhfail & ~hh2fail & ~hit & ~empty & ~cur0
    curt = m & ~extend

    _w(st, "adv_found", found, 1)
    ec_row = _blk(st["p_ec"], fs, E_MAX)
    med, mec, mne = _merged_edits(st, cur, ed_row, ec_row, fne)
    rrv = torch.stack([eff_top, eff_bot, fcost, fcost >> 14, mne], -1)
    _dw2(st, "rr", found, cur, rrv)
    _dw2(st, "rr_ed", found, cur, med)
    _dw2(st, "rr_ec", found, cur, mec)

    _dw(st, "p_len", extend, fs, flen + 1)
    slot3 = _slot3(fs, B)
    iota2L = torch.arange(2 * L, device=m.device)[None, None, :]
    c3m = consume[:, None, None] & slot3
    st["ptb_pool"] = torch.where(
        c3m & (iota2L == flen[:, None, None]), pt[:, None, None],
        torch.where(c3m & (iota2L == (L + flen)[:, None, None]),
                    pb[:, None, None], st["ptb_pool"]))
    iotaL = torch.arange(L, device=m.device)[None, None, :]
    m1 = c3m & (iotaL == flen[:, None, None])
    m2 = (extend[:, None, None] & slot3
          & (iotaL == (flen + 1)[:, None, None]))
    st["meta"] = torch.where(m1, meta_new[:, None, None],
                             torch.where(m2, META_ALL_DEAD, st["meta"]))
    st["overflow"] = st["overflow"] | (extend & (flen + 1 >= L))

    meta_row = _meta_row(st, fs)
    _elig, costs = _meta_costs(st, meta_row, frd, flen, fd0, d3,
                               cx.qual_order)
    lowest = costs.min(1).values
    exhausted = curt & (lowest == COST_INF)
    _dw(st, "p_valid", exhausted, fs, 0)
    live_curt = curt & ~exhausted
    _dw(st, "p_cost", live_curt, fs, fcost + lowest)
    _dw(st, "p_curt", live_curt, fs, 1)
    _w(st, "mode", m, M_SPP)


def _step_spp(st, cx):
    """advanceBranch part 2: splitAndPrep, the --maxbts ceiling,
    splitBranch/pick_edit with their draws, the loop exit checks
    (:1409)."""
    m = st["mode"] == M_SPP
    B, L = m.shape[0], cx.L
    cur = st["cur"]
    efw = _cfgF(st, cx, "ebwt_fw", cur)
    d3 = st["d3_cur"]
    fs, nonempty = _front_select(st, cur)
    pm_empty = m & ~nonempty
    live = m & nonempty
    (fcost, fdlyf, fdly, fcurt, frd, flen, fne, fham, fd0, fd1, fd2,
     fd3) = (_sel(st[k], fs) for k in (
         "p_cost", "p_dlyf", "p_dly", "p_curt", "p_rdepth", "p_len", "p_ne",
         "p_ham", "p_d0", "p_d1", "p_d2", "p_d3"))
    btfail0 = (live & (st["bt"] == 0)) if cx.bt_on else \
        torch.zeros_like(m)
    clear0 = btfail0
    live = live & ~btfail0
    dfix = live & (fdlyf > 0)
    _dw(st, "p_cost", dfix, fs, fdly)
    _dw(st, "p_dlyf", dfix, fs, 0)
    rest = live & ~dfix
    dosplit = rest & (fcurt > 0)
    if cx.bt_on:
        _w(st, "bt", dosplit, torch.clamp(st["bt"] - 1, min=0))
        btfail1 = dosplit & (st["bt"] == 0)
        clear0 = clear0 | btfail1
        dosplit = dosplit & ~btfail1
        rest = rest & ~btfail1
        cm = clear0[:, None] & (st["p_drv"] == cur[:, None])
        st["p_valid"] = torch.where(cm, 0, st["p_valid"])
        _dw(st, "pm_min", clear0, cur, 0)
        _w(st, "mode", clear0, M_DEND)

    meta_row = _meta_row(st, fs)
    elig, costs = _meta_costs(st, meta_row, frd, flen, fd0, d3,
                              cx.qual_order)
    best = costs.min(1).values
    tie = elig & (costs == best[:, None])
    n_t = tie.sum(1)
    gt = torch.where(elig & (costs > best[:, None]), costs, COST_INF)
    nxt = gt.min(1).values
    n_el = elig.sum(1)
    w = torch.clamp(n_t, max=3)
    ndraw = dosplit & (w > 1)
    rng_d = _sel(st["rng_rs"], cur)
    rng2, v = _rng_next(rng_d)
    r = torch.where(ndraw, v % torch.clamp(w, min=1), 0)
    _dw(st, "rng_rs", ndraw, cur, rng2)
    rank = n_t - w + r
    tcs = torch.cumsum(tie.long(), 1)
    posm = tie & (tcs == (rank + 1)[:, None])
    pos = posm.long().argmax(1)
    depth_split = frd + pos

    ptb = torch.where(_slot3(fs, B), st["ptb_pool"], 0).sum(1)
    spt = _sel(ptb[:, :L], pos)
    spb = _sel(ptb[:, L:], pos)
    meta_pos = _sel(meta_row, pos)
    is_fchr = (meta_pos & META_FCHR) > 0
    tops, bots = cx.lf4pair(efw, torch.where(dosplit, spt, 0),
                            torch.where(dosplit, spb, 0), dosplit & ~is_fchr)
    tops = torch.where(is_fchr[:, None], cx.fchr[None, :4], tops)
    bots = torch.where(is_fchr[:, None], cx.fchr[None, 1:5], bots)

    jj = _iota(4, m.device)
    cands = ((meta_pos[:, None] >> jj) & 1) == 0
    num = cands.sum(1)
    spreads = torch.where(cands, bots - tops, 0)
    tot = spreads.sum(1)
    multi = dosplit & (num > 1)
    rng_d2 = _sel(st["rng_rs"], cur)
    rng3, v2 = _rng_next(rng_d2)
    dart = v2 % torch.clamp(tot, min=1)
    _dw(st, "rng_rs", multi, cur, rng3)
    cumsp = torch.cumsum(spreads, 1)
    chosen_multi = (cands & (dart[:, None] < cumsp)).long().argmax(1)
    chosen_single = cands.long().argmax(1)
    last = num == 1
    chosen = torch.where(last, chosen_single, chosen_multi)
    pm_new = torch.where(last, meta_pos | META_ELIM,
                         meta_pos | (1 << torch.clamp(chosen, 0, 3)))

    fkey = st["p_valid"] * NBR + _iota(NBR, m.device)
    cslot = fkey.argmin(1)
    pool_full = _sel(st["p_valid"], cslot) > 0
    edits_over = fne + 1 > E_MAX
    over = dosplit & (pool_full | edits_over)
    st["overflow"] = st["overflow"] | over
    _w(st, "mode", over, M_DONE)
    ok = dosplit & ~over

    hamadd = best & 0x3FFF
    nid = _sel(st["drv_nextid"], cur)
    _dw(st, "drv_nextid", ok, cur, nid + 1)
    nd0 = torch.where(depth_split < fd1, fd1, fd0)
    nd1 = torch.where(depth_split < fd2, fd2, fd1)
    nd2 = torch.where(depth_split < fd3, fd3, fd2)
    zero, one = torch.zeros_like(fs), torch.ones_like(fs)
    for name, val in (("p_valid", one), ("p_drv", cur), ("p_cost", fcost),
                      ("p_ham", fham + hamadd), ("p_rdepth", frd + pos + 1),
                      ("p_len", zero),
                      ("p_top", tops.gather(1, chosen[:, None])[:, 0]),
                      ("p_bot", bots.gather(1, chosen[:, None])[:, 0]),
                      ("p_curt", zero), ("p_dly", zero), ("p_dlyf", zero),
                      ("p_id", nid), ("p_ne", fne + 1), ("p_d0", nd0),
                      ("p_d1", nd1), ("p_d2", nd2), ("p_d3", fd3)):
        _dw(st, name, ok, cslot, val)
    ed_row = _blk(st["p_ed"], fs, E_MAX)
    ec_row = _blk(st["p_ec"], fs, E_MAX)
    sl = _iota(E_MAX, m.device)
    at_ne = sl == torch.clamp(fne, 0, E_MAX - 1)[:, None]
    ned_row = torch.where(at_ne, depth_split[:, None], ed_row)
    nec_row = torch.where(at_ne, chosen[:, None], ec_row)
    st["p_ed"] = _blk_write(st["p_ed"], ok, cslot, ned_row, E_MAX)
    st["p_ec"] = _blk_write(st["p_ec"], ok, cslot, nec_row, E_MAX)

    exh = ok & (n_el == 1) & last
    _dw(st, "p_valid", exh, fs, 0)
    dly = ok & ~exh & (n_t == 1) & last & (best != nxt) & (nxt != COST_INF)
    _dw(st, "p_dly", dly, fs, fcost - best + nxt)
    _dw(st, "p_dlyf", dly, fs, 1)

    iotaL = torch.arange(L, device=m.device)[None, None, :]
    ok3 = ok[:, None, None]
    mp = ok3 & _slot3(fs, B) & (iotaL == pos[:, None, None])
    mc = ok3 & _slot3(cslot, B) & (iotaL == 0)
    st["meta"] = torch.where(mp, pm_new[:, None, None],
                             torch.where(mc, META_ALL_DEAD, st["meta"]))

    chk = (rest & ~over) | pm_empty
    elig2 = (st["p_valid"] > 0) & (st["p_drv"] == cur[:, None])
    any2 = elig2.any(1)
    fca = torch.where(elig2, st["p_cost"], INF32).min(1).values
    _dw(st, "pm_min", m & any2, cur, fca)
    exit_ = chk & (~any2 | (fca != st["loop_cost"]) | (st["adv_found"] > 0))
    _w(st, "mode", exit_, M_DEND)
    _w(st, "mode", chk & ~exit_, M_EXT)


def _step_dend(st, cx):
    """BestDriver.advance tail (:1602)."""
    m = st["mode"] == M_DEND
    cur = st["cur"]
    has = ((st["p_valid"] > 0) & (st["p_drv"] == cur[:, None])).any(1)
    _dw(st, "drv_done", m, cur, (~has).long())
    pmc = _sel(st["pm_min"], cur)
    adj = _sel(st["drv_adj"], cur)
    _dw(st, "drv_min", m & (pmc != 0), cur, torch.maximum(pmc, adj))
    _dw(st, "drv_found", m, cur, st["adv_found"])
    _w(st, "mode", m & (st["phase"] == PH_OUTER), M_ODEND)
    _w(st, "mode", m & (st["phase"] == PH_GEN), M_SDGEN)
    _w(st, "mode", m & (st["phase"] == PH_FULL), M_ICPOST)


def _step_odend(st, cx):
    """One outer-driver advance finished (:1624)."""
    m = st["mode"] == M_ODEND
    cur_o = st["cur_o"]
    kind = _cfgO(st, cx, "o_kind", cur_o)
    f0 = _cfgO(st, cx, "o_flat0", cur_o)
    pl = m & (kind == 0)
    _dw(st, "od_done", pl, cur_o, _sel(st["drv_done"], f0))
    _dw(st, "od_min", pl, cur_o, _sel(st["drv_min"], f0))
    pf = pl & (_sel(st["drv_found"], f0) > 0)
    _dw(st, "od_found", pf, cur_o, 1)
    _dw(st, "drv_found", pf, f0, 0)
    _dw2(st, "od_rr", pf, cur_o, _dsel2(st, "rr", f0))
    _dw2(st, "od_ed", pf, cur_o, _dsel2(st, "rr_ed", f0))
    _dw2(st, "od_ec", pf, cur_o, _dsel2(st, "rr_ec", f0))
    main = m & (st["octx"] == 0)
    _w(st, "mode", main, M_CPOST)
    sf = m & (st["octx"] == 1)
    exceed = sf & (_sel(st["od_min"], cur_o) > st["sfx_mc"])
    _w(st, "mode", exceed, M_SFXEND)
    _w(st, "mode", sf & ~exceed, M_SFX)


def _step_cpost(st, cx):
    """Outer CostAware.advance after p.advance() (:1652)."""
    m = st["mode"] == M_CPOST
    nd = cx.nd
    cur_o = st["cur_o"]
    pf = m & (_sel(st["od_found"], cur_o) > 0)
    needs0 = ((_sel(st["od_done"], cur_o) > 0)
              | (st["precost"] != _sel(st["od_min"], cur_o)))
    _copy_outer_range(st, pf, "ls_", cur_o)
    _w(st, "ca_found", pf, 1)
    _dw(st, "od_found", pf, cur_o, 0)
    r_fw = _cfgO(st, cx, "o_fw", cur_o)
    r_m1 = _cfgO(st, cx, "o_m1", cur_o)
    ii = _iota(nd, m.device)
    cfg_fw_row = cx.cfg["o_fw"][st["cfg0o"][:, None] + ii]
    cfg_m1_row = cx.cfg["o_m1"][st["cfg0o"][:, None] + ii]
    # the first i >= 1 of the static outer order on the other strand of
    # the same mate (:1666-1673; every outer is mate 1's but in V2)
    cand = ((ii >= 1) & (cfg_fw_row != r_fw[:, None])
            & (cfg_m1_row == r_m1[:, None])
            & (ii < st["act_n"][:, None]))
    has_i = cand.any(1)
    i_star = cand.long().argmax(1)
    sf = pf & has_i
    tgt = _sel(st["act"], i_star)
    mc = torch.maximum(st["ca_min"], _sel(st["od_min"], tgt))
    brk = sf & (mc > st["ls_cost"])
    go = sf & ~brk
    _w(st, "cur_o", go, tgt)
    _w(st, "octx", go, 1)
    _w(st, "sfx_mc", go, mc)
    _w(st, "mode", go, M_SFX)
    fin = m & ~go
    dosort = fin & (needs0 | go)
    _w(st, "mode", dosort, M_SORT)
    _w(st, "mode", fin & ~dosort, M_MAIN)


def _step_sfxend(st, cx):
    """strandFix loop tail (:1695)."""
    m = st["mode"] == M_SFXEND
    cur_o = st["cur_o"]
    pf = m & (_sel(st["od_found"], cur_o) > 0)
    _copy_outer_range(st, pf, "dl_", cur_o)
    _w(st, "dl_valid", pf, 1)
    _dw(st, "od_found", pf, cur_o, 0)
    tot = (st["dl_bot"] - st["dl_top"]) + (st["ls_bot"] - st["ls_top"])
    rng2, v = _rng_next(st["rng_ca"])
    _w(st, "rng_ca", pf, rng2)
    rq = v % torch.clamp(tot, min=1)
    swap = pf & (rq < (st["dl_bot"] - st["dl_top"]))
    for a, b in (("ls_drv", "dl_drv"), ("ls_top", "dl_top"),
                 ("ls_bot", "dl_bot"), ("ls_cost", "dl_cost"),
                 ("ls_strat", "dl_strat"), ("ls_ne", "dl_ne")):
        va, vb = st[a], st[b]
        st[a] = torch.where(swap, vb, va)
        st[b] = torch.where(swap, va, vb)
    for a, b in (("ls_ed", "dl_ed"), ("ls_ec", "dl_ec")):
        va, vb = st[a], st[b]
        st[a] = torch.where(swap[:, None], vb, va)
        st[b] = torch.where(swap[:, None], va, vb)
    _w(st, "octx", m, 0)
    _w(st, "mode", m, M_SORT)


def _step_sort(st, cx):
    """Outer sortActives + the post-sort active-empty check (:1725)."""
    m = st["mode"] == M_SORT
    act, act_n, rng = _sort_generic(
        m, st["act"], st["act_n"], st["od_done"], st["od_found"],
        st["od_min"], st["rng_ca"], cx.nd)
    st["act"] = torch.where(m[:, None], act, st["act"])
    _w(st, "act_n", m, act_n)
    _w(st, "rng_ca", m, rng)
    first = act[:, 0]
    _w(st, "ca_min", m & (act_n > 0) & (st["dl_valid"] == 0),
       torch.maximum(_sel(st["od_min"], first), st["ca_min"]))
    emp = m & (act_n == 0)
    _w(st, "ca_done", emp, (st["dl_valid"] == 0).long())
    _w(st, "mode", m, M_MAIN)


# -- seeded-driver scheduler (EbwtSeededRangeSourceDriver) -------------------

def _step_sd(st, cx):
    """SeededDriver.advance entry (:1750)."""
    m = st["mode"] == M_SD
    cur_o = st["cur_o"]
    gen = _cfgO(st, cx, "o_flat0", cur_o)
    gdone = _sel(st["drv_done"], gen) > 0
    gfound = _sel(st["drv_found"], gen) > 0
    fdone = _sel(st["ic_done"], cur_o) > 0
    ffound = _sel(st["ic_found"], cur_o) > 0
    alldone = m & gdone & fdone & ~gfound & ~ffound
    _dw(st, "od_done", alldone, cur_o, 1)
    _w(st, "mode", alldone, M_ODEND)
    rest = m & ~alldone
    sdead = rest & gdone & ~gfound
    _dw(st, "drv_min", sdead, gen, COST_INF)
    ret1 = sdead & (_sel(st["ic_min"], cur_o) > _sel(st["od_min"], cur_o))
    _dw(st, "od_min", ret1, cur_o, _sel(st["ic_min"], cur_o))
    _w(st, "mode", ret1, M_ODEND)
    rest = rest & ~ret1
    fdead = rest & fdone & ~ffound
    _dw(st, "ic_min", fdead, cur_o, COST_INF)
    ret2 = fdead & (_sel(st["drv_min"], gen) > _sel(st["od_min"], cur_o))
    _dw(st, "od_min", ret2, cur_o, _sel(st["drv_min"], gen))
    _w(st, "mode", ret2, M_ODEND)
    rest = rest & ~ret2
    do_full = _sel(st["ic_min"], cur_o) <= _sel(st["drv_min"], gen)
    genp = rest & ~do_full
    _w(st, "mode", genp & gfound, M_SDGEN)
    adv_g = genp & ~gfound
    _w(st, "cur", adv_g, gen)
    _w(st, "phase", adv_g, PH_GEN)
    _load_cur_rows(st, adv_g, st["cur"], cx.L)
    _w(st, "mode", adv_g, M_DADV)
    fullp = rest & do_full
    _w(st, "sdf_old", fullp, _sel(st["ic_min"], cur_o))
    pre_f = fullp & ffound
    _w(st, "mode", pre_f, M_SDFULL)
    _w(st, "mode", fullp & ~pre_f, M_ICADV)


def _step_sdgen(st, cx):
    """After a generator advance: create a full extender for a seed
    partial (its set_query on the card) and add it to the inner
    CostAware, then the generator min-cost propagation (:1802)."""
    m = st["mode"] == M_SDGEN
    B, L, fc = m.shape[0], cx.L, cx.fc
    dev = m.device
    cur_o = st["cur_o"]
    gen = _cfgO(st, cx, "o_flat0", cur_o)
    gfound = m & (_sel(st["drv_found"], gen) > 0)
    srr = _dsel2(st, "rr", gen)
    scost, sne = srr[:, 2], srr[:, 4]
    sed = _dsel2(st, "rr_ed", gen)
    sec = _dsel2(st, "rr_ec", gen)
    _dw(st, "drv_found", gfound, gen, 0)

    exb = _cfgO(st, cx, "o_exbase", cur_o)
    slot = _sel(st["ex_next"], cur_o)
    over = gfound & ((slot >= PEX) | (sne > 3))
    st["overflow"] = st["overflow"] | over
    _w(st, "mode", over, M_DONE)
    ok = gfound & ~over
    flat_e = exb + torch.clamp(slot, 0, PEX - 1)
    _dw(st, "ex_next", ok, cur_o, slot + 1)

    gdq = _sel(st["dqlen"], gen)
    k3 = _iota(3, dev)
    pm_m = torch.where(k3 < sne[:, None], gdq[:, None] - 1 - sed[:, :3], 0)
    pm_c = sec[:, :3]
    _dw2(st, "pm_m", ok, flat_e, pm_m)
    _dw2(st, "pm_c", ok, flat_e, pm_c)
    _dw(st, "pm_n", ok, flat_e, sne)
    qlen = _sel(st["qlen_o"], cur_o)
    s_seed = _sel(st["dd3"], gen)
    _dw(st, "dqlen", ok, flat_e, qlen)
    _dw(st, "dd3", ok, flat_e, s_seed)
    _dw(st, "dd5", ok, flat_e, s_seed >> 1)
    iham = (scost & 0x3FFF) if cx.qual_order else torch.zeros_like(scost)
    _dw(st, "drv_nextid", ok, flat_e, 0)
    _dw(st, "pm_min", ok, flat_e, 0)
    _dw(st, "rng_rs", ok, flat_e, _sel(st["seed_o"], cur_o))

    fl = torch.where(ok, flat_e, gen)
    qd_e, _pend = _derive_qd(st, fl, L)
    di = _iota(L, dev)
    dead = ((qd_e == 4) & (di < s_seed[:, None])).any(1)
    ns_ftab = ((qd_e[:, :fc] == 4) & (di[:, :fc] < qlen[:, None])).sum(1)
    use_ftab = (ns_ftab == 0) & (torch.minimum(s_seed, qlen) >= fc)
    wsh = (2 * torch.arange(fc, device=dev))[None, :]
    qf = torch.where(qd_e[:, :fc] > 3, 0, qd_e[:, :fc])
    foff = (qf << wsh).sum(1)
    efw_e = _cfgF(st, cx, "ebwt_fw", fl)
    ft = cx.by_index(efw_e, lambda fm: u32(fm.ftab_hi[torch.where(
        ok, foff, 0)]))
    fb = cx.by_index(efw_e, lambda fm: u32(fm.ftab_lo[torch.where(
        ok, foff + 1, 1)]))
    cx.touch("ftab_entries", foff, efw_e, ok)
    nonempty = fb > ft
    alive = ok & ~dead & (qlen >= 4)
    imm = alive & use_ftab & (qlen == fc) & nonempty
    rr_imm = torch.stack([ft, fb, scost, scost >> 14, sne], -1)
    _dw2(st, "rr", imm, flat_e, rr_imm)
    pad = torch.zeros((B, E_MAX - 3), dtype=torch.int64, device=dev)
    _dw2(st, "rr_ed", imm, flat_e, torch.cat([pm_m, pad], 1))
    _dw2(st, "rr_ec", imm, flat_e, torch.cat([pm_c, pad], 1))
    pushf = alive & use_ftab & (qlen > fc) & nonempty
    push0 = alive & ~use_ftab
    pushed = pushf | push0
    fkey = st["p_valid"] * NBR + _iota(NBR, dev)
    cslot = fkey.argmin(1)
    pool_full = _sel(st["p_valid"], cslot) > 0
    over2 = pushed & pool_full
    st["overflow"] = st["overflow"] | over2
    _w(st, "mode", over2, M_DONE)
    pushed = pushed & ~over2
    blen0 = torch.where(pushf, fc, 0)
    zero, one = torch.zeros_like(cslot), torch.ones_like(cslot)
    for name, val in (("p_valid", one), ("p_drv", flat_e), ("p_cost", scost),
                      ("p_ham", iham), ("p_rdepth", zero), ("p_len", blen0),
                      ("p_top", torch.where(pushf, ft, 0)),
                      ("p_bot", torch.where(pushf, fb, 0)),
                      ("p_curt", zero), ("p_dly", zero), ("p_dlyf", zero),
                      ("p_id", zero), ("p_ne", zero), ("p_d0", s_seed),
                      ("p_d1", s_seed), ("p_d2", s_seed), ("p_d3", s_seed)):
        _dw(st, name, pushed, cslot, val)
    _dw(st, "drv_nextid", pushed, flat_e, 1)
    iotaL = torch.arange(L, device=dev)[None, None, :]
    mcf = (pushed[:, None, None] & _slot3(cslot, B)
           & (iotaL == blen0[:, None, None]))
    st["meta"] = torch.where(mcf, META_ALL_DEAD, st["meta"])
    _dw(st, "drv_done", ok, flat_e, (~pushed & ~imm).long())
    _dw(st, "drv_found", ok, flat_e, imm.long())
    _dw(st, "drv_min", ok, flat_e, scost)

    # inner add_source
    _dw(st, "ic_found", ok, cur_o, 0)
    _dw(st, "ic_done", ok, cur_o, 0)
    actn = _sel(st["ic_actn"], cur_o)
    iact = _dsel2(st, "ic_act", cur_o)
    sl4 = _iota(PEX, dev)
    iact = torch.where((sl4 == actn[:, None]) & ok[:, None],
                       flat_e[:, None], iact)
    actn2 = torch.where(ok, actn + 1, actn)
    irng = _sel(st["ic_rng"], cur_o)
    iact3, actn3, irng3 = _sort_generic(
        ok, iact, actn2, st["drv_done"], st["drv_found"], st["drv_min"],
        irng, PEX)
    _dw2(st, "ic_act", m, cur_o, torch.where(ok[:, None], iact3, iact))
    _dw(st, "ic_actn", m, cur_o, torch.where(ok, actn3, actn))
    _dw(st, "ic_rng", ok, cur_o, irng3)
    ifirst = iact3[:, 0]
    icm = torch.where(actn3 > 0,
                      torch.clamp(_sel(st["drv_min"], ifirst), min=0), 0)
    _dw(st, "ic_min", ok, cur_o, icm)

    # generator min-cost propagation (not-do_full tail)
    gmin = _sel(st["drv_min"], gen)
    omin = _sel(st["od_min"], cur_o)
    upd = m & (gmin > omin)
    _dw(st, "od_min", upd, cur_o, gmin)
    icd = _sel(st["ic_done"], cur_o) > 0
    upd2 = upd & ~icd
    _dw(st, "od_min", upd2, cur_o,
        torch.minimum(_sel(st["od_min"], cur_o), _sel(st["ic_min"], cur_o)))
    _w(st, "mode", m & (st["mode"] == M_SDGEN), M_ODEND)


def _step_sdfull(st, cx):
    """SeededDriver.advance do_full tail (:1966)."""
    m = st["mode"] == M_SDFULL
    cur_o = st["cur_o"]
    gen = _cfgO(st, cx, "o_flat0", cur_o)
    ff = m & (_sel(st["ic_found"], cur_o) > 0)
    _dw(st, "od_found", ff, cur_o, 1)
    _dw(st, "ic_found", ff, cur_o, 0)
    rrv = torch.stack([_sel(st[k], cur_o) for k in (
        "il_top", "il_bot", "il_cost", "il_strat", "il_ne")], -1)
    _dw2(st, "od_rr", ff, cur_o, rrv)
    _dw2(st, "od_ed", ff, cur_o, _dsel2(st, "il_ed", cur_o))
    _dw2(st, "od_ec", ff, cur_o, _dsel2(st, "il_ec", cur_o))
    icm = _sel(st["ic_min"], cur_o)
    upd = m & (icm > st["sdf_old"])
    _dw(st, "od_min", upd, cur_o,
        torch.minimum(icm, _sel(st["drv_min"], gen)))
    _w(st, "mode", m, M_ODEND)


def _step_icadv(st, cx):
    """Inner CostAware.advance entry (:1992)."""
    m = st["mode"] == M_ICADV
    cur_o = st["cur_o"]
    actn = _sel(st["ic_actn"], cur_o)
    emp = m & (actn == 0)
    _dw(st, "ic_done", emp, cur_o, 1)
    _w(st, "mode", emp, M_SDFULL)
    go = m & ~emp
    p = _dsel2(st, "ic_act", cur_o)[:, 0]
    _w(st, "cur", go, p)
    _w(st, "ic_pre", go, _sel(st["drv_min"], p))
    pre = go & (_sel(st["drv_found"], p) > 0)
    _w(st, "mode", pre, M_ICPOST)
    adv = go & ~pre
    _w(st, "phase", adv, PH_FULL)
    _load_cur_rows(st, adv, st["cur"], cx.L)
    _w(st, "mode", adv, M_DADV)


def _step_icpost(st, cx):
    """Inner CostAware.advance tail (:2013)."""
    m = st["mode"] == M_ICPOST
    cur_o = st["cur_o"]
    p = st["cur"]
    pf = m & (_sel(st["drv_found"], p) > 0)
    rrv = _dsel2(st, "rr", p)
    for k, f in enumerate(("il_top", "il_bot", "il_cost", "il_strat",
                           "il_ne")):
        _dw(st, f, pf, cur_o, rrv[:, k])
    _dw2(st, "il_ed", pf, cur_o, _dsel2(st, "rr_ed", p))
    _dw2(st, "il_ec", pf, cur_o, _dsel2(st, "rr_ec", p))
    _dw(st, "ic_found", pf, cur_o, 1)
    _dw(st, "drv_found", pf, p, 0)
    needs = m & ((_sel(st["drv_done"], p) > 0)
                 | (st["ic_pre"] != _sel(st["drv_min"], p)))
    iact = _dsel2(st, "ic_act", cur_o)
    actn = _sel(st["ic_actn"], cur_o)
    irng = _sel(st["ic_rng"], cur_o)
    iact2, actn2, irng2 = _sort_generic(
        needs, iact, actn, st["drv_done"], st["drv_found"], st["drv_min"],
        irng, PEX)
    _dw2(st, "ic_act", needs, cur_o, iact2)
    _dw(st, "ic_actn", needs, cur_o, actn2)
    _dw(st, "ic_rng", needs, cur_o, irng2)
    ifirst = iact2[:, 0]
    _dw(st, "ic_min", needs & (actn2 > 0), cur_o,
        torch.maximum(_sel(st["drv_min"], ifirst), _sel(st["ic_min"],
                                                        cur_o)))
    _dw(st, "ic_done", needs & (actn2 == 0), cur_o, 1)
    _w(st, "mode", m, M_SDFULL)


def _step_chase(st, cx):
    """One RangeChaser row: resolve + joinedToTextOff + sink (:2056)."""
    m = st["mode"] == M_CHASE
    pair = cx.pair
    efw = _cfgO(st, cx, "o_chase_efw", st["ls_drv"])
    spread = st["ls_bot"] - st["ls_top"]
    ri = st["ch_r"] + st["ch_k"]
    ri = torch.where(ri >= st["ls_bot"], ri - spread, ri)
    ri_safe = torch.where(m, ri, 0)
    if pair.dense:
        off = cx.by_index(efw, lambda fm: u32(fm.sa[ri_safe]))
        cx.touch("sa_entries", ri_safe, efw, m)
        if cx.work is not None:
            cx.work["sa_loads"] += int(m.sum())
    else:
        start = m & (st["r_walk"] == 0)
        row = torch.where(start, ri_safe, st["r_row"])
        jumps = torch.where(start, 0, st["r_jumps"])
        omask = (1 << pair.fw.off_rate) - 1
        zoff = torch.where(efw > 0, pair.fw.zoff, pair.bw.zoff)
        at_z = row == zoff
        marked = ((row & omask) == 0) | at_z
        resolved = m & marked
        sidx = torch.where(m, row >> pair.fw.off_rate, 0)
        off = torch.where(at_z, jumps, cx.by_index(
            efw, lambda fm: u32(fm.offs[sidx])) + jumps)
        walkers = m & ~marked
        wrow = torch.where(walkers, row, 0)
        lf = cx.by_index(efw, lambda fm: lf_row_compact_plain(fm, wrow))
        if cx.work is not None:
            w = cx.work
            w["walk_steps"] += int(walkers.sum())
            w["rank_codes"] += int(walkers.sum())
            w["word_codes"] += int(words_needed(wrow)[walkers].sum())
            w["sa_loads"] += int(resolved.sum())
        cx.touch("sa_entries", sidx, efw, resolved & ~at_z)
        cx.touch("occ_entries", wrow // OCC_BLOCK, efw, walkers)
        cx.touch("bwt_blocks", wrow // OCC_BLOCK, efw, walkers)
        st["r_row"] = torch.where(walkers, lf, row)
        st["r_jumps"] = torch.where(walkers, jumps + 1, jumps)
        st["r_walk"] = torch.where(m, torch.where(resolved, 0, 1),
                                   st["r_walk"])
        m = resolved
    qlen = _sel(st["qlen_o"], st["ls_drv"])
    rs = pair.rstarts
    nfrag = cx.nfrag
    if nfrag == 1:
        start_f = torch.zeros_like(off)
        upper = torch.full_like(off, pair.length)
        tidx = torch.zeros_like(off)
        toff0 = torch.zeros_like(off)
    else:
        elt = torch.searchsorted(rs[:, 0].contiguous(), off, right=True) - 1
        elt = torch.where(elt < 0, elt + nfrag, elt)
        start_f = rs[elt, 0]
        upper = torch.where(elt + 1 < nfrag,
                            rs[torch.clamp(elt + 1, max=nfrag - 1), 0],
                            pair.length)
        tidx = rs[elt, 1]
        toff0 = rs[elt, 2]
    valid = off + qlen <= upper
    fragoff = off - start_f
    fraglen = upper - start_f
    fragoff = torch.where(efw == 0, fraglen - fragoff - 1 - (qlen - 1),
                          fragoff)
    toff = fragoff + toff0

    hit = m & valid
    newcount = st["count"] + 1
    _w(st, "count", hit, newcount)
    _w(st, "best_stratum", hit,
       torch.minimum(st["best_stratum"], st["ls_strat"]))
    maxed = hit & (newcount > cx.m_max)
    _w(st, "result", maxed, 2)
    _w(st, "mode", maxed, M_DONE)
    stored = hit & ~maxed
    fwflag = _cfgO(st, cx, "o_fw", st["ls_drv"])
    nmms = st["ls_ne"]
    pad = torch.zeros((off.shape[0], MM_SLOTS - E_MAX), dtype=torch.int64,
                      device=off.device)
    rec = torch.cat([torch.stack(
        [tidx, toff, fwflag | (efw << 1), spread - 1, st["ls_strat"],
         st["ls_cost"], nmms, qlen], -1),
        torch.cat([st["ls_ed"], pad], 1), torch.cat([st["ls_ec"], pad], 1)],
        -1)
    slot_full = st["nhits"] >= H_MAX
    over = stored & (slot_full | (nmms > MM_SLOTS))
    st["overflow"] = st["overflow"] | over
    _w(st, "mode", over, M_DONE)
    do_store = stored & ~over
    B = m.shape[0]
    hm = _oh(st["nhits"], H_MAX) & do_store[:, None]
    st["hits"] = torch.where(hm.repeat_interleave(HIT_W, 1),
                             rec.repeat(1, H_MAX), st["hits"])
    _w(st, "nhits", do_store, st["nhits"] + 1)
    n_k, m_max = cx.n_k, cx.m_max
    stop = do_store & (newcount == n_k) & ((m_max == INF32) or (m_max < n_k))
    _w(st, "result", stop, 1)
    _w(st, "mode", stop, M_DONE)
    irr = do_store & ~stop & _irrelevant(st, st["ls_cost"], cx.strata)
    go_on = m & ~maxed & ~stop & ~over & ~irr
    nk2 = st["ch_k"] + 1
    _w(st, "ch_k", go_on, nk2)
    wrapped = go_on & (nk2 >= spread)
    endc = irr | wrapped
    _w(st, "ca_found", endc, 0)
    _w(st, "mode", endc, M_MAIN)


def _step_plain(st, cx):
    """One lockstep iteration (:2173 _machine_step).  The gated groups
    (SD+ICADV, SDGEN+ICPOST+SDFULL, SORT, CHASE) run, as there, only if
    some lane was in one of their modes when the iteration began; the
    ungated steps are skipped only when no lane is in their mode at that
    point, where they would change nothing."""
    cnts = torch.bincount(st["mode"], minlength=M_ICPOST + 1).tolist()
    mode = lambda: st["mode"]  # noqa: E731

    def live(mc):
        return bool((mode() == mc).any())

    for mc, fn in ((M_MAIN, _step_main), (M_CADV, _step_cadv),
                   (M_SFX, _step_sfx)):
        if live(mc):
            fn(st, cx)
    if cx.has_seeded and (cnts[M_SD] or cnts[M_ICADV]):
        _step_sd(st, cx)
        _step_icadv(st, cx)
    for mc, fn in ((M_OADV, _step_oadv), (M_DADV, _step_dadv),
                   (M_EXT, _step_ext), (M_SPP, _step_spp),
                   (M_DEND, _step_dend)):
        if live(mc):
            fn(st, cx)
    if cx.has_seeded and (cnts[M_SDGEN] or cnts[M_ICPOST] or cnts[M_SDFULL]):
        _step_sdgen(st, cx)
        _step_icpost(st, cx)
        _step_sdfull(st, cx)
    for mc, fn in ((M_ODEND, _step_odend), (M_CPOST, _step_cpost),
                   (M_SFXEND, _step_sfxend)):
        if live(mc):
            fn(st, cx)
    if cnts[M_SORT]:
        _step_sort(st, cx)
    if cnts[M_CHASE] and not cx.record:
        _step_chase(st, cx)


def run_machine_plain(pair, cfg: dict, st: dict, *, chunk: int,
                      work: dict | None = None, **kw):
    """K10's plain version: lockstep iterations of the machine
    (bowtie_tpu/align/best_device.py:2224 run_chunk) over the state `st`
    (init_state) until every lane is M_DONE or `chunk` iterations have
    run.  cfg: the driver config arrays (HostInit.cfg, or several DAGs'
    tables concatenated, each lane addressing its own through cfg0f/cfg0o)
    as int64 tensors on the state's device; kw: nd, ndt, L, nfrag, n_k,
    m_max, strata, qual_lim, qual_order, bt_on, fc, has_seeded, record,
    rec_cap, paired, as run_chunk takes them (paired: the merged-mate DAG
    of the V2 recorder, with its mate elimination).
    -> (st, iterations).  If `work` is given (a dict), the rank work, walk
    steps and SA loads the run needs are added to its WORK_KEYS, and the
    distinct items it reads to the keys of TOUCHED, for bounds."""
    cx = _Ctx(pair, cfg, **kw)
    if work is not None:
        for k in WORK_KEYS:
            work.setdefault(k, 0)
        cx.work = work
    it = 0
    while it < chunk and bool((st["mode"] != M_DONE).any()):
        _step_plain(st, cx)
        it += 1
    if work is not None:
        work["iterations"] += it
        for k, keys in cx.touched.items():
            if keys:
                work[k] += int(torch.unique(torch.cat(keys)).numel())
    return st, it


# ---------------------------------------------------------------------------
# K10: the wrapper
# ---------------------------------------------------------------------------

OUT_KEYS = ("result", "overflow", "count", "best_stratum", "nhits", "hits",
            "mode")
# the config tables' bounds on a lane's driver DAG (outer, flat drivers):
# the paired V2 machine's merged -n 3 DAG, K14's largest; the largest of
# the other runs, the -n 3 and -v 3 fw-DAG + rc-DAG of the V1 recorder,
# is 2 x 4 outer and 2 x 12 flat drivers
ND_MAX, NDT_MAX = 16, 48
STEP_SUBSTEPS = 18               # sub-steps of one lockstep iteration
CFG_F = ("ebwt_fw", "fw", "exacts", "hh")
CFG_O = ("o_kind", "o_flat0", "o_exbase", "o_fw", "o_chase_efw", "o_m1")


def init_layout(nd: int, ndt: int, paired: bool = False) -> list:
    """(name, width) of the columns of pack_init's per-lane row, in
    order; csrc/best.cu reads them at the same offsets.  A paired run's
    row also holds each outer's read length and seed and each flat
    driver's RNG seed (the mate it serves)."""
    return ([(k, NBR) for k in P_KEYS]
            + [(k, ndt) for k in ("drv_done", "drv_found", "drv_min",
                                  "drv_adj", "drv_nextid", "dqlen", "dd5",
                                  "dd3")]
            + [("rr", ndt * 5)]
            + [(k, nd) for k in ("od_done", "od_found", "od_min", "act")]
            + [(k, 1) for k in ("act_n", "rng_ca", "ca_min", "qlen", "cfg0f",
                                "cfg0o")]
            + ([("qlen_o", nd), ("seed_o", nd), ("rng_rs", ndt)]
               if paired else []))


def pack_init(host: dict, nd: int, ndt: int,
              paired: bool = False) -> np.ndarray:
    """HostInit.build's arrays as one int32 row per lane ([B, NI], uint32
    values as their bit patterns), laid out by init_layout; the config
    bases cfg0f/cfg0o are zero unless `host` gives them."""
    B = len(host["qlen"])
    layout = init_layout(nd, ndt, paired)
    out = np.zeros((B, sum(w for _k, w in layout)), np.uint32)
    o = 0
    for k, w in layout:
        if k in host:
            # an integer column casts to its low 32 bits
            out[:, o:o + w] = np.asarray(host[k]).reshape(B, w)
        o += w
    return out.view(np.int32)


_I = ctypes.c_int32
_P = ctypes.c_void_p


class BestArgs(ctypes.Structure):
    """Mirror of `struct BestArgs` in csrc/best.cu (passed by pointer to
    the entry point, which passes it by value to the kernel)."""
    _fields_ = ([("fw", kernels.FMView), ("bw", kernels.FMView),
                 ("rstarts", _P), ("nfrag", _I), ("length", ctypes.c_uint32),
                 ("dense", _I), ("B", _I), ("L", _I), ("nd", _I),
                 ("ndt", _I), ("n_k", _I), ("m_max", _I), ("strata", _I),
                 ("qual_lim", _I), ("qual_order", _I), ("bt_on", _I),
                 ("has_seeded", _I), ("maxbts", _I), ("record", _I),
                 ("rec_cap", _I), ("paired", _I),
                 ("max_transitions", ctypes.c_int64)]
                + [("cfg_" + k, _I * NDT_MAX) for k in CFG_F]
                + [("cfg_" + k, _I * ND_MAX) for k in CFG_O]
                + [(k, _P) for k in ("init", "rows_qp", "seeds", "ptb",
                                     "meta", "scratch", "result", "overflow",
                                     "count", "best_stratum", "nhits", "hits",
                                     "mode", "steps")])


# K10's launch shape (csrc/best.cu kMaxLanes, kOnchipL, lane_words,
# scratch_words): MACHINE_LANES lanes a block, and smaller blocks for
# batches of under SMS x MACHINE_LANES lanes, so that every SM gets
# lanes.  16 lanes a block (four blocks an SM at the CLI's batch) ran
# 3-12 % faster than a whole warp on the best_bench.py cases (PERF.md).
# A lane's branch pool, live masks, active list and pick words (and, for
# rows of up to ONCHIP_L positions, its meta) live in shared memory,
# interleaved by lane; its per-driver blocks in a scratch column of
# scratch_words words, allocated by the wrapper.
MACHINE_LANES = 16
ONCHIP_L = 64
SMS = 132                           # the H100's streaming multiprocessors
# a pool slot: 13 scalar words, d0-d3 in 2, edit depths in 3, edit codes
# in 1
POOL_WORDS = (15 + 3 + 1) * NBR
PICK_WORDS = 8
FLAT_WORDS = 34                     # per flat driver
OUTER_WORDS = 47                    # per outer driver (paired: + 2)
# a block's shared bytes: two blocks fit one SM's 228 KB with the
# runtime's 1 KB a block
SM_SHARED = 228 * 1024
SHARED_LIMIT = SM_SHARED // 2 - 1024


def lane_shared_words(L: int, nd: int, onchip: bool) -> int:
    """K10's shared words a lane (csrc/best.cu lane_words): the pool, the
    pick words, the outer active list and on chip each slot's 64-bit mask
    of live positions and the meta [NBR][L] as 16-bit words."""
    return (POOL_WORDS + PICK_WORDS + nd
            + (2 * NBR + NBR * L // 2 if onchip else 0))


def scratch_words(nd: int, ndt: int, paired: bool) -> int:
    """A lane's scratch words (csrc/best.cu scratch_words): the blocks of
    its nd outer and ndt flat drivers, a paired lane's outers with their
    mate's read length and seed."""
    return FLAT_WORDS * ndt + (OUTER_WORDS + 2 * paired) * nd


def machine_shape(B: int, L: int, nd: int, ndt: int, paired: bool) -> dict:
    """K10's launch for B lanes of row width L over nd outer / ndt flat
    drivers: lanes (threads) a block, blocks, whether the meta is on chip
    (L <= ONCHIP_L), the block's shared bytes (dynamic, and with the
    arguments' copy), and the scratch words a lane."""
    if not (0 < nd <= ND_MAX and 0 < ndt <= NDT_MAX):
        raise ValueError(f"{nd} outer / {ndt} flat drivers exceed the "
                         f"kernel's {ND_MAX} / {NDT_MAX}")
    onchip = L <= ONCHIP_L
    # B // SMS lanes a block (at least one) make at least SMS blocks
    threads = max(1, min(MACHINE_LANES, B // SMS))
    dynamic = threads * 4 * lane_shared_words(L, nd, onchip)
    shared = dynamic + ctypes.sizeof(BestArgs)
    if shared > SHARED_LIMIT:
        raise ValueError(f"K10 needs {shared} shared bytes a block at L={L}")
    return dict(threads=threads, blocks=-(-B // threads), onchip=onchip,
                dynamic_shared=dynamic, shared=shared,
                scratch_words=scratch_words(nd, ndt, paired))


def _check_machine(L: int, nd: int, ndt: int, paired: bool) -> None:
    """Raise unless csrc/best.cu's K10 launches the shape machine_shape
    describes."""
    so = kernels.lib()
    if (so.bt_best_max_lanes() < MACHINE_LANES
            or so.bt_best_onchip_l() != ONCHIP_L
            or so.bt_best_args_bytes() != ctypes.sizeof(BestArgs)
            or any(so.bt_best_lane_words(L, nd, oc)
                   != lane_shared_words(L, nd, oc) for oc in (0, 1))
            or so.bt_best_scratch_words(nd, ndt, int(paired))
            != scratch_words(nd, ndt, paired)):
        raise RuntimeError("csrc/best.cu and align/best_device.py disagree "
                           "on K10's launch shape")


def run_machine(pair, cfg: dict, host: dict, seeds: torch.Tensor, *,
                L: int, nd: int, ndt: int, maxbts: int, n_k: int,
                m_max: int, strata: bool, qual_lim: int, qual_order: bool,
                bt_on: bool, has_seeded: bool, max_steps: int,
                record: bool = False, rec_cap: int | None = None,
                paired: bool = False):
    """K10: run every lane of the batch to M_DONE.  cfg: HostInit.cfg
    (numpy), or several DAGs' tables concatenated, which host's
    cfg0f/cfg0o columns address per lane; host: HostInit.build's arrays
    for these lanes (numpy); seeds: int64 [B] per-read seeds (uint32
    values) on the pair's device.  record/rec_cap: K10r, the record mode
    (module docstring), whose launches count under "best_record".
    paired (with record): K14, the merged-mate DAG of the paired V2
    recorder (align/pev2_device.py), host giving qlen_o/seed_o/rng_rs by
    mate; it runs the kernel's paired instantiation (csrc/best.cu) and
    its launches count under "best_pev2".
    -> (outputs by OUT_KEYS, int32/bool [B] and hits [B, H_MAX*HIT_W];
    overflow includes the lanes still running at the budget; the most
    iterations (plain) or transitions (kernel) any lane took).

    Launches csrc/best.cu's best_machine_kernel on CUDA tensors
    (run_machine_lanes); CPU tensors take init_state + run_machine_plain."""
    dev = pair.device
    B = seeds.shape[0]
    if not kernels.all_on_cpu(seeds, device=dev):
        out, steps = run_machine_lanes(
            pair, cfg, host, seeds, L=L, nd=nd, ndt=ndt, maxbts=maxbts,
            n_k=n_k, m_max=m_max, strata=strata, qual_lim=qual_lim,
            qual_order=qual_order, bt_on=bt_on, has_seeded=has_seeded,
            max_steps=max_steps, record=record, rec_cap=rec_cap,
            paired=paired)
        return out, (steps.max() if B else torch.tensor(0)).long()
    kw = dict(nd=nd, ndt=ndt, L=L, nfrag=pair.nfrag, n_k=n_k, m_max=m_max,
              strata=strata, qual_lim=qual_lim, qual_order=qual_order,
              bt_on=bt_on, fc=pair.ftab_chars, has_seeded=has_seeded,
              record=record, rec_cap=rec_cap, paired=paired)
    st = init_state(B, L, nd, ndt, seeds.numpy(), host, maxbts, dev)
    cfg_t = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
             for k, v in cfg.items()}
    # thousands of small ops per iteration: intra-op threads only add
    # their overhead (about 3x here)
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        st, it = run_machine_plain(pair, cfg_t, st, chunk=max_steps, **kw)
    finally:
        torch.set_num_threads(nthreads)
    out = {k: st[k] for k in OUT_KEYS}
    out["overflow"] = st["overflow"] | (st["mode"] != M_DONE)
    return out, torch.tensor(it)


def run_machine_lanes(pair, cfg: dict, host: dict, seeds: torch.Tensor, *,
                      L: int, nd: int, ndt: int, maxbts: int, n_k: int,
                      m_max: int, strata: bool, qual_lim: int,
                      qual_order: bool, bt_on: bool, has_seeded: bool,
                      max_steps: int, record: bool = False,
                      rec_cap: int | None = None, paired: bool = False):
    """K10 on CUDA tensors, as run_machine takes them: (outputs by
    OUT_KEYS, each lane's transitions as int32 [B]).  One thread per lane
    in machine_shape's blocks, 18 * max_steps transitions each (module
    docstring); the per-lane scratch (the driver blocks' column, the
    branch pools' ptb and, beyond ONCHIP_L, meta) allocated here, each
    word initialised by the kernel where a transition can read it before
    writing it."""
    dev = pair.device
    B = seeds.shape[0]
    if kernels.all_on_cpu(seeds, device=dev):
        raise ValueError("run_machine_lanes runs the kernel: CUDA tensors "
                         "only (run_machine takes CPU tensors)")
    kernels.check(seeds, "seeds", torch.int64, 1, dev)
    kernels.check(pair.rstarts, "rstarts", torch.int64, 2, dev)
    nco, ncf = len(cfg["o_kind"]), len(cfg["ebwt_fw"])
    if max(nco, nd) > ND_MAX or max(ncf, ndt) > NDT_MAX:
        raise ValueError(f"{nco} outer / {ncf} flat driver configs exceed "
                         f"the kernel's {ND_MAX} / {NDT_MAX}")
    if host["rows_qp"].shape != (B, ndt, 2 * L):
        raise ValueError("host rows_qp and the batch disagree on shapes")
    shape = machine_shape(B, L, nd, ndt, paired)
    init = torch.from_numpy(pack_init(host, nd, ndt, paired)).to(dev)
    rows_qp = torch.from_numpy(np.ascontiguousarray(
        host["rows_qp"], dtype=np.int8)).to(dev)
    out = {k: torch.empty((B, H_MAX * HIT_W) if k == "hits" else (B,),
                          dtype=torch.int32, device=dev)
           for k in OUT_KEYS + ("steps",)}
    ptb = torch.empty((B, NBR, 2 * L), dtype=torch.int32, device=dev)
    meta = (None if shape["onchip"] else
            torch.empty((B, NBR, L), dtype=torch.int16, device=dev))
    scratch = torch.empty((shape["scratch_words"], B), dtype=torch.int32,
                          device=dev)
    if B:
        a = BestArgs(
            fw=kernels.fm_view(pair.fw), bw=kernels.fm_view(pair.bw),
            rstarts=pair.rstarts.data_ptr(), nfrag=pair.nfrag,
            length=pair.length, dense=int(pair.dense), B=B, L=L, nd=nd,
            ndt=ndt, n_k=n_k, m_max=m_max, strata=int(strata),
            qual_lim=qual_lim, qual_order=int(qual_order), bt_on=int(bt_on),
            has_seeded=int(has_seeded), maxbts=maxbts, record=int(record),
            rec_cap=-1 if rec_cap is None else rec_cap, paired=int(paired),
            max_transitions=STEP_SUBSTEPS * max_steps,
            init=init.data_ptr(), rows_qp=rows_qp.data_ptr(),
            seeds=seeds.data_ptr(), ptb=ptb.data_ptr(),
            meta=None if meta is None else meta.data_ptr(),
            scratch=scratch.data_ptr(),
            **{k: v.data_ptr() for k, v in out.items()})
        for k in CFG_F:
            getattr(a, "cfg_" + k)[:ncf] = [int(x) for x in cfg[k]]
        for k in CFG_O:
            getattr(a, "cfg_" + k)[:nco] = [int(x) for x in cfg[k]]
        _check_layout(nd, ndt, paired)
        _check_machine(L, nd, ndt, paired)
        # K10r (record mode) and K14 (paired record mode) count apart
        # from K10
        kernels.launch("best_pev2" if paired else
                       "best_record" if record else "best_machine",
                       "bt_best_machine", ctypes.byref(a), shape["threads"],
                       device=dev)
    steps = out.pop("steps")
    out["overflow"] = out["overflow"] != 0
    return out, steps


def machine_local_bytes() -> dict:
    """The local memory (stack) per thread of csrc/best.cu's two
    instantiations of K10 (cudaFuncGetAttributes), which the runtime
    reserves for every resident thread: "single" (K10, K10r) and
    "paired" (K14)."""
    so = kernels.lib()
    return {"single": so.bt_best_local_bytes(0),
            "paired": so.bt_best_local_bytes(1)}


def _check_layout(nd: int, ndt: int, paired: bool = False) -> None:
    """Raise unless csrc/best.cu reads pack_init's row at the width
    init_layout gives it."""
    want = sum(w for _k, w in init_layout(nd, ndt, paired))
    if kernels.lib().bt_best_init_width(nd, ndt, int(paired)) != want:
        raise RuntimeError("csrc/best.cu and align/best_device.py disagree "
                           "on the init row")


# ---------------------------------------------------------------------------
# K11: one buffer per batch
# ---------------------------------------------------------------------------

HARVEST_KEYS = ("result", "overflow", "count", "best_stratum", "nhits")


def best_pack_plain(out: dict) -> torch.Tensor:
    """The lanes' scalars and hit rows in one int32 buffer: [5, B] (the
    HARVEST_KEYS rows, as bowtie_tpu/align/best_device.py:2264
    _harvest_small stacks them) then each lane's first nhits hit rows
    [sum nhits, HIT_W] (:2311 _gather_rows), lane by lane."""
    B = out["nhits"].shape[0]
    nh = out["nhits"].long()
    lanes = torch.repeat_interleave(torch.arange(B, device=nh.device), nh)
    first = torch.cumsum(nh, 0) - nh
    slots = torch.arange(lanes.shape[0], device=nh.device) - first[lanes]
    rows = out["hits"].reshape(B, H_MAX, HIT_W)[lanes, slots]
    small = torch.stack([out[k].to(torch.int32) for k in HARVEST_KEYS])
    return torch.cat([small.reshape(-1), rows.to(torch.int32).reshape(-1)])


def best_pack(out: dict) -> torch.Tensor:
    """K11: best_pack_plain's buffer from run_machine's outputs.  The
    exclusive scan of nhits is torch.cumsum; launches csrc/best.cu's
    best_pack_kernel on CUDA tensors, one thread per (lane, hit slot)."""
    dev = out["nhits"].device
    if kernels.all_on_cpu(*(out[k] for k in OUT_KEYS)):
        return best_pack_plain(out)
    for k in ("result", "count", "best_stratum", "nhits", "hits"):
        kernels.check(out[k], k, torch.int32, None, dev)
    kernels.check(out["overflow"], "overflow", torch.bool, 1, dev)
    B = out["nhits"].shape[0]
    nh = out["nhits"]
    hoff = torch.cumsum(nh, 0) - nh                  # int64
    total = int(hoff[-1] + nh[-1]) if B else 0
    packed = torch.empty(5 * B + total * HIT_W, dtype=torch.int32,
                         device=dev)
    if B:
        kernels.launch("best_pack", "bt_best_pack", out["result"].data_ptr(),
                       out["overflow"].data_ptr(), out["count"].data_ptr(),
                       out["best_stratum"].data_ptr(), nh.data_ptr(),
                       out["hits"].data_ptr(), hoff.data_ptr(), B,
                       packed.data_ptr(), device=dev)
    return packed


def unpack_harvest(packed: np.ndarray, B: int) -> dict:
    """best_pack's buffer (on the host) -> the reference's _harvest dict:
    HARVEST_KEYS [B] (overflow as bool) and hits [B, H_MAX, HIT_W], rows
    past a lane's nhits zero."""
    small = packed[:5 * B].reshape(5, B)
    out = {k: small[i].copy() for i, k in enumerate(HARVEST_KEYS)}
    out["overflow"] = out["overflow"].astype(bool)
    nh = out["nhits"].astype(np.int64)
    full = np.zeros((B, H_MAX, HIT_W), np.int32)
    if nh.sum():
        lanes = np.repeat(np.arange(B), nh)
        slots = np.arange(len(lanes)) - np.repeat(np.cumsum(nh) - nh, nh)
        full[lanes, slots] = packed[5 * B:].reshape(-1, HIT_W)
    out["hits"] = full
    return out


# ---------------------------------------------------------------------------
# The aligner
# ---------------------------------------------------------------------------

class DeviceBestAligner:
    """--best / -M / --strata / -v 3 and seeded -n --best single-end
    aligner on the machine, on `device` (default CUDA), with the per-read
    host-engine re-run of overflowing lanes (`fallbacks` counts them).
    mode="v" runs the -v driver DAG; mode="n" the seeded DAG
    (seed_mms/seed_len/qual_cutoff)."""

    DENSE_LIMIT = 1 << 28

    def __init__(self, idx_fw: EbwtIndex, idx_bw: EbwtIndex, policy,
                 v: int = 2, strata: bool = False,
                 all_hits: bool = False, mode: str = "v",
                 seed_mms: int = 2, seed_len: int = 28,
                 qual_cutoff: int = 70,
                 nofw: bool = False, norc: bool = False,
                 maq: bool = True, better: bool = False,
                 global_seed: int = 0, max_steps: int = 60000,
                 maxbts: int = 800, compact: bool | None = None,
                 device=None):
        self.idx_fw, self.idx_bw = idx_fw, idx_bw
        if idx_fw.length >= (1 << 31):
            raise ValueError(
                f"the best-first machine compares rows as signed int32; "
                f"joined length {idx_fw.length:,} >= 2^31 routes to the "
                f"host engine")
        if compact is None:
            compact = idx_fw.length > self.DENSE_LIMIT
        self.pair = build_fmpair(idx_fw, idx_bw, device,
                                 dense_sa=not compact)
        self.policy = policy
        self.mode = mode
        self.v = v
        self.seed_mms, self.seed_len = seed_mms, seed_len
        self.qual_cutoff = qual_cutoff
        self.strata, self.all_hits = strata, all_hits
        self.nofw, self.norc = nofw, norc
        self.maq = maq
        self.qual_order = not better
        self.global_seed = global_seed
        self.max_steps = max_steps
        self.maxbts = maxbts
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
        self.hostinit = HostInit(self.outers, idx_fw, idx_bw, maq,
                                 self.qual_order, self.qual_lim, sl)
        self.nd = self.hostinit.nd
        self.ndt = self.hostinit.ndt
        self._fallback = None
        self._chaser = None
        self.fallbacks = 0

    def _sink_n(self):
        """BestSink.n: INF32//2 for --strata -a, INF32 for -a, else -k."""
        if self.strata and self.all_hits:
            return INF32 // 2
        if self.all_hits:
            return INF32
        return self.policy.n if self.policy.n < INF32 else INF32

    def _host_aligner(self):
        if self._fallback is None:
            from .best_factories import (make_best_aligner,
                                         make_seeded_best_aligner)
            from .golden import GoldenFM
            gf, gb = GoldenFM(self.idx_fw), GoldenFM(self.idx_bw)
            kw = dict(strata=self.strata, all_hits=self.all_hits,
                      nofw=self.nofw, norc=self.norc, maq=self.maq,
                      better=not self.qual_order,
                      global_seed=self.global_seed, maxbts=self.maxbts)
            if self.mode == "n":
                self._fallback = make_seeded_best_aligner(
                    gf, gb, self.seed_mms, self.seed_len, self.qual_cutoff,
                    self.policy, **kw)
            else:
                self._fallback = make_best_aligner(gf, gb, self.v,
                                                   self.policy, **kw)
        return self._fallback

    def align_batch(self, reads) -> list:
        if not reads:
            return []
        gate = (self.policy.n == 1 and self.policy.max >= INF32 and
                not self.policy.sample_max and not self.strata and
                not self.all_hits)
        if not gate:
            return self._align_batch_machine(reads)
        results = self._exact_gate(reads)
        rest = [i for i, r in enumerate(results) if r is None]
        if rest:
            sub = self._align_batch_machine([reads[i] for i in rest])
            for i, r in zip(rest, sub):
                results[i] = r
        return results

    # -- exact-hit fast path (first-1-good policies) ----------------------
    #
    # A read with a whole-read exact hit reports, without running the
    # machine, a hit fully determined by the two exact drivers' ranges
    # (the only cost-0 sub-drivers: every other starts at >= 1<<14), the
    # CostAware set_query sort draws over the static initial costs, the
    # strandFix delayed-range draw (range_source.h:2322: rq %
    # (spread_delayed + spread_first)) and the chase's first row draw,
    # all computable on the host (bowtie_tpu/align/best_device.py:2522).

    def _gate_ranges(self, reads, cfg):
        """Whole-read exact (top, bot) per read on cfg's index, by K2."""
        base = [(r.codes_fw if cfg.fw else r.codes_rc) for r in reads]
        if not cfg.ebwt_fw:
            base = [b[::-1] for b in base]
        L = max(8, max(len(b) for b in base))
        mat, lens = right_align(base, pad_to=L)
        fm = self.pair.fw if cfg.ebwt_fw else self.pair.bw
        top, bot = exact_ranges(fm, torch.from_numpy(mat).to(fm.device),
                                torch.from_numpy(lens).to(fm.device))
        return top.tolist(), bot.tolist()

    def _exact_gate(self, reads) -> list:
        from .best import FoundRange
        from .best_driver import RangeChaser
        from .golden import GoldenFM
        from .policy import ReadResult
        from .types import Hit
        from ..utils.rng import BtRandom
        if self._chaser is None:
            self._chaser = RangeChaser(GoldenFM(self.idx_fw),
                                       GoldenFM(self.idx_bw))
        outers = self.outers
        ex_idx = [i for i, oc in enumerate(outers) if oc.cfg.report_exacts]
        sl = self.seed_len if self.mode == "n" else 0
        tops, bots = {}, {}
        for i in ex_idx:
            tops[i], bots[i] = self._gate_ranges(reads, outers[i].cfg)
        seeds = fill_seed_caches(reads, self.global_seed).tolist()
        results = []
        for b, read in enumerate(reads):
            if not (4 <= len(read.seq) <= 255):
                results.append(None)
                continue
            spreads = {i: bots[i][b] - tops[i][b] for i in ex_idx}
            if all(s <= 0 for s in spreads.values()):
                results.append(None)     # no exact hit: machine path
                continue
            costs = [_outer_min_cost(oc, read, sl, self.maq,
                                     self.qual_order) for oc in outers]
            if any(c == 0 for i, c in enumerate(costs) if i not in ex_idx):
                results.append(None)     # ambiguous zero-cost tie
                continue
            rand = BtRandom(seeds[b])
            order = _emulate_sort_actives(costs, rand)
            first = order[0]
            emit = None
            if spreads.get(first, 0) > 0:
                emit = first
                # strandFix quirk: the mate/strand test reads the
                # construction-order driver, the advance acts on the
                # sorted-order one (range_source.h:2322-2327)
                for i in range(1, len(outers)):
                    if outers[i].cfg.fw != outers[first].cfg.fw:
                        p2 = order[i]
                        if costs[p2] > 0:
                            break
                        if spreads.get(p2, 0) > 0:
                            tot = spreads[p2] + spreads[first]
                            rq = rand.next_u32() % tot
                            if rq < spreads[p2]:
                                emit = p2
                        break
            else:
                others = [i for i in ex_idx if i != first and spreads[i] > 0]
                emit = others[0] if others else None
            if emit is None:
                results.append(None)
                continue
            cfg = outers[emit].cfg
            fr = FoundRange(top=tops[emit][b], bot=bots[emit][b], cost=0,
                            stratum=0, num_mms=0, fw=cfg.fw,
                            ebwt_fw=cfg.ebwt_fw, mms=[], refcs=[])
            hit = None
            for tidx, toff in self._chaser.chase(fr, len(read.seq),
                                                 BtRandom(seeds[b])):
                hit = Hit(read=read, fw=cfg.fw, tidx=tidx, toff=toff,
                          oms=spreads[emit] - 1, stratum=0, cost=0, mms=[])
                break
            if hit is None:
                results.append(None)
                continue
            results.append(ReadResult([hit], nvalid=1, nbuffered=1))
        return results

    def _align_batch_machine(self, reads) -> list:
        """K10 and K11 over the reads the machine takes (4-255 bases;
        the rest go to the host engine, as the reference's
        _align_batch_machine flags them), one download, then assemble."""
        B = len(reads)
        seeds = fill_seed_caches(reads, self.global_seed)
        lanes = [b for b, r in enumerate(reads) if 4 <= len(r.seq) <= 255]
        out = {k: np.zeros(B, bool if k == "overflow" else np.int32)
               for k in HARVEST_KEYS}
        out["overflow"][:] = True
        out["hits"] = np.zeros((B, H_MAX, HIT_W), np.int32)
        if lanes:
            sub = [reads[b] for b in lanes]
            L = _len_bucket(max(len(r.seq) for r in sub))
            host = self.hostinit.build(sub, L, seeds[lanes])
            dev = self.pair.device
            m, _ = run_machine(
                self.pair, self.hostinit.cfg, host,
                torch.from_numpy(seeds[lanes].astype(np.int64)).to(dev),
                L=L, nd=self.nd, ndt=self.ndt, maxbts=self.maxbts,
                n_k=self._sink_n(), m_max=min(self.policy.max, INF32),
                strata=self.strata, qual_lim=self.qual_lim,
                qual_order=self.qual_order, bt_on=self.bt_on,
                has_seeded=self.mode == "n", max_steps=self.max_steps)
            h = unpack_harvest(best_pack(m).cpu().numpy(), len(lanes))
            for k, v in h.items():
                out[k][lanes] = v
        return self.assemble(reads, out, seeds)

    def assemble(self, reads, out, seeds) -> list:
        """Per-read results from the harvested lanes (the reference's
        assemble, :2671): the mismatch decode, the --strata oms rewrite,
        the -M stratum sample, and the host-engine re-run of overflowed
        lanes."""
        from .policy import ReadResult
        from .types import Hit
        from ..utils.rng import BtRandom
        results = []
        n = self._sink_n()
        m_max = self.policy.max
        for b, read in enumerate(reads):
            if out["overflow"][b]:
                self.fallbacks += 1
                results.append(self._host_aligner().align_read(read))
                continue
            buffered = []
            qlen = len(read.seq)
            nh = int(out["nhits"][b])
            recs = out["hits"][b, :nh].tolist() if nh else ()
            for rec in recs:
                fw = bool(rec[2] & 1)
                ebwt_fw = bool((rec[2] >> 1) & 1)
                mms = []
                for k in range(rec[6]):
                    d = rec[8 + k]               # search depth
                    refc = rec[8 + MM_SLOTS + k]
                    pos = qlen - 1 - d
                    off = qlen - pos - 1 if (ebwt_fw != fw) else pos
                    mms.append((off, (97, 99, 103, 116)[refc]))
                buffered.append(Hit(
                    read=read, fw=fw, tidx=rec[0], toff=rec[1], oms=rec[3],
                    stratum=rec[4], cost=rec[5], mms=sorted(mms)))
            count = int(out["count"][b])
            maxed = count > m_max
            if self.strata:
                for h in buffered:
                    h.oms = len(buffered) - 1
            if maxed:
                if self.policy.sample_max and buffered:
                    rand = BtRandom(int(seeds[b]))
                    num = 1
                    while (num < len(buffered) and
                           buffered[num].stratum == buffered[0].stratum):
                        num += 1
                    h = buffered[rand.next_u32() % num]
                    results.append(ReadResult(
                        [h], maxed=True, nvalid=count, sampled=True,
                        nbuffered=len(buffered)))
                else:
                    results.append(ReadResult(
                        [], maxed=True, nvalid=count,
                        nbuffered=len(buffered)))
            else:
                results.append(ReadResult(
                    buffered[:n], nvalid=count,
                    nbuffered=min(len(buffered), n)))
        return results
