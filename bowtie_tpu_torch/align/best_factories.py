"""Stateful-aligner driver DAGs per alignment mode (aligner_0mm.h,
aligner_1mm.h, aligner_23mm.h factories).

A copy of bowtie_tpu/align/best_factories.py, single-end part: the
paired factories (_pe_do_matrix, make_paired_best_aligner,
make_paired_best_aligner_v2) wait for the paired-end slice of the port.
"""
from __future__ import annotations

from .best import (BestRangeSource, PIN_TO_BEGINNING, PIN_TO_HI_HALF_EDGE,
                   PIN_TO_LEN, PIN_TO_SEED_EDGE)
from .best_driver import (BestDriver, BestSink, CostAwareDriver,
                          RangeChaser, UnpairedBestAligner)
from .golden import GoldenFM
from .policy import KPolicy

INF32 = 0xFFFFFFFF


def _mk_driver(g, ebwt_fw, fw, pins, report_exacts=True, seed_len=0,
               qual_lim=INF32, hh=0, seeded=False, maq=True,
               qual_order=True, global_seed=0, bt_cnt=None,
               nudge_left=True):
    rs = BestRangeSource(g, ebwt_fw, fw, qual_lim=qual_lim,
                         report_exacts=report_exacts, half_and_half=hh,
                         seeded=seeded, maq_penalty=maq,
                         qual_order=qual_order, global_seed=global_seed)
    return BestDriver(rs, seed=seeded, seed_len=seed_len,
                      nudge_left=nudge_left, pins=pins, bt_cnt=bt_cnt)


def exact_best_driver_factory(g_fw: GoldenFM, nofw, norc, strand_fix,
                              maq, qual_order, global_seed):
    """UnpairedExactAlignerV1Factory::create (aligner_0mm.h:69-116):
    fw + rc sources on the forward index, whole read unrevisitable."""
    P = (PIN_TO_LEN,) * 4

    def make(read):
        drs = []
        if not nofw:
            drs.append(_mk_driver(g_fw, True, True, P, maq=maq,
                                  qual_order=qual_order,
                                  global_seed=global_seed))
        if not norc:
            drs.append(_mk_driver(g_fw, True, False, P, maq=maq,
                                  qual_order=qual_order,
                                  global_seed=global_seed))
        return CostAwareDriver(drs, strand_fix=strand_fix,
                               global_seed=global_seed)
    return make


def mm1_best_driver_factory(g_fw: GoldenFM, g_bw: GoldenFM, nofw, norc,
                            strand_fix, maq, qual_order, global_seed):
    """Unpaired1mmAlignerV1Factory::create (aligner_1mm.h:79-140):
    4 half-constrained sources — {fw read x mirror/fw idx,
    rc read x fw/mirror idx}; the exact-covering one of each pair
    reports exacts, the other doesn't."""
    P = (PIN_TO_HI_HALF_EDGE, PIN_TO_LEN, PIN_TO_LEN, PIN_TO_LEN)

    def make(read):
        kw = dict(maq=maq, qual_order=qual_order,
                  global_seed=global_seed)
        drs = []
        if not nofw:
            drs.append(_mk_driver(g_bw, False, True, P,
                                  report_exacts=True, nudge_left=False,
                                  **kw))
            drs.append(_mk_driver(g_fw, True, True, P,
                                  report_exacts=False, nudge_left=True,
                                  **kw))
        if not norc:
            drs.append(_mk_driver(g_fw, True, False, P,
                                  report_exacts=True, nudge_left=True,
                                  **kw))
            drs.append(_mk_driver(g_bw, False, False, P,
                                  report_exacts=False, nudge_left=False,
                                  **kw))
        return CostAwareDriver(drs, strand_fix=strand_fix,
                               global_seed=global_seed)
    return make


def mm23_best_driver_factory(g_fw: GoldenFM, g_bw: GoldenFM, two: bool,
                             nofw, norc, strand_fix, maq, qual_order,
                             global_seed, maxbts=125):
    """Unpaired23mmAlignerV1Factory::create (aligner_23mm.h): per
    strand, three sources — left-half-pinned (exacts), right-half-
    pinned (no exacts), and a half-and-half source."""
    # (aligner_23mm.h:99-122,131-134)
    Pfull = (PIN_TO_HI_HALF_EDGE, PIN_TO_HI_HALF_EDGE,
             PIN_TO_LEN if two else PIN_TO_HI_HALF_EDGE, PIN_TO_LEN)
    Phalf = (PIN_TO_BEGINNING, PIN_TO_HI_HALF_EDGE,
             PIN_TO_LEN if two else PIN_TO_HI_HALF_EDGE, PIN_TO_LEN)

    Phalf3 = (PIN_TO_BEGINNING, PIN_TO_HI_HALF_EDGE,
              PIN_TO_HI_HALF_EDGE, PIN_TO_LEN)

    def make(read):
        kw = dict(maq=maq, qual_order=qual_order,
                  global_seed=global_seed)
        drs = []
        if not nofw:
            drs.append(_mk_driver(g_bw, False, True, Pfull,
                                  report_exacts=True, nudge_left=True,
                                  **kw))
            drs.append(_mk_driver(g_fw, True, True, Pfull,
                                  report_exacts=False, nudge_left=False,
                                  **kw))
            drs.append(_mk_driver(g_bw, False, True, Phalf,
                                  report_exacts=False, hh=2,
                                  nudge_left=True, **kw))
            if not two:
                drs.append(_mk_driver(g_fw, True, True, Phalf3,
                                      report_exacts=False, hh=3,
                                      nudge_left=False, **kw))
        if not norc:
            drs.append(_mk_driver(g_fw, True, False, Pfull,
                                  report_exacts=True, nudge_left=True,
                                  **kw))
            drs.append(_mk_driver(g_bw, False, False, Pfull,
                                  report_exacts=False, nudge_left=False,
                                  **kw))
            drs.append(_mk_driver(g_fw, True, False, Phalf,
                                  report_exacts=False, hh=2,
                                  nudge_left=True, **kw))
            if not two:
                drs.append(_mk_driver(g_bw, False, False, Phalf3,
                                      report_exacts=False, hh=3,
                                      nudge_left=False, **kw))
        return CostAwareDriver(drs, strand_fix=strand_fix,
                               global_seed=global_seed)
    return make


def seeded_best_driver_factory(g_fw: GoldenFM, g_bw: GoldenFM,
                               seed_mms: int, seed_len: int,
                               qual_cutoff: int, nofw, norc, strand_fix,
                               maq, qual_order, global_seed,
                               maxbts=125, bt_cell=None):
    """UnpairedSeedAlignerFactory::create (aligner_seed_mm.h:80-532):
    per seedMms, exact/seed/half driver DAGs with seeded partial
    generation chained into full extension drivers.

    bt_cell: an externally owned backtrack-ceiling cell — the PE
    factories share ONE across all four (mate, strand) groups and
    reset it per pair (one `new int[1]` at aligner_seed_mm.h:665,
    `*btCnt_ = maxBts_` at PairedBWAlignerV1::setQuery,
    aligner.h:758)."""
    from .best_driver import SeededDriver
    SEED, HI, BEG, L = (PIN_TO_SEED_EDGE, PIN_TO_HI_HALF_EDGE,
                        PIN_TO_BEGINNING, PIN_TO_LEN)

    def drv(g, efw, fw, pins, exacts, nudge, hh=0, partial=False,
            seed_flag=False, bt=None):
        return _mk_driver(g, efw, fw, pins, report_exacts=exacts,
                          seed_len=seed_len, qual_lim=qual_cutoff,
                          hh=hh, seeded=seed_flag, maq=maq,
                          qual_order=qual_order, global_seed=global_seed,
                          bt_cnt=bt, nudge_left=nudge)

    def seeded(g_ext, efw_ext, g_gen, efw_gen, fw, gen_pins, bt):
        """One EbwtSeededRangeSourceDriver: gen (seed-truncated) +
        factory creating full extenders on the opposite index."""
        def full_factory():
            return drv(g_ext, efw_ext, fw, (SEED, SEED, SEED, SEED),
                       exacts=True, nudge=True, bt=bt)
        gen = drv(g_gen, efw_gen, fw, gen_pins, exacts=False,
                  nudge=False, partial=True, seed_flag=True, bt=bt)
        # gen source hh flag set by caller via gen.rs.half_and_half
        return SeededDriver(full_factory, gen, fw, seed_len,
                            global_seed=global_seed)

    def make(read):
        if seed_mms < 2:
            bt = None          # no backtrack limit for -n 0/1
        elif bt_cell is not None:
            bt = bt_cell
        else:
            bt = [maxbts]
        drs = []
        n = seed_mms
        for fw in (True, False):
            if fw and nofw:
                continue
            if not fw and norc:
                continue
            # exact-side index for this strand: mirror for fw reads,
            # forward for rc reads; gen side is the opposite
            g_e, efw_e = (g_bw, False) if fw else (g_fw, True)
            g_g, efw_g = (g_fw, True) if fw else (g_bw, False)
            if n == 0:
                drs.append(drv(g_e, efw_e, fw, (SEED,) * 4, exacts=True,
                               nudge=True))
            elif n == 1:
                drs.append(drv(g_e, efw_e, fw, (HI, SEED, SEED, SEED),
                               exacts=True, nudge=True))
                drs.append(seeded(g_e, efw_e, g_g, efw_g, fw,
                                  (HI, SEED, SEED, SEED), None))
            elif n == 2:
                drs.append(drv(g_e, efw_e, fw, (HI, HI, SEED, SEED),
                               exacts=True, nudge=True, bt=bt))
                drs.append(seeded(g_e, efw_e, g_g, efw_g, fw,
                                  (HI, HI, SEED, SEED), bt))
                drs.append(drv(g_e, efw_e, fw, (BEG, HI, SEED, SEED),
                               exacts=False, nudge=True, hh=2, bt=bt))
            else:
                drs.append(drv(g_e, efw_e, fw, (HI, HI, HI, SEED),
                               exacts=True, nudge=True, bt=bt))
                drs.append(seeded(g_e, efw_e, g_g, efw_g, fw,
                                  (HI, HI, HI, SEED), bt))
                s12 = seeded(g_e, efw_e, g_g, efw_g, fw,
                             (BEG, HI, HI, SEED), bt)
                s12.rs_seed.rs.half_and_half = 3
                drs.append(s12)
                drs.append(drv(g_e, efw_e, fw, (BEG, HI, HI, SEED),
                               exacts=False, nudge=True, hh=2, bt=bt))
        ca = CostAwareDriver(drs, strand_fix=strand_fix,
                             global_seed=global_seed)
        # expose the ceiling cell so graph-reusing aligners can reset
        # it per read (*btCnt_ = maxBts_, aligner.h:453)
        ca.bt_cell = bt
        ca.bt_init = maxbts
        return ca
    return make


def make_seeded_best_aligner(g_fw, g_bw, seed_mms, seed_len, qual_cutoff,
                             policy, strata, all_hits, nofw=False,
                             norc=False, maq=True, better=False,
                             global_seed=0, maxbts=125):
    from .best_driver import BestSink, RangeChaser, UnpairedBestAligner
    fac = seeded_best_driver_factory(
        g_fw, g_bw, seed_mms, seed_len, qual_cutoff, nofw, norc, True,
        maq, not better, global_seed, maxbts)
    chaser = RangeChaser(g_fw, g_bw)
    sink = BestSink(policy, strata, all_hits, global_seed)
    return UnpairedBestAligner(fac, chaser, sink, global_seed)


def make_best_aligner(g_fw: GoldenFM, g_bw: GoldenFM | None, v: int,
                      policy: KPolicy, strata: bool, all_hits: bool,
                      nofw=False, norc=False, maq=True, better=False,
                      global_seed=0, maxbts=800):
    if v == 0:
        fac = exact_best_driver_factory(g_fw, nofw, norc, True, maq,
                                        not better, global_seed)
    elif v == 1:
        fac = mm1_best_driver_factory(g_fw, g_bw, nofw, norc, True,
                                      maq, not better, global_seed)
    else:
        fac = mm23_best_driver_factory(g_fw, g_bw, v == 2, nofw, norc,
                                       True, maq, not better,
                                       global_seed, maxbts)
    chaser = RangeChaser(g_fw, g_bw)
    sink = BestSink(policy, strata, all_hits, global_seed)
    return UnpairedBestAligner(fac, chaser, sink, global_seed)
