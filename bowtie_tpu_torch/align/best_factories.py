"""Stateful-aligner driver DAGs per alignment mode (aligner_0mm.h,
aligner_1mm.h, aligner_23mm.h factories).

A copy of bowtie_tpu/align/best_factories.py: the single-end factories
and the paired ones (_pe_do_matrix, make_paired_best_aligner for V1,
make_paired_best_aligner_v2 for V2).
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


def _pe_do_matrix(nofw, norc, fw1, fw2):
    """--nofw/--norc gate PAIR orientations, mapped per mate through
    its --ff/--fr/--rf orientation (PairedSeedAlignerFactory,
    aligner_seed_mm.h:676-691): --nofw kills each mate's driver for
    the strand it uses in the fw-pair orientation; --norc the other.
    Keyed by (is_mate1, fw)."""
    do = {(m1, fw): True for m1 in (True, False) for fw in (True, False)}
    if nofw:
        do[(True, fw1)] = False
        do[(False, fw2)] = False
    if norc:
        do[(True, not fw1)] = False
        do[(False, not fw2)] = False
    return do


def make_paired_best_aligner(g_fw, g_bw, refs, policy, mode="n", v=0,
                             seed_mms=2, seed_len=28, qual_cutoff=70,
                             fw1=True, fw2=False, min_insert=0,
                             max_insert=250, pairtries=100,
                             mixed_thresh=4, sym_ceiling=INF32,
                             nofw=False, norc=False, maq=True,
                             better=False, global_seed=0, maxbts=800):
    """PairedBWAlignerV1 wiring (Paired*AlignerV1Factory): four
    per-(mate,strand) cost-aware drivers + a RefAligner for rescue."""
    from .best_paired import (PairedBestAligner, PairedBestSink,
                              RefAlignerPy)
    qual_order = not better
    # ONE backtrack-ceiling cell for the whole pair, shared by every
    # (mate, strand) group and reset per pair (aligner_seed_mm.h:665,
    # aligner.h:758)
    shared_bt = [maxbts] if (mode == "n" and seed_mms >= 2) else None

    def strand_factory(fw):
        if mode == "n":
            return seeded_best_driver_factory(
                g_fw, g_bw, seed_mms, seed_len, qual_cutoff,
                nofw=not fw, norc=fw, strand_fix=True, maq=maq,
                qual_order=qual_order, global_seed=global_seed,
                maxbts=maxbts, bt_cell=shared_bt)
        if v == 0:
            return exact_best_driver_factory(
                g_fw, not fw, fw, True, maq, qual_order, global_seed)
        if v == 1:
            return mm1_best_driver_factory(
                g_fw, g_bw, not fw, fw, True, maq, qual_order,
                global_seed)
        return mm23_best_driver_factory(
            g_fw, g_bw, v == 2, not fw, fw, True, maq, qual_order,
            global_seed, maxbts)

    do = _pe_do_matrix(nofw, norc, fw1, fw2)
    built = {}   # (mate1, fw) -> CostAwareDriver, reused across pairs

    def driver_factory(rd1, rd2):
        """The reference constructs one aligner object graph per
        thread and re-points it at each read via setQuery
        (aligner.h:45-84); building the graphs per pair costs ~25% of
        host PE time, so they are cached and reset here too."""
        if shared_bt is not None:
            shared_bt[0] = maxbts      # *btCnt_ = maxBts_ per pair
        out = []
        for mate_read, mate1 in ((rd1, True), (rd2, False)):
            for fw in (True, False):
                ca = built.get((mate1, fw))
                if ca is None:
                    if do[(mate1, fw)]:
                        ca = strand_factory(fw)(mate_read)
                    else:
                        # banned by --nofw/--norc: the reference
                        # leaves the per-(mate,strand) source vector
                        # empty (aligner_seed_mm.h:676-691) — a
                        # CostAware driver that is done on first
                        # advance with no RNG draws
                        from .best_driver import CostAwareDriver
                        ca = CostAwareDriver([], strand_fix=True,
                                             global_seed=global_seed)
                    for d in ca.rss:
                        d.mate1_flag = mate1
                    built[(mate1, fw)] = ca
                ca.seed_read = rd1
                ca.set_query(mate_read)
                out.append(ca)
        return out

    if mode == "n":
        ra = RefAlignerPy(seed_mms=seed_mms, seed_len=seed_len,
                          qual_max=qual_cutoff, maq_round=maq)
    else:
        ra = RefAlignerPy(v=v)
    sink = PairedBestSink(policy, global_seed)
    return PairedBestAligner(
        driver_factory, g_fw, g_bw, refs, ra, sink,
        min_insert=min_insert, max_insert=max_insert, fw1=fw1, fw2=fw2,
        mixed_thresh=mixed_thresh, mixed_attempt_lim=pairtries,
        sym_ceiling=sym_ceiling, global_seed=global_seed)


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


def make_paired_best_aligner_v2(g_fw, g_bw, refs, policy, mode="n",
                                v=0, seed_mms=2, seed_len=28,
                                qual_cutoff=70, fw1=True, fw2=False,
                                min_insert=0, max_insert=250,
                                pairtries=100, nofw=False, norc=False,
                                maq=True, better=False, report_se=False,
                                best_sink=True, global_seed=0,
                                maxbts=800, order=None):
    """PairedBWAlignerV2 wiring (Paired*AlignerV1Factory with v1_
    false, aligner_0mm.h:323-339 etc.): ONE cost-merged driver over all
    (mate, strand) source groups; used for --best PE, --pev2 and
    --reportse.

    `order` is the drVec construction order of (mate1, fw) groups —
    (1,Fw),(1,Rc),(2,Fw),(2,Rc) for the -v exact factory;
    (1,Fw),(2,Fw),(1,Rc),(2,Rc) for the seeded factory (all four
    vectors alias dr1FwVec, aligner_seed_mm.h:700-703)."""
    from .best_driver import CostAwareDriver
    from .best_paired import (PairedBestAlignerV2, PairedBestSinkV2,
                              RefAlignerPy)
    qual_order = not better
    # one shared, per-pair-reset backtrack cell (aligner_seed_mm.h:665)
    shared_bt = [maxbts] if (mode == "n" and seed_mms >= 2) else None

    def strand_factory(fw):
        if mode == "n":
            return seeded_best_driver_factory(
                g_fw, g_bw, seed_mms, seed_len, qual_cutoff,
                nofw=not fw, norc=fw, strand_fix=True, maq=maq,
                qual_order=qual_order, global_seed=global_seed,
                maxbts=maxbts, bt_cell=shared_bt)
        if v == 0:
            return exact_best_driver_factory(
                g_fw, not fw, fw, True, maq, qual_order, global_seed)
        if v == 1:
            return mm1_best_driver_factory(
                g_fw, g_bw, not fw, fw, True, maq, qual_order,
                global_seed)
        return mm23_best_driver_factory(
            g_fw, g_bw, v == 2, not fw, fw, True, maq, qual_order,
            global_seed, maxbts)

    if order is None:
        order = ([(True, True), (True, False), (False, True),
                  (False, False)] if mode != "n" else
                 [(True, True), (False, True), (True, False),
                  (False, False)])

    do = _pe_do_matrix(nofw, norc, fw1, fw2)
    cache = []   # the merged driver, reused across pairs (setQuery
                 # re-points it, aligner.h:45-84)

    def driver_factory(rd1, rd2):
        if not cache:
            drs = []
            for mate1, fw in order:
                if not do[(mate1, fw)]:
                    continue
                ca = strand_factory(fw)(rd1 if mate1 else rd2)
                for d in ca.rss:
                    d.mate1_flag = mate1
                    if hasattr(d, "rs"):    # plain BestDriver: the
                        d.rs.mate1 = mate1  # range's mate1 field
                drs.extend(ca.rss)
            cache.append(CostAwareDriver(drs, strand_fix=True,
                                         global_seed=global_seed))
        merged = cache[0]
        if shared_bt is not None:
            shared_bt[0] = maxbts      # *btCnt_ = maxBts_ per pair
        merged.set_query_paired(rd1, rd2)
        return merged

    if mode == "n":
        ra = RefAlignerPy(seed_mms=seed_mms, seed_len=seed_len,
                          qual_max=qual_cutoff, maq_round=maq)
    else:
        ra = RefAlignerPy(v=v)
    sink = PairedBestSinkV2(policy, global_seed, best=best_sink)
    return PairedBestAlignerV2(
        driver_factory, g_fw, g_bw, refs, ra, sink,
        se_policy=(policy if report_se else None),
        min_insert=min_insert, max_insert=max_insert, fw1=fw1, fw2=fw2,
        mixed_attempt_lim=pairtries, global_seed=global_seed)
