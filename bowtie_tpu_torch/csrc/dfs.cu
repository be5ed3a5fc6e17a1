// The GreedyDFS machine (-v 1/2, and the -n launches): K6 row derivation,
// K7 the state machine, K8 dense packing of its hit and partial rows, K9
// the -n launch-B job table.
// Built with exact.cu by bowtie_tpu_torch/kernels.py and called through
// the plain C entry points at the bottom.
//
// Replaces:
//   K6 bt_derive_rows <- bowtie_tpu/align/dfs_device.py:496 derive_rows_jit
//                        (:412 _derive_rows_impl)
//   K7 bt_dfs_machine <- dfs_device.py:1484 run_machine, :1812 run_chunk
//                        (:1445 _machine_step), with K5 (:261 _rank4,
//                        :303 _lf4pair) inlined from fm.cuh, and K8's
//                        :2006 _init_state_jit as its prologue
//   K8 bt_dfs_pack    <- dfs_device.py:1874 _gather_rows, :1927
//                        _fuse_parts_jit, :1954 _pack_all, and :2011
//                        decode_hit_cols's hit gather
//   K9 bt_derive_b_jobs <- bowtie_tpu/align/n_device.py:85
//                        _derive_b_jobs_device (less its K6 tail)
// Plain PyTorch versions, which these are held to: derive_rows_plain,
// run_machine_plain (the lockstep form, step for step the JAX one) and
// pack_hits_plain in bowtie_tpu_torch/align/dfs_device.py, and
// derive_b_jobs_plain in bowtie_tpu_torch/align/n_device.py.  The lane
// compaction of the JAX driver (:1830 _compact) has no counterpart: each
// thread runs its own lane to the end and retires it.
//
// K7 runs one thread per lane.  The JAX version advances every lane one
// group of sub-steps per lockstep iteration (RETF, JOB, ADV x3, POP, REP,
// BR); here each thread applies its lane's transitions one after another,
// `switch (mode)`, until M_DONE.  A lane's transitions depend only on its
// own state, so the per-lane result is the same.  Each function below is
// the scalar form of the JAX sub-step of the same name, masked writes and
// all (a lane whose partial store overflows keeps running that sub-step,
// as there).  Step budget: an iteration applies at most 8 transitions to
// a lane, so a lane gets max_transitions = 8 * max_steps; whatever the
// lockstep version finishes within budget, this finishes too.
//
// Frames: the current frame's 28 registers live in registers, parents'
// in a per-thread stack (local memory); each stack level has its own
// [L][8] pairs and [L] elims slice in a per-lane global scratch, so a push
// copies only the registers.  A frame reads only positions >= its own
// depth, which it wrote, so this equals the JAX copy-the-frame push.
//
// What bounds K7: every ADV transition is a dependent pair of ranks (two
// 32-byte occ+word sector pairs, fm.cuh rank4) and every REP transition a
// dependent SA read (or a walk-left rank); lanes diverge from the first
// branch, so a warp runs its lanes' transitions mostly one lane at a time.
// It is bound by the latency of dependent L2/HBM reads and by divergence,
// not by bandwidth or arithmetic.  One thread per lane keeps the lane
// state in registers and retires finished lanes without the lockstep's
// masked work; warp-cooperative lanes and sorting lanes by mode are later
// work.  K6 is an elementwise copy, bound by bytes; K8 moves a few MB
// and is bound by launch and host-sync latency (its note below).
#include "fm.cuh"
#include "lookback.cuh"

// Mirrors DfsArgs in bowtie_tpu_torch/kernels.py field for field.
struct DfsArgs {
    BtFM fw, bw;
    const int64_t* rstarts;     // [nfrag][3] start, tidx, toff
    int32_t nfrag;
    uint32_t length;
    int32_t dense;
    const int32_t* scal;        // [B][J][NJF]
    const int8_t* qqp;          // [B][J][3L] qd | quald | pend
    const int64_t* seeds;       // [B] uint32 values
    const int32_t* count0;      // [B]
    int32_t B, J, L;
    int32_t n_k, m_max;
    int64_t max_transitions;
    uint32_t* pairs;            // scratch [B][S_MAX][L][8]
    uint8_t* elims;             // scratch [B][S_MAX][L]
    int32_t *result, *overflow, *count, *nhits, *hits, *npart, *part_n,
        *part_job, *part_pos, *part_refc, *rng, *mode, *steps;
};

namespace {

constexpr int kThreads = 128;
constexpr int M_DONE = 0, M_JOB = 1, M_ADV = 2, M_BR = 3, M_POP = 4,
              M_REP = 5, M_RETF = 6;
constexpr int S_MAX = 6, H_MAX = 8, MM_SLOTS = 8, P_MAX = 32;
constexpr int HIT_W = 8 + 2 * MM_SLOTS;
constexpr int32_t INF32 = 0x7FFFFFFF;

// JOB_FIELDS order of bowtie_tpu_torch/align/dfs_device.py
enum Field {
    F_VALID, F_QLEN, F_EBWT_FW, F_FW, F_D5, F_D3, F_UNREV, F_REV1, F_REV2,
    F_REV3, F_HAM0, F_REP_EXACTS, F_REP_PARTIALS, F_HH, F_MAX_BTS,
    F_CONS_QUALS, F_QUAL_THRESH, F_RESET_RNG, F_NS_GATE, F_NS_FTAB,
    F_MAQ_ROUND, F_NPREMUT, F_PREMUT_POS0, F_PREMUT_POS1, F_PREMUT_POS2,
    F_PREMUT_REFC0, F_PREMUT_REFC1, F_PREMUT_REFC2, F_COLLECT, NJF
};

// the 28 frame registers (REGS of dfs_device.py)
struct Frame {
    int32_t depth, unrev, rev1, rev2, rev3, ham, d;
    uint32_t top, bot;
    int32_t alt, elnum;
    uint32_t elsz;
    int32_t eli;
    uint32_t eltop, elbot;
    int32_t elham, elcint, elignore, lowq, btdm, mustbt, invhh, invex,
        reppart, dftab, bi, bj;
    uint32_t bspread;
};

struct Lane {
    int32_t mode, job, result;
    bool overflow, bailed;
    uint32_t rng, seed;
    int32_t count;
    const int8_t* qrow;          // current job's qqp row
    int32_t qlen, efw, fwflag, jd5, jd3, jrev2, jrev3, rep_exacts,
        rep_partials, hh, maxbts, cons_quals, qthresh, npremut;
    int32_t premut_pos[3], premut_refc[3];
    int32_t num_bts, sd;
    int32_t mms[S_MAX], refcs[S_MAX], mmd[S_MAX];
    uint32_t r_top, r_bot, r_r, r_k, r_row, r_jumps;
    int32_t r_sd, r_ham, r_stratum, r_resume, r_walk;
    int32_t nhits, npart;
    Frame c;
    Frame stk[S_MAX];
};

// per-thread view of the arguments
struct Ctx {
    const DfsArgs& a;
    int b;
    const int32_t* scal;     // this lane's [J][NJF]
    const int8_t* qqp;       // this lane's [J][3L]
    uint32_t* pairs;         // this lane's [S_MAX][L][8]
    uint8_t* elims;          // this lane's [S_MAX][L]
    int32_t* hits;           // this lane's [H_MAX][HIT_W]
};

__device__ __forceinline__ const BtFM& index_of(const Ctx& x,
                                                const Lane& s) {
    return s.efw ? x.a.fw : x.a.bw;
}

__device__ __forceinline__ uint32_t* pairs_at(const Ctx& x, int sd, int d) {
    return x.pairs + ((size_t)sd * x.a.L + d) * 8;
}

__device__ __forceinline__ uint8_t& elim_at(const Ctx& x, int sd, int d) {
    return x.elims[(size_t)sd * x.a.L + d];
}

// _ret_false (:678): end the job, or defer a pop
__device__ void ret_false(Lane& s) {
    if (s.sd == 0 || s.bailed) {
        s.mode = M_JOB;
        s.job += 1;
    } else {
        s.mode = M_RETF;
    }
}

// _init_regs (:703)
__device__ void init_regs(Lane& s, int32_t depth, int32_t unrev,
                          int32_t rev1, int32_t rev2, int32_t rev3,
                          int32_t ham, uint32_t top, uint32_t bot,
                          int32_t dftab) {
    Frame f = {};
    f.depth = depth; f.unrev = unrev; f.rev1 = rev1; f.rev2 = rev2;
    f.rev3 = rev3; f.ham = ham; f.d = depth; f.top = top; f.bot = bot;
    f.elham = ham; f.elignore = 1; f.lowq = 0xFF; f.dftab = dftab;
    s.c = f;
    const bool hh = s.hh > 0;
    const bool bail = hh && s.maxbts > 0 && s.num_bts == s.maxbts;
    if (hh && !bail) s.num_bts += 1;
    if (bail) {
        s.bailed = true;
        ret_false(s);
    } else {
        s.mode = M_ADV;
    }
}

// _store_partial (:781)
__device__ void store_partial(Lane& s, const Ctx& x, int32_t n) {
    if (s.npart >= P_MAX || n > 3) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    const size_t p = (size_t)x.b * P_MAX + s.npart;
    x.a.part_n[p] = n;
    x.a.part_job[p] = s.job;
    for (int k = 0; k < 3; ++k) {
        x.a.part_pos[p * 3 + k] = s.mms[k];
        x.a.part_refc[p * 3 + k] = s.refcs[k];
    }
    s.npart += 1;
}

// _report_fail (:768)
__device__ void report_fail(Lane& s) {
    if (s.r_resume == 0) {
        s.c.top = s.c.bot;
        s.mode = M_BR;
    } else if (s.r_resume == 1) {
        s.mode = M_POP;
    } else if (s.r_resume == 2) {
        ret_false(s);
    }
}

// _enter_report (:735)
__device__ void enter_report(Lane& s, const Ctx& x, int32_t sd_r,
                             uint32_t top, uint32_t bot, int32_t ham,
                             int32_t resume) {
    if (s.rep_partials > 0) {
        if (sd_r > 0) store_partial(s, x, sd_r);
        s.r_resume = resume;
        report_fail(s);
        return;
    }
    int32_t stratum = s.npremut;
    for (int i = 0; i < S_MAX; ++i)
        if (i < sd_r && s.mmd[i] < s.jrev3) stratum += 1;
    const uint32_t spread = bot - top;
    const uint32_t v = rng_next(s.rng);
    s.r_top = top; s.r_bot = bot; s.r_sd = sd_r; s.r_ham = ham;
    s.r_stratum = stratum; s.r_k = 0;
    s.r_r = top + v % (spread > 0 ? spread : 1u);
    s.r_resume = resume; s.r_walk = 0;
    s.mode = M_REP;
}

// _step_retf (:693)
__device__ void step_retf(Lane& s) {
    s.sd -= 1;
    s.c = s.stk[s.sd];
    s.mode = M_POP;
}

// _step_job (:922)
__device__ void step_job(Lane& s, const Ctx& x) {
    const int J = x.a.J, L = x.a.L;
    const int jidx = s.job < J - 1 ? s.job : J - 1;
    const int32_t* f = x.scal + (size_t)jidx * NJF;
    if (!(f[F_VALID] > 0 && s.job < J)) {
        s.mode = M_DONE;
        return;
    }
    s.qlen = f[F_QLEN]; s.efw = f[F_EBWT_FW]; s.fwflag = f[F_FW];
    s.jd5 = f[F_D5]; s.jd3 = f[F_D3]; s.jrev2 = f[F_REV2];
    s.jrev3 = f[F_REV3]; s.rep_exacts = f[F_REP_EXACTS];
    s.rep_partials = f[F_REP_PARTIALS]; s.hh = f[F_HH];
    s.maxbts = f[F_MAX_BTS]; s.cons_quals = f[F_CONS_QUALS];
    s.qthresh = f[F_QUAL_THRESH]; s.npremut = f[F_NPREMUT];
    for (int k = 0; k < 3; ++k) {
        s.premut_pos[k] = f[F_PREMUT_POS0 + k];
        s.premut_refc[k] = f[F_PREMUT_REFC0 + k];
    }
    if (f[F_RESET_RNG] > 0) s.rng = s.seed;
    s.num_bts = 0;
    s.bailed = false;
    s.sd = 0;
    s.qrow = x.qqp + (size_t)jidx * 3 * L;
    if (f[F_NS_GATE] > 0) {
        s.mode = M_JOB;
        s.job += 1;
        return;
    }
    const BtFM& fm = index_of(x, s);
    const int fc = fm.ftab_chars;
    const int32_t qlen = f[F_QLEN], unrev = f[F_UNREV];
    const int32_t ns_ftab = f[F_NS_FTAB], ham0 = f[F_HAM0];
    const int32_t rp = f[F_REP_PARTIALS];
    const bool use_ftab = ns_ftab == 0 && min(unrev, qlen) >= fc;
    uint32_t foff = 0;
    for (int k = 0; k < fc; ++k) {
        const int32_t q = s.qrow[k];
        foff |= (uint32_t)(q > 3 ? 0 : q) << (2 * k);
    }
    const uint32_t ft = __ldg(fm.ftab_hi + foff);
    const uint32_t fb = __ldg(fm.ftab_lo + foff + 1);
    const int32_t rev1 = f[F_REV1], rev2 = f[F_REV2], rev3 = f[F_REV3];
    if (use_ftab) {
        if (ft < fb && qlen == fc && rp == 0)
            enter_report(s, x, 0, ft, fb, ham0, 2);
        else if (ft < fb && qlen == fc)
            init_regs(s, 0, unrev, rev1, rev2, rev3, ham0, 0, 0, 0);
        else if (ft < fb && qlen > fc)
            init_regs(s, fc, unrev, rev1, rev2, rev3, ham0, ft, fb, 0);
        else if (!(ft < fb)) {
            s.mode = M_JOB;
            s.job += 1;
        }
    } else {
        init_regs(s, 0, unrev, rev1, rev2, rev3, ham0, 0, 0,
                  ns_ftab > 0 ? 1 : 0);
    }
}

// _branch_exit (:1025)
__device__ void branch_exit(Lane& s, const Ctx& x) {
    const Frame& c = s.c;
    if (c.mustbt || c.invhh || c.invex || (c.top == c.bot && c.alt == 0)) {
        ret_false(s);
        return;
    }
    if (!(c.d + 1 > s.qlen - 1)) {
        s.c.d = c.d + 1;
        s.mode = M_ADV;
        return;
    }
    if (s.sd >= s.rep_partials)
        enter_report(s, x, s.sd, c.top, c.bot, c.ham, 2);
    else
        ret_false(s);
}

// _step_adv (:1050)
__device__ void step_adv(Lane& s, const Ctx& x) {
    const int L = x.a.L;
    Frame& c = s.c;
    const int32_t d = c.d, sd = s.sd;
    const bool hh = s.hh > 0;
    int32_t hi_n = 0, lo_n = 0;
    for (int i = 0; i < S_MAX; ++i) {
        if (i >= sd) break;
        if (s.mmd[i] < s.jd5) hi_n += 1;
        else if (s.mmd[i] < s.jd3) lo_n += 1;
    }
    const bool req = s.jrev2 == s.jrev3;
    const bool fail5 = d == s.jd5 && (req ? sd == 0 : sd < 1);
    const bool fail3 = d == s.jd3 && (req ? sd < 2 : lo_n == 0);
    if (hh && (fail5 || fail3)) {
        ret_false(s);
        return;
    }
    const int dc = d < 0 ? 0 : (d > L - 1 ? L - 1 : d);
    const int32_t ch = s.qrow[dc], q = s.qrow[L + dc];
    const int32_t pen = s.qrow[2 * L + dc];
    const bool cq = s.cons_quals > 0;
    const int32_t ham = c.ham;
    const bool cur_is_alt = d >= c.unrev && (!cq || ham + pen <= s.qthresh);
    const bool cur_is_eligible = cur_is_alt && (cq ? q <= c.lowq : true);
    const bool cur_overrides = cur_is_alt && cq && q < c.lowq;

    const uint32_t pt = c.top, pb = c.bot;
    uint32_t top = pt, bot = pb;
    if (ch == 4 && d > 0) top = bot = 1;
    const bool zero_case = top == 0 && bot == 0;
    const BtFM& fm = index_of(x, s);
    uint32_t rt[4], rb[4];
    if (zero_case) {
        for (int j = 0; j < 4; ++j) {
            rt[j] = fm.fchr[j];
            rb[j] = fm.fchr[j + 1];
        }
    } else {
        lf4pair(fm, pt, pb, rt, rb);
    }
    if (zero_case || cur_is_alt) {
        uint4* p = reinterpret_cast<uint4*>(pairs_at(x, sd, d));
        p[0] = make_uint4(rt[0], rt[1], rt[2], rt[3]);
        p[1] = make_uint4(rb[0], rb[1], rb[2], rb[3]);
    }
    const int cK = ch < 0 ? 0 : (ch > 3 ? 3 : ch);
    const bool is_n = ch > 3;
    if (!is_n) {
        top = rt[cK];
        bot = rb[cK];
    }
    int32_t elim = is_n ? 0 : (1 << cK);
    int32_t nlive = 0, jstar = -1;
    uint32_t szlive = 0;
    for (int j = 0; j < 4; ++j) {
        const uint32_t sp = rb[j] - rt[j];
        if (cur_is_alt && j != ch && sp == 0) elim |= 1 << j;
        if (j != ch && sp != 0) {
            nlive += 1;
            szlive += sp;
            if (jstar < 0) jstar = j;
        }
    }
    if (jstar < 0) jstar = 0;
    elim_at(x, sd, d) = (uint8_t)elim;
    const int32_t alt = c.alt + (cur_is_alt ? nlive : 0);
    const bool el_upd = cur_is_alt && cur_is_eligible && nlive > 0;
    const bool ovr = el_upd && cur_overrides;
    int32_t elnum = ovr ? 0 : c.elnum;
    uint32_t elsz = ovr ? 0u : c.elsz;
    if (el_upd) {
        elnum += nlive;
        elsz += szlive;
    }
    if (ovr) {
        c.lowq = q; c.eli = d; c.eltop = rt[jstar]; c.elbot = rb[jstar];
        c.elham = pen; c.elcint = jstar; c.elignore = 0;
    }
    c.elnum = elnum; c.elsz = elsz; c.alt = alt;

    const bool cur0 = d == s.qlen - 1;
    const int32_t rp = s.rep_partials;
    const bool partial_c = cur0 && top != bot && rp > 0 && sd < rp;
    bool btdm = partial_c && alt > 0;
    const bool reported_partial = partial_c && sd > 0;
    if (reported_partial) store_partial(s, x, sd);
    const bool invex = cur0 && sd == 0 && bot != top && s.rep_exacts == 0;
    btdm = btdm || invex;
    const bool b5 = hh && d == s.jd5 - 1 && top != bot;
    bool invhh = b5 && sd == 0;
    bool mustbt = b5 && sd == 0 && alt > 0;
    btdm = btdm || mustbt;
    const bool die5 = b5 && sd == 0 && alt == 0;
    const bool b3 = hh && d == s.jd3 - 1 && top != bot;
    const bool inv3 = lo_n == 0 || hi_n == 0;
    invhh = invhh || (b3 && inv3);
    const bool mb3 = b3 && (sd < 2 || inv3) && alt > 0;
    mustbt = mustbt || mb3;
    btdm = btdm || mb3;
    const bool die3 = b3 && sd < 2 && alt == 0;
    if (die5 || die3) {
        ret_false(s);
        return;
    }
    c.top = top; c.bot = bot; c.btdm = btdm; c.mustbt = mustbt;
    c.invhh = invhh; c.invex = invex; c.reppart = reported_partial;
    if (cur0 && bot != top && !invhh && !invex && !reported_partial) {
        enter_report(s, x, sd, top, bot, ham, 0);
        return;
    }
    if ((top == bot || btdm) && alt > 0) {
        s.mode = M_BR;
        return;
    }
    branch_exit(s, x);
}

// _step_br (:1206)
__device__ void step_br(Lane& s, const Ctx& x) {
    const int L = x.a.L;
    Frame& c = s.c;
    if (!((c.top == c.bot || c.btdm) && c.alt > 0)) {
        branch_exit(s, x);
        return;
    }
    const int32_t sd = s.sd;
    const bool cq = s.cons_quals > 0;
    const bool scan = c.elnum > 1 || c.elignore;
    int32_t istar_s = -1;
    const int hi = c.d < L - 1 ? c.d : L - 1;
    for (int i = hi; i >= 0 && i >= c.depth; --i) {
        if (elim_at(x, sd, i) != 15
                && (!cq || (int32_t)s.qrow[L + i] == c.lowq)) {
            istar_s = i;
            break;
        }
    }
    const int32_t ist = istar_s < 0 ? 0 : istar_s;
    const uint32_t* p8 = pairs_at(x, sd, ist);
    const int32_t er_i = elim_at(x, sd, ist);
    uint32_t msp[4], pos_sz = 0;
    for (int j = 0; j < 4; ++j) {
        msp[j] = ((er_i >> j) & 1) == 0 ? p8[4 + j] - p8[j] : 0u;
        pos_sz += msp[j];
    }
    if (scan && (istar_s < 0 || pos_sz == 0)) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    int32_t istar, jstar, btham;
    uint32_t bttop, btbot;
    if (scan) {
        const uint32_t r = rng_next(s.rng) % (pos_sz > 0 ? pos_sz : 1u);
        int32_t js = -1;
        uint32_t cum = 0;
        for (int j = 0; j < 4; ++j) {
            const bool nonelim = ((er_i >> j) & 1) == 0;
            if (js < 0 && nonelim && cum <= r && r < cum + msp[j]) js = j;
            cum += msp[j];
        }
        istar = ist;
        jstar = js < 0 ? 0 : js;
        bttop = p8[jstar];
        btbot = p8[4 + jstar];
        btham = c.ham + s.qrow[2 * L + ist];
    } else {
        istar = c.eli;
        jstar = c.elcint;
        bttop = c.eltop;
        btbot = c.elbot;
        btham = c.ham + c.elham;
    }
    const bool lt1 = istar < c.rev1;
    const bool lt2 = !lt1 && istar < c.rev2;
    const bool lt3 = !lt1 && !lt2 && istar < c.rev3;
    const int32_t bt_unrev = lt1 ? c.rev1 : c.unrev;
    const int32_t bt_rev1 = (lt1 || lt2) ? c.rev2 : c.rev1;
    const int32_t bt_rev2 = (lt1 || lt2 || lt3) ? c.rev3 : c.rev2;
    s.mms[sd] = s.qlen - 1 - istar;
    s.refcs[sd] = jstar;
    s.mmd[sd] = istar;
    c.bi = istar;
    c.bj = jstar;
    c.bspread = btbot - bttop;
    if (istar + 1 == s.qlen) {
        enter_report(s, x, sd + 1, bttop, btbot, btham, 1);
        return;
    }
    const BtFM& fm = index_of(x, s);
    const int fc = fm.ftab_chars;
    const bool midftab = s.hh > 0 && c.dftab == 0 && s.jrev2 == s.jrev3
        && istar + 1 < fc && fc <= s.jd5;
    uint32_t ft = 0, fb = 0;
    if (midftab) {
        uint32_t foff = 0;
        for (int k = 0; k < fc; ++k) {
            const int32_t q = k == istar ? jstar : s.qrow[k];
            foff |= (uint32_t)(q > 3 ? 0 : q) << (2 * k);
        }
        ft = __ldg(fm.ftab_hi + foff);
        fb = __ldg(fm.ftab_lo + foff + 1);
        if (ft == fb) {
            s.mode = M_POP;
            return;
        }
    }
    if (sd + 1 >= S_MAX) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    const int32_t rev3 = c.rev3;
    s.stk[sd] = c;
    s.sd = sd + 1;
    init_regs(s, midftab ? fc : istar + 1, bt_unrev, bt_rev1, bt_rev2, rev3,
              btham, midftab ? ft : bttop, midftab ? fb : btbot, 0);
}

// the eligibility rescan of _step_pop (:1379 do_rescan)
__device__ void rescan(Lane& s, const Ctx& x) {
    const int L = x.a.L;
    Frame& c = s.c;
    const int lo = max(c.depth, c.unrev);
    const int hi = min(c.d, L - 1);
    int32_t low = 0x7FFF, kstar = -1, n_el = 0;
    uint32_t s_el = 0;
    for (int k = hi; k >= lo && k >= 0; --k) {
        const int32_t pend = s.qrow[2 * L + k], qk = s.qrow[L + k];
        if (!(c.ham + pend <= s.qthresh)) continue;
        const uint32_t* p = pairs_at(x, s.sd, k);
        const int32_t er = elim_at(x, s.sd, k);
        int32_t nlive = 0;
        uint32_t szs = 0;
        for (int j = 0; j < 4; ++j) {
            const uint32_t sp = p[4 + j] - p[j];
            if (((er >> j) & 1) == 0 && sp != 0) {
                nlive += 1;
                szs += sp;
            }
        }
        if (nlive == 0) continue;
        if (qk < low) {
            low = qk; kstar = k; n_el = nlive; s_el = szs;
        } else if (qk == low) {
            n_el += nlive; s_el += szs;
        }
    }
    if (kstar >= 0) {
        const uint32_t* p = pairs_at(x, s.sd, kstar);
        const int32_t er = elim_at(x, s.sd, kstar);
        int32_t lstar = 0;
        for (int j = 3; j >= 0; --j)
            if (((er >> j) & 1) == 0 && p[4 + j] != p[j]) lstar = j;
        c.lowq = low; c.eli = kstar; c.eltop = p[lstar];
        c.elbot = p[4 + lstar]; c.elham = s.qrow[2 * L + kstar];
        c.elcint = lstar; c.elignore = 0; c.elnum = n_el; c.elsz = s_el;
    } else {
        c.lowq = 0xFF; c.elnum = 0; c.elsz = 0;
    }
}

// _step_pop (:1346)
__device__ void step_pop(Lane& s, const Ctx& x) {
    Frame& c = s.c;
    const bool bts_hit = s.hh > 0 && s.maxbts > 0 && s.num_bts >= s.maxbts;
    if (s.bailed || bts_hit) {
        s.bailed = true;
        ret_false(s);
        return;
    }
    elim_at(x, s.sd, c.bi) |= (uint8_t)(1 << c.bj);
    c.elsz -= c.bspread;
    c.elnum -= 1;
    c.elignore = 1;
    c.alt -= 1;
    if (c.alt == 0) {
        ret_false(s);
        return;
    }
    if (c.elnum == 0 && s.cons_quals > 0) rescan(s, x);
    s.mode = M_BR;
}

// _step_rep (:803)
__device__ void step_rep(Lane& s, const Ctx& x) {
    const DfsArgs& a = x.a;
    const BtFM& fm = index_of(x, s);
    const uint32_t spread = s.r_bot - s.r_top;
    uint32_t ri = s.r_r + s.r_k;
    if (s.r_bot <= ri) ri -= spread;
    uint32_t off;
    if (a.dense) {
        off = __ldg(fm.sa + ri);
    } else {
        // walk left to a marked row, one LF per transition
        // (reportChaseOne, ebwt.h:2727-2746)
        const uint32_t row = s.r_walk == 0 ? ri : s.r_row;
        const uint32_t jumps = s.r_walk == 0 ? 0u : s.r_jumps;
        const bool at_z = row == fm.zoff;
        const uint32_t omask = (1u << fm.off_rate) - 1u;
        if (!((row & omask) == 0 || at_z)) {
            s.r_row = lf_row(fm, row);
            s.r_jumps = jumps + 1;
            s.r_walk = 1;
            return;
        }
        s.r_row = row;
        s.r_jumps = jumps;
        s.r_walk = 0;
        off = at_z ? jumps : __ldg(fm.offs + (row >> fm.off_rate)) + jumps;
    }
    // joinedToTextOff (ebwt.h:2569-2629)
    int lo = 0, hi = a.nfrag;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)a.rstarts[3 * mid] <= off) lo = mid + 1;
        else hi = mid;
    }
    // lo - 1 < 0 cannot happen (fragment 0 starts at 0); wrap as torch does
    const int elt = a.nfrag == 1 ? 0 : (lo > 0 ? lo - 1 : a.nfrag - 1);
    const uint32_t start = (uint32_t)a.rstarts[3 * elt];
    const uint32_t upper = elt + 1 < a.nfrag
        ? (uint32_t)a.rstarts[3 * (elt + 1)] : a.length;
    const int32_t qlen = s.qlen;
    const bool valid = off + (uint32_t)qlen <= upper;
    uint32_t fragoff = off - start;
    if (s.efw == 0) fragoff = (upper - start) - fragoff - 1 - (qlen - 1);
    const uint32_t toff = fragoff + (uint32_t)a.rstarts[3 * elt + 2];

    const int32_t newcount = s.count + 1;
    const bool maxed = valid && newcount > a.m_max;
    const bool stored = valid && !maxed;
    const int32_t nmms = s.r_sd + s.npremut;
    const bool over = stored && (s.nhits >= H_MAX || nmms > MM_SLOTS);
    if (over) {
        s.overflow = true;
        s.mode = M_DONE;
    }
    const bool do_store = stored && !over;
    if (do_store) {
        int32_t* h = x.hits + (size_t)s.nhits * HIT_W;
        h[0] = (int32_t)a.rstarts[3 * elt + 1];
        h[1] = (int32_t)toff;
        h[2] = s.fwflag | (s.efw << 1);
        h[3] = (int32_t)(s.r_bot - s.r_top - 1);
        h[4] = s.r_stratum;
        h[5] = s.r_ham | (s.r_stratum << 14);
        h[6] = nmms;
        h[7] = qlen;
        for (int k = 0; k < MM_SLOTS; ++k) {
            int32_t mv, rv;
            if (k < s.r_sd) {
                mv = k < S_MAX ? s.mms[k] : 0;
                rv = k < S_MAX ? s.refcs[k] : 0;
            } else {
                const int pi = min(max(k - s.r_sd, 0), 2);
                mv = s.premut_pos[pi];
                rv = s.premut_refc[pi];
            }
            h[8 + k] = mv;
            h[8 + MM_SLOTS + k] = rv;
        }
        s.nhits += 1;
    }
    if (valid) s.count = newcount;
    if (maxed) {
        s.result = 2;
        s.mode = M_DONE;
    }
    const bool stop = do_store && newcount == a.n_k
        && (a.m_max == INF32 || a.m_max < a.n_k);
    if (stop) {
        s.result = 1;
        s.mode = M_DONE;
    }
    if (!maxed && !stop && !over) {
        s.r_k += 1;
        if ((int32_t)s.r_k >= (int32_t)spread) report_fail(s);
    }
}

__global__ void __launch_bounds__(kThreads)
dfs_machine_kernel(const DfsArgs a) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const Ctx x{a, b, a.scal + (size_t)b * a.J * NJF,
                a.qqp + (size_t)b * a.J * 3 * a.L,
                a.pairs + (size_t)b * S_MAX * a.L * 8,
                a.elims + (size_t)b * S_MAX * a.L,
                a.hits + (size_t)b * H_MAX * HIT_W};
    // prologue (_init_state, :536): zeroed outputs, the lane at JOB 0
    for (int k = 0; k < H_MAX * HIT_W; ++k) x.hits[k] = 0;
    for (int k = 0; k < P_MAX; ++k) {
        const size_t p = (size_t)b * P_MAX + k;
        a.part_n[p] = 0;
        a.part_job[p] = 0;
        for (int j = 0; j < 3; ++j) {
            a.part_pos[3 * p + j] = 0;
            a.part_refc[3 * p + j] = 0;
        }
    }
    Lane s = {};
    s.mode = M_JOB;
    s.seed = s.rng = (uint32_t)a.seeds[b];
    s.count = a.count0[b];
    s.qrow = x.qqp;
    int64_t t = 0;
    for (; s.mode != M_DONE && t < a.max_transitions; ++t) {
        switch (s.mode) {
            case M_RETF: step_retf(s); break;
            case M_JOB: step_job(s, x); break;
            case M_ADV: step_adv(s, x); break;
            case M_POP: step_pop(s, x); break;
            case M_REP: step_rep(s, x); break;
            case M_BR: step_br(s, x); break;
            default: s.mode = M_DONE; s.overflow = true; break;
        }
    }
    a.result[b] = s.result;
    a.overflow[b] = (s.overflow || s.mode != M_DONE) ? 1 : 0;
    a.count[b] = s.count;
    a.nhits[b] = s.nhits;
    a.npart[b] = s.npart;
    a.rng[b] = (int32_t)s.rng;
    a.mode[b] = s.mode;
    a.steps[b] = (int32_t)t;
}

// K6: one thread per (lane, job) row; derive_rows_plain's arithmetic.
__global__ void __launch_bounds__(kThreads)
derive_rows_kernel(const int32_t* __restrict__ scal,
                   const int8_t* __restrict__ codes,
                   const int8_t* __restrict__ qual,
                   const int32_t* __restrict__ plen, int B, int J, int L,
                   int fc, int32_t* __restrict__ out,
                   int8_t* __restrict__ qqp) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B * J) return;
    const int b = r / J;
    const int32_t* f = scal + (size_t)r * NJF;
    int32_t* o = out + (size_t)r * NJF;
    for (int k = 0; k < NJF; ++k) o[k] = f[k];
    const int32_t qs = f[F_QLEN], pl = plen[b];
    const bool rev = f[F_FW] == f[F_EBWT_FW], comp = f[F_FW] == 0;
    const int8_t* cb = codes + (size_t)b * L;
    const int8_t* qb = qual + (size_t)b * L;
    int8_t* row = qqp + (size_t)r * 3 * L;
    int32_t nsc = 0, p1 = -1, p2 = -1, p3 = -1, ns_ftab = 0;
    for (int i = 0; i < L; ++i) {
        int32_t code = 4, qv = 0;
        if (i < qs) {
            int32_t t = (rev ? qs - 1 - i : pl - qs + i) % L;
            if (t < 0) t += L;
            code = cb[t];
            qv = qb[t];
            if (comp && code < 4) code = 3 - code;
        }
        for (int k = 0; k < 3; ++k)
            if (f[F_NPREMUT] > k && i == qs - 1 - f[F_PREMUT_POS0 + k])
                code = f[F_PREMUT_REFC0 + k];
        int32_t pen = qv;
        if (f[F_MAQ_ROUND] > 0) pen = min(30, ((qv + 5) / 10) * 10);
        if (code == 4 && i < qs && i < f[F_REV3]) {
            nsc += 1;
            if (nsc == 1) p1 = i;
            if (nsc == 2) p2 = i;
            if (nsc == 3) p3 = i;
        }
        if (i < fc && code == 4 && i < qs) ns_ftab += 1;
        row[i] = (int8_t)code;
        row[L + i] = (int8_t)min(max(qv, 0), 127);
        row[2 * L + i] = (int8_t)min(max(pen, 0), 127);
    }
    o[F_NS_GATE] = ((p1 >= 0 && p1 < f[F_UNREV]) || (p2 >= 0 && p2 < f[F_REV1])
                    || (p3 >= 0 && p3 < f[F_REV2]) || nsc > 3) ? 1 : 0;
    o[F_NS_FTAB] = ns_ftab;
}

// K8: pack_hits_plain's function in one launch.  A block takes the next
// tile of kPackLanes lanes from the counter, writes each lane's nh_eff (0
// under overflow), scans nh_eff and npart over the tile and takes the
// tile's two row offsets by look-back (warps 0 and 1, lookback.cuh).
// Then each thread copies whole rows: a hit row is HIT_W / 4 int4 loads
// and stores (the lane's rows are contiguous in and out), a partial row
// is fused from part_n, part_job, part_pos[3] and part_refc[3] into two
// int4 stores; a row finds its lane by a binary search of the tile's
// row ends.  The last tile writes the two totals.  `scratch` holds the
// tile counter, a count of finished blocks, the totals and two look-back
// words per tile; the last block to finish zeroes the counters and words,
// so the next call finds them zero without a memset.
// What bounds it: chip_smoke.py k8_bytes, each counted row read and
// written once and the per-lane counts, a few MB (0.00123 ms for phase
// dfs's 16,384 lanes).  Its time is launch and host-sync latency, so it
// is one launch, and its wrapper makes one copy of the totals and one
// sync.
constexpr int kPackLanes = 128;                // lanes a tile, one thread each
constexpr int kPackHead = 4;                   // scratch words before the
                                               // look-back words
static_assert(HIT_W % 4 == 0, "hit rows are whole int4s");

// The lane of the tile that owns `row`: the first whose row end passes it.
__device__ __forceinline__ int row_owner(const uint32_t* end, uint32_t row) {
    int lo = 0, hi = kPackLanes - 1;
    while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (end[mid] > row) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

__global__ void __launch_bounds__(kPackLanes)
dfs_pack_kernel(const int32_t* __restrict__ hits,
                const int32_t* __restrict__ nhits,
                const uint8_t* __restrict__ overflow,
                const int32_t* __restrict__ npart,
                const int32_t* __restrict__ part_n,
                const int32_t* __restrict__ part_job,
                const int32_t* __restrict__ part_pos,
                const int32_t* __restrict__ part_refc, int B,
                int32_t* __restrict__ nh_eff, int32_t* __restrict__ hout,
                int32_t* __restrict__ pout, unsigned long long* scratch) {
    __shared__ uint32_t hend[kPackLanes], pend[kPackLanes];  // row ends
    __shared__ uint32_t warp_sums[kPackLanes / 32];
    __shared__ unsigned long long base[2];
    __shared__ int s_tile, s_last;
    const int tile = lb::take_tile(scratch, &s_tile);
    const int tiles = (B + kPackLanes - 1) / kPackLanes;
    uint64_t* status = reinterpret_cast<uint64_t*>(scratch + kPackHead);
    const long long b0 = (long long)tile * kPackLanes;
    const long long b = b0 + threadIdx.x;
    uint32_t nh = 0, np = 0;
    if (b < B) {
        nh = overflow[b] ? 0u : (uint32_t)nhits[b];
        np = (uint32_t)npart[b];
        nh_eff[b] = (int32_t)nh;
    }
    uint32_t th, tp;
    hend[threadIdx.x] =
        lb::block_exclusive_scan<kPackLanes>(nh, warp_sums, th) + nh;
    pend[threadIdx.x] =
        lb::block_exclusive_scan<kPackLanes>(np, warp_sums, tp) + np;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp < 2) {            // warp 0: the hit rows, warp 1: the partials
        const uint64_t total = warp ? tp : th;
        uint64_t* word = status + 2 * (size_t)tile + warp;
        if (lane == 0) lb::publish(word, 1, tile == 0, total);
        const uint64_t prior =
            tile > 0 ? lb::warp_look_back(status + warp, 2, tile, 1) : 0;
        if (lane == 0) {
            if (tile > 0) lb::publish(word, 1, true, prior + total);
            base[warp] = prior;
            if (tile == tiles - 1) scratch[2 + warp] = prior + total;
        }
    }
    __syncthreads();
    for (uint32_t row = threadIdx.x; row < th; row += kPackLanes) {
        const int i = row_owner(hend, row);
        const uint32_t s = row - (i ? hend[i - 1] : 0u);
        const int4* src = reinterpret_cast<const int4*>(
            hits + ((b0 + i) * H_MAX + s) * HIT_W);
        int4* dst = reinterpret_cast<int4*>(hout + (base[0] + row) * HIT_W);
        int4 v[HIT_W / 4];
        for (int q = 0; q < HIT_W / 4; ++q) v[q] = src[q];
        for (int q = 0; q < HIT_W / 4; ++q) dst[q] = v[q];
    }
    for (uint32_t row = threadIdx.x; row < tp; row += kPackLanes) {
        const int i = row_owner(pend, row);
        const size_t p = (size_t)(b0 + i) * P_MAX
            + (row - (i ? pend[i - 1] : 0u));
        int4* dst = reinterpret_cast<int4*>(pout + (base[1] + row) * 8);
        dst[0] = make_int4(part_n[p], part_job[p], part_pos[3 * p],
                           part_pos[3 * p + 1]);
        dst[1] = make_int4(part_pos[3 * p + 2], part_refc[3 * p],
                           part_refc[3 * p + 1], part_refc[3 * p + 2]);
    }
    // every block's look-back is over once all have counted themselves
    // finished: the last leaves the scratch zeroed for the next call
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        s_last = atomicAdd(scratch + 1, 1ull) == (unsigned long long)tiles - 1;
    }
    __syncthreads();
    if (s_last) {
        for (int i = threadIdx.x; i < 2 * tiles; i += kPackLanes)
            status[i] = 0;
        if (threadIdx.x == 0) scratch[0] = scratch[1] = 0;
    }
}

// K9: launch B's job table (-n mode) from launch A's outputs, one thread
// per lane; derive_b_jobs_plain's arithmetic (bowtie_tpu_torch/align/
// n_device.py).  The thread zeroes its lane's J rows, then writes one
// extension job per partial of the rc block (slots whose job is jrc) and
// the rc half-and-half job, then the same for the fw block, in slot
// order.  It reads the lane's counted partial rows and writes the whole
// [J][NJF] table, so it is bound by the bytes of the table it writes.
__device__ __forceinline__ void b_common(int32_t* o, int32_t plen,
                                         bool is_rc, int32_t maxbts,
                                         int32_t qt, int32_t maq) {
    o[F_VALID] = 1;
    o[F_QLEN] = plen;
    o[F_FW] = is_rc ? 0 : 1;
    o[F_EBWT_FW] = is_rc ? 1 : 0;
    o[F_REP_EXACTS] = 1;
    o[F_MAX_BTS] = maxbts;
    o[F_CONS_QUALS] = 1;
    o[F_QUAL_THRESH] = qt;
    o[F_MAQ_ROUND] = maq;
}

__global__ void __launch_bounds__(kThreads)
derive_b_jobs_kernel(const int32_t* __restrict__ result,
                     const uint8_t* __restrict__ overflow,
                     const int32_t* __restrict__ mode,
                     const int32_t* __restrict__ npart,
                     const int32_t* __restrict__ part_job,
                     const int32_t* __restrict__ part_n,
                     const int32_t* __restrict__ part_pos,
                     const int32_t* __restrict__ part_refc,
                     const uint8_t* __restrict__ gated,
                     const int8_t* __restrict__ qual,
                     const int32_t* __restrict__ plen_a,
                     const int32_t* __restrict__ qual_rounds, int B, int L,
                     int J, int jrc, int n, int s, int qt, int maxbts,
                     int maq, int norc, int nofw, int32_t* __restrict__ out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int32_t* lane = out + (size_t)b * J * NJF;
    for (int k = 0; k < J * NJF; ++k) lane[k] = 0;
    const bool active = result[b] == 0 && !overflow[b] && mode[b] == M_DONE
        && !gated[b] && n > 0;
    if (!active) return;
    const int32_t plen = plen_a[b];
    const int32_t qs = min(plen, s);
    const int np = min(npart[b], P_MAX);
    const int32_t* pj = part_job + (size_t)b * P_MAX;
    int nrc = 0;
    for (int t = 0; t < np; ++t) nrc += pj[t] == jrc;
    const int nfw = np - nrc;
    const bool hh_rc = n >= 2 && !norc, hh_fw = n >= 2 && !nofw;
    const int fw_base = nrc + (hh_rc ? 1 : 0);
    const int8_t* q = qual + (size_t)b * L;
    // the extension jobs, rc block then fw block, each in slot order
    for (int blk = 0; blk < 2; ++blk) {
        const bool is_rc = blk == 0;
        if (is_rc ? norc : nofw) continue;
        int j = is_rc ? 0 : fw_base;
        const int j0 = j;
        for (int t = 0; t < np; ++t) {
            if ((pj[t] == jrc) != is_rc) continue;
            if (j < J) {
                int32_t* o = lane + (size_t)j * NJF;
                const size_t p = (size_t)b * P_MAX + t;
                const int32_t pn = part_n[p];
                b_common(o, plen, is_rc, maxbts, qt, maq);
                o[F_UNREV] = o[F_REV1] = o[F_REV2] = o[F_REV3] = qs;
                int32_t ham0 = 0;
                for (int k = 0; k < 3 && k < pn; ++k) {
                    const int32_t pos = part_pos[3 * p + k];
                    const int32_t c = min(max(pos, 0), L + 3);
                    const int32_t mq = c < L ? q[c] : 0;
                    ham0 += maq ? qual_rounds[min(max(mq, 0), 255)] : mq;
                    o[F_PREMUT_POS0 + k] = plen - 1 - pos;
                    o[F_PREMUT_REFC0 + k] = part_refc[3 * p + k];
                }
                o[F_HAM0] = ham0;
                o[F_RESET_RNG] = j == j0 ? 1 : 0;
                o[F_NPREMUT] = pn;
            }
            ++j;
        }
    }
    // the half-and-half jobs (search_seeded_phase3.c:29-92 setOffs)
    const int32_t q5 = (qs >> 1) + (qs & 1);
    for (int blk = 0; blk < 2; ++blk) {
        const bool is_rc = blk == 0;
        if (!(is_rc ? hh_rc : hh_fw)) continue;
        const int j = is_rc ? nrc : fw_base + nfw;
        if (j >= J) continue;
        int32_t* o = lane + (size_t)j * NJF;
        b_common(o, plen, is_rc, maxbts, qt, maq);
        o[F_D5] = q5;
        o[F_D3] = qs;
        o[F_UNREV] = 0;
        o[F_REV1] = n <= 2 ? q5 : 0;
        o[F_REV2] = n < 3 ? qs : q5;
        o[F_REV3] = qs;
        o[F_HH] = 1;
        o[F_RESET_RNG] = 1;
    }
}

inline dim3 grid_for(long n) { return dim3((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int bt_dfs_machine(const DfsArgs* a, void* stream) {
    dfs_machine_kernel<<<grid_for(a->B), kThreads, 0,
                         (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

int bt_derive_rows(const void* scal, const void* codes, const void* qual,
                   const void* plen, int B, int J, int L, int fc, void* out,
                   void* qqp, void* stream) {
    derive_rows_kernel<<<grid_for((long)B * J), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)scal, (const int8_t*)codes, (const int8_t*)qual,
        (const int32_t*)plen, B, J, L, fc, (int32_t*)out, (int8_t*)qqp);
    return (int)cudaGetLastError();
}

// Scratch words K8 needs for B lanes; the wrapper allocates them zeroed
// once and every call leaves them zeroed.
int bt_dfs_pack_scratch_words(int B) {
    return kPackHead + 2 * ((B + kPackLanes - 1) / kPackLanes);
}

int bt_dfs_pack(const void* hits, const void* nhits, const void* overflow,
                const void* npart, const void* part_n, const void* part_job,
                const void* part_pos, const void* part_refc, int B,
                void* nh_eff, void* hout, void* pout, void* scratch,
                void* stream) {
    dfs_pack_kernel<<<(B + kPackLanes - 1) / kPackLanes, kPackLanes, 0,
                      (cudaStream_t)stream>>>(
        (const int32_t*)hits, (const int32_t*)nhits,
        (const uint8_t*)overflow, (const int32_t*)npart,
        (const int32_t*)part_n, (const int32_t*)part_job,
        (const int32_t*)part_pos, (const int32_t*)part_refc, B,
        (int32_t*)nh_eff, (int32_t*)hout, (int32_t*)pout,
        (unsigned long long*)scratch);
    return (int)cudaGetLastError();
}

int bt_derive_b_jobs(const void* result, const void* overflow,
                     const void* mode, const void* npart,
                     const void* part_job, const void* part_n,
                     const void* part_pos, const void* part_refc,
                     const void* gated, const void* qual, const void* plen,
                     const void* qual_rounds, int B, int L, int J, int jrc,
                     int n, int s, int qt, int maxbts, int maq, int norc,
                     int nofw, void* out, void* stream) {
    derive_b_jobs_kernel<<<grid_for(B), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)result, (const uint8_t*)overflow,
        (const int32_t*)mode, (const int32_t*)npart,
        (const int32_t*)part_job, (const int32_t*)part_n,
        (const int32_t*)part_pos, (const int32_t*)part_refc,
        (const uint8_t*)gated, (const int8_t*)qual, (const int32_t*)plen,
        (const int32_t*)qual_rounds, B, L, J, jrc, n, s, qt, maxbts, maq,
        norc, nofw, (int32_t*)out);
    return (int)cudaGetLastError();
}

int bt_dfs_njf() { return NJF; }

}  // extern "C"
