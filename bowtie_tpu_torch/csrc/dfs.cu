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
// K7 runs one thread per lane, one warp a block (8,192 lanes make 256
// blocks on the card's 132 SMs).  The JAX version advances every lane one
// group of sub-steps per lockstep iteration (RETF, JOB, ADV x3, POP, REP,
// BR); here each thread applies its lane's transitions one after another
// until M_DONE, a pass of its loop applying them in the order RETF, JOB,
// POP, BR, ADV (up to twice), REP (up to four times) while the lane's
// mode is the next in that order.  A lane's transitions depend only on
// its own state, so the per-lane result is the same.  Each function below
// is the scalar form of the JAX sub-step of the same name, masked writes
// and all (a lane whose partial store overflows keeps running that
// sub-step, as there).  Step budget: an iteration applies at most 8
// transitions to a lane, so a lane gets max_transitions = 8 * max_steps;
// whatever the lockstep version finishes within budget, this finishes
// too.  Each transition is counted, so a lane stops at the same one.
//
// Where a lane lives: its scalars and current frame (26 registers: REGS
// less elsz and bspread, which no transition reads) in registers, its
// parents' frames in shared memory; each level's [L][8] pairs rows in a
// per-lane global scratch that no transition reads before writing it.  A
// frame reads only positions >= its own depth, which it wrote, so this
// equals the JAX copy-the-frame push.  Up to L = 64 (the on-chip layout)
// each level's elims, a 64-bit mask of its positions whose elims are not
// 15 and the job's by-depth row live in shared memory too: BR's search is
// a find-highest-bit and POP's rescan reads shared memory and one pairs
// row; beyond, they stay in global memory (the global layout).
//
// What bounds K7 (PERF.md, findings): a launch lasts as long as its
// slowest warp, and a warp about as long as its slowest lane's chain of
// transitions, each one dependent round trip to L2 (an ADV's two ranks,
// a BR's pairs row, a REP's SA value or walk step) plus a few hundred
// dependent instructions; a warp runs each mode's body once for all of
// its lanes in that mode, one mode after another.  Not bandwidth, not
// arithmetic.  The pass order lets a lane take a RETF, POP, BR, ADV
// chain in one pass, so a warp runs fewer bodies a transition; the lane
// state kept out of local memory and the scans kept on chip shorten each
// transition.  K6 is an elementwise copy, bound by bytes; K8 moves a few
// MB and is bound by launch and host-sync latency (its note below).
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
    uint8_t* elims;             // scratch [B][S_MAX][L] (global layout only)
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

// K7's launch shape (dfs_device.machine_shape mirrors it): one warp a
// block, so that 8,192 lanes make 256 blocks over the 132 SMs; the
// on-chip layout up to kOnchipL positions, the global one beyond.
constexpr int kMachineThreads = 32;
constexpr int kOnchipL = 64;
constexpr int kRepAhead = 4;        // dense SA rows a REP loads at once
// a loop pass applies up to this many ADVs, then REPs, in a row (fewer
// or more were slower on the -v, -n or walk-left cases: PERF.md)
constexpr int kAdvPerPass = 2;
constexpr int kRepPerPass = 4;

// the frame registers a parent keeps (REGS of dfs_device.py less elsz
// and bspread, which only ever feed each other: no transition reads
// them)
#define BT_FRAME_FIELDS(X)                                                  \
    X(int32_t, depth) X(int32_t, unrev) X(int32_t, rev1) X(int32_t, rev2)  \
    X(int32_t, rev3) X(int32_t, ham) X(int32_t, d) X(uint32_t, top)        \
    X(uint32_t, bot) X(int32_t, alt) X(int32_t, elnum) X(int32_t, eli)     \
    X(uint32_t, eltop) X(uint32_t, elbot) X(int32_t, elham)                \
    X(int32_t, elcint) X(int32_t, elignore) X(int32_t, lowq)               \
    X(int32_t, btdm) X(int32_t, mustbt) X(int32_t, invhh) X(int32_t, invex) \
    X(int32_t, reppart) X(int32_t, dftab) X(int32_t, bi) X(int32_t, bj)

struct Frame {
#define BT_DECL(t, n) t n;
    BT_FRAME_FIELDS(BT_DECL)
#undef BT_DECL
};
#define BT_COUNT(t, n) +1
constexpr int kFrameWords = 0 BT_FRAME_FIELDS(BT_COUNT);
#undef BT_COUNT

// A lane's shared memory, in 32-bit words interleaved by lane (word w of
// thread t at w * kMachineThreads + t, so that a warp touching the same
// word of its 32 lanes hits 32 banks): the parents' frames and eight words
// to pick a code's entry from (pick_of); in the on-chip layout also each
// level's mask of positions whose elims are not 15, the current job's
// by-depth row, and each level's elims bytes (low nibble; the high nibble
// marks the codes whose range is empty, written with the pairs row).
constexpr int kStkWords = (S_MAX - 1) * kFrameWords;
constexpr int kPickW = kStkWords;
constexpr int kPickWords = 8;
constexpr int kMaskW = kPickW + kPickWords;
constexpr int kMaskWords = 2 * S_MAX;

__host__ __device__ constexpr int lane_words(int L, bool onchip) {
    return onchip ? kMaskW + kMaskWords + (3 * L + 3) / 4
                        + (S_MAX * L + 3) / 4
                  : kMaskW;
}

struct Lane {
    int32_t mode, job, result;
    bool overflow, bailed;
    uint32_t rng, seed;
    int32_t count;
    const int8_t* qrow;          // current job's qqp row (global)
    int32_t qlen, efw, fwflag, jd5, jd3, jrev2, jrev3, rep_exacts,
        rep_partials, hh, maxbts, cons_quals, qthresh, npremut;
    int32_t premut_pos[3], premut_refc[3];
    int32_t num_bts, sd;
    // by level, read with constant indices and written with
    // set_at, so that they stay in registers
    int32_t mms[S_MAX], refcs[S_MAX], mmd[S_MAX];
    uint32_t r_top, r_bot, r_r, r_k, r_row, r_jumps;
    int32_t r_sd, r_ham, r_stratum, r_resume, r_walk;
    uint32_t ra_k;               // first row of the loaded SA values
    int32_t ra_n;                // how many are loaded (0: none), in the
                                 // pick words (no other transition of
                                 // the lane runs between a report's REPs)
    int32_t nhits, npart;
    Frame c;
};

__device__ __forceinline__ void set_at(int32_t (&a)[S_MAX], int i,
                                       int32_t v) {
#pragma unroll
    for (int k = 0; k < S_MAX; ++k)
        if (k == i) a[k] = v;
}

// per-thread view of the arguments
struct Ctx {
    const DfsArgs& a;
    int b;
    const int32_t* scal;     // this lane's [J][NJF]
    const int8_t* qqp;       // this lane's [J][3L]
    uint32_t* pairs;         // this lane's [S_MAX][L][8]
    uint8_t* elims;          // this lane's [S_MAX][L] (global layout)
    int32_t* hits;           // this lane's [H_MAX][HIT_W]
    uint32_t* sh;            // this lane's word 0 in shared memory
    int qw, ew;              // first word of the by-depth row, elims
};

__device__ __forceinline__ uint32_t& shw(const Ctx& x, int w) {
    return x.sh[w * kMachineThreads];
}

__device__ __forceinline__ uint8_t& shb(const Ctx& x, int w0, int k) {
    return reinterpret_cast<uint8_t*>(&shw(x, w0 + (k >> 2)))[k & 3];
}

// the index the lane's job searches (in the block's shared copy of the
// arguments)
__device__ __forceinline__ const BtFM& index_of(const Ctx& x,
                                                const Lane& s) {
    return s.efw ? x.a.fw : x.a.bw;
}

__device__ __forceinline__ uint32_t* pairs_at(const Ctx& x, int sd, int d) {
    return x.pairs + ((size_t)sd * x.a.L + d) * 8;
}

// byte k of the current job's by-depth row: codes [0, L), quals [L, 2L),
// penalties [2L, 3L)
template <bool ON>
__device__ __forceinline__ int32_t qq(const Ctx& x, const Lane& s, int k) {
    if (ON) return (int8_t)shb(x, x.qw, k);
    return s.qrow[k];
}

template <bool ON>
__device__ __forceinline__ int32_t elim_get(const Ctx& x, int sd, int d) {
    if (ON) return shb(x, x.ew, sd * x.a.L + d) & 15;
    return x.elims[(size_t)sd * x.a.L + d];
}

// the mask of positions of level sd whose elims are not 15
__device__ __forceinline__ uint64_t live_mask(const Ctx& x, int sd) {
    return (uint64_t)shw(x, kMaskW + 2 * sd)
        | ((uint64_t)shw(x, kMaskW + 2 * sd + 1) << 32);
}

__device__ __forceinline__ void live_bit(const Ctx& x, int sd, int d,
                                         bool live) {
    uint32_t& w = shw(x, kMaskW + 2 * sd + (d >> 5));
    const uint32_t bit = 1u << (d & 31);
    w = live ? (w | bit) : (w & ~bit);
}

// ADV's write of elims[sd][d]; `zero` (codes whose range is empty) rides
// in the high nibble where ADV writes the pairs row, and keeps its old
// value where it does not, as that row does
template <bool ON>
__device__ __forceinline__ void elim_adv(const Ctx& x, int sd, int d,
                                         int32_t elim, bool wrote_pairs,
                                         uint32_t zero) {
    if (ON) {
        uint8_t& e = shb(x, x.ew, sd * x.a.L + d);
        e = (uint8_t)(elim | (wrote_pairs ? zero << 4 : e & 0xF0u));
        live_bit(x, sd, d, elim != 15);
    } else {
        x.elims[(size_t)sd * x.a.L + d] = (uint8_t)elim;
    }
}

template <bool ON>
__device__ __forceinline__ void elim_or(const Ctx& x, int sd, int d,
                                        int32_t bit) {
    if (ON) {
        uint8_t& e = shb(x, x.ew, sd * x.a.L + d);
        e |= (uint8_t)bit;
        live_bit(x, sd, d, (e & 15) != 15);
    } else {
        x.elims[(size_t)sd * x.a.L + d] |= (uint8_t)bit;
    }
}

__device__ __forceinline__ void push_frame(const Ctx& x, int sd,
                                           const Frame& f) {
    int w = sd * kFrameWords;
#define BT_PUT(t, n) shw(x, w++) = (uint32_t)f.n;
    BT_FRAME_FIELDS(BT_PUT)
#undef BT_PUT
}

__device__ __forceinline__ void pop_frame(const Ctx& x, int sd, Frame& f) {
    int w = sd * kFrameWords;
#define BT_GET(t, n) f.n = (t)shw(x, w++);
    BT_FRAME_FIELDS(BT_GET)
#undef BT_GET
}

// Entry j of the eight words last put by put_pick: a code's top (j) or
// bot (4 + j) of a pairs row, or a word of a block.  An index into an
// array in registers puts the array in local memory, and the selects
// that avoid the index were computed wrongly on the card (PERF.md); a
// shared-memory word is neither.
__device__ __forceinline__ void put_pick(const Ctx& x,
                                         const uint32_t (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) shw(x, kPickW + j) = v[j];
}

__device__ __forceinline__ uint32_t pick_of(const Ctx& x, int j) {
    return shw(x, kPickW + j);
}

// fm.cuh lf_row, the row's own code picked from shared memory
__device__ __forceinline__ uint32_t lf_row_picked(const Ctx& x,
                                                  const BtFM& fm,
                                                  uint32_t i) {
    const uint32_t block = i / kOccBlock, rem = i % kOccBlock;
    const uint4 o = __ldg(fm.occ + block);
    uint32_t w[kWordsPerBlock];
    block_words(fm, block, w);
    put_pick(x, w);
    const uint32_t c = (pick_of(x, rem >> 4) >> (2 * (rem & 15))) & 3u;
    const uint32_t corr = (c == 0 && i > fm.zoff) ? 1u : 0u;
    return fchr_get(fm, c) + occ_get(o, c) + count_in_block(w, c, rem)
        - corr;
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
#pragma unroll
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
#pragma unroll
    for (int i = 0; i < S_MAX; ++i)
        if (i < sd_r && s.mmd[i] < s.jrev3) stratum += 1;
    const uint32_t spread = bot - top;
    const uint32_t v = rng_next(s.rng);
    s.r_top = top; s.r_bot = bot; s.r_sd = sd_r; s.r_ham = ham;
    s.r_stratum = stratum; s.r_k = 0;
    s.r_r = top + v % (spread > 0 ? spread : 1u);
    s.r_resume = resume; s.r_walk = 0;
    s.ra_n = 0;
    s.mode = M_REP;
}

// _step_retf (:693)
__device__ void step_retf(Lane& s, const Ctx& x) {
    s.sd -= 1;
    pop_frame(x, s.sd, s.c);
    s.mode = M_POP;
}

// _step_job (:922).  The on-chip layout copies the job's by-depth row
// into shared memory here, one word a load, all loads independent.
template <bool ON>
__device__ void step_job(Lane& s, const Ctx& x) {
    const int J = x.a.J, L = x.a.L;
    const int jidx = s.job < J - 1 ? s.job : J - 1;
    const int32_t* f = x.scal + (size_t)jidx * NJF;
    if (!(__ldg(f + F_VALID) > 0 && s.job < J)) {
        s.mode = M_DONE;
        return;
    }
    int32_t v[NJF];
#pragma unroll
    for (int k = 0; k < NJF; ++k) v[k] = __ldg(f + k);
    s.qlen = v[F_QLEN]; s.efw = v[F_EBWT_FW]; s.fwflag = v[F_FW];
    s.jd5 = v[F_D5]; s.jd3 = v[F_D3]; s.jrev2 = v[F_REV2];
    s.jrev3 = v[F_REV3]; s.rep_exacts = v[F_REP_EXACTS];
    s.rep_partials = v[F_REP_PARTIALS]; s.hh = v[F_HH];
    s.maxbts = v[F_MAX_BTS]; s.cons_quals = v[F_CONS_QUALS];
    s.qthresh = v[F_QUAL_THRESH]; s.npremut = v[F_NPREMUT];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        s.premut_pos[k] = v[F_PREMUT_POS0 + k];
        s.premut_refc[k] = v[F_PREMUT_REFC0 + k];
    }
    if (v[F_RESET_RNG] > 0) s.rng = s.seed;
    s.num_bts = 0;
    s.bailed = false;
    s.sd = 0;
    s.qrow = x.qqp + (size_t)jidx * 3 * L;
    if (v[F_NS_GATE] > 0) {
        s.mode = M_JOB;
        s.job += 1;
        return;
    }
    if (ON) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(s.qrow);
#pragma unroll 6
        for (int w = 0; w < (3 * L) / 4; ++w)
            shw(x, x.qw + w) = __ldg(src + w);
    }
    const BtFM& fm = index_of(x, s);
    const int fc = fm.ftab_chars;
    const int32_t qlen = v[F_QLEN], unrev = v[F_UNREV];
    const int32_t ns_ftab = v[F_NS_FTAB], ham0 = v[F_HAM0];
    const int32_t rp = v[F_REP_PARTIALS];
    const bool use_ftab = ns_ftab == 0 && min(unrev, qlen) >= fc;
    uint32_t foff = 0;
    for (int k = 0; k < fc; ++k) {
        const int32_t q = qq<ON>(x, s, k);
        foff |= (uint32_t)(q > 3 ? 0 : q) << (2 * k);
    }
    const uint32_t ft = __ldg(fm.ftab_hi + foff);
    const uint32_t fb = __ldg(fm.ftab_lo + foff + 1);
    const int32_t rev1 = v[F_REV1], rev2 = v[F_REV2], rev3 = v[F_REV3];
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
template <bool ON>
__device__ void step_adv(Lane& s, const Ctx& x) {
    const int L = x.a.L;
    Frame& c = s.c;
    const int32_t d = c.d, sd = s.sd;
    const bool hh = s.hh > 0;
    int32_t hi_n = 0, lo_n = 0;
#pragma unroll
    for (int i = 0; i < S_MAX; ++i) {
        if (i < sd) {
            if (s.mmd[i] < s.jd5) hi_n += 1;
            else if (s.mmd[i] < s.jd3) lo_n += 1;
        }
    }
    const bool req = s.jrev2 == s.jrev3;
    const bool fail5 = d == s.jd5 && (req ? sd == 0 : sd < 1);
    const bool fail3 = d == s.jd3 && (req ? sd < 2 : lo_n == 0);
    if (hh && (fail5 || fail3)) {
        ret_false(s);
        return;
    }
    const int dc = d < 0 ? 0 : (d > L - 1 ? L - 1 : d);
    const int32_t ch = qq<ON>(x, s, dc), q = qq<ON>(x, s, L + dc);
    const int32_t pen = qq<ON>(x, s, 2 * L + dc);
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
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            rt[j] = fm.fchr[j];
            rb[j] = fm.fchr[j + 1];
        }
    } else {
        lf4pair(fm, pt, pb, rt, rb);
    }
    const bool wrote = zero_case || cur_is_alt;
    if (wrote) {
        uint4* p = reinterpret_cast<uint4*>(pairs_at(x, sd, d));
        p[0] = make_uint4(rt[0], rt[1], rt[2], rt[3]);
        p[1] = make_uint4(rb[0], rb[1], rb[2], rb[3]);
    }
    const int cK = ch < 0 ? 0 : (ch > 3 ? 3 : ch);
    const bool is_n = ch > 3;
    const uint32_t rtb[8] = {rt[0], rt[1], rt[2], rt[3],
                             rb[0], rb[1], rb[2], rb[3]};
    put_pick(x, rtb);
    if (!is_n) {
        top = pick_of(x, cK);
        bot = pick_of(x, 4 + cK);
    }
    int32_t elim = is_n ? 0 : (1 << cK);
    int32_t nlive = 0, jstar = -1;
    uint32_t zero = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t sp = rb[j] - rt[j];
        if (sp == 0) zero |= 1u << j;
        if (cur_is_alt && j != ch && sp == 0) elim |= 1 << j;
        if (j != ch && sp != 0) {
            nlive += 1;
            if (jstar < 0) jstar = j;
        }
    }
    if (jstar < 0) jstar = 0;
    elim_adv<ON>(x, sd, d, elim, wrote, zero);
    const int32_t alt = c.alt + (cur_is_alt ? nlive : 0);
    const bool el_upd = cur_is_alt && cur_is_eligible && nlive > 0;
    const bool ovr = el_upd && cur_overrides;
    int32_t elnum = ovr ? 0 : c.elnum;
    if (el_upd) elnum += nlive;
    if (ovr) {
        const uint32_t et = pick_of(x, jstar), eb = pick_of(x, 4 + jstar);
        c.lowq = q; c.eli = d; c.eltop = et; c.elbot = eb;
        c.elham = pen; c.elcint = jstar; c.elignore = 0;
    }
    c.elnum = elnum; c.alt = alt;

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

// BR's search for the highest position in [lo, hi] whose elims are not
// 15 (and whose quality is lowq, under cq), or -1.  On chip: the level's
// mask of such positions, highest bit first; else the global elims, one
// byte a position, as the reference scans.
template <bool ON>
__device__ __forceinline__ int32_t find_istar(const Ctx& x, const Lane& s,
                                              int hi, int lo, bool cq,
                                              int32_t lowq) {
    const int L = x.a.L;
    if constexpr (ON) {
        if (hi < 0 || lo > hi) return -1;
        lo = lo < 0 ? 0 : lo;
        uint64_t m = live_mask(x, s.sd);
        m &= hi >= 63 ? ~0ull : ((2ull << hi) - 1ull);
        m &= ~((1ull << lo) - 1ull);
        while (m) {
            const int i = 63 - __clzll(m);
            if (!cq || qq<ON>(x, s, L + i) == lowq) return i;
            m &= ~(1ull << i);
        }
        return -1;
    } else {
        for (int i = hi; i >= 0 && i >= lo; --i)
            if (elim_get<ON>(x, s.sd, i) != 15
                    && (!cq || qq<ON>(x, s, L + i) == lowq))
                return i;
        return -1;
    }
}

// _step_br (:1206)
template <bool ON>
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
    const int hi = c.d < L - 1 ? c.d : L - 1;
    const int32_t istar_s = find_istar<ON>(x, s, hi, c.depth, cq, c.lowq);
    const int32_t ist = istar_s < 0 ? 0 : istar_s;
    const uint4* p4 = reinterpret_cast<const uint4*>(pairs_at(x, sd, ist));
    const uint4 pt4 = p4[0], pb4 = p4[1];
    const uint32_t pt[4] = {pt4.x, pt4.y, pt4.z, pt4.w};
    const uint32_t pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
    const int32_t er_i = elim_get<ON>(x, sd, ist);
    uint32_t msp[4], pos_sz = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        msp[j] = ((er_i >> j) & 1) == 0 ? pb[j] - pt[j] : 0u;
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
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool nonelim = ((er_i >> j) & 1) == 0;
            if (js < 0 && nonelim && cum <= r && r < cum + msp[j]) js = j;
            cum += msp[j];
        }
        istar = ist;
        jstar = js < 0 ? 0 : js;
        const uint32_t ptb[8] = {pt[0], pt[1], pt[2], pt[3],
                                 pb[0], pb[1], pb[2], pb[3]};
        put_pick(x, ptb);
        bttop = pick_of(x, jstar);
        btbot = pick_of(x, 4 + jstar);
        btham = c.ham + qq<ON>(x, s, 2 * L + ist);
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
    set_at(s.mms, sd, s.qlen - 1 - istar);
    set_at(s.refcs, sd, jstar);
    set_at(s.mmd, sd, istar);
    c.bi = istar;
    c.bj = jstar;
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
            const int32_t q = k == istar ? jstar : qq<ON>(x, s, k);
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
    push_frame(x, sd, c);
    s.sd = sd + 1;
    init_regs(s, midftab ? fc : istar + 1, bt_unrev, bt_rev1, bt_rev2, rev3,
              btham, midftab ? ft : bttop, midftab ? fb : btbot, 0);
}

// the eligibility rescan of _step_pop (:1379 do_rescan).  On chip the
// scan reads shared memory only (each position's elims and empty-range
// codes, quality and penalty) and loads one pairs row, the chosen one's;
// the global layout reads each position's pairs row and elims byte.
template <bool ON>
__device__ void rescan(Lane& s, const Ctx& x) {
    const int L = x.a.L;
    Frame& c = s.c;
    const int lo = max(c.depth, c.unrev);
    const int hi = min(c.d, L - 1);
    int32_t low = 0x7FFF, kstar = -1, n_el = 0;
    for (int k = hi; k >= lo && k >= 0; --k) {
        const int32_t pend = qq<ON>(x, s, 2 * L + k), qk = qq<ON>(x, s, L + k);
        if (!(c.ham + pend <= s.qthresh)) continue;
        int32_t nlive;
        if (ON) {
            const uint32_t e = shb(x, x.ew, s.sd * L + k);
            nlive = __popc(~(e | (e >> 4)) & 15u);
        } else {
            const uint32_t* p = pairs_at(x, s.sd, k);
            const int32_t er = elim_get<ON>(x, s.sd, k);
            nlive = 0;
            for (int j = 0; j < 4; ++j)
                if (((er >> j) & 1) == 0 && p[4 + j] - p[j] != 0) nlive += 1;
        }
        if (nlive == 0) continue;
        if (qk < low) {
            low = qk; kstar = k; n_el = nlive;
        } else if (qk == low) {
            n_el += nlive;
        }
    }
    if (kstar >= 0) {
        const uint4* p4 =
            reinterpret_cast<const uint4*>(pairs_at(x, s.sd, kstar));
        const uint4 pt4 = p4[0], pb4 = p4[1];
        const uint32_t pt[4] = {pt4.x, pt4.y, pt4.z, pt4.w};
        const uint32_t pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
        const int32_t er = elim_get<ON>(x, s.sd, kstar);
        int32_t lstar = 0;
#pragma unroll
        for (int j = 3; j >= 0; --j)
            if (((er >> j) & 1) == 0 && pb[j] != pt[j]) lstar = j;
        const uint32_t ptb[8] = {pt[0], pt[1], pt[2], pt[3],
                                 pb[0], pb[1], pb[2], pb[3]};
        put_pick(x, ptb);
        c.lowq = low; c.eli = kstar; c.eltop = pick_of(x, lstar);
        c.elbot = pick_of(x, 4 + lstar);
        c.elham = qq<ON>(x, s, 2 * L + kstar);
        c.elcint = lstar; c.elignore = 0; c.elnum = n_el;
    } else {
        c.lowq = 0xFF; c.elnum = 0;
    }
}

// _step_pop (:1346)
template <bool ON>
__device__ void step_pop(Lane& s, const Ctx& x) {
    Frame& c = s.c;
    const bool bts_hit = s.hh > 0 && s.maxbts > 0 && s.num_bts >= s.maxbts;
    if (s.bailed || bts_hit) {
        s.bailed = true;
        ret_false(s);
        return;
    }
    elim_or<ON>(x, s.sd, c.bi, 1 << c.bj);
    c.elnum -= 1;
    c.elignore = 1;
    c.alt -= 1;
    if (c.alt == 0) {
        ret_false(s);
        return;
    }
    if (c.elnum == 0 && s.cons_quals > 0) rescan<ON>(s, x);
    s.mode = M_BR;
}

// joinedToTextOff (ebwt.h:2569-2629): the fragment holding joined offset
// `off`, by a binary search of rstarts
__device__ __forceinline__ int frag_of(const DfsArgs& a, uint32_t off) {
    int lo = 0, hi = a.nfrag;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)__ldg(a.rstarts + 3 * mid) <= off) lo = mid + 1;
        else hi = mid;
    }
    // lo - 1 < 0 cannot happen (fragment 0 starts at 0); wrap as torch does
    return a.nfrag == 1 ? 0 : (lo > 0 ? lo - 1 : a.nfrag - 1);
}

// _step_rep (:803).  On the dense SA a REP loads the SA values of up to
// kRepAhead rows of its range at once (no more than the range, -k and -m
// can still take) and reports one row a transition from them.
__device__ void step_rep(Lane& s, const Ctx& x) {
    const DfsArgs& a = x.a;
    const BtFM& fm = index_of(x, s);
    const uint32_t spread = s.r_bot - s.r_top;
    uint32_t ri = s.r_r + s.r_k;
    if (s.r_bot <= ri) ri -= spread;
    uint32_t off;
    if (a.dense) {
        if (!(s.r_k >= s.ra_k && s.r_k < s.ra_k + (uint32_t)s.ra_n)) {
            uint32_t n = min((uint32_t)kRepAhead, spread - s.r_k);
            if (a.n_k != INF32 && a.n_k > s.count)
                n = min(n, (uint32_t)(a.n_k - s.count));
            if (a.m_max != INF32 && a.m_max >= s.count)
                n = min(n, (uint32_t)(a.m_max - s.count) + 1u);
            n = max(n, 1u);
#pragma unroll
            for (int k = 0; k < kRepAhead; ++k) {
                uint32_t r = ri + k;
                if (s.r_bot <= r) r -= spread;
                if ((uint32_t)k < n) shw(x, kPickW + k) = __ldg(fm.sa + r);
            }
            s.ra_k = s.r_k;
            s.ra_n = (int32_t)n;
        }
        off = pick_of(x, (int)(s.r_k - s.ra_k));
    } else {
        // walk left to a marked row, one LF per transition
        // (reportChaseOne, ebwt.h:2727-2746)
        const uint32_t row = s.r_walk == 0 ? ri : s.r_row;
        const uint32_t jumps = s.r_walk == 0 ? 0u : s.r_jumps;
        const bool at_z = row == fm.zoff;
        const uint32_t omask = (1u << fm.off_rate) - 1u;
        if (!((row & omask) == 0 || at_z)) {
            s.r_row = lf_row_picked(x, fm, row);
            s.r_jumps = jumps + 1;
            s.r_walk = 1;
            return;
        }
        s.r_row = row;
        s.r_jumps = jumps;
        s.r_walk = 0;
        off = at_z ? jumps : __ldg(fm.offs + (row >> fm.off_rate)) + jumps;
    }
    const int elt = frag_of(a, off);
    const uint32_t start = (uint32_t)__ldg(a.rstarts + 3 * elt);
    const uint32_t upper = elt + 1 < a.nfrag
        ? (uint32_t)__ldg(a.rstarts + 3 * (elt + 1)) : a.length;
    const int32_t qlen = s.qlen;
    const bool valid = off + (uint32_t)qlen <= upper;
    uint32_t fragoff = off - start;
    if (s.efw == 0) fragoff = (upper - start) - fragoff - 1 - (qlen - 1);
    const uint32_t toff = fragoff + (uint32_t)__ldg(a.rstarts + 3 * elt + 2);

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
        h[0] = (int32_t)__ldg(a.rstarts + 3 * elt + 1);
        h[1] = (int32_t)toff;
        h[2] = s.fwflag | (s.efw << 1);
        h[3] = (int32_t)(s.r_bot - s.r_top - 1);
        h[4] = s.r_stratum;
        h[5] = s.r_ham | (s.r_stratum << 14);
        h[6] = nmms;
        h[7] = qlen;
#pragma unroll
        for (int k = 0; k < MM_SLOTS; ++k) {
            int32_t mv, rv;
            if (k < s.r_sd) {
                mv = k < S_MAX ? s.mms[k < S_MAX ? k : 0] : 0;
                rv = k < S_MAX ? s.refcs[k < S_MAX ? k : 0] : 0;
            } else {
                const int pi = min(max(k - s.r_sd, 0), 2);
                mv = pi == 0 ? s.premut_pos[0]
                   : pi == 1 ? s.premut_pos[1] : s.premut_pos[2];
                rv = pi == 0 ? s.premut_refc[0]
                   : pi == 1 ? s.premut_refc[1] : s.premut_refc[2];
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

// The block's zeroed outputs (_init_state, :536): hit and partial slots
// of its lanes, each array a contiguous run of int4 stores by the whole
// block.
__device__ void zero_outputs(const DfsArgs& a, long b0, int n) {
    const int4 z = make_int4(0, 0, 0, 0);
    int32_t* arrs[5] = {a.hits, a.part_n, a.part_job, a.part_pos,
                        a.part_refc};
    const int widths[5] = {H_MAX * HIT_W, P_MAX, P_MAX, 3 * P_MAX,
                           3 * P_MAX};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        int4* p = reinterpret_cast<int4*>(arrs[k] + b0 * widths[k]);
        const int n4 = n * widths[k] / 4;
        for (int i = threadIdx.x; i < n4; i += blockDim.x) p[i] = z;
    }
}

// At least one block an SM lets ptxas give the lane every register it
// needs (none spilled); shared memory bounds the blocks an SM holds.
template <bool ON>
__global__ void __launch_bounds__(kMachineThreads, 1)
dfs_machine_kernel(const DfsArgs args) {
    extern __shared__ uint32_t smem[];
    // the arguments, read from shared memory from here on (a lane's picks
    // between the two indexes would otherwise copy them to local memory)
    __shared__ DfsArgs a;
    if (threadIdx.x == 0) a = args;
    const long b0 = (long)blockIdx.x * kMachineThreads;
    const int n = (int)min((long)kMachineThreads, (long)args.B - b0);
    zero_outputs(args, b0, n);
    __syncthreads();
    if ((int)threadIdx.x >= n) return;
    const int b = (int)b0 + threadIdx.x;
    const int qw = kMaskW + kMaskWords;
    const Ctx x{a, b, a.scal + (size_t)b * a.J * NJF,
                a.qqp + (size_t)b * a.J * 3 * a.L,
                a.pairs + (size_t)b * S_MAX * a.L * 8,
                ON ? nullptr : a.elims + (size_t)b * S_MAX * a.L,
                a.hits + (size_t)b * H_MAX * HIT_W,
                smem + threadIdx.x, qw, qw + (3 * a.L + 3) / 4};
    if (ON) {
        for (int w = kMaskW; w < lane_words(a.L, true); ++w) shw(x, w) = 0;
    }
    Lane s = {};
    s.mode = M_JOB;
    s.seed = s.rng = (uint32_t)a.seeds[b];
    s.count = a.count0[b];
    s.qrow = x.qqp;
    // One pass applies the lane's transitions in the order RETF, JOB, POP,
    // BR, ADV (up to kAdvPerPass), REP (up to kRepPerPass) while its mode
    // is the next in that order (so a RETF, POP, BR, ADV chain is one
    // pass), each counted; the lane's own order of transitions is
    // unchanged.  A warp runs each body for all its lanes in that mode at
    // once.  The repeats are loops, not unrolled: a second copy of a body
    // made every transition slower.
    const int64_t tmax = a.max_transitions;
    int64_t t = 0;
    while (s.mode != M_DONE && t < tmax) {
        bool ran = false;
        if (s.mode == M_RETF) {
            step_retf(s, x);
            ++t;
            ran = true;
        }
        if (s.mode == M_JOB && t < tmax) {
            step_job<ON>(s, x);
            ++t;
            ran = true;
        }
        if (s.mode == M_POP && t < tmax) {
            step_pop<ON>(s, x);
            ++t;
            ran = true;
        }
        if (s.mode == M_BR && t < tmax) {
            step_br<ON>(s, x);
            ++t;
            ran = true;
        }
#pragma unroll 1
        for (int k = 0; k < kAdvPerPass && s.mode == M_ADV && t < tmax;
             ++k) {
            step_adv<ON>(s, x);
            ++t;
            ran = true;
        }
#pragma unroll 1
        for (int k = 0; k < kRepPerPass && s.mode == M_REP && t < tmax;
             ++k) {
            step_rep(s, x);
            ++t;
            ran = true;
        }
        if (!ran && t < tmax) {      // no mode of the machine
            s.mode = M_DONE;
            s.overflow = true;
            ++t;
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

// K7 on a->B lanes, kMachineThreads a block, in the on-chip layout
// (L <= kOnchipL) or the global one; dfs_device.machine_shape picks it.
int bt_dfs_machine(const DfsArgs* a, int onchip, void* stream) {
    if (onchip && (a->L > kOnchipL || a->L % 4))
        return (int)cudaErrorInvalidValue;
    const size_t shared =
        (size_t)kMachineThreads * 4 * lane_words(a->L, onchip != 0);
    const dim3 grid((a->B + kMachineThreads - 1) / kMachineThreads);
    if (onchip)
        dfs_machine_kernel<true><<<grid, kMachineThreads, shared,
                                   (cudaStream_t)stream>>>(*a);
    else
        dfs_machine_kernel<false><<<grid, kMachineThreads, shared,
                                    (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

// K7's launch shape, for dfs_device.machine_shape to check itself by
int bt_dfs_machine_threads() { return kMachineThreads; }
int bt_dfs_onchip_l() { return kOnchipL; }
int bt_dfs_lane_bytes(int L, int onchip) {
    return 4 * lane_words(L, onchip != 0);
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
