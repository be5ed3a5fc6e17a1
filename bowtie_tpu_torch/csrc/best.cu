// The best-first machine (--best, --strata, -M, -v 3, -n --best): K10 the
// branch-and-bound state machine and K11 the packing of its results.
// Built with exact.cu and dfs.cu by bowtie_tpu_torch/kernels.py and called
// through the plain C entry points at the bottom.
//
// Replaces:
//   K10 bt_best_machine <- bowtie_tpu/align/best_device.py:638
//                          _init_state_jit (the prologue) and :2224
//                          run_chunk (:2173 _machine_step), with K1/K5
//                          (rank4, lf4pair, lf_row) inlined from fm.cuh;
//                          with `record` set, K10r, the record mode of the
//                          paired-end recorder (:1030-1120 _step_main,
//                          _record_range; the per-lane config bases
//                          cfg0f/cfg0o of :854-866 _cfgF/_cfgO); with
//                          `paired` set as well, K14, the merged-mate
//                          recorder of the paired V2 engine
//                          (bowtie_tpu/align/pev2_device.py:54
//                          PairedV2Machine, :157 record -> K10 with
//                          record=True, paired=True: best_device.py
//                          :1141-1159 mate elimination, :1666-1673 the
//                          same-mate strandFix test, :675-681/:731
//                          qlen_o/seed_o, read at :1102, :1845, :1856,
//                          :2099)
//   K11 bt_best_pack    <- best_device.py:2264 _harvest_small, :2270
//                          _poll_all, :2311 _gather_rows (:2278
//                          _harvest_poll, :2344 _merge_out)
// Plain PyTorch versions, which these are held to: init_state +
// run_machine_plain (the lockstep form, step for step the JAX one) and
// best_pack_plain in bowtie_tpu_torch/align/best_device.py.  The lane
// compaction of the JAX driver (:2249 _compact) has no counterpart: each
// thread runs its own lane to the end and retires it.
//
// K10 runs one thread per lane.  The JAX version applies each of
// _machine_step's 18 sub-steps (MAIN, CADV, SFX, SD, ICADV, OADV, DADV,
// EXT, SPP, DEND, SDGEN, ICPOST, SDFULL, ODEND, CPOST, SFXEND, SORT,
// CHASE) to the lanes in its mode, once per lockstep iteration; here each
// thread applies its lane's transitions one after another, `switch
// (mode)`, until M_DONE.  Each function below is the scalar form of the
// JAX sub-step of the same name: the same reads, the same writes under the
// same conditions, the same RNG draws in the same order (rng_al for the
// chase's first row, rng_ca for CostAware's sort ties and the strandFix
// swap, rng_rs per flat driver for splits and pick_edit, ic_rng per outer
// driver for the inner CostAware's sorts).  A sub-step reads and writes
// only its own lane, so the per-lane result is the lockstep one.  Step
// budget: one iteration applies each sub-step at most once to a lane, so a
// lane gets max_transitions = 18 * max_steps; whatever the lockstep
// version finishes within budget, this finishes too.  A lane stops at the
// transition that raises `overflow` (its result goes to the host engine).
//
// Record mode (K10r): a found range is appended to the lane's hit records
// in emission order, with its driver's done-at-emission flag, instead of
// being chased; the lane runs until its driver is exhausted or rec_cap
// ranges are recorded (then the done column of the last record reads 2).
// One launch holds lanes of two driver DAGs (the paired recorder's fw-DAG
// and rc-DAG): the config tables are the DAGs' tables one after another
// and every read of them goes through the lane's bases cfg0f (flat) and
// cfg0o (outer), zero outside record runs.
//
// Paired record mode (K14): one thread per pair runs the merged DAG of
// both mates' drivers, the scalar form of the plain paired sub-steps.
// Each outer reads its own mate's read length and seed (qlen_o, seed_o:
// the record's length column, a seeded extender's length and RNG seed,
// the chase's offset resolve), the strandFix scan takes the other strand
// of the same mate (o_m1), and the outer CostAware is done once either
// mate has no live outer (mate elimination).  The kernel and the lane
// state are templated on their bounds: StSingle (8 outer, 24 flat
// drivers) for single-end and V1 runs, StPaired (16, 48: the merged -n 3
// DAG) for K14, so that the other runs keep their per-thread stack.  The
// launch picks the instantiation by the run's `paired` flag.
//
// Rows are int32 here, as in the JAX machine, which compares them signed:
// the aligner refuses indexes of 2^31 rows or more.  The sentinels
// COST_INF = 0xFFFF and META_ALL_DEAD are the JAX ones.
//
// State: the ~60 lane scalars and the branch-pool scalars, per-driver
// blocks and inner CostAware lists (fixed sizes, St's ND_MAX outer and
// NDT_MAX flat drivers) in one per-thread struct (registers and local
// memory, whose size per instantiation PERF.md gives);
// the per-position pools, ptb [NBR][2L] (each consumed position's entry
// top | bot) and meta [NBR][L] (elimination bits, quallo, the fchr flag),
// in a per-lane global scratch; the hit records straight in the output.
//
// What bounds K10: each EXT or SPP transition is a dependent pair of ranks
// (two 32-byte occ+word sector pairs, fm.cuh rank4) and each CHASE
// transition a dependent SA read (or a walk-left rank); the rest is integer
// work over the lane's own state, which lives in local memory.  Lanes
// diverge at once, so a warp runs its lanes' transitions mostly one lane
// at a time: the kernel is bound by the latency of dependent memory reads
// and by divergence, not by bandwidth or arithmetic.  K11 is a copy, bound
// by the bytes of the rows it moves.
#include "fm.cuh"

namespace {

constexpr int NBR = 16, E_MAX = 6, H_MAX = 16, MM_SLOTS = 8, PEX = 4;
constexpr int HIT_W = 8 + 2 * MM_SLOTS;
// the config tables' bounds: the paired machine's merged -n 3 DAG
constexpr int ND_CFG = 16, NDT_CFG = 48;
constexpr int32_t INF32 = 0x7FFFFFFF;
constexpr int32_t COST_INF = 0xFFFF;
constexpr int32_t META_ELIM = 1 << 4;
constexpr int32_t META_ALL_DEAD = 0xF | META_ELIM | (127 << 5);
constexpr int32_t META_FCHR = 1 << 12;

enum Mode {
    M_DONE, M_MAIN, M_CADV, M_OADV, M_DADV, M_EXT, M_SPP, M_DEND, M_ODEND,
    M_CPOST, M_SFX, M_SFXEND, M_SORT, M_CHASE, M_SD, M_SDGEN, M_SDFULL,
    M_ICADV, M_ICPOST
};
constexpr int PH_OUTER = 0, PH_GEN = 2, PH_FULL = 3;

}  // namespace

// Mirrors BestArgs in bowtie_tpu_torch/align/best_device.py field for
// field.
struct BestArgs {
    BtFM fw, bw;
    const int64_t* rstarts;     // [nfrag][3] start, tidx, toff
    int32_t nfrag;
    uint32_t length;
    int32_t dense;
    int32_t B, L, nd, ndt;
    int32_t n_k, m_max, strata, qual_lim, qual_order, bt_on, has_seeded,
        maxbts;
    int32_t record, rec_cap;    // K10r; rec_cap < 0: no cap
    int32_t paired;             // K14: the merged-mate DAG (with record)
    int64_t max_transitions;
    // driver configs (HostInit.cfg, or the fused tables of a record run,
    // read through the lane's cfg0f/cfg0o): per flat, per outer driver
    int32_t cfg_ebwt_fw[NDT_CFG], cfg_fw[NDT_CFG], cfg_exacts[NDT_CFG],
        cfg_hh[NDT_CFG];
    int32_t cfg_o_kind[ND_CFG], cfg_o_flat0[ND_CFG], cfg_o_exbase[ND_CFG],
        cfg_o_fw[ND_CFG], cfg_o_chase_efw[ND_CFG], cfg_o_m1[ND_CFG];
    const int32_t* init;        // [B][NI] pack_init's rows
    const int8_t* rows_qp;      // [B][ndt][2L] by-depth codes | penalties
    const int64_t* seeds;       // [B] uint32 values
    int32_t* ptb;               // scratch [B][NBR][2L]
    int32_t* meta;              // scratch [B][NBR][L]
    int32_t *result, *overflow, *count, *best_stratum, *nhits, *hits, *mode,
        *steps;
};
// passed by value: within the classic 4 KB kernel-parameter limit
static_assert(sizeof(BestArgs) <= 4096, "BestArgs exceeds 4 KB");

namespace {

constexpr int kThreads = 64;

// the per-outer read length and seed, held only by the paired lane state
// (elsewhere they are the lane's qlen and seed: qlen_of, seed_of); the
// empty base adds no bytes
template <int ND, bool PAIRED>
struct MateRegs {};

template <int ND>
struct MateRegs<ND, true> {
    int32_t qlen_o[ND];
    uint32_t seed_o[ND];
};

// one lane's state (best_device.py:647 _init_state) for at most ND_ outer
// and NDT_ flat drivers
template <int ND_, int NDT_, bool PAIRED_>
struct St : MateRegs<ND_, PAIRED_> {
    static constexpr int ND_MAX = ND_, NDT_MAX = NDT_;
    static constexpr bool PAIRED = PAIRED_;
    int32_t mode, result, count, best_stratum, nhits, qlen;
    int32_t cfg0f, cfg0o, pre_min;
    bool overflow;
    uint32_t rng_al, rng_ca, seed;
    int32_t d5_cur, d3_cur, qlen_cur, bt;
    int32_t ca_done, ca_found, ca_min, act_n, cur, cur_o, precost, phase,
        octx, sfx_mc, adv_found, loop_cost, sdf_old, ic_pre;
    int32_t ls_drv, ls_top, ls_bot, ls_cost, ls_strat, ls_ne;
    int32_t dl_valid, dl_drv, dl_top, dl_bot, dl_cost, dl_strat, dl_ne;
    int32_t ls_ed[E_MAX], ls_ec[E_MAX], dl_ed[E_MAX], dl_ec[E_MAX];
    int32_t ch_r, ch_k, r_row, r_jumps, r_walk;
    int32_t act[ND_MAX];
    // branch pool scalars
    int32_t p_valid[NBR], p_drv[NBR], p_cost[NBR], p_ham[NBR],
        p_rdepth[NBR], p_len[NBR], p_top[NBR], p_bot[NBR], p_curt[NBR],
        p_dly[NBR], p_dlyf[NBR], p_id[NBR], p_ne[NBR], p_d0[NBR], p_d1[NBR],
        p_d2[NBR], p_d3[NBR];
    int32_t p_ed[NBR][E_MAX], p_ec[NBR][E_MAX];
    // flat drivers
    int32_t drv_done[NDT_MAX], drv_found[NDT_MAX], drv_min[NDT_MAX],
        drv_adj[NDT_MAX], pm_min[NDT_MAX], drv_nextid[NDT_MAX],
        dqlen[NDT_MAX], dd5[NDT_MAX], dd3[NDT_MAX], pm_n[NDT_MAX];
    uint32_t rng_rs[NDT_MAX];
    int32_t rr[NDT_MAX][5], rr_ed[NDT_MAX][E_MAX], rr_ec[NDT_MAX][E_MAX];
    int32_t pm_m[NDT_MAX][3], pm_c[NDT_MAX][3];
    // outer drivers and the inner CostAware of each
    int32_t ex_next[ND_MAX], od_done[ND_MAX], od_found[ND_MAX],
        od_min[ND_MAX];
    int32_t od_rr[ND_MAX][5], od_ed[ND_MAX][E_MAX], od_ec[ND_MAX][E_MAX];
    int32_t ic_act[ND_MAX][PEX], ic_actn[ND_MAX], ic_found[ND_MAX],
        ic_done[ND_MAX], ic_min[ND_MAX];
    uint32_t ic_rng[ND_MAX];
    int32_t il_top[ND_MAX], il_bot[ND_MAX], il_cost[ND_MAX],
        il_strat[ND_MAX], il_ne[ND_MAX];
    int32_t il_ed[ND_MAX][E_MAX], il_ec[ND_MAX][E_MAX];
};
using StSingle = St<8, 24, false>;
using StPaired = St<ND_CFG, NDT_CFG, true>;

// per-thread view of the arguments
struct Ctx {
    const BestArgs& a;
    int L;
    const int8_t* rows;      // this lane's [ndt][2L]
    int32_t* ptb;            // this lane's [NBR][2L]
    int32_t* meta;           // this lane's [NBR][L]
    int32_t* hits;           // this lane's [H_MAX][HIT_W]
};

__device__ __forceinline__ const BtFM& index_of(const Ctx& x, int32_t efw) {
    return efw > 0 ? x.a.fw : x.a.bw;
}

// the read length and RNG seed of outer driver o's mate
template <class S>
__device__ __forceinline__ int32_t qlen_of(const S& s, int32_t o) {
    if constexpr (S::PAIRED) return s.qlen_o[o];
    else return s.qlen;
}

template <class S>
__device__ __forceinline__ uint32_t seed_of(const S& s, int32_t o) {
    if constexpr (S::PAIRED) return s.seed_o[o];
    else return s.seed;
}

// config of flat driver f / outer driver o of the lane's own DAG
// (_cfgF / _cfgO, :854-866)
template <class S>
__device__ __forceinline__ int32_t cfgF(const int32_t* table, const S& s,
                                        int32_t f) {
    return table[s.cfg0f + f];
}

template <class S>
__device__ __forceinline__ int32_t cfgO(const int32_t* table, const S& s,
                                        int32_t o) {
    return table[s.cfg0o + o];
}

__device__ __forceinline__ int32_t clampi(int32_t v, int32_t lo,
                                          int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// the by-depth code of flat driver f at depth d: its static row with its
// seed-stage premuts applied (_derive_qd, :891)
template <class S>
__device__ __forceinline__ int32_t qd_at(const S& s, const Ctx& x, int f,
                                         int d) {
    int32_t c = x.rows[(size_t)f * 2 * x.L + d];
    for (int k = 0; k < 3; ++k)
        if (s.pm_n[f] > k && d == s.pm_m[f][k]) c = s.pm_c[f][k];
    return c;
}

__device__ __forceinline__ int32_t pend_at(const Ctx& x, int f, int d) {
    return x.rows[(size_t)f * 2 * x.L + x.L + d];
}

// NBestFirstStrat::irrelevantCost (hit.h:1124-1131)
template <class S>
__device__ __forceinline__ bool irrelevant(const S& s, const Ctx& x,
                                           int32_t cost) {
    return x.a.strata && s.count > 0 && (cost >> 14) > s.best_stratum;
}

// the quartets of both range ends on index efw, as the JAX machine's
// _lf4pair gives them (fm.cuh lf4pair)
__device__ __forceinline__ void quartets(const Ctx& x, int32_t efw,
                                         int32_t top, int32_t bot,
                                         int32_t t4[4], int32_t b4[4]) {
    uint32_t t[4], b[4];
    lf4pair(index_of(x, efw), (uint32_t)top, (uint32_t)bot, t, b);
    for (int j = 0; j < 4; ++j) {
        t4[j] = (int32_t)t[j];
        b4[j] = (int32_t)b[j];
    }
}

// PathManager front (_front_select, :876): the eligible slot of driver
// cur with the least CostCompare key, the least id among equal keys, the
// first slot among equal ids; slot 0 when none is eligible.
template <class S>
__device__ int front_select(const S& s, int32_t cur, bool& nonempty) {
    int32_t k1min = INF32;
    nonempty = false;
    for (int j = 0; j < NBR; ++j) {
        if (!(s.p_valid[j] > 0 && s.p_drv[j] == cur)) continue;
        nonempty = true;
        const int32_t tip = s.p_rdepth[j] + s.p_len[j];
        const int32_t key1 = ((s.p_cost[j] * 2 + s.p_curt[j]) << 8)
            | (255 - min(tip, 255));
        k1min = min(k1min, key1);
    }
    int fs = 0;
    int32_t best_id = INF32;
    for (int j = 0; j < NBR; ++j) {
        int32_t idk = INF32;
        if (s.p_valid[j] > 0 && s.p_drv[j] == cur) {
            const int32_t tip = s.p_rdepth[j] + s.p_len[j];
            const int32_t key1 = ((s.p_cost[j] * 2 + s.p_curt[j]) << 8)
                | (255 - min(tip, 255));
            if (key1 == k1min) idk = s.p_id[j];
        }
        if (idk < best_id) {
            best_id = idk;
            fs = j;
        }
    }
    return fs;
}

template <class S>
__device__ __forceinline__ bool drv_has_branch(const S& s, int32_t cur) {
    for (int j = 0; j < NBR; ++j)
        if (s.p_valid[j] > 0 && s.p_drv[j] == cur) return true;
    return false;
}

// the first free pool slot (slot 0 when the pool is full)
template <class S>
__device__ __forceinline__ int free_slot(const S& s) {
    for (int j = 0; j < NBR; ++j)
        if (s.p_valid[j] == 0) return j;
    return 0;
}

// the curtail/split cost of position ii of a branch (_meta_costs,
// :1228): COST_INF where the position is not eligible
template <class S>
__device__ __forceinline__ int32_t meta_cost(const S& s, const Ctx& x,
                                             int32_t meta, int ii,
                                             int32_t frd, int32_t flen,
                                             int32_t fd0, int32_t d3) {
    const int32_t i0 = max(0, fd0 - frd);
    const bool elig = ii >= i0 && ii <= flen && ii < s.qlen_cur - frd
        && (meta & META_ELIM) == 0;
    if (!elig) return COST_INF;
    const int32_t quallo = (meta >> 5) & 0x7F;
    const int32_t strat = (frd + ii) < d3 ? (1 << 14) : 0;
    return (x.a.qual_order ? quallo : 0) | strat;
}

// sortActives (range_source.h:2367+; _sort_generic, :949) over an id list
// act[0..K) indexing done2/found2/min2: selection sort with a draw per tie
__device__ void sort_generic(int32_t* act, int32_t& act_n,
                             const int32_t* done2, const int32_t* found2,
                             const int32_t* min2, uint32_t& rng, int K) {
    int32_t i = 0;
    for (int t = 0; t < 2 * K; ++t) {
        if (!(i < act_n)) break;
        const int32_t cur = act[clampi(i, 0, K - 1)];
        if (done2[cur] > 0 && found2[cur] == 0) {
            for (int c = i; c < K - 1; ++c) act[c] = act[c + 1];
            act_n -= 1;
            continue;
        }
        int32_t min_cost = min2[cur], min_off = i;
        for (int joff = 1; joff < K; ++joff) {
            const int32_t j = i + joff;
            if (!(j < act_n)) continue;
            const int32_t cj = act[clampi(j, 0, K - 1)];
            if (done2[cj] > 0 && found2[cj] == 0) continue;
            const int32_t cost_j = min2[cj];
            if (cost_j < min_cost) {
                min_cost = cost_j;
                min_off = j;
            } else if (cost_j == min_cost) {
                if (rng_next(rng) & 0x1000) min_off = j;
            }
        }
        if (min_off != i) {
            const int ia = clampi(i, 0, K - 1), ib = clampi(min_off, 0, K - 1);
            const int32_t vi = act[ia], vm = act[ib];
            act[ia] = vm;
            act[ib] = vi;
        }
        i += 1;
    }
}

template <class S>
__device__ __forceinline__ void load_cur_rows(S& s, int32_t f) {
    s.d5_cur = s.dd5[f];
    s.d3_cur = s.dd3[f];
    s.qlen_cur = s.dqlen[f];
}

template <class S>
__device__ void copy_outer_range(S& s, bool to_ls, int32_t o) {
    if (to_ls) {
        s.ls_drv = o; s.ls_top = s.od_rr[o][0]; s.ls_bot = s.od_rr[o][1];
        s.ls_cost = s.od_rr[o][2]; s.ls_strat = s.od_rr[o][3];
        s.ls_ne = s.od_rr[o][4];
        for (int k = 0; k < E_MAX; ++k) {
            s.ls_ed[k] = s.od_ed[o][k];
            s.ls_ec[k] = s.od_ec[o][k];
        }
    } else {
        s.dl_drv = o; s.dl_top = s.od_rr[o][0]; s.dl_bot = s.od_rr[o][1];
        s.dl_cost = s.od_rr[o][2]; s.dl_strat = s.od_rr[o][3];
        s.dl_ne = s.od_rr[o][4];
        for (int k = 0; k < E_MAX; ++k) {
            s.dl_ed[k] = s.od_ed[o][k];
            s.dl_ec[k] = s.od_ec[o][k];
        }
    }
}

template <typename T>
__device__ __forceinline__ void swap_(T& a, T& b) {
    const T t = a;
    a = b;
    b = t;
}

// ---- aligner-level + outer CostAware steps ---------------------------------

// _record_range (:1064): K10r's loop head.  A found range becomes a hit
// record [drv, top, bot, cost, stratum, nedits, done, qlen, edit depths
// (slot MM_SLOTS-1: pre_min), edit chars]; done is 2 on the record that
// reaches rec_cap with the driver not exhausted.  No chase, no draw.
template <class S>
__device__ void record_range(S& s, const Ctx& x) {
    const BestArgs& a = x.a;
    if (s.ca_found > 0) {
        const int32_t nmms = s.ls_ne;
        if (s.nhits >= H_MAX || nmms > MM_SLOTS) {
            s.overflow = true;
            s.mode = M_DONE;
            return;
        }
        int32_t done = s.ca_done;
        if (a.rec_cap >= 0 && s.nhits + 1 >= a.rec_cap && s.ca_done == 0)
            done = 2;
        int32_t* h = x.hits + (size_t)s.nhits * HIT_W;
        h[0] = s.ls_drv; h[1] = s.ls_top; h[2] = s.ls_bot; h[3] = s.ls_cost;
        h[4] = s.ls_strat; h[5] = nmms; h[6] = done;
        h[7] = qlen_of(s, s.ls_drv);
        for (int k = 0; k < MM_SLOTS; ++k) {
            h[8 + k] = k < E_MAX ? s.ls_ed[k] : 0;
            h[8 + MM_SLOTS + k] = k < E_MAX ? s.ls_ec[k] : 0;
        }
        h[8 + MM_SLOTS - 1] = s.pre_min;
        s.nhits += 1;
        s.ca_found = 0;
        if (a.rec_cap >= 0 && s.nhits >= a.rec_cap) s.mode = M_DONE;
        return;
    }
    s.pre_min = s.ca_min;
    s.mode = s.ca_done > 0 ? M_DONE : M_CADV;
}

// _step_main (:1030)
template <class S>
__device__ void step_main(S& s, const Ctx& x) {
    if (x.a.record) {
        record_range(s, x);
        return;
    }
    if (s.ca_found > 0) {
        if (irrelevant(s, x, s.ls_cost)) {
            s.ca_found = 0;
            return;
        }
        const int32_t spread = max(s.ls_bot - s.ls_top, 1);
        const uint32_t v = rng_next(s.rng_al);
        s.ch_r = s.ls_top + (int32_t)(v % (uint32_t)spread);
        s.ch_k = 0;
        s.r_walk = 0;
        s.mode = M_CHASE;
        return;
    }
    s.mode = (s.ca_done > 0 || irrelevant(s, x, s.ca_min)) ? M_DONE : M_CADV;
}

// _step_cadv (:1127), with K14's mate elimination
template <class S>
__device__ void step_cadv(S& s, const Ctx& x) {
    const bool has_act = s.act_n > 0;
    const int32_t act0 = s.act[0];
    if (s.dl_valid > 0) {
        s.ls_drv = s.dl_drv; s.ls_top = s.dl_top; s.ls_bot = s.dl_bot;
        s.ls_cost = s.dl_cost; s.ls_strat = s.dl_strat; s.ls_ne = s.dl_ne;
        for (int k = 0; k < E_MAX; ++k) {
            s.ls_ed[k] = s.dl_ed[k];
            s.ls_ec[k] = s.dl_ec[k];
        }
        s.dl_valid = 0;
        s.ca_found = 1;
        if (has_act) s.ca_min = max(s.od_min[act0], s.ca_min);
        else s.ca_done = 1;
        s.mode = M_MAIN;
        return;
    }
    if constexpr (S::PAIRED) {
        // (:1141-1159) with no delayed range pending, the merged driver
        // is done once either mate has no not-done outer left
        bool alive1 = false, alive2 = false;
        for (int o = 0; o < x.a.nd; ++o)
            if (s.od_done[o] == 0) {
                if (cfgO(x.a.cfg_o_m1, s, o) > 0) alive1 = true;
                else alive2 = true;
            }
        if (!(alive1 && alive2)) {
            s.ca_done = 1;
            s.mode = M_MAIN;
            return;
        }
    }
    if (!has_act) {
        s.ca_done = 1;
        s.mode = M_MAIN;
        return;
    }
    s.cur_o = act0;
    s.octx = 0;
    s.precost = s.od_min[act0];
    s.mode = s.od_found[act0] > 0 ? M_CPOST : M_OADV;
}

// _step_oadv (:1180)
template <class S>
__device__ void step_oadv(S& s, const Ctx& x) {
    const int32_t kind = x.a.has_seeded ? cfgO(x.a.cfg_o_kind, s, s.cur_o)
                                        : 0;
    if (kind == 0) {
        s.cur = cfgO(x.a.cfg_o_flat0, s, s.cur_o);
        s.phase = PH_OUTER;
        load_cur_rows(s, s.cur);
        s.mode = M_DADV;
    } else {
        s.mode = M_SD;
    }
}

// _step_sfx (:1203)
template <class S>
__device__ void step_sfx(S& s) {
    const int32_t o = s.cur_o;
    s.mode = (s.od_done[o] > 0 || s.od_found[o] > 0) ? M_SFXEND : M_OADV;
}

// _step_dadv (:1214)
template <class S>
__device__ void step_dadv(S& s) {
    const int32_t cur = s.cur;
    const bool dd = s.drv_done[cur] > 0 || !drv_has_branch(s, cur);
    if (dd) s.drv_done[cur] = 1;
    s.adv_found = 0;
    s.mode = dd ? M_DEND : M_EXT;
}

// _step_ext (:1263): consume one position of the front branch
template <class S>
__device__ void step_ext(S& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int L = x.L;
    const int32_t cur = s.cur;
    const int32_t efw = cfgF(a.cfg_ebwt_fw, s, cur);
    const int32_t hh = cfgF(a.cfg_hh, s, cur);
    const int32_t exacts = cfgF(a.cfg_exacts, s, cur);
    const int32_t d5 = s.d5_cur, d3 = s.d3_cur;
    bool nonempty;
    const int fs = front_select(s, cur, nonempty);
    const int32_t fcost = s.p_cost[fs], fham = s.p_ham[fs];
    const int32_t frd = s.p_rdepth[fs], flen = s.p_len[fs];
    const int32_t ftop = s.p_top[fs], fbot = s.p_bot[fs];
    const int32_t fne = s.p_ne[fs], fd0 = s.p_d0[fs];
    s.loop_cost = fcost;
    const int32_t depth = frd + flen;
    const int32_t qlen = s.qlen_cur;
    const bool hhfail = hh > 0 && ((depth == d5 && fne == 0)
                                   || (depth == d3 && fne < hh));
    const bool consume = !hhfail && depth < qlen;
    const int dc = clampi(depth, 0, L - 1);
    const int32_t c = qd_at(s, x, cur, dc), q = pend_at(x, cur, dc);
    const bool alt = depth >= fd0 && fham + q <= a.qual_lim;
    const int32_t pt = ftop, pb = fbot;
    const bool n4 = consume && c == 4 && depth > 0;
    const int32_t tb_top = n4 ? 1 : ftop, tb_bot = n4 ? 1 : fbot;
    const bool caseA = consume && tb_top == 0 && tb_bot == 0;
    const bool caseB = consume && !caseA && alt && (pb > pt || c == 4);
    const bool caseC = consume && !caseA && !caseB && pb > pt;
    const BtFM& fm = index_of(x, efw);
    int32_t tops[4], bots[4];
    if (caseA) {
        for (int j = 0; j < 4; ++j) {
            tops[j] = (int32_t)fm.fchr[j];
            bots[j] = (int32_t)fm.fchr[j + 1];
        }
    } else if (caseB || caseC) {
        quartets(x, efw, pt, pb, tops, bots);
    } else {
        for (int j = 0; j < 4; ++j) tops[j] = bots[j] = 0;   // unused
    }
    const bool install = caseA || caseB;
    const bool dead = q > a.qual_lim - fham;
    int32_t elim_bits = 0;
    bool any_enabled = false;
    for (int j = 0; j < 4; ++j) {
        const bool enabled = j != c && bots[j] > tops[j] && !dead && install;
        if (enabled) any_enabled = true;
        else elim_bits |= 1 << j;
    }
    int32_t meta_new = META_ALL_DEAD;
    if (install)
        meta_new = elim_bits | (any_enabled ? 0 : META_ELIM)
            | (clampi(q, 0, 127) << 5) | (caseA ? META_FCHR : 0);
    const int c3 = clampi(c, 0, 3);
    const bool abc = (caseA || caseB || caseC) && c < 4;
    int32_t new_top = abc ? tops[c3] : tb_top;
    int32_t new_bot = abc ? bots[c3] : tb_bot;
    if (caseA && c == 4) new_top = new_bot = 0;
    if (consume) {
        s.p_top[fs] = new_top;
        s.p_bot[fs] = new_bot;
    }
    const int32_t eff_top = consume ? new_top : ftop;
    const int32_t eff_bot = consume ? new_bot : fbot;
    const bool cur0 = depth >= qlen - 1;
    const bool empty = eff_top == eff_bot;
    const bool hit = !hhfail && cur0 && !empty;
    const bool invalid_exact = hit && fne == 0 && exacts == 0;
    int32_t hi_n = 0, lo_n = 0;
    for (int i = 0; i < E_MAX; ++i) {
        if (i >= fne) break;
        const int32_t e = s.p_ed[fs][i];
        if (e < d5) hi_n += 1;
        if (e >= d5 && e < d3) lo_n += 1;
    }
    bool hh2ok = true;
    if (depth == d5 - 1 && !empty) hh2ok = fne > 0;
    else if (depth == d3 - 1 && !empty)
        hh2ok = fne >= hh && !(lo_n == 0 || hi_n == 0);
    const bool hh2fail = !hhfail && hh > 0 && !hh2ok;
    const bool found = hit && !invalid_exact && !hh2fail;
    const bool extend = !hhfail && !hh2fail && !hit && !empty && !cur0;
    const bool curt = !extend;

    if (found) {
        // _mk_range with the driver's seed premuts appended
        // (_merged_edits, :1243)
        s.adv_found = 1;
        const int32_t npm = s.pm_n[cur];
        for (int k = 0; k < E_MAX; ++k) {
            if (k < fne) {
                s.rr_ed[cur][k] = s.p_ed[fs][k];
                s.rr_ec[cur][k] = s.p_ec[fs][k];
            } else {
                const int pi = clampi(k - fne, 0, 2);
                s.rr_ed[cur][k] = s.pm_m[cur][pi];
                s.rr_ec[cur][k] = s.pm_c[cur][pi];
            }
        }
        s.rr[cur][0] = eff_top; s.rr[cur][1] = eff_bot; s.rr[cur][2] = fcost;
        s.rr[cur][3] = fcost >> 14; s.rr[cur][4] = fne + npm;
    }
    if (extend) s.p_len[fs] = flen + 1;
    int32_t* ptb = x.ptb + (size_t)fs * 2 * L;
    int32_t* meta = x.meta + (size_t)fs * L;
    if (consume) {
        if (L + flen >= 0 && L + flen < 2 * L) ptb[L + flen] = pb;
        if (flen >= 0 && flen < 2 * L) ptb[flen] = pt;
    }
    if (extend && flen + 1 >= 0 && flen + 1 < L) meta[flen + 1] = META_ALL_DEAD;
    if (consume && flen >= 0 && flen < L) meta[flen] = meta_new;
    if (extend && flen + 1 >= L) {
        s.overflow = true;
        return;
    }
    // curtail (range_source.h:877-939 + PathManager::curtail 1434-1455)
    int32_t lowest = COST_INF;
    for (int ii = max(0, fd0 - frd); ii <= flen && ii < L; ++ii)
        lowest = min(lowest, meta_cost(s, x, meta[ii], ii, frd, flen, fd0,
                                       d3));
    if (curt) {
        if (lowest == COST_INF) {
            s.p_valid[fs] = 0;
        } else {
            s.p_cost[fs] = fcost + lowest;
            s.p_curt[fs] = 1;
        }
    }
    s.mode = M_SPP;
}

// _step_spp (:1409): splitAndPrep, the shared --maxbts ceiling,
// splitBranch/pick_edit and the loop exit checks
template <class S>
__device__ void step_spp(S& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int L = x.L;
    const int32_t cur = s.cur;
    const int32_t efw = cfgF(a.cfg_ebwt_fw, s, cur);
    const int32_t d3 = s.d3_cur;
    bool nonempty;
    const int fs = front_select(s, cur, nonempty);
    const bool pm_empty = !nonempty;
    bool live = nonempty;
    const int32_t fcost = s.p_cost[fs], fdlyf = s.p_dlyf[fs];
    const int32_t fdly = s.p_dly[fs], fcurt = s.p_curt[fs];
    const int32_t frd = s.p_rdepth[fs], flen = s.p_len[fs];
    const int32_t fne = s.p_ne[fs], fham = s.p_ham[fs];
    const int32_t fd0 = s.p_d0[fs], fd1 = s.p_d1[fs], fd2 = s.p_d2[fs];
    const int32_t fd3 = s.p_d3[fs];
    const bool btfail0 = a.bt_on && live && s.bt == 0;
    bool clear0 = btfail0;
    live = live && !btfail0;
    const bool dfix = live && fdlyf > 0;
    if (dfix) {
        s.p_cost[fs] = fdly;
        s.p_dlyf[fs] = 0;
    }
    bool rest = live && !dfix;
    bool dosplit = rest && fcurt > 0;
    if (a.bt_on) {
        if (dosplit) s.bt = max(s.bt - 1, 0);
        const bool btfail1 = dosplit && s.bt == 0;
        clear0 = clear0 || btfail1;
        dosplit = dosplit && !btfail1;
        rest = rest && !btfail1;
        if (clear0) {
            for (int j = 0; j < NBR; ++j)
                if (s.p_drv[j] == cur) s.p_valid[j] = 0;
            s.pm_min[cur] = 0;
            s.mode = M_DEND;
        }
    }
    const int32_t* ptb = x.ptb + (size_t)fs * 2 * L;
    int32_t* meta_f = x.meta + (size_t)fs * L;
    int32_t best = COST_INF, nxt = COST_INF, n_t = 0, n_el = 0;
    const int i0 = max(0, fd0 - frd);
    for (int ii = i0; ii <= flen && ii < L; ++ii) {
        const int32_t cst = meta_cost(s, x, meta_f[ii], ii, frd, flen, fd0,
                                      d3);
        if (cst == COST_INF) continue;          // not eligible
        n_el += 1;
        if (cst < best) {
            nxt = min(nxt, best);
            best = cst;
            n_t = 1;
        } else if (cst == best) {
            n_t += 1;
        } else {
            nxt = min(nxt, cst);
        }
    }
    const int32_t w = min(n_t, 3);
    int32_t r = 0;
    if (dosplit && w > 1)
        r = (int32_t)(rng_next(s.rng_rs[cur]) % (uint32_t)max(w, 1));
    const int32_t rank = n_t - w + r;
    int32_t pos = 0, seen = 0;
    for (int ii = i0; ii <= flen && ii < L && best != COST_INF; ++ii) {
        if (meta_cost(s, x, meta_f[ii], ii, frd, flen, fd0, d3) != best)
            continue;
        seen += 1;
        if (seen == rank + 1) {
            pos = ii;
            break;
        }
    }
    const int32_t depth_split = frd + pos;
    int32_t tops[4], bots[4];
    const int32_t meta_pos = meta_f[pos];
    const bool is_fchr = (meta_pos & META_FCHR) > 0;
    const BtFM& fm = index_of(x, efw);
    if (is_fchr) {
        for (int j = 0; j < 4; ++j) {
            tops[j] = (int32_t)fm.fchr[j];
            bots[j] = (int32_t)fm.fchr[j + 1];
        }
    } else if (dosplit) {
        quartets(x, efw, ptb[pos], ptb[L + pos], tops, bots);
    } else {
        for (int j = 0; j < 4; ++j) tops[j] = bots[j] = 0;   // unused
    }
    // pick_edit (range_source.h:321-485)
    int32_t num = 0, tot = 0, cumsp[4];
    bool cands[4];
    for (int j = 0; j < 4; ++j) {
        cands[j] = ((meta_pos >> j) & 1) == 0;
        num += cands[j];
        tot += cands[j] ? bots[j] - tops[j] : 0;
        cumsp[j] = tot;
    }
    uint32_t dart = 0;
    if (dosplit && num > 1)
        dart = rng_next(s.rng_rs[cur]) % (uint32_t)max(tot, 1);
    int32_t chosen_multi = 0, chosen_single = 0;
    for (int j = 3; j >= 0; --j) {
        if (cands[j] && (int32_t)dart < cumsp[j]) chosen_multi = j;
        if (cands[j]) chosen_single = j;
    }
    const bool last = num == 1;
    const int32_t chosen = last ? chosen_single : chosen_multi;
    const int32_t pm_new = last ? (meta_pos | META_ELIM)
                                : (meta_pos | (1 << clampi(chosen, 0, 3)));
    const int cslot = free_slot(s);
    const bool pool_full = s.p_valid[cslot] > 0;
    const bool over = dosplit && (pool_full || fne + 1 > E_MAX);
    if (over) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    const bool ok = dosplit;
    if (ok) {
        const int32_t nid = s.drv_nextid[cur];
        s.drv_nextid[cur] = nid + 1;
        s.p_valid[cslot] = 1; s.p_drv[cslot] = cur; s.p_cost[cslot] = fcost;
        s.p_ham[cslot] = fham + (best & 0x3FFF);
        s.p_rdepth[cslot] = frd + pos + 1; s.p_len[cslot] = 0;
        s.p_top[cslot] = tops[chosen]; s.p_bot[cslot] = bots[chosen];
        s.p_curt[cslot] = 0; s.p_dly[cslot] = 0; s.p_dlyf[cslot] = 0;
        s.p_id[cslot] = nid; s.p_ne[cslot] = fne + 1;
        s.p_d0[cslot] = depth_split < fd1 ? fd1 : fd0;
        s.p_d1[cslot] = depth_split < fd2 ? fd2 : fd1;
        s.p_d2[cslot] = depth_split < fd3 ? fd3 : fd2;
        s.p_d3[cslot] = fd3;
        const int at_ne = clampi(fne, 0, E_MAX - 1);
        for (int k = 0; k < E_MAX; ++k) {
            s.p_ed[cslot][k] = k == at_ne ? depth_split : s.p_ed[fs][k];
            s.p_ec[cslot][k] = k == at_ne ? chosen : s.p_ec[fs][k];
        }
        const bool exh = n_el == 1 && last;
        if (exh) s.p_valid[fs] = 0;
        if (!exh && n_t == 1 && last && best != nxt && nxt != COST_INF) {
            s.p_dly[fs] = fcost - best + nxt;
            s.p_dlyf[fs] = 1;
        }
        x.meta[(size_t)cslot * L] = META_ALL_DEAD;
        meta_f[pos] = pm_new;
    }
    // loop exit checks (advance_branch tail)
    const bool chk = rest || pm_empty;
    bool any2 = false;
    int32_t fca = INF32;
    for (int j = 0; j < NBR; ++j) {
        if (s.p_valid[j] > 0 && s.p_drv[j] == cur) {
            any2 = true;
            fca = min(fca, s.p_cost[j]);
        }
    }
    if (any2) s.pm_min[cur] = fca;
    if (chk) {
        const bool exit_ = !any2 || fca != s.loop_cost || s.adv_found > 0;
        s.mode = exit_ ? M_DEND : M_EXT;
    }
}

// _step_dend (:1602)
template <class S>
__device__ void step_dend(S& s) {
    const int32_t cur = s.cur;
    s.drv_done[cur] = drv_has_branch(s, cur) ? 0 : 1;
    const int32_t pmc = s.pm_min[cur];
    if (pmc != 0) s.drv_min[cur] = max(pmc, s.drv_adj[cur]);
    s.drv_found[cur] = s.adv_found;
    if (s.phase == PH_OUTER) s.mode = M_ODEND;
    else if (s.phase == PH_GEN) s.mode = M_SDGEN;
    else if (s.phase == PH_FULL) s.mode = M_ICPOST;
}

// _step_odend (:1624)
template <class S>
__device__ void step_odend(S& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t f0 = cfgO(x.a.cfg_o_flat0, s, o);
    if (cfgO(x.a.cfg_o_kind, s, o) == 0) {
        s.od_done[o] = s.drv_done[f0];
        s.od_min[o] = s.drv_min[f0];
        if (s.drv_found[f0] > 0) {
            s.od_found[o] = 1;
            s.drv_found[f0] = 0;
            for (int k = 0; k < 5; ++k) s.od_rr[o][k] = s.rr[f0][k];
            for (int k = 0; k < E_MAX; ++k) {
                s.od_ed[o][k] = s.rr_ed[f0][k];
                s.od_ec[o][k] = s.rr_ec[f0][k];
            }
        }
    }
    if (s.octx == 0) s.mode = M_CPOST;
    else if (s.octx == 1) s.mode = s.od_min[o] > s.sfx_mc ? M_SFXEND : M_SFX;
}

// _step_cpost (:1652): consume a found range incl. the strandFix scan
template <class S>
__device__ void step_cpost(S& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const bool pf = s.od_found[o] > 0;
    const bool needs0 = s.od_done[o] > 0 || s.precost != s.od_min[o];
    if (pf) {
        copy_outer_range(s, true, o);
        s.ca_found = 1;
        s.od_found[o] = 0;
    }
    const int32_t r_fw = cfgO(x.a.cfg_o_fw, s, o);
    // K14: the other strand of the same mate (:1666-1673)
    const int32_t r_m1 = S::PAIRED ? cfgO(x.a.cfg_o_m1, s, o) : 1;
    int i_star = -1;
    for (int i = 1; i < x.a.nd; ++i)
        if (cfgO(x.a.cfg_o_fw, s, i) != r_fw && i < s.act_n
            && (!S::PAIRED || cfgO(x.a.cfg_o_m1, s, i) == r_m1)) {
            i_star = i;
            break;
        }
    bool go = false;
    if (pf && i_star >= 0) {
        const int32_t tgt = s.act[i_star];
        const int32_t mc = max(s.ca_min, s.od_min[tgt]);
        if (!(mc > s.ls_cost)) {
            go = true;
            s.cur_o = tgt;
            s.octx = 1;
            s.sfx_mc = mc;
            s.mode = M_SFX;
        }
    }
    if (!go) s.mode = needs0 ? M_SORT : M_MAIN;
}

// _step_sfxend (:1695): the opposite-strand range as delayed, with the
// spread-weighted swap draw
template <class S>
__device__ void step_sfxend(S& s) {
    const int32_t o = s.cur_o;
    if (s.od_found[o] > 0) {
        copy_outer_range(s, false, o);
        s.dl_valid = 1;
        s.od_found[o] = 0;
        const int32_t tot = (s.dl_bot - s.dl_top) + (s.ls_bot - s.ls_top);
        const uint32_t v = rng_next(s.rng_ca);
        const int32_t rq = (int32_t)(v % (uint32_t)max(tot, 1));
        if (rq < s.dl_bot - s.dl_top) {
            swap_(s.ls_drv, s.dl_drv); swap_(s.ls_top, s.dl_top);
            swap_(s.ls_bot, s.dl_bot); swap_(s.ls_cost, s.dl_cost);
            swap_(s.ls_strat, s.dl_strat); swap_(s.ls_ne, s.dl_ne);
            for (int k = 0; k < E_MAX; ++k) {
                swap_(s.ls_ed[k], s.dl_ed[k]);
                swap_(s.ls_ec[k], s.dl_ec[k]);
            }
        }
    }
    s.octx = 0;
    s.mode = M_SORT;
}

// _step_sort (:1725)
template <class S>
__device__ void step_sort(S& s, const Ctx& x) {
    sort_generic(s.act, s.act_n, s.od_done, s.od_found, s.od_min, s.rng_ca,
                 x.a.nd);
    if (s.act_n > 0 && s.dl_valid == 0)
        s.ca_min = max(s.od_min[s.act[0]], s.ca_min);
    if (s.act_n == 0) s.ca_done = s.dl_valid == 0 ? 1 : 0;
    s.mode = M_MAIN;
}

// ---- seeded-driver scheduler (EbwtSeededRangeSourceDriver) -----------------

// _step_sd (:1750)
template <class S>
__device__ void step_sd(S& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t gen = cfgO(x.a.cfg_o_flat0, s, o);
    const bool gdone = s.drv_done[gen] > 0, gfound = s.drv_found[gen] > 0;
    const bool fdone = s.ic_done[o] > 0, ffound = s.ic_found[o] > 0;
    if (gdone && fdone && !gfound && !ffound) {
        s.od_done[o] = 1;
        s.mode = M_ODEND;
        return;
    }
    if (gdone && !gfound) {
        s.drv_min[gen] = COST_INF;
        if (s.ic_min[o] > s.od_min[o]) {
            s.od_min[o] = s.ic_min[o];
            s.mode = M_ODEND;
            return;
        }
    }
    if (fdone && !ffound) {
        s.ic_min[o] = COST_INF;
        if (s.drv_min[gen] > s.od_min[o]) {
            s.od_min[o] = s.drv_min[gen];
            s.mode = M_ODEND;
            return;
        }
    }
    if (!(s.ic_min[o] <= s.drv_min[gen])) {
        if (gfound) {
            s.mode = M_SDGEN;
        } else {
            s.cur = gen;
            s.phase = PH_GEN;
            load_cur_rows(s, gen);
            s.mode = M_DADV;
        }
    } else {
        s.sdf_old = s.ic_min[o];
        s.mode = ffound ? M_SDFULL : M_ICADV;
    }
}

// _step_sdgen (:1802): on a seed partial, create a full extender (its
// set_query: premuts, N tally, ftab jump, first branch) and add it to the
// inner CostAware; then the generator min-cost propagation
template <class S>
__device__ void step_sdgen(S& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int L = x.L;
    const int32_t o = s.cur_o;
    const int32_t gen = cfgO(a.cfg_o_flat0, s, o);
    const bool gfound = s.drv_found[gen] > 0;
    const int32_t scost = s.rr[gen][2], sne = s.rr[gen][4];
    int32_t sed[3], sec[3];
    for (int k = 0; k < 3; ++k) {
        sed[k] = s.rr_ed[gen][k];
        sec[k] = s.rr_ec[gen][k];
    }
    if (gfound) s.drv_found[gen] = 0;
    const int32_t slot = s.ex_next[o];
    if (gfound && (slot >= PEX || sne > 3)) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    const bool ok = gfound;
    if (ok) {
        const int32_t fe = cfgO(a.cfg_o_exbase, s, o)
            + clampi(slot, 0, PEX - 1);
        s.ex_next[o] = slot + 1;
        const int32_t gdq = s.dqlen[gen];
        int32_t pm_m[3], pm_c[3];
        for (int k = 0; k < 3; ++k) {
            pm_m[k] = k < sne ? gdq - 1 - sed[k] : 0;
            pm_c[k] = sec[k];
            s.pm_m[fe][k] = pm_m[k];
            s.pm_c[fe][k] = pm_c[k];
        }
        s.pm_n[fe] = sne;
        const int32_t qlen = qlen_of(s, o);
        const int32_t s_seed = s.dd3[gen];
        s.dqlen[fe] = qlen;
        s.dd3[fe] = s_seed;
        s.dd5[fe] = s_seed >> 1;
        const int32_t iham = a.qual_order ? (scost & 0x3FFF) : 0;
        s.drv_nextid[fe] = 0;
        s.pm_min[fe] = 0;
        s.rng_rs[fe] = seed_of(s, o);
        const int32_t efw_e = cfgF(a.cfg_ebwt_fw, s, fe);
        const BtFM& fm = index_of(x, efw_e);
        const int fc = fm.ftab_chars;
        bool dead = false;
        int32_t ns_ftab = 0;
        uint32_t foff = 0;
        for (int d = 0; d < L; ++d) {
            const int32_t c = qd_at(s, x, fe, d);
            if (c == 4 && d < s_seed) dead = true;
            if (d < fc) {
                if (c == 4 && d < qlen) ns_ftab += 1;
                foff |= (uint32_t)(c > 3 ? 0 : c) << (2 * d);
            }
        }
        const bool use_ftab = ns_ftab == 0 && min(s_seed, qlen) >= fc;
        const int32_t ft = (int32_t)__ldg(fm.ftab_hi + foff);
        const int32_t fb = (int32_t)__ldg(fm.ftab_lo + foff + 1);
        const bool nonempty = fb > ft;
        const bool alive = !dead && qlen >= 4;
        const bool imm = alive && use_ftab && qlen == fc && nonempty;
        if (imm) {
            s.rr[fe][0] = ft; s.rr[fe][1] = fb; s.rr[fe][2] = scost;
            s.rr[fe][3] = scost >> 14; s.rr[fe][4] = sne;
            for (int k = 0; k < E_MAX; ++k) {
                s.rr_ed[fe][k] = k < 3 ? pm_m[k] : 0;
                s.rr_ec[fe][k] = k < 3 ? pm_c[k] : 0;
            }
        }
        const bool pushf = alive && use_ftab && qlen > fc && nonempty;
        const bool push0 = alive && !use_ftab;
        bool pushed = pushf || push0;
        const int cslot = free_slot(s);
        if (pushed && s.p_valid[cslot] > 0) {
            s.overflow = true;
            s.mode = M_DONE;
            return;
        }
        const int32_t blen0 = pushf ? fc : 0;
        if (pushed) {
            s.p_valid[cslot] = 1; s.p_drv[cslot] = fe; s.p_cost[cslot] = scost;
            s.p_ham[cslot] = iham; s.p_rdepth[cslot] = 0;
            s.p_len[cslot] = blen0;
            s.p_top[cslot] = pushf ? ft : 0; s.p_bot[cslot] = pushf ? fb : 0;
            s.p_curt[cslot] = 0; s.p_dly[cslot] = 0; s.p_dlyf[cslot] = 0;
            s.p_id[cslot] = 0; s.p_ne[cslot] = 0;
            s.p_d0[cslot] = s.p_d1[cslot] = s.p_d2[cslot] = s.p_d3[cslot]
                = s_seed;
            s.drv_nextid[fe] = 1;
            if (blen0 >= 0 && blen0 < L)
                x.meta[(size_t)cslot * L + blen0] = META_ALL_DEAD;
        }
        s.drv_done[fe] = (!pushed && !imm) ? 1 : 0;
        s.drv_found[fe] = imm ? 1 : 0;
        s.drv_min[fe] = scost;
        // inner add_source (min_cost = 0, then _sort_actives)
        s.ic_found[o] = 0;
        s.ic_done[o] = 0;
        int32_t actn = s.ic_actn[o];
        if (actn >= 0 && actn < PEX) s.ic_act[o][actn] = fe;
        actn += 1;
        sort_generic(s.ic_act[o], actn, s.drv_done, s.drv_found, s.drv_min,
                     s.ic_rng[o], PEX);
        s.ic_actn[o] = actn;
        s.ic_min[o] = actn > 0 ? max(s.drv_min[s.ic_act[o][0]], 0) : 0;
    }
    // generator min-cost propagation (not-do_full tail)
    const int32_t gmin = s.drv_min[gen];
    if (gmin > s.od_min[o]) {
        s.od_min[o] = gmin;
        if (!(s.ic_done[o] > 0)) s.od_min[o] = min(s.od_min[o], s.ic_min[o]);
    }
    s.mode = M_ODEND;
}

// _step_sdfull (:1966)
template <class S>
__device__ void step_sdfull(S& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t gen = cfgO(x.a.cfg_o_flat0, s, o);
    if (s.ic_found[o] > 0) {
        s.od_found[o] = 1;
        s.ic_found[o] = 0;
        s.od_rr[o][0] = s.il_top[o]; s.od_rr[o][1] = s.il_bot[o];
        s.od_rr[o][2] = s.il_cost[o]; s.od_rr[o][3] = s.il_strat[o];
        s.od_rr[o][4] = s.il_ne[o];
        for (int k = 0; k < E_MAX; ++k) {
            s.od_ed[o][k] = s.il_ed[o][k];
            s.od_ec[o][k] = s.il_ec[o][k];
        }
    }
    const int32_t icm = s.ic_min[o];
    if (icm > s.sdf_old) s.od_min[o] = min(icm, s.drv_min[gen]);
    s.mode = M_ODEND;
}

// _step_icadv (:1992)
template <class S>
__device__ void step_icadv(S& s) {
    const int32_t o = s.cur_o;
    if (s.ic_actn[o] == 0) {
        s.ic_done[o] = 1;
        s.mode = M_SDFULL;
        return;
    }
    const int32_t p = s.ic_act[o][0];
    s.cur = p;
    s.ic_pre = s.drv_min[p];
    if (s.drv_found[p] > 0) {
        s.mode = M_ICPOST;
    } else {
        s.phase = PH_FULL;
        load_cur_rows(s, p);
        s.mode = M_DADV;
    }
}

// _step_icpost (:2013)
template <class S>
__device__ void step_icpost(S& s) {
    const int32_t o = s.cur_o;
    const int32_t p = s.cur;
    if (s.drv_found[p] > 0) {
        s.il_top[o] = s.rr[p][0]; s.il_bot[o] = s.rr[p][1];
        s.il_cost[o] = s.rr[p][2]; s.il_strat[o] = s.rr[p][3];
        s.il_ne[o] = s.rr[p][4];
        for (int k = 0; k < E_MAX; ++k) {
            s.il_ed[o][k] = s.rr_ed[p][k];
            s.il_ec[o][k] = s.rr_ec[p][k];
        }
        s.ic_found[o] = 1;
        s.drv_found[p] = 0;
    }
    if (s.drv_done[p] > 0 || s.ic_pre != s.drv_min[p]) {
        sort_generic(s.ic_act[o], s.ic_actn[o], s.drv_done, s.drv_found,
                     s.drv_min, s.ic_rng[o], PEX);
        if (s.ic_actn[o] > 0)
            s.ic_min[o] = max(s.drv_min[s.ic_act[o][0]], s.ic_min[o]);
        else
            s.ic_done[o] = 1;
    }
    s.mode = M_SDFULL;
}

// _step_chase (:2056): one RangeChaser row, resolve + joinedToTextOff +
// sink (range_chaser.h:22; BestSink.report_hit)
template <class S>
__device__ void step_chase(S& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int32_t efw = cfgO(a.cfg_o_chase_efw, s, s.ls_drv);
    const BtFM& fm = index_of(x, efw);
    const int32_t spread = s.ls_bot - s.ls_top;
    int32_t ri = s.ch_r + s.ch_k;
    if (ri >= s.ls_bot) ri -= spread;
    int32_t off;
    if (a.dense) {
        off = (int32_t)__ldg(fm.sa + (uint32_t)ri);
    } else {
        // walk left to a marked row, one LF per transition
        // (reportChaseOne, ebwt.h:2727-2746)
        const int32_t row = s.r_walk == 0 ? ri : s.r_row;
        const int32_t jumps = s.r_walk == 0 ? 0 : s.r_jumps;
        const bool at_z = (uint32_t)row == fm.zoff;
        const int32_t omask = (1 << fm.off_rate) - 1;
        if (!((row & omask) == 0 || at_z)) {
            s.r_row = (int32_t)lf_row(fm, (uint32_t)row);
            s.r_jumps = jumps + 1;
            s.r_walk = 1;
            return;
        }
        s.r_row = row;
        s.r_jumps = jumps;
        s.r_walk = 0;
        off = at_z ? jumps
                   : (int32_t)__ldg(fm.offs + ((uint32_t)row >> fm.off_rate))
                       + jumps;
    }
    // joinedToTextOff (ebwt.h:2569-2629)
    const int32_t qlen = qlen_of(s, s.ls_drv);
    int32_t start = 0, upper = (int32_t)a.length, tidx = 0, toff0 = 0;
    if (a.nfrag != 1) {
        int lo = 0, hi = a.nfrag;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (a.rstarts[3 * mid] <= off) lo = mid + 1;
            else hi = mid;
        }
        const int elt = lo > 0 ? lo - 1 : a.nfrag - 1;
        start = (int32_t)a.rstarts[3 * elt];
        upper = elt + 1 < a.nfrag ? (int32_t)a.rstarts[3 * (elt + 1)]
                                  : (int32_t)a.length;
        tidx = (int32_t)a.rstarts[3 * elt + 1];
        toff0 = (int32_t)a.rstarts[3 * elt + 2];
    }
    const bool valid = off + qlen <= upper;
    int32_t fragoff = off - start;
    if (efw == 0) fragoff = (upper - start) - fragoff - 1 - (qlen - 1);
    const int32_t toff = fragoff + toff0;

    const int32_t newcount = s.count + 1;
    bool maxed = false, stop = false, irr = false;
    if (valid) {
        s.count = newcount;
        s.best_stratum = min(s.best_stratum, s.ls_strat);
        maxed = newcount > a.m_max;
        if (maxed) {
            s.result = 2;
            s.mode = M_DONE;
        } else {
            const int32_t nmms = s.ls_ne;
            if (s.nhits >= H_MAX || nmms > MM_SLOTS) {
                s.overflow = true;
                s.mode = M_DONE;
                return;
            }
            int32_t* h = x.hits + (size_t)s.nhits * HIT_W;
            h[0] = tidx; h[1] = toff;
            h[2] = cfgO(a.cfg_o_fw, s, s.ls_drv) | (efw << 1);
            h[3] = spread - 1; h[4] = s.ls_strat; h[5] = s.ls_cost;
            h[6] = nmms; h[7] = qlen;
            for (int k = 0; k < MM_SLOTS; ++k) {
                h[8 + k] = k < E_MAX ? s.ls_ed[k] : 0;
                h[8 + MM_SLOTS + k] = k < E_MAX ? s.ls_ec[k] : 0;
            }
            s.nhits += 1;
            stop = newcount == a.n_k
                && (a.m_max == INF32 || a.m_max < a.n_k);
            if (stop) {
                s.result = 1;
                s.mode = M_DONE;
            } else {
                irr = irrelevant(s, x, s.ls_cost);
            }
        }
    }
    const bool go_on = !maxed && !stop && !irr;
    bool wrapped = false;
    if (go_on) {
        s.ch_k += 1;
        wrapped = s.ch_k >= spread;
    }
    if (irr || wrapped) {
        s.ca_found = 0;
        s.mode = M_MAIN;
    }
}

// The lane's state from pack_init's row (init_layout's order) and the
// constants of _init_state (:647); a paired row ends with the per-outer
// read lengths and seeds and the per-flat-driver RNG seeds (:660-681).
template <class S>
__device__ void init_lane(S& s, const Ctx& x, const int32_t* r,
                          uint32_t seed) {
    const BestArgs& a = x.a;
    const int nd = a.nd, ndt = a.ndt;
    s = S{};
    int32_t* pv[17] = {s.p_valid, s.p_drv, s.p_cost, s.p_ham, s.p_rdepth,
                       s.p_len, s.p_top, s.p_bot, s.p_curt, s.p_dly,
                       s.p_dlyf, s.p_id, s.p_ne, s.p_d0, s.p_d1, s.p_d2,
                       s.p_d3};
    for (int k = 0; k < 17; ++k)
        for (int j = 0; j < NBR; ++j) pv[k][j] = *r++;
    int32_t* dv[8] = {s.drv_done, s.drv_found, s.drv_min, s.drv_adj,
                      s.drv_nextid, s.dqlen, s.dd5, s.dd3};
    for (int k = 0; k < 8; ++k)
        for (int f = 0; f < ndt; ++f) dv[k][f] = *r++;
    for (int f = 0; f < ndt; ++f)
        for (int k = 0; k < 5; ++k) s.rr[f][k] = *r++;
    int32_t* ov[4] = {s.od_done, s.od_found, s.od_min, s.act};
    for (int k = 0; k < 4; ++k)
        for (int o = 0; o < nd; ++o) ov[k][o] = *r++;
    s.act_n = *r++;
    s.rng_ca = (uint32_t)*r++;
    s.ca_min = *r++;
    s.qlen = *r++;
    s.cfg0f = *r++;
    s.cfg0o = *r++;
    s.mode = M_MAIN;
    s.rng_al = s.seed = seed;
    for (int f = 0; f < S::NDT_MAX; ++f) s.rng_rs[f] = seed;
    for (int o = 0; o < S::ND_MAX; ++o) s.ic_rng[o] = seed;
    if constexpr (S::PAIRED) {
        for (int o = 0; o < nd; ++o) s.qlen_o[o] = *r++;
        for (int o = 0; o < nd; ++o) s.ic_rng[o] = s.seed_o[o] =
            (uint32_t)*r++;
        for (int f = 0; f < ndt; ++f) s.rng_rs[f] = (uint32_t)*r++;
    }
    s.best_stratum = 999;
    s.bt = a.maxbts;
}

// the width of pack_init's per-lane row
__host__ __device__ __forceinline__ int init_width(int nd, int ndt,
                                                   bool paired) {
    return 17 * NBR + 13 * ndt + 4 * nd + 6 + (paired ? 2 * nd + ndt : 0);
}

template <class S>
__global__ void __launch_bounds__(kThreads)
best_machine_kernel(const BestArgs a) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const int L = a.L;
    const Ctx x{a, L, a.rows_qp + (size_t)b * a.ndt * 2 * L,
                a.ptb + (size_t)b * NBR * 2 * L,
                a.meta + (size_t)b * NBR * L,
                a.hits + (size_t)b * H_MAX * HIT_W};
    const int ni = init_width(a.nd, a.ndt, S::PAIRED);
    for (int k = 0; k < NBR * 2 * L; ++k) x.ptb[k] = 0;
    for (int k = 0; k < NBR * L; ++k) x.meta[k] = META_ALL_DEAD;
    for (int k = 0; k < H_MAX * HIT_W; ++k) x.hits[k] = 0;
    S s;
    init_lane(s, x, a.init + (size_t)b * ni, (uint32_t)a.seeds[b]);
    int64_t t = 0;
    for (; s.mode != M_DONE && !s.overflow && t < a.max_transitions; ++t) {
        switch (s.mode) {
            case M_MAIN: step_main(s, x); break;
            case M_CADV: step_cadv(s, x); break;
            case M_SFX: step_sfx(s); break;
            case M_SD: step_sd(s, x); break;
            case M_ICADV: step_icadv(s); break;
            case M_OADV: step_oadv(s, x); break;
            case M_DADV: step_dadv(s); break;
            case M_EXT: step_ext(s, x); break;
            case M_SPP: step_spp(s, x); break;
            case M_DEND: step_dend(s); break;
            case M_SDGEN: step_sdgen(s, x); break;
            case M_ICPOST: step_icpost(s); break;
            case M_SDFULL: step_sdfull(s, x); break;
            case M_ODEND: step_odend(s, x); break;
            case M_CPOST: step_cpost(s, x); break;
            case M_SFXEND: step_sfxend(s); break;
            case M_SORT: step_sort(s, x); break;
            case M_CHASE: step_chase(s, x); break;
            default: s.overflow = true; break;
        }
    }
    a.result[b] = s.result;
    a.overflow[b] = (s.overflow || s.mode != M_DONE) ? 1 : 0;
    a.count[b] = s.count;
    a.best_stratum[b] = s.best_stratum;
    a.nhits[b] = s.nhits;
    a.mode[b] = s.mode;
    a.steps[b] = (int32_t)t;
}

// K11: one thread per (lane, hit slot): slot s of the lane goes to row
// hoff[lane] + s of the packed rows when s < nhits[lane]; slot 0 also
// writes the lane's five scalars into the [5][B] head.
__global__ void __launch_bounds__(128)
best_pack_kernel(const int32_t* __restrict__ result,
                 const uint8_t* __restrict__ overflow,
                 const int32_t* __restrict__ count,
                 const int32_t* __restrict__ best_stratum,
                 const int32_t* __restrict__ nhits,
                 const int32_t* __restrict__ hits,
                 const int64_t* __restrict__ hoff, int B,
                 int32_t* __restrict__ out) {
    const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= (long)B * H_MAX) return;
    const int b = (int)(r / H_MAX), slot = (int)(r % H_MAX);
    if (slot == 0) {
        out[b] = result[b];
        out[B + b] = overflow[b] ? 1 : 0;
        out[2 * B + b] = count[b];
        out[3 * B + b] = best_stratum[b];
        out[4 * B + b] = nhits[b];
    }
    if (slot < nhits[b]) {
        // word copies: the rows start 5 * B words into the buffer, which
        // is 16-byte aligned only when B is a multiple of 4
        const int32_t* src = hits + ((size_t)b * H_MAX + slot) * HIT_W;
        int32_t* dst = out + 5 * (size_t)B + (hoff[b] + slot) * HIT_W;
        for (int k = 0; k < HIT_W; ++k) dst[k] = src[k];
    }
}

}  // namespace

extern "C" {

// the instantiation by the run: the paired one for K14
int bt_best_machine(const BestArgs* a, void* stream) {
    const unsigned grid = (a->B + kThreads - 1) / kThreads;
    if (a->paired) {
        if (a->nd > StPaired::ND_MAX || a->ndt > StPaired::NDT_MAX)
            return (int)cudaErrorInvalidValue;
        best_machine_kernel<StPaired><<<grid, kThreads, 0,
                                        (cudaStream_t)stream>>>(*a);
    } else {
        if (a->nd > StSingle::ND_MAX || a->ndt > StSingle::NDT_MAX)
            return (int)cudaErrorInvalidValue;
        best_machine_kernel<StSingle><<<grid, kThreads, 0,
                                        (cudaStream_t)stream>>>(*a);
    }
    return (int)cudaGetLastError();
}

int bt_best_pack(const void* result, const void* overflow, const void* count,
                 const void* best_stratum, const void* nhits,
                 const void* hits, const void* hoff, int B, void* out,
                 void* stream) {
    const long n = (long)B * H_MAX;
    best_pack_kernel<<<(unsigned)((n + 127) / 128), 128, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)result, (const uint8_t*)overflow,
        (const int32_t*)count, (const int32_t*)best_stratum,
        (const int32_t*)nhits, (const int32_t*)hits, (const int64_t*)hoff,
        B, (int32_t*)out);
    return (int)cudaGetLastError();
}

// the width of pack_init's per-lane row for nd outer / ndt flat drivers
int bt_best_init_width(int nd, int ndt, int paired) {
    return init_width(nd, ndt, paired != 0);
}

// the local memory (the lane state's stack) per thread of an
// instantiation, which the runtime reserves for every resident thread;
// -1 on an error
int bt_best_local_bytes(int paired) {
    cudaFuncAttributes at;
    const cudaError_t e = paired
        ? cudaFuncGetAttributes(&at, best_machine_kernel<StPaired>)
        : cudaFuncGetAttributes(&at, best_machine_kernel<StSingle>);
    return e == cudaSuccess ? (int)at.localSizeBytes : -1;
}

}  // extern "C"
