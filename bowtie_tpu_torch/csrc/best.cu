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
// K10 runs one thread per lane, at most a warp a block (the wrapper's
// machine_shape takes 16 lanes a block, fewer for batches too small to
// give every SM a block of 16).  The JAX version applies each of
// _machine_step's 18 sub-steps (MAIN, CADV, SFX, SD, ICADV, OADV, DADV,
// EXT, SPP, DEND, SDGEN, ICPOST, SDFULL, ODEND, CPOST, SFXEND, SORT,
// CHASE) to the lanes in its mode, once per lockstep iteration; here each
// thread applies its lane's transitions one after another until M_DONE,
// a pass of its loop applying them in a fixed order of modes (MAIN,
// CHASE up to kChasePerPass times, CADV, SFX, OADV, SD, ICADV, DADV, EXT
// and SPP up to kExtPerPass times each, DEND, SDGEN, ICPOST, SDFULL,
// ODEND, CPOST, SFXEND, SORT) while the lane's mode is the next, so that
// the lanes of a warp in one mode step together and a lane's usual chain
// (CADV, OADV, DADV, EXT, SPP, ..., DEND, ODEND, CPOST, SORT) is one
// pass.  Each function below is the scalar form of the JAX sub-step of
// the same name: the same reads, the same writes under the same
// conditions, the same RNG draws in the same order (rng_al for the
// chase's first row, rng_ca for CostAware's sort ties and the strandFix
// swap, rng_rs per flat driver for splits and pick_edit, ic_rng per outer
// driver for the inner CostAware's sorts).  A sub-step reads and writes
// only its own lane, so the per-lane result is the lockstep one.  Step
// budget: one iteration applies each sub-step at most once to a lane, so a
// lane gets max_transitions = 18 * max_steps, each transition counted;
// whatever the lockstep version finishes within budget, this finishes
// too.  A lane stops at the transition that raises `overflow` (its result
// goes to the host engine).
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
// mate has no live outer (mate elimination).  The kernel is templated on
// `paired` alone: every size follows the run's nd outer and ndt flat
// drivers (at most the config tables' 16 and 48), so the CLI's -n 2
// merged DAG (12 / 28) pays for 12 / 28.
//
// Rows are int32 here, as in the JAX machine, which compares them signed:
// the aligner refuses indexes of 2^31 rows or more.  The sentinels
// COST_INF = 0xFFFF and META_ALL_DEAD are the JAX ones.
//
// Where a lane lives (no stack frame):
//   registers - the lane scalars (Lane), the pool's valid slots as a
//               16-bit mask (every slot loop visits those only), and the
//               current flat driver's premuts, split RNG, next branch id
//               and pool minimum between load_cur_rows and DEND, which
//               writes them back (no other transition runs in between:
//               DADV, EXT, SPP);
//   shared    - 32-bit words interleaved by lane (word w of thread t at
//               w * blockDim.x + t): the branch pool (13 scalar words a
//               slot, its bounds d0-d3 as int16 pairs, its six edit
//               depths as int16 pairs and six edit codes as nibbles:
//               depths stay under the row width, codes under 4), the
//               outer CostAware's active list, eight words to pick a
//               code's top or bottom, or a block's word, from (an index
//               into a register array would put it on the stack), and,
//               for rows up to kOnchipL positions, each slot's 64-bit
//               mask of the positions whose meta is not eliminated and
//               the pool's meta [NBR][L] as 16-bit words (13 bits used:
//               elimination bits, quallo, the fchr flag); the block's
//               copy of the arguments (config tables, the two indexes);
//   global    - a per-lane scratch column of the run's per-flat-driver
//               (34 words) and per-outer (47, paired 49) blocks, word w of
//               lane b at w * B + b, so that a warp reading one field of
//               one driver reads one line; ptb [NBR][2L] (each consumed
//               position's top and bottom); beyond kOnchipL the meta as
//               [NBR][L] 16-bit words; the hit records in the output.
// Only what a transition can read before writing is initialised: the
// scratch column, the pool from pack_init's row, every meta word, and
// ptb's position 0 of each slot (the one position SPP can read that the
// slot's branch did not write: pos 0 when no position is eligible; every
// eligible position was consumed, and written, by the branch, whose
// length stays under L).
//
// What bounds K10 (PERF.md): a launch lasts about as long as its
// slowest warp, and a warp about twice its slowest lane's chain of
// transitions.  Most transitions (86 %) are EXT and SPP; each is a few
// hundred dependent integer instructions (a front search over the valid
// slots, the rank arithmetic of a pair of ranks, fm.cuh rank4, whose
// 32-byte occ+word sectors come from L2) and, where a branch splits, a
// second pair of ranks on the split position's range.  Not bandwidth,
// not arithmetic throughput: latency and divergence.  The design keeps
// the state the transitions scan on chip (the scans visit live
// positions and valid slots only), the rest sized to the run and read by
// line, EXT's ranks issued beside its by-depth row's loads rather than
// after them, SPP reusing the front an extending EXT leaves, and the
// modes in a fixed order a pass.  K11 is a copy, bound by the bytes of
// the rows it moves.
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
    uint16_t* meta;             // scratch [B][NBR][L] (L > kOnchipL only)
    int32_t* scratch;           // [scratch_words(nd, ndt, paired)][B]
    int32_t *result, *overflow, *count, *best_stratum, *nhits, *hits, *mode,
        *steps;
};
// passed by value: within the classic 4 KB kernel-parameter limit
static_assert(sizeof(BestArgs) <= 4096, "BestArgs exceeds 4 KB");

namespace {

// K10's launch shape (best_device.machine_shape chooses within it): at
// most a warp a block; meta in shared memory up to kOnchipL positions.
constexpr int kMaxLanes = 32;
constexpr int kOnchipL = 64;
// a loop pass applies up to this many EXT-SPP pairs, and CHASEs, in a row
// (8 pairs ran faster than 2 or 4: PERF.md)
constexpr int kExtPerPass = 8;
constexpr int kChasePerPass = 4;

// The pool's scalar fields (pack_init's P_KEYS order), a word a slot;
// the four backtracking bounds d0-d3 (depths, at most the read length) as
// int16 pairs.
enum PoolField {
    P_VALID, P_DRV, P_COST, P_HAM, P_RDEPTH, P_LEN, P_TOP, P_BOT, P_CURT,
    P_DLY, P_DLYF, P_ID, P_NE, P_D01, P_D23, NPF
};
constexpr int kPinit = 17;                // pack_init's pool columns
// A lane's shared words (in units of its interleaved words)
constexpr int kPedW = NPF * NBR;          // edit depths, 3 words a slot
constexpr int kPecW = kPedW + 3 * NBR;    // edit codes, a word a slot
constexpr int kPickW = kPecW + NBR;       // 8 pick words
constexpr int kActW = kPickW + 8;         // the active list, nd words
// then, on chip, each slot's 64-bit mask of the positions whose meta
// has META_ELIM clear (2 words a slot), and the meta (NBR * L halves)

__host__ __device__ constexpr int lane_words(int L, int nd, bool onchip) {
    return kActW + nd + (onchip ? 2 * NBR + 8 * L : 0);
}

// The per-flat-driver fields of the scratch column (the first eight in
// pack_init's order), then the per-outer ones.
enum FlatField {
    F_DONE, F_FOUND, F_MIN, F_ADJ, F_NEXTID, F_DQLEN, F_DD5, F_DD3,
    F_RR, F_PMMIN = F_RR + 5, F_PMN, F_RNG, F_RRED,
    F_RREC = F_RRED + E_MAX, F_PMM = F_RREC + E_MAX, F_PMC = F_PMM + 3,
    NFF = F_PMC + 3
};
enum OuterField {
    O_DONE, O_FOUND, O_MIN, O_EXNEXT, O_RR, O_ED = O_RR + 5,
    O_EC = O_ED + E_MAX, O_ICACT = O_EC + E_MAX, O_ICACTN = O_ICACT + PEX,
    O_ICFOUND, O_ICDONE, O_ICMIN, O_ICRNG, O_IL, O_ILED = O_IL + 5,
    O_ILEC = O_ILED + E_MAX, O_QLEN = O_ILEC + E_MAX, O_SEED, NOF_PAIRED
};

__host__ __device__ constexpr int scratch_words(int nd, int ndt,
                                                bool paired) {
    return NFF * ndt + (paired ? NOF_PAIRED : O_QLEN) * nd;
}

// one lane's registers (best_device.py:647 _init_state's lane scalars)
struct Lane {
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
    // the pool's valid slots, a bit each (the pool's p_valid)
    uint32_t vmask;
    // the front an extending EXT leaves to its SPP (-1: none)
    int32_t spp_fs;
    // flat driver `cur`'s premuts, split RNG, next branch id and pool
    // minimum, from load_cur_rows to step_dend
    int32_t c_pmn, c_pmm[3], c_pmc[3], c_nextid, c_pmmin;
    uint32_t c_rng;
};

// per-thread view of the arguments
struct Ctx {
    const BestArgs& a;       // the block's shared copy
    int L, nt, nd, ndt;
    size_t B;
    bool onchip;
    const int8_t* rows;      // this lane's [ndt][2L]
    int32_t* ptb;            // this lane's [NBR][2L]
    uint16_t* gmeta;         // this lane's [NBR][L] (global layout)
    int32_t* g;              // this lane's scratch column
    int32_t* hits;           // this lane's [H_MAX][HIT_W]
    int32_t* sh;             // this lane's shared word 0
    int lw, mw;              // its first live-mask word, first meta word
};

__device__ __forceinline__ int32_t& shw(const Ctx& x, int w) {
    return x.sh[w * x.nt];
}

// pool field f of slot j
__device__ __forceinline__ int32_t& PF(const Ctx& x, int f, int j) {
    return shw(x, f * NBR + j);
}

// flat driver f's field, outer driver o's field
__device__ __forceinline__ int32_t& DF(const Ctx& x, int field, int f) {
    return x.g[(size_t)(field * x.ndt + f) * x.B];
}

__device__ __forceinline__ int32_t& OF(const Ctx& x, int field, int o) {
    return x.g[(size_t)(NFF * x.ndt + field * x.nd + o) * x.B];
}

__device__ __forceinline__ int32_t& ACT(const Ctx& x, int i) {
    return shw(x, kActW + i);
}

// backtracking bound k (0-3) of slot j
__device__ __forceinline__ int32_t pd_get(const Ctx& x, int j, int k) {
    const int32_t w = PF(x, P_D01 + (k >> 1), j);
    return (k & 1) ? (w >> 16) : (int32_t)(int16_t)(w & 0xFFFF);
}

__device__ __forceinline__ int32_t pack2(int32_t lo, int32_t hi) {
    return (int32_t)(((uint32_t)lo & 0xFFFFu) | ((uint32_t)hi << 16));
}

__device__ __forceinline__ void pd_set(const Ctx& x, int j, int32_t d0,
                                       int32_t d1, int32_t d2, int32_t d3) {
    PF(x, P_D01, j) = pack2(d0, d1);
    PF(x, P_D23, j) = pack2(d2, d3);
}

__device__ __forceinline__ int32_t meta_get(const Ctx& x, int slot, int ii) {
    const int k = slot * x.L + ii;
    if (x.onchip) {
        const uint32_t w = (uint32_t)shw(x, x.mw + (k >> 1));
        return (int32_t)((k & 1) ? (w >> 16) : (w & 0xFFFFu));
    }
    return x.gmeta[k];
}

// a meta write; on chip it keeps the slot's live mask in step
__device__ __forceinline__ void meta_set(const Ctx& x, int slot, int ii,
                                         int32_t v) {
    const int k = slot * x.L + ii;
    if (x.onchip) {
        reinterpret_cast<uint16_t*>(&shw(x, x.mw + (k >> 1)))[k & 1]
            = (uint16_t)v;
        int32_t& w = shw(x, x.lw + 2 * slot + (ii >> 5));
        const uint32_t bit = 1u << (ii & 31);
        w = (int32_t)((v & META_ELIM) ? ((uint32_t)w & ~bit)
                                      : ((uint32_t)w | bit));
    } else {
        x.gmeta[k] = (uint16_t)v;
    }
}

// f(ii, meta) for each position ii of slot in [lo, hi] whose meta has
// META_ELIM clear, in increasing order, until f returns true: on chip the
// set bits of the slot's live mask, else every position's meta
template <class F>
__device__ __forceinline__ void for_live(const Ctx& x, int slot, int lo,
                                         int hi, F f) {
    if (lo > hi) return;
    if (x.onchip) {
        const uint64_t live =
            (uint64_t)(uint32_t)shw(x, x.lw + 2 * slot)
            | ((uint64_t)(uint32_t)shw(x, x.lw + 2 * slot + 1) << 32);
        uint64_t m = live & (~0ull >> (63 - hi)) & (~0ull << lo);
        while (m) {
            const int ii = __ffsll((long long)m) - 1;
            m &= m - 1;
            if (f(ii, meta_get(x, slot, ii))) return;
        }
    } else {
        for (int ii = lo; ii <= hi; ++ii) {
            const int32_t me = meta_get(x, slot, ii);
            if ((me & META_ELIM) == 0 && f(ii, me)) return;
        }
    }
}

// slot j's six edit depths and codes, into and out of registers
__device__ __forceinline__ void load_edits(const Ctx& x, int j,
                                           int32_t (&ed)[E_MAX],
                                           int32_t (&ec)[E_MAX]) {
#pragma unroll
    for (int w = 0; w < 3; ++w) {
        const int32_t v = shw(x, kPedW + 3 * j + w);
        ed[2 * w] = (int32_t)(int16_t)(v & 0xFFFF);
        ed[2 * w + 1] = v >> 16;
    }
    const uint32_t c = (uint32_t)shw(x, kPecW + j);
#pragma unroll
    for (int k = 0; k < E_MAX; ++k) ec[k] = (int32_t)((c >> (4 * k)) & 0xFu);
}

__device__ __forceinline__ void store_edits(const Ctx& x, int j,
                                            const int32_t (&ed)[E_MAX],
                                            const int32_t (&ec)[E_MAX]) {
#pragma unroll
    for (int w = 0; w < 3; ++w)
        shw(x, kPedW + 3 * j + w) = (int32_t)(
            ((uint32_t)ed[2 * w] & 0xFFFFu)
            | ((uint32_t)ed[2 * w + 1] << 16));
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < E_MAX; ++k) c |= ((uint32_t)ec[k] & 0xFu) << (4 * k);
    shw(x, kPecW + j) = (int32_t)c;
}

// the four codes' tops and bottoms, kept where a code can pick them
__device__ __forceinline__ void put_pick(const Ctx& x, const int32_t (&t)[4],
                                         const int32_t (&b)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        shw(x, kPickW + j) = t[j];
        shw(x, kPickW + 4 + j) = b[j];
    }
}

__device__ __forceinline__ int32_t pick_top(const Ctx& x, int c) {
    return shw(x, kPickW + c);
}

__device__ __forceinline__ int32_t pick_bot(const Ctx& x, int c) {
    return shw(x, kPickW + 4 + c);
}

// fm.cuh lf_row, the row's own code picked from the pick words (an
// index into the block's words in registers would put them on the
// stack)
__device__ __forceinline__ uint32_t lf_row_picked(const Ctx& x,
                                                  const BtFM& fm,
                                                  uint32_t i) {
    const uint32_t block = i / kOccBlock, rem = i % kOccBlock;
    const uint4 o = __ldg(fm.occ + block);
    uint32_t w[kWordsPerBlock];
    block_words(fm, block, w);
#pragma unroll
    for (int j = 0; j < kWordsPerBlock; ++j) shw(x, kPickW + j) = (int32_t)w[j];
    const uint32_t c =
        ((uint32_t)shw(x, kPickW + (int)(rem >> 4)) >> (2 * (rem & 15))) & 3u;
    const uint32_t corr = (c == 0 && i > fm.zoff) ? 1u : 0u;
    return fchr_get(fm, c) + occ_get(o, c) + count_in_block(w, c, rem)
        - corr;
}

__device__ __forceinline__ const BtFM& index_of(const Ctx& x, int32_t efw) {
    return efw > 0 ? x.a.fw : x.a.bw;
}

// the read length and RNG seed of outer driver o's mate
template <bool PAIRED>
__device__ __forceinline__ int32_t qlen_of(const Lane& s, const Ctx& x,
                                           int32_t o) {
    if constexpr (PAIRED) return OF(x, O_QLEN, o);
    else return s.qlen;
}

template <bool PAIRED>
__device__ __forceinline__ uint32_t seed_of(const Lane& s, const Ctx& x,
                                            int32_t o) {
    if constexpr (PAIRED) return (uint32_t)OF(x, O_SEED, o);
    else return s.seed;
}

// config of flat driver f / outer driver o of the lane's own DAG
// (_cfgF / _cfgO, :854-866), from the block's shared copy
__device__ __forceinline__ int32_t cfgF(const int32_t* table, const Lane& s,
                                        int32_t f) {
    return table[s.cfg0f + f];
}

__device__ __forceinline__ int32_t cfgO(const int32_t* table, const Lane& s,
                                        int32_t o) {
    return table[s.cfg0o + o];
}

__device__ __forceinline__ int32_t clampi(int32_t v, int32_t lo,
                                          int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// v[i] of a 3-entry register array, i in [0, 2]
__device__ __forceinline__ int32_t sel3(const int32_t (&v)[3], int i) {
    return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

// the by-depth code of flat driver f at depth d: its static row with its
// seed-stage premuts (pmn, pmm, pmc) applied (_derive_qd, :891)
__device__ __forceinline__ int32_t qd_with(const Ctx& x, int f, int d,
                                           int32_t pmn,
                                           const int32_t (&pmm)[3],
                                           const int32_t (&pmc)[3]) {
    int32_t c = __ldg(x.rows + (size_t)f * 2 * x.L + d);
#pragma unroll
    for (int k = 0; k < 3; ++k)
        if (pmn > k && d == pmm[k]) c = pmc[k];
    return c;
}

__device__ __forceinline__ int32_t pend_at(const Ctx& x, int f, int d) {
    return __ldg(x.rows + (size_t)f * 2 * x.L + x.L + d);
}

// NBestFirstStrat::irrelevantCost (hit.h:1124-1131)
__device__ __forceinline__ bool irrelevant(const Lane& s, const Ctx& x,
                                           int32_t cost) {
    return x.a.strata && s.count > 0 && (cost >> 14) > s.best_stratum;
}

// the quartets of both range ends on index efw, as the JAX machine's
// _lf4pair gives them (fm.cuh lf4pair)
__device__ __forceinline__ void quartets(const BtFM& fm, int32_t top,
                                         int32_t bot, int32_t (&t4)[4],
                                         int32_t (&b4)[4]) {
    uint32_t t[4], b[4];
    lf4pair(fm, (uint32_t)top, (uint32_t)bot, t, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        t4[j] = (int32_t)t[j];
        b4[j] = (int32_t)b[j];
    }
}

// PathManager front (_front_select, :876): the eligible slot of driver
// cur with the least CostCompare key, the least id among equal keys, the
// first slot among equal ids; slot 0 when none is eligible (or when the
// least id is INF32: `picked` false).  One pass over the valid slots: a
// smaller key restarts the id search.
__device__ __forceinline__ int front_select(const Lane& s, const Ctx& x,
                                            int32_t cur, bool& nonempty,
                                            bool& picked) {
    int32_t k1min = INF32, best_id = INF32;
    int fs = 0;
    nonempty = false;
    for (uint32_t m = s.vmask; m; m &= m - 1) {
        const int j = __ffs((int)m) - 1;
        if (PF(x, P_DRV, j) != cur) continue;
        nonempty = true;
        const int32_t tip = PF(x, P_RDEPTH, j) + PF(x, P_LEN, j);
        const int32_t key1 = ((PF(x, P_COST, j) * 2 + PF(x, P_CURT, j)) << 8)
            | (255 - min(tip, 255));
        if (key1 < k1min) {
            k1min = key1;
            best_id = INF32;
            fs = 0;
        }
        const int32_t id = PF(x, P_ID, j);
        if (key1 == k1min && id < best_id) {
            best_id = id;
            fs = j;
        }
    }
    picked = best_id != INF32;
    return fs;
}

__device__ __forceinline__ bool drv_has_branch(const Lane& s, const Ctx& x,
                                               int32_t cur) {
    for (uint32_t m = s.vmask; m; m &= m - 1)
        if (PF(x, P_DRV, __ffs((int)m) - 1) == cur) return true;
    return false;
}

// the first free pool slot (slot 0 when the pool is full)
__device__ __forceinline__ int free_slot(const Lane& s) {
    const uint32_t fr = ~s.vmask & ((1u << NBR) - 1);
    return fr ? __ffs((int)fr) - 1 : 0;
}

__device__ __forceinline__ bool slot_valid(const Lane& s, int j) {
    return (s.vmask >> j) & 1u;
}

__device__ __forceinline__ void set_valid(Lane& s, int j, bool v) {
    s.vmask = v ? (s.vmask | (1u << j)) : (s.vmask & ~(1u << j));
}

// the curtail/split cost of position ii of a branch (_meta_costs,
// :1228): COST_INF where the position is not eligible
__device__ __forceinline__ int32_t meta_cost(const Lane& s, const Ctx& x,
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
// of K entries (get/put: entry i of the list) whose sources are dead
// (done, nothing found) or carry a min cost (minof): selection sort with a
// draw per tie
template <class Get, class Put, class Dead, class MinOf>
__device__ __forceinline__ void sort_generic(Get get, Put put,
                                             int32_t& act_n, Dead dead,
                                             MinOf minof, uint32_t& rng,
                                             int K) {
    int32_t i = 0;
#pragma unroll 1
    for (int t = 0; t < 2 * K; ++t) {
        if (!(i < act_n)) break;
        const int32_t cur = get(clampi(i, 0, K - 1));
        if (dead(cur)) {
#pragma unroll 1
            for (int c = i; c < K - 1; ++c) put(c, get(c + 1));
            act_n -= 1;
            continue;
        }
        int32_t min_cost = minof(cur), min_off = i;
#pragma unroll 1
        for (int joff = 1; joff < K; ++joff) {
            const int32_t j = i + joff;
            if (!(j < act_n)) continue;
            const int32_t cj = get(clampi(j, 0, K - 1));
            if (dead(cj)) continue;
            const int32_t cost_j = minof(cj);
            if (cost_j < min_cost) {
                min_cost = cost_j;
                min_off = j;
            } else if (cost_j == min_cost) {
                if (rng_next(rng) & 0x1000) min_off = j;
            }
        }
        if (min_off != i) {
            const int ia = clampi(i, 0, K - 1), ib = clampi(min_off, 0, K - 1);
            const int32_t vi = get(ia), vm = get(ib);
            put(ia, vm);
            put(ib, vi);
        }
        i += 1;
    }
}

// the outer CostAware's sort over the active list (shared) by the
// outers' done/found/min
__device__ __forceinline__ void sort_outer(Lane& s, const Ctx& x) {
    sort_generic(
        [&](int i) { return ACT(x, i); },
        [&](int i, int32_t v) { ACT(x, i) = v; }, s.act_n,
        [&](int32_t c) {
            return OF(x, O_DONE, c) > 0 && OF(x, O_FOUND, c) == 0;
        },
        [&](int32_t c) { return OF(x, O_MIN, c); }, s.rng_ca, x.nd);
}

// outer o's inner CostAware sort over its extenders (flat drivers)
__device__ __forceinline__ void sort_inner(const Ctx& x, int32_t o,
                                           int32_t& actn) {
    uint32_t rng = (uint32_t)OF(x, O_ICRNG, o);
    sort_generic(
        [&](int i) { return OF(x, O_ICACT + i, o); },
        [&](int i, int32_t v) { OF(x, O_ICACT + i, o) = v; }, actn,
        [&](int32_t c) {
            return DF(x, F_DONE, c) > 0 && DF(x, F_FOUND, c) == 0;
        },
        [&](int32_t c) { return DF(x, F_MIN, c); }, rng, PEX);
    OF(x, O_ICRNG, o) = (int32_t)rng;
}

// flat driver f becomes the current one: its row bounds, and its
// premuts, split RNG, next id and pool minimum into registers
__device__ __forceinline__ void load_cur_rows(Lane& s, const Ctx& x,
                                              int32_t f) {
    s.d5_cur = DF(x, F_DD5, f);
    s.d3_cur = DF(x, F_DD3, f);
    s.qlen_cur = DF(x, F_DQLEN, f);
    s.c_pmn = DF(x, F_PMN, f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        s.c_pmm[k] = DF(x, F_PMM + k, f);
        s.c_pmc[k] = DF(x, F_PMC + k, f);
    }
    s.c_rng = (uint32_t)DF(x, F_RNG, f);
    s.c_nextid = DF(x, F_NEXTID, f);
    s.c_pmmin = DF(x, F_PMMIN, f);
}

__device__ __forceinline__ void copy_outer_range(Lane& s, const Ctx& x,
                                                 bool to_ls, int32_t o) {
    const int32_t top = OF(x, O_RR, o), bot = OF(x, O_RR + 1, o);
    const int32_t cost = OF(x, O_RR + 2, o), strat = OF(x, O_RR + 3, o);
    const int32_t ne = OF(x, O_RR + 4, o);
    if (to_ls) {
        s.ls_drv = o; s.ls_top = top; s.ls_bot = bot; s.ls_cost = cost;
        s.ls_strat = strat; s.ls_ne = ne;
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            s.ls_ed[k] = OF(x, O_ED + k, o);
            s.ls_ec[k] = OF(x, O_EC + k, o);
        }
    } else {
        s.dl_drv = o; s.dl_top = top; s.dl_bot = bot; s.dl_cost = cost;
        s.dl_strat = strat; s.dl_ne = ne;
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            s.dl_ed[k] = OF(x, O_ED + k, o);
            s.dl_ec[k] = OF(x, O_EC + k, o);
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
template <bool PAIRED>
__device__ __forceinline__ void record_range(Lane& s, const Ctx& x) {
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
        h[7] = qlen_of<PAIRED>(s, x, s.ls_drv);
#pragma unroll
        for (int k = 0; k < MM_SLOTS; ++k) {
            h[8 + k] = k == MM_SLOTS - 1 ? s.pre_min
                                         : (k < E_MAX ? s.ls_ed[k] : 0);
            h[8 + MM_SLOTS + k] = k < E_MAX ? s.ls_ec[k] : 0;
        }
        s.nhits += 1;
        s.ca_found = 0;
        if (a.rec_cap >= 0 && s.nhits >= a.rec_cap) s.mode = M_DONE;
        return;
    }
    s.pre_min = s.ca_min;
    s.mode = s.ca_done > 0 ? M_DONE : M_CADV;
}

// _step_main (:1030)
template <bool PAIRED>
__device__ __forceinline__ void step_main(Lane& s, const Ctx& x) {
    if (x.a.record) {
        record_range<PAIRED>(s, x);
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
template <bool PAIRED>
__device__ __forceinline__ void step_cadv(Lane& s, const Ctx& x) {
    const bool has_act = s.act_n > 0;
    const int32_t act0 = ACT(x, 0);
    if (s.dl_valid > 0) {
        s.ls_drv = s.dl_drv; s.ls_top = s.dl_top; s.ls_bot = s.dl_bot;
        s.ls_cost = s.dl_cost; s.ls_strat = s.dl_strat; s.ls_ne = s.dl_ne;
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            s.ls_ed[k] = s.dl_ed[k];
            s.ls_ec[k] = s.dl_ec[k];
        }
        s.dl_valid = 0;
        s.ca_found = 1;
        if (has_act) s.ca_min = max(OF(x, O_MIN, act0), s.ca_min);
        else s.ca_done = 1;
        s.mode = M_MAIN;
        return;
    }
    if constexpr (PAIRED) {
        // (:1141-1159) with no delayed range pending, the merged driver
        // is done once either mate has no not-done outer left
        bool alive1 = false, alive2 = false;
        for (int o = 0; o < x.nd; ++o)
            if (OF(x, O_DONE, o) == 0) {
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
    s.precost = OF(x, O_MIN, act0);
    s.mode = OF(x, O_FOUND, act0) > 0 ? M_CPOST : M_OADV;
}

// _step_oadv (:1180)
__device__ __forceinline__ void step_oadv(Lane& s, const Ctx& x) {
    const int32_t kind = x.a.has_seeded ? cfgO(x.a.cfg_o_kind, s, s.cur_o)
                                        : 0;
    if (kind == 0) {
        s.cur = cfgO(x.a.cfg_o_flat0, s, s.cur_o);
        s.phase = PH_OUTER;
        load_cur_rows(s, x, s.cur);
        s.mode = M_DADV;
    } else {
        s.mode = M_SD;
    }
}

// _step_sfx (:1203)
__device__ __forceinline__ void step_sfx(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    s.mode = (OF(x, O_DONE, o) > 0 || OF(x, O_FOUND, o) > 0) ? M_SFXEND
                                                             : M_OADV;
}

// _step_dadv (:1214)
__device__ __forceinline__ void step_dadv(Lane& s, const Ctx& x) {
    const int32_t cur = s.cur;
    const bool dd = DF(x, F_DONE, cur) > 0 || !drv_has_branch(s, x, cur);
    if (dd) DF(x, F_DONE, cur) = 1;
    s.adv_found = 0;
    s.mode = dd ? M_DEND : M_EXT;
}

// _step_ext (:1263): consume one position of the front branch
__device__ __forceinline__ void step_ext(Lane& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int L = x.L;
    const int32_t cur = s.cur;
    const int32_t efw = cfgF(a.cfg_ebwt_fw, s, cur);
    const int32_t hh = cfgF(a.cfg_hh, s, cur);
    const int32_t exacts = cfgF(a.cfg_exacts, s, cur);
    const int32_t d5 = s.d5_cur, d3 = s.d3_cur;
    bool nonempty, picked;
    const int fs = front_select(s, x, cur, nonempty, picked);
    const int32_t fcost = PF(x, P_COST, fs), fham = PF(x, P_HAM, fs);
    const int32_t frd = PF(x, P_RDEPTH, fs), flen = PF(x, P_LEN, fs);
    const int32_t ftop = PF(x, P_TOP, fs), fbot = PF(x, P_BOT, fs);
    const int32_t fne = PF(x, P_NE, fs), fd0 = pd_get(x, fs, 0);
    s.loop_cost = fcost;
    const int32_t depth = frd + flen;
    const int32_t qlen = s.qlen_cur;
    const bool hhfail = hh > 0 && ((depth == d5 && fne == 0)
                                   || (depth == d3 && fne < hh));
    const bool consume = !hhfail && depth < qlen;
    const int dc = clampi(depth, 0, L - 1);
    const BtFM& fm = index_of(x, efw);
    const int32_t pt = ftop, pb = fbot;
    // the range's quartets, loaded beside the by-depth row (which decides
    // whether they are used) rather than after it; rows pt and pb are
    // rows of the index whichever case holds
    int32_t rt[4], rb[4];
    quartets(fm, (int32_t)min((uint32_t)pt, fm.bwt_len),
             (int32_t)min((uint32_t)pb, fm.bwt_len), rt, rb);
    const int32_t c = qd_with(x, cur, dc, s.c_pmn, s.c_pmm, s.c_pmc);
    const int32_t q = pend_at(x, cur, dc);
    const bool alt = depth >= fd0 && fham + q <= a.qual_lim;
    const bool n4 = consume && c == 4 && depth > 0;
    const int32_t tb_top = n4 ? 1 : ftop, tb_bot = n4 ? 1 : fbot;
    const bool caseA = consume && tb_top == 0 && tb_bot == 0;
    const bool caseB = consume && !caseA && alt && (pb > pt || c == 4);
    const bool caseC = consume && !caseA && !caseB && pb > pt;
    int32_t tops[4], bots[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        tops[j] = caseA ? (int32_t)fm.fchr[j]
                        : ((caseB || caseC) ? rt[j] : 0);
        bots[j] = caseA ? (int32_t)fm.fchr[j + 1]
                        : ((caseB || caseC) ? rb[j] : 0);
    }
    const bool install = caseA || caseB;
    const bool dead = q > a.qual_lim - fham;
    int32_t elim_bits = 0;
    bool any_enabled = false;
#pragma unroll
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
    put_pick(x, tops, bots);
    int32_t new_top = abc ? pick_top(x, c3) : tb_top;
    int32_t new_bot = abc ? pick_bot(x, c3) : tb_bot;
    if (caseA && c == 4) new_top = new_bot = 0;
    if (consume) {
        PF(x, P_TOP, fs) = new_top;
        PF(x, P_BOT, fs) = new_bot;
    }
    const int32_t eff_top = consume ? new_top : ftop;
    const int32_t eff_bot = consume ? new_bot : fbot;
    const bool cur0 = depth >= qlen - 1;
    const bool empty = eff_top == eff_bot;
    const bool hit = !hhfail && cur0 && !empty;
    const bool invalid_exact = hit && fne == 0 && exacts == 0;
    int32_t ed[E_MAX], ec[E_MAX];
    load_edits(x, fs, ed, ec);
    int32_t hi_n = 0, lo_n = 0;
#pragma unroll
    for (int i = 0; i < E_MAX; ++i) {
        if (i < fne) {
            if (ed[i] < d5) hi_n += 1;
            if (ed[i] >= d5 && ed[i] < d3) lo_n += 1;
        }
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
        const int32_t npm = s.c_pmn;
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            const int pi = clampi(k - fne, 0, 2);
            DF(x, F_RRED + k, cur) = k < fne ? ed[k] : sel3(s.c_pmm, pi);
            DF(x, F_RREC + k, cur) = k < fne ? ec[k] : sel3(s.c_pmc, pi);
        }
        DF(x, F_RR, cur) = eff_top; DF(x, F_RR + 1, cur) = eff_bot;
        DF(x, F_RR + 2, cur) = fcost; DF(x, F_RR + 3, cur) = fcost >> 14;
        DF(x, F_RR + 4, cur) = fne + npm;
    }
    if (extend) PF(x, P_LEN, fs) = flen + 1;
    int32_t* ptb = x.ptb + (size_t)fs * 2 * L;
    if (consume) {
        if (L + flen >= 0 && L + flen < 2 * L) ptb[L + flen] = pb;
        if (flen >= 0 && flen < 2 * L) ptb[flen] = pt;
    }
    if (extend && flen + 1 >= 0 && flen + 1 < L)
        meta_set(x, fs, flen + 1, META_ALL_DEAD);
    if (consume && flen >= 0 && flen < L) meta_set(x, fs, flen, meta_new);
    if (extend && flen + 1 >= L) {
        s.overflow = true;
        return;
    }
    // curtail (range_source.h:877-939 + PathManager::curtail 1434-1455):
    // the least cost over the eligible positions (an eliminated one costs
    // COST_INF)
    int32_t lowest = COST_INF;
    for_live(x, fs, max(0, fd0 - frd), min(flen, L - 1),
             [&](int ii, int32_t me) {
                 lowest = min(lowest,
                              meta_cost(s, x, me, ii, frd, flen, fd0, d3));
                 return false;
             });
    if (curt) {
        if (lowest == COST_INF) {
            set_valid(s, fs, false);
        } else {
            PF(x, P_COST, fs) = fcost + lowest;
            PF(x, P_CURT, fs) = 1;
        }
    }
    // an extended front only deepened its tip, which lowers its key and
    // leaves every other slot's: it is still the front at SPP
    s.spp_fs = extend && nonempty && picked ? fs : -1;
    s.mode = M_SPP;
}

// _step_spp (:1409): splitAndPrep, the shared --maxbts ceiling,
// splitBranch/pick_edit and the loop exit checks
__device__ __forceinline__ void step_spp(Lane& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int L = x.L;
    const int32_t cur = s.cur;
    const int32_t efw = cfgF(a.cfg_ebwt_fw, s, cur);
    const int32_t d3 = s.d3_cur;
    bool nonempty = true, picked = true;
    const int fs = s.spp_fs >= 0 ? s.spp_fs
                                 : front_select(s, x, cur, nonempty, picked);
    const bool pm_empty = !nonempty;
    bool live = nonempty;
    const int32_t fcost = PF(x, P_COST, fs), fdlyf = PF(x, P_DLYF, fs);
    const int32_t fdly = PF(x, P_DLY, fs), fcurt = PF(x, P_CURT, fs);
    const int32_t frd = PF(x, P_RDEPTH, fs), flen = PF(x, P_LEN, fs);
    const int32_t fne = PF(x, P_NE, fs), fham = PF(x, P_HAM, fs);
    const int32_t fd0 = pd_get(x, fs, 0), fd1 = pd_get(x, fs, 1);
    const int32_t fd2 = pd_get(x, fs, 2), fd3 = pd_get(x, fs, 3);
    const bool btfail0 = a.bt_on && live && s.bt == 0;
    bool clear0 = btfail0;
    live = live && !btfail0;
    const bool dfix = live && fdlyf > 0;
    if (dfix) {
        PF(x, P_COST, fs) = fdly;
        PF(x, P_DLYF, fs) = 0;
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
                if (PF(x, P_DRV, j) == cur) set_valid(s, j, false);
            s.c_pmmin = 0;
            s.mode = M_DEND;
        }
    }
    const int32_t* ptb = x.ptb + (size_t)fs * 2 * L;
    int32_t best = COST_INF, nxt = COST_INF, n_t = 0, n_el = 0;
    const int i0 = max(0, fd0 - frd), i1 = min(flen, L - 1);
    for_live(x, fs, i0, i1, [&](int ii, int32_t me) {
        const int32_t cst = meta_cost(s, x, me, ii, frd, flen, fd0, d3);
        if (cst == COST_INF) return false;      // not eligible
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
        return false;
    });
    const int32_t w = min(n_t, 3);
    int32_t r = 0;
    if (dosplit && w > 1)
        r = (int32_t)(rng_next(s.c_rng) % (uint32_t)max(w, 1));
    const int32_t rank = n_t - w + r;
    int32_t pos = 0, seen = 0;
    if (best != COST_INF)
        for_live(x, fs, i0, i1, [&](int ii, int32_t me) {
            if (meta_cost(s, x, me, ii, frd, flen, fd0, d3) != best)
                return false;
            seen += 1;
            if (seen == rank + 1) {
                pos = ii;
                return true;
            }
            return false;
        });
    const int32_t depth_split = frd + pos;
    int32_t tops[4], bots[4];
    const int32_t meta_pos = meta_get(x, fs, pos);
    const bool is_fchr = (meta_pos & META_FCHR) > 0;
    const BtFM& fm = index_of(x, efw);
    if (is_fchr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            tops[j] = (int32_t)fm.fchr[j];
            bots[j] = (int32_t)fm.fchr[j + 1];
        }
    } else if (dosplit) {
        quartets(fm, ptb[pos], ptb[L + pos], tops, bots);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) tops[j] = bots[j] = 0;   // unused
    }
    // pick_edit (range_source.h:321-485)
    int32_t num = 0, tot = 0, cumsp[4];
    bool cands[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        cands[j] = ((meta_pos >> j) & 1) == 0;
        num += cands[j];
        tot += cands[j] ? bots[j] - tops[j] : 0;
        cumsp[j] = tot;
    }
    uint32_t dart = 0;
    if (dosplit && num > 1)
        dart = rng_next(s.c_rng) % (uint32_t)max(tot, 1);
    int32_t chosen_multi = 0, chosen_single = 0;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
        if (cands[j] && (int32_t)dart < cumsp[j]) chosen_multi = j;
        if (cands[j]) chosen_single = j;
    }
    const bool last = num == 1;
    const int32_t chosen = last ? chosen_single : chosen_multi;
    const int32_t pm_new = last ? (meta_pos | META_ELIM)
                                : (meta_pos | (1 << clampi(chosen, 0, 3)));
    const int cslot = free_slot(s);
    const bool pool_full = slot_valid(s, cslot);
    const bool over = dosplit && (pool_full || fne + 1 > E_MAX);
    if (over) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    if (dosplit) {
        const int32_t nid = s.c_nextid;
        s.c_nextid = nid + 1;
        put_pick(x, tops, bots);
        set_valid(s, cslot, true); PF(x, P_DRV, cslot) = cur;
        PF(x, P_COST, cslot) = fcost;
        PF(x, P_HAM, cslot) = fham + (best & 0x3FFF);
        PF(x, P_RDEPTH, cslot) = frd + pos + 1; PF(x, P_LEN, cslot) = 0;
        PF(x, P_TOP, cslot) = pick_top(x, chosen);
        PF(x, P_BOT, cslot) = pick_bot(x, chosen);
        PF(x, P_CURT, cslot) = 0; PF(x, P_DLY, cslot) = 0;
        PF(x, P_DLYF, cslot) = 0;
        PF(x, P_ID, cslot) = nid; PF(x, P_NE, cslot) = fne + 1;
        pd_set(x, cslot, depth_split < fd1 ? fd1 : fd0,
               depth_split < fd2 ? fd2 : fd1,
               depth_split < fd3 ? fd3 : fd2, fd3);
        const int at_ne = clampi(fne, 0, E_MAX - 1);
        int32_t ed[E_MAX], ec[E_MAX];
        load_edits(x, fs, ed, ec);
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            if (k == at_ne) {
                ed[k] = depth_split;
                ec[k] = chosen;
            }
        }
        store_edits(x, cslot, ed, ec);
        const bool exh = n_el == 1 && last;
        if (exh) set_valid(s, fs, false);
        if (!exh && n_t == 1 && last && best != nxt && nxt != COST_INF) {
            PF(x, P_DLY, fs) = fcost - best + nxt;
            PF(x, P_DLYF, fs) = 1;
        }
        meta_set(x, cslot, 0, META_ALL_DEAD);
        meta_set(x, fs, pos, pm_new);
    }
    // loop exit checks (advance_branch tail)
    const bool chk = rest || pm_empty;
    bool any2 = false;
    int32_t fca = INF32;
    for (uint32_t m = s.vmask; m; m &= m - 1) {
        const int j = __ffs((int)m) - 1;
        if (PF(x, P_DRV, j) == cur) {
            any2 = true;
            fca = min(fca, PF(x, P_COST, j));
        }
    }
    if (any2) s.c_pmmin = fca;
    if (chk) {
        const bool exit_ = !any2 || fca != s.loop_cost || s.adv_found > 0;
        s.mode = exit_ ? M_DEND : M_EXT;
    }
}

// _step_dend (:1602); the end of driver cur's advance: its registers go
// back to the scratch
__device__ __forceinline__ void step_dend(Lane& s, const Ctx& x) {
    const int32_t cur = s.cur;
    DF(x, F_DONE, cur) = drv_has_branch(s, x, cur) ? 0 : 1;
    const int32_t pmc = s.c_pmmin;
    if (pmc != 0) DF(x, F_MIN, cur) = max(pmc, DF(x, F_ADJ, cur));
    DF(x, F_FOUND, cur) = s.adv_found;
    DF(x, F_RNG, cur) = (int32_t)s.c_rng;
    DF(x, F_NEXTID, cur) = s.c_nextid;
    DF(x, F_PMMIN, cur) = s.c_pmmin;
    if (s.phase == PH_OUTER) s.mode = M_ODEND;
    else if (s.phase == PH_GEN) s.mode = M_SDGEN;
    else if (s.phase == PH_FULL) s.mode = M_ICPOST;
}

// _step_odend (:1624)
__device__ __forceinline__ void step_odend(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t f0 = cfgO(x.a.cfg_o_flat0, s, o);
    if (cfgO(x.a.cfg_o_kind, s, o) == 0) {
        OF(x, O_DONE, o) = DF(x, F_DONE, f0);
        OF(x, O_MIN, o) = DF(x, F_MIN, f0);
        if (DF(x, F_FOUND, f0) > 0) {
            OF(x, O_FOUND, o) = 1;
            DF(x, F_FOUND, f0) = 0;
#pragma unroll
            for (int k = 0; k < 5; ++k) OF(x, O_RR + k, o) = DF(x, F_RR + k, f0);
#pragma unroll
            for (int k = 0; k < E_MAX; ++k) {
                OF(x, O_ED + k, o) = DF(x, F_RRED + k, f0);
                OF(x, O_EC + k, o) = DF(x, F_RREC + k, f0);
            }
        }
    }
    if (s.octx == 0) s.mode = M_CPOST;
    else if (s.octx == 1)
        s.mode = OF(x, O_MIN, o) > s.sfx_mc ? M_SFXEND : M_SFX;
}

// _step_cpost (:1652): consume a found range incl. the strandFix scan
template <bool PAIRED>
__device__ __forceinline__ void step_cpost(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const bool pf = OF(x, O_FOUND, o) > 0;
    const bool needs0 = OF(x, O_DONE, o) > 0 || s.precost != OF(x, O_MIN, o);
    if (pf) {
        copy_outer_range(s, x, true, o);
        s.ca_found = 1;
        OF(x, O_FOUND, o) = 0;
    }
    const int32_t r_fw = cfgO(x.a.cfg_o_fw, s, o);
    // K14: the other strand of the same mate (:1666-1673)
    const int32_t r_m1 = PAIRED ? cfgO(x.a.cfg_o_m1, s, o) : 1;
    int i_star = -1;
    for (int i = 1; i < x.nd; ++i)
        if (cfgO(x.a.cfg_o_fw, s, i) != r_fw && i < s.act_n
            && (!PAIRED || cfgO(x.a.cfg_o_m1, s, i) == r_m1)) {
            i_star = i;
            break;
        }
    bool go = false;
    if (pf && i_star >= 0) {
        const int32_t tgt = ACT(x, i_star);
        const int32_t mc = max(s.ca_min, OF(x, O_MIN, tgt));
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
__device__ __forceinline__ void step_sfxend(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    if (OF(x, O_FOUND, o) > 0) {
        copy_outer_range(s, x, false, o);
        s.dl_valid = 1;
        OF(x, O_FOUND, o) = 0;
        const int32_t tot = (s.dl_bot - s.dl_top) + (s.ls_bot - s.ls_top);
        const uint32_t v = rng_next(s.rng_ca);
        const int32_t rq = (int32_t)(v % (uint32_t)max(tot, 1));
        if (rq < s.dl_bot - s.dl_top) {
            swap_(s.ls_drv, s.dl_drv); swap_(s.ls_top, s.dl_top);
            swap_(s.ls_bot, s.dl_bot); swap_(s.ls_cost, s.dl_cost);
            swap_(s.ls_strat, s.dl_strat); swap_(s.ls_ne, s.dl_ne);
#pragma unroll
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
__device__ __forceinline__ void step_sort(Lane& s, const Ctx& x) {
    sort_outer(s, x);
    if (s.act_n > 0 && s.dl_valid == 0)
        s.ca_min = max(OF(x, O_MIN, ACT(x, 0)), s.ca_min);
    if (s.act_n == 0) s.ca_done = s.dl_valid == 0 ? 1 : 0;
    s.mode = M_MAIN;
}

// ---- seeded-driver scheduler (EbwtSeededRangeSourceDriver) -----------------

// _step_sd (:1750)
__device__ __forceinline__ void step_sd(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t gen = cfgO(x.a.cfg_o_flat0, s, o);
    const bool gdone = DF(x, F_DONE, gen) > 0;
    const bool gfound = DF(x, F_FOUND, gen) > 0;
    const bool fdone = OF(x, O_ICDONE, o) > 0;
    const bool ffound = OF(x, O_ICFOUND, o) > 0;
    if (gdone && fdone && !gfound && !ffound) {
        OF(x, O_DONE, o) = 1;
        s.mode = M_ODEND;
        return;
    }
    if (gdone && !gfound) {
        DF(x, F_MIN, gen) = COST_INF;
        if (OF(x, O_ICMIN, o) > OF(x, O_MIN, o)) {
            OF(x, O_MIN, o) = OF(x, O_ICMIN, o);
            s.mode = M_ODEND;
            return;
        }
    }
    if (fdone && !ffound) {
        OF(x, O_ICMIN, o) = COST_INF;
        if (DF(x, F_MIN, gen) > OF(x, O_MIN, o)) {
            OF(x, O_MIN, o) = DF(x, F_MIN, gen);
            s.mode = M_ODEND;
            return;
        }
    }
    if (!(OF(x, O_ICMIN, o) <= DF(x, F_MIN, gen))) {
        if (gfound) {
            s.mode = M_SDGEN;
        } else {
            s.cur = gen;
            s.phase = PH_GEN;
            load_cur_rows(s, x, gen);
            s.mode = M_DADV;
        }
    } else {
        s.sdf_old = OF(x, O_ICMIN, o);
        s.mode = ffound ? M_SDFULL : M_ICADV;
    }
}

// _step_sdgen (:1802): on a seed partial, create a full extender (its
// set_query: premuts, N tally, ftab jump, first branch) and add it to the
// inner CostAware; then the generator min-cost propagation
template <bool PAIRED>
__device__ __forceinline__ void step_sdgen(Lane& s, const Ctx& x) {
    const BestArgs& a = x.a;
    const int L = x.L;
    const int32_t o = s.cur_o;
    const int32_t gen = cfgO(a.cfg_o_flat0, s, o);
    const bool gfound = DF(x, F_FOUND, gen) > 0;
    const int32_t scost = DF(x, F_RR + 2, gen), sne = DF(x, F_RR + 4, gen);
    int32_t sed[3], sec[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        sed[k] = DF(x, F_RRED + k, gen);
        sec[k] = DF(x, F_RREC + k, gen);
    }
    if (gfound) DF(x, F_FOUND, gen) = 0;
    const int32_t slot = OF(x, O_EXNEXT, o);
    if (gfound && (slot >= PEX || sne > 3)) {
        s.overflow = true;
        s.mode = M_DONE;
        return;
    }
    if (gfound) {
        const int32_t fe = cfgO(a.cfg_o_exbase, s, o)
            + clampi(slot, 0, PEX - 1);
        OF(x, O_EXNEXT, o) = slot + 1;
        const int32_t gdq = DF(x, F_DQLEN, gen);
        int32_t pm_m[3], pm_c[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            pm_m[k] = k < sne ? gdq - 1 - sed[k] : 0;
            pm_c[k] = sec[k];
            DF(x, F_PMM + k, fe) = pm_m[k];
            DF(x, F_PMC + k, fe) = pm_c[k];
        }
        DF(x, F_PMN, fe) = sne;
        const int32_t qlen = qlen_of<PAIRED>(s, x, o);
        const int32_t s_seed = DF(x, F_DD3, gen);
        DF(x, F_DQLEN, fe) = qlen;
        DF(x, F_DD3, fe) = s_seed;
        DF(x, F_DD5, fe) = s_seed >> 1;
        const int32_t iham = a.qual_order ? (scost & 0x3FFF) : 0;
        DF(x, F_NEXTID, fe) = 0;
        DF(x, F_PMMIN, fe) = 0;
        DF(x, F_RNG, fe) = (int32_t)seed_of<PAIRED>(s, x, o);
        const int32_t efw_e = cfgF(a.cfg_ebwt_fw, s, fe);
        const BtFM& fm = index_of(x, efw_e);
        const int fc = fm.ftab_chars;
        bool dead = false;
        int32_t ns_ftab = 0;
        uint32_t foff = 0;
        for (int d = 0; d < L; ++d) {
            const int32_t c = qd_with(x, fe, d, sne, pm_m, pm_c);
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
            DF(x, F_RR, fe) = ft; DF(x, F_RR + 1, fe) = fb;
            DF(x, F_RR + 2, fe) = scost; DF(x, F_RR + 3, fe) = scost >> 14;
            DF(x, F_RR + 4, fe) = sne;
#pragma unroll
            for (int k = 0; k < E_MAX; ++k) {
                DF(x, F_RRED + k, fe) = k < 3 ? pm_m[k] : 0;
                DF(x, F_RREC + k, fe) = k < 3 ? pm_c[k] : 0;
            }
        }
        const bool pushf = alive && use_ftab && qlen > fc && nonempty;
        const bool push0 = alive && !use_ftab;
        const bool pushed = pushf || push0;
        const int cslot = free_slot(s);
        if (pushed && slot_valid(s, cslot)) {
            s.overflow = true;
            s.mode = M_DONE;
            return;
        }
        const int32_t blen0 = pushf ? fc : 0;
        if (pushed) {
            set_valid(s, cslot, true); PF(x, P_DRV, cslot) = fe;
            PF(x, P_COST, cslot) = scost; PF(x, P_HAM, cslot) = iham;
            PF(x, P_RDEPTH, cslot) = 0; PF(x, P_LEN, cslot) = blen0;
            PF(x, P_TOP, cslot) = pushf ? ft : 0;
            PF(x, P_BOT, cslot) = pushf ? fb : 0;
            PF(x, P_CURT, cslot) = 0; PF(x, P_DLY, cslot) = 0;
            PF(x, P_DLYF, cslot) = 0; PF(x, P_ID, cslot) = 0;
            PF(x, P_NE, cslot) = 0;
            pd_set(x, cslot, s_seed, s_seed, s_seed, s_seed);
            DF(x, F_NEXTID, fe) = 1;
            if (blen0 >= 0 && blen0 < L)
                meta_set(x, cslot, blen0, META_ALL_DEAD);
        }
        DF(x, F_DONE, fe) = (!pushed && !imm) ? 1 : 0;
        DF(x, F_FOUND, fe) = imm ? 1 : 0;
        DF(x, F_MIN, fe) = scost;
        // inner add_source (min_cost = 0, then _sort_actives)
        OF(x, O_ICFOUND, o) = 0;
        OF(x, O_ICDONE, o) = 0;
        int32_t actn = OF(x, O_ICACTN, o);
        if (actn >= 0 && actn < PEX) OF(x, O_ICACT + actn, o) = fe;
        actn += 1;
        sort_inner(x, o, actn);
        OF(x, O_ICACTN, o) = actn;
        OF(x, O_ICMIN, o) = actn > 0
            ? max(DF(x, F_MIN, OF(x, O_ICACT, o)), 0) : 0;
    }
    // generator min-cost propagation (not-do_full tail)
    const int32_t gmin = DF(x, F_MIN, gen);
    if (gmin > OF(x, O_MIN, o)) {
        OF(x, O_MIN, o) = gmin;
        if (!(OF(x, O_ICDONE, o) > 0))
            OF(x, O_MIN, o) = min(OF(x, O_MIN, o), OF(x, O_ICMIN, o));
    }
    s.mode = M_ODEND;
}

// _step_sdfull (:1966)
__device__ __forceinline__ void step_sdfull(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t gen = cfgO(x.a.cfg_o_flat0, s, o);
    if (OF(x, O_ICFOUND, o) > 0) {
        OF(x, O_FOUND, o) = 1;
        OF(x, O_ICFOUND, o) = 0;
#pragma unroll
        for (int k = 0; k < 5; ++k) OF(x, O_RR + k, o) = OF(x, O_IL + k, o);
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            OF(x, O_ED + k, o) = OF(x, O_ILED + k, o);
            OF(x, O_EC + k, o) = OF(x, O_ILEC + k, o);
        }
    }
    const int32_t icm = OF(x, O_ICMIN, o);
    if (icm > s.sdf_old) OF(x, O_MIN, o) = min(icm, DF(x, F_MIN, gen));
    s.mode = M_ODEND;
}

// _step_icadv (:1992)
__device__ __forceinline__ void step_icadv(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    if (OF(x, O_ICACTN, o) == 0) {
        OF(x, O_ICDONE, o) = 1;
        s.mode = M_SDFULL;
        return;
    }
    const int32_t p = OF(x, O_ICACT, o);
    s.cur = p;
    s.ic_pre = DF(x, F_MIN, p);
    if (DF(x, F_FOUND, p) > 0) {
        s.mode = M_ICPOST;
    } else {
        s.phase = PH_FULL;
        load_cur_rows(s, x, p);
        s.mode = M_DADV;
    }
}

// _step_icpost (:2013)
__device__ __forceinline__ void step_icpost(Lane& s, const Ctx& x) {
    const int32_t o = s.cur_o;
    const int32_t p = s.cur;
    if (DF(x, F_FOUND, p) > 0) {
#pragma unroll
        for (int k = 0; k < 5; ++k) OF(x, O_IL + k, o) = DF(x, F_RR + k, p);
#pragma unroll
        for (int k = 0; k < E_MAX; ++k) {
            OF(x, O_ILED + k, o) = DF(x, F_RRED + k, p);
            OF(x, O_ILEC + k, o) = DF(x, F_RREC + k, p);
        }
        OF(x, O_ICFOUND, o) = 1;
        DF(x, F_FOUND, p) = 0;
    }
    if (DF(x, F_DONE, p) > 0 || s.ic_pre != DF(x, F_MIN, p)) {
        int32_t actn = OF(x, O_ICACTN, o);
        sort_inner(x, o, actn);
        OF(x, O_ICACTN, o) = actn;
        if (actn > 0)
            OF(x, O_ICMIN, o) = max(DF(x, F_MIN, OF(x, O_ICACT, o)),
                                    OF(x, O_ICMIN, o));
        else
            OF(x, O_ICDONE, o) = 1;
    }
    s.mode = M_SDFULL;
}

// _step_chase (:2056): one RangeChaser row, resolve + joinedToTextOff +
// sink (range_chaser.h:22; BestSink.report_hit)
template <bool PAIRED>
__device__ __forceinline__ void step_chase(Lane& s, const Ctx& x) {
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
            s.r_row = (int32_t)lf_row_picked(x, fm, (uint32_t)row);
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
    const int32_t qlen = qlen_of<PAIRED>(s, x, s.ls_drv);
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
#pragma unroll
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
// constants of _init_state (:647): the pool into shared memory, the
// driver blocks of the run's nd / ndt into the scratch column, every
// field pack_init does not give zero (rng_rs and ic_rng the seed, a paired
// row's own); a paired row ends with the per-outer read lengths and seeds
// and the per-flat-driver RNG seeds (:660-681).
template <bool PAIRED>
__device__ __forceinline__ void init_lane(Lane& s, const Ctx& x,
                                          const int32_t* r, uint32_t seed) {
    const BestArgs& a = x.a;
    const int nd = x.nd, ndt = x.ndt;
    for (int k = 0; k < P_D01; ++k)
        for (int j = 0; j < NBR; ++j) PF(x, k, j) = *r++;
    s.vmask = 0;
    for (int j = 0; j < NBR; ++j)
        if (PF(x, P_VALID, j) > 0) s.vmask |= 1u << j;
    s.spp_fs = -1;
    for (int j = 0; j < NBR; ++j)
        pd_set(x, j, r[j], r[NBR + j], r[2 * NBR + j], r[3 * NBR + j]);
    r += (kPinit - P_D01) * NBR;
    for (int w = kPedW; w < kPickW; ++w) shw(x, w) = 0;
    if (x.onchip)
        for (int w = 0; w < 2 * NBR; ++w) shw(x, x.lw + w) = 0;
    for (int k = F_DONE; k <= F_DD3; ++k)
        for (int f = 0; f < ndt; ++f) DF(x, k, f) = *r++;
    for (int f = 0; f < ndt; ++f)
        for (int k = 0; k < 5; ++k) DF(x, F_RR + k, f) = *r++;
    for (int k = O_DONE; k <= O_MIN; ++k)
        for (int o = 0; o < nd; ++o) OF(x, k, o) = *r++;
    for (int o = 0; o < nd; ++o) ACT(x, o) = *r++;
    s.act_n = *r++;
    s.rng_ca = (uint32_t)*r++;
    s.ca_min = *r++;
    s.qlen = *r++;
    s.cfg0f = *r++;
    s.cfg0o = *r++;
    s.mode = M_MAIN;
    s.rng_al = s.seed = seed;
    for (int f = 0; f < ndt; ++f) {
        for (int k = F_PMMIN; k < NFF; ++k) DF(x, k, f) = 0;
        DF(x, F_RNG, f) = (int32_t)seed;
    }
    for (int o = 0; o < nd; ++o) {
        for (int k = O_EXNEXT; k < O_QLEN; ++k) OF(x, k, o) = 0;
        OF(x, O_ICRNG, o) = (int32_t)seed;
    }
    if constexpr (PAIRED) {
        for (int o = 0; o < nd; ++o) OF(x, O_QLEN, o) = *r++;
        for (int o = 0; o < nd; ++o) {
            const int32_t v = *r++;
            OF(x, O_SEED, o) = v;
            OF(x, O_ICRNG, o) = v;
        }
        for (int f = 0; f < ndt; ++f) DF(x, F_RNG, f) = *r++;
    }
    s.best_stratum = 999;
    s.bt = a.maxbts;
}

// the width of pack_init's per-lane row
__host__ __device__ __forceinline__ int init_width(int nd, int ndt,
                                                   bool paired) {
    return kPinit * NBR + 13 * ndt + 4 * nd + 6
        + (paired ? 2 * nd + ndt : 0);
}

// The block's stores that no lane's transitions depend on: its lanes' hit
// rows zeroed, and in the global layout their meta set to META_ALL_DEAD,
// each a contiguous run written with 16-byte stores.
__device__ void block_prologue(const BestArgs& a, long b0, int n,
                               bool onchip) {
    const int4 z = make_int4(0, 0, 0, 0);
    int4* h = reinterpret_cast<int4*>(a.hits + b0 * H_MAX * HIT_W);
    for (int i = threadIdx.x; i < n * H_MAX * HIT_W / 4; i += blockDim.x)
        h[i] = z;
    if (!onchip) {
        const int32_t dead2 = META_ALL_DEAD | (META_ALL_DEAD << 16);
        const int4 d = make_int4(dead2, dead2, dead2, dead2);
        int4* m = reinterpret_cast<int4*>(a.meta + b0 * NBR * a.L);
        for (int i = threadIdx.x; i < n * NBR * a.L / 8; i += blockDim.x)
            m[i] = d;
    }
}

// One thread a lane, blockDim.x lanes a block (at most a warp; one block
// an SM is enough for ptxas to give the lane every register it needs,
// shared memory bounds the blocks an SM holds).
template <bool PAIRED>
__global__ void __launch_bounds__(kMaxLanes, 1)
best_machine_kernel(const BestArgs args) {
    extern __shared__ int32_t smem[];
    // the arguments, read from shared memory from here on (a lane's picks
    // between the two indexes and its config reads would otherwise copy
    // them to local memory)
    __shared__ BestArgs a;
    if (threadIdx.x == 0) a = args;
    const int nt = blockDim.x;
    const long b0 = (long)blockIdx.x * nt;
    const int n = (int)min((long)nt, (long)args.B - b0);
    const bool onchip = args.L <= kOnchipL;
    block_prologue(args, b0, n, onchip);
    __syncthreads();
    if ((int)threadIdx.x >= n) return;
    const int b = (int)b0 + threadIdx.x;
    const int L = a.L;
    const Ctx x{a, L, nt, a.nd, a.ndt, (size_t)a.B, onchip,
                a.rows_qp + (size_t)b * a.ndt * 2 * L,
                a.ptb + (size_t)b * NBR * 2 * L,
                onchip ? nullptr : a.meta + (size_t)b * NBR * L,
                a.scratch + b,
                a.hits + (size_t)b * H_MAX * HIT_W,
                smem + threadIdx.x, kActW + a.nd, kActW + a.nd + 2 * NBR};
    if (onchip) {
        const int32_t dead2 = META_ALL_DEAD | (META_ALL_DEAD << 16);
        for (int w = 0; w < 8 * L; ++w) shw(x, x.mw + w) = dead2;
    }
    for (int j = 0; j < NBR; ++j) {
        x.ptb[(size_t)j * 2 * L] = 0;
        x.ptb[(size_t)j * 2 * L + L] = 0;
    }
    Lane s = {};
    init_lane<PAIRED>(s, x,
                      a.init + (size_t)b * init_width(a.nd, a.ndt, PAIRED),
                      (uint32_t)a.seeds[b]);
    // One pass applies the lane's transitions in the fixed order of modes
    // given at the top of this file while its mode is the next, each
    // counted; the lane's own order of transitions is unchanged, and it
    // stops where the switch on one transition at a time stopped: at
    // M_DONE, at an overflow, at max_transitions.
    const int64_t tmax = a.max_transitions;
    int64_t t = 0;
#define BT_STEP(m, call)                                                    \
    if (s.mode == (m) && !s.overflow && t < tmax) {                         \
        call;                                                               \
        ++t;                                                                \
        ran = true;                                                         \
    }
    while (s.mode != M_DONE && !s.overflow && t < tmax) {
        bool ran = false;
        BT_STEP(M_MAIN, step_main<PAIRED>(s, x))
#pragma unroll 1
        for (int k = 0; k < kChasePerPass; ++k) {
            BT_STEP(M_CHASE, step_chase<PAIRED>(s, x))
        }
        BT_STEP(M_CADV, step_cadv<PAIRED>(s, x))
        BT_STEP(M_SFX, step_sfx(s, x))
        BT_STEP(M_OADV, step_oadv(s, x))
        BT_STEP(M_SD, step_sd(s, x))
        BT_STEP(M_ICADV, step_icadv(s, x))
        BT_STEP(M_DADV, step_dadv(s, x))
#pragma unroll 1
        for (int k = 0; k < kExtPerPass; ++k) {
            BT_STEP(M_EXT, step_ext(s, x))
            BT_STEP(M_SPP, step_spp(s, x))
        }
        BT_STEP(M_DEND, step_dend(s, x))
        BT_STEP(M_SDGEN, step_sdgen<PAIRED>(s, x))
        BT_STEP(M_ICPOST, step_icpost(s, x))
        BT_STEP(M_SDFULL, step_sdfull(s, x))
        BT_STEP(M_ODEND, step_odend(s, x))
        BT_STEP(M_CPOST, step_cpost<PAIRED>(s, x))
        BT_STEP(M_SFXEND, step_sfxend(s, x))
        BT_STEP(M_SORT, step_sort(s, x))
        if (!ran && !s.overflow && t < tmax) {   // no mode of the machine
            s.overflow = true;
            ++t;
        }
    }
#undef BT_STEP
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

// K10 over a->B lanes, `threads` lanes a block (machine_shape's), the
// instantiation by the run: the paired one for K14
int bt_best_machine(const BestArgs* a, int threads, void* stream) {
    if (a->nd < 1 || a->ndt < 1 || a->nd > ND_CFG || a->ndt > NDT_CFG
        || threads < 1 || threads > kMaxLanes || a->L < 8 || a->L % 8)
        return (int)cudaErrorInvalidValue;
    const bool onchip = a->L <= kOnchipL;
    const int shared = threads * 4 * lane_words(a->L, a->nd, onchip);
    const unsigned grid = (unsigned)((a->B + threads - 1) / threads);
    cudaError_t e;
    if (a->paired) {
        e = cudaFuncSetAttribute(best_machine_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shared);
        if (e == cudaSuccess)
            best_machine_kernel<true><<<grid, threads, shared,
                                        (cudaStream_t)stream>>>(*a);
    } else {
        e = cudaFuncSetAttribute(best_machine_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shared);
        if (e == cudaSuccess)
            best_machine_kernel<false><<<grid, threads, shared,
                                         (cudaStream_t)stream>>>(*a);
    }
    return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
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

// K10's launch shape, for best_device.machine_shape to check against:
// the most lanes a block, the widest rows whose meta stays on chip, a
// lane's shared words, a lane's scratch words, and the block's static
// shared bytes (the arguments' copy)
int bt_best_max_lanes() { return kMaxLanes; }
int bt_best_onchip_l() { return kOnchipL; }
int bt_best_lane_words(int L, int nd, int onchip) {
    return lane_words(L, nd, onchip != 0);
}
int bt_best_scratch_words(int nd, int ndt, int paired) {
    return scratch_words(nd, ndt, paired != 0);
}
int bt_best_args_bytes() { return (int)sizeof(BestArgs); }

// the local memory (stack) per thread of an instantiation, which the
// runtime reserves for every resident thread; -1 on an error
int bt_best_local_bytes(int paired) {
    cudaFuncAttributes at;
    const cudaError_t e = paired
        ? cudaFuncGetAttributes(&at, best_machine_kernel<true>)
        : cudaFuncGetAttributes(&at, best_machine_kernel<false>);
    return e == cudaSuccess ? (int)at.localSizeBytes : -1;
}

}  // extern "C"
