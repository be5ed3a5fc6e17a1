// K13: the V1 interleave, chase and rescue of bowtie's default paired
// command (-k 1 without -m) over the anchor streams the recorder (K12,
// K10r) wrote.  Built with the other sources by bowtie_tpu_torch/kernels.py
// and called through the plain C entry point at the bottom.
//
// Replaces bowtie_tpu/align/pe_ilv_device.py:527 run_ilv_chunk over :503
// _machine_step (:151 _step_ilv, :262 _step_chase, :400 _step_scan) and
// the drivers :542 run_ilv and :535 _compact_ilv, with K1 (lf_row)
// inlined from fm.cuh.  Plain version, which this is held to:
// run_ilv_plain in bowtie_tpu_torch/align/pe_ilv_device.py.
//
// One thread per pair.  Each runs its pair's state machine until I_DONE,
// counting iterations as the lockstep plain version does: one iteration
// applies step_ilv, then step_chase (one LF step of a walk), then
// step_scan, each only if the lane is then in that mode, and a lane gets
// max_steps iterations (4096) before it escalates.  A step reads and
// writes only its own lane, so every lane ends in the plain version's
// state, escalations included.  Each step below is the scalar form of the
// plain step of the same name: the same reads and writes under the same
// conditions, one LCG draw per chase.
//
// The scan does not sweep the window: it walks the candidates in bowtie's
// zig-zag order (i = 1..lim+1, ri = halfway -/+ (i >> 1); ref_aligner.h:
// 204-212, best_paired.py RefAlignerPy.score), compares base by base,
// leaves a candidate at its first failing base and stops at the first
// valid one, which is the one of least rank that the plain sweep picks.
//
// Types: BWT rows uint32_t, text offsets and candidate counts int64_t
// (the reference's int32 counts clamp sym_ceiling; these need not).
//
// What bounds K13: a chase is a dependent SA read, or a walk of dependent
// rank reads (two 32-byte sectors per LF step); a scan reads up to a few
// hundred reference bytes, one byte load per compared base.  Lanes diverge
// at once (each pair takes its own path through the modes), so a warp
// runs its lanes mostly one at a time: bound by dependent-load latency
// and divergence, not by bandwidth or arithmetic.
#include "fm.cuh"

namespace {

constexpr int H_MAX = 16, REC_W = 24, N_OUT = 13;
constexpr int I_ILV = 0, I_CHASE = 1, I_SCAN = 2, I_DONE = 3;
constexpr int64_t OFFS_SAT = int64_t(1) << 29;
constexpr int kThreads = 64;

}  // namespace

// Mirrors IlvArgs in bowtie_tpu_torch/align/pe_ilv_device.py field for
// field.
struct IlvArgs {
    BtFM fw, bw;
    const int64_t* rstarts;     // [nfrag][3] start, tidx, toff
    int64_t length;
    int64_t sym_ceiling;
    int32_t nfrag, dense, B, Lq, nd, v, seed_mms, seed_len, qual_max,
        attempt_lim, dont_reconcile, max_steps, slot_l0, slot_r0, slot_l1,
        slot_r1;
    const int64_t* seeds;       // [B] mate 1's seed (uint32 values)
    const int32_t* hits;        // [B][4][H_MAX][REC_W] stream records
    const int32_t* nrec;        // [B][4]
    const int32_t* capped;      // [B][4]
    const uint8_t* q_c;         // [B][4][Lq] outstanding queries
    const int32_t* pen_c;       // [B][4][Lq] their penalties
    const int32_t *qlen_c, *alen_c, *qn_c, *sol_c, *wok_c;   // [B][4]
    const int32_t *minins, *maxins;                          // [B]
    const int32_t* efw_tab;     // [4 * nd]
    const int64_t* reflen;      // [nref]
    const uint8_t* refcat;      // the references one after another
    const int64_t* refbase;     // [nref]
    int64_t* out;               // [N_OUT][B]
};

namespace {

struct Lane {
    int32_t mode, phase, cur[4], sdone[4];
    int64_t offs_l, offs_r;
    int32_t del_l, del_r, dl_slot, dl_idx, dr_slot, dr_idx, attempts,
        p_valid, p_slot, p_idx, p_side;
    uint32_t rng;
    int32_t ch_slot, ch_idx, ch_k, ch_side, r_walk;
    uint32_t ch_top, ch_bot, ch_r, r_row;
    int64_t r_jumps;
    int64_t sc_tidx, sc_toff, sc_begin, sc_end;
    int32_t sc_combo;
    int64_t res[10];            // OUT_KEYS' res_* fields, in order
    int32_t escalate;
};

enum { R_FOUND, R_SLOT, R_IDX, R_TIDX, R_TOFF, R_LEFT, R_STRAT, R_HAM,
       R_PHASE, R_SIDE };

// per-thread view of the arguments
struct Ctx {
    const IlvArgs& a;
    int b;
    const int32_t* hits;        // this lane's [4][H_MAX][REC_W]
};

__device__ __forceinline__ const int32_t* rec_at(const Ctx& x, int slot,
                                                 int idx) {
    idx = idx < 0 ? 0 : (idx > H_MAX - 1 ? H_MAX - 1 : idx);
    return x.hits + ((size_t)slot * H_MAX + idx) * REC_W;
}

__device__ __forceinline__ int64_t min64(int64_t u, int64_t v) {
    return u < v ? u : v;
}

__device__ __forceinline__ int64_t max64(int64_t u, int64_t v) {
    return u > v ? u : v;
}

__device__ __forceinline__ int32_t lane4(const int32_t* t, const Ctx& x,
                                         int k) {
    return t[4 * (size_t)x.b + k];
}

// the outstanding (mate, strand) of an anchor (_combo)
__device__ __forceinline__ int combo_of(int phase, bool anchor_is_left) {
    return phase == 0 ? (anchor_is_left ? 2 : 0) : (anchor_is_left ? 1 : 3);
}

// _sched_chase: enter the chase of record (slot, idx), one LCG draw for
// its random first row
__device__ void sched_chase(Lane& s, const Ctx& x, int slot, int idx,
                            int side) {
    const int32_t* r = rec_at(x, slot, idx);
    const uint32_t top = (uint32_t)r[1], bot = (uint32_t)r[2];
    const uint32_t spread = bot > top ? bot - top : 1u;
    const uint32_t v = rng_next(s.rng);
    s.ch_slot = slot;
    s.ch_idx = idx;
    s.ch_top = top;
    s.ch_bot = bot;
    s.ch_r = top + v % spread;
    s.ch_k = 0;
    s.ch_side = side;
    s.r_walk = 0;
    s.mode = I_CHASE;
}

// _phase_advance: fw phase -> rc phase -> done without a pair
__device__ void phase_advance(Lane& s) {
    if (s.phase + 1 >= 2) {
        s.mode = I_DONE;
        return;
    }
    s.phase += 1;
    s.offs_l = s.offs_r = 0;
    s.del_l = s.del_r = 0;
    s.attempts = 0;
    s.p_valid = 0;
    s.mode = I_ILV;
}

// _chase_done_no_hit
__device__ void chase_done_no_hit(Lane& s, const Ctx& x) {
    if (s.p_valid > 0) {
        s.p_valid = 0;
        sched_chase(s, x, s.p_slot, s.p_idx, s.p_side);
    } else {
        s.mode = I_ILV;
    }
}

// _advance_row
__device__ void advance_row(Lane& s, const Ctx& x) {
    s.ch_k += 1;
    s.r_walk = 0;
    if ((uint32_t)s.ch_k >= s.ch_bot - s.ch_top) chase_done_no_hit(s, x);
    else s.mode = I_CHASE;
}

// _advance_attempt_and_row
__device__ void advance_attempt_and_row(Lane& s, const Ctx& x) {
    s.attempts += 1;
    if (s.attempts > x.a.attempt_lim) {
        s.p_valid = 0;
        phase_advance(s);
        return;
    }
    advance_row(s, x);
}

// _step_ilv: one iteration of advanceOrientation's while-loop
__device__ void step_ilv(Lane& s, const Ctx& x) {
    const IlvArgs& a = x.a;
    const int ls = s.phase == 0 ? a.slot_l0 : a.slot_l1;
    const int rs = s.phase == 0 ? a.slot_r0 : a.slot_r1;
    const bool ldone = s.sdone[ls] > 0, rdone = s.sdone[rs] > 0;
    const int64_t offsL = s.offs_l, offsR = s.offs_r;
    const bool condA = (offsL < offsR || rdone) && !ldone;
    const bool condB = !condA && !rdone;
    if ((condA && rdone && offsR == 0) || (condB && ldone && offsL == 0)
        || (!condA && !condB)) {
        phase_advance(s);
        return;
    }
    const bool myL = condA;
    const int aslot = myL ? ls : rs;
    const int64_t my_offs = myL ? offsL : offsR;
    const int64_t ot_offs = myL ? offsR : offsL;
    const int32_t ot_del = myL ? s.del_r : s.del_l;
    const int32_t ot_dslot = myL ? s.dr_slot : s.dl_slot;
    const int32_t ot_didx = myL ? s.dr_idx : s.dl_idx;
    const int cur = s.cur[aslot];
    const int n = lane4(a.nrec, x, aslot);
    const bool cap = lane4(a.capped, x, aslot) > 0;
    if (cur >= n) {
        // past the end of a capped stream: ReplayTruncated; an exhausted
        // uncapped stream is done with no range
        if (cap) {
            s.escalate = 1;
            s.mode = I_DONE;
        } else {
            s.sdone[aslot] = 1;
        }
        return;
    }
    const int32_t* r = rec_at(x, aslot, cur);
    const int64_t top = (uint32_t)r[1], bot = (uint32_t)r[2];
    if (r[6] == 1 || (cur + 1 >= n && !cap)) s.sdone[aslot] = 1;
    s.cur[aslot] = cur + 1;
    int64_t my2 = my_offs + (bot > top ? bot - top : 0);
    if (my2 > OFFS_SAT) my2 = OFFS_SAT;
    if (myL) s.offs_l = my2;
    else s.offs_r = my2;
    if (my2 >= OFFS_SAT) {
        s.escalate = 1;
        s.mode = I_DONE;
        return;
    }
    const bool delay = a.dont_reconcile ? (ot_offs == 0 && my2 > 3)
                                        : ot_offs == 0;
    if (delay) {
        if (myL) {
            s.del_l = 1;
            s.dl_slot = aslot;
            s.dl_idx = cur;
        } else {
            s.del_r = 1;
            s.dr_slot = aslot;
            s.dr_idx = cur;
        }
        return;
    }
    if (my2 > a.sym_ceiling && ot_offs > a.sym_ceiling) {
        phase_advance(s);
        return;
    }
    const int my_side = myL ? 1 : 0;
    if (ot_del > 0 && ot_offs < my2) {
        // the swap: the other side's delayed range first, then this one
        s.del_l = s.del_r = 0;
        s.p_valid = 1;
        s.p_slot = aslot;
        s.p_idx = cur;
        s.p_side = my_side;
        sched_chase(s, x, ot_dslot, ot_didx, 1 - my_side);
    } else {
        if (ot_del > 0) {
            if (myL) s.del_r = 0;
            else s.del_l = 0;
            s.p_valid = 1;
            s.p_slot = ot_dslot;
            s.p_idx = ot_didx;
            s.p_side = 1 - my_side;
        }
        sched_chase(s, x, aslot, cur, my_side);
    }
}

// _step_chase: the chased range's current row to a text offset, then
// joinedToTextOff and the rescue window of resolveOutstandingInRef
__device__ void step_chase(Lane& s, const Ctx& x) {
    const IlvArgs& a = x.a;
    const int slot = s.ch_slot;
    const int32_t drv = rec_at(x, slot, s.ch_idx)[0];
    const bool anchor_is_left = s.ch_side > 0;
    const int combo = combo_of(s.phase, anchor_is_left);
    const int64_t alen = lane4(a.alen_c, x, combo);
    const int32_t efw = a.efw_tab[slot * a.nd + drv];
    const BtFM& fm = efw > 0 ? a.fw : a.bw;
    const uint32_t spread = s.ch_bot - s.ch_top;
    uint32_t ri = s.ch_r + (uint32_t)s.ch_k;
    if (ri >= s.ch_bot) ri -= spread;
    int64_t off;
    if (a.dense) {
        off = __ldg(fm.sa + ri);
    } else {
        // one LF step of the walk left to a marked row per iteration
        // (reportChaseOne, ebwt.h:2727-2746)
        const uint32_t row = s.r_walk == 0 ? ri : s.r_row;
        const int64_t jumps = s.r_walk == 0 ? 0 : s.r_jumps;
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
        off = at_z ? jumps : (int64_t)__ldg(fm.offs + (row >> fm.off_rate))
                                 + jumps;
    }
    // joinedToTextOff (ebwt.h:2569-2629), the anchor's length
    int64_t start = 0, upper = a.length, tidx = 0, toff0 = 0;
    if (a.nfrag != 1) {
        int lo = 0, hi = a.nfrag;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (a.rstarts[3 * mid] <= off) lo = mid + 1;
            else hi = mid;
        }
        const int elt = lo > 0 ? lo - 1 : a.nfrag - 1;
        start = a.rstarts[3 * elt];
        upper = elt + 1 < a.nfrag ? a.rstarts[3 * (elt + 1)] : a.length;
        tidx = a.rstarts[3 * elt + 1];
        toff0 = a.rstarts[3 * elt + 2];
    }
    if (off + alen > upper) {
        // spans fragments: the next row, with no attempt
        advance_row(s, x);
        return;
    }
    int64_t fragoff = off - start;
    if (efw == 0) fragoff = (upper - start) - fragoff - 1 - (alen - 1);
    const int64_t toff = fragoff + toff0;

    // the rescue window; match_right is anchor_is_left
    const int64_t qlen = lane4(a.qlen_c, x, combo);
    const int64_t reflen = a.reflen[tidx];
    const int64_t minins = a.minins[x.b], maxins = a.maxins[x.b];
    int64_t begin, end;
    if (anchor_is_left) {
        const int64_t insdiff = maxins - minins;
        end = toff + maxins;
        begin = toff + 1 + (qlen < alen ? alen - qlen : 0);
        if (end > insdiff + qlen) begin = max64(begin, end - insdiff - qlen);
        end = min64(reflen, end);
        begin = min64(reflen, begin);
    } else {
        begin = toff + alen < maxins ? 0 : toff + alen - maxins;
        end = min64(toff + min64(alen, qlen) - 1,
                    toff + alen - minins + qlen - 1);
        if (toff + alen + qlen < minins + 1) end = 0;
    }
    if (lane4(a.wok_c, x, combo) > 0 && end - begin >= qlen
        && lane4(a.qn_c, x, combo) == 0) {
        s.sc_tidx = tidx;
        s.sc_toff = toff;
        s.sc_begin = begin;
        s.sc_end = end;
        s.sc_combo = combo;
        s.mode = I_SCAN;
    } else {
        // rejected before its scan: still an attempt
        advance_attempt_and_row(s, x);
    }
}

// _step_scan: RefAligner::find, the candidates in zig-zag order from the
// middle of the window, the first valid one wins
__device__ void step_scan(Lane& s, const Ctx& x) {
    const IlvArgs& a = x.a;
    const int combo = s.sc_combo;
    const int64_t qlen = lane4(a.qlen_c, x, combo);
    const bool sol = lane4(a.sol_c, x, combo) > 0;
    const int64_t reflen = a.reflen[s.sc_tidx];
    const uint8_t* ref = a.refcat + a.refbase[s.sc_tidx];
    const size_t qrow = (4 * (size_t)x.b + combo) * a.Lq;
    const uint8_t* q = a.q_c + qrow;
    const int32_t* pen = a.pen_c + qrow;
    const int64_t qbegin = sol ? s.sc_begin : s.sc_begin + qlen;
    const int64_t qend = sol ? s.sc_end - qlen : s.sc_end;
    const int64_t lim = qend - qbegin;
    const int64_t halfway = qbegin + (lim >> 1);
    const int slen = (int)(a.v >= 0 ? qlen : min64(a.seed_len, qlen));
    for (int64_t i = 1; i <= lim + 1; ++i) {
        const int64_t ri = (i & 1) ? halfway - (i >> 1) : halfway + (i >> 1);
        const int64_t left = sol ? ri : ri - qlen;
        if (left < 0 || left + qlen > reflen) continue;
        const uint8_t* w = ref + left;
        int mm = 0, smm = 0, ham = 0;
        bool ok = true;
        for (int j = 0; j < qlen; ++j) {
            const uint8_t c = w[j];
            if (c > 3) {
                ok = false;
                break;
            }
            if (c == q[j]) continue;
            ++mm;
            if (a.v >= 0) {
                if (mm > a.v) {
                    ok = false;
                    break;
                }
            } else {
                if (sol ? j < slen : j >= qlen - slen) ++smm;
                ham += pen[j];
                if (smm > a.seed_mms || ham > a.qual_max) {
                    ok = false;
                    break;
                }
            }
        }
        if (!ok) continue;
        // the pair reports and the lane is done (-k 1)
        s.res[R_FOUND] = 1;
        s.res[R_SLOT] = s.ch_slot;
        s.res[R_IDX] = s.ch_idx;
        s.res[R_TIDX] = s.sc_tidx;
        s.res[R_TOFF] = s.sc_toff;
        s.res[R_LEFT] = left;
        s.res[R_STRAT] = a.v >= 0 ? mm : smm;
        s.res[R_HAM] = a.v >= 0 ? 0 : ham;
        s.res[R_PHASE] = s.phase;
        s.res[R_SIDE] = s.ch_side;
        s.mode = I_DONE;
        return;
    }
    advance_attempt_and_row(s, x);
}

__global__ void __launch_bounds__(kThreads) ilv_kernel(const IlvArgs a) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const Ctx x{a, b, a.hits + (size_t)b * 4 * H_MAX * REC_W};
    Lane s = {};
    s.mode = I_ILV;
    s.rng = (uint32_t)a.seeds[b];
    s.ch_bot = 1;
    int it = 0;
    for (; it < a.max_steps && s.mode != I_DONE; ++it) {
        if (s.mode == I_ILV) step_ilv(s, x);
        if (s.mode == I_CHASE) step_chase(s, x);
        if (s.mode == I_SCAN) step_scan(s, x);
    }
    int64_t* o = a.out + b;
    const size_t B = a.B;
    for (int k = 0; k < 10; ++k) o[k * B] = s.res[k];
    o[10 * B] = (s.escalate || s.mode != I_DONE) ? 1 : 0;
    o[11 * B] = s.mode;
    o[12 * B] = it;
}

}  // namespace

extern "C" {

int bt_pe_ilv(const IlvArgs* a, void* stream) {
    ilv_kernel<<<(a->B + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

}  // extern "C"
