// K13: the V1 interleave, chase and rescue of bowtie's default paired
// command (-k 1 without -m) over the anchor streams the recorder (K12,
// K10r) wrote.  Built with the other sources by bowtie_tpu_torch/kernels.py
// and called through the plain C entry point at the bottom.
//
// Replaces bowtie_tpu/align/pe_ilv_device.py:527 run_ilv_chunk over :503
// _machine_step (:151 _step_ilv, :262 _step_chase, :400 _step_scan) and
// the drivers :542 run_ilv and :535 _compact_ilv, with K1 (mapLF,
// lf_row_word below) inlined.  Plain version, which this is held to:
// run_ilv_plain in bowtie_tpu_torch/align/pe_ilv_device.py.
//
// One warp per pair, kWarps warps a block.  Every thread of a warp runs
// its pair's state machine on the same scalar state
// until I_DONE, counting iterations as the lockstep plain version does:
// one iteration applies step_ilv, then step_chase (one LF step of a
// walk), then step_scan, each only if the pair is then in that mode, and
// a pair gets max_steps iterations (4096) before it escalates.  The bookkeeping, the chase and the LCG (one draw per chase)
// read the same addresses in every thread of the warp, so the warp never
// diverges and its loads are broadcasts; a step reads and writes only its
// own pair, so every pair ends in the plain version's state, escalations
// included.  Each step below is the scalar form of the plain step of the
// same name: the same reads and writes under the same conditions.
//
// The scan is where a pair spends its time (bowtie's zig-zag rescue: up
// to lim + 1 candidates a scan, a pair up to --pairtries scans a phase),
// and it is what the warp shares.  On entering SCAN the warp stages, with
// coalesced loads, the query row (and, seeded, its penalties) and two
// pieces of kPiece reference bytes into its shared memory: the left piece
// for the candidates left of the window's middle, the right one for those
// right of it.  Then each pass takes 32 consecutive zig-zag indices i0 ..
// i0 + 31 (i = 1..lim+1, ri = halfway -/+ (i >> 1); ref_aligner.h:
// 204-212, best_paired.py RefAlignerPy.score): thread t compares candidate
// i0 + t from shared memory four bases a step (a word of reference bytes
// against a word of the query, byte-wise), leaving at its first failing
// step; __ballot_sync gathers the valid ones and the least set bit, the
// least i, wins, which is the candidate the serial zig-zag loop stops at.
// Its mismatch counts reach the warp through __shfl_sync.  A pass reads at
// most 15 + qlen bytes a side, so a piece is restaged only when the
// passes have moved out of it: a window of up to kPiece bytes a side (the
// whole window at the default -X 250) is staged once, a larger one in
// pieces, each new piece reaching as far outward as it can.  A step
// reads the word after its bytes too, so each piece is followed in the
// warp's buffer by more of it (the right piece, or the query row).
//
// The lane state lives in registers: each slot's next record as a 5-bit
// field of one word (at most H_MAX = 16) and the done slots as a 4-bit
// mask, read by shift and mask; a found pair's results are written out
// where the scan finds them.  Only what a step can read before it writes
// it is initialised.  The arguments are copied once a block into shared
// memory, ahead of the warps' buffers.
//
// Types: BWT rows uint32_t, text offsets and candidate counts int64_t
// (the reference's int32 counts clamp sym_ceiling; these need not).
//
// What bounds K13: a pair is a chain of dependent steps (a chase is a
// dependent SA read, or a walk of dependent rank reads, two 32-byte
// sectors per LF step; a scan is at most a few passes of shared-memory
// compares behind one staging of a few hundred bytes), and the slowest
// pair sets the launch: latency, not bandwidth or arithmetic (on the
// H100 about 10 us an iteration for a pair that scans, 0.56 us an LF step
// of a walk; PERF.md).
#include "fm.cuh"

namespace {

constexpr int H_MAX = 16, REC_W = 24;
constexpr int I_ILV = 0, I_CHASE = 1, I_SCAN = 2, I_DONE = 3;
constexpr int64_t OFFS_SAT = int64_t(1) << 29;
constexpr int kWarps = 4;         // warps (pairs) a block
constexpr int kPiece = 256;       // bytes of each of a warp's two pieces
constexpr int kMaxLq = 64;        // the widest query row
// a warp's shared bytes: the penalties (int32), the two pieces, the query
constexpr int kWarpBytes = 4 * kMaxLq + 2 * kPiece + kMaxLq;
constexpr unsigned kFull = 0xFFFFFFFFu;

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
    int64_t* out;               // [13][B]
};

// a block's shared memory: the arguments, then each warp's buffers
extern __shared__ __align__(16) unsigned char bt_ilv_smem[];

namespace {

constexpr int kArgsBytes = (int)((sizeof(IlvArgs) + 15) / 16 * 16);
constexpr int kShared = kArgsBytes + kWarps * kWarpBytes;

struct Lane {
    int32_t mode, phase;
    uint32_t cur;               // next record of slot k: bits 5k..5k+4
    uint32_t sdone;             // slot k done: bit k
    int64_t offs_l, offs_r;
    int32_t del_l, del_r, dl_slot, dl_idx, dr_slot, dr_idx, attempts,
        p_valid, p_slot, p_idx, p_side;
    uint32_t rng;
    int32_t ch_slot, ch_idx, ch_k, ch_side, r_walk;
    uint32_t ch_top, ch_bot, ch_r, r_row;
    int64_t r_jumps;
    int64_t sc_tidx, sc_toff, sc_begin, sc_end;
    int32_t sc_combo;
    int32_t staged;             // the combo whose query the warp holds
    int32_t found, escalate;
};

__device__ __forceinline__ int cur_get(const Lane& s, int slot) {
    return (int)((s.cur >> (5 * slot)) & 31u);
}

__device__ __forceinline__ void cur_set(Lane& s, int slot, int v) {
    s.cur = (s.cur & ~(31u << (5 * slot))) | ((uint32_t)v << (5 * slot));
}

__device__ __forceinline__ bool done_get(const Lane& s, int slot) {
    return (s.sdone >> slot) & 1u;
}

// per-warp view of the arguments
struct Ctx {
    const IlvArgs& a;
    int b, t;                   // the pair; this thread's lane
    const int32_t* hits;        // this pair's [4][H_MAX][REC_W]
    int32_t* pen_s;             // the warp's query penalties [kMaxLq]
    uint8_t* ref_s;             // its left and right pieces [2][kPiece]
    uint8_t* q_s;               // its query row [kMaxLq]
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
__device__ __forceinline__ void sched_chase(Lane& s, const Ctx& x, int slot,
                                            int idx, int side) {
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
__device__ __forceinline__ void phase_advance(Lane& s) {
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
__device__ __forceinline__ void chase_done_no_hit(Lane& s, const Ctx& x) {
    if (s.p_valid > 0) {
        s.p_valid = 0;
        sched_chase(s, x, s.p_slot, s.p_idx, s.p_side);
    } else {
        s.mode = I_ILV;
    }
}

// _advance_row
__device__ __forceinline__ void advance_row(Lane& s, const Ctx& x) {
    s.ch_k += 1;
    s.r_walk = 0;
    if ((uint32_t)s.ch_k >= s.ch_bot - s.ch_top) chase_done_no_hit(s, x);
    else s.mode = I_CHASE;
}

// _advance_attempt_and_row
__device__ __forceinline__ void advance_attempt_and_row(Lane& s,
                                                        const Ctx& x) {
    s.attempts += 1;
    if (s.attempts > x.a.attempt_lim) {
        s.p_valid = 0;
        phase_advance(s);
        return;
    }
    advance_row(s, x);
}

// _step_ilv: one iteration of advanceOrientation's while-loop
__device__ __forceinline__ void step_ilv(Lane& s, const Ctx& x) {
    const IlvArgs& a = x.a;
    const int ls = s.phase == 0 ? a.slot_l0 : a.slot_l1;
    const int rs = s.phase == 0 ? a.slot_r0 : a.slot_r1;
    const bool ldone = done_get(s, ls), rdone = done_get(s, rs);
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
    const int cur = cur_get(s, aslot);
    const int n = lane4(a.nrec, x, aslot);
    const bool cap = lane4(a.capped, x, aslot) > 0;
    if (cur >= n) {
        // past the end of a capped stream: ReplayTruncated; an exhausted
        // uncapped stream is done with no range
        if (cap) {
            s.escalate = 1;
            s.mode = I_DONE;
        } else {
            s.sdone |= 1u << aslot;
        }
        return;
    }
    const int32_t* r = rec_at(x, aslot, cur);
    const int64_t top = (uint32_t)r[1], bot = (uint32_t)r[2];
    if (r[6] == 1 || (cur + 1 >= n && !cap)) s.sdone |= 1u << aslot;
    cur_set(s, aslot, cur + 1);
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
    if (ot_del > 0) {
        // the other side's delayed range (written when it was delayed)
        const int32_t ot_dslot = myL ? s.dr_slot : s.dl_slot;
        const int32_t ot_didx = myL ? s.dr_idx : s.dl_idx;
        if (ot_offs < my2) {
            // the swap: the delayed range first, then this one
            s.del_l = s.del_r = 0;
            s.p_valid = 1;
            s.p_slot = aslot;
            s.p_idx = cur;
            s.p_side = my_side;
            sched_chase(s, x, ot_dslot, ot_didx, 1 - my_side);
            return;
        }
        if (myL) s.del_r = 0;
        else s.del_l = 0;
        s.p_valid = 1;
        s.p_slot = ot_dslot;
        s.p_idx = ot_didx;
        s.p_side = 1 - my_side;
    }
    sched_chase(s, x, aslot, cur, my_side);
}

// mapLF(i) (ops/fm.py lf_row_compact_plain), the row's own code read from
// its word (a select from the block's words by a run-time index would put
// them on the stack)
__device__ __forceinline__ uint32_t lf_row_word(const BtFM& fm, uint32_t i) {
    const uint32_t block = i / kOccBlock, rem = i % kOccBlock;
    const uint4 o = __ldg(fm.occ + block);
    uint32_t w[kWordsPerBlock];
    block_words(fm, block, w);
    const uint32_t c =
        (__ldg(fm.bwt + (size_t)block * kWordsPerBlock + (rem >> 4))
         >> (2 * (rem & 15))) & 3u;
    const uint32_t corr = (c == 0 && i > fm.zoff) ? 1u : 0u;
    return fchr_get(fm, c) + occ_get(o, c) + count_in_block(w, c, rem)
        - corr;
}

// _step_chase: the chased range's current row to a text offset, then
// joinedToTextOff and the rescue window of resolveOutstandingInRef
__device__ __forceinline__ void step_chase(Lane& s, const Ctx& x) {
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
            s.r_row = lf_row_word(fm, row);
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

// reference bytes [p0, p0 + kPiece) into a piece of the warp's shared
// memory, coalesced; bytes outside [0, reflen), which no candidate in
// range reads, as N
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* ref,
                                      int64_t p0, int64_t reflen, int t) {
    __syncwarp();               // every read of the old bytes is done
    for (int k = t; k < kPiece; k += 32) {
        const int64_t p = p0 + k;
        dst[k] = p >= 0 && p < reflen ? __ldg(ref + p) : (uint8_t)4;
    }
    __syncwarp();
}

// the high bit of each byte of x that is not zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
    return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// the four bytes from byte p of a word-aligned buffer, lowest first
__device__ __forceinline__ uint32_t bytes4(const uint32_t* r, int p) {
    const uint64_t two = (uint64_t)r[(p >> 2) + 1] << 32 | r[p >> 2];
    return (uint32_t)(two >> (8 * (p & 3)));
}

// the zig-zag candidate i's text position ri
__device__ __forceinline__ int64_t zigzag(int64_t halfway, int64_t i) {
    return (i & 1) ? halfway - (i >> 1) : halfway + (i >> 1);
}

// _step_scan: RefAligner::find, the candidates in zig-zag order from the
// middle of the window, the first valid one wins; 32 candidates a pass
__device__ __forceinline__ void step_scan(Lane& s, const Ctx& x) {
    const IlvArgs& a = x.a;
    const int combo = s.sc_combo;
    const int qlen = lane4(a.qlen_c, x, combo);
    const bool sol = lane4(a.sol_c, x, combo) > 0;
    const int64_t reflen = a.reflen[s.sc_tidx];
    const uint8_t* ref = a.refcat + a.refbase[s.sc_tidx];
    const int64_t qbegin = sol ? s.sc_begin : s.sc_begin + qlen;
    const int64_t qend = sol ? s.sc_end - qlen : s.sc_end;
    const int64_t lim = qend - qbegin;
    const int64_t halfway = qbegin + (lim >> 1);
    const int64_t shift = sol ? 0 : qlen;       // left = ri - shift
    const int slen = (int)(a.v >= 0 ? qlen : min64(a.seed_len, qlen));
    // the bases compared: the row's first Lq, as the plain scan compares
    // (ilv_inputs makes rows of at least qlen bases)
    const int ncmp = qlen < a.Lq ? qlen : a.Lq;
    if (combo != s.staged) {
        const size_t qrow = (4 * (size_t)x.b + combo) * a.Lq;
        __syncwarp();
        for (int j = x.t; j < ncmp; j += 32) {
            x.q_s[j] = a.q_c[qrow + j];
            if (a.v < 0) x.pen_s[j] = a.pen_c[qrow + j];
        }
        __syncwarp();
        s.staged = combo;
    }
    // the pieces' first positions; a piece not staged yet starts empty
    int64_t lp = 0, rp = 0;
    bool lok = false, rok = false;
    for (int64_t i0 = 1; i0 <= lim + 1; i0 += 32) {
        // the pass: indices i0 (odd) .. il; the odd ones
        // left of the middle, the even ones right of it.  The bytes each
        // side reads, clipped to the reference (a candidate out of it is
        // skipped), must lie in that side's piece.
        const int64_t il = min64(i0 + 31, lim + 1);
        const int64_t il_odd = (il & 1) ? il : il - 1;
        int64_t lo = max64(zigzag(halfway, il_odd) - shift, 0);
        int64_t hi = min64(zigzag(halfway, i0) - shift + qlen, reflen);
        if (lo < hi && !(lok && lo >= lp && hi <= lp + kPiece)) {
            lp = hi - kPiece;
            lok = true;
            stage(x.ref_s, ref, lp, reflen, x.t);
        }
        if (i0 + 1 <= il) {
            lo = max64(zigzag(halfway, i0 + 1) - shift, 0);
            hi = min64(zigzag(halfway, il - (il & 1)) - shift + qlen,
                       reflen);
            if (lo < hi && !(rok && lo >= rp && hi <= rp + kPiece)) {
                rp = lo;
                rok = true;
                stage(x.ref_s + kPiece, ref, rp, reflen, x.t);
            }
        }
        const int64_t i = i0 + x.t;
        const int64_t left = zigzag(halfway, i) - shift;
        bool ok = i <= il && left >= 0 && left + qlen <= reflen;
        int mm = 0, smm = 0, ham = 0;
        if (ok) {
            // four bases a step: a reference N, or the counts past their
            // limits, fails the candidate wherever it lies (the counts
            // only grow), and a valid one is compared whole
            const uint32_t* r = reinterpret_cast<const uint32_t*>(
                (i & 1) ? x.ref_s : x.ref_s + kPiece);
            const int p0 = (int)(left - ((i & 1) ? lp : rp));
            const uint32_t* q = reinterpret_cast<const uint32_t*>(x.q_s);
            for (int j = 0; j < ncmp; j += 4) {
                const uint32_t keep = ncmp - j >= 4
                    ? 0x80808080u : 0x80808080u >> (8 * (4 - (ncmp - j)));
                const uint32_t c = bytes4(r, p0 + j);
                if (nonzero_bytes(c & 0xFCFCFCFCu) & keep) {
                    ok = false;
                    break;
                }
                uint32_t ne = nonzero_bytes(c ^ q[j >> 2]) & keep;
                if (ne == 0) continue;
                if (a.v >= 0) {
                    mm += __popc(ne);
                    if (mm > a.v) {
                        ok = false;
                        break;
                    }
                    continue;
                }
                do {
                    const int jj = j + ((__ffs((int)ne) - 1) >> 3);
                    ne &= ne - 1;
                    if (sol ? jj < slen : jj >= qlen - slen) ++smm;
                    ham += x.pen_s[jj];
                } while (ne);
                if (smm > a.seed_mms || ham > a.qual_max) {
                    ok = false;
                    break;
                }
            }
        }
        const unsigned hit = __ballot_sync(kFull, ok);
        if (hit == 0) continue;
        // the least valid index wins: the pair reports and is done (-k 1)
        const int k = __ffs((int)hit) - 1;
        const int strat = __shfl_sync(kFull, a.v >= 0 ? mm : smm, k);
        const int wham = __shfl_sync(kFull, a.v >= 0 ? 0 : ham, k);
        if (x.t == 0) {
            int64_t* o = a.out + x.b;
            const size_t B = a.B;
            o[0] = 1;
            o[B] = s.ch_slot;
            o[2 * B] = s.ch_idx;
            o[3 * B] = s.sc_tidx;
            o[4 * B] = s.sc_toff;
            o[5 * B] = zigzag(halfway, i0 + k) - shift;
            o[6 * B] = strat;
            o[7 * B] = wham;
            o[8 * B] = s.phase;
            o[9 * B] = s.ch_side;
        }
        s.found = 1;
        s.mode = I_DONE;
        return;
    }
    advance_attempt_and_row(s, x);
}

__global__ void __launch_bounds__(kWarps * 32)
ilv_kernel(const IlvArgs args) {
    IlvArgs& a = *reinterpret_cast<IlvArgs*>(bt_ilv_smem);
    if (threadIdx.x == 0) a = args;
    __syncthreads();
    const int w = threadIdx.x / 32;
    const int b = blockIdx.x * kWarps + w;
    if (b >= a.B) return;       // whole warps
    unsigned char* buf = bt_ilv_smem + kArgsBytes + w * kWarpBytes;
    const Ctx x{a, b, (int)(threadIdx.x % 32),
                a.hits + (size_t)b * 4 * H_MAX * REC_W,
                reinterpret_cast<int32_t*>(buf), buf + 4 * kMaxLq,
                buf + 4 * kMaxLq + 2 * kPiece};
    Lane s;
    s.mode = I_ILV;
    s.phase = 0;
    s.cur = s.sdone = 0;
    s.offs_l = s.offs_r = 0;
    s.del_l = s.del_r = 0;
    s.attempts = s.p_valid = 0;
    s.rng = (uint32_t)a.seeds[b];
    s.staged = -1;
    s.found = s.escalate = 0;
    int it = 0;
    for (; it < a.max_steps && s.mode != I_DONE; ++it) {
        if (s.mode == I_ILV) step_ilv(s, x);
        if (s.mode == I_CHASE) step_chase(s, x);
        if (s.mode == I_SCAN) step_scan(s, x);
    }
    if (x.t == 0) {
        int64_t* o = a.out + b;
        const size_t B = a.B;
        if (!s.found)
            for (int k = 0; k < 10; ++k) o[k * B] = 0;
        o[10 * B] = (s.escalate || s.mode != I_DONE) ? 1 : 0;
        o[11 * B] = s.mode;
        o[12 * B] = it;
    }
}

}  // namespace

extern "C" {

// K13 over a->B pairs: a warp a pair, kWarps pairs a block, kShared
// dynamic shared bytes (pe_ilv_device.ilv_shape describes the launch)
int bt_pe_ilv(const IlvArgs* a, void* stream) {
    if (a->B < 1 || a->Lq < 1 || a->Lq > kMaxLq)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((a->B + kWarps - 1) / kWarps);
    ilv_kernel<<<grid, kWarps * 32, kShared, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

// K13's launch constants, for pe_ilv_device.ilv_shape to check against:
// warps a block, the bytes of a reference piece, the widest query row, a
// warp's shared bytes, the arguments' shared bytes
int bt_ilv_warps() { return kWarps; }
int bt_ilv_piece() { return kPiece; }
int bt_ilv_max_lq() { return kMaxLq; }
int bt_ilv_warp_bytes() { return kWarpBytes; }
int bt_ilv_args_bytes() { return kArgsBytes; }

// the local memory (stack) per thread of K13; -1 on an error
int bt_ilv_local_bytes() {
    cudaFuncAttributes at;
    return cudaFuncGetAttributes(&at, ilv_kernel) == cudaSuccess
        ? (int)at.localSizeBytes : -1;
}

}  // extern "C"
