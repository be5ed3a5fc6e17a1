// Exact-match (-v 0) kernels: K2 exact search, K3 offset resolve, K4 the
// fused one-row path.  Built by bowtie_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// and called through the plain C entry points at the bottom.
//
// Replaces:
//   K2 bt_exact_ranges  <- bowtie_tpu/align/exact.py:37  exact_ranges
//   K3 bt_resolve_walk  <- bowtie_tpu/align/exact.py:99  resolve_rows (walk)
//      bt_resolve_sa    <- bowtie_tpu/align/exact.py:99  resolve_rows (dense SA)
//   K4 bt_one_row       <- bowtie_tpu/align/pipeline.py:53 _one_row_kernel
//   K12 bt_exact_ranges_cat <- bowtie_tpu/align/pe_device.py:37
//                              exact_ranges_cat
//   K15 bt_align_step   <- bowtie_tpu/parallel/mesh.py:55 sharded_align_step
//                          (one launch per shard of the mesh)
//   bt_walk_table builds the walk table the walks read (no counterpart:
//   the reference walks occ and the BWT words)
// Plain PyTorch versions: exact_ranges_plain / resolve_rows_plain /
// walk_table_plain in align/exact.py, one_row_plain in align/pipeline.py,
// exact_ranges_cat_plain in align/pe_device.py, align_step_plain in
// parallel/mesh.py.
//
// What bounds them: every LF step of a range end reads one 32-byte
// sector of occ and one of BWT words (fm.cuh), and the steps of one lane
// depend on each other, so a lane is a chain of dependent random sector
// reads: 2 sectors per LF step per range end in K2, plus 2 ftab sectors
// per strand, the read's bytes in and the results out.  A walk-left step
// (K3, K4, K15) reads one sector of the walk table.  The index of a
// bacterial genome fits in the 50 MB L2, so those sectors mostly come
// from L2.  K2 and K4 are latency-bound: a strand is a chain of ~26
// search steps and a walk.  K3's walk-left over millions of rows is
// bound by instruction issue: the walks are geometric (mean 2^offRate
// steps), so with one row a thread a warp runs as long as its longest
// of 32 walks and three quarters of its issue slots go to lanes that
// have finished.
//
// What the design does about it: one thread per strand (K2, K4, K15),
// vector loads (one 16-byte occ row, one 32-byte word block per rank),
// and early exits the TPU's lockstep scan cannot take: K2 stops as soon
// as its range is empty (an inactive lane of the scan keeps its values,
// so the result is the same).  K4 runs 64 threads a block, so that one
// CLI batch of 16,384 strands spreads over every SM.  K3's walk kernel
// gives each warp a run of rows and keeps every lane busy: a lane whose
// row has stopped writes it and takes the run's next row (a ballot of the
// lanes that need one, each lane's rank by popcount), a warp whose run is
// out takes the next by atomicAdd, and the grid is sized to the card.
// Each row's result does not depend on the schedule.
#include "fm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOneRowThreads = 64;     // K4: a CLI batch fills every SM
constexpr int kWalkWarps = 4;          // K3 walk: warps a block
constexpr int kWalkFill = 2;           // K3 walk: 1 / the occupancy used

// K2 for one strand: ftab jump on the last ftab_chars columns, then one
// LF per remaining column right to left; an N closes the range.  `q` is
// the strand's row of the right-aligned [n, L] matrix (pad code 4 on the
// left), `len` its length.  Returns (top, bot), both 0 when empty.
__device__ __forceinline__ void exact_one(const BtFM& fm, const uint8_t* q,
                                          int L, int len, uint32_t& top_out,
                                          uint32_t& bot_out) {
    const int fc = fm.ftab_chars;
    uint32_t top = 0, bot = fm.bwt_len;
    int start = L;                       // first consumed column + 1
    if (L >= fc) {
        bool ok = len >= fc;
        uint32_t foff = 0;
        for (int j = L - fc; j < L; ++j) {
            const uint32_t c = q[j];
            ok = ok && c < 4;
            foff = foff * 4 + (c < 4 ? c : 0);
        }
        if (ok) {
            top = __ldg(fm.ftab_hi + foff);
            bot = __ldg(fm.ftab_lo + foff + 1);
            start = L - fc;
        }
    }
    const int stop = L - len;
    for (int col = start - 1; col >= stop && bot > top; --col) {
        const uint32_t c = q[col];
        if (c > 3) {
            top = 0;
            bot = 0;
        } else {
            top = lf(fm, top, c);
            bot = lf(fm, bot, c);
        }
    }
    const bool hit = bot > top;
    top_out = hit ? top : 0;
    bot_out = hit ? bot : 0;
}

// The end of one walk: the joined-text offset and ok from the row `i`
// the walk stopped at after `jumps` steps (reportChaseOne,
// ebwt.h:2727-2746), `base` being offs[i >> off_rate] unless i is zoff.
// ok=false past kMaxWalk steps, with the offset the reference computes
// in that case.
__device__ __forceinline__ uint32_t walk_end(const BtFM& fm, uint32_t i,
                                             uint32_t jumps, uint32_t base,
                                             bool& ok) {
    const bool at_z = i == fm.zoff;
    ok = at_z || (i & ((1u << fm.off_rate) - 1u)) == 0;
    return at_z ? jumps : base + jumps;
}

// K3 for one row: the joined-text offset, by a dense-SA gather or by
// walking left with lf_walk until a row marked in the SA sample or zoff.
template <bool DENSE>
__device__ __forceinline__ uint32_t resolve_one(const BtFM& fm,
                                                const uint4* walk,
                                                uint32_t row, bool& ok) {
    if (DENSE) {
        ok = true;
        return __ldg(fm.sa + row);
    }
    const uint32_t mask = (1u << fm.off_rate) - 1u;
    uint32_t i = row, jumps = 0;
    for (int it = 0; it < kMaxWalk; ++it) {
        if ((i & mask) == 0 || i == fm.zoff) break;
        i = lf_walk(fm, walk, i);
        ++jumps;
    }
    const uint32_t base =
        i == fm.zoff ? 0u : __ldg(fm.offs + (i >> fm.off_rate));
    return walk_end(fm, i, jumps, base, ok);
}

__global__ void __launch_bounds__(kThreads)
exact_ranges_kernel(const BtFM fm, const uint8_t* __restrict__ reads,
                    const int32_t* __restrict__ lens, int n, int L,
                    int64_t* __restrict__ top, int64_t* __restrict__ bot) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    uint32_t t, u;
    exact_one(fm, reads + (size_t)b * L, L, lens[b], t, u);
    top[b] = t;
    bot[b] = u;
}

// One of two index views, chosen field by field: each field is then a
// register select between two kernel-parameter loads.  Selecting the
// whole struct (`first ? a : b`) needs the address of a kernel parameter,
// which copies both views to local memory and puts a local load in every
// LF step of the lane's dependent chain.
__device__ __forceinline__ BtFM pick_fm(bool first, const BtFM& a,
                                        const BtFM& b) {
    BtFM f;
    f.bwt = first ? a.bwt : b.bwt;
    f.occ = first ? a.occ : b.occ;
    f.ftab_hi = first ? a.ftab_hi : b.ftab_hi;
    f.ftab_lo = first ? a.ftab_lo : b.ftab_lo;
    f.offs = first ? a.offs : b.offs;
    f.sa = first ? a.sa : b.sa;
#pragma unroll
    for (int c = 0; c < 5; ++c) f.fchr[c] = first ? a.fchr[c] : b.fchr[c];
    f.zoff = first ? a.zoff : b.zoff;
    f.bwt_len = first ? a.bwt_len : b.bwt_len;
    f.ftab_chars = first ? a.ftab_chars : b.ftab_chars;
    f.off_rate = first ? a.off_rate : b.off_rate;
    return f;
}

// K12: K2 with a per-strand choice of index, for the paired recorder's
// phase 0 (the whole-read exact range of every anchor lane, each mate in
// each orientation on the forward or the mirror index, in one launch).
// efw[b] != 0 searches the forward index, else the mirror; each index
// brings its own ftab, occ, BWT words and zoff (fchr and bwt_len are
// shared, but each view carries its own copy).  Bound and design are
// K2's; a lane's chain touches one index only, and the two indexes of a
// bacterial genome still fit in L2 together.
__global__ void __launch_bounds__(kThreads)
exact_ranges_cat_kernel(const BtFM fw, const BtFM bw,
                        const uint8_t* __restrict__ reads,
                        const int32_t* __restrict__ lens,
                        const uint8_t* __restrict__ efw, int n, int L,
                        int64_t* __restrict__ top,
                        int64_t* __restrict__ bot) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    uint32_t t, u;
    const BtFM fm = pick_fm(efw[b] != 0, fw, bw);
    exact_one(fm, reads + (size_t)b * L, L, lens[b], t, u);
    top[b] = t;
    bot[b] = u;
}

// K3 dense: one thread a row, one gather.
__global__ void __launch_bounds__(kThreads)
resolve_sa_kernel(const BtFM fm, const int64_t* __restrict__ rows, int n,
                  int64_t* __restrict__ off, bool* __restrict__ ok) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    bool good;
    off[b] = resolve_one<true>(fm, nullptr, (uint32_t)rows[b], good);
    ok[b] = good;
}

// K3 walk-left: warp w owns the rows [w * stripe, (w + 1) * stripe), one
// a lane at a time.  Each iteration a lane whose row has stopped (marked,
// zoff or kMaxWalk steps) gathers its SA sample and takes the run's next
// row, ranked among the lanes that need one by a ballot; a lane that took
// a row this iteration steps from the next one on, every other live lane
// takes one lf_walk step; then the stopped rows are written at their own
// index.  The loads of an iteration (SA sample, new row, walk entry) do
// not depend on each other.  A warp whose run is out takes the next
// stripe of rows past the grid's first runs with one atomicAdd on
// `counter`, so that the warps end together.  The warp ends when no run
// is left and its rows have stopped; `iters`, if not null, gets its
// iteration count.
__global__ void __launch_bounds__(32 * kWalkWarps)
walk_kernel(const BtFM fm, const uint4* __restrict__ walk,
            const int64_t* __restrict__ rows, int n, int stripe,
            int* __restrict__ counter, int64_t* __restrict__ off,
            bool* __restrict__ ok, int32_t* __restrict__ iters) {
    const uint32_t lane = threadIdx.x & 31u;
    const int warp = blockIdx.x * kWalkWarps + (int)(threadIdx.x >> 5);
    const int64_t lo = (int64_t)warp * stripe;
    if (lo >= n) return;                          // the whole warp
    int hi = lo + stripe < n ? (int)(lo + stripe) : n;
    bool out = false;                             // no run left to take
    const uint32_t below = (1u << lane) - 1u;
    const uint32_t mask = (1u << fm.off_rate) - 1u;
    int cursor = (int)lo;
    int idx = -1;                                 // the lane's row; < 0: none
    uint32_t i = 0, jumps = 0;
    int it = 0;
    for (;; ++it) {
        const bool at_z = i == fm.zoff;
        const bool stop = idx >= 0 && ((i & mask) == 0 || at_z
                                       || jumps == kMaxWalk);
        const uint32_t base =
            stop && !at_z ? __ldg(fm.offs + (i >> fm.off_rate)) : 0u;
        const bool need = idx < 0 || stop;
        const uint32_t b = __ballot_sync(0xFFFFFFFFu, need);
        const int rank = __popc(b & below), cnt = __popc(b);
        int k = cursor + rank;
        if (cnt > hi - cursor && !out) {
            // the run cannot serve every lane: the lanes past it take the
            // next run, which one atomicAdd hands this warp
            int c = 0;
            if (lane == 0) c = atomicAdd(counter, 1);
            c = __shfl_sync(0xFFFFFFFFu, c, 0);
            const int64_t next = ((int64_t)gridDim.x * kWalkWarps + c)
                                 * stripe;
            const int avail = hi - cursor;
            if (next >= n) {
                out = true;
                cursor = hi;
            } else {
                if (rank >= avail) k = (int)next + rank - avail;
                cursor = (int)next + cnt - avail;
                hi = next + stripe < n ? (int)(next + stripe) : n;
            }
        } else {
            cursor += cnt;
        }
        const bool got = need && k < hi;
        const uint32_t fresh = got ? (uint32_t)__ldg(rows + k) : 0u;
        const bool step = idx >= 0 && !stop;
        const uint32_t next = step ? lf_walk(fm, walk, i) : fresh;
        if (stop) {
            bool good;
            off[idx] = walk_end(fm, i, jumps, base, good);
            ok[idx] = good;
        }
        jumps = step ? jumps + 1 : 0u;
        i = next;
        idx = !need ? idx : got ? k : -1;
        if (!__any_sync(0xFFFFFFFFu, idx >= 0)) break;
    }
    if (iters != nullptr && lane == 0) iters[warp] = it + 1;
}

// K4: K2, then the per-strand pick top + r % spread with the first
// RandomSource::nextU32 draw of the read's seed (random_source.h:36-42;
// reportFullAlignment, ebwt_search_backtrack.h:1536-1540), then K3.
// out is [3, n]: spread, offset, ok.
template <bool DENSE>
__global__ void __launch_bounds__(kOneRowThreads)
one_row_kernel(const BtFM fm, const uint4* __restrict__ walk,
               const uint8_t* __restrict__ reads,
               const int32_t* __restrict__ lens,
               const int64_t* __restrict__ seeds, int n, int L,
               int64_t* __restrict__ out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    uint32_t top, bot;
    exact_one(fm, reads + (size_t)b * L, L, lens[b], top, bot);
    const uint32_t a = 1664525u, c = 1013904223u;
    const uint32_t s1 = a * (uint32_t)seeds[b] + c;
    const uint32_t s2 = a * s1 + c;
    const uint32_t r1 = (s1 >> 16) ^ s2;
    const uint32_t spread = bot - top;
    const uint32_t row = top + r1 % (spread > 0 ? spread : 1u);
    bool good;
    const uint32_t o =
        resolve_one<DENSE>(fm, walk, spread > 0 ? row : 0u, good);
    out[b] = spread;
    out[(size_t)n + b] = o;
    out[2 * (size_t)n + b] = good ? 1 : 0;
}

// K15: K2, then K3 of the range's top row where the range is not empty
// (sharded_align_step, parallel/mesh.py:62-67), in the strand's own
// thread: the reference's jit feeds `top` from one op to the next through
// memory, here it stays in a register.  Outputs top, bot ((0, 0) for no
// range), off (the all-ones uint32 sentinel for no range) and ok (false
// for no range).
template <bool DENSE>
__global__ void __launch_bounds__(kThreads)
align_step_kernel(const BtFM fm, const uint4* __restrict__ walk,
                  const uint8_t* __restrict__ reads,
                  const int32_t* __restrict__ lens, int n, int L,
                  int64_t* __restrict__ top, int64_t* __restrict__ bot,
                  int64_t* __restrict__ off, bool* __restrict__ ok) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    uint32_t t, u;
    exact_one(fm, reads + (size_t)b * L, L, lens[b], t, u);
    bool good = false;
    uint32_t o = 0xFFFFFFFFu;
    if (u > t) o = resolve_one<DENSE>(fm, walk, t, good);
    top[b] = t;
    bot[b] = u;
    off[b] = o;
    ok[b] = good;
}

// The walk table (lf_walk, fm.cuh): entry e = occ[e / 2], plus for an
// odd e the codes of the block's first 64 rows, then the BWT words
// 4e..4e+3.  One thread an entry.
__global__ void __launch_bounds__(kThreads)
walk_table_kernel(const uint4* __restrict__ bwt, const uint4* __restrict__ occ,
                  int n, uint4* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    uint4 o = __ldg(occ + e / 2);
    const uint4 w = __ldg(bwt + e);
    if (e & 1) {
        const uint4 h = __ldg(bwt + e - 1);      // the block's first half
        const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
        uint32_t cnt[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (uint32_t c = 0; c < 4; ++c) {
                const uint32_t m = ~(hw[k] ^ (c * 0x55555555u));
                cnt[c] += __popc(m & (m >> 1) & 0x55555555u);
            }
        o.x += cnt[0];
        o.y += cnt[1];
        o.z += cnt[2];
        o.w += cnt[3];
    }
    out[2 * (size_t)e] = o;
    out[2 * (size_t)e + 1] = w;
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

// K3 walk's launch: the warps of 1 / kWalkFill of the card's resident
// blocks (the occupancy calculator's blocks an SM; half of them measured
// faster than all, fewer warps an SM each with more rows), each with a
// run of 32 to 64 rows: at least one a lane, and runs short enough that
// the warps end together, long enough that the first runs give every
// warp rows.  out = {blocks, threads, stripe}.
int walk_shape(int n, int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0)
        rc = (int)cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, walk_kernel, 32 * kWalkWarps, 0);
    if (rc != 0) return rc;
    const int64_t blocks = (int64_t)sms * per_sm / kWalkFill;
    const int64_t fill = (blocks > 0 ? blocks : 1) * kWalkWarps;
    int64_t stripe = (n + fill - 1) / fill;
    stripe = stripe < 32 ? 32 : stripe > 64 ? 64 : stripe;
    int64_t warps = (n + stripe - 1) / stripe;
    if (warps > fill) warps = fill;
    out[0] = (int)((warps + kWalkWarps - 1) / kWalkWarps);
    out[1] = 32 * kWalkWarps;
    out[2] = (int)stripe;
    return 0;
}

}  // namespace

extern "C" {

int bt_exact_ranges(const BtFM* fm, const void* reads, const void* lens,
                    int n, int L, void* top, void* bot, void* stream) {
    exact_ranges_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        *fm, (const uint8_t*)reads, (const int32_t*)lens, n, L,
        (int64_t*)top, (int64_t*)bot);
    return (int)cudaGetLastError();
}

int bt_exact_ranges_cat(const BtFM* fw, const BtFM* bw, const void* reads,
                        const void* lens, const void* efw, int n, int L,
                        void* top, void* bot, void* stream) {
    exact_ranges_cat_kernel<<<grid_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        *fw, *bw, (const uint8_t*)reads, (const int32_t*)lens,
        (const uint8_t*)efw, n, L, (int64_t*)top, (int64_t*)bot);
    return (int)cudaGetLastError();
}

// K3 walk over the walk table `walk`; counter is one zeroed int; iters
// (may be null) gets each warp's iterations.
int bt_resolve_walk(const BtFM* fm, const void* walk, const void* rows,
                    int n, void* counter, void* off, void* ok, void* iters,
                    void* stream) {
    int shape[3];
    const int rc = walk_shape(n, shape);
    if (rc != 0) return rc;
    walk_kernel<<<shape[0], shape[1], 0, (cudaStream_t)stream>>>(
        *fm, (const uint4*)walk, (const int64_t*)rows, n, shape[2],
        (int*)counter, (int64_t*)off, (bool*)ok, (int32_t*)iters);
    return (int)cudaGetLastError();
}

int bt_walk_shape(int n, void* out) { return walk_shape(n, (int*)out); }

int bt_resolve_sa(const BtFM* fm, const void* rows, int n, void* off,
                  void* ok, void* stream) {
    resolve_sa_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        *fm, (const int64_t*)rows, n, (int64_t*)off, (bool*)ok);
    return (int)cudaGetLastError();
}

// The walk table of n entries from the index's BWT words and occ rows.
int bt_walk_table(const void* bwt, const void* occ, int n, void* out,
                  void* stream) {
    walk_table_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)bwt, (const uint4*)occ, n, (uint4*)out);
    return (int)cudaGetLastError();
}

int bt_one_row(const BtFM* fm, const void* walk, const void* reads,
               const void* lens, const void* seeds, int n, int L, int dense,
               void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (n + kOneRowThreads - 1) / kOneRowThreads;
    if (dense)
        one_row_kernel<true><<<blocks, kOneRowThreads, 0, s>>>(
            *fm, (const uint4*)walk, (const uint8_t*)reads,
            (const int32_t*)lens, (const int64_t*)seeds, n, L,
            (int64_t*)out);
    else
        one_row_kernel<false><<<blocks, kOneRowThreads, 0, s>>>(
            *fm, (const uint4*)walk, (const uint8_t*)reads,
            (const int32_t*)lens, (const int64_t*)seeds, n, L,
            (int64_t*)out);
    return (int)cudaGetLastError();
}

int bt_align_step(const BtFM* fm, const void* walk, const void* reads,
                  const void* lens, int n, int L, int dense, void* top,
                  void* bot, void* off, void* ok, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dense)
        align_step_kernel<true><<<grid_for(n), kThreads, 0, s>>>(
            *fm, (const uint4*)walk, (const uint8_t*)reads,
            (const int32_t*)lens, n, L, (int64_t*)top, (int64_t*)bot,
            (int64_t*)off, (bool*)ok);
    else
        align_step_kernel<false><<<grid_for(n), kThreads, 0, s>>>(
            *fm, (const uint4*)walk, (const uint8_t*)reads,
            (const int32_t*)lens, n, L, (int64_t*)top, (int64_t*)bot,
            (int64_t*)off, (bool*)ok);
    return (int)cudaGetLastError();
}

const char* bt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
