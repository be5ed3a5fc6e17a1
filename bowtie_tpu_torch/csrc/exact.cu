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
// Plain PyTorch versions: exact_ranges_plain / resolve_rows_plain in
// align/exact.py, one_row_plain in align/pipeline.py,
// exact_ranges_cat_plain in align/pe_device.py, align_step_plain in
// parallel/mesh.py.
//
// What bounds them: every LF step of a range end reads one 32-byte
// sector of occ and one of BWT words (fm.cuh), and the steps of one lane
// depend on each other, so a lane is a chain of dependent random sector
// reads: 2 sectors per LF step per range end in K2, 2 per walk step in
// K3, plus 2 ftab sectors per strand, the read's bytes in and the results
// out.  The index of a bacterial genome fits in the 50 MB L2, so those
// sectors mostly come from L2, and the kernels are latency-bound.
//
// What the design does about it: one thread per strand (K2, K4) or per
// row (K3), enough threads to cover the latency, vector loads (one
// 16-byte occ row, one 32-byte word block per rank), and early exits the
// TPU's lockstep scan cannot take: K2 stops as soon as its range is
// empty (an inactive lane of the scan keeps its values, so the result is
// the same), K3 walks each row only to its own marked row instead of the
// whole batch's longest walk.  Keeping a read's occ/ftab working set in
// shared memory, warp-cooperative walks and CUDA graphs over the batch
// loop are later work.
#include "fm.cuh"

namespace {

constexpr int kThreads = 256;

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

// K3 for one row: the joined-text offset, by a dense-SA gather or by
// walking left with LF until a row marked in the SA sample or zoff
// (reportChaseOne, ebwt.h:2727-2746).  ok=false past kMaxWalk steps,
// with the same offset the reference computes in that case.
template <bool DENSE>
__device__ __forceinline__ uint32_t resolve_one(const BtFM& fm, uint32_t row,
                                                bool& ok) {
    if (DENSE) {
        ok = true;
        return __ldg(fm.sa + row);
    }
    const uint32_t mask = (1u << fm.off_rate) - 1u;
    uint32_t i = row, jumps = 0;
    for (int it = 0; it < kMaxWalk; ++it) {
        if ((i & mask) == 0 || i == fm.zoff) break;
        i = lf_row(fm, i);
        ++jumps;
    }
    const bool at_z = i == fm.zoff;
    ok = at_z || (i & mask) == 0;
    return at_z ? jumps : __ldg(fm.offs + (i >> fm.off_rate)) + jumps;
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

template <bool DENSE>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const BtFM fm, const int64_t* __restrict__ rows, int n,
               int64_t* __restrict__ off, bool* __restrict__ ok) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    bool good;
    off[b] = resolve_one<DENSE>(fm, (uint32_t)rows[b], good);
    ok[b] = good;
}

// K4: K2, then the per-strand pick top + r % spread with the first
// RandomSource::nextU32 draw of the read's seed (random_source.h:36-42;
// reportFullAlignment, ebwt_search_backtrack.h:1536-1540), then K3.
// out is [3, n]: spread, offset, ok.
template <bool DENSE>
__global__ void __launch_bounds__(kThreads)
one_row_kernel(const BtFM fm, const uint8_t* __restrict__ reads,
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
    const uint32_t o = resolve_one<DENSE>(fm, spread > 0 ? row : 0u, good);
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
align_step_kernel(const BtFM fm, const uint8_t* __restrict__ reads,
                  const int32_t* __restrict__ lens, int n, int L,
                  int64_t* __restrict__ top, int64_t* __restrict__ bot,
                  int64_t* __restrict__ off, bool* __restrict__ ok) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    uint32_t t, u;
    exact_one(fm, reads + (size_t)b * L, L, lens[b], t, u);
    bool good = false;
    uint32_t o = 0xFFFFFFFFu;
    if (u > t) o = resolve_one<DENSE>(fm, t, good);
    top[b] = t;
    bot[b] = u;
    off[b] = o;
    ok[b] = good;
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

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

int bt_resolve_walk(const BtFM* fm, const void* rows, int n, void* off,
                    void* ok, void* stream) {
    resolve_kernel<false><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        *fm, (const int64_t*)rows, n, (int64_t*)off, (bool*)ok);
    return (int)cudaGetLastError();
}

int bt_resolve_sa(const BtFM* fm, const void* rows, int n, void* off,
                  void* ok, void* stream) {
    resolve_kernel<true><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        *fm, (const int64_t*)rows, n, (int64_t*)off, (bool*)ok);
    return (int)cudaGetLastError();
}

int bt_one_row(const BtFM* fm, const void* reads, const void* lens,
               const void* seeds, int n, int L, int dense, void* out,
               void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dense)
        one_row_kernel<true><<<grid_for(n), kThreads, 0, s>>>(
            *fm, (const uint8_t*)reads, (const int32_t*)lens,
            (const int64_t*)seeds, n, L, (int64_t*)out);
    else
        one_row_kernel<false><<<grid_for(n), kThreads, 0, s>>>(
            *fm, (const uint8_t*)reads, (const int32_t*)lens,
            (const int64_t*)seeds, n, L, (int64_t*)out);
    return (int)cudaGetLastError();
}

int bt_align_step(const BtFM* fm, const void* reads, const void* lens,
                  int n, int L, int dense, void* top, void* bot, void* off,
                  void* ok, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dense)
        align_step_kernel<true><<<grid_for(n), kThreads, 0, s>>>(
            *fm, (const uint8_t*)reads, (const int32_t*)lens, n, L,
            (int64_t*)top, (int64_t*)bot, (int64_t*)off, (bool*)ok);
    else
        align_step_kernel<false><<<grid_for(n), kThreads, 0, s>>>(
            *fm, (const uint8_t*)reads, (const int32_t*)lens, n, L,
            (int64_t*)top, (int64_t*)bot, (int64_t*)off, (bool*)ok);
    return (int)cudaGetLastError();
}

const char* bt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
