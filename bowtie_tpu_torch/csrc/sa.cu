// K16: one prefix-doubling round of the suffix-array build
// (`bowtie-build --jax-sa`).  Built by bowtie_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// and called through the plain C entry points at the bottom.
//
// Replaces:
//   K16 bt_sa_round <- bowtie_tpu/build/sa.py:137 round_fn
//                      (in :117 suffix_array_jax, loop :151-159)
// Plain PyTorch version: sa_round_plain in build/sa.py.
//
// One round, for ranks r[0..n] and a step k (BIG > every rank):
//   key[i]   = r[i] * (BIG + 1) + (i + k <= n ? r[i + k] : BIG)
//   order    = the indices sorted stably by key (ties keep ascending i)
//   grp[j]   = the number of key changes in the sorted keys up to j
//   nr[order[j]] = grp[j];  maxg = grp[n]
// The host reads maxg once a round and stops when it equals n.
//
// What bounds it: the round must read r once and write nr and order once,
// 12 bytes a suffix (16 if the shifted read r[i+k] is counted as a second
// read of r), so 1.2 GB and 0.36 ms at 3.35 TB/s for 10^8 suffixes.
// Sorting needs far more traffic than that: a radix sort of the packed
// keys moves each key and index twice a digit pass.
//
// What the design does about it: the key is packed into one uint64 and
// only its significant bits are sorted, ceil(log2((BIG+1)^2)) of them, in
// 8-bit digits (7 passes at 10^8 suffixes).  Each LSD pass is three
// parts: a per-tile histogram with shared-memory atomics, an exclusive
// scan of the digit-major count table (scan_uint32 below, written out
// here: no CUB, thrust or torch call), and a stable scatter in which a
// tile's ranks follow input order: each warp takes its 32-element rows in
// order, __match_any_sync and a popcount of the lower lanes rank a lane
// among equal digits of its row, per-warp digit counters in shared memory
// carry the rank across the warp's rows, and an exclusive scan of those
// counters across warps puts the warps in order.  The first pass gathers
// r[i + k] and builds the key itself, so the keys are never written
// unsorted; the last pass scatters the indices straight into `order`.
// The renumbering is a flag kernel, the same scan, and a scatter kernel.
// Onesweep-style single-pass digit scans, fewer and wider passes, and
// sorting only the still-tied groups of later rounds are later work.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // one block = 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;               // 32-element rows
constexpr int kTile = kWarps * kRowsPerWarp * 32;   // 2048 elements
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;             // == kThreads
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;    // 2048 entries
constexpr uint32_t kNoDigit = 0xFFFFFFFFu;

static_assert(kBins == kThreads, "one thread per digit in the scans");

inline size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }
inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Element j of the round: its packed key and its index.  The first pass
// builds them from r; later passes read the previous pass's output.
template <bool FIRST>
__device__ __forceinline__ void load_item(
        long long j, int n1, int k, uint32_t big, const int32_t* r,
        const uint64_t* keys_in, const int32_t* vals_in, uint64_t& key,
        int32_t& val) {
    if (FIRST) {
        const uint32_t r1 = (uint32_t)r[j];
        const uint32_t r2 = j + k < n1 ? (uint32_t)r[j + k] : big;
        key = (uint64_t)r1 * ((uint64_t)big + 1) + r2;
        val = (int32_t)j;
    } else {
        key = keys_in[j];
        val = vals_in[j];
    }
}

// Index of the element that lane `lane` of warp `warp` takes in row `row`
// of tile `tile`: warps own consecutive rows, so a warp's rows, taken in
// order, follow input order.
__device__ __forceinline__ long long elem_index(int tile, int warp, int row,
                                                int lane) {
    return (long long)tile * kTile + (warp * kRowsPerWarp + row) * 32 + lane;
}

// Histogram of one digit over one tile -> table[digit * tiles + tile].
template <bool FIRST>
__global__ void __launch_bounds__(kThreads) hist_kernel(
        const int32_t* r, int n1, int k, uint32_t big,
        const uint64_t* keys_in, const int32_t* vals_in, int shift,
        uint32_t* table, int tiles) {
    __shared__ uint32_t bins[kBins];
    bins[threadIdx.x] = 0;
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int row = 0; row < kRowsPerWarp; ++row) {
        const long long j = elem_index(blockIdx.x, warp, row, lane);
        if (j < n1) {
            uint64_t key;
            int32_t val;
            load_item<FIRST>(j, n1, k, big, r, keys_in, vals_in, key, val);
            atomicAdd(&bins[(key >> shift) & (kBins - 1)], 1u);
        }
    }
    __syncthreads();
    table[(size_t)threadIdx.x * tiles + blockIdx.x] = bins[threadIdx.x];
}

// Stable scatter of one tile by one digit.  `offsets` is the scanned
// digit-major table: offsets[d * tiles + t] elements precede tile t's
// elements of digit d in the output.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
        const int32_t* r, int n1, int k, uint32_t big,
        const uint64_t* keys_in, const int32_t* vals_in, int shift,
        const uint32_t* offsets, int tiles, uint64_t* keys_out,
        int32_t* vals_out) {
    __shared__ uint32_t wcnt[kWarps][kBins];   // per warp, then warp offsets
    __shared__ uint32_t tile_off[kBins];
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
        wcnt[i / kBins][i % kBins] = 0;
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t lower = (1u << lane) - 1u;
    uint64_t key[kRowsPerWarp];
    int32_t val[kRowsPerWarp];
    uint32_t digit[kRowsPerWarp], rank[kRowsPerWarp];
    for (int row = 0; row < kRowsPerWarp; ++row) {
        const long long j = elem_index(blockIdx.x, warp, row, lane);
        const bool ok = j < n1;
        uint32_t d = kNoDigit;
        if (ok) {
            load_item<FIRST>(j, n1, k, big, r, keys_in, vals_in, key[row],
                             val[row]);
            d = (uint32_t)(key[row] >> shift) & (kBins - 1);
        }
        const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
        const uint32_t before = __popc(peers & lower);
        const uint32_t base = ok ? wcnt[warp][d] : 0u;
        __syncwarp();
        // the lowest lane of each digit group advances its counter
        if (ok && before == 0) wcnt[warp][d] = base + __popc(peers);
        __syncwarp();
        digit[row] = d;
        rank[row] = base + before;
    }
    __syncthreads();
    {   // per digit: the elements of the warps before, and the tile's base
        const int d = threadIdx.x;
        uint32_t run = 0;
        for (int w = 0; w < kWarps; ++w) {
            const uint32_t c = wcnt[w][d];
            wcnt[w][d] = run;
            run += c;
        }
        tile_off[d] = offsets[(size_t)d * tiles + blockIdx.x];
    }
    __syncthreads();
    for (int row = 0; row < kRowsPerWarp; ++row) {
        const uint32_t d = digit[row];
        if (d == kNoDigit) continue;
        const size_t pos = (size_t)tile_off[d] + wcnt[warp][d] + rank[row];
        keys_out[pos] = key[row];
        vals_out[pos] = val[row];
    }
}

// In-place exclusive scan of one 2048-entry tile of `a`; the tile's total
// goes to sums[tile].
__global__ void __launch_bounds__(kThreads) scan_tile_kernel(
        uint32_t* a, long long m, uint32_t* sums) {
    __shared__ uint32_t s[kThreads];
    const long long b0 = (long long)blockIdx.x * kScanTile
        + (long long)threadIdx.x * kScanItems;
    uint32_t v[kScanItems];
    uint32_t tot = 0;
    for (int i = 0; i < kScanItems; ++i) {
        v[i] = b0 + i < m ? a[b0 + i] : 0u;
        tot += v[i];
    }
    s[threadIdx.x] = tot;
    __syncthreads();
    for (int off = 1; off < kThreads; off <<= 1) {   // Hillis-Steele
        const uint32_t x = threadIdx.x >= off ? s[threadIdx.x - off] : 0u;
        __syncthreads();
        s[threadIdx.x] += x;
        __syncthreads();
    }
    uint32_t run = s[threadIdx.x] - tot;
    for (int i = 0; i < kScanItems; ++i) {
        if (b0 + i < m) a[b0 + i] = run;
        run += v[i];
    }
    if (threadIdx.x == kThreads - 1) sums[blockIdx.x] = s[kThreads - 1];
}

// Adds the scanned tile totals to each tile of `a`.
__global__ void __launch_bounds__(kThreads) scan_add_kernel(
        uint32_t* a, long long m, const uint32_t* sums) {
    const uint32_t add = sums[blockIdx.x];
    const long long b0 = (long long)blockIdx.x * kScanTile;
    for (int i = threadIdx.x; i < kScanTile; i += kThreads)
        if (b0 + i < m) a[b0 + i] += add;
}

// flags[j] = 1 where the sorted key changes at j (j > 0), else 0.
__global__ void __launch_bounds__(kThreads) flag_kernel(
        const uint64_t* keys, int n1, uint32_t* flags) {
    const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (j < n1) flags[j] = j > 0 && keys[j] != keys[j - 1] ? 1u : 0u;
}

// nr[order[j]] = grp[j], grp = the exclusive scan of the flags plus the
// flag itself; the last element's group is maxg.
__global__ void __launch_bounds__(kThreads) renumber_kernel(
        const uint64_t* keys, const uint32_t* scanned, const int32_t* order,
        int n1, int32_t* nr, int32_t* maxg) {
    const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (j >= n1) return;
    const uint32_t g = scanned[j]
        + (j > 0 && keys[j] != keys[j - 1] ? 1u : 0u);
    nr[order[j]] = (int32_t)g;
    if (j == n1 - 1) *maxg = (int32_t)g;
}

// Scratch entries the scan of m entries needs for its tile sums, at
// every level.
size_t scan_scratch(long long m) {
    const long long tiles = (m + kScanTile - 1) / kScanTile;
    return tiles + (tiles > 1 ? scan_scratch(tiles) : 0);
}

cudaError_t scan_uint32(uint32_t* a, long long m, uint32_t* sums,
                        cudaStream_t s) {
    const int tiles = ceil_div(m, kScanTile);
    scan_tile_kernel<<<tiles, kThreads, 0, s>>>(a, m, sums);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || tiles == 1) return err;
    err = scan_uint32(sums, tiles, sums + tiles, s);
    if (err != cudaSuccess) return err;
    scan_add_kernel<<<tiles, kThreads, 0, s>>>(a, m, sums);
    return cudaGetLastError();
}

// The scratch layout of one round over n1 elements.
struct Layout {
    size_t keys[2], vals[2], table, sums, total;
    explicit Layout(int n1) {
        const int tiles = ceil_div(n1, kTile);
        const long long entries = (long long)kBins * tiles;
        const long long scanned = entries > n1 ? entries : n1;
        size_t at = 0;
        for (int i = 0; i < 2; ++i) {
            keys[i] = at;
            at = align_up(at + (size_t)n1 * sizeof(uint64_t));
        }
        for (int i = 0; i < 2; ++i) {
            vals[i] = at;
            at = align_up(at + (size_t)n1 * sizeof(int32_t));
        }
        table = at;
        at = align_up(at + (size_t)entries * sizeof(uint32_t));
        sums = at;
        total = align_up(at + scan_scratch(scanned) * sizeof(uint32_t));
    }
};

int sig_bits(uint64_t x) {
    int b = 0;
    while (x) {
        ++b;
        x >>= 1;
    }
    return b;
}

#define BT_CHECK()                                          \
    do {                                                    \
        cudaError_t e_ = cudaGetLastError();                \
        if (e_ != cudaSuccess) return (int)e_;              \
    } while (0)

}  // namespace

extern "C" {

long long bt_sa_scratch_bytes(int n1) { return (long long)Layout(n1).total; }

// One round (see the head of this file) over r[0..n1), n1 = n + 1, with
// step k (<= n1) and BIG = big; writes nr, order and maxg (device int32).
int bt_sa_round(const void* r_, int n1, int k, int big_, void* nr_,
                void* order_, void* maxg_, void* scratch_, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* r = (const int32_t*)r_;
    const uint32_t big = (uint32_t)big_;
    char* scratch = (char*)scratch_;
    const Layout lay(n1);
    uint64_t* keys[2] = {(uint64_t*)(scratch + lay.keys[0]),
                         (uint64_t*)(scratch + lay.keys[1])};
    int32_t* vals[2] = {(int32_t*)(scratch + lay.vals[0]),
                        (int32_t*)(scratch + lay.vals[1])};
    uint32_t* table = (uint32_t*)(scratch + lay.table);
    uint32_t* sums = (uint32_t*)(scratch + lay.sums);
    int32_t* order = (int32_t*)order_;
    const int tiles = ceil_div(n1, kTile);
    const uint64_t max_key = ((uint64_t)big + 1) * ((uint64_t)big + 1) - 1;
    const int passes = (sig_bits(max_key) + kBits - 1) / kBits;
    for (int p = 0; p < passes; ++p) {
        const int shift = p * kBits;
        const uint64_t* kin = p ? keys[(p - 1) % 2] : nullptr;
        const int32_t* vin = p ? vals[(p - 1) % 2] : nullptr;
        uint64_t* kout = keys[p % 2];
        int32_t* vout = p == passes - 1 ? order : vals[p % 2];
        if (p == 0)
            hist_kernel<true><<<tiles, kThreads, 0, s>>>(
                r, n1, k, big, kin, vin, shift, table, tiles);
        else
            hist_kernel<false><<<tiles, kThreads, 0, s>>>(
                r, n1, k, big, kin, vin, shift, table, tiles);
        BT_CHECK();
        cudaError_t err = scan_uint32(table, (long long)kBins * tiles, sums,
                                      s);
        if (err != cudaSuccess) return (int)err;
        if (p == 0)
            scatter_kernel<true><<<tiles, kThreads, 0, s>>>(
                r, n1, k, big, kin, vin, shift, table, tiles, kout, vout);
        else
            scatter_kernel<false><<<tiles, kThreads, 0, s>>>(
                r, n1, k, big, kin, vin, shift, table, tiles, kout, vout);
        BT_CHECK();
    }
    // renumber: the sorted keys are in keys[(passes - 1) % 2], and every
    // vals buffer is free (the last pass wrote `order`)
    const uint64_t* sorted = keys[(passes - 1) % 2];
    uint32_t* flags = (uint32_t*)vals[0];
    const int blocks = ceil_div(n1, kThreads);
    flag_kernel<<<blocks, kThreads, 0, s>>>(sorted, n1, flags);
    BT_CHECK();
    cudaError_t err = scan_uint32(flags, n1, sums, s);
    if (err != cudaSuccess) return (int)err;
    renumber_kernel<<<blocks, kThreads, 0, s>>>(
        sorted, flags, order, n1, (int32_t*)nr_, (int32_t*)maxg_);
    BT_CHECK();
    return 0;
}

}  // extern "C"
