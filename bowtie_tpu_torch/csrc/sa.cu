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
// 12 bytes a suffix (chip_smoke.py k16_bounds; 16 if the shifted read
// r[i+k] counts as a second read of r), so 1.2 GB and 0.36 ms at 3.35
// TB/s for 10^8 suffixes.  A radix sort moves far more than that: each
// digit pass reads and writes every 8-byte key and 4-byte index, 24 bytes
// a suffix, so the passes set the round's time, and the most a pass can
// do is stream at the memory's rate, every read and write coalesced.
//
// What the design does about it: an LSD radix sort with one sweep over
// the keys per digit (Adinets and Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022), written out here: no
// CUB, thrust or torch call.  The key is packed into one uint64 and only
// its significant bits are sorted, ceil(log2((BIG+1)^2)) of them, in
// 8-bit digits (7 passes at 10^8 suffixes, 8 at BIG near 2^31).
// - hist_kernel reads r once, builds each key in registers and counts
//   every pass's digit into a shared [pass][256] table, then adds it to
//   the global one; the last block to finish scans it into offsets.  A
//   warp whose 32 digits agree adds once, so a pass whose keys nearly
//   all share one digit (all but the last suffix's, in the first round's
//   high digits) does not serialise on one shared atomic.
// - pass_kernel, once per digit: a block takes the next 6,144-key tile
//   from a counter and holds 24 keys a thread in registers, two blocks
//   an SM (with one, the passes waited on latency).  It ranks them
//   stably: each warp takes its 32-key rows in order, a ballot per digit
//   bit finds the lanes of a row with equal digits (the hardware's
//   match.any was slower) and a popcount ranks a lane among them,
//   per-warp counters carry the rank across the warp's rows, and a scan
//   over the warps puts the warps in order.  The tile publishes its
//   count of each digit, writes its keys and indices into shared memory
//   in (digit, rank) order, and only then looks back for the counts of
//   the tiles before it (lookback.cuh), which with the histogram's
//   offsets place each digit's run: no [digit][tile] table is written or
//   scanned.  It stores the runs from shared memory, neighbouring threads
//   to neighbouring positions of one run, so the scatter leaves
//   coalesced.  The first pass builds the keys from r; the last writes
//   the indices straight into `order`.
// - renumber_kernel flags each key change with a ballot over 32 sorted
//   keys, scans the flags through the block and takes the tile's prefix
//   by the same look-back.  The function ends in a scatter, nr[order[j]]
//   = grp[j], whose 4-byte writes land in random sectors of device
//   memory once `order` is random (the later rounds): done directly it
//   took as long as 60 % of a whole torch.sort.  So the kernel buckets
//   its (order[j], grp[j]) pairs by the top bits of order[j] and, after a
//   grid barrier, writes nr from the buckets in order, a few MB of nr at
//   a time, which L2 gathers into whole sectors.
// A round is passes + 2 kernels after one memset of the histogram, the
// tile counters and the look-back words.  Fewer, wider digits and sorting
// only the still-tied groups of later rounds are later work.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;                 // one block = 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 24;                    // keys a thread holds
constexpr int kWarpTile = kItems * 32;        // a warp's consecutive keys
constexpr int kTile = kWarps * kWarpTile;     // 6,144 keys
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;             // == kThreads
constexpr int kMaxPasses = 8;                 // 62-bit keys at BIG < 2^31
constexpr int kRnItems = 16;                  // renumber: rows a warp takes
constexpr int kRnTile = kWarps * kRnItems * 32;     // 4,096 keys
constexpr int kBuckets = 128;                 // renumber: index buckets
constexpr int kHistBlocksPerSM = 8;
constexpr uint32_t kNoDigit = 0xFFFFFFFFu;
// pass_kernel's dynamic shared memory: the tile's keys and indices in
// output order, and the per-warp digit counters
constexpr int kPassSmem = kTile * (int)(sizeof(uint64_t) + sizeof(int32_t))
    + kWarps * kBins * (int)sizeof(uint32_t);

static_assert(kBins == kThreads, "one thread per digit in the scans");
static_assert(kBuckets <= kThreads, "one thread per bucket");
static_assert(kWarpTile < (1 << 16), "a rank within a warp fits 16 bits");

inline size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }
inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint64_t make_key(const int32_t* r, long long j,
                                             int n1, int k, uint32_t big) {
    const uint32_t r1 = (uint32_t)r[j];
    const uint32_t r2 = j + k < n1 ? (uint32_t)r[j + k] : big;
    return (uint64_t)r1 * ((uint64_t)big + 1) + r2;
}

// table[p * kBins + d] = the keys whose digit p is below d, for every
// pass p: the grid strides over whole warps and adds its counts to the
// table, and the last block to finish turns them into offsets.
__global__ void __launch_bounds__(kThreads) hist_kernel(
        const int32_t* __restrict__ r, int n1, int k, uint32_t big,
        int passes, uint32_t* __restrict__ table, unsigned long long* done) {
    __shared__ uint32_t bins[kMaxPasses * kBins];
    __shared__ uint32_t warp_sums[kWarps];
    __shared__ int s_last;
    for (int i = threadIdx.x; i < kMaxPasses * kBins; i += kThreads)
        bins[i] = 0;
    __syncthreads();
    const int lane = threadIdx.x % 32;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long j0 = (long long)blockIdx.x * kThreads + threadIdx.x - lane;
         j0 < n1; j0 += stride) {
        const long long j = j0 + lane;
        const bool ok = j < n1;
        const uint64_t key = ok ? make_key(r, j, n1, k, big) : 0;
        const uint32_t valid = __ballot_sync(0xFFFFFFFFu, ok);
        for (int p = 0; p < passes; ++p) {
            const uint32_t d = (uint32_t)(key >> (p * kBits)) & (kBins - 1);
            const uint32_t d0 = __shfl_sync(0xFFFFFFFFu, d, 0);
            if (__all_sync(0xFFFFFFFFu, !ok || d == d0)) {
                if (lane == 0)
                    atomicAdd(&bins[p * kBins + d0], (uint32_t)__popc(valid));
            } else if (ok) {
                atomicAdd(&bins[p * kBins + d], 1u);
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < passes * kBins; i += kThreads)
        if (bins[i]) atomicAdd(&table[i], bins[i]);
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        s_last = atomicAdd(done, 1ull) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int p = 0; p < passes; ++p) {
        uint32_t* t = table + p * kBins + threadIdx.x;
        uint32_t total;
        *t = lb::block_exclusive_scan<kThreads>(__ldcg(t), warp_sums, total);
    }
}

// One stable digit pass (the head of this file).  `hist` is this pass's
// 256 digit offsets; `status` holds a look-back word per (tile, digit),
// published under `epoch`.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads, 2) pass_kernel(
        const int32_t* __restrict__ r, int n1, int k, uint32_t big,
        const uint64_t* __restrict__ keys_in,
        const int32_t* __restrict__ vals_in, int shift,
        const uint32_t* __restrict__ hist, uint64_t* status, uint32_t epoch,
        unsigned long long* ticket, uint64_t* __restrict__ keys_out,
        int32_t* __restrict__ vals_out) {
    extern __shared__ __align__(16) unsigned char bt_smem[];
    uint64_t* skey = reinterpret_cast<uint64_t*>(bt_smem);
    int32_t* sval = reinterpret_cast<int32_t*>(skey + kTile);
    uint32_t* wcnt = reinterpret_cast<uint32_t*>(sval + kTile);
    __shared__ uint32_t start[kBins];   // the tile's first slot of digit d
    __shared__ uint32_t adj[kBins];     // output position - tile slot
    __shared__ uint32_t warp_sums[kWarps];
    __shared__ int s_tile;
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) wcnt[i] = 0;
    const int tile = lb::take_tile(ticket, &s_tile);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    uint32_t* mine = wcnt + warp * kBins;
    const long long base = (long long)tile * kTile + warp * kWarpTile;
    uint64_t key[kItems];
    int32_t val[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const long long j = base + i * 32 + lane;
        key[i] = 0;
        val[i] = 0;
        if (j < n1) {
            if (FIRST) {
                key[i] = make_key(r, j, n1, k, big);
                val[i] = (int32_t)j;
            } else {
                key[i] = keys_in[j];
                val[i] = vals_in[j];
            }
        }
    }
    // the lanes of each row holding the same digit: a ballot per digit
    // bit
    uint32_t peers[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const bool ok = base + i * 32 + lane < n1;
        const uint32_t d = (uint32_t)(key[i] >> shift) & (kBins - 1);
        const uint32_t valid = __ballot_sync(0xFFFFFFFFu, ok);
        uint32_t same = valid;
#pragma unroll
        for (int b = 0; b < kBits; ++b) {
            const uint32_t ones = __ballot_sync(0xFFFFFFFFu, (d >> b) & 1u);
            same &= (d >> b) & 1u ? ones : ~ones;
        }
        peers[i] = ok ? same : 0u;
    }
    // rank: digit << 16 | the keys of this digit before it in the warp;
    // the lowest lane of each digit group advances its counter and hands
    // the old count to its group
    const uint32_t lower = (1u << lane) - 1u;
    uint32_t rank[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        const uint32_t d = (uint32_t)(key[i] >> shift) & (kBins - 1);
        const int leader = __ffs(peers[i]) - 1;
        uint32_t cnt = 0;
        if (leader == lane) {
            cnt = mine[d];
            mine[d] = cnt + __popc(peers[i]);
        }
        __syncwarp();
        cnt = __shfl_sync(0xFFFFFFFFu, cnt, leader < 0 ? lane : leader);
        rank[i] = peers[i] ? d << 16 | (cnt + __popc(peers[i] & lower))
                           : kNoDigit;
    }
    __syncthreads();
    // thread d: the warps' offsets within digit d, and the tile's count
    const int d = threadIdx.x;
    uint32_t count = 0;
    for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = wcnt[w * kBins + d];
        wcnt[w * kBins + d] = count;
        count += c;
    }
    uint64_t* word = status + (size_t)tile * kBins + d;
    lb::publish(word, epoch, tile == 0, count);
    uint32_t total;
    const uint32_t local =
        lb::block_exclusive_scan<kThreads>(count, warp_sums, total);
    start[d] = local;
    __syncthreads();
    // stage in (digit, rank) order first: the tiles before have had that
    // long to publish when the look-back starts
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        if (rank[i] == kNoDigit) continue;
        const uint32_t di = rank[i] >> 16;
        const uint32_t slot = start[di] + mine[di] + (rank[i] & 0xFFFFu);
        skey[slot] = key[i];
        sval[slot] = val[i];
    }
    uint64_t prior = 0;
    if (tile > 0) {
        prior = lb::look_back(status + d, kBins, tile, epoch);
        lb::publish(word, epoch, true, prior + count);
    }
    // wraps below 0 for some digits; every position it gives is < n1
    adj[d] = hist[d] + (uint32_t)prior - local;
    __syncthreads();
    const long long rest = n1 - (long long)tile * kTile;
    const int valid = rest < kTile ? (int)rest : kTile;
    for (int s = threadIdx.x; s < valid; s += kThreads) {
        const uint64_t kk = skey[s];
        const uint32_t pos = adj[(uint32_t)(kk >> shift) & (kBins - 1)] + s;
        keys_out[pos] = kk;
        vals_out[pos] = sval[s];
    }
}

// nr[order[j]] = grp[j], grp[j] = the key changes in keys[1..j], and
// maxg = grp[n1 - 1], in two phases of one persistent grid.  Phase 1: a
// block takes a 4,096-key tile from the counter, flags its key changes
// with a ballot per 32 keys, scans them, and takes the tile's prefix by
// look-back; then it buckets its (order[j], grp[j]) pairs by the top bits
// of order[j] and stores them through shared memory.  Bucket b holds the
// indices b << bshift .. (b + 1) << bshift, so its place in `pairs` is
// known without a histogram; a tile takes its stretch of it from the
// bucket's cursor with one atomic add (the pairs of a bucket may lie in
// any order: each index is written once).  Phase 2, after a grid
// barrier: the blocks write nr from `pairs` in 4,096-pair chunks handed
// out in order, so the writes in flight fall within a bucket or two of
// nr, a few MB that stay in L2 until their sectors are whole.  A direct
// nr[order[j]] scatter sends every 4-byte write to a random sector of
// device memory.
__global__ void __launch_bounds__(kThreads) renumber_kernel(
        const uint64_t* __restrict__ keys, const int32_t* __restrict__ order,
        int n1, int bshift, uint64_t* status, uint32_t* cursor,
        unsigned long long* ticket, uint2* __restrict__ pairs,
        int32_t* __restrict__ nr,
        int32_t* __restrict__ maxg) {
    __shared__ uint2 stage[kRnTile];
    __shared__ uint32_t bcount[kBuckets], bstart[kBuckets], bbase[kBuckets];
    __shared__ uint32_t warp_sums[kWarps];
    __shared__ uint32_t s_prior;
    __shared__ int s_tile;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tiles = (int)((n1 + (long long)kRnTile - 1) / kRnTile);
    const int nb = ((n1 - 1) >> bshift) + 1;
    const uint32_t upto = (2u << lane) - 1u;     // lanes 0..lane
    for (;;) {
        if (threadIdx.x < kBuckets) bcount[threadIdx.x] = 0;
        const int tile = lb::take_tile(ticket, &s_tile);
        if (tile >= tiles) break;
        const long long base =
            (long long)tile * kRnTile + warp * kRnItems * 32;
        uint32_t change = 0;            // bit i: this lane's key of row i
        uint32_t dest[kRnItems];
#pragma unroll
        for (int i = 0; i < kRnItems; ++i) {
            const long long j = base + i * 32 + lane;
            dest[i] = j < n1 ? (uint32_t)order[j] : 0u;
            if (j > 0 && j < n1 && keys[j] != keys[j - 1]) change |= 1u << i;
        }
        uint32_t flags[kRnItems];       // row i's changes, one bit a lane
        uint32_t wtot = 0;
#pragma unroll
        for (int i = 0; i < kRnItems; ++i) {
            flags[i] = __ballot_sync(0xFFFFFFFFu, (change >> i) & 1u);
            wtot += __popc(flags[i]);
        }
        uint32_t total;
        const uint32_t before = lb::block_exclusive_scan<kThreads>(
            lane == 0 ? wtot : 0u, warp_sums, total);
        const uint32_t wbase = __shfl_sync(0xFFFFFFFFu, before, 0);
        if (warp == 0) {
            uint64_t* word = status + tile;
            if (lane == 0) lb::publish(word, 1, tile == 0, total);
            const uint64_t prior =
                tile > 0 ? lb::warp_look_back(status, 1, tile, 1) : 0;
            if (lane == 0) {
                if (tile > 0) lb::publish(word, 1, true, prior + total);
                s_prior = (uint32_t)prior;
            }
        }
        // each pair's bucket and its rank there (any order will do)
        uint32_t rank[kRnItems];
#pragma unroll
        for (int i = 0; i < kRnItems; ++i) {
            const long long j = base + i * 32 + lane;
            if (j < n1) rank[i] = atomicAdd(&bcount[dest[i] >> bshift], 1u);
        }
        __syncthreads();
        {   // thread b: bucket b's slots in the tile and place in `pairs`
            const int b = threadIdx.x;
            const uint32_t cnt = b < nb ? bcount[b] : 0u;
            uint32_t all;
            const uint32_t local =
                lb::block_exclusive_scan<kThreads>(cnt, warp_sums, all);
            if (b < nb) {
                const uint32_t at = cnt ? atomicAdd(&cursor[b], cnt) : 0u;
                bstart[b] = local;
                // wraps below 0 for some buckets; every position is < n1
                bbase[b] = ((uint32_t)b << bshift) + at - local;
            }
        }
        __syncthreads();
        uint32_t run = s_prior + wbase;
#pragma unroll
        for (int i = 0; i < kRnItems; ++i) {
            const long long j = base + i * 32 + lane;
            const uint32_t g = run + __popc(flags[i] & upto);
            if (j < n1) {
                stage[bstart[dest[i] >> bshift] + rank[i]] =
                    make_uint2(dest[i], g);
                if (j == n1 - 1) *maxg = (int32_t)g;
            }
            run += __popc(flags[i]);
        }
        __syncthreads();
        const long long rest = n1 - (long long)tile * kRnTile;
        const int valid = rest < kRnTile ? (int)rest : kRnTile;
        for (int s = threadIdx.x; s < valid; s += kThreads) {
            const uint2 p = stage[s];
            pairs[bbase[p.x >> bshift] + s] = p;
        }
        __syncthreads();
    }
    lb::grid_barrier(ticket + 1, gridDim.x);
    // chunks of `pairs` handed out in order: a block that falls behind
    // holds one chunk, so the writes in flight stay within a few buckets
    for (;;) {
        const int chunk = lb::take_tile(ticket + 2, &s_tile);
        const long long p = (long long)chunk * kRnTile + threadIdx.x;
        if (p - threadIdx.x >= n1) break;
#pragma unroll
        for (int i = 0; i < kRnTile / kThreads; ++i) {
            if (p + i * kThreads < n1) {
                const uint2 q = pairs[p + i * kThreads];
                nr[q.x] = (int32_t)q.y;
            }
        }
        __syncthreads();
    }
}

// The scratch layout of one round over n1 elements; everything from
// `zeroed` on is cleared by the round's one memset.
struct Layout {
    size_t keys[2], vals[2], zeroed, hist, tickets, cursors, status,
        rstatus, total;
    explicit Layout(int n1) {
        const long long tiles = ceil_div(n1, kTile);
        const long long rtiles = ceil_div(n1, kRnTile);
        size_t at = 0;
        for (int i = 0; i < 2; ++i) {
            keys[i] = at;
            at = align_up(at + (size_t)n1 * sizeof(uint64_t));
        }
        for (int i = 0; i < 2; ++i) {
            vals[i] = at;
            at = align_up(at + (size_t)n1 * sizeof(int32_t));
        }
        zeroed = hist = at;
        at = align_up(at + (size_t)kMaxPasses * kBins * sizeof(uint32_t));
        // one a pass; renumbering's tiles, barrier, chunks; hist's blocks
        tickets = at;
        at = align_up(at + (kMaxPasses + 4) * sizeof(unsigned long long));
        cursors = at;      // renumbering's bucket cursors
        at = align_up(at + kBuckets * sizeof(uint32_t));
        status = at;
        at = align_up(at + (size_t)tiles * kBins * sizeof(uint64_t));
        rstatus = at;
        total = align_up(at + (size_t)rtiles * sizeof(uint64_t));
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
    uint32_t* hist = (uint32_t*)(scratch + lay.hist);
    unsigned long long* tickets =
        (unsigned long long*)(scratch + lay.tickets);
    uint64_t* status = (uint64_t*)(scratch + lay.status);
    uint64_t* rstatus = (uint64_t*)(scratch + lay.rstatus);
    uint32_t* cursors = (uint32_t*)(scratch + lay.cursors);
    int32_t* order = (int32_t*)order_;
    const int tiles = (int)ceil_div(n1, kTile);
    const uint64_t max_key = ((uint64_t)big + 1) * ((uint64_t)big + 1) - 1;
    const int passes = (sig_bits(max_key) + kBits - 1) / kBits;

    cudaError_t err = cudaMemsetAsync(scratch + lay.zeroed, 0,
                                      lay.total - lay.zeroed, s);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int hist_blocks = (int)(ceil_div(n1, kThreads) < (long long)sms
                                  * kHistBlocksPerSM
                                  ? ceil_div(n1, kThreads)
                                  : (long long)sms * kHistBlocksPerSM);
    hist_kernel<<<hist_blocks, kThreads, 0, s>>>(r, n1, k, big, passes,
                                                 hist, tickets + passes + 3);
    BT_CHECK();
    for (const auto fn : {pass_kernel<true>, pass_kernel<false>}) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kPassSmem);
        if (err != cudaSuccess) return (int)err;
    }
    for (int p = 0; p < passes; ++p) {
        const uint64_t* kin = p ? keys[(p - 1) % 2] : nullptr;
        const int32_t* vin = p ? vals[(p - 1) % 2] : nullptr;
        int32_t* vout = p == passes - 1 ? order : vals[p % 2];
        (p == 0 ? pass_kernel<true> : pass_kernel<false>)
            <<<tiles, kThreads, kPassSmem, s>>>(
                r, n1, k, big, kin, vin, p * kBits, hist + p * kBins,
                status, (uint32_t)(p + 1), tickets + p, keys[p % 2], vout);
        BT_CHECK();
    }
    // renumbering: a grid that fits on the card at once (its barrier),
    // its pairs in the keys buffer the last pass did not write
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, renumber_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const long long rn_blocks = (long long)sms * per_sm;
    const int bshift = sig_bits((uint64_t)(n1 - 1)) > 7
        ? sig_bits((uint64_t)(n1 - 1)) - 7 : 0;
    renumber_kernel<<<(int)(ceil_div(n1, kRnTile) < rn_blocks
                            ? ceil_div(n1, kRnTile) : rn_blocks),
                      kThreads, 0, s>>>(
        keys[(passes - 1) % 2], order, n1, bshift, rstatus, cursors,
        tickets + passes, (uint2*)keys[passes % 2],
        (int32_t*)nr_, (int32_t*)maxg_);
    BT_CHECK();
    return 0;
}

}  // extern "C"
