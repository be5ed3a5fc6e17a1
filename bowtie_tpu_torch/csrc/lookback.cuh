// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016) and a block scan, shared by K16's
// digit passes and renumbering (sa.cu) and K8's packing (dfs.cu).
//
// Each tile publishes its count as a status word as soon as it knows it
// (an aggregate), and again once it knows the counts of every tile before
// it (an inclusive prefix).  A tile's exclusive prefix is then the sum of
// the words of the tiles before it, read from the nearest backwards until
// the first inclusive prefix: one kernel, no second pass over the data.
//
// A status word is one 64-bit store, so its flag and count can never be
// read torn: [63:40] the epoch, [39] inclusive, [38:0] the count.  A word
// whose epoch is not the reader's has not been published yet: the words
// start zeroed and epochs start at 1, so one zeroed array serves several
// kernels of a stream in turn (K16's passes use epochs 1, 2, ...).
#pragma once

#include <cstdint>

namespace lb {

constexpr int kEpochShift = 40;
constexpr uint64_t kInclusive = 1ull << 39;
constexpr uint64_t kCountMask = kInclusive - 1;
// A wait this long (~2^24 polls, most 256 ns apart: ~4 s) means a tile
// that never publishes, a fault: trap rather than hang the card.
constexpr uint32_t kSpinLimit = 1u << 24;

// A status word carries its own data, so its loads and stores need no
// ordering with other memory: relaxed, but at device scope (coherent
// across SMs, never a stale L1 line).
__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
#else
    __atomic_store_n(p, v, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
#ifdef __CUDA_ARCH__
    uint64_t v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
#else
    return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ void publish(uint64_t* word, uint32_t epoch,
                                        bool inclusive, uint64_t count) {
    store_relaxed(word, ((uint64_t)epoch << kEpochShift)
                            | (inclusive ? kInclusive : 0ull) | count);
}

// The word at `w` once it is published under `epoch`.
__device__ __forceinline__ uint64_t wait_for(const uint64_t* w,
                                             uint32_t epoch) {
    uint64_t v = load_relaxed(w);
    for (uint32_t spins = 0; (v >> kEpochShift) != epoch; ++spins) {
        if (spins >= kSpinLimit) __trap();
        if (spins >= 32) __nanosleep(256);
        v = load_relaxed(w);
    }
    return v;
}

// The sum of the counts of tiles 0 .. tile-1, whose words lie at
// status[t * stride]: walks back from tile-1, adding aggregates, until
// it adds an inclusive prefix (tile 0 publishes only that).
__device__ __forceinline__ uint64_t look_back(const uint64_t* status,
                                              size_t stride, int tile,
                                              uint32_t epoch) {
    uint64_t sum = 0;
    for (int t = tile - 1; t >= 0; --t) {
        const uint64_t v = wait_for(status + (size_t)t * stride, epoch);
        sum += v & kCountMask;
        if (v & kInclusive) break;
    }
    return sum;
}

// look_back by a whole warp, for one count: lane l reads the word of
// tile top - l, so 32 words cost one round trip, and the lanes up to the
// nearest inclusive prefix add up.  Every lane returns the sum.
__device__ __forceinline__ uint64_t warp_look_back(const uint64_t* status,
                                                   size_t stride, int tile,
                                                   uint32_t epoch) {
    const int lane = threadIdx.x % 32;
    uint64_t sum = 0;
    for (int top = tile - 1;; top -= 32) {
        const int t = top - lane;
        // before tile 0: an inclusive prefix of 0
        const uint64_t v = t >= 0 ? wait_for(status + (size_t)t * stride,
                                             epoch)
                                  : kInclusive;
        const uint32_t incl = __ballot_sync(0xFFFFFFFFu,
                                            (v & kInclusive) != 0);
        const int first = incl ? __ffs(incl) - 1 : 31;
        uint64_t c = lane <= first ? v & kCountMask : 0;
        for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
        sum += c;
        if (incl) return sum;
    }
}

// Every block of the grid waits here until all have arrived; what each
// wrote before is then visible to all.  The grid must fit on the card at
// once (a persistent grid sized by the occupancy calculator), and
// `arrived` starts at 0.
__device__ __forceinline__ void grid_barrier(unsigned long long* arrived,
                                             unsigned blocks) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(arrived, 1ull);
        const uint64_t* w = reinterpret_cast<const uint64_t*>(arrived);
        for (uint32_t spins = 0; load_relaxed(w) < blocks; ++spins) {
            if (spins >= kSpinLimit) __trap();
            if (spins >= 32) __nanosleep(256);
        }
        __threadfence();
    }
    __syncthreads();
}

// Exclusive scan of one value per thread over a block of THREADS
// threads (a multiple of 32); `warp_sums` holds THREADS / 32 shared
// entries, and `total` gets the block's sum.  Every thread calls it.
template <int THREADS>
__device__ __forceinline__ uint32_t block_exclusive_scan(
        uint32_t v, uint32_t* warp_sums, uint32_t& total) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    uint32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    uint32_t before = 0;
    total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
        const uint32_t s = warp_sums[w];
        if (w < warp) before += s;
        total += s;
    }
    __syncthreads();            // warp_sums may be written again
    return before + x - v;
}

// The tile this block works on, from a counter in device memory that
// starts at 0: tiles go out in the order blocks start, so a tile only
// ever waits on tiles whose blocks are already running (look-back needs
// that forward progress; blockIdx order is not guaranteed to give it).
// All threads of the block call it.
__device__ __forceinline__ int take_tile(unsigned long long* counter,
                                         int* s_tile) {
    if (threadIdx.x == 0) *s_tile = (int)atomicAdd(counter, 1ull);
    __syncthreads();
    return *s_tile;
}

}  // namespace lb
