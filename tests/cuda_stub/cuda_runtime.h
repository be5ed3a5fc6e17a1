// A stand-in for CUDA's cuda_runtime.h that lets a kernel source of
// bowtie_tpu_torch/csrc build with g++ and run on the CPU, so that the CPU
// tests can hold a kernel to its plain version (tests/test_torch_ilv_shape.py
// builds csrc/ilv.cu with it, tests/test_torch_jobs_shape.py csrc/jobs.cu,
// tests/test_torch_walk_shape.py csrc/exact.cu).
//
// A launch `kernel<<<grid, block, shared, stream>>>(args)`, rewritten by the
// test to `emu_launch(kernel, grid, block, shared, stream, args)`, runs the
// blocks one at a time, each block's threads as fibers (ucontext) on the
// calling thread: a thread runs until it waits at a barrier, then the next
// one runs, so that a barrier costs two context switches a thread and no
// system scheduler's turn, whatever else the machine runs.  A block whose
// threads all wait and none arrives aborts.  The block's shared memory is
// the source's `extern __shared__` array, which the test defines;
// emu_block_start runs before each block (the test poisons the array
// there).  __syncthreads is a barrier over the block; __syncwarp,
// __ballot_sync, __any_sync and __shfl_sync are a barrier over the threads
// of the mask in the caller's warp and an exchange array of one word per
// lane.  The device has emu_sms SMs, each holding emu_blocks_per_sm blocks
// of any kernel (the occupancy calculator's answer).  Only what
// csrc/ilv.cu, csrc/fm.cuh, csrc/jobs.cu and csrc/exact.cu use is here.
#pragma once

#include <ucontext.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
    uint32_t x, y, z, w;
};
struct alignas(16) int4 {
    int32_t x, y, z, w;
};
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1;
struct cudaFuncAttributes {
    size_t localSizeBytes;
};
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* at, K) {
    at->localSizeBytes = 0;
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int emu_sms = 2, emu_blocks_per_sm = 3;
inline cudaError_t cudaGetDevice(int* d) {
    *d = 0;
    return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = emu_sms;
    return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
    *n = emu_blocks_per_sm;
    return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

template <class T>
T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T>
T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// the fibers of the block being run, and the calling thread's context
struct EmuFiber {
    ucontext_t ctx;
    bool done = false;
};
inline ucontext_t emu_main;
inline std::vector<EmuFiber>* emu_fibers = nullptr;
inline unsigned emu_cur = 0;
inline std::function<void()> emu_body;     // the kernel and its arguments
inline uint64_t emu_progress = 0;     // arrivals and ends, for deadlocks

inline void emu_yield() {
    swapcontext(&(*emu_fibers)[emu_cur].ctx, &emu_main);
}

// n threads meet: each but the last yields until the last arrives
struct EmuBarrier {
    explicit EmuBarrier(int n_) : n(n_) {}
    void arrive_and_wait() {
        ++emu_progress;
        const unsigned g = gen;
        if (++arrived == n) {
            arrived = 0;
            ++gen;
            return;
        }
        while (gen == g) emu_yield();
    }
    int n, arrived = 0;
    unsigned gen = 0;
};

struct EmuGroup {
    std::unique_ptr<EmuBarrier> bar;
    uint64_t slot[32];
};

struct EmuBlock {
    explicit EmuBlock(int n) : all(n) {}
    EmuBarrier all;
    std::map<std::pair<unsigned, unsigned>, EmuGroup> groups;
};

inline EmuBlock* emu_block = nullptr;
inline std::function<void()> emu_block_start;

// the threads of `mask` in the caller's warp
inline EmuGroup& emu_group(unsigned mask) {
    EmuGroup& gr = emu_block->groups[{threadIdx.x / 32, mask}];
    if (!gr.bar)
        gr.bar = std::make_unique<EmuBarrier>(__builtin_popcount(mask));
    return gr;
}

inline void __syncthreads() { emu_block->all.arrive_and_wait(); }

inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) {
    emu_group(mask).bar->arrive_and_wait();
}

inline unsigned __ballot_sync(unsigned mask, int pred) {
    EmuGroup& g = emu_group(mask);
    g.slot[threadIdx.x % 32] = pred != 0;
    g.bar->arrive_and_wait();
    unsigned r = 0;
    for (int k = 0; k < 32; ++k)
        if (((mask >> k) & 1u) && g.slot[k]) r |= 1u << k;
    g.bar->arrive_and_wait();
    return r;
}

inline bool __any_sync(unsigned mask, int pred) {
    return __ballot_sync(mask, pred) != 0;
}

template <class T>
T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
    static_assert(sizeof(T) <= sizeof(uint64_t), "one word a lane");
    EmuGroup& g = emu_group(mask);
    const int lane = threadIdx.x % 32;
    uint64_t bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    g.slot[lane] = bits;
    g.bar->arrive_and_wait();
    T r;
    std::memcpy(&r, &g.slot[(lane & ~(width - 1)) + (src & (width - 1))],
                sizeof(T));
    g.bar->arrive_and_wait();
    return r;
}

inline void emu_fiber_entry() {
    emu_body();
    (*emu_fibers)[emu_cur].done = true;
    ++emu_progress;
}

constexpr size_t kEmuStack = 1 << 18;  // bytes of stack a thread
inline std::vector<std::unique_ptr<char[]>> emu_stacks;

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int, cudaStream_t,
                A... args) {
    gridDim = grid;
    blockDim = block;
    while (emu_stacks.size() < block.x)
        emu_stacks.emplace_back(new char[kEmuStack]);
    emu_body = [=] { kernel(args...); };
    for (unsigned bx = 0; bx < grid.x; ++bx) {
        if (emu_block_start) emu_block_start();
        EmuBlock blk((int)block.x);
        emu_block = &blk;
        std::vector<EmuFiber> fibers(block.x);
        emu_fibers = &fibers;
        blockIdx = dim3(bx);
        for (unsigned t = 0; t < block.x; ++t) {
            getcontext(&fibers[t].ctx);
            fibers[t].ctx.uc_stack.ss_sp = emu_stacks[t].get();
            fibers[t].ctx.uc_stack.ss_size = kEmuStack;
            fibers[t].ctx.uc_link = &emu_main;
            makecontext(&fibers[t].ctx, emu_fiber_entry, 0);
        }
        for (unsigned live = block.x; live > 0;) {
            const uint64_t before = emu_progress;
            for (unsigned t = 0; t < block.x; ++t) {
                if (fibers[t].done) continue;
                emu_cur = t;
                threadIdx = dim3(t);
                swapcontext(&emu_main, &fibers[t].ctx);
                live -= fibers[t].done;
            }
            if (live > 0 && emu_progress == before) {
                std::fprintf(stderr, "emu_launch: block %u deadlocked\n",
                             bx);
                std::abort();
            }
        }
    }
    emu_block = nullptr;
    emu_fibers = nullptr;
}
