// A stand-in for CUDA's cuda_runtime.h that lets a kernel source of
// bowtie_tpu_torch/csrc build with g++ and run on the CPU, so that the CPU
// tests can hold a kernel to its plain version (tests/test_torch_ilv_shape.py
// builds csrc/ilv.cu with it, tests/test_torch_jobs_shape.py csrc/jobs.cu).
//
// A launch `kernel<<<grid, block, shared, stream>>>(args)`, rewritten by the
// test to `emu_launch(kernel, grid, block, shared, stream, args)`, runs the
// blocks one at a time, each block's threads as std::threads.  The block's
// shared memory is the source's `extern __shared__` array, which the test
// defines; emu_block_start runs before each block (the test poisons the
// array there).  __syncthreads is a std::barrier over the block;
// __syncwarp, __ballot_sync and __shfl_sync are a std::barrier over the
// threads of the mask in the caller's warp and an exchange array of one
// word per lane.  Only what csrc/ilv.cu, csrc/fm.cuh and csrc/jobs.cu use
// is here.
#pragma once

#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
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

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

template <class T>
T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct EmuGroup {
    std::unique_ptr<std::barrier<>> bar;
    uint64_t slot[32];
};

struct EmuBlock {
    explicit EmuBlock(int n) : all(n) {}
    std::barrier<> all;
    std::mutex mu;
    std::map<std::pair<unsigned, unsigned>, EmuGroup> groups;
};

inline EmuBlock* emu_block = nullptr;
inline std::function<void()> emu_block_start;

// the threads of `mask` in the caller's warp
inline EmuGroup& emu_group(unsigned mask) {
    std::lock_guard<std::mutex> g(emu_block->mu);
    EmuGroup& gr = emu_block->groups[{threadIdx.x / 32, mask}];
    if (!gr.bar)
        gr.bar = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
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

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int, cudaStream_t,
                A... args) {
    gridDim = grid;
    blockDim = block;
    for (unsigned bx = 0; bx < grid.x; ++bx) {
        if (emu_block_start) emu_block_start();
        EmuBlock blk((int)block.x);
        emu_block = &blk;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
            threads.emplace_back([&, t] {
                threadIdx = dim3(t);
                blockIdx = dim3(bx);
                kernel(args...);
            });
        for (auto& th : threads) th.join();
    }
    emu_block = nullptr;
}
