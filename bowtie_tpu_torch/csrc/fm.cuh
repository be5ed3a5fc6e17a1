// FM-index rank/LF helpers (K1), inlined into every kernel of exact.cu.
//
// Replaces bowtie_tpu/ops/fm.py:99 rank1, :126 rank4, :148 lf, :153 lf4,
// :158 bwt_char, :173 lf_row_compact and :197 ftab_jump — jitted XLA
// functions there, __device__ functions here; bowtie_tpu_torch/ops/fm.py
// holds their plain PyTorch versions.
//
// Layout (bowtie_tpu_torch/index/arrays.py): the BWT as 2-bit codes, 16
// per uint32 word, low bit-pair first, 8 words (32 bytes) per 128-row
// block; occ checkpoints as one uint4 (16 bytes) per block, counting the
// '$' at row zoff as an 'A'.  Rows are uint32_t (the reference's small
// index, TIndexOffU, up to 2^32-1 rows).
//
// Bound: one rank costs one 16-byte occ row and one 32-byte word block,
// each a single 32-byte sector, read with one vector load apiece; the
// popcount arithmetic is a few dozen integer ops and never the limit.
// So an LF step is two dependent random sector reads, and every caller
// is bound by memory latency and sectors, not by bandwidth or ALU.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr uint32_t kOccBlock = 128;   // rows per checkpoint
constexpr int kWordsPerBlock = 8;     // 32 bytes of 2-bit codes
constexpr int kMaxWalk = 1024;        // walk-left bound (exact.py MAX_WALK)

// Mirrors FMView in bowtie_tpu_torch/kernels.py field for field.
struct BtFM {
    const uint32_t* bwt;      // [(nblocks+1)*8] packed words
    const uint4* occ;         // [nblocks+1] (A,C,G,T) checkpoints
    const uint32_t* ftab_hi;  // [4^ftab_chars+1] escape-resolved ftabHi
    const uint32_t* ftab_lo;  // [4^ftab_chars+1] escape-resolved ftabLo
    const uint32_t* offs;     // SA sample, one per 2^off_rate rows
    const uint32_t* sa;       // dense SA, or null
    uint32_t fchr[5];
    uint32_t zoff;            // row of '$'
    uint32_t bwt_len;         // text length + 1
    int32_t ftab_chars;
    int32_t off_rate;
};

// RandomSource::nextU32 (random_source.h:36-42): the per-read LCG of the
// machines' random draws (dfs.cu, best.cu, ilv.cu)
__device__ __forceinline__ uint32_t rng_next(uint32_t& state) {
    const uint32_t s1 = 1664525u * state + 1013904223u;
    const uint32_t s2 = 1664525u * s1 + 1013904223u;
    state = s2;
    return (s1 >> 16) ^ s2;
}

__device__ __forceinline__ uint32_t occ_get(const uint4& o, uint32_t c) {
    return c == 0 ? o.x : c == 1 ? o.y : c == 2 ? o.z : o.w;
}

__device__ __forceinline__ uint32_t fchr_get(const BtFM& fm, uint32_t c) {
    return c == 0 ? fm.fchr[0] : c == 1 ? fm.fchr[1]
         : c == 2 ? fm.fchr[2] : fm.fchr[3];
}

// The 8 words of checkpoint block `block`, as two 16-byte loads.
__device__ __forceinline__ void block_words(const BtFM& fm, uint32_t block,
                                            uint32_t w[kWordsPerBlock]) {
    const uint4* p = reinterpret_cast<const uint4*>(fm.bwt) + 2 * (size_t)block;
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// # of the block's first `rem` rows whose stored code is c.
__device__ __forceinline__ uint32_t count_in_block(
        const uint32_t w[kWordsPerBlock], uint32_t c, uint32_t rem) {
    const uint32_t pat = c * 0x55555555u;   // c in every lane
    uint32_t cnt = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerBlock; ++k) {
        int n = (int)rem - 16 * k;
        n = n < 0 ? 0 : (n > 16 ? 16 : n);
        const uint32_t m = ~(w[k] ^ pat);   // lane == c iff both bits set
        const uint32_t hits = m & (m >> 1) & 0x55555555u;
        const uint32_t keep = n >= 16 ? 0xFFFFFFFFu : ((1u << (2 * n)) - 1u);
        cnt += __popc(hits & keep);
    }
    return cnt;
}

// The stored code of row `rem` of the block (a register select, no
// dynamically indexed local array).
__device__ __forceinline__ uint32_t code_in_block(
        const uint32_t w[kWordsPerBlock], uint32_t rem) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerBlock; ++k)
        if ((rem >> 4) == (uint32_t)k) word = w[k];
    return (word >> (2 * (rem & 15))) & 3u;
}

// Occ(c, i): occurrences of code c in BWT rows [0, i).
__device__ __forceinline__ uint32_t rank1(const BtFM& fm, uint32_t c,
                                          uint32_t i) {
    const uint32_t block = i / kOccBlock, rem = i % kOccBlock;
    const uint4 o = __ldg(fm.occ + block);
    uint32_t w[kWordsPerBlock];
    block_words(fm, block, w);
    const uint32_t corr = (c == 0 && i > fm.zoff) ? 1u : 0u;
    return occ_get(o, c) + count_in_block(w, c, rem) - corr;
}

// LF for a search arrow: fchr[c] + Occ(c, i).
__device__ __forceinline__ uint32_t lf(const BtFM& fm, uint32_t i,
                                       uint32_t c) {
    return fchr_get(fm, c) + rank1(fm, c, i);
}

// K5 (bowtie_tpu/align/dfs_device.py:261 _rank4): Occ(c, i) for all four
// codes from one occ load and one block load, '$' corrected on the A count
// (countFwSide, ebwt.h:2044-2052).  Plain version: ops/fm.py rank4_plain.
__device__ __forceinline__ void rank4(const BtFM& fm, uint32_t i,
                                      uint32_t out[4]) {
    const uint32_t block = i / kOccBlock, rem = i % kOccBlock;
    const uint4 o = __ldg(fm.occ + block);
    uint32_t w[kWordsPerBlock];
    block_words(fm, block, w);
    out[0] = o.x + count_in_block(w, 0, rem) - (i > fm.zoff ? 1u : 0u);
    out[1] = o.y + count_in_block(w, 1, rem);
    out[2] = o.z + count_in_block(w, 2, rem);
    out[3] = o.w + count_in_block(w, 3, rem);
}

// K5 (dfs_device.py:303 _lf4pair): the LF quartets of both ends of a range
// (mapLFEx at top and bot, ebwt.h:2334).  Plain version: ops/fm.py
// lf4pair_plain.
__device__ __forceinline__ void lf4pair(const BtFM& fm, uint32_t top,
                                        uint32_t bot, uint32_t t4[4],
                                        uint32_t b4[4]) {
    rank4(fm, top, t4);
    rank4(fm, bot, b4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        t4[c] += fm.fchr[c];
        b4[c] += fm.fchr[c];
    }
}

// mapLF(l): LF of row i by its own char, read from the same block as the
// rank scan (one occ row + one word block).  Undefined at zoff.
__device__ __forceinline__ uint32_t lf_row(const BtFM& fm, uint32_t i) {
    const uint32_t block = i / kOccBlock, rem = i % kOccBlock;
    const uint4 o = __ldg(fm.occ + block);
    uint32_t w[kWordsPerBlock];
    block_words(fm, block, w);
    const uint32_t c = code_in_block(w, rem);
    const uint32_t corr = (c == 0 && i > fm.zoff) ? 1u : 0u;
    return fchr_get(fm, c) + occ_get(o, c) + count_in_block(w, c, rem) - corr;
}
