// The job-table kernels of -v and -n: K6 derives each (lane, job) row's
// by-depth query, quality and penalty bytes and its N-tally gates; K9
// builds -n's launch-B job table from launch A's outputs.  Both feed K7
// (dfs.cu); the table's layout is dfs_layout.cuh.  Built with the other
// sources by bowtie_tpu_torch/kernels.py and called through the plain C
// entry points at the bottom.
//
// Replaces:
//   K6 bt_derive_rows   <- bowtie_tpu/align/dfs_device.py:496
//                          derive_rows_jit (:412 _derive_rows_impl)
//   K9 bt_derive_b_jobs <- bowtie_tpu/align/n_device.py:85
//                          _derive_b_jobs_device (less its K6 tail)
// Plain PyTorch versions, which these equal byte for byte:
// derive_rows_plain in bowtie_tpu_torch/align/dfs_device.py and
// derive_b_jobs_plain in bowtie_tpu_torch/align/n_device.py.
//
// The least they must move: K6 reads a row's NJF fields and writes them
// back with 3L bytes of qqp; K9 writes the whole [J][NJF] table of each
// lane and reads at most P_MAX partial rows.  One thread a row (K6) or a
// lane (K9) made every warp-wide store touch 32 sectors 116 B to 4 KB
// apart, so both moved far more sectors than bytes.  Here a warp takes a
// row (K6) or a lane (K9), and each store instruction writes consecutive
// bytes: a row's fields in one coalesced store, its qqp bytes 32 positions
// a store, a lane's table through shared memory in 16-byte stores.  K9 is
// then within 2x of its bytes; K6 is bound by instruction issue (its
// note).
#include <cstdint>
#include <cuda_runtime.h>

#include "dfs_layout.cuh"

// K9's tables, a warp's at lane_stride(J) words from the last
extern __shared__ __align__(16) int32_t bt_jobs_smem[];

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowWarps = 8;        // K6: warps a block
constexpr int kRowsPerWarp = 4;     // K6: rows a warp, one after another
constexpr int kLaneWarps = 4;       // K9: lanes (warps) a block
constexpr int kMaxShared = 48 * 1024;   // K9's shared bytes, no opt-in

static_assert(NJF <= 32, "a row's fields are one load of a warp");
static_assert(P_MAX == 32, "a lane's partials are one per thread of a warp");

__device__ __forceinline__ int32_t clamp_q(int32_t v) {
    return v < 0 ? 0 : (v > 127 ? 127 : v);
}

// K9's shared words a warp: the lane's table, shifted by up to 3 words so
// that its 16-byte boundaries fall where the output's do, rounded to whole
// int4s.
__host__ __device__ constexpr int lane_stride(int J) {
    return (J * NJF + 3 + 3) / 4 * 4;
}

// K6, a warp per (lane, job) row; derive_rows_plain's arithmetic.  Lanes
// 0..NJF-1 load the row's fields (one coalesced load) and store them back
// at once; the fields the positions need reach the warp by shuffles.  The
// L positions go across the lanes 32 at a time: each thread takes its
// base from the read (reversed and/or shifted), complements it, applies
// the seed mutations and rounds the penalty, and consecutive threads store
// consecutive bytes of the row's three qqp rows.  The N tally
// (_tally_ns, ebwt_search_backtrack.h:1306-1343) is a ballot a chunk: the
// first three Ns are its lowest set bits, the count its popcount.  Every
// row is written, F_VALID 0 or not, so qqp equals the plain version's on
// every row.  A warp takes kRowsPerWarp consecutive rows in turn.
//
// What bounds it (PERF.md, K6's runs B and C): instruction issue, about
// 200 warp instructions a row, most of them a chunk's per-position work,
// which at L = 40 runs twice for 40 positions.  Loading the read with the
// fields and taking each base by a shuffle removed the loads that wait for
// a field but added shuffles, and was slower.
__device__ __forceinline__ void derive_row(
    long long r, int lane, const int32_t* __restrict__ scal,
    const int8_t* __restrict__ codes, const int8_t* __restrict__ qual,
    const int32_t* __restrict__ plen, int J, int L, int fc,
    int32_t* __restrict__ out, int8_t* __restrict__ qqp) {
    const int b = (int)(r / J);
    const int32_t mine = lane < NJF ? scal[r * NJF + lane] : 0;
    int32_t* o = out + r * NJF;
    if (lane < NJF && lane != F_NS_GATE && lane != F_NS_FTAB) o[lane] = mine;
    const auto field = [&](int k) { return __shfl_sync(kFull, mine, k); };
    const int32_t qs = field(F_QLEN), fwv = field(F_FW);
    const bool rev = fwv == field(F_EBWT_FW), comp = fwv == 0;
    const bool maq = field(F_MAQ_ROUND) > 0;
    const int32_t unrev = field(F_UNREV), rev1 = field(F_REV1),
                  rev2 = field(F_REV2), rev3 = field(F_REV3),
                  npremut = field(F_NPREMUT);
    // the seed mutations: position and code, -1 where there is none
    int32_t mpos[3], mref[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int32_t pos = field(F_PREMUT_POS0 + k);
        mref[k] = field(F_PREMUT_REFC0 + k);
        mpos[k] = npremut > k ? qs - 1 - pos : -1;
    }
    const int32_t pl = plen[b];
    const int8_t* cb = codes + (size_t)b * L;
    const int8_t* qb = qual + (size_t)b * L;
    int8_t* row = qqp + r * 3 * L;
    int32_t nsc = 0, p1 = -1, p2 = -1, p3 = -1, ns_ftab = 0;
    for (int i0 = 0; i0 < L; i0 += 32) {
        const int i = i0 + lane;
        const bool in_q = i < L && i < qs;
        int32_t code = 4, qv = 0;
        if (in_q) {
            int32_t t = (rev ? qs - 1 - i : pl - qs + i) % L;
            if (t < 0) t += L;
            code = cb[t];
            qv = qb[t];
            if (comp && code < 4) code = 3 - code;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (i == mpos[k]) code = mref[k];
        const int32_t pen = maq ? min(30, ((qv + 5) / 10) * 10) : qv;
        const bool isn = in_q && code == 4;
        unsigned m = __ballot_sync(kFull, isn && i < rev3);
        ns_ftab += __popc(__ballot_sync(kFull, isn && i < fc));
        for (; m && nsc < 3; m &= m - 1) {      // the same on every thread
            const int32_t at = i0 + __ffs(m) - 1;
            if (nsc == 0) p1 = at;
            else if (nsc == 1) p2 = at;
            else p3 = at;
            ++nsc;
        }
        nsc += __popc(m);
        if (i < L) {
            row[i] = (int8_t)code;
            row[L + i] = (int8_t)clamp_q(qv);
            row[2 * L + i] = (int8_t)clamp_q(pen);
        }
    }
    if (lane == F_NS_GATE)
        o[lane] = ((p1 >= 0 && p1 < unrev) || (p2 >= 0 && p2 < rev1)
                   || (p3 >= 0 && p3 < rev2) || nsc > 3) ? 1 : 0;
    else if (lane == F_NS_FTAB)
        o[lane] = ns_ftab;
}

__global__ void __launch_bounds__(kRowWarps * 32)
derive_rows_kernel(const int32_t* __restrict__ scal,
                   const int8_t* __restrict__ codes,
                   const int8_t* __restrict__ qual,
                   const int32_t* __restrict__ plen, int B, int J, int L,
                   int fc, int32_t* __restrict__ out,
                   int8_t* __restrict__ qqp) {
    const long long rows = (long long)B * J;
    const long long r0 = kRowsPerWarp
        * ((long long)blockIdx.x * kRowWarps + threadIdx.x / 32);
    const long long r1 =
        r0 + kRowsPerWarp < rows ? r0 + kRowsPerWarp : rows;
    for (long long r = r0; r < r1; ++r)        // the same on every thread
        derive_row(r, threadIdx.x % 32, scal, codes, qual, plen, J, L, fc,
                   out, qqp);
}

// The fields every launch-B job sets.
__device__ __forceinline__ void b_common(int32_t* o, int32_t plen,
                                         bool is_rc, int32_t maxbts,
                                         int32_t qt, int32_t maq) {
    o[F_VALID] = 1;
    o[F_QLEN] = plen;
    o[F_FW] = is_rc ? 0 : 1;
    o[F_EBWT_FW] = is_rc ? 1 : 0;
    o[F_REP_EXACTS] = 1;
    o[F_MAX_BTS] = maxbts;
    o[F_CONS_QUALS] = 1;
    o[F_QUAL_THRESH] = qt;
    o[F_MAQ_ROUND] = maq;
}

// K9: launch B's job table (-n mode) from launch A's outputs, a warp per
// lane, kLaneWarps lanes a block; derive_b_jobs_plain's arithmetic.  The
// warp zeroes the lane's [J][NJF] table in shared memory.  Partial t sits
// on thread t: a ballot of the rc partials (job jrc) and one of the fw
// partials give nrc and nfw, and a partial's rank in its block is the
// popcount of its ballot below it, so the extension jobs keep slot order:
// j = rank in the rc block, fw_base + rank in the fw block (fw_base =
// nrc, plus the rc half-and-half job under n >= 2 and not --norc), the
// block's first job resets the RNG, and jobs at j >= J are dropped.
// --norc/--nofw skip a block's jobs but not its count.  Threads 0 and 1
// write the rc and fw half-and-half jobs (search_seeded_phase3.c:29-92
// setOffs).  Then the warp copies the table out, whole 16-byte stores
// between a scalar head and tail; a lane that takes no jobs writes its
// zeros the same way.
__global__ void __launch_bounds__(kLaneWarps * 32)
derive_b_jobs_kernel(const int32_t* __restrict__ result,
                     const uint8_t* __restrict__ overflow,
                     const int32_t* __restrict__ mode,
                     const int32_t* __restrict__ npart,
                     const int32_t* __restrict__ part_job,
                     const int32_t* __restrict__ part_n,
                     const int32_t* __restrict__ part_pos,
                     const int32_t* __restrict__ part_refc,
                     const uint8_t* __restrict__ gated,
                     const int8_t* __restrict__ qual,
                     const int32_t* __restrict__ plen_a,
                     const int32_t* __restrict__ qual_rounds, int B, int L,
                     int J, int jrc, int n, int s, int qt, int maxbts,
                     int maq, int norc, int nofw, int32_t* __restrict__ out) {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int b = blockIdx.x * kLaneWarps + w;
    if (b >= B) return;                          // the whole warp
    const int words = J * NJF;
    int32_t* dst = out + (size_t)b * words;
    const int shift = (int)((reinterpret_cast<uintptr_t>(dst) / 4) % 4);
    int32_t* tab = bt_jobs_smem + w * lane_stride(J) + shift;
    for (int k = lane; k < words; k += 32) tab[k] = 0;
    __syncwarp();
    const bool active = result[b] == 0 && !overflow[b] && mode[b] == M_DONE
        && !gated[b] && n > 0;
    if (active) {
        const int32_t plen = plen_a[b];
        const int32_t qs = min(plen, s);
        const int np = min(npart[b], P_MAX);
        const size_t p = (size_t)b * P_MAX + lane;
        const bool valid = lane < np;
        const bool is_rc = valid && part_job[p] == jrc;
        const unsigned rcm = __ballot_sync(kFull, is_rc);
        const unsigned fwm = __ballot_sync(kFull, valid && !is_rc);
        const int nrc = __popc(rcm), nfw = __popc(fwm);
        const bool hh_rc = n >= 2 && !norc, hh_fw = n >= 2 && !nofw;
        const int fw_base = nrc + (hh_rc ? 1 : 0);
        const unsigned below = (1u << lane) - 1u;
        if (valid && !(is_rc ? norc : nofw)) {
            const int rank = __popc((is_rc ? rcm : fwm) & below);
            const int j = is_rc ? rank : fw_base + rank;
            if (j < J) {
                int32_t* o = tab + j * NJF;
                const int8_t* q = qual + (size_t)b * L;
                const int32_t pn = part_n[p];
                b_common(o, plen, is_rc, maxbts, qt, maq);
                o[F_UNREV] = o[F_REV1] = o[F_REV2] = o[F_REV3] = qs;
                int32_t ham0 = 0;
                for (int k = 0; k < 3 && k < pn; ++k) {
                    const int32_t pos = part_pos[3 * p + k];
                    const int32_t c = min(max(pos, 0), L + 3);
                    const int32_t mq = c < L ? q[c] : 0;
                    ham0 += maq ? qual_rounds[min(max(mq, 0), 255)] : mq;
                    o[F_PREMUT_POS0 + k] = plen - 1 - pos;
                    o[F_PREMUT_REFC0 + k] = part_refc[3 * p + k];
                }
                o[F_HAM0] = ham0;
                o[F_RESET_RNG] = rank == 0 ? 1 : 0;
                o[F_NPREMUT] = pn;
            }
        }
        if (lane < 2 && (lane == 0 ? hh_rc : hh_fw)) {
            const bool rc = lane == 0;
            const int j = rc ? nrc : fw_base + nfw;
            if (j < J) {
                const int32_t q5 = (qs >> 1) + (qs & 1);
                int32_t* o = tab + j * NJF;
                b_common(o, plen, rc, maxbts, qt, maq);
                o[F_D5] = q5;
                o[F_D3] = qs;
                o[F_UNREV] = 0;
                o[F_REV1] = n <= 2 ? q5 : 0;
                o[F_REV2] = n < 3 ? qs : q5;
                o[F_REV3] = qs;
                o[F_HH] = 1;
                o[F_RESET_RNG] = 1;
            }
        }
    }
    __syncwarp();
    // out: the words before dst's first 16-byte boundary, whole int4s,
    // then the rest
    const int head = min((4 - shift) % 4, words);
    const int quads = (words - head) / 4;
    const int tail = head + 4 * quads;
    if (lane < head) dst[lane] = tab[lane];
    const int4* src4 = reinterpret_cast<const int4*>(tab + head);
    int4* dst4 = reinterpret_cast<int4*>(dst + head);
    for (int k = lane; k < quads; k += 32) dst4[k] = src4[k];
    if (tail + lane < words) dst[tail + lane] = tab[tail + lane];
}

size_t b_jobs_shared(int J) {
    return (size_t)kLaneWarps * lane_stride(J) * 4;
}

}  // namespace

extern "C" {

int bt_derive_rows(const void* scal, const void* codes, const void* qual,
                   const void* plen, int B, int J, int L, int fc, void* out,
                   void* qqp, void* stream) {
    const long long a_block = (long long)kRowWarps * kRowsPerWarp;
    const long long rows = (long long)B * J;
    derive_rows_kernel<<<(unsigned)((rows + a_block - 1) / a_block),
                         kRowWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)scal, (const int8_t*)codes, (const int8_t*)qual,
        (const int32_t*)plen, B, J, L, fc, (int32_t*)out, (int8_t*)qqp);
    return (int)cudaGetLastError();
}

int bt_derive_b_jobs(const void* result, const void* overflow,
                     const void* mode, const void* npart,
                     const void* part_job, const void* part_n,
                     const void* part_pos, const void* part_refc,
                     const void* gated, const void* qual, const void* plen,
                     const void* qual_rounds, int B, int L, int J, int jrc,
                     int n, int s, int qt, int maxbts, int maq, int norc,
                     int nofw, void* out, void* stream) {
    if (J < 1 || b_jobs_shared(J) > (size_t)kMaxShared
            || reinterpret_cast<uintptr_t>(out) % 4)
        return (int)cudaErrorInvalidValue;
    derive_b_jobs_kernel<<<(B + kLaneWarps - 1) / kLaneWarps,
                           kLaneWarps * 32, b_jobs_shared(J),
                           (cudaStream_t)stream>>>(
        (const int32_t*)result, (const uint8_t*)overflow,
        (const int32_t*)mode, (const int32_t*)npart,
        (const int32_t*)part_job, (const int32_t*)part_n,
        (const int32_t*)part_pos, (const int32_t*)part_refc,
        (const uint8_t*)gated, (const int8_t*)qual, (const int32_t*)plen,
        (const int32_t*)qual_rounds, B, L, J, jrc, n, s, qt, maxbts, maq,
        norc, nofw, (int32_t*)out);
    return (int)cudaGetLastError();
}

// The launch shapes, for dfs_device.derive_rows_shape and
// n_device.derive_b_jobs_shape to check themselves by
int bt_jobs_row_warps() { return kRowWarps; }
int bt_jobs_rows_per_warp() { return kRowsPerWarp; }
int bt_jobs_lane_warps() { return kLaneWarps; }
int bt_jobs_max_shared() { return kMaxShared; }
int bt_jobs_b_shared(int J) { return (int)b_jobs_shared(J); }

// The local memory (stack) per thread of K6 (which 0) and K9 (which 1)
int bt_jobs_local_bytes(int which) {
    cudaFuncAttributes at;
    const cudaError_t e = which == 0
        ? cudaFuncGetAttributes(&at, derive_rows_kernel)
        : cudaFuncGetAttributes(&at, derive_b_jobs_kernel);
    return e == cudaSuccess ? (int)at.localSizeBytes : -1;
}

}  // extern "C"
