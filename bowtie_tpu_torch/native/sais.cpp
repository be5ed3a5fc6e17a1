// SA-IS suffix-array construction (native builder core).
//
// The reference builds its SA with blockwise Kärkkäinen + multikey
// quicksort + a difference-cover sample (blockwise_sa.h:183,
// diff_sample.h:521, multikey_qsort.h) — a 2005-era design trading
// speed for bounded memory.  This is a from-scratch linear-time SA-IS
// (induced sorting; Nong/Zhang/Chan 2009, public algorithm), compiled
// with g++ at first use by native/build.py.
//
// Index type is templated: int32 for texts < 2^31 (half the memory
// traffic), int64 beyond (.ebwtl scale).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename TChar, typename TIdx>
static void classify(const TChar* T, TIdx n, uint8_t* st) {
    st[n - 1] = 1;
    for (TIdx i = n - 2; i >= 0; --i)
        st[i] = T[i] < T[i + 1] || (T[i] == T[i + 1] && st[i + 1]);
}

template <typename TIdx>
static inline bool is_lms(const uint8_t* st, TIdx i) {
    return i > 0 && st[i] && !st[i - 1];
}

template <typename TChar, typename TIdx>
static void induce(const TChar* T, TIdx n, TIdx K, TIdx* SA,
                   const uint8_t* st, const std::vector<TIdx>& cnt,
                   std::vector<TIdx>& ptr) {
    // induce L from LMS (left to right)
    TIdx s = 0;
    for (TIdx c = 0; c < K; ++c) { ptr[c] = s; s += cnt[c]; }
    for (TIdx i = 0; i < n; ++i) {
        TIdx j = SA[i] - 1;
        if (SA[i] > 0 && !st[j]) SA[ptr[T[j]]++] = j;
    }
    // induce S from L (right to left)
    s = 0;
    for (TIdx c = 0; c < K; ++c) { s += cnt[c]; ptr[c] = s; }
    for (TIdx i = n - 1; i >= 0; --i) {
        TIdx j = SA[i] - 1;
        if (SA[i] > 0 && st[j]) SA[--ptr[T[j]]] = j;
    }
}

template <typename TChar, typename TIdx>
static int sais_main(const TChar* T, TIdx n, TIdx K, TIdx* SA) {
    if (n == 0) return 0;
    if (n == 1) { SA[0] = 0; return 0; }
    std::vector<uint8_t> stv((size_t)n);
    uint8_t* st = stv.data();
    classify<TChar, TIdx>(T, n, st);
    std::vector<TIdx> cnt((size_t)K, 0), ptr((size_t)K);
    for (TIdx i = 0; i < n; ++i) cnt[T[i]]++;

    // step 1: place LMS suffixes at bucket ends (unsorted), induce
    std::memset(SA, -1, sizeof(TIdx) * (size_t)n);
    {
        TIdx s = 0;
        for (TIdx c = 0; c < K; ++c) { s += cnt[c]; ptr[c] = s; }
        for (TIdx i = 1; i < n; ++i)
            if (is_lms(st, i)) SA[--ptr[T[i]]] = i;
    }
    induce(T, n, K, SA, st, cnt, ptr);

    // step 2: compact sorted LMS positions, name LMS substrings
    TIdx nlms = 0;
    for (TIdx i = 0; i < n; ++i)
        if (SA[i] > 0 && is_lms(st, SA[i])) SA[nlms++] = SA[i];
    TIdx* name = SA + nlms;          // scratch: nlms <= n/2
    std::memset(name, -1, sizeof(TIdx) * (size_t)(n - nlms));
    TIdx names = 0, prev = -1;
    for (TIdx i = 0; i < nlms; ++i) {
        TIdx pos = SA[i];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (TIdx d = 0;; ++d) {
                if (pos + d >= n || prev + d >= n ||
                    T[pos + d] != T[prev + d] ||
                    st[pos + d] != st[prev + d]) { diff = true; break; }
                if (d > 0 && (is_lms(st, pos + d) || is_lms(st, prev + d))) {
                    diff = !(is_lms(st, pos + d) && is_lms(st, prev + d));
                    break;
                }
            }
        }
        if (diff) { ++names; prev = pos; }
        name[pos / 2] = names - 1;
    }
    std::vector<TIdx> red((size_t)nlms), redpos((size_t)nlms);
    {
        TIdx k = 0;
        for (TIdx i = 1; i < n; ++i)
            if (is_lms(st, i)) redpos[k++] = i;
        for (TIdx k2 = 0; k2 < nlms; ++k2)
            red[k2] = name[redpos[k2] / 2];
    }

    // step 3: sort the reduced problem
    std::vector<TIdx> lms_sa((size_t)nlms);
    if (names < nlms) {
        int rc = sais_main<TIdx, TIdx>(red.data(), nlms, names,
                                       lms_sa.data());
        if (rc) return rc;
    } else {
        for (TIdx k = 0; k < nlms; ++k) lms_sa[red[k]] = k;
    }

    // step 4: place LMS suffixes in sorted order, induce the final SA
    std::memset(SA, -1, sizeof(TIdx) * (size_t)n);
    {
        TIdx s = 0;
        for (TIdx c = 0; c < K; ++c) { s += cnt[c]; ptr[c] = s; }
        for (TIdx k = nlms - 1; k >= 0; --k) {
            TIdx pos = redpos[lms_sa[k]];
            SA[--ptr[T[pos]]] = pos;
        }
    }
    induce(T, n, K, SA, st, cnt, ptr);
    return 0;
}

template <typename TIdx>
static int sais_bowtie_t(const uint8_t* codes, TIdx n, TIdx* SA_out) {
    // bowtie orders the empty suffix LAST (build/sa.py) — the standard
    // suffix order of codes + a unique MAX char.  SA-IS needs a unique
    // SMALLEST terminal, so sort t = [codes+1, 5, 0] and drop the
    // sentinel row; the trailing 0 never affects comparisons of
    // positions <= n because the unique 5 resolves them first.
    std::vector<uint8_t> t((size_t)n + 2);
    for (TIdx i = 0; i < n; ++i) t[(size_t)i] = codes[i] + 1;
    t[(size_t)n] = 5;
    t[(size_t)n + 1] = 0;
    std::vector<TIdx> sa((size_t)n + 2);
    int rc = sais_main<uint8_t, TIdx>(t.data(), (TIdx)(n + 2), (TIdx)6,
                                      sa.data());
    if (rc) return rc;
    std::memcpy(SA_out, sa.data() + 1, sizeof(TIdx) * (size_t)(n + 1));
    return 0;
}

}  // namespace

extern "C" {

// bowtie-order SA (see above).  SA_out: n+1 entries.
int sais_bowtie32(const uint8_t* codes, int32_t n, int32_t* SA_out) {
    return sais_bowtie_t<int32_t>(codes, n, SA_out);
}

int sais_bowtie(const uint8_t* codes, int64_t n, int64_t* SA_out) {
    return sais_bowtie_t<int64_t>(codes, n, SA_out);
}

// Streaming-writer extraction pass (buildToDisk analog, ebwt.h:3985):
// for each SA row, emit the BWT char (text[sa-1], '$'->A) and the
// leading fc-mer word (-1 for suffixes shorter than fc).  Reads the
// 2-bit big-endian packed text (32 bases/uint64, base j at bits
// [62-2j,64-2j)) so each row costs ~1-2 cache lines instead of
// fc+1 byte gathers into the full text.
void stream_extract(const uint64_t* packed, const int64_t* sa,
                    int64_t nrows, int64_t length, int fc,
                    uint8_t* bwt_out, int64_t* word_out) {
    const uint64_t kshift = 64 - 2 * (uint64_t)fc;
    for (int64_t i = 0; i < nrows; i++) {
        int64_t p = sa[i];
        if (i + 8 < nrows) {  // hide DRAM latency across iterations
            int64_t pp = sa[i + 8];
            __builtin_prefetch(&packed[(pp > 0 ? pp - 1 : 0) >> 5]);
            __builtin_prefetch(&packed[pp >> 5]);
        }
        int64_t prev = p > 0 ? p - 1 : 0;
        uint64_t w = packed[prev >> 5];
        uint8_t c = (uint8_t)((w >> (62 - 2 * (prev & 31))) & 3);
        bwt_out[i] = p > 0 ? c : 0;
        if (length - p >= fc) {
            uint64_t r2 = 2 * (uint64_t)(p & 31);
            uint64_t hi = packed[p >> 5] << r2;
            uint64_t lo = (packed[(p >> 5) + 1] >> (63 - r2)) >> 1;
            word_out[i] = (int64_t)((hi | lo) >> kshift);
        } else {
            word_out[i] = -1;
        }
    }
}

}  // extern "C"
