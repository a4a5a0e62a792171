#define _GNU_SOURCE   /* memmem */
/* Native alignment primitives for pintron-tpu.
 *
 * The reference implements these loops in C (src/compute-alignments.c,
 * src/refine.c); this library provides the same recurrences as a small
 * shared object used by the host pipeline via ctypes.  Semantics are
 * identical to the Python fallbacks in pintron_tpu/factorize/alignments.py.
 *
 * Build: cc -O2 -fPIC -shared dp.c -o libpintron_dp.so
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static double fe_now(void);
static double ri_stats[8];

#define BIG (1LL << 60)

static inline int64_t min3(int64_t a, int64_t b, int64_t c) {
    int64_t m = a < b ? a : b;
    return m < c ? m : c;
}

/* K-band edit distance, classic three-phase band loop — kept as the
 * wide-value fallback for sequences beyond the int16 range; the normal
 * path is the band-offset wavefront kband_core further below.
 * seq1 must be the longer sequence; callers handle the swap/shortcuts.
 * Returns the final band cell value M[n+k-m]. */
/* ---- DP cell census ---------------------------------------------------
 * Host-computed DP cells per family, for the honest offload-fraction
 * metric (bench.py device_cell_fraction): 0=kband 1=edit 2=nw
 * 3=gap-align 4=refine-borders.  Per-process, non-atomic: every DP
 * core runs on the process's main thread. */
int64_t dp_census[5] = {0, 0, 0, 0, 0};

void dp_census_get(int64_t *out5) {
    int i;
    for (i = 0; i < 5; i++) out5[i] = dp_census[i];
}

void dp_census_reset(void) {
    int i;
    for (i = 0; i < 5; i++) dp_census[i] = 0;
}

/* ---- endpoint-memo misses ---------------------------------------------
 * The host NW alignments of the endpoint cut (ep_handle_endpoints) that
 * missed the tag-1/2 memo, where the device flow pre-fills it: by the
 * entry point whose cascade ran the cut (ep_site: EP_SITE_NOISY
 * est_collect_noisy, EP_SITE_GAPS est_collect_gaps, EP_SITE_INTRONS
 * est_collect_introns, EP_SITE_CASCADE est_process and
 * est_process_cands) and the kind (0 the head, 1 the tail of a
 * multi-factor candidate, 2 the tail of a one-factor candidate, which
 * the head cut may have moved), {alignments, cells as dp_census
 * counts them}; ep_nw_wipes counts the memo's wipes.  Per-process,
 * non-atomic, as dp_census. */
enum { EP_SITE_NOISY, EP_SITE_GAPS, EP_SITE_INTRONS, EP_SITE_CASCADE,
       EP_SITES };
static int ep_site = EP_SITE_CASCADE;
static int64_t ep_nw_miss[EP_SITES][3][2];
static int64_t ep_nw_wipes = 0;

/* out: EP_SITES * 3 * 2 counts (site-major), then the wipes */
void ep_nw_miss_get(int64_t *out) {
    memcpy(out, ep_nw_miss, sizeof(ep_nw_miss));
    out[EP_SITES * 3 * 2] = ep_nw_wipes;
}

void ep_nw_miss_reset(void) {
    memset(ep_nw_miss, 0, sizeof(ep_nw_miss));
    ep_nw_wipes = 0;
}

static int64_t kband_core_wide(const char *seq1, int64_t n,
                               const char *seq2, int64_t m, int64_t k) {
    int64_t w = 2 * k + 1;
    int64_t *M1 = (int64_t *)malloc(w * sizeof(int64_t));
    int64_t *M2 = (int64_t *)malloc(w * sizeof(int64_t));
    int64_t r, c, d, result;
    if (!M1 || !M2) { free(M1); free(M2); return -1; }
    for (c = 0; c < w; c++) M1[c] = BIG;
    for (c = 0; c <= k; c++) M1[k + c] = c;
    for (c = 0; c < w; c++) M2[c] = k + 1;

    for (r = 1; r <= k && r <= m; r++) {
        M2[k - r] = r;
        for (c = 1; c < r + k; c++) {
            d = M1[k - r + c] + (seq1[c - 1] != seq2[r - 1]);
            if (M2[k - r + c - 1] + 1 < d) d = M2[k - r + c - 1] + 1;
            if (M1[k - r + c + 1] + 1 < d) d = M1[k - r + c + 1] + 1;
            M2[k - r + c] = d;
        }
        d = M1[2 * k] + (seq1[r + k - 1] != seq2[r - 1]);
        if (M2[2 * k - 1] + 1 < d) d = M2[2 * k - 1] + 1;
        M2[2 * k] = d;
        { int64_t *t = M1; M1 = M2; M2 = t; }
    }

    for (r = k + 1; r <= n - k && r <= m; r++) {
        M2[0] = M1[0] + (seq1[r - k - 1] != seq2[r - 1]);
        if (M1[1] + 1 < M2[0]) M2[0] = M1[1] + 1;
        for (c = r + 1 - k; c < r + k; c++) {
            d = M1[c + k - r] + (seq1[c - 1] != seq2[r - 1]);
            if (M2[c + k - r - 1] + 1 < d) d = M2[c + k - r - 1] + 1;
            if (M1[c + k - r + 1] + 1 < d) d = M1[c + k - r + 1] + 1;
            M2[c + k - r] = d;
        }
        d = M1[2 * k] + (seq1[r + k - 1] != seq2[r - 1]);
        if (M2[2 * k - 1] + 1 < d) d = M2[2 * k - 1] + 1;
        M2[2 * k] = d;
        { int64_t *t = M1; M1 = M2; M2 = t; }
    }

    for (r = n + 1 - k; r <= m; r++) {
        if (r < k + 1) continue;
        M2[0] = M1[0] + (seq1[r - k - 1] != seq2[r - 1]);
        if (M1[1] + 1 < M2[0]) M2[0] = M1[1] + 1;
        for (c = r + 1 - k; c <= n; c++) {
            d = M1[c + k - r] + (seq1[c - 1] != seq2[r - 1]);
            if (M2[c + k - r - 1] + 1 < d) d = M2[c + k - r - 1] + 1;
            if (M1[c + k - r + 1] + 1 < d) d = M1[c + k - r + 1] + 1;
            M2[c + k - r] = d;
        }
        { int64_t *t = M1; M1 = M2; M2 = t; }
    }

    {
        int64_t fo = n + k - m;   /* clamped like the int16 core */
        if (fo < 0) fo = 0;
        if (fo >= w) fo = w - 1;
        result = M1[fo];
    }
    free(M1); free(M2);
    return result;
}

/* Global alignment (compute-alignments.c:85-207 semantics): unit cost,
 * N wildcards, direction preference diag > up > left with strict
 * improvement.  Fills dirs (n+1)x(m+1) row-major int8 and returns the
 * final score.  Caller runs the traceback. */
/* ---- left-relaxation prefix scans --------------------------------------
 * The DP rows' left-dependency  cur[j] = opt(t0[j], cur[j-1] +/- 1)
 * equals a prefix extremum over slope-shifted values:
 *   min version:  cur[j] = min_{k<=j}(t0[k] + (j-k))  ->  s=t0-j, prefmin
 *   max version:  cur[j] = max_{k<=j}(t0[k] - (j-k))  ->  s=t0+j, prefmax
 * which SIMD-izes with log-step in-register shuffles (the plain scan is
 * one cell per ~3 cycles; this is ~8 cells per ~6 ops).  cur[0] is the
 * boundary term (k = 0). */

#if defined(__AVX2__)
#include <immintrin.h>

/* shift x right by one/two/four int32 lanes, filling with `fill` */
static inline __m256i up_shr1(__m256i x, __m256i fill) {
    __m256i t = _mm256_permute2x128_si256(fill, x, 0x20);
    return _mm256_alignr_epi8(x, t, 12);
}
static inline __m256i up_shr2(__m256i x, __m256i fill) {
    __m256i t = _mm256_permute2x128_si256(fill, x, 0x20);
    return _mm256_alignr_epi8(x, t, 8);
}
static inline __m256i up_shr4(__m256i x, __m256i fill) {
    return _mm256_permute2x128_si256(fill, x, 0x20);
}
#endif

/* cur[j] = min(t0[j], cur[j-1] + 1) for j = 1..m, in place (cur[1..m]
 * holds t0 on entry; cur[0] is the row boundary). */
static void relax_min_slope1(int32_t *cur, int64_t m) {
    int64_t j = 1;
#if defined(__AVX2__)
    const __m256i INF = _mm256_set1_epi32(2147483647);
    const __m256i idx0 = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    int32_t carry = cur[0];
    for (; j + 8 <= m + 1; j += 8) {
        __m256i jv = _mm256_add_epi32(_mm256_set1_epi32((int32_t)j),
                                      idx0);
        __m256i x = _mm256_loadu_si256((const __m256i *)(cur + j));
        __m256i s = _mm256_sub_epi32(x, jv);
        s = _mm256_min_epi32(s, up_shr1(s, INF));
        s = _mm256_min_epi32(s, up_shr2(s, INF));
        s = _mm256_min_epi32(s, up_shr4(s, INF));
        s = _mm256_min_epi32(s, _mm256_set1_epi32(carry));
        _mm256_storeu_si256((__m256i *)(cur + j),
                            _mm256_add_epi32(s, jv));
        carry = _mm256_extract_epi32(s, 7);
    }
    for (; j <= m; j++) {
        int32_t s = cur[j] - (int32_t)j;
        if (carry < s) s = carry;
        cur[j] = s + (int32_t)j;
        carry = s;
    }
#else
    for (; j <= m; j++) {
        int32_t c = cur[j - 1] + 1;
        if (c < cur[j]) cur[j] = c;
    }
#endif
}

/* cur[j] = max(t0[j], cur[j-1] - 1) for j = 1..m, in place. */
static void relax_max_slope1(int32_t *cur, int64_t m) {
    int64_t j = 1;
#if defined(__AVX2__)
    const __m256i NINF = _mm256_set1_epi32(-2147483647 - 1);
    const __m256i idx0 = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    int32_t carry = cur[0];
    for (; j + 8 <= m + 1; j += 8) {
        __m256i jv = _mm256_add_epi32(_mm256_set1_epi32((int32_t)j),
                                      idx0);
        __m256i x = _mm256_loadu_si256((const __m256i *)(cur + j));
        __m256i s = _mm256_add_epi32(x, jv);
        s = _mm256_max_epi32(s, up_shr1(s, NINF));
        s = _mm256_max_epi32(s, up_shr2(s, NINF));
        s = _mm256_max_epi32(s, up_shr4(s, NINF));
        s = _mm256_max_epi32(s, _mm256_set1_epi32(carry));
        _mm256_storeu_si256((__m256i *)(cur + j),
                            _mm256_sub_epi32(s, jv));
        carry = _mm256_extract_epi32(s, 7);
    }
    for (; j <= m; j++) {
        int32_t s = cur[j] + (int32_t)j;
        if (carry > s) s = carry;
        cur[j] = s - (int32_t)j;
        carry = s;
    }
#else
    for (; j <= m; j++) {
        int32_t c = cur[j - 1] - 1;
        if (c > cur[j]) cur[j] = c;
    }
#endif
}

/* gcur[j] = max(gcur[j-1], lcur[j-1]) for j = 1..m with gcur[0] = 0 and
 * lcur[0] = 0, i.e. the running maximum of lcur shifted by one. */
static void g_scan_max(const int32_t *lcur, int32_t *gcur, int64_t m) {
    int64_t j = 1;
#if defined(__AVX2__)
    const __m256i NINF = _mm256_set1_epi32(-2147483647 - 1);
    int32_t carry = -2147483647 - 1;
    for (; j + 8 <= m + 1; j += 8) {
        __m256i x = _mm256_loadu_si256((const __m256i *)(lcur + j - 1));
        x = _mm256_max_epi32(x, up_shr1(x, NINF));
        x = _mm256_max_epi32(x, up_shr2(x, NINF));
        x = _mm256_max_epi32(x, up_shr4(x, NINF));
        x = _mm256_max_epi32(x, _mm256_set1_epi32(carry));
        _mm256_storeu_si256((__m256i *)(gcur + j), x);
        carry = _mm256_extract_epi32(x, 7);
    }
    for (; j <= m; j++) {
        int32_t v = lcur[j - 1];
        if (carry > v) v = carry;
        gcur[j] = v;
        carry = v;
    }
#else
    for (; j <= m; j++) {
        int32_t gp = gcur[j - 1];
        int32_t lc = lcur[j - 1];
        gcur[j] = gp < lc ? lc : gp;
    }
#endif
}

/* int16 variants of the row kernels: the DP values are bounded by
 * +-(n+m) and the slope shift adds at most m, so for n+m below ~14000
 * the whole row fits int16 exactly — identical values, twice the SIMD
 * lanes.  Callers gate on the window size and fall back to the int32
 * kernels above. */
#define I16_LIMIT 14000

#if defined(__AVX2__)
static inline __m256i up16_shr1(__m256i x, __m256i fill) {
    __m256i t = _mm256_permute2x128_si256(fill, x, 0x20);
    return _mm256_alignr_epi8(x, t, 14);
}
static inline __m256i up16_shr2(__m256i x, __m256i fill) {
    __m256i t = _mm256_permute2x128_si256(fill, x, 0x20);
    return _mm256_alignr_epi8(x, t, 12);
}
static inline __m256i up16_shr4(__m256i x, __m256i fill) {
    __m256i t = _mm256_permute2x128_si256(fill, x, 0x20);
    return _mm256_alignr_epi8(x, t, 8);
}
static inline __m256i up16_shr8(__m256i x, __m256i fill) {
    return _mm256_permute2x128_si256(fill, x, 0x20);
}
#endif

/* cur[j] = min(t0[j], cur[j-1] + 1), int16 rows. */
static void relax_min16_slope1(int16_t *cur, int64_t m) {
    int64_t j = 1;
#if defined(__AVX2__)
    const __m256i INF = _mm256_set1_epi16(32767);
    const __m256i idx0 = _mm256_setr_epi16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                           10, 11, 12, 13, 14, 15);
    int16_t carry = cur[0];
    for (; j + 16 <= m + 1; j += 16) {
        __m256i jv = _mm256_add_epi16(_mm256_set1_epi16((int16_t)j),
                                      idx0);
        __m256i x = _mm256_loadu_si256((const __m256i *)(cur + j));
        __m256i s = _mm256_sub_epi16(x, jv);
        s = _mm256_min_epi16(s, up16_shr1(s, INF));
        s = _mm256_min_epi16(s, up16_shr2(s, INF));
        s = _mm256_min_epi16(s, up16_shr4(s, INF));
        s = _mm256_min_epi16(s, up16_shr8(s, INF));
        s = _mm256_min_epi16(s, _mm256_set1_epi16(carry));
        _mm256_storeu_si256((__m256i *)(cur + j),
                            _mm256_add_epi16(s, jv));
        carry = (int16_t)_mm256_extract_epi16(s, 15);
    }
    for (; j <= m; j++) {
        int16_t s = (int16_t)(cur[j] - (int16_t)j);
        if (carry < s) s = carry;
        cur[j] = (int16_t)(s + (int16_t)j);
        carry = s;
    }
#else
    for (; j <= m; j++) {
        int16_t c = (int16_t)(cur[j - 1] + 1);
        if (c < cur[j]) cur[j] = c;
    }
#endif
}

/* cur[j] = max(t0[j], cur[j-1] - 1), int16 rows. */
static void relax_max16_slope1(int16_t *cur, int64_t m) {
    int64_t j = 1;
#if defined(__AVX2__)
    const __m256i NINF = _mm256_set1_epi16(-32768);
    const __m256i idx0 = _mm256_setr_epi16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                           10, 11, 12, 13, 14, 15);
    int16_t carry = cur[0];
    for (; j + 16 <= m + 1; j += 16) {
        __m256i jv = _mm256_add_epi16(_mm256_set1_epi16((int16_t)j),
                                      idx0);
        __m256i x = _mm256_loadu_si256((const __m256i *)(cur + j));
        __m256i s = _mm256_add_epi16(x, jv);
        s = _mm256_max_epi16(s, up16_shr1(s, NINF));
        s = _mm256_max_epi16(s, up16_shr2(s, NINF));
        s = _mm256_max_epi16(s, up16_shr4(s, NINF));
        s = _mm256_max_epi16(s, up16_shr8(s, NINF));
        s = _mm256_max_epi16(s, _mm256_set1_epi16(carry));
        _mm256_storeu_si256((__m256i *)(cur + j),
                            _mm256_sub_epi16(s, jv));
        carry = (int16_t)_mm256_extract_epi16(s, 15);
    }
    for (; j <= m; j++) {
        int16_t s = (int16_t)(cur[j] + (int16_t)j);
        if (carry > s) s = carry;
        cur[j] = (int16_t)(s - (int16_t)j);
        carry = s;
    }
#else
    for (; j <= m; j++) {
        int16_t c = (int16_t)(cur[j - 1] - 1);
        if (c > cur[j]) cur[j] = c;
    }
#endif
}

/* gcur[j] = max(gcur[j-1], lcur[j-1]) with gcur[0] = lcur[0] = 0. */
static void g_scan_max16(const int16_t *lcur, int16_t *gcur, int64_t m) {
    int64_t j = 1;
#if defined(__AVX2__)
    const __m256i NINF = _mm256_set1_epi16(-32768);
    int16_t carry = -32768;
    for (; j + 16 <= m + 1; j += 16) {
        __m256i x = _mm256_loadu_si256((const __m256i *)(lcur + j - 1));
        x = _mm256_max_epi16(x, up16_shr1(x, NINF));
        x = _mm256_max_epi16(x, up16_shr2(x, NINF));
        x = _mm256_max_epi16(x, up16_shr4(x, NINF));
        x = _mm256_max_epi16(x, up16_shr8(x, NINF));
        x = _mm256_max_epi16(x, _mm256_set1_epi16(carry));
        _mm256_storeu_si256((__m256i *)(gcur + j), x);
        carry = (int16_t)_mm256_extract_epi16(x, 15);
    }
    for (; j <= m; j++) {
        int16_t v = lcur[j - 1];
        if (carry > v) v = carry;
        gcur[j] = v;
        carry = v;
    }
#else
    for (; j <= m; j++) {
        int16_t gp = gcur[j - 1];
        int16_t lc = lcur[j - 1];
        gcur[j] = gp < lc ? lc : gp;
    }
#endif
}

/* K-band edit distance in the band-offset wavefront formulation — the
 * SAME program as the device op (ops/align.py banded_edit_distance,
 * proven bit-equal to the classic band loop): one band vector M[o]
 * with o = c - r + k, per row a branch-free diag/up minimum then the
 * left-chain closed by the slope-1 prefix relax.  int16 rows (values
 * are edit distances <= n plus a bounded sentinel), wide fallback for
 * long sequences.  Callers guarantee n >= m, n - m <= k, 2k+1 < n. */
#define KB_BIG16 ((int16_t)16000)

int64_t kband_core(const char *seq1, int64_t n, const char *seq2,
                   int64_t m, int64_t k) {
    static int16_t *buf = NULL;
    static int64_t buf_cap = 0;
    int64_t W = 2 * k + 1;
    int16_t *M1, *cand;
    int64_t r, o;
    dp_census[0] += m * W;
    if (n + W + 4 >= 15500)
        return kband_core_wide(seq1, n, seq2, m, k);
    if (2 * (W + 2) > buf_cap) {
        int16_t *nb = (int16_t *)realloc(
            buf, (size_t)(4 * (W + 2) + 64) * sizeof(int16_t));
        if (!nb) return -1;
        buf = nb;
        buf_cap = 4 * (W + 2) + 64;
    }
    M1 = buf;
    cand = buf + (W + 2);
    /* row 0: M[o] = c for 0 <= c <= k (c = o - k), BIG outside */
    for (o = 0; o < W; o++) {
        int64_t c = o - k;
        M1[o] = (c >= 0 && c <= k) ? (int16_t)c : KB_BIG16;
    }
    for (r = 1; r <= m; r++) {
        char c2 = seq2[r - 1];
        int64_t base = r - k;            /* c at o = 0 */
        int64_t o_lo = base >= 1 ? 0 : 1 - base;      /* c >= 1 */
        int64_t o_hi = n - base < W - 1 ? n - base : W - 1;  /* c <= n */
        /* cand[o] = min(M1[o] + mism, M1[o+1] + 1), BIG outside band */
        for (o = 0; o < o_lo; o++) cand[o] = KB_BIG16;
        for (o = o_hi + 1; o < W; o++) cand[o] = KB_BIG16;
        for (o = o_lo; o <= o_hi; o++) {
            int16_t diag = (int16_t)(M1[o]
                                     + (seq1[base + o - 1] != c2));
            int16_t up = (int16_t)((o + 1 < W ? M1[o + 1] : KB_BIG16)
                                   + 1);
            cand[o] = diag < up ? diag : up;
        }
        /* boundary cell c == 0 forced to r while r <= k */
        if (base <= 0 && r <= k) cand[-base] = (int16_t)r;
        /* left-chain: M2[o] = min_{j<=o}(cand[j] + (o-j)) */
        relax_min16_slope1(cand, W - 1);
        for (o = 0; o < W; o++)
            M1[o] = cand[o] < KB_BIG16 ? cand[o] : KB_BIG16;
    }
    {
        /* callers guarantee n - m <= k; clamp anyway so an
         * out-of-contract call cannot read past the band */
        int64_t fo = n + k - m;
        if (fo < 0) fo = 0;
        if (fo >= W) fo = W - 1;
        return M1[fo];
    }
}

static int32_t *nw_buf = NULL;
static int64_t nw_buf_cap = 0;

static double nw_t0_tmp;
/* int16 core (exact for n+m < I16_LIMIT: every value is bounded by
 * max(n, m) <= n+m and the relax slope adds at most m) */
static int64_t nw_align16(const char *est, int64_t n, const char *gen,
                          int64_t m, int8_t *dirs) {
    int64_t need = 2 * (m + 2);   /* int32 units; rows are int16 */
    int16_t *prev, *cur, *cost;
    int64_t i, j, score;
    if (need > nw_buf_cap) {
        int32_t *nb = (int32_t *)realloc(
            nw_buf, (size_t)(2 * need + 64) * sizeof(int32_t));
        if (!nb) return -1;
        nw_buf = nb;
        nw_buf_cap = 2 * need + 64;
    }
    prev = (int16_t *)nw_buf;
    cur = prev + (m + 1);
    cost = cur + (m + 1);
    for (j = 0; j <= m; j++) prev[j] = (int16_t)j;
    for (i = 1; i <= n; i++) {
        char e = est[i - 1];
        int8_t *drow = dirs + i * (m + 1);
        if (e == 'n' || e == 'N') {
            for (j = 1; j <= m; j++) cost[j] = 0;
        } else {
            for (j = 1; j <= m; j++) {
                char g = gen[j - 1];
                cost[j] = (g != e) & (g != 'n') & (g != 'N');
            }
        }
        cur[0] = (int16_t)i;
        for (j = 1; j <= m; j++) {
            int16_t a = (int16_t)(prev[j - 1] + cost[j]);
            int16_t b = (int16_t)(prev[j] + 1);
            cur[j] = a < b ? a : b;
        }
        relax_min16_slope1(cur, m);
        for (j = 1; j <= m; j++) {
            int16_t v = cur[j];
            drow[j] = v == (int16_t)(prev[j - 1] + cost[j]) ? 0
                : (v == (int16_t)(prev[j] + 1) ? 1 : 2);
        }
        { int16_t *t = prev; prev = cur; cur = t; }
    }
    score = prev[m];
    return score;
}

int64_t nw_align(const char *est, int64_t n, const char *gen, int64_t m,
                 int8_t *dirs) {
    nw_t0_tmp = fe_now();
    /* Pass-structured fill (same values/directions as the classic cell
     * loop): per row, (1) the branch-free diag/up minimum over the
     * previous row — independent per cell, auto-vectorizes; (2) the
     * sequential left-relaxation prefix scan; (3) direction bytes
     * recomputed from the final values with the same tie order
     * (diag > up > left, strict improvement). int16 rows when the
     * window allows (exact — see I16_LIMIT), int32 otherwise. */
    int64_t need = 3 * (m + 2);
    int32_t *prev, *cur, *cost;
    int64_t i, j, score;
    if (n + m < I16_LIMIT) {
        score = nw_align16(est, n, gen, m, dirs);
        ri_stats[2] += fe_now() - nw_t0_tmp; ri_stats[5] += 1.0;
        return score;
    }
    if (need > nw_buf_cap) {
        int32_t *nb = (int32_t *)realloc(
            nw_buf, (size_t)(2 * need + 64) * sizeof(int32_t));
        if (!nb) return -1;
        nw_buf = nb;
        nw_buf_cap = 2 * need + 64;
    }
    prev = nw_buf;
    cur = prev + (m + 1);
    cost = cur + (m + 1);
    for (j = 0; j <= m; j++) prev[j] = (int32_t)j;
    /* no dirs memset: the traceback only reads dirs[i][j] for
     * i,j >= 1, all of which are written below */
    for (i = 1; i <= n; i++) {
        char e = est[i - 1];
        int8_t *drow = dirs + i * (m + 1);
        if (e == 'n' || e == 'N') {
            for (j = 1; j <= m; j++) cost[j] = 0;
        } else {
            for (j = 1; j <= m; j++) {
                char g = gen[j - 1];
                cost[j] = (g != e) & (g != 'n') & (g != 'N');
            }
        }
        cur[0] = (int32_t)i;
        for (j = 1; j <= m; j++) {
            int32_t a = prev[j - 1] + cost[j];
            int32_t b = prev[j] + 1;
            cur[j] = a < b ? a : b;
        }
        relax_min_slope1(cur, m);
        for (j = 1; j <= m; j++) {
            int32_t v = cur[j];
            drow[j] = v == prev[j - 1] + cost[j] ? 0
                : (v == prev[j] + 1 ? 1 : 2);
        }
        { int32_t *t = prev; prev = cur; cur = t; }
    }
    score = prev[m];
    ri_stats[2] += fe_now() - nw_t0_tmp; ri_stats[5] += 1.0;
    return score;
}

/* ---- Suffix tree construction -----------------------------------------
 * Ukkonen build + augmentation, mirroring pintron_tpu/index/gst.py
 * exactly (including the DFS ordering that defines the occurrence
 * slices).  Children are kept as insertion-ordered sibling lists; edge
 * splits REPLACE the child in place (preserving its position) like a
 * Python dict key overwrite. */

typedef struct {
    int64_t *start, *end, *parent, *slink;
    int64_t *first_child, *next_sib, *last_child;
    unsigned char *first_char;   /* first char of the node's up edge label */
    int64_t nn;
} stree_t;

static int64_t st_new_node(stree_t *st, int64_t start, int64_t end,
                           int64_t parent) {
    int64_t v = st->nn++;
    st->start[v] = start;
    st->end[v] = end;
    st->parent[v] = parent;
    st->slink[v] = -1;
    st->first_child[v] = -1;
    st->last_child[v] = -1;
    st->next_sib[v] = -1;
    return v;
}

static int64_t st_get_child(const stree_t *st, int64_t v, unsigned char c) {
    int64_t ch = st->first_child[v];
    while (ch != -1) {
        if (st->first_char[ch] == c) return ch;
        ch = st->next_sib[ch];
    }
    return -1;
}

/* dict-like set: replace in place if key exists, else append at tail */
static void st_set_child(stree_t *st, int64_t v, unsigned char c,
                         int64_t node) {
    int64_t ch = st->first_child[v], prev = -1;
    st->first_char[node] = c;
    while (ch != -1) {
        if (st->first_char[ch] == c) {
            st->next_sib[node] = st->next_sib[ch];
            if (prev == -1) st->first_child[v] = node;
            else st->next_sib[prev] = node;
            if (st->last_child[v] == ch) st->last_child[v] = node;
            return;
        }
        prev = ch;
        ch = st->next_sib[ch];
    }
    st->next_sib[node] = -1;
    if (st->last_child[v] == -1) {
        st->first_child[v] = node;
        st->last_child[v] = node;
    } else {
        st->next_sib[st->last_child[v]] = node;
        st->last_child[v] = node;
    }
}

/* Dense-children Ukkonen build + augmentation for small alphabets
 * (<= 8 distinct symbols incl. the terminator, the normal genomic
 * case): per-node direct child arrays (int32) replace sibling-list
 * walks.  Child iteration is in symbol-code order; every downstream
 * consumer (occurrence slices, vertex scan, MEG) is order-insensitive
 * because pairing columns are sorted before use.  Returns the node
 * count or -2 when the alphabet is too large (caller falls back). */
static int64_t st_build_dense(const unsigned char *text, int64_t tlen,
                              int64_t *start, int64_t *end,
                              int64_t *parent, int64_t *slink,
                              int64_t *depth, int64_t *leaf_idx,
                              int64_t *lo, int64_t *hi, int64_t *occ,
                              unsigned char *single_char,
                              int64_t *coff, unsigned char *cchar,
                              int64_t *cnode) {
    int64_t cap = 2 * tlen + 4;
    int code256[256];
    unsigned char code_char[8];
    int64_t K = 0, i, nn;
    int32_t *kid;
    int64_t active_node, active_edge, active_len, remainder;

    for (i = 0; i < 256; i++) code256[i] = -1;
    for (i = 0; i < tlen; i++) {
        unsigned char c = text[i];
        /* the augmentation's leaf test (edge runs to the text end)
         * needs the terminal NUL to be unique */
        if (c == 0 && i != tlen - 1) return -2;
        if (code256[c] < 0) {
            if (K == 8) return -2;
            code256[c] = (int)K;
            code_char[K] = c;
            K++;
        }
    }

    kid = (int32_t *)malloc((size_t)cap * (size_t)K * sizeof(int32_t));
    if (!kid) return -1;

#define KID(v, c) kid[(int64_t)(v) * K + (c)]
#define NEW_NODE(s, e, par) (start[nn] = (s), end[nn] = (e),     parent[nn] = (par), slink[nn] = -1,     memset(kid + nn * K, 0xFF, (size_t)K * sizeof(int32_t)), nn++)

    nn = 0;
    NEW_NODE(0, 0, -1);   /* root */
    active_node = 0; active_edge = 0; active_len = 0; remainder = 0;
    for (i = 0; i < tlen; i++) {
        unsigned char c = text[i];
        int cc = code256[c];
        int64_t last_internal = -1;
        remainder++;
        while (remainder > 0) {
            int ae;
            int64_t child;
            if (active_len == 0) active_edge = i;
            ae = code256[text[active_edge]];
            child = KID(active_node, ae);
            if (child == -1) {
                int64_t leaf = NEW_NODE(i, tlen, active_node);
                KID(active_node, ae) = (int32_t)leaf;
                if (last_internal != -1) {
                    slink[last_internal] = active_node;
                    last_internal = -1;
                }
            } else {
                int64_t e = end[child] < i + 1 ? end[child] : i + 1;
                int64_t edge_len = e - start[child];
                if (active_len >= edge_len) {
                    active_node = child;
                    active_edge += edge_len;
                    active_len -= edge_len;
                    continue;
                }
                if (text[start[child] + active_len] == c) {
                    active_len++;
                    if (last_internal != -1) {
                        slink[last_internal] = active_node;
                        last_internal = -1;
                    }
                    break;
                }
                {
                    int64_t split = NEW_NODE(start[child],
                                             start[child] + active_len,
                                             active_node);
                    int64_t leaf;
                    KID(active_node, ae) = (int32_t)split;
                    start[child] += active_len;
                    parent[child] = split;
                    KID(split, code256[text[start[child]]]) =
                        (int32_t)child;
                    leaf = NEW_NODE(i, tlen, split);
                    KID(split, cc) = (int32_t)leaf;
                    if (last_internal != -1) slink[last_internal] = split;
                    last_internal = split;
                }
            }
            remainder--;
            if (active_node == 0 && active_len > 0) {
                active_len--;
                active_edge = i - remainder + 1;
            } else if (active_node != 0) {
                active_node = slink[active_node] != -1
                    ? slink[active_node] : 0;
            }
        }
    }
    for (i = 1; i < nn; i++)
        if (end[i] > tlen) end[i] = tlen;

    /* augmentation: iterative DFS, children visited in code order */
    {
        int64_t nocc = 0, sp = 0;
        int64_t *stack = (int64_t *)malloc((size_t)2 * cap
                                           * sizeof(int64_t));
        unsigned char *phase = (unsigned char *)malloc((size_t)2 * cap);
        if (!stack || !phase) { free(stack); free(phase); free(kid);
                                return -1; }
        stack[sp] = 0; phase[sp] = 0; sp++;
        while (sp > 0) {
            int64_t v = stack[--sp];
            unsigned char pr = phase[sp];
            if (!pr) {
                /* leaf iff the edge runs to the text end (the unique
                 * terminal makes every end==tlen edge childless) — no
                 * kid-matrix scan needed */
                int has_child = (v == 0) || end[v] < tlen;
                int c;
                if (v != 0)
                    depth[v] = depth[parent[v]] + (end[v] - start[v]);
                else
                    depth[v] = 0;
                if (!has_child) {
                    int64_t idx = tlen - depth[v];
                    leaf_idx[v] = idx;
                    lo[v] = nocc;
                    occ[nocc++] = idx;
                    hi[v] = nocc;
                    single_char[v] = idx > 0 ? text[idx - 1] : 0;
                } else {
                    leaf_idx[v] = -1;
                    stack[sp] = v; phase[sp] = 1; sp++;
                    lo[v] = nocc;
                    for (c = 0; c < K; c++) {
                        int64_t ch = KID(v, c);
                        if (ch != -1) {
                            stack[sp] = ch; phase[sp] = 0; sp++;
                        }
                    }
                }
            } else {
                int64_t val = -1;
                int c;
                hi[v] = nocc;
                for (c = 0; c < K; c++) {
                    int64_t ch = KID(v, c);
                    int64_t cv;
                    if (ch == -1) continue;
                    cv = single_char[ch];
                    if (cv == 0) { val = 0; break; }
                    if (val == -1) val = cv;
                    else if (val != cv) { val = 0; break; }
                }
                single_char[v] = val > 0 ? (unsigned char)val : 0;
            }
        }
        free(stack); free(phase);
        /* child flat arrays for vertex_scan */
        {
            int64_t pos = 0, v;
            int c;
            for (v = 0; v < nn; v++) {
                coff[v] = pos;
                if (v != 0 && end[v] >= tlen)
                    continue;   /* leaf: no children (see DFS) */
                for (c = 0; c < K; c++) {
                    int64_t ch = KID(v, c);
                    if (ch != -1) {
                        cchar[pos] = code_char[c];
                        cnode[pos] = ch;
                        pos++;
                    }
                }
            }
            coff[nn] = pos;
        }
    }
#undef KID
#undef NEW_NODE
    free(kid);
    return nn;
}

/* Build + augment.  text includes the trailing '\0' terminator; all
 * output arrays must have capacity 2*tlen+4 (occ: tlen).  Returns the
 * node count. */
int64_t st_build(const unsigned char *text, int64_t tlen,
                 int64_t *start, int64_t *end, int64_t *parent,
                 int64_t *slink, int64_t *depth, int64_t *leaf_idx,
                 int64_t *lo, int64_t *hi, int64_t *occ,
                 unsigned char *single_char,
                 int64_t *coff, unsigned char *cchar, int64_t *cnode) {
    int64_t cap = 2 * tlen + 4;
    stree_t st;
    int64_t i, active_node, active_edge, active_len, remainder;
    {
        int64_t dn = st_build_dense(text, tlen, start, end, parent, slink,
                                    depth, leaf_idx, lo, hi, occ,
                                    single_char, coff, cchar, cnode);
        if (dn != -2) return dn;   /* built (or hard failure) */
    }
    st.start = start; st.end = end; st.parent = parent; st.slink = slink;
    st.first_child = (int64_t *)malloc(cap * sizeof(int64_t));
    st.next_sib = (int64_t *)malloc(cap * sizeof(int64_t));
    st.last_child = (int64_t *)malloc(cap * sizeof(int64_t));
    st.first_char = (unsigned char *)malloc(cap);
    if (!st.first_child || !st.next_sib || !st.last_child
        || !st.first_char) {
        free(st.first_child); free(st.next_sib); free(st.last_child);
        free(st.first_char);
        return -1;
    }
    st.nn = 0;
    st_new_node(&st, 0, 0, -1);   /* root */

    active_node = 0; active_edge = 0; active_len = 0; remainder = 0;
    for (i = 0; i < tlen; i++) {
        unsigned char c = text[i];
        int64_t last_internal = -1;
        remainder++;
        while (remainder > 0) {
            unsigned char ae;
            int64_t child;
            if (active_len == 0) active_edge = i;
            ae = text[active_edge];
            child = st_get_child(&st, active_node, ae);
            if (child == -1) {
                int64_t leaf = st_new_node(&st, i, tlen, active_node);
                st_set_child(&st, active_node, ae, leaf);
                if (last_internal != -1) {
                    slink[last_internal] = active_node;
                    last_internal = -1;
                }
            } else {
                int64_t e = end[child] < i + 1 ? end[child] : i + 1;
                int64_t edge_len = e - start[child];
                if (active_len >= edge_len) {
                    active_node = child;
                    active_edge += edge_len;
                    active_len -= edge_len;
                    continue;
                }
                if (text[start[child] + active_len] == c) {
                    active_len++;
                    if (last_internal != -1) {
                        slink[last_internal] = active_node;
                        last_internal = -1;
                    }
                    break;
                }
                {
                    int64_t split = st_new_node(&st, start[child],
                                                start[child] + active_len,
                                                active_node);
                    int64_t leaf;
                    st_set_child(&st, active_node, ae, split);
                    start[child] += active_len;
                    parent[child] = split;
                    st_set_child(&st, split, text[start[child]], child);
                    leaf = st_new_node(&st, i, tlen, split);
                    st_set_child(&st, split, c, leaf);
                    if (last_internal != -1) slink[last_internal] = split;
                    last_internal = split;
                }
            }
            remainder--;
            if (active_node == 0 && active_len > 0) {
                active_len--;
                active_edge = i - remainder + 1;
            } else if (active_node != 0) {
                active_node = slink[active_node] != -1
                    ? slink[active_node] : 0;
            }
        }
    }
    for (i = 1; i < st.nn; i++)
        if (end[i] > tlen) end[i] = tlen;

    /* augmentation: iterative DFS matching gst.py::_augment, children
     * pushed in insertion order onto a stack (visited reversed) */
    {
        int64_t nn = st.nn, nocc = 0, sp = 0;
        int64_t *stack = (int64_t *)malloc(2 * cap * sizeof(int64_t));
        unsigned char *phase = (unsigned char *)malloc(2 * cap);
        if (!stack || !phase) {
            free(stack); free(phase);
            free(st.first_child); free(st.next_sib); free(st.last_child);
            free(st.first_char);
            return -1;
        }
        stack[sp] = 0; phase[sp] = 0; sp++;
        while (sp > 0) {
            int64_t v = stack[--sp];
            unsigned char pr = phase[sp];
            if (!pr) {
                if (v != 0)
                    depth[v] = depth[parent[v]] + (end[v] - start[v]);
                else
                    depth[v] = 0;
                if (st.first_child[v] == -1) {
                    int64_t idx = tlen - depth[v];
                    leaf_idx[v] = idx;
                    lo[v] = nocc;
                    occ[nocc++] = idx;
                    hi[v] = nocc;
                    single_char[v] = idx > 0 ? text[idx - 1] : 0;
                } else {
                    int64_t ch;
                    leaf_idx[v] = -1;
                    stack[sp] = v; phase[sp] = 1; sp++;
                    lo[v] = nocc;
                    for (ch = st.first_child[v]; ch != -1;
                         ch = st.next_sib[ch]) {
                        stack[sp] = ch; phase[sp] = 0; sp++;
                    }
                }
            } else {
                int64_t ch, val = -1;
                hi[v] = nocc;
                for (ch = st.first_child[v]; ch != -1;
                     ch = st.next_sib[ch]) {
                    int64_t cv = single_char[ch];
                    if (cv == 0) { val = 0; break; }
                    if (val == -1) val = cv;
                    else if (val != cv) { val = 0; break; }
                }
                single_char[v] = val > 0 ? (unsigned char)val : 0;
            }
        }
        free(stack); free(phase);
        /* child flat arrays for vertex_scan */
        {
            int64_t pos = 0, v, ch;
            for (v = 0; v < nn; v++) {
                coff[v] = pos;
                for (ch = st.first_child[v]; ch != -1; ch = st.next_sib[ch]) {
                    cchar[pos] = st.first_char[ch];
                    cnode[pos] = ch;
                    pos++;
                }
            }
            coff[nn] = pos;
        }
    }
    free(st.first_child); free(st.next_sib); free(st.last_child);
    free(st.first_char);
    return st.nn;
}

/* ---- MEG vertex scan --------------------------------------------------
 * Native port of the suffix-tree matching-statistics walk + pairing
 * emission (max-emb-graph.c:58-380; python mirror:
 * pintron_tpu/meg/graph.py:build_vertex_set +
 * pintron_tpu/index/gst.py:MaximalPairingScanner).  Tree arrays are
 * produced once per run by the Python SuffixTree. */

static double wr_stats[8];
void wr_get_stats(double *out8) { memcpy(out8, wr_stats, sizeof(wr_stats)); }
void wr_reset_stats(void) { memset(wr_stats, 0, sizeof(wr_stats)); }

typedef struct {
    const unsigned char *text; int64_t tlen;
    const int32_t *start, *end, *parent, *slink, *depth;
    const unsigned char *single_char;
    const int32_t *lo, *hi, *occ;
    const int32_t *coff; const unsigned char *cchar; const int32_t *cnode;
} tree_t;

/* Per-locus int32 shadow of the (int64 ABI) tree arrays: the scan is a
 * latency-bound random walk over ~2n nodes, so halving the element
 * width halves the cache-line footprint.  Single-slot cache keyed by
 * (text pointer, length) under the python keepalive contract (the tree
 * arrays are a pure function of the text bytes), like vs_prevk. */
static int32_t *vs_sh = NULL;
static int64_t vs_sh_cap = 0;
static const unsigned char *vs_sh_text = NULL;
static int64_t vs_sh_len = -1;

static int vs_shadow_get(const unsigned char *text, int64_t tlen,
                         const int64_t *start, const int64_t *end,
                         const int64_t *parent, const int64_t *slink,
                         const int64_t *depth, const int64_t *lo,
                         const int64_t *hi, const int64_t *occ,
                         const int64_t *coff, const int64_t *cnode,
                         tree_t *tr) {
    int64_t cap = 2 * tlen + 4;
    int64_t need = 9 * cap + 1 + tlen;
    int64_t nn = 0, i, nocc;
    int32_t *p;
    if (vs_sh_text != text || vs_sh_len != tlen) {
        if (need > vs_sh_cap) {
            int32_t *nb = (int32_t *)realloc(
                vs_sh, (size_t)need * sizeof(int32_t));
            if (!nb) return -1;
            vs_sh = nb;
            vs_sh_cap = need;
        }
        /* node count: walk coff (coff[nn] set, nodes contiguous) is not
         * available here; copy the full capacity bound instead — the
         * arrays are allocated to cap by the python side. */
        nn = cap;
        p = vs_sh;
        for (i = 0; i < nn; i++) p[i] = (int32_t)start[i];
        p += cap;
        for (i = 0; i < nn; i++) p[i] = (int32_t)end[i];
        p += cap;
        for (i = 0; i < nn; i++) p[i] = (int32_t)parent[i];
        p += cap;
        for (i = 0; i < nn; i++) p[i] = (int32_t)slink[i];
        p += cap;
        for (i = 0; i < nn; i++) p[i] = (int32_t)depth[i];
        p += cap;
        for (i = 0; i < nn; i++) p[i] = (int32_t)lo[i];
        p += cap;
        for (i = 0; i < nn; i++) p[i] = (int32_t)hi[i];
        p += cap;
        for (i = 0; i < cap + 1; i++) p[i] = (int32_t)coff[i];
        p += cap + 1;
        for (i = 0; i < nn; i++) p[i] = (int32_t)cnode[i];
        p += cap;
        nocc = tlen;
        for (i = 0; i < nocc; i++) p[i] = (int32_t)occ[i];
        vs_sh_text = text;
        vs_sh_len = tlen;
    }
    tr->start = vs_sh;
    tr->end = vs_sh + cap;
    tr->parent = vs_sh + 2 * cap;
    tr->slink = vs_sh + 3 * cap;
    tr->depth = vs_sh + 4 * cap;
    tr->lo = vs_sh + 5 * cap;
    tr->hi = vs_sh + 6 * cap;
    tr->coff = vs_sh + 7 * cap;
    tr->cnode = vs_sh + 8 * cap + 1;
    tr->occ = vs_sh + 9 * cap + 1;
    return 0;
}

static int64_t child_of(const tree_t *t, int64_t node, unsigned char c) {
    int64_t a = t->coff[node], b = t->coff[node + 1];
    for (; a < b; a++)
        if (t->cchar[a] == c) return t->cnode[a];
    return -1;
}

/* find_deepest_common_node_rec; returns dst node (or -1), *out_matched */
static int64_t vs_descend(const tree_t *t, const unsigned char *pat,
                          int64_t plen, int64_t node, int64_t rel,
                          int64_t already, unsigned char avoid,
                          int64_t *out_matched) {
    for (;;) {
        int64_t kid, el, lcp;
        if (rel >= plen) {
            if (node == 0) { *out_matched = 0; return -1; }
            *out_matched = t->end[node] - t->start[node];
            return node;
        }
        kid = child_of(t, node, pat[rel]);
        if (kid != -1 && t->single_char[kid] != 0
            && t->single_char[kid] == avoid)
            kid = -1;
        if (kid == -1) {
            if (node == 0) { *out_matched = 0; return -1; }
            *out_matched = t->end[node] - t->start[node];
            return node;
        }
        el = t->end[kid] - t->start[kid];
        if (el == 1) {
            lcp = 1;
        } else if (already > 0) {
            if (already >= el) lcp = el;
            else {
                int64_t i = t->start[kid] + already, j = rel + already;
                lcp = already;
                while (lcp < el && j < plen && t->text[i] == pat[j]) {
                    lcp++; i++; j++;
                }
            }
        } else {
            int64_t i = t->start[kid], j = rel;
            lcp = 0;
            while (lcp < el && j < plen && t->text[i] == pat[j]) {
                lcp++; i++; j++;
            }
        }
        if (rel + lcp >= plen || lcp < el) { *out_matched = lcp; return kid; }
        already = already > lcp ? already - lcp : 0;
        node = kid;
        rel += el;
    }
}

typedef struct { int64_t t, l; } pair_tl;

static int cmp_tl(const void *a, const void *b) {
    const pair_tl *x = (const pair_tl *)a, *y = (const pair_tl *)b;
    if (x->t != y->t) return x->t < y->t ? -1 : 1;
    if (x->l != y->l) return x->l < y->l ? -1 : 1;
    return 0;
}

/* Full per-EST vertex scan.  Emits (p, t, l) triples (post per-column
 * sort + in-column dedup) into out_*; returns the count, or -needed if
 * out_cap is too small, or -1 on allocation failure. */
/* per-locus prev-char class table: prevk[t] = alph_index256[text[t-1]]
 * (one load per occurrence instead of two dependent ones); single-slot
 * cache keyed by (text pointer, length) like the python-side keepalive
 * contract */
static unsigned char *vs_prevk = NULL;
static const unsigned char *vs_prevk_text = NULL;
static int64_t vs_prevk_len = -1;

static const unsigned char *vs_prevk_get(const unsigned char *text,
                                         int64_t tlen,
                                         const int64_t *alph_index256) {
    int64_t t;
    if (vs_prevk_text == text && vs_prevk_len == tlen) return vs_prevk;
    {
        unsigned char *nb = (unsigned char *)realloc(vs_prevk,
                                                     (size_t)tlen + 1);
        if (!nb) return NULL;
        vs_prevk = nb;
    }
    vs_prevk[0] = 255;   /* t == 0 has no previous char */
    for (t = 1; t < tlen; t++)
        vs_prevk[t] = (unsigned char)alph_index256[text[t - 1]];
    vs_prevk_text = text;
    vs_prevk_len = tlen;
    return vs_prevk;
}

int64_t vertex_scan(
    const unsigned char *text, int64_t tlen,
    const unsigned char *pattern, int64_t plen,
    const int64_t *start, const int64_t *end, const int64_t *parent,
    const int64_t *slink, const int64_t *depth,
    const unsigned char *single_char,
    const int64_t *lo, const int64_t *hi, const int64_t *occ,
    const int64_t *coff, const unsigned char *cchar, const int64_t *cnode,
    const int64_t *alph_index256, int64_t alph_size,
    double rate, int64_t min_len,
    int64_t *out_p, int64_t *out_t, int64_t *out_l, int64_t out_cap) {

    tree_t tr;
    int64_t prev_dst = -1, prev_matched = 0;
    unsigned char prev_symbol = 0;
    int64_t count = 0, needed = 0;
    int64_t col_cap = 1024;
    pair_tl *col = (pair_tl *)malloc(col_cap * sizeof(pair_tl));
    unsigned char *rm = (unsigned char *)malloc(col_cap);
    const unsigned char *prevk = vs_prevk_get(text, tlen, alph_index256);
    int64_t i;
    tr.text = text; tr.tlen = tlen;
    tr.single_char = single_char; tr.cchar = cchar;
    if (!col || !rm || !prevk
        || vs_shadow_get(text, tlen, start, end, parent, slink, depth,
                         lo, hi, occ, coff, cnode, &tr) != 0) {
        free(col); free(rm);
        return -1;
    }
    /* all node-indexed reads below go through the int32 shadow */
    {
        const int32_t *s_start = tr.start, *s_end = tr.end;
        const int32_t *s_parent = tr.parent, *s_slink = tr.slink;
        const int32_t *s_depth = tr.depth, *s_lo = tr.lo, *s_hi = tr.hi;
        const int32_t *s_occ = tr.occ;

    for (i = 0; i < plen; i++) {
        unsigned char avoid = prev_symbol;
        int64_t dst, matched, ncol = 0;
        /* scanner advance */
        if (prev_dst == -1 || s_slink[s_parent[prev_dst]] == -1) {
            dst = vs_descend(&tr, pattern, plen, 0, i, 0, avoid, &matched);
        } else {
            int64_t prev_len = s_end[prev_dst] - s_start[prev_dst];
            int64_t sl, m0;
            if (prev_len == prev_matched) { sl = s_slink[prev_dst]; m0 = 0; }
            else { sl = s_slink[s_parent[prev_dst]]; m0 = prev_matched; }
            dst = vs_descend(&tr, pattern, plen, sl, i + s_depth[sl], m0,
                             avoid, &matched);
        }
        if (dst == -1) { prev_dst = -1; prev_matched = 0; }
        else { prev_dst = dst; prev_matched = matched; }
        prev_symbol = i < plen ? pattern[i] : 0;
        if (dst == -1) continue;

        {
            int64_t d = s_depth[s_parent[dst]] + matched;
            double msd = d * rate;
            int64_t min_sd = (int64_t)(msd > (double)min_len
                                       ? msd : (double)min_len);
            int64_t symbol_k = alph_index256[avoid];
            int64_t node = dst, cur_l = d, block = -1;
            while (cur_l >= min_sd) {
                int64_t b_lo = block != -1 ? s_lo[block] : s_hi[node];
                int64_t b_hi = block != -1 ? s_hi[block] : s_hi[node];
                int64_t r, rngs[2][2];
                rngs[0][0] = s_lo[node]; rngs[0][1] = b_lo;
                rngs[1][0] = b_hi;       rngs[1][1] = s_hi[node];
                for (r = 0; r < 2; r++) {
                    int64_t j;
                    for (j = rngs[r][0]; j < rngs[r][1]; j++) {
                        int64_t t = s_occ[j];
                        int emit;
                        if (t > 0)
                            emit = prevk[t] != symbol_k;
                        else
                            emit = (symbol_k != 0 || alph_size > 1);
                        if (emit) {
                            if (ncol >= col_cap) {
                                pair_tl *ncolb;
                                unsigned char *nrm;
                                col_cap *= 2;
                                ncolb = (pair_tl *)realloc(
                                    col, col_cap * sizeof(pair_tl));
                                if (!ncolb) { free(col); free(rm); return -1; }
                                col = ncolb;
                                nrm = (unsigned char *)realloc(rm, col_cap);
                                if (!nrm) { free(col); free(rm); return -1; }
                                rm = nrm;
                            }
                            col[ncol].t = t;
                            col[ncol].l = cur_l;
                            ncol++;
                        }
                    }
                }
                block = node;
                node = s_parent[node];
                if (node <= 0) break;
                cur_l = s_depth[node];
            }
            /* sort by (t, l) then in-column dedup
             * (max-emb-graph.c:301-334) */
            qsort(col, ncol, sizeof(pair_tl), cmp_tl);
            memset(rm, 0, ncol);
            {
                int64_t jj, ii;
                for (jj = ncol - 1; jj >= 0; jj--) {
                    for (ii = jj - 1; ii >= 0; ii--) {
                        if ((col[jj].t > col[ii].t &&
                             col[jj].t + col[jj].l <= col[ii].t + col[ii].l)
                            || (col[jj].t == col[ii].t + 1 &&
                                col[jj].l == col[ii].l)) {
                            rm[jj] = 1;
                            break;
                        }
                    }
                }
                for (jj = 0; jj < ncol; jj++) {
                    if (rm[jj]) continue;
                    if (count < out_cap) {
                        out_p[count] = i;
                        out_t[count] = col[jj].t;
                        out_l[count] = col[jj].l;
                    }
                    count++;
                }
            }
        }
    }
    }  /* shadow scope */
    needed = count;
    free(col); free(rm);
    if (needed > out_cap) return -needed;
    return needed;
}

/* Longest common factor DP (factorization-refinement.c:253-316 semantics:
 * N wildcards always match; first strictly-greater maximum wins, with the
 * earliest i2 inside that row).  Writes occ1/occ2, returns plen. */
/* Byte-parallel LCF for short s2 (<= 63 chars): per-row int8 run
 * lengths, vectorizable; a strictly-greater row maximum triggers a
 * rescan of that row to recover the reference's tie-breaking (earliest
 * i2 achieving the row maximum).  Results are exactly lcf_dp's. */
static int64_t lcf_dp_small(const char *s1, int64_t l1, const char *s2,
                            int64_t l2, int64_t *occ1, int64_t *occ2) {
    /* fixed 64-lane layout (lanes >= l2 masked to zero) so the row
     * update and the max reduction are constant-trip and vectorize;
     * slot 0 of each row is the virtual R[-1] = 0 */
    uint8_t msk[256][64];
    uint8_t built[256];
    uint8_t rowa[65], rowb[65];
    uint8_t *R = rowa, *Rp = rowb;
    int64_t i1, i2, plen = 0;
    int64_t k;
    memset(built, 0, sizeof(built));
    memset(rowa, 0, sizeof(rowa));
    memset(rowb, 0, sizeof(rowb));
#if defined(__AVX2__)
    /* Register-resident row with an in-register one-lane shift: lane j
     * holds R[j+1], so new = (shl1(old) + 1) & mask[0..63] — no
     * store/reload of the row per char (the memory round trip stalls
     * on the 1-byte-shifted store-forward), and only the (rare) rows
     * that beat the current best fall to the exact scalar update, so
     * results are identical to the scalar loop. */
    {
        __m256i r0 = _mm256_setzero_si256();
        __m256i r1 = _mm256_setzero_si256();
        __m256i one = _mm256_set1_epi8(1);
        __m256i th = _mm256_set1_epi8((char)plen);
        for (i1 = 0; i1 < l1; i1++) {
            unsigned char c1 = (unsigned char)s1[i1];
            const uint8_t *mk;
            __m256i m0, m1, c0v, c1v, n0, n1;
            if (!built[c1]) {
                int w1 = (c1 == 'n' || c1 == 'N');
                for (i2 = 0; i2 < l2; i2++) {
                    char c2 = s2[i2];
                    msk[c1][i2] = (uint8_t)(0
                        - (w1 || c2 == 'n' || c2 == 'N'
                           || (unsigned char)c2 == c1));
                }
                for (i2 = l2; i2 < 64; i2++) msk[c1][i2] = 0;
                built[c1] = 1;
            }
            mk = msk[c1];
            m0 = _mm256_loadu_si256((const __m256i *)(mk + 0));
            m1 = _mm256_loadu_si256((const __m256i *)(mk + 32));
            /* shl1 across the 256-bit pair: lane 0 <- 0, r1 carries
             * in r0's top byte */
            c0v = _mm256_permute2x128_si256(r0, r0, 0x08);
            c1v = _mm256_permute2x128_si256(r0, r1, 0x21);
            n0 = _mm256_alignr_epi8(r0, c0v, 15);
            n1 = _mm256_alignr_epi8(r1, c1v, 15);
            r0 = _mm256_and_si256(_mm256_add_epi8(n0, one), m0);
            r1 = _mm256_and_si256(_mm256_add_epi8(n1, one), m1);
            if (_mm256_movemask_epi8(_mm256_cmpgt_epi8(r0, th))
                | _mm256_movemask_epi8(_mm256_cmpgt_epi8(r1, th))) {
                uint8_t tmp[65];
                uint8_t best = 0;
                tmp[0] = 0;
                _mm256_storeu_si256((__m256i *)(tmp + 1), r0);
                _mm256_storeu_si256((__m256i *)(tmp + 33), r1);
                for (k = 1; k <= 64; k++)
                    if (tmp[k] > best) best = tmp[k];
                if ((int64_t)best > plen) {
                    plen = best;
                    *occ1 = i1 + 1 - plen;
                    for (k = 1; k <= 64; k++)
                        if (tmp[k] == best) break;
                    *occ2 = k - plen;
                    th = _mm256_set1_epi8((char)plen);
                }
            }
        }
        (void)R; (void)Rp;
        return plen;
    }
#else
    for (i1 = 0; i1 < l1; i1++) {
        unsigned char c1 = (unsigned char)s1[i1];
        const uint8_t *mk;
        uint8_t best = 0;
        if (!built[c1]) {
            int w1 = (c1 == 'n' || c1 == 'N');
            for (i2 = 0; i2 < l2; i2++) {
                char c2 = s2[i2];
                msk[c1][i2] = (uint8_t)(0
                    - (w1 || c2 == 'n' || c2 == 'N'
                       || (unsigned char)c2 == c1));
            }
            for (i2 = l2; i2 < 64; i2++) msk[c1][i2] = 0;
            built[c1] = 1;
        }
        mk = msk[c1];
        for (k = 0; k < 64; k++)
            R[k + 1] = (uint8_t)((Rp[k] + 1) & mk[k]);
        for (k = 1; k <= 64; k++)
            if (R[k] > best) best = R[k];
        if ((int64_t)best > plen) {
            plen = best;
            *occ1 = i1 + 1 - plen;
            for (k = 1; k <= 64; k++)
                if (R[k] == best) break;
            *occ2 = k - plen;
        }
        { uint8_t *t = R; R = Rp; Rp = t; }
    }
    return plen;
#endif
}

int64_t lcf_dp(const char *s1, int64_t l1, const char *s2, int64_t l2,
               int64_t *occ1, int64_t *occ2) {
    int64_t *prev, *cur, *tmp;
    int64_t i1, i2, plen = 0;
    *occ1 = 0; *occ2 = 0;
    if (l1 == 0 || l2 == 0) return 0;
    if (l2 <= 63) return lcf_dp_small(s1, l1, s2, l2, occ1, occ2);
    prev = (int64_t *)calloc(l2, sizeof(int64_t));
    cur = (int64_t *)calloc(l2, sizeof(int64_t));
    if (!prev || !cur) { free(prev); free(cur); return -1; }
    for (i1 = 0; i1 < l1; i1++) {
        char c1 = s1[i1];
        int w1 = (c1 == 'n' || c1 == 'N');
        int64_t row_max = 0, row_arg = 0;
        for (i2 = 0; i2 < l2; i2++) {
            char c2 = s2[i2];
            int match = (c1 == c2) || w1 || c2 == 'n' || c2 == 'N';
            int64_t v = match ? ((i2 > 0 ? prev[i2 - 1] : 0) + 1) : 0;
            cur[i2] = v;
            if (v > row_max) { row_max = v; row_arg = i2; }
        }
        if (row_max > plen) {
            plen = row_max;
            *occ1 = i1 + 1 - plen;
            /* earliest i2 achieving the row maximum */
            for (i2 = 0; i2 < l2; i2++)
                if (cur[i2] == row_max) { row_arg = i2; break; }
            *occ2 = row_arg + 1 - plen;
        }
        tmp = prev; prev = cur; cur = tmp;
    }
    free(prev); free(cur);
    return plen;
}

/* MatInspector BPS sliding search (classify-intron.c:575-663 semantics).
 * pwm: 4 rows x L columns of weighted frequencies; cv: L consensus
 * weights; den = sum(cv*max).  Windows of 12 chars starting at
 * start_w..end_w (chars past the sequence end read as index 3, matching
 * the host fallback).  Later positions win ties (sb >= score).
 * Returns best position, stores score. */
int64_t bps_search(const char *seq, int64_t len, const double *pwm,
                   int64_t L, const double *cv, double den,
                   int64_t start_w, int64_t end_w, double *out_score) {
    static int base_idx[256];
    static int init_done = 0;
    int64_t i, j;
    double score = 0.0;
    int64_t best = -1;
    int first = 1;
    if (!init_done) {
        for (i = 0; i < 256; i++) base_idx[i] = 3;
        base_idx['A'] = base_idx['a'] = 0;
        base_idx['C'] = base_idx['c'] = 1;
        base_idx['G'] = base_idx['g'] = 2;
        base_idx['T'] = base_idx['t'] = 3;
        base_idx['N'] = base_idx['n'] = 0;
        init_done = 1;
    }
    for (i = start_w; i <= end_w; i++) {
        double num = 0.0;
        for (j = 0; j < L; j++) {
            int idx;
            if (i + j < len) idx = base_idx[(unsigned char)seq[i + j]];
            else idx = 3;   /* '\0' beyond the window -> fallback row */
            num += pwm[idx * L + j];
        }
        {
            double sb = num / den;
            if (first || sb >= score) { score = sb; best = i; first = 0; }
        }
    }
    *out_score = score;
    return best;
}

/* 3-matrix gap alignment fill (refine-intron.c:623-806 semantics; see
 * pintron_tpu/factorize/gap_align.py for the direction-update chains).
 * Fills the three (n+1)x(m+1) int8 direction matrices and the final
 * L/G/R values at (n, m).  Single fused row pass: G[i][*] depends only
 * on L's current row, R[i][j] on G[i][j-1] and R's previous/current
 * rows, so no full value matrices are materialized. */
static int32_t *ga_buf = NULL;
static int64_t ga_buf_cap = 0;

/* Packed-direction fill: one byte per cell holding all three matrices'
 * direction codes —
 *   bits 0-1: L dir (0 diag, 1 up, 2 left)
 *   bit  2  : G dir (1 keep-G, 0 take-L == the classic -2)
 *   bits 3-4: R dir (0 diag, 1 up, 2 left, 3 == the classic -2 jump)
 * One fused write loop per row replaces the three separate direction
 * matrices (3x less store traffic — the dominant cost at these window
 * sizes).  Values and decoded directions are identical to the classic
 * per-cell loop; the exported 3-matrix gap_align_fill below expands the
 * packed bytes for its (test/fallback) callers. */
/* int16 core (exact for n+m < I16_LIMIT — see the int16 kernels above) */
static void gap_align_fill_packed16(const char *est, int64_t n,
                                    const char *gen, int64_t m,
                                    int8_t *comb, int64_t *finals) {
    int64_t need = 3 * (m + 2);   /* in int32 units; rows are int16 */
    int16_t *Lprev, *Lcur, *Rprev, *Rcur, *Gcur, *ms, *tmp;
    int64_t i, j;
    if (need > ga_buf_cap) {
        int32_t *nd = (int32_t *)realloc(
            ga_buf, (size_t)(2 * need + 64) * sizeof(int32_t));
        if (!nd) { finals[0] = finals[1] = finals[2] = -(1LL << 40); return; }
        ga_buf = nd;
        ga_buf_cap = 2 * need + 64;
    }
    Lprev = (int16_t *)ga_buf;
    Lcur = Lprev + (m + 1);
    Rprev = Lcur + (m + 1);
    Rcur = Rprev + (m + 1);
    Gcur = Rcur + (m + 1);
    ms = Gcur + (m + 1);
    for (j = 0; j <= m; j++) { Lprev[j] = 0; Rprev[j] = 0; Gcur[j] = 0; }
    finals[0] = 0; finals[1] = 0; finals[2] = 0;
    for (i = 1; i <= n; i++) {
        char e = est[i - 1];
        int ew = (e == 'n' || e == 'N');
        int16_t cost = (i == n) ? 0 : 1;
        int8_t *crow = comb + i * (m + 1);
        if (ew) {
            for (j = 1; j <= m; j++) ms[j] = 1;
        } else {
            for (j = 1; j <= m; j++) {
                char g = gen[j - 1];
                ms[j] = ((g == e) | (g == 'n') | (g == 'N')) ? 1 : -1;
            }
        }
        Lcur[0] = 0;
        for (j = 1; j <= m; j++) {
            int16_t a = (int16_t)(Lprev[j - 1] + ms[j]);
            int16_t b = (int16_t)(Lprev[j] - 1);
            Lcur[j] = a > b ? a : b;
        }
        relax_max16_slope1(Lcur, m);
        g_scan_max16(Lcur, Gcur, m);
        Rcur[0] = 0;
        for (j = 1; j <= m; j++) {
            int16_t a = (int16_t)(Rprev[j - 1] + ms[j]);
            int16_t b = (int16_t)(Rprev[j] - 1);
            int16_t c = Gcur[j - 1];
            if (b > a) a = b;
            Rcur[j] = c > a ? c : a;
        }
        if (cost) {
            relax_max16_slope1(Rcur, m);
        } else {
            for (j = 1; j <= m; j++)
                if (Rcur[j - 1] > Rcur[j]) Rcur[j] = Rcur[j - 1];
        }
        for (j = 1; j <= m; j++) {
            int16_t lv = Lcur[j];
            int16_t rv = Rcur[j];
            int16_t diag = (int16_t)(Lprev[j - 1] + ms[j]);
            int16_t rdiag = (int16_t)(Rprev[j - 1] + ms[j]);
            int ld = lv == diag ? 0
                : (lv == (int16_t)(Lprev[j] - 1) ? 1 : 2);
            int gd = Gcur[j - 1] < Lcur[j - 1] ? 0 : 1;
            int rd = rv == rdiag ? 0
                : (rv == (int16_t)(Rcur[j - 1] - cost) ? 2
                   : (rv == Gcur[j - 1] ? 3 : 1));
            crow[j] = (int8_t)(ld | (gd << 2) | (rd << 3));
        }
        tmp = Lprev; Lprev = Lcur; Lcur = tmp;
        tmp = Rprev; Rprev = Rcur; Rcur = tmp;
    }
    finals[0] = Lprev[m];
    finals[1] = Gcur[m];
    finals[2] = Rprev[m];
}

static void gap_align_fill_packed32(const char *est, int64_t n,
                                    const char *gen, int64_t m,
                                    int8_t *comb, int64_t *finals) {
    int64_t need = 6 * (m + 2);
    int32_t *Lprev, *Lcur, *Rprev, *Rcur, *Gcur, *ms, *tmp;
    int64_t i, j;
    if (need > ga_buf_cap) {
        int32_t *nd = (int32_t *)realloc(
            ga_buf, (size_t)(2 * need + 64) * sizeof(int32_t));
        if (!nd) { finals[0] = finals[1] = finals[2] = -(1LL << 40); return; }
        ga_buf = nd;
        ga_buf_cap = 2 * need + 64;
    }
    Lprev = ga_buf;
    Lcur = Lprev + (m + 1);
    Rprev = Lcur + (m + 1);
    Rcur = Rprev + (m + 1);
    Gcur = Rcur + (m + 1);
    ms = Gcur + (m + 1);
    for (j = 0; j <= m; j++) { Lprev[j] = 0; Rprev[j] = 0; Gcur[j] = 0; }
    finals[0] = 0; finals[1] = 0; finals[2] = 0;
    for (i = 1; i <= n; i++) {
        char e = est[i - 1];
        int ew = (e == 'n' || e == 'N');
        int32_t cost = (i == n) ? 0 : 1;
        int8_t *crow = comb + i * (m + 1);
        if (ew) {
            for (j = 1; j <= m; j++) ms[j] = 1;
        } else {
            for (j = 1; j <= m; j++) {
                char g = gen[j - 1];
                ms[j] = ((g == e) | (g == 'n') | (g == 'N')) ? 1 : -1;
            }
        }
        /* L matrix */
        Lcur[0] = 0;
        for (j = 1; j <= m; j++) {
            int32_t a = Lprev[j - 1] + ms[j];
            int32_t b = Lprev[j] - 1;
            Lcur[j] = a > b ? a : b;
        }
        relax_max_slope1(Lcur, m);
        /* G matrix: G[i][j] = max(G[i][j-1], L[i][j-1]); Gcur[0] stays
         * 0 every row; keep-G wins ties */
        g_scan_max(Lcur, Gcur, m);
        /* R matrix */
        Rcur[0] = 0;
        for (j = 1; j <= m; j++) {
            int32_t a = Rprev[j - 1] + ms[j];
            int32_t b = Rprev[j] - 1;
            int32_t c = Gcur[j - 1];
            if (b > a) a = b;
            Rcur[j] = c > a ? c : a;
        }
        if (cost) {
            relax_max_slope1(Rcur, m);
        } else {
            /* last row: plain running max */
            for (j = 1; j <= m; j++)
                if (Rcur[j - 1] > Rcur[j]) Rcur[j] = Rcur[j - 1];
        }
        /* fused direction bytes, all three matrices in one pass (the
         * original strict-improvement tie orders: L diag > up > left;
         * G keep > take-L; R diag > i_del > grow > up) */
        for (j = 1; j <= m; j++) {
            int32_t lv = Lcur[j];
            int32_t rv = Rcur[j];
            int32_t diag = Lprev[j - 1] + ms[j];
            int32_t rdiag = Rprev[j - 1] + ms[j];
            int ld = lv == diag ? 0 : (lv == Lprev[j] - 1 ? 1 : 2);
            int gd = Gcur[j - 1] < Lcur[j - 1] ? 0 : 1;
            int rd = rv == rdiag ? 0
                : (rv == Rcur[j - 1] - cost ? 2
                   : (rv == Gcur[j - 1] ? 3 : 1));
            crow[j] = (int8_t)(ld | (gd << 2) | (rd << 3));
        }
        tmp = Lprev; Lprev = Lcur; Lcur = tmp;
        tmp = Rprev; Rprev = Rcur; Rcur = tmp;
    }
    finals[0] = Lprev[m];
    finals[1] = Gcur[m];
    finals[2] = Rprev[m];
}

static void gap_align_fill_packed(const char *est, int64_t n,
                                  const char *gen, int64_t m,
                                  int8_t *comb, int64_t *finals) {
    dp_census[3] += 3 * (n + 1) * (m + 1);
    if (n + m < I16_LIMIT)
        gap_align_fill_packed16(est, n, gen, m, comb, finals);
    else
        gap_align_fill_packed32(est, n, gen, m, comb, finals);
}

void gap_align_fill(const char *est, int64_t n, const char *gen, int64_t m,
                    int8_t *Ldir, int8_t *Gdir, int8_t *Rdir,
                    int64_t *finals) {
    /* ABI-preserving expansion of the packed fill (python mirror and
     * unit tests consume the classic three int8 matrices). */
    int64_t stride = m + 1;
    int64_t msize = (n + 1) * stride;
    static int8_t *cb = NULL;
    static int64_t cb_cap = 0;
    int64_t i, j;
    if (msize > cb_cap) {
        int8_t *nb = (int8_t *)realloc(cb, (size_t)(2 * msize + 64));
        if (!nb) { finals[0] = finals[1] = finals[2] = -(1LL << 40); return; }
        cb = nb;
        cb_cap = 2 * msize + 64;
    }
    gap_align_fill_packed(est, n, gen, m, cb, finals);
    if (finals[0] == -(1LL << 40)) return;
    for (i = 1; i <= n; i++) {
        const int8_t *crow = cb + i * stride;
        int8_t *Lrow = Ldir + i * stride;
        int8_t *Grow = Gdir + i * stride;
        int8_t *Rrow = Rdir + i * stride;
        for (j = 1; j <= m; j++) {
            int c = crow[j];
            int rd = (c >> 3) & 3;
            Lrow[j] = (int8_t)(c & 3);
            Grow[j] = (c & 4) ? 2 : -2;
            Rrow[j] = rd == 3 ? -2 : (int8_t)rd;
        }
    }
}

/* Edit distance matrix (refine.c:50-83): rows over s2, int64 row-major
 * (l2+1)x(l1+1) output. */
void edit_matrix(const char *s1, int64_t l1, const char *s2, int64_t l2,
                 int64_t *M) {
    dp_census[1] += (l1 + 1) * (l2 + 1);
    int64_t i, j;
    for (j = 0; j <= l1; j++) M[j] = j;
    for (i = 1; i <= l2; i++) {
        int64_t *row = M + i * (l1 + 1);
        int64_t *prev = M + (i - 1) * (l1 + 1);
        row[0] = i;
        for (j = 1; j <= l1; j++) {
            row[j] = min3(prev[j - 1] + (s1[j - 1] != s2[i - 1]),
                          prev[j] + 1, row[j - 1] + 1);
        }
    }
}

/* DUST dinucleotide complexity score (exon-complexity.c:38-131 semantics;
 * python mirror pintron_tpu/factorize/dust.py). */
double dust_score_c(const char *seq, int64_t len) {
    static int nt_idx[256];
    static int nt_init = 0;
    int64_t freq[17];
    int64_t running = 0, i;
    if (!nt_init) {
        for (i = 0; i < 256; i++) nt_idx[i] = -1;
        nt_idx['A'] = nt_idx['a'] = 0;
        nt_idx['C'] = nt_idx['c'] = 1;
        nt_idx['G'] = nt_idx['g'] = 2;
        nt_idx['T'] = nt_idx['t'] = 3;
        nt_init = 1;
    }
    if (len <= 2) return 0.0;
    for (i = 0; i < 17; i++) freq[i] = 0;
    for (i = 0; i < len - 1; i++) {
        int a = nt_idx[(unsigned char)seq[i]];
        int b = nt_idx[(unsigned char)seq[i + 1]];
        int idx = (a < 0 || b < 0) ? 16 : a * 4 + b;
        running += freq[idx];
        freq[idx]++;
    }
    return (10.0 * (double)running / (double)(len - 2)) / (double)len;
}

/* Burset dinucleotide pair frequency (refine-intron.c:376-556; python
 * mirror pintron_tpu/factorize/burset.py). */
static int burset_tab[16][16];
static int burset_init_done = 0;

static int b_idx(char c) {
    switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return -1;
    }
}

static void burset_init(void) {
    static const struct { const char *d, *a; int f; } entries[] = {
        {"AA","AG",1},{"AA","AT",1},{"AA","GT",1},
        {"AC","CC",1},
        {"AG","AC",1},{"AG","AG",5},{"AG","CT",2},{"AG","GC",1},
        {"AG","TG",2},
        {"AT","AA",1},{"AT","AC",8},{"AT","AG",7},{"AT","AT",2},
        {"AT","GC",1},{"AT","GT",1},
        {"CA","AG",1},{"CA","TT",1},
        {"CC","AG",2},
        {"CG","AG",1},{"CG","CA",1},
        {"CT","AC",2},{"CT","CA",1},
        {"GA","AG",8},{"GA","GT",1},{"GA","TC",1},{"GA","TG",1},
        {"GC","AG",126},{"GC","GG",1},{"GC","TA",1},
        {"GG","AC",1},{"GG","AG",11},{"GG","CA",1},{"GG","GA",2},
        {"GG","TC",2},
        {"GT","AG",200},{"GT","AC",4},{"GT","AT",2},{"GT","CA",9},
        {"GT","CG",4},{"GT","CT",3},{"GT","GC",1},{"GT","GG",10},
        {"GT","GT",1},{"GT","TA",7},{"GT","TC",2},{"GT","TG",8},
        {"GT","TT",2},
        {"TA","AG",6},{"TA","CG",1},{"TA","TC",1},
        {"TC","AG",1},{"TC","GG",1},
        {"TG","AC",1},{"TG","AG",7},{"TG","GG",2},
        {"TT","AG",5},{"TT","AT",1},{"TT","GG",1},
    };
    size_t i;
    memset(burset_tab, 0, sizeof(burset_tab));
    for (i = 0; i < sizeof(entries) / sizeof(entries[0]); i++) {
        int d = b_idx(entries[i].d[0]) * 4 + b_idx(entries[i].d[1]);
        int a = b_idx(entries[i].a[0]) * 4 + b_idx(entries[i].a[1]);
        burset_tab[d][a] = entries[i].f;
    }
    burset_init_done = 1;
}

static int burset_pair(char d0, char d1, char a0, char a1) {
    int i0 = b_idx(d0), i1 = b_idx(d1), j0 = b_idx(a0), j1 = b_idx(a1);
    if (!burset_init_done) burset_init();
    if (i0 < 0 || i1 < 0 || j0 < 0 || j1 < 0) return 0;
    return burset_tab[i0 * 4 + i1][j0 * 4 + j1];
}

/* adaptor: donor = t[cut1:cut1+2], acceptor = t[cut2-2:cut2] with the
 * python mirror's clamped-slice semantics (burset.py:39-49) */
static int burset_adaptor(const char *t, int64_t lt, int64_t cut1,
                          int64_t cut2) {
    if (cut2 < 2 || cut1 < 0) return 0;
    if (cut1 + 2 > lt || cut2 > lt) return 0;
    return burset_pair(t[cut1], t[cut1 + 1], t[cut2 - 2], t[cut2 - 1]);
}

/* Border refinement DP (refine.c:105-192; python mirror
 * pintron_tpu/factorize/refine.py).  out6 = {ok, off_p, off_t1,
 * lt - off_t2, best_edit, best_burset}. */
/* Cut selection over the per-row minima of the forward/reversed edit
 * DPs (the tail of refine_borders, refine.c:105-192): min total errors,
 * ties by Burset frequency of the induced intron.  Shared by the
 * host-DP path (refine_borders_core) and the device-offload fill
 * (epm_fill_rb), so both produce bit-identical out6. */
static void rb_select(int64_t lp, int64_t min_cut, int64_t max_cut,
                      const char *t, int64_t lt, int64_t max_errs,
                      const int64_t *min_pp, const int64_t *pos_pp,
                      const int64_t *min_sp, const int64_t *pos_sp,
                      int64_t *out6) {
    int64_t off_p = min_cut;
    int64_t off_t1 = pos_pp[min_cut];
    int64_t off_t2 = pos_sp[lp - min_cut];
    int64_t best = min_pp[min_cut] + min_sp[lp - min_cut];
    int64_t best_burset = burset_adaptor(t, lt, off_t1, lt - off_t2);
    int64_t i;
    for (i = min_cut + 1; i <= max_cut; i++) {
        int64_t curr = min_pp[i] + min_sp[lp - i];
        int64_t curr_burset = burset_adaptor(t, lt, pos_pp[i],
                                             lt - pos_sp[lp - i]);
        if (best > curr || (best == curr && curr_burset > best_burset)) {
            best = curr;
            off_p = i;
            off_t1 = pos_pp[i];
            off_t2 = pos_sp[lp - i];
            best_burset = curr_burset;
        }
    }
    out6[0] = best <= max_errs ? 1 : 0;
    out6[1] = off_p;
    out6[2] = off_t1;
    out6[3] = lt - off_t2;
    out6[4] = best;
    out6[5] = best_burset;
}

void refine_borders_core(const char *p, int64_t lp, int64_t min_cut,
                         int64_t max_cut, const char *t, int64_t lt,
                         int64_t max_errs, int64_t *out6) {
    int64_t tw = lp + max_errs < lt ? lp + max_errs : lt;
    dp_census[4] += 2 * (lp + 1) * (tw + 1);
    /* row minima (value, first position) of the (lp+1) x (tw+1) edit
     * matrix with rows over p prefixes, for the forward and reversed
     * strings.  Rows are int32 in the same pass form as nw_align
     * (vectorizable diag/up minimum, then the SIMD prefix-scan left
     * relaxation, then a min reduction + earliest-position scan). */
    int64_t *min_pp = (int64_t *)malloc((lp + 1) * sizeof(int64_t));
    int64_t *pos_pp = (int64_t *)malloc((lp + 1) * sizeof(int64_t));
    int64_t *min_sp = (int64_t *)malloc((lp + 1) * sizeof(int64_t));
    int64_t *pos_sp = (int64_t *)malloc((lp + 1) * sizeof(int64_t));
    int32_t *prev = (int32_t *)malloc((tw + 2) * sizeof(int32_t));
    int32_t *cur = (int32_t *)malloc((tw + 2) * sizeof(int32_t));
    char *tb = (char *)malloc((size_t)tw + 2);
    int64_t i, j, pass;
    int64_t off_p, off_t1, off_t2, best, best_burset;
    if (!min_pp || !pos_pp || !min_sp || !pos_sp || !prev || !cur
        || !tb) {
        out6[0] = -1;
        goto done;
    }
    for (pass = 0; pass < 2; pass++) {
        int64_t *mn = pass ? min_sp : min_pp;
        int64_t *ps = pass ? pos_sp : pos_pp;
        /* contiguous window text; reversed pass: rt = reverse(t),
         * window rt[:tw] reads t[lt-1], t[lt-2], ..., t[lt-tw] */
        for (j = 1; j <= tw; j++) tb[j] = pass ? t[lt - j] : t[j - 1];
        mn[0] = 0; ps[0] = 0;
        if (lp + tw < I16_LIMIT) {
            /* int16 rows (values bounded by lp + tw): twice the SIMD
             * lanes, identical results */
            int16_t *prev16 = (int16_t *)prev;
            int16_t *cur16 = (int16_t *)cur;
            int16_t *tmp16;
            for (j = 0; j <= tw; j++) prev16[j] = (int16_t)j;
            for (i = 1; i <= lp; i++) {
                char pc = pass ? p[lp - i] : p[i - 1];
                int16_t rmin;
                int64_t rpos;
                cur16[0] = (int16_t)i;
                for (j = 1; j <= tw; j++) {
                    int16_t a = (int16_t)(prev16[j - 1]
                                          + (tb[j] != pc));
                    int16_t b = (int16_t)(prev16[j] + 1);
                    cur16[j] = a < b ? a : b;
                }
                relax_min16_slope1(cur16, tw);
                rmin = cur16[0];
                for (j = 1; j <= tw; j++)
                    if (cur16[j] < rmin) rmin = cur16[j];
                rpos = 0;
                while (cur16[rpos] != rmin) rpos++;
                mn[i] = rmin; ps[i] = rpos;
                tmp16 = prev16; prev16 = cur16; cur16 = tmp16;
            }
        } else {
        int32_t *tmp;
        for (j = 0; j <= tw; j++) prev[j] = (int32_t)j;
        for (i = 1; i <= lp; i++) {
            char pc = pass ? p[lp - i] : p[i - 1];
            int32_t rmin;
            int64_t rpos;
            cur[0] = (int32_t)i;
            for (j = 1; j <= tw; j++) {
                int32_t a = prev[j - 1] + (tb[j] != pc);
                int32_t b = prev[j] + 1;
                cur[j] = a < b ? a : b;
            }
            relax_min_slope1(cur, tw);
            rmin = cur[0];
            for (j = 1; j <= tw; j++)
                if (cur[j] < rmin) rmin = cur[j];
            rpos = 0;
            while (cur[rpos] != rmin) rpos++;
            mn[i] = rmin; ps[i] = rpos;
            tmp = prev; prev = cur; cur = tmp;
        }
        }
    }
    rb_select(lp, min_cut, max_cut, t, lt, max_errs,
              min_pp, pos_pp, min_sp, pos_sp, out6);
    (void)off_p; (void)off_t1; (void)off_t2;
    (void)best; (void)best_burset; (void)i;
done:
    free(min_pp); free(pos_pp); free(min_sp); free(pos_sp);
    free(prev); free(cur); free(tb);
}

/* Full gap alignment: fill + traceback in one call (python mirror
 * pintron_tpu/factorize/gap_align.py).  est_al/gen_al must have capacity
 * n + m.  out7 = {align_len, factor_cut, intron_start, intron_end,
 * intron_start_on_align, intron_end_on_align, start_matrix}. */
static int8_t *dir_scratch = NULL;
static int64_t dir_scratch_cap = 0;

/* grow-once per-process int8 scratch shared by the tracebacks */
static int8_t *dir_scratch_get(int64_t need) {
    if (need > dir_scratch_cap) {
        int8_t *nd = (int8_t *)realloc(dir_scratch, 2 * need + 64);
        if (!nd) return NULL;
        dir_scratch = nd;
        dir_scratch_cap = 2 * need + 64;
    }
    return dir_scratch;
}

void gap_align_run(const char *est, int64_t n, const char *gen, int64_t m,
                   char *est_al, char *gen_al, int64_t *out7) {
    int64_t stride = m + 1;
    int64_t msize = (n + 1) * stride;
    int8_t *comb = dir_scratch_get(msize);
    int64_t finals[3];
    int64_t i, j, sm, cap = n + m, w;
    int64_t jump_w[2]; int64_t njump = 0;
    int64_t factor_cut = 0, intron_start = 0, intron_end = 0;
    int64_t is_al = 0, ie_al = 0, total, start_matrix;
    if (!comb) { out7[0] = -1; return; }
    gap_align_fill_packed(est, n, gen, m, comb, finals);
    if (finals[0] == -(1LL << 40)) { out7[0] = -1; return; }

    if (finals[2] >= finals[1])
        start_matrix = finals[2] >= finals[0] ? 2 : 0;
    else
        start_matrix = finals[1] >= finals[0] ? 1 : 0;

    i = n; j = m; sm = start_matrix; w = cap;
    while (i > 0 && j > 0) {
        int8_t d;
        int c = comb[i * stride + j];
        if (sm == 2) { int rd = (c >> 3) & 3; d = rd == 3 ? -2 : (int8_t)rd; }
        else if (sm == 1) d = (c & 4) ? 2 : -2;
        else d = (int8_t)(c & 3);
        w--;
        if (d == 0) {
            est_al[w] = est[i - 1]; gen_al[w] = gen[j - 1];
            i--; j--;
        } else if (d == 1) {
            est_al[w] = est[i - 1]; gen_al[w] = '-';
            i--;
        } else {
            if (d == -2) {
                if (sm == 2) { intron_end = j - 1; factor_cut = i; }
                else intron_start = j - 1;
                sm--;
                if (njump < 2) jump_w[njump++] = w;
            }
            est_al[w] = '-'; gen_al[w] = gen[j - 1];
            j--;
        }
    }
    while (i > 0) { w--; est_al[w] = est[i - 1]; gen_al[w] = '-'; i--; }
    while (j > 0) { w--; est_al[w] = '-'; gen_al[w] = gen[j - 1]; j--; }
    total = cap - w;
    if (w > 0) {
        memmove(est_al, est_al + w, total);
        memmove(gen_al, gen_al + w, total);
    }
    /* forward emission index of a jump = its buffer index - w */
    if (start_matrix == 2) {
        if (njump >= 1) ie_al = jump_w[0] - w;
        if (njump >= 2) is_al = jump_w[1] - w;
    } else if (start_matrix == 1) {
        if (njump >= 1) is_al = jump_w[0] - w;
    }
    out7[0] = total;
    out7[1] = factor_cut;
    out7[2] = intron_start;
    out7[3] = intron_end;
    out7[4] = is_al;
    out7[5] = ie_al;
    out7[6] = start_matrix;
}

/* Full NW alignment: fill + traceback (python mirror
 * pintron_tpu/factorize/alignments.py:compute_alignment).  est_al/gen_al
 * capacity n + m; returns the score; *out_len = alignment length. */
int64_t nw_align_run(const char *est, int64_t n, const char *gen, int64_t m,
                     char *est_al, char *gen_al, int64_t *out_len) {
    int64_t stride = m + 1;
    int8_t *dirs;
    int64_t score, i, j, cap = n + m, w;
    if (n == m && memcmp(est, gen, (size_t)n) == 0) {
        /* byte-equal inputs: the all-diagonal alignment is the unique
         * zero-cost optimum (any indel costs +1), so the DP and
         * traceback are redundant */
        memcpy(est_al, est, (size_t)n);
        memcpy(gen_al, gen, (size_t)n);
        *out_len = n;
        return 0;
    }
    dp_census[2] += (n + 1) * (m + 1);
    dirs = dir_scratch_get((n + 1) * stride);
    if (!dirs) return -1;
    score = nw_align(est, n, gen, m, dirs);
    if (score < 0) return -1;
    i = n; j = m; w = cap;
    while (i > 0 && j > 0) {
        int8_t d = dirs[i * stride + j];
        w--;
        if (d == 0) {
            est_al[w] = est[i - 1]; gen_al[w] = gen[j - 1]; i--; j--;
        } else if (d == 1) {
            est_al[w] = est[i - 1]; gen_al[w] = '-'; i--;
        } else {
            est_al[w] = '-'; gen_al[w] = gen[j - 1]; j--;
        }
    }
    while (i > 0) { w--; est_al[w] = est[i - 1]; gen_al[w] = '-'; i--; }
    while (j > 0) { w--; est_al[w] = '-'; gen_al[w] = gen[j - 1]; j--; }
    if (w > 0) {
        memmove(est_al, est_al + w, cap - w);
        memmove(gen_al, gen_al + w, cap - w);
    }
    *out_len = cap - w;
    return score;
}

/* ---- MEG build: edges + simplification + transitive reduction +
 * compaction ------------------------------------------------------------
 * Native mirror of pintron_tpu/meg/graph.py (build_edge_set,
 * _append_sink_and_cleanup) and pintron_tpu/meg/simplify.py
 * (remove_useless_edges, remove_other_sources_and_sinks,
 * compact_short_edges, transitive_reduction, complexity gates), which in
 * turn rebuild max-emb-graph.c:382-672 and meg-simplification.c.  All
 * list orders (column order, adjacency order, incidence order) match the
 * Python/reference semantics exactly — they are output-defining. */

#define MEG_SOURCE_P (-(int64_t)2147483648LL)
#define MEG_SINK_P   ((int64_t)2147483647LL - 200)

typedef struct { int64_t *d; int64_t n, cap; } ivec;

static int iv_push(ivec *v, int64_t x) {
    if (v->n == v->cap) {
        int64_t nc = v->cap ? v->cap * 2 : 8;
        int64_t *nd = (int64_t *)realloc(v->d, nc * sizeof(int64_t));
        if (!nd) return 0;
        v->d = nd; v->cap = nc;
    }
    v->d[v->n++] = x;
    return 1;
}

static void iv_del_at(ivec *v, int64_t k) {
    memmove(v->d + k, v->d + k + 1, (v->n - k - 1) * sizeof(int64_t));
    v->n--;
}

/* remove first occurrence by value; no-op if absent */
static void iv_del_val(ivec *v, int64_t x) {
    int64_t k;
    for (k = 0; k < v->n; k++)
        if (v->d[k] == x) { iv_del_at(v, k); return; }
}

typedef struct {
    int64_t p, t, l;
    ivec adjs, incs;
    int64_t id;
} mvert;

typedef struct {
    mvert *v; int64_t nv, cap_v;
    ivec *cols; int64_t ncols;
    int oom;
} meg_t;

static int64_t meg_new_vert(meg_t *g, int64_t p, int64_t t, int64_t l) {
    if (g->nv == g->cap_v) {
        int64_t nc = g->cap_v * 2;
        mvert *nd = (mvert *)realloc(g->v, nc * sizeof(mvert));
        if (!nd) { g->oom = 1; return -1; }
        g->v = nd; g->cap_v = nc;
    }
    {
        mvert *m = &g->v[g->nv];
        m->p = p; m->t = t; m->l = l;
        m->adjs.d = NULL; m->adjs.n = 0; m->adjs.cap = 0;
        m->incs.d = NULL; m->incs.n = 0; m->incs.cap = 0;
        m->id = -1;
        return g->nv++;
    }
}

static int meg_edge_strict(const mvert *I, const mvert *J, int64_t l,
                           int64_t fl, int64_t max_intron) {
    int I_is_long = I->l >= 5 * l;
    if (J->p <= I->p) return 0;
    if (J->t <= I->t) return 0;
    if (I->p + I->l <= J->p && J->p <= I->p + I->l + fl) {
        if (I->t + I->l <= J->t
            && (max_intron == 0 || J->t <= I->t + I->l + max_intron))
            return 1;
        if (I->t + 2 * l <= J->t + J->l && J->t < I->t + I->l
            && J->p + I->t - I->p - J->t <= fl) {
            if (I_is_long
                && (double)(I->t + I->l - J->t) > 0.4 * (double)I->l)
                return 0;
            return 1;
        }
    } else if (I->p + 2 * l <= J->p + J->l && J->p < I->p + I->l) {
        if (I->t + I->l <= J->t
            && (max_intron == 0 || J->t <= I->t + I->l + max_intron))
            return 1;
        if (I->t + 2 * l <= J->t + J->l && J->t < I->t + I->l
            && J->p + I->t - I->p - J->t <= fl)
            return 1;
    }
    return 0;
}

/* prune vertices with no adjacents or no incidents, to fixpoint */
static void meg_remove_other_ss(meg_t *g) {
    int removed;
    int64_t i, k, e;
    do {
        removed = 0;
        for (i = 1; i < g->ncols - 1; i++) {
            ivec *col = &g->cols[i];
            k = 0;
            while (k < col->n) {
                int64_t vi = col->d[k];
                mvert *I = &g->v[vi];
                if (I->adjs.n == 0 || I->incs.n == 0) {
                    removed = 1;
                    for (e = 0; e < I->adjs.n; e++)
                        iv_del_val(&g->v[I->adjs.d[e]].incs, vi);
                    for (e = 0; e < I->incs.n; e++)
                        iv_del_val(&g->v[I->incs.d[e]].adjs, vi);
                    I->adjs.n = 0;
                    I->incs.n = 0;
                    iv_del_at(col, k);
                } else {
                    k++;
                }
            }
        }
    } while (removed);
}

static void meg_stats_c(const meg_t *g, int64_t *tot_p, int64_t *tot_e) {
    int64_t i, k, tp = 0, te = 0;
    for (i = 0; i < g->ncols; i++)
        for (k = 0; k < g->cols[i].n; k++) {
            tp++;
            te += g->v[g->cols[i].d[k]].adjs.n;
        }
    *tot_p = tp;
    *tot_e = te;
}

/* iterative DFS topological ids (meg-simplification.c:360-470; python
 * mirror simplify.py:_dfs_topological_ids).  Returns acyclic flag. */
static int meg_topo_ids(meg_t *g, int64_t *flat, int64_t nv, int64_t *ids) {
    unsigned char *color = (unsigned char *)calloc(nv, 1);
    ivec S = {NULL, 0, 0};
    int is_acyclic = 1;
    int64_t k, progr_id = nv;
    if (!color) { g->oom = 1; return 0; }
    for (k = 0; k < nv; k++) g->v[flat[k]].id = k;
    for (k = 0; k < nv; k++)
        if (g->v[flat[k]].incs.n == 0)
            if (!iv_push(&S, k)) { g->oom = 1; goto out; }
    if (S.n == 0) is_acyclic = 0;
    for (;;) {
        while (S.n > 0) {
            int64_t v_id = S.d[--S.n];
            if (color[v_id] == 0) {
                mvert *v = &g->v[flat[v_id]];
                int64_t a;
                color[v_id] = 1;
                if (!iv_push(&S, v_id)) { g->oom = 1; goto out; }
                for (a = 0; a < v->adjs.n; a++) {
                    int64_t aid = g->v[v->adjs.d[a]].id;
                    if (color[aid] == 0) {
                        if (!iv_push(&S, aid)) { g->oom = 1; goto out; }
                    } else if (color[aid] == 1) {
                        is_acyclic = 0;
                    }
                }
            } else if (color[v_id] == 1) {
                color[v_id] = 2;
                ids[v_id] = --progr_id;
            }
        }
        {
            int restarted = 0;
            for (k = 0; k < nv; k++)
                if (color[k] == 0) {
                    is_acyclic = 0;
                    if (!iv_push(&S, k)) { g->oom = 1; goto out; }
                    restarted = 1;
                    break;
                }
            if (!restarted) break;
        }
    }
out:
    free(color); free(S.d);
    return is_acyclic;
}

/* portable insertion sort by vertex id (lists are tiny; avoids
 * qsort_r portability issues) */
static void sort_by_id(ivec *lst, const mvert *vs) {
    int64_t i, j;
    for (i = 1; i < lst->n; i++) {
        int64_t x = lst->d[i];
        int64_t xid = vs[x].id;
        j = i - 1;
        while (j >= 0 && vs[lst->d[j]].id > xid) {
            lst->d[j + 1] = lst->d[j];
            j--;
        }
        lst->d[j + 1] = x;
    }
}

/* transitive reduction (meg-simplification.c:518-632; python mirror
 * simplify.py:transitive_reduction).  Returns 1 if applied (acyclic). */
static int meg_trans_red(meg_t *g) {
    int64_t nv = 0, i, k;
    int64_t *flat, *ids;
    ivec *outs_star, *outs_red, *outs_red_inc;
    unsigned char *star_bits;
    int64_t words;
    for (i = 0; i < g->ncols; i++) nv += g->cols[i].n;
    if (nv == 0) return 1;
    flat = (int64_t *)malloc(nv * sizeof(int64_t));
    ids = (int64_t *)malloc(nv * sizeof(int64_t));
    if (!flat || !ids) { g->oom = 1; free(flat); free(ids); return 0; }
    k = 0;
    for (i = 0; i < g->ncols; i++) {
        int64_t j;
        for (j = 0; j < g->cols[i].n; j++) flat[k++] = g->cols[i].d[j];
    }
    if (!meg_topo_ids(g, flat, nv, ids)) {
        free(flat); free(ids);
        return 0;  /* cyclic (or oom): leave untouched */
    }
    /* assign topological rank as id; build rank->vertex order */
    {
        int64_t *by_rank = (int64_t *)malloc(nv * sizeof(int64_t));
        if (!by_rank) { g->oom = 1; free(flat); free(ids); return 0; }
        for (k = 0; k < nv; k++) {
            g->v[flat[k]].id = ids[k];
            by_rank[ids[k]] = flat[k];
        }
        free(flat);
        flat = by_rank;  /* now topologically ordered vertex indices */
    }
    for (k = 0; k < nv; k++) {
        sort_by_id(&g->v[flat[k]].adjs, g->v);
        sort_by_id(&g->v[flat[k]].incs, g->v);
    }
    outs_star = (ivec *)calloc(nv, sizeof(ivec));
    outs_red = (ivec *)calloc(nv, sizeof(ivec));
    outs_red_inc = (ivec *)calloc(nv, sizeof(ivec));
    words = (nv + 7) / 8;
    star_bits = (unsigned char *)malloc(words);
    if (!outs_star || !outs_red || !outs_red_inc || !star_bits) {
        g->oom = 1;
        goto tr_out;
    }
    for (i = nv - 1; i >= 0; i--) {
        int64_t vi = flat[i];
        mvert *v = &g->v[vi];
        int64_t a;
        memset(star_bits, 0, words);
        star_bits[i >> 3] |= (unsigned char)(1u << (i & 7));
        if (!iv_push(&outs_star[i], vi)) { g->oom = 1; goto tr_out; }
        for (a = 0; a < v->adjs.n; a++) {
            int64_t wi = v->adjs.d[a];
            mvert *w = &g->v[wi];
            int64_t wid = w->id;
            int in_star = (star_bits[wid >> 3] >> (wid & 7)) & 1;
            int keep = !in_star
                || w->p < v->p || w->t < v->t
                || w->p + w->l < v->p + v->l || w->t + w->l < v->t + v->l;
            if (keep) {
                if (!iv_push(&outs_red[i], wi)) { g->oom = 1; goto tr_out; }
                if (!iv_push(&outs_red_inc[wid], vi)) {
                    g->oom = 1; goto tr_out;
                }
                if (!(w->p + w->l < v->p + v->l
                      || w->t + w->l < v->t + v->l)) {
                    int64_t s;
                    for (s = 0; s < outs_star[wid].n; s++) {
                        int64_t wai = outs_star[wid].d[s];
                        mvert *wa = &g->v[wai];
                        int64_t waid = wa->id;
                        if (!((star_bits[waid >> 3] >> (waid & 7)) & 1)) {
                            if (v->t <= wa->t && v->p <= wa->p
                                && v->t + v->l <= wa->t + wa->l
                                && v->p + v->l <= wa->p + wa->l) {
                                star_bits[waid >> 3] |=
                                    (unsigned char)(1u << (waid & 7));
                                if (!iv_push(&outs_star[i], wai)) {
                                    g->oom = 1; goto tr_out;
                                }
                            }
                        }
                    }
                }
            }
        }
    }
    for (i = 0; i < nv; i++) {
        mvert *v = &g->v[flat[i]];
        free(v->adjs.d);
        v->adjs = outs_red[i];
        outs_red[i].d = NULL;
        free(v->incs.d);
        v->incs = outs_red_inc[i];
        outs_red_inc[i].d = NULL;
    }
tr_out:
    if (outs_star) {
        for (i = 0; i < nv; i++) free(outs_star[i].d);
        free(outs_star);
    }
    if (outs_red) {
        for (i = 0; i < nv; i++) free(outs_red[i].d);
        free(outs_red);
    }
    if (outs_red_inc) {
        for (i = 0; i < nv; i++) free(outs_red_inc[i].d);
        free(outs_red_inc);
    }
    free(star_bits); free(flat); free(ids);
    return 1;
}

/* Full MEG build.  Input: (p,t,l) pairing triples from vertex_scan (in
 * emission order = column-major).  Output: alive vertices in column
 * order with adjacency (indices into the output numbering).
 * Returns the output vertex count, -1 on allocation failure, or
 * -2 when caps are too small (needs in flags[3], flags[4]).
 * flags: [0]=too_complex, [1]=tot_pairings, [2]=tot_edges,
 *        [3]=needed_v, [4]=needed_e. */
int64_t meg_build(const int64_t *in_p, const int64_t *in_t,
                  const int64_t *in_l, int64_t n_in, int64_t plen,
                  int64_t min_factor_len, int64_t max_intron_length,
                  int64_t min_intron_length,
                  double max_prefix_rate, double max_suffix_rate,
                  int64_t max_pairings, double max_freq_shortest,
                  int64_t trans_red, int64_t short_edge_comp,
                  int64_t *out_p, int64_t *out_t, int64_t *out_l,
                  int64_t *out_col, int64_t *out_adj_off, int64_t *out_adj,
                  int64_t *flags, int64_t cap_v, int64_t cap_e) {
    meg_t g;
    int64_t i, k, ret = -1;
    int64_t ncols = plen + 2;
    int64_t l = min_factor_len, fl = 2 * min_factor_len + 1;
    int64_t gl = 2 * min_factor_len + 3;
    int too_complex = 0;

    g.ncols = ncols;
    g.cap_v = n_in + 16;
    g.nv = 0;
    g.oom = 0;
    g.v = (mvert *)malloc(g.cap_v * sizeof(mvert));
    g.cols = (ivec *)calloc(ncols, sizeof(ivec));
    if (!g.v || !g.cols) { free(g.v); free(g.cols); return -1; }

    /* source + sink sentinels and pairing columns (column = p + 1) */
    {
        int64_t src = meg_new_vert(&g, MEG_SOURCE_P, MEG_SOURCE_P, 200);
        if (src < 0 || !iv_push(&g.cols[0], src)) goto fail;
    }
    for (k = 0; k < n_in; k++) {
        int64_t vi = meg_new_vert(&g, in_p[k], in_t[k], in_l[k]);
        if (vi < 0 || !iv_push(&g.cols[in_p[k] + 1], vi)) goto fail;
    }
    {
        int64_t snk = meg_new_vert(&g, MEG_SINK_P, MEG_SINK_P, 200);
        if (snk < 0 || !iv_push(&g.cols[ncols - 1], snk)) goto fail;
    }

    /* cross-column cleanup (max-emb-graph.c:349-375; python
     * _append_sink_and_cleanup): filter col[i+1] against col[i], i
     * descending from ncols-3 to 1 */
    for (i = ncols - 3; i >= 1; i--) {
        ivec *ca = &g.cols[i], *cb = &g.cols[i + 1];
        int64_t kb = 0;
        while (kb < cb->n) {
            mvert *I1 = &g.v[cb->d[kb]];
            int removed = 0;
            int64_t ka;
            for (ka = 0; ka < ca->n; ka++) {
                mvert *I = &g.v[ca->d[ka]];
                if (I->t == I1->t && I->l >= I1->l) { removed = 1; break; }
            }
            if (removed) iv_del_at(cb, kb);
            else kb++;
        }
    }

    /* edge set (max-emb-graph.c:532-672; python build_edge_set) */
    for (i = 1; i < ncols - 1; i++) {
        int64_t ki;
        for (ki = 0; ki < g.cols[i].n; ki++) {
            int64_t Ii = g.cols[i].d[ki];
            mvert *I = &g.v[Ii];
            int64_t ub = I->p + I->l + fl + 1;
            int64_t j;
            if (ncols - l < ub) ub = ncols - l;
            for (j = 0; j < ub; j++) {
                int64_t kj;
                for (kj = 0; kj < g.cols[j].n; kj++) {
                    int64_t Ji = g.cols[j].d[kj];
                    mvert *J = &g.v[Ji];
                    if (meg_edge_strict(I, J, l, fl, max_intron_length)) {
                        if (!iv_push(&I->adjs, Ji)
                            || !iv_push(&J->incs, Ii)) goto fail;
                    }
                }
            }
        }
    }
    /* source edges */
    {
        int64_t max_p = (int64_t)((double)plen * max_prefix_rate);
        int64_t src = g.cols[0].d[0];
        for (i = 1; i <= max_p && i < ncols; i++) {
            int64_t ki;
            for (ki = 0; ki < g.cols[i].n; ki++) {
                int64_t Ii = g.cols[i].d[ki];
                mvert *I = &g.v[Ii];
                int possible = 1;
                int64_t e;
                for (e = 0; e < I->incs.n && possible; e++) {
                    mvert *inc = &g.v[I->incs.d[e]];
                    int disjoint =
                        (inc->p + inc->l <= I->p || I->p + I->l <= inc->p)
                        && (inc->t + inc->l <= I->t
                            || I->t + I->l <= inc->t);
                    possible = !disjoint;
                    possible = possible
                        && (inc->p + l > I->p || inc->t + l > I->t);
                }
                if (possible) {
                    if (!iv_push(&g.v[src].adjs, Ii)
                        || !iv_push(&I->incs, src)) goto fail;
                }
            }
        }
    }
    /* sink edges */
    {
        int64_t min_p = (int64_t)((double)plen * (1.0 - max_suffix_rate));
        int64_t snk = g.cols[ncols - 1].d[0];
        for (i = 1; i <= plen; i++) {
            int64_t ki;
            for (ki = 0; ki < g.cols[i].n; ki++) {
                int64_t Ii = g.cols[i].d[ki];
                mvert *I = &g.v[Ii];
                int possible = 1;
                int64_t e;
                if (I->p + I->l < min_p) continue;
                for (e = 0; e < I->adjs.n && possible; e++) {
                    mvert *adj = &g.v[I->adjs.d[e]];
                    int disjoint =
                        (adj->p + adj->l <= I->p || I->p + I->l <= adj->p)
                        && (adj->t + adj->l <= I->t
                            || I->t + I->l <= adj->t);
                    possible = !disjoint;
                    possible = possible
                        && (I->p + I->l + l > adj->p + adj->l
                            || I->t + I->l + l > adj->t + adj->l);
                }
                if (possible) {
                    if (!iv_push(&g.v[snk].incs, Ii)
                        || !iv_push(&I->adjs, snk)) goto fail;
                }
            }
        }
    }

    /* simplify: remove useless edges, then orphan pruning */
    for (i = 1; i < ncols; i++) {
        int64_t ki;
        for (ki = 0; ki < g.cols[i].n; ki++) {
            int64_t Pi = g.cols[i].d[ki];
            mvert *P = &g.v[Pi];
            int64_t e = 0;
            while (e < P->adjs.n) {
                mvert *A = &g.v[P->adjs.d[e]];
                if (A->t != MEG_SINK_P) {
                    int64_t gap = A->t - A->p - P->t + P->p;
                    if (gap < 0) gap = 0;
                    if (gap > gl && gap < min_intron_length) {
                        int64_t Ai = P->adjs.d[e];
                        iv_del_at(&P->adjs, e);
                        iv_del_val(&g.v[Ai].incs, Pi);
                        continue;
                    }
                }
                e++;
            }
        }
    }
    meg_remove_other_ss(&g);
    if (g.oom) goto fail;

    if (trans_red) {
        meg_trans_red(&g);
        if (g.oom) goto fail;
    }

    /* complexity gates + optional compaction (compute-est-fact.c:90-152
     * ordering; python stages/est_fact.py:build_meg) */
    {
        int64_t tot_p, tot_e;
        meg_stats_c(&g, &tot_p, &tot_e);
        too_complex = (tot_e > 1000 || tot_p > 2000);
    }
    if (!too_complex && short_edge_comp) {
        int removed;
        do {
            removed = 0;
            for (i = 1; i < ncols; i++) {
                ivec *col = &g.cols[i];
                int64_t pi = 0;
                while (pi < col->n) {
                    int64_t Pi = col->d[pi];
                    int64_t ai = 0;
                    while (ai < g.v[Pi].adjs.n) {
                        int64_t Ai = g.v[Pi].adjs.d[ai];
                        mvert *A = &g.v[Ai];
                        mvert *P = &g.v[Pi];
                        int compact = 0;
                        if (A->t != MEG_SINK_P
                            && A->t + A->l - P->t == A->p + A->l - P->p)
                            compact = (A->t >= P->t + P->l
                                       && A->t - P->t - P->l <= 3);
                        if (compact) {
                            int64_t nv_i, e;
                            removed = 1;
                            iv_del_at(&g.v[Pi].adjs, ai);
                            iv_del_val(&g.v[Ai].incs, Pi);
                            nv_i = meg_new_vert(&g, g.v[Pi].p, g.v[Pi].t,
                                                g.v[Ai].p + g.v[Ai].l
                                                - g.v[Pi].p);
                            if (nv_i < 0) goto fail;
                            /* realloc may move g.v: refresh nothing, use
                             * indices only below */
                            for (e = 0; e < g.v[Ai].adjs.n; e++) {
                                int64_t w = g.v[Ai].adjs.d[e];
                                if (!iv_push(&g.v[nv_i].adjs, w)
                                    || !iv_push(&g.v[w].incs, nv_i))
                                    goto fail;
                            }
                            for (e = 0; e < g.v[Pi].incs.n; e++) {
                                int64_t inc = g.v[Pi].incs.d[e];
                                if (!iv_push(&g.v[nv_i].incs, inc)
                                    || !iv_push(&g.v[inc].adjs, nv_i))
                                    goto fail;
                            }
                            if (!iv_push(col, nv_i)) goto fail;
                            continue;
                        }
                        ai++;
                    }
                    pi++;
                }
            }
            meg_remove_other_ss(&g);
            if (g.oom) goto fail;
        } while (removed);
    }

    /* heuristic complexity gate (meg-simplification.c:89-140) */
    {
        int64_t min_len = 0, freq_min_len = 0, tot_p = 0, tot_e = 0;
        for (i = 0; i < ncols; i++) {
            int64_t ki;
            for (ki = 0; ki < g.cols[i].n; ki++) {
                mvert *P = &g.v[g.cols[i].d[ki]];
                tot_p++;
                if (min_len == 0 || P->l < min_len) {
                    min_len = P->l;
                    freq_min_len = 1;
                } else if (P->l == min_len) {
                    freq_min_len++;
                }
                tot_e += P->adjs.n;
            }
        }
        flags[1] = tot_p;
        flags[2] = tot_e;
        if (tot_p >= 5 && tot_e >= 4) {
            if (max_pairings != 0 && tot_p > max_pairings
                && (double)freq_min_len
                   > max_freq_shortest * (double)tot_p)
                too_complex = 1;
            if (tot_e > 5 * tot_p
                || tot_p > (2 * plen) / min_factor_len
                || (tot_p > plen / min_factor_len && tot_p >= 50))
                too_complex = 1;
        }
        flags[0] = too_complex;
    }

    /* emit: alive vertices in column order, adjacency renumbered */
    {
        int64_t nv_out = 0, ne_out = 0, pos = 0;
        int64_t *newid = (int64_t *)malloc(g.nv * sizeof(int64_t));
        if (!newid) goto fail;
        for (i = 0; i < g.ncols; i++)
            for (k = 0; k < g.cols[i].n; k++) {
                newid[g.cols[i].d[k]] = nv_out++;
                ne_out += g.v[g.cols[i].d[k]].adjs.n;
            }
        flags[3] = nv_out;
        flags[4] = ne_out;
        if (nv_out > cap_v || ne_out > cap_e) {
            free(newid);
            ret = -2;
            goto fail;
        }
        nv_out = 0;
        for (i = 0; i < g.ncols; i++)
            for (k = 0; k < g.cols[i].n; k++) {
                mvert *P = &g.v[g.cols[i].d[k]];
                int64_t e;
                out_p[nv_out] = P->p;
                out_t[nv_out] = P->t;
                out_l[nv_out] = P->l;
                out_col[nv_out] = i;
                out_adj_off[nv_out] = pos;
                for (e = 0; e < P->adjs.n; e++)
                    out_adj[pos++] = newid[P->adjs.d[e]];
                nv_out++;
            }
        out_adj_off[nv_out] = pos;
        free(newid);
        ret = nv_out;
    }
fail:
    for (k = 0; k < g.nv; k++) {
        free(g.v[k].adjs.d);
        free(g.v[k].incs.d);
    }
    for (i = 0; i < g.ncols; i++) free(g.cols[i].d);
    free(g.v);
    free(g.cols);
    return ret;
}

/* ---- refine-intron alignment-string scanners ---------------------------
 * Native mirrors of pintron_tpu/factorize/refine_intron.py:31-126
 * (reference refine-intron.c:892-990, 1852-1874, 1950-1973).  All reads
 * past the string end yield '\0' like the C terminator semantics the
 * python mirror models. */

static char alch(const char *s, int64_t len, int64_t i) {
    return (i >= 0 && i < len) ? s[i] : '\0';
}

/* find_AG_after_on_the_right.  out3 = {cut_on_align, cut_gen, cut_est} */
void scan_ag_after_right(const char *est_al, const char *gen_al,
                         int64_t alen, int64_t init,
                         int64_t intron_end_on_align, int64_t *out3) {
    int64_t index, i, cut_gen = 0, cut_est = 0;
    int stop = 0;
    out3[0] = -1; out3[1] = -1; out3[2] = -1;
    if (init < 2) return;
    index = init - 2;
    while (!stop && index < alen - 1) {
        char first, second;
        while (alch(gen_al, alen, index) == '-') index++;
        first = alch(gen_al, alen, index);
        index++;
        while (alch(gen_al, alen, index) == '-') index++;
        second = alch(gen_al, alen, index);
        stop = (first == 'A' && second == 'G');
        if (!stop && index >= alen) break;
    }
    if (!stop) return;
    out3[0] = index + 1;
    for (i = intron_end_on_align + 1; i <= index; i++) {
        if (alch(gen_al, alen, i) != '-') cut_gen++;
        if (alch(est_al, alen, i) != '-') cut_est++;
    }
    out3[1] = cut_gen;
    out3[2] = cut_est;
}

/* find_ACCEPTOR_before_on_the_left.  acceptor = 2 chars.
 * out3 = {cut_on_align, cut_gen, cut_est} */
void scan_acceptor_before_left(const char *est_al, const char *gen_al,
                               int64_t alen, int64_t init,
                               char acc0, char acc1,
                               int64_t intron_start_on_align,
                               int64_t *out3) {
    int64_t index = init + 2, i, cut_gen = 0, cut_est = 0;
    int stop = 0;
    out3[0] = -1; out3[1] = -1; out3[2] = -1;
    while (!stop && index > 0) {
        char first, second;
        while (alch(gen_al, alen, index) == '-') index--;
        second = alch(gen_al, alen, index);
        index--;
        while (index >= 0 && alch(gen_al, alen, index) == '-') index--;
        first = index >= 0 ? alch(gen_al, alen, index) : '\0';
        if (first == acc0 && second == acc1) stop = 1;
    }
    if (!stop) return;
    out3[0] = index - 1;
    for (i = intron_start_on_align - 1; i >= index; i--) {
        if (alch(gen_al, alen, i) != '-') cut_gen++;
        if (alch(est_al, alen, i) != '-') cut_est++;
    }
    out3[1] = cut_gen;
    out3[2] = cut_est;
}

/* find_ACCEPTOR_after_on_the_left: returns genomic_substr_dim or -1 */
int64_t scan_acceptor_after_left(const char *gen_al, int64_t alen,
                                 int64_t init, char acc0, char acc1,
                                 int64_t intron_start_on_align,
                                 int64_t intron_end_on_align) {
    int64_t index = init;
    int stop = 0;
    while (!stop && index < intron_end_on_align) {
        char first = alch(gen_al, alen, index);
        char second;
        index++;
        second = alch(gen_al, alen, index);
        if (first == acc0 && second == acc1) stop = 1;
    }
    if (!stop) return -1;
    return index - intron_start_on_align - 1;
}

/* find_AG_before_on_the_right: returns dim or -1 */
int64_t scan_ag_before_right(const char *gen_al, int64_t alen,
                             int64_t init, int64_t intron_start_on_align,
                             int64_t intron_end_on_align) {
    int64_t index = init;
    int stop = 0;
    while (!stop && index > intron_start_on_align) {
        char second = alch(gen_al, alen, index);
        char first;
        index--;
        first = alch(gen_al, alen, index);
        if (first == 'A' && second == 'G') stop = 1;
    }
    if (!stop) return -1;
    return intron_end_on_align - index - 1;
}

/* ======================================================================
 * Embedding enumeration + factorization merge
 * (est-factorizations.c:597-1460 get_subtree_embeddings/update_embedding/
 * maximality, 1292-1356 embeddings->factorizations; exact semantics of
 * the python mirror pintron_tpu/factorize/embeddings.py).
 *
 * Operates on the flat MEG arrays emitted by meg_build: vertices
 * (p,t,l,col) plus CSR successor lists.  Enumerates maximal embeddings
 * memoized per subtree root, in column order, and emits the merged
 * factorizations as flat factor quadruples in exactly the order the
 * host-side cascade consumes them.
 * ====================================================================== */

#include <time.h>

typedef struct { int64_t off, len; } femb;

typedef struct {
    int64_t *pool;              /* triples: p,t,l per element */
    int64_t pn, pcap;
    femb *a; int64_t n, cap;    /* scratch embedding list of current root */
} fe_arena;

typedef struct { femb *a; int64_t n; unsigned char done; } fe_memo;

typedef struct {
    const int64_t *vp, *vt, *vl;
    const int64_t *adj_off, *adj;
    int64_t nv;
    const char *gen; int64_t gen_len;
    int64_t mfl, min_intron;
    double deadline;            /* CLOCK_MONOTONIC seconds; 0 = none */
    int64_t tick;
    fe_arena ar;
    fe_memo *memo;
    int err;                    /* 0 ok, -1 timeout, -3 oom */
} fe_ctx;

static double fe_now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static int fe_expired(fe_ctx *c) {
    return c->deadline > 0.0 && fe_now() > c->deadline;
}

static int64_t fe_pool_reserve(fe_ctx *c, int64_t triples) {
    fe_arena *ar = &c->ar;
    if (ar->pn + triples > ar->pcap) {
        int64_t nc = ar->pcap ? ar->pcap : 4096;
        while (nc < ar->pn + triples) nc *= 2;
        int64_t *np = (int64_t *)realloc(ar->pool, (size_t)nc * 3 * sizeof(int64_t));
        if (!np) { c->err = -3; return -1; }
        ar->pool = np; ar->pcap = nc;
    }
    return 0;
}

/* update_embedding (embeddings.py:41-126).  Returns 1 and fills *out if
 * a new embedding is produced, 0 otherwise, <0 on error. */
static int fe_update(fe_ctx *c, femb emb, int64_t node_v, femb *out) {
    int64_t *P = c->ar.pool;
    int64_t hp = P[3 * emb.off], ht = P[3 * emb.off + 1], hl = P[3 * emb.off + 2];
    int64_t np = c->vp[node_v], nt = c->vt[node_v], nl = c->vl[node_v];

    if (hp == MEG_SINK_P) {
        if (np >= 0) {
            if (fe_pool_reserve(c, 1)) return -1;
            P = c->ar.pool;
            int64_t o = c->ar.pn++;
            P[3 * o] = np; P[3 * o + 1] = nt; P[3 * o + 2] = nl;
            out->off = o; out->len = 1;
            return 1;
        }
        return 0;
    }
    if (np < 0) {               /* source: embedding passes through */
        *out = emb;
        return 1;
    }

    int64_t small_delta = (hp + hl) - np;
    int64_t big_delta = (ht + hl) - nt;
    int64_t fl = 2 * c->mfl;
    if (!(small_delta >= fl && big_delta >= fl)) return 0;
    if (!(small_delta - (nl + hl) <= fl)) return 0;
    if (!(small_delta - big_delta <= fl)) return 0;

    int64_t head_copy_p, head_copy_t, head_copy_l, node_copy_l;
    if (small_delta >= nl + hl && big_delta >= nl + hl) {
        head_copy_p = hp; head_copy_t = ht; head_copy_l = hl;
        node_copy_l = nl;
    } else {
        int64_t ref_delta = small_delta < big_delta ? small_delta : big_delta;
        int64_t tln = ref_delta / 2;
        int64_t tlh = ref_delta - tln;
        if (tln > nl) { tln = nl; tlh = ref_delta - tln; }
        else if (tlh > hl) { tlh = hl; tln = ref_delta - tlh; }
        head_copy_l = tlh;
        head_copy_p = hp + hl - head_copy_l;
        head_copy_t = ht + hl - head_copy_l;
        node_copy_l = tln;
    }

    int is_overlap_on_p = small_delta < (nl + hl);
    int64_t gap_p = head_copy_p - np - node_copy_l - 1;
    int64_t gap_t = head_copy_t - nt - node_copy_l - 1;
    int64_t pil = gap_t - (gap_p > 0 ? gap_p : 0);
    int is_intron_on_t = (pil >= 0
                          && (c->min_intron == 0 || pil >= c->min_intron));

    if (is_overlap_on_p && is_intron_on_t) {
        int64_t best_freq = -1, best_cut = 0;
        int64_t min_cut = np + c->mfl > hp ? np + c->mfl : hp;
        int64_t max_cut = hp + hl - c->mfl < np + nl ? hp + hl - c->mfl : np + nl;
        for (int64_t cut = min_cut; cut <= max_cut; cut++) {
            int f = burset_adaptor(c->gen, c->gen_len,
                                   cut - np + nt, cut - hp + ht);
            if (f >= best_freq) { best_freq = f; best_cut = cut; }
        }
        int64_t dH = best_cut - hp;
        head_copy_l = hl - dH;
        head_copy_p = hp + dH;
        head_copy_t = ht + dH;
        int64_t dN = np + nl - best_cut;
        node_copy_l = nl - dN;
    }

    if (gap_t <= fl || is_intron_on_t) {
        if (fe_pool_reserve(c, emb.len + 1)) return -1;
        P = c->ar.pool;
        int64_t o = c->ar.pn;
        c->ar.pn += emb.len + 1;
        P[3 * o] = np; P[3 * o + 1] = nt; P[3 * o + 2] = node_copy_l;
        P[3 * (o + 1)] = head_copy_p;
        P[3 * (o + 1) + 1] = head_copy_t;
        P[3 * (o + 1) + 2] = head_copy_l;
        if (emb.len > 1)
            memcpy(P + 3 * (o + 2), P + 3 * (emb.off + 1),
                   (size_t)(emb.len - 1) * 3 * sizeof(int64_t));
        out->off = o; out->len = emb.len + 1;
        return 1;
    }
    return 0;
}

/* maximality_relation (embeddings.py:129-175): 2 add maximal (cmp
 * dominated), 1 both, 0 add dominated. */
static int fe_maximality(const int64_t *P, femb add, femb cmp) {
    int64_t la = add.len, lc = cmp.len;
    const int64_t *A = P + 3 * add.off, *C = P + 3 * cmp.off;
    int64_t k;
    int check;
    if (la > lc) {
        check = 1;
        for (k = 0; k < lc; k++) {
            const int64_t *a = A + 3 * k, *c = C + 3 * k;
            if (c[0] < a[0] || c[0] + c[2] > a[0] + a[2]
                || c[1] < a[1] || c[1] + c[2] > a[1] + a[2]) {
                check = 0; break;
            }
        }
        return check ? 2 : 1;
    }
    if (la < lc) {
        check = 1;
        for (k = 0; k < la; k++) {
            const int64_t *a = A + 3 * k, *c = C + 3 * k;
            if (a[0] < c[0] || a[0] + a[2] > c[0] + c[2]
                || a[1] < c[1] || a[1] + a[2] > c[1] + c[2]) {
                check = 0; break;
            }
        }
        return check ? 0 : 1;
    }
    check = 1;
    for (k = 0; k < la; k++) {
        const int64_t *a = A + 3 * k, *c = C + 3 * k;
        if (a[0] < c[0] || a[0] + a[2] > c[0] + c[2]
            || a[1] < c[1] || a[1] + a[2] > c[1] + c[2]) {
            check = 0; break;
        }
    }
    if (check) return 0;
    check = 1;
    for (k = 0; k < la; k++) {
        const int64_t *a = A + 3 * k, *c = C + 3 * k;
        if (c[0] < a[0] || c[0] + c[2] > a[0] + a[2]
            || c[1] < a[1] || c[1] + c[2] > a[1] + a[2]) {
            check = 0; break;
        }
    }
    return check ? 2 : 1;
}

/* get_subtree_embeddings (embeddings.py:195-231), recursive + memoized. */
static int fe_subtree(fe_ctx *c, int64_t v) {
    if (c->memo[v].done) return 0;
    if (fe_expired(c)) { c->err = -1; return -1; }

    /* local embedding list for this root */
    femb *lst = NULL; int64_t ln = 0, lcap = 0;

    int64_t a0 = c->adj_off[v], a1 = c->adj_off[v + 1];
    if (a0 == a1) {
        lst = (femb *)malloc(sizeof(femb));
        if (!lst) { c->err = -3; return -1; }
        if (fe_pool_reserve(c, 1)) { free(lst); return -1; }
        int64_t o = c->ar.pn++;
        c->ar.pool[3 * o] = c->vp[v];
        c->ar.pool[3 * o + 1] = c->vt[v];
        c->ar.pool[3 * o + 2] = c->vl[v];
        lst[0].off = o; lst[0].len = 1;
        ln = 1;
    } else {
        for (int64_t e = a0; e < a1; e++) {
            int64_t w = c->adj[e];
            if (fe_subtree(c, w)) { free(lst); return -1; }
            fe_memo *sub = &c->memo[w];
            for (int64_t s = 0; s < sub->n; s++) {
                femb add;
                int r = fe_update(c, sub->a[s], v, &add);
                if (r < 0) { free(lst); return -1; }
                if (r == 0) continue;
                /* throttled timeout check (every 1024 adds) */
                if (c->tick == 0 && fe_expired(c)) {
                    c->err = -1; free(lst); return -1;
                }
                c->tick = (c->tick + 1) & 1023;
                int is_max = 2;
                int64_t k = 0;
                while (k < ln && is_max >= 1) {
                    is_max = fe_maximality(c->ar.pool, add, lst[k]);
                    if (is_max == 2) {
                        memmove(lst + k, lst + k + 1,
                                (size_t)(ln - k - 1) * sizeof(femb));
                        ln--;
                    } else {
                        k++;
                    }
                }
                if (is_max >= 1) {
                    if (ln == lcap) {
                        lcap = lcap ? 2 * lcap : 8;
                        femb *nl = (femb *)realloc(lst,
                                                   (size_t)lcap * sizeof(femb));
                        if (!nl) { c->err = -3; free(lst); return -1; }
                        lst = nl;
                    }
                    lst[ln++] = add;
                }
            }
        }
    }
    c->memo[v].a = lst;
    c->memo[v].n = ln;
    c->memo[v].done = 1;
    return 0;
}

/* Entry point.  Returns #factorizations and fills out_off (nf+1 offsets
 * into the factor arrays) and out_f (4 int64 per factor: est_start,
 * est_end, gen_start, gen_end).  Returns -1 on timeout, -2 if caps are
 * too small (need2 = {nf_needed, nfactors_needed}), -3 on OOM. */
int64_t meg_factorizations(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols,
    const char *gen, int64_t gen_len,
    int64_t min_factor_len, int64_t min_intron_length,
    double deadline,
    int64_t *out_off, int64_t *out_f,
    int64_t cap_facts, int64_t cap_factors,
    int64_t *need2) {

    fe_ctx c;
    memset(&c, 0, sizeof(c));
    c.vp = vp; c.vt = vt; c.vl = vl;
    c.adj_off = adj_off; c.adj = adj;
    c.nv = nv; c.gen = gen; c.gen_len = gen_len;
    c.mfl = min_factor_len; c.min_intron = min_intron_length;
    c.deadline = deadline;
    c.memo = (fe_memo *)calloc((size_t)nv, sizeof(fe_memo));
    if (!c.memo) return -3;

    /* column-order root iteration: stable counting sort by vcol */
    int64_t *cnt = (int64_t *)calloc((size_t)ncols + 1, sizeof(int64_t));
    int64_t *order = (int64_t *)malloc((size_t)nv * sizeof(int64_t));
    if (!cnt || !order) {
        free(c.memo); free(cnt); free(order);
        return -3;
    }
    for (int64_t k = 0; k < nv; k++) cnt[vcol[k] + 1]++;
    for (int64_t k = 1; k <= ncols; k++) cnt[k] += cnt[k - 1];
    for (int64_t k = 0; k < nv; k++) order[cnt[vcol[k]]++] = k;

    int64_t fl = 2 * min_factor_len;
    int64_t nf = 0, nfac = 0;
    int64_t ret = 0;

    for (int64_t r = 0; r < nv; r++) {
        int64_t root = order[r];
        if (c.memo[root].done) continue;
        if (fe_subtree(&c, root)) { ret = c.err; goto done; }
        fe_memo *m = &c.memo[root];
        for (int64_t s = 0; s < m->n; s++) {
            femb emb = m->a[s];
            const int64_t *P = c.ar.pool + 3 * emb.off;
            if (nf < cap_facts) out_off[nf] = nfac;
            int64_t last = -1; /* index into out_f rows of current factor */
            for (int64_t k = 0; k < emb.len; k++) {
                int64_t p = P[3 * k], t = P[3 * k + 1], l = P[3 * k + 2];
                int start_new = 1;
                if (last >= 0 && last < cap_factors) {
                    if (t - out_f[4 * last + 3] - 1 <= fl) start_new = 0;
                }
                if (start_new) {
                    if (nfac < cap_factors) {
                        out_f[4 * nfac] = p;
                        out_f[4 * nfac + 1] = p + l - 1;
                        out_f[4 * nfac + 2] = t;
                        out_f[4 * nfac + 3] = t + l - 1;
                        last = nfac;
                    } else {
                        last = cap_factors; /* poison: counting only */
                    }
                    nfac++;
                } else {
                    out_f[4 * last + 1] = p + l - 1;
                    out_f[4 * last + 3] = t + l - 1;
                }
            }
            nf++;
        }
    }
    if (nf <= cap_facts) {
        /* final sentinel offset */
        if (nf < cap_facts + 1) out_off[nf] = nfac;
    }
    if (nf + 1 > cap_facts + 1 || nfac > cap_factors) {
        need2[0] = nf; need2[1] = nfac;
        ret = -2;
    } else {
        ret = nf;
    }
done:
    for (int64_t k = 0; k < nv; k++) free(c.memo[k].a);
    free(c.memo); free(cnt); free(order); free(c.ar.pool);
    return ret;
}

/* ======================================================================
 * MEG text formatting (io-meg.c:meg_write and
 * max-emb-graph.c:add_intronic_edges_to_file), straight from the flat
 * arrays so the host never rebuilds per-vertex objects.
 * mode 0: "(p,t,l)\n"* "#adj#\n" "id-id\n"*      (ids in column order)
 * mode 1: intronic-edge rows (9 ints, optional " intronic").
 * Returns bytes written, or -(needed) if cap is too small.
 * ====================================================================== */

static char *fmt_i64(char *w, int64_t x) {
    char tmp[24];
    int n = 0;
    if (x < 0) { *w++ = '-'; do { tmp[n++] = (char)('0' - (x % 10)); x /= 10; } while (x); }
    else { do { tmp[n++] = (char)('0' + (x % 10)); x /= 10; } while (x); }
    while (n) *w++ = tmp[--n];
    return w;
}

int64_t meg_format(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols, int64_t mode,
    char *out, int64_t cap) {

    /* column-order ids (stable counting sort, matches meg write order) */
    int64_t *cnt = (int64_t *)calloc((size_t)ncols + 1, sizeof(int64_t));
    int64_t *order = (int64_t *)malloc((size_t)nv * sizeof(int64_t));
    int64_t *ids = (int64_t *)malloc((size_t)nv * sizeof(int64_t));
    if (!cnt || !order || !ids) { free(cnt); free(order); free(ids); return -1; }
    for (int64_t k = 0; k < nv; k++) cnt[vcol[k] + 1]++;
    for (int64_t k = 1; k <= ncols; k++) cnt[k] += cnt[k - 1];
    for (int64_t k = 0; k < nv; k++) order[cnt[vcol[k]]++] = k;
    for (int64_t i = 0; i < nv; i++) ids[order[i]] = i;

    /* worst-case line sizes: mode 0 vertex ~70, edge ~44; mode 1 ~220 */
    int64_t need = mode == 0
        ? nv * 72 + 8 + (nv ? adj_off[nv] : 0) * 46
        : (nv ? adj_off[nv] : 0) * 224;
    if (need + 1 > cap) {
        free(cnt); free(order); free(ids);
        return -(need + 1);
    }

    char *w = out;
    if (mode == 0) {
        for (int64_t i = 0; i < nv; i++) {
            int64_t k = order[i];
            *w++ = '(';
            w = fmt_i64(w, vp[k]); *w++ = ',';
            w = fmt_i64(w, vt[k]); *w++ = ',';
            w = fmt_i64(w, vl[k]); *w++ = ')'; *w++ = '\n';
        }
        memcpy(w, "#adj#\n", 6); w += 6;
        for (int64_t i = 0; i < nv; i++) {
            int64_t k = order[i];
            for (int64_t e = adj_off[k]; e < adj_off[k + 1]; e++) {
                w = fmt_i64(w, ids[k]); *w++ = '-';
                w = fmt_i64(w, ids[adj[e]]); *w++ = '\n';
            }
        }
    } else {
        for (int64_t i = 0; i < nv; i++) {
            int64_t k = order[i];
            if (vp[k] < 0 || vp[k] == MEG_SINK_P) continue;
            for (int64_t e = adj_off[k]; e < adj_off[k + 1]; e++) {
                int64_t a = adj[e];
                if (vp[a] == MEG_SINK_P) continue;
                int64_t dt = (vt[a] - vt[k]) - (vp[a] - vp[k]);
                w = fmt_i64(w, vt[k] + vl[k]); *w++ = ' ';
                w = fmt_i64(w, vt[a]); *w++ = ' ';
                w = fmt_i64(w, vp[k] + vl[k]); *w++ = ' ';
                w = fmt_i64(w, vp[a]); *w++ = ' ';
                w = fmt_i64(w, vt[a] - vt[k] - vl[k]); *w++ = ' ';
                w = fmt_i64(w, vp[a] - vp[k] - vl[k]); *w++ = ' ';
                w = fmt_i64(w, dt); *w++ = ' ';
                w = fmt_i64(w, vl[k]); *w++ = ' ';
                w = fmt_i64(w, vl[a]);
                if (dt >= 50) { memcpy(w, " intronic", 9); w += 9; }
                *w++ = '\n';
            }
        }
    }
    free(cnt); free(order); free(ids);
    return (int64_t)(w - out);
}

/* Final-cell unit-cost edit distance with rolling rows (the full-matrix
 * edit_matrix is only needed when callers read interior cells; most call
 * sites use just the total).  Same literal-char semantics as edit_matrix. */
int64_t edit_total(const char *s1, int64_t l1, const char *s2, int64_t l2) {
    dp_census[1] += (l1 + 1) * (l2 + 1);
    if (l1 == 0) return l2;
    if (l2 == 0) return l1;
    if (l1 == l2 && memcmp(s1, s2, (size_t)l1) == 0) return 0;
    if (l1 + l2 < I16_LIMIT) {
        /* wavefront form: cand[j] = min(diag, up), then the in-row
         * left-chain closed by the slope-1 prefix relax — int16 SIMD
         * (values bounded by l1 + l2). */
        static int16_t *buf = NULL;
        static int64_t buf_cap = 0;
        int16_t *prev, *cur, *tmp;
        int64_t i, j;
        if (2 * (l1 + 2) > buf_cap) {
            int16_t *nb = (int16_t *)realloc(
                buf, (size_t)(4 * (l1 + 2) + 64) * sizeof(int16_t));
            if (!nb) return -1;
            buf = nb;
            buf_cap = 4 * (l1 + 2) + 64;
        }
        prev = buf;
        cur = buf + (l1 + 2);
        for (j = 0; j <= l1; j++) prev[j] = (int16_t)j;
        for (i = 1; i <= l2; i++) {
            char c2 = s2[i - 1];
            cur[0] = (int16_t)i;
            for (j = 1; j <= l1; j++) {
                int16_t sub = (int16_t)(prev[j - 1]
                                        + (s1[j - 1] != c2));
                int16_t del = (int16_t)(prev[j] + 1);
                cur[j] = sub < del ? sub : del;
            }
            relax_min16_slope1(cur, l1);
            tmp = prev; prev = cur; cur = tmp;
        }
        return prev[l1];
    }
    int64_t *row = (int64_t *)malloc((size_t)(l1 + 1) * sizeof(int64_t));
    if (!row) return -1;
    for (int64_t j = 0; j <= l1; j++) row[j] = j;
    for (int64_t i = 1; i <= l2; i++) {
        int64_t diag = row[0];
        row[0] = i;
        char c2 = s2[i - 1];
        for (int64_t j = 1; j <= l1; j++) {
            int64_t up = row[j];
            int64_t sub = diag + (s1[j - 1] != c2);
            int64_t del = up + 1;
            int64_t ins = row[j - 1] + 1;
            int64_t m = sub < del ? sub : del;
            row[j] = m < ins ? m : ins;
            diag = up;
        }
    }
    int64_t r = row[l1];
    free(row);
    return r;
}

/* Longest-affix recovery scan (factorization-refinement.c:1134-1172).
 * Unit-cost edit matrix of (gen, est) — literal char comparison — with
 * rolling rows; among cells where est[i-1]==gen[j-1] and the weight
 * w = 2*M[i][j]/(i+j) is <= max_rate (and <= 1.0), select the LAST cell
 * in row-major order achieving the minimum weight.  Returns 1 if such a
 * cell exists (out[0]=i, out[1]=j), else 0; -1 on alloc failure. */
int64_t longest_affix(const char *est, int64_t n, const char *gen,
                      int64_t m, double max_rate, int64_t *out) {
    if (n == 0 || m == 0) return 0;
    int64_t *row = (int64_t *)malloc((size_t)(m + 1) * sizeof(int64_t));
    if (!row) return -1;
    for (int64_t j = 0; j <= m; j++) row[j] = j;
    double best = 2.0;  /* above any eligible weight */
    int64_t bi = 0, bj = 0;
    int found = 0;
    for (int64_t i = 1; i <= n; i++) {
        int64_t diag = row[0];
        row[0] = i;
        char ce = est[i - 1];
        for (int64_t j = 1; j <= m; j++) {
            int64_t up = row[j];
            int64_t sub = diag + (gen[j - 1] != ce);
            int64_t del = up + 1;
            int64_t ins = row[j - 1] + 1;
            int64_t v = sub < del ? sub : del;
            v = v < ins ? v : ins;
            row[j] = v;
            diag = up;
            if (ce == gen[j - 1]) {
                double w = 2.0 * (double)v / (double)(i + j);
                if (w <= max_rate && w <= 1.0 && w <= best) {
                    best = w; bi = i; bj = j; found = 1;
                }
            }
        }
    }
    free(row);
    out[0] = bi;
    out[1] = bj;
    return found;
}

/* ======================================================================
 * Full intron refinement (refine-intron.c:47-265 + Shift_* helpers;
 * exact semantics of the python mirror
 * pintron_tpu/factorize/refine_intron.py:refine_intron).
 *
 * Returns -1 on alloc failure (caller falls back to the python path),
 * 0 = no change, 1 = first-intron early accept (out4[1]=acceptor.est
 * _start, out4[2]=acceptor.gen_start), 2 = full accept (out4[0]=donor.
 * gen_end, out4[1]=acceptor.gen_start, out4[2]=acceptor.est_start).
 * ====================================================================== */

/* clamped substring append (util.c:real_substring semantics) — returns
 * number of chars appended */
static int64_t ri_substr(char *dst, const char *src, int64_t srclen,
                         int64_t index, int64_t length) {
    int64_t k, n = 0;
    if (index < 0) { length += index; index = 0; }
    if (length <= 0) return 0;
    for (k = index; k < index + length && k < srclen; k++) dst[n++] = src[k];
    return n;
}

static char ri_at(const char *s, int64_t len, int64_t i) {
    return (i >= 0 && i < len) ? s[i] : '\0';
}

/* check_burset_patterns (refine-intron.c:346-360) */
static int ri_check_burset(const char *gen, int64_t glen,
                           int64_t drg, int64_t arg) {
    char d[2], a[2];
    if (ri_substr(d, gen, glen, drg + 1, 2) < 2) return 0;
    if (ri_substr(a, gen, glen, arg - 2, 2) < 2) return 0;
    return burset_pair(d[0], d[1], a[0], a[1]);
}

/* get_est/genomic_substring_from_alignment (refine-intron.c:1878-1948).
 * Returns substring length (>=0) with *err set, or -1 for the python
 * None case (init out of range). */
static int64_t ri_sub_from_align(const char *keep, const char *other,
                                 int64_t alen, int64_t init, int64_t length,
                                 char *dst, int64_t *err) {
    int64_t actual, index, n = 0, e = 0;
    if (init < 0 || init >= alen) return -1;
    actual = alen - init < length ? alen - init : length;
    for (index = init; index < init + actual; index++) {
        if (keep[index] != '-') dst[n++] = keep[index];
        if (keep[index] != other[index]) e++;
    }
    *err = e;
    return n;
}

typedef struct {
    const char *est_al, *gen_al;
    int64_t alen;
    int64_t isa, iea;      /* intron_{start,end}_on_align */
    int64_t nafl, ndrg, nalg;
} ri_al_t;

/* _shift_ext_error */
static void ri_ext_error(const ri_al_t *al, int right_to_left,
                         char *ext_est, int64_t *ext_est_len,
                         char *ext_gen, int64_t *ext_gen_len,
                         int64_t *ext_error) {
    int64_t e1, e2, n1, n2;
    *ext_error = -1;
    if (right_to_left) {
        int64_t l_substr = 8, start = al->isa - 8;
        if (start < 0) { l_substr = 8 - start; start = 0; }
        n1 = ri_sub_from_align(al->est_al, al->gen_al, al->alen, start,
                               l_substr, ext_est, &e1);
        n2 = ri_sub_from_align(al->gen_al, al->est_al, al->alen, start,
                               l_substr, ext_gen, &e2);
    } else {
        int64_t init = al->iea + 1;
        n1 = ri_sub_from_align(al->est_al, al->gen_al, al->alen, init, 8,
                               ext_est, &e1);
        n2 = ri_sub_from_align(al->gen_al, al->est_al, al->alen, init, 8,
                               ext_gen, &e2);
    }
    *ext_est_len = n1;
    *ext_gen_len = n2;
    if (n1 >= 0) *ext_error = e1;
    if (n2 >= 0) *ext_error = e2;
}

#define RI_CYCLE 2
#define RI_STR_CAP 4096

/* one shift-candidate table row */
typedef struct {
    int64_t gen_cut, est_cut, gen_substr;
    char cut_factor[RI_STR_CAP]; int64_t cf_len;   /* -1 = None */
    char match_str[RI_STR_CAP];  int64_t ms_len;
    char prev_match[RI_STR_CAP]; int64_t pm_len;
    char ext_cut[2 * RI_STR_CAP];   int64_t ec_len;
    char ext_match[2 * RI_STR_CAP]; int64_t em_len;
} ri_row_t;

static void ri_rows_init(ri_row_t *rows) {
    int i;
    for (i = 0; i < RI_CYCLE; i++) {
        rows[i].gen_cut = rows[i].est_cut = rows[i].gen_substr = 0;
        rows[i].cf_len = rows[i].ms_len = rows[i].pm_len = -1;
        rows[i].ec_len = rows[i].em_len = -1;
    }
}

/* variant 1 (GT): first (i,j) with unsigned error <= 1 wins.
 * variant 2 (GC): minimize signed edit, stop only at 0.
 * right_to_left selects the scan direction pair. */
static int ri_shift(const char *est, int64_t est_len,
                    const char *gen, int64_t gen_len,
                    const ri_al_t *al, char acc0, char acc1,
                    int variant, int right_to_left, int64_t *out3) {
    ri_row_t rows[RI_CYCLE];
    char ext_est[64], ext_gen[64];
    int64_t ext_est_len, ext_gen_len, ext_error;
    int64_t init_right, init_left;
    int64_t i, j;
    int stop = 0;
    int64_t o3[3];

    ri_rows_init(rows);
    ri_ext_error(al, right_to_left, ext_est, &ext_est_len,
                 ext_gen, &ext_gen_len, &ext_error);

    if (right_to_left) {
        init_right = al->iea + 1;
        init_left = al->isa;
    } else {
        init_right = al->iea;
        init_left = al->isa - 1;
    }

    for (i = 0; i < RI_CYCLE; i++) {
        ri_row_t *r = &rows[i];
        if (right_to_left) {
            scan_ag_after_right(al->est_al, al->gen_al, al->alen,
                                init_right, al->iea, o3);
            r->gen_cut = o3[1]; r->est_cut = o3[2];
            if (r->est_cut > -1) {
                if (variant == 1)
                    r->pm_len = ri_substr(r->prev_match, gen, gen_len,
                                          al->nalg, r->gen_cut);
                r->cf_len = ri_substr(r->cut_factor, est, est_len,
                                      al->nafl, r->est_cut);
                init_right = o3[0] + 1;
                if (ext_error > 0 && ext_est_len >= 0) {
                    memcpy(r->ext_cut, ext_est, (size_t)ext_est_len);
                    memcpy(r->ext_cut + ext_est_len, r->cut_factor,
                           (size_t)r->cf_len);
                    r->ec_len = ext_est_len + r->cf_len;
                }
            }
            r->gen_substr = scan_acceptor_after_left(al->gen_al, al->alen,
                                                     init_left, acc0, acc1,
                                                     al->isa, al->iea);
            if (r->gen_substr > -1) {
                r->ms_len = ri_substr(r->match_str, gen, gen_len,
                                      al->ndrg + 1, r->gen_substr);
                init_left = al->isa + r->gen_substr + 1;
                if (r->cf_len >= 0 && ext_error > 0 && ext_gen_len >= 0) {
                    memcpy(r->ext_match, ext_gen, (size_t)ext_gen_len);
                    memcpy(r->ext_match + ext_gen_len, r->match_str,
                           (size_t)r->ms_len);
                    r->em_len = ext_gen_len + r->ms_len;
                }
            }
        } else {
            scan_acceptor_before_left(al->est_al, al->gen_al, al->alen,
                                      init_left, acc0, acc1, al->isa, o3);
            r->gen_cut = o3[1]; r->est_cut = o3[2];
            if (r->est_cut > -1) {
                if (variant == 1)
                    r->pm_len = ri_substr(r->prev_match, gen, gen_len,
                                          al->ndrg - r->gen_cut + 1,
                                          r->gen_cut);
                r->cf_len = ri_substr(r->cut_factor, est, est_len,
                                      al->nafl - r->est_cut, r->est_cut);
                init_left = o3[0] - 1;
                if (ext_error > 0 && ext_est_len >= 0) {
                    memcpy(r->ext_cut, r->cut_factor, (size_t)r->cf_len);
                    memcpy(r->ext_cut + r->cf_len, ext_est,
                           (size_t)ext_est_len);
                    r->ec_len = r->cf_len + ext_est_len;
                }
            }
            r->gen_substr = scan_ag_before_right(al->gen_al, al->alen,
                                                 init_right, al->isa,
                                                 al->iea);
            if (r->gen_substr > -1) {
                r->ms_len = ri_substr(r->match_str, gen, gen_len,
                                      al->nalg - r->gen_substr,
                                      r->gen_substr);
                init_right = al->iea - r->gen_substr - 1;
                if (r->cf_len >= 0 && ext_error > 0 && ext_gen_len >= 0) {
                    memcpy(r->ext_match, r->match_str, (size_t)r->ms_len);
                    memcpy(r->ext_match + r->ms_len, ext_gen,
                           (size_t)ext_gen_len);
                    r->em_len = r->ms_len + ext_gen_len;
                }
            }
        }
    }

    if (variant == 1) {
        int64_t error = 1000, edit_prev = 1000;
        for (i = 0; i < RI_CYCLE && !stop; i++) {
            for (j = 0; j < RI_CYCLE && !stop; j++) {
                if (rows[i].cf_len >= 0 && rows[j].ms_len >= 0) {
                    edit_prev = edit_total(rows[i].cut_factor,
                                           rows[i].cf_len,
                                           rows[i].prev_match,
                                           rows[i].pm_len);
                    if (edit_prev <= 5) {
                        int64_t ed;
                        if (rows[i].ec_len >= 0 && rows[j].em_len >= 0) {
                            ed = edit_total(rows[i].ext_cut, rows[i].ec_len,
                                            rows[j].ext_match,
                                            rows[j].em_len);
                            error = (int64_t)(uint32_t)(ed - edit_prev
                                                        - ext_error);
                        } else {
                            ed = edit_total(rows[i].cut_factor,
                                            rows[i].cf_len,
                                            rows[j].match_str,
                                            rows[j].ms_len);
                            error = (int64_t)(uint32_t)(ed - edit_prev);
                        }
                    }
                }
                if (error <= 1) {
                    if (right_to_left) {
                        out3[0] = al->ndrg + rows[j].gen_substr;
                        out3[1] = al->nalg + rows[i].gen_cut;
                        out3[2] = al->nafl + rows[i].est_cut;
                    } else {
                        out3[0] = al->ndrg - rows[i].gen_cut;
                        out3[1] = al->nalg - rows[j].gen_substr;
                        out3[2] = al->nafl - rows[i].est_cut;
                    }
                    stop = 1;
                }
            }
        }
    } else {
        int64_t error = 1000;
        for (i = 0; i < RI_CYCLE && !stop; i++) {
            for (j = 0; j < RI_CYCLE && !stop; j++) {
                int64_t edit;
                if (rows[i].ec_len >= 0 && rows[j].em_len >= 0) {
                    edit = edit_total(rows[i].ext_cut, rows[i].ec_len,
                                      rows[j].ext_match, rows[j].em_len)
                           - ext_error;
                } else if (rows[i].cf_len >= 0 && rows[j].ms_len >= 0) {
                    edit = edit_total(rows[i].cut_factor, rows[i].cf_len,
                                      rows[j].match_str, rows[j].ms_len);
                } else {
                    edit = 1000;
                }
                if (edit < error) {
                    error = edit;
                    if (right_to_left) {
                        out3[0] = al->ndrg + rows[j].gen_substr;
                        out3[1] = al->nalg + rows[i].gen_cut;
                        out3[2] = al->nafl + rows[i].est_cut;
                    } else {
                        out3[0] = al->ndrg - rows[i].gen_cut;
                        out3[1] = al->nalg - rows[j].gen_substr;
                        out3[2] = al->nafl - rows[i].est_cut;
                    }
                }
                if (error == 0) stop = 1;
            }
        }
    }
    return stop;
}

/* try_burset_after_match (refine-intron.c:267-343) */
static void ri_try_burset(const char *est, int64_t est_len,
                          const char *gen, int64_t gen_len,
                          int64_t afl, int64_t drg, int64_t alg,
                          int64_t sdfl, int64_t safr, int64_t *out3) {
    int64_t s_afl = afl, s_alg = alg, s_drg = drg;
    int64_t upd_afl = s_afl, upd_alg = s_alg, upd_drg = s_drg;
    int64_t frequency = 0;
    int right_to_left = 0, stop = 0;

    while (!stop && ri_at(est, est_len, s_afl) == ri_at(gen, gen_len, s_alg)
           && s_afl > sdfl + 1) {
        if (s_afl == 0 || s_drg == -1) { stop = 1; }
        else {
            int64_t tmp = ri_check_burset(gen, gen_len, s_drg, s_alg);
            if (tmp > frequency) {
                frequency = tmp;
                upd_afl = s_afl; upd_alg = s_alg; upd_drg = s_drg;
            }
            s_afl--; s_drg--; s_alg--;
        }
    }

    s_afl = afl; s_alg = alg + 1; s_drg = drg + 1;
    stop = 0;
    while (!stop && ri_at(est, est_len, s_afl) == ri_at(gen, gen_len, s_drg)
           && s_afl < safr) {
        if (s_afl == est_len || s_alg == gen_len) { stop = 1; }
        else {
            int64_t tmp = ri_check_burset(gen, gen_len, s_drg, s_alg);
            if (tmp > frequency) {
                frequency = tmp;
                upd_afl = s_afl; upd_alg = s_alg; upd_drg = s_drg;
                right_to_left = 1;
            }
            s_afl++; s_drg++; s_alg++;
        }
    }
    if (right_to_left) upd_afl++;
    out3[0] = upd_drg;
    out3[1] = upd_alg;
    out3[2] = upd_afl;
}

/* Window construction shared by refine_intron_core, the intron collect
 * pass and the device-fill decoder (all three must build byte-identical
 * windows).  Fills the module statics ri_seq_est/ri_seq_gen and the
 * geometry needed to map alignment coordinates back to the locus. */
typedef struct {
    int64_t n, m;                 /* window lengths (est, gen) */
    int64_t dsl_est, dsl_gen;     /* window origins */
    int64_t deleted_intron_dim;   /* genomic bases elided between the
                                     intron prefix and suffix */
} ri_win;

static char *ri_seq_est = NULL, *ri_seq_gen = NULL;
static int64_t ri_cap_e = 0, ri_cap_g = 0;
static char *ri_est_al = NULL, *ri_gen_al = NULL;
static int64_t ri_cap_al = 0;

static int ri_al_reserve(int64_t need) {
    if (need + 8 <= ri_cap_al) return 1;
    {
        /* commit each static only after its own realloc succeeds: a
         * partial failure must leave both pointers valid (ri_cap_al
         * stays put, so the next call retries the grow) */
        char *na = (char *)realloc(ri_est_al, (size_t)(2 * need + 64));
        char *ng;
        if (!na) return 0;
        ri_est_al = na;
        ng = (char *)realloc(ri_gen_al, (size_t)(2 * need + 64));
        if (!ng) return 0;
        ri_gen_al = ng;
        ri_cap_al = 2 * need + 64;
    }
    return 1;
}

static int ri_build_windows(
    const char *gen, int64_t gen_len, const char *est, int64_t est_len,
    int64_t d_es, int64_t d_ee, int64_t d_gs, int64_t d_ge,
    int64_t a_es, int64_t a_ee, int64_t a_gs, int64_t a_ge,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen, ri_win *w) {
    int64_t n = 0, m = 0;
    int64_t dsl_gen, dsl_est, apr_gen, apr_est;
    int64_t need_e, need_g;

    /* window bounds */
    dsl_gen = d_gs;
    if (d_ge - sp_gen + 1 >= dsl_gen) dsl_gen = d_ge - sp_gen + 1;
    dsl_est = d_es;
    if (d_ee - sp_est + 1 >= dsl_est) dsl_est = d_ee - sp_est + 1;
    apr_gen = a_ge;
    if (a_gs + sp_gen - 1 <= apr_gen) apr_gen = a_gs + sp_gen - 1;
    apr_est = a_ee;
    if (a_es + sp_est - 1 <= apr_est) apr_est = a_es + sp_est - 1;

    {
        int64_t t1 = d_ee - dsl_est + 1, t2 = a_es - d_ee - 1,
                t3 = apr_est - a_es + 1;
        if (t1 < 0) t1 = 0;
        if (t2 < 0) t2 = 0;
        if (t3 < 0) t3 = 0;
        need_e = t1 + t2 + t3 + 16;
        t1 = d_ge - dsl_gen + 1; t3 = apr_gen - a_gs + 1;
        if (t1 < 0) t1 = 0;
        if (t3 < 0) t3 = 0;
        need_g = t1 + 2 * sp_intron + t3 + 16;
    }
    if (need_e > ri_cap_e) {
        char *nb = (char *)realloc(ri_seq_est, (size_t)(2 * need_e));
        if (!nb) return 0;
        ri_seq_est = nb; ri_cap_e = 2 * need_e;
    }
    if (need_g > ri_cap_g) {
        char *nb = (char *)realloc(ri_seq_gen, (size_t)(2 * need_g));
        if (!nb) return 0;
        ri_seq_gen = nb; ri_cap_g = 2 * need_g;
    }

    /* sequence_on_est = donor suffix + gap + acceptor prefix */
    n += ri_substr(ri_seq_est + n, est, est_len, dsl_est,
                   d_ee - dsl_est + 1);
    if (d_ee != a_es - 1)
        n += ri_substr(ri_seq_est + n, est, est_len, d_ee + 1,
                       a_es - d_ee - 1);
    n += ri_substr(ri_seq_est + n, est, est_len, a_es,
                   apr_est - a_es + 1);

    /* sequence_on_gen = donor suffix + intron prefix + intron suffix +
     * acceptor prefix */
    m += ri_substr(ri_seq_gen + m, gen, gen_len, dsl_gen,
                   d_ge - dsl_gen + 1);
    m += ri_substr(ri_seq_gen + m, gen, gen_len, d_ge + 1, sp_intron);
    m += ri_substr(ri_seq_gen + m, gen, gen_len, a_gs - sp_intron,
                   sp_intron);
    m += ri_substr(ri_seq_gen + m, gen, gen_len, a_gs,
                   apr_gen - a_gs + 1);

    w->n = n;
    w->m = m;
    w->dsl_est = dsl_est;
    w->dsl_gen = dsl_gen;
    w->deleted_intron_dim = a_gs - d_ge - 1 - 2 * sp_intron;
    return 1;
}

/* Everything refine_intron_core does AFTER the gap alignment: splice
 * re-placement via shifts/Burset and the accept/reject rules
 * (refine-intron.c:47-265 below the DP).  est_al/gen_al/out7 come
 * either from gap_align_run (host) or from the device traceback decode
 * (ri_decode_ops behind the lookaside) — byte-identical by
 * construction. */
static int64_t ri_post_align(
    const char *gen, int64_t gen_len, const char *est, int64_t est_len,
    int64_t d_es, int64_t d_gs, int64_t d_ge,
    int64_t a_ee, int64_t a_gs, int64_t a_ge, const ri_win *w,
    char *est_al, char *gen_al, const int64_t *out7,
    int64_t min_intron_length, int64_t first_intron, int64_t *out4) {
    int64_t o3[3];
    ri_al_t al;
    int64_t final0, final1, final2;
    int ok;

    /* the shift-table rows hold alignment-derived substrings in fixed
     * buffers; outsized alignments fall back to the python path */
    if (out7[0] >= RI_STR_CAP) return -1;

    al.est_al = est_al; al.gen_al = gen_al; al.alen = out7[0];
    al.isa = out7[4]; al.iea = out7[5];
    al.nafl = w->dsl_est + out7[1];
    al.ndrg = w->dsl_gen + out7[2] - 1;
    al.nalg = w->dsl_gen + out7[3] + w->deleted_intron_dim + 1;

    if (al.nafl == d_es) {
        if (first_intron) {
            out4[1] = al.nalg;
            out4[2] = al.nafl;
            return 1;
        }
        return 0;
    }

    if (al.nalg - al.ndrg < min_intron_length) return 0;

    {
        int64_t drs = al.ndrg - d_ge; if (drs < 0) drs = -drs;
        int64_t als = al.nalg - a_gs; if (als < 0) als = -als;
        if (drs > 20 || als > 20) return 0;
    }

    scan_acceptor_before_left(est_al, gen_al, al.alen, al.isa - 1,
                              'G', 'T', al.isa, o3);
    {
        int64_t left_gcd = o3[1];
        scan_ag_after_right(est_al, gen_al, al.alen, al.iea + 1,
                            al.iea, o3);
        if (left_gcd == 0 && o3[1] == 0) {
            final0 = al.ndrg; final1 = al.nalg; final2 = al.nafl;
            goto mutate;
        }
    }

    { double rt0 = fe_now();
    ok = ri_shift(est, est_len, gen, gen_len, &al, 'G', 'T', 1, 1, o3);
    if (!ok) ok = ri_shift(est, est_len, gen, gen_len, &al, 'G', 'T',
                           1, 0, o3);
    if (!ok) ok = ri_shift(est, est_len, gen, gen_len, &al, 'G', 'C',
                           2, 1, o3);
    if (!ok) ok = ri_shift(est, est_len, gen, gen_len, &al, 'G', 'C',
                           2, 0, o3);
    if (!ok)
        ri_try_burset(est, est_len, gen, gen_len, al.nafl, al.ndrg,
                      al.nalg, d_es, a_ee, o3);
    ri_stats[1] += fe_now() - rt0; }
    final0 = o3[0]; final1 = o3[1]; final2 = o3[2];
    if (final1 > a_ge || final0 < d_gs) return 0;

mutate:
    out4[0] = final0;
    out4[1] = final1;
    out4[2] = final2;
    return 2;
}

/* ---- device-result lookaside --------------------------------------------
 * The intron-refinement chains are sequential (each refinement rewrites
 * the next pair's coordinates), but the DP WINDOWS of later pairs are
 * (almost always) independent of earlier results: a refinement moves
 * only the shared factor's start coordinates, which enter the window
 * construction only when the factor is shorter than the suffix/prefix
 * span.  The collect pass therefore emits every un-memoized pair's
 * windows speculatively in ONE round; the device evaluates the batch;
 * the results are installed here keyed by WINDOW BYTES; and
 * refine_intron_core consults the table lazily when the real cascade
 * reaches each pair with its true coordinates — window hit: decode the
 * device traceback (bit-identical); miss (mutated small factor):
 * compute on host.  Either way the outcome is byte-identical. */
typedef struct {
    const int64_t *recs;          /* 13-int64 collect records */
    const char *arena;            /* window bytes */
    const int64_t *sm0s, *nsteps;
    const int8_t *ops;
    int64_t stride, nrec;
    int32_t *htab;                /* open addressing, entry = rec idx+1 */
    int64_t hcap;                 /* power of two */
} ri_look_t;
static ri_look_t ri_look;

static uint64_t ri_hash_win(const char *e, int64_t n, const char *g,
                            int64_t m) {
    uint64_t h = 1469598103934665603ull;
    int64_t i;
    for (i = 0; i < n; i++) h = (h ^ (uint8_t)e[i]) * 1099511628211ull;
    h = (h ^ 0xff) * 1099511628211ull;
    for (i = 0; i < m; i++) h = (h ^ (uint8_t)g[i]) * 1099511628211ull;
    return h;
}

void ri_lookaside_clear(void) {
    free(ri_look.htab);
    memset(&ri_look, 0, sizeof(ri_look));
}

/* Install device results (caller keeps all arrays alive until
 * ri_lookaside_clear).  Returns 0, or -1 on allocation failure (the
 * table stays empty: every lookup misses, host computes). */
int64_t ri_lookaside_set(const int64_t *recs, int64_t nrec,
                         const char *arena,
                         const int64_t *sm0s, const int8_t *ops,
                         const int64_t *nsteps, int64_t stride) {
    int64_t i, cap = 16;
    ri_lookaside_clear();
    while (cap < 4 * nrec) cap <<= 1;
    ri_look.htab = (int32_t *)calloc((size_t)cap, sizeof(int32_t));
    if (!ri_look.htab) return -1;
    ri_look.hcap = cap;
    ri_look.recs = recs;
    ri_look.arena = arena;
    ri_look.sm0s = sm0s;
    ri_look.ops = ops;
    ri_look.nsteps = nsteps;
    ri_look.stride = stride;
    ri_look.nrec = nrec;
    for (i = 0; i < nrec; i++) {
        const int64_t *rec = recs + 13 * i;
        uint64_t h = ri_hash_win(arena + rec[9], rec[10],
                                 arena + rec[11], rec[12]);
        int64_t idx = (int64_t)(h & (uint64_t)(cap - 1));
        while (ri_look.htab[idx]) idx = (idx + 1) & (cap - 1);
        ri_look.htab[idx] = (int32_t)(i + 1);
    }
    return 0;
}

static int64_t ri_lookaside_find(const char *e, int64_t n, const char *g,
                                 int64_t m) {
    uint64_t h;
    int64_t idx;
    if (!ri_look.htab) return -1;
    h = ri_hash_win(e, n, g, m);
    idx = (int64_t)(h & (uint64_t)(ri_look.hcap - 1));
    while (ri_look.htab[idx]) {
        const int64_t *rec = ri_look.recs
                             + 13 * (ri_look.htab[idx] - 1);
        if (rec[10] == n && rec[12] == m
            && memcmp(ri_look.arena + rec[9], e, (size_t)n) == 0
            && memcmp(ri_look.arena + rec[11], g, (size_t)m) == 0)
            return ri_look.htab[idx] - 1;
        idx = (idx + 1) & (ri_look.hcap - 1);
    }
    return -1;
}

/* Decode one device traceback (batch_gap_traceback op codes) into
 * ri_est_al/ri_gen_al + the out7 block, replicating gap_align_run's
 * walk exactly (same buffers, same jump bookkeeping).  Caller must
 * have built the windows (ri_seq_est/ri_seq_gen) and reserved the
 * alignment buffers. */
static void ri_decode_ops(int64_t n, int64_t m, int64_t sm_start,
                          const int8_t *op, int64_t nst, int64_t stride,
                          int64_t *out7) {
    int64_t i = n, j = m, sm = sm_start, cap2 = n + m, w2 = cap2, k;
    int64_t jump_w[2]; int64_t njump = 0;
    int64_t factor_cut = 0, intron_start = 0, intron_end = 0;
    int64_t is_al = 0, ie_al = 0, total;
    for (k = 0; k < nst && k < stride; k++) {
        int d = op[k];
        w2--;
        if (d == 0) {
            ri_est_al[w2] = ri_seq_est[i - 1];
            ri_gen_al[w2] = ri_seq_gen[j - 1];
            i--; j--;
        } else if (d == 1) {
            ri_est_al[w2] = ri_seq_est[i - 1];
            ri_gen_al[w2] = '-';
            i--;
        } else {
            if (d == 3) {
                if (sm == 2) { intron_end = j - 1; factor_cut = i; }
                else intron_start = j - 1;
                sm--;
                if (njump < 2) jump_w[njump++] = w2;
            }
            ri_est_al[w2] = '-';
            ri_gen_al[w2] = ri_seq_gen[j - 1];
            j--;
        }
    }
    while (i > 0) {
        w2--;
        ri_est_al[w2] = ri_seq_est[i - 1];
        ri_gen_al[w2] = '-';
        i--;
    }
    while (j > 0) {
        w2--;
        ri_est_al[w2] = '-';
        ri_gen_al[w2] = ri_seq_gen[j - 1];
        j--;
    }
    total = cap2 - w2;
    if (w2 > 0) {
        memmove(ri_est_al, ri_est_al + w2, (size_t)total);
        memmove(ri_gen_al, ri_gen_al + w2, (size_t)total);
    }
    if (sm_start == 2) {
        if (njump >= 1) ie_al = jump_w[0] - w2;
        if (njump >= 2) is_al = jump_w[1] - w2;
    } else if (sm_start == 1) {
        if (njump >= 1) is_al = jump_w[0] - w2;
    }
    out7[0] = total;
    out7[1] = factor_cut;
    out7[2] = intron_start;
    out7[3] = intron_end;
    out7[4] = is_al;
    out7[5] = ie_al;
    out7[6] = sm_start;
}

int64_t refine_intron_core(
    const char *gen, int64_t gen_len, const char *est, int64_t est_len,
    int64_t d_es, int64_t d_ee, int64_t d_gs, int64_t d_ge,
    int64_t a_es, int64_t a_ee, int64_t a_gs, int64_t a_ge,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen,
    int64_t min_intron_length, int64_t first_intron, int64_t *out4) {
    ri_win w;
    int64_t out7[8];

    if (!ri_build_windows(gen, gen_len, est, est_len,
                          d_es, d_ee, d_gs, d_ge, a_es, a_ee, a_gs, a_ge,
                          sp_est, sp_intron, sp_gen, &w))
        return -1;
    if (!ri_al_reserve(w.n + w.m)) return -1;

    {
        int64_t li = ri_lookaside_find(ri_seq_est, w.n, ri_seq_gen, w.m);
        if (li >= 0) {
            /* device-evaluated gap alignment: decode the op stream */
            ri_decode_ops(w.n, w.m, ri_look.sm0s[li],
                          ri_look.ops + li * ri_look.stride,
                          ri_look.nsteps[li], ri_look.stride, out7);
            ri_stats[4] += 1.0;
        } else {
            double rt0 = fe_now();
            gap_align_run(ri_seq_est, w.n, ri_seq_gen, w.m,
                          ri_est_al, ri_gen_al, out7);
            ri_stats[0] += fe_now() - rt0; ri_stats[4] += 1.0;
            if (out7[0] < 0) return -1;
        }
    }

    return ri_post_align(gen, gen_len, est, est_len,
                         d_es, d_gs, d_ge, a_ee, a_gs, a_ge, &w,
                         ri_est_al, ri_gen_al, out7,
                         min_intron_length, first_intron, out4);
}

/* ======================================================================
 * Full per-EST post-MEG processing: candidate enumeration -> filter
 * cascade -> coverage/gap filters -> intron refinement -> polyA ->
 * refinement pass -> final dedup, all in one native call.
 *
 * Exact semantics of the host pipeline modules (which in turn rebuild
 * the reference):
 *   pintron_tpu/stages/est_fact.py:get_est_factorizations
 *     (est-factorizations.c:126-594)
 *   pintron_tpu/factorize/filters.py (est-factorizations.c:1136-2330)
 *   pintron_tpu/factorize/refinement.py (factorization-refinement.c)
 *   pintron_tpu/factorize/polya.py (detect-polya.c)
 *   pintron_tpu/factorize/classify.py (classify-intron.c:95-229)
 * ====================================================================== */

#include <math.h>

#include "pwm_tables.h"

/* ---- dynamic factor containers ---------------------------------------- */

typedef struct { int64_t es, ee, gs, ge; } efac;
typedef struct {
    efac *f; int64_t n, cap;
    int64_t polya, polyad;
} efct;
typedef struct { efct *a; int64_t n, cap; } eflst;

static int efct_reserve(efct *v, int64_t need) {
    if (need <= v->cap) return 1;
    {
        int64_t nc = v->cap ? v->cap : 8;
        efac *nd;
        while (nc < need) nc *= 2;
        nd = (efac *)realloc(v->f, (size_t)nc * sizeof(efac));
        if (!nd) return 0;
        v->f = nd; v->cap = nc;
    }
    return 1;
}

static int efct_push(efct *v, efac x) {
    if (!efct_reserve(v, v->n + 1)) return 0;
    v->f[v->n++] = x;
    return 1;
}

static int efct_insert(efct *v, int64_t at, efac x) {
    if (!efct_reserve(v, v->n + 1)) return 0;
    memmove(v->f + at + 1, v->f + at, (size_t)(v->n - at) * sizeof(efac));
    v->f[at] = x;
    v->n++;
    return 1;
}

static void efct_del(efct *v, int64_t at) {
    memmove(v->f + at, v->f + at + 1, (size_t)(v->n - at - 1) * sizeof(efac));
    v->n--;
}

static void efct_free(efct *v) { free(v->f); v->f = NULL; v->n = v->cap = 0; }

static int eflst_push(eflst *l, efct v) {      /* moves ownership */
    if (l->n == l->cap) {
        int64_t nc = l->cap ? l->cap * 2 : 8;
        efct *nd = (efct *)realloc(l->a, (size_t)nc * sizeof(efct));
        if (!nd) return 0;
        l->a = nd; l->cap = nc;
    }
    l->a[l->n++] = v;
    return 1;
}

static void eflst_del(eflst *l, int64_t at) {  /* frees the entry */
    efct_free(&l->a[at]);
    memmove(l->a + at, l->a + at + 1, (size_t)(l->n - at - 1) * sizeof(efct));
    l->n--;
}

static void eflst_free(eflst *l) {
    int64_t k;
    for (k = 0; k < l->n; k++) efct_free(&l->a[k]);
    free(l->a);
    l->a = NULL; l->n = l->cap = 0;
}

/* ---- string helpers ---------------------------------------------------- */

/* python s[a:b] semantics (negative indices wrap); the result is always a
 * contiguous span, returned as (pointer, length) */
static int64_t py_slice(const char *s, int64_t len, int64_t a, int64_t b,
                        const char **out) {
    if (a < 0) { a += len; if (a < 0) a = 0; }
    if (b < 0) { b += len; if (b < 0) b = 0; }
    if (a > len) a = len;
    if (b > len) b = len;
    *out = s + a;
    return b > a ? b - a : 0;
}

/* util.c real_substring semantics as (pointer, length) */
static int64_t rs_sub(const char *s, int64_t slen, int64_t index,
                      int64_t length, const char **out) {
    if (index < 0) { length += index; index = 0; }
    if (length <= 0) { *out = s; return 0; }
    if (index > slen) index = slen;
    if (index + length > slen) length = slen - index;
    *out = s + index;
    return length > 0 ? length : 0;
}

/* grow-once char scratch keyed by slot (single-threaded per process) */
static char *ep_cbuf(int slot, int64_t need) {
    static char *bufs[8];
    static int64_t caps[8];
    if (need > caps[slot]) {
        char *nb = (char *)realloc(bufs[slot], (size_t)(2 * need + 64));
        if (!nb) return NULL;
        bufs[slot] = nb;
        caps[slot] = 2 * need + 64;
    }
    return bufs[slot];
}

/* phase-time counters (seconds), for profiling via ep_get_stats:
 * 0 collect, 1 cascade, 2 filters, 3 refine_intron, 4 polyA,
 * 5 false-small, 6 new-small, 7 clean+final */
static double ep_stats[16];
void ri_get_stats(double *out8) { memcpy(out8, ri_stats, sizeof(ri_stats)); }
void ri_reset_stats(void) { memset(ri_stats, 0, sizeof(ri_stats)); }
void ep_get_stats(double *out16) {
    int i;
    for (i = 0; i < 16; i++) out16[i] = ep_stats[i];
}
void ep_reset_stats(void) {
    int i;
    for (i = 0; i < 16; i++) ep_stats[i] = 0.0;
}

/* ---- per-call coordinate-keyed memo ------------------------------------
 * Within one est_process call the gen/est sequences are fixed, so pure
 * helpers keyed by factor coordinates (NW endpoint handling, k-band,
 * dust, intron refinement, intron classification) can be memoized across
 * candidate factorizations -- the same role the host path's lru_caches
 * play.  Open addressing, generation-stamped clearing. */

#define EPM_BITS 18
#define EPM_CAP (1LL << EPM_BITS)

typedef struct {
    uint64_t k[7];
    int64_t v[5];
    uint32_t gen;
    uint8_t used;
} epm_ent;

static epm_ent *epm_tab = NULL;
static uint32_t epm_gen = 0;
static int64_t epm_fill = 0;

static void epm_wipe(void) {
    epm_gen++;
    epm_fill = 0;
    ep_nw_wipes++;
}

/* ---- persistent sequence registry --------------------------------------
 * The memo survives across est_process calls: entries are keyed by an
 * exact (est, est_orig) identity id, valid for the current genomic
 * sequence (a gen change wipes everything).  Identity is exact -- a hash
 * prefilter plus full memcmp against a stored copy -- so cache hits are
 * guaranteed bit-identical to recomputation.  This mirrors the host
 * path's lru_caches, which key on the sequence strings themselves. */

#define EPS_BITS 13
#define EPS_CAP (1LL << EPS_BITS)

typedef struct { uint64_t h; int64_t len; char *copy; uint32_t gen; } eps_ent;
static eps_ent eps_tab[EPS_CAP];
static int64_t eps_fill = 0;
static uint32_t eps_gen = 0;

static const char *epm_gen_ptr = NULL;
static int64_t epm_gen_len = -1;
static uint64_t epm_gen_hash = 0;

static uint64_t ep_hash_bytes(const char *s, int64_t n, uint64_t h) {
    int64_t i;
    for (i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static void eps_wipe(void) {
    int64_t i;
    for (i = 0; i < EPS_CAP; i++) {
        if (eps_tab[i].gen == eps_gen && eps_tab[i].copy) {
            free(eps_tab[i].copy);
            eps_tab[i].copy = NULL;
        }
    }
    eps_gen++;
    eps_fill = 0;
}

/* Returns a stable id (1..) for the (est, est_orig) pair, registering it
 * on first sight; wipes all caches when the genomic sequence changes or
 * the registry fills.  Returns 0 when the memo must be bypassed.
 *
 * The (pointer, length) fast path for the genomic sequence relies on a
 * caller contract: the python side keeps the previously-passed gen
 * bytes object alive (_GEN_KEEPALIVE in stages/est_fact.py), so the
 * cached address can never be recycled for different content — a
 * pointer+length match always means the same bytes. */
static uint64_t epm_begin(const char *gen, int64_t glen,
                          const char *est, int64_t elen,
                          const char *est_orig, int64_t eolen) {
    uint64_t h, idx;
    if (!epm_tab)
        epm_tab = (epm_ent *)calloc(EPM_CAP, sizeof(epm_ent));
    if (!epm_tab) return 0;
    if (gen != epm_gen_ptr || glen != epm_gen_len) {
        uint64_t gh = ep_hash_bytes(gen, glen, 1469598103934665603ULL);
        if (glen != epm_gen_len || gh != epm_gen_hash) {
            epm_wipe();
            eps_wipe();
            epm_gen_hash = gh;
        }
        epm_gen_ptr = gen;
        epm_gen_len = glen;
    }
    if (eps_fill > (EPS_CAP * 3) / 4) {
        epm_wipe();
        eps_wipe();
    }
    h = ep_hash_bytes(est, elen, 1469598103934665603ULL);
    h = ep_hash_bytes(est_orig, eolen, h ^ 0x9e3779b97f4a7c15ULL);
    if (h == 0) h = 1;
    idx = h & (EPS_CAP - 1);
    for (;;) {
        eps_ent *e = &eps_tab[idx];
        if (e->gen != eps_gen || !e->copy) {
            char *copy = (char *)malloc((size_t)(elen + eolen + 1));
            if (!copy) return 0;
            memcpy(copy, est, (size_t)elen);
            memcpy(copy + elen, est_orig, (size_t)eolen);
            copy[elen + eolen] = 0;
            if (e->gen == eps_gen && e->copy) free(e->copy);
            e->h = h;
            e->len = elen + eolen;
            e->copy = copy;
            e->gen = eps_gen;
            eps_fill++;
            return idx + 1;
        }
        if (e->h == h && e->len == elen + eolen
            && memcmp(e->copy, est, (size_t)elen) == 0
            && memcmp(e->copy + elen, est_orig, (size_t)eolen) == 0)
            return idx + 1;
        idx = (idx + 1) & (EPS_CAP - 1);
    }
}

/* Wipe the persistent memo/sequence registry.  Benchmarks measuring
 * fresh-locus work call this between repetitions (PINTRON_FRESH_MEMO);
 * the memo otherwise persists by design across runs on the same
 * locus. */
void ep_memo_wipe(void) {
    epm_wipe();
    eps_wipe();
    epm_gen_ptr = NULL;
    epm_gen_len = -1;
    epm_gen_hash = 0;
}

/* id of the (est, est_orig) pair for the current est_process call; 0
 * disables the memo for this call */
static uint64_t epm_seq_id = 0;

/* Returns the entry for key k; *found = 1 when it holds a cached value.
 * Returns NULL when the table is unavailable/full (caller just
 * recomputes without caching). */
static epm_ent *epm_find(const uint64_t k[7], int *found) {
    uint64_t h = 1469598103934665603ULL, idx;
    int i;
    if (!epm_tab || epm_seq_id == 0) { *found = 0; return NULL; }
    if (epm_fill > (EPM_CAP * 3) / 4) epm_wipe();
    for (i = 0; i < 7; i++) { h ^= k[i]; h *= 1099511628211ULL; }
    idx = h & (EPM_CAP - 1);
    for (;;) {
        epm_ent *e = &epm_tab[idx];
        if (!e->used || e->gen != epm_gen) {
            memcpy(e->k, k, sizeof(e->k));
            e->gen = epm_gen;
            e->used = 1;
            epm_fill++;
            *found = 0;
            return e;
        }
        if (memcmp(e->k, k, sizeof(e->k)) == 0) { *found = 1; return e; }
        idx = (idx + 1) & (EPM_CAP - 1);
    }
}

static void epm_key4(uint64_t *k, uint64_t tag, const efac *f) {
    k[0] = tag | (epm_seq_id << 16);
    k[1] = ((uint64_t)(uint32_t)f->es << 32) | (uint32_t)f->ee;
    k[2] = ((uint64_t)(uint32_t)f->gs << 32) | (uint32_t)f->ge;
    k[3] = 0;
    k[4] = 0;
    k[5] = 0;
    k[6] = 0;
}

/* ---- cascade: per-candidate checks (filters.py) ------------------------ */

static int ep_check_not_ss(const efct *f, int64_t est_length) {
    if (f->n > 1) return 1;
    return !(f->f[0].es < 0 || f->f[0].es >= est_length);
}

static int ep_check_exon_start_end(const efct *f) {
    int64_t prev_ee = -1, prev_ge = -1, k;
    for (k = 0; k < f->n; k++) {
        const efac *e = &f->f[k];
        if (e->es > e->ee || e->gs > e->ge) return 0;
        if (e->es < prev_ee || e->gs < prev_ge) return 0;
        prev_ee = e->ee;
        prev_ge = e->ge;
    }
    return 1;
}

/* Endpoint-cut scans over a computed head/tail alignment (the
 * decision halves of filters.py:handle_endpoints /
 * est-factorizations.c:2127-2301), shared by the host path
 * (ep_handle_endpoints) and the device offload fill
 * (epm_fill_endpoints) so both produce bit-identical memo values.
 * out3 = {keep (0/1), new_start_or_end_est, new_start_or_end_gen}. */
static void ep_head_cut(const char *est_al, const char *gen_al,
                        int64_t alen, int64_t es, int64_t gs,
                        int64_t *out3) {
    int64_t j = 0, matches = 0;
    int64_t cut_factor = es, cut_exon = gs;
    int stop = 0;
    while (j < alen && !stop) {
        if (matches > 5) stop = 1;
        else {
            if (est_al[j] == gen_al[j]) {
                cut_factor++; cut_exon++; matches++;
            } else {
                if (est_al[j] != '-') cut_factor++;
                if (gen_al[j] != '-') cut_exon++;
                matches = 0;
            }
            j++;
        }
    }
    if (!stop) {
        out3[0] = 0; out3[1] = 0; out3[2] = 0;
    } else {
        out3[0] = 1;
        out3[1] = cut_factor - matches;
        out3[2] = cut_exon - matches;
    }
}

static void ep_tail_cut(char *est_al, char *gen_al, int64_t alen,
                        int64_t ee0, int64_t ge0, int64_t gs,
                        int64_t *out3) {
    int64_t j = alen - 1, matches = 0;
    int64_t cut_factor = ee0, cut_exon = ge0;
    int stop = 0;
    int64_t est_cleav, gen_cleav, cursor, dim;
    int stop2;
    while (j >= 0 && !stop) {
        if (matches > 10) stop = 1;
        else {
            if (est_al[j] == gen_al[j]) {
                cut_factor--; cut_exon--; matches++;
            } else {
                if (est_al[j] != '-') cut_factor--;
                if (gen_al[j] != '-') cut_exon--;
                matches = 0;
            }
            j--;
        }
    }
    est_cleav = cut_factor + matches;
    gen_cleav = cut_exon + matches;

    cursor = j + matches + 1;
    stop2 = 0;
    dim = alen;
    while (cursor < dim - 1
           && (est_al[cursor] == '-' || gen_al[cursor] == '-')
           && !stop2) {
        if (est_al[cursor] == '-') {
            int64_t t = cursor + 1;
            while (t < dim && est_al[t] == '-') t++;
            if (t < dim) {
                if (est_al[t] == gen_al[cursor]) {
                    est_al[cursor] = est_al[t];
                    est_al[t] = '-';
                    est_cleav++; gen_cleav++;
                } else stop2 = 1;
            } else stop2 = 1;
        } else {
            int64_t t = cursor + 1;
            while (t < dim && gen_al[t] == '-') t++;
            if (t < dim) {
                if (gen_al[t] == est_al[cursor]) {
                    gen_al[cursor] = gen_al[t];
                    gen_al[t] = '-';
                    est_cleav++; gen_cleav++;
                } else stop2 = 1;
            } else stop2 = 1;
        }
        cursor++;
    }
    if (gen_cleav >= gs) {
        out3[0] = 1;
        out3[1] = est_cleav;
        out3[2] = gen_cleav;
    } else {
        out3[0] = 0; out3[1] = 0; out3[2] = 0;
    }
}

/* one memo miss of the endpoint cut (ep_nw_miss) */
static void ep_count_miss(int kind, const char *ee, int64_t eel,
                          const char *ge, int64_t gel) {
    int64_t *c = ep_nw_miss[ep_site][kind];
    c[0]++;
    if (!(eel == gel && memcmp(ee, ge, (size_t)eel) == 0))
        c[1] += (eel + 1) * (gel + 1);
}

/* filters.py:handle_endpoints (est-factorizations.c:2127-2301).
 * Returns 0 on allocation failure. */
static int ep_handle_endpoints(efct *f, const char *gen, int64_t glen,
                               const char *est, int64_t elen) {
    const char *ge, *ee;
    int64_t gel, eel, alen;
    char *est_al, *gen_al;
    int64_t out_len[1];
    efac *head = &f->f[0];
    int tail_kind = f->n == 1 ? 2 : 1;

    {
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found;
        epm_ent *me;
        epm_key4(mk, 1, head);
        me = epm_find(mk, &found);
        if (found) {
            if (me->v[0] == 0) efct_del(f, 0);
            else { head->es = me->v[1]; head->gs = me->v[2]; }
        } else {
            gel = rs_sub(gen, glen, head->gs, head->ge - head->gs + 1, &ge);
            eel = rs_sub(est, elen, head->es, head->ee - head->es + 1, &ee);
            ep_count_miss(0, ee, eel, ge, gel);
            est_al = ep_cbuf(0, eel + gel + 8);
            gen_al = ep_cbuf(1, eel + gel + 8);
            if (!est_al || !gen_al) {
                if (me) me->gen = epm_gen - 1;   /* un-claim: no value */
                return 0;
            }
            if (nw_align_run(ee, eel, ge, gel, est_al, gen_al,
                             out_len) < 0) {
                if (me) me->gen = epm_gen - 1;
                return 0;
            }
            alen = out_len[0];
            {
                int64_t out3[3];
                ep_head_cut(est_al, gen_al, alen, head->es, head->gs,
                            out3);
                if (!out3[0]) {
                    if (me) me->v[0] = 0;
                    efct_del(f, 0);
                } else {
                    head->es = out3[1];
                    head->gs = out3[2];
                    if (me) {
                        me->v[0] = 1;
                        me->v[1] = head->es;
                        me->v[2] = head->gs;
                    }
                }
            }
        }
    }
    if (f->n == 0) return 1;

    {
        efac *tail = &f->f[f->n - 1];
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found;
        epm_ent *me;
        epm_key4(mk, 2, tail);
        me = epm_find(mk, &found);
        if (found) {
            if (me->v[0] == 0) f->n--;
            else { tail->ee = me->v[1]; tail->ge = me->v[2]; }
            return 1;
        }
        gel = rs_sub(gen, glen, tail->gs, tail->ge - tail->gs + 1, &ge);
        eel = rs_sub(est, elen, tail->es, tail->ee - tail->es + 1, &ee);
        ep_count_miss(tail_kind, ee, eel, ge, gel);
        est_al = ep_cbuf(0, eel + gel + 8);
        gen_al = ep_cbuf(1, eel + gel + 8);
        if (!est_al || !gen_al) {
            if (me) me->gen = epm_gen - 1;
            return 0;
        }
        if (nw_align_run(ee, eel, ge, gel, est_al, gen_al, out_len) < 0) {
            if (me) me->gen = epm_gen - 1;
            return 0;
        }
        alen = out_len[0];
        {
            int64_t out3[3];
            ep_tail_cut(est_al, gen_al, alen, tail->ee, tail->ge,
                        tail->gs, out3);
            if (out3[0]) {
                tail->ee = out3[1];
                tail->ge = out3[2];
                if (me) {
                    me->v[0] = 1;
                    me->v[1] = tail->ee;
                    me->v[2] = tail->ge;
                }
            } else {
                if (me) me->v[0] = 0;
                f->n--;     /* pop the tail */
            }
        }
    }
    return 1;
}

static int ep_upper_is(char c, char up) {
    return c == up || c == (char)(up - 'A' + 'a');
}

static char ep_gch(const char *gen, int64_t glen, int64_t idx) {
    return (idx >= 0 && idx < glen) ? gen[idx] : '\0';
}

/* filters.py:clean_external_exons (est-factorizations.c:1706-1825) */
static void ep_clean_external(efct *f, const char *gen, int64_t glen,
                              const char *est, int64_t elen) {
    if (f->n == 0) return;
    {
        efac head = f->f[0];
        int64_t head_length = head.ge - head.gs + 1;
        int head_ok = 1;
        efct_del(f, 0);
        if (head_length < 10) head_ok = 0;
        if (head_ok && head_length < 20) {
            if (!ep_upper_is(ep_gch(gen, glen, head.ge + 1), 'G'))
                head_ok = 0;
            else {
                char c2 = ep_gch(gen, glen, head.ge + 2);
                if (!(ep_upper_is(c2, 'T') || ep_upper_is(c2, 'C')))
                    head_ok = 0;
                else {
                    if (f->n >= 1) {
                        efac *nxt = &f->f[0];
                        if (!ep_upper_is(ep_gch(gen, glen, nxt->gs - 2), 'A'))
                            head_ok = 0;
                        else if (!ep_upper_is(ep_gch(gen, glen, nxt->gs - 1),
                                              'G'))
                            head_ok = 0;
                    } else head_ok = 0;
                }
            }
            if (head_ok) {
                const char *gx, *ex;
                int64_t gl = rs_sub(gen, glen, head.gs, head_length, &gx);
                int64_t el = rs_sub(est, elen, head.es,
                                    head.ee - head.es + 1, &ex);
                if (edit_total(gx, gl, ex, el) > 0) head_ok = 0;
            }
        }
        if (head_ok) efct_insert(f, 0, head);
    }
    if (f->n == 0) return;
    {
        efac tail = f->f[f->n - 1];
        int64_t tail_length = tail.ge - tail.gs + 1;
        int tail_ok = 1;
        f->n--;
        if (tail_length < 10) tail_ok = 0;
        if (tail_ok && tail_length < 20) {
            if (!ep_upper_is(ep_gch(gen, glen, tail.gs - 2), 'A'))
                tail_ok = 0;
            else if (!ep_upper_is(ep_gch(gen, glen, tail.gs - 1), 'G'))
                tail_ok = 0;
            else {
                if (f->n >= 1) {
                    efac *prev = &f->f[f->n - 1];
                    if (!ep_upper_is(ep_gch(gen, glen, prev->ge + 1), 'G'))
                        tail_ok = 0;
                    else {
                        char c2 = ep_gch(gen, glen, prev->ge + 2);
                        if (!(ep_upper_is(c2, 'T') || ep_upper_is(c2, 'C')))
                            tail_ok = 0;
                    }
                } else tail_ok = 0;
            }
            if (tail_ok) {
                const char *gx, *ex;
                int64_t gl = rs_sub(gen, glen, tail.gs, tail_length, &gx);
                int64_t el = rs_sub(est, elen, tail.es,
                                    tail.ee - tail.es + 1, &ex);
                if (edit_total(gx, gl, ex, el) > 0) tail_ok = 0;
            }
        }
        if (tail_ok) efct_push(f, tail);
    }
}

/* filters.py:update_with_subfact_with_best_coverage
 * (est-factorizations.c:1900-1987); split entries are 1-based indices. */
static void ep_update_best_cov(efct *f, const int64_t *split,
                               int64_t nsplit) {
    int64_t best_left = -1, best_right = -1, best_cover = -1;
    int64_t size = f->n, pos = 0, left_index = 1, si;
    if (nsplit == 0) return;
    for (si = 0; si < nsplit; si++) {
        int64_t right_index = split[si];
        efac *left_exon = &f->f[pos];
        efac *right_exon;
        pos++;
        right_exon = left_exon;
        if (left_index < right_index) {
            int64_t times = right_index - left_index - 1;
            int64_t cover;
            while (times > 0) {
                right_exon = &f->f[pos];
                pos++;
                times--;
            }
            cover = right_exon->ee - left_exon->es + 1;
            if (cover > best_cover) {
                best_left = left_index;
                best_right = right_index - 1;
                best_cover = cover;
            }
            pos++;  /* skip the bad exon */
        }
        left_index = right_index + 1;
    }
    if (left_index <= size) {
        efac *left_exon = &f->f[pos];
        efac *right_exon = left_exon;
        int64_t times = size - left_index, cover;
        pos++;
        while (times > 0) {
            right_exon = &f->f[pos];
            pos++;
            times--;
        }
        cover = right_exon->ee - left_exon->es + 1;
        if (cover > best_cover) {
            best_left = left_index;
            best_right = size;
            best_cover = cover;
        }
    }
    if (best_left == -1 || best_right == -1) {
        f->n = 0;
    } else {
        /* del f[:best_left-1]; del f[best_right-(best_left-1):] */
        int64_t drop_head = best_left - 1;
        int64_t keep = best_right - drop_head;
        memmove(f->f, f->f + drop_head,
                (size_t)(f->n - drop_head) * sizeof(efac));
        f->n -= drop_head;
        if (keep < f->n) f->n = keep;
    }
}

/* filters.py:clean_low_complexity_exons_2 */
static void ep_clean_low_complexity(efct *f, const char *gen, int64_t glen,
                                    const char *est, int64_t elen,
                                    double thr) {
    int64_t *split = (int64_t *)malloc((size_t)(f->n + 1) * sizeof(int64_t));
    int64_t nsplit = 0, k;
    if (!split) return;
    for (k = 0; k < f->n; k++) {
        efac *e = &f->f[k];
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found, bad;
        epm_ent *me;
        epm_key4(mk, 5, e);
        me = epm_find(mk, &found);
        if (found) bad = (int)me->v[0];
        else {
            double gd = 0.0, ed = 0.0;
            if (e->gs <= e->ge) {
                const char *sub;
                int64_t sl = py_slice(gen, glen, e->gs, e->ge + 1, &sub);
                gd = dust_score_c(sub, sl);
                sl = py_slice(est, elen, e->es, e->ee + 1, &sub);
                ed = dust_score_c(sub, sl);
            }
            bad = (gd > thr || ed > thr);
            if (me) me->v[0] = bad;
        }
        if (bad) split[nsplit++] = k + 1;
    }
    ep_update_best_cov(f, split, nsplit);
    free(split);
}

/* alignments.py:k_band_edit_distance wrapper semantics; returns the edit
 * (or a value > ub when the early-exits fire), *ok set. */
static int64_t ep_kband(const char *s1, int64_t l1, const char *s2,
                        int64_t l2, int64_t ub, int *ok) {
    const char *a = s1, *b = s2;
    int64_t n = l1, m = l2, r;
    if (l1 == l2 && memcmp(s1, s2, (size_t)l1) == 0) { *ok = 1; return 0; }
    if (ub == 0) { *ok = 0; return 1; }
    if (n < m) { a = s2; b = s1; n = l2; m = l1; }
    if (n - m > ub) { *ok = 0; return n - m; }
    if (2 * ub + 1 >= n) {
        r = edit_total(a, n, b, m);
        *ok = r <= ub;
        return r;
    }
    r = kband_core(a, n, b, m, ub);
    *ok = (r >= 0 && r <= ub);
    return r;
}

/* filters.py:compute_max_edit_for_exon */
static int64_t ep_max_edit(int64_t exon_length) {
    double rate;
    double v;
    if (exon_length > 100) rate = 0.030;
    else if (exon_length > 50) rate = 0.035;
    else rate = 0.040;
    v = (double)exon_length * rate;
    v = ceil(v);
    if (v < 1.0) v = 1.0;
    return (int64_t)v;
}

/* filters.py:clean_noisy_exons (only_internals always 0 in the flow) */
static void ep_clean_noisy(efct *f, const char *gen, int64_t glen,
                           const char *est, int64_t elen, int seqtag) {
    int64_t *split = (int64_t *)malloc((size_t)(f->n + 1) * sizeof(int64_t));
    int64_t nsplit = 0, k;
    if (!split) return;
    for (k = 0; k < f->n; k++) {
        efac *e = &f->f[k];
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found, ok = 0;
        epm_ent *me;
        epm_key4(mk, 4 | ((uint64_t)seqtag << 8), e);
        me = epm_find(mk, &found);
        if (found) ok = (int)me->v[0];
        else {
            int64_t exon_length = e->ge - e->gs + 1;
            int64_t max_err = ep_max_edit(exon_length);
            if (e->gs <= e->ge) {
                const char *gx, *ex;
                int64_t gl = rs_sub(gen, glen, e->gs, exon_length, &gx);
                int64_t el = rs_sub(est, elen, e->es, e->ee - e->es + 1, &ex);
                ep_kband(gx, gl, ex, el, max_err, &ok);
            }
            if (me) me->v[0] = ok;
        }
        if (!ok) split[nsplit++] = k + 1;
    }
    ep_update_best_cov(f, split, nsplit);
    free(split);
}

static int ep_check_coverage(const efct *f, int64_t est_len) {
    double coverage = (double)(f->f[f->n - 1].ee - f->f[0].es + 1)
                      / (double)est_len;
    return coverage >= 0.35;
}

/* ---- relaxed comparisons (filters.py:359-541; list.c) ------------------ */

static int64_t ep_iabs(int64_t x) { return x < 0 ? -x : x; }

/* filters.py:relaxed_factor_compare.  0 == equal under the mode. */
static int ep_relaxed_factor_cmp(const efac *p1, const efac *p2,
                                 int cfr_type, int64_t allowed_diff,
                                 const efct *l1) {
    int64_t max_unconf_diff = 20;
    if (p1->gs < p2->gs && p1->ge < p2->gs) return 1;
    if (p2->gs < p1->gs && p2->ge < p1->gs) return 1;

    if (cfr_type == 0) {
        if (ep_iabs(p1->ge - p2->ge) <= allowed_diff
            && ep_iabs(p1->gs - p2->gs) <= allowed_diff)
            return 0;
    }
    if (cfr_type == 2 || cfr_type == -2) {
        if (ep_iabs(p1->ge - p2->ge) <= allowed_diff) {
            if (cfr_type == 2) {
                if (p1->gs - p2->gs > max_unconf_diff) return 1;
                if (p1->gs - p2->gs > 0) {
                    int64_t tot_l = 0, k;
                    for (k = 0; k < l1->n; k++) {
                        if (p1->gs == l1->f[k].gs) break;
                        tot_l += l1->f[k].ge - l1->f[k].gs + 1;
                    }
                    if (ep_iabs(p1->gs - p2->gs - tot_l) < 10) return 1;
                }
            }
            return 0;
        }
    }
    if (cfr_type == 1 || cfr_type == -1) {
        if (ep_iabs(p1->gs - p2->gs) <= allowed_diff) {
            if (cfr_type == 1) {
                if (p2->ge - p1->ge > max_unconf_diff) return 1;
                if (p2->ge - p1->ge > 0) {
                    int64_t tot_l = 0, k;
                    for (k = l1->n - 1; k >= 0; k--) {
                        if (p1->gs == l1->f[k].gs) break;
                        tot_l += l1->f[k].ge - l1->f[k].gs + 1;
                    }
                    if (ep_iabs(p2->ge - p1->ge - tot_l) < 20) return 1;
                }
            }
            return 0;
        }
    }
    return 1;
}

/* filters.py:relaxed_list_compare.  -2 == equal, else 0. */
static int ep_relaxed_list_cmp(const efct *l1, const efct *l2,
                               int64_t allowed_diff) {
    int64_t size = l1->n, k;
    if (l1->n != l2->n || l1->n == 1) return 0;
    for (k = 0; k < size; k++) {
        int cfr_type;
        int64_t actual;
        if (allowed_diff == -1) { cfr_type = 0; actual = 0; }
        else {
            actual = allowed_diff;
            if (k == 0) cfr_type = -2;
            else if (k == size - 1) cfr_type = -1;
            else cfr_type = 0;
        }
        if (ep_relaxed_factor_cmp(&l1->f[k], &l2->f[k], cfr_type, actual,
                                  l1) != 0)
            return 0;
    }
    return -2;
}

/* filters.py:relaxed_list_contained.  -2 equal; -1 l1 in l2; 1 l2 in l1;
 * 0 neither. */
static int ep_relaxed_contained(const efct *l1, const efct *l2,
                                int64_t allowed_diff) {
    const efct *longer, *shorter;
    int sign;
    int64_t actual, i_long, count_long, i_short, count_factors;
    int cfr_type, found, stop;
    if (l1->n == l2->n) return ep_relaxed_list_cmp(l1, l2, allowed_diff);
    if (l1->n == 1 || l2->n == 1) return 0;
    actual = allowed_diff == -1 ? 0 : allowed_diff;
    if (l1->n > l2->n) { longer = l1; shorter = l2; sign = 1; }
    else { longer = l2; shorter = l1; sign = -1; }

    cfr_type = allowed_diff == -1 ? 0 : -2;
    found = 0;
    count_long = 1;
    i_long = 0;
    while (i_long < longer->n && !found) {
        if (ep_relaxed_factor_cmp(&longer->f[i_long], &shorter->f[0],
                                  cfr_type, actual, longer) == 0)
            found = 1;
        else
            count_long++;
        i_long++;
        if (cfr_type == -2) cfr_type = 2;
    }
    if (!found) return 0;

    i_short = 1;
    count_factors = 1;
    stop = 0;
    while (i_long < longer->n && i_short < shorter->n && !stop) {
        if (allowed_diff == -1) cfr_type = 0;
        else {
            if (count_factors + 1 == shorter->n)
                cfr_type = (count_long + 1 == longer->n) ? -1 : 1;
            else
                cfr_type = 0;
        }
        if (ep_relaxed_factor_cmp(&longer->f[i_long], &shorter->f[i_short],
                                  cfr_type, actual, longer) == 0) {
            i_long++;
            i_short++;
        } else stop = 1;
        count_factors++;
        count_long++;
    }
    if (stop) return 0;
    if (count_factors == shorter->n) return sign;
    return 0;
}

/* filters.py:add_if_not_exists.  On *added the efct moves into the list;
 * otherwise the caller still owns it.  Returns 0 on alloc failure. */
static int ep_add_if_not_exists(eflst *lst, efct *fact,
                                int64_t allowed_diff, int *added) {
    int found = 0;
    int64_t k = 0;
    while (k < lst->n && !found) {
        efct *cmp_f = &lst->a[k];
        int cont_result;
        if (cmp_f->n == 1 && fact->n == 1) {
            const efac *h1 = &fact->f[0], *h2 = &cmp_f->f[0];
            if (h1->gs == h2->gs && h1->ge == h2->ge) cont_result = -2;
            else if (h1->gs >= h2->gs && h1->ge <= h2->ge) cont_result = -1;
            else if (h1->gs <= h2->gs && h1->ge >= h2->ge) cont_result = 1;
            else cont_result = 0;
        } else {
            cont_result = ep_relaxed_contained(fact, cmp_f, allowed_diff);
        }
        if (cont_result < 0) {
            if (cont_result == -2) {
                const efac *h1 = &fact->f[0];
                efac *h2 = &cmp_f->f[0];
                const efac *t1 = &fact->f[fact->n - 1];
                efac *t2 = &cmp_f->f[cmp_f->n - 1];
                if (h1->es < h2->es) { h2->es = h1->es; h2->gs = h1->gs; }
                if (t1->ee > t2->ee) { t2->ee = t1->ee; t2->ge = t1->ge; }
            }
            found = 1;
        } else {
            if (cont_result == 1) {
                eflst_del(lst, k);
                continue;
            }
        }
        k++;
    }
    if (!found) {
        if (!eflst_push(lst, *fact)) return 0;
        fact->f = NULL; fact->n = fact->cap = 0;   /* moved */
        *added = 1;
    } else {
        *added = 0;
    }
    return 1;
}

/* ---- coverage / gap-length helpers -------------------------------------- */

static double ep_coverage(const efct *f, int64_t length) {
    int64_t cover = length - (f->f[0].es + (length - f->f[f->n - 1].ee - 1));
    return (double)cover / (double)length;
}

static int64_t ep_gap_length(const efct *f) {
    int64_t total = 0, k;
    if (f->n == 1) return 0;
    for (k = 0; k < f->n - 1; k++)
        total += f->f[k + 1].es - f->f[k].ee - 1;
    return total;
}

/* filters.py:check_gap_errors (est-factorizations.c:1462-1545) */
static int ep_check_gap_errors(efct *f, const char *est, int64_t elen,
                               const char *gen, int64_t glen) {
    int64_t threshold_ed = 20, tot_ed = 0, k = 0;
    int ok = 1;
    while (k < f->n - 1 && ok) {
        efac *donor = &f->f[k];
        efac *accept = &f->f[k + 1];
        int64_t gap_p = accept->es - donor->ee - 1;
        if (gap_p > 0) {
            int64_t gap_t = accept->gs - donor->ge - 1;
            const char *p, *t;
            int64_t lp = rs_sub(est, elen, donor->ee + 1, gap_p, &p);
            int64_t lt = rs_sub(gen, glen, donor->ge + 1, gap_t, &t);
            int64_t out6[6];
            /* memo (tag 10): keyed on the window-defining coords —
             * donor (ee, ge) and accept (es, gs) fully determine the
             * gap problem, and none of them is mutated by an earlier
             * pair's refinement within this factorization.  Filled
             * ahead by the device offload (epm_fill_rb) or by a
             * previous factorization sharing the pair. */
            uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
            int found = 0;
            epm_ent *me = NULL;
            mk[0] = 10 | (epm_seq_id << 16);
            mk[1] = ((uint64_t)(uint32_t)donor->ee << 32)
                    | (uint32_t)donor->ge;
            mk[2] = ((uint64_t)(uint32_t)accept->es << 32)
                    | (uint32_t)accept->gs;
            if (epm_seq_id != 0 && epm_tab)
                me = epm_find(mk, &found);
            if (found) {
                out6[0] = me->v[0];
                out6[1] = me->v[1];
                out6[2] = me->v[2];
                out6[3] = me->v[3];
                out6[4] = me->v[4];
            } else {
                refine_borders_core(p, lp, 0, lp, t, lt, gap_p, out6);
                if (out6[0] < 0) {
                    if (me) { me->gen = epm_gen - 1; epm_fill--; }
                    return -1;   /* alloc failure: not a verdict */
                }
                if (me) {
                    /* nothing below wipes the memo, so the claimed
                     * slot pointer is still valid */
                    me->v[0] = out6[0];
                    me->v[1] = out6[1];
                    me->v[2] = out6[2];
                    me->v[3] = out6[3];
                    me->v[4] = out6[4];
                }
            }
            ok = out6[0] == 1;
            if (ok) {
                tot_ed += out6[4];
                donor->ee += out6[1];
                accept->es = donor->ee + 1;
                donor->ge += out6[2];
                accept->gs -= gap_t - out6[3];
            }
        }
        k++;
    }
    if (ok && tot_ed > threshold_ed) ok = 0;
    if (ok) {
        k = 0;
        while (k < f->n - 1) {
            efac *d = &f->f[k];
            efac *a = &f->f[k + 1];
            if (a->gs - d->ge - 1 <= 3) {
                d->ee = a->ee;
                d->ge = a->ge;
                efct_del(f, k + 1);
            } else k++;
        }
    }
    return ok;
}

/* refine_intron.py:refine_intron application (mutation rules of
 * _refine_intron_dispatch).  Returns -1 when the native core needs the
 * python fallback (outsized window). */
static int ep_refine_intron(const char *gen, int64_t glen,
                            const char *est, int64_t elen,
                            efac *donor, efac *accept,
                            int64_t sp_est, int64_t sp_intron,
                            int64_t sp_gen, int64_t min_intron,
                            int first_intron) {
    int64_t out4[4];
    int64_t ret;
    uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
    int found;
    epm_ent *me;
    mk[0] = 3 | ((uint64_t)(first_intron ? 1 : 0) << 8)
            | (epm_seq_id << 16);
    mk[1] = ((uint64_t)(uint32_t)donor->es << 32) | (uint32_t)donor->ee;
    mk[2] = ((uint64_t)(uint32_t)donor->gs << 32) | (uint32_t)donor->ge;
    mk[3] = ((uint64_t)(uint32_t)accept->es << 32) | (uint32_t)accept->ee;
    mk[4] = ((uint64_t)(uint32_t)accept->gs << 32) | (uint32_t)accept->ge;
    me = epm_find(mk, &found);
    if (found) {
        ret = me->v[0];
        out4[0] = me->v[1];
        out4[1] = me->v[2];
        out4[2] = me->v[3];
    } else {
        ret = refine_intron_core(
            gen, glen, est, elen,
            donor->es, donor->ee, donor->gs, donor->ge,
            accept->es, accept->ee, accept->gs, accept->ge,
            sp_est, sp_intron, sp_gen, min_intron,
            first_intron ? 1 : 0, out4);
        if (me) {
            me->v[0] = ret;
            me->v[1] = out4[0];
            me->v[2] = out4[1];
            me->v[3] = out4[2];
        }
    }
    if (ret < 0) return -1;
    if (ret == 1) {
        accept->es = out4[2];
        accept->gs = out4[1];
    } else if (ret == 2) {
        donor->ge = out4[0];
        accept->gs = out4[1];
        accept->es = out4[2];
        donor->ee = accept->es - 1;
    }
    return 0;
}

/* ---- polyA (polya.py; detect-polya.c) ----------------------------------- */

static void ep_correct_tail(efct *f, const char *gen, int64_t glen,
                            const char *est_orig, int64_t eolen) {
    efac *tail = &f->f[f->n - 1];
    int64_t i = tail->ee + 1, j = tail->ge + 1;
    while (i < eolen && j < glen && gen[j] == est_orig[i]) { i++; j++; }
    tail->ee = i - 1;
    tail->ge = j - 1;
}

static int ep_is_a(char c) { return c == 'a' || c == 'A'; }

static void ep_detect_polya(const efct *f, const char *gen, int64_t glen,
                            const char *est_orig, int64_t eolen,
                            int64_t *polya, int64_t *polyad) {
    const efac *tail = &f->f[f->n - 1];
    const char *cleav;
    int64_t n = py_slice(est_orig, eolen, tail->ee + 1, eolen, &cleav);
    int64_t i = 0, matches = 0;
    int stop = 0, pdl = 0;

    while (i < n && !stop) {
        if (ep_is_a(cleav[i])) {
            if (matches >= 8) stop = 1;
            else { matches++; i++; }
        } else {
            if (matches >= 8) stop = 1;
            else i = n;
        }
    }

    if (stop) {
        i = tail->ge - 39;
        if (i < 0) i = 0;
        while (i <= tail->ge && !pdl) {
            if (i < glen && ep_is_a(gen[i])) {
                const char *pas;
                int64_t pl = py_slice(gen, glen, i, i + 6, &pas);
                if (pl == 6
                    && (memcmp(pas, "aataaa", 6) == 0
                        || memcmp(pas, "AATAAA", 6) == 0
                        || memcmp(pas, "attaaa", 6) == 0
                        || memcmp(pas, "ATTAAA", 6) == 0))
                    pdl = 1;
            }
            i++;
        }
    }

    if (stop) {
        i = tail->ge - 9;
        if (i < 0) i = 0;
        matches = 0;
        while (i <= tail->ge + 10 && stop && i < glen) {
            if (matches >= 6) stop = 0;
            else {
                if (ep_is_a(gen[i])) matches++;
                else matches = 0;
                i++;
            }
        }
        if (stop) {
            int64_t count = 0;
            i = tail->ge + 1;
            while (i <= tail->ge + 10 && stop && i < glen) {
                if (count >= 7) stop = 0;
                else {
                    if (ep_is_a(gen[i])) count++;
                    i++;
                }
            }
        }
    }
    *polya = stop ? 1 : 0;
    *polyad = pdl ? 1 : 0;
}

/* ---- refinement pass (refinement.py; factorization-refinement.c) ------- */

#define EP_UB_VERY_SMALL 2
#define EP_LB_SMALL 6
#define EP_UB_SMALL 23
#define EP_UB_MED 100
#define EP_AFFIXES 5
#define EP_MAX_ERROR_RATE 0.17
#define EP_MIN_PERFECT_BORDER 6
#define EP_MAX_ERR_SMALL 2

static void ep_remove_very_small(eflst *lst) {
    int64_t k = 0;
    while (k < lst->n) {
        efct *f = &lst->a[k];
        int64_t j;
        int hit = 0;
        for (j = 0; j < f->n; j++)
            if (f->f[j].ee + 1 - f->f[j].es <= EP_UB_VERY_SMALL) {
                hit = 1;
                break;
            }
        if (hit) eflst_del(lst, k);
        else k++;
    }
}

static void ep_remove_invalid(eflst *lst) {
    int64_t k = 0;
    while (k < lst->n) {
        efct *f = &lst->a[k];
        int invalid = 0;
        int64_t j;
        const efac *prev = NULL;
        for (j = 0; j < f->n; j++) {
            const efac *e = &f->f[j];
            if (e->es > e->ee || e->gs > e->ge) { invalid = 1; break; }
            if (prev && (prev->ee >= e->es || prev->ge >= e->gs)) {
                invalid = 1;
                break;
            }
            prev = e;
        }
        if (invalid) eflst_del(lst, k);
        else k++;
    }
}

/* refinement.py:_fact_hash (32-bit rotate; shift 0 keeps h) */
static uint32_t ep_fact_hash(const efct *f) {
    uint32_t h = 1;
    int64_t k;
    for (k = 0; k < f->n; k++) {
        const efac *e = &f->f[k];
        int64_t s = (e->es + e->ee + e->gs + e->ge) % 32;
        uint32_t shift = (uint32_t)(s < 0 ? s + 32 : s);
        if (shift) h = (h >> shift) | (h << (32 - shift));
    }
    return h;
}

static int ep_fact_equal(const efct *a, const efct *b) {
    int64_t k;
    if (a->n != b->n) return 0;
    for (k = 0; k < a->n; k++) {
        if (a->f[k].es != b->f[k].es || a->f[k].ee != b->f[k].ee
            || a->f[k].gs != b->f[k].gs || a->f[k].ge != b->f[k].ge)
            return 0;
    }
    return 1;
}

static void ep_remove_dup(eflst *lst) {
    uint32_t members = 0;
    int has_possible = 0;
    int64_t k, k1;
    for (k = 0; k < lst->n; k++) {
        uint32_t h = ep_fact_hash(&lst->a[k]);
        if (members & h) { has_possible = 1; break; }
        members |= h;
    }
    if (!has_possible) return;
    k1 = 0;
    while (k1 < lst->n) {
        int dup = 0;
        int64_t k2;
        for (k2 = 0; k2 < k1; k2++) {
            if (ep_fact_equal(&lst->a[k1], &lst->a[k2])) { dup = 1; break; }
        }
        if (dup) eflst_del(lst, k1);
        else k1++;
    }
}

/* refinement.py:recover_lost_prefixes_and_suffixes */
static int ep_recover_affixes(eflst *lst, const char *gen, int64_t glen,
                              const char *est, int64_t elen) {
    int64_t k;
    for (k = 0; k < lst->n; k++) {
        efct *f = &lst->a[k];
        if (f->n == 0) continue;
        {
            efac *pff = &f->f[0];
            if (pff->es > 0 && pff->gs > 0) {
                int64_t flen = pff->es < pff->gs ? pff->es : pff->gs;
                int64_t el = (int64_t)((1.0 + EP_MAX_ERROR_RATE)
                                       * (double)flen);
                int64_t gl = el;
                const char *ef, *gf;
                int64_t efl, gfl, i;
                char *rb_e, *rb_g;
                if (el > pff->es) el = pff->es;
                if (gl > pff->gs) gl = pff->gs;
                efl = py_slice(est, elen, pff->es - el, pff->es, &ef);
                gfl = py_slice(gen, glen, pff->gs - gl, pff->gs, &gf);
                rb_e = ep_cbuf(2, efl + 1);
                rb_g = ep_cbuf(3, gfl + 1);
                if (!rb_e || !rb_g) return 0;
                for (i = 0; i < efl; i++) rb_e[i] = ef[efl - 1 - i];
                for (i = 0; i < gfl; i++) rb_g[i] = gf[gfl - 1 - i];
                {
                    char c1 = efl > 0 ? rb_e[0] : '\0';
                    char c2 = gfl > 0 ? rb_g[0] : '\0';
                    int differ = (efl > 0) != (gfl > 0)
                                 || (efl > 0 && c1 != c2);
                    if (differ && efl > 0 && gfl > 0) {
                        int64_t out2[2];
                        int64_t found = longest_affix(rb_e, efl, rb_g, gfl,
                                                      EP_MAX_ERROR_RATE,
                                                      out2);
                        if (found > 0) {
                            pff->es -= out2[0];
                            pff->gs -= out2[1];
                        }
                    } else if (differ) {
                        /* one side empty: python find_longest_affix
                         * returns False on empty input */
                    }
                }
            }
        }
        {
            efac *pfl = &f->f[f->n - 1];
            if ((elen - pfl->ee) > 1 && (glen - pfl->ge) > 1) {
                int64_t flen = elen - pfl->ee - 1 < glen - pfl->ge - 1
                               ? elen - pfl->ee - 1 : glen - pfl->ge - 1;
                /* (int)(1.0+RATE) * flen truncates to 1*flen */
                int64_t el = elen - pfl->ee - 1 < flen
                             ? elen - pfl->ee - 1 : flen;
                int64_t gl = glen - pfl->ge - 1 < flen
                             ? glen - pfl->ge - 1 : flen;
                const char *ef, *gf;
                int64_t efl = py_slice(est, elen, pfl->ee, pfl->ee + el, &ef);
                int64_t gfl = py_slice(gen, glen, pfl->ge, pfl->ge + gl, &gf);
                char c1 = efl > 0 ? ef[0] : '\0';
                char c2 = gfl > 0 ? gf[0] : '\0';
                int differ = (efl > 0) != (gfl > 0)
                             || (efl > 0 && c1 != c2);
                if (differ && efl > 0 && gfl > 0) {
                    int64_t out2[2];
                    int64_t found = longest_affix(ef, efl, gf, gfl,
                                                  EP_MAX_ERROR_RATE, out2);
                    if (found > 0) {
                        pfl->ee += out2[0];
                        pfl->ge += out2[1];
                    }
                }
            }
        }
    }
    return 1;
}

/* ---- native itype classification (classify.py:95-229) ------------------ */

static const int *ep_base_idx(void) {
    static int tab[256];
    static int done = 0;
    if (!done) {
        int i;
        for (i = 0; i < 256; i++) tab[i] = 3;
        tab['A'] = tab['a'] = 0;
        tab['C'] = tab['c'] = 1;
        tab['G'] = tab['g'] = 2;
        tab['T'] = tab['t'] = 3;
        tab['N'] = tab['n'] = 0;
        done = 1;
    }
    return tab;
}

/* classify.py:mat_inspector_score, same accumulation order */
static double ep_matins(const char *seq, int64_t slen, const double *pwm,
                        const double *cv, const double *maxv, int64_t L) {
    const int *bidx = ep_base_idx();
    double num = 0.0, den = 0.0;
    int64_t i;
    for (i = 0; i < L; i++) {
        char ch = i < slen ? seq[i] : '\0';
        int idx = bidx[(unsigned char)ch];
        if (ch == '\0') idx = 3;
        num += cv[i] * pwm[idx * L + i];
        den += cv[i] * maxv[i];
    }
    return num / den;
}

/* classify.py:search_bps via the bps_search kernel (weighted tables built
 * once, products in the same order as the python tables) */
static int64_t ep_search_bps(const char *iseq, int64_t ilen, int which,
                             int64_t range_start, int64_t range_end,
                             double *score) {
    static double w9[4 * PWM_BPS_9_L], w10[4 * PWM_BPS_10_L];
    static double den9 = 0.0, den10 = 0.0;
    static int done = 0;
    int64_t start_w, end_w;
    if (!done) {
        int r, i;
        for (r = 0; r < 4; r++)
            for (i = 0; i < PWM_BPS_9_L; i++)
                w9[r * PWM_BPS_9_L + i] = CV_BPS_9[i] * PWM_BPS_9[r][i];
        for (i = 0; i < PWM_BPS_9_L; i++)
            den9 += CV_BPS_9[i] * MAXV_BPS_9[i];
        for (r = 0; r < 4; r++)
            for (i = 0; i < PWM_BPS_10_L; i++)
                w10[r * PWM_BPS_10_L + i] = CV_BPS_10[i] * PWM_BPS_10[r][i];
        for (i = 0; i < PWM_BPS_10_L; i++)
            den10 += CV_BPS_10[i] * MAXV_BPS_10[i];
        done = 1;
    }
    if (ilen < range_start) { *score = 0.0; return -1; }
    start_w = ilen - range_end;
    end_w = ilen - range_start;
    if (start_w < 0) start_w = 0;
    if (which == 9)
        return bps_search(iseq, ilen, w9, PWM_BPS_9_L, CV_BPS_9, den9,
                          start_w, end_w, score);
    return bps_search(iseq, ilen, w10, PWM_BPS_10_L, CV_BPS_10, den10,
                      start_w, end_w, score);
}

/* classify.py:exists_good_bps */
static int64_t ep_exists_good_bps(const char *iseq, int64_t ilen,
                                  int64_t range_start, int64_t range_end,
                                  double *score) {
    int64_t bps_9, bps_10;
    double s9, s10;
    if (range_end > ilen) { *score = 0.0; return -1; }
    bps_9 = ep_search_bps(iseq, ilen, 9, range_start, range_end, &s9);
    bps_10 = ep_search_bps(iseq, ilen, 10, range_start, range_end, &s10);
    if (s9 > s10) {
        if (s9 > 0.75) { *score = s9; return bps_9; }
    } else {
        if (s10 > 0.75) { *score = s10; return bps_10; }
    }
    *score = 0.0;
    return -1;
}

static double ep_score5(const char *gen, int64_t glen, int64_t start,
                        const double *pwm, const double *cv,
                        const double *maxv, int64_t L, int64_t length) {
    const char *sub;
    int64_t sl = rs_sub(gen, glen, start - 3, length, &sub);
    (void)length;
    return ep_matins(sub, sl, pwm, cv, maxv, L);
}

/* exact-case 2-char pattern compare: all-lower or all-upper form only */
static int ep_is_pt(const char *pt, int64_t ptl, char a, char b) {
    if (ptl != 2) return 0;
    if (pt[0] == a && pt[1] == b) return 1;
    return pt[0] == (char)(a - 'a' + 'A') && pt[1] == (char)(b - 'a' + 'A');
}

/* classify.py:classify_genomic_intron_start_end, itype only (the 3'
 * scores never feed the type decision) */
static int ep_classify_itype_uncached(const char *gen, int64_t glen,
                                      int64_t start, int64_t end) {
    const char *iseq;
    int64_t ilen = rs_sub(gen, glen, start, end - start + 1, &iseq);
    double bscore;
    int64_t bps_position = ep_exists_good_bps(iseq, ilen, 14, 30, &bscore);
    const char *pt5, *pt3;
    int64_t pt5l = rs_sub(iseq, ilen, 0, 2, &pt5);
    int64_t pt3l = rs_sub(iseq, ilen, ilen - 2, 2, &pt3);
    double scoreU12_5 = 0.0, scoreU2_5 = 0.0, s2;
    int pt_type = 1;
    int itype = 2;

    if (ep_is_pt(pt5, pt5l, 'g', 't') && ep_is_pt(pt3, pt3l, 'a', 'g')) {
        pt_type = 0;
        scoreU12_5 = ep_score5(gen, glen, start, &PWM_P5_GTAG_U12[0][0],
                               CV_P5_GTAG_U12, MAXV_P5_GTAG_U12,
                               PWM_P5_GTAG_U12_L, 14);
        scoreU2_5 = ep_score5(gen, glen, start, &PWM_P5_GTAG_U2[0][0],
                              CV_P5_GTAG_U2, MAXV_P5_GTAG_U2,
                              PWM_P5_GTAG_U2_L, 13);
    } else if (ep_is_pt(pt5, pt5l, 'g', 'c')
               && ep_is_pt(pt3, pt3l, 'a', 'g')) {
        pt_type = 0;
        scoreU2_5 = ep_score5(gen, glen, start, &PWM_P5_GCAG_U2[0][0],
                              CV_P5_GCAG_U2, MAXV_P5_GCAG_U2,
                              PWM_P5_GCAG_U2_L, 14);
        scoreU12_5 = ep_score5(gen, glen, start, &PWM_P5_GTAG_U12[0][0],
                               CV_P5_GTAG_U12, MAXV_P5_GTAG_U12,
                               PWM_P5_GTAG_U12_L, 14);
        s2 = ep_score5(gen, glen, start, &PWM_P5_ATAC_U12[0][0],
                       CV_P5_ATAC_U12, MAXV_P5_ATAC_U12,
                       PWM_P5_ATAC_U12_L, 14);
        if (s2 > scoreU12_5) scoreU12_5 = s2;
    } else if (ep_is_pt(pt5, pt5l, 'a', 't')
               && ep_is_pt(pt3, pt3l, 'a', 'c')) {
        scoreU12_5 = ep_score5(gen, glen, start, &PWM_P5_ATAC_U12[0][0],
                               CV_P5_ATAC_U12, MAXV_P5_ATAC_U12,
                               PWM_P5_ATAC_U12_L, 14);
        scoreU2_5 = ep_score5(gen, glen, start, &PWM_P5_GTAG_U2[0][0],
                              CV_P5_GTAG_U2, MAXV_P5_GTAG_U2,
                              PWM_P5_GTAG_U2_L, 13);
        s2 = ep_score5(gen, glen, start, &PWM_P5_GCAG_U2[0][0],
                       CV_P5_GCAG_U2, MAXV_P5_GCAG_U2,
                       PWM_P5_GCAG_U2_L, 14);
        if (s2 > scoreU2_5) scoreU2_5 = s2;
    } else {
        scoreU12_5 = ep_score5(gen, glen, start, &PWM_P5_GTAG_U12[0][0],
                               CV_P5_GTAG_U12, MAXV_P5_GTAG_U12,
                               PWM_P5_GTAG_U12_L, 14);
        s2 = ep_score5(gen, glen, start, &PWM_P5_ATAC_U12[0][0],
                       CV_P5_ATAC_U12, MAXV_P5_ATAC_U12,
                       PWM_P5_ATAC_U12_L, 14);
        if (s2 > scoreU12_5) scoreU12_5 = s2;
        scoreU2_5 = ep_score5(gen, glen, start, &PWM_P5_GTAG_U2[0][0],
                              CV_P5_GTAG_U2, MAXV_P5_GTAG_U2,
                              PWM_P5_GTAG_U2_L, 13);
        s2 = ep_score5(gen, glen, start, &PWM_P5_GCAG_U2[0][0],
                       CV_P5_GCAG_U2, MAXV_P5_GCAG_U2,
                       PWM_P5_GCAG_U2_L, 14);
        if (s2 > scoreU2_5) scoreU2_5 = s2;
    }

    if (bps_position != -1) {
        itype = scoreU12_5 > scoreU2_5 ? 0 : 1;
    } else {
        if (pt_type == 0) itype = 1;
        else if (scoreU12_5 - scoreU2_5 > 0.25 && scoreU12_5 >= 0.75)
            itype = 0;
    }
    return itype;
}

static int ep_classify_itype(const char *gen, int64_t glen, int64_t start,
                             int64_t end) {
    uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
    int found, itype;
    epm_ent *me;
    mk[0] = 6;
    mk[1] = (uint64_t)start;
    mk[2] = (uint64_t)end;
    mk[3] = 0;
    mk[4] = 0;
    me = epm_find(mk, &found);
    if (found) return (int)me->v[0];
    itype = ep_classify_itype_uncached(gen, glen, start, end);
    if (me) me->v[0] = itype;
    return itype;
}

static int ep_is_canonical(const char *gen, int64_t glen, int64_t is,
                           int64_t ie) {
    char a = ep_gch(gen, glen, is);
    char b = ep_gch(gen, glen, is + 1);
    char c = ep_gch(gen, glen, ie - 1);
    char d = ep_gch(gen, glen, ie);
    return (a == 'G' && b == 'T' && c == 'A' && d == 'G')
           || (a == 'g' && b == 't' && c == 'a' && d == 'g');
}

/* refinement.py:analyze_possibly_small_exon.  Returns 1 if removed. */
static int ep_analyze_small(efct *f, int64_t i, const char *gen,
                            int64_t glen, const char *est, int64_t elen) {
    efac *pprev = &f->f[i - 1];
    efac *pcurr = &f->f[i];
    efac *pnext = &f->f[i + 1];
    int64_t el = pcurr->ee + 1 - pcurr->es;
    int64_t gl = pcurr->ge + 1 - pcurr->gs;
    const char *efa, *gfa;
    int64_t efl, gfl, orig_ed;
    int64_t estart, eend, epreflen, esufflen, allelen;
    int64_t gstart, gend, gpreflen, gsufflen, allglen;
    const char *allef, *allgf, *sp, *sg;
    int64_t orig_ed_pref, orig_ed_suff, spl, sgl;
    int64_t out6[6];
    double prev_avg;
    int64_t new_freq;

    if (el > EP_UB_MED) return 0;
    efl = py_slice(est, elen, pcurr->es, pcurr->es + el, &efa);
    gfl = py_slice(gen, glen, pcurr->gs, pcurr->gs + gl, &gfa);
    orig_ed = (efl == gfl && memcmp(efa, gfa, (size_t)efl) == 0)
              ? 0 : edit_total(efa, efl, gfa, gfl);

    estart = pprev->es + 1 > pprev->ee + 1 - EP_AFFIXES
             ? pprev->es + 1 : pprev->ee + 1 - EP_AFFIXES;
    eend = pnext->ee < pnext->es + EP_AFFIXES
           ? pnext->ee : pnext->es + EP_AFFIXES;
    epreflen = pprev->ee + 1 - estart;
    esufflen = eend - pnext->es;
    allelen = eend - estart;
    gstart = pprev->gs + 1 > pprev->ge + 1 - EP_AFFIXES
             ? pprev->gs + 1 : pprev->ge + 1 - EP_AFFIXES;
    gend = pnext->ge < pnext->gs + EP_AFFIXES
           ? pnext->ge : pnext->gs + EP_AFFIXES;
    gpreflen = pprev->ge + 1 - gstart;
    gsufflen = gend - pnext->gs;
    allglen = gend - gstart;
    efl = py_slice(est, elen, estart, estart + allelen, &allef);
    gfl = py_slice(gen, glen, gstart, gstart + allglen, &allgf);

    spl = py_slice(est, elen, estart, estart + epreflen, &sp);
    sgl = py_slice(gen, glen, gstart, gstart + gpreflen, &sg);
    orig_ed_pref = (spl == sgl && memcmp(sp, sg, (size_t)spl) == 0)
                   ? 0 : edit_total(sp, spl, sg, sgl);
    spl = py_slice(est, elen, estart - esufflen, estart, &sp);
    sgl = py_slice(gen, glen, gstart - gsufflen, gstart, &sg);
    orig_ed_suff = (spl == sgl && memcmp(sp, sg, (size_t)spl) == 0)
                   ? 0 : edit_total(sp, spl, sg, sgl);

    refine_borders_core(allef, efl, 0, efl, allgf, gfl,
                        orig_ed + orig_ed_pref + orig_ed_suff, out6);
    if (out6[0] < 0) return -1;   /* alloc failure: not a verdict */
    if (out6[0] != 1) return 0;
    prev_avg = ((double)burset_adaptor(gen, glen, pprev->ge + 1, pcurr->gs)
                + (double)burset_adaptor(gen, glen, pcurr->ge + 1,
                                         pnext->gs)) / 2.0;
    new_freq = burset_adaptor(gen, glen, gstart + out6[2],
                              gend - allglen + out6[3]);
    if ((double)new_freq >= prev_avg) {
        pprev->ee = estart + out6[1] - 1;
        pnext->es = eend + out6[1] - allelen;
        pprev->ge = gstart + out6[2] - 1;
        pnext->gs = gend + out6[3] - allglen;
        efct_del(f, i);
        return 1;
    }
    return 0;
}

/* memoized wrapper: behavior depends only on the (prev, curr, next)
 * factor coordinates; on a hit replays the mutations + deletion */
static int ep_analyze_small_memo(efct *f, int64_t i, const char *gen,
                                 int64_t glen, const char *est,
                                 int64_t elen) {
    uint64_t mk[7];
    int found, removed;
    epm_ent *me;
    efac *pprev = &f->f[i - 1];
    efac *pnext = &f->f[i + 1];
    mk[0] = 7 | (epm_seq_id << 16);
    mk[1] = ((uint64_t)(uint32_t)pprev->es << 32) | (uint32_t)pprev->ee;
    mk[2] = ((uint64_t)(uint32_t)pprev->gs << 32) | (uint32_t)pprev->ge;
    mk[3] = ((uint64_t)(uint32_t)f->f[i].es << 32) | (uint32_t)f->f[i].ee;
    mk[4] = ((uint64_t)(uint32_t)f->f[i].gs << 32) | (uint32_t)f->f[i].ge;
    mk[5] = ((uint64_t)(uint32_t)pnext->es << 32) | (uint32_t)pnext->ee;
    mk[6] = ((uint64_t)(uint32_t)pnext->gs << 32) | (uint32_t)pnext->ge;
    me = epm_find(mk, &found);
    if (found) {
        if (me->v[0]) {
            pprev->ee = (int64_t)(int32_t)(me->v[1] >> 32);
            pprev->ge = (int64_t)(int32_t)(uint32_t)me->v[1];
            pnext->es = (int64_t)(int32_t)(me->v[2] >> 32);
            pnext->gs = (int64_t)(int32_t)(uint32_t)me->v[2];
            efct_del(f, i);
            return 1;
        }
        return 0;
    }
    removed = ep_analyze_small(f, i, gen, glen, est, elen);
    if (removed < 0) {
        if (me) me->gen = epm_gen - 1;
        return removed;
    }
    if (me) {
        me->v[0] = removed;
        if (removed) {
            /* pprev/pnext may have moved after efct_del */
            efac *pp = &f->f[i - 1];
            efac *pn = &f->f[i];
            me->v[1] = ((uint64_t)(uint32_t)pp->ee << 32) | (uint32_t)pp->ge;
            me->v[2] = ((uint64_t)(uint32_t)pn->es << 32) | (uint32_t)pn->gs;
        }
    }
    return removed;
}

static int ep_remove_false_small(eflst *lst, const char *gen,
                                 int64_t glen, const char *est,
                                 int64_t elen) {
    int64_t k;
    for (k = 0; k < lst->n; k++) {
        efct *f = &lst->a[k];
        int64_t i = 1;
        while (i <= f->n - 2) {
            int r = ep_analyze_small_memo(f, i, gen, glen, est, elen);
            if (r < 0) return -1;
            if (r) {
                i -= 1;
                if (i < 1) i = 1;
            } else i++;
        }
    }
    return 0;
}

/* refinement.py:search_small_exon_at_prefix */
static int ep_search_small_prefix(efct *f, const char *gen, int64_t glen,
                                  const char *est, int64_t elen,
                                  int64_t min_intron_length) {
    efac *p1 = &f->f[0];
    int64_t e1len = p1->ee + 1 - p1->es;
    int64_t g1len = p1->ge + 1 - p1->gs;
    int64_t eplen, e1plen, pg, pe, cflen, edp, allelen, allglen;
    const char *epfact, *e1p, *g1p, *pp, *tt;
    int64_t e1l, g1l, ppl, ttl;
    int64_t out6[6];
    int64_t occ1, occ2;
    efac pnew;

    if ((e1len + p1->es) < (EP_LB_SMALL + EP_UB_SMALL)) return 0;
    eplen = p1->es < p1->gs ? p1->es : p1->gs;
    if (eplen > 2 * EP_UB_SMALL) eplen = 2 * EP_UB_SMALL;
    (void)py_slice(est, elen, p1->es - eplen, p1->es, &epfact);
    {
        int64_t epl = py_slice(est, elen, p1->es - eplen, p1->es, &epfact);
        int64_t gpre = p1->gs < glen ? p1->gs : glen;
        double ts = fe_now();
        cflen = lcf_dp(gen, gpre, epfact, epl, &occ1, &occ2);
        ep_stats[8] += fe_now() - ts;
        ep_stats[15] += 1.0;
        ep_stats[11] += (double)gpre;
        pg = occ1;
        pe = occ2;
    }
    if (cflen < EP_LB_SMALL) return 0;

    e1plen = e1len < g1len ? e1len : g1len;
    if (e1plen > EP_UB_SMALL) e1plen = EP_UB_SMALL;
    e1l = py_slice(est, elen, p1->es, p1->es + e1plen, &e1p);
    g1l = py_slice(gen, glen, p1->gs, p1->gs + e1plen, &g1p);
    edp = (e1l == g1l && memcmp(e1p, g1p, (size_t)e1l) == 0)
          ? 0 : edit_total(e1p, e1l, g1p, g1l);

    allelen = (p1->ee + 1 < p1->es + EP_UB_SMALL
               ? p1->ee + 1 : p1->es + EP_UB_SMALL) - pe;
    allglen = (p1->ge + 1 < p1->gs + EP_UB_SMALL
               ? p1->ge + 1 : p1->gs + EP_UB_SMALL) - pg;
    ppl = py_slice(est, elen, pe, pe + allelen, &pp);
    ttl = py_slice(gen, glen, pg, pg + allglen, &tt);
    refine_borders_core(pp, ppl, EP_LB_SMALL, allelen - EP_LB_SMALL,
                        tt, ttl, edp, out6);
    if (out6[0] < 0) return -1;   /* alloc failure: not a verdict */
    if (out6[0] != 1) return 0;
    if (out6[3] - out6[2] < min_intron_length) return 0;
    if (!ep_is_canonical(gen, glen, pg + out6[2], pg + out6[3] - 1))
        return 0;
    if (out6[1] - pe < EP_LB_SMALL) return 0;
    if (!efct_reserve(f, f->n + 1)) return -1;   /* before any mutation */
    pnew.es = pe;
    pnew.ee = pe + out6[1] - 1;
    pnew.gs = pg;
    pnew.ge = pg + out6[2] - 1;
    p1 = &f->f[0];   /* reserve may have moved the array */
    p1->es = pe + out6[1];
    p1->gs = pg + out6[3];
    efct_insert(f, 0, pnew);
    return 1;
}

/* grow-once int32 scratch keyed by slot */
static int32_t *ep_i32buf(int slot, int64_t need) {
    static int32_t *bufs[4];
    static int64_t caps[4];
    if (need > caps[slot]) {
        int32_t *nb = (int32_t *)realloc(bufs[slot],
                                         (size_t)(2 * need + 64)
                                         * sizeof(int32_t));
        if (!nb) return NULL;
        bufs[slot] = nb;
        caps[slot] = 2 * need + 64;
    }
    return bufs[slot];
}

/* grow-once int8 scratch keyed by slot (matching-statistics columns) */
static int8_t *ep_i8buf(int slot, int64_t need) {
    static int8_t *bufs[2];
    static int64_t caps[2];
    if (need > caps[slot]) {
        int8_t *nb = (int8_t *)realloc(bufs[slot],
                                       (size_t)(2 * need + 64));
        if (!nb) return NULL;
        bufs[slot] = nb;
        caps[slot] = 2 * need + 64;
    }
    return bufs[slot];
}

/* Z-array of a short pattern (literal char equality) */
static void ep_zself(const char *P, int64_t m, int32_t *zp) {
    int64_t i, l = 0, r = 0;
    zp[0] = (int32_t)m;
    for (i = 1; i < m; i++) {
        int64_t k = 0;
        if (i < r) {
            k = zp[i - l];
            if (k > r - i) k = r - i;
        }
        while (i + k < m && P[k] == P[i + k]) k++;
        zp[i] = (int32_t)k;
        if (i + k > r) { l = i; r = i + k; }
    }
}

/* matching statistics with filtered emission: for each q, the length
 * of the longest common prefix of P and T[q:] (capped at m); positions
 * with match length >= minL are appended to (out_q, out_m).  O(n + m)
 * total, and only qualifying positions touch memory. */
static int64_t ep_matchstats_emit(const char *P, int64_t m, const char *T,
                                  int64_t n, const int32_t *zp,
                                  int64_t minL, int32_t *out_q,
                                  int32_t *out_m) {
    int64_t q, l = -1, r = 0, cnt = 0;
    for (q = 0; q < n; q++) {
        int64_t k = 0;
        if (q < r) {
            k = zp[q - l];
            if (k >= r - q) k = r - q;
            else {
                if (k >= minL) {
                    out_q[cnt] = (int32_t)q;
                    out_m[cnt] = (int32_t)k;
                    cnt++;
                }
                continue;
            }
        }
        while (k < m && q + k < n && P[k] == T[q + k]) k++;
        if (k >= minL) {
            out_q[cnt] = (int32_t)q;
            out_m[cnt] = (int32_t)k;
            cnt++;
        }
        if (q + k > r) { l = q; r = q + k; }
    }
    return cnt;
}

/* python str.find(needle, start) over a bounded haystack */
static int64_t ep_find(const char *hay, int64_t hl, const char *nd,
                       int64_t nl, int64_t start) {
    int64_t pos;
    if (start < 0) start = 0;
    if (nl == 0) return start <= hl ? start : -1;
    if (start > hl - nl) return -1;
    /* hits cluster in low-complexity regions: try a short naive window
     * first, then fall back to memmem (two-way, linear worst case) for
     * the long jumps */
    {
        int64_t wend = start + 64;
        if (wend > hl - nl) wend = hl - nl;
        for (pos = start; pos <= wend; pos++) {
            if (hay[pos] == nd[0]
                && (nl == 1
                    || memcmp(hay + pos + 1, nd + 1,
                              (size_t)(nl - 1)) == 0))
                return pos;
        }
        if (pos > hl - nl) return -1;
        {
            const char *hit = (const char *)memmem(hay + pos,
                                                   (size_t)(hl - pos),
                                                   nd, (size_t)nl);
            return hit ? (int64_t)(hit - hay) : -1;
        }
    }
}

/* refinement.py:search_small_exon.  insert_at = index of p2. */
static int ep_search_small(efct *f, int64_t i1, const char *gen,
                           int64_t glen, const char *est, int64_t elen,
                           int64_t min_intron_cfg) {
    efac *p1 = &f->f[i1];
    efac *p2 = &f->f[i1 + 1];
    int64_t e1len = p1->ee + 1 - p1->es;
    int64_t g1len = p1->ge + 1 - p1->gs;
    int64_t e2len = p2->ee + 1 - p2->es;
    int64_t g2len = p2->ge + 1 - p2->gs;
    int64_t e1slen, e1sstart, g1sstart, e2plen, e2pstart, g2pstart;
    const char *e1s, *g1s, *e2p, *g2p;
    int64_t e1sl, g1sl, e2pl, g2pl;
    int64_t sed, ped, prev_ed;
    int continue_search = 0;
    int orig_cls;
    int64_t e1socc = 0, g1socc = 0, f1slen, e2pocc = 0, g2pocc = 0, f2plen;
    int64_t eln, estart, allgstart, allglen2, MIN_IL;
    const char *efact, *allgfact;
    int64_t efactl, allgfactl;
    int64_t max_sexon_len = 0, ecut1 = 0, ecut2 = 0;
    int64_t gcut1_1 = 0, gcut1_2 = 0, gcut2_1 = 0, gcut2_2 = 0;
    int64_t max_offstart, offstart;
    int ms_ok = 0;
    int64_t ms_offs[64], ms_cnts[64];
    int32_t *ms_q = NULL, *ms_m = NULL;

    if ((e1len + e2len) < (EP_LB_SMALL + 2 * EP_UB_SMALL)) return 0;
    e1slen = e1len < g1len ? e1len : g1len;
    if (e1slen > EP_UB_SMALL) e1slen = EP_UB_SMALL;
    e1sstart = p1->ee + 1 - e1slen;
    e1sl = py_slice(est, elen, e1sstart, e1sstart + e1slen, &e1s);
    g1sstart = p1->ge + 1 - e1slen;
    g1sl = py_slice(gen, glen, g1sstart, g1sstart + e1slen, &g1s);

    e2plen = e2len < g2len ? e2len : g2len;
    if (e2plen > EP_UB_SMALL) e2plen = EP_UB_SMALL;
    e2pstart = p2->es;
    e2pl = py_slice(est, elen, e2pstart, e2pstart + e2plen, &e2p);
    g2pstart = p2->gs;
    g2pl = py_slice(gen, glen, g2pstart, g2pstart + e2plen, &g2p);

    sed = (e1sl == g1sl && memcmp(e1s, g1s, (size_t)e1sl) == 0)
          ? 0 : edit_total(e1s, e1sl, g1s, g1sl);
    ped = (e2pl == g2pl && memcmp(e2p, g2p, (size_t)e2pl) == 0)
          ? 0 : edit_total(e2p, e2pl, g2p, g2pl);
    prev_ed = sed + ped;
    orig_cls = ep_classify_itype(gen, glen, p1->ge + 1, p2->gs - 1);
    if (prev_ed > EP_MAX_ERR_SMALL) continue_search = 1;
    if (orig_cls == 2) continue_search = 1;
    if (!continue_search) return 0;

    f1slen = e1slen;
    if (sed > 0) {
        int64_t o1, o2;
        f1slen = lcf_dp(e1s, e1sl, g1s, g1sl, &o1, &o2);
        e1socc = o1; g1socc = o2;
    }
    f2plen = e2plen;
    if (ped > 0) {
        int64_t o1, o2;
        f2plen = lcf_dp(e2p, e2pl, g2p, g2pl, &o1, &o2);
        e2pocc = o1; g2pocc = o2;
    }

    if (f1slen == e1slen && e2pocc > 0) {
        int64_t new_f1slen = f1slen + 1;
        for (;;) {
            char ce, cg;
            if (!((new_f1slen - f1slen) < e2pocc)) break;
            ce = (e1sstart + e1socc + f1slen < elen
                  && e1sstart + e1socc + f1slen >= 0)
                 ? est[e1sstart + e1socc + f1slen] : '\0';
            cg = (g2pstart + new_f1slen - f1slen < glen
                  && g2pstart + new_f1slen - f1slen >= 0)
                 ? gen[g2pstart + new_f1slen - f1slen] : '\0';
            if (ce != cg) break;
            new_f1slen++;
        }
        if (new_f1slen - 1 > f1slen) f1slen = new_f1slen - 1;
    }

    eln = (e1slen - e1socc) + (e2pocc + f2plen) - 2 * EP_MIN_PERFECT_BORDER;
    estart = e1sstart + e1socc + EP_MIN_PERFECT_BORDER;
    allgstart = g1sstart + g1socc + EP_MIN_PERFECT_BORDER;
    allglen2 = (g2pstart + g2pocc + f2plen - EP_MIN_PERFECT_BORDER)
               - allgstart;
    MIN_IL = min_intron_cfg > 4 ? min_intron_cfg : 4;
    if (f1slen < EP_MIN_PERFECT_BORDER) return 0;
    if (f2plen < EP_MIN_PERFECT_BORDER) return 0;
    if (allglen2 < 2 * MIN_IL + EP_LB_SMALL) return 0;
    if (eln < EP_LB_SMALL) return 0;

    efactl = py_slice(est, elen, estart, estart + eln, &efact);
    allgfactl = py_slice(gen, glen, allgstart, allgstart + allglen2,
                         &allgfact);

    max_offstart = f1slen + 1 - EP_MIN_PERFECT_BORDER;
    if (eln + 1 - EP_LB_SMALL < max_offstart)
        max_offstart = eln + 1 - EP_LB_SMALL;
    if (allglen2 + 1 - 2 * MIN_IL - EP_LB_SMALL < max_offstart)
        max_offstart = allglen2 + 1 - 2 * MIN_IL - EP_LB_SMALL;

    /* All-offstart matching statistics, vectorized: every offstart's
     * pass needs lcp(efact[offstart:], T[q:]) for all q, which the
     * diagonal recurrence
     *     Lcol(s)[q] = (T[q] == efact[s]) ? Lcol(s+1)[q+1] + 1 : 0
     * yields for ALL offstarts in |efact| int8 sweeps over T (32
     * text positions per AVX2 op) — replacing one Z-algorithm scan of
     * T per offstart.  Emitted hits (length >= EP_LB_SMALL, ascending
     * q, exact lengths) are precisely ep_matchstats_emit's, so the
     * bucket walk below is unchanged.  Pattern lengths are <= ~57
     * (EP_UB_SMALL windows), far under the int8 guard. */
    if (max_offstart > 0 && max_offstart <= 63 && efactl <= 120
        && allgfactl > 0) {
        int64_t n2 = allgfactl, s, acap = 4096, an = 0;
        int8_t *La = ep_i8buf(0, n2 + 40);
        int8_t *Lb = ep_i8buf(1, n2 + 40);
        double tf = fe_now();
        ms_q = ep_i32buf(1, acap);
        ms_m = ep_i32buf(2, acap);
        if (La && Lb && ms_q && ms_m) {
            ms_ok = 1;
            memset(La, 0, (size_t)(n2 + 40));
            memset(Lb, 0, (size_t)(n2 + 40));
            for (s = efactl - 1; s >= 0 && ms_ok; s--) {
                char pc = efact[s];
                int8_t *colc = (s & 1) ? La : Lb;
                int8_t *coln = (s & 1) ? Lb : La;
                int64_t q = 0;
#if defined(__AVX2__)
                {
                    __m256i pv = _mm256_set1_epi8(pc);
                    __m256i one = _mm256_set1_epi8(1);
                    for (; q + 32 <= n2; q += 32) {
                        __m256i tv = _mm256_loadu_si256(
                            (const __m256i *)(allgfact + q));
                        __m256i eq = _mm256_cmpeq_epi8(tv, pv);
                        __m256i nx = _mm256_loadu_si256(
                            (const __m256i *)(coln + q + 1));
                        _mm256_storeu_si256(
                            (__m256i *)(colc + q),
                            _mm256_and_si256(_mm256_add_epi8(nx, one),
                                             eq));
                    }
                }
#endif
                for (; q < n2; q++)
                    colc[q] = (allgfact[q] == pc)
                              ? (int8_t)(coln[q + 1] + 1) : 0;
                if (s < max_offstart) {
                    int64_t q2 = 0;
                    ms_offs[s] = an;
#if defined(__AVX2__)
                    {
                        __m256i th = _mm256_set1_epi8(EP_LB_SMALL - 1);
                        for (; q2 + 32 <= n2; q2 += 32) {
                            unsigned mask2 = (unsigned)_mm256_movemask_epi8(
                                _mm256_cmpgt_epi8(
                                    _mm256_loadu_si256(
                                        (const __m256i *)(colc + q2)),
                                    th));
                            while (mask2) {
                                int b = __builtin_ctz(mask2);
                                mask2 &= mask2 - 1;
                                if (an + 1 > acap) {
                                    acap *= 2;
                                    ms_q = ep_i32buf(1, acap);
                                    ms_m = ep_i32buf(2, acap);
                                    if (!ms_q || !ms_m) { ms_ok = 0; break; }
                                }
                                ms_q[an] = (int32_t)(q2 + b);
                                ms_m[an] = colc[q2 + b];
                                an++;
                            }
                            if (!ms_ok) break;
                        }
                    }
#endif
                    for (; ms_ok && q2 < n2; q2++) {
                        if (colc[q2] >= EP_LB_SMALL) {
                            if (an + 1 > acap) {
                                acap *= 2;
                                ms_q = ep_i32buf(1, acap);
                                ms_m = ep_i32buf(2, acap);
                                if (!ms_q || !ms_m) { ms_ok = 0; break; }
                            }
                            ms_q[an] = (int32_t)q2;
                            ms_m[an] = colc[q2];
                            an++;
                        }
                    }
                    ms_cnts[s] = an - ms_offs[s];
                }
            }
        }
        ep_stats[10] += fe_now() - tf;
    }

    for (offstart = 0; offstart < max_offstart; offstart++) {
        int64_t max_offend = f2plen + 1 - EP_MIN_PERFECT_BORDER;
        int64_t offend;
        const char *P;
        int64_t m_total, search_from;
        int32_t *zp, *M, *bpos, *bnext;
        int64_t *bstart, *bend, *cur0, *cur;
        int64_t nbuck, q, L;
        if (eln + 1 - offstart - EP_LB_SMALL < max_offend)
            max_offend = eln + 1 - offstart - EP_LB_SMALL;
        if (allglen2 + 1 - 2 * MIN_IL - EP_LB_SMALL - offstart < max_offend)
            max_offend = allglen2 + 1 - 2 * MIN_IL - EP_LB_SMALL - offstart;
        if (eln - offstart <= max_sexon_len) continue;
        if (max_offend <= 0) continue;

        /* Occurrence index: every offend's needle efact[offstart:eln-
         * offend] is a prefix of P = efact[offstart:], so one matching-
         * statistics pass M[q] = lcp(P, hay[q:]) answers all of them:
         * needle(offend) occurs at q iff M[q] >= ndl.  Occurrences are
         * then visited in the same ascending order as the str.find loop
         * (exact semantics), without rescanning the hay per offend. */
        P = efact + offstart;
        m_total = efactl - offstart;
        if (m_total < 0) m_total = 0;
        search_from = offstart + MIN_IL;
        {
            double tf = fe_now();
            int64_t need = allgfactl + 8;
            int32_t *hq, *hm;
            int64_t nhits, hmin, hk;
            M = NULL;
            bstart = (int64_t *)malloc((size_t)(m_total + 2) * 4
                                       * sizeof(int64_t));
            if (!bstart) return -1;
            bend = bstart + (m_total + 2);
            cur0 = bend + (m_total + 2);
            cur = cur0 + (m_total + 2);
            /* the shortest needle any offend uses is >= EP_LB_SMALL,
             * so positions with shorter matches can never be visited */
            hmin = EP_LB_SMALL;
            nhits = 0;
            if (ms_ok) {
                /* precomputed all-offstart pass (identical emission) */
                hq = ms_q + ms_offs[offstart];
                hm = ms_m + ms_offs[offstart];
                nhits = ms_cnts[offstart];
            } else {
                zp = ep_i32buf(0, m_total + 2);
                hq = ep_i32buf(1, need);
                hm = ep_i32buf(2, need);
                if (!zp || !hq || !hm) {
                    free(bstart);
                    return -1;   /* error, not a result */
                }
                if (m_total > 0) {
                    ep_zself(P, m_total, zp);
                    nhits = ep_matchstats_emit(P, m_total, allgfact,
                                               allgfactl, zp, hmin, hq,
                                               hm);
                }
            }
            /* bucket the (few) qualifying positions by match length,
             * ascending q within each bucket, then set per-bucket
             * cursors to the first q >= search_from */
            bpos = ep_i32buf(3, nhits + 1);
            if (!bpos) { free(bstart); return -1; }
            for (L = 1; L <= m_total; L++) bstart[L] = 0;
            for (hk = 0; hk < nhits; hk++) bstart[hm[hk]]++;
            {
                int64_t acc = 0;
                for (L = 1; L <= m_total; L++) {
                    int64_t c = bstart[L];
                    bstart[L] = acc;
                    bend[L] = acc;
                    acc += c;
                }
            }
            for (hk = 0; hk < nhits; hk++) bpos[bend[hm[hk]]++] = hq[hk];
            for (L = 1; L <= m_total; L++) {
                int64_t lo = bstart[L], hi = bend[L];
                while (lo < hi) {
                    int64_t mid = (lo + hi) / 2;
                    if (bpos[mid] < search_from) lo = mid + 1;
                    else hi = mid;
                }
                cur0[L] = lo;
            }
            nbuck = m_total;
            (void)M;
            ep_stats[10] += fe_now() - tf;
        }

        for (offend = 0; offend < max_offend; offend++) {
            int64_t ndl, hl, qmax;
            if (eln - offstart - offend <= max_sexon_len) break;
            /* needle/hay bounds with the python slice clamps */
            ndl = eln - offend;
            if (ndl > efactl) ndl = efactl;
            ndl -= offstart;
            hl = allglen2 - offend - MIN_IL;
            if (hl < 0) hl = 0;
            if (hl > allgfactl) hl = allgfactl;
            if (ndl <= 0) {
                /* empty needle: str.find("" , x) returns x while
                 * x <= len(hay), so the python loop visits EVERY
                 * position; the first position whose flanking introns
                 * both classify decides the pair (shared sexon_len,
                 * strict-improvement update) */
                int64_t pos;
                for (pos = search_from; pos <= hl; pos++) {
                    int64_t i1start = allgstart + offstart;
                    int64_t i1end = allgstart + pos - 1;
                    int64_t i2start = i1end + 1 + eln - offstart - offend;
                    int64_t i2end = allgstart + allglen2 - offend - 1;
                    int it1 = ep_classify_itype(gen, glen, i1start, i1end);
                    int it2 = ep_classify_itype(gen, glen, i2start, i2end);
                    if (it1 != 2 && it2 != 2) {
                        int64_t sexon_len = eln - offstart - offend;
                        if (sexon_len > max_sexon_len) {
                            max_sexon_len = sexon_len;
                            ecut1 = estart + offstart;
                            ecut2 = estart + offstart + sexon_len;
                            gcut1_1 = i1start;
                            gcut1_2 = i1end + 1;
                            gcut2_1 = i2start;
                            gcut2_2 = i2end + 1;
                        }
                        break;
                    }
                }
                continue;
            }
            if (ndl > nbuck) continue;   /* needle longer than any match */
            if (ndl < EP_LB_SMALL) {
                /* clamped needle shorter than the emission threshold:
                 * take the direct scan (never happens on valid data) */
                const char *needle, *hay;
                int64_t ndl2, hl2, pos;
                ndl2 = py_slice(efact, efactl, offstart, eln - offend,
                                &needle);
                hl2 = py_slice(allgfact, allgfactl, 0,
                               allglen2 - offend - MIN_IL, &hay);
                pos = ep_find(hay, hl2, needle, ndl2, search_from);
                while (pos != -1) {
                    int64_t i1start = allgstart + offstart;
                    int64_t i1end = allgstart + pos - 1;
                    int64_t i2start = i1end + 1 + eln - offstart - offend;
                    int64_t i2end = allgstart + allglen2 - offend - 1;
                    int it1 = ep_classify_itype(gen, glen, i1start, i1end);
                    int it2 = ep_classify_itype(gen, glen, i2start, i2end);
                    if (it1 != 2 && it2 != 2) {
                        int64_t sexon_len = eln - offstart - offend;
                        if (sexon_len > max_sexon_len) {
                            max_sexon_len = sexon_len;
                            ecut1 = estart + offstart;
                            ecut2 = estart + offstart + sexon_len;
                            gcut1_1 = i1start;
                            gcut1_2 = i1end + 1;
                            gcut2_1 = i2start;
                            gcut2_2 = i2end + 1;
                        }
                        break;
                    }
                    pos = ep_find(hay, hl2, needle, ndl2, pos + 1);
                }
                continue;
            }
            qmax = hl - ndl;
            memcpy(cur + ndl, cur0 + ndl,
                   (size_t)(nbuck - ndl + 1) * sizeof(int64_t));
            for (;;) {
                int64_t best = -1, bestL = -1;
                for (L = ndl; L <= nbuck; L++) {
                    if (cur[L] < bend[L]) {
                        int64_t cq = bpos[cur[L]];
                        if (best == -1 || cq < best) { best = cq; bestL = L; }
                    }
                }
                if (best == -1 || best > qmax) break;
                cur[bestL]++;
                {
                    int64_t pos = best;
                    int64_t i1start = allgstart + offstart;
                    int64_t i1end = allgstart + pos - 1;
                    int64_t i2start = i1end + 1 + eln - offstart - offend;
                    int64_t i2end = allgstart + allglen2 - offend - 1;
                    double ts = fe_now();
                    int it1 = ep_classify_itype(gen, glen, i1start, i1end);
                    int it2 = ep_classify_itype(gen, glen, i2start, i2end);
                    ep_stats[9] += fe_now() - ts;
                    ep_stats[12] += 2.0;
                    if (it1 != 2 && it2 != 2) {
                        /* first qualifying hit decides the pair: within
                         * it sexon_len is constant and only strict
                         * improvements count (exact) */
                        int64_t sexon_len = eln - offstart - offend;
                        if (sexon_len > max_sexon_len) {
                            max_sexon_len = sexon_len;
                            ecut1 = estart + offstart;
                            ecut2 = estart + offstart + sexon_len;
                            gcut1_1 = i1start;
                            gcut1_2 = i1end + 1;
                            gcut2_1 = i2start;
                            gcut2_2 = i2end + 1;
                        }
                        break;
                    }
                }
            }
        }
        free(bstart);
    }
    if (max_sexon_len >= EP_LB_SMALL) {
        efac pnew;
        if (!efct_reserve(f, f->n + 1)) return -1;  /* before mutation */
        pnew.es = ecut1;
        pnew.ee = ecut2 - 1;
        pnew.gs = gcut1_2;
        pnew.ge = gcut2_1 - 1;
        p1 = &f->f[i1];       /* reserve may have moved the array */
        p2 = &f->f[i1 + 1];
        p2->es = ecut2;
        p2->gs = gcut2_2;
        p1->ee = ecut1 - 1;
        p1->ge = gcut1_1 - 1;
        efct_insert(f, i1 + 1, pnew);
        return 1;
    }
    return 0;
}

/* memoized search_small_exon_at_prefix: depends only on p1 coords */
static int ep_search_small_prefix_memo(efct *f, const char *gen,
                                       int64_t glen, const char *est,
                                       int64_t elen,
                                       int64_t min_intron_length) {
    uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
    int found, inserted;
    epm_ent *me;
    epm_key4(mk, 8, &f->f[0]);
    me = epm_find(mk, &found);
    if (found) {
        if (me->v[0]) {
            efac pnew;
            if (!efct_reserve(f, f->n + 1)) return -1;
            pnew.es = (int64_t)(int32_t)(me->v[1] >> 32);
            pnew.ee = (int64_t)(int32_t)(uint32_t)me->v[1];
            pnew.gs = (int64_t)(int32_t)(me->v[2] >> 32);
            pnew.ge = (int64_t)(int32_t)(uint32_t)me->v[2];
            f->f[0].es = (int64_t)(int32_t)(me->v[3] >> 32);
            f->f[0].gs = (int64_t)(int32_t)(uint32_t)me->v[3];
            efct_insert(f, 0, pnew);
            return 1;
        }
        return 0;
    }
    inserted = ep_search_small_prefix(f, gen, glen, est, elen,
                                      min_intron_length);
    if (inserted < 0) {
        if (me) me->gen = epm_gen - 1;   /* claimed but valueless */
        return inserted;
    }
    if (me) {
        me->v[0] = inserted;
        if (inserted) {
            me->v[1] = ((uint64_t)(uint32_t)f->f[0].es << 32)
                       | (uint32_t)f->f[0].ee;
            me->v[2] = ((uint64_t)(uint32_t)f->f[0].gs << 32)
                       | (uint32_t)f->f[0].ge;
            me->v[3] = ((uint64_t)(uint32_t)f->f[1].es << 32)
                       | (uint32_t)f->f[1].gs;
        }
    }
    return inserted;
}

/* memoized search_small_exon: depends only on (p1, p2) coords */
static int ep_search_small_memo(efct *f, int64_t i1, const char *gen,
                                int64_t glen, const char *est,
                                int64_t elen, int64_t min_intron_cfg) {
    uint64_t mk[7];
    int found, inserted;
    epm_ent *me;
    efac *p1 = &f->f[i1];
    efac *p2 = &f->f[i1 + 1];
    mk[0] = 9 | (epm_seq_id << 16);
    mk[1] = ((uint64_t)(uint32_t)p1->es << 32) | (uint32_t)p1->ee;
    mk[2] = ((uint64_t)(uint32_t)p1->gs << 32) | (uint32_t)p1->ge;
    mk[3] = ((uint64_t)(uint32_t)p2->es << 32) | (uint32_t)p2->ee;
    mk[4] = ((uint64_t)(uint32_t)p2->gs << 32) | (uint32_t)p2->ge;
    mk[5] = 0;
    mk[6] = 0;
    me = epm_find(mk, &found);
    if (found) {
        if (me->v[0]) {
            efac pnew;
            if (!efct_reserve(f, f->n + 1)) return -1;
            p1 = &f->f[i1];
            p2 = &f->f[i1 + 1];
            pnew.es = (int64_t)(int32_t)(me->v[1] >> 32);
            pnew.ee = (int64_t)(int32_t)(uint32_t)me->v[1];
            pnew.gs = (int64_t)(int32_t)(me->v[2] >> 32);
            pnew.ge = (int64_t)(int32_t)(uint32_t)me->v[2];
            p1->ee = (int64_t)(int32_t)(me->v[3] >> 32);
            p1->ge = (int64_t)(int32_t)(uint32_t)me->v[3];
            p2->es = (int64_t)(int32_t)(me->v[4] >> 32);
            p2->gs = (int64_t)(int32_t)(uint32_t)me->v[4];
            efct_insert(f, i1 + 1, pnew);
            return 1;
        }
        return 0;
    }
    inserted = ep_search_small(f, i1, gen, glen, est, elen,
                               min_intron_cfg);
    if (inserted < 0) {
        if (me) me->gen = epm_gen - 1;
        return inserted;
    }
    /* the search runs nested ep_classify_itype lookups which may WIPE
     * the memo table and reclaim our slot: re-find (fresh claim if
     * wiped) before storing -- never write through the stale pointer */
    me = epm_find(mk, &found);
    if (me) {
        me->v[0] = inserted;
        if (inserted) {
            /* after the insert: p1 at i1, pnew at i1+1, p2 at i1+2 */
            efac *q1 = &f->f[i1];
            efac *qn = &f->f[i1 + 1];
            efac *q2 = &f->f[i1 + 2];
            me->v[1] = ((uint64_t)(uint32_t)qn->es << 32)
                       | (uint32_t)qn->ee;
            me->v[2] = ((uint64_t)(uint32_t)qn->gs << 32)
                       | (uint32_t)qn->ge;
            me->v[3] = ((uint64_t)(uint32_t)q1->ee << 32)
                       | (uint32_t)q1->ge;
            me->v[4] = ((uint64_t)(uint32_t)q2->es << 32)
                       | (uint32_t)q2->gs;
        }
    }
    return inserted;
}

static int ep_search_new_small_exons(eflst *lst, const char *gen,
                                     int64_t glen, const char *est,
                                     int64_t elen,
                                     int64_t min_intron_length) {
    int64_t k;
    for (k = 0; k < lst->n; k++) {
        efct *f = &lst->a[k];
        int64_t idx = 0, i;
        int r;
        if (f->n == 0) continue;
        if (f->f[0].es > EP_LB_SMALL) {
            r = ep_search_small_prefix_memo(f, gen, glen, est, elen,
                                            min_intron_length);
            if (r < 0) return -1;
            if (r) idx = 1;
        }
        i = idx;
        while (i + 1 < f->n) {
            r = ep_search_small_memo(f, i, gen, glen, est, elen,
                                     min_intron_length);
            if (r < 0) return -1;
            i += r ? 2 : 1;
        }
    }
    return 0;
}

/* refinement.py:clean_factorizations (uses the UNMASKED est sequence);
 * moves survivors from *lst into a fresh list returned in *out.
 * Returns 0 on alloc failure. */
static int ep_clean_facts(eflst *lst, const char *gen, int64_t glen,
                          const char *est_orig, int64_t eolen,
                          int64_t allowed_diff, eflst *out) {
    int64_t k = 0;
    while (k < lst->n) {
        efct *f = &lst->a[k];
        int added = 0;
        ep_clean_noisy(f, gen, glen, est_orig, eolen, 1);
        ep_clean_external(f, gen, glen, est_orig, eolen);
        if (f->n == 0) {
            eflst_del(lst, k);
            continue;
        }
        if (!ep_add_if_not_exists(out, f, allowed_diff, &added)) return 0;
        if (!added) {
            eflst_del(lst, k);
            continue;
        }
        /* moved into out; remove the (now empty) slot without freeing */
        memmove(lst->a + k, lst->a + k + 1,
                (size_t)(lst->n - k - 1) * sizeof(efct));
        lst->n--;
    }
    return 1;
}

/* ---- candidate collection (meg_factorizations with growable output) ---- */

static int64_t fe_collect(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols, const char *gen, int64_t gen_len,
    int64_t min_factor_len, int64_t min_intron_length, double deadline,
    int64_t **out_off, int64_t **out_f, int64_t *out_nf) {

    fe_ctx c;
    int64_t *cnt = NULL, *order = NULL;
    int64_t *coff = NULL, *cf = NULL;
    int64_t coff_cap = 256, cf_cap = 1024;
    int64_t fl = 2 * min_factor_len;
    int64_t nf = 0, nfac = 0, ret = 0;

    memset(&c, 0, sizeof(c));
    c.vp = vp; c.vt = vt; c.vl = vl;
    c.adj_off = adj_off; c.adj = adj;
    c.nv = nv; c.gen = gen; c.gen_len = gen_len;
    c.mfl = min_factor_len; c.min_intron = min_intron_length;
    c.deadline = deadline;
    c.memo = (fe_memo *)calloc((size_t)nv, sizeof(fe_memo));
    cnt = (int64_t *)calloc((size_t)ncols + 1, sizeof(int64_t));
    order = (int64_t *)malloc((size_t)nv * sizeof(int64_t));
    coff = (int64_t *)malloc((size_t)coff_cap * sizeof(int64_t));
    cf = (int64_t *)malloc((size_t)cf_cap * 4 * sizeof(int64_t));
    if (!c.memo || !cnt || !order || !coff || !cf) { ret = -3; goto done; }
    for (int64_t k = 0; k < nv; k++) cnt[vcol[k] + 1]++;
    for (int64_t k = 1; k <= ncols; k++) cnt[k] += cnt[k - 1];
    for (int64_t k = 0; k < nv; k++) order[cnt[vcol[k]]++] = k;

    for (int64_t r = 0; r < nv; r++) {
        int64_t root = order[r];
        if (c.memo[root].done) continue;
        if (fe_subtree(&c, root)) { ret = c.err; goto done; }
        {
            fe_memo *m = &c.memo[root];
            for (int64_t s = 0; s < m->n; s++) {
                femb emb = m->a[s];
                const int64_t *P = c.ar.pool + 3 * emb.off;
                int64_t last = -1;
                if (nf + 2 > coff_cap) {
                    coff_cap *= 2;
                    coff = (int64_t *)realloc(coff,
                                              (size_t)coff_cap
                                              * sizeof(int64_t));
                    if (!coff) { ret = -3; goto done; }
                }
                coff[nf] = nfac;
                for (int64_t k = 0; k < emb.len; k++) {
                    int64_t p = P[3 * k], t = P[3 * k + 1], l = P[3 * k + 2];
                    int start_new = 1;
                    if (last >= 0 && t - cf[4 * last + 3] - 1 <= fl)
                        start_new = 0;
                    if (start_new) {
                        if (nfac + 1 > cf_cap) {
                            cf_cap *= 2;
                            cf = (int64_t *)realloc(
                                cf, (size_t)cf_cap * 4 * sizeof(int64_t));
                            if (!cf) { ret = -3; goto done; }
                        }
                        cf[4 * nfac] = p;
                        cf[4 * nfac + 1] = p + l - 1;
                        cf[4 * nfac + 2] = t;
                        cf[4 * nfac + 3] = t + l - 1;
                        last = nfac;
                        nfac++;
                    } else {
                        cf[4 * last + 1] = p + l - 1;
                        cf[4 * last + 3] = t + l - 1;
                    }
                }
                nf++;
            }
        }
    }
    coff[nf] = nfac;
done:
    for (int64_t k = 0; k < nv; k++) free(c.memo[k].a);
    free(c.memo); free(cnt); free(order); free(c.ar.pool);
    if (ret != 0) {
        free(coff); free(cf);
        *out_off = NULL; *out_f = NULL; *out_nf = 0;
        return ret;
    }
    *out_off = coff;
    *out_f = cf;
    *out_nf = nf;
    return 0;
}

/* ---- device-offload collect/fill (PINTRON_DEVICE=1) ---------------------
 * The noisy-exon K-band checks (ep_clean_noisy) are the cascade's
 * regular, batchable DP workload: per exon, one banded edit distance
 * keyed in the memo purely by factor coordinates.  The device path runs
 * a COLLECT pass (the cascade up to — not including — ep_clean_noisy)
 * that lists every un-memoized K-band problem, evaluates the whole
 * batch across ESTs on the TPU (ops/align.py wavefront kernels, bit-
 * equal to kband_core), pre-FILLS the memo with the device verdicts,
 * then runs est_process normally: ep_clean_noisy memo-hits every exon
 * and the CPU K-band never runs.  Outputs are byte-identical by
 * construction (same memo entries the CPU would have produced).
 *
 * est_collect_noisy: emits 9-int64 records
 *   {es, ee, gs, ge, g_off, g_len, e_off, e_len, max_err}
 * (window offsets are into gen/est after real_substring clamping, so the
 * python side slices bytes directly).  Returns the record count, or
 *   -1 memo unavailable (caller falls back to the plain CPU path)
 *   -2 cap too small (meta[0] = records needed)
 *   -3 allocation failure
 * meta[1] = the persistent memo sequence id (for cross-EST dedup). */
int64_t est_collect_noisy(
    const int64_t *cand_off, const int64_t *cand_f, int64_t n_cand,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t est_length, double complexity_threshold,
    int64_t *out, int64_t cap, int64_t *meta) {

    int64_t ci, k, n_out = 0, need = 0;
    uint64_t set_cap = 64, set_fill = 0;
    uint64_t *set;
    int64_t ret = -3;

    epm_seq_id = epm_begin(gen, glen, est, elen, est_orig, eolen);
    meta[0] = 0;
    meta[1] = (int64_t)epm_seq_id;
    if (epm_seq_id == 0 || !epm_tab) return -1;

    /* local dedup set over (es,ee,gs,ge): same coords may recur across
     * candidates; one problem per memo key */
    {
        int64_t total = 0;
        for (ci = 0; ci < n_cand; ci++)
            total += cand_off[ci + 1] - cand_off[ci];
        while ((int64_t)set_cap < 2 * total + 2) set_cap <<= 1;
    }
    /* 3 words per slot: key0, key1, occupancy flag — the flag keeps the
     * full (w0, w1) key space addressable (a w0==0 key must not be
     * remapped onto the genuine key 1, which would silently drop that
     * factor's K-band problem from the device batch) */
    set = (uint64_t *)calloc((size_t)set_cap * 3, sizeof(uint64_t));
    if (!set) return -3;

    for (ci = 0; ci < n_cand; ci++) {
        efct f = {NULL, 0, 0, 0, 0};
        int is_ok;
        int64_t a = cand_off[ci], b = cand_off[ci + 1];
        if (!efct_reserve(&f, b - a)) goto fail;
        for (k = a; k < b; k++) {
            efac e;
            e.es = cand_f[4 * k];
            e.ee = cand_f[4 * k + 1];
            e.gs = cand_f[4 * k + 2];
            e.ge = cand_f[4 * k + 3];
            f.f[f.n++] = e;
        }
        is_ok = ep_check_not_ss(&f, est_length);
        if (is_ok) is_ok = ep_check_exon_start_end(&f);
        if (is_ok) {
            int ok_ep;
            ep_site = EP_SITE_NOISY;
            ok_ep = ep_handle_endpoints(&f, gen, glen, est, elen);
            ep_site = EP_SITE_CASCADE;
            if (!ok_ep) {
                efct_free(&f);
                goto fail;
            }
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) {
            ep_clean_external(&f, gen, glen, est, elen);
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) {
            ep_clean_low_complexity(&f, gen, glen, est, elen,
                                    complexity_threshold);
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) {
            for (k = 0; k < f.n; k++) {
                efac *e = &f.f[k];
                uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
                uint64_t h, idx;
                int found, dup = 0;
                epm_ent *me;
                if (e->gs > e->ge) continue;  /* ok=0 without a DP */
                epm_key4(mk, 4, e);
                me = epm_find(mk, &found);
                if (found) continue;
                if (me) {
                    /* un-claim: no value yet; give back the fill slot
                     * so collect+fill don't double-count toward the
                     * 3/4-full wipe threshold */
                    me->gen = epm_gen - 1;
                    epm_fill--;
                }
                /* dedup within this collect call */
                h = 1469598103934665603ULL;
                h ^= (uint64_t)e->es; h *= 1099511628211ULL;
                h ^= (uint64_t)e->ee; h *= 1099511628211ULL;
                h ^= (uint64_t)e->gs; h *= 1099511628211ULL;
                h ^= (uint64_t)e->ge; h *= 1099511628211ULL;
                if (h == 0) h = 1;
                idx = h & (set_cap - 1);
                for (;;) {
                    uint64_t w0 = ((uint64_t)(uint32_t)e->es << 32)
                                  | (uint32_t)e->ee;
                    uint64_t w1 = ((uint64_t)(uint32_t)e->gs << 32)
                                  | (uint32_t)e->ge;
                    if (!set[3 * idx + 2] && set_fill < set_cap - 1) {
                        set[3 * idx] = w0;
                        set[3 * idx + 1] = w1;
                        set[3 * idx + 2] = 1;
                        set_fill++;
                        break;
                    }
                    if (set[3 * idx + 2] && set[3 * idx] == w0
                        && set[3 * idx + 1] == w1) { dup = 1; break; }
                    idx = (idx + 1) & (set_cap - 1);
                }
                if (dup) continue;
                need++;
                if (n_out < cap) {
                    int64_t exon_length = e->ge - e->gs + 1;
                    const char *gx, *ex;
                    int64_t gl = rs_sub(gen, glen, e->gs, exon_length,
                                        &gx);
                    int64_t el = rs_sub(est, elen, e->es,
                                        e->ee - e->es + 1, &ex);
                    int64_t *rec = out + 9 * n_out;
                    rec[0] = e->es; rec[1] = e->ee;
                    rec[2] = e->gs; rec[3] = e->ge;
                    rec[4] = gx - gen; rec[5] = gl;
                    rec[6] = ex - est; rec[7] = el;
                    rec[8] = ep_max_edit(exon_length);
                    n_out++;
                }
            }
        }
        efct_free(&f);
    }
    free(set);
    meta[0] = need;
    if (need > cap) return -2;
    return n_out;
fail:
    free(set);
    return ret;
}

/* Pre-fill the noisy-exon memo entries with device-computed verdicts.
 * coords is 4*n int64 (es,ee,gs,ge per problem), ok is n int64 (the
 * ep_kband *ok flag).  Returns 0, or -1 when the memo is unavailable
 * (caller falls back to the CPU path). */
int64_t epm_fill_noisy(
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    const int64_t *coords, const int64_t *ok, int64_t n) {

    int64_t i;
    epm_seq_id = epm_begin(gen, glen, est, elen, est_orig, eolen);
    if (epm_seq_id == 0 || !epm_tab) return -1;
    for (i = 0; i < n; i++) {
        efac e;
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found;
        epm_ent *me;
        e.es = coords[4 * i];
        e.ee = coords[4 * i + 1];
        e.gs = coords[4 * i + 2];
        e.ge = coords[4 * i + 3];
        epm_key4(mk, 4, &e);
        me = epm_find(mk, &found);
        if (me) me->v[0] = ok[i];
    }
    return 0;
}

/* Collect pass for the endpoint-alignment offload: for every candidate
 * factorization that passes the two pure pre-checks (not-source-sink,
 * exon sanity — the checks that precede handle_endpoints in the
 * cascade), emit the head (kind 0) and tail (kind 1) NW problems whose
 * tag-1/2 memo entries are missing.  Single-factor candidates emit
 * only the head: their tail cut runs on the head-mutated factor, a
 * cross-dependency the host path resolves.  Records are 9 int64:
 * {kind, es, ee, gs, ge, e_off, e_len, g_off, g_len}. */
int64_t est_collect_endpoints(
    const int64_t *cand_off, const int64_t *cand_f, int64_t n_cand,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t est_length,
    int64_t *out, int64_t cap, int64_t *meta) {

    int64_t ci, k, n_out = 0, need = 0;
    uint64_t set_cap = 64, set_fill = 0;
    uint64_t *set;
    int64_t ret = -3;

    epm_seq_id = epm_begin(gen, glen, est, elen, est_orig, eolen);
    meta[0] = 0;
    meta[1] = (int64_t)epm_seq_id;
    if (epm_seq_id == 0 || !epm_tab) return -1;

    {
        int64_t total = 0;
        for (ci = 0; ci < n_cand; ci++) total += 2;
        while ((int64_t)set_cap < 2 * total + 2) set_cap <<= 1;
    }
    set = (uint64_t *)calloc((size_t)set_cap * 3, sizeof(uint64_t));
    if (!set) return -3;

    for (ci = 0; ci < n_cand; ci++) {
        efct f = {NULL, 0, 0, 0, 0};
        int64_t a = cand_off[ci], b = cand_off[ci + 1];
        int kind;
        if (!efct_reserve(&f, b - a)) goto fail;
        for (k = a; k < b; k++) {
            efac e;
            e.es = cand_f[4 * k];
            e.ee = cand_f[4 * k + 1];
            e.gs = cand_f[4 * k + 2];
            e.ge = cand_f[4 * k + 3];
            f.f[f.n++] = e;
        }
        if (!ep_check_not_ss(&f, est_length)
            || !ep_check_exon_start_end(&f)) {
            efct_free(&f);
            continue;
        }
        for (kind = 0; kind < 2; kind++) {
            efac *fac;
            uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
            int found;
            epm_ent *me;
            uint64_t w0, w1, idx, h;
            int dup = 0;
            if (kind == 1 && f.n < 2) continue;
            fac = kind == 0 ? &f.f[0] : &f.f[f.n - 1];
            epm_key4(mk, kind == 0 ? 1 : 2, fac);
            me = epm_find(mk, &found);
            if (me && !found) { me->gen = epm_gen - 1; epm_fill--; }
            if (found) continue;
            w0 = ((uint64_t)(uint32_t)fac->es << 32)
                 | (uint32_t)fac->ee;
            w1 = (((uint64_t)(uint32_t)fac->gs << 32)
                  | (uint32_t)fac->ge) ^ ((uint64_t)kind << 62);
            h = 1469598103934665603ULL;
            h ^= w0; h *= 1099511628211ULL;
            h ^= w1; h *= 1099511628211ULL;
            idx = h & (set_cap - 1);
            for (;;) {
                if (!set[3 * idx + 2] && set_fill < set_cap - 1) {
                    set[3 * idx] = w0;
                    set[3 * idx + 1] = w1;
                    set[3 * idx + 2] = 1;
                    set_fill++;
                    break;
                }
                if (set[3 * idx + 2] && set[3 * idx] == w0
                    && set[3 * idx + 1] == w1) { dup = 1; break; }
                idx = (idx + 1) & (set_cap - 1);
            }
            if (dup) continue;
            need++;
            if (n_out < cap) {
                const char *gx, *ex;
                int64_t gl = rs_sub(gen, glen, fac->gs,
                                    fac->ge - fac->gs + 1, &gx);
                int64_t el = rs_sub(est, elen, fac->es,
                                    fac->ee - fac->es + 1, &ex);
                int64_t *rec = out + 9 * n_out;
                rec[0] = kind;
                rec[1] = fac->es; rec[2] = fac->ee;
                rec[3] = fac->gs; rec[4] = fac->ge;
                rec[5] = ex - est; rec[6] = el;
                rec[7] = gx - gen; rec[8] = gl;
                n_out++;
            }
        }
        efct_free(&f);
    }
    free(set);
    meta[0] = need;
    if (need > n_out) return -2;
    return n_out;
fail:
    free(set);
    return ret;
}

/* Pre-fill the endpoint memo (tags 1/2) from device-computed NW
 * tracebacks: per record the caller provides the raw traceback op
 * codes (0=diag, 1=up/gap-in-gen, 2=left/gap-in-est, ordered from the
 * END of the alignment backwards, `nsteps[i]` of them at stride
 * `stride`) as produced by ops/align.batch_nw_traceback; the two
 * gapped strings are materialized HERE (the per-char decode is far too
 * hot for python at production problem counts), and the SAME scan
 * helpers the host path uses (ep_head_cut/ep_tail_cut) derive the
 * memo value — bit-identical to ep_handle_endpoints computing its own
 * nw_align_run alignment. */
int64_t epm_fill_endpoints(
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    const int64_t *recs, int64_t n,
    const int8_t *ops, const int64_t *nsteps, int64_t stride) {

    int64_t i;
    char *ebuf = NULL, *gbuf = NULL;
    int64_t cap = 0;
    epm_seq_id = epm_begin(gen, glen, est, elen, est_orig, eolen);
    if (epm_seq_id == 0 || !epm_tab) return -1;
    for (i = 0; i < n; i++) {
        const int64_t *rec = recs + 9 * i;
        const int8_t *op = ops + i * stride;
        const char *ew = est + rec[5];
        const char *gw = gen + rec[7];
        int64_t el = rec[6], gl = rec[8];
        int64_t ii = el, jj = gl, k, w;
        int64_t alen;
        efac fac;
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found;
        epm_ent *me;
        int64_t out3[3];
        if (el + gl + 2 > cap) {
            char *ne = (char *)realloc(ebuf, (size_t)(2 * (el + gl) + 64));
            char *ng = (char *)realloc(gbuf, (size_t)(2 * (el + gl) + 64));
            if (ne) ebuf = ne;
            if (ng) gbuf = ng;
            if (!ne || !ng) { free(ebuf); free(gbuf); return -3; }
            cap = 2 * (el + gl) + 64;
        }
        /* decode from the END backwards, writing right-to-left */
        w = el + gl;
        for (k = 0; k < nsteps[i] && k < stride; k++) {
            int d = op[k];
            w--;
            if (d == 0) {
                ebuf[w] = ew[ii - 1];
                gbuf[w] = gw[jj - 1];
                ii--; jj--;
            } else if (d == 1) {
                ebuf[w] = ew[ii - 1];
                gbuf[w] = '-';
                ii--;
            } else {
                ebuf[w] = '-';
                gbuf[w] = gw[jj - 1];
                jj--;
            }
        }
        while (ii > 0) {
            w--;
            ebuf[w] = ew[ii - 1];
            gbuf[w] = '-';
            ii--;
        }
        while (jj > 0) {
            w--;
            ebuf[w] = '-';
            gbuf[w] = gw[jj - 1];
            jj--;
        }
        alen = el + gl - w;
        fac.es = rec[1]; fac.ee = rec[2];
        fac.gs = rec[3]; fac.ge = rec[4];
        if (rec[0] == 0)
            ep_head_cut(ebuf + w, gbuf + w, alen,
                        fac.es, fac.gs, out3);
        else
            ep_tail_cut(ebuf + w, gbuf + w, alen,
                        fac.ee, fac.ge, fac.gs, out3);
        epm_key4(mk, rec[0] == 0 ? 1 : 2, &fac);
        me = epm_find(mk, &found);
        if (me) {
            me->v[0] = out3[0];
            me->v[1] = out3[1];
            me->v[2] = out3[2];
        }
    }
    free(ebuf);
    free(gbuf);
    return 0;
}

/* Pre-fill the refine-borders memo (tag 10) from device-computed row
 * tables: minpp/pospp (forward) and minsp/possp (reversed) hold, per
 * record, the per-row minima and FIRST minimal positions of the
 * (lp+1)-row edit DP (refine.c:105-192's two passes), laid out at
 * record stride `stride`.  The cut selection runs HERE with the same
 * rb_select the host DP uses, so the memoized out6 is bit-identical.
 * Records are est_collect_gaps' 9-int64 rows. */
int64_t epm_fill_rb(
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    const int64_t *recs, int64_t n,
    const int64_t *minpp, const int64_t *pospp,
    const int64_t *minsp, const int64_t *possp, int64_t stride) {

    int64_t i;
    epm_seq_id = epm_begin(gen, glen, est, elen, est_orig, eolen);
    if (epm_seq_id == 0 || !epm_tab) return -1;
    for (i = 0; i < n; i++) {
        const int64_t *rec = recs + 9 * i;
        int64_t lp = rec[5], lt = rec[7], gap_p = rec[8];
        const char *t = gen + rec[6];
        int64_t out6[6];
        uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
        int found;
        epm_ent *me;
        if (lp < 0 || lp + 1 > stride) return -2;
        rb_select(lp, 0, lp, t, lt, gap_p,
                  minpp + i * stride, pospp + i * stride,
                  minsp + i * stride, possp + i * stride, out6);
        mk[0] = 10 | (epm_seq_id << 16);
        mk[1] = ((uint64_t)(uint32_t)rec[0] << 32) | (uint32_t)rec[1];
        mk[2] = ((uint64_t)(uint32_t)rec[2] << 32) | (uint32_t)rec[3];
        me = epm_find(mk, &found);
        if (me) {
            me->v[0] = out6[0];
            me->v[1] = out6[1];
            me->v[2] = out6[2];
            me->v[3] = out6[3];
            me->v[4] = out6[4];
        }
    }
    return 0;
}

/* ---- intron (gap-alignment) collect sink --------------------------------
 * When active, est_process_impl replays the refine-intron chains
 * against the tag-3 memo and emits the first un-memoized gap-alignment
 * problem of each chain instead of solving it; the device evaluates
 * ONE speculative batch and the results install into the window-keyed
 * lookaside (ri_lookaside_set) that refine_intron_core probes lazily
 * during the real cascade.  Per-process like every other scratch
 * here.
 * Records are 13 int64s: {d_es, d_ee, d_gs, d_ge, a_es, a_ee, a_gs,
 * a_ge, first, est_arena_off, n, gen_arena_off, m}; window bytes live
 * in the arena. */
/* A window goes to the device batch when its est side is at most
 * ri_dev_max_n and its gen side at most ri_dev_max_m: the gap family's
 * bound, which the device flow sets (ri_dev_set_bounds) before it
 * collects.  Until then both are 0 and no window is collected. */
static int64_t ri_dev_max_n = 0, ri_dev_max_m = 0;

void ri_dev_set_bounds(int64_t max_n, int64_t max_m) {
    ri_dev_max_n = max_n;
    ri_dev_max_m = max_m;
}

typedef struct {
    int64_t *out;
    char *arena;
    int64_t cap, arena_cap;
    int64_t n, arena_n;
    int64_t need, arena_need;
    int64_t too_wide;   /* windows over the bound, left to the host */
    int active;
} ri_sink_t;
static ri_sink_t ri_sink;

/* ---- est_process: the full per-EST post-MEG flow ------------------------
 * Returns the number of FINAL factorizations (>= 0), or:
 *   -1 timeout during candidate enumeration
 *   -2 output caps too small (counts[1] = facts needed incl. flags,
 *      counts[2] = factors needed)
 *   -3 allocation failure (python fallback)
 *   -4 unsupported case (python fallback; e.g. outsized refine-intron)
 * counts[0] = number of flag pairs written to out_polya/out_polyad (the
 * pre-refinement factorization count; the python writer zips flags with
 * the final factorizations exactly like the host path).
 * When pre_off != NULL the candidate enumeration is skipped and the
 * (pre_off, pre_f, pre_n) arrays — the exact meg_factorizations output —
 * are consumed instead (device-offload flow; arrays stay caller-owned). */
static int64_t est_process_impl(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t min_factor_len, int64_t min_intron_length, double deadline,
    double complexity_threshold, int64_t max_site_difference,
    double max_coverage_diff, int64_t max_gapLength_diff,
    int64_t max_number_of_factorizations,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen,
    int64_t *out_off, int64_t *out_f,
    int64_t *out_polya, int64_t *out_polyad,
    int64_t cap_facts, int64_t cap_factors, int64_t *counts,
    const int64_t *pre_off, const int64_t *pre_f, int64_t pre_n,
    int64_t *gaps_out, int64_t gaps_cap, int64_t *gaps_meta) {

    int64_t *cand_off = NULL, *cand_f = NULL, n_cand = 0;
    int64_t est_length = ncols - 2;
    eflst lst = {NULL, 0, 0};
    eflst cleaned = {NULL, 0, 0};
    int64_t rc, ci, k;
    int64_t n_flags = 0;
    int64_t ret = -3;
    int owned = 1;
    double t0 = fe_now(), t1;

    epm_seq_id = epm_begin(gen, glen, est, elen, est_orig, eolen);
    if (pre_off != NULL) {
        cand_off = (int64_t *)pre_off;
        cand_f = (int64_t *)pre_f;
        n_cand = pre_n;
        owned = 0;
    } else {
        rc = fe_collect(vp, vt, vl, vcol, adj_off, adj, nv, ncols, gen,
                        glen, min_factor_len, min_intron_length, deadline,
                        &cand_off, &cand_f, &n_cand);
        if (rc != 0) return rc;
    }
    t1 = fe_now(); ep_stats[0] += t1 - t0; t0 = t1;

    /* per-candidate cascade (est_fact.py:get_est_factorizations) */
    for (ci = 0; ci < n_cand; ci++) {
        efct f = {NULL, 0, 0, 0, 0};
        int is_ok;
        int64_t a = cand_off[ci], b = cand_off[ci + 1];
        if (!efct_reserve(&f, b - a)) goto fail;
        for (k = a; k < b; k++) {
            efac e;
            e.es = cand_f[4 * k];
            e.ee = cand_f[4 * k + 1];
            e.gs = cand_f[4 * k + 2];
            e.ge = cand_f[4 * k + 3];
            f.f[f.n++] = e;
        }
        is_ok = ep_check_not_ss(&f, est_length);
        if (is_ok) is_ok = ep_check_exon_start_end(&f);
        if (is_ok) {
            if (!ep_handle_endpoints(&f, gen, glen, est, elen)) {
                efct_free(&f);
                goto fail;
            }
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) {
            ep_clean_external(&f, gen, glen, est, elen);
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) {
            ep_clean_low_complexity(&f, gen, glen, est, elen,
                                    complexity_threshold);
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) {
            ep_clean_noisy(&f, gen, glen, est, elen, 0);
            if (f.n == 0) is_ok = 0;
        }
        if (is_ok) is_ok = ep_check_coverage(&f, elen);
        if (is_ok) {
            int added = 0;
            if (!ep_add_if_not_exists(&lst, &f, max_site_difference,
                                      &added)) {
                efct_free(&f);
                goto fail;
            }
            if (!added) efct_free(&f);
        } else {
            efct_free(&f);
        }
    }
    if (owned) { free(cand_off); free(cand_f); }
    cand_off = cand_f = NULL;
    t1 = fe_now(); ep_stats[1] += t1 - t0; t0 = t1;

    /* coverage + FILTER 1 (est-factorizations.c:272-331) */
    {
        double *covs = (double *)malloc((size_t)(lst.n + 1)
                                        * sizeof(double));
        double max_coverage = 0.0;
        int64_t w = 0;
        if (!covs) goto fail;
        for (k = 0; k < lst.n; k++) {
            const efct *f = &lst.a[k];
            int is_ss = 0;
            if (f->n == 1
                && (f->f[0].es < 0 || f->f[0].es >= est_length)) {
                covs[k] = -1.0;
                is_ss = 1;
            }
            if (!is_ss) {
                covs[k] = ep_coverage(f, est_length);
                if (max_coverage < covs[k]) max_coverage = covs[k];
            }
        }
        for (k = 0; k < lst.n; k++) {
            int drop = covs[k] == -1.0
                       || max_coverage - covs[k] > max_coverage_diff
                       || (max_coverage - covs[k]) * (double)elen > 100.0;
            if (drop) {
                efct_free(&lst.a[k]);
            } else {
                lst.a[w++] = lst.a[k];
            }
        }
        lst.n = w;
        free(covs);
    }

    /* FILTER 3: total gap length */
    {
        int64_t min_gap = -1, w = 0;
        int64_t *gls = (int64_t *)malloc((size_t)(lst.n + 1)
                                         * sizeof(int64_t));
        if (!gls) goto fail;
        for (k = 0; k < lst.n; k++) {
            gls[k] = ep_gap_length(&lst.a[k]);
            if (min_gap == -1 || min_gap > gls[k]) min_gap = gls[k];
        }
        if (max_gapLength_diff != -1) {
            for (k = 0; k < lst.n; k++) {
                if (gls[k] - min_gap <= max_gapLength_diff)
                    lst.a[w++] = lst.a[k];
                else
                    efct_free(&lst.a[k]);
            }
            lst.n = w;
        }
        free(gls);
    }

    /* COLLECT MODE (gaps_out != NULL): the device-offload flow replays
     * the cascade to this point (all prior filters are deterministic
     * with the K-band memo warm) and collects every gap problem FILTER
     * 4 would hand to refine_borders — 9 int64s per record:
     * {donor_ee, donor_ge, accept_es, accept_gs, p_off, lp, t_off, lt,
     * gap_p}.  Pairs whose (tag 10) memo entry already exists are
     * skipped.  Returns the record count (or -2, needed in
     * gaps_meta[0]); the candidate/output state is discarded. */
    if (gaps_out != NULL) {
        int64_t n_out = 0, need = 0;
        for (k = 0; k < lst.n; k++) {
            efct *f = &lst.a[k];
            int64_t kk;
            for (kk = 0; kk + 1 < f->n; kk++) {
                efac *donor = &f->f[kk];
                efac *accept = &f->f[kk + 1];
                int64_t gap_p = accept->es - donor->ee - 1;
                int64_t gap_t, lp, lt;
                const char *pp, *tt;
                uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
                int found = 0;
                if (gap_p <= 0) continue;
                mk[0] = 10 | (epm_seq_id << 16);
                mk[1] = ((uint64_t)(uint32_t)donor->ee << 32)
                        | (uint32_t)donor->ge;
                mk[2] = ((uint64_t)(uint32_t)accept->es << 32)
                        | (uint32_t)accept->gs;
                if (epm_seq_id != 0 && epm_tab) {
                    epm_ent *me = epm_find(mk, &found);
                    if (!found && me) {
                        /* peek only: un-claim AND give back the fill
                         * slot, or repeated collect passes would drift
                         * epm_fill upward and trigger spurious
                         * full-memo wipes */
                        me->gen = epm_gen - 1;
                        epm_fill--;
                    }
                }
                if (found) continue;
                gap_t = accept->gs - donor->ge - 1;
                lp = rs_sub(est, elen, donor->ee + 1, gap_p, &pp);
                lt = rs_sub(gen, glen, donor->ge + 1, gap_t, &tt);
                need++;
                if (n_out < gaps_cap) {
                    int64_t *rec = gaps_out + 9 * n_out;
                    rec[0] = donor->ee; rec[1] = donor->ge;
                    rec[2] = accept->es; rec[3] = accept->gs;
                    rec[4] = pp - est; rec[5] = lp;
                    rec[6] = tt - gen; rec[7] = lt;
                    rec[8] = gap_p;
                    n_out++;
                }
            }
        }
        gaps_meta[0] = need;
        for (k = 0; k < lst.n; k++) efct_free(&lst.a[k]);
        free(lst.a);
        lst.a = NULL; lst.n = 0;
        if (need > n_out) return -2;
        return n_out;
    }

    /* FILTER 4: gap errors */
    {
        int64_t w = 0;
        int bad = 0;
        for (k = 0; k < lst.n; k++) {
            int r = bad ? -1 : ep_check_gap_errors(&lst.a[k], est, elen,
                                                   gen, glen);
            if (r < 0) { bad = 1; efct_free(&lst.a[k]); continue; }
            if (r)
                lst.a[w++] = lst.a[k];
            else
                efct_free(&lst.a[k]);
        }
        lst.n = w;
        if (bad) goto fail;   /* ret == -3: python fallback */
    }

    /* artifact check */
    if (max_number_of_factorizations != 0
        && lst.n > max_number_of_factorizations) {
        for (k = 0; k < lst.n; k++) efct_free(&lst.a[k]);
        lst.n = 0;
    }

    t1 = fe_now(); ep_stats[2] += t1 - t0; t0 = t1;

    /* INTRON COLLECT MODE (ri_sink.active): replay each factorization's
     * refine-intron CHAIN against the tag-3 memo.  Memo hits apply
     * ep_refine_intron's mutation rules and the chain stays exact; at
     * the first miss the chain turns SPECULATIVE: every remaining
     * pair's windows (byte-identical to refine_intron_core's
     * construction, built from the un-mutated coordinates) are emitted
     * for one device batch, deduped by window content.  Later pairs'
     * windows are coordinate-mutation independent except for
     * sub-window-length factors, whose stale windows simply miss the
     * lookaside at cascade time (host computes them); oversized
     * problems are not emitted for the same reason.  The device flow
     * runs ONE collect pass; the cascade consumes the results lazily
     * through the window-keyed lookaside. */
    if (ri_sink.active) {
        int64_t n_out = 0, need = 0, arena_need = 0;
        /* window-content dedup across pairs/candidates (candidates of
         * one EST share most pairs): open-addressed set of emitted
         * record indices keyed by window bytes */
        int64_t dcap = 1024, dfill = 0;
        int32_t *dset = (int32_t *)calloc((size_t)dcap, sizeof(int32_t));
        for (k = 0; k < lst.n && dset; k++) {
            efct *f = &lst.a[k];
            int first = 1;
            int speculative = 0;
            int64_t j, limit = f->n - 1;
            if (f->n == 0) continue;
            for (j = 0; j < limit; j++) {
                efac *donor = &f->f[j];
                efac *accept = &f->f[j + 1];
                int found = 0;
                epm_ent *me = NULL;
                if (!speculative) {
                    uint64_t mk[7] = {0, 0, 0, 0, 0, 0, 0};
                    mk[0] = 3 | ((uint64_t)(first ? 1 : 0) << 8)
                            | (epm_seq_id << 16);
                    mk[1] = ((uint64_t)(uint32_t)donor->es << 32)
                            | (uint32_t)donor->ee;
                    mk[2] = ((uint64_t)(uint32_t)donor->gs << 32)
                            | (uint32_t)donor->ge;
                    mk[3] = ((uint64_t)(uint32_t)accept->es << 32)
                            | (uint32_t)accept->ee;
                    mk[4] = ((uint64_t)(uint32_t)accept->gs << 32)
                            | (uint32_t)accept->ge;
                    me = epm_find(mk, &found);
                }
                if (found) {
                    /* memo hit: apply ep_refine_intron's mutations and
                     * keep the chain exact */
                    int64_t mret = me->v[0];
                    if (mret < 0) break;   /* python-fallback pair */
                    if (mret == 1) {
                        accept->es = me->v[3];
                        accept->gs = me->v[2];
                    } else if (mret == 2) {
                        donor->ge = me->v[1];
                        accept->gs = me->v[2];
                        accept->es = me->v[3];
                        donor->ee = accept->es - 1;
                    }
                    first = 0;
                    continue;
                }
                if (me) {   /* peek only: un-claim and refund */
                    me->gen = epm_gen - 1;
                    epm_fill--;
                }
                /* un-memoized pair: emit its windows SPECULATIVELY and
                 * keep walking the chain with unmutated coordinates —
                 * later pairs' windows are coordinate-mutation
                 * independent except for sub-window-length factors,
                 * which the lazy lookaside simply misses (host
                 * computes those).  No memo lookups after this point:
                 * the keys would be built from unmutated coords. */
                speculative = 1;
                {
                    ri_win w;
                    if (!ri_build_windows(
                            gen, glen, est, elen,
                            donor->es, donor->ee, donor->gs, donor->ge,
                            accept->es, accept->ee, accept->gs,
                            accept->ge, sp_est, sp_intron, sp_gen, &w)) {
                        first = 0;
                        continue;
                    }
                    if (w.n > ri_dev_max_n || w.m > ri_dev_max_m) {
                        ri_sink.too_wide++;
                        first = 0;
                        continue;   /* host computes oversized lazily */
                    }
                    /* dedup by window content */
                    {
                        uint64_t h = ri_hash_win(ri_seq_est, w.n,
                                                 ri_seq_gen, w.m);
                        int64_t idx = (int64_t)(h & (uint64_t)(dcap - 1));
                        int dup = 0;
                        while (dset[idx]) {
                            const int64_t *rec = ri_sink.out
                                + 13 * (dset[idx] - 1);
                            if (rec[10] == w.n && rec[12] == w.m
                                && memcmp(ri_sink.arena + rec[9],
                                          ri_seq_est, (size_t)w.n) == 0
                                && memcmp(ri_sink.arena + rec[11],
                                          ri_seq_gen, (size_t)w.m)
                                   == 0) {
                                dup = 1;
                                break;
                            }
                            idx = (idx + 1) & (dcap - 1);
                        }
                        if (dup) {
                            first = 0;
                            continue;
                        }
                        need++;
                        arena_need += w.n + w.m;
                        if (n_out < ri_sink.cap
                            && ri_sink.arena_n + w.n + w.m
                               <= ri_sink.arena_cap) {
                            int64_t *rec = ri_sink.out + 13 * n_out;
                            rec[0] = donor->es; rec[1] = donor->ee;
                            rec[2] = donor->gs; rec[3] = donor->ge;
                            rec[4] = accept->es; rec[5] = accept->ee;
                            rec[6] = accept->gs; rec[7] = accept->ge;
                            rec[8] = first;
                            rec[9] = ri_sink.arena_n; rec[10] = w.n;
                            rec[11] = ri_sink.arena_n + w.n;
                            rec[12] = w.m;
                            memcpy(ri_sink.arena + ri_sink.arena_n,
                                   ri_seq_est, (size_t)w.n);
                            memcpy(ri_sink.arena + ri_sink.arena_n
                                   + w.n, ri_seq_gen, (size_t)w.m);
                            ri_sink.arena_n += w.n + w.m;
                            n_out++;
                            dset[idx] = (int32_t)n_out;
                            dfill++;
                            if (4 * dfill > 3 * dcap) {
                                /* grow + rebuild from the records */
                                int64_t ncap = dcap * 2, r2;
                                int32_t *nd = (int32_t *)calloc(
                                    (size_t)ncap, sizeof(int32_t));
                                if (!nd) { free(dset); dset = NULL;
                                           break; }
                                for (r2 = 0; r2 < n_out; r2++) {
                                    const int64_t *rec = ri_sink.out
                                        + 13 * r2;
                                    uint64_t h2 = ri_hash_win(
                                        ri_sink.arena + rec[9], rec[10],
                                        ri_sink.arena + rec[11],
                                        rec[12]);
                                    int64_t i2 = (int64_t)(h2
                                        & (uint64_t)(ncap - 1));
                                    while (nd[i2])
                                        i2 = (i2 + 1) & (ncap - 1);
                                    nd[i2] = (int32_t)(r2 + 1);
                                }
                                free(dset);
                                dset = nd;
                                dcap = ncap;
                            }
                        }
                    }
                }
                first = 0;
            }
        }
        free(dset);
        ri_sink.n = n_out;
        ri_sink.need = need;
        ri_sink.arena_need = arena_need;
        for (k = 0; k < lst.n; k++) efct_free(&lst.a[k]);
        free(lst.a);
        lst.a = NULL; lst.n = 0;
        if (need > n_out) return -2;
        return n_out;
    }

    /* intron refinement (est-factorizations.c:444-492) */
    for (k = 0; k < lst.n; k++) {
        efct *f = &lst.a[k];
        int first = 1;
        int64_t j, limit = f->n - 1;
        if (f->n == 0) continue;
        for (j = 0; j < limit; j++) {
            if (ep_refine_intron(gen, glen, est, elen, &f->f[j],
                                 &f->f[j + 1], sp_est, sp_intron, sp_gen,
                                 min_intron_length, first) < 0) {
                ret = -4;
                goto fail;
            }
            first = 0;
        }
        if (f->n >= 2 && f->f[0].es == f->f[1].es) efct_del(f, 0);
    }

    t1 = fe_now(); ep_stats[3] += t1 - t0; t0 = t1;

    /* polyA detection (flags parallel to the pre-refinement list) */
    n_flags = lst.n;
    if (n_flags > cap_facts) {
        counts[0] = 0;
        counts[1] = n_flags;
        counts[2] = 0;
        ret = -2;
        goto fail;
    }
    for (k = 0; k < lst.n; k++) {
        efct *f = &lst.a[k];
        int64_t pa = 0, pd = 0;
        if (f->n > 0) {
            ep_correct_tail(f, gen, glen, est_orig, eolen);
            ep_detect_polya(f, gen, glen, est_orig, eolen, &pa, &pd);
        }
        out_polya[k] = pa;
        out_polyad[k] = pd;
    }

    t1 = fe_now(); ep_stats[4] += t1 - t0; t0 = t1;

    /* refinement pass (refinement.py:refine_est_factorizations) */
    ep_remove_invalid(&lst);
    ep_remove_dup(&lst);
    if (!ep_recover_affixes(&lst, gen, glen, est, elen)) goto fail;
    if (ep_remove_false_small(&lst, gen, glen, est, elen) < 0)
        goto fail;   /* ret == -3: python fallback */
    ep_remove_dup(&lst);
    t1 = fe_now(); ep_stats[5] += t1 - t0; t0 = t1;
    if (ep_search_new_small_exons(&lst, gen, glen, est, elen,
                                  min_intron_length) < 0)
        goto fail;   /* scratch failure: python fallback (ret stays -3) */
    t1 = fe_now(); ep_stats[6] += t1 - t0; t0 = t1;
    if (!ep_clean_facts(&lst, gen, glen, est_orig, eolen,
                        max_site_difference, &cleaned))
        goto fail;
    eflst_free(&lst);
    lst = cleaned;
    cleaned.a = NULL; cleaned.n = cleaned.cap = 0;

    /* final pruning (compute-est-fact.c:154-190 tail) */
    ep_remove_very_small(&lst);
    if (lst.n) ep_remove_dup(&lst);

    /* emit */
    {
        int64_t nfac = 0;
        for (k = 0; k < lst.n; k++) nfac += lst.a[k].n;
        counts[0] = n_flags;
        counts[1] = lst.n > n_flags ? lst.n : n_flags;
        counts[2] = nfac;
        if (lst.n + 1 > cap_facts + 1 || nfac > cap_factors) {
            ret = -2;
            goto fail;
        }
        nfac = 0;
        for (k = 0; k < lst.n; k++) {
            out_off[k] = nfac;
            for (int64_t j = 0; j < lst.a[k].n; j++) {
                out_f[4 * nfac] = lst.a[k].f[j].es;
                out_f[4 * nfac + 1] = lst.a[k].f[j].ee;
                out_f[4 * nfac + 2] = lst.a[k].f[j].gs;
                out_f[4 * nfac + 3] = lst.a[k].f[j].ge;
                nfac++;
            }
        }
        out_off[lst.n] = nfac;
        ret = lst.n;
    }
fail:
    if (owned) {
        free(cand_off);
        free(cand_f);
    }
    eflst_free(&lst);
    eflst_free(&cleaned);
    ep_stats[7] += fe_now() - t0;
    return ret;
}

int64_t est_process(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t min_factor_len, int64_t min_intron_length, double deadline,
    double complexity_threshold, int64_t max_site_difference,
    double max_coverage_diff, int64_t max_gapLength_diff,
    int64_t max_number_of_factorizations,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen,
    int64_t *out_off, int64_t *out_f,
    int64_t *out_polya, int64_t *out_polyad,
    int64_t cap_facts, int64_t cap_factors, int64_t *counts) {
    return est_process_impl(
        vp, vt, vl, vcol, adj_off, adj, nv, ncols, gen, glen, est, elen,
        est_orig, eolen, min_factor_len, min_intron_length, deadline,
        complexity_threshold, max_site_difference, max_coverage_diff,
        max_gapLength_diff, max_number_of_factorizations, sp_est,
        sp_intron, sp_gen, out_off, out_f, out_polya, out_polyad,
        cap_facts, cap_factors, counts, NULL, NULL, 0, NULL, 0, NULL);
}

/* est_process consuming a pre-enumerated candidate set (the exact
 * meg_factorizations output) — the device-offload flow enumerates once,
 * collects + batches the K-band problems on the TPU, pre-fills the memo
 * (epm_fill_noisy) and then runs the cascade here. */
int64_t est_process_cands(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t min_factor_len, int64_t min_intron_length, double deadline,
    double complexity_threshold, int64_t max_site_difference,
    double max_coverage_diff, int64_t max_gapLength_diff,
    int64_t max_number_of_factorizations,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen,
    int64_t *out_off, int64_t *out_f,
    int64_t *out_polya, int64_t *out_polyad,
    int64_t cap_facts, int64_t cap_factors, int64_t *counts,
    const int64_t *pre_off, const int64_t *pre_f, int64_t pre_n) {
    return est_process_impl(
        vp, vt, vl, vcol, adj_off, adj, nv, ncols, gen, glen, est, elen,
        est_orig, eolen, min_factor_len, min_intron_length, deadline,
        complexity_threshold, max_site_difference, max_coverage_diff,
        max_gapLength_diff, max_number_of_factorizations, sp_est,
        sp_intron, sp_gen, out_off, out_f, out_polya, out_polyad,
        cap_facts, cap_factors, counts, pre_off, pre_f, pre_n,
        NULL, 0, NULL);
}

/* Collect pass for the refine-borders offload: replays the cascade
 * (with a warm K-band memo) through the coverage/gap-length filters and
 * emits FILTER 4's gap problems instead of solving them
 * (est-factorizations.c:416-433 -> refine.c:105-192).  Same argument
 * block as est_process_cands plus the output buffer. */
int64_t est_collect_gaps(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t min_factor_len, int64_t min_intron_length, double deadline,
    double complexity_threshold, int64_t max_site_difference,
    double max_coverage_diff, int64_t max_gapLength_diff,
    int64_t max_number_of_factorizations,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen,
    const int64_t *pre_off, const int64_t *pre_f, int64_t pre_n,
    int64_t *gaps_out, int64_t gaps_cap, int64_t *gaps_meta) {
    int64_t counts[4] = {0, 0, 0, 0};
    int64_t r;
    ep_site = EP_SITE_GAPS;
    r = est_process_impl(
        vp, vt, vl, vcol, adj_off, adj, nv, ncols, gen, glen, est, elen,
        est_orig, eolen, min_factor_len, min_intron_length, deadline,
        complexity_threshold, max_site_difference, max_coverage_diff,
        max_gapLength_diff, max_number_of_factorizations, sp_est,
        sp_intron, sp_gen, NULL, NULL, NULL, NULL, 0, 0, counts,
        pre_off, pre_f, pre_n, gaps_out, gaps_cap, gaps_meta);
    ep_site = EP_SITE_CASCADE;
    return r;
}

/* Collect pass for the intron-refinement (gap-alignment) offload:
 * replays the cascade through FILTER 4 (K-band/rb memos warm), then
 * walks the refine-intron chains against the tag-3 memo and emits the
 * first un-memoized 3-matrix gap problem of each chain (see the
 * INTRON COLLECT MODE block in est_process_impl; reference:
 * est-factorizations.c:444-492 -> refine-intron.c:47-265).
 * Returns the record count, or -2 when caps are too small
 * (meta[0] = records needed, meta[1] = arena bytes needed), or any
 * other negative est_process error; meta[2] = the windows left to the
 * host for their size (ri_dev_set_bounds). */
int64_t est_collect_introns(
    const int64_t *vp, const int64_t *vt, const int64_t *vl,
    const int64_t *vcol, const int64_t *adj_off, const int64_t *adj,
    int64_t nv, int64_t ncols,
    const char *gen, int64_t glen,
    const char *est, int64_t elen,
    const char *est_orig, int64_t eolen,
    int64_t min_factor_len, int64_t min_intron_length, double deadline,
    double complexity_threshold, int64_t max_site_difference,
    double max_coverage_diff, int64_t max_gapLength_diff,
    int64_t max_number_of_factorizations,
    int64_t sp_est, int64_t sp_intron, int64_t sp_gen,
    const int64_t *pre_off, const int64_t *pre_f, int64_t pre_n,
    int64_t *recs_out, int64_t recs_cap,
    char *arena_out, int64_t arena_cap, int64_t *meta) {
    int64_t counts[4] = {0, 0, 0, 0};
    int64_t r;
    ri_sink.out = recs_out;
    ri_sink.arena = arena_out;
    ri_sink.cap = recs_cap;
    ri_sink.arena_cap = arena_cap;
    ri_sink.n = 0;
    ri_sink.arena_n = 0;
    ri_sink.need = 0;
    ri_sink.arena_need = 0;
    ri_sink.too_wide = 0;
    ri_sink.active = 1;
    ep_site = EP_SITE_INTRONS;
    r = est_process_impl(
        vp, vt, vl, vcol, adj_off, adj, nv, ncols, gen, glen, est, elen,
        est_orig, eolen, min_factor_len, min_intron_length, deadline,
        complexity_threshold, max_site_difference, max_coverage_diff,
        max_gapLength_diff, max_number_of_factorizations, sp_est,
        sp_intron, sp_gen, NULL, NULL, NULL, NULL, 0, 0, counts,
        pre_off, pre_f, pre_n, NULL, 0, NULL);
    ri_sink.active = 0;
    ep_site = EP_SITE_CASCADE;
    meta[0] = ri_sink.need;
    meta[1] = ri_sink.arena_need;
    meta[2] = ri_sink.too_wide;
    return r;
}

/* ======================================================================
 * Fused per-unit driver: the whole est-fact inner loop for one work unit
 * (a fixed-strand EST, or a forward EST plus its reverse-complement
 * copy) in ONE native call — vertex scan, MEG build with the
 * complexity/same-MEG/timeout retry ladder (compute-est-fact.c:192-293),
 * est_process, and all six output-stream text sections
 * (main-est-fact.c:144-178 writers, io-multifasta.c:187-243).
 *
 * Inputs mirror stages/est_fact.py:_process_unit; outputs are the six
 * text blobs in (raw, megs, processed-megs, megs-info, processed-ests,
 * meg-edges) order, concatenated into `out` with lengths in
 * out_meta[0..5].
 *
 * Returns 0 on success; -2 when `cap` is too small (needed total in
 * out_meta[6]); any other negative value means "fall back to the host
 * path for this unit" (rare allocation/edge cases — the host path
 * recomputes from scratch, so falling back is always safe).
 * ====================================================================== */

typedef struct { char *d; int64_t n, cap; } sbuf;

static int sb_reserve(sbuf *b, int64_t extra) {
    if (b->n + extra <= b->cap) return 1;
    int64_t ncap = b->cap ? b->cap : 4096;
    while (b->n + extra > ncap) ncap *= 2;
    char *nd = (char *)realloc(b->d, (size_t)ncap);
    if (!nd) return 0;
    b->d = nd; b->cap = ncap;
    return 1;
}

static int sb_put(sbuf *b, const char *s, int64_t len) {
    if (len <= 0) return 1;   /* memcpy(NULL src) is UB even for 0 */
    if (!sb_reserve(b, len)) return 0;
    memcpy(b->d + b->n, s, (size_t)len);
    b->n += len;
    return 1;
}

static int sb_puti(sbuf *b, int64_t x) {
    if (!sb_reserve(b, 24)) return 0;
    b->n = fmt_i64(b->d + b->n, x) - b->d;
    return 1;
}

/* grow-only int64 scratch (per-process; workers are single-threaded) */
static int64_t *up_bufs[16];
static int64_t up_caps[16];

static int64_t *up_i64(int slot, int64_t need) {
    if (need <= up_caps[slot]) return up_bufs[slot];
    int64_t ncap = up_caps[slot] ? up_caps[slot] : 4096;
    while (ncap < need) ncap *= 2;
    int64_t *nb = (int64_t *)realloc(up_bufs[slot], (size_t)ncap * 8);
    if (!nb) return NULL;
    up_bufs[slot] = nb; up_caps[slot] = ncap;
    return nb;
}

static int64_t up_cap(int slot, int64_t at_least) {
    return up_caps[slot] > at_least ? up_caps[slot] : at_least;
}

typedef struct {
    const unsigned char *text; int64_t tlen;
    const int64_t *st_start, *st_end, *st_parent, *st_slink, *st_depth;
    const unsigned char *st_single;
    const int64_t *st_lo, *st_hi, *st_occ, *st_coff;
    const unsigned char *st_cchar;
    const int64_t *st_cnode;
    const int64_t *a256; int64_t alph_size;
    const char *gen; int64_t glen;
    const char *gen_orig; int64_t golen;
    int64_t gen_pref_n;
    const int64_t *icfg; const double *dcfg;
} up_ctx;

/* Run ONE EST through the complete est-fact inner loop
 * (compute-est-fact.c:192-293): MEG build with the complexity /
 * same-MEG / timeout retry ladders, est_process, and the output-text
 * sections appended to the six stream buffers S.
 * Returns 1 (has factorizations), 0 (none), or a negative code meaning
 * "fall back to the host path". */
static int64_t up_est_run(const up_ctx *C,
                          const char *eid, int64_t idlen,
                          const unsigned char *seq, int64_t elen,
                          const char *orig, int64_t olen,
                          int64_t suffpa, sbuf *S) {
    const int64_t *icfg = C->icfg;
    const double *dcfg = C->dcfg;
    const int64_t base_mfl = icfg[0], max_intron = icfg[1],
        min_intron = icfg[2], max_pairings = icfg[3],
        trans_red = icfg[4], short_edge_comp = icfg[5],
        max_site_diff = icfg[6], max_gap_diff = icfg[7],
        max_nf = icfg[8], sp_est = icfg[9], sp_intron = icfg[10],
        sp_gen = icfg[11], retain_ext = icfg[12];
    const double rate = dcfg[0], pref_rate = dcfg[1], suff_rate = dcfg[2],
        max_freq_shortest = dcfg[3], complexity_thr = dcfg[4],
        max_cov_diff = dcfg[5], max_fact_time = dcfg[6];

    int64_t inc = 0, prev_p = 0, prev_e = 0;

    for (;;) {   /* retry-on-timeout ladder */
        double t_meg0 = fe_now();
        int64_t nv = 0, tot_p = 0, tot_e = 0;
        int64_t *mp = NULL, *mt = NULL, *ml = NULL, *mcol = NULL,
            *moff = NULL, *madj = NULL;
        int64_t flags[5];

        for (;;) {   /* same-MEG detection loop */
            int64_t n_scan;
            int64_t sc_cap = up_cap(0, 4096);
            int64_t *sc_p, *sc_t, *sc_l;
            for (;;) {   /* vertex scan + complexity ladder */
                int64_t mfl = base_mfl + inc;
                double wt0 = fe_now();
                for (;;) {
                    sc_p = up_i64(0, sc_cap);
                    sc_t = up_i64(1, sc_cap);
                    sc_l = up_i64(2, sc_cap);
                    if (!sc_p || !sc_t || !sc_l) return -3;
                    n_scan = vertex_scan(
                        C->text, C->tlen, seq, elen,
                        C->st_start, C->st_end, C->st_parent, C->st_slink,
                        C->st_depth, C->st_single, C->st_lo, C->st_hi,
                        C->st_occ, C->st_coff, C->st_cchar, C->st_cnode,
                        C->a256, C->alph_size, rate, mfl,
                        sc_p, sc_t, sc_l, sc_cap);
                    if (n_scan == -1) return -3;
                    if (n_scan < -1) { sc_cap = -n_scan; continue; }
                    break;
                }
                wr_stats[0] += fe_now() - wt0;
                wt0 = fe_now();
                {
                    int64_t cap_v = up_cap(3, n_scan + 16);
                    int64_t cap_e = up_cap(
                        8, 8 * n_scan > 1024 ? 8 * n_scan : 1024);
                    for (;;) {
                        mp = up_i64(3, cap_v);
                        mt = up_i64(4, cap_v);
                        ml = up_i64(5, cap_v);
                        mcol = up_i64(6, cap_v);
                        moff = up_i64(7, cap_v + 1);
                        madj = up_i64(8, cap_e);
                        if (!mp || !mt || !ml || !mcol || !moff
                            || !madj) return -3;
                        nv = meg_build(
                            sc_p, sc_t, sc_l, n_scan, elen,
                            mfl, max_intron, min_intron,
                            pref_rate, suff_rate,
                            max_pairings, max_freq_shortest,
                            trans_red, short_edge_comp,
                            mp, mt, ml, mcol, moff, madj,
                            flags, cap_v, cap_e);
                        if (nv == -2) {
                            cap_v = cap_v > flags[3] + 1
                                ? cap_v : flags[3] + 1;
                            cap_e = cap_e > flags[4] + 1
                                ? cap_e : flags[4] + 1;
                            continue;
                        }
                        if (nv < 0) return -3;
                        break;
                    }
                }
                wr_stats[1] += fe_now() - wt0;
                if (flags[0] && base_mfl + inc + 1 + 2 < elen + 2) {
                    inc++;
                    continue;
                }
                break;
            }
            tot_p = nv;
            tot_e = nv ? moff[nv] : 0;
            if (!(prev_p > 2 && prev_e > 0
                  && (prev_p <= tot_p || prev_e <= tot_e)))
                break;
            inc++;
        }
        prev_p = tot_p;
        prev_e = tot_e;
        {
            double meg_time = fe_now() - t_meg0;
            double t_fact0 = fe_now();
            double deadline = max_fact_time > 0.0
                ? fe_now() + max_fact_time : 0.0;
            int64_t nf;
            int timeout_f = 0, fe_none = 0;
            int64_t counts[4] = {0, 0, 0, 0};
            int64_t cap_facts = up_cap(9, 257) - 1;
            int64_t cap_factors = up_cap(10, 8192) / 4;
            int64_t *eoff, *ef, *epa, *epd;
            for (;;) {
                eoff = up_i64(9, cap_facts + 1);
                ef = up_i64(10, 4 * cap_factors);
                epa = up_i64(11, cap_facts);
                epd = up_i64(12, cap_facts);
                if (!eoff || !ef || !epa || !epd) return -3;
                nf = est_process(
                    mp, mt, ml, mcol, moff, madj, nv, elen + 2,
                    C->gen, C->glen, (const char *)seq, elen, orig, olen,
                    base_mfl, min_intron, deadline,
                    complexity_thr, max_site_diff,
                    max_cov_diff, max_gap_diff, max_nf,
                    sp_est, sp_intron, sp_gen,
                    eoff, ef, epa, epd,
                    cap_facts, cap_factors, counts);
                if (nf == -2) {
                    cap_facts = cap_facts > counts[1] + 1
                        ? cap_facts : counts[1] + 1;
                    cap_factors = cap_factors > counts[2] + 1
                        ? cap_factors : counts[2] + 1;
                    continue;
                }
                break;
            }
            if (nf == -1) { timeout_f = 1; fe_none = 1; nf = 0; }
            else if (nf < 0) return -3;   /* host fallback */
            else timeout_f = (deadline != 0.0 && fe_now() > deadline);
            {
                double fact_time = fe_now() - t_fact0;
                int has_facts = nf > 0;
                double wfmt0;
                wr_stats[2] += fact_time;
                wfmt0 = fe_now();

                if (!timeout_f || has_facts) {
                    /* megs.txt section */
                    int64_t n_adj = nv ? moff[nv] : 0;
                    int64_t need = nv * 72 + 8 + n_adj * 46 + 16;
                    int64_t m;
                    if (!sb_put(&S[1], "\n\n***********\n\n>", 16)
                        || !sb_put(&S[1], eid, idlen)
                        || !sb_put(&S[1], "\n", 1)
                        || !sb_put(&S[1], orig, olen)
                        || !sb_put(&S[1], "\n", 1)) return -3;
                    if (!sb_reserve(&S[1], need)) return -3;
                    m = meg_format(mp, mt, ml, mcol, moff, madj,
                                   nv, elen + 2, 0,
                                   S[1].d + S[1].n, need);
                    if (m < 0) return -3;
                    S[1].n += m;
                }
                if (has_facts) {
                    int64_t n_adj = nv ? moff[nv] : 0;
                    int64_t need = n_adj * 224 + 16;
                    int64_t m;
                    /* meg-edges.txt */
                    if (!sb_put(&S[5], ">", 1)
                        || !sb_put(&S[5], eid, idlen)
                        || !sb_put(&S[5], "\n", 1)) return -3;
                    if (!sb_reserve(&S[5], need)) return -3;
                    m = meg_format(mp, mt, ml, mcol, moff, madj,
                                   nv, elen + 2, 1,
                                   S[5].d + S[5].n, need);
                    if (m < 0) return -3;
                    S[5].n += m;
                    /* processed-megs.txt */
                    if (!sb_put(&S[2], ">", 1)
                        || !sb_put(&S[2], eid, idlen)
                        || !sb_put(&S[2], "\n", 1)
                        || !sb_put(&S[2], orig, olen)
                        || !sb_put(&S[2], "\n", 1)) return -3;
                    need = nv * 72 + 8 + n_adj * 46 + 16;
                    if (!sb_reserve(&S[2], need)) return -3;
                    m = meg_format(mp, mt, ml, mcol, moff, madj,
                                   nv, elen + 2, 0,
                                   S[2].d + S[2].n, need);
                    if (m < 0) return -3;
                    S[2].n += m;
                    /* processed-megs-info.txt */
                    if (!sb_puti(&S[3], (int64_t)(meg_time * 1e6))
                        || !sb_put(&S[3], " ", 1)
                        || !sb_puti(&S[3], (int64_t)(fact_time * 1e6))
                        || !sb_put(&S[3], " ", 1)
                        || !sb_puti(&S[3], nf)
                        || !sb_put(&S[3], "\n", 1)) return -3;
                    /* raw-multifasta-out.txt (io-multifasta.c:187-243) */
                    {
                        int64_t n_flags = counts[0];
                        int64_t i;
                        for (i = 0; i < nf && i < n_flags; i++) {
                            int64_t size = eoff[i + 1] - eoff[i];
                            int64_t pa, pd, l_index, r_index, c;
                            if (!(retain_ext || size > 2
                                  || (size == 2 && suffpa != -1)))
                                continue;
                            pa = retain_ext ? epa[i] : 0;
                            pd = retain_ext ? epd[i] : 0;
                            if (!sb_put(&S[0], ">", 1)
                                || !sb_put(&S[0], eid, idlen)
                                || !sb_put(&S[0], "\n#polya=", 8)
                                || !sb_puti(&S[0], pa)
                                || !sb_put(&S[0], "\n#polyad=", 9)
                                || !sb_puti(&S[0], pd)
                                || !sb_put(&S[0], "\n", 1)) return -3;
                            l_index = retain_ext ? 0 : 1;
                            r_index = retain_ext ? size + 1
                                : (suffpa == -1 ? size : size + 1);
                            for (c = 1; c <= size; c++) {
                                int64_t fi = eoff[i] + c - 1;
                                int64_t es = ef[4 * fi],
                                    ee = ef[4 * fi + 1],
                                    gs = ef[4 * fi + 2],
                                    ge = ef[4 * fi + 3];
                                const char *es_a, *gs_a;
                                int64_t es_b, gs_b;
                                if (!(c > l_index && c < r_index))
                                    continue;
                                /* python-slice semantics */
                                es_b = py_slice(orig, olen, es, ee + 1,
                                                &es_a);
                                gs_b = py_slice(C->gen_orig, C->golen,
                                                C->gen_pref_n + gs,
                                                C->gen_pref_n + ge + 1,
                                                &gs_a);
                                if (!sb_puti(&S[0], es + 1)
                                    || !sb_put(&S[0], " ", 1)
                                    || !sb_puti(&S[0], ee + 1)
                                    || !sb_put(&S[0], " ", 1)
                                    || !sb_puti(&S[0],
                                                C->gen_pref_n + gs + 1)
                                    || !sb_put(&S[0], " ", 1)
                                    || !sb_puti(&S[0],
                                                C->gen_pref_n + ge + 1)
                                    || !sb_put(&S[0], " ", 1)
                                    || !sb_put(&S[0], es_a, es_b)
                                    || !sb_put(&S[0], " ", 1)
                                    || !sb_put(&S[0], gs_a, gs_b)
                                    || !sb_put(&S[0], "\n", 1))
                                    return -3;
                            }
                        }
                    }
                    /* processed-ests.txt */
                    if (!sb_put(&S[4], ">", 1)
                        || !sb_put(&S[4], eid, idlen)
                        || !sb_put(&S[4], "\n", 1)
                        || !sb_put(&S[4], orig, olen)
                        || !sb_put(&S[4], "\n", 1)) return -3;
                    wr_stats[3] += fe_now() - wfmt0;
                    return 1;   /* EST done (facts) */
                }
                if (fe_none || timeout_f) {
                    wr_stats[3] += fe_now() - wfmt0;
                    if (!timeout_f) return 0;
                    inc++;
                    continue;   /* retry with longer seeds */
                }
                wr_stats[3] += fe_now() - wfmt0;
                return 0;   /* no facts, no timeout: EST done */
            }
        }
    }
}

int64_t unit_process(
    const unsigned char *text, int64_t tlen,
    const int64_t *st_start, const int64_t *st_end,
    const int64_t *st_parent, const int64_t *st_slink,
    const int64_t *st_depth, const unsigned char *st_single,
    const int64_t *st_lo, const int64_t *st_hi, const int64_t *st_occ,
    const int64_t *st_coff, const unsigned char *st_cchar,
    const int64_t *st_cnode,
    const int64_t *a256, int64_t alph_size,
    const char *gen, int64_t glen,
    const char *gen_orig, int64_t golen,
    int64_t gen_pref_n,
    const int64_t *icfg, const double *dcfg,
    const char *blob, const int64_t *emeta, int64_t n_ests,
    char *out, int64_t cap, int64_t *out_meta) {

    up_ctx C = { text, tlen, st_start, st_end, st_parent, st_slink,
                 st_depth, st_single, st_lo, st_hi, st_occ, st_coff,
                 st_cchar, st_cnode, a256, alph_size, gen, glen,
                 gen_orig, golen, gen_pref_n, icfg, dcfg };
    sbuf S[6];
    memset(S, 0, sizeof(S));
    int64_t ret = -3;
    int64_t k = 0;
    int is_reverse = 0;

    while (k < n_ests) {
        int64_t rc = up_est_run(
            &C, blob + emeta[8 * k], emeta[8 * k + 1],
            (const unsigned char *)(blob + emeta[8 * k + 2]),
            emeta[8 * k + 3],
            blob + emeta[8 * k + 4], emeta[8 * k + 5],
            emeta[8 * k + 7], S);
        if (rc < 0) goto fail;
        if (rc > 0) {
            if (!emeta[8 * k + 6] && !is_reverse) k += 1;
            is_reverse = 0;
        } else {
            if (is_reverse || emeta[8 * k + 6]) is_reverse = 0;
            else is_reverse = 1;
        }
        k += 1;
    }

    {
        int64_t total = 0, i, w = 0;
        for (i = 0; i < 6; i++) total += S[i].n;
        out_meta[6] = total;
        if (total > cap) { ret = -2; goto fail; }
        for (i = 0; i < 6; i++) {
            out_meta[i] = S[i].n;
            if (S[i].n) memcpy(out + w, S[i].d, (size_t)S[i].n);
            w += S[i].n;
        }
        ret = 0;
    }
fail:
    {
        int64_t i;
        for (i = 0; i < 6; i++) free(S[i].d);
    }
    return ret;
}

/* ======================================================================
 * Native EST preprocessing + whole-run worker driver.
 *
 * worker_run reads ests.txt itself, parses the multi-FASTA records
 * (io-multifasta.c:133-167 my_getline semantics), preprocesses only the
 * records owned by this worker (GB-id io-multifasta.c:279-304, strand
 * interpretation + reverse-complement io-multifasta.c:425-523, polyA/T
 * masking io-multifasta.c:663-828), and runs every owned unit through
 * up_est_run — the complete est-fact stage for one worker in a single
 * native call.  Mirrors stages/est_fact.py:_worker_units_from_file and
 * io/multifasta.py bit-for-bit (validated by the 3-way fuzz tests).
 * ====================================================================== */

static void up_comp_init(char *tbl) {
    static const char *pairs[6] = {"AT", "CG", "RY", "MK", "BV", "DH"};
    int i;
    for (i = 0; i < 256; i++) tbl[i] = (char)i;
    for (i = 0; i < 6; i++) {
        unsigned char a = (unsigned char)pairs[i][0];
        unsigned char b = (unsigned char)pairs[i][1];
        tbl[a] = (char)b; tbl[b] = (char)a;
        tbl[a + 32] = (char)(b + 32); tbl[b + 32] = (char)(a + 32);
    }
}

/* reverse-complement s into dst (both buffers length n) */
static void up_revcomp(const char *s, int64_t n, char *dst,
                       const char *tbl) {
    int64_t i;
    for (i = 0; i < n; i++)
        dst[i] = tbl[(unsigned char)s[n - 1 - i]];
}

#define UP_POLYA_MIN_LEN 14
#define UP_POLYA_FRACTION 0.72

/* one direction of the polyA/T scan (io/multifasta.py:_polyat_scan);
 * step = +1 from the start or -1 from the end, base = first index */
static int up_polyat_scan(const char *seq, int64_t est_len,
                          int64_t base, int64_t step, int64_t *mlen) {
    int64_t count_A = 0, count_T = 0;
    int64_t last_A = 0, last_T = 0;
    int64_t last_A_count = 0, last_T_count = 0;
    int64_t i = 0;
    double thr = UP_POLYA_FRACTION * UP_POLYA_MIN_LEN;
    int64_t running_A, running_T;
    while (i < UP_POLYA_MIN_LEN && i < est_len) {
        char c = seq[base + step * i];
        if (c == 'A') { count_A++; last_A = i; last_A_count = count_A; }
        if (c == 'T') { count_T++; last_T = i; last_T_count = count_T; }
        i++;
    }
    running_A = count_A; running_T = count_T;
    while (i < est_len && ((double)running_A >= thr
                           || (double)running_T >= thr)) {
        char drop = seq[base + step * (i - UP_POLYA_MIN_LEN)];
        char c;
        if (drop == 'A') running_A--;
        if (drop == 'T') running_T--;
        c = seq[base + step * i];
        if (c == 'A') {
            count_A++; running_A++; last_A = i; last_A_count = count_A;
        }
        if (c == 'T') {
            count_T++; running_T++; last_T = i; last_T_count = count_T;
        }
        i++;
    }
    if (last_A < UP_POLYA_MIN_LEN - 1) last_A = UP_POLYA_MIN_LEN - 1;
    if (last_T < UP_POLYA_MIN_LEN - 1) last_T = UP_POLYA_MIN_LEN - 1;
    if ((double)last_A_count >= UP_POLYA_FRACTION * (double)(last_A + 1)
        || (double)last_T_count
           >= UP_POLYA_FRACTION * (double)(last_T + 1)) {
        if ((double)last_A_count / (double)(last_A + 1)
            >= (double)last_T_count / (double)(last_T + 1)) {
            *mlen = last_A + 1;
            return 'A';
        }
        *mlen = last_T + 1;
        return 'T';
    }
    *mlen = 0;
    return 0;
}

/* polyA/T masking in place; fills lens[4] =
 * {pref_polyA, suff_polyA, pref_polyT, suff_polyT} (-1 = none).
 * Returns 0, or -1 when est_len == 0 (python asserts: host fallback). */
static int up_polyat_substitution(char *seq, int64_t est_len,
                                  int64_t *lens) {
    int64_t mlen, i;
    int c;
    lens[0] = lens[1] = lens[2] = lens[3] = -1;
    if (est_len <= 0) return est_len < 0 ? -1 : -1;
    if (est_len < UP_POLYA_MIN_LEN) return 0;
    c = up_polyat_scan(seq, est_len, 0, 1, &mlen);
    if (c) {
        char sc = c == 'A' ? '*' : '#';
        for (i = 0; i < mlen; i++) seq[i] = sc;
        if (c == 'A') lens[0] = mlen; else lens[2] = mlen;
    }
    c = up_polyat_scan(seq, est_len, est_len - 1, -1, &mlen);
    if (c) {
        char sc = c == 'A' ? '*' : '#';
        for (i = 0; i < mlen; i++) seq[est_len - 1 - i] = sc;
        if (c == 'A') lens[1] = mlen; else lens[3] = mlen;
    }
    return 0;
}

/* find needle in (hay, n); returns offset or -1 */
static int64_t up_find(const char *hay, int64_t n, const char *needle) {
    int64_t m = (int64_t)strlen(needle);
    int64_t i;
    for (i = 0; i + m <= n; i++)
        if (memcmp(hay + i, needle, (size_t)m) == 0) return i;
    return -1;
}

/* strand interpretation (io/multifasta.py:set_est_strand_and_rc minus
 * the RC itself): returns strand (+1/-1), sets *fixed */
static int up_strand(const char *id, int64_t idlen, int *fixed) {
    int64_t pos;
    int strand = 1;
    *fixed = 0;
    /* GB id (io-multifasta.c:279-304) for the NM_/NR_ rule */
    pos = up_find(id, idlen, "/gb=");
    if (pos < 0) pos = up_find(id, idlen, "/GB=");
    if (pos >= 0) {
        const char *gb = id + pos + 4;
        int64_t gblen = 0;
        while (pos + 4 + gblen < idlen && gb[gblen] != ' '
               && gb[gblen] != '/')
            gblen++;
        if (gblen >= 3 && gb[0] == 'N' && gb[2] == '_'
            && (gb[1] == 'M' || gb[1] == 'R')) {
            *fixed = 1;
            return 1;
        }
    }
    pos = up_find(id, idlen, "/clone_end=");
    if (pos < 0) pos = up_find(id, idlen, "/CLONE_END=");
    if (pos >= 0) {
        const char *rest = id + pos + 11;
        int64_t rlen = idlen - (pos + 11);
        char sar[11];
        int64_t sn = 0;
        int valid = 0;
        while (sn < 10 && sn < rlen) {
            if (rest[sn] == '\0' || rest[sn] == '\'') break;
            sar[sn] = rest[sn];
            sn++;
        }
        if (sn == 1 && sar[0] == '3') { strand = 1; valid = 1; }
        else if (sn == 1 && sar[0] == '5') { strand = -1; valid = 1; }
        else strand = 1;
        if (valid) {
            int64_t fpos = up_find(id, idlen, "/fixed_strand=");
            if (fpos < 0) fpos = up_find(id, idlen, "/FIXED_STRAND=");
            if (fpos >= 0 && fpos + 14 < idlen)
                *fixed = id[fpos + 14] == '1';
        }
    }
    return strand;
}

int64_t worker_run(
    const unsigned char *text, int64_t tlen,
    const int64_t *st_start, const int64_t *st_end,
    const int64_t *st_parent, const int64_t *st_slink,
    const int64_t *st_depth, const unsigned char *st_single,
    const int64_t *st_lo, const int64_t *st_hi, const int64_t *st_occ,
    const int64_t *st_coff, const unsigned char *st_cchar,
    const int64_t *st_cnode,
    const int64_t *a256, int64_t alph_size,
    const char *gen, int64_t glen,
    const char *gen_orig, int64_t golen,
    int64_t gen_pref_n,
    const int64_t *icfg, const double *dcfg,
    const char *ests_path, int64_t *claim, int64_t w, int64_t n,
    char **out_data, int64_t **out_meta) {

    up_ctx C = { text, tlen, st_start, st_end, st_parent, st_slink,
                 st_depth, st_single, st_lo, st_hi, st_occ, st_coff,
                 st_cchar, st_cnode, a256, alph_size, gen, glen,
                 gen_orig, golen, gen_pref_n, icfg, dcfg };
    static char comp_tbl[256];
    static int comp_init = 0;
    char *buf = NULL;
    int64_t flen = 0;
    sbuf S[6], DATA;
    int64_t ret = -3;
    int64_t rec = 0;         /* global record index */
    int64_t n_units = 0;     /* owned units emitted */
    int64_t *um = NULL;      /* 7 int64s per owned unit */
    int64_t um_cap = 0;
    /* current record state */
    char *id = NULL; int64_t idlen = 0;
    char *seqbuf = NULL; int64_t seqlen = 0, seqcap = 0;
    int in_record = 0;

    memset(S, 0, sizeof(S));
    memset(&DATA, 0, sizeof(DATA));

    if (!comp_init) { up_comp_init(comp_tbl); comp_init = 1; }

    {
        FILE *f = fopen(ests_path, "rb");
        long sz;
        if (!f) return -3;
        if (fseek(f, 0, SEEK_END) != 0 || (sz = ftell(f)) < 0
            || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -3; }
        buf = (char *)malloc((size_t)sz + 1);
        if (!buf) { fclose(f); return -3; }
        flen = (int64_t)fread(buf, 1, (size_t)sz, f);
        fclose(f);
    }

    /* parse + process.  Records flush on '>' headers, the literal
     * "#\\#" separator, and EOF.  Owned records run the full
     * preprocessing + up_est_run; others are skipped cheaply.
     * Ownership: static stride (rec % n == w) when claim is NULL, else
     * dynamic via atomic fetch-add on the shared counter — each record
     * is claimed by exactly one worker, so the reassembly-by-record
     * output is byte-identical either way while the load balances
     * itself. */
    {
        int64_t p = 0;
        int flush_err = 0;
        int64_t next_claim = claim
            ? __atomic_fetch_add(claim, 1, __ATOMIC_RELAXED) : -1;
        while (p <= flen && !flush_err) {
            /* next line [p, q) with universal-newline semantics */
            int64_t q = p, lend;
            if (p == flen) {
                if (!in_record && seqlen == 0 && id == NULL) break;
            }
            while (q < flen && buf[q] != '\n' && buf[q] != '\r') q++;
            lend = q;
            /* strip trailing chars < ' ' (my_getline) */
            while (lend > p && (unsigned char)buf[lend - 1] < 32) lend--;
            {
                char *line = buf + p;
                int64_t llen = lend - p;
                int is_hdr = llen > 0 && line[0] == '>';
                int is_sep = llen == 3 && line[0] == '#'
                    && line[1] == '\\' && line[2] == '#';
                if (is_hdr || is_sep || q >= flen) {
                    /* flush current record */
                    if (in_record) {
                        if (!is_hdr && !is_sep && q >= flen && llen > 0
                            && line[0] != '>') {
                            /* last line belongs to the record */
                            if (seqlen + llen > seqcap) {
                                int64_t nc = seqcap ? seqcap : 1024;
                                char *nb;
                                while (seqlen + llen > nc) nc *= 2;
                                nb = (char *)realloc(seqbuf, (size_t)nc);
                                if (!nb) { flush_err = 1; goto advance; }
                                seqbuf = nb; seqcap = nc;
                            }
                            memcpy(seqbuf + seqlen, line, (size_t)llen);
                            seqlen += llen;
                            llen = 0;
                        }
                        if (claim ? (rec == next_claim)
                                  : (rec % n == w)) {
                            /* preprocess + run this unit */
                            int fixed = 0;
                            int strand = up_strand(id, idlen, &fixed);
                            int64_t lens[4];
                            char *sq = NULL, *orig = NULL;
                            int64_t rc_run;
                            int64_t suffpa;
                            int64_t spos[6];
                            int64_t si;
                            if (seqlen == 0) { flush_err = 1; goto advance; }
                            sq = (char *)malloc((size_t)seqlen * 2);
                            if (!sq) { flush_err = 1; goto advance; }
                            orig = sq + seqlen;
                            if (strand == -1) {
                                up_revcomp(seqbuf, seqlen, sq, comp_tbl);
                                memcpy(orig, sq, (size_t)seqlen);
                            } else {
                                memcpy(sq, seqbuf, (size_t)seqlen);
                                memcpy(orig, seqbuf, (size_t)seqlen);
                            }
                            if (up_polyat_substitution(sq, seqlen, lens)
                                < 0) { free(sq); flush_err = 1;
                                       goto advance; }
                            suffpa = lens[1];
                            for (si = 0; si < 6; si++) spos[si] = S[si].n;
                            rc_run = up_est_run(
                                &C, id, idlen, (const unsigned char *)sq,
                                seqlen, orig, seqlen, suffpa, S);
                            if (rc_run >= 0 && rc_run == 0 && !fixed) {
                                /* forward failed: try the RC copy
                                 * (copy_and_reverse semantics: RC of the
                                 * MASKED seq; original == same bytes) */
                                char *rsq = (char *)malloc(
                                    (size_t)seqlen * 2);
                                if (!rsq) { free(sq); flush_err = 1;
                                            goto advance; }
                                up_revcomp(sq, seqlen, rsq, comp_tbl);
                                memcpy(rsq + seqlen, rsq,
                                       (size_t)seqlen);
                                if (up_polyat_substitution(rsq, seqlen,
                                                           lens) < 0) {
                                    free(rsq); free(sq); flush_err = 1;
                                    goto advance;
                                }
                                rc_run = up_est_run(
                                    &C, id, idlen,
                                    (const unsigned char *)rsq, seqlen,
                                    rsq + seqlen, seqlen, lens[1], S);
                                free(rsq);
                            }
                            free(sq);
                            if (7 * (n_units + 1) > um_cap) {
                                int64_t nc = um_cap ? 2 * um_cap : 448;
                                int64_t *nm = (int64_t *)realloc(
                                    um, (size_t)nc * 8);
                                if (!nm) { flush_err = 1; goto advance; }
                                um = nm; um_cap = nc;
                            }
                            if (rc_run < 0) {
                                /* per-unit host fallback: roll back any
                                 * partial stream writes, emit -1 lens */
                                for (si = 0; si < 6; si++)
                                    S[si].n = spos[si];
                                um[7 * n_units] = rec;
                                for (si = 0; si < 6; si++)
                                    um[7 * n_units + 1 + si] = -1;
                                n_units++;
                            } else {
                                um[7 * n_units] = rec;
                                for (si = 0; si < 6; si++)
                                    um[7 * n_units + 1 + si]
                                        = S[si].n - spos[si];
                                /* append this unit's streams to DATA */
                                for (si = 0; si < 6; si++) {
                                    if (!sb_put(&DATA, S[si].d + spos[si],
                                                S[si].n - spos[si])) {
                                        flush_err = 1;
                                        break;
                                    }
                                }
                                /* reset S so buffers stay small */
                                for (si = 0; si < 6; si++) S[si].n = 0;
                                n_units++;
                            }
                            if (claim)
                                next_claim = __atomic_fetch_add(
                                    claim, 1, __ATOMIC_RELAXED);
                        }
                        rec++;
                        in_record = 0;
                        seqlen = 0;
                    }
                    if (is_hdr) {
                        id = line + 1;
                        idlen = llen - 1;
                        in_record = 1;
                        seqlen = 0;
                    }
                } else if (in_record && llen > 0) {
                    if (seqlen + llen > seqcap) {
                        int64_t nc = seqcap ? seqcap : 1024;
                        char *nb;
                        while (seqlen + llen > nc) nc *= 2;
                        nb = (char *)realloc(seqbuf, (size_t)nc);
                        if (!nb) { flush_err = 1; goto advance; }
                        seqbuf = nb; seqcap = nc;
                    }
                    memcpy(seqbuf + seqlen, line, (size_t)llen);
                    seqlen += llen;
                }
            }
advance:
            if (q >= flen) break;
            /* skip the newline ('\r\n' counts as one terminator) */
            if (buf[q] == '\r' && q + 1 < flen && buf[q + 1] == '\n')
                p = q + 2;
            else
                p = q + 1;
        }
        if (flush_err) goto done;
        /* a header at EOF leaves an empty pending record: python would
         * flush it and crash on the empty sequence — fall back so the
         * host path reproduces that behavior */
        if (in_record) goto done;
    }

    *out_data = DATA.d;      /* ownership transfers to the caller */
    *out_meta = um;
    DATA.d = NULL;
    um = NULL;
    ret = n_units;
done:
    free(buf);
    free(seqbuf);
    free(DATA.d);
    free(um);
    {
        int64_t i;
        for (i = 0; i < 6; i++) free(S[i].d);
    }
    return ret;
}

/* free a buffer returned by worker_run */
void up_buf_free(void *p) { free(p); }
