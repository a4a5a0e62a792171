// Hand-written Hopper (sm_90a) kernel for the intron-refinement (gap
// alignment) family of the est-fact (STEP 2) device offload.
//
// gap_kernel replaces the XLA op
//   ops/align.py::batch_gap_traceback (pintron_tpu/ops/align.py:354)
// of the JAX package: the 3-matrix L/G/R gap alignment (match +1,
// mismatch -1 with N/n wildcards, gap -1 in L and R, a free genomic
// gap in G, free horizontal moves on R's last row), the fill
// (:394-447), the start-matrix choice (:465-474) and the matrix-state
// traceback walk (:481-500) all on the card.  Same int32 values,
// direction tie chains (L: diag > up > left; G: keep > take L; R: diag
// > left > G-jump > up) and op codes; the plain PyTorch version in
// pintron_tpu_torch/ops/align.py is its reference.
//
// What bounds it on this card: neither the bytes (a launch reads a few
// hundred KB of windows) nor the card's ALUs, but one warp's chain of
// dependent steps and its instruction issue.  STEP 2's gap launches are
// all in the (64, 256) bucket: 119 to 1334 refine-intron windows of at
// most 60 x 200 cells (python -m pintron_tpu_torch.measure_gap), so
// each problem's warp has its scheduler to itself or shares it with two
// or three others, and a launch takes about one warp's elen / R + glen
// steps plus its serial walk.  A warp alone is latency-bound (three on
// a scheduler take only about 1.4x as long); the integer instructions
// issue at half rate (16 INT32 lanes a sub-partition), and the
// direction bits' compares and selects are about a third of the fill
// (measure_gap, PERF.md).
//
// The design: one warp per problem (blocks of kWarps warps, nothing
// shared between them), everything of the fill in registers.
//   * Fill.  Lane l holds a strip of R consecutive est rows and the warp
//     sweeps the gen columns as a skewed wavefront: at step s lane l
//     computes column j = s - l + 1 of its rows, top to bottom.  The
//     strip's upper neighbours (the last row's L and R of lane l-1's
//     strip at column j) and the gen character of column j come from
//     lane l-1 by __shfl_up_sync, as lane l-1 computed that column one
//     step earlier; the diagonal ones are those it took the step
//     before.  Along a row the left chains stay in the lane's
//     registers: L's left candidate is L[i][j-1] - 1, G is the running
//     maximum G[i][j] = max(G[i][j-1], L[i][j-1]), and R's left
//     candidate is R[i][j-1] - cost (cost 0 on the problem's last row).
//     No block scan and no barrier.  The lane keeps every value offset
//     by its cell's i + j (G by i + j + 1), which takes the -1 of the up
//     and left moves and the cost of R's left move out of the cell: L
//     = max(diag + ms + 2, up, left), G = max(G, L + 1) + 1 and R =
//     max(diag + ms + 2, up, G, left + [last row]), the same maxima and
//     ties.  The strip's est codes and masks are pinned in registers,
//     the gen character and the diagonal steps are taken a step ahead,
//     off the step's dependent chain, and at R = 2 (one pass, its top
//     row known) a warp-width of steps is unrolled.
//   * R follows the est bucket (the wrapper passes it): R = 2 for ests
//     of at most 64 rows, so that all 32 lanes hold rows of a 60-row
//     window, and R = 16 for long ests, in passes of 32 x R = 512 rows:
//     lane 31 keeps the pass's last L and R rows in a (B, 2, max_m + 1)
//     int32 row buffer, which lane 0 of the next pass reads a
//     warp-width ahead.
//   * Only the problem's own elen rows and glen columns are computed, and
//     a pass drains over only the lanes that hold rows.
//   * Directions are 5 bits a cell (L's 2, R's 2, G's 1): at R = 2 one
//     16-bit word a lane's strip and column; at R = 16 a 64-bit word of
//     L's and R's bits and a 16-bit word of G's.  The word of lane l at
//     column j sits at slot (j - 1 + l) mod max_m of its pass, lanes
//     innermost, so the lanes of a step store one contiguous run
//     (coalesced; at R = 2 a store covers only 2 cells).  A problem's
//     scratch is at most max_n x max_m bytes at the offload's buckets.
//   * Walk.  From (elen, glen) the warp loads a tile of 32 / R + 1 strips
//     x 32 columns ending at the current cell into shared memory, every
//     load issued before the first is used; the path stays inside it
//     for at least 32 steps (it leaves only after 32 moves left or 33
//     moves up), each step a shared-memory read, not an L2 round trip,
//     and the matrix picks the cell's field by a shift and an xor, with
//     no branch.  Lane s mod 32 keeps step s's op code and the warp
//     stores them a warp-width at a time; it pads the rest with 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // problems a block, one warp each
constexpr unsigned kFull = 0xffffffffu;

// The direction words of R rows: with R = 2 one 16-bit word holds a
// row's 5 bits at 5r (L's 2, R's 2, G's 1); with R = 16 a 64-bit word
// holds L's and R's 4 bits a row at 4r and a 16-bit word G's bit at r.
template <int R> struct Dirs;
template <> struct Dirs<2> {
  static constexpr bool kJoint = true;
  using LRW = uint16_t;
  using GW = uint16_t;  // unused: the G bits sit in LRW
};
template <> struct Dirs<16> {
  static constexpr bool kJoint = false;
  using LRW = unsigned long long;
  using GW = uint16_t;
};

__device__ __forceinline__ bool wildcard(int c) {
  return c == 'N' || c == 'n';
}

// 3 on a match or a wildcard, 1 on a mismatch: the diagonal's +1 / -1
// plus the offset's 2
__device__ __forceinline__ int diag_step(int gc, int ec, unsigned em,
                                         unsigned gm) {
  return 3 - 2 * static_cast<int>(
                     min(static_cast<unsigned>(gc ^ ec) & em, gm));
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
    gap_kernel(const int8_t* __restrict__ est, int n_cols,
               const int8_t* __restrict__ gen, int m_cols,
               const int32_t* __restrict__ elen,
               const int32_t* __restrict__ glen,
               typename Dirs<R>::LRW* lrdirs, typename Dirs<R>::GW* gdirs,
               int32_t* rowbuf, int32_t* __restrict__ sm_out,
               int8_t* __restrict__ ops, int32_t* __restrict__ nsteps,
               int batch) {
  using LRW = typename Dirs<R>::LRW;
  using GW = typename Dirs<R>::GW;
  constexpr bool kJoint = Dirs<R>::kJoint;
  constexpr bool kOnePass = R == 2;    // the wrapper's R = 2: n_cols <= 64
  constexpr int kPass = 32 * R;
  constexpr int kStrips = 32 / R + 1;  // the walk's tile: strips x 32
  __shared__ LRW tlr[kWarps][kStrips][32];
  __shared__ GW tg[kWarps][kJoint ? 1 : kStrips][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= batch) return;  // b is the same on every lane of the warp
  const int n = min(max(elen[b], 0), n_cols);
  const int m = min(max(glen[b], 0), m_cols);
  const int8_t* e = est + static_cast<size_t>(b) * n_cols;
  const int8_t* g = gen + static_cast<size_t>(b) * m_cols;
  // lanes a pass: 32, or fewer when the bucket holds fewer strips
  const int lpp = min(32, (n_cols + R - 1) / R);
  const size_t plane = static_cast<size_t>((n_cols + kPass - 1) / kPass) *
                       m_cols * lpp;
  LRW* DLR = lrdirs + static_cast<size_t>(b) * plane;
  GW* DG = kJoint ? nullptr : gdirs + static_cast<size_t>(b) * plane;
  int32_t* topL = rowbuf + static_cast<size_t>(b) * 2 * (m_cols + 1);
  int32_t* topR = topL + m_cols + 1;

  // L, G and R of the lane's rows at its last column, offset (see the
  // header): L + i + j, G + i + j + 1 and R + i + j
  int Lc[R], Gc[R], Rc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) Lc[r] = Gc[r] = Rc[r] = 0;
  for (int p0 = 0; m > 0 && p0 < n; p0 += kPass) {
    const int i0 = p0 + lane * R;  // the row above the lane's strip
    const int lact = min(32, (n - p0 + R - 1) / R);  // lanes with rows
    const bool keep = !kOnePass && p0 + kPass < n;  // keep the last row
    const bool first = kOnePass || p0 == 0;
    LRW* plr = DLR + static_cast<size_t>(p0 / kPass) * m_cols * lpp + lane;
    GW* pg = kJoint ? nullptr
                    : DG + static_cast<size_t>(p0 / kPass) * m_cols * lpp +
                          lane;
    // the strip's est codes, a mask that is 0 on a wildcard row, and 1
    // on the problem's last row (R's free left move); the empty asm
    // keeps them in registers
    int ec[R], lst[R];
    unsigned em[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r + 1;
      ec[r] = i <= n ? e[i - 1] : 0;
      em[r] = wildcard(ec[r]) ? 0u : ~0u;
      lst[r] = i == n ? 1 : 0;
      asm volatile("" : "+r"(ec[r]), "+r"(em[r]), "+r"(lst[r]));
      Lc[r] = Rc[r] = i;  // column 0
      Gc[r] = i + 1;
    }
    int dL = i0, dR = i0;  // L and R of the row above at column j-1
    int botL = 0, botR = 0;
    // lane 0's inputs a warp-width ahead: gen[j-1], L[p0][j] and
    // R[p0][j] for j = s + 1 at step s; lane k holds step base + k's
    int cur_g, cur_l, cur_r, nxt_g, nxt_l, nxt_r;
    auto fetch = [&](int base, int& gv, int& lv, int& rv) {
      const int j = base + lane + 1;
      const bool in = j <= m;
      gv = in ? g[j - 1] : 0;
      if (!kOnePass) {
        lv = in ? (first ? j : topL[j]) : 0;
        rv = in ? (first ? j : topR[j]) : 0;
      }
    };
    fetch(0, cur_g, cur_l, cur_r);
    fetch(32, nxt_g, nxt_l, nxt_r);
    // the gen character of the lane's column and the diagonal steps of
    // its rows are taken a step ahead, off the step's dependent chain
    int gch = __shfl_sync(kFull, cur_g, 0);
    int dg[R];
    {
      const unsigned gm = wildcard(gch) ? 0u : 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) dg[r] = diag_step(gch, ec[r], em[r], gm);
    }
    const int steps = m + lact - 1;
    int slot = 0;  // s mod m_cols: the step's run of direction words
    for (int s0 = 0; s0 < steps; s0 += 32) {
      if (s0 > 0) {
        cur_g = nxt_g;
        cur_l = nxt_l;
        cur_r = nxt_r;
        fetch(s0 + 32, nxt_g, nxt_l, nxt_r);
      }
      // the short strips of the (64, 256) bucket unroll a warp-width of
      // steps, so that lane 0's inputs come from fixed lanes
#pragma unroll(R == 2 ? 32 : 1)
      for (int k = 0; k < 32; ++k) {
        const int s = s0 + k;
        if (s >= steps) break;
        // the next step's gen character: lane 0's from the window
        const int g0 = k < 31 ? __shfl_sync(kFull, cur_g, k + 1)
                              : __shfl_sync(kFull, nxt_g, 0);
        const int g_in = __shfl_up_sync(kFull, gch, 1);
        int upL = __shfl_up_sync(kFull, botL, 1);  // L[i0][j]
        int upR = __shfl_up_sync(kFull, botR, 1);  // R[i0][j]
        if (kOnePass) {
          if (lane == 0) upL = upR = s + 1;  // row 0: L = R = 0
        } else {
          const int l0 = __shfl_sync(kFull, cur_l, k);
          const int r0 = __shfl_sync(kFull, cur_r, k);
          if (lane == 0) {
            upL = l0;
            upR = r0;
          }
        }
        const int j = s - lane + 1;
        if (lane < lact && j >= 1 && j <= m) {
          int pL = dL, pR = dR;    // L, R[i-1][j-1]
          int uL = upL, uR = upR;  // L, R[i-1][j]
          LRW wlr = 0;
          GW wg = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int lc = Lc[r], gc = Gc[r], rc = Rc[r];
            const int diagL = pL + dg[r];
            const int lv = max(uL, max(diagL, lc));
            const unsigned ld = lv == diagL ? 0u : (lv == uL ? 1u : 2u);
            const int lc1 = lc + 1;  // L[i][j-1] on G's offset
            const unsigned gd = gc < lc1 ? 0u : 1u;
            const int diagR = pR + dg[r], leftR = rc + lst[r];
            const int rv = max(uR, max(max(diagR, gc), leftR));
            const unsigned rd =
                rv == diagR ? 0u : (rv == leftR ? 2u : (rv == gc ? 3u : 1u));
            if (kJoint) {
              wlr |= static_cast<LRW>((ld | (rd << 2) | (gd << 4)) << (5 * r));
            } else {
              wlr |= static_cast<LRW>(ld | (rd << 2)) << (4 * r);
              wg |= static_cast<GW>(gd << r);
            }
            pL = lc;
            pR = rc;
            uL = lv;
            uR = rv;
            Lc[r] = lv;
            Gc[r] = max(gc, lc1) + 1;
            Rc[r] = rv;
          }
          botL = Lc[R - 1];
          botR = Rc[R - 1];
          dL = upL;
          dR = upR;
          const size_t at = static_cast<size_t>(slot) * lpp;
          plr[at] = wlr;
          if (!kJoint) pg[at] = wg;
          if (keep && lane == 31) {
            topL[j] = botL;
            topR[j] = botR;
          }
        }
        gch = lane == 0 ? g0 : g_in;
        const unsigned gm = wildcard(gch) ? 0u : 1u;
#pragma unroll
        for (int r = 0; r < R; ++r) dg[r] = diag_step(gch, ec[r], em[r], gm);
        slot = slot + 1 == m_cols ? 0 : slot + 1;
      }
    }
    __syncwarp();  // the row buffer and the directions, for lane 0 / walk
  }

  // the start matrix from L, G and R at (n, m): R >= G >= L on ties
  int sm = 2;
  if (n > 0 && m > 0) {
    const int last = (n - 1) / kPass * kPass;
    const int rn = (n - 1) % R;
    int lf = 0, gf = 0, rf = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == rn) {
        lf = Lc[r];
        gf = Gc[r] - 1;
        rf = Rc[r];
      }
    const int src = (n - 1 - last) / R;
    lf = __shfl_sync(kFull, lf, src);
    gf = __shfl_sync(kFull, gf, src);
    rf = __shfl_sync(kFull, rf, src);
    sm = rf >= gf ? (rf >= lf ? 2 : 0) : (gf >= lf ? 1 : 0);
  }

  const int T_ops = n_cols + m_cols;
  int8_t* o = ops + static_cast<size_t>(b) * T_ops;
  LRW(*tl)[32] = tlr[w];
  GW(*tgw)[32] = tg[w];
  int i = n, j = m, s = 0, mat = sm;
  int obuf = 0;  // lane s % 32's op code, stored a warp-width at a time
  while (i > 0 && j > 0) {
    const int st = (i - 1) / R;  // the strip of row i
    const int c = j - lane;      // tile column lane: column j - lane
    size_t at[kStrips];
    bool ok[kStrips];
#pragma unroll
    for (int q = 0; q < kStrips; ++q) {
      const int sq = st - q;
      const int ln = sq & 31;  // the strip's lane in its pass
      const int x = c - 1 + ln;
      ok[q] = sq >= 0 && c >= 1;
      at[q] = static_cast<size_t>(sq >> 5) * m_cols * lpp + ln;
      at[q] += static_cast<size_t>(x < m_cols ? x : x - m_cols) * lpp;
    }
    if (m_cols < 32) {  // the slot may wrap more than once
#pragma unroll
      for (int q = 0; q < kStrips; ++q) {
        const int sq = st - q;
        const int ln = sq & 31;
        at[q] = (static_cast<size_t>(sq >> 5) * m_cols +
                 (c - 1 + ln) % m_cols) * lpp + ln;
      }
    }
    LRW vlr[kStrips];
    GW vg[kStrips];
#pragma unroll
    for (int q = 0; q < kStrips; ++q) {
      vlr[q] = ok[q] ? DLR[at[q]] : LRW(0);
      if (!kJoint) vg[q] = ok[q] ? DG[at[q]] : GW(0);
    }
#pragma unroll
    for (int q = 0; q < kStrips; ++q) {
      tl[q][lane] = vlr[q];
      if (!kJoint) tgw[q][lane] = vg[q];
    }
    __syncwarp();
    const int i_lo = max((st - kStrips + 1) * R, 0);
    const int j_lo = max(j - 32, 0);
    const int j0 = j;
    while (i > i_lo && j > j_lo) {
      const int q = st - (i - 1) / R;
      const int rr = (i - 1) % R;
      // the cell's 5 bits: L's 2, R's 2, G's 1; the matrix picks its
      // field (G's bit b gives 3 - b), as a shift and an xor
      const int sh = mat == 1 ? 4 : mat;
      const unsigned mask = mat == 1 ? 1u : 3u;
      unsigned v;
      if (kJoint) {
        v = (static_cast<unsigned>(tl[q][j0 - j]) >> (5 * rr + sh)) & mask;
      } else {
        const unsigned cell =
            (static_cast<unsigned>(tl[q][j0 - j] >> (4 * rr)) & 15u) |
            (((static_cast<unsigned>(tgw[q][j0 - j]) >> rr) & 1u) << 4);
        v = (cell >> sh) & mask;
      }
      // 0 diag, 1 up, 2 left, 3 left with a jump to mat - 1
      const int d = static_cast<int>(v) ^ (mat == 1 ? 3 : 0);
      obuf = lane == (s & 31) ? d : obuf;
      if ((s & 31) == 31) o[s - 31 + lane] = static_cast<int8_t>(obuf);
      ++s;
      i -= d <= 1;
      j -= d != 1;
      mat -= d == 3;
    }
    __syncwarp();
  }
  if (lane < (s & 31)) o[(s & ~31) + lane] = static_cast<int8_t>(obuf);
  if (lane == 0) {
    sm_out[b] = sm;
    nsteps[b] = s;
  }
  for (int p = s + lane; p < T_ops; p += 32) o[p] = 0;
}

template <int R>
int launch(const void* est, int n_cols, const void* gen, int m_cols,
           const void* elen, const void* glen, void* lrdirs, void* gdirs,
           void* rowbuf, void* sm, void* ops, void* nsteps, int batch,
           void* stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  gap_kernel<R><<<blocks, 32 * kWarps, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(est), n_cols,
      static_cast<const int8_t*>(gen), m_cols,
      static_cast<const int32_t*>(elen), static_cast<const int32_t*>(glen),
      static_cast<typename Dirs<R>::LRW*>(lrdirs),
      static_cast<typename Dirs<R>::GW*>(gdirs),
      static_cast<int32_t*>(rowbuf), static_cast<int32_t*>(sm),
      static_cast<int8_t*>(ops), static_cast<int32_t*>(nsteps), batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller: est (B, n_cols) and gen (B, m_cols)
// int8, elen/glen/sm/nsteps (B,) int32; the direction planes, (B,
// passes, m_cols, lanes a pass) words (passes = ceil(n_cols / 32R),
// lanes a pass = min(32, ceil(n_cols / R))): lrdirs of 16 bits at R = 2
// (gdirs unused) or of 64 bits at R = 16 with gdirs of 16 bits; rowbuf
// (B, 2, m_cols + 1) int32, read and written only when n_cols > 32R;
// ops (B, n_cols + m_cols) int8.  rows is R: 2 (n_cols <= 64, one pass)
// or 16.  The launch goes on the caller's stream and is not
// synchronised.  Returns the cudaError of the launch (0 on success).
extern "C" int pintron_gap(const void* est, int n_cols, const void* gen,
                           int m_cols, const void* elen, const void* glen,
                           void* lrdirs, void* gdirs, void* rowbuf, void* sm,
                           void* ops, void* nsteps, int rows, int batch,
                           void* stream) {
  if (batch <= 0) return 0;
  if (n_cols < 1 || m_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 2 && n_cols <= 64)
    return launch<2>(est, n_cols, gen, m_cols, elen, glen, lrdirs, gdirs,
                     rowbuf, sm, ops, nsteps, batch, stream);
  if (rows == 16)
    return launch<16>(est, n_cols, gen, m_cols, elen, glen, lrdirs, gdirs,
                      rowbuf, sm, ops, nsteps, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
