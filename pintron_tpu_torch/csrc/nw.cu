// Hand-written Hopper (sm_90a) kernel for the endpoint-NW family of the
// est-fact (STEP 2) device offload.
//
// nw_kernel replaces the XLA op
//   ops/align.py::batch_nw_traceback (pintron_tpu/ops/align.py:241)
// of the JAX package: Needleman-Wunsch with unit costs, N/n wildcards,
// direction ties diag > up > left, the fill (:274-293) and the
// traceback walk (:318-329) both on the card.  Same int32 scores and op
// codes; the plain PyTorch version in
// pintron_tpu_torch/ops/align.py is its reference.
//
// What bounds it on this card: neither the bytes (a launch reads a few
// hundred KB of windows) nor the card's ALUs (tens of millions of
// cells), but one warp's instruction issue.  STEP 2's launches hold 1 to
// 331 problems of at most 1442 x 1445 cells (the offload's per-problem
// cap), so a problem's warp runs alone on its SM sub-partition, and a
// launch takes its longest problem's elen x glen / 32 cells a lane
// times a cell's issue cycles.  Integer and logic instructions (IMNMX,
// ISETP, LOP3, SEL) issue at half rate there (16 INT32 lanes a
// sub-partition): a step of 16 cells costs about 575 cycles on an H100
// (python -m pintron_tpu_torch.measure_nw), against a dependent chain of
// one shuffle and 16 minima.  A float32 fill (exact on these integers,
// its adds on the FMA pipes) and direction bits from adds and a shift
// both measured no faster.
//
// The design: one warp per problem (blocks of kWarps warps, nothing
// shared between them), everything of the fill in registers.
//   * Fill.  Lane l holds a strip of R = 16 consecutive est rows and
//     the warp sweeps the gen columns as a skewed wavefront: at step s
//     lane l computes column j = s - l + 1 of its rows, top to bottom.
//     Its strip's upper neighbour (the last row of lane l-1's strip at
//     column j) and the gen character of column j come from lane l-1 by
//     one __shfl_up_sync each, as lane l-1 computed that column one
//     step earlier; lane 0 takes them from registers the warp filled a
//     warp-width ahead.  Inside a lane a cell is the plain recurrence
//     v = min(diag + cost, up + 1, left + 1), with the vertical chain
//     written as a running minimum of min(diag + cost, left + 1) - r
//     (one dependent minimum a row); the DP values are unique, so they
//     equal the plain version's cummin rows exactly.  The strip's est
//     codes are pinned in registers (the compiler would reload them
//     every step), and the mismatch cost is one masked xor and a minimum
//     whose bound is 0 on a gen wildcard.
//   * Long ests run in passes of 32 x R = 512 rows: lane 31 keeps the
//     pass's last row in a (B, max_m + 1) int32 row buffer, which lane 0
//     of the next pass reads a warp-width ahead.
//   * Only the problem's own elen rows and glen columns are computed, and
//     a pass drains over only the lanes that hold rows: the bucket's
//     padding costs nothing.
//   * Directions are 2 bits a cell, the JAX package's wire width: the R
//     codes of a lane's column form one 32-bit word, stored at (strip,
//     column), strips of R rows in row order and each strip's columns
//     contiguous: the scratch is a quarter of the cells' count in bytes.
//     Their compares and selects take about a third of the fill.
//   * Walk.  From (elen, glen) the warp loads a tile of 3 strips x 32
//     columns ending at the current cell (3 coalesced 128-byte rows)
//     into shared memory; the path stays inside it for at least 32 steps
//     (it leaves only after 32 moves left or 33 moves up), each step a
//     shared-memory read, not an L2 round trip.  Lane 0 writes the op
//     codes; the warp pads the rest with 3.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;         // est rows a lane holds: 2 bits each
constexpr int kWarps = 4;         // problems a block, one warp each
constexpr int kTileStrips = 3;    // the walk's tile: 3 strips x 32 columns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool wildcard(int c) {
  return c == 'N' || c == 'n';
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
    nw_kernel(const int8_t* __restrict__ est, int n_cols,
              const int8_t* __restrict__ gen, int m_cols,
              const int32_t* __restrict__ elen,
              const int32_t* __restrict__ glen, uint32_t* dirs,
              int32_t* rowbuf, int32_t* __restrict__ score,
              int8_t* __restrict__ ops, int32_t* __restrict__ nsteps,
              int batch) {
  static_assert(2 * R == 32, "a lane's column of directions is one word");
  constexpr int kPass = 32 * R;
  __shared__ uint32_t tiles[kWarps][kTileStrips][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= batch) return;  // b is the same on every lane of the warp
  const int n = min(max(elen[b], 0), n_cols);
  const int m = min(max(glen[b], 0), m_cols);
  const int8_t* e = est + static_cast<size_t>(b) * n_cols;
  const int8_t* g = gen + static_cast<size_t>(b) * m_cols;
  uint32_t* D = dirs + static_cast<size_t>(b) * ((n_cols + R - 1) / R) *
                           m_cols;
  int32_t* top = rowbuf + static_cast<size_t>(b) * (m_cols + 1);

  int col[R];  // M[i][j] of the lane's rows at its last column
  for (int p0 = 0; m > 0 && p0 < n; p0 += kPass) {
    const int i0 = p0 + lane * R;  // the row above the lane's strip
    const int lact = min(32, (n - p0 + R - 1) / R);  // lanes with rows
    const bool keep = p0 + kPass < n;  // a pass follows: keep last row
    // the strip's est codes, and a mask that is 0 on a wildcard row;
    // the empty asm keeps them in registers (the compiler would reload
    // the bytes from memory at every step instead)
    int ec[R];
    unsigned em[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r + 1;
      ec[r] = i <= n ? e[i - 1] : 0;
      em[r] = wildcard(ec[r]) ? 0u : ~0u;
      asm volatile("" : "+r"(ec[r]), "+r"(em[r]));
      col[r] = i;  // column 0: M[i][0] = i
    }
    int diag_top = i0;  // M[i0][j-1], first M[i0][0]
    int bottom = 0, gch = 0;
    // lane 0's inputs a warp-width ahead: gen[j-1] and M[p0][j] for
    // j = s + 1 at step s; lane k holds step base + k's
    int cur_g, cur_t, nxt_g, nxt_t;
    auto fetch = [&](int base, int& gv, int& tv) {
      const int j = base + lane + 1;
      gv = j <= m ? g[j - 1] : 0;
      tv = j <= m ? (p0 == 0 ? j : top[j]) : 0;
    };
    fetch(0, cur_g, cur_t);
    fetch(32, nxt_g, nxt_t);
    const int steps = m + lact - 1;
    for (int s = 0; s < steps; ++s) {
      const int k = s & 31;
      if (k == 0 && s > 0) {
        cur_g = nxt_g;
        cur_t = nxt_t;
        fetch(s + 32, nxt_g, nxt_t);
      }
      const int g0 = __shfl_sync(kFull, cur_g, k);
      const int t0 = __shfl_sync(kFull, cur_t, k);
      int up_in = __shfl_up_sync(kFull, bottom, 1);  // M[i0][j]
      const int g_in = __shfl_up_sync(kFull, gch, 1);
      gch = lane == 0 ? g0 : g_in;
      if (lane == 0) up_in = t0;
      const int j = s - lane + 1;
      if (lane < lact && j >= 1 && j <= m) {
        const unsigned gm = wildcard(gch) ? 0u : 1u;  // 0 on a wildcard
        int prev = diag_top;  // M[i-1][j-1]
        int vprev = up_in;    // M[i-1][j]
        int y = up_in + 1;    // running min of the candidates - r
        uint32_t word = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int L = col[r];  // M[i][j-1]
          // 1 on a mismatch of two bases that are not N/n
          const unsigned cost =
              min(static_cast<unsigned>(gch ^ ec[r]) & em[r], gm);
          const int diag = prev + static_cast<int>(cost);
          const int left = L + 1;
          y = min(y, min(diag, left) - r);
          const int v = y + r;
          const int up = vprev + 1;
          const unsigned d =
              left < min(diag, up) ? 2u : (up < diag ? 1u : 0u);
          word |= d << (2 * r);
          prev = L;
          col[r] = v;
          vprev = v;
        }
        bottom = col[R - 1];
        diag_top = up_in;
        D[static_cast<size_t>(p0 / R + lane) * m_cols + (j - 1)] = word;
        if (keep && lane == 31) top[j] = bottom;
      }
    }
    __syncwarp();  // the row buffer and the directions, for lane 0 / walk
  }

  int sc = n == 0 ? m : n;  // one side empty: the other's length
  if (n > 0 && m > 0) {
    const int last = (n - 1) / kPass * kPass;
    const int rn = (n - 1) % R;
    int mine = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == rn) mine = col[r];
    sc = __shfl_sync(kFull, mine, (n - 1 - last) / R);
  }

  const int T_ops = n_cols + m_cols;
  int8_t* o = ops + static_cast<size_t>(b) * T_ops;
  uint32_t(*tile)[32] = tiles[w];
  int i = n, j = m, s = 0;
  while (i > 0 && j > 0) {
    const int st = (i - 1) / R;  // the strip of row i
#pragma unroll
    for (int q = 0; q < kTileStrips; ++q) {
      const int c = j - lane;  // tile column lane: column j - lane
      tile[q][lane] = (st - q >= 0 && c >= 1)
                          ? D[static_cast<size_t>(st - q) * m_cols + (c - 1)]
                          : 0u;
    }
    __syncwarp();
    const int i_lo = max((st - kTileStrips + 1) * R, 0);
    const int j_lo = max(j - 32, 0);
    const int j0 = j;
    while (i > i_lo && j > j_lo) {
      const uint32_t word = tile[st - (i - 1) / R][j0 - j];
      const int d = (word >> (2 * ((i - 1) % R))) & 3u;
      if (lane == 0) o[s] = static_cast<int8_t>(d);
      ++s;
      i -= d != 2;
      j -= d != 1;
    }
    __syncwarp();
  }
  if (lane == 0) {
    score[b] = sc;
    nsteps[b] = s;
  }
  for (int p = s + lane; p < T_ops; p += 32) o[p] = 3;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller: est (B, n_cols) and gen (B, m_cols)
// int8, elen/glen/score/nsteps (B,) int32, dirs (B, ceil(n_cols / 16),
// m_cols) uint32 scratch, rowbuf (B, m_cols + 1) int32 scratch, ops
// (B, n_cols + m_cols) int8.  The launch goes on the caller's stream and
// is not synchronised.  Returns the cudaError of the launch (0 on
// success).
extern "C" int pintron_nw(const void* est, int n_cols, const void* gen,
                          int m_cols, const void* elen, const void* glen,
                          void* dirs, void* rowbuf, void* score, void* ops,
                          void* nsteps, int batch, void* stream) {
  if (batch <= 0) return 0;
  if (n_cols < 1 || m_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kWarps - 1) / kWarps;
  nw_kernel<kRows><<<blocks, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(est), n_cols,
      static_cast<const int8_t*>(gen), m_cols,
      static_cast<const int32_t*>(elen), static_cast<const int32_t*>(glen),
      static_cast<uint32_t*>(dirs), static_cast<int32_t*>(rowbuf),
      static_cast<int32_t*>(score), static_cast<int8_t*>(ops),
      static_cast<int32_t*>(nsteps), batch);
  return static_cast<int>(cudaGetLastError());
}
