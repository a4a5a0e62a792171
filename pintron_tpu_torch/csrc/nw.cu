// Hand-written Hopper (sm_90a) kernel for the endpoint-NW family of the
// est-fact (STEP 2) device offload.
//
// nw_kernel replaces the XLA op
//   ops/align.py::batch_nw_traceback (pintron_tpu/ops/align.py:241)
// of the JAX package: Needleman-Wunsch with unit costs, N/n wildcards,
// direction ties diag > up > left, the fill (:274-293) and the
// traceback walk (:318-329) both on the card.  Same int32 values and
// direction bytes; the plain PyTorch version in
// pintron_tpu_torch/ops/align.py is its reference.
//
// What bounds it on this card: each problem is a serial chain of rows
// (up to 4096 of them, 4096 columns wide, at the locus's largest
// bucket), and each row's left chain is a prefix minimum, so one thread
// per problem would pay one dependent step per cell (about 115 ns a
// step for the K-band kernel, 2 s for a 4096 x 4096 problem).  The
// design:
//   * one block per problem, up to 512 threads, each owning a
//     contiguous span of columns; the previous DP row sits in shared
//     memory (rowscan.cuh's thread-major layout), updated in place;
//   * per row, pass 1 forms each cell's diag/up candidate and the
//     span's min(cand - j); a block-wide exclusive min-scan closes the
//     left chain across spans; pass 2 walks the span once more with the
//     serial relaxation v = min(cand, v + 1), writes the row and the
//     direction byte of each cell to a (B, max_n, max_m) int8 global
//     scratch;
//   * the traceback is one thread's walk over that scratch, from
//     (elen, glen) back to row or column 0: a chain of dependent loads,
//     L2 hits while the problem's scratch stays resident (16 MB at
//     4096 x 4096);
//   * only the problem's own elen rows and glen columns are computed:
//     nothing right of or below them reaches the result.
// A faster traceback (directions in 2 bits, the walk staged through
// shared memory) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "rowscan.cuh"

namespace {

using pintron::slot;

__global__ void __launch_bounds__(pintron::kMaxThreads)
    nw_kernel(const int8_t* __restrict__ est, int n_cols,
              const int8_t* __restrict__ gen, int m_cols,
              const int32_t* __restrict__ elen,
              const int32_t* __restrict__ glen, int8_t* __restrict__ dirs,
              int32_t* __restrict__ score, int8_t* __restrict__ ops,
              int32_t* __restrict__ nsteps, int cpt) {
  extern __shared__ int smem[];
  __shared__ int scan_buf[32];
  __shared__ int walked;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int b = blockIdx.x;
  int* row = smem;                                         // cpt * T ints
  int8_t* gs = reinterpret_cast<int8_t*>(row + cpt * T);   // gen codes
  const int n = min(max(elen[b], 0), n_cols);
  const int m = min(max(glen[b], 0), m_cols);
  const int8_t* e = est + static_cast<size_t>(b) * n_cols;
  const int8_t* g = gen + static_cast<size_t>(b) * m_cols;
  int8_t* D = dirs + static_cast<size_t>(b) * n_cols * m_cols;
  const int j0 = 1 + t * cpt;

  // row 0: M[0][j] = j
  for (int k = 0; k < cpt; ++k) {
    const int j = j0 + k;
    row[slot(k, t)] = j;
    gs[slot(k, t)] = j <= m ? g[j - 1] : 0;
  }
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    const int8_t ce = e[i - 1];
    const bool we = pintron::wildcard(ce);
    // M[i-1][j0-1]: column 0 holds i-1; else the left neighbour's last
    // cell, read before the scan's barrier (it is rewritten after it)
    const int edge = t == 0 ? i - 1 : row[slot(cpt - 1, t - 1)];
    int diag_src = edge;
    int agg = pintron::MinOp::identity();
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = row[slot(k, t)];
      const int8_t gc = gs[slot(k, t)];
      const bool match = gc == ce || we || pintron::wildcard(gc);
      const int cand = min(diag_src + (match ? 0 : 1), up_src + 1);
      agg = min(agg, cand - j);
      diag_src = up_src;
    }
    // column 0 contributes cand_b[0] - 0 = i
    const int excl =
        pintron::block_exclusive_scan(agg, i, scan_buf, pintron::MinOp());
    int v = excl + j0 - 1;  // M[i][j0-1]
    diag_src = edge;
    int8_t* Drow = D + static_cast<size_t>(i - 1) * m_cols;
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = row[slot(k, t)];
      const int8_t gc = gs[slot(k, t)];
      const bool match = gc == ce || we || pintron::wildcard(gc);
      const int diag = diag_src + (match ? 0 : 1);
      const int up = up_src + 1;
      const int left = v + 1;
      const int best = min(diag, up);
      v = min(best, left);
      row[slot(k, t)] = v;
      diag_src = up_src;
      if (j <= m) Drow[j - 1] = left < best ? 2 : (up < diag ? 1 : 0);
    }
    __syncthreads();
  }

  const int T_ops = n_cols + m_cols;
  int8_t* o = ops + static_cast<size_t>(b) * T_ops;
  if (t == 0) {
    score[b] = m == 0 ? n : row[slot((m - 1) % cpt, (m - 1) / cpt)];
    int i = n, j = m, s = 0;
    while (i > 0 && j > 0) {
      const int8_t d = D[static_cast<size_t>(i - 1) * m_cols + (j - 1)];
      o[s++] = d;
      i -= d != 2;
      j -= d != 1;
    }
    nsteps[b] = s;
    walked = s;
  }
  __syncthreads();
  for (int p = walked + t; p < T_ops; p += T) o[p] = 3;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller: est (B, n_cols) and gen (B, m_cols)
// int8, elen/glen/score/nsteps (B,) int32, dirs (B, n_cols, m_cols) int8
// scratch, ops (B, n_cols + m_cols) int8.  The launch goes on the
// caller's stream and is not synchronised.  Returns the cudaError of the
// launch (0 on success).
extern "C" int pintron_nw(const void* est, int n_cols, const void* gen,
                          int m_cols, const void* elen, const void* glen,
                          void* dirs, void* score, void* ops, void* nsteps,
                          int batch, void* stream) {
  if (batch <= 0) return 0;
  int cpt, threads;
  if (!pintron::row_geometry(m_cols, &cpt, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(cpt) * threads * (4 + 1);
  return pintron::launch_rows(
      nw_kernel, batch, threads, bytes, stream,
      static_cast<const int8_t*>(est), n_cols,
      static_cast<const int8_t*>(gen), m_cols,
      static_cast<const int32_t*>(elen), static_cast<const int32_t*>(glen),
      static_cast<int8_t*>(dirs), static_cast<int32_t*>(score),
      static_cast<int8_t*>(ops), static_cast<int32_t*>(nsteps), cpt);
}
