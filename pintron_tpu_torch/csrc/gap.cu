// Hand-written Hopper (sm_90a) kernel for the intron-refinement (gap
// alignment) family of the est-fact (STEP 2) device offload.
//
// gap_kernel replaces the XLA op
//   ops/align.py::batch_gap_traceback (pintron_tpu/ops/align.py:353)
// of the JAX package: the 3-matrix L/G/R gap alignment (match +1,
// mismatch -1 with N/n wildcards, gap -1 in L and R, a free genomic
// gap in G, free horizontal moves on R's last row), the fill
// (:394-447), the start-matrix choice (:465-474) and the matrix-state
// traceback walk (:481-500) all on the card.  Same int32 values and
// direction bytes (bits 0-1 L, bit 2 G, bits 3-4 R); the plain PyTorch
// version in pintron_tpu_torch/ops/align.py is its reference.
//
// What bounds it on this card: the batches are many small problems
// (788 of them at est x gen = 64 x 256 on the golden loci), each a
// serial chain of rows with three dependent left chains per row (L's
// relaxation, G's prefix max of L, R's relaxation).  Neither the ALUs
// nor the memory are near their limit; the block barriers of the three
// scans are the cost.  The design:
//   * one block per problem, threads owning contiguous column spans,
//     the L and R rows in shared memory (rowscan.cuh's layout) updated
//     in place, and a byte per column holding the row's direction bits
//     while they are gathered;
//   * per row four passes over the span around three block-wide max
//     scans: L's raw candidates and max(Lb + j); L relaxed in place with
//     its direction bits and the span's max of L over columns j0-1 ..
//     j0+cpt-2 (G at column j is the max of L left of j); R's raw
//     candidates with G and max(Rb + cost * j); R relaxed in place, its
//     direction bits, and the direction byte written to a
//     (B, max_n, max_m) int8 global scratch;
//   * the final L, G and R cells at (elen, glen) pick the start matrix,
//     and one thread walks the traceback over the scratch.
// Only the problem's own elen rows and glen columns are computed.

#include <cstdint>
#include <cuda_runtime.h>

#include "rowscan.cuh"

namespace {

using pintron::slot;

__global__ void __launch_bounds__(pintron::kMaxThreads)
    gap_kernel(const int8_t* __restrict__ est, int n_cols,
               const int8_t* __restrict__ gen, int m_cols,
               const int32_t* __restrict__ elen,
               const int32_t* __restrict__ glen, int8_t* __restrict__ dirs,
               int32_t* __restrict__ sm_out, int8_t* __restrict__ ops,
               int32_t* __restrict__ nsteps, int cpt) {
  extern __shared__ int smem[];
  __shared__ int scan_buf[2][32];
  __shared__ int fin[4];  // L, G, R at (n, m); then the steps walked
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int b = blockIdx.x;
  int* Lrow = smem;                                          // cpt * T
  int* Rrow = Lrow + cpt * T;                                // cpt * T
  int8_t* gs = reinterpret_cast<int8_t*>(Rrow + cpt * T);    // gen codes
  int8_t* dbits = gs + cpt * T;                              // dir bits
  const int n = min(max(elen[b], 0), n_cols);
  const int m = min(max(glen[b], 0), m_cols);
  const int8_t* e = est + static_cast<size_t>(b) * n_cols;
  const int8_t* g = gen + static_cast<size_t>(b) * m_cols;
  int8_t* D = dirs + static_cast<size_t>(b) * n_cols * m_cols;
  const int j0 = 1 + t * cpt;

  // row 0 of L and R is all zeros (so is column 0 of every row)
  for (int k = 0; k < cpt; ++k) {
    const int j = j0 + k;
    Lrow[slot(k, t)] = 0;
    Rrow[slot(k, t)] = 0;
    gs[slot(k, t)] = j <= m ? g[j - 1] : 0;
  }
  if (t == 0) fin[0] = fin[1] = fin[2] = 0;
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    const int8_t ce = e[i - 1];
    const bool we = pintron::wildcard(ce);
    const int cost = i == n ? 0 : 1;  // R's last row moves left for free
    // L[i-1][j0-1] and R[i-1][j0-1], read before the first barrier
    const int Ledge = t == 0 ? 0 : Lrow[slot(cpt - 1, t - 1)];
    const int Redge = t == 0 ? 0 : Rrow[slot(cpt - 1, t - 1)];

    // pass 1: L's raw candidates, span max of Lb[j] + j
    int diag_src = Ledge;
    int agg = pintron::MaxOp::identity();
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = Lrow[slot(k, t)];
      const int8_t gc = gs[slot(k, t)];
      const int ms = (gc == ce || we || pintron::wildcard(gc)) ? 1 : -1;
      agg = max(agg, max(diag_src + ms, up_src - 1) + j);
      diag_src = up_src;
    }
    const int exclL = pintron::block_exclusive_scan(agg, 0, scan_buf[0],
                                                    pintron::MaxOp());
    const int Lleft = exclL - (j0 - 1);  // L[i][j0-1]

    // pass 2: L relaxed in place with its direction bits; span max of L
    // over columns j0-1 .. j0+cpt-2 for G
    int lrel = Lleft;
    int aggG = Lleft;
    diag_src = Ledge;
    for (int k = 0; k < cpt; ++k) {
      const int up_src = Lrow[slot(k, t)];
      const int8_t gc = gs[slot(k, t)];
      const int ms = (gc == ce || we || pintron::wildcard(gc)) ? 1 : -1;
      const int diagL = diag_src + ms;
      const int upL = up_src - 1;
      lrel = max(max(diagL, upL), lrel - 1);
      dbits[slot(k, t)] = lrel == diagL ? 0 : (lrel == upL ? 1 : 2);
      Lrow[slot(k, t)] = lrel;
      if (k < cpt - 1) aggG = max(aggG, lrel);
      diag_src = up_src;
    }
    // G[i][j0-1] = max(0, L[i][1 .. j0-2]); L[i][0] = 0 seeds it
    const int Gleft = pintron::block_exclusive_scan(aggG, 0, scan_buf[1],
                                                    pintron::MaxOp());

    // pass 3: R's raw candidates (diag, up, G[i][j-1]), G's direction
    // bit, span max of Rb[j] + cost * j
    int gprev = Gleft;   // G[i][j-1]
    int lprev = Lleft;   // L[i][j-1]
    diag_src = Redge;
    agg = pintron::MaxOp::identity();
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = Rrow[slot(k, t)];
      const int8_t gc = gs[slot(k, t)];
      const int ms = (gc == ce || we || pintron::wildcard(gc)) ? 1 : -1;
      const int rb = max(max(diag_src + ms, up_src - 1), gprev);
      agg = max(agg, rb + cost * j);
      dbits[slot(k, t)] |= (gprev < lprev ? 0 : 1) << 2;
      gprev = max(gprev, lprev);
      lprev = Lrow[slot(k, t)];
      diag_src = up_src;
    }
    const int exclR = pintron::block_exclusive_scan(agg, 0, scan_buf[0],
                                                    pintron::MaxOp());

    // pass 4: R relaxed in place, its direction bits, the direction byte
    int rrel = exclR - cost * (j0 - 1);  // R[i][j0-1]
    gprev = Gleft;
    lprev = Lleft;
    diag_src = Redge;
    int8_t* Drow = D + static_cast<size_t>(i - 1) * m_cols;
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = Rrow[slot(k, t)];
      const int8_t gc = gs[slot(k, t)];
      const int ms = (gc == ce || we || pintron::wildcard(gc)) ? 1 : -1;
      const int diagR = diag_src + ms;
      const int rb = max(max(diagR, up_src - 1), gprev);
      const int leftR = rrel - cost;
      rrel = max(rb, leftR);
      const int rd =
          rrel == diagR ? 0 : (rrel == leftR ? 2 : (rrel == gprev ? 3 : 1));
      Rrow[slot(k, t)] = rrel;
      if (j <= m) Drow[j - 1] = static_cast<int8_t>(dbits[slot(k, t)] | (rd << 3));
      const int lcur = Lrow[slot(k, t)];
      if (i == n && j == m) {
        fin[0] = lcur;
        fin[1] = max(gprev, lprev);  // G[n][m]
        fin[2] = rrel;
      }
      gprev = max(gprev, lprev);
      lprev = lcur;
      diag_src = up_src;
    }
    __syncthreads();
  }

  const int T_ops = n_cols + m_cols;
  int8_t* o = ops + static_cast<size_t>(b) * T_ops;
  if (t == 0) {
    const int Lf = fin[0], Gf = fin[1], Rf = fin[2];
    int sm = Rf >= Gf ? (Rf >= Lf ? 2 : 0) : (Gf >= Lf ? 1 : 0);
    sm_out[b] = sm;
    int i = n, j = m, s = 0;
    while (i > 0 && j > 0) {
      const int c = D[static_cast<size_t>(i - 1) * m_cols + (j - 1)];
      int d;  // 0 diag, 1 up, 2 left, 3 left with a jump to sm - 1
      if (sm == 2) {
        d = (c >> 3) & 3;
      } else if (sm == 1) {
        d = (c & 4) ? 2 : 3;
      } else {
        d = c & 3;
      }
      o[s++] = static_cast<int8_t>(d);
      i -= d <= 1;
      j -= d != 1;
      sm -= d == 3;
    }
    nsteps[b] = s;
    fin[3] = s;
  }
  __syncthreads();
  for (int p = fin[3] + t; p < T_ops; p += T) o[p] = 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller: est (B, n_cols) and gen (B, m_cols)
// int8, elen/glen/sm/nsteps (B,) int32, dirs (B, n_cols, m_cols) int8
// scratch, ops (B, n_cols + m_cols) int8.  The launch goes on the
// caller's stream and is not synchronised.  Returns the cudaError of the
// launch (0 on success).
extern "C" int pintron_gap(const void* est, int n_cols, const void* gen,
                           int m_cols, const void* elen, const void* glen,
                           void* dirs, void* sm, void* ops, void* nsteps,
                           int batch, void* stream) {
  if (batch <= 0) return 0;
  int cpt, threads;
  if (!pintron::row_geometry(m_cols, &cpt, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(cpt) * threads * (4 + 4 + 1 + 1);
  return pintron::launch_rows(
      gap_kernel, batch, threads, bytes, stream,
      static_cast<const int8_t*>(est), n_cols,
      static_cast<const int8_t*>(gen), m_cols,
      static_cast<const int32_t*>(elen), static_cast<const int32_t*>(glen),
      static_cast<int8_t*>(dirs), static_cast<int32_t*>(sm),
      static_cast<int8_t*>(ops), static_cast<int32_t*>(nsteps), cpt);
}
