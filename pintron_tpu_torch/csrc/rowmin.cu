// Hand-written Hopper (sm_90a) kernel for the refine-borders family of
// the est-fact (STEP 2) device offload.
//
// rowmin_kernel replaces the XLA op
//   ops/align.py::batch_edit_rowmin (pintron_tpu/ops/align.py:176)
// of the JAX package: the full unit-cost edit DP of a pattern (rows)
// against a text window (columns), and for every row its minimum over
// columns 0..len1 and the FIRST column attaining it (:203-209).  Same
// int32 recurrence; the plain PyTorch version in
// pintron_tpu_torch/ops/align.py is its reference.  The results are
// int32, so the JAX op's int16 wire format and its argmin encoding
// bound (CLAMP) are not needed.
//
// What bounds it on this card: the batches are small (30-146 problems
// of at most 64 x 64 cells on the golden loci), so the time is the
// latency of each problem's serial chain of rows, two block barriers a
// row.  The design:
//   * one block per problem, threads owning contiguous column spans,
//     the DP row in shared memory (rowscan.cuh's layout) updated in
//     place;
//   * per row, the left chain is closed by a block-wide exclusive
//     min-scan, then each thread relaxes its span and keeps its span's
//     smallest (value, column) key; a block-wide min of the 64-bit keys
//     (value << 32 | column) gives the row's minimum and first argmin;
//   * no scratch: rows are written to the (B, max_rows + 1) outputs as
//     they finish, and only the problem's own len2 rows and len1
//     columns are computed.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "rowscan.cuh"

namespace {

using pintron::slot;

__global__ void __launch_bounds__(pintron::kMaxThreads)
    rowmin_kernel(const int8_t* __restrict__ seq1, int n_cols,
                  const int8_t* __restrict__ seq2, int m_cols,
                  const int32_t* __restrict__ len1,
                  const int32_t* __restrict__ len2,
                  int32_t* __restrict__ vals, int32_t* __restrict__ pos,
                  int max_rows, int cpt) {
  extern __shared__ int smem[];
  __shared__ int scan_buf[32];
  __shared__ long long min_buf[32];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int T = blockDim.x;
  int* row = smem;                                          // cpt * T ints
  int8_t* s1s = reinterpret_cast<int8_t*>(row + cpt * T);   // text codes
  const int n = min(max(len1[b], 0), n_cols);
  const int m = min(max(len2[b], 0), max_rows);
  const int8_t* s1 = seq1 + static_cast<size_t>(b) * n_cols;
  const int8_t* s2 = seq2 + static_cast<size_t>(b) * m_cols;
  int32_t* V = vals + static_cast<size_t>(b) * (max_rows + 1);
  int32_t* P = pos + static_cast<size_t>(b) * (max_rows + 1);
  const int j0 = 1 + t * cpt;

  // row 0: M[0][j] = j, minimum 0 at column 0
  for (int k = 0; k < cpt; ++k) {
    const int j = j0 + k;
    row[slot(k, t)] = j;
    s1s[slot(k, t)] = j <= n ? s1[j - 1] : 0;
  }
  if (t == 0) {
    V[0] = 0;
    P[0] = 0;
  }
  __syncthreads();

  for (int r = 1; r <= m; ++r) {
    const int8_t ch2 = s2[min(r - 1, m_cols - 1)];
    // M[r-1][j0-1], read before the scan's barrier
    const int edge = t == 0 ? r - 1 : row[slot(cpt - 1, t - 1)];
    int diag_src = edge;
    int agg = pintron::MinOp::identity();
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = row[slot(k, t)];
      const int cand =
          min(diag_src + (s1s[slot(k, t)] != ch2 ? 1 : 0), up_src + 1);
      agg = min(agg, cand - j);
      diag_src = up_src;
    }
    const int excl =
        pintron::block_exclusive_scan(agg, r, scan_buf, pintron::MinOp());
    int v = excl + j0 - 1;  // M[r][j0-1]
    diag_src = edge;
    // column 0 holds r
    long long key = t == 0 ? static_cast<long long>(r) << 32 : LLONG_MAX;
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k;
      const int up_src = row[slot(k, t)];
      const int cand =
          min(diag_src + (s1s[slot(k, t)] != ch2 ? 1 : 0), up_src + 1);
      v = min(cand, v + 1);
      row[slot(k, t)] = v;
      diag_src = up_src;
      if (j <= n) key = min(key, (static_cast<long long>(v) << 32) | j);
    }
    // the reduction's barrier also orders this row's writes before the
    // next row's edge reads
    key = pintron::block_min(key, min_buf);
    if (t == 0) {
      V[r] = static_cast<int32_t>(key >> 32);
      P[r] = static_cast<int32_t>(key & 0xffffffffLL);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller: seq1 (B, n_cols) and seq2 (B, m_cols)
// int8, len1/len2 (B,) int32, vals/pos (B, max_rows + 1) int32.  The
// launch goes on the caller's stream and is not synchronised.  Returns
// the cudaError of the launch (0 on success).
extern "C" int pintron_rowmin(const void* seq1, int n_cols, const void* seq2,
                              int m_cols, const void* len1, const void* len2,
                              void* vals, void* pos, int batch, int max_rows,
                              void* stream) {
  if (batch <= 0) return 0;
  int cpt, threads;
  if (!pintron::row_geometry(n_cols, &cpt, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(cpt) * threads * (4 + 1);
  return pintron::launch_rows(
      rowmin_kernel, batch, threads, bytes, stream,
      static_cast<const int8_t*>(seq1), n_cols,
      static_cast<const int8_t*>(seq2), m_cols,
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(pos), max_rows,
      cpt);
}
