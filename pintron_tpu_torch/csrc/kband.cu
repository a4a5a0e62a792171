// Hand-written Hopper (sm_90a) kernels for the K-band family of the
// est-fact (STEP 2) device offload.
//
// kband_kernel replaces the Pallas TPU kernel
//   ops/pallas_align.py::_kband_kernel of the JAX package
//   (launched by banded_edit_distance_pallas),
// and edit_score_kernel replaces the XLA op
//   ops/align.py::batch_edit_distance_score of the JAX package,
// which the offload uses for the K-band problems whose band covers the
// whole matrix (2*ub+1 >= n).
//
// Both compute exactly what the JAX ops compute: the same int32 values,
// the same sentinel BIG = 1 << 20, the same band and boundary masks, and
// rows past len2 frozen.  The plain PyTorch versions in
// pintron_tpu_torch/ops/align.py are their reference.
//
// What bounds them on this card: each problem is a serial row wavefront
// with a few integer operations per cell, so a thread's time is the
// latency of its dependent chain of band-vector loads and stores, one
// row after the other; neither the ALUs nor the HBM bandwidth are
// near their limit.  The design keeps that chain short and cheap:
//   * one thread per problem (blocks of 128), no synchronisation;
//   * the band vector (or, for edit_score_kernel, the DP row) lives in
//     an int32 scratch laid out (W, B), so the 32 threads of a warp
//     touch 32 neighbouring words on every load and store, and the
//     whole scratch (33 x 32768 x 4 B = 4.3 MB at the production shape)
//     stays resident in the 50 MB L2;
//   * a row is one ascending in-place walk over the band: the diagonal
//     and up neighbours are read before the cell is overwritten, and
//     the in-row left chain min_{j<=o}(cand[j] + o - j) is the serial
//     relaxation run = min(cand, run + 1), the same integers as the
//     TPU kernel's log2(W) prefix-min;
//   * characters are compared as raw bytes (int8), for equality only.
// Keeping the band in shared memory or registers, a warp per problem
// with the left chain closed by __shfl_up_sync, and int16 cells are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kThreads = 128;

__global__ void kband_kernel(const int8_t* __restrict__ seq1, int n_cols,
                             const int8_t* __restrict__ seq2, int m_cols,
                             const int32_t* __restrict__ len1,
                             const int32_t* __restrict__ len2,
                             const int32_t* __restrict__ band,
                             int32_t* __restrict__ band_rows,
                             int32_t* __restrict__ out, int batch,
                             int max_rows, int k_max) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int W = 2 * k_max + 1;
  const int n = len1[b];
  const int m = len2[b];
  const int k = band[b];
  const int8_t* s1 = seq1 + static_cast<size_t>(b) * n_cols;
  const int8_t* s2 = seq2 + static_cast<size_t>(b) * m_cols;
  int32_t* M = band_rows + b;  // M[o] lives at M[o * batch]
  const size_t stride = static_cast<size_t>(batch);

  // row 0: M[o] = c for 0 <= c <= band (c = o - k_max), BIG elsewhere
  for (int o = 0; o < W; ++o) {
    const int c = o - k_max;
    M[o * stride] = (c >= 0 && c <= k) ? c : kBig;
  }

  // rows past len2 keep the band, so the walk stops there
  const int rows = min(max_rows, m);
  for (int r = 1; r <= rows; ++r) {
    const int8_t ch2 = s2[min(r - 1, m_cols - 1)];
    int diag_src = M[0];  // M_prev[o], read before M[o] is overwritten
    int run = kBig;
    for (int o = 0; o < W; ++o) {
      const int up_src = (o + 1 < W) ? M[(o + 1) * stride] : kBig;
      const int c = o + r - k_max;
      int cand = kBig;
      if (c == 0 && r <= k) {
        cand = r;  // boundary column, forced while r <= band
      } else if (abs(o - k_max) <= k && c >= 1 && c <= n) {
        const int8_t ch1 = s1[min(c - 1, n_cols - 1)];
        cand = min(diag_src + (ch1 != ch2 ? 1 : 0), up_src + 1);
      }
      run = (o == 0) ? cand : min(cand, run + 1);
      M[o * stride] = min(run, kBig);
      diag_src = up_src;
    }
  }

  const int final_off = min(max(n - m + k_max, 0), W - 1);
  out[b] = M[final_off * stride];
}

__global__ void edit_score_kernel(const int8_t* __restrict__ seq1,
                                  int n_cols,
                                  const int8_t* __restrict__ seq2,
                                  int m_cols,
                                  const int32_t* __restrict__ len1,
                                  const int32_t* __restrict__ len2,
                                  int32_t* __restrict__ dp_rows,
                                  int32_t* __restrict__ out, int batch,
                                  int max_rows) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  // columns past len1 never reach the final cell M[len2][len1]
  const int n = min(max(len1[b], 0), n_cols);
  const int m = len2[b];
  const int8_t* s1 = seq1 + static_cast<size_t>(b) * n_cols;
  const int8_t* s2 = seq2 + static_cast<size_t>(b) * m_cols;
  int32_t* M = dp_rows + b;  // M[c] lives at M[c * batch]
  const size_t stride = static_cast<size_t>(batch);

  for (int c = 0; c <= n; ++c) M[c * stride] = c;

  const int rows = min(max_rows, m);
  for (int r = 1; r <= rows; ++r) {
    const int8_t ch2 = s2[min(r - 1, m_cols - 1)];
    int diag_src = M[0];  // M_prev[c - 1]
    int run = r;
    M[0] = r;
    for (int c = 1; c <= n; ++c) {
      const int up_src = M[c * stride];
      const int cand =
          min(diag_src + (s1[c - 1] != ch2 ? 1 : 0), up_src + 1);
      run = min(cand, run + 1);
      M[c * stride] = run;
      diag_src = up_src;
    }
  }
  out[b] = M[n * stride];
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller; the launch goes on the caller's
// stream and is not synchronised.  The return value is the
// cudaGetLastError() of the launch (0 on success).

extern "C" int pintron_kband(const void* seq1, int n_cols, const void* seq2,
                             int m_cols, const void* len1, const void* len2,
                             const void* band, void* band_rows, void* out,
                             int batch, int max_rows, int k_max,
                             void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  kband_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(seq1), n_cols,
      static_cast<const int8_t*>(seq2), m_cols,
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2),
      static_cast<const int32_t*>(band), static_cast<int32_t*>(band_rows),
      static_cast<int32_t*>(out), batch, max_rows, k_max);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pintron_edit_score(const void* seq1, int n_cols,
                                  const void* seq2, int m_cols,
                                  const void* len1, const void* len2,
                                  void* dp_rows, void* out, int batch,
                                  int max_rows, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  edit_score_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(seq1), n_cols,
      static_cast<const int8_t*>(seq2), m_cols,
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2),
      static_cast<int32_t*>(dp_rows), static_cast<int32_t*>(out), batch,
      max_rows);
  return static_cast<int>(cudaGetLastError());
}
