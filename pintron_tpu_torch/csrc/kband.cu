// Hand-written Hopper (sm_90a) kernel for the K-band family of the
// est-fact (STEP 2) device offload.
//
// kband_kernel replaces the Pallas TPU kernel
//   ops/pallas_align.py::_kband_kernel of the JAX package
//   (launched by banded_edit_distance_pallas).
// The K-band problems whose band covers the whole matrix (2*ub+1 >= n)
// or is wider than this kernel takes go to edit_score_kernel
// (csrc/rowmin.cu).
//
// It computes exactly what the Pallas kernel computes: the same int32
// values, the same sentinel BIG = 1 << 20, the same band and boundary
// masks, and rows past len2 frozen.  The plain PyTorch version in
// pintron_tpu_torch/ops/align.py is its reference.
//
// What bounds it on this card: each problem is a serial row wavefront
// with a few integer operations per cell.  Neither the ALUs nor the HBM
// bandwidth are near their limit (a batch of the loci moves a few MB
// and does tens of millions of integer operations); the time is the
// dependent chain of the longest problem of a launch: its rows, one
// after the other, times the latency of one row.
//
// kband_kernel gives each problem one warp (blocks of kWarps warps) and
// keeps the band vector in registers:
//   * lane l owns the CPL adjacent band offsets o = l*CPL .. l*CPL+CPL-1
//     (CPL = ceil(W/32), a template argument: the smallest of 1, 2, 4,
//     8, 16, 17 and 33 that holds W = 2*k_max+1; 17 because W = 513 at
//     k_max = 256 is one cell more than 16 cells a lane, 33 for the
//     budgets of 257 to 512, W = 1025); offsets past W are padding that
//     stays BIG;
//   * a warp runs to its own len2 (rows past len2 would keep the band,
//     so the answer is read where the walk stops), so a launch is no
//     longer held to its longest problem of 32, and a padded problem
//     (len2 = 0) runs no row;
//   * one row is: `up` from the next offset (in-lane, and one
//     __shfl_down_sync for the lane's last cell), `diag` from the cell's
//     own previous value, `cand` with the boundary column forced, then
//     the left chain min_{j<=o}(cand[j] - j) + o as an inclusive
//     prefix-min: in-lane over the CPL cells, five __shfl_up_sync steps
//     over the 32 lanes' totals and one more for the exclusive prefix,
//     then + o and the clamp at BIG.  These are the Pallas kernel's
//     integers (its log2(W) prefix-min over the band), so the results
//     are equal.  A row's latency is about seven dependent shuffles
//     plus CPL dependent minima: that, times the longest problem's
//     rows, is what bounds a launch now (on an H100 SXM at 700 W, about
//     0.4 us a row at CPL 4, 0.64 us at CPL 8 and 1.1 us at CPL 16,
//     python -m pintron_tpu_torch.measure_kband; the ALUs and HBM are
//     idle by comparison);
//   * characters: seq2's row character is one load that every lane
//     makes of the same byte (a broadcast), and seq1's window, which
//     slides one column per row, is CPL bytes a lane, W adjacent bytes
//     a warp, read through the read-only path.  Both are loaded a row
//     ahead, off the dependent chain.  seq1 is not staged in shared
//     memory: a problem's row of seq1 is up to N bytes, and N is the
//     offload's length bucket (1024, 4096 and more), so a block of
//     warps would need up to hundreds of KB, while the warp's W
//     adjacent bytes a row hit L1 after their first row.
// Characters are compared as raw bytes (int8), for equality only.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kWarps = 4;  // one warp a problem
constexpr unsigned kFull = 0xffffffffu;

template <int CPL>
__global__ void __launch_bounds__(32 * kWarps)
kband_kernel(const int8_t* __restrict__ seq1, int n_cols,
             const int8_t* __restrict__ seq2, int m_cols,
             const int32_t* __restrict__ len1,
             const int32_t* __restrict__ len2,
             const int32_t* __restrict__ band, int32_t* __restrict__ out,
             int batch, int max_rows, int k_max) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= batch) return;  // b is the same on every lane of the warp
  const int W = 2 * k_max + 1;
  const int n = len1[b];
  const int m = len2[b];
  const int k = band[b];
  const int8_t* s1 = seq1 + static_cast<size_t>(b) * n_cols;
  const int8_t* s2 = seq2 + static_cast<size_t>(b) * m_cols;
  const int o0 = lane * CPL;  // this lane's first band offset

  // row 0: M[o] = c for 0 <= c <= band (c = o - k_max), BIG elsewhere;
  // inb: the lane's cells inside the band, |o - k_max| <= band (the
  // band is row-independent on the offset axis)
  int M[CPL];
  // one bit a cell: 33 cells a lane need a 64-bit mask
  using Mask = std::conditional_t<(CPL > 32), unsigned long long, unsigned>;
  Mask inb = 0;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int o = o0 + i;
    const int c = o - k_max;
    M[i] = (o < W && c >= 0 && c <= k) ? c : kBig;
    if (o < W && abs(c) <= k) inb |= Mask{1} << i;
  }

  const int rows = min(max_rows, m);
  // the characters of row 1: seq2[0] and seq1[c - 1] at c = o + 1 - k_max
  int8_t ch2_next = __ldg(s2);
  int8_t win_next[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    win_next[i] = __ldg(s1 + min(max(o0 + i - k_max, 0), n_cols - 1));

  for (int r = 1; r <= rows; ++r) {
    const int8_t ch2 = ch2_next;
    int8_t win[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) win[i] = win_next[i];
    if (r < rows) {  // row r+1's characters, off the chain
      ch2_next = __ldg(s2 + min(r, m_cols - 1));
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        win_next[i] =
            __ldg(s1 + min(max(o0 + i + r - k_max, 0), n_cols - 1));
    }
    // the next lane's first cell is this lane's last cell's `up`
    const int next0 = __shfl_down_sync(kFull, M[0], 1);
    int x[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int o = o0 + i;
      const int c = o + r - k_max;
      const int up = (i + 1 < CPL) ? M[i + 1] : (lane < 31 ? next0 : kBig);
      int cand = kBig;
      if (c == 0 && r <= k) {
        cand = r;  // boundary column, forced while r <= band
      } else if (((inb >> i) & 1) && c >= 1 && c <= n) {
        cand = min(M[i] + (win[i] != ch2 ? 1 : 0), up + 1);
      }
      x[i] = cand - o;
    }
    // left chain: inclusive prefix-min of cand[o] - o over the band
#pragma unroll
    for (int i = 1; i < CPL; ++i) x[i] = min(x[i], x[i - 1]);
    int t = x[CPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t = min(t, v);
    }
    int before = __shfl_up_sync(kFull, t, 1);  // lanes 0..lane-1
    if (lane == 0) before = kBig;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int o = o0 + i;
      M[i] = (o < W) ? min(min(x[i], before) + o, kBig) : kBig;
    }
  }

  const int final_off = min(max(n - m + k_max, 0), W - 1);
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    if (o0 + i == final_off) out[b] = M[i];
}

template <int CPL>
int launch_kband(const void* seq1, int n_cols, const void* seq2, int m_cols,
                 const void* len1, const void* len2, const void* band,
                 void* out, int batch, int max_rows, int k_max,
                 cudaStream_t stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  kband_kernel<CPL><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const int8_t*>(seq1), n_cols,
      static_cast<const int8_t*>(seq2), m_cols,
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2),
      static_cast<const int32_t*>(band), static_cast<int32_t*>(out), batch,
      max_rows, k_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller; the launch goes on the caller's
// stream and is not synchronised.  The return value is the
// cudaGetLastError() of the launch (0 on success).

// The widest band kband_kernel takes: W = 2*k_max+1 <= 33 * 32 (the
// wrapper, ops/kband.py, raises on a wider one before the launch).
constexpr int kMaxKmax = 512;

extern "C" int pintron_kband(const void* seq1, int n_cols, const void* seq2,
                             int m_cols, const void* len1, const void* len2,
                             const void* band, void* out, int batch,
                             int max_rows, int k_max, void* stream) {
  if (batch <= 0) return 0;
  if (k_max < 0 || k_max > kMaxKmax || n_cols < 1 || m_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = 2 * k_max + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 32)
    return launch_kband<1>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                           out, batch, max_rows, k_max, st);
  if (W <= 64)
    return launch_kband<2>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                           out, batch, max_rows, k_max, st);
  if (W <= 128)
    return launch_kband<4>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                           out, batch, max_rows, k_max, st);
  if (W <= 256)
    return launch_kband<8>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                           out, batch, max_rows, k_max, st);
  if (W <= 512)
    return launch_kband<16>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                            out, batch, max_rows, k_max, st);
  if (W <= 544)
    return launch_kband<17>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                            out, batch, max_rows, k_max, st);
  return launch_kband<33>(seq1, n_cols, seq2, m_cols, len1, len2, band,
                          out, batch, max_rows, k_max, st);
}
