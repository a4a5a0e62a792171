// Hand-written Hopper (sm_90a) kernel for stage 4's branch-point (BPS)
// sweep: MatInspector scores of fixed-width genomic windows.
//
// pwm_kernel replaces the XLA op ops/pwm.py::pwm_scores of the JAX
// package (a one-hot x cv-weighted-matrix contraction at
// Precision.HIGHEST).  It computes, per window b,
//   score[b] = (sum_{l=0..L-1} w[code[b][l]][l]) / den
// in float32: a gather and an add per column, in column order, with a
// code outside 0..3 adding nothing (the JAX op's all-zero one-hot row).
// The plain PyTorch version, pwm_scores in
// pintron_tpu_torch/ops/pwm.py, adds in the same order and divides
// once, so kernel and plain version are bit-equal.  No matrix product:
// a TF32 product would break the 1e-5 bound the exact f64 finish of
// the sweep relies on (pintron_tpu_torch/factorize/classify.py).
//
// What bounds it on this card: nothing on the card.  A window is 12
// int8 codes and 12 adds; issue-13's sweep is about 17k windows, 200 KB
// of codes.  A launch takes one to two microseconds on the card, most
// of it the launch itself and the latency of a thread's loads, and a
// call's time is the host's: the wrapper's checks, the output's
// allocation and the launch.  The design keeps a thread's chain short:
//   * one thread per window, blocks of 128;
//   * no shared memory and no barrier: a thread reads its window's
//     codes and gathers their weights through the read-only path (the
//     (4, L) table, 192 bytes at the BPS width, stays in L1); the loop
//     is unrolled by the BPS width, so at L = 12 every load of a thread
//     is issued before the first add waits on one;
//   * the adds are the only arithmetic, so no contraction into FMAs can
//     change a rounding, and the division is IEEE (no fast math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pwm_kernel(const int8_t* __restrict__ codes, int L,
           const float* __restrict__ weights, float den,
           float* __restrict__ out, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const int8_t* row = codes + static_cast<size_t>(b) * L;
  float acc = 0.0f;
#pragma unroll 12
  for (int l = 0; l < L; ++l) {
    const int c = __ldg(row + l);
    acc = __fadd_rn(acc, (c >= 0 && c < 4) ? __ldg(weights + c * L + l)
                                           : 0.0f);
  }
  out[b] = __fdiv_rn(acc, den);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  codes (batch, L) int8,
// weights (4, L) float32 and out (batch,) float32 are device pointers
// allocated by the caller; the launch goes on the caller's stream and
// is not synchronised.  Returns the cudaGetLastError() of the launch
// (0 on success), or cudaErrorInvalidValue for L < 1.

extern "C" int pintron_pwm(const void* codes, int L, const void* weights,
                           float den, void* out, int batch, void* stream) {
  if (batch <= 0) return 0;
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kThreads - 1) / kThreads;
  pwm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), L,
      static_cast<const float*>(weights), den, static_cast<float*>(out),
      batch);
  return static_cast<int>(cudaGetLastError());
}
