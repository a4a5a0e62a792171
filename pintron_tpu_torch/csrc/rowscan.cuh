// Block-wide building blocks of the row-parallel DP kernel of rowmin.cu
// (the nw.cu and gap.cu kernels run a warp per problem and use none of
// it): one block per problem, each thread owning a contiguous span of
// `cpt` columns of the DP row.
//
// The DP row lives in shared memory in a thread-major layout: column
// j = 1 + t * cpt + k (thread t, k < cpt) sits at index k * T + t, so
// the 32 threads of a warp touch 32 consecutive words for every k
// (no bank conflicts).  Column 0 is the problem's boundary column and
// is never stored: its value is known in closed form.
//
// The in-row left chain of each DP row is closed by an exclusive
// block-wide min scan over the threads' span aggregates, the same
// associative prefix the JAX op takes with lax.cummin, so the integers
// are the same.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace pintron {

constexpr int kMaxThreads = 512;  // threads of a block, a multiple of 32
constexpr int kMaxCpt = 32;       // columns per thread: rows <= 16384 wide

struct MinOp {
  static __device__ __forceinline__ int identity() { return INT_MAX; }
  __device__ __forceinline__ int operator()(int a, int b) const {
    return min(a, b);
  }
};

__device__ __forceinline__ int slot(int k, int t) {
  return k * static_cast<int>(blockDim.x) + t;
}

// Exclusive scan of one value per thread, in thread order, seeded with
// `seed` (the aggregate of the columns left of thread 0).  Every thread
// of the block calls it.  `buf` is 32 ints of shared memory.  Two
// __syncthreads inside; a caller that scans again before its next
// __syncthreads must pass the other of two buffers, since a slow
// thread may still read this call's warp totals.
template <class Op>
__device__ __forceinline__ int block_exclusive_scan(int x, int seed,
                                                    int* buf, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = op(incl, y);
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = Op::identity();
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? buf[lane] : Op::identity();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = op(w, y);
    }
    if (lane < nwarps) buf[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int pre = seed;
  if (warp > 0) pre = op(pre, buf[warp - 1]);
  return op(pre, excl);
}

// Minimum of one 64-bit key per thread; the result is valid in thread
// 0.  One __syncthreads inside.  `buf` is 32 long longs of shared
// memory, not touched again before the caller's next __syncthreads.
__device__ __forceinline__ long long block_min(long long x,
                                               long long* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (lane == 0) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < nwarps ? buf[lane] : LLONG_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// Launch geometry for a row `width` columns wide: the fewest columns per
// thread (a power of two) that fit the row into kMaxThreads threads,
// then the threads rounded up to whole warps.  Returns false when the
// row is wider than kMaxThreads * kMaxCpt.
inline bool row_geometry(int width, int* cpt, int* threads) {
  int c = 1;
  while ((width + c - 1) / c > kMaxThreads) c <<= 1;
  if (c > kMaxCpt) return false;
  const int t = (width + c - 1) / c;
  *cpt = c;
  *threads = t < 32 ? 32 : (t + 31) / 32 * 32;
  return true;
}

// Opt the kernel in to `bytes` of dynamic shared memory (above 48 KB
// Hopper needs the attribute) and launch it; returns the cudaError of
// the attribute call or of the launch.
template <class Kernel, class... Args>
inline int launch_rows(Kernel kernel, int blocks, int threads, size_t bytes,
                       void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pintron
