// Shared device helpers for the langscenex kernels: warp/block scans and
// a one-block exclusive scan used by the radix sort and the compaction.
#pragma once

#include <cuda_runtime.h>

#define LSX_CHECK_LAUNCH()                                   \
  do {                                                       \
    cudaError_t lsx_err_ = cudaGetLastError();               \
    if (lsx_err_ != cudaSuccess) return (int)lsx_err_;       \
  } while (0)

namespace lsx {

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Inclusive scan of one value per thread over a block of THREADS threads
// (a multiple of 32, at most 1024). Every thread of the block must call
// it. ``warp_sums`` is shared scratch of THREADS / 32 entries; it is free
// again when the call returns.
template <int THREADS>
__device__ __forceinline__ unsigned block_inclusive_scan(unsigned v,
                                                         unsigned* warp_sums) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < NW ? warp_sums[lane] : 0u;
    w = warp_inclusive_scan(w);
    if (lane < NW) warp_sums[lane] = w;
  }
  __syncthreads();
  unsigned out = incl + (warp > 0 ? warp_sums[warp - 1] : 0u);
  __syncthreads();
  return out;
}

constexpr int SCAN_THREADS = 1024;

// In-place exclusive scan of data[0, n) by ONE block: each thread sums a
// contiguous segment, the block scans the segment sums, then each thread
// rewrites its segment with running offsets. Writes the grand total to
// *total when total is non-null. n is at most a few hundred thousand
// here, so one block is enough and no cross-block ordering is involved.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
exclusive_scan_one_block(unsigned* data, int n, unsigned* total) {
  __shared__ unsigned warp_sums[THREADS / 32];
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += data[i];
  const unsigned incl = block_inclusive_scan<THREADS>(s, warp_sums);
  unsigned run = incl - s;
  for (int i = lo; i < hi; ++i) {
    const unsigned v = data[i];
    data[i] = run;
    run += v;
  }
  if (total != nullptr && threadIdx.x == THREADS - 1) *total = incl;
}

}  // namespace lsx
