// Stable LSD radix sort of int32 (key, value) pairs by key.
//
// Replaces: langscenex_tpu/ops/sort_engine.py:_local_kernel and
// :_cross_kernel (the TPU bitonic network, run through
// bitonic_sort_pairs). Contract: identical to a stable
// lax.sort((key, value), num_keys=1) — equal keys keep their input order,
// which gives the depth permutation its tie-break by splat id for free.
// Keys are ordered as signed int32 (the sign bit is flipped in the top
// digit), so the slice's non-negative keys — tile << 22 | rank, bitcast
// positive-f32 depths with +inf = 0x7f800000, pad 2^31 - 1 — need no
// special casing and a negative key still sorts correctly.
//
// Bound on the H100: memory traffic. Four 8-bit digit passes each read
// the keys twice (histogram, scatter), the values once and write both;
// at the slice's 520k pairs that is ~4 x 12 B x 520k = 25 MB, a few
// microseconds of HBM time, so launch count and the scatter's scattered
// writes dominate.
//
// Design: per pass three kernels — (1) per-block 256-bin digit histogram
// in shared memory, written digit-major [digit][block]; (2) one-block
// exclusive scan of that table, so block b's digit d starts after every
// smaller digit and after digit d of blocks < b; (3) a stable scatter in
// which each block walks its 2048-element tile in 256-element chunks in
// order and ranks equal digits with __match_any_sync inside a warp plus a
// per-digit prefix over the block's 8 warps. Nothing depends on the order
// in which blocks run. No wgmma/TMA: later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int SORT_THREADS = 256;
constexpr int SORT_ITEMS = 8;
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;
constexpr int RADIX = 256;
constexpr int NUM_PASSES = 4;
static_assert(SORT_THREADS == RADIX, "one thread per digit bin");

__device__ __forceinline__ unsigned digit_of(int key, int shift) {
  const unsigned u = static_cast<unsigned>(key) ^ 0x80000000u;
  return (u >> shift) & (RADIX - 1);
}

__global__ void __launch_bounds__(SORT_THREADS)
radix_histogram(const int* __restrict__ keys, int n, int shift, int n_blocks,
                unsigned* __restrict__ hist) {
  __shared__ unsigned h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * SORT_TILE;
  for (int i = threadIdx.x; i < SORT_TILE; i += SORT_THREADS) {
    const int idx = base + i;
    if (idx < n) atomicAdd(&h[digit_of(keys[idx], shift)], 1u);
  }
  __syncthreads();
  hist[threadIdx.x * n_blocks + blockIdx.x] = h[threadIdx.x];
}

__global__ void __launch_bounds__(SORT_THREADS)
radix_scatter(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
              int* __restrict__ keys_out, int* __restrict__ vals_out, int n,
              int shift, int n_blocks, const unsigned* __restrict__ offsets) {
  constexpr int NW = SORT_THREADS / 32;
  __shared__ unsigned cursor[RADIX];        // next output slot per digit
  __shared__ unsigned warp_cnt[NW][RADIX];  // per-warp digit counts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  cursor[threadIdx.x] = offsets[threadIdx.x * n_blocks + blockIdx.x];
  const int tile0 = blockIdx.x * SORT_TILE;

  for (int c = 0; c < SORT_ITEMS; ++c) {
#pragma unroll
    for (int w = 0; w < NW; ++w) warp_cnt[w][threadIdx.x] = 0u;
    __syncthreads();

    const int idx = tile0 + c * SORT_THREADS + threadIdx.x;
    const bool valid = idx < n;
    const int key = valid ? keys_in[idx] : 0;
    const int val = valid ? vals_in[idx] : 0;
    const unsigned d = valid ? digit_of(key, shift) : (unsigned)RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & lanemask_lt);
    if (valid && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();

    // thread t owns digit t: exclusive prefix over the warps, chunk total
    unsigned chunk_total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned v = warp_cnt[w][threadIdx.x];
      warp_cnt[w][threadIdx.x] = chunk_total;
      chunk_total += v;
    }
    __syncthreads();

    if (valid) {
      const unsigned pos = cursor[d] + warp_cnt[warp][d] + rank;
      keys_out[pos] = key;
      vals_out[pos] = val;
    }
    __syncthreads();
    cursor[threadIdx.x] += chunk_total;
  }
}

}  // namespace

extern "C" const char* lsx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sorts (keys_in, vals_in)[0, n) into (keys_out, vals_out). The inputs are
// not modified; keys_tmp/vals_tmp are [n] scratch and hist is
// [256 * n_blocks] scratch, n_blocks = ceil(n / 2048).
extern "C" int lsx_sort_pairs(const int* keys_in, const int* vals_in,
                              int* keys_out, int* vals_out, int* keys_tmp,
                              int* vals_tmp, unsigned* hist, int n,
                              int n_blocks, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int* src_k = keys_in;
  const int* src_v = vals_in;
  for (int pass = 0; pass < NUM_PASSES; ++pass) {
    const int shift = pass * 8;
    // even passes land in tmp, odd passes in out: pass 3 ends in out
    int* dst_k = (pass % 2 == 0) ? keys_tmp : keys_out;
    int* dst_v = (pass % 2 == 0) ? vals_tmp : vals_out;
    radix_histogram<<<n_blocks, SORT_THREADS, 0, stream>>>(src_k, n, shift,
                                                           n_blocks, hist);
    LSX_CHECK_LAUNCH();
    lsx::exclusive_scan_one_block<lsx::SCAN_THREADS>
        <<<1, lsx::SCAN_THREADS, 0, stream>>>(hist, RADIX * n_blocks,
                                              nullptr);
    LSX_CHECK_LAUNCH();
    radix_scatter<<<n_blocks, SORT_THREADS, 0, stream>>>(
        src_k, src_v, dst_k, dst_v, n, shift, n_blocks, hist);
    LSX_CHECK_LAUNCH();
    src_k = dst_k;
    src_v = dst_v;
  }
  return (int)cudaGetLastError();
}
