// Order-preserving stream compaction of int32 (key, sid) slots.
//
// Replaces: langscenex_tpu/ops/compaction.py:_compact_kernel (reached via
// compact_pairs). Slots with key < sent_min move to the front of the
// output in their input order; the rest of the output is filled with
// (fill_key, fill_sid). The TPU kernel's order inside a row was arbitrary
// and its overlapped output windows relied on DMA completion order; this
// version is a plain two-pass scan compaction and is order-preserving, so
// its output equals the argsort reference (compact_pairs_ref) exactly.
//
// Bound on the H100: memory traffic. The slice enumerates ~1.78M slots
// (14 MB of key+sid) of which <= 520k survive: the count pass reads the
// keys (7 MB), the scatter pass reads keys and, for valid slots, sids,
// and writes <= 4 MB, plus the sentinel tail fill — ~25 MB, under 10 us
// of HBM time, so the three launches and the one-block scan dominate.
//
// Design: (1) per 2048-slot block, count valid slots with
// __syncthreads_count; (2) one-block exclusive scan of the block counts
// (the grand total lands after the last block); (3) each block re-reads
// its slots in 256-slot chunks in order, ranks valid slots with a block
// scan and writes them at its offset; (4) a grid-stride fill writes the
// sentinel tail from the total. Writes past out_len are dropped (callers
// guarantee the valid count fits). No inter-block ordering is assumed.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int CMP_THREADS = 256;
constexpr int CMP_ITEMS = 8;
constexpr int CMP_TILE = CMP_THREADS * CMP_ITEMS;

__global__ void __launch_bounds__(CMP_THREADS)
compact_count(const int* __restrict__ key, int n, int sent_min,
              unsigned* __restrict__ counts) {
  const int base = blockIdx.x * CMP_TILE;
  unsigned total = 0;
  for (int r = 0; r < CMP_ITEMS; ++r) {
    const int idx = base + r * CMP_THREADS + threadIdx.x;
    total += __syncthreads_count(idx < n && key[idx] < sent_min);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(CMP_THREADS)
compact_scatter(const int* __restrict__ key, const int* __restrict__ sid,
                int* __restrict__ out_key, int* __restrict__ out_sid, int n,
                int out_len, int sent_min,
                const unsigned* __restrict__ offsets) {
  __shared__ unsigned warp_sums[CMP_THREADS / 32];
  unsigned run = offsets[blockIdx.x];
  const int base = blockIdx.x * CMP_TILE;
  for (int r = 0; r < CMP_ITEMS; ++r) {
    const int idx = base + r * CMP_THREADS + threadIdx.x;
    int k = 0;
    bool v = false;
    if (idx < n) {
      k = key[idx];
      v = k < sent_min;
    }
    const unsigned incl =
        lsx::block_inclusive_scan<CMP_THREADS>(v ? 1u : 0u, warp_sums);
    const unsigned pos = run + incl - (v ? 1u : 0u);
    if (v && pos < (unsigned)out_len) {
      out_key[pos] = k;
      out_sid[pos] = sid[idx];
    }
    run += __syncthreads_count(v);
  }
}

__global__ void compact_fill(int* __restrict__ out_key,
                             int* __restrict__ out_sid, int out_len,
                             const unsigned* __restrict__ total, int fill_key,
                             int fill_sid) {
  const unsigned t = *total;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < out_len;
       i += gridDim.x * blockDim.x) {
    if ((unsigned)i >= t) {
      out_key[i] = fill_key;
      out_sid[i] = fill_sid;
    }
  }
}

}  // namespace

// key/sid: [n] inputs; out_key/out_sid: [out_len] outputs; block_counts:
// [n_blocks + 1] scratch, n_blocks = ceil(n / 2048).
extern "C" int lsx_compact_pairs(const int* key, const int* sid, int* out_key,
                                 int* out_sid, unsigned* block_counts, int n,
                                 int out_len, int n_blocks, int sent_min,
                                 int fill_key, int fill_sid,
                                 cudaStream_t stream) {
  if (out_len <= 0) return 0;
  if (n > 0) {
    compact_count<<<n_blocks, CMP_THREADS, 0, stream>>>(key, n, sent_min,
                                                        block_counts);
    LSX_CHECK_LAUNCH();
    lsx::exclusive_scan_one_block<lsx::SCAN_THREADS>
        <<<1, lsx::SCAN_THREADS, 0, stream>>>(block_counts, n_blocks,
                                              block_counts + n_blocks);
    LSX_CHECK_LAUNCH();
    compact_scatter<<<n_blocks, CMP_THREADS, 0, stream>>>(
        key, sid, out_key, out_sid, n, out_len, sent_min, block_counts);
    LSX_CHECK_LAUNCH();
  } else {
    cudaError_t e = cudaMemsetAsync(block_counts, 0, sizeof(unsigned),
                                    stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int fill_blocks = min((out_len + 255) / 256, 1024);
  compact_fill<<<fill_blocks, 256, 0, stream>>>(
      out_key, out_sid, out_len, block_counts + (n > 0 ? n_blocks : 0),
      fill_key, fill_sid);
  LSX_CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
