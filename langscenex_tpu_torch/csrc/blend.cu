// Per-tile front-to-back alpha blend (forward).
//
// Replaces: langscenex_tpu/ops/rasterize_pallas.py:_fwd_kernel (reached via
// _blend_fwd_impl, blend_pairs and blend_tiles_pallas). Same semantics:
// for each pixel of a tile, walk the tile's depth-sorted pairs front to
// back; power = -1/2 (a dx^2 + c dy^2) - b dx dy, alpha = min(0.99,
// op e^power); skip power > 0 or alpha < 1/255; in log space, the pair
// whose log T + log1p(-alpha) drops below log 1e-4 sets the pixel done
// and is excluded (sticky), otherwise it is included with weight
// alpha T and log T advances. Up to 16 channels accumulate; observe[sid]
// counts, per splat, the pixels where the pair was included with
// T_excl > 0.5. dx, dy are taken relative to the tile centre as in the
// TPU kernel (f32 cancellation at global pixel coordinates).
//
// Bound on the H100: the per-pixel exp/log1p/exp chain and the 16 FMAs
// per (pair, pixel), i.e. SFU and FP32 issue, not memory — a tile's pairs
// are read once from HBM (22 floats each) and reused by all 1,024 pixels
// from shared memory.
//
// Design: one block per tile, one thread per pixel (tile_w * tile_h <=
// 1024 threads, pixels flattened y-major p = y * tile_w + x). The tile's
// pairs are staged 256 at a time into shared memory (~23 KB: sid and a
// 22-float row gathered from the per-splat payload, so no per-pair
// payload is built in HBM). Each thread walks the batch sequentially with
// its T in a register; the block exits early once __syncthreads_count of
// done pixels reaches the tile size. observe is counted per batch in
// shared memory with integer atomics and flushed with one global integer
// atomicAdd per pair — integer sums are order-free, so observe is exact.
// Channel accumulators stay in registers. No wgmma/TMA: later work. The
// per-pixel step is lsx::blend_power, blend_alpha and blend_log_t_next
// (common.cuh), which the backward (blend_backward.cu) re-runs bit for
// bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using lsx::BLEND_GEOM;
using lsx::BLEND_MAX_CH;
using lsx::BLEND_MAX_ROW;

constexpr int BATCH = 256;
constexpr int MAX_PIX = 1024;

__global__ void __launch_bounds__(MAX_PIX)
blend_forward(const int* __restrict__ point_list,
              const int* __restrict__ tile_starts,
              const int* __restrict__ tile_counts,
              const float* __restrict__ payload, float* __restrict__ accum,
              float* __restrict__ final_T, int* __restrict__ observe,
              int grid_x, int tile_w, int tile_h, int n_ch, int row_stride,
              int n_splats) {
  __shared__ float s_row[BATCH * BLEND_MAX_ROW];
  __shared__ int s_sid[BATCH];
  __shared__ int s_obs[BATCH];

  const int t = blockIdx.x;
  const int npx = tile_w * tile_h;
  const int p = threadIdx.x;
  const int start = tile_starts[t];
  const int count = tile_counts[t];
  const float tile_cx = (float)((t % grid_x) * tile_w + tile_w / 2);
  const float tile_cy = (float)((t / grid_x) * tile_h + tile_h / 2);
  const float vx = (float)(p % tile_w) - (float)(tile_w / 2);
  const float vy = (float)(p / tile_w) - (float)(tile_h / 2);

  float acc[BLEND_MAX_CH];
#pragma unroll
  for (int c = 0; c < BLEND_MAX_CH; ++c) acc[c] = 0.0f;
  float log_t = 0.0f;
  int done = 0;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    // barrier: every pixel finished the previous batch (and its observe
    // flush), and the whole-tile early exit
    if (__syncthreads_count(done) == npx) break;
    const int nb = min(BATCH, count - b0);
    for (int i = p; i < nb; i += npx) s_obs[i] = 0;
    lsx::stage_rows(point_list, start + b0, nb, payload, row_stride,
                    n_splats, s_sid, s_row);
    __syncthreads();

    if (!done) {
      for (int i = 0; i < nb; ++i) {
        const float* row = &s_row[i * BLEND_MAX_ROW];
        lsx::BlendSample s;
        const float power =
            lsx::blend_power(row, tile_cx, tile_cy, vx, vy, s);
        if (power > 0.0f) continue;
        lsx::blend_alpha(row[5], power, s);
        if (s.alpha < lsx::BLEND_ALPHA_MIN) continue;
        const float next = lsx::blend_log_t_next(log_t, s.alpha);
        if (next < lsx::BLEND_LOG_T_EPS) {
          done = 1;
          break;
        }
        const float t_excl = expf(log_t);
        log_t = next;
        const float w = s.alpha * t_excl;
#pragma unroll
        for (int ch = 0; ch < BLEND_MAX_CH; ++ch) {
          if (ch < n_ch) acc[ch] += w * row[BLEND_GEOM + ch];
        }
        if (t_excl > 0.5f) atomicAdd(&s_obs[i], 1);
      }
    }
    __syncthreads();
    for (int i = p; i < nb; i += npx) {
      if (s_obs[i] != 0 && s_sid[i] < n_splats) {
        atomicAdd(&observe[s_sid[i]], s_obs[i]);
      }
    }
  }

  const size_t base = (size_t)t * n_ch * npx;
#pragma unroll
  for (int ch = 0; ch < BLEND_MAX_CH; ++ch) {
    if (ch < n_ch) accum[base + (size_t)ch * npx + p] = acc[ch];
  }
  final_T[(size_t)t * npx + p] = expf(log_t);
}

}  // namespace

// point_list: [L] splat ids in (tile, depth) order; tile_starts/counts:
// [n_tiles]; payload: [n_splats, row_stride] rows (x, y, a, b, c, opacity,
// n_ch channels), row_stride = 6 + n_ch <= 22. Outputs: accum [n_tiles,
// n_ch, tile_w * tile_h], final_T [n_tiles, tile_w * tile_h], observe
// [n_splats] (zeroed here).
extern "C" int lsx_blend_forward(const int* point_list, const int* tile_starts,
                                 const int* tile_counts, const float* payload,
                                 float* accum, float* final_T, int* observe,
                                 int n_tiles, int grid_x, int tile_w,
                                 int tile_h, int n_ch, int row_stride,
                                 int n_splats, cudaStream_t stream) {
  const int npx = tile_w * tile_h;
  if (npx <= 0 || npx > MAX_PIX || n_ch < 0 || n_ch > BLEND_MAX_CH ||
      row_stride != BLEND_GEOM + n_ch) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaMemsetAsync(observe, 0, sizeof(int) * (size_t)n_splats,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  if (n_tiles <= 0) return 0;
  blend_forward<<<n_tiles, npx, 0, stream>>>(
      point_list, tile_starts, tile_counts, payload, accum, final_T, observe,
      grid_x, tile_w, tile_h, n_ch, row_stride, n_splats);
  LSX_CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
