// Per-tile front-to-back alpha blend (forward, K1).
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
// Bound on the H100: issue, not memory. A tile's pairs are read once from
// HBM (22 floats each) and reused by all its pixels from shared memory;
// per (pair, pixel) evaluation the step issues the power's FMAs and an
// exp, per gated one a log1p, per included one an exp of log T and the C
// channel FMAs (chip_smoke.blend_bound counts them from the inputs).
//
// Design: K2's block decomposition. A block of 256 threads, one per
// pixel, takes a 256-pixel part of a tile (pixels flattened y-major,
// p = y * tile_w + x; pixels past a smaller tile sit idle) and walks the
// tile's whole list with its own early exit (__syncthreads_count of done
// pixels), so a 32x32 tile is four blocks and the longest tiles no longer hold a
// 1,024-thread block to the end of their slowest warp. Pairs are staged
// 128 at a time by cp.async one batch ahead of the walk (lsx::PairPipe:
// ids and 22-float rows gathered from the per-splat payload, so no
// per-pair payload is built in HBM). Each thread walks the batch
// sequentially with its log T in a register; channel accumulators stay in
// registers (64 a thread at four blocks an SM, no spill), as many as the
// channels rounded up to four (a template parameter: a predicated FMA of
// an absent channel still issues). Every lane steps through every pair of
// the batch until its warp is done, so the warp reconverges at each pair:
// with lanes leaving the loop at their own stop, the warp's lanes drifted
// apart and the walk took nine times as long. observe is
// counted per batch in shared memory with integer atomics and flushed with
// one global integer atomicAdd per pair and part — integer sums are
// order-free, so observe is exact. The per-pixel step is lsx::blend_power,
// blend_alpha and blend_log_t_next (common.cuh), which the backward
// (blend_backward.cu) re-runs bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using lsx::BLEND_GEOM;
using lsx::BLEND_MAX_CH;
using lsx::BLEND_MAX_ROW;

constexpr int BATCH = 128;
constexpr int MAX_PIX = 1024;
constexpr unsigned FULL = 0xffffffffu;

template <int NCH>
__global__ void __launch_bounds__(lsx::BLEND_PART, 4)
blend_forward(const int* __restrict__ point_list,
              const int* __restrict__ tile_starts,
              const int* __restrict__ tile_counts,
              const float* __restrict__ payload, float* __restrict__ accum,
              float* __restrict__ final_T, int* __restrict__ observe,
              int grid_x, int tile_w, int tile_h, int n_parts, int n_ch,
              int row_stride, int n_splats) {
  __shared__ lsx::PairStage<BATCH> stage;
  __shared__ int s_obs[BATCH];

  constexpr int nt = lsx::BLEND_PART;
  const int tid = threadIdx.x;
  const int t = blockIdx.x / n_parts;
  const int npx = tile_w * tile_h;
  const int p = (blockIdx.x - t * n_parts) * nt + tid;   // pixel in tile
  const bool active = p < npx;
  const float tile_cx = (float)((t % grid_x) * tile_w + tile_w / 2);
  const float tile_cy = (float)((t / grid_x) * tile_h + tile_h / 2);
  const float vx = (float)(p % tile_w) - (float)(tile_w / 2);
  const float vy = (float)(p / tile_w) - (float)(tile_h / 2);

  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  float log_t = 0.0f;
  int done = active ? 0 : 1;
  for (int i = tid; i < BATCH; i += nt) s_obs[i] = 0;

  const lsx::PairPipe<BATCH> pipe{stage, point_list, payload,
                                  tile_starts[t], tile_counts[t],
                                  row_stride, n_splats};
  pipe.prologue();
  const int nb_all = pipe.batches();
  for (int k = 0; k < nb_all; ++k) {
    lsx::cp_async_wait_all();
    // barrier: batch k's rows and k + 1's ids have landed, the
    // previous batch's observe flush is done; and the part's early exit
    if (__syncthreads_count(done) == nt) break;
    pipe.ahead(k);
    const int nb = pipe.size(k);
    const float* rows = stage.row[k & 1];
    // the walk: every lane steps through every pair until its whole warp
    // is done, so the warp reconverges at each pair (a lane that left the
    // loop at its own pair would let the warp's lanes drift apart, each
    // group walking on alone)
    for (int i = 0; i < nb; ++i) {
      if (__all_sync(FULL, done)) break;            // warp-uniform
      const float* row = &rows[i * BLEND_MAX_ROW];
      do {  // the per-pixel step; K2 runs it as written here
        if (done) break;
        lsx::BlendSample s;
        const float power =
            lsx::blend_power(row, tile_cx, tile_cy, vx, vy, s);
        if (power > 0.0f) break;
        lsx::blend_alpha(row[5], power, s);
        if (s.alpha < lsx::BLEND_ALPHA_MIN) break;
        const float next = lsx::blend_log_t_next(log_t, s.alpha);
        if (next < lsx::BLEND_LOG_T_EPS) {
          done = 1;
          break;
        }
        const float t_excl = expf(log_t);
        log_t = next;
        const float w = s.alpha * t_excl;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          if (ch < n_ch) acc[ch] += w * row[BLEND_GEOM + ch];
        }
        if (t_excl > 0.5f) atomicAdd(&s_obs[i], 1);
      } while (false);
    }
    __syncthreads();
    const int* sid = stage.sid[k % 3];
    for (int i = tid; i < nb; i += nt) {
      if (s_obs[i] != 0 && sid[i] < n_splats) {
        atomicAdd(&observe[sid[i]], s_obs[i]);
      }
      s_obs[i] = 0;
    }
  }

  if (!active) return;
  const size_t base = (size_t)t * n_ch * npx;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
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
  const int n_parts = (npx + lsx::BLEND_PART - 1) / lsx::BLEND_PART;
  const auto kernel = lsx::by_channels(n_ch, blend_forward<4>,
                                       blend_forward<8>, blend_forward<12>,
                                       blend_forward<16>);
  kernel<<<n_tiles * n_parts, lsx::BLEND_PART, 0, stream>>>(
      point_list, tile_starts, tile_counts, payload, accum, final_T, observe,
      grid_x, tile_w, tile_h, n_parts, n_ch, row_stride, n_splats);
  LSX_CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
