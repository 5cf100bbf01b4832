// Per-tile front-to-back alpha blend, backward (K2).
//
// Replaces: langscenex_tpu/ops/rasterize_pallas.py:_bwd_kernel (reached via
// _blend_bwd_impl and the custom VJP's _bp_bwd of blend_pairs). Same
// semantics: for each pixel of a tile, re-walk the tile's depth-sorted
// pairs in FORWARD order with the forward's recurrence (lsx::blend_power,
// blend_alpha and blend_log_t_next, shared with K1, so inclusion and the
// sticky T < 1e-4 stop are decided bit for bit as the forward decided
// them) and, per included pair, with g the upstream gradient of the
// pixel's channels and g_T that of its final T:
//   chg = sum_c ch_c g_c,   contrib = w chg,   w = alpha T_excl
//   suffix = tot - inclusive prefix of contrib,  tot = sum_c acc_c g_c
//   dalpha = T_excl chg - (suffix + T_final g_T) / max(1 - alpha, 1e-6)
//   dpower = dalpha alpha, dop = dalpha e      (zero where op e >= 0.99)
//   d(x, y, a, b, c) = dpower * d(power)/d(.) at (dx, dy) from the tile
//   centre, dch_c = g_c w, and the two densification rows
//   |dpower d(power)/dx|, |dpower d(power)/dy| summed over pixels.
// The suffix is formed as total minus prefix, exactly as the TPU kernel
// does, so the rounding follows the reference; a back-to-front walk would
// need a per-pixel last-contributor index from K1 and round differently.
//
// Output: grad [n_splats, 8 + C] rows (dx, dy, da, db, dc, dop, dch[C],
// abs_x, abs_y) summed over every pair of the splat — the per-splat
// reduction the JAX package leaves to the VJP of its payload gather.
//
// Bound on the H100: the per-(pair, pixel) recurrence (SFU exp/log1p/exp,
// as in K1) plus the per-pair reduction of up to 24 sums over the tile's
// pixels. Design: one block per tile and one thread per pixel, like K1;
// pairs are staged 128 at a time in shared memory. For each pair a warp
// whose pixels include none of it skips the pair (__any_sync), otherwise
// it reduces each value with a butterfly of shuffles and lane 0 adds the
// warp's sum into the pair's shared row with a shared-memory atomic; a
// warp whose pixels are all done leaves the batch. After the batch each
// pair's row is added into the splat's output row with global float
// atomics. Float atomics make the summation order vary from run to run,
// so the result is reproducible to rounding, not bit for bit; the
// tolerances that hold it against the plain version say so. No wgmma/TMA:
// later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using lsx::BLEND_GEOM;
using lsx::BLEND_MAX_CH;
using lsx::BLEND_MAX_ROW;

constexpr int BATCH = 128;
constexpr int MAX_PIX = 1024;
constexpr int OUT_MAX = BLEND_MAX_ROW + 2;  // 6 geometry + 16 ch + 2 abs
constexpr unsigned FULL = 0xffffffffu;

// Warp sum of v; lane 0 adds it to *dst (skipped when it is zero).
__device__ __forceinline__ void warp_add(float v, float* dst, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0 && v != 0.0f) atomicAdd(dst, v);
}

__global__ void __launch_bounds__(MAX_PIX)
blend_backward(const int* __restrict__ point_list,
               const int* __restrict__ tile_starts,
               const int* __restrict__ tile_counts,
               const float* __restrict__ payload,
               const float* __restrict__ accum,
               const float* __restrict__ final_T,
               const float* __restrict__ g_accum,
               const float* __restrict__ g_T, float* __restrict__ grad,
               int grid_x, int tile_w, int tile_h, int n_ch, int row_stride,
               int n_splats) {
  __shared__ float s_row[BATCH * BLEND_MAX_ROW];
  __shared__ int s_sid[BATCH];
  __shared__ float s_grad[BATCH * OUT_MAX];

  const int t = blockIdx.x;
  const int npx = tile_w * tile_h;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int out_stride = BLEND_GEOM + n_ch + 2;
  const int start = tile_starts[t];
  const int count = tile_counts[t];
  const float tile_cx = (float)((t % grid_x) * tile_w + tile_w / 2);
  const float tile_cy = (float)((t / grid_x) * tile_h + tile_h / 2);
  const float vx = (float)(p % tile_w) - (float)(tile_w / 2);
  const float vy = (float)(p / tile_w) - (float)(tile_h / 2);

  // the pixel's upstream gradient and tot = sum_c acc_c g_c
  const size_t pix = (size_t)t * npx + p;
  const size_t cbase = (size_t)t * n_ch * npx + p;
  float g[BLEND_MAX_CH];
  float tot = 0.0f;
#pragma unroll
  for (int c = 0; c < BLEND_MAX_CH; ++c) {
    g[c] = 0.0f;
    if (c < n_ch) {
      g[c] = g_accum[cbase + (size_t)c * npx];
      tot += accum[cbase + (size_t)c * npx] * g[c];
    }
  }
  const float tail = final_T[pix] * g_T[pix];
  float log_t = 0.0f;
  float prefix = 0.0f;
  int done = 0;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    // barrier: every warp finished the previous batch and its flush, and
    // the whole-tile early exit (as in K1)
    if (__syncthreads_count(done) == npx) break;
    const int nb = min(BATCH, count - b0);
    for (int e = p; e < nb * OUT_MAX; e += npx) s_grad[e] = 0.0f;
    lsx::stage_rows(point_list, start + b0, nb, payload, row_stride,
                    n_splats, s_sid, s_row);
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
      if (__all_sync(FULL, done)) break;          // warp-uniform
      const float* row = &s_row[i * BLEND_MAX_ROW];
      lsx::BlendSample s;
      bool inc = false;
      float t_excl = 0.0f;
      do {  // K1's step, its tests written as in K1
        if (done) break;
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
        inc = true;
        t_excl = expf(log_t);
        log_t = next;
      } while (false);
      if (!__any_sync(FULL, inc)) continue;       // warp-uniform

      float w = 0.0f, dop = 0.0f;
      float d_x = 0.0f, d_y = 0.0f, d_a = 0.0f, d_b = 0.0f, d_c = 0.0f;
      if (inc) {
        w = s.alpha * t_excl;
        float chg = 0.0f;
#pragma unroll
        for (int c = 0; c < BLEND_MAX_CH; ++c) {
          if (c < n_ch) chg += row[BLEND_GEOM + c] * g[c];
        }
        prefix += w * chg;
        const float suffix = tot - prefix;
        const float dalpha =
            t_excl * chg -
            (suffix + tail) / fmaxf(1.0f - s.alpha, 1e-6f);
        if (s.ealpha < lsx::BLEND_ALPHA_MAX) {
          const float dpower = dalpha * s.alpha;
          dop = dalpha * s.e;
          const float a = row[2], b = row[3], c = row[4];
          d_x = dpower * -(a * s.dx + b * s.dy);
          d_y = dpower * -(c * s.dy + b * s.dx);
          d_a = dpower * (-0.5f * s.dx * s.dx);
          d_b = dpower * -(s.dx * s.dy);
          d_c = dpower * (-0.5f * s.dy * s.dy);
        }
      }
      float* out = &s_grad[i * OUT_MAX];
      warp_add(d_x, out + 0, lane);
      warp_add(d_y, out + 1, lane);
      warp_add(d_a, out + 2, lane);
      warp_add(d_b, out + 3, lane);
      warp_add(d_c, out + 4, lane);
      warp_add(dop, out + 5, lane);
#pragma unroll
      for (int c = 0; c < BLEND_MAX_CH; ++c) {
        if (c < n_ch) warp_add(w * g[c], out + BLEND_GEOM + c, lane);
      }
      warp_add(fabsf(d_x), out + BLEND_GEOM + n_ch, lane);
      warp_add(fabsf(d_y), out + BLEND_GEOM + n_ch + 1, lane);
    }
    __syncthreads();
    for (int e = p; e < nb * out_stride; e += npx) {
      const int i = e / out_stride;
      const int r = e - i * out_stride;
      const float v = s_grad[i * OUT_MAX + r];
      const int sid = s_sid[i];
      if (v != 0.0f && sid < n_splats) {
        atomicAdd(&grad[(size_t)sid * out_stride + r], v);
      }
    }
  }
}

}  // namespace

// Inputs as lsx_blend_forward's, plus the forward's outputs accum [n_tiles,
// n_ch, npx] and final_T [n_tiles, npx] and their upstream gradients
// g_accum, g_T of the same shapes (npx = tile_w * tile_h, a multiple of
// 32, <= 1024). Output: grad [n_splats, 8 + n_ch] (zeroed here).
extern "C" int lsx_blend_backward(const int* point_list,
                                  const int* tile_starts,
                                  const int* tile_counts,
                                  const float* payload, const float* accum,
                                  const float* final_T, const float* g_accum,
                                  const float* g_T, float* grad, int n_tiles,
                                  int grid_x, int tile_w, int tile_h,
                                  int n_ch, int row_stride, int n_splats,
                                  cudaStream_t stream) {
  const int npx = tile_w * tile_h;
  if (npx <= 0 || npx > MAX_PIX || npx % 32 != 0 || n_ch < 0 ||
      n_ch > BLEND_MAX_CH || row_stride != BLEND_GEOM + n_ch) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t out_stride = (size_t)(BLEND_GEOM + n_ch + 2);
  cudaError_t e = cudaMemsetAsync(
      grad, 0, sizeof(float) * out_stride * (size_t)n_splats, stream);
  if (e != cudaSuccess) return (int)e;
  if (n_tiles <= 0) return 0;
  blend_backward<<<n_tiles, npx, 0, stream>>>(
      point_list, tile_starts, tile_counts, payload, accum, final_T, g_accum,
      g_T, grad, grid_x, tile_w, tile_h, n_ch, row_stride, n_splats);
  LSX_CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
