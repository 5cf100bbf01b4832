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
//   dop = dalpha e, dpower = dop op = dalpha alpha (zero where op e >= 0.99)
//   d(x, y, a, b, c) = dpower * d(power)/d(.) at (dx, dy) from the tile
//   centre, dch_c = g_c w, and the two densification rows
//   |dpower d(power)/dx|, |dpower d(power)/dy| summed over pixels.
// The suffix is formed as total minus prefix, exactly as the TPU kernel
// does, so the rounding follows the reference.
//
// Output: grad [n_splats, 8 + C] rows (dx, dy, da, db, dc, dop, dch[C],
// abs_x, abs_y) summed over every pair of the splat — the per-splat
// reduction the JAX package leaves to the VJP of its payload gather.
//
// Bound on the H100: issue. Per (pair, pixel) evaluation the recurrence
// of K1 (FP32 and SFU), and per pair the reduction of 8 + C sums over the
// tile's pixels. Reduced across lanes, one warp butterfly per value and
// pair (the first port's design), that reduction took 110 shuffles and 22
// shared atomics per pair and warp, most of K2's time. The TPU kernel
// forms the same sums as products over the tile's pixels; so does this
// design, in FP32 FMAs:
//   1. the walk, one thread per pixel, runs K1's step over a batch of 16
//      pairs and writes each (pair, pixel)'s w and dop into shared memory
//      (zeros where the pair is not included), and one ballot per pair and
//      warp records which pixels included it;
//   2. the products, one thread per (pair, 16-pixel slice): each thread
//      sums its pair's 8 + C values over its slice's pixels from shared
//      memory (dch_c += w g_c against the tile's g staged once; the
//      geometry and abs rows from dpower and the pixel's offset, as the
//      plain version forms them), skipping slices that no pixel of the
//      pair included; the 16 slices of a pair then meet in one
//      transposing reduction (15 shuffles for 16 sums, 30 for 32), after
//      which each lane holds one or two of the pair's sums and adds them
//      into the splat's row with global float atomics.
// The moments of dpower over the pixel basis, as the TPU kernel takes
// them, would cost as many FMAs here (the abs rows need the per-pixel
// pass anyway) and cancel for splats far from the tile; the direct form
// keeps the plain version's rounding. A slice reads its pixels rotated by
// its index, so the 16 slices of a pair hit 16 banks.
//
// Blocks are decoupled from the tile: a block of 256 threads takes one
// 256-pixel part of a tile (pixels flattened y-major; pixels past a
// smaller tile sit idle) and walks the tile's whole list with its own
// early exit, so a 32x32 tile is four blocks, 1,380
// blocks fill 132 SMs four deep, and a part whose pixels are all done
// leaves while the others go on. Pair rows arrive by cp.async one batch
// ahead (lsx::PairPipe, shared with K1). The values, g and the staging
// take 50 KB of dynamic shared memory at C = 14; 64 registers a thread
// (__launch_bounds__(256, 4)) hold the walk's state and the products'
// 8 + C sums without a spill, C rounded up to four (a template parameter:
// a predicated FMA of an absent channel still issues). Float atomics make
// the summation order vary from run to run, so the result is reproducible
// to rounding, not bit for bit; the tolerances that hold it against the
// plain version say so.
#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace {

using lsx::BLEND_GEOM;
using lsx::BLEND_MAX_CH;
using lsx::BLEND_MAX_ROW;

constexpr int BATCH = 16;       // pairs per batch
constexpr int SLICE = 16;       // pixels per product task
constexpr int PART = lsx::BLEND_PART;
constexpr int MAX_PIX = 1024;
constexpr unsigned FULL = 0xffffffffu;

// One level of the transposing reduction over the lanes that differ in
// bit h: a lane keeps the half of its N slots that its bit selects, summed
// with its partner's.
template <int N>
__device__ __forceinline__ void transpose_level(float* v, int si, int h) {
  const bool up = (si & h) != 0;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = up ? v[j] : v[j + N / 2];
    const float keep = up ? v[j + N / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, h);
  }
}

struct Shared {
  lsx::PairStage<BATCH> stage;
  unsigned hit[BATCH][PART / 32];   // per pair and warp: pixels included
  float2 val[BATCH][PART];          // per pair and pixel: (w, dop)
  float2 v[PART];                   // pixel offset from the tile centre
  float g[1];                       // [n_ch][PART] upstream gradient
};

__host__ __device__ constexpr size_t shared_bytes(int n_ch) {
  return sizeof(Shared) + sizeof(float) * ((size_t)n_ch * PART);
}

template <int NCH>
__global__ void __launch_bounds__(PART, 4)
blend_backward(const int* __restrict__ point_list,
               const int* __restrict__ tile_starts,
               const int* __restrict__ tile_counts,
               const float* __restrict__ payload,
               const float* __restrict__ accum,
               const float* __restrict__ final_T,
               const float* __restrict__ g_accum,
               const float* __restrict__ g_T, float* __restrict__ grad,
               int grid_x, int tile_w, int tile_h, int n_parts, int n_ch,
               int row_stride, int n_splats) {
  constexpr int N_OUT = BLEND_GEOM + NCH + 2;   // the row's sums
  extern __shared__ float4 smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.x / n_parts;
  const int npx = tile_w * tile_h;
  const int p = (blockIdx.x - t * n_parts) * PART + tid;   // pixel in tile
  const bool active = p < npx;
  const int out_stride = BLEND_GEOM + n_ch + 2;
  const float tile_cx = (float)((t % grid_x) * tile_w + tile_w / 2);
  const float tile_cy = (float)((t / grid_x) * tile_h + tile_h / 2);
  const float vx = (float)(p % tile_w) - (float)(tile_w / 2);
  const float vy = (float)(p / tile_w) - (float)(tile_h / 2);
  sm.v[tid] = make_float2(vx, vy);

  // the pixel's upstream gradient (staged for the products) and
  // tot = sum_c acc_c g_c
  float tot = 0.0f, tail = 0.0f;
  const size_t cbase = (size_t)t * n_ch * npx + p;
  for (int c = 0; c < n_ch; ++c) {
    const float gc = active ? g_accum[cbase + (size_t)c * npx] : 0.0f;
    sm.g[c * PART + tid] = gc;
    if (active) tot += accum[cbase + (size_t)c * npx] * gc;
  }
  if (active) tail = final_T[(size_t)t * npx + p] * g_T[(size_t)t * npx + p];
  float log_t = 0.0f;
  float prefix = 0.0f;
  int done = active ? 0 : 1;

  const lsx::PairPipe<BATCH> pipe{sm.stage, point_list, payload,
                                  tile_starts[t], tile_counts[t],
                                  row_stride, n_splats};
  pipe.prologue();
  // the product task of this thread: pair ti of the batch, slice si
  const int ti = tid / SLICE;
  const int si = tid % SLICE;
  const int nb_all = pipe.batches();

  for (int k = 0; k < nb_all; ++k) {
    lsx::cp_async_wait_all();
    // barrier: batch k's rows and k + 1's ids have landed, the
    // products of batch k - 1 are done; and the part's early exit
    if (__syncthreads_count(done) == PART) break;
    pipe.ahead(k);
    const int nb = pipe.size(k);
    const float* rows = sm.stage.row[k & 1];
    // the walk's copy of the pixel's g, for chg (loaded per batch, so no
    // register holds it through the products)
    float g[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) g[c] = c < n_ch ? sm.g[c * PART + tid] : 0.0f;

    // ---- 1. the walk: K1's step, (w, dop) per pair and pixel ----------
    for (int i = 0; i < nb; ++i) {
      if (__all_sync(FULL, done)) {                 // warp-uniform
        for (int j = i + lane; j < nb; j += 32) sm.hit[j][warp] = 0u;
        break;
      }
      const float* row = &rows[i * BLEND_MAX_ROW];
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
      float w = 0.0f, dop = 0.0f;
      if (inc) {
        w = s.alpha * t_excl;
        float chg = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (c < n_ch) chg += row[BLEND_GEOM + c] * g[c];
        }
        prefix += w * chg;
        const float suffix = tot - prefix;
        // the fast division (about 2 ulp) decides nothing: the gates and
        // the stop are K1's, bit for bit
        const float dalpha =
            t_excl * chg -
            __fdividef(suffix + tail, fmaxf(1.0f - s.alpha, 1e-6f));
        if (s.ealpha < lsx::BLEND_ALPHA_MAX) dop = dalpha * s.e;
      }
      sm.val[i][tid] = make_float2(w, dop);
      const unsigned m = __ballot_sync(FULL, inc);
      if (lane == 0) sm.hit[i][warp] = m;
    }
    __syncthreads();

    // ---- 2. the products: pair ti's sums over slice si ---------------
    float acc[N_OUT];
#pragma unroll
    for (int j = 0; j < N_OUT; ++j) acc[j] = 0.0f;
    const int s0 = si * SLICE;
    const unsigned hits =
        ti < nb ? (sm.hit[ti][s0 >> 5] >> (s0 & 31)) & 0xffffu : 0u;
    if (hits) {
      const float* row = &rows[ti * BLEND_MAX_ROW];
      const float x0 = __fsub_rn(row[0], tile_cx);
      const float y0 = __fsub_rn(row[1], tile_cy);
      const float a = row[2], b = row[3], c = row[4], op = row[5];
      for (int kk = 0; kk < SLICE; ++kk) {
        const int q = s0 + ((kk + si) & (SLICE - 1));
        const float2 wd = sm.val[ti][q];
        const float2 v = sm.v[q];
        const float dx = __fsub_rn(x0, v.x);
        const float dy = __fsub_rn(y0, v.y);
        const float dpower = wd.y * op;
        const float gx = dpower * -(a * dx + b * dy);
        const float gy = dpower * -(c * dy + b * dx);
        acc[0] += gx;
        acc[1] += gy;
        acc[2] += dpower * (-0.5f * dx * dx);
        acc[3] += dpower * -(dx * dy);
        acc[4] += dpower * (-0.5f * dy * dy);
        acc[5] += wd.y;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          if (ch < n_ch) acc[BLEND_GEOM + ch] += wd.x * sm.g[ch * PART + q];
        }
        acc[N_OUT - 2] += fabsf(gx);
        acc[N_OUT - 1] += fabsf(gy);
      }
    }
    if (!__any_sync(FULL, hits != 0u)) continue;   // warp-uniform
    const int sid = ti < nb ? sm.stage.sid[k % 3][ti] : n_splats;
    float* out = grad + (size_t)sid * out_stride;
    // slot j of a pair's row: its column, or -1 for an absent channel
    auto column = [&](int j) {
      return j < BLEND_GEOM + n_ch ? j
             : j == N_OUT - 2     ? out_stride - 2
             : j == N_OUT - 1     ? out_stride - 1 : -1;
    };
    // the 16 slices of a pair meet in one transposing reduction of V
    // slots: at the level of h a lane keeps the half of its slots that its
    // bit h selects, summed with its partner's, so lane si ends with slots
    // si * V / 16 + j (15 V / 16 shuffles, not 4 N_OUT)
    constexpr int V = (N_OUT + SLICE - 1) / SLICE * SLICE;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < N_OUT ? acc[j] : 0.0f;
    transpose_level<V>(v, si, 8);
    transpose_level<V / 2>(v, si, 4);
    transpose_level<V / 4>(v, si, 2);
    transpose_level<V / 8>(v, si, 1);
    if (sid < n_splats) {
#pragma unroll
      for (int j = 0; j < V / SLICE; ++j) {
        const int col = column(si * (V / SLICE) + j);
        if (col >= 0 && v[j] != 0.0f) atomicAdd(out + col, v[j]);
      }
    }
  }
}

// Raises an instance's dynamic shared-memory limit to what its channels
// take, once per device (a bit per device), not on every launch.
template <int NCH>
cudaError_t allow_shared() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(blend_backward<NCH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shared_bytes(NCH));
  if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return e;
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
  const int n_parts = (npx + PART - 1) / PART;
  const auto prepare = lsx::by_channels(n_ch, allow_shared<4>,
                                        allow_shared<8>, allow_shared<12>,
                                        allow_shared<16>);
  e = prepare();
  if (e != cudaSuccess) return (int)e;
  const auto kernel = lsx::by_channels(n_ch, blend_backward<4>,
                                       blend_backward<8>, blend_backward<12>,
                                       blend_backward<16>);
  kernel<<<n_tiles * n_parts, PART, shared_bytes(n_ch), stream>>>(
      point_list, tile_starts, tile_counts, payload, accum, final_T, g_accum,
      g_T, grad, grid_x, tile_w, tile_h, n_parts, n_ch, row_stride,
      n_splats);
  LSX_CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
