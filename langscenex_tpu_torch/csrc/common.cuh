// Shared device helpers for the langscenex kernels: the warp and block
// scans of the radix sort (K4) and the compaction (K3), the decoupled
// look-back of the single-pass scans (K3, K15), and the per-pixel blend
// recurrence shared by the blend forward (K1) and backward (K2).
#pragma once

#include <cuda_runtime.h>

#define LSX_CHECK_LAUNCH()                                   \
  do {                                                       \
    cudaError_t lsx_err_ = cudaGetLastError();               \
    if (lsx_err_ != cudaSuccess) return (int)lsx_err_;       \
  } while (0)

namespace lsx {

// ---- the blend recurrence ---------------------------------------------
constexpr int BLEND_GEOM = 6;  // payload row: x, y, conic a, b, c, opacity
constexpr int BLEND_MAX_CH = 16;
constexpr int BLEND_MAX_ROW = BLEND_GEOM + BLEND_MAX_CH;
constexpr float BLEND_ALPHA_MAX = 0.99f;
constexpr float BLEND_ALPHA_MIN = 1.0f / 255.0f;
constexpr float BLEND_LOG_T_EPS = -9.210340371976182f;  // log(1e-4)

struct BlendSample {
  float dx, dy;    // pixel -> mean offset (tile-centre relative)
  float e;         // exp(power)
  float ealpha;    // opacity * e, before the 0.99 clamp
  float alpha;     // min(0.99, ealpha)
};

// The per-pixel recurrence of the forward (K1) and the backward (K2), in
// log space. Each (pair, pixel) runs, in both kernels:
//   power = blend_power(row, cx, cy, vx, vy, s);
//   if (power > 0) skip the pair;
//   blend_alpha(row[5], power, s);
//   if (s.alpha < BLEND_ALPHA_MIN) skip the pair;
//   next = blend_log_t_next(log_t, s.alpha);
//   if (next < BLEND_LOG_T_EPS) the pixel is done, the pair excluded;
//   else the pair is included with T_excl = exp(log_t); log_t = next.
// The tests stay in the callers' loops: returned from a helper they cost
// a reconvergence and a second branch on every (pair, pixel), most of
// which skip. The arithmetic is written with round-to-nearest intrinsics,
// the falloff with explicit FMAs, so the compiler neither fuses nor
// splits anything differently in the two kernels: the forward and the
// backward then take bit-identical decisions at the 1/255 gate and at the
// T < 1e-4 stop.

// power = -1/2 (a dx^2 + c dy^2) - b dx dy of one (pair, pixel): ``row``
// is the pair's payload row, (cx, cy) the tile centre and (vx, vy) the
// pixel's offset from it; sets s.dx, s.dy.
__device__ __forceinline__ float blend_power(const float* row, float cx,
                                             float cy, float vx, float vy,
                                             BlendSample& s) {
  s.dx = __fsub_rn(__fsub_rn(row[0], cx), vx);
  s.dy = __fsub_rn(__fsub_rn(row[1], cy), vy);
  const float q = __fmaf_rn(__fmul_rn(row[2], s.dx), s.dx,
                            __fmul_rn(__fmul_rn(row[4], s.dy), s.dy));
  return __fmaf_rn(-0.5f, q, -__fmul_rn(row[3], __fmul_rn(s.dx, s.dy)));
}

// s.e, s.ealpha and s.alpha of a pair with this opacity and power.
__device__ __forceinline__ void blend_alpha(float opacity, float power,
                                            BlendSample& s) {
  s.e = expf(power);
  s.ealpha = __fmul_rn(opacity, s.e);
  s.alpha = fminf(BLEND_ALPHA_MAX, s.ealpha);
}

// log T after a pair of this alpha is included.
__device__ __forceinline__ float blend_log_t_next(float log_t, float alpha) {
  return __fadd_rn(log_t, log1pf(-alpha));
}

// The threads of a block of K1 or K2, one per pixel of a 256-pixel part
// of a tile (the 16-pixel slices of a pair in K2 meet in xor shuffles).
// Pixels past the tile are idle.
constexpr int BLEND_PART = 256;

// K1's and K2's instance for n_ch channels: the one of the channels
// rounded up to four (4, 8, 12 or 16).
template <typename K>
inline K by_channels(int n_ch, K c4, K c8, K c12, K c16) {
  return n_ch <= 4 ? c4 : n_ch <= 8 ? c8 : n_ch <= 12 ? c12 : c16;
}

// ---- staging a tile's pairs, one batch ahead (cp.async) ---------------
// A block walks its tile's pairs in batches of BATCH. Their splat ids and
// payload rows (stride BLEND_MAX_ROW) are copied into shared memory by
// cp.async one batch ahead of the walk: the rows of batch k + 1 and the ids
// of batch k + 2 are in flight while the block works on batch k (ids in
// three buffers, rows in two). A sentinel id (>= n_splats, a pair dropped
// by the budget) stages a zero row (cp.async's zero fill), which never
// touches a pixel: its power is 0 and its alpha 0.
template <int BATCH>
struct PairStage {
  int sid[3][BATCH];
  float row[2][BATCH * BLEND_MAX_ROW];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(gmem)), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The pairs of one tile: ``first`` in the point list and ``count`` of
// them, staged by a block of blockDim.x threads. Every thread calls each
// method; the caller commits and waits (below).
template <int BATCH>
struct PairPipe {
  PairStage<BATCH>& st;
  const int* point_list;
  const float* payload;
  int first, count, row_stride, n_splats;

  __device__ int batches() const { return (count + BATCH - 1) / BATCH; }
  __device__ int size(int k) const { return min(BATCH, count - k * BATCH); }

  // issue the copies of batch k's ids
  __device__ void ids(int k) const {
    if (k >= batches()) return;
    const int nb = size(k);
    int* dst = st.sid[k % 3];
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      cp_async4(&dst[i], point_list + first + k * BATCH + i, true);
    }
  }
  // issue the copies of batch k's rows (its ids have landed): a warp
  // copies a row, one lane per float
  __device__ void rows(int k) const {
    if (k >= batches()) return;
    const int nb = size(k);
    const int* sid = st.sid[k % 3];
    float* dst = st.row[k & 1];
    const int r = threadIdx.x & 31;
    if (r >= row_stride) return;
    for (int i = threadIdx.x >> 5; i < nb; i += blockDim.x >> 5) {
      const bool ok = sid[i] < n_splats;
      cp_async4(&dst[i * BLEND_MAX_ROW + r],
                payload + (ok ? (size_t)sid[i] * row_stride + r : 0), ok);
    }
  }
  // before the loop: ids of batches 0 and 1, then rows of batch 0
  __device__ void prologue() const {
    ids(0);
    ids(1);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    rows(0);
    cp_async_commit();
  }
  // at the top of batch k, after the barrier that follows
  // cp_async_wait_all(): rows of k + 1 and ids of k + 2, in flight while
  // the block works on batch k
  __device__ void ahead(int k) const {
    rows(k + 1);
    ids(k + 2);
    cp_async_commit();
  }
};

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

// ---- the decoupled look-back of the single-pass scans (K3, K15) --------
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016.) Scratch: a 64-bit word holding the ticket
// counter (low half) and a call epoch (high half), then a 64-bit status
// word per tile (epoch, flag, 30-bit value), each word alone in its
// 32-byte sector. A block takes its tile by ticket (tiles start in ticket
// order, which the look-back's forward progress needs); the block that
// draws the last ticket resets the counter and bumps the epoch; a status
// word counts only if it carries this call's epoch, so stale words of
// earlier calls need no reset.
constexpr int STATUS_STRIDE = 4;            // int64 words a status word
constexpr unsigned FLAG_AGG = 1u << 30;     // the tile's own count
constexpr unsigned FLAG_PREFIX = 2u << 30;  // its inclusive prefix
constexpr unsigned VALUE_MASK = FLAG_AGG - 1u;

__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          unsigned flag,
                                                          unsigned value) {
  return ((unsigned long long)epoch << 32) | flag | value;
}

// Thread 0 of a block draws the block's ticket: (tile, epoch).
__device__ __forceinline__ void draw_ticket(unsigned long long* scratch,
                                            int& tile, unsigned& epoch) {
  const unsigned long long old = atomicAdd(&scratch[0], 1ull);
  epoch = (unsigned)(old >> 32);
  if ((unsigned)old == gridDim.x - 1u) {
    // every block of this call has its ticket: the next call (ordered
    // after this one on the stream) starts at 0 with the next epoch
    atomicExch(&scratch[0], (unsigned long long)(epoch + 1u) << 32);
  }
  tile = (int)(unsigned)old;
}

// The tile's exclusive prefix, by warp 0 (every lane calls it): lane l
// reads the status word of tile base - l; a round counts once every word
// up to the nearest inclusive prefix (or all 32) carries this epoch, else
// it reads the same words again. One word a lane: wider windows were
// slower on the card (PERF.md), their polls crowding the L2 lines
// of the status words.
__device__ inline unsigned look_back(const unsigned long long* status,
                                     int tile, unsigned epoch) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned excl = 0u;
  for (int base = tile - 1;;) {
    const int j = base - lane;
    const unsigned long long w =
        j >= 0 ? ld_relaxed64(&status[(size_t)j * STATUS_STRIDE])
               : status_word(epoch, FLAG_PREFIX, 0u);
    const unsigned flag = (unsigned)w & ~VALUE_MASK;
    const bool ready = (unsigned)(w >> 32) == epoch && flag != 0u;
    const unsigned prefix = __ballot_sync(FULL, ready && flag == FLAG_PREFIX);
    // the lanes up to the nearest inclusive prefix, or all of them
    const unsigned need = prefix ? (prefix & (0u - prefix)) * 2u - 1u : FULL;
    if ((__ballot_sync(FULL, ready) & need) != need) continue;
    excl += __reduce_add_sync(
        FULL, (need >> lane) & 1u ? (unsigned)w & VALUE_MASK : 0u);
    if (prefix) return excl;
    base -= 32;
  }
}

}  // namespace lsx
