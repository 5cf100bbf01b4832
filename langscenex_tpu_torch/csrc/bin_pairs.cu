// Tile binning's pair enumeration on the rank-key path, kernel K15: count,
// scan and emit the (tile << 22 | depth rank, splat id) pairs that the
// radix sort (K4) orders into the per-tile lists.
//
// Replaces: no TPU kernel. langscenex_tpu/ops/binning.py enumerates the
// pairs as XLA broadcasts (_enumerate_two_tier: a [P, K1] grid of tile
// slots and a [B_i, K_i] grid per register tier, the conic cull on every
// slot, an f32 cumsum of the kept counts, the budget mask, the streams'
// concatenation) and then compacts them (compact_pairs; K3 in the port).
// Run op by op on the card, that is ~20 streams of P * K1 slots (67.1M at
// 2^21 splats) written, read and scanned, and K3 compacting them to the
// ~0.5M kept pairs. This kernel writes the compacted stream directly; the
// broadcast and K3 stay as the plain version (ops/binning.py).
//
// Bound on the H100: bytes. The function must read each splat's tiles
// touched (4 B) and, for a splat that touches a tile, its rect, depth
// rank, mean, conic and cull threshold (40 B), and write each kept pair
// (8 B) and the fill of the rest of the stream: at field-sem's 2^21 slots
// at most 92 MB + 8 B a slot of the output, ~0.03 ms at 3.35 TB/s. The
// cull costs a few dozen FP32 operations a covered slot, far below that.
//
// Design: a single-pass scan with decoupled look-back (the protocol of K3,
// common.cuh), then a fill; one entry, two kernels.
//   - A block takes a tile of 1,024 splats by ticket; thread t holds
//     splats t, t + 256, t + 512 and t + 768 of it (rows), so that each
//     row's loads are coalesced. A splat that touches no tile reads only
//     its count.
//   - Count. A thread evaluates its splats' first-tier slots (k < min(tt,
//     K1), K1 <= 32) and keeps the kept ones as a bit mask in a register.
//     A splat that a further tier's register holds (the stable order of
//     -tt: tt above that of the tier's last entry, or equal and its id at
//     or below that entry's) has up to K_i more slots in the tier; its
//     warp walks them together, a slot a lane and a ballot a 32-slot
//     chunk, so the register's few big splats do not serialise one lane.
//   - Scan. Warp scans of the counts, one warp over the tile's 32 (row,
//     warp) sums, the look-back for the tile's prefix: each splat's offset
//     in splat-id order. The integer scan is exact; the plain path's f32
//     cumsum (_budget_offsets) equals it below 2^24 kept pairs and rounds
//     above, where this scan does not.
//   - Emit. A kept pair of rank r in its splat (the first tier in k
//     order, then each tier in order, its slots in order) goes to slot
//     off + r if that lies below min(budget, out_len): the budget drops
//     whole trailing splats by id, as the plain path's mask does, and the
//     kept pairs fill [0, min(total, budget)). Positions come from the
//     scan: no atomics, the same stream on every run.
//   - The tile that ends the scan writes the total (num_pairs) and the
//     budget flag; the second kernel fills [min(total, budget), out_len)
//     with (n_tiles << 22, P).
// The cull rounds as the plain path's separate PyTorch ops do, one
// rounding an operation in _rect_qmin's order (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: no FMA contraction), and min/max pass NaN on as
// torch.minimum/maximum do, so every keep decision is the plain path's.
// Every (tile, splat) key is unique and K4 is stable, so the same set of
// pairs in any order sorts to the same lists.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lsx::FLAG_AGG;
using lsx::FLAG_PREFIX;
using lsx::STATUS_STRIDE;

constexpr int BIN_THREADS = 256;
constexpr int BIN_WARPS = BIN_THREADS / 32;
constexpr int BIN_ROWS = 4;                       // splats a thread
constexpr int BIN_TILE = BIN_THREADS * BIN_ROWS;  // 1,024 splats a block
constexpr int MAX_TIERS = 8;
constexpr int FILL_BLOCKS = 2048;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BIN_ROWS * BIN_WARPS == 32, "one warp scans the tile's counts");

// the register's tiers in slot order
struct Tiers {
  int n;
  int b[MAX_TIERS];  // register entries the tier takes (1 .. P)
  int s[MAX_TIERS];  // its first slot
  int k[MAX_TIERS];  // its slots
};

struct Params {
  const int* tt;        // [P] tiles touched
  const int* rect_min;  // [P, 2] tile coords
  const int* rect_max;  // [P, 2] tile coords, exclusive
  const int* rank;      // [P] depth rank
  const float* mean2d;  // [P, 2]; null: no cull
  const float* conic;   // [P, 3]
  const float* qmax;    // [P]
  const int* top_neg_tt;      // the register: -tt sorted (stable) ...
  const long long* top_idx;   // ... and the ids in that order
  int* out_key;
  int* out_sid;
  int* total;
  bool* overflowed;
  unsigned long long* scratch;
  int P, K1, grid_x, tile_w, tile_h;
  unsigned limit;       // min(budget, out_len)
  long long budget;
  Tiers tiers;
};

// the tiers in shared memory, with each tier's last register entry
struct TierSmem {
  int s[MAX_TIERS], k[MAX_TIERS], thr_tt[MAX_TIERS], thr_id[MAX_TIERS];
};

struct Splat {
  int tt, rmx, rmy, rw;
  float mx, my, a, b, c, qmax;
};

// torch.minimum / torch.maximum: a NaN operand (x != x) gives NaN
__device__ __forceinline__ float tmin(float x, float y) {
  return x != x ? x : (y != y ? y : fminf(x, y));
}

__device__ __forceinline__ float tmax(float x, float y) {
  return x != x ? x : (y != y ? y : fmaxf(x, y));
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ Splat load_splat(const Params& q, int p, int tt) {
  Splat s;
  s.tt = tt;
  s.rmx = q.rect_min[2 * (size_t)p];
  s.rmy = q.rect_min[2 * (size_t)p + 1];
  s.rw = max(q.rect_max[2 * (size_t)p] - s.rmx, 1);
  s.mx = s.my = s.a = s.b = s.c = s.qmax = 0.f;
  if (q.mean2d != nullptr) {
    s.mx = q.mean2d[2 * (size_t)p];
    s.my = q.mean2d[2 * (size_t)p + 1];
    s.a = clamp_min(q.conic[3 * (size_t)p], 1e-12f);
    s.b = q.conic[3 * (size_t)p + 1];
    s.c = clamp_min(q.conic[3 * (size_t)p + 2], 1e-12f);
    s.qmax = q.qmax[p];
  }
  return s;
}

// _rect_qmin's edge_x: dx fixed at ex, dy = min(max((-b ex) / c, ly), hy);
// ((a ex) ex + (2 (b ex)) dy) + (c dy) dy
__device__ __forceinline__ float edge_x(const Splat& s, float ex, float ly,
                                        float hy) {
  const float dy =
      tmin(tmax(__fdiv_rn(__fmul_rn(-s.b, ex), s.c), ly), hy);
  const float t1 = __fmul_rn(__fmul_rn(s.a, ex), ex);
  const float t2 = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(s.b, ex)), dy);
  const float t3 = __fmul_rn(__fmul_rn(s.c, dy), dy);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// edge_y: dy fixed at ey, dx = min(max((-b ey) / a, lx), hx);
// ((a dx) dx + (2 (b dx)) ey) + (c ey) ey
__device__ __forceinline__ float edge_y(const Splat& s, float ey, float lx,
                                        float hx) {
  const float dx =
      tmin(tmax(__fdiv_rn(__fmul_rn(-s.b, ey), s.a), lx), hx);
  const float t1 = __fmul_rn(__fmul_rn(s.a, dx), dx);
  const float t2 = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(s.b, dx)), ey);
  const float t3 = __fmul_rn(__fmul_rn(s.c, ey), ey);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// the conic cull of tile (tx, ty): keep iff the minimum of Q over the
// tile's rectangle (0 if the mean lies inside) is at most qmax
__device__ __forceinline__ bool cull_keeps(const Splat& s, int tx, int ty,
                                           int tile_w, int tile_h) {
  const float lx = __fsub_rn(__int2float_rn(tx * tile_w), s.mx);
  const float ly = __fsub_rn(__int2float_rn(ty * tile_h), s.my);
  const float hx = __fadd_rn(lx, __int2float_rn(tile_w - 1));
  const float hy = __fadd_rn(ly, __int2float_rn(tile_h - 1));
  const bool inside = lx <= 0.f && 0.f <= hx && ly <= 0.f && 0.f <= hy;
  const float q = tmin(tmin(edge_x(s, lx, ly, hy), edge_x(s, hx, ly, hy)),
                       tmin(edge_y(s, ly, lx, hx), edge_y(s, hy, lx, hx)));
  return (inside ? 0.f : q) <= s.qmax;
}

// whether splat p (tt tiles) is among the first b entries of the register
// (the stable ascending sort of -tt), given the b-th entry (thr_tt, thr_id)
__device__ __forceinline__ bool in_register(int tt, int p, int thr_tt,
                                            int thr_id) {
  return tt > thr_tt || (tt == thr_tt && p <= thr_id);
}

// The further tiers' slots of splat p, walked by its whole warp (every
// lane calls it with the same splat): lane l takes slot base + l of each
// 32-slot chunk of each tier that holds the splat. fn(keep, tile, before)
// runs on every lane for every chunk: whether its slot is kept, the
// slot's tile and the kept slots of these tiers ahead of it. Returns the
// kept slots.
template <class Fn>
__device__ __forceinline__ unsigned walk_tiers(const Params& q,
                                               const TierSmem& ts,
                                               const Splat& s, int p,
                                               Fn fn) {
  const int lane = threadIdx.x & 31;
  unsigned n_kept = 0u;
  for (int i = 0; i < q.tiers.n; ++i) {
    const int si = ts.s[i];
    if (s.tt <= si || !in_register(s.tt, p, ts.thr_tt[i], ts.thr_id[i])) {
      continue;
    }
    const int n = min(ts.k[i], s.tt - si);
    for (int base = 0; base < n; base += 32) {
      const int slot = si + base + lane;
      bool keep = base + lane < n;
      int tx = 0, ty = 0;
      if (keep) {
        tx = s.rmx + slot % s.rw;
        ty = s.rmy + slot / s.rw;
        if (q.mean2d != nullptr) {
          keep = cull_keeps(s, tx, ty, q.tile_w, q.tile_h);
        }
      }
      const unsigned m = __ballot_sync(FULL, keep);
      fn(keep, ty * q.grid_x + tx, n_kept + __popc(m & ((1u << lane) - 1u)));
      n_kept += __popc(m);
    }
  }
  return n_kept;
}

__global__ void __launch_bounds__(BIN_THREADS)
bin_pairs_onepass(const Params q) {
  __shared__ unsigned offset[BIN_ROWS * BIN_WARPS];  // (row, warp) -> first
  __shared__ TierSmem ts;
  __shared__ unsigned s_excl, s_epoch;
  __shared__ int s_tile;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  unsigned long long* status = q.scratch + STATUS_STRIDE;
  const bool cull = q.mean2d != nullptr;

  if (t == 0) lsx::draw_ticket(q.scratch, s_tile, s_epoch);
  if (t == 0) {
    for (int i = 0; i < q.tiers.n; ++i) {
      const int e = q.tiers.b[i] - 1;
      ts.s[i] = q.tiers.s[i];
      ts.k[i] = q.tiers.k[i];
      ts.thr_tt[i] = -q.top_neg_tt[e];
      ts.thr_id[i] = (int)q.top_idx[e];
    }
  }
  __syncthreads();
  const int tile = s_tile;
  const unsigned epoch = s_epoch;
  const int first = tile * BIN_TILE + t;  // row r's splat: first + r * 256

  // ---- count: the first tier by each thread, the further tiers by warps
  unsigned mask[BIN_ROWS], cnt[BIN_ROWS];
  unsigned big = 0u;  // rows whose splat a further tier holds
#pragma unroll
  for (int r = 0; r < BIN_ROWS; ++r) {
    const int p = first + r * BIN_THREADS;
    const int tt = p < q.P ? q.tt[p] : 0;
    mask[r] = 0u;
    if (tt > 0) {
      const int n1 = min(tt, q.K1);
      if (!cull) {
        mask[r] = n1 >= 32 ? FULL : (1u << n1) - 1u;
      } else {
        const Splat s = load_splat(q, p, tt);
        for (int k = 0; k < n1; ++k) {
          if (cull_keeps(s, s.rmx + k % s.rw, s.rmy + k / s.rw, q.tile_w,
                         q.tile_h)) {
            mask[r] |= 1u << k;
          }
        }
      }
      for (int i = 0; i < q.tiers.n; ++i) {
        if (tt > ts.s[i] && in_register(tt, p, ts.thr_tt[i], ts.thr_id[i])) {
          big |= 1u << r;
          break;
        }
      }
    }
    cnt[r] = __popc(mask[r]);
  }
#pragma unroll
  for (int r = 0; r < BIN_ROWS; ++r) {
    for (unsigned lanes = __ballot_sync(FULL, (big >> r) & 1u); lanes;
         lanes &= lanes - 1u) {
      const int src = __ffs(lanes) - 1;
      const int p = first - lane + src + r * BIN_THREADS;
      const Splat s = load_splat(q, p, q.tt[p]);
      const unsigned n = walk_tiers(q, ts, s, p, [](bool, int, unsigned) {});
      if (lane == src) cnt[r] += n;
    }
  }

  // ---- scan: warps, the tile's 32 (row, warp) sums, the look-back
  unsigned incl[BIN_ROWS];
#pragma unroll
  for (int r = 0; r < BIN_ROWS; ++r) {
    incl[r] = lsx::warp_inclusive_scan(cnt[r]);
    if (lane == 31) offset[r * BIN_WARPS + warp] = incl[r];
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned c = offset[lane];
    const unsigned inc = lsx::warp_inclusive_scan(c);
    offset[lane] = inc - c;
    const unsigned count = __shfl_sync(FULL, inc, 31);
    if (lane == 0) {
      lsx::st_relaxed64(&status[(size_t)tile * STATUS_STRIDE],
                        lsx::status_word(epoch,
                                         tile == 0 ? FLAG_PREFIX : FLAG_AGG,
                                         count));
    }
    const unsigned excl =
        tile == 0 ? 0u : lsx::look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile > 0) {
        lsx::st_relaxed64(&status[(size_t)tile * STATUS_STRIDE],
                          lsx::status_word(epoch, FLAG_PREFIX, excl + count));
      }
      s_excl = excl;
      if (tile == (int)gridDim.x - 1) {
        *q.total = (int)(excl + count);
        *q.overflowed = (long long)(excl + count) > q.budget;
      }
    }
  }
  __syncthreads();

  // ---- emit: each kept pair at its splat's offset + its rank
  const unsigned excl = s_excl;
  const unsigned limit = q.limit;
  int* const out_key = q.out_key;
  int* const out_sid = q.out_sid;
  unsigned off[BIN_ROWS];
#pragma unroll
  for (int r = 0; r < BIN_ROWS; ++r) {
    off[r] = excl + offset[r * BIN_WARPS + warp] + incl[r] - cnt[r];
    unsigned m = mask[r];
    if (m == 0u || off[r] >= limit) continue;
    const int p = first + r * BIN_THREADS;
    const int rmx = q.rect_min[2 * (size_t)p];
    const int rmy = q.rect_min[2 * (size_t)p + 1];
    const int rw = max(q.rect_max[2 * (size_t)p] - rmx, 1);
    const int key_lo = q.rank[p];
    for (unsigned pos = off[r]; m != 0u && pos < limit; ++pos) {
      const int k = __ffs(m) - 1;
      m &= m - 1u;
      const int tile_id = (rmy + k / rw) * q.grid_x + rmx + k % rw;
      out_key[pos] = (tile_id << 22) | key_lo;
      out_sid[pos] = p;
    }
  }
#pragma unroll
  for (int r = 0; r < BIN_ROWS; ++r) {
    const unsigned after = off[r] + __popc(mask[r]);
    for (unsigned lanes =
             __ballot_sync(FULL, ((big >> r) & 1u) && after < limit);
         lanes; lanes &= lanes - 1u) {
      const int src = __ffs(lanes) - 1;
      const int p = first - lane + src + r * BIN_THREADS;
      const unsigned start = __shfl_sync(FULL, after, src);
      const Splat s = load_splat(q, p, q.tt[p]);
      const int key_lo = q.rank[p];
      walk_tiers(q, ts, s, p, [=](bool keep, int tile_id, unsigned before) {
        const unsigned pos = start + before;
        if (keep && pos < limit) {
          out_key[pos] = (tile_id << 22) | key_lo;
          out_sid[pos] = p;
        }
      });
    }
  }
}

// [min(total, budget), out_len) <- (fill_key, fill_sid)
__global__ void __launch_bounds__(BIN_THREADS)
bin_pairs_fill(int* __restrict__ out_key, int* __restrict__ out_sid,
               const int* __restrict__ total, unsigned limit, int out_len,
               int fill_key, int fill_sid) {
  const int start = (int)min((unsigned)*total, limit);
  for (int i = start + blockIdx.x * BIN_THREADS + threadIdx.x; i < out_len;
       i += gridDim.x * BIN_THREADS) {
    out_key[i] = fill_key;
    out_sid[i] = fill_sid;
  }
}

}  // namespace

// tt, rank: [P] int32; rect_min, rect_max: [P, 2] int32; mean2d [P, 2],
// conic [P, 3], qmax [P] f32, all three null for no cull; top_neg_tt [>=
// max b] int32 and top_idx int64: the register (torch.sort(-tt,
// stable=True)), null without tiers; tiers: a host array of n_tiers (b,
// first slot, slots) triples in slot order, 1 <= b <= P; out_key,
// out_sid: [out_len]; total: [1] int32 (the kept pairs, num_pairs);
// overflowed: [1] bool (total > budget); scratch: 4 (1 + n_blocks) 64-bit
// words, zeroed when first allocated and owned by one stream, n_blocks =
// ceil(P / 1024). The caller keeps every count below 2^30 (the status
// words' values): P K1 + sum b k < 2^30.
extern "C" int lsx_bin_pairs(const int* tt, const int* rect_min,
                             const int* rect_max, const int* rank,
                             const float* mean2d, const float* conic,
                             const float* qmax, const int* top_neg_tt,
                             const long long* top_idx, const int* tiers,
                             int n_tiers, int* out_key, int* out_sid,
                             int* total, bool* overflowed, void* scratch,
                             int P, int K1, int grid_x, int n_tiles,
                             int tile_w, int tile_h, long long budget,
                             int out_len, int n_blocks,
                             cudaStream_t stream) {
  if (P <= 0 || P >= (1 << 22) || K1 < 1 || K1 > 32 || n_tiers < 0 ||
      n_tiers > MAX_TIERS || (n_tiers > 0 && (!top_neg_tt || !top_idx)) ||
      out_len < 0 || budget < 0 || n_blocks != (P + BIN_TILE - 1) / BIN_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  Params q;
  q.tt = tt;
  q.rect_min = rect_min;
  q.rect_max = rect_max;
  q.rank = rank;
  q.mean2d = mean2d;
  q.conic = conic;
  q.qmax = qmax;
  q.top_neg_tt = top_neg_tt;
  q.top_idx = top_idx;
  q.out_key = out_key;
  q.out_sid = out_sid;
  q.total = total;
  q.overflowed = overflowed;
  q.scratch = static_cast<unsigned long long*>(scratch);
  q.P = P;
  q.K1 = K1;
  q.grid_x = grid_x;
  q.tile_w = tile_w;
  q.tile_h = tile_h;
  q.budget = budget;
  q.limit = (unsigned)(budget < out_len ? budget : out_len);
  q.tiers.n = n_tiers;
  for (int i = 0; i < n_tiers; ++i) {
    q.tiers.b[i] = tiers[3 * i];
    q.tiers.s[i] = tiers[3 * i + 1];
    q.tiers.k[i] = tiers[3 * i + 2];
    if (q.tiers.b[i] < 1 || q.tiers.b[i] > P || q.tiers.k[i] < 1) {
      return (int)cudaErrorInvalidValue;
    }
  }
  bin_pairs_onepass<<<n_blocks, BIN_THREADS, 0, stream>>>(q);
  LSX_CHECK_LAUNCH();
  if (out_len > 0) {
    const int blocks =
        min(FILL_BLOCKS, (out_len + BIN_THREADS - 1) / BIN_THREADS);
    bin_pairs_fill<<<blocks, BIN_THREADS, 0, stream>>>(
        out_key, out_sid, total, q.limit, out_len, n_tiles << 22, P);
  }
  return (int)cudaGetLastError();
}
