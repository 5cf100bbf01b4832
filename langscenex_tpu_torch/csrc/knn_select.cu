// 3D k-nearest selection, kernel K14: for each sampled splat i of S, the k
// slots j of N with the smallest
//   d2[i, j] = (sq_s[i] + sq_f[j]) - 2 dot(sf[i], f[j]),
// ties to the lower slot, in ascending (d2, slot) order: the set
// lax.top_k(-d2, k) selects. Outputs d2 [S, k] f32 and the slots [S, k]
// int64.
//
// Replaces no Pallas kernel. The JAX package's loss_cls_3d
// (langscenex_tpu/ops/losses.py:123-147) leaves the [S, N] matrix and
// lax.top_k to XLA; the port's plain version (ops/losses._knn_smallest)
// builds d2 as [800, 2^21] f32 (6.7 GB, from three temporaries of that
// size), runs topk over it and stable-sorts each row whose k-th value is
// tied, behind a host sync. This kernel writes no [S, N] tensor and never
// syncs.
//
// Bit for bit: d2 is torch's (sq_s[:, None] + sq_f[None, :]) - 2 (sf @ f.T)
// at "highest" precision. The norms come in from the caller (torch's own
// sums); their sum is rounded once (__fadd_rn); the dot is cuBLAS's gemm
// order for a depth of 3, fma(z, z', fma(y, y', x x')); and t - 2 dot is
// one fma (2 dot is exact, so one rounding of t - 2 dot is torch's
// subtraction). No expression is left for the compiler to contract or
// reorder. Of the orders tried on an H100 (CUDA 12.8) only this one
// matches, over the whole [800, 2^21] matrix and at 2 to 128 rows. (For a
// single row cuBLAS takes a gemv, whose order differs; K14 keeps the
// gemm's for every S.) Near neighbours sit at d2 ~ 2.5e-5 against a
// rounding step of ~5e-7 at |x|^2 ~ 4, so any other order flips
// neighbours.
//
// Bound on the H100: the FP32 pipe. Each (row, slot) pair costs 6 issue
// slots, as the scan's SASS has them (FMUL and two FFMAs for the dot, FADD
// for the norm sum, FFMA for t - 2 dot, FSETP for the compare; the branch
// is one per four slots and R rows): at [800] x 2^21, 1.68e9 pairs,
// 0.30 ms at 132 SMs x 128 lanes x 1980 MHz. Bytes are 16 a slot (34 MB,
// 0.01 ms at 3.35 TB/s).
//
// Design:
// - A scan block holds every row of its row block in registers, R rows a
//   thread (x, y, z, |s|^2 and a k-list of (d2, slot) each), and streams
//   one contiguous chunk of the slots through shared memory in tiles of
//   KS_TILE, the next tile in flight by cp.async while the block works on
//   this one. Every thread reads every staged slot: a broadcast, no bank
//   conflict. Blocks: the SMs times the blocks an SM holds, so the chunks
//   are one even wave.
// - A thread walks its slots in ascending order, so a strict d2 < k-th
//   keeps the lower slot of equal values; the insertion is an unrolled
//   compare-and-shift on the registers, taken rarely. The distances of a
//   group of four slots (one float4 of each staged array) to the thread's
//   rows are one straight run with one branch, whose rare side inserts.
// - Rarely, because a first pass bounds each row: the same scan over
//   M = min(KS_SAMPLE, N) slots, one in each N / M, gives every row a k-th
//   value tau that no true k-th value exceeds (at least k slots lie at or
//   below it), and the full scan starts each k-list just above tau. A
//   chunk then meets a few candidates a row instead of the k ln(chunk / k)
//   insertions of a list started empty, each of which stalls its warp. Tied rows (dead slots at
//   the origin: tau = 0) insert their chunk's first k zeros and no more.
//   On an H100 at [800] x 2^21 it takes K14 from 1.07 to 0.75 ms at k = 5
//   and from 2.20 to 1.24 ms at k = 16.
// - A merge warp a row takes the chunks' sorted k-lists, keeps a k-list a
//   lane by (d2, slot), and pops the k smallest of the 32 in k rounds of
//   shuffles.
// Slots past N stage as (0, 0, 0) with |f|^2 = +inf and never enter a list.
// A non-finite d2 never enters one either: with fewer than k finite
// values in a row (never for finite positions), the rest of the row is
// the last slot.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int KS_TILE = 256;          // slots a scan block stages at a time
constexpr int KS_THREADS = 256;       // most threads of a scan block
constexpr int KS_MERGE_WARPS = 8;     // rows (a warp each) of a merge block
constexpr int KS_MAX_K = 16;
constexpr int KS_SAMPLE = 32768;      // most slots of the first pass
constexpr int KS_VX = 3 * KS_TILE / 4;         // float4s of a tile's xyz
constexpr int KS_VQ = KS_TILE / 4;             // and of its |f|^2

// rows a scan thread holds: 4 while a k-list is short, 2 above k = 8
template <int K>
__host__ __device__ constexpr int rows_per_thread() {
  return K <= 8 ? 4 : 2;
}

struct Cand {
  float v;
  int c;
};

__device__ __forceinline__ bool lex_less(float v, int c, float v2, int c2) {
  return v < v2 || (v == v2 && c < c2);
}

// insert (d, j) into the sorted k-list (v, c), whose last entry it beats;
// LEX orders equal values by slot, else (slots ascending) strict < does
template <int K, bool LEX>
__device__ __forceinline__ void insert(float (&v)[K], int (&c)[K], float d,
                                       int j) {
#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    const bool left = LEX ? lex_less(d, j, v[q - 1], c[q - 1]) : d < v[q - 1];
    const bool here = LEX ? lex_less(d, j, v[q], c[q]) : d < v[q];
    if (left) {
      v[q] = v[q - 1];
      c[q] = c[q - 1];
    } else if (here) {
      v[q] = d;
      c[q] = j;
    }
  }
  if (LEX ? lex_less(d, j, v[0], c[0]) : d < v[0]) {
    v[0] = d;
    c[0] = j;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(gmem)));
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// issue the copies of the tile of slots [c0, c0 + KS_TILE) of f [N, 3] and
// sq_f [N]; slots past N are stored as (0, 0, 0) and +inf
__device__ __forceinline__ void stage_tile(float* sx, float* sq,
                                           const float* f, const float* sq_f,
                                           long long c0, int N, bool vec) {
  if (vec && c0 + KS_TILE <= N) {
    for (int e = threadIdx.x; e < KS_VX + KS_VQ; e += blockDim.x) {
      if (e < KS_VX) {
        cp_async16(sx + 4 * e, f + 3 * c0 + 4 * e);
      } else {
        cp_async16(sq + 4 * (e - KS_VX), sq_f + c0 + 4 * (e - KS_VX));
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < 3 * KS_TILE; e += blockDim.x) {
    const long long g = 3 * c0 + e;
    if (g < 3LL * N) {
      lsx::cp_async4(sx + e, f + g, true);
    } else {
      sx[e] = 0.0f;
    }
  }
  for (int e = threadIdx.x; e < KS_TILE; e += blockDim.x) {
    const long long g = c0 + e;
    if (g < N) {
      lsx::cp_async4(sq + e, sq_f + g, true);
    } else {
      sq[e] = __int_as_float(0x7f800000);
    }
  }
}

// d2 of a row (x, y, z, |s|^2) and a slot (fx, fy, fz, |f|^2): the dense
// expression's value bit for bit, in the dot order of cuBLAS's gemm (the
// note at the top)
__device__ __forceinline__ float knn_d2(float x, float y, float z, float q,
                                        float fx, float fy, float fz,
                                        float fq) {
  const float dot = __fmaf_rn(z, fz, __fmaf_rn(y, fy, __fmul_rn(x, fx)));
  return __fmaf_rn(-2.0f, dot, __fadd_rn(q, fq));
}

// every row of the thread against the four slots j .. j + 3 of one
// 16-byte group (xyz in a, m, z; |f|^2 in q): the 4 R distances in one
// straight run, one branch on whether any beats its row's k-th value, and
// only then the inserts, slot by slot in ascending order
template <int K, int R>
__device__ __forceinline__ void visit4(const float (&px)[R],
                                       const float (&py)[R],
                                       const float (&pz)[R],
                                       const float (&pq)[R],
                                       float (&v)[R][K], int (&c)[R][K],
                                       float4 a, float4 m, float4 z, float4 q,
                                       int j) {
  float d[4][R];
  bool hit = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    d[0][r] = knn_d2(px[r], py[r], pz[r], pq[r], a.x, a.y, a.z, q.x);
    d[1][r] = knn_d2(px[r], py[r], pz[r], pq[r], a.w, m.x, m.y, q.y);
    d[2][r] = knn_d2(px[r], py[r], pz[r], pq[r], m.z, m.w, z.x, q.z);
    d[3][r] = knn_d2(px[r], py[r], pz[r], pq[r], z.y, z.z, z.w, q.w);
    const float kth = v[r][K - 1];
    hit |= (d[0][r] < kth) | (d[1][r] < kth) | (d[2][r] < kth)
           | (d[3][r] < kth);
  }
  if (hit) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (d[s][r] < v[r][K - 1]) insert<K, false>(v[r], c[r], d[s][r], j + s);
      }
    }
  }
}

// The scan: block (x, y) takes row block y (R * blockDim.x rows) against
// chunk x of the n_tiles tiles of slots and writes each row's k-list to
// part [gridDim.x, S, K]. With tau, row i's list starts just above
// tau[i * K] (the first pass's k-th value), else at +inf.
template <int K>
__global__ void __launch_bounds__(KS_THREADS)
knn_select_scan(const float* __restrict__ sf, const float* __restrict__ sq_s,
                const float* __restrict__ f, const float* __restrict__ sq_f,
                const float* __restrict__ tau, Cand* __restrict__ part,
                int S, int N, int n_tiles, int vec) {
  constexpr int R = rows_per_thread<K>();
  __shared__ __align__(16) float s_xyz[2][3 * KS_TILE];
  __shared__ __align__(16) float s_sq[2][KS_TILE];

  const float inf = __int_as_float(0x7f800000);
  const int row0 = blockIdx.y * R * blockDim.x + threadIdx.x;
  float px[R], py[R], pz[R], pq[R];
  float v[R][K];
  int c[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * blockDim.x;
    const bool ok = row < S;
    px[r] = ok ? sf[3LL * row] : 0.0f;
    py[r] = ok ? sf[3LL * row + 1] : 0.0f;
    pz[r] = ok ? sf[3LL * row + 2] : 0.0f;
    pq[r] = ok ? sq_s[row] : inf;     // a row past S meets only +inf
    const float init =
        ok && tau != nullptr ? nextafterf(tau[(long long)row * K], inf) : inf;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      v[r][q] = init;
      c[r][q] = INT_MAX;
    }
  }

  const long long t_begin = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t_end = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;
  stage_tile(s_xyz[0], s_sq[0], f, sq_f, t_begin * KS_TILE, N, vec != 0);
  lsx::cp_async_commit();
  for (long long t = t_begin; t < t_end; ++t) {
    const int b = (int)((t - t_begin) & 1);
    if (t + 1 < t_end) {
      stage_tile(s_xyz[b ^ 1], s_sq[b ^ 1], f, sq_f, (t + 1) * KS_TILE, N,
                 vec != 0);
    }
    lsx::cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float4* X = reinterpret_cast<const float4*>(s_xyz[b]);
    const float4* Q = reinterpret_cast<const float4*>(s_sq[b]);
    const int j0 = (int)(t * KS_TILE);
#pragma unroll 1
    for (int g = 0; g < KS_VQ; ++g) {
      visit4<K, R>(px, py, pz, pq, v, c, X[3 * g], X[3 * g + 1],
                         X[3 * g + 2], Q[g], j0 + 4 * g);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * blockDim.x;
    if (row >= S) continue;
    Cand* out = part + ((long long)blockIdx.x * S + row) * K;
#pragma unroll
    for (int q = 0; q < K; ++q) out[q] = Cand{v[r][q], c[r][q]};
  }
}

// The merge: a warp a row over the C chunks' lists of part [C, S, K];
// writes the k smallest by (d2, slot) to out_v [S, K] and (if given)
// out_c [S, K], a slot past N (an unfilled entry) as N - 1.
template <int K>
__global__ void __launch_bounds__(KS_MERGE_WARPS * 32)
knn_select_merge(const Cand* __restrict__ part, int C, int S, int N,
                 float* __restrict__ out_v, long long* __restrict__ out_c) {
  const int row = blockIdx.x * KS_MERGE_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= S) return;               // the whole warp
  const float inf = __int_as_float(0x7f800000);
  float v[K];
  int c[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    v[q] = inf;
    c[q] = INT_MAX;
  }
  for (int ch = lane; ch < C; ch += 32) {
    const Cand* p = part + ((long long)ch * S + row) * K;
#pragma unroll 1
    for (int q = 0; q < K; ++q) {
      const Cand e = p[q];
      // a chunk's list is sorted: once one entry misses, the rest do
      if (!lex_less(e.v, e.c, v[K - 1], c[K - 1])) break;
      insert<K, true>(v, c, e.v, e.c);
    }
  }
  for (int q = 0; q < K; ++q) {
    float bv = v[0];
    int bc = c[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
      if (lex_less(ov, oc, bv, bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if (v[0] == bv && c[0] == bc) {   // slots are unique: the owner pops
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) {
        v[s] = v[s + 1];
        c[s] = c[s + 1];
      }
      v[K - 1] = inf;
      c[K - 1] = INT_MAX;
    }
    if (lane == 0) {
      out_v[(long long)row * K + q] = bv;
      if (out_c != nullptr) out_c[(long long)row * K + q] = bc < N ? bc : N - 1;
    }
  }
}

// the first pass's M slots of f and sq_f, packed
__global__ void knn_select_sample(const float* __restrict__ f,
                                  const float* __restrict__ sq_f,
                                  float* __restrict__ xyz,
                                  float* __restrict__ sq, int M,
                                  long long stride) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  // one slot in each stride-long bucket, at a hashed offset: distinct, and
  // off any period of the slots' order
  const long long j = m * stride + (m * 40503LL) % stride;
  xyz[3 * m] = f[3 * j];
  xyz[3 * m + 1] = f[3 * j + 1];
  xyz[3 * m + 2] = f[3 * j + 2];
  sq[m] = sq_f[j];
}

// one scan's launch shape
struct ScanShape {
  int threads, grid_y, chunks, n_tiles;
};

template <int K>
int scan_shape(int S, int N, ScanShape* sh) {
  constexpr int R = rows_per_thread<K>();
  const int per_block = R * KS_THREADS;
  sh->grid_y = (S + per_block - 1) / per_block;
  const int rows = (S + R * sh->grid_y - 1) / (R * sh->grid_y);
  sh->threads = (rows + 31) / 32 * 32;
  sh->n_tiles = (int)(((long long)N + KS_TILE - 1) / KS_TILE);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, knn_select_scan<K>, sh->threads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long chunks = wave / sh->grid_y;
  sh->chunks = (int)(chunks < 1 ? 1 : chunks > sh->n_tiles ? sh->n_tiles
                                                            : chunks);
  return 0;
}

long long align256(long long n) { return (n + 255) / 256 * 256; }

// scratch of a call: the sample's slots, the first pass's lists and
// k-th values, the full scan's lists
struct Plan {
  ScanShape full, sample;
  int M;
  long long stride, off_xyz, off_sq, off_part1, off_tau, off_part2, bytes;
};

template <int K>
int plan(int S, int N, Plan* p) {
  p->M = N < KS_SAMPLE ? N : KS_SAMPLE;
  p->stride = N / p->M;
  int err = scan_shape<K>(S, N, &p->full);
  if (!err) err = scan_shape<K>(S, p->M, &p->sample);
  if (err) return err;
  long long at = 0;
  p->off_xyz = at;
  p->off_sq = at += align256(3LL * p->M * sizeof(float));
  p->off_part1 = at += align256((long long)p->M * sizeof(float));
  p->off_tau = at += align256((long long)p->sample.chunks * S * K
                              * sizeof(Cand));
  p->off_part2 = at += align256((long long)S * K * sizeof(float));
  p->bytes = at + align256((long long)p->full.chunks * S * K * sizeof(Cand));
  return 0;
}

template <int K>
int scratch_bytes(int S, int N, long long* bytes) {
  Plan p;
  const int err = plan<K>(S, N, &p);
  if (err) return err;
  *bytes = p.bytes;
  return 0;
}

template <int K>
int run(const float* sf, const float* sq_s, const float* f, const float* sq_f,
        float* out_v, long long* out_c, char* scratch, int S, int N,
        cudaStream_t stream) {
  Plan p;
  const int err = plan<K>(S, N, &p);
  if (err) return err;
  const int merge_blocks = (S + KS_MERGE_WARPS - 1) / KS_MERGE_WARPS;
  float* xyz = reinterpret_cast<float*>(scratch + p.off_xyz);
  float* sq = reinterpret_cast<float*>(scratch + p.off_sq);
  Cand* part1 = reinterpret_cast<Cand*>(scratch + p.off_part1);
  float* kth = reinterpret_cast<float*>(scratch + p.off_tau);
  knn_select_sample<<<(p.M + 255) / 256, 256, 0, stream>>>(f, sq_f, xyz, sq,
                                                           p.M, p.stride);
  knn_select_scan<K>
      <<<dim3(p.sample.chunks, p.sample.grid_y), p.sample.threads, 0,
         stream>>>(sf, sq_s, xyz, sq, nullptr, part1, S, p.M,
                   p.sample.n_tiles, 1);
  knn_select_merge<K><<<merge_blocks, KS_MERGE_WARPS * 32, 0, stream>>>(
      part1, p.sample.chunks, S, p.M, kth, nullptr);
  const float* tau = kth + (K - 1);
  const bool vec = reinterpret_cast<std::uintptr_t>(f) % 16 == 0
                   && reinterpret_cast<std::uintptr_t>(sq_f) % 16 == 0;
  Cand* part2 = reinterpret_cast<Cand*>(scratch + p.off_part2);
  knn_select_scan<K>
      <<<dim3(p.full.chunks, p.full.grid_y), p.full.threads, 0, stream>>>(
          sf, sq_s, f, sq_f, tau, part2, S, N, p.full.n_tiles, vec ? 1 : 0);
  knn_select_merge<K><<<merge_blocks, KS_MERGE_WARPS * 32, 0, stream>>>(
      part2, p.full.chunks, S, N, out_v, out_c);
  LSX_CHECK_LAUNCH();
  return 0;
}

// K's instance of F(args...): k in [1, KS_MAX_K]
#define KS_DISPATCH(F, k, ...)                                   \
  switch (k) {                                                   \
    case 1: return F<1>(__VA_ARGS__);                            \
    case 2: return F<2>(__VA_ARGS__);                            \
    case 3: return F<3>(__VA_ARGS__);                            \
    case 4: return F<4>(__VA_ARGS__);                            \
    case 5: return F<5>(__VA_ARGS__);                            \
    case 6: return F<6>(__VA_ARGS__);                            \
    case 7: return F<7>(__VA_ARGS__);                            \
    case 8: return F<8>(__VA_ARGS__);                            \
    case 9: return F<9>(__VA_ARGS__);                            \
    case 10: return F<10>(__VA_ARGS__);                          \
    case 11: return F<11>(__VA_ARGS__);                          \
    case 12: return F<12>(__VA_ARGS__);                          \
    case 13: return F<13>(__VA_ARGS__);                          \
    case 14: return F<14>(__VA_ARGS__);                          \
    case 15: return F<15>(__VA_ARGS__);                          \
    case 16: return F<16>(__VA_ARGS__);                          \
    default: return (int)cudaErrorInvalidValue;                  \
  }

static_assert(KS_MAX_K == 16, "KS_DISPATCH instantiates k = 1..16");

}  // namespace

// bytes of device scratch lsx_knn_select takes for (S, N, k) on the
// current device, into *bytes
extern "C" int lsx_knn_select_scratch(int S, int N, int k, long long* bytes) {
  KS_DISPATCH(scratch_bytes, k, S, N, bytes)
}

// sf [S, 3], sq_s [S], f [N, 3], sq_f [N] f32 contiguous (sf 4-byte, f and
// sq_f best 16-byte aligned) -> out_v [S, k] f32, out_c [S, k] int64;
// scratch of lsx_knn_select_scratch's bytes, 256-byte aligned; S >= 1,
// 1 <= k <= min(16, N), N < 2^30.
extern "C" int lsx_knn_select(const void* sf, const void* sq_s, const void* f,
                              const void* sq_f, void* out_v, void* out_c,
                              void* scratch, int S, int N, int k,
                              cudaStream_t stream) {
  KS_DISPATCH(run, k, static_cast<const float*>(sf),
              static_cast<const float*>(sq_s), static_cast<const float*>(f),
              static_cast<const float*>(sq_f), static_cast<float*>(out_v),
              static_cast<long long*>(out_c), static_cast<char*>(scratch), S,
              N, stream)
}
