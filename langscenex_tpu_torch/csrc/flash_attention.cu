// Bounded-logit flash-attention forward in the [B, T, H, D] layout,
// kernel K5.
//
// Replaces: langscenex_tpu/ops/flash_attention.py:991
// _attn_kernel_nomax_t4 (reached via _flash_fwd_impl_bthd, :1043, from
// attention_bthd, :1128). Non-causal attention over the joint [text;
// video] sequence of the CogVideoX DiT, whose qk-LayerNorm bounds the
// logits, so there is no running max. The rounding points are the TPU
// kernel's:
//   q' = bf16(q * bf16(scale * log2 e))          (the product in bf16)
//   s  = k . q'   in f32;   p = exp2(s)
//   P  = bf16(p)  before the PV product; the normalizer l = sum of P
//   l  = max(l, 1e-30);  o = bf16(acc / l);  l2 = log2(l)  (kept for K7)
// kv rows past T contribute nothing (p is set to 0 there and the staged
// k/v rows are zero, so no garbage or NaN enters the sums).
//
// Bound on the H100: operations. At the DiT's shape (q, k, v [2, 17776,
// 48, 64] bf16) one call does 4 B H T^2 D = 7.77 TFLOP: 7.85 ms at
// 989 TFLOP/s, against 874 MB of q, k, v, o (0.26 ms at 3.35 TB/s). Its
// B H T^2 = 3.03e10 exp2s take about as long again on the SFU
// (16 ex2/clk/SM).
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work): one block of 4 warps per (b, h, 64-query tile); each warp
// owns 16 query rows. The scaled q tile is staged once into shared memory
// and held as mma A fragments. kv tiles of 64 rows are double-buffered in
// shared memory with cp.async (rows past T zero-filled), XOR-swizzled by
// 16-byte chunk so ldmatrix is conflict-free. S = q'k^T and O += P V run
// on the bf16 tensor cores through mma.sync.m16n8k16 with f32
// accumulators; exp2 and the bf16 rounding of P happen in registers, and
// the S accumulators are re-packed as the A fragments of the PV product
// without touching shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace lsx;

constexpr int FA_D = 64;        // head dim
constexpr int FA_BQ = 64;       // queries per block
constexpr int FA_BK = 64;       // kv rows per tile
constexpr int FA_WARPS = 4;     // 16 query rows each
constexpr int FA_THREADS = FA_WARPS * 32;

__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_bthd(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ l2, int T,
               int H, Strides qs, Strides ks, Strides vs, Strides os,
               float scale2) {
  __shared__ __align__(128) __nv_bfloat16 sQ[FA_BQ * FA_D];
  __shared__ __align__(128) __nv_bfloat16 sK[2][FA_BK * FA_D];
  __shared__ __align__(128) __nv_bfloat16 sV[2][FA_BK * FA_D];

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* kh = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vh = v + b * vs.b + h * vs.h;
  const int n_kv = (T + FA_BK - 1) / FA_BK;

  // first kv tile in flight while q is staged
  load_rows64<FA_THREADS>(sK[0], kh, ks.t, 0, T);
  load_rows64<FA_THREADS>(sV[0], vh, vs.t, 0, T);
  cp_async_commit();

  // q' = bf16(q * bf16(scale log2 e)); rows past T are zero
  {
    const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int i = 0; i < (FA_BQ * FA_D / 8) / FA_THREADS; ++i) {
      const int cid = threadIdx.x + i * FA_THREADS;
      const int r = cid >> 3;
      const int c = (cid & 7) << 3;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < T) {
        raw = *reinterpret_cast<const uint4*>(qh + (long long)(q0 + r) * qs.t
                                              + c);
      }
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        p2[e] = __floats2bfloat162_rn(f.x * scale2, f.y * scale2);
      }
      *reinterpret_cast<uint4*>(sQ + swz(r, c)) = raw;
    }
  }
  __syncthreads();

  // this warp's 16 q rows as A fragments over the 4 k-steps of D
  const int mat = lane >> 3;
  const int mr = lane & 7;
  unsigned qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int row = warp * 16 + mr + (mat & 1) * 8;
    const int col = kk * 16 + (mat >> 1) * 8;
    ldmatrix_x4(qa[kk], sQ + swz(row, col));
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float lsum0 = 0.f, lsum1 = 0.f;  // rows g and g + 8 of this warp
  const int tq = lane & 3;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      load_rows64<FA_THREADS>(sK[buf ^ 1], kh, ks.t, (j + 1) * FA_BK, T);
      load_rows64<FA_THREADS>(sV[buf ^ 1], vh, vs.t, (j + 1) * FA_BK, T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = q' k^T for this warp's 16 rows x 64 kv columns
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        const int row = np * 16 + mr + (mat >> 1) * 8;
        const int col = kk * 16 + (mat & 1) * 8;
        ldmatrix_x4(bk, sK[buf] + swz(row, col));
        mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // P = bf16(exp2(S)), zero past T; the normalizer sums P itself
    const int kv0 = j * FA_BK;
    const bool tail = kv0 + FA_BK > T;
    unsigned pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[n][e]);
        if (tail && kv0 + n * 8 + 2 * tq + (e & 1) >= T) p[e] = 0.f;
      }
      const unsigned lo = pack_bf16(p[0], p[1]);
      const unsigned hi = pack_bf16(p[2], p[3]);
      const float2 flo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&lo));
      const float2 fhi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi));
      lsum0 += flo.x + flo.y;
      lsum1 += fhi.x + fhi.y;
      // n-tile n holds kv columns 8n..8n+7: the A fragment of k-step n/2
      pa[n >> 1][(n & 1) * 2 + 0] = lo;
      pa[n >> 1][(n & 1) * 2 + 1] = hi;
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bv[4];
        const int row = kk * 16 + mr + (mat & 1) * 8;
        const int col = np * 16 + (mat >> 1) * 8;
        ldmatrix_x4_trans(bv, sV[buf] + swz(row, col));
        mma_bf16(acc[2 * np], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  // the quad of a row holds its partial sums
  lsum0 += __shfl_xor_sync(0xffffffffu, lsum0, 1);
  lsum0 += __shfl_xor_sync(0xffffffffu, lsum0, 2);
  lsum1 += __shfl_xor_sync(0xffffffffu, lsum1, 1);
  lsum1 += __shfl_xor_sync(0xffffffffu, lsum1, 2);
  const float l0 = fmaxf(lsum0, 1e-30f);
  const float l1 = fmaxf(lsum1, 1e-30f);

  const int g = lane >> 2;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = n * 8 + 2 * tq;
    if (r0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r0 * os.t + d) =
          __floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0);
    }
    if (r1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r1 * os.t + d) =
          __floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1);
    }
  }
  if (tq == 0) {
    float* lrow = l2 + ((long long)b * H + h) * T;
    if (r0 < T) lrow[r0] = log2f(l0);
    if (r1 < T) lrow[r1] = log2f(l1);
  }
}

}  // namespace

// o [B, T, H, 64] bf16 and l2 [B*H, T] f32 from q, k, v [B, T, H, 64]
// bf16 given by their (b, t, h) element strides (head-dim stride 1, rows
// 16-byte aligned; the wrapper checks). scale2 is bf16(scale * log2 e)
// as a float.
extern "C" int lsx_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* l2, int B,
    int T, int H, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh, float scale2,
    cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  const dim3 grid((T + FA_BQ - 1) / FA_BQ, H, B);
  flash_fwd_bthd<<<grid, FA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(l2), T, H, Strides{qsb, qst, qsh},
      Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, Strides{osb, ost, osh},
      scale2);
  LSX_CHECK_LAUNCH();
  return 0;
}
