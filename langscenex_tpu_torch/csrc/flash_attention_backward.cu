// Fused attention backward in the [B, T, H, D] layout, kernel K7: dq, dk
// and dv in one kernel, queries q [B, T, H, D] and keys k, v [B, Tk, H, D]
// with a key length Tk that may differ from T.
//
// Replaces: langscenex_tpu/ops/flash_attention.py:360 _bwd_fused_kernel_t
// (called through _flash_bwd_core, :468, fused branch :486-537, from the
// backward rule of attention_bthd). It is the gradient of K5 and keeps the
// TPU kernel's rounding points. It also serves K12, the split backward
// kernels of _flash_bwd_core: :208 _bwd_dq_kernel with :241
// _bwd_dkv_kernel (calls :581, :638; the backward of the online-softmax
// forward K9, and of K10) and :281 _bwd_dq_kernel_t with :320
// _bwd_dkv_kernel_t (calls :546, :599; FUSED_BWD off). Each pair computes
// this kernel's function from the l2 it is given, recomputing s and dp in
// both passes; K9's l2 = m + log2 l is taken as K5's is. With q' =
// bf16(q * bf16(scale * log2 e)) (scaled by the caller, as the JAX package
// does in XLA), l2 from the forward and dvec = sum_d do * o in f32 (also
// from the caller):
//   s  = k . q'  (f32)        p  = exp2(s - l2)   (0 past T or Tk)
//   dp = v . do  (f32)        ds = bf16(p * (dp - dvec))
//   dv = sum_q bf16(p) do     dk = (sum_q ds q') / log2 e
//   dq = scale * sum_k ds k
// dk and dv are accumulated in f32 registers and written in bf16; dq is
// accumulated in a caller-zeroed f32 [B, T, H, 64] buffer with atomics.
//
// Bound on the H100: operations. At the LoRA step's shape (q, k, v
// [1, 17776, 48, 64] bf16) one call does 5 products of 2 T Tk D H =
// 9.71 TFLOP: 9.8 ms at 989 TFLOP/s, against about 1 GB of operands and
// results (0.3 ms at 3.35 TB/s). Its 1.52e10 exp2s take about 7 ms of SFU
// time besides (16 ex2/clk/SM).
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work). The TPU kernel runs its grid in order and carries dq in
// HBM from one key block to the next; here blocks run in parallel, so
// each block owns one (b, h, 64-key tile of Tk) and walks all 64-query
// tiles of T:
// its k and v stay in shared memory and its dk, dv in registers, and its
// share of dq goes out through f32 atomicAdd (summation order varies from
// run to run). Blocks of one head start their walk at different query
// tiles, so they do not all add into the same dq rows at once. Each of
// the 4 warps owns 16 key rows. Per query tile, q' and do tiles, l2 and
// dvec arrive by cp.async, double-buffered, rows past T zero-filled.
// S^T = k q'^T and dP^T = v do^T run on the bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulate); p and ds are formed in registers
// and re-packed as the A fragments of dV += P^T do and dK += dS^T q'
// without a trip through shared memory; dS^T goes to shared memory once
// so that each warp can form 16 query rows of dq = dS k.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace lsx;

constexpr int BW_D = 64;       // head dim
constexpr int BW_BK = 64;      // keys per block
constexpr int BW_BQ = 64;      // queries per step
constexpr int BW_WARPS = 4;    // 16 key rows each
constexpr int BW_THREADS = BW_WARPS * 32;
constexpr float BW_LN2 = 0.6931471805599453f;  // 1 / log2(e)

struct BwdSmem {
  __nv_bfloat16 k[BW_BK * BW_D];
  __nv_bfloat16 v[BW_BK * BW_D];
  __nv_bfloat16 ds[BW_BK * BW_BQ];         // dS^T of the current step
  __nv_bfloat16 q[2][BW_BQ * BW_D];        // q' tiles
  __nv_bfloat16 dout[2][BW_BQ * BW_D];     // do tiles
  float l2[2][BW_BQ];
  float dvec[2][BW_BQ];
};

// Stage query tile qt of one head: q' and do rows, l2 and dvec.
__device__ __forceinline__ void load_query_tile(
    BwdSmem& sm, int buf, const __nv_bfloat16* qh, long long q_st,
    const __nv_bfloat16* doh, long long do_st, const float* l2h,
    const float* dvech, int qt, int T) {
  const int q0 = qt * BW_BQ;
  load_rows64<BW_THREADS>(sm.q[buf], qh, q_st, q0, T);
  load_rows64<BW_THREADS>(sm.dout[buf], doh, do_st, q0, T);
  const int i = threadIdx.x & (BW_BQ - 1);
  const bool ok = q0 + i < T;
  if (threadIdx.x < BW_BQ) {
    cp_async4(&sm.l2[buf][i], ok ? l2h + q0 + i : l2h, ok);
  } else {
    cp_async4(&sm.dvec[buf][i], ok ? dvech + q0 + i : dvech, ok);
  }
}

__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_bthd(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ l2, const float* __restrict__ dvec,
               float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int T, int Tk, int H,
               Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);

  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = kb * BW_BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3;
  const int mr = lane & 7;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kh = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vh = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* doh = dout + b * dos.b + h * dos.h;
  const float* l2h = l2 + bh * T;
  const float* dvech = dvec + bh * T;
  const int nq = (T + BW_BQ - 1) / BW_BQ;
  const int first = kb % nq;

  load_rows64<BW_THREADS>(sm.k, kh, ks.t, key0, Tk);
  load_rows64<BW_THREADS>(sm.v, vh, vs.t, key0, Tk);
  load_query_tile(sm, 0, qh, qs.t, doh, dos.t, l2h, dvech, first, T);
  cp_async_commit();

  // this thread's key rows (as accumulator rows) and whether they exist
  const int krow = warp * 16 + g;
  const bool key_ok0 = key0 + krow < Tk;
  const bool key_ok1 = key0 + krow + 8 < Tk;

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int j = 0; j < nq; ++j) {
    const int buf = j & 1;
    const int qt = (first + j) % nq;
    if (j + 1 < nq) {
      load_query_tile(sm, buf ^ 1, qh, qs.t, doh, dos.t, l2h, dvech,
                      (first + j + 1) % nq, T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = qt * BW_BQ;

    // S^T = k q'^T and dP^T = v do^T: this warp's 16 keys x 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ka[4], va[4];
      const int arow = warp * 16 + mr + (mat & 1) * 8;
      const int acol = kk * 16 + (mat >> 1) * 8;
      ldmatrix_x4(ka, sm.k + swz(arow, acol));
      ldmatrix_x4(va, sm.v + swz(arow, acol));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bq[4], bo[4];
        const int row = np * 16 + mr + (mat >> 1) * 8;
        const int col = kk * 16 + (mat & 1) * 8;
        ldmatrix_x4(bq, sm.q[buf] + swz(row, col));
        ldmatrix_x4(bo, sm.dout[buf] + swz(row, col));
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp2(S^T - l2), dS^T = bf16(P^T (dP^T - dvec)), both 0 for
    // keys past Tk or queries past T; packed as A fragments over the
    // query axis
    const bool q_tail = q0 + BW_BQ > T;
    unsigned pa[4][4], da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * tq + (e & 1);
        const bool ok = (e < 2 ? key_ok0 : key_ok1)
                        && (!q_tail || q0 + qc < T);
        p[e] = ok ? exp2f(s[n][e] - sm.l2[buf][qc]) : 0.f;
        d[e] = p[e] * (dp[n][e] - sm.dvec[buf][qc]);
      }
      const int slot = (n & 1) * 2;
      pa[n >> 1][slot] = pack_bf16(p[0], p[1]);
      pa[n >> 1][slot + 1] = pack_bf16(p[2], p[3]);
      da[n >> 1][slot] = pack_bf16(d[0], d[1]);
      da[n >> 1][slot + 1] = pack_bf16(d[2], d[3]);
      *reinterpret_cast<unsigned*>(sm.ds + swz(krow, n * 8 + 2 * tq)) =
          da[n >> 1][slot];
      *reinterpret_cast<unsigned*>(sm.ds + swz(krow + 8, n * 8 + 2 * tq)) =
          da[n >> 1][slot + 1];
    }

    // dV += bf16(P^T) do and dK += dS^T q' over this step's 64 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bo[4], bq[4];
        const int row = kk * 16 + mr + (mat & 1) * 8;
        const int col = np * 16 + (mat >> 1) * 8;
        ldmatrix_x4_trans(bo, sm.dout[buf] + swz(row, col));
        ldmatrix_x4_trans(bq, sm.q[buf] + swz(row, col));
        mma_bf16(dv_acc[2 * np], pa[kk], bo[0], bo[1]);
        mma_bf16(dv_acc[2 * np + 1], pa[kk], bo[2], bo[3]);
        mma_bf16(dk_acc[2 * np], da[kk], bq[0], bq[1]);
        mma_bf16(dk_acc[2 * np + 1], da[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // dS^T complete in shared memory

    // dq for this warp's 16 queries: scale * dS k over the block's keys;
    // the A fragment (queries x keys) is dS^T read transposed
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned a[4];
      ldmatrix_x4_trans(a, sm.ds + swz(kk * 16 + mr + (mat >> 1) * 8,
                                       warp * 16 + (mat & 1) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldmatrix_x4_trans(bk, sm.k + swz(kk * 16 + mr + (mat & 1) * 8,
                                         np * 16 + (mat >> 1) * 8));
        mma_bf16(acc[2 * np], a, bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    const int r0 = q0 + warp * 16 + g;
    const int r1 = r0 + 8;
    float* dq0 = dq + (((long long)b * T + r0) * H + h) * BW_D;
    float* dq1 = dq0 + 8LL * H * BW_D;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = n * 8 + 2 * tq;
      if (r0 < T) {
        atomicAdd(dq0 + d, scale * acc[n][0]);
        atomicAdd(dq0 + d + 1, scale * acc[n][1]);
      }
      if (r1 < T) {
        atomicAdd(dq1 + d, scale * acc[n][2]);
        atomicAdd(dq1 + d + 1, scale * acc[n][3]);
      }
    }
    __syncthreads();  // buffers and dS^T free for the next step
  }

  // dk = acc / log2 e and dv, in bf16, into contiguous [B, Tk, H, 64]
  const long long row_stride = (long long)H * BW_D;
  const long long base0 = (((long long)b * Tk + key0 + krow) * H + h) * BW_D;
  const long long base1 = base0 + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = n * 8 + 2 * tq;
    if (key_ok0) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base0 + d) =
          __floats2bfloat162_rn(dk_acc[n][0] * BW_LN2, dk_acc[n][1] * BW_LN2);
      *reinterpret_cast<__nv_bfloat162*>(dv + base0 + d) =
          __floats2bfloat162_rn(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_ok1) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base1 + d) =
          __floats2bfloat162_rn(dk_acc[n][2] * BW_LN2, dk_acc[n][3] * BW_LN2);
      *reinterpret_cast<__nv_bfloat162*>(dv + base1 + d) =
          __floats2bfloat162_rn(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

}  // namespace

// dq [B, T, H, 64] f32 (zeroed by the caller; accumulated), dk and dv
// [B, Tk, H, 64] bf16 (contiguous, written) from q' (q already scaled by
// bf16(scale * log2 e)) and do [B, T, H, 64], k and v [B, Tk, H, 64] bf16
// given by their (b, t, h) element strides (head-dim stride 1, rows
// 16-byte aligned; the wrapper checks), and l2, dvec [B * H, T] f32.
extern "C" int lsx_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* l2, const void* dvec, void* dq, void* dk, void* dv, int B,
    int T, int Tk, int H, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, long long dsb, long long dst, long long dsh, float scale,
    cudaStream_t stream) {
  if (B == 0 || Tk == 0 || H == 0) return 0;
  if (T == 0) {  // no queries: dk and dv are zero
    const size_t bytes = (size_t)B * Tk * H * BW_D * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, stream);
    return (int)err;
  }
  const int smem = (int)sizeof(BwdSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_bthd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BW_BK - 1) / BW_BK, H, B);
  flash_bwd_bthd<<<grid, BW_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(l2), static_cast<const float*>(dvec),
      static_cast<float*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, Tk, H, Strides{qsb, qst, qsh},
      Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, Strides{dsb, dst, dsh},
      scale);
  LSX_CHECK_LAUNCH();
  return 0;
}
