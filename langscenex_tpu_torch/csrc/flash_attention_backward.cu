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
// accumulated in a caller-zeroed f32 [B, H, T, 64] buffer by bulk tensor
// reductions (summation order varies from run to run).
//
// Bound on the H100: operations. At the LoRA step's shape (q, k, v
// [1, 17776, 48, 64] bf16) one call does 5 products of 2 T Tk D H =
// 9.707 TFLOP: 9.8 ms at 989 TFLOP/s, against about 1 GB of operands and
// results (0.3 ms at 3.35 TB/s).
//
// Design (FlashAttention-3's backward in structure, Shah et al. 2024).
// Blocks run in parallel, so each block owns one (b, h, 128-key tile of
// Tk) and walks all 64-query tiles of T, starting at a tile that differs
// between the key tiles of one head so that their dq reductions spread
// over the rows. Three warpgroups:
// - a producer, cut to 24 registers by setmaxnreg, whose one thread loads
//   k and v once and then a ring of 3 stages of (q', do, l2, dvec) by TMA
//   (4-D tensor maps over (D, T, H, B) built from the caller's strides, so
//   contiguous operands and [B, H, T, D] views load alike; 128-byte
//   swizzle, which is wgmma's canonical layout for 64-wide bf16 rows; rows
//   past T or Tk arrive as zeros) and 256-byte bulk copies, completed on
//   mbarrier transaction counts; the consumers free a stage by arriving on
//   its empty barrier;
// - two consumers of 64 keys each, raised to 240 registers. Per query
//   tile: S^T = K Q'^T and dP^T = V dO^T by wgmma.m64n64k16 from shared
//   memory; P^T and dS^T formed in registers, masked by index, and
//   re-packed as the register A operand of dV += bf16(P^T) dO and
//   dK += dS^T Q' (dO and Q' read transposed from the same tiles); dS^T
//   staged once in shared memory, so that dQ = dS K is a third product
//   with both operands transposed. Each consumer sums dQ over its 64 keys
//   into a 16 KB f32 tile in shared memory (swizzled, so the stores are
//   free of bank conflicts; two per consumer, alternating) and one of its
//   threads adds the tile to dq with two bulk tensor reductions
//   (cp.reduce.async.bulk.tensor ... add.f32), in place of 32 f32 atomics
//   per thread and step. The next tile's S^T and dP^T are issued before
//   that, so the tensor cores work while the tile goes out.
// Measured on the H100 (PERF.md): exp2f's subnormal path cost 8 ms at the
// LoRA shape, hence ex2.approx.ftz; the consumers handing one dq tile
// between them cost more than the second reduction each now issues.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace lsx::sm90;

constexpr int BW_D = 64;         // head dim
constexpr int BW_BK = 128;       // keys per block, 64 per consumer
constexpr int BW_BQ = 64;        // queries per step
constexpr int BW_STAGES = 3;     // query tiles in flight
constexpr int BW_CONSUMERS = 256;
constexpr int BW_THREADS = BW_CONSUMERS + 128;
constexpr uint32_t STAGE_BYTES = 2 * BW_BQ * BW_D * 2 + 2 * BW_BQ * 4;
constexpr float BW_LN2 = 0.6931471805599453f;  // 1 / log2(e)

struct __align__(1024) BwdSmem {
  __nv_bfloat16 k[BW_BK * BW_D];
  __nv_bfloat16 v[BW_BK * BW_D];
  __nv_bfloat16 q[BW_STAGES][BW_BQ * BW_D];     // q' tiles
  __nv_bfloat16 dout[BW_STAGES][BW_BQ * BW_D];  // do tiles
  __nv_bfloat16 ds[BW_BK * BW_BQ];              // dS^T, [key][query]
  float dq[2][2][BW_BQ * BW_D];  // per consumer, two [64][32] halves each
  float l2[BW_STAGES][BW_BQ];
  float dvec[BW_STAGES][BW_BQ];
  uint64_t kv_bar;
  uint64_t full[BW_STAGES];
  uint64_t empty[BW_STAGES];
};

// S^T = K Q'^T and dP^T = V dO^T of one stage, issued as one wgmma group
__device__ __forceinline__ void issue_s_dp(float (&sacc)[32],
                                           float (&pacc)[32],
                                           const __nv_bfloat16* kw,
                                           const __nv_bfloat16* vw,
                                           const __nv_bfloat16* qs,
                                           const __nv_bfloat16* dos) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0, 0>(sacc, desc128(kw + kk * 16), desc128(qs + kk * 16), kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0, 0>(pacc, desc128(vw + kk * 16), desc128(dos + kk * 16), kk);
  wgmma_commit();
}

__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dq_map,
                const float* __restrict__ aux, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int T, int Tk, int H, int Tp,
                float scale) {
  extern __shared__ unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = kb * BW_BK;
  const int nq = (T + BW_BQ - 1) / BW_BQ;
  const int first = kb % nq;
  const int bh = b * H + h;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_bar, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], BW_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer -------------------------------------------------------
    reg_dealloc<24>();
    if (threadIdx.x == BW_CONSUMERS) {
      mbar_expect_tx(&sm.kv_bar, 2 * BW_BK * BW_D * 2);
      tma_load_4d(sm.k, &k_map, 0, key0, h, b, &sm.kv_bar);
      tma_load_4d(sm.v, &v_map, 0, key0, h, b, &sm.kv_bar);
      const float* l2h = aux + (size_t)bh * Tp;
      const float* dvech = aux + ((size_t)gridDim.y * gridDim.z + bh) * Tp;
      for (int j = 0; j < nq; ++j) {
        const int s = j % BW_STAGES;
        if (j >= BW_STAGES) mbar_wait(&sm.empty[s], (j / BW_STAGES - 1) & 1);
        const int q0 = ((first + j) % nq) * BW_BQ;
        mbar_expect_tx(&sm.full[s], STAGE_BYTES);
        tma_load_4d(sm.q[s], &q_map, 0, q0, h, b, &sm.full[s]);
        tma_load_4d(sm.dout[s], &do_map, 0, q0, h, b, &sm.full[s]);
        bulk_load(sm.l2[s], l2h + q0, BW_BQ * 4, &sm.full[s]);
        bulk_load(sm.dvec[s], dvech + q0, BW_BQ * 4, &sm.full[s]);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----------------------------------------
    reg_alloc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int row0 = warp * 16 + (lane >> 2);  // accumulator rows row0, +8
    const int krow0 = key0 + wg * 64 + row0;
    const bool kok0 = krow0 < Tk;
    const bool kok1 = krow0 + 8 < Tk;
    const __nv_bfloat16* kw = sm.k + wg * 64 * BW_D;
    const __nv_bfloat16* vw = sm.v + wg * 64 * BW_D;
    unsigned char* dsw = reinterpret_cast<unsigned char*>(sm.ds) + wg * 8192;

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(&sm.kv_bar, 0);

    // step j + 1's S^T and dP^T are issued before step j's dq tile goes
    // out, so that the tensor cores work meanwhile
    float sacc[32], pacc[32];
    mbar_wait(&sm.full[0], 0);
    issue_s_dp(sacc, pacc, kw, vw, sm.q[0], sm.dout[0]);
    for (int j = 0; j < nq; ++j) {
      const int s = j % BW_STAGES;
      const int q0 = ((first + j) % nq) * BW_BQ;
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);

      // P^T = exp2(S^T - l2), dS^T = bf16(P^T (dP^T - dvec)), 0 for keys
      // past Tk or queries past T; packed as register A operands over the
      // query axis, dS^T also staged swizzled in shared memory. The exp
      // flushes subnormal results to 0: a p below 2^-126 adds nothing a
      // bf16 ds or dv can hold next to the row's p of order 1
      const bool q_tail = q0 + BW_BQ > T;
      uint32_t pa[16], da[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * i + 2 * tq + (e & 1);
          const bool ok = (e < 2 ? kok0 : kok1) && (!q_tail || q0 + c < T);
          const float pe = exp2_ftz(sacc[4 * i + e] - sm.l2[s][c]);
          p[e] = ok ? pe : 0.f;
          d[e] = ok ? pe * (pacc[4 * i + e] - sm.dvec[s][c]) : 0.f;
        }
        pa[2 * i] = pack_bf16(p[0], p[1]);
        pa[2 * i + 1] = pack_bf16(p[2], p[3]);
        da[2 * i] = pack_bf16(d[0], d[1]);
        da[2 * i + 1] = pack_bf16(d[2], d[3]);
        *reinterpret_cast<uint32_t*>(dsw + swz128(row0, 8 * i + 2 * tq)) =
            da[2 * i];
        *reinterpret_cast<uint32_t*>(dsw + swz128(row0 + 8, 8 * i + 2 * tq)) =
            da[2 * i + 1];
      }

      // dV += bf16(P^T) dO and dK += dS^T Q' over this tile's queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dv_acc, pa + 4 * kk, desc128(sm.dout[s] + kk * 16 * BW_D));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dk_acc, da + 4 * kk, desc128(sm.q[s] + kk * 16 * BW_D));
      wgmma_commit();

      // this consumer's part of dQ = dS K, over its 64 keys
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      float qacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(qacc, desc128(dsw + kk * 2048),
                       desc128(kw + kk * 16 * BW_D), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(qacc);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      mbar_arrive(&sm.empty[s]);

      // this consumer's part of the dq tile goes out on its own: stored
      // swizzled in shared memory, then added to dq by two bulk tensor
      // reductions (rows past T skipped) that one thread issues while the
      // tensor cores start on the next tile's S^T and dP^T
      unsigned char* dqb = reinterpret_cast<unsigned char*>(sm.dq[wg][j & 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = 8 * i + 2 * tq;
          *reinterpret_cast<float2*>(dqb + (c >> 5) * 8192
                                     + swz128_f32(row0 + 8 * half, c & 31)) =
              make_float2(scale * qacc[4 * i + 2 * half],
                          scale * qacc[4 * i + 2 * half + 1]);
        }
      }
      if (j + 1 < nq) {
        const int s1 = (j + 1) % BW_STAGES;
        mbar_wait(&sm.full[s1], ((j + 1) / BW_STAGES) & 1);
        issue_s_dp(sacc, pacc, kw, vw, sm.q[s1], sm.dout[s1]);
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if (tid == 0) {
        tma_reduce_add_3d(&dq_map, dqb, 0, q0, bh);
        tma_reduce_add_3d(&dq_map, dqb + 8192, 32, q0, bh);
        bulk_commit();
        bulk_wait_read<1>();  // this consumer's other buffer is free
      }
    }
    if (tid == 0) bulk_wait<0>();

    // dk = acc / log2 e and dv, in bf16, into contiguous [B, Tk, H, 64]
    const long long row_stride = (long long)H * BW_D;
    const long long base0 = (((long long)b * Tk + krow0) * H + h) * BW_D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * tq;
      if (kok0) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base0 + c) =
            __floats2bfloat162_rn(dk_acc[4 * i] * BW_LN2,
                                  dk_acc[4 * i + 1] * BW_LN2);
        *reinterpret_cast<__nv_bfloat162*>(dv + base0 + c) =
            __floats2bfloat162_rn(dv_acc[4 * i], dv_acc[4 * i + 1]);
      }
      if (kok1) {
        const long long at = base0 + 8 * row_stride + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[4 * i + 2] * BW_LN2,
                                  dk_acc[4 * i + 3] * BW_LN2);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
  }
}

// a 3-D map over the f32 dq scratch [B * H, T, 64], reducing boxes of
// 64 rows x 32 with the 128-byte swizzle
CUresult dq_map_of(EncodeTiled encode, CUtensorMap* map, void* dq, int BH,
                   int T) {
  const cuuint64_t dims[3] = {BW_D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {BW_D * 4, (cuuint64_t)T * BW_D * 4};
  const cuuint32_t box[3] = {32, BW_BQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dq, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// dq [B, H, T, 64] f32 (zeroed by the caller; accumulated), dk and dv
// [B, Tk, H, 64] bf16 (contiguous, written) from q' (q already scaled by
// bf16(scale * log2 e)) and do [B, T, H, 64], k and v [B, Tk, H, 64] bf16
// given by their (b, t, h) element strides (head-dim stride 1, strides
// multiples of 8 and 16-byte aligned bases; the wrapper checks), and aux
// [2, B * H, Tp] f32 holding l2 and then dvec, Tp = T rounded up to 64.
extern "C" int lsx_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* aux, void* dq, void* dk, void* dv, int B, int T, int Tk,
    int H, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    long long dsb, long long dst, long long dsh, float scale,
    cudaStream_t stream) {
  if (B == 0 || Tk == 0 || H == 0) return 0;
  if (T == 0) {  // no queries: dk and dv are zero
    const size_t bytes = (size_t)B * Tk * H * BW_D * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, stream);
    return (int)err;
  }
  // a missing entry point or a refused map returns its CUresult, whose
  // codes read as the cudaError_t of the same name
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  CUresult res = bthd_map(encode, &q_map, q, B, T, H, qsb, qst, qsh, BW_BQ);
  if (res == CUDA_SUCCESS)
    res = bthd_map(encode, &k_map, k, B, Tk, H, ksb, kst, ksh, BW_BK);
  if (res == CUDA_SUCCESS)
    res = bthd_map(encode, &v_map, v, B, Tk, H, vsb, vst, vsh, BW_BK);
  if (res == CUDA_SUCCESS)
    res = bthd_map(encode, &do_map, dout, B, T, H, dsb, dst, dsh, BW_BQ);
  if (res == CUDA_SUCCESS) res = dq_map_of(encode, &dq_map, dq, B * H, T);
  if (res != CUDA_SUCCESS) return (int)res;
  const int smem = (int)sizeof(BwdSmem) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int Tp = (T + BW_BQ - 1) / BW_BQ * BW_BQ;
  const dim3 grid((Tk + BW_BK - 1) / BW_BK, H, B);
  flash_bwd_wgmma<<<grid, BW_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, static_cast<const float*>(aux),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, Tk,
      H, Tp, scale);
  LSX_CHECK_LAUNCH();
  return 0;
}
