// Fused LayerNorm + per-stream adaLN modulation (CogVideoXLayerNormZero),
// kernel K8.
//
// Replaces: langscenex_tpu/ops/ln_modulate.py:31 _lnz_kernel (reached via
// _lnz_fwd_pallas, :67, from ln_modulate). Per row of x [B, T, H] bf16:
// f32 mean and E[x^2], var = max(E[x^2] - mean^2, 0) (flax's fast
// variance), n = (x - mean) * rsqrt(var + 1e-5), y = n * A + C with
// A = gamma (1 + scale), C = beta (1 + scale) + shift, where rows
// t < text_len take the text (scale, shift) of their batch row and later
// rows the video pair. Writes bf16.
//
// Bound on the H100: memory. At the DiT's shape (2 x 17,776 x 3,072) one
// call reads x and writes y, 2 x 218.4 MB = 437 MB: 0.130 ms at
// 3.35 TB/s. The arithmetic (about ten flops per element) is far below
// the card's rate.
//
// Design: one block of 128 threads per row. Each thread holds up to four
// 16-byte vectors of the row in registers, so x is read from device
// memory once; the two sums reduce by warp shuffles and one shared-memory
// step; gamma/beta and the row's (scale, shift) pair are read as
// 16-byte vectors (they are small and stay in L2 across rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int LNZ_THREADS = 128;
constexpr int LNZ_MAX_VEC = 4;  // 16-byte vectors per thread: H <= 4096
constexpr float LNZ_EPS = 1e-5f;

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return v;
}

__global__ void __launch_bounds__(LNZ_THREADS)
lnz_kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ gamma,
           const __nv_bfloat16* __restrict__ beta,
           const __nv_bfloat16* __restrict__ sc,
           const __nv_bfloat16* __restrict__ sh,
           const __nv_bfloat16* __restrict__ tsc,
           const __nv_bfloat16* __restrict__ tsh,
           __nv_bfloat16* __restrict__ y, int T, int H, int text_len) {
  __shared__ float red[2][LNZ_THREADS / 32];
  const long long row = blockIdx.x;
  const int b = (int)(row / T);
  const int t = (int)(row - (long long)b * T);
  const int nvec = H / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);

  uint4 v[LNZ_MAX_VEC];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < LNZ_MAX_VEC; ++i) {
    const int vi = threadIdx.x + i * LNZ_THREADS;
    if (vi < nvec) {
      v[i] = xr[vi];
      float f[8];
      unpack8(v[i], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s1 += f[k];
        s2 = fmaf(f[k], f[k], s2);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  s1 = 0.f;
  s2 = 0.f;
#pragma unroll
  for (int w = 0; w < LNZ_THREADS / 32; ++w) {
    s1 += red[0][w];
    s2 += red[1][w];
  }
  const float mean = s1 / (float)H;
  const float ex2 = s2 / (float)H;
  const float inv = rsqrtf(fmaxf(ex2 - mean * mean, 0.f) + LNZ_EPS);

  const bool text = t < text_len;
  const __nv_bfloat16* scr = (text ? tsc : sc) + (long long)b * H;
  const __nv_bfloat16* shr = (text ? tsh : sh) + (long long)b * H;
  uint4* yr = reinterpret_cast<uint4*>(y + row * H);
#pragma unroll
  for (int i = 0; i < LNZ_MAX_VEC; ++i) {
    const int vi = threadIdx.x + i * LNZ_THREADS;
    if (vi < nvec) {
      const int col = vi * 8;
      float f[8], g[8], be[8], s[8], h[8], out[8];
      unpack8(v[i], f);
      unpack8(*reinterpret_cast<const uint4*>(gamma + col), g);
      unpack8(*reinterpret_cast<const uint4*>(beta + col), be);
      unpack8(*reinterpret_cast<const uint4*>(scr + col), s);
      unpack8(*reinterpret_cast<const uint4*>(shr + col), h);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float one_sc = 1.f + s[k];
        const float A = g[k] * one_sc;
        const float C = be[k] * one_sc + h[k];
        out[k] = (f[k] - mean) * inv * A + C;
      }
      yr[vi] = pack8(out);
    }
  }
}

}  // namespace

// y[B, T, H] = LNZ(x) (see above). gamma/beta are [H], sc/sh/tsc/tsh
// [B, H], all bf16, contiguous and 16-byte aligned, H % 8 == 0 and
// H <= 4096 (the wrapper checks).
extern "C" int lsx_ln_modulate(const void* x, const void* gamma,
                               const void* beta, const void* sc,
                               const void* sh, const void* tsc,
                               const void* tsh, void* y, int B, int T, int H,
                               int text_len, cudaStream_t stream) {
  const long long rows = (long long)B * T;
  if (rows == 0) return 0;
  lnz_kernel<<<(unsigned)rows, LNZ_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const __nv_bfloat16*>(sc),
      static_cast<const __nv_bfloat16*>(sh),
      static_cast<const __nv_bfloat16*>(tsc),
      static_cast<const __nv_bfloat16*>(tsh),
      static_cast<__nv_bfloat16*>(y), T, H, text_len);
  LSX_CHECK_LAUNCH();
  return 0;
}
