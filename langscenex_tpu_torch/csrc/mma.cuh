// Tensor-core and async-copy helpers of the mma.sync attention forward
// (K5, K6 in flash_attention.cu): cp.async staging of 64-column
// bf16 tiles into XOR-swizzled shared memory, ldmatrix loads of mma
// fragments, and the bf16 mma.sync.m16n8k16 with f32 accumulators.
//
// Fragment layouts of m16n8k16 (g = lane / 4, tq = lane % 4):
//   A (16x16, row): a0 (row g, cols 2tq..2tq+1), a1 (row g+8, same cols),
//                   a2 (row g, cols 8+2tq..), a3 (row g+8, cols 8+2tq..)
//   B (16x8, col):  b0 (k rows 2tq..2tq+1, col g), b1 (k rows 8+2tq.., g)
//   C (16x8):       c0, c1 (row g, cols 2tq, 2tq+1), c2, c3 (row g+8)
// so an accumulator tile over n-tiles 2kk and 2kk+1, packed to bf16
// pairs, is the A fragment of k-step kk of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lsx {

constexpr int TILE_COLS = 64;  // columns of a staged tile (the head dim)

// (b, t, h) element strides of a [B, T, H, 64] operand whose head-dim
// stride is 1
struct Strides {
  long long b, t, h;
};

// element offset of (row, col) in a [rows][64] bf16 tile whose 16-byte
// chunks are XOR-swizzled by row, so ldmatrix is free of bank conflicts
__device__ __forceinline__ int swz(int row, int col) {
  return row * TILE_COLS + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Stage rows [row0, row0 + 64) of a [T, 64] bf16 head (row stride
// stride_t elements, 16-byte aligned rows) into a swizzled [64][64] tile
// with a block of THREADS threads; rows >= T are zero-filled.
template <int THREADS>
__device__ __forceinline__ void load_rows64(__nv_bfloat16* dst,
                                            const __nv_bfloat16* head,
                                            long long stride_t, int row0,
                                            int T) {
#pragma unroll
  for (int i = 0; i < (64 * TILE_COLS / 8) / THREADS; ++i) {
    const int cid = threadIdx.x + i * THREADS;
    const int r = cid >> 3;
    const int c = (cid & 7) << 3;
    const bool ok = row0 + r < T;
    const __nv_bfloat16* src = ok ? head + (long long)(row0 + r) * stride_t + c
                                  : head;
    cp_async16(dst + swz(r, c), src, ok);
  }
}

}  // namespace lsx
