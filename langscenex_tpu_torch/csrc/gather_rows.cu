// Row gather, kernel K13c: out[a] = tab[idx[a]] for a table [R, W] of f32
// or bf16 held in device memory (it fits the 50 MB L2 at the probe's size,
// Hopper's place for the TPU's VMEM-resident table) and int32 indices [A].
//
// Replaces: experiments/ab_gather2.py:63 kern inside pallas_gather (:54,
// call :68), the in-kernel counterpart of the XLA row gather that the same
// file sweeps (xla_gather, :40). The TPU kernel's grid over A/512 chunks
// of indices is its VMEM blocking; here the wrapper keeps A % 512 == 0 as
// the contract and the kernel does not need it.
//
// Out-of-range indices follow jnp.take's default "fill" mode, which the
// TPU kernel calls: an index in [-R, 0) counts from the end (i + R), any
// other outside [0, R) gives a row of NaN. One compare per row, and no
// read outside the table.
//
// Bound on the H100: bytes. At the probe's A = 640,000, W = 24, f32:
// 61.44 MB written, 2.56 MB of indices and 9.60 MB of table read once,
// 22.0 us at 3.35 TB/s (11.4 us in bf16). The rows are random, so each
// one is its own 96-byte (48 in bf16) piece of the table.
//
// Design (simple and right first): one thread per 16-byte vector of the
// output when a row is a whole number of vectors and the table 16-byte
// aligned (f32 W = 8, 24, 128; bf16 W = 8, 24, 128), else one thread per
// element. Neighbouring threads write neighbouring addresses, so the
// stores coalesce; the V threads of a row read its index once each
// (broadcast within the warp) and its V vectors side by side.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int GR_THREADS = 256;
constexpr unsigned GR_NAN_F32 = 0x7fc00000u;  // a quiet NaN as f32 bits
constexpr unsigned GR_NAN_BF16X2 = 0x7fc07fc0u;  // and as two bf16

// idx wrapped as jnp.take wraps it: i in [-R, 0) -> i + R; the result is
// a row of the table iff it lies in [0, R)
__device__ __forceinline__ int wrap_index(int i, int R) {
  return i < 0 ? i + R : i;
}

// one thread per 16-byte vector; vec_per_row vectors per row
__global__ void __launch_bounds__(GR_THREADS)
gather_rows_vec(const uint4* __restrict__ tab, const int* __restrict__ idx,
                uint4* __restrict__ out, long long n_vec, int vec_per_row,
                int R, unsigned fill) {
  const long long i = blockIdx.x * (long long)GR_THREADS + threadIdx.x;
  if (i >= n_vec) return;
  const long long a = i / vec_per_row;
  const int c = static_cast<int>(i - a * vec_per_row);
  const int j = wrap_index(__ldg(idx + a), R);
  uint4 v = make_uint4(fill, fill, fill, fill);
  if (static_cast<unsigned>(j) < static_cast<unsigned>(R)) {
    v = __ldg(tab + (long long)j * vec_per_row + c);
  }
  out[i] = v;
}

// one thread per element of ELEM bytes (4: f32, 2: bf16)
template <typename ELEM>
__global__ void __launch_bounds__(GR_THREADS)
gather_rows_elem(const ELEM* __restrict__ tab, const int* __restrict__ idx,
                 ELEM* __restrict__ out, long long n, int W, int R,
                 ELEM fill) {
  const long long i = blockIdx.x * (long long)GR_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long a = i / W;
  const int c = static_cast<int>(i - a * W);
  const int j = wrap_index(__ldg(idx + a), R);
  out[i] = static_cast<unsigned>(j) < static_cast<unsigned>(R)
               ? tab[(long long)j * W + c]
               : fill;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + GR_THREADS - 1) / GR_THREADS);
}

}  // namespace

// out [A, W] from tab [R, W] (contiguous, elem_bytes 4 for f32 or 2 for
// bf16) and idx [A] int32 (contiguous); out is contiguous.
extern "C" int lsx_gather_rows(const void* tab, const void* idx, void* out,
                               int R, int W, int A, int elem_bytes,
                               cudaStream_t stream) {
  if (A == 0 || W == 0) return 0;
  const long long row_bytes = (long long)W * elem_bytes;
  const bool vec = row_bytes % 16 == 0
                   && reinterpret_cast<std::uintptr_t>(tab) % 16 == 0
                   && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int* ix = static_cast<const int*>(idx);
  if (vec) {
    const int vec_per_row = static_cast<int>(row_bytes / 16);
    const long long n_vec = (long long)A * vec_per_row;
    gather_rows_vec<<<blocks_for(n_vec), GR_THREADS, 0, stream>>>(
        static_cast<const uint4*>(tab), ix, static_cast<uint4*>(out), n_vec,
        vec_per_row, R, elem_bytes == 4 ? GR_NAN_F32 : GR_NAN_BF16X2);
  } else if (elem_bytes == 4) {
    const long long n = (long long)A * W;
    gather_rows_elem<unsigned><<<blocks_for(n), GR_THREADS, 0, stream>>>(
        static_cast<const unsigned*>(tab), ix, static_cast<unsigned*>(out), n,
        W, R, GR_NAN_F32);
  } else {
    const long long n = (long long)A * W;
    gather_rows_elem<unsigned short>
        <<<blocks_for(n), GR_THREADS, 0, stream>>>(
            static_cast<const unsigned short*>(tab), ix,
            static_cast<unsigned short*>(out), n, W, R,
            static_cast<unsigned short>(GR_NAN_BF16X2 & 0xffffu));
  }
  LSX_CHECK_LAUNCH();
  return 0;
}
