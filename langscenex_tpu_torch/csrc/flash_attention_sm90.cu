// Flash-attention forward on Hopper (wgmma, TMA, warp specialisation):
// one device function templated on its softmax, on queries q [B, H, T, 64]
// and keys k, v [B, H, Tk, 64] read through element strides, so that
// transpose(1, 2) views of [B, T, H, 64] tensors, and the strided q, k, v
// views of one [B, T, 3, H, 64] tensor, load in place. Five modes:
// K5 and K6 (the bounded softmax, with l2), K9 (online softmax in the
// exp2 domain, with l2), K11 (online softmax in the natural-exp domain),
// K13a (K9's exp2 softmax with l from the unrounded p, no l2) and K13b
// (the exp2 softmax with p in packed bf16).
//
// K5 replaces: langscenex_tpu/ops/flash_attention.py:991
// _attn_kernel_nomax_t4 (called at :1071 from _flash_fwd_impl_bthd,
// through attention_bthd), on [B, T, H, 64] operands. K6 replaces :796
// _attn_kernel_nomax_t (called at :960 from _flash_fwd_impl_t, through
// flash_attention(bounded_logits=True) and attention_auto, on every shard
// of the tensor-parallel DiT), on [B, H, T, 64] ones with a key length Tk
// of their own; the lane-padded _attn_kernel_nomax (:82, K10) and the
// split-kv _attn_kernel_nomax_t2 and _t3 (:838, :873, K12) compute the same
// function and differ only in MXU scheduling, so K6's kernel serves them.
// K5 and K6 are one kernel with two tensor maps: on the same tensors they
// agree bit for bit. K9 replaces :32 _attn_kernel (called at :182 from
// _flash_fwd_impl, through flash_attention(bounded_logits=False) and
// attention_auto); its l2 is the residual that K7 reads in the split
// backward (K12). K11 replaces :676 _attn_kernel_h2 (called at :772 from
// flash_attention_h2); its head pairs packed block-diagonally keep the
// MXU's 128-deep contraction full and carry no function, so it is one head
// per block here. K13a replaces experiments/ab_attention2.py:46
// _exp2_kernel (call :96, from flash_exp2), K13b :129 _exp2_bf16_kernel
// (call :165, from flash_exp2_bf16). The rounding points are the TPU
// kernels', per tile of 128 keys:
//   bounded (K5, K6): q' = bf16(q * bf16(scale log2 e)), s = q' . k in
//     f32, p = exp2(s) with no running max (the DiT's qk-LayerNorm bounds
//     the logits), acc = acc + bf16(p) V, l = l + sum bf16(p), and
//     l2 = log2(max(l, 1e-30)) for rows < T;
// and, with a running row max m from -1e30:
//   natural (K11): q' = bf16(q * bf16(scale)), s = q' . k in f32,
//     m' = max(m, rowmax s), p = exp(s - m'), a = exp(m - m'),
//     acc = acc a + bf16(p) V, l = l a + sum p (the unrounded f32 p);
//   exp2 (K13a): K5's q', s and m' as above, p = exp2(s - m'),
//     a = exp2(m - m'), acc and l as K11's;
//   online (K9): K13a's, but l = l a + sum bf16(p), the P that enters the
//     product, and l2 = m + log2(max(l, 1e-30)) for rows < T;
//   exp2 bf16 (K13b): K13a's q', s and m', d = bf16(s - m'), p = exp2(d)
//     in bf16, two per ex2.approx.ftz.bf16x2, acc = acc a + p V,
//     l = l a + sum p (those bf16 p), a = exp2(m - m') in f32;
//   o = bf16(acc / max(l, 1e-30)), written for rows < T only.
// Every exp is one ex2.approx.ftz: of s (K5, K6), of s - m' (K9, K13a), of
// one FFMA, s log2 e - m' log2 e, in place of the library expf (K11; the
// FFMA's rounding moves p by under 2^-22 |s| of it, far inside a bf16
// ulp), or packed (K13b); subnormal p (below 2^-126) flush to 0, which
// moves a bounded row's l by under Tk 2^-126, and only where it is below
// 1e-30 anyway.
// Keys past Tk arrive as zero rows; every tile that holds them (the last,
// or a first one when Tk < 128) sets their s to -1e30, which makes their
// p 0: exp2(-1e30) in the bounded mode, exp(-1e30 - m') in the others (m'
// is the max of at least one real key, so a row whose logits are all
// below 0 does not take m = 0 from them).
//
// Bound on the H100: operations. At [1, 48, 17776, 64] one call does
// 4 H T Tk D = 3.88 TFLOP, 3.93 ms at 989 TFLOP/s, against 0.44 GB of q,
// k, v and o (K5 and K9 at the DiT's B = 2: twice both, 7.85 ms; K6 at a
// tensor-parallel shard of 24 heads and B = 2: 3.93 ms); its H T Tk =
// 1.52e10 exps take about as long on the SFU (16 ex2 per clock and SM),
// K13b's packed exps half of that. The bounded mode issues no exp for a
// rescale and no max.
//
// Design (FlashAttention-3's forward in structure, Shah et al. 2024):
// one block of three warpgroups per (b, h, 128-query tile):
// - a producer, cut to 24 registers by setmaxnreg, whose one thread loads
//   q once and then a ring of FW_STAGES stages of (k, v) tiles of 128
//   keys by TMA (4-D maps over (D, T, H, B), 128-byte swizzle, which is
//   wgmma's canonical layout for 64-wide bf16 rows), completed on
//   mbarrier transaction counts; the consumers free a stage by arriving
//   on its empty barrier once its V product is done;
// - two consumers of 64 query rows each, raised to 240 registers. Each
//   scales and rounds its q rows once from shared memory into the
//   register A operand of S = q' K^T (wgmma.m64n128k16, K as a K-major B);
//   P is re-packed from the S accumulator as the register A operand of
//   O += P V (wgmma.m64n64k16 over 8 k-steps, V as an MN-major B).
//   Per tile j a consumer issues S_j and, behind it, O's rescale and
//   P_{j-1} V_{j-1} as one turn, then runs tile j's softmax while both
//   products run; the two consumers take turns on two named barriers
//   (ping-pong, FlashAttention-3 §3.1), so that one warpgroup's exps run
//   on the SFU while the other's products run on the tensor cores.
// The bounded mode's and K9's l sum P itself, and the tensor cores sum it,
// as the TPU kernels do with their row or column of ones beside V: each
// k-step of P V also issues P times a K-major 128 x 8 tile of ones
// (wgmma.m64n8k16), whose accumulator holds every row's sum (rescaled
// with O's in K9; the bounded mode has no rescale). Rounding p
// to bf16 in f32 registers for an ALU sum instead (one cvt per pair, two
// ops to unpack, in the softmax between a consumer's products) made K9
// 7.5% slower (tools/ab_forward_sm90.py's variant lalu; PERF.md §6).
// Measured on the H100 (PERF.md §6; tools/ab_forward_sm90.py):
// ptxas serialises the products where it puts a wait in divergent code
// (C7518, 45% of K11), keeps S registers alive into the next S (C7511)
// or moves p out of them between two issues (C7513, 30% of K13b): hence
// the peeled tiles, the write-only first k-step and the f32 re-pack.
// Without the turns K11 is 24% slower; 3 stages beat 2 and 4; with no
// exp of the scores it is only 9-12% faster, with no K/V reads from L2
// no faster.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace lsx::sm90;

constexpr int FW_D = 64;          // head dim
constexpr int FW_BQ = 128;        // queries per block, 64 per consumer
constexpr int FW_BK = 128;        // keys per tile
constexpr int FW_STAGES = 3;      // (k, v) tiles in flight
constexpr int FW_CONSUMERS = 256;
constexpr int FW_THREADS = FW_CONSUMERS + 128;
constexpr uint32_t TILE_BYTES = FW_BK * FW_D * 2;  // a k, v or q tile
constexpr float FW_NEG_INF = -1e30f;  // JAX's NEG_INF: finite, so m - m'
                                      // is never inf - inf = NaN
constexpr float FW_LOG2E = 1.4426950408889634f;
constexpr int BAR_TURN = 1;  // named barriers 1, 2: consumer 0's, 1's turn

// The softmax of the device function: K11's online natural exp, K13b's
// online exp2 with p in packed bf16, K13a's online exp2, K9's online exp2
// with l from bf16(p) and l2, K5's and K6's exp2 with no running max, l
// from bf16(p) and l2.
enum class Softmax { kNatural, kExp2Bf16, kExp2, kOnline, kBounded };

// whether MODE's l is the tensor cores' sum of P
template <Softmax MODE>
constexpr bool L_MMA = MODE == Softmax::kOnline || MODE == Softmax::kBounded;

struct __align__(1024) FwdSmem {
  __nv_bfloat16 q[FW_BQ * FW_D];
  __nv_bfloat16 k[FW_STAGES][FW_BK * FW_D];
  __nv_bfloat16 v[FW_STAGES][FW_BK * FW_D];
  __nv_bfloat16 ones[8 * FW_D];  // one swizzle atom of ones (L_MMA)
  uint64_t q_bar;
  uint64_t full[FW_STAGES];
  uint64_t empty[FW_STAGES];
};

// One tile's softmax on this thread's S accumulator (rows g and g + 8 of
// its warp, columns 8i + 2tq + {0, 1}): p = exp2(s) in the bounded mode,
// which has no max, no rescale and an l that the tensor cores sum;
// otherwise m' = max(m, rowmax s) reduced over the quad of lanes that
// share a row, a = exp(m - m'), l = l a + sum p (but K9's, which the
// tensor cores sum: L_MMA). p overwrites s in f32; K13b's
// packed bf16 p are unpacked for the sum anyway and re-packed, exactly,
// once the last PV product is done. (Kept packed they share registers with
// S, which the next S overwrites before the PV product that reads p is
// issued: ptxas then moves them out between the two issues and serialises
// the products.) With MASK, the columns at or past `valid` are keys past
// Tk.
template <Softmax MODE, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], int valid,
                                             int tq, float& m0, float& m1,
                                             float& l0, float& l1, float& a0,
                                             float& a1) {
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * i + 2 * tq + (e & 1) >= valid) s[4 * i + e] = FW_NEG_INF;
      }
    }
  }
  if constexpr (MODE == Softmax::kBounded) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * i + e] = exp2_ftz(s[4 * i + e]);
    }
  } else {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
    if constexpr (MODE == Softmax::kNatural) {
      a0 = exp2_ftz((m0 - mx0) * FW_LOG2E);
      a1 = exp2_ftz((m1 - mx1) * FW_LOG2E);
      const float b0 = mx0 * FW_LOG2E, b1 = mx1 * FW_LOG2E;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_ftz(fmaf(s[4 * i + e], FW_LOG2E,
                                        -(e < 2 ? b0 : b1)));
          s[4 * i + e] = p;
          if (e < 2) {
            sum0 += p;
          } else {
            sum1 += p;
          }
        }
      }
    } else if constexpr (MODE == Softmax::kExp2Bf16) {
      a0 = exp2_ftz(m0 - mx0);
      a1 = exp2_ftz(m1 - mx1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t lo = exp2_bf16x2(pack_bf16(s[4 * i] - mx0,
                                                  s[4 * i + 1] - mx0));
        const uint32_t hi = exp2_bf16x2(pack_bf16(s[4 * i + 2] - mx1,
                                                  s[4 * i + 3] - mx1));
        const float2 flo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&lo));
        const float2 fhi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi));
        sum0 += flo.x + flo.y;
        sum1 += fhi.x + fhi.y;
        s[4 * i] = flo.x;
        s[4 * i + 1] = flo.y;
        s[4 * i + 2] = fhi.x;
        s[4 * i + 3] = fhi.y;
      }
    } else {
      a0 = exp2_ftz(m0 - mx0);
      a1 = exp2_ftz(m1 - mx1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float mx = e < 2 ? mx0 : mx1;
          const float p0 = exp2_ftz(s[4 * i + e] - mx);
          const float p1 = exp2_ftz(s[4 * i + e + 1] - mx);
          s[4 * i + e] = p0;
          s[4 * i + e + 1] = p1;
          if (e < 2) {
            sum0 += p0 + p1;
          } else {
            sum1 += p0 + p1;
          }
        }
      }
    }
    if constexpr (!L_MMA<MODE>) {
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
    }
    m0 = mx0;
    m1 = mx1;
  }
}

// bf16(P) as the register A operand of the PV product: k-step kk of 16
// keys is pa[4kk..4kk+3] (sm90.cuh's accumulator-to-A layout)
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pa[2 * i] = pack_bf16(s[4 * i], s[4 * i + 1]);
    pa[2 * i + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
}

// rows g (a0) and g + 8 (a1) of an m64nN accumulator times their rescale
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float a0,
                                        float a1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    acc[4 * i] *= a0;
    acc[4 * i + 1] *= a0;
    acc[4 * i + 2] *= a1;
    acc[4 * i + 3] *= a1;
  }
}

// What a consumer carries from one key tile to the next.
struct Carry {
  float acc[32];   // O, unnormalised
  float s[64];     // S, then p
  uint32_t pa[32]; // bf16(p) of the last tile, the A operand of its PV
  float lacc[4];   // with L_MMA: P's row sums, rows row0 (0, 1), row0 + 8
  float m0, m1;    // running max of rows row0, row0 + 8 (not kBounded)
  float l0, l1;    // this thread's part of their normalizers (not L_MMA)
  float a0, a1;    // the last tile's rescale, applied to acc before its PV
};

// O's rescale (none in the bounded mode) and O += P V over one tile's 128
// keys (with L_MMA, also the row sums of P: P times the tile of ones)
template <Softmax MODE>
__device__ __forceinline__ void issue_pv(Carry& c, const __nv_bfloat16* vt,
                                         const __nv_bfloat16* ones) {
  if constexpr (MODE != Softmax::kBounded) {
    rescale(c.acc, c.a0, c.a1);
    if constexpr (L_MMA<MODE>) rescale(c.lacc, c.a0, c.a1);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<1>(c.acc, c.pa + 4 * kk, desc128(vt + kk * 16 * FW_D));
  if constexpr (L_MMA<MODE>) {
    const uint64_t d1 = desc128(ones);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_n8(c.lacc, c.pa + 4 * kk, d1);
  }
  wgmma_commit();
}

template <Softmax MODE>
__device__ __forceinline__ void fence_o(Carry& c) {
  fence_regs(c.acc);
  if constexpr (L_MMA<MODE>) fence_regs(c.lacc);
}

// One turn of a consumer on key tile j: wait for its (k, v) stage and for
// its turn, issue S_j and (but on the first tile) O's rescale and
// P_{j-1} V_{j-1}, hand the turn to the other consumer, run tile j's
// softmax while the products run, then free tile j-1's stage and re-pack
// P_j. No branch lies between a product's issue and its wait (ptxas would
// serialise the products there), so the first tile and a masked last tile
// are instantiations of their own.
template <Softmax MODE, bool MASK, bool FIRST>
__device__ __forceinline__ void consumer_tile(FwdSmem& sm, int j, int Tk,
                                              int wg, int tq,
                                              const uint32_t (&qa)[16],
                                              Carry& c) {
  const int st = j % FW_STAGES;
  mbar_wait(&sm.full[st], (j / FW_STAGES) & 1);
  bar_sync(BAR_TURN + wg, FW_CONSUMERS);
  wgmma_fence();
  wgmma_rs_n128<0, true>(c.s, qa, desc128(sm.k[st]));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_rs_n128<0, false>(c.s, qa + 4 * kk, desc128(sm.k[st] + kk * 16));
  wgmma_commit();
  if constexpr (!FIRST) issue_pv<MODE>(c, sm.v[(j - 1) % FW_STAGES], sm.ones);
  bar_arrive(BAR_TURN + (wg ^ 1), FW_CONSUMERS);
  if constexpr (FIRST) {
    wgmma_wait<0>();
  } else {
    wgmma_wait<1>();
  }
  fence_regs(c.s);
  softmax_tile<MODE, MASK>(c.s, Tk - j * FW_BK, tq, c.m0, c.m1, c.l0, c.l1,
                           c.a0, c.a1);
  if constexpr (!FIRST) {
    wgmma_wait<0>();
    fence_o<MODE>(c);
    mbar_arrive(&sm.empty[(j - 1) % FW_STAGES]);
  }
  pack_p(c.s, c.pa);
}

template <Softmax MODE>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, float* __restrict__ l2, int T,
                int Tk, long long osb, long long osh, long long ost,
                float scale_q) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * FW_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_kv = (Tk + FW_BK - 1) / FW_BK;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_bar, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], FW_CONSUMERS);
    }
    mbar_init_fence();
  }
  if constexpr (L_MMA<MODE>) {
    // bf16 ones, two per word, visible to the tensor cores' reads
    if (threadIdx.x < 8 * FW_D / 2)
      reinterpret_cast<uint32_t*>(sm.ones)[threadIdx.x] = 0x3f803f80u;
    fence_proxy_async();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer -------------------------------------------------------
    reg_dealloc<24>();
    if (threadIdx.x == FW_CONSUMERS) {
      mbar_expect_tx(&sm.q_bar, TILE_BYTES);
      tma_load_4d(sm.q, &q_map, 0, q0, h, b, &sm.q_bar);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % FW_STAGES;
        if (j >= FW_STAGES) mbar_wait(&sm.empty[s], (j / FW_STAGES - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load_4d(sm.k[s], &k_map, 0, j * FW_BK, h, b, &sm.full[s]);
        tma_load_4d(sm.v[s], &v_map, 0, j * FW_BK, h, b, &sm.full[s]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----------------------------------
    reg_alloc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int row0 = wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8

    // q' = bf16(q * scale_q) as the register A operand of S = q' K^T:
    // k-step kk holds rows row0, row0 + 8 at columns 16kk + 2tq (+ 8)
    mbar_wait(&sm.q_bar, 0);
    uint32_t qa[16];
    const unsigned char* qs = reinterpret_cast<const unsigned char*>(sm.q);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(
            qs + swz128(row0 + (r & 1) * 8, 16 * kk + (r >> 1) * 8 + 2 * tq));
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw));
        qa[4 * kk + r] = pack_bf16(f.x * scale_q, f.y * scale_q);
      }
    }

    Carry c;
#pragma unroll
    for (int i = 0; i < 32; ++i) c.acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) c.lacc[i] = 0.f;
    c.m0 = c.m1 = FW_NEG_INF;
    c.l0 = c.l1 = 0.f;
    // consumer 0 takes the first turn; each consumer hands the turn over
    // once per tile, and consumer 0 takes consumer 1's last hand-over at
    // the end
    if (wg == 1) bar_arrive(BAR_TURN, FW_CONSUMERS);
    if (Tk < FW_BK) {
      consumer_tile<MODE, true, true>(sm, 0, Tk, wg, tq, qa, c);
    } else {
      consumer_tile<MODE, false, true>(sm, 0, Tk, wg, tq, qa, c);
    }
    for (int j = 1; j + 1 < n_kv; ++j)
      consumer_tile<MODE, false, false>(sm, j, Tk, wg, tq, qa, c);
    if (n_kv > 1) {
      if (Tk % FW_BK) {
        consumer_tile<MODE, true, false>(sm, n_kv - 1, Tk, wg, tq, qa, c);
      } else {
        consumer_tile<MODE, false, false>(sm, n_kv - 1, Tk, wg, tq, qa, c);
      }
    }
    issue_pv<MODE>(c, sm.v[(n_kv - 1) % FW_STAGES], sm.ones);
    wgmma_wait<0>();
    fence_o<MODE>(c);
    if (wg == 0) bar_sync(BAR_TURN, FW_CONSUMERS);

    // the tensor cores' row sums are whole (each column of the ones
    // product holds one); otherwise the quad of a row holds its parts
    float l0 = c.lacc[0], l1 = c.lacc[2];
    if constexpr (!L_MMA<MODE>) {
      l0 = c.l0 + __shfl_xor_sync(0xffffffffu, c.l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 = c.l1 + __shfl_xor_sync(0xffffffffu, c.l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    }
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    const int r0 = q0 + row0;
    const int r1 = r0 + 8;
    __nv_bfloat16* oh = o + b * osb + h * osh;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 8 * i + 2 * tq;
      if (r0 < T) {
        *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r0 * ost + d) =
            __floats2bfloat162_rn(c.acc[4 * i] / l0, c.acc[4 * i + 1] / l0);
      }
      if (r1 < T) {
        *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r1 * ost + d) =
            __floats2bfloat162_rn(c.acc[4 * i + 2] / l1,
                                  c.acc[4 * i + 3] / l1);
      }
    }
    if constexpr (MODE == Softmax::kOnline || MODE == Softmax::kBounded) {
      if (tq == 0) {
        const float m0 = MODE == Softmax::kOnline ? c.m0 : 0.f;
        const float m1 = MODE == Softmax::kOnline ? c.m1 : 0.f;
        float* lrow = l2 + ((long long)b * gridDim.y + h) * T;
        if (r0 < T) lrow[r0] = m0 + log2f(l0);
        if (r1 < T) lrow[r1] = m1 + log2f(l1);
      }
    }
  }
}

// q, k, v and o given by their (b, h, t) element strides (head-dim stride
// 1, strides multiples of 8 and 16-byte aligned bases; the wrapper
// checks); l2 [B*H, T] f32 for K5, K6 and K9, else null. A missing entry
// point or a refused map returns its CUresult, whose codes read as the
// cudaError_t of the same name; Tk = 0 (no key to take the softmax over)
// returns cudaErrorInvalidValue (the wrappers refuse it first).
template <Softmax MODE>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     void* l2, int B, int H, int T, int Tk, long long qsb,
                     long long qsh, long long qst, long long ksb,
                     long long ksh, long long kst, long long vsb,
                     long long vsh, long long vst, long long osb,
                     long long osh, long long ost, float scale_q,
                     cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  if (Tk == 0) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  CUresult res = bthd_map(encode, &q_map, q, B, T, H, qsb, qst, qsh, FW_BQ);
  if (res == CUDA_SUCCESS)
    res = bthd_map(encode, &k_map, k, B, Tk, H, ksb, kst, ksh, FW_BK);
  if (res == CUDA_SUCCESS)
    res = bthd_map(encode, &v_map, v, B, Tk, H, vsb, vst, vsh, FW_BK);
  if (res != CUDA_SUCCESS) return (int)res;
  const int smem = (int)sizeof(FwdSmem) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + FW_BQ - 1) / FW_BQ, H, B);
  flash_fwd_wgmma<MODE><<<grid, FW_THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(l2), T, Tk, osb, osh, ost, scale_q);
  LSX_CHECK_LAUNCH();
  return 0;
}

// K13b's packed exp alone, to measure it against exp2 rounded to bf16:
// y = exp2(x) for n2 pairs of bf16
__global__ void exp2_bf16x2_probe(const uint32_t* __restrict__ x,
                                  uint32_t* __restrict__ y, int n2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n2) y[i] = exp2_bf16x2(x[i]);
}

}  // namespace

// K5: o [B, T, H, 64] bf16 and l2 [B*H, T] f32 = log2 l from q, k, v
// [B, T, H, 64] bf16 with the bounded exp2 softmax (no running max), each
// given by its (b, t, h) element strides, so the strided views of one
// [B, T, 3, H, 64] tensor load in place; scale2 is bf16(scale * log2 e)
// as a float. K6's kernel with Tk = T.
extern "C" int lsx_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* l2, int B,
    int T, int H, long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh, float scale2,
    cudaStream_t stream) {
  return launch_fwd_wgmma<Softmax::kBounded>(
      q, k, v, o, l2, B, H, T, T, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh,
      vst, osb, osh, ost, scale2, stream);
}

// K6: K5's function on q [B, H, T, 64] and k, v [B, H, Tk, 64] bf16, each
// given by its (b, h, t) element strides (so a transpose(1, 2) view of
// [B, T, H, 64] tensors is read in place) -> o [B, H, T, 64] bf16 and l2
// [B*H, T] f32 = log2 l.
extern "C" int lsx_flash_attention_bhtd_fwd(
    const void* q, const void* k, const void* v, void* o, void* l2, int B,
    int H, int T, int Tk, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, float scale2,
    cudaStream_t stream) {
  return launch_fwd_wgmma<Softmax::kBounded>(
      q, k, v, o, l2, B, H, T, Tk, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh,
      vst, osb, osh, ost, scale2, stream);
}

// K9: o [B, H, T, 64] bf16 and l2 [B*H, T] f32 = m + log2 l (which K7
// takes as it takes K6's) from q [B, H, T, 64] and k, v [B, H, Tk, 64]
// bf16 with the online exp2 softmax whose l sums bf16(p); scale2 is
// bf16(scale * log2 e) as a float.
extern "C" int lsx_flash_attention_online_fwd(
    const void* q, const void* k, const void* v, void* o, void* l2, int B,
    int H, int T, int Tk, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, float scale2,
    cudaStream_t stream) {
  return launch_fwd_wgmma<Softmax::kOnline>(
      q, k, v, o, l2, B, H, T, Tk, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh,
      vst, osb, osh, ost, scale2, stream);
}

// K11: o [B, H, T, 64] bf16 from q [B, H, T, 64] and k, v [B, H, Tk, 64]
// bf16 with the natural-exp online softmax; scale1 is bf16(scale) as a
// float. No l2.
extern "C" int lsx_flash_attention_h2_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int T, int Tk, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, float scale1,
    cudaStream_t stream) {
  return launch_fwd_wgmma<Softmax::kNatural>(
      q, k, v, o, nullptr, B, H, T, Tk, qsb, qsh, qst, ksb, ksh, kst, vsb,
      vsh, vst, osb, osh, ost, scale1, stream);
}

// K13a: K11's operands and output with the exp2 online softmax whose l
// sums the unrounded p; scale2 as K9's. No l2.
extern "C" int lsx_flash_attention_exp2_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int T, int Tk, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, float scale2,
    cudaStream_t stream) {
  return launch_fwd_wgmma<Softmax::kExp2>(
      q, k, v, o, nullptr, B, H, T, Tk, qsb, qsh, qst, ksb, ksh, kst, vsb,
      vsh, vst, osb, osh, ost, scale2, stream);
}

// K13b: K11's operands and output with the exp2 online softmax whose p =
// exp2(bf16(s - m')) is evaluated in packed bf16; scale2 is bf16(scale *
// log2 e) as a float. No l2.
extern "C" int lsx_flash_attention_exp2_bf16_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int T, int Tk, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, float scale2,
    cudaStream_t stream) {
  return launch_fwd_wgmma<Softmax::kExp2Bf16>(
      q, k, v, o, nullptr, B, H, T, Tk, qsb, qsh, qst, ksb, ksh, kst, vsb,
      vsh, vst, osb, osh, ost, scale2, stream);
}

// y [n] bf16 = exp2(x [n] bf16) through K13b's packed instruction; n even.
extern "C" int lsx_exp2_bf16x2(const void* x, void* y, int n,
                               cudaStream_t stream) {
  const int n2 = n / 2;
  if (n2 == 0) return 0;
  exp2_bf16x2_probe<<<(n2 + 255) / 256, 256, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), n2);
  LSX_CHECK_LAUNCH();
  return 0;
}
