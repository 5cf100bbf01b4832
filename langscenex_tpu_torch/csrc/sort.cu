// Stable LSD radix sort of int32 (key, value) pairs by key, kernel K4.
//
// Replaces: langscenex_tpu/ops/sort_engine.py:92 _local_kernel and :104
// _cross_kernel (the TPU bitonic network, run through
// bitonic_sort_pairs). Contract: identical to a stable
// lax.sort((key, value), num_keys=1) for every int32 key and any n >= 0 —
// equal keys keep their input order, which gives the depth permutation
// its tie-break by splat id for free. Keys are ordered as signed int32
// (the sign bit is flipped in the top digit), and all 32 bits are sorted.
//
// Bound on the H100: memory traffic. The function's own floor is one read
// and one write of the keys and values (16 B a pair: 2.5 us at 2^19 pairs
// and 3.35 TB/s). A 4-pass LSD sort must move one key read (the upsweep)
// plus 4 x (read + write of keys and values): 68 B a pair, 10.6 us at
// 2^19. The earlier design ran 12 launches, scanned 65,536 digit counters
// on one block and serialised skewed digits on shared atomics. Measured
// on the H100 (PERF.md), the passes are latency-bound: 2,048-key tiles
// (two blocks per SM at 2^19), a short look-back window and ballots in
// place of __match_any_sync were each faster than the alternatives.
//
// Design: Onesweep (Adinets & Merrill, 2022), written by hand.
//   1. radix_upsweep: one pass over the keys builds all four 256-bin digit
//      histograms at once, in warp-private shared sub-histograms, so a
//      skewed digit (the top byte of positive f32 depths, the tile of a
//      pair key) contends only within a warp; the blocks' sums go to the
//      global histograms by atomics.
//   2. radix_onesweep, once per digit: a block takes a 2,048-key tile by
//      an atomic ticket (tiles start in ticket order, which the look-back
//      needs for forward progress), ranks its keys stably by warp-level
//      match ranks (one ballot per digit bit) plus a per-digit prefix over
//      the warps, publishes its per-digit counts and finds its global
//      offsets by decoupled look-back over the earlier tiles' status words
//      (flag + count, one 32-bit word per (tile, digit), zeroed per call;
//      4 read at once, as a pass's tiles mostly run in one wave), then
//      scatters through shared memory so that each digit's run leaves as
//      coalesced writes. Each block scans the 256 digit totals itself, so
//      there is no scan launch.
// Five launches and one memset per call, on the caller's stream, with no
// host synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int RADIX = 256;
constexpr int NUM_PASSES = 4;
constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_ITEMS = 8;
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;  // 2,048 keys
constexpr int WARP_SPAN = 32 * SORT_ITEMS;            // keys per warp
constexpr int UP_THREADS = 256;
constexpr int UP_ITEMS = 16;  // keys per upsweep thread
constexpr int UP_MAX_BLOCKS = 264;
constexpr int LOOKBACK = 4;  // status words read per look-back round
// scratch layout in 32-bit words: digit histograms, one ticket per pass
// (padded), status words [pass][tile][digit], then the ping-pong keys and
// values; must agree with ops/sort_engine.py:sort_scratch_words
constexpr int HIST_WORDS = NUM_PASSES * RADIX;
constexpr int TICKET_WORDS = 16;
constexpr unsigned FLAG_AGG = 1u << 30;     // tile's own count published
constexpr unsigned FLAG_PREFIX = 2u << 30;  // inclusive prefix published
constexpr unsigned COUNT_MASK = FLAG_AGG - 1u;
static_assert(SORT_THREADS == RADIX, "one thread per digit");

__device__ __forceinline__ unsigned digit_of(int key, int shift) {
  return ((static_cast<unsigned>(key) ^ 0x80000000u) >> shift) & (RADIX - 1);
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(UP_THREADS)
radix_upsweep(const int* __restrict__ keys, int n,
              unsigned* __restrict__ hist) {
  constexpr int NW = UP_THREADS / 32;
  __shared__ unsigned wh[NW][HIST_WORDS];
  for (int i = threadIdx.x; i < NW * HIST_WORDS; i += UP_THREADS)
    (&wh[0][0])[i] = 0u;
  __syncthreads();
  unsigned* mine = wh[threadIdx.x >> 5];
  const int stride = gridDim.x * UP_THREADS;
  for (int i = blockIdx.x * UP_THREADS + threadIdx.x; i < n; i += stride) {
    const int key = keys[i];
#pragma unroll
    for (int p = 0; p < NUM_PASSES; ++p)
      atomicAdd(&mine[p * RADIX + digit_of(key, 8 * p)], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < HIST_WORDS; b += UP_THREADS) {
    unsigned s = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += wh[w][b];
    if (s) atomicAdd(&hist[b], s);
  }
}

struct PassSmem {
  int keys[SORT_TILE];
  int vals[SORT_TILE];
  unsigned warp_cnt[SORT_WARPS][RADIX];  // counts, then offsets in digit
  unsigned blk_start[RADIX];             // digit's first slot in the tile
  unsigned out_base[RADIX];              // global slot of tile slot 0
  unsigned scan[SORT_WARPS];
  int tile;
};

__global__ void __launch_bounds__(SORT_THREADS)
radix_onesweep(const int* __restrict__ keys_in,
               const int* __restrict__ vals_in,
               int* __restrict__ keys_out, int* __restrict__ vals_out, int n,
               int pass, const unsigned* __restrict__ hist,
               unsigned* __restrict__ tickets, unsigned* __restrict__ status) {
  __shared__ PassSmem sm;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int shift = 8 * pass;

  // the ticket is taken first so that its round trip overlaps the
  // histogram's
  if (t == 0) sm.tile = (int)atomicAdd(&tickets[pass], 1u);
  // the digit's global start: an exclusive scan of the pass's histogram
  const unsigned total = hist[pass * RADIX + t];
  const unsigned gstart =
      lsx::block_inclusive_scan<SORT_THREADS>(total, sm.scan) - total;

#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) sm.warp_cnt[w][t] = 0u;
  __syncthreads();
  const int tile = sm.tile;
  const int base = tile * SORT_TILE + warp * WARP_SPAN + lane;

  // load: warp w holds tile keys [w, w + 1) * WARP_SPAN, item i of lane l
  // is key w * WARP_SPAN + 32 i + l, so (i, lane) order is input order
  int key[SORT_ITEMS], val[SORT_ITEMS];
  unsigned rank[SORT_ITEMS];
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    const int idx = base + 32 * i;
    key[i] = idx < n ? keys_in[idx] : 0;
    val[i] = idx < n ? vals_in[idx] : 0;
  }

  // stable rank of each key among the warp's keys of its digit
  unsigned* wc = sm.warp_cnt[warp];
  const unsigned lanemask_lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    const bool ok = base + 32 * i < n;
    const unsigned d = ok ? digit_of(key[i], shift) : (unsigned)RADIX;
    // the lanes holding this digit: one ballot per digit bit, and one
    // that keeps the lanes past n apart
    unsigned peers = __ballot_sync(0xffffffffu, ok);
    if (!ok) peers = ~peers;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1u;
      const unsigned vote = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? vote : ~vote;
    }
    const unsigned before = __popc(peers & lanemask_lt);
    const unsigned prior = ok ? wc[d] : 0u;
    __syncwarp();
    if (ok && before == 0) wc[d] = prior + __popc(peers);
    __syncwarp();
    rank[i] = prior + before;
  }
  __syncthreads();

  // thread t owns digit t: per-warp offsets inside the digit, tile count
  unsigned count = 0u;
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) {
    const unsigned c = sm.warp_cnt[w][t];
    sm.warp_cnt[w][t] = count;
    count += c;
  }

  // decoupled look-back over the earlier tiles' counts of digit t
  unsigned* st = status + (size_t)pass * gridDim.x * RADIX;
  st_relaxed(&st[tile * RADIX + t], (tile == 0 ? FLAG_PREFIX : FLAG_AGG)
                                        | count);
  // LOOKBACK words are read at once, so a chain of tiles that have only
  // published their own counts costs one L2 round trip per LOOKBACK tiles
  unsigned excl = 0u;
  for (int j = tile - 1; j >= 0;) {
    unsigned word[LOOKBACK];
#pragma unroll
    for (int w = 0; w < LOOKBACK; ++w)
      word[w] = j - w >= 0 ? ld_relaxed(&st[(j - w) * RADIX + t]) : FLAG_PREFIX;
    int used = 0;
    bool stop = false, done = false;
#pragma unroll
    for (int w = 0; w < LOOKBACK; ++w) {
      const unsigned flag = word[w] & ~COUNT_MASK;
      if (!stop && flag != 0u) {
        excl += word[w] & COUNT_MASK;
        ++used;
        done = flag == FLAG_PREFIX;
      }
      stop = stop || flag == 0u || done;
    }
    if (done) break;
    j -= used;  // poll again from the first tile not yet published
  }
  if (tile > 0) st_relaxed(&st[tile * RADIX + t], FLAG_PREFIX | (excl + count));

  const unsigned bstart =
      lsx::block_inclusive_scan<SORT_THREADS>(count, sm.scan) - count;
  sm.blk_start[t] = bstart;
  sm.out_base[t] = gstart + excl - bstart;
  __syncthreads();

  // place keys and values at their tile slots in shared memory
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    if (base + 32 * i < n) {
      const unsigned d = digit_of(key[i], shift);
      const unsigned slot = rank[i] + sm.blk_start[d] + sm.warp_cnt[warp][d];
      sm.keys[slot] = key[i];
      sm.vals[slot] = val[i];
    }
  }
  __syncthreads();

  // each digit's run of the tile goes out to consecutive addresses
  const int tile_n = min(SORT_TILE, n - tile * SORT_TILE);
  for (int j = t; j < tile_n; j += SORT_THREADS) {
    const int k = sm.keys[j];
    const unsigned pos = sm.out_base[digit_of(k, shift)] + (unsigned)j;
    keys_out[pos] = k;
    vals_out[pos] = sm.vals[j];
  }
}

}  // namespace

extern "C" const char* lsx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sorts (keys_in, vals_in)[0, n) into (keys_out, vals_out); the inputs are
// not modified. scratch holds sort_scratch_words(n) 32-bit words (see
// ops/sort_engine.py); n < 2^30.
extern "C" int lsx_sort_pairs(const int* keys_in, const int* vals_in,
                              int* keys_out, int* vals_out, unsigned* scratch,
                              int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int n_tiles = (n + SORT_TILE - 1) / SORT_TILE;
  unsigned* hist = scratch;
  unsigned* tickets = hist + HIST_WORDS;
  unsigned* status = tickets + TICKET_WORDS;
  const size_t zero_words =
      HIST_WORDS + TICKET_WORDS + (size_t)NUM_PASSES * n_tiles * RADIX;
  int* keys_tmp = reinterpret_cast<int*>(scratch + zero_words);
  int* vals_tmp = keys_tmp + n;
  cudaError_t err = cudaMemsetAsync(scratch, 0, zero_words * 4, stream);
  if (err != cudaSuccess) return (int)err;
  const int up_blocks = std::min(
      UP_MAX_BLOCKS, (n + UP_THREADS * UP_ITEMS - 1) / (UP_THREADS * UP_ITEMS));
  radix_upsweep<<<up_blocks, UP_THREADS, 0, stream>>>(keys_in, n, hist);
  LSX_CHECK_LAUNCH();
  const int* src_k = keys_in;
  const int* src_v = vals_in;
  for (int pass = 0; pass < NUM_PASSES; ++pass) {
    // even passes land in tmp, odd passes in out: pass 3 ends in out
    int* dst_k = (pass % 2 == 0) ? keys_tmp : keys_out;
    int* dst_v = (pass % 2 == 0) ? vals_tmp : vals_out;
    radix_onesweep<<<n_tiles, SORT_THREADS, 0, stream>>>(
        src_k, src_v, dst_k, dst_v, n, pass, hist, tickets, status);
    LSX_CHECK_LAUNCH();
    src_k = dst_k;
    src_v = dst_v;
  }
  return 0;
}
