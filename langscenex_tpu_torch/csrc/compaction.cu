// Order-preserving stream compaction of int32 (key, sid) slots, kernel K3.
//
// Replaces: langscenex_tpu/ops/compaction.py:121 _compact_kernel (reached
// via compact_pairs). Slots with key < sent_min move to the front of the
// output in their input order; valid slots past out_len are dropped; the
// rest of the output is (fill_key, fill_sid). The TPU kernel's order inside
// a row was arbitrary; this one keeps the input order, so its output equals
// the argsort reference (compact_pairs_ref) slot for slot.
//
// Bound on the H100: bytes. The function must read every key (4 B a slot),
// the sid of each valid slot (4 B) and write both outputs (8 B a kept
// slot): 13.4 MB at the render scene's 1,781,824 slots -> 520,000, 4.0 us
// at 3.35 TB/s. Each key is read once and the work between the loads and
// the stores is a few ballots, so the time goes to latency: launches,
// passes over the keys, barriers, and the look-back's chain of L2 round
// trips. Measured on the card (PERF.md), what moves it most is how
// many blocks an SM holds, so the design keeps registers and shared memory
// low enough for six.
//
// Design: one launch, a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016, the method of CUB's DeviceSelect).
//   - A block takes a 4,096-slot tile by an atomic ticket (tiles start in
//     ticket order, which the look-back's forward progress needs). Slot i
//     sits at position i + pad, pad = (key's address / 4) mod 4, so every
//     thread's four slots of a row are one 16-byte load (int4); the ragged
//     head and tail chunks are read as scalars.
//   - Ranks inside a warp come from ballots of each thread's valid count
//     (three bits, __ballot_sync / __popc); the 32 (row, warp) counts of a
//     tile meet in one warp scan.
//   - Warp 0 publishes the tile's count and looks back over its
//     predecessors' status words, 32 at a time, for the tile's exclusive
//     prefix, then publishes its inclusive prefix. Meanwhile every warp
//     stages its valid pairs in shared memory in tile order: the key from
//     registers, the sid by cp.async (a sid is read only for a valid slot,
//     and not into registers), so that the tile's run leaves as coalesced
//     stores.
//   - The sentinel tail [total, out_len) needs no grand total: tile t
//     writes the fill over [excl_t + count_t + n - end_t, excl_t + n -
//     start_t), as many slots as it has invalid ones. These ranges are
//     disjoint, lie at or above the total (excl_t + count_t + n - end_t
//     is the total if every later slot were valid) and together cover
//     [total, n); slots [n, out_len) are fill whatever the keys and are
//     written by a grid stride. No block waits for the last one.
// Scratch: a 64-bit word holding the ticket counter (low half) and a call
// epoch (high half), then a 64-bit status word per tile (epoch, flag,
// value), each word alone in its 32-byte sector. The block that draws the
// last ticket resets the counter and bumps the epoch; a status word counts
// only if it carries this call's epoch, so stale words of earlier calls
// need no reset. The wrapper owns the scratch per (device, stream), zeroed
// once when it is allocated or grown (a memset only then): a steady call
// is one kernel and no memset.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lsx::FLAG_AGG;
using lsx::FLAG_PREFIX;
using lsx::STATUS_STRIDE;
using lsx::look_back;
using lsx::st_relaxed64;
using lsx::status_word;

constexpr int CMP_THREADS = 256;
constexpr int CMP_WARPS = CMP_THREADS / 32;
constexpr int CMP_ROWS = 4;                           // int4 loads a thread
constexpr int CMP_TILE = CMP_THREADS * CMP_ROWS * 4;  // 4,096 slots
// 32.9 KB of staging a block lets six share an SM; at most 40 registers a
// thread keeps them all resident
constexpr int CMP_BLOCKS_PER_SM = 6;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CMP_ROWS * CMP_WARPS == 32, "one warp scans the tile's counts");

struct CompactSmem {
  int key[CMP_TILE];  // the tile's valid pairs, in input order
  int sid[CMP_TILE];
  unsigned offset[CMP_ROWS * CMP_WARPS];  // (row, warp) -> first rank
  unsigned count, excl, epoch;
  int tile;
};

__global__ void __launch_bounds__(CMP_THREADS, CMP_BLOCKS_PER_SM)
compact_pairs_onepass(const int* __restrict__ key,
                      const int* __restrict__ sid, int* __restrict__ out_key,
                      int* __restrict__ out_sid, int n, int pad, int out_len,
                      int sent_min, int fill_key, int fill_sid,
                      unsigned long long* __restrict__ scratch) {
  __shared__ CompactSmem sm;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  unsigned long long* status = scratch + STATUS_STRIDE;

  if (t == 0) lsx::draw_ticket(scratch, sm.tile, sm.epoch);
  __syncthreads();
  const int tile = sm.tile;
  const unsigned epoch = sm.epoch;

  // row r of thread t: slots i0 .. i0 + 3 at positions tile * CMP_TILE +
  // 4 (r * CMP_THREADS + t) ..; (row, warp, lane, slot) is input order
  int k[CMP_ROWS][4];
  unsigned valid[CMP_ROWS];
#pragma unroll
  for (int r = 0; r < CMP_ROWS; ++r) {
    const int i0 = tile * CMP_TILE + 4 * (r * CMP_THREADS + t) - pad;
    if (i0 >= 0 && i0 + 4 <= n) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(key + i0));
      k[r][0] = q.x;
      k[r][1] = q.y;
      k[r][2] = q.z;
      k[r][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e;
        k[r][e] = i >= 0 && i < n ? __ldg(key + i) : sent_min;
      }
    }
    valid[r] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k[r][e] < sent_min) valid[r] |= 1u << e;
    }
  }

  // rank of each thread's first valid slot of a row among its warp's:
  // the three bits of the lanes' counts, one ballot each
  const unsigned lt = (1u << lane) - 1u;
  unsigned rank[CMP_ROWS];
#pragma unroll
  for (int r = 0; r < CMP_ROWS; ++r) {
    const unsigned c = __popc(valid[r]);
    const unsigned b0 = __ballot_sync(FULL, c & 1u);
    const unsigned b1 = __ballot_sync(FULL, c & 2u);
    const unsigned b2 = __ballot_sync(FULL, c & 4u);
    rank[r] = __popc(b0 & lt) + 2u * __popc(b1 & lt) + 4u * __popc(b2 & lt);
    if (lane == 0) {
      sm.offset[r * CMP_WARPS + warp] =
          __popc(b0) + 2u * __popc(b1) + 4u * __popc(b2);
    }
  }
  __syncthreads();

  if (warp == 0) {
    const unsigned c = sm.offset[lane];
    const unsigned incl = lsx::warp_inclusive_scan(c);
    sm.offset[lane] = incl - c;
    const unsigned count = __shfl_sync(FULL, incl, 31);
    if (lane == 0) {
      st_relaxed64(&status[(size_t)tile * STATUS_STRIDE], status_word(
          epoch, tile == 0 ? FLAG_PREFIX : FLAG_AGG, count));
      sm.count = count;
    }
  }
  __syncthreads();

  // stage the valid pairs at their ranks in the tile: keys from registers,
  // sids by cp.async, in flight while warp 0 looks back
#pragma unroll
  for (int r = 0; r < CMP_ROWS; ++r) {
    const int i0 = tile * CMP_TILE + 4 * (r * CMP_THREADS + t) - pad;
    unsigned p = sm.offset[r * CMP_WARPS + warp] + rank[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((valid[r] >> e) & 1u) {
        sm.key[p] = k[r][e];
        lsx::cp_async4(&sm.sid[p], sid + i0 + e, true);
        ++p;
      }
    }
  }
  lsx::cp_async_commit();
  if (warp == 0) {
    const unsigned excl = tile == 0 ? 0u : look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile > 0) {
        st_relaxed64(&status[(size_t)tile * STATUS_STRIDE],
                     status_word(epoch, FLAG_PREFIX, excl + sm.count));
      }
      sm.excl = excl;
    }
  }
  lsx::cp_async_wait_all();
  __syncthreads();

  const unsigned count = sm.count;
  const unsigned excl = sm.excl;
  for (unsigned j = t; j < count; j += CMP_THREADS) {
    const unsigned pos = excl + j;
    if (pos < (unsigned)out_len) {
      out_key[pos] = sm.key[j];
      out_sid[pos] = sm.sid[j];
    }
  }
  // this tile's share of the fill: as many slots as it has invalid ones
  const int start = max(0, tile * CMP_TILE - pad);
  const int end = min(n, (tile + 1) * CMP_TILE - pad);
  const int hi = min((int)excl + n - start, out_len);
  for (int p = (int)(excl + count) + n - end + t; p < hi; p += CMP_THREADS) {
    out_key[p] = fill_key;
    out_sid[p] = fill_sid;
  }
  for (int p = n + tile * CMP_THREADS + t; p < out_len;
       p += gridDim.x * CMP_THREADS) {
    out_key[p] = fill_key;
    out_sid[p] = fill_sid;
  }
}

}  // namespace

// key/sid: [n] inputs (4-byte aligned); out_key/out_sid: [out_len] outputs;
// scratch: 4 (1 + n_tiles) 64-bit words, zeroed when first allocated and
// owned by one stream, n_tiles = max(1, ceil((n + pad) / 4096)) with pad =
// (key's address / 4) mod 4; n < 2^30 (the status words hold 30-bit
// counts).
extern "C" int lsx_compact_pairs(const int* key, const int* sid, int* out_key,
                                 int* out_sid, void* scratch, int n,
                                 int out_len, int n_tiles, int sent_min,
                                 int fill_key, int fill_sid,
                                 cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(key);
  const int pad = (int)((addr >> 2) & 3u);
  if (out_len <= 0) return 0;
  if ((addr & 3u) != 0 || n < 0 || n >= (1 << 30) ||
      n_tiles != max(1, (n + pad + CMP_TILE - 1) / CMP_TILE)) {
    return (int)cudaErrorInvalidValue;
  }
  compact_pairs_onepass<<<n_tiles, CMP_THREADS, 0, stream>>>(
      key, sid, out_key, out_sid, n, pad, out_len, sent_min, fill_key,
      fill_sid, static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}
