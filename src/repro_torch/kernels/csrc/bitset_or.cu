// Bit-set max-scatter for Hopper (sm_90a): Bloom filters and FM/PCSA
// bitmaps.
//
// Replaces: src/repro/kernels/bitset_or.py, bitset_max_update (rows given)
// and bitset_probe_max_update (routing probe fused); through them also
// src/repro/kernels/fm_bitmap.py, fm_bit_update and fm_probe_bit_update
// (k = 1 on the flattened [n, maps * bits] plane). The TPU kernels sweep a
// [T, S, M] one-hot max cube per tile because max has no matmul form; on
// the card it is a direct scatter:
//
//   bits[s, idx[t, h]] = max(bits[s, idx[t, h]], upd[t])   for rows[t] == s,
//                                                         h < k
//
// Entries are dropped for rows outside [0, n), upd <= 0 (upd 0 is the
// masked no-op) and positions outside [0, m). Offsets are 64-bit: a Bloom
// stack of 131,072 rows of 2**15 lanes already holds 2**32 lanes.
//
// What the engine feeds it: every kind hashes the tuple's own stream id,
// so all tuples of a stream set the same k lanes of its row. On a Zipf
// batch a few lanes take thousands of entries each (phase 2 of
// chip_smoke.py: 614,944 entries on 116,492 lanes, the hottest 7,647),
// and a stream seen in an earlier batch finds its lanes already set.
//
// Design: one warp per 32 consecutive tuples. Lane j loads tuple j's upd
// and row (or probes it); the warp's 32 * k positions, one contiguous
// slice of idx, are staged in shared memory by coalesced loads (k <=
// kStagedK; above, each lane reads its own tuple's slice). Then, kChunk
// hash indices at a time, lane j reads the state lane of tuple j's h-th
// position through L2 (`__ldcg`), all reads of a chunk in flight at once.
// Only entries below their upd go on: a lane only grows during a launch,
// so a stale read costs at most an extra atomic, never a missed one, and
// a stream seen in an earlier batch issues none. Those entries are grouped
// by their 64-bit lane offset (`__match_any_sync`: every tuple of a stream
// in the warp at one hash index), and the group's leader carries the
// group's max upd, read from its members' upd in shared memory
// (`__reduce_max_sync` over each group's mask serialises across the
// distinct masks). Before its atomicMax the leader records the lane
// in its block's table of kSlots hash slots (lane, max raised): where
// another warp of the block already raised that lane as far, that warp's
// atomic covers it. That leaves about one atomic per distinct lane a
// block (a lane whose slot holds another lane goes past the table): the
// hottest lane's 7,647 entries take at most 256. Integer max
// does not depend on order: the result is exact and the same on every
// run (tools/bitset_probe.py times each of these steps changed).
//
// Bound on this card: memory. The work must read the batch once (rows or
// sid halves, idx, upd), the probed table slots (12 bytes each), and each
// touched lane once, writing it only where it grows. A lane read or
// raised moves a 32-byte sector: on a state that is not in L2, random
// DRAM accesses, and a first touch's time follows the distinct lanes.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr int kWarps = 8;              // warps a block, 32 tuples each
constexpr int kChunk = 16;             // hash indices a lane holds at once
constexpr int kStagedK = 35;           // up to here the positions are
                                       // staged (36 KB of shared memory)
constexpr int kSlotBits = 10;          // a block's table of lanes it raised
constexpr int kSlots = 1 << kSlotBits;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <bool kProbe>
__global__ void __launch_bounds__(kWarps * 32)
    bitset_kernel(int32_t* __restrict__ bits, int n, int m,
                  const int32_t* __restrict__ rows,
                  const uint32_t* __restrict__ keys_lo,
                  const uint32_t* __restrict__ keys_hi,
                  const int32_t* __restrict__ table_rows, uint32_t size,
                  const uint32_t* __restrict__ sid_lo,
                  const uint32_t* __restrict__ sid_hi, int n_probe,
                  const int32_t* __restrict__ idx, int k,
                  const int32_t* __restrict__ upd, int T) {
  // [kWarps][32] each lane's upd, then [kWarps][32 * k] the positions
  extern __shared__ int32_t smem[];
  // the lanes this block raised, by hash slot, and the most it raised each
  __shared__ unsigned long long s_lane[kSlots];
  __shared__ int32_t s_top[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += kWarps * 32) {
    s_lane[i] = kEmpty;
    s_top[i] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (t0 >= T) return;                 // uniform across the warp
  const int nt = (int)min(32LL, T - t0);
  // every load of the batch issued at once (a lane past the batch reads
  // the last tuple again and adds nothing)
  const long long t = t0 + min(lane, nt - 1);
  int32_t u = upd[t];
  const int32_t row =
      kProbe ? sde::probe_row(keys_lo, keys_hi, table_rows, size, sid_lo[t],
                              sid_hi[t], n_probe)
             : rows[t];
  const int32_t* const src = idx + t0 * k;
  const bool staged = k <= kStagedK;
  int32_t* const su = smem + warp * 32;
  int32_t* const pos = smem + kWarps * 32 + warp * 32 * k;
  for (int e0 = 0; staged && e0 < nt * k; e0 += 32 * kChunk) {
    int32_t v[kChunk];                 // kChunk loads in flight a lane
#pragma unroll
    for (int r = 0; r < kChunk; ++r)
      if (e0 + 32 * r + lane < nt * k) v[r] = src[e0 + 32 * r + lane];
#pragma unroll
    for (int r = 0; r < kChunk; ++r)
      if (e0 + 32 * r + lane < nt * k) pos[e0 + 32 * r + lane] = v[r];
  }
  if (lane >= nt || row < 0 || row >= n) u = 0;      // u <= 0 adds nothing
  const long long base = u > 0 ? (long long)row * m : -1;
  su[lane] = u;
  __syncwarp();
  for (int h0 = 0; h0 < k; h0 += kChunk) {
    long long key[kChunk];
    int32_t cur[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      key[i] = -1;
      if (h0 + i < k && base >= 0) {
        const int h = h0 + i;
        const int32_t p = staged ? pos[lane * k + h] : src[lane * k + h];
        if (p >= 0 && p < m) key[i] = base + p;
      }
      if (key[i] >= 0) cur[i] = __ldcg(bits + key[i]);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (h0 + i >= k) break;                        // uniform
      const bool need = key[i] >= 0 && cur[i] < u;
      if (!__any_sync(kFull, need)) continue;        // uniform
      const unsigned group = __match_any_sync(kFull, need ? key[i] : -1LL);
      if (!need || lane != __ffs(group) - 1) continue;
      int32_t top = u;
      for (unsigned g = group & (group - 1); g; g &= g - 1)
        top = max(top, su[__ffs(g) - 1]);
      // another warp of the block raised this lane as far: it issues
      const unsigned slot = (unsigned)(
          ((unsigned long long)key[i] * 0x9E3779B97F4A7C15ull) >>
          (64 - kSlotBits));
      const unsigned long long was = atomicCAS(&s_lane[slot], kEmpty,
                                               (unsigned long long)key[i]);
      if ((was == kEmpty || was == (unsigned long long)key[i]) &&
          atomicMax(&s_top[slot], top) >= top)
        continue;
      atomicMax(bits + key[i], top);
    }
  }
}

template <bool kProbe>
int launch(int32_t* bits, int n, int m, const int32_t* rows,
           const uint32_t* keys_lo, const uint32_t* keys_hi,
           const int32_t* table_rows, uint32_t size, const uint32_t* sid_lo,
           const uint32_t* sid_hi, int n_probe, const int32_t* idx, int k,
           const int32_t* upd, int T, cudaStream_t stream) {
  if (T <= 0 || n <= 0 || k <= 0) return 0;
  const int tuples = kWarps * 32;
  const int blocks = (int)(((long long)T + tuples - 1) / tuples);
  const size_t smem =
      (size_t)kWarps * 32 * (1 + (k <= kStagedK ? k : 0)) * sizeof(int32_t);
  bitset_kernel<kProbe><<<blocks, tuples, smem, stream>>>(
      bits, n, m, rows, keys_lo, keys_hi, table_rows, size, sid_lo, sid_hi,
      n_probe, idx, k, upd, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bits [n, m] i32 (updated in place); rows / upd [T] i32; idx [T, k] i32.
int bitset_max_update(int32_t* bits, int n, int m, const int32_t* rows,
                      const int32_t* idx, int k, const int32_t* upd, int T,
                      cudaStream_t stream) {
  return launch<false>(bits, n, m, rows, nullptr, nullptr, nullptr, 0u,
                       nullptr, nullptr, 0, idx, k, upd, T, stream);
}

// As bitset_max_update, with the rows probed in the kernel from the
// routing-table mirror (keys_lo / keys_hi / table_rows of pow2 `size`)
// for the stream-id halves sid_lo / sid_hi [T].
int bitset_probe_max_update(int32_t* bits, int n, int m,
                            const uint32_t* keys_lo, const uint32_t* keys_hi,
                            const int32_t* table_rows, int size,
                            const uint32_t* sid_lo, const uint32_t* sid_hi,
                            int n_probe, const int32_t* idx, int k,
                            const int32_t* upd, int T, cudaStream_t stream) {
  return launch<true>(bits, n, m, nullptr, keys_lo, keys_hi, table_rows,
                      (uint32_t)size, sid_lo, sid_hi, n_probe, idx, k, upd,
                      T, stream);
}

}  // extern "C"
