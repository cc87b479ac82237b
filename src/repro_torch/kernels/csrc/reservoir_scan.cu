// The reservoir sampler's stacked update for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package updates a sampler stack with
// ReservoirSampler.add_batch (src/repro/core/sampler.py:55, a lax.scan of
// the one-slot step over the batch) under the vmap of
// batched.stacked_update (src/repro/core/batched.py:92): every row scans
// the whole batch, masked to its own tuples. Here every tuple is placed
// once, by its own row:
//
//   row r in [0, n):        the tuples with mask & rows == r, in batch order
//   a data-source row:      every tuple with mask, routed or not, in order
//   every other row:        untouched
//
// The step (the reference's _step) on a reservoir of S slots (values
// float32, items int32: the uint32 identities' bits) that has seen n
// tuples, for item x of value v: while n < S, slot n takes (v, x); else
//   u = float32(mix32(((n * 2654435761) mod 2**32) ^ x ^ seed_mix)) * 2**-32
//   j = int32(u * float32(n + 1))         (rounded products, truncated)
// and slot j takes (v, x) when j < S. Either way n grows by one. A masked
// step of the reference writes its slot back unchanged and leaves n, so
// dropping masked tuples gives its bytes.
//
// The step reads no state but n, and n at a row's tuple of rank i (the
// row's valid tuples before it in the batch) is n_seen + i. So no row is
// walked a tuple at a time: each tuple's slot is computed at once, and a
// slot ends up holding its last writer, the largest rank that writes it.
// Launches, on the caller's stream:
//   * (data-source rows) a memset and flag_kernel: a byte per row, set for
//     the source rows, whose routed tuples the grouping drops (their walk
//     takes every masked tuple anyway).
//   * key_kernel: each tuple's row, or -1 where it is masked, unrouted,
//     outside [0, n) or routed to a source row; with source rows, each
//     tile's masked tuples (__syncthreads_count), and scan_kernel, their
//     exclusive prefix: a source walk's rank is the masked tuples before.
//   * The stable row sort (row_sort.cuh) into srow / perm and the count of
//     kept tuples, which stays on the card: the host never waits.
//   * bounds_kernel: each run's first and last sorted position, by row.
//     A routed tuple's rank is its position less its run's start.
//   * A memset of `best` and place_kernel: a thread a (walk, tuple) pair,
//     the routed positions first, then a block a (source row, tile of
//     kThreads batch positions). Each computes its slot (native uint32
//     arithmetic, __fmul_rn / __uint2float_rn / __int2float_rn /
//     __float2int_rz, so nothing is contracted or rounded otherwise), and
//     the writers of a warp that share a (row, slot) keep only their last
//     lane (__match_any_sync). A routed run within one warp's 32 positions
//     is then complete: its last writers store their slots at once. A run
//     that crosses a warp's end (long runs), and every source walk, keep
//     the largest (rank + 1, tuple) per slot by a 64-bit atomicMax into
//     best[walk, slot]: the walk of a crossing run is the chunk of 32
//     positions it starts in (only the last run that starts in a chunk can
//     leave it), that of source row s its index past the chunks.
//   * finalize_kernel: each set entry of best stores its tuple's value and
//     item; each run's last position adds the run's length to its row's
//     n_seen, each source row the batch's masked tuples.
// No order depends on scheduling (a maximum is a maximum), so the state
// equals the plain version (ref.reservoir_scan_update) byte for byte.
//
// Bound on this card: the bytes (the batch read once, each walked row's
// n_seen read and written, each slot written once); no step depends on
// another.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_sort.cuh"

namespace {

constexpr int kThreads = 256;     // every kernel's block but scan_kernel's;
                                  // a source tile
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNMult = 2654435761u;     // 0x9E3779B1
constexpr unsigned kGolden = 0x9E3779B9u;    // the seed's multiplier
constexpr unsigned kC1 = 0x85EBCA6Bu;
constexpr unsigned kC2 = 0xC2B2AE35u;
constexpr float kTwoM32 = 2.3283064365386963e-10f;   // 2**-32

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

// The slot a tuple of item x that arrives at count n writes, or -1 (also
// for a count below 0, outside the contract, so that no write leaves the
// row).
__device__ __forceinline__ int slot_of(int n, unsigned x, int S,
                                       unsigned seed_mix) {
  if (n < 0) return -1;
  if (n < S) return n;
  const unsigned h = mix32(((unsigned)n * kNMult ^ x) ^ seed_mix);
  const float u = __fmul_rn(__uint2float_rn(h), kTwoM32);
  const int j = __float2int_rz(__fmul_rn(u, __int2float_rn(n + 1)));
  return j < S ? j : -1;
}

// A writer's entry in best: 0 is none, a later rank is larger.
__device__ __forceinline__ unsigned long long pack(int rank, int t) {
  return ((unsigned long long)(unsigned)(rank + 1) << 32) | (unsigned)t;
}

// Whether source row src[s] is one to walk: in [0, n), listed first there.
__device__ __forceinline__ bool first_source(const int64_t* src, int s,
                                             int n) {
  const int64_t row = src[s];
  if (row < 0 || row >= n) return false;
  for (int i = 0; i < s; ++i) {
    if (src[i] == row) return false;
  }
  return true;
}

__global__ void flag_kernel(const int64_t* __restrict__ src, int n_src,
                            int n, uint8_t* __restrict__ flag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_src) {
    const int64_t r = src[i];
    if (r >= 0 && r < n) flag[r] = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
key_kernel(const int32_t* __restrict__ rows,
           const uint8_t* __restrict__ mask, int T, int n,
           const uint8_t* __restrict__ flag, int32_t* __restrict__ key,
           int32_t* __restrict__ tile_cnt) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool m = t < T && mask[t] != 0;
  if (t < T) {
    const int32_t r = rows[t];
    const bool keep = m && r >= 0 && r < n &&
                      (flag == nullptr || flag[r] == 0);
    key[t] = keep ? r : -1;
  }
  if (tile_cnt != nullptr) {          // the same for the whole block
    const int c = __syncthreads_count(m);
    if (threadIdx.x == 0) tile_cnt[blockIdx.x] = c;
  }
}

// off[i] = cnt[0] + ... + cnt[i - 1] for i <= tiles (off[tiles]: the
// batch's masked tuples); one block.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ cnt, int tiles,
            int32_t* __restrict__ off) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? cnt[i] : 0;
    int x = v;                                  // inclusive over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {                            // inclusive over the warps
      int w = warp_sum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    if (i < tiles) off[i] = before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) off[tiles] = carry;
}

// run_start[r] / run_end[r]: the first / one past the last sorted position
// of row r's run (only the rows of this batch's runs are written or read).
__global__ void __launch_bounds__(kThreads)
bounds_kernel(const int32_t* __restrict__ srow,
              const int32_t* __restrict__ count,
              int32_t* __restrict__ run_start,
              int32_t* __restrict__ run_end) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long len = *count;
  if (p >= len) return;
  const int32_t r = srow[p];
  if (p == 0 || srow[p - 1] != r) run_start[r] = (int)p;
  if (p == len - 1 || srow[p + 1] != r) run_end[r] = (int)p + 1;
}

// Blocks [0, routed_blocks): sorted positions; then block
// routed_blocks + s * tiles + tile: source row src[s], batch positions
// tile * kThreads ...
__global__ void __launch_bounds__(kThreads)
place_kernel(float* __restrict__ values, int32_t* __restrict__ items,
             const int32_t* __restrict__ n_seen, int n, int S,
             const int32_t* __restrict__ in_items,
             const float* __restrict__ in_values,
             const uint8_t* __restrict__ mask, int T,
             const int64_t* __restrict__ src, unsigned seed_mix,
             const int32_t* __restrict__ srow,
             const int32_t* __restrict__ perm,
             const int32_t* __restrict__ count,
             const int32_t* __restrict__ run_start,
             const int32_t* __restrict__ run_end,
             const int32_t* __restrict__ tile_off, int routed_blocks,
             int tiles, long long chunks,
             unsigned long long* __restrict__ best) {
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x < routed_blocks) {
    const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
    int row = 0, rank = 0, t = 0, start = 0, slot = -1;
    if (p < *count) {
      row = srow[p];
      t = perm[p];
      start = run_start[row];
      rank = (int)p - start;
      slot = slot_of(n_seen[row] + rank, (unsigned)in_items[t], S,
                     seed_mix);
    }
    const unsigned writers = __ballot_sync(kFull, slot >= 0);
    if (slot < 0) return;
    const unsigned long long rs =
        ((unsigned long long)(unsigned)row << 32) | (unsigned)slot;
    if ((__match_any_sync(writers, rs) >> lane) != 1u) return;  // later
    if ((start >> 5) == ((run_end[row] - 1) >> 5)) {   // all in this warp
      const size_t at = (size_t)row * S + slot;
      values[at] = in_values[t];
      items[at] = in_items[t];
    } else {
      atomicMax(best + (size_t)(start >> 5) * S + slot, pack(rank, t));
    }
    return;
  }
  const int b = blockIdx.x - routed_blocks;
  const int s = b / tiles;
  const int tile = b - s * tiles;
  if (!first_source(src, s, n)) return;               // the whole block
  __shared__ int warp_cnt[kWarps];
  const int row = (int)src[s];
  const int warp = threadIdx.x >> 5;
  const long long t = (long long)tile * kThreads + threadIdx.x;
  const bool m = t < T && mask[t] != 0;
  const unsigned ms = __ballot_sync(kFull, m);
  if (lane == 0) warp_cnt[warp] = __popc(ms);
  __syncthreads();
  int rank = tile_off[tile] + __popc(ms & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_cnt[w];
  const int slot =
      m ? slot_of(n_seen[row] + rank, (unsigned)in_items[t], S, seed_mix)
        : -1;
  const unsigned writers = __ballot_sync(kFull, slot >= 0);
  if (slot < 0) return;
  if ((__match_any_sync(writers, slot) >> lane) != 1u) return;
  atomicMax(best + (size_t)(chunks + s) * S + slot, pack(rank, (int)t));
}

// Threads [0, entries): best's entries; then [entries, entries + T):
// sorted positions; then the n_src source rows.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(float* __restrict__ values, int32_t* __restrict__ items,
                int32_t* __restrict__ n_seen, int n, int S,
                const int32_t* __restrict__ in_items,
                const float* __restrict__ in_values, int T,
                const int64_t* __restrict__ src, int n_src,
                const int32_t* __restrict__ srow,
                const int32_t* __restrict__ count,
                const int32_t* __restrict__ run_start,
                const int32_t* __restrict__ tile_off, int tiles,
                const unsigned long long* __restrict__ best,
                long long chunks, long long entries) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < entries) {
    const unsigned long long v = best[i];
    if (v == 0ull) return;
    const long long w = i / S;
    const int slot = (int)(i - w * S);
    const int t = (int)(unsigned)(v & 0xffffffffull);
    // a crossing run holds its start chunk's last position
    const int32_t row =
        w < chunks ? srow[w * 32 + 31] : (int32_t)src[w - chunks];
    const size_t at = (size_t)row * S + slot;
    values[at] = in_values[t];
    items[at] = in_items[t];
    return;
  }
  const long long p = i - entries;
  if (p < T) {
    const long long len = *count;
    if (p >= len) return;
    const int32_t r = srow[p];
    if (p == len - 1 || srow[p + 1] != r) {
      n_seen[r] = (int32_t)((unsigned)n_seen[r] +
                            (unsigned)((int)p + 1 - run_start[r]));
    }
    return;
  }
  const int s = (int)(p - T);
  if (s < n_src && first_source(src, s, n)) {
    const int32_t r = (int32_t)src[s];
    n_seen[r] = (int32_t)((unsigned)n_seen[r] + (unsigned)tile_off[tiles]);
  }
}

// The scratch of a call, in int32 words from a 128-byte aligned base: the
// sort's, then the tuples' keys, run_start and run_end [n], the source
// flags (a byte a row), each tile's masked tuples and their prefix, and
// best [(chunks + n_src) * S] (8 bytes an entry).
struct Layout {
  long long key, run_start, run_end, flag, tile_cnt, tile_off, best, total;
  int tiles;
  long long chunks, entries;
};

Layout layout(int n, int S, int T, int n_src) {
  Layout l;
  l.tiles = (T + kThreads - 1) / kThreads;
  l.chunks = ((long long)T + 31) / 32;
  l.entries = (l.chunks + n_src) * (long long)S;
  l.key = sde::sort_words(T);
  l.run_start = l.key + sde::round32(T);
  l.run_end = l.run_start + sde::round32(n);
  l.flag = l.run_end + sde::round32(n);
  l.tile_cnt = l.flag + sde::round32(((long long)n + 3) / 4);
  l.tile_off = l.tile_cnt + sde::round32(l.tiles + 1);
  l.best = l.tile_off + sde::round32(l.tiles + 1);
  l.total = l.best + 2 * l.entries;
  return l;
}

}  // namespace

extern "C" {

// The scratch reservoir_scan needs, in int32 words.
int reservoir_words(int n, int S, int T, int n_src, long long* words) {
  *words = (T > 0 && n > 0 && S > 0) ? layout(n, S, T, n_src).total : 0;
  return 0;
}

// values [n, S] f32, items [n, S] i32, n_seen [n] i32 (updated in place);
// rows, in_items [T] i32; in_values [T] f32; mask [T] bytes (0 / 1); src
// [n_src] i64 (data-source rows, as the engine indexes them) or null;
// seed: the kind's; scratch:
// reservoir_words(n, S, T, n_src) words, 128-byte aligned.
int reservoir_scan(float* values, int32_t* items, int32_t* n_seen, int n,
                   int S, const int32_t* rows, const int32_t* in_items,
                   const float* in_values, const uint8_t* mask, int T,
                   const int64_t* src, int n_src, unsigned seed,
                   int32_t* scratch, cudaStream_t stream) {
  if (T <= 0 || n <= 0 || S <= 0) return 0;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (src == nullptr) n_src = 0;
  const unsigned seed_mix = seed * kGolden + 1u;
  const Layout l = layout(n, S, T, n_src);
  const sde::SortScratch s = sde::sort_scratch(scratch, T);
  int32_t* const key = scratch + l.key;
  int32_t* const run_start = scratch + l.run_start;
  int32_t* const run_end = scratch + l.run_end;
  int32_t* const tile_cnt = scratch + l.tile_cnt;
  int32_t* const tile_off = scratch + l.tile_off;
  unsigned long long* const best =
      reinterpret_cast<unsigned long long*>(scratch + l.best);
  uint8_t* flag = nullptr;
  cudaError_t err;
  if (n_src > 0) {
    flag = reinterpret_cast<uint8_t*>(scratch + l.flag);
    err = cudaMemsetAsync(flag, 0, (size_t)n, stream);
    if (err != cudaSuccess) return (int)err;
    flag_kernel<<<(n_src + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        src, n_src, n, flag);
  }
  key_kernel<<<l.tiles, kThreads, 0, stream>>>(
      rows, mask, T, n, flag, key, n_src > 0 ? tile_cnt : nullptr);
  if (n_src > 0) {
    scan_kernel<<<1, kScanThreads, 0, stream>>>(tile_cnt, l.tiles,
                                                tile_off);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sde::sort_rows(key, n, T, s, stream);
  if (err != cudaSuccess) return (int)err;
  bounds_kernel<<<l.tiles, kThreads, 0, stream>>>(s.srow, s.count,
                                                  run_start, run_end);
  err = cudaMemsetAsync(best, 0, sizeof(unsigned long long) * l.entries,
                        stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)l.tiles * (1 + n_src);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  place_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      values, items, n_seen, n, S, in_items, in_values, mask, T, src,
      seed_mix, s.srow, s.perm, s.count, run_start, run_end, tile_off,
      l.tiles, l.tiles, l.chunks, best);
  const long long threads = l.entries + T + n_src;
  const long long fin = (threads + kThreads - 1) / kThreads;
  if (fin > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  finalize_kernel<<<(unsigned)fin, kThreads, 0, stream>>>(
      values, items, n_seen, n, S, in_items, in_values, T, src, n_src,
      s.srow, s.count, run_start, tile_off, l.tiles, best, l.chunks,
      l.entries);
  return (int)cudaGetLastError();
}

}  // extern "C"
