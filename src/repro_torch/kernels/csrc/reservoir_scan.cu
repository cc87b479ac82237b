// The reservoir sampler's stacked update for Hopper (sm_90a), with the
// routing probe fused in or the rows given.
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
//
// What bounds it on this card: not its bytes (about 1 MB a batch of
// 65,536 tuples, 0.3 us at 3.35 TB/s) but the dependent steps between
// them: a stable grouping by row in two digit passes, each reading what
// the one before wrote, then the placing, then the last writers. One
// launch a step would make 13 device activities a call, each step waiting
// on a launch. So the whole update is ONE persistent launch
// (cudaLaunchCooperativeKernel: every block resident, at most one an SM)
// whose phases are separated by grid-wide barriers (cooperative groups'
// grid.sync()), and no memset: the words that a phase accumulates into
// are zero on entry, and the phase after their last reader sets them to
// zero again. Phases (a block takes virtual blocks, tiles or items, in a
// grid-stride loop):
//
//   A  each tuple's row (sde::probe_row on the routing table when it is
//      not given; masked tuples are not probed), its key (-1 where it is
//      masked, unrouted, outside [0, n) or routed to a data-source row,
//      whose walk takes every masked tuple anyway), each 512-tuple tile's
//      masked tuples, and the first digit pass's histogram
//      (row_sort.cuh's sort_hist_keys, the keys in registers)
//   S  per digit pass, the stable scatter (sort_scatter_tile), and after
//      the first, the next pass's histogram behind a barrier of its own;
//      the last pass also records each row's run [first, one past the
//      last) of sorted positions by integer atomicMax. The first pass's
//      last block scans the tiles' masked counts: a source walk's rank is
//      the masked tuples before.
//   P  a thread a (walk, tuple) pair, the routed positions first, then a
//      block a (source row, tile). Each computes its slot (native uint32
//      arithmetic, __fmul_rn / __uint2float_rn / __int2float_rn /
//      __float2int_rz, so nothing is contracted or rounded otherwise), and
//      the writers of a warp that share a (row, slot) keep only their last
//      lane (__match_any_sync). A routed run within one warp's 32
//      positions is then complete: its last writers store their slots at
//      once. A run that crosses a warp's end, and every source walk, keep
//      the largest (rank + 1, tuple) per slot by a 64-bit atomicMax into
//      best[walk, slot] (the walk of a crossing run is the chunk of 32
//      positions it starts in, that of source row s its index past the
//      chunks), a reduction that returns nothing, so P waits on no
//      atomic. P also zeroes the sort's digit sums.
//   G  each set entry of best stores its tuple's value and item and is
//      zeroed; each run's last position adds the run's length to its
//      row's n_seen and zeroes the row's run bounds; each source row adds
//      the batch's masked tuples.
//
// No order depends on scheduling (a maximum is a maximum, a sum a sum), so
// the state equals the plain version (ref.reservoir_scan_update) byte for
// byte. At n = 131,072 rows: 2 digit passes, 5 barriers, 1 launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "probe.cuh"
#include "row_sort.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = sde::kSortThreads;   // 512: a tile of P
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNMult = 2654435761u;     // 0x9E3779B1
constexpr unsigned kGolden = 0x9E3779B9u;    // the seed's multiplier
constexpr float kTwoM32 = 2.3283064365386963e-10f;   // 2**-32
static_assert(sde::kSortTile == 2 * kThreads, "a sort tile is two P tiles");

// The slot a tuple of item x that arrives at count n writes, or -1 (also
// for a count below 0, outside the contract, so that no write leaves the
// row).
__device__ __forceinline__ int slot_of(int n, unsigned x, int S,
                                       unsigned seed_mix) {
  if (n < 0) return -1;
  if (n < S) return n;
  const unsigned h = sde::mix32(((unsigned)n * kNMult ^ x) ^ seed_mix);
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

__device__ __forceinline__ bool is_source(const int64_t* src, int n_src,
                                          int32_t r) {
  for (int i = 0; i < n_src; ++i) {
    if (src[i] == r) return true;
  }
  return false;
}

struct Params {
  float* values;
  int32_t* items;
  int32_t* n_seen;
  int n, S;
  const int32_t* rows;             // null: probe the routing table
  const uint32_t* keys_lo;
  const uint32_t* keys_hi;
  const int32_t* table_rows;
  uint32_t size;
  const uint32_t* sid_lo;
  const uint32_t* sid_hi;
  int n_probe;
  const int32_t* in_items;
  const float* in_values;
  const uint8_t* mask;
  int T;
  const int64_t* src;
  int n_src;
  unsigned seed_mix;
  sde::SortScratch sort;
  sde::SortPlan plan;
  int32_t* key;
  int32_t* head;                   // [n]: kHeadBias - a run's first position
  int32_t* end;                    // [n]: one past a run's last position
  int32_t* tile_cnt;               // [tiles]: masked tuples of a P tile
  int32_t* tile_off;               // [tiles + 1]: their exclusive prefix
  int tiles;
  long long chunks;
  unsigned long long* best;        // [entries]: (chunks + n_src) * S
  long long entries;
};

// Phase A for sort tile vb: keys at the positions the histogram reads.
__device__ __forceinline__ void key_tile(const Params& p, int vb) {
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i0 = sde::tile_base(vb);
  int key[sde::kSortItems];
  int masked = 0;
#pragma unroll
  for (int r = 0; r < sde::kSortItems; ++r) {
    const long long t = i0 + r * 32;
    const bool in = t < p.T;
    const bool m = in && p.mask[t] != 0;
    int32_t row = in && p.rows != nullptr ? __ldg(p.rows + t) : -1;
    if (m && p.rows == nullptr) {
      row = sde::probe_row(p.keys_lo, p.keys_hi, p.table_rows, p.size,
                           __ldg(p.sid_lo + t), __ldg(p.sid_hi + t),
                           p.n_probe);
    }
    const bool keep =
        m && row >= 0 && row < p.n && !is_source(p.src, p.n_src, row);
    key[r] = keep ? row : -1;
    if (in) p.key[t] = key[r];
    masked += __popc(__ballot_sync(kFull, m));
  }
  if (p.n_src > 0) {        // warps [0, 8) cover P tile 2 vb, [8, 16) the next
    if (lane == 0) warp_cnt[warp] = masked;
    __syncthreads();
    if (threadIdx.x < 2 && 2 * vb + (int)threadIdx.x < p.tiles) {
      int c = 0;
      for (int w = 0; w < kWarps / 2; ++w)
        c += warp_cnt[threadIdx.x * (kWarps / 2) + w];
      p.tile_cnt[2 * vb + threadIdx.x] = c;
    }
  }
  sde::sort_hist_keys(vb, key, p.n, 0, p.plan.bits, p.sort.hist,
                      p.sort.sums);
}

// tile_off[i] = tile_cnt[0] + ... + tile_cnt[i - 1] for i <= tiles; one
// block.
__device__ __forceinline__ void scan_tiles(const Params& p) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < p.tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < p.tiles ? __ldcg(p.tile_cnt + i) : 0;
    int x = v;                                  // inclusive over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int before = carry + x - v;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (i < p.tiles) p.tile_off[i] = before;
    __syncthreads();
    if (threadIdx.x == kThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) p.tile_off[p.tiles] = carry;
}

// Phase P, sorted positions [q0, q0 + kThreads): the count is read with
// the positions' rows, which past it are stale and not used.
__device__ __forceinline__ void place_routed(const Params& p,
                                             long long q0) {
  const int lane = threadIdx.x & 31;
  const long long q = q0 + threadIdx.x;
  const bool in = q < p.T;
  const int len = __ldcg(p.sort.count);
  const int srow = in ? __ldcg(p.sort.srow + q) : 0;
  const int perm = in ? __ldcg(p.sort.perm + q) : 0;
  int row = 0, rank = 0, t = 0, start = 0, stop = 0, slot = -1, item = 0;
  float value = 0.0f;
  if (q < len) {             // the value is read with the item, stored or not
    row = srow;
    t = perm;
    start = sde::kHeadBias - __ldcg(p.head + row);
    stop = __ldcg(p.end + row);
    item = p.in_items[t];
    value = p.in_values[t];
    rank = (int)q - start;
    slot = slot_of(p.n_seen[row] + rank, (unsigned)item, p.S, p.seed_mix);
  }
  const unsigned writers = __ballot_sync(kFull, slot >= 0);
  if (slot < 0) return;
  const unsigned long long rs =
      ((unsigned long long)(unsigned)row << 32) | (unsigned)slot;
  if ((__match_any_sync(writers, rs) >> lane) != 1u) return;  // later
  if ((start >> 5) == ((stop - 1) >> 5)) {           // all in this warp
    const size_t at = (size_t)row * p.S + slot;
    p.values[at] = value;
    p.items[at] = item;
  } else {
    atomicMax(p.best + (long long)(start >> 5) * p.S + slot, pack(rank, t));
  }
}

// Phase P, source row src[s] over batch positions [tile * kThreads, ...).
__device__ __forceinline__ void place_source(const Params& p, int s,
                                             int tile) {
  __shared__ int warp_cnt[kWarps];
  if (!first_source(p.src, s, p.n)) return;          // the whole block
  __syncthreads();                 // warp_cnt is free (the block's last item)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (int)p.src[s];
  const long long t = (long long)tile * kThreads + threadIdx.x;
  const bool m = t < p.T && p.mask[t] != 0;
  const unsigned ms = __ballot_sync(kFull, m);
  if (lane == 0) warp_cnt[warp] = __popc(ms);
  __syncthreads();
  int rank = __ldcg(p.tile_off + tile) + __popc(ms & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_cnt[w];
  const int slot = m ? slot_of(p.n_seen[row] + rank, (unsigned)p.in_items[t],
                               p.S, p.seed_mix)
                     : -1;
  const unsigned writers = __ballot_sync(kFull, slot >= 0);
  if (slot < 0) return;
  if ((__match_any_sync(writers, slot) >> lane) != 1u) return;
  atomicMax(p.best + (p.chunks + s) * p.S + slot, pack(rank, (int)t));
}

__global__ void __launch_bounds__(kThreads)
reservoir_kernel(const Params p) {
  const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gthreads = (long long)gridDim.x * kThreads;
  cg::grid_group grid = cg::this_grid();
  // A
  for (int vb = blockIdx.x; vb < p.sort.blocks; vb += gridDim.x)
    key_tile(p, vb);
  grid.sync();
  // S
  for (int pass = 0; pass < p.plan.passes; ++pass) {
    const sde::SortPass q = sde::sort_pass(p.sort, p.key, pass, p.plan);
    if (pass > 0) {
      for (int vb = blockIdx.x; vb < p.sort.blocks; vb += gridDim.x)
        sde::sort_hist_tile<true>(vb, q.in_k, p.n, p.T, p.sort.count, false,
                                  q.shift, p.plan.bits, p.sort.hist, q.sums);
      grid.sync();
    }
    const bool last = pass == p.plan.passes - 1;
    for (int vb = blockIdx.x; vb < p.sort.blocks; vb += gridDim.x)
      sde::sort_scatter_tile<true>(vb, q.in_k, q.in_p, p.n, p.T, p.sort.count,
                                   q.shift, p.plan.bits, p.sort.hist, q.sums,
                                   q.out_k, q.out_p, last ? p.head : nullptr,
                                   last ? p.end : nullptr);
    if (pass == 0 && p.n_src > 0 && blockIdx.x == gridDim.x - 1)
      scan_tiles(p);
    grid.sync();
  }
  // P
  for (long long i = gtid; i < p.sort.sums_words; i += gthreads)
    p.sort.sums[i] = 0;
  const int items = p.tiles * (1 + p.n_src);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < p.tiles) {
      place_routed(p, (long long)it * kThreads);
    } else {
      const int s = (it - p.tiles) / p.tiles;
      place_source(p, s, it - p.tiles - s * p.tiles);
    }
  }
  grid.sync();
  // G: two entries of best and a sorted position a thread at a time, their
  // loads in flight together
  const long long len = __ldcg(p.sort.count);
  const long long half = (p.entries + 1) / 2;
  const long long span = half > len + p.n_src ? half : len + p.n_src;
  for (long long i = gtid; i < span; i += gthreads) {
    unsigned long long v[2] = {0ull, 0ull};
    for (int k = 0; k < 2; ++k) {
      if (i < half && i + k * half < p.entries)
        v[k] = __ldcg(p.best + i + k * half);
    }
    const bool at_q = i < len;
    const int32_t r = at_q ? __ldcg(p.sort.srow + i) : 0;
    const int32_t r_next = at_q && i + 1 < len ? __ldcg(p.sort.srow + i + 1)
                                               : -1;
    for (int k = 0; k < 2; ++k) {
      if (v[k] == 0ull) continue;
      const long long e = i + k * half;
      p.best[e] = 0ull;
      const long long w = e / p.S;
      const int slot = (int)(e - w * p.S);
      const int t = (int)(unsigned)(v[k] & 0xffffffffull);
      // a crossing run holds its start chunk's last position
      const int32_t row = w < p.chunks ? __ldcg(p.sort.srow + w * 32 + 31)
                                       : (int32_t)p.src[w - p.chunks];
      const size_t at = (size_t)row * p.S + slot;
      p.values[at] = p.in_values[t];
      p.items[at] = p.in_items[t];
    }
    if (at_q && r_next != r) {                    // the run's last position
      const int start = sde::kHeadBias - __ldcg(p.head + r);
      p.n_seen[r] = (int32_t)((unsigned)p.n_seen[r] +
                              (unsigned)((int)i + 1 - start));
      p.head[r] = 0;
      p.end[r] = 0;
    }
    if (i >= len && i < len + p.n_src) {
      const int s = (int)(i - len);
      if (first_source(p.src, s, p.n)) {
        const int32_t row = (int32_t)p.src[s];
        p.n_seen[row] = (int32_t)((unsigned)p.n_seen[row] +
                                  (unsigned)__ldcg(p.tile_off + p.tiles));
      }
    }
  }
}

// The scratch of a call, in int32 words from a 128-byte aligned base: the
// sort's (its digit sums zero on entry), the
// tuples' keys, head and end [n] (zero on entry), each P tile's masked
// tuples and their prefix, and best [(chunks + n_src) * S] (8 bytes an
// entry, zero on entry).
struct Layout {
  long long sort, key, head, end, tile_cnt, tile_off, best, total;
  int tiles;
  long long chunks, entries;
};

Layout layout(int n, int S, int T, int n_src) {
  Layout l;
  l.tiles = (T + kThreads - 1) / kThreads;
  l.chunks = ((long long)T + 31) / 32;
  l.entries = (l.chunks + n_src) * (long long)S;
  l.sort = 0;
  l.key = l.sort + sde::sort_words(T);
  l.head = l.key + sde::round32(T);
  l.end = l.head + sde::round32(n);
  l.tile_cnt = l.end + sde::round32(n);
  l.tile_off = l.tile_cnt + sde::round32(l.tiles + 1);
  l.best = l.tile_off + sde::round32(l.tiles + 1);
  l.total = l.best + 2 * l.entries;
  return l;
}

// Blocks of the cooperative grid: one an SM at most, and no more than the
// largest phase's work items; 0 if the kernel cannot be resident.
int grid_blocks(int tiles, int n_src, int sort_blocks) {
  static int resident[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (resident[dev] == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident[dev], reservoir_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  if (resident[dev] == 0) return 0;
  long long work = (long long)tiles * (1 + n_src);
  if (work < sort_blocks) work = sort_blocks;
  const int sms = sde::sm_count();
  return (int)(work < sms ? work : sms);
}

int launch(Params& p, int32_t* scratch, cudaStream_t stream) {
  if (p.T <= 0 || p.n <= 0 || p.S <= 0) return 0;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (p.src == nullptr) p.n_src = 0;
  const Layout l = layout(p.n, p.S, p.T, p.n_src);
  if ((long long)l.tiles * (1 + p.n_src) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.sort = sde::sort_scratch(scratch + l.sort, p.T);
  p.plan = sde::sort_plan(p.n);
  p.key = scratch + l.key;
  p.head = scratch + l.head;
  p.end = scratch + l.end;
  p.tile_cnt = scratch + l.tile_cnt;
  p.tile_off = scratch + l.tile_off;
  p.tiles = l.tiles;
  p.chunks = l.chunks;
  p.best = reinterpret_cast<unsigned long long*>(scratch + l.best);
  p.entries = l.entries;
  const int blocks = grid_blocks(l.tiles, p.n_src, p.sort.blocks);
  if (blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)reservoir_kernel,
                                          dim3(blocks), dim3(kThreads), args,
                                          0, stream);
}

}  // namespace

extern "C" {

// The scratch a reservoir update needs, in int32 words.
int reservoir_words(int n, int S, int T, int n_src, long long* words) {
  *words = (T > 0 && n > 0 && S > 0) ? layout(n, S, T, n_src).total : 0;
  return 0;
}

// values [n, S] f32, items [n, S] i32, n_seen [n] i32 (updated in place);
// rows, in_items [T] i32; in_values [T] f32; mask [T] bytes (0 / 1); src
// [n_src] i64 (data-source rows, as the engine indexes them) or null;
// seed: the kind's; scratch: reservoir_words(n, S, T, n_src) words,
// 128-byte aligned, all zero before its first call at these sizes (each
// call leaves the words it needs zero so).
int reservoir_scan(float* values, int32_t* items, int32_t* n_seen, int n,
                   int S, const int32_t* rows, const int32_t* in_items,
                   const float* in_values, const uint8_t* mask, int T,
                   const int64_t* src, int n_src, unsigned seed,
                   int32_t* scratch, cudaStream_t stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.values = values;
  p.items = items;
  p.n_seen = n_seen;
  p.n = n;
  p.S = S;
  p.rows = rows;
  p.in_items = in_items;
  p.in_values = in_values;
  p.mask = mask;
  p.T = T;
  p.src = src;
  p.n_src = n_src;
  p.seed_mix = seed * kGolden + 1u;
  return launch(p, scratch, stream);
}

// The same with each tuple's row probed from the routing-table mirror
// (keys_lo / keys_hi / table_rows of pow2 `size`) for the stream-id halves
// sid_lo / sid_hi [T], at most n_probe slots (-1: unrouted).
int reservoir_probe_scan(float* values, int32_t* items, int32_t* n_seen,
                         int n, int S, const uint32_t* keys_lo,
                         const uint32_t* keys_hi, const int32_t* table_rows,
                         int size, const uint32_t* sid_lo,
                         const uint32_t* sid_hi, int n_probe,
                         const int32_t* in_items, const float* in_values,
                         const uint8_t* mask, int T, const int64_t* src,
                         int n_src, unsigned seed, int32_t* scratch,
                         cudaStream_t stream) {
  if (size <= 0) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.values = values;
  p.items = items;
  p.n_seen = n_seen;
  p.n = n;
  p.S = S;
  p.keys_lo = keys_lo;
  p.keys_hi = keys_hi;
  p.table_rows = table_rows;
  p.size = (uint32_t)size;
  p.sid_lo = sid_lo;
  p.sid_hi = sid_hi;
  p.n_probe = n_probe;
  p.in_items = in_items;
  p.in_values = in_values;
  p.mask = mask;
  p.T = T;
  p.src = src;
  p.n_src = n_src;
  p.seed_mix = seed * kGolden + 1u;
  return launch(p, scratch, stream);
}

}  // extern "C"
