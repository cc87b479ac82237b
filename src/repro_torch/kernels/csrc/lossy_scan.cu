// Lossy Counting's stacked scan for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package updates a Lossy Counting stack
// with LossyCounting.add_batch (src/repro/core/lossy.py:65, a lax.scan of
// the one-slot step over the batch) under the vmap of
// batched.stacked_update (src/repro/core/batched.py:92): every row scans
// the whole batch, masked to its own tuples, so capacity x T steps a batch.
// Here the batch is grouped by row first and each tuple is scanned once,
// by its own row:
//
//   row r in [0, n):        the tuples with mask & rows == r, in batch order
//   a data-source row:      every tuple with mask, routed or not, in order
//   every other row:        untouched
//
// A step (the reference's _step) on a table of k slots (keys int32, -1
// empty; counts and error float32) for item x of weight v: the first slot
// whose key is x gets count + v; else the first empty slot gets key x and
// 0 + v; else the first slot of least count (NaN least, as argmin) gets
// key x, count + v and error = its old count. A masked step of the
// reference writes every slot back unchanged, so dropping masked tuples
// gives its bytes. Each add is __fadd_rn (never contracted), so the state
// equals the plain version (ref.lossy_scan_update) byte for byte; there
// are no float atomics and no order that depends on scheduling.
//
// Launches, on the caller's stream:
//   * (data-source rows) a memset and flag_kernel: a byte per row, set for
//     the source rows, whose routed tuples the grouping drops (their walk
//     takes every masked tuple anyway).
//   * key_kernel: each tuple's row, or -1 where it is masked, unrouted,
//     outside [0, n) or routed to a source row.
//   * The stable row sort (row_sort.cuh) into srow / perm and the count of
//     kept tuples, which stays on the card: the host never waits.
//   * walk_kernel: warp w < S walks data-source row src[w] (a row listed
//     twice is walked once) over the whole batch, 32 tuples a load; warp
//     S + c takes the runs that start in chunk c of 32 sorted positions,
//     one after another, each to its end. The source warps come first in
//     the grid, so their long walks start with it.
// A warp holds its row's table from the start to the end of a walk, lane j
// the slots j, j + 32, ... . Up to 128 slots it holds them in registers
// (R = 1, 2 or 4 slots a lane, the fewest that hold k; a template
// parameter, so every loop over them unrolls): a step compares
// each lane's keys with the item, reduces each lane's candidates (a hit's
// slot, else k + an empty slot's) by a tree, and one redux.sync minimum
// over the lanes decides hit, empty or eviction for the whole warp; an
// eviction takes the first least count by (an order-preserving key of the
// count, slot) the same way, with two more. The slot's lane updates its
// registers by predicated selects: no branch diverges, nothing goes
// through memory but an eviction's error, stored to the state row (more
// slots a lane were slower: on an H100 at 700 W, chip_smoke's batch,
// k = 1,000 at 32 a lane took 113 ms, in shared memory 64 ms). The
// next step's item and weight are shuffled out before a step runs, and
// the next group's are loaded a group ahead (routed runs: their sort
// positions two groups ahead), so a step waits on no load.
// Larger tables live in shared memory (k x 12 bytes; lanes read their
// keys, a redux.sync minimum finds the slot, the counts are read only for
// an eviction, and __syncwarp orders the slot's write before the next
// step's reads), or, above a block's opt-in limit (232,448 bytes on an
// H100: k > 19,370), in place in device memory by the same code.
//
// Bounds on this card. Bytes: the batch (rows, items, values, mask) read
// once and each walked row's table read and written once. The chain: a
// row's steps depend one on the next, and a data-source row walks every
// masked tuple of the batch (~62,000 at chip_smoke's batch): far above the
// byte bound. Walking a row's steps in parallel would change the order,
// and the order is the result.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "row_sort.cuh"

namespace {

constexpr int kThreads = 256;     // flag_kernel and key_kernel
constexpr int kWalkWarps = 4;     // walk_kernel warps a block, at most
constexpr int kMaxRegSlots = 128;   // tables up to 4 slots a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = -1;    // the bits of 0xFFFFFFFF
constexpr int kNone = INT_MAX;

__global__ void flag_kernel(const int32_t* __restrict__ src, int n_src,
                            int n, uint8_t* __restrict__ flag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_src) {
    const int32_t r = src[i];
    if (r >= 0 && r < n) flag[r] = 1;
  }
}

__global__ void key_kernel(const int32_t* __restrict__ rows,
                           const uint8_t* __restrict__ mask, int T, int n,
                           const uint8_t* __restrict__ flag,
                           int32_t* __restrict__ key) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int32_t r = rows[t];
  const bool keep = mask[t] != 0 && r >= 0 && r < n &&
                    (flag == nullptr || flag[r] == 0);
  key[t] = keep ? r : -1;
}

// An order-preserving key of a count for the argmin: equal floats give
// equal keys (-0 as +0), NaN the least (argmin returns the first NaN).
__device__ __forceinline__ unsigned order_key(float c) {
  if (c != c) return 0u;
  unsigned u = __float_as_uint(c);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A table of k slots in memory: shared (copied in and out by the walker)
// or the state row itself in device memory.
struct Table {
  int32_t* keys;
  float* counts;
  float* error;
};

// One step of item x, weight v on a table in memory (every lane calls it).
// The keys are read first; the counts only where no slot holds x or is
// empty (an eviction), else the chosen slot's count alone.
__device__ __forceinline__ void mem_step(const Table& tb, int k, int32_t x,
                                         float v) {
  const int lane = threadIdx.x & 31;
  int hit = kNone, emp = kNone;
  for (int j = lane; j < k; j += 32) {
    const int32_t key = tb.keys[j];
    if (key == x && hit == kNone) hit = j;
    if (key == kEmpty && emp == kNone) emp = j;
  }
  int slot = __reduce_min_sync(kFull, hit);
  if (slot != kNone) {
    if (lane == (slot & 31)) {          // the key is x already
      tb.counts[slot] = __fadd_rn(tb.counts[slot], v);
    }
  } else if ((slot = __reduce_min_sync(kFull, emp)) != kNone) {
    if (lane == (slot & 31)) {
      tb.keys[slot] = x;
      tb.counts[slot] = __fadd_rn(0.0f, v);
    }
  } else {
    // the first least count: each lane's first, then the lowest slot of
    // the lanes whose least is the warp's
    int low = kNone;
    float low_c = 0.0f;
    unsigned low_key = 0xffffffffu;   // above every count's key
    for (int j = lane; j < k; j += 32) {
      const float c = tb.counts[j];
      const unsigned o = order_key(c);
      if (o < low_key) {
        low_key = o;
        low = j;
        low_c = c;
      }
    }
    const unsigned m = __reduce_min_sync(kFull, low_key);
    slot = __reduce_min_sync(kFull, low_key == m ? low : kNone);
    if (lane == (slot & 31)) {          // its own first least: low_c
      tb.keys[slot] = x;
      tb.counts[slot] = __fadd_rn(low_c, v);
      tb.error[slot] = low_c;
    }
  }
  __syncwarp();
}

// A warp's walker of one row's table. R > 0: the table in registers, lane
// j holding slots j, j + 32, ..., j + 32 (R - 1) (k <= 32 R), and error
// written straight to the state row; R == 0: in shared memory (`smem`,
// 3 k words); R < 0: the state row itself in device memory.
template <int R>
struct Walker {
  static constexpr int kR = R > 0 ? R : 1;
  int k;
  int32_t* keys;      // the state row's
  float* counts;
  float* error;
  Table tb;           // R <= 0
  int32_t key[kR];    // R > 0
  float cnt[kR];

  __device__ __forceinline__ void open(int32_t* keys_all, float* counts_all,
                                       float* error_all, int k_, int row,
                                       int32_t* smem) {
    const int lane = threadIdx.x & 31;
    const long long base = (long long)row * k_;
    k = k_;
    keys = keys_all + base;
    counts = counts_all + base;
    error = error_all + base;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        key[r] = j < k ? keys[j] : kEmpty;
        cnt[r] = j < k ? counts[j] : 0.0f;
      }
    } else if constexpr (R == 0) {
      tb = Table{smem, reinterpret_cast<float*>(smem + k),
                 reinterpret_cast<float*>(smem + 2 * k)};
      for (int j = lane; j < k; j += 32) {
        tb.keys[j] = keys[j];
        tb.counts[j] = counts[j];
        tb.error[j] = error[j];
      }
      __syncwarp();
    } else {
      tb = Table{keys, counts, error};
    }
  }

  __device__ __forceinline__ void close() {
    const int lane = threadIdx.x & 31;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        if (j < k) {
          keys[j] = key[r];
          counts[j] = cnt[r];
        }
      }
    } else if constexpr (R == 0) {
      __syncwarp();
      for (int j = lane; j < k; j += 32) {
        keys[j] = tb.keys[j];
        counts[j] = tb.counts[j];
        error[j] = tb.error[j];
      }
    }
    __syncwarp();
  }

  // One step. In registers: each lane's candidates (a hit's slot, else k +
  // an empty slot's) reduced by a tree over its R slots and one redux.sync
  // over the lanes decide hit, empty or eviction for the whole warp; an
  // eviction takes the first least count the same way, by (order key,
  // slot). The slot's lane updates its register; no branch diverges.
  __device__ __forceinline__ void step(int32_t x, float v) {
    if constexpr (R <= 0) {
      mem_step(tb, k, x, v);
    } else {
      const int lane = threadIdx.x & 31;
      int c[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {     // selects, not branches
        const int j = r * 32 + lane;
        const bool valid = j < k;
        const bool hit = valid & (key[r] == x);
        const bool empty = valid & (key[r] == kEmpty);
        c[r] = hit ? j : empty ? k + j : kNone;
      }
#pragma unroll
      for (int s = 1; s < R; s *= 2) {
#pragma unroll
        for (int r = 0; r + s < R; r += 2 * s) c[r] = min(c[r], c[r + s]);
      }
      const int sel = __reduce_min_sync(kFull, c[0]);
      if (sel < k) {                    // a hit: the key is x already
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cnt[r] = sel == r * 32 + lane ? __fadd_rn(cnt[r], v) : cnt[r];
        }
      } else if (sel != kNone) {        // the first empty slot
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool mine = sel - k == r * 32 + lane;
          key[r] = mine ? x : key[r];
          cnt[r] = mine ? __fadd_rn(0.0f, v) : cnt[r];
        }
      } else {                          // evict the first least count
        unsigned o[R];
        int at[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          at[r] = r * 32 + lane;
          o[r] = at[r] < k ? order_key(cnt[r]) : 0xffffffffu;
        }
#pragma unroll
        for (int s = 1; s < R; s *= 2) {
#pragma unroll
          for (int r = 0; r + s < R; r += 2 * s) {
            if (o[r + s] < o[r]) {      // the left one is the lower slot
              o[r] = o[r + s];
              at[r] = at[r + s];
            }
          }
        }
        const unsigned m = __reduce_min_sync(kFull, o[0]);
        const int slot = __reduce_min_sync(kFull, o[0] == m ? at[0] : kNone);
        float old = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool mine = slot == r * 32 + lane;
          old = mine ? cnt[r] : old;
          key[r] = mine ? x : key[r];
          cnt[r] = mine ? __fadd_rn(cnt[r], v) : cnt[r];
        }
        if (lane == (slot & 31)) error[slot] = old;
      }
    }
  }
};

// Steps of the lanes in `in` (a mask of lanes), in lane order; lane i holds
// the i-th tuple's item and weight. The next step's item is shuffled out
// before this step runs, off its chain.
template <class W>
__device__ __forceinline__ void steps(W& w, unsigned in, int32_t x,
                                      float v) {
  if (in == 0u) return;
  int s = __ffs(in) - 1;
  in &= in - 1u;
  int32_t xs = __shfl_sync(kFull, x, s);
  float vs = __shfl_sync(kFull, v, s);
  while (true) {
    const bool more = in != 0u;
    s = more ? __ffs(in) - 1 : 0;
    in &= in - 1u;
    const int32_t xn = __shfl_sync(kFull, x, s);
    const float vn = __shfl_sync(kFull, v, s);
    w.step(xs, vs);
    if (!more) break;
    xs = xn;
    vs = vn;
  }
}

// A data-source row: every masked tuple of the batch, in order, 32 a
// group, the next group loaded during this one's steps.
template <class W>
__device__ __forceinline__ void walk_source(W& w,
                                            const int32_t* __restrict__ items,
                                            const float* __restrict__ values,
                                            const uint8_t* __restrict__ mask,
                                            int T) {
  const int lane = threadIdx.x & 31;
  bool ok = lane < T && mask[lane] != 0;
  int32_t x = ok ? items[lane] : 0;
  float v = ok ? values[lane] : 0.0f;
  for (long long g = 0; g < T; g += 32) {
    const long long q = g + 32 + lane;
    const bool ok1 = q < T && mask[q] != 0;
    const int32_t x1 = ok1 ? items[q] : 0;
    const float v1 = ok1 ? values[q] : 0.0f;
    steps(w, __ballot_sync(kFull, ok), x, v);
    ok = ok1;
    x = x1;
    v = v1;
  }
}

// A run of `row` from sorted position p0 to its end: the positions of a
// group that still hold `row` are a prefix of it (the rows are sorted).
// Group g's items and weights are in registers; g + 32's sort positions
// were read one group before; g + 64's are read now.
template <class W>
__device__ __forceinline__ void walk_run(W& w, int row, long long p0,
                                         long long len,
                                         const int32_t* __restrict__ srow,
                                         const int32_t* __restrict__ perm,
                                         const int32_t* __restrict__ items,
                                         const float* __restrict__ values) {
  const int lane = threadIdx.x & 31;
  long long p = p0 + lane;
  bool ok = p < len && srow[p] == row;
  const int t0 = ok ? perm[p] : 0;
  p += 32;
  bool ok1 = p < len && srow[p] == row;
  int t1 = ok1 ? perm[p] : 0;
  int32_t x = ok ? items[t0] : 0;
  float v = ok ? values[t0] : 0.0f;
  for (long long g = p0;; g += 32) {
    const unsigned in = __ballot_sync(kFull, ok);
    const int32_t x1 = ok1 ? items[t1] : 0;
    const float v1 = ok1 ? values[t1] : 0.0f;
    const long long q = g + 64 + lane;
    const bool ok2 = in == kFull && q < len && srow[q] == row;
    const int t2 = ok2 ? perm[q] : 0;
    steps(w, in, x, v);
    if (in != kFull) break;
    ok = ok1;
    x = x1;
    v = v1;
    ok1 = ok2;
    t1 = t2;
  }
}

template <int R>
__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(int32_t* __restrict__ keys, float* __restrict__ counts,
            float* __restrict__ error, int n, int k,
            const int32_t* __restrict__ items,
            const float* __restrict__ values,
            const uint8_t* __restrict__ mask, int T,
            const int32_t* __restrict__ src, int n_src,
            const int32_t* __restrict__ srow,
            const int32_t* __restrict__ perm,
            const int32_t* __restrict__ count) {
  extern __shared__ int32_t smem_all[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  int32_t* const smem = smem_all + (R == 0 ? (long long)wib * 3 * k : 0);
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  Walker<R> walker;
  if (w < n_src) {
    const int32_t row = src[w];
    if (row < 0 || row >= n) return;
    for (long long i = 0; i < w; ++i) {
      if (src[i] == row) return;      // listed before: walked there
    }
    walker.open(keys, counts, error, k, row, smem);
    walk_source(walker, items, values, mask, T);
    walker.close();
    return;
  }
  const long long len = *count;
  const long long c0 = (w - n_src) * 32;
  if (c0 >= len) return;
  const long long p = c0 + lane;
  const int32_t r = p < len ? srow[p] : -1;
  const bool start = p < len && (p == 0 || srow[p - 1] != r);
  unsigned starts = __ballot_sync(kFull, start);
  while (starts != 0u) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int row = __shfl_sync(kFull, r, s);
    walker.open(keys, counts, error, k, row, smem);
    walk_run(walker, row, c0 + s, len, srow, perm, items, values);
    walker.close();
  }
}

// The scratch of a call, in int32 words: the sort's, then the tuples' keys
// and the source rows' flags (a byte a row).
long long key_word(int T) { return sde::sort_words(T); }
long long flag_word(int T) { return key_word(T) + sde::round32(T); }
long long total_words(int n, int T) {
  return flag_word(T) + sde::round32(((long long)n + 3) / 4);
}

int max_shared() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return cached[dev];
}

template <int R>
cudaError_t launch_walk(int warps_per_block, size_t smem, int32_t* keys,
                        float* counts, float* error, int n, int k,
                        const int32_t* items, const float* values,
                        const uint8_t* mask, int T, const int32_t* src,
                        int n_src, const sde::SortScratch& s,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long warps = (long long)n_src + ((long long)T + 31) / 32;
  const long long blocks = (warps + warps_per_block - 1) / warps_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  walk_kernel<R><<<(unsigned)blocks, warps_per_block * 32, smem, stream>>>(
      keys, counts, error, n, k, items, values, mask, T, src, n_src, s.srow,
      s.perm, s.count);
  return cudaGetLastError();
}

// The walk for a table of k slots: in registers up to kMaxRegSlots, 32 R
// slots a warp for the least R of 1, 2, 4 that holds k; else in shared
// memory while it fits a block's; else in device memory.
cudaError_t walk(int32_t* keys, float* counts, float* error, int n, int k,
                 const int32_t* items, const float* values,
                 const uint8_t* mask, int T, const int32_t* src, int n_src,
                 const sde::SortScratch& s, cudaStream_t stream) {
#define SDE_LOSSY_WALK(R, wpb, smem)                                         \
  launch_walk<R>(wpb, smem, keys, counts, error, n, k, items, values, mask, \
                 T, src, n_src, s, stream)
  if (k <= 32) return SDE_LOSSY_WALK(1, kWalkWarps, 0);
  if (k <= 64) return SDE_LOSSY_WALK(2, kWalkWarps, 0);
  if (k <= kMaxRegSlots) return SDE_LOSSY_WALK(4, kWalkWarps, 0);
  const size_t table = (size_t)k * 12;
  const int limit = max_shared();
  if (table <= (size_t)limit) {
    int wpb = (int)((size_t)limit / table);
    wpb = wpb < kWalkWarps ? wpb : kWalkWarps;
    return SDE_LOSSY_WALK(0, wpb, table * wpb);
  }
  return SDE_LOSSY_WALK(-1, kWalkWarps, 0);
#undef SDE_LOSSY_WALK
}

}  // namespace

extern "C" {

// The scratch lossy_scan needs, in int32 words.
int lossy_words(int n, int T, long long* words) {
  *words = (T > 0 && n > 0) ? total_words(n, T) : 0;
  return 0;
}

// The most k whose table a warp holds in shared memory (larger tables are
// walked in device memory).
int lossy_max_shared_k(int* k) {
  *k = max_shared() / 12;
  return 0;
}

// keys [n, k] i32, counts and error [n, k] f32 (updated in place); rows,
// items [T] i32; values [T] f32; mask [T] bytes (0 / 1); src [n_src] i32
// (data-source rows) or null; scratch: lossy_words(n, T) words, 128-byte
// aligned.
int lossy_scan(int32_t* keys, float* counts, float* error, int n, int k,
               const int32_t* rows, const int32_t* items,
               const float* values, const uint8_t* mask, int T,
               const int32_t* src, int n_src, int32_t* scratch,
               cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  if (k < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (src == nullptr) n_src = 0;
  const sde::SortScratch s = sde::sort_scratch(scratch, T);
  int32_t* const key = scratch + key_word(T);
  uint8_t* flag = nullptr;
  cudaError_t err;
  if (n_src > 0) {
    flag = reinterpret_cast<uint8_t*>(scratch + flag_word(T));
    err = cudaMemsetAsync(flag, 0, (size_t)n, stream);
    if (err != cudaSuccess) return (int)err;
    flag_kernel<<<(n_src + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        src, n_src, n, flag);
  }
  key_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      rows, mask, T, n, flag, key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sde::sort_rows(key, n, T, s, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)walk(keys, counts, error, n, k, items, values, mask, T, src,
                   n_src, s, stream);
}

}  // extern "C"
