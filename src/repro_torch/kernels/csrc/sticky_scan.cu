// Sticky Sampling's stacked update for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package updates a Sticky Sampling stack
// with StickySampling.add_batch (src/repro/core/sticky.py:86, a lax.scan of
// _step over the batch) under the vmap of batched.stacked_update
// (src/repro/core/batched.py:92): every row steps through the whole batch,
// masked to its own tuples, so capacity x T steps a batch. A masked step
// is not a no-op there: it takes the bump check at the row's n_seen + 1
// (want_epoch above the epoch: every slot loses its geometric draw, slots
// at 0 or below are emptied, the epoch rises); only the count and the slot
// write are masked. A check at one count bumps at most once, so a row's
// steps come to:
//
//   every row:            the check at the batch's first step
//   row r in [0, n):      a check then a step for each tuple with
//                         mask & rows == r, in batch order
//   a data-source row:    the same for every tuple with mask
//   a walked row:         where its last tuple is not the batch's last,
//                         the check the step after it takes
//
// A step (the reference's _step after its check) on a table of cap slots
// (keys int32, -1 empty; counts float32) for item x arriving at count n:
// the first slot whose key is x gets count + 1; else, where the coin
// uniform01(x ^ n, seed + 1) is below 1 / exp2(epoch), the first empty
// slot gets key x and count + 1. The sentinel item (bits -1) "hits" the
// first empty slot, whose key stays empty. Counts change only by
// __fadd_rn(c, 1) and by c - geo floored at 0, both exact on integers;
// there are no float atomics and no order that depends on scheduling, so
// the state equals the plain version (ref.sticky_scan_update) byte for
// byte.
//
// The two float functions are not computed here: want_epoch is a monotone
// step function of n and geo one of the uint32 hash h whose uniform01 is
// u, so the host hands over their steps (core/sticky.py: epoch_starts,
// geo_steps, built from the literal float32 functions on the CPU) and the
// admission limits 1 / exp2(e) as floats (inv_rates). The card then
// computes what the CPU computes, whatever its own log2f and logf give.
//
// Launches, on the caller's stream:
//   * (data-source rows) a memset and flag_kernel: a byte per row, set for
//     the source rows, whose routed tuples the grouping drops (their walk
//     takes every masked tuple anyway).
//   * key_kernel, or probe_key_kernel with the routing probe fused in
//     (sde::probe_row): each tuple's row, or -1 where it is masked,
//     unrouted, outside [0, n) or routed to a source row.
//   * The stable row sort (row_sort.cuh) into srow / perm and the count of
//     kept tuples, which stays on the card: the host never waits.
//   * bump_kernel: the batch's first check, a lane a row of the stack
//     (8 bytes a row), a warp decrementing each row that bumps.
//   * walk_kernel: warp w < S walks data-source row src[w] (a row listed
//     twice is walked once) over the whole batch; warp S + c takes the
//     runs that start in chunk c of 32 sorted positions, one after
//     another, each to its end. A warp holds its row's table in shared
//     memory and takes its tuples 32 at a time, lane i the i-th: each
//     lane computes its tuple's count (n_seen + its rank + 1), the epoch
//     that count asks for, the running epoch (a max-scan over the lanes),
//     whether its check bumps and its coin, all ahead of the dependent
//     steps; then the tuples step one after another: a bump where one
//     falls, and a lookup by 32 keys a ballot, 128 keys a round (the
//     first hit, else the first empty slot), then the write.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "probe.cuh"
#include "row_sort.cuh"

namespace {

constexpr int kThreads = 256;     // flag, key and bump kernels
constexpr int kWalkWarps = 4;     // walk_kernel warps a block, at most
constexpr int kLookAhead = 4;     // a lookup's ballots of 32 keys a round
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = -1;    // the bits of 0xFFFFFFFF
constexpr int kMaxEpochs = 32;
constexpr int kMaxGeo = 64;
constexpr int kMaxRateEpoch = 128;
constexpr float kUScale = 2.3283064365386963e-10f;   // uniform01's 2**-32

// The tables of the float functions, as the wrapper packs them in int32
// words: the epochs k = 1 .. n_epochs each count reaches from start[k - 1]
// on; the hash thresholds geo_at (ascending), geo being geo_val[i] for the
// number i of thresholds <= h; the admission limit inv_rate[e] =
// 1 / exp2(e) for e = 0 .. kMaxRateEpoch (0 from there on).
struct Tables {
  int32_t n_epochs;
  int32_t n_geo;
  int32_t start[kMaxEpochs];
  uint32_t geo_at[kMaxGeo];
  float geo_val[kMaxGeo + 1];
  float inv_rate[kMaxRateEpoch + 1];
};
constexpr int kTableWords = sizeof(Tables) / 4;

// Every thread of the block copies its share, then waits for the rest.
__device__ __forceinline__ void load_tables(Tables& tb,
                                            const int32_t* __restrict__ w) {
  int32_t* const d = reinterpret_cast<int32_t*>(&tb);
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) d[i] = w[i];
  __syncthreads();
}

// want_epoch(n): the epochs whose start n has reached.
__device__ __forceinline__ int want_of(const Tables& tb, int32_t n) {
  int k = 0;
  while (k < tb.n_epochs && n >= tb.start[k]) ++k;
  return k;
}

// want_epoch(n) > e: the check at count n bumps a row at epoch e.
__device__ __forceinline__ bool due(const Tables& tb, int32_t n, int e) {
  return e < 0 || (e < tb.n_epochs && n >= tb.start[e]);
}

// geo of uniform01's float of hash h: a binary search of the thresholds.
__device__ __forceinline__ float geo_of(const Tables& tb, uint32_t h) {
  int lo = 0, hi = tb.n_geo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tb.geo_at[mid] <= h) lo = mid + 1;
    else hi = mid;
  }
  return tb.geo_val[lo];
}

// The coin of item x at count n below the limit of epoch e (e >= 0).
__device__ __forceinline__ bool admits(const Tables& tb, int32_t x,
                                       uint32_t n, int e,
                                       uint32_t coin_mix) {
  const uint32_t h = sde::mix32(((uint32_t)x ^ n) ^ coin_mix);
  const float u = __fmul_rn(__uint2float_rn(h), kUScale);
  return u < tb.inv_rate[e < kMaxRateEpoch ? e : kMaxRateEpoch];
}

// A bump at count n of a table (shared or device memory): slot j loses
// the geo of hash(j ^ n, seed), floored at 0 (NaN stays NaN); a slot left
// at 0 or below is emptied. Every lane of the warp calls it.
__device__ __forceinline__ void bump_table(int32_t* keys, float* counts,
                                           int cap, uint32_t n,
                                           const Tables& tb,
                                           uint32_t geo_mix) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int j = lane; j < cap; j += 32) {
    const uint32_t h = sde::mix32(((uint32_t)j ^ n) ^ geo_mix);
    const float d = __fsub_rn(counts[j], geo_of(tb, h));
    const float c = d < 0.0f ? 0.0f : d;
    counts[j] = c;
    if (c <= 0.0f) keys[j] = kEmpty;
  }
  __syncwarp();
}

__global__ void flag_kernel(const int32_t* __restrict__ src, int n_src,
                            int n, uint8_t* __restrict__ flag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_src) {
    const int32_t r = src[i];
    if (r >= 0 && r < n) flag[r] = 1;
  }
}

__device__ __forceinline__ int32_t key_of(int32_t r, bool masked, int n,
                                          const uint8_t* __restrict__ flag) {
  const bool keep = masked && r >= 0 && r < n &&
                    (flag == nullptr || flag[r] == 0);
  return keep ? r : -1;
}

__global__ void key_kernel(const int32_t* __restrict__ rows,
                           const uint8_t* __restrict__ mask, int T, int n,
                           const uint8_t* __restrict__ flag,
                           int32_t* __restrict__ key) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  key[t] = key_of(rows[t], mask[t] != 0, n, flag);
}

// The routing probe fused in: a masked tuple's row is the table's for its
// stream id (lo, hi); an unmasked one probes nothing.
__global__ void probe_key_kernel(const uint32_t* __restrict__ keys_lo,
                                 const uint32_t* __restrict__ keys_hi,
                                 const int32_t* __restrict__ trows,
                                 uint32_t size,
                                 const uint32_t* __restrict__ sid_lo,
                                 const uint32_t* __restrict__ sid_hi,
                                 int n_probe,
                                 const uint8_t* __restrict__ mask, int T,
                                 int n, const uint8_t* __restrict__ flag,
                                 int32_t* __restrict__ key) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const bool masked = mask[t] != 0;
  const int32_t r = masked ? sde::probe_row(keys_lo, keys_hi, trows, size,
                                            sid_lo[t], sid_hi[t], n_probe)
                           : -1;
  key[t] = key_of(r, masked, n, flag);
}

// The batch's first check on every row: a lane a row; the warp decrements
// each row whose check bumps, in device memory.
__global__ void __launch_bounds__(kThreads)
bump_kernel(int32_t* __restrict__ keys, float* __restrict__ counts,
            const int32_t* __restrict__ n_seen, int32_t* __restrict__ epoch,
            int n, int cap, const int32_t* __restrict__ tables,
            uint32_t geo_mix) {
  __shared__ Tables tb;
  load_tables(tb, tables);
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool bump = false;
  uint32_t nr = 0;
  if (r < n) {
    nr = (uint32_t)n_seen[r] + 1u;
    bump = due(tb, (int32_t)nr, epoch[r]);
  }
  unsigned todo = __ballot_sync(kFull, bump);
  while (todo != 0u) {
    const int s = __ffs(todo) - 1;
    todo &= todo - 1u;
    const long long row = __shfl_sync(kFull, r, s);
    const uint32_t ns = __shfl_sync(kFull, nr, s);
    bump_table(keys + row * cap, counts + row * cap, cap, ns, tb, geo_mix);
  }
  if (bump) epoch[r] = want_of(tb, (int32_t)nr);
}

// One row's walk: its table in the warp's shared memory from open() to
// close(), its count and epoch in registers (every lane alike).
struct Walker {
  int cap;
  int32_t* keys;      // the state row's
  float* counts;
  int32_t* tkeys;     // the table's, in shared memory
  float* tcounts;
  uint32_t n_seen;
  int epoch;
  int32_t last;       // the batch position of the row's last tuple, or -1

  __device__ __forceinline__ void open(int32_t* keys_all, float* counts_all,
                                       const int32_t* n_seen_all,
                                       const int32_t* epoch_all, int cap_,
                                       int row, int32_t* smem) {
    const int lane = threadIdx.x & 31;
    const long long base = (long long)row * cap_;
    cap = cap_;
    keys = keys_all + base;
    counts = counts_all + base;
    tkeys = smem;
    tcounts = reinterpret_cast<float*>(smem + cap_);
    for (int j = lane; j < cap_; j += 32) {
      tkeys[j] = keys[j];
      tcounts[j] = counts[j];
    }
    n_seen = (uint32_t)n_seen_all[row];
    epoch = epoch_all[row];
    last = -1;
    __syncwarp();
  }

  // The check after the row's last tuple where it is not the batch's
  // last; then the table, count and epoch back to the state row.
  __device__ __forceinline__ void close(int T, const Tables& tb,
                                        uint32_t geo_mix, int32_t* n_seen_all,
                                        int32_t* epoch_all, int row) {
    const int lane = threadIdx.x & 31;
    if (last >= 0 && last < T - 1) {
      const uint32_t n = n_seen + 1u;
      if (due(tb, (int32_t)n, epoch)) {
        bump_table(tkeys, tcounts, cap, n, tb, geo_mix);
        epoch = want_of(tb, (int32_t)n);
      }
    }
    __syncwarp();
    for (int j = lane; j < cap; j += 32) {
      keys[j] = tkeys[j];
      counts[j] = tcounts[j];
    }
    if (lane == 0) {
      n_seen_all[row] = (int32_t)n_seen;
      epoch_all[row] = epoch;
    }
    __syncwarp();
  }

  // One step of item x after its check: the first slot holding x, else
  // (admitted) the first empty slot, adds one. 32 keys a ballot, the
  // loads of kLookAhead ballots issued together; the scan stops at the
  // kLookAhead x 32 slots that hold the first hit.
  __device__ __forceinline__ void step(int32_t x, bool admit) {
    const int lane = threadIdx.x & 31;
    int slot = -1, emp = -1;
    for (int base = 0; base < cap && slot < 0; base += 32 * kLookAhead) {
      int32_t k[kLookAhead];
#pragma unroll
      for (int u = 0; u < kLookAhead; ++u) {
        const int j = base + 32 * u + lane;
        k[u] = j < cap ? tkeys[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < kLookAhead; ++u) {
        const int j0 = base + 32 * u;
        const bool in = j0 + lane < cap;
        const unsigned hit = __ballot_sync(kFull, in && k[u] == x);
        const unsigned e = __ballot_sync(kFull, in && k[u] == kEmpty);
        if (slot < 0 && hit != 0u) slot = j0 + __ffs(hit) - 1;
        if (emp < 0 && e != 0u) emp = j0 + __ffs(e) - 1;
      }
    }
    if (slot < 0 && admit) slot = emp;
    if (slot >= 0 && lane == (slot & 31)) {
      tkeys[slot] = x;
      tcounts[slot] = __fadd_rn(tcounts[slot], 1.0f);
    }
    __syncwarp();
  }

  // The lanes of `valid` (lane i's tuple x at batch position t), in lane
  // order. Each lane's count, the epoch it asks for, the running epoch
  // (the max over the lanes up to it), whether its check bumps and its
  // coin come first, for all lanes at once; then the dependent steps.
  __device__ __forceinline__ void group(unsigned valid, int32_t x, int32_t t,
                                        const Tables& tb, uint32_t geo_mix,
                                        uint32_t coin_mix) {
    if (valid == 0u) return;
    const int lane = threadIdx.x & 31;
    const bool mine = (valid >> lane) & 1u;
    const uint32_t n =
        n_seen + 1u + (uint32_t)__popc(valid & ((1u << lane) - 1u));
    const int want = mine ? want_of(tb, (int32_t)n) : INT_MIN;
    int run = want;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, run, o);
      if (lane >= o && y > run) run = y;
    }
    const int after = run > epoch ? run : epoch;
    int before = __shfl_up_sync(kFull, after, 1);
    if (lane == 0) before = epoch;
    const unsigned bumps = __ballot_sync(kFull, mine && want > before);
    const unsigned admit =
        __ballot_sync(kFull, mine && admits(tb, x, n, after, coin_mix));
    unsigned todo = valid;
    while (todo != 0u) {
      const int s = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int32_t xs = __shfl_sync(kFull, x, s);
      if ((bumps >> s) & 1u) {
        const uint32_t ns = __shfl_sync(kFull, n, s);
        bump_table(tkeys, tcounts, cap, ns, tb, geo_mix);
      }
      step(xs, (admit >> s) & 1u);
    }
    const int hi = 31 - __clz(valid);
    epoch = __shfl_sync(kFull, after, hi);
    last = __shfl_sync(kFull, t, hi);
    n_seen += (uint32_t)__popc(valid);
  }
};

__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(int32_t* __restrict__ keys, float* __restrict__ counts,
            int32_t* __restrict__ n_seen, int32_t* __restrict__ epoch,
            int n, int cap, const int32_t* __restrict__ items,
            const uint8_t* __restrict__ mask, int T,
            const int32_t* __restrict__ src, int n_src,
            const int32_t* __restrict__ srow,
            const int32_t* __restrict__ perm,
            const int32_t* __restrict__ count,
            const int32_t* __restrict__ tables, uint32_t geo_mix,
            uint32_t coin_mix) {
  __shared__ Tables tb;
  load_tables(tb, tables);
  extern __shared__ __align__(16) int32_t smem_all[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  int32_t* const smem = smem_all + (long long)wib * 2 * cap;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  Walker walker;
  if (w < n_src) {
    const int32_t row = src[w];
    if (row < 0 || row >= n) return;
    for (long long i = 0; i < w; ++i) {
      if (src[i] == row) return;      // listed before: walked there
    }
    walker.open(keys, counts, n_seen, epoch, cap, row, smem);
    for (long long g = 0; g < T; g += 32) {
      const long long t = g + lane;
      const bool ok = t < T && mask[t] != 0;
      const int32_t x = ok ? items[t] : 0;
      walker.group(__ballot_sync(kFull, ok), x, (int32_t)t, tb, geo_mix,
                   coin_mix);
    }
    walker.close(T, tb, geo_mix, n_seen, epoch, row);
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
    walker.open(keys, counts, n_seen, epoch, cap, row, smem);
    for (long long g = c0 + s;; g += 32) {
      const long long q = g + lane;
      const bool ok = q < len && srow[q] == row;
      const int32_t t = ok ? perm[q] : 0;
      const int32_t x = ok ? items[t] : 0;
      const unsigned in = __ballot_sync(kFull, ok);
      walker.group(in, x, t, tb, geo_mix, coin_mix);
      if (in != kFull) break;
    }
    walker.close(T, tb, geo_mix, n_seen, epoch, row);
  }
}

// The kernel's own want_epoch and geo over given counts and hashes, for
// the check that the tables equal the float functions they stand for.
__global__ void eval_kernel(const int32_t* __restrict__ tables, int32_t n0,
                            int count_n, int32_t* __restrict__ want,
                            const uint32_t* __restrict__ h, int count_h,
                            float* __restrict__ geo) {
  __shared__ Tables tb;
  load_tables(tb, tables);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < count_n) want[i] = want_of(tb, (int32_t)(n0 + i));
  if (i < count_h) geo[i] = geo_of(tb, h[i]);
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

// The key pass (rows given, or probed when keys_lo is set), the sort, the
// batch's first checks and the walks.
cudaError_t scan(int32_t* keys, float* counts, int32_t* n_seen,
                 int32_t* epoch, int n, int cap, const int32_t* rows,
                 const uint32_t* keys_lo, const uint32_t* keys_hi,
                 const int32_t* trows, uint32_t size, const uint32_t* sid_lo,
                 const uint32_t* sid_hi, int n_probe, const int32_t* items,
                 const uint8_t* mask, int T, const int32_t* src, int n_src,
                 const int32_t* tables, uint32_t geo_mix, uint32_t coin_mix,
                 int32_t* scratch, cudaStream_t stream) {
  if (T <= 0 || n <= 0) return cudaSuccess;
  if (cap < 1 || scratch == nullptr || tables == nullptr)
    return cudaErrorInvalidValue;
  if (src == nullptr) n_src = 0;
  const sde::SortScratch s = sde::sort_scratch(scratch, T);
  int32_t* const key = scratch + key_word(T);
  uint8_t* flag = nullptr;
  cudaError_t err;
  if (n_src > 0) {
    flag = reinterpret_cast<uint8_t*>(scratch + flag_word(T));
    err = cudaMemsetAsync(flag, 0, (size_t)n, stream);
    if (err != cudaSuccess) return err;
    flag_kernel<<<(n_src + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        src, n_src, n, flag);
  }
  const int kblocks = (T + kThreads - 1) / kThreads;
  if (keys_lo != nullptr) {
    probe_key_kernel<<<kblocks, kThreads, 0, stream>>>(
        keys_lo, keys_hi, trows, size, sid_lo, sid_hi, n_probe, mask, T, n,
        flag, key);
  } else {
    key_kernel<<<kblocks, kThreads, 0, stream>>>(rows, mask, T, n, flag, key);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sde::sort_rows(key, n, T, s, stream);
  if (err != cudaSuccess) return err;
  bump_kernel<<<(unsigned)(((long long)n + kThreads - 1) / kThreads),
                kThreads, 0, stream>>>(keys, counts, n_seen, epoch, n, cap,
                                       tables, geo_mix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t table = (size_t)cap * 8;
  const int room = max_shared() - (int)sizeof(Tables);
  int wpb = room > 0 ? (int)((size_t)room / table) : 0;
  if (wpb > kWalkWarps) wpb = kWalkWarps;
  if (wpb < 1) return cudaErrorInvalidValue;
  const size_t smem = table * wpb;
  if (smem + sizeof(Tables) > 48 * 1024) {
    err = cudaFuncSetAttribute(walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long warps = (long long)n_src + ((long long)T + 31) / 32;
  const long long blocks = (warps + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  walk_kernel<<<(unsigned)blocks, wpb * 32, smem, stream>>>(
      keys, counts, n_seen, epoch, n, cap, items, mask, T, src, n_src,
      s.srow, s.perm, s.count, tables, geo_mix, coin_mix);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch sticky_scan needs, in int32 words.
int sticky_words(int n, int T, long long* words) {
  *words = (T > 0 && n > 0) ? total_words(n, T) : 0;
  return 0;
}

// The int32 words of the tables, and the most slots a table may have (a
// warp's table in one block's shared memory).
int sticky_layout(int* table_words, int* max_cap) {
  *table_words = kTableWords;
  *max_cap = (max_shared() - (int)sizeof(Tables)) / 8;
  return 0;
}

// keys [n, cap] i32, counts [n, cap] f32, n_seen and epoch [n] i32 (updated
// in place); rows, items [T] i32; mask [T] bytes (0 / 1); src [n_src] i32
// (data-source rows) or null; tables: sticky_layout's words; geo_mix and
// coin_mix: hash_u32's seed words of the kind's seed and seed + 1;
// scratch: sticky_words(n, T) words, 128-byte aligned.
int sticky_scan(int32_t* keys, float* counts, int32_t* n_seen,
                int32_t* epoch, int n, int cap, const int32_t* rows,
                const int32_t* items, const uint8_t* mask, int T,
                const int32_t* src, int n_src, const int32_t* tables,
                uint32_t geo_mix, uint32_t coin_mix, int32_t* scratch,
                cudaStream_t stream) {
  return (int)scan(keys, counts, n_seen, epoch, n, cap, rows, nullptr,
                   nullptr, nullptr, 0, nullptr, nullptr, 0, items, mask, T,
                   src, n_src, tables, geo_mix, coin_mix, scratch, stream);
}

// As sticky_scan, each tuple's row probed from the routing table (keys_lo,
// keys_hi, trows: size slots, a power of two) for its stream id (sid_lo,
// sid_hi), at most n_probe slots.
int sticky_probe_scan(int32_t* keys, float* counts, int32_t* n_seen,
                      int32_t* epoch, int n, int cap,
                      const uint32_t* keys_lo, const uint32_t* keys_hi,
                      const int32_t* trows, int size, const uint32_t* sid_lo,
                      const uint32_t* sid_hi, int n_probe,
                      const int32_t* items, const uint8_t* mask, int T,
                      const int32_t* src, int n_src, const int32_t* tables,
                      uint32_t geo_mix, uint32_t coin_mix, int32_t* scratch,
                      cudaStream_t stream) {
  if (keys_lo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)scan(keys, counts, n_seen, epoch, n, cap, nullptr, keys_lo,
                   keys_hi, trows, (uint32_t)size, sid_lo, sid_hi, n_probe,
                   items, mask, T, src, n_src, tables, geo_mix, coin_mix,
                   scratch, stream);
}

// want[i] = the kernel's want_epoch of n0 + i (i < count_n) and geo[i] its
// geo of hash h[i] (i < count_h).
int sticky_eval(const int32_t* tables, int n0, int count_n, int32_t* want,
                const uint32_t* h, int count_h, float* geo,
                cudaStream_t stream) {
  const int most = count_n > count_h ? count_n : count_h;
  if (most <= 0) return 0;
  eval_kernel<<<(most + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      tables, n0, count_n, want, h, count_h, geo);
  return (int)cudaGetLastError();
}

}  // extern "C"
