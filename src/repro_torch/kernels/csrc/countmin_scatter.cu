// CountMin / count-sketch scatter-add for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/onehot_matmul.py, onehot_scatter_add (rows
// given, :61) and onehot_probe_scatter (routing probe fused, :139). The
// TPU kernels turn the scatter into a one-hot matmul on the MXU; on the
// card it is a direct scatter:
//
//   counts[s, j, idx[t, j]] += values[t] * signs[t, j]   for rows[t] == s
//
// Tuples whose row lies outside [0, n) are dropped (the reference's
// one-hot matches no row for them). Offsets are 64-bit.
//
// The byte contract. No float atomicAdd: every state element (s, j, b) is
// summed by ONE thread, in batch order, starting from its old value, and
// each weight v * sign is rounded on its own before it is added. So the
// state bytes are the same on every run and equal a serial loop over the
// batch even for float weights; integer weights give the exact sums.
// Adding a zero weight never changes a sum, so zero weights are skipped,
// as are buckets outside [0, w).
//
// Bounds on this card. Bytes: the batch read once (rows or the stream-id
// halves and the probed table slots, idx, values, signs) and each touched
// element read and written once: 0.00067 ms at phase 2's batch (3.35
// TB/s). The chain: under the byte contract all of an element's adds are
// one dependent chain, and a stream's tuples share one bucket per depth
// row, so the hottest row's run is a chain of that many adds: 8,095 at
// phase 2's Zipf(1.1) batch, 0.0164 ms at 4 cycles an add and 1.98 GHz,
// 24x the byte bound. A tree or chunked sum would give other bytes.
//
// The main path (d * n >= 1024), in launches on the caller's stream:
//   * (fused entry) probe_kernel: the routing probe (probe.cuh) writes the
//     routed rows into wrapper scratch.
//   * The stable row sort (row_sort.cuh): a memset and 2 passes of 2
//     launches at n = 131,072, into srow / perm.
//   * gather_kernel: for each sorted position p and depth row j, the
//     bucket sidx[j, p] and the weight sval[j, p] (-1 and -0.0 for a zero
//     weight or a bucket outside [0, w)), coalesced, so that a walk's
//     loads depend on p alone; and each run's end, recorded under its row.
//   * walk_kernel: one warp per (chunk of 32 sorted positions, depth row
//     j), a chunk's d warps on d consecutive blocks (started at once, on d
//     SMs). It takes the runs that START in its chunk: the chunk as one
//     step of 32 positions, then the chunk's last run to its end in steps
//     of kStep (512). In a step, positions of equal elements form a
//     group, whose adds every lane of the group repeats in position order.
//     The element of a step's last position stays in a register,
//     warp-uniform, into the next step (the carry); it is written back
//     when the next step does not touch it and at the run's end, and read
//     once. So the hot run's chain never waits on memory for its state. A
//     whole step whose positions all add to the carried element or add
//     nothing (the hot run's case: a stream's tuples share one bucket a
//     depth row) costs one vote: every lane adds all 512 weights, in
//     order, from 16-byte broadcast loads of the stage, with no branch (a
//     position that adds nothing holds -0.0, and adding -0.0 leaves every
//     float as it is); the next step's vote is taken among these adds.
//     The run's last, partial step goes 32 positions at a time. The run's
//     buckets and weights come through a ring of kRing stages in shared
//     memory a warp, filled with cp.async 16-byte copies kRing - 1 steps
//     ahead, up to the run's end, which the gather recorded by row.
// What remains above the chain floor: the 6 launches before the walk, and
// a step's ring wait, vote and copies (~550 cycles a 512-add step).
//
// Small stacks (d * n < 1024; the data-source fresh sketch has n = 1):
// grouped by row, the batch would be one run a depth row, walked by one
// warp. So the route keys each entry by its element instead:
//   * key_kernel: entry e = t * d + j (one thread each) gets its element's
//     flat offset (rows[t] * d + j) * w + idx[t, j], or -1 where it adds
//     nothing, and its weight v * sign rounded on its own.
//   * The same stable sort over the n * d * w keys (10,240 at the fresh
//     sketch: 2 passes of 7 bits) orders the entries by element and,
//     within an element, by e: batch order, since an element's entries
//     share j.
//   * gather_kernel and walk_kernel as above with d = w = 1: every run is
//     one element, so the hot element's run (a stream's tuples share one
//     bucket a depth row) takes the walk's 512-add steps, and the d depth
//     rows' hot elements are walked at once by d warps. The gather also
//     lists the chunks whose last run holds kLongRun (2,048) entries or
//     more, and the walk's first kLongWarps warps take them: so those
//     walks start with the grid, not after the ~10,000 chunk warps before
//     them (the walk's blocks hold 32 KB of ring each, 7 to an SM).
// A small stack whose keys or entries pass 2**30 - 1 takes the row route.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"
#include "row_sort.cuh"

namespace {

constexpr int kMaxDepth = 1024;
constexpr long long kSmallStack = 1024;  // d * n below it: keyed by element
constexpr long long kMaxKeyed = (1LL << 30) - 1;  // keys and entries
constexpr int kProbeThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kWalkWarps = 2;    // walk_kernel warps a block
constexpr int kStep = 512;       // sorted positions a continuation step
constexpr int kSub = kStep / 32;           // a lane's positions in a step
constexpr int kRing = 4;         // a walk warp's ring stages
constexpr int kStage = 2 * kStep;          // words: buckets, weights
constexpr int kLongRun = 4 * kStep;   // a run the long list takes
constexpr int kLongWarps = 32;        // the walk warps of the long list
constexpr unsigned kFull = 0xffffffffu;

__global__ void probe_kernel(const uint32_t* __restrict__ keys_lo,
                             const uint32_t* __restrict__ keys_hi,
                             const int32_t* __restrict__ table_rows,
                             uint32_t size, const uint32_t* __restrict__ sid_lo,
                             const uint32_t* __restrict__ sid_hi, int n_probe,
                             int32_t* __restrict__ rows, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T) {
    rows[t] = sde::probe_row(keys_lo, keys_hi, table_rows, size, sid_lo[t],
                             sid_hi[t], n_probe);
  }
}

// After the sort: for each sorted position p and depth row j, the bucket
// sidx[j, p] and the weight sval[j, p], v * sign rounded on its own, so
// that a walk's loads depend on p alone; where the walk adds nothing (a
// zero weight, or a bucket outside [0, w)), -1 and -0.0, which leaves any
// float as it is when added. The last position of each run records the
// run's end under its row (run_end [n]). One thread a position. For the
// element-keyed route (d = w = 1, the key is the element) idx is null:
// every bucket is 0, and values holds the rounded weights by entry; and
// the first position of each run of kLongRun or more appends its chunk to
// long_list (*n_long entries, zeroed by the key pass).
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const int32_t* __restrict__ srow,
              const int32_t* __restrict__ perm,
              const int32_t* __restrict__ count, int d, int w,
              const int32_t* __restrict__ idx,
              const float* __restrict__ values,
              const float* __restrict__ signs, int32_t* __restrict__ sidx,
              float* __restrict__ sval, long long cap,
              int32_t* __restrict__ run_end, int32_t* __restrict__ long_list,
              int32_t* __restrict__ n_long) {
  const long long p = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  const long long len = *count;
  if (p >= len) return;
  const int32_t row = __ldg(srow + p);
  if (p + 1 == len || __ldg(srow + p + 1) != row) {
    run_end[row] = (int32_t)(p + 1);
  }
  if (long_list != nullptr && (p == 0 || __ldg(srow + p - 1) != row) &&
      p + kLongRun <= len && __ldg(srow + p + kLongRun - 1) == row) {
    long_list[atomicAdd(n_long, 1)] = (int32_t)(p / 32);
  }
  const int t = __ldg(perm + p);
  const float v = __ldg(values + t);
  for (int j = 0; j < d; ++j) {
    const long long tj = (long long)t * d + j;
    const int b = idx != nullptr ? __ldg(idx + tj) : 0;
    const float x = signs != nullptr ? __fmul_rn(v, __ldg(signs + tj)) : v;
    const bool adds = x != 0.0f && b >= 0 && b < w;
    sidx[j * cap + p] = adds ? b : -1;
    sval[j * cap + p] = adds ? x : -0.0f;
  }
}

// The element carried in a register from one walk step to the next,
// warp-uniform: its flat offset in counts (< 0: none) and running value.
struct Carry {
  long long key;
  float val;
};

__device__ __forceinline__ long long element(int row, int d, int j, int w,
                                             int b) {
  return ((long long)row * d + j) * w + b;
}

// The element's value at the start of a step that touches it alone: the
// carry's, if the carry holds it; else the old carry goes back to memory
// and the element is read.
__device__ __forceinline__ float take(float* __restrict__ counts,
                                      long long key, const Carry& c) {
  if (key == c.key) return c.val;
  if (c.key >= 0 && (threadIdx.x & 31) == 0) counts[c.key] = c.val;
  return counts[key];
}

// One step of up to 32 sorted positions, in lane order: each lane with
// `active` adds v to element `key` (inactive lanes pass keys that are
// negative and distinct). Each element's adds are made, in lane order, by
// every lane of its group, starting from the carry where the carry holds
// the element, else from memory. Afterwards the carry holds the element of
// the last active lane; every other element touched, and the old carry if
// this step did not touch it, is written back. The caller orders the
// steps' memory accesses with __syncwarp(). Adding -0.0 leaves every float
// as it is (+0 + -0 = +0), so a step of one element adds the inactive
// lanes' -0.0 too, without a branch an add.
// With kPre, the carry is empty and each active lane's element value was
// read beforehand into `pre`.
template <bool kPre = false>
__device__ __forceinline__ void add_step(float* __restrict__ counts,
                                         bool active, long long key, float v,
                                         Carry& c, float pre = 0.0f) {
  const int lane = threadIdx.x & 31;
  const unsigned act = __ballot_sync(kFull, active);
  if (act == 0u) return;
  const int last = 31 - __clz(act);
  const long long k0 = __shfl_sync(kFull, key, __ffs(act) - 1);
  if (__ballot_sync(kFull, active && key != k0) == 0u) {
    // one element: the same 32 adds in every lane
    const float u = active ? v : -0.0f;
    float acc = kPre ? __shfl_sync(kFull, pre, __ffs(act) - 1)
                     : take(counts, k0, c);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, __shfl_sync(kFull, u, i));
    c.key = k0;
    c.val = acc;
    return;
  }
  // several elements: each lane walks its group's lanes, lowest first
  const unsigned peers = __match_any_sync(kFull, key);
  const bool hit = active && key == c.key;
  float acc = 0.0f;
  if (active) acc = hit ? c.val : kPre ? pre : counts[key];
  unsigned m = active ? peers : 0u;
  const int rounds = (int)__reduce_max_sync(kFull, (unsigned)__popc(m));
  for (int i = 0; i < rounds; ++i) {
    const int src = m != 0u ? __ffs(m) - 1 : lane;
    const float x = __shfl_sync(kFull, v, src);
    if (m != 0u) {
      acc = __fadd_rn(acc, x);
      m &= m - 1u;
    }
  }
  const long long kl = __shfl_sync(kFull, key, last);
  if (active && __ffs(peers) - 1 == lane && key != kl) counts[key] = acc;
  if (c.key >= 0 && __ballot_sync(kFull, hit) == 0u && lane == 0) {
    counts[c.key] = c.val;
  }
  c.key = kl;
  c.val = __shfl_sync(kFull, acc, last);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One warp's walk of the chunk of 32 sorted positions from c0 at depth row
// j: it takes the runs that start in the chunk and walks the last one to
// its end, through its ring `my`. srow [cap] and sidx / sval [d, cap] are
// the sort's and the gather's output (len positions). With kSkipLong it
// leaves a chunk whose last run is long (kLongRun positions or more,
// judged as the gather judges it) to the long list's warps.
template <bool kSkipLong>
__device__ __forceinline__ void walk_chunk(
    float* __restrict__ counts, int d, int w, int j, long long c0,
    const int32_t* __restrict__ srow, const int32_t* __restrict__ sidx,
    const float* __restrict__ sval, long long cap,
    const int32_t* __restrict__ run_end, long long len,
    int32_t* __restrict__ my) {
  const int lane = threadIdx.x & 31;
  if (c0 >= len) return;                       // uniform across the warp
  const int32_t* const bj = sidx + j * cap;
  const float* const vj = sval + j * cap;
  // one round of independent loads: the chunk and the row before it
  const long long p = c0 + lane;
  const bool in = p < len;
  const long long pc = in ? p : len - 1;
  const int32_t row = __ldg(srow + pc);
  const int32_t prev = pc > 0 ? __ldg(srow + pc - 1) : -1;
  const int32_t b = __ldg(bj + p);             // p < cap
  const float v = __ldg(vj + p);
  const unsigned starts = __ballot_sync(kFull, in && (p == 0 || prev != row));
  if (starts == 0u) return;      // the chunk lies inside an earlier run
  // the chunk's elements, read while the last run's end is read
  const bool active = in && lane >= __ffs(starts) - 1 && b >= 0;
  const long long key = active ? element(row, d, j, w, b) : -1 - lane;
  const float pre = active ? counts[key] : 0.0f;
  const int32_t r0 = __shfl_sync(kFull, row, 31);
  if (kSkipLong) {
    const long long ls = c0 + 31 - __clz(starts);   // the last run's start
    if (ls + kLongRun <= len && __ldg(srow + ls + kLongRun - 1) == r0) {
      return;
    }
  }
  const long long pend =                       // one past the chunk's last run
      c0 + 32 < len ? __ldg(run_end + r0) : 0;
  // steps of kStep positions from c0 + 32 to the run's end, through the
  // ring: stage word 4 * lane + k of array i (buckets, weights) is a
  // step's position 4 * lane + k. Copies stop at the 16 bytes that hold
  // the run's last position (<= cap); the first stages are in flight while
  // the chunk itself is added.
  const long long cb = c0 + 32;
  const long long steps = pend > cb ? (pend - cb + kStep - 1) / kStep : 0;
  const int32_t* const src[2] = {bj, reinterpret_cast<const int32_t*>(vj)};
  auto issue = [&](long long m) {              // step m into its stage
    int32_t* const st = my + (int)(m % kRing) * kStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < kStep / 128; ++h) {
        const int word = 128 * h + 4 * lane;
        const long long pos = cb + m * kStep + word;
        if (m < steps && pos < pend) {
          cp_async16(st + i * kStep + word, src[i] + pos);
        }
      }
    }
    cp_async_commit();                         // one group a step, even empty
  };
  if (steps > 0) {
    for (int m = 0; m < kRing - 1; ++m) issue(m);
  }
  Carry c{-1, 0.0f};
  add_step<true>(counts, active, key, v, c, pre);
  if (steps > 0) {
    const long long kbase = element(r0, d, j, w, 0);
    // whether step m is in the run as a whole and each of its positions
    // adds to the carried element or adds nothing (bucket -1, weight
    // -0.0): the hot case
    bool same = false;
    auto check = [&](long long m) {
      const int32_t* const st = my + (int)(m % kRing) * kStage;
      const int bc = c.key >= kbase && c.key < kbase + w
                         ? (int)(c.key - kbase) : -2;
      same = cb + (m + 1) * kStep <= pend;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const int32_t bq = st[32 * k + lane];
        same = same && (bq == bc || bq < 0);
      }
    };
    cp_async_wait<kRing - 2>();                // step 0's group has landed
    __syncwarp();                // and the chunk's writes are done
    check(0);
    for (long long m = 0; m < steps; ++m) {
      issue(m + kRing - 1);      // into the stage step m - 1 left
      const int32_t* const st = my + (int)(m % kRing) * kStage;
      if (__all_sync(kFull, same)) {
        // every lane adds all kStep weights, from 16-byte broadcast loads
        // kAhead words ahead of the adds they feed; step m + 1's checks
        // (the carried element stays) go among them
        cp_async_wait<kRing - 2>();            // step m + 1's group
        __syncwarp();
        check(m + 1);
        constexpr int kAhead = 8;
        const float4* const u = reinterpret_cast<const float4*>(st + kStep);
        float4 x[kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) x[i] = u[i];
        float acc = c.val;
#pragma unroll
        for (int i = 0; i < kStep / 4; ++i) {
          const float4 y = x[i % kAhead];
          if (i + kAhead < kStep / 4) x[i % kAhead] = u[i + kAhead];
          acc = __fadd_rn(acc, y.x);
          acc = __fadd_rn(acc, y.y);
          acc = __fadd_rn(acc, y.z);
          acc = __fadd_rn(acc, y.w);
        }
        c.val = acc;
      } else {
        // 32 positions at a time, lane order within each
        const long long base = cb + m * kStep;
#pragma unroll 1
        for (int k = 0; k < kSub; ++k) {
          const int32_t bq = st[32 * k + lane];
          const bool act = base + 32 * k + lane < pend && bq >= 0;
          add_step(counts, act, act ? kbase + bq : -1 - lane,
                   __int_as_float(st[kStep + 32 * k + lane]), c);
          __syncwarp();
        }
        cp_async_wait<kRing - 2>();            // step m + 1's group
        __syncwarp();
        check(m + 1);
      }
      __syncwarp();              // the stages read, the step's writes done
    }
  }
  if (c.key >= 0 && lane == 0) counts[c.key] = c.val;
}

// One warp per (chunk c of 32 sorted positions, depth row j): block B
// holds chunks kWalkWarps (B / d) .. + kWalkWarps - 1 at depth row B % d,
// so a chunk's d warps sit on d consecutive blocks, started at once on d
// SMs. With a long list (the element-keyed route, d = 1), the first
// kLongWarps warps take the chunks of the list, whose last runs are long,
// and warp kLongWarps + c takes chunk c unless it is on the list: so the
// hot elements' walks start with the grid, not when the blocks before
// their chunks have run.
__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(float* __restrict__ counts, int d, int w,
            const int32_t* __restrict__ srow,
            const int32_t* __restrict__ sidx,
            const float* __restrict__ sval, long long cap,
            const int32_t* __restrict__ run_end,
            const int32_t* __restrict__ count, long long chunks,
            const int32_t* __restrict__ long_list,
            const int32_t* __restrict__ n_long) {
  __shared__ __align__(16) int32_t ring[kWalkWarps][kRing * kStage];
  const int wib = threadIdx.x >> 5;
  const int j = (int)(blockIdx.x % d);
  long long c = (long long)blockIdx.x / d * kWalkWarps + wib;
  const long long len = *count;
  if (long_list == nullptr) {
    if (c < chunks) {
      walk_chunk<false>(counts, d, w, j, 32 * c, srow, sidx, sval, cap,
                        run_end, len, ring[wib]);
    }
    return;
  }
  if (c < kLongWarps) {
    const int k = *n_long;
    for (int i = (int)c; i < k; i += kLongWarps) {
      walk_chunk<false>(counts, d, w, j, 32LL * long_list[i], srow, sidx,
                        sval, cap, run_end, len, ring[wib]);
      __syncwarp();
    }
    return;
  }
  c -= kLongWarps;
  if (c < chunks) {
    walk_chunk<true>(counts, d, w, j, 32 * c, srow, sidx, sval, cap,
                     run_end, len, ring[wib]);
  }
}

// The small-stack route's key pass, one thread an entry e = t * d + j:
// key[e] the element (rows[t] * d + j) * w + idx[t, j], or -1 where the
// entry adds nothing (a row outside [0, n), a bucket outside [0, w), a zero
// weight), so that the sort drops it; wt[e] its weight v * sign, rounded
// on its own. n * d * w and T * d are at most kMaxKeyed. It also zeroes the
// long list's count.
__global__ void __launch_bounds__(kGatherThreads)
key_kernel(int n, int d, int w, const int32_t* __restrict__ rows,
           const int32_t* __restrict__ idx, const float* __restrict__ values,
           const float* __restrict__ signs, int entries,
           int32_t* __restrict__ key, float* __restrict__ wt,
           int32_t* __restrict__ n_long) {
  const int e = blockIdx.x * kGatherThreads + threadIdx.x;
  if (e == 0) *n_long = 0;
  if (e >= entries) return;
  const int t = e / d;
  const int j = e - t * d;
  const int32_t row = __ldg(rows + t);
  const int b = __ldg(idx + e);
  const float v = __ldg(values + t);
  const float x = signs != nullptr ? __fmul_rn(v, __ldg(signs + e)) : v;
  const bool adds = x != 0.0f && row >= 0 && row < n && b >= 0 && b < w;
  key[e] = adds ? (row * d + j) * w + b : -1;
  wt[e] = x;
}

// A sort and walk's scratch (cm_layout's words): the sort's (row_sort.cuh),
// then sidx and sval [d, cap] and run_end [n].
struct Layout {
  sde::SortScratch sort;
  int32_t* sidx;
  float* sval;
  int32_t* run_end;
};

long long layout_words(int n, int d, int T) {
  return sde::sort_words(T) + 2LL * d * sde::round32(T) + sde::round32(n);
}

Layout layout(int32_t* base, int d, int T) {
  Layout l;
  const long long sort_w = sde::sort_words(T);
  l.sort = sde::sort_scratch(base, T);
  l.sidx = base + sort_w;
  l.sval = reinterpret_cast<float*>(l.sidx + (long long)d * l.sort.cap);
  l.run_end = l.sidx + 2LL * d * l.sort.cap;
  return l;
}

// Whether a stack takes the element-keyed route: d * n < kSmallStack, with
// its keys and entries within kMaxKeyed. Its scratch (key_words) is key and
// wt [T * d], the long list's count (padded to 32 words) and the list (a
// chunk per run of kLongRun or more), before a layout of the T * d entries
// with d = 1 and n * d * w keys.
bool keyed(int n, int d, int w, int T) {
  return (long long)d * n < kSmallStack && w >= 1 &&
         (long long)n * d * w <= kMaxKeyed && (long long)T * d <= kMaxKeyed;
}

long long key_words(int entries) {
  return 2 * sde::round32(entries) + 32 +
         sde::round32(entries / kLongRun + 1);
}

// Sort `entries` by keys in [0, nkeys), then gather and walk them; the
// element of a sorted position is (key * d + j) * w + its bucket. A long
// list (d = 1 only) puts kLongWarps warps before the chunks' own.
int sort_and_walk(float* counts, const int32_t* keys, int nkeys, int d, int w,
                  const int32_t* idx, const float* values, const float* signs,
                  int entries, const Layout& l, int32_t* long_list,
                  int32_t* n_long, cudaStream_t stream) {
  const long long chunks = ((long long)entries + 31) / 32;
  const long long warps = chunks + (long_list != nullptr ? kLongWarps : 0);
  const long long blocks = (warps + kWalkWarps - 1) / kWalkWarps * d;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = sde::sort_rows(keys, nkeys, entries, l.sort, stream);
  if (err != cudaSuccess) return (int)err;
  gather_kernel<<<(unsigned)((entries + kGatherThreads - 1) / kGatherThreads),
                  kGatherThreads, 0, stream>>>(
      l.sort.srow, l.sort.perm, l.sort.count, d, w, idx, values, signs,
      l.sidx, l.sval, l.sort.cap, l.run_end, long_list, n_long);
  walk_kernel<<<(unsigned)blocks, kWalkWarps * 32, 0, stream>>>(
      counts, d, w, l.sort.srow, l.sidx, l.sval, l.sort.cap, l.run_end,
      l.sort.count, chunks, long_list, n_long);
  return (int)cudaGetLastError();
}

int launch_scatter(float* counts, int n, int d, int w, const int32_t* rows,
                   const int32_t* idx, const float* values,
                   const float* signs, int T, int32_t* scratch,
                   cudaStream_t stream) {
  if (d < 1 || d > kMaxDepth || w < 1) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (!keyed(n, d, w, T)) {
    return sort_and_walk(counts, rows, n, d, w, idx, values, signs, T,
                         layout(scratch, d, T), nullptr, nullptr, stream);
  }
  const int entries = T * d;
  int32_t* const key = scratch;
  float* const wt = reinterpret_cast<float*>(scratch + sde::round32(entries));
  int32_t* const n_long = scratch + 2 * sde::round32(entries);
  key_kernel<<<(unsigned)((entries + kGatherThreads - 1) / kGatherThreads),
               kGatherThreads, 0, stream>>>(n, d, w, rows, idx, values, signs,
                                            entries, key, wt, n_long);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Layout l = layout(scratch + key_words(entries), 1, entries);
  return sort_and_walk(counts, key, n * d * w, 1, 1, nullptr, wt, nullptr,
                       entries, l, n_long + 32, n_long, stream);
}

}  // namespace

extern "C" {

// The scratch a call needs, in int32 words (d = 0: the sort's alone, for
// cm_sort_rows), and where the sort leaves its output: off[0..3] = the word
// offsets of count, srow, perm and the total.
int cm_layout(int n, int d, int w, int T, long long* off) {
  off[0] = off[1] = off[2] = off[3] = 0;
  if (T <= 0 || n <= 0 || d < 0 || (d > 0 && w < 1)) return 0;
  long long base = 0, total;
  int entries = T;
  if (d == 0) {
    total = sde::sort_words(T);
  } else if (keyed(n, d, w, T)) {
    entries = T * d;
    base = key_words(entries);
    total = base + layout_words(n * d * w, 1, entries);
  } else {
    total = layout_words(n, d, T);
  }
  off[0] = base;
  off[1] = base + sde::sort_srow_word(entries);
  off[2] = off[1] + sde::round32(entries);
  off[3] = total;
  return 0;
}

// counts [n, d, w] f32 (updated in place); rows [T] i32 (-1 drops);
// idx [T, d] i32; values [T] f32; signs [T, d] f32 or null for +1;
// scratch: cm_layout(n, d, w, T) words, 128-byte aligned.
int cm_scatter(float* counts, int n, int d, int w, const int32_t* rows,
               const int32_t* idx, const float* values, const float* signs,
               int T, int32_t* scratch, cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  return launch_scatter(counts, n, d, w, rows, idx, values, signs, T, scratch,
                        stream);
}

// As cm_scatter, with the rows probed from the routing-table mirror
// (keys_lo / keys_hi / table_rows of pow2 `size`) for the stream-id
// halves sid_lo / sid_hi [T]; rows_scratch [T] i32 receives them.
int cm_probe_scatter(float* counts, int n, int d, int w,
                     const uint32_t* keys_lo, const uint32_t* keys_hi,
                     const int32_t* table_rows, int size,
                     const uint32_t* sid_lo, const uint32_t* sid_hi,
                     int n_probe, int32_t* rows_scratch, const int32_t* idx,
                     const float* values, const float* signs, int T,
                     int32_t* scratch, cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  probe_kernel<<<(T + kProbeThreads - 1) / kProbeThreads, kProbeThreads, 0,
                 stream>>>(keys_lo, keys_hi, table_rows, (uint32_t)size,
                           sid_lo, sid_hi, n_probe, rows_scratch, T);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_scatter(counts, n, d, w, rows_scratch, idx, values, signs, T,
                        scratch, stream);
}

// The stable row sort alone, into scratch of cm_layout(n, 0, 1, T) words.
int cm_sort_rows(const int32_t* rows, int n, int T, int32_t* scratch,
                 cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  return (int)sde::sort_rows(rows, n, T, sde::sort_scratch(scratch, T),
                             stream);
}

}  // extern "C"
