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
// Bucket ranges (bucket_kernel, d * n < 1024; the data-source fresh sketch
// has n = 1): a run of the whole batch on one row would be one long walk.
// Instead block (x, y) owns state row y / d, depth row y % d and the 256
// buckets from x * 256, one per thread of its first 8 warps, so 8 * 5
// blocks share a [1, 5, 2048] sketch. Each block streams the batch (the
// next chunk's loads in flight while it walks this one), keeping only the
// tuples of its own (row, bucket range), compacted in batch order (warp
// ballot + prefix count over the 32 warps). Per 32-entry step, each entry
// sets its bit in its owner's mask (a shared-memory atomicOr), and each
// owner adds its entries lowest bit first, taking their weights by warp
// shuffle. The owner keeps its element in a register from the first to
// the last tuple.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"
#include "row_sort.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the warp-count scan uses one warp");
constexpr int kProbeThreads = 256;
constexpr int kRange = 256;      // the buckets a bucket_kernel block owns
static_assert(kRange % 32 == 0 && kRange <= kThreads, "whole owner warps");
constexpr int kGatherThreads = 256;
constexpr int kWalkWarps = 2;    // walk_kernel warps a block
constexpr int kStep = 512;       // sorted positions a continuation step
constexpr int kSub = kStep / 32;           // a lane's positions in a step
constexpr int kRing = 4;         // a walk warp's ring stages
constexpr int kStage = 2 * kStep;          // words: buckets, weights
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

// Block-wide stream compaction in batch order (warp ballot + prefix count
// over the 32 warps): returns how many threads of the block keep, and in
// *slot each keeping thread's rank among them. Callers sync before the
// next call reuses s_warp.
__device__ __forceinline__ int compact(bool keep, int* s_warp, int* slot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += y;
    }
    s_warp[lane] = c;
  }
  __syncthreads();
  *slot = (warp ? s_warp[warp - 1] : 0) + __popc(ballot & ((1u << lane) - 1u));
  return s_warp[kWarps - 1];
}

// After the sort: for each sorted position p and depth row j, the bucket
// sidx[j, p] and the weight sval[j, p], v * sign rounded on its own, so
// that a walk's loads depend on p alone; where the walk adds nothing (a
// zero weight, or a bucket outside [0, w)), -1 and -0.0, which leaves any
// float as it is when added. The last position of each run records the
// run's end under its row (run_end [n]). One thread a position.
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const int32_t* __restrict__ srow,
              const int32_t* __restrict__ perm,
              const int32_t* __restrict__ count, int d, int w,
              const int32_t* __restrict__ idx,
              const float* __restrict__ values,
              const float* __restrict__ signs, int32_t* __restrict__ sidx,
              float* __restrict__ sval, long long cap,
              int32_t* __restrict__ run_end) {
  const long long p = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  const long long len = *count;
  if (p >= len) return;
  const int32_t row = __ldg(srow + p);
  if (p + 1 == len || __ldg(srow + p + 1) != row) {
    run_end[row] = (int32_t)(p + 1);
  }
  const int t = __ldg(perm + p);
  const float v = __ldg(values + t);
  for (int j = 0; j < d; ++j) {
    const long long tj = (long long)t * d + j;
    const int b = __ldg(idx + tj);
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

// One warp per (chunk c of 32 sorted positions, depth row j): block B
// holds chunks 4 (B / d) .. + 3 at depth row B % d, so a chunk's d warps
// sit on d consecutive blocks, started at once on d SMs. A warp takes the
// runs that start in its chunk and walks the last one to its end. srow
// [cap] and sidx / sval [d, cap] are the sort's and the gather's output
// (*count positions).
__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(float* __restrict__ counts, int d, int w,
            const int32_t* __restrict__ srow,
            const int32_t* __restrict__ sidx,
            const float* __restrict__ sval, long long cap,
            const int32_t* __restrict__ run_end,
            const int32_t* __restrict__ count, long long chunks) {
  __shared__ __align__(16) int32_t ring[kWalkWarps][kRing * kStage];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int j = (int)(blockIdx.x % d);
  const long long c0 = ((long long)blockIdx.x / d * kWalkWarps + wib) * 32;
  if (c0 >= chunks * 32) return;               // uniform across the warp
  const long long len = *count;
  if (c0 >= len) return;
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
  const long long pend =                       // one past the chunk's last run
      c0 + 32 < len ? __ldg(run_end + r0) : 0;
  // steps of kStep positions from c0 + 32 to the run's end, through the
  // ring: stage word 4 * lane + k of array i (buckets, weights) is a
  // step's position 4 * lane + k. Copies stop at the 16 bytes that hold
  // the run's last position (<= cap); the first stages are in flight while
  // the chunk itself is added.
  int32_t* const my = ring[wib];
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

// One tuple as a bucket_kernel thread reads it for depth row j.
struct Tuple {
  int row;
  int bucket;
  float value;
};

__device__ __forceinline__ Tuple load_tuple(const int32_t* rows,
                                            const int32_t* idx,
                                            const float* values,
                                            const float* signs, int t, int T,
                                            int d, int j) {
  Tuple x{-1, -1, 0.0f};
  if (t < T) {     // independent loads, so their latencies overlap
    const long long tj = (long long)t * d + j;
    x.row = __ldg(rows + t);
    x.bucket = __ldg(idx + tj);
    x.value = __ldg(values + t);
    if (signs != nullptr) x.value *= __ldg(signs + tj);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
bucket_kernel(float* __restrict__ counts, int d, int w,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ idx,
              const float* __restrict__ values,
              const float* __restrict__ signs, int T) {
  // per chunk: the kept tuples' buckets (relative to b_lo) and signed
  // weights in batch order; per owned bucket, this step's entry mask
  __shared__ int s_warp[kWarps];
  __shared__ int s_b[kThreads];
  __shared__ float s_v[kThreads];
  __shared__ unsigned s_mine[kRange];

  const int s = blockIdx.y / d;
  const int j = blockIdx.y % d;
  const int b_lo = blockIdx.x * kRange;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool owner = tid < kRange && b_lo + tid < w;
  float* elem = counts + ((long long)s * d + j) * w + b_lo + tid;
  float acc = owner ? *elem : 0.0f;
  bool touched = false;

  Tuple cur = load_tuple(rows, idx, values, signs, tid, T, d, j);
  for (int base = 0; base < T; base += kThreads) {
    // the next chunk's loads fly while this chunk is compacted and walked
    const Tuple nxt =
        load_tuple(rows, idx, values, signs, base + kThreads + tid, T, d, j);
    const int bb = cur.bucket - b_lo;
    // adding +-0 never changes a sum, so zero weights are dropped here
    const bool keep = cur.row == s && bb >= 0 && bb < kRange &&
                      b_lo + bb < w && cur.value != 0.0f;
    int off;
    const int total = compact(keep, s_warp, &off);
    if (keep) {
      s_b[off] = bb;
      s_v[off] = cur.value;
    }
    __syncthreads();
    // 32 entries per step, walked by the warps that own buckets: each
    // entry of this warp's 32 buckets sets its lane's bit in its owner's
    // mask; each owner then takes its entries lowest lane first (batch
    // order), reading their weights from the lanes that hold them
    if (warp < kRange / 32) {
      for (int k0 = 0; k0 < total; k0 += 32) {
        const int e = k0 + lane < total ? s_b[k0 + lane] : -1;
        const float v = k0 + lane < total ? s_v[k0 + lane] : 0.0f;
        s_mine[tid] = 0u;
        __syncwarp();
        if (e >= 0 && (e >> 5) == warp) atomicOr(&s_mine[e], 1u << lane);
        __syncwarp();
        unsigned mine = s_mine[tid];
        touched |= mine != 0u;
        const int steps = (int)__reduce_max_sync(0xffffffffu, __popc(mine));
        for (int i = 0; i < steps; ++i) {
          const int src = mine != 0u ? __ffs(mine) - 1 : lane;
          const float x = __shfl_sync(0xffffffffu, v, src);
          if (mine != 0u) {
            acc += x;
            mine &= mine - 1u;
          }
        }
        __syncwarp();   // the next step clears s_mine
      }
    }
    __syncthreads();    // the next chunk reuses the shared buffers
    cur = nxt;
  }
  if (owner && touched) *elem = acc;
}

// The main path's scratch (cm_layout's words): the sort's (row_sort.cuh),
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

bool small_stack(int n, int d) { return (long long)d * n < kThreads; }

int launch_scatter(float* counts, int n, int d, int w, const int32_t* rows,
                   const int32_t* idx, const float* values,
                   const float* signs, int T, int32_t* scratch,
                   cudaStream_t stream) {
  if (d < 1 || d > kThreads || w < 1) return (int)cudaErrorInvalidValue;
  if (small_stack(n, d)) {
    const dim3 grid((unsigned)((w + kRange - 1) / kRange),
                    (unsigned)(d * n));
    bucket_kernel<<<grid, kThreads, 0, stream>>>(counts, d, w, rows, idx,
                                                 values, signs, T);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)T + 31) / 32;
  const long long blocks = (chunks + kWalkWarps - 1) / kWalkWarps * d;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Layout l = layout(scratch, d, T);
  const cudaError_t err = sde::sort_rows(rows, n, T, l.sort, stream);
  if (err != cudaSuccess) return (int)err;
  gather_kernel<<<(unsigned)((T + kGatherThreads - 1) / kGatherThreads),
                  kGatherThreads, 0, stream>>>(
      l.sort.srow, l.sort.perm, l.sort.count, d, w, idx, values, signs,
      l.sidx, l.sval, l.sort.cap, l.run_end);
  walk_kernel<<<(unsigned)blocks, kWalkWarps * 32, 0, stream>>>(
      counts, d, w, l.sort.srow, l.sidx, l.sval, l.sort.cap, l.run_end,
      l.sort.count, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch a call needs, in int32 words (none for the bucket-range
// launch; d = 0: the sort's alone, for cm_sort_rows), and where the sort
// leaves its output: off[0..3] = the word offsets of count, srow, perm and
// the total.
int cm_layout(int n, int d, int T, long long* off) {
  if (T <= 0 || n <= 0 || d < 0 || (d > 0 && small_stack(n, d))) {
    off[0] = off[1] = off[2] = off[3] = 0;
    return 0;
  }
  off[0] = 0;
  off[1] = sde::sort_srow_word(T);
  off[2] = off[1] + sde::round32(T);
  off[3] = d > 0 ? layout_words(n, d, T) : sde::sort_words(T);
  return 0;
}

// counts [n, d, w] f32 (updated in place); rows [T] i32 (-1 drops);
// idx [T, d] i32; values [T] f32; signs [T, d] f32 or null for +1;
// scratch: cm_layout(n, d, T) words, 128-byte aligned.
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

// The stable row sort alone, into scratch of cm_layout(n, 0, T) words.
int cm_sort_rows(const int32_t* rows, int n, int T, int32_t* scratch,
                 cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  return (int)sde::sort_rows(rows, n, T, sde::sort_scratch(scratch, T),
                             stream);
}

}  // extern "C"
