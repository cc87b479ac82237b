// RHP / SimHash sign-row projection add for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rhp_project.py, rhp_project_update (rows
// given, :57) and rhp_probe_update (routing probe fused, :111). The TPU
// kernels turn the routed add into an [S_tile x T_tile] x [T_tile x B_tile]
// MXU matmul (A[t, s] = [rows[t] == s] * v[t]); on the card it is a routed
// row add:
//
//   state[s, :] += sum_t [rows[t] == s] * v[t] * sgn[t, :]
//
// Tuples whose row lies outside [0, n) are dropped. b (the planes) may be
// any width: the last 32-lane slice of a row is masked. Offsets are 64-bit.
//
// Determinism. No float atomicAdd: every state element (s, j) has ONE
// owner thread, which adds its row's tuples in batch order, starting from
// the element's old value: acc = __fadd_rn(acc, __fmul_rn(v, sgn)), each
// product rounded on its own. So the state bytes are those of the CPU's
// serial index_add_ for float weights, and integer weights give the exact
// sums. The wrapper orders the routed rows with a STABLE sort
// (torch.sort(stable=True): equal rows keep batch order) into
//   srow [T]  the rows in ascending order (-1 first, rows >= n last), and
//   perm [T]  the batch index of each sorted position;
// that ordering is preparation, as hashing is. Equal rows then form one
// run of sorted positions. Runs of fewer than kLongRun (256) tuples are
// short, the others long; a run's first position p0 starts a long run iff
// position p0 + kLongRun - 1 still holds its row, one test that every
// kernel below applies alike. Three launches follow the sort (a batch of
// fewer than kLongRun tuples makes the first only):
//
//   short_kernel (on the caller's stream): a warp owns a chunk of 32
//      sorted positions and a 32-plane slice q (lane j: plane 32q + j) and
//      adds the short runs that start in the chunk. It gathers the chunk's
//      32 products itself (perm, then a coalesced 128-byte piece of each
//      sign row) and loads the old state of every run that starts there,
//      all loads of a round issued together, then adds in order, segment
//      by segment; a run that goes on past the chunk is walked on 32
//      positions a step.
//   products_kernel, then long_kernel (on a second stream, forked from the
//      caller's after the sort and joined back after short_kernel, so they
//      share the card with it): the products pass writes v * sgn of every
//      position that may lie in a long run (the position kLongRun / 2
//      before or after it holds its row) into wrapper-allocated scratch
//      [slices, T/4, 32, 4] f32: the 4 products of positions 4g .. 4g + 3
//      at plane 32q + j are one 16-byte word, and a group's 32 words are
//      512 contiguous bytes. A block reads 32 positions' sign rows with
//      16-byte loads and transposes them through a shared-memory tile; the
//      last position of each long run records the run's end under its row
//      (scratch run_end [n]). Then one block per (window of kLongRun sorted
//      positions, slice): at most one long run starts in a window, and it
//      covers the window's last position, so the block finds it with one
//      round of loads (that position's row, and where the window's suffix
//      of that row starts) and a second (the long-run test and the
//      recorded end). Its second warp streams the run's groups through a
//      shared-memory ring of kStages stages of kRingGroups groups (256
//      positions, 32 KiB) with cp.async.bulk, a full and an empty mbarrier
//      a stage; its first warp runs each plane's add chain from shared
//      memory, one conflict-free 16-byte load a 4 adds, a full stage
//      unrolled, a run's partial first and last groups position by
//      position. Slice 0's block adds one to a device counter per long run
//      (an integer atomic), which the wrapper exposes, so a run can show
//      the path was taken.
//
// The fused entry first runs the probe (probe.cuh) as a small launch that
// writes the routed rows into wrapper-allocated scratch: the sort needs
// them in device memory.
//
// Bounds on this card. Bytes: the work must read the batch once (rows or
// sid halves and the probed table slots, v, and sgn: T * b * 4 bytes, the
// bulk of its 22.9 MB at phase 2's batch) and read and write each touched
// state row once: 0.0068 ms at 3.35 TB/s. The chain: under the byte
// contract each element's adds are one dependent chain, so the longest
// run sets a floor of its length times the add latency (4 cycles):
// 0.016 ms for phase 2's hottest row (8,095 of 65,536 Zipf(1.1) tuples)
// at 1.98 GHz, 2.4x the byte bound; a tree or chunked sum would give other
// bytes. What the design does about each: sgn is read once, coalesced,
// and only the long runs' products make a round trip through L2; the
// short runs never wait on the long ones; the long walk's loads do not
// depend on data and its ring keeps them ahead of the chain, and a 16-byte
// load feeds 4 adds (a 4-byte load an add costs a cycle more than the
// add's latency). What remains, in order: the stable sort, the largest
// part; the long walk's stage loop, some 5 cycles an add; the products
// pass ahead of it.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kProbeThreads = 256;
constexpr int kProductThreads = 256;  // 32 positions x 8 words
// runs of at least kLongRun tuples take long_kernel (rhp_project.py's
// LONG_RUN mirrors it); a multiple of 32 and of kRingRows
constexpr int kLongRun = 256;
// a ring stage holds kRingGroups groups of 4 positions of one slice
// (512 B each): 256 positions, 32 KiB; 3 stages, so 2 long-walk blocks fit
// an SM and the window blocks that find no run clear the card sooner
constexpr int kRingGroups = 64;
constexpr int kStages = 3;
static_assert(kLongRun % 32 == 0, "whole warps scan a window");
constexpr int kRingBytes = kStages * kRingGroups * 512;
constexpr int kLongSmem = kRingBytes + 2 * kStages * 8;
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

// The products scratch, [slices, T4, 32, 4] f32 with T4 = ceil(T / 4):
// element (q, p, j) = v * sgn of sorted position p at plane 32q + j, held
// at ((q * T4 + p / 4) * 32 + j) * 4 + p % 4. A lane's four consecutive
// positions are one 16-byte word, and the words of a group of four
// positions lie side by side: 512 contiguous bytes a group and slice.
__device__ __forceinline__ const float4* slice_of(const float* prod, int q,
                                                  long long T4) {
  return reinterpret_cast<const float4*>(prod) + (long long)q * T4 * 32;
}

// One block per (32 sorted positions, slice q = blockIdx.y), transposing
// through shared memory, for the positions that may lie in a run of
// kLongRun tuples or more (the long walk's): a position does if the one
// kLongRun / 2 before or after it holds its row. Thread i reads the 4
// planes 4(i % 8) .. of position i / 8 (16 bytes of its sign row where
// b % 4 == 0: coalesced), multiplies, and stores them in a [32 x 33]
// tile; then lane j of warp w writes plane j of positions 4w .. 4w + 3 as
// one 16-byte word (a warp's 512 bytes contiguous), where any of the 4 is
// kept. Positions not kept, outside [0, n) or past T, and planes past b
// get 0; the long walk adds none of them.
__global__ void __launch_bounds__(kProductThreads)
products_kernel(int n, int b, const int32_t* __restrict__ srow,
                const int64_t* __restrict__ perm,
                const float* __restrict__ values,
                const float* __restrict__ signs, int T,
                float* __restrict__ prod, int32_t* __restrict__ run_end) {
  __shared__ float tile[32][33];
  __shared__ int kept[32];
  const long long T4 = ((long long)T + 3) / 4;
  const long long p0 = (long long)blockIdx.x * 32;
  const int i = threadIdx.x;
  const int h = i & 7;
  const int j0 = blockIdx.y * 32 + 4 * h;
  const long long p = min(p0 + (i >> 3), (long long)T - 1);
  const int32_t row = __ldg(srow + p);
  const int32_t back = __ldg(srow + max(p - kLongRun / 2, 0ll));
  const int32_t fore = __ldg(srow + min(p + kLongRun / 2, (long long)T - 1));
  const bool keep = p0 + (i >> 3) < T && row >= 0 && row < n &&
                    ((p >= kLongRun / 2 && back == row) ||
                     (p + kLongRun / 2 < T && fore == row));
  if (!__syncthreads_or(keep)) return;         // no long run here
  if (h == 0) {
    kept[i >> 3] = keep;
    // the last position of a run of kLongRun tuples or more records the
    // run's end under its row, for the long walk
    const int32_t next = __ldg(srow + min(p + 1, (long long)T - 1));
    const int32_t first = __ldg(srow + max(p - kLongRun + 1, 0ll));
    if (keep && (p == T - 1 || next != row) && p - kLongRun + 1 >= 0 &&
        first == row) {
      run_end[row] = (int32_t)(p + 1);
    }
  }
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (keep) {
    const long long t = __ldg(reinterpret_cast<const long long*>(perm) + p);
    const float v = __ldg(values + t);
    float s[4];
    if ((b & 3) == 0) {           // 16-byte aligned words; j0 < b covers 4
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(
          signs + t * b + (j0 < b ? j0 : b - 4)));
      s[0] = s4.x;
      s[1] = s4.y;
      s[2] = s4.z;
      s[3] = s4.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] = __ldg(signs + t * b + (j0 + k < b ? j0 + k : b - 1));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j0 + k < b) o[k] = __fmul_rn(v, s[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) tile[i >> 3][4 * h + k] = o[k];
  __syncthreads();
  const int w = i >> 5, j = i & 31;
  const long long g = p0 / 4 + w;
  if (g < T4 && (kept[4 * w] | kept[4 * w + 1] | kept[4 * w + 2] |
                 kept[4 * w + 3])) {
    reinterpret_cast<float4*>(prod)[((long long)blockIdx.y * T4 + g) * 32 +
                                    j] =
        make_float4(tile[4 * w][j], tile[4 * w + 1][j], tile[4 * w + 2][j],
                    tile[4 * w + 3][j]);
  }
}

// The products v * sgn of sorted positions [base, base + 32) at plane j
// (lane_ok: j < b), gathered: lane k holds position base + k's batch index
// t (from perm) and value, and every lane reads its plane of each of the
// 32 sign rows (128 coalesced bytes a row). Positions past T read the last
// position's; no add takes them.
__device__ __forceinline__ void gather32(float (&x)[32],
                                         const int64_t* __restrict__ perm,
                                         const float* __restrict__ values,
                                         const float* __restrict__ signs,
                                         long long base, int T, int b, int j) {
  const int lane = threadIdx.x & 31;
  const long long pc = min(base + lane, (long long)T - 1);
  const long long t = __ldg(reinterpret_cast<const long long*>(perm) + pc);
  const float v = __ldg(values + t);
  const int jc = j < b ? j : b - 1;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const long long tk = __shfl_sync(kFull, t, k);
    x[k] = __ldg(signs + tk * b + jc);
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    x[k] = __fmul_rn(__shfl_sync(kFull, v, k), x[k]);
  }
}

// One warp per (chunk of 32 sorted positions, slice): the runs of fewer
// than kLongRun tuples that start in the chunk. Lane j owns plane 32q + j
// of each such run's row; it gathers the products itself and adds them in
// order.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
short_kernel(float* __restrict__ state, int n, int b, int slices,
             const int32_t* __restrict__ srow,
             const int64_t* __restrict__ perm,
             const float* __restrict__ values,
             const float* __restrict__ signs, int T) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long c0 = warp / slices * 32;     // first sorted position
  if (c0 >= T) return;                         // uniform across the warp
  const int q = (int)(warp % slices);
  const int j = q * 32 + lane;
  const bool lane_ok = j < b;
  // unconditional loads at clamped positions, issued together
  const long long p = c0 + lane;
  const long long pc = p < T ? p : T - 1;
  const int32_t row = __ldg(srow + pc);
  const int32_t prev = __ldg(srow + (pc > 0 ? pc - 1 : 0));
  const int32_t ahead =
      __ldg(srow + min(pc + kLongRun - 1, (long long)T - 1));
  const int32_t after = __ldg(srow + min(c0 + 32, (long long)T - 1));
  // a run boundary; the start of a run of fewer than kLongRun tuples
  const bool edge = p >= T || p == 0 || prev != row;
  const bool owned = p < T && edge && row >= 0 && row < n &&
                     !(pc + kLongRun - 1 < T && ahead == row);
  const unsigned edges = __ballot_sync(kFull, edge);
  const unsigned starts = __ballot_sync(kFull, owned);
  if (starts == 0u) return;
  // the chunk's 32 products and the owned runs' state, loads issued together
  float v[32], old[32];
  gather32(v, perm, values, signs, c0, T, b, j);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = __shfl_sync(kFull, row, i);
    old[i] = ((starts >> i) & 1u) && lane_ok ? state[(long long)r * b + j]
                                             : 0.0f;
  }
  float acc = 0.0f;
  int cur = -1;                                // the owned run's row, or -1
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((edges >> i) & 1u) {                   // uniform: a run ends here
      if (cur >= 0 && lane_ok) state[(long long)cur * b + j] = acc;
      cur = ((starts >> i) & 1u) ? __shfl_sync(kFull, row, i) : -1;
      acc = old[i];
    }
    // v * sgn was rounded on its own; the add is not fused with it
    if (cur >= 0) acc = __fadd_rn(acc, v[i]);
  }
  if (cur < 0) return;
  if (c0 + 32 < T && after == cur) {
    // the last owned run goes on past the chunk: walk on, 32 positions a
    // step
    for (long long base = c0 + 32;; base += 32) {
      const int32_t r = __ldg(srow + min(base + lane, (long long)T - 1));
      gather32(v, perm, values, signs, base, T, b, j);
      const int cnt =                          // sorted: a prefix of lanes
          __popc(__ballot_sync(kFull, base + lane < T && r == cur));
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i < cnt) acc = __fadd_rn(acc, v[i]);
      }
      if (cnt < 32) break;
    }
  }
  if (lane_ok) state[(long long)cur * b + j] = acc;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Ring stage k: the run's groups [k * kRingGroups, ...) of `groups` (at
// most kRingGroups of them) from src into stage k % kStages, reported to
// that stage's barrier.
__device__ __forceinline__ void ring_fill(float4* ring, uint64_t* bars,
                                          const float4* src, int k,
                                          long long groups) {
  const int st = k % kStages;
  const uint32_t bar = smem_u32(bars + st);
  const long long left = groups - (long long)k * kRingGroups;
  const uint32_t bytes =
      (uint32_t)(left < kRingGroups ? left : kRingGroups) * 512u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(ring + st * kRingGroups * 32)),
        "l"(src + (long long)k * kRingGroups * 32), "r"(bytes), "r"(bar)
      : "memory");
}

// acc += the word's components whose positions (pos .. pos + 3) lie in
// [p0, p1), in order: a run's partial first or last group of 4
__device__ __forceinline__ float add_part(float acc, float4 x, long long pos,
                                          long long p0, long long p1) {
  const float c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (pos + k >= p0 && pos + k < p1) acc = __fadd_rn(acc, c[k]);
  }
  return acc;
}

// acc += every product of a stage's groups kFirst .. kRingGroups - 1, in
// order: one 16-byte word (4 positions) a load, unrolled
template <int kFirst>
__device__ __forceinline__ float add_groups(float acc, const float4* rg) {
#pragma unroll
  for (int i = kFirst; i < kRingGroups; ++i) {
    const float4 x = rg[i * 32];
    acc = __fadd_rn(acc, x.x);
    acc = __fadd_rn(acc, x.y);
    acc = __fadd_rn(acc, x.z);
    acc = __fadd_rn(acc, x.w);
  }
  return acc;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}

// Two warps per (window of kLongRun sorted positions, slice q =
// blockIdx.y): the run of at least kLongRun tuples that starts in the
// window, if any. Such a run covers the window's last position, so its row
// is that position's, and it starts where the window's suffix of that row
// starts; its end is the products pass's record for the row. Warp 1's lane
// 0 keeps the ring filled; warp 0 adds.
__global__ void __launch_bounds__(64)
long_kernel(float* __restrict__ state, int n, int b,
            const int32_t* __restrict__ srow, const float* __restrict__ prod,
            const int32_t* __restrict__ run_end, int T,
            unsigned long long* __restrict__ walked) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* const ring = reinterpret_cast<float4*>(smem);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* const empty = full + kStages;
  constexpr int kPer = kLongRun / 32;
  const int lane = threadIdx.x & 31;
  const bool adder = threadIdx.x < 32;
  const long long w0 = (long long)blockIdx.x * kLongRun;
  const long long last = w0 + kLongRun - 1;    // < T: the launch's grid
  // one round of independent loads: the candidate row, the row before the
  // window, and the window's rows (both warps alike)
  const int32_t r = __ldg(srow + last);
  const int32_t before = __ldg(srow + (w0 > 0 ? w0 - 1 : 0));
  int32_t win[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) win[k] = __ldg(srow + w0 + lane * kPer + k);
  int cnt = 0;                                 // the window's suffix of r
#pragma unroll
  for (int k = 0; k < kPer; ++k) cnt += win[k] == r;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (r < 0 || r >= n || (w0 > 0 && before == r)) return;   // uniform
  const long long p0 = last + 1 - cnt;         // the run's first position
  // a second round: whether the run is long, and its end if it is
  const int32_t at_l = __ldg(srow + min(p0 + kLongRun - 1, (long long)T - 1));
  const long long p1 = __ldg(run_end + r);     // one past the run
  if (p0 + kLongRun - 1 >= T || at_l != r) return;   // short: not ours
  const int q = blockIdx.y;
  const long long T4 = ((long long)T + 3) / 4;
  // the ring streams whole groups, from the one holding p0
  const float4* const src = slice_of(prod, q, T4) + p0 / 4 * 32;
  const long long a0 = p0 / 4 * 4;
  const long long groups = (p1 + 3) / 4 - p0 / 4;
  const int n_stages = (int)((groups + kRingGroups - 1) / kRingGroups);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (q == 0) atomicAdd(walked, 1ull);
  }
  __syncthreads();
  if (!adder) {                                // the ring's filler
    if (lane == 0) {
      for (int k = 0; k < n_stages; ++k) {
        const int st = k % kStages;
        if (k >= kStages) {                    // the adder read the stage
          mbar_wait(smem_u32(empty + st), (uint32_t)(k / kStages - 1) & 1u);
        }
        ring_fill(ring, full, src, k, groups);
      }
    }
    return;
  }
  const int j = q * 32 + lane;
  const bool lane_ok = j < b;
  float* const dst = state + (long long)r * b + j;
  float acc = lane_ok ? *dst : 0.0f;
  for (int k = 0; k < n_stages; ++k) {
    const int st = k % kStages;
    mbar_wait(smem_u32(full + st), (uint32_t)(k / kStages) & 1u);
    const float4* const rg = ring + st * kRingGroups * 32 + lane;
    const long long g0 = (long long)k * kRingGroups;  // the stage's groups
    const long long pos0 = a0 + g0 * 4;
    const int m = (int)min((long long)kRingGroups, groups - g0);
    const bool head = pos0 < p0;               // stage 0, p0 % 4 != 0
    const bool tail = g0 + m == groups && (p1 & 3) != 0;
    if (m == kRingGroups && !tail) {           // the stage's 256 positions
      if (head) {
        acc = add_part(acc, rg[0], pos0, p0, p1);
        acc = add_groups<1>(acc, rg);
      } else {
        acc = add_groups<0>(acc, rg);
      }
    } else {                                   // the run's last stage
      if (head) acc = add_part(acc, rg[0], pos0, p0, p1);
      const int e = m - (tail ? 1 : 0);
#pragma unroll 4
      for (int i = head ? 1 : 0; i < e; ++i) {
        const float4 x = rg[i * 32];
        acc = __fadd_rn(acc, x.x);
        acc = __fadd_rn(acc, x.y);
        acc = __fadd_rn(acc, x.z);
        acc = __fadd_rn(acc, x.w);
      }
      if (tail) {
        acc = add_part(acc, rg[(m - 1) * 32], pos0 + 4 * (m - 1), p0, p1);
      }
    }
    mbar_arrive(smem_u32(empty + st));         // this lane read the stage
  }
  if (lane_ok) *dst = acc;
}

// A side stream and its fork and join events, one set per device, made at
// first use and kept for the process.
struct Fork {
  cudaStream_t side;
  cudaEvent_t fork, join;
};

cudaError_t fork_of_device(Fork** out) {
  constexpr int kDevices = 64;
  static Fork forks[kDevices];
  static bool made[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  Fork& f = forks[dev];
  if (!made[dev]) {
    err = cudaStreamCreateWithFlags(&f.side, cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&f.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&f.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    made[dev] = true;
  }
  *out = &f;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// state [n, b] f32 (updated in place); srow [T] i32 ascending, perm [T]
// i64 (a stable sort of the routed rows and its permutation; rows outside
// [0, n) are dropped); values [T] f32; signs [T, b] f32; scratch: prod
// [ceil(b / 32), ceil(T / 4), 32, 4] f32 and run_end [n] i32; walked: a
// device counter, plus one per run of kLongRun tuples or more (each walked
// by long_kernel).
int rhp_project(float* state, int n, int b, const int32_t* srow,
                const int64_t* perm, const float* values, const float* signs,
                int T, float* prod, int32_t* run_end,
                unsigned long long* walked, cudaStream_t stream) {
  if (T <= 0 || n <= 0 || b <= 0) return 0;
  const int slices = (b + 31) / 32;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const long long prod_blocks = ((long long)T + 31) / 32;
  const long long warps = ((long long)T + 31) / 32 * slices;
  const long long short_blocks = (warps + kWarpsPerBlock - 1) /
                                 kWarpsPerBlock;
  if (prod_blocks > 0x7fffffffLL || short_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the products pass and the long walk on a side stream forked from the
  // caller's after the sort, joined back after the short walk, which runs
  // beside them (else no run can be long, and neither is launched)
  Fork* fork = nullptr;
  if (T >= kLongRun) {
    cudaError_t err = fork_of_device(&fork);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLongSmem);
    }
    if (err == cudaSuccess) err = cudaEventRecord(fork->fork, stream);
    if (err == cudaSuccess) {
      err = cudaStreamWaitEvent(fork->side, fork->fork, 0);
    }
    if (err != cudaSuccess) return (int)err;
    products_kernel<<<dim3((unsigned)prod_blocks, slices), kProductThreads,
                      0, fork->side>>>(n, b, srow, perm, values, signs, T,
                                       prod, run_end);
    // the windows whose last position lies in the batch
    long_kernel<<<dim3((unsigned)(T / kLongRun), slices), 64, kLongSmem,
                  fork->side>>>(state, n, b, srow, prod, run_end, T, walked);
    err = cudaEventRecord(fork->join, fork->side);
    if (err != cudaSuccess) return (int)err;
  }
  short_kernel<<<(unsigned)short_blocks, kWarpsPerBlock * 32, 0, stream>>>(
      state, n, b, slices, srow, perm, values, signs, T);
  if (fork != nullptr) {
    const cudaError_t err = cudaStreamWaitEvent(stream, fork->join, 0);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The rows of the stream-id halves sid_lo / sid_hi [T], probed from the
// routing-table mirror (keys_lo / keys_hi / table_rows of pow2 `size`),
// into rows [T] i32 (-1 for unrouted ids).
int rhp_probe_rows(const uint32_t* keys_lo, const uint32_t* keys_hi,
                   const int32_t* table_rows, int size, const uint32_t* sid_lo,
                   const uint32_t* sid_hi, int n_probe, int32_t* rows, int T,
                   cudaStream_t stream) {
  if (T <= 0) return 0;
  probe_kernel<<<(T + kProbeThreads - 1) / kProbeThreads, kProbeThreads, 0,
                 stream>>>(keys_lo, keys_hi, table_rows, (uint32_t)size,
                           sid_lo, sid_hi, n_probe, rows, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
