// RHP / SimHash sign-row projection add for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rhp_project.py, rhp_project_update (rows
// given) and rhp_probe_update (routing probe fused). The TPU kernels turn
// the routed add into an [S_tile x T_tile] x [T_tile x B_tile] MXU matmul
// (A[t, s] = [rows[t] == s] * v[t]); on the card it is a routed row add:
//
//   state[s, :] += sum_t [rows[t] == s] * v[t] * sgn[t, :]
//
// Tuples whose row lies outside [0, n) are dropped. b (the planes) may be
// any width: the last 32-lane slice of a row is masked. Offsets row * b
// and t * b are 64-bit.
//
// Determinism. No float atomicAdd: every state element (s, j) has ONE
// owner thread, which adds its row's tuples in batch order, so the state
// bytes are the same on every run and integer weights give exactly the
// sequential sums. How tuples reach their row's owners (option b of the
// design): the wrapper orders the routed rows with a STABLE sort
// (torch.sort(stable=True): equal rows keep batch order) into
//   srow [T]  the rows in ascending order, and
//   perm [T]  the batch index of each sorted position.
// That ordering is preparation, as hashing is; the additions all happen
// here. Equal rows then form one run of sorted positions, and
//   * a warp owns a chunk of 32 sorted positions and a slice of 32
//     planes (lane j of the warp owns plane slice * 32 + j);
//   * a position starts a run when its row lies in [0, n) and differs from
//     the previous position's; the warp finds the starts of its chunk with
//     one ballot and walks each of those runs to its end (past its chunk
//     if need be), so every run has exactly one owner warp per slice;
//   * a walk keeps its plane's element in a register: one read and one
//     write of state per owned element, whatever the run's length.
// The fused entry first runs the probe (probe.cuh) as a small launch that
// writes the routed rows into wrapper-allocated scratch: the sort needs
// them in device memory.
//
// The dense sign row maps well onto this: every tuple of a run touches
// all b planes, so the slice's 32 lanes read 128 consecutive bytes of
// sgn per tuple, coalesced, with no per-bucket compaction.
//
// Bound on this card: memory. The work must read the batch once (rows or
// sid halves and the probed table slots, v, and sgn: T * b * 4 bytes, the
// bulk of it) and read and write each touched state row once; its
// arithmetic is one multiply and one add per tuple and plane. What this
// design does about it: sgn is read once, coalesced, and only for routed
// tuples; state is touched only at the rows the batch routes to. What
// remains: a Zipf-hot row's run is walked by one warp per slice in
// sequence (~8k tuples for the hottest of 65,536 streams at Zipf 1.1).
// A step stages its 32 tuples and values in the warp's shared memory, so
// each lane reads them four at a time instead of shuffling one by one,
// and the walk is pipelined one step deep: before a step's dependent add
// chain it issues the next step's 32 sign-row loads and value loads and
// the step after's tuples. Even so the hot run's walk takes several
// times its 32-add chain a step: one warp alone issues the step's ~150
// instructions, with little else on its scheduler to overlap their
// latencies (a deeper prefetch, through a cp.async ring in shared memory,
// was no faster). The sort adds a few small launches per batch.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kProbeThreads = 256;
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

// Lane k's tuple for the step at sorted position base: the batch index of
// position base + k if that position still holds row r, else -1. (A batch
// index fits in 32 bits: T is an int.)
__device__ __forceinline__ int run_tuple(const int32_t* __restrict__ srow,
                                         const int64_t* __restrict__ perm,
                                         long long base, int r, int T) {
  const long long pos = base + (threadIdx.x & 31);
  if (pos >= T) return -1;
  const int32_t row = srow[pos];
  const int t = (int)perm[pos];
  return row == r ? t : -1;
}

// Issue one step's 32 sign loads, sg[t_k * b] for the 32 tuples staged in
// shared memory (four at a time with one 16-byte read), into s. The
// loads are unconditional, so none waits behind a branch.
__device__ __forceinline__ void load_signs(float (&s)[32],
                                           const float* __restrict__ sg,
                                           const int* st, int b) {
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const int4 t4 = *reinterpret_cast<const int4*>(st + k);
    s[k] = __ldg(sg + (long long)t4.x * b);
    s[k + 1] = __ldg(sg + (long long)t4.y * b);
    s[k + 2] = __ldg(sg + (long long)t4.z * b);
    s[k + 3] = __ldg(sg + (long long)t4.w * b);
  }
}

// One warp adds the run of sorted positions [p0, ...) whose row is r into
// plane j of row r (lane_ok: j < b), in batch order, 32 tuples a step.
// Lane k loads the step's k-th tuple and value and stages them in the
// warp's shared memory (st: 32 tuples; sv: two buffers of 32 values), from
// where every lane reads them four at a time. Pipelined one step deep:
// before a step's 32 dependent adds the warp issues the next step's sign
// and value loads and the tuples of the step after.
__device__ __forceinline__ void walk_run(float* __restrict__ state, int b,
                                         int r, int j, bool lane_ok,
                                         const int32_t* __restrict__ srow,
                                         const int64_t* __restrict__ perm,
                                         const float* __restrict__ values,
                                         const float* __restrict__ signs,
                                         long long p0, int T, int* st,
                                         float* sv) {
  const int lane = threadIdx.x & 31;
  float* const dst = state + (long long)r * b + j;
  float acc = lane_ok ? *dst : 0.0f;
  // lanes past b read the row's last plane and discard it
  const float* const sg = signs + (lane_ok ? j : b - 1);
  int t_cur = run_tuple(srow, perm, p0, r, T);
  int t_next = run_tuple(srow, perm, p0 + 32, r, T);
  // past the run, a lane stages the run's first tuple: a valid sgn row
  const int t_first = __shfl_sync(kFull, t_cur, 0);
  __syncwarp();                       // the previous run's reads are done
  st[lane] = t_cur >= 0 ? t_cur : t_first;
  sv[lane] = t_cur >= 0 ? values[t_cur] : 0.0f;
  __syncwarp();
  float s_cur[32], s_next[32];
  load_signs(s_cur, sg, st, b);
  for (long long base = p0, cur = 0;; base += 32, cur ^= 32) {
    // sorted: the run's entries of a step are a prefix of the warp
    const int cnt = __popc(__ballot_sync(kFull, t_cur >= 0));
    float v_next = 0.0f;
    int t_after = -1;
    if (cnt == 32) {                   // the run may go on: load ahead
      __syncwarp();
      st[lane] = t_next >= 0 ? t_next : t_first;
      __syncwarp();
      load_signs(s_next, sg, st, b);
      v_next = t_next >= 0 ? values[t_next] : 0.0f;
      t_after = run_tuple(srow, perm, base + 64, r, T);
    }
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(sv + cur + k);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // v * sgn rounded on its own, then added: no fused multiply-add,
        // so the sums are those of the plain version's ``v * sgn`` rows
        if (k + q < cnt) acc = __fadd_rn(acc, __fmul_rn(v[q], s_cur[k + q]));
      }
    }
    if (cnt < 32) break;
    sv[(cur ^ 32) + lane] = v_next;    // the other buffer: nobody reads it
    __syncwarp();
    t_cur = t_next;
    t_next = t_after;
#pragma unroll
    for (int k = 0; k < 32; ++k) s_cur[k] = s_next[k];
  }
  if (lane_ok) *dst = acc;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
project_kernel(float* __restrict__ state, int n, int b, int slices,
               const int32_t* __restrict__ srow,
               const int64_t* __restrict__ perm,
               const float* __restrict__ values,
               const float* __restrict__ signs, int T) {
  __shared__ __align__(16) int s_t[kWarpsPerBlock][32];
  __shared__ __align__(16) float s_v[kWarpsPerBlock][64];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + w;
  const long long c0 = warp / slices * 32;     // first sorted position
  if (c0 >= T) return;                         // uniform across the warp
  const int j = (int)(warp % slices) * 32 + lane;
  const bool lane_ok = j < b;
  const long long p = c0 + lane;
  int row = -1;
  bool start = false;
  if (p < T) {
    row = srow[p];
    start = row >= 0 && row < n && (p == 0 || srow[p - 1] != row);
  }
  unsigned starts = __ballot_sync(kFull, start);
  while (starts != 0u) {
    const int k = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int r = __shfl_sync(kFull, row, k);
    walk_run(state, b, r, j, lane_ok, srow, perm, values, signs, c0 + k, T,
             s_t[w], s_v[w]);
  }
}

}  // namespace

extern "C" {

// state [n, b] f32 (updated in place); srow [T] i32 ascending, perm [T]
// i64 (a stable sort of the routed rows and its permutation; rows outside
// [0, n) are dropped); values [T] f32; signs [T, b] f32.
int rhp_project(float* state, int n, int b, const int32_t* srow,
                const int64_t* perm, const float* values, const float* signs,
                int T, cudaStream_t stream) {
  if (T <= 0 || n <= 0 || b <= 0) return 0;
  const int slices = (b + 31) / 32;
  const long long warps = ((long long)T + 31) / 32 * slices;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  project_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      state, n, b, slices, srow, perm, values, signs, T);
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
