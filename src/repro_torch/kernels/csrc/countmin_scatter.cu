// CountMin / count-sketch scatter-add for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/onehot_matmul.py, onehot_scatter_add (rows
// given) and onehot_probe_scatter (routing probe fused). The TPU kernels
// turn the scatter into a one-hot matmul on the MXU; on the card it is a
// direct scatter:
//
//   counts[s, j, idx[t, j]] += values[t] * signs[t, j]   for rows[t] == s
//
// Tuples whose row lies outside [0, n) are dropped (the reference's
// one-hot matches no row for them).
//
// Determinism. No float atomicAdd: every state element is summed by ONE
// thread, in batch order, so the state bytes are the same on every run,
// and integer-valued weights give exactly the sequential scatter's sums.
//   * Row tiles (scatter_kernel, d * n >= 1024, the main path): a block
//     owns a tile of 1024 / d consecutive state rows, and thread (r, j)
//     owns row s0 + r and depth row j.
//   * The block streams the batch's routed rows in chunks of 1024. For
//     each chunk it compacts the tuples that fall in its tile, in batch
//     order (warp ballot + prefix count over the 32 warps), into shared
//     memory together with their buckets and signed weights; then every
//     owner applies its own entries of that list in order, reading shared
//     memory only (a warp finds its lanes' entries 32 at a time with one
//     ballot per row it owns). This in-block loop takes the place of the
//     TPU's sequential T grid axis.
//   * Bucket ranges (bucket_kernel, d * n < 1024; the data-source fresh
//     sketch has n = 1): a row tile would be one block, every thread of
//     which walked every tuple of the batch. Instead block (x, y) owns
//     state row y / d, depth row y % d and the 256 buckets from x * 256,
//     one per thread of its first 8 warps, so 8 * 5 blocks share a
//     [1, 5, 2048] sketch. Each block streams the batch like a row tile
//     (the next chunk's loads in flight while it walks this one), keeping
//     only the tuples of its own (row, bucket range). Per 32-entry step,
//     each entry sets its bit in its owner's mask (a shared-memory
//     atomicOr), and each owner adds its entries lowest bit first, taking
//     their weights by warp shuffle. The owner keeps its element in a
//     register from the first to the last tuple.
//   * The fused entry first runs the probe (probe.cuh) as a small launch
//     that writes routed rows into wrapper-allocated scratch; both entry
//     points then share one scatter kernel, so it needs no rows-given /
//     probe-in-kernel template flag. Probing inside the scatter kernel
//     would repeat every tuple's probe in each of its ~640 blocks.
//
// Bound on this card: memory. The work must read the batch once
// (rows or sid halves, idx, values, signs), read the probed table slots,
// and read and write each touched state element once; its arithmetic is
// one add per update. What this design does about it: the state is
// touched only where the batch updates it (no pass over the [n, d, w]
// stack), so the state traffic is the touched elements alone. It is NOT
// yet at the bound: every block re-reads all T routed rows from L2, every
// warp of a block steps through its tile's whole compacted list (32
// entries a step), and one thread applies all of a hot row's updates of
// its depth row in sequence. These are left for a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the warp-count scan uses one warp");
constexpr int kProbeThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;   // a block's shared-memory cap
constexpr int kRange = 256;      // the buckets a bucket_kernel block owns
static_assert(kRange % 32 == 0 && kRange <= kThreads, "whole owner warps");

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

__global__ void __launch_bounds__(kThreads)
scatter_kernel(float* __restrict__ counts, int n, int d, int w, int chunk,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ idx,
               const float* __restrict__ values,
               const float* __restrict__ signs, int T) {
  // dynamic shared memory: per-warp counts, then for each compacted
  // tuple (batch order) its row in the tile, its d buckets and its d
  // signed weights -- staged once, so owners read shared memory only
  extern __shared__ int smem[];
  int* s_warp = smem;
  int* s_r = s_warp + kWarps;
  int* s_idx = s_r + chunk;
  float* s_val = reinterpret_cast<float*>(s_idx + chunk * d);

  const int tile = kThreads / d;
  const long long s0 = (long long)blockIdx.x * tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int my_r = tid / d;
  const int my_j = tid % d;
  const bool owner = my_r < tile && s0 + my_r < n;
  const int warp_r_lo = (warp * 32) / d;             // rows of this warp
  const int warp_r_hi = (warp * 32 + 31) / d;
  float* my_row = counts + ((s0 + my_r) * d + my_j) * (long long)w;
  // The owner keeps the element it last updated in a register: the same
  // adds in the same order as read-modify-writes through memory, without
  // a memory round trip per update while the bucket repeats (a stream's
  // tuples all hash to one bucket per depth row).
  int cur_b = -1;
  float acc = 0.0f;

  for (int base = 0; base < T; base += chunk) {
    const int t = base + tid;
    int lr = -1;
    if (tid < chunk && t < T) {
      const long long row = rows[t];
      if (row >= s0 && row < s0 + tile && row < n) lr = (int)(row - s0);
    }
    int off;
    const int total = compact(lr >= 0, s_warp, &off);
    if (lr >= 0) {
      s_r[off] = lr;
      const float v = values[t];
      for (int j = 0; j < d; ++j) {
        const long long tj = (long long)t * d + j;
        s_idx[off * d + j] = idx[tj];
        s_val[off * d + j] = signs != nullptr ? v * signs[tj] : v;
      }
    }
    __syncthreads();
    // Walk the list 32 entries per step: one ballot per row this warp
    // owns gives each lane the entries of its own row, which it applies
    // lowest index first -- still batch order, without every lane
    // stepping through every entry.
    for (int k0 = 0; k0 < total; k0 += 32) {
      const int e = k0 + lane < total ? s_r[k0 + lane] : -1;
      unsigned mine = 0;
      for (int r = warp_r_lo; r <= warp_r_hi; ++r) {
        const unsigned m = __ballot_sync(0xffffffffu, e == r);
        if (r == my_r) mine = m;
      }
      if (!owner) mine = 0;
      while (mine != 0u) {
        const int k = k0 + __ffs(mine) - 1;
        mine &= mine - 1u;
        const int b = s_idx[k * d + my_j];
        const float v = s_val[k * d + my_j];
        if (b < 0 || b >= w) continue;
        if (v == 0.0f) continue;         // adding +-0 never changes a sum
        if (b != cur_b) {
          if (cur_b >= 0) my_row[cur_b] = acc;
          cur_b = b;
          acc = my_row[b];
        }
        acc += v;
      }
    }
    __syncthreads();   // the next chunk reuses the shared buffers
  }
  if (owner && cur_b >= 0) my_row[cur_b] = acc;
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

int launch_scatter(float* counts, int n, int d, int w, const int32_t* rows,
                   const int32_t* idx, const float* values,
                   const float* signs, int T, cudaStream_t stream) {
  if (d < 1 || d > kThreads || w < 1) return (int)cudaErrorInvalidValue;
  if ((long long)d * n < kThreads) {
    const dim3 grid((unsigned)((w + kRange - 1) / kRange),
                    (unsigned)(d * n));
    bucket_kernel<<<grid, kThreads, 0, stream>>>(counts, d, w, rows, idx,
                                                 values, signs, T);
    return (int)cudaGetLastError();
  }
  // tuples staged per chunk: all of a block's threads, unless d is so
  // deep that their buckets and weights overflow shared memory
  int chunk = (kMaxSmemBytes / 4 - kWarps) / (1 + 2 * d);
  chunk = chunk >= kThreads ? kThreads : chunk / 32 * 32;
  if (chunk < 32) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (kWarps + (size_t)chunk * (1 + 2 * d));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tile = kThreads / d;
  const int blocks = (int)((n + tile - 1) / tile);
  scatter_kernel<<<blocks, kThreads, smem, stream>>>(
      counts, n, d, w, chunk, rows, idx, values, signs, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// counts [n, d, w] f32 (updated in place); rows [T] i32 (-1 drops);
// idx [T, d] i32; values [T] f32; signs [T, d] f32 or null for +1.
int cm_scatter(float* counts, int n, int d, int w, const int32_t* rows,
               const int32_t* idx, const float* values, const float* signs,
               int T, cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  return launch_scatter(counts, n, d, w, rows, idx, values, signs, T, stream);
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
                     cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  probe_kernel<<<(T + kProbeThreads - 1) / kProbeThreads, kProbeThreads, 0,
                 stream>>>(keys_lo, keys_hi, table_rows, (uint32_t)size,
                           sid_lo, sid_hi, n_probe, rows_scratch, T);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_scatter(counts, n, d, w, rows_scratch, idx, values, signs, T,
                        stream);
}

}  // extern "C"
