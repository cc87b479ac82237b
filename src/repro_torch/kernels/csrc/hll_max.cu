// HyperLogLog register max-scatter for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hll_max.py, hll_max_update (rows given) and
// hll_probe_max_update (routing probe fused). The TPU kernels sweep a
// [T, S, M] one-hot max cube per tile because max has no matmul form; on
// the card it is a direct scatter:
//
//   regs[s, bucket[t]] = max(regs[s, bucket[t]], rank[t])   for rows[t] == s
//
// One thread per tuple: probe (template flag kProbe) or read the row,
// skip rows outside [0, n) and rank <= 0 (rank 0 is the masked no-op),
// then atomicMax. Integer max does not depend on order, so the result is
// exact and the same on every run.
//
// Bound on this card: memory. The work must read the batch once (rows or
// sid halves, bucket, rank), read the probed table slots, and read and
// write each touched register once; its arithmetic is one max per tuple.
// What this design does about it: one pass over the batch with coalesced
// reads, the state touched only at the updated registers, the probe fused
// so routed rows never go through device memory. Colliding atomics on a
// hot register serialize in L2; that is the remaining gap.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kProbe>
__global__ void hll_kernel(int32_t* __restrict__ regs, int n, int m,
                           const int32_t* __restrict__ rows,
                           const uint32_t* __restrict__ keys_lo,
                           const uint32_t* __restrict__ keys_hi,
                           const int32_t* __restrict__ table_rows,
                           uint32_t size, const uint32_t* __restrict__ sid_lo,
                           const uint32_t* __restrict__ sid_hi, int n_probe,
                           const int32_t* __restrict__ bucket,
                           const int32_t* __restrict__ rank, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int32_t r = rank[t];
  if (r <= 0) return;
  const int32_t row =
      kProbe ? sde::probe_row(keys_lo, keys_hi, table_rows, size, sid_lo[t],
                              sid_hi[t], n_probe)
             : rows[t];
  if (row < 0 || row >= n) return;
  const int32_t b = bucket[t];
  if (b < 0 || b >= m) return;
  atomicMax(regs + (long long)row * m + b, r);
}

}  // namespace

extern "C" {

// regs [n, m] i32 (updated in place); rows / bucket / rank [T] i32.
int hll_max_update(int32_t* regs, int n, int m, const int32_t* rows,
                   const int32_t* bucket, const int32_t* rank, int T,
                   cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  hll_kernel<false><<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      regs, n, m, rows, nullptr, nullptr, nullptr, 0u, nullptr, nullptr, 0,
      bucket, rank, T);
  return (int)cudaGetLastError();
}

// As hll_max_update, with the rows probed in the kernel from the
// routing-table mirror (keys_lo / keys_hi / table_rows of pow2 `size`)
// for the stream-id halves sid_lo / sid_hi [T].
int hll_probe_max_update(int32_t* regs, int n, int m, const uint32_t* keys_lo,
                         const uint32_t* keys_hi, const int32_t* table_rows,
                         int size, const uint32_t* sid_lo,
                         const uint32_t* sid_hi, int n_probe,
                         const int32_t* bucket, const int32_t* rank, int T,
                         cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  hll_kernel<true><<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      regs, n, m, nullptr, keys_lo, keys_hi, table_rows, (uint32_t)size,
      sid_lo, sid_hi, n_probe, bucket, rank, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
