// Bit-set max-scatter for Hopper (sm_90a): Bloom filters and FM/PCSA
// bitmaps.
//
// Replaces: src/repro/kernels/bitset_or.py, bitset_max_update (rows given)
// and bitset_probe_max_update (routing probe fused); through them also
// src/repro/kernels/fm_bitmap.py, fm_bit_update and fm_probe_bit_update
// (k = 1 on the flattened [n, maps * bits] plane). The TPU kernels sweep a
// [T, S, M] one-hot max cube per tile because max has no matmul form; on
// the card it is a direct scatter:
//
//   bits[s, idx[t, h]] = max(bits[s, idx[t, h]], upd[t])   for rows[t] == s,
//                                                         h < k
//
// One thread per tuple: probe (template flag kProbe) or read the row, skip
// rows outside [0, n) and upd <= 0 (upd 0 is the masked no-op), then one
// atomicMax per hash position inside [0, m). Integer max does not depend
// on order, so the result is exact and the same on every run. Offsets are
// 64-bit: a Bloom stack of 131,072 rows of 2**15 lanes already holds 2**32
// lanes.
//
// Bound on this card: memory. The work must read the batch once (rows or
// sid halves, idx, upd), read the probed table slots (12 bytes each), and
// read and write each touched lane once; its arithmetic is k compares per
// tuple. What this design does about it: one pass over the batch, the
// state touched only at the updated lanes, the probe fused so routed rows
// never go through device memory. Each lane update is its own 4-byte
// atomic into a row of up to 64 KB, so the touched lanes cost a sector
// each; that, and atomics colliding on the lanes of a hot stream, is the
// remaining gap.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kProbe>
__global__ void bitset_kernel(int32_t* __restrict__ bits, int n, int m,
                              const int32_t* __restrict__ rows,
                              const uint32_t* __restrict__ keys_lo,
                              const uint32_t* __restrict__ keys_hi,
                              const int32_t* __restrict__ table_rows,
                              uint32_t size, const uint32_t* __restrict__ sid_lo,
                              const uint32_t* __restrict__ sid_hi, int n_probe,
                              const int32_t* __restrict__ idx, int k,
                              const int32_t* __restrict__ upd, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int32_t u = upd[t];
  if (u <= 0) return;
  const int32_t row =
      kProbe ? sde::probe_row(keys_lo, keys_hi, table_rows, size, sid_lo[t],
                              sid_hi[t], n_probe)
             : rows[t];
  if (row < 0 || row >= n) return;
  int32_t* const base = bits + (long long)row * m;
  const int32_t* const pos = idx + (long long)t * k;
  for (int h = 0; h < k; ++h) {
    const int32_t p = pos[h];
    if (p >= 0 && p < m) atomicMax(base + p, u);
  }
}

}  // namespace

extern "C" {

// bits [n, m] i32 (updated in place); rows / upd [T] i32; idx [T, k] i32.
int bitset_max_update(int32_t* bits, int n, int m, const int32_t* rows,
                      const int32_t* idx, int k, const int32_t* upd, int T,
                      cudaStream_t stream) {
  if (T <= 0 || n <= 0 || k <= 0) return 0;
  bitset_kernel<false><<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      bits, n, m, rows, nullptr, nullptr, nullptr, 0u, nullptr, nullptr, 0,
      idx, k, upd, T);
  return (int)cudaGetLastError();
}

// As bitset_max_update, with the rows probed in the kernel from the
// routing-table mirror (keys_lo / keys_hi / table_rows of pow2 `size`)
// for the stream-id halves sid_lo / sid_hi [T].
int bitset_probe_max_update(int32_t* bits, int n, int m,
                            const uint32_t* keys_lo, const uint32_t* keys_hi,
                            const int32_t* table_rows, int size,
                            const uint32_t* sid_lo, const uint32_t* sid_hi,
                            int n_probe, const int32_t* idx, int k,
                            const int32_t* upd, int T, cudaStream_t stream) {
  if (T <= 0 || n <= 0 || k <= 0) return 0;
  bitset_kernel<true><<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      bits, n, m, nullptr, keys_lo, keys_hi, table_rows, (uint32_t)size,
      sid_lo, sid_hi, n_probe, idx, k, upd, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
