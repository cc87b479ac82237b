// Device twin of the hashed-routing linear probe.
//
// Replaces: src/repro/kernels/probe.py, slot0 and probe_rows (traced
// inside every fused Pallas kernel there). The plain PyTorch version is
// src/repro_torch/kernels/probe.py; the host-side insert path is
// service/routing.py::slot_hash. All three must stay in lockstep.
//
// Keys are stored as uint32 (lo, hi) halves. An empty slot has
// hi == 0xFFFFFFFF, which no valid stream id (< 2**63) carries. The loop
// runs at most n_probe steps, like the reference's fori_loop: a key
// displaced further resolves to -1.
#pragma once

#include <cstdint>

namespace sde {

constexpr uint32_t kRouteGolden = 0x9E3779B9u;
constexpr uint32_t kEmptyHi = 0xFFFFFFFFu;

// murmur3 fmix32, bit-identical to core/hashing.py::mix32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Row routed to stream id (lo, hi), or -1. `size` is a power of two.
__device__ __forceinline__ int32_t probe_row(
    const uint32_t* __restrict__ keys_lo, const uint32_t* __restrict__ keys_hi,
    const int32_t* __restrict__ rows, uint32_t size, uint32_t lo, uint32_t hi,
    int n_probe) {
  const uint32_t mask = size - 1u;
  uint32_t slot = mix32(lo ^ mix32(hi ^ kRouteGolden)) & mask;
  for (int i = 0; i < n_probe; ++i) {
    const uint32_t k_hi = keys_hi[slot];
    if (k_hi == hi && keys_lo[slot] == lo) return rows[slot];
    if (k_hi == kEmptyHi) return -1;
    slot = (slot + 1u) & mask;
  }
  return -1;
}

}  // namespace sde
