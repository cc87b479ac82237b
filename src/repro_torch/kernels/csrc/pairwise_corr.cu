// All-pairs correlation estimates (the StatStream correlation step) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pairwise_corr.py, pairwise_corr. Over the
// flattened normalized DFT coefficients x [N, K] f32:
//
//   out[i, j] = 1 - (sq_i + sq_j - 2 <x_i, x_j>),  sq_i = <x_i, x_i>
//
// The TPU kernel runs the Gram <x_i, x_j> as one MXU product per
// 256 x 256 VMEM block, with K padded to the 128 lanes and sq computed
// outside. Here one block of 256 threads owns one 64 x 64 output tile and
// masks its own ragged edge, so nothing is padded. It stages the tile's 64
// x_i rows and 64 x_j rows in shared memory over K in chunks of 32
// (transposed, one padding column against bank conflicts); each thread
// owns 4 x 4 outputs, at rows ty + 16 r and columns tx + 16 c, so that 16
// neighbouring threads store 16 neighbouring floats of one row.
//
// Numbers. Every output sums its K products in one thread, k = 0 .. K-1,
// with fmaf on the CUDA cores: no tensor-core TF32, no split-K atomics, so
// two runs give the same bytes. sq is fused: each thread sums the squares
// of its rows and columns in the same loop, with the same fmaf, so out[i,
// i] is 1 exactly and out is symmetric bit for bit. The epilogue rounds
// each step on its own, in the reference's order, and stores each element
// once. Offsets are 64-bit: N * N passes 2**31 at N >= 46,341.
//
// Bound on this card: memory, by the output's write. At N = 5,000 and
// K = 16 the output is 100 MB against 0.32 MB of input: 0.0299 ms at
// 3.35 TB/s, while 2 N^2 K = 0.8 GFLOP take 0.012 ms at 67 TFLOP/s fp32.
// The output does not fit in the 50 MB L2, so the card writes it at the
// HBM rate. What this design does about it: it writes every element once,
// with the epilogue fused, and reads the input from L2 (8 KB a block for
// 16 KB of output at K = 16). Coalesced 16-byte stores, a persistent grid
// and the row norms kept across tiles are left to later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;             // output tile: kTile x kTile
constexpr int kSide = 16;             // threads along each side of a tile
constexpr int kThreads = kSide * kSide;
constexpr int kPer = kTile / kSide;   // outputs a thread owns, each way
constexpr int kChunk = 32;            // K staged per pass

__global__ void __launch_bounds__(kThreads)
corr_kernel(const float* __restrict__ x, float* __restrict__ out,
            long long N, int K) {
  __shared__ float xi_s[kChunk][kTile + 1];
  __shared__ float xj_s[kChunk][kTile + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const long long i0 = (long long)blockIdx.y * kTile;
  const long long j0 = (long long)blockIdx.x * kTile;

  float acc[kPer][kPer] = {};
  float sqa[kPer] = {};
  float sqb[kPer] = {};
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    // consecutive threads read consecutive floats of the [rows, kc] slab
    for (int e = tid; e < kTile * kc; e += kThreads) {
      const int r = e / kc;
      const int kk = e - r * kc;
      const long long gi = i0 + r;
      const long long gj = j0 + r;
      xi_s[kk][r] = gi < N ? x[gi * K + k0 + kk] : 0.0f;
      xj_s[kk][r] = gj < N ? x[gj * K + k0 + kk] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) a[r] = xi_s[kk][ty + kSide * r];
#pragma unroll
      for (int c = 0; c < kPer; ++c) b[c] = xj_s[kk][tx + kSide * c];
#pragma unroll
      for (int r = 0; r < kPer; ++r) sqa[r] = fmaf(a[r], a[r], sqa[r]);
#pragma unroll
      for (int c = 0; c < kPer; ++c) sqb[c] = fmaf(b[c], b[c], sqb[c]);
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long i = i0 + ty + kSide * r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const long long j = j0 + tx + kSide * c;
      if (j >= N) continue;
      const float d = __fsub_rn(__fadd_rn(sqa[r], sqb[c]),
                                __fmul_rn(2.0f, acc[r][c]));
      out[i * N + j] = __fsub_rn(1.0f, d);
    }
  }
}

}  // namespace

extern "C" {

// x [N, K] f32 contiguous -> out [N, N] f32 contiguous.
int pairwise_corr(const float* x, float* out, long long N, int K,
                  cudaStream_t stream) {
  if (N <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (N + kTile - 1) / kTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;   // gridDim.y
  const dim3 grid((unsigned)tiles, (unsigned)tiles);
  corr_kernel<<<grid, kThreads, 0, stream>>>(x, out, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
