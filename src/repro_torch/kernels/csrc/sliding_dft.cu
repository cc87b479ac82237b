// Batched sliding-DFT tick (StatStream) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_dft.py, sliding_dft_step. One tick of
// S streams' first F DFT coefficients, in (re, im) planes:
//
//   X[s, f] <- (X[s, f] + delta[s]) * (tw_re[f] + i tw_im[f])  where
//   mask[s] > 0, else unchanged.
//
// The TPU kernel fuses the complex multiply and the mask into one pass
// over [512, F] VMEM tiles. An ingest batch masks in only the streams it
// routes a tuple to (8% of 131,072 rows on the main path, ~1% of 2**20),
// so here the walk is over rows, not elements. A warp takes 128
// consecutive rows at a time: each lane reads the masks of 4 of them with
// one aligned 16-byte load (scalar loads at an unaligned head and tail,
// since the mask may be a view), the warp votes (`__ballot_sync`) on the
// rows masked in and lists them in shared memory, and the block's 8 warps
// tick only the rows of the block's list, together: F lanes a row (32 / F
// rows a warp a step; F > 32: one row a warp, the lanes looping over f),
// with the loads of 8 steps in flight at once, while the masks of the
// block's next 8 groups are read. The row's first lane loads delta[s]
// once and shuffles it to the others, after their element loads are
// issued; each lane reads its twiddle once.
// Strides are arguments, so the engine passes the interleaved [S, F, 2]
// coefficient leaf's re and im planes (im = re + 1, element stride 2):
// that case loads and stores each (re, im) pair as one float2, and 8
// lanes of a row cover its 64 bytes; other shared strides take the same
// walk with scalar accesses. Row and group indices are 32-bit
// (S < 2**31 - 128), address offsets 64-bit. The grid is persistent: at
// most 3 blocks of 8 warps an SM, walking the 128-row groups in steps of
// the grid, warp-major, so that the dense run of rows at the head of a
// skewed batch spreads over the SMs and over the warps of each block; one
// block serves the engine's 64-row continuous-DFT stack.
//
// Rounding. nvcc contracts a*b - c*d into a fused multiply-add by default,
// which rounds once where the plain version (and the reference) rounds
// twice. Every product, sum and difference is therefore written with an
// explicit round-to-nearest intrinsic, so the result equals the plain
// PyTorch version byte for byte.
//
// Bound on this card: memory. The mask of every row is read (4 bytes a
// row); a masked-in row's coefficients are read and written and its delta
// read, against 7 float operations per element. Reading the masks alone
// is the floor a tick cannot go under; the design spends one 16-byte load
// and four votes a lane on each 128 rows, and lanes only on the rows that
// the batch masks in.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 3;       // 768 threads an SM, <= 80 registers
constexpr int kGroup = 128;           // rows a warp votes on at a time
constexpr int kSteps = 8;             // steps of rows whose loads fly at once
constexpr unsigned kFull = 0xffffffffu;

// x <- (x + d) * (wr + i wi), each step rounded on its own.
__device__ __forceinline__ float2 ticked(float2 x, float d, float wr,
                                         float wi) {
  const float r = __fadd_rn(x.x, d);
  return make_float2(__fsub_rn(__fmul_rn(r, wr), __fmul_rn(x.y, wi)),
                     __fadd_rn(__fmul_rn(r, wi), __fmul_rn(x.y, wr)));
}

// kPair: re and im are one float2 (im == re + 1, 8-byte aligned).
template <bool kPair>
__device__ __forceinline__ float2 load(const float* re, const float* im,
                                       long long o) {
  if (kPair) return *reinterpret_cast<const float2*>(re + o);
  return make_float2(re[o], im[o]);
}

template <bool kPair>
__device__ __forceinline__ void store(float* re, float* im, long long o,
                                      float2 v) {
  if (kPair) {
    *reinterpret_cast<float2*>(re + o) = v;
  } else {
    re[o] = v.x;
    im[o] = v.y;
  }
}

// The masks of this lane's 4 rows of group g (0 past the last row): one
// 16-byte load where all 4 are rows, scalar loads at the head and tail.
__device__ __forceinline__ void load_masks(float (&m)[4], const float* base,
                                           int g, int lane, int off, int S) {
  const int v0 = g * kGroup + 4 * lane;
  if (v0 >= off && v0 + 4 <= off + S) {
    const float4 q = *reinterpret_cast<const float4*>(base + v0);
    m[0] = q.x;
    m[1] = q.y;
    m[2] = q.z;
    m[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m[j] = (v0 + j >= off && v0 + j < off + S) ? base[v0 + j] : 0.0f;
  }
}

// Rows are counted from ``base`` = mask - off, the 16-byte boundary at or
// before the mask: row s is virtual row s + off, and group g covers
// virtual rows [128 g, 128 g + 128). Groups go to warps warp-major (warp w
// of block b takes groups b + gridDim.x (w + 8 i)), so that each block's 8
// groups lie far apart; their rows masked in go to one list that the
// block's warps walk together: the dense groups at the head of a skewed
// batch share their rows with the sparse ones'.
template <bool kPair>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
tick_kernel(float* re, float* im, long long rs, long long cs,
            const float* __restrict__ delta, const float* __restrict__ mask,
            const float* __restrict__ tw_re, const float* __restrict__ tw_im,
            int S, int F, int off, int groups) {
  __shared__ int list_s[kWarps * kGroup];       // the block's rows masked in
  __shared__ int count_s[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* base = mask - off;
  const bool narrow = F <= 32;
  const int per = narrow ? 32 / F : 1;          // a warp's rows a step
  const int slot = narrow ? lane / F : 0;       // this lane's row of them
  const int f0 = narrow ? lane - slot * F : lane;
  const int first = narrow ? slot * F : 0;      // the row's first lane
  const bool active = slot < per;
  float wr = 0.0f, wi = 0.0f;
  if (narrow && active) {
    wr = tw_re[f0];
    wi = tw_im[f0];
  }
  const long long fo = (long long)f0 * cs;
  const unsigned below = (1u << lane) - 1u;
  const int stride = gridDim.x * kWarps;        // groups a block-step

  float m[4];
  load_masks(m, base, blockIdx.x + gridDim.x * warp, lane, off, S);
  for (int g0 = blockIdx.x; g0 < groups; g0 += stride) {
    const int g = g0 + gridDim.x * warp;
    const int v0 = g * kGroup + 4 * lane;
    unsigned b[4];
    int total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = __ballot_sync(kFull, m[j] > 0.0f);
      total += __popc(b[j]);
    }
    if (lane == 0) count_s[warp] = total;
    __syncthreads();
    // the next groups' masks fly while this step walks
    load_masks(m, base, g + stride, lane, off, S);
    int at = 0, n = 0;                          // this warp's list starts at
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = count_s[w];
      at += w < warp ? c : 0;
      n += c;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((b[j] >> lane) & 1u)
        list_s[at + __popc(b[j] & below)] = v0 + j - off;
      at += __popc(b[j]);
    }
    __syncthreads();
    if (narrow) {
      // each warp takes ``per`` rows of a block-step of kWarps * per;
      // kSteps block-steps at a time, every element and delta load of them
      // issued before the first shuffle waits on one
      for (int i = 0; i < n; i += kSteps * kWarps * per) {
        bool on[kSteps];
        int s[kSteps];
        float d[kSteps];
        float2 x[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int k = i + (u * kWarps + warp) * per + slot;
          on[u] = active && k < n;
          s[u] = on[u] ? list_s[k] : 0;
          x[u] = on[u] ? load<kPair>(re, im, (long long)s[u] * rs + fo)
                       : make_float2(0.0f, 0.0f);
          d[u] = on[u] && f0 == 0 ? delta[s[u]] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const float du = __shfl_sync(kFull, d[u], first);
          if (on[u])
            store<kPair>(re, im, (long long)s[u] * rs + fo,
                         ticked(x[u], du, wr, wi));
        }
      }
    } else {
      // F > 32: a row a warp, the lanes looping over f
      for (int k = warp; k < n; k += kWarps) {
        const int s = list_s[k];
        const float d = __shfl_sync(kFull, lane == 0 ? delta[s] : 0.0f, 0);
        const long long row = (long long)s * rs;
        for (int f = lane; f < F; f += 32) {
          const long long o = row + (long long)f * cs;
          store<kPair>(re, im, o,
                       ticked(load<kPair>(re, im, o), d, tw_re[f], tw_im[f]));
        }
      }
    }
    __syncthreads();                            // the lists are read
  }
}

}  // namespace

extern "C" {

// In place: re / im [S, F] f32 at row / element strides rs / cs (in
// floats), shared by both planes; delta / mask [S] f32; tw_re / tw_im [F]
// f32.
int dft_tick(float* re, float* im, long long rs, long long cs,
             const float* delta, const float* mask, const float* tw_re,
             const float* tw_im, long long S, int F, cudaStream_t stream) {
  if (S <= 0 || F <= 0) return 0;
  const uintptr_t maddr = reinterpret_cast<uintptr_t>(mask);
  if (S > 0x7fffffffLL - kGroup || (maddr & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int off = (int)((maddr & 15) / 4);
  const int groups = (int)((S + off + kGroup - 1) / kGroup);
  const int need = (groups + kWarps - 1) / kWarps;
  const int cap = sde::sm_count() * kBlocksPerSM;   // persistent grid
  const int blocks = need < cap ? need : cap;
  const bool pair = im == re + 1 && cs == 2 && rs % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(re) & 7) == 0;
  if (pair) {
    tick_kernel<true><<<blocks, kThreads, 0, stream>>>(
        re, im, rs, cs, delta, mask, tw_re, tw_im, (int)S, F, off, groups);
  } else {
    tick_kernel<false><<<blocks, kThreads, 0, stream>>>(
        re, im, rs, cs, delta, mask, tw_re, tw_im, (int)S, F, off, groups);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
