// Batched sliding-DFT tick (StatStream) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_dft.py, sliding_dft_step. One tick of
// S streams' first F DFT coefficients, in (re, im) planes:
//
//   X[s, f] <- (X[s, f] + delta[s]) * (tw_re[f] + i tw_im[f])  where
//   mask[s] > 0, else unchanged.
//
// The TPU kernel fuses the complex multiply and the mask into one pass
// over [512, F] VMEM tiles. Here one thread owns one (s, f) element and
// ticks it in place: it reads mask[s], and only where the row is masked in
// does it read re, im and delta and write the two results. Strides are
// arguments, so the engine passes the interleaved [S, F, 2] coefficient
// leaf's re and im planes (element stride 2): a thread reads and writes
// only its own element.
//
// Rounding. nvcc contracts a*b - c*d into a fused multiply-add by default,
// which rounds once where the plain version (and the reference) rounds
// twice. Every product, sum and difference is therefore written with an
// explicit round-to-nearest intrinsic, so the result equals the plain
// PyTorch version byte for byte.
//
// Bound on this card: memory. The mask of every row is read (4 bytes a
// row); a masked-in row's coefficients are read and written and its delta
// read, against 7 float operations per element. An ingest batch masks in
// only the streams it routes a tuple to, so the bytes follow the batch,
// not the stack: skipping unmasked rows is what this design does about it.
// A warp's 32 threads cover 32 neighbouring elements, so the interleaved
// re and im accesses of a warp fall on the same sectors.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tick_kernel(float* re, float* im, long long rs, long long cs,
            const float* __restrict__ delta, const float* __restrict__ mask,
            const float* __restrict__ tw_re, const float* __restrict__ tw_im,
            long long S, int F) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= S * F) return;
  const long long s = e / F;
  if (!(mask[s] > 0.0f)) return;       // the row keeps its coefficients
  const int f = (int)(e - s * F);
  float* p_re = re + s * rs + f * cs;
  float* p_im = im + s * rs + f * cs;
  const float x_im = *p_im;
  const float wr = tw_re[f];
  const float wi = tw_im[f];
  const float r = __fadd_rn(*p_re, delta[s]);
  *p_re = __fsub_rn(__fmul_rn(r, wr), __fmul_rn(x_im, wi));
  *p_im = __fadd_rn(__fmul_rn(r, wi), __fmul_rn(x_im, wr));
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
  const long long blocks = (S * F + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tick_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      re, im, rs, cs, delta, mask, tw_re, tw_im, S, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
