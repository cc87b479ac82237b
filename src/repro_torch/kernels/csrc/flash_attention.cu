// Streaming-softmax attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (:68;
// its body _kernel at :26). Over q [BH, Sq, D] and k, v [BH, Sk, D], all
// float32 or all bfloat16:
//
//   out = softmax(q k^T / sqrt(D) [causal: keys kpos > qpos get -1e30]) v
//
// with the output in q's dtype. The TPU kernel walks a sequential
// (BH, Sq/bq, Sk/bk) grid and carries the running max, the running
// denominator and a float32 accumulator in VMEM scratch from one key
// block to the next, over inputs padded to its blocks. Here one block owns
// one (bh, query tile) and a loop inside it walks the key tiles; the
// three carried values live in registers (bfloat16) or in registers and
// shared memory (float32), and scores never reach device memory. Keys past
// Sk and rows past Sq are masked in the kernel, so nothing is padded. With
// causal, key tiles wholly above the diagonal are skipped: in the
// reference such a tile adds exp(-1e30 - m) = 0, since every row's first
// key is unmasked. Query tiles run in reverse order, so the causal tiles
// with the most key tiles start first.
//
// Two kernels, one per dtype:
//   * bfloat16: 4 warps, 64 query rows (16 a warp), key tiles of 64 (32 at
//     D > 128) staged in shared memory by cp.async (the next K tile loads
//     during softmax and P.V, the next V tile during q.k^T). Scores and
//     P.V run on the tensor cores with mma.sync m16n8k16 (bf16 inputs,
//     float32 sums). P enters P.V as the sum of two bf16 parts (hi =
//     bf16(p), lo = bf16(p - hi)), two MMAs, so it keeps 16 significant
//     bits: one bf16 P (8 bits, as flash attention on GPUs takes it) puts
//     outputs up to two bf16 ulps off the reference's float32 p. The row
//     max, the denominator and the accumulator are float32. D is padded
//     in shared memory (zeros) to 64, 128 or 256.
//   * float32: 256 threads, 64 query rows, key tiles of 32, on the CUDA
//     cores with fmaf, every score and every output summed by one thread
//     in a fixed order (no TF32: the float32 result stays within 1e-5 of
//     the plain version, relative to its largest output).
// Each output element sums its terms in one thread (mma's own fixed
// order included) and each row's denominator in one fixed shuffle tree:
// no atomics and no split over keys, so two runs give the same bytes.
// Offsets are 64-bit: BH * S * D passes 2**31 at prefill lengths.
//
// Bound on this card: operations. For causal bf16 at Qwen2-72B's shape
// (BH = 64, S = 4096, D = 128) the work is 2 BH S^2 D = 0.275 TFLOP, 0.278
// ms at the 989 TFLOP/s bf16 tensor-core rate, against 268 MB of q, k, v
// and out, 0.080 ms at 3.35 TB/s. What this first design does about it:
// it keeps the products on the tensor cores, never writes scores, reads
// K and V once per 64 query rows (from L2 after the first head's tile),
// and skips the masked half of the causal work. The two-part P costs half
// again the MMAs of the function (P.V runs twice). It leaves for later:
// wgmma and TMA (mma.sync reaches a fraction of the wgmma rate), warp
// specialisation, a deeper K/V pipeline, Q held in registers (it is read
// from shared memory at every key tile), and a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;          // the reference's masked score

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor cores
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kBq = 16 * kWarps;        // query rows a block
constexpr int kMmaThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ``bytes`` = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 inputs, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as a pair of bf16 pairs, hi + lo, whose sum carries 16 of
// float32's 24 significant bits: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// rows [row0, row0 + R) of a [*, D] bf16 matrix into shared [R][DP + 8];
// rows at or past ``limit`` and columns at or past D are zeros
template <int R, int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          long long row0, long long limit,
                                          int D) {
  constexpr int kChunks = DP / 8;       // 16-byte chunks a row
  for (int e = threadIdx.x; e < R * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int col = (e - r * kChunks) * 8;
    const bool ok = row0 + r < limit && col < D;
    cp_async16(s + r * (DP + 8) + col, ok ? g + (row0 + r) * D + col : g,
               ok ? 16 : 0);
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kMmaThreads)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, long long Sq, long long Sk,
                 int D, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = DP + 8;            // 16 bytes of padding a row: the 8
                                        // rows of an ldmatrix hit 8 banks
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBq * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const long long bh = blockIdx.x;
  const long long q0 = (long long)(gridDim.y - 1 - blockIdx.y) * kBq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;               // fragment row
  const int c = lane % 4;               // fragment column pair
  const __nv_bfloat16* qh = q + bh * Sq * D;
  const __nv_bfloat16* kh = k + bh * Sk * D;
  const __nv_bfloat16* vh = v + bh * Sk * D;
  const long long kend = causal ? min(Sk, q0 + kBq) : Sk;
  const int n_kt = (int)((kend + BK - 1) / BK);
  const long long qw = q0 + warp * 16;  // the warp's first row
  const long long row_a = qw + g;       // this thread's two rows
  const long long row_b = row_a + 8;

  load_tile<kBq, DP>(Qs, qh, q0, Sq, D);
  load_tile<BK, DP>(Ks, kh, 0, Sk, D);
  cp_async_commit();
  load_tile<BK, DP>(Vs, vh, 0, Sk, D);
  cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float m[2] = {kNeg, kNeg};            // running max, log2 units
  float l[2] = {0.0f, 0.0f};            // this thread's share of the
                                        // running denominator
  for (int kt = 0; kt < n_kt; ++kt) {
    const long long k0 = (long long)kt * BK;
    cp_async_wait<1>();                 // Q and this K tile are in
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    cp_async_wait<0>();                 // this V tile is in, and every
    __syncthreads();                    // warp is done with Ks
    if (kt + 1 < n_kt) {
      load_tile<BK, DP>(Ks, kh, k0 + BK, Sk, D);
      cp_async_commit();
    }

    // scale to log2 units; mask keys past Sk and, causal, past the row
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[nt][e] * scale_log2;
        if (edge) {
          const long long key = k0 + nt * 8 + 2 * c + (e & 1);
          const long long row = e < 2 ? row_a : row_b;
          if (key >= Sk || (causal && key > row)) t = kNeg;
        }
        s[nt][e] = t;
      }

    // online softmax: the quad of threads holding a row shares its max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // acc += P V: the score fragments of two key groups of 8 are the A
    // fragment of one 16-key step. P goes in as hi + lo, two bf16 MMAs,
    // so it keeps 16 significant bits where one bf16 would keep 8: the
    // reference multiplies a float32 p by v cast to float32
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (j * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], hi, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }

    __syncthreads();                    // every warp is done with Vs
    if (kt + 1 < n_kt) {
      load_tile<BK, DP>(Vs, vh, k0 + BK, Sk, D);
      cp_async_commit();
    }
  }

  // the row's denominator over its quad, in one fixed tree; divide, store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* oh = out + bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int col = dt * 8 + 2 * c;
    if (col >= D) continue;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row_a * D + col) =
          __floats2bfloat162_rn(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row_b * D + col) =
          __floats2bfloat162_rn(acc[dt][2] / l[1], acc[dt][3] / l[1]);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFThreads = 256;
constexpr int kFBq = 64;                // query rows a block
constexpr int kFBk = 32;                // keys a tile

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)kFBq * (DP + 1) + (size_t)kFBk * (DP + 1) +
                          (size_t)kFBk * DP + (size_t)kFBq * (kFBk + 1) +
                          3 * kFBq);
}

template <int DP>
__global__ void __launch_bounds__(kFThreads)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                long long Sq, long long Sk, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LQ = DP + 1;            // odd row strides: no bank conflicts
  constexpr int LS = kFBk + 1;
  float* Qs = reinterpret_cast<float*>(smem);   // [kFBq][LQ]
  float* Ks = Qs + kFBq * LQ;                   // [kFBk][LQ]
  float* Vs = Ks + kFBk * LQ;                   // [kFBk][DP]
  float* Ss = Vs + kFBk * DP;                   // [kFBq][LS]: scores, then p
  float* m_s = Ss + kFBq * LS;                  // running max
  float* l_s = m_s + kFBq;                      // running denominator
  float* c_s = l_s + kFBq;                      // this tile's correction

  const int tid = threadIdx.x;
  const int tx = tid % 16;              // keys tx + 16 j; columns tx + 16 j
  const int ty = tid / 16;              // rows ty + 16 i
  const long long bh = blockIdx.x;
  const long long q0 = (long long)(gridDim.y - 1 - blockIdx.y) * kFBq;
  const float* qh = q + bh * Sq * D;
  const float* kh = k + bh * Sk * D;
  const float* vh = v + bh * Sk * D;
  const long long kend = causal ? min(Sk, q0 + kFBq) : Sk;
  const int n_kt = (int)((kend + kFBk - 1) / kFBk);

  for (int e = tid; e < kFBq * DP; e += kFThreads) {
    const int r = e / DP;
    const int col = e - r * DP;
    Qs[r * LQ + col] =
        q0 + r < Sq && col < D ? qh[(q0 + r) * D + col] : 0.0f;
  }
  if (tid < kFBq) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }
  float acc[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const long long k0 = (long long)kt * kFBk;
    __syncthreads();                    // the last tile's P.V is done
    for (int e = tid; e < kFBk * DP; e += kFThreads) {
      const int r = e / DP;
      const int col = e - r * DP;
      const bool ok = k0 + r < Sk && col < D;
      Ks[r * LQ + col] = ok ? kh[(k0 + r) * D + col] : 0.0f;
      Vs[r * DP + col] = ok ? vh[(k0 + r) * D + col] : 0.0f;
    }
    __syncthreads();

    float sc[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = Ks[(tx + 16 * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long row = q0 + ty + 16 * i;
        const long long key = k0 + tx + 16 * j;
        const bool masked = key >= Sk || (causal && key > row);
        Ss[(ty + 16 * i) * LS + tx + 16 * j] =
            masked ? kNeg : sc[i][j] * scale;
      }
    __syncthreads();

    {  // four neighbouring threads a row, 8 keys each
      const int r = tid / 4;
      float* srow = Ss + r * LS + (tid % 4) * 8;
      const float m_prev = m_s[r];
      const float l_prev = l_s[r];
      float mx = srow[0];
#pragma unroll
      for (int e = 1; e < 8; ++e) mx = fmaxf(mx, srow[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = expf(srow[e] - m_new);
        srow[e] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();                     // the quad has read m_s, l_s
      if (tid % 4 == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_prev * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kFBk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        const float vv = Vs[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  float* oh = out + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l_s[ty + 16 * i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int col = tx + 16 * j;
      if (col < D) oh[row * D + col] = acc[i][j] / den;
    }
  }
}

template <int DP, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, long long BH, long long Sq, long long Sk,
                        int D, int causal, cudaStream_t stream) {
  constexpr int smem = (kBq + 2 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  auto kern = attn_bf16_kernel<DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)BH, (unsigned)((Sq + kBq - 1) / kBq));
  const float scale_log2 = (float)(1.4426950408889634 / std::sqrt((double)D));
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, D, causal, scale_log2);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       long long BH, long long Sq, long long Sk, int D,
                       int causal, cudaStream_t stream) {
  constexpr int smem = (int)f32_smem_bytes<DP>();
  auto kern = attn_f32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)BH, (unsigned)((Sq + kFBq - 1) / kFBq));
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kern<<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, D,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [BH, Sq, D], k/v [BH, Sk, D] contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1) -> out [BH, Sq, D] in the same dtype. D is a
// multiple of 16 from 16 to 256; BH, Sq, Sk >= 1.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    long long BH, long long Sq, long long Sk, int D,
                    int causal, int bf16, cudaStream_t stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || D < 16 || D > 256 || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH > 0x7fffffffLL || (Sq + 63) / 64 > 65535)   // gridDim.x, .y
    return (int)cudaErrorInvalidValue;
  causal = causal != 0;
  cudaError_t err;
  if (bf16) {
    if (D <= 64)
      err = launch_bf16<64, 64>(q, k, v, out, BH, Sq, Sk, D, causal, stream);
    else if (D <= 128)
      err = launch_bf16<128, 64>(q, k, v, out, BH, Sq, Sk, D, causal, stream);
    else
      err = launch_bf16<256, 32>(q, k, v, out, BH, Sq, Sk, D, causal, stream);
  } else {
    if (D <= 64)
      err = launch_f32<64>(q, k, v, out, BH, Sq, Sk, D, causal, stream);
    else if (D <= 128)
      err = launch_f32<128>(q, k, v, out, BH, Sq, Sk, D, causal, stream);
    else
      err = launch_f32<256>(q, k, v, out, BH, Sq, Sk, D, causal, stream);
  }
  return (int)err;
}

}  // extern "C"
