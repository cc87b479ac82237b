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
// outside. Here a persistent grid (2 blocks of 256 threads an SM) walks
// 128 x 64 output tiles in row-strip order, each block a contiguous range
// of tiles, and masks the ragged edge itself, so nothing is padded. A
// block stages its strip's 128 x_i rows (transposed, in chunks of 16 of K)
// and their sq once and keeps them across the strip's tiles where K <= 16;
// it stages each tile's 64 x_j rows, the first chunk of them read into
// registers while the tile before runs its products. Each thread owns
// 8 x 4 outputs (rows 8 ty .. 8 ty + 7, columns 4 tx .. 4 tx + 3: two
// 16-byte shared loads of x_i and one of x_j a k).
//
// Numbers. Every output sums its K products in one thread, k = 0 .. K-1,
// with fmaf on the CUDA cores: no tensor-core TF32, no split-K atomics, so
// two runs give the same bytes. sq_i is the same fmaf chain over x_i's own
// products, summed beside the products by the threads that load row i
// (tx == 0) or column i (ty == 0), so out[i, i] is 1 exactly and out is
// symmetric bit for bit. The epilogue rounds each step on its own,
// in the reference's order, and stores each element once. Offsets are
// 64-bit: N * N passes 2**31 at N >= 46,341; the grid has no tile limit.
//
// Bound on this card: memory, by the output's write. At N = 5,000 and
// K = 16 the output is 100 MB against 0.32 MB of input: 0.0299 ms at
// 3.35 TB/s, while 2 N^2 K = 0.8 GFLOP take 0.012 ms at 67 TFLOP/s fp32.
// The output does not fit in the 50 MB L2, so the card writes it at the
// HBM rate. What this design does about it: each finished tile goes to
// one of two 32 KB buffers in shared memory, and leaves it asynchronously,
// so that tile t's store drains while tile t + 1 is computed. Where the
// output's rows are 16-byte aligned (N % 4 == 0 and out 16-byte aligned),
// one thread issues the whole tile as one 2-D TMA store (a tensor map of
// out encoded on the host; the map clips the ragged edge), after a
// fence.proxy.async, and waits only for the reads of the store two tiles
// back (wait_group.read 1); one bulk copy a row instead (cp.async.bulk
// without a tensor map, 128 a tile) measured slower than the parent
// kernel (tools/dft_corr_probe.py, corr/bulk-rows). Otherwise each half-warp
// streams a row piece out with __stcs: a scalar head up to the first
// 16-byte boundary, float4 stores, a scalar tail. Both write full 32-byte
// sectors in order and keep the output out of the caches' way.
#include <cuda.h>                       // CUtensorMap and its enums only
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kTM = 128;              // output tile rows: a strip
constexpr int kTN = 64;               // output tile columns
constexpr int kThreads = 256;
constexpr int kTX = 16;               // threads along a row, 4 columns each
constexpr int kRows = 8;              // rows a thread owns
constexpr int kChunk = 16;            // K staged per pass
constexpr int kPitchI = kTM + 4;      // 16-byte rows, fewer bank conflicts
constexpr int kPitchJ = kTN + 4;
constexpr int kBlocksPerSM = 2;

struct Smem {
  float stage[2][kTM * kTN];          // finished tiles, row-major
  float xi[kChunk][kPitchI];          // x_i, transposed
  float xj[kChunk][kPitchJ];          // x_j, transposed
  float sqi[kTM];
  float sqj[kTN];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tile at ``src`` to out[row .. row + 127, col .. col + 63] through
// the tensor map: what lies past N is not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(col),
        "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most kPending of this thread's bulk groups still read shared
// memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Each half-warp stores row pieces of ``cols`` floats from the staged tile:
// scalars up to the first 16-byte boundary of the row piece, then float4,
// then a scalar tail; all streaming (__stcs).
__device__ __forceinline__ void stream_rows(float* out, const float* stage,
                                            long long N, long long i0,
                                            long long j0, int rows,
                                            int cols) {
  const int half = threadIdx.x >> 4;
  const int l = threadIdx.x & 15;
  for (int r = half; r < rows; r += kThreads / 16) {
    float* dst = out + (i0 + r) * N + j0;
    const float* src = stage + r * kTN;
    const int lead =
        (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
    const int h = lead < cols ? lead : cols;
    const int nv = (cols - h) >> 2;           // 16-byte stores
    if (l < h) __stcs(dst + l, src[l]);
    if (l < nv) {
      const int c = h + 4 * l;
      __stcs(reinterpret_cast<float4*>(dst + c),
             make_float4(src[c], src[c + 1], src[c + 2], src[c + 3]));
    }
    for (int c = h + 4 * nv + l; c < cols; c += 16) __stcs(dst + c, src[c]);
  }
}

// The [kSlab, kc] slab of x from row r0, chunk k0 (kc = min(16, K - k0)),
// into shared memory, transposed: consecutive threads read consecutive
// floats of it.
template <int kSlab, int kPitch>
__device__ __forceinline__ void stage_slab(float (*dst)[kPitch],
                                           const float* __restrict__ x,
                                           long long r0, long long N, int K,
                                           int k0, int kc) {
  for (int e = threadIdx.x; e < kSlab * kc; e += kThreads) {
    const int r = e / kc;
    const int kk = e - r * kc;
    dst[kk][r] = r0 + r < N ? x[(r0 + r) * K + k0 + kk] : 0.0f;
  }
}

constexpr int kPre = kTN * kChunk / kThreads;

// The first chunk of the x_j slab of the tile at column j0 into registers:
// element q at (row, k) = (at[q] & 0xff, at[q] >> 8), none where at[q] < 0.
__device__ __forceinline__ void prefetch(float (&pre)[kPre],
                                         const int (&at)[kPre],
                                         const float* __restrict__ x,
                                         long long j0, long long N, int K) {
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int r = at[q] & 0xff;
    pre[q] = at[q] >= 0 && j0 + r < N ? x[(j0 + r) * K + (at[q] >> 8)]
                                      : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
corr_kernel(const __grid_constant__ CUtensorMap tm_out,
            const float* __restrict__ x, float* __restrict__ out,
            long long N, int K, long long ctiles, long long total, bool tma) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const bool keep = K <= kChunk;      // the strip's x_i and sq_i stay
  const long long t_begin = total * blockIdx.x / gridDim.x;
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;
  long long si = t_begin / ctiles;    // the tile's strip and column tile
  long long cj = t_begin - si * ctiles;
  long long strip = -1;
  int buf = 0;

  // x_j's first chunk of the next tile, kPre floats a thread, read while
  // this tile's products run: element q is (row, k) = (e / kc0, e % kc0),
  // e = tid + kThreads q, packed as row | k << 8
  const int kc0 = min(kChunk, K);
  int at[kPre];
  float pre[kPre];
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int e = tid + kThreads * q;
    at[q] = e < kTN * kc0 ? (e / kc0) | (e % kc0) << 8 : -1;
  }
  prefetch(pre, at, x, cj * kTN, N, K);

  for (long long t = t_begin; t < t_end; ++t, buf ^= 1) {
    const long long i0 = si * kTM;
    const long long j0 = cj * kTN;
    const bool stage_i = !keep || si != strip;
    strip = si;
    if (++cj == ctiles) {             // the next tile
      cj = 0;
      ++si;
    }

    float acc[kRows][4] = {};
    // sq rides on the products, in their fmaf order: threads tx == 0 hold
    // every row's x_i (only where staged), threads ty == 0 every column's
    float sqa[kRows] = {};
    float sqb[4] = {};
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = min(kChunk, K - k0);
      if (k0 > 0) __syncthreads();    // the previous chunk is read
      if (stage_i) stage_slab<kTM, kPitchI>(sm.xi, x, i0, N, K, k0, kc);
      if (k0 == 0) {
#pragma unroll
        for (int q = 0; q < kPre; ++q)
          if (at[q] >= 0) sm.xj[at[q] >> 8][at[q] & 0xff] = pre[q];
      } else {
        stage_slab<kTN, kPitchJ>(sm.xj, x, j0, N, K, k0, kc);
      }
      __syncthreads();
      if (k0 + kChunk >= K && t + 1 < t_end)
        prefetch(pre, at, x, cj * kTN, N, K);
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        if (kk >= kc) break;
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sm.xi[kk][kRows * ty]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sm.xi[kk][kRows * ty + 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.xj[kk][4 * tx]);
        const float a[kRows] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
        if (stage_i && tx == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) sqa[r] = fmaf(a[r], a[r], sqa[r]);
        }
        if (ty == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) sqb[c] = fmaf(b[c], b[c], sqb[c]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    if (stage_i && tx == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) sm.sqi[kRows * ty + r] = sqa[r];
    }
    if (ty == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sm.sqj[4 * tx + c] = sqb[c];
    }
    // buffer ``buf`` last left two tiles ago: its store has read it
    if (tma && tid == 0) bulk_wait_read<1>();
    __syncthreads();

    float* stage = sm.stage[buf];
    const float4 sj = *reinterpret_cast<const float4*>(&sm.sqj[4 * tx]);
    const float sqj[4] = {sj.x, sj.y, sj.z, sj.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = kRows * ty + r;
      const float si_ = sm.sqi[i];
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float d = __fsub_rn(__fadd_rn(si_, sqj[c]),
                                  __fmul_rn(2.0f, acc[r][c]));
        v[c] = __fsub_rn(1.0f, d);
      }
      *reinterpret_cast<float4*>(&stage[i * kTN + 4 * tx]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    if (tma) fence_async_shared();    // the writes, seen by the TMA store
    __syncthreads();

    const int rows = (int)(N - i0 < kTM ? N - i0 : kTM);
    const int cols = (int)(N - j0 < kTN ? N - j0 : kTN);
    if (tma) {
      if (tid == 0) {
        tma_store(&tm_out, stage, (int)j0, (int)i0);
        bulk_commit();
      }
    } else {
      stream_rows(out, stage, N, i0, j0, rows, cols);
    }
  }
  if (tma && tid == 0) bulk_wait_all();
}

}  // namespace

extern "C" {

// x [N, K] f32 contiguous -> out [N, N] f32 contiguous (out 4-byte
// aligned; TMA stores where N % 4 == 0 and out is 16-byte aligned).
int pairwise_corr(const float* x, float* out, long long N, int K,
                  cudaStream_t stream) {
  if (N <= 0) return 0;
  const uintptr_t oaddr = reinterpret_cast<uintptr_t>(out);
  if (K < 0 || (oaddr & 3)) return (int)cudaErrorInvalidValue;
  const long long ctiles = (N + kTN - 1) / kTN;
  const long long total = (N + kTM - 1) / kTM * ctiles;
  const long long cap = (long long)sde::sm_count() * kBlocksPerSM;
  const long long blocks = total < cap ? total : cap;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // a TMA coordinate is a 32-bit int
  const bool tma = N % 4 == 0 && (oaddr & 15) == 0 && N < 0x7fffffffLL;
  CUtensorMap map = {};
  cudaError_t err;
  if (tma) {
    sde::EncodeTiled encode;
    if ((err = sde::encoder(&encode)) != cudaSuccess) return (int)err;
    // [N, N] f32, columns innermost; boxes of 64 columns x 128 rows
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 4};
    const cuuint32_t box[2] = {(cuuint32_t)kTN, (cuuint32_t)kTM};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(
      corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  corr_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      map, x, out, N, K, ctiles, total, tma);
  return (int)cudaGetLastError();
}

}  // extern "C"
