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
// key is unmasked.
//
// Two kernels, one per dtype:
//   * bfloat16 (attn_bf16_kernel): a warp-specialised block of 384
//     threads owns a 128-row query tile. Warpgroup 0 is the producer: it
//     gives up registers (setmaxnreg 40) and one thread issues every TMA
//     load. Warpgroups 1 and 2 are the consumers (setmaxnreg 232), 64
//     query rows each. The Q tile is loaded once; K and V tiles pass
//     through a ring of NS stages in shared memory, each with a full and
//     an empty mbarrier for K and for V, so the next tiles land while the
//     consumers use the current ones, and a consumer releases K as soon
//     as its scores are in registers. The tensor maps are 3-D, [BH, S,
//     D], with 128-byte swizzle: a box is 64 columns (one 128-byte row)
//     by the tile's rows by one head, so a tile of DP columns is DP / 64
//     boxes, and TMA's zero fill supplies the columns past D and the rows
//     past Sq or Sk of this head (a 2-D map over [BH S, D] would read the
//     next head's rows at a ragged S). Both products run on wgmma with
//     float32 accumulators in registers: S = Q K^T with Q and K read from
//     shared memory by descriptor (both K-major), and O += P V with P in
//     registers and V from shared memory through the descriptor's
//     transpose bit. P enters P.V as two bf16 parts, two wgmmas on the
//     same V tile: hi = p with its low 16 bits cleared, lo = bf16(p - hi)
//     (p - hi is exact in float32), so the pair keeps 16 of p's 24
//     significant bits (relative error under 2**-16); one bf16 P (8 bits)
//     puts outputs up to two bf16 ulps off the reference's float32 p. The
//     softmax runs in the wgmma accumulator layout: raw float32 scores,
//     masked only on tiles that cross Sk or the causal diagonal, the
//     running max and the denominator in float32, exp2 of the score
//     scaled to log2 units by one fma. Key-tile widths and ring depths
//     (shared memory per block): D <= 64: 128 keys, 4 stages (145 KiB);
//     D <= 128: 128 keys, 2 stages (161 KiB); D <= 256: 64 keys, 2 stages
//     (193 KiB); one block per SM. Inside a consumer, tile kt's Q K^T
//     and tile kt - 1's P V go out together as two wgmma groups: the
//     softmax of tile kt runs once Q K^T is done, while P V is still on
//     the tensor cores, and the accumulator is rescaled after P V has
//     read it (FA3's intra-warpgroup overlap). At D <= 128 the two
//     consumers also take turns at issuing their groups, through named
//     barriers (FA3's ping-pong), so one's softmax runs under the other's
//     products; at D = 256 the turn bookkeeping spills registers and
//     measured slower, so there the consumers issue as they are ready.
//     Grid: one block per (head, query tile), in groups of 8 heads;
//     within a group the query tiles run in reverse, so the causal tiles
//     with the most key tiles start first, and the 8 heads' K and V
//     (16 MiB at S = 4096, D = 128) stay in L2 while all their query
//     tiles walk them. No persistent grid: the C interface gives no
//     scratch for a tile counter, so a persistent grid would schedule
//     statically, and causal tiles of unequal length then leave SMs idle
//     at the end unless query tiles i and n_qt - 1 - i are paired (their
//     key-tile counts sum to a constant); the block scheduler already
//     hands out tiles longest first. Left for later: that paired
//     persistent grid, O stored through shared memory by TMA, and P.V
//     with a single fp16 P (it needs V scaled into fp16's range).
//   * float32: 256 threads, 64 query rows, key tiles of 32, on the CUDA
//     cores with fmaf, every score and every output summed by one thread
//     in a fixed order (no TF32: the float32 result stays within 1e-5 of
//     the plain version, relative to its largest output).
// Each output element sums its terms in one thread (wgmma's own fixed
// order included) and each row's denominator in one fixed shuffle tree:
// no atomics and no split over keys, so two runs give the same bytes.
// Offsets are 64-bit: BH * S * D passes 2**31 at prefill lengths.
//
// Bound on this card: operations. For causal bf16 at Qwen2-72B's shape
// (BH = 64, S = 4096, D = 128) the work is 2 BH S^2 D = 0.275 TFLOP, 0.278
// ms at the 989 TFLOP/s bf16 tensor-core rate, against 268 MB of q, k, v
// and out, 0.080 ms at 3.35 TB/s. The two-part P makes P.V run twice, so
// this design's own tensor-core floor is 6 D operations a kept pair,
// 0.417 ms. The tensor maps are encoded on the host at every call, with
// cuTensorMapEncodeTiled found through cudaGetDriverEntryPoint
// (launch.cuh), so the library links against the CUDA runtime alone.
#include <cuda.h>                       // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr float kNeg = -1e30f;          // the reference's masked score

// ---------------------------------------------------------------------------
// bfloat16: TMA, mbarriers, wgmma; one producer and two consumer warpgroups
// ---------------------------------------------------------------------------
constexpr int kBq = 128;                // query rows a block, 64 a consumer
constexpr int kThreads = 384;           // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumerThreads = 256;
constexpr int kBox = 64;                // bf16 columns a box: 128 bytes
constexpr int kRowBytes = 2 * kBox;     // a swizzled row of a column block
constexpr int kHeadGroup = 8;           // heads whose query tiles run together
// the consumers take turns at issuing wgmmas (FA3's ping-pong) at D <= 128;
// at D = 256 the turn bookkeeping costs spills and the turns cost time
template <int DP>
constexpr bool kPingPong = DP <= 128;
constexpr int kProducerRegs = 40;       // 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;

// Shared memory of one block: the Q tile, NS K tiles, NS V tiles, then the
// mbarriers (Q; full and empty for each K and V stage). A tile of R rows
// is DP / 64 column blocks of R x 128 bytes, each as TMA writes it with
// the 128-byte swizzle, which repeats every 1024 bytes: tiles start on a
// 1024-byte boundary (the slack in kSmem rounds the base up).
template <int DP, int BK, int NS>
struct Plan {
  static constexpr int kQBytes = kBq * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;
  static constexpr int kBarOffset = kQBytes + 2 * NS * kKVBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 4 * NS);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count));
}

// arrive once and expect ``bytes`` of TMA transfers in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// one box of a 3-D tensor map (column, row, head) into shared memory,
// reported to ``bar`` as transferred bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(row), "r"(head)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barriers 1 and 2: the consumers take turns at issuing wgmmas
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// registers a wgmma wrote: no read of them moves above the wait
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a 128-byte-swizzled tile in shared memory: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (128-byte swizzle) in bits 62-63. K-major operands (Q, K): rows of 128
// bytes, 8-row groups 1024 bytes apart (the stride offset), the leading
// offset unused. MN-major (V): 8-key groups 1024 bytes apart (stride),
// 64-column blocks ``lbo`` bytes apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory by
// descriptor, both K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory by
// descriptor, both K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the m16n8k16
// A fragment of each warp's 16 rows), B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the m16n8k16
// A fragment of each warp's 16 rows), B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S[64 x BK] = Q[64 x 16] K^T[16 x BK] (scale_d 1: +=)
template <int BK>
__device__ __forceinline__ void qk_mma(float* s, uint64_t dq, uint64_t dk,
                                       int scale_d) {
  if constexpr (BK == 128)
    wgmma_ss_n128(s, dq, dk, scale_d);
  else
    wgmma_ss_n64(s, dq, dk, scale_d);
}

// O[64 x DP] += P[64 x 16] V[16 x DP] for the 16 keys whose V rows start at
// ``v`` (column blocks BK x 128 bytes apart); D = 256 as two halves
template <int DP, int BK>
__device__ __forceinline__ void pv_mma(float* o, const uint32_t* p,
                                       uint32_t v) {
  constexpr uint32_t kLbo = BK * kRowBytes;
  if constexpr (DP == 64) {
    wgmma_rs_n64(o, p, sw128_desc(v, kLbo));
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(o, p, sw128_desc(v, kLbo));
  } else {
    wgmma_rs_n128(o, p, sw128_desc(v, kLbo));
    wgmma_rs_n128(o + 64, p, sw128_desc(v + 2 * kLbo, kLbo));
  }
}

// issue S = Q K^T for one key tile as one wgmma group: DP / 16 steps of 16
// columns (32 bytes within a swizzled row; a new column block every 4)
template <int DP, int BK>
__device__ __forceinline__ void qk_issue(float* s, uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    qk_mma<BK>(s,
               sw128_desc(q + (ks / 4) * kBq * kRowBytes + (ks % 4) * 32, 16),
               sw128_desc(k + (ks / 4) * BK * kRowBytes + (ks % 4) * 32, 16),
               ks > 0);
  wgmma_commit();
}

// issue O += P V for one key tile as one wgmma group, P as hi + lo: two
// wgmmas on each 16-key step (2048 bytes of V)
template <int DP, int BK>
__device__ __forceinline__ void pv_issue(float* o, uint32_t (*p_hi)[4],
                                         uint32_t (*p_lo)[4], uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    pv_mma<DP, BK>(o, p_hi[t], v + t * 16 * kRowBytes);
    pv_mma<DP, BK>(o, p_lo[t], v + t * 16 * kRowBytes);
  }
  wgmma_commit();
}

// One key tile of the online softmax, in place on the raw scores ``s``:
// mask keys past Sk and, causal, past the row (only on a tile that crosses
// either); the quad of threads holding a row shares its max; p = exp2 of
// the score minus the max in log2 units; the running max ``m`` and this
// thread's share ``l`` of the denominator move on, and ``corr`` is what
// the accumulator must be multiplied by.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int Sk, int causal,
                                             int row_w, int g, int c,
                                             float scale_log2) {
  if (k0 + BK > Sk || (causal && k0 + BK - 1 > row_w)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * c + (i & 1);
      const int row = row_w + g + (i & 2 ? 8 : 0);
      if (key >= Sk || (causal && key > row)) s[i] = kNeg;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = ex2((m[h] - mx[h]) * scale_log2);
    m[h] = mx[h];
    mb[h] = mx[h] * scale_log2;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -mb[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

// Scores to P.V's A operand. A 64 x N wgmma accumulator holds, in thread
// (warp w, lane = 4 g + c), rows 16 w + g and 16 w + g + 8 at columns
// 8 j + 2 c and 8 j + 2 c + 1: d[4 j + 0, 1] on the first row, d[4 j + 2,
// 3] on the second. The register A fragment of a 16-key step t wants, per
// thread, (row g, keys 16 t + 2 c, +1), (row g + 8, the same keys), (row g,
// keys 16 t + 8 + 2 c, +1), (row g + 8, the same): accumulator entries
// 8 t .. 8 t + 7 in order, two to a register. So no data moves between
// threads: entries 8 t + 2 e, 8 t + 2 e + 1 make register e, as the hi part
// (the top 16 bits of each float, lower column in the low half) and the lo
// part (bf16 of the exact float32 remainder).
template <int BK>
__device__ __forceinline__ void p_fragments(const float* s,
                                            uint32_t (*hi)[4],
                                            uint32_t (*lo)[4]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = s[8 * t + 2 * e];
      const float x1 = s[8 * t + 2 * e + 1];
      const uint32_t u0 = __float_as_uint(x0);
      const uint32_t u1 = __float_as_uint(x1);
      hi[t][e] = __byte_perm(u0, u1, 0x7632);
      const __nv_bfloat162 r = __floats2bfloat162_rn(
          x0 - __uint_as_float(u0 & 0xffff0000u),
          x1 - __uint_as_float(u1 & 0xffff0000u));
      lo[t][e] = *reinterpret_cast<const uint32_t*>(&r);
    }
}

template <int DP, int BK, int NS>
__global__ void __launch_bounds__(kThreads, 1)
attn_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, int BH, int Sq, int Sk,
                 int D, int causal, float scale_log2) {
  using P = Plan<DP, BK, NS>;
  constexpr int kColBlocks = DP / kBox;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + P::kQBytes;           // stage st: + st kKVBytes
  const uint32_t v_s = k_s + NS * P::kKVBytes;
  const uint32_t full_q = base + P::kBarOffset;
  const uint32_t full_k = full_q + 8;               // stage st: + 8 st
  const uint32_t empty_k = full_k + 8 * NS;
  const uint32_t full_v = empty_k + 8 * NS;
  const uint32_t empty_v = full_v + 8 * NS;

  // block -> (head, query tile): groups of kHeadGroup heads, query tiles
  // in reverse within a group, heads fastest
  const int n_qt = (Sq + kBq - 1) / kBq;
  const int group = kHeadGroup * n_qt;
  const int r = (int)(blockIdx.x % (unsigned)group);
  const int bh = (int)(blockIdx.x / (unsigned)group) * kHeadGroup +
                 r % kHeadGroup;
  if (bh >= BH) return;
  const int q0 = (n_qt - 1 - r / kHeadGroup) * kBq;
  const int kend = causal ? min(Sk, q0 + kBq) : Sk;
  const int n_kt = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(empty_k + 8 * st, kConsumerThreads);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_v + 8 * st, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, P::kQBytes);
#pragma unroll
      for (int b = 0; b < kColBlocks; ++b)
        tma_load(q_s + b * kBq * kRowBytes, &tm_q, full_q, b * kBox, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % NS;
        const uint32_t ph = (kt / NS) & 1;
        mbar_wait(empty_k + 8 * st, ph ^ 1);
        mbar_expect_tx(full_k + 8 * st, P::kKVBytes);
#pragma unroll
        for (int b = 0; b < kColBlocks; ++b)
          tma_load(k_s + st * P::kKVBytes + b * BK * kRowBytes, &tm_k,
                   full_k + 8 * st, b * kBox, kt * BK, bh);
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, P::kKVBytes);
#pragma unroll
        for (int b = 0; b < kColBlocks; ++b)
          tma_load(v_s + st * P::kKVBytes + b * BK * kRowBytes, &tm_v,
                   full_v + 8 * st, b * kBox, kt * BK, bh);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;               // accumulator row
    const int c = lane % 4;               // accumulator column pair
    const int row_w = q0 + 64 * wg + 16 * warp;   // the warp's first row
    const uint32_t q_w = q_s + 64 * wg * kRowBytes;
    // key tiles not wholly above this warpgroup's diagonal (at least 1)
    const int n_own = causal ? min(n_kt, (q0 + 64 * wg + 63) / BK + 1)
                             : n_kt;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNeg, kNeg};            // running max of the raw scores
    float l[2] = {0.0f, 0.0f};            // this thread's share of the
                                          // running denominator
    float corr[2];
    float s[BK / 2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];

    // Tile kt's Q K^T is issued with tile kt - 1's P V behind it: the
    // softmax of tile kt runs while P V is on the tensor cores, and the
    // accumulator is rescaled once P V has read it. The two warpgroups
    // take turns at issuing (named barrier 1 + wg is this one's turn;
    // warpgroup 0 opens), so one's softmax runs under the other's
    // products. A turn comes n_turns times to each: once for tile 0's
    // Q K^T, once a later tile, once for the last P V, and warpgroup 0,
    // which may own one tile fewer, passes its spare turn empty.
    const int n_turns = (causal ? min(n_kt, (q0 + kBq - 1) / BK + 1)
                                : n_kt) + 1;
    int turn = 0;
    const auto take_turn = [&] {
      if constexpr (kPingPong<DP>) bar_sync(1 + wg, kConsumerThreads);
    };
    const auto pass_turn = [&] {
      if constexpr (kPingPong<DP>)
        if (wg == 0 || turn < n_turns - 1)
          bar_arrive(2 - wg, kConsumerThreads);
      ++turn;
    };
    if (kPingPong<DP> && wg == 0) bar_arrive(1, kConsumerThreads);
    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    take_turn();
    qk_issue<DP, BK>(s, q_w, k_s);
    pass_turn();
    wgmma_wait<0>();
    hold<BK / 2>(s);
    mbar_arrive(empty_k);
    softmax_tile<BK>(s, m, l, corr, 0, Sk, causal, row_w, g, c, scale_log2);
    p_fragments<BK>(s, p_hi, p_lo);
    for (int kt = 1; kt < n_own; ++kt) {
      const int st = kt % NS, st_prev = (kt - 1) % NS;
      mbar_wait(full_k + 8 * st, (kt / NS) & 1);
      mbar_wait(full_v + 8 * st_prev, ((kt - 1) / NS) & 1);
      take_turn();
      qk_issue<DP, BK>(s, q_w, k_s + st * P::kKVBytes);
      pv_issue<DP, BK>(o, p_hi, p_lo, v_s + st_prev * P::kKVBytes);
      pass_turn();
      wgmma_wait<1>();                    // Q K^T is done, P V may run on
      hold<BK / 2>(s);
      mbar_arrive(empty_k + 8 * st);
      softmax_tile<BK>(s, m, l, corr, kt * BK, Sk, causal, row_w, g, c,
                       scale_log2);
      wgmma_wait<0>();
      hold<DP / 2>(o);
      hold<BK / 2>(s);
      mbar_arrive(empty_v + 8 * st_prev);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      p_fragments<BK>(s, p_hi, p_lo);
    }
    const int st_last = (n_own - 1) % NS;
    mbar_wait(full_v + 8 * st_last, ((n_own - 1) / NS) & 1);
    take_turn();
    pv_issue<DP, BK>(o, p_hi, p_lo, v_s + st_last * P::kKVBytes);
    pass_turn();
    wgmma_wait<0>();
    hold<DP / 2>(o);
    mbar_arrive(empty_v + 8 * st_last);
    // tiles loaded for the other warpgroup only: released once they have
    // landed, so that the arrival falls in their phase of the ring (an
    // early one could complete the stage's previous phase while the other
    // warpgroup still reads it)
    for (int kt = n_own; kt < n_kt; ++kt) {
      const int st = kt % NS;
      mbar_wait(full_k + 8 * st, (kt / NS) & 1);
      mbar_arrive(empty_k + 8 * st);
      mbar_wait(full_v + 8 * st, (kt / NS) & 1);
      mbar_arrive(empty_v + 8 * st);
    }
    while (turn < n_turns) {
      take_turn();
      pass_turn();
    }

    // the row's denominator over its quad, in one fixed tree; divide, store
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
    const int row_a = row_w + g;          // this thread's two rows
    const int row_b = row_a + 8;
    __nv_bfloat16* oh = out + (long long)bh * Sq * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col >= D) continue;
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (long long)row_a * D + col) =
            __floats2bfloat162_rn(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (long long)row_b * D + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
    }
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

// [BH, S, D] bf16 as a 3-D map, D innermost; boxes of 64 columns x ``rows``
// rows x 1 head with the 128-byte swizzle; what lies past D or S reads as 0
cudaError_t tensor_map(CUtensorMap* map, sde::EncodeTiled encode,
                       const void* x, long long BH, long long S, int D,
                       int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, int BK, int NS>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, long long BH, long long Sq, long long Sk,
                        int D, int causal, cudaStream_t stream) {
  using P = Plan<DP, BK, NS>;
  const long long n_qt = (Sq + kBq - 1) / kBq;
  const long long blocks = (BH + kHeadGroup - 1) / kHeadGroup * kHeadGroup *
                           n_qt;
  if (blocks > INT_MAX || Sk > INT_MAX)   // a TMA coordinate is 32-bit
    return cudaErrorInvalidValue;
  sde::EncodeTiled encode;
  cudaError_t err = sde::encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = tensor_map(&tq, encode, q, BH, Sq, D, kBq)) != cudaSuccess ||
      (err = tensor_map(&tk, encode, k, BH, Sk, D, BK)) != cudaSuccess ||
      (err = tensor_map(&tv, encode, v, BH, Sk, D, BK)) != cudaSuccess)
    return err;
  auto kern = attn_bf16_kernel<DP, BK, NS>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / std::sqrt((double)D));
  kern<<<(unsigned)blocks, kThreads, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), (int)BH, (int)Sq,
      (int)Sk, D, causal, scale_log2);
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
      err = launch_bf16<64, 128, 4>(q, k, v, out, BH, Sq, Sk, D, causal,
                                    stream);
    else if (D <= 128)
      err = launch_bf16<128, 128, 2>(q, k, v, out, BH, Sq, Sk, D, causal,
                                     stream);
    else
      err = launch_bf16<256, 64, 2>(q, k, v, out, BH, Sq, Sk, D, causal,
                                    stream);
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
