// Stable counting sort of a batch's routed rows, for Hopper (sm_90a).
//
// Groups a batch by row for a walk that sums each row's tuples in batch
// order. Given rows [T] i32, it writes the tuples whose row lies in
// [0, n), ordered by row and, within a row, by batch index:
//
//   srow [T'] i32  the rows in ascending order
//   perm [T'] i32  the batch index of each sorted position
//   count          T', the tuples kept (on the card: the host never waits)
//
// It is an LSD radix sort over the ceil(log2 n) bits a row can have, in
// passes of at most kMaxDigitBits (9) bits of equal width: n = 131,072
// takes 2 passes of 9 bits, n = 2**18 + 1 takes 3 of 7. Each pass is two
// launches on the caller's stream:
//   1. hist: each block counts the digits of its tile of kSortTile tuples
//      (shared-memory counts, one add per group of equal digits a warp)
//      into hist [block, digit], and adds them into the pass's digit
//      totals and into its group's [digit] sums (integer atomics; a group
//      is kGroup blocks);
//   2. scatter: each block finds where its tuples of each digit begin in
//      the pass's output (thread g: the total of digit g, and its tuples
//      in the blocks of its own group before this block and in the groups
//      before it, kGroup loads in flight at a time, a warp reading a row's
//      128 bytes at once; the block scans the totals over the digits),
//      ranks its tile again, lays its tuples out by digit in shared memory
//      and writes each digit's tuples to their consecutive positions (a
//      warp's stores touch a few 32-byte sectors, not one a tuple). The
//      first pass's block 0 also writes T'.
// The rank is stable by construction, with no atomic deciding a position:
// a block's tile is one slice of kWarpTile consecutive tuples a warp; a
// warp ranks 32 tuples at a time (the lanes of a digit from one vote a
// digit bit, then __popc(peers & the lanes below)) on top of its own
// per-digit counts in shared memory, and a prefix of those counts over
// the warps puts warp w's tuples after those of warps 0 .. w - 1. So
// equal rows keep batch order.
// The first pass drops the tuples outside [0, n).
//
// The two steps are device functions over a virtual block index
// (sort_hist_tile, or sort_hist_keys for keys a block already holds, and
// sort_scatter_tile), so that a persistent kernel can run
// them between grid-wide barriers (reservoir_scan.cu); kCoherent then reads
// what other blocks of the same launch wrote through L2 (ld.global.cg), and
// a last pass given head / end also records each row's first and one past
// its last sorted position. sort_rows launches them as kernels.
//
// Scratch (SortScratch, from the caller's int32 words) holds the count,
// the [block, digit] counts, each pass's totals and group sums (set to 0
// by one memset a call) and two (rows, batch index) buffers that the
// passes alternate between; the last pass always writes srow and perm.
// Nothing is allocated here.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sde {
namespace {

constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 2;                         // tuples a lane ranks
constexpr int kWarpTile = 32 * kSortItems;            // a warp's, consecutive
constexpr int kSortTile = kSortThreads * kSortItems;  // a block's
constexpr int kMaxDigitBits = 9;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kMaxPasses = (31 + kMaxDigitBits - 1) / kMaxDigitBits;
constexpr int kGroup = 8;                             // blocks a group
constexpr unsigned kSortAll = 0xffffffffu;

__host__ __device__ inline long long round32(long long x) {
  return (x + 31) / 32 * 32;
}

// The caller's scratch: int32 words from a 128-byte aligned base, laid out
// by sort_scratch(): count (padded to 32 words), the [block, digit]
// counts, each pass's [1 + groups, digit] sums (row 0 the totals), then
// srow, perm and the second pair, cap = T rounded up to 32 words each.
struct SortScratch {
  int32_t* count;
  int32_t* hist;
  int32_t* sums;
  long long sums_words;          // all passes'
  int groups;
  int32_t* srow;
  int32_t* perm;
  int32_t* keys2;
  int32_t* perm2;
  long long cap;
  int blocks;
};

inline int sort_blocks(int T) { return (T + kSortTile - 1) / kSortTile; }
inline int sort_groups(int T) {
  return (sort_blocks(T) + kGroup - 1) / kGroup;
}
inline long long sort_sums_words(int T) {
  return (long long)kMaxPasses * (1 + sort_groups(T)) * kMaxRadix;
}

// word offsets: srow (count is at 0, hist at 32, sums after it), and the
// whole scratch
inline long long sort_srow_word(int T) {
  return 32 + round32((long long)kMaxRadix * sort_blocks(T)) +
         sort_sums_words(T);
}

inline long long sort_words(int T) {
  return sort_srow_word(T) + 4 * round32(T);
}

inline SortScratch sort_scratch(int32_t* base, int T) {
  SortScratch s;
  s.blocks = sort_blocks(T);
  s.cap = round32(T);
  s.count = base;
  s.hist = base + 32;
  s.groups = sort_groups(T);
  s.sums = s.hist + round32((long long)kMaxRadix * s.blocks);
  s.sums_words = sort_sums_words(T);
  int32_t* const p = base + sort_srow_word(T);
  s.srow = p;
  s.perm = p + s.cap;
  s.keys2 = p + 2 * s.cap;
  s.perm2 = p + 3 * s.cap;
  return s;
}

// For a kept lane: the kept lanes of the warp whose digit is its own, from
// one vote a digit bit (a vote costs the same whatever the digits, unlike
// __match_any_sync, whose time grows with the distinct values it sees).
__device__ __forceinline__ unsigned peers_of(bool keep, int dg, int bits) {
  unsigned peers = __ballot_sync(kSortAll, keep);
  for (int b = 0; b < bits; ++b) {
    const bool on = (dg >> b) & 1;
    const unsigned m = __ballot_sync(kSortAll, on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// Tuple i of block b's tile is b * kSortTile + w * kWarpTile + r * 32 + lane
// for warp w and round r: a warp's kWarpTile tuples are consecutive.
__device__ __forceinline__ long long tile_base(int vb) {
  return (long long)vb * kSortTile + (threadIdx.x >> 5) * kWarpTile +
         (threadIdx.x & 31);
}

// A pass's input (keys, batch indices): through the read-only cache, or,
// when another block of the same launch wrote it, through L2.
template <bool kCoherent>
__device__ __forceinline__ int32_t sort_in(const int32_t* p) {
  if constexpr (kCoherent) return __ldcg(p);
  else return __ldg(p);
}

// The counts and sums of a pass, written by the launch before (or, with
// kCoherent, by the phase before).
template <bool kCoherent>
__device__ __forceinline__ int32_t sort_sum(const int32_t* p) {
  if constexpr (kCoherent) return __ldcg(p);
  else return *p;
}

// head[r] holds kHeadBias - (row r's first sorted position), so that an
// integer atomicMax over a zeroed array keeps the least position.
constexpr int32_t kHeadBias = 0x7fffffff;

// Step 1, for virtual block vb. The pass's input is the batch's rows
// (first: T tuples, those in [0, n) kept) or the previous pass's output
// (*count tuples, all kept).
// The histogram of virtual block vb's keys, held by its threads (key[r]:
// tuple tile_base(vb) + 32 r; -1 or any key outside [0, n): none).
__device__ __forceinline__ void sort_hist_keys(
    int vb, const int (&key)[kSortItems], int n, int shift, int bits,
    int32_t* __restrict__ hist, int32_t* __restrict__ sums) {
  __shared__ int s_hist[kMaxRadix];
  const int radix = 1 << bits;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < radix; i += kSortThreads) s_hist[i] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool keep = key[r] >= 0 && key[r] < n;
    const int dg = (key[r] >> shift) & (radix - 1);
    const unsigned peers = peers_of(keep, dg, bits);
    if (keep && (peers & ((1u << lane) - 1u)) == 0u) {
      atomicAdd(&s_hist[dg], __popc(peers));
    }
  }
  __syncthreads();
  int32_t* const group = sums + (1 + vb / kGroup) * kMaxRadix;
  for (int i = threadIdx.x; i < radix; i += kSortThreads) {
    const int c = s_hist[i];
    hist[(long long)vb * kMaxRadix + i] = c;
    if (c != 0) {
      atomicAdd(sums + i, c);
      atomicAdd(group + i, c);
    }
  }
  __syncthreads();                 // s_hist is free for the next tile
}

template <bool kCoherent>
__device__ __forceinline__ void sort_hist_tile(
    int vb, const int32_t* __restrict__ keys, int n, int T,
    const int32_t* __restrict__ count, bool first, int shift, int bits,
    int32_t* __restrict__ hist, int32_t* __restrict__ sums) {
  const long long len = first ? T : sort_sum<kCoherent>(count);
  const long long i0 = tile_base(vb);
  int key[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    key[r] = i0 + r * 32 < len ? sort_in<kCoherent>(keys + i0 + r * 32) : -1;
  }
  sort_hist_keys(vb, key, n, shift, bits, hist, sums);
}

// Step 2, for virtual block vb. Where each digit of this block begins,
// then the ranks: each kept tuple (row, batch index) goes to that place +
// the tuples of its digit in the warps before its own + its rank in its
// warp. perm == nullptr: the first pass, whose batch index is the position.
// Given head and end (the last pass), each warp's first and last tuple of
// a row among the staged ones raise head[row] (kHeadBias - position) and
// end[row] (position + 1), both zero before: the row's run is [kHeadBias -
// head, end) once every block has run.
template <bool kCoherent>
__device__ __forceinline__ void sort_scatter_tile(
    int vb, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ perm, int n, int T,
    int32_t* __restrict__ count, int shift, int bits,
    const int32_t* __restrict__ hist, const int32_t* __restrict__ sums,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ perm_out,
    int32_t* __restrict__ head, int32_t* __restrict__ end) {
  __shared__ int s_cnt[kSortWarps][kMaxRadix];  // a warp's counts by digit
  __shared__ int s_base[kMaxRadix];    // output position - staged position
  __shared__ int s_lbase[kMaxRadix];   // where the digit's staged run begins
  __shared__ int s_sum[kSortWarps];
  __shared__ int s_lsum[kSortWarps];
  __shared__ int s_key[kSortTile];     // the block's tuples, by digit
  __shared__ int s_tix[kSortTile];
  const bool first = perm == nullptr;
  const int radix = 1 << bits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = threadIdx.x;                    // radix <= kSortThreads
  for (int i = lane; i < radix; i += 32) s_cnt[warp][i] = 0;
  const long long len = first ? T : sort_sum<kCoherent>(count);
  const long long i0 = tile_base(vb);
  int key[kSortItems], tix[kSortItems], dg[kSortItems], rank[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const long long i = i0 + r * 32;
    key[r] = i < len ? sort_in<kCoherent>(keys + i) : -1;
    tix[r] = first ? (int)i : (i < len ? sort_in<kCoherent>(perm + i) : 0);
  }
  // digit g: its tuples in all blocks, and in the blocks before this one
  // (its group's blocks before it, then the groups before its group),
  // kGroup independent loads in flight at a time: a loop of dependent
  // load-adds waits out one memory latency a load
  int total = 0, before = 0;
  if (g < radix) {
    const int grp = vb / kGroup;
    int part[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int b = grp * kGroup + i;
      part[i] = b < vb ? sort_sum<kCoherent>(hist + (long long)b * kMaxRadix +
                                             g)
                       : 0;
    }
    total = sort_sum<kCoherent>(sums + g);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) before += part[i];
    for (int q0 = 0; q0 < grp; q0 += kGroup) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        part[i] = q0 + i < grp
                      ? sort_sum<kCoherent>(sums + (1 + q0 + i) * kMaxRadix + g)
                      : 0;
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) before += part[i];
    }
  }
  int x = total;                                // inclusive over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kSortAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_sum[warp] = x;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool keep = i0 + r * 32 < len && key[r] >= 0 && key[r] < n;
    dg[r] = keep ? (key[r] >> shift) & (radix - 1) : -1;
    const unsigned peers = peers_of(keep, dg[r], bits);
    const unsigned below = peers & ((1u << lane) - 1u);
    const int seen = keep ? s_cnt[warp][dg[r]] : 0;
    __syncwarp();                  // every peer read before the count moves
    if (keep && below == 0u) s_cnt[warp][dg[r]] = seen + __popc(peers);
    __syncwarp();
    rank[r] = seen + __popc(below);
  }
  __syncthreads();
  // per digit, the tuples of the warps before each warp, and the block's
  int mine = 0;
  if (g < radix) {
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = s_cnt[w][g];
      s_cnt[w][g] = mine;
      mine += c;
    }
  }
  // where digit g's tuples begin in the block's staging: a scan of the
  // block's counts over the digits (zero past radix)
  int y = mine;                                 // inclusive over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int z = __shfl_up_sync(kSortAll, y, o);
    if (lane >= o) y += z;
  }
  if (lane == 31) s_lsum[warp] = y;
  __syncthreads();
  int kept = 0;                                 // the block's tuples
  for (int w = 0; w < kSortWarps; ++w) kept += s_lsum[w];
  if (g < radix) {
    int run = x - total;                        // exclusive, then warps'
    int lrun = y - mine;
    for (int w = 0; w < warp; ++w) {
      run += s_sum[w];
      lrun += s_lsum[w];
    }
    s_lbase[g] = lrun;
    s_base[g] = run + before - lrun;
    if (first && vb == 0 && g == radix - 1) *count = run + total;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (dg[r] < 0) continue;
    const int at = s_lbase[dg[r]] + s_cnt[warp][dg[r]] + rank[r];
    s_key[at] = key[r];
    s_tix[at] = tix[r];
  }
  __syncthreads();
  // staged tuple i goes to s_base[its digit] + i: a digit's run of the
  // block's tuples lands on consecutive positions
  for (int i = threadIdx.x; i < kept; i += kSortThreads) {
    const int k = s_key[i];
    const int pos = s_base[(k >> shift) & (radix - 1)] + i;
    keys_out[pos] = k;
    perm_out[pos] = s_tix[i];
    if (head != nullptr) {         // staged tuples are in sorted order
      if (lane == 0 || s_key[i - 1] != k) atomicMax(head + k, kHeadBias - pos);
      if (lane == 31 || i + 1 == kept || s_key[i + 1] != k)
        atomicMax(end + k, pos + 1);
    }
  }
  __syncthreads();                 // the staging is free for the next tile
}

__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const int32_t* __restrict__ keys, int n, int T,
                 const int32_t* __restrict__ count, bool first, int shift,
                 int bits, int32_t* __restrict__ hist,
                 int32_t* __restrict__ sums) {
  sort_hist_tile<false>(blockIdx.x, keys, n, T, count, first, shift, bits,
                        hist, sums);
}

__global__ void __launch_bounds__(kSortThreads)
sort_scatter_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ perm, int n, int T,
                    int32_t* __restrict__ count, int shift, int bits,
                    const int32_t* __restrict__ hist,
                    const int32_t* __restrict__ sums,
                    int32_t* __restrict__ keys_out,
                    int32_t* __restrict__ perm_out) {
  sort_scatter_tile<false>(blockIdx.x, keys, perm, n, T, count, shift, bits,
                           hist, sums, keys_out, perm_out, nullptr, nullptr);
}

// The passes of a sort of rows in [0, n): ceil(log2 n) bits in passes of
// equal width, at most kMaxDigitBits each (one pass of 0 bits at n <= 1).
struct SortPlan {
  int passes, bits;
};

__host__ __device__ inline SortPlan sort_plan(int n) {
  int nbits = 0;
  while (nbits < 31 && (1u << nbits) < (unsigned)n) ++nbits;
  const int passes =
      nbits > 0 ? (nbits + kMaxDigitBits - 1) / kMaxDigitBits : 1;
  return {passes, (nbits + passes - 1) / passes};
}

// Pass p's buffers: the passes alternate so that the last one writes srow /
// perm; the first reads `rows` (its batch index is the position).
struct SortPass {
  const int32_t* in_k;
  const int32_t* in_p;
  int32_t* out_k;
  int32_t* out_p;
  int32_t* sums;
  int shift;
};

__host__ __device__ inline SortPass sort_pass(const SortScratch& s,
                                              const int32_t* rows, int p,
                                              const SortPlan& plan) {
  const bool to_main = (plan.passes - 1 - p) % 2 == 0;
  SortPass q;
  q.in_k = p == 0 ? rows : (to_main ? s.keys2 : s.srow);
  q.in_p = p == 0 ? nullptr : (to_main ? s.perm2 : s.perm);
  q.out_k = to_main ? s.srow : s.keys2;
  q.out_p = to_main ? s.perm : s.perm2;
  q.sums = s.sums + (long long)p * (1 + s.groups) * kMaxRadix;
  q.shift = p * plan.bits;
  return q;
}

// Sort rows [T] (rows outside [0, n) dropped) into s.srow / s.perm, T' into
// *s.count, on `stream`. Returns the launches' error.
inline cudaError_t sort_rows(const int32_t* rows, int n, int T,
                             const SortScratch& s, cudaStream_t stream) {
  const SortPlan plan = sort_plan(n);
  const cudaError_t zero = cudaMemsetAsync(
      s.sums, 0, sizeof(int32_t) * s.sums_words, stream);
  if (zero != cudaSuccess) return zero;
  for (int p = 0; p < plan.passes; ++p) {
    const SortPass q = sort_pass(s, rows, p, plan);
    sort_hist_kernel<<<s.blocks, kSortThreads, 0, stream>>>(
        q.in_k, n, T, s.count, p == 0, q.shift, plan.bits, s.hist, q.sums);
    sort_scatter_kernel<<<s.blocks, kSortThreads, 0, stream>>>(
        q.in_k, q.in_p, n, T, s.count, q.shift, plan.bits, s.hist, q.sums,
        q.out_k, q.out_p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace sde
