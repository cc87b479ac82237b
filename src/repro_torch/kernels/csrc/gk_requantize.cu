// GK's stacked requantize for Hopper (sm_90a), with the routing probe
// fused in or the rows given.
//
// Replaces no TPU kernel. The JAX package updates a GK stack with
// GKQuantiles.add_batch (src/repro/core/gk.py:51) under the vmap of
// batched.stacked_update (src/repro/core/batched.py:92): every one of the
// stack's rows requantizes its m values (weight n / m) together with the
// WHOLE batch of T tuples, its own at weight 1 and the rest as +inf at
// weight 0:
//
//   sort the m + T entries stably (total order, -0.0 == 0.0, NaN last,
//   the state before the batch on ties), take the midpoint ranks
//   cum(w) - 0.5 w, search the m targets (i + 0.5) / m * total, clip to
//   m + T - 1 and gather; n grows by the row's tuples.
//
// A row with no tuple changes too (its targets sit on midpoints that
// rounding decides), so EVERY row is requantized on every batch. The
// running sums are jnp.cumsum's on the CPU, a scan in blocks of 16
// positions, the block totals scanned the same way, recursively; the
// search is jnp.searchsorted's, ceil(log2(m + T + 1)) halvings of
// [0, m + T) going left where target <= cum[mid]. Both orders are part of
// the result, and the masked tail's sums are not flat, so cum need not be
// monotone; the plain version (ref.gk_requantize_update) and
// src/repro_torch/core/gk.py say why the steps below give its bytes.
//
// Here no row builds its m + T entries. A row's head is its sorted state
// merged with its own tuples (h = m + k entries); the T - k zero-weight
// entries after it (the tail) are virtual: a tail position's running sum
// is one of the head's level sums (level 0's at the head's last entry,
// then level 1's at the head's last block, ...), so the search reads the
// head below h and those level sums above it. A row whose own tuples hold
// a +inf or a NaN, or whose state holds a NaN, has weighted entries among
// or after the zero-weight ones; it builds its m + T entries in the
// scratch of one block (the batch's zero-weight +inf entries in batch
// order, its own +inf among them).
//
// Launches a call (on the caller's stream):
//   memset   the run bounds, flags and the big-row count
//   key      a thread a tuple, in the batch's value order (`order`: the
//            wrapper's stable sort of the masked tuples first, by value):
//            its row (given, or sde::probe_row on the routing table for a
//            masked tuple), its key (-1 where masked, unrouted, outside
//            [0, n) or routed to a data-source row, whose own tuples are
//            every masked tuple), the row flagged where the tuple is +inf
//            or NaN (the data-source rows' flag where any masked one is)
//   sort     row_sort.cuh's stable grouping by row of those keys: a row's
//            run lists its tuples by value, ties in batch order
//   bounds   each row's run [start, end)
//   small    a block (256 threads) a row: its state sorted in shared
//            memory (bitonic, on (value key, slot)), merged with its run
//            (each tuple's place: its rank + the state entries <= it; a
//            state entry's: its rank + the tuples below it, a count
//            histogram), the blocked scan (a thread a block of 16 at each
//            level, then the prefixes down), the m searches (a thread a
//            target) and the gathers, all in shared memory. A data-source
//            row, a row with a non-finite tuple or NaN state, and a row
//            whose head exceeds the block's room go to the big list.
//   big      a block (512 threads) a listed row, in turn, its head (or its
//            m + T entries) in that block's global scratch. A state above
//            kSharedM values (eps < 4 / 4,096) does not fit a small
//            block: then the small pass is not launched, every row is
//            big, and the state's sort and counts sit in the block's
//            global scratch too.
// Floats: __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn only, so no
// multiply-add is contracted and no division becomes a reciprocal's
// product; no float atomics: the same bytes on every run, equal to the
// plain version's.
//
// What bounds it on this card: its bytes (the stack read and written,
// 1,604 B a row at m = 400: 0.125 ms for 131,072 rows at 3.35 TB/s) and
// the searches' shared-memory reads (m x 17 a row at T = 65,536, 32 a
// cycle an SM: 0.107 ms) about equally; this first design is held up
// longer by each row's dependent steps: the sort's 45 stages, the scan's
// levels and each search's 17 dependent shared loads.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "probe.cuh"
#include "row_sort.cuh"

namespace {

constexpr int kKeyThreads = 256;
constexpr int kSmallThreads = 256;
constexpr int kBigThreads = 512;
constexpr int kSharedM = 4096;         // the largest state in shared memory
constexpr int kMaxM = 1 << 20;         // the largest state (eps >= 4 / 2**20)
constexpr long long kBigWords = 1LL << 28;  // the big blocks' scratch, at most
constexpr int kExtra = 512;            // a small row's room past its state
constexpr int kLevels = 8;             // scan levels of a length < 2**31
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr uint32_t kInfKey = 0xff800000u;   // sort_key(+inf)
constexpr uint32_t kNanKey = 0xffc00000u;   // sort_key(any NaN)
constexpr unsigned kFull = 0xffffffffu;

// The sort's total order on float32 bits as an unsigned key: -0.0 as
// 0.0, every NaN as the positive quiet NaN, after +inf.
__host__ __device__ __forceinline__ uint32_t sort_key(uint32_t u) {
  if ((u & 0x7fffffffu) == 0u) {
    u = 0u;
  } else if ((u & 0x7fffffffu) > 0x7f800000u) {
    u = 0x7fc00000u;
  }
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool is_source(const int64_t* src, int n_src,
                                          int32_t r) {
  for (int i = 0; i < n_src; ++i) {
    if (src[i] == r) return true;
  }
  return false;
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The entries of levels 1, 2, ... of a blocked scan of `len` entries, up
// to the first level of 16 or fewer.
__host__ __device__ inline long long level_words(long long len) {
  long long total = 0;
  while (len > 16) {
    len = (len + 15) / 16;
    total += len;
  }
  return total;
}

struct Args {
  float* values;                 // [n, m]
  float* n_state;                // [n]
  int n, m, P, cap, T;
  long long N;                   // m + T
  int steps;                     // ceil(log2(N + 1))
  const int32_t* rows;           // null: probe the routing table
  const uint32_t* keys_lo;
  const uint32_t* keys_hi;
  const int32_t* table_rows;
  uint32_t size;
  const uint32_t* sid_lo;
  const uint32_t* sid_hi;
  int n_probe;
  const float* vals;
  const uint8_t* mask;
  const int32_t* order;          // [T]: the masked tuples first, by value
  const int32_t* nmask;          // the masked tuples (on the card)
  const int64_t* src;
  int n_src;
  sde::SortScratch sort;
  int32_t* key;                  // [T], by value position
  int32_t* rowt;                 // [T], by batch position: a kept row or -1
  int32_t* run_start;            // [n]
  int32_t* run_end;              // [n]
  uint8_t* flag;                 // [n]: a +inf or NaN among the row's own
  int32_t* misc;                 // [0]: the source flag, [1]: big rows
  int32_t* big_list;             // [n]
  uint32_t* big;                 // the big blocks' scratch
  long long big_stride;          // words a block
  long long state_words;         // the state's sort and counts there, or 0
};

// ---------------------------------------------------------------------------
// key and bounds passes
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kKeyThreads)
gk_key_kernel(const Args a) {
  const int j = blockIdx.x * kKeyThreads + threadIdx.x;
  if (j >= a.T) return;
  const int t = a.order[j];
  const bool m = a.mask[t] != 0;
  int32_t row = -1;
  if (m) {
    row = a.rows != nullptr
              ? a.rows[t]
              : sde::probe_row(a.keys_lo, a.keys_hi, a.table_rows, a.size,
                               a.sid_lo[t], a.sid_hi[t], a.n_probe);
  }
  const bool keep =
      m && row >= 0 && row < a.n && !is_source(a.src, a.n_src, row);
  a.key[j] = keep ? row : -1;
  a.rowt[t] = keep ? row : -1;
  const uint32_t u = __float_as_uint(a.vals[t]);
  const bool hot = u == kInfBits || (u & 0x7fffffffu) > 0x7f800000u;
  if (hot && keep) a.flag[row] = 1;
  if (hot && m) a.misc[0] = 1;
}

__global__ void __launch_bounds__(kKeyThreads)
gk_bounds_kernel(const Args a) {
  const int q = blockIdx.x * kKeyThreads + threadIdx.x;
  const int len = *a.sort.count;
  if (q >= len) return;
  const int32_t r = a.sort.srow[q];
  if (q == 0 || a.sort.srow[q - 1] != r) a.run_start[r] = q;
  if (q == len - 1 || a.sort.srow[q + 1] != r) a.run_end[r] = q + 1;
}

// ---------------------------------------------------------------------------
// a row's steps, by one block; `h*` arrays in shared or global memory
// ---------------------------------------------------------------------------

// A row's own tuples, in value order (ties in batch order): a routed run
// (through the sort's positions) or, for a data-source row, the masked
// tuples of the wrapper's order.
struct Own {
  const int32_t* perm;           // null: a data-source row
  int start;
  __device__ __forceinline__ uint32_t bits(const Args& a, int j) const {
    const int v = perm != nullptr ? a.order[perm[start + j]] : a.order[j];
    return __float_as_uint(a.vals[v]);
  }
};

// The row's m state values, keyed (value key << 32 | slot) and sorted in
// s_pair (pads of all ones after them); s_val keeps their bits by slot.
// Sets *s_nan where a value is a NaN.
__device__ void sort_state(const Args& a, int r, uint64_t* s_pair,
                           uint32_t* s_val, int* s_nan) {
  const float* row = a.values + (size_t)r * a.m;
  for (int i = threadIdx.x; i < a.P; i += blockDim.x) {
    if (i < a.m) {
      const uint32_t u = __float_as_uint(row[i]);
      if ((u & 0x7fffffffu) > 0x7f800000u) *s_nan = 1;
      s_val[i] = u;
      s_pair[i] = ((uint64_t)sort_key(u) << 32) | (uint32_t)i;
    } else {
      s_pair[i] = ~0ull;
    }
  }
  __syncthreads();
  for (int k = 2; k <= a.P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < a.P / 2; p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));
        const uint64_t x = s_pair[i], y = s_pair[i + j];
        if ((x > y) == ((i & k) == 0)) {
          s_pair[i] = y;
          s_pair[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ uint32_t state_key(const uint64_t* s_pair,
                                              int i) {
  return (uint32_t)(s_pair[i] >> 32);
}

// The first of the sorted state entries [0, S) whose key is above (or,
// with `strict` false, at least) `k`.
__device__ __forceinline__ int state_bound(const uint64_t* s_pair, int S,
                                           uint32_t k, bool strict) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint32_t x = state_key(s_pair, mid);
    if (strict ? x <= k : x < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Inclusive prefix sums of s[0, len) in place; one block.
__device__ void block_scan(int* s, int len) {
  __shared__ int warp_tot[32];
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int b = threadIdx.x * per;
  const int e = b + per < len ? b + per : len;
  int mine = 0;
  for (int i = b; i < e; ++i) {
    mine += s[i];
    s[i] = mine;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = x - mine;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  for (int i = b; i < e; ++i) s[i] += before;
  __syncthreads();
}

// The stable merge of the sorted state entries [0, S) (weight wst) and the
// own tuples [0, K) (weight 1) into hv / hw [0, S + K): a tuple's place is
// its rank plus the state entries whose key is at most its own, a state
// entry's its rank plus the tuples below it (s_cnt: tuples by the state
// entries at or below them, then its prefix sums).
__device__ void merge_head(const Args& a, const uint64_t* s_pair,
                           const uint32_t* s_val, int S, const Own& own,
                           int K, float wst, uint32_t* hv, float* hw,
                           int* s_cnt) {
  for (int i = threadIdx.x; i <= S; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const uint32_t u = own.bits(a, j);
    const int q = state_bound(s_pair, S, sort_key(u), true);
    hv[j + q] = u;
    hw[j + q] = 1.0f;
    atomicAdd(s_cnt + q, 1);
  }
  __syncthreads();
  block_scan(s_cnt, S + 1);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int at = i + s_cnt[i];
    hv[at] = s_val[(uint32_t)s_pair[i]];
    hw[at] = wst;
  }
  __syncthreads();
}

// The blocked scan of hw [0, h): c[j] = cum[j] - 0.5 hw[j] (the midpoint
// ranks), s_V[l] = level l's inclusive sum at the head's last entry (for
// levels past the last, the last's). lv holds levels 1, 2, ...
__device__ void blocked_scan(const float* hw, float* c, float* lv, int h,
                             float* s_V) {
  int cnt[kLevels];
  long long off[kLevels];
  int top = 0;
  cnt[0] = h;
  off[0] = 0;
  off[1] = 0;
  while (cnt[top] > 16 && top < kLevels - 1) {
    cnt[top + 1] = (cnt[top] + 15) / 16;
    if (top + 1 > 1) off[top + 1] = off[top] + cnt[top];
    ++top;
  }
  // up: each block's sums in order, its total to the level above
  for (int l = 0; l <= top; ++l) {
    const float* in = l == 0 ? hw : lv + off[l];
    float* out = l == 0 ? c : lv + off[l];
    const int groups = (cnt[l] + 15) / 16;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int b = g * 16;
      const int e = b + 16 < cnt[l] ? b + 16 : cnt[l];
      float s = in[b];
      out[b] = s;
      for (int i = b + 1; i < e; ++i) {
        s = __fadd_rn(s, in[i]);
        out[i] = s;
      }
      if (l < top) lv[off[l + 1] + g] = s;
    }
    __syncthreads();
  }
  // down: each block after the first takes the inclusive sum of the totals
  // before it
  for (int l = top - 1; l >= 1; --l) {
    float* A = lv + off[l];
    const float* U = lv + off[l + 1];
    for (int j = threadIdx.x; j < cnt[l]; j += blockDim.x) {
      if (j >= 16) A[j] = __fadd_rn(U[(j >> 4) - 1], A[j]);
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    float v = c[j];
    if (top > 0 && j >= 16) v = __fadd_rn(lv[off[1] + (j >> 4) - 1], v);
    if (j == h - 1) s_V[0] = v;
    c[j] = __fsub_rn(v, __fmul_rn(0.5f, hw[j]));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int l = 1; l < kLevels; ++l)
      s_V[l] = l <= top ? lv[off[l] + cnt[l] - 1] : s_V[l - 1];
  }
  __syncthreads();
}

// The midpoint rank at virtual position p of a row whose head holds h
// entries: the head's below h, else the level sum the position reads.
__device__ __forceinline__ float cum_at(long long p, int h, const float* c,
                                        const float* s_V) {
  if (p < h) return c[p];
  long long j = p, last = h - 1;
  int l = 0;
  while ((j >> 4) != (last >> 4) && l < kLevels - 1) {
    j = (j >> 4) - 1;
    last >>= 4;
    ++l;
  }
  return s_V[l];
}

// The m searches and gathers of row r, and its new count.
__device__ void search_row(const Args& a, int r, const uint32_t* hv,
                           const float* c, int h, const float* s_V,
                           float total) {
  float* out = a.values + (size_t)r * a.m;
  for (int i = threadIdx.x; i < a.m; i += blockDim.x) {
    const float tg = __fmul_rn(
        __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)a.m), total);
    const uint32_t kt = sort_key(__float_as_uint(tg));
    long long lo = 0, hi = a.N;
    for (int s = 0; s < a.steps; ++s) {
      const long long mid = (lo + hi) >> 1;
      if (kt <= sort_key(__float_as_uint(cum_at(mid, h, c, s_V)))) hi = mid;
      else lo = mid;
    }
    const long long idx = hi < a.N - 1 ? hi : a.N - 1;
    out[i] = __uint_as_float(idx < h ? hv[idx] : kInfBits);
  }
  if (threadIdx.x == 0) a.n_state[r] = total;
}

struct Shared {
  uint64_t* pair;
  uint32_t* val;
  int* cnt;
  uint32_t* hv;                  // small rows only
  float* hw;
  float* c;
  float* lv;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// The dynamic shared memory of a block: the state's sort and the count
// histogram, and, with `head`, a small row's head, sums and levels.
__host__ __device__ inline size_t shared_bytes(int m, int P, int cap,
                                               bool head, Shared* s,
                                               unsigned char* base) {
  size_t at = 0;
  const size_t pair = at;
  at = align16(at + sizeof(uint64_t) * P);
  const size_t val = at;
  at = align16(at + sizeof(uint32_t) * P);
  const size_t cnt = at;
  at = align16(at + sizeof(int) * (m + 1));
  size_t hv = at, hw = at, c = at, lv = at;
  if (head) {
    hv = at;
    at = align16(at + 4 * (size_t)cap);
    hw = at;
    at = align16(at + 4 * (size_t)cap);
    c = at;
    at = align16(at + 4 * (size_t)cap);
    lv = at;
    at = align16(at + 4 * (size_t)level_words(cap));
  }
  if (s != nullptr) {
    s->pair = reinterpret_cast<uint64_t*>(base + pair);
    s->val = reinterpret_cast<uint32_t*>(base + val);
    s->cnt = reinterpret_cast<int*>(base + cnt);
    s->hv = reinterpret_cast<uint32_t*>(base + hv);
    s->hw = reinterpret_cast<float*>(base + hw);
    s->c = reinterpret_cast<float*>(base + c);
    s->lv = reinterpret_cast<float*>(base + lv);
  }
  return at;
}

// ---------------------------------------------------------------------------
// small rows: a block a row, all in shared memory
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSmallThreads)
gk_small_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_V[kLevels];
  __shared__ int s_nan;
  Shared s;
  shared_bytes(a.m, a.P, a.cap, true, &s, smem);
  const int r = blockIdx.x;
  if (threadIdx.x == 0) s_nan = 0;
  __syncthreads();
  sort_state(a, r, s.pair, s.val, &s_nan);
  const int start = a.T > 0 ? a.run_start[r] : 0;
  const int k = a.T > 0 ? a.run_end[r] - start : 0;
  if (s_nan || a.flag[r] || is_source(a.src, a.n_src, r) ||
      a.m + k > a.cap) {
    if (threadIdx.x == 0) a.big_list[atomicAdd(a.misc + 1, 1)] = r;
    return;
  }
  const float n0 = a.n_state[r];
  const float wst = __fdiv_rn(n0, (float)a.m);
  const Own own = {a.sort.srow != nullptr ? a.sort.perm : nullptr, start};
  merge_head(a, s.pair, s.val, a.m, own, k, wst, s.hv, s.hw, s.cnt);
  const int h = a.m + k;
  blocked_scan(s.hw, s.c, s.lv, h, s_V);
  search_row(a, r, s.hv, s.c, h, s_V, __fadd_rn(n0, (float)k));
}

// ---------------------------------------------------------------------------
// big rows: a block a listed row in turn, the head in global scratch
// ---------------------------------------------------------------------------

// The first of the own tuples [0, K) whose key is at least k (one thread).
__device__ int own_bound(const Args& a, const Own& own, int K, uint32_t k) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sort_key(own.bits(a, mid)) < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A row with a non-finite own tuple or NaN state: its m + T entries, in
// the reference's sorted order, into hv / hw.
__device__ void build_full(const Args& a, int r, bool source,
                           const uint64_t* s_pair, const uint32_t* s_val,
                           const Own& own, int K, float wst, uint32_t* hv,
                           float* hw, int* s_cnt) {
  __shared__ int s_b[3];
  __shared__ int warp_cnt[kBigThreads / 32];
  __shared__ int carry;
  if (threadIdx.x == 0) {
    s_b[0] = own_bound(a, own, K, kInfKey);         // own finite
    s_b[1] = own_bound(a, own, K, kNanKey);         // own finite and +inf
    s_b[2] = state_bound(s_pair, a.m, kNanKey, false);   // state not NaN
    carry = 0;
  }
  __syncthreads();
  const int k_f = s_b[0], k_fi = s_b[1], s_fi = s_b[2];
  // the finite entries and the state's +inf
  merge_head(a, s_pair, s_val, s_fi, own, k_f, wst, hv, hw, s_cnt);
  // the batch's +inf entries in batch order: every tuple but the row's
  // own finite and NaN ones, weight 1 where its own
  const long long base = s_fi + k_f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < a.T; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    bool mine = false, skip = false;
    if (t < a.T) {
      mine = source ? a.mask[t] != 0 : a.rowt[t] == r;
      skip = mine && __float_as_uint(a.vals[t]) != kInfBits;
    }
    const unsigned b = __ballot_sync(kFull, skip);
    if (lane == 0) warp_cnt[warp] = __popc(b);
    __syncthreads();
    int before = carry + __popc(b & ((1u << lane) - 1u));
    int chunk = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
      if (w < warp) before += warp_cnt[w];
      chunk += warp_cnt[w];
    }
    if (t < a.T && !skip) {
      const long long at = base + t - before;
      hv[at] = kInfBits;
      hw[at] = mine ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += chunk;
    __syncthreads();
  }
  // the NaNs: the state's, then the row's own
  const long long nan0 = base + (a.T - k_f - (K - k_fi));
  for (int i = threadIdx.x; i < a.m - s_fi; i += blockDim.x) {
    hv[nan0 + i] = s_val[(uint32_t)s_pair[s_fi + i]];
    hw[nan0 + i] = wst;
  }
  for (int j = threadIdx.x; j < K - k_fi; j += blockDim.x) {
    hv[nan0 + (a.m - s_fi) + j] = own.bits(a, k_fi + j);
    hw[nan0 + (a.m - s_fi) + j] = 1.0f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBigThreads)
gk_big_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_V[kLevels];
  __shared__ int s_nan;
  Shared s;
  uint32_t* base = a.big + (size_t)blockIdx.x * a.big_stride;
  if (a.state_words > 0) {       // every row big, the state in scratch
    s.pair = reinterpret_cast<uint64_t*>(base);
    s.val = base + 2 * (size_t)a.P;
    s.cnt = reinterpret_cast<int*>(s.val + a.P);
  } else {
    shared_bytes(a.m, a.P, a.cap, false, &s, smem);
  }
  uint32_t* hv = base + a.state_words;
  float* hw = reinterpret_cast<float*>(hv + a.N);
  float* c = hw + a.N;
  float* lv = c + a.N;
  const int count = a.state_words > 0 ? a.n : a.misc[1];
  for (int b = blockIdx.x; b < count; b += gridDim.x) {
    const int r = a.state_words > 0 ? b : a.big_list[b];
    if (threadIdx.x == 0) s_nan = 0;
    __syncthreads();
    sort_state(a, r, s.pair, s.val, &s_nan);
    const bool source = is_source(a.src, a.n_src, r);
    const int start = a.T > 0 && !source ? a.run_start[r] : 0;
    const int K = source ? *a.nmask
                         : (a.T > 0 ? a.run_end[r] - start : 0);
    const Own own = {source || a.T == 0 ? nullptr : a.sort.perm, start};
    const bool full = s_nan || (source ? a.misc[0] != 0 : a.flag[r] != 0);
    const float n0 = a.n_state[r];
    const float wst = __fdiv_rn(n0, (float)a.m);
    int h;
    if (full) {
      build_full(a, r, source, s.pair, s.val, own, K, wst, hv, hw, s.cnt);
      h = (int)a.N;
    } else {
      merge_head(a, s.pair, s.val, a.m, own, K, wst, hv, hw, s.cnt);
      h = a.m + K;
    }
    blocked_scan(hw, c, lv, h, s_V);
    search_row(a, r, hv, c, h, s_V, __fadd_rn(n0, (float)K));
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the launcher
// ---------------------------------------------------------------------------

// The scratch of a call, in int32 words from a 128-byte aligned base.
struct Layout {
  long long sort, key, rowt, run_start, run_end, flag, misc, big_list, big;
  long long zero_words;          // run_start .. misc, zeroed each call
  long long state, stride, total;
  int blocks;                    // big blocks
};

Layout layout(int n, int m, int T) {
  Layout l;
  const long long N = (long long)m + T;
  l.sort = 0;
  l.key = l.sort + (T > 0 ? sde::sort_words(T) : 0);
  l.rowt = l.key + sde::round32(T);
  l.run_start = l.rowt + sde::round32(T);
  l.run_end = l.run_start + sde::round32(n);
  l.flag = l.run_end + sde::round32(n);
  l.misc = l.flag + sde::round32((n + 3) / 4);
  l.big_list = l.misc + 32;
  l.zero_words = l.big_list - l.run_start;
  l.big = l.big_list + sde::round32(n);
  // a state above kSharedM: its sorted pairs (2P words), bits (P) and
  // counts (m + 1) ahead of the head in each big block's scratch
  const long long P = next_pow2(m);
  l.state = m > kSharedM ? 3 * P + sde::round32(m + 1) : 0;
  l.stride = sde::round32(l.state + 3 * N + level_words(N) + 16);
  const long long fit = kBigWords / l.stride;
  l.blocks = fit < 1 ? 1 : (fit < sde::sm_count() ? (int)fit
                                                  : sde::sm_count());
  l.total = l.big + l.stride * l.blocks;
  return l;
}

int launch(Args& a, int32_t* scratch, cudaStream_t stream) {
  if (a.n <= 0) return 0;
  if (scratch == nullptr || a.m < 1 || a.m > kMaxM || a.T < 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(a.n, a.m, a.T);
  a.N = (long long)a.m + a.T;
  if (a.N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.steps = 0;
  while ((1LL << a.steps) <= a.N) ++a.steps;
  a.P = next_pow2(a.m);
  a.cap = a.P + kExtra;
  a.key = scratch + l.key;
  a.rowt = scratch + l.rowt;
  a.run_start = scratch + l.run_start;
  a.run_end = scratch + l.run_end;
  a.flag = reinterpret_cast<uint8_t*>(scratch + l.flag);
  a.misc = scratch + l.misc;
  a.big_list = scratch + l.big_list;
  a.big = reinterpret_cast<uint32_t*>(scratch + l.big);
  a.big_stride = l.stride;
  a.state_words = l.state;
  if (a.src == nullptr) a.n_src = 0;
  cudaError_t err = cudaMemsetAsync(scratch + l.run_start, 0,
                                    sizeof(int32_t) * l.zero_words, stream);
  if (err != cudaSuccess) return (int)err;
  a.sort = sde::SortScratch{};
  if (a.T > 0) {
    a.sort = sde::sort_scratch(scratch + l.sort, a.T);
    const int kb = (a.T + kKeyThreads - 1) / kKeyThreads;
    gk_key_kernel<<<kb, kKeyThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sde::sort_rows(a.key, a.n, a.T, a.sort, stream);
    if (err != cudaSuccess) return (int)err;
    gk_bounds_kernel<<<kb, kKeyThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  size_t big_smem = 0;
  if (a.state_words == 0) {
    const size_t small_smem =
        shared_bytes(a.m, a.P, a.cap, true, nullptr, nullptr);
    big_smem = shared_bytes(a.m, a.P, a.cap, false, nullptr, nullptr);
    err = cudaFuncSetAttribute(gk_small_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)small_smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gk_big_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)big_smem);
    if (err != cudaSuccess) return (int)err;
    gk_small_kernel<<<a.n, kSmallThreads, small_smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  gk_big_kernel<<<l.blocks, kBigThreads, big_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch a requantize needs, in int32 words, and the largest m.
int gk_words(int n, int m, int T, long long* words, int* max_m) {
  *words = n > 0 ? layout(n, m, T).total : 0;
  *max_m = kMaxM;
  return 0;
}

// values [n, m] f32, n_state [n] f32 (updated in place); rows [T] i32;
// vals [T] f32; mask [T] bytes (0 / 1); order [T] i32 (the masked tuples
// first, each part by value key, ties in batch order); nmask: the masked
// tuples, one i32 on the card; src [n_src] i64 (data-source rows) or null;
// scratch: gk_words(n, m, T) words, 128-byte aligned.
int gk_requantize(float* values, float* n_state, int n, int m,
                  const int32_t* rows, const float* vals,
                  const uint8_t* mask, int T, const int32_t* order,
                  const int32_t* nmask, const int64_t* src, int n_src,
                  int32_t* scratch, cudaStream_t stream) {
  if (rows == nullptr && T > 0) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.values = values;
  a.n_state = n_state;
  a.n = n;
  a.m = m;
  a.T = T;
  a.rows = rows;
  a.vals = vals;
  a.mask = mask;
  a.order = order;
  a.nmask = nmask;
  a.src = src;
  a.n_src = n_src;
  return launch(a, scratch, stream);
}

// The same with each tuple's row probed from the routing-table mirror
// (keys_lo / keys_hi / table_rows of pow2 `size`) for the stream-id halves
// sid_lo / sid_hi [T], at most n_probe slots (-1: unrouted).
int gk_probe_requantize(float* values, float* n_state, int n, int m,
                        const uint32_t* keys_lo, const uint32_t* keys_hi,
                        const int32_t* table_rows, int size,
                        const uint32_t* sid_lo, const uint32_t* sid_hi,
                        int n_probe, const float* vals, const uint8_t* mask,
                        int T, const int32_t* order, const int32_t* nmask,
                        const int64_t* src, int n_src, int32_t* scratch,
                        cudaStream_t stream) {
  if (size <= 0) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.values = values;
  a.n_state = n_state;
  a.n = n;
  a.m = m;
  a.T = T;
  a.keys_lo = keys_lo;
  a.keys_hi = keys_hi;
  a.table_rows = table_rows;
  a.size = (uint32_t)size;
  a.sid_lo = sid_lo;
  a.sid_hi = sid_hi;
  a.n_probe = n_probe;
  a.vals = vals;
  a.mask = mask;
  a.order = order;
  a.nmask = nmask;
  a.src = src;
  a.n_src = n_src;
  return launch(a, scratch, stream);
}

}  // extern "C"
