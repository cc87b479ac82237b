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
//   warp     a warp a row, several rows a block, for a row that takes no
//            tuple, is no data-source row and holds no NaN, and whose
//            state is in order (below): its head is its state at weight
//            n / m as it stands, scanned (a lane a block of 16 at each
//            level), checked, its targets placed and gathered, all in the
//            warp's shared memory with no block barrier. Every other row
//            goes to the block list.
//   small    a persistent grid of blocks (256 threads) over the block
//            list, a row at a time: its state sorted in shared memory
//            (bitonic, on (value key, slot)) unless in order, merged with
//            its run (each tuple's place: its rank + the state entries <=
//            it; a state entry's: its rank + the tuples below it, a count
//            histogram), the blocked scan (a thread a block of 16 at each
//            level, then the prefixes down), checked, the m targets placed
//            and gathered, all in shared memory. A data-source row, a row
//            with a non-finite tuple or NaN state, and a row whose head
//            exceeds the block's room go to the big list.
//   big      a block (512 threads) a listed row, in turn, its head (or its
//            m + T entries) in that block's global scratch. A state above
//            kSharedM values (eps < 4 / 4,096) does not fit a small
//            block: then the small pass is not launched, every row is
//            big, and the state's sort and counts sit in the block's
//            global scratch too.
// Two checks on each row's own data decide its shortcuts on the card:
//   in order  the m state keys do not fall by slot: the sort on (key <<
//             32 | slot) is then the identity, and no stage runs (-0.0
//             beside 0.0 and +inf tops tie or rise in key order already);
//   rising    the head's midpoint ranks c[0, h) do not fall in key order,
//             nor do c[h - 1] and the tail's level sums over the levels
//             the positions [h, N) read, and the total is not below 0 (so
//             the targets rise with i): the halvings then give each
//             target's lower bound, so a team member places a run of
//             consecutive targets, the first by a lower bound over the
//             head and each next by walking on (a target past the head
//             lands in the tail: +inf, or the head's last entry where
//             N = h). Where a row does not rise (the masked tail's sums
//             are grouped otherwise than the head's), it runs the
//             halvings over its N virtual positions as before.
// Floats: __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn only, so no
// multiply-add is contracted and no division becomes a reciprocal's
// product; no float atomics: the same bytes on every run, equal to the
// plain version's.
//
// What bounds it on this card: its bytes (the stack read and written,
// 1,604 B a row at m = 400: 0.125 ms for 131,072 rows at 3.35 TB/s). The
// first design (a block a row, a sort and 17-step halvings for every row)
// took 4.26 ms in its small-row kernel, held up by each row's dependent
// steps; a row that takes no tuple and is in order now costs a warp a few
// hundred instructions and no barrier, and a rising row's targets about
// log2(h) + 2 shared reads each where the halvings took ceil(log2(N + 1))
// level loops.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "probe.cuh"
#include "row_sort.cuh"

namespace {

constexpr int kKeyThreads = 256;
constexpr int kSmallThreads = 256;
constexpr int kWarpRows = 8;           // rows a block of the warp pass, at most
constexpr size_t kMaxShared = 232448;  // dynamic shared memory a block, at most
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
  int32_t* misc;                 // [0]: the source flag, then the rows
                                 // by path (gk_requantize's comment)
  int32_t* big_list;             // [n]
  int32_t* block_list;           // [n]: rows for the small pass
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
// Sets *s_nan where a value is a NaN. With `check_order`, a state whose
// keys do not fall by slot is left as it stands: its pairs are sorted.
// Returns whether the sort ran.
__device__ bool sort_state(const Args& a, int r, uint64_t* s_pair,
                           uint32_t* s_val, int* s_nan,
                           bool check_order = false) {
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
  if (check_order) {
    bool in_order = true;
    for (int i = threadIdx.x; i < a.m - 1; i += blockDim.x)
      in_order = in_order && (s_pair[i] >> 32) <= (s_pair[i + 1] >> 32);
    if (__syncthreads_and(in_order)) return false;
  }
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
  return true;
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

// The threads that take a row: a block, or one warp of a block.
struct BlockTeam {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool all(bool x) const { return __syncthreads_and(x) != 0; }
};

struct WarpTeam {
  int lane;
  __device__ int rank() const { return lane; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool all(bool x) const { return __all_sync(kFull, x) != 0; }
};

// A head's weights: merged (hw), or a state's alone, all n / m.
struct HeadWeights {
  const float* hw;
  __device__ float operator()(int j) const { return hw[j]; }
};

struct StateWeight {
  float w;
  __device__ float operator()(int) const { return w; }
};

// The blocked scan of the head's weights w(0 .. h - 1) by a team:
// c[j] = cum[j] - 0.5 w(j) (the midpoint ranks), s_V[l] = level l's
// inclusive sum at the head's last entry (for levels past the last, the
// last's). lv holds levels 1, 2, ...
template <class Team, class Weights>
__device__ void team_scan(const Team& g, const Weights& w, float* c,
                          float* lv, int h, float* s_V) {
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
    float* out = l == 0 ? c : lv + off[l];
    const int groups = (cnt[l] + 15) / 16;
    for (int q = g.rank(); q < groups; q += g.size()) {
      const int b = q * 16;
      const int e = b + 16 < cnt[l] ? b + 16 : cnt[l];
      float s = l == 0 ? w(b) : out[b];
      out[b] = s;
      for (int i = b + 1; i < e; ++i) {
        s = __fadd_rn(s, l == 0 ? w(i) : out[i]);
        out[i] = s;
      }
      if (l < top) lv[off[l + 1] + q] = s;
    }
    g.sync();
  }
  // down: each block after the first takes the inclusive sum of the totals
  // before it
  for (int l = top - 1; l >= 1; --l) {
    float* A = lv + off[l];
    const float* U = lv + off[l + 1];
    for (int j = g.rank(); j < cnt[l]; j += g.size()) {
      if (j >= 16) A[j] = __fadd_rn(U[(j >> 4) - 1], A[j]);
    }
    g.sync();
  }
  for (int j = g.rank(); j < h; j += g.size()) {
    float v = c[j];
    if (top > 0 && j >= 16) v = __fadd_rn(lv[off[1] + (j >> 4) - 1], v);
    if (j == h - 1) s_V[0] = v;
    c[j] = __fsub_rn(v, __fmul_rn(0.5f, w(j)));
  }
  g.sync();
  if (g.rank() == 0) {
    for (int l = 1; l < kLevels; ++l)
      s_V[l] = l <= top ? lv[off[l] + cnt[l] - 1] : s_V[l - 1];
  }
  g.sync();
}

__device__ __forceinline__ uint32_t key_of(float x) {
  return sort_key(__float_as_uint(x));
}

// The level whose sum at the head's last entry a virtual position p >= h
// reads, of a row whose head holds h entries.
__device__ __forceinline__ int tail_level(long long p, int h) {
  long long j = p, last = h - 1;
  int l = 0;
  while ((j >> 4) != (last >> 4) && l < kLevels - 1) {
    j = (j >> 4) - 1;
    last >>= 4;
    ++l;
  }
  return l;
}

// The midpoint rank at virtual position p: the head's below h, else the
// level sum the position reads.
__device__ __forceinline__ float cum_at(long long p, int h, const float* c,
                                        const float* s_V) {
  return p < h ? c[p] : s_V[tail_level(p, h)];
}

// jnp.searchsorted's halvings of a target's key over the N virtual
// positions, clipped to N - 1.
__device__ __forceinline__ long long halvings(const Args& a, uint32_t kt,
                                              int h, const float* c,
                                              const float* s_V) {
  long long lo = 0, hi = a.N;
  for (int s = 0; s < a.steps; ++s) {
    const long long mid = (lo + hi) >> 1;
    if (kt <= key_of(cum_at(mid, h, c, s_V))) hi = mid;
    else lo = mid;
  }
  return hi < a.N - 1 ? hi : a.N - 1;
}

// The m searches and gathers of row r, and its new count (the big-row
// pass).
__device__ void search_row(const Args& a, int r, const uint32_t* hv,
                           const float* c, int h, const float* s_V,
                           float total) {
  float* out = a.values + (size_t)r * a.m;
  for (int i = threadIdx.x; i < a.m; i += blockDim.x) {
    const float tg = __fmul_rn(
        __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)a.m), total);
    const long long idx = halvings(a, key_of(tg), h, c, s_V);
    out[i] = __uint_as_float(idx < h ? hv[idx] : kInfBits);
  }
  if (threadIdx.x == 0) a.n_state[r] = total;
}

// The rising check: whether the row's midpoint ranks over its N virtual
// positions never fall in key order and its total is not below 0 (the
// targets (i + 0.5) / m * total then rise with i). The tail's positions
// read the level sums from tail_level(h) to tail_level(N - 1), each of
// those levels over a run of positions, in order.
template <class Team>
__device__ bool rising(const Args& a, const Team& g, const float* c, int h,
                       const float* s_V, float total) {
  bool ok = total >= 0.0f;
  for (int j = g.rank(); j < h - 1; j += g.size())
    ok = ok && key_of(c[j]) <= key_of(c[j + 1]);
  if (g.rank() == 0 && a.N > h) {
    uint32_t prev = key_of(c[h - 1]);
    const int last = tail_level(a.N - 1, h);
    for (int l = tail_level(h, h); l <= last; ++l) {
      const uint32_t k = key_of(s_V[l]);
      ok = ok && prev <= k;
      prev = k;
    }
  }
  return g.all(ok);
}

// Each target's new value into dst [m] (q [m]: (i + 0.5) / m). A rising
// row: a team member takes a run of consecutive targets, places the first
// at its lower bound over the head's keys and walks on for each next one;
// one past the head is +inf where the row has a tail, else the head's
// last entry. Otherwise the halvings, a target a member at a time.
template <class Team>
__device__ void place(const Args& a, const Team& g, const uint32_t* hv,
                      const float* c, int h, const float* s_V, float total,
                      const float* q, bool sweep, uint32_t* dst) {
  if (!sweep) {
    for (int i = g.rank(); i < a.m; i += g.size()) {
      const long long idx =
          halvings(a, key_of(__fmul_rn(q[i], total)), h, c, s_V);
      dst[i] = idx < h ? hv[idx] : kInfBits;
    }
    return;
  }
  const uint32_t past = a.N > h ? kInfBits : hv[h - 1];
  const int per = (a.m + g.size() - 1) / g.size();
  int i = g.rank() * per;
  const int end = i + per < a.m ? i + per : a.m;
  if (i >= end) return;
  uint32_t kt = key_of(__fmul_rn(q[i], total));
  int lo = 0, hi = h;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_of(c[mid]) < kt) lo = mid + 1;
    else hi = mid;
  }
  for (int p = lo;;) {
    dst[i] = p < h ? hv[p] : past;
    if (++i == end) break;
    kt = key_of(__fmul_rn(q[i], total));
    while (p < h && key_of(c[p]) < kt) ++p;
  }
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

// (i + 0.5) / m for i in [0, m): the targets' fractions, a block's.
__device__ void fill_fractions(const Args& a, float* q) {
  for (int i = threadIdx.x; i < a.m; i += blockDim.x)
    q[i] = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)a.m);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// rows without tuples: a warp a row, several rows a block
// ---------------------------------------------------------------------------

// A warp's row in shared memory: the state's bits by slot (sv), its
// midpoint ranks (c), the new values (ov), the scan's levels (lv) and the
// level sums (s_V).
struct WarpRow {
  uint32_t* sv;
  float* c;
  uint32_t* ov;
  float* lv;
  float* s_V;
};

__host__ __device__ inline size_t warp_row_bytes(int m, WarpRow* w,
                                                 unsigned char* base) {
  const size_t words = align16(4 * (size_t)m);
  const size_t lv = 3 * words;
  const size_t s_V = lv + align16(4 * (size_t)level_words(m));
  if (w != nullptr) {
    w->sv = reinterpret_cast<uint32_t*>(base);
    w->c = reinterpret_cast<float*>(base + words);
    w->ov = reinterpret_cast<uint32_t*>(base + 2 * words);
    w->lv = reinterpret_cast<float*>(base + lv);
    w->s_V = reinterpret_cast<float*>(base + s_V);
  }
  return s_V + align16(4 * kLevels);
}

// Rows a block of the warp pass: as many warps as fit beside the
// fractions, up to kWarpRows.
__host__ __device__ inline int warp_rows(int m) {
  const size_t room = (kMaxShared - align16(4 * (size_t)m)) /
                      warp_row_bytes(m, nullptr, nullptr);
  return room < 1 ? 1 : (room < kWarpRows ? (int)room : kWarpRows);
}

// A row that takes no tuple (its head is its state at weight n / m), is
// no data-source row, is not flagged, holds no NaN and is in order: its
// update on one warp. Every other row goes to the block list.
__global__ void __launch_bounds__(kWarpRows * 32)
gk_warp_kernel(const Args a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);
  fill_fractions(a, q);
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * rows + warp;
  if (r >= a.n) return;
  const WarpTeam g{(int)(threadIdx.x & 31)};
  const size_t per = warp_row_bytes(a.m, nullptr, nullptr);
  WarpRow s;
  warp_row_bytes(a.m, &s, smem + align16(4 * (size_t)a.m) + warp * per);
  float* row = a.values + (size_t)r * a.m;
  bool general = (a.T > 0 && a.run_end[r] != a.run_start[r]) ||
                 a.flag[r] != 0 || is_source(a.src, a.n_src, r);
  if (!general) {
    bool nan = false;
    for (int i = g.lane; i < a.m; i += 32) {
      const uint32_t u = __float_as_uint(row[i]);
      nan = nan || (u & 0x7fffffffu) > 0x7f800000u;
      s.sv[i] = u;
    }
    __syncwarp();
    bool in_order = true;
    for (int i = g.lane; i < a.m - 1; i += 32)
      in_order = in_order && sort_key(s.sv[i]) <= sort_key(s.sv[i + 1]);
    general = __any_sync(kFull, nan) || !__all_sync(kFull, in_order);
  }
  if (general) {
    if (g.lane == 0) a.block_list[atomicAdd(a.misc + 2, 1)] = r;
    return;
  }
  const float n0 = a.n_state[r];
  const float total = __fadd_rn(n0, 0.0f);
  team_scan(g, StateWeight{__fdiv_rn(n0, (float)a.m)}, s.c, s.lv, a.m,
            s.s_V);
  const bool sweep = rising(a, g, s.c, a.m, s.s_V, total);
  if (!sweep && g.lane == 0) atomicAdd(a.misc + 3, 1);
  place(a, g, s.sv, s.c, a.m, s.s_V, total, q, sweep, s.ov);
  __syncwarp();
  for (int i = g.lane; i < a.m; i += 32) row[i] = __uint_as_float(s.ov[i]);
  if (g.lane == 0) a.n_state[r] = total;
}

// ---------------------------------------------------------------------------
// small rows: the block list, a block a row, all in shared memory
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSmallThreads)
gk_small_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_V[kLevels];
  __shared__ int s_nan;
  Shared s;
  float* q = reinterpret_cast<float*>(
      smem + shared_bytes(a.m, a.P, a.cap, true, &s, smem));
  fill_fractions(a, q);
  const BlockTeam g;
  const int count = a.misc[2];
  for (int b = blockIdx.x; b < count; b += gridDim.x) {
    const int r = a.block_list[b];
    __syncthreads();               // the previous row's reads of s_nan
    if (threadIdx.x == 0) s_nan = 0;
    __syncthreads();
    const bool sorted = sort_state(a, r, s.pair, s.val, &s_nan, true);
    const int start = a.T > 0 ? a.run_start[r] : 0;
    const int k = a.T > 0 ? a.run_end[r] - start : 0;
    if (s_nan || a.flag[r] || is_source(a.src, a.n_src, r) ||
        a.m + k > a.cap) {
      if (threadIdx.x == 0) a.big_list[atomicAdd(a.misc + 1, 1)] = r;
      continue;
    }
    const float n0 = a.n_state[r];
    const float total = __fadd_rn(n0, (float)k);
    const Own own = {a.sort.srow != nullptr ? a.sort.perm : nullptr, start};
    merge_head(a, s.pair, s.val, a.m, own, k, __fdiv_rn(n0, (float)a.m),
               s.hv, s.hw, s.cnt);
    const int h = a.m + k;
    team_scan(g, HeadWeights{s.hw}, s.c, s.lv, h, s_V);
    const bool sweep = rising(a, g, s.c, h, s_V, total);
    if (threadIdx.x == 0) {
      if (!sweep) atomicAdd(a.misc + 4, 1);
      if (sorted) atomicAdd(a.misc + 5, 1);
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(s.cnt);   // merged: free
    place(a, g, s.hv, s.c, h, s_V, total, q, sweep, dst);
    __syncthreads();
    float* out = a.values + (size_t)r * a.m;
    for (int i = threadIdx.x; i < a.m; i += blockDim.x)
      out[i] = __uint_as_float(dst[i]);
    if (threadIdx.x == 0) a.n_state[r] = total;
  }
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
    team_scan(BlockTeam{}, HeadWeights{hw}, c, lv, h, s_V);
    search_row(a, r, hv, c, h, s_V, __fadd_rn(n0, (float)K));
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the launcher
// ---------------------------------------------------------------------------

// The scratch of a call, in int32 words from a 128-byte aligned base.
struct Layout {
  long long misc, run_start, run_end, flag, sort, key, rowt, big_list,
      block_list, big;
  long long zero_words;          // misc .. flag, zeroed each call
  long long state, stride, total;
  int blocks;                    // big blocks
};

Layout layout(int n, int m, int T) {
  Layout l;
  const long long N = (long long)m + T;
  l.misc = 0;                    // first: gk_requantize's comment
  l.run_start = l.misc + 32;
  l.run_end = l.run_start + sde::round32(n);
  l.flag = l.run_end + sde::round32(n);
  l.sort = l.flag + sde::round32((n + 3) / 4);
  l.zero_words = l.sort - l.misc;
  l.key = l.sort + (T > 0 ? sde::sort_words(T) : 0);
  l.rowt = l.key + sde::round32(T);
  l.big_list = l.rowt + sde::round32(T);
  l.block_list = l.big_list + sde::round32(n);
  l.big = l.block_list + sde::round32(n);
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
  a.block_list = scratch + l.block_list;
  a.big = reinterpret_cast<uint32_t*>(scratch + l.big);
  a.big_stride = l.stride;
  a.state_words = l.state;
  if (a.src == nullptr) a.n_src = 0;
  cudaError_t err = cudaMemsetAsync(scratch + l.misc, 0,
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
    const int rows = warp_rows(a.m);
    const size_t warp_smem = align16(4 * (size_t)a.m) +
                             rows * warp_row_bytes(a.m, nullptr, nullptr);
    const size_t small_smem =
        shared_bytes(a.m, a.P, a.cap, true, nullptr, nullptr) +
        align16(4 * (size_t)a.m);
    big_smem = shared_bytes(a.m, a.P, a.cap, false, nullptr, nullptr);
    err = cudaFuncSetAttribute(gk_warp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)warp_smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gk_small_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)small_smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gk_big_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)big_smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gk_small_kernel, kSmallThreads, small_smem);
    if (err != cudaSuccess) return (int)err;
    const long long fit = (long long)(per_sm < 1 ? 1 : per_sm) *
                          sde::sm_count();
    gk_warp_kernel<<<(a.n + rows - 1) / rows, rows * 32, warp_smem,
                     stream>>>(a, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gk_small_kernel<<<(int)(fit < a.n ? fit : a.n), kSmallThreads,
                      small_smem, stream>>>(a);
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
// scratch: gk_words(n, m, T) words, 128-byte aligned. After the call, its
// words 1 to 5 count the rows by path (with m <= kSharedM): [1] the
// big-row pass, [2] the block list (the warp pass's others, big rows
// among them), [3] warp rows and [4] block rows that ran the halvings
// (the rising check false), [5] block rows whose state was sorted.
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
