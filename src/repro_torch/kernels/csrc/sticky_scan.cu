// Sticky Sampling's stacked update for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package updates a Sticky Sampling stack
// with StickySampling.add_batch (src/repro/core/sticky.py:86, a lax.scan of
// _step over the batch) under the vmap of batched.stacked_update
// (src/repro/core/batched.py:92): every row steps through the whole batch,
// masked to its own tuples, so capacity x T steps a batch. A masked step
// is not a no-op there: it takes the bump check at the row's n_seen + 1
// (want_epoch above the epoch: every slot loses its geometric draw, slots
// at 0 or below are emptied, the epoch rises); only the count and the slot
// write are masked. A check at one count bumps at most once, so a row's
// steps come to:
//
//   every row:            the check at the batch's first step
//   row r in [0, n):      a check then a step for each tuple with
//                         mask & rows == r, in batch order
//   a data-source row:    the same for every tuple with mask
//   a walked row:         where its last tuple is not the batch's last,
//                         the check the step after it takes
//
// A step (the reference's _step after its check) on a table of cap slots
// (keys int32, -1 empty; counts float32) for item x arriving at count n:
// the first slot whose key is x gets count + 1; else, where the coin
// uniform01(x ^ n, seed + 1) is below 1 / exp2(epoch), the first empty
// slot gets key x and count + 1. The sentinel item (bits -1) "hits" the
// first empty slot, whose key stays empty.
//
// What order the steps act in is the result only in few places. Between
// two bumps a key changes only where an admitted miss takes the first
// empty slot, and every count changes only by __fadd_rn(c, 1). So, within
// such a stretch:
//   * an item in the table at the stretch's start hits its first slot
//     there every time;
//   * the misses admitted take the empty slots in slot order, one each, in
//     the order of their tuples: the a-th admission the a-th empty slot of
//     the stretch's start, while empty slots are left. An item's first
//     admitted tuple is its first miss whose coin admits it (a coin
//     depends only on the item and the tuple's count); its tuples before
//     do nothing, those after hit its slot;
//   * the sentinel adds to the empty slot the admissions before it left
//     first;
//   * a slot's adds commute: each stretch keeps an int32 count of them a
//     slot (`pend`), folded into the count before a bump and at the walk's
//     end, m adds as min(c + m, 2**24) where c is an integer in
//     [-2**24, 2**24] and one __fadd_rn at a time elsewhere (a fraction,
//     past 2**24, inf; a NaN keeps its payload, quieted, as the host's
//     float adds do). The walk's in-place bumps keep a NaN's payload too;
//     bump_kernel's first-step checks give the card's NaN, as torch does
//     on the card.
//   * once no slot is empty, no key changes until the next bump: every
//     tuple up to it is an independent lookup and an add.
// The bumps fall where they fell: a tuple's check reads its count, so a
// bump's place in the walk is known before the steps run (`due` at each
// count: counts near the int32 top wrap).
//
// The walk (sticky_walk_kernel<W>, blocks of W warps, W the most of 16,
// 8, 4 whose tables fit a block's shared memory): block b < S walks
// data-source row src[b] (a row listed twice is walked once) over the
// whole batch; each later warp takes the runs of sorted positions that
// start in its chunk of 32, one after another, each to its end. A walk's
// table sits in shared memory from its start to its end: keys, `pend`,
// an item -> first slot hash index (16-bit entries, rebuilt at a bump; a
// source block's four times as large, an eighth full at most) and
// the empty slots in slot order (`elist`, consumed from the front). One
// warp reads the row's keys in (`open_warp`), 16 loads in flight a lane,
// and indexes the slots that hold one in a pass of their own.
//   * A warp walks 32 tuples a group (`group`): each lane's count and its
//     check first; the lanes before the first due check at once: every
//     lane looks its item up; misses whose coin admits are matched by item
//     among the misses (__match_any_sync), each item's first such lane
//     takes the next empty slot by its rank among them (a ballot and
//     __popc), that item's later lanes hit it; then each lane adds one to
//     its slot's `pend` (the first lane's slot summed by a ballot). At a
//     due check: fold, bump, rebuild, and the group goes on from that lane.
//   * A data-source row's block takes the batch 1,024 positions a chunk:
//     each masked tuple's rank (a block prefix of ballots), its item into
//     `sx` by rank and the chunk's first due check. The ranks up to it (a
//     stretch, `stretch`) are spread over the block: each looks its item
//     up and a hit adds to `pend` at once (shared-memory atomicAdd, in no
//     order that matters). While some slot is empty, the misses whose
//     coin admits them go in rank order to warp 0, which places them 32
//     at a time as a group does; then every other miss hits the slot its
//     item took at an earlier rank, if it did, and a sentinel adds to the
//     empty slot the admissions before it left first. A bump at the due
//     check is taken by the block.
// There are no float atomics and no order that depends on scheduling, so
// the state equals the plain version (ref.sticky_scan_update) byte for
// byte.
//
// The two float functions are not computed here: want_epoch is a monotone
// step function of n and geo one of the uint32 hash h whose uniform01 is
// u, so the host hands over their steps (core/sticky.py: epoch_starts,
// geo_steps, built from the literal float32 functions on the CPU) and the
// admission limits 1 / exp2(e) as floats (inv_rates). The card then
// computes what the CPU computes, whatever its own log2f and logf give.
//
// Launches, on the caller's stream:
//   * (data-source rows) a memset and flag_kernel: a byte per row, set for
//     the source rows, whose routed tuples the grouping drops (their walk
//     takes every masked tuple anyway).
//   * key_kernel, or probe_key_kernel with the routing probe fused in
//     (sde::probe_row): each tuple's row, or -1 where it is masked,
//     unrouted, outside [0, n) or routed to a source row.
//   * The stable row sort (row_sort.cuh) into srow / perm and the count of
//     kept tuples, which stays on the card: the host never waits.
//   * bump_kernel: the batch's first check, a lane a row of the stack
//     (8 bytes a row), a warp decrementing each row that bumps.
//   * sticky_walk_kernel: the walks above.
//
// Bounds on this card. Bytes: the batch read once, every row's n_seen and
// epoch, each walked table's keys and each bumped table's counts read,
// each changed word written once. Operations: a group of 32 tuples that
// meets an empty slot hands its admissions' keys to the next group's
// lookups, a dependent chain of shared loads, a ballot and a store; the
// rest are independent lookups and adds.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "probe.cuh"
#include "row_sort.cuh"

namespace {

constexpr int kThreads = 256;     // flag, key and bump kernels
constexpr int kMaxWalkWarps = 16; // sticky_walk_kernel warps a block
constexpr int kChunk = 1024;      // a source block's batch positions a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = -1;    // the bits of 0xFFFFFFFF
constexpr unsigned kNoSlot = 0xffffu;   // an empty index entry
constexpr int kMaxCap = 4096;     // the reference's most slots a table
constexpr int kMaxEpochs = 32;
constexpr int kMaxGeo = 64;
constexpr int kMaxRateEpoch = 128;
constexpr float kUScale = 2.3283064365386963e-10f;   // uniform01's 2**-32
constexpr float kExactTop = 16777216.0f;   // 2**24: c + 1 exact below it

// The tables of the float functions, as the wrapper packs them in int32
// words: the epochs k = 1 .. n_epochs each count reaches from start[k - 1]
// on; the hash thresholds geo_at (ascending), geo being geo_val[i] for the
// number i of thresholds <= h; the admission limit inv_rate[e] =
// 1 / exp2(e) for e = 0 .. kMaxRateEpoch (0 from there on).
struct Tables {
  int32_t n_epochs;
  int32_t n_geo;
  int32_t start[kMaxEpochs];
  uint32_t geo_at[kMaxGeo];
  float geo_val[kMaxGeo + 1];
  float inv_rate[kMaxRateEpoch + 1];
};
constexpr int kTableWords = sizeof(Tables) / 4;

// Every thread of the block copies its share, then waits for the rest.
__device__ __forceinline__ void load_tables(Tables& tb,
                                            const int32_t* __restrict__ w) {
  int32_t* const d = reinterpret_cast<int32_t*>(&tb);
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) d[i] = w[i];
  __syncthreads();
}

// want_epoch(n): the epochs whose start n has reached.
__device__ __forceinline__ int want_of(const Tables& tb, int32_t n) {
  int k = 0;
  while (k < tb.n_epochs && n >= tb.start[k]) ++k;
  return k;
}

// want_epoch(n) > e: the check at count n bumps a row at epoch e.
__device__ __forceinline__ bool due(const Tables& tb, int32_t n, int e) {
  return e < 0 || (e < tb.n_epochs && n >= tb.start[e]);
}

// geo of uniform01's float of hash h: the number of thresholds <= h, by
// a search of fixed steps (unrolled, so that a loop over slots keeps
// several in flight).
__device__ __forceinline__ float geo_of(const Tables& tb, uint32_t h) {
  int lo = 0;
#pragma unroll
  for (int step = kMaxGeo; step > 0; step >>= 1) {
    if (lo + step <= tb.n_geo && tb.geo_at[lo + step - 1] <= h) lo += step;
  }
  return tb.geo_val[lo];
}

// The coin of item x at count n below the limit of epoch e (e >= 0).
__device__ __forceinline__ bool admits(const Tables& tb, int32_t x,
                                       uint32_t n, int e,
                                       uint32_t coin_mix) {
  const uint32_t h = sde::mix32(((uint32_t)x ^ n) ^ coin_mix);
  const float u = __fmul_rn(__uint2float_rn(h), kUScale);
  return u < tb.inv_rate[e < kMaxRateEpoch ? e : kMaxRateEpoch];
}

// A bump at count n of a table in device memory (bump_kernel): slot j
// loses the geo of hash(j ^ n, seed), floored at 0; a slot left at 0 or
// below is emptied. Every lane of the warp calls it.
__device__ __forceinline__ void bump_table(int32_t* keys, float* counts,
                                           int cap, uint32_t n,
                                           const Tables& tb,
                                           uint32_t geo_mix) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int j = lane; j < cap; j += 32) {
    const uint32_t h = sde::mix32(((uint32_t)j ^ n) ^ geo_mix);
    const float d = __fsub_rn(counts[j], geo_of(tb, h));
    const float c = d < 0.0f ? 0.0f : d;
    counts[j] = c;
    if (c <= 0.0f) keys[j] = kEmpty;
  }
  __syncwarp();
}

// A NaN as the host's float arithmetic returns it from one NaN operand:
// its payload, quieted.
__device__ __forceinline__ float host_nan(float c) {
  return __int_as_float(__float_as_int(c) | 0x00400000);
}

// m > 0 adds of 1.0f (__fadd_rn, one after another) to c.
__device__ __forceinline__ float add_ones(float c, int m) {
  while (m > 0) {
    if (c != c) return host_nan(c);
    if (fabsf(c) <= kExactTop && c == truncf(c)) {
      const long long s = (long long)c + m;
      return s >= (1LL << 24) ? kExactTop : (float)s;
    }
    const float d = __fadd_rn(c, 1.0f);
    if (d == c) return c;               // every later add returns it too
    c = d;
    --m;
  }
  return c;
}

__global__ void flag_kernel(const int32_t* __restrict__ src, int n_src,
                            int n, uint8_t* __restrict__ flag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_src) {
    const int32_t r = src[i];
    if (r >= 0 && r < n) flag[r] = 1;
  }
}

__device__ __forceinline__ int32_t key_of(int32_t r, bool masked, int n,
                                          const uint8_t* __restrict__ flag) {
  const bool keep = masked && r >= 0 && r < n &&
                    (flag == nullptr || flag[r] == 0);
  return keep ? r : -1;
}

__global__ void key_kernel(const int32_t* __restrict__ rows,
                           const uint8_t* __restrict__ mask, int T, int n,
                           const uint8_t* __restrict__ flag,
                           int32_t* __restrict__ key) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  key[t] = key_of(rows[t], mask[t] != 0, n, flag);
}

// The routing probe fused in: a masked tuple's row is the table's for its
// stream id (lo, hi); an unmasked one probes nothing.
__global__ void probe_key_kernel(const uint32_t* __restrict__ keys_lo,
                                 const uint32_t* __restrict__ keys_hi,
                                 const int32_t* __restrict__ trows,
                                 uint32_t size,
                                 const uint32_t* __restrict__ sid_lo,
                                 const uint32_t* __restrict__ sid_hi,
                                 int n_probe,
                                 const uint8_t* __restrict__ mask, int T,
                                 int n, const uint8_t* __restrict__ flag,
                                 int32_t* __restrict__ key) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const bool masked = mask[t] != 0;
  const int32_t r = masked ? sde::probe_row(keys_lo, keys_hi, trows, size,
                                            sid_lo[t], sid_hi[t], n_probe)
                           : -1;
  key[t] = key_of(r, masked, n, flag);
}

// The batch's first check on every row: a lane a row; the warp decrements
// each row whose check bumps, in device memory.
__global__ void __launch_bounds__(kThreads)
bump_kernel(int32_t* __restrict__ keys, float* __restrict__ counts,
            const int32_t* __restrict__ n_seen, int32_t* __restrict__ epoch,
            int n, int cap, const int32_t* __restrict__ tables,
            uint32_t geo_mix) {
  __shared__ Tables tb;
  load_tables(tb, tables);
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool bump = false;
  uint32_t nr = 0;
  if (r < n) {
    nr = (uint32_t)n_seen[r] + 1u;
    bump = due(tb, (int32_t)nr, epoch[r]);
  }
  unsigned todo = __ballot_sync(kFull, bump);
  while (todo != 0u) {
    const int s = __ffs(todo) - 1;
    todo &= todo - 1u;
    const long long row = __shfl_sync(kFull, r, s);
    const uint32_t ns = __shfl_sync(kFull, nr, s);
    bump_table(keys + row * cap, counts + row * cap, cap, ns, tb, geo_mix);
  }
  if (bump) epoch[r] = want_of(tb, (int32_t)nr);
}

__host__ __device__ __forceinline__ int round4(int x) {
  return (x + 3) & ~3;
}

// The hash index of a table of cap slots: a power of two of at least
// `spread` cap entries (and 32), 16 bits each: kRunSpread for a routed
// walk, kSourceSpread for a source block's walk, which looks up every
// masked tuple of the batch and has the room (a miss probes ~1 entry at
// an eighth full, ~2.5 at a half).
constexpr int kRunSpread = 2, kSourceSpread = 8;
__host__ __device__ __forceinline__ int index_bits(int cap, int spread) {
  int b = 5;
  while ((1 << b) < spread * cap) ++b;
  return b;
}

// A walk's shared memory, in int32 words: keys and pend [round4(cap)]
// each, the index [2^index_bits] (two entries a word), elist
// [round8(cap)] (two a word); every part 16-byte aligned.
__host__ __device__ __forceinline__ int walk_words(int cap, int spread) {
  return 2 * round4(cap) + (1 << (index_bits(cap, spread) - 1)) +
         round4((cap + 1) / 2);
}

// A source block's: its walk, then a chunk's items by rank (`sx`), its
// admitting misses' ranks in order (`clist`), its admissions' ranks in
// order (`arank`) [kChunk] each, each rank's class (`scls`, a byte), the
// prefix's 32 counts and the block's shared walk state.
struct BlockState {
  int epoch;
  int n_empty;
  int eo;
  int bumped;
  int dmin[2];    // a chunk's first due rank, by the chunk's parity
  int dscan;      // the first due rank from a bump on
  int last;       // the batch position of the walk's last tuple, or -1
};
__host__ __device__ __forceinline__ int source_words(int cap) {
  return walk_words(cap, kSourceSpread) + 3 * kChunk + kChunk / 4 + 32 +
         (int)(sizeof(BlockState) / 4);
}

// Threads that share a table: a warp (tid = lane) or a whole block.
struct Team {
  int tid, nt;
  bool block;
  __device__ __forceinline__ void sync() const {
    if (block) __syncthreads();
    else __syncwarp();
  }
};

// One walk's table (shared memory) and its state row (device memory).
struct Table {
  int cap;
  int32_t* key;
  int32_t* pend;
  unsigned short* idx;
  int16_t* elist;
  unsigned imask;
  int ishift;
  int32_t* keys;      // the state row's
  float* counts;

  __device__ __forceinline__ void attach(int32_t* smem, int cap_,
                                         int spread) {
    cap = cap_;
    const int b = index_bits(cap_, spread);
    key = smem;
    pend = smem + round4(cap_);
    idx = reinterpret_cast<unsigned short*>(smem + 2 * round4(cap_));
    elist = reinterpret_cast<int16_t*>(smem + 2 * round4(cap_) +
                                       (1 << (b - 1)));
    imask = (1u << b) - 1u;
    ishift = 32 - b;
  }

  __device__ __forceinline__ unsigned hslot(int32_t x) const {
    return ((uint32_t)x * 0x9E3779B1u) >> ishift;
  }

  // The first slot whose key is x (not the sentinel), or -1: the index
  // probed from entry h on.
  __device__ __forceinline__ int lookup_from(int32_t x, unsigned h) const {
    while (true) {
      const unsigned s = idx[h];
      if (s == kNoSlot) return -1;
      if (key[s] == x) return (int)s;
      h = (h + 1u) & imask;
    }
  }

  __device__ __forceinline__ int lookup(int32_t x) const {
    return lookup_from(x, hslot(x));
  }

  // lookup() of K items at once (the sentinel and empty ranks: -1): every
  // first probe issued together, the rare longer ones after.
  template <int K>
  __device__ __forceinline__ void lookup_all(const int32_t* x, int* s) const {
    unsigned h[K], e[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      h[u] = hslot(x[u]);
      e[u] = idx[h[u]];
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int32_t k = e[u] != kNoSlot ? key[e[u]] : kEmpty;
      s[u] = x[u] == kEmpty || e[u] == kNoSlot ? -1
             : k == x[u] ? (int)e[u]
                         : lookup_from(x[u], (h[u] + 1u) & imask);
    }
  }

  // Slot j's key x into the index: its entry keeps the key's least slot.
  // Two entries share a word, written by a compare-and-swap of the word.
  __device__ __forceinline__ void insert(int32_t x, int j) {
    unsigned h = hslot(x);
    unsigned* const words = reinterpret_cast<unsigned*>(idx);
    while (true) {
      unsigned* const word = words + (h >> 1);
      const int sh = (int)(h & 1u) * 16;
      const unsigned part = 0xffffu << sh;
      unsigned old = *reinterpret_cast<volatile unsigned*>(word);
      bool next = false;
      while (!next) {
        const unsigned cur = (old & part) >> sh;
        if (cur != kNoSlot && (key[cur] != x || cur <= (unsigned)j)) {
          if (key[cur] == x) return;          // held at a slot no later
          next = true;                        // another key: probe on
          continue;
        }
        const unsigned was =
            atomicCAS(word, old, (old & ~part) | ((unsigned)j << sh));
        if (was == old) return;
        old = was;
      }
      h = (h + 1u) & imask;
    }
  }

  // The empty slots in slot order into elist, by one warp; returns their
  // number to every lane.
  __device__ __forceinline__ int make_elist() {
    const int lane = threadIdx.x & 31;
    const unsigned lt = (1u << lane) - 1u;
    int base = 0;
    for (int r = 0; r < cap; r += 32) {
      const int j = r + lane;
      const bool e = j < cap && key[j] == kEmpty;
      const unsigned b = __ballot_sync(kFull, e);
      if (e) elist[base + __popc(b & lt)] = (int16_t)j;
      base += __popc(b);
    }
    return base;
  }

  // The index anew from the keys (the team), and elist by its first warp,
  // whose lanes get the number of empty slots; the team waits for both.
  __device__ __forceinline__ int reindex(const Team& t) {
    int4* const w4 = reinterpret_cast<int4*>(idx);
    const int n4 = (int)((imask + 1u) >> 3);
    for (int i = t.tid; i < n4; i += t.nt) w4[i] = make_int4(-1, -1, -1, -1);
    t.sync();
    int ne = 0;
    if (t.tid < 32) ne = make_elist();
    for (int j = t.tid; j < cap; j += t.nt) {
      const int32_t x = key[j];
      if (x != kEmpty) insert(x, j);
    }
    t.sync();
    return ne;
  }

  // The state row a walk takes (every thread of its team).
  __device__ __forceinline__ void bind(int32_t* keys_all, float* counts_all,
                                       int row) {
    keys = keys_all + (long long)row * cap;
    counts = counts_all + (long long)row * cap;
  }

  // The walk's start, by one warp in one pass over the row's keys,
  // kOpenLoads rounds of 32 in flight a lane: each key into the table,
  // each empty slot into elist from the front and each other slot from
  // the back (the walk takes elist's slots only from the front, at most
  // its empty ones); then the keys of those other slots into the index.
  // pend is 0 here: it starts so and each fold clears what it takes.
  // Returns the number of empty slots.
  __device__ __forceinline__ int open_warp() {
    constexpr int kOpenLoads = 16;
    const int lane = threadIdx.x & 31;
    const unsigned lt = (1u << lane) - 1u;
    int4* const w4 = reinterpret_cast<int4*>(idx);
    const int n4 = (int)((imask + 1u) >> 3);
    for (int i = lane; i < n4; i += 32) w4[i] = make_int4(-1, -1, -1, -1);
    int ne = 0, nk = 0;
    for (int r0 = 0; r0 < cap; r0 += 32 * kOpenLoads) {
      int32_t k[kOpenLoads];
#pragma unroll
      for (int u = 0; u < kOpenLoads; ++u) {
        const int j = r0 + 32 * u + lane;
        k[u] = j < cap ? keys[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < kOpenLoads; ++u) {
        const int j = r0 + 32 * u + lane;
        const bool e = j < cap && k[u] == kEmpty;
        const bool f = j < cap && k[u] != kEmpty;
        const unsigned be = __ballot_sync(kFull, e);
        const unsigned bf = __ballot_sync(kFull, f);
        if (j < cap) key[j] = k[u];
        if (e) elist[ne + __popc(be & lt)] = (int16_t)j;
        if (f) elist[cap - 1 - nk - __popc(bf & lt)] = (int16_t)j;
        ne += __popc(be);
        nk += __popc(bf);
      }
    }
    __syncwarp();                       // an insert reads others' keys
    for (int i = lane; i < nk; i += 32) {
      const int j = elist[cap - 1 - i];
      insert(key[j], j);
    }
    __syncwarp();
    return ne;
  }

  // Each slot's pending adds into its count (pend read 4 slots a load;
  // its padding past cap stays 0).
  __device__ __forceinline__ void fold(const Team& t) {
    int4* const p4 = reinterpret_cast<int4*>(pend);
    for (int q = t.tid; q < round4(cap) / 4; q += t.nt) {
      const int4 v = p4[q];
      if ((v.x | v.y | v.z | v.w) == 0) continue;
      const int m[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m[i] != 0) counts[4 * q + i] = add_ones(counts[4 * q + i], m[i]);
      }
      p4[q] = make_int4(0, 0, 0, 0);
    }
  }

  // A bump at count n after a fold (bump_table's, a NaN kept as the host
  // keeps it), kBumpLoads slots' counts a thread in flight.
  __device__ __forceinline__ void bump(uint32_t n, const Tables& tb,
                                       uint32_t geo_mix, const Team& t) {
    constexpr int kBumpLoads = 8;
    for (int j0 = t.tid; j0 < cap; j0 += kBumpLoads * t.nt) {
      float c0[kBumpLoads];
#pragma unroll
      for (int u = 0; u < kBumpLoads; ++u) {
        const int j = j0 + u * t.nt;
        c0[u] = j < cap ? counts[j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBumpLoads; ++u) {
        const int j = j0 + u * t.nt;
        if (j >= cap) break;
        const uint32_t h = sde::mix32(((uint32_t)j ^ n) ^ geo_mix);
        const float d = c0[u] != c0[u] ? host_nan(c0[u])
                                       : __fsub_rn(c0[u], geo_of(tb, h));
        const float c = d < 0.0f ? 0.0f : d;
        counts[j] = c;
        if (c <= 0.0f) key[j] = kEmpty;
      }
    }
  }

  // The keys back to the state row: every slot after a bump, else the
  // slots the walk's admissions took (elist[0, eo)).
  __device__ __forceinline__ void write_keys(bool bumped, int eo,
                                             const Team& t) const {
    if (bumped) {
      for (int j = t.tid; j < cap; j += t.nt) keys[j] = key[j];
    } else {
      for (int i = t.tid; i < eo; i += t.nt) {
        const int j = elist[i];
        keys[j] = key[j];
      }
    }
  }
};

// A walk's state, alike in every lane of its warp.
struct Walk {
  uint32_t n_seen;
  int epoch;
  int n_empty;    // elist's length
  int eo;         // elist's slots taken
  bool bumped;
};

// The lanes of `sub` of a group, on the table as it stands (no check of
// theirs is due): each finds its item's slot, the misses whose coin
// admits take empty slots (each item's first such lane, in lane order),
// the sentinel its empty slot, and each lane with a slot adds one to its
// pend. With `arank`, each admission's `rank` goes to arank[its index in
// elist - abase].
__device__ __forceinline__ void place(Table& tab, Walk& w, const Tables& tb,
                                      int32_t x, uint32_t n, unsigned sub,
                                      uint32_t coin_mix,
                                      int32_t* arank = nullptr,
                                      int abase = 0, int rank = 0) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const bool mine = (sub >> lane) & 1u;
  const bool sent = mine && x == kEmpty;
  int slot = (mine && !sent) ? tab.lookup(x) : -1;
  const bool miss = mine && !sent && slot < 0;
  const int room = w.n_empty - w.eo;
  if (room > 0 && __any_sync(kFull, miss || sent)) {
    const bool coin = miss && admits(tb, x, n, w.epoch, coin_mix);
    const unsigned misses = __ballot_sync(kFull, miss);
    const unsigned cands = __ballot_sync(kFull, coin);
    unsigned same = 0u;
    if (miss) same = __match_any_sync(misses, x);
    const unsigned mc = same & cands;
    const int lead = mc != 0u ? __ffs(mc) - 1 : -1;
    const bool leader = miss && lead == lane;
    const unsigned leaders = __ballot_sync(kFull, leader);
    const int r = __popc(leaders & lt);       // admissions before the lane
    if (leader) {
      slot = r < room ? tab.elist[w.eo + r] : -1;
      if (slot >= 0) {
        tab.key[slot] = x;
        tab.insert(x, slot);
        if (arank != nullptr) arank[w.eo + r - abase] = rank;
      }
    }
    const int got = __shfl_sync(kFull, slot, lead >= 0 ? lead : lane);
    if (miss && !leader && lead >= 0 && lane > lead) slot = got;
    if (sent) slot = r < room ? tab.elist[w.eo + r] : -1;
    const int took = __popc(leaders);
    w.eo += took < room ? took : room;
  }
  const int s0 = __shfl_sync(kFull, slot, __ffs(sub) - 1);
  const unsigned agg = __ballot_sync(kFull, slot >= 0 && slot == s0);
  if (slot >= 0 && slot != s0) atomicAdd(&tab.pend[slot], 1);
  if (agg != 0u && lane == __ffs(agg) - 1)
    atomicAdd(&tab.pend[s0], __popc(agg));
  __syncwarp();
}

// A group: lanes 0 .. cnt - 1 hold a walk's next tuples (items x), lane 0
// the one at count n_first. Each lane's check comes first; the lanes
// before the first due check are placed at once, then the table is
// folded, bumped and indexed anew, and the group goes on from that lane.
__device__ __forceinline__ void group(Table& tab, Walk& w, const Tables& tb,
                                      int32_t x, int cnt, uint32_t n_first,
                                      uint32_t geo_mix, uint32_t coin_mix) {
  const int lane = threadIdx.x & 31;
  const uint32_t n = n_first + (uint32_t)lane;
  const Team warp{lane, 32, false};
  unsigned todo = cnt >= 32 ? kFull : (1u << cnt) - 1u;
  while (true) {
    const bool mine = (todo >> lane) & 1u;
    const unsigned dm =
        __ballot_sync(kFull, mine && due(tb, (int32_t)n, w.epoch));
    const int b = dm != 0u ? __ffs(dm) - 1 : 32;
    const unsigned sub = b < 32 ? todo & ((1u << b) - 1u) : todo;
    if (sub != 0u) place(tab, w, tb, x, n, sub, coin_mix);
    if (b == 32) return;
    const uint32_t nb = n_first + (uint32_t)b;
    tab.fold(warp);
    __syncwarp();
    tab.bump(nb, tb, geo_mix, warp);
    __syncwarp();
    w.epoch = want_of(tb, (int32_t)nb);
    w.bumped = true;
    w.n_empty = tab.reindex(warp);
    w.eo = 0;
    todo &= ~((1u << b) - 1u);
  }
}

// The check after a walk's last tuple (at batch position last) where that
// is not the batch's last, after the fold; then the keys, n_seen and
// epoch back to the state row. The team's threads all call it.
__device__ __forceinline__ void close_walk(Table& tab, Walk& w, int32_t last,
                                           int T, const Tables& tb,
                                           uint32_t geo_mix,
                                           int32_t* n_seen_all,
                                           int32_t* epoch_all, int row,
                                           const Team& t) {
  tab.fold(t);
  t.sync();
  if (last >= 0 && last < T - 1) {
    const uint32_t nc = w.n_seen + 1u;
    if (due(tb, (int32_t)nc, w.epoch)) {
      tab.bump(nc, tb, geo_mix, t);
      t.sync();
      w.epoch = want_of(tb, (int32_t)nc);
      w.bumped = true;
    }
  }
  tab.write_keys(w.bumped, w.eo, t);
  if (t.tid == 0) {
    n_seen_all[row] = (int32_t)w.n_seen;
    epoch_all[row] = w.epoch;
  }
  t.sync();
}

// The first rank in [r0, total) whose check is due at epoch e, or total:
// the whole block.
__device__ __forceinline__ int due_from(BlockState& bs, const Tables& tb,
                                        int r0, int total, uint32_t n0,
                                        int e) {
  if (threadIdx.x == 0) bs.dscan = INT_MAX;
  __syncthreads();
  int dm = INT_MAX;
  for (int r = r0 + (int)threadIdx.x; r < total; r += blockDim.x)
    if (due(tb, (int32_t)(n0 + 1u + (uint32_t)r), e)) dm = min(dm, r);
  dm = __reduce_min_sync(kFull, dm);
  if ((threadIdx.x & 31) == 0 && dm != INT_MAX) atomicMin(&bs.dscan, dm);
  __syncthreads();
  return min(bs.dscan, total);
}

// A source block's buffers for a chunk (in its shared memory).
struct Chunk {
  int32_t* sx;
  int32_t* clist;
  int32_t* arank;
  int8_t* scls;
  int32_t* tot;
};
constexpr int8_t kDone = 0, kMiss = 1, kCand = 2, kSent = 3;

// The least i in [0, m) with a[i] >= v (a ascending), or m.
template <class T>
__device__ __forceinline__ int lower_bound(const T* a, int m, int v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int)a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The ranks [r0, r1) of a chunk (sx, counts n0 + 1 + rank), no check due
// among them, by the whole block. Where no slot is empty, each rank is a
// lookup and an add. Else: (1) every rank looks its item up on the table
// as it stands; a hit adds at once (its slot is fixed until the next
// bump); a miss whose coin admits it is a candidate; (2) the candidates'
// ranks in order (a block prefix) into clist; (3) warp 0 walks clist 32
// at a time (`place`: each item's first candidate takes the next empty
// slot while one is left, its later ones hit it), each admission's rank
// into arank; (4) every other miss hits the slot its item took at an
// earlier rank, if it did, and a sentinel adds to the empty slot the
// admissions before it left first.
template <int W>
__device__ __forceinline__ void stretch(Table& tab, BlockState& bs,
                                        const Tables& tb, const Chunk& ck,
                                        int r0, int r1, uint32_t n0,
                                        uint32_t coin_mix) {
  constexpr int NT = 32 * W, K = 32 / W;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int e = bs.epoch, eo0 = bs.eo, n_empty = bs.n_empty;
  int32_t x[K];
  int s[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int r = r0 + j * NT + tid;
    x[j] = r < r1 ? ck.sx[r] : kEmpty;
  }
  tab.lookup_all<K>(x, s);
  if (n_empty == eo0) {                         // a full table
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (s[j] >= 0) atomicAdd(&tab.pend[s[j]], 1);
    return;
  }
  unsigned cbal[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {                 // (1)
    const int r = r0 + j * NT + tid;
    bool cand = false;
    if (r < r1) {
      int8_t cls = kSent;
      if (s[j] >= 0) {
        atomicAdd(&tab.pend[s[j]], 1);
        cls = kDone;
      } else if (x[j] != kEmpty) {
        cand = admits(tb, x[j], n0 + 1u + (uint32_t)r, e, coin_mix);
        cls = cand ? kCand : kMiss;
      }
      ck.scls[r] = cls;
    }
    cbal[j] = __ballot_sync(kFull, cand);
    if (lane == 0) ck.tot[j * W + wid] = __popc(cbal[j]);
  }
  __syncthreads();
  const int v = ck.tot[lane];                   // (2)
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int nc = __shfl_sync(kFull, incl, 31);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int excl = __shfl_sync(kFull, incl - v, j * W + wid);
    if ((cbal[j] >> lane) & 1u)
      ck.clist[excl + __popc(cbal[j] & lt)] = r0 + j * NT + tid;
  }
  __syncthreads();
  if (wid == 0) {                               // (3)
    Walk w{0u, e, n_empty, eo0, bs.bumped != 0};
    for (int i = 0; i < nc; i += 32) {
      const int cnt = nc - i < 32 ? nc - i : 32;
      const int r = lane < cnt ? ck.clist[i + lane] : 0;
      const int32_t x = lane < cnt ? ck.sx[r] : 0;
      place(tab, w, tb, x, n0 + 1u + (uint32_t)r,
            cnt >= 32 ? kFull : (1u << cnt) - 1u, coin_mix, ck.arank, eo0,
            r);
    }
    if (lane == 0) bs.eo = w.eo;
  }
  __syncthreads();
  const int na = bs.eo - eo0;                   // (4)
  for (int r = r0 + tid; r < r1; r += NT) {
    const int8_t cls = ck.scls[r];
    int s = -1;
    if (cls == kMiss && na > 0) {
      s = tab.lookup(ck.sx[r]);
      if (s >= 0 &&
          ck.arank[lower_bound(tab.elist + eo0, na, s)] > r)
        s = -1;                                 // taken after this rank
    } else if (cls == kSent) {
      const int a = eo0 + lower_bound(ck.arank, na, r);
      s = a < n_empty ? tab.elist[a] : -1;
    }
    if (s >= 0) atomicAdd(&tab.pend[s], 1);
  }
}

// A data-source row's walk over every masked tuple of the batch, by the
// block (W warps, K positions a thread a chunk).
template <int W>
__device__ __forceinline__ void source_walk(
    Table& tab, int32_t* smem, int row, int32_t* keys_all,
    float* counts_all, int32_t* n_seen_all, int32_t* epoch_all,
    const int32_t* __restrict__ items, const uint8_t* __restrict__ mask,
    int T, const Tables& tb, uint32_t geo_mix, uint32_t coin_mix) {
  constexpr int NT = 32 * W, K = 32 / W, CH = NT * K;
  static_assert(CH == kChunk, "a chunk is 32 (round, warp) counts");
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const Team team{tid, NT, true};
  int32_t* const sx = smem + walk_words(tab.cap, kSourceSpread);
  const Chunk ck{sx, sx + kChunk, sx + 2 * kChunk,
                 reinterpret_cast<int8_t*>(sx + 3 * kChunk),
                 sx + 3 * kChunk + kChunk / 4};
  int32_t* const tot = ck.tot;
  BlockState& bs = *reinterpret_cast<BlockState*>(tot + 32);
  for (int j = tid; j < round4(tab.cap); j += NT) tab.pend[j] = 0;
  tab.bind(keys_all, counts_all, row);
  const int ne = wid == 0 ? tab.open_warp() : 0;
  if (tid == 0) {
    bs.epoch = epoch_all[row];
    bs.n_empty = ne;
    bs.eo = 0;
    bs.bumped = 0;
    bs.dmin[0] = bs.dmin[1] = INT_MAX;
    bs.last = -1;
  }
  uint32_t n0 = (uint32_t)n_seen_all[row];
  int lastp = -1;
  bool ok[K];
  int32_t x[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int p = u * NT + tid;
    ok[u] = p < T && mask[p] != 0;
    x[u] = p < T ? items[p] : 0;
  }
  __syncthreads();
  int k = 0;
  for (long long c0 = 0; c0 < T; c0 += CH, ++k) {
    unsigned bal[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      bal[u] = __ballot_sync(kFull, ok[u]);
      if (lane == 0) tot[u * W + wid] = __popc(bal[u]);
      if (ok[u]) lastp = (int)c0 + u * NT + tid;
    }
    __syncthreads();                            // the counts are in
    const int v = tot[lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int e0 = bs.epoch;
    int dm = INT_MAX;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int i = u * W + wid;
      const int excl = __shfl_sync(kFull, incl - v, i);
      if (ok[u]) {
        const int r = excl + __popc(bal[u] & lt);
        sx[r] = x[u];
        if (due(tb, (int32_t)(n0 + 1u + (uint32_t)r), e0)) dm = min(dm, r);
      }
    }
    dm = __reduce_min_sync(kFull, dm);
    if (lane == 0 && dm != INT_MAX) atomicMin(&bs.dmin[k & 1], dm);
    if (tid == 0) bs.dmin[(k + 1) & 1] = INT_MAX;
#pragma unroll
    for (int u = 0; u < K; ++u) {               // the next chunk's tuples
      const long long p = c0 + CH + u * NT + tid;
      ok[u] = p < T && mask[p] != 0;
      x[u] = p < T ? items[p] : 0;
    }
    __syncthreads();                            // sx and the first due
    if (total == 0) continue;
    int b = min(bs.dmin[k & 1], total);
    int rstart = 0;
    while (true) {
      stretch<W>(tab, bs, tb, ck, rstart, b, n0, coin_mix);
      if (b >= total) break;
      __syncthreads();
      tab.fold(team);
      __syncthreads();
      const uint32_t nb = n0 + 1u + (uint32_t)b;
      tab.bump(nb, tb, geo_mix, team);
      __syncthreads();
      const int ne2 = tab.reindex(team);
      const int e = want_of(tb, (int32_t)nb);
      if (tid == 0) {
        bs.n_empty = ne2;
        bs.eo = 0;
        bs.epoch = e;
        bs.bumped = 1;
      }
      rstart = b;
      b = due_from(bs, tb, rstart, total, n0, e);
    }
    n0 += (uint32_t)total;
  }
  if (lastp >= 0) atomicMax(&bs.last, lastp);
  __syncthreads();
  Walk w{n0, bs.epoch, bs.n_empty, bs.eo, bs.bumped != 0};
  close_walk(tab, w, bs.last, T, tb, geo_mix, n_seen_all, epoch_all, row,
             team);
}

// The runs of sorted positions that start in chunk c (32 positions), one
// after another, each to its end, by one warp: 128 positions a load.
__device__ __forceinline__ void run_walks(
    Table& tab, long long c, int32_t* keys_all, float* counts_all,
    int32_t* n_seen_all, int32_t* epoch_all,
    const int32_t* __restrict__ items, int T,
    const int32_t* __restrict__ srow, const int32_t* __restrict__ perm,
    long long len, const Tables& tb, uint32_t geo_mix, uint32_t coin_mix) {
  const int lane = threadIdx.x & 31;
  const Team warp{lane, 32, false};
  const long long c0 = c * 32;
  if (c0 >= len) return;
  for (int j = lane; j < round4(tab.cap); j += 32) tab.pend[j] = 0;
  __syncwarp();
  const long long p = c0 + lane;
  const int32_t r = p < len ? srow[p] : -1;
  const bool start = p < len && (p == 0 || srow[p - 1] != r);
  unsigned starts = __ballot_sync(kFull, start);
  while (starts != 0u) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int row = __shfl_sync(kFull, r, s);
    Walk w{(uint32_t)n_seen_all[row], epoch_all[row], 0, 0, false};
    tab.bind(keys_all, counts_all, row);
    w.n_empty = tab.open_warp();
    int32_t last = -1;
    bool more = true;
    // 128 sorted positions a load, the next ones' rows and positions in
    // flight while these are placed: ok / t / x (these), nok / nt (next)
    bool ok[4], nok[4];
    int32_t t[4], x[4], nt[4];
    const auto rows_at = [&](long long g, bool* o, int32_t* tt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long q = g + 32 * u + lane;
        o[u] = q < len && srow[q] == row;
        tt[u] = q < len ? perm[q] : 0;
      }
    };
    rows_at(c0 + s, ok, t);
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = ok[u] ? items[t[u]] : 0;
    for (long long g = c0 + s; more; g += 128) {
      rows_at(g + 128, nok, nt);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!more) break;
        const int cnt = __popc(__ballot_sync(kFull, ok[u]));
        if (cnt == 0) {
          more = false;
          break;
        }
        group(tab, w, tb, x[u], cnt, w.n_seen + 1u, geo_mix, coin_mix);
        w.n_seen += (uint32_t)cnt;
        last = __shfl_sync(kFull, t[u], cnt - 1);
        more = cnt == 32;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ok[u] = nok[u];
        t[u] = nt[u];
        x[u] = ok[u] && more ? items[t[u]] : 0;
      }
    }
    close_walk(tab, w, last, T, tb, geo_mix, n_seen_all, epoch_all, row,
               warp);
  }
}

template <int W>
__global__ void __launch_bounds__(W * 32)
sticky_walk_kernel(int32_t* __restrict__ keys, float* __restrict__ counts,
                   int32_t* __restrict__ n_seen, int32_t* __restrict__ epoch,
                   int n, int cap, const int32_t* __restrict__ items,
                   const uint8_t* __restrict__ mask, int T,
                   const int32_t* __restrict__ src, int n_src,
                   const int32_t* __restrict__ srow,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ count,
                   const int32_t* __restrict__ tables, uint32_t geo_mix,
                   uint32_t coin_mix) {
  __shared__ Tables tb;
  load_tables(tb, tables);
  extern __shared__ __align__(16) int32_t smem_all[];
  const int wid = threadIdx.x >> 5;
  Table tab;
  if ((int)blockIdx.x < n_src) {
    const int32_t row = src[blockIdx.x];
    if (row < 0 || row >= n) return;
    for (int i = 0; i < (int)blockIdx.x; ++i) {
      if (src[i] == row) return;      // listed before: walked there
    }
    tab.attach(smem_all, cap, kSourceSpread);
    source_walk<W>(tab, smem_all, row, keys, counts, n_seen, epoch, items,
                   mask, T, tb, geo_mix, coin_mix);
    return;
  }
  tab.attach(smem_all + (long long)wid * walk_words(cap, kRunSpread), cap,
             kRunSpread);
  run_walks(tab, (long long)(blockIdx.x - n_src) * W + wid, keys, counts,
            n_seen, epoch, items, T, srow, perm, *count, tb, geo_mix,
            coin_mix);
}

// The kernel's own want_epoch and geo over given counts and hashes, for
// the check that the tables equal the float functions they stand for.
__global__ void eval_kernel(const int32_t* __restrict__ tables, int32_t n0,
                            int count_n, int32_t* __restrict__ want,
                            const uint32_t* __restrict__ h, int count_h,
                            float* __restrict__ geo) {
  __shared__ Tables tb;
  load_tables(tb, tables);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < count_n) want[i] = want_of(tb, (int32_t)(n0 + i));
  if (i < count_h) geo[i] = geo_of(tb, h[i]);
}

// The scratch of a call, in int32 words: the sort's, then the tuples' keys
// and the source rows' flags (a byte a row).
long long key_word(int T) { return sde::sort_words(T); }
long long flag_word(int T) { return key_word(T) + sde::round32(T); }
long long total_words(int n, int T) {
  return flag_word(T) + sde::round32(((long long)n + 3) / 4);
}

int max_shared() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return cached[dev];
}

// The walk's warps a block: the most of 16, 8, 4 whose walks' tables fit
// one block's shared memory beside the Tables (a source block's too, where
// there is one); 0 where none fits (4 fit at kMaxCap slots).
int walk_warps(int cap, bool sources) {
  const long long room = (long long)max_shared() - (long long)sizeof(Tables);
  if (cap < 1 || cap > kMaxCap) return 0;
  if (sources && 4LL * source_words(cap) > room) return 0;
  for (int w = kMaxWalkWarps; w >= 4; w >>= 1) {
    if (4LL * w * walk_words(cap, kRunSpread) <= room) return w;
  }
  return 0;
}

template <int W>
cudaError_t launch_walk(int32_t* keys, float* counts, int32_t* n_seen,
                        int32_t* epoch, int n, int cap, const int32_t* items,
                        const uint8_t* mask, int T, const int32_t* src,
                        int n_src, const int32_t* srow, const int32_t* perm,
                        const int32_t* count, const int32_t* tables,
                        uint32_t geo_mix, uint32_t coin_mix,
                        cudaStream_t stream) {
  long long words = (long long)W * walk_words(cap, kRunSpread);
  if (n_src > 0 && source_words(cap) > words) words = source_words(cap);
  const size_t smem = (size_t)words * 4;
  if (smem + sizeof(Tables) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sticky_walk_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long chunks = ((long long)T + 31) / 32;
  const long long blocks = (long long)n_src + (chunks + W - 1) / W;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sticky_walk_kernel<W><<<(unsigned)blocks, W * 32, smem, stream>>>(
      keys, counts, n_seen, epoch, n, cap, items, mask, T, src, n_src, srow,
      perm, count, tables, geo_mix, coin_mix);
  return cudaGetLastError();
}

cudaError_t launch_walks(int32_t* keys, float* counts, int32_t* n_seen,
                         int32_t* epoch, int n, int cap, const int32_t* items,
                         const uint8_t* mask, int T, const int32_t* src,
                         int n_src, const int32_t* srow, const int32_t* perm,
                         const int32_t* count, const int32_t* tables,
                         uint32_t geo_mix, uint32_t coin_mix,
                         cudaStream_t stream) {
  switch (walk_warps(cap, n_src > 0)) {
    case 16:
      return launch_walk<16>(keys, counts, n_seen, epoch, n, cap, items,
                             mask, T, src, n_src, srow, perm, count, tables,
                             geo_mix, coin_mix, stream);
    case 8:
      return launch_walk<8>(keys, counts, n_seen, epoch, n, cap, items, mask,
                            T, src, n_src, srow, perm, count, tables, geo_mix,
                            coin_mix, stream);
    case 4:
      return launch_walk<4>(keys, counts, n_seen, epoch, n, cap, items, mask,
                            T, src, n_src, srow, perm, count, tables, geo_mix,
                            coin_mix, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The key pass (rows given, or probed when keys_lo is set), the sort, the
// batch's first checks and the walks.
cudaError_t scan(int32_t* keys, float* counts, int32_t* n_seen,
                 int32_t* epoch, int n, int cap, const int32_t* rows,
                 const uint32_t* keys_lo, const uint32_t* keys_hi,
                 const int32_t* trows, uint32_t size, const uint32_t* sid_lo,
                 const uint32_t* sid_hi, int n_probe, const int32_t* items,
                 const uint8_t* mask, int T, const int32_t* src, int n_src,
                 const int32_t* tables, uint32_t geo_mix, uint32_t coin_mix,
                 int32_t* scratch, cudaStream_t stream) {
  if (T <= 0 || n <= 0) return cudaSuccess;
  if (cap < 1 || scratch == nullptr || tables == nullptr)
    return cudaErrorInvalidValue;
  if (src == nullptr) n_src = 0;
  const sde::SortScratch s = sde::sort_scratch(scratch, T);
  int32_t* const key = scratch + key_word(T);
  uint8_t* flag = nullptr;
  cudaError_t err;
  if (n_src > 0) {
    flag = reinterpret_cast<uint8_t*>(scratch + flag_word(T));
    err = cudaMemsetAsync(flag, 0, (size_t)n, stream);
    if (err != cudaSuccess) return err;
    flag_kernel<<<(n_src + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        src, n_src, n, flag);
  }
  const int kblocks = (T + kThreads - 1) / kThreads;
  if (keys_lo != nullptr) {
    probe_key_kernel<<<kblocks, kThreads, 0, stream>>>(
        keys_lo, keys_hi, trows, size, sid_lo, sid_hi, n_probe, mask, T, n,
        flag, key);
  } else {
    key_kernel<<<kblocks, kThreads, 0, stream>>>(rows, mask, T, n, flag, key);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sde::sort_rows(key, n, T, s, stream);
  if (err != cudaSuccess) return err;
  bump_kernel<<<(unsigned)(((long long)n + kThreads - 1) / kThreads),
                kThreads, 0, stream>>>(keys, counts, n_seen, epoch, n, cap,
                                       tables, geo_mix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_walks(keys, counts, n_seen, epoch, n, cap, items, mask, T,
                     src, n_src, s.srow, s.perm, s.count, tables, geo_mix,
                     coin_mix, stream);
  return err;
}

}  // namespace

extern "C" {

// The scratch sticky_scan needs, in int32 words.
int sticky_words(int n, int T, long long* words) {
  *words = (T > 0 && n > 0) ? total_words(n, T) : 0;
  return 0;
}

// The int32 words of the tables, and the most slots a table may have: the
// reference's 4,096, or 0 where a walk of that many does not fit a block's
// shared memory.
int sticky_layout(int* table_words, int* max_cap) {
  *table_words = kTableWords;
  *max_cap = walk_warps(kMaxCap, true) > 0 ? kMaxCap : 0;
  return 0;
}

// keys [n, cap] i32, counts [n, cap] f32, n_seen and epoch [n] i32 (updated
// in place); rows, items [T] i32; mask [T] bytes (0 / 1); src [n_src] i32
// (data-source rows) or null; tables: sticky_layout's words; geo_mix and
// coin_mix: hash_u32's seed words of the kind's seed and seed + 1;
// scratch: sticky_words(n, T) words, 128-byte aligned.
int sticky_scan(int32_t* keys, float* counts, int32_t* n_seen,
                int32_t* epoch, int n, int cap, const int32_t* rows,
                const int32_t* items, const uint8_t* mask, int T,
                const int32_t* src, int n_src, const int32_t* tables,
                uint32_t geo_mix, uint32_t coin_mix, int32_t* scratch,
                cudaStream_t stream) {
  return (int)scan(keys, counts, n_seen, epoch, n, cap, rows, nullptr,
                   nullptr, nullptr, 0, nullptr, nullptr, 0, items, mask, T,
                   src, n_src, tables, geo_mix, coin_mix, scratch, stream);
}

// As sticky_scan, each tuple's row probed from the routing table (keys_lo,
// keys_hi, trows: size slots, a power of two) for its stream id (sid_lo,
// sid_hi), at most n_probe slots.
int sticky_probe_scan(int32_t* keys, float* counts, int32_t* n_seen,
                      int32_t* epoch, int n, int cap,
                      const uint32_t* keys_lo, const uint32_t* keys_hi,
                      const int32_t* trows, int size, const uint32_t* sid_lo,
                      const uint32_t* sid_hi, int n_probe,
                      const int32_t* items, const uint8_t* mask, int T,
                      const int32_t* src, int n_src, const int32_t* tables,
                      uint32_t geo_mix, uint32_t coin_mix, int32_t* scratch,
                      cudaStream_t stream) {
  if (keys_lo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)scan(keys, counts, n_seen, epoch, n, cap, nullptr, keys_lo,
                   keys_hi, trows, (uint32_t)size, sid_lo, sid_hi, n_probe,
                   items, mask, T, src, n_src, tables, geo_mix, coin_mix,
                   scratch, stream);
}

// want[i] = the kernel's want_epoch of n0 + i (i < count_n) and geo[i] its
// geo of hash h[i] (i < count_h).
int sticky_eval(const int32_t* tables, int n0, int count_n, int32_t* want,
                const uint32_t* h, int count_h, float* geo,
                cudaStream_t stream) {
  const int most = count_n > count_h ? count_n : count_h;
  if (most <= 0) return 0;
  eval_kernel<<<(most + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      tables, n0, count_n, want, h, count_h, geo);
  return (int)cudaGetLastError();
}

}  // extern "C"
