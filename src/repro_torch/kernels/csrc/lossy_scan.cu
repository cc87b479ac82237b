// Lossy Counting's stacked scan for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package updates a Lossy Counting stack
// with LossyCounting.add_batch (src/repro/core/lossy.py:65, a lax.scan of
// the one-slot step over the batch) under the vmap of
// batched.stacked_update (src/repro/core/batched.py:92): every row scans
// the whole batch, masked to its own tuples, so capacity x T steps a batch.
// Here the batch is grouped by row first and each tuple is scanned once,
// by its own row:
//
//   row r in [0, n):        the tuples with mask & rows == r, in batch order
//   a data-source row:      every tuple with mask, routed or not, in order
//   every other row:        untouched
//
// A step (the reference's _step) on a table of k slots (keys int32, -1
// empty; counts and error float32) for item x of weight v: the first slot
// whose key is x gets count + v; else the first empty slot gets key x and
// 0 + v; else the first slot of least count (NaN least, as argmin) gets
// key x, count + v and error = its old count. A masked step of the
// reference writes every slot back unchanged, so dropping masked tuples
// gives its bytes. Each add is __fadd_rn (never contracted), so the state
// equals the plain version (ref.lossy_scan_update) byte for byte; there
// are no float atomics and no order that depends on scheduling.
//
// Launches, on the caller's stream:
//   * (data-source rows) a memset and flag_kernel: a byte per row, set for
//     the source rows, whose routed tuples the grouping drops (their walk
//     takes every masked tuple anyway).
//   * key_kernel: each tuple's row, or -1 where it is masked, unrouted,
//     outside [0, n) or routed to a source row.
//   * The stable row sort (row_sort.cuh) into srow / perm and the count of
//     kept tuples, which stays on the card: the host never waits.
//   * walk_kernel: warp w < S walks data-source row src[w] (a row listed
//     twice is walked once) over the whole batch, 32 tuples a load; warp
//     S + c takes the runs that start in chunk c of 32 sorted positions,
//     one after another, each to its end. The source warps come first in
//     the grid, so their long walks start with it.
//
// The walk of a table of k <= kGroupK (1,024) slots (GroupWalker) takes a
// row's tuples 32 at a time, lane i holding the i-th, and keeps the table
// in shared memory from the start to the end of the walk. What order the
// tuples act in is the result only in two places: a miss's choice (first
// empty, else first least count) reads the counts of that moment, and the
// adds into one slot must stay in batch order. Adds into different slots
// commute exactly, and a key changes only on a miss. The warp keeps a
// bitmask (`mins`, a word a lane: lane l holds slots 32 l .. 32 l + 31)
// of exactly the slots whose count is the least, or an empty one, taken
// again from every count when an eviction needs it; so the first least
// count is a ballot and a shuffle away, the first m a scan of the words'
// bit counts. A slot leaves `mins` when its count rises; a count of the
// set that does not rise (a weight not positive or NaN, a sum that rounds
// back), an empty slot taken or a hit on the set outside a phase empties
// it. The sentinel item's slot is the first empty one, kept warp-wide
// (`fe`) from a like bitmask of empty slots. A group goes:
//   1. Every lane finds its item's slot at once: up to kBroadcastK (128)
//      slots by comparing with every key (16-byte broadcast reads), above
//      through an item -> slot hash index in shared memory (linear
//      probing, 4k entries or more; built at a walk's third group, so a
//      short run compares instead). One __match_any_sync of the items
//      gives each lane the lanes of its item (~11 cycles a distinct value
//      on an H100): they hit one slot.
//   2. On a full table, a phase: the longest prefix of the lanes left
//      whose misses can take the first slots of `mins` in order (weights
//      above 0, no item twice, not the sentinel, no more misses than
//      slots) and whose hits (weights above 0) avoid those slots. Every
//      miss takes its slot at once (its rank among the misses picks it
//      from a list the word owners write), each slot's first lane adds
//      its item's lanes in lane order, and the lanes after the phase fix
//      their slots: a miss of the phase with their item took one, or the
//      slot they hit lost their key to a miss. A miss whose count does
//      not rise ends the phase there.
//   3. Else (an empty slot, or no phase can start) the hits before the
//      first miss are added in lane order (one hit one add; hits into one
//      slot an unrolled sum over the lanes, a shuffle and an add a tuple
//      for a hot routed run), then that miss takes `fe` or the first slot
//      of `mins`, and the lanes after it fix their slots for that slot.
//   4. The group's new keys go into the index at its end, in parallel
//      (each lane writes a free entry and reads it back); an evicted key's
//      entry became a tombstone at the miss. The index is rebuilt when
//      live entries and tombstones pass half of it.
// A lane whose slot lost its key looks again: the next empty slot for the
// sentinel; nothing in an indexed row, whose keys are distinct; else the
// first slot of that key.
// A row whose keys repeat (a merged or hand-made state) is not indexed: it
// compares. Tables of more than kGroupK slots (MemWalker) take one step a
// tuple: every lane compares its share of the keys with the item, and a
// redux.sync minimum decides; in shared memory (k x 12 bytes) while a
// block's opt-in limit holds one (232,448 bytes on an H100: k <= 19,370),
// else in place in device memory.
//
// Bounds on this card. Bytes: the batch (rows, items, values, mask) read
// once and each walked row's table read and written once. The chain: a
// slot's adds stay in batch order, and the least count is found again
// from every count once the slots that held the last one are all taken
// or raised (a level: ~1,150 a batch for a 100-slot data-source table at
// chip_smoke's batch, ~80 for a 1,000-slot one, against ~36,000 and
// ~24,000 misses of ~62,000 steps). A phase takes at once the misses
// whose slots the counts already fix, so what stays serial is a phase's
// few dozen dependent warp operations (ballots, shuffles, a scan, shared
// loads) and a group's lookups: far above both bounds.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "row_sort.cuh"

namespace {

constexpr int kThreads = 256;     // flag_kernel and key_kernel
constexpr int kWalkWarps = 4;     // walk_kernel warps a block, at most
constexpr int kGroupK = 1024;     // group walk: a bitmask word a lane
constexpr int kBroadcastK = 128;  // lookups by compare up to here
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = -1;    // the bits of 0xFFFFFFFF; an empty entry
constexpr int32_t kTomb = -2;     // an index entry whose key left
constexpr int kNone = INT_MAX;

__global__ void flag_kernel(const int32_t* __restrict__ src, int n_src,
                            int n, uint8_t* __restrict__ flag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_src) {
    const int32_t r = src[i];
    if (r >= 0 && r < n) flag[r] = 1;
  }
}

__global__ void key_kernel(const int32_t* __restrict__ rows,
                           const uint8_t* __restrict__ mask, int T, int n,
                           const uint8_t* __restrict__ flag,
                           int32_t* __restrict__ key) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int32_t r = rows[t];
  const bool keep = mask[t] != 0 && r >= 0 && r < n &&
                    (flag == nullptr || flag[r] == 0);
  key[t] = keep ? r : -1;
}

// An order-preserving key of a count for the argmin: equal floats give
// equal keys (-0 as +0), NaN the least (argmin returns the first NaN).
__device__ __forceinline__ unsigned order_key(float c) {
  if (c != c) return 0u;
  unsigned u = __float_as_uint(c);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The first set bit of a warp's bitmask of slots (lane l's word holds
// slots 32 l .. 32 l + 31), or kNone; every lane gets it.
__device__ __forceinline__ int first_bit(unsigned word) {
  const unsigned any = __ballot_sync(kFull, word != 0u);
  if (any == 0u) return kNone;
  const int l = __ffs(any) - 1;
  return 32 * l + __ffs(__shfl_sync(kFull, word, l)) - 1;
}

__host__ __device__ __forceinline__ int round4(int k) {
  return (k + 3) & ~3;
}

// The index of a table of k slots: a power of two of at least 4 k entries.
__host__ __device__ __forceinline__ int index_bits(int k) {
  int b = 2;
  while ((1 << b) < 4 * k) ++b;
  return b;
}

// The walk of a row of k <= kGroupK slots, a group of 32 tuples at a time
// (the header's steps 1-4). Its shared memory (`smem`): the group's
// weights [32], a phase's slots [32], the table's keys and counts
// [round4(k)] each, then, above kBroadcastK, the index [2^index_bits(k)]
// and each slot's entry in it [round4(k)]; error is written straight to
// the state row. Values every lane holds alike are kept in every lane,
// and stores of them made by every lane alike.
struct GroupWalker {
  int k, nw;
  int32_t* keys;      // the state row's
  float* counts;
  float* error;
  int32_t* key;       // shared
  float* cnt;
  int32_t* hidx;      // index entries: a slot, kEmpty or kTomb
  int32_t* hpos;      // a slot's entry, or -1 (none yet: empty or new)
  int hmask, hshift;
  int mode;           // 0 compare; 1 index due; 2 indexed; 3 keys repeat
  int used;           // index entries not empty
  int groups;
  int fe;             // the first empty slot, or kNone
  unsigned emp;       // this lane's word of the empty slots
  unsigned mins;      // this lane's word of the slots of least count
  float* vbuf;        // shared: the group's weights, lane by lane
  int32_t* slist;     // shared: the slots a phase's misses take, in order

  static __host__ __device__ long long words(int k) {
    return 64 + (k > kBroadcastK ? 3LL * round4(k) + (1LL << index_bits(k))
                                 : 2LL * round4(k));
  }

  __device__ __forceinline__ void open(int32_t* keys_all, float* counts_all,
                                       float* error_all, int k_, int row,
                                       int32_t* smem) {
    const int lane = threadIdx.x & 31;
    const long long base = (long long)row * k_;
    k = k_;
    nw = (k + 31) >> 5;
    keys = keys_all + base;
    counts = counts_all + base;
    error = error_all + base;
    const int kp = round4(k);
    vbuf = reinterpret_cast<float*>(smem);
    slist = smem + 32;
    key = smem + 64;
    cnt = reinterpret_cast<float*>(key + kp);
    hidx = hpos = nullptr;
    hmask = hshift = 0;
    mode = 0;
    if (k > kBroadcastK) {
      const int b = index_bits(k);
      hidx = key + 2 * kp;
      hpos = hidx + (1 << b);
      hmask = (1 << b) - 1;
      hshift = 32 - b;
      mode = 1;
    }
    emp = 0u;
    for (int r = 0; r < nw; ++r) {      // slots 32 r + lane, pads past k
      const int j = 32 * r + lane;
      const int32_t x = j < k ? keys[j] : kEmpty;
      if (j < kp) {
        key[j] = x;
        cnt[j] = j < k ? counts[j] : 0.0f;
      }
      const unsigned b = __ballot_sync(kFull, j < k && x == kEmpty);
      if (lane == r) emp = b;
    }
    fe = first_bit(emp);
    mins = 0u;
    used = 0;
    groups = 0;
    __syncwarp();
  }

  __device__ __forceinline__ void close() {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    for (int j = lane; j < k; j += 32) {
      keys[j] = key[j];
      counts[j] = cnt[j];
    }
    __syncwarp();
  }

  __device__ __forceinline__ unsigned hslot(int32_t x) const {
    return ((unsigned)x * 0x9E3779B1u) >> hshift;
  }

  // Slot j's key x into the index (lanes at once: a lost compare-and-swap
  // reads the entry again). Returns true, taking nothing, where a live
  // entry holds the same key.
  __device__ __forceinline__ bool insert(int32_t x, int j) {
    unsigned h = hslot(x);
    int32_t e = hidx[h];
    while (true) {
      if (e == kEmpty) {
        const int32_t was = atomicCAS(&hidx[h], kEmpty, j);
        if (was == kEmpty) {
          hpos[j] = (int32_t)h;
          return false;
        }
        e = was;
        continue;
      }
      if (key[e] == x) return true;
      h = (h + 1) & hmask;
      e = hidx[h];
    }
  }

  // The index of every key anew (mode 2), or mode 3 where a key repeats.
  __device__ __forceinline__ void build_index() {
    const int lane = threadIdx.x & 31;
    for (int j = lane; j <= hmask; j += 32) hidx[j] = kEmpty;
    __syncwarp();
    bool repeat = false;
    for (int j = lane; j < k; j += 32) {
      const int32_t x = key[j];
      hpos[j] = -1;
      if (x != kEmpty) repeat |= insert(x, j);
    }
    __syncwarp();
    mode = __any_sync(kFull, repeat) ? 3 : 2;
    used = k - (int)__reduce_add_sync(kFull, __popc(emp));
  }

  // The slot of item x: the first whose key is x, or kNone.
  __device__ __forceinline__ int lookup(int32_t x) const {
    if (x == kEmpty) return fe;
    if (mode == 2) {
      unsigned h = hslot(x);
      while (true) {
        const int32_t e = hidx[h];
        if (e == kEmpty) return kNone;
        if (e >= 0 && key[e] == x) return e;
        h = (h + 1) & hmask;
      }
    }
    int h0 = kNone, h1 = kNone, h2 = kNone, h3 = kNone;   // by column
    const int4* k4 = reinterpret_cast<const int4*>(key);
    for (int q = round4(k) / 4 - 1; q >= 0; --q) {   // the lowest wins
      const int4 t = k4[q];
      h0 = t.x == x ? 4 * q : h0;
      h1 = t.y == x ? 4 * q + 1 : h1;
      h2 = t.z == x ? 4 * q + 2 : h2;
      h3 = t.w == x ? 4 * q + 3 : h3;
    }
    return min(min(h0, h1), min(h2, h3));
  }

  // `mins` from every count: the slots whose order key is the least. One
  // pass over the counts; each lane keeps its least key and which of its
  // slots (32 r + lane) hold it, and a ballot a word turns those over.
  __device__ __forceinline__ void recompute() {
    const int lane = threadIdx.x & 31;
    unsigned m = 0xffffffffu, at = 0u;
#pragma unroll 4
    for (int r = 0; r < nw; ++r) {
      const int j = 32 * r + lane;
      const unsigned o = j < k ? order_key(cnt[j]) : 0xffffffffu;
      at = o < m ? 1u << r : o == m ? at | 1u << r : at;
      m = min(m, o);
    }
    if (m != __reduce_min_sync(kFull, m)) at = 0u;
    mins = 0u;
    for (int r = 0; r < nw; ++r) {
      const unsigned b = __ballot_sync(kFull, (at >> r) & 1u);
      if (lane == r) mins = b;
    }
  }

  // Slot s's count went from a to b by the hits of one group: a slot of
  // least count that rose leaves `mins`; a count that did not rise (a
  // weight not positive, a NaN, a sum that rounds back) empties `mins`,
  // so the next eviction takes them again from every count.
  __device__ __forceinline__ void rose(int s, bool up) {
    const int lane = threadIdx.x & 31;
    mins = up ? mins & ~(lane == (s >> 5) ? 1u << (s & 31) : 0u) : 0u;
  }

  // The hits of the lanes in `seg` (at least one), in lane order: the adds
  // into one slot stay in batch order, adds into different slots commute.
  // One lane: one add. One slot: an unrolled sum over the lanes. Else
  // each slot's first lane sums its lanes (those of its item: `peers`)
  // from `vbuf`.
  __device__ __forceinline__ void add_hits(unsigned seg, int hit, float v,
                                           unsigned peers) {
    const int lane = threadIdx.x & 31;
    const int p = __ffs(seg) - 1;
    const int s = __shfl_sync(kFull, hit, p);
    if ((seg & (seg - 1u)) == 0u) {
      const float a = cnt[s];
      const float b = __fadd_rn(a, __shfl_sync(kFull, v, p));
      cnt[s] = b;
      rose(s, b > a);
      return;
    }
    const bool mine = (seg >> lane) & 1u;
    if ((__ballot_sync(kFull, hit == s) & seg) == seg) {
      float c = cnt[s];
      bool up = true;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float w = __shfl_sync(kFull, v, i);
        const float n = __fadd_rn(c, w);
        const bool in = (seg >> i) & 1u;
        up = in ? up && n > c : up;
        c = in ? n : c;
      }
      cnt[s] = c;
      rose(s, up);
      return;
    }
    const unsigned at_least =
        __shfl_sync(kFull, mins, mine ? hit >> 5 : 0);
    const bool least = mine && ((at_least >> (hit & 31)) & 1u);
    bool up = true;
    lead_sum(seg, hit, peers, up);
    __syncwarp();
    if (__any_sync(kFull, least || !up)) mins = 0u;
  }

  // The hits of the lanes in `lanes`: the first lane of each item (its
  // lanes: `peers`, one slot) adds their weights from `vbuf` in lane
  // order; `up`, in that lane, whether the count rose. Returns whether
  // this lane led.
  __device__ __forceinline__ bool lead_sum(unsigned lanes, int hit,
                                           unsigned peers, bool& up) {
    const int lane = threadIdx.x & 31;
    const unsigned same = peers & lanes;
    if (!((lanes >> lane) & 1u) || lane != __ffs(same) - 1) return false;
    const float c0 = cnt[hit];
    float c = c0;
    for (unsigned q = same; q != 0u; q &= q - 1u) {
      c = __fadd_rn(c, vbuf[__ffs(q) - 1]);
    }
    cnt[hit] = c;
    up = c > c0;
    return true;
  }

  // A miss of item x, weight v: the first empty slot, else the first
  // least count, the first slot of `mins`. Returns the slot; `y` its old
  // key.
  __device__ __forceinline__ int take(int32_t x, float v, int32_t& y) {
    const int lane = threadIdx.x & 31;
    int s;
    if (fe != kNone) {
      s = fe;
      y = kEmpty;
      key[s] = x;
      cnt[s] = __fadd_rn(0.0f, v);
      if (lane == (s >> 5)) emp &= ~(1u << (s & 31));
      fe = first_bit(emp);
      mins = 0u;                        // its count may be the least now
    } else {
      s = first_bit(mins);
      if (s == kNone) {
        recompute();
        s = first_bit(mins);
      }
      const float old = cnt[s];
      y = key[s];
      const float c = __fadd_rn(old, v);
      key[s] = x;
      cnt[s] = c;
      if (lane == 0) error[s] = old;
      rose(s, c > old);
      if (x == kEmpty) {                // the sentinel empties the slot
        if (lane == (s >> 5)) emp |= 1u << (s & 31);
        fe = s;
      }
    }
    if (mode == 2) {                    // the old key's entry goes
      const int32_t p = hpos[s];
      if (p >= 0) hidx[p] = kTomb;
      hpos[s] = -1;
    }
    return s;
  }

  // Where a lane whose slot held key y (now gone from it) looks again.
  __device__ __forceinline__ int relookup(int32_t y) const {
    if (y == kEmpty) return fe;
    if (mode == 2) return kNone;        // an indexed row's keys differ
    return lookup(y);
  }

  // The slots this group's misses took (lane b: `taken`) into the index,
  // all at once: each lane writes the first free entry of its probe and
  // reads it back; one that lost it to another lane probes on. A slot
  // taken twice in the group may leave a second entry of its key; every
  // lookup checks the key, so such an entry only takes room until the
  // next rebuild.
  __device__ __forceinline__ void index_taken(int taken) {
    const int32_t x = taken >= 0 ? key[taken] : kEmpty;
    bool pending = x != kEmpty;
    bool fresh = false;
    unsigned h = pending ? hslot(x) : 0u;
    while (__any_sync(kFull, pending)) {
      int32_t e = kEmpty;
      if (pending) {
        e = hidx[h];
        while (e != kEmpty && e != kTomb) {
          h = (h + 1) & hmask;
          e = hidx[h];
        }
        hidx[h] = taken;
      }
      __syncwarp();
      if (pending) {
        if (hidx[h] == taken) {
          hpos[taken] = (int32_t)h;
          fresh = fresh || e == kEmpty;
          pending = false;
        } else {
          h = (h + 1) & hmask;
        }
      }
      __syncwarp();
    }
    used += __popc(__ballot_sync(kFull, fresh));
  }

  // The hits before the first miss of `rem` (lanes in lane order), then
  // that miss: its slot, and the lanes after it fixed for that one slot.
  __device__ __forceinline__ void one_miss(unsigned& rem, int& hit,
                                           int& taken, int32_t x, float v,
                                           unsigned peers) {
    const int lane = threadIdx.x & 31;
    const unsigned miss = __ballot_sync(kFull, hit == kNone) & rem;
    const unsigned low = miss & (0u - miss);        // the first miss
    const unsigned seg = miss ? rem & (low - 1u) : rem;
    if (seg != 0u) add_hits(seg, hit, v, peers);
    if (miss == 0u) {
      rem = 0u;
      return;
    }
    const int b = __ffs(miss) - 1;
    rem &= ~((2u << b) - 1u);                       // the lanes after b
    const int32_t xb = __shfl_sync(kFull, x, b);
    const float vb = __shfl_sync(kFull, v, b);
    int32_t y;
    const int s = take(xb, vb, y);
    if (lane == b) taken = s;
    if (x == xb) {
      hit = min(hit, s);
    } else if (x == y && hit == s) {
      hit = relookup(y);
    }
  }

  // The longest prefix P of `rem` whose tuples act at once (a phase), on
  // a full table with `mins` set: its misses have weights above 0, items
  // that no earlier miss of P has and are not the sentinel, and number at
  // most the slots of `mins`, so the j-th miss takes the j-th slot of
  // `mins` (each leaves the set as its count rises; a miss whose count
  // does not rise ends P); its hits have weights above 0 and avoid the
  // slots those misses take, so they only raise counts, and a slot of
  // `mins` they raise leaves the set after the misses chose. Returns false
  // (nothing done) where P is empty. `peers`: the lanes of each lane's
  // item (one slot for a hit).
  __device__ __forceinline__ bool phase(unsigned& rem, int& hit, int& taken,
                                        int32_t x, float v, unsigned peers) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const bool in = (rem >> lane) & 1u;
    const unsigned missm = __ballot_sync(kFull, in && hit == kNone);
    if (missm != 0u && __ballot_sync(kFull, mins != 0u) == 0u) recompute();
    const bool miss = (missm >> lane) & 1u;
    const int pc = __popc(mins);
    const int nmin = (int)__reduce_add_sync(kFull, (unsigned)pc);
    const unsigned hw =
        __shfl_sync(kFull, mins, in && !miss ? hit >> 5 : 0);
    const bool least = in && !miss && ((hw >> (hit & 31)) & 1u);
    const int rank = __popc(missm & below);
    const bool stop =
        in && (miss ? (peers & missm & below) != 0u || !(v > 0.0f) ||
                          x == kEmpty || rank >= nmin
                    : !(v > 0.0f));
    const unsigned stops = __ballot_sync(kFull, stop);
    unsigned P = stops ? rem & ((stops & (0u - stops)) - 1u) : rem;
    if (P == 0u) return false;
    unsigned pm = missm & P;
    unsigned lh = __ballot_sync(kFull, least) & P;  // hits on `mins`
    int excl = 0;
    if ((pm | lh) != 0u) {
      int incl = pc;                    // over the nw lanes with words
      for (int d = 1; d < nw; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      excl = incl - pc;
    }
    if (lh != 0u && pm != 0u) {         // a slot a miss of P takes: cut
      const int at = __shfl_sync(kFull, excl, least ? hit >> 5 : 0) +
                     __popc(hw & ((1u << (hit & 31)) - 1u));
      const unsigned cut =
          __ballot_sync(kFull, ((lh >> lane) & 1u) && at < __popc(pm));
      if (cut != 0u) {
        P &= (cut & (0u - cut)) - 1u;
        if (P == 0u) return false;
        pm &= P;
        lh &= P;
      }
    }
    int s = kNone;
    unsigned tk = 0u;
    if (pm != 0u) {
      // the first |pm| slots of `mins`, in slot order, into `slist`
      const int m = __popc(pm);
      unsigned w = mins;
      for (int r = excl; w != 0u && r < m; ++r) {
        slist[r] = 32 * lane + __ffs(w) - 1;
        tk |= w & (0u - w);
        w &= w - 1u;
      }
      __syncwarp();
      float old = 0.0f, c = 0.0f;
      if (miss && ((P >> lane) & 1u)) {
        s = slist[rank];
        old = cnt[s];
        c = __fadd_rn(old, v);
      }
      const unsigned bad = __ballot_sync(kFull, s != kNone && !(c > old));
      if (bad != 0u) {                  // through it
        P &= ((bad & (0u - bad)) << 1) - 1u;
        lh &= P;
      }
      pm &= P;
      if ((pm >> lane) & 1u) {
        key[s] = x;
        cnt[s] = c;
        error[s] = old;
        taken = s;
        if (mode == 2) {                // the old key's entry goes
          const int32_t e = hpos[s];
          if (e >= 0) hidx[e] = kTomb;
          hpos[s] = -1;
        }
      } else {
        s = kNone;
      }
      if (bad != 0u) {                  // the slots taken before it
        const int m2 = __popc(pm);
        tk = 0u;
        unsigned w = mins;
        for (int r = excl; w != 0u && r < m2; ++r) {
          tk |= w & (0u - w);
          w &= w - 1u;
        }
        mins = 0u;
      } else {
        mins &= ~tk;
      }
    }
    const unsigned ph = P & ~pm;                    // the hits
    if (ph != 0u) {
      bool up = true;
      const bool lead = lead_sum(ph, hit, peers, up);
      // the raised slots of `mins` leave it; one that did not rise
      // empties it
      unsigned raised = __ballot_sync(kFull, lead && ((lh >> lane) & 1u));
      if (__any_sync(kFull, lead && ((lh >> lane) & 1u) && !up)) {
        mins = 0u;
        raised = 0u;
      }
      while (raised != 0u) {
        const int j = __shfl_sync(kFull, hit, __ffs(raised) - 1);
        if (lane == (j >> 5)) mins &= ~(1u << (j & 31));
        raised &= raised - 1u;
      }
    }
    __syncwarp();
    // the lanes after P: a miss of P with their item took slot s; a slot
    // of theirs that a miss took lost their key
    const unsigned q = peers & pm;
    const int sj = __shfl_sync(kFull, s, q != 0u ? __ffs(q) - 1 : 0);
    const unsigned tw = __shfl_sync(kFull, tk, hit != kNone ? hit >> 5 : 0);
    if (q != 0u) {
      hit = sj;
    } else if (hit != kNone && ((tw >> (hit & 31)) & 1u)) {
      hit = relookup(x);
    }
    rem &= ~P;
    return true;
  }

  // The tuples of the lanes in `in`, in lane order: lane i's item x and
  // weight v. While the table has an empty slot, or the next tuple cannot
  // open a phase, a miss at a time.
  __device__ __forceinline__ void group(unsigned in, int32_t x, float v) {
    const int lane = threadIdx.x & 31;
    if (in == 0u) return;
    if ((mode == 1 && groups >= 2) ||
        (mode == 2 && 2 * used > hmask + 1)) {
      build_index();
    }
    ++groups;
    vbuf[lane] = v;
    __syncwarp();
    int hit = lookup(x);
    const unsigned peers = __match_any_sync(kFull, x);  // my item's lanes
    int taken = -1;
    unsigned rem = in;
    while (rem != 0u) {
      if (fe != kNone || !phase(rem, hit, taken, x, v, peers)) {
        one_miss(rem, hit, taken, x, v, peers);
      }
    }
    if (mode == 2) index_taken(taken);
  }
};

// A table of k > kGroupK slots in memory: shared (kShared; k x 12 bytes,
// copied in and out) or the state row itself in device memory. One step
// a tuple: the keys are read first; the counts only where no slot holds
// x or is empty (an eviction), else the chosen slot's count alone.
template <bool kShared>
struct MemWalker {
  int k;
  int32_t* keys;      // the state row's
  float* counts;
  float* error;
  int32_t* tkeys;     // the table's
  float* tcounts;
  float* terror;

  static __host__ __device__ long long words(int k) {
    return kShared ? 3LL * k : 0LL;
  }

  __device__ __forceinline__ void open(int32_t* keys_all, float* counts_all,
                                       float* error_all, int k_, int row,
                                       int32_t* smem) {
    const int lane = threadIdx.x & 31;
    const long long base = (long long)row * k_;
    k = k_;
    keys = keys_all + base;
    counts = counts_all + base;
    error = error_all + base;
    if constexpr (kShared) {
      tkeys = smem;
      tcounts = reinterpret_cast<float*>(smem + k);
      terror = reinterpret_cast<float*>(smem + 2 * k);
      for (int j = lane; j < k; j += 32) {
        tkeys[j] = keys[j];
        tcounts[j] = counts[j];
        terror[j] = error[j];
      }
      __syncwarp();
    } else {
      tkeys = keys;
      tcounts = counts;
      terror = error;
    }
  }

  __device__ __forceinline__ void close() {
    if constexpr (kShared) {
      const int lane = threadIdx.x & 31;
      __syncwarp();
      for (int j = lane; j < k; j += 32) {
        keys[j] = tkeys[j];
        counts[j] = tcounts[j];
        error[j] = terror[j];
      }
    }
    __syncwarp();
  }

  // One step of item x, weight v (every lane calls it).
  __device__ __forceinline__ void step(int32_t x, float v) {
    const int lane = threadIdx.x & 31;
    int hit = kNone, emp = kNone;
    for (int j = lane; j < k; j += 32) {
      const int32_t key = tkeys[j];
      if (key == x && hit == kNone) hit = j;
      if (key == kEmpty && emp == kNone) emp = j;
    }
    int slot = __reduce_min_sync(kFull, hit);
    if (slot != kNone) {
      if (lane == (slot & 31)) {        // the key is x already
        tcounts[slot] = __fadd_rn(tcounts[slot], v);
      }
    } else if ((slot = __reduce_min_sync(kFull, emp)) != kNone) {
      if (lane == (slot & 31)) {
        tkeys[slot] = x;
        tcounts[slot] = __fadd_rn(0.0f, v);
      }
    } else {
      // the first least count: each lane's first, then the lowest slot of
      // the lanes whose least is the warp's
      int low = kNone;
      float low_c = 0.0f;
      unsigned low_key = 0xffffffffu;   // above every count's key
      for (int j = lane; j < k; j += 32) {
        const float c = tcounts[j];
        const unsigned o = order_key(c);
        if (o < low_key) {
          low_key = o;
          low = j;
          low_c = c;
        }
      }
      const unsigned m = __reduce_min_sync(kFull, low_key);
      slot = __reduce_min_sync(kFull, low_key == m ? low : kNone);
      if (lane == (slot & 31)) {        // its own first least: low_c
        tkeys[slot] = x;
        tcounts[slot] = __fadd_rn(low_c, v);
        terror[slot] = low_c;
      }
    }
    __syncwarp();
  }

  // The tuples of the lanes in `in`, in lane order, a step each; the next
  // step's item is shuffled out before this step runs.
  __device__ __forceinline__ void group(unsigned in, int32_t x, float v) {
    if (in == 0u) return;
    int s = __ffs(in) - 1;
    in &= in - 1u;
    int32_t xs = __shfl_sync(kFull, x, s);
    float vs = __shfl_sync(kFull, v, s);
    while (true) {
      const bool more = in != 0u;
      s = more ? __ffs(in) - 1 : 0;
      in &= in - 1u;
      const int32_t xn = __shfl_sync(kFull, x, s);
      const float vn = __shfl_sync(kFull, v, s);
      step(xs, vs);
      if (!more) break;
      xs = xn;
      vs = vn;
    }
  }
};

// A data-source row: every masked tuple of the batch, in order, 32 a
// group, the next group loaded during this one's.
template <class W>
__device__ __forceinline__ void walk_source(W& w,
                                            const int32_t* __restrict__ items,
                                            const float* __restrict__ values,
                                            const uint8_t* __restrict__ mask,
                                            int T) {
  const int lane = threadIdx.x & 31;
  bool ok = lane < T && mask[lane] != 0;
  int32_t x = ok ? items[lane] : 0;
  float v = ok ? values[lane] : 0.0f;
  for (long long g = 0; g < T; g += 32) {
    const long long q = g + 32 + lane;
    const bool ok1 = q < T && mask[q] != 0;
    const int32_t x1 = ok1 ? items[q] : 0;
    const float v1 = ok1 ? values[q] : 0.0f;
    w.group(__ballot_sync(kFull, ok), x, v);
    ok = ok1;
    x = x1;
    v = v1;
  }
}

// A run of `row` from sorted position p0 to its end: the positions of a
// group that still hold `row` are a prefix of it (the rows are sorted).
// Group g's items and weights are in registers; g + 32's sort positions
// were read one group before; g + 64's are read now.
template <class W>
__device__ __forceinline__ void walk_run(W& w, int row, long long p0,
                                         long long len,
                                         const int32_t* __restrict__ srow,
                                         const int32_t* __restrict__ perm,
                                         const int32_t* __restrict__ items,
                                         const float* __restrict__ values) {
  const int lane = threadIdx.x & 31;
  long long p = p0 + lane;
  bool ok = p < len && srow[p] == row;
  const int t0 = ok ? perm[p] : 0;
  p += 32;
  bool ok1 = p < len && srow[p] == row;
  int t1 = ok1 ? perm[p] : 0;
  int32_t x = ok ? items[t0] : 0;
  float v = ok ? values[t0] : 0.0f;
  for (long long g = p0;; g += 32) {
    const unsigned in = __ballot_sync(kFull, ok);
    const int32_t x1 = ok1 ? items[t1] : 0;
    const float v1 = ok1 ? values[t1] : 0.0f;
    const long long q = g + 64 + lane;
    const bool ok2 = in == kFull && q < len && srow[q] == row;
    const int t2 = ok2 ? perm[q] : 0;
    w.group(in, x, v);
    if (in != kFull) break;
    ok = ok1;
    x = x1;
    v = v1;
    ok1 = ok2;
    t1 = t2;
  }
}

template <class W>
__global__ void __launch_bounds__(kWalkWarps * 32)
walk_kernel(int32_t* __restrict__ keys, float* __restrict__ counts,
            float* __restrict__ error, int n, int k,
            const int32_t* __restrict__ items,
            const float* __restrict__ values,
            const uint8_t* __restrict__ mask, int T,
            const int32_t* __restrict__ src, int n_src,
            const int32_t* __restrict__ srow,
            const int32_t* __restrict__ perm,
            const int32_t* __restrict__ count) {
  extern __shared__ __align__(16) int32_t smem_all[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  int32_t* const smem = smem_all + (long long)wib * W::words(k);
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  W walker;
  if (w < n_src) {
    const int32_t row = src[w];
    if (row < 0 || row >= n) return;
    for (long long i = 0; i < w; ++i) {
      if (src[i] == row) return;      // listed before: walked there
    }
    walker.open(keys, counts, error, k, row, smem);
    walk_source(walker, items, values, mask, T);
    walker.close();
    return;
  }
  const long long len = *count;
  const long long c0 = (w - n_src) * 32;
  if (c0 >= len) return;
  const long long p = c0 + lane;
  const int32_t r = p < len ? srow[p] : -1;
  const bool start = p < len && (p == 0 || srow[p - 1] != r);
  unsigned starts = __ballot_sync(kFull, start);
  while (starts != 0u) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int row = __shfl_sync(kFull, r, s);
    walker.open(keys, counts, error, k, row, smem);
    walk_run(walker, row, c0 + s, len, srow, perm, items, values);
    walker.close();
  }
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

// walk_kernel<W> with as many warps a block (up to kWalkWarps) as the
// shared memory of their tables allows.
template <class W>
cudaError_t launch_walk(int32_t* keys, float* counts, float* error, int n,
                        int k, const int32_t* items, const float* values,
                        const uint8_t* mask, int T, const int32_t* src,
                        int n_src, const sde::SortScratch& s,
                        cudaStream_t stream) {
  const size_t table = (size_t)W::words(k) * 4;
  int wpb = kWalkWarps;
  if (table > 0) {
    const int by_smem = (int)((size_t)max_shared() / table);
    wpb = by_smem < wpb ? by_smem : wpb;
    if (wpb < 1) return cudaErrorInvalidValue;
  }
  const size_t smem = table * wpb;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long warps = (long long)n_src + ((long long)T + 31) / 32;
  const long long blocks = (warps + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  walk_kernel<W><<<(unsigned)blocks, wpb * 32, smem, stream>>>(
      keys, counts, error, n, k, items, values, mask, T, src, n_src, s.srow,
      s.perm, s.count);
  return cudaGetLastError();
}

// The walk for a table of k slots: a group at a time up to kGroupK; else
// a step at a time, the table in shared memory while it fits a block's,
// else in device memory.
cudaError_t walk(int32_t* keys, float* counts, float* error, int n, int k,
                 const int32_t* items, const float* values,
                 const uint8_t* mask, int T, const int32_t* src, int n_src,
                 const sde::SortScratch& s, cudaStream_t stream) {
#define SDE_LOSSY_WALK(W)                                                   \
  launch_walk<W>(keys, counts, error, n, k, items, values, mask, T, src, \
                 n_src, s, stream)
  if (k <= kGroupK) return SDE_LOSSY_WALK(GroupWalker);
  if ((size_t)k * 12 <= (size_t)max_shared())
    return SDE_LOSSY_WALK(MemWalker<true>);
  return SDE_LOSSY_WALK(MemWalker<false>);
#undef SDE_LOSSY_WALK
}

}  // namespace

extern "C" {

// The scratch lossy_scan needs, in int32 words.
int lossy_words(int n, int T, long long* words) {
  *words = (T > 0 && n > 0) ? total_words(n, T) : 0;
  return 0;
}

// The most k whose table a warp holds in shared memory (larger tables are
// walked in device memory).
int lossy_max_shared_k(int* k) {
  *k = max_shared() / 12;
  return 0;
}

// The most k whose walk takes 32 tuples at a time (larger tables take one
// step a tuple), and the most whose lookups compare with every key
// (larger ones go through the hash index).
int lossy_group_k(int* group_k, int* broadcast_k) {
  *group_k = kGroupK;
  *broadcast_k = kBroadcastK;
  return 0;
}

// keys [n, k] i32, counts and error [n, k] f32 (updated in place); rows,
// items [T] i32; values [T] f32; mask [T] bytes (0 / 1); src [n_src] i32
// (data-source rows) or null; scratch: lossy_words(n, T) words, 128-byte
// aligned.
int lossy_scan(int32_t* keys, float* counts, float* error, int n, int k,
               const int32_t* rows, const int32_t* items,
               const float* values, const uint8_t* mask, int T,
               const int32_t* src, int n_src, int32_t* scratch,
               cudaStream_t stream) {
  if (T <= 0 || n <= 0) return 0;
  if (k < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (src == nullptr) n_src = 0;
  const sde::SortScratch s = sde::sort_scratch(scratch, T);
  int32_t* const key = scratch + key_word(T);
  uint8_t* flag = nullptr;
  cudaError_t err;
  if (n_src > 0) {
    flag = reinterpret_cast<uint8_t*>(scratch + flag_word(T));
    err = cudaMemsetAsync(flag, 0, (size_t)n, stream);
    if (err != cudaSuccess) return (int)err;
    flag_kernel<<<(n_src + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        src, n_src, n, flag);
  }
  key_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      rows, mask, T, n, flag, key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sde::sort_rows(key, n, T, s, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)walk(keys, counts, error, n, k, items, values, mask, T, src,
                   n_src, s, stream);
}

}  // extern "C"
