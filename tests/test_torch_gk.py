"""GK quantiles (``GKQuantiles``) in the port against the JAX package: the
running sums (``core/gk.blocked_cumsum``) against ``jnp.cumsum`` and the
search (``core/gk.searchsorted_scan``) against ``jnp.searchsorted``; the
one-row ``add_batch`` against the reference's, run op by op, over chained
batches (cold, idle and full rows, mask shares 0 to 1, ties, -0.0 with
0.0, +inf state values, +inf and NaN tuples, a state out of order); the
stacked update (``ref.gk_requantize_update`` and
``batched.stacked_update``'s scan branch) against a loop of the
reference's op-by-op ``add_batch`` over every row with its own mask, as
the reference's vmap masks it; the jitted reference ``stacked_update``
within its stated tolerance; the queries and the merge; and the engine's
JSON flow through ``SDE.handle`` in both packages, fused and unfused,
then carried across by ``convert.engine_from_contents``.

Byte for byte means float32 bytes: ``values`` and ``n`` compared as int32
bit patterns, so -0.0 differs from 0.0 and a NaN's payload counts. The
port's bytes are those of the reference run op by op, whose divisions are
true float32 divisions; under ``jit`` XLA multiplies by ``float32(1 /
m)`` instead (ROADMAP section 3a), which moves a few targets across a
midpoint rank, so the jitted reference is held to a tolerance."""
import bisect
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import batched as jbatched
from repro.service import SDE as JaxSDE
from test_torch_convert import jax_contents
from repro_torch import core as tcore
from repro_torch.convert import engine_from_contents
from repro_torch.core import batched as tbatched
from repro_torch.core import gk as tgk
from repro_torch.kernels import gk_requantize, probe, ref
from repro_torch.kernels import ops as tops
from repro_torch.service import SDE as TorchSDE
from repro_torch.service import routing


def _t(a):
    return torch.from_numpy(np.array(a))


def _bytes(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(
        np.int32).tobytes()


def _jstate(values, n):
    return dict(values=jnp.asarray(values), n=jnp.asarray(n, jnp.float32))


# ---------------------------------------------------------------------------
# the two helpers that fix the order of the reference's sums and search
# ---------------------------------------------------------------------------
def _cumsum_lengths():
    rng = np.random.RandomState(0)
    picked = set(rng.choice(np.arange(301, 5001), 100, replace=False))
    picked |= {511, 512, 513, 4095, 4096, 4097, 4111, 4112, 4113, 4352,
               5000}
    lengths = list(range(1, 301)) + sorted(int(x) for x in picked)
    return [lengths[i::8] for i in range(8)] + [[65936]]


_CUMSUM_CHUNKS = _cumsum_lengths()


def _weights(rng, length):
    """GK's weights (a state's n / m, a tuple's 1, a masked tuple's 0)
    mixed with arbitrary positive floats."""
    w = (rng.rand(length) * 1000).astype(np.float32)
    pick = rng.rand(length)
    w[pick < 0.3] = np.float32(12345) / np.float32(400)
    w[(pick >= 0.3) & (pick < 0.5)] = 1.0
    w[(pick >= 0.5) & (pick < 0.6)] = 0.0
    return w


@pytest.mark.parametrize("chunk", range(len(_CUMSUM_CHUNKS)))
def test_blocked_cumsum_matches_jnp_cumsum(chunk):
    """Every length from 1 to 300, 111 more up to 5,000 (the level
    boundaries 512 and 4,096 among them) and phase 3's 65,936 (m = 400
    plus a batch of 65,536): byte-equal to ``jnp.cumsum`` on the CPU, in
    a batch of rows as in one row. A sequential float32 scan parts from it
    at the longest length."""
    rng = np.random.RandomState(100 + chunk)
    for length in _CUMSUM_CHUNKS[chunk]:
        w = _weights(rng, length)
        want = np.asarray(jnp.cumsum(jnp.asarray(w)))
        assert _bytes(tgk.blocked_cumsum(_t(w)).numpy()) == _bytes(want), \
            length
    rows = np.stack([_weights(rng, length) for _ in range(3)])
    want = np.asarray(jnp.cumsum(jnp.asarray(rows), axis=-1))
    assert _bytes(tgk.blocked_cumsum(_t(rows)).numpy()) == _bytes(want)
    if length == 65936:
        assert _bytes(np.cumsum(w, dtype=np.float32)) != _bytes(
            np.asarray(jnp.cumsum(jnp.asarray(w))))


def test_blocked_cumsum_levels():
    """``levels=True`` returns the sums and each level's inclusive sums of
    the block totals: level l has ceil(L / 16**l) entries, up to the first
    level of 16 or fewer, and level 1 is the running sum of the level-0
    block totals taken the same way."""
    w = _t(_weights(np.random.RandomState(1), 5000))
    lev = tgk.blocked_cumsum(w, levels=True)
    assert [x.shape[0] for x in lev] == [5000, 313, 20, 2]
    assert torch.equal(lev[0], tgk.blocked_cumsum(w))
    pad = torch.cat([w, w.new_zeros(313 * 16 - 5000)]).view(313, 16)
    totals = pad[:, 0].clone()
    for j in range(1, 16):
        totals = totals + pad[:, j]
    assert torch.equal(lev[1], tgk.blocked_cumsum(totals))


@pytest.mark.parametrize("length", [1, 7, 16, 17, 400, 4496])
def test_searchsorted_scan_matches_jnp(length):
    """Sorted, non-monotone and tied arrays (phase 3's midpoint ranks are
    not monotone past the head), targets on entries, between them, below
    the first and above the last, -0.0 against 0.0 and NaN targets:
    ``jnp.searchsorted``'s default (method 'scan', side 'left') index for
    index, in one row and broadcast over rows."""
    rng = np.random.RandomState(length)
    base = np.cumsum(rng.rand(length)).astype(np.float32)
    shuffled = base.copy()
    shuffled[rng.rand(length) < 0.2] = rng.rand() * length
    tied = np.repeat(base[::3], 3)[:length].copy()
    tied[::5] = -0.0
    for cum in (base, shuffled, tied):
        targets = np.concatenate([
            cum[rng.randint(0, length, 20)], rng.rand(40) * length * 1.1,
            [-1.0, 0.0, -0.0, np.nan, np.inf]]).astype(np.float32)
        want = np.asarray(jnp.searchsorted(jnp.asarray(cum),
                                           jnp.asarray(targets)))
        got = tgk.searchsorted_scan(_t(cum), _t(targets)).numpy()
        assert np.array_equal(got, want)
        two = tgk.searchsorted_scan(_t(np.stack([cum, cum])),
                                    _t(np.stack([targets, targets])))
        assert np.array_equal(two.numpy(), np.stack([want, want]))


# ---------------------------------------------------------------------------
# the one-row update
# ---------------------------------------------------------------------------
def _row_state(rng, m, pattern):
    """(values, n) of one row: cold (zeros, n = 0), idle / all (sorted,
    n in the thousands), ties (values on a few steps, -0.0 and 0.0),
    nonfinite (+inf, -inf and a NaN among sorted values) or unsorted."""
    values = (rng.randn(m) * 10).astype(np.float32)
    n = np.float32(rng.randint(1000, 50000))
    if pattern == "cold":
        return np.zeros(m, np.float32), np.float32(0)
    if pattern in ("idle", "all"):
        values.sort()
    elif pattern == "ties":
        values = (np.round(values / 5) * 5).astype(np.float32)
        values[values == 0] = -0.0
        values[::7] = 0.0
        values.sort()
    elif pattern == "nonfinite":
        values.sort()
        values[-3:] = np.inf
        values[0] = -np.inf
    return values, n


def _row_batch(rng, t, share, pattern):
    vals = (rng.randn(t) * 10).astype(np.float32)
    if pattern == "ties":
        vals = (np.round(vals / 5) * 5).astype(np.float32)
        vals[rng.rand(t) < 0.3] = -0.0
    if pattern == "nonfinite":
        for x, p in ((np.inf, 0.1), (np.nan, 0.05), (-np.inf, 0.05)):
            vals[rng.rand(t) < p] = x
    mask = rng.rand(t) < share
    return vals, mask


_ADD_CASES = [
    (0.5, 1, 1.0, "cold"), (0.5, 15, 0.5, "ties"), (0.5, 16, 0.01, "idle"),
    (0.5, 17, 1.0, "all"), (0.5, 100, 0.5, "nonfinite"),
    (0.5, 4096, 0.5, "unsorted"), (0.01, 1, 0.0, "idle"),
    (0.01, 100, 0.5, "ties"), (0.01, 4096, 0.01, "idle"),
    (0.01, 17, 1.0, "nonfinite"), (0.01, 16, 0.5, "unsorted"),
    (0.01, 15, 0.0, "cold"), (0.01, 4096, 1.0, "all")]


@pytest.mark.parametrize("eps,t,share,pattern", _ADD_CASES)
def test_add_batch_matches_reference_op_by_op(eps, t, share, pattern):
    """m = 8 and 400; T = 1, 15, 16, 17, 100 and 4,096; four chained
    batches: ``values`` and ``n`` byte-equal to the reference's
    ``add_batch`` run op by op (not under ``jit``)."""
    jkind, kind = jcore.GKQuantiles(eps=eps), tcore.GKQuantiles(eps=eps)
    m = kind.m
    rng = np.random.RandomState(t + m)
    values, n = _row_state(rng, m, pattern)
    if pattern == "unsorted":
        rng.shuffle(values)
    jst = _jstate(values, n)
    st = dict(values=_t(values.copy()), n=_t(np.asarray(n)))
    for _ in range(4):
        vals, mask = _row_batch(rng, t, share, pattern)
        jst = jkind.add_batch(jst, None, jnp.asarray(vals),
                              jnp.asarray(mask))
        kind.add_batch(st, None, _t(vals), _t(mask))
        assert _bytes(st["values"].numpy()) == _bytes(jst["values"])
        assert _bytes(st["n"].numpy()) == _bytes(jst["n"])


# ---------------------------------------------------------------------------
# the stacked update
# ---------------------------------------------------------------------------
def _stack_case(rng, n, m, t, sources):
    """A stack of n rows (cold, idle, out of order, with +inf values) and
    a batch: rows -1 and n, masked tuples, ties, a few +inf and NaN
    tuples, the first source row also routed to."""
    values = (np.round(rng.randn(n, m) * 8) / 2).astype(np.float32)
    values[::2].sort(axis=1)
    counts = rng.randint(0, 20000, n).astype(np.float32)
    counts[::3] = 0
    values[::3] = 0
    values[1::4, -2:] = np.inf
    vals = (np.round(rng.randn(t) * 8) / 2).astype(np.float32)
    vals[rng.rand(t) < 0.1] = -0.0
    vals[rng.rand(t) < 0.01] = np.inf
    vals[rng.rand(t) < 0.005] = np.nan
    rows = rng.randint(0, n, t).astype(np.int32)
    rows[::11] = -1
    rows[5::13] = n
    if sources:
        rows[1::17] = sources[0]
    mask = rng.rand(t) < 0.8
    return values, counts, rows, vals, mask


def _reference_rows(jkind, values, counts, rows, vals, mask, sources):
    """The reference's vmap, row by row and op by op: row r takes
    ``mask & ((rows == r) | r is a source row)``."""
    out_v, out_n = values.copy(), counts.copy()
    for r in range(values.shape[0]):
        own = mask & ((rows == r) | (r in sources))
        st = jkind.add_batch(_jstate(values[r], counts[r]), None,
                             jnp.asarray(vals), jnp.asarray(own))
        out_v[r], out_n[r] = np.asarray(st["values"]), np.asarray(st["n"])
    return out_v, out_n


_STACK_CASES = [(8, 0.5, 4096, [3]), (8, 0.01, 4096, []),
                (12, 0.01, 100, [0, 11]), (16, 0.5, 17, [5])]


@pytest.mark.parametrize("route", ["plain", "stacked_update"])
@pytest.mark.parametrize("n,eps,t,sources", _STACK_CASES)
def test_stacked_update_matches_reference_rows(n, eps, t, sources, route):
    """Two chained batches on stacks of 8 to 16 rows, T = 17 to 4,096 (at
    4,096 an idle row's tail is 4,096 zero-weight entries long), source
    rows listed twice and routed to: every row, idle ones included,
    byte-equal to a loop of the reference's op-by-op ``add_batch`` with
    the row's mask. ``plain`` calls ``ref.gk_requantize_update``,
    ``stacked_update`` the scan branch of ``batched.stacked_update``
    (``GKQuantiles.scan_update``, whose CPU route is the same)."""
    jkind, kind = jcore.GKQuantiles(eps=eps), tcore.GKQuantiles(eps=eps)
    m = kind.m
    rng = np.random.RandomState(n + m + t)
    values, counts, _, _, _ = _stack_case(rng, n, m, t, sources)
    state = dict(values=_t(values.copy()), n=_t(counts.copy()))
    src = _t(np.asarray(sources + sources[:1], np.int64)) if sources else None
    for _ in range(2):
        _, _, rows, vals, mask = _stack_case(rng, n, m, t, sources)
        values, counts = _reference_rows(jkind, values, counts, rows, vals,
                                         mask, sources)
        if route == "plain":
            ref.gk_requantize_update(state["values"], state["n"], _t(rows),
                                     _t(vals), _t(mask), src, m=m)
        else:
            tbatched.stacked_update(kind, state, _t(rows),
                                    torch.zeros(t, dtype=torch.int32),
                                    _t(vals), _t(mask), src)
        assert _bytes(state["values"].numpy()) == _bytes(values)
        assert _bytes(state["n"].numpy()) == _bytes(counts)


def _neighbours(values_row, vals, own, a, b):
    """Whether ``a`` and ``b`` are equal or adjacent among the distinct
    sort keys of the row's m + T entries (its values, its own tuples and
    the +inf every other tuple stands for)."""
    entries = np.concatenate([values_row, np.where(own, vals, np.inf)])
    keys = np.unique(tgk.sort_key(_t(entries.astype(np.float32))).numpy())
    ka, kb = (int(tgk.sort_key(_t(np.asarray([x], np.float32)))[0])
              for x in (a, b))
    return abs(int(np.searchsorted(keys, ka)) - int(np.searchsorted(keys,
                                                                    kb))) <= 1


def test_jitted_reference_within_a_neighbour():
    """The reference's jitted ``stacked_update`` (its engine's path)
    against the port on 32 rows at m = 400 over one batch of 300 tuples.
    Under ``jit`` XLA multiplies by float32(1 / m) where the reference
    divides by m (the state weight n * r, the targets (i + 0.5) * r *
    total), which moves a target across a midpoint rank at most one entry
    of the row's merged order: so every value equals the jitted one or
    its neighbour among the row's distinct sorted values, and n is equal.
    The op-by-op reference equals the port byte for byte on the same
    batch."""
    jkind, kind = jcore.GKQuantiles(), tcore.GKQuantiles()
    m, n, t = kind.m, 32, 300
    rng = np.random.RandomState(9)
    values, counts, rows, vals, mask = _stack_case(rng, n, m, t, [4])
    vals[~np.isfinite(vals)] = 1.0
    jitted = jax.jit(lambda st, r, v, k, s: jbatched.stacked_update(
        jkind, st, r, jnp.zeros(t, jnp.uint32), v, k, s))
    jst = jitted(_jstate(values, counts), jnp.asarray(rows),
                 jnp.asarray(vals), jnp.asarray(mask),
                 jnp.asarray([4], jnp.int32))
    state = dict(values=_t(values.copy()), n=_t(counts.copy()))
    ref.gk_requantize_update(state["values"], state["n"], _t(rows), _t(vals),
                             _t(mask), _t(np.asarray([4])), m=m)
    got, want = state["values"].numpy(), np.asarray(jst["values"])
    assert _bytes(state["n"].numpy()) == _bytes(jst["n"])
    for r in range(n):
        own = mask & ((rows == r) | (r == 4))
        for a, b in zip(got[r], want[r]):
            assert _bytes(a) == _bytes(b) or _neighbours(values[r], vals,
                                                         own, a, b)
    exact_v, _ = _reference_rows(jkind, values, counts, rows, vals, mask,
                                 [4])
    assert _bytes(got) == _bytes(exact_v)


# ---------------------------------------------------------------------------
# the requantize kernel's per-row decisions (csrc/gk_requantize.cu)
# ---------------------------------------------------------------------------
_WARP, _BLOCK = 32, 256    # a team: a row without tuples, a row with them
_LEVELS = 8                # the kernel's kLevels


def _tail_levels(p, h):
    """The level whose sum at the head's last entry each virtual position
    ``p`` >= h reads (the kernel's ``tail_level``)."""
    j, last = p.clone(), torch.full_like(p, h - 1)
    lvl = torch.full_like(p, _LEVELS - 1)
    done = torch.zeros_like(p, dtype=torch.bool)
    for i in range(_LEVELS - 1):
        hit = ~done & ((j >> 4) == (last >> 4))
        lvl[hit] = i
        done |= hit
        j, last = (j >> 4) - 1, last >> 4
    return lvl


def _sweep(kc, kt, h, big, team):
    """The kernel's sweep: member i of a team of ``team`` takes a
    contiguous run of the targets, places its first by a lower bound over
    the head's keys ``kc`` and walks on from there for each next one.
    Returns each target's position, ``h`` for one past the head (+inf
    where the row has a tail, else clipped to h - 1)."""
    m = len(kt)
    per = -(-m // team)
    idx = []
    for i0 in range(0, m, per):
        p = bisect.bisect_left(kc, kt[i0], 0, h)
        for i in range(i0, min(m, i0 + per)):
            while p < h and kc[p] < kt[i]:
                p += 1
            idx.append(p if p < h or big > h else h - 1)
    return torch.tensor(idx, dtype=torch.int64)


def _kernel_row(values, n, own, big, team, taken):
    """One row of a stack as the kernel updates it, with no +inf or NaN
    among its own tuples ``own`` (batch order) and no NaN state; ``big``
    = m + T. The order check: a state whose keys do not fall by slot is
    its own sorted order (no sort), else it is sorted stably. The
    monotone check: where the midpoint ranks of the head rise, the tail's
    level sums after them rise over the levels read up to ``big`` and the
    row's total is not below 0 (the targets then rise), every target is
    placed by the sweep; else by the halvings of ``searchsorted_scan``
    over the whole virtual row. Counts each decision in ``taken``."""
    m, k = values.shape[0], own.shape[0]
    key = tgk.sort_key(values)
    in_order = bool((key[:-1] <= key[1:]).all())
    state = values if in_order else values[torch.sort(key,
                                                      stable=True).indices]
    own = own[torch.sort(tgk.sort_key(own), stable=True).indices]
    head_v = torch.cat([state, own])
    head_w = torch.cat([tgk.true_div(n.expand(m), m), torch.ones(k)])
    merged = torch.sort(tgk.sort_key(head_v), stable=True).indices
    hv, hw = head_v[merged], head_w[merged]
    h = m + k
    lev = tgk.blocked_cumsum(hw, levels=True)
    c = lev[0] - 0.5 * hw
    s_v = torch.stack([x[-1] for x in lev] + [lev[-1][-1]] *
                      (_LEVELS - len(lev)))
    virtual = torch.cat([c, s_v[_tail_levels(torch.arange(h, big), h)]])
    kc, ks = tgk.sort_key(c).tolist(), tgk.sort_key(s_v).tolist()
    rising = all(a <= b for a, b in zip(kc, kc[1:]))
    if big > h:
        reads = _tail_levels(torch.tensor([h, big - 1]), h).tolist()
        chain = [kc[-1]] + ks[reads[0]:reads[1] + 1]
        tail_rising = all(a <= b for a, b in zip(chain, chain[1:]))
    else:
        tail_rising = True
    kv = tgk.sort_key(virtual)
    # the chain over the levels read is exactly the virtual row rising
    assert (rising and tail_rising) == bool((kv[:-1] <= kv[1:]).all())
    total = n + torch.tensor(float(k))
    sweep = rising and tail_rising and bool(total >= 0)
    targets = tgk.targets_of(m, total)
    if sweep:
        idx = _sweep(kc, tgk.sort_key(targets).tolist(), h, big, team)
        taken["tail"] += int(idx[-1] >= h)
    else:
        idx = tgk.searchsorted_scan(virtual, targets).clamp(max=big - 1)
    taken["in_order" if in_order else "sorted"] += 1
    taken["sweep" if sweep else ("halvings, tail" if rising else
                                 "halvings, head")] += 1
    taken["warp halvings"] += team == _WARP and not sweep
    got = hv[idx.clamp(max=h - 1)]
    return torch.where(idx < h, got, torch.full_like(got, np.inf)), total


def _kernel_model(values, counts, rows, vals, mask, sources):
    """The stacked update as the kernel routes each row: a data-source
    row, a row with a +inf or NaN own tuple or NaN state, or one whose
    head passes the small rows' room, through ``core/gk.add_row`` (the
    big-row pass); a row without tuples whose state is in order on a
    warp; every other row on a block. Returns (values, n, taken): the
    count of rows by path and by each check's outcome."""
    n, m = values.shape
    big = m + vals.shape[0]
    cap = 2 ** int(np.ceil(np.log2(m))) + 512
    keep = mask & (rows >= 0) & (rows < n) & ~torch.isin(
        rows, torch.tensor(sorted(sources), dtype=rows.dtype))
    out_v, out_n = values.clone(), counts.clone()
    taken = collections.Counter()
    for r in range(n):
        own_mask = mask if r in sources else keep & (rows == r)
        own = vals[own_mask]
        key = tgk.sort_key(values[r])
        if (r in sources or torch.isnan(values[r]).any()
                or (torch.isnan(own) | (own == np.inf)).any()
                or m + own.shape[0] > cap):
            out_v[r], out_n[r] = tgk.add_row(values[r], counts[r], vals,
                                             own_mask, m)
            taken["big"] += 1
            continue
        warp = own.shape[0] == 0 and bool((key[:-1] <= key[1:]).all())
        taken["warp" if warp else "block"] += 1
        out_v[r], out_n[r] = _kernel_row(values[r], counts[r], own, big,
                                         _WARP if warp else _BLOCK, taken)
    return out_v, out_n, taken


def _model_case(rng, n, m, t, pattern):
    """A stack of n rows and a batch for the kernel's model, over the
    rows each check meets. Row 0 is the data-source row; rows 1 to n / 3
    take a few tuples each (for ``wide`` and ``huge`` rows 1 to n - 2
    hundreds), the others none; the rest of the batch is masked out, or
    masked in and routed to rows -1 and n (zero-weight tail entries of
    every row):

      unsorted_idle  counts in the thousands, half the rows' values out of
                     order
      inf_top        rows in order whose top values are +inf
      ties           values on a few steps, -0.0 and 0.0 side by side in
                     slot order
      cold           every row at n = 0, its values zero
      wide           heads past 256 entries, whose masked tails' level
                     sums need not rise; counts below 10**6, not whole
      huge           counts near 2**30, where a tuple's weight is below a
                     sum's rounding and the head's midpoint ranks need
                     not rise
    """
    counts = rng.randint(1000, 10000, n).astype(np.float32)
    values = np.sort((rng.randn(n, m) * 10).astype(np.float32), axis=1)
    if pattern == "unsorted_idle":
        for r in range(0, n, 2):
            rng.shuffle(values[r])
    elif pattern == "inf_top":
        values[:, -max(1, m // 8):] = np.inf
    elif pattern == "ties":
        values = np.sort(np.round(values / 8).astype(np.float32), axis=1)
        values[:, ::2][values[:, ::2] == 0] = -0.0
    elif pattern == "cold":
        counts[:] = 0
        values[:] = 0
    elif pattern == "wide":
        counts = (rng.rand(n) * 10**6).astype(np.float32)
    elif pattern == "huge":
        counts = (2.0**30 + rng.randint(0, 2**20, n)).astype(np.float32)
    vals = (rng.randn(t) * 10).astype(np.float32)
    if pattern == "ties":
        vals = np.round(vals / 8).astype(np.float32)
        vals[rng.rand(t) < 0.3] = -0.0
    rows = np.where(rng.rand(t) < 0.5, -1, n).astype(np.int32)
    mask = rng.rand(t) < 0.5
    many = pattern in ("wide", "huge")
    pos = rng.permutation(t)
    at = 0
    for r in range(1, n - 1 if many else n // 3):
        k = rng.randint(250, 500) if many else rng.randint(1, 20)
        rows[pos[at:at + k]] = r
        mask[pos[at:at + k]] = True
        at += k
    return values, counts, rows, vals, mask


# (eps, T, pattern, the outcomes its rows must show)
_COMMON = ("warp", "block", "sweep")
_MODEL_CASES = [
    (0.5, 16384, "unsorted_idle", _COMMON + ("in_order", "sorted")),
    (0.5, 16384, "inf_top", _COMMON + ("in_order",)),
    (0.5, 16384, "ties", _COMMON + ("in_order",)),
    (0.5, 16384, "cold", _COMMON + ("tail",)),
    (0.5, 16384, "wide", ("block", "sweep")),
    (0.5, 16384, "huge", ("block", "sweep", "tail", "halvings, head",
                          "halvings, tail")),
    (0.01, 65536, "unsorted_idle", _COMMON + ("in_order", "sorted", "tail",
                                              "halvings, tail")),
    (0.01, 65536, "inf_top", _COMMON + ("tail",)),
    (0.01, 65536, "ties", _COMMON + ("tail",)),
    (0.01, 65536, "cold", _COMMON + ("tail",)),
    (0.01, 65536, "wide", ("block", "sweep", "tail", "halvings, tail")),
    (0.01, 65536, "huge", ("block", "sweep", "halvings, head")),
    (0.003, 16384, "ties", _COMMON + ("warp halvings",)),
    (0.003, 65536, "unsorted_idle", _COMMON + ("in_order", "sorted",
                                               "warp halvings")),
    (0.003, 16384, "huge", ("block", "sweep", "halvings, head",
                            "warp halvings"))]


@pytest.mark.parametrize("eps,t,pattern,expect", _MODEL_CASES)
def test_kernel_model_matches_plain_version(eps, t, pattern, expect):
    """The kernel's per-row decisions, modelled here (:func:`_kernel_row`),
    byte-equal to the plain version (``ref.gk_requantize_update``) over
    two chained batches at m = 8 (T = 16,384), m = 400 (T = 65,536) and
    m = 1,334 (not a multiple of 16: a warp row's tail reads the head's
    level-0 sum, whose rounding may fall below level 1's): each check's
    shortcut (a state in order read as it stands, the targets placed by
    the sweep) and its fallback (the sort, the halvings over the whole
    virtual row, for a head or a tail that does not rise, on a block and
    on a warp) taken where the pattern's rows call for it, the sweep's
    last target past the head (+inf) among them. The check over the tail
    is held to the whole virtual row rising, position by position. The
    plain version is held in turn to a loop of the reference's op-by-op
    ``add_batch`` on the same rows, at these sizes and counts (heads past
    256 entries, counts near 2**30)."""
    jkind = jcore.GKQuantiles(eps=eps)
    m = tgk.GKQuantiles(eps=eps).m
    rng = np.random.RandomState(t + m + len(pattern))
    n = 24
    values, counts, rows, vals, mask = _model_case(rng, n, m, t, pattern)
    state = dict(values=_t(values), n=_t(counts))
    model_v, model_n = _t(values), _t(counts)
    taken = collections.Counter()
    for _ in range(2):
        values, counts = _reference_rows(jkind, values, counts, rows, vals,
                                         mask, {0})
        ref.gk_requantize_update(state["values"], state["n"], _t(rows),
                                 _t(vals), _t(mask), _t(np.asarray([0])),
                                 m=m)
        model_v, model_n, step = _kernel_model(model_v, model_n, _t(rows),
                                               _t(vals), _t(mask), {0})
        taken += step
        assert _bytes(state["values"].numpy()) == _bytes(values)
        assert _bytes(state["n"].numpy()) == _bytes(counts)
        assert _bytes(model_v.numpy()) == _bytes(state["values"].numpy())
        assert _bytes(model_n.numpy()) == _bytes(state["n"].numpy())
        _, _, rows, vals, mask = _model_case(rng, n, m, t, pattern)
    missing = [k for k in expect if taken[k] == 0]
    assert not missing, (missing, taken)


# ---------------------------------------------------------------------------
# queries and merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eps", [0.5, 0.01])
def test_queries_and_merge_match_reference(eps):
    """``estimate``, ``stacked_estimate`` and ``rank`` byte-equal to the
    reference's with ``qs`` in [-0.5, 1.5] (clipped reads at both ends)
    and x on and between the values; ``merge`` byte-equal, also of two
    empty rows (the 1e-9 floor) and of an empty with a full one."""
    jkind, kind = jcore.GKQuantiles(eps=eps), tcore.GKQuantiles(eps=eps)
    m = kind.m
    rng = np.random.RandomState(m)
    values = np.sort((rng.randn(6, m) * 3).astype(np.float32), axis=1)
    values[2, :5] = -0.0
    counts = rng.randint(1, 9000, 6).astype(np.float32)
    qs = np.concatenate([np.linspace(-0.5, 1.5, 41),
                         [0.0, 1.0, 1.0 / m, 0.5]]).astype(np.float32)
    for r in range(6):
        jst = _jstate(values[r], counts[r])
        st = dict(values=_t(values[r]), n=_t(np.asarray(counts[r])))
        assert _bytes(kind.estimate(st, _t(qs)).numpy()) == _bytes(
            jkind.estimate(jst, jnp.asarray(qs)))
        x = np.concatenate([values[r, ::7], rng.randn(9) * 3]).astype(
            np.float32)
        assert _bytes(kind.rank(st, _t(x)).numpy()) == _bytes(
            jkind.rank(jst, jnp.asarray(x)))
    rows = np.asarray([5, 0, 2, 2], np.int32)
    qs2 = qs[:8][None, :].repeat(4, 0) + np.arange(4, dtype=np.float32)[
        :, None] / 10
    stack = dict(values=_t(values), n=_t(counts))
    assert _bytes(kind.stacked_estimate(stack, _t(rows), _t(qs2)).numpy()) \
        == _bytes(jkind.stacked_estimate(_jstate(values, counts),
                                         jnp.asarray(rows),
                                         jnp.asarray(qs2)))
    zero = np.zeros(m, np.float32)
    for (va, na), (vb, nb) in (((values[0], counts[0]),
                                (values[1], counts[1])),
                               ((zero, 0.0), (zero, 0.0)),
                               ((zero, 0.0), (values[3], counts[3]))):
        a = dict(values=_t(va), n=_t(np.asarray(na, np.float32)))
        b = dict(values=_t(vb), n=_t(np.asarray(nb, np.float32)))
        got = kind.merge(a, b)
        want = jkind.merge(_jstate(va, na), _jstate(vb, nb))
        assert _bytes(got["values"].numpy()) == _bytes(want["values"])
        assert _bytes(got["n"].numpy()) == _bytes(want["n"])


@pytest.mark.smoke
def test_kind_matches_reference_shape():
    """m = max(8, ceil(4 / eps)) as the reference's, the registry name,
    status params, memory bytes, and an init that needs a device; the
    wrappers refuse a tensor on neither the CPU nor a card."""
    for eps in (0.9, 0.5, 0.03, 0.01, 0.001):
        assert tcore.GKQuantiles(eps=eps).m == jcore.GKQuantiles(eps=eps).m
    kind = tcore.make_kind("gk_quantiles")
    assert tcore.kind_params(kind) == {"eps": 0.01, "seed": 43}
    assert kind.memory_bytes() == 1600 and kind.update_kernel == \
        "gk_requantize"
    with pytest.raises(TypeError):
        kind.init()
    st = tbatched.stacked_init(kind, 3, "cpu")
    assert st["values"].shape == (3, 400) and st["n"].shape == (3,)
    meta = torch.zeros((2, 400), device="meta")
    with pytest.raises(ValueError):
        gk_requantize.gk_requantize_update(
            meta, torch.zeros(2, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, device="meta"),
            torch.ones(1, dtype=torch.bool, device="meta"), m=400)


def test_card_check_refuses_only_states_past_the_kernel():
    """The check a build on the card makes (``ops.check_on_card``) passes
    every m up to the requantize kernel's largest, 2**20, and refuses one
    past it; the CPU engine builds and serves such an eps all the same,
    as the reference does."""
    top = 4 / gk_requantize.MAX_M
    for eps in (0.01, 0.0005, 4 / 4096, top):
        kind = tcore.make_kind("gk_quantiles", eps=eps)
        assert kind.m <= gk_requantize.MAX_M
        tops.check_on_card(kind)
    tops.check_on_card(tcore.make_kind("countmin", eps=1e-6, delta=0.01))
    fine = tcore.make_kind("gk_quantiles", eps=3e-6)
    assert fine.m == jcore.GKQuantiles(eps=3e-6).m > gk_requantize.MAX_M
    with pytest.raises(ValueError, match="at most 1048576"):
        tops.check_on_card(fine)
    te = TorchSDE(device="cpu")
    r = te.handle({"type": "build", "request_id": "b", "synopsis_id": "g",
                   "kind": "gk_quantiles", "params": {"eps": 0.0005}})
    assert r.ok, r.error
    te.ingest(np.asarray([-1, 5], np.int64),
              np.asarray([1.0, 2.0], np.float32))
    assert float(te.state_of("g")["n"]) == 1.0       # id -1 is masked


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
SMALL = {"eps": 0.05}                  # m = 80


def _engine_requests(rng, ids, extra, t=300):
    reqs = [
        {"type": "build", "request_id": "b-gk", "synopsis_id": "gk",
         "kind": "gk_quantiles", "params": SMALL,
         "per_stream_of_source": True, "stream_ids": ids},
        {"type": "build", "request_id": "b-src", "synopsis_id": "src-gk",
         "kind": "gk_quantiles", "params": SMALL},
        {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-gk",
         "kind": "gk_quantiles", "params": SMALL, "continuous": True},
        {"type": "build", "request_id": "b-one", "synopsis_id": "one",
         "kind": "gk_quantiles", "stream_id": extra},
    ]
    pop = np.asarray(ids, np.int64)
    batches = []
    for b in range(3):
        sids = pop[(rng.zipf(1.2, t) - 1) % len(pop)].copy()
        sids[::9] = extra
        sids[::11] = rng.randint(0, 2**62, len(sids[::11])) | 1
        sids[::17] = -3                               # negative: masked
        vals = np.round(rng.randn(t) * 20, 1).astype(np.float32)
        vals[::23] = -0.0
        batches.append((sids, vals))
        reqs.append({"type": "ingest", "request_id": f"i{b}",
                     "stream_ids": [int(x) for x in sids],
                     "values": [float(x) for x in vals]})
    return reqs, batches


def _replay(te, jkind_of, batches):
    """Every row of each port stack from init through the batches, row by
    row with the reference's op-by-op ``add_batch`` and the row's mask
    (the port's own routing table probed as the engine probes it)."""
    out = {}
    for kind, stack in te.stacks.items():
        jkind = jkind_of[kind.eps]
        klo, khi, trows = stack.device_table()
        src = set(stack.source_rows)
        values = np.zeros((stack.capacity, kind.m), np.float32)
        counts = np.zeros(stack.capacity, np.float32)
        for sids, vals in batches:
            lo, hi = routing.split64(sids.astype(np.int64))
            rows = probe.probe_rows(klo, khi, trows, _t(lo.view(np.int32)),
                                    _t(hi.view(np.int32)),
                                    n_probe=stack.n_probe).numpy()
            values, counts = _reference_rows(jkind, values, counts, rows,
                                             vals, sids >= 0, src)
        out[kind] = (values, counts)
    return out


def _within_rank(x, data, q, eps):
    """The reference's rank bound (``tests/test_properties.py``): x lies
    within 6 eps + 1 / N of the q-quantile of ``data``, ties safe."""
    tol = 6 * eps + 1.0 / len(data)
    q = min(max(float(q), 0.0), 1.0)
    return ((data < x).mean() <= q + tol) and ((data <= x).mean() >= q - tol)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_engine_json_flow_matches_jax_engine(monkeypatch, fused):
    """Per-stream (70 streams, 128 rows), data-source and continuous GK at
    eps 0.05 and a single-stream one at the defaults through
    ``SDE.handle``: the same responses' ids and ok flags (a bad ``qs``
    failing alone with the reference's error, a malformed entry, an
    unknown synopsis), the same status; each stack, every row, byte-equal
    to an op-by-op replay of the reference's ``add_batch`` with the row's
    mask, and each answer (adhoc, query_many, continuous) equal to the
    replay's. Against the JAX engine (its ``jit`` rewrites the division
    by m, ROADMAP section 3a), each answer equals its answer or both lie
    within the reference's rank bound of the exact quantile of what the
    row was fed. Then stop, rebuild (reads 0) and a converted engine
    whose stacks equal the reference's byte for byte and answer as it
    does. Each ingest takes the registry route: the fused entry, or the
    plain probe and the rows-given one."""
    monkeypatch.setenv("SDE_FUSED_PROBE", "1" if fused else "0")
    calls = collections.Counter()
    for name in ("gk_probe_requantize_update", "gk_requantize_update"):
        real = getattr(gk_requantize, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(gk_requantize, name, spy)
    rng = np.random.RandomState(37)
    ids = [int(s) for s in np.unique(rng.randint(0, 2**63 - 1, size=70,
                                                 dtype=np.int64))]
    extra = int(rng.randint(0, 2**62))
    reqs, batches = _engine_requests(rng, ids, extra)
    queries = (
        [{"synopsis_id": f"gk/{i}", "query": {"qs": [0.1, 0.5, 0.9]}}
         for i in ids[:30]]
        + [{"synopsis_id": "src-gk",
            "query": {"qs": [0.01, 0.25, 0.5, 0.75, 0.99]}},
           {"synopsis_id": "one", "query": {"qs": [0.5, -0.2, 1.7]}},
           {"synopsis_id": "cq-gk"}, {"synopsis_id": f"gk/{ids[0]}"},
           {"synopsis_id": "src-gk", "query": {"qs": "x"}},
           {"synopsis_id": "nope"}, 5])
    reqs += [
        {"type": "adhoc", "request_id": "q-src", "synopsis_id": "src-gk",
         "query": {"qs": [0.5, 0.9, 0.1]}},
        {"type": "adhoc", "request_id": "q-bad", "synopsis_id": "one",
         "query": {"qs": [[0.5], [0.1, 0.2]]}},
        {"type": "query_many", "request_id": "qm", "queries": queries},
        {"type": "status", "request_id": "st"}]
    je, te = JaxSDE(), TorchSDE(device="cpu")
    before = tops.DISPATCH_COUNT["update:GKQuantiles"]
    got = {}
    for r in reqs:
        ra, rb = je.handle(dict(r)), te.handle(dict(r))
        assert (ra.request_id, ra.synopsis_id, ra.ok, ra.error) == \
            (rb.request_id, rb.synopsis_id, rb.ok, rb.error), (ra, rb)
        assert r["type"] != "build" or rb.ok, rb.error
        if r["type"] == "status":
            assert ra.value == rb.value
        elif isinstance(rb.value, list):
            for a, b in zip(ra.value, rb.value, strict=True):
                assert (a["request_id"], a["ok"], a["error"]) == \
                    (b["request_id"], b["ok"], b["error"])
                if b["ok"]:
                    got[b["request_id"]] = (a["value"], b["value"])
        elif r["type"] == "adhoc" and rb.ok:
            got[r["request_id"]] = (ra.value, rb.value)
    n_ingest = len(batches)
    assert tops.DISPATCH_COUNT["update:GKQuantiles"] - before == \
        2 * n_ingest               # two kind stacks: eps 0.05 and 0.01
    route = "gk_probe_requantize_update" if fused else "gk_requantize_update"
    assert calls == {route: 2 * n_ingest}
    # every stack row against the op-by-op replay
    jkind_of = {e: jcore.GKQuantiles(eps=e) for e in (0.05, 0.01)}
    replay = _replay(te, jkind_of, batches)
    for kind, (values, counts) in replay.items():
        state = te.stacks[kind].state
        assert _bytes(state["values"].numpy()) == _bytes(values)
        assert _bytes(state["n"].numpy()) == _bytes(counts)
    # answers: the replay's exactly; the JAX engine's within the bound
    fed = collections.defaultdict(list)
    for sids, vals in batches:
        for s, v in zip(sids, vals):
            if s >= 0:
                fed[int(s)].append(v)
                fed[None].append(v)
    qs_of = {"q-src": [0.5, 0.9, 0.1]}
    sid_of = {"q-src": "src-gk"}
    for i, q in enumerate(queries[:34]):
        qs_of[f"qm/{i}"] = q.get("query", {}).get("qs", [0.5])
        sid_of[f"qm/{i}"] = q["synopsis_id"]
    for rid, (a, b) in got.items():
        e = te.entries[sid_of[rid]]
        values, _ = replay[e.kind_key]
        qs = np.asarray(qs_of[rid], np.float32)
        idx = np.clip((qs * e.kind_key.m).astype(np.int32), 0,
                      e.kind_key.m - 1)
        assert _bytes(b) == _bytes(values[e.row][idx]), rid
        data = np.asarray(fed[e.stream_id], np.float32)
        for x, y, q in zip(a, b, qs):
            assert _bytes(x) == _bytes(y) or (
                _within_rank(x, data, q, e.kind_key.eps)
                and _within_rank(y, data, q, e.kind_key.eps)), (rid, q)
    assert [r.request_id for r in je.continuous_out] == \
        [r.request_id for r in te.continuous_out]
    assert len(te.continuous_out) == n_ingest
    cq = te.entries["cq-gk"]          # the default qs [0.5]: index m / 2
    assert _bytes(list(te.continuous_out)[-1].value) == \
        _bytes(replay[cq.kind_key][0][cq.row][[cq.kind_key.m // 2]])
    # stop and rebuild: a fresh row reads 0
    for r in ({"type": "stop", "request_id": "s", "synopsis_id": "gk"},
              {"type": "build", "request_id": "b-again", "synopsis_id": "gk",
               "kind": "gk_quantiles", "params": SMALL,
               "per_stream_of_source": True, "stream_ids": ids[:10]}):
        assert je.handle(dict(r)).ok and te.handle(dict(r)).ok
    r = te.handle({"type": "adhoc", "request_id": "z",
                   "synopsis_id": f"gk/{ids[2]}", "query": {"qs": [0.5]}})
    assert r.ok and float(r.value[0]) == 0.0
    # carried into a fresh port engine: the reference's stacks, byte for
    # byte, answer as the reference does
    tc = engine_from_contents(jax_contents(je), device="cpu")
    for sid in je.entries:
        a, b = je.state_of(sid), tc.state_of(sid)
        assert sorted(b) == ["n", "values"]
        assert b["values"].dtype == torch.float32 and b["n"].dim() == 0
        assert _bytes(b["values"].numpy()) == _bytes(a["values"])
        assert _bytes(b["n"].numpy()) == _bytes(a["n"])
    q = {"type": "query_many", "request_id": "qc", "queries": [
        {"synopsis_id": s, "query": {"qs": [0.0, 0.3, 0.99]}}
        for s in ("src-gk", "one", f"gk/{ids[5]}", "cq-gk")]}
    ra, rb = je.handle(dict(q)), tc.handle(dict(q))
    assert ra.to_json() == rb.to_json()
