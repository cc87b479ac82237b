"""Plain PyTorch versions of the hand-written kernels (port of the
scatter, sliding-DFT, pairwise-correlation and attention oracles in
``repro/kernels/ref.py``, and of the one-hot max cube of
``repro/kernels/bitset_or.py``, which has no oracle there; and the
stacked scans of Lossy Counting, of the reservoir sampler and of Sticky
Sampling, and GK's stacked requantize, whose reference is no kernel but
the kind's ``add_batch`` under the vmap of ``batched.stacked_update``).

The wrappers run these on CPU tensors; ``chip_smoke.py`` holds each CUDA
kernel against them on the card. The updates work in place (the
reference's sliding-DFT oracle returns new planes); the pairwise
correlation and the attention return a new tensor, or fill ``out``.

Unlike the reference's CountMin oracle, whose ``.at[-1]`` wraps a
``syn_idx = -1`` tuple onto the LAST row, these drop rows outside
``[0, n)``, as the kernels and the engine's own path
(``core/batched.py``) do. (The reference's RHP oracle zeroes a ``-1``
tuple's value instead, which drops it too.)
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import gk, lossy, sampler, sticky
from . import probe


def onehot_scatter_add(counts: torch.Tensor, syn_idx: torch.Tensor,
                       idx: torch.Tensor, values: torch.Tensor,
                       signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``counts[s, j, idx[t, j]] += values[t] * signs[t, j]`` for every
    tuple t with ``syn_idx[t] = s`` in ``[0, n)``; ``signs=None`` means +1.
    counts [n, d, w] f32; syn_idx [T] i32; idx [T, d] i32; values [T] f32;
    signs [T, d] f32."""
    n, d, _ = counts.shape
    keep = (syn_idx >= 0) & (syn_idx < n)
    ix = idx[keep].long()
    v = values[keep][:, None]
    v = v.expand(ix.shape) if signs is None else v * signs[keep]
    rows = syn_idx[keep].long()[:, None].expand(ix.shape)
    js = torch.arange(d, device=counts.device)[None, :].expand(ix.shape)
    counts.index_put_((rows, js, ix), v.contiguous(), accumulate=True)
    return counts


def hll_max_update(regs: torch.Tensor, syn_idx: torch.Tensor,
                   bucket: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """``regs[s, bucket[t]] = max(regs[s, bucket[t]], rank[t])`` for every
    tuple t with ``syn_idx[t] = s`` in ``[0, n)``, ``bucket[t]`` in
    ``[0, m)`` and ``rank[t] > 0`` (the rows, registers and ranks the
    reference's one-hot cube matches; rank 0 is the masked no-op).
    regs [n, m] i32; syn_idx/bucket/rank [T] i32."""
    n, m = regs.shape
    keep = ((syn_idx >= 0) & (syn_idx < n) & (bucket >= 0) & (bucket < m)
            & (rank > 0))
    flat = syn_idx[keep].long() * m + bucket[keep].long()
    regs.view(-1).scatter_reduce_(0, flat, rank[keep], reduce="amax")
    return regs


def bitset_max_update(bits: torch.Tensor, syn_idx: torch.Tensor,
                      idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """``bits[s, idx[t, h]] = max(bits[s, idx[t, h]], upd[t])`` for every
    tuple t with ``syn_idx[t] = s`` in ``[0, n)``, every h < k whose
    position lies in ``[0, m)``, and ``upd[t] > 0`` (the rows, positions
    and values the reference's one-hot cube matches).
    bits [n, m] i32; syn_idx [T] i32; idx [T, k] i32; upd [T] i32."""
    n, m = bits.shape
    keep = (syn_idx >= 0) & (syn_idx < n) & (upd > 0)
    pos = idx[keep].long()
    flat = syn_idx[keep].long()[:, None] * m + pos
    vals = upd[keep][:, None].expand(pos.shape)
    ok = (pos >= 0) & (pos < m)
    bits.view(-1).scatter_reduce_(0, flat[ok], vals[ok], reduce="amax")
    return bits


def rhp_project_update(state: torch.Tensor, syn_idx: torch.Tensor,
                       values: torch.Tensor,
                       signs: torch.Tensor) -> torch.Tensor:
    """``state[s, :] += values[t] * signs[t, :]`` for every tuple t with
    ``syn_idx[t] = s`` in ``[0, n)``; on the CPU ``index_add_`` adds them
    in batch order, as the kernel does (on the card it adds in no fixed
    order). state [n, b] f32; syn_idx [T] i32; values [T] f32 (mask
    folded in); signs [T, b] f32."""
    n = state.shape[0]
    keep = (syn_idx >= 0) & (syn_idx < n)
    state.index_add_(0, syn_idx[keep].long(),
                     values[keep][:, None] * signs[keep])
    return state


def rhp_probe_update(state: torch.Tensor, keys_lo: torch.Tensor,
                     keys_hi: torch.Tensor, table_rows: torch.Tensor,
                     sid_lo: torch.Tensor, sid_hi: torch.Tensor,
                     values: torch.Tensor, signs: torch.Tensor, *,
                     n_probe: int) -> torch.Tensor:
    """The routing probe (``probe.probe_rows``), then
    :func:`rhp_project_update`."""
    rows = probe.probe_rows(keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
                            n_probe=n_probe)
    return rhp_project_update(state, rows, values, signs)


def _walks(syn_idx: torch.Tensor, mask: torch.Tensor, n: int,
           source_rows: Optional[torch.Tensor]):
    """The rows a stacked scan walks, each with its tuples in batch order:
    each row r in ``[0, n)`` the tuples with ``mask & (syn_idx == r)``,
    grouped by ``torch.sort(stable=True)``, then each data-source row
    (``source_rows``) every tuple with ``mask``, routed or not (once,
    however often it is listed; its routed tuples are not taken twice).
    Yields (row, index or bool mask of its tuples)."""
    keep = mask & (syn_idx >= 0) & (syn_idx < n)
    src = []
    if source_rows is not None:
        src = sorted({int(r) for r in source_rows.tolist() if 0 <= r < n})
        is_src = torch.zeros(n, dtype=torch.bool, device=syn_idx.device)
        is_src[src] = True
        keep &= ~is_src[syn_idx.clamp(0, n - 1).long()]
    rows, order = torch.sort(syn_idx[keep], stable=True)
    tix = torch.nonzero(keep)[:, 0][order]
    uniq, sizes = torch.unique_consecutive(rows, return_counts=True)
    yield from zip(uniq.tolist(), torch.split(tix, sizes.tolist()))
    for r in src:
        yield r, mask


def lossy_scan_update(keys: torch.Tensor, counts: torch.Tensor,
                      error: torch.Tensor, syn_idx: torch.Tensor,
                      items: torch.Tensor, values: torch.Tensor,
                      mask: torch.Tensor,
                      source_rows: Optional[torch.Tensor] = None) -> None:
    """Lossy Counting's stacked scan, in place: each walked row
    (:func:`_walks`) goes through the one-row scan
    (``core/lossy.scan_row``) over its tuples; other rows are untouched.
    keys [n, k] i32 (-1 empty); counts, error [n, k] f32; syn_idx, items
    [T] i32; values [T] f32; mask [T] bool."""
    if keys.shape[0] == 0:
        return
    for r, part in _walks(syn_idx, mask, keys.shape[0], source_rows):
        lossy.scan_row(keys[r], counts[r], error[r], items[part],
                       values[part])


def reservoir_scan_update(values: torch.Tensor, items: torch.Tensor,
                          n_seen: torch.Tensor, syn_idx: torch.Tensor,
                          in_items: torch.Tensor, in_values: torch.Tensor,
                          mask: torch.Tensor,
                          source_rows: Optional[torch.Tensor] = None, *,
                          seed: int) -> None:
    """The reservoir sampler's stacked update, in place: each walked row
    (:func:`_walks`) goes through the one-row sampler
    (``core/sampler.sample_row``) over its tuples; other rows are
    untouched. values [n, S] f32; items [n, S] i32 (uint32 bits); n_seen
    [n] i32; syn_idx, in_items [T] i32; in_values [T] f32; mask [T]
    bool."""
    if values.shape[0] == 0:
        return
    for r, part in _walks(syn_idx, mask, values.shape[0], source_rows):
        sampler.sample_row(values[r], items[r], n_seen[r], in_items[part],
                           in_values[part], seed)


def sticky_scan_update(keys: torch.Tensor, counts: torch.Tensor,
                       n_seen: torch.Tensor, epoch: torch.Tensor,
                       syn_idx: torch.Tensor, items: torch.Tensor,
                       mask: torch.Tensor,
                       source_rows: Optional[torch.Tensor] = None, *,
                       support: float, eps: float, delta: float,
                       seed: int) -> None:
    """Sticky Sampling's stacked update, in place, equal to the reference's
    vmap of ``add_batch`` over every row with the batch masked to that
    row's tuples (capacity x T steps): first every row's bump check at the
    batch's first step (``core/sticky.bump_rows``; a masked step takes it
    too), then each walked row (:func:`_walks`) through its own tuples in
    batch order (``core/sticky.walk_row``), with the check the step after
    its last tuple takes where that tuple is not the batch's last. Between
    two of a row's tuples its masked steps check at one count, which the
    step of the later tuple checks again, and a check at one count bumps
    at most once: so these are all the bumps the row takes, at the counts
    it takes them. The walked rows' tables are walked on the host.
    keys [n, cap] i32 (-1 empty); counts [n, cap] f32; n_seen, epoch [n]
    i32; syn_idx, items [T] i32; mask [T] bool."""
    kind = sticky.StickySampling(support, eps, delta, seed)
    n, t = keys.shape[0], syn_idx.shape[0]
    if keys.shape[1] != kind.capacity:
        raise ValueError(f"keys has {keys.shape[1]} slots, the kind "
                         f"{kind.capacity}")
    if n == 0 or t == 0:
        return
    sticky.bump_rows(kind, keys, counts, n_seen, epoch)
    walks = []
    for r, part in _walks(syn_idx, mask, n, source_rows):
        tix = torch.nonzero(part)[:, 0] if part.dtype == torch.bool else part
        walks.append((r, tix))
    if not walks:
        return
    rows = torch.tensor([r for r, _ in walks], dtype=torch.int64,
                        device=keys.device)
    k_host, c_host = keys[rows].cpu().numpy(), counts[rows].cpu().numpy()
    s_host, e_host = n_seen[rows].tolist(), epoch[rows].tolist()
    items_host = items.cpu()
    for i, (_, tix) in enumerate(walks):
        tix = tix.cpu()
        end_check = tix.numel() > 0 and int(tix[-1]) < t - 1
        s_host[i], e_host[i] = sticky.walk_row(
            kind, k_host[i], c_host[i], s_host[i], e_host[i],
            items_host[tix], end_check)
    keys[rows] = torch.from_numpy(k_host).to(keys.device)
    counts[rows] = torch.from_numpy(c_host).to(keys.device)
    n_seen[rows] = torch.tensor(s_host, dtype=torch.int32, device=keys.device)
    epoch[rows] = torch.tensor(e_host, dtype=torch.int32, device=keys.device)


def _gk_tail(mid: torch.Tensor, h: torch.Tensor,
             tail: torch.Tensor) -> torch.Tensor:
    """The sort keys of a row's running sums at virtual positions ``mid``
    >= h (its head's length; ``tail [R, 8]``: the keys of each level's
    sum at the head's last entry, :func:`gk_requantize_update`): position
    p reads level 0's where p's block of 16 is the head's last one, else
    level l + 1's where ``(p >> 4) - 1`` reads level l + 1's, and so on
    up the levels."""
    out = tail[:, -1:].expand_as(mid)
    done = torch.zeros_like(mid, dtype=torch.bool)
    j, last = mid, h - 1
    for lvl in range(tail.shape[1]):
        hit = ~done & ((j >> 4) == (last >> 4))
        out = torch.where(hit, tail[:, lvl:lvl + 1], out)
        done |= hit
        j, last = (j >> 4) - 1, last >> 4
    return out


def gk_requantize_update(values: torch.Tensor, n: torch.Tensor,
                         syn_idx: torch.Tensor, vals: torch.Tensor,
                         mask: torch.Tensor,
                         source_rows: Optional[torch.Tensor] = None, *,
                         m: int) -> None:
    """GK's stacked update, in place, equal byte for byte to the
    reference's vmap of ``add_batch`` over EVERY row of the stack, each
    with the whole batch of T tuples masked to its own (row r: ``mask &
    (syn_idx == r)``; a data-source row: ``mask``; rows outside [0, n) and
    masked tuples feed none), without that vmap's n x (m + T) arrays.
    values [n, m] f32; n [n] f32; syn_idx [T] i32; vals [T] f32; mask [T]
    bool.

    Why it is the same. A row's sorted array there is its state (weight
    n / m, sorted first on ties) merged with its k own tuples (weight 1,
    in batch order on ties), then its T - k other tuples as +inf with
    weight 0. Where the row's own tuples hold no +inf or NaN and its
    state no NaN, the first h = m + k entries (the head) are the merge
    and the rest (the tail) all weigh 0. Each level of the blocked scan
    (``core/gk.blocked_cumsum``) groups its entries by position alone, so
    the head's sums are those of the head scanned by itself, and a tail
    position's sum is one of the head's level sums: level 0's at the
    head's last entry within the head's last block of 16; past it, what
    the previous block's level-1 sum is, which within the head's last
    block of 16 blocks is level 1's at the head's last block, and so on
    up (adding a weight or a total of 0 changes no sum). So the search
    (``core/gk.searchsorted_scan``) runs over the virtual length m + T,
    reading the head's midpoint ranks below h and these level sums above
    it (:func:`_gk_tail`), for ``ceil(log2(m + T + 1))`` steps; the
    result is clipped to m + T - 1 (the head's last entry when the row
    took every tuple) and reads the head's value below h, else +inf.

    The heads of a run of rows (``_GK_CHUNK`` at a time) come from one
    stable sort of (row, key) over their state entries listed first, then
    each row's tuples in batch order; rows are scanned and searched
    together, grouped by their head length's power of two. A row whose
    own tuples hold a +inf or a NaN, or whose state holds a NaN, places
    weighted entries among or past the zero-weight ones; it goes through
    the one-row ``add_batch`` of ``core/gk.py``, which builds its m + T
    entries."""
    rows_n = values.shape[0]
    if values.shape[1:] != (m,) or n.shape != (rows_n,):
        raise ValueError(f"values must be [n, {m}] and n [n], got "
                         f"{tuple(values.shape)} and {tuple(n.shape)}")
    if rows_n == 0:
        return
    dev = values.device
    keep = mask & (syn_idx >= 0) & (syn_idx < rows_n)
    src = []
    if source_rows is not None:
        src = sorted({int(r) for r in source_rows.tolist()
                      if 0 <= r < rows_n})
    if src:
        is_src = torch.zeros(rows_n, dtype=torch.bool, device=dev)
        is_src[src] = True
        keep &= ~is_src[syn_idx.clamp(0, rows_n - 1).long()]
    routed = torch.nonzero(keep)[:, 0]
    masked = torch.nonzero(mask)[:, 0]
    # (row, tuple) pairs: each row's own tuples, grouped by row, each
    # row's in batch order
    pair_row = torch.cat([syn_idx[routed].long()] + [
        torch.full_like(masked, r) for r in src])
    by_row = torch.sort(pair_row, stable=True)
    pair_row = by_row.values
    pair_t = torch.cat([routed] + [masked] * len(src))[by_row.indices]
    k = torch.bincount(pair_row, minlength=rows_n)
    pv = vals[pair_t]
    special = torch.isnan(values).any(1)
    special[pair_row[torch.isnan(pv) | (pv == math.inf)]] = True
    total = n + k.to(torch.float32)
    ends = torch.cumsum(k, 0).tolist()
    for r0 in range(0, rows_n, _GK_CHUNK):
        r1 = min(r0 + _GK_CHUNK, rows_n)
        p0, p1 = (ends[r0 - 1] if r0 else 0), ends[r1 - 1]
        _gk_rows(values[r0:r1], n[r0:r1], total[r0:r1], k[r0:r1],
                 special[r0:r1], pair_row[p0:p1] - r0, pv[p0:p1], m,
                 m + vals.shape[0])
    for r in torch.nonzero(special)[:, 0].tolist():
        own = mask if r in src else keep & (syn_idx == r)
        values[r], _ = gk.add_row(values[r], n[r], vals, own, m)
    n.copy_(total)


_GK_CHUNK = 1 << 14     # rows a step of the plain version takes at once


def _gk_rows(values, n, total, k, special, pair_row, pv, m, big):
    """:func:`gk_requantize_update` on a run of rows, in place on their
    values (not the special rows'): ``pair_row`` / ``pv`` their own
    tuples' rows (from 0) and values, grouped by row, each row's in batch
    order; ``big`` = m + T."""
    dev = values.device
    rows_n = values.shape[0]
    # every row's head: its state, then its own tuples in batch order,
    # stably sorted by (row, value key)
    state_row = torch.arange(rows_n, device=dev).repeat_interleave(m)
    flat_row = torch.cat([state_row, pair_row])
    flat_v = torch.cat([values.reshape(-1), pv])
    flat_w = torch.cat([gk.true_div(n, m).repeat_interleave(m),
                        torch.ones_like(pv)])
    key = (flat_row << 32) | (gk.sort_key(flat_v).long() + (1 << 31))
    order = torch.sort(key, stable=True).indices
    sv, sw = flat_v[order], flat_w[order]
    h = m + k
    off = torch.arange(rows_n, device=dev) * m + torch.cumsum(k, 0) - k
    width = (2 ** torch.ceil(torch.log2(h.double()))).long().clamp(min=16)
    width[special] = 0
    for hb in torch.unique(width).tolist():
        if hb == 0:
            continue
        rows = torch.nonzero(width == hb)[:, 0]
        hr = h[rows][:, None]
        col = torch.arange(hb, device=dev)[None, :]
        pos = (off[rows][:, None] + col).clamp(max=sv.shape[0] - 1)
        w = torch.where(col < hr, sw[pos], torch.zeros_like(sw[pos]))
        lev = gk.blocked_cumsum(w, levels=True)
        kcum = gk.sort_key(lev[0] - 0.5 * w)
        tail = [gk.sort_key(torch.gather(x, 1, (hr - 1) >> (4 * i)))
                for i, x in enumerate(lev)]
        tail = torch.cat(tail + tail[-1:] * (8 - len(tail)), dim=1)
        kt = gk.sort_key(gk.targets_of(m, total[rows]))
        lo = torch.zeros(kt.shape, dtype=torch.int64, device=dev)
        hi = torch.full(kt.shape, big, dtype=torch.int64, device=dev)
        for _ in range(big.bit_length()):
            mid = (lo + hi) // 2
            kc = torch.where(mid < hr,
                             torch.gather(kcum, 1, mid.clamp(max=hb - 1)),
                             _gk_tail(mid, hr, tail))
            left = kt <= kc
            lo = torch.where(left, lo, mid)
            hi = torch.where(left, mid, hi)
        idx = hi.clamp(max=big - 1)
        got = torch.gather(sv[pos], 1, idx.clamp(max=hb - 1))
        values[rows] = torch.where(idx < hr, got,
                                   torch.full_like(got, math.inf))


def sliding_dft_step(re: torch.Tensor, im: torch.Tensor, delta: torch.Tensor,
                     mask: torch.Tensor, tw_re: torch.Tensor,
                     tw_im: torch.Tensor):
    """One masked StatStream tick ``X <- (X + delta) * tw`` on the (re, im)
    planes, in place, as the reference's oracle computes it: each product,
    sum and difference rounded on its own. re/im [S, F] f32 (views allowed);
    delta/mask [S] f32; tw_re/tw_im [F] f32. Returns (re, im)."""
    re2 = re + delta[:, None]
    new_re = re2 * tw_re[None, :] - im * tw_im[None, :]
    new_im = re2 * tw_im[None, :] + im * tw_re[None, :]
    m = (mask > 0)[:, None]
    re.copy_(torch.where(m, new_re, re))
    im.copy_(torch.where(m, new_im, im))
    return re, im


def pairwise_corr(x: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs ``1 - (sq_i + sq_j - 2 <x_i, x_j>)`` of x [N, K] f32, as
    the reference's oracle computes it (``sq = sum(x * x, -1)``, then one
    matrix product): [N, N] f32, written into ``out`` when given."""
    sq = torch.sum(x * x, dim=-1)
    gram = x @ x.T
    return torch.sub(1.0, sq[:, None] + sq[None, :] - 2.0 * gram, out=out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention, as the reference's oracle computes it:
    float32 scores over q [BH, Sq, D] and k [BH, Sk, D] divided by
    sqrt(D); with ``causal`` a top-left ``tril`` [Sq, Sk] where masked
    scores become -1e30; softmax over keys; the product with v [BH, Sk, D]
    in float32, cast to q's dtype. Returns [BH, Sq, D], or fills ``out``.
    Holds the [BH, Sq, Sk] float32 scores twice at its peak."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32))
    s.div_(math.sqrt(d))
    if causal:
        keep = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s.masked_fill_(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
    if out is None:
        return o
    return out.copy_(o)
