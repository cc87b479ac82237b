"""Plain PyTorch versions of the hand-written kernels (port of the
scatter, sliding-DFT, pairwise-correlation and attention oracles in
``repro/kernels/ref.py``, and of the one-hot max cube of
``repro/kernels/bitset_or.py``, which has no oracle there; and the
stacked scans of Lossy Counting, of the reservoir sampler and of Sticky
Sampling, whose reference is no kernel but the kind's ``add_batch`` under
the vmap of ``batched.stacked_update``).

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

from repro_torch.core import lossy, sampler, sticky
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
