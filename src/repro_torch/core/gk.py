"""GK quantile summary [Greenwald & Khanna 2001] -- eps-approximate
quantiles (port of ``repro/core/gk.py``).

The summary is m = max(8, ceil(4 / eps)) values at equi-spaced quantile
positions of the weighted empirical distribution; add and merge are a
weighted re-quantization. State is two leaves: ``values`` float32 ``[m]``
and ``n`` a float32 scalar.

The reference's float32 expressions are kept in their order, and two
pieces of them are written out here because their order is part of the
result (a row's values are the gathers of a binary search over running
sums, so a sum rounded otherwise moves a value):

  * :func:`blocked_cumsum` is ``jnp.cumsum`` as XLA computes it on the
    CPU: a scan in blocks of 16 positions, each block's sums sequential,
    the block totals scanned the same way, recursively, and the exclusive
    prefix of the totals added to each block.
  * :func:`searchsorted_scan` is ``jnp.searchsorted``'s default
    ``method='scan'``: ``ceil(log2(N + 1))`` halvings of ``[0, N)``, each
    going left where ``target <= cum[mid]`` in the total order of the
    sort's comparator. It does not assume ``cum`` is monotone, and it
    need not be (the masked tuples' zero weights sit in sums grouped
    otherwise than the finite ones').

Differences from the reference:

  * Divisions are true float32 divisions by a tensor of the divisor, as
    the reference computes them op by op. (Under ``jit``, XLA rewrites a
    division by the constant m as a product by ``float32(1 / m)``, and
    PyTorch on the card divides by a host scalar the same way: either
    moves some of the m targets.) The one division the reference makes
    under a ``jit`` of its own, ``jnp.mean`` in ``rank``, is that
    product here too.
  * Every sort is keyed on :func:`sort_key`: -0.0 ties with 0.0, every
    NaN ties with every other and sorts after +inf, as the reference's
    argsort canonicalizes them; the values keep their own bits.
  * There is no ``stacked_add_batch``: the engine updates a stack through
    the registry kernel ``"gk_requantize"`` (``kernels/ops.py``), and
    ``batched.stacked_update`` through :meth:`GKQuantiles.scan_update`;
    both requantize EVERY row of the stack, as the reference's vmap does
    (a row that took no tuple still moves where rounding decides its
    targets), without building the m + T array of each row
    (``kernels/ref.py::gk_requantize_update`` says how).
"""
from __future__ import annotations

import dataclasses
import math

import torch

LEVEL = 16              # the blocked scan's block, at every level


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the sort's total order of the
    float32 ``x``: -0.0 as 0.0 and every NaN as the positive quiet NaN
    (after +inf)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, math.nan), x)
    bits = x.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as a true float32 division: the divisor is a tensor of
    x's shape on x's device, which no kernel turns into a product by the
    reciprocal."""
    return torch.div(x, torch.full_like(x, float(d)))


def blocked_cumsum(w: torch.Tensor, levels: bool = False):
    """The running sums of ``w`` along its last axis as ``jnp.cumsum``
    gives them on the CPU: positions in blocks of 16, each block's sums
    taken in order (15 elementwise adds over a ``[..., L / 16, 16]``
    view), the block totals summed the same way, recursively, and each
    block after the first given the inclusive sum of the totals before it
    (added to the block's own sums). A length of 16 or less is one
    sequential scan. The same bytes on the CPU and on the card.

    With ``levels``, a list: the sums, then the inclusive sums of each
    level's block totals (level l holds ceil(L / 16**l) entries), up to
    the first level of 16 entries or fewer."""
    length = w.shape[-1]
    if length <= LEVEL:
        s = w.clone()
        for j in range(1, length):
            s[..., j] = s[..., j - 1] + s[..., j]
        return [s] if levels else s
    nb = -(-length // LEVEL)
    pad = w.new_zeros(w.shape[:-1] + (nb * LEVEL - length,))
    s = torch.cat([w, pad], dim=-1).reshape(w.shape[:-1] + (nb, LEVEL))
    for j in range(1, LEVEL):
        s[..., j] = s[..., j - 1] + s[..., j]
    up = blocked_cumsum(s[..., LEVEL - 1].contiguous(), levels=True)
    out = s.clone()
    out[..., 1:, :] = up[0][..., :-1, None] + s[..., 1:, :]
    out = out.reshape(w.shape[:-1] + (nb * LEVEL,))[..., :length]
    return [out] + up if levels else out


def searchsorted_scan(cum: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
    """``jnp.searchsorted(cum, targets)`` (side 'left', method 'scan')
    along the last axis, int64: from ``low = 0, high = N``, ``ceil(log2(N
    + 1))`` steps of ``mid = (low + high) // 2``, going left (``high =
    mid``) where ``targets <= cum[mid]`` in the sort's total order, else
    right (``low = mid``); the answer is ``high``. ``cum`` need not be
    sorted; leading axes broadcast as ``targets``'s."""
    n = cum.shape[-1]
    kc = sort_key(cum).expand(targets.shape[:-1] + (n,))
    kt = sort_key(targets)
    lo = torch.zeros(targets.shape, dtype=torch.int64, device=cum.device)
    hi = torch.full(targets.shape, n, dtype=torch.int64, device=cum.device)
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        left = kt <= torch.gather(kc, -1, mid)
        lo = torch.where(left, lo, mid)
        hi = torch.where(left, mid, hi)
    return hi


def targets_of(m: int, total: torch.Tensor) -> torch.Tensor:
    """The m targets ``(i + 0.5) / m * total`` (float32, op by op; a
    leading axis of ``total`` gives a row of targets each)."""
    i = torch.arange(m, dtype=torch.float32, device=total.device) + 0.5
    return true_div(i, m) * total[..., None]


def requantize(values: torch.Tensor, weights: torch.Tensor,
               total: torch.Tensor, m: int) -> torch.Tensor:
    """The reference's ``_requantize``: the stable sort of ``values``,
    the midpoint ranks ``cum(w) - 0.5 w``, the search of the m targets,
    the clip to the last position and the gather."""
    order = torch.sort(sort_key(values), stable=True).indices
    v, w = values[order], weights[order]
    cum = blocked_cumsum(w) - 0.5 * w
    idx = searchsorted_scan(cum, targets_of(m, total))
    return v[idx.clamp(0, values.shape[0] - 1)]


def add_row(values: torch.Tensor, n: torch.Tensor, vals: torch.Tensor,
            mask: torch.Tensor, m: int) -> tuple:
    """One row's ``add_batch`` as the reference computes it: its m values
    at weight ``n / m`` and the whole batch, each tuple at weight 1 where
    ``mask`` and at +inf with weight 0 where not; returns (values, n)."""
    w_new = mask.to(torch.float32)
    total = n + w_new.sum()
    vals_in = torch.where(mask, vals.to(torch.float32),
                          torch.full_like(vals, math.inf, dtype=torch.float32))
    all_v = torch.cat([values, vals_in])
    all_w = torch.cat([true_div(n.expand(m), m), w_new])
    return requantize(all_v, all_w, total, m), total


@dataclasses.dataclass(frozen=True)
class GKQuantiles:
    eps: float = 0.01
    seed: int = 43

    merge_mode = "gather"
    update_kernel = "gk_requantize"      # kernels.ops registry name

    @property
    def m(self) -> int:
        return max(8, int(math.ceil(4.0 / self.eps)))

    def init(self, device) -> dict:
        return dict(values=torch.zeros((self.m,), dtype=torch.float32,
                                       device=device),
                    n=torch.zeros((), dtype=torch.float32, device=device))

    def add_batch(self, state, items, values, mask) -> dict:
        """The one-row update (the reference's expressions, the m + T array
        built), in place."""
        del items
        v, n = add_row(state["values"], state["n"], values, mask, self.m)
        state["values"].copy_(v)
        state["n"].copy_(n)
        return state

    def scan_update(self, state, syn_idx, items, values, mask,
                    source_rows=None) -> dict:
        """Update a stack ``{values [n, m], n [n]}`` in place: row r takes
        the tuples with ``mask & (syn_idx == r)``, a data-source row every
        tuple with ``mask``, and EVERY row is requantized, as the
        reference's vmap does. The hand-written requantize kernel on the
        card, its plain version on the CPU."""
        del items
        from repro_torch.kernels import gk_requantize   # kernels import core
        gk_requantize.gk_requantize_update(
            state["values"], state["n"], syn_idx, values, mask, source_rows,
            m=self.m)
        return state

    def _index(self, qs: torch.Tensor) -> torch.Tensor:
        """``clip(int32(qs * m), 0, m - 1)``, truncated toward zero; a NaN
        reads index 0 as XLA's conversion gives it."""
        x = torch.nan_to_num(qs.to(torch.float32) * self.m, nan=0.0)
        return x.clamp(-1.0, float(self.m)).to(torch.int64).clamp(
            0, self.m - 1)

    def estimate(self, state, qs: torch.Tensor) -> torch.Tensor:
        """Quantile queries q in [0, 1]."""
        return state["values"][self._index(qs)]

    def stacked_estimate(self, state, rows: torch.Tensor,
                         qs: torch.Tensor) -> torch.Tensor:
        """Query q reads ``qs[q]`` quantiles of row ``rows[q]``: [N, Q] in
        one gather."""
        return state["values"][rows.long()[:, None], self._index(qs)]

    def rank(self, state, x: torch.Tensor) -> torch.Tensor:
        """Approximate rank of x (count of items <= x): the share of the
        values at most x times n. The share is the reference's
        ``jnp.mean``, which is jitted inside, so it is the count times
        float32(1 / m), XLA's rewrite of its division by m."""
        le = (state["values"] <= x[..., None]).to(torch.float32)
        inv_m = true_div(torch.ones((), device=le.device), self.m)
        return le.sum(-1) * inv_m * state["n"]

    def merge(self, a, b) -> dict:
        total = a["n"] + b["n"]
        values = torch.cat([a["values"], b["values"]])
        weights = torch.cat([true_div(a["n"].expand(self.m), self.m),
                             true_div(b["n"].expand(self.m), self.m)])
        floor = torch.full_like(total, 1e-9)
        return dict(values=requantize(values, weights,
                                      torch.maximum(total, floor), self.m),
                    n=total)

    def memory_bytes(self) -> int:
        return self.m * 4
