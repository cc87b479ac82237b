"""Sliding-window DFT synopsis (StatStream [Zhu & Shasha 2002]; port of
``repro/core/dft.py``).

The paper's vertical-scalability engine: each stream keeps the first
``n_coeffs`` DFT coefficients of its length-``window`` sliding window,
updated incrementally in O(n_coeffs) per tick:

    X_F(t+1) = (X_F(t) - x_out + x_in) * e^{+2 pi i F / n}

State: six leaves -- ``ring [W]`` f32 (the window), ``pos`` and ``count``
int32, ``total`` and ``totsq`` f32 (the window's sum and sum of squares)
and ``coeff [F, 2]`` f32 ((re, im) pairs). ``estimate`` returns the
normalized (z-scored) coefficients U_F = X_F / (sigma * n) and their grid
bucket (cell eps = sqrt(2 (1 - T))), as the reference's.

Differences from the reference:

  * ``step`` and ``add_batch`` update ``state`` in place, on one row
    (leaves without the stack axis) or on a stack ``[S]`` (one value and
    one valid flag per row); the reference's ``step`` takes one row and
    ``batched.stacked_step`` vmaps it.
  * :meth:`DFT.tick` is the tick of a stack with the coefficient update
    passed in: ``step`` passes the plain one
    (``kernels/ref.sliding_dft_step``), and ``batched.stacked_step`` the
    hand-written kernel (``kernels/sliding_dft.py``).
  * Divisions divide by a tensor on the state's device, never by a Python
    float: on the card torch multiplies by such a scalar's reciprocal,
    which may round otherwise than the reference's division. The square
    root is taken in float64 and rounded once to float32, since torch's
    float32 root on the CPU is not correctly rounded.
  * :func:`adjacent_bucket_mask` compares one coordinate axis at a time
    instead of building the ``[N, N, 2g]`` difference cube: the same
    mask, in an ``[N, N]`` temporary.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict

import numpy as np
import torch

_COUNT_CAP = 2 ** 30


@functools.lru_cache(maxsize=None)
def _twiddle_planes(window: int, n_coeffs: int,
                    device: torch.device) -> torch.Tensor:
    """e^{+2 pi i F / n} for F = 1..n_coeffs as contiguous [2, F] (re, im)
    planes: float64 in numpy, then float32, as the reference computes
    it."""
    fs = np.arange(1, n_coeffs + 1, dtype=np.float64)
    ang = 2.0 * np.pi * fs / window
    tw = np.stack([np.cos(ang), np.sin(ang)], 0).astype(np.float32)
    return torch.from_numpy(tw).to(device)


@dataclasses.dataclass(frozen=True)
class DFT:
    window: int = 64
    n_coeffs: int = 8           # coefficients F = 1 .. n_coeffs
    threshold: float = 0.9      # similarity threshold T -> grid cell eps
    grid_coeffs: int = 2        # leading coefficients used for bucket coords
    seed: int = 23

    merge_mode = "fresh"        # DFT replicas are exchanged, not reduced

    @property
    def eps(self) -> float:
        return math.sqrt(2.0 * max(1e-6, 1.0 - self.threshold))

    @property
    def grid_cells(self) -> int:
        return int(math.ceil(math.sqrt(2.0) / self.eps))

    def init(self, device) -> Dict[str, torch.Tensor]:
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return dict(
            ring=zeros((self.window,), torch.float32),
            pos=zeros((), torch.int32),
            count=zeros((), torch.int32),
            total=zeros((), torch.float32),
            totsq=zeros((), torch.float32),
            coeff=zeros((self.n_coeffs, 2), torch.float32),
        )

    def _twiddle(self, device) -> torch.Tensor:
        """e^{+2 pi i F / n} for F = 1..n_coeffs as [2, F] (re, im) planes
        (the reference's is [F, 2])."""
        return _twiddle_planes(self.window, self.n_coeffs,
                               torch.device(device))

    # ------------------------------------------------------------------
    def tick(self, state, x, valid, rotate: Callable):
        """One tick of every row of a stack ``[S]``, in place: row s takes
        ``x[s]`` where ``valid[s]``; the other rows keep all six leaves.
        ``x_out = ring[pos]`` is read before the ring is written.
        ``rotate(re, im, delta, mask, tw_re, tw_im)`` updates the
        ``[S, F]`` coefficient planes in place."""
        ring, pos, count = state["ring"], state["pos"], state["count"]
        total, totsq, coeff = state["total"], state["totsq"], state["coeff"]
        slot = pos.long()[:, None]
        x_out = torch.gather(ring, 1, slot)[:, 0]
        delta = x - x_out
        tw_re, tw_im = self._twiddle(ring.device)
        rotate(coeff[..., 0], coeff[..., 1], delta, valid.to(torch.float32),
               tw_re, tw_im)
        ring.scatter_(1, slot, torch.where(valid, x, x_out)[:, None])
        pos.copy_(torch.where(valid, (pos + 1) % self.window, pos))
        count.copy_(torch.where(
            valid, torch.clamp(count + 1, max=_COUNT_CAP), count))
        total.copy_(torch.where(valid, total + delta, total))
        totsq.copy_(torch.where(valid, (totsq + x * x) - x_out * x_out,
                                totsq))
        return state

    def step(self, state, value, valid=True):
        """One plain tick, in place: of one row (``value``/``valid``
        scalars) or of a stack ``[S]`` (one of each per row)."""
        from repro_torch.kernels import ref     # kernels import core
        rows = state
        if state["pos"].dim() == 0:
            rows = {k: v.unsqueeze(0) for k, v in state.items()}  # views
        dev = rows["pos"].device
        n = rows["pos"].shape[0]
        x = torch.as_tensor(value, dtype=torch.float32,
                            device=dev).reshape(-1).expand(n)
        ok = torch.as_tensor(valid, dtype=torch.bool,
                             device=dev).reshape(-1).expand(n)
        self.tick(rows, x, ok, ref.sliding_dft_step)
        return state

    def add_batch(self, state, items, values, mask):
        """Feed a (time-ordered) run of ticks of this stream, in place.
        ``items`` unused."""
        del items
        for x, ok in zip(values.to(torch.float32), mask):
            self.step(state, x, ok)
        return state

    # ------------------------------------------------------------------
    def estimate(self, state) -> Dict[str, torch.Tensor]:
        """Normalized coefficients and their grid bucket (paper: 'the
        coefficients and the bucket identifier'), for one row or a stack."""
        coeffs = self.normalized_coeffs(state)
        coords, bucket = self.bucket_of(coeffs)
        return dict(bucket=bucket, coeffs=coeffs, coords=coords)

    def stacked_estimate(self, state, rows) -> Dict[str, torch.Tensor]:
        """Estimates of the requested rows of a stack, in one call."""
        idx = rows.long()
        return self.estimate({k: v[idx] for k, v in state.items()})

    def normalized_coeffs(self, state) -> torch.Tensor:
        total = state["total"]
        n = torch.full((), float(self.window), dtype=torch.float32,
                       device=total.device)
        floor = torch.full((), 1e-12, dtype=torch.float32, device=total.device)
        mean = total / n
        var = torch.maximum(state["totsq"] / n - mean * mean, floor)
        # float32 sqrt, correctly rounded on every device: torch's CPU
        # kernel is not (it is off by one ulp at some inputs), and a float64
        # root rounded once to float32 is
        sigma = torch.sqrt(var.double()).float()
        return state["coeff"] / (sigma * n)[..., None, None]

    def bucket_of(self, coeffs):
        """Grid coords over the first grid_coeffs (re, im) pairs, cell =
        eps, packed row-major into one int32 bucket id."""
        g = self.grid_coeffs
        flat = coeffs[..., :g, :].reshape(*coeffs.shape[:-2], 2 * g)
        half = math.sqrt(2.0) / 2.0
        eps = torch.full((), self.eps, dtype=torch.float32, device=flat.device)
        cell = torch.floor((flat + half) / eps)
        # clamp before the cast: the reference's float->int32 conversion
        # saturates and maps NaN to 0, torch's does neither
        coords = torch.clamp(torch.nan_to_num(cell, nan=0.0), 0,
                             self.grid_cells - 1).to(torch.int32)
        mult = torch.tensor([self.grid_cells ** i for i in range(2 * g)],
                            dtype=torch.int32, device=flat.device)
        bucket = torch.sum(coords * mult, dim=-1).to(torch.int32)
        return coords, bucket

    def merge(self, a, b):
        """DFT synopses are exchanged between sites, not reduced; keep the
        replica that has seen more ticks (the reference's documented
        deviation), row by row."""
        fresher = b["count"] > a["count"]

        def pick(x, y):
            f = fresher.reshape(fresher.shape
                                + (1,) * (x.dim() - fresher.dim()))
            return torch.where(f, y, x)
        return {k: pick(a[k], b[k]) for k in sorted(a)}

    def memory_bytes(self) -> int:
        return (self.window + 4 + 2 * self.n_coeffs) * 4


# ---------------------------------------------------------------------------
# Batch helpers over many streams (the StatStream correlation step)
# ---------------------------------------------------------------------------

def corr_from_coeffs(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """corr ~= 1 - d_trunc^2 / 2 with d^2 = 2 sum_F |cx - cy|^2."""
    d2 = 2.0 * torch.sum((cx - cy) ** 2, dim=(-2, -1))
    return 1.0 - 0.5 * d2


def pairwise_corr(coeffs: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation estimates from stacked coeffs [N, F, 2].

    corr_ij = 1 - (|c_i|^2 + |c_j|^2 - 2 <c_i, c_j>)  (factor 2 folded in)
    The <c_i, c_j> Gram matrix is one plain matrix product, as in the
    reference; ``kernels/ops.corr_matrix`` is the hand-written kernel.
    """
    from repro_torch.kernels import ref     # kernels import core
    return ref.pairwise_corr(coeffs.reshape(coeffs.shape[0], -1))


def adjacent_bucket_mask(coords: torch.Tensor) -> torch.Tensor:
    """[N, N] bool mask: True where streams fall in the same or adjacent
    grid cells (the only candidate pairs; everything else is pruned).
    ``coords`` [N, 2g] int32."""
    n = coords.shape[0]
    mask = torch.ones((n, n), dtype=torch.bool, device=coords.device)
    for axis in range(coords.shape[-1]):
        c = coords[:, axis]
        mask &= torch.abs(c[:, None] - c[None, :]) <= 1
    return mask
