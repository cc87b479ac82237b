"""Entry points around the kernels -- the engine's, the correlation
step's (``corr_matrix``) and the attention forward's
(``flash_attention``) -- and the update-kernel registry (port of a
subset of ``repro/kernels/ops.py``).

Kernel dispatch is a REGISTRY, as in the reference: a kind declares
``update_kernel = "<name>"`` and :func:`resolve_update_kernel` returns the
matching builder's update function -- uniform signature, probe fused into
the kernel when ``SDE_FUSED_PROBE`` is on (the default).

Differences from the reference:

  * No padding helpers: the CUDA kernels mask their own ragged edge.
  * No interpret-mode switch and no jit caches: PyTorch runs eagerly, and
    the wrappers pick the kernel or the plain version from the device of
    the tensors they are given.
  * The data-source fold of CountMin, AMS, HLL, Bloom and FM builds the
    batch's fresh single sketch with the SAME kernel (n = 1, every tuple
    routed to row 0) and then applies it to the distinct source rows with
    ``index_add_`` (CM, AMS) or ``torch.maximum`` (HLL, Bloom, FM). The
    reference computes it with a plain scatter, which on the card would
    sum floats in no fixed order. RHP's fresh sketch is a dense sum over
    the batch, which the reference computes outside its kernel too
    (``jnp.sum(sgn * v, axis=0)``); the port takes the same fixed-shape
    torch reduction, which is deterministic on the card, and adds it
    into the source rows without atomics (:func:`_sum_fold`). It
    launches no one-row kernel.
  * ``dft_step`` ticks its planes in place, as the scatters update their
    state in place; the reference's returns new planes.
  * Bucket hashing, sign hashing, ``_hll_prep`` and FM's ``_which_pos``
    are plain torch ops on the state's device, as the reference keeps
    them outside its Pallas kernels.
  * ``corr_matrix`` pads nothing and has no ``tile`` keyword: the
    reference pads N to its 256 tile and K to the MXU's 128 lanes; the
    CUDA kernel masks its own ragged edge.
  * ``flash_attention`` pads nothing and slices nothing: the kernel masks
    its own ragged Sq and Sk. Its ``bq``/``bk`` keywords choose no tiling;
    they only decide the one call the reference refuses, a non-causal
    call with ``Sk % bk != 0`` (``ValueError`` here, an ``assert``
    there). The head dim must be a multiple of 16 from 16 to 256.
  * For a causal ``flash_attention`` with Sq > Sk and Sk not a multiple of
    ``bk``, the port follows the oracle (``ref.flash_attention``). The
    reference pads Sk with zero keys, which query rows at positions >= Sk
    see: each adds ``exp(0 - m)`` to their denominator, so its op
    departs from its own oracle there.
  * For a bfloat16 ``flash_attention`` on the card, p enters P.V as two
    bf16 parts, hi + lo (16 significant bits; the bf16 MMA takes no
    float32 operand), where the reference multiplies a float32 p by v
    cast to float32. A single bf16 p (8 bits) would put outputs up to
    two bf16 ulps off the reference; the two parts keep every output
    within one ulp plus 1e-3 of the largest.

Not yet ported: the sharded, collective, merged and subpopulation
estimate paths.
"""
from __future__ import annotations

import collections
import os
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import batched, hashing
from . import (bitset_or, flash_attention as fa, fm_bitmap, gk_requantize,
               hll_max, onehot_matmul, pairwise_corr, probe, reservoir_scan,
               rhp_project, sliding_dft, sticky_scan)

_FALSY = ("0", "false", "no", "off")


def probe_fusion_enabled() -> bool:
    """Whether registry kernels fuse the routing probe into the kernel --
    on unless ``SDE_FUSED_PROBE`` is falsy. Off, the probe runs as plain
    torch ops ahead of the rows-given kernel, so both entry points of each
    kernel stay reachable."""
    return os.environ.get("SDE_FUSED_PROBE", "1").strip().lower() \
        not in _FALSY


def route_probe(keys_lo, keys_hi, rows, sid_lo, sid_hi, *,
                n_probe: int) -> torch.Tensor:
    """int32 rows for a batch of stream ids (uint32 halves as int32 bit
    patterns) via linear probing: ``-1`` for unrouted ids."""
    return probe.probe_rows(keys_lo, keys_hi, rows, sid_lo, sid_hi,
                            n_probe=n_probe)


def _source_fold(out: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                 signs: Optional[torch.Tensor],
                 source_rows: torch.Tensor) -> torch.Tensor:
    """Add the batch's fresh single sketch into the data-source rows of
    ``out [n, d, w]`` in place. CM and AMS merges are linear, so adding
    the fresh sketch is exact; work is proportional to the number of
    source rows, not capacity."""
    _, d, w = out.shape
    fresh = torch.zeros((1, d, w), dtype=torch.float32, device=out.device)
    to_row0 = torch.zeros(values.shape, dtype=torch.int32, device=out.device)
    onehot_matmul.onehot_scatter_add(fresh, to_row0, idx, values, signs)
    out.index_add_(0, source_rows, fresh.expand(source_rows.shape[0], d, w))
    return out


def _max_fold(state: torch.Tensor, source_rows: torch.Tensor,
              kernel: Callable, *args: torch.Tensor) -> None:
    """Max the batch's fresh single sketch into the data-source rows of a
    max-merge stack, in place: ``kernel(fresh, to_row0, *args)`` runs the
    kind's rows-given wrapper on a one-row zero state with every tuple
    routed to row 0 (``args`` lead with the batch axis)."""
    fresh = torch.zeros((1,) + tuple(state.shape[1:]), dtype=state.dtype,
                        device=state.device)
    to_row0 = torch.zeros((args[0].shape[0],), dtype=torch.int32,
                          device=state.device)
    kernel(fresh, to_row0, *args)
    state[source_rows] = torch.maximum(state[source_rows], fresh)


def _sum_fold(state: torch.Tensor, source_rows: torch.Tensor,
              signs: torch.Tensor, v: torch.Tensor) -> None:
    """Add the batch's fresh RHP sketch ``sum_t v[t] * signs[t, :]`` into
    the distinct data-source rows of ``state [n, b]`` in place: one
    fixed-shape reduction over T, then a gather, one add per element and
    a put (no atomics, so the bytes are the same on every run)."""
    fresh = torch.sum(signs * v[:, None], dim=0)
    state[source_rows] = state[source_rows] + fresh


def rhp_update(state: torch.Tensor, syn_idx: torch.Tensor,
               items: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
               *, seeds: torch.Tensor,
               source_rows: Optional[torch.Tensor] = None,
               source_tuple_mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Kernel-backed stacked RHP/SimHash update, in place. state [n, b]
    f32; each tuple adds ``v * sign_row`` into its routed row (rows
    outside [0, n) are dropped). Data-source rows add the batch's summed
    projection (linear merge), over ``source_tuple_mask`` when given."""
    sgn = hashing.sign_hash(items, seeds)                       # [T, b]
    v = values * mask.to(torch.float32)
    rhp_project.rhp_project_update(state, syn_idx, v, sgn)
    if source_rows is not None:
        tm = mask if source_tuple_mask is None else source_tuple_mask
        _sum_fold(state, source_rows, sgn, values * tm.to(torch.float32))
    return state


def dft_step(re: torch.Tensor, im: torch.Tensor, delta: torch.Tensor,
             mask: torch.Tensor, tw_re: torch.Tensor, tw_im: torch.Tensor):
    """Kernel-backed batched sliding-DFT tick, in place. re/im [S, F] f32
    (any strides the two share), delta/mask [S], tw_re/tw_im [F]; returns
    (out_re, out_im), which are (re, im). No padding: the kernel masks
    its own edge."""
    return sliding_dft.sliding_dft_step(
        re, im, delta.to(torch.float32), mask.to(torch.float32), tw_re,
        tw_im)


def corr_matrix(coeffs: torch.Tensor) -> torch.Tensor:
    """Pairwise correlation estimates from [N, F, 2] or [N, K] coeffs:
    [N, N] f32 from the hand-written kernel (no padding)."""
    x = coeffs.reshape(coeffs.shape[0], -1).to(torch.float32).contiguous()
    return pairwise_corr.pairwise_corr(x)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Streaming-softmax attention, O(S) device memory. q [BH, Sq, D],
    k/v [BH, Sk, D] -> [BH, Sq, D] in q's dtype, from the hand-written
    kernel (no padding). ``bq`` and ``bk`` only decide the reference's
    refusal: a non-causal call needs ``Sk % bk == 0``."""
    del bq
    if not causal and k.shape[1] % bk:
        raise ValueError(f"non-causal needs Sk % bk == 0, got Sk = "
                         f"{k.shape[1]}, bk = {bk}")
    return fa.flash_attention(q, k, v, causal)


# ---------------------------------------------------------------------------
# ``TRACE_COUNT`` counts, per kernel source, the nvcc builds of this process
# (the port has no tracing; a build is its one compile event).
# ``DISPATCH_COUNT`` counts red-path estimate calls per kind and blue-path
# updates per ``update:<kind>``.
# ---------------------------------------------------------------------------

TRACE_COUNT: collections.Counter = collections.Counter()
DISPATCH_COUNT: collections.Counter = collections.Counter()


def estimate_all(kind, state, rows: torch.Tensor, *query_args):
    """Batched red-path entry point: estimates for ``rows`` of ``state``
    with per-query args (leading axis == rows) in one call."""
    DISPATCH_COUNT[type(kind).__name__] += 1
    return batched.stacked_estimate(kind, state, rows, *query_args)


def _hll_prep(items, seed: int, p: int):
    """int32 (bucket, raw rank) per item, as ``HyperLogLog._bucket_rank``."""
    h = hashing.hash_u32(items, seed)
    bucket = (h >> (32 - p)).to(torch.int32)
    rest = (h << p) & hashing.MASK32
    raw_rank = torch.where(rest == 0, 32 - p + 1,
                           hashing.clz32(rest) + 1).to(torch.int32)
    return bucket, raw_rank


# ---------------------------------------------------------------------------
# the update-kernel registry. Every registered builder returns an update fn
# with the SAME signature:
#
#     fn(state, keys_lo, keys_hi, table_rows, sid_lo, sid_hi,
#        items, values, mask, source_rows, *, n_probe) -> state
#
# updating ``state`` in place. ``source_rows`` may be None. Built with
# ``fuse_probe=True`` the probe runs inside the kernel; with False it runs
# as ``route_probe`` ahead of the rows-given kernel (same results).
# ---------------------------------------------------------------------------

UPDATE_KERNELS: Dict[str, Callable] = {}


def register_update_kernel(name: str, builder: Callable, *,
                           overwrite: bool = False) -> None:
    """Register ``builder(kind, fuse_probe) -> update_fn`` under ``name``."""
    if name in UPDATE_KERNELS and not overwrite:
        raise ValueError(f"update kernel {name!r} already registered "
                         "(pass overwrite=True to replace)")
    UPDATE_KERNELS[name] = builder


def check_on_card(kind) -> None:
    """Raise ValueError where the kind's kernel on the card cannot take
    its parameters: GK's requantize holds at most ``gk_requantize.MAX_M``
    state values. The engine calls it at a build on a CUDA device, before
    anything is allocated, so that no ingest fails on them later."""
    if (getattr(kind, "update_kernel", None) == "gk_requantize"
            and kind.m > gk_requantize.MAX_M):
        raise ValueError(
            f"{type(kind).__name__}(eps={kind.eps}) needs m = {kind.m} "
            f"state values; the card's requantize kernel takes at most "
            f"{gk_requantize.MAX_M} (eps >= 4 / {gk_requantize.MAX_M})")


def resolve_update_kernel(kind, fuse_probe: bool | None = None):
    """The kind's built update fn, or None when the kind declares no
    ``update_kernel``. ``fuse_probe`` defaults to
    :func:`probe_fusion_enabled`."""
    name = getattr(kind, "update_kernel", None)
    if name is None:
        return None
    builder = UPDATE_KERNELS.get(name)
    if builder is None:
        raise KeyError(
            f"{type(kind).__name__} declares update_kernel={name!r} but no "
            f"such kernel is registered")
    if fuse_probe is None:
        fuse_probe = probe_fusion_enabled()
    return builder(kind, fuse_probe)


def _scatter_update(fuse, state, klo, khi, trows, slo, shi, idx, v, signs,
                    src_rows, n_probe):
    """CountMin's and AMS's update (``signs`` None: +1): routed rows
    through kernel #2, or the plain probe and kernel #1, then the
    data-source fold's fresh sketch."""
    if fuse:
        onehot_matmul.onehot_probe_scatter(state, klo, khi, trows, slo, shi,
                                           idx, v, signs, n_probe=n_probe)
    else:
        syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
        onehot_matmul.onehot_scatter_add(state, syn, idx, v, signs)
    if src_rows is not None:
        _source_fold(state, idx, v, signs, src_rows)
    return state


def _countmin_kernel(kind, fuse):
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        idx = hashing.bucket_hash(items, kind._seeds(), kind.log2_width)
        v = vals if kind.weighted else torch.ones_like(vals)
        return _scatter_update(fuse, state, klo, khi, trows, slo, shi, idx,
                               v * msk.to(torch.float32), None, src_rows,
                               n_probe)
    return fn


def _ams_kernel(kind, fuse):
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        idx, sgn = kind._hash(items)
        return _scatter_update(fuse, state, klo, khi, trows, slo, shi, idx,
                               vals * msk.to(torch.float32), sgn, src_rows,
                               n_probe)
    return fn


def _hll_kernel(kind, fuse):
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        bucket, raw_rank = _hll_prep(items, kind.seed, kind.p)
        rank = torch.where(msk, raw_rank, 0).to(torch.int32)
        if fuse:
            hll_max.hll_probe_max_update(state, klo, khi, trows, slo, shi,
                                         bucket, rank, n_probe=n_probe)
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            hll_max.hll_max_update(state, syn, bucket, rank)
        if src_rows is not None:
            _max_fold(state, src_rows, hll_max.hll_max_update, bucket, rank)
        return state
    return fn


def _bloom_kernel(kind, fuse):
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        idx = hashing.bucket_hash(items, kind._seeds(), kind.log2_bits)
        upd = msk.to(torch.int32)
        if fuse:
            bitset_or.bitset_probe_max_update(state, klo, khi, trows, slo,
                                              shi, idx, upd, n_probe=n_probe)
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            bitset_or.bitset_max_update(state, syn, idx, upd)
        if src_rows is not None:
            # every tuple of the batch, routed or not, as the reference's
            _max_fold(state, src_rows, bitset_or.bitset_max_update, idx, upd)
        return state
    return fn


def _fm_kernel(kind, fuse):
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        which, pos = kind._which_pos(items)
        upd = msk.to(torch.int32)
        if fuse:
            fm_bitmap.fm_probe_bit_update(state, klo, khi, trows, slo, shi,
                                          which, pos, upd, n_probe=n_probe)
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            fm_bitmap.fm_bit_update(state, syn, which, pos, upd)
        if src_rows is not None:
            _max_fold(state, src_rows, fm_bitmap.fm_bit_update, which, pos,
                      upd)
        return state
    return fn


def _rhp_kernel(kind, fuse):
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        sgn = hashing.sign_hash(items, kind._seeds())
        v = vals * msk.to(torch.float32)
        if fuse:
            rhp_project.rhp_probe_update(state, klo, khi, trows, slo, shi, v,
                                         sgn, n_probe=n_probe)
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            rhp_project.rhp_project_update(state, syn, v, sgn)
        if src_rows is not None:
            _sum_fold(state, src_rows, sgn, v)
        return state
    return fn


def _sampler_kernel(kind, fuse):
    """The chain sampler's update: routed rows and data-source rows in one
    launch of the reservoir kernel, the probe inside it or ahead of it."""
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        leaves = (state["values"], state["items"], state["n_seen"])
        if fuse:
            reservoir_scan.reservoir_probe_scan_update(
                *leaves, klo, khi, trows, slo, shi, items, vals, msk,
                src_rows, n_probe=n_probe, seed=kind.seed)
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            reservoir_scan.reservoir_scan_update(*leaves, syn, items, vals,
                                                 msk, src_rows,
                                                 seed=kind.seed)
        return state
    return fn


def _sticky_kernel(kind, fuse):
    """Sticky Sampling's update: every row's first bump check, routed rows
    and data-source rows in one call of the sticky-scan kernel, the probe
    inside its key pass or ahead of it."""
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        leaves = (state["keys"], state["counts"], state["n_seen"],
                  state["epoch"])
        if fuse:
            sticky_scan.sticky_probe_scan_update(
                *leaves, klo, khi, trows, slo, shi, items, msk, src_rows,
                n_probe=n_probe, **kind.params())
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            sticky_scan.sticky_scan_update(*leaves, syn, items, msk,
                                           src_rows, **kind.params())
        return state
    return fn


def _gk_kernel(kind, fuse):
    """GK's update: every row of the stack requantized, routed rows and
    data-source rows in one call of the requantize kernel, the probe
    inside its key pass or ahead of it."""
    def fn(state, klo, khi, trows, slo, shi, items, vals, msk, src_rows, *,
           n_probe):
        leaves = (state["values"], state["n"])
        if fuse:
            gk_requantize.gk_probe_requantize_update(
                *leaves, klo, khi, trows, slo, shi, vals, msk, src_rows,
                n_probe=n_probe, m=kind.m)
        else:
            syn = route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
            gk_requantize.gk_requantize_update(*leaves, syn, vals, msk,
                                               src_rows, m=kind.m)
        return state
    return fn


register_update_kernel("countmin_scatter", _countmin_kernel)
register_update_kernel("ams_scatter", _ams_kernel)
register_update_kernel("hll_max", _hll_kernel)
register_update_kernel("bloom_bitset", _bloom_kernel)
register_update_kernel("fm_bitmap", _fm_kernel)
register_update_kernel("rhp_project", _rhp_kernel)
register_update_kernel("reservoir_scan", _sampler_kernel)
register_update_kernel("sticky_scan", _sticky_kernel)
register_update_kernel("gk_requantize", _gk_kernel)
