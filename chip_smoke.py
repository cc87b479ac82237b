#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # needs one CUDA card; ~7-8 minutes

Phases (any failure raises, so the script exits non-zero without its
last line; each phase prints its peak device memory, held under 48 GiB):

  1. Card and build: ``nvidia-smi`` name and power limit, then the ten
     kernel sources built by ``nvcc`` in parallel.
  2. Each of the thirteen kernel entry points against its plain version at
     the main path's shapes, on a batch of 65,536 tuples with unrouted,
     -1 and masked (upd 0 / rank 0 / weight 0) lanes: CountMin
     eps=0.002, delta=0.01 (the paper's parameters,
     ``benchmarks/fig5_scalability.py``) -> rows [5, 2048] f32; CountMin's
     two entry points again as AMS runs them (``@ams``: AMS()'s [12,
     2048] rows, +-1 signs from ``sign_hash``, integer weights, 12 GiB);
     HyperLogLog rse=0.03 -> 2048 registers; n = 131,072 rows (the
     capacity of phase 3's stacks); Bloom(1024, 0.01) -> 16,384 lanes,
     k = 11, n = 131,072 (8 GiB); FM defaults -> [131,072, 64, 32]; RHP
     defaults -> [131,072, 64] f32; the sliding-DFT tick of the paper's
     Figure-6 DFT (window 128, 8 coefficients,
     ``benchmarks/fig6_dft_workflow.py``) in place on the [S, 8, 2]
     coefficient leaf at S = 131,072 and 2**20, byte for byte; the
     pairwise correlation at N = 5,000 and K = 16 (the paper's 12.5M
     pairs at Figure 6's 8 coefficients), to 1e-5 and byte for byte
     across two runs, with the float32 matmul settings read (never set)
     and required to be full float32; the attention forward at each
     config's width (Qwen2-72B's 64 heads of 128, ``configs/qwen2_72b.py``;
     Qwen2-0.5B's 14 x 64; Gemma-7B's 16 x 256), batch 1 at train_4k's
     S = 4096, causal bfloat16, each output element within 2**-7 of
     itself plus 1e-3 of the largest output of the plain version, byte
     for byte across two runs, timed beside
     ``scaled_dot_product_attention``; then untimed Qwen2-72B's shape in
     float32 (1e-5 of the largest output) and with peaky scores (q, k at
     1.5 N(0, 1), causal and not), Gemma-7B's heads peaky, a ragged
     causal S = 4000, a non-causal S = 4096 and a causal Sq = 200,
     Sk = 100. Plus the
     one-row fresh-sketch launch each CM, HLL, Bloom and FM data-source
     fold makes (``<name>@fresh``; AMS's, [1, 12, 2048] with signs, is
     ``onehot_scatter_add@fresh@ams``; RHP's fold is a torch reduction
     and launches none), an untimed exactness run of both bit-set entry
     points on a 262,144 x 16,384 stack (2**32 lanes) with tuples routed
     to its last rows, and an untimed RHP run at b = 200 with rows -1 and
     n and a batch of no multiple of 32. Integer results must match
     exactly; the two float-sum kernels (CM and RHP) under float weights
     to a stated tolerance and byte for byte across two kernel runs, CM's
     also to a serial float32 loop's bytes on every touched element (CM's
     fresh sketch too, and AMS's with its +-1 signs). The
     CountMin kernels' own row sort must equal ``torch.sort(stable=True)``.
     Times are CUDA-event medians of one call (host enqueue included),
     each with its ``torch.profiler`` device time per call beside it (its
     kernels' summed durations; for RHP, whose kernels run on two streams
     at once, the union of their intervals). The CountMin and RHP rows
     also print their device time by kernel (CM: the probe, the row sort
     with its memset, the gather, the walk, and for the fresh sketch the
     key pass; RHP: the sort, the probe, the products pass, the short and
     the long walk), the batch's longest run (for the fresh sketch, the
     most entries at one element, and its elements) and the chain floor
     it sets (its adds at FADD_CYCLES each at the card's top SM clock)
     beside the bound; the RHP rows must have
     walked every run of LONG_RUN+ tuples through the ring (the wrappers'
     ``long_runs``). The bit-set rows (Bloom, FM and HLL) time the kernel on
     the state the batch already set and on a first touch (a fresh copy
     of the state before every call, the copy not timed); their
     ``@fresh`` rows time kernel, plain and library call on a state zeroed
     before every call, as the fold runs them (the fill not timed); each
     prints the distinct lanes, 32-byte sectors and the hottest lane's
     entries beside the bound. Then Lossy Counting's scan (``lossy_scan``,
     no TPU counterpart) at the reference's default eps = 0.01 (k = 100)
     and at eps = 0.001 (``lossy_scan@k1000``) on n rows routed as the
     batch's probe gives them plus one data-source row: keys, counts and
     error byte-equal to the plain version on the card and across two
     kernel runs; the plain version timed from its one checked call (tens
     of seconds: a torch launch an op of every step); the data-source
     walk's misses (empty slots taken and evictions), levels (the least
     count taken again from every count) and hottest slot's adds counted
     by a host replay (``lossy_replay``, held to the plain version's keys)
     and printed; the bound the larger of the bytes and the chain these
     inputs need (the levels at LOSSY_LEVEL_CYCLES each, or the hottest
     slot's adds, or the longest routed run's, at FADD_CYCLES each,
     whichever is longer), with every miss at LOSSY_LEVEL_CYCLES and the
     earlier floor (every step of the walk at LOSSY_STEP_CYCLES) beside
     it, neither a bound. Then the reservoir sampler's update (no TPU
     counterpart) through both entry points, rows given
     (``reservoir_scan``) and the probe fused in
     (``reservoir_probe_scan``), at the reference's defaults (S = 64) on
     the same rows and data-source row, from empty rows and from rows
     past the fill: values, items and n_seen byte-equal to the plain
     version (the fused entry's: the plain probe, then the plain update)
     and across two kernel runs, each timed on its starting state
     restored before every call, a profiler window held to
     RESERVOIR_ACTIVITIES a call; the bound the bytes (the batch's rows or
     stream ids, items and mask once, the table slots the probes read,
     the value of each slot's last writer, each walked row's n_seen, each
     slot written once, counted by ``reservoir_writes``). Then Sticky
     Sampling's update (no TPU counterpart): first the kernel's own
     float-function lookups (``sticky_scan.eval_tables``) equal to the
     CPU's literal float32 functions, want_epoch at every count from 1 to
     2**24 and geo at every distinct draw of ``uniform01``; then rows
     given (``sticky_scan``, the reference's defaults, capacity 288), the
     probe fused in (``sticky_probe_scan``) and rows given at support
     0.001, eps 0.0001 (``sticky_scan@cap4096``: 7,195 slots by the
     formula, capped to 4,096) on the same rows and data-source row, from
     empty tables and from the state STICKY_PAST_BATCHES batches leave,
     its counts set (``sticky_bump_state``) so that rows bump at the
     batch's first step, after their walks and inside the source walk,
     which the run requires: keys, counts, n_seen and epoch byte-equal
     to the plain version (its
     walks on the host) and across two kernel runs, each timed on its
     starting state restored before every call; the bound the larger of
     the bytes (``sticky_bytes``: the words the plain version changed,
     each walked table's keys and each bumped table's counts) and the
     source walk's groups of 32 that change a key at
     STICKY_GROUP_CYCLES each, from a host replay (``sticky_replay``)
     held to the plain version's keys, which also counts its steps with
     an empty slot, its full-table steps, admissions and bumps; the
     hottest slot's dependent updates at FADD_CYCLES, the earlier
     figure, printed beside it; each call's device time by kernel
     (``kernel_split``). Then GK's requantize (no TPU counterpart) at the
     reference's defaults (eps 0.01: m = 400) on the same rows and
     data-source row with continuous values (N(0, 10)), every row
     requantized: rows given from empty rows
     (``gk_requantize``) and from the state GK_IDLE_BATCHES batches leave
     on counts in the thousands, where nearly every row takes no tuple and
     moves anyway (``gk_requantize@idle``), that state with half its rows
     out of order (``gk_requantize@unsorted``), and the probe fused in from
     empty rows (``gk_probe_requantize``): values and n byte-equal to the
     plain version and across two kernel runs, timed on the starting
     state restored before every call (events, events queued behind a
     spin, the profiler's split by kernel); the bound the larger of the
     bytes (the stack read and written, the batch) and the searches'
     shared-memory reads (m x ceil(log2(m + T + 1)) a row, 32 a cycle an
     SM). One entry's tensors are held at a time.
  3. The main path through ``SDE(device="cuda").handle``: per-stream AMS
     (the reference's defaults, [12, 2048]), CM, HLL, Bloom, FM, RHP and
     Figure-6 DFT over 65,536 hashed 63-bit ids; a data-source AMS, CM,
     HLL, Bloom(1,048,576, 0.01) (own stack: 64 x 2**24 lanes), FM, RHP
     and DFT; continuous AMS, HLL and FM (data-source rows) and DFT
     (window 64, on the hottest stream); per-stream and data-source Lossy
     Counting at eps 0.01 (one stack) and a data-source one at eps 0.001
     (its own stack); per-stream, data-source and continuous chain
     samplers at the reference's defaults (S = 64, one stack of 131,072
     rows, 64.5 MiB); per-stream and data-source Sticky Sampling at the
     reference's defaults (one stack of 131,072 rows, 2,312 B a row) and a
     data-source one at support 0.001, eps 0.0001 (capacity 4,096, its
     own stack); per-stream, data-source and continuous GK quantiles at
     the reference's defaults (eps 0.01: m = 400, one stack of 131,072
     rows, 1,604 B a row, built last); 16 ingest batches of 65,536
     Zipf(1.1) tuples (half with SDE_FUSED_PROBE=0), then 2 more under
     ``torch.profiler`` (device-busy share, top kernels, the Sticky walk
     activities the profiler kept against the sticky-scan launches);
     1,024 CM,
     1,024 Bloom, 1,025 RHP, 1,025 DFT, 1,024 AMS and 1,024 per-stream
     Lossy queries (with ``items``; the two data-source Lossy tables'
     heavy items too) in query_many, Bloom false positives, HLL, FM, AMS
     and DFT adhoc queries. Each per-stream Lossy answer for its own
     folded id must equal its stream's exact total weight, each
     data-source Lossy table's counts must sum to the exact weight W it
     was fed, every folded id heavier than W / k must be tracked with an
     estimate in [true, true + W / k], and the scan must launch once a
     batch on each Lossy stack. Each sampler row's n_seen must equal the
     masked tuples it was fed after every unprofiled batch and after the
     last (a per-stream row its stream's, a source row all), every valid
     (item, value) must be an ingested pair (a per-stream row's of its own
     stream), 1,026 sampler answers in query_many (1,024 per-stream,
     src-rs, cq-rs) must equal the stack's rows with items as uint32, the
     continuous sampler must emit once a batch, the reservoir kernel must
     launch through its fused entry once a fused batch and through the
     rows-given one once an unfused batch, and the sampler's update may
     run the plain probe (``ops.route_probe``) only in unfused batches,
     once each (``ScanProbes``). Each Sticky row's n_seen must equal its
     fed tuples after every unprofiled batch and after the last, and its
     epoch the one its next count asks for (its current count's where its
     last tuple was its batch's last); each per-stream Sticky answer for
     its own id must equal its stream's fed count while that is below 2t
     (9,216); the sticky-scan kernel must launch through its fused entry
     once a fused batch and through the rows-given one once an unfused
     batch on each of the two Sticky stacks, and their updates may run the
     plain probe only in unfused batches. Each per-stream GK median (``qs``
     [0.5]) must equal its row of the stack, the data-source GK's answers
     at ``qs`` GK_QS (query_many and adhoc alike) lie within the
     reference's rank bound 6 eps + 1 / N of the exact quantiles of the N
     masked tuples ingested, the continuous GK equal src-gk's state and
     emit once a batch, and the requantize kernel launch through its fused
     entry once a fused batch and through the rows-given one once an
     unfused batch, the plain probe only in unfused batches. Each
     per-stream AMS answer must be
     float32(total)**2 of its
     stream's exact total weight, the data-source AMS within 0.15 of the
     exact F2 of the items it was fed, the continuous AMS equal to it and
     emitted once a batch. Every stack must equal a replay of the
     same batches through the plain versions on the card (AMS, RHP and
     DFT byte for byte, RHP's and DFT's answers equal to the replay's; the
     Lossy, sampler, Sticky and GK stacks as they stood after the first
     LOSSY_REPLAY_BATCHES batches, copied there, byte for byte against a
     replay of those batches, since the plain Lossy scan takes tens of
     seconds a batch; the DFT
     replay finds each row's last routed value in numpy and ticks with
     ``DFT.step``), the data-source DFT must stay at init, no ingested id
     may be missing from its Bloom, every entry point must launch, the
     RHP fold must make no one-row launch, and each RHP entry point's
     ring walk must have taken exactly the runs of LONG_RUN+ tuples of
     the batches it ingested.
  3b. Every ring wraps: a per-stream Figure-6 DFT over 131,072 hashed ids
     and 192 ingests, each carrying every stream once plus 1/8 duplicates
     (the last one wins), 1/16 unrouted and a few negative ids, every
     stream following one of 8 latent random walks plus its own noise;
     the stack must equal its plain replay byte for byte, and the tick
     kernel must launch once per batch. Then the StatStream correlation
     step: the coefficients and coords of the first 5,000 per-stream
     synopses, asked for in one ``query_many`` (equal to the replay's),
     go through ``ops.corr_matrix``, which must launch the correlation
     kernel once and agree with the plain Gram
     (``core/dft.py::pairwise_corr``) to 1e-5. The bucket-adjacency mask
     must equal a numpy recomputation, prune some pairs and keep every
     pair above the threshold, and distinct streams must correlate above
     it.
  3c. GK on continuous values (phase 3's weights are the integers 1 to
     4, on which its rank check cannot tell most wrong quantiles apart):
     a second ``SDE(device="cuda")`` with only GK stacks, per-stream over
     65,536 ids and data-source at the defaults (one stack of 131,072
     rows) and a data-source GK at eps 0.0005 (m = 8,000, past the
     kernel's shared memory: every row through its big-row pass),
     GK_CONT_BATCHES ingests of 65,536 Zipf(1.1) tuples (half unfused)
     whose values are 70% N(0, 10) and 30% lognormal(3, 1). Both entry
     points must launch, both stacks equal a replay of every batch through
     the plain version byte for byte, and each data-source answer at
     GK_QS (query_many and adhoc alike) lie within 6 eps + 1 / N of the
     exact quantile of the N masked tuples. Each stack's device ms a
     batch and its split by kernel are printed (the rows-given entry on
     the last batch).
  4. The attention entry point: ``ops.flash_attention`` once at each
     config's width, causal bfloat16, with the counts reset just before
     each call; each must launch the attention kernel exactly once and
     agree with the plain version within phase 2's bfloat16 limits.
  5. The gate of the CountMin rows (#1, #2 and the one-row launch): each
     one's device time no higher than the library call's. Then one JSON
     line with each kernel's
     launches in phase 3 (the correlation kernel's in phase 3b, the
     attention kernel's in phase 4) and its
     phase-2 numbers (``ms``, ``plain_ms``,
     ``library_ms`` by CUDA event; ``device_ms``, ``plain_device_ms``,
     ``library_device_ms`` by ``torch.profiler``; the sliding-DFT row
     adds its S = 2**20 numbers, the CM and RHP rows their split, longest
     run, chain floor, and CM's runs (the fresh sketch's: elements) or
     RHP's phase-3 long runs; an ``@ams`` row's launches are the
     wrapper's signed ones on the AMS stack, and ``@fresh@ams``'s its
     signed one-row ones, which phase 3 requires to be one a batch on
     the stack and one fold a batch; the Lossy rows' ``launches`` are all
     the scan's and those on tables of 1,000 slots, their ``replaces``
     the JAX counterpart, ``src/repro/core/lossy.py:65``; the two
     reservoir rows' ``replaces`` ``src/repro/core/sampler.py:55``, with
     their past-the-fill numbers; the three sticky-scan rows' ``replaces``
     ``src/repro/core/sticky.py:86``, with their past-epochs numbers and
     ``@cap4096``'s launches those on tables of 4,096 slots; the three GK
     rows' ``replaces`` ``src/repro/core/gk.py:51``, ``@idle``'s and
     ``@unsorted``'s launches all the rows-given entry's; every row
     whose counterpart lies under
     ``src/repro/core/`` has ``tpu_kernel`` null), then the device
     line.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
OPS_PER_S = {"float32": 67e12,             # H100 SXM fp32 CUDA cores
             "bf16 tensor cores": 989e12}  # H100 SXM bf16, dense
TIMING_RUNS = 25
WINDOW_TRIES = 6        # profiler windows taken for one prepared reading
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-3   # float sums of up to ~10^4 terms
                                      # taken in another order
PEAK_LIMIT_GIB = 48.0
FADD_CYCLES = 4         # a dependent float32 add's latency on the card
# the earlier floor on a Lossy Counting walk: every step a dependent
# chain of the item's compare with the keys, the warp's minimum over the
# lanes (redux.sync) and the count's add, each at least a dependent add's
# latency; kept beside the bound for comparison
LOSSY_STEP_CYCLES = 3 * FADD_CYCLES
# a level of a Lossy walk: the least count taken again from every count
# once the slots that held the last one have all been evicted or raised,
# a warp minimum (redux.sync, 47.1 cycles a step of a dependent chain on
# an H100: tools/lossy_probe.py --latency) and a select. Each level reads
# the counts the one before left; the evictions within a level take its
# slots in slot order, which the counts already fix, so they need not
# wait on one another
REDUX_CYCLES = 47
LOSSY_LEVEL_CYCLES = REDUX_CYCLES + FADD_CYCLES
SRC_BLOOM_ELEMENTS = 1 << 20          # phase 3's data-source Bloom
# phase 3's Lossy Counting: the reference's default eps (k = 100) per
# stream and as a data source, and a data source at k = 1000
LOSSY_PARAMS, LOSSY_K1000_PARAMS = {"eps": 0.01}, {"eps": 0.001}
LOSSY_REPLAY_BATCHES = 2    # the batches the plain replay takes (phase 3)
# a Lossy scan's device time is 0.95-0.98 of its CUDA-event time on an
# H100; a profiler window that lost activities read 0.78 of it
LOSSY_DEVICE_SHARE = 0.9
# the device activities of one reservoir update, either entry, at sizes
# it ran at before: its one cooperative launch (no memset: the scratch
# it keeps is zeroed only when the sizes change). A profiler window of
# its calls opens with PAD_LAUNCHES spin kernels (``device_events``), and
# one that holds another count is taken again (windows of the earlier
# 13-launch design held 66, 64 and 58 in 5 runs)
RESERVOIR_ACTIVITIES = 1
PAD_LAUNCHES, PAD_CYCLES = 16, 100_000   # ~0.8 ms of spin at 1,980 MHz
# Sticky Sampling: the reference's defaults (support 0.01, eps 0.002, delta
# 0.01: capacity 288), and support 0.001, eps 0.0001 (7,195 slots by the
# formula, capped to 4,096: the largest table); phase 2's state "past a
# few epochs" is the one STICKY_PAST_BATCHES of its batches leave, with
# counts set so that its batch takes every kind of bump (sticky_bump_state)
STICKY_PARAMS = {}
STICKY_CAP4096_PARAMS = {"support": 0.001, "eps": 0.0001}
STICKY_PAST_BATCHES = 5
STICKY_TIMING_RUNS = 10     # its calls take ms: fewer event runs suffice
# a walk's group of 32 tuples that changes a key (admits one, or holds a
# bump that empties a slot): its keys must reach the next group's lookups,
# so the least dependent chain of such a group is a lookup (two dependent shared loads: the index entry,
# then its key), the misses' ballot, the rank's load of the empty slot and
# the key's store: three shared-memory latencies and a ballot's
# (34.0 and 17.2 cycles by tools/lossy_probe.py --latency on an H100)
LDS_CYCLES, BALLOT_CYCLES = 34, 17
STICKY_GROUP_CYCLES = 3 * LDS_CYCLES + BALLOT_CYCLES
# GK quantiles: the reference's defaults (eps 0.01: m = 400, 1,604 B a
# row); phase 2's idle state is the one GK_IDLE_BATCHES batches leave on
# counts in the thousands
GK_IDLE_BATCHES = 4
GK_QS = [0.01, 0.25, 0.5, 0.75, 0.99]   # phase 3's data-source quantiles
GK_CONT_BATCHES = 4                     # phase 3c's ingests
GK_FINE_EPS = 0.0005                    # phase 3c's m = 8,000 stack
QUEUE_CYCLES = 4_000_000    # ~2 ms of spin at 1,980 MHz: a call's enqueue
# the paper's Figure-6 DFT (benchmarks/fig6_dft_workflow.py)
FIG6_DFT = {"window": 128, "n_coeffs": 8, "threshold": 0.9,
            "grid_coeffs": 2}
TABLE_B = 12                          # a probed slot: key lo, key hi, row
# the correlation step: the paper's 12.5M pairs at Figure 6's 8 coefficients
CORR_N, CORR_K = 5000, 16
CORR_ATOL = 1e-5        # float32 Grams of K <= 16 terms summed in another
                        # order than the plain version's matrix product
CORR_GROUPS = 8         # phase 3b's streams follow one of 8 latent walks
# the attention forward: Qwen2-72B (configs/qwen2_72b.py: 64 heads, d_model
# 8192 -> head_dim 128), batch 1 at train_4k's S = 4096 (configs/base.py)
ATTN_HEADS, ATTN_D, ATTN_S = 64, 128, 4096
# row name -> (heads, head_dim) of each config's attention: Qwen2-72B,
# Qwen2-0.5B (configs/qwen2_05b.py: 14 x 64), Gemma-7B
# (configs/gemma_7b.py: 16 x 256)
ATTN_WIDTHS = {"flash_attention": (ATTN_HEADS, ATTN_D),
               "flash_attention@d64": (14, 64),
               "flash_attention@d256": (16, 256)}
# float32: largest abs error over the largest output. bfloat16, each
# element: |got - want| <= 2**-7 |want| (one bf16 ulp of the value) plus
# 1e-3 of the largest output (values near zero)
ATTN_F32_TOL = 1e-5
ATTN_BF16_RTOL, ATTN_BF16_ATOL = 2.0 ** -7, 1e-3
ATTN_PEAKY = 1.5        # q, k scale whose scores move the running max
GIB = 2.0 ** 30


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, runs: int = TIMING_RUNS, prep=None) -> float:
    """Median CUDA-event time of ``fn()`` over ``runs`` runs (1 warm-up);
    ``prep()``, when given, runs before each run, outside the events."""
    fn()
    times = []
    for _ in range(runs):
        if prep is not None:
            prep()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_events(fn, runs: int = 5, attempts: int = 6,
                  pad: int = 0) -> list:
    """(name, start µs, end µs) of every device activity (kernels and
    copies) of ``runs`` calls of ``fn()`` from ``torch.profiler``, on every
    stream, without the host's enqueue
    time, which a CUDA-event time of a few-µs launch mostly is. A profile
    that caught no device activity at all is taken again, up to
    ``attempts`` times, after a pause that doubles from 0.1 s:
    torch.profiler now and then drops a whole window's CUDA events on this
    card (seen once in some 300 windows), and once three windows in a row
    that followed one another at once. With ``pad``, the window opens with
    that many spin kernels of PAD_CYCLES each (``torch.cuda._sleep``),
    left out of the list: windows have lost their first activities (a
    one-call window of the 13-launch reservoir update held only its last
    6), so that a pad, not the calls, takes the loss."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.1 * 2 ** (attempt - 1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(PAD_CYCLES)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not (pad and "spin_kernel" in e.name)]
        if spans:
            return spans
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{attempts} windows")


def busy_us(spans) -> float:
    """The union of (start, end) intervals, in their unit: the time some
    activity ran, however many at once."""
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def device_ms(fn, runs: int = 5, union: bool = False, prep=None,
              label: str = "", floor_ms: float = 0.0, activities: int = 0,
              reset=None) -> float:
    """Mean device time of ``fn()`` per run (``device_events``): its
    activities' summed durations, or, for a call whose kernels run on two
    streams at once (``union``), the union of their intervals. ``prep()``,
    when given, runs before each run as one device activity (a copy or a
    fill), which is not counted; ``reset()``, when given, runs before each
    window, outside it. The profiler now and then loses some of a
    window's activities (seen in a Bloom first-touch window and in a Lossy
    scan's, which then read 0.78 of its event time): a prepared window
    whose activities do not split evenly into the runs, a window that does
    not hold ``activities`` a run (when given; such a window opens with a
    pad, ``device_events``), or a window whose
    time falls under ``floor_ms``, is taken again, up to ``WINDOW_TRIES``
    windows, each retake printed with ``label``; then it fails."""
    for attempt in range(1, WINDOW_TRIES + 1):
        if reset is not None:
            reset()
        if prep is None:
            events = device_events(fn, runs,
                                   pad=PAD_LAUNCHES if activities else 0)
            spans = [(s, e) for _, s, e in events]
            even = not activities or len(events) == activities * runs
        else:
            events = sorted(device_events(lambda: (prep(), fn()), runs),
                            key=lambda ev: ev[1])
            per = len(events) // runs
            even = per > 1 and per * runs == len(events)
            spans = [(s, e) for i, (_, s, e) in enumerate(events)
                     if even and i % per]
        total = busy_us(spans) if union else sum(e - s for s, e in spans)
        ms = total / runs / 1e3
        if even and ms >= floor_ms:
            return ms
        print(f"[timing] {label}: window {attempt} of {WINDOW_TRIES} held "
              f"{len(events)} device activities in {runs} runs, "
              f"{ms:.4f} ms a run (floor {floor_ms:.4f}); taken again",
              flush=True)
    raise RuntimeError(f"{label}: {len(events)} device activities in "
                       f"{runs} runs, {ms:.4f} ms a run against a floor of "
                       f"{floor_ms:.4f}, {WINDOW_TRIES} windows")


def queued_device_ms(fn, restore, runs: int = 5) -> float:
    """Median device time of ``fn()`` over ``runs`` calls, each on the
    state ``restore()`` makes: CUDA events recorded around the call while
    a spin kernel ahead of them (``torch.cuda._sleep``, QUEUE_CYCLES)
    holds the card, so that every launch of the call is queued before
    the first one runs and no host enqueue lies between the events.
    torch.profiler recorded no activity of the 4,096-slot sticky walk (a
    127 ms kernel) in 6 windows of 6, so the long scans are timed so."""
    times = []
    for _ in range(runs):
        restore()
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_split(fn, groups: dict, rest: str, runs: int = 5,
                 label: str = "", floor_ms: float = 0.0,
                 activities: int = 0) -> dict:
    """Device ms of ``fn()`` per run by kernel: each activity whose name
    holds a key of ``groups`` under that key's value, every other one
    under ``rest``; a window whose sum falls under ``floor_ms``, or that
    does not hold ``activities`` a run (when given), is taken again, as
    in ``device_ms``."""
    for attempt in range(1, WINDOW_TRIES + 1):
        split: dict = {}
        events = device_events(fn, runs,
                               pad=PAD_LAUNCHES if activities else 0)
        for name, start, end in events:
            key = next((g for k, g in groups.items() if k in name), rest)
            split[key] = split.get(key, 0.0) + (end - start) / runs / 1e3
        if (sum(split.values()) >= floor_ms
                and (not activities or len(events) == activities * runs)):
            return split
        print(f"[timing] {label}: split window {attempt} of {WINDOW_TRIES} "
              f"held {len(events)} device activities in {runs} runs and "
              f"summed {sum(split.values()):.4f} ms a run (floor "
              f"{floor_ms:.4f}); taken again", flush=True)
    raise RuntimeError(f"{label}: no split window in {WINDOW_TRIES} held "
                       f"{activities or 'any'} activities a run and summed "
                       f"{floor_ms:.4f} ms a run or more")


def chain_floor_ms(longest: int, cycles: int = FADD_CYCLES) -> tuple:
    """(ms, MHz): the least time of ``longest`` dependent steps, ``cycles``
    each at the card's top SM clock: by default float32 adds, as the
    hottest run's adds at one element are under the byte contract."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return longest * cycles / (mhz * 1e6) * 1e3, mhz


def bound_ms(n_bytes: int, n_ops: int, rate: str = "float32"):
    """The least time for the work: bytes over the HBM rate or operations
    over the peak rate ``OPS_PER_S[rate]``, whichever is larger, and
    which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[rate] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096):
    """(equal, max abs err, allclose at FLOAT_RTOL/ATOL) of two tensors of
    one shape, row chunk by row chunk: no full-size temporary."""
    equal, err, close = True, 0.0, True
    for i in range(0, a.shape[0], chunk):
        x, y = a[i:i + chunk], b[i:i + chunk]
        equal = equal and torch.equal(x, y)
        if x.dtype == torch.bfloat16:       # differences taken in float32
            x, y = x.float(), y.float()
        if x.numel():
            err = max(err, float((x - y).abs().max()))
        if x.is_floating_point():
            close = close and torch.allclose(x, y, rtol=FLOAT_RTOL,
                                             atol=FLOAT_ATOL)
    return equal, err, close


def bits_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the elements whose bits differ (0.0 where
    every element's bits agree; inf where such an element is not finite
    in either)."""
    diff = a.reshape(-1).view(torch.int32) != b.reshape(-1).view(torch.int32)
    if not bool(diff.any()):
        return 0.0
    d = (a.reshape(-1)[diff] - b.reshape(-1)[diff]).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


def same_bytes(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096) -> bool:
    """Byte-equal 4-byte tensors of one shape, row chunk by row chunk."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dim() == 0:
        a, b = a[None], b[None]
    return all(torch.equal(a[i:i + chunk].view(torch.int32),
                           b[i:i + chunk].view(torch.int32))
               for i in range(0, a.shape[0], chunk))


def peak_gib(phase: str) -> float:
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / GIB
    print(f"[{phase}] peak device memory {peak:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    require(peak < PEAK_LIMIT_GIB,
            f"{phase} peaked at {peak:.3f} GiB, over {PEAK_LIMIT_GIB} GiB")
    return peak


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def zipf_streams(rng, n_streams: int, t: int, s: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, n_streams + 1) ** s
    return rng.choice(n_streams, size=t, p=p / p.sum())


def make_batch(rng, pop: np.ndarray, t: int) -> tuple:
    """Zipf(1.1) stream ids over ``pop`` with 10% unrouted ids and a few
    negative (masked) ids; integer weights 1..4."""
    sids = pop[zipf_streams(rng, len(pop), t)]
    unrouted = rng.rand(t) < 0.10
    sids[unrouted] = rng.randint(0, 2**62, size=int(unrouted.sum()),
                                 dtype=np.int64) | (1 << 62)
    sids[rng.rand(t) < 0.002] = -1
    vals = rng.randint(1, 5, size=t).astype(np.float32)
    return sids, vals


def probed_slots(b, lanes) -> int:
    """Distinct table slots the probe reads for the ``lanes`` ids."""
    from repro_torch.core import hashing
    from repro_torch.kernels import probe
    size = b.klo.shape[0]
    kh = hashing.as_u32(b.khi)
    kl = hashing.as_u32(b.klo)
    lo = hashing.as_u32(b.slo[lanes])
    hi = hashing.as_u32(b.shi[lanes])
    slot = probe.slot0(lo, hi, size)
    done = torch.zeros_like(lo, dtype=torch.bool)
    seen = []
    for _ in range(b.n_probe):
        seen.append(slot[~done])
        hit = (kl[slot] == lo) & (kh[slot] == hi)
        done = done | hit | (kh[slot] == probe.ROUTE_EMPTY_HI)
        slot = torch.where(done, slot, (slot + 1) & (size - 1))
    return int(torch.unique(torch.cat(seen)).numel())


def distinct(flat: torch.Tensor) -> int:
    return int(torch.unique(flat).numel())


def lane_stats(rows: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
               m: int) -> dict:
    """What a bit-set batch asks of the state [n, m]: the entries it keeps
    (row in [0, n) is not checked: the callers pass routed rows; upd > 0;
    position in [0, m)), the distinct lanes and 32-byte sectors they
    touch, the most entries on one lane, and the groups left after
    grouping equal lanes within each warp's 32 tuples at one hash index
    (at most the atomics the kernel issues on a state none of them is
    set in; its block table drops more)."""
    k = idx.shape[1]
    ok = (rows >= 0)[:, None] & (upd > 0)[:, None] & (idx >= 0) & (idx < m)
    key = torch.where(ok, rows.long()[:, None] * m + idx.long(), -1)
    flat = key[ok]
    lanes, counts = torch.unique(flat, return_counts=True)
    pad = (-key.shape[0]) % 32
    cols = torch.cat([key, key.new_full((pad, k), -1)]).view(-1, 32, k)
    cols = cols.transpose(1, 2).reshape(-1, 32).sort(dim=1).values
    groups = int(((cols[:, 1:] != cols[:, :-1]) & (cols[:, 1:] >= 0)).sum()
                 + (cols[:, 0] >= 0).sum())
    return dict(entries=int(flat.numel()), lanes=int(lanes.numel()),
                sectors=int(torch.unique(flat // 8).numel()),
                hottest=int(counts.max()) if counts.numel() else 0,
                warp_groups=groups)


# ---------------------------------------------------------------------------
# phase 2: every kernel entry point against its plain version
# ---------------------------------------------------------------------------
def record(results, name, fn_kernel, fn_plain, fn_lib, state0, n_bytes,
           n_ops, floats=None, atol=None, within=None, rate="float32",
           union=False, zeroed=False, first_touch=False):
    """Hold ``fn_kernel`` against ``fn_plain`` on copies of ``state0``
    (torch.equal; a max abs error of at most ``atol`` when given;
    ``within(kernel_out, plain_out)`` when given), then time kernel,
    plain and library call (``fn_lib`` None: no one PyTorch call computes
    the function), each on the state it left (for a max kernel: the batch
    already set), or, where ``zeroed``, on a state zeroed before every
    call as the data-source folds' fresh sketch is (the fill not timed).
    ``first_touch`` adds the kernel's time on a fresh copy of ``state0``
    before every call (the copy not timed). The bound takes ``n_ops`` at
    ``OPS_PER_S[rate]``; the kernel's device time is the union of its
    intervals where ``union`` (its kernels run on two streams)."""
    k = state0.clone()
    fn_kernel(k)
    p = state0.clone()
    fn_plain(p)
    torch.cuda.synchronize()
    equal, err, _ = compare(k, p)
    ok = (within(k, p) if within is not None else
          equal if atol is None else err <= atol)
    require(ok, f"{name}: kernel disagrees with its plain version (max abs "
                f"err {err}{'' if atol is None else f', atol {atol}'})")
    del p
    if floats is not None:
        floats(state0)
    zero = (lambda: k.zero_()) if zeroed else None
    kms = cuda_ms(lambda: fn_kernel(k), prep=zero)
    kdev = device_ms(lambda: fn_kernel(k), union=union, prep=zero,
                     label=name)
    first = {}
    if first_touch:
        restore = lambda: k.copy_(state0)
        first = dict(first_touch_ms=cuda_ms(lambda: fn_kernel(k),
                                            prep=restore),
                     first_touch_device_ms=device_ms(
                         lambda: fn_kernel(k), prep=restore,
                         label=f"{name} first touch"))
    p = state0.clone()
    zero = (lambda: p.zero_()) if zeroed else None
    pms = cuda_ms(lambda: fn_plain(p), prep=zero)
    pdev = device_ms(lambda: fn_plain(p), prep=zero,
                     label=f"{name} plain")
    lms = ldev = None
    if fn_lib is not None:
        lms = cuda_ms(lambda: fn_lib(p), prep=zero)
        ldev = device_ms(lambda: fn_lib(p), prep=zero,
                         label=f"{name} library")
    del k, p
    free()
    bms, by = bound_ms(n_bytes, n_ops, rate)
    results[name] = dict(max_abs_err=err, ms=kms, plain_ms=pms,
                         library_ms=lms, bound_ms=bms, bound_by=by,
                         device_ms=kdev,
                         plain_device_ms=pdev, library_device_ms=ldev,
                         **first)
    lib = ("no library call" if lms is None else
           f"library {lms:.4f} ms (device {ldev:.4f} ms)")
    match = (f"max abs err {err:.3g}, within its limits" if within else
             "exact match" if atol is None else
             f"max abs err {err:.3g} <= {atol}")
    touch = ("" if not first_touch else
             f", first touch {first['first_touch_ms']:.4f} ms (device "
             f"{first['first_touch_device_ms']:.4f} ms)")
    print(f"[phase2] {name}: {match}, kernel {kms:.4f} ms (device "
          f"{kdev:.4f} ms){' from zero' if zeroed else ''}{touch}, plain "
          f"{pms:.4f} ms (device {pdev:.4f} ms), "
          f"{lib}, bound {bms:.5f} ms ({by}, {n_bytes} B, {n_ops} ops at "
          f"the {rate} rate)", flush=True)


def float_runs(label, kern, plain, state0, check=None) -> None:
    """Float weights: two kernel runs byte-identical, and allclose to the
    plain version at FLOAT_RTOL / FLOAT_ATOL; where ``check`` is given,
    ``check(out)`` must hold too, and returns what it held (the bytes of
    a serial loop, a symmetric matrix)."""
    a = state0.clone()
    kern(a)
    c = state0.clone()
    kern(c)
    torch.cuda.synchronize()
    require(same_bytes(a, c), f"{label}: float-weight runs differ byte-wise")
    del c
    p = state0.clone()
    plain(p)
    _, ferr, close = compare(a, p)
    require(close, f"{label}: float weights off by {ferr}")
    tail = "" if check is None else f"; {check(a)}"
    print(f"[phase2] {label}: float weights byte-identical over 2 runs; max "
          f"abs err vs plain {ferr:.3g} (rtol {FLOAT_RTOL}, atol "
          f"{FLOAT_ATOL}){tail}", flush=True)
    del a, p
    free()


def phase2_batch(dev, seed: int, n_streams: int, t: int):
    """The route table, one batch and its routed rows, shared by every
    entry."""
    from repro_torch.kernels import ops
    from repro_torch.service import routing

    rng = np.random.RandomState(seed)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams, dtype=np.int64))
    table = routing.RouteTable()
    table.insert_many(pop, np.arange(len(pop), dtype=np.int32))
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    klo, khi = (dt(h.view(np.int32)) for h in routing.split64(table.keys))
    sids, vals = make_batch(rng, pop, t)
    slo, shi = (dt(h.view(np.int32)) for h in routing.split64(sids))
    b = types.SimpleNamespace(
        dev=dev, t=t, pop=pop, klo=klo, khi=khi, trows=dt(table.rows),
        slo=slo, shi=shi, n_probe=routing.next_pow2(table.max_probe),
        items=dt(routing.fold64(sids).view(np.int32)), vals=dt(vals),
        mask=dt((rng.rand(t) > 0.05) & (sids >= 0)), table_size=table.size,
        gen=torch.Generator(device=dev).manual_seed(seed))
    b.rows = ops.route_probe(b.klo, b.khi, b.trows, b.slo, b.shi,
                             n_probe=b.n_probe)
    b.to_row0 = torch.zeros(t, dtype=torch.int32, device=dev)
    require(int((b.rows < 0).sum()) > 0, "batch has no -1 lanes")
    require(int((~b.mask).sum()) > 0, "batch has no masked lanes")
    print(f"[phase2] T={t} unrouted={int((b.rows < 0).sum())} masked="
          f"{int((~b.mask).sum())} table size={table.size} "
          f"n_probe={b.n_probe}", flush=True)
    return b


def serial_countmin(state0, rows, idx, v, signs=None):
    """A check that a CountMin state holds, on the elements the batch
    touches, the bytes of a serial loop over the batch in float32 (numpy's
    ``add.at`` adds repeated indices in order; each weight ``v * sign``
    rounded on its own, zero weights skipped, as the kernels skip them)
    from ``state0``'s values."""
    n, d, w = state0.shape
    r, ix, vv = (x.cpu().numpy() for x in (rows, idx, v))
    sg = None if signs is None else signs.cpu().numpy()
    flat, wts = [], []
    for j in range(d):
        x = vv if sg is None else (vv * sg[:, j]).astype(np.float32)
        keep = (r >= 0) & (r < n) & (x != 0)
        flat.append((r[keep].astype(np.int64) * d + j) * w + ix[keep, j])
        wts.append(x[keep])
    uniq, inv = np.unique(np.concatenate(flat), return_inverse=True)
    where = torch.from_numpy(uniq).to(state0.device)
    want = state0.view(-1)[where].cpu().numpy()
    np.add.at(want, inv, np.concatenate(wts))

    def check(out):
        got = out.view(-1)[where].cpu().numpy()
        require(got.tobytes() == want.tobytes(),
                f"CountMin float weights: {int((got != want).sum())} of "
                f"{len(uniq)} touched elements differ from the serial loop")
        return "the serial loop's bytes on every touched element"
    return check


def countmin_split(b, results: dict, tag: str, state0, idx, v,
                   signs=None) -> None:
    """The add chains and the device time by kernel of the rows
    ``onehot_scatter_add<tag>`` and ``onehot_probe_scatter<tag>`` (already
    recorded) on a copy of ``state0``, as for RHP."""
    from repro_torch.kernels import onehot_matmul
    n = state0.shape[0]
    n_runs, longest = onehot_matmul.runs_of(b.rows, n)
    floor_ms, mhz = chain_floor_ms(longest)
    groups = {"probe_kernel": "probe", "sort_": "sort", "Memset": "sort",
              "gather_kernel": "gather", "walk_kernel": "walk"}
    for name, fn in ((f"onehot_scatter_add{tag}",
                      lambda s: onehot_matmul.onehot_scatter_add(
                          s, b.rows, idx, v, signs)),
                     (f"onehot_probe_scatter{tag}",
                      lambda s: onehot_matmul.onehot_probe_scatter(
                          s, b.klo, b.khi, b.trows, b.slo, b.shi, idx, v,
                          signs, n_probe=b.n_probe))):
        k = state0.clone()
        split = device_split(lambda: fn(k), groups, "other")
        del k
        r = results[name]
        r.update(longest_run=longest, runs=n_runs, chain_floor_ms=floor_ms,
                 split_device_ms=split)
        print(f"[phase2] {name}: {n_runs} runs, longest {longest} tuples, "
              f"chain floor {floor_ms:.5f} ms ({FADD_CYCLES} cycles an add "
              f"at {mhz:.0f} MHz) beside the bound {r['bound_ms']:.5f} ms; "
              f"device ms by kernel: " + ", ".join(
                  f"{g} {ms:.4f}" for g, ms in sorted(
                      split.items(), key=lambda kv: -kv[1])), flush=True)
    free()


def record_scatter(b, results: dict, tag: str, state0, idx, v, signs=None,
                   floats=None) -> None:
    """The rows ``onehot_scatter_add<tag>`` and ``onehot_probe_scatter<tag>``
    on ``state0`` [n, d, w] and phase 2's batch, each held against its plain
    version beside ``index_put_`` on the (signed) weights, then their split
    by kernel. Signs add T·d·4 bytes to the bound."""
    from repro_torch.kernels import onehot_matmul, probe, ref
    n, d, w = state0.shape
    t, dev, rows = b.t, b.dev, b.rows
    keep = rows >= 0
    kept_rows = rows[keep].long()
    ix = idx[keep].long()
    js = torch.arange(d, device=dev)[None, :].expand(ix.shape)
    lib_index = (kept_rows[:, None].expand(ix.shape), js, ix)
    x = v[keep][:, None]
    lib_vals = (x.expand(ix.shape) if signs is None
                else x * signs[keep]).contiguous()
    nz = v[keep] != 0
    state_b = 8 * distinct(((kept_rows[:, None] * d + js) * w + ix)[nz])
    # idx, signs where given, values
    batch_b = t * d * 4 * (1 if signs is None else 2) + t * 4
    n_upd = int(keep.sum()) * d
    slots = probed_slots(b, torch.ones_like(b.mask))
    lib = lambda s: s.index_put_(lib_index, lib_vals, accumulate=True)
    record(results, f"onehot_scatter_add{tag}",
           lambda s: onehot_matmul.onehot_scatter_add(s, rows, idx, v, signs),
           lambda s: ref.onehot_scatter_add(s, rows, idx, v, signs), lib,
           state0, t * 4 + batch_b + state_b, n_upd, floats=floats)
    record(results, f"onehot_probe_scatter{tag}",
           lambda s: onehot_matmul.onehot_probe_scatter(
               s, b.klo, b.khi, b.trows, b.slo, b.shi, idx, v, signs,
               n_probe=b.n_probe),
           lambda s: ref.onehot_scatter_add(
               s, probe.probe_rows(b.klo, b.khi, b.trows, b.slo, b.shi,
                                   n_probe=b.n_probe), idx, v, signs), lib,
           state0, t * 8 + TABLE_B * slots + batch_b + state_b, n_upd)
    countmin_split(b, results, tag, state0, idx, v, signs)


def record_fresh(b, results: dict, name: str, d: int, w: int, idx, v,
                 signs=None, floats=None) -> None:
    """A data-source fold's fresh sketch [1, d, w] (n = 1, every tuple to
    row 0, each entry keyed by its element as d * n < 1024) on phase 2's
    batch, held against its plain version beside ``index_put_`` on the
    (signed) weights; then its elements, longest run and split."""
    from repro_torch.kernels import onehot_matmul, ref
    t, dev = b.t, b.dev
    js = torch.arange(d, device=dev)[None, :].expand(idx.shape)
    lib_index = (torch.zeros_like(idx, dtype=torch.long), js, idx.long())
    x = v[:, None]
    lib_vals = (x.expand(idx.shape) if signs is None
                else x * signs).contiguous()
    fresh_b = 8 * distinct((js * w + idx.long())[v != 0])
    batch_b = t * d * 4 * (1 if signs is None else 2) + t * 4
    kern = lambda s: onehot_matmul.onehot_scatter_add(s, b.to_row0, idx, v,
                                                      signs)
    fresh0 = torch.zeros((1, d, w), device=dev)
    record(results, name, kern,
           lambda s: ref.onehot_scatter_add(s, b.to_row0, idx, v, signs),
           lambda s: s.index_put_(lib_index, lib_vals, accumulate=True),
           fresh0, t * 4 + batch_b + fresh_b, t * d, floats=floats)
    # its runs are elements: how many, the longest chain, and the split
    n_el, longest = onehot_matmul.element_runs_of(b.to_row0, idx, v, 1, w,
                                                  signs)
    floor_ms, mhz = chain_floor_ms(longest)
    k = fresh0.clone()
    split = device_split(lambda: kern(k),
                         {"key_kernel": "key", "sort_": "sort",
                          "Memset": "sort", "gather_kernel": "gather",
                          "walk_kernel": "walk"}, "other")
    del k
    r = results[name]
    r.update(longest_run=longest, runs=n_el, chain_floor_ms=floor_ms,
             split_device_ms=split)
    print(f"[phase2] {name}: {n_el} elements, the longest run {longest} "
          f"entries, chain floor {floor_ms:.5f} ms ({FADD_CYCLES} cycles an "
          f"add at {mhz:.0f} MHz) beside the bound {r['bound_ms']:.5f} ms; "
          f"device ms by kernel: " + ", ".join(
              f"{g} {ms:.4f}" for g, ms in sorted(
                  split.items(), key=lambda kv: -kv[1])), flush=True)


def fresh_float_check(b, label: str, d: int, w: int, idx, v, signs=None):
    """The ``floats`` hook of a fresh-sketch row: float weights ``v`` on a
    zero [1, d, w] sketch, held to a serial loop."""
    from repro_torch.kernels import onehot_matmul, ref

    def check(state0):
        zero = torch.zeros((1, d, w), device=b.dev)
        float_runs(label,
                   lambda s: onehot_matmul.onehot_scatter_add(
                       s, b.to_row0, idx, v, signs),
                   lambda s: ref.onehot_scatter_add(s, b.to_row0, idx, v,
                                                    signs),
                   zero, serial_countmin(zero, b.to_row0, idx, v, signs))
    return check


def phase2_countmin(b, n: int, results: dict) -> None:
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import onehot_matmul, ref

    cm = core.CountMin(eps=0.002, delta=0.01)
    d, w, t, dev = cm.depth, cm.width, b.t, b.dev
    idx = hashing.bucket_hash(b.items, cm._seeds(), cm.log2_width)
    v_int = b.vals * b.mask.float()
    v_flt = torch.rand(t, generator=b.gen, device=dev) * 4 * b.mask.float()
    rows, keep = b.rows, b.rows >= 0
    kept_rows = rows[keep].long()
    print(f"[phase2] CountMin: n={n} d={d} w={w}", flush=True)
    # the kernels' own row sort against torch.sort(stable=True) (the
    # yardstick, here only)
    srow, perm = onehot_matmul.sort_rows(rows, n)
    want_rows, order = torch.sort(kept_rows.int(), stable=True)
    require(torch.equal(srow, want_rows) and torch.equal(
        perm.long(), torch.nonzero(keep)[:, 0][order]),
        "the CountMin row sort differs from torch.sort(stable=True)")
    print(f"[phase2] CountMin row sort: {srow.numel()} tuples, equal to "
          f"torch.sort(stable=True)", flush=True)
    del srow, perm, want_rows, order

    def float_checks(state0):
        serial = serial_countmin(state0, rows, idx, v_flt)
        float_runs("onehot_scatter_add",
                   lambda s: onehot_matmul.onehot_scatter_add(s, rows, idx,
                                                              v_flt),
                   lambda s: ref.onehot_scatter_add(s, rows, idx, v_flt),
                   state0, serial)
        float_runs("onehot_probe_scatter",
                   lambda s: onehot_matmul.onehot_probe_scatter(
                       s, b.klo, b.khi, b.trows, b.slo, b.shi, idx, v_flt,
                       n_probe=b.n_probe),
                   lambda s: ref.onehot_scatter_add(s, rows, idx, v_flt),
                   state0, serial)

    cm0 = torch.randint(0, 8, (n, d, w), generator=b.gen, device=dev,
                        dtype=torch.int32).to(torch.float32)
    record_scatter(b, results, "", cm0, idx, v_int, floats=float_checks)
    del cm0
    free()
    record_fresh(b, results, "onehot_scatter_add@fresh", d, w, idx, v_int,
                 floats=fresh_float_check(b, "onehot_scatter_add@fresh", d,
                                          w, idx, v_flt))


def phase2_ams(b, n: int, results: dict) -> None:
    """Kernels #1 and #2 as AMS runs them: AMS()'s [12, 2048] rows with +-1
    signs (seed 13), phase 2's batch and integer weights, on n rows; then
    AMS's data-source fold, [1, 12, 2048]."""
    from repro_torch import core

    ams = core.AMS()
    d, w, t, dev = ams.depth, ams.width, b.t, b.dev
    idx, sg = ams._hash(b.items)
    v_int = b.vals * b.mask.float()
    v_flt = torch.rand(t, generator=b.gen, device=dev) * 4 * b.mask.float()
    print(f"[phase2] AMS: n={n} d={d} w={w} ({n * d * w * 4 / GIB:.3f} GiB), "
          f"+-1 signs from sign_hash, integer weights", flush=True)
    ams0 = torch.randint(-4, 5, (n, d, w), generator=b.gen, device=dev,
                         dtype=torch.int32).to(torch.float32)
    record_scatter(b, results, "@ams", ams0, idx, v_int, sg)
    del ams0
    free()
    name = "onehot_scatter_add@fresh@ams"
    record_fresh(b, results, name, d, w, idx, v_int, sg,
                 floats=fresh_float_check(b, f"{name} signed", d, w, idx,
                                          v_flt, sg))


def phase2_hll(b, n: int, results: dict) -> None:
    """HLL's three rows on the bit-set kernel at k = 1: the bucket is the
    one position, the rank the upd."""
    from repro_torch import core
    from repro_torch.kernels import hll_max, ops, probe, ref

    hll = core.HyperLogLog(rse=0.03)
    m, dev, rows = hll.m, b.dev, b.rows
    bucket, raw_rank = ops._hll_prep(b.items, hll.seed, hll.p)
    rank = torch.where(b.mask, raw_rank, 0).to(torch.int32)
    pos = bucket[:, None]
    print(f"[phase2] HyperLogLog: n={n} m={m}", flush=True)
    hll0 = torch.randint(0, 4, (n, m), generator=b.gen, device=dev,
                         dtype=torch.int32)
    record_bitset(
        b, results, "hll_max_update",
        lambda s: hll_max.hll_max_update(s, rows, bucket, rank),
        lambda s: ref.hll_max_update(s, rows, bucket, rank),
        hll0, rows, pos, rank, fused=False)
    record_bitset(
        b, results, "hll_probe_max_update",
        lambda s: hll_max.hll_probe_max_update(
            s, b.klo, b.khi, b.trows, b.slo, b.shi, bucket, rank,
            n_probe=b.n_probe),
        lambda s: ref.hll_max_update(
            s, probe.probe_rows(b.klo, b.khi, b.trows, b.slo, b.shi,
                                n_probe=b.n_probe), bucket, rank),
        hll0, rows, pos, rank, fused=True)
    del hll0
    free()
    # the data-source fold's fresh sketch, zeroed before every call as
    # ops._max_fold makes it
    record_bitset(
        b, results, "hll_max_update@fresh",
        lambda s: hll_max.hll_max_update(s, b.to_row0, bucket, rank),
        lambda s: ref.hll_max_update(s, b.to_row0, bucket, rank),
        torch.zeros((1, m), dtype=torch.int32, device=dev),
        b.to_row0, pos, rank, fused=False, zeroed=True)


def record_bitset(b, results, name, kernel, plain, state0, rows, idx, upd,
                  fused, zeroed=False):
    """Record one bit-set entry (``fused``: the probe runs in the kernel)
    with its library call and bound: on a zeroed state where ``zeroed``
    (a fresh sketch), else on the set state and on a first touch; print
    the lanes the batch touches beside the bound."""
    m = state0.shape[1:].numel()
    k = idx.shape[1]
    keep = (rows >= 0) & (upd > 0)
    pos = idx[keep].long()
    flat = (rows[keep].long()[:, None] * m + pos).reshape(-1)
    src = upd[keep][:, None].expand(pos.shape).reshape(-1).contiguous()
    # rows (or sid halves), idx, upd; touched lanes read and written once
    n_bytes = b.t * (8 if fused else 4) + b.t * k * 4 + b.t * 4 \
        + 8 * distinct(flat)
    if fused:
        n_bytes += TABLE_B * probed_slots(b, upd > 0)
    stats = lane_stats(rows, idx, upd, m)
    print(f"[phase2] {name}: {stats['entries']} entries on {stats['lanes']} "
          f"distinct lanes in {stats['sectors']} 32-byte sectors, the "
          f"hottest lane {stats['hottest']} entries; {stats['warp_groups']} "
          f"groups of equal lanes by warp and hash index", flush=True)
    record(results, name, kernel, plain,
           lambda s: s.view(-1).scatter_reduce_(0, flat, src, reduce="amax"),
           state0, n_bytes, int(keep.sum()) * k, zeroed=zeroed,
           first_touch=not zeroed)
    results[name].update(lanes=stats["lanes"], sectors=stats["sectors"],
                         hottest_lane=stats["hottest"])


def phase2_bloom(b, n: int, results: dict) -> None:
    from repro_torch import core
    from repro_torch.kernels import bitset_or, probe, ref

    bloom = core.BloomFilter(n_elements=1024, fpr=0.01)
    m, dev, rows = bloom.n_bits, b.dev, b.rows
    idx = bloom._positions(b.items)
    upd = b.mask.to(torch.int32)
    require(int((upd == 0).sum()) > 0, "batch has no upd-0 lanes")
    print(f"[phase2] Bloom: n={n} m={m} k={bloom.k} "
          f"({n * m * 4 / GIB:.1f} GiB)", flush=True)
    bits0 = (torch.rand((n, m), generator=b.gen, device=dev) > 0.9).to(
        torch.int32)
    record_bitset(
        b, results, "bitset_max_update",
        lambda s: bitset_or.bitset_max_update(s, rows, idx, upd),
        lambda s: ref.bitset_max_update(s, rows, idx, upd),
        bits0, rows, idx, upd, fused=False)
    record_bitset(
        b, results, "bitset_probe_max_update",
        lambda s: bitset_or.bitset_probe_max_update(
            s, b.klo, b.khi, b.trows, b.slo, b.shi, idx, upd,
            n_probe=b.n_probe),
        lambda s: ref.bitset_max_update(
            s, probe.probe_rows(b.klo, b.khi, b.trows, b.slo, b.shi,
                                n_probe=b.n_probe), idx, upd),
        bits0, rows, idx, upd, fused=True)
    del bits0
    free()

    # the data-source Bloom's fresh sketch: 2**24 lanes, every tuple
    src_bloom = core.BloomFilter(n_elements=SRC_BLOOM_ELEMENTS, fpr=0.01)
    sidx = src_bloom._positions(b.items)
    record_bitset(
        b, results, "bitset_max_update@fresh",
        lambda s: bitset_or.bitset_max_update(s, b.to_row0, sidx, upd),
        lambda s: ref.bitset_max_update(s, b.to_row0, sidx, upd),
        torch.zeros((1, src_bloom.n_bits), dtype=torch.int32, device=dev),
        b.to_row0, sidx, upd, fused=False, zeroed=True)
    free()

    # 64-bit offsets: 2**32 lanes, tuples routed to the last rows (not
    # timed; kernel and plain copies only)
    big = 2 * n
    big_rows = torch.where(rows >= 0, big - 1 - rows, rows)
    big_rows[:64] = big - 1
    big_idx = idx.clone()
    big_idx[:64, 0] = m - 1
    big_trows = torch.where(b.trows >= 0, big - 1 - b.trows, b.trows)
    print(f"[phase2] Bloom offset check: n={big} m={m} "
          f"({big * m / 2**32:.0f} x 2**32 lanes), rows "
          f"{int(big_rows[big_rows >= 0].min())}..{int(big_rows.max())}",
          flush=True)
    k_bits = torch.zeros((big, m), dtype=torch.int32, device=dev)
    p_bits = torch.zeros((big, m), dtype=torch.int32, device=dev)
    for label, kern, plain in (
            ("bitset_max_update",
             lambda s: bitset_or.bitset_max_update(s, big_rows, big_idx, upd),
             lambda s: ref.bitset_max_update(s, big_rows, big_idx, upd)),
            ("bitset_probe_max_update",
             lambda s: bitset_or.bitset_probe_max_update(
                 s, b.klo, b.khi, big_trows, b.slo, b.shi, big_idx, upd,
                 n_probe=b.n_probe),
             lambda s: ref.bitset_max_update(
                 s, probe.probe_rows(b.klo, b.khi, big_trows, b.slo, b.shi,
                                     n_probe=b.n_probe), big_idx, upd))):
        k_bits.zero_()
        p_bits.zero_()
        kern(k_bits)
        plain(p_bits)
        torch.cuda.synchronize()
        equal, err, _ = compare(k_bits, p_bits)
        set_lanes = sum(int(torch.count_nonzero(k_bits[i:i + 4096]))
                        for i in range(big // 2, big, 4096))
        require(equal and set_lanes > 0,
                f"{label}: kernel disagrees with its plain version on the "
                f"2**32-lane stack (max abs err {err})")
        last = int(k_bits[-1, -1])
        require(last == 1 or label != "bitset_max_update",
                f"{label}: the stack's last lane was not set")
        print(f"[phase2] {label}: exact match on the {big} x {m} stack "
              f"({set_lanes} lanes set in its upper half, last lane "
              f"{last})", flush=True)
    del k_bits, p_bits
    free()


def phase2_fm(b, n: int, results: dict) -> None:
    from repro_torch import core
    from repro_torch.kernels import fm_bitmap, probe, ref

    fm = core.FMSketch()
    maps, bits, dev, rows = fm.nmaps, fm.bitmap_size, b.dev, b.rows
    which, pos = fm._which_pos(b.items)
    upd = b.mask.to(torch.int32)
    flat_pos = torch.add(pos, which, alpha=bits)[:, None]
    print(f"[phase2] FM: n={n} maps={maps} bits={bits}", flush=True)
    fm0 = (torch.rand((n, maps, bits), generator=b.gen, device=dev)
           > 0.9).to(torch.int32)
    record_bitset(
        b, results, "fm_bit_update",
        lambda s: fm_bitmap.fm_bit_update(s, rows, which, pos, upd),
        lambda s: ref.bitset_max_update(s.view(n, -1), rows, flat_pos, upd),
        fm0, rows, flat_pos, upd, fused=False)
    record_bitset(
        b, results, "fm_probe_bit_update",
        lambda s: fm_bitmap.fm_probe_bit_update(
            s, b.klo, b.khi, b.trows, b.slo, b.shi, which, pos, upd,
            n_probe=b.n_probe),
        lambda s: ref.bitset_max_update(
            s.view(n, -1), probe.probe_rows(b.klo, b.khi, b.trows, b.slo,
                                            b.shi, n_probe=b.n_probe),
            flat_pos, upd),
        fm0, rows, flat_pos, upd, fused=True)
    del fm0
    free()
    record_bitset(
        b, results, "fm_bit_update@fresh",
        lambda s: fm_bitmap.fm_bit_update(s, b.to_row0, which, pos, upd),
        lambda s: ref.bitset_max_update(s.view(1, -1), b.to_row0, flat_pos,
                                        upd),
        torch.zeros((1, maps, bits), dtype=torch.int32, device=dev),
        b.to_row0, flat_pos, upd, fused=False, zeroed=True)


def phase2_rhp(b, n: int, results: dict) -> None:
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import ref, rhp_project

    rhp = core.RHP()
    nb, t, dev, rows = rhp.n_bits, b.t, b.dev, b.rows
    sgn = hashing.sign_hash(b.items, rhp._seeds())              # [T, b]
    v_int = b.vals * b.mask.float()
    v_flt = torch.rand(t, generator=b.gen, device=dev) * 4 * b.mask.float()
    keep = rows >= 0
    kept_rows = rows[keep].long()
    kept_v, kept_sgn = v_int[keep], sgn[keep]
    # rows (or sid halves), v and the dense sgn read once; touched state
    # rows read and written once; one multiply and one add per plane
    batch_b = t * 4 + t * nb * 4
    state_b = 8 * nb * distinct(kept_rows)
    n_ops = 2 * int(keep.sum()) * nb
    slots = probed_slots(b, torch.ones_like(b.mask))
    print(f"[phase2] RHP: n={n} b={nb} ({n * nb * 4 / GIB:.3f} GiB), "
          f"{int(keep.sum())} routed tuples onto {distinct(kept_rows)} rows",
          flush=True)
    lib = lambda s: s.index_add_(0, kept_rows, kept_v[:, None] * kept_sgn)
    project = lambda v: (lambda s: rhp_project.rhp_project_update(s, rows, v,
                                                                  sgn))
    project_plain = lambda v: (lambda s: ref.rhp_project_update(s, rows, v,
                                                                sgn))
    fused = lambda v: (lambda s: rhp_project.rhp_probe_update(
        s, b.klo, b.khi, b.trows, b.slo, b.shi, v, sgn, n_probe=b.n_probe))
    fused_plain = lambda v: (lambda s: ref.rhp_probe_update(
        s, b.klo, b.khi, b.trows, b.slo, b.shi, v, sgn, n_probe=b.n_probe))

    def float_checks(state0):
        float_runs("rhp_project_update", project(v_flt), project_plain(v_flt),
                   state0)
        float_runs("rhp_probe_update", fused(v_flt), fused_plain(v_flt),
                   state0)

    rhp0 = torch.randint(-8, 8, (n, nb), generator=b.gen, device=dev,
                         dtype=torch.int32).to(torch.float32)
    record(results, "rhp_project_update", project(v_int),
           project_plain(v_int), lib, rhp0, t * 4 + batch_b + state_b, n_ops,
           floats=float_checks, union=True)
    record(results, "rhp_probe_update", fused(v_int), fused_plain(v_int), lib,
           rhp0, t * 8 + TABLE_B * slots + batch_b + state_b, n_ops,
           union=True)
    # the add chains: the longest run's adds are one dependent chain (the
    # byte contract), FADD_CYCLES each at the card's top SM clock
    n_long, longest = rhp_project.long_runs_of(rows, n)
    floor_ms, mhz = chain_floor_ms(longest)
    groups = {"probe_kernel": "probe", "products_kernel": "products",
              "short_kernel": "short walk", "long_kernel": "long walk"}
    for name, fn in (("rhp_project_update", project(v_int)),
                     ("rhp_probe_update", fused(v_int))):
        wrapper = getattr(rhp_project, name)
        k = rhp0.clone()
        wrapper.long_runs.reset()
        fn(k)
        walked = int(wrapper.long_runs)
        require(walked == n_long > 0, f"{name}: the ring walk took {walked} "
                                      f"runs, not the batch's {n_long} runs "
                                      f"of {rhp_project.LONG_RUN}+ tuples")
        split = device_split(lambda: fn(k), groups, "sort")
        del k
        r = results[name]
        r.update(longest_run=longest, long_runs=n_long,
                 chain_floor_ms=floor_ms, split_device_ms=split)
        print(f"[phase2] {name}: longest run {longest} tuples, chain floor "
              f"{floor_ms:.5f} ms ({FADD_CYCLES} cycles an add at {mhz:.0f} "
              f"MHz) beside the bound {r['bound_ms']:.5f} ms; {n_long} runs "
              f"of {rhp_project.LONG_RUN}+ tuples, all walked by the ring; "
              f"device ms by kernel (the short walk runs beside the "
              f"products pass and the long walk): " + ", ".join(
                  f"{g} {ms:.4f}" for g, ms in sorted(
                      split.items(), key=lambda kv: -kv[1])), flush=True)
    del rhp0
    free()

    # edge shapes: b = 200 (a ragged lane slice), rows -1 and n, and a
    # batch that is no multiple of 32 (not timed)
    en, eb, et = 4096, 200, t - 13
    erows = torch.where(rows[:et] >= 0, rows[:et] % en, rows[:et])
    erows[::97] = en
    erows[1::89] = -1
    esgn = hashing.sign_hash(b.items[:et], core.RHP(n_bits=eb)._seeds())
    e0 = torch.randint(-8, 8, (en, eb), generator=b.gen, device=dev,
                       dtype=torch.int32).to(torch.float32)
    kern = lambda v: (lambda s: rhp_project.rhp_project_update(s, erows, v,
                                                               esgn))
    plain = lambda v: (lambda s: ref.rhp_project_update(s, erows, v, esgn))
    k, p = e0.clone(), e0.clone()
    kern(v_int[:et])(k)
    plain(v_int[:et])(p)
    torch.cuda.synchronize()
    equal, err, _ = compare(k, p)
    require(equal, f"rhp_project_update: b={eb} edge batch disagrees with "
                   f"the plain version (max abs err {err})")
    print(f"[phase2] rhp_project_update: exact match on the {en} x {eb} "
          f"edge stack, T={et}", flush=True)
    del k, p
    float_runs(f"rhp_project_update (b={eb})", kern(v_flt[:et]),
               plain(v_flt[:et]), e0)


def sectors(rows: torch.Tensor, width: int) -> int:
    """Distinct 32-byte sectors that rows ``rows`` of ``width`` bytes each
    touch in an array that starts on a sector boundary."""
    if rows.numel() == 0:
        return 0
    first = rows * width // 32
    last = ((rows + 1) * width - 1) // 32
    ids = [torch.where(first + k <= last, first + k, first)
           for k in range(int((last - first).max()) + 1)]
    return int(torch.unique(torch.cat(ids)).numel())


def phase2_dft(b, n: int, results: dict) -> None:
    """The sliding-DFT tick as the engine calls it: in place on the
    interleaved [S, F, 2] coefficient leaf of a Figure-6 DFT stack
    (window 128, 8 coefficients; ``benchmarks/fig6_dft_workflow.py``),
    rows masked where the batch routes a tuple, at S = n and S = 2**20."""
    from repro_torch import core
    from repro_torch.kernels import ref, sliding_dft

    dft = core.DFT(**FIG6_DFT)
    f, dev = dft.n_coeffs, b.dev
    tw_re, tw_im = dft._twiddle(dev)

    for s_rows in (n, 1 << 20):
        hit = torch.zeros(s_rows, dtype=torch.float32, device=dev)
        hit[b.rows[(b.rows >= 0) & b.mask].long() % s_rows] = 1.0
        delta = torch.randn(s_rows, generator=b.gen, device=dev) * 4

        def kern(c, hit=hit, delta=delta):
            sliding_dft.sliding_dft_step(c[..., 0], c[..., 1], delta, hit,
                                         tw_re, tw_im)

        def plain(c, hit=hit, delta=delta):
            ref.sliding_dft_step(c[..., 0], c[..., 1], delta, hit, tw_re,
                                 tw_im)

        coeff0 = torch.randn((s_rows, f, 2), generator=b.gen, device=dev) * 40
        k, p = coeff0.clone(), coeff0.clone()
        kern(k)
        plain(p)
        require(same_bytes(k, p), f"sliding_dft_step: kernel differs "
                                  f"byte-wise from its plain version at "
                                  f"S={s_rows}")
        rows_in = torch.nonzero(hit > 0)[:, 0]
        n_hit = rows_in.numel()
        print(f"[phase2] DFT: S={s_rows} F={f}, interleaved [S, F, 2] leaf "
              f"in place, {n_hit} rows masked in; byte-equal to the plain "
              f"version", flush=True)
        del k, p
        # what the in-place tick must move: every row's mask read; each
        # masked-in row's (re, im) row read and written and its delta read,
        # in the 32-byte sectors they touch; the twiddles read. 7 float
        # operations per ticked element
        n_bytes = (s_rows * 4 + 2 * 32 * sectors(rows_in, f * 8)
                   + 32 * sectors(rows_in, 4) + f * 8)
        name = "sliding_dft_step" + ("" if s_rows == n else f"@{s_rows}")
        record(results, name, kern, plain, None, coeff0, n_bytes,
               7 * f * n_hit)
        del coeff0
        free()


def corr_exact(label):
    """A check that a correlation matrix is symmetric bit for bit and its
    diagonal exactly 1."""
    def check(out):
        require(same_bytes(out, out.T.contiguous()),
                f"{label}: not symmetric bit for bit")
        require(torch.equal(out.diagonal(), torch.ones_like(out.diagonal())),
                f"{label}: the diagonal is not exactly 1")
        return "symmetric bit for bit, diagonal exactly 1"
    return check


def phase2_corr(b, n: int, results: dict) -> None:
    """The pairwise correlation at N = 5,000 and K = 16 (x ~ 0.1 N(0, 1),
    as the reference's kernel test draws it): within CORR_ATOL of the
    plain version, byte-identical across two runs, symmetric bit for bit
    with a diagonal of exactly 1. The float32 matmul
    settings are read and must be full float32, so that neither the plain
    version nor the library call runs in TF32."""
    from repro_torch.kernels import pairwise_corr, ref

    del n
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    require(tf32 is False, f"torch.backends.cuda.matmul.allow_tf32 is "
                           f"{tf32}: the plain version would run in TF32")
    require(precision == "highest", f"float32 matmul precision is "
                                    f"{precision!r}, not 'highest'")
    nn, k, dev = CORR_N, CORR_K, b.dev
    x = torch.randn((nn, k), generator=b.gen, device=dev) * 0.1
    print(f"[phase2] pairwise correlation: N={nn} K={k} -> [N, N] f32 "
          f"({nn * nn * 4 / 1e6:.0f} MB); allow_tf32={tf32}, "
          f"float32_matmul_precision={precision!r}", flush=True)
    kern = lambda s: pairwise_corr.pairwise_corr(x, s)
    plain = lambda s: ref.pairwise_corr(x, s)

    def lib(s):
        sq = torch.sum(x * x, dim=-1)
        torch.sub(1.0, sq[:, None] + sq[None, :] - 2.0 * torch.mm(x, x.T),
                  out=s)

    # the output written once, the input read once; 2 K operations a pair
    record(results, "pairwise_corr", kern, plain, lib,
           torch.zeros((nn, nn), device=dev), nn * nn * 4 + nn * k * 4,
           2 * nn * nn * k,
           floats=lambda s0: float_runs("pairwise_corr", kern, plain, s0,
                                        corr_exact("pairwise_corr")),
           atol=CORR_ATOL)


def attn_inputs(gen, bh: int, sq: int, sk: int, d: int, dtype,
                qk_scale: float = 0.3):
    """q and k at ``qk_scale`` N(0, 1) (0.3: the reference's kernel
    test's scale), v at N(0, 1), drawn in float32 and cast to ``dtype``."""
    dev = gen.device
    q = torch.randn((bh, sq, d), generator=gen, device=dev) * qk_scale
    k = torch.randn((bh, sk, d), generator=gen, device=dev) * qk_scale
    v = torch.randn((bh, sk, d), generator=gen, device=dev)
    return tuple(x.to(dtype) for x in (q, k, v))


def attn_work(bh: int, sq: int, sk: int, d: int, causal: bool,
              itemsize: int):
    """(bytes, operations) of one attention forward: q, k, v read once and
    out written once; 4 D operations (q.k and p.v, a multiply and an add
    each) for every (query, key) pair the mask keeps."""
    if not causal:
        pairs = sq * sk
    elif sq <= sk:
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sk * (sk + 1) // 2 + (sq - sk) * sk
    return bh * (2 * sq + 2 * sk) * d * itemsize, 4 * bh * d * pairs


def attn_check(got: torch.Tensor, want: torch.Tensor):
    """(largest abs error, largest ratio of an element's error to its
    limit), in float32; within the limits when the ratio is <= 1. The
    limit is ATTN_F32_TOL of the largest output for float32, and for
    bfloat16 ATTN_BF16_RTOL of the element plus ATTN_BF16_ATOL of the
    largest output."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    top = float(w.abs().max())
    if got.dtype == torch.float32:
        limit = ATTN_F32_TOL * top
    else:
        limit = ATTN_BF16_RTOL * w.abs() + ATTN_BF16_ATOL * top
    return float(err.max()), float((err / limit).max())


def attn_limit(dtype) -> str:
    return (f"{ATTN_F32_TOL} of the largest output" if dtype == torch.float32
            else f"2**-7 of each element + {ATTN_BF16_ATOL} of the largest "
                 f"output")


def phase2_flash(b, n: int, results: dict) -> None:
    """The attention forward at each config's width, batch 1 at S = 4096,
    causal bfloat16 (ATTN_WIDTHS: Qwen2-72B's row ``flash_attention``,
    Qwen2-0.5B's ``@d64``, Gemma-7B's ``@d256``): within ``attn_check``'s
    limits of the plain version, byte-identical across two runs, timed
    beside ``scaled_dot_product_attention``. Then, untimed, Qwen2-72B's
    shape in float32, with peaky scores (q, k at ATTN_PEAKY N(0, 1): the
    running max moves across key tiles), Gemma-7B's heads peaky, a ragged
    causal S, a non-causal S and a causal Sq > Sk, each against the plain
    version (which follows the reference's oracle) and byte-identical
    across two runs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref

    del n
    bf16 = torch.bfloat16
    s = ATTN_S
    for name, (h, d) in ATTN_WIDTHS.items():
        q, k, v = attn_inputs(b.gen, h, s, s, d, bf16)
        n_bytes, n_ops = attn_work(h, s, s, d, True, 2)
        kern = lambda o: fa.flash_attention(q, k, v, True, o)

        def two_runs(state0):
            a, c = state0.clone(), state0.clone()
            kern(a)
            kern(c)
            torch.cuda.synchronize()
            require(same_bytes(a, c), f"{name}: two runs differ byte-wise")
            print(f"[phase2] {name}: byte-identical over 2 runs", flush=True)

        def within(got, want):
            err, worst = attn_check(got, want)
            print(f"[phase2] {name}: q/k/v [{h}, {s}, {d}] bf16 causal: max "
                  f"abs err {err:.3g}, worst element at {worst:.3g} of its "
                  f"limit ({attn_limit(bf16)})", flush=True)
            return worst <= 1.0

        # the library call on [1, H, S, D] views: PyTorch's fused attention
        # backends take 4-D inputs only (3-D ones run its unfused math path)
        record(results, name, kern,
               lambda o: ref.flash_attention(q, k, v, True, o),
               lambda o: F.scaled_dot_product_attention(
                   q[None], k[None], v[None], is_causal=True),
               torch.zeros((h, s, d), dtype=bf16, device=b.dev), n_bytes,
               n_ops, floats=two_runs, within=within,
               rate="bf16 tensor cores")
        del q, k, v, kern
        free()

    # untimed exactness: (label, BH, Sq, Sk, D, dtype, causal, q/k scale)
    h, d = ATTN_WIDTHS["flash_attention"]
    for label, bh, sq, sk, dd, dtype, causal, qk in (
            ("Qwen2-72B f32", h, s, s, d, torch.float32, True, 0.3),
            ("peaky scores", h, s, s, d, bf16, True, ATTN_PEAKY),
            ("peaky non-causal", h, s, s, d, bf16, False, ATTN_PEAKY),
            ("Gemma-7B peaky", 16, s, s, 256, bf16, True, ATTN_PEAKY),
            ("ragged causal", h, 4000, 4000, d, bf16, True, 0.3),
            ("non-causal", h, s, s, d, bf16, False, 0.3),
            ("causal Sq > Sk", 2, 200, 100, 64, bf16, True, 0.3)):
        q, k, v = attn_inputs(b.gen, bh, sq, sk, dd, dtype, qk)
        got = fa.flash_attention(q, k, v, causal)
        again = fa.flash_attention(q, k, v, causal)
        want = ref.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        err, worst = attn_check(got, want)
        require(worst <= 1.0, f"flash_attention ({label}): max abs err "
                              f"{err}, {worst:.3g} times its limit")
        require(same_bytes(got, again), f"flash_attention ({label}): two "
                                        f"runs differ byte-wise")
        print(f"[phase2] flash_attention ({label}): [{bh}, {sq}, {sk}, {dd}] "
              f"{str(dtype)[6:]} causal={causal} q/k {qk} N(0,1): max abs "
              f"err {err:.3g}, worst element at {worst:.3g} of its limit "
              f"({attn_limit(dtype)}), byte-identical over 2 runs",
              flush=True)
        del q, k, v, got, again, want
        free()


def order_keys(counts: np.ndarray) -> np.ndarray:
    """csrc/lossy_scan.cu's order key of each float32 count, as uint32:
    -0 as +0, NaN least."""
    u = counts.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    o = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    o[np.isnan(counts)] = 0
    return o


def lossy_replay(keys, counts, items, values) -> dict:
    """A host replay of one Lossy table's scan (keys [k] i32, counts [k]
    f32) over ``items`` / ``values`` in order, with the reference's step,
    counting the work its dependences need: ``misses`` (empty slots taken
    and evictions), ``levels`` (evictions that find no slot left of the
    least count a level before found: the least count taken again from
    every count), ``hottest`` (the most adds into one slot, hits and
    takes, which stay in batch order) and the ``keys`` after, which a
    caller holds to the plain version's. Synchronises; for checks."""
    keys = keys.cpu().numpy().copy()
    counts = counts.cpu().numpy().copy()
    adds = np.zeros(keys.shape[0], np.int64)
    level: set = set()
    misses = levels = 0
    for x, v in zip(items.cpu().numpy().tolist(),
                    values.cpu().numpy().astype(np.float32)):
        hit = np.flatnonzero(keys == x)     # the sentinel: the first empty
        if hit.size:
            j = int(hit[0])
            counts[j] = counts[j] + v
        else:
            misses += 1
            empty = np.flatnonzero(keys == -1)
            if empty.size:
                j = int(empty[0])
                counts[j] = np.float32(0.0) + v
                level = set()
            else:
                o = order_keys(counts)
                j = int(np.argmin(o))
                if j not in level:
                    levels += 1
                    level = set(np.flatnonzero(o == o[j]).tolist())
                counts[j] = counts[j] + v
            keys[j] = x
        level.discard(j)
        adds[j] += 1
    return dict(misses=misses, levels=levels,
                hottest=int(adds.max()) if adds.size else 0, keys=keys)


def phase2_lossy(b, n: int, results: dict) -> None:
    """The Lossy Counting scan at the reference's default eps = 0.01
    (k = 100, row ``lossy_scan``) and at eps = 0.001 (k = 1000,
    ``lossy_scan@k1000``) on phase 2's batch: n rows, routed as the
    batch's probe gives them, plus one data-source row (row n_streams, as
    the engine allocates it). Kernel against its plain version on the
    card from an empty stack, byte for byte, and byte-equal across two
    kernel runs; the kernel timed on the state it left (25 CUDA-event
    calls, 5 profiler calls, and its split by kernel), the plain version
    from its one checked call (it takes seconds: one launch a torch op of
    every step). No one PyTorch call computes the scan: no library time.
    The data-source walk's misses, levels and hottest slot's adds come
    from a host replay of its tuples (``lossy_replay``), whose keys must
    equal the plain version's. The bound is the larger of the bytes (the
    batch read once, each walked row's table read and written once) and
    the chain (the levels at LOSSY_LEVEL_CYCLES, or the most adds into one
    slot, a walk's hottest or the longest routed run's, at FADD_CYCLES);
    the misses at LOSSY_LEVEL_CYCLES each and the earlier floor, every
    step of the longest walk at LOSSY_STEP_CYCLES, are printed beside it:
    neither is a bound, as a phase of the kernel takes many misses at
    once and a group many steps."""
    from repro_torch import core
    from repro_torch.core import batched
    from repro_torch.kernels import lossy_scan, ref

    t, dev = b.t, b.dev
    src = torch.tensor([n // 2], dtype=torch.int64, device=dev)
    batch = (b.rows, b.items, b.vals, b.mask, src)
    walks, longest = lossy_scan.walks_of(b.rows, b.mask, n, src)
    longest_run = lossy_scan.walks_of(b.rows, b.mask & (b.rows != src[0]),
                                      n)[1]
    step_floor_ms, mhz = chain_floor_ms(longest, LOSSY_STEP_CYCLES)
    for name, eps in (("lossy_scan", 0.01), ("lossy_scan@k1000", 0.001)):
        kind = core.LossyCounting(eps=eps)
        k = kind.k
        state0 = batched.stacked_init(kind, n, dev)
        leaves = lambda st: (st["keys"], st["counts"], st["error"])
        runs = []
        for _ in range(2):
            st = batched.tree_map(torch.clone, state0)
            lossy_scan.lossy_scan_update(*leaves(st), *batch)
            runs.append(st)
        torch.cuda.synchronize()
        require(same_leaves(runs[0], runs[1]),
                f"{name}: two kernel runs differ byte-wise")
        plain = batched.tree_map(torch.clone, state0)
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        ref.lossy_scan_update(*leaves(plain), *batch)
        z.record()
        z.synchronize()
        pms = a.elapsed_time(z)
        require(same_leaves(runs[0], plain),
                f"{name}: kernel differs byte-wise from its plain version")
        _, err, _ = compare(runs[0]["counts"], plain["counts"])
        r0 = int(src[0])
        rp = lossy_replay(state0["keys"][r0], state0["counts"][r0],
                          b.items[b.mask], b.vals[b.mask])
        misses, levels, hottest = rp["misses"], rp["levels"], rp["hottest"]
        require(np.array_equal(rp["keys"], plain["keys"][r0].cpu().numpy()),
                f"{name}: the miss count's host replay differs from the "
                f"plain version's keys")
        del plain, runs[1]
        k_state = runs.pop()
        kern = lambda: lossy_scan.lossy_scan_update(*leaves(k_state), *batch)
        kms = cuda_ms(kern)
        # the scan's few launches hide behind its ms of device time, so a
        # window reading under LOSSY_DEVICE_SHARE of the event time lost
        # activities
        kdev = device_ms(kern, label=name, floor_ms=LOSSY_DEVICE_SHARE * kms)
        split = device_split(kern, {"walk_kernel": "walk", "sort_": "sort",
                                    "Memset": "sort", "key_kernel": "key",
                                    "flag_kernel": "flag"}, "other",
                             label=name, floor_ms=LOSSY_DEVICE_SHARE * kms)
        n_bytes = t * (4 + 4 + 4 + 1) + 4 * src.numel() + walks * k * 12 * 2
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        level_ms = chain_floor_ms(levels, LOSSY_LEVEL_CYCLES)[0]
        miss_ms = chain_floor_ms(misses, LOSSY_LEVEL_CYCLES)[0]
        adds_ms = chain_floor_ms(max(hottest, longest_run))[0]
        floor_ms = max(level_ms, adds_ms)
        bms = max(t_bytes, floor_ms)
        by = "bytes" if t_bytes >= floor_ms else "operations"
        results[name] = dict(
            max_abs_err=err, ms=kms, plain_ms=pms, library_ms=None,
            bound_ms=bms, bound_by=by, device_ms=kdev, plain_device_ms=None,
            library_device_ms=None, runs=walks, longest_run=longest,
            chain_floor_ms=floor_ms, step_floor_ms=step_floor_ms,
            miss_floor_ms=miss_ms, misses=misses, levels=levels,
            hottest_adds=hottest, split_device_ms=split, k=k,
            plain_timing="one call (CUDA events); its device time not "
                         "measured",
            library="none: no one PyTorch call computes it")
        print(f"[phase2] {name}: k={k}, n={n} rows + data-source row "
              f"{r0}, exact match (keys, counts, error byte for byte; two "
              f"kernel runs byte-identical), kernel {kms:.4f} ms (device "
              f"{kdev:.4f} ms), plain {pms:.1f} ms (one call), no library "
              f"call; {walks} walks, the longest {longest} steps (the "
              f"data-source row: {misses} misses, {levels} levels, the "
              f"hottest slot {hottest} adds; the longest routed run "
              f"{longest_run}); chain {floor_ms:.5f} ms (levels at "
              f"{LOSSY_LEVEL_CYCLES} cycles {level_ms:.5f}, adds at "
              f"{FADD_CYCLES} cycles {adds_ms:.5f}, at {mhz:.0f} MHz), "
              f"bytes {t_bytes:.5f} ms ({n_bytes} B): bound {bms:.5f} ms "
              f"({by}); not bounds, for comparison: every miss at "
              f"{LOSSY_LEVEL_CYCLES} cycles {miss_ms:.5f} ms, every step "
              f"at {LOSSY_STEP_CYCLES} cycles {step_floor_ms:.5f} ms; "
              f"device ms by kernel: " +
              ", ".join(f"{g} {ms:.4f}" for g, ms in sorted(
                  split.items(), key=lambda kv: -kv[1])), flush=True)
        del k_state, state0, kern
        free()


def reservoir_stack(n: int, s: int, dev):
    """A sampler stack's three leaves as views of one int32 buffer, so that
    a restore is one copy: (buffer, {values [n, s] f32, items [n, s] i32,
    n_seen [n] i32}), all zero."""
    buf = torch.zeros(2 * n * s + n, dtype=torch.int32, device=dev)
    return buf, dict(values=buf[:n * s].view(torch.float32).view(n, s),
                     items=buf[n * s:2 * n * s].view(n, s),
                     n_seen=buf[2 * n * s:])


def reservoir_writes(kind, rows, items, mask, n: int, src: torch.Tensor,
                     n_seen0: torch.Tensor) -> tuple:
    """(walks, longest walk, slots written) of one batch on a sampler
    stack of n rows with data-source rows ``src``: the walks of the plain
    version (``ref._walks``), each tuple ranked by its place in its walk,
    and its slot and write from the reference's step arithmetic
    (``core/sampler.slots_of``); a slot is written once however many
    tuples draw it, so the slots written are also the tuples whose value
    is read. Synchronises; for the bound, not for the path."""
    from repro_torch.core import sampler
    from repro_torch.kernels import ref
    walk_rows, parts = zip(*ref._walks(rows, mask, n, src))
    tix = [torch.nonzero(p)[:, 0] if p.dtype == torch.bool else p
           for p in parts]
    sizes = torch.tensor([p.numel() for p in tix], device=rows.device)
    row = torch.repeat_interleave(
        torch.tensor(walk_rows, device=rows.device), sizes)
    rank = (torch.arange(row.numel(), device=rows.device)
            - torch.repeat_interleave(torch.cumsum(sizes, 0) - sizes, sizes))
    tix = torch.cat(tix)
    slot, write = sampler.slots_of(n_seen0[row].long() + rank, items[tix],
                                   kind.sample_size, kind.seed)
    written = torch.unique(row[write] * kind.sample_size + slot[write])
    return len(walk_rows), int(sizes.max()), int(written.numel())


def phase2_reservoir(b, n: int, results: dict) -> None:
    """The reservoir sampler's update (no TPU counterpart) through both
    entry points, rows given (``reservoir_scan``) and the routing probe
    fused in (``reservoir_probe_scan``, on the batch's stream ids and
    table), at the reference's defaults (S = 64, seed 41) on phase 2's
    batch: n rows, routed as the batch's probe gives them, plus one
    data-source row (row n_streams, as the engine allocates it); from
    empty rows (the fill, as a new stack's first batch) and from rows past
    the fill (counts 64 to 2**20, random samples). Kernel against its
    plain version on the card (the fused entry's: the plain probe, then
    the plain update), byte for byte in values, items and n_seen, and
    byte-equal across two kernel runs; each timed from its starting
    state: 25 CUDA-event calls on a copy restored before every call (the
    copy not timed), 5 profiler calls each on a copy made before the
    window; the plain version from its one checked call (seconds: torch
    ops a row and a write). No one PyTorch call computes it: no library
    time. The bound is the bytes: the batch read once (rows, or the
    stream ids' halves, items and mask of every tuple, the value of each
    slot's last writer), for the fused entry each table slot the masked
    tuples' probes read (TABLE_B bytes), each walked row's n_seen read and
    written, each slot written once (``reservoir_writes``); no step
    depends on another. A profiler window must hold RESERVOIR_ACTIVITIES
    a call, else it is taken again; so must one of two stacks (S = 64 and
    16) updated in turn, each size with its own scratch."""
    from repro_torch import core
    from repro_torch.kernels import probe, ref, reservoir_scan

    t, dev = b.t, b.dev
    kind = core.ReservoirSampler()
    s = kind.sample_size
    src_row = n // 2
    src = torch.tensor([src_row], dtype=torch.int64, device=dev)
    tail = (b.items, b.vals, b.mask, src)
    table = (b.klo, b.khi, b.trows, b.slo, b.shi)
    leaves = lambda st: (st["values"], st["items"], st["n_seen"])
    entries = {
        "reservoir_scan": (
            lambda st: reservoir_scan.reservoir_scan_update(
                *leaves(st), b.rows, *tail, seed=kind.seed),
            lambda st: ref.reservoir_scan_update(
                *leaves(st), b.rows, *tail, seed=kind.seed),
            t * 4),
        "reservoir_probe_scan": (
            lambda st: reservoir_scan.reservoir_probe_scan_update(
                *leaves(st), *table, *tail, n_probe=b.n_probe,
                seed=kind.seed),
            lambda st: ref.reservoir_scan_update(
                *leaves(st), probe.probe_rows(*table, n_probe=b.n_probe),
                *tail, seed=kind.seed),
            t * 8 + TABLE_B * probed_slots(b, b.mask))}
    out = {name: {} for name in entries}
    for label in ("empty", "past_fill"):
        buf0, st0 = reservoir_stack(n, s, dev)
        if label == "past_fill":
            st0["n_seen"].random_(s, 1 << 20, generator=b.gen)
            st0["items"].random_(-(1 << 31), 1 << 31, generator=b.gen)
            st0["values"].normal_(generator=b.gen)
        walks, longest, writes = reservoir_writes(
            kind, b.rows, b.items, b.mask, n, src, st0["n_seen"])
        for name, (kernel, plain, rows_b) in entries.items():
            runs = []
            for _ in range(2):
                buf, st = reservoir_stack(n, s, dev)
                buf.copy_(buf0)
                kernel(st)
                runs.append((buf, st))
            torch.cuda.synchronize()
            require(torch.equal(runs[0][0], runs[1][0]),
                    f"{name} ({label}): two kernel runs differ byte-wise")
            pbuf, pst = reservoir_stack(n, s, dev)
            pbuf.copy_(buf0)
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            plain(pst)
            z.record()
            z.synchronize()
            pms = a.elapsed_time(z)
            kbuf, kst = runs[0]
            require(torch.equal(kbuf, pbuf),
                    f"{name} ({label}): kernel differs byte-wise from its "
                    f"plain version")
            _, err, _ = compare(kst["values"], pst["values"])
            del runs, pbuf, pst
            kern = lambda: kernel(kst)
            restore = lambda: kbuf.copy_(buf0)
            kms = cuda_ms(kern, prep=restore)
            # the profiler's calls each on a copy of the starting state,
            # restored before each window (for the warm-up and 5 runs), so
            # that no copy runs among the activities it sums
            pool = [reservoir_stack(n, s, dev) for _ in range(6)]
            calls = iter(())

            def refill():
                nonlocal calls
                for pbuf, _ in pool:
                    pbuf.copy_(buf0)
                torch.cuda.synchronize()
                calls = iter(pool)

            fresh = lambda: kernel(next(calls)[1])
            kdev = device_ms(fresh, label=f"{name} ({label})",
                             activities=RESERVOIR_ACTIVITIES, reset=refill)
            names = {}
            refill()
            for act, _, _ in device_events(fresh, runs=1, pad=PAD_LAUNCHES):
                names[act[:40]] = names.get(act[:40], 0) + 1
            # rows (or the ids' halves and the table slots the probes
            # read), items and mask of every tuple, the value of each
            # slot's last writer; each walked row's n_seen in and out;
            # each slot's value and item out
            n_bytes = (rows_b + t * (4 + 1) + 8 * src.numel()
                       + walks * 4 * 2 + writes * (4 + 4 + 4))
            bms, by = bound_ms(n_bytes, 0)
            out[name][label] = dict(max_abs_err=err, ms=kms, plain_ms=pms,
                                    bound_ms=bms, bound_by=by,
                                    device_ms=kdev, walks=walks,
                                    longest_run=longest, writes=writes)
            print(f"[phase2] {name} ({label}): S={s}, n={n} rows + "
                  f"data-source row {src_row}, exact match (values, items, "
                  f"n_seen byte for byte; two kernel runs byte-identical), "
                  f"kernel {kms:.4f} ms (device {kdev:.4f} ms), plain "
                  f"{pms:.1f} ms (one call), no library call; {walks} "
                  f"walks, the longest {longest} tuples, {writes} slots "
                  f"written; bound {bms:.5f} ms ({by}, {n_bytes} B); device "
                  f"activities of a call: {names}", flush=True)
            del kern, restore, kbuf, kst, pool, fresh
            free()
        del buf0, st0
        free()
    # two stacks of different sizes in turn, as an engine with two sampler
    # kinds updates them in every batch: each size keeps its own scratch,
    # so a window must still hold RESERVOIR_ACTIVITIES a call
    small = core.ReservoirSampler(sample_size=16)
    pair = [(kd, reservoir_stack(n, kd.sample_size, dev)[1])
            for kd in (kind, small)]

    def both():
        for kd, st in pair:
            reservoir_scan.reservoir_scan_update(*leaves(st), b.rows, *tail,
                                                 seed=kd.seed)

    pair_ms = device_ms(both, label="reservoir_scan (two stacks)",
                        activities=2 * RESERVOIR_ACTIVITIES)
    print(f"[phase2] reservoir_scan (two stacks, S={s} and "
          f"{small.sample_size}, in turn): device {pair_ms:.4f} ms a pair, "
          f"{RESERVOIR_ACTIVITIES} device activities a call", flush=True)
    del pair
    free()
    for name in entries:
        results[name] = dict(
            out[name]["empty"], library_ms=None, plain_device_ms=None,
            library_device_ms=None, past_fill=out[name]["past_fill"],
            start="empty rows (the fill)",
            plain_timing="one call (CUDA events); its device time not "
                         "measured",
            library="none: no one PyTorch call computes it")
    results["reservoir_scan"]["two_stacks_device_ms"] = pair_ms


def sticky_stack(n: int, cap: int, dev):
    """A Sticky stack's four leaves as views of one int32 buffer, so that
    a restore is one copy: (buffer, {keys [n, cap] i32 (all -1), counts
    [n, cap] f32, n_seen [n] i32, epoch [n] i32 (all 0)})."""
    buf = torch.zeros(2 * n * cap + 2 * n, dtype=torch.int32, device=dev)
    st = dict(keys=buf[:n * cap].view(n, cap),
              counts=buf[n * cap:2 * n * cap].view(torch.float32).view(n, cap),
              n_seen=buf[2 * n * cap:2 * n * cap + n],
              epoch=buf[2 * n * cap + n:])
    st["keys"].fill_(-1)
    return buf, st


def sticky_leaves(st: dict) -> tuple:
    return st["keys"], st["counts"], st["n_seen"], st["epoch"]


def sticky_replay(kind, keys, counts, n_seen: int, epoch: int,
                  items: torch.Tensor, end_check: bool) -> dict:
    """A host replay of one Sticky table's walk over its own ``items`` in
    order (keys [cap] i32, counts [cap] f32 as the batch found them),
    with the reference's checks: the batch's first, one before each
    tuple, and with ``end_check`` the one after the last. It counts what
    the walk's dependences need: ``bumps``, ``hits``, ``takes`` (empty
    slots taken), ``hottest`` (the most dependent updates of one slot: its
    adds, and a subtract at each bump) and the ``keys`` after, which a
    caller holds to the plain version's; and what the kernel's walk meets:
    ``serial_steps`` (steps that find an empty slot after their check),
    ``full_steps`` (the rest) and ``serial_groups``: the groups of 32
    steps from the walk's start that change a key (an admission, or a
    bump that empties a slot: the first-step bump counts in the first
    group, the end check's in the last), which alone hand the next group
    work through the keys. Synchronises; for the bound."""
    from repro_torch.core import hashing, sticky
    keys = keys.cpu().numpy().copy()
    counts = counts.cpu().numpy().copy()
    cap = keys.shape[0]
    t_kind = 16 * cap
    chain = np.zeros(cap, np.int64)
    got = dict(bumps=0, hits=0, takes=0)
    serial = np.zeros(items.shape[0], bool)
    changed = np.zeros(max(items.shape[0], 1), bool)
    rates = np.asarray(sticky.inv_rates(), np.float32)
    slots = torch.arange(cap, dtype=torch.int64)
    m = items.shape[0]
    n = (int(n_seen) + 1 + torch.arange(m + 1, dtype=torch.int64)
         + 2**31) % 2**32 - 2**31
    want = sticky.want_of(n, t_kind).tolist()
    x = items.cpu()
    coin = hashing.uniform01(hashing.as_u32(x) ^ hashing.as_u32(n[:m]),
                             kind.seed + 1).numpy()

    def bump(c, i):
        g = sticky.geo_of(hashing.hash_u32(slots ^ (c & hashing.MASK32),
                                           kind.seed)).numpy()
        d = counts - g
        counts[:] = np.where(d < 0, np.float32(0.0), d)
        changed[i] |= bool(((counts <= 0) & (keys != -1)).any())
        keys[counts <= 0] = -1
        chain[:] += 1
        got["bumps"] += 1

    e = int(epoch)
    if want[0] > e:                             # the batch's first step
        bump(int(n[0]), 0)
        e = want[0]
    for i, item in enumerate(x.tolist()):
        if want[i] > e:
            bump(int(n[i]), i)
            e = want[i]
        serial[i] = bool((keys == -1).any())
        hit = np.flatnonzero(keys == item)      # the sentinel: first empty
        if hit.size:
            j = int(hit[0])
            got["hits"] += 1
        else:
            empty = np.flatnonzero(keys == -1)
            j = (int(empty[0]) if empty.size
                 and coin[i] < rates[min(e, sticky.MAX_RATE_EPOCH)] else -1)
            got["takes"] += j >= 0
            changed[i] |= j >= 0 and item != -1
        if j >= 0:
            keys[j] = item
            counts[j] = counts[j] + np.float32(1.0)
            chain[j] += 1
    if m and end_check and want[m] > e:
        bump(int(n[m]), m - 1)
    groups = np.zeros(-(-m // 32) * 32, bool)
    groups[:m] = changed[:m]
    return dict(got, hottest=int(chain.max()), keys=keys,
                serial_steps=int(serial.sum()), full_steps=int(m - serial.sum()),
                serial_groups=int(groups.reshape(-1, 32).any(1).sum()))


def sticky_floats(dev) -> dict:
    """The kernel's own want_epoch and geo (``sticky_scan.eval_tables``:
    the tables and lookups the kernel uses) against the port's literal
    float32 functions on the CPU: want_epoch at every count from 1 to
    2**24 for the capacities phase 2 runs (288 and 4,096), and geo at
    every distinct float32 u that ``uniform01`` can return (u = float32(h)
    * 2**-32: every hash below 2**24, then each float of [2**24, 2**32]
    once). Returns the counts of values checked."""
    from repro_torch.core import sticky
    from repro_torch.kernels import sticky_scan
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    counts_n = 1 << 24
    n = torch.arange(1, counts_n + 1, dtype=torch.int32)
    for cap in (288, 4096):
        want, _ = sticky_scan.eval_tables(cap, 1, counts_n, none)
        require(torch.equal(want.cpu(), sticky.want_epoch(n, 16 * cap)),
                f"sticky_scan: the kernel's want_epoch at capacity {cap} "
                f"differs from the CPU's float32 function below 2**24")
    chunks = [torch.arange(0, 1 << 24, dtype=torch.int64)]
    for k in range(24, 32):          # the floats of [2**k, 2**(k + 1))
        chunks.append((1 << k) + (torch.arange(0, 1 << 23, dtype=torch.int64)
                                  << (k - 23)))
    chunks.append(torch.tensor([2**32 - 1], dtype=torch.int64))  # u = 1.0
    n_u = 0
    for h in chunks:
        bits = (h.to(torch.int64) - (h >= 2**31).to(torch.int64) * 2**32)
        _, geo = sticky_scan.eval_tables(288, 1, 0,
                                         bits.to(torch.int32).to(dev))
        want = sticky.geo_of_hash(h)
        require(torch.equal(geo.cpu().view(torch.int32),
                            want.view(torch.int32)),
                "sticky_scan: the kernel's geo differs from the CPU's "
                "float32 function")
        n_u += h.numel()
    print(f"[phase2] sticky_scan float functions: the kernel's want_epoch "
          f"equals the CPU's float32 one at every count 1..2**24 (capacities"
          f" 288 and 4096), its geo at all {n_u} distinct float32 draws of "
          f"uniform01", flush=True)
    return dict(want_counts=counts_n, geo_draws=n_u)


def sticky_bump_state(kind, st: dict, b, n: int, src_row: int) -> tuple:
    """Counts that make phase 2's batch take each kind of bump the
    reference's masked steps take, set in place on ``st`` (the tables as
    earlier batches left them): every 16th row is pending a bump at the
    batch's first step (n_seen one below epoch 1's first count, epoch
    0); each row 8 past those that the batch walks and whose last tuple
    is not the batch's last reaches that count with its last tuple (a
    bump after its walk); the data-source row is half its walk below its
    next epoch (a bump inside its walk), at its count's epoch. Returns
    the masks of the first-step and the end-of-walk rows."""
    from repro_torch.core import sticky
    t_kind = 16 * kind.capacity
    starts = sticky.epoch_starts(t_kind)
    dev = st["n_seen"].device
    keep = b.mask & (b.rows >= 0) & (b.rows < n)
    rows = b.rows[keep].long()
    fed = torch.bincount(rows, minlength=n)
    last = torch.full((n,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, rows, torch.arange(b.t, device=dev)[keep], "amax")
    r = torch.arange(n, device=dev)
    first = (r % 16 == 0) & (r != src_row)
    end = ((r % 16 == 8) & (r != src_row) & (fed > 0)
           & (fed < starts[0] - 1) & (last < b.t - 1))
    st["n_seen"][first] = starts[0] - 1
    st["epoch"][first] = 0
    st["n_seen"][end] = (starts[0] - 1 - fed[end]).to(torch.int32)
    st["epoch"][end] = 0
    e = int(sticky.want_of(st["n_seen"][src_row:src_row + 1].cpu(), t_kind))
    at = starts[e] - int(b.mask.sum()) // 2
    require(at > 0 and int(sticky.want_of(torch.tensor([at]), t_kind)) == e,
            f"sticky at capacity {kind.capacity}: the source walk cannot "
            f"start half a walk below epoch {e + 1} within epoch {e}")
    st["n_seen"][src_row] = at
    st["epoch"][src_row] = e
    return first, end


STICKY_SPLIT = {"sticky_walk_kernel": "walk", "bump_kernel": "bump",
                "sort_": "sort"}


def kernel_split(kern, restore, groups: dict, runs: int = 3) -> dict:
    """Device ms of a call a run by kernel (``device_events`` with
    PAD_LAUNCHES spin kernels first): each activity whose name holds a key
    of ``groups`` under its value (for the sticky scan: the walk,
    ``bump_kernel`` and the row sort), every other one under "other" (the
    key pass, flags, memsets, torch ops); the state restored before each
    call, its copy left out."""
    split: dict = {}
    for name, start, end in device_events(lambda: (restore(), kern()), runs,
                                          pad=PAD_LAUNCHES):
        if "emcpy" in name:
            continue
        key = next((g for k, g in groups.items() if k in name), "other")
        split[key] = split.get(key, 0.0) + (end - start) / runs / 1e3
    return split


def sticky_bytes(buf0: torch.Tensor, buf: torch.Tensor, n: int, cap: int,
                 walks: int) -> int:
    """The bytes a Sticky update from ``buf0`` to ``buf`` (``sticky_stack``
    buffers) must move besides the batch's: every row's n_seen and epoch
    read (the first-step checks), each walked table's keys read (a miss
    rules out every key), each bumped table's counts read (the rows
    whose epoch rose), each changed word written once, and each changed
    count outside a bumped table read."""
    nc = n * cap
    diff = buf != buf0
    counts = diff[nc:2 * nc].view(n, cap)
    bumped = diff[2 * nc + n:]
    words = (int(diff[:nc].sum()) + int(counts.sum())
             + int(counts[~bumped].sum()) + int(diff[2 * nc:].sum()))
    return n * 8 + walks * 4 * cap + int(bumped.sum()) * 4 * cap + 4 * words


def phase2_sticky(b, n: int, results: dict) -> None:
    """Sticky Sampling's update (no TPU counterpart) at the reference's
    defaults (capacity 288) through both entry points, rows given
    (``sticky_scan``) and the probe fused in (``sticky_probe_scan``), and
    rows given at support 0.001, eps 0.0001 (7,195 slots by the formula,
    capped to 4,096: ``sticky_scan@cap4096``, the largest table and the
    shared-memory case), on phase 2's batch: n rows routed as the batch's
    probe gives them, plus one data-source row (row n_streams); from empty
    tables and from the state STICKY_PAST_BATCHES batches leave (the
    source row a few epochs on), its counts set by ``sticky_bump_state``:
    there the plain version must bump rows at the first step, after their
    walks and inside the source walk. First the float-function check
    (``sticky_floats``). For each parameter set and state the plain
    version runs once (its walks on the host, timed): each entry's kernel
    must equal it byte for byte in the four leaves (the fused entry's
    plain version is the plain probe, whose rows the batch's are, then
    this one) and equal itself across two runs. Each kernel is timed from
    its starting state restored before every call (the copy not timed):
    STICKY_TIMING_RUNS CUDA-event calls and 5 queued calls
    (``queued_device_ms``). No one PyTorch call computes it. The bound is
    the larger of the bytes (the batch read once, or the ids' halves and
    the table slots the probes read; then ``sticky_bytes`` of the plain
    version's change) and the source walk's groups that change a key
    at STICKY_GROUP_CYCLES each (a host replay, ``sticky_replay``, whose
    keys must equal the plain version's; its steps with an empty slot,
    full-table steps, admissions and bumps are printed first). The earlier
    figure, the hottest slot's dependent updates at FADD_CYCLES, is kept
    beside the bound: the kernel folds a slot's adds, so it no longer binds
    it, and a kernel that reads under it is named."""
    from repro_torch import core
    from repro_torch.kernels import lossy_scan, probe, ref, sticky_scan

    t, dev = b.t, b.dev
    floats = sticky_floats(dev)
    src_row = n // 2
    src = torch.tensor([src_row], dtype=torch.int64, device=dev)
    table = (b.klo, b.khi, b.trows, b.slo, b.shi)
    walks, longest = lossy_scan.walks_of(b.rows, b.mask, n, src)
    masked = torch.nonzero(b.mask)[:, 0]
    end_check = int(masked[-1]) < t - 1
    t0 = time.perf_counter()
    probe.probe_rows(*table, n_probe=b.n_probe)
    torch.cuda.synchronize()
    probe_ms = (time.perf_counter() - t0) * 1e3
    for params, names in ((STICKY_PARAMS, ("sticky_scan",
                                           "sticky_probe_scan")),
                          (STICKY_CAP4096_PARAMS, ("sticky_scan@cap4096",))):
        kind = core.StickySampling(**params)
        cap, kp = kind.capacity, kind.params()
        fused_update = sticky_scan.sticky_probe_scan_update
        entries = {
            "sticky_scan": lambda st: sticky_scan.sticky_scan_update(
                *sticky_leaves(st), b.rows, b.items, b.mask, src, **kp),
            "sticky_probe_scan": lambda st: fused_update(
                *sticky_leaves(st), *table, b.items, b.mask, src,
                n_probe=b.n_probe, **kp)}
        out = {name: {} for name in names}
        buf0, st0 = sticky_stack(n, cap, dev)
        for label in ("empty", "past_epochs"):
            bump_rows = None
            if label == "past_epochs":
                for _ in range(STICKY_PAST_BATCHES):
                    entries["sticky_scan"](st0)
                bump_rows = sticky_bump_state(kind, st0, b, n, src_row)
            nxt = st0["n_seen"].long() + 1
            first = int((core.sticky.want_of(nxt, 16 * cap)
                         > st0["epoch"]).sum())
            rp = sticky_replay(kind, st0["keys"][src_row],
                               st0["counts"][src_row],
                               int(st0["n_seen"][src_row]),
                               int(st0["epoch"][src_row]),
                               b.items[b.mask], end_check)
            pbuf, pst = sticky_stack(n, cap, dev)
            pbuf.copy_(buf0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref.sticky_scan_update(*sticky_leaves(pst), b.rows, b.items,
                                   b.mask, src, **kp)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            require(np.array_equal(rp["keys"],
                                   pst["keys"][src_row].cpu().numpy()),
                    f"sticky_scan at capacity {cap} ({label}): the host "
                    f"replay of the source walk differs from the plain "
                    f"version's keys")
            n_end = 0
            if bump_rows is not None:
                rose = pst["epoch"] > st0["epoch"]
                n_end = int(bump_rows[1].sum())
                require(first > 0 and n_end > 0 and rp["bumps"] > 0
                        and bool(rose[bump_rows[0] | bump_rows[1]].all())
                        and bool(rose[src_row]),
                        f"sticky_scan at capacity {cap} ({label}): the plain "
                        f"version took {first} first-step bumps, "
                        f"{n_end} rows set to bump after their walks, the "
                        f"source walk {rp['bumps']} bumps; each must be "
                        f"some and each such row's epoch must rise")
            words_b = sticky_bytes(buf0, pbuf, n, cap, walks)
            chain_ms, mhz = chain_floor_ms(rp["hottest"])
            group_ms, _ = chain_floor_ms(rp["serial_groups"],
                                         STICKY_GROUP_CYCLES)
            print(f"[phase2] sticky_scan at capacity {cap} ({label}): the "
                  f"source walk's {b.items[b.mask].numel()} steps: "
                  f"{rp['serial_steps']} with an empty slot, "
                  f"{rp['serial_groups']} groups of 32 that change a key, "
                  f"{rp['full_steps']} on a full table, {rp['takes']} "
                  f"admissions, {rp['bumps']} bumps, {rp['hits']} hits "
                  f"(host replay)", flush=True)
            for name in names:
                kernel = entries[name.split("@")[0]]
                fused = name.startswith("sticky_probe")
                runs = []
                for _ in range(2):
                    buf, st = sticky_stack(n, cap, dev)
                    buf.copy_(buf0)
                    kernel(st)
                    runs.append((buf, st))
                torch.cuda.synchronize()
                require(torch.equal(runs[0][0], runs[1][0]),
                        f"{name} ({label}): two kernel runs differ byte-wise")
                del runs[1]
                kbuf, kst = runs.pop()
                require(torch.equal(kbuf, pbuf),
                        f"{name} ({label}): kernel differs byte-wise from "
                        f"its plain version")
                _, err, _ = compare(kst["counts"], pst["counts"])
                restore = lambda: kbuf.copy_(buf0)
                kern = lambda: kernel(kst)
                kms = cuda_ms(kern, runs=STICKY_TIMING_RUNS, prep=restore)
                kdev = queued_device_ms(kern, restore)
                split = kernel_split(kern, restore, STICKY_SPLIT)
                batch_b = (t * (8 + 4 + 1)
                           + TABLE_B * probed_slots(b, b.mask) if fused
                           else t * (4 + 4 + 1) + 4 * src.numel())
                n_bytes = batch_b + words_b
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                bms = max(t_bytes, group_ms)
                by = "bytes" if t_bytes >= group_ms else "operations"
                plain_ms = pms + (probe_ms if fused else 0.0)
                under = kdev < chain_ms
                note = (", which the kernel reads under: it folds a slot's "
                        "adds" if under else "")
                out[name][label] = dict(
                    max_abs_err=err, ms=kms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, device_ms=kdev, walks=walks,
                    longest_run=longest, hottest_adds=rp["hottest"],
                    bumps=rp["bumps"], hits=rp["hits"], takes=rp["takes"],
                    serial_steps=rp["serial_steps"],
                    serial_groups=rp["serial_groups"],
                    full_steps=rp["full_steps"], group_floor_ms=group_ms,
                    former_chain_ms=chain_ms, under_former_chain=under,
                    split_device_ms=split,
                    first_step_bumps=first, end_of_walk_bumps=n_end)
                print(f"[phase2] {name} ({label}): capacity {cap}, n={n} "
                      f"rows + data-source row {src_row}, exact match (keys, "
                      f"counts, n_seen, epoch byte for byte; two kernel runs "
                      f"byte-identical), kernel {kms:.4f} ms (device "
                      f"{kdev:.4f} ms), plain {plain_ms:.1f} ms (one call, "
                      f"its walks on the host"
                      f"{', the plain probe first' if fused else ''}), "
                      f"no library call; {walks} walks, the longest "
                      f"{longest} tuples; {first} rows bump at the first "
                      f"step, {n_end} after their walks; the source walk: "
                      f"{rp['hits']} hits, "
                      f"{rp['takes']} slots taken, {rp['bumps']} bumps, "
                      f"profiled device ms by kernel "
                      f"{ {k: round(v, 4) for k, v in split.items()} }, "
                      f"{rp['serial_groups']} groups that change a key at "
                      f"{STICKY_GROUP_CYCLES} cycles {group_ms:.5f} ms "
                      f"({mhz:.0f} MHz), bytes {t_bytes:.5f} ms ({n_bytes} B):"
                      f" bound {bms:.5f} ms ({by}); beside it the former "
                      f"chain, the hottest slot's {rp['hottest']} dependent "
                      f"updates at {FADD_CYCLES} cycles, {chain_ms:.5f} ms"
                      f"{note}", flush=True)
                del kern, restore, kbuf, kst
                free()
            del pbuf, pst
            free()
        del buf0, st0
        free()
        for name in names:
            results[name] = dict(
                out[name]["empty"], library_ms=None, plain_device_ms=None,
                library_device_ms=None, past_epochs=out[name]["past_epochs"],
                capacity=cap, start="empty tables",
                plain_timing="one call (host clock, synchronized; its walks "
                             "on the host); its device time not measured",
                device_timing="CUDA events around the call queued behind a "
                              "spin kernel (no host enqueue inside), median "
                              "of 5",
                library="none: no one PyTorch call computes it")
    results["sticky_scan"]["float_check"] = floats


GK_SPLIT = {"gk_warp_kernel": "warp rows", "gk_small_kernel": "small rows",
            "gk_big_kernel": "big rows",
            "sort_": "row sort", "gk_key_kernel": "key pass",
            "gk_bounds_kernel": "run bounds"}


def gk_stack(n: int, m: int, dev):
    """A GK stack's two leaves as views of one float32 buffer, so that a
    restore is one copy: (buffer, {values [n, m], n [n]}), all zero."""
    buf = torch.zeros(n * m + n, dtype=torch.float32, device=dev)
    return buf, dict(values=buf[:n * m].view(n, m), n=buf[n * m:])


def gk_idle_state(kind, b, n: int, src: torch.Tensor):
    """The state GK_IDLE_BATCHES batches leave on rows whose counts start
    in the thousands (1,000 to 10,000, each row's values sorted normals):
    each batch phase 2's rows and mask permuted, values N(0, 10), through
    the plain version. Returns its buffer."""
    from repro_torch.kernels import ref
    buf, st = gk_stack(n, kind.m, b.dev)
    st["n"].copy_(torch.randint(1000, 10000, (n,), generator=b.gen,
                                device=b.dev).to(torch.float32))
    st["values"].copy_(torch.sort(torch.randn(
        n, kind.m, generator=b.gen, device=b.dev) * 10, dim=1).values)
    for _ in range(GK_IDLE_BATCHES):
        perm = torch.randperm(b.t, generator=b.gen, device=b.dev)
        vals = torch.randn(b.t, generator=b.gen, device=b.dev) * 10
        ref.gk_requantize_update(st["values"], st["n"], b.rows[perm], vals,
                                 b.mask[perm], src, m=kind.m)
    return buf


def gk_unsorted_state(idle: torch.Tensor, n: int, m: int, gen):
    """The idle state with every other row's values shuffled out of order
    (their counts kept): half the rows without tuples take the sort.
    Returns its buffer."""
    buf = idle.clone()
    values = buf[:n * m].view(n, m)
    perm = torch.argsort(torch.rand(n // 2, m, generator=gen,
                                    device=buf.device), dim=1)
    values[::2] = torch.gather(values[::2], 1, perm)
    return buf


def phase2_gk(b, n: int, results: dict) -> None:
    """GK's requantize (no TPU counterpart) at the reference's defaults
    (eps 0.01: m = 400) on phase 2's batch with continuous values (N(0,
    10), not the batch's four integer weights, so that rows merge many
    distinct values): n rows routed as the batch's probe gives them plus
    one data-source row (row n // 2, as the engine allocates one), every
    row requantized. Rows given
    (``gk_requantize``) from empty rows, (``gk_requantize@idle``) from
    the state GK_IDLE_BATCHES batches leave on counts in the thousands,
    where nearly every row takes no tuple and requantizes anyway, and
    (``gk_requantize@unsorted``) from that state with half the rows out
    of order (those without tuples take the sort); the probe fused in
    (``gk_probe_requantize``) from empty rows. Each held
    byte for byte (values and n) against its plain version on the card
    (the fused entry's: the plain probe, then the plain update; its
    ``max_abs_err`` taken from the same tensors, :func:`bits_err`) and
    across two kernel runs; timed from its starting state restored
    before every call: CUDA events (``ms``, host enqueue included),
    events around the call queued behind a spin (``device_ms``) and the
    profiler's split by kernel; the plain version from its one checked
    call. No one PyTorch call computes it: no library time. The bound is
    the larger of the bytes (the stack read and written once, the batch
    and the data-source row once, the fused entry's stream ids and the
    table slots its probes read) and the searches' shared-memory reads (m
    x ceil(log2(m + T + 1)) a row, 32 a cycle an SM at the card's top SM
    clock)."""
    from repro_torch import core
    from repro_torch.kernels import gk_requantize, probe, ref

    t, dev = b.t, b.dev
    kind = core.GKQuantiles()
    m = kind.m
    src_row = n // 2
    src = torch.tensor([src_row], dtype=torch.int64, device=dev)
    gvals = torch.randn(t, generator=b.gen, device=dev) * 10
    tail = (gvals, b.mask, src)
    table = (b.klo, b.khi, b.trows, b.slo, b.shi)
    leaves = lambda st: (st["values"], st["n"])
    rows_given = (
        lambda st: gk_requantize.gk_requantize_update(
            *leaves(st), b.rows, *tail, m=m),
        lambda st: ref.gk_requantize_update(*leaves(st), b.rows, *tail,
                                            m=m),
        t * 4)
    entries = {
        "gk_requantize": rows_given + ("empty",),
        "gk_requantize@idle": rows_given + ("idle",),
        "gk_requantize@unsorted": rows_given + ("unsorted",),
        "gk_probe_requantize": (
            lambda st: gk_requantize.gk_probe_requantize_update(
                *leaves(st), *table, *tail, n_probe=b.n_probe, m=m),
            lambda st: ref.gk_requantize_update(
                *leaves(st), probe.probe_rows(*table, n_probe=b.n_probe),
                *tail, m=m),
            t * 8 + TABLE_B * probed_slots(b, b.mask), "empty")}
    steps = (m + t).bit_length()
    _, mhz = chain_floor_ms(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    search_ms = n * m * steps / (32 * sms * mhz * 1e6) * 1e3
    own = torch.bincount(b.rows[b.mask & (b.rows >= 0)].long(), minlength=n)
    own[src_row] = int(b.mask.sum())
    took = int((own > 0).sum())
    starts = {"empty": gk_stack(n, m, dev)[0],
              "idle": gk_idle_state(kind, b, n, src)}
    starts["unsorted"] = gk_unsorted_state(starts["idle"], n, m, b.gen)
    for name, (kernel, plain, rows_b, start) in entries.items():
        buf0 = starts[start]
        runs = []
        for _ in range(2):
            buf, st = gk_stack(n, m, dev)
            buf.copy_(buf0)
            kernel(st)
            runs.append((buf, st))
        torch.cuda.synchronize()
        require(same_bytes(runs[0][0], runs[1][0]),
                f"{name}: two kernel runs differ byte-wise")
        kbuf, kst = runs[0]
        del runs
        pbuf, pst = gk_stack(n, m, dev)
        pbuf.copy_(buf0)
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        plain(pst)
        z.record()
        z.synchronize()
        pms = a.elapsed_time(z)
        require(same_bytes(kbuf, pbuf),
                f"{name}: kernel differs byte-wise from its plain version")
        err = max(bits_err(kst[k], pst[k]) for k in ("values", "n"))
        moved = int((kst["values"] != buf0[:n * m].view(n, m)).any(1).sum())
        del pbuf, pst
        restore = lambda: kbuf.copy_(buf0)
        kern = lambda: kernel(kst)
        kms = cuda_ms(kern, runs=STICKY_TIMING_RUNS, prep=restore)
        kdev = queued_device_ms(kern, restore)
        split = kernel_split(kern, restore, GK_SPLIT)
        # the stack read and written once; the batch's rows (or stream ids
        # and probed table slots), values and mask; the source row's index
        n_bytes = n * (m + 1) * 4 * 2 + rows_b + t * (4 + 1) + 8
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        bms = max(t_bytes, search_ms)
        by = "bytes" if t_bytes >= search_ms else "operations"
        results[name] = dict(
            max_abs_err=err, ms=kms, plain_ms=pms, library_ms=None,
            bound_ms=bms, bound_by=by, device_ms=kdev, plain_device_ms=None,
            library_device_ms=None, split_device_ms=split,
            start=f"{start} rows", rows_with_tuples=took, rows_moved=moved,
            search_floor_ms=search_ms,
            plain_timing="one call (CUDA events); its device time not "
                         "measured",
            device_timing="CUDA events around the call queued behind a "
                          "spin kernel (no host enqueue inside), median of 5",
            library="none: no one PyTorch call computes it")
        print(f"[phase2] {name} ({start} rows): m={m}, n={n} rows + "
              f"data-source row {src_row}, N(0, 10) values, exact match "
              f"(values and n byte for byte, max abs err {err}; two kernel "
              f"runs byte-identical); {took} rows took "
              f"tuples, {moved} rows' values moved; kernel {kms:.4f} ms "
              f"(device {kdev:.4f} ms; by kernel "
              f"{ {k: round(v, 4) for k, v in split.items()} }), plain "
              f"{pms:.1f} ms (one call), no library call; bound "
              f"{bms:.5f} ms ({by}: bytes {t_bytes:.5f} ms, {n_bytes} B; "
              f"searches {search_ms:.5f} ms, {steps} steps a target at 32 "
              f"reads a cycle on {sms} SMs, {mhz:.0f} MHz)", flush=True)
        del kern, restore, kbuf, kst
        free()
    del starts
    free()


def phase2(dev, seed: int, n: int, n_streams: int, t: int) -> dict:
    torch.cuda.reset_peak_memory_stats()
    b = phase2_batch(dev, seed, n_streams, t)
    results: dict = {}
    for part in (phase2_countmin, phase2_ams, phase2_hll, phase2_bloom,
                 phase2_fm, phase2_rhp, phase2_dft, phase2_corr,
                 phase2_flash, phase2_lossy, phase2_reservoir,
                 phase2_sticky, phase2_gk):
        part(b, n, results)
        free()
    peak_gib("phase2")
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path through SDE.handle, held against a plain replay
# ---------------------------------------------------------------------------
# JSON name -> (wrapper module, wrapper, source, TPU kernel it replaces);
# a "@fresh" row reads the wrapper's one-row launches given no signs
# (data-source folds), an "@ams" row its signed launches on a stack
# (AMS's), "@fresh@ams" its signed one-row launches (AMS's folds), and
# "@k1000" the launches on tables of 1,000 slots, "@cap4096" those on
# tables of 4,096; a main row counts all
LOSSY_COUNTERPART = "src/repro/core/lossy.py:65"
SAMPLER_COUNTERPART = "src/repro/core/sampler.py:55"
STICKY_COUNTERPART = "src/repro/core/sticky.py:86"
GK_COUNTERPART = "src/repro/core/gk.py:51"
ENTRY_POINTS = {
    "onehot_scatter_add": ("onehot_matmul", "onehot_scatter_add",
                           "countmin_scatter.cu", "onehot_matmul.py:61"),
    "onehot_scatter_add@fresh": ("onehot_matmul", "onehot_scatter_add",
                                 "countmin_scatter.cu", "onehot_matmul.py:61"),
    "onehot_scatter_add@ams": ("onehot_matmul", "onehot_scatter_add",
                               "countmin_scatter.cu", "onehot_matmul.py:61"),
    "onehot_scatter_add@fresh@ams": ("onehot_matmul", "onehot_scatter_add",
                                     "countmin_scatter.cu",
                                     "onehot_matmul.py:61"),
    "onehot_probe_scatter": ("onehot_matmul", "onehot_probe_scatter",
                             "countmin_scatter.cu", "onehot_matmul.py:139"),
    "onehot_probe_scatter@ams": ("onehot_matmul", "onehot_probe_scatter",
                                 "countmin_scatter.cu",
                                 "onehot_matmul.py:139"),
    "hll_max_update": ("hll_max", "hll_max_update", "bitset_or.cu",
                       "hll_max.py:52"),
    "hll_max_update@fresh": ("hll_max", "hll_max_update", "bitset_or.cu",
                             "hll_max.py:52"),
    "hll_probe_max_update": ("hll_max", "hll_probe_max_update",
                             "bitset_or.cu", "hll_max.py:116"),
    "bitset_max_update": ("bitset_or", "bitset_max_update", "bitset_or.cu",
                          "bitset_or.py:66"),
    "bitset_max_update@fresh": ("bitset_or", "bitset_max_update",
                                "bitset_or.cu", "bitset_or.py:66"),
    "bitset_probe_max_update": ("bitset_or", "bitset_probe_max_update",
                                "bitset_or.cu", "bitset_or.py:120"),
    "fm_bit_update": ("fm_bitmap", "fm_bit_update", "bitset_or.cu",
                      "fm_bitmap.py:38"),
    "fm_bit_update@fresh": ("fm_bitmap", "fm_bit_update", "bitset_or.cu",
                            "fm_bitmap.py:38"),
    "fm_probe_bit_update": ("fm_bitmap", "fm_probe_bit_update",
                            "bitset_or.cu", "fm_bitmap.py:52"),
    "rhp_project_update": ("rhp_project", "rhp_project_update",
                           "rhp_project.cu", "rhp_project.py:57"),
    "rhp_probe_update": ("rhp_project", "rhp_probe_update", "rhp_project.cu",
                         "rhp_project.py:111"),
    "sliding_dft_step": ("sliding_dft", "sliding_dft_step", "sliding_dft.cu",
                         "sliding_dft.py:35"),
    "pairwise_corr": ("pairwise_corr", "pairwise_corr", "pairwise_corr.cu",
                      "pairwise_corr.py:31"),
    "flash_attention": ("flash_attention", "flash_attention",
                        "flash_attention.cu", "flash_attention.py:68"),
    "flash_attention@d64": ("flash_attention", "flash_attention",
                            "flash_attention.cu", "flash_attention.py:68"),
    "flash_attention@d256": ("flash_attention", "flash_attention",
                             "flash_attention.cu", "flash_attention.py:68"),
    # no TPU kernel: its JAX counterpart is LossyCounting.add_batch under
    # the vmap of batched.stacked_update (src/repro/core/batched.py:92)
    "lossy_scan": ("lossy_scan", "lossy_scan_update", "lossy_scan.cu",
                   LOSSY_COUNTERPART),
    "lossy_scan@k1000": ("lossy_scan", "lossy_scan_update", "lossy_scan.cu",
                         LOSSY_COUNTERPART),
    # no TPU kernel: its JAX counterpart is ReservoirSampler.add_batch
    # under the vmap of batched.stacked_update
    "reservoir_scan": ("reservoir_scan", "reservoir_scan_update",
                       "reservoir_scan.cu", SAMPLER_COUNTERPART),
    "reservoir_probe_scan": ("reservoir_scan", "reservoir_probe_scan_update",
                             "reservoir_scan.cu", SAMPLER_COUNTERPART),
    # no TPU kernel: its JAX counterpart is StickySampling.add_batch under
    # the vmap of batched.stacked_update
    "sticky_scan": ("sticky_scan", "sticky_scan_update", "sticky_scan.cu",
                    STICKY_COUNTERPART),
    "sticky_scan@cap4096": ("sticky_scan", "sticky_scan_update",
                            "sticky_scan.cu", STICKY_COUNTERPART),
    "sticky_probe_scan": ("sticky_scan", "sticky_probe_scan_update",
                          "sticky_scan.cu", STICKY_COUNTERPART),
    # no TPU kernel: its JAX counterpart is GKQuantiles.add_batch under the
    # vmap of batched.stacked_update, every row of the stack each batch;
    # "@idle" is phase 2's start on counts in the thousands, "@unsorted"
    # that start with half its rows out of order (launches: all the
    # rows-given entry's)
    "gk_requantize": ("gk_requantize", "gk_requantize_update",
                      "gk_requantize.cu", GK_COUNTERPART),
    "gk_requantize@idle": ("gk_requantize", "gk_requantize_update",
                           "gk_requantize.cu", GK_COUNTERPART),
    "gk_requantize@unsorted": ("gk_requantize", "gk_requantize_update",
                               "gk_requantize.cu", GK_COUNTERPART),
    "gk_probe_requantize": ("gk_requantize", "gk_probe_requantize_update",
                            "gk_requantize.cu", GK_COUNTERPART),
}


def wrappers() -> dict:
    import importlib
    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), fn)
        for name, (mod, fn, _, _) in ENTRY_POINTS.items()}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for count in ("one_row_launches", "signed_launches",
                      "signed_one_row_launches"):
            if hasattr(fn, count):
                setattr(fn, count, 0)
        if hasattr(fn, "long_runs"):
            fn.long_runs.reset()
        if hasattr(fn, "launches_by_k"):
            fn.launches_by_k.clear()
        if hasattr(fn, "launches_by_capacity"):
            fn.launches_by_capacity.clear()


def launches_of(name: str, fn) -> int:
    if name.endswith("@k1000"):
        return fn.launches_by_k[1000]
    if name.endswith("@cap4096"):
        return fn.launches_by_capacity[4096]
    ams_folds = getattr(fn, "signed_one_row_launches", 0)
    if name.endswith("@fresh@ams"):
        return ams_folds
    if name.endswith("@fresh"):
        return fn.one_row_launches - ams_folds
    if name.endswith("@ams"):
        return fn.signed_launches - ams_folds
    return fn.launches


def read_launches() -> dict:
    return {name: launches_of(name, fn) for name, fn in wrappers().items()}


def last_writer(rows: np.ndarray, sids: np.ndarray, vals: np.ndarray,
                capacity: int):
    """For each row of a time-series stack: whether the batch routes a
    tuple to it, and the value of its LAST routed tuple (in numpy, apart
    from the engine's scatter-max)."""
    ok = (rows >= 0) & (sids >= 0)
    last = np.full(capacity, -1, np.int64)
    np.maximum.at(last, rows[ok], np.nonzero(ok)[0])
    hit = last >= 0
    return hit, np.where(hit, vals[np.maximum(last, 0)], 0).astype(np.float32)


def probe_host(stack, sids: np.ndarray, dev) -> np.ndarray:
    """The plain probe's rows for a batch of stream ids, on the host."""
    from repro_torch.kernels import probe
    from repro_torch.service import routing
    klo, khi, trows = stack.device_table()
    lo, hi = routing.split64(sids.astype(np.int64))
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return probe.probe_rows(klo, khi, trows, dt(lo.view(np.int32)),
                            dt(hi.view(np.int32)),
                            n_probe=stack.n_probe).cpu().numpy()


def replay_timeseries(stack, batches, dev):
    """A plain replay of a time-series stack: the plain probe, the last
    routed value per row, and the kind's plain tick (``DFT.step``)."""
    from repro_torch.core import batched
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    replay = batched.stacked_init(stack.kind, stack.capacity, dev)
    for sids, vals in batches:
        hit, per_row = last_writer(probe_host(stack, sids, dev), sids, vals,
                                   stack.capacity)
        stack.kind.step(replay, dt(per_row), dt(hit))
    return replay


def same_leaves(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        same_bytes(got[k], want[k]) for k in got)


class ScanProbes:
    """Counts, while entered, the plain probes (``ops.route_probe``) that
    the engine runs inside the stack updates of the kind ``kind_type``
    (the chain sampler, Sticky Sampling), keyed by whether the batch fused
    the probe (``SDE_FUSED_PROBE``): it wraps the engine's ``_update`` and
    ``ops.route_probe`` and restores them on exit."""

    def __init__(self, kind_type) -> None:
        self.kind_type = kind_type

    def __enter__(self) -> dict:
        from repro_torch.kernels import ops
        from repro_torch.service import engine
        counts = {"fused": 0, "unfused": 0}
        inside = [False]
        probe0, update0 = ops.route_probe, engine._update

        def route_probe(*args, **kwargs):
            if inside[0]:
                counts["fused" if ops.probe_fusion_enabled()
                       else "unfused"] += 1
            return probe0(*args, **kwargs)

        def update(kind, *args, **kwargs):
            inside[0] = isinstance(kind, self.kind_type)
            try:
                return update0(kind, *args, **kwargs)
            finally:
                inside[0] = False

        ops.route_probe, engine._update = route_probe, update
        self._undo = lambda: (setattr(ops, "route_probe", probe0),
                              setattr(engine, "_update", update0))
        return counts

    def __exit__(self, *exc) -> None:
        self._undo()


def profile_batches(sde, batches, first: int) -> None:
    """Ingest ``batches`` under torch.profiler; print wall and device-busy
    ms per batch, the idle share and the top 10 device kernels; and the
    Sticky walk activities the profiler kept against the sticky-scan
    launches the window made, by capacity (``launches_by_capacity``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import sticky_scan
    entries = (sticky_scan.sticky_scan_update,
               sticky_scan.sticky_probe_scan_update)

    def sticky_launches() -> collections.Counter:
        out = collections.Counter()
        for fn in entries:
            out.update(fn.launches_by_capacity)
        return out

    launched = sticky_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (sids, vals) in enumerate(batches):
            os.environ["SDE_FUSED_PROBE"] = "1" if i % 2 == 0 else "0"
            r = sde.handle({"type": "ingest", "request_id": f"p{first + i}",
                            "stream_ids": sids.tolist(),
                            "values": vals.tolist()})
            require(r.ok, f"profiled ingest failed: {r.error}")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    nb = len(batches)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    by_name: dict = {}
    for e in dev_events:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_ms = busy / 1e3
    print(f"[phase3] profiled {nb} batches (torch.profiler, fused then "
          f"unfused): {wall_ms / nb:.4f} ms wall per batch, device busy "
          f"{busy_ms / nb:.4f} ms per batch, idle share "
          f"{1 - busy_ms / wall_ms:.4f}, {len(dev_events) / nb:.1f} device "
          f"activities per batch", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (tot, cnt) in top:
        print(f"[phase3]   {tot / 1e3 / nb:.4f} ms/batch in {cnt / nb:g} "
              f"launches/batch: {name[:110]}", flush=True)
    require(dev_events, "torch.profiler recorded no device activity")
    launched = sticky_launches() - launched
    walks = [e for e in dev_events if "sticky_walk_kernel<" in e.name]
    by_warps = collections.Counter(
        e.name.split("sticky_walk_kernel<")[1].split(">")[0] for e in walks)
    walk_ms = sum(e.time_range.elapsed_us() for e in walks) / 1e3
    print(f"[phase3] Sticky walks: the profiler kept {len(walks)} walk "
          f"activities ({dict(by_warps)} by the kernel's warps a block) of "
          f"{sum(launched.values())} sticky-scan launches ({dict(launched)} "
          f"by capacity), {walk_ms / nb:.4f} ms a batch; device busy is the "
          f"union of every kept activity, so it holds these "
          f"{len(walks)}", flush=True)
    gk = [e for e in dev_events
          if any(k in e.name for k in GK_SPLIT if k.startswith("gk_"))]
    gk_ms = sum(e.time_range.elapsed_us() for e in gk) / 1e3
    print(f"[phase3] GK requantize: {len(gk) / nb:g} activities a batch of "
          f"its key, bounds, warp, small-row and big-row kernels, "
          f"{gk_ms / nb:.4f} "
          f"ms a batch, {gk_ms / busy_ms:.4f} of device busy (its row sort "
          f"shares its kernels' names with the other row sorts and is not "
          f"in it)", flush=True)


def check_dft_stack(sde, stack, batches, answers, dev) -> None:
    """A DFT stack equals its plain replay byte for byte in all six
    leaves, its data-source rows stayed at init, and its answers among
    ``answers`` ((synopsis id, answer) pairs) equal the replay's."""
    from repro_torch.core import batched
    name = f"DFT(window={stack.kind.window})"
    replay = replay_timeseries(stack, batches, dev)
    require(same_leaves(stack.state, replay),
            f"{name} engine state differs byte-wise from the plain replay")
    init = stack.kind.init(dev)
    for row in stack.source_rows:
        require(same_leaves(batched.stacked_row(stack.state, row), init),
                f"{name}: a data-source row left init")
    ticked = int((stack.state["count"] > 0).sum())
    mine = [(sde.entries[sid].row, a) for sid, a in answers
            if sde.entries[sid].kind_key == stack.kind]
    if mine:
        want = batched.stacked_estimate(
            stack.kind, replay,
            torch.tensor([row for row, _ in mine], dtype=torch.int32,
                         device=dev))
        for i, (_, got) in enumerate(mine):
            for key in ("bucket", "coeffs", "coords"):
                w = want[key][i].cpu().numpy()
                require(got[key].dtype == w.dtype
                        and got[key].tobytes() == w.tobytes(),
                        f"{name} answer {i} ({key}) differs from the plain "
                        f"replay's")
    print(f"[phase3] {name} stack {stack.capacity} x {stack.row_bytes()} B "
          f"equals the plain replay byte for byte in all six leaves "
          f"({ticked} streams ticked); {len(stack.source_rows)} data-source "
          f"rows stayed at init; {len(mine)} answers equal the replay's",
          flush=True)


def check_lossy_answers(sde, answers, q_streams, totals, heavy, fed_items,
                        fed_totals, fed_w, dev) -> None:
    """Lossy Counting after every batch: each per-stream answer for its
    own folded id equals its stream's exact total (a per-stream row only
    ever sees its own item); each data-source table's counts sum to the
    exact weight W it was fed; every item heavier than W / k is tracked
    with an estimate in [true, true + W / k] (Space-Saving's guarantee)."""
    got = np.asarray([float(v[0]) for v in answers["lossy"]])
    require(np.array_equal(got, totals),
            "per-stream Lossy answers differ from the exact stream totals")
    for (sid, items), est in zip(heavy.items(), answers["lossy-src"]):
        state = sde.state_of(sid)
        k = state["keys"].shape[0]
        total = float(state["counts"].double().sum())
        require(total == fed_w, f"{sid}: counts sum to {total}, not the "
                                f"{fed_w} it was fed")
        true = fed_totals[np.searchsorted(fed_items, items)]
        est = np.asarray(est, np.float64)
        slack = est - true
        require(len(items) > 0 and bool((slack >= 0).all())
                and bool((slack <= fed_w / k).all()),
                f"{sid}: an item above W/k is untracked or off by more than "
                f"W/k (slack {slack.min()}..{slack.max()}, W/k {fed_w / k})")
        print(f"[phase3] {sid} (k={k}): counts sum to the exact W={fed_w:.0f};"
              f" all {len(items)} items above W/k={fed_w / k:.1f} tracked, "
              f"over-count {slack.min():.0f}..{slack.max():.0f}", flush=True)
    print(f"[phase3] exact: {len(got)} per-stream Lossy answers equal their "
          f"streams' totals", flush=True)


def check_scan_stack(stack, snap, prefix, dev) -> None:
    """A scan-path stack (Lossy Counting, the sampler, Sticky Sampling,
    GK), as it stood after the first ``len(prefix)`` batches (``snap``),
    equals a replay of those batches through the plain version on the
    card (the plain probe, then ``ref.lossy_scan_update``,
    ``ref.reservoir_scan_update``, ``ref.sticky_scan_update`` or
    ``ref.gk_requantize_update``: torch ops a step or a write, or walks on
    the host, so only a prefix fits the run's time) byte for byte in every
    leaf."""
    from repro_torch import core
    from repro_torch.core import batched
    from repro_torch.kernels import probe, ref
    from repro_torch.service import routing
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    kind = stack.kind
    replay = batched.stacked_init(kind, stack.capacity, dev)
    if isinstance(kind, core.LossyCounting):
        name = f"LossyCounting(eps={kind.eps})"
        plain = lambda *batch: ref.lossy_scan_update(
            replay["keys"], replay["counts"], replay["error"], *batch)
    elif isinstance(kind, core.StickySampling):
        name = f"StickySampling(capacity={kind.capacity})"
        plain = lambda rows, items, vals, mask, src: ref.sticky_scan_update(
            replay["keys"], replay["counts"], replay["n_seen"],
            replay["epoch"], rows, items, mask, src, **kind.params())
    elif isinstance(kind, core.GKQuantiles):
        name = f"GKQuantiles(m={kind.m})"
        plain = lambda rows, items, vals, mask, src: ref.gk_requantize_update(
            replay["values"], replay["n"], rows, vals, mask, src, m=kind.m)
    else:
        name = f"ReservoirSampler(sample_size={kind.sample_size})"
        plain = lambda *batch: ref.reservoir_scan_update(
            replay["values"], replay["items"], replay["n_seen"], *batch,
            seed=kind.seed)
    klo, khi, trows = stack.device_table()
    t0 = time.perf_counter()
    for sids, vals in prefix:
        sid64 = sids.astype(np.int64)
        lo, hi = routing.split64(sid64)
        rows = probe.probe_rows(klo, khi, trows, dt(lo.view(np.int32)),
                                dt(hi.view(np.int32)), n_probe=stack.n_probe)
        plain(rows, dt(routing.fold64(sid64).view(np.int32)), dt(vals),
              dt(sid64 >= 0), stack.source_rows_idx())
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    require(same_leaves(snap, replay),
            f"{name} engine state differs byte-wise from the plain replay "
            f"of its first {len(prefix)} batches")
    print(f"[phase3] {name} stack {stack.capacity} x {stack.row_bytes()} B "
          f"after the first {len(prefix)} batches equals their plain replay "
          f"byte for byte in {', '.join(sorted(snap))} ({replay_s:.1f} s of "
          f"replay)", flush=True)


def check_sampler(sde, batches, counts, answers, q_streams, pop) -> None:
    """The chain sampler after every batch: each per-stream row's n_seen
    equals its stream's masked, routed tuples so far and each data-source
    row's every masked tuple so far (``counts``: n_seen after each of the
    unprofiled batches, then after the last); no other row moved. After
    the last batch every valid (item, value) of a per-stream row is one of
    its stream's ingested pairs (its item that stream's folded id), and of
    a source row one of all ingested pairs; the query_many answers
    (``answers``: the q_streams' rows, then src-rs and cq-rs) equal the
    stack's rows, items as uint32; cq-rs equals src-rs."""
    from repro_torch import core
    from repro_torch.service import routing
    kind = core.make_kind("chain_sampler")
    stack = sde.stacks[kind]
    s = kind.sample_size
    rows = np.asarray([sde.entries[f"rs/{int(i)}"].row for i in pop])
    src_rows = [sde.entries[sid].row for sid in ("src-rs", "cq-rs")]
    want = np.zeros(stack.capacity, np.int64)
    pairs, spairs, fed = [], [], 0
    for b, (sids, vals) in enumerate(batches):
        at = np.minimum(np.searchsorted(pop, sids), len(pop) - 1)
        own = (pop[at] == sids) & (sids >= 0)
        np.add.at(want, rows[at[own]], 1)
        fed += int((sids >= 0).sum())
        want[src_rows] = fed
        bits = vals.astype(np.float32).view(np.uint32).astype(np.int64)
        pairs.append((at[own].astype(np.int64) << 32) | bits[own])
        items = routing.fold64(sids[sids >= 0]).astype(np.int64)
        spairs.append((items << 32) | bits[sids >= 0])
        if b < len(counts) - 1 or b == len(batches) - 1:
            got = counts[min(b, len(counts) - 1)].cpu().numpy()
            require(np.array_equal(got, want),
                    f"sampler n_seen after batch {b} differs from the "
                    f"masked tuples each row was fed")
    state = {k: v.cpu().numpy() for k, v in stack.state.items()}
    n_seen = state["n_seen"]
    k = np.minimum(n_seen, s)
    valid = np.arange(s)[None, :] < k[:, None]
    items = state["items"].view(np.uint32).astype(np.int64)
    bits = state["values"].view(np.uint32).astype(np.int64)
    own_items = routing.fold64(pop).astype(np.int64)
    r_valid = valid[rows]
    stream = np.broadcast_to(np.arange(len(pop))[:, None], r_valid.shape)
    require(bool((items[rows] == own_items[:, None])[r_valid].all()),
            "a per-stream sample holds another stream's item")
    require(bool(np.isin(((stream.astype(np.int64) << 32)
                          | bits[rows])[r_valid],
                         np.concatenate(pairs)).all()),
            "a per-stream sample holds a value its stream was not fed")
    src_keys = ((items[src_rows] << 32) | bits[src_rows])[valid[src_rows]]
    require(src_keys.size == 2 * s and bool(np.isin(
        src_keys, np.concatenate(spairs)).all()),
            "a data-source sample holds a pair that was not ingested")
    q_rows = [sde.entries[f"rs/{int(i)}"].row for i in q_streams] + src_rows
    require(len(answers) == len(q_rows), "sampler answers missing")
    for a, row in zip(answers, q_rows):
        require(a["items"].dtype == np.uint32
                and np.array_equal(a["items"], items[row])
                and a["values"].tobytes() == state["values"][row].tobytes()
                and np.array_equal(a["valid"], valid[row]),
                f"a sampler answer differs from its row {row} of the stack")
    require(all(np.array_equal(answers[-1][key], answers[-2][key])
                for key in ("items", "values", "valid")),
            "cq-rs (a data-source row too) differs from src-rs")
    print(f"[phase3] sampler: n_seen of every row equals its fed tuples "
          f"after each of {len(batches)} batches (per-stream up to "
          f"{int(want[rows].max())}, source {fed}); every valid per-stream "
          f"(item, value) is its stream's ({int(r_valid.sum())} slots), "
          f"every source one ingested ({src_keys.size}); {len(answers)} "
          f"query_many answers equal the stack's rows, items uint32 (max "
          f"{int(items[q_rows].max())})", flush=True)


def check_sticky(sde, batches, counts, answers, q_streams, pop,
                 heavy) -> None:
    """Sticky Sampling after every batch: each row's n_seen equals its fed
    tuples (a per-stream row its stream's masked, routed tuples, a source
    row every masked tuple; ``counts``: (n_seen, epoch) of both stacks
    after each unprofiled batch, then after the last), and its epoch is
    ``want_epoch(n_seen + 1)`` (the check the step after its last tuple
    took), or ``want_epoch(n_seen)`` for a row whose last tuple was its
    batch's last (that check falls on the next batch's first step, a bump
    pending where the two differ). After the last batch each per-stream
    answer for its own folded id equals its stream's fed count while that
    is below 2t = 9,216 (no bump yet: every tuple counted). The share of
    the items above support x N each data-source table tracks (``heavy``:
    their answers last in ``answers``) is printed, not gated."""
    from repro_torch import core
    from repro_torch.core import sticky
    kinds = {sid: core.make_kind("sticky_sampling", **params)
             for sid, params in (("src-sticky", STICKY_PARAMS),
                                 ("src-sticky-cap4096",
                                  STICKY_CAP4096_PARAMS))}
    stacks = {sid: sde.stacks[kd] for sid, kd in kinds.items()}
    rows = np.asarray([sde.entries[f"ss/{int(i)}"].row for i in pop])
    src = {sid: sde.entries[sid].row for sid in kinds}
    want = {sid: np.zeros(st.capacity, np.int64)
            for sid, st in stacks.items()}
    fed, pending = 0, 0
    n_checks = len(counts)
    for b, (sids, _) in enumerate(batches):
        at = np.minimum(np.searchsorted(pop, sids), len(pop) - 1)
        own = (pop[at] == sids) & (sids >= 0)
        np.add.at(want["src-sticky"], rows[at[own]], 1)
        fed += int((sids >= 0).sum())
        for sid in kinds:
            want[sid][src[sid]] = fed
        if not (b < n_checks - 1 or b == len(batches) - 1):
            continue
        last = set()               # rows whose last tuple is the batch's
        if sids[-1] >= 0:
            last = {("src-sticky", src["src-sticky"]),
                    ("src-sticky-cap4096", src["src-sticky-cap4096"])}
            if own[-1]:
                last.add(("src-sticky", int(rows[at[-1]])))
        for sid, kd in kinds.items():
            n_seen, epoch = (x.cpu().numpy()
                             for x in counts[min(b, n_checks - 1)][sid])
            require(np.array_equal(n_seen, want[sid]),
                    f"{sid}'s stack: n_seen after batch {b} differs from "
                    f"the masked tuples each row was fed")
            t_kind = 16 * kd.capacity
            nxt = sticky.want_of(torch.from_numpy(n_seen + 1), t_kind).numpy()
            now = sticky.want_of(torch.from_numpy(n_seen), t_kind).numpy()
            ok = epoch == nxt
            for s_id, r in last:
                if s_id == sid:
                    ok[r] = epoch[r] == now[r]
                    pending += int(now[r] < nxt[r])
            require(bool(ok.all()),
                    f"{sid}'s stack: an epoch after batch {b} is not the one "
                    f"its count asks for (rows {np.nonzero(~ok)[0][:5]})")
    n_fed = want["src-sticky"][rows]
    q_rows = [sde.entries[f"ss/{int(i)}"].row for i in q_streams]
    got = np.asarray([float(a[0]) for a in answers[:len(q_streams)]])
    fed_q = want["src-sticky"][q_rows]
    below = fed_q < 2 * 16 * kinds["src-sticky"].capacity
    require(np.array_equal(got[below], fed_q[below].astype(np.float64)),
            "a per-stream Sticky answer below 2t differs from its stream's "
            "fed count")
    shares = []
    for (sid, items), est in zip(heavy.items(), answers[len(q_streams):]):
        shares.append(f"{sid} {int((np.asarray(est) > 0).sum())} of "
                      f"{len(items)}")
    print(f"[phase3] Sticky: n_seen of every row equals its fed tuples and "
          f"its epoch the one its count asks for after each of "
          f"{len(batches)} batches (per-stream up to {int(n_fed.max())}, "
          f"sources {fed}; {pending} bumps pending on a next batch's first "
          f"step); {int(below.sum())} of {len(q_streams)} per-stream answers "
          f"below 2t equal their fed counts exactly; items above support x "
          f"N tracked (not gated): {', '.join(shares)}", flush=True)


def check_gk(sde, batches, answers, adhoc_src, q_streams) -> None:
    """GK after the last batch: each per-stream answer (``qs`` [0.5])
    equals its row's value at index m // 2 in the stack; the data-source
    answers at GK_QS, in query_many and adhoc alike, lie within the
    reference's rank bound 6 eps + 1 / N (``tests/test_properties.py``) of
    the exact quantiles of the N masked tuples ingested (every tuple with
    an id >= 0, routed or not: four integer values, so this check tells
    few wrong answers apart; phase 3c makes it on continuous values); the
    continuous GK, a data-source row too,
    holds src-gk's state byte for byte and emitted once a batch, its last
    emission its query_many answer."""
    kind = sde.entries["src-gk"].kind_key
    m = kind.m
    stack = sde.stacks[kind]
    rows = torch.tensor([sde.entries[f"gk/{int(s)}"].row for s in q_streams],
                        device=stack.state["values"].device)
    want = stack.state["values"][rows, m // 2].cpu().numpy()
    got = np.asarray([np.asarray(a)[0] for a in answers[:len(q_streams)]],
                     np.float32)
    require(got.tobytes() == want.tobytes(),
            "a per-stream GK answer differs from its row of the stack")
    data = np.concatenate([v[s >= 0] for s, v in batches]).astype(np.float32)
    tol = 6 * kind.eps + 1.0 / len(data)
    src_q = np.asarray(answers[len(q_streams)], np.float32)
    brackets = gk_rank_check(data, src_q, kind.eps, "src-gk")
    require(adhoc_src.ok and np.asarray(adhoc_src.value, np.float32).tobytes()
            == src_q.tobytes(), "src-gk's adhoc answer differs from its "
                                "query_many answer")
    require(same_leaves(sde.state_of("cq-gk"), sde.state_of("src-gk")),
            "the continuous GK (a data-source row) differs from src-gk")
    cq = [c.value for c in sde.continuous_out if c.synopsis_id == "cq-gk"]
    require(len(cq) == len(batches) and np.asarray(cq[-1]).tobytes()
            == np.asarray(answers[len(q_streams) + 1]).tobytes(),
            "the continuous GK did not emit once a batch, or its last "
            "emission differs from its query_many answer")
    print(f"[phase3] GK (m={m}): {len(q_streams)} per-stream medians equal "
          f"their rows of the stack; src-gk over N={len(data)} masked "
          f"tuples, (q, answer, rank below, rank at or below): {brackets}, "
          f"each within {tol:.6f} of q; cq-gk equals src-gk and emitted "
          f"{len(cq)} times", flush=True)


def phase3(dev, seed: int, n_streams: int, t: int, n_batches: int,
           n_queries: int, n_profiled: int = 2) -> dict:
    from repro_torch import core
    from repro_torch.core import batched
    from repro_torch.kernels import lossy_scan, probe, rhp_project
    from repro_torch.service import SDE, routing

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(seed + 1)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams, dtype=np.int64))
    cm_params = {"eps": 0.002, "delta": 0.01}
    dft_params = FIG6_DFT
    hll_params = {"rse": 0.03}
    bloom_params = {"n_elements": 1024, "fpr": 0.01}
    src_bloom_params = {"n_elements": SRC_BLOOM_ELEMENTS, "fpr": 0.01}
    batches = [make_batch(rng, pop, t) for _ in range(n_batches + n_profiled)]
    reset_launches()                         # counts of the main path only

    sde = SDE(device=dev)
    ids = [int(s) for s in pop]
    per_stream = dict(per_stream_of_source=True, stream_ids=ids)
    # AMS's 12 GiB stack first: its growth to 131,072 rows (old + fresh +
    # new, 24 GiB) then meets no other stack
    for sid, kind, params, extra in (
            ("ams", "ams", {}, per_stream),
            ("src-ams", "ams", {}, {}),
            ("cq-ams", "ams", {}, {"continuous": True}),
            ("cm", "countmin", cm_params, per_stream),
            ("hll", "hyperloglog", hll_params, per_stream),
            ("bloom", "bloom", bloom_params, per_stream),
            ("fm", "fm", {}, per_stream),
            ("src-cm", "countmin", cm_params, {}),
            ("src-hll", "hyperloglog", hll_params, {}),
            ("src-bloom", "bloom", src_bloom_params, {}),
            ("src-fm", "fm", {}, {}),
            ("cq-hll", "hyperloglog", hll_params, {"continuous": True}),
            ("cq-fm", "fm", {}, {"continuous": True}),
            ("rhp", "rhp", {}, per_stream),
            ("src-rhp", "rhp", {}, {}),
            ("dft", "dft", dft_params, per_stream),
            ("src-dft", "dft", dft_params, {}),
            ("cq-dft", "dft", {"window": 64, "n_coeffs": 8},
             {"stream_id": ids[0], "continuous": True}),
            ("lossy", "lossy_counting", LOSSY_PARAMS, per_stream),
            ("src-lossy", "lossy_counting", LOSSY_PARAMS, {}),
            ("src-lossy-k1000", "lossy_counting", LOSSY_K1000_PARAMS, {}),
            ("rs", "chain_sampler", {}, per_stream),
            ("src-rs", "chain_sampler", {}, {}),
            ("cq-rs", "chain_sampler", {}, {"continuous": True}),
            ("ss", "sticky_sampling", STICKY_PARAMS, per_stream),
            ("src-sticky", "sticky_sampling", STICKY_PARAMS, {}),
            ("src-sticky-cap4096", "sticky_sampling", STICKY_CAP4096_PARAMS,
             {}),
            ("gk", "gk_quantiles", {}, per_stream),
            ("src-gk", "gk_quantiles", {}, {}),
            ("cq-gk", "gk_quantiles", {}, {"continuous": True})):
        r = sde.handle({"type": "build", "request_id": f"b-{sid}",
                        "synopsis_id": sid, "kind": kind, "params": params,
                        **extra})
        require(r.ok, f"build {sid} failed: {r.error}")
    for kind, stack in sde.stacks.items():
        leaves = batched.tree_leaves(stack.state)
        print(f"[phase3] stack {type(kind).__name__} "
              f"{[tuple(x.shape) for x in leaves]} "
              f"({sum(x.numel() * 4 for x in leaves) / GIB:.3f} GiB)",
              flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_snap, sampler_counts, sticky_counts = {}, [], []
    sampler = sde.stacks[core.make_kind("chain_sampler")]
    sticky_stacks = {sid: sde.stacks[sde.entries[sid].kind_key]
                     for sid in ("src-sticky", "src-sticky-cap4096")}

    def sticky_now():                            # device copies, no sync
        return {sid: (st.state["n_seen"].clone(), st.state["epoch"].clone())
                for sid, st in sticky_stacks.items()}

    with ScanProbes(core.ReservoirSampler) as sampler_probes, \
            ScanProbes(core.StickySampling) as sticky_probes, \
            ScanProbes(core.GKQuantiles) as gk_probes:
        for b, (sids, vals) in enumerate(batches[:n_batches]):
            os.environ["SDE_FUSED_PROBE"] = "1" if b % 2 == 0 else "0"
            r = sde.handle({"type": "ingest", "request_id": f"i{b}",
                            "stream_ids": sids.tolist(),
                            "values": vals.tolist()})
            require(r.ok, f"ingest {b} failed: {r.error}")
            sampler_counts.append(sampler.state["n_seen"].clone())  # async
            sticky_counts.append(sticky_now())
            if b + 1 == LOSSY_REPLAY_BATCHES:   # the scan replay's prefix
                scan_snap = {kind: batched.tree_map(torch.clone, st.state)
                             for kind, st in sde.stacks.items()
                             if isinstance(kind, (core.LossyCounting,
                                                  core.ReservoirSampler,
                                                  core.StickySampling,
                                                  core.GKQuantiles))}
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        profile_batches(sde, batches[n_batches:], n_batches)
    os.environ.pop("SDE_FUSED_PROBE", None)
    sampler_counts.append(sampler.state["n_seen"].clone())
    sticky_counts.append(sticky_now())

    # exact answers: each per-stream CM row only ever sees its own item,
    # so its point estimate is the stream's exact total weight, and each
    # per-stream AMS row holds +-total at one counter a depth row, so its
    # L2 estimate is total * total in float32; each per-stream Bloom
    # holds its own id once that stream was ingested
    all_s = np.concatenate([s for s, _ in batches])
    all_v = np.concatenate([v for _, v in batches])
    uniq, inverse = np.unique(all_s, return_inverse=True)
    totals = np.bincount(inverse, weights=all_v)
    q_streams = pop[zipf_streams(rng, len(pop), n_queries)]
    ingested = np.intersect1d(pop, all_s)
    b_streams = rng.choice(ingested, size=n_queries, replace=False)
    items = np.unique(routing.fold64(all_s[all_s >= 0]))
    fresh_ids = rng.randint(0, 2**62, size=4 * n_queries, dtype=np.int64)
    fresh_ids = fresh_ids[~np.isin(routing.fold64(fresh_ids), items)]
    fresh_ids = fresh_ids[:n_queries]
    # the data-source Lossy tables were fed every tuple with an id >= 0,
    # routed or not; the items heavier than W / k of each table
    fed = all_s >= 0
    fed_items, by_item = np.unique(routing.fold64(all_s[fed]),
                                   return_inverse=True)
    fed_totals = np.bincount(by_item, weights=all_v[fed])
    fed_w = float(fed_totals.sum())
    heavy = {sid: fed_items[fed_totals > fed_w / core.make_kind(
        "lossy_counting", **params).k]
        for sid, params in (("src-lossy", LOSSY_PARAMS),
                            ("src-lossy-k1000", LOSSY_K1000_PARAMS))}
    # the items a data-source Sticky table should keep: those seen more
    # than support x N times of the N tuples it was fed
    fed_n = np.bincount(by_item)
    sticky_heavy = {sid: fed_items[fed_n > core.make_kind(
        "sticky_sampling", **params).support * fed_n.sum()]
        for sid, params in (("src-sticky", STICKY_PARAMS),
                            ("src-sticky-cap4096", STICKY_CAP4096_PARAMS))}
    # query_many's queries by kind, in order
    parts = {
        "cm": [{"synopsis_id": f"cm/{int(s)}", "query": {"items": [int(s)]}}
               for s in q_streams],
        "bloom": ([{"synopsis_id": f"bloom/{int(s)}",
                    "query": {"items": [int(s)]}} for s in b_streams]
                  + [{"synopsis_id": "src-bloom",
                      "query": {"items": items.tolist()}},
                     {"synopsis_id": "src-bloom",
                      "query": {"items": fresh_ids.tolist()}},
                     {"synopsis_id": f"bloom/{int(b_streams[0])}",
                      "query": {"items": fresh_ids.tolist()}}]),
        "rhp": ([{"synopsis_id": f"rhp/{int(s)}"} for s in q_streams]
                + [{"synopsis_id": "src-rhp"}]),
        "dft": ([{"synopsis_id": f"dft/{int(s)}"} for s in q_streams]
                + [{"synopsis_id": "src-dft"}]),
        "ams": [{"synopsis_id": f"ams/{int(s)}"} for s in q_streams],
        "lossy": [{"synopsis_id": f"lossy/{int(s)}",
                   "query": {"items": [int(s)]}} for s in q_streams],
        "lossy-src": [{"synopsis_id": sid,
                       "query": {"items": [int(x) for x in heavy[sid]]}}
                      for sid in heavy],
        "rs": ([{"synopsis_id": f"rs/{int(s)}"} for s in q_streams]
               + [{"synopsis_id": "src-rs"}, {"synopsis_id": "cq-rs"}]),
        "ss": ([{"synopsis_id": f"ss/{int(s)}", "query": {"items": [int(s)]}}
                for s in q_streams]
               + [{"synopsis_id": sid,
                   "query": {"items": [int(x) for x in items]}}
                  for sid, items in sticky_heavy.items()]),
        "gk": ([{"synopsis_id": f"gk/{int(s)}", "query": {"qs": [0.5]}}
                for s in q_streams]
               + [{"synopsis_id": "src-gk", "query": {"qs": GK_QS}},
                  {"synopsis_id": "cq-gk"}])}
    queries = [q for part in parts.values() for q in part]
    t0 = time.perf_counter()
    r = sde.handle({"type": "query_many", "request_id": "qm",
                    "queries": queries})
    adhoc = {sid: sde.handle({"type": "adhoc", "request_id": f"a-{sid}",
                              "synopsis_id": sid})
             for sid in ("src-hll", f"hll/{ids[0]}", "cq-hll", "src-fm",
                         f"fm/{ids[0]}", "cq-fm", "cq-dft", "src-ams",
                         "cq-ams")}
    adhoc_gk = sde.handle({"type": "adhoc", "request_id": "a-src-gk",
                           "synopsis_id": "src-gk", "query": {"qs": GK_QS}})
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    n_answered = len(queries) + len(adhoc) + 1
    require(r.ok, f"query_many failed: {r.error}")
    answers, at = {}, 0
    for key, part in parts.items():
        answers[key] = [q["value"] for q in r.value[at:at + len(part)]]
        at += len(part)
    got = np.asarray([float(v[0]) for v in answers["cm"]])
    pos = np.minimum(np.searchsorted(uniq, q_streams), len(uniq) - 1)
    want = np.where(uniq[pos] == q_streams, totals[pos], 0.0)
    require(np.array_equal(got, want), "CM answers differ from exact sums")
    ams_got = [np.asarray(v) for v in answers["ams"]]
    want32 = want.astype(np.float32)
    require(all(v.dtype == np.float32 and v.shape == () for v in ams_got)
            and np.stack(ams_got).tobytes() == (want32 * want32).tobytes(),
            "per-stream AMS answers differ from float32(total)**2")
    own = np.concatenate(answers["bloom"][:n_queries])
    require(own.dtype == bool and own.all(),
            "a per-stream Bloom misses its own ingested id")
    src_all, src_fp, own_fp = answers["bloom"][n_queries:]
    rhp_answers, dft_answers = answers["rhp"], answers["dft"]
    require(len(src_all) == len(items) and src_all.all(),
            "the data-source Bloom misses an ingested id")
    for sid, h in adhoc.items():
        require(h.ok and (sid == "cq-dft" or np.isfinite(float(h.value))),
                f"adhoc {sid} failed: {h.error}")
    require(int(adhoc["cq-dft"].value["coeffs"].shape[0]) == 8
            and np.isfinite(adhoc["cq-dft"].value["coeffs"]).all(),
            "the continuous DFT's adhoc answer is not 8 finite coefficients")
    n_distinct = len(items)
    rel = {sid: float(adhoc[sid].value) / n_distinct - 1.0
           for sid in ("src-hll", "cq-hll", "src-fm", "cq-fm")}
    print(f"[phase3] exact: {n_queries} CM totals; {n_queries} per-stream "
          f"Blooms hold their own id; src-bloom holds all {n_distinct} "
          f"ingested ids; false positives on {len(fresh_ids)} never-ingested"
          f" ids: src-bloom {int(src_fp.sum())}, bloom/<one stream> "
          f"{int(own_fp.sum())}; relative errors vs {n_distinct} distinct: "
          + ", ".join(f"{k} {v:+.4f}" for k, v in rel.items()), flush=True)
    require(abs(rel["src-hll"]) < 0.15, f"data-source HLL off by "
                                        f"{rel['src-hll']:.3f}")
    require(abs(rel["src-fm"]) < 0.35, f"data-source FM off by "
                                       f"{rel['src-fm']:.3f}")
    require(len(sde.continuous_out) == 6 * (n_batches + n_profiled),
            "one continuous response per continuous query and batch "
            "expected")
    # the data-source AMS against the exact F2 of the items it was fed
    # (every tuple with an id >= 0, routed or not, folded as ingest folds)
    f2 = float((fed_totals ** 2).sum())
    src_ams = np.asarray(adhoc["src-ams"].value)
    cq_ams = [c.value for c in sde.continuous_out
              if c.synopsis_id == "cq-ams"]
    rel_f2 = float(src_ams) / f2 - 1.0
    print(f"[phase3] exact: {n_queries} per-stream AMS answers equal "
          f"float32(total)**2; src-ams {float(src_ams)} against the exact "
          f"F2 {f2} of {len(fed_totals)} items: relative error "
          f"{rel_f2:+.4f}; cq-ams emitted {len(cq_ams)} times", flush=True)
    require(abs(rel_f2) < 0.15, f"data-source AMS off by {rel_f2:.3f}")
    require(len(cq_ams) == n_batches + n_profiled,
            "the continuous AMS did not emit once per batch")
    require(all(np.asarray(x).tobytes() == src_ams.tobytes()
                for x in (adhoc["cq-ams"].value, cq_ams[-1])),
            "the continuous AMS (a data-source row too) differs from "
            "src-ams")
    check_lossy_answers(sde, answers, q_streams, want, heavy, fed_items,
                        fed_totals, fed_w, dev)
    check_sampler(sde, batches, sampler_counts, answers["rs"], q_streams,
                  pop)
    check_sticky(sde, batches, sticky_counts, answers["ss"], q_streams, pop,
                 sticky_heavy)
    check_gk(sde, batches, answers["gk"], adhoc_gk, q_streams)
    cq_rs = [c.value for c in sde.continuous_out
             if c.synopsis_id == "cq-rs"]
    require(len(cq_rs) == n_batches + n_profiled
            and all(np.array_equal(cq_rs[-1][key], answers["rs"][-1][key])
                    for key in ("items", "values", "valid")),
            "the continuous sampler did not emit once a batch, or its last "
            "emission differs from its query_many answer")
    launches = read_launches()
    n_fused = len(range(0, n_batches, 2)) + len(range(0, n_profiled, 2))
    n_all = n_batches + n_profiled
    want_lossy = {"lossy_scan": 2 * n_all, "lossy_scan@k1000": n_all}
    require(all(launches[k] == v for k, v in want_lossy.items()),
            f"the Lossy scan's launches {[launches[k] for k in want_lossy]}, "
            f"not {list(want_lossy.values())} (one a batch on each of the "
            f"two Lossy stacks)")
    want_rs = {"reservoir_probe_scan": n_fused,
               "reservoir_scan": n_all - n_fused}
    require(all(launches[k] == v for k, v in want_rs.items()),
            f"the reservoir kernel's launches "
            f"{[launches[k] for k in want_rs]}, not "
            f"{list(want_rs.values())} (the fused entry once a fused batch, "
            f"the rows-given one once an unfused batch)")
    want_ss = {"sticky_probe_scan": 2 * n_fused,
               "sticky_scan": 2 * (n_all - n_fused),
               "sticky_scan@cap4096": n_all - n_fused}
    require(all(launches[k] == v for k, v in want_ss.items()),
            f"the sticky-scan kernel's launches "
            f"{[launches[k] for k in want_ss]}, not "
            f"{list(want_ss.values())} (on each of the two Sticky stacks "
            f"the fused entry once a fused batch, the rows-given one once an "
            f"unfused batch)")
    want_gk = {"gk_probe_requantize": n_fused,
               "gk_requantize": n_all - n_fused}
    require(all(launches[k] == v for k, v in want_gk.items()),
            f"the requantize kernel's launches "
            f"{[launches[k] for k in want_gk]}, not "
            f"{list(want_gk.values())} (the fused entry once a fused batch, "
            f"the rows-given one once an unfused batch)")
    require(gk_probes == {"fused": 0, "unfused": n_all - n_fused},
            f"the GK stack's plain probes by batch kind: {gk_probes}, not "
            f"none in a fused batch and one in each unfused batch")
    require(sticky_probes == {"fused": 0, "unfused": 2 * (n_all - n_fused)},
            f"the Sticky stacks' plain probes by batch kind: {sticky_probes},"
            f" not none in a fused batch and one a stack in each unfused "
            f"batch")
    require(sampler_probes == {"fused": 0, "unfused": n_all - n_fused},
            f"the sampler stack's plain probes by batch kind: "
            f"{sampler_probes}, not none in a fused batch and one in each "
            f"unfused batch")
    want_ams = {"onehot_probe_scatter@ams": n_fused,
                "onehot_scatter_add@ams": n_all - n_fused,
                "onehot_scatter_add@fresh@ams": n_all}
    require(all(launches[k] == v for k, v in want_ams.items()),
            f"AMS's signed launches {[launches[k] for k in want_ams]}, not "
            f"{list(want_ams.values())} (a launch a batch and a fold a "
            f"batch)")
    walked = {name: int(getattr(rhp_project, name).long_runs)
              for name in ("rhp_probe_update", "rhp_project_update")}
    launches.update({f"{k}.long_runs": v for k, v in walked.items()})
    one_row = rhp_project.rhp_project_update.one_row_launches
    require(one_row == 0, f"the RHP data-source fold launched {one_row} "
                          "one-row kernels")

    # plain replay on the card: route_probe + batched.stacked_update (the
    # time-series stacks: the last routed value per row + DFT.step)
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    # the DFT answers: query_many's, and the continuous DFT's adhoc answer
    # and its emission after the last batch, all read after every batch
    last_cq = [c for c in sde.continuous_out if c.synopsis_id == "cq-dft"]
    dft_checks = ([(q["synopsis_id"], a)
                   for q, a in zip(parts["dft"], dft_answers)]
                  + [("cq-dft", adhoc["cq-dft"].value),
                     ("cq-dft", last_cq[-1].value)])
    for kind, stack in sde.stacks.items():
        if stack.is_timeseries:
            check_dft_stack(sde, stack, batches, dft_checks, dev)
            continue
        if kind in scan_snap:
            check_scan_stack(stack, scan_snap[kind],
                             batches[:LOSSY_REPLAY_BATCHES], dev)
            continue
        replay = batched.stacked_init(kind, stack.capacity, dev)
        klo, khi, trows = stack.device_table()
        src = stack.source_rows_idx()
        long_runs = [0, 0]            # the fused (even) and unfused batches'
        for i, (sids, vals_b) in enumerate(batches):
            sid64 = sids.astype(np.int64)
            lo, hi = routing.split64(sid64)
            rows = probe.probe_rows(klo, khi, trows, dt(lo.view(np.int32)),
                                    dt(hi.view(np.int32)),
                                    n_probe=stack.n_probe)
            if kind.update_kernel == "rhp_project":
                long_runs[i % 2] += rhp_project.long_runs_of(
                    rows, stack.capacity)[0]
            batched.stacked_update(
                kind, replay, rows,
                dt(routing.fold64(sid64).view(np.int32)), dt(vals_b),
                dt(sid64 >= 0), src)
        equal, err, _ = compare(stack.state, replay)
        require(equal, f"{type(kind).__name__} engine state differs from "
                       f"the plain replay (max abs err {err})")
        if kind.update_kernel == "ams_scatter":
            require(same_bytes(stack.state, replay),
                    "AMS engine state differs byte-wise from the replay")
            print("[phase3] AMS stack equals the plain replay byte for "
                  "byte", flush=True)
        if kind.update_kernel == "rhp_project":
            require(same_bytes(stack.state, replay),
                    "RHP engine state differs byte-wise from the replay")
            q_rows = [sde.entries[q["synopsis_id"]].row
                      for q in parts["rhp"]]
            want = batched.stacked_estimate(
                kind, replay, dt(np.asarray(q_rows, np.int32)))
            for i, got in enumerate(rhp_answers):
                for key in ("signature", "hamming_weight", "bucket"):
                    require(np.array_equal(got[key],
                                           want[key][i].cpu().numpy()),
                            f"RHP answer {i} ({key}) differs from the "
                            f"plain replay's")
            print(f"[phase3] {len(rhp_answers)} RHP signatures, Hamming "
                  f"weights and buckets equal the plain replay's",
                  flush=True)
            want = dict(zip(("rhp_probe_update", "rhp_project_update"),
                            long_runs))
            require(walked == want and min(long_runs) > 0,
                    f"the RHP ring walk took {walked} runs of "
                    f"{rhp_project.LONG_RUN}+ tuples, not the batches' "
                    f"{want}")
            print(f"[phase3] RHP runs of {rhp_project.LONG_RUN}+ tuples "
                  f"walked by the ring: {walked}, as the batches hold",
                  flush=True)
        print(f"[phase3] {type(kind).__name__} stack "
              f"{tuple(stack.state.shape)} equals the plain replay",
              flush=True)
        del replay
        free()
    n_tuples = n_batches * t
    print(f"[phase3] {n_batches} batches x {t} tuples in {ingest_s:.4f} s = "
          f"{n_tuples / ingest_s:.1f} tuples/s (host clock, synchronized); "
          f"{n_answered} queries in {query_s:.4f} s = "
          f"{n_answered / query_s:.1f} queries/s", flush=True)
    print(f"[phase3] launches: {launches}; rhp_project_update one-row "
          f"launches: {one_row}", flush=True)
    sde.close()
    free()
    peak_gib("phase3")
    return launches


def correlation_step(sde, stack, replay, ids: np.ndarray, dev) -> int:
    """The StatStream correlation step over the engine's own answers:
    coefficients and coords of the per-stream synopses of ``ids`` in one
    ``query_many`` (equal to the replay's answers byte for byte), the
    correlation matrix by ``ops.corr_matrix`` (one kernel launch, within
    CORR_ATOL of the plain Gram ``core/dft.py::pairwise_corr``) and the
    bucket-adjacency candidate mask. Returns the kernel's launches."""
    from repro_torch.core import batched, dft
    from repro_torch.kernels import ops

    n = len(ids)
    reset_launches()                      # counts of this step only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = sde.handle({"type": "query_many", "request_id": "corr",
                    "queries": [{"synopsis_id": f"ts/{int(s)}"}
                                for s in ids]})
    require(r.ok and all(a["ok"] for a in r.value),
            f"the correlation step's query_many failed: {r.error}")
    stacked = {key: torch.from_numpy(np.stack(
        [a["value"][key] for a in r.value])).to(dev)
        for key in ("coeffs", "coords")}
    corr = ops.corr_matrix(stacked["coeffs"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read_launches()["pairwise_corr"]
    require(launches == 1, f"ops.corr_matrix launched the correlation "
                           f"kernel {launches} times, not once")
    rows = torch.tensor([sde.entries[f"ts/{int(s)}"].row for s in ids],
                        dtype=torch.int32, device=dev)
    want = batched.stacked_estimate(stack.kind, replay, rows)
    for key in ("coeffs", "coords"):
        require(same_bytes(stacked[key], want[key]),
                f"the correlation step's {key} differ from the replay's")
    require(tuple(corr.shape) == (n, n) and corr.dtype == torch.float32
            and bool(torch.isfinite(corr).all()),
            "the correlation matrix is not finite f32 [N, N]")
    plain = dft.pairwise_corr(stacked["coeffs"])
    _, err, _ = compare(corr, plain)
    del plain
    require(err <= CORR_ATOL, f"ops.corr_matrix is off the plain Gram by "
                              f"{err} (atol {CORR_ATOL})")
    mask = dft.adjacent_bucket_mask(stacked["coords"])
    c = stacked["coords"].cpu().numpy().astype(np.int8)     # cells 0 .. 3
    cheb = np.abs(c[:, None, :] - c[None, :, :]).max(axis=-1)
    require(np.array_equal(mask.cpu().numpy(), cheb <= 1),
            "adjacent_bucket_mask differs from the numpy Chebyshev "
            "distance <= 1 over the same coords")
    del cheb
    n_cand = int(mask.sum())
    above = corr > FIG6_DFT["threshold"]
    high = int(above.sum())
    # |c_i - c_j|^2 < 1 - T puts every pair above T in adjacent cells
    pruned = int((above & ~mask).sum())
    require(pruned == 0, f"{pruned} pairs above the threshold were pruned "
                         f"by the bucket-adjacency mask")
    require(n_cand < n * n and high > n,
            f"the correlation step saw no structure: {n_cand} of {n * n} "
            f"candidate pairs, {high} above the threshold (diagonal {n})")
    print(f"[phase3b] correlation step: {n} streams' coefficients "
          f"{tuple(stacked['coeffs'].shape)} in one query_many, equal to "
          f"the replay's; ops.corr_matrix -> {tuple(corr.shape)} in "
          f"{step_s:.4f} s with the query (host clock, synchronized), "
          f"pairwise_corr launches {launches}, max abs err vs the plain "
          f"Gram {err:.3g} (atol {CORR_ATOL}); candidate pairs by bucket "
          f"adjacency {n_cand} of {n * n} (share {n_cand / (n * n):.6f}), "
          f"equal to numpy's; {high} pairs above the threshold "
          f"{FIG6_DFT['threshold']}, none of them pruned", flush=True)
    del corr, mask, above, stacked
    free()
    return launches


def phase3b(dev, seed: int, n_streams: int, n_batches: int) -> int:
    """Every ring wraps: a per-stream Figure-6 DFT over ``n_streams``
    hashed ids, ``n_batches`` > window ingests that each carry every
    stream once plus duplicates (the last one wins), unrouted and
    negative ids, held against the plain replay byte for byte. Each
    stream follows one of CORR_GROUPS latent random walks plus its own
    noise, so that streams correlate in groups. Then the correlation step
    over the first CORR_N streams; returns its correlation-kernel
    launches."""
    from repro_torch.service import SDE

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(seed + 2)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams + 64,
                                dtype=np.int64))[:n_streams]
    sde = SDE(device=dev)
    r = sde.handle({"type": "build", "request_id": "b", "synopsis_id": "ts",
                    "kind": "dft", "params": FIG6_DFT,
                    "per_stream_of_source": True,
                    "stream_ids": [int(s) for s in pop]})
    require(r.ok, f"build failed: {r.error}")
    stack = next(iter(sde.stacks.values()))
    kind = stack.kind
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    from repro_torch.core import batched
    replay = batched.stacked_init(kind, stack.capacity, dev)
    reset_launches()
    ingest_s, n_tuples = 0.0, 0
    group = np.arange(len(pop)) % CORR_GROUPS
    walk = np.zeros(CORR_GROUPS)
    for _ in range(n_batches):
        walk += rng.randn(CORR_GROUPS) * 10
        routed = np.concatenate([np.arange(len(pop)),
                                 rng.randint(0, len(pop), len(pop) // 8)])
        sids = np.concatenate([
            pop[routed],
            rng.randint(0, 2**62, size=len(pop) // 16, dtype=np.int64)
            | (1 << 62), np.full(16, -1, np.int64)])
        vals = rng.randn(len(sids)) * 10
        vals[:len(routed)] = walk[group[routed]] + rng.randn(len(routed))
        perm = rng.permutation(len(sids))
        sids, vals = sids[perm], vals[perm].astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sde.ingest(sids, vals)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        n_tuples += len(sids)
        hit, per_row = last_writer(probe_host(stack, sids, dev), sids, vals,
                                   stack.capacity)
        kind.step(replay, dt(per_row), dt(hit))
    launches = read_launches()["sliding_dft_step"]
    require(launches == n_batches, f"sliding_dft_step launched {launches} "
                                   f"times in {n_batches} batches")
    require(same_leaves(stack.state, replay),
            "the wrapped DFT stack differs byte-wise from the plain replay")
    min_count = int(stack.state["count"].min())
    require(min_count > kind.window, f"a ring did not wrap (min count "
                                     f"{min_count})")
    print(f"[phase3b] {len(pop)} streams x {n_batches} ticks: {n_tuples} "
          f"tuples in {ingest_s:.4f} s ({ingest_s / n_batches * 1e3:.4f} ms "
          f"per batch, host clock, synchronized); sliding_dft_step launches "
          f"{launches}; stack {stack.capacity} x {stack.row_bytes()} B "
          f"equals the plain replay byte for byte in all six leaves; every "
          f"ring wrapped (min count {min_count})", flush=True)
    corr_launches = correlation_step(sde, stack, replay, pop[:CORR_N], dev)
    sde.close()
    del replay
    free()
    peak_gib("phase3b")
    return corr_launches


def gk_rank_check(data: np.ndarray, answer, eps: float, name: str) -> list:
    """Each answer at GK_QS lies within the reference's rank bound
    6 eps + 1 / N (``tests/test_properties.py``) of the exact quantile of
    ``data``; returns (q, answer, rank below, rank at or below)."""
    tol = 6 * eps + 1.0 / len(data)
    out = []
    for x, q in zip(np.asarray(answer, np.float32), GK_QS):
        below, upto = float((data < x).mean()), float((data <= x).mean())
        out.append((q, float(x), round(below, 5), round(upto, 5)))
        require(below <= q + tol and upto >= q - tol,
                f"{name}'s {q}-quantile {x} has ranks [{below}, {upto}], "
                f"outside {q} +- {tol}")
    return out


def gk_batch_device_ms(stack, batch, dev) -> tuple:
    """The device ms of one GK stack's requantize on ``batch`` (its rows
    from the plain probe, as the engine's unfused route takes them), on a
    copy of the stack's state restored before each call
    (``queued_device_ms``), and its split by kernel (``kernel_split``)."""
    from repro_torch.kernels import gk_requantize, probe
    from repro_torch.service import routing
    sids, vals = batch
    sid64 = sids.astype(np.int64)
    lo, hi = routing.split64(sid64)
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = probe.probe_rows(*stack.device_table(), dt(lo.view(np.int32)),
                            dt(hi.view(np.int32)), n_probe=stack.n_probe)
    vals_d, mask_d = dt(vals), dt(sid64 >= 0)
    values, counts = (stack.state[k].clone() for k in ("values", "n"))
    start = (values.clone(), counts.clone())
    restore = lambda: (values.copy_(start[0]), counts.copy_(start[1]))
    kern = lambda: gk_requantize.gk_requantize_update(
        values, counts, rows, vals_d, mask_d, stack.source_rows_idx(),
        m=stack.kind.m)
    return (queued_device_ms(kern, restore),
            kernel_split(kern, restore, GK_SPLIT))


def phase3c(dev, seed: int, n_streams: int, t: int, n_batches: int) -> None:
    """GK through ``SDE(device="cuda").handle`` on continuous values:
    per-stream over ``n_streams`` ids and data-source GK at the defaults
    (one stack), a data-source GK at eps GK_FINE_EPS (its own stack, its
    state past the kernel's shared memory); ``n_batches`` ingests of
    Zipf(1.1) ids whose values are 70% N(0, 10) and 30% lognormal(3, 1),
    half with SDE_FUSED_PROBE=0. Both entry points must launch, each stack
    equal a replay of every batch through the plain version byte for
    byte, and each data-source answer at GK_QS lie within the rank bound
    of the exact quantiles of the masked tuples ingested. Then each
    stack's device ms a batch and its split (``gk_batch_device_ms``)."""
    from repro_torch.kernels import gk_requantize
    from repro_torch.service import SDE

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(seed + 3)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams, dtype=np.int64))
    sde = SDE(device=dev)
    for sid, params, extra in (
            ("gk", {}, dict(per_stream_of_source=True,
                            stream_ids=[int(s) for s in pop])),
            ("src-gk", {}, {}),
            ("src-gk-fine", {"eps": GK_FINE_EPS}, {})):
        r = sde.handle({"type": "build", "request_id": f"b-{sid}",
                        "synopsis_id": sid, "kind": "gk_quantiles",
                        "params": params, **extra})
        require(r.ok, f"build {sid} failed: {r.error}")
    batches = []
    for _ in range(n_batches):
        sids, _ = make_batch(rng, pop, t)
        vals = np.where(rng.rand(t) < 0.3, rng.lognormal(3, 1, t),
                        rng.randn(t) * 10).astype(np.float32)
        batches.append((sids, vals))
    entries = (gk_requantize.gk_requantize_update,
               gk_requantize.gk_probe_requantize_update)
    before = [fn.launches for fn in entries]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, (sids, vals) in enumerate(batches):
        os.environ["SDE_FUSED_PROBE"] = "1" if b % 2 == 0 else "0"
        r = sde.handle({"type": "ingest", "request_id": f"i{b}",
                        "stream_ids": sids.tolist(),
                        "values": vals.tolist()})
        require(r.ok, f"ingest {b} failed: {r.error}")
    os.environ.pop("SDE_FUSED_PROBE", None)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    made = [fn.launches - n for fn, n in zip(entries, before)]
    n_fused = len(range(0, n_batches, 2))
    require(made == [2 * (n_batches - n_fused), 2 * n_fused],
            f"the requantize kernel's launches (rows given, fused) {made}, "
            f"not one a stack and batch through the batch's entry")
    qs = {"qs": GK_QS}
    r = sde.handle({"type": "query_many", "request_id": "qm", "queries": [
        {"synopsis_id": sid, "query": qs}
        for sid in ("src-gk", "src-gk-fine")]})
    require(r.ok and all(a["ok"] for a in r.value),
            f"query_many failed: {r.error}")
    data = np.concatenate([v[s >= 0] for s, v in batches])
    for sid, a in zip(("src-gk", "src-gk-fine"), r.value):
        adhoc = sde.handle({"type": "adhoc", "request_id": f"a-{sid}",
                            "synopsis_id": sid, "query": qs})
        require(adhoc.ok and np.asarray(adhoc.value, np.float32).tobytes()
                == np.asarray(a["value"], np.float32).tobytes(),
                f"{sid}'s adhoc answer differs from its query_many answer")
        eps = sde.entries[sid].kind_key.eps
        brackets = gk_rank_check(data, a["value"], eps, sid)
        print(f"[phase3c] {sid} (eps {eps}, m = "
              f"{sde.entries[sid].kind_key.m}) over N={len(data)} masked "
              f"continuous tuples, (q, answer, rank below, rank at or "
              f"below): {brackets}, each within "
              f"{6 * eps + 1.0 / len(data):.6f} of q", flush=True)
    for stack in sde.stacks.values():
        check_scan_stack(stack, stack.state, batches, dev)
    print(f"[phase3c] {n_batches} batches x {t} tuples into the two GK "
          f"stacks in {ingest_s:.4f} s (host clock, synchronized); "
          f"requantize launches (rows given, fused) {made}", flush=True)
    for stack in sde.stacks.values():
        ms, split = gk_batch_device_ms(stack, batches[-1], dev)
        print(f"[phase3c] GKQuantiles(m={stack.kind.m}) stack of "
              f"{stack.capacity} rows: {ms:.4f} ms device a batch (the "
              f"rows-given entry on the last batch, from the state it "
              f"left, restored before each call; events around calls "
              f"queued behind a spin, median of 5; by kernel "
              f"{ {k: round(v, 4) for k, v in split.items()} })",
              flush=True)
    sde.close()
    free()
    peak_gib("phase3c")


def phase4(dev, seed: int) -> dict:
    """The attention entry point: ``ops.flash_attention`` once at each
    config's width (ATTN_WIDTHS), S = 4096, causal bfloat16, with the
    counts reset just before each call and read just after. Each call must
    launch the attention kernel exactly once and agree with the plain
    version; returns each row's launches."""
    from repro_torch.kernels import ops, ref

    torch.cuda.reset_peak_memory_stats()
    s = ATTN_S
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    launches = {}
    for name, (h, d) in ATTN_WIDTHS.items():
        q, k, v = attn_inputs(gen, h, s, s, d, torch.bfloat16)
        reset_launches()                  # counts of this call only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches[name] = read_launches()[name]
        require(launches[name] == 1, f"ops.flash_attention ({name}) "
                                     f"launched the attention kernel "
                                     f"{launches[name]} times, not once")
        require(tuple(out.shape) == (h, s, d) and out.dtype == torch.bfloat16
                and bool(torch.isfinite(out).all()),
                f"ops.flash_attention ({name})'s output is not finite bf16 "
                f"[BH, S, D]")
        want = ref.flash_attention(q, k, v, True)
        err, worst = attn_check(out, want)
        require(worst <= 1.0, f"ops.flash_attention ({name}) is off the "
                              f"plain version by {err}, {worst:.3g} times "
                              f"its limit")
        print(f"[phase4] ops.flash_attention ({name}): q/k/v [{h}, {s}, {d}] "
              f"bf16 causal in {call_s:.4f} s (host clock, synchronized, "
              f"first call of this shape), launches {launches[name]}, max "
              f"abs err {err:.3g}, worst element at {worst:.3g} of its limit "
              f"({attn_limit(torch.bfloat16)})", flush=True)
        del q, k, v, out, want
        free()
    peak_gib("phase4")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    # phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    print(f"[phase1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build(["countmin_scatter", "bitset_or", "rhp_project",
                 "sliding_dft", "pairwise_corr", "flash_attention",
                 "lossy_scan", "reservoir_scan", "sticky_scan",
                 "gk_requantize"])
    print(f"[phase1] kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.strip().splitlines():
            print(f"[phase1] {name}: {line}", flush=True)
    peak_gib("phase1")

    n_streams, t = 65536, 65536
    t0 = time.perf_counter()
    timings = phase2(dev, args.seed, 2 * n_streams, n_streams, t)
    print(f"[phase2] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = phase3(dev, args.seed, n_streams, t, n_batches=16,
                      n_queries=1024)
    print(f"[phase3] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches["pairwise_corr"] = phase3b(dev, args.seed,
                                        n_streams=2 * n_streams,
                                        n_batches=192)
    print(f"[phase3b] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase3c(dev, args.seed, n_streams, t, n_batches=GK_CONT_BATCHES)
    print(f"[phase3c] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase4(dev, args.seed))
    print(f"[phase4] done in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ENTRY_POINTS:
        require(launches[name] > 0, f"{name} was not launched on the main "
                                    f"path (phase 3, 3b's correlation step "
                                    f"or phase 4)")
    for name in ("onehot_scatter_add", "onehot_probe_scatter",
                 "onehot_scatter_add@fresh"):
        r = timings[name]
        require(r["device_ms"] <= r["library_device_ms"],
                f"{name} takes {r['device_ms']:.4f} ms of device time, "
                f"above the library call's {r['library_device_ms']:.4f} ms")

    kernels = []
    for name, (_, _, src, replaced) in ENTRY_POINTS.items():
        r = timings[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=(replaced if replaced.startswith("src/")
                      else f"src/repro/kernels/{replaced}"),
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            device_ms=r["device_ms"], plain_device_ms=r["plain_device_ms"],
            library_device_ms=r["library_device_ms"]))
        # CountMin and RHP: their add chains and the split by kernel
        kernels[-1].update({k: r[k] for k in (
            "longest_run", "runs", "long_runs", "chain_floor_ms",
            "step_floor_ms", "miss_floor_ms", "misses", "levels",
            "hottest_adds", "split_device_ms", "walks", "writes",
            "past_fill", "past_epochs", "capacity", "bumps", "hits",
            "takes", "first_step_bumps", "end_of_walk_bumps", "float_check",
            "serial_steps", "serial_groups", "full_steps", "group_floor_ms",
            "former_chain_ms", "under_former_chain",
            "device_timing",
            "start",
            "two_stacks_device_ms", "rows_with_tuples", "rows_moved",
            "search_floor_ms",
            "first_touch_ms", "first_touch_device_ms",
            "lanes", "sectors", "hottest_lane", "k", "plain_timing",
            "library") if k in r})
        if replaced.startswith("src/repro/core/"):
            kernels[-1]["tpu_kernel"] = None    # none: see ENTRY_POINTS
        if f"{name}.long_runs" in launches:
            kernels[-1]["long_runs_phase3"] = launches[f"{name}.long_runs"]
        large = timings.get(f"{name}@{1 << 20}")
        if large is not None:       # the same kernel at S = 2**20 rows
            kernels[-1][f"at_{1 << 20}"] = {
                k: large[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "device_ms",
                                      "plain_device_ms")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
