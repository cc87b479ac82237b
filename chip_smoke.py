#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # needs one CUDA card; ~1-2 minutes

Phases (any failure raises, so the script exits non-zero without its
last line):

  1. Card and build: ``nvidia-smi`` name and power limit, then both
     kernel sources built by ``nvcc`` in parallel.
  2. Each of the four kernel entry points against its plain version at
     the main path's shapes: CountMin eps=0.002, delta=0.01 (the paper's
     parameters, ``benchmarks/fig5_scalability.py``) -> rows [5, 2048]
     f32; HyperLogLog rse=0.03 -> 2048 registers; n = 131,072 rows (the
     capacity of phase 3's stacks); a batch of 65,536 tuples with
     unrouted and -1 lanes. Integer weights must match exactly, float
     weights to a stated tolerance and byte for byte across two kernel
     runs. Times are CUDA-event medians.
  3. The main path through ``SDE(device="cuda").handle``: per-stream CM
     and HLL over 65,536 hashed 63-bit ids, a data-source CM and HLL and
     one continuous HLL; 16 ingest batches of 65,536 Zipf(1.1) tuples
     (half with SDE_FUSED_PROBE=0); 1,024 CM queries in one query_many
     and HLL adhoc queries. The final state must equal a replay of the
     same batches through the plain versions on the card.
  4. One JSON line with each kernel's launches in phase 3 and its
     phase-2 numbers, then the device line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
TIMING_RUNS = 25
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-3   # float sums of up to ~10^4 terms
                                      # taken in another order


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median CUDA-event time of ``fn()`` over ``runs`` runs (1 warm-up)."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def probed_slots(klo, khi, slo, shi, n_probe: int, lanes) -> int:
    """Distinct table slots the probe reads for the ``lanes`` ids."""
    from repro_torch.core import hashing
    from repro_torch.kernels import probe
    size = klo.shape[0]
    kh = hashing.as_u32(khi)
    kl = hashing.as_u32(klo)
    lo = hashing.as_u32(slo[lanes])
    hi = hashing.as_u32(shi[lanes])
    slot = probe.slot0(lo, hi, size)
    done = torch.zeros_like(lo, dtype=torch.bool)
    seen = []
    for _ in range(n_probe):
        seen.append(slot[~done])
        hit = (kl[slot] == lo) & (kh[slot] == hi)
        done = done | hit | (kh[slot] == probe.ROUTE_EMPTY_HI)
        slot = torch.where(done, slot, (slot + 1) & (size - 1))
    return int(torch.unique(torch.cat(seen)).numel())


# ---------------------------------------------------------------------------
# phase 2: every kernel entry point against its plain version
# ---------------------------------------------------------------------------
def phase2(dev, seed: int, n: int, n_streams: int, t: int) -> dict:
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import hll_max, onehot_matmul, ops, probe, ref
    from repro_torch.service import routing

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cm = core.CountMin(eps=0.002, delta=0.01)
    hll = core.HyperLogLog(rse=0.03)
    d, w, m = cm.depth, cm.width, hll.m
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams, dtype=np.int64))
    table = routing.RouteTable()
    table.insert_many(pop, np.arange(len(pop), dtype=np.int32))
    n_probe = routing.next_pow2(table.max_probe)
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    klo, khi = (dt(h.view(np.int32)) for h in routing.split64(table.keys))
    trows = dt(table.rows)
    sids, vals = make_batch(rng, pop, t)
    slo, shi = (dt(h.view(np.int32)) for h in routing.split64(sids))
    items = dt(routing.fold64(sids).view(np.int32))
    mask = dt((rng.rand(t) > 0.05) & (sids >= 0))
    rows = ops.route_probe(klo, khi, trows, slo, shi, n_probe=n_probe)
    require(int((rows < 0).sum()) > 0, "batch has no -1 lanes")
    idx = hashing.bucket_hash(items, cm._seeds(), cm.log2_width)
    v_int = dt(vals) * mask.float()
    v_flt = torch.rand(t, generator=gen, device=dev) * 4 * mask.float()
    bucket, raw_rank = ops._hll_prep(items, hll.seed, hll.p)
    rank = torch.where(mask, raw_rank, 0).to(torch.int32)
    print(f"[phase2] n={n} d={d} w={w} m={m} T={t} unrouted="
          f"{int((rows < 0).sum())} table size={table.size} "
          f"n_probe={n_probe}", flush=True)

    keep = rows >= 0
    kept_rows = rows[keep].long()
    ix = idx[keep].long()
    js = torch.arange(d, device=dev)[None, :].expand(ix.shape)
    lib_cm_index = (kept_rows[:, None].expand(ix.shape), js, ix)
    hkeep = keep & (rank > 0)
    lib_hll_flat = rows[hkeep].long() * m + bucket[hkeep].long()
    lib_hll_src = rank[hkeep]

    nz = v_int[keep] != 0
    cm_touched = int(torch.unique(
        ((kept_rows[:, None] * d + js) * w + ix)[nz]).numel())
    lib_cm_vals = v_int[keep][:, None].expand(ix.shape).contiguous()
    cm_updates = int(keep.sum()) * d
    hll_touched = int(torch.unique(lib_hll_flat).numel())
    probe_slots_cm = probed_slots(klo, khi, slo, shi, n_probe,
                                  torch.ones_like(mask))
    probe_slots_hll = probed_slots(klo, khi, slo, shi, n_probe, rank > 0)
    batch_cm = t * d * 4 + t * 4                    # idx, values
    batch_hll = t * 4 * 2                           # bucket, rank
    table_b = 12                                    # key lo, key hi, row

    results = {}

    def record(name, fn_kernel, fn_plain, fn_lib, state0, n_bytes, n_ops,
               floats=None):
        k = state0.clone()
        fn_kernel(k)
        p = state0.clone()
        fn_plain(p)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        require(torch.equal(k, p),
                f"{name}: kernel disagrees with its plain version "
                f"(max abs err {err})")
        del p
        if floats is not None:
            floats(state0)
        kms = cuda_ms(lambda: fn_kernel(k))
        p = state0.clone()
        pms = cuda_ms(lambda: fn_plain(p))
        lms = cuda_ms(lambda: fn_lib(p))
        del k, p
        bms, by = bound_ms(n_bytes, n_ops)
        results[name] = dict(max_abs_err=err, ms=kms, plain_ms=pms,
                             library_ms=lms, bound_ms=bms, bound_by=by,
                             bytes=n_bytes)
        print(f"[phase2] {name}: exact match, kernel {kms:.4f} ms, plain "
              f"{pms:.4f} ms, library {lms:.4f} ms, bound {bms:.4f} ms "
              f"({by}, {n_bytes} B)", flush=True)

    # -- CountMin: integer weights exact, float weights reproducible ----
    cm0 = torch.randint(0, 8, (n, d, w), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.float32)

    def cm_float_checks(state0):
        for label, kern, plain in (
                ("onehot_scatter_add",
                 lambda s: onehot_matmul.onehot_scatter_add(s, rows, idx,
                                                            v_flt),
                 lambda s: ref.onehot_scatter_add(s, rows, idx, v_flt)),
                ("onehot_probe_scatter",
                 lambda s: onehot_matmul.onehot_probe_scatter(
                     s, klo, khi, trows, slo, shi, idx, v_flt,
                     n_probe=n_probe),
                 lambda s: ref.onehot_scatter_add(s, rows, idx, v_flt))):
            a = state0.clone()
            kern(a)
            b = state0.clone()
            kern(b)
            torch.cuda.synchronize()
            require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                    f"{label}: float-weight runs differ byte-wise")
            del b
            p = state0.clone()
            plain(p)
            ferr = float((a - p).abs().max())
            require(torch.allclose(a, p, rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
                    f"{label}: float weights off by {ferr}")
            print(f"[phase2] {label}: float weights byte-identical over 2 "
                  f"runs; max abs err vs plain {ferr:.3g} (rtol "
                  f"{FLOAT_RTOL}, atol {FLOAT_ATOL})", flush=True)
            del a, p

    cm_state_b = 8 * cm_touched
    record("onehot_scatter_add",
           lambda s: onehot_matmul.onehot_scatter_add(s, rows, idx, v_int),
           lambda s: ref.onehot_scatter_add(s, rows, idx, v_int),
           lambda s: s.index_put_(lib_cm_index, lib_cm_vals,
                                  accumulate=True),
           cm0, t * 4 + batch_cm + cm_state_b, cm_updates,
           floats=cm_float_checks)
    record("onehot_probe_scatter",
           lambda s: onehot_matmul.onehot_probe_scatter(
               s, klo, khi, trows, slo, shi, idx, v_int, n_probe=n_probe),
           lambda s: ref.onehot_scatter_add(
               s, probe.probe_rows(klo, khi, trows, slo, shi,
                                   n_probe=n_probe), idx, v_int),
           lambda s: s.index_put_(lib_cm_index, lib_cm_vals,
                                  accumulate=True),
           cm0, t * 8 + table_b * probe_slots_cm + batch_cm + cm_state_b,
           cm_updates)
    del cm0
    torch.cuda.empty_cache()

    # -- HyperLogLog -----------------------------------------------------
    hll0 = torch.randint(0, 4, (n, m), generator=gen, device=dev,
                         dtype=torch.int32)
    hll_state_b = 8 * hll_touched
    record("hll_max_update",
           lambda s: hll_max.hll_max_update(s, rows, bucket, rank),
           lambda s: ref.hll_max_update(s, rows, bucket, rank),
           lambda s: s.view(-1).scatter_reduce_(0, lib_hll_flat, lib_hll_src,
                                                reduce="amax"),
           hll0, t * 4 + batch_hll + hll_state_b, int(hkeep.sum()))
    record("hll_probe_max_update",
           lambda s: hll_max.hll_probe_max_update(
               s, klo, khi, trows, slo, shi, bucket, rank, n_probe=n_probe),
           lambda s: ref.hll_max_update(
               s, probe.probe_rows(klo, khi, trows, slo, shi,
                                   n_probe=n_probe), bucket, rank),
           lambda s: s.view(-1).scatter_reduce_(0, lib_hll_flat, lib_hll_src,
                                                reduce="amax"),
           hll0, t * 8 + table_b * probe_slots_hll + batch_hll + hll_state_b,
           int(hkeep.sum()))
    del hll0
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path through SDE.handle, held against a plain replay
# ---------------------------------------------------------------------------
ENTRY_POINTS = ("onehot_scatter_add", "onehot_probe_scatter",
                "hll_max_update", "hll_probe_max_update")


def wrappers() -> dict:
    from repro_torch.kernels import hll_max, onehot_matmul
    return {"onehot_scatter_add": onehot_matmul.onehot_scatter_add,
            "onehot_probe_scatter": onehot_matmul.onehot_probe_scatter,
            "hll_max_update": hll_max.hll_max_update,
            "hll_probe_max_update": hll_max.hll_probe_max_update}


def phase3(dev, seed: int, n_streams: int, t: int, n_batches: int,
           n_queries: int) -> dict:
    from repro_torch import core
    from repro_torch.core import batched
    from repro_torch.kernels import probe
    from repro_torch.service import SDE, routing

    rng = np.random.RandomState(seed + 1)
    pop = np.unique(rng.randint(0, 2**63 - 1, size=n_streams, dtype=np.int64))
    cm_params = {"eps": 0.002, "delta": 0.01}
    hll_params = {"rse": 0.03}
    batches = [make_batch(rng, pop, t) for _ in range(n_batches)]
    for fn in wrappers().values():
        fn.launches = 0                      # counts of the main path only

    sde = SDE(device=dev)
    ids = [int(s) for s in pop]
    for req in (
            {"type": "build", "request_id": "b-cm", "synopsis_id": "cm",
             "kind": "countmin", "params": cm_params,
             "per_stream_of_source": True, "stream_ids": ids},
            {"type": "build", "request_id": "b-hll", "synopsis_id": "hll",
             "kind": "hyperloglog", "params": hll_params,
             "per_stream_of_source": True, "stream_ids": ids},
            {"type": "build", "request_id": "b-src-cm",
             "synopsis_id": "src-cm", "kind": "countmin",
             "params": cm_params},
            {"type": "build", "request_id": "b-src-hll",
             "synopsis_id": "src-hll", "kind": "hyperloglog",
             "params": hll_params},
            {"type": "build", "request_id": "b-cq", "synopsis_id": "cq-hll",
             "kind": "hyperloglog", "params": hll_params,
             "continuous": True}):
        r = sde.handle(req)
        require(r.ok, f"build {req['synopsis_id']} failed: {r.error}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, (sids, vals) in enumerate(batches):
        os.environ["SDE_FUSED_PROBE"] = "1" if b % 2 == 0 else "0"
        r = sde.handle({"type": "ingest", "request_id": f"i{b}",
                        "stream_ids": sids.tolist(),
                        "values": vals.tolist()})
        require(r.ok, f"ingest {b} failed: {r.error}")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    os.environ.pop("SDE_FUSED_PROBE", None)

    # exact answers: each per-stream CM row only ever sees its own item,
    # so its point estimate is the stream's exact total weight
    all_s = np.concatenate([s for s, _ in batches])
    all_v = np.concatenate([v for _, v in batches])
    uniq, inverse = np.unique(all_s, return_inverse=True)
    totals = np.bincount(inverse, weights=all_v)
    q_streams = pop[zipf_streams(rng, len(pop), n_queries)]
    queries = [{"synopsis_id": f"cm/{int(s)}", "query": {"items": [int(s)]}}
               for s in q_streams]
    t0 = time.perf_counter()
    r = sde.handle({"type": "query_many", "request_id": "qm",
                    "queries": queries})
    hll_r = [sde.handle({"type": "adhoc", "request_id": f"h{k}",
                         "synopsis_id": sid})
             for k, sid in enumerate(("src-hll", f"hll/{ids[0]}",
                                      "cq-hll"))]
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    require(r.ok, f"query_many failed: {r.error}")
    got = np.asarray([float(q["value"][0]) for q in r.value])
    pos = np.minimum(np.searchsorted(uniq, q_streams), len(uniq) - 1)
    want = np.where(uniq[pos] == q_streams, totals[pos], 0.0)
    require(np.array_equal(got, want), "CM answers differ from exact sums")
    for h in hll_r:
        require(h.ok and np.isfinite(float(h.value)),
                f"HLL adhoc failed: {h.error}")
    distinct = len(np.unique(routing.fold64(all_s[all_s >= 0])))
    rel = float(hll_r[0].value) / distinct - 1.0
    require(abs(rel) < 0.15, f"data-source HLL off by {rel:.3f}")
    require(len(sde.continuous_out) == n_batches,
            "one continuous response per batch expected")
    launches = {name: fn.launches for name, fn in wrappers().items()}

    # plain replay on the card: route_probe + batched.stacked_update
    for kind, stack in sde.stacks.items():
        replay = batched.stacked_init(kind, stack.capacity, dev)
        klo, khi, trows = stack.device_table()
        src = stack.source_rows_idx()
        for sids, vals in batches:
            sid64 = sids.astype(np.int64)
            lo, hi = routing.split64(sid64)
            dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            rows = probe.probe_rows(klo, khi, trows, dt(lo.view(np.int32)),
                                    dt(hi.view(np.int32)),
                                    n_probe=stack.n_probe)
            batched.stacked_update(
                kind, replay, rows,
                dt(routing.fold64(sid64).view(np.int32)), dt(vals),
                dt(sid64 >= 0), src)
        require(torch.equal(stack.state, replay),
                f"{type(kind).__name__} engine state differs from the "
                "plain replay")
        print(f"[phase3] {type(kind).__name__} stack {tuple(stack.state.shape)}"
              f" equals the plain replay", flush=True)
        del replay
    n_tuples = n_batches * t
    print(f"[phase3] {n_batches} batches x {t} tuples in {ingest_s:.4f} s = "
          f"{n_tuples / ingest_s:.1f} tuples/s (host clock, synchronized); "
          f"{n_queries} CM + 3 HLL queries in {query_s:.4f} s = "
          f"{(n_queries + 3) / query_s:.1f} queries/s", flush=True)
    print(f"[phase3] launches: {launches}", flush=True)
    sde.close()
    torch.cuda.empty_cache()
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
    build.build(["countmin_scatter", "hll_max"])
    print(f"[phase1] kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.strip().splitlines():
            print(f"[phase1] {name}: {line}", flush=True)

    n_streams, t = 65536, 65536
    timings = phase2(dev, args.seed, 2 * n_streams, n_streams, t)
    launches = phase3(dev, args.seed, n_streams, t, n_batches=16,
                      n_queries=1024)
    for name in ENTRY_POINTS:
        require(launches[name] > 0,
                f"{name} was not launched on the main path")

    sources = {"onehot_scatter_add": ("countmin_scatter.cu",
                                      "onehot_matmul.py:61"),
               "onehot_probe_scatter": ("countmin_scatter.cu",
                                        "onehot_matmul.py:139"),
               "hll_max_update": ("hll_max.cu", "hll_max.py:52"),
               "hll_probe_max_update": ("hll_max.cu", "hll_max.py:116")}
    kernels = []
    for name in ENTRY_POINTS:
        src, ref = sources[name]
        r = timings[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{ref}", launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
