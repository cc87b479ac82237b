#!/usr/bin/env python3
"""Lossy Counting's scan kernel (``csrc/lossy_scan.cu``) on one walk:
the device time of a data-source row's walk, by the path its tuples take,
at several table sizes, beside earlier checkouts of the kernel.

    python3 tools/lossy_probe.py                         # one CUDA card
    python3 tools/lossy_probe.py --src build/parent --sass build/sass

A one-row stack whose row is a data-source row walks every tuple of a
batch of T = 65,536 (all masked in, none routed), as chip_smoke's data-
source Lossy rows do. Item patterns: ``hits`` (one item: every tuple
after the first hits, as in a hot routed run), ``evictions`` (distinct
items: every tuple misses) and ``zipf`` (chip_smoke's phase-2 mix:
Zipf(1.1) over 65,536 ids, 10% unique ids); weights 1-4. Each call
starts from the table the first call left (a full one). For each k,
pattern and build (this checkout's source, then each ``--src``
checkout's, such as a parent unpacked by ``git archive``) it prints the
walk kernel's device time (``torch.profiler``, mean of 5 calls), the
misses and levels of the walk (``chip_smoke.lossy_replay``) and the
cycles at the card's top SM clock a tuple, a group of 32 tuples and a
miss. ptxas's register and spill lines are printed for every build; with
``--sass DIR`` this checkout's walk SASS (``cuobjdump``) goes to DIR.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np      # noqa: E402
import torch            # noqa: E402

import chip_smoke as cs                                  # noqa: E402
from repro_torch.core import batched, lossy              # noqa: E402
from repro_torch.kernels import build, lossy_scan        # noqa: E402
from probe_build import (build_all, card_line, edited,   # noqa: E402
                         kernel_ms)

T = 65536
CSRC = Path("src/repro_torch/kernels/csrc")
# --stamps: a copy of this checkout's source whose data-source walk adds
# clock64() intervals by part into sde_stamp[] (lane 0, integer atomics),
# read back through lossy_stamps(); a row walked by another warp would add
# to them too, so the probe walks one data-source row alone
STAMP_PARTS = ("lookups", "phases", "phase checks that fail",
               "a miss at a time", "index inserts", "phase classification",
               "phases (count)", "misses at a time (count)",
               "phase: cut at slots its misses take", "phase: slot list",
               "phase: misses read",
               "phase: misses (slot list, read, written)",
               "phase: hits", "phase: lanes after fixed")
STAMP_EDITS = [
    ('#include "row_sort.cuh"\n', '#include "row_sort.cuh"\n'
     '__device__ unsigned long long sde_stamp[16];\n'
     '#define SDE_T(v) const unsigned long long v = clock64()\n'
     '#define SDE_ADD(i, a) if ((threadIdx.x & 31) == 0) '
     'atomicAdd(&sde_stamp[i], (a))\n'),
    ('    ++groups;\n    vbuf[lane] = v;',
     '    SDE_T(t0);\n    ++groups;\n    vbuf[lane] = v;'),
    ('    int taken = -1;\n    unsigned rem = in;\n    while (rem != 0u) {\n'
     '      if (fe != kNone || !phase(rem, hit, taken, x, v, peers)) {\n'
     '        one_miss(rem, hit, taken, x, v, peers);\n      }\n    }\n'
     '    if (mode == 2) index_taken(taken);',
     '    SDE_T(t1);\n    SDE_ADD(0, t1 - t0);\n'
     '    int taken = -1;\n    unsigned rem = in;\n    while (rem != 0u) {\n'
     '      SDE_T(a);\n'
     '      const bool done = fe == kNone && phase(rem, hit, taken, x, v, '
     'peers);\n      SDE_T(b);\n      SDE_ADD(done ? 1 : 2, b - a);\n'
     '      SDE_ADD(done ? 6 : 7, 1);\n'
     '      if (!done) {\n        one_miss(rem, hit, taken, x, v, peers);\n'
     '        SDE_T(c);\n        SDE_ADD(3, c - b);\n      }\n    }\n'
     '    SDE_T(t2);\n    if (mode == 2) index_taken(taken);\n'
     '    SDE_T(t3);\n    SDE_ADD(4, t3 - t2);'),
    ('    const unsigned below = (1u << lane) - 1u;\n    const bool in = ',
     '    SDE_T(p0);\n    const unsigned below = (1u << lane) - 1u;\n'
     '    const bool in = '),
    ('    unsigned P = stops ? rem & ((stops & (0u - stops)) - 1u) : rem;\n',
     '    unsigned P = stops ? rem & ((stops & (0u - stops)) - 1u) : rem;\n'
     '    SDE_T(p1);\n    SDE_ADD(5, p1 - p0);\n'),
    ('    int s = kNone;\n    unsigned tk = 0u;\n    if (pm != 0u) {\n',
     '    SDE_T(p2);\n    SDE_ADD(8, p2 - p1);\n'
     '    int s = kNone;\n    unsigned tk = 0u;\n    if (pm != 0u) {\n'),
    ('      float old = 0.0f, c = 0.0f;\n',
     '      SDE_T(p3);\n      SDE_ADD(9, p3 - p2);\n'
     '      float old = 0.0f, c = 0.0f;\n'),
    ('      pm &= P;\n      if ((pm >> lane) & 1u) {\n        key[s] = x;\n',
     '      SDE_T(p4);\n      SDE_ADD(10, p4 - p3);\n'
     '      pm &= P;\n      if ((pm >> lane) & 1u) {\n        key[s] = x;\n'),
    ('    const unsigned ph = P & ~pm;                    // the hits\n',
     '    SDE_T(p5);\n    SDE_ADD(11, p5 - p2);\n'
     '    const unsigned ph = P & ~pm;                    // the hits\n'),
    ('    // the lanes after P: a miss of P with their item took slot s; '
     'a slot\n',
     '    SDE_T(p6);\n    SDE_ADD(12, p6 - p5);\n'
     '    // the lanes after P: a miss of P with their item took slot s; '
     'a slot\n'),
    ('    rem &= ~P;\n    return true;\n',
     '    SDE_T(p7);\n    SDE_ADD(13, p7 - p6);\n'
     '    rem &= ~P;\n    return true;\n'),
    ('extern "C" {\n', 'extern "C" {\n\n'
     'int lossy_stamps(unsigned long long* out) {\n'
     '  cudaError_t e = cudaMemcpyFromSymbol(out, sde_stamp, 128);\n'
     '  const unsigned long long z[16] = {};\n'
     '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(sde_stamp, z, 128);\n'
     '  return (int)e;\n}\n'),
]


# --latency: one warp runs a chain of 4,096 dependent steps of each
# operation the walk's chain is made of; cycles a step by clock64()
LATENCY_OPS = {
    "fadd": "x = __float_as_int(__fadd_rn(__int_as_float(x), 1.0f));",
    "shfl": "x = __shfl_sync(0xffffffffu, x, x & 31);",
    "ballot": "x = (int)__ballot_sync(0xffffffffu, (x >> lane) & 1);",
    "redux.min": "x = (int)__reduce_min_sync(0xffffffffu, (unsigned)(x ^ "
                 "lane));",
    "match_any (4 values)": "x = (int)__match_any_sync(0xffffffffu, "
                            "(x & 0xff) + (lane & 3));",
    "match_any (32 values)": "x = (int)__match_any_sync(0xffffffffu, "
                             "(x & 0xff) + lane);",
    "lds": "x = sm[x & 1023];",
    "atomicCAS shared": "x = atomicCAS(&sm[x & 1023], -7, 5);",
    "first set bit (ballot, ffs, shfl, ffs)":
        "{ const int l = __ffs(__ballot_sync(0xffffffffu, (x >> lane) & 1) "
        "| 0x80000000u) - 1; x += 32 * l + __ffs(__shfl_sync(0xffffffffu, "
        "x | 1, l)) - 1; }",
}
LATENCY_SRC = """#include <cuda_runtime.h>
__global__ void chain_kernel(long long* out, int x0) {
  __shared__ int sm[1024];
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 1024; i += 32) sm[i] = (i * 7 + 1) & 1023;
  __syncwarp();
  int x = x0 + (lane == 0);
  const long long t0 = clock64();
  for (int i = 0; i < 4096; ++i) { OP }
  const long long t1 = clock64();
  if (lane == 0) { out[0] = t1 - t0; out[1] = x; }
}
extern "C" int chain(long long* out) {
  chain_kernel<<<1, 32>>>(out, 1);
  return (int)cudaDeviceSynchronize();
}
"""


def latencies() -> None:
    """Cycles a step of each LATENCY_OPS chain, every source built at
    once."""
    srcs = {op: (f"chain{i}", LATENCY_SRC.replace("OP", body), ROOT / CSRC)
            for i, (op, body) in enumerate(LATENCY_OPS.items())}
    libs = build_all(srcs, {name: {"chain": (ctypes.c_void_p,)}
                            for name, _, _ in srcs.values()}, "lossy_lat_")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    for op, (lib, _) in libs.items():
        best = min(
            (build.check_launch(lib.chain(out.data_ptr()), op),
             int(out[0]))[1] for _ in range(3))
        print(f"[latency] {op}: {best / 4096:.1f} cycles a step", flush=True)


def items_of(pattern: str, rng) -> np.ndarray:
    if pattern == "hits":
        return np.full(T, 7, np.uint32)
    if pattern == "evictions":
        return rng.permutation(T).astype(np.uint32) + 1
    ids = rng.randint(0, 2**32 - 1, size=T, dtype=np.int64)
    items = ids[cs.zipf_streams(rng, T, T)].astype(np.uint32)
    unique = rng.rand(T) < 0.10
    items[unique] = rng.randint(0, 2**32 - 1, size=int(unique.sum()),
                                dtype=np.int64).astype(np.uint32)
    return items


def scan_call(lib, st: dict, rows, items, vals, mask, src):
    """One call of a build's C ``lossy_scan`` on a stack, on the current
    stream (the wrapper's call, with its own library)."""
    n, k = st["keys"].shape
    words = ctypes.c_longlong(0)
    build.check_launch(lib.lossy_words(n, T, ctypes.addressof(words)),
                       "lossy_words")
    scratch = torch.empty((words.value,), dtype=torch.int32,
                          device=rows.device)
    src32 = src.to(torch.int32)
    build.check_launch(lib.lossy_scan(
        st["keys"].data_ptr(), st["counts"].data_ptr(),
        st["error"].data_ptr(), n, k, rows.data_ptr(), items.data_ptr(),
        vals.data_ptr(), mask.data_ptr(), T, src32.data_ptr(), 1,
        scratch.data_ptr(), build.stream(rows.device)), "lossy_scan")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="4,20,32,100,129,1000")
    ap.add_argument("--src", type=Path, action="append", default=[])
    ap.add_argument("--sass", default=None)
    ap.add_argument("--stamps", action="store_true",
                    help="also split the walk by part (a stamped copy)")
    ap.add_argument("--latency", action="store_true",
                    help="also time chains of the walk's operations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lossy_probe.py needs a CUDA card")
    card_line()
    if args.latency:
        latencies()
    dev = torch.device("cuda", 0)
    srcs = {"this": ("lossy_scan", (ROOT / CSRC / "lossy_scan.cu")
                     .read_text(), ROOT / CSRC)}
    for s in args.src:
        d = s.resolve() / CSRC
        srcs[s.name] = ("lossy_scan", (d / "lossy_scan.cu").read_text(), d)
    # the calls the probe makes, which every build of the source exports
    calls = {f: lossy_scan._SIGNATURES[f] for f in ("lossy_words",
                                                     "lossy_scan")}
    sigs = {"lossy_scan": calls}
    if args.stamps:
        text = edited("stamps", "lossy_scan", srcs["this"][1], STAMP_EDITS)
        srcs["stamps"] = ("lossy_scan_stamps", text, ROOT / CSRC)
        sigs["lossy_scan_stamps"] = dict(calls,
                                         lossy_stamps=(ctypes.c_void_p,))
    libs = build_all(srcs, sigs, "lossy_probe_")
    if args.sass:
        build.build(["lossy_scan"])
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        out = subprocess.run([tool, "-sass", str(build.lib_path(
            "lossy_scan"))], capture_output=True, text=True)
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        (Path(args.sass) / "lossy_scan.sass").write_text(out.stdout)
        print(f"[sass] {len(out.stdout.splitlines())} lines to {args.sass}",
              flush=True)
    _, mhz = cs.chain_floor_ms(1)
    hz = mhz * 1e6
    rng = np.random.RandomState(0)
    rows = torch.full((T,), -1, dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.randint(1, 5, T).astype(np.float32)).to(dev)
    mask = torch.ones(T, dtype=torch.bool, device=dev)
    src = torch.zeros(1, dtype=torch.int64, device=dev)
    for pattern in ("hits", "evictions", "zipf"):
        items = torch.from_numpy(items_of(pattern, rng).view(np.int32)).to(
            dev)
        for k in (int(x) for x in args.ks.split(",")):
            kind = lossy.LossyCounting(eps=1.0 / k)
            start = batched.stacked_init(kind, 1, dev)
            lossy_scan.lossy_scan_update(start["keys"], start["counts"],
                                         start["error"], rows, items, vals,
                                         mask, src)
            rp = cs.lossy_replay(start["keys"][0], start["counts"][0], items,
                                 vals)
            misses, levels, hottest = (rp["misses"], rp["levels"],
                                       rp["hottest"])
            want = None
            for label, (lib, _) in libs.items():
                st = batched.tree_map(torch.clone, start)
                prep = lambda st=st: [st[x].copy_(start[x])
                                      for x in ("keys", "counts", "error")]
                fn = lambda lib=lib, st=st: scan_call(lib, st, rows, items,
                                                      vals, mask, src)
                walk = kernel_ms(fn, "walk_kernel", 5, prep=prep)
                prep()
                fn()
                got = [st[x].view(torch.int32) for x in
                       ("keys", "counts", "error")]
                want = got if want is None else want
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                cycles = walk * 1e-3 * hz
                print(f"[probe] {label:8s} {pattern:9s} k={kind.k:5d}: walk "
                      f"{walk:.4f} ms device; {misses} misses, {levels} "
                      f"levels, hottest slot {hottest} adds; cycles at "
                      f"{mhz:.0f} MHz: "
                      f"{cycles / T:.1f} a tuple, {cycles / (T / 32):.1f} a "
                      f"group of 32, {cycles / max(misses, 1):.1f} a miss; "
                      f"bytes as '{next(iter(libs))}': {same}", flush=True)
                cs.require(same, f"{label}: {pattern} k={k} differs from "
                                 f"this checkout's bytes")
                if label == "stamps":
                    stamps = (ctypes.c_ulonglong * 16)()
                    build.check_launch(lib.lossy_stamps(stamps), "stamps")
                    prep()
                    fn()
                    torch.cuda.synchronize()
                    build.check_launch(lib.lossy_stamps(stamps), "stamps")
                    groups = T / 32
                    print(f"[stamps] {pattern:9s} k={kind.k:5d}, cycles a "
                          f"group of 32 by part: " + "; ".join(
                              f"{part} {stamps[i] / groups:.1f}"
                              for i, part in enumerate(STAMP_PARTS)),
                          flush=True)


if __name__ == "__main__":
    main()
