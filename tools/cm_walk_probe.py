#!/usr/bin/env python3
"""Where a CountMin call's time goes: each launch, and the walk.

    python3 tools/cm_walk_probe.py      # needs one CUDA card and nvcc
    python3 tools/cm_walk_probe.py --fresh            # the small-stack route
    python3 tools/cm_walk_probe.py --fresh --launches-only --src DIR

On chip_smoke's phase-2 batch (65,536 Zipf(1.1) tuples), into CountMin
[131,072, 5, 2048] on the routed rows, or with ``--fresh`` into the
data-source fold's fresh sketch [1, 5, 2048] with every tuple on row 0
(the element-keyed route: a key pass, the sort over 10,240 keys, the
gather and the walk, whose runs are elements):

  * the device time of each launch of one ``onehot_scatter_add`` call
    (``torch.profiler``, mean of 5 calls), in launch order: the memset of
    the sort's sums, the row sort's histogram and scatter of each pass,
    the gather and the walk;
  * a stamped build of ``csrc/countmin_scatter.cu`` and
    ``csrc/row_sort.cuh`` (text edits of copies, built in a temporary
    directory): every walk warp records its start and end on the global
    timer (ns) and the chunk it walked last; the warp of the hot run's
    first chunk at depth row 0 records the SM cycles from its start to
    each of its first 1,024 ring steps, to the start and the end of each
    step's adds, and to its end; block 0 of each sort scatter pass records
    the cycles to its digit sums, its ranks, its prefixes (before it stages
    its tuples by digit) and its end, and every block of the first two scatter passes its start and
    end on the global timer. It prints the hot
    warp's cycles a step (median, min, max) and their split (from the
    step's wait to its adds, the adds), when the warps end (the hot warp,
    the last one with its chunk, depth row and run, and the share of
    warps ended by each quarter of the kernel), and the scatter stamps
    (block 0's, and each pass's spread of block starts, median and
    longest block and its index).
    The stamped build's state must equal the wrapper's own build's bytes.
    With ``--fresh`` the stamped warp is the one that walks the hottest
    element's run.

``--launches-only`` stops after the launch times, and ``--src DIR`` takes
``repro_torch`` from the checkout at DIR (built there): with both, the
same numbers for another commit, such as a parent unpacked by ``git
archive``, to compare in one call. Ends with one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MAX_WARPS = 1 << 16
STEPS = 1024
STAMP_DECLS = f"""__device__ unsigned long long g_span[2 * {MAX_WARPS}];
__device__ long long g_chunk[{MAX_WARPS}];   // the chunk a warp walked last
__device__ unsigned long long g_hot[2];      // the hot chunk's warp: span
__device__ long long g_steps[2 + {STEPS}];   // steps, all, each step
__device__ long long g_parts[2 * {STEPS}];   // each step: checked, added
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
"""
STAMP_API = f"""extern "C" {{
int cm_spans(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_span, sizeof(g_span));
}}
int cm_steps(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_steps, sizeof(g_steps));
}}
int cm_parts(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_parts, sizeof(g_parts));
}}
int cm_sort_stamps(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_sort, sizeof(g_sort));
}}
int cm_sort_blocks(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_sblock, sizeof(g_sblock));
}}
int cm_chunks(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_chunk, sizeof(g_chunk));
}}
int cm_hot(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_hot, sizeof(g_hot));
}}
static int zero(const void* symbol, size_t bytes) {{
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, symbol);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, bytes));
}}
int cm_reset() {{   // every timer stamp back to 0 (0: not stamped)
  int e = zero(g_span, sizeof(g_span));
  if (e == 0) e = zero(g_hot, sizeof(g_hot));
  if (e == 0) e = zero(g_sblock, sizeof(g_sblock));
  return e;
}}
}}  // extern "C"
"""
# (old, new) text edits of csrc/row_sort.cuh: block 0 of each scatter pass
# stamps its start, the digit sums, the ranks, the prefixes over warps and
# digits (before the tuples are staged) and its end; every block of the first two passes (up to SORT_BLOCKS) its start
# and end on the global timer
SORT_BLOCKS = 1024
SORT_STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0 && pass < 2) "
              "g_sort[pass][{}] = clock64() - sts0;\n")


def sort_span(end: int) -> str:
    """A scatter block's start (0) or end (1) on the global timer."""
    return (f"if (threadIdx.x == 0 && blockIdx.x < {SORT_BLOCKS} && "
            "pass < 2) {\n"
            "    unsigned long long t;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            f"    g_sblock[pass][2 * blockIdx.x + {end}] = t;\n"
            "  }\n")


SORT_EDITS = [
    ("namespace sde {\n", "__device__ long long g_sort[2][5];\n"
     f"__device__ unsigned long long g_sblock[2][2 * {SORT_BLOCKS}];\n"
     "namespace sde {\n"),
    ("  const int g = threadIdx.x;                    // radix <= "
     "kSortThreads\n",
     "  const int g = threadIdx.x;                    // radix <= "
     "kSortThreads\n"
     "  const long long sts0 = clock64();\n"
     "  const int pass = shift == 0 ? 0 : 1;\n"
     "  " + sort_span(0)),
    ("  int x = total;                                // inclusive over the "
     "warp\n",
     "  " + SORT_STAMP.format(1) +
     "  int x = total;                                // inclusive over the "
     "warp\n"),
    ("    rank[r] = seen + __popc(below);\n  }\n  __syncthreads();\n",
     "    rank[r] = seen + __popc(below);\n  }\n  __syncthreads();\n"
     "  " + SORT_STAMP.format(2)),
    ("  __syncthreads();\n#pragma unroll\n  for (int r = 0; r < kSortItems; "
     "++r) {\n    if (dg[r] < 0) continue;\n",
     "  __syncthreads();\n  " + SORT_STAMP.format(3) +
     "#pragma unroll\n  for (int r = 0; r < kSortItems; "
     "++r) {\n    if (dg[r] < 0) continue;\n"),
    ("    perm_out[pos] = s_tix[i];\n  }\n}\n",
     "    perm_out[pos] = s_tix[i];\n  }\n"
     "  " + SORT_STAMP.format(4) + "  " + sort_span(1) + "}\n"),
]
# (old, new) text edits of csrc/countmin_scatter.cu, each found exactly once:
# every walk warp stamps its start and end (the global timer) and the chunk
# it walked last; the warp of chunk kHotChunk at depth row 0 stamps its
# steps in SM cycles and its span
STAMP_EDITS = [
    ("namespace {\n\nconstexpr int kMaxDepth", STAMP_DECLS +
     "namespace {\n\nconstexpr int kMaxDepth"),
    ("  const int lane = threadIdx.x & 31;\n"
     "  if (c0 >= len) return;                       // uniform across the "
     "warp\n",
     "  const int lane = threadIdx.x & 31;\n"
     "  const long long warp = (long long)blockIdx.x * kWalkWarps + "
     "(threadIdx.x >> 5);\n"
     "  const bool hot = c0 == 32LL * kHotChunk && j == 0;\n"
     "  const long long ts0 = clock64();\n"
     f"  if (lane == 0 && warp < {MAX_WARPS}) {{\n"
     "    g_span[2 * warp] = gtime();\n"
     "    g_chunk[warp] = c0 / 32;\n"
     "  }\n"
     "  if (hot && lane == 0) g_hot[0] = gtime();\n"
     "  if (c0 >= len) return;                       // uniform across the "
     "warp\n"),
    ("      issue(m + kRing - 1);      // into the stage step m - 1 left\n",
     "      issue(m + kRing - 1);      // into the stage step m - 1 left\n"
     f"      if (hot && lane == 0 && m < {STEPS}) "
     "g_steps[2 + m] = clock64() - ts0;\n"),
    ("        float acc = c.val;\n",
     "        float acc = c.val;\n"
     f"        if (hot && lane == 0 && m < {STEPS}) {{\n"
     "          g_parts[2 * m] = clock64() - ts0;\n"
     "        }\n"),
    ("        c.val = acc;\n",
     f"        if (hot && lane == 0 && m < {STEPS}) {{\n"
     "          asm volatile(\"\" :: \"f\"(acc));\n"
     "          g_parts[2 * m + 1] = clock64() - ts0;\n"
     "        }\n"
     "        c.val = acc;\n"),
    ("  if (c.key >= 0 && lane == 0) counts[c.key] = c.val;\n}\n",
     "  if (c.key >= 0 && lane == 0) counts[c.key] = c.val;\n"
     f"  if (lane == 0 && warp < {MAX_WARPS}) "
     "g_span[2 * warp + 1] = gtime();\n"
     "  if (hot && lane == 0) {\n"
     "    g_steps[0] = steps;\n"
     "    g_steps[1] = clock64() - ts0;\n"
     "    g_hot[1] = gtime();\n"
     "  }\n}\n"),
]


def launch_times(fn) -> dict:
    """Device ms per call of each kernel name (mean of 5 calls), in the
    order they first ran, with a pass number for the sort's launches."""
    out: dict = {}
    seen: dict = {}
    events = sorted(cs.device_events(fn, runs=5), key=lambda e: e[1])
    per_call = len(events) // 5
    for i, (name, start, end) in enumerate(events):
        short = name.split("(")[0].split("::")[-1].split("<")[0]
        k = i % per_call
        key = seen.setdefault(k, f"{k}:{short}")
        out[key] = out.get(key, 0.0) + (end - start) / 5 / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fresh", action="store_true",
                    help="the data-source fresh sketch [1, 5, 2048]")
    ap.add_argument("--launches-only", action="store_true",
                    help="the launch times alone, no stamped build")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="the checkout whose repro_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cm_walk_probe.py needs a CUDA card")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import build, onehot_matmul as om

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    cm = core.CountMin(eps=0.002, delta=0.01)
    idx = hashing.bucket_hash(b.items, cm._seeds(), cm.log2_width)
    v = b.vals * b.mask.float()
    d, w = cm.depth, cm.width
    if args.fresh:
        n, rows = 1, b.to_row0
        state0 = torch.zeros((n, d, w), device=dev)
    else:
        n, rows = 131072, b.rows
        state0 = torch.randint(0, 8, (n, d, w), generator=b.gen,
                               device=dev, dtype=torch.int32).to(
                                   torch.float32)
    want = om.onehot_scatter_add(state0.clone(), rows, idx, v)
    k = state0.clone()
    launches = launch_times(lambda: om.onehot_scatter_add(k, rows, idx, v))
    del k
    for name, ms in launches.items():
        print(f"launch {name}: {ms:.4f} ms device", flush=True)
    label = dict(src=str(args.src), fresh=args.fresh)
    if args.launches_only:
        print(json.dumps({"launch_device_ms": launches, **label}),
              flush=True)
        return

    # the walk's sorted keys (rows, or with --fresh the elements), the
    # first chunk of the hottest one, the depth rows the walk's blocks
    # cycle through and the warps before the chunks' own (the long list's)
    if args.fresh:
        keep = (v != 0).cpu().numpy()
        keys = (np.arange(d) * w + idx.cpu().numpy())[keep].reshape(-1)
        srow = np.sort(keys, kind="stable")
        hot_key = np.bincount(srow).argmax()
        hot, dd = int(np.searchsorted(srow, hot_key)) // 32, 1
        long_warps = int(re.search(r"constexpr int kLongWarps = (\d+);",
                                   (build.CSRC / "countmin_scatter.cu")
                                   .read_text()).group(1))
    else:
        srow, _ = om.sort_rows(rows, n)
        srow = srow.cpu().numpy()
        hot, dd, long_warps = 0, d, 0

    def edited(name, edits):
        text = (build.CSRC / name).read_text()
        for old, new in edits:
            cs.require(text.count(old) == 1, f"the edited text is not in "
                                             f"{name} exactly once: {old!r}")
            text = text.replace(old, new)
        return text
    text = edited("countmin_scatter.cu", STAMP_EDITS).replace(
        STAMP_DECLS, STAMP_DECLS + f"constexpr long long kHotChunk = {hot};\n")
    sort_text = edited("row_sort.cuh", SORT_EDITS)
    csrc, build_dir = build.CSRC, build.BUILD_DIR
    tmp = Path(tempfile.mkdtemp(prefix="cm_walk_"))
    try:
        build.CSRC, build.BUILD_DIR = tmp / "csrc", tmp / "build"
        build.CSRC.mkdir()
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, build.CSRC)
        (build.CSRC / "row_sort.cuh").write_text(sort_text)
        (build.CSRC / "cm_stamped.cu").write_text(text + STAMP_API)
        build.build(["cm_stamped"])
        for line in build.BUILD_LOG["cm_stamped"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas: {line.strip()}", flush=True)
        lib = build.load("cm_stamped", dict(
            om._SIGNATURES, cm_spans=(ctypes.c_void_p,),
            cm_steps=(ctypes.c_void_p,), cm_parts=(ctypes.c_void_p,),
            cm_sort_stamps=(ctypes.c_void_p,),
            cm_sort_blocks=(ctypes.c_void_p,), cm_chunks=(ctypes.c_void_p,),
            cm_hot=(ctypes.c_void_p,), cm_reset=()))
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        shutil.rmtree(tmp, ignore_errors=True)

    built = om._lib
    om._lib = lambda: lib
    runs = []
    per = int(re.search(r"constexpr int kWalkWarps = (\d+);", text).group(1))
    chunks = (b.t * (d if args.fresh else 1) + 31) // 32
    warps = (chunks + long_warps + per - 1) // per * per * dd
    try:
        for _ in range(3):
            build.check_launch(lib.cm_reset(), "cm_reset")
            got = om.onehot_scatter_add(state0.clone(), rows, idx, v)
            torch.cuda.synchronize()
            cs.require(cs.same_bytes(got, want), "the stamped build's state "
                                                 "differs from the source's")
            del got
            span = (ctypes.c_ulonglong * (2 * MAX_WARPS))()
            steps = (ctypes.c_longlong * (2 + STEPS))()
            build.check_launch(lib.cm_spans(span), "cm_spans")
            build.check_launch(lib.cm_steps(steps), "cm_steps")
            parts = (ctypes.c_longlong * (2 * STEPS))()
            build.check_launch(lib.cm_parts(parts), "cm_parts")
            sorts = (ctypes.c_longlong * 10)()
            build.check_launch(lib.cm_sort_stamps(sorts), "cm_sort_stamps")
            sblk = (ctypes.c_ulonglong * (4 * SORT_BLOCKS))()
            build.check_launch(lib.cm_sort_blocks(sblk), "cm_sort_blocks")
            nblk = min(-(-b.t * (d if args.fresh else 1) // 1024),
                       SORT_BLOCKS)
            scat = []                        # each scatter pass's blocks
            for q in range(2):
                bs = np.array(sblk[2 * SORT_BLOCKS * q:][:2 * nblk],
                              dtype=np.int64).reshape(nblk, 2)
                dur = bs[:, 1] - bs[:, 0]
                scat.append(dict(
                    blocks=nblk, kernel_ns=int(bs[:, 1].max() - bs[:, 0].min()),
                    start_spread_ns=int(bs[:, 0].max() - bs[:, 0].min()),
                    block_ns_median=float(np.median(dur)),
                    block_ns_max=int(dur.max()),
                    slowest_block=int(dur.argmax())))
            sp = np.array(span[:2 * warps], dtype=np.int64).reshape(warps, 2)
            started = sp[:, 0] > 0           # warps given a chunk
            ended = started & (sp[:, 1] > sp[:, 0])   # and reached its end
            t0 = sp[started, 0].min()
            ends = sp[ended, 1] - t0
            total = int(ends.max())
            last = int(np.nonzero(ended)[0][np.argmax(ends)])
            chunk_of = (ctypes.c_longlong * MAX_WARPS)()
            build.check_launch(lib.cm_chunks(chunk_of), "cm_chunks")
            hot_span = (ctypes.c_ulonglong * 2)()
            build.check_launch(lib.cm_hot(hot_span), "cm_hot")
            lc, lj = int(chunk_of[last]), last // per % dd
            lrow = int(srow[32 * lc])
            run = int((srow == lrow).sum())
            n_steps = int(steps[0])
            st = list(steps[2:2 + min(n_steps, STEPS)])
            gaps = [y - x for x, y in zip(st, st[1:])]
            # within a step: from its wait to the adds' start (the checks,
            # the stage writes, the carry), and the adds themselves
            pre = [parts[2 * m] - st[m] for m in range(len(st))]
            add = [parts[2 * m + 1] - parts[2 * m] for m in range(len(st))]
            quart = {f"by_{q}_of_the_kernel": float(
                (ends <= total * q / 4).mean()) for q in (1, 2, 3)}
            r = dict(warps_walked=int(ended.sum()), kernel_ns=total,
                     hot_chunk=hot,
                     hot_warp_start_ns=int(hot_span[0] - t0),
                     hot_warp_ns=int(hot_span[1] - t0),
                     hot_warp_cycles=int(steps[1]), hot_steps=n_steps,
                     before_first_step=int(st[0]) if st else None,
                     step_cycles_median=statistics.median(gaps),
                     step_cycles_min=min(gaps), step_cycles_max=max(gaps),
                     step_checks_median=statistics.median(pre),
                     step_adds_median=statistics.median(add),
                     sort_block0_stamps=[list(sorts[:5]), list(sorts[5:])],
                     sort_scatter_blocks=scat,
                     last_warp=dict(chunk=lc, depth_row=lj, row=lrow,
                                    run=run, start_ns=int(sp[last, 0] - t0),
                                    end_ns=int(sp[last, 1] - t0)),
                     **quart)
            runs.append(r)
            print(json.dumps(r), flush=True)
    finally:
        om._lib = built
    print(json.dumps({"cm_walk_probe": runs, "launch_device_ms": launches,
                      **label}), flush=True)


if __name__ == "__main__":
    main()
