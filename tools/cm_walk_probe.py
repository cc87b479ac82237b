#!/usr/bin/env python3
"""Where the CountMin main path's time goes: each launch, and the walk.

    python3 tools/cm_walk_probe.py      # needs one CUDA card and nvcc

On chip_smoke's phase-2 batch (65,536 Zipf(1.1) tuples, CountMin
[131,072, 5, 2048]):

  * the device time of each launch of one ``onehot_scatter_add`` call
    (``torch.profiler``, mean of 5 calls), in launch order: the memset of
    the sort's sums, the row sort's histogram and scatter of each pass,
    the gather and the walk;
  * a stamped build of ``csrc/countmin_scatter.cu`` and
    ``csrc/row_sort.cuh`` (text edits of copies, built in a temporary
    directory): every walk warp records its start and end on the global
    timer (ns); the warp of the hot run's first chunk at depth row 0
    records the SM cycles from its start to each of its first 1,024 ring
    steps, to the start and the end of each step's adds, and to its end;
    block 0 of each sort scatter pass records the cycles to its digit
    sums, its ranks, its warps' prefix and its end. It prints the hot
    warp's cycles a step (median, min, max) and their split (from the
    step's wait to its adds, the adds), when the warps end (the hot warp,
    the last one with its chunk, depth row and run, and the share of
    warps ended by each quarter of the kernel), and the scatter stamps.
    The stamped build's state must equal the wrapper's own build's bytes.

Ends with one JSON line.
"""
from __future__ import annotations

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
}}  // extern "C"
"""
# (old, new) text edits of csrc/row_sort.cuh: block 0 of each scatter pass
# stamps its start, the digit sums, the ranks, the warps' prefix and its end
SORT_STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0 && pass < 2) "
              "g_sort[pass][{}] = clock64() - sts0;\n")
SORT_EDITS = [
    ("namespace sde {\n", "__device__ long long g_sort[2][5];\n"
     "namespace sde {\n"),
    ("  const int g = threadIdx.x;                    // radix <= "
     "kSortThreads\n",
     "  const int g = threadIdx.x;                    // radix <= "
     "kSortThreads\n"
     "  const long long sts0 = clock64();\n"
     "  const int pass = shift == 0 ? 0 : 1;\n"),
    ("  int x = total;                                // inclusive over the "
     "warp\n",
     "  " + SORT_STAMP.format(1) +
     "  int x = total;                                // inclusive over the "
     "warp\n"),
    ("    rank[r] = seen + __popc(below);\n  }\n  __syncthreads();\n",
     "    rank[r] = seen + __popc(below);\n  }\n  __syncthreads();\n"
     "  " + SORT_STAMP.format(2)),
    ("      run += c;\n    }\n  }\n  __syncthreads();\n",
     "      run += c;\n    }\n  }\n  __syncthreads();\n"
     "  " + SORT_STAMP.format(3)),
    ("    perm_out[pos] = tix[r];\n  }\n}\n",
     "    perm_out[pos] = tix[r];\n  }\n"
     "  " + SORT_STAMP.format(4) + "}\n"),
]
# (old, new) text edits of csrc/countmin_scatter.cu, each found exactly once
STAMP_EDITS = [
    ("namespace {\n\nconstexpr int kThreads", STAMP_DECLS +
     "namespace {\n\nconstexpr int kThreads"),
    ("  if (c0 >= chunks * 32) return;               // uniform across the "
     "warp\n",
     "  if (c0 >= chunks * 32) return;               // uniform across the "
     "warp\n"
     "  const long long warp = (long long)blockIdx.x * kWalkWarps + wib;\n"
     "  const long long ts0 = clock64();\n"
     f"  if (lane == 0 && warp < {MAX_WARPS}) g_span[2 * warp] = gtime();\n"),
    ("      issue(m + kRing - 1);      // into the stage step m - 1 left\n",
     "      issue(m + kRing - 1);      // into the stage step m - 1 left\n"
     f"      if (warp == 0 && lane == 0 && m < {STEPS}) "
     "g_steps[2 + m] = clock64() - ts0;\n"),
    ("        float acc = c.val;\n",
     "        float acc = c.val;\n"
     f"        if (warp == 0 && lane == 0 && m < {STEPS}) {{\n"
     "          g_parts[2 * m] = clock64() - ts0;\n"
     "        }\n"),
    ("        c.val = acc;\n",
     f"        if (warp == 0 && lane == 0 && m < {STEPS}) {{\n"
     "          asm volatile(\"\" :: \"f\"(acc));\n"
     "          g_parts[2 * m + 1] = clock64() - ts0;\n"
     "        }\n"
     "        c.val = acc;\n"),
    ("  if (c.key >= 0 && lane == 0) counts[c.key] = c.val;\n}\n",
     "  if (c.key >= 0 && lane == 0) counts[c.key] = c.val;\n"
     f"  if (lane == 0 && warp < {MAX_WARPS}) "
     "g_span[2 * warp + 1] = gtime();\n"
     "  if (warp == 0 && lane == 0) {\n"
     "    g_steps[0] = steps;\n"
     "    g_steps[1] = clock64() - ts0;\n"
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
    if not torch.cuda.is_available():
        raise SystemExit("cm_walk_probe.py needs a CUDA card")
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import build, onehot_matmul as om

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    def edited(name, edits):
        text = (build.CSRC / name).read_text()
        for old, new in edits:
            cs.require(text.count(old) == 1, f"the edited text is not in "
                                             f"{name} exactly once: {old!r}")
            text = text.replace(old, new)
        return text
    text = edited("countmin_scatter.cu", STAMP_EDITS)
    sort_text = edited("row_sort.cuh", SORT_EDITS)
    dev = torch.device("cuda", 0)
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    cm = core.CountMin(eps=0.002, delta=0.01)
    idx = hashing.bucket_hash(b.items, cm._seeds(), cm.log2_width)
    v = b.vals * b.mask.float()
    n, d = 131072, cm.depth
    state0 = torch.randint(0, 8, (n, d, cm.width), generator=b.gen,
                           device=dev, dtype=torch.int32).to(torch.float32)
    want = om.onehot_scatter_add(state0.clone(), b.rows, idx, v)
    k = state0.clone()
    launches = launch_times(lambda: om.onehot_scatter_add(k, b.rows, idx, v))
    del k
    for name, ms in launches.items():
        print(f"launch {name}: {ms:.4f} ms device", flush=True)

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
            cm_sort_stamps=(ctypes.c_void_p,)))
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        shutil.rmtree(tmp, ignore_errors=True)

    built = om._lib
    om._lib = lambda: lib
    runs = []
    per = int(re.search(r"constexpr int kWalkWarps = (\d+);", text).group(1))
    chunks = (b.t + 31) // 32
    warps = (chunks + per - 1) // per * per * d   # block B: chunks per B / d ..
    srow, _ = om.sort_rows(b.rows, n)
    srow = srow.cpu().numpy()
    try:
        for _ in range(3):
            got = om.onehot_scatter_add(state0.clone(), b.rows, idx, v)
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
            sp = np.array(span[:2 * warps], dtype=np.int64).reshape(warps, 2)
            ended = sp[:, 1] > sp[:, 0]      # warps that reached the end
            t0 = sp[:, 0].min()
            ends = sp[ended, 1] - t0
            total = int(ends.max())
            last = int(np.nonzero(ended)[0][np.argmax(ends)])
            lc, lj = last // per // d * per + last % per, last // per % d
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
                     hot_warp_ns=int(sp[0, 1] - t0),
                     hot_warp_cycles=int(steps[1]), hot_steps=n_steps,
                     before_first_step=int(st[0]) if st else None,
                     step_cycles_median=statistics.median(gaps),
                     step_cycles_min=min(gaps), step_cycles_max=max(gaps),
                     step_checks_median=statistics.median(pre),
                     step_adds_median=statistics.median(add),
                     sort_block0_stamps=[list(sorts[:5]), list(sorts[5:])],
                     last_warp=dict(chunk=lc, depth_row=lj, row=lrow,
                                    run=run, start_ns=int(sp[last, 0] - t0),
                                    end_ns=int(sp[last, 1] - t0)),
                     **quart)
            runs.append(r)
            print(json.dumps(r), flush=True)
    finally:
        om._lib = built
    print(json.dumps({"cm_walk_probe": runs, "launch_device_ms": launches}),
          flush=True)


if __name__ == "__main__":
    main()
