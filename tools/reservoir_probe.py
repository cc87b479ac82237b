#!/usr/bin/env python3
"""Where the reservoir kernel's time goes: its device time at phase 2's
shapes, split by phase, beside another checkout's build.

    python3 tools/reservoir_probe.py            # needs one CUDA card and nvcc
    python3 tools/reservoir_probe.py --src build/parent

Builds ``csrc/reservoir_scan.cu`` of this checkout, a copy of it that
stamps ``%globaltimer`` at the kernel's start, at each grid barrier's
arrival and departure and at its end (thread 0 of every block), and the
source of every checkout given by ``--src`` (such as a parent unpacked
by ``git archive``). All are built with ``nvcc`` at once into a
temporary directory and timed in one process on chip_smoke's phase-2
batch (131,072 rows, 65,536 Zipf(1.1) tuples of seed 0, one data-source
row), from empty rows and from rows past the fill, through the
rows-given entry and, where the build has it, the fused one. Every
build's state must equal the plain version's bytes. A reading is the
build's device time a call from ``torch.profiler`` (its kernels and
memsets, not the restore copy; mean of ``RUNS`` calls, each on the
starting state restored before it); each case runs the builds in the
order given and then in reverse.

The split (the stamped build, mean of ``RUNS`` calls): for each phase,
from the last block's departure from the barrier before it (the kernel's
start for the first) to the last block's arrival at the barrier after it
(the kernel's end for the last), and each barrier's release, from the
last arrival to the last departure, in microseconds.

Ends with one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import probe_build as pb  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import build, ref, reservoir_scan  # noqa: E402

RUNS = 10
CSRC = Path("src/repro_torch/kernels/csrc")
STAMPS = 16                     # stamp slots a block
PHASES = ("A keys", "S pass 1", "H pass 2", "S pass 2", "P place",
          "G last writers")

# the kernel's grid barriers, each stamped at its arrival and departure
SYNC = "grid.sync();"
STAMPED_SYNC = "sde_sync(grid);"
STAMP_EDITS = [
    ('#include "row_sort.cuh"\n',
     '#include "row_sort.cuh"\n\n'
     '__device__ unsigned long long sde_stamp[4096 * 16];\n'
     '__shared__ int sde_k;\n'
     '__device__ __forceinline__ unsigned long long sde_now() {\n'
     '  unsigned long long t;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     '  return t;\n'
     '}\n\n'
     'template <class G>\n'
     '__device__ __forceinline__ void sde_sync(G& grid) {\n'
     '  __syncthreads();\n'
     '  if (threadIdx.x == 0)\n'
     '    sde_stamp[blockIdx.x * 16 + 1 + 2 * sde_k] = sde_now();\n'
     '  grid.sync();\n'
     '  if (threadIdx.x == 0) {\n'
     '    sde_stamp[blockIdx.x * 16 + 2 + 2 * sde_k] = sde_now();\n'
     '    ++sde_k;\n'
     '  }\n'
     '}\n'),
    ("  const long long gthreads = (long long)gridDim.x * kThreads;\n",
     "  const long long gthreads = (long long)gridDim.x * kThreads;\n"
     "  if (threadIdx.x == 0) {\n"
     "    sde_k = 0;\n"
     "    sde_stamp[blockIdx.x * 16] = sde_now();\n"
     "  }\n"),
    ("                                (unsigned)__ldcg(p.tile_off + "
     "p.tiles));\n      }\n    }\n  }\n}\n",
     "                                (unsigned)__ldcg(p.tile_off + "
     "p.tiles));\n      }\n    }\n  }\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) sde_stamp[blockIdx.x * 16 + 15] = sde_now();\n"
     "}\n"),
    ('extern "C" {\n',
     'extern "C" {\n\n'
     'int reservoir_stamps(unsigned long long* out, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, sde_stamp, '
     'sizeof(unsigned long long) * n);\n'
     '}\n'),
]


def stamped(text: str) -> str:
    """``text`` with every grid barrier and the kernel's start and end
    stamped."""
    cs.require(text.count(SYNC) == 4,
               f"reservoir_scan.cu holds {text.count(SYNC)} {SYNC!r}, not 4")
    return pb.edited("stamps", "reservoir_scan",
                     text.replace(SYNC, STAMPED_SYNC), STAMP_EDITS)


def sources(args) -> dict:
    """label -> (source name, text, header directory)."""
    text = (ROOT / CSRC / "reservoir_scan.cu").read_text()
    srcs = {"this": ("reservoir_scan", text, ROOT / CSRC),
            "stamps": ("reservoir_stamps", stamped(text), ROOT / CSRC)}
    for d in args.src:          # its own name: it may lack the fused entry
        srcs[str(d)] = ("reservoir_other",
                        (d / CSRC / "reservoir_scan.cu").read_text(), d / CSRC)
    return srcs


def device_ms(fn, restore) -> float:
    """Device ms a call of ``fn`` (every activity but the restore copy and
    the window's pad), each call after ``restore()``; a window that lost
    calls is taken again."""
    for _ in range(cs.WINDOW_TRIES):
        spans = cs.device_events(lambda: (restore(), fn()), runs=RUNS,
                                 pad=cs.PAD_LAUNCHES)
        mine = [(n, s, e) for n, s, e in spans if "Memcpy" not in n]
        if sum("Memcpy" in n for n, _, _ in spans) == RUNS:
            return sum(e - s for _, s, e in mine) / RUNS / 1e3
    raise RuntimeError("no profiler window held every call")


def split_us(stamps, blocks: int, barriers: int) -> dict:
    """Phase and barrier times, microseconds, from one call's stamps."""
    rows = [stamps[b * STAMPS:(b + 1) * STAMPS] for b in range(blocks)]
    arrive = [max(r[1 + 2 * k] for r in rows) for k in range(barriers)]
    leave = [max(r[2 + 2 * k] for r in rows) for k in range(barriers)]
    start = min(r[0] for r in rows)
    end = max(r[15] for r in rows)
    out, before = {}, start
    for k in range(barriers):
        out[PHASES[k]] = (arrive[k] - before) / 1e3
        out[f"barrier {k + 1}"] = (leave[k] - arrive[k]) / 1e3
        before = leave[k]
    out[PHASES[barriers]] = (end - before) / 1e3
    out["kernel"] = (end - start) / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, action="append", default=[],
                    help="another checkout whose reservoir kernel is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("reservoir_probe.py needs a CUDA card")
    pb.card_line()
    dev = torch.device("cuda", 0)
    srcs = sources(args)
    sigs = dict(reservoir_scan._SIGNATURES)
    rows_given = {k: sigs[k] for k in ("reservoir_words", "reservoir_scan")}
    built = pb.build_all(srcs, {
        "reservoir_scan": sigs, "reservoir_other": rows_given,
        "reservoir_stamps": dict(sigs, reservoir_stamps=(ctypes.c_void_p,
                                                          ctypes.c_int))},
        "reservoir_probe_")
    libs = {lb: lib for lb, (lib, _) in built.items()}
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    kind = core.ReservoirSampler()
    n, s, t = 131072, kind.sample_size, b.t
    src = torch.tensor([n // 2], dtype=torch.int64, device=dev)
    stream = build.stream(dev)
    scratch = {}
    for lb, lib in libs.items():
        words = ctypes.c_longlong(0)
        build.check_launch(lib.reservoir_words(n, s, t, 1,
                                               ctypes.addressof(words)), lb)
        scratch[lb] = torch.zeros(words.value, dtype=torch.int32, device=dev)

    def call(lb, st, fused):
        lib = libs[lb]
        head = (st["values"].data_ptr(), st["items"].data_ptr(),
                st["n_seen"].data_ptr(), n, s)
        tail = (b.items.data_ptr(), b.vals.data_ptr(), b.mask.data_ptr(), t,
                src.data_ptr(), 1, kind.seed, scratch[lb].data_ptr(), stream)
        if fused:
            err = lib.reservoir_probe_scan(
                *head, b.klo.data_ptr(), b.khi.data_ptr(), b.trows.data_ptr(),
                b.klo.shape[0], b.slo.data_ptr(), b.shi.data_ptr(),
                b.n_probe, *tail)
        else:
            err = lib.reservoir_scan(*head, b.rows.data_ptr(), *tail)
        build.check_launch(err, lb)

    results = []
    for label in ("empty", "past_fill"):
        buf0, st0 = cs.reservoir_stack(n, s, dev)
        if label == "past_fill":
            st0["n_seen"].random_(s, 1 << 20, generator=b.gen)
            st0["items"].random_(-(1 << 31), 1 << 31, generator=b.gen)
            st0["values"].normal_(generator=b.gen)
        pbuf, pst = cs.reservoir_stack(n, s, dev)
        pbuf.copy_(buf0)
        ref.reservoir_scan_update(pst["values"], pst["items"], pst["n_seen"],
                                  b.rows, b.items, b.vals, b.mask, src,
                                  seed=kind.seed)
        kbuf, kst = cs.reservoir_stack(n, s, dev)
        for fused in (False, True):
            labels = [lb for lb in libs
                      if not fused or built[lb][1] != "reservoir_other"]
            ms = {lb: [] for lb in labels}
            for order in (labels, labels[::-1]):
                for lb in order:
                    kbuf.copy_(buf0)
                    call(lb, kst, fused)
                    torch.cuda.synchronize()
                    cs.require(torch.equal(kbuf, pbuf),
                               f"{lb} ({label}, fused={fused}) differs "
                               f"byte-wise from the plain version")
                    ms[lb].append(device_ms(lambda: call(lb, kst, fused),
                                            lambda: kbuf.copy_(buf0)))
            case = f"{label}{'/fused' if fused else ''}"
            print(f"{case}: device ms a call (forward / reverse order): "
                  + ", ".join(f"{lb} {v[0]:.4f} / {v[1]:.4f}"
                              for lb, v in ms.items()), flush=True)
            # the split, from the stamped build
            blocks = min(torch.cuda.get_device_properties(dev)
                         .multi_processor_count, 2 * ((t + 511) // 512))
            barriers = 5
            acc: dict = {}
            host = (ctypes.c_ulonglong * (blocks * STAMPS))()
            for _ in range(RUNS):
                kbuf.copy_(buf0)
                call("stamps", kst, fused)
                torch.cuda.synchronize()
                build.check_launch(libs["stamps"].reservoir_stamps(
                    host, blocks * STAMPS), "stamps")
                for k, v in split_us(list(host), blocks, barriers).items():
                    acc[k] = acc.get(k, 0.0) + v / RUNS
            print(f"{case}: split (us, stamps, {blocks} blocks): " + ", ".join(
                f"{k} {v:.2f}" for k, v in acc.items()), flush=True)
            results.append(dict(case=case, device_ms=ms, split_us=acc))
        del buf0, st0, pbuf, pst, kbuf, kst
        cs.free()
    print(json.dumps({"reservoir_probe": results, "runs": RUNS}), flush=True)


if __name__ == "__main__":
    main()
