#!/usr/bin/env python3
"""The GK requantize kernel (``csrc/gk_requantize.cu``) at chip_smoke
phase 2's shapes, by pass and by row class, beside other checkouts of the
kernel and with each step of its design taken out; and the share of rows
each of its checks sends where.

    python3 tools/gk_probe.py                        # one CUDA card
    python3 tools/gk_probe.py --src build/parent     # a parent checkout

Phase 2's batch (T = 65,536 Zipf(1.1) tuples over 131,072 rows, the
data-source row 65,536, N(0, 10) values) requantizes a GK stack at m = 400
from chip_smoke's three starts: empty rows, the idle state
(``chip_smoke.gk_idle_state``) and that state with half its rows out of
order (``chip_smoke.gk_unsorted_state``). Row classes are variants of the
batch: ``whole`` (the call as chip_smoke times it), ``no_tuples`` (every
tuple unrouted: no row but the data-source one takes a tuple) and
``no_source`` (no data-source row). Builds: this checkout's, each
``--src`` checkout's (such as a parent unpacked by ``git archive``,
called through the same C interface) and this source with one design
step taken out (DESIGNS). Each is timed by CUDA events around calls
queued behind a spin (``chip_smoke.queued_device_ms``, median of 5) on
the state restored before each call, and every build's result must equal
this checkout's byte for byte. Then this checkout's whole call by kernel
(``chip_smoke.kernel_split``), the ptxas lines of every build, and the
rows each check sent where (:func:`paths`, the kernel's own counts) on
phase 2's starts and on phase 3's values (the batch's integers 1 to 4)
over PHASE3_BATCHES batches from empty rows, and on phase 3c's values
(70% N(0, 10), 30% lognormal(3, 1)) over CONT_BATCHES batches from empty
rows, the last one also timed and split by kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch            # noqa: E402

import chip_smoke as cs                                  # noqa: E402
from repro_torch import core                             # noqa: E402
from repro_torch.core import gk                          # noqa: E402
from repro_torch.kernels import build, gk_requantize     # noqa: E402
from probe_build import build_all, card_line, edited     # noqa: E402

CSRC = Path("src/repro_torch/kernels/csrc")
PHASE3_BATCHES = 6
CONT_BATCHES = 4
# design step -> the edits of this source that take it out
DESIGNS = {
    "sort_always": [("    if (__syncthreads_and(in_order)) return false;",
                     "    if (false && __syncthreads_and(in_order)) "
                     "return false;")],
    "no_warp": [("  bool general = (a.T > 0 && a.run_end[r] != "
                 "a.run_start[r]) ||",
                 "  bool general = true || (a.T > 0 && a.run_end[r] != "
                 "a.run_start[r]) ||")],
    "halvings": [("  bool ok = total >= 0.0f;", "  bool ok = false;")],
}


def caller(lib):
    """A rows-given update through a built library's C interface (the
    wrapper's batch order and scratch, sized by that library); returns
    the scratch."""
    def update(values, n, rows, vals, mask, src, m):
        count, t = values.shape[0], vals.shape[0]
        words, most = ctypes.c_longlong(0), ctypes.c_int(0)
        build.check_launch(lib.gk_words(count, m, t, ctypes.addressof(words),
                                        ctypes.addressof(most)), "gk_words")
        key = (((~mask).to(torch.int64) << 32)
               | (gk.sort_key(vals).to(torch.int64) + (1 << 31)))
        order = torch.sort(key, stable=True).indices.to(torch.int32)
        nmask = mask.sum(dtype=torch.int32).reshape(1)
        scratch = torch.empty((words.value,), dtype=torch.int32,
                              device=values.device)
        err = lib.gk_requantize(
            values.data_ptr(), n.data_ptr(), count, m, rows.data_ptr(),
            vals.data_ptr(), mask.data_ptr(), t, order.data_ptr(),
            nmask.data_ptr(), build.ptr(src),
            0 if src is None else src.shape[0], scratch.data_ptr(),
            build.stream(values.device))
        build.check_launch(err, "gk_requantize")
        return scratch
    return update


def paths(scratch: torch.Tensor, rows: int) -> dict:
    """The rows each of the kernel's checks sent where on the call that
    used ``scratch``, from the kernel's own counts in its first words
    (``gk_requantize``'s comment in the source): to the big-row pass, to
    a warp (no tuple, state in order) or to a block; of the block rows,
    those in order (no sort); of each, those that rose (the sweep)."""
    _, big, listed, warp_h, block_h, sorted_ = scratch[:6].tolist()
    warp, block = rows - listed, listed - big
    return dict(rows=rows, big=big, warp=warp, block=block,
                block_in_order=block - sorted_, warp_rise=warp - warp_h,
                block_rise=block - block_h)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gk_probe.py needs a CUDA card")
    card_line()
    dev = torch.device("cuda", 0)
    text = (ROOT / CSRC / "gk_requantize.cu").read_text()
    srcs = {"this": ("gk_requantize", text, ROOT / CSRC)}
    for s in args.src:
        d = s.resolve() / CSRC
        srcs[s.name] = ("gk_requantize", (d / "gk_requantize.cu")
                        .read_text(), d)
    for label, edits in DESIGNS.items():
        srcs[label] = ("gk_requantize",
                       edited(label, "gk_requantize", text, edits),
                       ROOT / CSRC)
    sigs = {"gk_requantize": {f: gk_requantize._SIGNATURES[f]
                              for f in ("gk_words", "gk_requantize")}}
    libs = build_all(srcs, sigs, "gk_probe_")
    updates = {label: caller(lib) for label, (lib, _) in libs.items()}
    this = updates["this"]
    n, n_streams, t = 131072, 65536, 65536
    b = cs.phase2_batch(dev, 0, n_streams, t)
    kind = core.GKQuantiles()
    m = kind.m
    src = torch.tensor([n // 2], dtype=torch.int64, device=dev)
    gvals = torch.randn(t, generator=b.gen, device=dev) * 10
    none = torch.full_like(b.rows, -1)
    variants = {"whole": (b.rows, src), "no_tuples": (none, src),
                "no_source": (b.rows, None)}
    starts = {"empty": cs.gk_stack(n, m, dev)[0],
              "idle": cs.gk_idle_state(kind, b, n, src)}
    starts["unsorted"] = cs.gk_unsorted_state(starts["idle"], n, m, b.gen)
    buf, st = cs.gk_stack(n, m, dev)
    leaves = (st["values"], st["n"])
    for label, buf0 in starts.items():
        restore = lambda: buf.copy_(buf0)
        for vname, (rows, vsrc) in variants.items():
            restore()
            got = paths(this(*leaves, rows, gvals, b.mask, vsrc, m), n)
            print(f"[gk] {label:8s} {vname:9s} rows by check: {got}",
                  flush=True)
            want = None
            for build_label, update in updates.items():
                kern = lambda: update(*leaves, rows, gvals, b.mask, vsrc, m)
                restore()
                kern()
                torch.cuda.synchronize()
                if want is None:
                    want = buf.clone()
                cs.require(torch.equal(buf.view(torch.int32),
                                       want.view(torch.int32)),
                           f"{build_label} ({vname}, {label}) differs from "
                           f"this checkout's build")
                ms = cs.queued_device_ms(kern, restore)
                print(f"[gk] {label:8s} {vname:9s} {build_label:12s} "
                      f"{ms:.4f} ms device", flush=True)
        whole = lambda: gk_requantize.gk_requantize_update(
            *leaves, b.rows, gvals, b.mask, src, m=m)
        split = cs.kernel_split(whole, restore, cs.GK_SPLIT)
        print(f"[gk] {label} whole, by kernel: "
              f"{ {k: round(v, 4) for k, v in split.items()} }", flush=True)
    buf.zero_()
    for i in range(PHASE3_BATCHES):
        perm = torch.randperm(t, generator=b.gen, device=dev)
        rows, vals, mask = b.rows[perm], b.vals[perm], b.mask[perm]
        got = paths(this(*leaves, rows, vals, mask, src, m), n)
        print(f"[gk] phase 3's values, batch {i + 1} of {PHASE3_BATCHES}: "
              f"rows by check: {got}", flush=True)
    buf.zero_()
    for i in range(CONT_BATCHES):
        perm = torch.randperm(t, generator=b.gen, device=dev)
        rows, mask = b.rows[perm], b.mask[perm]
        u = torch.rand(t, generator=b.gen, device=dev)
        vals = torch.where(
            u < 0.3, torch.exp(3 + torch.randn(t, generator=b.gen,
                                               device=dev)),
            torch.randn(t, generator=b.gen, device=dev) * 10)
        kern = lambda: gk_requantize.gk_requantize_update(
            *leaves, rows, vals, mask, src, m=m)
        if i == CONT_BATCHES - 1:
            start = buf.clone()
            restore = lambda: buf.copy_(start)
            ms = cs.queued_device_ms(kern, restore)
            split = cs.kernel_split(kern, restore, cs.GK_SPLIT)
            print(f"[gk] phase 3c's values, batch {i + 1}: {ms:.4f} ms "
                  f"device; by kernel "
                  f"{ {k: round(v, 4) for k, v in split.items()} }",
                  flush=True)
            restore()
        got = paths(this(*leaves, rows, vals, mask, src, m), n)
        print(f"[gk] phase 3c's values, batch {i + 1} of {CONT_BATCHES}: "
              f"rows by check: {got}", flush=True)
    cs.free()


if __name__ == "__main__":
    main()
