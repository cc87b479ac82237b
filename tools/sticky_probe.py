#!/usr/bin/env python3
"""The sticky-scan kernel (``csrc/sticky_scan.cu``) at chip_smoke phase
2's shapes, its walks taken apart: the device time of a whole call, of
its data-source walk alone and of its routed walks alone, beside other
checkouts of the kernel.

    python3 tools/sticky_probe.py                        # one CUDA card
    python3 tools/sticky_probe.py --src build/parent --src build/d1

Phase 2's batch (T = 65,536 Zipf(1.1) tuples, 131,072 rows, data-source
row 65,536) updates a Sticky stack at 288 and at 4,096 slots, from empty
tables, empty tables but for one key no tuple holds (``foreign_key``),
the tables STICKY_PAST_BATCHES batches leave (``past_plain``), their
counts with every key emptied (``past_no_keys``) and chip_smoke's "past a
few epochs" state, those tables with counts set so that rows bump
(``chip_smoke.sticky_bump_state``).
Variants: ``whole`` (the call as chip_smoke times it), ``source`` (every
row -1: the key pass, the sort and the source block's walk) and
``routed`` (no source row: the routed walks). Each is timed by CUDA
events around calls queued behind a spin kernel
(``chip_smoke.queued_device_ms``, median of 5), each call on the state
restored before it, for this checkout's build and each ``--src``
checkout's (such as a parent unpacked by ``git archive``; its library is
called through the same C interface). Every build's result must equal
this checkout's byte for byte. Then this checkout's whole call by kernel
(``chip_smoke.kernel_split``) and the ptxas lines of every build.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch            # noqa: E402

import chip_smoke as cs                                  # noqa: E402
from repro_torch import core                             # noqa: E402
from repro_torch.kernels import build, sticky_scan       # noqa: E402
from probe_build import build_all, card_line             # noqa: E402

CSRC = Path("src/repro_torch/kernels/csrc")


def caller(lib):
    """A rows-given update through a built library's C interface."""
    def update(st, rows, items, mask, src, kind):
        keys, counts, n_seen, epoch = cs.sticky_leaves(st)
        n, cap = keys.shape
        t = rows.shape[0]
        dev = keys.device
        scratch = sticky_scan._scratch(dev, n, t)
        err = lib.sticky_scan(
            keys.data_ptr(), counts.data_ptr(), n_seen.data_ptr(),
            epoch.data_ptr(), n, cap, rows.data_ptr(), items.data_ptr(),
            mask.data_ptr(), t, build.ptr(src),
            0 if src is None else src.shape[0],
            sticky_scan._tables(dev, cap).data_ptr(),
            sticky_scan._mix(kind.seed), sticky_scan._mix(kind.seed + 1),
            scratch.data_ptr(), build.stream(dev))
        build.check_launch(err, "sticky_scan")
    return update


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sticky_probe.py needs a CUDA card")
    card_line()
    dev = torch.device("cuda", 0)
    srcs = {"this": ("sticky_scan", (ROOT / CSRC / "sticky_scan.cu")
                     .read_text(), ROOT / CSRC)}
    for s in args.src:
        d = s.resolve() / CSRC
        srcs[s.name] = ("sticky_scan", (d / "sticky_scan.cu").read_text(), d)
    sigs = {"sticky_scan": {f: sticky_scan._SIGNATURES[f]
                            for f in ("sticky_words", "sticky_scan")}}
    libs = build_all(srcs, sigs, "sticky_probe_")
    updates = {label: caller(lib) for label, (lib, _) in libs.items()}
    n, n_streams, t = 131072, 65536, 65536
    b = cs.phase2_batch(dev, 0, n_streams, t)
    src_row = n // 2
    src = torch.tensor([src_row], dtype=torch.int32, device=dev)
    none = torch.full_like(b.rows, -1)
    variants = {"whole": (b.rows, src), "source": (none, src),
                "routed": (b.rows, None)}
    for params in (cs.STICKY_PARAMS, cs.STICKY_CAP4096_PARAMS):
        kind = core.StickySampling(**params)
        cap = kind.capacity
        buf0, st0 = cs.sticky_stack(n, cap, dev)
        for label in ("empty", "foreign_key", "past_plain", "past_no_keys",
                      "past_epochs"):
            if label == "foreign_key":      # slot 0 of every row: an item
                st0["keys"][:, 0] = -5      # the batch never holds
                st0["counts"][:, 0] = 1.0
            if label == "past_plain":
                buf0.zero_()
                st0["keys"].fill_(-1)
                for _ in range(cs.STICKY_PAST_BATCHES):
                    updates["this"](st0, b.rows, b.items, b.mask, src, kind)
                keys_past = st0["keys"].clone()
            if label == "past_no_keys":     # past_plain's counts, no key
                st0["keys"].fill_(-1)
            if label == "past_epochs":
                st0["keys"].copy_(keys_past)
                cs.sticky_bump_state(kind, st0, b, n, src_row)
            buf, st = cs.sticky_stack(n, cap, dev)
            restore = lambda: buf.copy_(buf0)
            for vname, (rows, vsrc) in variants.items():
                want = None
                for build_label, update in updates.items():
                    kern = lambda: update(st, rows, b.items, b.mask, vsrc,
                                          kind)
                    restore()
                    kern()
                    torch.cuda.synchronize()
                    if want is None:
                        want = buf.clone()
                    cs.require(torch.equal(buf, want),
                               f"{build_label} ({vname}, {label}, capacity "
                               f"{cap}) differs from this checkout's build")
                    ms = cs.queued_device_ms(kern, restore)
                    print(f"[sticky] capacity {cap} {label:13s} {vname:6s} "
                          f"{build_label:8s} {ms:.4f} ms device", flush=True)
            whole = lambda: updates["this"](st, b.rows, b.items, b.mask, src,
                                            kind)
            split = cs.kernel_split(whole, restore, cs.STICKY_SPLIT)
            print(f"[sticky] capacity {cap} {label} whole, by kernel: "
                  f"{ {k: round(v, 4) for k, v in split.items()} }",
                  flush=True)
            del buf, st
        del buf0, st0
        cs.free()


if __name__ == "__main__":
    main()
