#!/usr/bin/env python3
"""Lossy Counting's scan kernel (``csrc/lossy_scan.cu``) on one walk:
the device time a step of a data-source row's walk, by the path its
steps take, at several table sizes.

    python3 tools/lossy_probe.py          # needs one CUDA card

A one-row stack whose row is a data-source row walks every tuple of a
batch of T = 65,536 (all masked in, none routed), as chip_smoke's data-
source Lossy rows do. Item patterns: ``hits`` (one item: every step after
the first hits), ``evictions`` (distinct items: every step after the
first k evicts) and ``zipf`` (chip_smoke's phase-2 mix: Zipf(1.1) over
65,536 ids, 10% unique ids). For each k and pattern it prints the walk
kernel's device time (``torch.profiler``, mean of 5 calls on the state
the first call left) and the cycles a step at the card's top SM clock,
and with ``--sass DIR`` writes the walk kernel's SASS (``cuobjdump``)
to DIR.
"""
from __future__ import annotations

import argparse
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
from probe_build import card_line                        # noqa: E402

T = 65536


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="4,20,32,100,1000")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lossy_probe.py needs a CUDA card")
    card_line()
    dev = torch.device("cuda", 0)
    build.build(["lossy_scan"])
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        out = subprocess.run([tool, "-sass", str(build.lib_path(
            "lossy_scan"))], capture_output=True, text=True)
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        (Path(args.sass) / "lossy_scan.sass").write_text(out.stdout)
        print(f"[sass] {len(out.stdout.splitlines())} lines to {args.sass}",
              flush=True)
    _, mhz = cs.chain_floor_ms(1)
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
            st = batched.stacked_init(kind, 1, dev)
            fn = lambda: lossy_scan.lossy_scan_update(
                st["keys"], st["counts"], st["error"], rows, items, vals,
                mask, src)
            split = cs.device_split(fn, {"walk_kernel": "walk"}, "other")
            walk = split["walk"]
            print(f"[probe] {pattern:9s} k={kind.k:5d}: walk {walk:.4f} ms "
                  f"device, {walk * 1e-3 * mhz * 1e6 / T:.1f} cycles a step "
                  f"at {mhz:.0f} MHz; other launches {split.get('other', 0):.4f}"
                  f" ms", flush=True)


if __name__ == "__main__":
    main()
