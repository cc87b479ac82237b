#!/usr/bin/env python3
"""The device time of the kernels that share the row sort
(``csrc/row_sort.cuh``), in one checkout: run it for two commits in
alternating order to compare them in one call.

    python3 tools/sort_users_probe.py                  # needs one CUDA card
    python3 tools/sort_users_probe.py --src build/parent

``--src DIR`` takes ``repro_torch`` from the checkout at DIR (its kernels
built there), such as a parent unpacked by ``git archive``. On
chip_smoke's phase-2 batch (seed 0: 65,536 Zipf(1.1) tuples routed into
n = 131,072 rows) it times, each the mean device time of 5 calls
(``torch.profiler``, every activity of the call) on the state the call
before it left:

  * ``sort_rows``: the row sort alone (its memset and digit passes);
  * ``onehot_scatter_add``: CountMin [n, 5, 2048] on the routed rows;
  * ``lossy_scan``: Lossy Counting [n, 100] (eps 0.01) on the routed
    rows and one data-source row, every call's sort, walk and memsets.

Ends with one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

N = 131072


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="the checkout whose repro_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sort_users_probe.py needs a CUDA card")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    from repro_torch import core
    from repro_torch.core import batched, hashing
    from repro_torch.kernels import lossy_scan, onehot_matmul as om
    from probe_build import card_line      # imports repro_torch: after DIR

    card_line()
    dev = torch.device("cuda", 0)
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    cm = core.CountMin(eps=0.002, delta=0.01)
    idx = hashing.bucket_hash(b.items, cm._seeds(), cm.log2_width)
    v = b.vals * b.mask.float()
    counts = torch.zeros((N, cm.depth, cm.width), device=dev)
    lossy = batched.stacked_init(core.LossyCounting(eps=0.01), N, dev)
    src = torch.tensor([N // 2], dtype=torch.int64, device=dev)
    calls = {
        "sort_rows": lambda: om.sort_rows(b.rows, N),
        "onehot_scatter_add": lambda: om.onehot_scatter_add(counts, b.rows,
                                                            idx, v),
        "lossy_scan": lambda: lossy_scan.lossy_scan_update(
            lossy["keys"], lossy["counts"], lossy["error"], b.rows, b.items,
            b.vals, b.mask, src)}
    out = {}
    for name, fn in calls.items():
        out[name] = cs.device_ms(fn, label=name)
        print(f"{name}: device {out[name]:.4f} ms a call", flush=True)
    print(json.dumps({"sort_users": out, "src": str(args.src)}), flush=True)


if __name__ == "__main__":
    main()
