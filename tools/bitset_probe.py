#!/usr/bin/env python3
"""Where a bit-set call's time goes: the hot lanes, the atomics, the
batch's loads and the probe; for Bloom, FM and HyperLogLog, which all
run on the bit-set kernel.

    python3 tools/bitset_probe.py            # needs one CUDA card and nvcc
    python3 tools/bitset_probe.py --src build/parent --designs

Builds ``csrc/bitset_or.cu`` of this checkout, of every checkout given by
``--src`` (such as a parent unpacked by ``git archive``) and, with
``--designs``, of this checkout's source with one step of its design
changed at a time (``DESIGNS``: text edits of a copy); where a ``--src``
checkout still has the one-thread-per-tuple ``csrc/hll_max.cu``, that
source too (``<name>:hll_max``, timed in the HLL cases only). Each is
built with ``nvcc`` into a temporary directory, and all are timed in one
process on
chip_smoke's phase-2 batch (65,536 Zipf(1.1) tuples, seed 0). Every
case runs each build in the order given and then in reverse; a reading
is the kernel's own device time a call from ``torch.profiler`` (mean of
``RUNS`` calls; the state's restore before a call is a separate
activity and is not counted). Every build's state must equal the plain
version's bytes.

Cases (the state is set: the batch already ran on it once, a stream seen
before; first: restored from its initial copy before every call; zero:
zeroed before every call, as the data-source fold's fresh sketch is):

  bloom/set, bloom/first   per-stream Bloom(1024, 0.01), [131,072, 16,384]
                           lanes, k = 11, on the batch's routed rows
                           (``bits0``: 10% of lanes set)
  uniform/set, /first      the same with stream ids drawn uniformly over
                           the table: no hot lane
  loads/set                every position set to m: the kernel reads the
                           batch and drops every entry, no atomic
  probe/set, probe/first   the fused-probe entry point on bloom's batch
  bloom@fresh/zero         Bloom(2**20, 0.01): 2**24 lanes, every tuple on
                           row 0
  fm/set, fm/first         FM (64 maps x 32 bits) as a k = 1 bit-set on the
                           flat [131,072, 2048] plane
  fm-probe/set             the fused entry point at k = 1
  fm@fresh/zero            FM's one-row fresh sketch
  hll/set, hll/first       per-stream HyperLogLog(rse=0.03) as a k = 1
                           bit-set on [131,072, 2048] registers (``regs0``:
                           ranks 0-3), the bucket the position, the rank
                           (0 where masked) the upd
  hll-probe/set            the fused entry point
  hll@fresh/zero           HLL's one-row fresh sketch

Beside each case it prints the entries the batch keeps, their distinct
lanes and 32-byte sectors, the most entries on one lane and the groups
left after grouping equal lanes within each warp's 32 tuples at one hash
index (``chip_smoke.lane_stats``). Ends with one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import probe_build as pb  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import bitset_or, build, ops, probe, ref  # noqa: E402
from repro_torch.service import routing  # noqa: E402

RUNS = 10
CSRC = Path("src/repro_torch/kernels/csrc")
# design -> (old, new) text edits of this checkout's bitset_or.cu, each
# found exactly once: the source with one step of its design changed
DESIGNS = {
    # positions read by each lane from its own tuple's slice, not staged
    "unstaged": [("const bool staged = k <= kStagedK;",
                  "const bool staged = false;")],
    # staged 4 loads in flight a lane at a time
    "stage-by-4": [("int32_t v[kChunk];                 // kChunk loads in "
                    "flight a lane", "int32_t v[4];"),
                   ("#pragma unroll\n"
                    "    for (int r = 0; r < kChunk; ++r)\n"
                    "      if (e0 + 32 * r + lane < nt * k) v[r]",
                    "#pragma unroll 1\n"
                    "    for (int q = 0; q < kChunk; q += 4) {\n"
                    "#pragma unroll\n"
                    "    for (int r = q; r < q + 4; ++r)\n"
                    "      if (e0 + 32 * r + lane < nt * k) v[r - q]"),
                   ("    for (int r = 0; r < kChunk; ++r)\n"
                    "      if (e0 + 32 * r + lane < nt * k) pos",
                    "    for (int r = q; r < q + 4; ++r)\n"
                    "      if (e0 + 32 * r + lane < nt * k) pos"),
                   ("pos[e0 + 32 * r + lane] = v[r];",
                    "pos[e0 + 32 * r + lane] = v[r - q];\n    }")],
    # the lane read through L1 as well
    "read-l1": [("cur[i] = __ldcg(bits + key[i]);",
                 "cur[i] = __ldca(bits + key[i]);")],
    # no block table: every group leader that needs an update issues
    "no-table": [("      if ((was == kEmpty", "      if (false && (was == kEmpty")],
    # blocks of 16 warps (512 tuples)
    "16-warps": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
                 ("constexpr int kStagedK = 35;", "constexpr int kStagedK = 11;")],
    # no grouping: every lane that needs an update issues its atomic
    "ungrouped": [("__match_any_sync(kFull, need ? key[i] : -1LL)",
                   "(1u << lane)")],
    # no read first: every entry joins its group and each leader issues
    "unread": [("if (key[i] >= 0) cur[i] = __ldcg(bits + key[i]);", ""),
               ("const bool need = key[i] >= 0 && cur[i] < u;",
                "const bool need = key[i] >= 0;")],
}


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of an earlier checkout's csrc/hll_max.cu
HLL_SIGNATURES = {
    "hll_max_update": (_P, _I, _I, _P, _P, _P, _I, _P),
    "hll_probe_max_update": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                             _P, _I, _P),
}


def sources(args) -> dict:
    """label -> (source name, its text, the directory of its headers)."""
    out = {"tree": ("bitset_or", (ROOT / CSRC / "bitset_or.cu").read_text(),
                    ROOT / CSRC)}
    for src in args.src:
        d = src.resolve() / CSRC
        out[src.name] = ("bitset_or", (d / "bitset_or.cu").read_text(), d)
        if (d / "hll_max.cu").exists():
            out[f"{src.name}:hll_max"] = (
                "hll_max", (d / "hll_max.cu").read_text(), d)
    if args.designs:
        for label, edits in DESIGNS.items():
            out[label] = ("bitset_or", pb.edited(label, "bitset_or",
                                                 out["tree"][1], edits),
                          ROOT / CSRC)
    return out


def call_hll(lib, regs, c) -> None:
    """One launch of case ``c``'s entry point from an earlier
    ``hll_max.cu``: the [T] bucket and rank, as its wrappers made it."""
    n, m = regs.shape
    t = c["idx"].shape[0]
    bucket = c["idx"][:, 0].contiguous()
    stream = build.stream(regs.device)
    if c["probe"] is None:
        err = lib.hll_max_update(regs.data_ptr(), n, m, c["rows"].data_ptr(),
                                 bucket.data_ptr(), c["upd"].data_ptr(), t,
                                 stream)
    else:
        p = c["probe"]
        err = lib.hll_probe_max_update(
            regs.data_ptr(), n, m, p.klo.data_ptr(), p.khi.data_ptr(),
            p.trows.data_ptr(), p.klo.shape[0], p.slo.data_ptr(),
            p.shi.data_ptr(), p.n_probe, bucket.data_ptr(),
            c["upd"].data_ptr(), t, stream)
    build.check_launch(err, "hll_probe")


def call(lib, bits, c) -> None:
    """One launch of case ``c``'s entry point from ``lib``, as the
    wrappers make it."""
    n, m = bits.shape
    k, t = c["idx"].shape[1], c["idx"].shape[0]
    stream = build.stream(bits.device)
    if c["probe"] is None:
        err = lib.bitset_max_update(bits.data_ptr(), n, m,
                                    c["rows"].data_ptr(),
                                    c["idx"].data_ptr(), k,
                                    c["upd"].data_ptr(), t, stream)
    else:
        p = c["probe"]
        err = lib.bitset_probe_max_update(
            bits.data_ptr(), n, m, p.klo.data_ptr(), p.khi.data_ptr(),
            p.trows.data_ptr(), p.klo.shape[0], p.slo.data_ptr(),
            p.shi.data_ptr(), p.n_probe, c["idx"].data_ptr(), k,
            c["upd"].data_ptr(), t, stream)
    build.check_launch(err, "bitset_probe")


def cases(b, dev) -> list:
    """Each case: name, its entry's operands, the state's initial copy
    and how the state is prepared before a call."""
    n = 131072
    bloom = core.BloomFilter(n_elements=1024, fpr=0.01)
    m = bloom.n_bits
    idx = bloom._positions(b.items)
    upd = b.mask.to(torch.int32)
    bits0 = (torch.rand((n, m), generator=b.gen, device=dev) > 0.9).to(
        torch.int32)
    # uniform stream ids where the batch has a routed one
    rng = np.random.RandomState(1)
    sids = b.pop[rng.randint(0, len(b.pop), b.t)]
    lo, hi = (torch.from_numpy(np.ascontiguousarray(h.view(np.int32))).to(dev)
              for h in routing.split64(sids))
    u_rows = probe.probe_rows(b.klo, b.khi, b.trows, lo, hi,
                              n_probe=b.n_probe)
    u_rows = torch.where(b.rows >= 0, u_rows, b.rows)
    u_items = torch.from_numpy(routing.fold64(sids).view(np.int32)).to(dev)
    u_idx = bloom._positions(u_items)
    src_bloom = core.BloomFilter(n_elements=cs.SRC_BLOOM_ELEMENTS, fpr=0.01)
    fm = core.FMSketch()
    which, pos = fm._which_pos(b.items)
    fm_m = fm.nmaps * fm.bitmap_size
    fm_pos = torch.add(pos, which, alpha=fm.bitmap_size).to(
        torch.int32)[:, None].contiguous()
    fm0 = (torch.rand((n, fm_m), generator=b.gen, device=dev) > 0.9).to(
        torch.int32)
    hll = core.HyperLogLog(rse=0.03)
    bucket, raw_rank = ops._hll_prep(b.items, hll.seed, hll.p)
    rank = torch.where(b.mask, raw_rank, 0).to(torch.int32)
    h_pos = bucket[:, None]
    regs0 = torch.randint(0, 4, (n, hll.m), generator=b.gen, device=dev,
                          dtype=torch.int32)
    row0 = b.to_row0
    c = lambda name, rows, ix, state0, mode, fused=False, u=upd: dict(
        name=name, rows=rows, idx=ix, upd=u, state0=state0, mode=mode,
        probe=b if fused else None, hll=name.startswith("hll"))
    return [
        c("bloom/set", b.rows, idx, bits0, "set"),
        c("bloom/first", b.rows, idx, bits0, "first"),
        c("uniform/set", u_rows, u_idx, bits0, "set"),
        c("uniform/first", u_rows, u_idx, bits0, "first"),
        c("loads/set", b.rows, torch.full_like(idx, m), bits0, "set"),
        c("probe/set", b.rows, idx, bits0, "set", fused=True),
        c("probe/first", b.rows, idx, bits0, "first", fused=True),
        c("bloom@fresh/zero", row0, src_bloom._positions(b.items),
          torch.zeros((1, src_bloom.n_bits), dtype=torch.int32, device=dev),
          "zero"),
        c("fm/set", b.rows, fm_pos, fm0, "set"),
        c("fm/first", b.rows, fm_pos, fm0, "first"),
        c("fm-probe/set", b.rows, fm_pos, fm0, "set", fused=True),
        c("fm@fresh/zero", row0, fm_pos,
          torch.zeros((1, fm_m), dtype=torch.int32, device=dev), "zero"),
        c("hll/set", b.rows, h_pos, regs0, "set", u=rank),
        c("hll/first", b.rows, h_pos, regs0, "first", u=rank),
        c("hll-probe/set", b.rows, h_pos, regs0, "set", fused=True, u=rank),
        c("hll@fresh/zero", row0, h_pos,
          torch.zeros((1, hll.m), dtype=torch.int32, device=dev), "zero",
          u=rank),
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, action="append", default=[],
                    help="another checkout whose bitset_or.cu (and "
                         "hll_max.cu, where it has one) is timed")
    ap.add_argument("--designs", action="store_true",
                    help="also this source with each design step changed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bitset_probe.py needs a CUDA card")
    pb.card_line()
    dev = torch.device("cuda", 0)
    libs = pb.build_all(sources(args), {"bitset_or": bitset_or._SIGNATURES,
                                        "hll_max": HLL_SIGNATURES},
                        "bitset_probe_")
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    results = []
    for c in cases(b, dev):
        # the earlier hll_max.cu builds take the HLL cases only
        labels = [lb for lb, (_, name) in libs.items()
                  if c["hll"] or name == "bitset_or"]
        order = labels + labels[::-1]
        state0, m = c["state0"], c["state0"].shape[1]
        rows = c["rows"]          # the probe's rows, for a fused case
        stats = cs.lane_stats(rows, c["idx"], c["upd"], m)
        want = (ref.hll_max_update(state0.clone(), rows, c["idx"][:, 0],
                                   c["upd"]) if c["hll"] else
                ref.bitset_max_update(state0.clone(), rows, c["idx"],
                                      c["upd"]))
        work = state0.clone()
        prep = {"set": lambda: None,
                "first": lambda: work.copy_(state0),
                "zero": lambda: work.zero_()}[c["mode"]]
        ms: dict = {}
        for label in order:
            lib, name = libs[label]
            launch, kernel = ((call_hll, "hll_kernel") if name == "hll_max"
                              else (call, "bitset"))
            if label not in ms:       # first visit: the bytes, from state0
                work.copy_(state0)
                launch(lib, work, c)
                torch.cuda.synchronize()
                cs.require(cs.same_bytes(work, want),
                           f"{label}: {c['name']} differs from the plain "
                           f"version")
            ms.setdefault(label, []).append(
                pb.kernel_ms(lambda: launch(lib, work, c), kernel, RUNS,
                             prep))
        del want, work
        cs.free()
        line = ", ".join(f"{lb} {v[0]:.4f} / {v[1]:.4f}"
                         for lb, v in ms.items())
        print(f"{c['name']}: {stats}; device ms a call (forward / "
              f"reverse order): {line}", flush=True)
        results.append(dict(case=c["name"], **stats, device_ms=ms))
    print(json.dumps({"bitset_probe": results, "runs": RUNS}), flush=True)


if __name__ == "__main__":
    main()
