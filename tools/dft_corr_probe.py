#!/usr/bin/env python3
"""Where the DFT tick's (#11) and the correlation kernel's (#12) time
goes: each beside another checkout's build and beside its own design
steps, at phase 2's shapes.

    python3 tools/dft_corr_probe.py            # needs one CUDA card and nvcc
    python3 tools/dft_corr_probe.py --src build/parent --designs

Builds ``csrc/sliding_dft.cu`` and ``csrc/pairwise_corr.cu`` of this
checkout, of every checkout given by ``--src`` (such as a parent unpacked
by ``git archive``) and, with ``--designs``, of a source with one step of
its design changed at a time (``DESIGNS``: text edits of a copy of this
checkout's source, or of the first ``--src``'s where the step is the old
design's). Each is built with ``nvcc`` into a temporary directory, all
at once, and all are timed in one process. Every case runs each build in
the order given and then in reverse; a reading is the kernel's own
device time a call from ``torch.profiler`` (mean of ``RUNS`` calls).

Cases:

  dft@131072, dft@1048576  the tick in place on the interleaved [S, 8, 2]
                           leaf of a Figure-6 DFT stack, rows masked in
                           where chip_smoke's phase-2 batch (65,536
                           Zipf(1.1) tuples, seed 0) routes a tuple, as
                           phase 2 draws them; every build that ticks
                           must equal the plain version's bytes
  corr                     N = 5,000, K = 16, x ~ 0.1 N(0, 1): every
                           build's output byte-equal to the first
                           ``--src``'s (the parent kernel), within
                           CORR_ATOL of the plain version, symmetric bit
                           for bit, its diagonal 1

Designs (``--designs``):

  dft/masks-only     the row walk with no row masked in: the masks' read
                     and the votes alone, a floor (its bytes are not
                     checked: it ticks nothing)
  dft/scalar         the row walk with scalar (re, im) accesses, no float2
  dft/elem-32bit     the old element walk (first ``--src``) with 32-bit
                     index arithmetic: no 64-bit division
  corr/scalar        streaming stores from shared memory, 4 bytes each
  corr/float4        streaming float4 stores, no TMA
  corr/bulk-rows     one bulk copy (cp.async.bulk, no tensor map) a tile
                     row, 128 a tile, issued by warp 0, for the 2-D TMA
                     store
  corr/compute-only  no store: the products and the epilogue alone, a
                     floor (not checked)
  corr/store-only    no products: every tile of 1s stored, a floor (not
                     checked)
  corr/per-tile      one block a tile, not the persistent grid

Ends with one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import probe_build as pb  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import (build, pairwise_corr, ref,  # noqa: E402
                                 sliding_dft)

RUNS = 10
CSRC = Path("src/repro_torch/kernels/csrc")
KERNELS = {"sliding_dft": ("dft", sliding_dft._SIGNATURES, "tick_kernel"),
           "pairwise_corr": ("corr", pairwise_corr._SIGNATURES,
                             "corr_kernel")}
# label -> (source name, base: "tree" or "parent", (old, new) text edits
# each found exactly once, checks its bytes)
DESIGNS = {
    "dft/masks-only": ("sliding_dft", "tree", [
        ("__ballot_sync(kFull, m[j] > 0.0f)",
         "__ballot_sync(kFull, m[j] > 3.0e38f)")], False),
    "dft/scalar": ("sliding_dft", "tree", [
        ("const bool pair = im == re + 1",
         "const bool pair = false && im == re + 1")], True),
    "dft/elem-32bit": ("sliding_dft", "parent", [
        ("const long long e = (long long)blockIdx.x * kThreads + "
         "threadIdx.x;\n  if (e >= S * F) return;\n  const long long s = "
         "e / F;",
         "const int e = blockIdx.x * kThreads + threadIdx.x;\n"
         "  if (e >= (int)S * F) return;\n  const int s = e / F;"),
        ("const int f = (int)(e - s * F);", "const int f = e - s * F;")],
        True),
    "corr/scalar": ("pairwise_corr", "tree", [
        ("const bool tma = N % 4 == 0", "const bool tma = false && N"),
        ("const int nv = (cols - h) >> 2;", "const int nv = 0;")], True),
    "corr/float4": ("pairwise_corr", "tree", [
        ("const bool tma = N % 4 == 0", "const bool tma = false && N")],
        True),
    "corr/bulk-rows": ("pairwise_corr", "tree", [
        ("if (tma && tid == 0) bulk_wait_read<1>();",
         "if (tma && tid < 32) bulk_wait_read<1>();"),
        ("if (tma && tid == 0) bulk_wait_all();",
         "if (tma && tid < 32) bulk_wait_all();"),
        ("      if (tid == 0) {\n"
         "        tma_store(&tm_out, stage, (int)j0, (int)i0);\n",
         "      if (tid < 32) {\n"
         "        for (int r = tid; r < rows; r += 32)\n"
         "          asm volatile(\"cp.async.bulk.global.shared::cta."
         "bulk_group [%0], [%1], %2;\\n\" :: \"l\"(out + (i0 + r) * N + j0),"
         " \"r\"(smem_u32(stage + r * kTN)), \"r\"(cols * 4) : "
         "\"memory\");\n")], True),
    "corr/compute-only": ("pairwise_corr", "tree", [
        ("        tma_store(&tm_out, stage, (int)j0, (int)i0);\n", "")], False),
    "corr/store-only": ("pairwise_corr", "tree", [
        ("for (int k0 = 0; k0 < K; k0 += kChunk)",
         "for (int k0 = 0; k0 < 0; k0 += kChunk)")], False),
    "corr/per-tile": ("pairwise_corr", "tree", [
        ("const long long cap = (long long)sde::sm_count() * kBlocksPerSM;",
         "const long long cap = 0x7fffffffLL;")], True),
}


def sources(args) -> dict:
    """label -> (source name, its text, its headers' directory, whether
    its bytes are checked)."""
    out = {}
    for name, (short, _, _) in KERNELS.items():
        for src in args.src:        # first: #12's bytes are the parent's
            d = src.resolve() / CSRC
            out[f"{short}/{src.name}"] = (name, (d / f"{name}.cu").read_text(),
                                          d, True)
        out[f"{short}/tree"] = (name, (ROOT / CSRC / f"{name}.cu").read_text(),
                                ROOT / CSRC, True)
    if args.designs:
        for label, (name, base, edits, checked) in DESIGNS.items():
            if base == "parent" and not args.src:
                print(f"{label}: skipped, it edits the first --src's source",
                      flush=True)
                continue
            d = ROOT / CSRC if base == "tree" else args.src[0].resolve() / CSRC
            text = pb.edited(label, name, (d / f"{name}.cu").read_text(),
                             edits)
            out[label] = (name, text, d, checked)
    return out


def timed(libs: dict, name: str, call, check) -> dict:
    """Each build of ``name`` checked once (``check(label, checked)``
    after its first call), then timed in order and in reverse."""
    labels = [lb for lb, (_, n, _) in libs.items() if n == name]
    ms: dict = {}
    for label in labels + labels[::-1]:
        lib, _, checked = libs[label]
        if label not in ms:
            check(label, lib, checked)
        ms.setdefault(label, []).append(
            pb.kernel_ms(lambda: call(lib), KERNELS[name][2], RUNS))
    return ms


def dft_cases(b, dev) -> list:
    """The tick's operands at S = 131,072 and 2**20, as phase 2 draws
    them."""
    dft = core.DFT(**cs.FIG6_DFT)
    f = dft.n_coeffs
    tw_re, tw_im = dft._twiddle(dev)
    out = []
    for s_rows in (1 << 17, 1 << 20):
        hit = torch.zeros(s_rows, dtype=torch.float32, device=dev)
        hit[b.rows[(b.rows >= 0) & b.mask].long() % s_rows] = 1.0
        delta = torch.randn(s_rows, generator=b.gen, device=dev) * 4
        coeff0 = torch.randn((s_rows, f, 2), generator=b.gen, device=dev) * 40
        out.append(dict(s=s_rows, f=f, hit=hit, delta=delta, coeff0=coeff0,
                        tw_re=tw_re, tw_im=tw_im))
    return out


def call_dft(lib, c, coeff) -> None:
    re, im = coeff[..., 0], coeff[..., 1]
    err = lib.dft_tick(re.data_ptr(), im.data_ptr(), re.stride(0),
                       re.stride(1), c["delta"].data_ptr(),
                       c["hit"].data_ptr(), c["tw_re"].data_ptr(),
                       c["tw_im"].data_ptr(), c["s"], c["f"],
                       build.stream(coeff.device))
    build.check_launch(err, "dft_tick")


def probe_dft(libs, c) -> dict:
    want = c["coeff0"].clone()
    ref.sliding_dft_step(want[..., 0], want[..., 1], c["delta"], c["hit"],
                         c["tw_re"], c["tw_im"])
    work = c["coeff0"].clone()

    def check(label, lib, checked):
        work.copy_(c["coeff0"])
        call_dft(lib, c, work)
        torch.cuda.synchronize()
        if checked:
            cs.require(cs.same_bytes(work, want),
                       f"{label}: the tick differs from the plain version "
                       f"at S={c['s']}")

    ms = timed(libs, "sliding_dft", lambda lib: call_dft(lib, c, work), check)
    n_hit = int((c["hit"] > 0).sum())
    rows_in = torch.nonzero(c["hit"] > 0)[:, 0]
    n_bytes = (c["s"] * 4 + 2 * 32 * cs.sectors(rows_in, c["f"] * 8)
               + 32 * cs.sectors(rows_in, 4) + c["f"] * 8)
    bound, _ = cs.bound_ms(n_bytes, 7 * c["f"] * n_hit)
    return dict(case=f"dft@{c['s']}", rows_in=n_hit, bound_ms=bound,
                device_ms=ms)


def probe_corr(libs, b, dev) -> dict:
    nn, k = cs.CORR_N, cs.CORR_K
    x = torch.randn((nn, k), generator=b.gen, device=dev) * 0.1
    want = ref.pairwise_corr(x)
    out = torch.empty((nn, nn), device=dev)
    first = {}          # the first build whose bytes all others must equal

    def call(lib):
        err = lib.pairwise_corr(x.data_ptr(), out.data_ptr(), nn, k,
                                build.stream(dev))
        build.check_launch(err, "pairwise_corr")

    def check(label, lib, checked):
        out.fill_(float("nan"))
        call(lib)
        torch.cuda.synchronize()
        if not checked:
            return
        _, err, _ = cs.compare(out, want)
        cs.require(err <= cs.CORR_ATOL, f"{label}: max abs err {err}")
        cs.require(cs.same_bytes(out, out.T.contiguous()),
                   f"{label}: not symmetric bit for bit")
        cs.require(torch.equal(out.diagonal(), torch.ones(nn, device=dev)),
                   f"{label}: the diagonal is not 1")
        if not first:
            first.update(label=label, out=out.clone())
        else:
            cs.require(cs.same_bytes(out, first["out"]),
                       f"{label}: bytes differ from {first['label']}'s")
        print(f"corr {label}: max abs err {err:.3g}, symmetric, diagonal 1,"
              f" bytes equal to {first['label']}'s", flush=True)

    # builds in the order of ``sources``: the first --src (the parent)
    # first, so every other build must give its bytes
    ms = timed(libs, "pairwise_corr", call, check)
    bound, _ = cs.bound_ms(nn * nn * 4 + nn * k * 4, 2 * nn * nn * k)
    return dict(case="corr", n=nn, k=k, bound_ms=bound, device_ms=ms,
                bytes_equal_to=first["label"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, action="append", default=[],
                    help="another checkout whose two sources are timed "
                         "(the first: the parent, for #12's bytes and the "
                         "old design's steps)")
    ap.add_argument("--designs", action="store_true",
                    help="also the sources with each design step changed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dft_corr_probe.py needs a CUDA card")
    pb.card_line()
    dev = torch.device("cuda", 0)
    srcs = sources(args)
    built = pb.build_all({lb: v[:3] for lb, v in srcs.items()},
                         {name: sigs for name, (_, sigs, _) in KERNELS.items()},
                         "dft_corr_probe_")
    # label -> (loaded library, source name, whether its bytes are checked)
    libs = {lb: (lib, name, srcs[lb][3]) for lb, (lib, name) in built.items()}
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    results = []
    for case in [lambda c=c: probe_dft(libs, c) for c in dft_cases(b, dev)] \
            + [lambda: probe_corr(libs, b, dev)]:
        r = case()
        cs.free()
        line = ", ".join(f"{lb} {v[0]:.4f} / {v[1]:.4f}"
                         for lb, v in r["device_ms"].items())
        print(f"{r['case']}: bound {r['bound_ms']:.5f} ms; device ms a call "
              f"(forward / reverse order): {line}", flush=True)
        results.append(r)
    print(json.dumps({"dft_corr_probe": results, "runs": RUNS}), flush=True)


if __name__ == "__main__":
    main()
