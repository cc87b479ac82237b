#!/usr/bin/env python3
"""Show that chip_smoke.py's attention check catches a broken kernel.

    python3 tools/attn_check_mutants.py      # needs one CUDA card and nvcc

Builds ``csrc/flash_attention.cu`` as it is and four variants of it, each
made by a text edit of a copy in a temporary directory:

  * ``no_acc_rescale``: the bf16 kernel's accumulator is not multiplied by
    exp(m_old - m_new) when the running max moves;
  * ``no_l_rescale``: its running denominator is not;
  * ``one_part_p``: P enters P.V as one bf16 value (hi only: p with its
    low 16 bits cleared, 8 significant bits) instead of hi + lo;
  * ``no_softmax``: the raw scores go to P.V with no mask, max, exp or
    rescale: wrong by design, its time is the products' alone.

Each goes through the wrapper ``flash_attention.flash_attention`` at
Qwen2-72B's attention width (q/k/v [64, 4096, 128] bfloat16), causal and
not, with q and k at 0.3 N(0, 1) and at chip_smoke's ATTN_PEAKY, and is
held against the plain version with ``chip_smoke.attn_check``. Each
variant is also timed on the causal q/k 0.3 case (``torch.profiler``
device time, ``chip_smoke.device_ms``): beside the source, ``one_part_p``
shows what the second P.V costs and ``no_softmax`` what the softmax
costs that the products do not hide. Prints a line for each (variant,
case) and then one JSON line. Exits non-zero unless the source as it is
passes every case and both rescale variants fail every case;
``one_part_p`` and ``no_softmax`` are reported only.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ACC_RESCALE = """#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
"""
LO_MMAS = """    pv_mma<DP, BK>(o, p_lo[t], v + t * 16 * kRowBytes);
"""
VARIANTS = {
    "as_is": [],
    "no_acc_rescale": [(ACC_RESCALE, "")],
    "no_l_rescale": [("l[0] = l[0] * corr[0] + rs[0];", "l[0] += rs[0];"),
                     ("l[1] = l[1] * corr[1] + rs[1];", "l[1] += rs[1];")],
    "one_part_p": [(LO_MMAS, "")],
    "no_softmax": [("softmax_tile<BK>(s, m, l, corr, 0,",
                    "if (0) softmax_tile<BK>(s, m, l, corr, 0,"),
                   ("softmax_tile<BK>(s, m, l, corr, kt * BK,",
                    "if (0) softmax_tile<BK>(s, m, l, corr, kt * BK,"),
                   ("float corr[2];", "float corr[2] = {1.0f, 1.0f};")],
}
RESCALE_VARIANTS = ("no_acc_rescale", "no_l_rescale")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attn_check_mutants.py needs a CUDA card")
    from repro_torch.kernels import build, flash_attention as fa, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="attn_mutants_"))
    try:
        build.CSRC, build.BUILD_DIR = tmp / "csrc", tmp / "build"
        build.CSRC.mkdir()
        for name, edits in VARIANTS.items():
            text = src
            for old, new in edits:
                cs.require(text.count(old) == 1,
                           f"{name}: the edited text is not in the source "
                           f"exactly once: {old!r}")
                text = text.replace(old, new)
            (build.CSRC / f"attn_{name}.cu").write_text(text)
        build.build([f"attn_{name}" for name in VARIANTS])

        dev = torch.device("cuda", 0)
        h, d, s = cs.ATTN_HEADS, cs.ATTN_D, cs.ATTN_S
        cases = [(causal, qk) for qk in (0.3, cs.ATTN_PEAKY)
                 for causal in (True, False)]
        inputs, wants = {}, {}
        for i, case in enumerate(cases):
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            inputs[case] = cs.attn_inputs(gen, h, s, s, d, torch.bfloat16,
                                          case[1])
            wants[case] = ref.flash_attention(*inputs[case], case[0])
            cs.free()
        rows, times = [], {}
        for name in VARIANTS:
            lib = build.load(f"attn_{name}", fa._SIGNATURES)
            fa._lib = lambda lib=lib: lib
            timed = inputs[True, 0.3]
            times[name] = cs.device_ms(lambda: fa.flash_attention(*timed,
                                                                  True))
            print(f"{name}: q/k/v [{h}, {s}, {d}] bf16 causal: "
                  f"{times[name]:.4f} ms device", flush=True)
            for causal, qk in cases:
                got = fa.flash_attention(*inputs[causal, qk], causal)
                err, worst = cs.attn_check(got, wants[causal, qk])
                rows.append(dict(variant=name, causal=causal, qk_scale=qk,
                                 max_abs_err=err, worst=worst,
                                 passes=worst <= 1.0))
                print(f"{name}: q/k/v [{h}, {s}, {d}] bf16 causal={causal} "
                      f"q/k {qk} N(0,1): max abs err {err:.4g}, worst "
                      f"element at {worst:.4g} of its limit -> "
                      f"{'passes' if worst <= 1.0 else 'FAILS'}", flush=True)
                del got
                cs.free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"attn_check_mutants": rows, "device_ms": times}),
          flush=True)
    for r in rows:
        if r["variant"] == "as_is":
            cs.require(r["passes"], f"the kernel as it is fails: {r}")
        elif r["variant"] in RESCALE_VARIANTS:
            cs.require(not r["passes"], f"the check misses a mutant: {r}")


if __name__ == "__main__":
    main()
