#!/usr/bin/env python3
"""Where the RHP long walk's time goes, in SM cycles.

    python3 tools/rhp_chain_probe.py      # needs one CUDA card and nvcc

Builds, in a temporary directory, two sources:

  * ``rhp_stamped``: ``csrc/rhp_project.cu`` with clock stamps added by a
    text edit of a copy: the slice-0 block of the longest run records the
    cycles from its start to each ring stage's wait and to its end;
  * ``fadd_chain``: one warp adding 65,536 values into a dependent chain
    of ``__fadd_rn``, the values read from registers, from shared memory
    with a 4-byte load an add, and with a 16-byte load a 4 adds.

Then it runs ``rhp_project_update`` through the stamped build on
chip_smoke's phase-2 batch (65,536 Zipf(1.1) tuples, b = 64, 131,072
rows), three times, requires the state's bytes to equal the wrapper's
own build, and prints the hot block's cycles: before its first stage's
wait, from each stage's wait to the next (a stage is 256 positions, 256
adds a lane), and in all; then the chain's cycles an add for each
microbenchmark. Ends with one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STAMP_DECLS = """__device__ long long g_want;      // the run length to stamp
__device__ long long g_stamps[3 + 256];  // length, all, stages, waits
"""
STAMP_API = """extern "C" {
int rhp_stamp_want(long long len) {
  return (int)cudaMemcpyToSymbol(g_want, &len, sizeof(len));
}
int rhp_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
}  // extern "C"
"""
# (old, new) text edits of csrc/rhp_project.cu, each found exactly once
STAMP_EDITS = [
    ("namespace {\n", STAMP_DECLS + "namespace {\n"),
    ("  uint64_t* const empty = full + kStages;\n",
     "  uint64_t* const empty = full + kStages;\n"
     "  const long long ts0 = clock64();\n"),
    ("    mbar_wait(smem_u32(full + st), (uint32_t)(k / kStages) & 1u);\n",
     "    if (lane == 0 && q == 0 && p1 - p0 == g_want && k < 256) {\n"
     "      g_stamps[3 + k] = clock64() - ts0;\n"
     "    }\n"
     "    mbar_wait(smem_u32(full + st), (uint32_t)(k / kStages) & 1u);\n"),
    ("  if (lane_ok) *dst = acc;\n}\n",
     "  if (lane_ok) *dst = acc;\n"
     "  if (lane == 0 && q == 0 && p1 - p0 == g_want) {\n"
     "    g_stamps[0] = p1 - p0;\n"
     "    g_stamps[1] = clock64() - ts0;\n"
     "    g_stamps[2] = n_stages;\n"
     "  }\n}\n"),
]

FADD_CHAIN = r"""#include <cuda_runtime.h>

// acc += v[i] for 65,536 values in one dependent chain, one warp
__global__ void from_registers(const float* in, float* out, long long* cyc,
                               int n) {
  float v[32];
  for (int i = 0; i < 32; ++i) v[i] = in[i * 32 + threadIdx.x];
  float acc = in[threadIdx.x];
  const long long t0 = clock64();
  for (int k = 0; k < n; k += 32) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, v[i]);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}

__global__ void from_shared_4b(const float* in, float* out, long long* cyc,
                               int n) {
  __shared__ float ring[128 * 32];
  for (int i = 0; i < 128; ++i) {
    ring[i * 32 + threadIdx.x] = in[i * 32 + threadIdx.x];
  }
  __syncwarp();
  float acc = in[threadIdx.x];
  const float* rg = ring + threadIdx.x;
  const long long t0 = clock64();
  for (int k = 0; k < n; k += 128) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc = __fadd_rn(acc, rg[i * 32]);
    __syncwarp();
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}

__global__ void from_shared_16b(const float* in, float* out, long long* cyc,
                                int n) {
  __shared__ __align__(16) float ring[128 * 32];
  for (int i = 0; i < 128; ++i) {
    ring[i * 32 + threadIdx.x] = in[i * 32 + threadIdx.x];
  }
  __syncwarp();
  float acc = in[threadIdx.x];
  const float4* rg = reinterpret_cast<const float4*>(ring) + threadIdx.x;
  const long long t0 = clock64();
  for (int k = 0; k < n; k += 128) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float4 x = rg[i * 32];
      acc = __fadd_rn(acc, x.x);
      acc = __fadd_rn(acc, x.y);
      acc = __fadd_rn(acc, x.z);
      acc = __fadd_rn(acc, x.w);
    }
    __syncwarp();
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}

extern "C" int fadd_chain(const float* in, float* out, long long* cyc, int n,
                          int which) {
  if (which == 0) from_registers<<<1, 32>>>(in, out, cyc, n);
  else if (which == 1) from_shared_4b<<<1, 32>>>(in, out, cyc, n);
  else from_shared_16b<<<1, 32>>>(in, out, cyc, n);
  return (int)cudaDeviceSynchronize();
}
"""
CHAINS = ("registers", "shared memory, 4-byte loads",
          "shared memory, 16-byte loads")
CHAIN_ADDS = 65536


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rhp_chain_probe.py needs a CUDA card")
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import build, rhp_project as rp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    text = (build.CSRC / "rhp_project.cu").read_text()
    for old, new in STAMP_EDITS:
        cs.require(text.count(old) == 1, f"the edited text is not in the "
                                         f"source exactly once: {old!r}")
        text = text.replace(old, new)
    dev = torch.device("cuda", 0)
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    sgn = hashing.sign_hash(b.items, core.RHP()._seeds())
    v = b.vals * b.mask.float()
    n = 131072
    state0 = torch.randint(-8, 8, (n, sgn.shape[1]), generator=b.gen,
                           device=dev, dtype=torch.int32).to(torch.float32)
    want = rp.rhp_project_update(state0.clone(), b.rows, v, sgn)
    _, longest = rp.long_runs_of(b.rows, n)

    csrc, build_dir = build.CSRC, build.BUILD_DIR
    tmp = Path(tempfile.mkdtemp(prefix="rhp_chain_"))
    try:
        build.CSRC, build.BUILD_DIR = tmp / "csrc", tmp / "build"
        build.CSRC.mkdir()
        shutil.copy(csrc / "probe.cuh", build.CSRC)
        (build.CSRC / "rhp_stamped.cu").write_text(text + STAMP_API)
        (build.CSRC / "fadd_chain.cu").write_text(FADD_CHAIN)
        build.build(["rhp_stamped", "fadd_chain"])
        lib = build.load("rhp_stamped", dict(
            rp._SIGNATURES, rhp_stamp_want=(ctypes.c_longlong,),
            rhp_stamps=(ctypes.c_void_p,)))
        chain = build.load("fadd_chain", {"fadd_chain": (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int)})
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        shutil.rmtree(tmp, ignore_errors=True)

    built = rp._lib
    rp._lib = lambda: lib
    runs = []
    try:
        build.check_launch(lib.rhp_stamp_want(longest), "rhp_stamp_want")
        for _ in range(3):
            got = rp.rhp_project_update(state0.clone(), b.rows, v, sgn)
            torch.cuda.synchronize()
            cs.require(cs.same_bytes(got, want), "the stamped build's state "
                                                 "differs from the source's")
            stamps = (ctypes.c_longlong * 259)()
            build.check_launch(lib.rhp_stamps(stamps), "rhp_stamps")
            cs.require(stamps[0] == longest, "the hot block left no stamps")
            waits = list(stamps[3:3 + min(stamps[2], 256)])
            stages = [b2 - a for a, b2 in zip(waits, waits[1:])]
            runs.append(dict(run_length=longest, before_first_stage=waits[0],
                             stage_cycles=stages, all_cycles=stamps[1]))
            print(f"hot block: {longest} tuples, {waits[0]} cycles before "
                  f"its first stage, {stamps[1]} in all; from one stage's "
                  f"wait to the next (256 adds a lane): median "
                  f"{statistics.median(stages):g}, min {min(stages)}, max "
                  f"{max(stages)} cycles; each: {stages}", flush=True)
    finally:
        rp._lib = built

    vals = torch.randn(4096, device=dev)
    out = torch.empty(32, device=dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    per_add = {}
    for which, name in enumerate(CHAINS):
        for _ in range(2):                     # the first run warms up
            build.check_launch(chain.fadd_chain(
                vals.data_ptr(), out.data_ptr(), cyc.data_ptr(), CHAIN_ADDS,
                which), "fadd_chain")
        per_add[name] = int(cyc) / CHAIN_ADDS
        print(f"dependent __fadd_rn chain, values from {name}: "
              f"{per_add[name]:.4f} cycles an add", flush=True)
    print(json.dumps({"rhp_chain_probe": runs,
                      "fadd_cycles_an_add": per_add}), flush=True)


if __name__ == "__main__":
    main()
