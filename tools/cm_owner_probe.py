#!/usr/bin/env python3
"""The small-stack route's other design, measured beside the one kept.

    python3 tools/cm_owner_probe.py     # needs one CUDA card and nvcc

CountMin stacks with d * n < 1024 take the element-keyed route of
``csrc/countmin_scatter.cu`` (a key pass, the row sort over n * d * w
keys, the gather and the walk). This tool builds, in a temporary
directory, the design it was measured against: bucket ownership, as the
earlier ``bucket_kernel`` had it, without what serialised it. Block (x, y)
owns state row y / d, depth row y % d and R buckets from x * R, one per
thread of its first R / 32 warps, each element in a register from the
first tuple to the last. The block streams the batch in chunks of 2,048
tuples (the next chunk's loads in flight), compacts the tuples of its
(row, bucket range) into shared memory in batch order, and every owner
adds each compacted weight, its own or -0.0, straight from shared
memory: no shuffle round on an add, one thread an element, batch order.

On chip_smoke's phase-2 batch (65,536 Zipf(1.1) tuples, integer weights
with zeros) it runs, for the data-source fresh sketch [1, 5, 2048] at R
= 32 to 256 and for a stack of n = 204 rows (d * n = 1,020, rows Zipf
over the stack), the owner design and the wrapper's route, checks that
each gives the wrapper's bytes (integer and float weights) and prints
their ``torch.profiler`` device ms a call. Ends with one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RANGES = (32, 64, 128, 256)
SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kT = 256;               // threads a block
constexpr int kPer = 8;               // tuples a thread a chunk
constexpr int kChunk = kT * kPer;
constexpr int kWarps = kT / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Raw {
  int row, b;
  float v, sg;
};

__device__ __forceinline__ void load(Raw (&x)[kPer], const int32_t* rows,
                                     const int32_t* idx, const float* values,
                                     const float* signs, int base, int T,
                                     int d, int j) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = base + i * kT + threadIdx.x;
    x[i] = Raw{-1, -1, 0.0f, 1.0f};
    if (t < T) {
      const long long tj = (long long)t * d + j;
      x[i].row = __ldg(rows + t);
      x[i].b = __ldg(idx + tj);
      x[i].v = __ldg(values + t);
      if (signs != nullptr) x[i].sg = __ldg(signs + tj);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kT)
owner_kernel(float* __restrict__ counts, int d, int w,
             const int32_t* __restrict__ rows,
             const int32_t* __restrict__ idx,
             const float* __restrict__ values,
             const float* __restrict__ signs, int T) {
  __shared__ __align__(16) int s_b[kChunk];
  __shared__ __align__(16) float s_v[kChunk];
  __shared__ int s_cnt[kPer * kWarps];
  __shared__ int s_total;
  const int s = blockIdx.y / d;
  const int j = blockIdx.y % d;
  const int b_lo = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool owner = tid < R && b_lo + tid < w;
  float* const elem = counts + ((long long)s * d + j) * w + b_lo + tid;
  float acc = owner ? *elem : 0.0f;
  Raw cur[kPer], nxt[kPer];
  load(cur, rows, idx, values, signs, 0, T, d, j);
  for (int base = 0; base < T; base += kChunk) {
    load(nxt, rows, idx, values, signs, base + kChunk, T, d, j);
    int bb[kPer];
    float xv[kPer];
    unsigned bal[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float x = signs != nullptr ? __fmul_rn(cur[i].v, cur[i].sg)
                                       : cur[i].v;
      const int rb = cur[i].b - b_lo;
      const bool keep = cur[i].row == s && rb >= 0 && rb < R &&
                        cur[i].b < w && x != 0.0f;
      bb[i] = keep ? rb : -1;
      xv[i] = x;
      bal[i] = __ballot_sync(kFull, keep);
      if (lane == 0) s_cnt[i * kWarps + warp] = __popc(bal[i]);
    }
    __syncthreads();
    if (warp == 0) {          // exclusive scan over (round, warp): 2 a lane
      const int c0 = s_cnt[2 * lane], c1 = s_cnt[2 * lane + 1];
      int x = c0 + c1;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      s_cnt[2 * lane] = x - c0 - c1;
      s_cnt[2 * lane + 1] = x - c1;
      if (lane == 31) s_total = x;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (bb[i] >= 0) {
        const int at = s_cnt[i * kWarps + warp] +
                       __popc(bal[i] & ((1u << lane) - 1u));
        s_b[at] = bb[i];
        s_v[at] = xv[i];
      }
    }
    __syncthreads();
    if (tid < R) {            // every owner adds every entry, in order
      const int K = s_total;
      int k = 0;
      for (; k + 4 <= K; k += 4) {
        const int4 b4 = *reinterpret_cast<const int4*>(s_b + k);
        const float4 v4 = *reinterpret_cast<const float4*>(s_v + k);
        acc = __fadd_rn(acc, b4.x == tid ? v4.x : -0.0f);
        acc = __fadd_rn(acc, b4.y == tid ? v4.y : -0.0f);
        acc = __fadd_rn(acc, b4.z == tid ? v4.z : -0.0f);
        acc = __fadd_rn(acc, b4.w == tid ? v4.w : -0.0f);
      }
      for (; k < K; ++k) acc = __fadd_rn(acc, s_b[k] == tid ? s_v[k] : -0.0f);
    }
    __syncthreads();          // the next chunk reuses the shared arrays
#pragma unroll
    for (int i = 0; i < kPer; ++i) cur[i] = nxt[i];
  }
  if (owner) *elem = acc;
}

template <int R>
int launch(float* counts, int n, int d, int w, const int32_t* rows,
           const int32_t* idx, const float* values, const float* signs,
           int T, cudaStream_t stream) {
  const dim3 grid((unsigned)((w + R - 1) / R), (unsigned)(d * n));
  owner_kernel<R><<<grid, kT, 0, stream>>>(counts, d, w, rows, idx, values,
                                           signs, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cm_owner(float* counts, int n, int d, int w,
                        const int32_t* rows, const int32_t* idx,
                        const float* values, const float* signs, int T,
                        int range, cudaStream_t stream) {
  switch (range) {
    case 32: return launch<32>(counts, n, d, w, rows, idx, values, signs, T,
                               stream);
    case 64: return launch<64>(counts, n, d, w, rows, idx, values, signs, T,
                               stream);
    case 128: return launch<128>(counts, n, d, w, rows, idx, values, signs,
                                 T, stream);
    case 256: return launch<256>(counts, n, d, w, rows, idx, values, signs,
                                 T, stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURE = {"cm_owner": (P, I, I, I, P, P, P, P, I, I, P)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cm_owner_probe.py needs a CUDA card")
    from repro_torch import core
    from repro_torch.core import hashing
    from repro_torch.kernels import build, onehot_matmul as om

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    csrc, build_dir = build.CSRC, build.BUILD_DIR
    tmp = Path(tempfile.mkdtemp(prefix="cm_owner_"))
    try:
        build.CSRC, build.BUILD_DIR = tmp / "csrc", tmp / "build"
        build.CSRC.mkdir()
        (build.CSRC / "cm_owner.cu").write_text(SOURCE)
        build.build(["cm_owner"])
        for line in build.BUILD_LOG["cm_owner"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", flush=True)
        lib = build.load("cm_owner", SIGNATURE)
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        shutil.rmtree(tmp, ignore_errors=True)

    dev = torch.device("cuda", 0)
    b = cs.phase2_batch(dev, 0, 65536, 65536)
    cm = core.CountMin(eps=0.002, delta=0.01)
    idx = hashing.bucket_hash(b.items, cm._seeds(), cm.log2_width)
    d, w = cm.depth, cm.width
    v_int = b.vals * b.mask.float()
    v_flt = torch.rand(b.t, generator=b.gen, device=dev) * 4 * b.mask.float()
    rng = np.random.RandomState(0)
    p = 1.0 / np.arange(1, 205) ** 1.1
    rows204 = torch.from_numpy(rng.choice(204, b.t, p=p / p.sum()).astype(
        np.int32)).to(dev)
    out: dict = {}
    for label, n, rows, ranges in (("fresh n=1", 1, b.to_row0, RANGES),
                                   ("n=204", 204, rows204, (128,))):
        state0 = torch.zeros((n, d, w), device=dev)

        def owner(s, r, v):
            cs.require(lib.cm_owner(
                s.data_ptr(), n, d, w, rows.data_ptr(), idx.data_ptr(),
                v.data_ptr(), None, b.t, r,
                torch.cuda.current_stream().cuda_stream) == 0, "cm_owner")

        row = {}
        for v in (v_int, v_flt):
            want = om.onehot_scatter_add(state0.clone(), rows, idx, v)
            for r in ranges:
                got = state0.clone()
                owner(got, r, v)
                torch.cuda.synchronize()
                cs.require(cs.same_bytes(got, want),
                           f"{label} R={r}: owner bytes differ from the "
                           f"wrapper's")
        k = state0.clone()
        row["keyed_route"] = cs.device_ms(
            lambda: om.onehot_scatter_add(k, rows, idx, v_int))
        for r in ranges:
            row[f"owner_R{r}"] = cs.device_ms(lambda: owner(k, r, v_int))
        row["keyed_route_again"] = cs.device_ms(
            lambda: om.onehot_scatter_add(k, rows, idx, v_int))
        del k, state0
        print(f"{label}: device ms a call " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in row.items()) +
            "; every design the wrapper's bytes (integer and float weights)",
            flush=True)
        out[label] = row
    print(json.dumps({"cm_owner_probe": out}), flush=True)


if __name__ == "__main__":
    main()
