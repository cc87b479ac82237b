"""Build and load the hand-written CUDA kernels (no counterpart in the
JAX package, where Pallas compiles kernels itself).

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so

The library name carries a hash of the sources, so an edited source
rebuilds and an unchanged one is reused. The output lands in
``build/kernels`` at the root of the checkout (listed in ``.gitignore``).
Building happens at first use, never at import: the CPU tests import
every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per source: ptxas' register / shared-memory / spill report
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return path


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by a hash of the source
    and every shared header."""
    h = hashlib.sha1()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; raises with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in dict.fromkeys(names):
        out = lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    from repro_torch.kernels import ops   # counters; avoids an import cycle
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)    # atomic: a concurrent build is harmless
            ops.TRACE_COUNT[name] += 1
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C function to its ctypes ``argtypes``; every
    function returns the ``cudaError_t`` of its launches as an int."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = lib_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error (a refused or failed
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Validate one kernel operand before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_table(keys_lo, keys_hi, table_rows, sid_lo, sid_hi, t, dev) -> int:
    """Validate the routing-table mirror and the stream-id halves; returns
    the table size."""
    size = keys_lo.shape[0]
    if size & (size - 1):
        raise ValueError(f"routing table size {size} is not a power of two")
    for name, x, shape in (("keys_lo", keys_lo, (size,)),
                           ("keys_hi", keys_hi, (size,)),
                           ("table_rows", table_rows, (size,)),
                           ("sid_lo", sid_lo, (t,)),
                           ("sid_hi", sid_hi, (t,))):
        check(x, name, torch.int32, shape, dev)
    return size


def require_cuda(state: torch.Tensor) -> None:
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
