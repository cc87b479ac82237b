"""The harness the kernel probes share: a source with one step of its
design changed (text edits of a copy), every variant built with ``nvcc``
at once and loaded through its C interface, a kernel's device time from
``torch.profiler``, and the card's name and power limit.

Imported by ``tools/bitset_probe.py`` and ``tools/dft_corr_probe.py``,
which put the repo's root and ``src/`` on ``sys.path`` first.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import chip_smoke as cs
from repro_torch.kernels import build


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them;
    printed too."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def edited(label: str, name: str, text: str, edits) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; each ``old``
    must be found exactly once."""
    for old, new in edits:
        cs.require(text.count(old) == 1,
                   f"{label}: the edited text is not in {name}.cu exactly "
                   f"once: {old!r}")
        text = text.replace(old, new)
    return text


def build_all(srcs: dict, signatures: dict, prefix: str) -> dict:
    """label -> (loaded library, source name), from ``srcs``: label ->
    (source name, its text, the directory of its headers). Every ``nvcc``
    is started at once, in a temporary directory that is removed once the
    libraries are loaded; ptxas's register and spill lines are printed.
    ``signatures``: source name -> {C function: argtypes}."""
    tmp = Path(tempfile.mkdtemp(prefix=prefix))
    try:
        procs = {}
        for i, (label, (name, text, headers)) in enumerate(srcs.items()):
            d = tmp / f"v{i}"
            d.mkdir()
            for h in headers.glob("*.cuh"):
                shutil.copy(h, d)
            (d / f"{name}.cu").write_text(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                   str(d / f"{name}.cu")]
            procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True), d, name)
        libs = {}
        for label, (proc, d, name) in procs.items():
            log, _ = proc.communicate()
            cs.require(proc.returncode == 0, f"{label}: nvcc failed\n{log}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {label}: {line.strip()}", flush=True)
            lib = ctypes.CDLL(str(d / "lib.so"))
            for fn, argtypes in signatures[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            libs[label] = (lib, name)
        return libs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernel_ms(fn, kernel: str, runs: int, prep=None) -> float:
    """The device ms a call (mean of ``runs``) of the kernels whose name
    holds ``kernel``; ``prep()``, where given, runs before each call and
    is not counted."""
    call = fn if prep is None else (lambda: (prep(), fn()))
    spans = cs.device_events(call, runs=runs)
    return sum(e - s for name, s, e in spans if kernel in name) / runs / 1e3
