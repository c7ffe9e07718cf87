"""Build and load the CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface, bound with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The libraries go to `build/optiland_tpu_torch/<digest>/` at the repository
root, keyed by a hash of every source in `csrc/`, so an edited source is
rebuilt and an unchanged one is reused. All sources are compiled in
parallel, one nvcc process each. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "optiland_tpu_torch"
SOURCES = ("moments_fwd", "moments_bwd", "raygen_trace_fwd",
           "raygen_trace_bwd", "fused_trace_fwd", "fused_trace_bwd",
           "history_fwd", "huygens_sum", "vpu_peak")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                           "of optiland_tpu_torch/csrc)")
    return nvcc


@lru_cache(maxsize=1)
def build_all() -> dict:
    """Compile every missing library, all nvcc processes at once; returns
    {name: (library path, seconds spent building it or 0.0 if cached)}."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    result = {name: (out / f"lib{name}.so", 0.0) for name in SOURCES}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
        result[name] = (lib, time.perf_counter() - t0)
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return result


def build_log(name: str) -> str:
    """nvcc's output for `name` (registers, shared memory, spills), or ''
    when the library came from an earlier build."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


@lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from `csrc/<name>.cu`."""
    return ctypes.CDLL(str(build_all()[name][0]))
