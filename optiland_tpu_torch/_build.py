"""Build and load the CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface, bound with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The libraries go to `build/optiland_tpu_torch/<digest>/` at the repository
root, keyed by a hash of every source in `csrc/`, so an edited source is
rebuilt and an unchanged one is reused. All sources are compiled in
parallel, one nvcc process each. A failed build raises; nothing falls back.

A per-system source (K1 `moments_fwd.cu`, K3 `raygen_trace_fwd.cu`, K5
`fused_trace_fwd.cu` and K7 `history_fwd.cu`, with their own flags in
PER_SYSTEM) is not built on its own: it takes a system's static codes as
macro definitions (a header of them, `<variant>.h`, that nvcc includes
first), and each set of definitions is a variant
`lib<name>-<signature>.so` in the same directory, built at first use
(`variant`) or up front with the others (`build_all(variants)`). The
signature hashes the definitions and the flags alone, so new parameter
values reuse a variant and new codes build another.
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
SOURCES = ("moments_bwd", "raygen_trace_bwd", "fused_trace_bwd",
           "huygens_sum", "vpu_peak")
# sources built once per system, from its codes (`variant`), and their own
# nvcc flags: K1, K3 and K5 take approximate division and square root,
# which held every one of K1's checks and cut it by a third on an H100
# (PERF.md); not -use_fast_math, whose `__tanf` moved the raygen's field.
# K7, bound by its stores, keeps IEEE arithmetic: approximate division and
# square root gained it 3% at 2M rays and changed 42% of its history's
# floats, where IEEE leaves 99% of them as the run-time chain wrote them
# (PERF.md, PR 8)
_APPROX = ("-prec-div=false", "-prec-sqrt=false")
PER_SYSTEM = {"moments_fwd": _APPROX, "raygen_trace_fwd": _APPROX,
              "fused_trace_fwd": _APPROX, "history_fwd": ()}
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


def variant_name(source: str, defines) -> str:
    """The library name of `source` built with `defines`, ((macro, value),
    ...): the source's name and a hash of the definitions and its flags."""
    sig = hashlib.sha256(repr((tuple(defines), PER_SYSTEM.get(
        source, ()))).encode()).hexdigest()[:12]
    return f"{source}-{sig}"


def defines_header(defines) -> str:
    """The definitions ((macro, value), ...) as a header's #define lines."""
    return "".join(f"#define {macro} {value}\n" for macro, value in defines)


def _compile(jobs: dict) -> dict:
    """Compile every missing library of `jobs` ({library name: (source,
    defines)}), all nvcc processes at once; returns {library name: (path,
    seconds spent building it or 0.0 if it was there)}."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, (source, defines) in jobs.items():
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        flags = list(PER_SYSTEM.get(source, ()))
        if defines:   # a header, not -D: nvcc splits -D values at commas
            header = out / f"{name}.h"
            header.write_text(defines_header(defines))
            flags += ["-include", str(header)]
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
             str(CSRC / f"{source}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    result = {name: (out / f"lib{name}.so", 0.0) for name in jobs}
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


@lru_cache(maxsize=None)
def build_all(variants=()) -> dict:
    """Compile every missing library of SOURCES and of the per-system
    `variants` ((source, defines), ...), all nvcc processes at once;
    returns {library name: (path, seconds spent building it or 0.0 if
    cached)}, a variant under `variant_name`."""
    jobs = {name: (name, ()) for name in SOURCES}
    jobs.update({variant_name(src, d): (src, tuple(d)) for src, d in variants})
    return _compile(jobs)


def build_log(name: str) -> str:
    """nvcc's output for `name` (registers, shared memory, spills), or ''
    when the library came from an earlier build."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


@lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from `csrc/<name>.cu`."""
    return ctypes.CDLL(str(build_all()[name][0]))


@lru_cache(maxsize=None)
def variant(source: str, defines) -> ctypes.CDLL:
    """The loaded library of per-system `source` built with `defines`
    ((macro, value), ...), compiled on first use; raises if nvcc fails."""
    defines = tuple(defines)
    name = variant_name(source, defines)
    return ctypes.CDLL(str(_compile({name: (source, defines)})[name][0]))
