"""Probes of the per-system kernels K1, K3, K5 and K7 on one CUDA card:
other builds of their sources, timed in rounds beside the parent's kernel
in one process.

    python -m optiland_tpu_torch.tools.system_probes --parent DIR
    python -m optiland_tpu_torch.tools.system_probes --parent DIR --k7
    python -m optiland_tpu_torch.tools.system_probes --per-ray
    python -m optiland_tpu_torch.tools.system_probes --freeform

DIR is a checkout of the commit before K3 and K5 were built per system
(their run-time chain), for instance `git archive <commit> | tar -x -C
build/parent`. On chip_smoke.py's bench lens (2,000,000 rays and 65,536;
K3 also on the Cooke triplet at 0.55 um, on the same rays) it builds, all
nvcc processes at once:
  parent  DIR's raygen_trace_fwd.cu and fused_trace_fwd.cu;
  p1      the per-system K3 and K5 with IEEE division and square root;
  p2      the same with _build.PER_SYSTEM's approximate division and
          square root, and K5 without its blocks-an-SM bound;
  p4      p2's K5 with float4 loads and stores, 4 rays a thread
          (P4_SOURCE);
and, at 2M rays, the bench lens's K1, K3 and K5 held to m blocks an SM by
`__launch_bounds__(256, m)` (SWEEP). Each per-system build runs on a
persistent grid (at most as many blocks as fit the card at once) and on a
block a tile of 256 rays (p3, for p2). Each K3 and K5 build is held against
the plain version on the rays both leave lit (x, y, z) and timed as
`kernel_turns` times a launch (CUDA events after a `torch.cuda._sleep`
spin, the median of 25), in four rounds of alternating order. Prints, per
build, nvcc's registers and spill bytes, its SASS instruction count
(`cuobjdump -sass`) and its blocks an SM, then the card's name and power
limit and every time.

With --k7, DIR is a checkout of the commit before K7 was built per system
(its run-time chain), and the probes are K7's, on the Cooke triplet at the
flagship's 1,999,998 rays at per-ray wavelengths (chip_smoke.py
`flagship_inputs`) and on the 16,384-ray bundle of
`wavefront_data` (field (0, 1), 0.55 um, the 128 x 128 pupil grid):
  parent    DIR's history_fwd.cu;
  p0        two stripped builds of DIR's body: the chain with no stores
            (each ray's finals summed into one value a block) and a kernel
            that moves the same bytes with no chain (P0_CHAIN_SOURCE,
            P0_STORES_SOURCE);
  p1        K7 per system, each surface's values stored one float a
            thread (P3_SOURCE), with IEEE division and square root and the
            extinction tables' masked interpolation (`kv_interp`);
  p2        p1 with approximate division and square root;
  p3        p2 with `kv_segment`;
  p3 shared log  p3 with each power of w in formulas 3-5 as exp2(e log2 w);
  p4a       p3 with streaming stores (`__stcs`);
  this tree this tree's K7 as its wrapper launches it (IEEE division and
            square root, `_build.PER_SYSTEM`): the full tiles' rows by
            bulk copies from shared memory where the history outgrows the
            L2 cache (`fused.history_bulk`), else one float a thread; also
            built with approximate division and square root;
  p4b       this tree's K7 with bulk copies at every size, and ("per
            thread") with one float a thread at every size;
  p4c       p4b with four sets of staging rows and one block barrier a
            surface (P4C_SOURCE), this tree's arithmetic;
  p5        this tree's K7 held to m blocks an SM by
            `__launch_bounds__(256, m)` (K7_SWEEP), at the flagship's size;
and the store paths (p3, p4a, this tree, p4b, per thread) also at the
flagship's first 65,536, 262,144, 524,288 and 1,048,576 rays, whose rows
start on 32-byte sectors, and at its first 262,142, 1,048,574 and
1,999,872;
each per-system build on a persistent grid and on a block a tile, each
held against `_history_plain` on the rays both leave lit at every surface
(all 8 arrays, all S rows) and against the parent's own history (the
share of floats that differ, bit for bit), and timed as above; and, on
the CPU, the shared
logarithm's accuracy over the catalog (`shared_log_excess`).

With --per-ray (no DIR), the probes are the per-ray variants of the
backward kernels K2, K4 and K6 on the Cooke triplet at the flagship's
1,999,998 rays at per-ray wavelengths and at their first 16,384: the
committed build, whose re-trace records each surface's index and alpha
at the ray's w (two floats a surface more in the per-thread record), and
a build with OTK_MEDIA_RECOMPUTE, whose reverse sweep evaluates them
again from w; both through the wrappers (K2 without the data cotangents,
K4 seeded on x, y and opd, K6 on 8 seeds), each launch timed as
kernel_turns times it, in four rounds of alternating order, the
one-wavelength Cooke K2 at 0.55 um beside; each build's K2 held to its
plain version (`chip_smoke.cotangent_errs`) and its registers, stack
frame and SASS count printed.

With --freeform (no DIR), the probes are the freeform branch's builds of
chip_smoke.py's phase j5 (systems G, H and I; K5 and K6 on I's vignetted
twin), K1-K7 at one wavelength (0.55 um) and at the flagship batch's
per-ray wavelengths: each build's registers, stack frame, spill bytes and
SASS count, the blocks an SM of the per-system builds (their occupancy
query; the backward kernels run a persistent grid of one block an SM,
`fused.backward_grid`), the threads `fused._backward_launch` gives the
per-ray backward block of a 64-surface system, and the card's name and
power limit. The same kernels' times are `kernel_turns`'s (`freeform_ms`).

With --long (no DIR), the same report for the builds of chip_smoke.py's
phase j6 (systems J, K and L; K5 and K6 on J's vignetted twin): a Forbes
Q-2D face, two faces past a 17-slot row (OTK_WIDE), 70 surfaces
(OTK_MAX_SURFACES in the backward kernels), with the threads
`fused._backward_launch` gives L's backward blocks at the flagship's
1,999,998 rays. Their times are `kernel_turns`'s (`long_ms`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from dataclasses import replace as dataclasses_replace
from functools import partial
from pathlib import Path

import numpy as np
import torch

from optiland_tpu_torch import _build, config
from optiland_tpu_torch.models import CookeTriplet
from optiland_tpu_torch.system.optic import Optic
from optiland_tpu_torch.tools.kernel_turns import SPIN_CYCLES, TIMED, WARMUP
from optiland_tpu_torch.tools.kernel_turns import _smoke, launch_ms
from optiland_tpu_torch.tools.kernel_turns import timed_launches
from optiland_tpu_torch.trace import fused
from optiland_tpu_torch.trace.raygen import generate_rays

SOURCES = {"K1": "moments_fwd", "K3": "raygen_trace_fwd",
           "K5": "fused_trace_fwd"}
SWEEP = {"K1": ("free", 3, 4, 5), "K3": ("free", 8),
         "K5": ("free", 3, 4, 5, 6)}
APPROX = tuple(_build.PER_SYSTEM["fused_trace_fwd"])
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"K1": [_I] * 3 + [_P] * 8, "K3": [_I] * 4 + [_P] * 15,
            "K5": [_I] * 3 + [_P] * 18}
PARENT_ARGTYPES = {"K3": [_I] * 6 + [_P] * 16, "K5": [_I] * 3 + [_P] * 19}
NS = (65_536, 2_000_000)
# K5 with float4 loads and stores across rays, 4 rays a thread, under K5's
# C names and signature (n a multiple of 4)
P4_SOURCE = r"""
#include "system_chain.cuh"
namespace {
constexpr int THREADS = otk::SYSTEM_THREADS;
__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set(float4& v, int j, float a) {
  if (j == 0) v.x = a;
  else if (j == 1) v.y = a;
  else if (j == 2) v.z = a;
  else v.w = a;
}
__global__ void __launch_bounds__(THREADS)
k5_f4(int n4, const float* __restrict__ ftab, const float4* __restrict__ x,
      const float4* __restrict__ y, const float4* __restrict__ z,
      const float4* __restrict__ L, const float4* __restrict__ M,
      const float4* __restrict__ N, const float4* __restrict__ i,
      const float4* __restrict__ opd, float4* __restrict__ ox, float4* __restrict__ oy,
      float4* __restrict__ oz, float4* __restrict__ oL, float4* __restrict__ oM,
      float4* __restrict__ oN, float4* __restrict__ oi, float4* __restrict__ oopd) {
  __shared__ float s_ft[OTK_S * otk::F_STRIDE];
  otk::stage_system(ftab, nullptr, s_ft, nullptr);
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < n4; q += gridDim.x * THREADS) {
    const float4 a[8] = {x[q], y[q], z[q], L[q], M[q], N[q], i[q], opd[q]};
    float4 o[8];
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      otk::Ray r = {comp(a[0], j), comp(a[1], j), comp(a[2], j), comp(a[3], j),
                    comp(a[4], j), comp(a[5], j), comp(a[6], j), comp(a[7], j)};
      otk::trace_system(s_ft, r);
      set(o[0], j, r.x);
      set(o[1], j, r.y);
      set(o[2], j, r.z);
      set(o[3], j, r.L);
      set(o[4], j, r.M);
      set(o[5], j, r.N);
      set(o[6], j, r.i);
      set(o[7], j, r.opd);
    }
    ox[q] = o[0];
    oy[q] = o[1];
    oz[q] = o[2];
    oL[q] = o[3];
    oM[q] = o[4];
    oN[q] = o[5];
    oi[q] = o[6];
    oopd[q] = o[7];
  }
}
}  // namespace
extern "C" int fused_trace_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k5_f4, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
extern "C" int fused_trace_fwd(int n, int S, int blocks, const void* ftab, const void* x,
                               const void* y, const void* z, const void* L, const void* M,
                               const void* N, const void* i, const void* opd, void* ox,
                               void* oy, void* oz, void* oL, void* oM, void* oN, void* oi,
                               void* oopd, void* stream) {
  if (S != OTK_S || blocks < 1 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float4*>(p); };
  const auto out = [](void* p) { return static_cast<float4*>(p); };
  k5_f4<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n / 4, static_cast<const float*>(ftab), in(x), in(y), in(z), in(L), in(M), in(N),
      in(i), in(opd), out(ox), out(oy), out(oz), out(oL), out(oM), out(oN), out(oi),
      out(oopd));
  return static_cast<int>(cudaGetLastError());
}
"""


def _sources(parent: Path, out: Path) -> dict:
    """{build name: (kernel, source path, include dir, lens or None, nvcc
    flags)}; the sweep's and p2's K5 sources are written to `out`, each
    with its own `__launch_bounds__`."""
    csrc = _build.CSRC
    jobs = {f"parent {k}": (k, parent / f"{SOURCES[k]}.cu", parent, None, ())
            for k in ("K3", "K5")}
    for key, mins in SWEEP.items():
        src = re.sub(r"__launch_bounds__\([^)]*\)", "__launch_bounds__(THREADS)",
                     (csrc / f"{SOURCES[key]}.cu").read_text())
        for m in mins:   # unbounded: p2 on the bench lens
            path = out / f"{key}_{m}.cu"
            path.write_text(src if m == "free" else src.replace(
                "__launch_bounds__(THREADS)", f"__launch_bounds__(THREADS, {m})"))
            name = f"p2 {key} bench" if m == "free" else f"{key} {m} an SM"
            jobs[name] = (key, path, csrc, "bench", APPROX)
    jobs["p1 K3 bench"] = ("K3", out / "K3_free.cu", csrc, "bench", ())
    jobs["p1 K3 cooke"] = ("K3", out / "K3_free.cu", csrc, "cooke", ())
    jobs["p2 K3 cooke"] = ("K3", out / "K3_free.cu", csrc, "cooke", APPROX)
    jobs["p1 K5 bench"] = ("K5", out / "K5_free.cu", csrc, "bench", ())
    (out / "p4.cu").write_text(P4_SOURCE)
    jobs["p4 K5 bench"] = ("K5", out / "p4.cu", csrc, "bench", APPROX)
    return jobs


def _build_all(jobs: dict, out: Path, defines: dict) -> dict:
    """{build name: (kernel, lens, library, nvcc's log)}, all nvcc processes
    at once; raises if one fails."""
    procs = {}
    for k, (name, (key, src, inc, lens, flags)) in enumerate(jobs.items()):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, f"-I{inc}"]
        if lens:
            header = out / f"{lens}.h"
            header.write_text(_build.defines_header(defines[lens]))
            cmd += ["-include", str(header)]
        lib = out / f"libprobe{k}.so"
        procs[name] = (key, lens, lib, subprocess.Popen(
            [*cmd, "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (key, lens, lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (key, lens, lib, log)
    return built


# ---------------------------------------------------------------------------
# K7: the history trace at per-ray wavelengths
# ---------------------------------------------------------------------------
# every build at the flagship's and the bundle's sizes; the store paths
# (p3, p4a, this tree, p4b) also at the flagship's first n rays, n between
K7_NS = {"flagship": 1_999_998, "bundle": 16_384, "flagship 65536": 65_536,
         "flagship 262144": 262_144, "flagship 524288": 524_288,
         "flagship 1048576": 1_048_576, "flagship 262142": 262_142,
         "flagship 1048574": 1_048_574, "flagship 1999872": 1_999_872}
K7_STORE_PATHS = ("parent K7", "p3", "p4a", "this tree")
K7_SWEEP = (2, 3, 5)
# the parent's K7 (run-time chain) and its two stripped builds share its C
# name and signature: n, S, n_newton, mat_w, K, ftab, itab, mat, kwl, kval,
# 9 ray pointers, 8 history pointers, stream
K7_PARENT_ARGTYPES = [_I] * 5 + [_P] * 23
K7_ARGTYPES = [_I] * 6 + [_P] * 22
# (p0) the parent's chain with no stores: each ray's 8 finals summed, and
# the block's sum written to hx[blockIdx.x], so that nothing is eliminated
P0_CHAIN_SOURCE = r"""
#include "chain.cuh"
namespace {
struct Rays9 { const float* p[9]; };
__global__ void __launch_bounds__(otk::BLOCK)
p0_chain(int n, int S, int n_newton, int mat_w, int K, const float* __restrict__ ftab,
         const int* __restrict__ itab, const float* __restrict__ mat,
         const float* __restrict__ kwl, const float* __restrict__ kval, Rays9 rays,
         float* __restrict__ fold) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  __shared__ float s_mat[otk::MAX_SURFACES * otk::MAT_SHARED];
  __shared__ float s_fold[otk::BLOCK];
  otk::stage_materials(S, mat_w, mat, s_mat);
  otk::stage_tables(S, ftab, itab, nullptr, s_ft, s_it, nullptr);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.f;
  if (idx < n) {
    otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                  rays.p[4][idx], rays.p[5][idx], rays.p[6][idx], rays.p[7][idx]};
    const otk::Dispersion disp = {mat, s_mat, kwl, kval, mat_w, K, rays.p[8][idx]};
    otk::trace_chain(S, n_newton, s_ft, s_it, r, nullptr, &disp);
    v = r.x + r.y + r.z + r.L + r.M + r.N + r.i + r.opd;
  }
  s_fold[threadIdx.x] = v;
  __syncthreads();
  for (int h = otk::BLOCK / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s_fold[threadIdx.x] += s_fold[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) fold[blockIdx.x] = s_fold[0];
}
}  // namespace
extern "C" int history_fwd(int n, int S, int n_newton, int mat_w, int K, const void* ftab,
                           const void* itab, const void* mat, const void* kwl,
                           const void* kval, const void* x, const void* y, const void* z,
                           const void* L, const void* M, const void* N, const void* i,
                           const void* opd, const void* w, void* hx, void*, void*, void*,
                           void*, void*, void*, void*, void* stream) {
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  Rays9 rays = {{in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), in(w)}};
  p0_chain<<<(n + otk::BLOCK - 1) / otk::BLOCK, otk::BLOCK, 0,
             static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, mat_w, K, in(ftab), static_cast<const int*>(itab), in(mat), in(kwl),
      in(kval), rays, static_cast<float*>(hx));
  return static_cast<int>(cudaGetLastError());
}
"""
# (p0) the parent's bytes without its chain: each ray's 9 floats read, and
# its 8 arrays' values written to all S rows at k n + idx, one ray a thread
P0_STORES_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstddef>
namespace {
struct Rays9 { const float* p[9]; };
struct History { float* p[8]; };
__global__ void __launch_bounds__(256) p0_stores(int n, int S, Rays9 rays, History hist) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float v[8];
  for (int q = 0; q < 8; ++q) v[q] = rays.p[q][idx];
  const float w = rays.p[8][idx];
  for (int k = 0; k < S; ++k) {
    const size_t o = (size_t)k * n + idx;
    for (int q = 0; q < 8; ++q) hist.p[q][o] = v[q] + k * w;
  }
}
}  // namespace
extern "C" int history_fwd(int n, int S, int, int, int, const void*, const void*,
                           const void*, const void*, const void*, const void* x,
                           const void* y, const void* z, const void* L, const void* M,
                           const void* N, const void* i, const void* opd, const void* w,
                           void* hx, void* hy, void* hz, void* hL, void* hM, void* hN,
                           void* hi, void* hopd, void* stream) {
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  Rays9 rays = {{in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), in(w)}};
  History hist = {{out(hx), out(hy), out(hz), out(hL), out(hM), out(hN), out(hi), out(hopd)}};
  p0_stores<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(n, S, rays, hist);
  return static_cast<int>(cudaGetLastError());
}
"""
# (p1-p4a) K7 with each surface's 8 values stored one float a thread, at
# k n + idx, as the chain computes them: this tree's kernel before its
# bulk copies, under its C names and signature (`bulk` is not read)
P3_SOURCE = r"""
#include "system_chain.cuh"
namespace {
constexpr int THREADS = otk::SYSTEM_THREADS;
struct Rays9 { const float* p[9]; };
struct History { float* p[8]; };
struct HistorySink {
  History h;
  size_t n, idx;
  __device__ __forceinline__ void operator()(int k, const otk::Ray& r) const {
    const size_t o = (size_t)k * n + idx;
    h.p[0][o] = r.x;
    h.p[1][o] = r.y;
    h.p[2][o] = r.z;
    h.p[3][o] = r.L;
    h.p[4][o] = r.M;
    h.p[5][o] = r.N;
    h.p[6][o] = r.i;
    h.p[7][o] = r.opd;
  }
};
__global__ void __launch_bounds__(THREADS)
history_fwd_kernel(int n, int mat_w, int K, const float* __restrict__ ftab,
                   const float* __restrict__ mat, const float* __restrict__ kwl,
                   const float* __restrict__ kval, Rays9 rays, History hist) {
  __shared__ float s_ft[OTK_S * otk::F_STRIDE];
  __shared__ float s_mat[OTK_S * otk::MAT_SHARED];
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
  otk::stage_system(ftab, nullptr, s_ft, nullptr);
  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < n; idx += gridDim.x * THREADS) {
    otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                  rays.p[4][idx], rays.p[5][idx], rays.p[6][idx], rays.p[7][idx]};
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, rays.p[8][idx]};
    const HistorySink sink = {hist, (size_t)n, (size_t)idx};
    sink(0, r);
    otk::trace_system(s_ft, media, r, sink);
  }
}
}  // namespace
extern "C" int history_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, history_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
extern "C" int history_fwd(int n, int S, int blocks, int, int mat_w, int K, const void* ftab,
                           const void* mat, const void* kwl, const void* kval,
                           const void* x, const void* y, const void* z, const void* L,
                           const void* M, const void* N, const void* i, const void* opd,
                           const void* w, void* hx, void* hy, void* hz, void* hL, void* hM,
                           void* hN, void* hi, void* hopd, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const Rays9 rays = {{in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), in(w)}};
  const History hist = {{out(hx), out(hy), out(hz), out(hL), out(hM), out(hN), out(hi),
                         out(hopd)}};
  history_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, mat_w, K, in(ftab), in(mat), in(kwl), in(kval), rays, hist);
  return static_cast<int>(cudaGetLastError());
}
"""
# (p4c) this tree's K7, bulk copies at every size, with four sets of
# staging rows and one block barrier a surface: before the barrier that
# releases a surface's rows to the bulk copy, thread 0 waits for the copy
# that read the set the next surface writes (`bulk` is not read)
P4C_SOURCE = r"""
#include "system_chain.cuh"
namespace {
constexpr int THREADS = otk::SYSTEM_THREADS;
constexpr int ROW = THREADS + 4;
constexpr int BUFS = 4;
struct Rays9 { const float* p[9]; };
struct History { float* p[8]; };
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))),
                  "r"(bytes) : "memory");
}
struct BulkSink {
  History h;
  size_t n, t0;
  float (*buf)[8][ROW];
  int* step;
  bool full;
  __device__ __forceinline__ void operator()(int k, const otk::Ray& r) const {
    const float v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    const size_t start = (size_t)k * n + t0;
    const int tid = threadIdx.x;
    if (!full) {
#pragma unroll
      for (int q = 0; q < 8; ++q) h.p[q][start + tid] = v[q];
      return;
    }
    const int mis = static_cast<int>(start & 3);
    const int head = (4 - mis) & 3;
    const int body = (THREADS - head) & ~3;
    const int b = (*step)++ % BUFS;
    if (tid < head || tid >= head + body) {
#pragma unroll
      for (int q = 0; q < 8; ++q) h.p[q][start + tid] = v[q];
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) buf[b][q][tid + mis] = v[q];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(BUFS - 2) : "memory");
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) bulk_store(h.p[q] + start + head, &buf[b][q][head + mis], body * 4);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
};
__global__ void __launch_bounds__(THREADS)
history_fwd_kernel(int n, int mat_w, int K, const float* __restrict__ ftab,
                   const float* __restrict__ mat, const float* __restrict__ kwl,
                   const float* __restrict__ kval, Rays9 rays, History hist) {
  __shared__ float s_ft[OTK_S * otk::F_STRIDE];
  __shared__ float s_mat[OTK_S * otk::MAT_SHARED];
  __shared__ alignas(16) float buf[BUFS][8][ROW];
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
  otk::stage_system(ftab, nullptr, s_ft, nullptr);
  int step = 0;
  for (int t0 = blockIdx.x * THREADS; t0 < n; t0 += gridDim.x * THREADS) {
    const int idx = t0 + threadIdx.x;
    if (idx >= n) continue;
    otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                  rays.p[4][idx], rays.p[5][idx], rays.p[6][idx], rays.p[7][idx]};
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, rays.p[8][idx]};
    const BulkSink sink = {hist, (size_t)n, (size_t)t0, buf, &step, t0 + THREADS <= n};
    sink(0, r);
    otk::trace_system(s_ft, media, r, sink);
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
}  // namespace
extern "C" int history_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, history_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
extern "C" int history_fwd(int n, int S, int blocks, int, int mat_w, int K,
                           const void* ftab, const void* mat, const void* kwl, const void* kval,
                           const void* x, const void* y, const void* z, const void* L,
                           const void* M, const void* N, const void* i, const void* opd,
                           const void* w, void* hx, void* hy, void* hz, void* hL, void* hM,
                           void* hN, void* hi, void* hopd, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const Rays9 rays = {{in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), in(w)}};
  const History hist = {{out(hx), out(hy), out(hz), out(hL), out(hM), out(hN), out(hi),
                         out(hopd)}};
  history_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, mat_w, K, in(ftab), in(mat), in(kwl), in(kval), rays, hist);
  return static_cast<int>(cudaGetLastError());
}
"""


def _edited_csrc(out: Path, name: str, edits, kernel=None) -> Path:
    """A copy of csrc's K7 sources in out/name, history_fwd.cu replaced by
    `kernel` where given, with `edits`, (file, regex, replacement) triples,
    each of which must apply."""
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for f in ("chain.cuh", "system_chain.cuh", "history_fwd.cu"):
        text = (_build.CSRC / f).read_text()
        if f == "history_fwd.cu" and kernel is not None:
            text = kernel
        for file, pattern, repl in edits:
            if file == f:
                text, count = re.subn(pattern, repl, text)
                if not count:
                    raise RuntimeError(f"{name}: {pattern!r} not in {f}")
        (d / f).write_text(text)
    return d


def _k7_sources(parent: Path, out: Path) -> dict:
    """{build name: (kernel, source path, include dir, lens or None, nvcc
    flags)} of K7's probes; every per-system build is the Cooke
    triplet's."""
    (out / "p0_chain.cu").write_text(P0_CHAIN_SOURCE)
    (out / "p0_stores.cu").write_text(P0_STORES_SOURCE)
    jobs = {"parent K7": ("K7p", parent / "history_fwd.cu", parent, None, ()),
            "p0 chain": ("K7p", out / "p0_chain.cu", parent, None, ()),
            "p0 stores": ("K7p", out / "p0_stores.cu", parent, None, ())}
    masked = [("system_chain.cuh", r"kv_segment\(", "kv_interp(")]
    shared_log = [("chain.cuh", r"powf\(w, (c\[[^\]]+\])\)",
                   r"exp2f(\1 * log2f(w))")]
    stcs = [("history_fwd.cu", r"h\.p\[(\d)\]\[o\] = (r\.\w+);",
             r"__stcs(&h.p[\1][o], \2);")]
    for name, edits, flags in (("p1", masked, ()), ("p2", masked, APPROX),
                               ("p3", [], APPROX),
                               ("p3 shared log", shared_log, APPROX),
                               ("p4a", stcs, APPROX)):
        d = _edited_csrc(out, name.replace(" ", "_"), edits, P3_SOURCE)
        jobs[name] = ("K7", d / "history_fwd.cu", d, "cooke", flags)
    own = tuple(_build.PER_SYSTEM["history_fwd"])
    jobs["this tree"] = ("K7", _build.CSRC / "history_fwd.cu", _build.CSRC,
                         "cooke", own)
    jobs["this tree approx"] = ("K7", _build.CSRC / "history_fwd.cu",
                                _build.CSRC, "cooke", APPROX)
    d = _edited_csrc(out, "p4c", [], P4C_SOURCE)
    jobs["p4c"] = ("K7", d / "history_fwd.cu", d, "cooke", own)
    for m in K7_SWEEP:
        d = _edited_csrc(out, f"p5_{m}", [(
            "history_fwd.cu", r"__launch_bounds__\(THREADS\)",
            f"__launch_bounds__(THREADS, {m})")])
        jobs[f"p5 {m} an SM"] = ("K7", d / "history_fwd.cu", d, "cooke", own)
    return jobs


def _index_f32(formula, c, w, pow_w):
    """`material_index` of formula 3, 4 or 5 in float32 arithmetic, in the
    kernel's order, with `pow_w(w, e)` for the powers of w."""
    c, w = c.astype(np.float32), w.astype(np.float32)
    nc, first = len(c), 1
    n2 = np.full_like(w, c[0])
    if formula == 4:
        w2, first = w * w, 9
        if nc > 4:
            n2 = n2 + c[1] * pow_w(w, c[2]) / (w2 - np.power(c[3], c[4]))
        if nc > 8:
            n2 = n2 + c[5] * pow_w(w, c[6]) / (w2 - np.power(c[7], c[8]))
    for k in range(first, nc - 1, 2):
        n2 = n2 + c[k] * pow_w(w, c[k + 1])
    return n2 if formula == 5 else np.sqrt(n2)


def shared_log_excess() -> dict:
    """The shared-logarithm lever's accuracy, on the CPU: for every catalog
    glass of formulas 3, 4 and 5 at 9 wavelengths over 0.4-0.8 um (within
    its range), the float32 index with w^e as exp2(e log2 w), log2 w taken
    once, against the powf form, each against the float64
    `material_index`; float32 arithmetic with log2, exp2 and pow each
    rounded once from float64 (correctly rounded). Returns the worst excess
    of the first over the second in float32 ulps of the index, and its
    glass."""
    import torch as _torch

    from optiland_tpu_torch.materials import catalog
    from optiland_tpu_torch.materials.dispersion import material_index

    def f32(a):
        return np.asarray(a, np.float64).astype(np.float32)

    worst, glasses = (-np.inf, None), 0
    for row in catalog._load_catalog():
        if row.get("formula") not in (3, 4, 5):
            continue
        lo, hi = max(0.4, row["wmin"]), min(0.8, row["wmax"])
        if lo > hi:
            continue
        spec = catalog._spec_from_row(row, row["n"])
        c = np.asarray(spec.coefficients, dtype=np.float64)
        w = np.linspace(lo, hi, 9)
        ref = material_index(spec.formula, spec.n_coeffs,
                             _torch.from_numpy(c),
                             _torch.from_numpy(w)).numpy()
        if not np.isfinite(ref).all():
            continue
        w64 = f32(w).astype(np.float64)
        lw = f32(np.log2(w64))
        by_pow = _index_f32(spec.formula, c, w, lambda _w, e: f32(
            w64 ** np.float64(e)))
        by_log = _index_f32(spec.formula, c, w, lambda _w, e: f32(
            np.exp2((e * lw).astype(np.float64))))
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        excess = float(((np.abs(by_log - ref) - np.abs(by_pow - ref))
                        / ulp).max())
        worst = max(worst, (excess, row["n"]))
        glasses += 1
    return {"glasses": glasses, "worst_excess_ulps": worst[0],
            "worst_glass": worst[1]}


def _parent_int_table(static, device):
    """The run-time K7's (S, 16) int table: geometry, coefficient count,
    interaction, tilt, decenter, aperture, the medium's formula and
    coefficient count, its absorption."""
    rows = [[static.geom_codes[k], static.geom_n_coeffs[k],
             static.interactions[k], int(static.has_tilt[k]),
             int(static.has_decenter[k]), int(static.has_aperture[k]),
             static.mat_formulas[k], static.mat_n_coeffs[k],
             int(static.has_absorption[k])] + [0] * 7
            for k in range(static.num_surfaces)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def k7_main(parent: Path):
    """K7's probes on the Cooke triplet: the flagship's 1,999,998 rays at
    per-ray wavelengths and the 16,384-ray wavefront bundle."""
    from optiland_tpu_torch.wavefront.core import pupil_grid_coords

    cs = _smoke()
    print(json.dumps({"shared_log": shared_log_excess()}), flush=True)
    config.set_precision("float32")
    dev = torch.device("cuda")
    static, params = CookeTriplet().build(device="cuda")
    out = _build.BUILD_ROOT.parent / "system_probes_k7"
    out.mkdir(parents=True, exist_ok=True)
    built = _build_all(_k7_sources(parent, out), out,
                       {"cooke": fused.history_defines(static)})
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    report, fns = {}, {}
    for name, (key, _, lib, log) in built.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        handle = ctypes.CDLL(str(lib))
        fn = handle.history_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = K7_PARENT_ARGTYPES if key == "K7p" else K7_ARGTYPES
        fns[name] = fn
        report[name] = {
            "registers": re.findall(r"Used (\d+) registers", log),
            "spill_bytes": re.findall(r"(\d+) bytes spill stores", log),
            "sass": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass))}
        if key == "K7":
            report[name]["blocks_an_sm"] = handle.history_fwd_blocks_per_sm()
    p7 = (fused._diff_params(params), fused._nondiff_params(params))
    px_b, py_b, _ = pupil_grid_coords(128, torch.float32, dev)
    n_sm = config.sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    itab = _parent_int_table(static, dev)
    calls, errors, alive = {}, {}, [itab]
    for size, n in K7_NS.items():
        if size.startswith("flagship"):
            r0 = generate_rays(static, params, *(
                a[:n] for a in cs.flagship_inputs(params, dev)))
        else:
            r0 = generate_rays(static, params, torch.zeros_like(px_b),
                               torch.ones_like(px_b), px_b, py_b, 0.55,
                               apply_vignetting=False)
        rays9 = tuple(getattr(r0, k).detach().contiguous()
                      for k in fused._RAY_KEYS)
        if rays9[0].numel() != n:
            raise RuntimeError(f"{size}: {rays9[0].numel()} rays, not {n}")
        _, args, outs, keep = fused.k7_launch(static, *p7, rays9)
        ref = fused._history_plain(static, *p7, rays9)
        # args: n, S, blocks, bulk, mat_w, K, ftab, mat, kwl, kval, rays, hist
        parent_args = [n, static.num_surfaces,
                       min(static.newton_iters, fused._NEWTON_FUSED_MAX),
                       args[4], args[5], args[6], itab.data_ptr(), *args[7:]]
        alive.append((rays9, outs, keep))
        tiles = -(-n // fused._SYSTEM_THREADS)
        runs = []
        for name, (key, *_rest) in built.items():
            if size not in ("flagship", "bundle") and name not in K7_STORE_PATHS:
                continue
            if key == "K7p":
                runs.append((f"{name} {size}", partial(
                    fns[name], *parent_args, stream), not name.startswith("p0")))
                continue
            if " an SM" in name and size != "flagship":
                continue
            persistent = min(tiles, n_sm * report[name]["blocks_an_sm"])
            # this tree's K7 as its wrapper launches it, (p4b) with bulk
            # copies at every size and with one float a thread at every size
            for label, bulk in ((name, args[3]), ("p4b", 1), ("per thread", 0))[
                    :3 if name == "this tree" else 1]:
                for grid, blocks in (("persistent", persistent),
                                     ("a block a tile", tiles)):
                    runs.append((f"{label} {grid} {size}", partial(
                        fns[name], *args[:2], blocks, bulk, *args[4:],
                        stream), True))
        parent_out = None
        for label, call, check in runs:
            for o in outs:
                o.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label}: launch failed")
            torch.cuda.synchronize()
            calls[label] = call
            if parent_out is None:   # the parent's history, run first
                parent_out = [o.clone() for o in outs]
            if check:
                keep_h = ((outs[6] > 0) == (ref[6] > 0)).all(dim=0)
                errors[label] = {"lit_differs": 1.0 - keep_h.float().mean(
                    ).item()}
                errors[label].update({
                    key: (outs[k] - ref[k])[:, keep_h].abs().max().item()
                    for k, key in enumerate(fused._NAMES)})
                # against the parent's history: the share of its floats
                # that differ at all, and the largest difference
                errors[label]["parent_differs"] = sum(
                    (o != q).sum().item() for o, q in zip(outs, parent_out)
                    ) / (8 * outs[0].numel())
                errors[label]["parent_max_diff"] = max(
                    (o - q).abs().max().item() for o, q in zip(outs, parent_out))
        del ref, r0, parent_out
    print(json.dumps({"builds": report, "errors": errors}), flush=True)
    ms = {label: [] for label in calls}
    for r in range(4):
        for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            ms[label].append(_kernel_ms(calls[label]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"rounds": 4, "ms": ms}))


def _kernel_ms(call):
    """Median CUDA-event span of 25 launches of `call` after a warm-up,
    each after a `torch.cuda._sleep` spin, as kernel_turns times them."""
    for _ in range(WARMUP):
        call()
    spans = []
    for _ in range(TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        call()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in spans]))


BWD_SOURCES = {"K2": "moments_bwd", "K4": "raygen_trace_bwd",
               "K6": "fused_trace_bwd"}


def per_ray_main():
    """--per-ray: the per-ray backward kernels with the media recorded
    (committed) or recomputed in the reverse sweep (module docstring)."""
    cs = _smoke()
    config.set_precision("float32")
    dev = torch.device("cuda")
    static, params = CookeTriplet().build(device="cuda")
    fb = cs.flagship_inputs(params, dev)
    p, data = fused._prepare(static, params, *fb)
    r0 = generate_rays(static, params, *fb)
    rays9 = tuple(getattr(r0, k).detach().contiguous() for k in fused._RAY_KEYS)
    p9 = p[:2]
    p_one, data_one = fused._prepare(static, params, *fb[:4], 0.55)
    rng = np.random.default_rng(1)
    c = torch.tensor([0.3, -0.7, 0.5, 1.1], device=dev)
    own_defines = fused.media_defines
    builds = {"record": own_defines,
              "recompute": lambda st: own_defines(st) + (
                  ("OTK_MEDIA_RECOMPUTE", "1"),)}
    _build.build_all(tuple((src, of(static)) for of in builds.values()
                           for src in BWD_SOURCES.values()))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    report = {}
    for build, of in builds.items():
        for key, src in BWD_SOURCES.items():
            name = _build.variant_name(src, of(static))
            log = _build.build_log(name)
            sass = subprocess.run(
                [str(cuobjdump), "-sass", str(_build.build_dir()
                                              / f"lib{name}.so")],
                capture_output=True, text=True).stdout
            report[f"{key} {build}"] = {
                "registers": re.findall(r"Used (\d+) registers", log),
                "stack_bytes": re.findall(r"(\d+) bytes stack frame", log),
                "spill_bytes": re.findall(r"(\d+) bytes spill stores", log),
                "sass": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass))}
    def calls(n):
        d, r9 = (tuple(a[:n].contiguous() for a in x) for x in (data, rays9))
        seeds = [torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev) for _ in range(8)]
        return {
            "K2": lambda: fused.moments_backward(static, *p, d, c, False),
            "K4": lambda: fused.raygen_trace_backward(static, *p, d,
                                                      (0, 1, 7), seeds[:3]),
            "K6": lambda: fused.fused_trace_backward(static, *p9, r9, seeds)}

    ns = (fb[0].shape[0], 16_384)
    runs = {n: calls(n) for n in ns}
    one = {n: (lambda n=n: fused.moments_backward(
        static, *p_one, tuple(a[:n].contiguous() for a in data_one), c,
        False)) for n in ns}
    ms, errs = {}, {}
    spans, restore = timed_launches(fused)
    try:
        for rnd in range(4):
            order = list(builds) if rnd % 2 == 0 else list(builds)[::-1]
            for build in order:
                fused.media_defines = builds[build]
                for n in ns:
                    for key, call in runs[n].items():
                        ms.setdefault(f"{key} {build} {n}", []).append(
                            launch_ms(call, spans))
            for n in ns:
                ms.setdefault(f"K2 one wavelength {n}", []).append(
                    launch_ms(one[n], spans))
        for build in builds:
            fused.media_defines = builds[build]
            got = fused.moments_backward(static, *p, data, c, True)
            ref = fused._moments_bwd_plain(static, *p, data, c, True)
            keep = fused._raygen_trace_plain(static, *p, data, (6,))[0] > 0
            errs[build] = cs.cotangent_errs(got, ref, keep)[:2]
    finally:
        restore()
        fused.media_defines = own_defines
    print(json.dumps({"builds": report, "K2 vs plain": errs}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"rounds": 4, "ms": ms}))


def freeform_main(long=False):
    """--freeform: the builds of the freeform branch, or with `long`
    (--long) those of phase j6 (module docstring); their times are
    `kernel_turns.freeform_ms`'s and `long_ms`'s."""
    cs = _smoke()
    config.set_precision("float32")
    dev = torch.device("cuda")
    if long:
        systems = {"J": cs.q2d_singlet(Optic),
                   "K": cs.wide_freeform_singlet(Optic),
                   "L": cs.relay_train(Optic),
                   "J vignetted": cs.q2d_singlet(Optic, True)}
    else:
        systems = {"G": cs.anamorphic_singlet(Optic),
                   "H": cs.xy_freeform_singlet(Optic),
                   "I": cs.tilted_freeform_singlet(Optic),
                   "I vignetted": cs.tilted_freeform_singlet(Optic, True)}
    built = {label: lens.build(device="cuda")
             for label, lens in systems.items()}
    srcs = dict(SOURCES, K7="history_fwd", **BWD_SOURCES)
    jobs = {}
    for label, (st, _) in built.items():
        keys = ("K5", "K6") if label.endswith("vignetted") else (
            "K1", "K2", "K3", "K4", "K7")
        for key in keys:
            for cfg in ("0.55", "per-ray"):
                if key == "K7" and cfg == "0.55":
                    continue
                if key in BWD_SOURCES:
                    defines = fused.backward_defines(st, cfg == "per-ray")
                elif cfg == "per-ray" or key == "K7":
                    defines = fused.history_defines(st)
                else:
                    defines = fused.system_defines(st)
                jobs[f"{key} {label} {cfg}"] = (srcs[key], defines)
    _build.build_all(tuple(v for v in set(jobs.values()) if v[1]))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    report = {}
    for job, (src, defines) in jobs.items():
        name = _build.variant_name(src, defines) if defines else src
        log = _build.build_log(name)
        lib = _build.build_dir() / f"lib{name}.so"
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        report[job] = {
            "registers": re.findall(r"Used (\d+) registers", log),
            "stack_bytes": re.findall(r"(\d+) bytes stack frame", log),
            "spill_bytes": re.findall(r"(\d+) bytes spill stores", log),
            "sass": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass))}
        if src not in BWD_SOURCES.values():
            report[job]["blocks_an_sm"] = fused._blocks_per_sm(src, defines)
    if long:
        st = built["L"][0]
        blocks = {cfg: fused._backward_launch(
            st, 1_999_998, dev, st.num_surfaces + 1, cfg == "per-ray")[:2]
            for cfg in ("0.55", "per-ray")}
        print(json.dumps({"builds": report, "L's K2 block": {
            cfg: {"blocks": b, "threads": t}
            for cfg, (b, t) in blocks.items()}}))
    else:
        wide = dataclasses_replace(built["H"][0], num_surfaces=64)
        blocks, threads, _, _ = fused._backward_launch(wide, 2_000_000, dev,
                                                       64 + 1, True)
        print(json.dumps({"builds": report,
                          "64-surface per-ray backward block": {
                              "blocks": blocks, "threads": threads}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path,
                        help="checkout of the commit with the run-time "
                             "kernels probed")
    parser.add_argument("--k7", action="store_true",
                        help="probe K7 against DIR's run-time K7")
    parser.add_argument("--per-ray", action="store_true",
                        help="probe the per-ray backward kernels' record")
    parser.add_argument("--freeform", action="store_true",
                        help="report the freeform branch's builds")
    parser.add_argument("--long", action="store_true",
                        help="report the builds of phase j6's systems")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("system_probes times CUDA kernels and needs a card")
    if opts.per_ray:
        per_ray_main()
        return
    if opts.freeform or opts.long:
        freeform_main(long=opts.long)
        return
    if opts.parent is None:
        parser.error("--parent is required unless --per-ray, --freeform or "
                     "--long")
    if opts.k7:
        k7_main(opts.parent.resolve() / "optiland_tpu_torch" / "csrc")
        return
    cs = _smoke()
    config.set_precision("float32")
    dev = torch.device("cuda")
    static, params = cs.bench_lens(Optic).build(device="cuda")
    static_v, params_v = cs.bench_lens(Optic, vignetted=True).build(
        device="cuda")
    static_c, params_c = CookeTriplet().build(device="cuda")
    out = _build.BUILD_ROOT.parent / "system_probes"
    out.mkdir(parents=True, exist_ok=True)
    built = _build_all(
        _sources(opts.parent.resolve() / "optiland_tpu_torch" / "csrc", out),
        out, {"bench": fused.system_defines(static),
              "cooke": fused.system_defines(static_c)})
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    report, fns = {}, {}
    for name, (key, _, lib, log) in built.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        handle = ctypes.CDLL(str(lib))
        fn = getattr(handle, SOURCES[key])
        fn.restype = ctypes.c_int
        fn.argtypes = (PARENT_ARGTYPES if name.startswith("parent")
                       else ARGTYPES)[key]
        fns[name] = fn
        report[name] = {
            "registers": re.findall(r"Used (\d+) registers", log),
            "spill_bytes": re.findall(r"(\d+) bytes spill stores", log),
            "sass": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass))}
        if not name.startswith("parent"):
            report[name]["blocks_an_sm"] = getattr(
                handle, f"{SOURCES[key]}_blocks_per_sm")()

    def prep(st, pr, wl):
        return fused._uniform_params(st, pr, wl) + (
            fused._raygen_scalars(st, pr),)

    systems = {"bench": (static, prep(static, params, cs.WAVELENGTH)),
               "cooke": (static_c, prep(static_c, params_c, 0.55))}
    p_v = prep(static_v, params_v, cs.WAVELENGTH)[:2]
    n_sm, stream = config.sm_count(dev), torch.cuda.current_stream(dev).cuda_stream
    rays = cs.bench_rays(dev)
    calls, errors, alive = {}, {}, []
    for n in NS:
        data = tuple(a[:n].contiguous() for a in rays)
        r0 = generate_rays(static_v, params_v, *data, cs.WAVELENGTH)
        rays8 = tuple(getattr(r0, k).detach().contiguous()
                      for k in fused._RAY_KEYS[:8])
        outs = [torch.empty(n, device=dev) for _ in range(8)]
        partials = torch.empty((-(-n // fused._SYSTEM_THREADS), 4), device=dev)
        op = [o.data_ptr() for o in outs]
        raygen, refs = {}, {}
        for lens, (st, (diffp, nondiffp, rg)) in systems.items():
            _, head, ptrs, tabs = fused._launch_args(st, rg, diffp, nondiffp,
                                                     data, "K3")
            raygen[lens] = (st.num_surfaces, head, ptrs)
            refs[lens] = fused._raygen_trace_plain(st, diffp, nondiffp, rg, data,
                                                   tuple(range(8)))
            alive.append(tabs)
        _, head_v, ptrs_v, tabs_v = fused._caller_ray_args(static_v, *p_v,
                                                           rays8, "K5")
        refs["K5"] = fused._fused_trace_plain(static_v, *p_v, rays8)
        alive.append((data, rays8, outs, partials, tabs_v))
        # (label, launch with its arguments bound, reference or None)
        runs = []
        for name, (key, lens, _, _) in built.items():
            fn = fns[name]
            if name == "parent K5":
                runs.append((f"{name} {n}", partial(
                    fn, *head_v, *ptrs_v, *op, stream), refs["K5"]))
                continue
            if name == "parent K3":
                for sys_ in ("bench", "cooke"):
                    _, head, ptrs = raygen[sys_]
                    runs.append((f"{name} {sys_} {n}", partial(
                        fn, *head, 255, *ptrs, *op, stream), refs[sys_]))
                continue
            if " an SM" in name and n != max(NS):
                continue
            S, _, ptrs = raygen[lens]
            tiles = -(-(n // 4 if name.startswith("p4") else n)
                      // fused._SYSTEM_THREADS)
            persistent = min(tiles, n_sm * report[name]["blocks_an_sm"])
            for grid, blocks in (("persistent", persistent),
                                 ("a block a tile", tiles)):
                label = f"{name} {grid} {n}"
                if key == "K1":
                    runs.append((label, partial(
                        fn, n, S, blocks, ptrs[0], ptrs[1], *ptrs[3:],
                        partials.data_ptr(), stream), None))
                elif key == "K3":
                    runs.append((label, partial(
                        fn, n, S, blocks, 255, ptrs[0], ptrs[1], *ptrs[3:],
                        *op, stream), refs[lens]))
                else:
                    runs.append((label, partial(
                        fn, n, static_v.num_surfaces, blocks, ptrs_v[0],
                        *ptrs_v[2:], *op, stream), refs["K5"]))
        for label, call, ref in runs:
            if call() != 0:
                raise RuntimeError(f"{label}: launch failed")
            torch.cuda.synchronize()
            calls[label] = call
            if ref is not None:
                lit = (outs[6] > 0) == (ref[6] > 0)
                errors[label] = {
                    "lit_differs": 1.0 - lit.float().mean().item(),
                    "xyz_mm": max((outs[j] - ref[j])[lit].abs().max().item()
                                  for j in range(3))}
        del refs
    print(json.dumps({"builds": report, "errors": errors}), flush=True)
    ms = {label: [] for label in calls}
    for r in range(4):
        for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            ms[label].append(_kernel_ms(calls[label]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"rounds": 4, "ms": ms}))


if __name__ == "__main__":
    main()
