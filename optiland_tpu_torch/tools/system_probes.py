"""Probes of the per-system kernels K1, K3 and K5 on one CUDA card: other
builds of their sources, timed in rounds beside the parent's K3 and K5 in
one process.

    python -m optiland_tpu_torch.tools.system_probes --parent DIR

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
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from functools import partial
from pathlib import Path

import numpy as np
import torch

from optiland_tpu_torch import _build, config
from optiland_tpu_torch.models import CookeTriplet
from optiland_tpu_torch.system.optic import Optic
from optiland_tpu_torch.tools.kernel_turns import SPIN_CYCLES, TIMED, WARMUP
from optiland_tpu_torch.tools.kernel_turns import _smoke
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="checkout of the commit with the run-time K3, K5")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("system_probes times CUDA kernels and needs a card")
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
            "sass": len(re.findall(r"/\*[0-9a-f]{4}\*/", sass))}
        if not name.startswith("parent"):
            report[name]["blocks_an_sm"] = getattr(
                handle, f"{SOURCES[key]}_blocks_per_sm")()

    def prep(st, pr, wl):
        n_table, alpha = fused._uniform_tables(st, pr, wl)
        return (fused._diff_params(pr, n_table),
                fused._nondiff_params(pr, alpha), fused._raygen_scalars(st, pr))

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

    def kernel_ms(call):
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

    ms = {label: [] for label in calls}
    for r in range(4):
        for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            ms[label].append(kernel_ms(calls[label]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"rounds": 4, "ms": ms}))


if __name__ == "__main__":
    main()
