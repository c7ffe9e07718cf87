#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. In order it:
  1. prints the card (`nvidia-smi` name and power limit) and the torch and
     CUDA versions;
  2. builds the CUDA kernels of optiland_tpu_torch/csrc with nvcc and
     prints the build time and nvcc's register report;
  3. builds the benchmark's 13-surface, 4-asphere lens in float32 on the
     card and draws 2,000,000 rays as bench.py draws them (seed 0);
  4. drives the main path through the entry points a user calls,
     `centroid_rms_spot` (reaches K1) and `trace_system_final` (reaches
     K3), with every launch counter set to 0 just before and read just
     after, and fails unless both kernels were launched;
  5. checks the outputs: finite, of the expected shape, and in agreement
     with the port's eager float64 path on the card (an independent
     implementation: full Newton, autograd-friendly ops, no kernel);
  6. holds each kernel against its plain PyTorch version on the same
     inputs, with the tolerances stated at `TOL`;
  7. times each kernel and its plain version with CUDA events (warm-up,
     then the median of 25 calls) and prints one JSON line of kernels;
  8. prints as its last line {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. Without a CUDA card,
or without the repository around it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_RAYS = 2_000_000
WAVELENGTH = 0.5876
TIMED_CALLS = 25

# Peak rates of one H100 SXM (NVIDIA's data sheet, at its 700 W limit):
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel-vs-plain tolerances, float32 on the card. The kernel contracts
# multiply-adds into FMAs and uses the hardware rsqrt, the plain version
# runs PyTorch's elementwise kernels, so the two round differently: at
# image heights up to ~25 mm and paths of ~300 mm, f32 spacing is 2e-6 mm
# and 3e-5 mm, and a 12-surface chain amplifies a few ulps per surface.
TOL = {
    "position_mm": 5e-4,     # x, y, z
    "direction": 1e-5,       # L, M, N
    "opd_mm": 2e-3,          # 12 accumulated |t n| terms of ~30 mm
    "intensity_frac": 1e-5,  # rays whose i differs (edge TIR / clipping)
    "moment_rel": 1e-4,      # moments, relative to their natural scale
}
# The main path against the eager float64 path: float32 against float64
# (kernel: capped Newton; eager: 16 iterations), same scales.
TOL_F64 = {"position_mm": 5e-4, "direction": 1e-5, "moment_rel": 1e-4,
           "loss_rel": 1e-3}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bench_lens(Optic):
    """The benchmark prescription (bench.py:33-56): 10 glass surfaces, 4
    even aspheres, imageFNO 5, angle fields 0 and 14 degrees."""
    lens = Optic("Bench10")
    inf = math.inf
    asph = (1e-7, -2e-11, 3e-15)
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=56.20238, thickness=8.75, material=1.617,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=2, radius=152.28580, thickness=0.5)
    lens.add_surface(index=3, radius=37.68262, thickness=12.5, material=1.607)
    lens.add_surface(index=4, radius=inf, thickness=3.8, material=1.603,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=5, radius=24.23130, thickness=16.369445)
    lens.add_surface(index=6, radius=inf, thickness=13.747957, is_stop=True)
    lens.add_surface(index=7, radius=-28.37731, thickness=3.8, material=1.603,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=8, radius=inf, thickness=11, material=1.620,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=9, radius=-37.92546, thickness=0.5)
    lens.add_surface(index=10, radius=177.41176, thickness=7, material=1.620)
    lens.add_surface(index=11, radius=-79.41143, thickness=61.487536)
    lens.add_surface(index=12)
    lens.set_aperture(aperture_type="imageFNO", value=5)
    lens.set_field_type("angle")
    lens.add_field(y=0)
    lens.add_field(y=14)
    lens.add_wavelength(value=WAVELENGTH, is_primary=True)
    return lens


def bench_rays(device):
    """2M rays drawn as bench.py:74-80 draws them."""
    rng = np.random.default_rng(0)
    r = np.sqrt(rng.uniform(size=N_RAYS)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, size=N_RAYS).astype(np.float32)
    Px = torch.from_numpy(r * np.cos(th)).to(device)
    Py = torch.from_numpy(r * np.sin(th)).to(device)
    Hy = torch.from_numpy(rng.uniform(-1, 1, size=N_RAYS).astype(
        np.float32)).to(device)
    return torch.zeros_like(Hy), Hy, Px, Py


def chain_ops_per_ray(static, fused):
    """FP32 operations per ray of the chain in csrc/chain.cuh for this
    system, counted from its branches: each add, subtract, multiply,
    divide, sqrt, rsqrt, tan, sin and cos counts one (an FMA two), the way
    the 67 TFLOP/s peak counts them; selects and compares count none. The
    Newton loop has a fixed trip count, so the count holds for any data."""
    ops = 32  # raygen, angle field with an infinite object
    n_newton = min(static.newton_iters, fused._NEWTON_FUSED_MAX)
    for k in range(1, static.num_surfaces):
        code, nc = static.geom_codes[k], static.geom_n_coeffs[k]
        asphere = code in (2, 3) and nc > 0
        odd = code == 3 and nc > 0
        ops += 1 + 2 + 1 + 43 + 9  # position, z shift, 1+k, conic root, step
        if static.has_tilt[k] or static.has_decenter[k]:
            ops += 4
        if static.has_tilt[k]:
            ops += 3 + 6 * 14
        if asphere:
            ops += (n_newton + 1) * (29 + 7 * nc + (6 if odd else 0))
        if static.has_aperture[k]:
            ops += 5
        if static.interactions[k] != 3:  # normal, orientation, l.n
            ops += 28 + 4 * nc + (6 if odd else 0) + 5
            ops += 7 if static.interactions[k] == 1 else 18
    return ops


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def time_ms(fn):
    """Median over TIMED_CALLS of CUDA-event time around one call, after
    three warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_CALLS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "optiland_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: optiland_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from optiland_tpu_torch import _build, config
    from optiland_tpu_torch.optimization.merits import centroid_rms_spot
    from optiland_tpu_torch.system.optic import Optic
    from optiland_tpu_torch.trace import fused, tracer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. build the kernels from the sources in the checkout
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{k} {v[1]:.1f} s" for k, v in built.items()))
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. the lens and the rays
    config.set_precision("float32")
    static, params = bench_lens(Optic).build(device="cuda")
    check(static.num_surfaces == 13 and static.fused_newton_ok,
          "bench lens: 13 surfaces, Newton guard passes")
    check(fused.supports_fused(static) and fused.supports_fused_raygen(static),
          "bench lens inside both fused gates")
    Hx, Hy, Px, Py = bench_rays(dev)
    torch.cuda.synchronize()

    # 4. the main path, counters at 0 just before and read just after
    fused.moments_forward.launches = 0
    fused.raygen_trace_forward.launches = 0
    loss = centroid_rms_spot(static, params, Hx, Hy, Px, Py, WAVELENGTH)
    m_main = fused.spot_moments(static, params, Hx, Hy, Px, Py, WAVELENGTH)
    final = tracer.trace_system_final(static, params, Hx, Hy, Px, Py,
                                      WAVELENGTH)
    torch.cuda.synchronize()
    launches = {"K1": fused.moments_forward.launches,
                "K3": fused.raygen_trace_forward.launches}
    print(f"main path launches: {launches}")
    check(launches["K1"] >= 1 and launches["K3"] >= 1,
          "main path launched K1 and K3")

    # 5. what comes out: finite, shaped, and agreeing with the eager
    # float64 path on the card
    check(torch.isfinite(loss).item(), "loss finite")
    for key, v in final.items():
        check(v.shape == (N_RAYS,) and v.dtype == torch.float32,
              f"{key}: shape and dtype")
        check(bool(torch.isfinite(v).all()), f"{key}: finite")
    i_main = final["intensity"]
    check(bool(((i_main == 0) | (i_main == 1)).all()), "intensity in {0, 1}")
    config.set_precision("float64")
    static64, params64 = bench_lens(Optic).build(device="cuda")
    data64 = tuple(a.double() for a in (Hx, Hy, Px, Py))
    ref_final = tracer.trace_system_final(static64, params64, *data64,
                                          WAVELENGTH)
    ref_m = fused.spot_moments(static64, params64, *data64, WAVELENGTH)
    ref_loss = centroid_rms_spot(static64, params64, *data64, WAVELENGTH)
    torch.cuda.synchronize()
    check(fused.moments_forward.launches == launches["K1"]
          and fused.raygen_trace_forward.launches == launches["K3"],
          "float64 reference ran eager (no kernel)")
    ref_m = [float(v) for v in ref_m]
    scale = [ref_m[0], math.sqrt(ref_m[0] * ref_m[3]),
             math.sqrt(ref_m[0] * ref_m[3]), ref_m[3]]
    err64 = {}
    for j in range(4):
        err64[f"m{j}_rel"] = abs(float(m_main[j]) - ref_m[j]) / scale[j]
    err64["loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(
        float(ref_loss))
    same = i_main.double() == ref_final["intensity"]
    err64["intensity_frac"] = 1.0 - same.double().mean().item()
    for key, tol in (("x", "position_mm"), ("y", "position_mm"),
                     ("L", "direction"), ("M", "direction"),
                     ("N", "direction")):
        err64[key] = (final[key].double() - ref_final[key])[same].abs().max(
        ).item()
    print("main path vs eager float64: " + json.dumps(err64)
          + f" tolerances {json.dumps(TOL_F64)}")
    for j in range(4):
        check(err64[f"m{j}_rel"] <= TOL_F64["moment_rel"], f"m{j} vs f64")
    check(err64["loss_rel"] <= TOL_F64["loss_rel"], "loss vs f64")
    check(err64["intensity_frac"] <= TOL["intensity_frac"], "i vs f64")
    for key in ("x", "y"):
        check(err64[key] <= TOL_F64["position_mm"], f"{key} vs f64")
    for key in ("L", "M", "N"):
        check(err64[key] <= TOL_F64["direction"], f"{key} vs f64")
    del ref_final, data64
    config.set_precision("float32")

    # 6. each kernel against its plain version on the same inputs
    p, data = fused._prepare(static, params, Hx, Hy, Px, Py, WAVELENGTH)
    k1 = fused.moments_forward(static, *p, data)
    k1_plain = fused._moments_plain(static, *p, data)
    k1_scale = torch.stack([k1_plain[0], (k1_plain[0] * k1_plain[3]).sqrt(),
                            (k1_plain[0] * k1_plain[3]).sqrt(), k1_plain[3]])
    k1_rel = ((k1 - k1_plain).abs() / k1_scale).max().item()
    k1_abs = (k1 - k1_plain).abs().max().item()
    print(f"K1 vs plain: max abs {k1_abs:.6g}, max rel {k1_rel:.6g} "
          f"(tolerance rel {TOL['moment_rel']})")
    check(k1_rel <= TOL["moment_rel"], "K1 vs plain")

    keys = tuple(range(8))
    k3 = fused.raygen_trace_forward(static, *p, data, keys)
    k3_plain = fused._raygen_trace_plain(static, *p, data, keys)
    same = k3[6] == k3_plain[6]
    k3_err = {"intensity_frac": 1.0 - same.float().mean().item()}
    tol_of = {"x": "position_mm", "y": "position_mm", "z": "position_mm",
              "L": "direction", "M": "direction", "N": "direction",
              "opd": "opd_mm"}
    for k, key in enumerate(fused._NAMES):
        if key in tol_of:
            k3_err[key] = (k3[k] - k3_plain[k])[same].abs().max().item()
    print("K3 vs plain: " + json.dumps(k3_err)
          + f" tolerances {json.dumps(TOL)}")
    check(k3_err["intensity_frac"] <= TOL["intensity_frac"], "K3 i")
    for key, tol in tol_of.items():
        check(k3_err[key] <= TOL[tol], f"K3 {key} vs plain")
    del k3, k3_plain
    torch.cuda.synchronize()

    # 7. times and bounds, at the main path's shapes. A kernel's time is
    # its bare launch (tables packed once, outside the timed region);
    # these launches bypass the wrappers and their counters.
    n, head, ptrs, keep = fused._launch_args(static, p[2], p[0], p[1], data)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials = torch.empty((-(-n // fused._BLOCK), 4), device=dev)
    outs = [torch.empty(n, device=dev) for _ in range(8)]

    def launch(name, *args):
        err = fused._kernel(name)(*args, stream)
        check(err == 0, f"{name} launch: cudaError {err}")

    def launch_k1():
        launch("moments_fwd", *head, *ptrs, partials.data_ptr())

    def launch_k3():
        launch("raygen_trace_fwd", *head, 255, *ptrs,
               *(o.data_ptr() for o in outs))

    ops = chain_ops_per_ray(static, fused) * N_RAYS
    k1_bound = bound_ms(4 * 4 * N_RAYS, ops + 10 * N_RAYS)
    k3_bound = bound_ms((4 + 8) * 4 * N_RAYS, ops)
    rows = [
        dict(name="K1 _moments_forward", route="cuda",
             source="optiland_tpu_torch/csrc/moments_fwd.cu",
             replaces="optiland_tpu/trace/fused.py:1431",
             launches=launches["K1"], max_abs_err=k1_abs,
             ms=time_ms(launch_k1),
             plain_ms=time_ms(lambda: fused._moments_plain(static, *p, data)),
             bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None),
        dict(name="K3 _raygen_forward", route="cuda",
             source="optiland_tpu_torch/csrc/raygen_trace_fwd.cu",
             replaces="optiland_tpu/trace/fused.py:1011",
             launches=launches["K3"],
             max_abs_err=max(v for k, v in k3_err.items()
                             if k != "intensity_frac"),
             ms=time_ms(launch_k3),
             plain_ms=time_ms(lambda: fused._raygen_trace_plain(
                 static, *p, data, keys)),
             bound_ms=k3_bound[0], bound_by=k3_bound[1], library_ms=None),
    ]
    wrap_ms = {
        "K1 wrapper": time_ms(lambda: fused.moments_forward(static, *p,
                                                             data)),
        "K3 wrapper": time_ms(lambda: fused.raygen_trace_forward(
            static, *p, data, keys)),
        "centroid_rms_spot": time_ms(lambda: centroid_rms_spot(
            static, params, Hx, Hy, Px, Py, WAVELENGTH)),
        "trace_system_final": time_ms(lambda: tracer.trace_system_final(
            static, params, Hx, Hy, Px, Py, WAVELENGTH)),
    }
    print(f"end to end at 2M rays, float32, median of {TIMED_CALLS} (ms): "
          + json.dumps(wrap_ms) + f"; chain FP32 ops/ray "
          f"{chain_ops_per_ray(static, fused)}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
