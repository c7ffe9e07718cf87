"""The kernels K1-K8 of two checkouts of this repository, timed against
each other on one CUDA card in turns.

    python -m optiland_tpu_torch.tools.kernel_turns --parent DIR [--n N ...]

DIR is a checkout of another commit, for instance
`git archive <commit> | tar -x -C build/parent`. Each tree runs in a
process of its own, in the order parent, this tree, this tree, parent. A
process builds its tree's kernels with that tree's own `_build`, and
drives that tree's own wrappers at each ray count N (default 16,384, 65,536
and 2,000,000) on the bench lens of chip_smoke.py: `fused.moments_forward`
(K1), `moments_backward` (K2), `raygen_trace_forward` (K3, all 8 outputs),
`raygen_trace_backward` (K4), and, on the eager rays of its vignetted twin,
`fused_trace_forward` (K5) and `fused_trace_backward` (K6); and, for K1, K2
and K3, on the absorbing Cooke triplet at 0.55 um. It drives
`fused.history_forward` (K7) on the Cooke triplet at two sizes: the
flagship's 1,999,998 rays at per-ray wavelengths (chip_smoke.py
`flagship_inputs`, as `__graft_entry__._make_inputs` makes them: 3 fields x
3 wavelengths) and the 16,384-ray bundle of `wavefront_data` (field (0,
1), 0.55 um, the 128 x 128 pupil grid). On the Cooke triplet it also
drives K1-K6's per-ray variants at the flagship batch's own wavelengths,
at its 1,999,998 rays and its first 16,384 (K2 without the data
cotangents, K4 seeded on x, y and opd, K5 and K6 on the eager rays of that
batch); a tree without them records None there. It drives the coating,
thin-lens and grating configurations of chip_smoke.py's phase j3 at the
same two sizes (`branch_ms`: K1-K4 of systems A, B and C at 0.55 um and
per-ray, K5 and K6 on B's vignetted twin, K7 on A and B) and the phase
configurations of its phase j4 (`phase_ms`: K1-K4 of systems D, E and F,
K5 and K6 on F's vignetted twin, K7 on D, E and F) and the freeform
configurations of its phase j5 (`freeform_ms`: K1-K4 of systems G, H and
I, K5 and K6 on I's vignetted twin, K7 on G, H and I) and the systems of
its phase j6 (`long_ms`: K1-K4 of systems J (Forbes Q-2D), K (rows past 17
slots) and L (70 surfaces), K5 and K6 on J's vignetted twin, K7 on J, K
and L); a tree without those branches or systems records None there. It also drives
`huygens.huygens_sum_forward` (K8) on the Cooke triplet's Huygens PSF at
its defaults (128 x 128: the image sum and its normalizing peak sum), at
256 x 256, and on the random inputs of tools/bench_wave_optics.py. Each
tree's wrappers pick their own launch signature, grid and (for a kernel
built per system) variant: the tool only wraps the tree's `fused._kernel` and
`huygens._kernel` so that CUDA events are recorded on the launch stream
just before and just after each C call, and a kernel's time is the median
of those spans over TIMED launches after a warm-up (which also builds a
per-system variant). Before each start event the stream first spins for
SPIN_CYCLES (`torch.cuda._sleep`), so that the launch is queued before the
card reaches the event and the span holds the kernel alone, not the
host's launch latency (which at 10^4 rays is a fifth of a kernel's time).
At the largest N it also times the bench training step
(`centroid_rms_spot(..., diff_inputs=False)`, `backward`, Adam) on the
host clock. Prints one JSON line for each process (with nvcc's register
lines of each library it built), then the card's name and power limit, a
JSON summary of every time in turns, and, for every library the two trees
built under one name (the same source, definitions and flags), whether
their SASS (`cuobjdump -sass`, the instructions) is the same.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TIMED, WARMUP, STEPS = 25, 3, 10
SPIN_CYCLES = 200_000   # ~0.1 ms at an H100's clock
COOKE_WAVELENGTH = 0.55
DEFAULT_N = (16_384, 65_536, 2_000_000)


def _smoke():
    """This checkout's chip_smoke.py, for its bench lens, rays, Huygens
    inputs and step settings (it is loaded, not run)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_launches(*modules):
    """Wrap each module's `_kernel` (the C entry points of its kernels) so
    that every launch through it runs between two CUDA events on the
    stream, after a `torch.cuda._sleep` spin (SPIN_CYCLES) that queues the
    launch before the card reaches the first event: a span holds the
    kernel alone, not the host's launch latency. Returns the list the
    spans (start, end) go to and a function that restores the modules."""
    import torch

    spans = []
    owns = [(m, m._kernel) for m in modules]

    def timed(own):
        def kernel(*key):
            fn = own(*key)

            def launch(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SPIN_CYCLES)
                start.record()
                err = fn(*args)
                end.record()
                spans.append((start, end))
                return err
            return launch
        return kernel

    for m, own in owns:
        m._kernel = timed(own)

    def restore():
        for m, own in owns:
            m._kernel = own
    return spans, restore


def launch_ms(call, spans):
    """Median span, over TIMED calls of `call` after WARMUP, of the one
    launch each makes through a module `timed_launches` wrapped."""
    import numpy as np
    import torch

    for _ in range(WARMUP):
        call()
    spans.clear()
    for _ in range(TIMED):
        call()
    torch.cuda.synchronize()
    if len(spans) != TIMED:
        raise RuntimeError(f"{len(spans)} launches in {TIMED} calls")
    return float(np.median([a.elapsed_time(b) for a, b in spans]))


def worker(tree: Path, ns: list[int]) -> dict:
    """Times of `tree`'s K1-K8 wrappers' launches (K1-K6 at each n), and
    its bench training step at the largest n."""
    tree = tree.resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import optiland_tpu_torch
    from optiland_tpu_torch import _build, config
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.optimization.merits import centroid_rms_spot
    from optiland_tpu_torch.psf import huygens
    from optiland_tpu_torch.system.optic import Optic
    from optiland_tpu_torch.trace import fused
    from optiland_tpu_torch.trace.raygen import generate_rays
    from optiland_tpu_torch.wavefront.core import pupil_grid_coords

    pkg = Path(optiland_tpu_torch.__file__).resolve()
    if not pkg.is_relative_to(tree):
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    cs = _smoke()
    dev = torch.device("cuda")
    _build.build_all()
    config.set_precision("float32")
    spans, _ = timed_launches(fused, huygens)

    def kernel_ms(call):
        return launch_ms(call, spans)

    def args_of(static, params, wl):
        return fused._uniform_params(static, params, wl) + (
            fused._raygen_scalars(static, params),)

    static, params = cs.bench_lens(Optic).build(device="cuda")
    static_v, params_v = cs.bench_lens(Optic, vignetted=True).build(
        device="cuda")
    lens_c = CookeTriplet()
    static_c, params_c = lens_c.build(device="cuda")
    p, p_v = args_of(static, params, cs.WAVELENGTH), args_of(
        static_v, params_v, cs.WAVELENGTH)[:2]
    p_c = args_of(static_c, params_c, COOKE_WAVELENGTH)
    rays = cs.bench_rays(dev)
    c = torch.tensor([0.3, -0.7, 0.5, 1.1], device=dev)
    rng = np.random.default_rng(1)
    ms = {}
    for n in ns:
        data = tuple(a[:n].contiguous() for a in rays)
        seeds = [torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev) for _ in range(8)]
        ms[f"K1 {n}"] = kernel_ms(lambda: fused.moments_forward(
            static, *p, data))
        ms[f"K1 Cooke {n}"] = kernel_ms(lambda: fused.moments_forward(
            static_c, *p_c, data))
        ms[f"K2 {n}"] = kernel_ms(lambda: fused.moments_backward(
            static, *p, data, c, diff_data=False))
        ms[f"K3 {n}"] = kernel_ms(lambda: fused.raygen_trace_forward(
            static, *p, data, tuple(range(8))))
        ms[f"K3 Cooke {n}"] = kernel_ms(lambda: fused.raygen_trace_forward(
            static_c, *p_c, data, tuple(range(8))))
        ms[f"K4 {n}"] = kernel_ms(lambda: fused.raygen_trace_backward(
            static, *p, data, (0, 1, 7), seeds[:3]))
        r0 = generate_rays(static_v, params_v, *data, cs.WAVELENGTH)
        rays8 = tuple(getattr(r0, k).detach().contiguous()
                      for k in ("x", "y", "z", "L", "M", "N", "i", "opd"))
        ms[f"K5 {n}"] = kernel_ms(lambda: fused.fused_trace_forward(
            static_v, *p_v, rays8))
        ms[f"K6 {n}"] = kernel_ms(lambda: fused.fused_trace_backward(
            static_v, *p_v, rays8, seeds))
        ms[f"K2 Cooke {n}"] = kernel_ms(lambda: fused.moments_backward(
            static_c, *p_c, data, c, diff_data=False))
        del seeds, r0, rays8
        torch.cuda.empty_cache()
    p7 = (fused._diff_params(params_c), fused._nondiff_params(params_c))
    fb = cs.flagship_inputs(params_c, dev)
    r0 = generate_rays(static_c, params_c, *fb)
    rays9 = tuple(getattr(r0, k).detach().contiguous()
                  for k in fused._RAY_KEYS)
    pw = p7 + (fused._raygen_scalars(static_c, params_c),)
    has_per_ray = hasattr(fused, "media_defines")
    for n in (16_384, fb[0].shape[0]):
        d, r9 = (tuple(a[:n].contiguous() for a in x) for x in (fb, rays9))
        seeds = [torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev) for _ in range(8)]
        calls = {
            "K1": lambda: fused.moments_forward(static_c, *pw, d),
            "K2": lambda: fused.moments_backward(static_c, *pw, d, c,
                                                 diff_data=False),
            "K3": lambda: fused.raygen_trace_forward(static_c, *pw, d,
                                                     tuple(range(8))),
            "K4": lambda: fused.raygen_trace_backward(
                static_c, *pw, d, (0, 1, 7), seeds[:3]),
            "K5": lambda: fused.fused_trace_forward(static_c, *p7, r9),
            "K6": lambda: fused.fused_trace_backward(static_c, *p7, r9,
                                                     seeds)}
        for key, call in calls.items():
            ms[f"{key} Cooke per-ray {n}"] = (kernel_ms(call) if has_per_ray
                                              else None)
        del d, r9, seeds
    del fb, r0, rays9
    torch.cuda.empty_cache()
    ms.update(branch_ms(cs, fused, kernel_ms, Optic, CookeTriplet, dev, rng,
                        c))
    ms.update(phase_ms(cs, fused, kernel_ms, Optic, dev, rng, c))
    ms.update(freeform_ms(cs, fused, kernel_ms, Optic, dev, rng, c))
    ms.update(long_ms(cs, fused, kernel_ms, Optic, dev, rng, c))
    px_b, py_b, _ = pupil_grid_coords(128, torch.float32, dev)
    for label, r0 in (
            ("flagship 1999998", generate_rays(
                static_c, params_c, *cs.flagship_inputs(params_c, dev))),
            ("wavefront bundle 16384", generate_rays(
                static_c, params_c, torch.zeros_like(px_b),
                torch.ones_like(px_b), px_b, py_b, COOKE_WAVELENGTH,
                apply_vignetting=False))):
        rays9 = tuple(getattr(r0, k).detach().contiguous()
                      for k in fused._RAY_KEYS)
        ms[f"K7 {label}"] = kernel_ms(lambda: fused.history_forward(
            static_c, *p7, rays9))
        del r0, rays9
        torch.cuda.empty_cache()
    img, peak = huygens.huygens_psf_sums(lens_c, (0.0, 1.0), 0.55, 128, 128,
                                         device="cuda")[:2]
    big = huygens.huygens_psf_sums(lens_c, (0.0, 1.0), 0.55, 256, 256,
                                   device="cuda")[0]
    for label, args in (("psf_128", img), ("psf_128_peak", peak),
                        ("bench_wave_optics", cs.bench_wave_optics_args(dev)),
                        ("psf_256", big)):
        ms[f"K8 {label}"] = kernel_ms(
            lambda: huygens.huygens_sum_forward(*args))
    del img, peak, big
    torch.cuda.empty_cache()
    leaves = {k: getattr(params, k).detach().clone().requires_grad_(True)
              for k in cs.TRAIN_LEAVES}
    p_f = params.replace(**leaves)
    opt = torch.optim.Adam(list(leaves.values()), lr=cs.ADAM_LR)
    data = tuple(a[:max(ns)].contiguous() for a in rays)

    def step():
        opt.zero_grad()
        centroid_rms_spot(static, p_f, *data, cs.WAVELENGTH,
                          diff_inputs=False).backward()
        opt.step()

    times = []
    for k in range(WARMUP + STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if k >= WARMUP:
            times.append(1e3 * (time.perf_counter() - t))
    registers = {log.stem: [line.split(":", 1)[-1].strip() for line in
                            log.read_text().splitlines()
                            if "registers" in line]
                 for log in sorted(_build.build_dir().glob("*.log"))}
    return {"tree": str(tree), "kernel_ms": ms,
            f"step_ms {max(ns)}": float(np.median(times)),
            "ptxas": registers}


def branch_ms(cs, fused, kernel_ms, Optic, CookeTriplet, dev, rng, c):
    """The coating, thin-lens and grating configurations of chip_smoke.py's
    phase j3, timed at the flagship batch's 1,999,998 rays and its first
    16,384: K1-K4 of system A (the coated Cooke triplet), B (the
    spectrograph) and C (the concave reflective grating) at 0.55 um and at
    the batch's per-ray wavelengths, K5 and K6 on the eager rays of B's
    vignetted twin in both configurations, K7 on A and B. None for every
    key where the tree has no such branches (`fused.branch_defines`)."""
    systems = {"A": lambda: cs.coated_cooke(CookeTriplet),
               "B": lambda: cs.spectrograph(Optic),
               "C": lambda: cs.concave_grating(Optic),
               "B vignetted": lambda: cs.spectrograph(Optic, vignetted=True)}
    return _systems_ms(systems, ("A", "B"), hasattr(fused, "branch_defines"),
                       cs, fused, kernel_ms, dev, rng, c)


def phase_ms(cs, fused, kernel_ms, Optic, dev, rng, c):
    """The phase-sheet configurations of chip_smoke.py's phase j4, timed as
    `branch_ms` times j3's: K1-K4 of system D (the hybrid achromat), E (the
    coated metalens on a conic carrier) and F (the tilted reflective
    linear-grating sheet), K5 and K6 on F's vignetted twin, K7 on D, E and
    F. None for every key where the tree has no phase branch
    (`fused._uniform_phase`)."""
    systems = {"D": lambda: cs.hybrid_achromat(Optic),
               "E": lambda: cs.curved_metalens(Optic),
               "F": lambda: cs.phase_mirror(Optic),
               "F vignetted": lambda: cs.phase_mirror(Optic, vignetted=True)}
    return _systems_ms(systems, ("D", "E", "F"),
                       hasattr(fused, "_uniform_phase"), cs, fused,
                       kernel_ms, dev, rng, c)


def freeform_ms(cs, fused, kernel_ms, Optic, dev, rng, c):
    """The freeform configurations of chip_smoke.py's phase j5, timed as
    `branch_ms` times j3's: K1-K4 of system G (biconic and toroidal), H
    (poly-XY and Zernike) and I (tilted Chebyshev and Forbes Q-bfs), K5 and
    K6 on I's vignetted twin, K7 on G, H and I. None for every key where the
    tree has no freeform branch (`fused._freeform_mask`)."""
    systems = {"G": lambda: cs.anamorphic_singlet(Optic),
               "H": lambda: cs.xy_freeform_singlet(Optic),
               "I": lambda: cs.tilted_freeform_singlet(Optic),
               "I vignetted": lambda: cs.tilted_freeform_singlet(
                   Optic, vignetted=True)}
    return _systems_ms(systems, ("G", "H", "I"),
                       hasattr(fused, "_freeform_mask"), cs, fused,
                       kernel_ms, dev, rng, c)


def long_ms(cs, fused, kernel_ms, Optic, dev, rng, c):
    """The systems of chip_smoke.py's phase j6, timed as `branch_ms` times
    j3's: K1-K4 of system J (a Forbes Q-2D face), K (a 38-slot Zernike and
    a 29-slot Q-2D) and L (70 surfaces of relays), K5 and K6 on J's
    vignetted twin, K7 on J, K and L. None for every key where the tree's
    kernels do not take them (`fused._wide_layout`)."""
    systems = {"J": lambda: cs.q2d_singlet(Optic),
               "K": lambda: cs.wide_freeform_singlet(Optic),
               "L": lambda: cs.relay_train(Optic),
               "J vignetted": lambda: cs.q2d_singlet(Optic, vignetted=True)}
    return _systems_ms(systems, ("J", "K", "L"),
                       hasattr(fused, "_wide_layout"), cs, fused, kernel_ms,
                       dev, rng, c)


def _systems_ms(systems, history, supported, cs, fused, kernel_ms, dev, rng,
                c):
    """K1-K4 of each of `systems` (label -> builder) but the vignetted
    twin, at 0.55 um and at the flagship batch's per-ray wavelengths, K5
    and K6 on the eager rays of the "... vignetted" twin in both
    configurations, and K7 at per-ray wavelengths on the `history` labels,
    each at the batch's 1,999,998 rays and its first 16,384; all None where
    the tree does not take them (`supported` false)."""
    import numpy as np
    import torch

    from optiland_tpu_torch.trace.raygen import generate_rays

    twins = [label for label in systems if label.endswith("vignetted")]
    keys = [f"{k} {label} {cfg}" for label in systems if label not in twins
            for cfg in ("0.55", "per-ray") for k in ("K1", "K2", "K3", "K4")]
    keys += [f"{k} {label} {cfg}" for label in twins
             for cfg in ("0.55", "per-ray") for k in ("K5", "K6")]
    keys += [f"K7 {label} per-ray" for label in history]
    ns = (16_384, 1_999_998)
    if not supported:
        return {f"{key} {n}": None for key in keys for n in ns}
    from optiland_tpu_torch import _build

    built = {label: make().build(device="cuda")
             for label, make in systems.items()}
    # every variant these launches take, built at once (one nvcc each)
    sources = {"K1": "moments_fwd", "K2": "moments_bwd",
               "K3": "raygen_trace_fwd", "K4": "raygen_trace_bwd",
               "K5": "fused_trace_fwd", "K6": "fused_trace_bwd"}
    variants = set()
    for label, (static, _) in built.items():
        for key in (("K5", "K6") if label in twins else ("K1", "K2", "K3",
                                                         "K4")):
            backward = key in ("K2", "K4", "K6")
            variants.add((sources[key], fused.backward_defines(static, False)
                          if backward else fused.system_defines(static)))
            variants.add((sources[key], fused.backward_defines(static, True)
                          if backward else fused.history_defines(static)))
        if label in history:
            variants.add(("history_fwd", fused.history_defines(static)))
    _build.build_all(tuple(v for v in variants if v[1]))
    ms = {}
    for label, (static, params) in built.items():
        fb = cs.flagship_inputs(params, dev)
        for n in ns:
            d = tuple(a[:n].contiguous() for a in fb)
            seeds = [torch.from_numpy(rng.standard_normal(
                d[0].shape[0]).astype(np.float32)).to(dev) for _ in range(8)]
            for cfg, args in (("0.55", d[:4] + (COOKE_WAVELENGTH,)),
                              ("per-ray", d)):
                p, data = fused._prepare(static, params, *args)
                if label in twins:
                    r0 = generate_rays(static, params, *args)
                    rk = fused._RAY_KEYS[:8] if cfg == "0.55" else (
                        fused._RAY_KEYS)
                    r = tuple(getattr(r0, k).detach().contiguous()
                              for k in rk)
                    pc = p[:2]
                    ms[f"K5 {label} {cfg} {n}"] = kernel_ms(
                        lambda: fused.fused_trace_forward(static, *pc, r))
                    ms[f"K6 {label} {cfg} {n}"] = kernel_ms(
                        lambda: fused.fused_trace_backward(static, *pc, r,
                                                           seeds))
                    continue
                calls = {
                    "K1": lambda: fused.moments_forward(static, *p, data),
                    "K2": lambda: fused.moments_backward(
                        static, *p, data, c, diff_data=False),
                    "K3": lambda: fused.raygen_trace_forward(
                        static, *p, data, tuple(range(8))),
                    "K4": lambda: fused.raygen_trace_backward(
                        static, *p, data, (0, 1, 6, 7), seeds[:4])}
                for key, call in calls.items():
                    ms[f"{key} {label} {cfg} {n}"] = kernel_ms(call)
            if label in history:
                r0 = generate_rays(static, params, *d)
                r9 = tuple(getattr(r0, k).detach().contiguous()
                           for k in fused._RAY_KEYS)
                p7 = (fused._diff_params(params),
                      fused._nondiff_params(params))
                ms[f"K7 {label} per-ray {n}"] = kernel_ms(
                    lambda: fused.history_forward(static, *p7, r9))
            torch.cuda.empty_cache()
    return {f"{key} {n}": ms[f"{key} {n}"] for key in keys for n in ns}


def sass_same(parent: Path) -> dict:
    """{library: true, or its first differing SASS line in each tree} for
    every library built under one name in the parent's build directory and
    in this tree's (the same source, definitions and flags). Compared: each
    function's instructions, symbol names (which nvcc derives in part from
    the source's path, for an anonymous namespace) left out."""
    from optiland_tpu_torch import _build

    theirs = max((parent / "build" / "optiland_tpu_torch").glob("*/"),
                 key=lambda d: d.stat().st_mtime)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    symbol = re.compile(r"_Z\w+")

    def sass(lib):
        out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                             capture_output=True, text=True,
                             check=True).stdout
        return [symbol.sub("", line.strip()) for line in out.splitlines()
                if "/*0" in line or "Function :" in line]

    same = {}
    for lib in sorted(theirs.glob("lib*.so")):
        mine = _build.build_dir() / lib.name
        if mine.exists():
            a, b = sass(lib), sass(mine)
            same[lib.name] = a == b or next(
                ([x, y] for x, y in zip(a, b) if x != y),
                [f"{len(a)} lines", f"{len(b)} lines"])
    return same


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="checkout of the commit to time against")
    parser.add_argument("--n", type=int, nargs="+", default=list(DEFAULT_N))
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.worker is not None:
        print(json.dumps(worker(opts.worker, opts.n)))
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_turns times CUDA kernels and needs a card")
    runs = []
    for tree in (opts.parent, ROOT, ROOT, opts.parent):
        out = subprocess.run(
            [sys.executable, __file__, "--parent", str(opts.parent),
             "--worker", str(tree), "--n", *map(str, opts.n)],
            capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f"worker for {tree} failed:\n{out.stderr}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    turns = {k: [r["kernel_ms"][k] for r in runs] for k in runs[0]["kernel_ms"]}
    step_key = f"step_ms {max(opts.n)}"
    turns[step_key] = [r[step_key] for r in runs]
    print(json.dumps({"order": ["parent", "change", "change", "parent"],
                      "ms": turns}))
    print(json.dumps({"same SASS as the parent": sass_same(opts.parent)}))


if __name__ == "__main__":
    main()
