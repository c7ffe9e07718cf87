"""The freeform geometries of the port against the JAX package, in float64
on the CPU.

Families: the seven of JAX's fused kernels (`FREEFORM_CASES` of
tests/test_fused_kernel.py: poly-XY, biconic, toroidal, Chebyshev, Zernike,
Forbes Q-bfs, and Forbes Q-2D), each on the R +-60 mm singlet, EPD 8,
Newton count 6, and the one the kernels leave to the eager trace, the grid
sag. Each system is built in both packages from one prescription
(tests/torch_port_helpers.py `build_both`, which also holds the port's own
`Optic.build` to the JAX tables: codes, cv, k, coefficients, aux):
  - each family's `sag` and `sag_and_grad` on seeded points at 1e-12 of
    their scale, on its singlet;
  - on four singlets that carry two families each (`PAIRS`: biconic and
    toroidal, poly-XY and Zernike, Chebyshev and Q-bfs, Q-2D and grid
    sag), and on chip_smoke.py's system K ("wide": a 38-slot Fringe Zernike
    and a 29-slot Q-2D, past a 17-slot row): `trace_system` at per-ray
    wavelengths, every history field from the family's face on at rtol
    1e-10 of its scale, and `centroid_rms_spot`'s gradients at one and at
    per-ray wavelengths, within 1e-8 of each leaf's largest entry;
  - on the biconic-toroidal singlet (every parameter that enters a sag
    nonlinearly but a norm: cv and k of both profiles, the rotation
    curvature, the y-polynomial) and on the Q-2D singlet (a and b terms at
    the same (n, m)) (`BODIES`): the plain versions of K1/K2
    (`_moments_plain`, `_moments_bwd_plain`) and K5/K6
    (`_fused_trace_plain`, `_fused_trace_bwd_plain`) against `jax.vjp` of
    JAX's kernel body (`_tile_raygen` + `_tile_trace(..., for_grad=True)`),
    at one and at per-ray wavelengths, every cotangent group at atol 1e-10
    of its largest entry. The plain freeform arm is one code for every
    family (the conic seed, the detached Newton steps, the differentiable
    last one) around each family's `sag_and_grad`, held to JAX's above;
  - on a triplet with one of six kernel families on each face: the
    kernels' plain path (K7's `_history_plain`, `_tile_trace`, the K1/K2
    seam's gradients) against the port's eager trace, in both
    configurations.
Also the two safe-divides of the Newton step (the eager path's and the
kernels'), the three Zernike conventions, the kernels' gate (Q-2D passes,
grid sag and NURBS are refused by name), and `Optic.add_surface` (NURBS
builds, an unknown keyword is refused by name).

The JAX side is nine XLA programs, a module-scoped fixture: one per pair
and for K, and one per configuration of each kernel body, lowered one
after another and compiled in threads at once at XLA's backend
optimization level 0 (the same float64 arithmetic)."""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.geometry import surfaces as jsurf
from optiland_tpu.trace import fused as jfused
from optiland_tpu.trace.tracer import trace_rays as j_trace_rays
from optiland_tpu.trace.tracer import trace_system as j_trace_system
from optiland_tpu_torch.geometry import surfaces as tsurf
from optiland_tpu_torch.optimization.merits import centroid_rms_spot
from optiland_tpu_torch.system import spec as tspec
from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.trace import fused as tfused
from optiland_tpu_torch.trace.tracer import trace_rays, trace_system

from torch_port_helpers import SMOKE, assert_close, build_both, jax_f64

N_RAYS = 48
RTOL_SAG = 1e-12
RTOL_VALUES = 1e-10
RTOL_GRADS = 1e-8
ATOL_KERNEL = 1e-10
C = (0.3, -0.7, 0.5, 1.1)
_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
_LEAVES = ("cv", "conic", "coeffs", "thickness", "mat_coeffs")
_GROUPS = ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
           "mat_coeffs", "coating_params", "n_table", "grating",
           "phase_params", "focal_length")

# tests/test_fused_kernel.py FREEFORM_CASES, and the eager family
KERNEL_CASES = {
    "polynomial": dict(coefficients=(0.0, 1e-5, -2e-6, 3e-6)),
    "biconic": dict(radius_y=-90.0, conic_y=0.4, conic=-0.2),
    "toroidal": dict(radius_y=55.0, conic=-0.1, coeffs_poly_y=[1e-5, -2e-8]),
    "chebyshev": dict(coefficients=[[0.0, 1e-5], [2e-5, 0.0]], norm_x=10.0,
                      norm_y=10.0),
    "zernike": dict(coefficients=(1e-5, -2e-5, 3e-5), norm_radius=8.0),
    "forbes_qbfs": dict(coefficients=(1e-4, -2e-5), norm_radius=8.0),
    "forbes_q2d": dict(norm_radius=8.0, freeform_coeffs={
        ("a", 0, 0): 1e-4, ("a", 0, 1): -2e-5, ("a", 1, 0): 2e-5,
        ("b", 1, 0): -1e-5, ("a", 2, 1): 3e-5, ("b", 3, 0): 1e-5}),
}
_XS = np.linspace(-6.0, 6.0, 7)
EAGER_CASES = {
    "grid_sag": dict(x_coordinates=_XS, y_coordinates=_XS, sag_values=(
        1e-3 * np.add.outer(_XS**2, 0.5 * _XS**2)
        + 2e-4 * np.add.outer(_XS, -_XS))),
}
CASES = {**KERNEL_CASES, **EAGER_CASES}
# singlets with one family on the front face and one on the back (the
# toroidal's y radius -55 mm there, as on system G of chip_smoke.py), and
# each family's (singlet, face)
PAIRS = {
    "anamorphic": (("biconic", KERNEL_CASES["biconic"]), ("toroidal", dict(
        radius_y=-55.0, conic=-0.1, coeffs_poly_y=[1e-5, -2e-8]))),
    "xy": (("polynomial", KERNEL_CASES["polynomial"]),
           ("zernike", KERNEL_CASES["zernike"])),
    "orthogonal": (("chebyshev", KERNEL_CASES["chebyshev"]),
                   ("forbes_qbfs", KERNEL_CASES["forbes_qbfs"])),
    "forbes_grid": (("forbes_q2d", KERNEL_CASES["forbes_q2d"]),
                    ("grid_sag", EAGER_CASES["grid_sag"])),
}
FACE = {stype: (label, k) for label, faces in PAIRS.items()
        for k, (stype, _) in enumerate(faces, 1)}
assert sorted(FACE) == sorted(CASES)


def freeform_singlet(stype, kw, n_wavelengths=3):
    """`_freeform_singlet` of tests/test_fused_kernel.py (n = 1.55, R +-60
    mm, 5 mm thick, EPD 8, fields 0 and 5 degrees), the freeform its front
    face; 0.48 and 0.65 um beside the primary 0.55 um."""
    def make(Optic):
        lens = Optic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        lens.add_surface(index=1, radius=60.0, thickness=5.0, material=1.55,
                         is_stop=True, surface_type=stype, **kw)
        lens.add_surface(index=2, radius=-60.0, thickness=45.0)
        lens.add_surface(index=3)
        return _finish(lens, n_wavelengths)
    return make


def freeform_pair(label):
    """The singlet of `freeform_singlet` with PAIRS[label]'s families on
    its front and back faces."""
    (front, kw_front), (back, kw_back) = PAIRS[label]

    def make(Optic):
        lens = Optic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        lens.add_surface(index=1, radius=60.0, thickness=5.0, material=1.55,
                         is_stop=True, surface_type=front, **kw_front)
        lens.add_surface(index=2, radius=-60.0, thickness=45.0,
                         surface_type=back, **kw_back)
        lens.add_surface(index=3)
        return _finish(lens, 3)
    return make


def _finish(lens, n_wavelengths):
    lens.set_aperture("EPD", 8.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(0.55, is_primary=True)
    for w in (0.48, 0.65)[: n_wavelengths - 1]:
        lens.add_wavelength(w)
    return lens


def freeform_triplet(Optic):
    """Three n = 1.55 singlets (R +-60 mm, 5 mm thick, 8 mm apart), a
    freeform on each face: the six kernel families of `KERNEL_CASES` with
    their coefficients (the biconic and the toroidal as back and front
    faces), EPD 8, fields 0 and 5 degrees, 0.48/0.55/0.65 um."""
    lens = Optic()
    inf = math.inf
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=60.0, thickness=5.0, material=1.55,
                     is_stop=True, surface_type="polynomial",
                     **KERNEL_CASES["polynomial"])
    lens.add_surface(index=2, radius=-60.0, thickness=8.0,
                     surface_type="biconic", radius_y=-75.0, conic_y=0.4,
                     conic=-0.2)
    lens.add_surface(index=3, radius=60.0, thickness=5.0, material=1.55,
                     surface_type="toroidal", **KERNEL_CASES["toroidal"])
    lens.add_surface(index=4, radius=-60.0, thickness=8.0,
                     surface_type="chebyshev", **KERNEL_CASES["chebyshev"])
    lens.add_surface(index=5, radius=60.0, thickness=5.0, material=1.55,
                     surface_type="zernike", **KERNEL_CASES["zernike"])
    lens.add_surface(index=6, radius=-60.0, thickness=20.0,
                     surface_type="forbes_qbfs",
                     **KERNEL_CASES["forbes_qbfs"])
    lens.add_surface(index=7)
    return _finish(lens, 3)


def _inputs():
    """(Hx, Hy, Px, Py), each ray's wavelength index, and the seeds of the
    K6 check, from a seed."""
    rng = np.random.default_rng(12)
    Hx, Hy = rng.uniform(-1.0, 1.0, (2, N_RAYS))
    Px, Py = rng.uniform(-0.7, 0.7, (2, N_RAYS))
    return (Hx, Hy, Px, Py), rng.integers(0, 3, N_RAYS), rng.normal(
        size=(8, N_RAYS))


def _kernel_body(js, jp, uniform, rg, data, w, seeds):
    """JAX's kernel body (`_tile_raygen` + `_tile_trace(..., for_grad=
    True)`) on whole arrays: its final state, and its cotangents for K2's
    seeds (c . m) and for `seeds` (K6's): (d_rg, d_diff, d_data) and
    (d_rays8 + d_w, d_diff)."""
    if uniform:
        n_table, alpha = jfused._uniform_tables(js, jp, 0.55)
        diffp = jfused._diff_params(jp, n_table)
        nondiffp = jfused._nondiff_params(jp, alpha)
    else:
        diffp = jfused._diff_params(jp)
        nondiffp = jfused._nondiff_params(jp)
    rays8, raygen_vjp = jax.vjp(
        lambda rg_, *d: jfused._tile_raygen(js, rg_, *d), rg, *data)
    final, trace_vjp = jax.vjp(
        lambda dp, r8, w_: jfused._tile_trace(js, uniform, dp, nondiffp, *r8,
                                              w_, for_grad=True),
        diffp, rays8, w)
    x, y, i = final[0], final[1], final[6]
    z = jnp.zeros_like(x)
    k2 = ((i * (C[1] + 2 * C[3] * x), i * (C[2] + 2 * C[3] * y)) + (z,) * 4
          + (C[0] + C[1] * x + C[2] * y + C[3] * (x * x + y * y), z))
    d_diff, d_rays8, d_w = trace_vjp(k2)
    d_rg, *d_data = raygen_vjp(tuple(d_rays8))
    d_data = tuple(d_data) + (() if uniform else (d_w,))
    e_diff, e_rays8, e_w = trace_vjp(tuple(seeds))
    return (final, rays8, (d_rg, d_diff, d_data),
            (tuple(e_rays8) + (() if uniform else (e_w,)), e_diff))


# the systems whose kernel body JAX differentiates here: the biconic-toroidal
# pair and the Q-2D singlet
BODIES = {"anamorphic": freeform_pair("anamorphic"),
          "q2d": freeform_singlet("forbes_q2d", KERNEL_CASES["forbes_q2d"])}
BODY_CASES = tuple(BODIES)
# chip_smoke.py's system K: a 38-slot Fringe Zernike front and a 29-slot
# Forbes Q-2D back, on the first N_WIDE rays, WIDE_NEWTON Newton steps
# (in both packages; JAX's program for it is the fixture's longest)
N_WIDE, WIDE_NEWTON = 16, 3


def _j_spot_merit(h):
    """JAX's `centroid_rms_spot` on the CPU from its history: the spot
    moments of the image row (`fused.spot_moments`' XLA path traces as
    `trace_system` does) and the merit's closed form
    (`optimization/merits.py`, eps 1e-6)."""
    x, y, i = h.x[-1], h.y[-1], h.intensity[-1]
    m0, m1, m2, m3 = (jnp.sum(i), jnp.sum(x * i), jnp.sum(y * i),
                      jnp.sum((x * x + y * y) * i))
    ws = m0 + 1e-6
    cx, cy = m1 / ws, m2 / ws
    return (m3 - 2.0 * (cx * m1 + cy * m2) + (cx * cx + cy * cy) * m0) / ws


@pytest.fixture(scope="module")
def jax_results():
    """Per pair (`PAIRS`) and for K ("wide"): the JAX history of its
    singlet at per-ray wavelengths, and the merit and its gradients at one
    wavelength (every ray at the primary 0.55 um) and at per-ray ones, by
    one program that differentiates the merit with the history as its
    by-product; for `BODIES` the kernel body's values and cotangents, one
    program per configuration; the XLA compiles in threads at once. And
    the port's system carried across."""
    data, widx, seeds = _inputs()
    idx = jnp.asarray(widx)
    jobs = {}
    with jax_f64():
        def merit_job(make, data, idx, newton_iters=6):
            (js, jp), port = build_both(make, newton_iters=newton_iters)

            def run(p, idx, js=js, data=data):
                def merit(q):
                    h = j_trace_system(js, q, *data, q.wavelengths[idx])
                    return _j_spot_merit(h), h

                (loss, h), g = jax.value_and_grad(merit, has_aux=True)(p)
                return tuple(getattr(h, f) for f in _FIELDS), g, loss

            return run, (jp, idx), port

        # the longest compiles first: each program compiles in a thread as
        # soon as it is lowered, beside the next one's lowering
        jobs["wide"] = merit_job(SMOKE.wide_freeform_singlet, tuple(
            a[:N_WIDE] for a in data), idx[:N_WIDE], WIDE_NEWTON)
        for label, make in BODIES.items():
            (js, jp), port = build_both(make, newton_iters=6)
            ts, tp = port
            rg = jnp.asarray(tfused._raygen_scalars(ts, tp).numpy())
            d = tuple(jnp.asarray(a) for a in data)
            for uniform in (True, False):
                def body(p, idx, js=js, rg=rg, uniform=uniform):
                    w = p.wavelengths[idx]
                    return _kernel_body(js, p, uniform, rg, d, jnp.full_like(
                        w, 0.55) if uniform else w, seeds)

                jobs[(label, uniform)] = (body, (jp, idx), port)
        for label in PAIRS:
            jobs[label] = merit_job(freeform_pair(label), data, idx)
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = [pool.submit(lambda lo: lo.compile(compiler_options={
                "xla_backend_optimization_level": 0}), jax.jit(f).lower(
                    *args)) for f, args, _ in jobs.values()]
            compiled = [f.result() for f in futures]
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        out = {}
        for (key, (_, (jp, idx_k), port)), prog in zip(jobs.items(),
                                                        compiled):
            if isinstance(key, tuple):
                out.setdefault(f"body {key[0]}", dict(port=port)).setdefault(
                    "kernel", [None, None])[0 if key[1] else 1] = to_np(
                    prog(jp, idx_k))
                continue
            hist, g_ray, loss_ray = to_np(prog(jp, idx_k))
            at_055 = int(np.argmin(np.abs(np.asarray(jp.wavelengths) - 0.55)))
            _, g_one, loss_one = to_np(prog(jp, jnp.full_like(idx_k, at_055)))
            out[key] = dict(port=port, hist=hist, grads=(g_one, g_ray),
                            loss=(loss_one, loss_ray))
    return out


def _points(seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-5.0, 5.0, (2, 40))


@pytest.mark.parametrize("name", list(CASES))
def test_sag_and_grad_match_jax(name):
    """Each family's `sag` and `sag_and_grad` (z, dz/dx, dz/dy) at 40 seeded
    points within 1e-12 of the scale of JAX's, from the tables both
    packages build; a Q-bfs and a Q-2D surface also past their norm radius
    (|u| > 1, where the departure is masked)."""
    (js, jp), (ts, tp) = build_both(freeform_singlet(name, CASES[name]))
    x, y = _points()
    if name.startswith("forbes"):
        x = x * 2.0
    args = (ts.geom_codes[1], ts.geom_n_coeffs[1])
    aux = ts.geom_aux[1]
    with jax_f64():
        ref = (jsurf.sag(*args, jnp.asarray(x), jnp.asarray(y), jp.cv[1],
                         jp.conic[1], jp.coeffs[1], js.geom_aux[1]),
               *jsurf.sag_and_grad(*args, jnp.asarray(x), jnp.asarray(y),
                                   jp.cv[1], jp.conic[1], jp.coeffs[1],
                                   js.geom_aux[1]))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = (tsurf.sag(*args, tx, ty, tp.cv[1], tp.conic[1], tp.coeffs[1], aux),
           *tsurf.sag_and_grad(*args, tx, ty, tp.cv[1], tp.conic[1],
                               tp.coeffs[1], aux))
    for label, g, r in zip(("sag", "z", "gx", "gy"), got, ref):
        assert_close(g, r, RTOL_SAG, f"{name} {label}")
    assert float(np.abs(np.asarray(ref[2])).max()) > 0


@pytest.mark.parametrize("zernike_type", ["fringe", "noll", "standard"])
def test_zernike_conventions_match_jax(zernike_type):
    """A 12-term Zernike of each convention: the port builds JAX's tables
    (its type code in aux), and its sag and gradient match JAX's at
    1e-12."""
    kw = dict(coefficients=(1e-5, -2e-5, 3e-5, 1e-5, 0.0, -1e-5, 2e-5,
                            5e-6, -5e-6, 4e-6, -3e-6, 2e-6), norm_radius=8.0,
              zernike_type=zernike_type)
    (js, jp), (ts, tp) = build_both(freeform_singlet("zernike", kw, 1))
    assert ts.geom_aux[1] == (tsurf.ZERNIKE_TYPE_CODES[zernike_type],)
    x, y = _points(5)
    args = (ts.geom_codes[1], ts.geom_n_coeffs[1])
    with jax_f64():
        ref = jsurf.sag_and_grad(*args, jnp.asarray(x), jnp.asarray(y),
                                 jp.cv[1], jp.conic[1], jp.coeffs[1],
                                 js.geom_aux[1])
    got = tsurf.sag_and_grad(*args, torch.from_numpy(x), torch.from_numpy(y),
                             tp.cv[1], tp.conic[1], tp.coeffs[1],
                             ts.geom_aux[1])
    for label, g, r in zip(("z", "gx", "gy"), got, ref):
        assert_close(g, r, RTOL_SAG, label)


@pytest.mark.parametrize("name", list(CASES))
def test_trace_system_matches_jax(jax_results, name):
    """`trace_system` at per-ray wavelengths on the family's pair: every
    field of the history from the family's face on within 1e-10 of its
    scale of the JAX package's."""
    label, k = FACE[name]
    ts, tp = jax_results[label]["port"]
    data, widx, _ = _inputs()
    h = trace_system(ts, tp, *(torch.from_numpy(a) for a in data),
                     tp.wavelengths[torch.from_numpy(widx)])
    for f, r in zip(_FIELDS, jax_results[label]["hist"]):
        assert_close(getattr(h, f)[k:], r[k:], RTOL_VALUES, f)
    assert float(h.intensity[-1].min()) == 1.0


@pytest.mark.parametrize("config", ["one", "per_ray"])
@pytest.mark.parametrize("name", list(CASES))
def test_merit_gradients_match_jax(jax_results, name, config):
    """`centroid_rms_spot` on the family's pair, its value within 1e-10 and
    its gradient within 1e-8 of each leaf's largest entry of JAX's: into
    the family's face's cv, conic and coefficient row (its nonlinear and
    linear slots alike), and into thickness and mat_coeffs (and the
    wavelength table at per-ray wavelengths). The port takes one
    wavelength as a scalar; JAX's reference is its per-ray trace with
    every ray at it."""
    label, k = FACE[name]
    ts, tp = jax_results[label]["port"]
    per_ray = config == "per_ray"
    ref = jax_results[label]["grads"][per_ray]
    data, widx, _ = _inputs()
    leaves = {key: getattr(tp, key).detach().clone().requires_grad_(True)
              for key in _LEAVES + ("wavelengths",)}
    p = tp.replace(**leaves)
    w = p.wavelengths[torch.from_numpy(widx)] if per_ray else 0.55
    loss = centroid_rms_spot(ts, p, *(torch.from_numpy(a) for a in data), w)
    assert_close(loss, jax_results[label]["loss"][per_ray], RTOL_VALUES,
                 "loss")
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True,
        materialize_grads=True)))
    for leaf in ("cv", "conic", "coeffs"):
        r = np.asarray(getattr(ref, leaf))
        assert_close(grads[leaf][k], r[k], RTOL_GRADS, leaf,
                     scale=np.abs(r).max())
    for leaf in ("thickness", "mat_coeffs") + (
            ("wavelengths",) if per_ray else ()):
        assert_close(grads[leaf], getattr(ref, leaf), RTOL_GRADS, leaf)
    assert grads["coeffs"][k].abs().max() > 0


def test_wide_trace_system_matches_jax(jax_results):
    """System K (chip_smoke.py `wide_freeform_singlet`: a 38-slot Fringe
    Zernike front, a 29-slot Forbes Q-2D back, N-BK7): `trace_system` at
    per-ray wavelengths on N_WIDE rays, every history field within 1e-10
    of its scale of the JAX package's."""
    ts, tp = jax_results["wide"]["port"]
    assert ts.geom_n_coeffs[1:3] == (38, 29)
    data, widx, _ = _inputs()
    h = trace_system(ts, tp, *(torch.from_numpy(a[:N_WIDE]) for a in data),
                     tp.wavelengths[torch.from_numpy(widx[:N_WIDE])])
    for f, r in zip(_FIELDS, jax_results["wide"]["hist"]):
        assert_close(getattr(h, f), r, RTOL_VALUES, f)


@pytest.mark.parametrize("config", ["one", "per_ray"])
def test_wide_merit_gradients_match_jax(jax_results, config):
    """`centroid_rms_spot` on system K at one and at per-ray wavelengths:
    its value within 1e-10 of JAX's, its gradients into cv, conic and both
    faces' whole coefficient rows (past their 17th slot too) within 1e-8 of
    each leaf's largest entry, every slot of both rows reached."""
    ts, tp = jax_results["wide"]["port"]
    per_ray = config == "per_ray"
    ref = jax_results["wide"]["grads"][per_ray]
    data, widx, _ = _inputs()
    leaves = {key: getattr(tp, key).detach().clone().requires_grad_(True)
              for key in ("cv", "conic", "coeffs")}
    p = tp.replace(**leaves)
    w = (p.wavelengths[torch.from_numpy(widx[:N_WIDE])] if per_ray
         else 0.55)
    loss = centroid_rms_spot(ts, p, *(torch.from_numpy(a[:N_WIDE])
                                      for a in data), w)
    assert_close(loss, jax_results["wide"]["loss"][per_ray], RTOL_VALUES,
                 "loss")
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    for leaf in leaves:
        assert_close(grads[leaf], getattr(ref, leaf), RTOL_GRADS, leaf)
    for k in (1, 2):
        assert grads["coeffs"][k, 1:ts.geom_n_coeffs[k]].abs().min() > 0


@pytest.mark.parametrize("config", ["one", "per_ray"])
@pytest.mark.parametrize("name", BODY_CASES)
def test_kernel_plain_versions_match_jax(jax_results, name, config):
    """The freeform arm of the kernels' plain versions on the
    biconic-toroidal singlet and on the Q-2D singlet (`BODIES`): K1's
    moments and K2's cotangents (rg, every table group, Hx, Hy, Px, Py and
    at per-ray wavelengths w), K5's final state and K6's cotangents against
    `jax.vjp` of JAX's kernel body, every group at atol 1e-10 of its
    largest entry, the freeform faces' coefficient rows reached."""
    ts, tp = jax_results[f"body {name}"]["port"]
    uniform = config == "one"
    final, rays8, ref2, ref6 = jax_results[f"body {name}"]["kernel"][
        0 if uniform else 1]
    data, widx, seeds = _inputs()
    t = tuple(torch.from_numpy(a) for a in data)
    if uniform:
        n_table, alpha = tfused._uniform_tables(ts, tp, 0.55)
        diffp = tfused._diff_params(tp, n_table)
        nondiffp = tfused._nondiff_params(tp, alpha)
        w = ()
    else:
        diffp, nondiffp = tfused._diff_params(tp), tfused._nondiff_params(tp)
        w = (tp.wavelengths[torch.from_numpy(widx)],)
    rg = tfused._raygen_scalars(ts, tp)
    m = tfused._moments_plain(ts, diffp, nondiffp, rg, t + w)
    x, y, i = final[0], final[1], final[6]
    assert_close(m, np.array([i.sum(), (x * i).sum(), (y * i).sum(),
                              ((x * x + y * y) * i).sum()]), RTOL_VALUES, "m")
    d_rg, d_diff, d_data = tfused._moments_bwd_plain(
        ts, diffp, nondiffp, rg, t + w, torch.tensor(C, dtype=torch.float64),
        True)
    assert_close(d_rg, ref2[0], ATOL_KERNEL, "rg")
    for key, g, r in zip(_GROUPS, d_diff, ref2[1]):
        assert_close(g, r, ATOL_KERNEL, f"K2 {key}")
    for key, g, r in zip(("Hx", "Hy", "Px", "Py", "w"), d_data, ref2[2]):
        assert_close(g, r, ATOL_KERNEL, f"K2 {key}")
    faces = [k for k in (1, 2) if ts.geom_n_coeffs[k]]
    assert np.abs(ref2[1][2][faces]).max(axis=1).min() > 0  # the faces' rows
    rays = tuple(torch.from_numpy(np.asarray(a)) for a in rays8) + w
    got = tfused._fused_trace_plain(ts, diffp, nondiffp, rays)
    for key, g, r in zip(_FIELDS, got, final):
        assert_close(g, r, RTOL_VALUES, f"K5 {key}")
    d_rays, d_diff = tfused._fused_trace_bwd_plain(
        ts, diffp, nondiffp, rays, tuple(torch.from_numpy(seeds)))
    for key, g, r in zip(_FIELDS + ("w",), d_rays, ref6[0]):
        assert_close(g, r, ATOL_KERNEL, f"K6 d{key}")
    for key, g, r in zip(_GROUPS, d_diff, ref6[1]):
        assert_close(g, r, ATOL_KERNEL, f"K6 {key}")


@pytest.mark.parametrize("config", ["one", "per_ray"])
def test_triplet_kernel_path_matches_eager(config):
    """The six kernel families in one system: K7's `_history_plain` (per-ray
    wavelengths) or `_tile_trace` (one wavelength, the tables hoisted)
    against the port's eager trace at rtol 1e-10, and the merit's
    gradients through the K1/K2 seam (`_moments_plain`,
    `_moments_bwd_plain`) against the eager path's at 1e-8, each
    freeform's coefficient row reached."""
    from optiland_tpu_torch.optimization.merits import (
        centroid_rms_from_moments,
    )
    from optiland_tpu_torch.trace.raygen import generate_rays

    ts, tp = freeform_triplet(TOptic).build(device="cpu")
    from dataclasses import replace

    ts = replace(ts, newton_iters=6)
    assert tfused.supports_fused(ts)
    data, widx, _ = _inputs()
    t = tuple(torch.from_numpy(a) for a in data)
    per_ray = config == "per_ray"
    w = tp.wavelengths[torch.from_numpy(widx)] if per_ray else 0.55
    rays0 = generate_rays(ts, tp, *t, w)
    ref = trace_rays(ts, tp, rays0)
    if per_ray:
        got = tfused._history_plain(
            ts, tfused._diff_params(tp), tfused._nondiff_params(tp),
            tuple(getattr(rays0, k) for k in tfused._RAY_KEYS))
        ref_rows = [getattr(ref, f) for f in _FIELDS]
    else:
        diffp, nondiffp = tfused._uniform_params(ts, tp, 0.55)
        got = tfused._tile_trace(ts, diffp, nondiffp, *(
            getattr(rays0, k).expand(N_RAYS) for k in tfused._RAY_KEYS[:8]))
        ref_rows = [getattr(ref, f)[-1] for f in _FIELDS]
    for f, g, r in zip(_FIELDS, got, ref_rows):
        assert_close(g, r, RTOL_VALUES, f)
    assert float(ref.intensity[-1].min()) == 1.0

    def grads(path):
        leaves = {k: getattr(tp, k).detach().clone().requires_grad_(True)
                  for k in _LEAVES}
        p = tp.replace(**leaves)
        if path == "eager":
            loss = centroid_rms_spot(ts, p, *t, w)
        else:
            prepared, d = tfused._prepare(ts, p, *t, w)
            loss = centroid_rms_from_moments(
                *tfused.fused_spot_moments(ts, prepared, d))
        return dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))

    eager, kernel = grads("eager"), grads("kernel")
    for leaf in _LEAVES:
        assert_close(kernel[leaf], eager[leaf], RTOL_GRADS, leaf)
    assert all(eager["coeffs"][k].abs().max() > 0 for k in range(1, 7))


def test_newton_safe_divides():
    """The Newton step's two safe-divides, each path's own: the eager
    intersection (JAX `surfaces.intersect`) takes |f'| <= 1e-14 to sign(f')
    1e-14 (1e-14 where f' = 0); the kernels' chain (JAX `_tile_trace`) takes
    every |f'| <= 1e-12 to +1e-12. On a flat biconic a ray along x has f'
    = 0 and one with N = 5e-13 has f' = -5e-13, which the eager step keeps
    and the kernels' flips: each path matches its JAX counterpart, and the
    two paths differ."""
    kw = dict(radius_y=math.inf, conic_y=0.0)
    (js, jp), (ts, tp) = build_both(
        lambda O: _flat(O, freeform_singlet("biconic", kw, 1)),
        newton_iters=6)
    assert ts.geom_codes[1] == tsurf.GEOM_BICONIC and float(tp.cv[1]) == 0.0
    one, zero = np.ones(3), np.zeros(3)
    rays = dict(x=np.array([0.0, 0.5, 1.0]), y=zero, z=np.full(3, -2.0),
                L=np.array([1.0, 0.0, 1.0]), M=zero,
                N=np.array([0.0, 5e-13, 0.0]), i=one, opd=zero, w=0.55 * one)
    from optiland_tpu.core.rays import Rays as JRays
    from optiland_tpu_torch.core.rays import Rays as TRays

    with jax_f64():
        j_eager = j_trace_rays(js, jp, JRays(**{k: jnp.asarray(v)
                                                  for k, v in rays.items()}))
        n_table, alpha = jfused._uniform_tables(js, jp, 0.55)
        j_kernel = jfused._tile_trace(
            js, True, jfused._diff_params(jp, n_table),
            jfused._nondiff_params(jp, alpha),
            *(jnp.asarray(rays[k]) for k in tfused._RAY_KEYS), record=True,
            for_grad=False)
    t_rays = {k: torch.from_numpy(v) for k, v in rays.items()}
    eager = trace_rays(ts, tp, TRays(**t_rays))
    diffp, nondiffp = tfused._uniform_params(ts, tp, 0.55)
    kernel = tfused._tile_trace(ts, diffp, nondiffp,
                                *(t_rays[k] for k in tfused._RAY_KEYS[:8]),
                                record=True)
    # the hit on surface 1: x + t L and z + t N
    e = np.array([eager.x[1].numpy(), eager.z[1].numpy()])
    k = np.array([kernel[1][0].numpy(), kernel[1][2].numpy()])
    assert_close(e, np.array([np.asarray(j_eager.x[1]),
                              np.asarray(j_eager.z[1])]), RTOL_VALUES, "eager")
    assert_close(k, np.array([np.asarray(j_kernel[1][0]),
                              np.asarray(j_kernel[1][2])]), RTOL_VALUES,
                 "kernel")
    assert np.all(np.isfinite(e)) and np.all(np.isfinite(k))
    assert not np.allclose(e, k, rtol=1e-3)


def _flat(Optic, make):
    """`make`'s system with a flat (R = inf) x-profile on the biconic: a
    biconic stays a biconic (Newton) at cv = 0."""
    lens = make(Optic)
    lens.surfaces[1].radius = math.inf
    lens._dirty()
    return lens


def test_kernels_refuse_q2d_and_eager_families():
    """The kernels' gate is JAX's (`supports_fused`): the seven kernel
    families, Forbes Q-2D among them, pass the plain versions (the card's
    wrappers on the CPU), K1's and K7's; the grid sag and NURBS are not in
    the gate, as in JAX, and the plain versions refuse them by name."""
    data, _, _ = _inputs()
    t = tuple(torch.from_numpy(a) for a in data)
    nurbs = freeform_singlet("nurbs", dict(
        conic=-0.8, n_points_u=6, n_points_v=6, nurbs_norm_x=8.0,
        nurbs_norm_y=8.0), 1)
    for name in list(CASES) + ["nurbs"]:
        ts, tp = (nurbs(TOptic).build(device="cpu") if name == "nurbs" else
                  build_both(freeform_singlet(name, CASES[name], 1))[1])
        assert tfused.supports_fused(ts) == (name in KERNEL_CASES), name
        diffp, nondiffp = tfused._uniform_params(ts, tp, 0.55)
        rg = tfused._raygen_scalars(ts, tp)
        if name in KERNEL_CASES:
            m = tfused._moments_plain(ts, diffp, nondiffp, rg, t)
            assert float(m[0]) == N_RAYS
            if name == "forbes_q2d":
                rays9 = tfused._tile_raygen(ts, rg, *t)
                rays9 = tuple(r.expand(N_RAYS) for r in rays9) + (
                    torch.full((N_RAYS,), 0.55, dtype=torch.float64),)
                h = tfused._history_plain(ts, tfused._diff_params(tp),
                                          tfused._nondiff_params(tp), rays9)
                assert float(h[6][-1].min()) == 1.0
        else:
            with pytest.raises(ValueError, match="no grid sag or NURBS"):
                tfused._moments_plain(ts, diffp, nondiffp, rg, t)
            with pytest.raises(ValueError, match="no grid sag or NURBS"):
                tfused._history_plain(ts, diffp, nondiffp, (t[0],) * 9)


def test_optic_refuses_nurbs_and_unknown_keywords():
    """NURBS builds (a fitted conic and an explicit control net;
    tests/test_torch_nurbs.py holds both to JAX), and a keyword a geometry
    does not take is refused by name."""
    lens = TOptic()
    lens.add_surface(index=0, surface_type="nurbs", radius=60.0,
                     n_points_u=5, n_points_v=5, nurbs_norm_x=4.0,
                     nurbs_norm_y=4.0)
    g = np.linspace(-4.0, 4.0, 4)
    net = np.stack(list(np.meshgrid(g, g, indexing="ij"))
                   + [np.zeros((4, 4))])
    lens.add_surface(index=1, surface_type="nurbs", control_points=net,
                     weights=np.ones((4, 4)), u_degree=2, v_degree=2)
    packed = [tspec._pack_geometry(s) for s in lens.surfaces]
    assert [p[0] for p in packed] == [tsurf.GEOM_NURBS] * 2
    assert packed[0][4] == (3, 3, 5, 5, -4.0, 4.0, -4.0, 4.0)
    assert len(packed[1][3]) == 7 + 7 + 4 * 16
    with pytest.raises(NotImplementedError, match="norm_x"):
        lens.add_surface(index=0, surface_type="zernike", norm_x=1.0)
    with pytest.raises(NotImplementedError, match="norm_radius"):
        lens.add_surface(index=0, surface_type="nurbs", norm_radius=1.0)
