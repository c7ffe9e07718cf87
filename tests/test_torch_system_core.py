"""The port's system core against the JAX package, in float64 on the CPU:
apodization, telecentric object space and the image-height fields,
aperture masks, absolute coordinate systems, the paraxial functions and
the Seidel sums, `TraceHistory`'s accessors, and the `Optic` editing API
(setters, `scale_system`, `flip`, `+`, `update_params`, pickups, solves,
`MultiConfiguration`, the thick-lens converters, `update_paraxial`).

Each system is built in both packages from one prescription
(tests/torch_port_helpers.py, chip_smoke.py's phase j7 systems). Values
are held at rtol 1e-10 of each field's largest entry. The gradient of a
scalar of `trace_system_final` into every parameter leaf is held to the
JAX package's `jax.grad` at 1e-10 on the telecentric and the paraxial
image-height systems; the real image height's fixed-count Newton costs
JAX minutes of XLA compilation under `jax.grad` (an eager `jax.grad` of
it took 167 s) or `jax.jvp` (60 s), so its gradient is held, along a few
directions in the parameters and the field coordinates, to a five-point
central difference of JAX's own values (one vmapped forward program) at
1e-10. An edit is held by the
tables it rebuilds: the JAX package's build carried across must equal the
port's. The JAX traces run in one module-scoped fixture, each system's
program jitted and compiled in a thread at XLA's backend optimization
level 0."""

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.core import apodization as japod
from optiland_tpu.system import aberrations as jab
from optiland_tpu.system import apertures as japs
from optiland_tpu.system import converters as jconv
from optiland_tpu.system import multiconfig as jmc
from optiland_tpu.system import paraxial as jpx
from optiland_tpu.system.optic import Optic as JOptic
from optiland_tpu.trace import tracer as jtracer
from optiland_tpu_torch.core import apodization as tapod
from optiland_tpu_torch.core import transforms as ttf
from optiland_tpu_torch.materials import dispersion as tdisp
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.system import aberrations as tab
from optiland_tpu_torch.system import apertures as taps
from optiland_tpu_torch.system import converters as tconv
from optiland_tpu_torch.system import multiconfig as tmc
from optiland_tpu_torch.system import paraxial as tpx
from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.trace import tracer as ttracer

from torch_port_helpers import (
    apodized_singlet,
    assert_close,
    build_both,
    carry_across,
    curved_grating,
    fold_mirror,
    image_height_singlet,
    jax_build_f64,
    jax_f64,
    masked_plates,
    singlet_lens,
    telecentric_singlet,
    thin_lens_system,
)

N_RAYS = 12
RTOL = 1e-10
W = 0.55
_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")

_XS = np.linspace(-6.0, 6.0, 7)
# each aperture class with numbers that clip part of `masked_plates`'
# bundle (EPD 12), as a callable of the aperture module of either package
MASKS = {
    "radial": lambda a: a.RadialAperture(r_max=5.5, r_min=1.0),
    "offset_radial": lambda a: a.OffsetRadialAperture(
        r_max=5.0, r_min=0.5, offset_x=0.4, offset_y=-0.3),
    "elliptical": lambda a: a.EllipticalAperture(a=5.8, b=4.5,
                                                 offset_x=0.2),
    "rectangular": lambda a: a.RectangularAperture(-5.0, 5.5, -4.8, 5.2),
    "polygon": lambda a: a.PolygonAperture(
        (-6.0, 0.0, 6.0, 5.0, -5.0), (-5.0, -6.5, -5.0, 5.5, 5.0)),
    "union": lambda a: (a.RadialAperture(r_max=3.0)
                        | a.RectangularAperture(-6.0, 6.0, -1.0, 1.0)),
    "intersection": lambda a: (a.RadialAperture(r_max=6.0)
                               & a.EllipticalAperture(a=7.0, b=5.0)),
    "difference": lambda a: (a.RadialAperture(r_max=6.0)
                             - a.RectangularAperture(-0.5, 0.5, -7.0, 7.0)),
}
# a pentagon's vertices, the text of the file `FileAperture` reads
POLYGON_FILE = "x,y\n-5.5,-4\n0,-6\n5.5,-4\n4.5,5\n-4.5,5\n"

# each geometry family on one face of a singlet (tests/test_fused_kernel.py
# FREEFORM_CASES, the grid sag of tests/test_torch_freeform.py)
FAMILIES = {
    "even_asphere": dict(coefficients=(1e-6, -1e-9)),
    "odd_asphere": dict(coefficients=(1e-5, 1e-6, -1e-9)),
    "polynomial": dict(coefficients=(0.0, 1e-5, -2e-6, 3e-6)),
    "biconic": dict(radius_y=-90.0, conic_y=0.4, conic=-0.2),
    "toroidal": dict(radius_y=55.0, conic=-0.1, coeffs_poly_y=[1e-5, -2e-8]),
    "chebyshev": dict(coefficients=[[0.0, 1e-5], [2e-5, 0.0]], norm_x=10.0,
                      norm_y=10.0),
    "zernike": dict(coefficients=(1e-5, -2e-5, 3e-5), norm_radius=8.0),
    "forbes_qbfs": dict(coefficients=(1e-4, -2e-5), norm_radius=8.0),
    "forbes_q2d": dict(norm_radius=8.0, freeform_coeffs={
        ("a", 0, 0): 1e-4, ("a", 1, 0): 2e-5, ("b", 1, 0): -1e-5}),
    "grid_sag": dict(x_coordinates=_XS, y_coordinates=_XS, sag_values=(
        1e-3 * np.add.outer(_XS**2, 0.5 * _XS**2))),
}


def family_singlet(stype):
    """A three-element train (two singlets, the second's front face the
    family `stype`, a radial aperture and a decentred surface among them)
    whose media, gaps and curvatures all differ, so that a flip or a scale
    moves every table."""
    def make(Optic):
        lens = Optic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        lens.add_surface(index=1, radius=45.0, thickness=4.0,
                         material="N-BK7", is_stop=True, aperture=9.0)
        lens.add_surface(index=2, radius=-200.0, thickness=3.0)
        lens.add_surface(index=3, radius=60.0, thickness=5.0, material=1.62,
                         surface_type=stype, **FAMILIES.get(stype, {}))
        lens.add_surface(index=4, radius=-70.0, thickness=40.0, dy=0.1)
        lens.add_surface(index=5)
        lens.set_aperture("EPD", 8.0)
        lens.set_field_type("angle")
        lens.add_field(y=0.0)
        lens.add_field(y=5.0)
        lens.add_wavelength(0.55, is_primary=True)
        return lens
    return make


def _data(seed=0, n=N_RAYS):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n),
            rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n))


def _scalar(out, lib):
    """The scalar whose gradient the field tests take: the final spot's
    second moment plus a share of the OPD."""
    return (lib.sum(out["x"] ** 2 + out["y"] ** 2)
            + 0.01 * lib.sum(out["opd"]))


def _masked(Optic):
    aps = japs if Optic is JOptic else taps
    return masked_plates(Optic, aps, list(MASKS.values()))


# system name -> (maker, whether JAX differentiates it too)
_SYSTEMS = {
    "telecentric": (telecentric_singlet, True),
    "paraxial_image_height": (
        lambda O: image_height_singlet(O, "paraxial_image_height"), True),
    "real_image_height": (
        lambda O: image_height_singlet(O, "real_image_height"), False),
    "apodized": (apodized_singlet, False),
    "fold_mirror": (fold_mirror, False),
    "masked": (_masked, False),
}
_PARAXIAL = ("F1", "F2", "N1", "N2", "P1", "P2", "magnification",
             "invariant")
# the weights of the transverse spherical terms whose gradient is taken
TSC_W = (0.3, -0.7)
# the stencil step along each of `_stencil_directions`
STENCIL_H = 1e-2
STENCIL_OFFSETS = (-2.0, -1.0, 1.0, 2.0)


def _stencil_directions():
    """(label, {leaf or "Hx"/"Hy": direction}) along which the real image
    height's gradient is held to JAX's differences: the curved faces'
    curvatures, the gaps, the field table, the NA and the rays' field
    coordinates (seed 7). A flat surface's curvature is left out: its
    intersection takes the linear root -C/B, whose derivative in cv drops
    the A t^2 term in both packages, so autograd and `jax.grad` agree there
    (held on the paraxial image-height system) and a difference does not."""
    rng = np.random.default_rng(7)
    return [
        ("cv", {"cv": np.r_[0.0, rng.normal(size=2), 0.0] * 1e-3}),
        ("thickness", {"thickness": np.r_[0.0, rng.normal(size=2), 0.0]}),
        ("y_fields", {"y_fields": np.r_[0.0, rng.normal()]}),
        ("aperture_value", {"aperture_value": np.asarray(rng.normal())}),
        ("field coordinates", {"Hx": 0.1 * rng.normal(size=N_RAYS),
                               "Hy": 0.1 * rng.normal(size=N_RAYS)}),
    ]


def _stencil_inputs(jp):
    """The stacked JAX params and (Hx, Hy) at each direction's stencil
    points, direction-major."""
    Hx, Hy, _, _ = _data()
    points = [(d, s * STENCIL_H) for _, d in _stencil_directions()
              for s in STENCIL_OFFSETS]
    leaves = {f.name: np.stack([np.asarray(getattr(jp, f.name))
                                + s * d.get(f.name, 0.0) for d, s in points])
              for f in fields(jp) if getattr(jp, f.name) is not None}
    return (jp.replace(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            jnp.asarray(np.stack([Hx + s * d.get("Hx", 0.0)
                                  for d, s in points])),
            jnp.asarray(np.stack([Hy + s * d.get("Hy", 0.0)
                                  for d, s in points])))


def _paraxial_values(px, static, params):
    vals = [getattr(px, f)(static, params) for f in _PARAXIAL]
    vals += list(px.unit_chief(static, params, "image"))
    vals += list(px.unit_chief(static, params, "object"))
    return vals


@pytest.fixture(scope="module")
def jax_results():
    """Per system of `_SYSTEMS`: the JAX history of `_data()` and, where
    marked, the gradient of `_scalar` of `trace_system_final`; for the
    Cooke triplet and a finite-object singlet the paraxial functions, for
    the singlet also `third_order` (every term and the Seidel sums) and
    the gradient of a weighted sum of its transverse spherical terms (one
    gradient: each term recomputes the paraxial rays, and JAX's tracing of
    many of them costs tens of seconds); for the real image height,
    "real_image_height_stencil", the scalar at each point of
    `_stencil_inputs`. Each system's program is one jit, the XLA compiles
    in threads at once."""
    data = tuple(jnp.asarray(a) for a in _data())
    jobs = {}
    with jax_f64():
        for name, (make, grad) in _SYSTEMS.items():
            (js, jp), port = build_both(make)

            def run(p, js=js, grad=grad):
                h = jtracer.trace_system(js, p, *data, jnp.asarray(W))
                g = (jax.grad(lambda q: _scalar(jtracer.trace_system_final(
                    js, q, *data, jnp.asarray(W)), jnp))(p) if grad
                     else None)
                return tuple(getattr(h, f) for f in _FIELDS), g

            jobs[name] = (jax.jit(run).lower(jp), (jp,), port)
            if name == "real_image_height":
                def at(p, hx, hy, js=js):
                    return _scalar(jtracer.trace_system_final(
                        js, p, hx, hy, *data[2:], jnp.asarray(W)), jnp)

                args = _stencil_inputs(jp)
                jobs[name + "_stencil"] = (
                    jax.jit(jax.vmap(at)).lower(*args), args, port)
        for name, make in (("cooke", lambda O: _cooke(O)),
                           ("finite", lambda O: singlet_lens(
                               O, object_distance=100.0, asphere=False))):
            (js, jp), port = build_both(make)

            def run(p, js=js, seidel=name == "finite"):
                if not seidel:
                    return _paraxial_values(jpx, js, p), None, None
                g = jax.grad(lambda q: jnp.sum(jab.TSC(js, q)
                                               * jnp.asarray(TSC_W)))(p)
                return (_paraxial_values(jpx, js, p), jab.third_order(js, p),
                        g)

            jobs[name] = (jax.jit(run).lower(jp), (jp,), port)
        with ThreadPoolExecutor(len(jobs)) as pool:
            compiled = list(pool.map(lambda job: job[0].compile(
                compiler_options={"xla_backend_optimization_level": 0}),
                jobs.values()))
        return {name: (jax.tree_util.tree_map(np.asarray, run(*args)), port)
                for (name, (_, args, port)), run in zip(jobs.items(),
                                                        compiled)}


def _cooke(Optic):
    from optiland_tpu.models import CookeTriplet as JCooke

    return JCooke() if Optic is JOptic else TCooke()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _assert_leaves(got, ref, tol, label):
    """Every leaf of a port gradient (a SystemParams of tensors) against
    the JAX one: NaN where JAX has NaN, the finite entries within `tol` of
    the leaf's largest finite entry."""
    for f in fields(ref):
        r = getattr(ref, f.name)
        if r is None:
            continue
        r = np.asarray(r)
        g = getattr(got, f.name)
        g = (np.zeros_like(r) if g is None else g.detach().numpy())
        assert np.array_equal(np.isnan(g), np.isnan(r)), (label, f.name)
        fin = np.isfinite(r)
        if fin.any():
            scale = max(float(np.abs(r[fin]).max()), 1e-300)
            np.testing.assert_allclose(g[fin] / scale, r[fin] / scale,
                                       rtol=0, atol=tol,
                                       err_msg=f"{label} {f.name}")


def _port_grad(ts, tp, scalar_of):
    """The gradient of `scalar_of(params)` into every leaf of `tp`."""
    leaves = {f.name: getattr(tp, f.name).detach().clone().requires_grad_(
        True) for f in fields(tp) if getattr(tp, f.name) is not None}
    p = tp.replace(**leaves)
    grads = torch.autograd.grad(scalar_of(p), list(leaves.values()),
                                allow_unused=True)
    return tp.replace(**dict(zip(leaves, grads)))


# -- apodization ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tapod._REGISTRY))
def test_apodization_weights_match_jax(name):
    rng = np.random.default_rng(5)
    Px, Py = rng.uniform(-1.1, 1.1, (2, 64))
    kw = {"gaussian": {"sigma": 0.6}, "tukey": {"R": 0.9, "alpha": 0.3},
          "super_gaussian": {"w": 0.8, "n": 4.0},
          "polynomial": {"R": 1.0, "p": 2.0}}.get(name, {})
    got = tapod.make_apodization((name, kw)).get_intensity(_t(Px), _t(Py))
    ref = japod.make_apodization((name, kw)).get_intensity(
        jnp.asarray(Px), jnp.asarray(Py))
    assert_close(got, ref, RTOL, name)
    # the three spec forms, and hash and equality by value
    apod = tapod.make_apodization(name)
    assert apod == tapod.make_apodization((name, {}))
    assert tapod.make_apodization(apod) is apod
    assert hash(tapod.make_apodization((name, kw))) == hash(
        tapod.make_apodization((name, kw)))
    assert isinstance(tapod.make_apodization(None),
                      tapod.UniformApodization)


# -- the traces of the new configurations -----------------------------------

@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_trace_system_matches_jax(jax_results, name):
    """`trace_system`'s history (its row 0 the generated rays) against
    JAX's: the apodized launch intensities, the telecentric aim, the
    image-height fields' origins, the masks' clipped intensities, the fold
    mirror's absolute placements."""
    (hist, _), (ts, tp) = jax_results[name]
    got = ttracer.trace_system(ts, tp, *map(_t, _data()), _t(W))
    for f, ref in zip(_FIELDS, hist):
        assert_close(getattr(got, f), ref, RTOL, f"{name} {f}")
    if name == "masked":
        # the masks clip part of the bundle, and the clipped rays trace on
        assert (got.intensity[-1] == 0).any()
        assert (got.intensity[-1] > 0).any()
        assert torch.isfinite(got.x[-1]).all()
    if name == "apodized":
        assert (got.intensity[0] < 1.0).any()


@pytest.mark.parametrize("name", [n for n, (_, g) in _SYSTEMS.items() if g])
def test_trace_system_final_gradient_matches_jax(jax_results, name):
    (_, ref), (ts, tp) = jax_results[name]
    data = tuple(map(_t, _data()))
    got = _port_grad(ts, tp, lambda p: _scalar(ttracer.trace_system_final(
        ts, p, *data, _t(W)), torch))
    _assert_leaves(got, ref, RTOL, name)


def _stencil_check(jax_results, per_ray):
    """The port's autograd gradient of `_scalar` of the real image
    height's `trace_system_final` along each of `_stencil_directions`
    against JAX's five-point central difference, within RTOL of
    max(|difference|, 1) (the difference's own error is ~1e-12 there).
    With `per_ray`, Hx and Hy carry a gradient too, so that
    `raygen._solve_per_field` solves each ray on its own."""
    vals, (ts, tp) = jax_results["real_image_height_stencil"]
    f = np.asarray(vals).reshape(-1, len(STENCIL_OFFSETS))
    ref = (f[:, 0] - 8.0 * f[:, 1] + 8.0 * f[:, 2] - f[:, 3]) / (
        12.0 * STENCIL_H)
    Hx, Hy, Px, Py = map(_t, _data())
    leaves = {f.name: getattr(tp, f.name).detach().clone().requires_grad_(
        True) for f in fields(tp) if getattr(tp, f.name) is not None}
    if per_ray:
        Hx, Hy = Hx.requires_grad_(True), Hy.requires_grad_(True)
        leaves.update(Hx=Hx, Hy=Hy)
    p = tp.replace(**{k: v for k, v in leaves.items()
                      if k not in ("Hx", "Hy")})
    out = _scalar(ttracer.trace_system_final(ts, p, Hx, Hy, Px, Py, _t(W)),
                  torch)
    grads = dict(zip(leaves, torch.autograd.grad(out, list(leaves.values()),
                                                 allow_unused=True)))
    checked = 0
    for (label, d), r in zip(_stencil_directions(), ref):
        if not set(d) <= set(grads):
            continue
        got = sum(float((grads[k] * _t(v)).sum()) for k, v in d.items())
        assert abs(got - r) <= RTOL * max(abs(r), 1.0), (label, got, r)
        checked += 1
    assert checked == len(ref) - (not per_ray)


def test_real_image_height_gradient_matches_difference(jax_results):
    """The real image height's gradient (autograd through the port's
    fixed-count Newton, once per field point, its Jacobian by forward-mode
    probes) into the curvatures, gaps, field table and NA, against JAX's
    differences."""
    _stencil_check(jax_results, per_ray=False)


def test_real_image_height_per_ray_gradient_matches_difference(jax_results):
    """As above with the rays' field coordinates differentiated too: the
    Newton runs per ray, and the gradient into Hx and Hy is held as
    well."""
    _stencil_check(jax_results, per_ray=True)


def test_telecentric_validation():
    lens = TCooke()
    lens.set_telecentric(True)
    with pytest.raises(ValueError, match="telecentric"):
        lens.build(device="cpu")
    lens.set_field_type("object_height")
    with pytest.raises(ValueError, match="not compatible"):
        lens.build(device="cpu")


# -- aperture masks ---------------------------------------------------------

@pytest.mark.parametrize("name", list(MASKS) + ["file"])
def test_aperture_contains_matches_jax(name, tmp_path):
    rng = np.random.default_rng(6)
    x, y = rng.uniform(-7.0, 7.0, (2, 400))
    if name == "file":
        path = tmp_path / "pentagon.csv"
        path.write_text(POLYGON_FILE)
        got_ap = taps.FileAperture(str(path), skip_header=1)
        ref_ap = japs.FileAperture(str(path), skip_header=1)
        assert got_ap.xs == ref_ap.xs and got_ap.ys == ref_ap.ys
    else:
        got_ap, ref_ap = MASKS[name](taps), MASKS[name](japs)
    got = got_ap.contains(_t(x), _t(y))
    ref = np.asarray(ref_ap.contains(jnp.asarray(x), jnp.asarray(y)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < x.size
    np.testing.assert_array_equal(got_ap.clip(_t(x), _t(y)).numpy(), ~ref)
    assert got_ap.extent == pytest.approx(ref_ap.extent)


def test_masks_carry_across_as_port_objects(jax_results):
    """`static_from_dict` turns JAX's masks, apodization, BSDFs and
    thin-film stacks into the port's classes, field by field; an object
    with no counterpart is refused by name."""
    from optiland_tpu.core import scatter as jscatter
    from optiland_tpu.thin_film.stack import ThinFilmStack as JStack
    from optiland_tpu_torch.core import scatter as tscatter
    from optiland_tpu_torch.system.spec import static_from_dict
    from optiland_tpu_torch.thin_film.stack import ThinFilmStack as TStack

    _, (ts, _) = jax_results["masked"]
    masks = [m for m in ts.aperture_masks if m is not None]
    assert len(masks) == len(MASKS)
    assert all(type(m).__module__ == taps.__name__ for m in masks)
    _, (ts, _) = jax_results["apodized"]
    assert isinstance(ts.apodization, tapod.GaussianApodization)
    d = {f.name: getattr(ts, f.name) for f in fields(ts)}
    d["bsdfs"] = (None, jscatter.GaussianBSDF(0.2), jscatter.LambertianBSDF())
    d["thin_films"] = (None, JStack(1.0, 1.5).add_layer_nm(1.38, 90.0), None)
    carried = static_from_dict(d)
    assert carried.bsdfs[1] == tscatter.GaussianBSDF(0.2)
    assert carried.bsdfs[2] == tscatter.LambertianBSDF()
    stack = carried.thin_films[1]
    assert isinstance(stack, TStack) and stack.layers[0].thickness_um == 0.09
    with pytest.raises(NotImplementedError, match="object"):
        static_from_dict({"bsdfs": (None, object(), None)})


# -- paraxial functions and Seidel sums -------------------------------------

@pytest.mark.parametrize("name", ["cooke", "finite"])
def test_paraxial_functions_match_jax(jax_results, name):
    (par, _, _), (ts, tp) = jax_results[name]
    for label, got, ref in zip(_PARAXIAL + ("y_img", "u_img", "y_obj",
                                            "u_obj"),
                               _paraxial_values(tpx, ts, tp), par):
        assert_close(got, ref, RTOL, label, scale=max(abs(float(ref)), 1.0))


def test_seidels_match_jax(jax_results):
    (_, third, grad), (ts, tp) = jax_results["finite"]
    for k, (got, ref) in enumerate(zip(tab.third_order(ts, tp), third)):
        assert_close(got, ref, RTOL, f"third_order[{k}]")
    assert_close(tab.seidels(ts, tp), third[-1], RTOL, "seidels")
    # the twelve sums against the terms of JAX's `third_order`
    terms = (tab.TSC, tab.SC, tab.CC, tab.TCC, tab.TAC, tab.AC, tab.TPC,
             tab.PC, tab.DC, tab.TAchC, tab.LchC, tab.TchC)
    for fn, ref in zip(terms, third):
        assert_close(fn(ts, tp), ref, RTOL, fn.__name__)
    weights = torch.tensor(TSC_W, dtype=torch.float64)
    got = _port_grad(ts, tp, lambda p: torch.sum(tab.TSC(ts, p) * weights))
    _assert_leaves(got, grad, RTOL, "TSC gradient")


def test_small_leaves_match_jax():
    from optiland_tpu.core.transforms import rotation_matrix as jrot
    from optiland_tpu.materials.dispersion import (
        FORMULA_IDEAL,
        material_extinction as jext,
    )

    with jax_f64():
        ref = np.asarray(jrot(jnp.asarray(0.1), jnp.asarray(-0.4),
                              jnp.asarray(1.3)))
    assert_close(ttf.rotation_matrix(0.1, -0.4, 1.3), ref, 1e-14, "R")
    w = np.asarray([0.45, 0.55, 0.65])
    coeffs = np.asarray([1.5, 2e-4, 0.0])
    for formula, n in ((FORMULA_IDEAL, 2), (FORMULA_IDEAL, 1), (1, 3)):
        got = tdisp.material_extinction(formula, n, _t(coeffs), _t(w))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jext(formula, n, jnp.asarray(coeffs),
                                         jnp.asarray(w))))


def test_trace_history_accessors(jax_results):
    (hist, _), (ts, tp) = jax_results["fold_mirror"]
    got = ttracer.trace_system(ts, tp, *map(_t, _data()), _t(W))
    assert got.num_surfaces == ts.num_surfaces == len(hist[0])
    rays = got.final_rays(_t(W))
    for name, f in zip(("x", "y", "z", "L", "M", "N", "i", "opd"), _FIELDS):
        assert_close(getattr(rays, name), hist[_FIELDS.index(f)][-1], RTOL,
                     name)
    assert torch.equal(rays.w, torch.full_like(rays.x, W))
    assert torch.equal(got.final_rays().w, torch.zeros_like(rays.x))
    assert got.p is None  # a scalar trace carries no PRT matrices


# -- the editing API ----------------------------------------------------------

def _assert_same_build(jlens, tlens, tol=0.0):
    """The JAX lens's build, carried across, equals the port lens's own
    (within `tol` relative, where the edit computed its numbers)."""
    js, jp = jax_build_f64(jlens)
    ts, tp = tlens.build(device="cpu")
    cs, cp = carry_across(js, jp)
    assert ts == cs
    for f in fields(tp):
        a, b = getattr(tp, f.name), getattr(cp, f.name)
        torch.testing.assert_close(a, b, rtol=tol, atol=0, equal_nan=True,
                                   msg=f.name)


def _both(make):
    return make(JOptic), make(TOptic)


def test_setters_match_jax():
    _assert_same_build(*_both(_edited))


def _edited(Optic):
    lens = _cooke(Optic)
    lens.set_radius(25.0, 1)
    lens.set_conic(-0.4, 2)
    lens.set_thickness(4.0, 3)
    lens.set_index(1.7, 3)
    lens.set_material("N-SF5", 5)
    lens.set_material(("F2", "schott"), 1)
    lens.set_asphere_coeff(2e-6, 6, 1)
    return lens


_EDIT_FAMILIES = ["standard"] + list(FAMILIES)


@pytest.mark.parametrize("stype", _EDIT_FAMILIES)
def test_scale_system_matches_jax(stype):
    jl, tl = _both(family_singlet(stype))
    for lens in (jl, tl):
        lens.scale_system(1.7)
    _assert_same_build(jl, tl)


@pytest.mark.parametrize("stype", _EDIT_FAMILIES + ["grating"])
def test_flip_matches_jax(stype):
    """One flip against the JAX package's; a second restores the build."""
    make = (curved_grating if stype == "grating"
            else family_singlet(stype))
    jl, tl = _both(make)
    for lens in (jl, tl):
        lens.flip()
    _assert_same_build(jl, tl)
    tl.flip()
    ts, tp = tl.build(device="cpu")
    os_, op = make(TOptic).build(device="cpu")
    assert ts == os_
    for f in fields(tp):
        assert torch.equal(getattr(tp, f.name), getattr(op, f.name)), f.name


def test_scale_grating_and_mask():
    """A grating's period and a radial aperture scale; a mask keeps its
    size, as in the JAX package."""
    jl, tl = _both(curved_grating)
    for lens in (jl, tl):
        lens.scale_system(0.5)
    _assert_same_build(jl, tl)
    jl, tl = _both(_masked)
    for lens in (jl, tl):
        lens.scale_system(2.0)
    _assert_same_build(jl, tl)


def test_add_and_update_params():
    jl = _cooke(JOptic) + singlet_lens(JOptic, asphere=False)
    tl = _cooke(TOptic) + singlet_lens(TOptic, asphere=False)
    _assert_same_build(jl, tl)
    assert tl.name == "CookeTriplet+Optic"
    assert sum(s.is_stop for s in tl.surfaces.specs) == 1
    # update_params installs new parameters, the structure kept
    ts, tp = tl.build(device="cpu")
    assert tl.static == ts and tl.params is tp
    new = tp.replace(cv=tp.cv * 1.01)
    tl.update_params(new)
    assert tl.params is new and tl.static == ts
    Px, Py = _t(np.linspace(-0.5, 0.5, 5)), _t(np.zeros(5))
    h = tl.trace(Hy=1.0, distribution=(Px, Py), device="cpu")
    ref = ttracer.trace_system(ts, new, torch.zeros(5, dtype=torch.float64),
                               torch.ones(5, dtype=torch.float64), Px, Py,
                               _t(tl.primary_wavelength))
    assert torch.equal(h.x, ref.x)
    tl.set_radius(30.0, 1)
    assert tl.params is not new


def test_pickups_and_solves_match_jax():
    """A pickup and the five solves (marginal and chief ray heights by
    thickness, the two ray-angle curvature solves, quick focus), applied
    on `update`, against the JAX package's."""
    lenses = []
    for Optic in (JOptic, TOptic):
        lens = _cooke(Optic)
        if Optic is TOptic:
            lens.build(device="cpu")
        with jax_f64():
            lens.pickups.add(1, "radius", 6, scale=-1.0)
            lens.solves.add("marginal_ray_height", 6, height=0.5)
            lens.solves.add("chief_ray_height", 3, height=0.2)
            lens.solves.add("marginal_ray_angle_curvature", 5, angle=-0.08)
            lens.solves.add("chief_ray_angle_curvature", 2, angle=0.05)
            lens.solves.add("quick_focus")
            lens.update()
        lenses.append(lens)
    assert len(lenses[1].pickups) == 1 and len(lenses[1].solves) == 5
    # the solves' numbers come from each package's paraxial trace
    _assert_same_build(*lenses, tol=1e-12)
    with pytest.raises(ValueError, match="Unknown solve type"):
        lenses[1].solves.add("nope")


def test_multiconfiguration_matches_jax():
    out = []
    for Optic, mc in ((JOptic, jmc), (TOptic, tmc)):
        m = mc.MultiConfiguration(_cooke(Optic))
        cfg = m.add_configuration(unlink=((6, "thickness"),))
        cfg.set_thickness(45.0, 6)
        m.configurations[0].set_radius(22.5, 1)
        m.update()
        out.append(m)
    assert len(out[1]) == 2 and len(out[1].cross_pickups) == len(
        out[0].cross_pickups)
    for jl, tl in zip(out[0].configurations, out[1].configurations):
        _assert_same_build(jl, tl)
    hists = out[1].trace_all(Hy=1.0, num_rays=2, device="cpu")
    assert [h.x.shape for h in hists] == [(8, 19), (8, 19)]
    assert not torch.equal(hists[0].x[-1], hists[1].x[-1])


def test_thick_lens_converters_match_jax():
    jl, tl = _both(lambda O: thin_lens_system(O))
    with jax_f64():
        jconv.paraxial_to_thick_lens(jl, 1, material="N-BK7",
                                     center_thickness=4.0)
    tconv.paraxial_to_thick_lens(tl, 1, material="N-BK7",
                                 center_thickness=4.0)
    _assert_same_build(jl, tl)
    jl, tl = _both(lambda O: thin_lens_system(O) + thin_lens_system(O))
    with jax_f64():
        jconv.convert_to_thick_lens(jl)
    tconv.convert_to_thick_lens(tl)
    _assert_same_build(jl, tl)
    with pytest.raises(TypeError, match="not a thin-lens"):
        tconv.paraxial_to_thick_lens(tl, 1)


def test_update_paraxial_matches_jax():
    jl, tl = _both(lambda O: singlet_lens(O, asphere=False, aperture=7.5))
    with jax_f64():
        ref = jl.update_paraxial()
    tl.build(device="cpu")
    got = tl.update_paraxial()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    assert got[1] == 7.5
