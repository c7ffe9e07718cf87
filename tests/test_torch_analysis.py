"""The analyses of the PyTorch port against the JAX package, float64 on the
CPU, on the Cooke triplet at small sizes: `analysis/` (every class of its
`__all__`), `mtf/geometric.py` and `colorimetry/`.

  - each class built the same way in both packages (the port's with
    `device="cpu"`), every array it exposes at rtol 1e-10 of the array's
    largest entry; the random pupils of `EncircledEnergy`,
    `IncoherentIrradiance` and `RadiantIntensity` come from
    `np.random.default_rng(None)` in both packages, which the tests seed
    (`seeded_rng`), so that both draw the same points;
  - `bin_irradiance` and `bin_radiant_intensity` and their gradients in the
    rays' power against `jax.grad`;
  - the PSF basis: its field grid of FFT PSFs at TOL_PSF (the OPD's
    rounding, as tests/test_torch_wave_analyses.py holds FFT PSFs), the
    centred SVD on JAX's own grid at 1e-10, each singular pair after
    aligning its sign, and the rank-K reconstruction;
  - `ImageSimulationEngine.run` at oversample 1 and 2 (the second shrinks
    its image by antialiased resizing) on an 8-bit image: the engine keeps
    the image in float32, as JAX does, and an 8-bit image resized by 2 is
    exact in float32 (weights 1/4 and 3/4), so every float32 stage is
    exact and the comparison measures the float64 ones;
  - `_resize` against `jax.image.resize` enlarging and shrinking;
  - colorimetry on a thin-film stack's transmission spectrum;
  - `RadiantIntensity(source=...)` refused by name, every `view()` under
    matplotlib's Agg backend, and every class on the CUDA card by default
    (it raises without one).

Two analyses are rounding-bound by construction, and are held to the
rounding they carry: `Distortion` divides by the image height of a chief
ray at Hy = 1e-10 (~4e-10 mm, which a float64 trace resolves to ~1e-16
mm, 3e-7 of itself), and `FieldCurvature` intersects parabasal pairs
split by 1e-5 in the pupil (their directions differ by ~1e-6, resolved
to ~1e-16). Their traced rows are held at 1e-10, the derived curves at
TOL_ROUNDING of their scale.

The JAX references are made once per module, each class in a thread, with
every `jax.jit` of that window compiled at XLA's backend optimization level
0 (the same float64 arithmetic), and the calls JAX's classes make eagerly
jitted for the oracle (`jax_oracles_jitted`)."""

import functools
import threading
from concurrent.futures import (Future, ProcessPoolExecutor,
                                ThreadPoolExecutor)
from contextlib import contextmanager
from multiprocessing import get_context

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_tpu.analysis as JA
from optiland_tpu import colorimetry as jcolor
from optiland_tpu.analysis import image_simulation as jsim
from optiland_tpu.analysis import intensity as jint
from optiland_tpu.analysis import irradiance as jirr
from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.mtf import GeometricMTF as JGeometricMTF
from optiland_tpu.thin_film import ThinFilmStack as JStack
import optiland_tpu_torch.analysis as TA
from optiland_tpu_torch import colorimetry as tcolor
from optiland_tpu_torch.analysis import image_simulation as tsim
from optiland_tpu_torch.analysis import intensity as tint
from optiland_tpu_torch.analysis import irradiance as tirr
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.mtf import GeometricMTF as TGeometricMTF
from optiland_tpu_torch.thin_film import ThinFilmStack as TStack

from torch_port_helpers import jax_f64

RTOL = 1e-10
TOL_ROUNDING = 1e-6
# the FFT PSFs of the PSF basis: the OPD's division by the wavelength
# scales a path difference of a few ulps of ~50 mm (1e-14 mm) to 2e-11
# waves, 2 pi times that in each phase, ~1e-10 of the peak; held at
# 1e-9, as tests/test_torch_wave_analyses.py holds the FFT PSFs
TOL_PSF = 1e-9
SEED = 1234
LEVEL0 = {"xla_backend_optimization_level": 0}
IMAGE = np.random.default_rng(0).integers(0, 256, (16, 20, 3), np.uint8)
ENGINE = {"psf_grid_shape": (3, 3), "psf_size": 32, "num_rays": 16,
          "padding": 4, "wavelengths": [0.65, 0.55]}


def _np(a):
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(got, ref, tol=RTOL, label=""):
    """|got - ref| <= tol * max|ref| (NaN where ref is NaN)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    nan = np.isnan(ref)
    assert (np.isnan(got) == nan).all(), f"{label}: NaN pattern"
    got, ref = got[~nan], ref[~nan]
    if ref.size == 0:
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"{label}: {err:.3e} of scale"


@contextmanager
def seeded_rng(seed=SEED):
    """`np.random.default_rng(None)` seeded: the random pupils of both
    packages (`core/distributions.random`) draw the same points."""
    orig = np.random.default_rng

    def rng(s=None):
        return orig(seed if s is None else s)

    np.random.default_rng = rng
    try:
        yield
    finally:
        np.random.default_rng = orig


@contextmanager
def level0_jit():
    """Every `jax.jit` made in this window compiles at optimization level 0."""
    orig = jax.jit

    def jit(fun=None, **kw):
        kw.setdefault("compiler_options", LEVEL0)
        return orig(fun, **kw) if fun is not None else functools.partial(
            jit, **kw)

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = orig


# -- the cases: one constructor call for both packages ----------------------
# `make(mod, lens, kw)` builds the analysis from the package's namespace
# (`mod`: the JAX or the port's analysis module, with GeometricMTF beside);
# `arrays(obj)` names what is compared.

def _spot_arrays(s):
    return {"x": s.x, "y": s.y, "intensity": s.intensity,
            "rms": s.rms_spot_radius(), "geo": s.geometric_spot_radius(),
            "centroid": np.array([[float(v) for v in c]
                                  for c in s.centroid()]),
            "airy": float(s.airy_radius())}


def _mtf_arrays(m):
    return {"freq": m.freq, "dl": m.diff_limited_mtf,
            "mtf": [[_np(a) for a in row] for row in m.mtf]}


def _ee_arrays(e):
    radii, curves = e.encircled_energy()
    return {"radii": [_np(r) for r in radii],
            "curves": [_np(c) for c in curves],
            "centroid": np.array([[float(v) for v in c]
                                  for c in e.centroid()])}


def _fan_arrays(f):
    return {k: f.data[k] for k in ("ex", "ey", "intensity_x", "intensity_y")}


def _pupil_arrays(p):
    return {f"{f} {w} {a}": p.data[f][w][a] for f in p.fields
            for w in p.wavelengths for a in ("x", "y")}


def _irr_arrays(r):
    return {"grids": [[_np(g) for g in row] for row in r.data],
            "extent": r.extent, "peak": r.peak_irradiance()}


def _int_arrays(r):
    return {"cells": [[tuple(_np(a) for a in c) for c in row]
                      for row in r.data],
            "peak": r.peak_intensity_values(),
            "cross_x": tuple(_np(a) for a in r.cross_section(0, 0, "x")),
            "cross_y": tuple(_np(a) for a in r.cross_section(0, 0, "y", 2.0))}


CASES = {
    "SpotDiagram": (lambda M, L, kw: M.SpotDiagram(L, num_rings=3, **kw),
                    _spot_arrays),
    "SpotDiagram centroid": (
        lambda M, L, kw: M.SpotDiagram(L, fields=[(0.0, 0.0), (0.0, 1.0)],
                                       wavelengths=[0.48, 0.65], num_rings=4,
                                       reference="centroid", **kw),
        _spot_arrays),
    "GeometricMTF": (lambda M, L, kw: M.GeometricMTF(L, num_rays=8,
                                                     num_points=32, **kw),
                     _mtf_arrays),
    "EncircledEnergy": (lambda M, L, kw: M.EncircledEnergy(
        L, num_rays=200, num_points=16, **kw), _ee_arrays),
    "RmsSpotSizeVsField": (lambda M, L, kw: M.RmsSpotSizeVsField(
        L, num_fields=3, num_rings=3, **kw), lambda r: {"rms": r._spot_size}),
    "RmsWavefrontErrorVsField": (lambda M, L, kw: M.RmsWavefrontErrorVsField(
        L, num_fields=3, num_rings=3, **kw),
        lambda r: {"rms": r._wavefront_error}),
    "RayFan": (lambda M, L, kw: M.RayFan(L, num_points=8, **kw), _fan_arrays),
    "BestFitRayFan": (lambda M, L, kw: M.BestFitRayFan(
        L, num_points=8, num_rays_for_fit=3, **kw), _fan_arrays),
    "ThroughFocusSpotDiagram": (lambda M, L, kw: M.ThroughFocusSpotDiagram(
        L, num_rings=3, **kw), lambda t: {"rms": t.rms_spot_radius()}),
    "ThroughFocusMTF": (lambda M, L, kw: M.ThroughFocusMTF(
        L, 20.0, num_rays=8, **kw), lambda t: {"mtf": t.data}),
    "MTFvsField": (lambda M, L, kw: M.MTFvsField(L, num_fields=3,
                                                 num_rays=8, **kw),
                   lambda m: dict(m.data)),
    "GridDistortion": (lambda M, L, kw: M.GridDistortion(L, num_points=4,
                                                         **kw),
                       lambda g: {k: g.data[k] for k in ("xr", "yr")}),
    "YYbar": (lambda M, L, kw: M.YYbar(L, **kw), lambda y: dict(y.data)),
    "PupilAberration": (lambda M, L, kw: M.PupilAberration(
        L, num_points=8, **kw), _pupil_arrays),
    "AngleVsHeight": (lambda M, L, kw: M.AngleVsHeight(
        L, surface_idx=4, num_points=8, **kw), lambda a: dict(a.data)),
    "PupilIncidentAngleVsHeight": (
        lambda M, L, kw: M.PupilIncidentAngleVsHeight(
            L, axis=0, num_points=8, Hy=0.7, **kw), lambda a: dict(a.data)),
    "FieldIncidentAngleVsHeight": (
        lambda M, L, kw: M.FieldIncidentAngleVsHeight(
            L, num_points=8, Py=0.5, **kw), lambda a: dict(a.data)),
    "IncoherentIrradiance": (lambda M, L, kw: M.IncoherentIrradiance(
        L, num_rays=200, res=(8, 8), **kw), _irr_arrays),
    "RadiantIntensity": (lambda M, L, kw: M.RadiantIntensity(
        L, num_rays=200, num_angular_bins=(8, 6), **kw), _int_arrays),
    "JonesPupil": (lambda M, L, kw: M.JonesPupil(L, field=(0.0, 1.0),
                                                 grid_size=4, **kw),
                   lambda j: {f"J {k}": d["J"] for k, d in enumerate(j.data)}),
}
# rounding-bound: their traced rows at RTOL, the derived curves beside
ROUNDING = {
    "Distortion": lambda M, L, kw: M.Distortion(L, num_points=8, **kw),
    "Distortion f-theta": lambda M, L, kw: M.Distortion(
        L, wavelengths="primary", num_points=8, distortion_type="f-theta",
        **kw),
    "FieldCurvature": lambda M, L, kw: M.FieldCurvature(L, num_points=8, **kw),
}
PSF_BASIS = dict(grid_shape=(3, 3), num_rays=16, psf_grid_size=32)


class _JaxNamespace:
    """JAX's analysis package with GeometricMTF beside it, as the port's
    cases see theirs."""

    def __getattr__(self, name):
        return JGeometricMTF if name == "GeometricMTF" else getattr(JA, name)


class _PortNamespace:
    def __getattr__(self, name):
        return TGeometricMTF if name == "GeometricMTF" else getattr(TA, name)


JAX_NS, PORT_NS = _JaxNamespace(), _PortNamespace()


def _flatten(tree, prefix=""):
    """{label: array} of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k} "))
        return out
    if isinstance(tree, (list, tuple)) and tree and not np.isscalar(tree[0]):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i} "))
        return out
    a = _np(tree)
    return {prefix.strip(): a.astype(np.complex128 if np.iscomplexobj(a)
                                     else np.float64)}


def _rounding(M, make_lens, make):
    """A rounding-bound analysis on a lens of its own: the traced rows it
    divides (the chief rays of `Distortion`, the parabasal pairs of
    `FieldCurvature`; every final row of each `trace_generic`) and its
    curves."""
    lens = make_lens()
    rows = []
    trace = lens.trace_generic

    def spy(*a, **k):
        h = trace(*a, **k)
        rows.append({r: _np(getattr(h, r)[-1]) for r in ("x", "y", "z", "L",
                                                         "M", "N")})
        return h

    lens.trace_generic = spy
    obj = make(M, lens, {} if M is JAX_NS else {"device": "cpu"})
    if isinstance(obj, (JA.Distortion, TA.Distortion)):
        curves = {f"{k}": c for k, c in enumerate(obj.data)}
    else:
        curves = {f"{k} {a}": c for k, pair in enumerate(obj.data)
                  for a, c in zip("ts", pair)}
    return ({f"{k} {r}": v for k, h in enumerate(rows) for r, v in h.items()},
            curves)


@contextmanager
def jax_oracles_jitted():
    """The JAX calls the analyses make eagerly, jitted for the oracles (the
    same float64 arithmetic, one compile in place of hundreds of eager
    operator compiles that hold the interpreter's lock): `wavefront_data`
    as `BestFitRayFan` imports it, `_lsf_mtf`, the Jones pupil's polarized
    `trace_system`, the distortion fit's `_poly_features`; and the PSF basis's field grid memoized per
    wavelength and configuration (JAX jits a new closure for every
    generator)."""
    from optiland_tpu.analysis import jones_pupil as jjones
    from optiland_tpu.mtf import geometric as jgeo
    from optiland_tpu.wavefront import core as jwave

    saved = [(jwave, "wavefront_data"), (jgeo, "_lsf_mtf"),
             (jjones, "trace_system"), (jsim, "_poly_features"),
             (jsim.PSFBasisGenerator, "_compute_psf_grid")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    memo, grid = {}, jsim.PSFBasisGenerator._compute_psf_grid
    lock = threading.Lock()

    def psf_grid(gen):
        """One computation per key; a thread that asks for a key another
        is computing waits for it."""
        key = (id(gen.optic), gen.wavelength, tuple(gen.grid_shape),
               gen.num_rays, gen.psf_grid_size, gen.strategy)
        with lock:
            first = key not in memo
            if first:
                memo[key] = Future()
        if first:
            memo[key].set_result(grid(gen))
        return memo[key].result()

    jwave.wavefront_data = jax.jit(
        jwave.wavefront_data, static_argnums=(0,),
        static_argnames=("strategy", "aiming"))
    jgeo._lsf_mtf = jax.jit(jgeo._lsf_mtf, static_argnums=(3,))
    jjones.trace_system = jax.jit(
        jjones.trace_system, static_argnums=(0,),
        static_argnames=("polarization",))
    jsim._poly_features = jax.jit(jsim._poly_features, static_argnums=(2,))
    jsim.PSFBasisGenerator._compute_psf_grid = psf_grid
    try:
        yield
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)


# the analyses whose JAX references run in a spawned process: the rest of
# the oracle's Python (tracing, eager dispatch) holds the interpreter's lock
SPAWNED = [name for name in list(CASES) + list(ROUNDING)
           if name not in ("JonesPupil", "RadiantIntensity",
                           "IncoherentIrradiance")]


def _jax_analyses(names, threads):
    """JAX's result for each named analysis, each in a thread, under the
    seeded generator: {name: numpy tree}."""
    with jax_f64(), seeded_rng(), level0_jit(), jax_oracles_jitted(), \
            ThreadPoolExecutor(threads) as pool:
        lens = JCooke()
        lens.build()
        jobs = {name: (pool.submit(_rounding, JAX_NS, JCooke, ROUNDING[name])
                       if name in ROUNDING else
                       pool.submit(lambda m=CASES[name][0], a=CASES[name][1]:
                                   a(m(JAX_NS, lens, {}))))
                for name in names}
        return {k: jax.tree_util.tree_map(np.asarray, f.result())
                for k, f in jobs.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference of the module: most analyses in a spawned
    process; here meanwhile, each in a thread, the engine at oversample 1
    and 2 and the PSF basis (which share the two wavelengths' PSF grids),
    the other analyses, the binning functions with their gradients and
    colorimetry."""
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as procs, \
            jax_f64(), seeded_rng(), level0_jit(), jax_oracles_jitted(), \
            ThreadPoolExecutor(8) as pool:
        spawned = procs.submit(_jax_analyses, SPAWNED, 6)
        lens = JCooke()
        lens.build()
        jobs = {f"engine {s}": pool.submit(
            lambda s=s: jsim.ImageSimulationEngine(
                lens, IMAGE, dict(ENGINE, oversample=s)).run())
            for s in (1, 2)}
        jobs["basis"] = pool.submit(_jax_basis, lens)
        jobs.update({name: pool.submit(lambda m=make, a=arrays: a(
            m(JAX_NS, lens, {}))) for name, (make, arrays) in CASES.items()
            if name not in SPAWNED})
        jobs["binning"] = pool.submit(_jax_binning)
        jobs["color"] = pool.submit(_jax_color)
        ref = {k: f.result() for k, f in jobs.items()}
        ref.update(spawned.result())
        return ref


def _jax_basis(lens):
    gen = jsim.PSFBasisGenerator(lens, 0.55, **PSF_BASIS)
    return gen._compute_psf_grid(), gen.generate_basis(3)


BIN_RNG = np.random.default_rng(5)
BIN_XY = BIN_RNG.uniform(-1.2, 1.2, (2, 300))
BIN_DIRS = BIN_RNG.uniform(-0.45, 0.45, (2, 300))
BIN_POWER = BIN_RNG.uniform(0.0, 1.0, 300)
BIN_WEIGHTS = BIN_RNG.uniform(0.0, 1.0, (8, 6))


def _bin_inputs():
    """Edge-sitting rays included: a quarter sit on the bins' edges."""
    x, y = BIN_XY.copy()
    x[::4] = np.linspace(-1.0, 1.0, 9)[np.arange(0, 300, 4) % 9]
    L, M = BIN_DIRS
    N = np.sqrt(1.0 - L**2 - M**2)
    return x, y, L, M, N, BIN_POWER


def _jax_binning():
    x, y, L, M, N, p = (jnp.asarray(a) for a in _bin_inputs())
    Wt = jnp.asarray(BIN_WEIGHTS)
    extent = ((-1.0, 1.0), (-0.9, 1.1))

    def irr(p):
        return jirr.bin_irradiance(x, y, p, extent, (8, 6))

    def inten(p, absolute):
        return jint.bin_radiant_intensity(L, M, N, p, (-20.0, 20.0),
                                          (-25.0, 15.0), (6, 8), absolute)[0]

    return {
        "irradiance": irr(p),
        "irradiance grad": jax.grad(lambda p: jnp.sum(irr(p) * Wt))(p),
        "intensity": inten(p, True),
        "intensity counts": inten(p, False),
        "intensity grad": jax.grad(
            lambda p: jnp.sum(inten(p, True) * Wt))(p),
    }


def _spectrum():
    return np.linspace(370.0, 790.0, 211)


def _color(stack_cls, color, **kw):
    stack = stack_cls("air", 1.52)
    stack.add_layer_nm(1.38, 95.0).add_layer_nm(2.1, 60.0)
    T = stack.transmittance_nm_deg(_spectrum(), 12.0, **kw)
    out = {"T": T}
    for obs in ("2deg", "10deg"):
        X, Y, Z = color.spectrum_to_xyz(_spectrum(), T, observer=obs, **kw)
        out[f"XYZ {obs}"] = [X, Y, Z]
        out[f"xyY {obs}"] = list(color.xyz_to_xyY(X, Y, Z))
        out[f"sRGB {obs}"] = list(color.xyz_to_srgb(X, Y, Z))
        out[f"sRGB raw {obs}"] = list(color.xyz_to_srgb(X, Y, Z, False))
    return out


def _jax_color():
    return _color(JStack, jcolor)


# -- the analyses -----------------------------------------------------------

@pytest.fixture(scope="module")
def port_lens():
    return TCooke()


@pytest.mark.parametrize("name", list(CASES))
def test_analysis_matches_jax(jax_ref, port_lens, name):
    make, arrays = CASES[name]
    with seeded_rng():
        got = _flatten(arrays(make(PORT_NS, port_lens, {"device": "cpu"})))
    ref = _flatten(jax_ref[name])
    assert got.keys() == ref.keys(), name
    for k in ref:
        close(got[k], ref[k], label=f"{name} {k}")


@pytest.mark.parametrize("name", list(ROUNDING))
def test_rounding_bound_analysis(jax_ref, name):
    """The traced rows at RTOL, the curves derived from their small
    differences at TOL_ROUNDING (the module's docstring)."""
    rows, curves = _rounding(PORT_NS, TCooke, ROUNDING[name])
    ref_rows, ref_curves = jax_ref[name]
    assert rows.keys() == ref_rows.keys() and curves.keys() == ref_curves.keys()
    for k, ref in ref_rows.items():
        close(rows[k], ref, label=f"{name} row {k}")
    for k, ref in ref_curves.items():
        close(curves[k], ref, TOL_ROUNDING, label=f"{name} {k}")


def test_spot_diagram_is_one_trace_on_the_build_device(port_lens,
                                                       monkeypatch):
    """One trace of fields x wavelengths x pupil at per-ray wavelengths,
    with no polarization, and the chief rays a second (JAX's
    `_jit_trace(static)`), both on the build's device."""
    from optiland_tpu_torch.analysis import spot

    calls = []
    orig = spot.trace_system

    def spy(static, params, Hx, Hy, Px, Py, w, *a, **kw):
        calls.append((Hx.shape[0], w.shape, kw.get("polarization")))
        return orig(static, params, Hx, Hy, Px, Py, w, *a, **kw)

    monkeypatch.setattr(spot, "trace_system", spy)
    s = TA.SpotDiagram(port_lens, num_rings=3, device="cpu")
    assert calls == [(3 * 3 * 37, (3 * 3 * 37,), None), (3, (3,), None)]
    assert s.x.device.type == "cpu" and s.x.shape == (3, 3, 37)


# -- binning, the PSF basis, the engine, resizing, colorimetry ---------------

def test_binning_and_gradients_match_jax(jax_ref):
    x, y, L, M, N, p = (torch.tensor(a) for a in _bin_inputs())
    p = p.clone().requires_grad_(True)
    Wt = torch.tensor(BIN_WEIGHTS)
    ref = jax_ref["binning"]
    irr = tirr.bin_irradiance(x, y, p, ((-1.0, 1.0), (-0.9, 1.1)), (8, 6))
    close(irr, ref["irradiance"], label="irradiance")
    g, = torch.autograd.grad(torch.sum(irr * Wt), p)
    close(g, ref["irradiance grad"], label="irradiance grad")
    for absolute, key in ((True, "intensity"), (False, "intensity counts")):
        out = tint.bin_radiant_intensity(L, M, N, p, (-20.0, 20.0),
                                         (-25.0, 15.0), (6, 8), absolute)
        close(out[0], ref[key], label=key)
    g, = torch.autograd.grad(torch.sum(
        tint.bin_radiant_intensity(L, M, N, p, (-20.0, 20.0), (-25.0, 15.0),
                                   (6, 8))[0] * Wt), p)
    close(g, ref["intensity grad"], label="intensity grad")


def test_psf_basis_matches_jax_up_to_sign(jax_ref, port_lens):
    """The field grid of FFT PSFs at TOL_PSF; the centred SVD on JAX's own
    grid at RTOL, each singular pair after aligning its sign (either sign
    is the solver's choice); and the whole basis's rank-K sum at TOL_PSF
    (an eigen-PSF alone moves by the grid's error over the gap between
    singular values)."""
    gen = tsim.PSFBasisGenerator(port_lens, 0.55, device="cpu", **PSF_BASIS)
    grid = gen._compute_psf_grid()
    ref_grid, (je, jc, jm) = jax_ref["basis"]
    je, jc, jm = (np.asarray(a) for a in (je, jc, jm))
    close(grid, ref_grid, TOL_PSF, label="PSF grid")
    rank_k = np.einsum("kyx,kij->yxij", jc, je)
    eigen, coeffs, mean = gen.generate_basis(3)
    close(np.einsum("kyx,kij->yxij", _np(coeffs), _np(eigen)), rank_k,
          TOL_PSF, label="rank-3 sum")

    gen._compute_psf_grid = lambda: torch.tensor(np.asarray(ref_grid))
    eigen, coeffs, mean = gen.generate_basis(3)
    close(mean, jm, label="mean PSF")
    for k in range(3):
        sign = np.sign(np.sum(_np(eigen[k]) * je[k]))
        close(sign * _np(eigen[k]), je[k], label=f"eigen PSF {k}")
        close(sign * _np(coeffs[k]), jc[k], label=f"coefficients {k}")
    close(np.einsum("kyx,kij->yxij", _np(coeffs), _np(eigen)), rank_k,
          label="rank-3 sum on JAX's grid")


@pytest.mark.parametrize("oversample", [1, 2])
def test_image_simulation_engine_matches_jax(jax_ref, port_lens, oversample):
    engine = TA.ImageSimulationEngine(port_lens, IMAGE,
                                      dict(ENGINE, oversample=oversample),
                                      device="cpu")
    out = engine.run()
    assert out.shape == (16, 20, 2) and out.dtype == torch.float64
    close(out, jax_ref[f"engine {oversample}"], label="simulated image")


@pytest.mark.parametrize("shape,size", [((3, 5, 5), (23, 17)),
                                        ((2, 24, 20), (12, 10)),
                                        ((2, 9, 7), (4, 3))])
def test_resize_matches_jax_image_resize(shape, size):
    a = np.random.default_rng(2).standard_normal(shape)
    with jax_f64():
        ref = jax.image.resize(jnp.asarray(a), shape[:1] + size, "linear")
    close(tsim._resize(torch.tensor(a), size), ref, label="resize")


def test_colorimetry_of_a_thin_film_spectrum(jax_ref):
    got = _flatten(_color(TStack, tcolor, device="cpu"))
    ref = _flatten(jax_ref["color"])
    assert got.keys() == ref.keys()
    for k in ref:
        close(got[k], ref[k], label=k)
    with pytest.raises(ValueError, match="visible range"):
        tcolor.spectrum_to_xyz(np.linspace(400.0, 700.0, 11), np.ones(11),
                               device="cpu")


def test_radiant_intensity_refuses_a_source(port_lens):
    with pytest.raises(NotImplementedError, match="fails in the JAX package"):
        TA.RadiantIntensity(port_lens, source=object(), device="cpu")


def test_all_names_match_jax():
    assert TA.__all__ == JA.__all__


@pytest.mark.parametrize("name", list(CASES) + ["ImageSimulationEngine",
                                                "colorimetry"])
def test_analyses_default_to_the_card(monkeypatch, name):
    """Without `device`, every class builds on the CUDA card and raises
    without one, as the port's entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"), seeded_rng():
        if name == "ImageSimulationEngine":
            TA.ImageSimulationEngine(TCooke(), IMAGE)
        elif name == "colorimetry":
            tcolor.spectrum_to_xyz(_spectrum(), np.ones(211))
        else:
            CASES[name][0](PORT_NS, TCooke(), {})


# -- the views ----------------------------------------------------------------

VIEWS = dict(CASES, **{name: (make, None) for name, make in ROUNDING.items()})


@pytest.mark.parametrize("name", list(VIEWS) + ["ImageSimulationEngine"])
def test_view_draws(port_lens, name):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with seeded_rng():
        if name == "ImageSimulationEngine":
            obj = TA.ImageSimulationEngine(
                port_lens, IMAGE[:8, :8, 0],
                dict(ENGINE, padding=2, wavelengths=[0.55]), device="cpu")
        else:
            obj = VIEWS[name][0](PORT_NS, port_lens, {"device": "cpu"})
    fig = obj.view()[0]
    assert fig.axes
    plt.close("all")
