"""Polarization ray tracing, BSDF scattering and the vectorial wave optics
of the PyTorch port against the JAX package, float64 on the CPU.

  - every Jones matrix of `polarization/jones.py`, `local_basis` (with its
    normal-incidence fallback), the starting field, the exit fields and
    the PRT intensity, at rtol 1e-10 of each array's scale;
  - polarized traces through Fresnel coatings, thin-film stacks (on a
    refracting and on a reflecting face) and a chain of polarizers,
    retarders and diattenuators: every history row, the PRT matrices `p`
    and the final intensity at 1e-10, the gradient of a merit in cv,
    thickness and the coatings' parameters at 1e-8;
  - `scatter_directions` and a BSDF trace on the uniforms that JAX's keys
    give (`core/scatter.py` takes them as `draws`);
  - the polarized `wavefront_data`'s `E_exits`, `VectorialHuygensPSF`,
    `VectorialFFTPSF` and `VectorialFFTMTF` at num_rays 32 and image size
    32, on a Fresnel-coated singlet;
  - the coatings' angle of incidence at normal incidence, where JAX's
    gradient is NaN and the port's is finite.

The JAX references are jitted programs of one module fixture, each
compiled at XLA's backend optimization level 0 in a thread as soon as it
is lowered (`jax_ref`)."""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.core import scatter as jscatter
from optiland_tpu.mtf.fft import VectorialFFTMTF as JVMTF
from optiland_tpu.polarization import PolarizationState as JPS
from optiland_tpu.polarization import jones as jJ
from optiland_tpu.polarization import prt as jprt
from optiland_tpu.psf.fft import VectorialFFTPSF as JVFFT
from optiland_tpu.psf.huygens import VectorialHuygensPSF as JVHuygens
from optiland_tpu.system.optic import Optic as JOptic
from optiland_tpu.thin_film.stack import ThinFilmStack as JStack
from optiland_tpu.trace.tracer import trace_system as jtrace
from optiland_tpu.wavefront.core import wavefront_data as jwavefront
from optiland_tpu_torch.core import scatter as tscatter
from optiland_tpu_torch.mtf import FFTMTF, VectorialFFTMTF
from optiland_tpu_torch.polarization import PolarizationState as TPS
from optiland_tpu_torch.polarization import jones as tJ
from optiland_tpu_torch.polarization import prt as tprt
from optiland_tpu_torch.psf import (
    FFTPSF,
    HuygensPSF,
    VectorialFFTPSF,
    VectorialHuygensPSF,
)
from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.thin_film.stack import ThinFilmStack as TStack
from optiland_tpu_torch.trace.tracer import trace_system as ttrace
from optiland_tpu_torch.wavefront import wavefront_data as twavefront

from torch_port_helpers import carry_across, jax_build_f64, jax_f64

RTOL = 1e-10
GRAD_RTOL = 1e-8
N_WAVE = 32
STATE = (True, 0.6, 0.8, 0.0, 0.5)
_ROWS = ("x", "y", "z", "L", "M", "N", "opd", "intensity")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def close(got, ref, tol=RTOL, label=""):
    """|got - ref| <= tol * max|ref| elementwise (complex or real)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"{label}: {err:.3e} of scale"


# -- prescriptions (one function, both packages) -------------------------

def fresnel_singlet(Optic, Stack=None):
    """An N-BK7 singlet (R 50, -50 mm) with "fresnel" on both faces, EPD 10,
    fields 0 and 5 degrees, 0.55 um."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=5.0, material="N-BK7",
                     is_stop=True, coating="fresnel")
    lens.add_surface(index=2, radius=-50.0, thickness=47.0,
                     coating="fresnel")
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def thin_film_singlet(Optic, Stack):
    """The singlet of tests/test_polarization.py's thin-film case: MgF2
    (1.38, 100 nm) on the front of an n = 1.5 lens; a 5 degree field."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=5.0, material=1.5,
                     is_stop=True,
                     coating=Stack(1.0, 1.5).add_layer_nm(1.38, 100.0))
    lens.add_surface(index=2, radius=-50.0, thickness=47.0)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def thin_film_mirror(Optic, Stack):
    """The concave mirror of tests/test_polarization.py's reflective
    thin-film case (MgF2, 120 nm, in air), a 3 degree field."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=-100.0, material="mirror", is_stop=True,
                     thickness=-40.0,
                     coating=Stack(1.0, 1.0).add_layer_nm(1.38, 120.0))
    lens.add_surface(index=2, radius=math.inf, thickness=0.0)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


CHAIN = (("linear_polarizer", 0.3), ("retarder", 0.7, 0.4),
         ("diattenuator", 0.2, 0.9, 0.3), "polarizer_h", "polarizer_rcp",
         "polarizer_v", "polarizer_lcp", None)


def polarizer_chain(Optic, Stack=None, faces=len(CHAIN)):
    """The first `faces` of eight coated faces: a linear polarizer, a
    retarder and a diattenuator on the faces of two weak N-BK7 lenses, an
    H polarizer behind them, then RCP, V and LCP polarizers on flat faces
    in air (the local basis's fallback where k0 = k1), a 4 degree
    field."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    radii = (200.0, -300.0, 250.0, -400.0, math.inf, math.inf, math.inf,
             math.inf)
    mats = ("N-BK7", "air", "N-BK7", "air", "air", "air", "air", "air")
    for k, (r, m, c) in enumerate(list(zip(radii, mats, CHAIN))[:faces]):
        lens.add_surface(index=k + 1, radius=r, thickness=3.0, material=m,
                         is_stop=k == 0, coating=c)
    lens.add_surface(index=faces + 1)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=4.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def bsdf_plate(Optic, bsdf):
    """A flat N-BK7 plate with `bsdf` on its back face."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, thickness=10.0,
                     material="N-BK7", is_stop=True)
    lens.add_surface(index=2, radius=80.0, thickness=20.0)
    lens.add_surface(index=3)
    lens.surfaces[2].bsdf = bsdf
    lens.set_aperture("EPD", 4.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=10.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


# the traced systems: (prescription, states, Hy, gradient leaves); a
# system's states share one JAX program. The whole chain is held without
# its gradient (XLA takes ~20 s to compile the gradient of eight complex
# PRT products), its first four faces with it.
TRACES = {
    "fresnel": (fresnel_singlet, (STATE, None), 1.0, ("cv", "thickness")),
    "thin_film": (thin_film_singlet, (STATE,), 1.0, ("cv", "thickness")),
    "thin_film_mirror": (thin_film_mirror, ((True, 1.0, 0.0, 0.0, 0.0),),
                         1.0, ("cv",)),
    "chain": (polarizer_chain, ((True, 1.0, 0.0, 0.0, 0.0),), 1.0, ()),
    "chain_4": (lambda O, S: polarizer_chain(O, S, 4),
                ((True, 0.6, 0.8, 0.0, 0.5),), 1.0, ("cv", "coating_params")),
}
RINGS = 4


def _dirs(n=61, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.uniform(-0.3, 0.3, n)
    M = rng.uniform(-0.3, 0.3, n)
    k0 = np.stack([L, M, np.sqrt(1 - L**2 - M**2)], axis=1)
    L2 = L + rng.uniform(-0.1, 0.1, n)
    M2 = M + rng.uniform(-0.1, 0.1, n)
    k1 = np.stack([L2, M2, np.sqrt(1 - L2**2 - M2**2)], axis=1)
    # normal incidence (k0 = k1 = z: the fallback's second branch) and an
    # index-matched oblique ray (k0 = k1)
    k0[0] = k1[0] = (0.0, 0.0, 1.0)
    k1[1] = k0[1]
    return k0, k1


def _merit(h):
    return torch.sum(h.intensity[-1]) + 0.01 * torch.sum(h.y[-1] ** 2)


def _jmerit(h):
    return jnp.sum(h.intensity[-1]) + 0.01 * jnp.sum(h.y[-1] ** 2)


def _state(pkg_state, s):
    return pkg_state.unpolarized() if s is None else pkg_state(*s)


def _inputs(Hy, rings=RINGS):
    from optiland_tpu.core import distributions as jdist

    Px, Py = (np.asarray(a) for a in jdist.generate("hexapolar", rings)[:2])
    return np.zeros_like(Px), np.full_like(Px, Hy), Px, Py


def _bsdf_draws(key, n, budget=8):
    """The standard uniforms that `scatter_directions` draws from `key`
    (its split into `budget` attempt keys, each split into a radius and an
    angle key), as (u_r, u_t), each (budget, n)."""
    u = [jax.random.split(k) for k in jax.random.split(key, budget)]
    return tuple(np.stack([np.asarray(jax.random.uniform(ks[j], (n,)))
                           for ks in u]) for j in (0, 1))


LEVEL0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX references as jitted programs, each lowered in turn and
    compiled in a thread as soon as it is lowered, at XLA's backend
    optimization level 0 (the same float64 arithmetic): the Jones and PRT
    algebra, each traced system's history and merit gradient,
    `scatter_directions`, the BSDF traces, the polarized wavefront, and the
    vectorial PSFs' classes staged whole; the MTF class runs eagerly in a
    thread beside them (it reads its working F-numbers on the host)."""
    jobs = {}
    with jax_f64(), ThreadPoolExecutor(8) as pool:
        def add(key, lowered, args, extra=()):
            jobs[key] = (pool.submit(lowered.compile, LEVEL0), args, extra)

        # the wave optics on the Fresnel singlet, unpolarized (the optic
        # built first, so that its cache holds arrays, not tracers)
        lens = fresnel_singlet(JOptic)
        lens.set_polarization("unpolarized")
        js, jp = lens.build()
        mtf = pool.submit(lambda: JVMTF(lens, fields=[(0.0, 1.0)],
                                        num_rays=N_WAVE).mtf[0])
        for name, (make, states, Hy, leaves) in TRACES.items():
            tjs, tjp = jax_build_f64(make(JOptic, JStack))

            def run(sub, args, js=tjs, jp=tjp, states=states):
                out = []
                for s in states:
                    def f(sub, s=s):
                        h = jtrace(js, jp.replace(**sub), *args, 0.55,
                                   polarization=_state(JPS, s))
                        return _jmerit(h), h

                    if sub:
                        (_, h), g = jax.value_and_grad(f, has_aux=True)(sub)
                    else:
                        h, g = f(sub)[1], {}
                    out.append((h, g))
                return out

            sub = {k: getattr(tjp, k) for k in leaves}
            args = tuple(jnp.asarray(a) for a in _inputs(Hy))
            add(("trace", name), jax.jit(run).lower(sub, args), (sub, args),
                (tjs, tjp))
        pupil = tuple(jnp.asarray(a) for a in _inputs(1.0)[2:])
        add(("wave", "data"), jax.jit(lambda p, P: jwavefront(
            js, p, 0.0, 1.0, *P, 0.55, polarization=JPS.unpolarized())).lower(
                jp, pupil), (jp, pupil))
        add(("wave", "huygens"), jax.jit(lambda: JVHuygens(
            lens, (0.0, 0.0), num_rays=N_WAVE, image_size=N_WAVE).psf).lower(),
            ())
        add(("wave", "fft"), jax.jit(lambda: JVFFT(
            lens, (0.0, 1.0), num_rays=N_WAVE).psf).lower(), ())
        for bsdf in (jscatter.LambertianBSDF(), jscatter.GaussianBSDF(0.1)):
            bjs, bjp = jax_build_f64(bsdf_plate(JOptic, bsdf))
            args = tuple(jnp.asarray(a) for a in _inputs(0.5))
            add(("bsdf", bsdf.kind), jax.jit(
                lambda p, a, js=bjs: jtrace(js, p, *a, 0.55)).lower(bjp, args),
                (bjp, args), (bjs, bjp))

        def algebra(k0, k1):
            aoi = jnp.arccos(jnp.abs(k0[:, 2]))
            jones = {
                "fresnel_t": jJ.fresnel(k0, k1, aoi, 1.0, 1.52,
                                        reflect=False),
                "fresnel_r": jJ.fresnel(k0, k1, aoi, 1.0, 1.52, reflect=True),
                "pol_h": jJ.polarizer_h(k0, k1),
                "pol_v": jJ.polarizer_v(k0, k1),
                "rcp": jJ.polarizer_rcp(k0, k1),
                "lcp": jJ.polarizer_lcp(k0, k1),
                "linear": jJ.linear_polarizer(k0, k1, [0.6, 0.8, 0.0]),
                "diattenuator": jJ.linear_diattenuator(
                    k0, k1, 0.2, 0.9, [math.cos(0.3), math.sin(0.3), 0.0]),
                "retarder": jJ.linear_retarder(
                    k0, k1, 0.7, [math.cos(0.4), math.sin(0.4), 0.0]),
                "quarter": jJ.quarter_wave_retarder(k0, k1, 0.2),
                "half": jJ.half_wave_retarder(k0, k1, -0.5),
            }
            P = jprt.surface_prt(k0, k1, jones["retarder"])
            i0 = jnp.linspace(0.5, 1.0, k0.shape[0])
            return jones, jprt.local_basis(k0, k1), (
                P, jprt.surface_prt(k0, k1),
                jprt.initial_field(k0, JPS(*STATE)),
                jprt.exit_fields(P, k0, i0, JPS.unpolarized()),
                jprt.intensity_from_prt(P, k0, i0, JPS(*STATE)),
                jprt.intensity_from_prt(P, k0, i0, JPS.unpolarized()))

        k0, k1 = (jnp.asarray(a) for a in _dirs())
        add(("algebra", ""), jax.jit(algebra).lower(k0, k1), (k0, k1))
        # scatter_directions on JAX's own keys
        rng = np.random.default_rng(3)
        n = k0.shape[0]
        L, M = rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n)
        ny = 0.1 * rng.standard_normal(n)
        arrays = (L, M, np.sqrt(1 - L**2 - M**2), np.zeros(n),
                  ny / np.sqrt(1 + ny**2), -1 / np.sqrt(1 + ny**2))
        key = jax.random.PRNGKey(7)
        a = tuple(jnp.asarray(v) for v in arrays)
        for kind in ("lambertian", "gaussian"):
            add(("scatter", kind), jax.jit(
                lambda a, kind=kind: jscatter.scatter_directions(
                    key, *a, kind=kind, sigma=0.1)).lower(a), (a,),
                (arrays, _bsdf_draws(key, n)))

        out = {"traces": {}, "bsdf": {}, "wave": {"mtf": mtf.result()}}
        for (kind, name), (fut, args, extra) in jobs.items():
            res = fut.result()(*args)
            if kind == "trace":
                out["traces"][name] = extra + (res,)
            elif kind == "algebra":
                out["jones"], out["basis"], out["prt"] = res
            elif kind == "scatter":
                out["bsdf"][name] = extra + (res,)
            elif kind == "bsdf":
                draws = _bsdf_draws(jax.random.fold_in(
                    jax.random.PRNGKey(0), 2), res.x.shape[1])
                out["bsdf"][name + " trace"] = extra + (res, draws)
            else:
                out["wave"][name] = res
    return out


# -- Jones matrices and the PRT algebra -------------------------------------

def test_jones_matrices_and_local_basis(jax_ref):
    k0, k1 = (torch.tensor(a) for a in _dirs())
    aoi = torch.arccos(torch.abs(k0[:, 2]))
    got = {
        "fresnel_t": tJ.fresnel(k0, k1, aoi, 1.0, 1.52, reflect=False),
        "fresnel_r": tJ.fresnel(k0, k1, aoi, 1.0, 1.52, reflect=True),
        "pol_h": tJ.polarizer_h(k0, k1), "pol_v": tJ.polarizer_v(k0, k1),
        "rcp": tJ.polarizer_rcp(k0, k1), "lcp": tJ.polarizer_lcp(k0, k1),
        "linear": tJ.linear_polarizer(k0, k1, [0.6, 0.8, 0.0]),
        "diattenuator": tJ.linear_diattenuator(
            k0, k1, 0.2, 0.9, [math.cos(0.3), math.sin(0.3), 0.0]),
        "retarder": tJ.linear_retarder(
            k0, k1, 0.7, [math.cos(0.4), math.sin(0.4), 0.0]),
        "quarter": tJ.quarter_wave_retarder(k0, k1, 0.2),
        "half": tJ.half_wave_retarder(k0, k1, -0.5),
    }
    for name, ref in jax_ref["jones"].items():
        assert got[name].dtype == torch.complex128, name
        close(got[name], ref, label=name)
    basis = tprt.local_basis(k0, k1)
    for label, g, r in zip(("s", "p0", "p1", "o_in", "o_out"), basis,
                           jax_ref["basis"]):
        close(g, r, label=label)
    # the fallback keeps the basis orthonormal where k0 = k1
    o_in = basis[3]
    eye = torch.eye(3, dtype=o_in.dtype).expand_as(o_in)
    assert torch.allclose(o_in @ o_in.transpose(1, 2), eye, atol=1e-14)


def test_prt_fields_and_intensity(jax_ref):
    k0, k1 = (torch.tensor(a) for a in _dirs())
    jm = tJ.linear_retarder(k0, k1, 0.7, [math.cos(0.4), math.sin(0.4), 0.0])
    P = tprt.surface_prt(k0, k1, jm)
    i0 = torch.linspace(0.5, 1.0, k0.shape[0], dtype=torch.float64)
    got = (P, tprt.surface_prt(k0, k1), tprt.initial_field(k0, TPS(*STATE)),
           tprt.exit_fields(P, k0, i0, TPS.unpolarized()),
           tprt.intensity_from_prt(P, k0, i0, TPS(*STATE)),
           tprt.intensity_from_prt(P, k0, i0, TPS.unpolarized()))
    labels = ("surface_prt", "rotation", "initial_field", "exit_fields",
              "intensity", "intensity unpolarized")
    for label, g, r in zip(labels, got, jax_ref["prt"]):
        if isinstance(g, list):
            for a, b in zip(g, r):
                close(a, b, label=label)
        else:
            close(g, r, label=label)
    assert torch.allclose(tprt.identity_prt(2, torch.complex128)[1],
                          torch.eye(3, dtype=torch.complex128))


# -- polarized traces -----------------------------------------------------

@pytest.mark.parametrize("name", [f"{k} {i}" for k, v in TRACES.items()
                                  for i in range(len(v[1]))])
def test_polarized_trace_and_gradient(jax_ref, name):
    name, i = name.split()
    make, states, Hy, leaves = TRACES[name]
    s = states[int(i)]
    js, jp, results = jax_ref["traces"][name]
    jh, jg = results[int(i)]
    ts, tp = carry_across(js, jp)
    args = tuple(torch.tensor(a) for a in _inputs(Hy))
    sub = {k: getattr(tp, k).clone().requires_grad_(True) for k in leaves}
    h = ttrace(ts, tp.replace(**sub), *args, 0.55,
               polarization=_state(TPS, s))
    for key in _ROWS:
        close(getattr(h, key), getattr(jh, key), label=key)
    close(h.p, jh.p, label="p")
    assert (h.intensity[-1] > 0).any()
    if leaves:
        _merit(h).backward()
    for k in leaves:
        close(sub[k].grad, jg[k], GRAD_RTOL, label=f"d merit / d {k}")
    # the port's own builder makes the same system
    ts_own, tp_own = make(TOptic, TStack).build(device="cpu")
    h_own = ttrace(ts_own, tp_own, *args, 0.55, polarization=_state(TPS, s))
    for key in _ROWS:
        assert torch.equal(getattr(h_own, key), getattr(h, key).detach()), key


def test_polarizer_goldens_through_optic_trace():
    """Malus's law, crossed polarizers, half intensity for unpolarized
    light, and a quarter-wave retarder between crossed polarizers, through
    `Optic.set_polarization` and `Optic.trace` (the goldens' plates)."""
    def plates(c1, c2, c_mid=None):
        lens = TOptic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        lens.add_surface(index=1, radius=math.inf, thickness=5.0,
                         is_stop=True, coating=c1)
        lens.add_surface(index=2, radius=math.inf, thickness=5.0,
                         coating=c_mid)
        lens.add_surface(index=3, radius=math.inf, thickness=5.0,
                         coating=c2)
        lens.add_surface(index=4)
        lens.set_aperture("EPD", 4)
        lens.set_field_type("angle")
        lens.add_field(y=0)
        lens.add_wavelength(0.55, is_primary=True)
        lens.set_polarization(TPS(True, 1.0, 0.0, 0.0, 0.0))
        return lens

    def final_i(lens):
        return lens.trace(Hx=0.0, Hy=0.0, num_rays=8,
                          device="cpu").intensity[-1]

    assert final_i(plates("polarizer_h", "polarizer_v")).abs().max() < 1e-12
    assert (final_i(plates("polarizer_h", "polarizer_h")) - 1).abs().max() \
        < 1e-12
    for theta in (0.2, 0.7, 1.3):
        i = final_i(plates("polarizer_h", ("linear_polarizer", theta)))
        assert (i - math.cos(theta) ** 2).abs().max() < 1e-12, theta
    unpol = plates("polarizer_h", None)
    unpol.set_polarization("unpolarized")
    assert (final_i(unpol) - 0.5).abs().max() < 1e-12
    quarter = plates("polarizer_h", "polarizer_v",
                     ("retarder", math.pi / 2, math.pi / 4))
    assert (final_i(quarter) - 0.5).abs().max() < 1e-12
    half = plates("polarizer_h", "polarizer_v",
                  ("retarder", math.pi, math.pi / 4))
    assert (final_i(half) - 1.0).abs().max() < 1e-12


# -- BSDF scattering ------------------------------------------------------

@pytest.mark.parametrize("kind", ["lambertian", "gaussian"])
def test_scatter_directions_on_jax_draws(jax_ref, kind):
    arrays, draws, ref = jax_ref["bsdf"][kind]
    got = tscatter.scatter_directions(
        None, *(torch.tensor(a) for a in arrays), kind=kind, sigma=0.1,
        draws=tuple(torch.tensor(d) for d in draws))
    for g, r in zip(got, ref):
        close(g, r)
    # the port's own stream: unit, forward directions
    g = torch.Generator().manual_seed(5)
    L, M, N = tscatter.scatter_directions(
        g, *(torch.tensor(a) for a in arrays), kind=kind, sigma=0.1)
    assert torch.allclose(L * L + M * M + N * N,
                          torch.ones_like(L), atol=1e-12)
    assert (N > 0).all()


@pytest.mark.parametrize("kind", ["lambertian", "gaussian"])
def test_bsdf_trace_on_jax_draws(jax_ref, kind):
    js, jp, jh, draws = jax_ref["bsdf"][kind + " trace"]
    ts, tp = carry_across(js, jp)
    assert isinstance(ts.bsdfs[2], (tscatter.LambertianBSDF,
                                    tscatter.GaussianBSDF))
    args = tuple(torch.tensor(a) for a in _inputs(0.5))
    h = ttrace(ts, tp, *args, 0.55,
               scatter_draws={2: tuple(torch.tensor(d) for d in draws)})
    for key in _ROWS:
        close(getattr(h, key), getattr(jh, key), label=key)
    # a generator's stream is reproducible
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = ttrace(ts, tp, *args, 0.55, scatter=g1)
    b = ttrace(ts, tp, *args, 0.55, scatter=g2)
    assert torch.equal(a.L, b.L) and not torch.equal(a.L[-1], h.L[-1])
    # the stream comes from a generator, not a seed
    with pytest.raises(TypeError, match="torch.Generator"):
        ttrace(ts, tp, *args, 0.55, scatter=9)


# -- the polarized wavefront and the vectorial analyses ---------------------

def test_polarized_wavefront_and_vectorial_analyses(jax_ref):
    ref = jax_ref["wave"]
    lens = fresnel_singlet(TOptic)
    lens.set_polarization("unpolarized")
    ts, tp = lens.build(device="cpu")
    Px, Py = (torch.tensor(a) for a in _inputs(1.0)[2:])
    data = twavefront(ts, tp, 0.0, 1.0, Px, Py, 0.55,
                      polarization=TPS.unpolarized())
    assert data.E_exits.shape == (2, Px.shape[0], 3)
    close(data.E_exits, ref["data"].E_exits, label="E_exits")
    close(data.opd, ref["data"].opd, label="opd")

    psf = HuygensPSF(lens, (0.0, 0.0), num_rays=N_WAVE, image_size=N_WAVE,
                     device="cpu")
    assert isinstance(psf, VectorialHuygensPSF)
    close(psf.psf, ref["huygens"], label="VectorialHuygensPSF")
    fft = FFTPSF(lens, (0.0, 1.0), num_rays=N_WAVE, device="cpu")
    assert isinstance(fft, VectorialFFTPSF)
    close(fft.psf, ref["fft"], label="VectorialFFTPSF")
    mtf = FFTMTF(lens, fields=[(0.0, 1.0)], num_rays=N_WAVE, device="cpu")
    assert isinstance(mtf, VectorialFFTMTF)
    for g, r in zip(mtf.mtf[0], ref["mtf"]):
        close(g, r, 1e-9, label="VectorialFFTMTF")


def test_normal_incidence_gradient_is_finite():
    """Rays at and near normal incidence to Fresnel-coated faces (the
    on-axis chief ray, and rays within ~3e-4 rad of the normals, where
    float32 rounds |k0 . n| to 1): JAX's arccos has an infinite derivative
    there and its gradient is NaN; the port's AOI (`tracer._aoi`) keeps
    the gradient finite in both precisions, and float32's within 1e-3 of
    float64's scale."""
    from optiland_tpu_torch import config

    grads = {}
    for prec in ("float32", "float64"):
        config.set_precision(prec)
        try:
            st, pr = fresnel_singlet(TOptic).build(device="cpu")
        finally:
            config.set_precision("float64")
        Px = torch.cat([torch.linspace(-1e-3, 1e-3, 201),
                        torch.linspace(-1.0, 1.0, 201)]).to(pr.cv.dtype)
        zero = torch.zeros_like(Px)
        cv = pr.cv.clone().requires_grad_(True)
        h = ttrace(st, pr.replace(cv=cv), zero, zero, Px, zero, 0.55,
                   polarization=TPS.unpolarized())
        h.intensity[-1].mean().backward()
        assert torch.isfinite(cv.grad).all(), prec
        grads[prec] = cv.grad
    close(grads["float32"].double(), grads["float64"], 1e-3, "d / d cv")
