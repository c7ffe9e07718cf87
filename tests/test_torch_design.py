"""The design loop of the PyTorch port against the JAX package, float64 on
the CPU: `environment/` (the four air models, `nair_zemax`,
`relative_wavelength`, the Schott thermal correction), `utils/checkpoint`,
and `optimization/` (variables, the 51 operands, the problem's merit,
gradient and residual Jacobian, the torch.optim Adam and SGD loops against
the optax ones, the scipy adapters, GlassExpert), with the flat-face
curvature cotangent that both packages keep from the reference.

The JAX oracle is computed once (`jax_ref`). Its operands run eagerly (a
jit of the 51 operands costs ~40 s of tracing, most of it the Seidel
terms' paraxial set-up, which the fixture memoizes per system); the
problems' `_compile()` products are lowered once and compiled at XLA's
backend optimization level 0 in threads while the eager work runs. The
systems are the Cooke triplet at 2-3 rings, the asphere singlet of
`tests/test_fused_kernel.py` tilted and decentred, its conic twin and the
singlet of `test_scipy_optimizer_converges_singlet`."""

import math
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import contextmanager
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu import environment as jenv
from optiland_tpu import optimization as jopt
from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.optimization import glass_expert as jge
from optiland_tpu.optimization import operands as jops
from optiland_tpu.optimization import problem as jproblem
from optiland_tpu.optimization import variables as jvars
from optiland_tpu.system import aberrations as jab
from optiland_tpu.system.optic import Optic as JOptic
from optiland_tpu_torch import environment as tenv
from optiland_tpu_torch import optimization as topt
from optiland_tpu_torch.materials import catalog as tcat
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.optimization import glass_expert as tge
from optiland_tpu_torch.optimization import operands as tops
from optiland_tpu_torch.optimization import problem as tproblem
from optiland_tpu_torch.optimization import variables as tvars
from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.utils import checkpoint as tckpt

from torch_port_helpers import jax_f64, singlet_lens

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-10
GRAD_ATOL = 1e-9   # of each row's largest entry
LEVEL0 = {"xla_backend_optimization_level": 0}

# -- systems -------------------------------------------------------------


def cooke(Optic):
    return JCooke() if Optic is JOptic else TCooke()


def tilted_singlet(Optic):
    return singlet_lens(Optic, tilt=True, decenter=True)


def conic_singlet(Optic):
    return singlet_lens(Optic, asphere=False)


def scipy_singlet(Optic):
    """The singlet of tests/test_optimization.py
    (`test_scipy_optimizer_converges_singlet`)."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=60.0, thickness=5.0, material=1.52,
                     is_stop=True)
    lens.add_surface(index=2, radius=-60.0, thickness=55.0)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def glass_singlet(Optic):
    """An N-BK7 singlet at the F, d and C lines, for the glass search."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=5.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-50.0, thickness=47.0)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    for w in (0.4861, 0.5876, 0.6563):
        lens.add_wavelength(w, is_primary=w == 0.5876)
    return lens


def bk7_plate(Optic, radius=math.inf):
    """ROADMAP queue 3's probe: an N-BK7 plate, 10 mm thick, the stop at
    its flat front face (or a sphere of `radius`), EPD 10, angle fields 0,
    5 and 10 degrees, 0.55 um, the image plane 20 mm behind it."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=radius, thickness=10.0,
                     material="N-BK7", is_stop=True)
    lens.add_surface(index=2, radius=math.inf, thickness=20.0)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    for y in (0.0, 5.0, 10.0):
        lens.add_field(y=y)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def port_optic(make):
    """The port's lens, built on the CPU (its entry points then run there)."""
    lens = make(TOptic)
    lens.build(device="cpu")
    return lens


# -- operand inputs ------------------------------------------------------

_RAY = dict(surface_number=-1, Hx=0.2, Hy=1.0, Px=0.3, Py=0.5,
            wavelength=0.55)
_PER_SURFACE = ("TSC", "SC", "CC", "TCC", "TAC", "AC", "TPC", "PC", "DC",
                "TAchC", "LchC", "TchC")


def operand_inputs(name):
    if name == "seidel":
        return dict(seidel_number=3)
    if name in _PER_SURFACE:   # an index into the (S - 2,) interior terms
        return dict(surface_number=1)
    if name.startswith("real_"):
        return _RAY
    if name == "rms_spot_size":
        return dict(surface_number=-1, Hx=0.0, Hy=0.7, num_rays=3,
                    wavelength=0.55)
    if name == "OPD_difference":
        return dict(Hx=0.0, Hy=0.7, num_rays=3, wavelength=0.55)
    if name == "AOI":
        return dict(surface_number=2, Hx=0.0, Hy=1.0, Px=0.0, Py=0.7,
                    wavelength=0.55)
    if name == "clearance":
        return dict(line_ray=(0.0, 1.0, 0.0, 1.0),
                    point_ray=(0.0, 1.0, 0.0, -1.0), wavelength=0.55)
    if name == "edge_thickness":
        return dict(surface_number=1, semi_apertures=(5.0, 4.8))
    return {}


def gradient_problem(pkg, lens):
    """The merit whose value, gradient and residual Jacobian are held: an
    equality on f2, the RMS spot at 19 rays, a chief-ray height, total
    track over its maximum, the summed Seidel spherical under its minimum
    and EPD at the edge of its band; four variables."""
    p = pkg.OptimizationProblem(lens)
    p.add_operand(operand_type="f2", target=95.0, weight=1.0)
    p.add_operand(operand_type="rms_spot_size", target=0.0, weight=2.0,
                  input_data=dict(surface_number=-1, Hx=0.0, Hy=0.7,
                                  num_rays=2, wavelength=0.55))
    p.add_operand(operand_type="real_y_intercept", target=0.5, weight=0.5,
                  input_data=dict(surface_number=-1, Hx=0.0, Hy=1.0, Px=0.0,
                                  Py=0.5, wavelength=0.55))
    p.add_operand(operand_type="total_track", max_val=50.0, weight=0.3)
    p.add_operand(operand_type="SC_sum", min_val=0.0, weight=3.0)
    p.add_operand(operand_type="EPD", min_val=9.0, max_val=11.0)
    p.add_variable(lens, "radius", surface_number=1)
    p.add_variable(lens, "radius", surface_number=2)
    p.add_variable(lens, "thickness", surface_number=1)
    p.add_variable(lens, "conic", surface_number=1)
    return p


def spot_problem(pkg, lens):
    """RMS spot (7 rays) and f2 over both radii: the Adam/SGD merit."""
    p = pkg.OptimizationProblem(lens)
    p.add_operand(operand_type="rms_spot_size", target=0.0, weight=1.0,
                  input_data=dict(surface_number=-1, Hx=0.0, Hy=1.0,
                                  num_rays=1, wavelength=0.55))
    p.add_operand(operand_type="f2", target=90.0, weight=0.1)
    p.add_variable(lens, "radius", surface_number=1)
    p.add_variable(lens, "radius", surface_number=2, min_val=-49.9,
                   max_val=-40.0)
    return p


def f2_problem(pkg, lens):
    """tests/test_optimization.py's singlet design: f2 to 75 mm."""
    p = pkg.OptimizationProblem(lens)
    p.add_operand(operand_type="f2", target=75.0, weight=1)
    p.add_variable(lens, "radius", surface_number=1)
    p.add_variable(lens, "radius", surface_number=2)
    return p


def flat_problem(pkg, lens):
    """The plate's merit: the RMS spot over the three fields, 32 rays each
    on the pupil's y line (96 rays); x = 10 cv of the front face."""
    p = pkg.OptimizationProblem(lens)
    for hy in (0.0, 0.5, 1.0):
        p.add_operand(operand_type="rms_spot_size", target=0.0,
                      input_data=dict(surface_number=-1, Hx=0.0, Hy=hy,
                                      num_rays=32, wavelength=0.55,
                                      distribution="line_y"))
    p.add_variable(lens, "reciprocal_radius", surface_number=1)
    return p


GLASSES = ["N-BK7", "F2", "N-SF5", "LAK9"]
GLASS_MAP = ["N-BK7", "F2", "N-SF5", "LAK9", "SF11", "SK16", "BAF10", "F4"]


def glass_problem(pkg, lens):
    p = pkg.OptimizationProblem(lens)
    p.add_operand(operand_type="f2", target=50.0, weight=1.0)
    p.add_operand(operand_type="LchC_sum", target=0.0, weight=10.0)
    return p


def scipy_run(pkg, which):
    lens = scipy_singlet(JOptic if pkg is jopt else TOptic)
    if pkg is topt:
        lens.build(device="cpu")
    p = f2_problem(pkg, lens)
    if which == "generic":
        res = pkg.OptimizerGeneric(p).optimize(maxiter=200, tol=1e-12)
    elif which == "least_squares":
        res = pkg.LeastSquares(p).optimize(maxiter=100)
    else:
        res = pkg.OrthogonalDescent(p).optimize(max_iter=10)
    return np.asarray(res.x, float), float(lens.paraxial.f2())


@contextmanager
def memo_precalc():
    """JAX's Seidel set-up (`aberrations._precalc`) memoized per (static,
    params) while the operands run eagerly: every aberration operand
    recomputes it, the values are the same."""
    original = jab._precalc
    cache = {}

    def cached(static, params):
        key = (id(static), id(params))
        if key not in cache:
            cache[key] = (static, params, original(static, params))
        return cache[key][2]

    jab._precalc = cached
    try:
        yield
    finally:
        jab._precalc = original


SYSTEMS = {"cooke": cooke, "tilted singlet": tilted_singlet}


def jax_values(label):
    """JAX's value of every operand of the registry on system `label` (run
    in a process of its own, beside the rest of the oracle)."""
    with jax_f64(), memo_precalc():
        js, jp = SYSTEMS[label](JOptic).build()
        return {n: float(fn(js, jp, **operand_inputs(n)))
                for n, fn in jops.REGISTRY.items()}


def jax_glass_expert():
    """JAX's GlassExpert on the glass singlet, eagerly: (the glass chosen,
    the final merit)."""
    lens = glass_singlet(JOptic)
    p = glass_problem(jopt, lens)
    with jax.disable_jit(), memo_precalc():
        jopt.GlassExpert(p, glass_surfaces=[1], glass_selection=GLASSES,
                         num_neighbours=1, pool_size=4,
                         verbose=False).optimize(disp=False)
        return lens.surfaces.specs[1].material.name, float(p.sum_squared())


@pytest.fixture(scope="module")
def jax_ref():
    """Everything the JAX package computes for this file, float64: the
    operand values of each system in a spawned process, the problems'
    programs compiled in threads, the optimizers and the glass search here
    meanwhile."""
    with ProcessPoolExecutor(len(SYSTEMS),
                             mp_context=get_context("spawn")) as procs, \
            jax_f64():
        values = {label: procs.submit(jax_values, label)
                  for label in SYSTEMS}
        jobs = {}
        for key, make, problem in (("grad", conic_singlet, gradient_problem),
                                   ("flat", bk7_plate, flat_problem)):
            p = problem(jopt, make(JOptic))
            c = p._compile()
            args = (p.x0(), p.optic.params)
            names = (("value_and_grad", "residual_jac") if key == "grad"
                     else ("value_and_grad",))
            for n in names:
                jobs[key, n] = (c[n].lower(*args), args)
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {k: pool.submit(lo.compile, compiler_options=LEVEL0)
                       for k, (lo, _) in jobs.items()}
            ref = {}
            for name in ("adam", "sgd"):
                lens = conic_singlet(JOptic)
                opt = (jopt.AdamOptimizer(spot_problem(jopt, lens), lr=1e-2)
                       if name == "adam" else
                       jopt.SGDOptimizer(spot_problem(jopt, lens), lr=1e-3,
                                         momentum=0.9))
                res = opt.optimize(n_steps=6)
                ref[name] = (np.asarray(res.loss_history),
                             np.asarray(res.x))
            for which in ("generic", "least_squares", "orthogonal"):
                ref["scipy", which] = scipy_run(jopt, which)
            ref["glass"] = jax_glass_expert()
            nd_vd = {g: jge.get_nd_vd(g) for g in GLASS_MAP}
            ref["nd_vd"] = nd_vd
            ref["downsampled"] = jge.downsample_glass_map(nd_vd, 4)
            for k, f in futures.items():
                ref[k] = jax.tree_util.tree_map(
                    np.asarray, f.result()(*jobs[k][1]))
        ref["values"] = {k: v.result() for k, v in values.items()}
    return ref


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# -- environment ---------------------------------------------------------

WAVELENGTHS = np.linspace(0.35, 2.5, 16)
CONDITIONS = ({}, dict(pressure=90000.0, temperature=30.0,
                       relative_humidity=0.6, co2_ppm=450.0),
              dict(pressure=101325.0, temperature=-10.0,
                   relative_humidity=0.3))


def _env_call(pkg, name, w, cond):
    c = pkg.EnvironmentalConditions(**cond)
    if name in ("ciddor", "edlen", "birch_downs", "kohlrausch"):
        return pkg.refractive_index_air(w, c, model=name)
    if name == "nair_zemax":
        return pkg.nair_zemax(w, c.temperature, c.pressure / 101325.0)
    if name == "relative_wavelength":
        return pkg.relative_wavelength(w, c.temperature,
                                       c.pressure / 101325.0)
    m = tcat.resolve_material("N-BK7")
    n_rel = 1.5 + 0.01 / w**2
    return pkg.schott_thermal_correction(n_rel, w, m.therm, m.t0,
                                         c.temperature, c.pressure / 101325.0)


@pytest.mark.parametrize("name", ["ciddor", "edlen", "birch_downs",
                                  "kohlrausch", "nair_zemax",
                                  "relative_wavelength", "schott_thermal"])
def test_environment_matches_jax(name):
    """Each air model, the air index of the thermal path, the relative
    wavelength and the Schott correction, at 16 wavelengths (0.35-2.5 um)
    and three conditions (the last below 0 degrees C, Ciddor's other vapor
    branch), at rtol 1e-12."""
    with jax_f64():
        for cond in CONDITIONS:
            ref = np.asarray(_env_call(jenv, name, jnp.asarray(WAVELENGTHS),
                                       cond))
            got = _env_call(tenv, name, torch.as_tensor(WAVELENGTHS), cond)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(_np(got), ref, rtol=1e-12, atol=0,
                                       err_msg=f"{name} {cond}")


def test_environment_tensor_temperatures_and_refusal():
    """Ciddor's vapor pressure over a tensor of temperatures takes each
    its branch (`torch.where`, as JAX's `jnp.where`); an unknown model is
    refused by name."""
    temps = np.array([-20.0, -0.5, 0.0, 15.0, 40.0])
    with jax_f64():
        ref = np.asarray(jenv._ciddor_svp(jnp.asarray(temps)))
    got = tenv._ciddor_svp(torch.as_tensor(temps))
    np.testing.assert_allclose(_np(got), ref, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="ciddor"):
        tenv.refractive_index_air(0.55, tenv.EnvironmentalConditions(),
                                  model="nope")


# -- checkpoint ----------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    """Tensors, numpy arrays, numbers and nested lists come back as they
    were saved (weights_only loading); the newest step wins; a generator's
    state restores its stream."""
    assert tckpt.restore_checkpoint(str(tmp_path / "none")) is None
    state = {"step": 3, "x": torch.tensor([1.0, 2.0], dtype=torch.float64),
             "losses": np.array([0.5, 0.25]),
             "parts": [np.arange(3), np.zeros((2, 0))],
             "opt": {"lr": 1e-2, "betas": (0.9, 0.999)}}
    tckpt.save_checkpoint(str(tmp_path), 3, state)
    path = tckpt.save_checkpoint(str(tmp_path), 12, dict(state, step=12))
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert tckpt.checkpoint_step(path) == 12
    got = tckpt.restore_checkpoint(str(tmp_path))
    assert got["step"] == 12 and torch.equal(got["x"], state["x"])
    assert isinstance(got["losses"], np.ndarray)
    np.testing.assert_array_equal(got["losses"], state["losses"])
    assert [a.shape for a in got["parts"]] == [(3,), (2, 0)]
    assert got["opt"] == state["opt"]
    assert tckpt.restore_checkpoint(str(tmp_path / "step_00000003"))[
        "step"] == 3
    g = torch.Generator().manual_seed(7)
    saved = tckpt.prng_to_state(g)
    a = torch.rand(4, generator=g)
    b = torch.rand(4, generator=tckpt.state_to_prng(saved))
    assert torch.equal(a, b)


# -- variables -----------------------------------------------------------

VARIABLE_KINDS = [("radius", 1, 0), ("reciprocal_radius", 2, 0),
                  ("conic", 1, 0), ("thickness", 2, 0), ("index", 1, 0),
                  ("asphere_coeff", 1, 1), ("decenter_x", 1, 0),
                  ("decenter_y", 1, 0), ("tilt_x", 1, 0), ("tilt_y", 1, 0),
                  ("tilt_z", 1, 0), ("focal_length", 1, 0),
                  ("geom_coeff", 1, 0), ("norm_radius", 1, 0),
                  ("norm_y", 1, 0)]


@pytest.mark.parametrize("kind,surface,coeff", VARIABLE_KINDS,
                         ids=[k[0] for k in VARIABLE_KINDS])
def test_variable_get_set_scale_match_jax(kind, surface, coeff):
    """`Variable.get`, its scaler and `set` (through `apply_all`) on the
    tilted asphere singlet against JAX's: values at 1e-14, every table of
    the new params equal, the optic's cached tensors untouched."""
    with jax_f64():
        _, jp = tilted_singlet(JOptic).build()
        jv = jvars.Variable(kind, surface, coeff)
        jx = jvars.initial_values([jv], jp)
        jnew = jvars.apply_all([jv], jp, jx * 0.9 + 0.01)
    lens = port_optic(tilted_singlet)
    tp = lens.params
    before = {f: getattr(tp, f).clone() for f in ("cv", "coeffs", "tilt",
                                                  "thickness", "mat_coeffs")}
    tv = tvars.Variable(kind, surface, coeff)
    tx = tvars.initial_values([tv], tp)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=1e-14)
    tnew = tvars.apply_all([tv], tp, tx * 0.9 + 0.01)
    for f in ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
              "mat_coeffs", "focal_length"):
        np.testing.assert_allclose(_np(getattr(tnew, f)),
                                   np.asarray(getattr(jnew, f)), rtol=1e-14,
                                   atol=1e-300, err_msg=f"{kind} {f}")
    assert lens.params is tp
    for f, v in before.items():
        assert torch.equal(getattr(tp, f), v), f


def test_variable_set_carries_the_gradient():
    """`set` is out of place and differentiable: the gradient of a sum of
    the new table reaches the value written and not the overwritten
    entry."""
    tp = port_optic(tilted_singlet).params
    v = torch.tensor(0.02, dtype=torch.float64, requires_grad=True)
    new = tvars.Variable("reciprocal_radius", 1).set(tp, v)
    (new.cv * torch.arange(1.0, 5.0, dtype=torch.float64)).sum().backward()
    assert v.grad.item() == 2.0 and not tp.cv.requires_grad


# -- operands ------------------------------------------------------------


@pytest.mark.parametrize("system", ["cooke", "tilted singlet"])
def test_operand_values_match_jax(system, jax_ref):
    """Every name of the registry (51) on the Cooke triplet and the tilted,
    decentred asphere singlet against the JAX operand, rtol 1e-10."""
    assert len(tops.REGISTRY) == 51 and set(tops.REGISTRY) == set(
        jops.REGISTRY)
    lens = port_optic(SYSTEMS[system])
    ts, tp = lens.build(device="cpu")
    ref = jax_ref["values"][system]
    for name, fn in tops.REGISTRY.items():
        got = fn(ts, tp, **operand_inputs(name))
        assert got.shape == () and got.dtype == torch.float64, name
        np.testing.assert_allclose(got.item(), ref[name], rtol=RTOL,
                                   atol=1e-13, err_msg=name)


def test_register_operand():
    def twice_f2(static, params):
        return 2.0 * tops.f2(static, params)

    tops.register("twice_f2_test", twice_f2)
    try:
        with pytest.raises(ValueError, match="already"):
            tops.register("twice_f2_test", twice_f2)
        lens = port_optic(scipy_singlet)
        p = topt.OptimizationProblem(lens)
        p.add_operand("twice_f2_test", target=0.0)
        np.testing.assert_allclose(
            p.operand_values().item(), 2.0 * lens.paraxial.f2().item(),
            rtol=1e-15)
    finally:
        del tops.REGISTRY["twice_f2_test"]
    with pytest.raises(ValueError, match="Unknown operand"):
        topt.OptimizationProblem(None).add_operand("nope")


# -- the problem ---------------------------------------------------------


def test_merit_gradient_and_jacobian_match_jax(jax_ref):
    """value_and_grad and residual_jac on the conic singlet (every kind of
    delta: targets, a violated maximum and minimum, a band edge) against
    JAX's `_compile()` products: the merit at rtol 1e-10, the gradient and
    each Jacobian row within 1e-9 of their largest entry; fun_array, the
    residuals and rss agree with them."""
    lens = port_optic(conic_singlet)
    p = gradient_problem(topt, lens)
    c = p._compile()
    x0 = p.x0()
    v, g = c["value_and_grad"](x0, lens.params)
    jv, jg = jax_ref["grad", "value_and_grad"]
    np.testing.assert_allclose(v.item(), jv, rtol=RTOL)
    np.testing.assert_allclose(_np(g) / np.abs(jg).max(),
                               jg / np.abs(jg).max(), rtol=0, atol=GRAD_ATOL)
    J = _np(c["residual_jac"](x0, lens.params))
    jJ = jax_ref["grad", "residual_jac"]
    assert J.shape == jJ.shape == (6, 4)
    for i in range(6):
        scale = max(np.abs(jJ[i]).max(), 1e-300)
        np.testing.assert_allclose(J[i] / scale, jJ[i] / scale, rtol=0,
                                   atol=GRAD_ATOL, err_msg=f"row {i}")
    np.testing.assert_allclose(
        _np(p.residual_vector()),
        _np(c["residuals"](x0, lens.params)), rtol=0)
    np.testing.assert_allclose(p.rss().item() ** 2, v.item(), rtol=1e-14)
    np.testing.assert_allclose(p.fun_array().sum().item(), v.item(),
                               rtol=1e-14)


def test_delta_fn_band_edge_gradient():
    """On the edge of an inequality band the derivative of the delta is
    0.5, as JAX's `jnp.maximum` gives (torch.clamp would give 1, relu 0)."""
    for kw, edge, slope in ((dict(max_val=2.0), 2.0, 0.5),
                            (dict(min_val=-1.0), -1.0, -0.5)):
        v = torch.tensor(edge, dtype=torch.float64, requires_grad=True)
        tproblem.OperandSpec("f2", **kw).delta_fn(v).backward()
        ref = jax.grad(jproblem.OperandSpec("f2", **kw).delta_fn)(
            jnp.asarray(edge, jnp.float64))
        assert v.grad.item() == float(ref) == slope


def test_value_and_grad_leaves_the_optic_unchanged():
    """A merit gradient and `apply_all` leave the optic's cached build as it
    was: the same tensors, equal values, none requiring grad."""
    lens = port_optic(conic_singlet)
    static, params = lens.build(device="cpu")
    saved = {k: v.clone() for k, v in vars(params).items()
             if torch.is_tensor(v)}
    p = gradient_problem(topt, lens)
    c = p._compile()
    c["value_and_grad"](p.x0() * 1.01, lens.params)
    tvars.apply_all(p.variables, lens.params, p.x0() + 0.1)
    assert lens.build(device="cpu")[1] is params
    for k, v in saved.items():
        t = getattr(params, k)
        assert torch.equal(t, v) and not t.requires_grad, k


# -- optimizers ----------------------------------------------------------


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_torch_optimizers_match_optax(name, jax_ref):
    """6 steps of torch.optim.Adam (lr 1e-2) and SGD (lr 1e-3, momentum
    0.9) on the spot merit against JAX's optax loops (`AdamOptimizer`,
    `SGDOptimizer`), one bound active: losses and x within 1e-10."""
    lens = port_optic(conic_singlet)
    p = spot_problem(topt, lens)
    opt = (topt.AdamOptimizer(p, lr=1e-2) if name == "adam" else
           topt.SGDOptimizer(p, lr=1e-3, momentum=0.9))
    metrics = []
    res = opt.optimize(n_steps=6, metrics=metrics)
    losses, x = jax_ref[name]
    np.testing.assert_allclose(res.loss_history, losses, rtol=1e-10)
    np.testing.assert_allclose(res.x, x, rtol=1e-10)
    assert res.success and [m["step"] for m in metrics] == list(range(6))
    np.testing.assert_allclose(_np(p.x0()), x, rtol=1e-14)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_torch_optimizer_resume_equals_straight_run(name, tmp_path):
    """3 steps checkpointed, then a resumed run to 6, equal 6 steps
    straight: x, the losses and the optimizer state come back."""
    def run(n_steps, **kw):
        lens = port_optic(conic_singlet)
        p = spot_problem(topt, lens)
        cls = topt.AdamOptimizer if name == "adam" else topt.SGDOptimizer
        return cls(p, lr=1e-2 if name == "adam" else 1e-3).optimize(
            n_steps=n_steps, **kw)

    straight = run(6)
    run(3, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(str(tmp_path))) == 3
    resumed = run(6, checkpoint_dir=str(tmp_path), resume=True)
    assert resumed.loss_history == straight.loss_history
    np.testing.assert_array_equal(resumed.x, straight.x)


@pytest.mark.parametrize("which", ["generic", "least_squares",
                                   "orthogonal"])
def test_scipy_optimizers_match_jax(which, jax_ref):
    """OptimizerGeneric, LeastSquares and OrthogonalDescent on the f2 design
    of tests/test_optimization.py: the same solution within 1e-8, f2 at
    75 mm."""
    x, f2 = scipy_run(topt, which)
    jx, jf2 = jax_ref["scipy", which]
    np.testing.assert_allclose(x, jx, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(f2, jf2, rtol=1e-8)
    if which != "orthogonal":
        assert abs(f2 - 75.0) < 1e-3


def test_optimizer_undo_and_global_bounds():
    lens = port_optic(scipy_singlet)
    p = f2_problem(topt, lens)
    opt = topt.OptimizerGeneric(p)
    r0 = float(p.variables[0].get(lens.params))
    opt.optimize(maxiter=5)
    assert float(p.variables[0].get(lens.params)) != r0
    opt.undo()
    assert float(p.variables[0].get(lens.params)) == pytest.approx(
        r0, rel=1e-15)
    with pytest.raises(ValueError, match="finite"):
        topt.DualAnnealing(p).optimize(maxiter=1)


# -- GlassExpert ---------------------------------------------------------


def test_glass_map_matches_jax(jax_ref):
    """(n_d, V_d) of eight catalog glasses at 1e-13 and their k-means
    downsampling to four: the same glasses."""
    nd_vd = {g: tge.get_nd_vd(g) for g in GLASS_MAP}
    for g, (nd, vd) in nd_vd.items():
        np.testing.assert_allclose((nd, vd), jax_ref["nd_vd"][g],
                                   rtol=1e-13, err_msg=g)
    assert set(tge.downsample_glass_map(nd_vd, 4)) == set(
        jax_ref["downsampled"])


def test_glass_expert_matches_jax(jax_ref):
    """GlassExpert on a pool of 4 glasses (the front glass of the glass
    singlet, f2 and the summed longitudinal colour): the same glass as
    JAX's, the same final merit."""
    lens = port_optic(glass_singlet)
    p = glass_problem(topt, lens)
    topt.GlassExpert(p, glass_surfaces=[1], glass_selection=GLASSES,
                     num_neighbours=1, pool_size=4,
                     verbose=False).optimize(disp=False)
    glass, merit = jax_ref["glass"]
    assert lens.surfaces.specs[1].material.name == glass
    np.testing.assert_allclose(p.sum_squared().item(), merit, rtol=1e-10)


def test_glass_expert_with_variables_keeps_or_improves():
    lens = port_optic(glass_singlet)
    p = glass_problem(topt, lens)
    p.add_variable(lens, "radius", surface_number=1)
    p.add_variable(lens, "radius", surface_number=2)
    before = p.sum_squared().item()
    topt.GlassExpert(p, glass_surfaces=[1], glass_selection=GLASSES[:3],
                     pool_size=3, num_neighbours=1,
                     verbose=False).optimize(maxiter=20, disp=False)
    after = p.sum_squared().item()
    assert math.isfinite(after) and after <= before * 1.001


# -- the flat-face cotangent (ROADMAP queue 3) ----------------------------


def test_flat_face_curvature_cotangent(jax_ref):
    """d merit / d x of a `reciprocal_radius` on the plate's flat front
    face: the port's eager gradient equals JAX's within 1e-8, and both
    differ from the central difference of the same forward (the flat
    surface's normal stays (0, 0, 1) whatever its cv), which in turn
    differs from the difference of rebuilt spheres, R = +-1e6 (the true
    derivative): ROADMAP queue 3's table, recorded."""
    lens = port_optic(bk7_plate)
    p = flat_problem(topt, lens)
    c = p._compile()
    x0 = p.x0()
    _, g = c["value_and_grad"](x0, lens.params)
    jg = jax_ref["flat", "value_and_grad"][1]
    np.testing.assert_allclose(_np(g), jg, rtol=1e-8, atol=1e-12)
    assert x0.item() == 0.0
    h = 1e-5   # in x = 10 cv: cv +-1e-6, radii -+1e6
    fd = ((c["sum_squared"](x0 + h, lens.params)
           - c["sum_squared"](x0 - h, lens.params)) / (2 * h)).item()
    merits = []
    for radius in (1e6, -1e6):
        sphere = port_optic(lambda O: bk7_plate(O, radius=radius))
        merits.append(flat_problem(topt, sphere).sum_squared().item())
    fd_sphere = (merits[0] - merits[1]) / (2 * h)
    g = g.item()
    assert abs(g - fd) > 0.5 * max(abs(g), abs(fd)), (g, fd)
    assert abs(fd_sphere - fd) > 0.5 * max(abs(fd_sphere), abs(fd)), (
        fd_sphere, fd)
    assert abs(fd_sphere - g) > 0.5 * max(abs(fd_sphere), abs(g)), (
        fd_sphere, g)


# -- the package boundary ------------------------------------------------


def test_design_loop_imports_no_jax():
    code = ("import sys, optiland_tpu_torch.environment, "
            "optiland_tpu_torch.optimization, "
            "optiland_tpu_torch.tolerancing, optiland_tpu_torch.utils\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'orbax', 'optiland_tpu')]\n"
            "assert not bad, bad\n"
            "from optiland_tpu_torch import optimization, tolerancing\n"
            "print(len(optimization.__all__), len(tolerancing.__all__))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["13", "7"]
    assert topt.__all__ == jopt.__all__
