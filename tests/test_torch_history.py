"""The flagship path of the PyTorch port against the JAX package, float64 on
the CPU: the Cooke triplet (`models/objectives.py`) traced by
`trace_system` at per-ray wavelengths through glasses that absorb.

Held here: the glass catalog's rows and coefficients; the built Cooke
triplet's tables (extinction tables included); the eager `trace_rays`
with Beer-Lambert absorption; `_history_plain`, the plain version of K7,
against the JAX kernel body (`_tile_trace(..., record=True,
for_grad=False)` on whole arrays, never Pallas interpret mode); gradients
through the K7 seam `_FusedHistory` against autograd of `trace_rays`, for
the parameters and the starting rays; the flagship merit of
`__graft_entry__.entry` and its gradients against `jax.grad`; and
`Optic.trace`. Values at rtol 1e-10 (the same float64 arithmetic; room for
reordered sums over the surfaces' per-ray formulas), gradients at 1e-9 of
each leaf's largest entry."""

from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from optiland_tpu.core import distributions as jdist
from optiland_tpu.materials import catalog as jcat
from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.trace import fused as jfused
from optiland_tpu.trace import raygen as jraygen
from optiland_tpu_torch.core import distributions as tdist
from optiland_tpu_torch.core.rays import Rays as TRays
from optiland_tpu_torch.materials import catalog as tcat
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.trace import fused as tfused
from optiland_tpu_torch.trace import raygen as traygen
from optiland_tpu_torch.trace import tracer as ttracer

from torch_port_helpers import carry_across, jax_build_f64, jax_f64

RTOL = 1e-10
GRAD_ATOL = 1e-9   # of each leaf's largest entry
N_RAYS = 72  # `_make_inputs(..., rays_per_field=8)`: 3 fields x 3 wavelengths


@pytest.mark.parametrize("spec", ["SK16", ("F2", "schott"), "N-BK7",
                                  "F5|schott"], ids=str)
def test_catalog_rows_match_jax(spec):
    a, b = tcat.resolve_material(spec), jcat.resolve_material(spec)
    assert (a.formula, a.coefficients, a.name, a.k_table, a.therm, a.t0) == (
        b.formula, b.coefficients, b.name, b.k_table, b.therm, b.t0)
    name, ref = spec if isinstance(spec, tuple) else (
        spec.split("|") + [None])[:2]
    assert tcat.find_material(name, ref) == jcat.find_material(name, ref)


def test_catalog_names_match_jax():
    names = tcat.catalog_names()
    assert names == jcat.catalog_names() and "SK16" in names


def test_unknown_glass_raises_key_error():
    with pytest.raises(KeyError, match="No matches"):
        tcat.resolve_material("no-such-glass-xyz")
    with pytest.raises(KeyError, match="No matches"):
        jcat.resolve_material("no-such-glass-xyz")


@pytest.fixture(scope="module")
def cooke():
    """The Cooke triplet in both packages; the port's own build must equal
    the JAX tables carried across, extinction tables included."""
    js, jp = jax_build_f64(JCooke())
    ts_own, tp_own = TCooke().build(device="cpu")
    ts, tp = carry_across(js, jp)
    return js, jp, ts, tp, ts_own, tp_own


def test_cooke_triplet_tables_match_jax(cooke):
    js, jp, ts, tp, ts_own, tp_own = cooke
    assert ts_own == ts
    assert ts.has_absorption == (False, True, False, True, False, True,
                                 False, False)
    assert ts.mat_formulas == (0, 3, 0, 2, 0, 3, 0, 0)
    assert tp.k_wl.shape == (8, 22)
    for f in fields(tp_own):
        a, b = getattr(tp_own, f.name), getattr(tp, f.name)
        if f.name in ("phase_grids", "phase_mat_coeffs"):
            continue  # tables of surface types the port does not build yet
        assert torch.equal(a, b), f.name
    assert tfused.supports_fused(ts) and tfused.supports_fused_raygen(ts)


@pytest.fixture(scope="module")
def flagship(cooke):
    """`__graft_entry__.entry`'s merit, its history and `jax.grad` on
    `_make_inputs(..., rays_per_field=8)` (72 rays over the three fields
    and three wavelengths), and the starting rays of both packages. One
    eager JAX gradient (an XLA compile of it costs more), and every JAX
    call at the same ray count, so the primitives compile once."""
    js, jp, ts, tp, _, _ = cooke
    batch = graft._make_inputs(js, jp, rays_per_field=8)
    fn, _ = graft.entry()
    with jax_f64():
        (loss, hist), grad = jax.value_and_grad(
            lambda p: fn(p, *(jnp.asarray(a) for a in batch)),
            has_aux=True)(jp)
        jr = jraygen.generate_rays(js, jp, *(jnp.asarray(a) for a in batch))
    tb = tuple(torch.tensor(np.asarray(a, np.float64)) for a in batch)
    tr = traygen.generate_rays(ts, tp, *tb)
    return dict(batch=tb, loss=float(loss), hist=hist, grad=grad, jr=jr,
                tr=tr, th=ttracer.trace_rays(ts, tp, tr))


def test_trace_rays_with_absorption_matches_jax(flagship):
    jh, th = flagship["hist"], flagship["th"]
    for name in ("x", "y", "z", "L", "M", "N", "intensity", "opd"):
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(getattr(jh, name)), rtol=RTOL,
                                   atol=1e-12, err_msg=name)
    i_final = th.intensity[-1].numpy()
    assert 0.99 < i_final.min() and i_final.max() < 1.0  # the glasses absorb


def test_history_plain_matches_jax_kernel_body(cooke, flagship):
    js, jp, ts, tp, _, _ = cooke
    jr, tr = flagship["jr"], flagship["tr"]
    recs = jfused._tile_trace(
        js, False, jfused._diff_params(jp), jfused._nondiff_params(jp),
        *(getattr(jr, k) for k in ("x", "y", "z", "L", "M", "N", "i", "opd")),
        jr.w, record=True, for_grad=False)
    ref = [np.stack([np.asarray(r[j]) for r in recs]) for j in range(8)]
    rays9 = tuple(getattr(tr, k).contiguous() for k in tfused._RAY_KEYS)
    got = tfused._history_plain(ts, tfused._diff_params(tp),
                                tfused._nondiff_params(tp), rays9)
    for j, name in enumerate(tfused._NAMES):
        assert got[j].shape == (ts.num_surfaces, N_RAYS)
        assert got[j].dtype == torch.float64
        np.testing.assert_allclose(got[j].numpy(), ref[j], rtol=RTOL,
                                   atol=1e-12, err_msg=name)


def _close_grads(got, ref, label):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all(), label
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                               atol=GRAD_ATOL, err_msg=label)


def test_fused_history_gradients_match_trace_rays(cooke, flagship):
    """Cotangents through the K7 seam (CPU tensors: `_history_plain`
    forward, eager-twin backward) against autograd of `trace_rays`, for
    every table the twin reads and for the 9 starting ray arrays. Seeds on
    four of the 8 outputs; the rest are unseeded (zero seeds)."""
    _, _, ts, tp, _, _ = cooke
    diffp = [t.clone().requires_grad_(True)
             for t in tfused._diff_params(tp)]
    nondiffp = [t.clone().requires_grad_(True)
                for t in tfused._nondiff_params(tp)]
    rays9 = [getattr(flagship["tr"], k).detach().clone().requires_grad_(True)
             for k in tfused._RAY_KEYS]
    rng = np.random.default_rng(9)
    seeds = {k: torch.tensor(rng.normal(size=(ts.num_surfaces, N_RAYS)))
             for k in (0, 1, 6, 7)}
    outs = tfused.fused_history(ts, (diffp, nondiffp), rays9)
    loss = sum((outs[k] * s).sum() for k, s in seeds.items())
    wrt = diffp + nondiffp + rays9
    g_fused = torch.autograd.grad(loss, wrt, allow_unused=True)

    names = ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
             "mat_coeffs", "k_wl", "k_val")
    leaves = {k: getattr(tp, k).clone().requires_grad_(True) for k in names}
    rays_ref = [r.detach().clone().requires_grad_(True) for r in rays9]
    h = ttracer.trace_rays(ts, tp.replace(**leaves), TRays(*rays_ref))
    hist = (h.x, h.y, h.z, h.L, h.M, h.N, h.intensity, h.opd)
    loss_ref = sum((hist[k] * s).sum() for k, s in seeds.items())
    g_ref = torch.autograd.grad(loss_ref, list(leaves.values()) + rays_ref,
                                allow_unused=True)
    by_name = dict(zip(("cv", "conic", "coeffs", "thickness", "tilt",
                        "decenter", "mat_coeffs"), g_fused[:7]))
    by_name.update(k_wl=g_fused[13], k_val=g_fused[14])
    for name, r in zip(names, g_ref):
        g = by_name[name]
        assert g is not None and torch.isfinite(g).all(), name
        _close_grads(g, np.zeros(g.shape) if r is None else r, name)
    for k, (g, r) in enumerate(zip(g_fused[16:], g_ref[len(names):])):
        _close_grads(g, r, f"ray {tfused._RAY_KEYS[k]}")
    # the tables the twin does not read get explicit zeros, not None
    assert not g_fused[8].any() and not g_fused[15].any()
    assert g_fused[0].abs().max() > 0 and g_fused[16 + 1].abs().max() > 0


def _merit_port(hist):
    # `__graft_entry__.entry`'s merit, written for the port
    x, y, i = hist.x[-1], hist.y[-1], hist.intensity[-1]
    wsum = torch.sum(i) + 1e-12
    cx = torch.sum(x * i) / wsum
    cy = torch.sum(y * i) / wsum
    return torch.sum(((x - cx) ** 2 + (y - cy) ** 2) * i) / wsum


@pytest.mark.parametrize("via_seam", [False, True], ids=["eager", "k7_seam"])
def test_flagship_merit_and_gradients_match_jax(cooke, flagship, via_seam):
    """The merit of `entry()` and its gradient over every parameter leaf,
    in the port through `trace_system` (eager on the CPU) or through the
    K7 seam (rays from `generate_rays`, history from `fused_history`: its
    ray cotangents carry the raygen's dependence on the parameters),
    against `jax.grad`. Where a JAX cotangent is not finite (none is
    expected), the port's is only required to be finite."""
    js, jp, ts, tp, _, _ = cooke
    jgrad, tb = flagship["grad"], flagship["batch"]
    names = [f.name for f in fields(tp) if getattr(tp, f.name) is not None
             and getattr(tp, f.name).numel()]
    leaves = {k: getattr(tp, k).clone().requires_grad_(True) for k in names}
    p = tp.replace(**leaves)
    if via_seam:
        rays0 = traygen.generate_rays(ts, p, *tb)
        rays9 = tuple(getattr(rays0, k).contiguous()
                      for k in tfused._RAY_KEYS)
        hist = ttracer.TraceHistory(*tfused.fused_history(
            ts, (tfused._diff_params(p), tfused._nondiff_params(p)), rays9))
    else:
        hist = ttracer.trace_system(ts, p, *tb)
    loss = _merit_port(hist)
    np.testing.assert_allclose(loss.item(), flagship["loss"], rtol=RTOL)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    for name, g in zip(names, grads):
        ref = np.asarray(getattr(jgrad, name))
        g = np.zeros(ref.shape) if g is None else g.numpy()
        assert np.isfinite(g).all(), name
        ok = np.isfinite(ref)
        _close_grads(g[ok], ref[ok], name)
    assert np.abs(grads[names.index("cv")].numpy()).max() > 0


def test_optic_trace_matches_jax():
    """`Optic.trace` (hexapolar, 6 rings, two field points) against the
    JAX package's, float64."""
    with jax_f64():
        ref = JCooke().trace(Hx=[0.0, 0.0], Hy=[0.0, 1.0], num_rays=6)
    got = TCooke().trace(Hx=[0.0, 0.0], Hy=[0.0, 1.0], num_rays=6,
                          device="cpu")
    assert got.x.shape == (8, 2 * 127)
    for name in ("x", "y", "z", "L", "M", "N", "intensity", "opd"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=RTOL,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("name,arg", [
    ("hexapolar", 6), ("uniform", 9), ("line_x", 7), ("line_y", 7),
    ("cross", 7), ("ring", 12), ("random", 20)])
def test_distributions_match_jax(name, arg):
    if name == "random":  # `generate` draws it unseeded
        got, ref = tdist.random(arg, seed=3), jdist.random(arg, seed=3)
    else:
        got, ref = tdist.generate(name, arg), jdist.generate(name, arg)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("symmetric", [True, False])
def test_gaussian_quadrature_matches_jax(symmetric):
    got = tdist.gaussian_quadrature(4, symmetric)
    ref = jdist.gaussian_quadrature(4, symmetric)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_optic_trace_generic_and_aiming():
    """`trace_generic` on explicit coordinates equals `trace` on the same
    pupil points (no vignetting on the Cooke triplet); under iterative
    aiming the rays cross the stop at (Px, Py) times the stop radius, as
    the JAX package's own test holds its aim
    (tests/test_aiming_glass.py)."""
    from optiland_tpu_torch.trace.aiming import stop_radius

    lens = TCooke()
    Px, Py = tdist.hexapolar(3)
    h = lens.trace(Hx=0.0, Hy=0.7, num_rays=3, device="cpu")
    g = lens.trace_generic(0.0, 0.7, Px, Py, device="cpu")
    for name in ("x", "y", "L", "M", "intensity", "opd"):
        assert torch.equal(getattr(g, name), getattr(h, name)), name
    lens.set_ray_aiming("iterative")
    Py = torch.linspace(-0.9, 0.9, 7, dtype=torch.float64)
    a = lens.trace(Hx=0.0, Hy=1.0, distribution=(torch.zeros_like(Py), Py),
                   wavelength=0.55, device="cpu")
    static, params = lens.build(device="cpu")
    r = stop_radius(static, params, torch.tensor(0.55, dtype=torch.float64))
    k = static.stop_index
    np.testing.assert_allclose((a.y[k] / r).numpy(), Py.numpy(), atol=1e-9)
    np.testing.assert_allclose(a.x[k].numpy(), 0.0, atol=1e-12)
