"""The port's NURBS surfaces against the JAX package, in float64 on the CPU.

`optiland_tpu_torch/geometry/nurbs.py` against `optiland_tpu.geometry.nurbs`:
  - the basis functions and their derivatives (`basis_funs`,
    `basis_and_deriv`, `find_span`) at seeded parameters and at the knots,
    on a clamped uniform and a non-uniform knot vector, at 1e-12;
  - `surface_eval` and `sag_and_grad_xy` on a fitted conic and on an
    explicit weighted control net (`SINGLETS`), and the packing of both
    (`spec._pack_nurbs`);
  - on the two singlets of those faces, `trace_system` at 1e-10 of each
    field's scale and `centroid_rms_spot`'s gradients into `coeffs` (the
    control net's z, its weights and knots) and cv at 1e-8 of each leaf's
    largest entry;
  - the clamp of the (u, v) Newton: rays whose root lies on the patch's
    edges at u = 1 and u = 0, where JAX's clamp splits the derivative of a
    tie evenly (`nurbs._clip`); `torch.clamp` would not.

The JAX side runs eagerly, a module-scoped fixture (per singlet, the merit
differentiated with the history as its by-product): a jit of the unrolled
Newton loops costs minutes of XLA compilation. The singlets take 4 Newton
steps (`newton_iters`), the NURBS intersection's count, in both packages."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.geometry import nurbs as jnurbs
from optiland_tpu.geometry import surfaces as jsurf
from optiland_tpu.system.spec import SurfaceSpec as JSpec
from optiland_tpu.system.spec import _pack_geometry as j_pack
from optiland_tpu.trace.tracer import trace_system as j_trace_system
from optiland_tpu_torch.geometry import nurbs as tnurbs
from optiland_tpu_torch.geometry import surfaces as tsurf
from optiland_tpu_torch.optimization.merits import centroid_rms_spot
from optiland_tpu_torch.system.spec import SurfaceSpec as TSpec
from optiland_tpu_torch.system.spec import _pack_geometry as t_pack
from optiland_tpu_torch.trace.tracer import trace_system

from torch_port_helpers import assert_close, build_both, jax_f64

N_RAYS = 24
RTOL_EVAL = 1e-12
RTOL_VALUES = 1e-10
RTOL_GRADS = 1e-8
_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")


def _weighted_net():
    """An explicit 6 x 6 quadratic control net over +-6 mm: the R 60, k
    -0.8 conic's sag plus a seeded departure of 2e-3 mm, weights in [0.8,
    1.2], non-uniform knots in u."""
    rng = np.random.default_rng(4)
    g = np.linspace(-6.0, 6.0, 6)
    X, Y = np.meshgrid(g, g, indexing="ij")
    r2 = X * X + Y * Y
    c, k = 1.0 / 60.0, -0.8
    Z = c * r2 / (1 + np.sqrt(1 - (1 + k) * c * c * r2))
    Z = Z + 2e-3 * rng.standard_normal(Z.shape)
    return dict(control_points=np.stack([X, Y, Z]),
                weights=rng.uniform(0.8, 1.2, (6, 6)),
                u_knots=np.array([0, 0, 0, 0.3, 0.55, 0.8, 1, 1, 1.0]),
                u_degree=2, v_degree=2)


# each singlet's NURBS front face: JAX's `test_nurbs_fitted_conic` (R 60,
# k -0.8, a 10 x 10 net fitted over +-8 mm), and the explicit weighted net
SINGLETS = {
    "fitted": dict(radius=60.0, conic=-0.8, n_points_u=10, n_points_v=10,
                   nurbs_norm_x=8.0, nurbs_norm_y=8.0),
    "weighted": _weighted_net(),
}


def nurbs_singlet(name):
    """An n = 1.55 singlet (5 mm thick, EPD 8, fields 0 and 5 degrees,
    0.48/0.55/0.65 um) with SINGLETS[name] its front face and a spherical
    back (R -60)."""
    def make(Optic):
        lens = Optic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        kw = dict(SINGLETS[name])
        radius = kw.pop("radius", math.inf)
        lens.add_surface(index=1, radius=radius, thickness=5.0,
                         material=1.55, is_stop=True, surface_type="nurbs",
                         **kw)
        lens.add_surface(index=2, radius=-60.0, thickness=45.0)
        lens.add_surface(index=3)
        lens.set_aperture("EPD", 8.0)
        lens.set_field_type("angle")
        lens.add_field(y=0.0)
        lens.add_field(y=5.0)
        lens.add_wavelength(0.55, is_primary=True)
        lens.add_wavelength(0.48)
        lens.add_wavelength(0.65)
        return lens
    return make


def _inputs():
    """(Hx, Hy, Px, Py) and each ray's wavelength index, from a seed."""
    rng = np.random.default_rng(9)
    Hx, Hy = rng.uniform(-1.0, 1.0, (2, N_RAYS))
    Px, Py = rng.uniform(-0.7, 0.7, (2, N_RAYS))
    return (Hx, Hy, Px, Py), rng.integers(0, 3, N_RAYS)


def _j_spot_merit(h):
    """JAX's `centroid_rms_spot` from its history (eps 1e-6)."""
    x, y, i = h.x[-1], h.y[-1], h.intensity[-1]
    m0, m1, m2, m3 = (jnp.sum(i), jnp.sum(x * i), jnp.sum(y * i),
                      jnp.sum((x * x + y * y) * i))
    ws = m0 + 1e-6
    cx, cy = m1 / ws, m2 / ws
    return (m3 - 2.0 * (cx * m1 + cy * m2) + (cx * cx + cy * cy) * m0) / ws


@pytest.fixture(scope="module")
def jax_results():
    """Per singlet: the JAX history at per-ray wavelengths, the merit and
    its gradients (eager JAX); and the port's system carried across from
    JAX's tables."""
    data, widx = _inputs()
    idx = jnp.asarray(widx)
    out = {}
    with jax_f64():
        for name in SINGLETS:
            (js, jp), port = build_both(nurbs_singlet(name), newton_iters=4)

            def merit(q, js=js):
                h = j_trace_system(js, q, *data, q.wavelengths[idx])
                return _j_spot_merit(h), h

            (loss, h), g = jax.value_and_grad(merit, has_aux=True)(jp)
            hist = tuple(np.asarray(getattr(h, f)) for f in _FIELDS)
            out[name] = dict(port=port, hist=hist, loss=np.asarray(loss),
                             grads=jax.tree_util.tree_map(np.asarray, g))
    return out


@pytest.mark.parametrize("knots", ["uniform", "non_uniform"])
def test_basis_functions_match_jax(knots):
    """`find_span`, `basis_funs` and `basis_and_deriv` at degrees 1-3, at
    seeded parameters, at every knot and at the domain's ends, against the
    JAX package's at 1e-12."""
    for degree in (1, 2, 3):
        n_ctrl = 7
        U = (tnurbs.clamped_uniform_knots(n_ctrl, degree)
             if knots == "uniform" else np.concatenate(
                 [np.zeros(degree + 1), [0.1, 0.3, 0.45, 0.5, 0.9][
                     :n_ctrl - degree - 1], np.ones(degree + 1)]))
        assert len(U) == n_ctrl + degree + 1
        t = np.concatenate([np.random.default_rng(degree).uniform(0, 1, 30),
                            U, [0.0, 1.0]])
        with jax_f64():
            span_j = jnurbs.find_span(jnp.asarray(U), degree, n_ctrl,
                                      jnp.asarray(t))
            ref = jnurbs.basis_and_deriv(jnp.asarray(U), degree, span_j,
                                         jnp.asarray(t))
        span = tnurbs.find_span(torch.from_numpy(U), degree, n_ctrl,
                                torch.from_numpy(t))
        assert np.array_equal(span.numpy(), np.asarray(span_j))
        got = tnurbs.basis_and_deriv(torch.from_numpy(U), degree, span,
                                     torch.from_numpy(t))
        for label, g_list, r_list in zip(("N", "dN"), got, ref):
            for j, (g, r) in enumerate(zip(g_list, r_list)):
                assert_close(g, r, RTOL_EVAL, f"{label}{j} degree {degree}",
                             scale=max(1.0, float(np.abs(r).max())))
        # partition of unity
        assert_close(sum(got[0]), np.ones_like(t), RTOL_EVAL, "sum N")


@pytest.mark.parametrize("name", list(SINGLETS))
def test_pack_and_surface_eval_match_jax(name):
    """`spec._pack_nurbs` (the fitted net, LSQ in float64; the explicit
    weighted one) packs JAX's row and aux; `surface_eval` (S, S_u, S_v) at
    seeded (u, v) and `sag_and_grad_xy` at seeded (x, y) over the patch
    match the JAX package's at 1e-12 of each output's scale."""
    kw = dict(SINGLETS[name])
    radius = kw.pop("radius", math.inf)
    conic = kw.pop("conic", 0.0)
    with jax_f64():
        jc = j_pack(JSpec(radius=radius, conic=conic, geometry="nurbs",
                          geom_params=kw))
    code, cv, k, co, aux = t_pack(TSpec(radius=radius, conic=conic,
                                        geometry="nurbs", geom_params=kw))
    assert (code, cv, k, aux) == (jc[0], jc[1], jc[2], jc[4])
    assert_close(np.asarray(co), np.asarray(jc[3]), RTOL_EVAL, "coeffs",
                 scale=1.0)
    co_t = torch.tensor(co, dtype=torch.float64)
    sl = tsurf._nurbs_slices(co_t, aux)
    rng = np.random.default_rng(2)
    u, v = rng.uniform(0.0, 1.0, (2, 40))
    x, y = rng.uniform(-5.0, 5.0, (2, 40))
    with jax_f64():
        jsl = jsurf._nurbs_slices(jnp.asarray(jc[3]), aux[:4])
        ref_eval = jnurbs.surface_eval(*jsl, *aux[:4], jnp.asarray(u),
                                       jnp.asarray(v))
        ref_sag = jnurbs.sag_and_grad_xy(*jsl, *aux[:4], aux[4:8],
                                         jnp.asarray(x), jnp.asarray(y))
    got_eval = tnurbs.surface_eval(*sl, *aux[:4], torch.from_numpy(u),
                                   torch.from_numpy(v))
    for label, g3, r3 in zip(("S", "S_u", "S_v"), got_eval, ref_eval):
        for c in range(3):
            assert_close(g3[c], r3[c], RTOL_EVAL, f"{label}[{c}]")
    got_sag = tnurbs.sag_and_grad_xy(*sl, *aux[:4], aux[4:8],
                                     torch.from_numpy(x), torch.from_numpy(y))
    for label, g, r in zip(("z", "gx", "gy"), got_sag, ref_sag):
        assert_close(g, r, RTOL_EVAL, label)
    got = tsurf.sag_and_grad(code, len(co), torch.from_numpy(x),
                             torch.from_numpy(y), cv, k, co_t, aux)
    for g, r in zip(got, got_sag):
        assert torch.equal(g, r)


@pytest.mark.parametrize("name", list(SINGLETS))
def test_trace_system_matches_jax(jax_results, name):
    """`trace_system` at per-ray wavelengths: every field of the history
    within 1e-10 of its scale of the JAX package's, every ray through."""
    ts, tp = jax_results[name]["port"]
    data, widx = _inputs()
    h = trace_system(ts, tp, *(torch.from_numpy(a) for a in data),
                     tp.wavelengths[torch.from_numpy(widx)])
    for f, r in zip(_FIELDS, jax_results[name]["hist"]):
        assert_close(getattr(h, f), r, RTOL_VALUES, f)
    assert float(h.intensity[-1].min()) == 1.0


@pytest.mark.parametrize("name", list(SINGLETS))
def test_merit_gradients_match_jax(jax_results, name):
    """`centroid_rms_spot` at per-ray wavelengths: its value within 1e-10
    and its gradients into `coeffs` (the NURBS row: knots, weights and the
    control net) and cv within 1e-8 of each leaf's largest entry of JAX's;
    the control net's z reached."""
    ts, tp = jax_results[name]["port"]
    ref = jax_results[name]["grads"]
    data, widx = _inputs()
    leaves = {key: getattr(tp, key).detach().clone().requires_grad_(True)
              for key in ("cv", "coeffs", "wavelengths")}
    p = tp.replace(**leaves)
    loss = centroid_rms_spot(ts, p, *(torch.from_numpy(a) for a in data),
                             p.wavelengths[torch.from_numpy(widx)])
    assert_close(loss, jax_results[name]["loss"], RTOL_VALUES, "loss")
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), materialize_grads=True)))
    for leaf in ("cv", "coeffs"):
        assert_close(grads[leaf], getattr(ref, leaf), RTOL_GRADS, leaf)
    nu, nv = ts.geom_aux[1][2:4]
    pz = grads["coeffs"][1, ts.geom_n_coeffs[1] - nu * nv:
                         ts.geom_n_coeffs[1]]
    assert pz.abs().max() > 0


def test_clamp_splits_a_tie_as_jax(monkeypatch):
    """Axial rays at x = +-8 mm meet the fitted patch on its edges, u = 1
    and u = 0, where the Newton lands on the clamp's bound at every step:
    the two-plane intersection's t and its gradients into the rays' x and
    the patch's row match JAX's (whose clamp splits a tie's derivative
    evenly) at 1e-12; with `torch.clamp` (the whole derivative at the
    bound) they would not."""
    kw = dict(SINGLETS["fitted"])
    radius, conic = kw.pop("radius"), kw.pop("conic")
    code, cv, k, co, aux = t_pack(TSpec(radius=radius, conic=conic,
                                        geometry="nurbs", geom_params=kw))
    x = np.array([8.0, 3.0, -8.0])
    y, z = np.array([0.0, 1.0, 2.0]), np.full(3, -1.0)
    L, M, N = np.zeros(3), np.zeros(3), np.ones(3)
    w = np.array([1.0, 0.3, 0.7])

    def j_loss(co_, x_):
        t, _ = jsurf.intersect(code, len(co), x_, *(jnp.asarray(a) for a in (
            y, z, L, M, N)), cv, k, co_, newton_iters=4, aux=aux)
        return jnp.sum(t * w), t

    with jax_f64():
        (g_co, g_x), t_ref = jax.grad(j_loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(co), jnp.asarray(x))

    def port():
        co_, x_ = (torch.tensor(a, requires_grad=True) for a in (co, x))
        t, valid = tsurf.intersect(
            code, len(co), x_, *(torch.from_numpy(a) for a in (y, z, L, M, N)),
            cv, k, co_, newton_iters=4, aux=aux)
        assert bool(valid.all())
        (t * torch.from_numpy(w)).sum().backward()
        return t.detach(), co_.grad, x_.grad

    t, d_co, d_x = port()
    assert_close(t, t_ref, RTOL_EVAL, "t")
    assert_close(d_x, g_x, RTOL_EVAL, "dt/dx")
    assert_close(d_co, g_co, RTOL_EVAL, "dt/dcoeffs")
    assert abs(float(d_x[0])) > 0 and abs(float(d_x[2])) > 0
    monkeypatch.setattr(tnurbs, "_clip",
                        lambda t, lo, hi: torch.clamp(t, lo, hi))
    _, _, d_x_clamp = port()
    assert not np.allclose(d_x_clamp.numpy()[[0, 2]],
                           np.asarray(g_x)[[0, 2]], rtol=0.1)
