"""The coating, thin-lens and grating branches of the port against the JAX
package, in float64 on the CPU.

Four systems, each built in both packages from one prescription
(tests/torch_port_helpers.py), at three wavelengths: the coated singlet,
the ideal thin lens, the plane grating and the concave reflective grating
of tests/test_fused_kernel.py (`test_fused_simple_coating_parity`,
`test_fused_thin_lens_parity`, `test_fused_grating_parity`,
`test_fused_curved_grating_parity`; the thin lens and the gratings coated
here). For each:
  - `trace_system` at per-ray wavelengths against the JAX package's eager
    trace, every field of the (S, n) history at rtol 1e-10 of its scale;
  - f2, EPL, EPD, FNO and the marginal and chief rays at 1e-10;
  - `centroid_rms_spot`'s gradient (the JAX package's `jax.grad`) into
    `coating_params`, `focal_length`, `grating`, `mat_coeffs` and the
    geometry, at one wavelength and at per-ray wavelengths (then into
    `wavelengths` too), within 1e-8 of each leaf's largest entry;
  - the port's kernel path on the CPU (the plain versions `_tile_trace`,
    `_moments_plain` and `_moments_bwd_plain` behind the autograd seams of
    K1/K2 and K7, the gratings' m w hoisted at one wavelength) against the
    port's eager tracer, values and gradients.
The JAX side runs once per system in one jit, a module-scoped fixture,
the four XLA compiles in threads at once and at XLA's backend
optimization level 0 (the same float64 arithmetic; ~8-11 s in all instead
of ~17-20 s, the file's cost)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.optimization.merits import centroid_rms_spot as j_merit
from optiland_tpu.system import paraxial as jpx
from optiland_tpu.trace.tracer import trace_system as j_trace_system
from optiland_tpu_torch.optimization.merits import (
    centroid_rms_from_moments,
    centroid_rms_spot,
)
from optiland_tpu_torch.system import paraxial as tpx
from optiland_tpu_torch.trace import fused
from optiland_tpu_torch.trace.raygen import generate_rays
from optiland_tpu_torch.trace.tracer import trace_rays, trace_system

from torch_port_helpers import (
    assert_close,
    build_both,
    coated_singlet,
    curved_grating,
    jax_f64,
    plane_grating,
    thin_lens_system,
)

N_RAYS = 64
WAVELENGTH = 0.55
RTOL_VALUES = 1e-10   # of each history field's largest entry
RTOL_GRADS = 1e-8     # of each leaf's largest entry
# The merit's eps: the merit is invariant to a common scale of the
# intensities up to eps, so with the default 1e-6 a coating's gradient (T
# scales every ray that passes the surface) is the near-cancellation of
# terms 1e6 times its size; with eps ~ sum(i) it is a gradient of its own
EPS = 1.0
_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
_LEAVES = ("cv", "conic", "thickness", "coating_params", "focal_length",
           "grating", "mat_coeffs")
# first-order properties and paraxial rays, which the thin lens bends
_PARAXIAL = ("f2", "EPL", "EPD", "FNO", "marginal_ray", "chief_ray")


def _plane_grating_coated(Optic):
    """The plane grating with the simple coating (0.9, 0.05) on it."""
    lens = plane_grating(Optic)
    lens.surfaces[1].coating = ("simple", 0.9, 0.05)
    lens._dirty()
    return lens


def _three_wavelengths(make):
    """`make` with 0.48 and 0.65 um added beside its 0.55 um."""
    def build(Optic):
        lens = make(Optic)
        lens.add_wavelength(0.48)
        lens.add_wavelength(0.65)
        return lens
    return build


_SYSTEMS = {
    "coated_singlet": _three_wavelengths(coated_singlet),
    "thin_lens": _three_wavelengths(thin_lens_system),
    "plane_grating": _three_wavelengths(_plane_grating_coated),
    "curved_grating": _three_wavelengths(
        lambda O: curved_grating(O, ("simple", 0.9, 0.05))),
}


def _inputs():
    """(Hx, Hy, Px, Py) and each ray's wavelength index (0, 1 or 2) from a
    seed; the per-ray wavelengths are `wavelengths[index]`, so that the
    merit differentiates the wavelength table."""
    rng = np.random.default_rng(4)
    Hx, Hy = rng.uniform(-1.0, 1.0, (2, N_RAYS))
    Px, Py = rng.uniform(-0.7, 0.7, (2, N_RAYS))
    return (Hx, Hy, Px, Py), rng.integers(0, 3, N_RAYS)


@pytest.fixture(scope="module")
def jax_results():
    """Per system: the JAX history at per-ray wavelengths, the first-order
    properties and paraxial rays (`_PARAXIAL`), and
    `centroid_rms_spot`'s gradients at one wavelength (every ray at the
    primary wavelength, 0.55 um) and at per-ray ones, by one jit of the
    history and the gradient taking the rays' wavelength indices (the
    systems' XLA compiles run in threads at once); and the port's system
    carried across."""
    data, widx = _inputs()
    jobs = {}
    with jax_f64():
        for name, make in _SYSTEMS.items():
            (js, jp), port = build_both(make)
            primary = js.primary_wavelength_idx
            assert float(jp.wavelengths[primary]) == WAVELENGTH

            def run(p, idx, js=js):
                h = j_trace_system(js, p, *data, p.wavelengths[idx])
                g = jax.grad(lambda q: j_merit(js, q, *data,
                                               q.wavelengths[idx], EPS))(p)
                px = [getattr(jpx, f)(js, p) for f in _PARAXIAL]
                return tuple(getattr(h, f) for f in _FIELDS), g, px

            jobs[name] = (jax.jit(run).lower(jp, jnp.asarray(widx)), jp,
                          primary, port)
        with ThreadPoolExecutor(len(jobs)) as pool:
            compiled = list(pool.map(lambda job: job[0].compile(
                compiler_options={"xla_backend_optimization_level": 0}),
                jobs.values()))
        out = {}
        for (name, (_, jp, primary, port)), run in zip(jobs.items(),
                                                       compiled):
            hist, g2, px = run(jp, jnp.asarray(widx))
            _, g1, _ = run(jp, jnp.full_like(jnp.asarray(widx), primary))
            out[name] = (port, [np.asarray(a) for a in hist],
                         jax.tree_util.tree_map(np.asarray, (g1, g2)),
                         jax.tree_util.tree_map(np.asarray, px))
    return out


def _port_grads(ts, tp, wavelength_of, path):
    """Gradients of the port's `centroid_rms_spot` into `_LEAVES` and
    `wavelengths`, by the eager trace ("eager") or by the kernels' plain
    versions behind the K1/K2 seam ("kernel")."""
    data, widx = _inputs()
    leaves = {k: getattr(tp, k).detach().clone().requires_grad_(True)
              for k in _LEAVES + ("wavelengths",)}
    p = tp.replace(**leaves)
    w = wavelength_of(p, torch.from_numpy(widx))
    t = tuple(torch.from_numpy(a) for a in data)
    if path == "eager":
        loss = centroid_rms_spot(ts, p, *t, w, eps=EPS)
    else:
        prepared, d = fused._prepare(ts, p, *t, w)
        loss = centroid_rms_from_moments(
            *fused.fused_spot_moments(ts, prepared, d), eps=EPS)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return dict(zip(leaves, grads))


_ONE = (lambda p, widx: WAVELENGTH)
_PER_RAY = (lambda p, widx: p.wavelengths[widx])


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_trace_system_matches_jax(jax_results, name):
    """`trace_system` at per-ray wavelengths: every field of the history
    within 1e-10 of its scale of the JAX package's."""
    (ts, tp), ref, _, _ = jax_results[name]
    data, widx = _inputs()
    h = trace_system(ts, tp, *(torch.from_numpy(a) for a in data),
                     tp.wavelengths[torch.from_numpy(widx)])
    for f, r in zip(_FIELDS, ref):
        assert_close(getattr(h, f), r, RTOL_VALUES, f)
    assert 0.0 < float(h.intensity[-1].max()) <= 1.0


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_paraxial_matches_jax(jax_results, name):
    """f2, EPL, EPD, FNO and the marginal and chief rays (heights and
    slopes at every surface) within 1e-10 of the JAX package's: the thin
    lens bends the paraxial rays by (n1 u - y / f) / n2."""
    (ts, tp), _, _, ref = jax_results[name]
    for f, r in zip(_PARAXIAL, ref):
        got = getattr(tpx, f)(ts, tp)
        for g, q in zip(got if isinstance(got, tuple) else (got,),
                        r if isinstance(r, (tuple, list)) else (r,)):
            g, q = g.detach().numpy(), np.asarray(q)
            # a grating in air has no power: f2 and FNO are infinite
            finite = np.isfinite(q)
            assert np.array_equal(g[~finite], q[~finite]), f
            if finite.any():
                assert_close(g[finite], q[finite], RTOL_VALUES, f)


@pytest.mark.parametrize("config", ["one", "per_ray"])
@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_merit_gradients_match_jax(jax_results, name, config):
    """`centroid_rms_spot`'s gradient into the coatings, focal lengths,
    gratings, material coefficients and geometry (and the wavelength table
    at per-ray wavelengths) within 1e-8 of each leaf's largest entry of
    `jax.grad`'s. The port takes one wavelength as a scalar (the kernels'
    hoisted configuration); JAX's reference is its per-ray trace with every
    ray at that wavelength, the same function."""
    (ts, tp), _, (g1, g2), _ = jax_results[name]
    ref = g1 if config == "one" else g2
    got = _port_grads(ts, tp, _ONE if config == "one" else _PER_RAY, "eager")
    names = _LEAVES + (("wavelengths",) if config == "per_ray" else ())
    for leaf in names:
        assert_close(got[leaf], getattr(ref, leaf), RTOL_GRADS, leaf)
    branch = {"coated_singlet": "coating_params", "thin_lens": "focal_length",
              "plane_grating": "grating", "curved_grating": "grating"}[name]
    assert got[branch].abs().max() > 0
    if config == "per_ray" and branch == "grating":
        assert got["wavelengths"].abs().max() > 0


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_kernel_path_matches_eager(jax_results, name):
    """The kernels' plain versions as the card's wrappers run them on the
    CPU: K7's `_history_plain` at per-ray wavelengths and `_tile_trace` at
    one wavelength (the index, absorption and grating tables hoisted)
    against the port's eager trace at rtol 1e-10; the merit's gradients
    through K1/K2's seam (`_moments_plain`, `_moments_bwd_plain`) against
    the eager path's at 1e-8, in both configurations."""
    (ts, tp), _, _, _ = jax_results[name]
    data, widx = _inputs()
    t = tuple(torch.from_numpy(a) for a in data)
    w = tp.wavelengths[torch.from_numpy(widx)]
    rays0 = generate_rays(ts, tp, *t, w)
    rays9 = tuple(getattr(rays0, k) for k in fused._RAY_KEYS)
    ref = trace_rays(ts, tp, rays0)
    got = fused._history_plain(ts, fused._diff_params(tp),
                               fused._nondiff_params(tp), rays9)
    for f, g in zip(_FIELDS, got):
        assert_close(g, getattr(ref, f), RTOL_VALUES, f"K7 {f}")
    rays0 = generate_rays(ts, tp, *t, WAVELENGTH)
    ref = trace_rays(ts, tp, rays0)
    n_table, alpha = fused._uniform_tables(ts, tp, WAVELENGTH)
    got = fused._tile_trace(
        ts, fused._diff_params(tp, n_table, fused._uniform_grating(
            ts, tp, WAVELENGTH)), fused._nondiff_params(tp, alpha),
        *(getattr(rays0, k).expand(N_RAYS) for k in fused._RAY_KEYS[:8]))
    for f, g in zip(_FIELDS, got):
        assert_close(g, getattr(ref, f)[-1], RTOL_VALUES, f)
    for wavelength_of in (_ONE, _PER_RAY):
        eager = _port_grads(ts, tp, wavelength_of, "eager")
        kernel = _port_grads(ts, tp, wavelength_of, "kernel")
        for leaf in eager:
            assert_close(kernel[leaf], eager[leaf], RTOL_GRADS, leaf)
