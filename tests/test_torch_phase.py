"""The phase-sheet branch of the port against the JAX package, in float64 on
the CPU.

Six systems, each built in both packages from one prescription
(tests/torch_port_helpers.py), at three wavelengths: the three profiles of
tests/test_fused_kernel.py (`test_fused_phase_parity`: radial, linear
grating, constant) as three sheets of one system; the coated metalens on a
conic carrier of tests/test_phase.py; the tilted reflective linear-grating
sheet whose 6 degree field passes the cutoff at 0.65 um (chip_smoke.py's
system F); the hybrid achromat (system D: N-BK7, its radial sheet
decentered here, and a constant sheet); a grid sheet at the bicubic
spline's order; a grid sheet and a height-profile sheet of N-BK7 at the
bilinear order. For each:
  - `trace_system` at per-ray wavelengths against the JAX package's eager
    trace, every field of the (S, n) history at rtol 1e-10 of its scale;
  - `centroid_rms_spot`'s gradient (`jax.grad` of its function on the JAX
    package's trace) into
    `phase_params` (all eight radial slots), `phase_grids`,
    `phase_mat_coeffs`, cv, conic, decenter, `mat_coeffs` and
    `coating_params`, at one wavelength and at per-ray wavelengths (then
    into `wavelengths` too), within 1e-8 of each leaf's largest entry;
  - on the systems the fused chain takes (the analytic kinds), its plain
    versions as the card's wrappers run them on the CPU (`_history_plain`,
    `_tile_trace` with the hoisted tables, K1/K2's seam) against the port's
    eager trace.
And `paraxial_phase_gradient`, `grid_bilinear` and `grid_cubic` against
JAX's, inside and outside the table; and the reference's axis quirk: the
derivative of d phi / dx in x at r = 0 is 0 in the eager phase of both
packages and 2 p0 in the fused chain's form of both.
The JAX side runs once per system in one jit, a module-scoped fixture, its
XLA compiles in threads at once at XLA's backend optimization level 0 (the
same float64 arithmetic)."""

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.core import interpolation as j_interp
from optiland_tpu.trace import fused as jfused
from optiland_tpu.trace import phase as j_phase
from optiland_tpu.trace.tracer import trace_system as j_trace_system
from optiland_tpu_torch.core import interpolation as t_interp
from optiland_tpu_torch.optimization.merits import (
    centroid_rms_from_moments,
    centroid_rms_spot,
)
from optiland_tpu_torch.trace import fused
from optiland_tpu_torch.trace import phase as t_phase
from optiland_tpu_torch.trace.raygen import generate_rays
from optiland_tpu_torch.trace.tracer import trace_rays, trace_system

from torch_port_helpers import (
    K0_055,
    PHASE_PROFILES,
    assert_close,
    build_both,
    curved_metalens,
    hybrid_achromat,
    jax_f64,
    phase_mirror,
)

N_RAYS = 64
RTOL_VALUES = 1e-10   # of each history field's largest entry
RTOL_GRADS = 1e-8     # of each leaf's largest entry
EPS = 1.0             # the merit's eps (tests/test_torch_interactions.py)
_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
_LEAVES = ("cv", "conic", "decenter", "phase_params", "phase_grids",
           "phase_mat_coeffs", "mat_coeffs", "coating_params")


def _sheets(Optic, image=20.0):
    """The three profiles of `test_fused_phase_parity` as three plane
    sheets 10 mm apart, the radial one at the stop (EPD 6); fields 0 and 3
    degrees."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    for k, kind in enumerate(("radial", "linear_grating", "constant")):
        lens.add_surface(index=k + 1, radius=math.inf,
                         thickness=10.0 if k < 2 else image, is_stop=k == 0,
                         surface_type="phase",
                         phase_profile=PHASE_PROFILES[kind])
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    return lens


def _grid(fn, n=15, lim=4.0):
    xs = np.linspace(-lim, lim, n)
    ys = np.linspace(-lim, lim, n)
    return xs, ys, np.array([[fn(x, y) for x in xs] for y in ys])


def _tabulated(Optic, height=True):
    """A plane grid sheet at the stop (EPD 6) of a 15 x 15 table over 8 x 8
    mm, a lens-like phase with a tilt and a saddle, and with `height` 10 mm
    after it a height profile of N-BK7 of the same shape, 20 um deep; the
    image plane 40 mm after the first sheet; fields 0 and 3 degrees."""
    xs, ys, g = _grid(lambda x, y: -K0_055 * (x * x + y * y) / 400.0
                      + 0.05 * K0_055 * y + 0.02 * K0_055 * x * y)
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, is_stop=True,
                     thickness=10.0 if height else 40.0,
                     surface_type="phase", phase_profile=("grid", xs, ys, g))
    if height:
        _, _, h = _grid(lambda x, y: 2e-3 - 1e-4 * (x * x + y * y)
                        + 5e-5 * y + 2e-5 * x * y)
        lens.add_surface(index=2, radius=math.inf, thickness=30.0,
                         surface_type="phase",
                         phase_profile=("height_profile", xs, ys, h, "N-BK7"))
    lens.add_surface(index=len(lens.surfaces))
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    return lens


def _with_wavelengths(make, primary=0.55):
    """`make` with 0.48, `primary` and 0.65 um."""
    def build(Optic):
        lens = make(Optic)
        for w in (0.48, primary, 0.65):
            lens.add_wavelength(w, is_primary=w == primary)
        return lens
    return build


def _decentered_achromat(Optic):
    """System D with its radial sheet decentered by (0.05, -0.1) mm."""
    lens = hybrid_achromat(Optic)
    lens.surfaces[2].dx, lens.surfaces[2].dy = 0.05, -0.1
    lens._dirty()
    return lens


# name -> (builder, interpolation order, whether the fused chain takes it)
_SYSTEMS = {
    "tabulated_cubic": (_with_wavelengths(lambda O: _tabulated(O, False)),
                        "cubic", False),
    "achromat": (_decentered_achromat, "cubic", True),
    "sheets": (_with_wavelengths(_sheets), "cubic", True),
    "tabulated_linear": (_with_wavelengths(_tabulated), "linear", False),
    "mirror": (phase_mirror, "cubic", True),
    "metalens": (curved_metalens, "cubic", True),
}


def _build(name):
    """((jax static, params), (port static, params)), the interpolation
    order applied to both."""
    make, interp, _ = _SYSTEMS[name]
    (js, jp), (ts, tp) = build_both(make)
    return (replace(js, phase_interp=interp), jp), (
        replace(ts, phase_interp=interp), tp)


def _inputs():
    """(Hx, Hy, Px, Py) and each ray's wavelength index from a seed."""
    rng = np.random.default_rng(4)
    Hx, Hy = rng.uniform(-1.0, 1.0, (2, N_RAYS))
    Px, Py = rng.uniform(-0.7, 0.7, (2, N_RAYS))
    return (Hx, Hy, Px, Py), rng.integers(0, 3, N_RAYS)


def _queries():
    """Query points on a 15 x 15 table over +-4 mm: inside it, on its
    nodes and outside it (clamped)."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(-3.9, 3.9, 12), [0.0, 4.0 / 7, 5.2]])
    y = np.concatenate([rng.uniform(-3.9, 3.9, 12), [0.0, -4.0 / 7, -4.6]])
    return x, y


@pytest.fixture(scope="module")
def jax_results():
    """Per system: the JAX history at per-ray wavelengths and
    `centroid_rms_spot`'s gradients at one wavelength (every ray at the
    primary wavelength) and at per-ray ones, by one jit of the history and
    the gradient taking the rays' wavelength indices, and the port's system;
    and the JAX package's phase helpers (`grid_bilinear`, `grid_cubic`,
    `paraxial_phase_gradient`) on the grid sheet's table, and the x
    derivative of d phi / dx of the sheets' radial profile at x = 0 and
    1e-6 in its eager and its fused-chain form. Each XLA compile starts in
    a thread as soon as its program is lowered (the systems whose compiles
    take longest first), so that it runs while the next is lowered."""
    data, widx = _inputs()
    xq, yq = _queries()
    jobs = {}
    pool = ThreadPoolExecutor(len(_SYSTEMS) + 1)

    def compile_(lowered):
        return pool.submit(lowered.compile, compiler_options={
            "xla_backend_optimization_level": 0})

    with jax_f64():
        for name in _SYSTEMS:
            (js, jp), port = _build(name)

            def run(p, idx, js=js):
                def merit(leaves):
                    # centroid_rms_spot's function on the history (one
                    # trace for both: its XLA path is generate_rays and
                    # trace_rays, as trace_system's), differentiated in the
                    # leaves compared alone
                    q = p.replace(**leaves)
                    h = j_trace_system(js, q, *data, q.wavelengths[idx])
                    x, y, i = h.x[-1], h.y[-1], h.intensity[-1]
                    m0, m1, m2 = i.sum(), (x * i).sum(), (y * i).sum()
                    m3 = ((x * x + y * y) * i).sum()
                    ws = m0 + EPS
                    cx, cy = m1 / ws, m2 / ws
                    loss = (m3 - 2.0 * (cx * m1 + cy * m2)
                            + (cx * cx + cy * cy) * m0) / ws
                    return loss, tuple(getattr(h, f) for f in _FIELDS)

                (_, hist), g = jax.value_and_grad(merit, has_aux=True)(
                    {k: getattr(p, k) for k in _LEAVES + ("wavelengths",)})
                return hist, g

            jobs[name] = (compile_(jax.jit(run).lower(
                jp, jnp.asarray(widx))), jp, js.primary_wavelength_idx, port)
        (gs, gp), _ = _build("tabulated_cubic")
        (ss, sp), _ = _build("sheets")
        k, (_, gy_, gx_) = 1, gs.phase_aux[1]

        def helpers(gp, sp):
            bounds, grid = gp.phase_params[k], gp.phase_grids[k]
            zero = jnp.zeros(())
            quirk = [[jax.grad(fn)(jnp.asarray(x0)) for x0 in (0.0, 1e-6)]
                     for fn in (lambda x: j_phase.phase_value_grad(
                         ss, sp, 1, x, zero, 0.55)[1],
                                lambda x: jfused._phase_vg_inline(
                         ss.phase_kinds[1], sp.phase_params[1], x, zero)[1])]
            return (j_phase.grid_bilinear(grid, bounds, gy_, gx_, xq, yq),
                    j_interp.grid_cubic(grid, bounds, gy_, gx_, xq, yq),
                    j_phase.paraxial_phase_gradient(gs, gp, k, yq, 0.55),
                    quirk)

        helper_run = compile_(jax.jit(helpers).lower(gp, sp))
        out = {}
        for name, (run, jp, primary, port) in jobs.items():
            run = run.result()
            hist, g2 = run(jp, jnp.asarray(widx))
            _, g1 = run(jp, jnp.full_like(jnp.asarray(widx), primary))
            out[name] = (port, [np.asarray(a) for a in hist],
                         jax.tree_util.tree_map(np.asarray, (g1, g2)),
                         float(jp.wavelengths[primary]))
        out["helpers"] = jax.tree_util.tree_map(
            np.asarray, helper_run.result()(gp, sp))
    pool.shutdown()
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


def _one(primary):
    return lambda p, widx: primary


def _per_ray(p, widx):
    return p.wavelengths[widx]


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_trace_system_matches_jax(jax_results, name):
    """`trace_system` at per-ray wavelengths: every field of the history
    within 1e-10 of its scale of the JAX package's; light gets through."""
    (ts, tp), ref, _, _ = jax_results[name]
    data, widx = _inputs()
    h = trace_system(ts, tp, *(torch.from_numpy(a) for a in data),
                     tp.wavelengths[torch.from_numpy(widx)])
    for f, r in zip(_FIELDS, ref):
        assert_close(getattr(h, f), r, RTOL_VALUES, f)
    assert float(h.intensity[-1].max()) > 0.0
    if name == "mirror":   # the 6 degree field at 0.65 um is evanescent
        assert float(h.intensity[-1].min()) == 0.0


@pytest.mark.parametrize("config", ["one", "per_ray"])
@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_merit_gradients_match_jax(jax_results, name, config):
    """`centroid_rms_spot`'s gradient into the phase tables, the carrier,
    the decenter, the material and coating coefficients (and the
    wavelength table at per-ray wavelengths) within 1e-8 of each leaf's
    largest entry of `jax.grad`'s. The port takes one wavelength as a
    scalar (the kernels' hoisted configuration); JAX's reference is its
    per-ray trace with every ray at the primary wavelength."""
    (ts, tp), _, (g1, g2), primary = jax_results[name]
    ref = g1 if config == "one" else g2
    got = _port_grads(ts, tp, _one(primary) if config == "one" else _per_ray,
                      "eager")
    names = _LEAVES + (("wavelengths",) if config == "per_ray" else ())
    for leaf in names:
        if ref[leaf].size:   # no grid, no table
            assert_close(got[leaf], ref[leaf], RTOL_GRADS, leaf)
    sheets = [k for k, i in enumerate(ts.interactions) if i == fused.INT_PHASE]
    assert got["phase_params"][sheets].abs().max() > 0
    if name == "sheets":   # every radial slot has its cotangent
        assert got["phase_params"][1].abs().min() > 0
    if name.startswith("tabulated"):
        assert got["phase_grids"][1].abs().max() > 0
    if name == "tabulated_linear":
        assert got["phase_grids"][2].abs().max() > 0
        assert got["phase_mat_coeffs"][2].abs().max() > 0
    if name == "achromat":
        assert got["decenter"][2].abs().min() > 0
    if config == "per_ray":
        assert got["wavelengths"].abs().max() > 0


@pytest.mark.parametrize(
    "name", [n for n, (_, _, kernel) in _SYSTEMS.items() if kernel])
def test_kernel_path_matches_eager(jax_results, name):
    """The kernels' plain versions as the card's wrappers run them on the
    CPU: K7's `_history_plain` at per-ray wavelengths and `_tile_trace` at
    one wavelength (the index, absorption and phase tables hoisted)
    against the port's eager trace at rtol 1e-10; the merit's gradients
    through K1/K2's seam (`_moments_plain`, `_moments_bwd_plain`) against
    the eager path's at 1e-8, in both configurations (no ray of the draw
    crosses a radial sheet on its axis, where the two forms differ)."""
    (ts, tp), _, _, primary = jax_results[name]
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
    rays0 = generate_rays(ts, tp, *t, primary)
    ref = trace_rays(ts, tp, rays0)
    got = fused._tile_trace(
        ts, *fused._uniform_params(ts, tp, primary),
        *(getattr(rays0, k).expand(N_RAYS) for k in fused._RAY_KEYS[:8]))
    for f, g in zip(_FIELDS, got):
        assert_close(g, getattr(ref, f)[-1], RTOL_VALUES, f)
    for wavelength_of in (_one(primary), _per_ray):
        eager = _port_grads(ts, tp, wavelength_of, "eager")
        kernel = _port_grads(ts, tp, wavelength_of, "kernel")
        for leaf in eager:
            if leaf == "cv":
                # the reference's flat-surface rule (ROADMAP queue 3): the
                # eager path leaves a plane's normal at (0, 0, 1) whatever
                # its cv, the chain's follows cv; compared on the others
                flat = [k for k in range(ts.num_surfaces)
                        if ts.geom_codes[k] == fused.GEOM_PLANE
                        and ts.interactions[k] != fused.INT_NONE]
                for g in (kernel, eager):
                    g[leaf] = g[leaf].clone()
                    g[leaf][flat] = 0.0
            if eager[leaf].numel():
                assert_close(kernel[leaf], eager[leaf], RTOL_GRADS, leaf)


@pytest.mark.parametrize("helper", ["grid_bilinear", "grid_cubic",
                                    "paraxial_phase_gradient"])
def test_phase_helpers_match_jax(jax_results, helper):
    """The grid samplers (value, d/dx, d/dy) and the paraxial gradient d
    phi / dy at x = 0 on the grid sheet's table, inside it, on its
    nodes and outside it (clamped), within 1e-10 of JAX's."""
    ref = dict(zip(("grid_bilinear", "grid_cubic", "paraxial_phase_gradient"),
                   jax_results["helpers"][:3]))[helper]
    (ts, tp), _, _, _ = jax_results["tabulated_cubic"]
    xq, yq = (torch.from_numpy(a) for a in _queries())
    k, (_, gy, gx) = 1, ts.phase_aux[1]
    bounds, grid = tp.phase_params[k], tp.phase_grids[k]
    if helper == "grid_bilinear":
        got = t_phase.grid_bilinear(grid, bounds, gy, gx, xq, yq)
    elif helper == "grid_cubic":
        got = t_interp.grid_cubic(grid, bounds, gy, gx, xq, yq)
    else:
        got = (t_phase.paraxial_phase_gradient(ts, tp, k, yq, 0.55),)
        ref = (ref,)
    for g, r in zip(got, ref):
        assert_close(g, r, RTOL_VALUES, helper)


def test_radial_axis_derivative_quirk(jax_results):
    """The reference's known behaviour on a radial sheet's axis, kept by
    the port on each path: d(d phi / dx) / dx at x = y = 0 is 0 in the
    eager phase of both packages (its d phi / d(r^2) = r^(2j) / r^2 is
    guarded to 0 there) and 2 p0 in the fused chain's form of both (JAX
    `_phase_vg_inline`, the port's `_phase_vg` and csrc/chain.cuh); at x =
    1e-6 all four give 2 p0 to 1e-6."""
    (ts, tp), _, _, _ = jax_results["sheets"]
    ref = jax_results["helpers"][3]   # [eager, chain] x [x = 0, 1e-6]
    p0 = float(tp.phase_params[1, 0])
    fns = (lambda x: t_phase.phase_value_grad(
        ts, tp, 1, x, torch.zeros((), dtype=x.dtype), 0.55)[1],
           lambda x: fused._phase_vg(ts.phase_kinds[1], tp.phase_params[1],
                                     x, torch.zeros((), dtype=x.dtype))[1])
    for j, (x0, want) in enumerate(((0.0, (0.0, 2 * p0)),
                                    (1e-6, (2 * p0, 2 * p0)))):
        got = []
        for fn in fns:
            x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
            got.append(float(torch.autograd.grad(fn(x), x)[0]))
        for path in range(2):
            assert got[path] == pytest.approx(float(ref[path][j]), rel=1e-12,
                                              abs=1e-12)
        assert got == pytest.approx(list(want), rel=1e-6, abs=1e-12)
