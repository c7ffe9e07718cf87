"""The port's ray aiming (`trace/aiming.py`, `Optic.set_ray_aiming`)
against the JAX package, in float64 on the CPU, on a five-surface singlet
whose stop sits 10 mm behind the lens, at fields up to 27 degrees
(`aimed_singlet`, tests/torch_port_helpers.py), 8 rays:
  - `stop_radius`, the iterative and the robust aim at rtol 1e-10, and
    each aim's own target: the rays' stop hits over the stop radius equal
    (Px, Py);
  - the cached mode: the iterative aim, memoized on the parameters and the
    query;
  - the iterative aim's gradient (autograd through its six Newton steps)
    and the robust aim's (its implicit-function derivative, one Newton
    step from its detached root) against JAX's derivative of the converged
    aim by the implicit-function theorem: -J^-T c through `jax.vjp` of the
    stop hit in the parameters, J each ray's 2x2 Jacobian by `jax.jvp`.
    (JAX's `jax.grad` through its `lax.scan` of forward-mode probes costs
    ~170 s of XLA compilation; its robust aim's `lax.while_loop` has no
    reverse mode.)
JAX's two aimers run once, in a module-scoped fixture, in threads at once
beside the compile of the gradient's program (each aimer compiles its
loop's body: ~17 s in all)."""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.trace import aiming as jaim
from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.trace import aiming as taim
from optiland_tpu_torch.trace.raygen import generate_rays
from optiland_tpu_torch.trace.tracer import trace_rays, trace_system

from torch_port_helpers import aimed_singlet, assert_close, build_both, jax_f64

N_RAYS = 8
RTOL = 1e-10
W = 0.55
# the weights of the aimed coordinates in the scalar whose gradient is held
C_X, C_Y = 0.7, -1.3


def _data():
    rng = np.random.default_rng(0)
    return (np.zeros(N_RAYS), np.linspace(0.0, 0.9, N_RAYS),
            rng.uniform(-0.6, 0.6, N_RAYS), rng.uniform(-0.6, 0.6, N_RAYS))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _jax_ift_gradient(js, jp, data, q):
    """JAX's gradient of C_X sum(qx) + C_Y sum(qy) at its converged aim q
    by the implicit-function theorem: F(q, p) = stop_hit(q, p) / r(p) - P
    = 0, so dq/dp = -J^-1 F_p and the gradient is -F_p^T J^-T c."""
    Hx, Hy, Px, Py = data
    w = jnp.asarray(W)

    def F(qx, qy, p):
        sx, sy = jaim._stop_hit(js, p, Hx, Hy, qx, qy, w)
        r = jaim.stop_radius(js, p, w)
        return sx / r - Px, sy / r - Py

    qx, qy = q
    ones = jnp.ones_like(qx)
    _, (a, c) = jax.jvp(lambda u: F(u, qy, jp), (qx,), (ones,))
    _, (b, d) = jax.jvp(lambda v: F(qx, v, jp), (qy,), (ones,))
    det = a * d - b * c
    # lam = J^-T (C_X, C_Y), J = [[a, b], [c, d]]
    lam_x = (d * C_X - c * C_Y) / det
    lam_y = (-b * C_X + a * C_Y) / det
    _, vjp = jax.vjp(lambda p: F(qx, qy, p), jp)
    (g,) = vjp((-lam_x, -lam_y))
    return g


@pytest.fixture(scope="module")
def jax_aims():
    """JAX's iterative and robust aims of `_data()` (two threads), its
    stop radius and the implicit-function gradient of the iterative aim;
    the port's system carried across."""
    with jax_f64():
        (js, jp), port = build_both(aimed_singlet)
        data = tuple(jnp.asarray(a) for a in _data())
        w = jnp.asarray(W)

        def ift(p, q):
            return (_jax_ift_gradient(js, p, data, q),
                    jaim.stop_radius(js, p, w))

        lowered = jax.jit(ift).lower(jp, data[2:])
        with ThreadPoolExecutor(3) as pool:
            it = pool.submit(jaim.aim_rays_iterative, js, jp, *data, w)
            rb = pool.submit(jaim.aim_rays_robust, js, jp, *data, w)
            ift = pool.submit(lowered.compile, compiler_options={
                "xla_backend_optimization_level": 0})
            q = it.result()
            grad, r_stop = ift.result()(jp, q)
            robust = rb.result()
        to_np = jax.tree_util.tree_map
        return dict(iterative=to_np(np.asarray, q),
                    robust=to_np(np.asarray, robust),
                    r_stop=np.asarray(r_stop),
                    grad=to_np(np.asarray, grad), port=port)


def _stop_errors(ts, tp, q):
    """Each ray's stop hit over the stop radius minus its (Px, Py)."""
    Hx, Hy, Px, Py = map(_t, _data())
    rays = generate_rays(ts, tp, Hx, Hy, *q, _t(W), apply_vignetting=False)
    hist = trace_rays(ts, tp, rays)
    r = taim.stop_radius(ts, tp, _t(W))
    k = ts.stop_index
    return hist.x[k] / r - Px, hist.y[k] / r - Py


def test_stop_radius_matches_jax(jax_aims):
    ts, tp = jax_aims["port"]
    assert_close(taim.stop_radius(ts, tp, _t(W)), jax_aims["r_stop"], RTOL)


@pytest.mark.parametrize("mode", ["iterative", "robust"])
def test_aim_matches_jax_and_meets_its_target(jax_aims, mode):
    ts, tp = jax_aims["port"]
    stats = {}
    if mode == "iterative":
        got = taim.aim_rays_iterative(ts, tp, *map(_t, _data()), _t(W))
    else:
        got = taim.aim_rays_robust(ts, tp, *map(_t, _data()), _t(W),
                                   stats=stats)
        assert 0 < stats["rounds"] < 320
    for a, ref, label in zip(got, jax_aims[mode], ("Px", "Py")):
        assert_close(a, ref, RTOL, f"{mode} {label}")
    # the paraxial aim misses the stop target at these fields; the aim hits
    Px, Py = map(_t, _data()[2:])
    miss = _stop_errors(ts, tp, (Px, Py))
    assert max(float(e.abs().max()) for e in miss) > 1e-3
    for e in _stop_errors(ts, tp, got):
        assert float(e.abs().max()) < 1e-12


def test_cached_aim_and_optic_modes(jax_aims):
    """`Optic.trace_generic` under each mode launches the aimed pupil
    coordinates (the robust aim's path is the iterative one's); "cached"
    is the iterative aim, computed once per parameter set and query."""
    Hx, Hy, Px, Py = map(_t, _data())
    lens = aimed_singlet(TOptic)
    ts, tp = lens.build(device="cpu")
    for mode in ("paraxial", "iterative", "cached"):
        lens.set_ray_aiming(mode)
        got = lens.trace_generic(Hx, Hy, Px, Py, wavelength=W, device="cpu")
        q = (Px, Py) if mode == "paraxial" else map(_t, jax_aims["iterative"])
        ref = trace_system(ts, tp, Hx, Hy, *q, _t(W))
        for f in ("x", "y", "L", "M", "opd"):
            assert_close(getattr(got, f), getattr(ref, f), RTOL, f"{mode} {f}")
    lens.set_ray_aiming("cached")
    assert lens._aim_cache == {}
    first = lens.trace_generic(Hx, Hy, Px, Py, wavelength=W, device="cpu")
    again = lens.trace_generic(Hx, Hy, Px, Py, wavelength=W, device="cpu")
    assert len(lens._aim_cache) == 1 and torch.equal(first.y, again.y)
    lens.set_radius(-110.0, 2)
    lens.trace_generic(Hx, Hy, Px, Py, wavelength=W, device="cpu")
    assert len(lens._aim_cache) == 2
    with pytest.raises(ValueError, match="ray aiming"):
        lens.set_ray_aiming("nope")


def _check_gradient(jax_aims, aim):
    """The gradient of C_X sum(qx) + C_Y sum(qy) of `aim`'s coordinates
    into every parameter leaf against JAX's implicit-function gradient,
    within 1e-9 of each leaf's largest entry."""
    ts, tp = jax_aims["port"]
    leaves = {f.name: getattr(tp, f.name).detach().clone().requires_grad_(
        True) for f in fields(tp) if getattr(tp, f.name) is not None}
    p = tp.replace(**leaves)
    qx, qy = aim(ts, p, *map(_t, _data()), _t(W))
    grads = torch.autograd.grad(C_X * qx.sum() + C_Y * qy.sum(),
                                list(leaves.values()), allow_unused=True)
    ref = jax_aims["grad"]
    moved = 0
    for name, g in zip(leaves, grads):
        r = np.asarray(getattr(ref, name))
        g = np.zeros_like(r) if g is None else g.numpy()
        fin = np.isfinite(r)
        assert np.array_equal(np.isfinite(g), fin), name
        scale = float(np.abs(r[fin]).max()) if fin.any() else 0.0
        if scale > 0:
            moved += 1
            np.testing.assert_allclose(g[fin] / scale, r[fin] / scale,
                                       rtol=0, atol=1e-9, err_msg=name)
        else:
            assert not np.abs(g[fin]).any(), name
    assert moved >= 4  # cv, thickness, mat_coeffs, aperture_value, ...


def test_iterative_aim_gradient_matches_jax(jax_aims):
    _check_gradient(jax_aims, taim.aim_rays_iterative)


def test_robust_aim_gradient_matches_jax(jax_aims):
    """The robust aim's values are its search's (held above), and its
    gradient is the implicit-function derivative at its root."""
    def aim(*args):
        q = taim.aim_rays_robust(*args)
        with torch.no_grad():
            ref = taim.aim_rays_robust(*args)
        for a, b in zip(q, ref):
            assert torch.equal(a.detach(), b)
        return q

    _check_gradient(jax_aims, aim)
