"""Ray aiming strategies.

Port of `optiland_tpu/trace/aiming.py` (the reference's
`rays/ray_aiming/`). The paraxial aimer is the closed form inside
`generate_rays`. The iterative aimer is JAX's fixed-count, batched Newton
over the normalized pupil coordinates, each ray's 2x2 Jacobian from two
forward-mode probes (`raygen.newton_step`); the robust aimer runs that
Newton (its Jacobians by reverse mode) inside a damped, per-ray
continuation. Both run the eager tracer, on the device and in the dtype
of `params`. A system with a Newton-refined geometry (an asphere or
freeform with coefficients) cannot be aimed: its intersection has a
reverse-mode rule only, as JAX's `custom_vjp` has.
"""

from __future__ import annotations

import dataclasses

import torch

from optiland_tpu_torch.core.rays import make_rays
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.system.spec import (
    SystemParams,
    SystemStatic,
    positions_of,
)
from optiland_tpu_torch.trace.raygen import generate_rays, newton_step, twice
from optiland_tpu_torch.trace.tracer import trace_rays


def stop_radius(static, params, wavelength):
    """Effective stop radius, the aim's target (reference
    `ray_aiming/initialization.py:24-189`): a float-by-stop system's stop
    semi-aperture; otherwise |y| at the stop of a real marginal ray
    (axis-parallel at y = EPD/2 for an infinite object, from the object's
    centre to the pupil's edge otherwise), or the paraxial marginal height
    where that ray dies."""
    stop = static.stop_index
    if static.aperture_type == "float_by_stop":
        return params.ap_radius[stop]

    ym, _ = px.marginal_ray(static, params, wavelength)
    r_par = torch.abs(ym.reshape(-1)[stop])

    epd = px.EPD(static, params)
    epl = px.EPL(static, params)
    pos = positions_of(static, params)
    dt, dev = params.cv.dtype, params.cv.device
    half = epd / 2.0
    zero = torch.zeros(1, dtype=dt, device=dev)
    if static.object_infinite:
        x0, y0, z0 = zero, half.reshape(1), (pos[1] - 100.0).reshape(1)
        L0, M0, N0 = zero, zero, torch.ones(1, dtype=dt, device=dev)
    else:
        dy = half
        dz = epl - pos[0]
        mag = torch.sqrt(dy * dy + dz * dz)
        x0, y0, z0 = zero, zero, pos[0].reshape(1)
        L0, M0, N0 = zero, (dy / mag).reshape(1), (dz / mag).reshape(1)
    rays = make_rays(x0, y0, z0, L0, M0, N0, wavelength=wavelength,
                     dtype=dt, device=dev)
    hist = trace_rays(static, params, rays)
    r_real = torch.abs(hist.y[stop][0])
    ok = (hist.intensity[stop][0] > 0) & torch.isfinite(r_real) & (r_real > 0)
    return torch.where(ok, r_real, r_par)


def _stop_hit(static, params, Hx, Hy, qx, qy, wavelength):
    """(x, y) at the stop surface of rays aimed at pupil coordinates
    (qx, qy)."""
    rays0 = generate_rays(static, params, Hx, Hy, qx, qy, wavelength,
                          apply_vignetting=False)
    hist = trace_rays(static, params, rays0)
    k = static.stop_index
    return hist.x[k], hist.y[k]


def _carries_grad(params, *arrays) -> bool:
    """Whether autograd is on and a leaf of `params` or one of `arrays`
    requires a gradient."""
    leaves = [getattr(params, f.name) for f in dataclasses.fields(params)]
    return torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad for a in (*leaves, *arrays))


def aim_rays_iterative(static: SystemStatic, params: SystemParams, Hx, Hy,
                       Px, Py, wavelength, iters: int = 6,
                       damping: float = 1.0, q0=None):
    """Newton-correct the normalized pupil coordinates so that each ray
    crosses the stop surface at (Px, Py) * r_stop; returns the corrected
    (Px', Py') to feed to `generate_rays`. `q0` warm-starts the Newton.
    Each ray's 2x2 Jacobian comes from JAX's two forward-mode probes
    (`torch.func.jvp`, `raygen.newton_step`). The `iters` steps stay in
    the autograd graph, so the aimed coordinates are differentiable in the
    parameters, as JAX's `lax.scan` is."""
    r_stop = stop_radius(static, params, wavelength)
    Hx2, Hy2, Px2, Py2 = twice(Hx, Hy, Px, Py)

    def fx(a, b):
        sx, sy = _stop_hit(static, params, Hx2, Hy2, a, b, wavelength)
        return sx / r_stop - Px2, sy / r_stop - Py2

    qx, qy = (Px, Py) if q0 is None else q0
    for _ in range(iters):
        dqx, dqy = newton_step(fx, qx, qy)
        qx, qy = qx - damping * dqx, qy - damping * dqy
    return qx, qy


def aim_rays_robust(static, params, Hx, Hy, Px, Py, wavelength,
                    iters: int = 6, max_outer: int = 320, dt0: float = 0.125,
                    dt_min: float = 1.0 / 2048.0, tol: float = 1e-4,
                    stats: dict | None = None):
    """Per-ray adaptive continuation (reference `ray_aiming/robust.py:22-171`):
    walk the field and pupil target from 0 to full scale, each ray with
    its own parameter t and step dt. A Newton result is accepted only where
    the aimed ray is live (no missed surface, no total internal reflection)
    and hits the stop target within `tol`; an accepted step grows dt by
    1.25 (to at most 0.125), a rejected one halves it (to at least
    `dt_min`); at most `max_outer` rounds. A guarded Newton polish at the
    full target ends it. The search runs under `torch.no_grad`, its
    Newton taking each ray's Jacobian by reverse mode (the derivatives of
    JAX's forward-mode probes, for a third of their cost over its many
    rounds). JAX's `lax.while_loop` gives no reverse-mode gradient; here,
    where a parameter or an input requires a gradient, the root carries
    the implicit-function derivative dq/dp = -J^-1 dF/dp: one step of the
    iterative aim from the detached root, whose value is taken away again,
    so that the values are the search's. A
    `stats` dict receives "rounds", the continuation rounds taken."""
    with torch.no_grad():
        r_stop = stop_radius(static, params, wavelength)

    # probes trace with the apertures off: a ray's validity reflects the
    # geometry alone (a vignetted ray still aims in the reference)
    S = static.num_surfaces
    static_noap = dataclasses.replace(
        static, has_aperture=(False,) * S, aperture_masks=(None,) * S)

    def newton(qx, qy, Hxt, Hyt, Pxt, Pyt):
        def fx(a, b):
            sx, sy = _stop_hit(static, params, Hxt, Hyt, a, b, wavelength)
            return sx / r_stop - Pxt, sy / r_stop - Pyt

        for _ in range(iters):
            dqx, dqy = newton_step(fx, qx, qy, reverse=True)
            # trust region: at most half a pupil radius a step, so that a
            # near-singular Jacobian at grazing incidence cannot fling the
            # iterate out of its basin
            step = torch.sqrt(dqx * dqx + dqy * dqy)
            lim = torch.where(step > 0.5,
                              0.5 / torch.clamp(step, min=1e-30),
                              torch.ones_like(step))
            qx, qy = qx - dqx * lim, qy - dqy * lim
        return qx, qy

    def probe(qx, qy, Hxt, Hyt):
        rays0 = generate_rays(static_noap, params, Hxt, Hyt, qx, qy,
                              wavelength, apply_vignetting=False)
        hist = trace_rays(static_noap, params, rays0)
        k = static.stop_index
        return hist.x[k], hist.y[k], hist.intensity[-1] > 0

    with torch.no_grad():
        zero = torch.zeros_like(Px)
        t = zero
        dt = torch.full_like(Px, dt0)
        qx = qy = zero
        rounds = 0
        while rounds < max_outer and bool(torch.any(t < 1.0)):
            rounds += 1
            t_new = torch.clamp(t + dt, max=1.0)
            # differential predictor (reference `robust.py:131-141`): the
            # target scales linearly with t, so rescale the accepted root
            scale = torch.where(t > 0, t_new / torch.clamp(t, min=1e-12),
                                torch.ones_like(t))
            qn_x, qn_y = newton(qx * scale, qy * scale, Hx * t_new,
                                Hy * t_new, Px * t_new, Py * t_new)
            sx, sy, live = probe(qn_x, qn_y, Hx * t_new, Hy * t_new)
            ex = sx / r_stop - Px * t_new
            ey = sy / r_stop - Py * t_new
            ok = (live & (ex * ex + ey * ey < tol * tol)
                  & torch.isfinite(qn_x) & torch.isfinite(qn_y))
            adv = ok & (t < 1.0)
            qx = torch.where(adv, qn_x, qx)
            qy = torch.where(adv, qn_y, qy)
            t = torch.where(adv, t_new, t)
            dt = torch.where(ok, torch.clamp(dt * 1.25, max=0.125),
                             torch.clamp(dt * 0.5, min=dt_min))
        # final polish at the full target, kept only where it is finite,
        # live and at least as close to the stop target as the
        # continuation's root
        qpx, qpy = newton(qx, qy, Hx, Hy, Px, Py)

        def err2(ax, ay):
            sx, sy, live = probe(ax, ay, Hx, Hy)
            ex = sx / r_stop - Px
            ey = sy / r_stop - Py
            e2 = ex * ex + ey * ey
            return torch.where(live & torch.isfinite(e2), e2,
                               torch.full_like(e2, float("inf")))

        if stats is not None:
            stats["rounds"] = rounds
        better = (torch.isfinite(qpx) & torch.isfinite(qpy)
                  & (err2(qpx, qpy) <= err2(qx, qy)))
        qx = torch.where(better, qpx, qx)
        qy = torch.where(better, qpy, qy)
    if not _carries_grad(params, Hx, Hy, Px, Py, wavelength):
        return qx, qy

    q1x, q1y = aim_rays_iterative(static, params, Hx, Hy, Px, Py, wavelength,
                                  iters=1, q0=(qx, qy))
    return qx + (q1x - q1x.detach()), qy + (q1y - q1y.detach())

