"""Ray generation: field/pupil coordinates -> starting ray bundle.

Port of `optiland_tpu/trace/raygen.py`: angle, object-height and the two
image-height fields (the real one by a fixed-count Newton on the real
chief ray), aimed at the paraxial entrance pupil or, in a telecentric
object space, along the axis; apodization weights the launch
intensities. The paraxial EPL/EPD sub-traces are tensors in the autograd
graph, so merit gradients see the aiming's dependence on thicknesses and
curvatures.
"""

from __future__ import annotations

import torch

from optiland_tpu_torch.core.rays import Rays, make_rays
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.system.spec import SystemParams, SystemStatic, positions_of


def vignetting_factors(static: SystemStatic, params: SystemParams, Hx, Hy):
    """Nearest-neighbor interpolation of (vx, vy) over the field table."""
    max_field = torch.sqrt(torch.max(params.x_fields**2 + params.y_fields**2))
    scale = torch.where(max_field == 0, torch.ones_like(max_field), max_field)
    fx = params.x_fields / scale
    fy = params.y_fields / scale
    d2 = (Hx[..., None] - fx) ** 2 + (Hy[..., None] - fy) ** 2
    idx = torch.argmin(d2, dim=-1)
    onehot = (idx[:, None] == torch.arange(params.vx.shape[0],
                                           device=idx.device)).to(params.vx.dtype)
    return onehot @ params.vx, onehot @ params.vy


def _ray_origins(static: SystemStatic, params: SystemParams, Hx, Hy, Px, Py,
                 vx, vy, epl, epd):
    """Starting positions by field type."""
    pos = positions_of(static, params)
    max_field = torch.sqrt(torch.max(params.x_fields**2 + params.y_fields**2))
    field_x = max_field * Hx
    field_y = max_field * Hy

    if static.field_type == "angle":
        if static.object_infinite:
            # start one EPD upstream of the first surface
            offset = epd - torch.min(pos[1:-1])
            x = -torch.tan(torch.deg2rad(field_x)) * (offset + epl)
            y = -torch.tan(torch.deg2rad(field_y)) * (offset + epl)
            z = pos[1] - offset
            x0 = Px * epd / 2.0 * vx + x
            y0 = Py * epd / 2.0 * vy + y
            z0 = z.expand(Px.shape)
        else:
            z0 = pos[0].expand(Px.shape)
            x0 = (-torch.tan(torch.deg2rad(field_x)) * (epl - pos[0])
                  ).expand(Px.shape)
            y0 = (-torch.tan(torch.deg2rad(field_y)) * (epl - pos[0])
                  ).expand(Px.shape)
        return x0, y0, z0

    if static.field_type == "object_height":
        if static.object_infinite:
            raise ValueError(
                "field type 'object_height' is invalid for an infinite object"
            )
        return (field_x.expand(Px.shape), field_y.expand(Px.shape),
                pos[0].expand(Px.shape))

    if static.field_type in ("paraxial_image_height", "real_image_height"):
        # field values are chief-ray image heights; convert them to
        # object-space angles (infinite object) or object heights by unit
        # chief-ray traces (reference
        # `field_types/paraxial_image_height.py:17-77`)
        y_img_unit, _ = px.unit_chief(static, params, "image")
        y_obj_unit, u_obj_unit = px.unit_chief(static, params, "object")
        unit = u_obj_unit if static.object_infinite else y_obj_unit
        val_x = unit * (field_x / y_img_unit)
        val_y = unit * (field_y / y_img_unit)
        if static.field_type == "real_image_height":
            val_x, val_y = _solve_per_field(
                static, params, Hx, Hy, val_x, val_y, field_x, field_y, epl,
                epd, pos)
        return _origins_from_field_params(
            static, params, val_x, val_y, Px, Py, vx, vy, epl, epd, pos)

    raise ValueError(f"Unsupported field type {static.field_type!r}")


def _origins_from_field_params(static, params, val_x, val_y, Px, Py, vx, vy,
                               epl, epd, pos):
    """Ray origins from solved per-ray field parameters: object-space
    angles (infinite object) or object heights (reference
    `field_types/real_image_height.py:174-203`)."""
    if static.object_infinite:
        offset = epd - torch.min(pos[1:-1])
        x = -val_x * (offset + epl)
        y = -val_y * (offset + epl)
        z = pos[1] - offset
        x0 = Px * epd / 2.0 * vx + x
        y0 = Py * epd / 2.0 * vy + y
        z0 = z.expand(Px.shape)
    else:
        x0 = val_x.expand(Px.shape)
        y0 = val_y.expand(Px.shape)
        z0 = pos[0].expand(Px.shape)
    return x0, y0, z0


def _solve_per_field(static, params, Hx, Hy, val_x, val_y, target_x,
                     target_y, epl, epd, pos):
    """`_solve_real_image_field` once per distinct field point (Hx, Hy),
    each ray given its field's solution: a ray's solve depends on its field
    alone, so every value is the one of a solve per ray, as JAX's, for a
    few rays' work. Where Hx or Hy carries a gradient, each ray keeps its
    own solve, so that each gets its own cotangent."""
    if Hx.requires_grad or Hy.requires_grad:
        return _solve_real_image_field(static, params, val_x, val_y,
                                       target_x, target_y, epl, epd, pos)
    fields_, inverse = torch.unique(torch.stack([Hx, Hy]), dim=1,
                                    return_inverse=True)
    first = torch.full((fields_.shape[1],), Hx.shape[0], dtype=torch.long,
                       device=Hx.device).scatter_reduce(
        0, inverse, torch.arange(Hx.shape[0], device=Hx.device), "amin")
    vx_u, vy_u = _solve_real_image_field(
        static, params, val_x[first], val_y[first], target_x[first],
        target_y[first], epl, epd, pos)
    return vx_u[inverse], vy_u[inverse]


def twice(*arrays):
    """Each array twice over, end to end: the batch of `newton_step`'s
    two forward-mode probes."""
    return tuple(torch.cat([a, a]) for a in arrays)


def newton_step(fx, qx, qy, reverse: bool = False):
    """The Newton step (dqx, dqy) of the residual fx(a, b) -> (ex, ey) at
    (qx, qy), each ray's 2x2 Jacobian, its determinant guarded at 1e-14 as
    JAX's. By default `fx` takes the batch twice over (`twice`): one
    `torch.func.jvp` carries the tangent of qx on the first copy and that
    of qy on the second, JAX's two forward-mode probes in one trace (the
    rays are independent, so each copy's values are those of a probe of
    its own), and the step stays in the autograd graph. With `reverse`,
    `fx` takes the batch once and the Jacobian comes from two
    vector-Jacobian products of the summed residuals: the same
    derivatives, at about a third of the probes' cost in PyTorch's eager
    mode, for values only (the step carries no graph)."""
    if reverse:
        with torch.enable_grad():
            a = qx.detach().requires_grad_(True)
            b = qy.detach().requires_grad_(True)
            ex, ey = fx(a, b)
            dex_dqx, dex_dqy = torch.autograd.grad(ex.sum(), (a, b),
                                                   retain_graph=True)
            dey_dqx, dey_dqy = torch.autograd.grad(ey.sum(), (a, b))
        ex, ey = ex.detach(), ey.detach()
    else:
        n = qx.shape[0]
        one, zero = torch.ones_like(qx), torch.zeros_like(qx)
        (ex, ey), (dex, dey) = torch.func.jvp(
            fx, twice(qx, qy), (torch.cat([one, zero]),
                                torch.cat([zero, one])))
        ex, ey = ex[:n], ey[:n]
        dex_dqx, dey_dqx, dex_dqy, dey_dqy = dex[:n], dey[:n], dex[n:], dey[n:]
    det = dex_dqx * dey_dqy - dex_dqy * dey_dqx
    det = torch.where(torch.abs(det) > 1e-14, det,
                      torch.full_like(det, 1e-14))
    return ((ex * dey_dqy - ey * dex_dqy) / det,
            (ey * dex_dqx - ex * dey_dqx) / det)


def _solve_real_image_field(static, params, val_x, val_y, target_x, target_y,
                            epl, epd, pos, iters: int = 8):
    """Refine the field parameters so that the real chief ray hits the
    target image height: JAX's fixed-count Newton (`iters` steps of
    `newton_step`, its Jacobian by forward-mode probes). It stays in the
    autograd graph, as JAX's `lax.scan` does."""
    from optiland_tpu_torch.trace import tracer as _tracer

    zeros = torch.zeros(2 * val_x.shape[0], dtype=val_x.dtype,
                        device=val_x.device)
    target_x, target_y = twice(target_x, target_y)

    def residual(vx_, vy_):
        x0, y0, z0 = _origins_from_field_params(
            static, params, vx_, vy_, zeros, zeros, zeros, zeros,
            epl, epd, pos)
        dx, dy, dz = -x0, -y0, epl - z0
        mag = torch.sqrt(dx * dx + dy * dy + dz * dz)
        mag = torch.where(mag < 1e-9, torch.ones_like(mag), mag)
        rays = make_rays(x0, y0, z0, dx / mag, dy / mag, dz / mag,
                         wavelength=params.wavelengths[
                             static.primary_wavelength_idx],
                         dtype=params.cv.dtype, device=params.cv.device)
        hist = _tracer.trace_rays(static, params, rays)
        return hist.x[-1] - target_x, hist.y[-1] - target_y

    for _ in range(iters):
        dvx, dvy = newton_step(residual, val_x, val_y)
        val_x, val_y = val_x - dvx, val_y - dvy
    return val_x, val_y


def generate_rays(static: SystemStatic, params: SystemParams, Hx, Hy, Px, Py,
                  wavelength, apply_vignetting: bool = True,
                  polarized: bool = False) -> Rays:
    """Aim rays at the paraxial entrance pupil and build the starting bundle.

    Hx/Hy/Px/Py are same-length 1-D tensors of normalized field and pupil
    coordinates; `wavelength` is a scalar or per-ray. `polarized` starts
    each ray's PRT matrix `p` at the identity (a polarized trace).
    """
    dt, dev = params.cv.dtype, params.cv.device

    def as1d(a):
        return torch.atleast_1d(torch.as_tensor(a, dtype=dt, device=dev))

    Hx, Hy, Px, Py = torch.broadcast_tensors(as1d(Hx), as1d(Hy), as1d(Px),
                                             as1d(Py))

    if apply_vignetting:
        vxf, vyf = vignetting_factors(static, params, Hx, Hy)
        vx, vy = 1.0 - vxf, 1.0 - vyf
    else:
        vx = vy = torch.ones_like(Px)

    epl = px.EPL(static, params)
    epd = px.EPD(static, params)

    x0, y0, z0 = _ray_origins(static, params, Hx, Hy, Px, Py, vx, vy, epl, epd)

    if static.telecentric:
        # object-space telecentric: every chief ray is axis-parallel; aim
        # at a per-ray pupil one NA cone away from the origin (reference
        # `rays/ray_aiming/paraxial.py:81-88`)
        sin_na = params.aperture_value
        x1 = Px * vx + x0
        y1 = Py * vy + y0
        z1 = torch.sqrt(1.0 - sin_na**2) / sin_na + z0
    else:
        # aim at the paraxial entrance pupil
        x1 = Px * epd * vx / 2.0
        y1 = Py * epd * vy / 2.0
        z1 = epl.expand(Px.shape)

    dx, dy, dz = x1 - x0, y1 - y0, z1 - z0
    mag = torch.sqrt(dx * dx + dy * dy + dz * dz)
    degenerate = mag < 1e-9
    mag = torch.where(degenerate, torch.ones_like(mag), mag)
    zero = torch.zeros_like(mag)
    L = torch.where(degenerate, zero, dx / mag)
    M = torch.where(degenerate, zero, dy / mag)
    N = torch.where(degenerate, torch.ones_like(mag), dz / mag)

    if static.apodization is not None:
        intensity = static.apodization.get_intensity(Px, Py)
    else:
        intensity = torch.ones_like(Px)
    rays = make_rays(x0, y0, z0, L, M, N, intensity=intensity,
                     wavelength=wavelength, dtype=dt, device=dev)
    if polarized:
        from optiland_tpu_torch.polarization.prt import complex_of, identity_prt

        rays = rays.replace(p=identity_prt(rays.x.shape[0], complex_of(dt),
                                           dev))
    return rays
