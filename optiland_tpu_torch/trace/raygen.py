"""Ray generation: field/pupil coordinates -> starting ray bundle.

Port of `optiland_tpu/trace/raygen.py` for angle and object-height fields
with paraxial aiming. The paraxial EPL/EPD sub-traces are tensors in the
autograd graph, so merit gradients see the aiming's dependence on
thicknesses and curvatures.
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

    raise NotImplementedError(
        f"field type {static.field_type!r} is not ported yet (ROADMAP queue "
        "1, item 23)")


def generate_rays(static: SystemStatic, params: SystemParams, Hx, Hy, Px, Py,
                  wavelength, apply_vignetting: bool = True) -> Rays:
    """Aim rays at the paraxial entrance pupil and build the starting bundle.

    Hx/Hy/Px/Py are same-length 1-D tensors of normalized field and pupil
    coordinates; `wavelength` is a scalar or per-ray.
    """
    if static.apodization is not None or static.telecentric:
        raise NotImplementedError(
            "apodization and telecentric aiming are not ported yet (ROADMAP "
            "queue 1, item 13)")
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

    return make_rays(x0, y0, z0, L, M, N, intensity=torch.ones_like(Px),
                     wavelength=wavelength, dtype=dt, device=dev)
