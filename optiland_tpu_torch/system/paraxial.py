"""Paraxial (y-u) ray engine and first-order system properties.

Port of `optiland_tpu/system/paraxial.py`: every property is a small
differentiable function of `(static, params)`; nothing is cached.
"""

from __future__ import annotations

import torch

from optiland_tpu_torch.materials.dispersion import material_index
from optiland_tpu_torch.system.spec import (
    INT_REFLECT,
    INT_THIN_LENS,
    SystemParams,
    SystemStatic,
    positions_of,
)


def index_table(static: SystemStatic, params: SystemParams, wavelength):
    """Refractive index after each surface at `wavelength` -> (S,) tensor."""
    n = [
        material_index(static.mat_formulas[k], static.mat_n_coeffs[k],
                       params.mat_coeffs[k], wavelength)
        for k in range(static.num_surfaces)
    ]
    return torch.stack(n)


def trace_generic(static: SystemStatic, params: SystemParams, y, u, z,
                  wavelength, reverse: bool = False, skip: int = 0):
    """Trace a paraxial ray; returns (heights, slopes) stacked over surfaces
    `skip..S-1`. Mirrors: u' = -u - 2y/R; thin lens: u' = (n1 u - y/f)/n2;
    otherwise u' = (n1 u - y (n2 - n1)/R)/n2."""
    S = static.num_surfaces
    dt, dev = params.cv.dtype, params.cv.device
    y_ = torch.as_tensor(y, dtype=dt, device=dev)
    u_ = torch.as_tensor(u, dtype=dt, device=dev)
    z_ = torch.as_tensor(z, dtype=dt, device=dev)

    cv = params.cv
    pos = positions_of(static, params)
    n = index_table(static, params, wavelength)
    interactions = list(static.interactions)
    f_thin = params.focal_length
    object_rows = [k == 0 for k in range(S)]

    if reverse:
        cv = -torch.flip(cv, (0,))
        n = torch.flip(torch.roll(n, shifts=1), (0,))
        pos = pos[-1] - torch.flip(pos, (0,))
        interactions = interactions[::-1]
        f_thin = torch.flip(f_thin, (0,))
        object_rows = object_rows[::-1]

    heights = []
    slopes = []
    for k in range(skip, S):
        if object_rows[k]:
            heights.append(y_)
            slopes.append(u_)
            continue
        t = pos[k] - z_
        z_ = pos[k]
        y_ = y_ + t * u_
        n_prev = n[k - 1] if k > 0 else n[0]
        if interactions[k] == INT_REFLECT:
            u_ = -u_ - 2.0 * y_ * cv[k]
        elif interactions[k] == INT_THIN_LENS:
            u_ = (n_prev * u_ - y_ / f_thin[k]) / n[k]
        else:
            power = (n[k] - n_prev) * cv[k]
            u_ = (n_prev * u_ - y_ * power) / n[k]
        heights.append(y_)
        slopes.append(u_)

    return torch.stack(heights), torch.stack(slopes)


def _primary(static: SystemStatic, params: SystemParams):
    return params.wavelengths[static.primary_wavelength_idx]


def f1(static, params, wavelength=None):
    """Front focal length."""
    w = _primary(static, params) if wavelength is None else wavelength
    y, u = trace_generic(static, params, 1.0, 0.0, -1.0, w, reverse=True)
    return y[0] / u[-1]


def f2(static, params, wavelength=None):
    """Back (effective) focal length."""
    w = _primary(static, params) if wavelength is None else wavelength
    pos = positions_of(static, params)
    y, u = trace_generic(static, params, 1.0, 0.0, pos[1] - 1.0, w)
    return -y[0] / u[-1]


def F1(static, params, wavelength=None):
    """Front focal point, relative to the first surface."""
    w = _primary(static, params) if wavelength is None else wavelength
    y, u = trace_generic(static, params, 1.0, 0.0, -1.0, w, reverse=True,
                         skip=1)
    return y[-1] / u[-1]


def F2(static, params, wavelength=None):
    """Back focal point, relative to the image surface."""
    w = _primary(static, params) if wavelength is None else wavelength
    pos = positions_of(static, params)
    y, u = trace_generic(static, params, 1.0, 0.0, pos[1] - 1.0, w)
    return -y[-1] / u[-1]


def P1(static, params):
    """Front principal plane."""
    return F1(static, params) - f1(static, params)


def P2(static, params):
    """Back principal plane."""
    return F2(static, params) - f2(static, params)


def N1(static, params):
    """Front nodal plane."""
    return F1(static, params) + f2(static, params)


def N2(static, params):
    """Back nodal plane."""
    return F2(static, params) + f1(static, params)


def EPL(static: SystemStatic, params: SystemParams, wavelength=None):
    """Entrance pupil z location."""
    pos = positions_of(static, params)
    if static.stop_index == 1:
        return pos[1]
    w = _primary(static, params) if wavelength is None else wavelength
    stop = static.stop_index
    z0 = pos[-1] - pos[stop]
    skip = static.num_surfaces - stop
    y, u = trace_generic(static, params, 0.0, 0.1, z0, w, reverse=True,
                         skip=skip)
    return y[-1] / u[-1]


def XPL(static: SystemStatic, params: SystemParams, wavelength=None):
    """Exit pupil location relative to the image surface."""
    w = _primary(static, params) if wavelength is None else wavelength
    pos = positions_of(static, params)
    stop = static.stop_index
    y, u = trace_generic(static, params, 0.0, 0.1, pos[stop], w, skip=stop + 1)
    return -y[-1] / u[-1]


def EPD(static: SystemStatic, params: SystemParams, wavelength=None):
    """Entrance pupil diameter per system-aperture type."""
    ap = static.aperture_type
    value = params.aperture_value
    w = _primary(static, params) if wavelength is None else wavelength
    if ap == "EPD":
        return value
    if ap == "imageFNO":
        return f2(static, params, w) / value
    if ap == "objectNA":
        pos = positions_of(static, params)
        n0 = index_table(static, params, w)[0]
        u0 = torch.arcsin(value / n0)
        z = EPL(static, params, w) - pos[0]
        return 2.0 * z * torch.tan(u0)
    if ap == "float_by_stop":
        pos = positions_of(static, params)
        stop = static.stop_index
        if static.object_infinite:
            y, _ = trace_generic(static, params, 1.0, 0.0, -1.0, w)
            return value / y[stop]
        epl = EPL(static, params, w)
        y, _ = trace_generic(static, params, 0.0, 0.1, pos[0], w)
        u0 = 0.1 * value / y[stop]
        return u0 * (epl - pos[0])
    raise ValueError(f"Unknown aperture type {ap!r}")


def XPD(static, params, wavelength=None):
    """Exit pupil diameter."""
    ya, ua = marginal_ray(static, params, wavelength)
    return 2.0 * (ya[-1] + ua[-1] * XPL(static, params, wavelength))


def FNO(static, params, wavelength=None):
    if static.aperture_type == "imageFNO":
        return params.aperture_value
    return f2(static, params, wavelength) / EPD(static, params, wavelength)


def marginal_ray(static: SystemStatic, params: SystemParams, wavelength=None):
    """Axial ray through the stop edge."""
    w = _primary(static, params) if wavelength is None else wavelength
    epd = EPD(static, params, w)
    pos = positions_of(static, params)
    if static.object_infinite:
        ya, ua, obj_z = epd / 2.0, 0.0, pos[1] - 10.0
    else:
        obj_z = pos[0]
        ya = 0.0
        ua = epd / (2.0 * (EPL(static, params, w) - obj_z))
    return trace_generic(static, params, ya, ua, obj_z, w)


def chief_ray(static: SystemStatic, params: SystemParams, wavelength=None):
    """Full-field ray through the stop center."""
    w = _primary(static, params) if wavelength is None else wavelength
    pos = positions_of(static, params)
    stop = static.stop_index
    S = static.num_surfaces

    y_fwd, _ = trace_generic(static, params, 0.0, 0.1, pos[stop], w, skip=stop)
    y_img_unit = y_fwd[-1]
    y_rev, u_rev = trace_generic(
        static, params, 0.0, 0.1, pos[-1] - pos[stop], w, reverse=True,
        skip=S - stop,
    )
    y_obj_unit, u_obj_unit = y_rev[-1], u_rev[-1]

    scale = _chief_scale(static, params, y_obj_unit, u_obj_unit, y_img_unit)
    y_obj_start = -(y_obj_unit * scale)
    u_obj_start = u_obj_unit * scale

    if static.object_infinite:
        epl = EPL(static, params, w)
        y1 = u_obj_start * (pos[1] - epl)
        return trace_generic(static, params, y1, u_obj_start, pos[1], w)
    return trace_generic(static, params, y_obj_start, u_obj_start, pos[0], w)


def _chief_scale(static, params, y_obj_unit, u_obj_unit, y_img_unit):
    """Field-type-specific chief-ray scaling."""
    ft = static.field_type
    max_y = torch.max(params.y_fields)
    if ft == "angle":
        return torch.tan(torch.deg2rad(max_y)) / u_obj_unit
    if ft == "object_height":
        return max_y / y_obj_unit
    if ft in ("paraxial_image_height", "real_image_height"):
        return max_y / y_img_unit
    raise ValueError(f"Unsupported field type {ft!r}")


def unit_chief(static: SystemStatic, params: SystemParams, plane: str,
               wavelength=None):
    """(y, u) of a unit ray (y = 0, u = 1 at the stop) traced forward to
    the image plane (`plane="image"`) or in reverse to object space
    (reference `fields/field_types/paraxial_image_height.py:142-160`)."""
    w = _primary(static, params) if wavelength is None else wavelength
    pos = positions_of(static, params)
    stop = static.stop_index
    S = static.num_surfaces
    if plane == "image":
        y, u = trace_generic(static, params, 0.0, 1.0, pos[stop], w,
                             skip=stop)
    else:
        y, u = trace_generic(static, params, 0.0, 1.0, pos[-1] - pos[stop],
                             w, reverse=True, skip=S - stop)
    return y[-1], u[-1]


def magnification(static, params, wavelength=None):
    """Paraxial magnification n0 u0 / (n' u') of the marginal ray."""
    w = _primary(static, params) if wavelength is None else wavelength
    ya, ua = marginal_ray(static, params, w)
    n = index_table(static, params, w)
    return n[0] * ua[0] / (n[-1] * ua[-1])


def invariant(static, params, wavelength=None):
    """Lagrange invariant (reference `paraxial.py:303-314`)."""
    w = _primary(static, params) if wavelength is None else wavelength
    ya, ua = marginal_ray(static, params, w)
    yb, ub = chief_ray(static, params, w)
    n = index_table(static, params, w)
    return yb[1] * n[1] * ua[1] - ya[1] * n[1] * ub[1]
