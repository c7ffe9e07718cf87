"""Wavefront computation: OPD relative to a reference sphere at the exit pupil.

Port of `optiland_tpu/wavefront/core.py`: chief-ray trace, reference-sphere
construction, full-bundle trace, OPD normalization and pupil back-projection
as one tensor function of `(static, params)`, differentiable with respect
to every lens parameter on the eager path. On the card in float32 both
traces are launches of K7 (`tracer.trace_system`).

Strategies:
  - "chief_ray": reference sphere centered on the chief-ray image hit, radius
    = distance to the paraxial exit pupil.
  - "centroid_sphere": sphere centered on the intensity centroid of the spot.
  - "best_fit": least-squares sphere through the wavefront points.

With a polarization state the bundle is traced with PRT matrices (on the
eager path, as JAX's gate sends a polarized trace) and the exit-pupil E
fields come with the wavefront as `E_exits`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.system.spec import SystemParams, SystemStatic, positions_of
from optiland_tpu_torch.trace.raygen import vignetting_factors
from optiland_tpu_torch.trace.tracer import trace_system
from optiland_tpu_torch.zernike import lstsq

STRATEGIES = ("chief_ray", "centroid_sphere", "best_fit")


@dataclass(frozen=True)
class WavefrontData:
    """Wavefront at the exit pupil for one (field, wavelength): pupil-sphere
    intersection points, OPD in waves, per-ray intensity, the
    reference-sphere radius and its center (xc, yc, zc). `E_exits`: the
    exit-pupil E fields of a polarized trace, one (N, 3) complex array per
    incoherent polarization state, stacked to (n_states, N, 3); None for a
    scalar trace."""

    pupil_x: torch.Tensor
    pupil_y: torch.Tensor
    pupil_z: torch.Tensor
    opd: torch.Tensor  # in waves
    intensity: torch.Tensor
    radius: torch.Tensor
    E_exits: torch.Tensor | None = None
    center: torch.Tensor | None = None


def _sphere_path_length(x, y, z, L, M, N, xc, yc, zc, R):
    """Optical path from image-surface ray positions *backwards* along the ray
    to the reference sphere."""
    Lb, Mb, Nb = -L, -M, -N
    a = Lb * Lb + Mb * Mb + Nb * Nb
    b = 2.0 * (Lb * (x - xc) + Mb * (y - yc) + Nb * (z - zc))
    c = (x - xc) ** 2 + (y - yc) ** 2 + (z - zc) ** 2 - R * R
    d = b * b - 4.0 * a * c
    d = torch.where(d < 0.0, torch.zeros_like(d), d)
    sq = torch.sqrt(d)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return torch.where(t1 < 0.0, t2, t1)


def _tilt_correction(static: SystemStatic, params: SystemParams, Hx, Hy, Px, Py,
                     epd):
    """Launch-plane tilt term added to the OPD for angle fields with an
    infinite object."""
    if static.field_type != "angle" or not static.object_infinite:
        return torch.zeros_like(Px)
    max_field = torch.sqrt(torch.max(params.x_fields**2 + params.y_fields**2))
    fx = torch.deg2rad(Hx * max_field)
    fy = torch.deg2rad(Hy * max_field)
    tx, ty = torch.tan(fx), torch.tan(fy)
    uz = 1.0 / torch.sqrt(1.0 + tx * tx + ty * ty)
    ux, uy = tx * uz, ty * uz
    return ux * Px * epd / 2.0 + uy * Py * epd / 2.0


def wavefront_data(static: SystemStatic, params: SystemParams, Hx, Hy, Px, Py,
                   wavelength, strategy: str = "chief_ray",
                   polarization=None, aiming: str = "paraxial"
                   ) -> WavefrontData:
    """Compute the wavefront for one field over a pupil sample set, on the
    device and in the dtype of `params`.

    Hx/Hy are scalars (one field); Px/Py are (N,) normalized pupil coords.
    `aiming` is the optic's ray-aiming mode: "iterative" and "cached" aim
    the bundle and the chief ray with `aim_rays_iterative`, "robust" with
    `aim_rays_robust`, as the JAX package's `wavefront_data` does. With
    `polarization` (a `PolarizationState`, unpolarized included) the bundle
    is traced with PRT matrices and the exit E fields are `E_exits`.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"Unknown wavefront strategy {strategy!r}")
    dt, dev = params.cv.dtype, params.cv.device
    wavelength = torch.as_tensor(wavelength, dtype=dt, device=dev)
    n_img = px.index_table(static, params, wavelength)[-1]
    pos = positions_of(static, params)
    pupil_z = px.XPL(static, params) + pos[-1]
    epd = px.EPD(static, params)

    Hx, Hy, Px, Py = (torch.as_tensor(a, dtype=dt, device=dev)
                      for a in (Hx, Hy, Px, Py))

    # vignetting applied to pupil coords, as Optic.trace_generic does
    vxf, vyf = vignetting_factors(static, params, Hx[None], Hy[None])
    Pxv = Px * (1.0 - vxf[0])
    Pyv = Py * (1.0 - vyf[0])

    # ray aiming (the wide-angle lenses aim iteratively or robustly: a
    # paraxially aimed bundle misses their real pupil at large fields);
    # the chief ray is aimed too
    cqx = cqy = torch.zeros(1, dtype=dt, device=dev)
    if aiming in ("iterative", "cached", "robust"):
        from optiland_tpu_torch.trace import aiming as _aiming

        aim = (_aiming.aim_rays_robust if aiming == "robust"
               else _aiming.aim_rays_iterative)
        Pxv, Pyv = aim(static, params, Hx.expand(Px.shape),
                       Hy.expand(Px.shape), Pxv, Pyv, wavelength)
        cqx, cqy = aim(static, params, Hx[None], Hy[None], cqx, cqy,
                       wavelength)

    # chief ray
    ch = trace_system(static, params, Hx[None], Hy[None], cqx, cqy,
                      wavelength, apply_vignetting=False)
    cx, cy, cz = ch.x[-1, 0], ch.y[-1, 0], ch.z[-1, 0]
    c_opd = ch.opd[-1, 0]
    cL, cM, cN = ch.L[-1, 0], ch.M[-1, 0], ch.N[-1, 0]

    # full bundle
    full = trace_system(static, params, Hx.expand(Px.shape),
                        Hy.expand(Px.shape), Pxv, Pyv, wavelength,
                        apply_vignetting=False, polarization=polarization)
    E_exits = None
    if polarization is not None:
        from optiland_tpu_torch.polarization.prt import exit_fields

        k0 = torch.stack([full.L[0], full.M[0], full.N[0]], dim=-1)
        E_exits = torch.stack(exit_fields(full.p, k0, full.intensity[0],
                                          polarization))
    x, y, z = full.x[-1], full.y[-1], full.z[-1]
    L, M, N = full.L[-1], full.M[-1], full.N[-1]
    opd = full.opd[-1]
    intensity = full.intensity[-1]

    if strategy == "chief_ray":
        xc, yc, zc = cx, cy, cz
        R = torch.sqrt(cx**2 + cy**2 + (cz - pupil_z) ** 2)
    elif strategy == "centroid_sphere":
        wsum = torch.sum(intensity) + 1e-12
        xc = torch.sum(x * intensity) / wsum
        yc = torch.sum(y * intensity) / wsum
        zc = torch.sum(z * intensity) / wsum
        R = torch.sqrt(xc**2 + yc**2 + (zc - pupil_z) ** 2)
    else:  # best_fit
        # LSQ sphere through the wavefront point cloud: each ray is
        # back-projected from its image hit by its full accumulated OPD
        # (geometrized with the image-space index, after the launch-plane
        # tilt correction), then the algebraic sphere fit
        # |w|^2 = 2 c . w + (R^2 - |c|^2)
        opd_bf = opd + _tilt_correction(static, params, Hx, Hy, Px, Py, epd)
        t0 = opd_bf / n_img
        wx = x - t0 * L
        wy = y - t0 * M
        wz = z - t0 * N
        # vignetted rays are excluded by zeroing their rows (static shapes).
        # The live rows span a 2-D cap of a sphere, so the 4 columns stay
        # independent and the matrix has the full column rank that CUDA's
        # `gels` assumes.
        live = (intensity > 0).to(wx.dtype)
        A = torch.stack([wx, wy, wz, torch.ones_like(wx)], dim=-1) * live[:, None]
        b = (wx**2 + wy**2 + wz**2) * live
        sol = lstsq(A, b)
        xc, yc, zc = sol[0] / 2.0, sol[1] / 2.0, sol[2] / 2.0
        R = torch.sqrt(sol[3] + xc**2 + yc**2 + zc**2)

    # reference OPD from the chief ray (always vs the same sphere)
    opd_img_ref = n_img * _sphere_path_length(cx, cy, cz, cL, cM, cN,
                                              xc, yc, zc, R)
    opd_ref = c_opd - opd_img_ref
    zero = torch.zeros((), dtype=dt, device=dev)
    opd_ref = opd_ref + _tilt_correction(static, params, Hx, Hy, zero, zero,
                                         epd)

    t_img = _sphere_path_length(x, y, z, L, M, N, xc, yc, zc, R)
    opd_img = n_img * t_img
    opd_full = opd - opd_img
    opd_full = opd_full + _tilt_correction(static, params, Hx, Hy, Px, Py, epd)

    opd_waves = (opd_ref - opd_full) / (wavelength * 1e-3)

    t = opd_img / n_img
    return WavefrontData(
        pupil_x=x - t * L,
        pupil_y=y - t * M,
        pupil_z=z - t * N,
        opd=opd_waves,
        intensity=intensity,
        radius=R,
        E_exits=E_exits,
        center=torch.stack([xc, yc, zc]),
    )


def pupil_grid_coords(num_rays: int, dtype, device):
    """The (Px, Py) of a num_rays x num_rays square grid over [-1, 1]^2,
    row-major (`meshgrid` "xy"), and the mask of the points in the unit
    disk: the pupil sampling of the FFT and Huygens PSFs."""
    lin = torch.linspace(-1.0, 1.0, num_rays, dtype=dtype, device=device)
    X, Y = torch.meshgrid(lin, lin, indexing="xy")
    Px, Py = X.reshape(-1), Y.reshape(-1)
    return Px, Py, Px**2 + Py**2 <= 1.0

