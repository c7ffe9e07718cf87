"""The real-ray trace in eager PyTorch, under autograd.

Port of `optiland_tpu/trace/tracer.py` for the ported surface and
interaction set: plane/conic/even/odd-asphere geometries; refract, reflect
and none; radial apertures; tilt and decenter; Beer-Lambert absorption in
media with a tabulated extinction; simple coatings (the only coating that
acts on an unpolarized trace). Per surface:
  localize -> intersect -> propagate -> OPD -> absorption -> aperture clip
  -> interact -> coating -> globalize -> record.

It is the oracle of the port's CUDA kernels, and the path for everything
the kernel gates refuse, as XLA is in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from optiland_tpu_torch.core import rays as R
from optiland_tpu_torch.core import transforms as T
from optiland_tpu_torch.core.rays import Rays
from optiland_tpu_torch.geometry.surfaces import (
    _CLOSED_FORM,
    SLICE_GEOMS,
    _conic_intersect,
    intersect,
    intersect_implicit,
    surface_normal,
)
from optiland_tpu_torch.materials.dispersion import _interp, material_index
from optiland_tpu_torch.system.spec import (
    COAT_SIMPLE,
    INT_NONE,
    INT_REFLECT,
    INT_REFRACT,
    SystemParams,
    SystemStatic,
    positions_of,
)
from optiland_tpu_torch.trace.raygen import generate_rays


@dataclass(frozen=True)
class TraceHistory:
    """Per-surface ray records, shape (S, N) each."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    L: torch.Tensor
    M: torch.Tensor
    N: torch.Tensor
    intensity: torch.Tensor
    opd: torch.Tensor


def _check_traceable(static: SystemStatic):
    """Refuse what the eager tracer does not implement yet."""
    unported = []
    if any(g not in SLICE_GEOMS for g in static.geom_codes):
        unported.append("freeform geometries")
    if any(i not in (INT_REFRACT, INT_REFLECT, INT_NONE)
           for i in static.interactions):
        unported.append("thin-lens, grating and phase interactions")
    if static.has_abs_cs:
        unported.append("absolute coordinate systems")
    if any(b is not None for b in static.bsdfs):
        unported.append("BSDF scattering")
    if any(m is not None for m in static.aperture_masks):
        unported.append("aperture masks")
    if unported:
        raise NotImplementedError(
            "not ported yet (ROADMAP queue 1, slice 2): " + ", ".join(unported))


def trace_rays(static: SystemStatic, params: SystemParams,
               rays0: Rays) -> TraceHistory:
    """Trace a starting bundle through all surfaces; row 0 of the history is
    the starting bundle."""
    _check_traceable(static)
    S = static.num_surfaces
    pos = positions_of(static, params)

    def n_of(k, w):
        return material_index(static.mat_formulas[k], static.mat_n_coeffs[k],
                              params.mat_coeffs[k], w)

    rays = rays0
    records = [rays0]

    for k in range(1, S):
        tx = params.decenter[k, 0]
        ty = params.decenter[k, 1]
        tz = pos[k]
        tilted = static.has_tilt[k]
        decentered = static.has_decenter[k]

        if tilted:
            rays = T.localize(rays, tx, ty, tz, params.tilt[k, 0],
                              params.tilt[k, 1], params.tilt[k, 2])
        elif decentered:
            rays = rays.replace(x=rays.x - tx, y=rays.y - ty, z=rays.z - tz)
        else:
            rays = T.translate_z(rays, tz)

        # Newton-refined geometries take the implicit-function-theorem
        # backward (the converged root, not the iteration chain)
        code = static.geom_codes[k]
        if code in _CLOSED_FORM or static.geom_n_coeffs[k] == 0:
            t, valid = intersect(
                code, static.geom_n_coeffs[k],
                rays.x, rays.y, rays.z, rays.L, rays.M, rays.N,
                params.cv[k], params.conic[k], params.coeffs[k],
                newton_iters=static.newton_iters,
            )
        else:
            t = intersect_implicit(
                code, static.geom_n_coeffs[k], static.newton_iters,
                static.geom_aux[k], params.cv[k], params.conic[k],
                params.coeffs[k], rays.x, rays.y, rays.z,
                rays.L, rays.M, rays.N,
            )
            _, valid = _conic_intersect(rays.x, rays.y, rays.z, rays.L,
                                        rays.M, rays.N, params.cv[k],
                                        params.conic[k])
        n_pre = n_of(k - 1, rays.w)
        rays = R.propagate(rays, t)
        new_i = torch.where(valid, rays.i, torch.zeros_like(rays.i))
        if static.has_absorption[k - 1]:
            # Beer-Lambert through the medium before this surface, k(w)
            # interpolated from the material's tabulated extinction
            kv = _interp(rays.w, params.k_wl[k - 1], params.k_val[k - 1])
            alpha = 4.0 * math.pi * kv / rays.w
            new_i = new_i * torch.exp(-alpha * t * 1e3)
        rays = rays.replace(opd=rays.opd + torch.abs(t * n_pre), i=new_i)

        # physical aperture clip: zero intensity, keep tracing
        if static.has_aperture[k]:
            r2 = rays.x**2 + rays.y**2
            rays = R.clip(rays, r2 > params.ap_radius[k] ** 2)

        interaction = static.interactions[k]
        if interaction == INT_REFLECT:
            nx, ny, nz = surface_normal(
                code, static.geom_n_coeffs[k], rays.x, rays.y,
                params.cv[k], params.conic[k], params.coeffs[k])
            rays = R.reflect(rays, nx, ny, nz)
        elif interaction == INT_REFRACT:
            nx, ny, nz = surface_normal(
                code, static.geom_n_coeffs[k], rays.x, rays.y,
                params.cv[k], params.conic[k], params.coeffs[k])
            rays = R.refract(rays, nx, ny, nz, n_pre, n_of(k, rays.w))

        # fixed-R/T coating: intensity scale (T on refract, R on reflect);
        # polarization coatings do not act on an unpolarized trace
        if interaction != INT_NONE and static.coatings[k] == COAT_SIMPLE:
            cp = params.coating_params[k]
            rays = rays.replace(
                i=rays.i * (cp[1] if interaction == INT_REFLECT else cp[0]))

        if tilted:
            rays = T.globalize(rays, tx, ty, tz, params.tilt[k, 0],
                               params.tilt[k, 1], params.tilt[k, 2])
        elif decentered:
            rays = rays.replace(x=rays.x + tx, y=rays.y + ty, z=rays.z + tz)
        else:
            rays = T.untranslate_z(rays, tz)

        records.append(rays)

    def stack(name):
        return torch.stack([getattr(r, name) for r in records])

    return TraceHistory(x=stack("x"), y=stack("y"), z=stack("z"),
                        L=stack("L"), M=stack("M"), N=stack("N"),
                        intensity=stack("i"), opd=stack("opd"))


def _final(h: TraceHistory) -> dict:
    return dict(x=h.x[-1], y=h.y[-1], z=h.z[-1], L=h.L[-1], M=h.M[-1],
                N=h.N[-1], intensity=h.intensity[-1], opd=h.opd[-1])


def trace_system_final(static: SystemStatic, params: SystemParams, Hx, Hy,
                       Px, Py, wavelength, apply_vignetting: bool = True,
                       outputs=None):
    """Generate + aim + trace, returning only the final-surface state as a
    dict of x/y/z/L/M/N/intensity/opd tensors of shape (N,).

    On a CUDA device in float32, a system both fused gates accept runs as
    one kernel launch (K3, raygen fused into the chain); a system only
    `supports_fused` accepts goes to `trace_final` (K5, the chain on the
    caller's rays). Either kernel takes a scalar `wavelength` or per-ray
    ones (an array), as JAX's. Everything else is the eager trace."""
    from optiland_tpu_torch.trace.fused import (
        supports_fused,
        supports_fused_raygen,
        trace_final,
        trace_system_final_fused,
    )

    on_cuda = params.cv.is_cuda
    if (supports_fused(static) and supports_fused_raygen(static) and on_cuda
            and params.cv.dtype == torch.float32):
        return trace_system_final_fused(static, params, Hx, Hy, Px, Py,
                                        wavelength, outputs=outputs)
    rays0 = generate_rays(static, params, Hx, Hy, Px, Py, wavelength,
                          apply_vignetting=apply_vignetting)
    if supports_fused(static) and on_cuda:
        return trace_final(static, params, rays0, wavelength=wavelength)
    return _final(trace_rays(static, params, rays0))


def trace_system(static: SystemStatic, params: SystemParams, Hx, Hy, Px, Py,
                 wavelength, apply_vignetting: bool = True,
                 polarization=None) -> TraceHistory:
    """Generate + aim + trace, returning the full (S, N) history; row 0 is
    the starting bundle. `wavelength` is a scalar or per-ray. On a CUDA
    device a `supports_fused` system goes to `trace_history_fused` (K7 in
    float32, its gradient through the eager trace)."""
    if polarization is not None:
        raise NotImplementedError(
            "polarized traces are not ported yet (ROADMAP queue 1, item 15)")
    rays0 = generate_rays(static, params, Hx, Hy, Px, Py, wavelength,
                          apply_vignetting=apply_vignetting)
    from optiland_tpu_torch.trace.fused import supports_fused, trace_history_fused

    if supports_fused(static) and params.cv.is_cuda:
        return trace_history_fused(static, params, rays0)
    return trace_rays(static, params, rays0)
