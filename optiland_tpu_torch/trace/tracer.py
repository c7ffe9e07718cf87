"""The real-ray trace in eager PyTorch, under autograd.

Port of `optiland_tpu/trace/tracer.py` for the ported surface and
interaction set: plane/conic/even/odd-asphere geometries, the freeform
families (poly-XY, biconic, toroidal, Chebyshev, Zernike, Forbes Q-bfs
and Q-2D) and the grid sag; refract, reflect,
none, the ideal thin lens, gratings on plane and curved carriers and phase
sheets (generalized Snell's law) of all five profile kinds; radial
apertures and aperture masks (`system/apertures.py`); tilt and decenter,
and absolute coordinate systems (`cs_pos`); Beer-Lambert absorption in
media with a tabulated extinction; BSDF scattering (`core/scatter.py`);
every coating: a simple coating scales the intensity, and in a polarized
trace (`polarization=` a `PolarizationState`) each surface composes its
Jones matrix (Fresnel, a thin-film stack, a polarizer, retarder or
diattenuator, or the identity) into each ray's PRT matrix. Per surface:
  localize -> intersect -> propagate -> OPD -> absorption -> aperture clip
  -> interact -> scatter -> coating -> globalize -> record.

It is the oracle of the port's CUDA kernels, and the path for everything
the kernel gates refuse, as XLA is in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from optiland_tpu_torch.core import rays as R
from optiland_tpu_torch.core import transforms as T
from optiland_tpu_torch.core.rays import Rays
from optiland_tpu_torch.geometry.surfaces import (
    _CLOSED_FORM,
    GEOM_GRID_SAG,
    GEOM_NURBS,
    GEOM_PLANE,
    SLICE_GEOMS,
    _conic_intersect,
    _grid_interp,
    intersect,
    intersect_implicit,
    sag_and_grad,
    surface_normal,
)
from optiland_tpu_torch.materials.dispersion import _interp, material_index
from optiland_tpu_torch.system.spec import (
    COAT_DIATTENUATOR,
    COAT_FRESNEL,
    COAT_LINEAR_POLARIZER,
    COAT_NONE,
    COAT_POLARIZER_H,
    COAT_POLARIZER_LCP,
    COAT_POLARIZER_RCP,
    COAT_POLARIZER_V,
    COAT_RETARDER,
    COAT_SIMPLE,
    COAT_THIN_FILM,
    INT_DIFFRACT,
    INT_NONE,
    INT_PHASE,
    INT_REFLECT,
    INT_REFRACT,
    INT_THIN_LENS,
    SystemParams,
    SystemStatic,
    positions_of,
)
from optiland_tpu_torch.trace.raygen import generate_rays


@dataclass(frozen=True)
class TraceHistory:
    """Per-surface ray records, shape (S, N) each, and `p`, the final
    (N, 3, 3) polarization ray-tracing matrices of a polarized trace (None
    for a scalar trace)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    L: torch.Tensor
    M: torch.Tensor
    N: torch.Tensor
    intensity: torch.Tensor
    opd: torch.Tensor
    p: torch.Tensor | None = None

    @property
    def num_surfaces(self) -> int:
        return self.x.shape[0]

    def final_rays(self, wavelength=None) -> Rays:
        """The last surface's rays as a bundle; `wavelength` (scalar or
        per-ray) fills `w`, else 0."""
        w = (torch.zeros_like(self.x[-1]) if wavelength is None
             else torch.as_tensor(wavelength, dtype=self.x.dtype,
                                  device=self.x.device))
        return Rays(x=self.x[-1], y=self.y[-1], z=self.z[-1],
                    L=self.L[-1], M=self.M[-1], N=self.N[-1],
                    i=self.intensity[-1], opd=self.opd[-1],
                    w=w.expand(self.x[-1].shape))


def _check_traceable(static: SystemStatic):
    """Refuse geometry codes the tracer does not know."""
    unknown = sorted({g for g in static.geom_codes if g not in SLICE_GEOMS})
    if unknown:
        raise ValueError(f"Unknown geometry codes {unknown}")


def _thin_lens_interact(rays: Rays, f, n1, n2) -> Rays:
    """Ideal thin-lens bending (JAX `tracer._thin_lens_interact`): the ray
    height is kept, the slopes (L/N, M/N) obey the ideal lens equation
    (n1 u - y / f) / n2, and the lens's quadratic phase -(x^2 + y^2) / 2f
    enters the OPD, so that a perfect lens images with zero wavefront
    error."""
    ux = rays.L / rays.N
    uy = rays.M / rays.N
    ux2 = (n1 * ux - rays.x / f) / n2
    uy2 = (n1 * uy - rays.y / f) / n2
    N2 = 1.0 / torch.sqrt(1.0 + ux2**2 + uy2**2)
    opd = rays.opd - (rays.x**2 + rays.y**2) / (2.0 * f)
    return rays.replace(L=ux2 * N2, M=uy2 * N2, N=N2, opd=opd)


def _grating_interact(static, params, k, rays: Rays, n1, n2) -> Rays:
    """Grating diffraction at surface k (JAX `tracer._grating_interact`):
    the grating vector from the groove orientation, the period corrected
    by its in-plane projection, then the vector grating equation
    (`rays.grating_diffract`). A plane grating takes f = (-sin a, cos a, 0)
    and the normal (0, 0, 1); a curved one f = -(n_up x t) / |n_up x t|,
    t the groove tangent lifted onto the sag, n_up the upward normal."""
    m = params.grating[k, 0]
    d = params.grating[k, 1]
    angle = params.grating[k, 2]
    code = static.geom_codes[k]
    one = torch.ones_like(rays.x)
    if code == GEOM_PLANE:
        nx = torch.zeros_like(rays.x)
        ny = torch.zeros_like(rays.x)
        nz = one
        fx = -torch.sin(angle) * one
        fy = torch.cos(angle) * one
        fz = torch.zeros_like(rays.x)
    else:
        nc, cv, conic, co, aux = (static.geom_n_coeffs[k], params.cv[k],
                                  params.conic[k], params.coeffs[k],
                                  static.geom_aux[k])
        nx, ny, nz = surface_normal(code, nc, rays.x, rays.y, cv, conic, co,
                                    aux)
        _, gx, gy = sag_and_grad(code, nc, rays.x, rays.y, cv, conic, co,
                                 aux)
        ca, sa = torch.cos(angle), torch.sin(angle)
        tx, ty, tz = ca, sa, gx * ca + gy * sa
        # surface_normal has nz < 0; f is built from the upward normal
        ux, uy, uz = -nx, -ny, -nz
        fx = uy * tz - uz * ty
        fy = uz * tx - ux * tz
        fz = ux * ty - uy * tx
        mag = torch.sqrt(fx * fx + fy * fy + fz * fz)
        fx, fy, fz = -fx / mag, -fy / mag, -fz / mag
    pp = d / torch.sqrt(fx * fx + fy * fy)
    return R.grating_diffract(rays, nx, ny, nz, fx, fy, fz, m, pp, n1, n2,
                              static.is_reflective[k])


def _aoi(nx, ny, nz, L, M, N):
    """The angle of incidence between a ray (L, M, N) and a surface normal,
    atan2(|k x n|, |k . n|). JAX takes arccos(clip(|k . n|, -1, 1)), the
    same angle up to rounding, but arccos loses a small angle to rounding
    (float32 rounds |k . n| to exactly 1 within ~3e-4 rad of the normal,
    many of 2M rays through the Cooke triplet at field 0) and its
    derivative -1 / sqrt(1 - x^2) is infinite there: the gradient of any
    merit through a Fresnel or thin-film coating was NaN. The cross
    product keeps the small angle, and its norm is floored at the dtype's
    tiny, so that a ray exactly along the normal (an on-axis chief ray)
    takes the derivative 0, which is exact there: |k . n| does not move to
    first order when two unit vectors are aligned."""
    c = torch.abs(nx * L + ny * M + nz * N)
    cx = M * nz - N * ny
    cy = N * nx - L * nz
    cz = L * ny - M * nx
    s2 = torch.clamp(cx * cx + cy * cy + cz * cz, min=torch.finfo(c.dtype).tiny)
    return torch.atan2(torch.sqrt(s2), c)


def _apply_coating(static, params, k, rays: Rays, k0_dirs, n1, n2) -> Rays:
    """The coating of surface k after its interaction (JAX
    `tracer._apply_coating`). A simple coating scales the intensity by T,
    or R after a reflection, and, as in the reference, leaves the PRT
    matrix without the surface's basis rotation. In a polarized trace
    every other surface composes O_out J O_in into each ray's PRT matrix:
    J the coating's Jones matrix (Fresnel or a thin-film stack at the
    ray's AOI and wavelength, a polarizer, retarder or diattenuator), or
    the identity without a coating. An unpolarized trace ignores all but
    the simple coating."""
    from optiland_tpu_torch.polarization import jones as J
    from optiland_tpu_torch.polarization.prt import surface_prt

    coat = static.coatings[k]
    interaction = static.interactions[k]
    if interaction == INT_NONE:
        return rays
    reflective = interaction == INT_REFLECT
    if coat == COAT_SIMPLE:
        cp = params.coating_params[k]
        return rays.replace(i=rays.i * (cp[1] if reflective else cp[0]))
    if rays.p is None:
        return rays

    k0 = torch.stack(k0_dirs, dim=-1)
    k1 = torch.stack([rays.L, rays.M, rays.N], dim=-1)
    cp = params.coating_params[k]

    def axis(theta):
        return [torch.cos(theta), torch.sin(theta), 0.0]

    if coat == COAT_NONE:
        jm = None
    elif coat in (COAT_FRESNEL, COAT_THIN_FILM):
        nx, ny, nz = surface_normal(
            static.geom_codes[k], static.geom_n_coeffs[k], rays.x, rays.y,
            params.cv[k], params.conic[k], params.coeffs[k],
            static.geom_aux[k])
        aoi = _aoi(nx, ny, nz, *k0_dirs)
        if coat == COAT_THIN_FILM:
            jm = static.thin_films[k].jones_matrices(k0, k1, rays.w, aoi,
                                                     reflect=reflective)
        else:
            jm = J.fresnel(k0, k1, aoi, n1, n2, reflect=reflective)
    elif coat == COAT_POLARIZER_H:
        jm = J.polarizer_h(k0, k1)
    elif coat == COAT_POLARIZER_V:
        jm = J.polarizer_v(k0, k1)
    elif coat == COAT_POLARIZER_RCP:
        jm = J.polarizer_rcp(k0, k1)
    elif coat == COAT_POLARIZER_LCP:
        jm = J.polarizer_lcp(k0, k1)
    elif coat == COAT_RETARDER:
        jm = J.linear_retarder(k0, k1, cp[0], axis(cp[1]))
    elif coat == COAT_DIATTENUATOR:
        jm = J.linear_diattenuator(k0, k1, cp[0], cp[1], axis(cp[2]))
    elif coat == COAT_LINEAR_POLARIZER:
        jm = J.linear_polarizer(k0, k1, axis(cp[0]))
    else:
        raise ValueError(f"Unknown coating code {coat}")
    p_surf = surface_prt(k0, k1, jm).to(rays.p.dtype)
    return rays.replace(p=torch.einsum("nij,njk->nik", p_surf, rays.p))


def _scatter(static, params, k, rays: Rays, base_seed, draws) -> Rays:
    """BSDF scattering at surface k (JAX: `scatter_directions` under
    `fold_in(scatter_key, k)`): the surface's own generator under
    `base_seed`, or the caller's uniforms `draws[k]`."""
    from optiland_tpu_torch.core.scatter import (
        scatter_directions,
        surface_generator,
    )

    b = static.bsdfs[k]
    nx, ny, nz = surface_normal(
        static.geom_codes[k], static.geom_n_coeffs[k], rays.x, rays.y,
        params.cv[k], params.conic[k], params.coeffs[k], static.geom_aux[k])
    d = None if draws is None else draws.get(k)
    g = None if d is not None else surface_generator(base_seed, k,
                                                     rays.x.device)
    L, M, N = scatter_directions(g, rays.L, rays.M, rays.N, nx, ny, nz,
                                 kind=b.kind, sigma=b.sigma, draws=d)
    return rays.replace(L=L, M=M, N=N)


def _base_seed(scatter) -> int:
    """The seed the surfaces' generators derive from: 0 for None, else one
    draw of the `torch.Generator`."""
    if scatter is None:
        return 0
    if not isinstance(scatter, torch.Generator):
        raise TypeError(f"scatter must be None or a torch.Generator, not "
                        f"{type(scatter).__name__}")
    return int(torch.randint(0, 1 << 62, (1,), generator=scatter,
                             device=scatter.device).item())


def _phase_interact(static, params, k, rays: Rays, n1, n2) -> Rays:
    """Generalized Snell's law for a thin phase sheet at surface k (JAX
    `tracer._phase_interact`, reference
    `interactions/phase_interaction_model.py:45-131`): the phase gradient
    and the incident wavevector n1 k0 l projected onto the carrier's
    tangent plane and added; the normal component rebuilt from |k_out| =
    n2 k0 (n2 = n1 on a mirror); an evanescent ray (R^2 < 0) keeps its
    direction with i = 0; the OPD takes -phi / k0. The JAX package's
    deliberate deviation from the reference is kept: the outgoing normal
    component follows sign(k_in . n), so transmission through a curved
    carrier continues forward."""
    from optiland_tpu_torch.trace.phase import phase_value_grad

    reflective = static.is_reflective[k]
    if reflective:
        n2 = n1
    k0 = 2.0 * math.pi / (rays.w * 1e-3)  # wavenumber in 1/mm
    nx, ny, nz = surface_normal(
        static.geom_codes[k], static.geom_n_coeffs[k], rays.x, rays.y,
        params.cv[k], params.conic[k], params.coeffs[k], static.geom_aux[k])
    phase, gx, gy = phase_value_grad(static, params, k, rays.x, rays.y,
                                     rays.w)
    gz = torch.zeros_like(gx)
    # tangential projections G = grad(phi) - (grad(phi).n) n and
    # k_par = k_in - (k_in.n) n
    g_dot_n = gx * nx + gy * ny + gz * nz
    Gx, Gy, Gz = gx - g_dot_n * nx, gy - g_dot_n * ny, gz - g_dot_n * nz
    kix = n1 * k0 * rays.L
    kiy = n1 * k0 * rays.M
    kiz = n1 * k0 * rays.N
    ki_dot_n = kix * nx + kiy * ny + kiz * nz
    kpx = kix - ki_dot_n * nx + Gx
    kpy = kiy - ki_dot_n * ny + Gy
    kpz = kiz - ki_dot_n * nz + Gz
    R_sq = (n2 * k0) ** 2 - (kpx**2 + kpy**2 + kpz**2)
    ok = R_sq >= 0.0
    alpha = torch.sqrt(torch.clamp(R_sq, min=0.0))
    # refraction keeps the incident normal component's sign, reflection
    # reverses it
    alpha = (-1.0 if reflective else 1.0) * torch.sign(ki_dot_n) * alpha
    k_out_x = kpx + alpha * nx
    k_out_y = kpy + alpha * ny
    k_out_z = kpz + alpha * nz
    mag = torch.sqrt(k_out_x**2 + k_out_y**2 + k_out_z**2)
    return rays.replace(
        L=torch.where(ok, k_out_x / mag, rays.L),
        M=torch.where(ok, k_out_y / mag, rays.M),
        N=torch.where(ok, k_out_z / mag, rays.N),
        i=torch.where(ok, rays.i, torch.zeros_like(rays.i)),
        opd=rays.opd - phase / k0,
    )


def trace_rays(static: SystemStatic, params: SystemParams, rays0: Rays,
               scatter=None, scatter_draws=None) -> TraceHistory:
    """Trace a starting bundle through all surfaces; row 0 of the history is
    the starting bundle. A bundle with PRT matrices (`rays0.p`) is traced
    polarized. BSDF surfaces draw from `scatter` (None: seed 0; or a
    `torch.Generator`, of which one draw seeds every surface's own
    generator), or take the uniforms of `scatter_draws[k]` ((u_r, u_t),
    each (budget, N); `core/scatter.py`)."""
    _check_traceable(static)
    base_seed = (_base_seed(scatter)
                 if any(b is not None for b in static.bsdfs) else 0)
    S = static.num_surfaces
    pos = positions_of(static, params)

    def n_of(k, w):
        return material_index(static.mat_formulas[k], static.mat_n_coeffs[k],
                              params.mat_coeffs[k], w)

    rays = rays0
    records = [rays0]

    for k in range(1, S):
        if static.has_abs_cs:
            tx = params.cs_pos[k, 0]
            ty = params.cs_pos[k, 1]
        else:
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
        # backward (the converged root, not the iteration chain); NURBS
        # takes its two-plane Newton directly, differentiated through its
        # fixed steps (JAX's tracer: its validity is the converged residual,
        # and the implicit backward's sag would be an inner Newton itself)
        code = static.geom_codes[k]
        aux = static.geom_aux[k]
        if (code in _CLOSED_FORM or static.geom_n_coeffs[k] == 0
                or code == GEOM_NURBS):
            t, valid = intersect(
                code, static.geom_n_coeffs[k],
                rays.x, rays.y, rays.z, rays.L, rays.M, rays.N,
                params.cv[k], params.conic[k], params.coeffs[k],
                newton_iters=static.newton_iters, aux=aux,
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
            if code == GEOM_GRID_SAG:
                _, _, _, oob = _grid_interp(
                    rays.x + t * rays.L, rays.y + t * rays.M,
                    params.coeffs[k], aux[0], aux[1])
                valid = valid & ~oob
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
            mask = (static.aperture_masks[k]
                    if k < len(static.aperture_masks) else None)
            if mask is not None:
                rays = R.clip(rays, mask.clip(rays.x, rays.y))
            else:
                r2 = rays.x**2 + rays.y**2
                rays = R.clip(rays, r2 > params.ap_radius[k] ** 2)

        k0_dirs = (rays.L, rays.M, rays.N)  # pre-interaction directions
        interaction = static.interactions[k]
        if interaction == INT_REFLECT:
            nx, ny, nz = surface_normal(
                code, static.geom_n_coeffs[k], rays.x, rays.y,
                params.cv[k], params.conic[k], params.coeffs[k], aux)
            rays = R.reflect(rays, nx, ny, nz)
        elif interaction == INT_REFRACT:
            nx, ny, nz = surface_normal(
                code, static.geom_n_coeffs[k], rays.x, rays.y,
                params.cv[k], params.conic[k], params.coeffs[k], aux)
            rays = R.refract(rays, nx, ny, nz, n_pre, n_of(k, rays.w))
        elif interaction == INT_THIN_LENS:
            rays = _thin_lens_interact(rays, params.focal_length[k], n_pre,
                                       n_of(k, rays.w))
        elif interaction == INT_DIFFRACT:
            rays = _grating_interact(static, params, k, rays, n_pre,
                                     n_of(k, rays.w))
        elif interaction == INT_PHASE:
            rays = _phase_interact(static, params, k, rays, n_pre,
                                   n_of(k, rays.w))

        if static.bsdfs[k] is not None:
            rays = _scatter(static, params, k, rays, base_seed, scatter_draws)

        rays = _apply_coating(static, params, k, rays, k0_dirs, n_pre,
                              n_of(k, rays.w))

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
                        intensity=stack("i"), opd=stack("opd"), p=rays.p)


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
                 polarization=None, scatter=None,
                 scatter_draws=None) -> TraceHistory:
    """Generate + aim + trace, returning the full (S, N) history; row 0 is
    the starting bundle. `wavelength` is a scalar or per-ray. On a CUDA
    device a `supports_fused` system goes to `trace_history_fused` (K7 in
    float32, its gradient through the eager trace), unless it is traced
    polarized, as JAX's gate sends it.

    `polarization`: None for a scalar trace, or a `PolarizationState`
    (`PolarizationState.unpolarized()` included) for a PRT trace: the
    final intensity row is then the PRT matrices' intensity for that state,
    masked by the traced intensity, so that clipped and TIR rays stay dark.
    `scatter` and `scatter_draws` feed the BSDF surfaces (`trace_rays`)."""
    rays0 = generate_rays(static, params, Hx, Hy, Px, Py, wavelength,
                          apply_vignetting=apply_vignetting,
                          polarized=polarization is not None)
    from optiland_tpu_torch.trace.fused import supports_fused, trace_history_fused

    if (polarization is None and supports_fused(static)
            and params.cv.is_cuda):
        return trace_history_fused(static, params, rays0)
    hist = trace_rays(static, params, rays0, scatter, scatter_draws)
    if polarization is None:
        return hist
    from optiland_tpu_torch.polarization.prt import intensity_from_prt

    k0 = torch.stack([rays0.L, rays0.M, rays0.N], dim=-1)
    i_pol = intensity_from_prt(hist.p, k0, rays0.i, polarization)
    mask = (hist.intensity[-1] > 0).to(i_pol.dtype)
    intensity = torch.cat([hist.intensity[:-1], (i_pol * mask)[None]])
    return dataclasses.replace(hist, intensity=intensity)
