"""Ray bundles and the ray-level physics primitives.

Port of `optiland_tpu/core/rays.py`: a `Rays` dataclass of same-shape
tensors plus pure functions that return new bundles. Conventions are the
JAX package's: normalized direction cosines, `clip` zeroes intensity but
keeps tracing, the normal is sign-aligned with the incident direction, and
total internal reflection and evanescent grating orders are masked
(intensity 0) instead of producing NaN.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Rays:
    """A batch of real rays (positions, direction cosines, intensity,
    optical path, wavelength in micrometers), and for a polarized trace
    `p`, each ray's (N, 3, 3) complex polarization ray-tracing matrix
    (None in a scalar trace)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    L: torch.Tensor
    M: torch.Tensor
    N: torch.Tensor
    i: torch.Tensor
    opd: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor | None = None

    @property
    def num_rays(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw) -> "Rays":
        return dataclasses.replace(self, **kw)


def make_rays(x, y, z, L, M, N, intensity=None, wavelength=None, dtype=None,
              device=None) -> Rays:
    """Build a ray bundle, broadcasting scalars to a common shape."""
    arrs = [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (x, y, z, L, M, N)]
    shape = torch.broadcast_shapes(*(a.shape for a in arrs))
    x, y, z, L, M, N = (a.expand(shape) for a in arrs)
    i = (torch.ones(shape, dtype=x.dtype, device=x.device)
         if intensity is None
         else torch.as_tensor(intensity, dtype=x.dtype,
                              device=x.device).expand(shape))
    w = (torch.full(shape, 0.55, dtype=x.dtype, device=x.device)
         if wavelength is None
         else torch.as_tensor(wavelength, dtype=x.dtype,
                              device=x.device).expand(shape))
    return Rays(x, y, z, L, M, N, i,
                torch.zeros(shape, dtype=x.dtype, device=x.device), w)


def propagate(rays: Rays, t) -> Rays:
    """Advance rays by distance t along their direction."""
    return rays.replace(
        x=rays.x + t * rays.L,
        y=rays.y + t * rays.M,
        z=rays.z + t * rays.N,
    )


def normalize(rays: Rays) -> Rays:
    mag = torch.sqrt(rays.L**2 + rays.M**2 + rays.N**2)
    return rays.replace(L=rays.L / mag, M=rays.M / mag, N=rays.N / mag)


def clip(rays: Rays, outside) -> Rays:
    """Zero the intensity where `outside` is True; rays keep tracing."""
    return rays.replace(i=torch.where(outside, torch.zeros_like(rays.i),
                                      rays.i))


def _align_normal(rays: Rays, nx, ny, nz):
    """Flip the normal to point along the incident direction; returns
    (nx, ny, nz, |cos(aoi)|)."""
    dot = rays.L * nx + rays.M * ny + rays.N * nz
    sgn = torch.sign(dot)
    return nx * sgn, ny * sgn, nz * sgn, torch.abs(dot)


def refract(rays: Rays, nx, ny, nz, n1, n2) -> Rays:
    """Vector Snell refraction; TIR rays keep their direction and get
    intensity 0."""
    u = n1 / n2
    nx, ny, nz, cosi = _align_normal(rays, nx, ny, nz)
    disc = 1.0 - u**2 * (1.0 - cosi**2)
    tir = disc < 0.0
    root = torch.sqrt(torch.where(tir, torch.zeros_like(disc), disc))
    tx = u * rays.L + nx * (root - u * cosi)
    ty = u * rays.M + ny * (root - u * cosi)
    tz = u * rays.N + nz * (root - u * cosi)
    return rays.replace(
        L=torch.where(tir, rays.L, tx),
        M=torch.where(tir, rays.M, ty),
        N=torch.where(tir, rays.N, tz),
        i=torch.where(tir, torch.zeros_like(rays.i), rays.i),
    )


def grating_diffract(rays: Rays, nx, ny, nz, fx, fy, fz, m, d, n1, n2,
                     is_reflective: bool) -> Rays:
    """Vector grating diffraction, in the tangential-momentum form

        out = (n1 d u0_t + m w f_t - n sqrt(Q)) / (d n2')

    with u0_t the tangential incident direction, f the (unit) grating
    vector, w the per-ray wavelength (um), d the local grating period (um),
    n2' = -n2 for reflection, and Q = d^2 n2^2 - |n1 d u0_t + m w f_t|^2.
    Evanescent orders (Q < 0) keep their direction and get intensity 0.
    The x and y components carry -n sqrt(Q) while z carries +nz sqrt(Q)
    (mirrored for reflection), then the direction is renormalized: the
    JAX package's sign convention, kept as it is."""
    nx, ny, nz, cosi = _align_normal(rays, nx, ny, nz)
    u_t = (rays.L - cosi * nx, rays.M - cosi * ny, rays.N - cosi * nz)
    fdotn = fx * nx + fy * ny + fz * nz
    f_t = (fx - fdotn * nx, fy - fdotn * ny, fz - fdotn * nz)

    n2c = -n2 if is_reflective else n2
    Tx = n1 * d * u_t[0] + m * rays.w * f_t[0]
    Ty = n1 * d * u_t[1] + m * rays.w * f_t[1]
    Tz = n1 * d * u_t[2] + m * rays.w * f_t[2]
    Q = d * d * n2 * n2 - (Tx * Tx + Ty * Ty + Tz * Tz)
    evanescent = Q < 0.0
    root = torch.sqrt(torch.where(evanescent, torch.zeros_like(Q), Q))
    den = d * n2c
    s = -1.0 if is_reflective else 1.0
    L = (Tx - nx * root) / den
    M = (Ty - ny * root) / den
    N = (Tz + s * nz * root) / den
    mag = torch.sqrt(L * L + M * M + N * N)
    return rays.replace(
        L=torch.where(evanescent, rays.L, L / mag),
        M=torch.where(evanescent, rays.M, M / mag),
        N=torch.where(evanescent, rays.N, N / mag),
        i=torch.where(evanescent, torch.zeros_like(rays.i), rays.i),
    )


def reflect(rays: Rays, nx, ny, nz) -> Rays:
    """Mirror reflection at a surface with normal (nx, ny, nz)."""
    nx, ny, nz, cosi = _align_normal(rays, nx, ny, nz)
    return rays.replace(
        L=rays.L - 2.0 * cosi * nx,
        M=rays.M - 2.0 * cosi * ny,
        N=rays.N - 2.0 * cosi * nz,
    )
