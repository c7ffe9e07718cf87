"""Surface geometry: sag, gradient, normal and ray intersection.

Port of `optiland_tpu/geometry/surfaces.py` for the geometries of the
first slice: plane, conic, even asphere and odd asphere. A geometry is a
static integer code plus a `(cv, k, coeffs)` parameter triple of tensors.
The other geometry codes are defined so that system tables carried across
from the JAX package keep their meaning; their sag raises
NotImplementedError until they are ported (ROADMAP queue 1, item 14).
"""

from __future__ import annotations

import torch

GEOM_PLANE = 0
GEOM_CONIC = 1
GEOM_EVEN_ASPHERE = 2
GEOM_ODD_ASPHERE = 3
GEOM_POLYNOMIAL_XY = 4
GEOM_BICONIC = 5
GEOM_TOROIDAL = 6
GEOM_CHEBYSHEV = 7
GEOM_ZERNIKE = 8
GEOM_FORBES_QBFS = 9
GEOM_FORBES_Q2D = 10
GEOM_GRID_SAG = 11
GEOM_NURBS = 12

# geometries this package traces
SLICE_GEOMS = (GEOM_PLANE, GEOM_CONIC, GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE)

# Geometry codes that are exactly a conic (closed-form intersection).
_CLOSED_FORM = (GEOM_PLANE, GEOM_CONIC)

_EPS = 1e-14


def _unported(code):
    return NotImplementedError(
        f"geometry code {code}: only plane, conic, even and odd aspheres are "
        "ported (other geometries: ROADMAP queue 1, item 14)")


def _conic_sag(x, y, cv, k):
    r2 = x * x + y * y
    den = 1.0 + torch.sqrt(torch.clamp(1.0 - (1.0 + k) * cv * cv * r2, min=_EPS))
    return cv * r2 / den


def _conic_grad(x, y, cv, k):
    """(d sag/dx, d sag/dy) of the conic: cv x / sqrt(1 - (1+k) cv^2 r^2)."""
    r2 = x * x + y * y
    root = torch.sqrt(torch.clamp(1.0 - (1.0 + k) * cv * cv * r2, min=_EPS))
    return cv * x / root, cv * y / root


def _even_asphere_terms(x, y, coeffs, n_coeffs):
    r2 = x * x + y * y
    s = 0.0
    rp = r2
    for i in range(n_coeffs):
        s = s + coeffs[i] * rp
        rp = rp * r2
    return s


def _even_asphere_grad_terms(x, y, coeffs, n_coeffs):
    r2 = x * x + y * y
    g = 0.0
    rp = torch.ones_like(r2)
    for i in range(n_coeffs):
        g = g + 2.0 * (i + 1) * coeffs[i] * rp
        rp = rp * r2
    return x * g, y * g


def _odd_asphere_terms(x, y, coeffs, n_coeffs):
    r = torch.sqrt(x * x + y * y)
    s = 0.0
    rp = r
    for i in range(n_coeffs):
        s = s + coeffs[i] * rp
        rp = rp * r
    return s


def _odd_asphere_grad_terms(x, y, coeffs, n_coeffs):
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=_EPS))
    g = 0.0
    rp = torch.ones_like(r)
    for i in range(n_coeffs):
        g = g + (i + 1) * coeffs[i] * rp
        rp = rp * r
    return x / r * g, y / r * g


def sag(code: int, n_coeffs: int, x, y, cv, k, coeffs, aux: tuple = ()):
    """Surface sag z(x, y). `code` and `n_coeffs` are static."""
    if code == GEOM_PLANE:
        return torch.zeros_like(x + y)
    base = _conic_sag(x, y, cv, k)
    if code == GEOM_CONIC:
        return base
    if code == GEOM_EVEN_ASPHERE:
        return base + _even_asphere_terms(x, y, coeffs, n_coeffs)
    if code == GEOM_ODD_ASPHERE:
        return base + _odd_asphere_terms(x, y, coeffs, n_coeffs)
    raise _unported(code)


def sag_and_grad(code: int, n_coeffs: int, x, y, cv, k, coeffs, aux: tuple = ()):
    """(sag, d sag/dx, d sag/dy) with the analytic gradients."""
    if code == GEOM_PLANE:
        z = torch.zeros_like(x + y)
        return z, z, z
    if code == GEOM_CONIC or (n_coeffs == 0 and code in (GEOM_EVEN_ASPHERE,
                                                        GEOM_ODD_ASPHERE)):
        z = _conic_sag(x, y, cv, k)
        gx, gy = _conic_grad(x, y, cv, k)
        return z, gx, gy
    if code == GEOM_EVEN_ASPHERE:
        z = _conic_sag(x, y, cv, k)
        gx, gy = _conic_grad(x, y, cv, k)
        tz = _even_asphere_terms(x, y, coeffs, n_coeffs)
        tx, ty = _even_asphere_grad_terms(x, y, coeffs, n_coeffs)
        return z + tz, gx + tx, gy + ty
    if code == GEOM_ODD_ASPHERE:
        z = _conic_sag(x, y, cv, k)
        gx, gy = _conic_grad(x, y, cv, k)
        tz = _odd_asphere_terms(x, y, coeffs, n_coeffs)
        tx, ty = _odd_asphere_grad_terms(x, y, coeffs, n_coeffs)
        return z + tz, gx + tx, gy + ty
    raise _unported(code)


def surface_normal(code: int, n_coeffs: int, x, y, cv, k, coeffs,
                   aux: tuple = ()):
    """Unit surface normal at (x, y), oriented with nz < 0."""
    _, gx, gy = sag_and_grad(code, n_coeffs, x, y, cv, k, coeffs, aux)
    mag = torch.sqrt(gx * gx + gy * gy + 1.0)
    return gx / mag, gy / mag, -1.0 / mag


def _conic_intersect(x, y, z, L, M, N, cv, k):
    """Closed-form ray/conic intersection in curvature form; the root
    nearest the vertex plane, with a linear fallback for A ~ 0.
    Returns (t, valid)."""
    kk = 1.0 + k
    A = cv * (L * L + M * M + kk * N * N)
    B = 2.0 * (cv * (L * x + M * y + kk * N * z) - N)
    C = cv * (x * x + y * y + kk * z * z) - 2.0 * z

    disc = B * B - 4.0 * A * C
    valid = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    one = torch.ones_like(A)
    big = torch.abs(A) > _EPS
    A_safe = torch.where(big, A, one)
    t1 = (-B + sq) / (2.0 * A_safe)
    t2 = (-B - sq) / (2.0 * A_safe)
    z1 = z + t1 * N
    z2 = z + t2 * N
    t_quad = torch.where(torch.abs(z1) <= torch.abs(z2), t1, t2)

    B_safe = torch.where(torch.abs(B) > _EPS, B, _EPS * one)
    t_lin = -C / B_safe
    t = torch.where(big, t_quad, t_lin)
    valid = torch.where(big, valid, torch.ones_like(valid))
    return t, valid


def intersect(code: int, n_coeffs: int, x, y, z, L, M, N, cv, k, coeffs,
              newton_iters: int = 16, aux: tuple = ()):
    """Distance t from ray origin to the surface (local frame): closed form
    for plane/conic, conic seed + fixed-count Newton for aspheres.
    Returns (t, valid)."""
    if code not in SLICE_GEOMS:
        raise _unported(code)
    t, valid = _conic_intersect(x, y, z, L, M, N, cv, k)
    if code in _CLOSED_FORM or n_coeffs == 0:
        return t, valid

    for _ in range(newton_iters):
        xt = x + t * L
        yt = y + t * M
        zt = z + t * N
        s, gx, gy = sag_and_grad(code, n_coeffs, xt, yt, cv, k, coeffs, aux)
        f = s - zt
        fp = gx * L + gy * M - N
        fp = torch.where(torch.abs(fp) > _EPS, fp,
                         torch.sign(fp) * _EPS + (fp == 0).to(fp.dtype) * _EPS)
        t = t - f / fp
    return t, valid


class _IntersectImplicit(torch.autograd.Function):
    """Newton root whose backward is the implicit-function-theorem
    derivative of the converged root: t*(p) solves
    F(t, p) = sag(x + tL, y + tM; p) - (z + tN) = 0, so
    dt/dp = -(dF/dp) / (dF/dt)."""

    @staticmethod
    def forward(ctx, code, n_coeffs, newton_iters, cv, k, coeffs,
                x, y, z, L, M, N):
        t, _ = intersect(code, n_coeffs, x, y, z, L, M, N, cv, k, coeffs,
                         newton_iters)
        ctx.code, ctx.n_coeffs = code, n_coeffs
        ctx.save_for_backward(cv, k, coeffs, x, y, z, L, M, N, t)
        return t

    @staticmethod
    def backward(ctx, g):
        cv, k, coeffs, x, y, z, L, M, N, t = ctx.saved_tensors
        code, n_coeffs = ctx.code, ctx.n_coeffs
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(True)
                   for a in (cv, k, coeffs, x, y, z)]
            cv_, k_, co_, x_, y_, z_ = ins
            F = sag(code, n_coeffs, x_ + t * L, y_ + t * M, cv_, k_, co_) \
                - (z_ + t * N)
            _, gx, gy = sag_and_grad(code, n_coeffs, x + t * L, y + t * M,
                                     cv, k, coeffs)
            ft = gx * L + gy * M - N
            ft = torch.where(torch.abs(ft) > _EPS, ft, _EPS * torch.ones_like(ft))
            lam = -g / ft
            grads = torch.autograd.grad(F, ins, grad_outputs=lam,
                                        allow_unused=True)
        grads = [torch.zeros_like(a) if gr is None else gr
                 for a, gr in zip((cv, k, coeffs, x, y, z), grads)]
        d_L = lam * gx * t
        d_M = lam * gy * t
        d_N = lam * (-t)
        return (None, None, None, *grads, d_L, d_M, d_N)


def intersect_implicit(code: int, n_coeffs: int, newton_iters: int,
                       aux: tuple, cv, k, coeffs, x, y, z, L, M, N):
    """Newton intersection differentiated through the converged root (IFT),
    not through the iteration chain."""
    return _IntersectImplicit.apply(code, n_coeffs, newton_iters, cv, k,
                                    coeffs, x, y, z, L, M, N)
