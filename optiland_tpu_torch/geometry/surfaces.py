"""Surface geometry: sag, gradient, normal and ray intersection.

Port of `optiland_tpu/geometry/surfaces.py`. A geometry is a static integer
code plus a `(cv, k, coeffs)` parameter triple of tensors and, for some
families, static ints `aux`. Ported: plane, conic, even and odd aspheres
and poly-XY (hand-written gradients); biconic, toroidal, Chebyshev,
Zernike, Forbes Q-bfs and Q-2D (gradients by forward-mode AD of their sag,
as JAX's two JVPs, themselves differentiable by autograd); the tabulated
grid sag (bilinear, analytic cell gradients, a validity mask outside the
grid); NURBS (`geometry/nurbs.py`: the graph z(x, y) by the inverted (u,
v) chart, the intersection by the two-plane Newton).

Coefficient layouts (the per-surface `coeffs` row; `aux` static ints):
  POLYNOMIAL_XY: C_ij x^i y^j on a square (order+1)^2 grid, row-major
  BICONIC:   coeffs = [cvy, ky]; (cv, k) are the x-profile
  TOROIDAL:  (cv, k) = Y-Z curve; coeffs = [cv_rot, alpha_1..alpha_n]
             (alpha_i multiplies y^(2i))
  CHEBYSHEV: coeffs = [norm_x, norm_y, C_00..C_ij row-major]; aux = (rows, cols)
  ZERNIKE:   coeffs = [norm_radius, c_0..c_n]; aux = (type_code,), 0 fringe,
             1 noll, 2 standard
  FORBES_QBFS: coeffs = [norm_radius, a_0..a_N]; aux = ()
  FORBES_Q2D:  coeffs = [norm_radius, c_0..]; aux = ((n, m_signed), ...),
             m_signed > 0 a cos ('a') term, < 0 a sin ('b') term
  GRID_SAG:  coeffs = x_grid(nx) ++ y_grid(ny) ++ z(ny*nx row-major);
             aux = (nx, ny)
  NURBS:     coeffs = U(nu+p+1) ++ V(nv+q+1) ++ W(nu*nv) ++ Px ++ Py ++ Pz;
             aux = (p, q, nu, nv, x0, x1, y0, y1), the last four the
             patch's box
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

# geometries this package traces: all of the JAX package's
SLICE_GEOMS = (GEOM_PLANE, GEOM_CONIC, GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE,
               GEOM_POLYNOMIAL_XY, GEOM_BICONIC, GEOM_TOROIDAL,
               GEOM_CHEBYSHEV, GEOM_ZERNIKE, GEOM_FORBES_QBFS,
               GEOM_FORBES_Q2D, GEOM_GRID_SAG, GEOM_NURBS)
# the families whose gradient is forward-mode AD of their sag
FREEFORM_GEOMS = (GEOM_BICONIC, GEOM_TOROIDAL, GEOM_CHEBYSHEV, GEOM_ZERNIKE,
                  GEOM_FORBES_QBFS, GEOM_FORBES_Q2D)

# Geometry codes that are exactly a conic (closed-form intersection).
_CLOSED_FORM = (GEOM_PLANE, GEOM_CONIC)

_EPS = 1e-14

ZERNIKE_TYPE_CODES = {"fringe": 0, "noll": 1, "standard": 2}
_ZERNIKE_TYPES = {v: k for k, v in ZERNIKE_TYPE_CODES.items()}


def _unknown(code):
    return ValueError(f"Unknown geometry code {code}")


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


def _poly_xy_terms(x, y, coeffs, n_coeffs, grad: bool):
    """Freeform sum C_ij x^i y^j, the coefficients a square (order+1)^2
    grid flattened row-major (order = round(sqrt(n_coeffs)) - 1)."""
    order = int(round(n_coeffs**0.5)) - 1
    s = 0.0
    gx = 0.0
    gy = 0.0
    for i in range(order + 1):
        for j in range(order + 1):
            cij = coeffs[i * (order + 1) + j]
            s = s + cij * x**i * y**j
            if grad:
                if i > 0:
                    gx = gx + cij * i * x ** (i - 1) * y**j
                if j > 0:
                    gy = gy + cij * j * x**i * y ** (j - 1)
    if grad:
        return s, gx, gy
    return s


def _conic_1d(t, c, k):
    """1-D conic profile c t^2 / (1 + sqrt(1 - (1+k) c^2 t^2))."""
    t2 = t * t
    den = 1.0 + torch.sqrt(torch.clamp(1.0 - (1.0 + k) * c * c * t2, min=_EPS))
    return c * t2 / den


def _biconic_sag(x, y, cv, k, coeffs):
    return _conic_1d(x, cv, k) + _conic_1d(y, coeffs[0], coeffs[1])


def _toroidal_sag(x, y, cv, k, coeffs, n_coeffs):
    """z = R - sqrt((R - z_y)^2 - x^2), rationalized to curvature form
    (regular at cv_rot = 0): z = (2 z_y - c z_y^2 + c x^2) / (1 + sqrt(w)),
    w = (1 - c z_y)^2 - c^2 x^2."""
    z_y = _conic_1d(y, cv, k)
    y2 = y * y
    yp = y2
    for i in range(1, n_coeffs):
        z_y = z_y + coeffs[i] * yp
        yp = yp * y2
    c = coeffs[0]
    w = (1.0 - c * z_y) ** 2 - c * c * x * x
    w = torch.clamp(w, min=_EPS)
    return (2.0 * z_y - c * z_y * z_y + c * x * x) / (1.0 + torch.sqrt(w))


def _cheb_T(order: int, t):
    """Chebyshev T_0..T_order values at t by the recurrence."""
    Ts = [torch.ones_like(t), t]
    for _ in range(2, order + 1):
        Ts.append(2.0 * t * Ts[-1] - Ts[-2])
    return Ts[: order + 1]


def _chebyshev_sag(x, y, cv, k, coeffs, rows: int, cols: int):
    xn = x / coeffs[0]
    yn = y / coeffs[1]
    z = _conic_sag(x, y, cv, k)
    Tx = _cheb_T(rows - 1, xn)
    Ty = _cheb_T(cols - 1, yn)
    for i in range(rows):
        for j in range(cols):
            z = z + coeffs[2 + i * cols + j] * Tx[i] * Ty[j]
    return z


def _zernike_sag(x, y, cv, k, coeffs, n_coeffs: int, type_code: int):
    from optiland_tpu_torch import zernike as _z

    norm_radius = coeffs[0]
    z = _conic_sag(x, y, cv, k)
    zc = torch.stack([coeffs[1 + i] for i in range(n_coeffs - 1)])
    # Cartesian polynomial evaluation: smooth at the vertex, unlike the
    # (rho, phi) form whose atan2 derivative is singular at the origin
    return z + _z.evaluate_xy(_ZERNIKE_TYPES[type_code], zc, x / norm_radius,
                              y / norm_radius)


def _forbes_phi(r2, cv, k):
    """Forbes conic correction factor sqrt((1-kc^2r^2)/(1-(1+k)c^2r^2)),
    projecting the normal departure onto the sag axis."""
    c2r2 = cv * cv * r2
    num = torch.clamp(1.0 - k * c2r2, min=1e-12)
    den = torch.clamp(1.0 - (1.0 + k) * c2r2, min=1e-12)
    return torch.sqrt(num / den)


def _forbes_qbfs_sag(x, y, cv, k, coeffs, n_coeffs):
    """Forbes slope-orthogonal ('Qbfs') sag."""
    from optiland_tpu_torch.geometry import forbes as _fb

    r2 = x * x + y * y
    zb = _conic_sag(x, y, cv, k)
    if n_coeffs <= 1:
        return zb
    nr = coeffs[0]
    usq = r2 / (nr * nr)
    a = [coeffs[1 + i] for i in range(n_coeffs - 1)]
    S = usq * (1.0 - usq) * _forbes_phi(r2, cv, k) * _fb.qbfs_sum(a, usq)
    return zb + torch.where(usq > 1.0, torch.zeros_like(S), S)


def _forbes_q2d_sag(x, y, cv, k, coeffs, n_coeffs, nm_pairs):
    """Forbes Q2D freeform sag. The u^m cos(m theta) / sin(m theta)
    harmonics are Cartesian polynomials C_m + i S_m = ((x + i y)/r_norm)^m
    by the real recurrence, smooth at the vertex (no atan2)."""
    from optiland_tpu_torch.geometry import forbes as _fb

    r2 = x * x + y * y
    zb = _conic_sag(x, y, cv, k)
    if n_coeffs <= 1:
        return zb
    nr = coeffs[0]
    xn = x / nr
    yn = y / nr
    usq = r2 / (nr * nr)

    cm0: dict = {}
    a_by_m: dict = {}
    b_by_m: dict = {}
    for i, (n, ms) in enumerate(nm_pairs):
        c = coeffs[1 + i]
        if ms == 0:
            cm0[n] = c
        elif ms > 0:
            a_by_m.setdefault(ms, {})[n] = c
        else:
            b_by_m.setdefault(-ms, {})[n] = c

    total = torch.zeros_like(x)
    if cm0:
        n_top = max(cm0)
        cs = [cm0.get(n, 0.0) for n in range(n_top + 1)]
        total = total + usq * (1.0 - usq) * _fb.qbfs_sum(cs, usq)

    max_m = max(list(a_by_m) + list(b_by_m), default=0)
    Cm = torch.ones_like(x)
    Sm = torch.zeros_like(x)
    for m in range(1, max_m + 1):
        Cm, Sm = Cm * xn - Sm * yn, Sm * xn + Cm * yn
        term = torch.zeros_like(x)
        if m in a_by_m:
            n_top = max(a_by_m[m])
            cs = [a_by_m[m].get(n, 0.0) for n in range(n_top + 1)]
            term = term + Cm * _fb.q2d_sum(cs, m, usq)
        if m in b_by_m:
            n_top = max(b_by_m[m])
            cs = [b_by_m[m].get(n, 0.0) for n in range(n_top + 1)]
            term = term + Sm * _fb.q2d_sum(cs, m, usq)
        total = total + term

    S = _forbes_phi(r2, cv, k) * total
    return zb + torch.where(usq > 1.0, torch.zeros_like(S), S)


def _grid_slices(coeffs, nx: int, ny: int):
    xg = coeffs[0:nx]
    yg = coeffs[nx: nx + ny]
    zg = coeffs[nx + ny: nx + ny + nx * ny].reshape(ny, nx)
    return xg, yg, zg


def _grid_interp(x, y, coeffs, nx: int, ny: int):
    """Bilinear interpolation on the tabulated sag grid, its cell
    derivatives and the out-of-bounds mask (clamped to the edge cell; the
    mask feeds the intersection's validity)."""
    xg, yg, zg = _grid_slices(coeffs, nx, ny)
    i = torch.clamp(torch.searchsorted(xg.detach().contiguous(),
                                       x.detach().contiguous(), right=True)
                    - 1, 0, nx - 2)
    j = torch.clamp(torch.searchsorted(yg.detach().contiguous(),
                                       y.detach().contiguous(), right=True)
                    - 1, 0, ny - 2)
    x1, x2 = xg[i], xg[i + 1]
    y1, y2 = yg[j], yg[j + 1]
    z11, z12 = zg[j, i], zg[j, i + 1]
    z21, z22 = zg[j + 1, i], zg[j + 1, i + 1]
    dx = x2 - x1
    dy = y2 - y1
    tx = (x - x1) / dx
    ty = (y - y1) / dy
    z = (z11 * (1 - tx) + z12 * tx) * (1 - ty) + (z21 * (1 - tx) + z22 * tx) * ty
    gx = ((z12 - z11) * (1 - ty) + (z22 - z21) * ty) / dx
    gy = ((z21 - z11) * (1 - tx) + (z22 - z12) * tx) / dy
    oob = (x < xg[0]) | (x > xg[-1]) | (y < yg[0]) | (y > yg[-1])
    return z, gx, gy, oob


def _nurbs_slices(coeffs, aux):
    """A NURBS surface's (U, V, W, Px, Py, Pz) from its coefficient row,
    aux = (p, q, nu, nv, ...)."""
    p, q, nu, nv = aux[:4]
    lu, lv, n = nu + p + 1, nv + q + 1, nu * nv
    o = lu + lv
    return (coeffs[:lu], coeffs[lu:o], coeffs[o:o + n],
            coeffs[o + n:o + 2 * n], coeffs[o + 2 * n:o + 3 * n],
            coeffs[o + 3 * n:o + 4 * n])


def _nurbs_sag_and_grad(x, y, coeffs, aux):
    from optiland_tpu_torch.geometry import nurbs as _nb

    return _nb.sag_and_grad_xy(*_nurbs_slices(coeffs, aux), *aux[:4],
                               tuple(aux[4:8]), x, y)


def sag(code: int, n_coeffs: int, x, y, cv, k, coeffs, aux: tuple = ()):
    """Surface sag z(x, y). `code`, `n_coeffs` and `aux` are static."""
    if code == GEOM_PLANE:
        return torch.zeros_like(x + y)
    if code == GEOM_CONIC:
        return _conic_sag(x, y, cv, k)
    if code == GEOM_EVEN_ASPHERE:
        return _conic_sag(x, y, cv, k) + _even_asphere_terms(x, y, coeffs,
                                                             n_coeffs)
    if code == GEOM_ODD_ASPHERE:
        return _conic_sag(x, y, cv, k) + _odd_asphere_terms(x, y, coeffs,
                                                            n_coeffs)
    if code == GEOM_POLYNOMIAL_XY:
        return _conic_sag(x, y, cv, k) + _poly_xy_terms(x, y, coeffs,
                                                        n_coeffs, grad=False)
    if code == GEOM_BICONIC:
        return _biconic_sag(x, y, cv, k, coeffs)
    if code == GEOM_TOROIDAL:
        return _toroidal_sag(x, y, cv, k, coeffs, n_coeffs)
    if code == GEOM_CHEBYSHEV:
        return _chebyshev_sag(x, y, cv, k, coeffs, aux[0], aux[1])
    if code == GEOM_ZERNIKE:
        return _zernike_sag(x, y, cv, k, coeffs, n_coeffs, aux[0])
    if code == GEOM_FORBES_QBFS:
        return _forbes_qbfs_sag(x, y, cv, k, coeffs, n_coeffs)
    if code == GEOM_FORBES_Q2D:
        return _forbes_q2d_sag(x, y, cv, k, coeffs, n_coeffs, aux)
    if code == GEOM_GRID_SAG:
        return _grid_interp(x, y, coeffs, aux[0], aux[1])[0]
    if code == GEOM_NURBS:
        return _nurbs_sag_and_grad(x, y, coeffs, aux)[0]
    raise _unknown(code)


def sag_and_grad(code: int, n_coeffs: int, x, y, cv, k, coeffs, aux: tuple = ()):
    """(sag, d sag/dx, d sag/dy): hand-written gradients for the conic,
    aspheres and poly-XY, the grid's cell derivatives, and for the other
    freeform families two forward-mode JVPs of their sag (JAX's
    `jax.jvp`), which autograd differentiates again."""
    if code == GEOM_PLANE:
        z = torch.zeros_like(x + y)
        return z, z, z
    if code == GEOM_CONIC or (n_coeffs == 0 and code in (
            GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE, GEOM_POLYNOMIAL_XY)):
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
    if code == GEOM_POLYNOMIAL_XY:
        z = _conic_sag(x, y, cv, k)
        gx, gy = _conic_grad(x, y, cv, k)
        tz, tx, ty = _poly_xy_terms(x, y, coeffs, n_coeffs, grad=True)
        return z + tz, gx + tx, gy + ty
    if code == GEOM_GRID_SAG:
        z, gx, gy, _ = _grid_interp(x, y, coeffs, aux[0], aux[1])
        return z, gx, gy
    if code == GEOM_NURBS:
        return _nurbs_sag_and_grad(x, y, coeffs, aux)
    if code in FREEFORM_GEOMS:
        from torch.func import jvp

        x, y = torch.broadcast_tensors(x, y)

        def fn(xx, yy):
            return sag(code, n_coeffs, xx, yy, cv, k, coeffs, aux)

        z, gx = jvp(lambda xx: fn(xx, y), (x,), (torch.ones_like(x),))
        _, gy = jvp(lambda yy: fn(x, yy), (y,), (torch.ones_like(y),))
        return z, gx, gy
    raise _unknown(code)


def surface_normal(code: int, n_coeffs: int, x, y, cv, k, coeffs,
                   aux: tuple = ()):
    """Unit surface normal at (x, y), oriented with nz < 0."""
    _, gx, gy = sag_and_grad(code, n_coeffs, x, y, cv, k, coeffs, aux)
    mag = torch.sqrt(gx * gx + gy * gy + 1.0)
    return gx / mag, gy / mag, -1.0 / mag


def _conic_intersect(x, y, z, L, M, N, cv, k):
    """Closed-form ray/conic intersection in curvature form; the root
    nearest the vertex plane, with a linear fallback for A ~ 0.
    The two roots are q / A and C / q with q = -(B + sign(B) sqrt(disc)) / 2,
    which never subtracts sqrt(disc) from |B|: (-B +- sqrt(disc)) / 2A
    cancels where 4 |A C| << B^2, a ray that has come far to a shallow
    mirror (a telescope's primary loses ~1 mm in float32 that way). A ray
    that misses (disc < 0) takes the clamped double root -B / 2A, as the
    JAX package does, so its dark rows and any Newton seeded there match.
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
    q = -0.5 * (B + torch.where(B >= 0.0, sq, -sq))
    q_safe = torch.where(q != 0.0, q, one)
    t1 = q / A_safe
    t2 = torch.where((q != 0.0) & valid, C / q_safe, t1)
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
    for plane/conic (and coefficient-less aspheres and poly-XY), else the
    conic seed and `newton_iters` Newton updates on f(t) = sag(x + tL,
    y + tM) - (z + tN), with the eager safe-divide of JAX's `intersect`
    (|f'| <= 1e-14 becomes sign(f') 1e-14, and 1e-14 where f' = 0; the
    fused chain's takes 1e-12 for every |f'| <= 1e-12). A grid sag's rays
    that land outside its grid are invalid. A NURBS surface takes the
    two-plane Newton (`nurbs.intersect_two_plane`, `newton_iters` steps),
    valid where its residual closes. Returns (t, valid)."""
    if code not in SLICE_GEOMS:
        raise _unknown(code)
    if code == GEOM_NURBS:
        from optiland_tpu_torch.geometry import nurbs as _nb

        return _nb.intersect_two_plane(
            *_nurbs_slices(coeffs, aux), *aux[:4], tuple(aux[4:8]), x, y, z,
            L, M, N, iters=newton_iters)
    t, valid = _conic_intersect(x, y, z, L, M, N, cv, k)
    if code in _CLOSED_FORM or (n_coeffs == 0 and code in (
            GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE, GEOM_POLYNOMIAL_XY)):
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

    if code == GEOM_GRID_SAG:
        # rays landing outside the tabulated grid are invalid (masked)
        _, _, _, oob = _grid_interp(x + t * L, y + t * M, coeffs, aux[0],
                                    aux[1])
        valid = valid & ~oob
    return t, valid


class _IntersectImplicit(torch.autograd.Function):
    """Newton root whose backward is the implicit-function-theorem
    derivative of the converged root: t*(p) solves
    F(t, p) = sag(x + tL, y + tM; p) - (z + tN) = 0, so
    dt/dp = -(dF/dp) / (dF/dt)."""

    @staticmethod
    def forward(ctx, code, n_coeffs, newton_iters, aux, cv, k, coeffs,
                x, y, z, L, M, N):
        t, _ = intersect(code, n_coeffs, x, y, z, L, M, N, cv, k, coeffs,
                         newton_iters, aux)
        ctx.code, ctx.n_coeffs, ctx.aux = code, n_coeffs, aux
        ctx.save_for_backward(cv, k, coeffs, x, y, z, L, M, N, t)
        return t

    @staticmethod
    def backward(ctx, g):
        cv, k, coeffs, x, y, z, L, M, N, t = ctx.saved_tensors
        code, n_coeffs, aux = ctx.code, ctx.n_coeffs, ctx.aux
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(True)
                   for a in (cv, k, coeffs, x, y, z)]
            cv_, k_, co_, x_, y_, z_ = ins
            F = sag(code, n_coeffs, x_ + t * L, y_ + t * M, cv_, k_, co_,
                    aux) - (z_ + t * N)
        with torch.no_grad():
            _, gx, gy = sag_and_grad(code, n_coeffs, x + t * L, y + t * M,
                                     cv, k, coeffs, aux)
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
        return (None, None, None, None, *grads, d_L, d_M, d_N)


def intersect_implicit(code: int, n_coeffs: int, newton_iters: int,
                       aux: tuple, cv, k, coeffs, x, y, z, L, M, N):
    """Newton intersection differentiated through the converged root (IFT),
    not through the iteration chain."""
    return _IntersectImplicit.apply(code, n_coeffs, newton_iters, aux, cv, k,
                                    coeffs, x, y, z, L, M, N)
