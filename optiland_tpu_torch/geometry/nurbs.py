"""NURBS surfaces: basis functions, point and derivative evaluation, the
inversion of the (x, y) chart and the ray intersection.

Port of `optiland_tpu/geometry/nurbs.py`. A NURBS surface takes the eager
trace only: the fused kernels refuse it, as JAX's `supports_fused` does.

  - basis and derivative evaluation (Piegl & Tiller A2.2 and the
    degree-reduction derivative identity), unrolled over the static degree,
    the knot span found by `searchsorted`;
  - the (u, v) Newton runs a fixed count of iterations, clamped to the
    parameter square [0, 1]^2 instead of restarted at random, with JAX's
    clamp, `minimum(maximum(.))`, whose derivative splits a tie evenly
    (`_clip`);
  - fitting a conic with a NURBS patch is a host-side numpy least-squares
    fit on a Greville-anchored control net.

Surface model: S(u, v) = sum_ij N_i(u) N_j(v) w_ij P_ij / sum_ij N_i N_j
w_ij, the control points as three (nu nv,) arrays in u-major order.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-14


def _clip(t, lo: float, hi: float):
    """min(max(t, lo), hi) as JAX's `jnp.clip` takes it: at t == lo or t ==
    hi the derivative is 1/2 (`torch.maximum` and `torch.minimum` split a
    tie evenly, as `jnp.maximum` and `jnp.minimum` do; `torch.clamp` would
    pass it whole)."""
    return torch.minimum(torch.maximum(t, torch.full_like(t, lo)),
                         torch.full_like(t, hi))


def _safe(den):
    """den where |den| > 1e-14, else 1."""
    return torch.where(torch.abs(den) > _EPS, den, torch.ones_like(den))


def find_span(knots, degree: int, n_ctrl: int, t):
    """Knot span index i with knots[i] <= t < knots[i+1], clipped to the
    valid range [degree, n_ctrl - 1] (so t at the domain's ends counts)."""
    span = torch.searchsorted(knots.detach().contiguous(),
                              t.detach().contiguous(), right=True) - 1
    return torch.clamp(span, degree, n_ctrl - 1)


def basis_funs(knots, degree: int, span, t):
    """The nonzero basis values [N_{span-degree,p}, ..., N_{span,p}] at t
    (Piegl & Tiller A2.2, unrolled over the static degree)."""
    left = {}
    right = {}
    N = [torch.ones_like(t)]
    for j in range(1, degree + 1):
        left[j] = t - knots[span + 1 - j]
        right[j] = knots[span + j] - t
        saved = torch.zeros_like(t)
        new_N = []
        for r in range(j):
            temp = N[r] / _safe(right[r + 1] + left[j - r])
            new_N.append(saved + right[r + 1] * temp)
            saved = left[j - r] * temp
        new_N.append(saved)
        N = new_N
    return N


def basis_and_deriv(knots, degree: int, span, t):
    """(N, dN): the nonzero basis values and their first derivatives at t,
    N'_{i,p} = p [N_{i,p-1} / (U_{i+p} - U_i) - N_{i+1,p-1} / (U_{i+p+1} -
    U_{i+1})]."""
    N = basis_funs(knots, degree, span, t)
    if degree == 0:
        return N, [torch.zeros_like(t)]
    Nm = basis_funs(knots, degree - 1, span, t)
    dN = []
    for r in range(degree + 1):
        i = span - degree + r
        if r >= 1:
            a = Nm[r - 1] / _safe(knots[i + degree] - knots[i])
        else:
            a = torch.zeros_like(t)
        if r <= degree - 1:
            b = Nm[r] / _safe(knots[i + degree + 1] - knots[i + 1])
        else:
            b = torch.zeros_like(t)
        dN.append(degree * (a - b))
    return N, dN


def surface_eval(U, V, W, Px, Py, Pz, p: int, q: int, nu: int, nv: int,
                 u, v, derivs: bool = True):
    """S(u, v) and, with `derivs`, S_u and S_v at per-ray (u, v), each a
    tuple (x, y, z) of per-ray arrays; the control arrays are flattened
    (nu nv,) in u-major order."""
    su = find_span(U, p, nu, u)
    sv = find_span(V, q, nv, v)
    if derivs:
        Bu, dBu = basis_and_deriv(U, p, su, u)
        Bv, dBv = basis_and_deriv(V, q, sv, v)
    else:
        Bu, Bv = basis_funs(U, p, su, u), basis_funs(V, q, sv, v)
    zero = torch.zeros_like(u)
    num = [zero, zero, zero]
    den = zero
    num_u = [zero, zero, zero]
    den_u = zero
    num_v = [zero, zero, zero]
    den_v = zero
    P3 = (Px, Py, Pz)
    for a in range(p + 1):
        iu = su - p + a
        for b in range(q + 1):
            idx = iu * nv + (sv - q + b)
            w_ab = W[idx]
            bb = Bu[a] * Bv[b] * w_ab
            Pg = [P3[c][idx] for c in range(3)]
            for c in range(3):
                num[c] = num[c] + bb * Pg[c]
            den = den + bb
            if derivs:
                bu = dBu[a] * Bv[b] * w_ab
                bv = Bu[a] * dBv[b] * w_ab
                for c in range(3):
                    num_u[c] = num_u[c] + bu * Pg[c]
                    num_v[c] = num_v[c] + bv * Pg[c]
                den_u = den_u + bu
                den_v = den_v + bv
    den_safe = _safe(den)
    S = tuple(n / den_safe for n in num)
    if not derivs:
        return S, None, None
    S_u = tuple((num_u[c] - S[c] * den_u) / den_safe for c in range(3))
    S_v = tuple((num_v[c] - S[c] * den_v) / den_safe for c in range(3))
    return S, S_u, S_v


def _safe_det(det):
    """det where |det| > 1e-14, else +-1e-14 by its sign (+ at 0)."""
    eps = torch.full_like(det, _EPS)
    return torch.where(torch.abs(det) > _EPS, det,
                       torch.where(det >= 0, eps, -eps))


def _solve2(a, b, c, d, r1, r2):
    """[[a, b], [c, d]] [du, dv] = [r1, r2] per ray, the determinant kept
    off 0."""
    det = _safe_det(a * d - b * c)
    return (d * r1 - b * r2) / det, (a * r2 - c * r1) / det


def invert_xy(U, V, W, Px, Py, Pz, p, q, nu, nv, box, x, y, iters: int = 8):
    """Newton inversion of the (x, y) chart: (u, v) with S_xy(u, v) = (x,
    y), from the affine guess over `box` = (x0, x1, y0, y1) (static
    floats), clamped to [0, 1] at each step."""
    x0, x1, y0, y1 = box
    u = _clip((x - x0) / max(x1 - x0, _EPS), 0.0, 1.0)
    v = _clip((y - y0) / max(y1 - y0, _EPS), 0.0, 1.0)
    for _ in range(iters):
        S, S_u, S_v = surface_eval(U, V, W, Px, Py, Pz, p, q, nu, nv, u, v)
        du, dv = _solve2(S_u[0], S_v[0], S_u[1], S_v[1], S[0] - x, S[1] - y)
        u = _clip(u - du, 0.0, 1.0)
        v = _clip(v - dv, 0.0, 1.0)
    return u, v


def sag_and_grad_xy(U, V, W, Px, Py, Pz, p, q, nu, nv, box, x, y,
                    iters: int = 8):
    """(z, dz/dx, dz/dy) of the NURBS graph z(x, y) at the inverted (u, v):
    [dz/dx, dz/dy] = [z_u, z_v] [[x_u, x_v], [y_u, y_v]]^-1."""
    u, v = invert_xy(U, V, W, Px, Py, Pz, p, q, nu, nv, box, x, y, iters)
    S, S_u, S_v = surface_eval(U, V, W, Px, Py, Pz, p, q, nu, nv, u, v)
    a, b, c, d = S_u[0], S_v[0], S_u[1], S_v[1]
    det = _safe_det(a * d - b * c)
    gx = (S_u[2] * d - S_v[2] * c) / det
    gy = (-S_u[2] * b + S_v[2] * a) / det
    return S[2], gx, gy


def intersect_two_plane(U, V, W, Px, Py, Pz, p, q, nu, nv, box,
                        x, y, z, L, M, N, iters: int = 12):
    """The ray's hit on the NURBS surface by the two-plane Newton (the ray
    as two planes with normals n1, n2; Newton solves n1.S + d1 = 0, n2.S +
    d2 = 0 in (u, v)), a fixed `iters` steps clamped to the unit square.
    Returns (t, valid): t the signed projection of S - P0 on the ray, valid
    where the residual is below 1e-4 of the point's scale."""
    mask = (L > M) & (L > N)
    one = torch.ones_like(L)
    mag_lm = torch.sqrt(L * L + M * M)
    mag_nm = torch.sqrt(N * N + M * M)
    mag_lm = torch.where(mag_lm > _EPS, mag_lm, one)
    mag_nm = torch.where(mag_nm > _EPS, mag_nm, one)
    zero = torch.zeros_like(L)
    n1x = torch.where(mask, M / mag_lm, zero)
    n1y = torch.where(mask, -L / mag_lm, N / mag_nm)
    n1z = torch.where(mask, zero, -M / mag_nm)
    n2x = n1y * N - n1z * M
    n2y = n1z * L - n1x * N
    n2z = n1x * M - n1y * L
    d1 = -(n1x * x + n1y * y + n1z * z)
    d2 = -(n2x * x + n2y * y + n2z * z)

    # the guess: the ray's z = 0 footprint mapped through the patch's box
    x0b, x1b, y0b, y1b = box
    t0 = -z / torch.where(torch.abs(N) > _EPS, N, one)
    u = _clip((x + t0 * L - x0b) / max(x1b - x0b, _EPS), 0.0, 1.0)
    v = _clip((y + t0 * M - y0b) / max(y1b - y0b, _EPS), 0.0, 1.0)
    for _ in range(iters):
        S, S_u, S_v = surface_eval(U, V, W, Px, Py, Pz, p, q, nu, nv, u, v)
        r1 = n1x * S[0] + n1y * S[1] + n1z * S[2] + d1
        r2 = n2x * S[0] + n2y * S[1] + n2z * S[2] + d2
        a = n1x * S_u[0] + n1y * S_u[1] + n1z * S_u[2]
        b = n1x * S_v[0] + n1y * S_v[1] + n1z * S_v[2]
        c = n2x * S_u[0] + n2y * S_u[1] + n2z * S_u[2]
        dd = n2x * S_v[0] + n2y * S_v[1] + n2z * S_v[2]
        du, dv = _solve2(a, b, c, dd, r1, r2)
        u = _clip(u - du, 0.0, 1.0)
        v = _clip(v - dv, 0.0, 1.0)

    S, _, _ = surface_eval(U, V, W, Px, Py, Pz, p, q, nu, nv, u, v,
                           derivs=False)
    r1 = n1x * S[0] + n1y * S[1] + n1z * S[2] + d1
    r2 = n2x * S[0] + n2y * S[1] + n2z * S[2] + d2
    scale = 1.0 + torch.abs(S[0]) + torch.abs(S[1]) + torch.abs(S[2])
    valid = (torch.abs(r1) + torch.abs(r2)) < 1e-4 * scale
    t = (S[0] - x) * L + (S[1] - y) * M + (S[2] - z) * N
    return t, valid


# ---------------------------------------------------------------------------
# host-side construction (numpy, float64)
# ---------------------------------------------------------------------------


def clamped_uniform_knots(n_ctrl: int, degree: int) -> np.ndarray:
    """A clamped knot vector on [0, 1] with uniformly spaced interior
    knots."""
    n_interior = n_ctrl - degree - 1
    interior = np.linspace(0.0, 1.0, n_interior + 2)[1:-1]
    return np.concatenate([np.zeros(degree + 1), interior,
                           np.ones(degree + 1)])


def greville(knots: np.ndarray, degree: int, n_ctrl: int) -> np.ndarray:
    """The Greville abscissae, each control point's natural parameter."""
    return np.array([knots[i + 1: i + degree + 1].mean()
                     for i in range(n_ctrl)])


def _basis_matrix_np(knots: np.ndarray, degree: int, n_ctrl: int,
                     ts: np.ndarray) -> np.ndarray:
    """The dense (len(ts), n_ctrl) B-spline collocation matrix
    (de Boor)."""
    B = np.zeros((len(ts), n_ctrl))
    for col in range(n_ctrl):
        c = np.zeros(n_ctrl)
        c[col] = 1.0
        for row, t in enumerate(ts):
            B[row, col] = _deboor_np(knots, degree, n_ctrl, c, t)
    return B


def _deboor_np(knots, degree, n_ctrl, coeffs, t):
    span = int(np.clip(np.searchsorted(knots, t, side="right") - 1,
                       degree, n_ctrl - 1))
    d = [coeffs[j + span - degree] for j in range(degree + 1)]
    for r in range(1, degree + 1):
        for j in range(degree, r - 1, -1):
            i = j + span - degree
            den = knots[i + 1 + degree - r] - knots[i]
            alpha = 0.0 if den == 0 else (t - knots[i]) / den
            d[j] = (1.0 - alpha) * d[j - 1] + alpha * d[j]
    return d[degree]


def fit_nurbs_to_sag(sag_fn, x0, x1, y0, y1, nu: int, nv: int,
                     p: int = 3, q: int = 3, n_samples: int = 24):
    """Least-squares B-spline fit of z = sag_fn(x, y) (numpy in, numpy out)
    over [x0, x1] x [y0, y1]: (U, V, W, Px, Py, Pz), the control net's (x,
    y) on the Greville abscissae, so that the (u, v) -> (x, y) chart is
    near-affine, unit weights."""
    p = min(p, nu - 1)
    q = min(q, nv - 1)
    U = clamped_uniform_knots(nu, p)
    V = clamped_uniform_knots(nv, q)
    gu = greville(U, p, nu)
    gv = greville(V, q, nv)
    us = np.linspace(0.0, 1.0, n_samples)
    vs = np.linspace(0.0, 1.0, n_samples)
    Bu = _basis_matrix_np(U, p, nu, us)
    Bv = _basis_matrix_np(V, q, nv, vs)
    # the target sampled on the parameter grid mapped affinely to the box
    Xs = x0 + us[:, None] * (x1 - x0) + 0.0 * vs[None, :]
    Ys = y0 + 0.0 * us[:, None] + vs[None, :] * (y1 - y0)
    Zs = np.asarray(sag_fn(Xs, Ys), dtype=float)
    # separable least squares: C = pinv(Bu) Z pinv(Bv)^T
    Pz = np.linalg.pinv(Bu) @ Zs @ np.linalg.pinv(Bv).T
    Px = x0 + gu[:, None] * (x1 - x0) + 0.0 * gv[None, :]
    Py = y0 + 0.0 * gu[:, None] + gv[None, :] * (y1 - y0)
    W = np.ones((nu, nv))
    return U, V, W, Px, Py, Pz
