"""Differentiable cubic B-spline grid interpolation.

Port of `optiland_tpu/core/interpolation.py`, which re-implements the
reference's numpy-backend `GridInterpolator` (scipy's
`RectBivariateSpline`, an interpolating bicubic tensor-product B-spline):

  - FITPACK interpolating knot vector: 4-fold end knots, interior knots at
    the data sites x_2 .. x_{n-3};
  - spline coefficients from the 1-D collocation systems B c = z per axis.

The collocation matrices depend only on the grid's size (queries and knots
live in uniform index space: a grid is stored with its (xmin, xmax, ymin,
ymax) bounds), so their inverses are host-side numpy constants under an
`lru_cache`, and the grid-values -> coefficients map is a linear,
differentiable contraction: C = Ainv_y @ Z @ Ainv_x^T. Evaluation gathers
the 4 x 4 block of nonzero basis functions per query. The basis's
derivative in its argument is carried beside its value through the
Cox-de Boor recursion (whose denominators are knot differences), so the
gradient of the spline in x and y is exact, the value JAX's `jax.jvp`
gives, and every output is differentiable in the grid and the query
coordinates by autograd.

Out-of-bounds queries clamp to the boundary, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_DEG = 3  # cubic


def fitpack_knots(n: int) -> np.ndarray:
    """Index-space FITPACK interpolating knot vector for n uniform sites."""
    if n < 4:
        raise ValueError("cubic spline interpolation needs >= 4 grid points")
    return np.concatenate([
        np.zeros(4), np.arange(2, n - 2, dtype=float), np.full(4, n - 1.0)])


def _basis4_np(t: np.ndarray, j: int, u: float) -> np.ndarray:
    """The 4 nonzero cubic basis values B_{j-3..j}(u) (NURBS Book A2.2)."""
    left = np.zeros(_DEG + 1)
    right = np.zeros(_DEG + 1)
    N = np.zeros(_DEG + 1)
    N[0] = 1.0
    for r in range(1, _DEG + 1):
        left[r] = u - t[j + 1 - r]
        right[r] = t[j + r] - u
        saved = 0.0
        for i in range(r):
            den = right[i + 1] + left[r - i]
            tmp = N[i] / den if den != 0 else 0.0
            N[i] = saved + right[i + 1] * tmp
            saved = left[r - i] * tmp
        N[r] = saved
    return N


def _interval_np(t: np.ndarray, u: float) -> int:
    n = len(t) - _DEG - 1  # number of basis functions
    j = int(np.searchsorted(t, u, side="right") - 1)
    return min(max(j, _DEG), n - 1)


@lru_cache(maxsize=64)
def collocation_inverse(n: int) -> np.ndarray:
    """Inverse of the cubic B-spline collocation matrix B[i, j] = B_j(i)
    for n uniform sites in index space (static per grid size)."""
    t = fitpack_knots(n)
    B = np.zeros((n, n))
    for i in range(n):
        j = _interval_np(t, float(i))
        B[i, j - _DEG: j + 1] = _basis4_np(t, j, float(i))
    return np.linalg.inv(B)


def spline_coefficients_2d(grid, ny: int, nx: int):
    """(ny, nx) grid values -> bicubic spline coefficients (linear map,
    differentiable in the grid)."""
    Ay = torch.as_tensor(collocation_inverse(ny), dtype=grid.dtype,
                         device=grid.device)
    Ax = torch.as_tensor(collocation_inverse(nx), dtype=grid.dtype,
                         device=grid.device)
    return Ay @ grid[:ny, :nx] @ Ax.T


def _basis4(t, j, u):
    """The 4 nonzero cubic basis values at u (index space) and their
    derivatives in u, each (..., 4). `t` is a numpy knot vector; j, u are
    tensors. The JAX package's guarded recursion, with the derivative
    carried beside it (d left / du = 1, d right / du = -1)."""
    tj = torch.as_tensor(t, dtype=u.dtype, device=u.device)
    Ns = [torch.ones_like(u)]
    dNs = [torch.zeros_like(u)]
    for r in range(1, _DEG + 1):
        left = [u - tj[j + 1 - rr] for rr in range(r + 1)]
        right = [tj[j + rr] - u for rr in range(r + 1)]
        new, dnew = [], []
        saved = torch.zeros_like(u)
        dsaved = torch.zeros_like(u)
        for i in range(r):
            den = right[i + 1] + left[r - i]
            ok = torch.abs(den) > 1e-12
            safe = torch.where(ok, den, torch.ones_like(den))
            tmp = torch.where(ok, Ns[i] / safe, torch.zeros_like(u))
            dtmp = torch.where(ok, dNs[i] / safe, torch.zeros_like(u))
            new.append(saved + right[i + 1] * tmp)
            dnew.append(dsaved - tmp + right[i + 1] * dtmp)
            saved = left[r - i] * tmp
            dsaved = tmp + left[r - i] * dtmp
        new.append(saved)
        dnew.append(dsaved)
        Ns, dNs = new, dnew
    return torch.stack(Ns, dim=-1), torch.stack(dNs, dim=-1)


def _interval(t, u, n_basis: int):
    tj = torch.as_tensor(t, dtype=u.dtype, device=u.device)
    j = torch.searchsorted(tj, u.detach().contiguous(), right=True) - 1
    return torch.clamp(j, _DEG, n_basis - 1)


def bicubic_eval(C, ny: int, nx: int, u, v):
    """The bicubic spline of coefficient matrix C at index-space
    coordinates (u, v) = (x index, y index), clamped to the table, and its
    derivatives in u and v: (value, d/du, d/dv)."""
    tx = fitpack_knots(nx)
    ty = fitpack_knots(ny)
    # outside the table the value is the edge's, its derivative 0
    inx = ((u >= 0.0) & (u <= nx - 1.0)).to(u.dtype)
    iny = ((v >= 0.0) & (v <= ny - 1.0)).to(v.dtype)
    u = torch.clamp(u, 0.0, nx - 1.0)
    v = torch.clamp(v, 0.0, ny - 1.0)
    jx = _interval(tx, u, nx)
    jy = _interval(ty, v, ny)
    bx, dbx = _basis4(tx, jx, u)  # (..., 4)
    by, dby = _basis4(ty, jy, v)
    # gather the 4 x 4 coefficient block: C[jy-3+a, jx-3+b]
    offs = torch.arange(_DEG + 1, device=u.device)
    rows = jy[..., None] - _DEG + offs  # (..., 4)
    cols = jx[..., None] - _DEG + offs
    idx = rows[..., :, None] * nx + cols[..., None, :]  # (..., 4, 4)
    block = C.reshape(-1)[idx]
    val = torch.einsum("...a,...ab,...b->...", by, block, bx)
    du = torch.einsum("...a,...ab,...b->...", by, block, dbx)
    dv = torch.einsum("...a,...ab,...b->...", dby, block, bx)
    return val, du * inx, dv * iny


def grid_cubic(grid, bounds, gy: int, gx: int, x, y):
    """Bicubic-spline sample and analytic gradient of a (gy, gx) table over
    the rectangle `bounds` = (xmin, xmax, ymin, ymax): the cubic
    counterpart of `trace/phase.grid_bilinear`. Returns (value, d/dx,
    d/dy), differentiable in the grid and the query coordinates."""
    xmin, xmax, ymin, ymax = bounds[0], bounds[1], bounds[2], bounds[3]
    sx = (gx - 1) / (xmax - xmin)
    sy = (gy - 1) / (ymax - ymin)
    C = spline_coefficients_2d(grid, gy, gx)
    val, du, dv = bicubic_eval(C, gy, gx, (x - xmin) * sx, (y - ymin) * sy)
    return val, du * sx, dv * sy
