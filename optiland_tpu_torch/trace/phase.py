"""Phase-profile evaluation shared by the real-ray tracer and the paraxial
engine.

Port of `optiland_tpu/trace/phase.py`: the reference's five phase profiles
(`optiland/phase/{constant,radial,linear_grating,grid,height_profile}.py`),
the analytic kinds and tabulated grids with differentiable interpolation:
the bicubic spline by default (`core/interpolation.py`, the reference's
scipy `RectBivariateSpline`) or bilinear (`phase_interp="linear"`, the
reference's torch `grid_sample` order). Height profiles turn a height map
and a dispersive material into phase:
phi(x, y, w) = 2 pi / (w 1e-3) (n(w) - 1) h(x, y) (w in um, lengths in mm).

The radial profile's d phi / d(r^2) takes the eager form of the JAX
package, r^(2j) / r^2 guarded to 0 at r = 0: its derivative in x and y is
0 on the axis, where the fused chain's form (`trace/fused.py
_phase_vg_inline`, csrc/chain.cuh) gives the true 2 p_0. Their values agree
everywhere.
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch.materials.dispersion import material_index
from optiland_tpu_torch.system.spec import (
    PHASE_CONSTANT,
    PHASE_GRID,
    PHASE_HEIGHT,
    PHASE_LINEAR_GRATING,
    PHASE_RADIAL,
)


def grid_bilinear(grid, bounds, gy: int, gx: int, x, y):
    """Differentiable bilinear sample and analytic gradient of a (gy, gx)
    table over the rectangle `bounds` = (xmin, xmax, ymin, ymax). Queries
    outside the rectangle clamp to the edge (the gradient from the edge
    cell). Returns (value, d/dx, d/dy)."""
    xmin, xmax, ymin, ymax = bounds[0], bounds[1], bounds[2], bounds[3]
    sx = (gx - 1) / (xmax - xmin)
    sy = (gy - 1) / (ymax - ymin)
    u = torch.clamp((x - xmin) * sx, 0.0, gx - 1.0)
    v = torch.clamp((y - ymin) * sy, 0.0, gy - 1.0)
    u0 = torch.clamp(torch.floor(u.detach()), 0, gx - 2).long()
    v0 = torch.clamp(torch.floor(v.detach()), 0, gy - 2).long()
    fu = u - u0
    fv = v - v0
    g = grid[:gy, :gx]
    g00 = g[v0, u0]
    g01 = g[v0, u0 + 1]
    g10 = g[v0 + 1, u0]
    g11 = g[v0 + 1, u0 + 1]
    val = (g00 * (1 - fu) * (1 - fv) + g01 * fu * (1 - fv)
           + g10 * (1 - fu) * fv + g11 * fu * fv)
    dvdx = ((g01 - g00) * (1 - fv) + (g11 - g10) * fv) * sx
    dvdy = ((g10 - g00) * (1 - fu) + (g11 - g01) * fu) * sy
    return val, dvdx, dvdy


def _height_factor(static, params, k, w):
    """2 pi / (w 1e-3) (n(w) - 1) for the height profile's material at
    surface k."""
    aux = static.phase_aux[k]
    n = material_index(aux[3], aux[4], params.phase_mat_coeffs[k], w)
    return 2.0 * math.pi / (w * 1e-3) * (n - 1.0)


def phase_value_grad(static, params, k, x, y, w):
    """Phase (radians) and its (x, y) gradient at surface k (reference
    `phase/*.py` get_phase / get_gradient)."""
    kind = static.phase_kinds[k]
    p = params.phase_params[k]
    if kind == PHASE_CONSTANT:
        z = torch.zeros_like(x)
        return p[0] + z, z, z
    if kind == PHASE_RADIAL:
        r2 = x * x + y * y
        phase = torch.zeros_like(x)
        dphi_dr2 = torch.zeros_like(x)
        rp = r2
        for ci in range(p.shape[0]):
            phase = phase + p[ci] * rp
            dphi_dr2 = dphi_dr2 + p[ci] * (ci + 1) * torch.where(
                r2 > 0, rp / torch.clamp(r2, min=1e-30), torch.zeros_like(r2))
            rp = rp * r2
        return phase, 2.0 * x * dphi_dr2, 2.0 * y * dphi_dr2
    if kind == PHASE_LINEAR_GRATING:
        return p[0] * x + p[1] * y, p[0] + 0.0 * x, p[1] + 0.0 * y
    if kind in (PHASE_GRID, PHASE_HEIGHT):
        aux = static.phase_aux[k]
        val, dx, dy = _grid_sample(static, params.phase_grids[k], p, aux[1],
                                   aux[2], x, y)
        if kind == PHASE_GRID:
            return val, dx, dy
        f = _height_factor(static, params, k, w)
        return f * val, f * dx, f * dy
    raise ValueError(f"Unknown phase kind {kind}")


def _grid_sample(static, grid, bounds, gy, gx, x, y):
    """The grid sample at the build's interpolation order: "cubic" (the
    reference's scipy `RectBivariateSpline`, `core/interpolation.py`) or
    "linear" (its torch `grid_sample` order)."""
    if static.phase_interp == "linear":
        return grid_bilinear(grid, bounds, gy, gx, x, y)
    from optiland_tpu_torch.core.interpolation import grid_cubic

    return grid_cubic(grid, bounds, gy, gx, x, y)


def paraxial_phase_gradient(static, params, k, y, w):
    """d phi / dy along the meridian x = 0 (reference `phase/*.py`
    get_paraxial_gradient)."""
    _, _, gy = phase_value_grad(static, params, k, torch.zeros_like(y), y, w)
    return gy
