"""Pupil sampling distributions.

Port of `optiland_tpu/core/distributions.py`: host-side point generators
(hexapolar default, uniform grid, random, sobol, line_x/y, cross, ring,
Gaussian quadrature). Each returns `(Px, Py)` normalized pupil coordinates
in the unit disk as float64 CPU tensors (Gaussian quadrature also returns
integration weights); the caller moves them to its device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def hexapolar(num_rings: int = 6):
    """Hexapolar rings: 1 + 3 * n * (n + 1) points (reference default)."""
    xs = [np.zeros(1)]
    ys = [np.zeros(1)]
    r = np.linspace(0.0, 1.0, num_rings + 1)
    for i in range(num_rings):
        n_theta = 6 * (i + 1)
        theta = np.linspace(0.0, 2.0 * np.pi, n_theta + 1)[:-1]
        xs.append(r[i + 1] * np.cos(theta))
        ys.append(r[i + 1] * np.sin(theta))
    return _t(np.concatenate(xs)), _t(np.concatenate(ys))


def uniform(num_points: int = 10):
    """num_points x num_points grid masked to the unit disk."""
    x = np.linspace(-1.0, 1.0, num_points)
    X, Y = np.meshgrid(x, x)
    m = X**2 + Y**2 <= 1.0
    return _t(X[m]), _t(Y[m])


def random(num_points: int, seed: int | None = None):
    """Uniform random points in the unit disk (area-uniform)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=num_points)
    theta = rng.uniform(0.0, 2.0 * np.pi, size=num_points)
    return _t(np.sqrt(r) * np.cos(theta)), _t(np.sqrt(r) * np.sin(theta))


def line_x(num_points: int, positive_only: bool = False):
    x = np.linspace(0.0 if positive_only else -1.0, 1.0, num_points)
    return _t(x), _t(np.zeros(num_points))


def line_y(num_points: int, positive_only: bool = False):
    y = np.linspace(0.0 if positive_only else -1.0, 1.0, num_points)
    return _t(np.zeros(num_points)), _t(y)


def cross(num_points: int):
    """Points along both axes; duplicate origin removed for odd counts."""
    yy = np.linspace(-1.0, 1.0, num_points)
    xx = np.linspace(-1.0, 1.0, num_points)
    x_line_x, x_line_y = xx, np.zeros(num_points)
    if num_points % 2 == 1:
        mid = num_points // 2
        x_line_x = np.delete(x_line_x, mid)
        x_line_y = np.delete(x_line_y, mid)
    return (_t(np.concatenate([np.zeros(num_points), x_line_x])),
            _t(np.concatenate([yy, x_line_y])))


def ring(num_points: int, radius: float = 1.0):
    theta = np.linspace(0.0, 2.0 * np.pi, num_points + 1)[:-1]
    return _t(radius * np.cos(theta)), _t(radius * np.sin(theta))


def gaussian_quadrature(num_rings: int = 3, symmetric: bool = True):
    """Forbes Gaussian-quadrature pupil rings and weights (G.W. Forbes,
    JOSA A 5, 1943 (1988)). Returns (Px, Py, weights). With `symmetric`
    (on-axis fields) a single azimuthal arm suffices; otherwise three arms
    at +-60 degrees."""
    nodes, weights = np.polynomial.legendre.leggauss(num_rings)
    r = np.sqrt(0.5 * (nodes + 1.0))
    w = weights / 2.0
    if symmetric:
        theta = np.array([np.pi / 2.0])
    else:
        theta = np.array([-np.pi / 3.0 + np.pi / 2.0, np.pi / 2.0,
                          np.pi / 3.0 + np.pi / 2.0])
    R, T = np.meshgrid(r, theta, indexing="ij")
    wts = np.repeat(w, len(theta)) / len(theta)
    return (_t((R * np.cos(T)).ravel()), _t((R * np.sin(T)).ravel()),
            _t(wts))


def sobol(num_points: int, seed: int | None = 0):
    """Low-discrepancy Sobol points on the unit disk: area-uniform polar map
    of a scrambled 2-D Sobol sequence (scipy.stats.qmc)."""
    from scipy.stats import qmc

    u = qmc.Sobol(d=2, scramble=True, seed=seed).random(num_points)
    r = np.sqrt(u[:, 0])
    theta = 2.0 * np.pi * u[:, 1]
    return _t(r * np.cos(theta)), _t(r * np.sin(theta))


_GENERATORS = {
    "hexapolar": hexapolar,
    "uniform": uniform,
    "random": random,
    "sobol": sobol,
    "line_x": line_x,
    "line_y": line_y,
    "cross": cross,
    "ring": ring,
}


def generate(distribution: str, num_points: int):
    """Pupil points by distribution name. `num_points` follows the
    reference convention: rings for hexapolar, per-axis count for
    uniform/line/cross."""
    try:
        gen = _GENERATORS[distribution]
    except KeyError:
        raise ValueError(
            f"Unknown distribution {distribution!r}; "
            f"expected one of {sorted(_GENERATORS)}"
        ) from None
    return gen(num_points)
