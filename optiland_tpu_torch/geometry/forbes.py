"""Forbes Q-polynomial evaluation (Q-bfs radial and Q-2D freeform).

Port of `optiland_tpu/geometry/forbes.py`. The recurrence constants (pure
functions of the static term structure) are host-side floats under
`functools.cache`; the Clenshaw loops unroll into straight-line tensor
arithmetic, differentiable by autograd (and in x and y by forward-mode AD,
`geometry/surfaces.sag_and_grad`).

Math (Forbes 2007 "Shape specification for axially symmetric optical
surfaces"; Forbes 2011 generalization to a conic reference):

  Q-bfs:  z(r) = z_conic(r) + phi(r^2) * u^2 (1-u^2) * sum_m a_m Q_m(u^2)
  Q2D:    z(r,t) = z_conic(r) + phi(r^2) * [ u^2(1-u^2) sum_n a_n^0 Q_n^0(u^2)
             + sum_{m>=1} u^m sum_n (a_n^m cos mt + b_n^m sin mt) Q_n^m(u^2) ]

with u = r / r_norm and phi the conic correction factor
sqrt((1 - k c^2 r^2) / (1 - (1+k) c^2 r^2)).

The user coefficients are turned into the orthonormal auxiliary basis by a
triangular backward recurrence, then summed by Clenshaw's algorithm. The
fused chain's Q-bfs branch (csrc/freeform.cuh) evaluates the same
recurrence with the constants `_f_qbfs`, `_g_qbfs`, `_h_qbfs` tabulated.
"""

from __future__ import annotations

import math
from functools import cache

import torch

# ---------------------------------------------------------------------------
# Host-side recurrence constants (pure Python floats, cached)
# ---------------------------------------------------------------------------


@cache
def _f_qbfs(n: int) -> float:
    if n == 0:
        return 2.0
    if n == 1:
        return math.sqrt(19.0) / 2.0
    return math.sqrt(n * (n + 1) + 3.0 - _g_qbfs(n - 1) ** 2
                     - _h_qbfs(n - 2) ** 2)


@cache
def _g_qbfs(n_minus_1: int) -> float:
    if n_minus_1 == 0:
        return -0.5
    n_minus_2 = n_minus_1 - 1
    return -(1.0 + _g_qbfs(n_minus_2) * _h_qbfs(n_minus_2)) / _f_qbfs(n_minus_1)


@cache
def _h_qbfs(n_minus_2: int) -> float:
    n = n_minus_2 + 2
    return -n * (n - 1.0) / (2.0 * _f_qbfs(n_minus_2))


def _fact2(n: int) -> float:
    """Double factorial n!! (1 for n <= 0)."""
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


@cache
def _gamma_q2d(n: int, m: int) -> float:
    if n == 1 and m == 2:
        return 3.0 / 8.0
    if n == 1 and m > 2:
        mm1 = m - 1
        return ((2.0 * mm1 + 1.0) / (2.0 * (mm1 - 1.0))) * _gamma_q2d(1, mm1)
    nm1 = n - 1
    num = (nm1 + 1.0) * (2.0 * m + 2.0 * nm1 - 1.0)
    den = (m + nm1 - 2.0) * (2.0 * nm1 + 1.0)
    return (num / den) * _gamma_q2d(nm1, m)


@cache
def _g_q2d_raw(n: int, m: int) -> float:
    if n == 0:
        return _fact2(2 * m - 1) / (2.0 ** (m + 1) * math.factorial(m - 1))
    if n > 0 and m == 1:
        t1 = -((2.0 * n * n - 1.0) * (n * n - 1.0)) / (8.0 * (4.0 * n * n - 1.0))
        return t1 - (1.0 / 24.0 if n == 1 else 0.0)
    num = (2.0 * n * (m + n - 1.0) - m) * (n + 1.0) * (2.0 * m + 2.0 * n - 1.0)
    den = ((m + 2.0 * n - 2.0) * (m + 2.0 * n - 1.0)
           * (m + 2.0 * n) * (2.0 * n + 1.0))
    return -(num / den) * _gamma_q2d(n, m)


@cache
def _f_q2d_raw(n: int, m: int) -> float:
    if n == 0 and m == 1:
        return 0.25
    if n == 0:
        return m * m * _fact2(2 * m - 3) / (2.0 ** (m + 1)
                                            * math.factorial(m - 1))
    if n > 0 and m == 1:
        t1 = (4.0 * (n - 1.0) ** 2 * n * n + 1.0) / (8.0 * (2.0 * n - 1.0) ** 2)
        return t1 + (11.0 / 32.0 if n == 1 else 0.0)
    chi = m + n - 2.0
    num = 2.0 * n * chi * (3.0 - 5.0 * m + 4.0 * n * chi) + m * m * (
        3.0 - m + 4.0 * n * chi)
    den = ((m + 2.0 * n - 3.0) * (m + 2.0 * n - 2.0)
           * (m + 2.0 * n - 1.0) * (2.0 * n - 1.0))
    return (num / den) * _gamma_q2d(n, m)


@cache
def _g_q2d(n: int, m: int) -> float:
    return _g_q2d_raw(n, m) / _f_q2d(n, m)


@cache
def _f_q2d(n: int, m: int) -> float:
    if n == 0:
        return math.sqrt(_f_q2d_raw(0, m))
    return math.sqrt(_f_q2d_raw(n, m) - _g_q2d(n - 1, m) ** 2)


# Clenshaw A/B/C special cases keyed (m, n) — Forbes 2011 Table / reference
# `qpoly.py:370-377`.
_ABC_SPECIAL = {
    (1, 0): (2.0, -1.0, 0.0),
    (1, 1): (-4.0 / 3.0, -8.0 / 3.0, -11.0 / 3.0),
    (1, 2): (9.0 / 5.0, -24.0 / 5.0, 0.0),
    (2, 0): (3.0, -2.0, 0.0),
    (3, 0): (5.0, -4.0, 0.0),
}


@cache
def _abc_q2d(n: int, m: int) -> tuple[float, float, float]:
    if (m, n) in _ABC_SPECIAL:
        return _ABC_SPECIAL[(m, n)]
    d = (4.0 * n * n - 1.0) * (m + n - 2.0) * (m + 2.0 * n - 3.0)
    if d == 0.0:
        d = 1e-99
    a = ((2.0 * n - 1.0) * (m + 2.0 * n - 2.0)
         * (4.0 * n * (m + n - 2.0) + (m - 3.0) * (2.0 * m - 1.0))) / d
    b = (-2.0 * (2.0 * n - 1.0) * (m + 2.0 * n - 3.0)
         * (m + 2.0 * n - 2.0) * (m + 2.0 * n - 1.0)) / d
    c = (n * (2.0 * n - 3.0) * (m + 2.0 * n - 1.0)
         * (2.0 * m + 2.0 * n - 3.0)) / d
    return a, b, c


# ---------------------------------------------------------------------------
# evaluation (static-length unrolled Clenshaw)
# ---------------------------------------------------------------------------


def qbfs_sum(cs: list, usq):
    """sum_m a_m Q_m(usq) for the radial (m=0) Forbes basis.

    `cs` is a static-length list of scalars (floats or 0-d tensors).
    """
    m = len(cs) - 1
    if m < 0:
        return torch.zeros_like(usq)
    # basis change a -> orthonormal P_n coefficients (triangular, static)
    bs = [None] * (m + 1)
    bs[m] = cs[m] / _f_qbfs(m)
    if m > 0:
        bs[m - 1] = (cs[m - 1] - _g_qbfs(m - 1) * bs[m]) / _f_qbfs(m - 1)
        for i in range(m - 2, -1, -1):
            bs[i] = (cs[i] - _g_qbfs(i) * bs[i + 1]
                     - _h_qbfs(i) * bs[i + 2]) / _f_qbfs(i)
    prefix = 2.0 - 4.0 * usq
    b_curr = bs[m] + torch.zeros_like(usq)
    b_next = torch.zeros_like(usq)
    for n in range(m - 1, -1, -1):
        b_new = bs[n] + prefix * b_curr - b_next
        b_next, b_curr = b_curr, b_new
    return 2.0 * (b_curr + b_next) if m > 0 else 2.0 * b_curr


def q2d_sum(cs: list, m: int, usq):
    """sum_n c_n Q_n^m(usq) for the azimuthal order m >= 1."""
    n_max = len(cs) - 1
    if n_max < 0:
        return torch.zeros_like(usq)
    ds = [None] * (n_max + 1)
    ds[n_max] = cs[n_max] / _f_q2d(n_max, m)
    for n in range(n_max - 1, -1, -1):
        ds[n] = (cs[n] - _g_q2d(n, m) * ds[n + 1]) / _f_q2d(n, m)

    alphas = [torch.zeros_like(usq) for _ in range(n_max + 1)]
    alphas[n_max] = ds[n_max] + torch.zeros_like(usq)
    if n_max >= 1:
        a, b, _ = _abc_q2d(n_max - 1, m)
        alphas[n_max - 1] = ds[n_max - 1] + (a + b * usq) * alphas[n_max]
    for n in range(n_max - 2, -1, -1):
        a, b, _ = _abc_q2d(n, m)
        _, _, c = _abc_q2d(n + 1, m)
        alphas[n] = ds[n] + (a + b * usq) * alphas[n + 1] - c * alphas[n + 2]

    s = 0.5 * alphas[0]
    # Forbes' special summation rule for m = 1 (reference `qpoly.py:404-410`)
    if m == 1 and n_max > 2:
        s = s - 0.4 * alphas[3]
    return s
