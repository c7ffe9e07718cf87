"""Zernike polynomial bases (fringe / noll / standard) and least-squares fit.

Port of `optiland_tpu/zernike/__init__.py`: each convention is a host-side
(n, m) index table; a design matrix is built term by term (n, m plain
Python integers), so `fit` and `evaluate` are differentiable tensor
functions of their inputs.

Radial terms use the closed-form factorial sum; norm constants match each
convention exactly:
  - fringe: 1
  - noll/standard: sqrt((2n+2)/2) if m == 0 else sqrt(2n+2)
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def _fringe_number(n: int, m: int) -> int | None:
    if (n - m) % 2 != 0:
        return None
    return int((1 + (n + abs(m)) / 2) ** 2 - 2 * abs(m) + (1 - np.sign(m)) / 2)


def _noll_number(n: int, m: int) -> int | None:
    if (n - m) % 2 != 0:
        return None
    mod = n % 4
    if (m > 0 and mod <= 1) or (m < 0 and mod >= 2):
        c = 0
    else:
        c = 1
    return int(n * (n + 1) / 2 + abs(m) + c)


def _standard_number(n: int, m: int) -> int | None:
    if (n - m) % 2 != 0:
        return None
    return (n * (n + 2) + m) // 2


_NUMBERING = {
    "fringe": _fringe_number,
    "noll": _noll_number,
    "standard": _standard_number,
}


@lru_cache(maxsize=32)
def indices(zernike_type: str, num_terms: int) -> tuple[tuple[int, int], ...]:
    """(n, m) pairs for the first `num_terms` of a convention, in coefficient
    order."""
    number_fn = _NUMBERING[zernike_type]
    found: dict[int, tuple[int, int]] = {}
    for n in range(0, 2 * num_terms + 4):
        for m in range(-n, n + 1):
            num = number_fn(n, m)
            if num is not None and num not in found:
                found[num] = (n, m)
    return tuple(found[k] for k in sorted(found))[:num_terms]


def _norm_constant(zernike_type: str, n: int, m: int) -> float:
    if zernike_type == "fringe":
        return 1.0
    den = 2 if m == 0 else 1
    return math.sqrt((2 * n + 2) / den)


def _radial_term(n: int, m: int, r):
    m = abs(m)
    val = 0.0
    for k in range((n - m) // 2 + 1):
        coeff = ((-1) ** k * math.factorial(n - k)
                 / (math.factorial(k) * math.factorial((n + m) // 2 - k)
                    * math.factorial((n - m) // 2 - k)))
        val = val + coeff * r ** (n - 2 * k)
    return val


def _azimuthal_term(m: int, phi):
    if m == 0:
        return torch.ones_like(phi)
    if m > 0:
        return torch.cos(m * phi)
    return torch.sin(abs(m) * phi)


def design_matrix(zernike_type: str, num_terms: int, r, phi):
    """(N, num_terms) matrix of Zernike basis values at (r, phi)."""
    cols = []
    for n, m in indices(zernike_type, num_terms):
        cols.append(_norm_constant(zernike_type, n, m)
                    * _radial_term(n, m, r) * _azimuthal_term(m, phi))
    return torch.stack(cols, dim=-1)


def evaluate(zernike_type: str, coeffs, r, phi):
    """Sum of Zernike terms with the given coefficients at (r, phi)."""
    A = design_matrix(zernike_type, int(coeffs.shape[-1]), r, phi)
    return A @ coeffs


def evaluate_xy(zernike_type: str, coeffs, xn, yn):
    """Zernike sum evaluated directly in Cartesian coordinates.

    Each term R_n^m(rho) * cos/sin(m phi) is expanded as a polynomial in
    (xn, yn): rho^m cos(m phi) = Re[(xn + i yn)^m] via the real recurrence,
    and the remaining radial powers are even powers of rho^2. Unlike the
    (rho, phi) form, this is smooth at the origin, where atan2's
    derivative is singular.
    """
    r2 = xn * xn + yn * yn
    num_terms = int(coeffs.shape[-1])
    idx = indices(zernike_type, num_terms)
    max_m = max(abs(m) for _, m in idx)
    # C[m] = rho^m cos(m phi), S[m] = rho^m sin(m phi)
    C = [torch.ones_like(xn)]
    S = [torch.zeros_like(xn)]
    for _ in range(max_m):
        c_prev, s_prev = C[-1], S[-1]
        C.append(c_prev * xn - s_prev * yn)
        S.append(s_prev * xn + c_prev * yn)
    out = 0.0
    for t, (n, m) in enumerate(idx):
        am = abs(m)
        # R_n^m(rho) / rho^am  -> polynomial in rho^2
        rad = 0.0
        for k in range((n - am) // 2 + 1):
            ck = ((-1) ** k * math.factorial(n - k)
                  / (math.factorial(k) * math.factorial((n + am) // 2 - k)
                     * math.factorial((n - am) // 2 - k)))
            rad = rad + ck * r2 ** ((n - am) // 2 - k)
        azim = C[am] if m >= 0 else S[am]
        out = out + (coeffs[t] * _norm_constant(zernike_type, n, m)
                     * rad * azim)
    return out


def lstsq(A, b):
    """Least-squares solution x of A x = b for an (N, K) A of full column
    rank and an (N,) b. On CUDA torch solves it only by QR (`gels`), which
    assumes full rank; every caller's matrix has it (see there)."""
    return torch.linalg.lstsq(A, b[:, None]).solution[:, 0]


def fit(zernike_type: str, num_terms: int, x, y, z):
    """LSQ-fit Zernike coefficients to samples z(x, y) on the unit disk.
    Returns (num_terms,) coefficients."""
    r = torch.sqrt(x * x + y * y)
    phi = torch.atan2(y, x)
    A = design_matrix(zernike_type, num_terms, r, phi)
    return lstsq(A, z)
