"""Refractive-index dispersion models as pure, differentiable functions.

Port of `optiland_tpu/materials/dispersion.py`: the 9 refractiveindex.info
formulas, the ideal constant index, tabulated n(w) and the Abbe polynomial.
A material is a static formula code plus a coefficient vector; the
coefficients are a tensor, so an ideal material's index is differentiable.
Wavelengths are in micrometers.
"""

from __future__ import annotations

import numpy as np
import torch

# Formula codes. 1-9 match refractiveindex.info numbering.
FORMULA_IDEAL = 0
FORMULA_SELLMEIER = 1
FORMULA_SELLMEIER2 = 2
FORMULA_POLYNOMIAL = 3
FORMULA_RII = 4
FORMULA_CAUCHY = 5
FORMULA_GASES = 6
FORMULA_HERZBERGER = 7
FORMULA_RETRO = 8
FORMULA_EXOTIC = 9
FORMULA_TABULATED = 10
FORMULA_POLYVAL = 11  # n = polyval(coeffs, w), highest power first (Abbe model)

# Padded coefficient-vector width used by SystemParams.mat_coeffs.
MAX_COEFFS = 17

# jnp.interp's zero-width-segment threshold: the spacing of the dtype's eps
_SPACING_OF_EPS = {
    torch.float32: float(np.spacing(np.finfo(np.float32).eps)),
    torch.float64: float(np.spacing(np.finfo(np.float64).eps)),
}


def _sellmeier(c, w, squared: bool):
    w2 = w * w
    n2 = 1.0 + c[0]
    for k in range(1, len(c) - 1, 2):
        d = c[k + 1] ** 2 if squared else c[k + 1]
        n2 = n2 + c[k] * w2 / (w2 - d)
    return torch.sqrt(n2)


def _polynomial(c, w):
    n2 = c[0]
    for k in range(1, len(c) - 1, 2):
        n2 = n2 + c[k] * w ** c[k + 1]
    return torch.sqrt(n2)


def _rii4(c, w):
    w2 = w * w
    n2 = c[0]
    if len(c) > 4:
        n2 = n2 + c[1] * w ** c[2] / (w2 - c[3] ** c[4])
    if len(c) > 8:
        n2 = n2 + c[5] * w ** c[6] / (w2 - c[7] ** c[8])
    for k in range(9, len(c) - 1, 2):
        n2 = n2 + c[k] * w ** c[k + 1]
    return torch.sqrt(n2)


def _cauchy(c, w):
    n = c[0]
    for k in range(1, len(c) - 1, 2):
        n = n + c[k] * w ** c[k + 1]
    return n


def _gases(c, w):
    inv_w2 = 1.0 / (w * w)
    n = 1.0 + c[0]
    for k in range(1, len(c) - 1, 2):
        n = n + c[k] / (c[k + 1] - inv_w2)
    return n


def _herzberger(c, w):
    w2 = w * w
    g = 1.0 / (w2 - 0.028)
    n = c[0] + c[1] * g + c[2] * g * g
    for k in range(3, len(c)):
        n = n + c[k] * w ** (2 * (k - 2))
    return n


def _retro(c, w):
    w2 = w * w
    rhs = c[0] + c[1] * w2 / (w2 - c[2]) + c[3] * w2
    return torch.sqrt((2.0 * rhs + 1.0) / (1.0 - rhs))


def _exotic(c, w):
    w2 = w * w
    n2 = c[0] + c[1] / (w2 - c[2]) + c[3] * (w - c[4]) / ((w - c[4]) ** 2 + c[5])
    return torch.sqrt(n2)


def _interp(x, xp, fp):
    """jnp.interp semantics: edge-clamped linear interpolation; a segment
    of zero width (a table padded by repeating its last point) takes its
    left value and divides by one, so no gradient through it is NaN.

    The table entries are read with `torch.gather`, whose backward is a
    scatter-add: the backward of indexing (`fp[i]`) accumulates millions of
    rays into a few table entries through a sorted index_put that runs one
    entry's rays serially on the GPU (1.37 s of a 1.37 s flagship training
    step at 2M rays on an H100, `chip_smoke.py`)."""
    xp, fp = xp.contiguous(), fp.contiguous()
    xf = x.reshape(-1).contiguous()
    hi = torch.searchsorted(xp, xf, right=True).clamp(1, len(xp) - 1)
    lo = (hi - 1).clamp(min=0)  # a 1-point table: both ends are point 0
    x0, f0 = torch.gather(xp, 0, lo), torch.gather(fp, 0, lo)
    df = torch.gather(fp, 0, hi) - f0
    dx = torch.gather(xp, 0, hi) - x0
    dx0 = torch.abs(dx) <= _SPACING_OF_EPS[xp.dtype]
    f = torch.where(dx0, f0, f0 + ((xf - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(xf < xp[0], fp[0], f)
    f = torch.where(xf > xp[-1], fp[-1], f)
    return f.reshape(x.shape)


def material_index(formula: int, n_coeffs: int, coeffs, w):
    """Refractive index n(w) for a material.

    Args:
        formula: static formula code (FORMULA_*).
        n_coeffs: static number of valid entries in `coeffs`.
        coeffs: coefficient tensor (padded rows are fine; only the first
            `n_coeffs` entries are read).
        w: wavelength(s) in micrometers, a tensor of the coefficients' dtype.
    """
    w = torch.as_tensor(w, dtype=coeffs.dtype, device=coeffs.device)
    if formula == FORMULA_TABULATED:
        K = n_coeffs // 2
        return _interp(w, coeffs[:K], coeffs[K:n_coeffs])
    c = [coeffs[i] for i in range(n_coeffs)]
    if formula == FORMULA_IDEAL:
        return c[0].expand(w.shape) if w.ndim else c[0] + 0.0 * w
    if formula == FORMULA_SELLMEIER:
        return _sellmeier(c, w, squared=True)
    if formula == FORMULA_SELLMEIER2:
        return _sellmeier(c, w, squared=False)
    if formula == FORMULA_POLYNOMIAL:
        return _polynomial(c, w)
    if formula == FORMULA_RII:
        return _rii4(c, w)
    if formula == FORMULA_CAUCHY:
        return _cauchy(c, w)
    if formula == FORMULA_GASES:
        return _gases(c, w)
    if formula == FORMULA_HERZBERGER:
        return _herzberger(c, w)
    if formula == FORMULA_RETRO:
        return _retro(c, w)
    if formula == FORMULA_EXOTIC:
        return _exotic(c, w)
    if formula == FORMULA_POLYVAL:
        n = c[0] + 0.0 * w
        for k in range(1, n_coeffs):
            n = n * w + c[k]
        return n
    raise ValueError(f"Unknown dispersion formula code {formula}")


def material_extinction(formula: int, n_coeffs: int, coeffs, w):
    """Extinction coefficient k(w). Ideal materials store k in coeffs[1];
    dispersion-formula materials are lossless here (their tabulated k is
    the Beer-Lambert table `SystemParams.k_wl`, `k_val`)."""
    w = torch.as_tensor(w, dtype=coeffs.dtype, device=coeffs.device)
    if formula == FORMULA_IDEAL and n_coeffs > 1:
        return coeffs[1] + 0.0 * w
    return torch.zeros_like(w)
