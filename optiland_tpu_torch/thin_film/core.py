"""Transfer-matrix method (TMM) for coherent thin-film stacks.

Port of `optiland_tpu/thin_film/core.py`: the Abeles characteristic
matrices of the layers multiplied over a (wavelength, AOI) grid, the
layer loop unrolled in Python, differentiable with respect to the layer
thicknesses and indices. Complex tensors follow the grid's real dtype
(complex128 under float64, complex64 under float32).
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch.polarization.prt import complex_of

# sqrt(eps0/mu0) in siemens, as the reference
_SQRT_EPS_MU = 0.002654418729832701370374020517935


def _snell_cos(n0, theta0, n):
    """Forward-branch cosine of the propagation angle in medium n
    (Macleod 2.6)."""
    nr, k = n.real, n.imag
    return torch.sqrt(nr**2 - k**2 - (n0 * torch.sin(theta0)) ** 2
                      - 2j * nr * k) / n


def _admittance(n, cos_t, pol: str):
    eta_s = _SQRT_EPS_MU * n * cos_t
    if pol == "s":
        return eta_s
    if pol == "p":
        return _SQRT_EPS_MU**2 * (n.real - 1j * n.imag) ** 2 / eta_s
    raise ValueError("pol must be 's' or 'p'")


def _complex(v, cdt, device):
    return torch.as_tensor(v, dtype=cdt, device=device)


def tmm_coh(n0, ns, layer_n, layer_d_um, wavelength_um, theta0_rad, pol: str):
    """Coherent TMM for one polarization.

    Args:
        n0, ns: complex incident/substrate indices (broadcastable over the
            wavelength/AOI grid).
        layer_n: sequence of complex layer indices (each broadcastable).
        layer_d_um: sequence of layer physical thicknesses in um (numbers
            or tensors).
        wavelength_um, theta0_rad: evaluation grids (real tensors,
            broadcastable; their dtype and device set the result's).
        pol: 's' or 'p'.

    Returns:
        (r, t, R, T, A).
    """
    w = wavelength_um
    th = torch.as_tensor(theta0_rad, dtype=w.dtype, device=w.device)
    cdt = complex_of(w.dtype)
    n0 = _complex(n0, cdt, w.device)
    ns = _complex(ns, cdt, w.device)

    cos0 = _snell_cos(n0, th, n0)
    coss = _snell_cos(n0, th, ns)
    eta0 = _admittance(n0, cos0, pol)
    etas = _admittance(ns, coss, pol)

    A = torch.ones_like(eta0)
    B = torch.zeros_like(eta0)
    C = torch.zeros_like(eta0)
    D = torch.ones_like(eta0)

    for n_l, d_l in zip(layer_n, layer_d_um):
        n_l = _complex(n_l, cdt, w.device)
        cos_l = _snell_cos(n0, th, n_l)
        eta_l = _admittance(n_l, cos_l, pol)
        delta = 2.0 * math.pi / w * n_l * d_l * cos_l
        c = torch.cos(delta)
        s = torch.sin(delta)
        mB = 1j * (s / eta_l)
        mC = 1j * (eta_l * s)
        A, B, C, D = (A * c + B * mC, A * mB + B * c,
                      C * c + D * mC, C * mB + D * c)

    denom = eta0 * (A + etas * B) + C + etas * D
    denom = torch.where(torch.abs(denom) == 0,
                        torch.full_like(denom, 1e-30), denom)

    r = (eta0 * A + eta0 * etas * B - C - etas * D) / denom
    t = torch.conj_physical((2.0 * eta0) / denom)

    R = torch.real(r * torch.conj(r))
    T = torch.real(t * torch.conj(t)) * torch.real(etas) / torch.real(eta0)
    return r, t, R, T, 1.0 - R - T
