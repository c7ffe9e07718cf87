"""Jones matrix library: batched (N, 3, 3) complex matrices.

Port of `optiland_tpu/polarization/jones.py`. Each function takes the
pre- and post-interaction ray directions (k0, k1 as (N, 3)) and the
element's parameters, and returns the padded 3x3 Jones matrix in the local
(s, p, k) frame, built by stacking (no in-place assembly), so autograd
differentiates through it. The complex dtype is the partner of k0's real
dtype: complex128 under float64, complex64 under float32.
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.polarization.prt import complex_of, local_basis


def _assemble(j00, j01, j10, j11, j22, n, dtype=None, device=None):
    """The (n, 3, 3) matrix [[j00, j01, 0], [j10, j11, 0], [0, 0, j22]]
    from scalars or (n,) tensors, in `dtype` (complex)."""
    dtype = dtype or config.complex_dtype()
    z = torch.zeros(n, dtype=dtype, device=device)

    def c(v):
        return torch.as_tensor(v, dtype=dtype, device=device) + z

    rows = [
        torch.stack([c(j00), c(j01), z], dim=-1),
        torch.stack([c(j10), c(j11), z], dim=-1),
        torch.stack([z, z, c(j22)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _like(k0):
    return dict(dtype=complex_of(k0.dtype), device=k0.device)


def fresnel(k0, k1, aoi, n1, n2, reflect: bool):
    """Fresnel amplitude coefficients as a Jones matrix: s and p on the
    diagonal (-p and -1 on reflection, the reference's sign)."""
    cos_i = torch.cos(aoi)
    n = n2 / n1
    root = torch.sqrt((n**2 - torch.sin(aoi) ** 2).to(complex_of(k0.dtype)))
    if reflect:
        s = (cos_i - root) / (cos_i + root)
        p = (n**2 * cos_i - root) / (n**2 * cos_i + root)
        return _assemble(s, 0.0, 0.0, -p, -1.0, k0.shape[0], **_like(k0))
    s = 2 * cos_i / (cos_i + root)
    p = 2 * n * cos_i / (n**2 * cos_i + root)
    return _assemble(s, 0.0, 0.0, p, 1.0, k0.shape[0], **_like(k0))


def _vector(axis, like):
    """A 3-vector of numbers or 0-d tensors as a (N, 3) tensor like `like`,
    differentiable in its tensor entries."""
    v = torch.stack([torch.as_tensor(a, dtype=like.dtype, device=like.device)
                     for a in axis])
    return v.expand(like.shape)


def _unit_pair(ts, tp):
    norm = torch.sqrt(ts**2 + tp**2)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return ts / norm, tp / norm


def _axis_in_basis(k0, k1, axis):
    """Unit projection of a global axis onto the incident (s, p0) plane."""
    s, p0, p1, _, _ = local_basis(k0, k1)
    axis_b = _vector(axis, k0)
    us, up = _unit_pair(torch.sum(axis_b * s, dim=-1),
                        torch.sum(axis_b * p0, dim=-1))
    return us, up, s, p0, p1


def linear_polarizer(k0, k1, axis):
    """General linear polarizer with a global transmission axis."""
    us_in, up_in, s, p0, p1 = _axis_in_basis(k0, k1, axis)
    axis_b = _vector(axis, k0)
    us_out, up_out = _unit_pair(torch.sum(axis_b * s, dim=-1),
                                torch.sum(axis_b * p1, dim=-1))
    return _assemble(us_out * us_in, us_out * up_in, up_out * us_in,
                     up_out * up_in, 1.0, k0.shape[0], **_like(k0))


def polarizer_h(k0, k1):
    return linear_polarizer(k0, k1, [1.0, 0.0, 0.0])


def polarizer_v(k0, k1):
    return linear_polarizer(k0, k1, [0.0, 1.0, 0.0])


def _constant(j00, j01, j10, j11, k0):
    return _assemble(j00, j01, j10, j11, 1.0, k0.shape[0], **_like(k0))


def polarizer_rcp(k0, k1):
    """Right circular polarizer."""
    return _constant(0.5, 0.5j, -0.5j, 0.5, k0)


def polarizer_lcp(k0, k1):
    """Left circular polarizer."""
    return _constant(0.5, -0.5j, 0.5j, 0.5, k0)


def linear_diattenuator(k0, k1, t_min, t_max, axis=(1.0, 0.0, 0.0)):
    """Linear diattenuator: amplitude t_max along the axis, t_min across."""
    us, up, *_ = _axis_in_basis(k0, k1, axis)
    j00 = t_max * us**2 + t_min * up**2
    j0x = (t_max - t_min) * us * up
    j11 = t_max * up**2 + t_min * us**2
    return _assemble(j00, j0x, j0x, j11, 1.0, k0.shape[0], **_like(k0))


def linear_retarder(k0, k1, retardance, axis=(1.0, 0.0, 0.0)):
    """Linear retarder of `retardance` radians about a global fast axis."""
    us, up, *_ = _axis_in_basis(k0, k1, axis)
    d = torch.as_tensor(retardance, dtype=k0.dtype, device=k0.device)
    j00 = torch.exp(-0.5j * d) * us**2 + torch.exp(0.5j * d) * up**2
    j0x = -2j * torch.sin(d / 2) * us * up
    j11 = torch.exp(0.5j * d) * us**2 + torch.exp(-0.5j * d) * up**2
    return _assemble(j00, j0x, j0x, j11, 1.0, k0.shape[0], **_like(k0))


def _fast_axis(theta, k0):
    th = torch.as_tensor(theta, dtype=k0.dtype, device=k0.device)
    return [torch.cos(th), torch.sin(th), 0.0]


def quarter_wave_retarder(k0, k1, theta=0.0):
    return linear_retarder(k0, k1, math.pi / 2, _fast_axis(theta, k0))


def half_wave_retarder(k0, k1, theta=0.0):
    return linear_retarder(k0, k1, math.pi, _fast_axis(theta, k0))
