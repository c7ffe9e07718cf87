"""Polarization ray tracing (PRT): a 3x3 complex matrix per ray.

Port of `optiland_tpu/polarization/prt.py`: each ray carries a complex
3x3 matrix `p`, composed at every surface as p <- (O_out J O_in) p, where
O_in and O_out rotate between global coordinates and the local (s, p, k)
basis before and after the interaction. Everything is batched over a
leading ray axis, (N, 3, 3); the complex dtype is the partner of the
directions' real dtype (complex128 for float64, complex64 for float32).
"""

from __future__ import annotations

import cmath

import torch

from optiland_tpu_torch import config


def complex_of(dtype) -> torch.dtype:
    """The complex dtype that pairs with a real dtype: complex128 for
    float64, complex64 otherwise."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def identity_prt(n: int, dtype=None, device=None):
    """n identity PRT matrices, (n, 3, 3), in `dtype` (default
    `config.complex_dtype()`)."""
    dtype = dtype or config.complex_dtype()
    return torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3)


def _axis(v, like):
    """The 3-vector `v` as a tensor broadcast to `like`'s (N, 3) shape."""
    return torch.as_tensor(v, dtype=like.dtype,
                           device=like.device).expand(like.shape)


def local_basis(k0, k1):
    """s/p basis vectors and rotation matrices for an interaction.

    Args:
        k0: (N, 3) incident directions. k1: (N, 3) outgoing directions.
    Returns:
        (s, p0, p1, o_in, o_out): o_in has rows (s, p0, k0) and projects
        global vectors into the incident local frame; o_out has columns
        (s, p1, k1) and maps local exit components back to global.

    Where k0 and k1 are (nearly) parallel, normal incidence or an
    index-matched face, s is any transverse vector. The test is against a
    tolerance of 100 eps of the dtype, not exact zero, as in the JAX
    package: the card's elementwise kernels contract the cross product's
    multiply-subtract into FMAs, so cross(k, k) is O(eps) noise there, and
    an s normalized from that noise is not perpendicular to k (a
    non-orthogonal rotation)."""
    s = torch.linalg.cross(k0, k1, dim=-1)
    mag = torch.linalg.norm(s, dim=-1, keepdim=True)
    eps = 100.0 * torch.finfo(k0.dtype).eps
    p_fb = torch.linalg.cross(k0, _axis([1.0, 0.0, 0.0], k0), dim=-1)
    p_fb_norm = torch.linalg.norm(p_fb, dim=-1, keepdim=True)
    p_fb = torch.where(p_fb_norm < eps,
                       torch.linalg.cross(k0, _axis([0.0, 1.0, 0.0], k0),
                                          dim=-1), p_fb)
    s_fb = torch.linalg.cross(p_fb, k0, dim=-1)
    s = torch.where(mag < eps, s_fb, s)
    s = s / torch.linalg.norm(s, dim=-1, keepdim=True)
    p0 = torch.linalg.cross(k0, s, dim=-1)
    p1 = torch.linalg.cross(k1, s, dim=-1)
    o_in = torch.stack((s, p0, k0), dim=1)   # rows
    o_out = torch.stack((s, p1, k1), dim=2)  # columns
    return s, p0, p1, o_in, o_out


def surface_prt(k0, k1, jones_matrix=None):
    """The surface's polarization matrix O_out [J] O_in, (N, 3, 3)."""
    _, _, _, o_in, o_out = local_basis(k0, k1)
    if jones_matrix is None:
        return torch.einsum("nij,njk->nik", o_out, o_in)
    o_outc = o_out.to(jones_matrix.dtype)
    o_inc = o_in.to(jones_matrix.dtype)
    return torch.einsum("nij,njk,nkl->nil", o_outc, jones_matrix, o_inc)


def initial_field(k, state):
    """The 3-D E field of the starting rays of direction k (N, 3):
    Ex e^{i phase_x} s + Ey e^{i phase_y} p, with p = (k x x)/|k x x| and
    s = p x k."""
    p = torch.linalg.cross(k, _axis([1.0, 0.0, 0.0], k), dim=-1)
    p = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    s = torch.linalg.cross(p, k, dim=-1)
    return (state.Ex * cmath.exp(1j * state.phase_x) * s
            + state.Ey * cmath.exp(1j * state.phase_y) * p)


def _states(state):
    """The coherent states that `state` is traced as: itself, or, for
    unpolarized light, the x and y linear states."""
    from optiland_tpu_torch.polarization.state import PolarizationState

    if state is not None and state.is_polarized:
        return [state]
    return [PolarizationState(True, 1.0, 0.0, 0.0, 0.0),
            PolarizationState(True, 0.0, 1.0, 0.0, 0.0)]


def exit_fields(p_matrix, k0, i0, state):
    """The exit E fields, one (N, 3) complex tensor per coherent state,
    scaled by sqrt(i0 / number of states)."""
    states = _states(state)
    scale = torch.sqrt(i0 / len(states))[..., None]
    return [torch.einsum("nij,nj->ni", p_matrix,
                         initial_field(k0, st).to(p_matrix.dtype)) * scale
            for st in states]


def intensity_from_prt(p_matrix, k0, i0, state):
    """The final intensity from the PRT matrices: |p E0|^2 averaged over
    the coherent states, times the launch intensity i0."""
    states = _states(state)
    total = 0.0
    for st in states:
        E1 = torch.einsum("nij,nj->ni", p_matrix,
                          initial_field(k0, st).to(p_matrix.dtype))
        # |E|^2 as re^2 + im^2: abs() has no derivative at E = 0 (crossed
        # polarizers)
        total = total + torch.sum(E1.real ** 2 + E1.imag ** 2, dim=-1)
    return total * i0 / len(states)
