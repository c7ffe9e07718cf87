"""Operand library: named metric functions of (static, params).

Port of `optiland_tpu/optimization/operands.py`: the reference's operand
registry (`optimization/operand/operand.py:29-151` and its paraxial,
aberration, ray and lens modules) with the same names and semantics, each
a function of `(static, params, **input_data)` that returns a scalar
tensor, differentiable by autograd.

The ray operands call `trace_system`: on the CUDA card in float32 a system
inside the fused gate is one launch of K7 per call (a single ray for the
`real_*`, `AOI` and `clearance` operands, the pupil distribution for
`rms_spot_size` and `OPD_difference`), differentiated through the eager
twin; on the CPU, and in float64, the eager trace.
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch.core import distributions as dist
from optiland_tpu_torch.system import aberrations as ab
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.trace.raygen import vignetting_factors
from optiland_tpu_torch.trace.tracer import trace_system


def _like(params, value):
    """`value` as a tensor of the parameters' dtype and device."""
    return torch.as_tensor(value, dtype=params.cv.dtype,
                           device=params.cv.device)


def _trace_single(static, params, Hx, Hy, Px, Py, wavelength):
    """Trace one ray with trace_generic vignetting semantics."""
    Hx, Hy, Px, Py = (torch.atleast_1d(_like(params, a))
                      for a in (Hx, Hy, Px, Py))
    vxf, vyf = vignetting_factors(static, params, Hx, Hy)
    return trace_system(static, params, Hx, Hy, Px * (1 - vxf),
                        Py * (1 - vyf), _like(params, wavelength),
                        apply_vignetting=False)


def _pupil(params, distribution, num_rays):
    """(Px, Py) of a named distribution on the parameters' device."""
    out = dist.generate(distribution, num_rays)
    return _like(params, out[0]), _like(params, out[1])


# -- paraxial --------------------------------------------------------------

def f1(static, params):
    return px.f1(static, params)


def f2(static, params):
    return px.f2(static, params)


def F1(static, params):
    return px.F1(static, params)


def F2(static, params):
    return px.F2(static, params)


def P1(static, params):
    return px.P1(static, params)


def P2(static, params):
    return px.P2(static, params)


def N1(static, params):
    return px.N1(static, params)


def N2(static, params):
    return px.N2(static, params)


def EPD(static, params):
    return px.EPD(static, params)


def EPL(static, params):
    return px.EPL(static, params)


def XPD(static, params):
    return px.XPD(static, params)


def XPL(static, params):
    return px.XPL(static, params)


def FNO(static, params):
    return px.FNO(static, params)


def magnification(static, params):
    return px.magnification(static, params)


def total_track(static, params):
    """Vertex distance from first surface to image plane."""
    from optiland_tpu_torch.system.spec import positions_of

    pos = positions_of(static, params)
    return pos[-1] - pos[1]


# -- aberrations -----------------------------------------------------------

def seidel(static, params, seidel_number):
    return ab.seidels(static, params)[seidel_number - 1]


def _per_surface(fn):
    def op(static, params, surface_number):
        return fn(static, params)[surface_number]

    return op


def _summed(fn):
    def op(static, params):
        return torch.sum(fn(static, params))

    return op


TSC = _per_surface(ab.TSC)
SC = _per_surface(ab.SC)
CC = _per_surface(ab.CC)
TCC = _per_surface(ab.TCC)
TAC = _per_surface(ab.TAC)
AC = _per_surface(ab.AC)
TPC = _per_surface(ab.TPC)
PC = _per_surface(ab.PC)
DC = _per_surface(ab.DC)
TAchC = _per_surface(ab.TAchC)
LchC = _per_surface(ab.LchC)
TchC = _per_surface(ab.TchC)

TSC_sum = _summed(ab.TSC)
SC_sum = _summed(ab.SC)
CC_sum = _summed(ab.CC)
TCC_sum = _summed(ab.TCC)
TAC_sum = _summed(ab.TAC)
AC_sum = _summed(ab.AC)
TPC_sum = _summed(ab.TPC)
PC_sum = _summed(ab.PC)
DC_sum = _summed(ab.DC)
TAchC_sum = _summed(ab.TAchC)
LchC_sum = _summed(ab.LchC)
TchC_sum = _summed(ab.TchC)


# -- real-ray --------------------------------------------------------------

def real_x_intercept(static, params, surface_number, Hx, Hy, Px, Py,
                     wavelength):
    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    return hist.x[surface_number, 0]


def real_y_intercept(static, params, surface_number, Hx, Hy, Px, Py,
                     wavelength):
    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    return hist.y[surface_number, 0]


def real_z_intercept(static, params, surface_number, Hx, Hy, Px, Py,
                     wavelength):
    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    return hist.z[surface_number, 0]


def real_L(static, params, surface_number, Hx, Hy, Px, Py, wavelength):
    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    return hist.L[surface_number, 0]


def real_M(static, params, surface_number, Hx, Hy, Px, Py, wavelength):
    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    return hist.M[surface_number, 0]


def real_N(static, params, surface_number, Hx, Hy, Px, Py, wavelength):
    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    return hist.N[surface_number, 0]


def rms_spot_size(static, params, surface_number=-1, Hx=0.0, Hy=0.0,
                  num_rays=100, wavelength=0.5876,
                  distribution="hexapolar"):
    """RMS spot about the unweighted spot mean at `surface_number`
    (reference `operand/ray.py:300-340`)."""
    Px, Py = _pupil(params, distribution, num_rays)
    hist = trace_system(static, params,
                        torch.full_like(Px, Hx), torch.full_like(Px, Hy),
                        Px, Py, _like(params, wavelength))
    x = hist.x[surface_number]
    y = hist.y[surface_number]
    r2 = (x - torch.mean(x)) ** 2 + (y - torch.mean(y)) ** 2
    return torch.sqrt(torch.mean(r2))


def OPD_difference(static, params, Hx, Hy, num_rays, wavelength,
                   distribution="gaussian_quad"):
    """Mean |OPD - weighted-mean OPD| over a pupil distribution
    (reference `operand/ray.py:343-400`)."""
    if distribution == "gaussian_quad":
        Px, Py, weights = (_like(params, a) for a in dist.gaussian_quadrature(
            num_rays, symmetric=(Hx == 0 and Hy == 0)))
        weights = weights * 2.0 * math.pi
    else:
        Px, Py = _pupil(params, distribution, num_rays)
        weights = torch.ones_like(Px)
    hist = trace_system(static, params,
                        torch.full_like(Px, Hx), torch.full_like(Px, Hy),
                        Px, Py, _like(params, wavelength))
    opd = hist.opd[-1]
    mean_opd = torch.sum(weights * opd) / torch.sum(weights)
    return torch.sum(torch.abs(opd - mean_opd) * weights) / torch.sum(weights)


def AOI(static, params, surface_number, Hx, Hy, Px, Py, wavelength):
    """Angle of incidence (degrees) at a surface for a single ray."""
    from optiland_tpu_torch.geometry.surfaces import surface_normal

    hist = _trace_single(static, params, Hx, Hy, Px, Py, wavelength)
    # incident direction = direction recorded at previous surface
    L0 = hist.L[surface_number - 1, 0]
    M0 = hist.M[surface_number - 1, 0]
    N0 = hist.N[surface_number - 1, 0]
    k = surface_number
    nx, ny, nz = surface_normal(
        static.geom_codes[k], static.geom_n_coeffs[k],
        hist.x[k, 0], hist.y[k, 0], params.cv[k], params.conic[k],
        params.coeffs[k], aux=static.geom_aux[k],
    )
    cosa = torch.abs(L0 * nx + M0 * ny + N0 * nz)
    # JAX's clip: min(max(x, -1), 1), whose derivative splits a tie evenly
    one = torch.ones_like(cosa)
    return torch.rad2deg(torch.arccos(torch.minimum(torch.maximum(cosa, -one),
                                                    one)))


def clearance(static, params, line_ray, point_ray, wavelength):
    """Perpendicular distance from a point-ray hit to a line ray
    (reference `operand/ray.py` clearance)."""
    lh = _trace_single(static, params, *line_ray, wavelength)
    ph = _trace_single(static, params, *point_ray, wavelength)
    y0, z0 = lh.y[-2, 0], lh.z[-2, 0]
    M, N = lh.M[-2, 0], lh.N[-2, 0]
    yp, zp = ph.y[-2, 0], ph.z[-2, 0]
    return ((zp - z0) * M - (yp - y0) * N) / torch.sqrt(M * M + N * N)


# -- lens ------------------------------------------------------------------

def edge_thickness(static, params, surface_number, semi_apertures):
    """Edge gap between surface k and k+1 at given semi-apertures.

    `semi_apertures` must be provided (host-side: optic.semi_apertures or
    explicit); sag evaluated at the aperture height.
    """
    from optiland_tpu_torch.geometry.surfaces import sag

    k = surface_number
    r1, r2 = semi_apertures
    zero = _like(params, 0.0)
    z1 = sag(static.geom_codes[k], static.geom_n_coeffs[k],
             zero, _like(params, r1), params.cv[k], params.conic[k],
             params.coeffs[k], aux=static.geom_aux[k])
    z2 = sag(static.geom_codes[k + 1], static.geom_n_coeffs[k + 1],
             zero, _like(params, r2), params.cv[k + 1],
             params.conic[k + 1], params.coeffs[k + 1],
             aux=static.geom_aux[k + 1])
    return params.thickness[k] - z1 + z2


REGISTRY = {
    "f1": f1, "f2": f2, "F1": F1, "F2": F2, "P1": P1, "P2": P2,
    "N1": N1, "N2": N2, "EPD": EPD, "EPL": EPL, "XPD": XPD, "XPL": XPL,
    "FNO": FNO, "magnification": magnification, "total_track": total_track,
    "seidel": seidel,
    "TSC": TSC, "SC": SC, "CC": CC, "TCC": TCC, "TAC": TAC, "AC": AC,
    "TPC": TPC, "PC": PC, "DC": DC, "TAchC": TAchC, "LchC": LchC,
    "TchC": TchC,
    "TSC_sum": TSC_sum, "SC_sum": SC_sum, "CC_sum": CC_sum,
    "TCC_sum": TCC_sum, "TAC_sum": TAC_sum, "AC_sum": AC_sum,
    "TPC_sum": TPC_sum, "PC_sum": PC_sum, "DC_sum": DC_sum,
    "TAchC_sum": TAchC_sum, "LchC_sum": LchC_sum, "TchC_sum": TchC_sum,
    "real_x_intercept": real_x_intercept,
    "real_y_intercept": real_y_intercept,
    "real_z_intercept": real_z_intercept,
    "real_L": real_L, "real_M": real_M, "real_N": real_N,
    "rms_spot_size": rms_spot_size,
    "OPD_difference": OPD_difference,
    "AOI": AOI,
    "clearance": clearance,
    "edge_thickness": edge_thickness,
}


def register(name, fn, overwrite: bool = False):
    """Register a custom operand (reference `OperandRegistry.register`)."""
    if name in REGISTRY and not overwrite:
        raise ValueError(f"Operand {name!r} is already registered.")
    REGISTRY[name] = fn
