"""Optimization variables: named views into the SystemParams tensors.

Port of `optiland_tpu/optimization/variables.py`. A variable is a (get,
set) pair on the parameter dataclass plus a scaler; the optimizer works in
scaled space and `apply_all` writes the scaled vector into a new
`SystemParams`. `Variable.set` is out of place (`index_put`): the optic's
cached build keeps its tensors, and autograd carries the gradient from the
new tensor back to the value written.

Scalers mirror `optimization/scaling/`: identity, linear, log, reciprocal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


class Scaler:
    def scale(self, value):
        raise NotImplementedError

    def inverse_scale(self, value):
        raise NotImplementedError


class IdentityScaler(Scaler):
    def scale(self, value):
        return value

    def inverse_scale(self, value):
        return value


@dataclass
class LinearScaler(Scaler):
    factor: float = 1.0
    offset: float = 0.0

    def scale(self, value):
        return value * self.factor + self.offset

    def inverse_scale(self, value):
        return (value - self.offset) / self.factor


class LogScaler(Scaler):
    def scale(self, value):
        return torch.log(value) if torch.is_tensor(value) else math.log(value)

    def inverse_scale(self, value):
        return torch.exp(value) if torch.is_tensor(value) else math.exp(value)


class ReciprocalScaler(Scaler):
    def scale(self, value):
        return 1.0 / value

    def inverse_scale(self, value):
        return 1.0 / value


# default scalers per variable kind, identical to the reference's defaults
# (`optimization/variable/{radius,thickness,index,reciprocal_radius,
# asphere_coeff,conic,tilt,decenter}.py`)
_DEFAULT_SCALERS = {
    "radius": LinearScaler(factor=1.0 / 100.0, offset=-1.0),
    "reciprocal_radius": LinearScaler(factor=10.0),
    "conic": IdentityScaler(),
    "thickness": LinearScaler(factor=1.0 / 10.0, offset=-1.0),
    "index": LinearScaler(factor=1.0, offset=-1.5),
    "decenter_x": IdentityScaler(),
    "decenter_y": IdentityScaler(),
    "tilt_x": IdentityScaler(),
    "tilt_y": IdentityScaler(),
    "tilt_z": IdentityScaler(),
    "focal_length": IdentityScaler(),
}


# geometry-coefficient kinds addressing the packed params.coeffs row; the
# logical coefficient index is shifted by extra["offset"] (the packed
# layouts of `system/spec.py`: chebyshev [norm_x, norm_y, C...],
# zernike/forbes [norm_radius, ...], toroidal [cv_rot, poly...], grid sag
# [xs..., ys..., sag...], NURBS [U, V, W, Px, Py, Pz]). Offsets are computed
# by `geom_coeff_offset` / OptimizationProblem.add_variable (reference
# counterparts: `optimization/variable/{chebyshev,zernike,forbes,grid_sag,
# nurbs,norm_radius}.py`).
_GEOM_COEFF_KINDS = frozenset({
    "chebyshev_coeff", "zernike_coeff", "forbes_coeff", "toroidal_coeff",
    "grid_sag_coeff", "nurbs_cp_z", "geom_coeff",
})

# kind -> (SystemParams field, column or None for an (S,) field)
_SLOTS = {
    "reciprocal_radius": ("cv", None),
    "conic": ("conic", None),
    "thickness": ("thickness", None),
    "index": ("mat_coeffs", 0),
    "decenter_x": ("decenter", 0),
    "decenter_y": ("decenter", 1),
    "tilt_x": ("tilt", 0),
    "tilt_y": ("tilt", 1),
    "tilt_z": ("tilt", 2),
    "focal_length": ("focal_length", None),
    "norm_radius": ("coeffs", 0),
    "norm_x": ("coeffs", 0),
    "norm_y": ("coeffs", 1),
}


def geom_coeff_offset(static, kind: str, surface_number: int) -> int:
    """Packed-layout offset of logical coefficient 0 for a geometry kind."""
    if kind == "chebyshev_coeff":
        return 2
    if kind in ("zernike_coeff", "forbes_coeff", "toroidal_coeff"):
        return 1
    if kind == "grid_sag_coeff":
        nx, ny = static.geom_aux[surface_number]
        return nx + ny
    if kind == "nurbs_cp_z":
        p, q, nu, nv = static.geom_aux[surface_number][:4]
        return (nu + p + 1) + (nv + q + 1) + 3 * nu * nv
    return 0


def _put(t: torch.Tensor, index: tuple, value) -> torch.Tensor:
    """A copy of `t` with `value` at `index` (JAX's `.at[index].set`)."""
    idx = tuple(torch.tensor(i, device=t.device) for i in index)
    return t.index_put(idx, torch.as_tensor(value, dtype=t.dtype,
                                            device=t.device))


@dataclass
class Variable:
    """One optimizable scalar in the system.

    kind: one of _DEFAULT_SCALERS keys.
    surface_number: index into the surface axis.
    coeff_number: coefficient index for asphere/polynomial kinds.
    bounds: optional (min, max) in UNscaled space.
    """

    kind: str
    surface_number: int
    coeff_number: int = 0
    scaler: Scaler | None = None
    bounds: tuple[float | None, float | None] = (None, None)
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.scaler is None:
            if self.kind == "asphere_coeff":
                # order-dependent factor, as the reference
                # (`variable/asphere_coeff.py:49-51`; even asphere order = 2)
                order = self.extra.get("order", 2)
                self.scaler = LinearScaler(
                    factor=10.0 ** (4 + order * self.coeff_number)
                )
            else:
                self.scaler = _DEFAULT_SCALERS.get(self.kind, IdentityScaler())

    def _slot(self):
        """(SystemParams field, index) of this variable's scalar."""
        s = self.surface_number
        if self.kind in ("radius", *_SLOTS):
            name, col = _SLOTS.get(self.kind, ("cv", None))
            return name, (s,) if col is None else (s, col)
        if self.kind == "asphere_coeff":
            return "coeffs", (s, self.coeff_number)
        if self.kind in _GEOM_COEFF_KINDS:
            return "coeffs", (s, self.coeff_number
                              + self.extra.get("offset", 0))
        raise ValueError(f"Unknown variable kind {self.kind!r}")

    # -- raw (unscaled) parameter access -----------------------------------
    def get(self, params):
        name, index = self._slot()
        v = getattr(params, name)[index]
        if self.kind == "radius":
            return torch.where(v == 0, torch.full_like(v, math.inf), 1.0 / v)
        return v

    def set(self, params, value):
        """A new `SystemParams` with `value` written; `params` unchanged."""
        name, index = self._slot()
        if self.kind == "radius":
            value = 1.0 / value
        return params.replace(**{name: _put(getattr(params, name), index,
                                            value)})

    def __str__(self):
        extra = f"[{self.coeff_number}]" if self.kind == "asphere_coeff" else ""
        return f"{self.kind}{extra}@surface{self.surface_number}"


def apply_all(variables: list[Variable], params, x_scaled):
    """Write the scaled variable vector into a new params dataclass."""
    for i, v in enumerate(variables):
        params = v.set(params, v.scaler.inverse_scale(x_scaled[i]))
    return params


def initial_values(variables: list[Variable], params):
    """Scaled starting vector from the current params."""
    if not variables:
        return torch.zeros((0,), dtype=params.cv.dtype,
                           device=params.cv.device)
    return torch.stack([torch.as_tensor(v.scaler.scale(v.get(params)))
                        for v in variables])
