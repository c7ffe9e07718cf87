"""Pickups and solves: prescription constraints applied on update.

Port of `optiland_tpu/system/solves.py` (the reference's `pickup.py:19-285`
and `solves/*.py`). Both edit the SurfaceSpec list, so that the next build
sees the constrained prescription; the ray data come from the paraxial
engine and the real trace on the device of the optic's last build, read
back to the host as numpy.
"""

from __future__ import annotations

import math

import numpy as np


def _host(a):
    """A tensor's values as a flat float64 numpy array."""
    return a.detach().cpu().double().numpy().ravel()


class Pickup:
    """target.attr := source.attr * scale + offset (reference `Pickup`)."""

    _ATTRS = ("radius", "conic", "thickness")

    def __init__(self, optic, source_surface_idx, attr_type,
                 target_surface_idx, scale=1.0, offset=0.0):
        if attr_type not in self._ATTRS:
            raise ValueError(f"attr_type must be one of {self._ATTRS}")
        self.optic = optic
        self.source_surface_idx = source_surface_idx
        self.attr_type = attr_type
        self.target_surface_idx = target_surface_idx
        self.scale = scale
        self.offset = offset

    def apply(self):
        specs = self.optic.surfaces.specs
        val = getattr(specs[self.source_surface_idx], self.attr_type)
        new = val * self.scale + self.offset
        setattr(specs[self.target_surface_idx], self.attr_type, new)
        self.optic._dirty()


class PickupManager:
    def __init__(self, optic):
        self.optic = optic
        self.pickups: list[Pickup] = []

    def __len__(self):
        return len(self.pickups)

    def add(self, source_surface_idx, attr_type, target_surface_idx,
            scale=1.0, offset=0.0):
        p = Pickup(self.optic, source_surface_idx, attr_type,
                   target_surface_idx, scale, offset)
        self.pickups.append(p)
        p.apply()
        return p

    def apply(self):
        for p in self.pickups:
            p.apply()

    def clear(self):
        self.pickups = []


class BaseSolve:
    def apply(self):
        raise NotImplementedError


class MarginalRayHeightSolve(BaseSolve):
    """Thickness solve: move surface `surface_idx` (and everything after) so
    the marginal ray height there equals `height`
    (reference `solves/thickness.py:56-90`)."""

    ray = "marginal"

    def __init__(self, optic, surface_idx: int, height: float = 0.0):
        self.optic = optic
        self.surface_idx = surface_idx
        self.height = height

    def _yu(self):
        if self.ray == "marginal":
            return self.optic.paraxial.marginal_ray()
        return self.optic.paraxial.chief_ray()

    def apply(self):
        y, u = self._yu()
        y = _host(y)
        u = _host(u)
        k = self.surface_idx
        u_in = u[0] if k == 0 else u[k - 1]
        if u_in == 0:
            return
        offset = float((self.height - y[k]) / u_in)
        # shift this surface by changing the preceding gap; keep all later
        # vertex positions (gap after k shrinks by the same amount)
        specs = self.optic.surfaces.specs
        specs[k - 1].thickness += offset
        if k < len(specs) - 1:
            specs[k].thickness -= offset
        self.optic._dirty()


class ChiefRayHeightSolve(MarginalRayHeightSolve):
    ray = "chief"


class QuickFocusSolve(BaseSolve):
    """Move the image plane to the RMS-optimal focus
    (reference `solves/quick_focus.py:14-80`)."""

    def __init__(self, optic, *args):
        self.optic = optic
        if len(optic.surfaces) <= 2:
            raise ValueError("Cannot focus an empty optical system")

    def apply(self):
        hist = self.optic.trace(Hx=0, Hy=0,
                                wavelength=self.optic.primary_wavelength,
                                num_rays=5, distribution="hexapolar",
                                device=self.optic.device)
        L, M, N, x, y, z = (_host(a[-1]) for a in (
            hist.L, hist.M, hist.N, hist.x, hist.y, hist.z))
        A = L**2 + M**2
        B = L * x + M * y
        with np.errstate(divide="ignore", invalid="ignore"):
            t_opt = np.where(A != 0, -B / A, np.nan)
        z_focus = np.nanmean(z + t_opt * N)
        specs = self.optic.surfaces.specs
        specs[-2].thickness += float(z_focus - z.mean())
        self.optic._dirty()


class MarginalRayAngleCurvatureSolve(BaseSolve):
    """Curvature solve: set surface curvature so the outgoing marginal ray
    slope equals `angle` (reference `solves/curvature.py:71-155`)."""

    ray = "marginal"

    def __init__(self, optic, surface_idx: int, angle: float):
        self.optic = optic
        self.surface_idx = surface_idx
        self.angle = angle

    def apply(self):
        from optiland_tpu_torch.system import paraxial as px

        optic = self.optic
        if self.ray == "marginal":
            y, u = optic.paraxial.marginal_ray()
        else:
            y, u = optic.paraxial.chief_ray()
        y = _host(y)
        u = _host(u)
        k = self.surface_idx
        u_in = u[0] if k == 0 else u[k - 1]
        static, params = optic.build(device=optic.device)
        n = _host(px.index_table(static, params, optic.primary_wavelength))
        n_pre = n[k - 1]
        n_post = n[k]
        dn = n_post - n_pre
        if dn == 0 or y[k] == 0:
            return
        c = float((n_pre * u_in - n_post * self.angle) / (y[k] * dn))
        specs = optic.surfaces.specs
        specs[k].radius = math.inf if c == 0 else 1.0 / c
        optic._dirty()


class ChiefRayAngleCurvatureSolve(MarginalRayAngleCurvatureSolve):
    ray = "chief"


_SOLVE_MAP = {
    "marginal_ray_height": MarginalRayHeightSolve,
    "marginal_ray_height_thickness": MarginalRayHeightSolve,
    "chief_ray_height": ChiefRayHeightSolve,
    "chief_ray_height_thickness": ChiefRayHeightSolve,
    "quick_focus": QuickFocusSolve,
    "marginal_ray_angle_curvature": MarginalRayAngleCurvatureSolve,
    "chief_ray_angle_curvature": ChiefRayAngleCurvatureSolve,
}


class SolveManager:
    def __init__(self, optic):
        self.optic = optic
        self.solves: list[BaseSolve] = []

    def __len__(self):
        return len(self.solves)

    def add(self, solve_type: str, *args, apply: bool = True, **kwargs):
        cls = _SOLVE_MAP.get(solve_type)
        if cls is None:
            raise ValueError(
                f"Unknown solve type {solve_type!r}; expected one of "
                f"{sorted(_SOLVE_MAP)}"
            )
        solve = cls(self.optic, *args, **kwargs)
        self.solves.append(solve)
        if apply:
            solve.apply()
        return solve

    def apply(self):
        for s in self.solves:
            s.apply()

    def clear(self):
        self.solves = []
