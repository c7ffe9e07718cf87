"""Pupil aberration and incident angle vs height (port of
`optiland_tpu/analysis/pupil_aberration.py`)."""

from __future__ import annotations

import numpy as np

from optiland_tpu_torch.analysis.base import (
    like,
    resolve_fields,
    resolve_wavelengths,
)
from optiland_tpu_torch.system import paraxial as px


def _np(a):
    return a.detach().cpu().numpy()


class PupilAberration:
    """Percent deviation of the real stop-surface intercepts from the
    paraxial prediction, normalized by the paraxial stop radius (reference
    `analysis/pupil_aberration.py:180-245`); traced on the device of the
    optic's build (the CUDA card unless `device="cpu"`), the curves numpy
    arrays with the vignetted rays NaN, as in JAX."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_points: int = 32, device=None):
        self.optic = optic
        self.fields = resolve_fields(optic, fields)
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        if num_points % 2 == 0:
            num_points += 1
        self.num_points = num_points

        static, params = optic.build(device=device)
        stop = static.stop_index

        # paraxial reference: y at stop for a pupil scan = Py * y_marginal
        ym, _ = px.marginal_ray(static, params)
        d = _np(ym).ravel()[stop]
        P = np.linspace(-1.0, 1.0, num_points)
        parax_ref = P * d

        self.data = {"Px": P, "Py": P}
        for field in self.fields:
            fx = {}
            for w in self.wavelengths:
                hx = optic.trace(Hx=field[0], Hy=field[1], wavelength=w,
                                 num_rays=num_points, distribution="line_x",
                                 device=device)
                hy = optic.trace(Hx=field[0], Hy=field[1], wavelength=w,
                                 num_rays=num_points, distribution="line_y",
                                 device=device)
                ex = (parax_ref - _np(hx.x[stop])) / d * 100.0
                ey = (parax_ref - _np(hy.y[stop])) / d * 100.0
                ex[_np(hx.intensity[stop]) == 0] = np.nan
                ey[_np(hy.intensity[stop]) == 0] = np.nan
                fx[w] = {"x": ex, "y": ey}
            self.data[field] = fx

    def view(self, figsize=(10, 3.33)):
        import matplotlib.pyplot as plt

        F = len(self.fields)
        fig, axs = plt.subplots(F, 2, figsize=(figsize[0], figsize[1] * F),
                                squeeze=False)
        for k, field in enumerate(self.fields):
            for w in self.wavelengths:
                axs[k, 0].plot(self.data["Py"], self.data[field][w]["y"],
                               label=f"{w:.4f} um")
                axs[k, 1].plot(self.data["Px"], self.data[field][w]["x"])
            axs[k, 0].set_title(f"Hy={field[1]:.2f} tangential")
            axs[k, 1].set_title(f"Hx={field[0]:.2f} sagittal")
            axs[k, 0].set_ylabel("Pupil aberration (%)")
        axs[0, 0].legend()
        fig.tight_layout()
        return fig, axs


class AngleVsHeight:
    """Incident angle vs height at a surface, swept over field or pupil
    (reference `analysis/angle_vs_height.py`); numpy curves, as in JAX."""

    def __init__(self, optic, surface_idx: int = -1, axis: int = 1,
                 wavelength="primary", num_points: int = 128,
                 scan: str = "field", fixed=(0.0, 0.0), device=None):
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.optic = optic
        self.surface_idx = surface_idx
        self.axis = axis
        s = np.linspace(-1.0, 1.0, num_points)
        zeros = np.zeros(num_points)
        if scan == "field":
            Hx, Hy = (s, zeros) if axis == 0 else (zeros, s)
            Px, Py = np.full(num_points, fixed[0]), np.full(num_points, fixed[1])
        else:
            Px, Py = (s, zeros) if axis == 0 else (zeros, s)
            Hx, Hy = np.full(num_points, fixed[0]), np.full(num_points, fixed[1])
        _, params = optic.build(device=device)
        hist = optic.trace_generic(*(like(a, params) for a in (Hx, Hy, Px, Py)),
                                   wavelength=wavelength, device=device)
        if axis == 1:
            dcos, height = hist.M[surface_idx], hist.y[surface_idx]
        else:
            dcos, height = hist.L[surface_idx], hist.x[surface_idx]
        self.scan = s
        self.data = {"height": _np(height),
                     "angle": np.degrees(np.arcsin(np.clip(_np(dcos), -1, 1)))}

    def view(self, figsize=(7, 4.5)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        ax.plot(self.data["height"], self.data["angle"])
        ax.set_xlabel("Height (mm)")
        ax.set_ylabel("Incident angle (deg)")
        ax.grid(True)
        return fig, ax


class PupilIncidentAngleVsHeight(AngleVsHeight):
    """Angle vs height swept over pupil coordinates at a fixed field —
    telecentricity after a point source (reference
    `analysis/angle_vs_height.py:322-400`)."""

    def __init__(self, optic, surface_idx: int = -1, axis: int = 1,
                 wavelength="primary", num_points: int = 128,
                 Hx: float = 0.0, Hy: float = 0.0, device=None):
        super().__init__(optic, surface_idx, axis, wavelength, num_points,
                         scan="pupil", fixed=(Hx, Hy), device=device)


class FieldIncidentAngleVsHeight(AngleVsHeight):
    """Angle vs height swept over field coordinates at a fixed pupil point
    — scan-lens telecentricity (reference
    `analysis/angle_vs_height.py:401-480`)."""

    def __init__(self, optic, surface_idx: int = -1, axis: int = 1,
                 wavelength="primary", num_points: int = 128,
                 Px: float = 0.0, Py: float = 0.0, device=None):
        super().__init__(optic, surface_idx, axis, wavelength, num_points,
                         scan="field", fixed=(Px, Py), device=device)
