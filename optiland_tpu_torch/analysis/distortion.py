"""Distortion analyses (port of `optiland_tpu/analysis/distortion.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import (
    like,
    linspace,
    resolve_wavelengths,
)


class Distortion:
    """Percent distortion vs normalized field height (chief-ray based), on
    the device of the optic's build (the CUDA card unless `device="cpu"`).

    data[k] is the (num_points,) distortion curve for wavelength k. Its
    constant comes from the chief ray at Hy = 1e-10, whose image height
    is rounding-bound (a float32 trace resolves ~1e-7 of the field)."""

    def __init__(self, optic, wavelengths="all", num_points: int = 128,
                 distortion_type: str = "f-tan", device=None):
        if distortion_type not in ("f-tan", "f-theta"):
            raise ValueError('Distortion type must be "f-tan" or "f-theta"')
        self.optic = optic
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        self.num_points = num_points
        self.distortion_type = distortion_type
        max_field_rad = math.radians(optic.fields.max_field)

        _, params = optic.build(device=device)
        Hy = linspace(1e-10, 1.0, num_points, params.cv)
        Hx = torch.zeros_like(Hy)
        self.data = []
        for w in self.wavelengths:
            hist = optic.trace_generic(Hx, Hy, 0.0, 0.0, wavelength=w,
                                       device=device)
            yr = hist.y[-1]
            const = yr[0] / math.tan(1e-10 * max_field_rad)
            if distortion_type == "f-tan":
                yp = const * torch.tan(Hy * max_field_rad)
            else:
                yp = const * Hy * max_field_rad
            self.data.append((yr - yp) / yp * 100.0)

    def view(self, figsize=(7, 5.5)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        field = np.linspace(1e-10, self.optic.fields.max_field,
                            self.num_points)
        for k, w in enumerate(self.wavelengths):
            ax.plot(self.data[k].detach().cpu().numpy(), field,
                    label=f"{w:.4f} um")
        ax.axvline(0, color="k", lw=1, ls="--")
        ax.set_xlabel("Distortion (%)")
        ax.set_ylabel("Field")
        ax.legend()
        ax.grid(True)
        return fig, ax


class GridDistortion:
    """Distorted vs ideal image grid (reference `grid_distortion.py:133-200`)."""

    def __init__(self, optic, wavelength="primary", num_points: int = 10,
                 distortion_type: str = "f-tan", device=None):
        self.optic = optic
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.wavelength = float(wavelength)
        self.num_points = num_points
        max_field_rad = math.radians(optic.fields.max_field)

        # chief + small-field reference rays
        h0 = optic.trace_generic(0.0, 0.0, 0.0, 0.0,
                                 wavelength=self.wavelength, device=device)
        y_chief = h0.y[-1][0]
        h1 = optic.trace_generic(0.0, 1e-10, 0.0, 0.0,
                                 wavelength=self.wavelength, device=device)
        y_ref = h1.y[-1][0]

        max_field = np.sqrt(2) / 2
        extent = np.linspace(-max_field, max_field, num_points)
        _, params = optic.build(device=device)
        Hx, Hy = (like(a, params) for a in np.meshgrid(extent, extent))

        if distortion_type == "f-tan":
            const = (y_ref - y_chief) / math.tan(1e-10 * max_field_rad)
            xp = const * torch.tan(Hx * max_field_rad)
            yp = const * torch.tan(Hy * max_field_rad)
        elif distortion_type == "f-theta":
            const = (y_ref - y_chief) / (1e-10 * max_field_rad)
            xp = const * Hx * max_field_rad
            yp = const * Hy * max_field_rad
        else:
            raise ValueError('Distortion type must be "f-tan" or "f-theta"')

        hist = optic.trace_generic(Hx.ravel(), Hy.ravel(), 0.0, 0.0,
                                   wavelength=self.wavelength, device=device)
        xr = hist.x[-1].reshape(num_points, num_points)
        yr = hist.y[-1].reshape(num_points, num_points)
        delta = torch.sqrt((xr - xp) ** 2 + (yr - yp) ** 2)
        rp = torch.sqrt(xp**2 + yp**2)
        self.data = {
            "xp": xp, "yp": yp, "xr": xr, "yr": yr,
            "max_distortion": torch.amax(
                delta / torch.clamp(rp, min=1e-12) * 100.0),
        }

    def view(self, figsize=(7, 7)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        d = {k: v.detach().cpu().numpy() for k, v in self.data.items()
             if k != "max_distortion"}
        ax.plot(d["xp"], d["yp"], "k-", lw=0.5)
        ax.plot(d["xp"].T, d["yp"].T, "k-", lw=0.5)
        ax.plot(d["xr"], d["yr"], "r-", lw=0.7)
        ax.plot(d["xr"].T, d["yr"].T, "r-", lw=0.7)
        ax.set_aspect("equal")
        ax.set_title(
            f"Max distortion: {float(self.data['max_distortion']):.3f}%"
        )
        return fig, ax
