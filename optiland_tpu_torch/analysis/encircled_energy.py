"""Encircled energy (port of `optiland_tpu/analysis/encircled_energy.py`)."""

from __future__ import annotations

import torch

from optiland_tpu_torch.analysis.base import linspace
from optiland_tpu_torch.analysis.spot import SpotDiagram


class EncircledEnergy(SpotDiagram):
    """Fraction of energy inside a radius about the centroid, per field.

    Uses a random pupil distribution like the reference (energy weighting by
    ray intensity; geometric, not diffraction); its points come from an
    unseeded generator, so two calls see different rays, as in JAX."""

    def __init__(self, optic, fields="all", wavelength="primary",
                 num_rays: int = 100_000, num_points: int = 256,
                 device=None):
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.num_points_curve = num_points
        super().__init__(optic, fields=fields, wavelengths=[float(wavelength)],
                         num_rings=num_rays, distribution="random",
                         reference="centroid", device=device)

    def centroid(self):
        """Energy-weighted centroid per field (reference overrides the
        geometric centroid with an intensity weighting)."""
        i = self.intensity[:, 0]
        wsum = torch.sum(i, dim=-1) + 1e-12
        cx = torch.sum(self.x[:, 0] * i, dim=-1) / wsum
        cy = torch.sum(self.y[:, 0] * i, dim=-1) / wsum
        return [(cx[k], cy[k]) for k in range(len(self.fields))]

    def encircled_energy(self, radii=None):
        """Lists of (R,) radii and fraction-of-energy curves per field; the
        radii default to `num_points` from 0 to 1.2 x the spot's extent."""
        cents = self.centroid()
        curves = []
        radii_out = []
        for k in range(len(self.fields)):
            cx, cy = cents[k]
            r = torch.sqrt((self.x[k, 0] - cx) ** 2 + (self.y[k, 0] - cy) ** 2)
            i = self.intensity[k, 0]
            total = torch.sum(i) + 1e-12
            rmax = torch.amax(torch.where(i > 0, r, 0.0))
            rr = (linspace(0.0, 1.2, self.num_points_curve, r) * rmax
                  if radii is None else torch.as_tensor(
                      radii, dtype=r.dtype, device=r.device))
            frac = torch.sum(
                torch.where(r[None, :] <= rr[:, None], i[None, :], 0.0),
                dim=-1) / total
            curves.append(frac)
            radii_out.append(rr)
        return radii_out, curves

    def view(self, figsize=(7, 4.5)):
        import matplotlib.pyplot as plt

        radii, curves = self.encircled_energy()
        fig, ax = plt.subplots(figsize=figsize)
        for k, field in enumerate(self.fields):
            ax.plot(radii[k].detach().cpu().numpy(),
                    curves[k].detach().cpu().numpy(),
                    label=f"Hy={field[1]:.2f}")
        ax.set_xlabel("Radius (mm)")
        ax.set_ylabel("Encircled energy fraction")
        ax.legend()
        ax.grid(True)
        return fig, ax
