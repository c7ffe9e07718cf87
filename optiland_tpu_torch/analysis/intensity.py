"""Radiant intensity analysis (port of `optiland_tpu/analysis/intensity.py`).

Power per unit solid angle, binned over Zemax-style projection angles
(Angle X = atan2(L, N), Angle Y = atan2(M, N)) by an accumulating
`index_put` on the device (differentiable in the rays' power); the
absolute-units normalization applies the tan-space solid-angle Jacobian
J = sec^2(tx) sec^2(ty) / (1 + tan^2 tx + tan^2 ty)^{3/2}.
"""

from __future__ import annotations

import torch

from optiland_tpu_torch.analysis.base import (
    linspace,
    resolve_fields,
    resolve_wavelengths,
)
from optiland_tpu_torch.analysis.irradiance import bin_index


def bin_radiant_intensity(L, M, N, power, angle_x_range, angle_y_range,
                          bins, absolute_units: bool = True):
    """Histogram ray directions into an angle-space intensity map.

    Returns (map[Y, X], x_edges, y_edges, x_centers, y_centers) — the map is
    indexed [y_bin, x_bin] as the reference plots it.
    """
    nx, ny = bins
    x_edges = linspace(angle_x_range[0], angle_x_range[1], nx + 1, power)
    y_edges = linspace(angle_y_range[0], angle_y_range[1], ny + 1, power)
    x_centers = 0.5 * (x_edges[:-1] + x_edges[1:])
    y_centers = 0.5 * (y_edges[:-1] + y_edges[1:])

    valid = ((power > 1e-12) & torch.isfinite(L) & torch.isfinite(M)
             & torch.isfinite(N) & (torch.abs(N) > 1e-9))
    ax = torch.rad2deg(torch.atan2(L, N))
    ay = torch.rad2deg(torch.atan2(M, N))
    inside = (valid & (ax >= angle_x_range[0]) & (ax <= angle_x_range[1])
              & (ay >= angle_y_range[0]) & (ay <= angle_y_range[1]))
    ix = bin_index(x_edges, ax, nx)
    iy = bin_index(y_edges, ay, ny)
    w = torch.where(inside, power, 0.0)
    pmap = torch.zeros((ny, nx), dtype=power.dtype,
                       device=power.device).index_put((iy, ix), w,
                                                      accumulate=True)

    if absolute_units:
        dx = torch.deg2rad(x_edges[1] - x_edges[0])
        dy = torch.deg2rad(y_edges[1] - y_edges[0])
        AY, AX = torch.meshgrid(torch.deg2rad(y_centers),
                                torch.deg2rad(x_centers), indexing="ij")
        tan2x = torch.tan(AX) ** 2
        tan2y = torch.tan(AY) ** 2
        jac = ((1.0 + tan2x) * (1.0 + tan2y)
               / (1.0 + tan2x + tan2y) ** 1.5)
        solid = jac * dx * dy
        pmap = torch.where(solid > 1e-12, pmap / solid, 0.0)
    return pmap, x_edges, y_edges, x_centers, y_centers


class RadiantIntensity:
    """Radiant intensity maps per (field, wavelength), on the device of the
    optic's build (the CUDA card unless `device="cpu"`). The default random
    pupil comes from an unseeded generator, as in JAX."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_rays: int = 50_000, distribution: str = "random",
                 num_angular_bins=(64, 64), angle_x_range=(-30.0, 30.0),
                 angle_y_range=(-30.0, 30.0), reference_surface: int = -1,
                 use_absolute_units: bool = True, source=None, device=None):
        if source is not None:
            raise NotImplementedError(
                "RadiantIntensity(source=...) fails in the JAX package, "
                "which the port follows: its `analysis/intensity.py` "
                "imports `trace_source` from `sources`, whose "
                "`__init__.py` does not export it, and passes it a "
                "`wavelength` that `sources/base.py` `trace_source` does "
                "not take (ROADMAP queue 3, known behaviours); trace a "
                "source with `sources.base.trace_source`")
        self.optic = optic
        self.fields = resolve_fields(optic, fields)
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        self.bins = tuple(num_angular_bins)
        self.angle_x_range = angle_x_range
        self.angle_y_range = angle_y_range
        self.reference_surface = reference_surface
        k = reference_surface
        self.data = []
        for fx, fy in self.fields:
            row = []
            for w in self.wavelengths:
                hist = optic.trace(Hx=fx, Hy=fy, wavelength=w,
                                   num_rays=num_rays,
                                   distribution=distribution, device=device)
                row.append(bin_radiant_intensity(
                    hist.L[k], hist.M[k], hist.N[k], hist.intensity[k],
                    angle_x_range, angle_y_range, self.bins,
                    absolute_units=use_absolute_units))
            self.data.append(row)

    def peak_intensity_values(self):
        """Per-(field, wavelength) map maxima (reference
        `intensity.py:288-299`)."""
        return [[float(torch.amax(cell[0])) for cell in row]
                for row in self.data]

    def cross_section(self, field_idx: int = 0, wl_idx: int = 0,
                      axis: str = "x", position: float | None = None):
        """1-D slice through the intensity map at the given angular position
        (degrees; default: through the peak): (centers, values)."""
        pmap, _, _, xc, yc = self.data[field_idx][wl_idx]
        if axis == "x":
            if position is None:
                row = int(torch.argmax(pmap)) // pmap.shape[1]
            else:
                row = int(torch.argmin(torch.abs(yc - position)))
            return xc, pmap[row, :]
        if position is None:
            col = int(torch.argmax(pmap)) % pmap.shape[1]
        else:
            col = int(torch.argmin(torch.abs(xc - position)))
        return yc, pmap[:, col]

    def view(self, figsize=(7, 5.5)):
        import matplotlib.pyplot as plt

        nf, nw = len(self.fields), len(self.wavelengths)
        fig, axs = plt.subplots(nf, nw, figsize=figsize, squeeze=False)
        for i in range(nf):
            for j in range(nw):
                pmap, xe, ye, _, _ = self.data[i][j]
                axs[i][j].imshow(
                    pmap.detach().cpu().numpy(), origin="lower",
                    extent=(float(xe[0]), float(xe[-1]),
                            float(ye[0]), float(ye[-1])),
                    aspect="auto")
                axs[i][j].set_xlabel("Angle X (deg)")
                axs[i][j].set_ylabel("Angle Y (deg)")
        fig.tight_layout()
        return fig, axs
