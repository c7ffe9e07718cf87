"""Incoherent detector irradiance (port of
`optiland_tpu/analysis/irradiance.py`).

Intensity-weighted 2-D binning of image-plane ray hits as an accumulating
`index_put` on the device, so an irradiance map stays there and is
differentiable in the rays' power.
"""

from __future__ import annotations

import torch

from optiland_tpu_torch.analysis.base import (
    like,
    linspace,
    resolve_fields,
    resolve_wavelengths,
)
from optiland_tpu_torch.analysis.spot import field_pupil_batch
from optiland_tpu_torch.core import distributions as dist


def bin_index(edges, v, n):
    """The bin of each value of `v` among n bins with these edges, by
    np.histogram's rule: right-open bins, the last edge in the last bin."""
    i = torch.searchsorted(edges, v.contiguous(), right=True) - 1
    return torch.clamp(i, 0, n - 1)


def bin_irradiance(x, y, power, extent, res):
    """Scatter-add rays into a (res_x, res_y) grid over extent
    ((xmin, xmax), (ymin, ymax)); X is the row index as in the reference."""
    (xmin, xmax), (ymin, ymax) = extent
    nx, ny = res
    ix = bin_index(linspace(xmin, xmax, nx + 1, x), x, nx)
    iy = bin_index(linspace(ymin, ymax, ny + 1, y), y, ny)
    inside = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    w = torch.where(inside, power, 0.0)
    grid = torch.zeros((nx, ny), dtype=power.dtype,
                       device=power.device).index_put((ix, iy), w,
                                                      accumulate=True)
    # normalize to irradiance (power per unit area)
    px_area = (xmax - xmin) / nx * (ymax - ymin) / ny
    return grid / px_area


class IncoherentIrradiance:
    """Irradiance maps per (field, wavelength) on the detector surface, on
    the device of the optic's build (the CUDA card unless `device="cpu"`).
    The default random pupil comes from an unseeded generator, as in JAX."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_rays: int = 50_000, res=(64, 64), px_size=None,
                 detector_surface: int = -1, distribution: str = "random",
                 device=None):
        self.optic = optic
        self.fields = resolve_fields(optic, fields)
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        self.res = res
        self.detector_surface = detector_surface

        _, params = optic.build(device=device)
        out = dist.generate(distribution, num_rays)
        Px, Py = like(out[0], params), like(out[1], params)
        P = Px.shape[0]
        F, W = len(self.fields), len(self.wavelengths)
        Hx, Hy, Pxs, Pys, wl = field_pupil_batch(self.fields,
                                                 self.wavelengths, Px, Py,
                                                 params)
        hist = optic.trace_generic(Hx, Hy, Pxs, Pys, wavelength=wl,
                                   device=device)
        x = hist.x[detector_surface].reshape(F, W, P)
        y = hist.y[detector_surface].reshape(F, W, P)
        i = hist.intensity[detector_surface].reshape(F, W, P)

        # detector extent: physical aperture if defined, else data bounds
        spec = optic.surfaces.specs[detector_surface]
        if px_size is not None:
            hx = px_size[0] * res[0] / 2
            hy = px_size[1] * res[1] / 2
            extent = ((-hx, hx), (-hy, hy))
        elif spec.semi_aperture is not None:
            r = spec.semi_aperture
            extent = ((-r, r), (-r, r))
        else:
            pad = 1.05
            xm = float(torch.amax(torch.abs(torch.where(i > 0, x, 0.0)))) * pad
            ym = float(torch.amax(torch.abs(torch.where(i > 0, y, 0.0)))) * pad
            extent = ((-xm, xm), (-ym, ym))
        self.extent = extent

        self.data = [
            [bin_irradiance(x[f, w], y[f, w], i[f, w], extent, res)
             for w in range(W)]
            for f in range(F)
        ]

    def peak_irradiance(self):
        return [[float(torch.amax(g)) for g in row] for row in self.data]

    def view(self, figsize=(6, 5), cmap="inferno"):
        import matplotlib.pyplot as plt

        F, W = len(self.fields), len(self.wavelengths)
        fig, axs = plt.subplots(F, W, figsize=figsize, squeeze=False)
        (xmin, xmax), (ymin, ymax) = self.extent
        for f in range(F):
            for w in range(W):
                im = axs[f, w].imshow(self.data[f][w].detach().cpu().numpy().T,
                                      origin="lower", cmap=cmap,
                                      extent=(xmin, xmax, ymin, ymax))
                fig.colorbar(im, ax=axs[f, w])
        fig.tight_layout()
        return fig, axs
