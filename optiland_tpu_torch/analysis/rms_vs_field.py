"""RMS spot size and RMS wavefront error vs field (port of
`optiland_tpu/analysis/rms_vs_field.py`)."""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import like, resolve_wavelengths
from optiland_tpu_torch.analysis.spot import SpotDiagram
from optiland_tpu_torch.core import distributions as dist
from optiland_tpu_torch.wavefront.core import wavefront_data


def _view_vs_field(analysis, data, ylabel, figsize):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    hy = (np.linspace(0, 1, analysis.num_fields)
          * analysis.optic.fields.max_field)
    data = data.detach().cpu().numpy()
    for j, w in enumerate(analysis.wavelengths):
        ax.plot(hy, data[:, j], label=f"{w:.4f} um")
    ax.set_xlabel("Field")
    ax.set_ylabel(ylabel)
    ax.legend()
    ax.grid(True)
    return fig, ax


class RmsSpotSizeVsField(SpotDiagram):
    """RMS spot size swept over field height (y scan, Hx = 0)."""

    def __init__(self, optic, num_fields: int = 32, wavelengths="all",
                 num_rings: int = 6, distribution: str = "hexapolar",
                 device=None):
        self.num_fields = num_fields
        fields = [(0.0, float(hy)) for hy in np.linspace(0, 1, num_fields)]
        super().__init__(optic, fields=fields, wavelengths=wavelengths,
                         num_rings=num_rings, distribution=distribution,
                         device=device)
        self._spot_size = self.rms_spot_radius()  # (F, W)

    def view(self, figsize=(7, 4.5)):
        return _view_vs_field(self, self._spot_size, "RMS spot size (mm)",
                              figsize)


class RmsWavefrontErrorVsField:
    """RMS wavefront error (waves) swept over field height, one
    `wavefront_data` per field and wavelength."""

    def __init__(self, optic, num_fields: int = 32, wavelengths="all",
                 num_rings: int = 15, strategy: str = "chief_ray",
                 device=None):
        self.optic = optic
        self.num_fields = num_fields
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        static, params = optic.build(device=device)
        Px, Py = (like(a, params) for a in dist.hexapolar(num_rings))

        rows = []
        for hy in np.linspace(0, 1, num_fields):
            cols = []
            for w in self.wavelengths:
                d = wavefront_data(static, params, 0.0, float(hy), Px, Py, w,
                                   strategy=strategy,
                                   aiming=optic.ray_aiming)
                m = (d.intensity > 0).to(d.opd.dtype)
                cols.append(torch.sqrt(torch.sum(d.opd**2 * m)
                                       / torch.clamp(torch.sum(m), min=1.0)))
            rows.append(torch.stack(cols))
        self._wavefront_error = torch.stack(rows)  # (F, W)

    def view(self, figsize=(7, 4.5)):
        return _view_vs_field(self, self._wavefront_error,
                              "RMS wavefront error (waves)", figsize)
