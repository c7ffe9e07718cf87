"""Geometric MTF from spot-diagram line-spread functions.

Port of `optiland_tpu/mtf/geometric.py` (Smith, Modern Optical Engineering
section 11.9): a histogram and a cosine/sine transform, vectorized over
the frequency axis and over any leading axes of the coordinates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import linspace
from optiland_tpu_torch.analysis.spot import SpotDiagram
from optiland_tpu_torch.system import paraxial as px


def _lsf_mtf(xi, mask, freqs, num_points):
    """MTF of the 1-D intensity histogram of the coordinates xi (masked) at
    `freqs`; xi and mask are (..., P), the result (..., len(freqs)).

    A coordinate's bin is its offset over the span truncated toward zero,
    then clipped, as JAX's `.astype(jnp.int32)` and `jnp.clip` take it; the
    histogram is a scatter-add of the mask."""
    inf = torch.tensor(math.inf, dtype=xi.dtype, device=xi.device)
    lo = torch.amin(torch.where(mask > 0, xi, inf), dim=-1, keepdim=True)
    hi = torch.amax(torch.where(mask > 0, xi, -inf), dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    edges = lo + span * torch.arange(num_points + 2, dtype=xi.dtype,
                                     device=xi.device) / (num_points + 1)
    x = (edges[..., 1:] + edges[..., :-1]) / 2.0
    idx = torch.clamp(((xi - lo) / span * (num_points + 1)).to(torch.int32),
                      0, num_points).to(torch.int64)
    A = torch.zeros(xi.shape[:-1] + (num_points + 1,), dtype=xi.dtype,
                    device=xi.device).scatter_add(-1, idx, mask)
    dx = x[..., 1:2] - x[..., 0:1]
    total = torch.sum(A * dx, dim=-1, keepdim=True)
    arg = 2.0 * math.pi * freqs[:, None] * x[..., None, :]
    Ac = torch.sum(A[..., None, :] * torch.cos(arg) * dx[..., None],
                   dim=-1) / total
    As = torch.sum(A[..., None, :] * torch.sin(arg) * dx[..., None],
                   dim=-1) / total
    return torch.sqrt(Ac**2 + As**2)


class GeometricMTF(SpotDiagram):
    """Spot-based geometric MTF per field, on the device of the optic's
    build (the CUDA card unless `device="cpu"`)."""

    def __init__(self, optic, fields="all", wavelength="primary",
                 num_rays: int = 100, distribution: str = "uniform",
                 num_points: int = 256, max_freq="cutoff", scale: bool = True,
                 device=None):
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        super().__init__(optic, fields=fields, wavelengths=[float(wavelength)],
                         num_rings=num_rays, distribution=distribution,
                         device=device)
        self.num_points = num_points
        self.scale = scale

        static, params = optic.build(device=device)
        fno = float(px.FNO(static, params, wavelength))
        if max_freq == "cutoff":
            self.max_freq = 1.0 / (wavelength * 1e-3 * fno)
        else:
            self.max_freq = float(max_freq)

        self.freq = linspace(0.0, self.max_freq, num_points, self.x)
        # diffraction-limited scaling curve (Smith 11.9)
        v = self.freq / self.max_freq
        self.diff_limited_mtf = (2.0 / math.pi) * (
            torch.arccos(v) - v * torch.sqrt(1.0 - v**2)
        )

        # both axes of every field in one batch: (F, 2, num_points)
        lsf = _lsf_mtf(torch.stack([self.y[:, 0], self.x[:, 0]], dim=1),
                       self._mask[:, 0, None].expand(-1, 2, -1).contiguous(),
                       self.freq, num_points)
        if scale:
            lsf = lsf * self.diff_limited_mtf
        self.mtf = [[lsf[k, 0], lsf[k, 1]] for k in range(len(self.fields))]

    def view(self, figsize=(10, 7), add_reference: bool = False):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        f = self.freq.detach().cpu().numpy()
        for i, field in enumerate(self.fields):
            t, s = (np.asarray(a.detach().cpu()) for a in self.mtf[i])
            ax.plot(f, t, label=f"Hy={field[1]:.2f} T")
            ax.plot(f, s, "--", label=f"Hy={field[1]:.2f} S")
        if add_reference:
            ax.plot(f, self.diff_limited_mtf.detach().cpu().numpy(), "k:",
                    label="diffraction limit")
        ax.set_xlabel("Spatial frequency (cycles/mm)")
        ax.set_ylabel("MTF")
        ax.set_ylim(0, 1)
        ax.legend()
        ax.grid(True)
        return fig, ax
