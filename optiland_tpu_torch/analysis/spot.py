"""Spot diagram analysis.

Port of `optiland_tpu/analysis/spot.py`: ONE batched trace covers the full
fields x wavelengths x pupil grid at per-ray wavelengths (on the card, a
`supports_fused` system is one K7 launch), with no aim and no polarization,
as JAX's `_jit_trace(static)` traces it. Zero-intensity (vignetted) rays
are handled by mask-weighted reductions rather than boolean gathers, so the
centroid and RMS are the reference's masked means.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import (
    like,
    resolve_fields,
    resolve_wavelengths,
)
from optiland_tpu_torch.core import distributions as dist
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.trace.tracer import trace_system


def _masked_mean(v, m, dim=-1):
    return torch.sum(v * m, dim=dim) / torch.clamp(torch.sum(m, dim=dim),
                                                   min=1.0)


def field_pupil_batch(fields, wavelengths, Px, Py, params):
    """(Hx, Hy, Px, Py, w) of every field x wavelength x pupil point, field
    major, on the device and in the dtype of `params` (JAX's `np.repeat` /
    `np.tile` layout)."""
    F, W, P = len(fields), len(wavelengths), Px.shape[0]
    Hx = like([f[0] for f in fields], params).repeat_interleave(W * P)
    Hy = like([f[1] for f in fields], params).repeat_interleave(W * P)
    wl = like(wavelengths, params).repeat_interleave(P).repeat(F)
    return Hx, Hy, Px.repeat(F * W), Py.repeat(F * W), wl


class SpotDiagram:
    """Image-plane intersections per field and wavelength, on the device of
    the optic's build (the CUDA card unless `device="cpu"`).

    x, y and intensity are (F, W, P) tensors (clipped rays carry intensity
    0)."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_rings: int = 6, distribution: str = "hexapolar",
                 reference: str = "chief_ray", device=None):
        self.optic = optic
        self.fields = resolve_fields(optic, fields)
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        self.reference = reference

        prim = optic.primary_wavelength
        self._ref_wl_idx = (
            self.wavelengths.index(prim) if prim in self.wavelengths else 0
        )

        static, params = optic.build(device=device)
        self._device = params.cv.device
        out = dist.generate(distribution, num_rings)
        Px, Py = like(out[0], params), like(out[1], params)
        self.num_points = Px.shape[0]

        F, W, P = len(self.fields), len(self.wavelengths), self.num_points
        hist = trace_system(static, params, *field_pupil_batch(
            self.fields, self.wavelengths, Px, Py, params), True)
        self.x = hist.x[-1].reshape(F, W, P)
        self.y = hist.y[-1].reshape(F, W, P)
        self.intensity = hist.intensity[-1].reshape(F, W, P)
        self._mask = (self.intensity > 0).to(self.x.dtype)

        # reference centers per field
        if reference == "chief_ray":
            zero = like(np.zeros(F), params)
            ch = trace_system(
                static, params, like([f[0] for f in self.fields], params),
                like([f[1] for f in self.fields], params), zero, zero,
                like(np.full(F, self.wavelengths[self._ref_wl_idx]), params),
                True)
            self._cx = ch.x[-1]
            self._cy = ch.y[-1]
        elif reference == "centroid":
            m = self._mask[:, self._ref_wl_idx]
            self._cx = _masked_mean(self.x[:, self._ref_wl_idx], m, dim=-1)
            self._cy = _masked_mean(self.y[:, self._ref_wl_idx], m, dim=-1)
        else:
            raise ValueError(f"Unknown spot reference {reference!r}")

    # -- metrics (reference `core.py:329-370`) ------------------------------
    def centroid(self):
        """Unweighted masked mean of the reference-wavelength spot per field."""
        m = self._mask[:, self._ref_wl_idx]
        cx = _masked_mean(self.x[:, self._ref_wl_idx], m, dim=-1)
        cy = _masked_mean(self.y[:, self._ref_wl_idx], m, dim=-1)
        return [(cx[i], cy[i]) for i in range(len(self.fields))]

    def _centered(self):
        dx = self.x - self._cx[:, None, None]
        dy = self.y - self._cy[:, None, None]
        return dx, dy

    def rms_spot_radius(self):
        """(F, W) RMS spot radii about the reference point."""
        dx, dy = self._centered()
        return torch.sqrt(_masked_mean(dx**2 + dy**2, self._mask, dim=-1))

    def geometric_spot_radius(self):
        """(F, W) max spot radii about the reference point."""
        dx, dy = self._centered()
        r = torch.sqrt(dx**2 + dy**2)
        return torch.amax(torch.where(self._mask > 0, r, 0.0), dim=-1)

    def airy_radius(self, wavelength=None):
        """Airy disc radius 1.22 lambda FNO (mm) at the working F-number."""
        w = wavelength or self.wavelengths[self._ref_wl_idx]
        static, params = self.optic.build(device=self._device)
        fno = px.FNO(static, params, w)
        return 1.22 * fno * w * 1e-3

    def view(self, figsize=(12, 4), add_airy_disk: bool = False):
        import matplotlib.pyplot as plt

        F = len(self.fields)
        fig, axs = plt.subplots(1, F, figsize=figsize, squeeze=False)
        dx, dy = (a.detach().cpu().numpy() for a in self._centered())
        m = self._mask.detach().cpu().numpy() > 0
        for i, field in enumerate(self.fields):
            ax = axs[0, i]
            for j, w in enumerate(self.wavelengths):
                sel = m[i, j]
                ax.scatter(dx[i, j][sel], dy[i, j][sel], s=2,
                           label=f"{w:.4f} um")
            ax.set_title(f"Hx={field[0]:.2f}, Hy={field[1]:.2f}")
            ax.set_aspect("equal")
            if add_airy_disk:
                t = np.linspace(0, 2 * np.pi, 100)
                r = float(self.airy_radius())
                ax.plot(r * np.cos(t), r * np.sin(t), "k--", lw=0.8)
        axs[0, -1].legend()
        fig.tight_layout()
        return fig, axs
