"""Transverse ray-aberration fans (port of
`optiland_tpu/analysis/fans.py`)."""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import (
    like,
    resolve_fields,
    resolve_wavelengths,
)
from optiland_tpu_torch.analysis.spot import field_pupil_batch
from optiland_tpu_torch.trace.tracer import trace_system


class RayFan:
    """Ex(Px) and Ey(Py) fans per field/wavelength, centered on the P=0 ray,
    on the device of the optic's build (the CUDA card unless
    `device="cpu"`).

    One batched trace covers fields x wavelengths x (x-fan + y-fan).
    """

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_points: int = 256, device=None):
        self.optic = optic
        self.fields = resolve_fields(optic, fields)
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        if num_points % 2 == 0:
            num_points += 1  # force a sample at P = 0 (reference behavior)
        self.num_points = num_points

        F, W, P = len(self.fields), len(self.wavelengths), num_points
        p = np.linspace(-1.0, 1.0, P)
        zeros = np.zeros(P)
        static, params = optic.build(device=device)
        self._device = params.cv.device
        # layout per (field, wavelength): [x-fan | y-fan]
        hist = trace_system(static, params, *field_pupil_batch(
            self.fields, self.wavelengths,
            like(np.concatenate([p, zeros]), params),
            like(np.concatenate([zeros, p]), params), params), True)
        x = hist.x[-1].reshape(F, W, 2, P)
        y = hist.y[-1].reshape(F, W, 2, P)
        i = hist.intensity[-1].reshape(F, W, 2, P)

        self.Px = self.Py = p
        off_x, off_y = self._reference_offsets(x, y, i, P)
        ex = x[:, :, 0, :] - off_x[:, None, None]
        ey = y[:, :, 1, :] - off_y[:, None, None]
        self.data = {
            "Px": p, "Py": p,
            "ex": ex, "ey": ey,
            "intensity_x": i[:, :, 0, :], "intensity_y": i[:, :, 1, :],
        }

    def _reference_offsets(self, x, y, i, P):
        """Per-field (off_x, off_y) the fans are centered on: the PRIMARY
        wavelength's P=0 ray (reference `_remove_distortion`); the masked
        fan mean where the central ray is vignetted. `BestFitRayFan`
        overrides this."""
        prim = self.optic.primary_wavelength
        ref_j = (self.wavelengths.index(prim)
                 if prim in self.wavelengths else 0)
        c = P // 2

        def _offset(v, inten):
            center_ok = inten[:, ref_j, c] > 0
            mask = (inten[:, ref_j, :] > 0).to(v.dtype)
            mean = torch.sum(v[:, ref_j, :] * mask, dim=-1) / torch.clamp(
                torch.sum(mask, dim=-1), min=1.0)
            return torch.where(center_ok, v[:, ref_j, c], mean)

        return _offset(x[:, :, 0], i[:, :, 0]), _offset(y[:, :, 1],
                                                        i[:, :, 1])

    def view(self, figsize=(10, 3.33)):
        import matplotlib.pyplot as plt

        F = len(self.fields)
        fig, axs = plt.subplots(F, 2, figsize=(figsize[0], figsize[1] * F),
                                sharex=True, sharey=True, squeeze=False)
        d = {k: self.data[k].detach().cpu().numpy()
             for k in ("ex", "ey", "intensity_x", "intensity_y")}
        for k, field in enumerate(self.fields):
            for j, w in enumerate(self.wavelengths):
                ey = np.where(d["intensity_y"][k, j] > 0, d["ey"][k, j],
                              np.nan)
                ex = np.where(d["intensity_x"][k, j] > 0, d["ex"][k, j],
                              np.nan)
                axs[k, 0].plot(self.Py, ey, label=f"{w:.4f} um")
                axs[k, 1].plot(self.Px, ex)
            axs[k, 0].set_title(f"Hy={field[1]:.2f} tangential")
            axs[k, 1].set_title(f"Hx={field[0]:.2f} sagittal")
            axs[k, 0].grid(True)
            axs[k, 1].grid(True)
        axs[0, 0].legend()
        fig.tight_layout()
        return fig, axs


class BestFitRayFan(RayFan):
    """Ray fan referenced to the best-fit sphere center instead of the
    chief ray (reference `analysis/ray_fan.py:247-340`): for each field, a
    hexapolar pupil at the primary wavelength is fit with the LSQ reference
    sphere (`wavefront_data(strategy="best_fit")`) and the fan origin is
    the sphere center's lateral (x, y)."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_points: int = 256, num_rays_for_fit: int = 15,
                 device=None):
        self.num_rays_for_fit = num_rays_for_fit
        super().__init__(optic, fields, wavelengths, num_points,
                         device=device)

    def _reference_offsets(self, x, y, i, P):
        from optiland_tpu_torch.core.distributions import generate
        from optiland_tpu_torch.wavefront.core import wavefront_data

        static, params = self.optic.build(device=self._device)
        Px, Py = (like(a, params)
                  for a in generate("hexapolar", self.num_rays_for_fit))
        wl = self.optic.primary_wavelength
        off_x, off_y = [], []
        for (Hx, Hy) in self.fields:
            data = wavefront_data(static, params, Hx, Hy, Px, Py, wl,
                                  strategy="best_fit",
                                  aiming=self.optic.ray_aiming)
            off_x.append(data.center[0])
            off_y.append(data.center[1])
        return torch.stack(off_x), torch.stack(off_y)
