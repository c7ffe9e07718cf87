"""Sampled MTF: pupil autocorrelation via a Zernike wavefront fit.

Port of `optiland_tpu/mtf/sampled.py`; the shifted-pupil overlap of every
requested (fx, fy) is one batched tensor computation.
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch import config
from optiland_tpu_torch import zernike as _z
from optiland_tpu_torch.core import distributions as dist
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.wavefront.core import wavefront_data


class SampledMTF:
    def __init__(self, optic, field=(0, 0), wavelength="primary",
                 num_rays: int = 32, distribution: str = "uniform",
                 zernike_terms: int = 37, zernike_type: str = "fringe",
                 device=None):
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.optic = optic
        self.field = field
        self.wavelength = float(wavelength)
        self.zernike_type = zernike_type
        self.zernike_terms = zernike_terms

        static, params = optic.build(device=device)
        dt, dev = params.cv.dtype, params.cv.device
        Px, Py = (a.to(dtype=dt, device=dev)
                  for a in dist.generate(distribution, num_rays)[:2])
        data = wavefront_data(static, params, field[0], field[1], Px, Py,
                              self.wavelength, aiming=optic.ray_aiming)
        self.x_norm = Px
        self.y_norm = Py
        self.intensity = data.intensity
        self.opd_waves = data.opd
        self.xpd = float(px.XPD(static, params, self.wavelength))
        self.xpl = float(px.XPL(static, params, self.wavelength))

        # Zernike fit of the wavefront (mask-weighted LSQ, static shapes;
        # the lit samples of the grid keep the columns independent)
        w = (self.intensity > 0).to(self.opd_waves.dtype)
        r = torch.sqrt(Px**2 + Py**2)
        phi = torch.atan2(Py, Px)
        A = _z.design_matrix(zernike_type, zernike_terms, r, phi) * w[:, None]
        self.zernike_coeffs = _z.lstsq(A, self.opd_waves * w)

        self.P1 = torch.polar(torch.sqrt(self.intensity),
                              2 * math.pi * self.opd_waves).to(
                                  config.complex_dtype())
        self.otf_at_zero = torch.sum(self.intensity)

    def calculate_mtf(self, frequencies):
        """MTF at (fx, fy) pairs in cycles/mm."""
        if self.xpd == 0.0:
            return [1.0 if fx == 0 and fy == 0 else 0.0
                    for fx, fy in frequencies]
        wl_mm = self.wavelength * 1e-3
        fxy = torch.as_tensor(frequencies, dtype=self.x_norm.dtype,
                              device=self.x_norm.device).reshape(-1, 2)
        delta_x = self.xpl * (wl_mm * fxy[:, :1]) / (self.xpd / 2.0)
        delta_y = self.xpl * (wl_mm * fxy[:, 1:]) / (self.xpd / 2.0)
        xs = self.x_norm - delta_x          # (F, N)
        ys = self.y_norm - delta_y
        r = torch.sqrt(xs**2 + ys**2)
        phi = torch.atan2(ys, xs)
        opd_shift = _z.evaluate(self.zernike_type, self.zernike_coeffs, r,
                                phi)
        P2c = torch.polar(torch.sqrt(self.intensity).expand_as(opd_shift),
                          -2 * math.pi * opd_shift).to(config.complex_dtype())
        P2c = torch.where(r > 1.0, torch.zeros_like(P2c), P2c)
        otf = torch.sum(self.P1 * P2c, dim=-1)
        return [float(v) for v in torch.abs(otf / self.otf_at_zero)]
