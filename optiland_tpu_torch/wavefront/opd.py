"""OPD analyses: per-field wavefront maps, RMS, Zernike decomposition and
pupil-slice fans.

Port of `optiland_tpu/wavefront/opd.py` (plotting left out). Each class is a
thin host shell over `wavefront_data` on the device of the optic's build:
the CUDA card unless `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch import zernike as _zernike
from optiland_tpu_torch.core import distributions as dist
from optiland_tpu_torch.wavefront.core import wavefront_data


class OPD:
    """Optical path difference map for one (field, wavelength)."""

    def __init__(self, optic, field, wavelength=None, num_rings: int = 15,
                 distribution: str = "hexapolar", strategy: str = "chief_ray",
                 device=None):
        self.optic = optic
        self.field = field
        self.wavelength = (
            optic.primary_wavelength if wavelength in (None, "primary")
            else wavelength
        )
        static, params = optic.build(device=device)
        dt, dev = params.cv.dtype, params.cv.device
        out = dist.generate(distribution, num_rings)
        self.Px, self.Py = (a.to(dtype=dt, device=dev) for a in out[:2])
        self.strategy = strategy
        self.data = wavefront_data(
            static, params, field[0], field[1], self.Px, self.Py,
            self.wavelength, strategy=strategy, aiming=optic.ray_aiming)

    def rms(self):
        """Intensity-masked RMS OPD in waves."""
        m = self.data.intensity > 0
        n = torch.sum(m)
        return torch.sqrt(torch.sum(torch.where(
            m, self.data.opd**2, torch.zeros_like(self.data.opd))) / n)

    def peak_to_valley(self):
        m = self.data.intensity > 0
        opd = self.data.opd
        return torch.max(opd[m]) - torch.min(opd[m])

    def generate_opd_map(self, num_points: int = 256):
        """Interpolate the OPD samples onto a regular grid for plotting
        (scipy `griddata`, cubic, on the host)."""
        from scipy.interpolate import griddata

        m = self.data.intensity.cpu().numpy() > 0
        x = self.Px.cpu().numpy()[m]
        y = self.Py.cpu().numpy()[m]
        z = self.data.opd.detach().cpu().numpy()[m]
        xi, yi = np.meshgrid(np.linspace(-1, 1, num_points),
                             np.linspace(-1, 1, num_points))
        zi = griddata((x, y), z, (xi, yi), method="cubic")
        return {"x": xi, "y": yi, "z": zi}


class OPDFan:
    """Wavefront-error pupil-slice fans: OPD along the Py and Px axes for
    every (field, wavelength) pair."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_rays: int = 100, strategy: str = "chief_ray",
                 device=None):
        self.optic = optic
        self.fields = (optic.fields.get_field_coords() if fields == "all"
                       else fields)
        self.wavelengths = (optic.wavelengths.values_um
                            if wavelengths == "all" else wavelengths)
        static, params = optic.build(device=device)
        dt, dev = params.cv.dtype, params.cv.device
        self.pupil_coord = torch.linspace(-1.0, 1.0, num_rays, dtype=dt,
                                          device=dev)
        # x-axis slice first, then y-axis slice (no origin merge, so the two
        # fans index cleanly at [:num_rays] / [num_rays:])
        zeros = torch.zeros_like(self.pupil_coord)
        Px = torch.cat([self.pupil_coord, zeros])
        Py = torch.cat([zeros, self.pupil_coord])
        self.data = [
            [wavefront_data(static, params, fx, fy, Px, Py, w,
                            strategy=strategy, aiming=optic.ray_aiming)
             for w in self.wavelengths]
            for fx, fy in self.fields
        ]
        self.num_rays = num_rays

    def fan_y(self, field_idx: int, wl_idx: int):
        """(Py, OPD) along the y pupil axis."""
        d = self.data[field_idx][wl_idx]
        return self.pupil_coord, d.opd[self.num_rays:]

    def fan_x(self, field_idx: int, wl_idx: int):
        """(Px, OPD) along the x pupil axis."""
        d = self.data[field_idx][wl_idx]
        return self.pupil_coord, d.opd[: self.num_rays]


class ZernikeOPD(OPD):
    """OPD map + Zernike LSQ decomposition."""

    def __init__(self, optic, field, wavelength=None, num_rings: int = 15,
                 zernike_type: str = "fringe", num_terms: int = 37,
                 strategy: str = "chief_ray", device=None):
        super().__init__(optic, field, wavelength, num_rings=num_rings,
                         strategy=strategy, device=device)
        self.zernike_type = zernike_type
        self.num_terms = num_terms
        # static-shape LSQ: weight rows by the mask instead of gathering;
        # the lit samples of a hexapolar grid keep the columns independent
        w = (self.data.intensity > 0).to(self.data.opd.dtype)
        r = torch.sqrt(self.Px**2 + self.Py**2)
        phi = torch.atan2(self.Py, self.Px)
        A = _zernike.design_matrix(zernike_type, num_terms, r, phi) * w[:, None]
        self.coeffs = _zernike.lstsq(A, self.data.opd * w)

    def zernike_terms(self):
        return list(zip(_zernike.indices(self.zernike_type, self.num_terms),
                        self.coeffs.detach().cpu().numpy()))
