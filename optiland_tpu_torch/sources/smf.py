"""Single-mode-fiber Gaussian source with Sobol sampling (port of
`optiland_tpu/sources/smf.py`; reference `sources/smf.py:33-195`)."""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.core.rays import make_rays
from optiland_tpu_torch.sources.base import BaseSource


def _sobol(num_samples: int, dim: int, device):
    """Scrambled Sobol points from scipy (host-side, seed 0, as the JAX
    package draws them), on `device`."""
    from scipy.stats import qmc

    return torch.as_tensor(qmc.Sobol(d=dim, scramble=True, seed=0)
                           .random(num_samples), dtype=config.get_dtype(),
                           device=device)


class SMFSource(BaseSource):
    def __init__(self, mfd_um: float, wavelength_um: float,
                 divergence_deg_1e2: float | None = None,
                 total_power: float = 1.0,
                 position=(0.0, 0.0, 0.0), is_point_source: bool = False):
        super().__init__(position)
        self.mfd_um = mfd_um
        self.wavelength = wavelength_um
        self.total_power = total_power
        self.is_point_source = is_point_source

        if divergence_deg_1e2 is None:
            w0 = mfd_um / 2.0
            theta_half = wavelength_um / (math.pi * w0)
            self.divergence_deg_1e2 = 2.0 * math.degrees(theta_half)
        else:
            self.divergence_deg_1e2 = divergence_deg_1e2

        self.sigma_spatial_mm = (mfd_um / 2.0 * 1e-3) / 2.0
        self.sigma_angular_rad = math.radians(
            self.divergence_deg_1e2 / 2.0) / 2.0

    def generate_rays(self, num_rays: int, device=None):
        """The next power of two at or above `num_rays` Sobol rays on
        `device` (None: the CUDA card), in the precision's dtype."""
        if num_rays <= 0:
            raise ValueError("num_rays must be a positive integer.")
        dev = config.resolve_device(device)
        n = 1 << (num_rays - 1).bit_length()  # Sobol wants powers of two
        u = _sobol(n, 4, dev)
        sqrt2 = math.sqrt(2.0)
        if self.is_point_source:
            x = torch.zeros(n, dtype=u.dtype, device=dev)
            y = torch.zeros(n, dtype=u.dtype, device=dev)
        else:
            x = self.sigma_spatial_mm * sqrt2 * torch.erfinv(2 * u[:, 0] - 1)
            y = self.sigma_spatial_mm * sqrt2 * torch.erfinv(2 * u[:, 1] - 1)
        tx = torch.tan(self.sigma_angular_rad * sqrt2
                       * torch.erfinv(2 * u[:, 2] - 1))
        ty = torch.tan(self.sigma_angular_rad * sqrt2
                       * torch.erfinv(2 * u[:, 3] - 1))
        N = 1.0 / torch.sqrt(1.0 + tx**2 + ty**2)
        rays = make_rays(x, y, torch.zeros(n, dtype=u.dtype, device=dev),
                         tx * N, ty * N, N,
                         intensity=torch.full((n,), self.total_power / n,
                                              dtype=u.dtype, device=dev),
                         wavelength=self.wavelength)
        return self._globalize(rays)
