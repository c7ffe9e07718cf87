"""Matrix-method DFT (zoomed) PSF.

Port of `optiland_tpu/psf/mmdft.py`: the image field is L @ pupil @ R with
DFT kernel matrices, giving an arbitrarily sampled (zoomed) PSF without
zero-padding: two complex matrix products (`torch.matmul`, as the JAX
package leaves them to XLA).
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.psf.fft import _pupil_grid, calculate_grid_size
from optiland_tpu_torch.system import paraxial as px


class MMDFTPSF:
    def __init__(self, optic, field, wavelength="primary", num_rays: int = 128,
                 image_size: int | None = None, pixel_pitch: float | None = None,
                 strategy: str = "chief_ray", device=None):
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.optic = optic
        self.field = field
        self.wavelength = float(wavelength)
        num_rays_eff, grid_size = calculate_grid_size(num_rays)
        self.num_rays = num_rays_eff

        static, params = optic.build(device=device)
        dt, dev = params.cv.dtype, params.cv.device
        fno = float(px.FNO(static, params, self.wavelength))
        clear_size = self.num_rays - 1
        # sampling defaults of the reference
        if image_size is None and pixel_pitch is None:
            image_size = grid_size
        if pixel_pitch is None:
            pixel_pitch = self.wavelength * fno * clear_size / image_size
        elif image_size is None:
            image_size = int(self.wavelength * fno * clear_size / pixel_pitch)
        self.image_size = image_size
        self.pixel_pitch = pixel_pitch

        pad_size = self.wavelength * fno * clear_size / pixel_pitch
        if image_size > pad_size:
            raise ValueError(
                f"Supplied image_size of {image_size} not less than or equal "
                f"to calculated pad size of {int(pad_size)}. Consider "
                "increasing num_rays."
            )

        pupil = _pupil_grid(static, params, field[0], field[1],
                            self.wavelength, self.num_rays, strategy,
                            optic.ray_aiming)
        cdt = config.complex_dtype()
        pc = torch.arange(self.num_rays, dtype=dt, device=dev) - self.num_rays // 2
        ic = torch.arange(image_size, dtype=dt, device=dev) - image_size // 2
        one = torch.ones((), dtype=dt, device=dev)
        right = torch.polar(one, -2.0 * (math.pi * torch.outer(pc, ic)
                                         / pad_size)).to(cdt)
        left = torch.polar(one, -2.0 * (math.pi * torch.outer(ic, pc)
                                        / pad_size)).to(cdt)
        G = left @ (pupil @ right)
        psf = torch.real(G * torch.conj(G))
        # DL normalization: uniform unit pupil through the same kernels
        ideal = (torch.abs(pupil) > 0).to(cdt)
        G0 = left @ (ideal @ right)
        peak = torch.max(torch.real(G0 * torch.conj(G0)))
        self.psf = psf / peak * 100.0

    def strehl_ratio(self):
        c = self.image_size // 2
        return self.psf[c, c] / 100.0
