"""Huygens MTF: |DFT| of the Huygens-Fresnel PSF (port of
`optiland_tpu/mtf/huygens.py`; K8 runs under the PSF on the card)."""

from __future__ import annotations

import numpy as np

from optiland_tpu_torch.mtf.fft import mtf_slices
from optiland_tpu_torch.psf.huygens import HuygensPSF
from optiland_tpu_torch.system import paraxial as px


class HuygensMTF:
    def __init__(self, optic, field=(0, 0), wavelength="primary",
                 num_rays: int = 64, image_size: int = 64, max_freq="cutoff",
                 **kwargs):
        self.psf_obj = HuygensPSF(optic, field, wavelength,
                                  num_rays=num_rays, image_size=image_size,
                                  **kwargs)
        self.optic = optic
        self.mtf = mtf_slices(self.psf_obj.psf)
        # frequency axis from the PSF pixel pitch (cycles/mm)
        df = 1.0 / (image_size * float(self.psf_obj.pixel_pitch))
        self.freq = np.arange(image_size // 2) * df
        if max_freq == "cutoff":
            static, params = optic.build(device=kwargs.get("device"))
            w = self.psf_obj.wavelength
            self.max_freq = 1.0 / (w * 1e-3 * float(px.FNO(static, params, w)))
        else:
            self.max_freq = float(max_freq)
