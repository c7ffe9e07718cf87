"""FFT MTF: |FFT(PSF)| slices normalized to the DC bin, frequency axes
from the per-field working F-number, with the tangential axis corrected
back to the flat image plane by the chief-ray tilt factor FNO_on/FNO_off.

Port of `optiland_tpu/mtf/fft.py`: `ScalarFFTMTF` on the scalar FFT PSF,
`VectorialFFTMTF` on the vectorial one; `FFTMTF` picks the vectorial MTF
for a polarized optic.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.core.resolve import resolve_fields
from optiland_tpu_torch.psf.fft import (
    ScalarFFTPSF,
    VectorialFFTPSF,
    calculate_grid_size,
)
from optiland_tpu_torch.system import paraxial as px

_MAX_FNUM = 1e4


def get_working_FNO(optic, field, wavelength, device=None) -> float:
    """Per-field working F-number: trace the chief ray plus the four
    pupil-edge marginal rays, average the squared NAs of the unvignetted
    marginals relative to the chief direction."""
    Hx, Hy = field
    static, params = optic.build(device=device)
    n_img = float(px.index_table(static, params, wavelength)[-1])

    Px = [0.0, 0.0, 0.0, 1.0, -1.0]
    Py = [0.0, 1.0, -1.0, 0.0, 0.0]
    h = optic.trace_generic(Hx=Hx, Hy=Hy, Px=Px, Py=Py,
                            wavelength=wavelength, device=device)
    L, M, N, i = (a[-1].double().cpu().numpy()
                  for a in (h.L, h.M, h.N, h.intensity))
    dot = np.clip(L[0] * L[1:] + M[0] * M[1:] + N[0] * N[1:], -1.0, 1.0)
    na_sq = (n_img * np.sin(np.arccos(dot))) ** 2
    live = i[1:] > 0
    avg = float(np.mean(na_sq[live])) if live.any() else float(np.mean(na_sq))
    if avg <= 0:
        return _MAX_FNUM
    fno = 1.0 / (2.0 * np.sqrt(avg))
    if not np.isfinite(fno):
        raise ValueError(
            "Working F/# could not be calculated due to raytrace errors.")
    return min(fno, _MAX_FNUM)


def mtf_slices(psf):
    """Tangential and sagittal MTF of a square PSF: |fft2| slices through
    the centre, normalized to the DC bin and clipped to [0, 1]."""
    center = psf.shape[0] // 2
    otf = torch.abs(torch.fft.fftshift(torch.fft.fft2(psf)))
    dc = otf[center, center]
    return [torch.clip(otf[center:, center][:center] / dc, 0.0, 1.0),
            torch.clip(otf[center, center:][:center] / dc, 0.0, 1.0)]


class ScalarFFTMTF:
    """Tangential/sagittal MTF per field at one wavelength (scalar PSF), on
    the device of the optic's build (the CUDA card unless `device="cpu"`)."""

    _psf_cls = ScalarFFTPSF

    def __init__(self, optic, fields="all", wavelength="primary",
                 num_rays: int = 128, grid_size: int | None = None,
                 max_freq="cutoff", strategy: str = "chief_ray", device=None):
        self.optic = optic
        self.fields = resolve_fields(optic, fields)
        self.wavelength = (
            optic.primary_wavelength if wavelength == "primary"
            else float(wavelength)
        )
        if grid_size is None:
            num_rays, grid_size = calculate_grid_size(num_rays)
        self.num_rays = num_rays
        self.grid_size = grid_size
        self.strategy = strategy

        # the on-axis WORKING F/# (the reference evaluates get_working_FNO
        # at (0, 0), not the paraxial F/#), and the per-field one
        self._fno_on_axis = get_working_FNO(optic, (0.0, 0.0),
                                            self.wavelength, device)
        self.FNO = [get_working_FNO(optic, f, self.wavelength, device)
                    for f in self.fields]
        if max_freq == "cutoff":
            self.max_freq = 1.0 / (self.wavelength * 1e-3 * self._fno_on_axis)
        else:
            self.max_freq = float(max_freq)

        center = grid_size // 2
        self.mtf = []
        self.freq_tang = []
        self.freq_sag = []
        for k, field in enumerate(self.fields):
            psf = self._psf_cls(optic, field, wavelength=[self.wavelength],
                                num_rays=num_rays, grid_size=grid_size,
                                strategy=strategy, device=device).psf
            self.mtf.append(mtf_slices(psf))
            ks = np.arange(center)
            self.freq_tang.append(ks * self._mtf_units_tang(k))
            self.freq_sag.append(ks * self._mtf_units_sag(k))
        self.freq = self.freq_tang

    def _mtf_units_tang(self, k: int) -> float:
        """Tangential frequency step with the chief-ray image-plane
        correction df_chief * FNO_on/FNO_off."""
        df_chief = 1.0 / ((self.num_rays - 1) * self.wavelength * 1e-3
                          * self.FNO[k])
        return df_chief * (self._fno_on_axis / self.FNO[k])

    def _mtf_units_sag(self, k: int) -> float:
        """Sagittal frequency step: the per-field working F/# directly."""
        return 1.0 / ((self.num_rays - 1) * self.wavelength * 1e-3
                      * self.FNO[k])


class VectorialFFTMTF(ScalarFFTMTF):
    """The FFT MTF of the vectorial PSF (the exit pupil's three E-field
    components)."""

    _psf_cls = VectorialFFTPSF


class FFTMTF:
    """Factory: the vectorial FFT MTF for an optic with a polarization
    state, else the scalar one."""

    def __new__(cls, optic, *args, **kwargs):
        if getattr(optic, "polarization", "ignore") != "ignore":
            return VectorialFFTMTF(optic, *args, **kwargs)
        return ScalarFFTMTF(optic, *args, **kwargs)
