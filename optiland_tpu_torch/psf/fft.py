"""FFT point-spread function (scalar and vectorial).

Port of `optiland_tpu/psf/fft.py`: sample the wavefront on a square pupil
grid, build the complex pupil A exp(-i 2 pi OPD) in `config.complex_dtype()`,
zero-pad, fft2. Normalization: diffraction-limited peak = 100, so
`strehl_ratio()` is the centered peak / 100. The vectorial PSF takes one
pupil per Cartesian component of each incoherent state's exit E field and
sums their intensities; `FFTPSF` picks it for a polarized optic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.core.resolve import resolve_wavelengths
from optiland_tpu_torch.wavefront.core import pupil_grid_coords, wavefront_data


def calculate_grid_size(num_rays: int) -> tuple[int, int]:
    """OpticStudio-style FFT sampling emulation."""
    eff = int(np.floor(32 * 2 ** ((np.log2(num_rays) - 5) / 2)))
    return eff, num_rays * 2


def _pupil_grid(static, params, Hx, Hy, wavelength, num_rays, strategy,
                aiming="paraxial"):
    """Complex pupil on a num_rays x num_rays grid (unit-disk masked)."""
    Px, Py, inside = pupil_grid_coords(num_rays, params.cv.dtype,
                                       params.cv.device)
    data = wavefront_data(static, params, Hx, Hy, Px, Py, wavelength,
                          strategy=strategy, aiming=aiming)
    P = torch.polar(torch.sqrt(data.intensity), -2.0 * math.pi * data.opd)
    P = torch.where(inside, P.to(config.complex_dtype()), 0.0)
    return P.reshape(num_rays, num_rays)


def _intensity_sum(pupils, grid_size):
    """Zero-pad + fft2 + |.|^2 summed over the pupils (unnormalized)."""
    n = pupils.shape[-1]
    pad_before = (grid_size - n) // 2
    padded = pupils.new_zeros(pupils.shape[:-2] + (grid_size, grid_size))
    padded[..., pad_before:pad_before + n, pad_before:pad_before + n] = pupils
    amp = torch.fft.fftshift(torch.fft.fft2(padded), dim=(-2, -1))
    return torch.sum(torch.real(amp * torch.conj(amp)), dim=0)


def _psf_from_pupils(pupils, grid_size):
    """Zero-pad + fft2 + |.|^2 summed over the pupils, normalized to DL
    peak = 100."""
    norm = torch.sum(torch.abs(pupils[0]) > 0) ** 2
    return _intensity_sum(pupils, grid_size) / norm * 100.0


class ScalarFFTPSF:
    """Scalar FFT PSF for one field over the configured wavelengths, on the
    device of the optic's build (the CUDA card unless `device="cpu"`)."""

    def __init__(self, optic, field, wavelength="primary", num_rays: int = 128,
                 grid_size: int | None = None, strategy: str = "chief_ray",
                 device=None):
        self.optic = optic
        self.field = field
        self.wavelengths = resolve_wavelengths(optic, wavelength)
        if grid_size is None:
            if num_rays < 32:
                raise ValueError(
                    "num_rays must be at least 32 if grid_size is not specified."
                )
            num_rays, grid_size = calculate_grid_size(num_rays)
        elif grid_size < num_rays:
            raise ValueError("grid_size must be >= num_rays")
        self.num_rays = num_rays
        self.grid_size = grid_size
        self.strategy = strategy

        static, params = optic.build(device=device)
        self.pupils = torch.stack([
            _pupil_grid(static, params, field[0], field[1], w, num_rays,
                        strategy, optic.ray_aiming)
            for w in self.wavelengths])
        self.psf = _psf_from_pupils(self.pupils, grid_size)

    def strehl_ratio(self):
        c = self.psf.shape[0] // 2
        return self.psf[c, c] / 100.0


def _vector_pupils(static, params, Hx, Hy, wavelength, num_rays, strategy,
                   state, aiming="paraxial"):
    """Component pupils for one wavelength: (n_states * 3, n, n) complex,
    state-major."""
    Px, Py, inside = pupil_grid_coords(num_rays, params.cv.dtype,
                                       params.cv.device)
    data = wavefront_data(static, params, Hx, Hy, Px, Py, wavelength,
                          strategy=strategy, polarization=state,
                          aiming=aiming)
    phase = torch.polar(torch.ones_like(data.opd), -2.0 * math.pi * data.opd)
    keep = (data.intensity > 0) & inside
    P = torch.where(keep[None, :, None], data.E_exits * phase[None, :, None],
                    0.0)
    return P.permute(0, 2, 1).reshape(-1, num_rays, num_rays)


def _psf_from_vector_pupils(pupils, grid_size):
    """Incoherent sum of the components' FFT intensities; DL peak = 100 by
    sum_i (sum |P_i|)^2."""
    norm = torch.sum(torch.sum(torch.abs(pupils), dim=(-2, -1)) ** 2)
    return _intensity_sum(pupils, grid_size) / norm * 100.0


class VectorialFFTPSF(ScalarFFTPSF):
    """Vectorial FFT PSF: the FFT of each Cartesian exit-pupil E-field
    component, summed incoherently over components and polarization
    states: the optic's state, or unpolarized light where it has none."""

    def __init__(self, optic, field, wavelength="primary",
                 num_rays: int = 128, grid_size: int | None = None,
                 strategy: str = "chief_ray", device=None):
        from optiland_tpu_torch.polarization import PolarizationState

        state = optic.polarization
        if state == "ignore" or state is None:
            state = PolarizationState.unpolarized()
        self.optic = optic
        self.field = field
        self.wavelengths = resolve_wavelengths(optic, wavelength)
        if grid_size is None:
            if num_rays < 32:
                raise ValueError(
                    "num_rays must be at least 32 if grid_size is not "
                    "specified.")
            num_rays, grid_size = calculate_grid_size(num_rays)
        elif grid_size < num_rays:
            raise ValueError("grid_size must be >= num_rays")
        self.num_rays = num_rays
        self.grid_size = grid_size
        self.strategy = strategy

        static, params = optic.build(device=device)
        self.pupils = torch.cat([
            _vector_pupils(static, params, field[0], field[1], w, num_rays,
                           strategy, state, optic.ray_aiming)
            for w in self.wavelengths])
        self.psf = _psf_from_vector_pupils(self.pupils, grid_size)


class FFTPSF:
    """Factory: the scalar FFT PSF, or the vectorial one for an optic with
    a polarization state."""

    def __new__(cls, optic, *args, **kwargs):
        if getattr(optic, "polarization", "ignore") != "ignore":
            return VectorialFFTPSF(optic, *args, **kwargs)
        return ScalarFFTPSF(optic, *args, **kwargs)
