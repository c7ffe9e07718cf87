"""Thin-film tolerancing: perturbations, sensitivity sweeps, Monte Carlo.

Port of `optiland_tpu/thin_film/tolerancing.py`: the operand values are
one torch function of the layer-thickness vector that also takes a batch
of vectors, so a sensitivity sweep or a Monte-Carlo run is one evaluation
over a (B, L) matrix of perturbed thicknesses. Monte-Carlo draws come from
an explicit `torch.Generator` (the JAX package's threefry keys cannot be
reproduced) or from a table the caller gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.thin_film.optimization import (
    SpectralOperand,
    _as_tuple,
    _spread,
)
from optiland_tpu_torch.thin_film.stack import ThinFilmStack

__all__ = ["ThinFilmPerturbation", "ThinFilmTolerancing",
           "ThinFilmSensitivity", "ThinFilmMonteCarlo"]


@dataclass(frozen=True)
class ThinFilmPerturbation:
    """Thickness perturbation of one layer: uniform over +-`range_nm`, or
    normal with `sigma_nm`."""

    layer_index: int
    range_nm: float | None = None
    sigma_nm: float | None = None

    def sample(self, generator, n: int, dtype=None, device=None):
        """n thickness deltas (um) from `generator`."""
        kw = dict(generator=generator, dtype=dtype or config.get_dtype(),
                  device=device)
        if self.sigma_nm is not None:
            return torch.randn(n, **kw) * (self.sigma_nm * 1e-3)
        r = (self.range_nm or 0.0) * 1e-3
        return (2.0 * torch.rand(n, **kw) - 1.0) * r

    def sweep(self, num_steps: int, dtype=None, device=None):
        r = ((self.sigma_nm * 3.0) if self.sigma_nm is not None
             else (self.range_nm or 0.0)) * 1e-3
        return torch.linspace(-r, r, num_steps, dtype=dtype or
                              config.get_dtype(), device=device)


class ThinFilmTolerancing:
    """Perturbations and operands on a stack, evaluated on `device` (None:
    the CUDA card) in the precision policy's dtype."""

    def __init__(self, stack: ThinFilmStack, device=None):
        self.stack = stack
        self.device = config.resolve_device(device)
        self.perturbations: list[ThinFilmPerturbation] = []
        self.operands: list[SpectralOperand] = []

    def add_perturbation(self, layer_index: int, range_nm: float | None = None,
                         sigma_nm: float | None = None):
        self.perturbations.append(
            ThinFilmPerturbation(layer_index, range_nm, sigma_nm))
        return self

    def add_operand(self, property: str, wavelength_nm=550.0, aoi_deg=0.0,
                    polarization: str = "u"):
        """Track the value of R/T/A at a spectral point (no target: the
        output is the values' distribution)."""
        wl, aoi = _spread(_as_tuple(wavelength_nm), _as_tuple(aoi_deg))
        self.operands.append(SpectralOperand(
            prop=property, wavelength_nm=wl, aoi_deg=aoi,
            polarization=polarization, target_type="equal",
            value=(0.0,) * len(wl), weight=1.0))
        return self

    def _base_thickness(self):
        return torch.tensor([float(np.asarray(lay.thickness_um))
                             for lay in self.stack.layers],
                            dtype=config.get_dtype(), device=self.device)

    def _values(self, th):
        """The operands' values at the thicknesses `th`, (L,) -> (K,) or
        (B, L) -> (B, K)."""
        return torch.cat([torch.atleast_1d(op.values(self.stack, th))
                          for op in self.operands], dim=-1)

    def evaluate(self) -> np.ndarray:
        with torch.no_grad():
            return self._values(self._base_thickness()).cpu().numpy()


class ThinFilmSensitivity(ThinFilmTolerancing):
    """Per-perturbation sweep of every operand."""

    def run(self, num_steps: int = 11) -> dict:
        base = self._base_thickness()
        results = {}
        for p in self.perturbations:
            deltas = p.sweep(num_steps, base.dtype, base.device)
            ths = base[None, :].repeat(num_steps, 1)
            ths[:, p.layer_index] += deltas
            with torch.no_grad():
                vals = self._values(ths)
            results[p.layer_index] = {
                "delta_nm": deltas.cpu().numpy() * 1e3,
                "values": vals.cpu().numpy(),
            }
        return results


class ThinFilmMonteCarlo(ThinFilmTolerancing):
    """Monte Carlo over perturbation draws, one evaluation for all trials.
    The draws are `draws`, a (num_trials, number of perturbations) table of
    thickness deltas in um, or else each perturbation's `sample` from
    `generator` (None: a generator seeded with `seed` on the device)."""

    def run(self, num_trials: int = 1000, seed: int = 0, generator=None,
            draws=None) -> dict:
        base = self._base_thickness()
        ths = base[None, :].repeat(num_trials, 1)
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=base.device)
                generator.manual_seed(seed)
            draws = torch.stack([p.sample(generator, num_trials, base.dtype,
                                          base.device)
                                 for p in self.perturbations], dim=-1)
        draws = torch.as_tensor(draws, dtype=base.dtype, device=base.device)
        for i, p in enumerate(self.perturbations):
            ths[:, p.layer_index] += draws[:, i]
        ths = torch.clamp(ths, min=0.0)
        with torch.no_grad():
            vals = self._values(ths).cpu().numpy()
        return {
            "thicknesses_um": ths.cpu().numpy(),
            "values": vals,
            "mean": vals.mean(axis=0),
            "std": vals.std(axis=0),
            "p05": np.percentile(vals, 5, axis=0),
            "p95": np.percentile(vals, 95, axis=0),
        }
