"""Polarization state: the amplitudes and phases of a ray's Ex and Ey.

Port of `optiland_tpu/polarization/state.py`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PolarizationState:
    """Transverse field state: amplitudes and phases of Ex/Ey.

    `is_polarized=False` models unpolarized light, traced as the incoherent
    average of two orthogonal linear states."""

    is_polarized: bool = True
    Ex: float = 1.0
    Ey: float = 0.0
    phase_x: float = 0.0
    phase_y: float = 0.0

    def __post_init__(self):
        if self.is_polarized:
            mag = np.sqrt(self.Ex**2 + self.Ey**2)
            if mag == 0:
                raise ValueError("Polarized state needs nonzero (Ex, Ey).")

    @staticmethod
    def unpolarized() -> "PolarizationState":
        return PolarizationState(is_polarized=False, Ex=0.0, Ey=0.0)
