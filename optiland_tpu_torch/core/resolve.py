"""Field/wavelength argument resolution shared by analyses and PSF/MTF
(port of `optiland_tpu/core/resolve.py`)."""

from __future__ import annotations

import numpy as np


def resolve_fields(optic, fields):
    """Normalize a fields argument to a list of (Hx, Hy) coordinates."""
    if fields == "all":
        return optic.fields.get_field_coords()
    return [tuple(f) for f in fields]


def resolve_wavelengths(optic, wavelengths):
    """Normalize a wavelengths argument to a list of values in um."""
    if wavelengths == "all":
        return list(optic.wavelengths.values_um)
    if wavelengths == "primary":
        return [optic.primary_wavelength]
    return [float(w) for w in np.atleast_1d(wavelengths)]
