"""Sample lens systems (port of `optiland_tpu/models`; the lens zoo,
`models/zoo.py`, is still to port)."""

from optiland_tpu_torch.models.objectives import (
    CookeTriplet,
    DoubleGauss,
    ReverseTelephoto,
)

__all__ = ["CookeTriplet", "DoubleGauss", "ReverseTelephoto"]
