from optiland_tpu_torch.polarization.state import PolarizationState
from optiland_tpu_torch.polarization import jones, prt

__all__ = ["PolarizationState", "jones", "prt"]
