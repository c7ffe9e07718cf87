from optiland_tpu_torch.tolerancing.core import (
    Tolerancing,
    ScalarSampler,
    RangeSampler,
    NormalSampler,
    UniformSampler,
)
from optiland_tpu_torch.tolerancing.monte_carlo import MonteCarlo
from optiland_tpu_torch.tolerancing.sensitivity import SensitivityAnalysis

__all__ = [
    "Tolerancing",
    "ScalarSampler",
    "RangeSampler",
    "NormalSampler",
    "UniformSampler",
    "MonteCarlo",
    "SensitivityAnalysis",
]
