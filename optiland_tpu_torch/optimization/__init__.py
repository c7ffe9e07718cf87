from optiland_tpu_torch.optimization.problem import OptimizationProblem
from optiland_tpu_torch.optimization.optimizers import (
    OptimizerGeneric,
    LeastSquares,
    DualAnnealing,
    DifferentialEvolution,
    BasinHopping,
    SHGO,
    OrthogonalDescent,
    AdamOptimizer,
    SGDOptimizer,
)
from optiland_tpu_torch.optimization.glass_expert import GlassExpert
from optiland_tpu_torch.optimization import operands, variables

__all__ = [
    "OptimizationProblem",
    "OptimizerGeneric",
    "LeastSquares",
    "DualAnnealing",
    "DifferentialEvolution",
    "BasinHopping",
    "SHGO",
    "OrthogonalDescent",
    "AdamOptimizer",
    "SGDOptimizer",
    "GlassExpert",
    "operands",
    "variables",
]
