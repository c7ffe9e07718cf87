from optiland_tpu_torch.thin_film.core import tmm_coh
from optiland_tpu_torch.thin_film.optimization import (
    NeedleSynthesis,
    NeedleSynthesisResult,
    ThinFilmOptimizer,
)
from optiland_tpu_torch.thin_film.stack import Layer, ThinFilmStack
from optiland_tpu_torch.thin_film.tolerancing import (
    ThinFilmMonteCarlo,
    ThinFilmPerturbation,
    ThinFilmSensitivity,
    ThinFilmTolerancing,
)

__all__ = [
    "Layer",
    "ThinFilmStack",
    "tmm_coh",
    "ThinFilmOptimizer",
    "NeedleSynthesis",
    "NeedleSynthesisResult",
    "ThinFilmTolerancing",
    "ThinFilmSensitivity",
    "ThinFilmMonteCarlo",
    "ThinFilmPerturbation",
]
