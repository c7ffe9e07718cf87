"""optiland_tpu_torch — the PyTorch/CUDA port of optiland_tpu.

A second package beside the JAX one, with the same module layout and
function names. Plain tensor code is PyTorch; the fused trace kernels and
the Huygens-Fresnel sum are hand-written CUDA for Hopper (`csrc/`), built
with nvcc at first use.
Entry points run on the CUDA card unless the caller passes device="cpu".
"""

from __future__ import annotations

from optiland_tpu_torch import config
from optiland_tpu_torch.config import get_dtype, set_precision
from optiland_tpu_torch.core.rays import Rays
from optiland_tpu_torch.system.optic import Optic

__version__ = "0.1.0"

__all__ = [
    "Optic",
    "Rays",
    "config",
    "set_precision",
    "get_dtype",
]
