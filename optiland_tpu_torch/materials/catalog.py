"""Material specs: the subset of `optiland_tpu/materials/catalog.py` that
the system builder needs.

`resolve_material` maps a number (ideal index), a `MaterialSpec`, "air" or
"mirror" to a `MaterialSpec`. Named catalog glasses arrive with the glass
catalog port (ROADMAP queue 1, slice 2) and raise NotImplementedError here.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from optiland_tpu_torch.materials.dispersion import FORMULA_IDEAL, FORMULA_POLYVAL

# the fitted Schott-catalog coefficients of the Abbe glass model, shared
# data of the repository, read in place
_GLASS_MODEL = (Path(__file__).resolve().parents[2] / "optiland_tpu" / "data"
                / "glass_model_coefficients.npy")


@dataclass(frozen=True)
class MaterialSpec:
    """Static description of a material (hashable; lives in SystemStatic)."""

    formula: int
    coefficients: tuple[float, ...]
    name: str = ""
    mirror: bool = False
    k_table: tuple[tuple[float, ...], tuple[float, ...]] | None = None

    @property
    def n_coeffs(self) -> int:
        return len(self.coefficients)


AIR = MaterialSpec(formula=FORMULA_IDEAL, coefficients=(1.0,), name="air")
MIRROR = MaterialSpec(formula=FORMULA_IDEAL, coefficients=(1.0,), name="mirror",
                      mirror=True)


def abbe_material(index: float, abbe: float) -> MaterialSpec:
    """Material from (n_d, V_d) via the polynomial glass model
    (reference `materials/abbe.py:38-82`)."""
    C = np.load(_GLASS_MODEL)
    X = np.array([index, abbe, index**2, abbe**2, index**3, abbe**3])
    p = X @ C
    return MaterialSpec(
        formula=FORMULA_POLYVAL,
        coefficients=tuple(float(v) for v in p),
        name=f"abbe({index!r},{abbe!r})",
    )


def resolve_material(spec) -> MaterialSpec:
    """Resolve a user material spec: None/"air", "mirror", a number (ideal
    constant index) or a MaterialSpec (passthrough)."""
    if spec is None:
        return AIR
    if isinstance(spec, MaterialSpec):
        return spec
    if isinstance(spec, (int, float)):
        return MaterialSpec(FORMULA_IDEAL, (float(spec),), name=f"ideal({spec})")
    if isinstance(spec, str) and spec.lower() == "air":
        return AIR
    if isinstance(spec, str) and spec.lower() == "mirror":
        return MIRROR
    raise NotImplementedError(
        f"material {spec!r}: named catalog glasses arrive with the "
        "materials/catalog.py port (ROADMAP queue 1, item 10, slice 2)")
