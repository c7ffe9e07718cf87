"""Material specs and the bundled glass catalog.

Port of `optiland_tpu/materials/catalog.py`: the full refractiveindex.info
database (3201 rows, a gzipped JSON shared by both packages and read in
place). Name resolution has the JAX package's semantics: a substring filter
over (category, name, filename), an optional reference filter, an optional
wavelength-range filter, then the row of least Levenshtein distance.

`resolve_material` maps a number (ideal index), a glass name, a
`(name, catalog)` tuple, the serialized "name|catalog" form, "air",
"mirror" or a `MaterialSpec` to a `MaterialSpec` (static formula code and
coefficient tuple, plus the tabulated extinction table where the catalog
has one).
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from optiland_tpu_torch.materials.dispersion import (
    FORMULA_IDEAL,
    FORMULA_POLYVAL,
    FORMULA_TABULATED,
)

# shared data of the repository, read in place: the fitted Schott-catalog
# coefficients of the Abbe glass model and the full glass catalog
_DATA = Path(__file__).resolve().parents[2] / "optiland_tpu" / "data"
_GLASS_MODEL = _DATA / "glass_model_coefficients.npy"
_CATALOG = _DATA / "catalog_full.json.gz"


@dataclass(frozen=True)
class MaterialSpec:
    """Static description of a material (hashable; lives in SystemStatic).

    `k_table` is an optional (wavelengths_um, k_values) pair of tuples: the
    tabulated extinction coefficient, interpolated at trace time for
    Beer-Lambert absorption. `therm` / `t0` carry the Schott thermal
    dispersion coefficients and reference temperature where the catalog row
    has them."""

    formula: int
    coefficients: tuple[float, ...]
    name: str = ""
    mirror: bool = False
    k_table: tuple[tuple[float, ...], tuple[float, ...]] | None = None
    therm: tuple[float, ...] | None = None
    t0: float | None = None

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


@lru_cache(maxsize=1)
def _load_catalog() -> list[dict]:
    with gzip.open(_CATALOG, "rt") as f:
        return json.load(f)["rows"]


def catalog_names() -> list[str]:
    """All distinct glass/material names in the bundled database."""
    return sorted({r["n"] for r in _load_catalog()})


def _levenshtein(s1: str, s2: str) -> int:
    """Edit distance (iterative two-row DP)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    prev = list(range(len(s2) + 1))
    for i, ch1 in enumerate(s1, 1):
        cur = [i]
        for j, ch2 in enumerate(s2, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ch1 != ch2)))
        prev = cur
    return prev[-1]


def find_material(
    name: str,
    reference: str | None = None,
    min_wavelength: float | None = None,
    max_wavelength: float | None = None,
    robust: bool = True,
) -> dict:
    """The best-matching catalog row for a material name: case-insensitive
    substring filter on category/name/filename, optional reference filter
    over five fields, optional wavelength-range containment, Levenshtein
    ranking. KeyError when nothing matches."""
    key = name.lower()
    rows = [
        r for r in _load_catalog()
        if key in r["c"].lower() or key in r["n"].lower()
        or key in r["f"].lower()
    ]
    if reference:
        ref = reference.lower()
        rows = [
            r for r in rows
            if ref in r["c"].lower() or ref in r["cf"].lower()
            or ref in r["r"].lower() or ref in r["n"].lower()
            or ref in r["file"].lower()
        ]
    if min_wavelength is not None:
        rows = [r for r in rows
                if r["wmin"] <= min_wavelength <= r["wmax"]]
    if max_wavelength is not None:
        rows = [r for r in rows
                if r["wmin"] <= max_wavelength <= r["wmax"]]
    if not rows:
        raise KeyError(
            f"No matches found for material {name!r}"
            + (f" with reference {reference!r}" if reference else "")
        )
    scored = sorted(
        rows,
        key=lambda r: min(_levenshtein(key, r["c"].lower()),
                          _levenshtein(key, r["n"].lower()),
                          _levenshtein(key, r["f"].lower())),
    )
    if len(scored) > 1 and not robust:
        raise KeyError(f"Multiple matches found for material {name!r}")
    return scored[0]


def _spec_from_row(row: dict, display_name: str) -> MaterialSpec:
    """A catalog row as a MaterialSpec: a dispersion formula row, or a
    tabulated n(w) row (formula 10, coefficients = wavelengths then
    indices), with its extinction table and thermal data where present."""
    k_table = None
    if "kt" in row:
        k_table = (tuple(float(v) for v in row["kt"][0]),
                   tuple(float(v) for v in row["kt"][1]))
    therm = tuple(float(v) for v in row["therm"]) if "therm" in row else None
    t0 = float(row["t0"]) if "t0" in row else None
    if "formula" in row:
        return MaterialSpec(
            formula=int(row["formula"]),
            coefficients=tuple(float(c) for c in row["coeffs"]),
            name=display_name, k_table=k_table, therm=therm, t0=t0,
        )
    if "nt" in row:
        wl, nv = row["nt"]
        return MaterialSpec(
            formula=FORMULA_TABULATED,
            coefficients=tuple(float(v) for v in wl)
            + tuple(float(v) for v in nv),
            name=display_name, k_table=k_table, therm=therm, t0=t0,
        )
    raise KeyError(
        f"Catalog row for {display_name!r} has no refractive-index data "
        f"(file {row.get('file')})"
    )


def resolve_material(spec) -> MaterialSpec:
    """Resolve a user material spec: None/"air", "mirror", a number (ideal
    constant index), a MaterialSpec (passthrough), a glass name, a
    (name, catalog) tuple or the serialized "name|catalog" form."""
    if spec is None:
        return AIR
    if isinstance(spec, MaterialSpec):
        return spec
    if isinstance(spec, (int, float)):
        return MaterialSpec(FORMULA_IDEAL, (float(spec),), name=f"ideal({spec})")
    if isinstance(spec, tuple):
        name, reference = spec
    else:
        name, reference = str(spec), None
        if name.lower() == "air":
            return AIR
        if name.lower() == "mirror":
            return MIRROR
        if "|" in name:
            name, reference = name.split("|", 1)
    row = find_material(name, reference)
    display = f"{name}|{reference}" if reference else name
    return _spec_from_row(row, display)
