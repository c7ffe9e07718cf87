"""Surface-type converters.

Port of `optiland_tpu/system/converters.py` (the reference's
`optiland/surfaces/converters.py`, the
`ParaxialToThickLensConverter`): replace an ideal thin-lens ("paraxial")
surface with an equivalent thick lens of two real surfaces via the
lensmaker's equation, preserving focal length. Operates on the host-side
`SurfaceSpec` list; the next `build()` recompiles the system.
"""

from __future__ import annotations

import math

import torch

from optiland_tpu_torch.materials.catalog import resolve_material
from optiland_tpu_torch.materials.dispersion import material_index


def _solve_equiconvex_r1(n: float, f_target: float, d: float) -> float:
    """R1 (= -R2) of a symmetric thick lens with focal length `f_target`,
    index n, center thickness d (reference `converters.py:102-184`):
    P*n*R1^2 - 2*n*(n-1)*R1 + (n-1)^2*d = 0."""
    P = 1.0 / f_target
    a = P * n
    b = -2.0 * n * (n - 1.0)
    c = (n - 1.0) ** 2 * d
    if abs(a) < 1e-9:
        if abs(b) < 1e-9:
            raise ValueError("Cannot solve for R1 (P=0, n=1).")
        return -c / b
    disc = b * b - 4.0 * a * c
    if disc < 0:
        raise ValueError("Thick-lens conversion: discriminant < 0.")
    sol1 = (-b + math.sqrt(disc)) / (2.0 * a)
    sol2 = (-b - math.sqrt(disc)) / (2.0 * a)
    want_positive = f_target > 0
    for r in (sol1, sol2):
        if (r > 0) == want_positive and r != 0:
            return r
    raise ValueError("Thick-lens conversion: no usable R1 root.")


def paraxial_to_thick_lens(optic, surface_index: int, material="N-BK7",
                           center_thickness: float = 3.0):
    """Replace the thin-lens surface at `surface_index` with an equivalent
    biconvex/biconcave thick lens (reference `converters.py:21-242`).

    The thick lens is symmetric (R1 = -R2), made of `material`, with the
    given center thickness; the gap after the element is shortened so the
    following surface stays at the same axial position.
    """
    specs = optic.surfaces.specs
    s = specs[surface_index]
    if s.surface_type != "paraxial":
        raise TypeError(
            f"Surface {surface_index} is {s.surface_type!r}, not a thin-lens "
            f"'paraxial' surface.")
    f_target = s.focal_length
    if abs(f_target) < 1e-9:
        raise ValueError("Thin lens has zero power; nothing to convert.")

    mat = resolve_material(material)
    n = float(material_index(
        mat.formula, mat.n_coeffs,
        torch.tensor(mat.coefficients, dtype=torch.float64),
        optic.primary_wavelength))
    r1 = _solve_equiconvex_r1(n, f_target, center_thickness)
    r2 = -r1

    from optiland_tpu_torch.system.spec import SurfaceSpec

    front = SurfaceSpec(radius=r1, thickness=center_thickness, material=mat,
                        is_stop=s.is_stop, comment="Thick Lens - Surface 1")
    # the reference keeps the thin surface's gap after the back surface
    # (`converters.py:205-213`)
    back = SurfaceSpec(radius=r2, thickness=s.thickness, material=s.material,
                       comment="Thick Lens - Surface 2")
    optic.surfaces._specs = (specs[:surface_index] + [front, back]
                             + specs[surface_index + 1:])
    optic._dirty()
    return optic


def convert_to_thick_lens(optic, material="N-BK7",
                          center_thickness: float = 3.0):
    """Convert every thin-lens surface in the system to a thick lens
    (reference `converters.py:227-242`)."""
    idx = 1
    while idx < len(optic.surfaces.specs) - 1:
        if optic.surfaces.specs[idx].surface_type == "paraxial":
            paraxial_to_thick_lens(optic, idx, material=material,
                                   center_thickness=center_thickness)
            idx += 2
        else:
            idx += 1
    return optic
