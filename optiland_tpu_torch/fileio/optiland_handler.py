"""Optiland-format JSON save/load (port of
`optiland_tpu/fileio/optiland_handler.py`).

Writes/reads the reference's JSON schema (`fileio/optiland_handler.py:21-97`,
`optic/optic_serializer.py:28`) so prescriptions interchange between the two
frameworks: aperture, fields, wavelengths, and the surface list with
geometry/material/stop data.
"""

from __future__ import annotations

import json
import math

import numpy as np

from optiland_tpu_torch.materials.catalog import MIRROR, resolve_material
from optiland_tpu_torch.system.optic import Optic

_GEOM_TYPE = {
    "standard": "StandardGeometry",
    "plane": "Plane",
    "even_asphere": "EvenAsphere",
    "odd_asphere": "OddAsphere",
    "polynomial": "PolynomialGeometry",
    "chebyshev": "ChebyshevPolynomialGeometry",
    "zernike": "ZernikePolynomialGeometry",
    "biconic": "BiconicGeometry",
    "toroidal": "ToroidalGeometry",
}
_GEOM_FROM_TYPE = {v: k for k, v in _GEOM_TYPE.items()}
_GEOM_FROM_TYPE["Plane"] = "standard"


def optic_to_dict(optic: Optic) -> dict:
    """Serialize to the reference's JSON schema."""
    specs = optic.surfaces.specs
    zs = [0.0]
    for s in specs[1:]:
        zs.append(zs[-1] + 0.0)
    # vertex positions: surface 1 at z=0
    z = 0.0
    positions = []
    for i, s in enumerate(specs):
        if i == 0:
            positions.append(-s.thickness)
        else:
            positions.append(z)
            z += s.thickness

    surfaces = []
    for i, s in enumerate(specs):
        geom = {
            "type": _GEOM_TYPE.get(s.geometry, "StandardGeometry"),
            "cs": {"x": s.dx, "y": s.dy, "z": positions[i],
                   "rx": s.rx, "ry": s.ry, "rz": s.rz, "reference_cs": None},
            "radius": s.radius,
            "conic": s.conic,
        }
        if s.coefficients:
            geom["coefficients"] = list(s.coefficients)
        mat = s.material
        if mat.mirror:
            mat_d = {"type": "Mirror"}
        elif mat.name == "air":
            mat_d = {"type": "IdealMaterial", "index": 1.0, "absorp": 0.0}
        elif mat.name.startswith("ideal("):
            mat_d = {"type": "IdealMaterial",
                     "index": float(mat.coefficients[0]), "absorp": 0.0}
        else:
            mat_d = {"type": "Material", "name": mat.name,
                     "reference": None, "robust_search": True}
        stype = ("ObjectSurface" if i == 0
                 else "ImageSurface" if i == len(specs) - 1 else "Surface")
        surfaces.append({
            "type": stype,
            "thickness": s.thickness,
            "geometry": geom,
            "material_post": mat_d,
            "is_stop": s.is_stop,
            "aperture": (None if s.semi_aperture is None else
                         {"type": "RadialAperture",
                          "r_max": s.semi_aperture, "r_min": 0.0}),
            "comment": s.comment,
        })

    return {
        "version": 1.0,
        "name": optic.name,
        "aperture": {"type": optic.aperture_type,
                     "value": optic.aperture_value},
        "fields": {
            "fields": [
                {"x": x, "y": y, "vx": vx, "vy": vy, "weight": 1.0}
                for x, y, vx, vy in zip(optic.fields.x, optic.fields.y,
                                        optic.fields.vx, optic.fields.vy)
            ],
            "telecentric": False,
            "field_definition": {
                "field_type": ("AngleField"
                               if optic.fields.field_type == "angle"
                               else "ObjectHeightField")
            },
        },
        "wavelengths": {
            "wavelengths": [
                {"value": w, "is_primary": j == optic.wavelengths.primary_idx,
                 "unit": "um", "weight": 1.0}
                for j, w in enumerate(optic.wavelengths.values_um)
            ],
            "polarization": "ignore",
        },
        "apodization": None,
        "pickups": [],
        "solves": {"solves": []},
        "surface_group": {"surfaces": surfaces},
    }


def optic_from_dict(data: dict) -> Optic:
    """Build an Optic from the reference's JSON schema."""
    lens = Optic(data.get("name"))

    surfaces = data["surface_group"]["surfaces"]
    for i, sd in enumerate(surfaces):
        geom = sd.get("geometry", {})
        gtype = _GEOM_FROM_TYPE.get(geom.get("type", "StandardGeometry"),
                                    "standard")
        mat_d = sd.get("material_post") or {}
        mtype = mat_d.get("type", "IdealMaterial")
        if mtype == "Mirror" or sd.get("interaction_model", {}).get(
            "is_reflective", False
        ):
            material = MIRROR
        elif mtype == "IdealMaterial":
            idx = float(mat_d.get("index", 1.0))
            material = "air" if idx == 1.0 else idx
        elif mtype == "AbbeMaterial":
            from optiland_tpu_torch.materials.catalog import abbe_material

            material = abbe_material(mat_d["index"], mat_d["abbe"])
        else:
            name = mat_d.get("name", "air")
            ref = mat_d.get("reference")
            material = resolve_material((name, ref) if ref else name)

        ap = sd.get("aperture")
        semi_ap = None
        if isinstance(ap, dict) and "r_max" in ap:
            semi_ap = ap["r_max"]

        cs = geom.get("cs", {})
        radius = geom.get("radius", math.inf)
        if isinstance(radius, str) or radius is None:
            radius = math.inf
        kwargs = {}
        stype = "standard"
        if gtype in ("even_asphere", "odd_asphere", "polynomial", "zernike"):
            stype = gtype
            kwargs["coefficients"] = geom.get("coefficients", ())
        thickness = sd.get("thickness", 0.0)
        if thickness is None or (isinstance(thickness, float)
                                 and not np.isfinite(thickness)):
            thickness = math.inf if i == 0 else 0.0
        lens.add_surface(
            index=i, radius=float(radius), thickness=float(thickness),
            conic=float(geom.get("conic", 0.0)), material=material,
            is_stop=bool(sd.get("is_stop", False)),
            surface_type=stype, aperture=semi_ap,
            dx=cs.get("x", 0.0), dy=cs.get("y", 0.0),
            rx=cs.get("rx", 0.0), ry=cs.get("ry", 0.0),
            rz=cs.get("rz", 0.0),
            comment=sd.get("comment", ""), **kwargs,
        )

    ap = data.get("aperture")
    if ap:
        lens.set_aperture(ap["type"], ap["value"])

    fd = data.get("fields", {})
    ftype = fd.get("field_definition", {}).get("field_type", "AngleField")
    lens.set_field_type("angle" if ftype == "AngleField" else "object_height")
    for f in fd.get("fields", []):
        lens.add_field(y=f.get("y", 0.0), x=f.get("x", 0.0),
                       vx=f.get("vx", 0.0), vy=f.get("vy", 0.0))

    for w in data.get("wavelengths", {}).get("wavelengths", []):
        lens.add_wavelength(w["value"], is_primary=w.get("is_primary", False),
                            unit=w.get("unit", "um"))
    return lens


def save_optiland_file(optic: Optic, path: str):
    with open(path, "w") as f:
        json.dump(optic_to_dict(optic), f, indent=2, default=float)


def load_optiland_file(path: str) -> Optic:
    with open(path) as f:
        return optic_from_dict(json.load(f))
