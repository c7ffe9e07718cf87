"""CODE V .seq import and export (port of `optiland_tpu/fileio/codev.py`).

Compact reader for the sequential CODE V subset the reference supports
(`optiland/fileio/codev/`): TITLE, EPD/FNO/NA apertures, WL (nm) + REF
primary index, XAN/YAN angle or YOB height fields, SO/S/SI surface rows
(radius thickness [glass|nd:vd|REFL]), STO stop marker, K conic and
A/B/C/D/E 4th..12th-order asphere coefficients.
"""

from __future__ import annotations

import math
import shlex

from optiland_tpu_torch.materials.catalog import (abbe_material,
                                                 resolve_material)
from optiland_tpu_torch.system.optic import Optic


def _parse_glass(tok: str):
    if tok.upper() == "REFL":
        return "mirror"
    if ":" in tok:
        nd, vd = (float(x) for x in tok.split(":"))
        if vd == 0.0:
            return resolve_material(nd)  # constant-index "fictitious" glass
        return abbe_material(nd, vd)
    name = tok.split("_")[0]
    catalog = tok.split("_")[1].lower() if "_" in tok else None
    try:
        return resolve_material((name, catalog) if catalog else name)
    except KeyError:
        return resolve_material(name)


def load_codev_file(path: str) -> Optic:
    lines = open(path, encoding="latin-1").read().splitlines()

    title = None
    aperture = None
    wavelengths_nm = []
    ref_idx = 1
    yan, xan, yob = [], [], []
    field_type = "angle"
    surfaces = []  # dicts
    cur = None

    # CODE V asphere letters: A=r^4, B=r^6, C=r^8, D=r^10, E=r^12
    _ASPH = {"A": 1, "B": 2, "C": 3, "D": 4, "E": 5}

    for raw in lines:
        line = raw.split("!")[0].strip()
        if not line:
            continue
        t = shlex.split(line)
        key = t[0].upper()
        if key == "TITLE":
            title = t[1] if len(t) > 1 else None
        elif key == "EPD":
            aperture = ("EPD", float(t[1]))
        elif key == "FNO":
            aperture = ("imageFNO", float(t[1]))
        elif key == "NA":
            aperture = ("objectNA", float(t[1]))
        elif key == "WL":
            wavelengths_nm = [float(v) for v in t[1:]]
        elif key == "REF":
            ref_idx = int(t[1])
        elif key == "YAN":
            yan = [float(v) for v in t[1:]]
            field_type = "angle"
        elif key == "XAN":
            xan = [float(v) for v in t[1:]]
        elif key == "YOB":
            yob = [float(v) for v in t[1:]]
            field_type = "object_height"
        elif key in ("SO", "S", "SI"):
            cur = {"radius": float(t[1]) if len(t) > 1 else math.inf,
                   "thickness": float(t[2]) if len(t) > 2 else 0.0,
                   "glass": t[3] if len(t) > 3 else None,
                   "conic": 0.0, "asph": {}, "is_stop": False,
                   "kind": key, "dx": 0.0, "dy": 0.0,
                   "rx": 0.0, "ry": 0.0, "rz": 0.0, "aperture": None}
            surfaces.append(cur)
        elif key == "STO" and cur is not None:
            cur["is_stop"] = True
        elif key == "K" and cur is not None:
            cur["conic"] = float(t[1])
        elif key == "XDE" and cur is not None:
            cur["dx"] = float(t[1])
        elif key == "YDE" and cur is not None:
            cur["dy"] = float(t[1])
        elif key == "ADE" and cur is not None:
            cur["rx"] = math.radians(float(t[1]))
        elif key == "BDE" and cur is not None:
            cur["ry"] = math.radians(float(t[1]))
        elif key == "CDE" and cur is not None:
            cur["rz"] = math.radians(float(t[1]))
        elif key == "CIR" and cur is not None and len(t) > 2 \
                and t[1].upper() == "CLR":
            cur["aperture"] = float(t[2])
        elif key in _ASPH and cur is not None and len(t) > 1:
            cur["asph"][_ASPH[key]] = float(t[1])

    lens = Optic(title)
    for i, s in enumerate(surfaces):
        radius = math.inf if s["radius"] == 0.0 else s["radius"]
        thickness = s["thickness"]
        if s["kind"] == "SO" and thickness >= 1e9:
            thickness = math.inf
        mat = "air"
        if s["glass"] is not None:
            mat = _parse_glass(s["glass"])
        kwargs = {}
        stype = "standard"
        if s["asph"]:
            stype = "even_asphere"
            top = max(s["asph"])
            coeffs = [0.0] * top
            for order, v in s["asph"].items():
                coeffs[order - 1] = v
            kwargs["coefficients"] = coeffs
        lens.add_surface(index=i, radius=radius, thickness=thickness,
                         conic=s["conic"], material=mat,
                         is_stop=s["is_stop"], surface_type=stype,
                         dx=s["dx"], dy=s["dy"], rx=s["rx"], ry=s["ry"],
                         rz=s["rz"], aperture=s["aperture"], **kwargs)

    if aperture is None:
        aperture = ("EPD", 10.0)
    lens.set_aperture(*aperture)
    lens.set_field_type(field_type)
    fields_y = yob if field_type == "object_height" else yan
    if not fields_y:
        fields_y = [0.0]
    if not xan:
        xan = [0.0] * len(fields_y)
    for fx, fy in zip(xan, fields_y):
        lens.add_field(y=fy, x=fx)
    for j, wnm in enumerate(wavelengths_nm or [550.0]):
        lens.add_wavelength(wnm * 1e-3, is_primary=(j + 1 == ref_idx))
    return lens


# ---------------------------------------------------------------------------
# writer (reference `optiland/fileio/codev/writer/{formatter,encoder,
# exporter}.py`)
# ---------------------------------------------------------------------------
_AP_TO_CMD = {"EPD": "EPD", "imageFNO": "FNO", "objectNA": "NA"}
# CODE V asphere letters for r^4 .. r^20
_ASPH_LETTERS = ("A", "B", "C", "D", "E", "F", "G", "H", "J")


def _fmt(v: float) -> str:
    return f"{v:.8g}"


def _parse_abbe_name(name: str):
    """Exact (nd, vd) from an `abbe(nd,vd)` MaterialSpec name, else None."""
    if name and name.startswith("abbe(") and name.endswith(")"):
        try:
            nd_s, vd_s = name[5:-1].split(",")
            return float(nd_s), float(vd_s)
        except ValueError:
            return None
    return None


def _encode_glass_inline(mat) -> str:
    from optiland_tpu_torch.fileio.zemax import material_nd_vd
    from optiland_tpu_torch.materials.dispersion import FORMULA_IDEAL

    if mat.mirror:
        return "REFL"
    if mat.formula == FORMULA_IDEAL:
        n = float(mat.coefficients[0])
        if abs(n - 1.0) < 1e-9:
            return ""
        return f"{n!r}:0.0"
    ab = _parse_abbe_name(mat.name or "")
    if ab is not None:
        # glass was built from exact (nd, vd): round-trip them verbatim
        return f"{ab[0]!r}:{ab[1]!r}"
    name = (mat.name or "").split("|")[0]
    catalog = (mat.name or "").split("|")[1] if "|" in (mat.name or "") \
        else None
    # write the glass by name only when the reader resolves that name back
    # to the identical dispersion (same formula + coefficients)
    try:
        from optiland_tpu_torch.materials.catalog import resolve_material

        cand = resolve_material((name, catalog) if catalog else name) \
            if name else None
        known = (cand is not None and cand.formula == mat.formula
                 and cand.coefficients == mat.coefficients)
    except Exception:
        known = False
    if known:
        return f"{name.upper()}_{catalog.upper()}" if catalog \
            else name.upper()
    nd, vd = material_nd_vd(mat)
    return f"{nd:.6f}:{vd:.4f}"


def save_codev_file(optic: Optic, path: str) -> None:
    """Write an Optic as a sequential CODE V .seq file."""
    lines: list[str] = []
    lines.append("! Generated by optiland_tpu")
    lines.append("RDM Y")
    if optic.name:
        lines.append(f"TITLE '{optic.name}'")

    cmd = _AP_TO_CMD.get(optic.aperture_type or "EPD")
    if cmd:
        lines.append(f"{cmd} {_fmt(optic.aperture_value)}")

    wls = list(optic.wavelengths.values_um) or [0.55]
    lines.append("WL " + " ".join(_fmt(w * 1000.0) for w in wls))
    lines.append("WTW " + " ".join(["1"] * len(wls)))
    lines.append(f"REF {optic.wavelengths.primary_idx + 1}")

    yf = list(optic.fields.y) or [0.0]
    xf = list(optic.fields.x)
    x_cmd, y_cmd = ("XOB", "YOB") \
        if optic.fields.field_type == "object_height" else ("XAN", "YAN")
    if xf and any(abs(v) > 1e-12 for v in xf):
        lines.append(f"{x_cmd} " + " ".join(_fmt(v) for v in xf))
    lines.append(f"{y_cmd} " + " ".join(_fmt(v) for v in yf))
    lines.append("")

    specs = optic.surfaces.specs
    for idx, s in enumerate(specs):
        radius = 0.0 if s.radius in (math.inf, -math.inf) else s.radius
        thickness = s.thickness if math.isfinite(s.thickness) else 1e10
        if idx == 0:
            line = f"SO {_fmt(radius)} {_fmt(thickness)}"
        elif idx == len(specs) - 1:
            line = f"SI {_fmt(radius)} {_fmt(thickness)}"
        else:
            glass = _encode_glass_inline(s.material)
            line = f"S  {_fmt(radius)} {_fmt(thickness)}"
            if glass:
                line += f"  {glass}"
        lines.append(line)
        if s.is_stop:
            lines.append("  STO")
        if abs(s.conic) > 1e-16:
            lines.append(f"  K {_fmt(s.conic)}")
        if s.geometry == "even_asphere":
            for i, c in enumerate(s.coefficients):
                if i < len(_ASPH_LETTERS) and abs(c) > 1e-30:
                    lines.append(f"  {_ASPH_LETTERS[i]} {_fmt(float(c))}")
        for val, label in ((s.dx, "XDE"), (s.dy, "YDE"),
                           (math.degrees(s.rx), "ADE"),
                           (math.degrees(s.ry), "BDE"),
                           (math.degrees(s.rz), "CDE")):
            if abs(val) > 1e-12:
                lines.append(f"  {label} {_fmt(val)}")
        if s.semi_aperture is not None and not hasattr(s.semi_aperture,
                                                      "contains"):
            lines.append(f"  CIR CLR {_fmt(float(s.semi_aperture))}")

    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
