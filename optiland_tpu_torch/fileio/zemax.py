"""Zemax .zmx import and export (port of `optiland_tpu/fileio/zemax.py`).

A compact tokenizing reader for the sequential-mode .zmx files the reference
supports (`optiland/fileio/zemax/`): UNIT/ENPD/FNUM/OBNA, FTYP + XFLN/YFLN
fields, WAVM wavelengths + PWAV primary, SURF blocks with TYPE
STANDARD/EVENASPH, CURV, DISZ, CONI, PARM (asphere terms), GLAS (catalog
name with (n_d, V_d) Abbe fallback), STOP, MIRROR, DIAM apertures.
"""

from __future__ import annotations

import math

from optiland_tpu_torch.materials.catalog import (abbe_material,
                                                 resolve_material)
from optiland_tpu_torch.system.optic import Optic


def _tokens(line: str):
    return line.strip().split()


def _parse_float(s: str) -> float:
    if s.upper() in ("INFINITY", "INF"):
        return math.inf
    return float(s)


def load_zemax_file(path: str) -> Optic:
    """Parse a .zmx file into an Optic."""
    # zemax files come in several encodings (utf-16 with BOM, latin-1)
    raw = open(path, "rb").read()
    for enc in ("utf-16", "utf-8-sig", "latin-1"):
        try:
            text = raw.decode(enc)
            if "SURF" in text or "MODE" in text:
                break
        except UnicodeError:
            continue
    lines = text.splitlines()

    aperture_type, aperture_value = None, None
    fields_x, fields_y = [], []
    field_type = "angle"
    wavelengths = []  # (index, value)
    primary_wav_idx = None
    surfaces = {}  # idx -> dict
    cur = None
    obj_na = None

    for line in lines:
        if not line.strip():
            continue
        indented = line[:1] in (" ", "\t")
        t = _tokens(line)
        key = t[0].upper()

        if not indented:
            cur = None
            if key == "ENPD":
                aperture_type, aperture_value = "EPD", _parse_float(t[1])
            elif key == "FNUM":
                aperture_type, aperture_value = "imageFNO", _parse_float(t[1])
            elif key == "OBNA":
                aperture_type, aperture_value = "objectNA", _parse_float(t[1])
                obj_na = aperture_value
            elif key == "FLOA":
                # floating stop: sized by the stop surface's DIAM
                # (reference `fileio/zemax/reader/converter.py:267-279`)
                aperture_type = "float_by_stop"
            elif key == "FTYP":
                # field type: 0 angle, 1 object height, 2/3 image height
                ft = int(t[1])
                field_type = {0: "angle", 1: "object_height"}.get(ft, "angle")
            elif key == "XFLN":
                fields_x = [float(v) for v in t[1:]]
            elif key == "YFLN":
                fields_y = [float(v) for v in t[1:]]
            elif key == "WAVM":
                wavelengths.append((int(t[1]), float(t[2])))
            elif key == "PWAV":
                primary_wav_idx = int(t[1])
            elif key == "SURF":
                cur = {"type": "STANDARD", "curv": 0.0, "disz": 0.0,
                       "conic": 0.0, "parm": {}, "glass": None,
                       "is_stop": False, "mirror": False, "diam": None}
                surfaces[int(t[1])] = cur
            continue

        if cur is None:
            continue
        if key == "TYPE":
            cur["type"] = t[1].upper()
        elif key == "CURV":
            cur["curv"] = _parse_float(t[1])
        elif key == "DISZ":
            cur["disz"] = _parse_float(t[1])
        elif key == "CONI":
            cur["conic"] = _parse_float(t[1])
        elif key == "PARM":
            cur["parm"][int(t[1])] = _parse_float(t[2])
        elif key == "GLAS":
            name = t[1]
            if name.upper() == "MIRROR":
                cur["mirror"] = True
            else:
                nd = float(t[4]) if len(t) > 4 else None
                vd = float(t[5]) if len(t) > 5 else None
                cur["glass"] = (name, nd, vd)
        elif key == "COAT":
            cur["coating"] = t[1] if len(t) > 1 else None
        elif key == "STOP":
            cur["is_stop"] = True
        elif key == "MIRROR":
            cur["mirror"] = True
        elif key == "DIAM":
            cur["diam"] = _parse_float(t[1])

    # drop trailing wavelengths that WAVM lists beyond the used count? The
    # reference uses all WAVM rows with weight > 0; files list exactly the
    # used set. Keep all unique indices in order.
    wavelengths.sort()

    lens = Optic()
    n_surf = max(surfaces) + 1
    has_cb = any(surfaces[i]["type"] == "COORDBRK" for i in surfaces)

    # cumulative coordinate system for COORDBRK chains (reference
    # `fileio/zemax/reader/converter.py` coordinate-break path): rotations/
    # decenters first, then the CB thickness along the rotated z
    import numpy as np
    import torch

    from optiland_tpu_torch.core.transforms import rotation_matrix

    R_cum = np.eye(3)
    t_cum = np.zeros(3)

    def _euler_from_R(R):
        # R = Rz(rz) @ Ry(ry) @ Rx(rx). Use scipy's extrinsic-xyz
        # decomposition — the SAME convention (incl. the gimbal-lock
        # third-angle-to-zero choice at 90-degree folds) as the reference
        # (`coordinate_system.py:182`), so CB chains match exactly.
        import warnings

        from scipy.spatial.transform import Rotation

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rx, ry, rz = Rotation.from_matrix(np.asarray(R)).as_euler("xyz")
        return float(rx), float(ry), float(rz)

    out_idx = 0
    for idx in range(n_surf):
        s = surfaces[idx]

        if s["type"] == "COORDBRK":
            dx = s["parm"].get(1, 0.0)
            dy = s["parm"].get(2, 0.0)
            rx = math.radians(s["parm"].get(3, 0.0))
            ry = math.radians(s["parm"].get(4, 0.0))
            rz = math.radians(s["parm"].get(5, 0.0))
            t_cum = t_cum + R_cum @ np.asarray([dx, dy, 0.0])
            R_cum = R_cum @ rotation_matrix(
                *(torch.tensor(a, dtype=torch.float64) for a in (rx, ry, rz))
            ).numpy()
            t_cum = t_cum + R_cum @ np.asarray([0.0, 0.0, s["disz"]])
            continue

        radius = math.inf if s["curv"] == 0 else 1.0 / s["curv"]
        if s["type"] == "TOROIDAL":
            # Zemax toroidal: CURV = Y-curve, PARM 1 = rotation (X) radius
            # (0 -> flat/cylinder), PARM 2.. = Y-polynomial (reference
            # `fileio/zemax/surfaces.py:376-398`)
            radius = s["parm"].get(1, 0.0) or math.inf
        mat = "air"
        if s["mirror"]:
            mat = "mirror"
        elif s["glass"] is not None:
            name, nd, vd = s["glass"]
            try:
                mat = resolve_material(name)
            except KeyError:
                if nd is not None and vd:
                    mat = abbe_material(nd, vd)
                elif nd is not None and nd > 0:
                    # MODEL glass with V=0: constant-index material (our
                    # writer emits ideal media this way)
                    mat = resolve_material(nd)
                else:
                    raise
        kwargs = {}
        surface_type = "standard"
        if s["type"] in ("EVENASPH", "ODDASPHE"):
            surface_type = ("even_asphere" if s["type"] == "EVENASPH"
                            else "odd_asphere")
            # PARM i is the i-th polynomial coefficient; files (and our
            # writer) may omit zero terms, so gap-fill by index
            pk = s["parm"]
            top = max(pk) if pk else 0
            kwargs["coefficients"] = [pk.get(i, 0.0)
                                      for i in range(1, top + 1)]
        elif s["type"] == "TOROIDAL":
            surface_type = "toroidal"
            ry = math.inf if s["curv"] == 0 else 1.0 / s["curv"]
            poly = [s["parm"].get(k, 0.0) for k in range(2, 10)]
            while poly and poly[-1] == 0.0:
                poly.pop()
            kwargs["radius_y"] = ry
            kwargs["coeffs_poly_y"] = poly
        spec = lens.add_surface(
            index=out_idx, radius=radius, thickness=s["disz"],
            conic=s["conic"], material=mat, is_stop=s["is_stop"],
            surface_type=surface_type, aperture=s["diam"], **kwargs,
        )
        if has_cb and out_idx > 0 and math.isfinite(s["disz"]):
            rx_, ry_, rz_ = _euler_from_R(R_cum)
            spec.abs_cs = (float(t_cum[0]), float(t_cum[1]),
                           float(t_cum[2]), rx_, ry_, rz_)
        out_idx += 1

        if math.isfinite(s["disz"]):
            t_cum = t_cum + R_cum @ np.asarray([0.0, 0.0, s["disz"]])

    if aperture_type is None:
        aperture_type, aperture_value = "EPD", 10.0
    if aperture_type == "float_by_stop":
        stop_diam = next(
            (surfaces[i]["diam"] for i in sorted(surfaces)
             if surfaces[i]["is_stop"] and surfaces[i]["diam"] is not None),
            None)
        if stop_diam is None:
            raise ValueError(
                "Floating stop aperture specified but no stop diameter found")
        aperture_value = stop_diam
    lens.set_aperture(aperture_type, aperture_value)
    del obj_na

    lens.set_field_type(field_type)
    if not fields_y:
        fields_y = [0.0]
        fields_x = [0.0]
    if not fields_x:
        fields_x = [0.0] * len(fields_y)
    for fx, fy in zip(fields_x, fields_y):
        lens.add_field(y=fy, x=fx)

    for j, (widx, wval) in enumerate(wavelengths):
        lens.add_wavelength(wval, is_primary=(widx == primary_wav_idx))
    if primary_wav_idx is None and wavelengths:
        lens.wavelengths.primary_idx = len(wavelengths) // 2

    return lens


# ---------------------------------------------------------------------------
# writer (reference `optiland/fileio/zemax/writer/{formatter,encoder,
# exporter}.py`: Optic -> data model -> text lines -> UTF-16 file)
# ---------------------------------------------------------------------------
_AP_TO_OPERAND = {"EPD": "ENPD", "imageFNO": "FNUM", "objectNA": "OBNA",
                  "float_by_stop": "FLOA"}
_FTYP_INT = {"angle": 0, "object_height": 1, "paraxial_image_height": 2,
             "real_image_height": 3}
_TYPE_TO_ZMX = {"standard": "STANDARD", "plane": "STANDARD",
                "even_asphere": "EVENASPH", "odd_asphere": "ODDASPHE",
                "toroidal": "TOROIDAL"}


def _fmt(v: float) -> str:
    return f"{v:.8E}"


def material_nd_vd(mat) -> tuple[float, float]:
    """(n_d, V_d) of a MaterialSpec, evaluated at the d/F/C lines in
    float64 on the host."""
    import torch

    from optiland_tpu_torch.materials.dispersion import material_index

    w = torch.tensor([0.5875618, 0.4861327, 0.6562725], dtype=torch.float64)
    n = material_index(mat.formula, mat.n_coeffs,
                       torch.tensor(mat.coefficients, dtype=torch.float64), w)
    nd, nF, nC = float(n[0]), float(n[1]), float(n[2])
    vd = (nd - 1.0) / (nF - nC) if abs(nF - nC) > 1e-12 else 0.0
    return nd, vd


def _encode_glas(mat) -> str | None:
    """GLAS line for a SurfaceSpec material; None for air."""
    from optiland_tpu_torch.materials.dispersion import FORMULA_IDEAL

    if mat.mirror:
        return "  GLAS MIRROR 1 0 0 0"
    if mat.formula == FORMULA_IDEAL:
        n = float(mat.coefficients[0])
        if abs(n - 1.0) < 1e-9:
            return None  # air
        return f"  GLAS MODEL 1 0 {n!r} 0.0"
    from optiland_tpu_torch.fileio.codev import _parse_abbe_name

    ab = _parse_abbe_name(mat.name or "")
    if ab is not None:
        return f"  GLAS MODEL 1 0 {ab[0]!r} {ab[1]!r}"
    name = (mat.name or "").split("|")[0]
    # write the glass by name only when the reader will resolve that name
    # back to the identical dispersion (same formula + coefficients)
    try:
        cand = resolve_material(name) if name else None
        known = (cand is not None and cand.formula == mat.formula
                 and cand.coefficients == mat.coefficients)
    except Exception:
        known = False
    if known:
        return f"  GLAS {name.upper()} 1 0 0 0"
    nd, vd = material_nd_vd(mat)
    return f"  GLAS MODEL 1 0 {_fmt(nd)} {_fmt(vd)}"


def save_zemax_file(optic: Optic, path: str) -> None:
    """Write an Optic as a sequential-mode .zmx file (UTF-16, like
    OpticStudio and the reference's exporter)."""
    lines: list[str] = []
    lines.append("VERS 240000 3 0")
    lines.append("MODE SEQ")
    lines.append(f"NAME {optic.name or ''}".rstrip())
    lines.append("NOTE 0")
    lines.append("UNIT MM X W X CM MR CPMM")

    ap_type = optic.aperture_type or "EPD"
    operand = _AP_TO_OPERAND.get(ap_type)
    if operand == "FLOA":
        lines.append("FLOA")
    elif operand == "FNUM":
        lines.append(f"FNUM {_fmt(optic.aperture_value)} 0")
    elif operand == "OBNA":
        lines.append(f"OBNA {_fmt(optic.aperture_value)} 0")
    elif operand:
        lines.append(f"{operand} {_fmt(optic.aperture_value)}")

    xf = list(optic.fields.x)
    yf = list(optic.fields.y)
    n_fields = max(len(yf), 1)
    n_wl = max(optic.wavelengths.num_wavelengths, 1)
    ftyp = _FTYP_INT.get(optic.fields.field_type, 0)
    telecentric = 1 if getattr(optic.fields, "telecentric", False) else 0
    lines.append(f"FTYP {ftyp} {telecentric} {n_fields} {n_wl} 0 0 0")
    lines.append("XFLN " + " ".join(_fmt(v) for v in (xf or [0.0])))
    lines.append("YFLN " + " ".join(_fmt(v) for v in (yf or [0.0])))
    lines.append("FWGN " + " ".join(_fmt(1.0) for _ in (yf or [0.0])))

    wls = list(optic.wavelengths.values_um)
    for i, wv in enumerate(wls or [0.55]):
        lines.append(f"WAVM {i + 1} {_fmt(wv)} 1")
    lines.append(f"PWAV {optic.wavelengths.primary_idx + 1}")

    for idx, s in enumerate(optic.surfaces.specs):
        lines.append(f"SURF {idx}")
        stype = _TYPE_TO_ZMX.get(s.geometry, "STANDARD")
        lines.append(f"  TYPE {stype}")
        if s.is_stop:
            lines.append("  STOP")
        if s.geometry == "toroidal":
            # CURV = Y-curve, PARM 1 = rotation radius, PARM 2.. = Y-poly
            ry = s.geom_params.get("radius_y", math.inf)
            curv = 0.0 if math.isinf(ry) or ry == 0 else 1.0 / ry
            lines.append(f"  CURV {_fmt(curv)}")
        else:
            curv = 0.0 if s.radius in (math.inf, -math.inf) \
                or s.radius == 0 else 1.0 / s.radius
            lines.append(f"  CURV {_fmt(curv)}")
        if math.isinf(s.thickness):
            lines.append("  DISZ INFINITY")
        else:
            lines.append(f"  DISZ {_fmt(s.thickness)}")
        if abs(s.conic) > 1e-16:
            lines.append(f"  CONI {_fmt(s.conic)}")
        glas = _encode_glas(s.material)
        if glas:
            lines.append(glas)
        if s.semi_aperture is not None and not hasattr(s.semi_aperture,
                                                      "contains"):
            lines.append(f"  DIAM {_fmt(float(s.semi_aperture))}")
        if s.geometry == "toroidal":
            if math.isfinite(s.radius) and s.radius != 0:
                lines.append(f"  PARM 1 {_fmt(1.0 * s.radius)}")
            poly = s.geom_params.get("coeffs_poly_y",
                                     list(s.coefficients))
            for i, c in enumerate(poly):
                if abs(c) > 1e-30:
                    lines.append(f"  PARM {i + 2} {_fmt(float(c))}")
        else:
            for i, c in enumerate(s.coefficients):
                if abs(c) > 1e-30:
                    lines.append(f"  PARM {i + 1} {_fmt(float(c))}")

    with open(path, "w", encoding="utf-16") as f:
        f.write("\n".join(lines) + "\n")
