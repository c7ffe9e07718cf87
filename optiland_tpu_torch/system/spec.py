"""System representation: the static/parameter split.

Port of `optiland_tpu/system/spec.py`:
  - `SystemStatic` — hashable structure: geometry codes, material formulas,
    interaction kinds, stop index, field/aperture types.
  - `SystemParams` — a dataclass of tensors: curvatures, conics,
    coefficients, thicknesses, tilts/decenters, material coefficients,
    field/wavelength tables. Autograd differentiates merits through it.

`build_system` compiles a list of `SurfaceSpec`s for the ported surface
types (every geometry of the JAX package, NURBS's fit of a conic by a
host least-squares in float64 among them; refract, reflect, none, the
ideal thin lens, gratings and phase sheets of the five profile kinds),
every coating kind (simple, Fresnel, the polarizers, retarders and
diattenuators, thin-film stacks in `SystemStatic.thin_films`), BSDFs,
absorbing media (the tabulated extinction tables `k_wl`, `k_val`),
aperture masks (`system/apertures.py`), apodization, object-space
telecentricity and absolute coordinate systems (`SurfaceSpec.abs_cs`,
`cs_pos`). `static_from_dict` and `params_from_numpy` carry a system built
by the JAX package across, so both packages can run on the same tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.config import resolve_device
from optiland_tpu_torch.geometry.surfaces import (
    GEOM_BICONIC,
    GEOM_CHEBYSHEV,
    GEOM_CONIC,
    GEOM_EVEN_ASPHERE,
    GEOM_FORBES_Q2D,
    GEOM_FORBES_QBFS,
    GEOM_GRID_SAG,
    GEOM_NURBS,
    GEOM_ODD_ASPHERE,
    GEOM_PLANE,
    GEOM_POLYNOMIAL_XY,
    GEOM_TOROIDAL,
    GEOM_ZERNIKE,
    ZERNIKE_TYPE_CODES,
)
from optiland_tpu_torch.materials.catalog import (
    AIR,
    MaterialSpec,
    resolve_material,
)
from optiland_tpu_torch.materials.dispersion import MAX_COEFFS

# interaction kinds (static per surface)
INT_REFRACT = 0
INT_REFLECT = 1
INT_THIN_LENS = 2
INT_NONE = 3  # object/image surfaces: record only
INT_DIFFRACT = 4
INT_PHASE = 5

# phase profile kinds (static per surface)
PHASE_NONE = 0
PHASE_CONSTANT = 1
PHASE_RADIAL = 2
PHASE_LINEAR_GRATING = 3
PHASE_GRID = 4
PHASE_HEIGHT = 5

# coating kinds (static per surface; params in SystemParams.coating_params)
COAT_NONE = 0
COAT_SIMPLE = 1        # params: [transmittance, reflectance]
COAT_FRESNEL = 2
COAT_POLARIZER_H = 3
COAT_POLARIZER_V = 4
COAT_POLARIZER_RCP = 5
COAT_POLARIZER_LCP = 6
COAT_RETARDER = 7
COAT_DIATTENUATOR = 8
COAT_LINEAR_POLARIZER = 9
COAT_THIN_FILM = 10

_COATING_BY_NAME = {
    None: COAT_NONE,
    "fresnel": COAT_FRESNEL,
    "polarizer_h": COAT_POLARIZER_H,
    "polarizer_v": COAT_POLARIZER_V,
    "polarizer_rcp": COAT_POLARIZER_RCP,
    "polarizer_lcp": COAT_POLARIZER_LCP,
}

_GEOM_BY_TYPE = {
    "standard": GEOM_CONIC,
    "plane": GEOM_PLANE,
    "even_asphere": GEOM_EVEN_ASPHERE,
    "odd_asphere": GEOM_ODD_ASPHERE,
    "polynomial": GEOM_POLYNOMIAL_XY,
    "biconic": GEOM_BICONIC,
    "toroidal": GEOM_TOROIDAL,
    "chebyshev": GEOM_CHEBYSHEV,
    "zernike": GEOM_ZERNIKE,
    "forbes_qbfs": GEOM_FORBES_QBFS,
    "forbes_q2d": GEOM_FORBES_Q2D,
    "grid_sag": GEOM_GRID_SAG,
    "nurbs": GEOM_NURBS,
}

_INF = float("inf")

MAX_GEOM_COEFFS = 17


@dataclass
class SurfaceSpec:
    """Host-side description of one surface (builder output)."""

    radius: float = _INF
    thickness: float = 0.0
    conic: float = 0.0
    coefficients: tuple[float, ...] = ()
    material: MaterialSpec = AIR  # medium *after* this surface
    geometry: str = "standard"
    surface_type: str = "standard"  # "standard" | "paraxial" | "grating"
    is_stop: bool = False
    # physical aperture: None = open, a float = radial semi-aperture (in
    # SystemParams.ap_radius, differentiable), or a BaseAperture mask
    # (`system/apertures.py`, a structural predicate)
    semi_aperture: object = None
    dx: float = 0.0
    dy: float = 0.0
    rx: float = 0.0
    ry: float = 0.0
    rz: float = 0.0
    focal_length: float = 0.0  # thin-lens surfaces only
    abs_cs: tuple | None = None  # absolute (x, y, z, rx, ry, rz) placement
    # None | name str | (kind, *params) tuple | ThinFilmStack
    coating: object = None
    bsdf: object = None  # None | LambertianBSDF | GaussianBSDF
    # a grating's grating_order, grating_period (um) and
    # groove_orientation_angle (rad)
    geom_params: dict = field(default_factory=dict)
    comment: str = ""


@dataclass(frozen=True)
class SystemStatic:
    """Hashable structural description of the optical system (the same
    fields as the JAX package's, so its systems carry across)."""

    num_surfaces: int
    geom_codes: tuple[int, ...]
    geom_n_coeffs: tuple[int, ...]
    interactions: tuple[int, ...]
    is_reflective: tuple[bool, ...]
    coatings: tuple[int, ...]
    bsdfs: tuple
    phase_kinds: tuple[int, ...]
    geom_aux: tuple[tuple, ...]
    mat_formulas: tuple[int, ...]
    mat_n_coeffs: tuple[int, ...]
    has_absorption: tuple[bool, ...]
    has_tilt: tuple[bool, ...]
    has_decenter: tuple[bool, ...]
    has_aperture: tuple[bool, ...]
    stop_index: int
    object_infinite: bool
    has_abs_cs: bool
    field_type: str
    aperture_type: str
    num_fields: int
    num_wavelengths: int
    primary_wavelength_idx: int
    apodization: object = None
    newton_iters: int = 16
    telecentric: bool = False
    aperture_masks: tuple = ()
    thin_films: tuple = ()
    has_vignetting: bool = False
    phase_aux: tuple = ()
    phase_interp: str = "cubic"
    # True iff every asphere's conic-seeded capped f32 Newton lands within
    # f32 round-off of the converged f64 root (`_fused_newton_seed_ok`);
    # the fused kernels refuse the system otherwise
    fused_newton_ok: bool = True

    @property
    def surface_indices(self):
        return range(self.num_surfaces)


@dataclass(frozen=True)
class SystemParams:
    """Differentiable system parameters (tensors).

    Per-surface tensors have shape (S,) or (S, K); field/wavelength tables
    are (F,) / (W,). `thickness[k]` is the gap after surface k.
    """

    cv: torch.Tensor
    conic: torch.Tensor
    coeffs: torch.Tensor  # (S, MAX_GEOM_COEFFS)
    thickness: torch.Tensor
    tilt: torch.Tensor  # (S, 3) rx, ry, rz
    decenter: torch.Tensor  # (S, 2) dx, dy
    focal_length: torch.Tensor
    mat_coeffs: torch.Tensor  # (S, MAX_COEFFS)
    k_wl: torch.Tensor
    k_val: torch.Tensor
    ap_radius: torch.Tensor  # (S,) physical semi-aperture (inf = open)
    grating: torch.Tensor
    coating_params: torch.Tensor  # (S, 4)
    phase_params: torch.Tensor
    cs_pos: torch.Tensor
    aperture_value: torch.Tensor
    x_fields: torch.Tensor
    y_fields: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    wavelengths: torch.Tensor
    phase_grids: torch.Tensor | None = None
    phase_mat_coeffs: torch.Tensor | None = None

    def positions(self) -> torch.Tensor:
        """Vertex z positions (S,), with pos[1] = 0 and pos[0] =
        -thickness[0] (-inf for an infinite object)."""
        t = self.thickness
        return torch.cat([-t[:1], torch.zeros(1, dtype=t.dtype, device=t.device),
                          torch.cumsum(t[1:-1], 0)])

    def replace(self, **kw) -> "SystemParams":
        return replace(self, **kw)


def positions_of(static, params) -> torch.Tensor:
    """Vertex z positions: the thickness cumsum, or the stored absolute CS
    z for folded systems."""
    if static.has_abs_cs:
        return params.cs_pos[:, 2]
    return params.positions()


def _port_stack(stack):
    """The port's `ThinFilmStack` of a JAX-package stack: the same media
    and layers, each material rebuilt field by field and each thickness
    carried as a float."""
    from optiland_tpu_torch.thin_film.stack import ThinFilmStack

    new = ThinFilmStack(_port_object(stack.incident_material),
                        _port_object(stack.substrate_material))
    for lay in stack.layers:
        new.add_layer(_port_object(lay.material),
                      float(np.asarray(lay.thickness_um)))
    return new


def _port_object(obj):
    """The port's counterpart of a JAX-package object that a system
    carries: an aperture mask, an apodization, a BSDF, a polarization
    state or a material, rebuilt field by field from its class name (the
    classes share names and fields), or a thin-film stack
    (`_port_stack`); None stays None."""
    if obj is None:
        return None
    from optiland_tpu_torch.core import apodization as apod
    from optiland_tpu_torch.core import scatter
    from optiland_tpu_torch.materials.catalog import MaterialSpec
    from optiland_tpu_torch.polarization.state import PolarizationState
    from optiland_tpu_torch.system import apertures as aps

    name = type(obj).__name__
    if name == "ThinFilmStack":
        return _port_stack(obj)
    if name == "LambertianBSDF":
        return scatter.LambertianBSDF()
    if name == "GaussianBSDF":
        return scatter.GaussianBSDF(obj.sigma)
    if name in ("PolarizationState", "MaterialSpec"):
        cls = PolarizationState if name == "PolarizationState" else MaterialSpec
        return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})
    cls = getattr(aps, name, None) or getattr(apod, name, None)
    if not isinstance(cls, type) or not issubclass(
            cls, (aps.BaseAperture, apod.BaseApodization)):
        raise NotImplementedError(
            f"{name} has no counterpart in the port")
    kw = {k: _port_object(v) if hasattr(v, "__dict__") else v
          for k, v in vars(obj).items()}
    return cls(**kw)


def static_from_dict(d: dict) -> SystemStatic:
    """A `SystemStatic` from the JAX package's `SystemStatic` fields, keyed
    by field name. Its aperture masks, apodization, BSDFs and thin-film
    stacks become the port's objects of the same class and fields
    (`_port_object`)."""
    names = {f.name for f in fields(SystemStatic)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SystemStatic fields {sorted(unknown)}")
    d = dict(d)
    for key in ("bsdfs", "thin_films"):
        d[key] = tuple(_port_object(b) for b in d.get(key, ()))
    d["aperture_masks"] = tuple(_port_object(m)
                                for m in d.get("aperture_masks", ()))
    d["apodization"] = _port_object(d.get("apodization"))
    return SystemStatic(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in d.items()})


def params_from_numpy(arrays: dict, device, dtype=None) -> SystemParams:
    """A `SystemParams` from numpy arrays keyed by field name (the JAX
    package's `SystemParams` leaves), on `device` in `dtype`."""
    dev = resolve_device(device)
    dtype = dtype or config.get_dtype()
    kw = {}
    for f in fields(SystemParams):
        a = arrays.get(f.name)
        kw[f.name] = (None if a is None else
                      torch.as_tensor(np.array(a), dtype=dtype, device=dev))
    return SystemParams(**kw)


def _safe_cv(r: float) -> float:
    return 0.0 if (r in (_INF, -_INF) or r == 0) else 1.0 / r


def _fused_newton_seed_ok(code, cvk, conic_k, coeffs, r_max) -> bool:
    """Measure, on the host at build time, whether the fused kernel's capped
    Newton converges for this asphere: the kernel's exact intersection path
    in float32 (closed-form conic seed, then 2+1 Newton steps) on a fan of
    oblique rays over the clear aperture, against a 48-iteration float64
    Newton. False when the capped root misses by more than ~1e-4 of the
    aperture scale."""
    n_c = len(coeffs)
    kk = 1.0 + conic_k

    def sag_grad(x, dtype):
        x = x.astype(dtype)
        r2 = x * x
        m = np.maximum(1.0 - kk * cvk * cvk * r2, 1e-12)
        root = np.sqrt(m)
        s_val = cvk * r2 / (1.0 + root)
        g = cvk / root
        if code == GEOM_EVEN_ASPHERE:
            rp = r2.copy()
            rp0 = np.ones_like(r2)
            for ci in range(n_c):
                s_val = s_val + coeffs[ci] * rp
                g = g + 2.0 * (ci + 1) * coeffs[ci] * rp0
                rp = rp * r2
                rp0 = rp0 * r2
            return s_val, x * g
        r = np.sqrt(np.maximum(r2, 1e-12))
        godd = np.zeros_like(r)
        rpow = r.copy()
        rpow0 = np.ones_like(r)
        for ci in range(n_c):
            s_val = s_val + coeffs[ci] * rpow
            godd = godd + (ci + 1) * coeffs[ci] * rpow0
            rpow = rpow * r
            rpow0 = rpow0 * r
        return s_val, x * g + (x / r) * godd

    heights = np.linspace(-r_max, r_max, 17)
    angles = np.deg2rad(np.linspace(-35.0, 35.0, 9))
    X0, A = [a.ravel() for a in np.meshgrid(heights, angles)]
    L = np.sin(A)
    N = np.cos(A)
    z0 = -(abs(float(sag_grad(np.asarray([r_max]), np.float64)[0][0])) + 1.0)
    z = np.full_like(X0, z0)

    def newton(t, iters, dtype):
        t = t.astype(dtype)
        for _ in range(iters):
            xt = (X0 + t * L).astype(dtype)
            zt = (z + t * N).astype(dtype)
            s_val, gx = sag_grad(xt, dtype)
            f = s_val - zt
            fp = gx * L - N
            fp = np.where(np.abs(fp) > 1e-12, fp, 1e-12)
            t = (t - f / fp).astype(dtype)
        return t

    Aq = cvk * (L * L + kk * N * N)
    Bq = 2.0 * (cvk * (L * X0 + kk * N * z) - N)
    Cq = cvk * (X0 * X0 + kk * z * z) - 2.0 * z
    disc = np.maximum(Bq * Bq - 4.0 * Aq * Cq, 0.0)
    sq = np.sqrt(disc)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-Bq + sq) / (2.0 * Aq)
        t2 = (-Bq - sq) / (2.0 * Aq)
        tq = np.where(np.abs(z + t1 * N) <= np.abs(z + t2 * N), t1, t2)
        seed = np.where(np.abs(Aq) > 1e-12, tq, -Cq / np.where(
            np.abs(Bq) > 1e-12, Bq, 1e-12))
    t_fused = newton(seed.astype(np.float32), 3, np.float32)
    t_true = newton(seed, 48, np.float64)
    ok = np.isfinite(t_true)
    if not ok.any():
        return True
    err = np.abs(t_fused.astype(np.float64) - t_true)[ok]
    return bool(np.max(err) <= 1e-4 * max(1.0, r_max))


_PHASE_KINDS = {"constant": PHASE_CONSTANT, "radial": PHASE_RADIAL,
                "linear_grating": PHASE_LINEAR_GRATING, "grid": PHASE_GRID,
                "height_profile": PHASE_HEIGHT}


def _pack_phase(profile, idx, kinds, aux, params, grids, mat_coeffs):
    """Pack the phase profile of surface idx as the JAX package does:
    ("constant", v), ("radial", [c1, c2, ...]) (the coefficients of r^2,
    r^4, ... in slots 0..n-1), ("linear_grating", kx, ky), ("grid", xs,
    ys, grid) or ("height_profile", xs, ys, h, material). A tabulated
    profile keeps its bounds (xmin, xmax, ymin, ymax) in slots 0-3, its
    (len(ys), len(xs)) table in `grids` and, for a height profile, its
    material's codes in `aux` and coefficients in `mat_coeffs`; its axes
    must be uniformly spaced."""
    kind_name, *pvals = profile
    if kind_name not in _PHASE_KINDS:
        raise ValueError(f"unknown phase profile {kind_name!r}; expected one "
                         f"of {', '.join(_PHASE_KINDS)}")
    kinds[idx] = _PHASE_KINDS[kind_name]
    if kind_name == "radial":
        pvals = list(pvals[0])
    if kind_name not in ("grid", "height_profile"):
        params[idx, : len(pvals)] = pvals
        return
    xs = np.asarray(pvals[0], float)
    ys = np.asarray(pvals[1], float)
    gr = np.asarray(pvals[2], float)
    if gr.shape != (len(ys), len(xs)):
        raise ValueError("phase grid must have shape (len(y), len(x))")
    for ax in (xs, ys):
        d = np.diff(ax)
        if len(d) and not np.allclose(d, d[0], rtol=1e-6):
            raise ValueError("phase grid axes must be uniformly spaced")
    params[idx, :4] = (xs[0], xs[-1], ys[0], ys[-1])
    grids[idx] = gr
    if kind_name == "height_profile":
        mat = resolve_material(pvals[3])
        aux[idx] = ("height", gr.shape[0], gr.shape[1], mat.formula,
                    mat.n_coeffs)
        mat_coeffs[idx, : mat.n_coeffs] = mat.coefficients
    else:
        aux[idx] = ("grid", gr.shape[0], gr.shape[1])


def _forbes_norm_radius(gp: dict, s: SurfaceSpec) -> float:
    """The manual norm radius, else the reference's rule 1.25 x the
    semi-aperture, else 1."""
    nr = gp.get("norm_radius")
    if nr is not None:
        return float(nr)
    if s.semi_aperture is not None and not hasattr(s.semi_aperture,
                                                    "contains"):
        return 1.25 * float(s.semi_aperture)
    return 1.0


def _pack_geometry(s: SurfaceSpec):
    """Resolve one SurfaceSpec's geometry to (code, cv, k, coeffs, aux), the
    layouts of `geometry/surfaces.py` (its module docstring)."""
    if s.geometry not in _GEOM_BY_TYPE:
        raise ValueError(f"Unknown geometry {s.geometry!r}")
    geom = _GEOM_BY_TYPE[s.geometry]
    gp = s.geom_params
    if geom == GEOM_CONIC and _safe_cv(s.radius) == 0.0:
        geom = GEOM_PLANE
    if geom in (GEOM_PLANE, GEOM_CONIC, GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE,
                GEOM_POLYNOMIAL_XY):
        return geom, _safe_cv(s.radius), s.conic, list(s.coefficients), ()
    if geom == GEOM_BICONIC:
        return (geom, _safe_cv(s.radius), s.conic,
                [_safe_cv(gp.get("radius_y", _INF)), gp.get("conic_y", 0.0)],
                ())
    if geom == GEOM_TOROIDAL:
        # (cv, k) = Y-Z curve; s.radius is the rotation radius R_rot
        poly = list(gp.get("coeffs_poly_y", s.coefficients))
        return (geom, _safe_cv(gp.get("radius_y", _INF)), s.conic,
                [_safe_cv(s.radius)] + poly, ())
    if geom == GEOM_CHEBYSHEV:
        C = np.atleast_2d(np.asarray(gp.get("coefficients", s.coefficients),
                                     float))
        rows, cols = C.shape
        return (geom, _safe_cv(s.radius), s.conic,
                [gp.get("norm_x", 1.0), gp.get("norm_y", 1.0)]
                + list(C.ravel()), (rows, cols))
    if geom == GEOM_ZERNIKE:
        zt = gp.get("zernike_type", "standard")
        return (geom, _safe_cv(s.radius), s.conic,
                [gp.get("norm_radius", 1.0)] + list(s.coefficients),
                (ZERNIKE_TYPE_CODES[zt],))
    if geom == GEOM_FORBES_QBFS:
        # radial_terms: {n: a_n}
        terms = dict(gp.get("radial_terms", enumerate(s.coefficients)))
        n_top = max(terms.keys(), default=-1)
        a = [float(terms.get(n, 0.0)) for n in range(n_top + 1)]
        return (geom, _safe_cv(s.radius), s.conic,
                [_forbes_norm_radius(gp, s)] + a, ())
    if geom == GEOM_FORBES_Q2D:
        # freeform_coeffs: {('a'|'b', m, n): c}, sorted by (n, |m|, cos
        # before sin)
        items = []
        for (kind, m, n), val in gp.get("freeform_coeffs", {}).items():
            cos = kind.lower() == "a"
            items.append(((n, abs(m), 0 if cos else 1),
                          (n, m if cos else -m), float(val)))
        items.sort(key=lambda it: it[0])
        return (geom, _safe_cv(s.radius), s.conic,
                [_forbes_norm_radius(gp, s)] + [it[2] for it in items],
                tuple(it[1] for it in items))
    if geom == GEOM_GRID_SAG:
        xg = list(np.asarray(gp["x_coordinates"], float))
        yg = list(np.asarray(gp["y_coordinates"], float))
        zg = np.asarray(gp["sag_values"], float)
        if zg.shape != (len(yg), len(xg)):
            raise ValueError(
                f"sag_values shape {zg.shape} must be (ny, nx) = "
                f"({len(yg)}, {len(xg)})")
        return geom, 0.0, 0.0, xg + yg + list(zg.ravel()), (len(xg), len(yg))
    return _pack_nurbs(s, gp)


def _pack_nurbs(s: SurfaceSpec, gp: dict):
    """Pack a NURBS surface (the layout of `geometry/surfaces.py`, cv and k
    0): an explicit control net (`control_points` (3, nu, nv), `weights`,
    `u_knots`, `v_knots`, `u_degree`, `v_degree`; clamped uniform knots and
    cubic degrees by default), its box the net's (x, y) extent; or a host
    least-squares fit (`nurbs.fit_nurbs_to_sag`) of the surface's conic
    (`radius`, `conic`) over the box of half-widths `nurbs_norm_x`,
    `nurbs_norm_y` about (`x_center`, `y_center`), `n_points_u` by
    `n_points_v` control points (4 by 4), in float64 whatever the
    system's dtype."""
    from optiland_tpu_torch.geometry import nurbs as _nb
    from optiland_tpu_torch.geometry.surfaces import _conic_sag

    if gp.get("control_points") is not None:
        P = np.asarray(gp["control_points"], float)  # (3, nu, nv)
        _, nu, nv = P.shape
        p = int(gp.get("u_degree", 3))
        q = int(gp.get("v_degree", 3))
        W = np.asarray(gp.get("weights", np.ones((nu, nv))), float)
        U = np.asarray(gp.get("u_knots", _nb.clamped_uniform_knots(nu, p)),
                       float)
        V = np.asarray(gp.get("v_knots", _nb.clamped_uniform_knots(nv, q)),
                       float)
        Px, Py, Pz = P[0], P[1], P[2]
        box = (float(Px.min()), float(Px.max()),
               float(Py.min()), float(Py.max()))
    else:
        nu = int(gp.get("n_points_u", 4))
        nv = int(gp.get("n_points_v", 4))
        p = int(gp.get("u_degree", min(3, nu - 1)))
        q = int(gp.get("v_degree", min(3, nv - 1)))
        norm_x = float(gp.get("nurbs_norm_x") or 1.0)
        norm_y = float(gp.get("nurbs_norm_y") or 1.0)
        xc = float(gp.get("x_center", 0.0))
        yc = float(gp.get("y_center", 0.0))
        cv, k = _safe_cv(s.radius), s.conic

        def sag_np(X, Y):
            return _conic_sag(torch.from_numpy(X), torch.from_numpy(Y), cv,
                              k).numpy()

        box = (xc - norm_x, xc + norm_x, yc - norm_y, yc + norm_y)
        U, V, W, Px, Py, Pz = _nb.fit_nurbs_to_sag(sag_np, *box, nu, nv,
                                                   p=p, q=q)
    coeffs = (list(U) + list(V) + list(np.asarray(W).ravel())
              + list(np.asarray(Px).ravel()) + list(np.asarray(Py).ravel())
              + list(np.asarray(Pz).ravel()))
    return GEOM_NURBS, 0.0, 0.0, coeffs, (p, q, nu, nv) + tuple(box)


def _coating_code(coat):
    """(code, parameters, thin-film stack or None) of a surface's coating:
    None or a name ("fresnel", "polarizer_h", ...), a (kind, *params)
    tuple ("simple" T R, "retarder" retardance theta, "diattenuator" t_min
    t_max theta, "linear_polarizer" theta), or a `ThinFilmStack` (also as
    ("thin_film", stack))."""
    from optiland_tpu_torch.thin_film.stack import ThinFilmStack

    if isinstance(coat, tuple) and len(coat) == 2 and coat[0] == "thin_film":
        coat = coat[1]
    if isinstance(coat, ThinFilmStack):
        return COAT_THIN_FILM, (), coat
    if coat is None or isinstance(coat, str):
        return _COATING_BY_NAME[coat], (), None
    kind, *cp = coat
    code = {
        "simple": COAT_SIMPLE,
        "retarder": COAT_RETARDER,
        "diattenuator": COAT_DIATTENUATOR,
        "linear_polarizer": COAT_LINEAR_POLARIZER,
    }[kind]
    return code, tuple(cp), None


def build_system(
    surfaces: list[SurfaceSpec],
    *,
    field_type: str,
    x_fields,
    y_fields,
    vx,
    vy,
    aperture_type: str,
    aperture_value: float,
    wavelengths,
    primary_wavelength_idx: int,
    apodization=None,
    newton_iters: int = 16,
    telecentric: bool = False,
    phase_interp: str = "cubic",
    dtype=None,
    device=None,
) -> tuple[SystemStatic, SystemParams]:
    """Compile builder state into the (static, params) pair, with the
    parameter tensors on `device` (None means the CUDA card).
    `phase_interp` is the interpolation order of grid and height-profile
    phase sheets: "cubic" (the bicubic spline) or "linear". A telecentric
    object space takes object-height or image-height fields and an
    objectNA or float_by_stop aperture (reference
    `rays/ray_aiming/paraxial.py:108-117`)."""
    if telecentric:
        if field_type == "angle":
            raise ValueError(
                'Field type cannot be "angle" for telecentric object space.')
        if aperture_type not in ("objectNA", "float_by_stop"):
            raise ValueError(
                f"Aperture type {aperture_type!r} is not compatible with "
                f"telecentric object space.")
    dev = resolve_device(device)
    dtype = dtype or config.get_dtype()
    S = len(surfaces)
    if S < 3:
        raise ValueError("A system needs at least object, one surface, image.")

    packed = [_pack_geometry(s) for s in surfaces]
    coeff_width = max([MAX_GEOM_COEFFS] + [len(p[3]) for p in packed])

    geom_codes, geom_n_coeffs, interactions, is_reflective = [], [], [], []
    geom_aux = []
    coatings, mat_formulas, mat_n_coeffs = [], [], []
    thin_films, bsdfs = [], []
    has_tilt, has_decenter, has_aperture = [], [], []
    aperture_masks = []
    stop_index = 0

    cv = np.zeros(S)
    conic = np.zeros(S)
    coeffs = np.zeros((S, coeff_width))
    thickness = np.zeros(S)
    tilt = np.zeros((S, 3))
    decenter = np.zeros((S, 2))
    mat_w = max([MAX_COEFFS] + [s.material.n_coeffs for s in surfaces])
    mat_coeffs = np.zeros((S, mat_w))
    KMAX = max((len(s.material.k_table[0]) for s in surfaces
                if s.material.k_table is not None), default=1)
    k_wl = np.ones((S, KMAX))
    k_val = np.zeros((S, KMAX))
    has_absorption = []
    ap_radius = np.full(S, np.inf)
    coating_params = np.zeros((S, 4))
    focal_length = np.zeros(S)
    grating = np.zeros((S, 3))
    phase_kinds = [PHASE_NONE] * S
    phase_aux = [None] * S
    phase_params = np.zeros((S, 8))
    phase_grid_list = [None] * S
    phase_mat_coeffs = np.zeros((S, MAX_COEFFS))
    cs_pos = np.zeros((S, 3))
    has_abs_cs = any(s.abs_cs is not None for s in surfaces)

    current_medium = AIR
    for idx, s in enumerate(surfaces):
        if s.surface_type not in ("standard", "paraxial", "grating", "phase"):
            raise ValueError(
                f"Unknown surface_type {s.surface_type!r}; expected standard, "
                "paraxial, grating or phase")
        mat = s.material
        reflective = mat.mirror
        if not reflective:
            current_medium = mat
        is_reflective.append(bool(reflective))

        geom, cv_val, k_val_, packed_coeffs, aux = packed[idx]
        geom_codes.append(geom)
        geom_aux.append(aux)
        geom_n_coeffs.append(len(packed_coeffs))

        if idx == 0 or idx == S - 1:
            interactions.append(INT_NONE)
        elif s.surface_type == "paraxial":
            interactions.append(INT_THIN_LENS)
        elif s.surface_type == "grating":
            interactions.append(INT_DIFFRACT)
            gp = s.geom_params
            grating[idx] = (gp.get("grating_order", 1),
                            gp.get("grating_period", 1.0),
                            gp.get("groove_orientation_angle", 0.0))
        elif s.surface_type == "phase":
            interactions.append(INT_PHASE)
            _pack_phase(s.geom_params.get("phase_profile", ("constant", 0.0)),
                        idx, phase_kinds, phase_aux, phase_params,
                        phase_grid_list, phase_mat_coeffs)
        elif reflective:
            interactions.append(INT_REFLECT)
        else:
            interactions.append(INT_REFRACT)

        mat_formulas.append(current_medium.formula)
        mat_n_coeffs.append(current_medium.n_coeffs)
        mat_coeffs[idx, : current_medium.n_coeffs] = current_medium.coefficients
        kt = current_medium.k_table
        has_absorption.append(kt is not None and any(v > 0 for v in kt[1]))
        if kt is not None:
            nk = len(kt[0])
            k_wl[idx, :nk] = kt[0]
            k_val[idx, :nk] = kt[1]
            # pad by repeating the last point; interp clamps at the edges
            k_wl[idx, nk:] = kt[0][-1]
            k_val[idx, nk:] = kt[1][-1]

        if s.abs_cs is not None:
            # an absolute placement: its position in cs_pos, its rotation
            # in tilt; an x or y offset takes the tilted frame's transform
            ax_, ay_, az_, arx, ary, arz = s.abs_cs
            cs_pos[idx] = (ax_, ay_, az_)
            tilt[idx] = (arx, ary, arz)
            has_tilt.append(bool(arx or ary or arz or ax_ or ay_))
        else:
            has_tilt.append(bool(s.rx or s.ry or s.rz))
            tilt[idx] = (s.rx, s.ry, s.rz)
        has_decenter.append(bool(s.dx or s.dy))
        has_aperture.append(s.semi_aperture is not None)
        aperture_masks.append(
            s.semi_aperture if hasattr(s.semi_aperture, "contains") else None)

        code, cp, stack = _coating_code(s.coating)
        coatings.append(code)
        coating_params[idx, : len(cp)] = cp
        thin_films.append(stack)
        bsdfs.append(s.bsdf)

        if s.is_stop:
            stop_index = idx

        cv[idx] = cv_val
        conic[idx] = k_val_
        if packed_coeffs:
            coeffs[idx, : len(packed_coeffs)] = packed_coeffs
        thickness[idx] = s.thickness
        decenter[idx] = (s.dx, s.dy)
        focal_length[idx] = s.focal_length
        if s.semi_aperture is not None and aperture_masks[idx] is None:
            ap_radius[idx] = s.semi_aperture

    if stop_index == 0:
        stop_index = 1

    object_infinite = not np.isfinite(surfaces[0].thickness)
    if object_infinite:
        thickness[0] = np.inf
    if has_abs_cs:
        # the other surfaces' cs z from the thickness chain, restarted at
        # each absolutely placed surface
        z = 0.0
        for idx, s in enumerate(surfaces):
            if idx == 0:
                cs_pos[idx, 2] = -thickness[0]
                continue
            if s.abs_cs is None:
                cs_pos[idx, 2] = z
            else:
                z = cs_pos[idx, 2]
            z += thickness[idx] if np.isfinite(thickness[idx]) else 0.0

    fused_newton_ok = True
    for idx in range(S):
        if (geom_codes[idx] in (GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE)
                and geom_n_coeffs[idx]):
            if np.isfinite(ap_radius[idx]):
                r_max = float(ap_radius[idx])
            elif aperture_type == "EPD":
                r_max = 0.75 * float(aperture_value)
            else:
                r_max = 10.0
            cvk = float(cv[idx])
            kk = 1.0 + float(conic[idx])
            if cvk != 0.0 and kk > 0.0:
                r_max = min(r_max, 0.9 / (abs(cvk) * np.sqrt(kk)))
            if not _fused_newton_seed_ok(
                    geom_codes[idx], cvk, float(conic[idx]),
                    [float(c) for c in coeffs[idx][:geom_n_coeffs[idx]]],
                    r_max):
                fused_newton_ok = False
                break

    static = SystemStatic(
        num_surfaces=S,
        geom_codes=tuple(geom_codes),
        geom_n_coeffs=tuple(geom_n_coeffs),
        geom_aux=tuple(geom_aux),
        interactions=tuple(interactions),
        is_reflective=tuple(is_reflective),
        coatings=tuple(coatings),
        bsdfs=tuple(bsdfs),
        phase_kinds=tuple(phase_kinds),
        mat_formulas=tuple(mat_formulas),
        mat_n_coeffs=tuple(mat_n_coeffs),
        has_absorption=tuple(has_absorption),
        has_tilt=tuple(has_tilt),
        has_decenter=tuple(has_decenter),
        has_aperture=tuple(has_aperture),
        stop_index=stop_index,
        object_infinite=object_infinite,
        has_abs_cs=has_abs_cs,
        field_type=field_type,
        aperture_type=aperture_type,
        num_fields=len(x_fields),
        num_wavelengths=len(wavelengths),
        primary_wavelength_idx=primary_wavelength_idx,
        apodization=apodization,
        newton_iters=newton_iters,
        telecentric=telecentric,
        aperture_masks=tuple(aperture_masks),
        thin_films=tuple(thin_films),
        has_vignetting=any(float(v) != 0.0 for v in list(vx) + list(vy)),
        phase_aux=tuple(phase_aux),
        phase_interp=phase_interp,
        fused_newton_ok=fused_newton_ok,
    )
    gy_max = max([0] + [g.shape[0] for g in phase_grid_list if g is not None])
    gx_max = max([0] + [g.shape[1] for g in phase_grid_list if g is not None])
    phase_grids = np.zeros((S, gy_max, gx_max))
    for k, g in enumerate(phase_grid_list):
        if g is not None:
            phase_grids[k, : g.shape[0], : g.shape[1]] = g

    def t(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)

    params = SystemParams(
        cv=t(cv), conic=t(conic), coeffs=t(coeffs), thickness=t(thickness),
        tilt=t(tilt), decenter=t(decenter), focal_length=t(focal_length),
        mat_coeffs=t(mat_coeffs), k_wl=t(k_wl),
        k_val=t(k_val), ap_radius=t(ap_radius),
        grating=t(grating), coating_params=t(coating_params),
        phase_params=t(phase_params), cs_pos=t(cs_pos),
        aperture_value=t(aperture_value), x_fields=t(x_fields),
        y_fields=t(y_fields), vx=t(vx), vy=t(vy), wavelengths=t(wavelengths),
        phase_grids=t(phase_grids),
        phase_mat_coeffs=t(phase_mat_coeffs),
    )
    return static, params
