"""The `Optic` builder: the prescription API of `optiland_tpu/system/optic.py`.

`build(device=...)` compiles the description to a `(SystemStatic,
SystemParams)` pair with the parameter tensors on that device; without
`device=` it builds on the CUDA card. `trace` and `trace_generic` trace
a pupil distribution or explicit coordinates on that device, aimed as
`set_ray_aiming` says, and return the (S, N) `TraceHistory` (on the card
in float32: kernel K7). The editing API (the setters, `scale_system`,
`flip`, `+`, `update_params`, pickups and solves) edits the description
or installs new parameters, as the JAX package's does. `info`, `draw` and
`draw3D` render through `visualization/` (`draw` and `draw3D` trace on
the card unless `device="cpu"`), `to_dict` and `from_dict` through
`fileio/`, in the reference's JSON schema. `set_polarization` makes
`trace` and `trace_generic` polarized traces (PRT matrices through every
coating).
"""

from __future__ import annotations

import copy
import hashlib
import math
from dataclasses import fields

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.core import distributions as dist
from optiland_tpu_torch.materials.catalog import resolve_material
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.system.spec import SurfaceSpec, build_system


# the geometry surface types and the keywords each takes
_GEOMETRY_KEYS = {
    "even_asphere": set(),
    "odd_asphere": set(),
    "polynomial": set(),
    "biconic": {"radius_y", "conic_y"},
    "toroidal": {"radius_y", "coeffs_poly_y"},
    "chebyshev": {"coefficients", "norm_x", "norm_y"},
    "zernike": {"norm_radius", "zernike_type"},
    "forbes_qbfs": {"norm_radius", "radial_terms"},
    "forbes_q2d": {"norm_radius", "freeform_coeffs"},
    "grid_sag": {"x_coordinates", "y_coordinates", "sag_values"},
    "nurbs": {"control_points", "weights", "u_knots", "v_knots", "u_degree",
              "v_degree", "n_points_u", "n_points_v", "nurbs_norm_x",
              "nurbs_norm_y", "x_center", "y_center"},
}


class _SurfaceCollection:
    """Builder for the surface list."""

    def __init__(self, optic: "Optic"):
        self._optic = optic
        self._specs: list[SurfaceSpec] = []

    def __len__(self):
        return len(self._specs)

    def __getitem__(self, i):
        return self._specs[i]

    @property
    def specs(self) -> list[SurfaceSpec]:
        return self._specs

    def add(
        self,
        index: int | None = None,
        radius: float = math.inf,
        thickness: float = 0.0,
        material="air",
        conic: float = 0.0,
        is_stop: bool = False,
        surface_type: str = "standard",
        coefficients=(),
        dx: float = 0.0,
        dy: float = 0.0,
        rx: float = 0.0,
        ry: float = 0.0,
        rz: float = 0.0,
        aperture=None,
        f: float = 0.0,
        coating=None,
        bsdf=None,
        comment: str = "",
        **geom_kwargs,
    ):
        """Add a surface. `coating` is None, a name ("fresnel",
        "polarizer_h", "polarizer_v", "polarizer_rcp", "polarizer_lcp"), a
        tuple ("simple", T, R), ("retarder", retardance, theta),
        ("diattenuator", t_min, t_max, theta) or ("linear_polarizer",
        theta), or a `ThinFilmStack`; `bsdf` a `LambertianBSDF` or
        `GaussianBSDF` (`core/scatter.py`). `surface_type="paraxial"` is an
        ideal thin lens of
        focal length `f`; `"grating"` takes `grating_order`,
        `grating_period` (um) and `groove_orientation_angle` (rad) as
        keywords; `"phase"` a thin phase sheet on the plane or conic of
        `radius` and `conic`, its `phase_profile` one of ("constant", v),
        ("radial", [c1, c2, ...]) (c_j r^(2j)), ("linear_grating", kx, ky),
        ("grid", xs, ys, grid) or ("height_profile", xs, ys, h, material),
        as in the JAX package. `aperture` is a radial semi-aperture (a
        number) or a mask of `system/apertures.py`. The geometry types take
        the JAX package's
        keywords: "polynomial" its (order+1)^2 `coefficients` C_ij x^i y^j,
        row-major; "biconic" `radius_y`, `conic_y` (`radius`, `conic` the
        x-profile); "toroidal" `radius_y`, `coeffs_poly_y` (`radius` the
        rotation radius, `conic` the y-profile's); "chebyshev" a 2-D
        `coefficients` grid, `norm_x`, `norm_y`; "zernike" `coefficients`,
        `norm_radius`, `zernike_type` ("fringe", "noll" or "standard");
        "forbes_qbfs" `coefficients` or `radial_terms` ({n: a_n}),
        `norm_radius`; "forbes_q2d" `freeform_coeffs` ({("a" or "b", m, n):
        c}), `norm_radius`; "grid_sag" `x_coordinates`, `y_coordinates`,
        `sag_values` ((ny, nx)); "nurbs" an explicit control net
        (`control_points` (3, nu, nv), `weights`, `u_knots`, `v_knots`,
        `u_degree`, `v_degree`) or a fit of the conic of `radius` and
        `conic` (`n_points_u`, `n_points_v`, `nurbs_norm_x`,
        `nurbs_norm_y`, `x_center`, `y_center`)."""
        geometry = "standard"
        if surface_type in _GEOMETRY_KEYS:
            geometry = surface_type
            surface_type = "standard"
        if surface_type not in ("standard", "paraxial", "grating", "phase"):
            raise ValueError(
                f"Unknown surface_type {surface_type!r}; expected one of "
                "standard, paraxial, grating, phase, "
                + ", ".join(_GEOMETRY_KEYS))
        keys = {"grating": {"grating_order", "grating_period",
                            "groove_orientation_angle"},
                "phase": {"phase_profile"}}.get(surface_type,
                                                _GEOMETRY_KEYS.get(geometry,
                                                                   set()))
        if set(geom_kwargs) - keys:
            raise NotImplementedError(
                f"surface keywords {sorted(set(geom_kwargs) - keys)} are not "
                f"read by a {geometry} {surface_type} surface (the JAX "
                "package stores them unread)")
        if geometry == "chebyshev":
            # the 2-D coefficient grid travels in geom_params (static shape)
            geom_kwargs.setdefault("coefficients", coefficients)
            coefficients = ()
        spec = SurfaceSpec(
            radius=float(radius),
            thickness=float(thickness),
            conic=float(conic),
            coefficients=tuple(float(c) for c in coefficients),
            material=resolve_material(material),
            geometry=geometry,
            surface_type=surface_type,
            is_stop=is_stop,
            semi_aperture=aperture,
            dx=dx, dy=dy, rx=rx, ry=ry, rz=rz,
            focal_length=f,
            coating=coating,
            bsdf=bsdf,
            geom_params=geom_kwargs,
            comment=comment,
        )
        if index is None or index == len(self._specs):
            self._specs.append(spec)
        else:
            self._specs.insert(index, spec)
        self._optic._dirty()
        return spec


class _FieldGroup:
    def __init__(self, optic: "Optic"):
        self._optic = optic
        self.field_type = "angle"
        self.x: list[float] = []
        self.y: list[float] = []
        self.vx: list[float] = []
        self.vy: list[float] = []

    def set_type(self, field_type: str):
        if field_type not in ("angle", "object_height",
                              "paraxial_image_height", "real_image_height"):
            raise ValueError(f"Invalid field type: {field_type}.")
        self.field_type = field_type
        self._optic._dirty()

    def add(self, y: float = 0.0, x: float = 0.0, vx: float = 0.0,
            vy: float = 0.0):
        self.x.append(float(x))
        self.y.append(float(y))
        self.vx.append(float(vx))
        self.vy.append(float(vy))
        self._optic._dirty()

    @property
    def num_fields(self):
        return len(self.x)

    @property
    def max_field(self):
        return max(
            (math.hypot(xx, yy) for xx, yy in zip(self.x, self.y)), default=0.0
        )

    def get_field_coords(self):
        """The fields as normalized (Hx, Hy) pairs."""
        m = self.max_field
        if m == 0:
            return [(0.0, 0.0)]
        return [(xx / m, yy / m) for xx, yy in zip(self.x, self.y)]


_UNIT_TO_UM = {"nm": 1e-3, "um": 1.0, "mm": 1e3}


class _WavelengthGroup:
    def __init__(self, optic: "Optic"):
        self._optic = optic
        self.values_um: list[float] = []
        self.primary_idx = 0

    def add(self, value: float, is_primary: bool = False, unit: str = "um"):
        self.values_um.append(float(value) * _UNIT_TO_UM[unit])
        if is_primary or len(self.values_um) == 1:
            self.primary_idx = len(self.values_um) - 1
        self._optic._dirty()

    @property
    def num_wavelengths(self):
        return len(self.values_um)

    @property
    def primary_wavelength(self):
        return self.values_um[self.primary_idx]


class _ParaxialFacade:
    """`optic.paraxial.f2()`-style accessors over the functional engine,
    evaluated on the device of the optic's last build."""

    def __init__(self, optic: "Optic"):
        self._optic = optic

    def __getattr__(self, name):
        fn = getattr(px, name, None)
        if fn is None:
            raise AttributeError(name)

        def call(*args, **kw):
            static, params = self._optic.build(device=self._optic.device)
            return fn(static, params, *args, **kw)

        return call


class Optic:
    """A sequential optical system (lens prescription + trace entry
    points)."""

    def __init__(self, name: str | None = None):
        self.name = name or self.__class__.__name__
        self.surfaces = _SurfaceCollection(self)
        self.fields = _FieldGroup(self)
        self.obj_space_telecentric = False
        self.wavelengths = _WavelengthGroup(self)
        self.aperture_type: str | None = None
        self.aperture_value: float = 0.0
        self.apodization = None
        self.device = None  # the device of the last build; None = CUDA
        self.ray_aiming = "paraxial"  # paraxial, iterative, robust, cached
        self.polarization = "ignore"  # "ignore" | PolarizationState
        self._aim_cache = {}
        self._built = {}
        self.paraxial = _ParaxialFacade(self)
        from optiland_tpu_torch.system.solves import (
            PickupManager,
            SolveManager,
        )

        self.pickups = PickupManager(self)
        self.solves = SolveManager(self)

    def _dirty(self):
        self._built = {}

    def add_surface(self, **kw):
        return self.surfaces.add(**kw)

    def set_aperture(self, aperture_type: str, value: float):
        if aperture_type == "float_by_stop_size":
            aperture_type = "float_by_stop"
        self.aperture_type = aperture_type
        self.aperture_value = float(value)
        self._dirty()

    def set_field_type(self, field_type: str):
        self.fields.set_type(field_type)

    def set_telecentric(self, is_telecentric: bool = True):
        """Object-space telecentricity (reference
        `fields/field_group.py:212`): chief rays parallel to the axis."""
        self.obj_space_telecentric = bool(is_telecentric)
        self._dirty()

    def set_apodization(self, spec):
        """Set the pupil apodization: a name, (name, kwargs) or an instance
        of `core/apodization.py` (reference `optiland/apodization/`)."""
        from optiland_tpu_torch.core.apodization import make_apodization

        self.apodization = make_apodization(spec)
        self._dirty()

    def set_polarization(self, state):
        """Set the trace polarization: "ignore" (a scalar trace),
        "unpolarized", or a `PolarizationState` (a PRT trace)."""
        from optiland_tpu_torch.polarization import PolarizationState

        if isinstance(state, PolarizationState) or state == "ignore":
            self.polarization = state
        elif state == "unpolarized":
            self.polarization = PolarizationState.unpolarized()
        else:
            raise ValueError(
                "polarization must be 'ignore', 'unpolarized', or a "
                "PolarizationState")

    def _pol(self):
        return None if self.polarization == "ignore" else self.polarization

    def set_ray_aiming(self, mode: str):
        """Choose the ray-aiming strategy (reference
        `rays/ray_aiming/registry.py`): "paraxial" (the closed form in
        `generate_rays`), "iterative", "robust" or "cached" (the iterative
        aim, memoized on the parameters and the query)."""
        if mode not in ("paraxial", "iterative", "robust", "cached"):
            raise ValueError(
                "ray aiming must be paraxial, iterative, robust, or cached")
        self.ray_aiming = mode
        self._aim_cache = {}

    def _aim(self, static, params, Hx, Hy, Px, Py, wavelength):
        """The pupil coordinates to launch, aimed as `ray_aiming` says."""
        if self.ray_aiming == "paraxial":
            return Px, Py
        from optiland_tpu_torch.trace import aiming

        w = torch.as_tensor(wavelength, dtype=params.cv.dtype,
                            device=params.cv.device)
        if self.ray_aiming == "cached":
            # the iterative aim memoized (reference
            # `ray_aiming/cached.py:22-147`), keyed on the parameters'
            # bytes and the query's, so that an edit misses the cache
            h = hashlib.sha256()
            arrays = [getattr(params, f.name) for f in fields(params)]
            for a in arrays + [Hx, Hy, Px, Py, w]:
                if a is not None:
                    h.update(a.detach().cpu().numpy().tobytes())
            key = h.hexdigest()
            if key not in self._aim_cache:
                self._aim_cache[key] = aiming.aim_rays_iterative(
                    static, params, Hx, Hy, Px, Py, w)
            return self._aim_cache[key]
        fn = (aiming.aim_rays_iterative if self.ray_aiming == "iterative"
              else aiming.aim_rays_robust)
        return fn(static, params, Hx, Hy, Px, Py, w)

    def add_field(self, y: float = 0.0, x: float = 0.0, vx: float = 0.0,
                  vy: float = 0.0):
        self.fields.add(y=y, x=x, vx=vx, vy=vy)

    def add_wavelength(self, value: float, is_primary: bool = False,
                       unit: str = "um"):
        self.wavelengths.add(value, is_primary=is_primary, unit=unit)

    @property
    def primary_wavelength(self):
        return self.wavelengths.primary_wavelength

    def build(self, device=None):
        """Compile to (SystemStatic, SystemParams) on `device` (None: the
        CUDA card, RuntimeError without one); cached per device and dtype
        until the prescription changes."""
        dev = config.resolve_device(device)
        self.device = dev
        key = (str(dev), config.get_dtype())
        if key not in self._built:
            if self.aperture_type is None:
                raise ValueError("No aperture defined; call set_aperture().")
            if not self.wavelengths.num_wavelengths:
                raise ValueError("No wavelengths defined.")
            if not self.fields.num_fields:
                self.fields.add(y=0.0)
            self._built[key] = build_system(
                self.surfaces.specs,
                field_type=self.fields.field_type,
                x_fields=self.fields.x,
                y_fields=self.fields.y,
                vx=self.fields.vx,
                vy=self.fields.vy,
                aperture_type=self.aperture_type,
                aperture_value=self.aperture_value,
                wavelengths=self.wavelengths.values_um,
                primary_wavelength_idx=self.wavelengths.primary_idx,
                apodization=self.apodization,
                telecentric=self.obj_space_telecentric,
                device=dev,
            )
        return self._built[key]

    @property
    def static(self):
        """The `SystemStatic` of a build on the last build's device."""
        return self.build(device=self.device)[0]

    @property
    def params(self):
        """The `SystemParams` of a build on the last build's device."""
        return self.build(device=self.device)[1]

    def update_params(self, params):
        """Install an externally updated `SystemParams` (e.g. an optimizer
        step) without touching the structure, for the last build's device
        and the current precision."""
        static, _ = self.build(device=self.device)
        key = (str(config.resolve_device(self.device)), config.get_dtype())
        self._built[key] = (static, params)

    def update(self):
        """Re-apply pickups and solves (reference `Optic.update`)."""
        self.pickups.apply()
        self.solves.apply()

    # -- per-surface edits (reference `optic/optic_updater.py:38-160`) ---
    def set_radius(self, value: float, surface_number: int):
        """Set the radius of curvature of surface `surface_number`."""
        self.surfaces.specs[surface_number].radius = float(value)
        self._dirty()

    def set_conic(self, value: float, surface_number: int):
        """Set the conic constant of surface `surface_number`."""
        self.surfaces.specs[surface_number].conic = float(value)
        self._dirty()

    def set_thickness(self, value: float, surface_number: int):
        """Set the gap thickness after surface `surface_number`."""
        self.surfaces.specs[surface_number].thickness = float(value)
        self._dirty()

    def set_index(self, value: float, surface_number: int):
        """Make the medium after surface `surface_number` an ideal material
        of constant index `value`."""
        self.surfaces.specs[surface_number].material = resolve_material(
            float(value))
        self._dirty()

    def set_material(self, material, surface_number: int):
        """Set the medium after surface `surface_number` (a name, a (name,
        manufacturer) pair, a number or a MaterialSpec)."""
        from optiland_tpu_torch.materials.catalog import MaterialSpec

        if not isinstance(material, MaterialSpec):
            material = resolve_material(material)
        self.surfaces.specs[surface_number].material = material
        self._dirty()

    def set_asphere_coeff(self, value: float, surface_number: int,
                          aspher_coeff_idx: int):
        """Set one polynomial coefficient of an asphere surface."""
        s = self.surfaces.specs[surface_number]
        c = list(s.coefficients)
        while len(c) <= aspher_coeff_idx:
            c.append(0.0)
        c[aspher_coeff_idx] = float(value)
        s.coefficients = tuple(c)
        self._dirty()

    # -- system-level edits (reference `optic/optic_updater.py:24-340`) --
    def scale_system(self, scale_factor: float):
        """Scale every length of the prescription (radii, thicknesses,
        freeform coefficients by their powers of length, norm radii, grid
        sags, grating periods, radial apertures, an EPD or float-by-stop
        aperture) by `scale_factor` (reference `optic_updater.py:175-204`
        and each geometry's `scale`). Aperture masks keep their size, as in
        the JAX package."""
        f = float(scale_factor)
        for s in self.surfaces.specs:
            if math.isfinite(s.radius):
                s.radius *= f
            if math.isfinite(s.thickness):
                s.thickness *= f
            gp = s.geom_params
            g = s.geometry
            if g == "even_asphere":
                s.coefficients = tuple(
                    c * f ** (1 - 2 * (i + 1))
                    for i, c in enumerate(s.coefficients))
            elif g == "odd_asphere":
                s.coefficients = tuple(
                    c * f ** (1 - (i + 1))
                    for i, c in enumerate(s.coefficients))
            elif g == "polynomial":
                # the flattened (order+1)^2 grid: C_ij' = C_ij f^(1-(i+j))
                n = len(s.coefficients)
                order = int(round(n**0.5)) - 1
                s.coefficients = tuple(
                    c * f ** (1 - (idx // (order + 1) + idx % (order + 1)))
                    for idx, c in enumerate(s.coefficients))
            elif g == "chebyshev":
                gp["norm_x"] = gp.get("norm_x", 1.0) * f
                gp["norm_y"] = gp.get("norm_y", 1.0) * f
                gp["coefficients"] = np.asarray(
                    gp.get("coefficients", s.coefficients), float) * f
            elif g == "zernike":
                gp["norm_radius"] = gp.get("norm_radius", 1.0) * f
                s.coefficients = tuple(c * f for c in s.coefficients)
            elif g in ("forbes_qbfs", "forbes_q2d"):
                if gp.get("norm_radius") is not None:
                    gp["norm_radius"] = gp["norm_radius"] * f
                if "radial_terms" in gp:
                    gp["radial_terms"] = {
                        k: v * f for k, v in gp["radial_terms"].items()}
                if "freeform_coeffs" in gp:
                    gp["freeform_coeffs"] = {
                        k: v * f for k, v in gp["freeform_coeffs"].items()}
                s.coefficients = tuple(c * f for c in s.coefficients)
            elif g == "biconic":
                if math.isfinite(gp.get("radius_y", math.inf)):
                    gp["radius_y"] = gp["radius_y"] * f
            elif g == "toroidal":
                if math.isfinite(gp.get("radius_y", math.inf)):
                    gp["radius_y"] = gp["radius_y"] * f
                poly = list(gp.get("coeffs_poly_y", s.coefficients))
                poly = [c * f ** (1 - 2 * (i + 1))
                        for i, c in enumerate(poly)]
                if "coeffs_poly_y" in gp:
                    gp["coeffs_poly_y"] = poly
                else:
                    s.coefficients = tuple(poly)
            elif g == "grid_sag":
                for key in ("x_coordinates", "y_coordinates", "sag_values"):
                    gp[key] = np.asarray(gp[key], float) * f
            if "grating_period" in gp:
                gp["grating_period"] = gp["grating_period"] * f
            sa = s.semi_aperture
            if isinstance(sa, (int, float)):
                s.semi_aperture = sa * f
            elif sa is not None and hasattr(sa, "scale"):
                s.semi_aperture = sa.scale(f)
        # EPD and float-by-stop values are lengths, FNO and NA ratios
        # (reference `aperture/*.is_scalable`)
        if self.aperture_type in ("EPD", "float_by_stop"):
            self.aperture_value *= f
        self._dirty()

    def flip(self):
        """Reverse the optical train in place: surface order, the signs of
        every curvature-like radius (a grid sag's table), media and the
        gaps between surfaces (reference `optic_updater.py:267-289`,
        `surface_group.py:458-552`); conics and polynomial coefficients
        stay. The object and image gaps are kept; pickups are remapped to
        the new surface numbers."""
        specs = self.surfaces.specs
        n = len(specs)
        if n < 3:
            raise ValueError(
                "Optic flip requires at least 3 surfaces (obj, element, img)")
        inner = specs[1:-1]
        # material[k] is the medium after surface k; reversed, the medium
        # after new surface j (old surface n-1-j) is the one before it
        old_mats = [s.material for s in specs]
        old_thick = [s.thickness for s in specs]
        new_inner = list(reversed(inner))
        for j, s in enumerate(new_inner):
            old_idx = n - 2 - j
            if math.isfinite(s.radius):
                s.radius = -s.radius
            if (s.geometry in ("biconic", "toroidal")
                    and "radius_y" in s.geom_params
                    and math.isfinite(s.geom_params["radius_y"])):
                s.geom_params["radius_y"] = -s.geom_params["radius_y"]
            if s.geometry == "grid_sag" and "sag_values" in s.geom_params:
                s.geom_params["sag_values"] = -np.asarray(
                    s.geom_params["sag_values"], float)
            s.material = (old_mats[old_idx - 1]
                          if not s.material.mirror else s.material)
            # the inner gaps reverse; the gap to the image plane stays
            s.thickness = (old_thick[n - 2 - (j + 1)] if j < n - 3
                           else old_thick[n - 2])
        self.surfaces._specs = [specs[0]] + new_inner + [specs[-1]]

        def remap(idx):
            return idx if idx in (0, n - 1) else n - 1 - idx

        for p in getattr(self.pickups, "pickups", []):
            p.source_surface_idx = remap(p.source_surface_idx)
            p.target_surface_idx = remap(p.target_surface_idx)
        self._dirty()

    def __add__(self, other: "Optic") -> "Optic":
        """Concatenate two systems: this one's surfaces but its image plane,
        then the other's but its object plane (reference `optic/optic.py`
        `__add__`, `surface_group.py:63-84`); one stop, this one's."""
        out = Optic(f"{self.name}+{other.name}")
        out.aperture_type = self.aperture_type
        out.aperture_value = self.aperture_value
        out.fields = copy.deepcopy(self.fields)
        out.fields._optic = out
        out.wavelengths = copy.deepcopy(self.wavelengths)
        out.wavelengths._optic = out
        out.obj_space_telecentric = self.obj_space_telecentric
        left = [copy.deepcopy(s) for s in self.surfaces.specs[:-1]]
        right = [copy.deepcopy(s) for s in other.surfaces.specs[1:]]
        has_stop = any(s.is_stop for s in left)
        for s in right:
            if has_stop:
                s.is_stop = False
        out.surfaces._specs = left + right
        return out

    def update_paraxial(self):
        """Per-surface semi-apertures from the paraxial marginal and chief
        rays (reference `optic_updater.py:206-228`), at least each set
        radial aperture, stored in `self.semi_apertures` (numpy); the clip
        apertures stay as set."""
        static, params = self.build(device=self.device)
        ya, _ = px.marginal_ray(static, params)
        yb, _ = px.chief_ray(static, params)
        r = (np.abs(ya.detach().cpu().numpy().ravel())
             + np.abs(yb.detach().cpu().numpy().ravel()))
        for k, s in enumerate(self.surfaces.specs):
            if isinstance(s.semi_aperture, (int, float)):
                r[k] = max(r[k], float(s.semi_aperture))
        self.semi_apertures = r
        return r

    # -- convenience views (reference `Optic.draw/info`) --------------------
    def draw(self, device=None, **kwargs):
        """The 2-D cross-section (`visualization.OpticViewer.view`), its
        rays traced on `device` (None: the CUDA card)."""
        from optiland_tpu_torch.visualization import OpticViewer

        return OpticViewer(self, device=device).view(**kwargs)

    def draw3D(self, device=None, **kwargs):
        """3-D render (reference `Optic.draw3D`, VTK there; matplotlib 3-D
        by default here, `visualization/viewer3d.py`), its rays traced on
        `device` (None: the CUDA card)."""
        from optiland_tpu_torch.visualization import OpticViewer3D

        return OpticViewer3D(self, device=device).view(**kwargs)

    def info(self):
        from optiland_tpu_torch.visualization import LensInfoViewer

        return LensInfoViewer(self).view()

    # -- serialization ----------------------------------------------------
    def to_dict(self):
        from optiland_tpu_torch.fileio import optic_to_dict

        return optic_to_dict(self)

    @classmethod
    def from_dict(cls, data):
        from optiland_tpu_torch.fileio import optic_from_dict

        return optic_from_dict(data)

    # -- tracing ---------------------------------------------------------
    def trace(self, Hx=0.0, Hy=0.0, wavelength=None, num_rays: int = 100,
              distribution="hexapolar", device=None):
        """Trace a pupil distribution for field point(s) on `device` (None:
        the CUDA card); returns the (S, N) TraceHistory (reference
        `Optic.trace`, `optic/optic.py:715`). `distribution` is a name of
        `core/distributions.py` (with `num_rays` its size) or a (Px, Py)
        pair."""
        from optiland_tpu_torch.trace.tracer import trace_system

        static, params = self.build(device=device)
        if wavelength is None:
            wavelength = self.primary_wavelength
        if isinstance(distribution, str):
            Px, Py = dist.generate(distribution, num_rays)[:2]
        else:
            Px, Py = distribution
        dt, dev = params.cv.dtype, params.cv.device
        Px, Py, Hx, Hy = (torch.atleast_1d(torch.as_tensor(
            a, dtype=dt, device=dev)) for a in (Px, Py, Hx, Hy))
        nP = Px.shape[0]
        Hx_full = Hx.repeat_interleave(nP)
        Hy_full = Hy.repeat_interleave(nP)
        Px_full, Py_full = self._aim(static, params, Hx_full, Hy_full,
                                     Px.repeat(Hx.shape[0]),
                                     Py.repeat(Hx.shape[0]), wavelength)
        return trace_system(static, params, Hx_full, Hy_full, Px_full,
                            Py_full, torch.as_tensor(wavelength, dtype=dt,
                                                     device=dev), True,
                            polarization=self._pol())

    def trace_generic(self, Hx, Hy, Px, Py, wavelength=None, device=None):
        """Trace explicit (field, pupil) coordinate arrays on `device`.
        Vignetting is applied to the pupil coordinates as in the
        reference's `RealRayTracer.trace_generic`
        (`raytrace/real_ray_tracer.py:120-154`)."""
        from optiland_tpu_torch.trace.raygen import vignetting_factors
        from optiland_tpu_torch.trace.tracer import trace_system

        static, params = self.build(device=device)
        if wavelength is None:
            wavelength = self.primary_wavelength
        dt, dev = params.cv.dtype, params.cv.device
        Hx, Hy, Px, Py = torch.broadcast_tensors(*(torch.atleast_1d(
            torch.as_tensor(a, dtype=dt, device=dev))
            for a in (Hx, Hy, Px, Py)))
        vxf, vyf = vignetting_factors(static, params, Hx, Hy)
        Px, Py = self._aim(static, params, Hx, Hy, Px * (1.0 - vxf),
                           Py * (1.0 - vyf), wavelength)
        return trace_system(static, params, Hx, Hy, Px, Py,
                            torch.as_tensor(wavelength, dtype=dt, device=dev),
                            True, polarization=self._pol())
