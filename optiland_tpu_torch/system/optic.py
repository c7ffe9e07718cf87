"""The `Optic` builder: the prescription API of `optiland_tpu/system/optic.py`
for the ported surface types.

`build(device=...)` compiles the description to a `(SystemStatic,
SystemParams)` pair with the parameter tensors on that device; without
`device=` it builds on the CUDA card. `trace` and `trace_generic` trace
a pupil distribution or explicit coordinates on that device and return
the (S, N) `TraceHistory` (on the card in float32: kernel K7).
"""

from __future__ import annotations

import math

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
        aperture: float | None = None,
        f: float = 0.0,
        coating=None,
        comment: str = "",
        **geom_kwargs,
    ):
        """Add a surface. `surface_type="paraxial"` is an ideal thin lens of
        focal length `f`; `"grating"` takes `grating_order`,
        `grating_period` (um) and `groove_orientation_angle` (rad) as
        keywords; `"phase"` a thin phase sheet on the plane or conic of
        `radius` and `conic`, its `phase_profile` one of ("constant", v),
        ("radial", [c1, c2, ...]) (c_j r^(2j)), ("linear_grating", kx, ky),
        ("grid", xs, ys, grid) or ("height_profile", xs, ys, h, material),
        as in the JAX package. The geometry types take the JAX package's
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
            raise NotImplementedError(
                f"surface_type {surface_type!r} is not ported yet; ported: "
                "standard, paraxial, grating, phase, "
                + ", ".join(_GEOMETRY_KEYS) + " (ROADMAP queue 1, item 15)")
        keys = {"grating": {"grating_order", "grating_period",
                            "groove_orientation_angle"},
                "phase": {"phase_profile"}}.get(surface_type,
                                                _GEOMETRY_KEYS.get(geometry,
                                                                   set()))
        if set(geom_kwargs) - keys:
            raise NotImplementedError(
                f"surface keywords {sorted(set(geom_kwargs) - keys)} are not "
                "ported yet (ROADMAP queue 1, item 15)")
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
            semi_aperture=None if aperture is None else float(aperture),
            dx=dx, dy=dy, rx=rx, ry=ry, rz=rz,
            focal_length=f,
            coating=coating,
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
    """A sequential optical system (lens prescription)."""

    def __init__(self, name: str | None = None):
        self.name = name or self.__class__.__name__
        self.surfaces = _SurfaceCollection(self)
        self.fields = _FieldGroup(self)
        self.wavelengths = _WavelengthGroup(self)
        self.aperture_type: str | None = None
        self.aperture_value: float = 0.0
        self.device = None  # the device of the last build; None = CUDA
        self.ray_aiming = "paraxial"
        self._built = {}
        self.paraxial = _ParaxialFacade(self)

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

    def set_ray_aiming(self, mode: str):
        """Choose the ray-aiming strategy; only "paraxial" is ported (the
        iterative and robust aimers come with `trace/aiming.py`)."""
        if mode not in ("paraxial", "iterative", "robust", "cached"):
            raise ValueError(
                "ray aiming must be paraxial, iterative, robust, or cached")
        self.ray_aiming = mode

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
                device=dev,
            )
        return self._built[key]

    # -- tracing ---------------------------------------------------------
    def _aim(self, Px, Py):
        if self.ray_aiming != "paraxial":
            raise NotImplementedError(
                f"ray aiming {self.ray_aiming!r} is not ported yet "
                "(trace/aiming.py, ROADMAP queue 1, item 13)")
        return Px, Py

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
        Px_full, Py_full = self._aim(Px.repeat(Hx.shape[0]),
                                     Py.repeat(Hx.shape[0]))
        return trace_system(static, params, Hx_full, Hy_full, Px_full,
                            Py_full, torch.as_tensor(wavelength, dtype=dt,
                                                     device=dev), True)

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
        Px, Py = self._aim(Px * (1.0 - vxf), Py * (1.0 - vyf))
        return trace_system(static, params, Hx, Hy, Px, Py,
                            torch.as_tensor(wavelength, dtype=dt, device=dev),
                            True)
