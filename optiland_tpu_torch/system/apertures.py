"""Physical aperture masks: ray-clipping predicates per surface.

Port of `optiland_tpu/system/apertures.py` (the reference's
`optiland/physical_apertures/`): each aperture is a frozen, hashable
dataclass whose numbers are structural constants, not optimization
variables (the differentiable radial semi-aperture stays in
`SystemParams.ap_radius`); `contains(x, y)` takes tensors and returns a
boolean tensor. Rays outside an aperture get intensity zero but keep
tracing (`physical_apertures/base.py:30-340`, `rays/real_rays.py:154-161`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

__all__ = [
    "BaseAperture",
    "RadialAperture",
    "OffsetRadialAperture",
    "EllipticalAperture",
    "RectangularAperture",
    "PolygonAperture",
    "FileAperture",
    "UnionAperture",
    "IntersectionAperture",
    "DifferenceAperture",
]


@dataclass(frozen=True)
class BaseAperture:
    """Boolean-composable aperture predicate (reference
    `physical_apertures/base.py:30`)."""

    def contains(self, x, y):
        raise NotImplementedError

    def clip(self, x, y):
        """Mask of rays to *remove* (outside the aperture)."""
        return ~self.contains(x, y)

    @property
    def extent(self) -> tuple[float, float, float, float]:
        raise NotImplementedError

    def __or__(self, other):
        return UnionAperture(self, other)

    def __and__(self, other):
        return IntersectionAperture(self, other)

    def __sub__(self, other):
        return DifferenceAperture(self, other)


@dataclass(frozen=True)
class RadialAperture(BaseAperture):
    """r_min <= r <= r_max annulus (reference `radial.py:31`)."""

    r_max: float
    r_min: float = 0.0

    def contains(self, x, y):
        r2 = x * x + y * y
        return (r2 <= self.r_max**2) & (r2 >= self.r_min**2)

    @property
    def extent(self):
        return -self.r_max, self.r_max, -self.r_max, self.r_max


@dataclass(frozen=True)
class OffsetRadialAperture(BaseAperture):
    """Annulus centered at (offset_x, offset_y) (reference
    `offset_radial.py`)."""

    r_max: float
    r_min: float = 0.0
    offset_x: float = 0.0
    offset_y: float = 0.0

    def contains(self, x, y):
        r2 = (x - self.offset_x) ** 2 + (y - self.offset_y) ** 2
        return (r2 <= self.r_max**2) & (r2 >= self.r_min**2)

    @property
    def extent(self):
        return (self.offset_x - self.r_max, self.offset_x + self.r_max,
                self.offset_y - self.r_max, self.offset_y + self.r_max)


@dataclass(frozen=True)
class EllipticalAperture(BaseAperture):
    """x^2/a^2 + y^2/b^2 <= 1, offsettable (reference `elliptical.py`)."""

    a: float
    b: float
    offset_x: float = 0.0
    offset_y: float = 0.0

    def contains(self, x, y):
        xr = x - self.offset_x
        yr = y - self.offset_y
        return xr * xr / self.a**2 + yr * yr / self.b**2 <= 1.0

    @property
    def extent(self):
        return (self.offset_x - self.a, self.offset_x + self.a,
                self.offset_y - self.b, self.offset_y + self.b)


@dataclass(frozen=True)
class RectangularAperture(BaseAperture):
    """Axis-aligned box (reference `rectangular.py`)."""

    x_min: float
    x_max: float
    y_min: float
    y_max: float

    def contains(self, x, y):
        return ((self.x_min <= x) & (x <= self.x_max)
                & (self.y_min <= y) & (y <= self.y_max))

    @property
    def extent(self):
        return self.x_min, self.x_max, self.y_min, self.y_max


@dataclass(frozen=True)
class PolygonAperture(BaseAperture):
    """Point-in-polygon by the even-odd (ray casting) rule, one pass over
    the edges (reference `polygon.py:52` uses matplotlib Path; same rule).
    The vertices are tuples of floats."""

    xs: tuple[float, ...]
    ys: tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "xs", tuple(float(v) for v in self.xs))
        object.__setattr__(self, "ys", tuple(float(v) for v in self.ys))

    def contains(self, x, y):
        n = len(self.xs)
        inside = torch.zeros_like(torch.as_tensor(x), dtype=torch.bool)
        for i in range(n):
            x1, y1 = self.xs[i], self.ys[i]
            x2, y2 = self.xs[(i + 1) % n], self.ys[(i + 1) % n]
            if y1 == y2:
                continue
            crosses = ((y1 > y) != (y2 > y)) & (
                x < (x2 - x1) * (y - y1) / (y2 - y1) + x1)
            inside = inside ^ crosses
        return inside

    @property
    def extent(self):
        return min(self.xs), max(self.xs), min(self.ys), max(self.ys)


def FileAperture(filepath: str, delimiter=None, skip_header: int = 0
                 ) -> PolygonAperture:
    """Polygon aperture loaded from a 2-column vertex file (reference
    `polygon.py:107`; auto-detects comma/whitespace delimiters)."""
    if delimiter is None:
        with open(filepath) as fh:
            for _ in range(skip_header):
                fh.readline()
            first = fh.readline()
        delimiter = "," if "," in first else None
    data = np.genfromtxt(filepath, delimiter=delimiter,
                         skip_header=skip_header)
    if data.ndim != 2 or data.shape[1] < 2:
        raise ValueError(f"Aperture file {filepath!r} must have two columns")
    return PolygonAperture(tuple(data[:, 0]), tuple(data[:, 1]))


@dataclass(frozen=True)
class UnionAperture(BaseAperture):
    a: BaseAperture
    b: BaseAperture

    def contains(self, x, y):
        return self.a.contains(x, y) | self.b.contains(x, y)

    @property
    def extent(self):
        ea, eb = self.a.extent, self.b.extent
        return (min(ea[0], eb[0]), max(ea[1], eb[1]),
                min(ea[2], eb[2]), max(ea[3], eb[3]))


@dataclass(frozen=True)
class IntersectionAperture(BaseAperture):
    a: BaseAperture
    b: BaseAperture

    def contains(self, x, y):
        return self.a.contains(x, y) & self.b.contains(x, y)

    @property
    def extent(self):
        ea, eb = self.a.extent, self.b.extent
        return (max(ea[0], eb[0]), min(ea[1], eb[1]),
                max(ea[2], eb[2]), min(ea[3], eb[3]))


@dataclass(frozen=True)
class DifferenceAperture(BaseAperture):
    a: BaseAperture
    b: BaseAperture

    def contains(self, x, y):
        return self.a.contains(x, y) & ~self.b.contains(x, y)

    @property
    def extent(self):
        return self.a.extent
