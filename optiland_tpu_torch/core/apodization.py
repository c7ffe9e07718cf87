"""Pupil apodization: intensity weighting of the launch rays.

Port of `optiland_tpu/core/apodization.py` (the reference's
`optiland/apodization/*` registry). Each apodization is a function of the
normalized pupil coordinates as tensors, applied in `generate_rays` where
the reference's RayGenerator applies it (`rays/ray_generator.py:81-85`).
The objects are hashable and compare by value, since `SystemStatic`
carries them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


class BaseApodization:
    def get_intensity(self, Px, Py):
        raise NotImplementedError

    def __hash__(self):
        return hash((type(self).__name__,) + tuple(sorted(vars(self).items())))

    def __eq__(self, other):
        return type(self) is type(other) and vars(self) == vars(other)


class UniformApodization(BaseApodization):
    def get_intensity(self, Px, Py):
        return torch.ones_like(Px)


def _radius(Px, Py):
    return torch.sqrt(Px**2 + Py**2)


@dataclass(frozen=True, eq=True)
class GaussianApodization(BaseApodization):
    sigma: float = 1.0

    def get_intensity(self, Px, Py):
        return torch.exp(-(Px**2 + Py**2) / (2.0 * self.sigma**2))


@dataclass(frozen=True, eq=True)
class CosineSquaredApodization(BaseApodization):
    R: float = 1.0

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        inten = torch.cos(math.pi * r / (2.0 * self.R)) ** 2
        return torch.where(r < self.R, inten, torch.zeros_like(inten))


@dataclass(frozen=True, eq=True)
class HannApodization(BaseApodization):
    D: float = 2.0

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        inten = 0.5 * (1.0 - torch.cos(2.0 * math.pi * r / self.D))
        return torch.where(r < self.D / 2.0, inten, torch.zeros_like(inten))


@dataclass(frozen=True, eq=True)
class TukeyApodization(BaseApodization):
    R: float = 1.0
    alpha: float = 0.5

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        a = self.alpha
        flat = r <= self.R * (1.0 - a)
        taper = 0.5 * (1.0 + torch.cos(
            math.pi / max(a, 1e-12) * (r / self.R - 1.0 + a)))
        inten = torch.where(flat, torch.ones_like(taper), taper)
        return torch.where(r <= self.R, inten, torch.zeros_like(inten))


@dataclass(frozen=True, eq=True)
class SuperGaussianApodization(BaseApodization):
    w: float = 1.0
    n: float = 2.0

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        return torch.exp(-((r / self.w) ** self.n))


@dataclass(frozen=True, eq=True)
class PolynomialApodization(BaseApodization):
    R: float = 1.0
    p: float = 1.0

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        inten = (1.0 - (r / self.R) ** 2) ** self.p
        return torch.where(r < self.R, inten, torch.zeros_like(inten))


_REGISTRY = {
    "uniform": UniformApodization,
    "gaussian": GaussianApodization,
    "cosine_squared": CosineSquaredApodization,
    "hann": HannApodization,
    "tukey": TukeyApodization,
    "super_gaussian": SuperGaussianApodization,
    "polynomial": PolynomialApodization,
}


def make_apodization(spec) -> BaseApodization:
    """None | name | (name, kwargs dict) | instance -> apodization."""
    if spec is None:
        return UniformApodization()
    if isinstance(spec, BaseApodization):
        return spec
    if isinstance(spec, str):
        return _REGISTRY[spec]()
    name, kwargs = spec
    return _REGISTRY[name](**kwargs)
