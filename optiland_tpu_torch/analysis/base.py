"""Shared analysis plumbing (port of `optiland_tpu/analysis/base.py`): the
field and wavelength resolvers of `core/resolve.py`, host sample arrays
moved to a build's device and dtype, and `jnp.linspace`'s formula."""

from __future__ import annotations

import torch

from optiland_tpu_torch.core.resolve import resolve_fields, resolve_wavelengths

__all__ = ["resolve_fields", "resolve_wavelengths", "like", "linspace"]


def like(a, params):
    """An array (numpy, list, number or tensor) as a tensor on the device
    and in the dtype of `params`."""
    return torch.as_tensor(a, dtype=params.cv.dtype, device=params.cv.device)


def linspace(start, stop, num: int, ref):
    """`num` points from `start` to `stop` on the device and in the dtype of
    the tensor `ref`, by `jnp.linspace`'s formula, start (1 - t) + stop t
    with t = i / (num - 1) and the last point `stop` itself (torch.linspace
    rounds its points otherwise, and a ray on a bin edge must land in the
    same bin as in JAX)."""
    start = torch.as_tensor(start, dtype=ref.dtype, device=ref.device)
    stop = torch.as_tensor(stop, dtype=ref.dtype, device=ref.device)
    if num == 1:
        return start.reshape(1)
    t = torch.arange(num - 1, dtype=ref.dtype, device=ref.device) / (num - 1)
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])
