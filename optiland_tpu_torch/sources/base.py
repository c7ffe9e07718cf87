"""Extended sources: ray bundles generated at a source plane and traced
through an Optic (port of `optiland_tpu/sources/base.py`; reference
`optiland/sources/base.py`, `optic/extended_source_optic.py:24`)."""

from __future__ import annotations

import torch

from optiland_tpu_torch.core.rays import Rays


class BaseSource:
    """A ray-bundle generator positioned in global space."""

    def __init__(self, position=(0.0, 0.0, 0.0)):
        self.position = tuple(float(v) for v in position)

    def generate_rays(self, num_rays: int, device=None) -> Rays:
        raise NotImplementedError

    def _globalize(self, rays: Rays) -> Rays:
        px, py, pz = self.position
        return rays.replace(x=rays.x + px, y=rays.y + py, z=rays.z + pz)


def trace_source(optic, source: BaseSource, num_rays: int, device=None):
    """Trace source-generated rays through the optic, eagerly, as JAX's
    `trace_rays` does (the reference's ExtendedSourceOptic.trace), on
    `device` (None: the CUDA card)."""
    from optiland_tpu_torch.trace.tracer import trace_rays

    static, params = optic.build(device=device)
    rays = source.generate_rays(num_rays, device=params.cv.device)
    rays = rays.replace(**{k: torch.as_tensor(
        getattr(rays, k), dtype=params.cv.dtype, device=params.cv.device)
        for k in ("x", "y", "z", "L", "M", "N", "i", "opd", "w")})
    return trace_rays(static, params, rays)
