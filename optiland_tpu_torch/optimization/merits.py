"""Fused merit functions for the trace-and-merit path.

Port of `optiland_tpu/optimization/merits.py`. The centroid-RMS spot merit
consumes four weighted moments of the image-surface state, which
`trace.fused.spot_moments` computes in one kernel launch (K1) on the CUDA
card for the systems the fused gates accept; its gradient is one launch of
K2. With a device mesh (`parallel/`), each rank's K1 and K2 run on its own
shard of the rays, and the four moment sums are all-reduced before the
merit is formed from them."""

from __future__ import annotations

import torch

from optiland_tpu_torch.trace.fused import spot_moments


def centroid_rms_spot(static, params, Hx, Hy, Px, Py, wavelength,
                      eps: float = 1e-6, diff_inputs: bool = True,
                      mesh=None):
    """Intensity-weighted RMS spot size (squared) about the weighted
    centroid at the image surface:

        loss = sum(((x-cx)^2 + (y-cy)^2) * i) / (sum(i) + eps)

    Differentiable with respect to `params` and, by default, the field and
    pupil inputs. `diff_inputs=False` declares the per-ray input
    cotangents unwanted, so the backward kernel skips them (they come back
    as zeros): the params-only optimization step.

    With a `mesh` (`parallel.make_mesh`, `make_mesh_2d`) the rays are this
    rank's shard (`parallel.shard_rays`): the four moment sums are summed
    over the mesh (`parallel.mesh.all_sum`) and every rank returns the
    merit of the whole batch. Its parameter gradients then carry the
    mesh size as a factor until `parallel.mesh.average_gradients`."""
    m = spot_moments(static, params, Hx, Hy, Px, Py, wavelength,
                     diff_data=diff_inputs)
    if mesh is not None:
        from optiland_tpu_torch.parallel.mesh import all_sum

        m = all_sum(mesh, torch.stack(tuple(m)))
    return centroid_rms_from_moments(*m, eps)


def centroid_rms_from_moments(m0, m1, m2, m3, eps: float = 1e-6):
    """The centroid-RMS spot merit from the four spot moments."""
    ws = m0 + eps
    cx = m1 / ws
    cy = m2 / ws
    # expansion of sum(((x-cx)^2+(y-cy)^2) i) in moments
    return (m3 - 2.0 * (cx * m1 + cy * m2) + (cx * cx + cy * cy) * m0) / ws
