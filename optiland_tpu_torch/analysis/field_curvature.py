"""Field curvature via parabasal ray pairs (port of
`optiland_tpu/analysis/field_curvature.py`)."""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import (
    like,
    linspace,
    resolve_wavelengths,
)


def _focus_shift(h, axis):
    """z of the crossing of each ray pair (even, odd) in the plane of
    `axis` ("y" or "x"), relative to the image plane."""
    u = h.M[-1] if axis == "y" else h.L[-1]
    p = h.y[-1] if axis == "y" else h.x[-1]
    N, z = h.N[-1], h.z[-1]
    u1, N1, p1, z1 = u[::2], N[::2], p[::2], z[::2]
    u2, N2, p2, z2 = u[1::2], N[1::2], p[1::2], z[1::2]
    t1 = (u2 * z1 - u2 * z2 - N2 * p1 + N2 * p2) / (u1 * N2 - u2 * N1)
    return t1 * N1


class FieldCurvature:
    """Tangential/sagittal focal shift vs field, on the device of the
    optic's build (the CUDA card unless `device="cpu"`).

    data[k] = (tangential, sagittal) tensors of z-intersections relative to
    the image plane, one pair per wavelength. Each comes from a parabasal
    pair split by +-delta in the pupil, whose crossing is rounding-bound (a
    float32 trace resolves directions to ~1e-7, the pair differs by
    ~delta)."""

    def __init__(self, optic, wavelengths="all", num_points: int = 128,
                 delta: float = 1e-5, device=None):
        self.optic = optic
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        self.num_points = num_points

        n = num_points
        _, params = optic.build(device=device)
        Hy = linspace(0.0, 1.0, n, params.cv).repeat_interleave(2)
        Hx = torch.zeros_like(Hy)
        pm = like(np.tile([-delta, delta], n), params)
        zero = torch.zeros_like(Hy)

        self.data = []
        for w in self.wavelengths:
            # tangential: the pair split in Py; sagittal: in Px
            ht = optic.trace_generic(Hx, Hy, zero, pm, wavelength=w,
                                     device=device)
            hs = optic.trace_generic(Hx, Hy, pm, zero, wavelength=w,
                                     device=device)
            self.data.append((_focus_shift(ht, "y"), _focus_shift(hs, "x")))

    def view(self, figsize=(7, 5.5)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        field = np.linspace(0, self.optic.fields.max_field, self.num_points)
        for k, w in enumerate(self.wavelengths):
            t, s = (a.detach().cpu().numpy() for a in self.data[k])
            ax.plot(t, field, label=f"T {w:.4f} um")
            ax.plot(s, field, "--", label=f"S {w:.4f} um")
        ax.axvline(0, color="k", lw=1)
        ax.set_xlabel("Focal shift (mm)")
        ax.set_ylabel("Field")
        ax.legend()
        ax.grid(True)
        return fig, ax
