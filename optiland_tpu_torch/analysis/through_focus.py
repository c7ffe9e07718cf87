"""Through-focus analyses (port of `optiland_tpu/analysis/through_focus.py`).

All focus steps evaluate from ONE trace: rays recorded at the image
surface are re-propagated along their directions to each shifted plane.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import (
    like,
    resolve_fields,
    resolve_wavelengths,
)
from optiland_tpu_torch.analysis.spot import _masked_mean, field_pupil_batch
from optiland_tpu_torch.core import distributions as dist


class ThroughFocusSpotDiagram:
    """RMS spot size at focal planes nominal + k*delta_focus, on the device
    of the optic's build (the CUDA card unless `device="cpu"`).

    data: (num_steps, F, W) RMS radii about each plane's centroid.
    """

    MIN_STEPS, MAX_STEPS = 3, 7

    def __init__(self, optic, delta_focus: float = 0.1, num_steps: int = 5,
                 fields="all", wavelengths="all", num_rings: int = 6,
                 distribution: str = "hexapolar", device=None):
        if num_steps % 2 == 0 or not (self.MIN_STEPS <= num_steps
                                      <= self.MAX_STEPS):
            raise ValueError(
                f"num_steps must be odd and within "
                f"[{self.MIN_STEPS}, {self.MAX_STEPS}]"
            )
        self.optic = optic
        self.delta_focus = delta_focus
        self.num_steps = num_steps
        self.fields = resolve_fields(optic, fields)
        self.wavelengths = resolve_wavelengths(optic, wavelengths)

        _, params = optic.build(device=device)
        out = dist.generate(distribution, num_rings)
        Px, Py = like(out[0], params), like(out[1], params)
        P = Px.shape[0]
        F, W = len(self.fields), len(self.wavelengths)
        Hx, Hy, Pxs, Pys, wl = field_pupil_batch(self.fields,
                                                 self.wavelengths, Px, Py,
                                                 params)
        hist = optic.trace_generic(Hx, Hy, Pxs, Pys, wavelength=wl,
                                   device=device)
        # rays at the image plane; re-propagate by dz along ray directions
        x, y = hist.x[-1], hist.y[-1]
        L, M, N = hist.L[-1], hist.M[-1], hist.N[-1]
        m = (hist.intensity[-1] > 0).to(x.dtype).reshape(F, W, P)

        shifts = (np.arange(num_steps) - num_steps // 2) * delta_focus
        rows = []
        self.spots = []
        for dz in shifts:
            t = float(dz) / N  # advance to plane z + dz
            xs = (x + t * L).reshape(F, W, P)
            ys = (y + t * M).reshape(F, W, P)
            cx = _masked_mean(xs, m)[..., None]
            cy = _masked_mean(ys, m)[..., None]
            rows.append(torch.sqrt(_masked_mean(
                (xs - cx) ** 2 + (ys - cy) ** 2, m, dim=-1)))
            self.spots.append((xs, ys, m))
        self.focus_shifts = shifts
        self.data = torch.stack(rows)

    def rms_spot_radius(self):
        return self.data

    def view(self, figsize=(12, 3)):
        import matplotlib.pyplot as plt

        F = len(self.fields)
        fig, axs = plt.subplots(F, self.num_steps,
                                figsize=(figsize[0], figsize[1] * F),
                                squeeze=False)
        for si in range(self.num_steps):
            xs, ys, mm = (a.detach().cpu().numpy() for a in self.spots[si])
            for fi in range(F):
                ax = axs[fi, si]
                for wi in range(len(self.wavelengths)):
                    sel = mm[fi, wi] > 0
                    ax.scatter(xs[fi, wi][sel], ys[fi, wi][sel], s=1)
                ax.set_title(f"dz={self.focus_shifts[si]:+.3f}", fontsize=7)
                ax.set_aspect("equal")
        fig.tight_layout()
        return fig, axs


class ThroughFocusMTF:
    """Geometric MTF at a single frequency vs focal shift (tangential and
    sagittal), per field (reference `analysis/through_focus_mtf.py`).

    data: (num_steps, F, 2) tensor of (tangential, sagittal) MTFs."""

    def __init__(self, optic, freq: float, delta_focus: float = 0.05,
                 num_steps: int = 7, fields="all", wavelength="primary",
                 num_rays: int = 64, distribution: str = "uniform",
                 device=None):
        from optiland_tpu_torch.mtf.geometric import _lsf_mtf

        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.optic = optic
        self.freq = freq
        self.fields = resolve_fields(optic, fields)
        self.num_steps = num_steps
        self.delta_focus = delta_focus

        _, params = optic.build(device=device)
        out = dist.generate(distribution, num_rays)
        Px, Py = like(out[0], params), like(out[1], params)
        P = Px.shape[0]
        F = len(self.fields)
        hist = optic.trace_generic(
            like([f[0] for f in self.fields], params).repeat_interleave(P),
            like([f[1] for f in self.fields], params).repeat_interleave(P),
            Px.repeat(F), Py.repeat(F), wavelength=wavelength, device=device)
        x, y = hist.x[-1], hist.y[-1]
        L, M, N = hist.L[-1], hist.M[-1], hist.N[-1]
        m = (hist.intensity[-1] > 0).to(x.dtype).reshape(F, P)

        shifts = (np.arange(num_steps) - num_steps // 2) * delta_focus
        freqs = like([freq], params)
        # every step, field and axis in one batch: (steps, F, 2, P)
        t = like(shifts, params)[:, None] / N
        ys = (y + t * M).reshape(num_steps, F, P)
        xs = (x + t * L).reshape(num_steps, F, P)
        self.focus_shifts = shifts
        self.data = _lsf_mtf(torch.stack([ys, xs], dim=2),
                             m[None, :, None].expand(num_steps, F, 2, P)
                             .contiguous(), freqs, 128)[..., 0]

    def view(self, figsize=(7, 4.5)):
        import matplotlib.pyplot as plt

        data = self.data.detach().cpu().numpy()
        fig, ax = plt.subplots(figsize=figsize)
        for fi, field in enumerate(self.fields):
            ax.plot(self.focus_shifts, data[:, fi, 0],
                    label=f"Hy={field[1]:.2f} T")
            ax.plot(self.focus_shifts, data[:, fi, 1], "--",
                    label=f"Hy={field[1]:.2f} S")
        ax.set_xlabel("Focus shift (mm)")
        ax.set_ylabel(f"MTF @ {self.freq:g} cyc/mm")
        ax.legend()
        ax.grid(True)
        return fig, ax
