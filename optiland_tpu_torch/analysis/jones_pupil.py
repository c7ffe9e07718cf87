"""Jones pupil map (port of `optiland_tpu/analysis/jones_pupil.py`): the
2x2 Jones matrix of the full system across the exit-pupil grid, from a
polarized trace's PRT matrices projected into the dipole local basis."""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import like, resolve_wavelengths
from optiland_tpu_torch.polarization import PolarizationState
from optiland_tpu_torch.trace.tracer import trace_system


class JonesPupil:
    """data[k] = {"Px", "Py", "J"} per wavelength, J (grid_size^2, 2, 2)
    complex, on the device of the optic's build (the CUDA card unless
    `device="cpu"`). The polarized trace is eager there, as JAX's gate
    keeps it from the kernels."""

    def __init__(self, optic, field=(0, 0), wavelengths="all",
                 grid_size: int = 32, device=None):
        self.optic = optic
        self.field = field
        self.wavelengths = resolve_wavelengths(optic, wavelengths)
        self.grid_size = grid_size
        static, params = optic.build(device=device)

        lin = np.linspace(-1.0, 1.0, grid_size)
        PX, PY = np.meshgrid(lin, lin)
        Px, Py = PX.ravel(), PY.ravel()
        args = tuple(like(a, params) for a in (
            np.full_like(Px, field[0]), np.full_like(Px, field[1]), Px, Py))

        self.data = []
        for w in self.wavelengths:
            hist = trace_system(
                static, params, *args, like(w, params),
                polarization=PolarizationState(True, 1.0, 0.0, 0.0, 0.0),
            )
            k = torch.stack([hist.L[-1], hist.M[-1], hist.N[-1]], dim=-1)
            k = k / torch.linalg.norm(k, dim=-1, keepdim=True)
            x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=k.dtype,
                                  device=k.device).expand_as(k)
            v = torch.linalg.cross(k, x_axis)
            v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-15)
            u = torch.linalg.cross(v, k)
            u = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-15)

            P_x_in = hist.p[:, :, 0]
            P_y_in = hist.p[:, :, 1]
            uc = u.to(hist.p.dtype)
            vc = v.to(hist.p.dtype)
            J = torch.stack([
                torch.stack([torch.sum(uc * P_x_in, dim=-1),
                             torch.sum(uc * P_y_in, dim=-1)], dim=-1),
                torch.stack([torch.sum(vc * P_x_in, dim=-1),
                             torch.sum(vc * P_y_in, dim=-1)], dim=-1)],
                dim=-2)
            self.data.append({"Px": Px, "Py": Py, "J": J})

    def view(self, wavelength_index: int = 0, figsize=(9, 8)):
        import matplotlib.pyplot as plt

        d = self.data[wavelength_index]
        J = d["J"].detach().cpu().numpy().reshape(self.grid_size,
                                                  self.grid_size, 2, 2)
        fig, axs = plt.subplots(2, 2, figsize=figsize)
        labels = [["|Jxx|", "|Jxy|"], ["|Jyx|", "|Jyy|"]]
        for i in range(2):
            for j in range(2):
                im = axs[i, j].imshow(np.abs(J[:, :, i, j]),
                                      extent=(-1, 1, -1, 1), origin="lower")
                axs[i, j].set_title(labels[i][j])
                fig.colorbar(im, ax=axs[i, j])
        fig.tight_layout()
        return fig, axs
