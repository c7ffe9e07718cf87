"""MTF vs field (port of `optiland_tpu/analysis/mtf_vs_field.py`):
tangential and sagittal geometric MTF at chosen spatial frequencies swept
over field height, from one batched trace."""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import like
from optiland_tpu_torch.core import distributions as dist


class MTFvsField:
    """data: {"tangential", "sagittal"}, each a (num_fields, len(freqs))
    tensor on the device of the optic's build (the CUDA card unless
    `device="cpu"`)."""

    def __init__(self, optic, freqs=(10.0, 30.0), num_fields: int = 16,
                 wavelength="primary", num_rays: int = 64,
                 distribution: str = "uniform", device=None):
        from optiland_tpu_torch.mtf.geometric import _lsf_mtf

        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.optic = optic
        self.freqs = list(freqs)
        self.num_fields = num_fields

        _, params = optic.build(device=device)
        out = dist.generate(distribution, num_rays)
        Px, Py = like(out[0], params), like(out[1], params)
        P = Px.shape[0]
        hys = np.linspace(0.0, 1.0, num_fields)
        hist = optic.trace_generic(
            like(np.zeros(num_fields * P), params),
            like(hys, params).repeat_interleave(P), Px.repeat(num_fields),
            Py.repeat(num_fields), wavelength=wavelength, device=device)
        x = hist.x[-1].reshape(num_fields, P)
        y = hist.y[-1].reshape(num_fields, P)
        m = (hist.intensity[-1] > 0).to(x.dtype).reshape(num_fields, P)

        # both axes of every field in one batch: (num_fields, 2, P)
        mtf = _lsf_mtf(torch.stack([y, x], dim=1),
                       m[:, None].expand(-1, 2, -1).contiguous(),
                       like(self.freqs, params), 128)
        self.fields_hy = hys
        self.data = {"tangential": mtf[:, 0], "sagittal": mtf[:, 1]}

    def view(self, figsize=(7, 4.5)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        hy = self.fields_hy * self.optic.fields.max_field
        tan, sag = (self.data[k].detach().cpu().numpy()
                    for k in ("tangential", "sagittal"))
        for j, f in enumerate(self.freqs):
            ax.plot(hy, tan[:, j], label=f"{f:g} cyc/mm T")
            ax.plot(hy, sag[:, j], "--", label=f"{f:g} cyc/mm S")
        ax.set_xlabel("Field")
        ax.set_ylabel("MTF")
        ax.set_ylim(0, 1)
        ax.legend()
        ax.grid(True)
        return fig, ax
