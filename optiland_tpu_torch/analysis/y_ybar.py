"""Y-Ybar diagram (port of `optiland_tpu/analysis/y_ybar.py`)."""

from __future__ import annotations

from optiland_tpu_torch.system import paraxial as px


class YYbar:
    """Marginal vs chief paraxial ray heights per surface, on the device of
    the optic's build (the CUDA card unless `device="cpu"`)."""

    def __init__(self, optic, wavelength="primary", device=None):
        self.optic = optic
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.wavelength = float(wavelength)
        static, params = optic.build(device=device)
        ya, _ = px.marginal_ray(static, params, self.wavelength)
        yb, _ = px.chief_ray(static, params, self.wavelength)
        self.data = {"ya": ya.ravel(), "yb": yb.ravel()}

    def view(self, figsize=(7, 5.5)):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        ya = self.data["ya"].detach().cpu().numpy()
        yb = self.data["yb"].detach().cpu().numpy()
        ax.plot(yb, ya, "o-")
        for i, (xb, xa) in enumerate(zip(yb, ya)):
            ax.annotate(str(i), (xb, xa))
        ax.set_xlabel("Chief ray height")
        ax.set_ylabel("Marginal ray height")
        ax.grid(True)
        return fig, ax
