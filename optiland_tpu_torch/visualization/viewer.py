"""2-D system visualization and info tables (port of
`optiland_tpu/visualization/viewer.py`).

Counterpart of the reference's `visualization/system/optic_viewer.py` (+
`system/lens.py`, `system/rays.py`, `system/mirror.py`): matplotlib lens
cross-section with shaded lens solids, mirror hatching, physical-aperture
overlays, reference-ray modes, vignetted-ray hiding, YZ/XZ projections,
per-field legend, and the theme system (`visualization/themes.py`). Tilted
/ decentered / absolute-CS surfaces are drawn in their true global
placement (fold-mirror chains render correctly). The viewers that trace
or evaluate sags do so on their `device` (None: the CUDA card; K7 in
float32 there), and draw from host copies.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.analysis.base import linspace
from optiland_tpu_torch.geometry import surfaces as G
from optiland_tpu_torch.system.spec import positions_of
from optiland_tpu_torch.visualization.themes import (Theme, get_active_theme,
                                               resolve_theme)

# legacy name kept for back-compat (pre-r5 THEMES dict)
THEMES = {"light": "light", "dark": "dark"}


def _resolve(theme) -> Theme:
    if theme is None:
        return get_active_theme()
    return resolve_theme(theme)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def placement(static, params, k):
    """(R, t): the global rotation matrix and translation of surface k,
    numpy float64."""
    rx, ry, rz = (float(v) for v in _np(params.tilt[k]))
    if static.has_abs_cs:
        t = _np(params.cs_pos[k]).astype(float)
    else:
        dx, dy = (float(v) for v in _np(params.decenter[k]))
        pos = _np(positions_of(static, params))
        t = np.array([dx, dy, float(pos[k])])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx, t


def surface_sag(static, params, k, x, y):
    """Surface k's sag at the numpy points (x, y), evaluated on the build's
    device and dtype; numpy."""
    x, y = (torch.as_tensor(a, dtype=params.cv.dtype, device=params.cv.device)
            for a in (x, y))
    return _np(G.sag(static.geom_codes[k], static.geom_n_coeffs[k], x, y,
                     params.cv[k], params.conic[k], params.coeffs[k],
                     aux=static.geom_aux[k]))


def is_glass_after(optic, static, k):
    """Whether the medium after surface k is a glass (not air, not a
    mirror's)."""
    from optiland_tpu_torch.materials.dispersion import FORMULA_IDEAL

    if static.is_reflective[k]:
        return False
    m = optic.surfaces.specs[k].material
    return not (m.formula == FORMULA_IDEAL
                and m.coefficients[0] == 1.0 and m.k_table is None)


class OpticViewer:
    """Cross-section plot: lens solids, ray paths, apertures, mirrors; rays
    traced on `device` (None: the CUDA card)."""

    def __init__(self, optic, device=None):
        self.optic = optic
        self.device = device

    def _build(self):
        return self.optic.build(device=self.device)

    # -- geometry helpers --------------------------------------------------
    def _placement(self, k):
        """(R, t): global rotation matrix and translation of surface k."""
        return placement(*self._build(), k)

    def _surface_profile(self, k, semi, n_pts=64, projection="YZ"):
        """Global-frame polyline of surface k: (transverse, z) arrays."""
        static, params = self._build()
        tcoord = _np(linspace(-semi, semi, n_pts, params.cv))
        zero = np.zeros_like(tcoord)
        if projection == "YZ":
            xl, yl = zero, tcoord
        else:
            xl, yl = tcoord, zero
        zl = surface_sag(static, params, k, xl, yl)
        P = np.stack([xl, yl, zl])
        R, t = self._placement(k)
        Pg = R @ P + t[:, None]
        trans = Pg[1] if projection == "YZ" else Pg[0]
        return trans, Pg[2]

    def _semi(self, k, max_y):
        spec = self.optic.surfaces.specs[k]
        if isinstance(spec.semi_aperture, (int, float)):
            return float(spec.semi_aperture), True
        return max(float(max_y[k]) * 1.1, 1e-6), False

    def _is_glass_after(self, k):
        return is_glass_after(self.optic, self._build()[0], k)

    # -- main render -------------------------------------------------------
    def view(self, fields="all", wavelengths="primary", num_rays: int = 3,
             distribution: str | None = None, figsize=(10, 4), title=None,
             reference=None, theme=None, projection: str = "YZ",
             show_apertures: bool = True, hide_vignetted: bool = False,
             show_legend: bool = True, xlim=None, ylim=None):
        """Cross-section render (reference `optic_viewer.py:47-171`).

        Args:
            reference: None | "chief" | "marginal" | "chief_and_marginal" —
                dashed reference-ray overlays per field.
            theme: theme name / Theme / None (active theme).
            projection: "YZ" (default) or "XZ".
            show_apertures: overlay physical-aperture marks.
            hide_vignetted: drop rays whose final intensity is zero instead
                of fading them.
            xlim / ylim: explicit axis limits.
        """
        import matplotlib.pyplot as plt

        if projection not in ("YZ", "XZ"):
            raise ValueError("projection must be 'YZ' or 'XZ'")
        if distribution is None:
            distribution = "line_y" if projection == "YZ" else "line_x"
        optic = self.optic
        static, params = self._build()
        S = static.num_surfaces
        th = _resolve(theme)
        pal = th.palette

        fig, ax = plt.subplots(figsize=figsize)
        th.apply_to_axes(fig, ax)
        ax.grid(False)

        # -- ray fans per field ------------------------------------------
        from optiland_tpu_torch.analysis.base import resolve_fields

        field_list = resolve_fields(optic, fields)
        wl = (optic.primary_wavelength if wavelengths == "primary"
              else wavelengths)
        max_t = np.zeros(S)
        cycle = th.ray_cycle
        tr_idx = 1 if projection == "YZ" else 0  # transverse component
        for fi, field in enumerate(field_list):
            color = cycle[fi % len(cycle)]
            hist = optic.trace(Hx=field[0], Hy=field[1], wavelength=wl,
                               num_rays=num_rays, distribution=distribution,
                               device=self.device)
            ts = _np(hist.y if projection == "YZ" else hist.x)
            zs = _np(hist.z)
            inten = _np(hist.intensity)
            max_t = np.maximum(max_t, np.abs(_np(hist.y)).max(axis=1))
            first = True
            for r in range(ts.shape[1]):
                alive = bool(inten[-1, r] > 0)
                if hide_vignetted and not alive:
                    continue
                label = None
                if first and show_legend:
                    label = (f"Hx={field[0]:g}, Hy={field[1]:g}"
                             if field[0] else f"Hy={field[1]:g}")
                    first = False
                ax.plot(zs[1:, r], ts[1:, r], color=color, lw=0.7,
                        alpha=0.9 if alive else 0.25, label=label)

            # reference-ray overlays (dashed): chief = pupil center,
            # marginal = pupil edge (reference optic_viewer modes)
            ref_pupils = []
            if reference in ("chief", "chief_and_marginal"):
                ref_pupils.append(0.0)
            if reference in ("marginal", "chief_and_marginal"):
                ref_pupils.append(1.0)
            for pr in ref_pupils:
                pp = ([0.0], [pr]) if projection == "YZ" else ([pr], [0.0])
                rh = optic.trace(Hx=field[0], Hy=field[1], wavelength=wl,
                                 num_rays=1, distribution=pp,
                                 device=self.device)
                rts = _np(rh.y if projection == "YZ" else rh.x)
                ax.plot(_np(rh.z)[1:, 0], rts[1:, 0],
                        color=color, lw=1.4, ls="--")

        # -- lens solids (shaded glass regions) ---------------------------
        profiles = {}
        semis = {}
        for k in range(1, S):
            semis[k] = self._semi(k, max_t)
            profiles[k] = self._surface_profile(k, semis[k][0],
                                                projection=projection)
        for k in range(1, S - 1):
            if static.interactions[k] != 0 or static.is_reflective[k]:
                continue
            if not self._is_glass_after(k):
                continue
            s1, s2 = semis[k][0], semis[k + 1][0]
            smax = max(s1, s2)
            t1, z1 = profiles[k]
            t2, z2 = profiles[k + 1]
            # cylindrical edge extension to the common extent (reference
            # `lens.py:_extend_surface`)
            poly_t = np.concatenate([
                [-smax], t1, [smax],
                [smax], t2[::-1], [-smax]])
            poly_z = np.concatenate([
                [z1[0]], z1, [z1[-1]],
                [z2[-1]], z2[::-1], [z2[0]]])
            ax.fill(poly_z, poly_t, color=pal["lens"], alpha=0.8,
                    zorder=0.5, linewidth=0)

        # -- surface profiles, mirrors, apertures -------------------------
        for k in range(1, S):
            tt, zz = profiles[k]
            semi, has_ap = semis[k]
            if static.is_reflective[k]:
                ax.plot(zz, tt, color=pal["mirror"], lw=2.2)
                # hatch ticks on the back of the mirror (reference
                # `mirror.py` hatching)
                R, _ = self._placement(k)
                back = R @ np.array([0.0, 0.0, 1.0])
                step = max(len(tt) // 12, 1)
                dlen = semi * 0.08
                for i in range(0, len(tt), step):
                    bt = back[1] if projection == "YZ" else back[0]
                    ax.plot([zz[i], zz[i] + back[2] * dlen],
                            [tt[i], tt[i] + bt * dlen],
                            color=pal["mirror"], lw=0.8)
            else:
                ax.plot(zz, tt, color=pal["edges"], lw=1.2)
            if has_ap and show_apertures:
                # aperture marks just past the clear aperture (reference
                # aperture overlays)
                for end in (0, -1):
                    sgn = -1.0 if end == 0 else 1.0
                    R, _ = self._placement(k)
                    up = R @ (np.array([0.0, sgn, 0.0])
                              if projection == "YZ"
                              else np.array([sgn, 0.0, 0.0]))
                    ut = up[1] if projection == "YZ" else up[0]
                    ax.plot([zz[end], zz[end] + up[2] * semi * 0.15],
                            [tt[end], tt[end] + ut * semi * 0.15],
                            color=pal["aperture"], lw=2.5)

        # -- lens edges for glass gaps ------------------------------------
        for k in range(1, S - 1):
            if static.interactions[k] == 0 and not static.is_reflective[k] \
                    and self._is_glass_after(k):
                t1, z1 = profiles[k]
                t2, z2 = profiles[k + 1]
                for end in (0, -1):
                    ax.plot([z1[end], z2[end]], [t1[end], t2[end]],
                            color=pal["edges"], lw=1.0)

        ax.set_xlabel("z (mm)")
        ax.set_ylabel(("y" if projection == "YZ" else "x") + " (mm)")
        ax.set_title(title or optic.name)
        if xlim is not None:
            ax.set_xlim(xlim)
        if ylim is not None:
            ax.set_ylim(ylim)
        if xlim is None and ylim is None:
            ax.set_aspect("equal", adjustable="datalim")
        if show_legend and field_list:
            leg = ax.legend(loc="upper right", fontsize=8,
                            facecolor=pal["background"],
                            edgecolor=pal["grid"])
            for txt in leg.get_texts():
                txt.set_color(pal["text"])
        fig.tight_layout()
        return fig, ax


class LensInfoViewer:
    """Prescription table (reference LensInfoViewer)."""

    def __init__(self, optic):
        self.optic = optic

    def table_rows(self):
        optic = self.optic
        rows = []
        for i, s in enumerate(optic.surfaces.specs):
            kind = ("Object" if i == 0
                    else "Image" if i == len(optic.surfaces.specs) - 1
                    else s.surface_type if s.surface_type != "standard"
                    else s.geometry)
            rows.append({
                "index": i,
                "type": kind + (" (stop)" if s.is_stop else ""),
                "radius": s.radius,
                "thickness": s.thickness,
                "conic": s.conic,
                "material": s.material.name or "air",
                "semi-aperture": s.semi_aperture,
                "comment": s.comment,
            })
        return rows

    def view(self):
        rows = self.table_rows()
        hdr = (f"{'#':>3} {'type':16} {'radius':>12} {'thickness':>12} "
               f"{'conic':>8} {'material':14} {'semi-ap':>8}")
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            sa = ("-" if r["semi-aperture"] is None
                  else f"{r['semi-aperture']:.3f}")
            print(f"{r['index']:>3} {r['type']:16} {r['radius']:>12.5g} "
                  f"{r['thickness']:>12.5g} {r['conic']:>8.4g} "
                  f"{r['material']:14} {sa:>8}")
        return rows


class SurfaceSagViewer:
    """Sag map + cross-sections of one surface (reference
    `visualization/surface_sag_viewer.py`), evaluated on `device` (None:
    the CUDA card)."""

    def __init__(self, optic, device=None):
        self.optic = optic
        self.device = device

    def sag_grid(self, surface_index: int, semi: float | None = None,
                 n: int = 64):
        static, params = self.optic.build(device=self.device)
        k = surface_index
        if semi is None:
            spec = self.optic.surfaces.specs[k]
            semi = (spec.semi_aperture
                    if isinstance(spec.semi_aperture, (int, float)) else 10.0)
        lin = _np(linspace(-semi, semi, n, params.cv))
        X, Y = np.meshgrid(lin, lin)
        Z = surface_sag(static, params, k, X.ravel(), Y.ravel())
        return X, Y, Z.reshape(n, n), float(semi)

    def view(self, surface_index: int, semi: float | None = None,
             n: int = 64, figsize=(10, 4)):
        import matplotlib.pyplot as plt

        X, Y, Z, semi = self.sag_grid(surface_index, semi, n)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=figsize)
        im = ax1.imshow(Z, extent=[-semi, semi, -semi, semi],
                        origin="lower", cmap="viridis")
        fig.colorbar(im, ax=ax1, label="sag (mm)")
        ax1.set_title(f"surface {surface_index} sag")
        ax1.set_xlabel("x (mm)")
        ax1.set_ylabel("y (mm)")
        mid = Z.shape[0] // 2
        ax2.plot(X[mid], Z[mid], label="y = 0")
        ax2.plot(Y[:, mid], Z[:, mid], "--", label="x = 0")
        ax2.set_xlabel("coordinate (mm)")
        ax2.set_ylabel("sag (mm)")
        ax2.legend()
        ax2.grid(True)
        fig.tight_layout()
        return fig, (ax1, ax2)
