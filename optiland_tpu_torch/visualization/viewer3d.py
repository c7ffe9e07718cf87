"""3-D system visualization (port of
`optiland_tpu/visualization/viewer3d.py`).

Counterpart of the reference's `visualization/system/optic_viewer_3d.py`
(+ `system/lens.py` Lens3D, `system/rays.py` Rays3D). The scene is built
backend-independently by `build_scene()` — surface-of-revolution meshes in
their true global placement (tilt/decenter/absolute-CS), cylindrical lens
edge walls between glass surfaces, and traced ray polylines per field —
then rendered by matplotlib 3-D axes (default, headless-safe) or by VTK
(`backend="vtk"`, the reference's interactive scene) when importable.
The rays are traced, and the sags evaluated, on the viewer's `device`
(None: the CUDA card).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from optiland_tpu_torch.system.spec import positions_of
from optiland_tpu_torch.visualization.themes import (get_active_theme,
                                                     resolve_theme)
from optiland_tpu_torch.visualization.viewer import (_np, is_glass_after,
                                                     placement, surface_sag)


@dataclass
class Scene3D:
    """Backend-independent scene description."""

    # (X, Y, Z) global meshes + kind in {"glass", "mirror", "surface"}
    surfaces: list = field(default_factory=list)
    # (X, Y, Z) quad meshes of cylindrical lens edge walls
    edges: list = field(default_factory=list)
    # (x, y, z) polylines grouped with their field index
    rays: list = field(default_factory=list)
    extent_z: tuple = (0.0, 1.0)
    extent_r: float = 1.0


class OpticViewer3D:
    """3-D render of surfaces + lens solids + ray bundles; rays traced on
    `device` (None: the CUDA card)."""

    def __init__(self, optic, device=None):
        self.optic = optic
        self.device = device

    def _build(self):
        return self.optic.build(device=self.device)

    # -- geometry ----------------------------------------------------------
    def _placement(self, k):
        return placement(*self._build(), k)

    def _surface_mesh(self, k, semi, n_r=24, n_t=49):
        """Global (X, Y, Z) mesh of surface k over its clear semi-diameter
        (freeforms are sampled on the polar grid, not revolved)."""
        static, params = self._build()
        r = np.linspace(0.0, max(float(semi), 1e-6), n_r)
        t = np.linspace(0.0, 2.0 * np.pi, n_t)
        R_, T_ = np.meshgrid(r, t)
        X = R_ * np.cos(T_)
        Y = R_ * np.sin(T_)
        Z = surface_sag(static, params, k, X.ravel(),
                        Y.ravel()).reshape(X.shape)
        R, tvec = self._placement(k)
        P = np.stack([X.ravel(), Y.ravel(), Z.ravel()])
        Pg = R @ P + tvec[:, None]
        return (Pg[0].reshape(X.shape), Pg[1].reshape(X.shape),
                Pg[2].reshape(X.shape))

    def _edge_wall(self, k, semi1, semi2, n_t=49):
        """Cylindrical wall joining the rims of surfaces k and k+1 (the
        lens edge of `lens.py:_extend_surface`, revolved)."""
        static, params = self._build()
        smax = max(semi1, semi2)
        t = np.linspace(0.0, 2.0 * np.pi, n_t)
        walls = []
        for kk, s in ((k, semi1), (k + 1, semi2)):
            x = smax * np.cos(t)
            y = smax * np.sin(t)
            zr = surface_sag(static, params, kk, s * np.cos(t),
                             s * np.sin(t))
            R, tv = self._placement(kk)
            P = R @ np.stack([x, y, zr]) + tv[:, None]
            walls.append(P)
        A, B = walls
        X = np.stack([A[0], B[0]])
        Y = np.stack([A[1], B[1]])
        Z = np.stack([A[2], B[2]])
        return X, Y, Z

    def _semi_apertures(self):
        sa = getattr(self.optic, "semi_apertures", None)
        if sa is None:
            sa = self.optic.update_paraxial()
        return np.asarray(sa)

    def _is_glass_after(self, k):
        return is_glass_after(self.optic, self._build()[0], k)

    # -- scene -------------------------------------------------------------
    def build_scene(self, fields="all", wavelengths="primary",
                    num_rays: int = 24, distribution: str = "ring") -> Scene3D:
        optic = self.optic
        static, params = self._build()
        S = static.num_surfaces
        semi = self._semi_apertures()
        scene = Scene3D()

        for k in range(1, S):
            X, Y, Z = self._surface_mesh(k, semi[k] * 1.05)
            if static.is_reflective[k]:
                kind = "mirror"
            elif self._is_glass_after(k) or (k > 1 and
                                             self._is_glass_after(k - 1)):
                kind = "glass"
            else:
                kind = "surface"
            scene.surfaces.append((X, Y, Z, kind))
            if (k < S - 1 and static.interactions[k] == 0
                    and not static.is_reflective[k]
                    and self._is_glass_after(k)):
                scene.edges.append(self._edge_wall(
                    k, semi[k] * 1.05, semi[k + 1] * 1.05))

        from optiland_tpu_torch.analysis.base import resolve_fields

        field_list = resolve_fields(optic, fields)
        wl = (optic.primary_wavelength if wavelengths == "primary"
              else wavelengths)
        for fi, f in enumerate(field_list):
            hist = optic.trace(Hx=f[0], Hy=f[1], wavelength=wl,
                               num_rays=num_rays, distribution=distribution,
                               device=self.device)
            xs = _np(hist.x)
            ys = _np(hist.y)
            zs = _np(hist.z)
            inten = _np(hist.intensity)
            for r in range(xs.shape[1]):
                alive = inten[:, r] > 0
                scene.rays.append((xs[alive, r], ys[alive, r],
                                   zs[alive, r], fi))

        pos = _np(positions_of(static, params))
        zmin = min(0.0, float(np.min([s[2].min() for s in scene.surfaces])))
        zmax = max(float(pos[-1]),
                   float(np.max([s[2].max() for s in scene.surfaces])))
        scene.extent_z = (zmin, zmax)
        scene.extent_r = float(semi.max() * 1.2)
        return scene

    # -- matplotlib render -------------------------------------------------
    def view(self, fields="all", wavelengths="primary", num_rays: int = 24,
             distribution: str = "ring", figsize=(9, 6), elev: float = 20.0,
             azim: float = -60.0, backend: str = "matplotlib", theme=None):
        scene = self.build_scene(fields, wavelengths, num_rays, distribution)
        if backend == "vtk":
            return self.render_vtk(scene)
        import matplotlib.pyplot as plt

        th = resolve_theme(theme) if theme is not None else get_active_theme()
        pal = th.palette
        fig = plt.figure(figsize=figsize)
        fig.patch.set_facecolor(pal["background"])
        ax = fig.add_subplot(projection="3d")
        ax.set_facecolor(pal["background"])

        colors = {"glass": pal["lens"], "mirror": pal["mirror"],
                  "surface": pal["edges"]}
        for X, Y, Z, kind in scene.surfaces:
            ax.plot_surface(Z, X, Y, alpha=0.35, color=colors[kind],
                            linewidth=0, antialiased=False)
        for X, Y, Z in scene.edges:
            ax.plot_surface(Z, X, Y, alpha=0.25, color=pal["lens"],
                            linewidth=0, antialiased=False)
        cycle = th.ray_cycle
        for x, y, z, fi in scene.rays:
            ax.plot(z, x, y, color=cycle[fi % len(cycle)], linewidth=0.6,
                    alpha=0.8)

        ax.set_xlabel("Z (mm)")
        ax.set_ylabel("X (mm)")
        ax.set_zlabel("Y (mm)")
        for axis_label in (ax.xaxis, ax.yaxis, ax.zaxis):
            axis_label.label.set_color(pal["text"])
        ax.tick_params(colors=pal["axis"])
        ax.view_init(elev=elev, azim=azim)
        zspan = max(scene.extent_z[1] - scene.extent_z[0], 1e-6)
        rspan = max(scene.extent_r * 2.0, 1e-6)
        ax.set_box_aspect((zspan, rspan, rspan))
        return fig, ax

    # -- VTK render --------------------------------------------------------
    def render_vtk(self, scene: Scene3D | None = None):
        """Build a vtkRenderer from the scene (the reference's default
        backend, `optic_viewer_3d.py`). Requires a real vtk package."""
        try:
            import vtk
        except ImportError as e:  # pragma: no cover - vtk optional
            raise ImportError(
                "backend='vtk' requires the vtk package; use the default "
                "matplotlib backend instead") from e
        if not hasattr(vtk, "vtkRenderer"):  # mocked/broken install
            raise ImportError("vtk import did not provide vtkRenderer")
        if scene is None:
            scene = self.build_scene()

        renderer = vtk.vtkRenderer()
        for mesh in list(scene.surfaces) + [
                (X, Y, Z, "glass") for (X, Y, Z) in scene.edges]:
            X, Y, Z, kind = mesh
            points = vtk.vtkPoints()
            n_t, n_r = X.shape
            for i in range(n_t):
                for j in range(n_r):
                    points.InsertNextPoint(float(Z[i, j]), float(X[i, j]),
                                           float(Y[i, j]))
            grid = vtk.vtkStructuredGrid()
            grid.SetDimensions(n_r, n_t, 1)
            grid.SetPoints(points)
            mapper = vtk.vtkDataSetMapper()
            mapper.SetInputData(grid)
            actor = vtk.vtkActor()
            actor.SetMapper(mapper)
            actor.GetProperty().SetOpacity(0.4)
            renderer.AddActor(actor)
        for x, y, z, _fi in scene.rays:
            pts = vtk.vtkPoints()
            lines = vtk.vtkCellArray()
            for i in range(len(x)):
                pts.InsertNextPoint(float(z[i]), float(x[i]), float(y[i]))
            for i in range(len(x) - 1):
                line = vtk.vtkLine()
                line.GetPointIds().SetId(0, i)
                line.GetPointIds().SetId(1, i + 1)
                lines.InsertNextCell(line)
            poly = vtk.vtkPolyData()
            poly.SetPoints(pts)
            poly.SetLines(lines)
            mapper = vtk.vtkPolyDataMapper()
            mapper.SetInputData(poly)
            actor = vtk.vtkActor()
            actor.SetMapper(mapper)
            renderer.AddActor(actor)
        return renderer
