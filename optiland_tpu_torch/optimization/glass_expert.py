"""GlassExpert: greedy categorical glass search + continuous refinement.

Port of `optiland_tpu/optimization/glass_expert.py`, the counterpart of the
reference's `optimizer/scipy/glass_expert.py:39-365` (CODE V Glass-Expert
style): each surface's glass is a categorical variable over the catalog;
global exploration over a k-means-downsampled (n_d, V_d) pool, then
nearest-neighbour passes, each candidate evaluated by substituting the
glass (a rebuild: new static codes) and a short continuous refinement;
kept if the merit improves.

On the card a candidate whose dispersion formula, coefficient count or
absorption differs from every glass tried before needs a K7 variant of
its own (`trace.fused.history_defines`), which nvcc builds at its first
launch.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_tpu_torch.materials import catalog as cat
from optiland_tpu_torch.materials.dispersion import material_index
from optiland_tpu_torch.optimization.optimizers import OptimizerGeneric


def get_nd_vd(spec) -> tuple[float, float]:
    """d-line index and Abbe number of a MaterialSpec."""
    m = cat.resolve_material(spec)
    coeffs = torch.tensor(m.coefficients, dtype=torch.float64)

    def n(w):
        return float(material_index(m.formula, m.n_coeffs, coeffs, w))

    nd = n(0.5876)
    nf = n(0.4861)
    nc = n(0.6563)
    vd = (nd - 1.0) / max(nf - nc, 1e-12)
    return nd, vd


def downsample_glass_map(glass_dict: dict, num_glasses_to_keep: int) -> dict:
    """K-means downsampling in (n_d, V_d) space (reference
    `materials/material_utils.py`): keep the glass nearest each centroid."""
    names = list(glass_dict)
    if len(names) <= num_glasses_to_keep:
        return dict(glass_dict)
    pts = np.asarray([glass_dict[g] for g in names], float)
    # normalize axes
    mu, sd = pts.mean(0), pts.std(0) + 1e-12
    z = (pts - mu) / sd
    rng = np.random.default_rng(0)
    centroids = z[rng.choice(len(z), num_glasses_to_keep, replace=False)]
    for _ in range(12):
        d = ((z[:, None, :] - centroids[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in range(num_glasses_to_keep):
            sel = z[assign == k]
            if len(sel):
                centroids[k] = sel.mean(0)
    keep = set()
    for k in range(num_glasses_to_keep):
        d = ((z - centroids[k]) ** 2).sum(-1)
        keep.add(names[int(d.argmin())])
    return {g: glass_dict[g] for g in keep}


class GlassExpert(OptimizerGeneric):
    def __init__(self, problem, glass_surfaces: list[int],
                 glass_selection: list[str] | None = None,
                 num_neighbours: int = 5, pool_size: int = 10,
                 verbose: bool = True):
        super().__init__(problem)
        self.glass_surfaces = glass_surfaces
        self.glass_selection = glass_selection or cat.catalog_names()
        self.num_neighbours = num_neighbours
        self.pool_size = pool_size
        self.verbose = verbose
        self._nd_vd = {g: get_nd_vd(g) for g in self.glass_selection}

    def vprint(self, *a, **k):
        if self.verbose:
            print(*a, **k)

    def _merit(self) -> float:
        with torch.no_grad():
            return float(self.problem.sum_squared())

    def _refine(self, maxiter: int = 30) -> float:
        if self.problem.variables:
            OptimizerGeneric(self.problem).optimize(maxiter=maxiter,
                                                    disp=False)
        return self._merit()

    def _substitute(self, surface_number: int, glass: str):
        optic = self.problem.optic
        optic.surfaces.specs[surface_number].material = cat.resolve_material(
            glass)
        optic._dirty()
        self.problem._compiled = None

    def _current_glass(self, surface_number: int) -> str:
        return self.problem.optic.surfaces.specs[surface_number].material.name

    def _try_pool(self, surface_number: int, pool) -> None:
        best = self._refine()
        best_glass = self._current_glass(surface_number)
        best_params = self.problem.optic.params
        for glass in pool:
            if glass.lower() == str(best_glass).lower():
                continue
            self._substitute(surface_number, glass)
            val = self._refine()
            if val < best:
                self.vprint(f"  surface {surface_number}: {glass} "
                            f"improves merit {best:.4e} -> {val:.4e}")
                best, best_glass = val, glass
                best_params = self.problem.optic.params
        self._substitute(surface_number, best_glass)
        self.problem.optic.update_params(
            best_params if best_glass == self._current_glass(surface_number)
            else self.problem.optic.params
        )
        self._refine()

    def optimize(self, maxiter: int = 100, disp: bool = True):
        self.verbose = disp
        # pass 1: global exploration over the downsampled catalog
        self.vprint("Global exploration")
        pool = downsample_glass_map(self._nd_vd, self.pool_size)
        for s in self.glass_surfaces:
            self._try_pool(s, list(pool))
        # pass 2: nearest-neighbour refinement
        self.vprint("Neighbour refinement")
        for s in self.glass_surfaces:
            cur = self._current_glass(s)
            try:
                nd0, vd0 = get_nd_vd(cur)
            except KeyError:
                continue
            d = {g: (nd - nd0) ** 2 * 1e4 + ((vd - vd0) / 60.0) ** 2
                 for g, (nd, vd) in self._nd_vd.items()}
            neighbours = sorted(d, key=d.get)[: self.num_neighbours + 1]
            self._try_pool(s, neighbours)
        # final polish
        res = (OptimizerGeneric(self.problem).optimize(maxiter=maxiter,
                                                       disp=False)
               if self.problem.variables else None)
        self.vprint(f"Final merit: {self._merit():.4e}")
        return res
