"""Thin-film design optimization: spectral operands, optimizer, needle
synthesis.

Port of `optiland_tpu/thin_film/optimization.py`: the merit is one torch
function of the layer-thickness vector; its value and gradient (autograd)
drive scipy's L-BFGS-B at a float64 numpy boundary, on the device the
optimizer was given (None: the CUDA card). Needle synthesis scores every
trial insertion with the same merit and re-optimizes the winner.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.materials.catalog import resolve_material
from optiland_tpu_torch.thin_film.core import tmm_coh
from optiland_tpu_torch.thin_film.stack import Layer, ThinFilmStack

__all__ = ["ThinFilmOptimizer", "NeedleSynthesis", "NeedleSynthesisResult"]


def _stack_rta(stack: ThinFilmStack, thicknesses_um, w_um, aoi_rad,
               pol: str):
    """(R, T, A) of the stack with its layer thicknesses replaced by the
    tensor `thicknesses_um`, (L,) or a batch (B, L): the differentiable
    evaluation path. A batch broadcasts against the spectral grid to
    (B, K)."""
    n0, ns = stack._indices(w_um)
    layer_n = [lay.n_complex(w_um) for lay in stack.layers]
    layer_d = [thicknesses_um[..., i, None] for i in range(len(stack.layers))]

    def one(p):
        return tmm_coh(n0, ns, layer_n, layer_d, w_um, aoi_rad, p)[2:]

    if pol in ("s", "p"):
        return one(pol)
    Rs, Ts, As = one("s")
    Rp, Tp, Ap = one("p")
    return (Rs + Rp) / 2, (Ts + Tp) / 2, (As + Ap) / 2


@dataclass(frozen=True)
class SpectralOperand:
    """One R/T/A target over a wavelength/AOI grid."""

    prop: str  # 'R' | 'T' | 'A'
    wavelength_nm: tuple
    aoi_deg: tuple
    polarization: str  # 's' | 'p' | 'u'
    target_type: str  # 'equal' | 'below' | 'over'
    value: tuple
    weight: float = 1.0
    tolerance: float = 1e-6

    def grid(self, like):
        """(wavelengths in um, AOIs in rad) on `like`'s device and dtype."""
        kw = dict(dtype=like.dtype, device=like.device)
        return (torch.tensor(self.wavelength_nm, **kw) * 1e-3,
                torch.deg2rad(torch.tensor(self.aoi_deg, **kw)))

    def values(self, stack, thicknesses_um):
        R, T, A = _stack_rta(stack, thicknesses_um,
                             *self.grid(thicknesses_um), self.polarization)
        return {"R": R, "T": T, "A": A}[self.prop]

    def residuals(self, stack, thicknesses_um):
        val = self.values(stack, thicknesses_um)
        tgt = torch.tensor(self.value, dtype=val.dtype, device=val.device)
        if self.target_type == "equal":
            d = val - tgt
            d = torch.where(torch.abs(d) <= self.tolerance,
                            torch.zeros_like(d), d)
        elif self.target_type == "below":
            d = torch.clamp(val - tgt, min=0.0)
        elif self.target_type == "over":
            d = torch.clamp(tgt - val, min=0.0)
        else:
            raise ValueError(f"Unknown target_type {self.target_type!r}")
        return torch.atleast_1d(self.weight * d)


def _as_tuple(v):
    arr = np.atleast_1d(np.asarray(v, float))
    return tuple(arr.tolist())


def _spread(*cols):
    """The columns, each a tuple, lengthened to the longest where they
    hold one value."""
    n = max(len(c) for c in cols)
    return tuple(c * n if len(c) == 1 else c for c in cols)


@dataclass
class _Variable:
    layer_index: int
    min_um: float
    max_um: float


class ThinFilmOptimizer:
    """Fluent thin-film optimizer: `add_variable` frees layer thicknesses,
    `add_operand` adds spectral R/T/A targets, `optimize` runs scipy's
    L-BFGS-B on the value and gradient of the summed squared residuals, on
    `device` (None: the CUDA card) in the precision policy's dtype, and
    writes the solution back into the stack."""

    def __init__(self, stack: ThinFilmStack, device=None):
        self.stack = stack
        self.device = config.resolve_device(device)
        self.operands: list[SpectralOperand] = []
        self.variables: list[_Variable] = []
        self._snapshot = [lay.thickness_um for lay in stack.layers]
        self._history: list[float] = []

    # -- setup ----------------------------------------------------------
    def add_variable(self, layer_index: int, kind: str = "thickness",
                     min_nm: float = 0.1, max_nm: float = 10000.0):
        if kind != "thickness":
            raise ValueError("Only 'thickness' variables are supported")
        self.variables.append(_Variable(layer_index, min_nm * 1e-3,
                                        max_nm * 1e-3))
        return self

    def add_all_variables(self, min_nm: float = 0.1, max_nm: float = 10000.0):
        for i in range(len(self.stack.layers)):
            self.add_variable(i, min_nm=min_nm, max_nm=max_nm)
        return self

    def add_operand(self, property: str | None = None, wavelength_nm=550.0,
                    target_type: str = "equal", value=0.0,
                    weight: float = 1.0, aoi_deg=0.0,
                    polarization: str = "u", tolerance: float = 1e-6,
                    operand_type: str | None = None):
        prop = property if property is not None else operand_type
        if prop not in ("R", "T", "A"):
            raise ValueError(f"Unknown operand {prop!r}; expected R, T or A")
        wl, aoi, val = _spread(_as_tuple(wavelength_nm), _as_tuple(aoi_deg),
                               _as_tuple(value))
        self.operands.append(SpectralOperand(
            prop=prop, wavelength_nm=wl, aoi_deg=aoi,
            polarization=polarization, target_type=target_type, value=val,
            weight=float(weight), tolerance=float(tolerance)))
        return self

    def add_spectral_operand(self, property: str, wavelength_nm,
                             target_type: str, value, weight: float = 1.0,
                             aoi_deg: float = 0.0, polarization: str = "u"):
        return self.add_operand(property=property, wavelength_nm=wavelength_nm,
                                target_type=target_type, value=value,
                                weight=weight, aoi_deg=aoi_deg,
                                polarization=polarization)

    def add_angular_operand(self, property: str, aoi_deg,
                            wavelength_nm: float, target_type: str, value,
                            weight: float = 1.0, polarization: str = "u"):
        return self.add_operand(property=property, wavelength_nm=wavelength_nm,
                                target_type=target_type, value=value,
                                weight=weight, aoi_deg=aoi_deg,
                                polarization=polarization)

    # -- evaluation -----------------------------------------------------
    def _tensor(self, values):
        return torch.tensor(values, dtype=config.get_dtype(),
                            device=self.device)

    def _thickness_vector(self):
        return self._tensor([float(np.asarray(lay.thickness_um))
                             for lay in self.stack.layers])

    def _variable_values(self):
        return [float(np.asarray(
            self.stack.layers[v.layer_index].thickness_um))
            for v in self.variables]

    def _residual_fn(self):
        stack = self.stack
        operands = tuple(self.operands)
        var_idx = torch.tensor([v.layer_index for v in self.variables],
                               dtype=torch.long, device=self.device)
        base = self._thickness_vector()

        def residuals(x_um):
            th = (base.index_put((var_idx,), x_um) if len(self.variables)
                  else base)
            return torch.cat([op.residuals(stack, th) for op in operands])

        return residuals

    def fun_array(self) -> np.ndarray:
        with torch.no_grad():
            r = self._residual_fn()(self._tensor(self._variable_values()))
        return r.double().cpu().numpy()

    def sum_squared(self) -> float:
        return float(np.sum(self.fun_array() ** 2))

    def rss(self) -> float:
        return float(np.sqrt(np.sum(self.fun_array() ** 2)))

    # -- optimization ---------------------------------------------------
    def optimize(self, method: str = "L-BFGS-B", max_iter: int = 200,
                 tol: float = 1e-12, verbose: bool = False):
        from scipy import optimize as sciopt

        if not self.variables:
            raise ValueError("No variables added")
        residuals = self._residual_fn()

        def fun(x):
            xt = self._tensor(np.asarray(x, float)).requires_grad_(True)
            r = residuals(xt)
            v = torch.sum(r * r)
            (g,) = torch.autograd.grad(v, xt)
            self._history.append(v.item())
            return v.item(), g.double().cpu().numpy()

        x0 = np.asarray(self._variable_values())
        bounds = [(v.min_um, v.max_um) for v in self.variables]
        res = sciopt.minimize(fun, x0, jac=True, method=method, bounds=bounds,
                              tol=tol, options={"maxiter": max_iter,
                                                "disp": verbose})
        for v, t in zip(self.variables, res.x):
            lay = self.stack.layers[v.layer_index]
            self.stack.layers[v.layer_index] = replace(
                lay, thickness_um=float(t))
        return res

    def reset(self):
        """Restore the stack to its state at the optimizer's construction."""
        for i, t in enumerate(self._snapshot):
            self.stack.layers[i] = replace(self.stack.layers[i],
                                           thickness_um=t)
        return self

    def get_current_performance(self) -> dict:
        return {"merit": self.sum_squared(), "rss": self.rss(),
                "residuals": self.fun_array()}

    def info(self):
        rows = []
        for op in self.operands:
            rows.append(f"  {op.prop} {op.target_type} {op.value} @ "
                        f"{op.wavelength_nm} nm, AOI {op.aoi_deg} deg, "
                        f"pol {op.polarization}, w={op.weight}")
        print(f"ThinFilmOptimizer: {len(self.variables)} variables, "
              f"{len(self.operands)} operands, merit={self.sum_squared():.4e}")
        print("\n".join(rows))


# ---------------------------------------------------------------------------
# Needle synthesis
# ---------------------------------------------------------------------------


@dataclass
class NeedleResult:
    iteration: int
    merit: float
    num_layers: int
    action: str


@dataclass
class NeedleSynthesisResult:
    stack: ThinFilmStack
    merit_history: list = field(default_factory=list)
    steps: list = field(default_factory=list)

    @property
    def final_merit(self) -> float:
        return self.merit_history[-1] if self.merit_history else float("nan")


class NeedleSynthesis:
    """Needle synthesis: insert thin 'needle' layers of an alternate
    material where they most improve the merit, each trial scored at the
    needle's starting thickness, the winner re-optimized (continuous
    thickness optimization), until no insertion improves the merit."""

    def __init__(self, stack: ThinFilmStack, needle_material,
                 min_thickness_nm: float = 1.0, needle_start_nm: float = 5.0,
                 positions_per_layer: int = 3, max_needles: int = 10,
                 device=None):
        self.stack = stack
        self.needle_material = resolve_material(needle_material)
        self.min_thickness_um = min_thickness_nm * 1e-3
        self.needle_start_um = needle_start_nm * 1e-3
        self.positions_per_layer = positions_per_layer
        self.max_needles = max_needles
        self.device = device
        self._targets: list[dict] = []

    def add_target(self, property: str, wavelength_nm, target_type: str,
                   value, weight: float = 1.0, aoi_deg=0.0,
                   polarization: str = "u"):
        self._targets.append(dict(
            property=property, wavelength_nm=wavelength_nm,
            target_type=target_type, value=value, weight=weight,
            aoi_deg=aoi_deg, polarization=polarization))
        return self

    add_spectral_target = add_target

    def _build_optimizer(self, stack: ThinFilmStack) -> ThinFilmOptimizer:
        opt = ThinFilmOptimizer(stack, device=self.device)
        for t in self._targets:
            opt.add_operand(**t)
        opt.add_all_variables(min_nm=0.0)
        return opt

    def _merit(self, stack: ThinFilmStack) -> float:
        return self._build_optimizer(stack).sum_squared()

    def _reoptimize(self, stack: ThinFilmStack, max_iter: int = 100) -> float:
        opt = self._build_optimizer(stack)
        opt.optimize(max_iter=max_iter)
        return opt.sum_squared()

    def _trial(self, stack: ThinFilmStack, j: int, f: float):
        trial = stack.copy()
        trial.split_layer(j, float(f))
        trial.insert_layer(j + 1, self.needle_material, self.needle_start_um)
        return trial

    def _candidate_merits(self, stack: ThinFilmStack):
        """The (layer, fraction) needle insertions and their merits at the
        needle's starting thickness."""
        n = len(stack.layers)
        fracs = np.linspace(0.0, 1.0, self.positions_per_layer + 2)[1:-1]
        candidates = [(j, f) for j in range(n) for f in fracs
                      if stack.layers[j].material is not self.needle_material]
        return candidates, np.asarray([self._merit(self._trial(stack, j, f))
                                       for j, f in candidates])

    def _cleanup(self, stack: ThinFilmStack):
        """Drop layers thinner than the minimum and merge same-material
        neighbours."""
        layers = [lay for lay in stack.layers
                  if float(np.asarray(lay.thickness_um))
                  >= self.min_thickness_um]
        merged: list[Layer] = []
        for lay in layers:
            if merged and merged[-1].material is lay.material:
                merged[-1] = replace(
                    merged[-1],
                    thickness_um=float(np.asarray(merged[-1].thickness_um))
                    + float(np.asarray(lay.thickness_um)))
            else:
                merged.append(lay)
        stack.layers = merged

    def run(self, max_iterations: int | None = None,
            verbose: bool = False) -> NeedleSynthesisResult:
        if not self._targets:
            raise ValueError("No targets added")
        stack = self.stack
        result = NeedleSynthesisResult(stack=stack)
        merit = self._reoptimize(stack)
        result.merit_history.append(merit)
        result.steps.append(NeedleResult(0, merit, len(stack.layers),
                                         "initial reopt"))
        iters = max_iterations or self.max_needles
        for it in range(1, iters + 1):
            candidates, merits = self._candidate_merits(stack)
            if not candidates:
                break
            j, f = candidates[int(np.argmin(merits))]
            trial = self._trial(stack, j, f)
            new_merit = self._reoptimize(trial)
            if new_merit < merit * (1.0 - 1e-6):
                self._cleanup(trial)
                new_merit = self._reoptimize(trial)
                stack.layers = trial.layers
                merit = new_merit
                result.merit_history.append(merit)
                result.steps.append(NeedleResult(
                    it, merit, len(stack.layers),
                    f"needle in layer {j} @ {f:.2f}"))
                if verbose:
                    print(f"needle iter {it}: merit={merit:.4e}, "
                          f"{len(stack.layers)} layers")
            else:
                result.steps.append(NeedleResult(
                    it, merit, len(stack.layers), "no improvement — stop"))
                break
        return result
