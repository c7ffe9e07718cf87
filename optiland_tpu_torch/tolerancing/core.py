"""Tolerancing core: perturbations, compensators and operands.

Port of `optiland_tpu/tolerancing/core.py`, the redesign of the reference's
`tolerancing/` (`core.py:18-145`, `perturbation.py:19-172`,
`compensator.py:15-66`): one draw's pipeline (perturb -> compensate ->
evaluate) is one function of a perturbation vector, and `pipeline_batch`
runs it draw by draw (the kernels take no batch axis over systems).

Compensation runs a fixed number of damped Gauss-Newton steps on the
compensator variables (a data-independent count, as in JAX; the
reference runs scipy to tolerance instead), each with the residual
Jacobian by reverse mode, one vector-Jacobian product per residual.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from optiland_tpu_torch.optimization import operands as ops
from optiland_tpu_torch.optimization import variables as vars_mod
from optiland_tpu_torch.optimization.problem import (
    OperandSpec,
    operand_values,
    value_and_jac,
    weighted_deltas,
)
from optiland_tpu_torch.optimization.variables import Variable


# -- samplers (reference `perturbation.py:19-172`) --------------------------

class BaseSampler:
    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError


@dataclass
class ScalarSampler(BaseSampler):
    value: float

    size = 1

    def sample(self, rng, n):
        return np.full(n, self.value)


@dataclass
class RangeSampler(BaseSampler):
    start: float
    end: float
    steps: int

    @property
    def size(self):
        return self.steps

    def sample(self, rng, n):
        grid = np.linspace(self.start, self.end, self.steps)
        return np.resize(grid, n)


@dataclass
class NormalSampler(BaseSampler):
    mean: float
    std: float

    def sample(self, rng, n):
        return rng.normal(self.mean, self.std, n)


@dataclass
class UniformSampler(BaseSampler):
    low: float
    high: float

    def sample(self, rng, n):
        return rng.uniform(self.low, self.high, n)


@dataclass
class Perturbation:
    variable: Variable
    sampler: BaseSampler

    def __str__(self):
        return str(self.variable)


class Tolerancing:
    """Perturbations + compensators + operands over one optic."""

    def __init__(self, optic, compensator_steps: int = 12,
                 compensator_damping: float = 1e-6):
        self.optic = optic
        self.perturbations: list[Perturbation] = []
        self.compensators: list[Variable] = []
        self.operands: list[OperandSpec] = []
        self.compensator_steps = compensator_steps
        self.compensator_damping = compensator_damping
        self._nominal_params = optic.params
        self._compiled = None

    def add_perturbation(self, variable_type: str, sampler: BaseSampler,
                         **kwargs):
        var = Variable(kind=variable_type,
                       surface_number=kwargs.pop("surface_number"),
                       coeff_number=kwargs.pop("coeff_number", 0),
                       extra=kwargs)
        self.perturbations.append(Perturbation(var, sampler))
        self._compiled = None

    def add_compensator(self, variable_type: str, **kwargs):
        self.compensators.append(
            Variable(kind=variable_type,
                     surface_number=kwargs.pop("surface_number"),
                     coeff_number=kwargs.pop("coeff_number", 0),
                     extra=kwargs)
        )
        self._compiled = None

    def add_operand(self, operand_type: str, input_data: dict = None,
                    target: float = None, weight: float = 1.0,
                    min_val: float = None, max_val: float = None):
        spec = OperandSpec(operand_type, target, min_val, max_val, weight,
                           input_data or {})
        if target is None and min_val is None and max_val is None:
            # reference behavior: default target = nominal value
            static, params = self.optic.build(device=self.optic.device)
            with torch.no_grad():
                spec.target = float(ops.REGISTRY[operand_type](
                    static, params, **spec.input_data))
        self.operands.append(spec)
        self._compiled = None

    # -- the pipeline ------------------------------------------------------
    def _compile(self):
        if self._compiled is not None:
            return self._compiled
        static, _ = self.optic.build(device=self.optic.device)
        perturb_vars = [p.variable for p in self.perturbations]
        comp_vars = list(self.compensators)
        operands = list(self.operands)
        steps = self.compensator_steps
        damping = self.compensator_damping

        def values(params):
            return torch.stack(operand_values(static, params, operands))

        def residuals(params):
            return weighted_deltas(operand_values(static, params, operands),
                                   operands)

        def apply_perturbation(params, draw):
            for i, v in enumerate(perturb_vars):
                params = v.set(params, draw[i])
            return params

        def compensate(params):
            """Fixed-count damped Gauss-Newton on the compensator variables."""
            if not comp_vars:
                return params, torch.zeros((0,), dtype=params.cv.dtype,
                                           device=params.cv.device)
            x = vars_mod.initial_values(comp_vars, params).detach()
            eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
            for _ in range(steps):
                r, J = value_and_jac(lambda xx: residuals(
                    vars_mod.apply_all(comp_vars, params, xx)), x)
                JTJ = J.T @ J + damping * eye
                x = x - torch.linalg.solve(JTJ, J.T @ r)
            return vars_mod.apply_all(comp_vars, params, x), x

        def pipeline(nominal_params, draw):
            p = apply_perturbation(nominal_params, draw)
            p, comp_x = compensate(p)
            with torch.no_grad():
                return values(p), comp_x

        def pipeline_batch(nominal_params, draws):
            """`pipeline` of each row of `draws`, stacked: (values (N, M),
            compensators (N, C))."""
            dt, dev = nominal_params.cv.dtype, nominal_params.cv.device
            out = [pipeline(nominal_params,
                            torch.as_tensor(d, dtype=dt, device=dev))
                   for d in np.asarray(draws)]
            if not out:
                return (torch.zeros((0, len(operands)), dtype=dt, device=dev),
                        torch.zeros((0, len(comp_vars)), dtype=dt,
                                    device=dev))
            return (torch.stack([v for v, _ in out]),
                    torch.stack([c for _, c in out]))

        def values_no_grad(params):
            with torch.no_grad():
                return values(params)

        self._compiled = {
            "pipeline": pipeline,
            "pipeline_batch": pipeline_batch,
            "operand_values": values_no_grad,
        }
        return self._compiled

    # -- reference-style serial interface -----------------------------------
    def apply(self, draw):
        """The operand values of one perturbation draw (+compensation); the
        optic keeps its parameters."""
        c = self._compile()
        p = self._nominal_params
        vals, _ = c["pipeline"](p, torch.as_tensor(
            np.asarray(draw), dtype=p.cv.dtype, device=p.cv.device))
        return vals

    def evaluate(self):
        c = self._compile()
        return c["operand_values"](self.optic.params)

    def reset(self):
        self.optic.update_params(self._nominal_params)

    def draw_table(self, num: int, seed: int = 0) -> np.ndarray:
        """(num, P) perturbation draws from each sampler."""
        rng = np.random.default_rng(seed)
        cols = [p.sampler.sample(rng, num) for p in self.perturbations]
        return np.stack(cols, axis=1) if cols else np.zeros((num, 0))
