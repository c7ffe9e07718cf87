"""OptimizationProblem: operands and variables over one optic.

Port of `optiland_tpu/optimization/problem.py`, API-compatible with the
reference's `OptimizationProblem` (`optimization/problem.py:27-380`):
`add_operand(operand_type, target, weight, input_data)`,
`add_variable(optic, kind, **kwargs)`, `fun_array / sum_squared / rss`.
`_compile` returns plain closures of the scaled variable vector under the
JAX package's keys; `value_and_grad` and `residual_jac` differentiate them
by reverse mode. The Jacobian is one vector-Jacobian product per residual
over one forward: K7's autograd seam (`trace.fused._FusedHistory`) has
no forward mode, so no Jacobian of a ray operand takes one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from optiland_tpu_torch.optimization import operands as ops
from optiland_tpu_torch.optimization import variables as vars_mod
from optiland_tpu_torch.optimization.variables import Variable


@dataclass
class OperandSpec:
    operand_type: str
    target: float | None = None
    min_val: float | None = None
    max_val: float | None = None
    weight: float = 1.0
    input_data: dict = field(default_factory=dict)

    def delta_fn(self, value):
        """Signed deviation used in the merit (reference Operand.delta)."""
        if self.target is not None:
            return value - self.target
        lo = -math.inf if self.min_val is None else self.min_val
        hi = math.inf if self.max_val is None else self.max_val
        # inequality operand: penalize only outside the [lo, hi] band;
        # torch.maximum splits the derivative of a tie evenly, as
        # jnp.maximum does (0.5 on the band's edge)
        zero = torch.zeros_like(value)
        return (torch.maximum(lo - value, zero)
                + torch.maximum(value - hi, zero))


def operand_values(static, params, operands) -> list:
    """The operands' values at `params`, one 0-d tensor each."""
    return [torch.as_tensor(
        ops.REGISTRY[o.operand_type](static, params, **o.input_data),
        dtype=params.cv.dtype, device=params.cv.device) for o in operands]


def weighted_deltas(values, operands) -> list:
    """weight * delta of each operand value: the residuals, one 0-d tensor
    each, so that a row of the Jacobian differentiates its own operand's
    graph alone (through a stacked vector, every row's product would run
    every operand's backward, K7's eager twin included)."""
    return [o.weight * o.delta_fn(v) for o, v in zip(operands, values)]


def _leaf(x):
    return x.detach().requires_grad_(True)


def _grad(out, x, retain_graph=False):
    """d out / d x, zeros where `out` does not depend on `x`."""
    if not out.requires_grad:
        return torch.zeros_like(x)
    g, = torch.autograd.grad(out, x, retain_graph=retain_graph,
                             allow_unused=True)
    return torch.zeros_like(x) if g is None else g


def value_and_jac(fn, x):
    """(fn(x), its Jacobian) for `fn` returning a list of 0-d tensors: one
    forward, then one vector-Jacobian product per output."""
    x = _leaf(x)
    r = fn(x)
    m = len(r)
    if not m:
        return x.new_zeros((0,)), x.new_zeros((0, x.numel()))
    J = torch.stack([_grad(r[i], x, retain_graph=i < m - 1)
                     for i in range(m)])
    return torch.stack([t.detach() for t in r]), J


class OptimizationProblem:
    """Merit function definition over one optic."""

    def __init__(self, optic=None):
        self.optic = optic
        self.operands: list[OperandSpec] = []
        self.variables: list[Variable] = []
        self._compiled = None
        self.initial_value = 0.0

    # -- builder -----------------------------------------------------------
    def add_operand(self, operand_type=None, target=None, min_val=None,
                    max_val=None, weight=1.0, input_data=None):
        if operand_type not in ops.REGISTRY:
            raise ValueError(f"Unknown operand type {operand_type!r}")
        self.operands.append(OperandSpec(operand_type, target, min_val,
                                         max_val, weight, input_data or {}))
        self._compiled = None

    def add_variable(self, optic, variable_type, **kwargs):
        if self.optic is None:
            self.optic = optic
        scaler = kwargs.pop("scaler", None)
        surface_number = kwargs.pop("surface_number")
        coeff_number = kwargs.pop("coeff_number", 0)
        min_val = kwargs.pop("min_val", None)
        max_val = kwargs.pop("max_val", None)
        if (variable_type in vars_mod._GEOM_COEFF_KINDS
                and "offset" not in kwargs):
            kwargs["offset"] = vars_mod.geom_coeff_offset(
                optic.static, variable_type, surface_number)
        self.variables.append(Variable(
            kind=variable_type, surface_number=surface_number,
            coeff_number=coeff_number, scaler=scaler,
            bounds=(min_val, max_val), extra=kwargs,
        ))
        self._compiled = None

    def clear_operands(self):
        self.operands = []
        self._compiled = None

    def clear_variables(self):
        self.variables = []
        self._compiled = None

    # -- compiled access ---------------------------------------------------
    def _compile(self):
        """Closures of (x_scaled, params) under the JAX package's keys:
        values, fun_array, residuals, sum_squared, value_and_grad (the
        merit and its gradient, detached) and residual_jac."""
        if self._compiled is not None:
            return self._compiled
        static, _ = self.optic.build(device=self.optic.device)
        operands = list(self.operands)
        variables = list(self.variables)

        def value_list(x_scaled, params):
            p = vars_mod.apply_all(variables, params, x_scaled)
            return operand_values(static, p, operands)

        def values(x_scaled, params):
            return torch.stack(value_list(x_scaled, params))

        def fun_array(x_scaled, params):
            # reference semantics (`problem.py:141-172`): weight * delta^2
            return torch.stack([
                o.weight * o.delta_fn(v) * o.delta_fn(v)
                for o, v in zip(operands, value_list(x_scaled, params))])

        def residual_list(x_scaled, params):
            # reference `residual_vector`: weight * delta (note: the
            # reference's own sum_squared weighs deltas linearly, not
            # quadratically; we mirror both behaviors exactly)
            return weighted_deltas(value_list(x_scaled, params), operands)

        def residuals(x_scaled, params):
            return torch.stack(residual_list(x_scaled, params))

        def sum_squared(x_scaled, params):
            return torch.sum(fun_array(x_scaled, params))

        def value_and_grad(x_scaled, params):
            x = _leaf(x_scaled)
            v = sum_squared(x, params)
            return v.detach(), _grad(v, x)

        def residual_jac(x_scaled, params):
            return value_and_jac(lambda x: residual_list(x, params),
                                 x_scaled)[1]

        self._compiled = {
            "values": values,
            "fun_array": fun_array,
            "residuals": residuals,
            "sum_squared": sum_squared,
            "value_and_grad": value_and_grad,
            "residual_jac": residual_jac,
        }
        return self._compiled

    @property
    def params(self):
        return self.optic.params

    def x0(self):
        """Scaled starting vector."""
        return vars_mod.initial_values(self.variables, self.optic.params)

    def _x(self, x_scaled):
        """A solution vector as a tensor of the optic's dtype and device."""
        p = self.optic.params
        return torch.as_tensor(x_scaled, dtype=p.cv.dtype, device=p.cv.device)

    # -- reference-compatible queries --------------------------------------
    def fun_array(self):
        c = self._compile()
        return c["fun_array"](self.x0(), self.optic.params)

    def operand_values(self):
        c = self._compile()
        return c["values"](self.x0(), self.optic.params)

    def residual_vector(self):
        c = self._compile()
        return c["residuals"](self.x0(), self.optic.params)

    def sum_squared(self):
        c = self._compile()
        return c["sum_squared"](self.x0(), self.optic.params)

    def rss(self):
        return torch.sqrt(self.sum_squared())

    def update_optics(self):
        """No-op for API compatibility (params are pure)."""

    def apply(self, x_scaled):
        """Install a solution vector into the optic."""
        with torch.no_grad():
            params = vars_mod.apply_all(self.variables, self.optic.params,
                                        self._x(x_scaled))
        self.optic.update_params(params)

    def info(self):
        c = self._compile()
        with torch.no_grad():
            vals = c["values"](self.x0(), self.optic.params).cpu().numpy()
        print(f"{'operand':24s} {'target':>12s} {'weight':>8s} {'value':>14s}")
        for o, v in zip(self.operands, vals):
            t = "-" if o.target is None else f"{o.target:.6g}"
            print(f"{o.operand_type:24s} {t:>12s} {o.weight:>8.3g} {v:>14.6g}")
        print(f"{'variable':40s} {'value':>14s}")
        for var in self.variables:
            print(f"{str(var):40s} {float(var.get(self.optic.params)):>14.6g}")
