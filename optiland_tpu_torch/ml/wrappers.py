"""Hybrid physics-ML wrapper: the lens as a differentiable module.

Port of `optiland_tpu/ml/wrappers.py`, the counterpart of the reference
`OpticalSystemModule` (`optiland/ml/wrappers.py:32-155`), which wraps an
OptimizationProblem in a torch `nn.Module`: variables become an
`nn.Parameter`, `forward()` writes them into the system's parameters and
returns the merit, and `apply_bounds()` clamps after a step. The JAX
package recast the module as pure functions; the port is the reference's
own design again:

  - `module.x`               -> the trainable `nn.Parameter`, the scaled
                                variable vector (JAX: `module.parameters()`;
                                here `parameters()` keeps `nn.Module`'s
                                meaning and yields `x`)
  - `module.loss(x)`         -> the scalar merit, differentiable; `module(x)`
                                runs `forward`, the same loss (`x` defaults
                                to `module.x`)
  - `module.apply_bounds(x)` -> the vector clamped to the variable bounds
  - `module.fit(...)`        -> a torch.optim.Adam loop (bounds clamped
                                after each step)
  - `module.system_params(x)`-> the full SystemParams with the variables
                                written in, for custom objectives

A custom `objective_fn(static, params) -> scalar` replaces the reference's
`objective_fn` hook; the default is the problem's weighted sum of squares.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from optiland_tpu_torch.optimization import variables as vars_mod


class OpticalSystemModule(nn.Module):
    """Expose an optic's optimization variables as one trainable parameter.

    Args:
        optic: the `Optic` (its `build(device=)` supplies static + params).
        problem: an `OptimizationProblem` defining variables (and, unless
            `objective_fn` is given, the merit operands).
        objective_fn: optional `(static, params) -> scalar` loss override.
        device: where the system is built and the loss evaluated (None:
            the CUDA card).
    """

    def __init__(self, optic, problem, objective_fn=None, device=None):
        super().__init__()
        self.optic = optic
        self.problem = problem
        if problem.optic is None:
            problem.optic = optic
        self.static, self._params0 = optic.build(device=device)
        self.variables = list(problem.variables)
        self.objective_fn = objective_fn
        self.x = nn.Parameter(
            vars_mod.initial_values(self.variables, self._params0).detach())
        self._bounds = self._scaled_bounds()

    def system_params(self, x=None):
        """Full SystemParams with the variable vector (default `x`)
        written in."""
        return vars_mod.apply_all(self.variables, self._params0,
                                  self.x if x is None else x)

    # -- forward ------------------------------------------------------------
    def loss(self, x=None, params=None) -> torch.Tensor:
        """Differentiable scalar loss at the variable vector `x` (default
        `self.x`). Mirrors the reference forward(): sync params -> update
        optics -> objective (`ml/wrappers.py:131-155`)."""
        base = self._params0 if params is None else params
        p = vars_mod.apply_all(self.variables, base,
                               self.x if x is None else x)
        if self.objective_fn is not None:
            return self.objective_fn(self.static, p)
        return self._problem_merit(p)

    def forward(self, x=None, params=None) -> torch.Tensor:
        return self.loss(x, params)

    def _problem_merit(self, p):
        from optiland_tpu_torch.optimization import operands as ops

        total = torch.zeros((), dtype=p.cv.dtype, device=p.cv.device)
        for o in self.problem.operands:
            val = ops.REGISTRY[o.operand_type](self.static, p, **o.input_data)
            d = o.delta_fn(torch.as_tensor(val, dtype=p.cv.dtype,
                                           device=p.cv.device))
            total = total + o.weight * d * d
        return total

    # -- bounds -------------------------------------------------------------
    def _scaled_bounds(self):
        lo, hi = [], []
        for v in self.variables:
            lo.append(-np.inf if v.bounds[0] is None
                      else float(v.scaler.scale(v.bounds[0])))
            hi.append(np.inf if v.bounds[1] is None
                      else float(v.scaler.scale(v.bounds[1])))
        lo, hi = (torch.as_tensor(a, dtype=self.x.dtype, device=self.x.device)
                  for a in (lo, hi))
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    def apply_bounds(self, x=None) -> torch.Tensor:
        """The scaled vector (default `x`) clamped to the variable bounds
        (reference `apply_bounds`, `ml/wrappers.py:108-130`)."""
        lo, hi = self._bounds
        return torch.clamp(self.x if x is None else x, lo, hi)

    # -- training -----------------------------------------------------------
    def fit(self, steps: int = 100, lr: float = 1e-2, optimizer=None,
            callback=None):
        """`steps` optimizer steps on `x` (default torch.optim.Adam at `lr`,
        JAX's `optax.adam`; or a torch optimizer over `[module.x]`), the
        bounds clamped after each step (the reference's torch-Adam pattern,
        `optimizer/torch/base.py`). Returns (x, the loss before each step)
        and installs the solution into the optic."""
        opt = (torch.optim.Adam([self.x], lr=lr) if optimizer is None
               else optimizer)
        losses = []
        for i in range(steps):
            opt.zero_grad()
            loss = self.loss()
            loss.backward()
            opt.step()
            with torch.no_grad():
                self.x.copy_(self.apply_bounds())
            losses.append(loss.item())
            if callback is not None:
                callback(i, losses[-1])
        x = self.x.detach().clone()
        self.sync_to_optic(x)
        return x, losses

    def sync_to_optic(self, x=None) -> None:
        """Write a solution vector (default `x`) back into the live optic
        (reference `_sync_params_to_problem`)."""
        x = self.x if x is None else x
        with torch.no_grad():
            self.optic.update_params(self.system_params(
                torch.as_tensor(x, dtype=self.x.dtype, device=self.x.device)))

    # -- a module of its own ------------------------------------------------
    def as_torch_module(self) -> nn.Module:
        """A fresh `nn.Module` whose single parameter, `variables`, is the
        current vector and whose forward returns the loss at it: the
        contract of the JAX package's `as_flax_module`, for embedding the
        lens in another model tree."""
        module = self
        x0 = self.x.detach().clone()

        class _OpticalLayer(nn.Module):
            def __init__(self):
                super().__init__()
                self.variables = nn.Parameter(x0)

            def forward(self):
                return module.loss(self.variables)

        return _OpticalLayer()
