"""Optimizers over an OptimizationProblem.

Port of `optiland_tpu/optimization/optimizers.py`, mirroring the
reference's optimizer suite (`optimization/optimizer/scipy/*.py`,
`optimizer/torch/*.py`): scipy's minimize, least_squares and global
methods driven by the problem's merit with its autograd gradient (each
call turns scipy's float64 `x` into a tensor of the optic's dtype and
device, and the value and gradient back into float64 numpy), and Adam and
SGD loops of `torch.optim` on one tensor `x` on the optic's device (the
reference's torch Adam, `optimizer/torch/adam.py:31`).
"""

from __future__ import annotations

import time

import numpy as np
import torch


class OptimizationResult(dict):
    """scipy-style result wrapper."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(float)


class OptimizerGeneric:
    """scipy.optimize.minimize wrapper with analytic gradients
    (reference `optimizer/scipy/base.py:25-138` + undo stack)."""

    method = None

    def __init__(self, problem):
        self.problem = problem
        self._undo: list[np.ndarray] = []

    def undo(self):
        if self._undo:
            x = self._undo.pop()
            self.problem.apply(x)

    def _start(self):
        """The compiled problem, the optic's params and the scaled start
        (numpy, float64), pushed on the undo stack."""
        c = self.problem._compile()
        x0 = _numpy(self.problem.x0())
        self._undo.append(x0.copy())
        return c, self.problem.optic.params, x0

    def _value_and_grad(self, c, params0):
        def fun(x):
            v, g = c["value_and_grad"](self.problem._x(x), params0)
            return float(v), _numpy(g)

        return fun

    def _value(self, c, params0):
        def fun(x):
            with torch.no_grad():
                return float(c["sum_squared"](self.problem._x(x), params0))

        return fun

    def optimize(self, maxiter: int = 1000, disp: bool = False, tol: float = 1e-3,
                 callback=None):
        from scipy import optimize as sciopt

        c, params0, x0 = self._start()
        res = sciopt.minimize(
            self._value_and_grad(c, params0), x0, jac=True,
            method=self.method, tol=tol, bounds=self._bounds(),
            options={"maxiter": maxiter, "disp": disp}, callback=callback,
        )
        self.problem.apply(res.x)
        return res

    def _bounds(self):
        bounds = []
        any_bound = False
        for v in self.problem.variables:
            lo, hi = v.bounds
            slo = None if lo is None else float(v.scaler.scale(lo))
            shi = None if hi is None else float(v.scaler.scale(hi))
            if slo is not None and shi is not None and slo > shi:
                slo, shi = shi, slo
            if slo is not None or shi is not None:
                any_bound = True
            bounds.append((slo, shi))
        return bounds if any_bound else None


class LeastSquares(OptimizerGeneric):
    """scipy.optimize.least_squares with the analytic residual Jacobian."""

    def optimize(self, maxiter: int = 1000, disp: bool = False, tol: float = 1e-9):
        from scipy import optimize as sciopt

        c, params0, x0 = self._start()

        def fun(x):
            with torch.no_grad():
                return _numpy(c["residuals"](self.problem._x(x), params0))

        def jac(x):
            return _numpy(c["residual_jac"](self.problem._x(x), params0))

        res = sciopt.least_squares(fun, x0, jac=jac, xtol=tol,
                                   max_nfev=maxiter, verbose=2 if disp else 0)
        self.problem.apply(res.x)
        return res


class _GlobalOptimizer(OptimizerGeneric):
    """Base for scipy global optimizers needing finite bounds."""

    def _finite_bounds(self):
        bounds = self._bounds()
        if bounds is None or any(b[0] is None or b[1] is None for b in bounds):
            raise ValueError(
                "Global optimizers require finite min_val/max_val bounds on "
                "every variable."
            )
        return bounds


class DualAnnealing(_GlobalOptimizer):
    def optimize(self, maxiter: int = 1000, disp: bool = False):
        from scipy import optimize as sciopt

        c, params0, _ = self._start()
        res = sciopt.dual_annealing(self._value(c, params0),
                                    self._finite_bounds(), maxiter=maxiter)
        self.problem.apply(res.x)
        return res


class DifferentialEvolution(_GlobalOptimizer):
    def optimize(self, maxiter: int = 1000, disp: bool = False,
                 workers: int = 1):
        from scipy import optimize as sciopt

        c, params0, _ = self._start()
        res = sciopt.differential_evolution(
            self._value(c, params0), self._finite_bounds(), maxiter=maxiter,
            disp=disp, workers=workers, polish=False,
        )
        self.problem.apply(res.x)
        return res


class BasinHopping(OptimizerGeneric):
    def optimize(self, niter: int = 100, disp: bool = False):
        from scipy import optimize as sciopt

        c, params0, x0 = self._start()
        res = sciopt.basinhopping(
            self._value_and_grad(c, params0), x0, niter=niter, disp=disp,
            minimizer_kwargs={"jac": True},
        )
        self.problem.apply(res.x)
        return res


class SHGO(_GlobalOptimizer):
    """Simplicial homology global optimization (reference
    `optimizer/scipy/shgo.py`)."""

    def optimize(self, n: int = 100, iters: int = 1, disp: bool = False):
        from scipy import optimize as sciopt

        c, params0, _ = self._start()
        res = sciopt.shgo(self._value(c, params0), self._finite_bounds(),
                          n=n, iters=iters, options={"disp": disp})
        self.problem.apply(res.x)
        return res


class OrthogonalDescent(OptimizerGeneric):
    """Cyclic coordinate descent with Brent line searches — derivative-free,
    one variable at a time (reference
    `optimizer/scipy/orthogonal_descent.py:21-105`)."""

    def optimize(self, max_iter: int = 100, tol: float = 1e-4,
                 disp: bool = False):
        from scipy.optimize import minimize_scalar

        c, params0, x = self._start()
        bounds = self._bounds() or [(None, None)] * len(x)
        value = self._value(c, params0)

        def rss(xv):
            return float(np.sqrt(value(xv)))

        current = rss(x)
        for _ in range(max_iter):
            prev = current
            for i in range(len(x)):
                lo, hi = bounds[i]
                lo = -1e12 if lo is None else lo
                hi = 1e12 if hi is None else hi
                x_start, f_start = x[i], rss(x)

                def obj(v, i=i, lo=lo, hi=hi):
                    if v < lo or v > hi:
                        return 1e20
                    x[i] = v
                    try:
                        return rss(x)
                    finally:
                        x[i] = x_start

                step = max(abs(x_start) * 0.05, 0.1)
                res = minimize_scalar(obj, bracket=(x_start - step,
                                                    x_start + step),
                                      method="brent", tol=1e-5)
                if res.fun < f_start:
                    x[i] = float(res.x)
            current = rss(x)
            if disp:
                print(f"orthogonal descent: rss={current:.6g}")
            if abs(prev - current) / (prev + 1e-10) < tol:
                break
        self.problem.apply(x)
        return OptimizationResult(x=x, fun=current)


class _TorchOptimizer:
    """First-order loop of a `torch.optim` optimizer on the scaled vector
    `x`, on the optic's device; bounds are clamped after each step, as the
    reference's torch optimizers do (`optimizer/torch/base.py`)."""

    def __init__(self, problem, lr: float = 1e-2):
        self.problem = problem
        self.lr = lr

    def _optimizer(self, x: torch.Tensor) -> torch.optim.Optimizer:
        raise NotImplementedError

    def _clamp_bounds(self, x):
        """(lo, hi) of the scaled bounds, as tensors like `x`."""
        def scaled(v, k, inf):
            b = v.bounds[k]
            return inf if b is None else float(v.scaler.scale(b))

        lo = torch.tensor([scaled(v, 0, -np.inf)
                           for v in self.problem.variables], dtype=x.dtype,
                          device=x.device)
        hi = torch.tensor([scaled(v, 1, np.inf)
                           for v in self.problem.variables], dtype=x.dtype,
                          device=x.device)
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    def optimize(self, n_steps: int = 100, disp: bool = False, callback=None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 metrics: list | None = None):
        """Run the first-order loop.

        checkpoint_dir/checkpoint_every/resume: (x, optimizer state, step,
        losses) checkpoints for long runs (`optiland_tpu_torch.utils.
        checkpoint`); a resumed run continues as the straight run would.
        `metrics`: optional list that collects one dict per step with loss,
        grad-norm, step wall time and evals/s.
        """
        from optiland_tpu_torch.utils import checkpoint as ckpt

        c = self.problem._compile()
        params0 = self.problem.optic.params
        x = self.problem.x0().detach().clone().requires_grad_(True)
        lo, hi = self._clamp_bounds(x)
        opt = self._optimizer(x)
        start = 0
        losses = []
        if checkpoint_dir and resume:
            latest = ckpt.latest_checkpoint(checkpoint_dir)
            if latest is not None:
                state = ckpt.restore_checkpoint(latest)
                with torch.no_grad():
                    x.copy_(torch.as_tensor(state["x"]))
                opt.load_state_dict(state["opt_state"])
                start = ckpt.checkpoint_step(latest)
                losses = [float(v) for v in np.asarray(state["losses"])]

        for i in range(start, n_steps):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = c["sum_squared"](x, params0)
            loss.backward()
            gnorm = torch.sqrt(torch.sum(x.grad * x.grad))
            opt.step()
            with torch.no_grad():
                x.copy_(torch.clamp(x, lo, hi))
            loss_f = float(loss.detach())
            dt = time.perf_counter() - t0
            losses.append(loss_f)
            if metrics is not None:
                metrics.append({"step": i, "loss": loss_f,
                                "grad_norm": float(gnorm.detach()),
                                "step_time_s": dt,
                                "evals_per_s": 1.0 / max(dt, 1e-12)})
            if callback is not None:
                callback(i, loss_f)
            if checkpoint_dir and checkpoint_every \
                    and (i + 1) % checkpoint_every == 0:
                ckpt.save_checkpoint(checkpoint_dir, i + 1,
                                     {"step": i + 1, "x": x.detach(),
                                      "losses": np.asarray(losses),
                                      "opt_state": opt.state_dict()})
            if disp and (i % max(1, n_steps // 10) == 0):
                print(f"step {i:5d}  loss {loss_f:.6e}")
        self.problem.apply(x.detach())
        # a resume at step >= n_steps runs zero new steps; evaluate once so
        # fun/success are well-defined
        if not losses:
            losses = [float(c["value_and_grad"](x, params0)[0])]
        return OptimizationResult(x=_numpy(x), fun=losses[-1],
                                  loss_history=losses, nit=n_steps,
                                  success=bool(np.isfinite(losses[-1])))


class AdamOptimizer(_TorchOptimizer):
    def _optimizer(self, x):
        return torch.optim.Adam([x], lr=self.lr)


class SGDOptimizer(_TorchOptimizer):
    def __init__(self, problem, lr: float = 1e-3, momentum: float = 0.9):
        super().__init__(problem, lr)
        self.momentum = momentum

    def _optimizer(self, x):
        return torch.optim.SGD([x], lr=self.lr, momentum=self.momentum)
