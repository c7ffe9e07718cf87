"""Hybrid physics-ML integration layer (port of `optiland_tpu/ml/`).

The reference's `optiland/ml/` package (`ml/wrappers.py:32`
`OpticalSystemModule(nn.Module)`) exposes an optical system's optimization
variables as trainable leaves of a differentiable module, so that the lens
can sit inside a larger learned pipeline. The port keeps that design: an
`nn.Module` whose one `nn.Parameter` is the scaled variable vector. The
JAX package's `as_flax_module()` (a flax module over the same vector) has
no flax counterpart in a torch package; `as_torch_module()` gives its
contract, a fresh module whose single parameter is the current vector and
whose forward returns the loss.
"""

from optiland_tpu_torch.ml.wrappers import OpticalSystemModule

__all__ = ["OpticalSystemModule"]
