"""The JAX package's sharded dryrun steps, for `tests/test_torch_parallel.py`
to run in a spawned interpreter of their own: it imports JAX, the JAX
package and optax, and neither torch nor the port. The interpreter
inherits the parent's environment, and with it the 8 virtual CPU devices
that tests/conftest.py forces."""

from dataclasses import fields

import numpy as np

import jax
import jax.numpy as jnp
import optax

import optiland_tpu
from optiland_tpu import parallel as jpar
from optiland_tpu.models import CookeTriplet
from optiland_tpu.optimization.merits import centroid_rms_spot
from optiland_tpu.trace.tracer import trace_system


def _on_mesh(batch_np):
    """The Cooke triplet in float64 and the batch on a (2, 4) mesh: (static,
    params replicated, batch sharded over rays)."""
    optiland_tpu.set_precision("float64")
    static, params = CookeTriplet().build()
    mesh = jpar.make_mesh_2d(n_hosts=2, chips_per_host=4)
    batch = tuple(jax.device_put(jnp.asarray(a), jpar.ray_sharding_2d(mesh))
                  for a in batch_np)
    return static, jax.device_put(params, jpar.replicated_sharding(mesh)), \
        batch


def _host(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in fields(tree) if getattr(tree, f.name) is not None}


# Each step runs op by op in an interpreter of its own: jitted, the two
# programs take ~15 s each for XLA to compile (one program of both ~30
# s), at twice the CPU time, and JAX's op-by-op dispatch is not safe from
# two threads of one process.


def flagship_step(batch_np, lr):
    """JAX's dryrun flagship step on the (Hx, Hy, Px, Py, w) numpy batch:
    the loss, the gradients and the parameters after one `optax.adam(lr)`
    step, as numpy."""
    static, params, batch = _on_mesh(batch_np)
    tx = optax.adam(lr)

    def merit(p, Hx, Hy, Px, Py, w):
        h = trace_system(static, p, Hx, Hy, Px, Py, w)
        x, y, i = h.x[-1], h.y[-1], h.intensity[-1]
        wsum = jnp.sum(i) + 1e-12
        cx = jnp.sum(x * i) / wsum
        cy = jnp.sum(y * i) / wsum
        return jnp.sum(((x - cx) ** 2 + (y - cy) ** 2) * i) / wsum

    loss, g = jax.value_and_grad(merit)(params, *batch)
    updates, _ = tx.update(g, tx.init(params))
    p2 = jax.block_until_ready(optax.apply_updates(params, updates))
    return dict(loss=float(loss), grads=_host(g), params=_host(p2))


def spot_step(batch_np):
    """JAX's dryrun spot merit at the primary wavelength on the batch's
    (Hx, Hy, Px, Py): its value and gradients, as numpy."""
    static, params, batch = _on_mesh(batch_np)
    wl = float(np.asarray(params.wavelengths)[static.primary_wavelength_idx])
    sl, sg = jax.value_and_grad(
        lambda q: centroid_rms_spot(static, q, *batch[:4], wl))(params)
    return dict(spot_loss=float(sl), spot_grads=_host(jax.block_until_ready(
        sg)))
