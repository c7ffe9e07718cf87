"""The eager conic root of the PyTorch port on rays that miss a conic,
against the JAX package, float64 on the CPU.

A ray whose line misses a conic (discriminant < 0) goes dark; the JAX
package then takes the clamped double root -B / 2A, and so does the port
(`geometry/surfaces._conic_intersect`), while rays that hit keep the
stable roots q / A and C / q. ProjectionLens160FOV at Hy 0.5 has such
rays, and `rms_spot_size` averages them without a weight.

JAX's `jax.grad` of that operand is NaN (the derivative of its clamped
square root at a missed conic is 0 * inf), so the port's gradient is held
to a central difference of JAX's values instead: one eager vmapped JAX
trace gives the history at the base point and at the difference points
(a jit of it compiles for longer than it runs)."""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.core import distributions as jdist
from optiland_tpu.models import zoo as jzoo
from optiland_tpu.trace.tracer import trace_system as jtrace
from optiland_tpu_torch import config
from optiland_tpu_torch.models import zoo as tzoo
from optiland_tpu_torch.optimization import operands as tops
from optiland_tpu_torch.trace.tracer import trace_system as ttrace

from torch_port_helpers import assert_close, carry_across, jax_build_f64

RTOL = 1e-10
HY = 0.5
RINGS = 6
STEP = 1e-6
# (leaf, index) pairs of the difference: two curvatures, two gaps
FD_LEAVES = (("cv", 2), ("cv", 9), ("thickness", 3), ("thickness", 12))


def _rms(x, y):
    r2 = (x - x.mean(-1, keepdims=True)) ** 2 + (y - y.mean(-1,
                                                          keepdims=True)) ** 2
    return np.sqrt(r2.mean(-1))


def test_missed_conic_history_and_rms_spot_size():
    js, jp = jax_build_f64(jzoo.ProjectionLens160FOV())
    ts, tp = carry_across(js, jp)
    wl = float(jp.wavelengths[js.primary_wavelength_idx])
    Px, Py = jdist.generate("hexapolar", RINGS)[:2]

    # the base point, then each leaf at -2, -1, +1, +2 steps
    sets = [(jp.cv, jp.thickness)]
    for name, k in FD_LEAVES:
        for s in (-2.0, -1.0, 1.0, 2.0):
            cv, th = jp.cv, jp.thickness
            if name == "cv":
                cv = cv.at[k].add(s * STEP)
            else:
                th = th.at[k].add(s * STEP)
            sets.append((cv, th))
    cvs = jnp.stack([a for a, _ in sets])
    ths = jnp.stack([b for _, b in sets])
    H = jax.vmap(lambda cv, th: jtrace(
        js, jp.replace(cv=cv, thickness=th), jnp.zeros_like(Px),
        jnp.full_like(Px, HY), Px, Py, wl))(cvs, ths)
    jx, jy = np.asarray(H.x), np.asarray(H.y)
    rms_j = _rms(jx[:, -1], jy[:, -1])

    # the port's history, dark rays included, row by row
    Pxt, Pyt = (torch.tensor(np.asarray(a)) for a in (Px, Py))
    h = ttrace(ts, tp, torch.zeros_like(Pxt), torch.full_like(Pxt, HY), Pxt,
               Pyt, wl)
    dark = np.asarray(H.intensity[0, -1]) == 0
    assert dark.sum() > 0, "the probe must have rays that miss a conic"
    for key in ("x", "y", "z", "L", "M", "N", "opd", "intensity"):
        assert_close(getattr(h, key), np.asarray(getattr(H, key)[0]), RTOL,
                     key)

    # the operand, and its gradient against JAX's central difference
    leaves = {"cv": tp.cv.clone().requires_grad_(True),
              "thickness": tp.thickness.clone().requires_grad_(True)}
    v = tops.rms_spot_size(ts, tp.replace(**leaves), -1, 0.0, HY, RINGS, wl)
    np.testing.assert_allclose(v.item(), rms_j[0], rtol=RTOL)
    v.backward()
    for j, (name, k) in enumerate(FD_LEAVES):
        f = rms_j[1 + 4 * j: 5 + 4 * j]
        fd = (f[0] - 8.0 * f[1] + 8.0 * f[2] - f[3]) / (12.0 * STEP)
        got = leaves[name].grad[k].item()
        assert math.isfinite(got)
        np.testing.assert_allclose(got, fd, rtol=1e-7, err_msg=f"{name}[{k}]")


def test_hubble_float32_image_near_float64():
    """The stable roots keep the telescope's far, shallow primary: its
    float32 trace stays within 1e-5 of float64's scale at every row."""
    out = {}
    for prec in ("float32", "float64"):
        config.set_precision(prec)
        try:
            out[prec] = tzoo.HubbleTelescope().trace(Hy=1.0, num_rays=12,
                                                     device="cpu")
        finally:
            config.set_precision("float64")
    lit = out["float64"].intensity > 0
    for key in ("x", "y", "z"):
        a = getattr(out["float32"], key).double()
        b = getattr(out["float64"], key)
        scale = b[lit].abs().max()
        err = ((a - b).abs() * lit).max() / scale
        assert err <= 1e-5, (key, err.item())
