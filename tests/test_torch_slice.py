"""The first slice of the PyTorch port end to end on the CPU, against the
JAX package: the benchmark's 13-surface, 4-asphere lens built in both
packages (and carried across with `params_from_numpy`), 200 rays drawn as
the benchmark draws them, float64.

Held at rtol 1e-10: `trace_system_final`, `centroid_rms_spot` and the
port's plain kernel versions against the JAX XLA path. The eager autograd
gradients of `centroid_rms_spot` with respect to cv, conic, coeffs and
thickness are held against `jax.grad` at atol 1e-8 of the largest entry
(these gradients are the oracle the next slice's backward kernels meet)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.optimization import merits as jmerits
from optiland_tpu.trace import fused as jfused
from optiland_tpu.trace import tracer as jtracer
from optiland_tpu_torch.optimization import merits as tmerits
from optiland_tpu_torch.trace import fused as tfused
from optiland_tpu_torch.trace import tracer as ttracer

from torch_port_helpers import bench_lens, build_both

RTOL = 1e-10
W = 0.5876
_GRAD_FIELDS = ("cv", "conic", "coeffs", "thickness")


def _bench_rays(n=200):
    rng = np.random.default_rng(0)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    Hy = rng.uniform(-1, 1, size=n)
    return np.zeros(n), Hy, r * np.cos(th), r * np.sin(th)


def _loss_from_moments(m0, m1, m2, m3, eps=1e-6):
    # `centroid_rms_spot`'s expansion of the moments (merits.py)
    ws = m0 + eps
    cx, cy = m1 / ws, m2 / ws
    return (m3 - 2.0 * (cx * m1 + cy * m2) + (cx * cx + cy * cy) * m0) / ws


@pytest.fixture(scope="module")
def ref():
    """Both systems, the rays, and the JAX references from one eager XLA
    evaluation: off the TPU, `centroid_rms_spot` is the loss of the four
    moment sums of the `trace_system_final` state (checked below)."""
    (js, jp), (ts, tp) = build_both(bench_lens)
    data = _bench_rays()
    jd = tuple(jnp.asarray(a) for a in data)

    def loss_and_final(p):
        f = jtracer.trace_system_final(js, p, *jd, W)
        x, y, i = f["x"], f["y"], f["intensity"]
        m = (jnp.sum(i), jnp.sum(x * i), jnp.sum(y * i),
             jnp.sum((x * x + y * y) * i))
        return _loss_from_moments(*m), (f, m)

    (loss, (final, moments)), grad = jax.value_and_grad(
        loss_and_final, has_aux=True)(jp)
    return dict(js=js, jp=jp, jd=jd, ts=ts, tp=tp,
                data=tuple(torch.tensor(a) for a in data),
                final={k: np.asarray(v) for k, v in final.items()},
                moments=[float(v) for v in moments], loss=float(loss),
                grad={k: np.asarray(getattr(grad, k)) for k in _GRAD_FIELDS})


def test_trace_system_final(ref):
    got = ttracer.trace_system_final(ref["ts"], ref["tp"], *ref["data"], W)
    assert set(got) == set(ref["final"])
    for key, val in ref["final"].items():
        np.testing.assert_allclose(got[key].numpy(), val, rtol=RTOL,
                                   atol=1e-12, err_msg=key)


def test_plain_kernel_versions_match_xla(ref):
    ts, tp = ref["ts"], ref["tp"]
    # the bench lens is inside both kernel gates in both packages
    assert ts.num_surfaces == 13 and ts.fused_newton_ok
    assert not any(ts.has_aperture)
    assert tfused.supports_fused(ts) and tfused.supports_fused_raygen(ts)
    assert jfused.supports_fused(ref["js"])
    assert jfused.supports_fused_raygen(ref["js"])
    n_table, alpha = tfused._uniform_tables(ts, tp, W)
    args = (tfused._diff_params(tp, n_table),
            tfused._nondiff_params(tp, alpha), tfused._raygen_scalars(ts, tp))
    f, moments = ref["final"], ref["moments"]
    got_m = tfused._moments_plain(ts, *args, ref["data"])
    for j in range(4):
        np.testing.assert_allclose(float(got_m[j]), moments[j], rtol=RTOL,
                                   err_msg=f"m{j}")
    got_f = tfused._raygen_trace_plain(ts, *args, ref["data"],
                                       tuple(range(8)))
    for k, key in enumerate(tfused._NAMES):
        np.testing.assert_allclose(got_f[k].numpy(), f[key], rtol=RTOL,
                                   atol=1e-12, err_msg=key)


def test_centroid_rms_spot_value_and_gradients(ref):
    ts, tp = ref["ts"], ref["tp"]
    leaves = {k: getattr(tp, k).clone().requires_grad_(True)
              for k in _GRAD_FIELDS}
    loss = tmerits.centroid_rms_spot(ts, tp.replace(**leaves), *ref["data"],
                                     W)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=RTOL)
    # the JAX merit itself gives the same loss
    np.testing.assert_allclose(float(jmerits.centroid_rms_spot(
        ref["js"], ref["jp"], *ref["jd"], W)), ref["loss"], rtol=1e-13)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for key, g in zip(_GRAD_FIELDS, grads):
        b = ref["grad"][key]
        a = g.numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all(), key
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-8,
                                   err_msg=key)
    assert np.abs(ref["grad"]["coeffs"]).max() > 0
