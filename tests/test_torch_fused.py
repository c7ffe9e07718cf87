"""Parity of the port's fused trace kernels (K1 `_moments_forward`, K3
`_raygen_forward`) with the JAX package.

On the CPU the port's plain PyTorch versions (`_moments_plain`,
`_raygen_trace_plain`, the arithmetic of csrc/chain.cuh) are held in
float64 against the JAX Pallas kernels run in interpret mode, on the small
singlets of tests/test_fused_kernel.py (K1 on the tilted, decentered,
clipped even-asphere singlet, K3 on the odd-asphere mirror: between them
every branch of the chain), at n = 200 rays (not a multiple of the 128-lane
tile) and rtol 1e-10. The 13-surface bench lens is held against the JAX
XLA path in tests/test_torch_slice.py (interpret mode costs ~30 s there);
tests/test_fused_kernel.py pins that path to the kernel.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.trace import fused as jfused
from optiland_tpu_torch.system.spec import PHASE_GRID
from optiland_tpu_torch.trace import fused as tfused

from torch_port_helpers import bench_lens, build_both, singlet_lens

RTOL = 1e-10
N_RAYS = 200

_SYSTEMS = {
    "singlet": dict(),
    "tilt_decenter_aperture": dict(tilt=True, decenter=True, aperture=4.5),
    "odd_asphere_mirror": dict(mirror=True, odd=True),
}


def _system(name):
    return build_both(lambda O: singlet_lens(O, **_SYSTEMS[name]),
                      newton_iters=4)


def _data(seed=11, n=N_RAYS):
    rng = np.random.default_rng(seed)
    Px, Py = rng.uniform(-0.9, 0.9, (2, n))
    Hx, Hy = rng.uniform(-0.5, 0.5, (2, n))
    return Hx, Hy, Px, Py


def _port_args(ts, tp, w):
    return tfused._uniform_params(ts, tp, w) + (
        tfused._raygen_scalars(ts, tp),)


def _t(arrays):
    return tuple(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("name", ["tilt_decenter_aperture"])
def test_moments_plain_matches_jax_kernel(name):
    (js, jp), (ts, tp) = _system(name)
    data = _data()
    ref = jax.jit(lambda p, *d: jfused.spot_moments(
        js, p, *d, 0.55, interpret=True))(jp, *(jnp.asarray(a) for a in data))
    got = tfused._moments_plain(ts, *_port_args(ts, tp, 0.55), _t(data))
    assert float(ref[0]) > 0
    for j in range(4):
        np.testing.assert_allclose(float(got[j]), float(ref[j]), rtol=RTOL,
                                   err_msg=f"m{j}")


@pytest.mark.parametrize("name", ["odd_asphere_mirror"])
def test_raygen_trace_plain_matches_jax_kernel(name):
    (js, jp), (ts, tp) = _system(name)
    data = _data(seed=3)
    ref = jfused.trace_system_final_fused(
        js, jp, *(jnp.asarray(a) for a in data), jnp.asarray(0.55),
        interpret=True)
    got = tfused._raygen_trace_plain(ts, *_port_args(ts, tp, 0.55), _t(data),
                                     tuple(range(8)))
    for k, key in enumerate(tfused._NAMES):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, atol=1e-12, err_msg=key)


@pytest.fixture(scope="module")
def bench_pair():
    return build_both(bench_lens)


def test_cpu_dispatch_is_eager_and_launches_nothing(bench_pair):
    _, (ts, tp) = bench_pair
    k1, k3 = tfused.moments_forward.launches, \
        tfused.raygen_trace_forward.launches
    data = _t(_data(seed=0, n=64))
    m = tfused.spot_moments(ts, tp, *data, 0.5876)
    plain = tfused._moments_plain(ts, *_port_args(ts, tp, 0.5876), data)
    for j in range(4):
        np.testing.assert_allclose(float(m[j]), float(plain[j]), rtol=RTOL)
    assert (tfused.moments_forward.launches,
            tfused.raygen_trace_forward.launches) == (k1, k3)


def test_kernel_seams_refuse_backward(bench_pair):
    """The K1 and K3 seams no longer refuse a backward: on CPU tensors
    their gradients (K2, K4) equal the plain versions', here for cv and
    for the raygen scalars through autograd around the seam."""
    _, (ts, tp) = bench_pair
    data = _t(_data(seed=0, n=16))
    diffp, nondiffp, rg = _port_args(ts, tp, 0.5876)
    cv = diffp[0].clone().requires_grad_(True)
    rg_ = rg.clone().requires_grad_(True)
    p = ((cv,) + tuple(diffp[1:]), nondiffp, rg_)
    m = tfused.fused_spot_moments(ts, p, data)
    g_cv, g_rg = torch.autograd.grad(m[3], (cv, rg_))
    c = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    d_rg, d_diff, _ = tfused._moments_bwd_plain(ts, diffp, nondiffp, rg,
                                                data, c, True)
    assert torch.equal(g_cv, d_diff[0]) and torch.equal(g_rg, d_rg)
    assert g_cv.abs().max() > 0

    out = tfused.fused_raygen_trace_final(ts, (0, 1), p, data)
    g_cv, g_rg = torch.autograd.grad(out[0].sum(), (cv, rg_))
    d_rg, d_diff, _ = tfused._raygen_trace_bwd_plain(
        ts, diffp, nondiffp, rg, data, (0, 1),
        (torch.ones(16, dtype=torch.float64), None))
    assert torch.equal(g_cv, d_diff[0]) and torch.equal(g_rg, d_rg)
    assert g_rg.abs().max() > 0


def test_unported_chain_branches_raise():
    """No chain branch of JAX's kernels is left to port: a phase sheet at
    one wavelength and at per-ray wavelengths, a simple coating and a
    Forbes Q-2D face (system J of chip_smoke.py; tests/test_torch_freeform.py
    holds it to JAX) pass the kernels' plain versions. What JAX's gate
    leaves to the eager trace is refused by name before a launch, as are
    the forms the tables cannot hold: a grid sag or NURBS geometry, a grid
    or height-profile sheet, and a phase sheet on an asphere."""
    (_, _), (ts, tp) = build_both(
        lambda O: singlet_lens(O, asphere=False))
    from dataclasses import replace

    from optiland_tpu_torch.geometry.surfaces import GEOM_GRID_SAG, GEOM_NURBS
    from torch_port_helpers import SMOKE, TOptic

    phased = replace(ts, interactions=(3, tfused.INT_PHASE, 0, 3),
                     phase_kinds=(0, tfused.PHASE_CONSTANT, 0, 0))
    assert tfused.supports_fused(phased)
    diffp, nondiffp = tfused._uniform_params(phased, tp, 0.55)
    m = tfused._moments_plain(phased, diffp, nondiffp,
                              tfused._raygen_scalars(ts, tp),
                              _t(_data(n=8)))
    assert bool(torch.isfinite(m).all()) and float(m[0]) > 0
    # per-ray wavelengths are a configuration of every kernel, no branch
    out = tfused.trace_system_final_fused(
        phased, tp, *_t(_data(n=8)), torch.full((8,), 0.55,
                                                dtype=torch.float64))
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    ts_q, tp_q = SMOKE.q2d_singlet(TOptic).build(device="cpu")
    assert tfused.supports_fused(ts_q)
    m = tfused._moments_plain(ts_q, *_port_args(ts_q, tp_q, 0.55),
                              _t(_data(n=8)))
    assert bool(torch.isfinite(m).all()) and 7.9 < float(m[0]) <= 8.0
    out = tfused.trace_system_final_fused(ts_q, tp_q, *_t(_data(n=8)), 0.55)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    for code in (GEOM_GRID_SAG, GEOM_NURBS):
        eager = replace(ts, geom_codes=(0, code, 1, 0))
        assert not tfused.supports_fused(eager)
        with pytest.raises(ValueError, match="no grid sag or NURBS"):
            tfused._moments_plain(eager, *_port_args(ts, tp, 0.55),
                                  _t(_data(n=8)))
        with pytest.raises(ValueError, match="no grid sag or NURBS"):
            tfused.trace_system_final_fused(eager, tp, *_t(_data(n=8)), 0.55)
    gridded = replace(phased, phase_kinds=(0, PHASE_GRID, 0, 0))
    assert not tfused.supports_fused(gridded)
    with pytest.raises(ValueError, match="not grid or height profiles"):
        tfused._moments_plain(gridded, diffp, nondiffp,
                              tfused._raygen_scalars(ts, tp), _t(_data(n=8)))
    aspheric = replace(phased, geom_codes=(0, tfused.GEOM_EVEN_ASPHERE, 1, 0))
    with pytest.raises(ValueError, match="phase sheet on a geometry"):
        tfused._moments_plain(aspheric, diffp, nondiffp,
                              tfused._raygen_scalars(ts, tp), _t(_data(n=8)))
    coated = replace(ts, coatings=(0, 1, 0, 0))
    tfused._moments_plain(coated, *_port_args(ts, tp, 0.55), _t(_data(n=8)))


def test_phase_table_width_follows_configuration():
    """A launch's table takes the phase table of its own configuration: at
    one wavelength the 8 profile slots and the hoisted 1 / k0
    (`_uniform_params`), at per-ray wavelengths the 8 slots, 1 / k0 per um
    padded in. A table of the other width raises rather than trace the
    sheet at another wavelength (the plain version fails on the missing
    column)."""
    from dataclasses import replace

    from torch_port_helpers import TOptic

    ts, tp = singlet_lens(TOptic, asphere=False).build(device="cpu")
    phased = replace(ts, interactions=(3, tfused.INT_PHASE, 0, 3),
                     phase_kinds=(0, tfused.PHASE_CONSTANT, 0, 0))
    one = tfused._uniform_params(phased, tp, 0.55)
    own = (tfused._diff_params(tp), tfused._nondiff_params(tp))
    ftab = tfused._pack_tables(phased, *one, False)[0]
    assert float(ftab[1, tfused._F_PHASE_IK]) == pytest.approx(
        0.55 * tfused._INV_K0_PER_UM, rel=1e-15)
    ftab = tfused._pack_tables(phased, *own, True)[0]
    assert float(ftab[1, tfused._F_PHASE_IK]) == tfused._INV_K0_PER_UM
    with pytest.raises(ValueError, match="hoisted 1 / k0"):
        tfused._pack_tables(phased, *own, False)
    with pytest.raises(ValueError, match="per-ray wavelengths takes"):
        tfused._pack_tables(phased, *one, True)
