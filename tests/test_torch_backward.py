"""Parity of the port's backward kernels' plain versions (K2
`_moments_bwd_plain`, K4 `_raygen_trace_bwd_plain`, K6
`_fused_trace_bwd_plain`, and K5 `_fused_trace_plain`) with the JAX
package's kernel body, on the CPU in float64.

The oracle is `jax.vjp` of `jfused._tile_raygen` + `jfused._tile_trace(...,
for_grad=True)` on whole arrays: the function the Pallas backward kernels
differentiate inside each tile, without Pallas (a JAX backward through
interpret mode costs 15-27 s per gradient). One forward per system serves
every seed: K2's seeds are c . m's per-ray cotangents of the final (x, y),
i (c1 + 2 c3 x) and i (c2 + 2 c3 y); K4 and K6 share one set. Systems: the three singlets of
tests/test_torch_fused.py and the 13-surface bench lens, 200 rays. Every
cotangent group is held at atol 1e-10 of its largest entry.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.trace import fused as jfused
from optiland_tpu_torch.trace import fused as tfused

from torch_port_helpers import bench_lens, build_both, singlet_lens

ATOL = 1e-10     # of each cotangent group's largest entry
N_RAYS = 200
C = (0.3, -0.7, 0.5, 1.1)
K4_KEYS = (0, 1, 2, 3, 5, 7)   # x, y, z, L, N, opd: a subset of the outputs
_GROUPS = ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
           "mat_coeffs", "coating_params", "n_table", "grating",
           "phase_params", "focal_length")
_SYSTEMS = {
    "singlet": lambda O: singlet_lens(O),
    "tilt_decenter_aperture": lambda O: singlet_lens(
        O, tilt=True, decenter=True, aperture=4.5),
    "odd_asphere_mirror": lambda O: singlet_lens(O, mirror=True, odd=True),
    "bench": bench_lens,
}
_cache = {}


def _case(name):
    """The system in both packages, the data, the port's kernel arguments,
    and the JAX oracle's cotangents for the K2, K4 and K6 seeds."""
    if name in _cache:
        return _cache[name]
    (js, jp), (ts, tp) = build_both(
        _SYSTEMS[name], newton_iters=None if name == "bench" else 4)
    w = 0.5876 if name == "bench" else 0.55
    rng = np.random.default_rng(7)
    Px, Py = rng.uniform(-0.9, 0.9, (2, N_RAYS))
    Hx, Hy = rng.uniform(-0.5, 0.5, (2, N_RAYS))
    data = (Hx, Hy, Px, Py)
    # the seeds of K4's out_keys and of i (K6 seeds all eight; M's is 0)
    seeds = rng.normal(size=(8, N_RAYS))
    seeds[[k for k in range(8) if k not in K4_KEYS + (6,)]] = 0.0
    if name == "odd_asphere_mirror":
        # the image lies on surface 2 (thickness 0): the last step's
        # opd += |t n| sits at the kink t = 0, where the two packages round
        # t to opposite signs and so take opposite one-sided derivatives
        seeds[7] = 0.0

    n_table, alpha = jfused._uniform_tables(js, jp, w)
    diffp = jfused._diff_params(jp, n_table)
    nondiffp = jfused._nondiff_params(jp, alpha)
    rg = jfused._raygen_scalars(js, jp)
    rays8, raygen_vjp = jax.vjp(
        lambda rg_, *d: jfused._tile_raygen(js, rg_, *d), rg,
        *(jnp.asarray(a) for a in data))
    wv = jnp.full((N_RAYS,), w)
    final, trace_vjp = jax.vjp(
        lambda dp, r8: jfused._tile_trace(js, True, dp, nondiffp, *r8, wv,
                                          for_grad=True), diffp, rays8)

    # two backward passes: K2's seeds, and the K4 seeds plus a seed of i,
    # which serve K6 too (the raygen's i is a constant, so the seed of i
    # reaches only K6's starting i)
    x, y, i = (np.asarray(final[k]) for k in (0, 1, 6))
    z = np.zeros(N_RAYS)
    k2_seed = (i * (C[1] + 2 * C[3] * x), i * (C[2] + 2 * C[3] * y)) + (z,) * 6
    ref = {"final": [np.asarray(v) for v in final]}
    for key, cot in (("K2", k2_seed), ("K4", seeds)):
        d_diff, d_rays8 = trace_vjp(tuple(jnp.asarray(s) for s in cot))
        d_rg, *d_data = raygen_vjp(tuple(d_rays8))
        ref[key] = (np.asarray(d_rg), [np.asarray(g) for g in d_diff],
                    [np.asarray(g) for g in d_data])
        if key == "K4":
            ref["K6"] = ([np.asarray(g) for g in d_rays8], ref[key][1])

    t_nt, t_alpha = tfused._uniform_tables(ts, tp, w)
    args = (tfused._diff_params(tp, t_nt), tfused._nondiff_params(tp, t_alpha),
            tfused._raygen_scalars(ts, tp))
    _cache[name] = dict(
        ts=ts, args=args, data=tuple(torch.tensor(a) for a in data),
        rays8=tuple(torch.tensor(np.asarray(r)) for r in rays8),
        seeds=torch.tensor(seeds), ref=ref)
    return _cache[name]


def _close(got, ref, label):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.shape(ref), label
    assert np.isfinite(got).all(), label
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got / scale, np.asarray(ref) / scale, rtol=0,
                               atol=ATOL, err_msg=label)


def _close_groups(d_diff, ref_diff):
    for key, g, r in zip(_GROUPS, d_diff, ref_diff):
        _close(g, r, key)


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_moments_bwd_plain_matches_jax(name):
    case = _case(name)
    ts, (diffp, nondiffp, rg) = case["ts"], case["args"]
    ref_rg, ref_diff, ref_data = case["ref"]["K2"]
    c = torch.tensor(C, dtype=torch.float64)
    d_rg, d_diff, d_data = tfused._moments_bwd_plain(
        ts, diffp, nondiffp, rg, case["data"], c, True)
    _close(d_rg, ref_rg, "rg")
    _close_groups(d_diff, ref_diff)
    for key, g, r in zip(("Hx", "Hy", "Px", "Py"), d_data, ref_data):
        _close(g, r, key)
    assert np.abs(ref_diff[0]).max() > 0 and np.abs(ref_data[1]).max() > 0
    # params only: the same parameter cotangents, bit for bit, and zeros
    d_rg2, d_diff2, d_data2 = tfused._moments_bwd_plain(
        ts, diffp, nondiffp, rg, case["data"], c, False)
    assert torch.equal(d_rg, d_rg2)
    assert all(torch.equal(a, b) for a, b in zip(d_diff, d_diff2))
    assert all(g.shape == (N_RAYS,) and not g.any() for g in d_data2)


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_raygen_trace_bwd_plain_matches_jax(name):
    case = _case(name)
    ts, (diffp, nondiffp, rg) = case["ts"], case["args"]
    ref_rg, ref_diff, ref_data = case["ref"]["K4"]
    seeds = tuple(case["seeds"][k] for k in K4_KEYS)
    d_rg, d_diff, d_data = tfused._raygen_trace_bwd_plain(
        ts, diffp, nondiffp, rg, case["data"], K4_KEYS, seeds)
    _close(d_rg, ref_rg, "rg")
    _close_groups(d_diff, ref_diff)
    for key, g, r in zip(("Hx", "Hy", "Px", "Py"), d_data, ref_data):
        _close(g, r, key)
    # an unrequested seed (None) is a zero seed
    d_rg0, _, _ = tfused._raygen_trace_bwd_plain(
        ts, diffp, nondiffp, rg, case["data"], K4_KEYS,
        seeds[:3] + (None,) * 3)
    d_rg1, _, _ = tfused._raygen_trace_bwd_plain(
        ts, diffp, nondiffp, rg, case["data"], K4_KEYS[:3], seeds[:3])
    assert torch.equal(d_rg0, d_rg1)


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_fused_trace_plain_and_bwd_match_jax(name):
    case = _case(name)
    ts, (diffp, nondiffp, _) = case["ts"], case["args"]
    final = tfused._fused_trace_plain(ts, diffp, nondiffp, case["rays8"])
    for key, got, ref in zip(tfused._NAMES, final, case["ref"]["final"]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12,
                                   err_msg=key)
    ref_rays, ref_diff = case["ref"]["K6"]
    d_rays, d_diff = tfused._fused_trace_bwd_plain(
        ts, diffp, nondiffp, case["rays8"], tuple(case["seeds"]))
    for key, g, r in zip(tfused._NAMES, d_rays, ref_rays):
        _close(g, r, "d" + key)
    _close_groups(d_diff, ref_diff)


def test_caller_ray_seam_matches_plain():
    """`fused_trace_final` (K5 forward, K6 backward at the autograd seam)
    on CPU tensors: values and the gradients of leaves upstream of the
    seam (cv through the tables, a starting array) equal the plain
    versions'."""
    case = _case("tilt_decenter_aperture")
    ts, (diffp, nondiffp, _) = case["ts"], case["args"]
    cv = diffp[0].clone().requires_grad_(True)
    x0 = case["rays8"][0].clone().requires_grad_(True)
    dp = (cv,) + tuple(diffp[1:])
    rays8 = (x0,) + case["rays8"][1:]
    out = tfused.fused_trace_final(ts, (dp, nondiffp), rays8)
    seeds = tuple(case["seeds"])
    g_cv, g_x0 = torch.autograd.grad(out, (cv, x0), seeds)
    d_rays, d_diff = tfused._fused_trace_bwd_plain(ts, diffp, nondiffp,
                                                   case["rays8"], seeds)
    assert torch.equal(g_cv, d_diff[0]) and torch.equal(g_x0, d_rays[0])


def test_spot_moments_diff_inputs_opt_out():
    """The port's `test_spot_moments_diff_inputs_opt_out`: through the K1/K2
    seam, diff_data=False keeps the parameter gradients of the
    centroid-RMS loss bit-identical and returns zero input cotangents."""
    case = _case("bench")
    ts, (diffp, nondiffp, rg) = case["ts"], case["args"]
    Hx, Hy, Px, Py = case["data"]

    def loss_and_grads(diff_data):
        cv = diffp[0].clone().requires_grad_(True)
        hy = Hy.clone().requires_grad_(True)
        m0, m1, m2, m3 = tfused.fused_spot_moments(
            ts, ((cv,) + tuple(diffp[1:]), nondiffp, rg), (Hx, hy, Px, Py),
            diff_data)
        ws = m0 + 1e-6
        cx, cy = m1 / ws, m2 / ws
        loss = (m3 - 2.0 * (cx * m1 + cy * m2) + (cx * cx + cy * cy) * m0) / ws
        return (loss,) + torch.autograd.grad(loss, (cv, hy))

    v1, g_cv1, g_hy1 = loss_and_grads(True)
    v2, g_cv2, g_hy2 = loss_and_grads(False)
    assert v1.item() == v2.item()
    assert torch.equal(g_cv1, g_cv2) and g_cv1.abs().max() > 0
    assert g_hy1.abs().max() > 0
    assert not g_hy2.any()
