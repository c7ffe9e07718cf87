"""The per-ray-wavelength configuration of K1-K6 (JAX's `uniform_w=False`)
against the JAX package, on the CPU in float64: the plain versions of K1
(`_moments_plain`), K3 (`_raygen_trace_plain`) and K5
(`_fused_trace_plain`) and the cotangents of K2, K4 and K6's
(`_moments_bwd_plain`, `_raygen_trace_bwd_plain`, `_fused_trace_bwd_plain`),
every group, `mat_coeffs` and each ray's w included, on the absorbing Cooke
triplet at 200 rays over its 3 fields and 3 wavelengths; and the
polychromatic `centroid_rms_spot`, the port's eager path against
`jax.grad` of the same call.

The oracle is `jax.vjp` of `jfused._tile_raygen` + `jfused._tile_trace(
static, False, ..., w, for_grad=True)` on whole arrays: the function the
Pallas kernels differentiate inside each tile, without Pallas (see
tests/test_torch_backward.py). Every group is held at atol 1e-10 of its
largest entry. JAX's own K6 (`_fused_bwd`) returns a zero cotangent for
w; the port's K6 returns the derivative, as the kernel body's vjp does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.optimization import merits as jmerits
from optiland_tpu.trace import fused as jfused
from optiland_tpu_torch.optimization import merits as tmerits
from optiland_tpu_torch.trace import fused as tfused

from torch_port_helpers import assert_close, carry_across, jax_build_f64

ATOL = 1e-10     # of each group's largest entry
N_RAYS = 200
C = (0.3, -0.7, 0.5, 1.1)
K4_KEYS = (0, 1, 2, 3, 5, 6, 7)   # all but M
_GROUPS = ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
           "mat_coeffs", "coating_params", "n_table", "grating",
           "phase_params", "focal_length")


@pytest.fixture(scope="module")
def case():
    """The Cooke triplet in both packages (the port's carried across from
    the JAX tables), 200 rays over its fields and wavelengths, and the
    JAX oracle's values and cotangents for the K2 and the K4/K6 seeds."""
    js, jp = jax_build_f64(JCooke())
    ts, tp = carry_across(js, jp)
    rng = np.random.default_rng(11)
    yf = np.asarray(jp.y_fields)
    Hy = rng.choice(yf / yf.max(), N_RAYS)
    Hx = rng.uniform(-0.05, 0.05, N_RAYS)
    r = np.sqrt(rng.uniform(size=N_RAYS))
    th = rng.uniform(0, 2 * np.pi, N_RAYS)
    Px, Py = r * np.cos(th), r * np.sin(th)
    w = rng.choice(np.asarray(jp.wavelengths), N_RAYS)
    assert len(set(w)) == 3 and len(set(Hy)) == 3
    seeds = rng.normal(size=(8, N_RAYS))
    seeds[4] = 0.0   # M's: K4 leaves it out

    diffp = jfused._diff_params(jp)
    nondiffp = jfused._nondiff_params(jp)
    # the port's raygen scalars, for both packages: JAX's eager paraxial
    # trace would cost this file a second and a half. Its EPL and EPD are
    # JAX's (the eager raygen of the polychromatic merit below uses them,
    # held to JAX's loss at 1e-12)
    rg_t = tfused._raygen_scalars(ts, tp)
    rg = jnp.asarray(rg_t.numpy())
    data = tuple(jnp.asarray(a) for a in (Hx, Hy, Px, Py))
    rays8, raygen_vjp = jax.vjp(
        lambda rg_, *d: jfused._tile_raygen(js, rg_, *d), rg, *data)
    final, trace_vjp = jax.vjp(
        lambda dp, r8, w_: jfused._tile_trace(js, False, dp, nondiffp, *r8,
                                              w_, for_grad=True),
        diffp, rays8, jnp.asarray(w))
    x, y, i = (np.asarray(final[k]) for k in (0, 1, 6))
    z = np.zeros(N_RAYS)
    # c . m's per-ray cotangents of the final x, y and i (the absorbing
    # glasses make i depend on the parameters)
    k2_seed = ((i * (C[1] + 2 * C[3] * x), i * (C[2] + 2 * C[3] * y))
               + (z,) * 4 + (C[0] + C[1] * x + C[2] * y
                             + C[3] * (x * x + y * y), z))
    ref = {"final": [np.asarray(v) for v in final]}
    for key, cot in (("K2", k2_seed), ("K4", seeds)):
        d_diff, d_rays8, d_w = trace_vjp(tuple(jnp.asarray(s) for s in cot))
        d_rg, *d_data = raygen_vjp(tuple(d_rays8))
        ref[key] = (np.asarray(d_rg), [np.asarray(g) for g in d_diff],
                    [np.asarray(g) for g in d_data] + [np.asarray(d_w)])
        if key == "K4":
            ref["K6"] = ([np.asarray(g) for g in d_rays8] + [np.asarray(d_w)],
                         ref[key][1])
    p = (tfused._diff_params(tp), tfused._nondiff_params(tp), rg_t)
    t = [torch.tensor(a) for a in (Hx, Hy, Px, Py, w)]
    rays9 = tuple(torch.tensor(np.asarray(a)) for a in rays8) + (t[4],)
    return dict(js=js, jp=jp, ts=ts, tp=tp, p=p, data=tuple(t), rays9=rays9,
                seeds=torch.tensor(seeds), ref=ref)


def _close(got, ref, label):
    assert np.isfinite(got.detach().numpy()).all(), label
    assert_close(got, ref, ATOL, label)


def _close_all(d_rg, d_diff, d_ray, ref, ray_names):
    ref_rg, ref_diff, ref_ray = ref
    if d_rg is not None:
        _close(d_rg, ref_rg, "rg")
    for key, g, r in zip(_GROUPS, d_diff, ref_diff):
        _close(g, r, key)
    assert len(d_ray) == len(ref_ray) == len(ray_names)
    for key, g, r in zip(ray_names, d_ray, ref_ray):
        _close(g, r, key)


def test_forward_plain_matches_jax(case):
    """K1's moments, K3's and K5's final arrays at per-ray wavelengths."""
    ts, (diffp, nondiffp, rg) = case["ts"], case["p"]
    final = case["ref"]["final"]
    x, y, i = final[0], final[1], final[6]
    m = tfused._moments_plain(ts, diffp, nondiffp, rg, case["data"])
    ref_m = [i.sum(), (x * i).sum(), (y * i).sum(), ((x * x + y * y) * i).sum()]
    np.testing.assert_allclose(m.numpy(), ref_m, rtol=1e-12)
    assert 0.0 < i.max() < 1.0   # the glasses absorb
    outs = tfused._raygen_trace_plain(ts, diffp, nondiffp, rg, case["data"],
                                      tuple(range(8)))
    outs5 = tfused._fused_trace_plain(ts, diffp, nondiffp, case["rays9"])
    for key, a, b, r in zip(tfused._NAMES, outs, outs5, final):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-12, atol=1e-12,
                                   err_msg=f"K3 {key}")
        np.testing.assert_allclose(b.numpy(), r, rtol=1e-12, atol=1e-12,
                                   err_msg=f"K5 {key}")


def test_moments_bwd_plain_matches_jax(case):
    """K2 at per-ray wavelengths: rg, every table group (mat_coeffs
    through the dispersion formulas, n_table a placeholder with no
    cotangent) and the 5 data cotangents, w's included; without
    diff_data the same parameter cotangents, bit for bit, and zeros."""
    ts, (diffp, nondiffp, rg) = case["ts"], case["p"]
    c = torch.tensor(C, dtype=torch.float64)
    got = tfused._moments_bwd_plain(ts, diffp, nondiffp, rg, case["data"], c,
                                    True)
    _close_all(*got, case["ref"]["K2"], ("Hx", "Hy", "Px", "Py", "w"))
    assert got[1][6].abs().max() > 0 and got[2][4].abs().max() > 0
    assert not got[1][8].any()
    again = tfused._moments_bwd_plain(ts, diffp, nondiffp, rg, case["data"],
                                      c, False)
    assert torch.equal(got[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
    assert len(again[2]) == 5 and not any(d.any() for d in again[2])


def test_raygen_trace_bwd_plain_matches_jax(case):
    """K4 at per-ray wavelengths, seeds of 7 of the 8 outputs."""
    ts, (diffp, nondiffp, rg) = case["ts"], case["p"]
    seeds = tuple(case["seeds"][k] for k in K4_KEYS)
    got = tfused._raygen_trace_bwd_plain(ts, diffp, nondiffp, rg,
                                         case["data"], K4_KEYS, seeds)
    _close_all(*got, case["ref"]["K4"], ("Hx", "Hy", "Px", "Py", "w"))


def test_fused_trace_bwd_plain_matches_jax(case):
    """K6 at per-ray wavelengths: the 9 ray cotangents (w's the 9th) and
    every table group."""
    ts, (diffp, nondiffp, _) = case["ts"], case["p"]
    d_rays, d_diff = tfused._fused_trace_bwd_plain(
        ts, diffp, nondiffp, case["rays9"], tuple(case["seeds"]))
    _close_all(None, d_diff, d_rays, (None, *case["ref"]["K6"][::-1]),
               tfused._RAY_KEYS)


def test_seams_carry_w(case):
    """The K1/K2 and K5/K6 seams on CPU tensors at per-ray wavelengths:
    the gradient of a leaf upstream of each seam (w itself, mat_coeffs)
    equals the plain versions' cotangent."""
    ts, (diffp, nondiffp, rg) = case["ts"], case["p"]
    mat = diffp[6].clone().requires_grad_(True)
    w = case["data"][4].clone().requires_grad_(True)
    dp = diffp[:6] + (mat,) + diffp[7:]
    m = tfused.fused_spot_moments(ts, (dp, nondiffp, rg),
                                  case["data"][:4] + (w,))
    c = torch.tensor(C, dtype=torch.float64)
    g_mat, g_w = torch.autograd.grad(torch.stack(m) @ c, (mat, w))
    _, d_diff, d_data = tfused._moments_bwd_plain(ts, diffp, nondiffp, rg,
                                                  case["data"], c, True)
    assert torch.equal(g_mat, d_diff[6]) and torch.equal(g_w, d_data[4])
    w9 = case["rays9"][8].clone().requires_grad_(True)
    out = tfused.fused_trace_final(ts, (diffp, nondiffp),
                                   case["rays9"][:8] + (w9,))
    g_w9, = torch.autograd.grad(out, (w9,), tuple(case["seeds"]))
    d_rays, _ = tfused._fused_trace_bwd_plain(ts, diffp, nondiffp,
                                              case["rays9"],
                                              tuple(case["seeds"]))
    assert torch.equal(g_w9, d_rays[8]) and g_w9.abs().max() > 0


def test_polychromatic_centroid_rms_spot_matches_jax(case):
    """`centroid_rms_spot` at per-ray wavelengths: the port's eager path
    against `jax.grad` of the JAX package's call, the loss and the
    gradient of every parameter leaf the merit reaches, and w's."""
    js, jp, ts, tp = case["js"], case["jp"], case["ts"], case["tp"]
    args = [np.asarray(a.numpy()) for a in case["data"]]
    names = ("cv", "conic", "thickness", "mat_coeffs")

    def jloss(leaves, w):
        return jmerits.centroid_rms_spot(js, jp.replace(**leaves), *args[:4],
                                         w)

    jleaves = {k: getattr(jp, k) for k in names}
    jv, (jg, jg_w) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jleaves, jnp.asarray(args[4]))
    leaves = {k: getattr(tp, k).clone().requires_grad_(True) for k in names}
    w = case["data"][4].clone().requires_grad_(True)
    loss = tmerits.centroid_rms_spot(ts, tp.replace(**leaves),
                                     *case["data"][:4], w)
    grads = torch.autograd.grad(loss, [*leaves.values(), w])
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-12)
    for k, g in zip(names, grads):
        _close(g, np.asarray(jg[k]), k)
    _close(grads[-1], np.asarray(jg_w), "w")
    assert np.abs(np.asarray(jg["mat_coeffs"])).max() > 0
