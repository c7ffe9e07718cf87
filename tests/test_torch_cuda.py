"""The port's CUDA kernels on the card (no JAX needed): K1-K7 against
their plain PyTorch versions in float32 (K1-K6 also on the absorbing Cooke
triplet, on the coating, grating, thin-lens, phase and freeform systems,
K1, K3, K5 and K7 on every system built here, each its own
variant, all built at once by the module's `system_variants`; K7 at
per-ray wavelengths, and K1-K6's per-ray variants on the Cooke triplet and
on a doublet of a tabulated glass; K1, K2, K4 and K6 also at ragged ray counts around
their 32-ray groups and at 2M + 17 rays, K3, K5 and K7 around their
256-ray tiles;
K3 leaving an unrequested output untouched; the per-system launchers
refusing another system's S), K8 (the Huygens sum) against the
float64 plain version, also at ragged block edges, T1's peak-rate chains
against theirs, the bitwise reproducibility of the backward kernels'
parameter cotangents, of K1 and of K8, the dispatch of the public entry
points (and their backward) to the kernels, K5/K6 after the eager raygen
of a telecentric and a real-image-height system and K7 on an iteratively
aimed bundle, the design loop's merit and a tolerancing draw through K7
(chip_smoke.py phase j8) against K7's plain version, and the explicit
refusal of a branch or an input a kernel does not take; and the eager
paths that JAX's gates keep from the kernels (chip_smoke.py phase j9: a
Fresnel-coated polarized trace, a vectorial FFT PSF) in float32 against
float64 on the card; and the spot diagram's K7 rows against K7's plain
version and its radii against float64 (chip_smoke.py phase j10). Every
test skips without a CUDA device and nvcc.

On a machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from optiland_tpu_torch import _build as kbuild
from optiland_tpu_torch import config
from optiland_tpu_torch.geometry.surfaces import GEOM_GRID_SAG, GEOM_NURBS
from optiland_tpu_torch.models import CookeTriplet
from optiland_tpu_torch.mtf import HuygensMTF
from optiland_tpu_torch.psf import ScalarHuygensPSF
from optiland_tpu_torch.psf import huygens
from optiland_tpu_torch.system.optic import Optic
from optiland_tpu_torch.tools import vpu_peak
from optiland_tpu_torch.models import UVProjectionLens
from optiland_tpu_torch.trace import aiming, fused, tracer
from optiland_tpu_torch.trace.raygen import generate_rays
from optiland_tpu_torch.wavefront.core import pupil_grid_coords, wavefront_data

from torch_port_helpers import (
    SMOKE,
    aimed_singlet,
    bench_lens,
    coated_cooke,
    coated_singlet,
    curved_grating,
    curved_metalens,
    hybrid_achromat,
    phase_mirror,
    singlet_lens,
    spectrograph,
    tabulated_doublet,
    thin_lens_system,
)

pytestmark = pytest.mark.cuda

# float32, kernel against plain: the two round differently (FMA
# contraction, hardware rsqrt), a few ulps per surface at mm scales; an
# intensity through absorbing glass is a product of f32 exp factors of
# ~0.9995, a few ulps (6e-8) apart
POS_TOL, DIR_TOL, OPD_TOL, MOMENT_RTOL = 5e-4, 1e-5, 2e-3, 1e-4
INT_TOL = 2e-6
_TOLS = (POS_TOL,) * 3 + (DIR_TOL,) * 3 + (INT_TOL, OPD_TOL)
# float32 cotangents, kernel against plain, relative to each group's
# largest entry: a parameter's sums 5000 per-ray terms, of both signs under
# random seeds, so it cancels to a small fraction of their size (1.3e-4
# measured on an H100 for a singlet's conic); per-ray cotangents carry the
# chain's conditioning (6e-4 measured at 2M rays on the bench lens)
PARAM_GRAD_RTOL, RAY_GRAD_RTOL = 1e-3, 5e-3
# the phase systems D-F, whose groups that miss PARAM_GRAD_RTOL (sums that
# cancel under the seeds) are held to float64 instead (`_assert_params`)
_PHASE = ("hybrid_achromat", "metalens", "phase_mirror")
# the 70-surface relay train (L): a group that misses PARAM_GRAD_RTOL joins
# that float64 check only where the plain float32 version itself misses it
# against float64 on the same inputs (K6's `coeffs` under its random seeds:
# 1.1e-3 on the CPU, the kernel 1.1e-3 off the plain version on an H100);
# so too the 44-surface UV projection lens (chip_smoke.py
# LONG_TRACK_SYSTEMS), whose final arrays past _TOLS pass as near float64
# (`SMOKE.final_float64_errs`)
_LONG = ("relay_train", "uv_projection")

_SYSTEMS = {
    "singlet": dict(),
    "tilt_decenter_aperture": dict(tilt=True, decenter=True, aperture=4.5),
    "odd_asphere_mirror": dict(mirror=True, odd=True),
}


_PER_SYSTEM = ("moments_fwd", "raygen_trace_fwd", "fused_trace_fwd")
_BACKWARD = ("moments_bwd", "raygen_trace_bwd", "fused_trace_bwd")
# the systems of the coating, thin-lens, grating and phase branches
# (OTK_INTERACTIONS, and OTK_PHASE for the phase sheets): the coated singlet
# and Cooke triplet, the coated thin lens, the spectrograph (thin lenses and
# a plane grating, object heights), the concave reflective grating, coated,
# and chip_smoke.py's phase systems D-F: the hybrid achromat (radial and
# constant sheets behind N-BK7), the coated metalens on a conic carrier and
# the tilted reflective linear-grating sheet; its freeform systems G-I
# (OTK_FREEFORM): the biconic and toroidal singlet, the poly-XY and Zernike
# singlet, the tilted, decentred Chebyshev and Forbes Q-bfs singlet; and
# its systems J-L: the tilted, decentred Forbes Q-2D singlet, the singlet
# of a 38-slot Zernike and a 29-slot Q-2D (OTK_WIDE), the 70-surface relay
# train (OTK_MAX_SURFACES in the backward kernels)
_BRANCHES = ("coated_singlet", "coated_cooke", "thin_lens", "spectrograph",
             "curved_grating", "hybrid_achromat", "metalens", "phase_mirror",
             "anamorphic", "xy_freeform", "tilted_freeform", "q2d_freeform",
             "wide_freeform", "relay_train")
# the system core's configurations that JAX sends to K5/K6 after its eager
# raygen (object-space telecentric, the real image height) and to K7 after
# an eager aim (the five-surface singlet of tests/test_torch_aiming.py)
_CORE = ("uv_projection", "real_image_height", "aimed_singlet")


@pytest.fixture(scope="module")
def system_variants():
    """Every per-system variant (K1, K3, K5 and K7) of the systems built
    here, and the sources built once, compiled in one parallel nvcc
    round."""
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("no CUDA device / nvcc")
    statics = [_build(name, "cpu")[0]
               for name in list(_SYSTEMS) + ["bench", "cooke"]
               + list(_BRANCHES) + list(_CORE)]
    variants = tuple((src, fused.system_defines(ts)) for ts in statics
                     for src in _PER_SYSTEM) + tuple(
        ("history_fwd", fused.history_defines(ts)) for ts in statics)
    # the per-ray variants of K1-K6, and the backward kernels' builds of
    # the branch systems (`backward_defines`)
    for name in ("cooke", "doublet") + _BRANCHES:
        ts = _build(name, "cpu")[0]
        variants += tuple((src, fused.history_defines(ts))
                          for src in _PER_SYSTEM)
        variants += tuple((src, fused.backward_defines(ts, True))
                          for src in _BACKWARD)
        if fused.backward_defines(ts, False):
            variants += tuple((src, fused.backward_defines(ts, False))
                              for src in _BACKWARD)
    kbuild.build_all(variants)
    return variants


@pytest.fixture
def cuda_f32(system_variants):
    prev = config.get_dtype()
    config.set_precision("float32")
    yield torch.device("cuda")
    config.set_precision("float64" if prev == torch.float64 else "float32")


def _lit_alike(a, b):
    """The rays both versions leave lit, or both dark (a valid root, the
    aperture and TIR decide it; absorption only scales i)."""
    return (a > 0) == (b > 0)


def _data(n, device, seed=11):
    rng = np.random.default_rng(seed)
    Px, Py = rng.uniform(-0.9, 0.9, (2, n))
    Hx, Hy = rng.uniform(-0.5, 0.5, (2, n))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (Hx, Hy, Px, Py))


def _args(ts, tp, w):
    return fused._uniform_params(ts, tp, w) + (fused._raygen_scalars(ts, tp),)


def _build(name, device):
    """(static, params, wavelength) of a test system on `device`."""
    if name == "bench":
        return (*bench_lens(Optic).build(device=device), 0.5876)
    if name == "cooke":
        return (*CookeTriplet().build(device=device), 0.55)
    if name == "doublet":
        return (*tabulated_doublet(Optic).build(device=device), 0.55)
    if name == "uv_projection":
        lens = UVProjectionLens()
        return (*lens.build(device=device), lens.primary_wavelength)
    if name == "real_image_height":
        return (*SMOKE.image_height_cooke(
            CookeTriplet, "real_image_height").build(device=device), 0.55)
    if name == "aimed_singlet":
        return (*aimed_singlet(Optic).build(device=device), 0.55)
    if name in _BRANCHES:
        make = {"coated_singlet": coated_singlet, "coated_cooke": coated_cooke,
                # 5 mm inside the focus: at the focus the pupil's
                # cotangents are 0, the float32 kernel's rounding noise
                "thin_lens": lambda O: thin_lens_system(O, 95.0),
                "spectrograph": spectrograph,
                "curved_grating": lambda O: curved_grating(
                    O, ("simple", 0.9, 0.0)),
                "hybrid_achromat": hybrid_achromat,
                "metalens": curved_metalens,
                "phase_mirror": phase_mirror,
                "anamorphic": SMOKE.anamorphic_singlet,
                "xy_freeform": SMOKE.xy_freeform_singlet,
                "tilted_freeform": SMOKE.tilted_freeform_singlet,
                "q2d_freeform": SMOKE.q2d_singlet,
                "wide_freeform": SMOKE.wide_freeform_singlet,
                "relay_train": SMOKE.relay_train}[name]
        return (*make(Optic).build(device=device), 0.55)
    ts, tp = singlet_lens(Optic, **_SYSTEMS[name]).build(device=device)
    return replace(ts, newton_iters=4), tp, 0.55


@pytest.mark.parametrize("name", list(_SYSTEMS) + ["bench", "cooke"]
                         + list(_BRANCHES))
def test_kernels_match_plain(cuda_f32, name):
    ts, tp, _ = _build(name, cuda_f32)
    data = _data(5000, cuda_f32)
    args = _args(ts, tp, 0.55)
    before = fused.moments_forward.launches
    got = fused.moments_forward(ts, *args, data)
    ref = fused._moments_plain(ts, *args, data)
    assert fused.moments_forward.launches == before + 1
    scale = torch.stack([ref[0], (ref[0] * ref[3]).sqrt(),
                         (ref[0] * ref[3]).sqrt(), ref[3]])
    assert ((got - ref).abs() / scale).max().item() <= MOMENT_RTOL
    outs = fused.raygen_trace_forward(ts, *args, data, tuple(range(8)))
    refs = fused._raygen_trace_plain(ts, *args, data, tuple(range(8)))
    same = _lit_alike(outs[6], refs[6])
    assert same.float().mean().item() >= 1 - 1e-3
    for k, tol in enumerate(_TOLS):
        err = (outs[k] - refs[k])[same].abs().max().item()
        assert err <= tol, (fused._NAMES[k], err)


def _rel(got, ref, keep=None):
    if keep is not None:
        got, ref = got[keep], ref[keep]
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _param_errs(got, ref):
    """{group index: relative error} of the `_diff_params` cotangents."""
    return {j: _rel(g, r) for j, (g, r) in enumerate(zip(got, ref))
            if r.abs().max() > 0 or g.abs().max() > 0}


def _assert_params(name, got, ref, plain, args):
    """Each `_diff_params` cotangent group of a backward kernel's `got`
    within PARAM_GRAD_RTOL of its plain version's `ref`. On the phase
    systems a group that misses it passes by chip_smoke.py's float64 check
    (`float64_errs`, `near_float64`): the kernel within the larger of
    PARAM_GRAD_RTOL and F64_FACTOR times the float32 noise of `plain(*args)`
    run in float64; on the relay train (`_LONG`) only a group whose float32
    noise itself exceeds PARAM_GRAD_RTOL."""
    errs = _param_errs(got[1], ref[1])
    miss = [j for j, v in errs.items() if v > PARAM_GRAD_RTOL]
    far = {}
    if miss and name in _PHASE + _LONG:
        far = SMOKE.float64_errs(got, plain, args)
        miss = [j for j in miss if not (
            SMOKE.near_float64(far[SMOKE.PARAM_GROUPS[j]], PARAM_GRAD_RTOL)
            and (name in _PHASE
                 or far[SMOKE.PARAM_GROUPS[j]][1] > PARAM_GRAD_RTOL))]
    assert errs and not miss, (errs, far)


@pytest.mark.parametrize("name", list(_SYSTEMS) + ["bench", "cooke"]
                         + list(_BRANCHES))
def test_backward_kernels_match_plain(cuda_f32, name):
    """K2 (with and without the data cotangents), K4, K5 and K6 against
    their plain versions; K2's and K6's parameter cotangents bitwise equal
    over two launches."""
    ts, tp, w = _build(name, cuda_f32)
    data = _data(5000, cuda_f32)
    diffp, nondiffp, rg = _args(ts, tp, w)
    keep = _lit_alike(
        fused.raygen_trace_forward(ts, diffp, nondiffp, rg, data, (6,))[0],
        fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data, (6,))[0])

    c = torch.tensor([0.3, -0.7, 0.5, 1.1], device=cuda_f32)
    before = fused.moments_backward.launches
    got = fused.moments_backward(ts, diffp, nondiffp, rg, data, c, True)
    ref = fused._moments_bwd_plain(ts, diffp, nondiffp, rg, data, c, True)
    assert fused.moments_backward.launches == before + 1
    assert _rel(got[0], ref[0]) <= PARAM_GRAD_RTOL
    _assert_params(name, got, ref, lambda *a: fused._moments_bwd_plain(
        ts, *a, True), (diffp, nondiffp, rg, data, c))
    for g, r in zip(got[2], ref[2]):
        assert _rel(g, r, keep) <= RAY_GRAD_RTOL
    again = fused.moments_backward(ts, diffp, nondiffp, rg, data, c, False)
    assert torch.equal(again[0], got[0])
    assert all(torch.equal(a, b) for a, b in zip(again[1], got[1]))
    assert not any(d.any() for d in again[2])

    rng = np.random.default_rng(3)
    seeds = [torch.tensor(rng.normal(size=5000), dtype=torch.float32,
                          device=cuda_f32) for _ in range(8)]
    keys = (0, 1, 5, 7)
    got = fused.raygen_trace_backward(ts, diffp, nondiffp, rg, data, keys,
                                      [seeds[k] for k in keys])
    ref = fused._raygen_trace_bwd_plain(ts, diffp, nondiffp, rg, data, keys,
                                        [seeds[k] for k in keys])
    assert _rel(got[0], ref[0]) <= PARAM_GRAD_RTOL
    _assert_params(name, got, ref, lambda *a: fused._raygen_trace_bwd_plain(
        ts, *a[:4], keys, a[4]), (diffp, nondiffp, rg, data,
                                  [seeds[k] for k in keys]))
    for g, r in zip(got[2], ref[2]):
        assert _rel(g, r, keep) <= RAY_GRAD_RTOL

    rays8 = fused._tile_raygen(ts, rg, *data)[:6] + (
        torch.tensor(rng.uniform(0.5, 1.0, 5000), dtype=torch.float32,
                     device=cuda_f32), torch.zeros_like(data[0]))
    rays8 = tuple(r.contiguous() for r in rays8)
    outs = fused.fused_trace_forward(ts, diffp, nondiffp, rays8)
    refs = fused._fused_trace_plain(ts, diffp, nondiffp, rays8)
    same = _lit_alike(outs[6], refs[6])
    assert same.float().mean().item() >= 1 - 1e-3
    for k, tol in enumerate(_TOLS):
        assert (outs[k] - refs[k])[same].abs().max().item() <= tol
    got = fused.fused_trace_backward(ts, diffp, nondiffp, rays8, seeds)
    ref = fused._fused_trace_bwd_plain(ts, diffp, nondiffp, rays8, seeds)
    _assert_params(name, (None,) + got[::-1], (None,) + ref[::-1],
                   lambda *a: (None,) + fused._fused_trace_bwd_plain(
                       ts, *a)[::-1], (diffp, nondiffp, rays8, seeds))
    for k, (g, r) in enumerate(zip(got[0], ref[0])):
        assert _rel(g, r, same) <= RAY_GRAD_RTOL, fused._NAMES[k]
    again = fused.fused_trace_backward(ts, diffp, nondiffp, rays8, seeds)
    assert all(torch.equal(a, b) for a, b in zip(again[1], got[1]))


@pytest.mark.parametrize("n", [1, 31, 33, 16_389, 2_000_017])
def test_backward_kernels_ragged(cuda_f32, n):
    """K2, K4 and K6 on the bench lens at ray counts that leave a group of
    32 rays part-filled, in 128-thread tiles (16,389 over 129 SMs) and, at
    2M + 17, in a persistent grid of 512-thread blocks that walk many tiles:
    against their plain versions at the tolerances above, and their
    parameter cotangents bitwise equal over two launches. K1's persistent
    grid at the same counts (a part-filled last tile; at 2M + 17 blocks
    that walk many): the moments against the plain version, bitwise over
    two launches."""
    ts, tp, w = _build("bench", cuda_f32)
    data = _data(n, cuda_f32, seed=n)
    diffp, nondiffp, rg = _args(ts, tp, w)
    m = fused.moments_forward(ts, diffp, nondiffp, rg, data)
    ref = fused._moments_plain(ts, diffp, nondiffp, rg, data)
    scale = torch.stack([ref[0], (ref[0] * ref[3]).sqrt(),
                         (ref[0] * ref[3]).sqrt(), ref[3]]).clamp_min(1e-30)
    assert ((m - ref).abs() / scale).max().item() <= MOMENT_RTOL
    assert torch.equal(m, fused.moments_forward(ts, diffp, nondiffp, rg, data))
    keep = _lit_alike(
        fused.raygen_trace_forward(ts, diffp, nondiffp, rg, data, (6,))[0],
        fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data, (6,))[0])
    c = torch.tensor([0.3, -0.7, 0.5, 1.1], device=cuda_f32)
    rng = np.random.default_rng(n)
    seeds = [torch.tensor(rng.normal(size=n), dtype=torch.float32,
                          device=cuda_f32) for _ in range(8)]
    rays8 = tuple(r.contiguous() for r in fused._tile_raygen(
        ts, rg, *data)[:6]) + (torch.ones_like(data[0]),
                               torch.zeros_like(data[0]))
    runs = {
        "K2": (lambda: fused.moments_backward(ts, diffp, nondiffp, rg, data,
                                              c, True),
               lambda: fused._moments_bwd_plain(ts, diffp, nondiffp, rg, data,
                                                c, True)),
        "K4": (lambda: fused.raygen_trace_backward(
                   ts, diffp, nondiffp, rg, data, tuple(range(8)), seeds),
               lambda: fused._raygen_trace_bwd_plain(
                   ts, diffp, nondiffp, rg, data, tuple(range(8)), seeds)),
        "K6": (lambda: (None,) + fused.fused_trace_backward(
                   ts, diffp, nondiffp, rays8, seeds)[::-1],
               lambda: (None,) + fused._fused_trace_bwd_plain(
                   ts, diffp, nondiffp, rays8, seeds)[::-1]),
    }
    for key, (kernel, plain) in runs.items():
        got, again, ref = kernel(), kernel(), plain()
        if key != "K6":
            assert _rel(got[0], ref[0]) <= PARAM_GRAD_RTOL, key
            assert torch.equal(got[0], again[0]), key
        errs = _param_errs(got[1], ref[1])
        assert errs and max(errs.values()) <= PARAM_GRAD_RTOL, (key, errs)
        assert all(torch.equal(a, b) for a, b in zip(got[1], again[1])), key
        for g, r in zip(got[2], ref[2]):
            assert g.shape == (n,)
            assert _rel(g, r, keep) <= RAY_GRAD_RTOL, key
        del got, again, ref


@pytest.mark.parametrize("n", [0, 1, 255, 257, 65_537])
def test_system_kernels_ragged(cuda_f32, n):
    """K3 on the bench lens and K5 on its vignetted twin's eager rays at
    counts around the 256-ray tiles (none, one, a part-filled tile, a tile
    and one more, 256 tiles and one more ray) against their plain
    versions; one launch each where there are rays."""
    ts, tp, w = _build("bench", cuda_f32)
    data = _data(n, cuda_f32, seed=n + 1)
    diffp, nondiffp, rg = _args(ts, tp, w)
    launches = fused.raygen_trace_forward.launches
    outs = fused.raygen_trace_forward(ts, diffp, nondiffp, rg, data,
                                      tuple(range(8)))
    refs = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data,
                                     tuple(range(8)))
    assert fused.raygen_trace_forward.launches == launches + (n > 0)
    tv, pv = bench_lens(Optic, vignetted=True).build(device=cuda_f32)
    r0 = generate_rays(tv, pv, *data, w)
    rays8 = tuple(getattr(r0, k).detach().expand(n).contiguous()
                  for k in fused._RAY_KEYS[:8])
    pv = _args(tv, pv, w)[:2]
    launches = fused.fused_trace_forward.launches
    outs_v = fused.fused_trace_forward(tv, *pv, rays8)
    refs_v = fused._fused_trace_plain(tv, *pv, rays8)
    assert fused.fused_trace_forward.launches == launches + (n > 0)
    for got, ref in ((outs, refs), (outs_v, refs_v)):
        assert all(g.shape == (n,) for g in got)
        if not n:
            continue
        same = _lit_alike(got[6], ref[6])
        assert same.float().mean().item() >= 1 - 1e-3
        for k, tol in enumerate(_TOLS):
            err = (got[k] - ref[k])[same].abs().max().item()
            assert err <= tol, (fused._NAMES[k], err)


def test_system_kernels_refuse_other_systems(cuda_f32):
    """A per-system launcher (K1, K3, K5, K7) refuses S other than its
    build's, and an empty grid, with cudaErrorInvalidValue (1) before any
    launch; K3 writes no output whose bit is clear, even where its pointer
    is given."""
    ts, tp, w = _build("bench", cuda_f32)
    data = _data(1000, cuda_f32)
    diffp, nondiffp, rg = _args(ts, tp, w)
    rays8 = tuple(r.contiguous() for r in fused._tile_raygen(
        ts, rg, *data)[:6]) + (torch.ones_like(data[0]),
                               torch.zeros_like(data[0]))
    rays9 = rays8 + (torch.full_like(data[0], w),)
    stream = torch.cuda.current_stream().cuda_stream
    launches = (fused.k1_launch(ts, diffp, nondiffp, rg, data)[:2],
                fused.k3_launch(ts, diffp, nondiffp, rg, data, (0,))[:2],
                fused.k5_launch(ts, diffp, nondiffp, rays8)[:2],
                fused.k7_launch(ts, diffp, nondiffp, rays9)[:2])
    for fn, args in launches:
        S = args[1]
        assert fn(*args[:1], S + 1, *args[2:], stream) == 1
        assert fn(*args[:1], S - 1, *args[2:], stream) == 1
        assert fn(*args[:2], 0, *args[3:], stream) == 1
    # args: n, S, blocks, out_mask, rg, ftab, Hx, Hy, Px, Py, 8 outputs
    fn, args, (x, i), _keep = fused.k3_launch(ts, diffp, nondiffp, rg, data,
                                              (0, 6))
    assert args[3] == 0b1000001 and args[10 + 1] is None
    sentinel = torch.full((1000,), -7.0, device=cuda_f32)
    args[10 + 1] = sentinel.data_ptr()   # y's pointer; its bit is clear
    assert fn(*args, stream) == 0
    torch.cuda.synchronize()
    assert (sentinel == -7.0).all()
    ref = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data, (0, 6))
    same = _lit_alike(i, ref[1])
    assert same.float().mean().item() >= 1 - 1e-3
    assert (x - ref[0])[same].abs().max().item() <= POS_TOL


def _ulps(got, ref):
    """max |got - ref| in units in the last place of float32 ref."""
    a = ref.float().abs()
    ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()
    return ((got.double() - ref.double()).abs() / ulp).max().item()


def test_vpu_peak_kernels_match_plain(cuda_f32):
    """T1's three chains against their plain versions. At 1 and 2 steps,
    before the chains settle (and tan at 1 step on 1000 x T1's input, over
    its pole), within 4 ulps: fmaf rounds once a step where the plain
    version rounds twice. At T1's own counts: FMA at 1e-4 relative (512
    steps of that difference), rsqrt at its fixed point, tan underflowed to
    0 in both. One launch a call, counted; `run` gives a rate."""
    x = vpu_peak.peak_input(cuda_f32)
    plains = {"fma": vpu_peak.fma_plain, "rsqrt": vpu_peak.rsqrt_plain,
              "tan": vpu_peak.tan_plain}
    for name, (wrapper, _) in vpu_peak.CHAINS.items():
        cases = [(x, 1), (x, 2)] + ([(x * 1000.0, 1)] if name == "tan"
                                    else [])
        for xs, steps in cases:
            ref = plains[name](xs, steps)
            assert (ref != 0).all()
            assert _ulps(wrapper(xs, steps), ref) <= 4.0, (name, steps)
        before = wrapper.launches
        got = wrapper(x)
        assert wrapper.launches == before + 1
        ref = plains[name](x)
        if name == "fma":
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=0)
        elif name == "rsqrt":
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
            torch.testing.assert_close(got, torch.full_like(got, 0.6776506),
                                       rtol=1e-6, atol=0)
        else:
            assert not got.any() and not ref.any()
    per_s, seconds = vpu_peak.run("rsqrt")
    assert per_s > 0 and seconds > 0
    with pytest.raises(ValueError, match="float32"):
        vpu_peak.fma_chain(x.double())


@pytest.mark.parametrize("name, n", [
    ("cooke", 5000), ("singlet", 5000), ("cooke", 1), ("cooke", 255),
    ("cooke", 257), ("cooke", 65_537), ("cooke", 262_145)]
    + [(name, 5000) for name in _BRANCHES])
def test_history_kernel_matches_plain(cuda_f32, name, n):
    """K7 at per-ray wavelengths (three, mixed over the rays) against
    `_history_plain`, all 8 arrays and all S rows; at 5000 rays and at
    counts around its 256-ray tiles (one ray, a part-filled tile, a tile
    and one more, 256 tiles and one more ray), and at 262,145 rays, whose
    history outgrows an H100's L2 cache: bulk copies of rows that start
    off 16-byte boundaries (n = 1 mod 4), the last tile ragged."""
    ts, tp, _ = _build(name, cuda_f32)
    rng = np.random.default_rng(5)
    data = _data(n, cuda_f32)
    w = torch.tensor(rng.choice([0.48, 0.55, 0.65], n), dtype=torch.float32,
                     device=cuda_f32)
    rays0 = generate_rays(ts, tp, *data, w)
    rays9 = tuple(getattr(rays0, k).contiguous() for k in fused._RAY_KEYS)
    p = (fused._diff_params(tp), fused._nondiff_params(tp))
    before = fused.history_forward.launches
    got = fused.history_forward(ts, *p, rays9)
    ref = fused._history_plain(ts, *p, rays9)
    assert fused.history_forward.launches == before + 1
    same = _lit_alike(got[6], ref[6]).all(dim=0)
    assert same.float().mean().item() >= 1 - 1e-3
    for k, tol in enumerate(_TOLS):
        assert got[k].shape == (ts.num_surfaces, n)
        err = (got[k] - ref[k])[:, same].abs().max().item()
        assert err <= tol, (fused._NAMES[k], err)


@pytest.mark.parametrize("name, n", [
    ("cooke", 5000), ("doublet", 5000), ("cooke", 33), ("cooke", 257),
    ("doublet", 65_537)] + [(name, 5000) for name in _BRANCHES])
def test_per_ray_kernels_match_plain(cuda_f32, name, n):
    """K1-K6's per-ray variants against their plain versions, at three
    wavelengths mixed over the rays (on the doublet also below and above
    its tabulated glass's table): K1's moments, K3's and K5's final arrays,
    and K2's, K4's and K6's cotangents, `mat_coeffs`' and w's included;
    their parameter cotangents bitwise over two launches; one launch a
    call. The doublet's tabulated glass takes its cotangents by per-ray
    segments summed in the wrapper."""
    ts, tp, _ = _build(name, cuda_f32)
    rng = np.random.default_rng(n)
    waves = (0.48, 0.55, 0.65) + ((0.38, 0.75) if name == "doublet" else ())
    data = _data(n, cuda_f32, seed=n) + (torch.tensor(
        rng.choice(waves, n), dtype=torch.float32, device=cuda_f32),)
    diffp, nondiffp, rg = (fused._diff_params(tp), fused._nondiff_params(tp),
                           fused._raygen_scalars(ts, tp))
    counters = (fused.moments_forward, fused.moments_backward,
                fused.raygen_trace_forward, fused.raygen_trace_backward,
                fused.fused_trace_forward, fused.fused_trace_backward)
    before = [f.launches for f in counters]
    got = fused.moments_forward(ts, diffp, nondiffp, rg, data)
    ref = fused._moments_plain(ts, diffp, nondiffp, rg, data)
    scale = torch.stack([ref[0], (ref[0] * ref[3]).sqrt(),
                         (ref[0] * ref[3]).sqrt(), ref[3]]).clamp_min(1e-30)
    assert ((got - ref).abs() / scale).max().item() <= MOMENT_RTOL
    outs = fused.raygen_trace_forward(ts, diffp, nondiffp, rg, data,
                                      tuple(range(8)))
    refs = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data,
                                     tuple(range(8)))
    keep = _lit_alike(outs[6], refs[6])
    assert keep.float().mean().item() >= 1 - 1e-3
    for k, tol in enumerate(_TOLS):
        assert (outs[k] - refs[k])[keep].abs().max().item() <= tol
    seeds = [torch.tensor(rng.normal(size=n), dtype=torch.float32,
                          device=cuda_f32) for _ in range(8)]
    rays9 = tuple(r.contiguous() for r in fused._tile_raygen(
        ts, rg, *data[:4])[:6]) + (
        torch.tensor(rng.uniform(0.5, 1.0, n), dtype=torch.float32,
                     device=cuda_f32), torch.zeros_like(data[0]), data[4])
    outs5 = fused.fused_trace_forward(ts, diffp, nondiffp, rays9)
    refs5 = fused._fused_trace_plain(ts, diffp, nondiffp, rays9)
    same = _lit_alike(outs5[6], refs5[6])
    for k, tol in enumerate(_TOLS):
        assert (outs5[k] - refs5[k])[same].abs().max().item() <= tol
    c = torch.tensor([0.3, -0.7, 0.5, 1.1], device=cuda_f32)
    runs = {
        "K2": lambda: fused.moments_backward(ts, diffp, nondiffp, rg, data, c,
                                             True),
        "K4": lambda: fused.raygen_trace_backward(
            ts, diffp, nondiffp, rg, data, tuple(range(8)), seeds),
        "K6": lambda: (None,) + fused.fused_trace_backward(
            ts, diffp, nondiffp, rays9, seeds)[::-1]}
    plains = {
        "K2": lambda: fused._moments_bwd_plain(ts, diffp, nondiffp, rg, data,
                                               c, True),
        "K4": lambda: fused._raygen_trace_bwd_plain(
            ts, diffp, nondiffp, rg, data, tuple(range(8)), seeds),
        "K6": lambda: (None,) + fused._fused_trace_bwd_plain(
            ts, diffp, nondiffp, rays9, seeds)[::-1]}
    for key in runs:
        got, again, ref = runs[key](), runs[key](), plains[key]()
        if key != "K6":
            assert _rel(got[0], ref[0]) <= PARAM_GRAD_RTOL, key
        errs = _param_errs(got[1], ref[1])
        assert 6 in errs and max(errs.values()) <= PARAM_GRAD_RTOL, (key,
                                                                     errs)
        assert all(torch.equal(a, b) for a, b in zip(got[1], again[1])), key
        assert len(got[2]) == len(ref[2]) == (9 if key == "K6" else 5)
        for g, r in zip(got[2], ref[2]):
            assert _rel(g, r, same if key == "K6" else keep) <= RAY_GRAD_RTOL
    assert [f.launches - b for f, b in zip(counters, before)] == [
        1, 2, 1, 2, 1, 2]


def test_requested_outputs_only(cuda_f32):
    ts, tp = singlet_lens(Optic).build(device=cuda_f32)
    data = _data(1000, cuda_f32)
    out = fused.trace_system_final_fused(ts, tp, *data, 0.55,
                                         outputs=("x", "intensity"))
    assert set(out) == {"x", "intensity"}
    full = fused.trace_system_final_fused(ts, tp, *data, 0.55)
    assert torch.equal(out["x"], full["x"])


def test_entry_points_launch_kernels(cuda_f32):
    ts, tp = bench_lens(Optic).build(device=cuda_f32)
    tp = tp.replace(cv=tp.cv.clone().requires_grad_(True))
    data = _data(4096, cuda_f32, seed=0)
    counters = (fused.moments_forward, fused.moments_backward,
                fused.raygen_trace_forward, fused.raygen_trace_backward,
                fused.fused_trace_forward, fused.fused_trace_backward)
    before = [f.launches for f in counters]
    m = fused.spot_moments(ts, tp, *data, 0.5876)
    m[3].backward()
    out = tracer.trace_system_final(ts, tp, *data, 0.5876)
    out["x"].square().sum().backward()
    # a vignetted system leaves in-kernel raygen: the caller-ray pair
    vignetted = replace(ts, has_vignetting=True)
    out_v = tracer.trace_system_final(vignetted, tp, *data, 0.5876)
    out_v["y"].square().sum().backward()
    assert [f.launches - b for f, b in zip(counters, before)] == [1] * 6
    assert bool(torch.isfinite(torch.stack(m)).all())
    for o in (out, out_v):
        assert all(bool(torch.isfinite(v).all()) for v in o.values())
    assert bool(torch.isfinite(tp.cv.grad).all()) and tp.cv.grad.any()
    # the history path: K7, its gradient through the eager twin
    before = fused.history_forward.launches
    tp.cv.grad = None
    h = tracer.trace_system(ts, tp, *data, 0.5876)
    h.y[-1].square().sum().backward()
    assert fused.history_forward.launches == before + 1
    assert h.x.shape == (ts.num_surfaces, 4096)
    assert bool(torch.isfinite(tp.cv.grad).all()) and tp.cv.grad.any()
    # what JAX's gate leaves to the eager trace (grid sag, NURBS) the kernels
    # refuse by name; a Forbes Q-2D system (J) takes them: K1, K2 and K7
    rays0 = generate_rays(ts, tp, *data, 0.5876)
    rays9 = tuple(getattr(rays0, k).contiguous() for k in fused._RAY_KEYS)
    for code in (GEOM_GRID_SAG, GEOM_NURBS):
        other = replace(ts, geom_codes=(0, code) + ts.geom_codes[2:])
        with pytest.raises(ValueError, match="no grid sag or NURBS"):
            fused.history_forward(other, fused._diff_params(tp),
                                  fused._nondiff_params(tp), rays9)
    ts_q, tp_q = SMOKE.q2d_singlet(Optic).build(device=cuda_f32)
    tp_q = tp_q.replace(coeffs=tp_q.coeffs.clone().requires_grad_(True))
    before = [f.launches for f in counters[:2]] + [
        fused.history_forward.launches]
    m = fused.spot_moments(ts_q, tp_q, *data, 0.55)
    m[3].backward()
    h = tracer.trace_system(ts_q, tp_q, *data, 0.55)
    assert [f.launches - b for f, b in zip(
        counters[:2] + (fused.history_forward,), before)] == [1, 1, 1]
    assert bool(torch.isfinite(h.x).all())
    assert bool((tp_q.coeffs.grad[1, :17] != 0).all())
    # a phase system takes the kernels: K1, K2 and K7 at one wavelength
    ts_p, tp_p = curved_metalens(Optic).build(device=cuda_f32)
    tp_p = tp_p.replace(phase_params=tp_p.phase_params.clone()
                        .requires_grad_(True))
    before = [f.launches for f in counters[:2]] + [
        fused.history_forward.launches]
    m = fused.spot_moments(ts_p, tp_p, *data, 0.55)
    m[3].backward()
    h = tracer.trace_system(ts_p, tp_p, *data, 0.55)
    assert [f.launches - b for f, b in zip(
        counters[:2] + (fused.history_forward,), before)] == [1, 1, 1]
    assert bool(torch.isfinite(h.x).all())
    assert bool(torch.isfinite(tp_p.phase_params.grad).all())
    assert tp_p.phase_params.grad[1, 0] != 0
    # per-ray wavelengths, even all equal, take the per-ray K1 and K2
    before = [f.launches for f in counters[:2]]
    tp.cv.grad = None
    m = fused.spot_moments(ts, tp, *data, torch.full_like(data[0], 0.5876))
    m[3].backward()
    assert [f.launches - b for f, b in zip(counters[:2], before)] == [1, 1]
    assert bool(torch.isfinite(tp.cv.grad).all()) and tp.cv.grad.any()


def test_wrapper_rejects_bad_inputs(cuda_f32):
    ts, tp = singlet_lens(Optic).build(device=cuda_f32)
    data = _data(64, cuda_f32)
    args = _args(ts, tp, 0.55)
    with pytest.raises(ValueError, match="float32"):
        fused.moments_forward(ts, *args, tuple(d.double() for d in data))
    strided = tuple(torch.stack([d, d], 1)[:, 0] for d in data)
    with pytest.raises(ValueError, match="contiguous"):
        fused.moments_forward(ts, *args, strided)


def _huygens_inputs(device, num_rays=64, image_size=64, field=(0.0, 1.0)):
    """The Cooke triplet's pupil (amplitude, OPD in mm) at `field` and an
    image grid around the chief ray's hit, as ScalarHuygensPSF builds them,
    in the precision set."""
    ts, tp = CookeTriplet().build(device=device)
    Px, Py, inside = pupil_grid_coords(num_rays, tp.cv.dtype, device)
    data = wavefront_data(ts, tp, *field, Px, Py, 0.55)
    c = data.center
    g = torch.linspace(-0.03, 0.03, image_size, dtype=tp.cv.dtype,
                       device=device)
    IX, IY = torch.meshgrid(g + c[0], g + c[1], indexing="xy")
    return ((IX, IY, torch.zeros_like(IX) + c[2]),
            (data.pupil_x, data.pupil_y, data.pupil_z),
            torch.sqrt(data.intensity) * inside, data.opd * 0.55e-3, 0.55e-3,
            data.radius)


def test_huygens_kernel_matches_plain(cuda_f32):
    """K8 against the plain version in float64 on the same (float32) inputs,
    within twice the float32 plain version's own error and 1e-2 of the
    peak (float32 rounds R ~ 54 mm to 4e-6 mm, up to 0.02 rad of phase per
    term, correlated over the pupil grid: the plain float32 version is
    2.3e-3 of the peak off on the CPU, 3.9e-3 on an H100); two launches
    bitwise equal."""
    args = _huygens_inputs(cuda_f32)
    before = huygens.huygens_sum_forward.launches
    got = huygens.huygens_sum(*args)
    assert huygens.huygens_sum_forward.launches == before + 1
    again = huygens.huygens_sum_forward(*args)
    assert torch.equal(got, again)
    ref = huygens.huygens_sum_plain(*(
        tuple(a.double() for a in x) if isinstance(x, tuple)
        else (x.double() if torch.is_tensor(x) else x) for x in args))
    plain32 = huygens.huygens_sum_plain(*args)
    peak = ref.abs().max()
    err = ((got.double() - ref).abs().max() / peak).item()
    err32 = ((plain32.double() - ref).abs().max() / peak).item()
    assert got.shape == (64, 64) and bool(torch.isfinite(got).all())
    assert err <= 1e-2 and err <= 2 * err32, (err, err32)


@pytest.mark.parametrize("num_rays, image_size", [(13, 23), (40, 1), (9, 33)])
def test_huygens_kernel_ragged(cuda_f32, num_rays, image_size):
    """K8 where neither axis fills its block: 529 image points (a block
    holds 1,024) over 169 pupil samples (a tile holds 128), the single image
    point of a normalizing peak over 1,600 samples, and 1,089 over 81;
    against the float64 plain version within 1e-2 of the peak and twice the
    float32 plain version's own error (plus 1e-6 of the peak, where that
    error is ~0), two launches bitwise equal."""
    args = _huygens_inputs(cuda_f32, num_rays, image_size)
    got = huygens.huygens_sum_forward(*args)
    assert torch.equal(got, huygens.huygens_sum_forward(*args))
    ref = huygens.huygens_sum_plain(*(
        tuple(a.double() for a in x) if isinstance(x, tuple)
        else (x.double() if torch.is_tensor(x) else x) for x in args))
    plain32 = huygens.huygens_sum_plain(*args)
    peak = ref.abs().max()
    err = ((got.double() - ref).abs().max() / peak).item()
    err32 = ((plain32.double() - ref).abs().max() / peak).item()
    assert got.shape == (image_size, image_size)
    assert err <= 1e-2 and err <= 2 * err32 + 1e-6, (err, err32)


def test_huygens_psf_launches_kernel(cuda_f32):
    """ScalarHuygensPSF on the card: K7 under wavefront_data, K8 for the
    image and for the normalizing peak; HuygensMTF through it; the plain
    version only when asked (use_kernel=False)."""
    lens = CookeTriplet()
    k7, k8 = fused.history_forward.launches, huygens.huygens_sum_forward.launches
    psf = ScalarHuygensPSF(lens, (0.0, 1.0), num_rays=32, image_size=32)
    assert huygens.huygens_sum_forward.launches == k8 + 2
    assert fused.history_forward.launches >= k7 + 3   # chief, bundle, spot
    assert psf.psf.is_cuda and bool(torch.isfinite(psf.psf).all())
    k8 = huygens.huygens_sum_forward.launches
    mtf = HuygensMTF(lens, (0, 0), 0.55, num_rays=32, image_size=32)
    assert huygens.huygens_sum_forward.launches == k8 + 2
    assert all(bool(torch.isfinite(m).all()) for m in mtf.mtf)
    plain = ScalarHuygensPSF(lens, (0.0, 1.0), num_rays=32, image_size=32,
                             use_kernel=False)
    assert huygens.huygens_sum_forward.launches == k8 + 2
    # both float32, each ~2e-3 of the peak from float64 (rounding of R)
    assert (plain.psf - psf.psf).abs().max() <= 1e-2 * plain.psf.max()


def test_huygens_kernel_refuses(cuda_f32):
    """K8 has no backward: an input that requires grad under grad mode
    raises; float16 raises; float64 on the card takes the plain version."""
    image, pupil, amp, opd, wl, Rp = _huygens_inputs(cuda_f32, 8, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        huygens.huygens_sum(image, pupil, amp.clone().requires_grad_(True),
                            opd, wl, Rp)
    with pytest.raises(ValueError, match="float32"):
        huygens.huygens_sum_forward(image, pupil, amp.half(), opd, wl, Rp)
    before = huygens.huygens_sum_forward.launches
    out = huygens.huygens_sum(tuple(a.double() for a in image),
                              tuple(a.double() for a in pupil), amp.double(),
                              opd.double(), wl, Rp.double())
    assert out.dtype == torch.float64
    assert huygens.huygens_sum_forward.launches == before


@pytest.mark.parametrize("name", ["uv_projection", "real_image_height"])
def test_caller_ray_kernels_after_eager_raygen(cuda_f32, name):
    """K5 and K6 on the rays the eager raygen makes for an object-space
    telecentric system and a real-image-height one (JAX's path for them:
    `supports_fused`, not `supports_fused_raygen`), each against its plain
    version; `trace_system_final` and its params-only backward launch them
    once each."""
    ts, tp, w = _build(name, cuda_f32)
    assert fused.supports_fused(ts) and not fused.supports_fused_raygen(ts)
    data = _data(5000, cuda_f32)
    p = tp.replace(cv=tp.cv.clone().requires_grad_(True))
    before = (fused.fused_trace_forward.launches,
              fused.fused_trace_backward.launches)
    out = tracer.trace_system_final(ts, p, *data, w)
    (out["x"] ** 2 + out["y"] ** 2 + out["opd"]).sum().backward()
    assert (fused.fused_trace_forward.launches,
            fused.fused_trace_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert bool(torch.isfinite(p.cv.grad).all()) and p.cv.grad.any()
    rays0 = generate_rays(ts, tp, *data, w)
    rays8 = tuple(getattr(rays0, k).detach().contiguous()
                  for k in fused._RAY_KEYS[:8])
    diffp, nondiffp = fused._uniform_params(ts, tp, w, diff_w=False)
    outs = fused.fused_trace_forward(ts, diffp, nondiffp, rays8)
    refs = fused._fused_trace_plain(ts, diffp, nondiffp, rays8)
    same = _lit_alike(outs[6], refs[6])
    assert same.float().mean().item() >= 1 - 1e-3
    miss = [k for k, tol in enumerate(_TOLS)
            if (outs[k] - refs[k])[same].abs().max().item() > tol]
    if miss and name in _LONG:
        far = SMOKE.final_float64_errs(outs, lambda *a: (
            fused._fused_trace_plain(ts, *a)), (diffp, nondiffp, rays8), same)
        miss = [k for k in miss if not SMOKE.near_float64(
            far[fused._NAMES[k]], _TOLS[k])]
    assert not miss, [fused._NAMES[k] for k in miss]
    rng = np.random.default_rng(3)
    seeds = [torch.tensor(rng.normal(size=5000), dtype=torch.float32,
                          device=cuda_f32) for _ in range(8)]
    got = fused.fused_trace_backward(ts, diffp, nondiffp, rays8, seeds)
    ref = fused._fused_trace_bwd_plain(ts, diffp, nondiffp, rays8, seeds)
    _assert_params(name, (None,) + got[::-1], (None,) + ref[::-1],
                   lambda *a: (None,) + fused._fused_trace_bwd_plain(
                       ts, *a)[::-1], (diffp, nondiffp, rays8, seeds))
    for k, (g, r) in enumerate(zip(got[0], ref[0])):
        assert _rel(g, r, same) <= RAY_GRAD_RTOL, fused._NAMES[k]


def test_history_kernel_on_aimed_rays(cuda_f32):
    """K7 against its plain version on an iteratively aimed bundle (the
    aimed singlet at fields up to 15 degrees, 5000 rays), the bundle's stop
    hits at its targets; `Optic.trace_generic` under iterative aiming
    launches K7 once."""
    ts, tp, w = _build("aimed_singlet", cuda_f32)
    Hx, Hy, Px, Py = _data(5000, cuda_f32)
    qx, qy = aiming.aim_rays_iterative(ts, tp, Hx, Hy, Px, Py,
                                       torch.tensor(w, device=cuda_f32))
    rays0 = generate_rays(ts, tp, Hx, Hy, qx, qy, w, apply_vignetting=False)
    rays9 = tuple(getattr(rays0, k).detach().contiguous()
                  for k in fused._RAY_KEYS)
    p = (fused._diff_params(tp), fused._nondiff_params(tp))
    got = fused.history_forward(ts, *p, rays9)
    ref = fused._history_plain(ts, *p, rays9)
    same = _lit_alike(got[6], ref[6]).all(dim=0)
    assert same.float().mean().item() >= 1 - 1e-3
    for k, tol in enumerate(_TOLS):
        err = (got[k] - ref[k])[:, same].abs().max().item()
        assert err <= tol, (fused._NAMES[k], err)
    k = ts.stop_index
    r = aiming.stop_radius(ts, tp, torch.tensor(w, device=cuda_f32))
    live = got[6][-1] > 0
    err = torch.hypot(got[0][k] / r - Px, got[1][k] / r - Py)[live]
    assert err.max().item() <= SMOKE.TOL_AIM
    lens = aimed_singlet(Optic)
    lens.set_ray_aiming("iterative")
    before = fused.history_forward.launches
    h = lens.trace_generic(Hx, Hy, Px, Py, wavelength=w)
    assert fused.history_forward.launches == before + 1
    assert bool(torch.isfinite(h.x[-1]).all())


def test_design_merit_on_history_kernel(cuda_f32, monkeypatch):
    """chip_smoke.py phase j8's design merit on the bench lens (cv x 1.05)
    at 147 hexapolar rings (65,269 rays) a field: `trace_system` launches
    K7 three times an evaluation (two fields and the chief ray), and the
    merit, `fun_array` and `value_and_grad` agree with the same calls on
    K7's plain version (the backward is the eager twin on both)."""
    from optiland_tpu_torch.optimization import OptimizationProblem

    lens = bench_lens(Optic)
    lens.build(device=cuda_f32)
    SMOKE.detune(lens)
    p = SMOKE.design_problem(OptimizationProblem, lens, rings=147)
    c = p._compile()
    x = p.x0()
    before = fused.history_forward.launches
    v, g = c["value_and_grad"](x, lens.params)
    fa = p.fun_array()
    assert fused.history_forward.launches - before == 6
    monkeypatch.setattr(fused, "history_forward", fused._history_plain)
    vp, gp = c["value_and_grad"](x, lens.params)
    fap = p.fun_array()
    assert abs(v.item() - vp.item()) <= MOMENT_RTOL * abs(vp.item())
    assert _rel(fa, fap) <= MOMENT_RTOL
    assert _rel(g, gp) <= PARAM_GRAD_RTOL
    assert bool(torch.isfinite(g).all()) and g.abs().max() > 0


def test_tolerancing_draw_on_history_kernel(cuda_f32, monkeypatch):
    """One Monte-Carlo draw of chip_smoke.py's Cooke tolerancing (its image
    gap compensated by 4 Gauss-Newton steps, RMS spot at 12,481 rays):
    K7 once a step and once for the values, which agree with the draw on
    K7's plain version, the compensator within POS_TOL mm."""
    from optiland_tpu_torch import tolerancing

    lens = CookeTriplet()
    lens.build(device=cuda_f32)
    t = SMOKE.cooke_tolerancing(tolerancing, lens)
    draw = t.draw_table(1, seed=1)
    c = t._compile()
    before = fused.history_forward.launches
    v, x = c["pipeline_batch"](lens.params, draw)
    assert fused.history_forward.launches - before == 5
    monkeypatch.setattr(fused, "history_forward", fused._history_plain)
    vp, xp = c["pipeline_batch"](lens.params, draw)
    assert _rel(v, vp) <= MOMENT_RTOL
    gap = t.compensators[0].scaler.inverse_scale
    assert (gap(x) - gap(xp)).abs().max().item() <= POS_TOL


# every kernel's launch counter: the eager paths leave them all unmoved
_COUNTED = {"K1": fused.moments_forward, "K2": fused.moments_backward,
            "K3": fused.raygen_trace_forward,
            "K4": fused.raygen_trace_backward,
            "K5": fused.fused_trace_forward,
            "K6": fused.fused_trace_backward,
            "K7": fused.history_forward, "K8": huygens.huygens_sum_forward}


@pytest.fixture
def cuda_eager():
    """The card in float32, for the eager paths that launch no kernel
    (nothing is built)."""
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("no CUDA device / nvcc")
    prev = config.get_dtype()
    config.set_precision("float32")
    yield torch.device("cuda")
    config.set_precision("float64" if prev == torch.float64 else "float32")


def _pair(make, dev):
    """`make()` built on `dev` in float32 and in float64."""
    b32 = make().build(device=dev)
    config.set_precision("float64")
    try:
        b64 = make().build(device=dev)
    finally:
        config.set_precision("float32")
    return b32, b64


def test_fresnel_polarized_trace_against_float64(cuda_eager):
    """chip_smoke.py phase j9 (a) at 65,538 rays: the Fresnel-coated Cooke
    triplet's unpolarized PRT trace, eager on the card (no kernel), float32
    against float64 within TOL_F64 and TOL_POL."""
    from optiland_tpu_torch.polarization import PolarizationState

    (st, pr), (st64, pr64) = _pair(
        lambda: SMOKE.fresnel_cooke(CookeTriplet), cuda_eager)
    fb = SMOKE.flagship_inputs(pr, cuda_eager, 7_282)
    state = PolarizationState.unpolarized()
    before = {k: f.launches for k, f in _COUNTED.items()}
    h = tracer.trace_system(st, pr, *fb, polarization=state)
    assert {k: f.launches for k, f in _COUNTED.items()} == before
    h64 = tracer.trace_system(st64, pr64, *(a.double() for a in fb),
                              polarization=state)
    lit = (h.intensity[-1] > 0) & (h64.intensity[-1] > 0)
    assert lit.double().mean() > 0.5
    for key, tol in (("x", SMOKE.TOL_F64["position_mm"]),
                     ("y", SMOKE.TOL_F64["position_mm"]),
                     ("L", SMOKE.TOL_F64["direction"]),
                     ("M", SMOKE.TOL_F64["direction"]),
                     ("intensity", SMOKE.TOL_POL["intensity"])):
        err = (getattr(h, key)[-1].double() - getattr(h64, key)[-1])[lit]
        assert err.abs().max().item() <= tol, key
    err_p = (h.p.abs().double() - h64.p.abs())[lit].abs().max().item()
    assert err_p <= SMOKE.TOL_POL["p_abs"]


def test_vectorial_fft_psf_against_float64(cuda_eager):
    """`VectorialFFTPSF` of the unpolarized Cooke triplet at field (0, 1),
    64 pupil rays (a 128 grid), float32 against float64 on the card within
    TOL_WAVE's FFT bounds; the vectorial sum launches no K8."""
    from optiland_tpu_torch.psf import VectorialFFTPSF

    lens32, lens64 = CookeTriplet(), CookeTriplet()
    for lens in (lens32, lens64):
        lens.set_polarization("unpolarized")
    k8 = huygens.huygens_sum_forward.launches
    p32 = VectorialFFTPSF(lens32, (0.0, 1.0), num_rays=64, device=cuda_eager)
    assert huygens.huygens_sum_forward.launches == k8
    config.set_precision("float64")
    try:
        p64 = VectorialFFTPSF(lens64, (0.0, 1.0), num_rays=64,
                              device=cuda_eager)
    finally:
        config.set_precision("float32")
    err = ((p32.psf.double() - p64.psf).abs().max()
           / p64.psf.abs().max()).item()
    assert err <= SMOKE.TOL_WAVE["fft_psf_of_peak"]
    assert abs(p32.strehl_ratio().item() - p64.strehl_ratio().item()) \
        <= SMOKE.TOL_WAVE["fft_strehl"]


def test_spot_diagram_on_history_kernel(cuda_f32):
    """chip_smoke.py phase j10 (a) at 40 rings (3 fields x 3 wavelengths x
    4,921 points, 44,289 rays): `SpotDiagram` launches K7 twice (the bundle
    and the chief rays, no other kernel); its image rows against
    `_history_plain` on the same rays within _TOLS; its RMS and geometric
    radii against the eager float64 path on the card within
    TOL_J10["position"] of their largest entry."""
    from optiland_tpu_torch.analysis import SpotDiagram
    from optiland_tpu_torch.analysis.base import like
    from optiland_tpu_torch.analysis.spot import field_pupil_batch
    from optiland_tpu_torch.core import distributions as dist

    rings = 40
    lens = CookeTriplet()
    before = {k: f.launches for k, f in _COUNTED.items()}
    spot = SpotDiagram(lens, num_rings=rings)
    launched = {k: f.launches - before[k] for k, f in _COUNTED.items()}
    assert launched == dict.fromkeys(_COUNTED, 0) | {"K7": 2}
    assert spot.x.shape == (3, 3, 4921) and spot.x.is_cuda
    ts, tp = lens.build()
    Px, Py = (like(a, tp) for a in dist.hexapolar(rings))
    rays0 = generate_rays(ts, tp, *field_pupil_batch(
        spot.fields, spot.wavelengths, Px, Py, tp))
    rays9 = tuple(getattr(rays0, k).contiguous() for k in fused._RAY_KEYS)
    ref = fused._history_plain(ts, fused._diff_params(tp),
                               fused._nondiff_params(tp), rays9)
    same = _lit_alike(spot.intensity.reshape(-1), ref[6][-1])
    assert same.float().mean().item() >= 1 - 1e-3
    for k, got in ((0, spot.x), (1, spot.y), (6, spot.intensity)):
        err = (got.reshape(-1) - ref[k][-1])[same].abs().max().item()
        assert err <= _TOLS[k], (fused._NAMES[k], err)
    config.set_precision("float64")
    try:
        spot64 = SpotDiagram(CookeTriplet(), num_rings=rings)
        radii64 = (spot64.rms_spot_radius(), spot64.geometric_spot_radius())
    finally:
        config.set_precision("float32")
    for got, ref64 in zip((spot.rms_spot_radius(),
                           spot.geometric_spot_radius()), radii64):
        err = ((got.double() - ref64).abs().max()
               / ref64.abs().max()).item()
        assert err <= SMOKE.TOL_J10["position"]


def test_sharded_spot_merit_on_one_rank(cuda_f32):
    """parallel/: one sharded spot-merit step at world size 1 on the card
    (a one-rank NCCL mesh), K1 and K2 once each, bitwise the unsharded
    step: a one-rank all-reduce is the identity (tests/test_torch_parallel.py
    holds two ranks on the CPU)."""
    import torch.distributed as dist

    from optiland_tpu_torch.parallel import dryrun, init_distributed, make_mesh

    ts, tp = CookeTriplet().build()
    batch = dryrun.dryrun_batch(ts, tp, 65_536, rays_per_field=8)[:4]
    loss0, g0 = dryrun.spot_step(ts, tp, batch, 0.55)
    created = not dist.is_initialized()
    init_distributed()
    try:
        before = {k: f.launches for k, f in _COUNTED.items()}
        loss1, g1 = dryrun.spot_step(ts, tp, batch, 0.55, make_mesh(1))
        launched = {k: f.launches - before[k] for k, f in _COUNTED.items()}
    finally:
        if created:
            dist.destroy_process_group()
    assert launched == dict.fromkeys(_COUNTED, 0) | {"K1": 1, "K2": 1}
    assert torch.equal(loss1, loss0) and bool(torch.isfinite(loss0))
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    assert g0["cv"].abs().max() > 0
