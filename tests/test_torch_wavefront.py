"""`wavefront_data` and the OPD analyses of the PyTorch port against the
JAX package, float64 on the CPU, on the Cooke triplet: the three
reference-sphere strategies at fields (0, 0) and (0, 1), and `OPD`,
`ZernikeOPD` and `OPDFan` (tests/test_torch_wave.py holds the Huygens
path, tests/test_torch_wave_analyses.py the FFT analyses).

The JAX references run once per module (`jax_f64`), through the jitted
`wavefront_data` that the JAX analyses use, at the pupil size of the PSFs'
16 x 16 grid (256 points: the grid, 256 Sobol points, two 128-point fans)
and at ZernikeOPD's 6 hexapolar rings (127): one compile for each
strategy and size. Tolerances, each of the largest entry of the compared
array, float64 on both sides: positions, intensities and the sphere
1e-10; OPD values 1e-9 (XLA contracts the jitted reference's arithmetic
into multiply-adds, so paths of 60-100 mm differ by a few of their ulps,
and the division by the wavelength makes each 1.4e-14 mm 2.5e-11 waves;
1.4e-10 measured; the best-fit sphere's algebraic fit, with nearly
parallel z and constant columns, is solved by SVD in JAX and by QR
here)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.wavefront import OPD as JOPD
from optiland_tpu.wavefront import OPDFan as JOPDFan
from optiland_tpu.wavefront import ZernikeOPD as JZernikeOPD
from optiland_tpu.wavefront import wavefront_data as jwavefront
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.wavefront import OPD, OPDFan, ZernikeOPD
from optiland_tpu_torch.wavefront import wavefront_data as twavefront
from optiland_tpu_torch.wavefront.core import pupil_grid_coords

from torch_port_helpers import assert_close, jax_f64

FIELDS = [(0.0, 0.0), (0.0, 1.0)]
FIELD = (0.0, 1.0)
STRATEGIES = ["chief_ray", "centroid_sphere", "best_fit"]
WAVES = ("pupil_x", "pupil_y", "pupil_z", "opd", "intensity", "radius",
         "center")
OPD_KW = dict(num_rings=256, distribution="sobol",
              strategy="centroid_sphere")


@pytest.fixture(scope="module")
def lenses():
    return JCooke(), TCooke()


@pytest.fixture(scope="module")
def pupil():
    return pupil_grid_coords(16, torch.float64, "cpu")


@pytest.fixture(scope="module")
def jax_ref(lenses, pupil):
    """Every JAX reference of the module, computed once: 256 pupil points,
    then 127."""
    jl = lenses[0]
    Px, Py = (jnp.asarray(a.numpy()) for a in pupil[:2])
    out = {}
    with jax_f64():
        js, jp = jl.build()
        jitted = jax.jit(jwavefront, static_argnums=(0,),
                         static_argnames=("strategy", "aiming"))
        for s in STRATEGIES:
            for f in FIELDS:
                out[s, f] = jitted(js, jp, *f, Px, Py, jnp.asarray(0.55),
                                   strategy=s)
        out["opd"] = JOPD(jl, FIELD, **OPD_KW)
        out["fan"] = JOPDFan(jl, wavelengths=[0.55], num_rays=128)
        out["zopd"] = JZernikeOPD(jl, FIELD, num_rings=6)
    return out


@pytest.mark.parametrize("field", FIELDS, ids=str)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_wavefront_data_matches_jax(lenses, pupil, jax_ref, strategy, field):
    ts, tp = lenses[1].build(device="cpu")
    got = twavefront(ts, tp, *field, *pupil[:2], 0.55, strategy=strategy)
    ref = jax_ref[strategy, field]
    for name in WAVES:
        tol = 1e-9 if name == "opd" else 1e-10
        assert_close(getattr(got, name), getattr(ref, name), tol, name)


def test_wavefront_data_refuses_unported_options(lenses):
    """Unknown strategies refuse; a polarized wavefront carries its exit
    fields, one (N, 3) row per state; the aiming modes run: "cached" is the iterative aim, and the aimed chief ray, at the
    stop's centre, leaves its OPD reference at 0."""
    ts, tp = lenses[1].build(device="cpu")
    P = torch.zeros(3, dtype=torch.float64)
    Py = torch.tensor([-0.8, 0.0, 0.8], dtype=torch.float64)
    aimed = {mode: twavefront(ts, tp, 0.0, 1.0, P, Py, 0.55, aiming=mode)
             for mode in ("paraxial", "iterative", "cached")}
    for name in WAVES:
        assert torch.equal(getattr(aimed["iterative"], name),
                           getattr(aimed["cached"], name)), name
    assert not torch.equal(aimed["iterative"].opd, aimed["paraxial"].opd)
    assert torch.isfinite(aimed["iterative"].opd).all()
    assert abs(float(aimed["iterative"].opd[1])) < 1e-9
    from optiland_tpu_torch.polarization import PolarizationState

    pol = twavefront(ts, tp, 0.0, 1.0, P, Py, 0.55,
                     polarization=PolarizationState.unpolarized())
    assert pol.E_exits.shape == (2, 3, 3) and aimed["paraxial"].E_exits is None
    assert torch.equal(pol.opd, aimed["paraxial"].opd)
    with pytest.raises(ValueError, match="strategy"):
        twavefront(ts, tp, 0.0, 1.0, P, P, 0.55, strategy="nope")


def test_opd_analyses_match_jax(lenses, jax_ref):
    z = ZernikeOPD(lenses[1], FIELD, num_rings=6, device="cpu")
    ref = jax_ref["zopd"]
    assert_close(z.coeffs, ref.coeffs, 1e-9, "coeffs")
    assert [nm for nm, _ in z.zernike_terms()] == [
        nm for nm, _ in ref.zernike_terms()]
    opd = OPD(lenses[1], FIELD, device="cpu", **OPD_KW)
    for got, want in ((z, ref), (opd, jax_ref["opd"])):
        assert_close(got.rms(), want.rms(), 1e-9, "rms")
        assert_close(got.peak_to_valley(), want.peak_to_valley(), 1e-9,
                     "peak to valley")
    opd_map = z.generate_opd_map(num_points=9)["z"]
    assert opd_map.shape == (9, 9) and np.isfinite(opd_map[4, 4])
    fan = OPDFan(lenses[1], wavelengths=[0.55], num_rays=128, device="cpu")
    rfan = jax_ref["fan"]
    assert len(fan.data) == 3
    for i in range(3):
        assert_close(fan.fan_y(i, 0)[1], rfan.fan_y(i, 0)[1], 1e-9, "fan y")
        assert_close(fan.fan_x(i, 0)[1], rfan.fan_x(i, 0)[1], 1e-9, "fan x")
