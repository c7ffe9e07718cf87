"""The FFT wave-optics analyses of the PyTorch port against the JAX package,
float64 on the CPU, on the Cooke triplet: the Zernike bases and fit, the
FFT and MMDFT PSFs and the FFT and sampled MTFs (tests/test_torch_wave.py
holds the Huygens path, tests/test_torch_wavefront.py `wavefront_data` and
the OPD analyses).

The JAX references run once per module (`jax_f64`), with 256 pupil
points each (16 x 16 grids, 256 Sobol points). JAX's FFT PSF class jits a
new closure for every instance, a whole compile each, so its reference is
the class's two JAX functions, jitted once (`_UnbatchedFFTPSF`, a loop
over the wavelengths in place of the class's `vmap`), and the FFT MTF's
reference is JAX's class on those PSFs.
Tolerances, each of the largest entry of the compared array, float64 on
both sides: Zernike coefficients 1e-10 (the OPD's division
by the wavelength scales a 1e-14 mm path difference to 2e-11 waves);
complex pupils, PSFs and MTFs 1e-9 (2 pi times that in each phase); the
Zernike bases 1e-12 (one polynomial per entry)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu import zernike as jzern
from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.mtf import SampledMTF as JSampledMTF
from optiland_tpu.mtf import ScalarFFTMTF as JFFTMTF
from optiland_tpu.psf import MMDFTPSF as JMMDFT
from optiland_tpu.psf import fft as jfft
from optiland_tpu_torch import zernike as tzern
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.mtf import SampledMTF, ScalarFFTMTF
from optiland_tpu_torch.psf import MMDFTPSF, ScalarFFTPSF

from torch_port_helpers import assert_close, jax_f64

FIELD = (0.0, 1.0)
MTF_FREQS = [(0.0, 0.0), (20.0, 0.0), (0.0, 45.0), (60.0, 60.0)]
# 16 x 16 pupil grids (FFT: num_rays 16 into a 32 grid; MMDFT: num_rays 8
# samples calculate_grid_size(8) = (16, 16))
FFT = dict(num_rays=16, grid_size=32)
MMDFT = dict(num_rays=8)
SAMPLED = dict(num_rays=256, distribution="sobol")


_pupil_grid = jax.jit(jfft._pupil_grid, static_argnums=(0, 5, 6, 7))
_psf_from_pupils = jax.jit(jfft._psf_from_pupils, static_argnums=(1,))


class _UnbatchedFFTPSF:
    """JAX's `ScalarFFTPSF` for given num_rays and grid_size: its pupils one
    wavelength at a time (`_pupil_grid`), then `_psf_from_pupils`."""

    def __init__(self, optic, field, wavelength, num_rays, grid_size,
                 strategy):
        static, params = optic.build()
        self.pupils = jnp.stack([
            _pupil_grid(static, params, field[0], field[1],
                        jnp.asarray(w, params.cv.dtype), num_rays, strategy,
                        "paraxial") for w in wavelength])
        self.psf = _psf_from_pupils(self.pupils, grid_size)


class _JFFTMTF(JFFTMTF):
    _psf_cls = _UnbatchedFFTPSF


@pytest.fixture(scope="module")
def lenses():
    return JCooke(), TCooke()


@pytest.fixture(scope="module")
def jax_ref(lenses):
    jl = lenses[0]
    with jax_f64():
        out = {
            "fft": _UnbatchedFFTPSF(jl, FIELD, [0.55], FFT["num_rays"],
                                    FFT["grid_size"], "chief_ray"),
            "mmdft": JMMDFT(jl, FIELD, **MMDFT),
            "fftmtf": _JFFTMTF(jl, **FFT),
            "smtf": JSampledMTF(jl, FIELD, **SAMPLED),
        }
        out["smtf_values"] = out["smtf"].calculate_mtf(MTF_FREQS)
    return out


@pytest.mark.parametrize("kind", ["fringe", "noll", "standard"])
def test_zernike_matches_jax(kind):
    assert tzern.indices(kind, 37) == jzern.indices(kind, 37)
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-0.7, 0.7, (2, 200))
    r, phi = np.hypot(x, y), np.arctan2(y, x)
    coeffs, z = rng.normal(size=15), rng.normal(size=200)
    t = {k: torch.from_numpy(v) for k, v in dict(
        x=x, y=y, r=r, phi=phi, c=coeffs, z=z).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    assert_close(tzern.design_matrix(kind, 37, t["r"], t["phi"]),
                 jzern.design_matrix(kind, 37, j["r"], j["phi"]), 1e-12,
                 "design matrix")
    assert_close(tzern.evaluate(kind, t["c"], t["r"], t["phi"]),
                 jzern.evaluate(kind, j["c"], j["r"], j["phi"]), 1e-12,
                 "evaluate")
    assert_close(tzern.evaluate_xy(kind, t["c"], t["x"], t["y"]),
                 jzern.evaluate_xy(kind, j["c"], j["x"], j["y"]), 1e-12,
                 "evaluate_xy")
    assert_close(tzern.fit(kind, 15, t["x"], t["y"], t["z"]),
                 jzern.fit(kind, 15, j["x"], j["y"], j["z"]), 1e-10, "fit")


def test_fft_psfs_match_jax(lenses, jax_ref):
    fft = ScalarFFTPSF(lenses[1], FIELD, wavelength=[0.55], device="cpu",
                       **FFT)
    assert fft.pupils.dtype == torch.complex128
    assert_close(fft.pupils, jax_ref["fft"].pupils, 1e-9, "pupils")
    assert_close(fft.psf, jax_ref["fft"].psf, 1e-9, "fft psf")
    mm = MMDFTPSF(lenses[1], FIELD, device="cpu", **MMDFT)
    assert mm.psf.shape == (16, 16)
    assert_close(mm.psf, jax_ref["mmdft"].psf, 1e-9, "mmdft psf")
    assert abs(float(mm.strehl_ratio())
               - float(jax_ref["mmdft"].strehl_ratio())) < 1e-9


def test_fft_mtf_matches_jax(lenses, jax_ref):
    ref = jax_ref["fftmtf"]
    got = ScalarFFTMTF(lenses[1], device="cpu", **FFT)
    assert got.fields == ref.fields and len(got.fields) == 3
    np.testing.assert_allclose(got.FNO, ref.FNO, rtol=1e-10)
    assert got._fno_on_axis == pytest.approx(ref._fno_on_axis, rel=1e-10)
    for k in range(3):
        for g, r, name in zip(got.mtf[k], ref.mtf[k], ("tang", "sag")):
            assert_close(g, r, 1e-9, name)
        assert_close(got.freq_tang[k], ref.freq_tang[k], 1e-10, "freq")
        assert_close(got.freq_sag[k], ref.freq_sag[k], 1e-10, "freq")


def test_sampled_mtf_matches_jax(lenses, jax_ref):
    ref = jax_ref["smtf"]
    got = SampledMTF(lenses[1], FIELD, device="cpu", **SAMPLED)
    assert_close(got.zernike_coeffs, ref.zernike_coeffs, 1e-10, "zernike")
    assert got.xpd == pytest.approx(ref.xpd, rel=1e-10)
    assert got.xpl == pytest.approx(ref.xpl, rel=1e-10)
    values = got.calculate_mtf(MTF_FREQS)
    assert 0.99 < values[0] <= 1.0 + 1e-12
    assert_close(np.array(values), np.array(jax_ref["smtf_values"]), 1e-9,
                 "sampled mtf")
