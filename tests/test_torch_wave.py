"""The Huygens path of the PyTorch port against the JAX package, float64 on
the CPU, on the Cooke triplet (`models/objectives.py`): the Huygens sum
(`huygens_sum_plain`, K8's plain version, against `huygens_sum_xla`, never
Pallas interpret mode), `ScalarHuygensPSF`, `HuygensMTF`, and the
factories' refusal of a polarized optic. tests/test_torch_wavefront.py
holds `wavefront_data` and the OPD analyses, and
tests/test_torch_wave_analyses.py the FFT analyses.

The JAX references run once per module (`jax_f64`), at one pupil size
(the PSF's 16 x 16 grid), so their jitted `wavefront_data` compiles once. Tolerances, each of the largest entry
of the compared array, float64 on both sides:
  - the Huygens sum 1e-10: XLA's CPU sin/cos and multiply-adds round
    otherwise than PyTorch's, and k = 1.1e4 /mm turns one ulp of R = 54 mm
    into 8e-11 rad (measured 1.5e-11 of the peak; PyTorch against numpy's
    same formula 2.5e-12);
  - the PSF and MTF 1e-9 (2 pi times the OPD's 2e-11 waves in each
    phase); Strehl 1e-9 absolute; pixel pitch and centroid 1e-12 mm.
"""

import pytest
import torch

import jax.numpy as jnp

from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu.mtf import HuygensMTF as JHuygensMTF
from optiland_tpu.psf import ScalarHuygensPSF as JHuygensPSF
from optiland_tpu.psf.huygens import huygens_sum_xla
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.mtf import FFTMTF, HuygensMTF
from optiland_tpu_torch.psf import FFTPSF, HuygensPSF, ScalarHuygensPSF
from optiland_tpu_torch.psf import huygens as thuygens
from optiland_tpu_torch.wavefront import wavefront_data as twavefront
from optiland_tpu_torch.wavefront.core import pupil_grid_coords

from torch_port_helpers import assert_close, jax_f64

FIELDS = [(0.0, 0.0), (0.0, 1.0)]
N_GRID = 16     # the PSF's pupil grid: 256 samples, the one pupil size here


@pytest.fixture(scope="module")
def lenses():
    return JCooke(), TCooke()


@pytest.fixture(scope="module")
def pupil():
    return pupil_grid_coords(N_GRID, torch.float64, "cpu")


@pytest.fixture(scope="module")
def jax_ref(lenses):
    """Every JAX reference of the module, computed once."""
    jl = lenses[0]
    out = {}
    with jax_f64():
        for f in FIELDS:
            out["psf", f] = JHuygensPSF(jl, f, num_rays=N_GRID,
                                        image_size=N_GRID, use_pallas=False)
        out["mtf"] = JHuygensMTF(jl, (0, 0), 0.55, num_rays=N_GRID,
                                 image_size=N_GRID, use_pallas=False)
    return out


def test_huygens_sum_plain_matches_xla(lenses, pupil):
    """K8's plain version against `huygens_sum_xla` on the Cooke triplet's
    geometry (Rp ~ 54 mm): 324 image points around the chief ray's hit, in
    chunks of 100 rows, and 256 pupil samples with their amplitudes and
    OPD."""
    ts, tp = lenses[1].build(device="cpu")
    Px, Py, inside = pupil
    data = twavefront(ts, tp, 0.0, 1.0, Px, Py, 0.55)
    g = torch.linspace(-0.02, 0.02, 18, dtype=torch.float64)
    IX, IY = torch.meshgrid(g + data.center[0], g + data.center[1],
                            indexing="xy")
    image = (IX, IY, torch.zeros_like(IX) + data.center[2])
    pupil_xyz = (data.pupil_x, data.pupil_y, data.pupil_z)
    amp = torch.sqrt(data.intensity) * inside
    opd_mm = data.opd * 0.55e-3
    assert 50.0 < float(data.radius) < 60.0
    args = (image, pupil_xyz, amp, opd_mm, 0.55e-3, data.radius)
    got = thuygens.huygens_sum_plain(*args, row_chunk=100)
    ref = huygens_sum_xla(*(tuple(jnp.asarray(a.numpy()) for a in grp)
                            for grp in (image, pupil_xyz)),
                          jnp.asarray(amp.numpy()),
                          jnp.asarray(opd_mm.numpy()), 0.55e-3,
                          float(data.radius))
    assert_close(got, ref, 1e-10)
    # on CPU tensors the kernel's wrapper is the plain version
    assert torch.equal(thuygens.huygens_sum(*args),
                       thuygens.huygens_sum_plain(*args))


@pytest.mark.parametrize("field", FIELDS, ids=str)
def test_huygens_psf_matches_jax(lenses, jax_ref, field):
    ref = jax_ref["psf", field]
    got = ScalarHuygensPSF(lenses[1], field, num_rays=N_GRID,
                           image_size=N_GRID, device="cpu")
    assert got.psf.shape == (N_GRID, N_GRID)
    assert_close(got.psf, ref.psf, 1e-9, "psf")
    for name in ("pixel_pitch", "cx", "cy"):
        assert_close(getattr(got, name), getattr(ref, name), 1e-12, name,
                     scale=1.0)
    assert abs(float(got.strehl_ratio()) - float(ref.strehl_ratio())) < 1e-9
    if field == (0.0, 0.0):
        assert 0.05 < float(got.strehl_ratio()) < 0.1
    # JAX's use_pallas=False is the port's use_kernel=False
    plain = ScalarHuygensPSF(lenses[1], field, num_rays=N_GRID,
                             image_size=N_GRID, use_kernel=False,
                             device="cpu")
    assert torch.equal(plain.psf, got.psf)


def test_huygens_mtf_matches_jax(lenses, jax_ref):
    ref = jax_ref["mtf"]
    got = HuygensMTF(lenses[1], (0, 0), 0.55, num_rays=N_GRID,
                     image_size=N_GRID, device="cpu")
    for t, r in zip(got.mtf, ref.mtf):
        assert t.shape == (N_GRID // 2,)
        assert_close(t, r, 1e-9, "mtf")
    assert_close(got.freq, ref.freq, 1e-10, "freq")
    assert abs(got.max_freq - ref.max_freq) < 1e-10 * ref.max_freq


def test_factories_refuse_polarized_optic():
    """The factories pick the scalar analyses for a scalar optic and the
    vectorial ones for a polarized optic (tests/test_torch_polarization.py
    holds those to the JAX package)."""
    from optiland_tpu_torch.mtf import VectorialFFTMTF
    from optiland_tpu_torch.psf import VectorialFFTPSF, VectorialHuygensPSF

    lens = TCooke()
    assert isinstance(HuygensPSF(lens, (0, 0), num_rays=4, image_size=2,
                                 device="cpu"), ScalarHuygensPSF)
    lens.set_polarization("unpolarized")
    assert isinstance(HuygensPSF(lens, (0, 0), num_rays=4, image_size=2,
                                 device="cpu"), VectorialHuygensPSF)
    assert isinstance(FFTPSF(lens, (0, 0), num_rays=8, grid_size=16,
                             device="cpu"), VectorialFFTPSF)
    mtf = FFTMTF(lens, fields=[(0, 0)], num_rays=8, grid_size=16,
                 device="cpu")
    assert isinstance(mtf, VectorialFFTMTF)
    assert isinstance(HuygensMTF(lens, num_rays=4, image_size=4,
                                 device="cpu").psf_obj, VectorialHuygensPSF)
