"""The 26 lenses of the zoo (`optiland_tpu_torch/models/zoo.py`) in the
port, float64 on the CPU:
  - each lens's packed tables against the JAX package's build of the same
    prescription (host side: the JAX build carried across must equal the
    port's own, masks, materials and flags included);
  - each of the 19 lenses that need none of the system core's extras
    traces on its fields with finite, live rays;
  - the seven that do, through their own paths: the four aimed lenses'
    rays cross the stop at (Px, Py) times the stop radius (their aim's
    target), `UVProjectionLens`'s chief rays leave the object parallel to
    the axis (object-space telecentric), and the two annular apertures
    clip exactly the rays inside r_min.
JAX's aimers are not run here: on these lenses each call costs 47 s or
more of XLA compilation; tests/test_torch_aiming.py holds the port's
aimers to JAX's."""

import math

import numpy as np
import pytest
import torch

import optiland_tpu.models as jmodels
import optiland_tpu_torch.models as tmodels
from optiland_tpu_torch.system.apertures import RadialAperture
from optiland_tpu_torch.trace.aiming import stop_radius

from torch_port_helpers import carry_across, jax_build_f64

ZOO = [n for n in tmodels.__all__
       if n not in ("CookeTriplet", "DoubleGauss", "ReverseTelephoto")]
AIMED = {"WideAngle100FOV": 1.0, "ProjectionLens120FOV": 1.0,
         "ProjectionLens160FOV": 0.5, "WideAngle170FOV": 0.5}
ANNULAR = {"UVReflectingMicroscope": 4, "HubbleTelescope": 2}
EXTRAS = set(AIMED) | set(ANNULAR) | {"UVProjectionLens"}


def test_zoo_is_the_jax_packages():
    assert len(ZOO) == 26
    assert sorted(tmodels.__all__) == sorted(jmodels.__all__)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_build_matches_jax(name):
    js, jp = jax_build_f64(getattr(jmodels, name)())
    ts, tp = getattr(tmodels, name)().build(device="cpu")
    cs, cp = carry_across(js, jp)
    assert ts == cs
    for f in cp.__dataclass_fields__:
        a, b = getattr(tp, f), getattr(cp, f)
        assert torch.equal(a, b), f


@pytest.mark.parametrize("name", sorted(set(ZOO) - EXTRAS))
def test_zoo_traces(name):
    lens = getattr(tmodels, name)()
    assert lens.ray_aiming == "paraxial" and not lens.obj_space_telecentric
    h = lens.trace(Hx=0.0, Hy=1.0, num_rays=2, device="cpu")
    assert h.x.shape == (len(lens.surfaces), 19)
    for f in ("x", "y", "z", "L", "M", "N", "opd"):
        assert torch.isfinite(getattr(h, f)[-1]).all(), f
    assert (h.intensity[-1] > 0).sum() >= 10


@pytest.mark.parametrize("name", list(AIMED))
def test_aimed_lens_meets_its_stop_target(name):
    """Two rays at Hy = `AIMED[name]` (the widest lenses at half field: the
    robust continuation takes rounds in proportion), through `trace_generic`
    under the lens's own mode."""
    lens = getattr(tmodels, name)()
    assert lens.ray_aiming == ("iterative" if name == "WideAngle100FOV"
                               else "robust")
    Px = torch.zeros(2, dtype=torch.float64)
    Py = torch.tensor([-0.7, 0.7], dtype=torch.float64)
    h = lens.trace_generic(0.0, AIMED[name], Px, Py, device="cpu")
    ts, tp = lens.build(device="cpu")
    k = ts.stop_index
    r = stop_radius(ts, tp, torch.tensor(lens.primary_wavelength,
                                         dtype=torch.float64))
    assert torch.isfinite(h.y[-1]).all() and (h.intensity[-1] > 0).all()
    np.testing.assert_allclose((h.x[k] / r).numpy(), Px.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose((h.y[k] / r).numpy(), Py.numpy(), rtol=0,
                               atol=1e-9)


def test_uv_projection_lens_is_telecentric():
    lens = tmodels.UVProjectionLens()
    assert lens.obj_space_telecentric
    ts, _ = lens.build(device="cpu")
    assert ts.telecentric and ts.field_type == "object_height"
    Hy = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    zero = torch.zeros(3, dtype=torch.float64)
    chief = lens.trace_generic(zero, Hy, zero, zero, device="cpu")
    assert torch.equal(chief.L[0], zero) and torch.equal(chief.M[0], zero)
    assert torch.isfinite(chief.y[-1]).all()
    assert (chief.intensity[-1] > 0).all()
    # the chief rays start at the field's object heights
    heights = Hy * max(abs(y) for y in lens.fields.y)
    torch.testing.assert_close(chief.y[0], heights, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(ANNULAR))
def test_annular_aperture_clips_its_core(name):
    lens = getattr(tmodels, name)()
    k = ANNULAR[name]
    ts, tp = lens.build(device="cpu")
    mask = ts.aperture_masks[k]
    assert ts.has_aperture[k] and isinstance(mask, RadialAperture)
    assert mask.r_max == math.inf and mask.r_min > 0
    Py = torch.linspace(-0.95, 0.95, 39, dtype=torch.float64)
    h = lens.trace_generic(0.0, 0.0, torch.zeros_like(Py), Py, device="cpu")
    r = torch.hypot(h.x[k], h.y[k])
    inside = r < mask.r_min
    assert inside.any() and (~inside).any()
    assert (h.intensity[k][inside] == 0).all()
    assert (h.intensity[k][~inside] > 0).all()
    assert (h.intensity[-1][inside] == 0).all()
