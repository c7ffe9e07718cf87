"""Module-level parity of the PyTorch port (optiland_tpu_torch) with the JAX
package, in float64 on the CPU: dispersion formulas, surface geometry,
first-order properties and ray generation. Inputs are made from a numpy
seed and handed to both packages; values agree to rtol 1e-12 (the two
evaluate the same float64 arithmetic; the tolerance leaves room for a
differently rounded transcendental or a reordered sum)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optiland_tpu.geometry import surfaces as jsurf
from optiland_tpu.materials import catalog as jcat
from optiland_tpu.materials import dispersion as jdisp
from optiland_tpu.system import paraxial as jpx
from optiland_tpu.trace import raygen as jraygen
from optiland_tpu_torch.geometry import surfaces as tsurf
from optiland_tpu_torch.materials import catalog as tcat
from optiland_tpu_torch.materials import dispersion as tdisp
from optiland_tpu_torch.system import paraxial as tpx
from optiland_tpu_torch.trace import raygen as traygen

from torch_port_helpers import bench_lens, singlet_lens, build_both

RTOL = 1e-12


def _close(a, b, rtol=RTOL, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach")
                                          else a),
                               np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


_FORMULAS = [
    (jdisp.FORMULA_IDEAL, [1.5]),
    (jdisp.FORMULA_SELLMEIER, [0.0, 1.0396, 0.0775, 0.2318, 0.1435, 1.0105,
                               10.15]),
    (jdisp.FORMULA_SELLMEIER2, [0.0, 1.0396, 0.0060, 0.2318, 0.0200, 1.0105,
                                103.56]),
    (jdisp.FORMULA_POLYNOMIAL, [2.27, -0.0101, 2.0, 0.0105, -2.0]),
    (jdisp.FORMULA_RII, [2.0, 0.5, 2.0, 0.1, 2.0, 0.3, 2.0, 10.0, 1.0, 0.01,
                         2.0]),
    (jdisp.FORMULA_CAUCHY, [1.5, 0.004, -2.0, 0.0001, -4.0]),
    (jdisp.FORMULA_GASES, [0.0, 0.05792105, 238.0185, 0.00167917, 57.362]),
    (jdisp.FORMULA_HERZBERGER, [1.5, 0.01, 0.001, 0.0001, -1e-5, 1e-6]),
    (jdisp.FORMULA_RETRO, [0.5, 0.1, 0.05, -0.01]),
    (jdisp.FORMULA_EXOTIC, [2.0, 0.02, 0.01, 0.1, 0.3, 0.05]),
    (jdisp.FORMULA_TABULATED, [0.4, 0.5, 0.6, 0.7, 1.53, 1.52, 1.515, 1.51]),
    (jdisp.FORMULA_POLYVAL,
     list(jcat.abbe_material(1.5168, 64.17).coefficients)),
]


@pytest.mark.parametrize("formula,coeffs", _FORMULAS,
                         ids=[str(f) for f, _ in _FORMULAS])
def test_material_index(formula, coeffs):
    w = np.linspace(0.35, 0.85, 9)
    padded = np.zeros(tdisp.MAX_COEFFS)
    padded[:len(coeffs)] = coeffs
    ref = jdisp.material_index(formula, len(coeffs), jnp.asarray(padded),
                               jnp.asarray(w))
    got = tdisp.material_index(formula, len(coeffs),
                               torch.tensor(padded), torch.tensor(w))
    _close(got, ref)


def test_abbe_material_and_resolve():
    assert (tcat.abbe_material(1.5168, 64.17).coefficients
            == jcat.abbe_material(1.5168, 64.17).coefficients)
    for spec in (1.52, "air", "mirror", None, "N-BK7"):
        a, b = tcat.resolve_material(spec), jcat.resolve_material(spec)
        assert (a.formula, a.coefficients, a.mirror, a.k_table) == (
            b.formula, b.coefficients, b.mirror, b.k_table)
    with pytest.raises(KeyError, match="No matches"):
        tcat.resolve_material("no-such-glass-xyz")


_GEOMS = [
    ("plane", jsurf.GEOM_PLANE, 0.0, 0.0, []),
    ("conic", jsurf.GEOM_CONIC, 1 / 50.0, -0.5, []),
    ("even_asphere", jsurf.GEOM_EVEN_ASPHERE, 1 / 50.0, 0.1,
     [1e-5, -1e-8, 1e-11]),
    ("odd_asphere", jsurf.GEOM_ODD_ASPHERE, 1 / 40.0, 0.0,
     [1e-4, 1e-6, -1e-8]),
]


@pytest.mark.parametrize("name,code,cv,k,coeffs", _GEOMS,
                         ids=[g[0] for g in _GEOMS])
def test_geometry(name, code, cv, k, coeffs):
    rng = np.random.default_rng(1)
    n = 64
    x, y = rng.uniform(-8, 8, (2, n))
    co = np.zeros(17)
    co[:len(coeffs)] = coeffs
    nc = len(coeffs)
    j = dict(cv=jnp.asarray(cv), k=jnp.asarray(k), coeffs=jnp.asarray(co))
    t = dict(cv=torch.tensor(cv, dtype=torch.float64),
             k=torch.tensor(k, dtype=torch.float64), coeffs=torch.tensor(co))
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), \
        torch.tensor(y)

    _close(tsurf.sag(code, nc, tx, ty, **t), jsurf.sag(code, nc, jx, jy, **j),
           atol=1e-15)
    for a, b in zip(tsurf.sag_and_grad(code, nc, tx, ty, **t),
                    jsurf.sag_and_grad(code, nc, jx, jy, **j)):
        _close(a, b, atol=1e-15)

    # oblique rays from z = -5 toward the surface
    L, M = rng.uniform(-0.2, 0.2, (2, n))
    N = np.sqrt(1 - L * L - M * M)
    z = np.full(n, -5.0)
    jr = [jnp.asarray(v) for v in (x, y, z, L, M, N)]
    tr = [torch.tensor(v) for v in (x, y, z, L, M, N)]
    t_t, v_t = tsurf.intersect(code, nc, *tr, t["cv"], t["k"], t["coeffs"])
    t_j, v_j = jsurf.intersect(code, nc, *jr, j["cv"], j["k"], j["coeffs"])
    _close(t_t, t_j)
    assert np.array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.fixture(scope="module")
def bench_pair():
    return build_both(bench_lens)


@pytest.mark.parametrize("fn", ["EPL", "EPD", "FNO", "f2"])
def test_paraxial(bench_pair, fn):
    (js, jp), (ts, tp) = bench_pair
    _close(getattr(tpx, fn)(ts, tp), getattr(jpx, fn)(js, jp))


def test_paraxial_singlet_object_height():
    (js, jp), (ts, tp) = build_both(lambda O: singlet_lens(
        O, field_type="object_height", object_distance=200.0))
    for fn in ("EPL", "EPD", "FNO", "f2"):
        _close(getattr(tpx, fn)(ts, tp), getattr(jpx, fn)(js, jp),
               err_msg=fn)


@pytest.mark.parametrize("field_type", ["angle", "object_height"])
def test_generate_rays(field_type):
    (js, jp), (ts, tp) = build_both(lambda O: singlet_lens(
        O, field_type=field_type, object_distance=(
            math.inf if field_type == "angle" else 200.0)))
    rng = np.random.default_rng(2)
    n = 50
    Hx, Hy, Px, Py = rng.uniform(-1, 1, (4, n))
    ref = jraygen.generate_rays(js, jp, *(jnp.asarray(a)
                                          for a in (Hx, Hy, Px, Py)), 0.55)
    got = traygen.generate_rays(ts, tp, *(torch.tensor(a)
                                          for a in (Hx, Hy, Px, Py)), 0.55)
    for name in ("x", "y", "z", "L", "M", "N", "i", "opd", "w"):
        _close(getattr(got, name), getattr(ref, name), atol=1e-15,
               err_msg=name)
