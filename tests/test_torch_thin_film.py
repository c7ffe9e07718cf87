"""`thin_film/` of the PyTorch port against the JAX package, float64 on the
CPU: `tmm_coh`, the stack's complex amplitudes and R/T/A spectra at s, p
and u over AOIs and wavelengths (a dispersive substrate and an absorbing
layer among them), their gradient in the layer thicknesses, the coating's
Jones matrices at per-ray AOI and wavelength, a stack carried across from
the JAX package, `ThinFilmOptimizer` (5 L-BFGS-B iterations on a 4-layer
AR stack), `ThinFilmSensitivity` and `ThinFilmMonteCarlo` on JAX's own
draws, and the port's needle synthesis.

The JAX spectra and gradients are one jitted program, compiled at XLA's
backend optimization level 0 in a thread beside the JAX optimizer, the
sensitivity sweep and the Monte Carlo, each in a thread of its own (they
jit their own merits)."""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optiland_tpu.materials.catalog import MaterialSpec as JMat
from optiland_tpu.thin_film import ThinFilmMonteCarlo as JMC
from optiland_tpu.thin_film import ThinFilmOptimizer as JOpt
from optiland_tpu.thin_film import ThinFilmSensitivity as JSens
from optiland_tpu.thin_film import ThinFilmStack as JStack
from optiland_tpu_torch.materials.catalog import MaterialSpec as TMat
from optiland_tpu_torch.system.spec import _port_object
from optiland_tpu_torch.thin_film import (
    NeedleSynthesis,
    ThinFilmMonteCarlo,
    ThinFilmOptimizer,
    ThinFilmSensitivity,
    ThinFilmStack,
    tmm_coh,
)

from torch_port_helpers import jax_f64

RTOL = 1e-10
GRAD_RTOL = 1e-8
WL = np.linspace(0.4, 0.8, 41)
AOI = np.deg2rad(np.array([0.0, 30.0, 60.0]))
THICK = (0.058, 0.100, 0.020, 0.071)
MC_TRIALS = 64
LEVEL0 = {"xla_backend_optimization_level": 0}


def spectral_stack(Stack, Mat):
    """Air | TiO2-like 2.35 | MgF2-like 1.38 | an absorbing ideal layer
    (n 2.0, k 0.05) | 1.6 | N-BK7 (the catalog's Sellmeier)."""
    stack = Stack(incident_material="air", substrate_material="N-BK7")
    for mat, d in zip((2.35, 1.38, Mat(0, (2.0, 0.05), name="lossy"), 1.6),
                      THICK):
        stack.add_layer(mat, d)
    return stack


def ar_stack(Stack):
    """A 4-layer AR start on n = 1.52, off its optimum."""
    stack = Stack(incident_material="air", substrate_material=1.52)
    for n, d in ((1.38, 0.09), (2.1, 0.05), (1.38, 0.03), (2.1, 0.02)):
        stack.add_layer(n, d)
    return stack


def _setup(opt):
    opt.add_all_variables(min_nm=5.0, max_nm=400.0)
    opt.add_operand(property="R", wavelength_nm=np.linspace(450, 650, 9),
                    target_type="equal", value=0.0, polarization="u")
    opt.add_operand(property="R", wavelength_nm=550.0, aoi_deg=30.0,
                    target_type="below", value=0.005, polarization="s",
                    weight=2.0)
    return opt


def _tolerancing(tol):
    tol.add_perturbation(0, range_nm=5.0)
    tol.add_perturbation(2, sigma_nm=2.0)
    tol.add_operand("R", wavelength_nm=[500.0, 550.0, 600.0])
    tol.add_operand("T", wavelength_nm=550.0, aoi_deg=20.0, polarization="p")
    return tol


def _spectra(stack, th, w, aoi, k0, k1):
    """(r, t, R, T, A) per polarization on the (wavelength, AOI) grid, the
    unpolarized R, T, A, and the coating's Jones matrices at per-ray
    wavelength and AOI; `th` replaces the layers' thicknesses."""
    for i, d in enumerate(th):
        stack.layers[i] = type(stack.layers[i])(stack.layers[i].material, d)
    grid = (w[:, None], aoi[None, :])
    out = {p: stack.compute_rtRTA(*grid, p) for p in ("s", "p")}
    out["u"] = (stack.reflectance(*grid), stack.transmittance(*grid),
                stack.absorptance(*grid))
    aoi_r = jnp.arccos(jnp.abs(k0[:, 2])) if isinstance(k0, jax.Array) \
        else torch.arccos(torch.abs(k0[:, 2]))
    w_r = 0.45 + 0.3 * aoi_r
    out["jones"] = (stack.jones_matrices(k0, k1, w_r, aoi_r, reflect=False),
                    stack.jones_matrices(k0, k1, w_r, aoi_r, reflect=True))
    return out


def _dirs(n=16):
    rng = np.random.default_rng(2)
    L, M = rng.uniform(-0.5, 0.5, (2, n))
    return np.stack([L, M, np.sqrt(1 - L**2 - M**2)], axis=1)


@pytest.fixture(scope="module")
def jax_ref():
    with jax_f64(), ThreadPoolExecutor(4) as pool:
        stack = spectral_stack(JStack, JMat)
        k0 = jnp.asarray(_dirs())

        def spectra(th, w, aoi):
            return _spectra(stack, th, w, aoi, k0, k0)

        def loss(th, w, aoi):
            out = _spectra(stack, th, w, aoi, k0, k0)
            return jnp.sum(out["u"][0]) + jnp.sum(out["p"][3])

        args = (jnp.asarray(THICK), jnp.asarray(WL), jnp.asarray(AOI))
        prog = pool.submit(jax.jit(lambda *a: (spectra(*a), jax.grad(loss)(
            *a))).lower(*args).compile, LEVEL0)

        def optimize():
            opt = _setup(JOpt(ar_stack(JStack)))
            res = opt.optimize(max_iter=5)
            return ([float(lay.thickness_um) for lay in opt.stack.layers],
                    list(opt._history), int(res.nit))

        optim = pool.submit(optimize)
        sens = pool.submit(lambda: _tolerancing(JSens(ar_stack(JStack))).run(
            num_steps=7))
        mc_tol = _tolerancing(JMC(ar_stack(JStack)))
        mc = pool.submit(lambda: mc_tol.run(num_trials=MC_TRIALS, seed=3))
        key = jax.random.PRNGKey(3)
        draws = np.stack([np.asarray(p.sample(jax.random.fold_in(key, i),
                                              MC_TRIALS))
                          for i, p in enumerate(mc_tol.perturbations)], -1)
        spec, grad = prog.result()(*args)
        return dict(spectra=spec, grad=grad, optim=optim.result(),
                    sens=sens.result(), mc=mc.result(), draws=draws,
                    jstack=spectral_stack(JStack, JMat))


def _close(got, ref, tol=RTOL, label=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"{label}: {err:.3e} of scale"


def test_stack_spectra_and_jones_matrices(jax_ref):
    stack = spectral_stack(ThinFilmStack, TMat)
    k0 = torch.tensor(_dirs())
    th = torch.tensor(THICK, dtype=torch.float64, requires_grad=True)
    w, aoi = torch.tensor(WL), torch.tensor(AOI)
    got = _spectra(stack, list(th), w, aoi, k0, k0)
    ref = jax_ref["spectra"]
    for pol in ("s", "p", "u"):
        for label, g, r in zip("rtRTA" if pol != "u" else "RTA", got[pol],
                               ref[pol]):
            _close(g, r, label=f"{label} ({pol})")
    for g, r in zip(got["jones"], ref["jones"]):
        assert g.dtype == torch.complex128
        _close(g, r, label="jones")
    loss = torch.sum(got["u"][0]) + torch.sum(got["p"][3])
    loss.backward()
    _close(th.grad, jax_ref["grad"], GRAD_RTOL, "d loss / d thickness")


def test_tmm_coh_direct_and_carried_stack(jax_ref):
    """`tmm_coh` on bare indices, and a JAX stack carried across
    (`spec._port_object`) gives the port's spectra."""
    w = torch.tensor(WL)
    r, t, R, T, A = tmm_coh(1.0, 1.52, [2.35, 1.38 + 0.01j], [0.058, 0.1],
                            w, 0.4, "p")
    assert torch.allclose(R + T + A, torch.ones_like(R), atol=1e-14)
    assert (A > 0).all()
    carried = _port_object(jax_ref["jstack"])
    assert isinstance(carried, ThinFilmStack) and len(carried) == 4
    own = spectral_stack(ThinFilmStack, TMat)
    for pol in ("s", "p"):
        for a, b in zip(carried.compute_rtRTA(w, 0.3, pol),
                        own.compute_rtRTA(w, 0.3, pol)):
            assert torch.equal(a, b)
    # nm / degree conveniences
    assert torch.allclose(own.reflectance_nm_deg(w * 1e3, 17.2),
                          own.reflectance(w, math.radians(17.2)),
                          rtol=1e-14)


def test_optimizer_matches_jax(jax_ref):
    opt = _setup(ThinFilmOptimizer(ar_stack(ThinFilmStack), device="cpu"))
    res = opt.optimize(max_iter=5)
    thick, history, nit = jax_ref["optim"]
    assert int(res.nit) == nit
    np.testing.assert_allclose(opt._history, history, rtol=GRAD_RTOL)
    np.testing.assert_allclose([lay.thickness_um for lay in opt.stack.layers],
                               thick, rtol=GRAD_RTOL)
    assert history[-1] < history[0]


def test_sensitivity_and_monte_carlo_match_jax(jax_ref):
    sens = _tolerancing(ThinFilmSensitivity(ar_stack(ThinFilmStack),
                                            device="cpu")).run(num_steps=7)
    for k, ref in jax_ref["sens"].items():
        _close(sens[k]["delta_nm"], ref["delta_nm"], label="delta")
        _close(sens[k]["values"], ref["values"], label="sensitivity")
    mc = _tolerancing(ThinFilmMonteCarlo(ar_stack(ThinFilmStack),
                                         device="cpu")).run(
        num_trials=MC_TRIALS, draws=torch.tensor(jax_ref["draws"]))
    for key in ("thicknesses_um", "values", "mean", "std", "p05", "p95"):
        _close(mc[key], jax_ref["mc"][key], label=key)
    # the port's own stream: reproducible from a generator
    tol = _tolerancing(ThinFilmMonteCarlo(ar_stack(ThinFilmStack),
                                          device="cpu"))
    a = tol.run(num_trials=8, generator=torch.Generator().manual_seed(1))
    b = tol.run(num_trials=8, generator=torch.Generator().manual_seed(1))
    assert np.array_equal(a["values"], b["values"])


def test_needle_synthesis_improves_merit():
    stack = ThinFilmStack(incident_material="air", substrate_material=1.52)
    stack.add_layer(1.38, 0.1)
    needle = NeedleSynthesis(stack, needle_material=2.35,
                             positions_per_layer=2, max_needles=2,
                             device="cpu")
    needle.add_target("R", np.linspace(450, 650, 5), "equal", 0.0)
    result = needle.run()
    assert result.merit_history[-1] <= result.merit_history[0]
    assert len(result.steps) >= 2
