"""The tolerancing of the PyTorch port against the JAX package, float64 on
the CPU: the samplers' draw table bit for bit, the perturb -> compensate ->
evaluate pipeline draw by draw (a damped Gauss-Newton compensator whose
Jacobian the port takes by reverse mode, JAX by forward mode), Monte Carlo
and sensitivity tables, chunked checkpoints and their resume, and the
refusal of a mesh that is not a DeviceMesh.

The JAX oracle (`jax_ref`) runs JAX's own `MonteCarlo.run` and
`SensitivityAnalysis.run`; their shared `pipeline_batch` is compiled once,
at XLA's backend optimization level 0, for the one batch shape both use.
The system is the conic singlet of `tests/test_fused_kernel.py` (its
closed-form intersection: JAX's forward-mode Jacobian does not pass
through the implicit asphere intersection)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optiland_tpu import tolerancing as jtol
from optiland_tpu.system.optic import Optic as JOptic
from optiland_tpu_torch import tolerancing as ttol
from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.utils import checkpoint as tckpt

from torch_port_helpers import jax_f64, singlet_lens

DRAWS = 5
SEED = 1


def make_tolerancing(pkg, lens, samplers="range", operands=True):
    """Radius and thickness of the front face perturbed, the image gap the
    compensator (4 Gauss-Newton steps), f2 and the RMS spot at 7 rays
    (their nominal values the targets)."""
    if samplers == "range":
        s1 = pkg.RangeSampler(49.0, 51.0, DRAWS)
        s2 = pkg.RangeSampler(4.9, 5.1, DRAWS)
    else:
        s1 = pkg.NormalSampler(50.0, 0.5)
        s2 = pkg.UniformSampler(4.9, 5.1)
    t = pkg.Tolerancing(lens, compensator_steps=4)
    t.add_perturbation("radius", s1, surface_number=1)
    t.add_perturbation("thickness", s2, surface_number=1)
    t.add_compensator("thickness", surface_number=2)
    if operands:
        t.add_operand("f2")
        t.add_operand("rms_spot_size", input_data={
            "surface_number": -1, "Hx": 0.0, "Hy": 1.0, "num_rays": 1,
            "wavelength": 0.55})
    return t


def port_tolerancing(samplers="range"):
    lens = singlet_lens(TOptic, asphere=False)
    lens.build(device="cpu")
    return make_tolerancing(ttol, lens, samplers)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's Monte Carlo and sensitivity tables of the range tolerancing:
    both run `pipeline_batch` on (5, 2) draws."""
    with jax_f64():
        t = make_tolerancing(jtol, singlet_lens(JOptic, asphere=False))
        c = t._compile()
        c["pipeline_batch"] = c["pipeline_batch"].lower(
            t._nominal_params, jnp.asarray(t.draw_table(DRAWS, SEED))
        ).compile(compiler_options={"xla_backend_optimization_level": 0})
        return {"mc": jtol.MonteCarlo(t).run(DRAWS, seed=SEED),
                "sa": jtol.SensitivityAnalysis(t).run()}


@pytest.mark.parametrize("samplers", ["range", "normal"])
def test_draw_table_bit_identical(samplers):
    """Every sampler's draws (numpy's Generator under the same seed) equal
    JAX's bit for bit, and a scalar sampler fills its value."""
    with jax_f64():
        jt = make_tolerancing(jtol, singlet_lens(JOptic, asphere=False),
                              samplers, operands=False)
        jt.add_perturbation("conic", jtol.ScalarSampler(0.25),
                            surface_number=2)
    tt = port_tolerancing(samplers)
    tt.add_perturbation("conic", ttol.ScalarSampler(0.25), surface_number=2)
    for seed in (0, 7):
        a, b = tt.draw_table(9, seed), jt.draw_table(9, seed)
        assert a.shape == (9, 3) and a.tobytes() == b.tobytes()
        assert (a[:, 2] == 0.25).all()


def test_monte_carlo_matches_jax(jax_ref):
    """`MonteCarlo.run`: every column (perturbations, the compensator, the
    operands) of each draw within 1e-9 of JAX's."""
    df = ttol.MonteCarlo(port_tolerancing()).run(DRAWS, seed=SEED)
    ref = jax_ref["mc"]
    assert list(df.columns) == list(ref.columns) and len(df) == DRAWS
    for col in ref.columns:
        np.testing.assert_allclose(df[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=col)


def test_pipeline_per_draw_matches_jax(jax_ref):
    """`apply(draw)`, one draw at a time, returns the Monte-Carlo row's
    operand values (within 1e-9 of JAX's) and leaves the optic's cached
    parameters as they were."""
    t = port_tolerancing()
    params = t.optic.params
    saved = {k: v.clone() for k, v in vars(params).items()
             if torch.is_tensor(v)}
    draws = t.draw_table(DRAWS, SEED)
    ref = jax_ref["mc"]
    ops = [c for c in ref.columns if c[0].isdigit()]
    for i in (0, DRAWS - 1):
        vals = t.apply(draws[i]).numpy()
        np.testing.assert_allclose(vals, ref[ops].to_numpy()[i], rtol=1e-9,
                                   atol=1e-12)
    assert t.optic.params is params
    for k, v in saved.items():
        assert torch.equal(getattr(params, k), v), k
    np.testing.assert_allclose(t.evaluate().numpy(),
                               [o.target for o in t.operands], rtol=1e-14)


def test_sensitivity_matches_jax(jax_ref):
    """`SensitivityAnalysis.run`: the range sweeps of both perturbations
    (the other held nominal), rows and values within 1e-9 of JAX's."""
    df = ttol.SensitivityAnalysis(port_tolerancing()).run()
    ref = jax_ref["sa"]
    assert list(df.columns) == list(ref.columns) and len(df) == 2 * DRAWS
    assert list(df["perturbation"]) == list(ref["perturbation"])
    for col in ref.columns[1:]:
        np.testing.assert_allclose(df[col].to_numpy(float),
                                   ref[col].to_numpy(float), rtol=1e-9,
                                   atol=1e-12, err_msg=col)


def test_monte_carlo_chunks_resume(tmp_path):
    """Chunked draws checkpoint each chunk; a run that resumes from the
    second chunk's checkpoint gives the straight run's table."""
    t = port_tolerancing("normal")
    straight = ttol.MonteCarlo(t).run(DRAWS, seed=SEED)
    chunked = ttol.MonteCarlo(t).run(DRAWS, seed=SEED, chunk_size=2,
                                     checkpoint_dir=str(tmp_path))
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(str(tmp_path))) == 3
    np.testing.assert_allclose(chunked.to_numpy(), straight.to_numpy(),
                               rtol=1e-13)
    (tmp_path / "step_00000003").unlink()
    resumed = ttol.MonteCarlo(t).run(DRAWS, seed=SEED, chunk_size=2,
                                     checkpoint_dir=str(tmp_path))
    np.testing.assert_allclose(resumed.to_numpy(), straight.to_numpy(),
                               rtol=1e-13)


def test_compensator_recovers_focus():
    """tests/test_tolerancing.py's defocus on the port: the image gap of the
    Cooke triplet set to 44 mm, the compensator pulls it back near 42.208
    and the spot near its nominal size."""
    from optiland_tpu_torch.models import CookeTriplet

    lens = CookeTriplet()
    lens.build(device="cpu")
    t = ttol.Tolerancing(lens, compensator_steps=8)
    t.add_perturbation("thickness", ttol.ScalarSampler(44.0),
                       surface_number=6)
    t.add_compensator("thickness", surface_number=6)
    t.add_operand("rms_spot_size", input_data={
        "surface_number": -1, "Hx": 0, "Hy": 0.0, "num_rays": 3,
        "wavelength": 0.55})
    df = ttol.MonteCarlo(t).run(2)
    comp = df[[c for c in df.columns if c.startswith("C0")][0]]
    rms = df[[c for c in df.columns if "rms" in c][0]]
    assert abs(comp.iloc[0] - 42.20778) < 0.3 and rms.iloc[0] < 0.01


def test_monte_carlo_refuses_a_mesh():
    """A mesh that is not a DeviceMesh is refused by name (a DeviceMesh
    shards the draws: tests/test_torch_parallel.py)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttol.MonteCarlo(port_tolerancing(), mesh=object())
