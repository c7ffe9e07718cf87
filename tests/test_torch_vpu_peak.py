"""T1's chains (tools/vpu_peak.py) against the port's plain versions on the
CPU: the JAX tool's own kernel bodies, loaded from its file unchanged, run
through `pl.pallas_call(..., interpret=True)` on 2 tiles of (ROWS, LANE),
and `fma_plain`, `rsqrt_plain` and `tan_plain` of
optiland_tpu_torch/tools/vpu_peak.py on the same numpy input (seed 0).
The CUDA kernels are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from optiland_tpu_torch.tools import vpu_peak

ROOT = Path(__file__).resolve().parents[1]
TILES = 2
# float32 on both sides. The FMA chain is 512 dependent steps that JAX's
# interpreter and torch round differently, and an ulp in one step grows
# with the polynomial's degree (6.7e-6 relative measured at the largest);
# rsqrt agrees exactly, at its fixed point; the tan chain underflows to 0
# (subnormals on the way).
TOLS = {"fma": dict(rtol=1e-5, atol=0), "rsqrt": dict(rtol=1e-6, atol=0),
        "tan": dict(rtol=0, atol=1e-30)}


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_t1_vpu_peak", ROOT / "tools" / "vpu_peak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["fma", "rsqrt", "tan"])
def test_chain_matches_jax_kernel(jax_tool, name):
    for const in ("ROWS", "LANE", "N_TILES", "K_FMA", "K_TRANS"):
        assert getattr(jax_tool, const) == getattr(vpu_peak, const), const
    kernel = {"fma": jax_tool.fma_kernel, "rsqrt": jax_tool.sqrt_kernel,
              "tan": jax_tool.tan_kernel}[name]
    plain = {"fma": vpu_peak.fma_plain, "rsqrt": vpu_peak.rsqrt_plain,
             "tan": vpu_peak.tan_plain}[name]
    x = np.random.default_rng(0).uniform(
        1.0, 2.0, (TILES * vpu_peak.ROWS, vpu_peak.LANE)).astype(np.float32)
    spec = pl.BlockSpec((vpu_peak.ROWS, vpu_peak.LANE), lambda g: (g, 0))
    # eager: the interpreter's jit of 1024 unrolled steps costs ~10 s
    ref = np.asarray(pl.pallas_call(
        kernel, grid=(TILES,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(jnp.asarray(x)))
    got = plain(torch.from_numpy(x))
    # the CPU wrapper takes the plain version
    assert torch.equal(getattr(vpu_peak, f"{name}_chain")(torch.from_numpy(x)),
                       got)
    got = got.numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOLS[name])
    if name == "rsqrt":   # the chain's fixed point, a^2 (a + 1.5) = 1
        np.testing.assert_allclose(got, 0.6776506, rtol=1e-6)
    if name == "tan":     # underflowed
        assert not got.any()


@pytest.mark.parametrize("name", ["fma", "rsqrt", "tan"])
@pytest.mark.parametrize("steps", [0, 1, 2])
def test_chain_steps_match_numpy(name, steps):
    """The plain versions (which the CPU wrappers take) at the few steps at
    which the card's kernels are held to them, against the same arithmetic
    step by step in numpy float32: each element still its own value."""
    x = np.random.default_rng(0).uniform(
        1.0, 2.0, (vpu_peak.ROWS, vpu_peak.LANE)).astype(np.float32)
    f32 = np.float32
    acc = x * f32(0.51) if name == "fma" else x.copy()
    for _ in range(steps):
        if name == "fma":
            acc = acc * (x * f32(0.51)) + f32(0.003)
        elif name == "rsqrt":
            acc = f32(1) / np.sqrt(acc + f32(1.5))
        else:
            acc = np.tan(acc * f32(0.001))
    got = getattr(vpu_peak, f"{name}_chain")(torch.from_numpy(x), steps)
    assert got.dtype == torch.float32
    # numpy's float32 sqrt and divide round twice where torch.rsqrt rounds
    # once; tan is libm's in both
    np.testing.assert_allclose(got.numpy(), acc, rtol=4e-7, atol=0)
    assert np.unique(got.numpy()).size > x.size // 2


def test_chain_refuses_negative_steps():
    with pytest.raises(ValueError, match="steps"):
        vpu_peak.tan_chain(torch.ones(4), -1)
