"""The port's CUDA kernels on the card (no JAX needed): K1 and K3 against
their plain PyTorch versions in float32, the dispatch of the public entry
points to the kernels, and the explicit refusals of the paths whose kernels
are not ported yet. Every test skips without a CUDA device and nvcc.

On a machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.system.optic import Optic
from optiland_tpu_torch.trace import fused, tracer

from torch_port_helpers import bench_lens, singlet_lens

pytestmark = pytest.mark.cuda

# float32, kernel against plain: the two round differently (FMA
# contraction, hardware rsqrt), a few ulps per surface at mm scales
POS_TOL, DIR_TOL, OPD_TOL, MOMENT_RTOL = 5e-4, 1e-5, 2e-3, 1e-4

_SYSTEMS = {
    "singlet": dict(),
    "tilt_decenter_aperture": dict(tilt=True, decenter=True, aperture=4.5),
    "odd_asphere_mirror": dict(mirror=True, odd=True),
}


@pytest.fixture
def cuda_f32():
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("no CUDA device / nvcc")
    prev = config.get_dtype()
    config.set_precision("float32")
    yield torch.device("cuda")
    config.set_precision("float64" if prev == torch.float64 else "float32")


def _data(n, device, seed=11):
    rng = np.random.default_rng(seed)
    Px, Py = rng.uniform(-0.9, 0.9, (2, n))
    Hx, Hy = rng.uniform(-0.5, 0.5, (2, n))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (Hx, Hy, Px, Py))


def _args(ts, tp, w):
    n_table, alpha = fused._uniform_tables(ts, tp, w)
    return (fused._diff_params(tp, n_table), fused._nondiff_params(tp, alpha),
            fused._raygen_scalars(ts, tp))


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_kernels_match_plain(cuda_f32, name):
    ts, tp = singlet_lens(Optic, **_SYSTEMS[name]).build(device=cuda_f32)
    ts = replace(ts, newton_iters=4)
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
    same = outs[6] == refs[6]
    assert same.float().mean().item() >= 1 - 1e-3
    for k, tol in enumerate((POS_TOL,) * 3 + (DIR_TOL,) * 3 + (0, OPD_TOL)):
        if k != 6:
            err = (outs[k] - refs[k])[same].abs().max().item()
            assert err <= tol, (fused._NAMES[k], err)


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
    data = _data(4096, cuda_f32, seed=0)
    k1, k3 = fused.moments_forward.launches, fused.raygen_trace_forward.launches
    m = fused.spot_moments(ts, tp, *data, 0.5876)
    out = tracer.trace_system_final(ts, tp, *data, 0.5876)
    assert fused.moments_forward.launches == k1 + 1
    assert fused.raygen_trace_forward.launches == k3 + 1
    assert all(math.isfinite(float(v)) for v in m)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    # the paths whose kernels are the next slice refuse, naming the kernel
    with pytest.raises(NotImplementedError, match="K7 _history_forward"):
        tracer.trace_system(ts, tp, *data, 0.5876)
    vignetted = replace(ts, has_vignetting=True)
    with pytest.raises(NotImplementedError, match="K5 _fused_forward"):
        tracer.trace_system_final(vignetted, tp, *data, 0.5876)


def test_wrapper_rejects_bad_inputs(cuda_f32):
    ts, tp = singlet_lens(Optic).build(device=cuda_f32)
    data = _data(64, cuda_f32)
    args = _args(ts, tp, 0.55)
    with pytest.raises(ValueError, match="float32"):
        fused.moments_forward(ts, *args, tuple(d.double() for d in data))
    strided = tuple(torch.stack([d, d], 1)[:, 0] for d in data)
    with pytest.raises(ValueError, match="contiguous"):
        fused.moments_forward(ts, *args, strided)
