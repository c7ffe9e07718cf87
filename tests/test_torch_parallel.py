"""Ray-batch sharding of the PyTorch port (`optiland_tpu_torch/parallel/`)
against the unsharded port and the JAX package's sharded step, float64 on
the CPU.

The batch is `__graft_entry__.dryrun_multichip`'s: one ray a field and
wavelength of the Cooke triplet, tiled to 16 rays a rank (32). The port
runs it unsharded, on a one-rank gloo mesh in this process, and on two
spawned gloo ranks (`python -m optiland_tpu_torch.parallel.dryrun
--nprocs 2`, which saves each rank's results); JAX runs it on a
("hosts", "chips") = (2, 4) mesh of the 8 virtual CPU devices that
tests/conftest.py forces, with `optax.adam` (whose eps placement is
torch.optim.Adam's). Each case: the fused spot merit's value and
gradients at the primary wavelength, and the flagship training step's
loss, gradients and parameters after one Adam step (lr 1e-4), each
against the unsharded port at rtol 1e-12 (one rank: bit for bit) and
against JAX at rtol 1e-10, elementwise (a gradient entry also passes
within 1e-10 of its leaf's largest). Monte Carlo's draws split over the
two ranks against the unsharded port run (bit for bit) and JAX's run
sharded over its 8 devices (rtol 1e-10). The spawns, the dryrun's
subprocess, JAX's Monte Carlo and JAX's two steps (op by op, each in a
spawned interpreter: `jax_parallel_steps.py`) run at once."""

import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import pytest
import torch

from optiland_tpu import parallel as jpar
from optiland_tpu import tolerancing as jtol
from optiland_tpu.models import CookeTriplet as JCooke
from optiland_tpu_torch import config
from optiland_tpu_torch import parallel as tpar
from optiland_tpu_torch import tolerancing as ttol
from optiland_tpu_torch.models import CookeTriplet as TCooke
from optiland_tpu_torch.optimization.merits import (
    centroid_rms_from_moments,
    centroid_rms_spot,
)
from optiland_tpu_torch.parallel import dryrun
from optiland_tpu_torch.parallel import mesh as tmesh
from optiland_tpu_torch.trace.fused import spot_moments

import jax_parallel_steps
from torch_port_helpers import (
    SMOKE,
    cooke_tolerancing,
    jax_f64,
    monte_carlo_rank,
)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 2
N_RAYS = dryrun.RAYS_PER_DEVICE * RANKS
RTOL_PORT = 1e-12
RTOL_JAX = 1e-10
DRAWS, SEED = 7, 2   # 7 draws pad to 8 on 2 ranks and on JAX's 8 devices


def _dryrun_cli(out):
    proc = subprocess.run(
        [sys.executable, "-m", "optiland_tpu_torch.parallel.dryrun",
         "--nprocs", str(RANKS), "--device", "cpu", "--precision", "float64",
         "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    return proc.returncode, proc.stdout, proc.stderr


def _jax_steps_apart(batch_np):
    """`jax_parallel_steps`' flagship and spot steps, each in a spawned
    interpreter of its own: JAX's op-by-op dispatch is not safe from two
    threads of one process, and needs a GIL of its own to be quick."""
    with ProcessPoolExecutor(2, mp_context=get_context("spawn")) as pool:
        flag = pool.submit(jax_parallel_steps.flagship_step, batch_np,
                           dryrun.ADAM_LR)
        spot = pool.submit(jax_parallel_steps.spot_step, batch_np)
        return flag.result() | spot.result()


def _jax_monte_carlo():
    with jax_f64():
        lens = JCooke()
        df = jtol.MonteCarlo(cooke_tolerancing(jtol, lens),
                             mesh=jpar.make_mesh(8)).run(DRAWS, seed=SEED)
    return list(df.columns), df.to_numpy()


def _port_steps(static, params, batch, mesh=None, rank=0, world=1):
    """The port's flagship step and spot merit on this rank's shard."""
    if mesh is not None:
        batch = tmesh.shard_rays(mesh, batch)
    loss, g, p = dryrun.flagship_step(static, params, batch, mesh)
    wl = params.wavelengths[static.primary_wavelength_idx].item()
    sl, sg = dryrun.spot_step(static, params, batch[:4], wl, mesh)
    return dict(loss=loss, grads=g, params=p, spot_loss=sl, spot_grads=sg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: the unsharded port, the port on a one-rank
    mesh of this process, the 2-rank dryrun, the 2-rank Monte Carlo, the
    unsharded port's Monte Carlo, and JAX's sharded step and Monte
    Carlo."""
    config.set_precision("float64")
    out = tmp_path_factory.mktemp("dryrun") / "ranks.pt"
    static, params = TCooke().build(device="cpu")
    batch = dryrun.dryrun_batch(static, params, N_RAYS)
    batch_np = tuple(a.numpy() for a in batch)
    with ThreadPoolExecutor(4) as pool:
        jax_steps = pool.submit(_jax_steps_apart, batch_np)
        jax_mc = pool.submit(_jax_monte_carlo)
        cli = pool.submit(_dryrun_cli, out)
        mc2 = pool.submit(dryrun.spawn, RANKS, monte_carlo_rank, DRAWS, SEED,
                          device="cpu", precision="float64")
        unsharded = _port_steps(static, params, batch)
        tpar.init_distributed(device="cpu")
        try:
            one = _port_steps(static, params, batch,
                              tpar.make_mesh_2d(1, 1))
            lens = TCooke()
            lens.build(device="cpu")
            df = ttol.MonteCarlo(cooke_tolerancing(ttol, lens)).run(
                DRAWS, seed=SEED)
            mesh1, mesh2 = tpar.make_mesh(), tpar.make_mesh_2d()
            group = dict(world=torch.distributed.get_world_size(),
                         mesh1=mesh1, mesh2=mesh2,
                         reduced_over=[torch.distributed.get_world_size(
                             tmesh.mesh_group(m)) for m in (mesh1, mesh2)],
                         too_many=_raises(lambda: tpar.make_mesh(2)),
                         mc1=ttol.MonteCarlo(cooke_tolerancing(ttol, lens),
                                             mesh=mesh1).run(DRAWS,
                                                             seed=SEED))
        finally:
            torch.distributed.destroy_process_group()
        rc, stdout, stderr = cli.result()
        results = dict(unsharded=unsharded, one=one, cli=(rc, stdout, stderr),
                       mc2=mc2.result(), jax=jax_steps.result(),
                       jax_mc=jax_mc.result(),
                       mc_port=df, group=group,
                       batch=batch)
    assert rc == 0, stderr[-3000:]
    results["two"] = torch.load(out, weights_only=True)
    return results


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_pad_to_multiple():
    assert [tpar.pad_to_multiple(n, 8) for n in (0, 1, 8, 9, 24)] == [
        0, 8, 8, 16, 24]
    assert tpar.pad_to_multiple(7, 2) == jpar.pad_to_multiple(7, 2)


def test_names_match_jax():
    assert tpar.__all__ == jpar.__all__
    assert (tpar.RAY_AXIS, tpar.HOST_AXIS, tpar.CHIP_AXIS) == (
        jpar.RAY_AXIS, jpar.HOST_AXIS, jpar.CHIP_AXIS)


def test_mesh_constructors(runs):
    """One rank of gloo: the 1-D and 2-D meshes, their layouts, and a mesh
    wider than the group refused by name with both counts."""
    from torch.distributed.tensor import Replicate, Shard

    g = runs["group"]
    assert g["world"] == 1
    m1, m2 = g["mesh1"], g["mesh2"]
    assert m1.mesh_dim_names == ("rays",) and m1.size() == 1
    assert m2.mesh_dim_names == ("hosts", "chips") and m2.shape == (1, 1)
    assert m1.device_type == "cpu"
    assert tpar.ray_sharding(m1).placements == (Shard(0),)
    assert tpar.ray_sharding_2d(m2).placements == (Shard(0), Shard(0))
    assert tpar.replicated_sharding(m2) == (m2, (Replicate(), Replicate()))
    assert "2 devices" in g["too_many"] and "1 ranks" in g["too_many"]
    assert g["reduced_over"] == [1, 1]   # every rank of each mesh


class _StubMesh:
    """The two queries `shard_rays` makes of a mesh, for a rank at
    `coord` of a mesh of `shape`."""

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]

    def get_coordinate(self):
        return list(self.coord)


@pytest.mark.parametrize("shape", [(4,), (2, 2), (1, 3)], ids=str)
def test_shard_rays_concatenate_back(shape):
    """Every rank's slices, taken row-major over the mesh, concatenate back
    to each leaf; a count that does not divide is refused."""
    n = 12
    tree = {"a": torch.arange(n), "b": (torch.arange(2 * n).reshape(n, 2),)}
    coords = list(np.ndindex(*shape))
    parts = [tmesh.shard_rays(_StubMesh(shape, c), tree) for c in coords]
    assert torch.equal(torch.cat([p["a"] for p in parts]), tree["a"])
    assert torch.equal(torch.cat([p["b"][0] for p in parts]), tree["b"][0])
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_rays(_StubMesh((5,), (0,)), tree)


def test_no_mesh_changes_nothing(runs):
    """Without a mesh the spot merit is the moments' merit and the
    flagship merit `__graft_entry__.entry`'s, bit for bit."""
    static, params = TCooke().build(device="cpu")
    b = runs["batch"]
    m = spot_moments(static, params, *b[:4], 0.55)
    assert torch.equal(centroid_rms_spot(static, params, *b[:4], 0.55),
                       centroid_rms_from_moments(*m))
    from optiland_tpu_torch.trace.tracer import trace_system

    h = trace_system(static, params, *b)
    x, y, i = h.x[-1], h.y[-1], h.intensity[-1]
    wsum = torch.sum(i) + 1e-12
    cx, cy = torch.sum(x * i) / wsum, torch.sum(y * i) / wsum
    ref = torch.sum(((x - cx) ** 2 + (y - cy) ** 2) * i) / wsum
    assert torch.equal(dryrun.flagship_merit(h), ref)


def _close(got, ref, rtol, label):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    ok = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), ok), label
    scale = np.abs(ref[ok]).max() if ok.any() else 0.0
    np.testing.assert_allclose(got[ok], ref[ok], rtol=rtol,
                               atol=rtol * scale, err_msg=label)


def _ranked(runs, ranks):
    """The port's results on `ranks` ranks (each rank's, all equal)."""
    return [runs["one"]] if ranks == 1 else runs["two"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_spot_merit_matches(runs, ranks):
    ref, jref = runs["unsharded"], runs["jax"]
    for r in _ranked(runs, ranks):
        if ranks == 1:
            assert torch.equal(r["spot_loss"], ref["spot_loss"])
        _close(r["spot_loss"], ref["spot_loss"], RTOL_PORT, "loss")
        _close(r["spot_loss"], jref["spot_loss"], RTOL_JAX, "loss vs JAX")
        for k, g in r["spot_grads"].items():
            if ranks == 1:
                assert torch.equal(g, ref["spot_grads"][k]), k
            _close(g, ref["spot_grads"][k], RTOL_PORT, k)
            _close(g, jref["spot_grads"][k], RTOL_JAX, f"{k} vs JAX")
        assert max(g.abs().max() for g in r["spot_grads"].values()) > 0


@pytest.mark.parametrize("ranks", [1, 2])
def test_flagship_step_matches(runs, ranks):
    """Loss, every gradient and the parameters after one Adam step."""
    ref, jref = runs["unsharded"], runs["jax"]
    for r in _ranked(runs, ranks):
        _close(r["loss"], ref["loss"], RTOL_PORT, "loss")
        _close(r["loss"], jref["loss"], RTOL_JAX, "loss vs JAX")
        for part in ("grads", "params"):
            for k, v in r[part].items():
                if ranks == 1:
                    assert torch.equal(v, ref[part][k]), (part, k)
                _close(v, ref[part][k], RTOL_PORT, f"{part} {k}")
                _close(v, jref[part][k], RTOL_JAX, f"{part} {k} vs JAX")
        assert r["grads"]["cv"].abs().max() > 0


def test_two_ranks_split_the_batch(runs):
    two = runs["two"]
    assert [r["rank"] for r in two] == [0, 1]
    assert all(r["world"] == RANKS and r["rays"] == N_RAYS // RANKS
               for r in two)
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k


def test_monte_carlo_mesh_matches(runs):
    """MonteCarlo(mesh=) over 2 ranks, and over a one-rank mesh, is the
    unsharded port run bit for bit, and JAX's run sharded over 8 devices
    within 1e-10."""
    df = runs["mc_port"]
    cols, jvals = runs["jax_mc"]
    assert list(df.columns) == cols
    np.testing.assert_array_equal(runs["group"]["mc1"].to_numpy(),
                                  df.to_numpy())
    for r in runs["mc2"]:
        assert r["columns"] == cols
        np.testing.assert_array_equal(r["values"].numpy(), df.to_numpy())
    np.testing.assert_allclose(df.to_numpy(), jvals, rtol=RTOL_JAX, atol=0)


def test_dryrun_cli_exits_zero(runs):
    rc, stdout, _ = runs["cli"]
    assert rc == 0 and "dryrun_multichip OK: 2 devices (cpu)" in stdout


# chip_smoke.py phase j11's check of a sharded float32 step's gradients, on
# one leaf whose two ranks' parts cancel (each ~5x the whole): (error
# against the whole, the unsharded float32 step's own error against
# float64 on the leaf, the gradient passes, its limit sees a lost rank)
_WHOLE = torch.tensor([1.0, -0.5, 0.25], dtype=torch.float64)
_PART0 = torch.tensor([5.0, 2.0, -1.0], dtype=torch.float64)
_LIMIT_CASES = {
    "rounding past TOL, within the limit": (2e-4, 4e-5, True, True),
    "one rank's part lost": ("lost", 4e-5, False, True),
    "the mesh size left in": ("W", 4e-5, False, True),
    "noise too large to see a lost rank": (2e-4, 0.3, True, False),
}


@pytest.mark.parametrize("case", list(_LIMIT_CASES))
def test_j11_grad_limits(case):
    """Each gradient within its limit, and the limit below the error of a
    reduction that lost a rank (phase j11 (b) checks both): a reduction
    that lost a rank's part, or kept the factor W, misses the limit; a
    leaf whose float32 noise would hide a lost rank fails the second."""
    err, noise, passes, sees = _LIMIT_CASES[case]
    parts = [_PART0, _WHOLE - _PART0]
    if err == "lost":
        got = parts[0].clone()
    elif err == "W":
        got = 2 * _WHOLE
    else:
        got = _WHOLE + err * _WHOLE.abs().max()
    errs = {"k": SMOKE.rel_err(got, _WHOLE)}
    limits, amp, lost = SMOKE.j11_grad_limits(
        errs, {"k": noise}, {"k": _WHOLE}, [{"k": p} for p in parts],
        {"k": got})
    assert amp["k"] == pytest.approx(5.0)
    assert limits["k"] >= SMOKE.TOL["param_grad_rel"]
    assert (errs["k"] <= limits["k"]) == passes
    assert (lost["k"] > limits["k"]) == sees
