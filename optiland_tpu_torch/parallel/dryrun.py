"""The sharded training step on N ranks: the port of
`__graft_entry__.dryrun_multichip`.

    python -m optiland_tpu_torch.parallel.dryrun --nprocs N
        [--device cuda|cpu] [--precision float32|float64] [--out FILE]

spawns N ranks (`torch.multiprocessing`, spawn), which meet at a
`file://` rendezvous in a temporary directory (no port to collide on).
Each builds the flagship Cooke triplet on its device, makes the batch of
`make_inputs` (JAX's `_make_inputs`: one ray a field and wavelength,
tiled to 16 N rays), takes its contiguous shard on a `("hosts",
"chips")` mesh (2 x N/2 when N is even and above 1, else 1 x N, as JAX
factors it) and runs JAX's two phases with their checks:

  1. the flagship training step (`flagship_step`): the RMS spot merit of
     `trace_system`'s history (K7 on the card in float32, its backward
     the eager twin), with the weighted sums and then the spread about
     the centroid each summed over the mesh (JAX's two passes), the
     gradients averaged over the mesh, one Adam step (lr 1e-4) over every
     parameter leaf;
  2. the fused spot merit's value and gradient at the primary wavelength
     (`spot_step`: `centroid_rms_spot(..., mesh=)`, K1 on the shard, the
     four moments summed, K2 on the shard).

On the card rank r takes cuda:(r mod the card count). NCCL takes one
rank per card, so more ranks than cards run gloo with CUDA tensors (a
rehearsal of a multi-card run on one card). The parent builds the
kernels of the system before the ranks start, so that no two ranks build
one library. `--out` saves each rank's loss, gradients, stepped
parameters and kernel launches (`torch.save`, a list by rank).
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time
from dataclasses import fields
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from optiland_tpu_torch import config
from optiland_tpu_torch.parallel.mesh import (
    average_gradients,
    init_distributed,
    make_mesh_2d,
    shard_rays,
)

ADAM_LR = 1e-4
RAYS_PER_DEVICE = 16   # JAX's dryrun: 16 rays a device, tiled


def make_inputs(static, params, rays_per_field: int):
    """(Hx, Hy, Px, Py, w) numpy batches over fields x wavelengths x pupil
    (`__graft_entry__._make_inputs`: seed 0, a uniform disc pupil)."""
    rng = np.random.default_rng(0)
    F, W, n = static.num_fields, static.num_wavelengths, rays_per_field
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    Px, Py = r * np.cos(th), r * np.sin(th)
    xf = params.x_fields.double().cpu().numpy()
    yf = params.y_fields.double().cpu().numpy()
    m = max(float(np.max(np.hypot(xf, yf))), 1e-12)
    Hx = np.repeat(np.tile(xf / m, W), n)
    Hy = np.repeat(np.tile(yf / m, W), n)
    w = np.repeat(np.repeat(params.wavelengths.double().cpu().numpy(), F), n)
    return Hx, Hy, np.tile(Px, F * W), np.tile(Py, F * W), w


def dryrun_batch(static, params, n: int, rays_per_field: int = 1):
    """`make_inputs` tiled to n rays (JAX's dryrun tiles its one-ray-a-field
    batch), as tensors on the device and in the dtype of `params`."""
    batch = make_inputs(static, params, rays_per_field)
    reps = -(-n // len(batch[0]))
    return tuple(torch.as_tensor(np.tile(a, reps)[:n], dtype=params.cv.dtype,
                                 device=params.cv.device) for a in batch)


def flagship_merit(hist, mesh=None):
    """`__graft_entry__.entry`'s merit, the intensity-weighted RMS spot
    about the centroid on the image row of the history. With a `mesh`
    the history is this rank's shard: the weighted sums (sum i, sum x i,
    sum y i) are summed over the mesh for the centroid, and then the
    spread about it, sum ((x - cx)^2 + (y - cy)^2) i (JAX's two passes;
    a one-pass moment form cancels in float32)."""
    from optiland_tpu_torch.parallel.mesh import all_sum

    x, y, i = hist.x[-1], hist.y[-1], hist.intensity[-1]
    s = torch.stack([torch.sum(i), torch.sum(x * i), torch.sum(y * i)])
    if mesh is not None:
        s = all_sum(mesh, s)
    wsum = s[0] + 1e-12
    cx = s[1] / wsum
    cy = s[2] / wsum
    spread = torch.sum(((x - cx) ** 2 + (y - cy) ** 2) * i)
    if mesh is not None:
        spread = all_sum(mesh, spread)
    return spread / wsum


def leaves_of(params, names=None):
    """({name: a fresh leaf that requires grad}, params with them in) for
    `names`, by default every parameter tensor that is not empty."""
    if names is None:
        names = [f.name for f in fields(params)
                 if getattr(params, f.name) is not None
                 and getattr(params, f.name).numel()]
    leaves = {k: getattr(params, k).detach().clone().requires_grad_(True)
              for k in names}
    return leaves, params.replace(**leaves)


def _grads(leaves):
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).detach()
            for k, v in leaves.items()}


def flagship_step(static, params, batch, mesh=None, lr: float = ADAM_LR):
    """One training step of the flagship merit over every parameter leaf:
    (loss, {leaf: gradient}, {leaf: value after one Adam step}). With a
    `mesh` the batch is this rank's shard and the gradients are averaged
    over the mesh before the step (`average_gradients`)."""
    from optiland_tpu_torch.trace.tracer import trace_system

    leaves, p = leaves_of(params)
    loss = flagship_merit(trace_system(static, p, *batch), mesh)
    loss.backward()
    if mesh is not None:
        average_gradients(mesh, leaves.values())
    grads = _grads(leaves)
    opt = torch.optim.Adam(list(leaves.values()), lr=lr)
    opt.step()
    return loss.detach(), grads, {k: v.detach() for k, v in leaves.items()}


def spot_step(static, params, batch4, wavelength, mesh=None):
    """`centroid_rms_spot` at `wavelength` and its gradient over every
    parameter leaf, params only (K1 and K2 on the card in float32):
    (loss, {leaf: gradient}), averaged over the mesh when there is one."""
    from optiland_tpu_torch.optimization.merits import centroid_rms_spot

    leaves, p = leaves_of(params)
    loss = centroid_rms_spot(static, p, *batch4, wavelength,
                             diff_inputs=False, mesh=mesh)
    loss.backward()
    if mesh is not None:
        average_gradients(mesh, leaves.values())
    return loss.detach(), _grads(leaves)


def launch_counters():
    """The launch counters of the kernels on this path: K1, K2 and K7."""
    from optiland_tpu_torch.trace import fused

    return {"K1": fused.moments_forward, "K2": fused.moments_backward,
            "K7": fused.history_forward}


def _clock(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _counted(dev, fn):
    """fn() with every counter at 0 just before; (result, launches,
    host-clock seconds)."""
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    t0 = _clock(dev)
    out = fn()
    seconds = _clock(dev) - t0
    return out, {k: f.launches for k, f in counters.items()}, seconds


def step_times(dev, flag, spot, steps: int):
    """Median host-clock ms of `steps` more calls of each step (`flag`,
    `spot`: callables), and on the card the median CUDA-event span of each
    of their kernels' launches over `steps` calls more
    (`tools.kernel_turns.timed_launches`: the span holds the kernel alone):
    {"flagship", "spot", "K7", "K1", "K2"}."""
    ms = {key: float(np.median([1e3 * _counted(dev, fn)[2]
                                for _ in range(steps)]))
          for key, fn in (("flagship", flag), ("spot", spot))}
    if dev.type != "cuda":
        return ms
    from optiland_tpu_torch.tools import kernel_turns
    from optiland_tpu_torch.trace import fused

    spans, restore = kernel_turns.timed_launches(fused)
    try:
        for fn, names in ((flag, ("K7",)), (spot, ("K1", "K2"))):
            spans.clear()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize(dev)
            check(len(spans) == steps * len(names),
                  f"{len(spans)} launches in {steps} steps of {names}")
            for j, name in enumerate(names):
                ms[name] = float(np.median([a.elapsed_time(b) for a, b
                                            in spans[j::len(names)]]))
    finally:
        restore()
    return ms


def _cpu(tree):
    return {k: v.cpu() for k, v in tree.items()}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun check failed: {msg}")


def dryrun_mesh():
    """The ("hosts", "chips") mesh of every rank of the group, as JAX's
    dryrun factors it: 2 x N/2 when N is even and above 1, else 1 x N."""
    world = dist.get_world_size()
    n_hosts = 2 if world % 2 == 0 and world > 1 else 1
    return make_mesh_2d(n_hosts, world // n_hosts)


def sharded_steps(dev, n_rays: int | None = None, rays_per_field: int = 1,
                  timed_steps: int = 0):
    """One rank's part of the dryrun: the flagship Cooke triplet on `dev`,
    the batch of `dryrun_batch` (n_rays, by default 16 a rank), this
    rank's shard on the ("hosts", "chips") mesh, the flagship training
    step and the spot merit, each checked as JAX's dryrun checks them;
    with `timed_steps`, `step_times` of that many more steps. Returns the
    rank's results on the CPU."""
    from optiland_tpu_torch.models import CookeTriplet

    world = dist.get_world_size()
    mesh = dryrun_mesh()
    static, params = CookeTriplet().build(device=dev)
    n = RAYS_PER_DEVICE * world if n_rays is None else n_rays
    batch = shard_rays(mesh, dryrun_batch(static, params, n, rays_per_field))
    (loss, grads, stepped), k_flag, s_flag = _counted(
        dev, lambda: flagship_step(static, params, batch, mesh))
    check(math.isfinite(loss.item()), f"non-finite loss {loss.item()}")
    moved = max(((stepped[k] - getattr(params, k))[
        torch.isfinite(getattr(params, k))].abs().max().item()
        if torch.isfinite(getattr(params, k)).any() else 0.0)
        for k in stepped)
    check(moved > 0, "the training step did not update the parameters")
    wl = params.wavelengths[static.primary_wavelength_idx].item()
    (spot_loss, spot_grads), k_spot, s_spot = _counted(
        dev, lambda: spot_step(static, params, batch[:4], wl, mesh))
    check(math.isfinite(spot_loss.item()),
          f"non-finite spot-merit loss {spot_loss.item()}")
    gmax = max(g[torch.isfinite(g)].abs().max().item() if g.numel() else 0.0
               for g in spot_grads.values())
    check(gmax > 0, "the spot-moments merit produced zero gradients")
    ms = step_times(dev, lambda: flagship_step(static, params, batch, mesh),
                    lambda: spot_step(static, params, batch[:4], wl, mesh),
                    timed_steps) if timed_steps else {}
    return dict(rank=dist.get_rank(), world=world, device=str(dev),
                rays=batch[0].shape[0], loss=loss.cpu(), grads=_cpu(grads),
                params=_cpu(stepped), max_param_delta=moved,
                spot_loss=spot_loss.cpu(), spot_grads=_cpu(spot_grads),
                spot_grad_max=gmax, wavelength=wl,
                launches={"flagship": k_flag, "spot": k_spot},
                seconds={"flagship": s_flag, "spot": s_spot}, ms=ms)


def _rank_main(rank, nprocs, tmp, device_type, backend, precision, fn,
               args):
    """A spawned rank: its device, the process group at the rendezvous in
    `tmp`, fn(device, *args), its result saved for the parent."""
    config.set_precision(precision)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:   # the ranks are the CPU's parallelism: one thread each
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    init_distributed(f"file://{tmp}/rendezvous", nprocs, rank, device=dev,
                     backend=backend)
    try:
        torch.save(fn(dev, *args), Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(nprocs: int, fn, *args, device=None, precision: str = "float32"):
    """fn(device, *args) on `nprocs` spawned ranks of one process group;
    returns their results by rank. `fn` must be importable by name (the
    ranks are fresh interpreters) and return tensors, numbers, strings
    and containers of them. `device`: None for the card (NCCL when every
    rank has its own card, else gloo), "cpu" for gloo on the CPU."""
    dev = config.resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and nprocs <= torch.cuda.device_count() else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(nprocs, tmp, dev.type, backend, precision, fn,
                              args),
            nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True)
                for r in range(nprocs)]


def prebuild(static) -> None:
    """Build the kernels of `static`'s path on the card (K1's and K7's
    variants, K2), so that spawned ranks load them and never race to
    build one."""
    from optiland_tpu_torch import _build
    from optiland_tpu_torch.trace import fused

    bwd = fused.backward_defines(static, False)
    _build.build_all((("moments_fwd", fused.system_defines(static)),
                      ("history_fwd", fused.history_defines(static)))
                     + ((("moments_bwd", bwd),) if bwd else ()))


def dryrun_multichip(n_devices: int, device=None, precision="float32"):
    """The sharded training step on `n_devices` spawned ranks (module
    docstring); returns each rank's results and prints JAX's summary."""
    from optiland_tpu_torch.models import CookeTriplet

    dev = config.resolve_device(device)
    if dev.type == "cuda":
        prebuild(CookeTriplet().build(device="cpu")[0])
    results = spawn(n_devices, sharded_steps, device=dev,
                    precision=precision)
    r0 = results[0]
    print(f"dryrun_multichip OK: {n_devices} devices ({dev.type}), "
          f"loss={r0['loss'].item():.6g}, max param delta="
          f"{max(r['max_param_delta'] for r in results):.3g}, spot-merit "
          f"loss={r0['spot_loss'].item():.6g} (grad max "
          f"{r0['spot_grad_max']:.3g}); launches by rank "
          f"{[r['launches'] for r in results]}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--precision", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--out", default=None,
                    help="torch.save each rank's results here")
    a = ap.parse_args(argv)
    results = dryrun_multichip(a.nprocs, a.device, a.precision)
    if a.out:
        torch.save(results, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
