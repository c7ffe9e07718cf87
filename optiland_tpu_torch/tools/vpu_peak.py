"""The card's achieved FP32 FMA, rsqrt and tan rates: the port of
tools/vpu_peak.py.

    python -m optiland_tpu_torch.tools.vpu_peak

prints, as the JAX tool does, `fma_per_s`, `fma_tflops_f32`, `rsqrt_per_s`
and `tan_per_s`, and beside them `device`: the card's name and power limit
as `nvidia-smi --query-gpu=name,power.limit` gives them. It runs on the
CUDA card only and fails without one.

T1, the three Pallas kernels of `tools/vpu_peak.py` (`fma_kernel`,
`sqrt_kernel`, `tan_kernel` under its `run`), are hand-written CUDA
kernels here (csrc/vpu_peak.cu), one element per thread over T1's input:
(N_TILES * ROWS, LANE) float32 drawn uniform in [1, 2) with
`np.random.default_rng(0)`. `fma_chain`, `rsqrt_chain` and `tan_chain`
launch them on a CUDA tensor and take `fma_plain`, `rsqrt_plain` and
`tan_plain`, their plain versions, only for a tensor on the CPU.

What the rates mean (T1's arithmetic is kept as it is; `run` times T1's
step counts, and the wrappers take fewer steps only so that the kernels can
be held to their plain versions before the chains settle):
  - the FMA chain, acc = acc * x + 0.003 over 512 steps, is a degree-512
    polynomial: `fma_tflops_f32` is the FP32 rate the card reaches on
    dependent FMAs, to set beside the data sheet's 67 TFLOP/s;
  - the rsqrt chain, acc = rsqrt(acc + 1.5), converges to its fixed point
    (0.67765 for every element) within a few steps, so it measures the
    rsqrt instruction at one argument;
  - the tan chain, acc = tan(acc * 0.001), reaches float32's subnormals
    after about 13 steps and 0 soon after, so `tan_per_s` measures tanf at
    tiny arguments, its fast path: it does not bound the cost of a sincosf
    at the 1e2 to 1e5 rad of the Huygens sum's phases.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
from functools import lru_cache

import numpy as np
import torch

from optiland_tpu_torch import config

ROWS, LANE = 256, 128
N_TILES = 64
K_FMA = 512      # FMAs per element per pass
K_TRANS = 64     # transcendentals per element per pass
# the least span of back-to-back launches one timing covers: a single FMA
# launch is ~32 us at the data sheet's rate, so fewer launches would time
# the launch overhead
WINDOW_MS = 20.0


def peak_input(device=None) -> torch.Tensor:
    """T1's input: (N_TILES * ROWS, LANE) float32, uniform in [1, 2), from
    `np.random.default_rng(0)`."""
    x = np.random.default_rng(0).uniform(
        1.0, 2.0, (N_TILES * ROWS, LANE)).astype(np.float32)
    return torch.from_numpy(x).to(config.resolve_device(device))


def fma_plain(x: torch.Tensor, steps: int = K_FMA) -> torch.Tensor:
    """`fma_kernel`: acc = acc * v + 0.003, `steps` times (T1's K_FMA),
    from v = x * 0.51."""
    v = x * 0.51
    acc = v
    for _ in range(steps):
        acc = acc * v + 0.003
    return acc


def rsqrt_plain(x: torch.Tensor, steps: int = K_TRANS) -> torch.Tensor:
    """`sqrt_kernel`: acc = rsqrt(acc + 1.5), `steps` times (T1's
    K_TRANS)."""
    acc = x
    for _ in range(steps):
        acc = torch.rsqrt(acc + 1.5)
    return acc


def tan_plain(x: torch.Tensor, steps: int = K_TRANS) -> torch.Tensor:
    """`tan_kernel`: acc = tan(acc * 0.001), `steps` times (T1's
    K_TRANS)."""
    acc = x
    for _ in range(steps):
        acc = torch.tan(acc * 0.001)
    return acc


@lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point `name` of csrc/vpu_peak.cu, built on first use."""
    from optiland_tpu_torch import _build

    fn = getattr(_build.library("vpu_peak"), name)
    # n, steps, x, out, stream
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, x: torch.Tensor, out: torch.Tensor, steps: int) -> None:
    """One launch of `wrapper`'s kernel of `steps` steps from x into out
    (float32, contiguous, on one CUDA device, of one size); counts it on the
    wrapper."""
    for a in (x, out):
        if a.device.type != "cuda" or a.dtype != torch.float32:
            raise ValueError(f"{wrapper.__name__} takes float32 CUDA tensors, "
                             f"got {a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: expected contiguous "
                             "tensors")
    if x.device != out.device or x.numel() != out.numel():
        raise ValueError(f"{wrapper.__name__}: x and out differ in device or "
                         "size")
    if x.numel():
        err = _kernel(wrapper.__name__)(
            x.numel(), steps, x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{wrapper.__name__} launch failed: "
                               f"cudaError {err}")
        wrapper.launches += 1


def _chain(wrapper, plain, x: torch.Tensor, steps: int) -> torch.Tensor:
    if steps < 0:
        raise ValueError(f"{wrapper.__name__}: steps must be >= 0, got "
                         f"{steps}")
    if x.device.type == "cpu":
        return plain(x, steps)
    out = torch.empty_like(x)
    _launch(wrapper, x, out, steps)
    return out


def fma_chain(x: torch.Tensor, steps: int = K_FMA) -> torch.Tensor:
    """T1's FMA chain of `steps` steps on every element of x (`fma_plain`
    on the CPU)."""
    return _chain(fma_chain, fma_plain, x, steps)


fma_chain.launches = 0


def rsqrt_chain(x: torch.Tensor, steps: int = K_TRANS) -> torch.Tensor:
    """T1's rsqrt chain of `steps` steps on every element of x
    (`rsqrt_plain` on the CPU)."""
    return _chain(rsqrt_chain, rsqrt_plain, x, steps)


rsqrt_chain.launches = 0


def tan_chain(x: torch.Tensor, steps: int = K_TRANS) -> torch.Tensor:
    """T1's tan chain of `steps` steps on every element of x (`tan_plain`
    on the CPU)."""
    return _chain(tan_chain, tan_plain, x, steps)


tan_chain.launches = 0

# name: (wrapper, steps an element)
CHAINS = {"fma": (fma_chain, K_FMA), "rsqrt": (rsqrt_chain, K_TRANS),
          "tan": (tan_chain, K_TRANS)}


def run(name: str, device=None):
    """(steps per second, seconds per launch) of chain `name` ("fma",
    "rsqrt" or "tan") on T1's input on the card: CUDA events around
    back-to-back launches spanning at least WINDOW_MS, after a warm-up.
    Takes a CUDA device only (`None` is the card) and raises without one."""
    dev = config.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("run times the CUDA kernels; it takes no CPU device")
    wrapper, steps = CHAINS[name]
    x = peak_input(dev)
    out = torch.empty_like(x)
    for _ in range(3):
        _launch(wrapper, x, out, steps)
    calls = 10
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            _launch(wrapper, x, out, steps)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms >= WINDOW_MS:
            break
        calls = math.ceil(calls * 1.25 * WINDOW_MS / max(ms, 1e-3))
    dt = ms * 1e-3 / calls
    return x.numel() * steps / dt, dt


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def main():
    res = {}
    ops, _ = run("fma")
    res["fma_per_s"] = ops
    res["fma_tflops_f32"] = ops * 2 / 1e12
    res["rsqrt_per_s"], _ = run("rsqrt")
    res["tan_per_s"], _ = run("tan")
    res["device"] = card()
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
