"""Checkpointing for long-running optimization and Monte-Carlo jobs.

Port of `optiland_tpu/utils/checkpoint.py`. Each checkpoint is one file,
`directory/step_<step>` (eight digits), written by `torch.save` of a state
dict whose values are tensors, numpy arrays, numbers, strings, and lists,
tuples or dicts of them: {"step", "x", "opt_state", ...}. Numpy arrays
travel as tensors beside a marker and come back as numpy arrays, so
`restore_checkpoint` loads with `weights_only=True`. The port reads its own
files only, not the JAX package's orbax directories. A pseudo-random
state is a `torch.Generator`'s (`prng_to_state`, `state_to_prng`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

_NUMPY = "__numpy__"


def _pack(obj):
    """Numpy arrays as {_NUMPY: tensor}, tensors on the CPU, recursively."""
    if isinstance(obj, np.ndarray):
        return {_NUMPY: torch.from_numpy(np.ascontiguousarray(obj))}
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj):
    if isinstance(obj, dict):
        if set(obj) == {_NUMPY}:
            return obj[_NUMPY].numpy()
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v) for v in obj)
    return obj


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Write `state` under `directory/step_<step>`; returns the path. The
    file is written beside its final name and renamed into place, so an
    interrupted save leaves the previous checkpoints as they were."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".step_{step:08d}.{os.getpid()}.tmp")
    torch.save(_pack(state), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> str | None:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(directory_or_path: str, template=None):
    """Restore the newest checkpoint in a directory (or an exact path).
    Returns None when nothing is saved yet. `template` is accepted for the
    JAX package's signature and not needed: the file keeps its own
    structure and dtypes."""
    del template
    path = directory_or_path
    if not os.path.basename(path).startswith("step_"):
        path = latest_checkpoint(path)
        if path is None:
            return None
    return _unpack(torch.load(path, map_location="cpu", weights_only=True))


def checkpoint_step(path_or_dir: str) -> int:
    """Step number encoded in a checkpoint path."""
    base = os.path.basename(path_or_dir)
    return int(base.split("_")[1]) if base.startswith("step_") else -1


def prng_to_state(generator: torch.Generator) -> np.ndarray:
    """A generator's state as its raw bytes (uint8)."""
    return generator.get_state().numpy().copy()


def state_to_prng(data, device="cpu") -> torch.Generator:
    """A generator on `device` in the state `prng_to_state` returned."""
    g = torch.Generator(device=device)
    g.set_state(torch.as_tensor(np.asarray(data, dtype=np.uint8)))
    return g
