"""Global numeric policy and device selection for optiland_tpu_torch.

Precision:
  - "float64": parity mode, used by the CPU tests against the JAX package.
  - "float32": the kernels' dtype (the CUDA chain runs in f32 only).

Device: entry points run on the CUDA card unless the caller passes
`device="cpu"`. `resolve_device` is the one place that turns the user's
choice into a `torch.device` and refuses "cuda" when no card is present.
"""

from __future__ import annotations

from functools import lru_cache

import torch

_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
}

_dtype = torch.float64


def set_precision(precision: str) -> None:
    """Set the default floating dtype used when building system parameters."""
    global _dtype
    try:
        _dtype = _DTYPES[precision]
    except KeyError:
        raise ValueError(
            f"Unknown precision {precision!r}; expected one of {sorted(_DTYPES)}"
        ) from None


def get_dtype():
    """Return the current default floating dtype."""
    return _dtype


def complex_dtype():
    """The complex dtype of the precision policy: complex128 under float64,
    complex64 under float32 (CUDA has both, so nothing drops to
    complex64 as it must on a TPU)."""
    return torch.complex128 if _dtype == torch.float64 else torch.complex64


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card. Raises RuntimeError when CUDA is asked
    for and no card is present, so a missing card never silently turns
    into a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to build on the CPU")
    return dev


@lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The number of SMs of the CUDA card `device`, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def l2_bytes(device: torch.device) -> int:
    """The L2 cache of the CUDA card `device`, in bytes."""
    return torch.cuda.get_device_properties(device).L2_cache_size
