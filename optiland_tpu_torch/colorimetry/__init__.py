"""Colorimetry: spectrum -> CIE XYZ -> xyY / sRGB.

Port of `optiland_tpu/colorimetry/__init__.py` (CIE 15:2004). The CIE
observer and illuminant tables are read in place from the JAX package's
`data/cie_data.json`; the integration runs on the device and in the dtype
of the spectrum, so a transmission spectrum straight out of the thin-film
TMM converts where it was computed.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.materials.dispersion import _interp

_DATA = (Path(__file__).resolve().parents[2] / "optiland_tpu" / "data"
         / "cie_data.json")


@lru_cache(maxsize=1)
def _tables():
    with open(_DATA) as f:
        d = json.load(f)
    return {
        "wl": np.asarray(d["wavelengths_nm"]),
        "2deg": np.asarray(d["cie_1931_2deg"]),
        "10deg": np.asarray(d["cie_1964_10deg"]),
        "d65": np.asarray(d["illuminant_d65"]),
    }


def _place(values, device):
    """(dtype, device) of a computation on `values`: a tensor's own, else
    the precision policy's dtype on `device` (None: the CUDA card)."""
    if torch.is_tensor(values):
        dt = values.dtype if values.is_floating_point() else config.get_dtype()
        return dt, values.device
    return config.get_dtype(), config.resolve_device(device)


def spectrum_to_xyz(wavelengths_nm, values, illuminant=None,
                    observer: str = "2deg", device=None):
    """CIE tristimulus values of a reflectance/transmittance spectrum,
    normalized so a perfect white gives Y = 100; on the device of `values`
    when it is a tensor, else on `device` (None: the CUDA card)."""
    t = _tables()
    std_wl = t["wl"]
    dt, dev = _place(values, device)

    def tensor(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    wl = tensor(wavelengths_nm)
    lo, hi = float(torch.min(wl)), float(torch.max(wl))
    if lo > std_wl[0] or hi < std_wl[-1]:
        raise ValueError(
            f"Input spectrum range ({lo:.1f}-{hi:.1f} nm) does not cover the "
            f"required visible range ({std_wl[0]:.0f}-{std_wl[-1]:.0f} nm)."
        )

    cmf = tensor(t[observer if observer in ("2deg", "10deg") else "2deg"])
    S = tensor(t["d65"] if illuminant is None else illuminant)
    r = _interp(tensor(std_wl), wl, tensor(values))
    d_lambda = float(std_wl[1] - std_wl[0])
    X = torch.sum(r * S * cmf[:, 0]) * d_lambda
    Y = torch.sum(r * S * cmf[:, 1]) * d_lambda
    Z = torch.sum(r * S * cmf[:, 2]) * d_lambda
    k = 100.0 / (torch.sum(S * cmf[:, 1]) * d_lambda)
    return X * k, Y * k, Z * k


def _stack(X, Y, Z):
    """(X, Y, Z) as one tensor, on the device and in the dtype of the first
    tensor among them; numbers alone go to the precision policy's dtype on
    the CUDA card."""
    ref = next((v for v in (X, Y, Z) if torch.is_tensor(v)), None)
    dt = ref.dtype if ref is not None else config.get_dtype()
    dev = ref.device if ref is not None else config.resolve_device(None)
    return torch.stack([torch.as_tensor(v, dtype=dt, device=dev)
                        for v in (X, Y, Z)])


def xyz_to_xyY(X, Y, Z):
    s = X + Y + Z
    s = torch.where(s == 0, 1.0, s) if torch.is_tensor(s) else (s or 1.0)
    return X / s, Y / s, Y


_M_SRGB = ((3.2406, -1.5372, -0.4986),
           (-0.9689, 1.8758, 0.0415),
           (0.0557, -0.2040, 1.0570))


def xyz_to_srgb(X, Y, Z, normalize: bool = True):
    """Linear XYZ (Y in [0, 100]) -> gamma-corrected sRGB in [0, 1]
    (reference `colorimetry/core.py:202-251`)."""
    xyz = _stack(X, Y, Z) / 100.0
    rgb = torch.tensor(_M_SRGB, dtype=xyz.dtype, device=xyz.device) @ xyz
    rgb = torch.where(
        rgb <= 0.0031308, 12.92 * rgb,
        1.055 * torch.clamp(rgb, min=1e-12) ** (1.0 / 2.4) - 0.055,
    )
    rgb = torch.clip(rgb, 0.0, 1.0)
    if normalize:
        m = torch.amax(rgb)
        rgb = torch.where(m > 0, rgb / torch.clamp(m, min=1e-12), rgb)
    return rgb[0], rgb[1], rgb[2]
