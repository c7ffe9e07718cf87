"""Thin-film stack: a layer list and its spectra.

Port of `optiland_tpu/thin_film/stack.py`: `add_layer`, `add_layer_nm`,
`add_layer_qwot`, R/T/A spectra for 's', 'p' and 'u' (unpolarized),
insert/remove/split for needle synthesis, and the Jones matrices of a
thin-film coating at per-ray AOI and wavelength. Materials are the port's
`MaterialSpec`s (or numbers), resolved through the same catalog as lens
materials; a layer's thickness may be a tensor, and stays differentiable.

Spectra are evaluated on the device and in the dtype of the wavelength
tensor they are given; a wavelength given as numbers goes to `device`
(None: the CUDA card) in the precision policy's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.materials.catalog import resolve_material
from optiland_tpu_torch.materials.dispersion import (
    _interp,
    material_extinction,
    material_index,
)
from optiland_tpu_torch.polarization.jones import _assemble
from optiland_tpu_torch.polarization.prt import complex_of
from optiland_tpu_torch.thin_film.core import tmm_coh


def _as_real(a, device=None, like=None):
    """`a` as a real tensor: on `like`'s device and dtype where `like` is
    given, on its own where `a` is a tensor, else on `device` (None: the
    CUDA card) in the policy's dtype."""
    if like is not None:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(a, dtype=config.get_dtype(),
                           device=config.resolve_device(device))


def n_complex(m, w):
    """The complex index n + i k of material `m` at the wavelengths `w`
    (um): k from the material's tabulated extinction where it has one."""
    coeffs = torch.as_tensor(m.coefficients, dtype=w.dtype, device=w.device)
    n = material_index(m.formula, m.n_coeffs, coeffs, w)
    if m.k_table is not None:
        k = _interp(w, *(torch.as_tensor(t, dtype=w.dtype, device=w.device)
                         for t in m.k_table))
    else:
        k = material_extinction(m.formula, m.n_coeffs, coeffs, w)
    return torch.complex(n + 0.0 * w, k + 0.0 * w)


@dataclass(frozen=True)
class Layer:
    material: object  # MaterialSpec
    thickness_um: object  # a number or a 0-d tensor (differentiable)

    def n_complex(self, wavelength_um):
        return n_complex(self.material, wavelength_um)


class ThinFilmStack:
    """Ordered coating layers between an incident and a substrate
    medium."""

    def __init__(self, incident_material="air", substrate_material="air"):
        self.incident_material = resolve_material(incident_material)
        self.substrate_material = resolve_material(substrate_material)
        self.layers: list[Layer] = []

    def __len__(self):
        return len(self.layers)

    # -- construction ---------------------------------------------------
    def add_layer(self, material, thickness_um):
        self.layers.append(Layer(resolve_material(material), thickness_um))
        return self

    def add_layer_nm(self, material, thickness_nm: float):
        return self.add_layer(material, thickness_nm * 1e-3)

    def add_layer_qwot(self, material, wavelength_um: float,
                       qwot: float = 1.0):
        """Quarter-wave optical thickness layer at `wavelength_um`."""
        m = resolve_material(material)
        w = torch.tensor(wavelength_um, dtype=torch.float64)
        n = float(material_index(m.formula, m.n_coeffs, torch.tensor(
            m.coefficients, dtype=torch.float64), w))
        return self.add_layer(m, qwot * wavelength_um / (4.0 * n))

    def insert_layer(self, index: int, material, thickness_um):
        self.layers.insert(index, Layer(resolve_material(material),
                                        thickness_um))
        return self

    def remove_layer(self, index: int) -> Layer:
        return self.layers.pop(index)

    def split_layer(self, layer_index: int, position_fraction: float):
        """Split a layer in two (needle-synthesis helper)."""
        lay = self.layers[layer_index]
        t1 = lay.thickness_um * position_fraction
        t2 = lay.thickness_um - t1
        self.layers[layer_index] = replace(lay, thickness_um=t1)
        self.layers.insert(layer_index + 1, replace(lay, thickness_um=t2))
        return self

    def copy(self) -> "ThinFilmStack":
        new = ThinFilmStack(self.incident_material, self.substrate_material)
        new.layers = list(self.layers)
        return new

    # -- spectra --------------------------------------------------------
    def _indices(self, w):
        return (n_complex(self.incident_material, w),
                n_complex(self.substrate_material, w))

    def compute_rtRTA(self, wavelength_um, aoi_rad=0.0, pol: str = "s",
                      device=None):
        """(r, t, R, T, A) over a wavelength/AOI grid; pol in {'s', 'p'}."""
        w = _as_real(wavelength_um, device)
        n0, ns = self._indices(w)
        layer_n = [lay.n_complex(w) for lay in self.layers]
        layer_d = [lay.thickness_um for lay in self.layers]
        return tmm_coh(n0, ns, layer_n, layer_d, w,
                       _as_real(aoi_rad, like=w), pol)

    def _rta(self, wavelength_um, aoi_rad, pol, device=None):
        if pol in ("s", "p"):
            _, _, R, T, A = self.compute_rtRTA(wavelength_um, aoi_rad, pol,
                                               device)
            return R, T, A
        # unpolarized: the average of s and p
        _, _, Rs, Ts, As = self.compute_rtRTA(wavelength_um, aoi_rad, "s",
                                              device)
        _, _, Rp, Tp, Ap = self.compute_rtRTA(wavelength_um, aoi_rad, "p",
                                              device)
        return (Rs + Rp) / 2, (Ts + Tp) / 2, (As + Ap) / 2

    def reflectance(self, wavelength_um, aoi_rad=0.0, pol: str = "u",
                    device=None):
        return self._rta(wavelength_um, aoi_rad, pol, device)[0]

    def transmittance(self, wavelength_um, aoi_rad=0.0, pol: str = "u",
                      device=None):
        return self._rta(wavelength_um, aoi_rad, pol, device)[1]

    def absorptance(self, wavelength_um, aoi_rad=0.0, pol: str = "u",
                    device=None):
        return self._rta(wavelength_um, aoi_rad, pol, device)[2]

    # nm/deg conveniences
    def _nm_deg(self, wavelength_nm, aoi_deg, device):
        w = _as_real(wavelength_nm, device)
        return w * 1e-3, _as_real(aoi_deg, like=w) * (math.pi / 180.0)

    def reflectance_nm_deg(self, wavelength_nm, aoi_deg=0.0, pol: str = "u",
                           device=None):
        return self.reflectance(*self._nm_deg(wavelength_nm, aoi_deg, device),
                                pol)

    def transmittance_nm_deg(self, wavelength_nm, aoi_deg=0.0,
                             pol: str = "u", device=None):
        return self.transmittance(*self._nm_deg(wavelength_nm, aoi_deg,
                                                device), pol)

    def absorptance_nm_deg(self, wavelength_nm, aoi_deg=0.0, pol: str = "u",
                           device=None):
        return self.absorptance(*self._nm_deg(wavelength_nm, aoi_deg, device),
                                pol)

    def jones_matrices(self, k0, k1, wavelength_um, aoi_rad, reflect: bool):
        """(N, 3, 3) Jones matrices from the stack's rs/rp or ts/tp at each
        ray's wavelength and AOI: the thin-film coating's bridge to the
        polarization trace."""
        rs, ts, *_ = self.compute_rtRTA(wavelength_um, aoi_rad, "s")
        rp, tp, *_ = self.compute_rtRTA(wavelength_um, aoi_rad, "p")
        like = dict(dtype=complex_of(k0.dtype), device=k0.device)
        if reflect:
            return _assemble(rs, 0.0, 0.0, -rp, -1.0, k0.shape[0], **like)
        return _assemble(ts, 0.0, 0.0, tp, 1.0, k0.shape[0], **like)
