"""Environment models: air refractive index and thermal glass correction.

Port of `optiland_tpu/environment/__init__.py`: the
`EnvironmentalConditions` dataclass, four air-index models (Ciddor 1996,
Edlén 1966 with the NIST water-vapor temperature correction, Birch & Downs
1994, Kohlrausch/OpticStudio), and the Schott thermal dn/dT correction
that the catalog's thermal rows (`MaterialSpec.therm`, `t0`) feed. All
functions are plain tensor arithmetic: the wavelength is a number, an
array or a tensor (on any device; a tensor keeps its dtype, anything else
becomes float64), and the conditions' fields are numbers or tensors. No
kernel runs here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "EnvironmentalConditions",
    "refractive_index_air",
    "ciddor_refractive_index",
    "edlen_refractive_index",
    "birch_downs_refractive_index",
    "kohlrausch_refractive_index",
    "nair_zemax",
    "relative_wavelength",
    "schott_thermal_correction",
]


@dataclass(frozen=True)
class EnvironmentalConditions:
    """Atmospheric state for the air-index models (reference
    `environment/conditions.py:19`). Frozen, so hashable."""

    pressure: float = 101325.0  # Pa
    temperature: float = 15.0  # deg C
    relative_humidity: float = 0.0  # fraction 0..1
    co2_ppm: float = 400.0
    wavelength: float | None = None


def _t(x):
    """`x` as a tensor: a tensor as it is, anything else in float64."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# ---------------------------------------------------------------------------
# Ciddor (1996) — reference `environment/models/ciddor.py`
# ---------------------------------------------------------------------------

_R_GAS = 8.314510
_M_W = 0.018015
_T_STD_AIR_K = 288.15
_P_STD_AIR = 101325.0
_T_STD_VAP_K = 293.15
_P_STD_VAP = 1333.0


def _ciddor_svp(temp_c):
    # both branches evaluated and one selected, so a tensor of
    # temperatures takes each its own
    t_k = _t(temp_c) + 273.15
    warm = torch.exp(1.2378847e-5 * t_k**2 - 1.9121316e-2 * t_k
                     + 33.93711047 - 6.3431645e3 / t_k)
    cold = 10.0 ** (-2663.5 / t_k + 12.537)
    return torch.where(_t(temp_c) >= 0, warm, cold)


def _ciddor_enhancement(pressure_pa, temp_c):
    return 1.00062 + 3.14e-8 * pressure_pa + 5.6e-7 * temp_c**2


def _ciddor_compressibility(pressure_pa, temp_k, xw):
    t_c = temp_k - 273.15
    term = (1.58123e-6 - 2.9331e-8 * t_c + 1.1043e-10 * t_c**2
            + (5.707e-6 - 2.051e-8 * t_c) * xw
            + (1.9898e-4 - 2.376e-6 * t_c) * xw**2)
    term2 = 1.83e-11 - 0.765e-8 * xw**2
    return (1.0 - (pressure_pa / temp_k) * term
            + (pressure_pa / temp_k) ** 2 * term2)


def ciddor_refractive_index(wavelength_um, conditions: EnvironmentalConditions):
    """Phase index of moist air, Ciddor (1996) component-density method."""
    sigma_sq = (1.0 / _t(wavelength_um)) ** 2
    n_as = 1e-8 * (5792105.0 / (238.0185 - sigma_sq)
                   + 167917.0 / (57.362 - sigma_sq))
    n_axs = n_as * (1.0 + 0.534e-6 * (conditions.co2_ppm - 450.0))
    n_ws = 1e-8 * 1.022 * (295.235 + 2.6422 * sigma_sq
                           - 0.032380 * sigma_sq**2 + 0.004028 * sigma_sq**3)

    m_a = 1e-3 * (28.9635 + 12.011e-6 * (conditions.co2_ppm - 400.0))
    z_axs = _ciddor_compressibility(_P_STD_AIR, _T_STD_AIR_K, 0.0)
    rho_axs = _P_STD_AIR * m_a / (z_axs * _R_GAS * _T_STD_AIR_K)
    z_ws = _ciddor_compressibility(_P_STD_VAP, _T_STD_VAP_K, 1.0)
    rho_ws = _P_STD_VAP * _M_W / (z_ws * _R_GAS * _T_STD_VAP_K)

    t_c = conditions.temperature
    p_pa = conditions.pressure
    t_k = t_c + 273.15
    svp = _ciddor_svp(t_c)
    f = _ciddor_enhancement(p_pa, t_c)
    xw = f * conditions.relative_humidity * svp / p_pa if p_pa > 0 else 0.0
    z = _ciddor_compressibility(p_pa, t_k, xw)
    rho_a = p_pa * m_a * (1.0 - xw) / (z * _R_GAS * t_k)
    rho_w = p_pa * _M_W * xw / (z * _R_GAS * t_k)

    return 1.0 + (rho_a / rho_axs) * n_axs + (rho_w / rho_ws) * n_ws


# ---------------------------------------------------------------------------
# Edlén (1966) + NIST water-vapor temperature correction — `models/edlen.py`
# ---------------------------------------------------------------------------

_TORR = 101325.0 / 760.0


def edlen_refractive_index(wavelength_um, conditions: EnvironmentalConditions):
    sigma_sq = (1.0 / _t(wavelength_um)) ** 2
    n_s = 1e-8 * (8342.13 + 2406030.0 / (130.0 - sigma_sq)
                  + 15997.0 / (38.9 - sigma_sq))
    n_s = n_s * (1.0 + 0.540 * (conditions.co2_ppm - 300.0) * 1e-6)
    p_torr = conditions.pressure / _TORR
    t_c = conditions.temperature
    density = (p_torr * (1.0 + p_torr * (0.817 - 0.0133 * t_c) * 1e-6)
               / (1.0 + 0.0036710 * t_c))
    n_tp = n_s * density / 720.775
    # Buck (1981) saturation vapor pressure
    svp = 611.21 * torch.exp(_t((18.678 - t_c / 234.5)
                                * (t_c / (257.14 + t_c))))
    f_torr = conditions.relative_humidity * svp / _TORR
    wv = -f_torr * (5.722 - 0.0457 * sigma_sq) * 1e-8
    wv = wv * (292.75 / (t_c + 273.15))
    return 1.0 + n_tp + wv


# ---------------------------------------------------------------------------
# Birch & Downs (1994) — `models/birch_downs.py`
# ---------------------------------------------------------------------------


def birch_downs_refractive_index(wavelength_um,
                                 conditions: EnvironmentalConditions):
    sigma_sq = (1.0 / _t(wavelength_um)) ** 2
    n_s = 1e-8 * (8342.54 + 2406147.0 / (130.0 - sigma_sq)
                  + 15998.0 / (38.9 - sigma_sq))
    n_as = n_s * (1.0 + 0.534e-6 * (conditions.co2_ppm - 450.0))
    t_c = conditions.temperature
    p_pa = conditions.pressure
    density = (p_pa / 96095.43) * ((1.0 + 1e-8 * (0.601 - 0.00972 * t_c)
                                    * p_pa) / (1.0 + 0.003661 * t_c))
    n_tp = n_as * density
    svp = torch.exp(_t(1.2378847e-5 * (t_c + 273.15) ** 2
                       - 1.9121316e-2 * (t_c + 273.15)
                       + 33.93711047 - 6.3431645e3 / (t_c + 273.15)))
    f_w = 1.00062 + 3.14e-8 * p_pa + 5.6e-7 * t_c**2
    f_pa = conditions.relative_humidity * f_w * svp
    wv = -f_pa * (3.7345 - 0.0401 * sigma_sq) * 1e-10
    wv = wv * (292.75 / (t_c + 273.15))
    return 1.0 + n_tp + wv


# ---------------------------------------------------------------------------
# Kohlrausch (OpticStudio dry-air model) — `models/kohlrausch.py`
# ---------------------------------------------------------------------------


def kohlrausch_refractive_index(wavelength_um,
                                conditions: EnvironmentalConditions):
    sigma_sq = (1.0 / _t(wavelength_um)) ** 2
    n_ref = 1e-5 * (64.328 + 29498.1 / (146.0 - sigma_sq)
                    + 25.54 / (41.0 - sigma_sq))
    denom = 1.0 + (conditions.temperature - 15.0) * 0.00348
    return 1.0 + n_ref * (conditions.pressure / 101325.0) / denom


_MODELS = {
    "ciddor": ciddor_refractive_index,
    "edlen": edlen_refractive_index,
    "birch_downs": birch_downs_refractive_index,
    "kohlrausch": kohlrausch_refractive_index,
}


def refractive_index_air(wavelength_um, conditions: EnvironmentalConditions,
                         model: str = "ciddor"):
    """Dispatcher over the four air models (reference
    `environment/air_index.py:30`)."""
    try:
        fn = _MODELS[model.lower()]
    except KeyError:
        raise ValueError(
            f"Unsupported air model {model!r}; expected one of "
            f"{sorted(_MODELS)}") from None
    return fn(wavelength_um, conditions)


# ---------------------------------------------------------------------------
# Schott thermal glass correction — `materials/material_file.py:131-215`
# ---------------------------------------------------------------------------


def nair_zemax(wavelength_um, temp_c, pressure_atm=1.0):
    """The Edlén-variant air index OpticStudio (and the reference's material
    thermal path, `material_file.py:188-216`) uses for relative/absolute
    index conversion."""
    w2 = _t(wavelength_um) ** 2
    n_ref = (6432.8 + (2949810.0 * w2) / (146.0 * w2 - 1.0)
             + (25540.0 * w2) / (41.0 * w2 - 1.0)) * 1e-8
    return 1.0 + n_ref * pressure_atm / (1.0 + (temp_c - 15.0) * 0.0034785)


def relative_wavelength(wavelength_um, temp_c, pressure_atm=1.0, t0_c=20.0):
    """The 'relative' wavelength at which the catalog dispersion formula must
    be evaluated before applying `schott_thermal_correction` (reference
    `material_file.py:108-118`): the vacuum wavelength rescaled by the air
    index ratio between system and reference conditions."""
    return (_t(wavelength_um)
            * nair_zemax(wavelength_um, temp_c, pressure_atm)
            / nair_zemax(wavelength_um, t0_c, 1.0))


def schott_thermal_correction(n_rel_ref, wavelength_um, therm_coeffs,
                              t0_c, temp_c, pressure_atm=1.0):
    """Correct a catalog (air-relative, reference-temperature) index to the
    system temperature/pressure via the Schott dn/dT model
    (`material_file.py:164-183`).

    therm_coeffs = (D0, D1, D2, E0, E1, lambda_tk).
    """
    d0, d1, d2, e0, e1, wtk = therm_coeffs
    n_air_ref = nair_zemax(wavelength_um, t0_c, 1.0)
    n_abs = n_rel_ref * n_air_ref
    dt = temp_c - t0_c
    w2 = _t(wavelength_um) ** 2
    term = (d0 + d1 * dt + d2 * dt**2
            + (e0 + e1 * dt) / (w2 - wtk**2))
    dn_abs = (n_abs**2 - 1.0) / (2.0 * n_abs) * term * dt
    n_air_sys = nair_zemax(wavelength_um, temp_c, pressure_atm)
    return (n_abs + dn_abs) / n_air_sys
