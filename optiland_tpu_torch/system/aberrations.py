"""Third-order (Seidel) and first-order chromatic aberrations.

Port of `optiland_tpu/system/aberrations.py` (the reference's `Aberrations`,
`optiland/aberrations.py:24-462`): tensor math over the (S-2,)
interior-surface axis; every term is a differentiable function of
`(static, params)`, so Seidel targets can sit in a merit function.

Formulas follow the reference exactly (including its chromatic-term indexing,
which uses the marginal height at the previous surface), validated by parity
tests; chromatic terms use the F (0.4861 um) and C (0.6563 um) lines.
"""

from __future__ import annotations

import torch

from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.system.spec import SystemParams, SystemStatic


def _precalc(static: SystemStatic, params: SystemParams):
    inv = px.invariant(static, params)
    on_axis = bool(torch.isclose(inv, torch.zeros_like(inv)))
    n = px.index_table(static, params,
                       params.wavelengths[static.primary_wavelength_idx])
    C = params.cv
    ya, ua = px.marginal_ray(static, params)
    yb, ub = px.chief_ray(static, params)
    ya, ua, yb, ub = (a.reshape(-1) for a in (ya, ua, yb, ub))
    hp = inv / (n[-1] * ua[-1])
    dn = (px.index_table(static, params, 0.4861)
          - px.index_table(static, params, 0.6563))

    # interior surfaces k = 1..S-2
    k = torch.arange(1, static.num_surfaces - 1, device=C.device)
    i_val = C[k] * ya[k] + ua[k - 1]
    ip_val = C[k] * yb[k] + ub[k - 1]
    if on_axis:
        B = Bp = torch.zeros_like(i_val)
    else:
        denom = 2.0 * n[k] * inv
        B = n[k - 1] * (n[k] - n[k - 1]) * ya[k] * (ua[k] + i_val) / denom
        Bp = n[k - 1] * (n[k] - n[k - 1]) * yb[k] * (ub[k] + ip_val) / denom
    return dict(inv=inv, on_axis=on_axis, n=n, C=C, ya=ya, ua=ua, yb=yb,
                ub=ub, hp=hp, dn=dn, k=k, i=i_val, ip=ip_val, B=B, Bp=Bp)


def TSC(static, params):
    """Transverse spherical per surface (reference
    `aberrations.py:102-130`)."""
    p = _precalc(static, params)
    k, n, ya, ua = p["k"], p["n"], p["ya"], p["ua"]
    on_axis_term = (
        n[k - 1] * (n[k] - n[k - 1]) * ya[k] * (ua[k] + p["i"]) * p["i"] ** 2
    ) / (2.0 * n[k] * n[-1] * ua[-1])
    off_axis_term = p["B"] * p["i"] ** 2 * p["hp"]
    return on_axis_term if p["on_axis"] else off_axis_term


def CC(static, params):
    p = _precalc(static, params)
    return p["B"] * p["i"] * p["ip"] * p["hp"]


def TCC(static, params):
    return CC(static, params) * 3.0


def TAC(static, params):
    p = _precalc(static, params)
    return p["B"] * p["ip"] ** 2 * p["hp"]


def TPC(static, params):
    p = _precalc(static, params)
    k, n = p["k"], p["n"]
    return ((n[k] - n[k - 1]) * p["C"][k] * p["hp"] * p["inv"]
            / (2.0 * n[k] * n[k - 1]))


def DC(static, params):
    p = _precalc(static, params)
    k, ub = p["k"], p["ub"]
    return p["hp"] * (p["Bp"] * p["i"] * p["ip"]
                      + 0.5 * (ub[k] ** 2 - ub[k - 1] ** 2))


def TAchC(static, params):
    p = _precalc(static, params)
    k, n, ya, ua, dn = p["k"], p["n"], p["ya"], p["ua"], p["dn"]
    return (-ya[k - 1] * p["i"] / (n[-1] * ua[-1])
            * (dn[k - 1] - n[k - 1] / n[k] * dn[k]))


def TchC(static, params):
    p = _precalc(static, params)
    k, n, ya, ua, dn = p["k"], p["n"], p["ya"], p["ua"], p["dn"]
    return (-ya[k - 1] * p["ip"] / (n[-1] * ua[-1])
            * (dn[k - 1] - n[k - 1] / n[k] * dn[k]))


def SC(static, params):
    p = _precalc(static, params)
    return -TSC(static, params) / p["ua"][-1]


def AC(static, params):
    p = _precalc(static, params)
    return -TAC(static, params) / p["ua"][-1]


def PC(static, params):
    p = _precalc(static, params)
    return -TPC(static, params) / p["ua"][-1]


def LchC(static, params):
    p = _precalc(static, params)
    return -TAchC(static, params) / p["ua"][-1]


def seidels(static, params):
    """The five Seidel sums S_I..S_V (reference `_sum_seidels`)."""
    p = _precalc(static, params)
    factor = p["n"][-1] * p["ua"][-1] * 2.0
    return torch.stack([
        -torch.sum(TSC(static, params)) * factor,
        -torch.sum(CC(static, params)) * factor,
        -torch.sum(TAC(static, params)) * factor,
        -torch.sum(TPC(static, params)) * factor,
        -torch.sum(DC(static, params)) * factor,
    ])


def third_order(static, params):
    """All terms, mirroring the reference's `third_order()` tuple order."""
    tsc = TSC(static, params)
    cc = CC(static, params)
    tac = TAC(static, params)
    tpc = TPC(static, params)
    dc = DC(static, params)
    tachc = TAchC(static, params)
    tchc = TchC(static, params)
    p = _precalc(static, params)
    ua_img = p["ua"][-1]
    factor = p["n"][-1] * ua_img * 2.0
    S = torch.stack([-torch.sum(tsc) * factor, -torch.sum(cc) * factor,
                   -torch.sum(tac) * factor, -torch.sum(tpc) * factor,
                   -torch.sum(dc) * factor])
    return (tsc, -tsc / ua_img, cc, cc * 3.0, tac, -tac / ua_img, tpc,
            -tpc / ua_img, dc, tachc, -tachc / ua_img, tchc, S)
