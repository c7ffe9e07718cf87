"""Fused trace kernels: ray generation, the whole surface chain and the
spot-moment reduction in one launch on the CUDA card, and their backward.

Port of `optiland_tpu/trace/fused.py`: the seven Pallas kernels of the
trace-and-merit, trace-final and trace-history paths, each a hand-written
CUDA kernel.

  K1 `moments_forward` replaces `_moments_forward`: in-kernel raygen from
     5 scalars, the surface chain, and the masked moments (sum i, sum x i,
     sum y i, sum (x^2+y^2) i). CUDA source: csrc/moments_fwd.cu, built
     once per system from its static codes (`system_defines`), as the JAX
     kernel is traced once per system.
  K2 `moments_backward` replaces `_moments_bwd`: the cotangents of c . m
     for the raygen scalars, the per-surface tables and (with `diff_data`)
     the per-ray inputs. csrc/moments_bwd.cu.
  K3 `raygen_trace_forward` replaces `_raygen_forward`: the same raygen and
     chain, writing the requested final per-ray arrays.
     csrc/raygen_trace_fwd.cu, built once per system like K1.
  K4 `raygen_trace_backward` replaces `_raygen_bwd`: per-ray seeds of the
     requested outputs -> raygen, table and data cotangents.
     csrc/raygen_trace_bwd.cu.
  K5 `fused_trace_forward` replaces `_fused_forward`: the chain on the
     caller's rays (the fields in-kernel raygen refuses: vignetted ones).
     csrc/fused_trace_fwd.cu, built once per system like K1.
  K6 `fused_trace_backward` replaces `_fused_bwd`: per-ray seeds of the 8
     final arrays -> the 8 starting-ray and the table cotangents.
     csrc/fused_trace_bwd.cu.
  K7 `history_forward` replaces `_history_forward`: the chain on the
     caller's rays at their own wavelengths (per-ray dispersion and
     absorption), writing every surface's state: the (S, n) history of
     `trace_system`. csrc/history_fwd.cu, built once per system like K1,
     with its media's dispersion codes (`history_defines`). As in JAX, its
     gradient is autograd through the eager trace (`_FusedHistory`), not a
     kernel.

K1-K6 run in the two configurations of their JAX kernels (`uniform_w`):
at one wavelength, hoisted into the per-surface index and absorption
tables (`_uniform_tables`), or at each ray's own wavelength, the ray data
gaining w (Hx, Hy, Px, Py, w for K1-K4, a 9th ray array for K5 and K6, as
K7's), with the dispersion formulas and extinction tables evaluated per
ray and, in K2, K4 and K6, differentiated into `mat_coeffs` and each ray's
w. As in JAX, a scalar wavelength takes the first and any array the
second. Each configuration is its own build: the per-ray forward
variants take the media's dispersion codes (`history_defines`, K7's), the
per-ray backward variants those codes alone (`media_defines`).

The chain's interactions are JAX's `_tile_trace` branches: refraction,
reflection, simple coatings (T, or R after a reflection), the ideal thin
lens, gratings on plane and curved carriers, and phase sheets of the
constant, radial and linear-grating kinds on plane and conic carriers,
each with its adjoint in K2, K4 and K6; its geometries JAX's kernel
geometries: plane, conic, even and odd aspheres, and the freeforms
(poly-XY, biconic, toroidal, Chebyshev, Zernike, Forbes Q-bfs and Q-2D,
csrc/freeform.cuh), at any number of coefficient slots (a surface past 17
keeps its row in the float table's tail, `_wide_layout`) and surfaces
(past 64 the one-wavelength backward kernels' record grows,
`backward_defines`), up to a block's shared memory (`_static_smem`,
`_backward_launch`). A system with a coating, a thin
lens, a grating or a phase sheet is built with OTK_INTERACTIONS
(`branch_defines`), its one-wavelength K2, K4 and K6 too, and a system
with a phase sheet also with OTK_PHASE; a system without them builds the
code as it was before those branches. At one wavelength a grating's order
column holds m w (`_uniform_grating`) and a phase sheet's 1 / k0 = w 1e-3
/ 2 pi (`_uniform_phase`), as the index table holds n(w).

All run one ray per thread (csrc/chain.cuh; the backward kernels share the
reverse sweep of csrc/chain_bwd.cuh; K1, K3, K5 and K7 unroll the same
per-surface step over their system's constant codes, csrc/system_chain.cuh,
on a grid that `system_grid` shapes). What bounds K1-K6 on an H100: FP32
arithmetic, not memory. At 2M rays K1 reads 32 MB (Hx, Hy, Px, Py in f32),
about 10 us at 3.35 TB/s, while the chain costs on the order of 10^3 FP32
operations per ray (counted per branch by `chip_smoke.py`), ~50 us at the
67 TFLOP/s non-tensor FP32 peak of NVIDIA's H100 SXM data sheet; a
backward re-traces the ray and runs the adjoint, about three times that.
K7 is bound by the bytes of the history it writes (8 S floats per ray).
The design keeps the forward's per-ray intermediates in registers, stages
the small system tables in shared memory once per block, and reduces
inside the block (warp shuffles, then shared memory) to one partial per
block, summed by `torch.sum`: deterministic, no atomics. A backward keeps
each surface's entry state for its reverse sweep in local memory (L1
holds it) and sums its cotangents per warp, over a persistent grid of at
most one block an SM (`backward_grid`).

Beside each kernel is its plain PyTorch version (`_moments_plain`,
`_moments_bwd_plain`, `_raygen_trace_plain`, `_raygen_trace_bwd_plain`,
`_fused_trace_plain`, `_fused_trace_bwd_plain`, `_history_plain`; a
backward's plain version is autograd through its forward's): the wrapper
takes it only for tensors on the CPU. On a CUDA tensor the wrapper
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.geometry import surfaces as _geom
from optiland_tpu_torch.geometry.surfaces import (
    GEOM_BICONIC,
    GEOM_CHEBYSHEV,
    GEOM_CONIC,
    GEOM_EVEN_ASPHERE,
    GEOM_FORBES_Q2D,
    GEOM_FORBES_QBFS,
    GEOM_ODD_ASPHERE,
    GEOM_PLANE,
    GEOM_POLYNOMIAL_XY,
    GEOM_TOROIDAL,
    GEOM_ZERNIKE,
)
from optiland_tpu_torch.materials.dispersion import (
    FORMULA_TABULATED,
    _interp,
    material_index,
)
from optiland_tpu_torch.system.spec import (
    COAT_NONE,
    COAT_SIMPLE,
    INT_DIFFRACT,
    INT_NONE,
    INT_PHASE,
    INT_REFLECT,
    INT_THIN_LENS,
    MAX_GEOM_COEFFS,
    PHASE_CONSTANT,
    PHASE_LINEAR_GRATING,
    PHASE_NONE,
    PHASE_RADIAL,
    SystemParams,
    SystemStatic,
    positions_of,
)

# inline geometries (hand-written sag and gradient); the rest of
# _SUPPORTED_GEOMS traces through `geometry/surfaces.sag_and_grad` with a
# conic-seeded Newton of its own count, as JAX's `_tile_trace`
_INLINE_GEOMS = (GEOM_PLANE, GEOM_CONIC, GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE)
_SUPPORTED_GEOMS = _INLINE_GEOMS + (
    GEOM_POLYNOMIAL_XY, GEOM_BICONIC, GEOM_TOROIDAL, GEOM_CHEBYSHEV,
    GEOM_ZERNIKE, GEOM_FORBES_QBFS, GEOM_FORBES_Q2D)
# the freeform families the CUDA chain covers (csrc/freeform.cuh): all of
# JAX's kernel freeforms
_KERNEL_FREEFORMS = (GEOM_POLYNOMIAL_XY, GEOM_BICONIC, GEOM_TOROIDAL,
                     GEOM_CHEBYSHEV, GEOM_ZERNIKE, GEOM_FORBES_QBFS,
                     GEOM_FORBES_Q2D)
_SUPPORTED_INTERACTIONS = (0, INT_REFLECT, INT_NONE, INT_THIN_LENS,
                           INT_DIFFRACT, INT_PHASE)
_ANALYTIC_PHASE = (PHASE_NONE, PHASE_CONSTANT, PHASE_RADIAL,
                   PHASE_LINEAR_GRATING)
_EPS = 1e-12
# 1 / k0 per um of wavelength: k0 = 2 pi / (w 1e-3) in 1/mm, w in um
_INV_K0_PER_UM = 1e-3 / (2.0 * math.pi)

# Newton cap of the fused chain: the conic closed form seeds within ~1e-3
# of the asphere root and Newton converges quadratically, so 2 iterations
# plus the closing step land below f32 eps. It overrides
# `static.newton_iters`; `spec._fused_newton_seed_ok` refuses the systems
# where that does not hold.
_NEWTON_FUSED_MAX = 2
# freeform seeds (the conic of a biconic's x-profile, a toroidal's y-curve,
# a Zernike's carrier) start further from the root: more steps
_NEWTON_FUSED_MAX_FF = 6

# row widths of the packed per-surface tables; `_pack_tables` writes the
# slots in the order csrc/chain.cuh names them (F_* and I_* there)
_F_STRIDE = 32
_F_COEFFS, _F_THICK, _F_TILT, _F_DEC, _F_NTAB = 2, 19, 20, 23, 25
# a thin lens's focal length, a grating's (m w or m, d, angle) and a phase
# sheet's 8 profile slots and 1 / k0 (at per-ray wavelengths 1 / k0 per um,
# `_INV_K0_PER_UM`) take the first coefficient slots (their surfaces are
# planes or conics); a coated surface's factor (T, or R after a reflection)
# takes _F_COAT
_F_FOCAL = _F_GRATING = _F_PHASE = _F_COEFFS
_F_PHASE_IK = _F_PHASE + 8
_F_COAT = 28
_I_STRIDE = 16
# a wide surface's offset in the float table and first wide row (I_XOFF,
# I_XROW of csrc/chain.cuh)
_I_XOFF, _I_XROW = 13, 14
# leading material-coefficient columns K7 stages in shared memory: every
# dispersion formula but the tabulated one has at most this many
_MAT_SHARED = 17
# the surfaces a backward kernel's record holds at one wavelength without
# OTK_MAX_SURFACES (csrc/chain.cuh MAX_SURFACES)
_MAX_SURFACES = 64
# threads per block of K1, K3, K5 and K7 (csrc/system_chain.cuh
# SYSTEM_THREADS)
_SYSTEM_THREADS = 256
# a per-system kernel of which an SM holds at least this many blocks at once
# takes a block a tile (`system_grid`)
_TILE_GRID_BLOCKS_PER_SM = 4
# threads per block of the backward kernels K2, K4 and K6 at most
# (csrc/chain_bwd.cuh BWD_THREADS) and at least (`backward_grid`)
_BWD_THREADS = 512
_BWD_MIN_THREADS = 128
# the dynamic shared memory a block may take on Hopper (csrc/chain_bwd.cuh
# MAX_DYN_SMEM), and the static shared memory of one (the per-system
# kernels stage their tables in it)
_MAX_SMEM = 232_448
_MAX_STATIC_SMEM = 49_152
# static shared memory of the per-system kernels besides the float table
# and, at per-ray wavelengths, the material columns (csrc/*_fwd.cu): K1's
# raygen scalars and warp partials, K3's raygen scalars, K7's two staging
# tiles of eight 256-float history rows
_STATIC_SMEM_OTHER = {"K1": 4 * (5 + 4 * 8), "K3": 4 * 5, "K5": 0,
                      "K7": 4 * 2 * 8 * 256}

_NAMES = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
_RAY_KEYS = ("x", "y", "z", "L", "M", "N", "i", "opd", "w")
_KERNELS = {"K1": "moments_forward", "K2": "moments_backward",
            "K3": "raygen_trace_forward", "K4": "raygen_trace_backward",
            "K5": "fused_trace_forward", "K6": "fused_trace_backward",
            "K7": "history_forward"}


def supports_fused(static: SystemStatic) -> bool:
    """Whether the fused chain's system class covers this system (the JAX
    gate, including the build-time measured Newton-cap guard)."""
    return (
        static.fused_newton_ok
        and not static.has_abs_cs
        and all(g in _SUPPORTED_GEOMS for g in static.geom_codes)
        and all(i in _SUPPORTED_INTERACTIONS for i in static.interactions)
        and all(pk in _ANALYTIC_PHASE for pk in static.phase_kinds)
        and all(c in (COAT_NONE, COAT_SIMPLE) for c in static.coatings)
        and all(b is None for b in static.bsdfs)
        and static.apodization is None
        and all(m is None for m in static.aperture_masks)
    )


def supports_fused_raygen(static: SystemStatic) -> bool:
    """Whether ray generation can run inside the kernel: angle fields, or
    object-height fields with a finite object; no telecentric aiming, no
    vignetting factors, no apodization."""
    return (
        static.field_type in ("angle", "object_height")
        and not (static.field_type == "object_height"
                 and static.object_infinite)
        and not static.telecentric
        and not static.has_vignetting
        and static.apodization is None
    )


def _check_kernel_branches(static: SystemStatic, kernel: str):
    """Refuse, by name, a system the CUDA kernel `kernel` ("K1".."K7") does
    not take, at one wavelength or at per-ray wavelengths alike: every
    kernel takes both. These are JAX's own refusals (`supports_fused`:
    grid sag, NURBS, tabulated phase profiles) and the forms of the
    tables' slots; past them, the one limit of the card: a per-system
    kernel (K1, K3, K5, K7) stages its tables in the block's static shared
    memory (`_static_smem`)."""
    eager = sorted({g for g in static.geom_codes
                    if g not in _SUPPORTED_GEOMS})
    if eager:
        # as JAX's kernels (`supports_fused`): grid sag and NURBS take the
        # eager trace
        raise ValueError(f"geometry codes {eager}: the fused chain takes "
                         "no grid sag or NURBS surface")
    aspheres = [k for k in range(static.num_surfaces)
                if static.interactions[k] in (INT_THIN_LENS, INT_DIFFRACT,
                                              INT_PHASE)
                and static.geom_codes[k] not in (GEOM_PLANE, GEOM_CONIC)]
    if aspheres:
        # their coefficient slots hold the focal length, the grating or the
        # phase profile (`_pack_tables`); `Optic.add_surface` gives them the
        # standard geometry
        raise ValueError(f"surfaces {aspheres}: a thin lens, grating or "
                         "phase sheet on a geometry other than plane or "
                         "conic")
    tabulated = [k for k in range(static.num_surfaces)
                 if static.phase_kinds[k] not in _ANALYTIC_PHASE]
    if tabulated:
        # as JAX's kernels (`supports_fused`): grid and height-profile
        # sheets take the eager trace
        raise ValueError(f"surfaces {tabulated}: the fused chain takes "
                         "constant, radial and linear-grating phase "
                         "profiles, not grid or height profiles")
    if kernel in _STATIC_SMEM_OTHER:
        need = _static_smem(static, kernel)
        if need > _MAX_STATIC_SMEM:
            raise ValueError(
                f"{kernel} {_KERNELS[kernel]}: a {static.num_surfaces}-"
                f"surface system needs {need} bytes of static shared "
                f"memory for its tables, more than the {_MAX_STATIC_SMEM} "
                "a block of the per-system kernels may take")
    q2d = _q2d_tables(static)
    if q2d and len(q2d[0]) > 255:
        raise ValueError(f"{len(q2d[0])} Forbes Q-2D term groups: the "
                         "per-system codes hold at most 255")


def _static_smem(static: SystemStatic, kernel: str) -> int:
    """Bytes of static shared memory that the per-system kernel `kernel`
    ("K1", "K3", "K5", "K7") takes for this system in its per-ray variant
    (its one-wavelength variant takes less): the float table
    (`_table_floats`), the first _MAT_SHARED material columns of each
    surface, and the kernel's own (`_STATIC_SMEM_OTHER`). A block takes at
    most _MAX_STATIC_SMEM: K7 holds 167 surfaces of 17 slots, K1, K3 and K5
    250."""
    return (4 * (_table_floats(static) + static.num_surfaces * _MAT_SHARED)
            + _STATIC_SMEM_OTHER[kernel])


def _raygen_scalars(static: SystemStatic, params: SystemParams):
    """The differentiable scalar prologue of the in-kernel raygen:
    (5,) = [epl, epd, fmax, a, b] (see `_tile_raygen`)."""
    from optiland_tpu_torch.system import paraxial as px

    epl = px.EPL(static, params)
    epd = px.EPD(static, params)
    pos = positions_of(static, params)
    fmax = torch.sqrt(torch.max(params.x_fields ** 2 + params.y_fields ** 2))
    if static.field_type == "angle" and static.object_infinite:
        offset = epd - torch.min(pos[1:-1])
        a = pos[1] - offset   # start plane z
        b = offset + epl      # lever arm for the field-angle offset
    else:
        a = pos[0]            # object plane z
        b = epl - pos[0]
    return torch.stack([epl, epd, fmax, a, b]).to(params.cv.dtype)


def _uniform_tables(static: SystemStatic, params: SystemParams, w):
    """Hoist monochromatic dispersion out of the kernel: (n_table,
    alpha_table), the index after each surface (differentiable through
    `mat_coeffs`) and the Beer-Lambert coefficient 4 pi k(w) / w of the
    medium after each surface (the extinction tables are not differentiated,
    as in JAX)."""
    w = torch.as_tensor(w, dtype=params.cv.dtype, device=params.cv.device)
    S = static.num_surfaces
    n_table = torch.stack([
        material_index(static.mat_formulas[k], static.mat_n_coeffs[k],
                       params.mat_coeffs[k], w)
        for k in range(S)
    ])
    if not any(static.has_absorption):
        return n_table, torch.zeros_like(params.cv)
    kv = torch.stack([_interp(w, params.k_wl[k], params.k_val[k])
                      for k in range(S)])
    return n_table, 4.0 * math.pi * kv / w


def _uniform_grating(static: SystemStatic, params: SystemParams, w):
    """The grating table at one wavelength w: the order column of each
    grating holds m w, the product the grating equation takes (w hoisted
    out of the kernel as the indices are), differentiable in m and w;
    JAX's kernel forms the same m * w from each ray's w. A system without
    a grating keeps its table as it is."""
    g = params.grating
    if INT_DIFFRACT not in static.interactions:
        return g
    w = torch.as_tensor(w, dtype=g.dtype, device=g.device)
    return torch.cat([g[:, :1] * w, g[:, 1:]], dim=1)


def _uniform_phase(static: SystemStatic, params: SystemParams, w):
    """The phase table at one wavelength w: the (S, 8) profile slots and a
    9th column, 1 / k0 = w 1e-3 / 2 pi (mm), the factor of the phase
    gradient and of the OPD term (w hoisted out of the kernel as the
    indices are), differentiable in w; JAX's kernel forms k0 from each
    ray's w. A system without a phase sheet keeps its table as it is."""
    ph = params.phase_params
    if INT_PHASE not in static.interactions:
        return ph
    w = torch.as_tensor(w, dtype=ph.dtype, device=ph.device)
    return torch.cat([ph, (w * _INV_K0_PER_UM).expand(ph.shape[0], 1)],
                     dim=1)


def _uniform_params(static: SystemStatic, params: SystemParams, w,
                    diff_w: bool = True):
    """(diffp, nondiffp) of the chain at one wavelength w: the index and
    absorption tables (`_uniform_tables`), the gratings' m w
    (`_uniform_grating`) and the phase sheets' 1 / k0 (`_uniform_phase`)
    hoisted; with `diff_w` false w enters the last two detached."""
    n_table, alpha_table = _uniform_tables(static, params, w)
    w = torch.as_tensor(w, dtype=params.cv.dtype, device=params.cv.device)
    if not diff_w:
        w = w.detach()
    return (_diff_params(params, n_table, _uniform_grating(static, params, w),
                         _uniform_phase(static, params, w)),
            _nondiff_params(params, alpha_table))


def _diff_params(params: SystemParams, n_table=None, grating=None,
                 phase=None):
    """The 12 differentiable tables of the chain (JAX `_diff_params`); at
    one wavelength `n_table`, `grating` and `phase` are the hoisted ones
    (`_uniform_tables`, `_uniform_grating`, `_uniform_phase`)."""
    if n_table is None:
        n_table = torch.zeros_like(params.cv)
    return (params.cv, params.conic, params.coeffs, params.thickness,
            params.tilt, params.decenter, params.mat_coeffs,
            params.coating_params, n_table,
            params.grating if grating is None else grating,
            params.phase_params if phase is None else phase,
            params.focal_length)


def _nondiff_params(params: SystemParams, alpha_table=None):
    if alpha_table is None:
        alpha_table = torch.zeros_like(params.cv)
    return (params.ap_radius, params.k_wl, params.k_val, alpha_table)


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------
def _tile_raygen(static: SystemStatic, rg, Hx, Hy, Px, Py):
    """Ray generation from the 5 raygen scalars; `generate_rays` semantics
    for the `supports_fused_raygen` class. Returns (x0, y0, z0, L, M, N,
    i, opd)."""
    epl, epd, fmax, a, b = rg[0], rg[1], rg[2], rg[3], rg[4]
    half = epd * 0.5
    if static.field_type == "angle":
        tx = torch.tan(torch.deg2rad(fmax * Hx))
        ty = torch.tan(torch.deg2rad(fmax * Hy))
        if static.object_infinite:
            x0 = Px * half - tx * b
            y0 = Py * half - ty * b
        else:
            x0 = (-tx * b).expand(Px.shape)
            y0 = (-ty * b).expand(Px.shape)
    else:  # object_height (finite object)
        x0 = (fmax * Hx).expand(Px.shape)
        y0 = (fmax * Hy).expand(Px.shape)
    z0 = a.expand(Px.shape)
    # aim at the paraxial entrance pupil
    dx = Px * half - x0
    dy = Py * half - y0
    dz = epl - z0
    mag2 = dx * dx + dy * dy + dz * dz
    degen = (mag2 < 1e-18).to(dx.dtype)
    inv = torch.rsqrt(torch.clamp(mag2, min=1e-18))
    L = (1.0 - degen) * dx * inv
    M = (1.0 - degen) * dy * inv
    N = (1.0 - degen) * dz * inv + degen
    return x0, y0, z0, L, M, N, torch.ones_like(Px), torch.zeros_like(Px)


def _sag_grad_terms(code, n_coeffs, coeffs_k, cvk, kk, r2, want_sag):
    """Conic+polynomial sag (optional) and its radial gradient factors:
    (sag, fx, fy, godd) with gradient (x fx + x godd, y fy + y godd);
    godd is None except for odd aspheres."""
    m = torch.clamp(1.0 - kk * cvk * cvk * r2, min=_EPS)
    inv_root = torch.rsqrt(m)
    root = m * inv_root
    s_val = cvk * r2 / (1.0 + root) if want_sag else None
    gmul = cvk * inv_root
    if code == GEOM_EVEN_ASPHERE and n_coeffs:
        rp = r2
        rp0 = torch.ones_like(r2)
        g = torch.zeros_like(r2)
        for ci in range(n_coeffs):
            if want_sag:
                s_val = s_val + coeffs_k[ci] * rp
                rp = rp * r2
            g = g + 2.0 * (ci + 1) * coeffs_k[ci] * rp0
            rp0 = rp0 * r2
        return s_val, gmul + g, gmul + g, None
    if code == GEOM_ODD_ASPHERE and n_coeffs:
        r = torch.sqrt(torch.clamp(r2, min=_EPS))
        rpow = r
        rpow0 = torch.ones_like(r)
        g = torch.zeros_like(r)
        for ci in range(n_coeffs):
            if want_sag:
                s_val = s_val + coeffs_k[ci] * rpow
                rpow = rpow * r
            g = g + (ci + 1) * coeffs_k[ci] * rpow0
            rpow0 = rpow0 * r
        return s_val, gmul, gmul, g / r
    return s_val, gmul, gmul, None


def _radial_grad(code, n_coeffs, coeffs_k, cvk, kk, x, y, want_sag):
    r2 = x * x + y * y
    s_val, fx, fy, godd = _sag_grad_terms(code, n_coeffs, coeffs_k, cvk, kk,
                                          r2, want_sag)
    if godd is None:
        return s_val, x * fx, y * fy
    return s_val, x * fx + x * godd, y * fy + y * godd


def _refract(L, M, N, nx, ny, nz, u):
    """Vector Snell refraction with TIR passthrough; `n` oriented along the
    incident ray. Returns (L', M', N', okf)."""
    c = L * nx + M * ny + N * nz
    d2 = 1.0 - u * u * (1.0 - c * c)
    okf = (d2 >= 0.0).to(L.dtype)
    rt = torch.sqrt(torch.clamp(d2, min=0.0))
    q = rt - u * c
    Lo = okf * (u * L + q * nx) + (1.0 - okf) * L
    Mo = okf * (u * M + q * ny) + (1.0 - okf) * M
    No = okf * (u * N + q * nz) + (1.0 - okf) * N
    return Lo, Mo, No, okf


def _reflect(L, M, N, nx, ny, nz):
    """Mirror reflection l' = l - 2 (l.n) n."""
    c = L * nx + M * ny + N * nz
    return L - 2.0 * c * nx, M - 2.0 * c * ny, N - 2.0 * c * nz


def _rotate(x, y, z, L, M, N, angles):
    for c_, s_, rot in angles:
        if rot == "z":
            x, y = x * c_ - y * s_, x * s_ + y * c_
            L, M = L * c_ - M * s_, L * s_ + M * c_
        elif rot == "y":
            x, z = x * c_ + z * s_, -x * s_ + z * c_
            L, N = L * c_ + N * s_, -L * s_ + N * c_
        else:
            y, z = y * c_ - z * s_, y * s_ + z * c_
            M, N = M * c_ - N * s_, M * s_ + N * c_
    return x, y, z, L, M, N


def _thin_lens(L, M, N, x, y, opd, f, n1, n2):
    """Ideal thin-lens bending and its quadratic OPD term (JAX
    `_tile_trace`'s INT_THIN_LENS branch)."""
    ux = L / N
    uy = M / N
    ux2 = (n1 * ux - x / f) / n2
    uy2 = (n1 * uy - y / f) / n2
    N = torch.rsqrt(1.0 + ux2 * ux2 + uy2 * uy2)
    return ux2 * N, uy2 * N, N, opd - (x * x + y * y) / (2.0 * f)


def _diffract(plane, reflective, mw, d, angle, L, M, N, i, nx, ny, nz, gx,
              gy, n1, n2):
    """Grating diffraction (JAX `_tile_diffract`) with `mw` the order times
    the wavelength (JAX's m * w): (nx, ny, nz) is the carrier's raw normal
    (nz < 0) and (gx, gy) its sag gradient. Returns (L, M, N, i); an
    evanescent order keeps its direction with i = 0."""
    one = torch.ones_like(L)
    if plane:
        nxx = torch.zeros_like(L)
        nyy = torch.zeros_like(L)
        nzz = one
        fx = -torch.sin(angle) * one
        fy = torch.cos(angle) * one
        fz = torch.zeros_like(L)
    else:
        nxx, nyy, nzz = nx, ny, nz
        ca, sa = torch.cos(angle), torch.sin(angle)
        tz_ = gx * ca + gy * sa
        ux, uy, uz = -nxx, -nyy, -nzz
        fx = uy * tz_ - uz * sa
        fy = uz * ca - ux * tz_
        fz = ux * sa - uy * ca
        inv = torch.rsqrt(fx * fx + fy * fy + fz * fz)
        fx, fy, fz = -fx * inv, -fy * inv, -fz * inv

    pp = d * torch.rsqrt(fx * fx + fy * fy)
    dot = L * nxx + M * nyy + N * nzz
    sgn = torch.sign(dot)
    nxx, nyy, nzz = nxx * sgn, nyy * sgn, nzz * sgn
    cosi = torch.abs(dot)
    utx = L - cosi * nxx
    uty = M - cosi * nyy
    utz = N - cosi * nzz
    fdotn = fx * nxx + fy * nyy + fz * nzz
    ftx = fx - fdotn * nxx
    fty = fy - fdotn * nyy
    ftz = fz - fdotn * nzz

    n2c = -n2 if reflective else n2
    Tx = n1 * pp * utx + mw * ftx
    Ty = n1 * pp * uty + mw * fty
    Tz = n1 * pp * utz + mw * ftz
    Q = pp * pp * n2 * n2 - (Tx * Tx + Ty * Ty + Tz * Tz)
    okf = (Q >= 0.0).to(L.dtype)
    root = torch.sqrt(torch.clamp(Q, min=0.0))
    inv_den = 1.0 / (pp * n2c)
    s = -1.0 if reflective else 1.0
    Lr = (Tx - nxx * root) * inv_den
    Mr = (Ty - nyy * root) * inv_den
    Nr = (Tz + s * nzz * root) * inv_den
    inv_mag = torch.rsqrt(Lr * Lr + Mr * Mr + Nr * Nr)
    L = okf * Lr * inv_mag + (1.0 - okf) * L
    M = okf * Mr * inv_mag + (1.0 - okf) * M
    N = okf * Nr * inv_mag + (1.0 - okf) * N
    return L, M, N, i * okf


def _phase_vg(kind, p, x, y):
    """Phase value and gradient of the analytic kinds in the fused chain's
    form (JAX `_phase_vg_inline`): the radial d phi / d(r^2) runs over all
    of p's slots with r^(2 ci) carried from 1, so that its derivative at r
    = 0 is the true 2 p_0 (the eager form, `trace/phase.py`, gives 0
    there)."""
    if kind == PHASE_CONSTANT:
        z = torch.zeros_like(x)
        return p[0] + z, z, z
    if kind == PHASE_RADIAL:
        r2 = x * x + y * y
        phase = torch.zeros_like(x)
        dphi_dr2 = torch.zeros_like(x)
        rp = r2
        rp_prev = torch.ones_like(x)
        for ci in range(p.shape[0]):
            phase = phase + p[ci] * rp
            dphi_dr2 = dphi_dr2 + p[ci] * (ci + 1) * rp_prev
            rp_prev = rp
            rp = rp * r2
        return phase, 2.0 * x * dphi_dr2, 2.0 * y * dphi_dr2
    # PHASE_LINEAR_GRATING
    return p[0] * x + p[1] * y, p[0] + 0.0 * x, p[1] + 0.0 * y


def _phase_sheet(kind, p, reflective, ik, L, M, N, i, opd, x, y, nx, ny,
                 nz, n1, n2):
    """The generalized Snell law of a phase sheet (JAX `_tile_phase`) in
    units of k0: with ik = 1 / k0, the scaled gradient (a, b) = ik grad
    phi, the carrier's raw normal n (nz < 0), c = l.n and e = n1 c + a nx +
    b ny, the tangential wavevector kp = n1 l + (a, b, 0) - e n and R^2 =
    n2^2 - |kp|^2 (n2 = n1 on a mirror); the outgoing direction is kp +
    s sqrt(R^2) n renormalized, s = sign(c), negated on a mirror. An
    evanescent ray (R^2 < 0) keeps its direction with i = 0; the OPD takes
    -phi / k0. Returns (L, M, N, i, opd)."""
    if reflective:
        n2 = n1
    phase, gpx, gpy = _phase_vg(kind, p, x, y)
    a = ik * gpx
    b = ik * gpy
    c = L * nx + M * ny + N * nz
    e = n1 * c + a * nx + b * ny
    kpx = n1 * L + a - e * nx
    kpy = n1 * M + b - e * ny
    kpz = n1 * N - e * nz
    Q = n2 * n2 - (kpx * kpx + kpy * kpy + kpz * kpz)
    okf = (Q >= 0.0).to(L.dtype)
    al = (-1.0 if reflective else 1.0) * torch.sign(c) * torch.sqrt(
        torch.clamp(Q, min=0.0))
    kox = kpx + al * nx
    koy = kpy + al * ny
    koz = kpz + al * nz
    inv = torch.rsqrt(kox * kox + koy * koy + koz * koz)
    L = okf * kox * inv + (1.0 - okf) * L
    M = okf * koy * inv + (1.0 - okf) * M
    N = okf * koz * inv + (1.0 - okf) * N
    return L, M, N, i * okf, opd - phase * ik


def _kv_interp(w, kwl, kval):
    """Unrolled linear interpolation of a (K,)-point extinction table:
    jnp.interp semantics (edge-clamped) with float masks and a guarded
    divide on the zero-width segments of a padded table. The arithmetic of
    `kv_interp` in csrc/chain.cuh and of the JAX `_kv_interp`."""
    K = kwl.shape[0]
    one = torch.ones((), dtype=w.dtype, device=w.device)
    lo = (w <= kwl[0]).to(w.dtype)
    hi = (w > kwl[K - 1]).to(w.dtype)
    kv = lo * kval[0] + hi * kval[K - 1]
    for j in range(K - 1):
        w0 = kwl[j]
        w1 = kwl[j + 1]
        dw = torch.where(torch.abs(w1 - w0) > _EPS, w1 - w0, one)
        frac = (w - w0) / dw
        val = kval[j] + frac * (kval[j + 1] - kval[j])
        inseg = (w > w0).to(w.dtype) * (w <= w1).to(w.dtype)
        kv = kv + inseg * val
    return kv


def _tile_trace(static: SystemStatic, diffp, nondiffp,
                x, y, z, L, M, N, i, opd, w=None, record=False):
    """The fused chain in PyTorch for the branches the CUDA kernels cover;
    the arithmetic of csrc/chain.cuh and of the JAX `_tile_trace` value
    pass. `w=None`: one wavelength, hoisted into `n_table`, `alpha_table`
    the gratings' m w (`_uniform_grating`) and the phase sheets' 1 / k0
    (`_uniform_phase`); otherwise the per-ray wavelengths, with
    `material_index`, the extinction tables, m w and 1 / k0 evaluated per
    ray (K1-K6 in their per-ray configuration, K7),
    differentiable into `mat_coeffs` and w (the extinction tables are not
    differentiated, as in JAX).
    With `record`, returns every surface's state, row 0 the starting rays.
    Newton runs on a detached root and closes with one differentiable
    step, so autograd through it gives the implicit-function-theorem
    derivative; so does a pure conic's closed-form root where it carries a
    gradient (JAX's `for_grad` pass). Aspheres take min(newton_iters, 2)
    updates before that step, freeforms min(newton_iters, 6)."""
    (cv, conic, coeffs, thickness, tilt, decenter, mat_coeffs,
     coating_params, n_table, grating, phase_params, focal_length) = diffp
    ap_radius, k_wl, k_val, alpha_table = nondiffp
    pos_prev = torch.zeros((), dtype=cv.dtype, device=cv.device)
    one = torch.ones((), dtype=cv.dtype, device=cv.device)
    eps = _EPS * one

    def n_of(k):
        if w is None:
            return n_table[k]
        return material_index(static.mat_formulas[k], static.mat_n_coeffs[k],
                              mat_coeffs[k], w)

    records = [(x, y, z, L, M, N, i, opd)] if record else None
    n_pre = n_of(0)
    for k in range(1, static.num_surfaces):
        pos_k = pos_prev + (thickness[k - 1] if k > 1 else 0.0)
        pos_prev = pos_k

        tilted = static.has_tilt[k]
        decentered = static.has_decenter[k]
        tx = decenter[k, 0]
        ty = decenter[k, 1]
        if tilted or decentered:
            x = x - tx
            y = y - ty
        z = z - pos_k
        if tilted:
            rx, ry, rz = tilt[k, 0], tilt[k, 1], tilt[k, 2]
            x, y, z, L, M, N = _rotate(x, y, z, L, M, N, (
                (torch.cos(-rz), torch.sin(-rz), "z"),
                (torch.cos(-ry), torch.sin(-ry), "y"),
                (torch.cos(-rx), torch.sin(-rx), "x")))

        code = static.geom_codes[k]
        cvk = cv[k]
        kk = 1.0 + conic[k]
        # closed-form conic intersection (curvature form)
        A = cvk * (L * L + M * M + kk * N * N)
        B = 2.0 * (cvk * (L * x + M * y + kk * N * z) - N)
        C = cvk * (x * x + y * y + kk * z * z) - 2.0 * z
        disc = B * B - 4.0 * A * C
        validf = (disc >= 0.0).to(A.dtype)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        big = torch.abs(A) > _EPS
        A_safe = torch.where(big, A, one)
        inv2A = 1.0 / (2.0 * A_safe)
        t1 = (-B + sq) * inv2A
        t2 = (-B - sq) * inv2A
        z1 = z + t1 * N
        z2 = z + t2 * N
        t_quad = torch.where(torch.abs(z1) <= torch.abs(z2), t1, t2)
        B_safe = torch.where(torch.abs(B) > _EPS, B, eps)
        t = torch.where(big, t_quad, -C / B_safe)
        validf = torch.where(big, validf, one)

        n_coeffs = static.geom_n_coeffs[k]
        aux_k = static.geom_aux[k]
        freeform = code not in _INLINE_GEOMS
        if freeform:
            # conic-seeded Newton through `geometry/surfaces.sag_and_grad`
            # (JAX's `_tile_trace`): min(newton_iters, 6) updates on a
            # detached root, then one differentiable update, with the
            # kernel's safe-divide (every |f'| <= 1e-12 becomes 1e-12)
            t = t.detach()
            n_newton = min(static.newton_iters, _NEWTON_FUSED_MAX_FF)
            for it in range(n_newton + 1):
                if it == n_newton:
                    t = t.detach()
                xt = x + t * L
                yt = y + t * M
                zt = z + t * N
                s_val, gx, gy = _geom.sag_and_grad(
                    code, n_coeffs, xt, yt, cvk, conic[k], coeffs[k], aux_k)
                f = s_val - zt
                fp = gx * L + gy * M - N
                fp = torch.where(torch.abs(fp) > _EPS, fp, eps)
                t = t - f / fp
        elif code in (GEOM_EVEN_ASPHERE, GEOM_ODD_ASPHERE) and n_coeffs:
            t = t.detach()
            n_newton = min(static.newton_iters, _NEWTON_FUSED_MAX)
            for it in range(n_newton + 1):
                if it == n_newton:
                    t = t.detach()
                xt = x + t * L
                yt = y + t * M
                zt = z + t * N
                s_val, gx, gy = _radial_grad(code, n_coeffs, coeffs[k], cvk,
                                             kk, xt, yt, True)
                f = s_val - zt
                fp = gx * L + gy * M - N
                fp = torch.where(torch.abs(fp) > _EPS, fp, eps)
                t = t - f / fp
        elif code != GEOM_PLANE and t.requires_grad:
            # a pure conic's closed-form root is exact, but its derivative
            # through the quadratic formula cancels (-B and sqrt(disc) agree
            # to many digits on a weak curve): as JAX's `for_grad` pass
            # does, detach the root and close the graph with one Newton
            # step, whose derivative is the implicit-function theorem's (the
            # backward kernels' `intersect_bwd`); the value moves by F / F',
            # below the dtype's eps
            t = t.detach()
            xt = x + t * L
            yt = y + t * M
            zt = z + t * N
            s_val, gx, gy = _radial_grad(code, 0, coeffs[k], cvk, kk, xt, yt,
                                         True)
            fp = gx * L + gy * M - N
            fp = torch.where(torch.abs(fp) > _EPS, fp, eps)
            t = t - (s_val - zt) / fp

        x = x + t * L
        y = y + t * M
        z = z + t * N
        opd = opd + torch.abs(t * n_pre)
        i = i * validf
        if static.has_absorption[k - 1]:
            # Beer-Lambert through the medium before this surface
            if w is None:
                alpha = alpha_table[k - 1]
            else:
                kv = _kv_interp(w, k_wl[k - 1], k_val[k - 1])
                alpha = 4.0 * math.pi * kv / w
            i = i * torch.exp(-alpha * t * 1e3)
        if static.has_aperture[k]:
            i = i * (x * x + y * y <= ap_radius[k] ** 2).to(i.dtype)

        interaction = static.interactions[k]
        if interaction != INT_NONE:
            if freeform:
                _, gx, gy = _geom.sag_and_grad(code, n_coeffs, x, y, cvk,
                                               conic[k], coeffs[k], aux_k)
            else:
                _, gx, gy = _radial_grad(code, n_coeffs, coeffs[k], cvk, kk,
                                         x, y, False)
            inv_mag = torch.rsqrt(gx * gx + gy * gy + 1.0)
            nx, ny, nz = gx * inv_mag, gy * inv_mag, -inv_mag
            if interaction == INT_THIN_LENS:
                n_post = n_of(k)
                L, M, N, opd = _thin_lens(L, M, N, x, y, opd,
                                          focal_length[k], n_pre, n_post)
                n_pre = n_post
            elif interaction == INT_DIFFRACT:
                n_post = n_of(k)
                mw = grating[k, 0] if w is None else grating[k, 0] * w
                L, M, N, i = _diffract(
                    code == GEOM_PLANE, static.is_reflective[k], mw,
                    grating[k, 1], grating[k, 2], L, M, N, i, nx, ny, nz, gx,
                    gy, n_pre, n_post)
                n_pre = n_post
            elif interaction == INT_PHASE:
                n_post = n_of(k)
                ik = (phase_params[k, 8] if w is None
                      else w * _INV_K0_PER_UM)
                L, M, N, i, opd = _phase_sheet(
                    static.phase_kinds[k], phase_params[k, :8],
                    static.is_reflective[k], ik, L, M, N, i, opd, x, y, nx,
                    ny, nz, n_pre, n_post)
                n_pre = n_post
            else:
                sgn = torch.sign(L * nx + M * ny + N * nz)
                nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
                if interaction == INT_REFLECT:
                    L, M, N = _reflect(L, M, N, nx, ny, nz)
                else:
                    n_post = n_of(k)
                    L, M, N, okf = _refract(L, M, N, nx, ny, nz,
                                            n_pre / n_post)
                    i = i * okf
                    n_pre = n_post
            if static.coatings[k] == COAT_SIMPLE:
                # fixed-R/T coating: R after a reflection, T after every
                # other interaction (a reflective grating's or phase
                # sheet's included)
                i = i * coating_params[k, 1 if interaction == INT_REFLECT
                                       else 0]

        if tilted:
            x, y, z, L, M, N = _rotate(x, y, z, L, M, N, (
                (torch.cos(rx), torch.sin(rx), "x"),
                (torch.cos(ry), torch.sin(ry), "y"),
                (torch.cos(rz), torch.sin(rz), "z")))
        z = z + pos_k
        if tilted or decentered:
            x = x + tx
            y = y + ty
        if record:
            records.append((x, y, z, L, M, N, i, opd))

    if record:
        return records
    return x, y, z, L, M, N, i, opd


def _moments_plain(static, diffp, nondiffp, rg, data):
    """Plain version of K1: (4,) = (sum i, sum x i, sum y i,
    sum (x^2+y^2) i) at the image surface. data = (Hx, Hy, Px, Py) at the
    tables' wavelength, or (Hx, Hy, Px, Py, w) at per-ray wavelengths (the
    raygen does not read w)."""
    _check_kernel_branches(static, "K1")
    rays8 = _tile_raygen(static, rg, *data[:4])
    x, y, _, _, _, _, i, _ = _tile_trace(static, diffp, nondiffp, *rays8,
                                         *data[4:])
    return torch.stack([torch.sum(i), torch.sum(x * i), torch.sum(y * i),
                        torch.sum((x * x + y * y) * i)])


def _raygen_trace_plain(static, diffp, nondiffp, rg, data, out_keys):
    """Plain version of K3: the `out_keys` subset of the final
    (x, y, z, L, M, N, i, opd); data as `_moments_plain`'s."""
    _check_kernel_branches(static, "K3")
    rays8 = _tile_raygen(static, rg, *data[:4])
    res = _tile_trace(static, diffp, nondiffp, *rays8, *data[4:])
    return tuple(res[k] for k in out_keys)


def _fused_trace_plain(static, diffp, nondiffp, rays):
    """Plain version of K5: the final (x, y, z, L, M, N, i, opd) of the
    caller's rays, (x, y, z, L, M, N, i, opd) at the tables' wavelength or
    (x, ..., opd, w) at per-ray wavelengths."""
    _check_kernel_branches(static, "K5")
    return _tile_trace(static, diffp, nondiffp, *rays)


def _history_plain(static, diffp, nondiffp, rays9):
    """Plain version of K7: the 8 (S, n) history arrays (x, y, z, L, M, N,
    i, opd) of the caller's rays9 = (x, y, z, L, M, N, i, opd, w), at the
    rays' own wavelengths; row 0 is the starting bundle."""
    _check_kernel_branches(static, "K7")
    recs = _tile_trace(static, diffp, nondiffp, *rays9, record=True)
    return tuple(torch.stack([r[j] for r in recs]) for j in range(8))


def _vjp(fn, args, grad_mask, seeds):
    """Autograd of `fn(*args)` (a tuple of tensors) against `seeds` (None
    is a zero seed): the cotangent of every arg where `grad_mask` holds,
    explicit zeros elsewhere and where an arg does not reach the output."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(m) for a, m in zip(args, grad_mask)]
        # an output that no arg reaches (i from the raygen) takes no seed
        pairs = [(o, torch.zeros_like(o) if s is None else s)
                 for o, s in zip(fn(*leaves), seeds, strict=True)
                 if o.requires_grad]
        wrt = [a for a in leaves if a.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [s for _, s in pairs],
            allow_unused=True) if pairs else [None] * len(wrt))
    res = []
    for a in leaves:
        g = next(grads) if a.requires_grad else None
        res.append(torch.zeros_like(a) if g is None else g)
    return res


def _moments_bwd_plain(static, diffp, nondiffp, rg, data, c, diff_data):
    """Plain version of K2: autograd of c . `_moments_plain`. Returns
    (d_rg, d_diffp, d_data), d_data one cotangent per data array (w's the
    5th at per-ray wavelengths), zeros without `diff_data`."""
    nd = len(diffp)
    g = _vjp(lambda rg_, *a: (_moments_plain(static, a[:nd], nondiffp, rg_,
                                             a[nd:]),),
             (rg, *diffp, *data), [True] * (1 + nd) + [diff_data] * len(data),
             (c,))
    return g[0], tuple(g[1:1 + nd]), tuple(g[1 + nd:])


def _raygen_trace_bwd_plain(static, diffp, nondiffp, rg, data, out_keys,
                            seeds):
    """Plain version of K4: autograd of `_raygen_trace_plain` against the
    per-ray `seeds` of `out_keys` (None = zero). Returns (d_rg, d_diffp,
    d_data)."""
    nd = len(diffp)
    g = _vjp(lambda rg_, *a: _raygen_trace_plain(static, a[:nd], nondiffp,
                                                 rg_, a[nd:], out_keys),
             (rg, *diffp, *data), [True] * (1 + nd + len(data)), seeds)
    return g[0], tuple(g[1:1 + nd]), tuple(g[1 + nd:])


def _fused_trace_bwd_plain(static, diffp, nondiffp, rays, seeds):
    """Plain version of K6: autograd of `_fused_trace_plain` against the 8
    per-ray `seeds` (None = zero). Returns (d_rays, d_diffp), a cotangent
    per ray array (w's the 9th at per-ray wavelengths)."""
    nd = len(diffp)
    g = _vjp(lambda *a: _fused_trace_plain(static, a[:nd], nondiffp, a[nd:]),
             (*diffp, *rays), [True] * (nd + len(rays)), seeds)
    return tuple(g[nd:]), tuple(g[:nd])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # n, S, blocks, rg, ftab, Hx, Hy, Px, Py, partials (blocks, 4), stream;
    # the system's codes are the variant's (`system_defines`), as for K3, K5
    "moments_fwd": [_I] * 3 + [_P] * 8,
    # n, S, n_newton, field_angle, object_infinite, blocks, threads,
    # diff_data, rg, ftab, itab, Hx, Hy, Px, Py, c, partials (blocks, S + 1,
    # 32), dHx, dHy, dPx, dPy (NULL without diff_data), stream
    "moments_bwd": [_I] * 8 + [_P] * 14,
    # n, S, blocks, out_mask, rg, ftab, Hx, Hy, Px, Py, 8 output pointers
    # (NULL = not requested), stream
    "raygen_trace_fwd": [_I] * 4 + [_P] * 15,
    # n, S, n_newton, field_angle, object_infinite, blocks, threads, rg,
    # ftab, itab, Hx, Hy, Px, Py, 8 seed pointers (NULL = zero seed),
    # partials (blocks, S + 1, 32), dHx, dHy, dPx, dPy, stream
    "raygen_trace_bwd": [_I] * 7 + [_P] * 21,
    # n, S, blocks, ftab, 8 ray pointers, 8 output pointers, stream
    "fused_trace_fwd": [_I] * 3 + [_P] * 18,
    # n, S, n_newton, blocks, threads, ftab, itab, 8 ray pointers, 8 seed
    # pointers (NULL = zero seed), partials (blocks, S, 32), 8 cotangent
    # pointers, stream
    "fused_trace_bwd": [_I] * 5 + [_P] * 28,
    # n, S, blocks, bulk (`history_bulk`), mat_w, K, ftab, mat_coeffs
    # (S, mat_w), k_wl and k_val (S, K), 9 ray pointers (x .. opd, w), 8
    # history pointers (S, n each), stream; the codes, the media's
    # included, are the variant's (`history_defines`)
    "history_fwd": [_I] * 6 + [_P] * 22,
    # the per-ray variants (`_kernel(..., per_ray=True)`): the uniform
    # signature with mat_w and K after its int arguments, the material rows
    # and extinction tables (mat, k_wl, k_val) after the tables, and w
    # after the per-ray inputs; a backward adds w's cotangent after the
    # others and the tabulated glasses' per-ray segments and cotangents
    # (`_tabulated_outputs`) before the stream
    "moments_fwd_w": [_I] * 5 + [_P] * 12,
    "raygen_trace_fwd_w": [_I] * 6 + [_P] * 19,
    "fused_trace_fwd_w": [_I] * 5 + [_P] * 22,
    "moments_bwd_w": [_I] * 10 + [_P] * 21,
    "raygen_trace_bwd_w": [_I] * 9 + [_P] * 28,
    "fused_trace_bwd_w": [_I] * 7 + [_P] * 35,
}


@lru_cache(maxsize=None)
def _kernel(name: str, defines=(), per_ray: bool = False):
    """The C entry point `name` of csrc/<name>.cu, built on first use; with
    `defines`, of the variant built with them; `per_ray`, its per-ray
    entry `<name>_w` (a variant with the media's codes)."""
    from optiland_tpu_torch import _build

    lib = (_build.variant(name, defines) if defines
           else _build.library(name))
    entry = f"{name}_w" if per_ray else name
    fn = getattr(lib, entry)
    fn.argtypes = _SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def _coated(static: SystemStatic, k: int) -> bool:
    """Whether surface k applies a simple coating's factor (an interacting
    surface with COAT_SIMPLE)."""
    return (static.coatings[k] == COAT_SIMPLE
            and static.interactions[k] != INT_NONE)


def _reflective_sheet(static: SystemStatic, k: int) -> bool:
    """Whether surface k is a grating or a phase sheet on a mirror (the
    reflective flag of csrc/chain.cuh; a plain mirror is INT_REFLECT)."""
    return (static.interactions[k] in (INT_DIFFRACT, INT_PHASE)
            and bool(static.is_reflective[k]))


def _phase_kind(static: SystemStatic, k: int) -> int:
    """Surface k's phase kind where it is a phase sheet, else 0."""
    return static.phase_kinds[k] if static.interactions[k] == INT_PHASE else 0


def branch_defines(static: SystemStatic) -> tuple:
    """OTK_INTERACTIONS where the system has a simple coating, a thin lens,
    a grating or a phase sheet: the definition that compiles those branches
    of the chain and of its reverse sweep (csrc/chain.cuh,
    csrc/chain_bwd.cuh) and the coating's intensity cotangent in the
    record; OTK_PHASE where it has a phase sheet, which adds the phase
    branch and its adjoint and each surface's phase kind to its codes;
    OTK_FREEFORM, the mask of its freeform families (`_freeform_mask`),
    where it has one: their sag, Newton and adjoint (csrc/freeform.cuh),
    their aux ints and Newton count in the int table, and with a Forbes
    Q-2D surface its terms' tables (`_q2d_defines`); and where a surface
    has more than 17 coefficient slots, the wide rows (`_wide_defines`). A
    system without them builds the code without those branches, as it was
    before them."""
    phase = INT_PHASE in static.interactions
    new = (any(_coated(static, k) for k in range(static.num_surfaces))
           or INT_THIN_LENS in static.interactions
           or INT_DIFFRACT in static.interactions or phase)
    ff = _freeform_mask(static)
    return ((("OTK_INTERACTIONS", "1"),) if new else ()) + (
        (("OTK_PHASE", "1"),) if phase else ()) + (
        (("OTK_FREEFORM", f"0x{ff:x}u"),) if ff else ()) + (
        _q2d_defines(static) + _wide_defines(static))


def _freeform_mask(static: SystemStatic) -> int:
    """The bit 1 << code of each freeform family the system has (of
    _KERNEL_FREEFORMS), 0 without one."""
    return sum(1 << g for g in set(static.geom_codes)
               if g in _KERNEL_FREEFORMS)


def _freeform_aux(static: SystemStatic, k: int) -> tuple[int, int]:
    """Surface k's two aux ints as the chain reads them: a Chebyshev's
    (rows, cols), a Zernike's (type code, 0), a Forbes Q-2D's range of
    groups in the system's Q-2D tables (`_q2d_tables`), else (0, 0)."""
    if static.geom_codes[k] == GEOM_FORBES_Q2D:
        return _q2d_tables(static)[2][k]
    aux = tuple(static.geom_aux[k]) if static.geom_codes[k] in (
        GEOM_CHEBYSHEV, GEOM_ZERNIKE) else ()
    return (tuple(int(a) for a in aux) + (0, 0))[:2]


def _f32(x) -> str:
    """A float constant for the device code: the double rounded once to
    float there (a host build in double keeps it whole)."""
    return f"static_cast<float>({float(x)!r})"


@lru_cache(maxsize=64)
def _q2d_tables(static: SystemStatic):
    """The Forbes Q-2D terms of the system's Q-2D surfaces as the chain
    reads them (csrc/freeform.cuh `Q2DGroup`, `Q2DRow`): (groups, rows,
    {k: (first group, end)}, one more than the highest n), or None without
    a Q-2D surface (one without terms has no group; a system of such
    surfaces alone has one group of n = 0 and no slot, which none reads). A surface's terms (its `geom_aux`, (n, signed m) for
    coefficient slot 1 + i: m > 0 a cosine term, m < 0 a sine term) form
    groups, the radial terms (m = 0) first, then each |m| ascending,
    cosine before sine, as `geometry/surfaces._forbes_q2d_sag` sums them
    (a term given twice takes its last slot, as there); a group is (m,
    ntop, first row) and has a row per n <= ntop: (slot or -1, and the
    constants of `geometry/forbes.py` in float64, which the build rounds
    once to float: f_n, g_n (n < ntop) and h_n (n < ntop - 1) of the
    radial sum, or f_n, g_n (n < ntop), a_n and b_n (n < ntop) and
    c_(n+1) (n < ntop - 1) of the azimuthal ones; the others 0)."""
    from optiland_tpu_torch.geometry import forbes as fb

    groups, rows, ranges = [], [], {}
    for k in range(static.num_surfaces):
        if static.geom_codes[k] != GEOM_FORBES_Q2D:
            continue
        by_m = {}
        for i, (n, ms) in enumerate(static.geom_aux[k]):
            by_m.setdefault(int(ms), {})[int(n)] = 1 + i
        g0 = len(groups)
        for m in sorted(by_m, key=lambda m: (abs(m), m < 0)):
            terms, am = by_m[m], abs(m)
            ntop = max(terms)
            groups.append((m, ntop, len(rows)))
            for n in range(ntop + 1):
                f, g, a, b, c = fb._f_qbfs(n) if am == 0 else fb._f_q2d(
                    n, am), 0.0, 0.0, 0.0, 0.0
                if am == 0:
                    g = fb._g_qbfs(n) if n < ntop else 0.0
                    a = fb._h_qbfs(n) if n < ntop - 1 else 0.0
                else:
                    if n < ntop:
                        g = fb._g_q2d(n, am)
                        a, b, _ = fb._abc_q2d(n, am)
                    if n < ntop - 1:
                        c = fb._abc_q2d(n + 1, am)[2]
                rows.append((terms.get(n, -1), f, g, a, b, c))
        ranges[k] = (g0, len(groups))
    if not ranges:
        return None
    if not groups:
        groups, rows = [(0, 0, 0)], [(-1, 1.0, 0.0, 0.0, 0.0, 0.0)]
    return (tuple(groups), tuple(rows), ranges,
            1 + max(ntop for _, ntop, _ in groups))


def _q2d_defines(static: SystemStatic) -> tuple:
    """OTK_Q2D_GROUPS, OTK_Q2D_ROWS and OTK_Q2D_NMAX of a system with a
    Forbes Q-2D surface (`_q2d_tables`), else nothing."""
    tables = _q2d_tables(static)
    if tables is None:
        return ()
    groups, rows, _, nmax = tables
    return (("OTK_Q2D_GROUPS", ", ".join(
                "{%d, %d, %d}" % g for g in groups)),
            ("OTK_Q2D_ROWS", ", ".join(
                "{%d, %s}" % (r[0], ", ".join(_f32(v) for v in r[1:]))
                for r in rows)),
            ("OTK_Q2D_NMAX", str(nmax)))


def _wide(static: SystemStatic, k: int) -> bool:
    """Whether surface k has more coefficient slots than a table row holds
    (MAX_GEOM_COEFFS) on a geometry that reads them."""
    return (static.geom_n_coeffs[k] > MAX_GEOM_COEFFS
            and static.geom_codes[k] not in (GEOM_PLANE, GEOM_CONIC))


@lru_cache(maxsize=64)
def _wide_layout(static: SystemStatic):
    """Where the float table keeps the rows of the wide surfaces (`_wide`):
    (the widest one's slots, each surface's offset of its whole row from
    the table's start (0 for the others), each surface's first wide row of
    cotangents (csrc/chain_bwd.cuh `put_wide_rows`), the floats of the
    table's tail, the wide rows), or None without a wide surface. The tail
    follows the S rows of _F_STRIDE floats, the wide surfaces' rows in
    surface order; a surface of nc slots takes ceil((nc - 17) / 32) wide
    rows, in surface order."""
    S = static.num_surfaces
    wide = [k for k in range(S) if _wide(static, k)]
    if not wide:
        return None
    off, xrow = [0] * S, [0] * S
    floats = rows = 0
    for k in wide:
        nc = static.geom_n_coeffs[k]
        off[k], xrow[k] = S * _F_STRIDE + floats, rows
        floats += nc
        rows += -(-(nc - MAX_GEOM_COEFFS) // _F_STRIDE)
    return (max(static.geom_n_coeffs[k] for k in wide), tuple(off),
            tuple(xrow), floats, rows)


def _table_floats(static: SystemStatic) -> int:
    """The floats of the system's float table: S rows and the wide
    surfaces' tail (csrc/chain.cuh OTK_FT_FLOATS)."""
    lay = _wide_layout(static)
    return static.num_surfaces * _F_STRIDE + (lay[3] if lay else 0)


@lru_cache(maxsize=None)
def _wide_tables(co_max: int) -> tuple:
    """The freeform tables of a build whose surfaces take up to `co_max`
    coefficient slots (csrc/freeform.cuh under OTK_WIDE), as definitions:
    the Q-bfs constants f_n, g_n, h_n of `geometry/forbes.py` for n <
    co_max - 1 (0 where no sum reads them), and for each Zernike convention
    (fringe, noll, standard) its first co_max - 1 terms' m and radial
    polynomials R_n^m / rho^|m| in rho^2, highest power first, times the
    convention's norm, padded in front with zeros to ZR coefficients; ZM
    bounds |m|."""
    from optiland_tpu_torch import zernike as zk
    from optiland_tpu_torch.geometry import forbes as fb

    T = co_max - 1
    terms = {kind: zk.indices(kind, T) for kind in ("fringe", "noll",
                                                     "standard")}
    ZR = max([4] + [(n - abs(m)) // 2 + 1 for idx in terms.values()
                    for n, m in idx])
    ZM = max([6] + [abs(m) + 1 for idx in terms.values() for _, m in idx])

    def radial(kind, n, m):
        am = abs(m)
        d = (n - am) // 2
        c = [(-1) ** j * math.factorial(n - j)
             / (math.factorial(j) * math.factorial((n + am) // 2 - j)
                * math.factorial(d - j)) for j in range(d + 1)]
        norm = zk._norm_constant(kind, n, m)
        return [0.0] * (ZR - d - 1) + [norm * v for v in c]

    def floats(vals):
        return ", ".join(_f32(v) for v in vals)

    return (("OTK_WIDE_ZR", str(ZR)), ("OTK_WIDE_ZM", str(ZM)),
            ("OTK_WIDE_QBFS_F", floats(fb._f_qbfs(n) for n in range(T))),
            ("OTK_WIDE_QBFS_G", floats(fb._g_qbfs(n) if n < T - 1 else 0.0
                                       for n in range(T))),
            ("OTK_WIDE_QBFS_H", floats(fb._h_qbfs(n) if n < T - 2 else 0.0
                                       for n in range(T))),
            ("OTK_WIDE_ZERNIKE_M", ", ".join(
                "{%s}" % ", ".join(str(m) for _, m in idx)
                for idx in terms.values())),
            ("OTK_WIDE_ZERNIKE_RADIAL", ", ".join(
                "{%s}" % ", ".join("{%s}" % floats(radial(kind, n, m))
                                   for n, m in idx)
                for kind, idx in terms.items())))


def _wide_defines(static: SystemStatic) -> tuple:
    """The definitions of a system with a wide surface (`_wide_layout`):
    OTK_WIDE, the widest surface's slots; OTK_WIDE_FLOATS and
    OTK_WIDE_ROWS, the table's tail and the wide rows; OTK_WIDE_OFF, each
    surface's offset of its row in the table (0: in its own row), and
    OTK_WIDE_NC, each surface's slots (the packed codes hold 255 at most);
    and the freeform tables at that width (`_wide_tables`). Else
    nothing."""
    lay = _wide_layout(static)
    if lay is None:
        return ()
    co_max, off, _, floats, rows = lay
    return (("OTK_WIDE", str(co_max)), ("OTK_WIDE_FLOATS", str(floats)),
            ("OTK_WIDE_ROWS", str(rows)),
            ("OTK_WIDE_OFF", ", ".join(str(o) for o in off)),
            ("OTK_WIDE_NC", ", ".join(str(nc)
                                      for nc in static.geom_n_coeffs))
            ) + _wide_tables(co_max)


def system_defines(static: SystemStatic) -> tuple:
    """The nvcc definitions ((macro, value), ...) of the per-system kernels'
    variants (K1, K3, K5; K7's add `history_defines`) for this system: S,
    the Newton updates, the field and object codes, and each surface's
    geometry code, coefficient count, interaction, and tilt, decenter,
    aperture and absorption flags (the medium after it), a coated
    surface's flag, a reflective grating's and a phase sheet's kind, packed
    as csrc/system_chain.cuh `unpack_codes` reads them, then
    `branch_defines`, and with a freeform the freeforms' Newton updates
    (OTK_NEWTON_FF) and each surface's aux ints (OTK_FF_AUX, aux0 | aux1
    << 8, `_freeform_aux`). Values (curvatures, thicknesses, indices, ...) are
    not codes: they reach the kernel in the float table, so one build
    serves every value of a system."""
    packed = (
        static.geom_codes[k] | (static.geom_n_coeffs[k] & 0xff) << 8
        | static.interactions[k] << 16 | int(static.has_tilt[k]) << 20
        | int(static.has_decenter[k]) << 21
        | int(static.has_aperture[k]) << 22
        | int(static.has_absorption[k]) << 23
        | int(_coated(static, k)) << 24
        | int(_reflective_sheet(static, k)) << 25
        | _phase_kind(static, k) << 26
        for k in range(static.num_surfaces))
    ff = ()
    if _freeform_mask(static):
        ff = (("OTK_NEWTON_FF",
               str(min(static.newton_iters, _NEWTON_FUSED_MAX_FF))),
              ("OTK_FF_AUX", ", ".join(
                  "0x{:x}u".format(a0 | a1 << 8) for a0, a1 in (
                      _freeform_aux(static, k)
                      for k in range(static.num_surfaces)))))
    return (("OTK_S", str(static.num_surfaces)),
            ("OTK_NEWTON", str(min(static.newton_iters, _NEWTON_FUSED_MAX))),
            ("OTK_FIELD_ANGLE", str(int(static.field_type == "angle"))),
            ("OTK_OBJECT_INFINITE", str(int(static.object_infinite))),
            ("OTK_SURFACES", ", ".join(f"0x{c:x}u" for c in packed))
            ) + branch_defines(static) + ff


def media_defines(static: SystemStatic) -> tuple:
    """OTK_MATERIALS, the dispersion formula and coefficient count of the
    medium after each surface ({formula, count} pairs, as csrc/chain.cuh
    `material_codes` reads them), so that each medium's `material_index`
    and its adjoint unroll: the definitions of the per-ray variants of the
    backward kernels K2, K4 and K6, whose chain reads the system's codes
    from the int table at run time."""
    media = ", ".join(f"{{{f}, {nc}}}" for f, nc in zip(
        static.mat_formulas, static.mat_n_coeffs))
    return (("OTK_MATERIALS", media),)


def backward_defines(static: SystemStatic, per_ray: bool) -> tuple:
    """The nvcc definitions of the backward kernels K2, K4 and K6 for this
    system, whose chain reads the system's codes from the int table at run
    time: `media_defines` at per-ray wavelengths, then `branch_defines`,
    and past 64 surfaces OTK_MAX_SURFACES, the surfaces the one-wavelength
    kernels' per-thread record holds: the power of two that holds the
    system. Empty (the library built once) at one wavelength for a system
    of at most 64 surfaces without the coating, thin-lens, grating, phase
    and freeform branches."""
    S = static.num_surfaces
    long = (("OTK_MAX_SURFACES", str(1 << (S - 1).bit_length())),
            ) if S > _MAX_SURFACES else ()
    return ((media_defines(static) if per_ray else ())
            + branch_defines(static) + long)


def history_defines(static: SystemStatic) -> tuple:
    """The nvcc definitions of K7 and of the per-ray variants of K1, K3 and
    K5 for this system: `system_defines` and `media_defines`. At one
    wavelength K1, K3 and K5 read the tables and take `system_defines`
    alone."""
    return system_defines(static) + media_defines(static)


@lru_cache(maxsize=None)
def _blocks_per_sm(source: str, defines) -> int:
    """Blocks of the per-system kernel `source` that fit one SM at once,
    from its variant's occupancy query (`<source>_blocks_per_sm`)."""
    from optiland_tpu_torch import _build

    query = getattr(_build.variant(source, defines), f"{source}_blocks_per_sm")
    per_sm = query()
    if per_sm < 1:
        raise RuntimeError(f"{source} occupancy query failed: {per_sm}")
    return per_sm


def system_grid(n: int, n_sm: int, per_sm: int) -> int:
    """Blocks of a per-system kernel (K1, K3, K5, K7) over n rays on a card
    of `n_sm` SMs, of which each holds `per_sm` of its blocks at once. Each
    block walks tiles of _SYSTEM_THREADS rays. Where an SM holds
    _TILE_GRID_BLOCKS_PER_SM or more, a block a tile, which the card
    schedules as blocks end; where it holds fewer, a persistent grid of at
    most `n_sm * per_sm` blocks, each staging the table once. On an H100 at
    2M rays a block a tile was 6% faster for K3 at 6 blocks an SM, and 2-15%
    slower for K1 and K5 at 2 or 3 (PERF.md)."""
    tiles = max(1, -(-n // _SYSTEM_THREADS))
    if per_sm >= _TILE_GRID_BLOCKS_PER_SM:
        return tiles
    return min(tiles, n_sm * per_sm)


def _system_blocks(source: str, defines, n: int, device) -> int:
    """`system_grid` for the per-system variant of `source` on `device`."""
    return system_grid(n, config.sm_count(device),
                       _blocks_per_sm(source, defines))


def history_bulk(S: int, n: int, l2_bytes: int) -> bool:
    """Whether K7 sends the history of n rays through a system of S
    surfaces by bulk copies from shared memory (its full tiles' rows, 1 KB
    each) rather than one float a thread: where the rows do not start on
    32-byte sectors (n not a multiple of 8), so that a warp's 128-byte
    stores leave part-written sectors at both ends, and the 8 (S, n)
    float32 arrays outgrow the card's L2 cache of `l2_bytes`, so that
    those sectors reach device memory part-written. On an H100, on the
    Cooke triplet, bulk copies took 2M rays from 0.284 to 0.248 ms and
    1M from 0.148 to 0.136 with misaligned rows, while with aligned rows one
    float a thread was 5-10% faster from 262,144 rays to 2M (PERF.md)."""
    return n % 8 != 0 and 8 * 4 * S * n > l2_bytes


def backward_grid(n: int, n_sm: int) -> tuple[int, int]:
    """(blocks, threads) of the persistent grid of K2, K4 and K6 over n rays
    on a card of `n_sm` SMs. Each block walks tiles of `threads` rays and
    writes one partial row set. A small batch takes the smallest block of
    _BWD_MIN_THREADS, twice or four times that whose tiles fit one to an SM,
    so that it spreads over as many SMs as it can fill; a larger one takes
    blocks of _BWD_THREADS, one an SM, each walking its tiles. (On an H100,
    16,384 rays ran fastest in 128-thread tiles, 65,536 in 512-thread ones:
    more rounds of smaller tiles cost more than an idle SM; PERF.md.)"""
    threads = _BWD_MIN_THREADS
    while threads < _BWD_THREADS and -(-n // threads) > n_sm:
        threads *= 2
    return min(-(-n // threads), n_sm), threads


@lru_cache(maxsize=64)
def _int_table(static: SystemStatic, device: torch.device):
    """The (S, 16) int table of static codes of the run-time chain (K2, K4,
    K6), in the slot order of csrc/chain.cuh (I_* there); row k's
    absorption flag is that of the medium after surface k, and a freeform
    surface's row holds its aux ints (`_freeform_aux`) and Newton updates
    in slots 10-12 (I_AUX0, I_AUX1, I_NEWTON_FF there), and a wide
    surface's its row's offset in the float table and its first wide row
    (`_wide_layout`) in slots 13-14 (I_XOFF, I_XROW)."""
    n_ff = min(static.newton_iters, _NEWTON_FUSED_MAX_FF)
    S = static.num_surfaces
    lay = _wide_layout(static)
    off, xrow = (lay[1], lay[2]) if lay else ((0,) * S, (0,) * S)
    rows = [[static.geom_codes[k], static.geom_n_coeffs[k],
             static.interactions[k], int(static.has_tilt[k]),
             int(static.has_decenter[k]), int(static.has_aperture[k]),
             int(static.has_absorption[k]), int(_coated(static, k)),
             int(_reflective_sheet(static, k)), _phase_kind(static, k),
             *_freeform_aux(static, k),
             n_ff if static.geom_codes[k] in _KERNEL_FREEFORMS else 0,
             off[k], xrow[k]]
            + [0] * (_I_STRIDE - 15) for k in range(S)]
    return torch.tensor(rows, dtype=torch.int32).to(device)


@lru_cache(maxsize=64)
def _surface_masks(static: SystemStatic, device: torch.device):
    """(S, 1) bool columns on `device`: thin-lens surfaces, gratings, coated
    surfaces (`_coated`), coated mirrors (whose factor is R) and phase
    sheets."""
    S = static.num_surfaces

    def col(pred):
        return torch.tensor([[pred(k)] for k in range(S)], device=device)

    return (col(lambda k: static.interactions[k] == INT_THIN_LENS),
            col(lambda k: static.interactions[k] == INT_DIFFRACT),
            col(lambda k: _coated(static, k)),
            col(lambda k: _coated(static, k)
                and static.interactions[k] == INT_REFLECT),
            col(lambda k: static.interactions[k] == INT_PHASE))


def _pack_tables(static: SystemStatic, diffp, nondiffp, per_ray: bool):
    """The per-surface float table (S, 32) in the slot layout of
    csrc/chain.cuh, in the parameters' dtype, and the (S, 16) int table of
    static codes, for a launch at one wavelength or (`per_ray`) at each
    ray's own. A thin lens's focal length, a grating's row (m w at one
    wavelength, m at per-ray wavelengths; d; the groove angle) and a phase
    sheet's 8 profile slots and 1 / k0 (at one wavelength the hoisted 9th
    column of `_uniform_phase`, at per-ray wavelengths 1 / k0 per um) take
    the first coefficient slots, and a coated surface's factor slot
    _F_COAT. A phase table of the other configuration's width raises.
    With a wide surface (`_wide_layout`) the float table is flat: the S
    rows, then each wide surface's whole coefficient row."""
    (cv, conic, coeffs, thickness, tilt, decenter, _mat, coating_params,
     n_table, grating, phase, focal_length) = diffp
    ap_radius, _k_wl, _k_val, alpha_table = nondiffp
    S = static.num_surfaces
    co = coeffs[:, :MAX_GEOM_COEFFS]
    if co.shape[1] < MAX_GEOM_COEFFS:
        co = torch.nn.functional.pad(co, (0, MAX_GEOM_COEFFS - co.shape[1]))
    coat = coating_params[:, :1]   # not read without OTK_INTERACTIONS
    if branch_defines(static):
        thin, grat, coated, coated_mirror, sheet = _surface_masks(static,
                                                                  cv.device)
        lead = torch.where(grat, grating, co[:, :3])
        lead = torch.where(thin, torch.nn.functional.pad(
            focal_length[:, None], (0, 2)), lead)
        co = torch.cat([lead, co[:, 3:]], dim=1)
        if INT_PHASE in static.interactions:
            if phase.shape[1] != (8 if per_ray else 9):
                raise ValueError(
                    f"phase_params of width {phase.shape[1]}: a launch at "
                    + ("per-ray wavelengths takes the 8 profile slots"
                       if per_ray else "one wavelength takes the 8 profile "
                       "slots and the hoisted 1 / k0 (`_uniform_params`)"))
            if per_ray:
                phase = torch.nn.functional.pad(phase, (0, 1),
                                                value=_INV_K0_PER_UM)
            co = torch.where(sheet, torch.nn.functional.pad(
                phase, (0, MAX_GEOM_COEFFS - 9)), co)
        coat = torch.where(coated, torch.where(
            coated_mirror, coating_params[:, 1:2], coat),
            torch.zeros_like(coat))
    col = [cv[:, None], conic[:, None], co, thickness[:, None], tilt,
           decenter, n_table[:, None], alpha_table[:, None],
           ap_radius[:, None], coat]
    used = sum(c.shape[1] for c in col)
    col.append(torch.zeros((S, _F_STRIDE - used), dtype=cv.dtype,
                           device=cv.device))
    ftab = torch.cat(col, dim=1).contiguous()
    if _wide_layout(static):
        ftab = torch.cat([ftab.reshape(-1)] + [
            coeffs[k, :static.geom_n_coeffs[k]] for k in range(S)
            if _wide(static, k)])
    return ftab, _int_table(static, cv.device)


def _unpack_table_grads(static, tab, diffp, d_mat=None, wide=None):
    """The (S, 32) table cotangents of a backward kernel as the 12
    `_diff_params` cotangents: cv, conic, coeffs (cut back or padded with
    zeros to its width; zeros on thin lenses, gratings and phase sheets,
    whose slots hold their own; a wide surface's slots past 17 from its
    rows of `wide`, the kernel's wide rows, `_wide_layout`), thickness,
    tilt, decenter and n_table from their slots; focal_length, grating and
    phase_params from a thin lens's, a grating's and a phase sheet's first
    coefficient slots (the grating's m w and, with the hoisted 9th column,
    the sheet's 1 / k0 at one wavelength: autograd through
    `_uniform_grating` and `_uniform_phase` takes them to m and w);
    coating_params' T or R from a coated surface's factor slot; `d_mat`
    for mat_coeffs at per-ray wavelengths (at one wavelength the n_table
    slot's cotangent reaches mat_coeffs by autograd through
    `_uniform_tables`)."""
    coeffs = diffp[2]
    nco = coeffs.shape[1]
    co = tab[:, _F_COEFFS:_F_COEFFS + min(nco, MAX_GEOM_COEFFS)]
    slots = {0: tab[:, 0], 1: tab[:, 1], 3: tab[:, _F_THICK],
             4: tab[:, _F_TILT:_F_TILT + 3], 5: tab[:, _F_DEC:_F_DEC + 2],
             8: tab[:, _F_NTAB]}
    if branch_defines(static):
        thin, grat, coated, coated_mirror, sheet = _surface_masks(static,
                                                                  tab.device)
        co = torch.where(thin | grat | sheet, torch.zeros_like(co), co)
        width = diffp[10].shape[1]   # 9 with the hoisted 1 / k0
        slots[10] = torch.where(sheet, tab[:, _F_PHASE:_F_PHASE + width],
                                torch.zeros_like(tab[:, :width]))
        zero = torch.zeros_like(tab[:, :1])
        coat = torch.where(coated, tab[:, _F_COAT:_F_COAT + 1], zero)
        slots[7] = torch.cat([torch.where(coated_mirror, zero, coat),
                              torch.where(coated_mirror, coat, zero)]
                             + [zero] * (diffp[7].shape[1] - 2), dim=1)
        slots[9] = torch.where(grat, tab[:, _F_GRATING:_F_GRATING + 3],
                               torch.zeros_like(tab[:, :3]))
        slots[11] = torch.where(thin[:, 0], tab[:, _F_FOCAL],
                                torch.zeros_like(tab[:, 0]))
    if nco > MAX_GEOM_COEFFS:
        rest = [torch.zeros(nco - MAX_GEOM_COEFFS, dtype=tab.dtype,
                            device=tab.device)] * static.num_surfaces
        lay = _wide_layout(static)
        for k in range(static.num_surfaces):
            if wide is not None and _wide(static, k):
                extra = static.geom_n_coeffs[k] - MAX_GEOM_COEFFS
                got = wide[lay[2][k]:].reshape(-1)[:extra]
                rest[k] = torch.nn.functional.pad(
                    got, (0, nco - MAX_GEOM_COEFFS - extra))
        co = torch.cat([co, torch.stack(rest)], dim=1)
    slots[2] = co
    if d_mat is not None:
        slots[6] = d_mat
    return tuple(slots[j].to(p.dtype).reshape(p.shape) if j in slots
                 else torch.zeros_like(p) for j, p in enumerate(diffp))


def _check_arrays(named, dev):
    """Every (name, tensor) float32, contiguous, on `dev`, and the per-ray
    ones (all but rg and the tables) of one shape (n,). Returns n."""
    for name, a in named:
        if a.device != dev or a.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    per_ray = [a for name, a in named
               if name not in ("rg", "tables", "mat_coeffs", "k_wl", "k_val")]
    n = per_ray[0].shape[0] if per_ray else 0
    if any(a.shape != (n,) for a in per_ray):
        raise ValueError("expected (n,) per-ray arrays of one length")
    return n


def _media_args(static, diffp, nondiffp, per_ray):
    """The media arguments of a per-ray kernel: ([mat_w, K], the pointers
    of the material rows (S, mat_w) and the extinction tables k_wl, k_val
    (S, K), checked, and those tensors, to keep alive until the launch is
    enqueued); empty lists at one wavelength. The rows go to the kernel
    whole: a tabulated glass's row is as wide as its table."""
    if not per_ray:
        return [], [], ()
    wide = [k for k in range(static.num_surfaces)
            if static.mat_formulas[k] != FORMULA_TABULATED
            and static.mat_n_coeffs[k] > _MAT_SHARED]
    if wide:
        raise ValueError(f"surfaces {wide}: a dispersion formula with more "
                         f"than {_MAT_SHARED} coefficients")
    mat = diffp[6].contiguous()
    k_wl, k_val = nondiffp[1].contiguous(), nondiffp[2].contiguous()
    _check_arrays([("mat_coeffs", mat), ("k_wl", k_wl), ("k_val", k_val)],
                  mat.device)
    return ([mat.shape[1], k_wl.shape[1]],
            [mat.data_ptr(), k_wl.data_ptr(), k_val.data_ptr()],
            (mat, k_wl, k_val))


def _launch_args(static, rg, diffp, nondiffp, data, kernel):
    """Tables and checked pointers of the raygen kernels (K1-K4): data =
    (Hx, Hy, Px, Py), or (Hx, Hy, Px, Py, w) at per-ray wavelengths."""
    _check_kernel_branches(static, kernel)
    if len(data) not in (4, 5) or rg.shape != (5,):
        raise ValueError("expected four (n,) ray arrays (five with w) and a "
                         "(5,) rg")
    ftab, itab = _pack_tables(static, diffp, nondiffp, len(data) == 5)
    n = _check_arrays([("rg", rg), ("tables", ftab)] + list(
        zip(("Hx", "Hy", "Px", "Py", "w"), data)), rg.device)
    head = [n, static.num_surfaces,
            min(static.newton_iters, _NEWTON_FUSED_MAX),
            int(static.field_type == "angle"), int(static.object_infinite)]
    ptrs = [rg.data_ptr(), ftab.data_ptr(), itab.data_ptr()] + [
        d.data_ptr() for d in data]
    # the caller holds (ftab, itab) until the launch is enqueued: freed
    # earlier, their blocks could be handed to the outputs it allocates
    return n, head, ptrs, (ftab, itab)


def _caller_ray_args(static, diffp, nondiffp, rays, kernel):
    """Tables and checked pointers of the caller-ray kernels (K5, K6): rays
    = (x, y, z, L, M, N, i, opd), or with w at per-ray wavelengths."""
    _check_kernel_branches(static, kernel)
    if len(rays) not in (8, 9):
        raise ValueError("expected the 8 ray arrays x, y, z, L, M, N, i, opd "
                         "(9 with w)")
    ftab, itab = _pack_tables(static, diffp, nondiffp, len(rays) == 9)
    n = _check_arrays([("tables", ftab)] + list(zip(_RAY_KEYS, rays)),
                      ftab.device)
    head = [n, static.num_surfaces,
            min(static.newton_iters, _NEWTON_FUSED_MAX)]
    ptrs = [ftab.data_ptr(), itab.data_ptr()] + [r.data_ptr() for r in rays]
    return n, head, ptrs, (ftab, itab)


def _seed_ptrs(seeds, n, dev):
    """Seeds as float32 contiguous (n,) tensors on `dev` and their pointers;
    None stays None (a zero seed, a NULL pointer)."""
    out = []
    for j, s in enumerate(seeds):
        if s is not None:
            s = s.to(device=dev, dtype=torch.float32).contiguous()
            if s.shape != (n,):
                raise ValueError(f"seed {j}: expected shape ({n},), got "
                                 f"{tuple(s.shape)}")
        out.append(s)
    return out, [None if s is None else s.data_ptr() for s in out]


def _backward_launch(static, n, dev, n_rows, per_ray):
    """(blocks, threads) of a backward kernel over n rays, its (blocks,
    rows, 32) partial buffer and, at per-ray wavelengths, the tabulated
    glasses' outputs (`_tabulated_outputs`). A block keeps `n_rows` table
    and raygen rows, at per-ray wavelengths a material row per medium, and
    a system's wide rows (`_wide_layout`) last, and takes fewer threads
    where they would outgrow a block's shared memory (csrc/chain_bwd.cuh
    MAX_DYN_SMEM: 64 surfaces at 512 threads per ray, 128 at 256); a
    system that outgrows it at 32 threads is refused by name."""
    S = static.num_surfaces
    blocks, threads = backward_grid(n, config.sm_count(dev))
    lay = _wide_layout(static)
    rows = n_rows + (S if per_ray else 0) + (lay[4] if lay else 0)

    def smem(t):   # csrc/chain_bwd.cuh bwd_smem_bytes, bwd_w_smem_bytes
        return 4 * (S * (_F_STRIDE + _I_STRIDE + 2
                         + (_MAT_SHARED if per_ray else 0))
                    + _table_floats(static) - S * _F_STRIDE + 8
                    + t // 32 * rows * _F_STRIDE)

    while threads > 32 and smem(threads) > _MAX_SMEM:
        threads //= 2
        blocks = min(-(-n // threads), config.sm_count(dev))
    if smem(threads) > _MAX_SMEM:
        raise ValueError(
            f"a {S}-surface system's backward block needs {smem(threads)} "
            f"bytes of shared memory at {threads} threads, more than the "
            f"{_MAX_SMEM} a block may take")
    partials = torch.empty((blocks, rows, _F_STRIDE), dtype=torch.float32,
                           device=dev)
    return blocks, threads, partials, (
        _tabulated_outputs(static, n, dev) if per_ray else ())


def _table_grads(static, tab, diffp, n_rows, tabulated, per_ray):
    """A backward kernel's summed rows `tab` as the 12 `_diff_params`
    cotangents (`_unpack_table_grads`): the S table rows, at per-ray
    wavelengths `mat_coeffs`' from the S material rows after the `n_rows`
    table and raygen rows (`_material_grads`), and the wide rows last."""
    S = static.num_surfaces
    lay = _wide_layout(static)
    d_mat = (_material_grads(static, tab[n_rows:n_rows + S], tabulated,
                             diffp[6]) if per_ray else None)
    return _unpack_table_grads(static, tab[:S], diffp, d_mat,
                               tab[tab.shape[0] - lay[4]:] if lay else None)


def _tabulated_outputs(static, n, dev):
    """The per-ray outputs of the tabulated glasses (formula 10) of a
    per-ray backward kernel, T of them in surface order: each ray's segment
    i (the knots i - 1 and i; (T, n) int32, 1 where a glass is not
    refracted through) and the cotangents of (w[i - 1], w[i], n[i - 1],
    n[i]) of that glass's row ((T, 4, n), zeros there)."""
    T = sum(f == FORMULA_TABULATED for f in static.mat_formulas)
    return (torch.ones((T, n), dtype=torch.int32, device=dev),
            torch.zeros((T, 4, n), dtype=torch.float32, device=dev))


def _material_grads(static, rows, tabulated, mat):
    """d mat_coeffs (S, mat_w) of a per-ray backward kernel: the formula
    glasses' coefficient cotangents from the kernel's material rows (S,
    32), each tabulated glass's from its per-ray (segment, cotangents)
    (`_tabulated_outputs`). Those land on 4 entries of a row as wide as
    the glass's table, a scatter: the 4 n entries of every ray are sorted
    by position (a stable sort) and summed by `torch.segment_reduce` in
    that order, so the sums are reproducible bit for bit, with no float
    atomics, as the kernels' partials are."""
    d_mat = torch.zeros(mat.shape, dtype=rows.dtype, device=rows.device)
    d_mat[:, :_MAT_SHARED] = rows[:, :_MAT_SHARED]
    seg, val = tabulated
    tab = [k for k, f in enumerate(static.mat_formulas)
           if f == FORMULA_TABULATED]
    for t, k in enumerate(tab if seg.shape[1] else ()):
        K = static.mat_n_coeffs[k] // 2
        i = seg[t].long()
        i0 = (i - 1).clamp(min=0)
        pos, order = torch.sort(torch.cat([i0, i, K + i0, K + i]),
                                stable=True)
        at, counts = torch.unique_consecutive(pos, return_counts=True)
        d_mat[k, :_MAT_SHARED] = 0.0
        d_mat[k, at] = torch.segment_reduce(val[t].reshape(-1)[order], "sum",
                                            lengths=counts)
    return d_mat.to(mat.dtype)


def _raise_on_error(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def k1_launch(static, diffp, nondiffp, rg, data):
    """K1's variant for this system (its per-ray variant where data holds
    w), its arguments up to the partials and the stream, the (blocks, 4)
    partial buffer, and the tensors to keep alive until the launch is
    enqueued. Builds the variant on first use."""
    n, _, ptrs, keep = _launch_args(static, rg, diffp, nondiffp, data,
                                    kernel="K1")
    per_ray = len(data) == 5
    sizes, media, media_keep = _media_args(static, diffp, nondiffp, per_ray)
    defines = (history_defines if per_ray else system_defines)(static)
    fn = _kernel("moments_fwd", defines, per_ray)
    blocks = _system_blocks("moments_fwd", defines, n, rg.device)
    partials = torch.empty((blocks, 4), dtype=torch.float32, device=rg.device)
    args = [n, static.num_surfaces, blocks, *sizes, ptrs[0], ptrs[1], *media,
            *ptrs[3:], partials.data_ptr()]
    return fn, args, partials, keep + media_keep


def moments_forward(static, diffp, nondiffp, rg, data):
    """K1: (4,) spot moments of rays made from data = (Hx, Hy, Px, Py), or
    (Hx, Hy, Px, Py, w) at per-ray wavelengths. CPU tensors take
    `_moments_plain`; CUDA tensors launch the kernel, the system's own
    variant (built at first use; a failed build raises)."""
    if rg.device.type == "cpu":
        return _moments_plain(static, diffp, nondiffp, rg, data)
    fn, args, partials, _keep = k1_launch(static, diffp, nondiffp, rg, data)
    if args[0]:
        _raise_on_error("moments_fwd", fn(*args, _stream(rg.device)))
        moments_forward.launches += 1
    else:
        partials.zero_()
    return torch.sum(partials, dim=0)


moments_forward.launches = 0


def moments_backward(static, diffp, nondiffp, rg, data, c, diff_data=True):
    """K2: the cotangents of c . m (m the K1 moments, c of shape (4,)):
    (d_rg, d_diffp, d_data), a cotangent per data array (w's the 5th at
    per-ray wavelengths, with `mat_coeffs`' in d_diffp). Without
    `diff_data` the data cotangents are explicit zeros that the kernel
    neither computes nor writes. CPU tensors take `_moments_bwd_plain`;
    CUDA tensors launch the kernel. Parameter cotangents are per-block
    partials summed by torch.sum: reproducible bit for bit."""
    if rg.device.type == "cpu":
        return _moments_bwd_plain(static, diffp, nondiffp, rg, data, c,
                                  diff_data)
    n, head, ptrs, keep = _launch_args(static, rg, diffp, nondiffp, data,
                                       kernel="K2")
    dev, S, per_ray = rg.device, static.num_surfaces, len(data) == 5
    sizes, media, _media_keep = _media_args(static, diffp, nondiffp, per_ray)
    c = c.to(torch.float32).contiguous()
    blocks, threads, partials, tabulated = _backward_launch(
        static, n, dev, S + 1, per_ray)
    d_data = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                   if diff_data else torch.zeros_like(d) for d in data)
    d_ptrs = [d.data_ptr() if diff_data else None for d in d_data]
    if n and per_ray:
        err = _kernel("moments_bwd", backward_defines(static, True),
                      True)(
            *head, blocks, threads, int(diff_data), *sizes, *ptrs[:3],
            *media, *ptrs[3:], c.data_ptr(), partials.data_ptr(), *d_ptrs,
            *(t.data_ptr() for t in tabulated), _stream(dev))
    elif n:
        err = _kernel("moments_bwd", backward_defines(static, False))(
            *head, blocks, threads, int(diff_data), *ptrs, c.data_ptr(),
            partials.data_ptr(), *d_ptrs, _stream(dev))
    if n:
        _raise_on_error("moments_bwd", err)
        moments_backward.launches += 1
    tab = torch.sum(partials, dim=0)
    return (tab[S, :5].to(rg.dtype),
            _table_grads(static, tab, diffp, S + 1, tabulated, per_ray),
            d_data)


moments_backward.launches = 0


def k3_launch(static, diffp, nondiffp, rg, data, out_keys):
    """K3's variant for this system (its per-ray variant where data holds
    w), its arguments up to the stream, the `out_keys` outputs it writes
    (others are neither allocated nor written), and the tensors to keep
    alive until the launch is enqueued. Builds the variant on first use."""
    n, _, ptrs, keep = _launch_args(static, rg, diffp, nondiffp, data,
                                    kernel="K3")
    per_ray = len(data) == 5
    sizes, media, media_keep = _media_args(static, diffp, nondiffp, per_ray)
    defines = (history_defines if per_ray else system_defines)(static)
    fn = _kernel("raygen_trace_fwd", defines, per_ray)
    outs = {k: torch.empty((n,), dtype=torch.float32, device=rg.device)
            for k in out_keys}
    args = [n, static.num_surfaces,
            _system_blocks("raygen_trace_fwd", defines, n, rg.device),
            sum(1 << k for k in outs), *sizes, ptrs[0], ptrs[1], *media,
            *ptrs[3:],
            *(outs[k].data_ptr() if k in outs else None for k in range(8))]
    return fn, args, tuple(outs[k] for k in out_keys), keep + media_keep


def raygen_trace_forward(static, diffp, nondiffp, rg, data, out_keys):
    """K3: the `out_keys` subset of the final (x, y, z, L, M, N, i, opd) of
    rays made from data = (Hx, Hy, Px, Py), or with w at per-ray
    wavelengths. CPU tensors take `_raygen_trace_plain`; CUDA tensors
    launch the kernel, the system's own variant (built at first use; a
    failed build raises). Unrequested outputs are neither allocated nor
    written."""
    if rg.device.type == "cpu":
        return _raygen_trace_plain(static, diffp, nondiffp, rg, data,
                                   out_keys)
    fn, args, outs, _keep = k3_launch(static, diffp, nondiffp, rg, data,
                                      out_keys)
    if args[0]:
        _raise_on_error("raygen_trace_fwd", fn(*args, _stream(rg.device)))
        raygen_trace_forward.launches += 1
    return outs


raygen_trace_forward.launches = 0


def raygen_trace_backward(static, diffp, nondiffp, rg, data, out_keys,
                          seeds):
    """K4: the cotangents (d_rg, d_diffp, d_data) of the K3 outputs
    `out_keys` against per-ray `seeds` (one per key; None is a zero seed,
    never read), d_data one per data array (w's the 5th at per-ray
    wavelengths). CPU tensors take `_raygen_trace_bwd_plain`; CUDA tensors
    launch the kernel."""
    if rg.device.type == "cpu":
        return _raygen_trace_bwd_plain(static, diffp, nondiffp, rg, data,
                                       out_keys, seeds)
    n, head, ptrs, keep = _launch_args(static, rg, diffp, nondiffp, data,
                                       kernel="K4")
    dev, S, per_ray = rg.device, static.num_surfaces, len(data) == 5
    sizes, media, _media_keep = _media_args(static, diffp, nondiffp, per_ray)
    by_key = dict(zip(out_keys, seeds))
    seeds8, seed_ptrs = _seed_ptrs([by_key.get(k) for k in range(8)], n, dev)
    blocks, threads, partials, tabulated = _backward_launch(
        static, n, dev, S + 1, per_ray)
    d_data = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                   for _ in data)
    if n and per_ray:
        err = _kernel("raygen_trace_bwd", backward_defines(static, True),
                      True)(
            *head, blocks, threads, *sizes, *ptrs[:3], *media, *ptrs[3:],
            *seed_ptrs, partials.data_ptr(), *(d.data_ptr() for d in d_data),
            *(t.data_ptr() for t in tabulated), _stream(dev))
    elif n:
        err = _kernel("raygen_trace_bwd", backward_defines(static, False))(
            *head, blocks, threads, *ptrs, *seed_ptrs, partials.data_ptr(),
            *(d.data_ptr() for d in d_data), _stream(dev))
    if n:
        _raise_on_error("raygen_trace_bwd", err)
        raygen_trace_backward.launches += 1
    tab = torch.sum(partials, dim=0)
    return (tab[S, :5].to(rg.dtype),
            _table_grads(static, tab, diffp, S + 1, tabulated, per_ray),
            d_data)


raygen_trace_backward.launches = 0


def k5_launch(static, diffp, nondiffp, rays):
    """K5's variant for this system (its per-ray variant for 9 ray arrays),
    its arguments up to the stream, the 8 outputs it writes, and the
    tensors to keep alive until the launch is enqueued. Builds the variant
    on first use."""
    n, _, ptrs, keep = _caller_ray_args(static, diffp, nondiffp, rays,
                                        kernel="K5")
    dev, per_ray = rays[0].device, len(rays) == 9
    sizes, media, media_keep = _media_args(static, diffp, nondiffp, per_ray)
    defines = (history_defines if per_ray else system_defines)(static)
    fn = _kernel("fused_trace_fwd", defines, per_ray)
    outs = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                 for _ in range(8))
    args = [n, static.num_surfaces,
            _system_blocks("fused_trace_fwd", defines, n, dev), *sizes,
            ptrs[0], *media, *ptrs[2:], *(o.data_ptr() for o in outs)]
    return fn, args, outs, keep + media_keep


def fused_trace_forward(static, diffp, nondiffp, rays):
    """K5: the final (x, y, z, L, M, N, i, opd) of the caller's rays (the
    same 8 arrays at the start, and w at per-ray wavelengths). CPU tensors
    take `_fused_trace_plain`; CUDA tensors launch the kernel, the
    system's own variant (built at first use; a failed build raises)."""
    if rays[0].device.type == "cpu":
        return _fused_trace_plain(static, diffp, nondiffp, rays)
    fn, args, outs, _keep = k5_launch(static, diffp, nondiffp, rays)
    if args[0]:
        _raise_on_error("fused_trace_fwd",
                        fn(*args, _stream(rays[0].device)))
        fused_trace_forward.launches += 1
    return outs


fused_trace_forward.launches = 0


def fused_trace_backward(static, diffp, nondiffp, rays, seeds):
    """K6: the cotangents (d_rays, d_diffp) of the K5 outputs against the 8
    per-ray `seeds` (None is a zero seed), a cotangent per ray array (w's
    the 9th at per-ray wavelengths). CPU tensors take
    `_fused_trace_bwd_plain`; CUDA tensors launch the kernel."""
    if rays[0].device.type == "cpu":
        return _fused_trace_bwd_plain(static, diffp, nondiffp, rays, seeds)
    n, head, ptrs, keep = _caller_ray_args(static, diffp, nondiffp, rays,
                                           kernel="K6")
    dev, S, per_ray = rays[0].device, static.num_surfaces, len(rays) == 9
    sizes, media, _media_keep = _media_args(static, diffp, nondiffp, per_ray)
    seeds8, seed_ptrs = _seed_ptrs(seeds, n, dev)
    blocks, threads, partials, tabulated = _backward_launch(
        static, n, dev, S, per_ray)
    d_rays = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                   for _ in rays)
    if n and per_ray:
        err = _kernel("fused_trace_bwd", backward_defines(static, True),
                      True)(
            *head, blocks, threads, *sizes, *ptrs[:2], *media, *ptrs[2:],
            *seed_ptrs, partials.data_ptr(), *(d.data_ptr() for d in d_rays),
            *(t.data_ptr() for t in tabulated), _stream(dev))
    elif n:
        err = _kernel("fused_trace_bwd", backward_defines(static, False))(
            *head, blocks, threads, *ptrs, *seed_ptrs, partials.data_ptr(),
            *(d.data_ptr() for d in d_rays), _stream(dev))
    if n:
        _raise_on_error("fused_trace_bwd", err)
        fused_trace_backward.launches += 1
    tab = torch.sum(partials, dim=0)
    return d_rays, _table_grads(static, tab, diffp, S, tabulated, per_ray)


fused_trace_backward.launches = 0


def k7_launch(static, diffp, nondiffp, rays9):
    """K7's variant for this system, its arguments up to the stream, the 8
    (S, n) history arrays it writes, and the tensors to keep alive until
    the launch is enqueued. Builds the variant on first use."""
    _check_kernel_branches(static, "K7")
    if len(rays9) != 9:
        raise ValueError("expected the 9 ray arrays x, y, z, L, M, N, i, "
                         "opd, w")
    ftab, _ = _pack_tables(static, diffp, nondiffp, True)
    sizes, media, media_keep = _media_args(static, diffp, nondiffp, True)
    dev, S = ftab.device, static.num_surfaces
    n = _check_arrays([("tables", ftab)] + list(zip(_RAY_KEYS, rays9)), dev)
    defines = history_defines(static)
    fn = _kernel("history_fwd", defines)
    outs = tuple(torch.empty((S, n), dtype=torch.float32, device=dev)
                 for _ in range(8))
    args = [n, S, _system_blocks("history_fwd", defines, n, dev),
            int(history_bulk(S, n, config.l2_bytes(dev))), *sizes,
            ftab.data_ptr(), *media, *(r.data_ptr() for r in rays9),
            *(o.data_ptr() for o in outs)]
    return fn, args, outs, (ftab,) + media_keep


def history_forward(static, diffp, nondiffp, rays9):
    """K7: the 8 (S, n) history arrays of the caller's rays9 = (x, y, z, L,
    M, N, i, opd, w) at their own wavelengths. CPU tensors take
    `_history_plain`; CUDA tensors launch the kernel, the system's own
    variant (built at first use; a failed build raises)."""
    if rays9[0].device.type == "cpu":
        return _history_plain(static, diffp, nondiffp, rays9)
    fn, args, outs, _keep = k7_launch(static, diffp, nondiffp, rays9)
    if args[0]:
        _raise_on_error("history_fwd", fn(*args, _stream(rays9[0].device)))
        history_forward.launches += 1
    return outs


history_forward.launches = 0


# ---------------------------------------------------------------------------
# autograd seams
# ---------------------------------------------------------------------------
def _split(n_diff, tensors):
    """(diffp, nondiffp, per-ray arrays) of a seam's flat tensor list."""
    return (tensors[:n_diff], tensors[n_diff:n_diff + 4],
            tensors[n_diff + 4:])


class _FusedSpotMoments(torch.autograd.Function):
    """K1 at the autograd seam; its backward is K2. Per-ray data (with w)
    get w's cotangent as the others'."""

    @staticmethod
    def forward(ctx, static, n_diff, diff_data, rg, *tensors):
        ctx.static, ctx.n_diff, ctx.diff_data = static, n_diff, diff_data
        ctx.save_for_backward(rg, *tensors)
        diffp, nondiffp, data = _split(n_diff, tensors)
        return moments_forward(static, diffp, nondiffp, rg, data)

    @staticmethod
    def backward(ctx, c):
        rg, *tensors = ctx.saved_tensors
        diffp, nondiffp, data = _split(ctx.n_diff, tensors)
        d_rg, d_diff, d_data = moments_backward(
            ctx.static, diffp, nondiffp, rg, data, c, ctx.diff_data)
        return (None, None, None, d_rg, *d_diff, *[None] * len(nondiffp),
                *d_data)


class _FusedRaygenTraceFinal(torch.autograd.Function):
    """K3 at the autograd seam; its backward is K4."""

    @staticmethod
    def forward(ctx, static, out_keys, n_diff, rg, *tensors):
        ctx.static, ctx.out_keys, ctx.n_diff = static, out_keys, n_diff
        ctx.save_for_backward(rg, *tensors)
        ctx.set_materialize_grads(False)
        diffp, nondiffp, data = _split(n_diff, tensors)
        return raygen_trace_forward(static, diffp, nondiffp, rg, data,
                                    out_keys)

    @staticmethod
    def backward(ctx, *grads):
        rg, *tensors = ctx.saved_tensors
        diffp, nondiffp, data = _split(ctx.n_diff, tensors)
        d_rg, d_diff, d_data = raygen_trace_backward(
            ctx.static, diffp, nondiffp, rg, data, ctx.out_keys, grads)
        return (None, None, None, d_rg, *d_diff, *[None] * len(nondiffp),
                *d_data)


class _FusedTraceFinal(torch.autograd.Function):
    """K5 at the autograd seam; its backward is K6 (9 ray arrays at per-ray
    wavelengths, w's cotangent the 9th)."""

    @staticmethod
    def forward(ctx, static, n_diff, *tensors):
        ctx.static, ctx.n_diff = static, n_diff
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        diffp, nondiffp, rays8 = _split(n_diff, tensors)
        return fused_trace_forward(static, diffp, nondiffp, rays8)

    @staticmethod
    def backward(ctx, *grads):
        diffp, nondiffp, rays8 = _split(ctx.n_diff, ctx.saved_tensors)
        d_rays, d_diff = fused_trace_backward(ctx.static, diffp, nondiffp,
                                              rays8, grads)
        return (None, None, *d_diff, *[None] * len(nondiffp), *d_rays)


def _hist_eager(static, diffp, nondiffp, rays9):
    """The eager trace on K7's (diffp, nondiffp, rays9) parameterization,
    the twin of the kernel that its backward differentiates (JAX
    `_hist_xla`). The leaves the supported system class never reads are
    placeholders."""
    from optiland_tpu_torch.core.rays import Rays
    from optiland_tpu_torch.trace.tracer import trace_rays

    (cv, conic, coeffs, thickness, tilt, decenter, mat_coeffs,
     coating_params, _n_table, grating, phase_params, focal_length) = diffp
    ap_radius, k_wl, k_val, _alpha_table = nondiffp

    def zeros(*shape):
        return torch.zeros(shape, dtype=cv.dtype, device=cv.device)

    p = SystemParams(
        cv=cv, conic=conic, coeffs=coeffs, thickness=thickness, tilt=tilt,
        decenter=decenter, focal_length=focal_length, mat_coeffs=mat_coeffs,
        k_wl=k_wl, k_val=k_val, ap_radius=ap_radius, grating=grating,
        coating_params=coating_params, phase_params=phase_params,
        cs_pos=zeros(cv.shape[0], 3), aperture_value=zeros(),
        x_fields=zeros(1), y_fields=zeros(1), vx=zeros(1), vy=zeros(1),
        wavelengths=zeros(1))
    h = trace_rays(static, p, Rays(*rays9))
    return (h.x, h.y, h.z, h.L, h.M, h.N, h.intensity, h.opd)


class _FusedHistory(torch.autograd.Function):
    """K7 at the autograd seam. JAX has no backward kernel for it, and
    neither has the port: the backward is autograd through the eager twin
    `_hist_eager` (JAX `_fused_history_bwd`). It returns cotangents for
    every table, the non-differentiable ones included, and for the 9 ray
    arrays, which carry the gradient back into the ray generation (EPD,
    EPL, field angles, thickness). An unseeded output is a zero seed."""

    @staticmethod
    def forward(ctx, static, n_diff, *tensors):
        ctx.static, ctx.n_diff = static, n_diff
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        diffp, nondiffp, rays9 = _split(n_diff, tensors)
        return history_forward(static, diffp, nondiffp, rays9)

    @staticmethod
    def backward(ctx, *grads):
        nd, tensors = ctx.n_diff, ctx.saved_tensors
        g = _vjp(lambda *a: _hist_eager(ctx.static, a[:nd], a[nd:nd + 4],
                                        a[nd + 4:]),
                 tensors, [True] * len(tensors), grads)
        return (None, None, *g)


def fused_spot_moments(static, params_tuple, data, diff_data=True):
    """(m0, m1, m2, m3) through K1, differentiable through K2.
    `params_tuple` = (diffp, nondiffp, rg) as `_diff_params`,
    `_nondiff_params`, `_raygen_scalars` give them; `data` = (Hx, Hy, Px,
    Py), or (Hx, Hy, Px, Py, w) at per-ray wavelengths. `diff_data=False`
    declares the data cotangents unwanted: they come back as zeros and the
    backward kernel skips them."""
    diffp, nondiffp, rg = params_tuple
    m = _FusedSpotMoments.apply(static, len(diffp), diff_data, rg, *diffp,
                                *nondiffp, *data)
    return tuple(m.unbind())


def fused_raygen_trace_final(static, out_keys, params_tuple, data):
    """The `out_keys` final arrays through K3, differentiable through K4
    (arguments as `fused_spot_moments`)."""
    diffp, nondiffp, rg = params_tuple
    return _FusedRaygenTraceFinal.apply(static, tuple(out_keys), len(diffp),
                                        rg, *diffp, *nondiffp, *data)


def fused_trace_final(static, params_tuple, rays):
    """The final (x, y, z, L, M, N, i, opd) of the caller's 8 ray arrays (9
    with w at per-ray wavelengths) through K5, differentiable through K6.
    `params_tuple` = (diffp, nondiffp)."""
    diffp, nondiffp = params_tuple
    return _FusedTraceFinal.apply(static, len(diffp), *diffp, *nondiffp,
                                  *rays)


def fused_history(static, params_tuple, rays9):
    """The 8 (S, n) history arrays of the caller's 9 ray arrays through K7,
    differentiable through the eager twin. `params_tuple` = (diffp,
    nondiffp)."""
    diffp, nondiffp = params_tuple
    return _FusedHistory.apply(static, len(diffp), *diffp, *nondiffp, *rays9)


def _per_ray(wavelength) -> bool:
    """JAX's test for the per-ray configuration (`uniform_w` false): a
    wavelength that is an array, even of equal values."""
    return torch.as_tensor(wavelength).ndim != 0


def _prepare(static, params, Hx, Hy, Px, Py, wavelength, diff_w=True):
    """Broadcast the per-ray data and build the kernel parameter tuple of
    the raygen kernels (K1-K4). A scalar `wavelength` fills the index and
    absorption tables, the gratings' m w and the phase sheets' 1 / k0
    (`_uniform_params`; with `diff_w` false w enters the last two detached,
    as JAX's K2 returns no w cotangent without its data cotangents) and
    data = (Hx, Hy, Px, Py); an array leaves the index and absorption slots
    as unused placeholders and data gains w, broadcast to the rays."""
    dt, dev = params.cv.dtype, params.cv.device
    Px = torch.as_tensor(Px, dtype=dt, device=dev)
    Py = torch.as_tensor(Py, dtype=dt, device=dev)
    Hx = torch.as_tensor(Hx, dtype=dt, device=dev).expand(Px.shape)
    Hy = torch.as_tensor(Hy, dtype=dt, device=dev).expand(Px.shape)
    data = (Hx, Hy, Px, Py)
    if _per_ray(wavelength):
        p = (_diff_params(params), _nondiff_params(params))
        data += (torch.as_tensor(wavelength, dtype=dt,
                                 device=dev).expand(Px.shape),)
    else:
        p = _uniform_params(static, params, wavelength, diff_w)
    p += (_raygen_scalars(static, params),)
    return p, tuple(a.contiguous() for a in data)


def trace_system_final_fused(static: SystemStatic, params: SystemParams,
                             Hx, Hy, Px, Py, wavelength, outputs=None):
    """Raygen+trace in one launch of K3 (backward: K4). The caller has
    checked `supports_fused` and `supports_fused_raygen`. `outputs`: names
    from ("x", "y", "z", "L", "M", "N", "intensity", "opd"); default all."""
    p, data = _prepare(static, params, Hx, Hy, Px, Py, wavelength)
    if outputs is None:
        out_keys = tuple(range(8))
    else:
        out_keys = tuple(sorted(_NAMES.index(o) for o in outputs))
    vals = fused_raygen_trace_final(static, out_keys, p, data)
    return {_NAMES[k]: v for k, v in zip(out_keys, vals)}


def trace_final(static: SystemStatic, params: SystemParams, rays0,
                wavelength=None):
    """Final-surface state from a caller-made bundle. On a CUDA device in
    float32 a `supports_fused` system is one launch of K5 (backward: K6):
    at a scalar `wavelength` (the one the bundle was made with) from the
    index, absorption, grating and phase tables (w detached from the
    gratings' m w and the phase sheets' 1 / k0: JAX's K6 returns no w
    cotangent); at per-ray wavelengths (an
    array, or `None`, as in JAX) at the bundle's own w, which K6
    differentiates. Otherwise the eager trace."""
    from optiland_tpu_torch.trace.tracer import _final, trace_rays

    if (supports_fused(static) and rays0.x.is_cuda
            and rays0.x.dtype == torch.float32):
        if wavelength is None or _per_ray(wavelength):
            p = (_diff_params(params), _nondiff_params(params))
            keys = _RAY_KEYS
        else:
            p = _uniform_params(static, params, wavelength, diff_w=False)
            keys = _RAY_KEYS[:8]
        rays = tuple(getattr(rays0, k).contiguous() for k in keys)
        return dict(zip(_NAMES, fused_trace_final(static, p, rays)))
    return _final(trace_rays(static, params, rays0))


def trace_history_fused(static: SystemStatic, params: SystemParams, rays0):
    """Full (S, N) history. On a CUDA device in float32 a `supports_fused`
    system is one launch of K7 at the rays' own wavelengths, differentiable
    through the eager twin (gradients reach the parameters and the starting
    rays); a branch K7 does not cover raises. Otherwise the eager trace."""
    from optiland_tpu_torch.trace.tracer import TraceHistory, trace_rays

    if (supports_fused(static) and rays0.x.is_cuda
            and rays0.x.dtype == torch.float32):
        p = (_diff_params(params), _nondiff_params(params))
        rays9 = tuple(getattr(rays0, k).contiguous() for k in _RAY_KEYS)
        return TraceHistory(*fused_history(static, p, rays9))
    return trace_rays(static, params, rays0)


def spot_moments(static: SystemStatic, params: SystemParams,
                 Hx, Hy, Px, Py, wavelength, diff_data: bool = True):
    """Weighted spot moments (m0, m1, m2, m3) = (sum i, sum x i, sum y i,
    sum (x^2+y^2) i) at the image surface. On a CUDA device in float32 a
    system both gates accept is one launch of K1, and its gradient one
    launch of K2, at a scalar `wavelength` or per-ray ones (an array: the
    polychromatic merit); `diff_data=False` then declares the (Hx, Hy, Px,
    Py, w) cotangents unwanted (they come back as zeros, the parameter
    gradients are unchanged). On the CPU, and in float64, the eager generate_rays ->
    trace_rays pipeline under autograd, which differentiates everything."""
    dtype = params.cv.dtype
    use_fused = (supports_fused(static) and supports_fused_raygen(static)
                 and params.cv.is_cuda and dtype == torch.float32)
    if use_fused:
        p, data = _prepare(static, params, Hx, Hy, Px, Py, wavelength,
                           diff_w=diff_data)
        return fused_spot_moments(static, p, data, diff_data)
    from optiland_tpu_torch.trace.raygen import generate_rays
    from optiland_tpu_torch.trace.tracer import trace_rays

    dev = params.cv.device
    Px = torch.as_tensor(Px, dtype=dtype, device=dev)
    Hxb = torch.as_tensor(Hx, dtype=dtype, device=dev).expand(Px.shape)
    Hyb = torch.as_tensor(Hy, dtype=dtype, device=dev).expand(Px.shape)
    rays0 = generate_rays(static, params, Hxb, Hyb, Px, Py, wavelength)
    h = trace_rays(static, params, rays0)
    x, y, i = h.x[-1], h.y[-1], h.intensity[-1]
    return (torch.sum(i), torch.sum(x * i), torch.sum(y * i),
            torch.sum((x * x + y * y) * i))
