"""Huygens-Fresnel direct-summation PSF.

Port of `optiland_tpu/psf/huygens.py`. For every image point
the complex phasors of every pupil sample are summed: the repo's only
O(N^2) computation. K8 `huygens_sum_forward`, a hand-written CUDA kernel
(csrc/huygens_sum.cu, body csrc/huygens.cuh), replaces the Pallas kernel
`huygens_sum_pallas`; `huygens_sum_plain`, the twin of `huygens_sum_xla`,
is its plain PyTorch version.

Physics as in the JAX package: spherical kernel exp(ikR)/R, obliquity
(1 + cos theta)/2 with the pupil-sphere normal approximated as Q/Rp, pupil
phase exp(-ik OPD), the phase referenced to the pupil-sphere radius Rp.

`VectorialHuygensPSF` sums the same integral over each Cartesian
component of each incoherent state's exit-pupil E field, whose amplitude
is complex: `huygens_sum_complex`, the twin of the JAX package's
`huygens_sum_complex_xla`, which is XLA there and stays plain PyTorch here
(K8 takes a real amplitude). `HuygensPSF` picks the vectorial PSF for a
polarized optic.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.system import paraxial as px
from optiland_tpu_torch.system.spec import positions_of
from optiland_tpu_torch.wavefront.core import pupil_grid_coords, wavefront_data

_BLOCK_I = 1024  # image points per block (csrc/huygens_sum.cu BLOCK_I)
_TILE_P = 128    # pupil samples per staged tile (TILE_P there)
_BLOCKS_PER_SM = 16  # blocks of the grid per SM: ~4 waves of 4 resident


def _field_contrib(ix, iy, iz, ux, uy, uz, amp, opd, k, Rp):
    """Field at image points (broadcast (I, P)) from pupil samples."""
    dx = ix - ux
    dy = iy - uy
    dz = iz - uz
    R = torch.sqrt(dx * dx + dy * dy + dz * dz)
    cos_theta = (dx * ux + dy * uy + dz * uz) / (R * Rp)
    obliq = 0.5 * (1.0 + cos_theta)
    # Phase referenced to the pupil sphere radius: k*(R - Rp) differs from
    # k*R by a constant phase that cancels in |field|^2, and keeps the
    # cos/sin argument small (k*R itself is ~1e6 radians).
    phase = k * ((R - Rp) - opd)
    scale = amp * obliq / R
    re = torch.sum(scale * torch.cos(phase), dim=-1)
    im = torch.sum(scale * torch.sin(phase), dim=-1)
    return re, im


def huygens_sum_plain(image_xyz, pupil_xyz, pupil_amp, pupil_opd,
                      wavelength_mm, Rp, row_chunk: int = 128):
    """|sum_p amp obliq / R e^{ik(R - Rp - opd)}|^2 at every image point, in
    the inputs' dtype, over chunks of `row_chunk` image points to bound
    memory; the result has the shape of image_xyz[0]."""
    ix, iy, iz = (a.reshape(-1) for a in image_xyz)
    ux, uy, uz = (a[None, :] for a in pupil_xyz)
    amp, opd = pupil_amp[None, :], pupil_opd[None, :]
    k = 2.0 * math.pi / wavelength_mm
    rows = []
    for s in range(0, ix.shape[0], row_chunk):
        re, im = _field_contrib(
            ix[s:s + row_chunk, None], iy[s:s + row_chunk, None],
            iz[s:s + row_chunk, None], ux, uy, uz, amp, opd, k, Rp)
        rows.append(re * re + im * im)
    return torch.cat(rows).reshape(image_xyz[0].shape)


@lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/huygens_sum.cu, built on first use."""
    from optiland_tpu_torch import _build

    fn = _build.library("huygens_sum").huygens_sum
    # I, P, chunk, 1 / wavelength as a float pair (`inv_wavelength`), Rp
    # (device pointer), ix, iy, iz, ux, uy, uz, amp, opd, partial (chunks,
    # 2, I), stream
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    return fn


def inv_wavelength(wavelength_mm: float) -> tuple[float, float]:
    """1 / wavelength_mm as float32 hi + lo: K8 takes the OPD's phase in
    cycles, and 1 / lambda rounded to float32 alone would be off by up to
    3e-8 relative, ~1e-3 cycles at an OPD of 20 mm."""
    inv = 1.0 / wavelength_mm
    hi = float(np.float32(inv))
    return hi, float(np.float32(inv - hi))


def pupil_chunk(n_image: int, n_pupil: int, n_sm: int) -> int:
    """Pupil samples per block of K8: the pupil axis is split into as many
    chunks as, beside the image blocks, fill `n_sm` SMs with
    `_BLOCKS_PER_SM` blocks each; a chunk is a whole number of tiles, at
    least one."""
    tiles = max(1, -(-n_pupil // _TILE_P))
    image_blocks = max(1, -(-n_image // _BLOCK_I))
    chunks = max(1, min(tiles, -(-n_sm * _BLOCKS_PER_SM // image_blocks)))
    return -(-tiles // chunks) * _TILE_P


def reduce_partials(partial):
    """The PSF from K8's (chunks, 2, I) partial fields: summed over the
    chunks first (fixed order), then squared."""
    field = torch.sum(partial, dim=0)
    return field[0] * field[0] + field[1] * field[1]


def huygens_sum_forward(image_xyz, pupil_xyz, pupil_amp, pupil_opd,
                        wavelength_mm, Rp):
    """K8: the Huygens sum of `huygens_sum_plain` on float32 CUDA tensors,
    one launch. Forward only, as the Pallas kernel is: it raises when grad
    mode is on and an input requires grad. Raises on inputs it does not
    take (dtype, device, shapes) and when the launch fails."""
    image = [a.reshape(-1).contiguous() for a in image_xyz]
    pupil = [a.contiguous() for a in (*pupil_xyz, pupil_amp, pupil_opd)]
    Rp = torch.as_tensor(Rp, dtype=torch.float32,
                         device=pupil[0].device).reshape(1)
    arrays = image + pupil + [Rp]
    if torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
        raise RuntimeError(
            "huygens_sum (K8) has no backward; call it under torch.no_grad() "
            "or on inputs that do not require grad")
    dev = pupil[0].device
    for a in arrays:
        if a.device != dev or a.dtype != torch.float32 or dev.type != "cuda":
            raise ValueError(f"K8 takes float32 tensors on one CUDA device, "
                             f"got {a.dtype} on {a.device}")
    n_img, n_pup = image[0].shape[0], pupil[0].shape[0]
    if any(a.shape != (n_img,) for a in image) or any(
            a.dim() != 1 or a.shape[0] != n_pup for a in pupil):
        raise ValueError("expected 3 image arrays of one size and 5 (P,) "
                         "pupil arrays")
    chunk = pupil_chunk(n_img, n_pup, config.sm_count(dev))
    partial = torch.empty((-(-n_pup // chunk), 2, n_img), dtype=torch.float32,
                          device=dev)
    if n_img and n_pup:
        err = _kernel()(n_img, n_pup, chunk, *inv_wavelength(wavelength_mm),
                        *(a.data_ptr() for a in [Rp] + image + pupil),
                        partial.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"huygens_sum launch failed: cudaError {err}")
        huygens_sum_forward.launches += 1
    return reduce_partials(partial).reshape(image_xyz[0].shape)


huygens_sum_forward.launches = 0


def huygens_sum(image_xyz, pupil_xyz, pupil_amp, pupil_opd, wavelength_mm,
                Rp):
    """The Huygens sum with the signature of the JAX package's summations.
    CPU tensors and float64 ones (the port's reference path, as float64
    traces run eager) take `huygens_sum_plain`; float32 CUDA tensors launch
    K8 (`huygens_sum_forward`), which raises rather than fall back."""
    if pupil_amp.device.type == "cpu" or pupil_amp.dtype == torch.float64:
        return huygens_sum_plain(image_xyz, pupil_xyz, pupil_amp, pupil_opd,
                                 wavelength_mm, Rp)
    return huygens_sum_forward(image_xyz, pupil_xyz, pupil_amp, pupil_opd,
                               wavelength_mm, Rp)


def _image_grid(optic, static, params, field, wavelength: float,
                image_size: int, device):
    """The image grid (IX, IY, IZ) of a Huygens PSF, centred on the beam
    footprint of the optic's own hexapolar trace (6 rings) and wide enough
    for the footprint or 5 Airy radii; with its pixel pitch and centre
    (cx, cy)."""
    dt, dev = params.cv.dtype, params.cv.device
    spot = optic.trace(Hx=field[0], Hy=field[1], wavelength=wavelength,
                       num_rays=6, distribution="hexapolar", device=device)
    sx, sy, si = spot.x[-1], spot.y[-1], spot.intensity[-1]
    wsum = torch.sum(si) + 1e-12
    cx = torch.sum(sx * si) / wsum
    cy = torch.sum(sy * si) / wsum
    fno = px.FNO(static, params, wavelength)
    extent_geo = torch.max(torch.where(
        si > 0, torch.hypot(sx - cx, sy - cy), torch.zeros_like(si)))
    extent_ideal = 5.0 * fno * 1.22 * wavelength * 1e-3
    extent = torch.maximum(extent_geo, torch.as_tensor(
        extent_ideal, dtype=dt, device=dev))
    pixel_pitch = 2.0 * extent / image_size
    gx = torch.linspace(-1.0, 1.0, image_size, dtype=dt, device=dev) * extent
    IX, IY = torch.meshgrid(gx + cx, gx + cy, indexing="xy")
    IZ = torch.zeros_like(IX) + positions_of(static, params)[-1]
    return (IX, IY, IZ), pixel_pitch, cx, cy


def huygens_psf_sums(optic, field, wavelength: float, num_rays: int,
                     image_size: int, strategy: str = "chief_ray",
                     device=None):
    """The two Huygens sums of `ScalarHuygensPSF` as argument tuples of
    `huygens_sum`: the image grid's, and the ideal (zero-OPD, unit
    amplitude) on-axis peak's that normalizes it; with the grid's pixel
    pitch and centre (cx, cy). Built on the device of the optic's build."""
    static, params = optic.build(device=device)
    dt, dev = params.cv.dtype, params.cv.device

    # pupil samples on a uniform disk grid
    Px, Py, inside = pupil_grid_coords(num_rays, dt, dev)
    data = wavefront_data(static, params, field[0], field[1], Px, Py,
                          wavelength, strategy=strategy,
                          aiming=optic.ray_aiming)
    amp = torch.sqrt(data.intensity) * inside
    opd_mm = data.opd * wavelength * 1e-3

    grid, pixel_pitch, cx, cy = _image_grid(optic, static, params, field,
                                            wavelength, image_size, device)
    pos = positions_of(static, params)
    wl_mm = wavelength * 1e-3
    image = (grid, (data.pupil_x, data.pupil_y, data.pupil_z), amp,
             opd_mm, wl_mm, data.radius)

    zero = torch.zeros((1, 1), dtype=dt, device=dev)
    if field == (0, 0):
        ideal = data
    else:
        ideal = wavefront_data(static, params, 0.0, 0.0, Px, Py, wavelength,
                               strategy=strategy, aiming=optic.ray_aiming)
    peak = ((zero, zero, zero + pos[-1]),
            (ideal.pupil_x, ideal.pupil_y, ideal.pupil_z),
            torch.ones_like(ideal.intensity) * inside,
            torch.zeros_like(opd_mm), wl_mm, ideal.radius)
    return image, peak, pixel_pitch, cx, cy


class ScalarHuygensPSF:
    """Scalar Huygens-Fresnel PSF for one field and wavelength, on the
    device of the optic's build (the CUDA card unless `device="cpu"`),
    normalized so that the ideal on-axis peak is 100.

    The summation is `huygens_sum`: K8 on float32 CUDA tensors, the plain
    version on the CPU and in float64. `use_kernel=False` (JAX's
    `use_pallas=False`) takes the plain version everywhere.
    """

    def __init__(self, optic, field, wavelength="primary", num_rays: int = 128,
                 image_size: int = 128, strategy: str = "chief_ray",
                 use_kernel: bool = True, device=None):
        self.optic = optic
        self.field = field
        self.wavelength = (
            optic.primary_wavelength if wavelength == "primary" else float(wavelength)
        )
        self.num_rays = num_rays
        self.image_size = image_size
        image, peak, self.pixel_pitch, self.cx, self.cy = huygens_psf_sums(
            optic, field, self.wavelength, num_rays, image_size, strategy,
            device)
        summation = huygens_sum if use_kernel else huygens_sum_plain
        self.psf = summation(*image) / summation(*peak)[0, 0] * 100.0

    def strehl_ratio(self):
        c = self.image_size // 2
        return self.psf[c, c] / 100.0


def huygens_sum_complex(image_xyz, pupil_xyz, amp_re, amp_im, pupil_opd,
                        wavelength_mm, Rp, row_chunk: int = 128):
    """The Huygens sum with a complex pupil amplitude (a vectorial E-field
    component): |sum_p (re + i im) obliq / R e^{ik(R - Rp - opd)}|^2 at
    every image point, over chunks of `row_chunk` image points (the twin
    of JAX's `huygens_sum_complex_xla`). `amp_re` and `amp_im` may also be
    (C, P), C components that share the geometry: the result is then the
    sum of their C intensities, added in component order at each point, as
    C calls would add them."""
    ix, iy, iz = (a.reshape(-1) for a in image_xyz)
    ux, uy, uz = (a[None, :] for a in pupil_xyz)
    amp_re, amp_im = torch.atleast_2d(amp_re), torch.atleast_2d(amp_im)
    opd = pupil_opd[None, :]
    k = 2.0 * math.pi / wavelength_mm
    rows = []
    for s in range(0, ix.shape[0], row_chunk):
        dx = ix[s:s + row_chunk, None] - ux
        dy = iy[s:s + row_chunk, None] - uy
        dz = iz[s:s + row_chunk, None] - uz
        R = torch.sqrt(dx * dx + dy * dy + dz * dz)
        cos_theta = (dx * ux + dy * uy + dz * uz) / (R * Rp)
        obliq = 0.5 * (1.0 + cos_theta)
        phase = k * ((R - Rp) - opd)
        scale = obliq / R
        cp, sp = torch.cos(phase), torch.sin(phase)
        total = 0.0
        for c in range(amp_re.shape[0]):
            ar, ai = amp_re[c][None, :], amp_im[c][None, :]
            re = torch.sum(scale * (ar * cp - ai * sp), dim=-1)
            im = torch.sum(scale * (ar * sp + ai * cp), dim=-1)
            total = total + (re * re + im * im)
        rows.append(total)
    return torch.cat(rows).reshape(image_xyz[0].shape)


def _component_sum(E_exits, valid, image, pupil_xyz, opd_mm, wl_mm, Rp):
    """The vectorial PSF's sum over every state's three E components."""
    amp = torch.where(valid[None, :, None], E_exits, 0.0)
    amp = amp.permute(0, 2, 1).reshape(-1, amp.shape[1])
    return huygens_sum_complex(image, pupil_xyz, amp.real, amp.imag, opd_mm,
                               wl_mm, Rp)


class VectorialHuygensPSF:
    """Vectorial Huygens-Fresnel PSF: the diffraction integral of each
    Cartesian exit-pupil E-field component of each incoherent polarization
    state, the intensities summed; normalized so that the ideal on-axis
    peak is 100. The optic's polarization state, or unpolarized light
    where it has none; on the device of the optic's build (the CUDA card
    unless `device="cpu"`)."""

    def __init__(self, optic, field, wavelength="primary",
                 num_rays: int = 128, image_size: int = 128,
                 strategy: str = "chief_ray", device=None):
        from optiland_tpu_torch.polarization import PolarizationState

        state = optic.polarization
        if state == "ignore" or state is None:
            state = PolarizationState.unpolarized()
        self.optic = optic
        self.field = field
        self.wavelength = (
            optic.primary_wavelength if wavelength == "primary"
            else float(wavelength))
        self.num_rays = num_rays
        self.image_size = image_size

        static, params = optic.build(device=device)
        dt, dev = params.cv.dtype, params.cv.device
        Px, Py, inside = pupil_grid_coords(num_rays, dt, dev)
        data = wavefront_data(static, params, field[0], field[1], Px, Py,
                              self.wavelength, strategy=strategy,
                              polarization=state, aiming=optic.ray_aiming)
        valid = (data.intensity > 0) & inside
        opd_mm = data.opd * self.wavelength * 1e-3
        image, self.pixel_pitch, self.cx, self.cy = _image_grid(
            optic, static, params, field, self.wavelength, image_size,
            device)
        wl_mm = self.wavelength * 1e-3
        psf_raw = _component_sum(
            data.E_exits, valid, image,
            (data.pupil_x, data.pupil_y, data.pupil_z), opd_mm, wl_mm,
            data.radius)

        # the ideal (zero-OPD) on-axis peak -> 100; as in the JAX package,
        # an off-axis field's ideal wavefront is aimed paraxially
        zero = torch.zeros((1, 1), dtype=dt, device=dev)
        if tuple(field) == (0, 0):
            ideal = data
        else:
            ideal = wavefront_data(static, params, 0.0, 0.0, Px, Py,
                                   self.wavelength, strategy=strategy,
                                   polarization=state)
        ideal_valid = (ideal.intensity > 0) & inside
        peak = _component_sum(
            ideal.E_exits, ideal_valid,
            (zero, zero, zero + positions_of(static, params)[-1]),
            (ideal.pupil_x, ideal.pupil_y, ideal.pupil_z),
            torch.zeros_like(opd_mm), wl_mm, ideal.radius)
        self.psf = psf_raw / peak[0, 0] * 100.0

    strehl_ratio = ScalarHuygensPSF.strehl_ratio


class HuygensPSF:
    """Factory: the scalar Huygens PSF, or the vectorial one for an optic
    with a polarization state."""

    def __new__(cls, optic, *args, **kwargs):
        if getattr(optic, "polarization", "ignore") != "ignore":
            kwargs.pop("use_kernel", None)
            return VectorialHuygensPSF(optic, *args, **kwargs)
        return ScalarHuygensPSF(optic, *args, **kwargs)
