"""Image simulation: spatially-varying blur + distortion + lateral color.

Port of `optiland_tpu/analysis/image_simulation.py` (the reference pipeline
`optiland/analysis/image_simulation/`), on the device of the optic's build
(the CUDA card unless `device="cpu"`):

  1. PSF basis: the FFT PSF at every field point of a (ny, nx) grid (one
     `wavefront_data` each, then one batched FFT), and an SVD for the top-K
     "eigen PSFs" and their field-coefficient maps.
  2. Spatially-variable convolution: the eigen decomposition turns the
     shift-variant blur into K+1 shift-invariant convolutions, one batched
     rFFT convolution over the (K+1) stack.
  3. Distortion warp: trace a field grid, fit a polynomial from the real
     image coordinates to the normalized source field by least squares,
     evaluate it per destination pixel and resample bilinearly
     (`grid_sample`).

Lateral color falls out of running the stack once per wavelength channel.
The source image is float32, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from optiland_tpu_torch import config as _config
from optiland_tpu_torch.analysis.base import like, linspace
from optiland_tpu_torch.psf.fft import _pupil_grid, calculate_grid_size
from optiland_tpu_torch.trace.tracer import trace_system


def _resize(x, size):
    """`jax.image.resize(x, (..., *size), method="linear")` of the last two
    axes: the triangle kernel at half-pixel centres, widened by the factor
    when it shrinks (antialiasing), its weights normalized; which is
    `F.interpolate(..., "bilinear", align_corners=False, antialias=True)`
    in both directions."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((1, -1) + x.shape[-2:]), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + tuple(size))


# ---------------------------------------------------------------------------
# stage 1: PSF basis
# ---------------------------------------------------------------------------
class PSFBasisGenerator:
    """Eigen-PSF basis across the field (reference
    `psf_basis_generator.py:10-130`)."""

    def __init__(self, optic, wavelength, grid_shape=(5, 5), num_rays=64,
                 psf_grid_size=None, strategy: str = "chief_ray",
                 device=None):
        self.optic = optic
        self.wavelength = float(wavelength)
        self.grid_shape = grid_shape
        if psf_grid_size is None:
            num_rays, psf_grid_size = calculate_grid_size(num_rays)
        self.num_rays = num_rays
        self.psf_grid_size = psf_grid_size
        self.strategy = strategy
        self.device = device

    def _compute_psf_grid(self):
        """(ny*nx, P, P) stack of sum-normalized PSFs over the field grid."""
        static, params = self.optic.build(device=self.device)
        ny, nx = self.grid_shape
        ys = np.linspace(-1.0, 1.0, ny)
        xs = np.linspace(-1.0, 1.0, nx)
        nr, gs = self.num_rays, self.psf_grid_size
        pupils = torch.stack([
            _pupil_grid(static, params, float(x), float(y), self.wavelength,
                        nr, self.strategy) for y in ys for x in xs])
        pad_b = (gs - nr) // 2
        padded = pupils.new_zeros((pupils.shape[0], gs, gs))
        padded[:, pad_b:pad_b + nr, pad_b:pad_b + nr] = pupils
        amp = torch.fft.fftshift(torch.fft.fft2(padded), dim=(-2, -1))
        psf = torch.real(amp * torch.conj(amp))
        return psf / torch.sum(psf, dim=(-2, -1), keepdim=True)

    def generate_basis(self, n_components=3):
        """Returns (eigen_psfs (K,P,P), coeff_grid (K,ny,nx), mean_psf (P,P));
        the reference's centered-SVD PCA (`psf_basis_generator.py:37-99`).
        Each singular pair's sign is the solver's choice, as in JAX; the
        rank-K blur does not depend on it."""
        stack = self._compute_psf_grid()
        n, h, w = stack.shape
        X = stack.reshape(n, h * w)
        mean_flat = torch.mean(X, dim=0)
        U, S, Vt = torch.linalg.svd(X - mean_flat, full_matrices=False)
        eigen = Vt[:n_components].reshape(n_components, h, w)
        coeffs = (U[:, :n_components] * S[:n_components]).T.reshape(
            n_components, self.grid_shape[0], self.grid_shape[1])
        return eigen, coeffs, mean_flat.reshape(h, w)

    @staticmethod
    def resize_coefficient_map(coeff_map, target_shape):
        """Bilinear resize of (K, h, w) or (h, w) maps to target (H, W)."""
        return _resize(torch.as_tensor(coeff_map), target_shape)


# ---------------------------------------------------------------------------
# stage 2: spatially-variable convolution
# ---------------------------------------------------------------------------
def _fftconvolve_same(image, kernels):
    """Batched 2-D FFT convolution, 'same' output (reference
    `be.fftconvolve(..., mode="same")`).

    image: (B, H, W); kernels: (B, P, P) -> (B, H, W). One rFFT each way.
    """
    B, H, W = image.shape
    P, Q = kernels.shape[-2:]
    fh, fw = H + P - 1, W + Q - 1
    Fi = torch.fft.rfft2(image, s=(fh, fw))
    Fk = torch.fft.rfft2(kernels, s=(fh, fw))
    full = torch.fft.irfft2(Fi * Fk, s=(fh, fw))
    y0 = (P - 1) // 2
    x0 = (Q - 1) // 2
    return full[:, y0:y0 + H, x0:x0 + W]


class SpatiallyVariableSimulator:
    """Eigen-PSF shift-variant blur (reference `simulator.py:6-56`):
    out = src * mean_psf + sum_k (src . coeff_k) * eigen_k."""

    def simulate(self, source_image, eigen_psfs, coefficient_maps, mean_psf):
        eigen = torch.as_tensor(eigen_psfs)
        cmaps = torch.as_tensor(coefficient_maps)
        mean = torch.as_tensor(mean_psf)
        src = torch.as_tensor(source_image, device=cmaps.device)
        # the image's float32 meets the basis's dtype as JAX promotes it
        src = src.to(torch.promote_types(src.dtype, cmaps.dtype))

        images = torch.cat([src[None], src[None] * cmaps], dim=0)
        kernels = torch.cat([mean[None], eigen], dim=0).to(images.dtype)
        return torch.sum(_fftconvolve_same(images, kernels), dim=0)


# ---------------------------------------------------------------------------
# stage 3: distortion warp
# ---------------------------------------------------------------------------
def _poly_features(x, y, degree):
    """[x^i y^j for i+j <= degree] feature matrix, (N, n_terms) — same term
    ordering as the reference (`distortion_warper.py:31-38`)."""
    feats = []
    for d in range(degree + 1):
        for i in range(d + 1):
            j = d - i
            feats.append((x ** i) * (y ** j))
    return torch.stack(feats, dim=1)


class DistortionWarper:
    """Geometric distortion + lateral color warp (reference
    `distortion_warper.py:6-146`)."""

    def __init__(self, optic, source_fov=None, device=None):
        self.optic = optic
        self.device = device
        if source_fov is None:
            mf = float(optic.fields.max_field)
            self.source_fov = (mf, mf)
        else:
            self.source_fov = source_fov

    def generate_distortion_map(self, wavelength, image_shape,
                                num_grid_points=25, degree=5):
        """(H, W, 2) normalized source coords (gx, gy in [-1, 1]) for each
        destination pixel, via a degree-`degree` polynomial least-squares
        fit of the traced chief-ray landing grid."""
        H, W = image_shape
        max_fx, max_fy = self.source_fov
        static, params = self.optic.build(device=self.device)

        lin = np.linspace(-1.0, 1.0, num_grid_points)
        gx, gy = np.meshgrid(lin, lin)
        gxf, gyf = like(gx.ravel(), params), like(gy.ravel(), params)

        optic_max = float(self.optic.fields.max_field)
        scale = 1.0 if optic_max == 0 else optic_max
        hx = gxf * (max_fx / scale)
        hy = gyf * (max_fy / scale)

        def land(hx, hy):
            zero = torch.zeros_like(hx)
            hist = trace_system(static, params, hx, hy, zero, zero,
                                torch.full_like(hx, wavelength))
            return hist.x[-1], hist.y[-1]

        x_real, y_real = land(hx, hy)
        cx0, cy0 = land(torch.zeros_like(hx[:1]), torch.zeros_like(hy[:1]))
        x_real = (x_real - cx0[0]).double()
        y_real = (y_real - cy0[0]).double()

        # The fit is a degree-5 polynomial of landing points in mm up to
        # the image height: its columns span ~10 decades, an ill-conditioned
        # system. It is solved in float64 whatever the precision, by an
        # SVD-based solver (LAPACK gelsd, the cut-off of JAX's lstsq) on
        # the host: CUDA's lstsq has only the QR solver `gels`, which
        # assumes full rank. The fitted map is evaluated in float64 too.
        Xf = _poly_features(x_real, y_real, degree)
        c = torch.linalg.lstsq(
            Xf.cpu(), torch.stack([gxf, gyf], dim=1).double().cpu(),
            driver="gelsd").solution.to(Xf.device)

        ty = linspace(torch.amax(y_real), torch.amin(y_real), H, y_real)
        tx = linspace(torch.amin(x_real), torch.amax(x_real), W, x_real)
        grid_y, grid_x = torch.meshgrid(ty, tx, indexing="ij")  # row 0: +y
        Xg = _poly_features(grid_x.ravel(), grid_y.ravel(), degree)
        return (Xg @ c).reshape(H, W, 2).to(params.cv.dtype)

    def warp_image(self, image, distortion_grid):
        """Bilinear resample: each destination pixel pulls from the source at
        its normalized (gx, gy), each corner outside the image zero (JAX's
        `map_coordinates(order=1, mode="constant")`): `grid_sample` with
        the corners aligned and the y axis flipped (+gy, the top of the
        field, is row 0)."""
        img = torch.as_tensor(image)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[None]
        grid = torch.stack([distortion_grid[..., 0],
                            -distortion_grid[..., 1]], dim=-1)
        out = F.grid_sample(img[None], grid[None].to(img.dtype),
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True)[0]
        return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class ImageSimulationEngine:
    """Full pipeline: pad/oversample -> per-channel eigen-PSF blur ->
    distortion warp -> crop (reference `engine.py:13-220`), on the device
    of the optic's build (the CUDA card unless `device="cpu"`)."""

    def __init__(self, optic, source_image, config=None, device=None):
        self.optic = optic
        self.device = device
        self.simulated_image = None

        img = torch.as_tensor(np.asarray(source_image)
                              if not torch.is_tensor(source_image)
                              else source_image, dtype=torch.float32,
                              device=_config.resolve_device(device))
        if img.ndim == 3 and img.shape[2] in (3, 4):
            img = img[:, :, :3].permute(2, 0, 1)
        elif img.ndim == 2:
            img = img[None, :, :]
        self.source_image = img

        self.config = {
            "wavelengths": [0.65, 0.55, 0.45],
            "psf_grid_shape": (5, 5),
            "psf_size": 128,
            "num_rays": 64,
            "n_components": 3,
            "oversample": 1,
            "padding": 64,
        }
        if config:
            self.config.update(config)

    def run(self):
        processed, pad_info = self._preprocess(self.source_image)
        C, H, W = processed.shape
        wavelengths = self.config["wavelengths"]
        if C == 1 and len(wavelengths) == 3:
            channels = [processed[0]] * 3
        else:
            channels = [processed[c] for c in range(min(C, len(wavelengths)))]

        out_channels = []
        for wave, channel in zip(wavelengths, channels):
            gen = PSFBasisGenerator(
                self.optic, wavelength=wave,
                grid_shape=self.config["psf_grid_shape"],
                num_rays=self.config["num_rays"],
                psf_grid_size=self.config["psf_size"], device=self.device,
            )
            eigen, coeffs, mean_psf = gen.generate_basis(
                n_components=self.config["n_components"])
            coeffs_hw = gen.resize_coefficient_map(coeffs, (H, W))

            blurred = SpatiallyVariableSimulator().simulate(
                channel, eigen, coeffs_hw, mean_psf)

            warper = DistortionWarper(self.optic, device=self.device)
            dist_map = warper.generate_distortion_map(wave, (H, W))
            out_channels.append(warper.warp_image(blurred, dist_map))

        result = self._postprocess(torch.stack(out_channels), pad_info)
        if result.ndim == 3:
            result = result.permute(1, 2, 0)
        self.simulated_image = result
        return result

    def view(self, force_rerun=False, figsize=(10, 5)):
        if self.simulated_image is None or force_rerun:
            self.run()
        import matplotlib.pyplot as plt

        src = self.source_image
        if src.shape[0] in (1, 3):
            src = src.permute(1, 2, 0)
        src_np = np.clip(src.detach().cpu().numpy().squeeze(), 0, None)
        sim_np = np.clip(self.simulated_image.detach().cpu().numpy()
                         .squeeze(), 0, None)
        if src_np.max() > 2.0:
            src_np = src_np / 255.0
        if sim_np.max() > 2.0:
            sim_np = sim_np / 255.0
        fig, ax = plt.subplots(1, 2, figsize=figsize)
        ax[0].imshow(np.clip(src_np, 0, 1),
                     cmap="gray" if src_np.ndim == 2 else None)
        ax[0].set_title("Original Image")
        ax[0].axis("off")
        ax[1].imshow(np.clip(sim_np, 0, 1),
                     cmap="gray" if sim_np.ndim == 2 else None)
        ax[1].set_title("Simulated Image")
        ax[1].axis("off")
        fig.tight_layout()
        return fig, ax

    def _preprocess(self, image):
        pad = self.config["padding"]
        # numpy's "reflect" (the edge not repeated) is torch's
        padded = F.pad(image[None], (pad, pad, pad, pad), mode="reflect")[0]
        scale = self.config["oversample"]
        if scale > 1:
            C, H, W = padded.shape
            padded = _resize(padded, (H * scale, W * scale))
        return padded, (pad, scale)

    def _postprocess(self, image, pad_info):
        pad, scale = pad_info
        if scale > 1:
            C, H, W = image.shape
            image = _resize(image, (H // scale, W // scale))
        th, tw = self.source_image.shape[-2:]
        crop = image[:, pad:pad + th, pad:pad + tw]
        return torch.clamp(crop, min=0.0)
