#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. In order it:
  1. prints the card (`nvidia-smi` name and power limit) and the torch and
     CUDA versions;
  2. builds the CUDA kernels of optiland_tpu_torch/csrc with nvcc, with
     the per-system variants of K1 and K3 for the bench lens and the Cooke
     triplet, of K5 for the vignetted bench lens and of K7 for the Cooke
     triplet, the per-ray variants of K1-K6 for the Cooke triplet and
     of K1 and K2 for a doublet of a tabulated glass, and the variants of
     phases (j3), (j4), (j5), (j6), (j7) and (j8)'s systems (their backward
     kernels built with their branches' definitions,
     `fused.backward_defines`), one
     process per source
     and per variant, all at once, and prints the seconds of each and
     nvcc's register report;
  2b. (t) T1, the peak-rate chains of tools/vpu_peak.py: each of its three
     kernels against its plain version on T1's input, then the port's tool
     (`vpu_peak.run`, as `python -m optiland_tpu_torch.tools.vpu_peak`
     runs it) for each, printing the four rates;
  3. builds the benchmark's 13-surface, 4-asphere lens in float32 on the
     card and draws 2,000,000 rays as bench.py draws them (seed 0);
  4. drives the forward path through the entry points a user calls,
     `centroid_rms_spot` (reaches K1) and `trace_system_final` (reaches
     K3), and
  5. checks its outputs: finite, of the expected shape, and in agreement
     with the port's eager float64 path on the card (an independent
     implementation: full Newton, autograd-friendly ops, no kernel);
  6. holds K1 and K3 (the bench lens's variants) against their plain
     PyTorch versions;
  7. (a) takes the training step at full width: `centroid_rms_spot(...,
     diff_inputs=False).backward()` (K1, K2), gradients of cv, conic,
     coeffs and thickness against the eager float64 path's autograd;
  8. (b) the input cotangents: `diff_inputs=True` gives Hy cotangents that
     agree with the plain version, `diff_inputs=False` the same parameter
     gradients bit for bit and zero Hy cotangents;
  9. (c) the backward of `trace_system_final` (K3, K4);
 10. (d) the caller-ray path: a vignetted 14 degree field leaves in-kernel
     raygen, so `trace_system_final` and its backward reach K5 (the
     vignetted lens's variant) and K6; values against the eager float64
     path;
 11. (e) holds K2, K4, K5 and K6 against their plain versions, and K2's and
     K6's parameter cotangents bitwise against a second launch;
 12. (f) a trainer: 5 torch.optim.Adam steps (lr 1e-4) of the training step;
 13. the flagship: the Cooke triplet (8 surfaces, absorbing SK16 and F2,
     3 fields x 3 wavelengths) built on the card in float32 and float64,
     and the 1,999,998-ray batch of `__graft_entry__._make_inputs(...,
     222_222)` (a numpy copy here, seed 0);
 14. (h) `trace_system` at per-ray wavelengths (reaches K7): every row of
     the (S, n) history against the plain version and against the eager
     float64 trace on the card;
 15. (i) the flagship training step: `__graft_entry__.entry`'s RMS-spot
     merit, `.backward()` (K7 forward, the eager twin's backward), finite
     gradients on every leaf that agree with float64 autograd, and 5
     torch.optim.Adam steps (lr 1e-4) over every leaf;
 16. (j) `centroid_rms_spot(..., 0.55)` and its backward on the Cooke
     triplet (K1's Cooke variant and K2 with absorption) against their
     plain versions and float64, the lit rays from K3's Cooke variant;
 16b. (j2) the polychromatic merit: `centroid_rms_spot` at the flagship
     batch's own per-ray wavelengths and its backward (the per-ray K1 and
     K2, nothing eager), the loss and every leaf the kernels differentiate
     (`mat_coeffs` included) against float64 autograd, 5 Adam steps; then
     each per-ray kernel against its plain version on that batch (K1, K2;
     K3 and K4 through `trace_system_final(..., w)` and its backward, K5
     and K6 through `trace_final` of the rays `generate_rays` makes at w),
     w's cotangents included, and the per-ray K1 and K2 on the tabulated
     doublet at wavelengths below, in and above its glass's table;
 16c. (j3) the coating, thin-lens and grating branches at the flagship's
     1,999,998 rays (`flagship_inputs`): system A, the Cooke triplet with
     the simple coating (0.98, 0.01) on its six refracting surfaces; B, a
     thin-lens transmission-grating spectrograph (`spectrograph`: object
     heights, a 600 lines/mm grating, its vignetted twin for K5 and K6);
     C, the concave reflective grating (`concave_grating`). Through the
     user's entry points, each with the counters at 0 just before and read
     just after: the polychromatic and the 0.55 um `centroid_rms_spot` with
     backward (K1, K2 in both configurations; the polychromatic loss and
     gradients against float64), 5 Adam steps of the polychromatic step,
     `trace_system_final` and its backward at 0.55 um and per-ray (K3, K4;
     on B's vignetted twin K5, K6), and `trace_system` (K7) with a backward
     through the eager twin on A and B; each kernel in each configuration
     against its plain version on the same inputs at TOL;
 16d. (j4) the phase sheets through the same paths and checks: system D,
     the hybrid achromat (`hybrid_achromat`); E, the coated metalens on a
     conic carrier (`curved_metalens`); F, the tilted reflective
     linear-grating sheet past its cutoff at 0.65 um (`phase_mirror`, its
     vignetted twin for K5 and K6); a cotangent group past TOL passes
     only by `near_float64`; then one eager `trace_system` of a cubic
     grid-phase sheet (`grid_sheet`) on the card against float64;
 16e. (j5) the freeform geometries through the same paths and checks:
     system G, a biconic and a toroidal face (`anamorphic_singlet`); H, a
     poly-XY and a 16-term Fringe Zernike (`xy_freeform_singlet`); I, a
     tilted, decentred Chebyshev and a Forbes Q-bfs
     (`tilted_freeform_singlet`, its vignetted twin for K5 and K6); first
     the count of rays the kernels' capped Newton leaves unconverged (none
     may), last a Forbes Q-2D system's `centroid_rms_spot` through K1;
 16f. (j6) the configurations the kernels took last, through the same
     paths and checks: system J, a
     Forbes Q-2D face of 16 terms, tilted and decentred (`q2d_singlet`, its vignetted twin for K5 and K6); K, a
     38-slot Fringe Zernike and a 29-slot Q-2D (`wide_freeform_singlet`);
     L, 70 surfaces of relays (`relay_train`); K1's blocks an SM and K2's
     threads a block printed, then a NURBS singlet (`trace_system` and its
     merit's gradient, the eager path, no kernel) against float64;
 16g. (j7) the system core: WideAngle100FOV's `trace_generic` at its three
     fields, 1,999,998 rays, iteratively aimed (the aim timed apart), and
     ProjectionLens120FOV's `wavefront_data` robustly aimed on the
     Huygens PSF's 128 x 128 pupil grid (its rounds and time printed), K7
     on each aimed bundle against its plain version and each aim against
     its own target (the rays' stop hits over the stop radius equal (Px,
     Py) within TOL_AIM); UVProjectionLens (object-space telecentric) and
     the Cooke triplet with real and paraxial image-height fields at
     1,999,998 rays through `trace_system_final` and its backward (K5, K6
     after the eager raygen, against their plain versions), the
     telecentric `trace_system` (K7); the eager HubbleTelescope (annular
     aperture), `fold_mirror` (absolute coordinates) and
     `apodized_singlet` at 65,536 rays in float32 against float64 on the
     card (TOL_EAGER); and the zoo's 26 lenses' `trace` in float64 on the
     card against the CPU (TOL_ZOO);
 16h. (j8) the design loop: (a) the bench lens (cv x 1.05) under
     `design_problem`'s merit (RMS spots at 0 and 14 degrees over 2,000,017
     rays each, f2, total track, the Seidel spherical sum, the chief ray's
     image height; the radii of its curved faces and its back gap):
     `sum_squared`, `fun_array` and `value_and_grad` (K7 three times an
     evaluation, its backward the eager twin) against K7's plain version
     and the eager float64 path, the residual Jacobian, 5 Adam steps, 3
     iterations of scipy's minimize and least_squares, each timed; (b) the
     Cooke triplet's Monte-Carlo draws (16, seed 1) and a 5-step sweep with
     the image gap compensated (`cooke_tolerancing`) against float64; (c)
     GlassExpert on its middle glass (GLASSES_J8), the K7 variants built at
     first use printed; (d) environment/ in float64, card against CPU;
 16i. (j9) polarization, thin films, BSDFs and the vectorial wave optics,
     which JAX's gates keep from every kernel (`phase_j9`; no K1-K8 launch
     may occur there, the uncoated unpolarized twin keeps its K7): (a) the
     Cooke triplet with "fresnel" on its six glass faces, unpolarized, and
     (b) with a MgF2 layer between each face's media under POL_STATE, at
     the flagship's 1,999,998 rays through `trace_system(...,
     polarization=)` and `Optic.trace`, float32 against float64 on the card
     (positions, directions, intensity, |p|; the gradient of the mean
     intensity in cv and thickness at the whole batch, and against float64
     on its first J9_GRAD_RAYS); (c) the polarizer goldens (extinction,
     Malus's law, halving, a quarter wave between crossed polarizers) at
     1,999,998 rays; (d) Lambertian and Gaussian (0.1) BSDFs on a
     singlet's flat face at 1,999,998 rays, on injected draws against
     float64 and on a generator's stream against the law's moments; (e)
     `VectorialHuygensPSF`, `VectorialFFTPSF` at (0, 0) and (0, 1) and
     `VectorialFFTMTF` at their defaults against float64 and the scalar
     Strehl ratios, with the Huygens call's split (each stage clocked
     inside the call); (f) ThinFilmOptimizer on the card against the CPU;
 16j. (j10) the analyses (`phase_j10`): `SpotDiagram(CookeTriplet(),
     num_rings=272)`, 2,004,921 rays through K7 (two launches: the bundle
     and the chief rays), its image rows against K7's plain version on the
     same rays at TOL and its RMS and geometric radii against the eager
     float64 path on the card, K7 timed on that batch; every other
     analysis of `analysis/`, `GeometricMTF` and colorimetry (on a thin-film
     stack's transmission) at its defaults, float32 against float64 on the
     card (TOL_J10; the random pupils seeded alike, `seeded_draws`), the
     image simulation on a 512 x 512 RGB image; `Distortion` and
     `FieldCurvature`, rounding-bound, in float64 on the card against the
     CPU; each row with its host-clock time and launches;
 16k. (j11) ray-batch sharding (`phase_j11`, `optiland_tpu_torch/parallel`):
     (a) the flagship training step (K7, Adam over every leaf) at
     1,999,998 rays on a one-rank NCCL ("hosts", "chips") mesh and the
     spot merit at 0.55 um (K1, K2) on a one-rank ("rays",) mesh, bitwise
     against the unsharded steps (under PyTorch's deterministic
     algorithms: the extinction tables' gather adds by atomics); (b) both
     on two spawned gloo ranks on the one card (`parallel.dryrun.spawn`;
     NCCL takes one rank per card), 999,999 rays each, within TOL of the
     unsharded steps (a cancelling leaf within `j11_grad_limits`' limit,
     which must lie below the error of a reduction that lost a rank), K1,
     K2 and K7 launched on each rank, each rank's steps and kernels timed,
     the kernels line's rows of K1, K2 and K7 under the mesh, each held to
     its plain version on rank 0's shard within TOL; (c) in the same ranks, phase j8's 16 tolerancing
     draws split over them by `MonteCarlo(mesh=)`, equal to the unsharded
     run; (d) the Cooke triplet through the JSON, Zemax and CODE V
     writers and readers, traced through K7 against the original; the ML
     wrapper's Adam steps against float64; the 3-D scene (K7), a sag grid
     and `info()`, `draw` and `draw3D` under Agg where matplotlib is
     installed; an SMF source through `trace_source` against float64;
 17. (k) `CookeTriplet().trace(Hx=0, Hy=1, num_rays=6)`, the user's entry,
     reaches K7;
 18. (w1) K8, the Huygens sum, on the inputs of the Cooke triplet's
     `ScalarHuygensPSF` at its defaults (128 x 128 pupil samples and image
     points, field (0, 1)) and of `HuygensMTF`'s (64 x 64, on axis): K8 and
     the float32 plain version each against the float64 plain version on
     the same inputs (PSF, Strehl, MTF), and two launches bitwise equal;
     the same for the PSF's normalizing peak sum alone (1 x 16384) and for
     the random inputs of tools/bench_wave_optics.py (16384 x 8192, OPD up
     to 20 mm: phases up to ~2.3e5 rad);
 19. (w2) `ScalarHuygensPSF` at its defaults, fields (0, 0) and (0, 1), in
     float32 (K7 under `wavefront_data`, K8) against the same class in
     float64 on the card;
 20. (w3) `HuygensMTF` at its defaults (K8) against float64;
 21. (w4) `ScalarFFTPSF`, `MMDFTPSF`, `ScalarFFTMTF` over the 3 fields,
     `SampledMTF` and `ZernikeOPD` at their defaults, float32 (K7 under
     `wavefront_data`) against float64;
 22. (g) times each kernel with CUDA events (warm-up, then the median of
     25 calls) and its plain version (the median of PLAIN_CALLS), K1 and
     K3 also on the Cooke triplet, K7 also on the 16,384-ray bundle of
     `wavefront_data`, K8 also at the peak
     sum, the random inputs of tools/bench_wave_optics.py and
     256 x 256 (with the phase range each reduces), K1-K6's per-ray
     variants at 1,999,998 and 16,384 rays, phases (j3)-(j8)'s kernels
     (each plain version's time its comparison's own call: once, cold,
     host clock), the training steps (the polychromatic one beside the
     monochromatic one, the flagship's and those of phase (j3)'s systems),
     the flagship forward and the Huygens PSF end to end, and prints one
     JSON line of kernels;
 23. checks the whole run's seconds against its limit, RUN_LIMIT_S, and
     prints as its last line {"ok": true, "device": {...}}.
Every path is driven with all the launch counters set to 0 just before it
and read just after, and fails unless its kernels were launched.

Any failed check raises and the script exits non-zero. Without a CUDA card,
or without the repository around it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
N_RAYS = 2_000_000
WAVELENGTH = 0.5876
TIMED_CALLS = 25
# a plain version's time in the kernels line: the median of 3 calls after
# one warm-up (at 2M rays the plain versions take 25-100 ms a call, and
# medians of 25 cost ~20 s of the run for no information the kernels need)
PLAIN_CALLS = 3
TIMED_STEPS = 10
GRAD_LEAVES = ("cv", "conic", "coeffs", "thickness")
# Adam moves every coordinate by about lr per step whatever its scale; the
# asphere coefficients (1e-7 to 3e-15) would jump by orders of magnitude,
# so the trainer steps the other three leaves
TRAIN_LEAVES = ("cv", "conic", "thickness")
ADAM_STEPS, ADAM_LR = 5, 1e-4

# Peak rates of one H100 SXM (NVIDIA's data sheet, at its 700 W limit):
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel-vs-plain tolerances, float32 on the card. The kernel contracts
# multiply-adds into FMAs and uses the hardware rsqrt, the plain version
# runs PyTorch's elementwise kernels, so the two round differently: at
# image heights up to ~25 mm and paths of ~300 mm, f32 spacing is 2e-6 mm
# and 3e-5 mm, and a 12-surface chain amplifies a few ulps per surface.
# Cotangents are held relative to the largest entry of their group: a
# parameter's is a sum over 2M rays (blocked sums in another order), a
# per-ray one carries the chain's conditioning (the plain f32 version is
# ~5e-4 of scale off float64 on the bench lens, on the CPU) and is
# compared on the rays whose intensity both versions agree on.
TOL = {
    "position_mm": 5e-4,     # x, y, z
    "direction": 1e-5,       # L, M, N
    "opd_mm": 2e-3,          # 12 accumulated |t n| terms of ~30 mm
    "intensity_frac": 1e-5,  # rays whose i differs (edge TIR / clipping)
    # i of the rays both keep: a product of three f32 exp factors of about
    # 0.9995 each (absorbing glass), a few ulps (6e-8) apart
    "intensity": 2e-6,
    "moment_rel": 1e-4,      # moments, relative to their natural scale
    "param_grad_rel": 1e-4,  # raygen-scalar and table cotangents
    "ray_grad_rel": 5e-3,    # per-ray cotangents
}
# The main path against the eager float64 path: float32 against float64
# (kernel: capped Newton; eager: 16 iterations), same scales.
TOL_F64 = {"position_mm": 5e-4, "direction": 1e-5, "moment_rel": 1e-4,
           "loss_rel": 1e-3, "grad_rel": 1e-4, "opd_mm": 2e-3,
           "intensity": 2e-6}
# Some flagship gradients cancel: the merit is invariant to a common scale
# of the intensities (the extinction tables act only through it), and the
# raygen's start plane moves with the aperture, a shift each ray's trace
# undoes (the aperture, the wavelengths through the paraxial pupil, the
# vignetting factors). In float32 they miss float64 by more than 1e-4 of
# their largest entry in the eager float32 trace itself, with no kernel
# (printed beside). The kernel path rounds its forward differently (FMA
# contraction), an independent draw of that noise. Each flagship gradient
# is held to the larger of TOL_F64["grad_rel"] and this factor times the
# eager float32 path's own error on the same leaf.
GRAD_NOISE_FACTOR = 10
# A check of phase j4's systems only (D, E, F): some of their backward
# kernels' parameter cotangents are near-cancellations under fixed seeds
# (the hybrid achromat's front conic under K2's moment weights c, the
# metalens's highest radial slot, whose rays' terms weigh r^14), whose
# float32 sums miss float64 by more than TOL["param_grad_rel"] in every
# float32 version, kernel and plain, on the card and on the CPU, each with
# its own rounding and reduction order. A group that misses
# TOL["param_grad_rel"] against the plain version passes only if the
# kernel is within the larger of that and F64_FACTOR times the float32
# noise of the plain version run in float64 on the same inputs, the noise
# being the larger of the plain float32 version's own errors against it on
# the card and on the CPU (`float64_errs`, printed). Every other phase,
# and every group within TOL, is held to TOL alone.
F64_FACTOR = 2
PHASE_SYSTEMS = ("D", "E", "F")
# Phase j7's UVProjectionLens: 44 surfaces over ~1.3 m of track, its image
# heights to 12 mm and paths to 1,300 mm. float32 spacing there (6e-5 mm at
# 1,000 mm) puts the plain float32 version's own error against float64
# past TOL's absolute position and OPD bounds (set at the bench lens's
# scale): x 3.1e-4, y 4.7e-4, OPD 1.4e-3 mm at 20,000 of its rays on the
# CPU, more over 1,999,998 rays. On this system alone a final array or a
# cotangent group past TOL passes by the rule of phase j4's: the kernel
# within F64_FACTOR times the plain float32 version's own error against
# the plain version run in float64 (`final_float64_errs`, `float64_errs`).
LONG_TRACK_SYSTEMS = ("UV",)
# the flagship batch: `__graft_entry__._make_inputs(static, params, 222_222)`
FLAGSHIP_RAYS_PER_FIELD = 222_222
FLAGSHIP_WAVELENGTH = 0.55   # `dryrun_multichip`'s primary-wavelength phase

# K8 against the float64 plain version on the same float32 inputs. float32
# rounds R ~ 54 mm to ~4e-6 mm, up to 0.02 rad of phase at k = 1.1e4 /mm,
# per term, and over a regular pupil grid those roundings are correlated
# (R varies smoothly): the summed phase tilts a little, so the largest
# errors sit on the PSF's slopes. The plain float32 version's own error is
# 1.8e-3 to 2.1e-3 of the peak at the PSF's defaults on the CPU (1.8e-4 at
# the peak itself, Strehl 1e-4, MTF 1.4e-4 to 2.5e-4). K8 is held to twice
# the plain float32 version's error and to 1e-2 of the peak; Strehl and
# the MTF to 1e-3 absolute. (K8 forms R - Rp and the OPD's phase without
# those roundings, csrc/huygens.cuh, and lands well inside both.)
TOL_K8 = {"psf_of_peak": 1e-2, "plain_factor": 2.0, "strehl": 1e-3,
          "mtf": 1e-3}
# A whole float32 analysis against float64 also carries the float32
# trace's OPD noise: paths of ~100 mm rounded to ~4e-6 mm give 0.014-0.018
# waves rms (0.05 max) of OPD on the Cooke triplet's 128 x 128 pupil, the
# eager float32 trace on the CPU against float64. Measured there, float32
# against float64: Huygens PSF 4.6e-3 and 7.5e-3 of the peak, Strehl 9e-5
# and 6.0e-4, pixel pitch 2.7e-4 relative (the spot's extent), Huygens MTF
# 4.7e-3 (4.7e-3 with a float64 sum of the float32 wavefront: the trace,
# not the sum); FFT and MMDFT PSF 2.2e-2 of the peak, Strehl 2.2e-3; FFT
# MTF 9.3e-3; sampled MTF 4.4e-3; Zernike coefficients 5.4e-3 waves, RMS
# 0.6%. Each tolerance is about 2.5x that.
TOL_WAVE = {"huygens_psf_of_peak": 2e-2, "huygens_strehl": 2e-3,
            "centroid_mm": 5e-4, "pixel_pitch_rel": 1e-3, "huygens_mtf": 1e-2,
            "fft_psf_of_peak": 5e-2, "fft_strehl": 5e-3, "fft_mtf": 2.5e-2,
            "sampled_mtf": 1.2e-2, "zernike_waves": 1.5e-2, "rms_rel": 2e-2}
SAMPLED_FREQS = [(0.0, 0.0), (10.0, 0.0), (0.0, 30.0), (50.0, 50.0),
                 (100.0, 0.0)]
# T1's kernels against their plain versions. At T1's step counts the FMA
# chain's kernel rounds each step once (fmaf), the plain version twice (a
# multiply, then an add): up to ~6e-8 relative a step over 512 steps, 3e-5
# at worst, where the polynomial grows (x * 0.51 above 1); rsqrt has
# converged to its fixed point and tan has underflowed to 0 in both, which
# the script asserts rather than compares. So each chain is also held at 1
# and 2 steps, where every element's value is still its own (tan ~1e-3 and
# ~1e-6, rsqrt in [0.53, 0.71]), and the tan chain at 1 step on 1000 x
# T1's input (tan over [1, 2), across its pole): within TOL_T1_ULPS units
# in the last place of the plain version, one rounding of fmaf against two
# a step, rsqrtf's and tanf's own against torch's.
TOL_T1 = {"fma": ("rel", 1e-4), "rsqrt": ("rel", 1e-6)}
TOL_T1_ULPS = 4.0
T1_FIXED_POINT = 0.6776506   # a^2 (a + 1.5) = 1, the rsqrt chain's limit
# T1's functions: FP32 operations an element (each rsqrt and tan one, as
# `chain_ops_per_ray` counts) and the TPU kernel each replaces
T1_OPS = {"fma": 1 + 2 * 512, "rsqrt": 2 * 64, "tan": 2 * 64}
# The rsqrt and tan chains are special-function work: the bound of each is
# its special-function instructions an element over the card's
# special-function rate, SFU_PER_CLOCK_SM results a clock on each SM
# (compute capability 9.0, the CUDA C++ Programming Guide's throughput
# table: reciprocal, reciprocal square root, sine, cosine, log2, exp2, and
# conversions from float to integer) at the card's maximum SM clock
# (`nvidia-smi --query-gpu=clocks.max.sm`), ~4.2e12/s on an H100 SXM. The
# counts are the instructions of that rate in each chain's step in the
# SASS of csrc/vpu_peak.cu (`cuobjdump -sass`): rsqrtf emits one MUFU.RSQ;
# tanf one F2I.NTZ (its quadrant) and one MUFU.RCP (predicated, the
# reciprocal of the odd quadrants), beside ~25 FP32-pipe instructions of
# its reduction and polynomial, which this bound leaves out.
SFU_PER_CLOCK_SM = 16
T1_SFU = {"rsqrt": 64, "tan": 2 * 64}
T1_REPLACES = {"fma": ("fma_kernel", "tools/vpu_peak.py:22"),
               "rsqrt": ("sqrt_kernel", "tools/vpu_peak.py:32"),
               "tan": ("tan_kernel", "tools/vpu_peak.py:39")}

def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bench_lens(Optic, vignetted=False):
    """The benchmark prescription (bench.py:33-56): 10 glass surfaces, 4
    even aspheres, imageFNO 5, angle fields 0 and 14 degrees; `vignetted`
    gives the 14 degree field vignetting factors vx = vy = 0.1."""
    lens = Optic("Bench10")
    inf = math.inf
    asph = (1e-7, -2e-11, 3e-15)
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=56.20238, thickness=8.75, material=1.617,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=2, radius=152.28580, thickness=0.5)
    lens.add_surface(index=3, radius=37.68262, thickness=12.5, material=1.607)
    lens.add_surface(index=4, radius=inf, thickness=3.8, material=1.603,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=5, radius=24.23130, thickness=16.369445)
    lens.add_surface(index=6, radius=inf, thickness=13.747957, is_stop=True)
    lens.add_surface(index=7, radius=-28.37731, thickness=3.8, material=1.603,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=8, radius=inf, thickness=11, material=1.620,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=9, radius=-37.92546, thickness=0.5)
    lens.add_surface(index=10, radius=177.41176, thickness=7, material=1.620)
    lens.add_surface(index=11, radius=-79.41143, thickness=61.487536)
    lens.add_surface(index=12)
    lens.set_aperture(aperture_type="imageFNO", value=5)
    lens.set_field_type("angle")
    lens.add_field(y=0)
    if vignetted:
        lens.add_field(y=14, vx=0.1, vy=0.1)
    else:
        lens.add_field(y=14)
    lens.add_wavelength(value=WAVELENGTH, is_primary=True)
    return lens


def bench_rays(device):
    """2M rays drawn as bench.py:74-80 draws them."""
    rng = np.random.default_rng(0)
    r = np.sqrt(rng.uniform(size=N_RAYS)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, size=N_RAYS).astype(np.float32)
    Px = torch.from_numpy(r * np.cos(th)).to(device)
    Py = torch.from_numpy(r * np.sin(th)).to(device)
    Hy = torch.from_numpy(rng.uniform(-1, 1, size=N_RAYS).astype(
        np.float32)).to(device)
    return torch.zeros_like(Hy), Hy, Px, Py


def raygen_ops(static):
    """FP32 operations per ray of the in-kernel raygen (csrc/chain.cuh
    `tile_raygen`): 32 for an angle field with an infinite object, 30 with
    a finite one (no pupil term in the origin), 24 for object heights (no
    tangents)."""
    if static.field_type != "angle":
        return 24
    return 32 if static.object_infinite else 30


# FP32 operations per ray of the coating, thin-lens and grating branches
# (csrc/chain.cuh `thin_lens`, `grating_frame`, `diffract`), counted as
# `chain_ops_per_ray` counts: the thin lens's bending and OPD term; the
# grating equation on its frame (the projected period, the oriented normal,
# the tangential parts, T, Q, the root and the renormalized direction),
# the frame a plane's (cos, sin and a sign) or a curved carrier's (the
# conic's sag gradient and normal, the lifted groove tangent and the unit
# cross product); a coating's factor one multiply
THIN_LENS_OPS = 23
GRATING_OPS = 71
GRATING_FRAME_OPS = {"plane": 3, "curved": 49}
COATING_OPS = 1
# and of their adjoints (csrc/chain_bwd.cuh `thin_lens_bwd`,
# `diffract_bwd`): the cotangents the closed forms make, the curved frame's
# through the sag gradient (31, the conic's `sag_grad_bwd`) besides; a
# coating's cotangent i_pre di_post and the intensity cotangent's passage
# through the surface
THIN_LENS_BWD_OPS = 56
GRATING_BWD_OPS = {"plane": 150, "curved": 250}
COATING_BWD_OPS = 3
# of a phase sheet (csrc/chain.cuh `phase_sheet`): the carrier's raw
# normal (21), the scaled gradient, l.n, e, the tangential wavevector, R^2,
# the signed root, the outgoing direction renormalized and the OPD term
# (49), and its profile's value and gradient (`phase_vg`) by kind: a
# constant none, the radial sum over its 8 slots 55, the linear grating 3;
# and of its adjoint (csrc/chain_bwd.cuh `phase_sheet_bwd`, 136: the
# normalization's, the root's, the projections', the OPD term's, the
# normal's and the conic's `sag_grad_bwd`) and of `phase_vg_bwd` by kind
# (the radial kind's second derivative sum and its 8 slots' cotangents)
PHASE_OPS = 70
PHASE_VG_OPS = {1: 0, 2: 55, 3: 3}
PHASE_BWD_OPS = 136
PHASE_VG_BWD_OPS = {1: 1, 2: 87, 3: 8}


# of a freeform surface (csrc/freeform.cuh, under OTK_FREEFORM), counted
# by hand per family as `chain_ops_per_ray` counts, from the closed forms a
# hand-written sag would take (nested Horner sums, the families'
# recurrences, constants of the surface folded at launch): `freeform_ops`.
# The conic part of a freeform's sag: its value at r^2 (r^2 3, the root's
# argument 4, its square root, 1 +, cv r^2, the divide), its gradient (cv /
# s, times x and y), its partials in cv and k from the forward's h = r^2 /
# (1 + s) (h h / s, dz/dk 0.5 cv^3 that, dz/dcv h + a cv^2 that), and the
# cotangent of the normal through it (cv a cv^2 / s^3 times x.v, the
# Hessian's two rows; d(cv / s)/dcv and /dk times x.v)
CONIC_FF = {"value": 12, "grad": 3, "partials": 7, "normal_bwd": 23}
# a 1-D conic profile of a biconic or a toroidal: t^2, then as the conic
CONIC_1D = {"value": 10, "grad": 2, "partials": 7, "normal_bwd": 14}


def _horner2(terms):
    """FP32 operations of a nested Horner sum of `terms` constant-weighted
    terms (an FMA a term but the first)."""
    return max(2 * (terms - 1), 0)


def freeform_ops(code, nc, aux):
    """FP32 operations per evaluation of the sag of freeform family `code`
    with nc coefficient slots and aux ints `aux`, counted by hand from each
    family's closed form: {"vg": its value and gradient (each Newton update
    and the normal take one), "partials": its partials in every parameter
    beyond the forward's values, each times the ray's weight (the hit's
    implicit-function derivative), "normal_bwd": the cotangent of x, y and
    every parameter from that of (dz/dx, dz/dy), the gradient of D_v z
    (the sag's Hessian times v and its mixed derivatives), beyond the
    forward's values}. Where a parameter's cotangent is a sum over rays,
    its one add a ray counts in `backward_ops_per_ray`'s slots."""
    pos = lambda v: max(v, 0)  # noqa: E731
    conic = CONIC_FF
    if code == 4:    # poly-XY: sum C_ij x^i y^j on an n1 x n1 grid
        n1 = int(round(nc ** 0.5))
        value = conic["value"] + _horner2(nc) + 1
        # dz/dx: Horner in x of i P_i(y); dz/dy: the rows' Horner sums of
        # j C_ij y^(j-1), then Horner in x
        grad = (conic["grad"] + 3 * pos(n1 - 2) + n1 * _horner2(n1 - 1)
                + _horner2(n1) + 2)
        monomials = 2 * pos(n1 - 2) + (n1 - 1) ** 2
        partials = conic["partials"] + monomials + nc + 2
        # the Hessian's three second-derivative grids by Horner, H v; each
        # slot's D_v x^i y^j = i v_x x^(i-1) y^j + j v_y x^i y^(j-1)
        hess = (2 * _horner2(pos(n1 - 2) * n1) + _horner2((n1 - 1) ** 2)
                + 8)
        mixed = 4 * pos(n1 - 1) + 3 * (n1 - 1) ** 2 + monomials
        return {"vg": value + grad, "partials": partials,
                "normal_bwd": conic["normal_bwd"] + hess + mixed}
    if code == 5:    # biconic: a 1-D conic in x and one in y, summed
        one = CONIC_1D
        return {"vg": 2 * (one["value"] + one["grad"]) + 1,
                "partials": 2 * one["partials"] + 4,
                # the Hessian diagonal c / s^3 times v; d(c / s)/dc, /dk
                "normal_bwd": 2 * (4 + 10)}
    if code == 6:    # toroidal: z_y the y-curve (cv, k) plus sum alpha_i
        # y^(2i) over its nc - 1 slots (Horner in y^2), rotated about a
        # radius 1 / c: z = (1 - sqrt(w)) / c, w = (1 - c z_y)^2 - c^2 x^2
        one, alphas = CONIC_1D, nc - 1
        value = one["value"] + 2 * alphas + 15
        # z_x = c x / sqrt(w), z_y = (1 - c z_y) / sqrt(w) dz_y/dy
        grad = one["grad"] + 2 * alphas + 5
        # the y-curve's cv, k times dz/dz_y, alpha_i's y^(2i) times it,
        # d/dc, the weights
        partials = one["partials"] + 2 + pos(alphas - 1) + alphas + 10 + (
            nc + 2)
        # z_xx, z_xY, z_YY from 1 / w^(3/2), z_y'' (the y-curve's c / s^3
        # and the polynomial's), H v; the mixed terms through z_y and z_y'
        hess = 6 + 3 + 3 + pos(2 * alphas - 1) + 1 + 4 + 6
        mixed = 5 + one["partials"] + 9 + 6 + pos(6 * alphas - 1) + 15
        return {"vg": value + grad, "partials": partials,
                "normal_bwd": hess + mixed}
    if code == 7:    # Chebyshev: sum C_ij T_i(x / nx) T_j(y / ny)
        rows, cols = aux
        value = (conic["value"] + 2 + 1 + 2 * pos(rows - 2) + 1
                 + 2 * pos(cols - 2) + rows * _horner2(cols) + _horner2(rows)
                 + 1)
        # T' by its recurrence, the rows' sums of C_ij T_j', the two dots
        grad = (conic["grad"] + 1 + 4 * pos(rows - 3) + 1 + 4 * pos(cols - 3)
                + rows * _horner2(cols - 1) + _horner2(rows - 1)
                + _horner2(rows) + 2 + 2)
        # T_i T_j of the slots, the norms' -x / nx dz/dx, the weights
        partials = conic["partials"] + pos(rows - 1) * pos(cols - 1) + 2 + (
            nc + 2)
        # T'' by its recurrence, the three second-derivative dots, H v;
        # each slot's (v_x / nx) T_i' T_j + (v_y / ny) T_i T_j', the norms'
        hess = (4 * pos(rows - 3) + 4 * pos(cols - 3) + _horner2(rows - 2)
                + 1 + rows * _horner2(cols - 2) + _horner2(rows) + 1
                + _horner2(rows - 1) + 1 + 8)
        mixed = 2 * rows + 2 + 3 * rows * cols + 16
        return {"vg": value + grad, "partials": partials,
                "normal_bwd": conic["normal_bwd"] + hess + mixed}
    if code == 8:    # Zernike: sum c_t R_t(rho^2) (C_m or S_m), C_m + i S_m
        # = (xn + i yn)^m
        from optiland_tpu_torch.zernike import indices
        terms = [((n - abs(m)) // 2, abs(m)) for n, m in indices(
            ("fringe", "noll", "standard")[aux[0]], nc - 1)]
        m_max = max(am for _, am in terms)
        value = conic["value"] + 2 + 3 + 6 * pos(m_max - 1) + sum(
            2 * d + 2 + (am > 0) for d, am in terms) + 1
        # A = sum c R' h and B = sum c R grad h (d h = m h_(m-1)), then
        # (2 xn A + B) / R
        grad = sum((2 * pos(d - 1) + 2 + (am > 0) if d else 0)
                   + (5 if am else 0) for d, am in terms) + 8 + conic["grad"] + 2
        # each slot's R h, the norm's -(x dz/dx + y dz/dy) / R, the weights
        partials = conic["partials"] + sum(am > 0 for _, am in terms) + 4 + (
            nc + 2)
        # R'' and the second derivatives of h per term, H v of the sums; each
        # slot's D_v (R h), the norm's
        hess = sum(2 * pos(d - 2) + (2 + (am > 0) if d >= 2 else 0)
                   + (5 if d and am else 0) + (5 if am >= 2 else 0)
                   for d, am in terms) + 2 + 25 + 4
        mixed = 3 + sum((8 if d else 5) if am else (2 if d else 0)
                        for d, am in terms) + 4
        return {"vg": value + grad, "partials": partials,
                "normal_bwd": conic["normal_bwd"] + hess + mixed}
    if code == 10:   # Forbes Q-2D: z_conic + phi [u^2 (1 - u^2) sum_n
        # a_n^0 Q_n^0(u^2) + sum_m (C_m sum_n a_n^m Q_n^m + S_m sum_n b_n^m
        # Q_n^m)], each group's orthonormal weights a surface's constants
        tops = {}
        for n, m in aux:
            tops[m] = max(tops.get(m, 0), n)
        m_max = max(abs(m) for m in tops)

        def group(m, n):   # Clenshaw (3 a step) or the three-term
            # recurrence (6), the group's factor and its sum into the total
            if m == 0:
                return 3 * n + 2 + 2 + 3 + 1
            return 6 * n + 1 + (2 if abs(m) == 1 and n > 2 else 0) + 2

        gv = sum(group(m, n) for m, n in tops.items())
        # x / R, y / R, u^2; phi (9); the harmonics' recurrence (6 an
        # order); phi times the sum, plus the conic
        value = conic["value"] + 4 + 9 + 6 * m_max + gv + 2
        # each sum's derivative in u^2 by its derivative recurrence, the
        # harmonics' m (C_(m-1), S_(m-1)) / R, phi', the products, 2 x, 2 y
        grad = conic["grad"] + gv + 4 * len(tops) + 4 * m_max + 8 + 6
        # phi's cv and k, the basis values by the transposed sums, the norm
        # radius's, the weights
        partials = conic["partials"] + 8 + 2 * gv + 4 + (nc + 2)
        # the second derivatives of the sums and harmonics, H v; the mixed
        # terms of cv, k and R, the basis values' derivatives
        hess = 2 * gv + 8 * m_max + 29
        mixed = 2 * gv + 4 * len(tops) + 15 + 2 * (nc + 2)
        return {"vg": value + grad, "partials": partials,
                "normal_bwd": conic["normal_bwd"] + hess + mixed}
    # Forbes Q-bfs: z_conic + u^2 (1 - u^2) phi sum_n a_n Q_n(u^2), u = r /
    # R, by Clenshaw's sum (its M = nc - 1 terms' orthonormal weights a
    # surface's constants); the gradient a radial one
    m = nc - 1
    value = conic["value"] + 1 + 1 + 4 + 3 + 2 + 3 * pos(m - 1) + 2 + 2
    # (pre S)' by Clenshaw's derivative sum, phi' = 1 / (2 phi D^2), 2 x, 2 y
    grad = conic["grad"] + 3 + 4 * pos(m - 1) + 2 + 4 + 8 + 5
    # phi's cv and k (8), the basis values by the transposed Clenshaw sum,
    # the norm radius's, the weights
    partials = conic["partials"] + 8 + 8 * m - 1 + 2 + 3
    # the radial second derivative (Clenshaw's second sum), H v; the mixed
    # terms of cv and k, the basis values' derivatives, the norm radius's
    hess = 4 * pos(m - 1) + 2 + 20 + 9
    mixed = 15 + 12 * m + 8 + 2 * (m + 3)
    return {"vg": value + grad, "partials": partials,
            "normal_bwd": conic["normal_bwd"] + hess + mixed}


def _freeform(static, k):
    """Surface k's freeform code and its `freeform_ops`, or (0, None)."""
    code = static.geom_codes[k]
    if code not in (4, 5, 6, 7, 8, 9, 10):
        return 0, None
    return code, freeform_ops(code, static.geom_n_coeffs[k],
                              static.geom_aux[k])


def chain_ops_per_ray(static, fused):
    """FP32 operations per ray of the chain in csrc/chain.cuh for this
    system, counted from its branches: each add, subtract, multiply,
    divide, sqrt, rsqrt, tan, sin and cos counts one (an FMA two), the way
    the 67 TFLOP/s peak counts them; selects and compares count none. The
    Newton loop has a fixed trip count, so the count holds for any data."""
    ops = raygen_ops(static)
    n_newton = min(static.newton_iters, fused._NEWTON_FUSED_MAX)
    for k in range(1, static.num_surfaces):
        code, nc = static.geom_codes[k], static.geom_n_coeffs[k]
        asphere = code in (2, 3) and nc > 0
        odd = code == 3 and nc > 0
        ops += 1 + 2 + 1 + 43 + 9  # position, z shift, 1+k, conic root, step
        if static.has_tilt[k] or static.has_decenter[k]:
            ops += 4
        if static.has_tilt[k]:
            ops += 3 + 6 * 14
        if asphere:
            ops += (n_newton + 1) * (29 + 7 * nc + (6 if odd else 0))
        ff, ffo = _freeform(static, k)
        if ff:   # the Newton updates on the sag's value and gradient
            ops += (min(static.newton_iters, fused._NEWTON_FUSED_MAX_FF)
                    + 1) * (ffo["vg"] + 13)
        if static.has_aperture[k]:
            ops += 5
        inter = static.interactions[k]
        if inter == fused.INT_THIN_LENS:
            ops += THIN_LENS_OPS
        elif inter == fused.INT_DIFFRACT:
            ops += GRATING_OPS + GRATING_FRAME_OPS[
                "plane" if code == 0 else "curved"]
        elif inter == fused.INT_PHASE:
            ops += PHASE_OPS + PHASE_VG_OPS[static.phase_kinds[k]]
        elif inter != 3:  # normal, orientation, l.n
            ops += (ffo["vg"] + 9 if ff else
                    28 + 4 * nc + (6 if odd else 0)) + 5
            ops += 7 if inter == 1 else 18
        if fused._coated(static, k):
            ops += COATING_OPS
    return ops


def backward_ops_per_ray(static, fused, raygen=True):
    """FP32 operations per ray of a backward kernel's function, counted as
    `chain_ops_per_ray` counts: the forward once (its re-trace), then the
    adjoint once. The adjoint of each piece (csrc/chain_bwd.cuh) counts the
    operations that make cotangents, with every forward value it reads
    taken from the forward: the sag gradient and normal at the hit, the
    refraction's u, d2 and q, a plane's A, B and C, the rotations' cos and
    sin, the polynomial's lower powers. The sweep recomputes those from its
    record, a cost of the design and not of the function. A plane takes
    the branch of cv = 0. A parameter's cotangent is a sum over rays: one
    add per ray for each slot. With `raygen`, the raygen adjoint and its
    row; without it (K6) the forward starts from loaded rays."""
    ops = chain_ops_per_ray(static, fused)
    ops += 56 + 5 if raygen else -raygen_ops(static)
    for k in range(1, static.num_surfaces):
        code, nc = static.geom_codes[k], static.geom_n_coeffs[k]
        asphere = code in (2, 3) and nc > 0
        odd = code == 3 and nc > 0
        inter = static.interactions[k]
        tilted = static.has_tilt[k]
        moved = tilted or static.has_decenter[k]
        ops += 16 + 3                # propagation and opd; vertex z, thickness
        ops += 4 if moved else 0     # decenter
        ops += 6 * 20 if tilted else 0   # the six rotations
        if inter == fused.INT_THIN_LENS:
            ops += THIN_LENS_BWD_OPS
        elif inter == fused.INT_DIFFRACT:
            ops += GRATING_BWD_OPS["plane" if code == 0 else "curved"]
        elif inter == fused.INT_PHASE:
            ops += PHASE_BWD_OPS + PHASE_VG_BWD_OPS[static.phase_kinds[k]]
        ff, ffo = _freeform(static, k)
        if inter in (0, 1):   # reflection or refraction, normal, sag gradient
            ops += (24 if inter == 1 else 57) + 17
            ops += (ffo["normal_bwd"] if ff else
                    31 if not asphere else (34 if odd else 28) + 7 * nc)
        if fused._coated(static, k):
            ops += COATING_BWD_OPS
        # the hit: a plane's closed form; the IFT, with the sag's
        # denominator and top power, which the forward does not form (a
        # freeform's: its sag's partials)
        ops += (56 if code == 0 else 34 + ffo["partials"] if ff
                else 34 + 2 * nc + int(asphere))
        slots = 3 + (nc if asphere or ff else 0) + (3 if tilted else 0) + (
            2 if moved else 0) + (1 if inter in (0, 2, 4, 5) else 0) + {
            fused.INT_THIN_LENS: 1, fused.INT_DIFFRACT: 3,
            fused.INT_PHASE: 9}.get(inter, 0) + (
            1 if fused._coated(static, k) else 0)
        ops += slots
    return ops + 1   # n_table[0]


def flagship_inputs(params, device, rays_per_field=FLAGSHIP_RAYS_PER_FIELD):
    """(Hx, Hy, Px, Py, w) flat batches over fields x wavelengths x pupil,
    made as `__graft_entry__._make_inputs` makes them (seed 0), float32."""
    rng = np.random.default_rng(0)
    xf = params.x_fields.double().cpu().numpy()
    yf = params.y_fields.double().cpu().numpy()
    wl = params.wavelengths.double().cpu().numpy()
    F, W, n = len(xf), len(wl), rays_per_field
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    Px, Py = r * np.cos(th), r * np.sin(th)
    m = max(float(np.max(np.hypot(xf, yf))), 1e-12)
    Hx = np.repeat(np.tile(xf / m, W), n)
    Hy = np.repeat(np.tile(yf / m, W), n)
    w = np.repeat(np.repeat(wl, F), n)
    Px = np.tile(Px, F * W)
    Py = np.tile(Py, F * W)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (Hx, Hy, Px, Py, w))


def flagship_merit(hist):
    """`__graft_entry__.entry`'s merit: the intensity-weighted RMS spot
    about the centroid, on the image row of the history."""
    x, y, i = hist.x[-1], hist.y[-1], hist.intensity[-1]
    wsum = torch.sum(i) + 1e-12
    cx = torch.sum(x * i) / wsum
    cy = torch.sum(y * i) / wsum
    return torch.sum(((x - cx) ** 2 + (y - cy) ** 2) * i) / wsum


# FP32 operations of `material_index` per formula code, counted as
# `chain_ops_per_ray` counts (pow, sqrt and a divide one each), for nc
# coefficients; the tabulated formula's binary search is compares and loads
FORMULA_OPS = {
    0: lambda nc: 0,
    1: lambda nc: 1 + 1 + 5 * ((nc - 1) // 2) + 1,
    2: lambda nc: 1 + 1 + 4 * ((nc - 1) // 2) + 1,
    3: lambda nc: 3 * ((nc - 1) // 2) + 1,
    4: lambda nc: 1 + 12 + 3 * max(0, (nc - 9) // 2) + 1,
    5: lambda nc: 3 * ((nc - 1) // 2),
    6: lambda nc: 2 + 1 + 3 * ((nc - 1) // 2),
    7: lambda nc: 1 + 3 + 4 + 3 * max(0, nc - 3),
    8: lambda nc: 12,
    9: lambda nc: 12,
    10: lambda nc: 6,
    11: lambda nc: 2 * (nc - 1),
}


def media_ops_per_ray(static):
    """FP32 operations per ray of the media at the ray's own wavelength:
    the per-ray index of every medium a refraction, a thin lens, a grating
    or a phase sheet reads, a grating's order times w, a phase sheet's
    1 / k0 per um times w, and per
    absorbing medium the linear interpolation of its extinction table on
    the one segment that holds the ray's wavelength (5 operations; the
    search is compares and loads), alpha = 4 pi k / w (2) and the exp
    factor (4). The per-ray kernels' bounds add it to the chain's count
    (their adjoints' own operations are left out)."""
    media = [0] + [k for k in range(1, static.num_surfaces)
                   if static.interactions[k] in (0, 2, 4, 5)]
    ops = sum(FORMULA_OPS[static.mat_formulas[k]](static.mat_n_coeffs[k])
              for k in media)
    # a grating's order and a phase sheet's 1 / k0 per um times the ray's w
    ops += sum(1 for i in static.interactions if i in (4, 5))
    return ops + sum(5 + 2 + 4 for k in range(static.num_surfaces - 1)
                     if static.has_absorption[k])


def history_ops_per_ray(static, fused):
    """FP32 operations per ray of K7's function: the chain on loaded rays
    (`chain_ops_per_ray` without the raygen) and the media at the ray's
    wavelength (`media_ops_per_ray`)."""
    return (chain_ops_per_ray(static, fused) - raygen_ops(static)
            + media_ops_per_ray(static))


def tabulated_doublet(Optic):
    """A cemented doublet of two absorbing glasses: a tabulated n(w) glass
    (formula 10) and an Abbe-model glass (formula 11), with extinction
    tables of 5 and 3 points (the shorter one padded); the test systems'
    (tests/torch_port_helpers.py)."""
    from optiland_tpu_torch.materials import catalog as cat

    wl = (0.4, 0.5, 0.6, 0.7)
    tab = cat.MaterialSpec(
        10, wl + (1.53, 1.52, 1.515, 1.51), name="tabulated",
        k_table=(wl + (0.8,), (3e-7, 2e-7, 1e-7, 1e-7, 2e-7)))
    abbe = cat.abbe_material(1.62, 36.4)
    abbe = cat.MaterialSpec(abbe.formula, abbe.coefficients, name=abbe.name,
                            k_table=((0.45, 0.55, 0.65), (4e-7, 2e-7, 3e-7)))
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=40.0, thickness=6.0, material=tab,
                     is_stop=True)
    lens.add_surface(index=2, radius=-30.0, thickness=2.5, material=abbe)
    lens.add_surface(index=3, radius=-150.0, thickness=60.0)
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def coated_cooke(CookeTriplet):
    """System A: the flagship Cooke triplet with the simple coating (T, R)
    = (0.98, 0.01) on each of its six refracting surfaces."""
    lens = CookeTriplet()
    for spec in lens.surfaces.specs[1:-1]:
        spec.coating = ("simple", 0.98, 0.01)
    lens._dirty()
    return lens


def spectrograph(Optic, vignetted=False):
    """System B, a thin-lens transmission-grating spectrograph: a slit 100
    mm before a thin-lens collimator (f = 100 mm, at the stop, EPD 20), a
    plane grating of 600 lines/mm (period 1.6667 um) in first order 20 mm
    after it, a thin-lens camera (f = 100 mm) 20 mm after that and the
    image plane 98 mm after the camera, 2 mm inside its focus (at the focus
    of ideal lenses every pupil ray meets one point: the spot merit and the
    pupil's cotangents would be 0); object heights 0, 0.5 and 1 mm, 0.48,
    0.55 and 0.65 um; `vignetted` gives the 1 mm field vx = vy = 0.1 (the
    prescription of tests/torch_port_helpers.py `spectrograph`)."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=100.0)
    lens.add_surface(index=1, surface_type="paraxial", f=100.0,
                     thickness=20.0, is_stop=True)
    lens.add_surface(index=2, radius=math.inf, thickness=20.0,
                     surface_type="grating", grating_order=1,
                     grating_period=1e3 / 600.0,
                     groove_orientation_angle=0.0)
    lens.add_surface(index=3, surface_type="paraxial", f=100.0,
                     thickness=98.0)
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 20.0)
    lens.set_field_type("object_height")
    lens.add_field(y=0.0)
    lens.add_field(y=0.5)
    if vignetted:
        lens.add_field(y=1.0, vx=0.1, vy=0.1)
    else:
        lens.add_field(y=1.0)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


def concave_grating(Optic):
    """System C, the concave reflective grating of the JAX package's
    tests/test_fused_kernel.py (`test_fused_curved_grating_parity`): R =
    -100 mm, a mirror, order -1, period 5 um, EPD 6, the image plane 30 mm
    from it; here with angle fields 0, 1 and 2 degrees and 0.48, 0.55 and
    0.65 um."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=-100.0, thickness=30.0, is_stop=True,
                     surface_type="grating", material="mirror",
                     grating_order=-1, grating_period=5.0,
                     groove_orientation_angle=0.0)
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    for y in (0.0, 1.0, 2.0):
        lens.add_field(y=y)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


# the wavenumber at 0.55 um, 1/mm
K0_055 = 2.0 * math.pi / 0.55e-3


def hybrid_achromat(Optic):
    """System D, a hybrid refractive-diffractive achromat: an N-BK7
    plano-convex singlet (R 54.46 mm, 4 mm thick, at the stop, EPD 20)
    whose flat back face carries the radial phase p0 r^2 + p1 r^4 with
    5.1% of the power at 0.5876 um (f_DOE = 1957.9 mm, p0 = -k0 / 2 f_DOE,
    k0 at 0.5876 um): the split phi_DOE / phi = V_DOE / (V_DOE - V_glass)
    that cancels primary axial colour at F, d and C, with the glass's Abbe
    number 64.14 and the DOE's 0.5876 / (0.4861 - 0.6563) = -3.45; p1 =
    3e-3 corrects most of the spherical aberration. A constant-phase sheet
    (2.5 rad) stands in air 10 mm behind the lens and the image plane
    87.62 mm behind that: the back focal distance of the total power (f =
    100 mm) at 0.5876 um, 97.62 mm, from a paraxial trace by hand through
    both powers (the glass's (n - 1) / R at its vertex, then the DOE's
    -2 p0 / k0 at the back face), since the paraxial engine sees the
    carriers alone (their power: the first face's). The F and C foci fall
    within 0.06 mm of each other there. Fields 0, 3 and 5 degrees; F, d and
    C. The card tests build systems D-F from here."""
    k0_d = 2.0 * math.pi / 0.5876e-3
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=54.46, thickness=4.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=math.inf, thickness=10.0,
                     surface_type="phase",
                     phase_profile=("radial", [-k0_d / (2 * 1957.9), 3e-3]))
    lens.add_surface(index=3, radius=math.inf, thickness=87.62,
                     surface_type="phase", phase_profile=("constant", 2.5))
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 20.0)
    lens.set_field_type("angle")
    for y in (0.0, 3.0, 5.0):
        lens.add_field(y=y)
    for w in (0.4861, 0.5876, 0.6563):
        lens.add_wavelength(w, is_primary=w == 0.5876)
    return lens


def curved_metalens(Optic):
    """System E, the metalens on a curved carrier of the JAX package's
    tests/test_phase.py (`test_phase_on_curved_carrier_stays_forward`): the
    radial phase -k0 r^2 / 2f (k0 at 0.55 um, f = 100 mm) on a conic carrier
    of radius 200 mm at the stop, EPD 10, coated (0.95, 0.04), the image
    plane 100 mm after it; fields 0, 1 and 2 degrees; 0.48, 0.55 and 0.65
    um."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=200.0, thickness=100.0, is_stop=True,
                     surface_type="phase", coating=("simple", 0.95, 0.04),
                     phase_profile=("radial", [-K0_055 / (2 * 100.0)]))
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    for y in (0.0, 1.0, 2.0):
        lens.add_field(y=y)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


def phase_mirror(Optic, vignetted=False):
    """System F, a reflective linear-grating phase sheet: a flat mirror
    tilted 5 degrees about x at the stop (EPD 10) carrying Kx x + Ky y with
    Kx = 0.1 k0 and Ky = 0.7 k0 (k0 at 0.55 um), the image plane 10 mm
    before it; fields 0, 3 and 6 degrees; 0.48, 0.55 and 0.65 um. In units
    of k0 the tangential wavevector grows with w (K / k0 = K w 1e-3 / 2 pi),
    so at 0.65 um the 6 degree field passes the cutoff (R^2 = -0.05:
    evanescent, i = 0) and the 3 degree field is the surviving ray nearest
    it (R^2 = 0.052). `vignetted`, its twin for K5 and K6: the 6 degree
    field with vx = vy = 0.1 (out of in-kernel raygen) and a clear aperture
    of radius 25 mm 5 mm before the mirror."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, material="mirror",
                     thickness=-5.0 if vignetted else -10.0, is_stop=True,
                     rx=math.radians(5.0), surface_type="phase",
                     phase_profile=("linear_grating", 0.1 * K0_055,
                                    0.7 * K0_055))
    if vignetted:
        lens.add_surface(index=2, radius=math.inf, thickness=-5.0,
                         aperture=25.0)
    lens.add_surface(index=len(lens.surfaces))
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    v = 0.1 if vignetted else 0.0
    lens.add_field(y=6.0, vx=v, vy=v)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


def grid_sheet(Optic):
    """A plane grid-phase sheet at the stop (EPD 6): a 15 x 15 table over 8
    x 8 mm of a lens-like phase with a tilt and a saddle, sampled by the
    bicubic spline; the image plane 40 mm after it; fields 0 and 3
    degrees; 0.55 um (tests/test_torch_phase.py's cubic grid sheet). JAX's
    kernels do not take it (`supports_fused`): it traces eagerly."""
    xs = np.linspace(-4.0, 4.0, 15)
    grid = np.array([[-K0_055 * (x * x + y * y) / 400.0 + 0.05 * K0_055 * y
                      + 0.02 * K0_055 * x * y for x in xs] for y in xs])
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, thickness=40.0, is_stop=True,
                     surface_type="phase",
                     phase_profile=("grid", xs, xs, grid))
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


# The freeform systems of phase j5: the singlets of the JAX package's
# tests/test_fused_kernel.py (`FREEFORM_CASES`: R +-60 mm, 5 mm thick, EPD
# 8, the image plane 45 mm behind), in N-BK7, grown to two freeform faces
# each; fields 0, 3 and 5 degrees; 0.48, 0.55 and 0.65 um. The card tests
# and tests/test_torch_chain_host.py build them from here.
FREEFORM_SYSTEMS = ("G", "H", "I")
# H's front: poly-XY of order 3, its 16 coefficients C_ij (x^i y^j,
# row-major), 1e-8 to 2e-5 mm over its +-4 mm aperture
POLY_XY_H = (0.0, 1e-5, 2e-5, -1e-6,
             -2e-6, 3e-6, -1e-6, 2e-7,
             1.5e-5, -1e-6, 3e-7, -5e-8,
             1e-6, -2e-7, 4e-8, -1e-8)
# H's back: 16 Fringe Zernike terms over a norm radius of 5 mm
ZERNIKE_H = (1e-4, -2e-5, 3e-5, 5e-5, -2e-5, 1e-5, 2e-5, -1e-5, 3e-5, 1e-5,
             -1e-5, 2e-5, -1e-5, 1e-5, -5e-6, 1e-5)
# I's front: a 3 x 5 Chebyshev grid over 5 mm norms
CHEBYSHEV_I = ((0.0, 1e-5, -2e-5, 5e-6, -3e-6),
               (2e-5, 0.0, 1e-5, -5e-6, 2e-6),
               (1e-5, -1e-5, 5e-6, 2e-6, -1e-6))


def _freeform_pair(Optic, front, back, vignetted=False, **surface):
    """An N-BK7 singlet at the stop, EPD 8, with the faces `front` and
    `back` ((radius, surface_type, keywords) each); `surface` goes to the
    front (a tilt, a decenter); `vignetted`, the twin for K5 and K6: the 5
    degree field with vx = vy = 0.1."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    radius, stype, kw = front
    lens.add_surface(index=1, radius=radius, thickness=5.0, material="N-BK7",
                     is_stop=True, surface_type=stype, **kw, **surface)
    radius, stype, kw = back
    lens.add_surface(index=2, radius=radius, thickness=45.0,
                     surface_type=stype, **kw)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 8.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    v = 0.1 if vignetted else 0.0
    lens.add_field(y=5.0, vx=v, vy=v)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


def anamorphic_singlet(Optic):
    """System G: a biconic front (R 60, k -0.2; R_y 75, k_y 0.4) and a
    toroidal back (rotation radius -60, R_y -55, k -0.1, y^2 and y^4 terms
    1e-5 and -2e-8)."""
    return _freeform_pair(
        Optic, (60.0, "biconic", dict(conic=-0.2, radius_y=75.0,
                                      conic_y=0.4)),
        (-60.0, "toroidal", dict(radius_y=-55.0, conic=-0.1,
                                 coeffs_poly_y=(1e-5, -2e-8))))


def xy_freeform_singlet(Optic):
    """System H: a poly-XY front of order 3 (R 60, `POLY_XY_H`: 16
    coefficient slots) and a Fringe Zernike back (R -60, norm radius 5,
    `ZERNIKE_H`: 17 slots, a whole coefficient row)."""
    return _freeform_pair(
        Optic, (60.0, "polynomial", dict(coefficients=POLY_XY_H)),
        (-60.0, "zernike", dict(coefficients=ZERNIKE_H, norm_radius=5.0,
                                zernike_type="fringe")))


def tilted_freeform_singlet(Optic, vignetted=False):
    """System I: a Chebyshev front (R 60, `CHEBYSHEV_I` over 5 mm norms: 17
    slots) tilted 3 degrees about x and decentred 0.3 mm in y, and a Forbes
    Q-bfs back (R -60, 4 terms, norm radius 5); `vignetted`, its twin for
    K5 and K6."""
    return _freeform_pair(
        Optic, (60.0, "chebyshev", dict(coefficients=CHEBYSHEV_I,
                                        norm_x=5.0, norm_y=5.0)),
        (-60.0, "forbes_qbfs", dict(coefficients=(1e-4, -2e-5, 1e-5, -5e-6),
                                    norm_radius=5.0)),
        vignetted=vignetted, rx=math.radians(3.0), dy=0.3)


# The systems of phase j6 (the card's tests and tests/test_torch_chain_host.py
# build them from here too): J, a Forbes Q-2D face within a 17-slot row; K,
# two faces past 17 slots; L, a system of 70 surfaces.
LONG_SYSTEMS = ("J", "K", "L")
# J's front: Forbes Q-2D terms {("a" or "b", m, n): c} over a 5 mm norm
# radius: a_n^0 for n <= 3 and the (a, b) pairs of m = 1 .. 3 for n <= 1,
# 16 terms (17 slots), 5e-6 to 1e-4 mm
Q2D_J = {("a", 0, 0): 1e-4, ("a", 0, 1): -2e-5, ("a", 0, 2): 1e-5,
         ("a", 0, 3): -5e-6,
         ("a", 1, 0): 2e-5, ("b", 1, 0): -1e-5, ("a", 1, 1): 1e-5,
         ("b", 1, 1): 5e-6,
         ("a", 2, 0): 3e-5, ("b", 2, 0): -2e-5, ("a", 2, 1): 1e-5,
         ("b", 2, 1): -1e-5,
         ("a", 3, 0): 1e-5, ("b", 3, 0): 2e-5, ("a", 3, 1): -5e-6,
         ("b", 3, 1): 5e-6}
# K's front: 37 Fringe Zernike terms (38 slots) over 5 mm, 2e-5 falling to
# 2e-6 mm, alternating in sign; K's back: Forbes Q-2D a_n^0 for n <= 3 and
# the (a, b) pairs of m = 1 .. 4 for n <= 2, 28 terms (29 slots)
ZERNIKE_K = tuple((-1) ** t * 2e-5 / (1 + t // 4) for t in range(37))
Q2D_K = {**{("a", 0, n): c for n, c in enumerate((8e-5, -2e-5, 1e-5,
                                                  -5e-6))},
         **{(kind, m, n): (1 if kind == "a" else -1) * 2e-5 / (m + n)
            for m in range(1, 5) for n in range(3) for kind in ("a", "b")}}
# L: RELAYS unit-magnification relays (`relay_train`), the relay train of
# a rigid borescope at a millimetre's scale: each two identical N-BK7
# biconvex singlets (R +-5 mm, 1.5 mm thick, f 5.08 mm at 0.55 um, their
# principal planes 0.52 mm inside) 2 f apart, an afocal telescope of
# magnification -1, the next relay 2 f on; one face of each relay an even
# asphere (its first term -2.4e-4 r^2) so that Newton runs. Its 70 surfaces span
# 361 mm: the float32 trace's own noise against float64 (x, y 3e-5 mm,
# directions 4e-6, i 1e-6, OPD 8e-4 mm, the plain version on the CPU)
# stays inside TOL, which a 2 m train of R 31 mm lenses (OPD 3e-3 mm) does
# not
RELAYS = 17
RELAY_R, RELAY_T, RELAY_GAP, RELAY_C2, RELAY_EPD = 5.0, 1.5, 9.12, -2.4e-4, 0.5


def q2d_singlet(Optic, vignetted=False):
    """System J: a Forbes Q-2D front (R 60, `Q2D_J` over a 5 mm norm radius:
    17 slots, a and b terms at the same (n, m)) tilted 2 degrees about x and
    decentred 0.2 mm in y, and a spherical back (R -60); `vignetted`, its
    twin for K5 and K6."""
    return _freeform_pair(
        Optic, (60.0, "forbes_q2d", dict(norm_radius=5.0,
                                         freeform_coeffs=Q2D_J)),
        (-60.0, "standard", {}), vignetted=vignetted, rx=math.radians(2.0),
        dy=0.2)


def wide_freeform_singlet(Optic):
    """System K: a 37-term Fringe Zernike front (R 60, `ZERNIKE_K` over 5
    mm: 38 slots) and a Forbes Q-2D back (R -60, `Q2D_K` over 5 mm: 29
    slots), both past a 17-slot row."""
    return _freeform_pair(
        Optic, (60.0, "zernike", dict(coefficients=ZERNIKE_K,
                                      norm_radius=5.0,
                                      zernike_type="fringe")),
        (-60.0, "forbes_q2d", dict(norm_radius=5.0, freeform_coeffs=Q2D_K)))


def relay_train(Optic, relays=RELAYS):
    """System L: `relays` relays (`RELAY_R`, `RELAY_T`, `RELAY_GAP`: 4
    surfaces each) behind an object at infinity, 2 + 4 relays surfaces (70
    for 17), the stop on the first face, EPD `RELAY_EPD` (F/10), fields 0,
    1 and 2 degrees, 0.48, 0.55 and 0.65 um: each relay's front face an
    even asphere."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    k = 1
    for r in range(relays):
        for j in range(2):
            asphere = dict(surface_type="even_asphere",
                           coefficients=(RELAY_C2,)) if j == 0 else {}
            lens.add_surface(index=k, radius=RELAY_R, thickness=RELAY_T,
                             material="N-BK7", is_stop=k == 1, **asphere)
            lens.add_surface(index=k + 1, radius=-RELAY_R,
                             thickness=RELAY_GAP)
            k += 2
    lens.add_surface(index=k)
    lens.set_aperture("EPD", RELAY_EPD)
    lens.set_field_type("angle")
    for y in (0.0, 1.0, 2.0):
        lens.add_field(y=y)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


# The systems of phase j7 (the card's tests and tests/test_torch_system_core.py
# build them from here too) beside the zoo's: a fold mirror placed by
# absolute coordinates, an apodized singlet, and the Cooke triplet with
# image-height fields.
FOLD_MIRROR_TILT = math.pi / 4.0
FOLD_IMAGE_Y = 16.0


def fold_mirror(Optic):
    """An N-BK7 biconvex singlet (R +-50 mm, 5 mm thick, the stop on its
    front, EPD 10, fields 0, 2 and 3 degrees, 0.55 um) whose beam a flat
    mirror 30 mm behind it, placed by absolute coordinates and tilted 45
    degrees about x, folds into +y; the image plane, placed absolutely too,
    faces the folded beam `FOLD_IMAGE_Y` mm up, near its focus. The JAX
    package sets `abs_cs` only in its Zemax reader, so the system is built
    here by hand."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=5.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-50.0, thickness=30.0)
    mirror = lens.add_surface(index=3, radius=math.inf, thickness=0.0,
                              material="mirror")
    mirror.abs_cs = (0.0, 0.0, 35.0, FOLD_MIRROR_TILT, 0.0, 0.0)
    image = lens.add_surface(index=4)
    image.abs_cs = (0.0, FOLD_IMAGE_Y, 35.0, -math.pi / 2.0, 0.0, 0.0)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    for y in (0.0, 2.0, 3.0):
        lens.add_field(y=y)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def apodized_singlet(Optic):
    """An N-BK7 biconvex singlet (R +-50 mm, 5 mm thick, the stop on its
    front, EPD 10, the image plane 47 mm behind, fields 0, 3 and 5
    degrees, 0.55 um) under a Gaussian apodization of sigma 0.6."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=5.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-50.0, thickness=47.0)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    for y in (0.0, 3.0, 5.0):
        lens.add_field(y=y)
    lens.add_wavelength(0.55, is_primary=True)
    lens.set_apodization(("gaussian", {"sigma": 0.6}))
    return lens


def image_height_cooke(CookeTriplet, field_type):
    """The Cooke triplet with its fields (0, 14 and 20) read as image
    heights in mm, as the JAX package's own test builds it
    (tests/test_field_types_materials.py)."""
    lens = CookeTriplet()
    lens.set_field_type(field_type)
    return lens


# WideAngle100FOV's aimed batch: its three fields, 666,666 rays each
AIM_RAYS = 1_999_998
# the eager traces of phase j7, over each system's fields
EAGER_RAYS = 65_536
# An aim's own target on the card, float32: each live ray's stop hit over
# the stop radius within TOL_AIM of its (Px, Py). The robust aim accepts a
# continuation step only within its tol, 1e-4, of the target, and keeps its
# final polish only where that does no worse, so each ray it brings to
# t = 1 ends within 1e-4; the iterative aim's Newton stops at the float32
# trace's own noise (a few ulps a surface on the stop hit, 1.2e-5 of the
# stop radius on WideAngle100FOV's 1,999,998 rays in a probe on the H100).
# TOL_AIM is twice the robust aim's acceptance. JAX's own test holds the
# aim at 1e-6 in float64 on the Cooke triplet (tests/test_aiming_glass.py).
TOL_AIM = 2e-4
# The eager traces of phase j7, float32 against float64 on the card: each
# final array's largest error on the rays both precisions keep lit, over
# its scale (the largest |value|, at least 1): float32's 6e-8 a rounding,
# a few a surface, over the paths of a 2.4 m telescope (OPD ~1e4 mm), a
# fold and a singlet.
TOL_EAGER = 1e-4
# The Hubble telescope's primary (R -11040 mm, k -1.0012) meets rays that
# have come 4.9 m: there 4 |A C| << B^2 in the conic's quadratic, and the
# eager intersection takes the root that does not cancel
# (`geometry/surfaces.py` `_conic_intersect`; the textbook form lost 2.4 mm
# at the image in float32). Its image rows are printed beside, over their
# own scale (the image's x spans 0.04 mm, so float32's ~5e-4 mm in global
# coordinates of ~6 m shows there).
# The zoo in float64, card against CPU, over each array's scale: two
# float64 evaluations of the same arithmetic (fused multiply-adds on the
# card) differ by rounding alone.
TOL_ZOO = 1e-9


def field_pupil_inputs(lens, n, device, seed=14):
    """(Hx, Hy, Px, Py) float32 on `device`: `n` rays spread over the lens's
    normalized fields (the first fields one more where n does not divide),
    each field's pupil points uniform in the unit disk (seed `seed`)."""
    rng = np.random.default_rng(seed)
    coords = lens.fields.get_field_coords()
    counts = [len(c) for c in np.array_split(np.arange(n), len(coords))]
    Hx = np.repeat([c[0] for c in coords], counts)
    Hy = np.repeat([c[1] for c in coords], counts)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (Hx, Hy, r * np.cos(th), r * np.sin(th)))


def scaled_err(got, ref):
    """The largest |got - ref| over ref's scale (its largest finite |value|,
    at least 1); inf unless both are NaN at the same entries (a ray that
    misses a surface)."""
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return math.inf
    ok = ~nan
    if not ok.any():
        return 0.0
    scale = max(ref[ok].abs().max().item(), 1.0)
    return ((got - ref)[ok].abs().max() / scale).item()


# The design loop of phase j8 (the card tests share these): the bench
# lens's merit, RMS spots at 0 and 14 degrees over DESIGN_RINGS hexapolar
# rings (1 + 3 * 816 * 817 = 2,000,017 rays a field), f2, total track over
# its maximum, the summed Seidel spherical and the chief ray's image
# height, over the radii of its curved faces and its back gap. The flat
# faces 4, 6 and 8 stay fixed: a flat surface's curvature cotangent is the
# reference's rule, which the eager path and the kernels' differ on by
# design (ROADMAP queue 3; tests/test_torch_design.py pins it).
DESIGN_RINGS = 816
DESIGN_RADII = (1, 2, 3, 5, 7, 9, 10, 11)
# the Cooke triplet's tolerancing (tests/test_tolerancing.py's fixture, its
# image gap the compensator): RMS spot over 64 rings, 12,481 rays
TOLERANCING_RINGS = 64
TOLERANCING_DRAWS = 16
# GlassExpert's catalog on the Cooke triplet's middle glass: three of
# Sellmeier's 7-coefficient form (F2's own K7 variant) and two of the
# 11-coefficient one, which need a K7 variant of their own
GLASSES_J8 = ("F2", "SF2", "SF5", "N-SF5", "LAK9", "F4")
# environment/ on the card: float64 against the CPU, relative
ENV_WAVELENGTHS = 64
TOL_ENV = 1e-13


def design_problem(OptimizationProblem, lens, rings=DESIGN_RINGS):
    """Phase j8's merit on the bench lens `lens` (see DESIGN_RINGS)."""
    p = OptimizationProblem(lens)
    for hy in (0.0, 1.0):
        p.add_operand("rms_spot_size", target=0.0, weight=10.0,
                      input_data=dict(surface_number=-1, Hx=0.0, Hy=hy,
                                      num_rays=rings, wavelength=WAVELENGTH))
    p.add_operand("f2", target=100.0)
    p.add_operand("total_track", max_val=139.0)
    p.add_operand("SC_sum", target=0.0)
    p.add_operand("real_y_intercept", target=24.6, input_data=dict(
        surface_number=-1, Hx=0.0, Hy=1.0, Px=0.0, Py=0.0,
        wavelength=WAVELENGTH))
    for s in DESIGN_RADII:
        p.add_variable(lens, "radius", surface_number=s)
    p.add_variable(lens, "thickness", surface_number=11)
    return p


def detune(lens, factor=1.05):
    """`lens` with every curvature times `factor`, as tests/test_optimization
    .py detunes the Cooke triplet before Adam."""
    params = lens.params
    lens.update_params(params.replace(cv=params.cv * factor))
    return lens


def cooke_tolerancing(tol_mod, lens, rings=TOLERANCING_RINGS, steps=4):
    """tests/test_tolerancing.py's fixture on `lens` (the Cooke triplet):
    R1 and the gap after surface 4 perturbed, f2 and the on-axis RMS spot
    at 0.55 um; the image gap the compensator, `steps` Gauss-Newton
    steps."""
    t = tol_mod.Tolerancing(lens, compensator_steps=steps)
    t.add_perturbation("radius", tol_mod.NormalSampler(22.01359, 0.05),
                       surface_number=1)
    t.add_perturbation("thickness", tol_mod.NormalSampler(4.75041, 0.02),
                       surface_number=4)
    t.add_compensator("thickness", surface_number=6)
    t.add_operand("f2")
    t.add_operand("rms_spot_size", input_data={
        "surface_number": -1, "Hx": 0, "Hy": 0.0, "num_rays": rings,
        "wavelength": 0.55})
    return t


def cooke_with_glass(CookeTriplet, glass):
    """The Cooke triplet with `glass` after surface 3 (GlassExpert's
    candidates)."""
    lens = CookeTriplet()
    lens.set_material(glass, 3)
    return lens


def huygens_ops_per_contribution():
    """FP32 operations per (image point, pupil sample) of the Huygens sum
    as the reference writes it (`_huygens_kernel`, `huygens_sum_plain`),
    counted as `chain_ops_per_ray` counts (an add, subtract, multiply,
    divide, sqrt, sin and cos one each, an FMA two): the difference vector
    3, R^2 5, sqrt 1, the dot product 5, R Rp 1, the divide 1, the
    obliquity 2 (1 + cos, * 0.5), amp * it 1, / R 1, the phase 3 (R - Rp,
    - opd, * k), sin and cos 2, the two products and sums 4. The bound is
    the function's: K8 computes it with its own instruction mix (~24
    FP32-pipe and 4 special-function instructions, csrc/huygens.cuh)."""
    return 3 + 5 + 1 + 5 + 1 + 1 + 2 + 1 + 1 + 3 + 2 + 4


def huygens_bound(n_img, n_pup):
    """(bytes, operations) of the Huygens sum at I image points and P pupil
    samples: 3 I + 5 P floats in, I out; 29 operations a contribution, plus
    the square of each point's field (3)."""
    return ((3 * n_img + 5 * n_pup + n_img) * 4,
            huygens_ops_per_contribution() * n_img * n_pup + 3 * n_img)


def phase_reduction(args, rows=2048):
    """What K8's phase reduction meets on a Huygens sum's arguments, in
    float64 over chunks of image points: the reference's largest |phase|
    k ((R - Rp) - opd) in rad and the float32 quantum at that phase (half
    its ulp: the reference's rounding of the phase alone); the most cycles
    K8 reduces, |R - Rp| / lambda + 1/2 (the OPD's whole cycles leave when a
    sample is staged), and the float32 quantum there in rad."""
    image, pupil, _, opd, wl_mm, Rp = args
    ix, iy, iz = (a.reshape(-1).double() for a in image)
    ux, uy, uz = (u.double()[None, :] for u in pupil)
    k = 2.0 * math.pi / wl_mm
    top, dr = 0.0, 0.0
    for s in range(0, ix.shape[0], rows):
        R = torch.sqrt((ix[s:s + rows, None] - ux) ** 2 + (
            iy[s:s + rows, None] - uy) ** 2 + (iz[s:s + rows, None] - uz) ** 2)
        d = R - float(Rp)
        top = max(top, (k * (d - opd.double()[None, :])).abs().max().item())
        dr = max(dr, d.abs().max().item())
    cycles = dr / wl_mm + 0.5

    def quantum(v, scale):
        a = torch.tensor(v, dtype=torch.float32)
        ulp = (torch.nextafter(a, torch.tensor(math.inf)) - a).item()
        return 0.5 * ulp * scale

    return dict(max_abs_phase_rad=top,
                reference_quantum_rad=quantum(top, 1.0),
                max_abs_cycles=cycles,
                k8_quantum_rad=quantum(cycles, 2.0 * math.pi))


def bench_wave_optics_args(dev):
    """The random inputs of tools/bench_wave_optics.py (seed 0): 16384 image
    points at z = 60 within 0.05 mm of the axis, 8192 pupil samples in a
    10 mm square at z = 0, amplitudes in [0.5, 1], OPD in [0, 20] mm,
    lambda 0.55 um, Rp 60 mm."""
    rng = np.random.default_rng(0)

    def on_card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    pupil = tuple(on_card(rng.uniform(-5, 5, 8192)) for _ in range(2))
    pupil += (on_card(np.zeros(8192)),)
    image = tuple(on_card(rng.uniform(-0.05, 0.05, 16384)) for _ in range(2))
    image += (on_card(np.full(16384, 60.0)),)
    amp = on_card(rng.uniform(0.5, 1.0, 8192))
    opd = on_card(rng.uniform(0, 20, 8192))
    return (image, pupil, amp, opd, 0.55e-3, torch.tensor(60.0, device=dev))


def bound_ms(n_bytes, n_ops, ops_per_s=PEAK_FP32_FLOPS):
    """The least time of a function that moves `n_bytes` and does `n_ops`
    operations at `ops_per_s` (FP32 by default), and which of the two
    bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def sfu_per_s(n_sm):
    """The card's special-function results a second at its maximum SM
    clock, and that clock in MHz."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    return n_sm * SFU_PER_CLOCK_SM * mhz * 1e6, mhz


def time_ms(fn, calls=TIMED_CALLS, warmup=3):
    """Median over `calls` of CUDA-event time around one call, after
    `warmup` warm-up calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(got, ref, keep=None):
    """max |got - ref| over max |ref| (on the `keep` entries)."""
    if keep is not None:
        got, ref = got[keep], ref[keep]
    scale = ref.abs().max().double().clamp_min(1e-30)
    return ((got.double() - ref.double()).abs().max() / scale).item()


def ulp_err(got, ref):
    """max |got - ref| in units in the last place of float32 ref."""
    a = ref.float().abs()
    ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()
    return ((got.double() - ref.double()).abs() / ulp).max().item()


def max_abs(got, ref, keep=None):
    if keep is not None:
        got, ref = got[keep], ref[keep]
    return (got.double() - ref.double()).abs().max().item()


# the 12 `_diff_params` groups, in order
PARAM_GROUPS = ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
                "mat_coeffs", "coating_params", "n_table", "grating",
                "phase_params", "focal_length")


def cotangent_errs(got, ref, keep):
    """Relative errors of a backward kernel against its plain version:
    rg, the `_diff_params` groups either side fills, and the per-ray
    cotangents (on `keep`). Returns (errors, max abs error of the
    parameter cotangents)."""
    d_rg, d_diff, d_ray = got
    r_rg, r_diff, r_ray = ref
    errs, worst = {}, 0.0
    if d_rg is not None:
        errs["rg"] = rel_err(d_rg, r_rg)
        worst = max_abs(d_rg, r_rg)
    for name, g, r in zip(PARAM_GROUPS, d_diff, r_diff):
        if r.abs().max() > 0 or g.abs().max() > 0:
            errs[name] = rel_err(g, r)
            worst = max(worst, max_abs(g, r))
    rays = {}
    if keep is not None:
        for j, (g, r) in enumerate(zip(d_ray, r_ray)):
            if r.abs().max() > 0 or g.abs().max() > 0:
                rays[f"ray{j}"] = rel_err(g, r, keep)
    return errs, rays, worst


def check_cotangents(label, errs, rays, float64=None):
    """Each parameter cotangent group within TOL["param_grad_rel"], each
    per-ray one within TOL["ray_grad_rel"]. With `float64` (phase j4's
    systems), a group that misses TOL passes if `near_float64` holds for
    it in `float64()` (`float64_errs`), which runs only then."""
    print(f"{label} vs plain: params {json.dumps(errs)} per-ray "
          f"{json.dumps(rays)} tolerances param_grad_rel "
          f"{TOL['param_grad_rel']} ray_grad_rel {TOL['ray_grad_rel']}")
    miss = [k for k, v in errs.items() if v > TOL["param_grad_rel"]]
    if miss and float64 is not None:
        far = float64()
        print(f"{label}, the groups past TOL against the plain version run "
              f"in float64: " + json.dumps({
                  k: {"kernel": far[k][0], "float32_noise": far[k][1],
                      "bound": max(TOL["param_grad_rel"],
                                   F64_FACTOR * far[k][1])} for k in miss}))
        miss = [k for k in miss
                if not near_float64(far[k], TOL["param_grad_rel"])]
    for k in errs:
        check(k not in miss, f"{label} {k} vs plain")
    for k, v in rays.items():
        check(v <= TOL["ray_grad_rel"], f"{label} {k} vs plain")


def tree_map(fn, x):
    """`fn` on each tensor of a nested tuple or list (None kept)."""
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, y) for y in x)
    return fn(x) if torch.is_tensor(x) else x


def float64_errs(got, plain, args):
    """Per parameter group (`cotangent_errs`' names): the backward kernel's
    result `got` against its plain version run in float64 on the same
    inputs, `plain(*args)` with `args` in float64, and the float32 noise,
    the larger of the plain float32 version's own errors against that run
    on the card and on the CPU. Returns {group: (kernel, noise)}."""
    ref = plain(*tree_map(torch.Tensor.double, args))
    kernel = cotangent_errs(got, ref, None)[0]
    card = cotangent_errs(plain(*args), ref, None)[0]
    dev = ref[1][0].device
    cpu = cotangent_errs(tree_map(lambda t: t.to(dev), plain(*tree_map(
        lambda t: t.cpu(), args))), ref, None)[0]
    return {k: (v, max(card.get(k, 0.0), cpu.get(k, 0.0)))
            for k, v in kernel.items()}


def final_float64_errs(got, plain, args, keep):
    """Per array (`fused._NAMES`: K5's final state or K7's (S, n) history),
    on the rays `keep`: a forward kernel's `got` against its plain version
    run in float64 on the same inputs, `plain(*args)` with `args` in
    float64, and the float32 noise, the larger of the plain float32
    version's own errors against that run on the card and on the CPU.
    Returns {name: (kernel, noise)}."""
    from optiland_tpu_torch.trace import fused

    ref = plain(*tree_map(torch.Tensor.double, args))

    def errs(outs):
        return {name: (o.to(r) - r)[..., keep.to(r.device)].abs().max().item()
                for name, o, r in zip(fused._NAMES, outs, ref)}

    card = errs(plain(*args))
    cpu = errs(plain(*tree_map(lambda t: t.cpu(), args)))
    return {k: (v, max(card[k], cpu[k])) for k, v in errs(got).items()}


def near_float64(pair, tol):
    """Whether a group's (kernel, noise) of `float64_errs` has the kernel
    within the larger of `tol` and F64_FACTOR times the noise."""
    return pair[0] <= max(tol, F64_FACTOR * pair[1])


# Phase j9: polarization ray tracing, thin-film coatings, BSDF scattering
# and the vectorial wave optics. JAX's gates send every one of them to its
# XLA path (`trace_system`: a polarized trace never takes K7;
# `supports_fused`: no Fresnel, thin-film or polarizer coating, no BSDF;
# the vectorial Huygens sum is XLA, not K8), so the port runs them eagerly
# on the card and no kernel may launch; the unpolarized, uncoated Cooke
# triplet beside them keeps its K7.
POL_STATE = (True, 0.6, 0.8, 0.0, 0.5)
MGF2 = (1.38, 100.0)   # a quarter wave at 552 nm: index, thickness in nm
# the rays of the float64 gradient's reference (its autograd graph holds
# (N, 3, 3) complex128 records at every surface)
J9_GRAD_RAYS = 65_536
J9_BSDF_RAYS = 1_999_998
J9_STEPS = 5           # ThinFilmOptimizer's L-BFGS-B iterations
J9_SPLIT_CALLS = 3     # warm VectorialHuygensPSF calls, split inside each
# The polarized traces in float32 against float64 on the card, on the rays
# both keep lit: positions and directions as TOL_F64; the final intensity
# and |p| entries (each a product of six Fresnel or thin-film amplitudes
# of ~0.98 and the rotations between the faces' bases, a few float32
# roundings of 6e-8 each a face: 3e-6 and 6e-6 at 18,000 rays in a CPU
# rehearsal, larger in the tails of 1,999,998) within 5e-5; the gradient of the mean
# final intensity relative to its largest entry within 1e-3 (a float32 sum
# of 65,536 rays' terms, each a difference of AOI-dependent amplitudes);
# the share of rays lit in one precision only within TOL["intensity_frac"].
TOL_POL = {"intensity": 5e-5, "p_abs": 5e-5, "grad_rel": 1e-3}
# The polarizer goldens in float32: an extinction is the square of a
# rounded zero (1e-14), Malus's law and the halvings within 1e-5 (a few
# roundings of the unit vectors that build each Jones matrix).
TOL_GOLDEN = {"extinction": 1e-6, "malus": 1e-5}
# BSDF scattering on injected draws, float32 against float64, at the
# scattering face (row 1) and the next (row 2, the singlet's back face),
# on the rays both keep lit: a ray whose candidate lands within rounding of
# the unit disk's edge may be accepted in one precision and rejected in the
# other, and takes another attempt's direction, so at most 1e-4 of the rays
# may miss TOL_F64's direction or position, and every other ray is held to
# them. At the back face, a Lambertian ray can leave near grazing, where
# refraction amplifies a rounding by 1 / cos of the exit angle (2.2e-5 in
# direction at 40,000 rays in a CPU rehearsal): there the rule holds the
# rays that leave within BSDF_EXIT_COS of the axis (N >= 0.5, 60 degrees).
TOL_BSDF = {"outside_frac": 1e-4}
BSDF_EXIT_COS = 0.5
# The moments of the generator's own stream are held to the law within
# this many standard errors of the sample.
SIGMAS = 5.0
# VectorialFFTPSF and VectorialHuygensPSF against the scalar PSFs' Strehl
# ratios, as tests/test_vectorial_psf.py holds them (unpolarized light
# through an uncoated lens: the PSFs differ by the vector components'
# obliquity alone).
TOL_VEC_STREHL = {"fft": 1e-2, "huygens": 2e-2}
# ThinFilmOptimizer on the card against the CPU, float64: two roundings of
# one arithmetic (fused multiply-adds on the card), through 5 L-BFGS-B
# iterations.
TOL_THIN_FILM = 1e-8


def fresnel_cooke(CookeTriplet):
    """The Cooke triplet with "fresnel" on its six glass faces."""
    lens = CookeTriplet()
    for k in range(1, 7):
        lens.surfaces[k].coating = "fresnel"
    lens._dirty()
    return lens


def mgf2_cooke(CookeTriplet, ThinFilmStack):
    """The Cooke triplet with one MgF2 layer (MGF2) on each glass face,
    between the face's own media."""
    lens = CookeTriplet()
    for k in range(1, 7):
        stack = ThinFilmStack(lens.surfaces[k - 1].material,
                              lens.surfaces[k].material)
        lens.surfaces[k].coating = stack.add_layer_nm(*MGF2)
    lens._dirty()
    return lens


def polarizer_plates(Optic, coat1, coat2, between=None):
    """tests/test_polarization_goldens.py's `_polarizer_system`: two
    coated flat faces in air (EPD 4, on axis, 0.55 um), `between` on a
    third face between them where given."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    coats = (coat1, between, coat2) if between is not None else (coat1,
                                                                  coat2)
    for k, c in enumerate(coats):
        lens.add_surface(index=k + 1, radius=math.inf, thickness=5.0,
                         is_stop=k == 0, coating=c)
    lens.add_surface(index=len(coats) + 1)
    lens.set_aperture(aperture_type="EPD", value=4)
    lens.set_field_type("angle")
    lens.add_field(y=0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def bsdf_singlet(Optic, bsdf):
    """A plano-convex N-BK7 singlet (flat front, R -60 mm back, 5 mm
    thick, EPD 10, on axis and 3 degrees, 0.55 um) with `bsdf` on its flat
    front face: an on-axis beam meets it at normal incidence, so the
    scattered directions there follow the law's disk draws exactly
    (L' = -y, M' = x)."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, thickness=5.0,
                     material="N-BK7", is_stop=True, bsdf=bsdf)
    lens.add_surface(index=2, radius=-60.0, thickness=100.0)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0)
    lens.add_field(y=3)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def ar_stack(ThinFilmStack):
    """A 4-layer AR start on n = 1.52 (tests/test_torch_thin_film.py's)."""
    stack = ThinFilmStack(incident_material="air", substrate_material=1.52)
    for n, d in ((1.38, 0.09), (2.1, 0.05), (1.38, 0.03), (2.1, 0.02)):
        stack.add_layer(n, d)
    return stack


class _OpCount(TorchDispatchMode):
    """Counts the ATen operators dispatched while it is active: each runs
    at least one kernel on the card, so an eager path's count is a floor
    on its launches."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def precision(name):
    """The port's precision global at `name`, float32 after."""
    from optiland_tpu_torch import config

    config.set_precision(name)
    try:
        yield
    finally:
        config.set_precision("float32")


def phase_j9(dev, reset_counts, read_counts, smi,
             rays_per_field=FLAGSHIP_RAYS_PER_FIELD, grad_rays=J9_GRAD_RAYS,
             bsdf_rays=J9_BSDF_RAYS, wave=True):
    """Phase j9 on `dev` (the card; a CPU rehearsal passes the CPU and small
    sizes): (a) the Fresnel-coated Cooke triplet, unpolarized, at the
    flagship batch; (b) the MgF2-coated one under POL_STATE; (c) the
    polarizer goldens; (d) Lambertian and Gaussian BSDFs; (e) the
    vectorial PSFs and MTF at their defaults; (f) ThinFilmOptimizer.
    Returns the seconds of each part."""
    from optiland_tpu_torch.core.scatter import (
        GaussianBSDF,
        LambertianBSDF,
        disk_draws,
    )
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.mtf import VectorialFFTMTF
    from optiland_tpu_torch.polarization import PolarizationState
    from optiland_tpu_torch.psf import (
        ScalarFFTPSF,
        ScalarHuygensPSF,
        VectorialFFTPSF,
        VectorialHuygensPSF,
    )
    from optiland_tpu_torch.psf import huygens
    from optiland_tpu_torch.system.optic import Optic
    from optiland_tpu_torch.thin_film import ThinFilmOptimizer, ThinFilmStack
    from optiland_tpu_torch.trace import tracer

    seconds = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def clock():
        sync()
        return time.perf_counter()

    def build(make):
        """`make()` on `dev` in float32 and in float64."""
        b32 = make().build(device=dev)
        with precision("float64"):
            b64 = make().build(device=dev)
        return b32, b64

    def no_kernel(label, got):
        print(f"phase j9: {label}: launches {got}")
        check(sum(got.values()) == 0, f"{label} launched no kernel: {got}")

    def polarized(label, make, state):
        """trace_system and Optic.trace under `state`, float32 against
        float64 on the card, no kernel launched; the gradient of the mean
        final intensity in cv and thickness at the whole batch (finite),
        and against float64 on its first `grad_rays` rays."""
        t0 = clock()
        (st, pr), (st64, pr64) = build(make)
        fb = flagship_inputs(pr, dev, rays_per_field)
        leaves = {k: getattr(pr, k).detach().clone().requires_grad_(True)
                  for k in ("cv", "thickness")}
        reset_counts()
        h = tracer.trace_system(st, pr.replace(**leaves), *fb,
                                polarization=state)
        h.intensity[-1].mean().backward()
        got = read_counts()
        no_kernel(f"{label}, trace_system and its backward at "
                  f"{fb[0].numel()} rays", got)
        ops = {}
        for what in ("forward", "forward and backward"):
            lv = {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves.items()}
            with _OpCount() as count:
                hh = tracer.trace_system(st, pr.replace(**lv),
                                         *(a[:1024] for a in fb),
                                         polarization=state)
                if what != "forward":
                    hh.intensity[-1].mean().backward()
            ops[what] = count.n
        check(all(bool(torch.isfinite(v.grad).all())
                  for v in leaves.values()), f"{label}: finite gradients")
        with torch.no_grad():
            h64 = tracer.trace_system(st64, pr64, *(a.double() for a in fb),
                                      polarization=state)
        i32, i64 = h.intensity[-1].detach(), h64.intensity[-1]
        lit = (i32 > 0) & (i64 > 0)
        err = {"lit_differs_frac": ((i32 > 0) != (i64 > 0)).double().mean()
               .item(), "intensity": (i32.double() - i64).abs().max().item(),
               "p_abs": (h.p.detach().abs().double() - h64.p.abs())[lit]
               .abs().max().item()}
        for key in ("x", "y", "z", "L", "M", "N"):
            err[key] = (getattr(h, key)[-1].detach().double()
                        - getattr(h64, key)[-1])[lit].abs().max().item()
        del h, h64
        # the gradient against float64 on the batch's first grad_rays rays
        grads = []
        for (s, p), cast in (((st, pr), torch.float32),
                             ((st64, pr64), torch.float64)):
            lv = {k: getattr(p, k).detach().clone().requires_grad_(True)
                  for k in ("cv", "thickness")}
            hh = tracer.trace_system(s, p.replace(**lv),
                                     *(a[:grad_rays].to(cast) for a in fb),
                                     polarization=state)
            hh.intensity[-1].mean().backward()
            grads.append(lv)
            del hh
        for k in ("cv", "thickness"):
            g32, g64 = grads[0][k].grad.double(), grads[1][k].grad
            err[f"grad {k}"] = ((g32 - g64).abs().max()
                                / g64.abs().max()).item()
        # the user's entry: Optic.trace on the polarized optic
        lens32, lens64 = make(), make()
        lens32.set_polarization(state)
        lens64.set_polarization(state)
        reset_counts()
        t32 = lens32.trace(Hx=0.0, Hy=1.0, num_rays=64, device=dev)
        got_o = read_counts()
        no_kernel(f"{label}, Optic.trace", got_o)
        with precision("float64"):
            t64 = lens64.trace(Hx=0.0, Hy=1.0, num_rays=64, device=dev)
        err["Optic.trace intensity"] = (t32.intensity[-1].double()
                                        - t64.intensity[-1]).abs().max().item()
        sync()
        seconds[label] = time.perf_counter() - t0
        print(f"phase j9 ({smi}): {label}, {fb[0].numel()} rays (gradient "
              f"against float64 on the first {grad_rays}), float32 vs "
              f"float64 on the card: {json.dumps(err)}; ATen operators a "
              f"trace_system call dispatches (each at least one launch) "
              f"{json.dumps(ops)}; {seconds[label]:.1f} s")
        check(err["lit_differs_frac"] <= TOL["intensity_frac"], f"{label} lit")
        check(all(err[k] <= TOL_F64["position_mm"] for k in "xyz")
              and all(err[k] <= TOL_F64["direction"] for k in "LMN"),
              f"{label} positions and directions vs float64")
        check(err["intensity"] <= TOL_POL["intensity"]
              and err["Optic.trace intensity"] <= TOL_POL["intensity"]
              and err["p_abs"] <= TOL_POL["p_abs"],
              f"{label} intensity and |p| vs float64")
        check(all(err[f"grad {k}"] <= TOL_POL["grad_rel"]
                  for k in ("cv", "thickness")), f"{label} gradients")

    t_j9 = time.perf_counter()
    # (a) Fresnel on six faces, unpolarized; (b) MgF2 stacks, POL_STATE
    polarized("(a) Fresnel-coated Cooke triplet, unpolarized",
              lambda: fresnel_cooke(CookeTriplet),
              PolarizationState.unpolarized())
    polarized("(b) MgF2-coated Cooke triplet, polarized",
              lambda: mgf2_cooke(CookeTriplet, ThinFilmStack),
              PolarizationState(*POL_STATE))
    # the uncoated, unpolarized twin keeps K7
    st_c, pr_c = CookeTriplet().build(device=dev)
    fb_c = flagship_inputs(pr_c, dev, rays_per_field)
    reset_counts()
    tracer.trace_system(st_c, pr_c, *fb_c)
    got = read_counts()
    print(f"phase j9: the uncoated, unpolarized twin's trace_system: "
          f"launches {got}")
    if dev.type == "cuda":
        check(got["K7"] == 1 and sum(got.values()) == 1,
              f"the uncoated twin launched K7 once: {got}")
    del fb_c

    # (c) the polarizer goldens at the flagship's number of rays
    t0 = clock()
    n = 9 * rays_per_field
    h_state = PolarizationState(True, 1.0, 0.0, 0.0, 0.0)
    cases = {"crossed H, V": ("polarizer_h", "polarizer_v", None, h_state,
                              0.0),
             "parallel H, H": ("polarizer_h", "polarizer_h", None, h_state,
                               1.0),
             "unpolarized through H": ("polarizer_h", None, None,
                                       PolarizationState.unpolarized(), 0.5),
             "quarter wave at 45 deg between crossed H, V": (
                 "polarizer_h", "polarizer_v",
                 ("retarder", math.pi / 2, math.pi / 4), h_state, 0.5)}
    for theta in (0.2, 0.7, 1.3):
        cases[f"Malus, H then {theta} rad"] = (
            "polarizer_h", ("linear_polarizer", theta), None, h_state,
            math.cos(theta) ** 2)
    golden = {}
    reset_counts()
    for name, (c1, c2, mid, state, want) in cases.items():
        lens = polarizer_plates(Optic, c1, c2, mid)
        st, pr = lens.build(device=dev)
        inp = field_pupil_inputs(lens, n, dev)
        i = tracer.trace_system(st, pr, *inp, 0.55,
                                polarization=state).intensity[-1]
        golden[name] = (i.double() - want).abs().max().item()
        tol = TOL_GOLDEN["extinction" if want == 0.0 else "malus"]
        check(golden[name] <= tol, f"{name}: {golden[name]} > {tol}")
    no_kernel(f"(c) the polarizer goldens at {n} rays", read_counts())
    seconds["(c)"] = clock() - t0
    print(f"phase j9 ({smi}): (c) the polarizer goldens at {n} rays, float32, "
          f"largest |i - law| {json.dumps(golden)} (tolerances "
          f"{json.dumps(TOL_GOLDEN)}); {seconds['(c)']:.1f} s")

    # (d) BSDFs on the singlet's flat face, on-axis rays, an explicit
    # generator on the device
    t0 = clock()
    for bsdf in (LambertianBSDF(), GaussianBSDF(0.1)):
        make = (lambda b=bsdf: bsdf_singlet(Optic, b))
        (st, pr), (st64, pr64) = build(make)
        rng = np.random.default_rng(21)
        r = np.sqrt(rng.uniform(size=bsdf_rays))
        th = rng.uniform(0, 2 * np.pi, bsdf_rays)
        inp = tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in
                    (np.zeros(bsdf_rays), np.zeros(bsdf_rays), r * np.cos(th),
                     r * np.sin(th)))
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        draws = disk_draws(gen, bsdf_rays, 8, torch.float64, dev)
        reset_counts()
        h = tracer.trace_system(st, pr, *inp, 0.55,
                                scatter_draws={1: draws})
        h_own = tracer.trace_system(st, pr, *inp, 0.55, scatter=gen)
        no_kernel(f"(d) {bsdf.kind} BSDF, injected draws and the "
                  f"generator's stream", read_counts())
        h64 = tracer.trace_system(st64, pr64, *(a.double() for a in inp),
                                  0.55, scatter_draws={1: draws})
        err = {}
        for row in (1, 2):
            def diff(keys):
                return torch.stack([(getattr(h, k)[row].double()
                                     - getattr(h64, k)[row]).abs()
                                    for k in keys]).amax(0)

            d, dp = diff("LMN"), diff("xyz")
            lit = (h.intensity[row] > 0) & (h64.intensity[row] > 0)
            if row == 2:
                lit &= h64.N[row] >= BSDF_EXIT_COS
            out = lit & ((d > TOL_F64["direction"])
                         | (dp > TOL_F64["position_mm"]))
            err[f"row {row} outside frac"] = out.double().mean().item()
            err[f"row {row} direction max"] = d[lit].max().item()
            err[f"row {row} position max"] = dp[lit].max().item()
        print(f"phase j9 ({smi}): (d) {bsdf.kind} BSDF, {bsdf_rays} rays, "
              f"injected draws, float32 vs float64: {json.dumps(err)}")
        check(all(err[f"row {r_} outside frac"] <= TOL_BSDF["outside_frac"]
                  for r_ in (1, 2)), f"{bsdf.kind} BSDF vs float64")
        # the generator's stream against the law: at normal incidence the
        # scattered (M', -L') is the disk draw (x, y)
        law2 = 0.25 if bsdf.kind == "lambertian" else bsdf.sigma ** 2
        mom = {}
        for k, v in (("M", h_own.M[1].double()), ("L", -h_own.L[1].double())):
            m1, m2 = v.mean(), (v * v).mean()
            se1 = v.std() / math.sqrt(v.numel())
            se2 = (v * v).std() / math.sqrt(v.numel())
            mom[k] = {"mean": m1.item(), "mean/se": (m1 / se1).item(),
                      "second": m2.item(),
                      "(second - law)/se": ((m2 - law2) / se2).item()}
            check(abs(mom[k]["mean/se"]) <= SIGMAS
                  and abs(mom[k]["(second - law)/se"]) <= SIGMAS,
                  f"{bsdf.kind} BSDF moments of {k}")
        print(f"phase j9 ({smi}): (d) {bsdf.kind} BSDF: the generator's "
              f"stream against the law (second moment {law2}) "
              f"{json.dumps(mom)}")
        del h, h_own, h64, draws
    seconds["(d)"] = clock() - t0

    # (e) the vectorial PSFs and MTF of the Cooke triplet at their
    # defaults, unpolarized, float32 against float64
    if wave:
        t0 = clock()
        lens32, scalar32 = CookeTriplet(), CookeTriplet()
        lens32.set_polarization("unpolarized")
        with precision("float64"):
            lens64 = CookeTriplet()
            lens64.set_polarization("unpolarized")
            lens64.build(device=dev)
        errs = {}
        reset_counts()
        for field in ((0.0, 0.0), (0.0, 1.0)):
            for name, cls, key in (("VectorialHuygensPSF",
                                    VectorialHuygensPSF, "huygens"),
                                   ("VectorialFFTPSF", VectorialFFTPSF,
                                    "fft")):
                p32 = cls(lens32, field, device=dev)
                with precision("float64"):
                    p64 = cls(lens64, field, device=dev)
                peak = p64.psf.abs().max()
                errs[f"{name} {field}"] = {
                    "psf_of_peak": ((p32.psf.double() - p64.psf).abs().max()
                                    / peak).item(),
                    "strehl": abs(p32.strehl_ratio().item()
                                  - p64.strehl_ratio().item())}
                check(errs[f"{name} {field}"]["psf_of_peak"]
                      <= TOL_WAVE[f"{key}_psf_of_peak"]
                      and errs[f"{name} {field}"]["strehl"]
                      <= TOL_WAVE[f"{key}_strehl"], f"{name} {field}")
        m32 = VectorialFFTMTF(lens32, device=dev)
        with precision("float64"):
            m64 = VectorialFFTMTF(lens64, device=dev)
        errs["VectorialFFTMTF"] = max(
            (a.double() - b).abs().max().item()
            for fa, fb_ in zip(m32.mtf, m64.mtf) for a, b in zip(fa, fb_))
        check(errs["VectorialFFTMTF"] <= TOL_WAVE["fft_mtf"],
              "VectorialFFTMTF vs float64")
        got = read_counts()
        print(f"phase j9: (e) the vectorial analyses: launches {got}")
        check(got["K8"] == 0, "the vectorial Huygens sum is no K8 launch")
        # the vectorial Strehl ratios against the scalar PSFs'
        strehl = {
            "fft": (VectorialFFTPSF(lens32, (0.0, 0.0), device=dev)
                    .strehl_ratio().item(),
                    ScalarFFTPSF(scalar32, (0.0, 0.0), device=dev)
                    .strehl_ratio().item()),
            "huygens": (VectorialHuygensPSF(lens32, (0.0, 0.0), device=dev)
                        .strehl_ratio().item(),
                        ScalarHuygensPSF(scalar32, (0.0, 0.0), device=dev)
                        .strehl_ratio().item())}
        for key, (v, s_) in strehl.items():
            check(abs(v - s_) <= TOL_VEC_STREHL[key],
                  f"vectorial {key} Strehl {v} vs scalar {s_}")
        # the Huygens PSF call at (0, 1), host clock, and its split, each
        # stage clocked inside the call itself: the class's module calls
        # `wavefront_data` (field and ideal) and `_component_sum` (image and
        # peak) through wrappers that synchronize around them; of
        # J9_SPLIT_CALLS warm calls, the one of median time, the rest the
        # call less its stages
        spent = {}

        def clocked(key, fn):
            def run(*a, **kw):
                t = clock()
                out = fn(*a, **kw)
                spent[key] = spent.get(key, 0.0) + clock() - t
                return out
            return run

        stages = {"wavefront_data (field and ideal)": "wavefront_data",
                  "component sums (image and peak)": "_component_sum"}
        orig = {key: getattr(huygens, name) for key, name in stages.items()}
        calls = []
        try:
            for key, name in stages.items():
                setattr(huygens, name, clocked(key, orig[key]))
            for _ in range(J9_SPLIT_CALLS):
                spent.clear()
                t1 = clock()
                VectorialHuygensPSF(lens32, (0.0, 1.0), device=dev)
                calls.append({"total": clock() - t1, **spent})
        finally:
            for key, name in stages.items():
                setattr(huygens, name, orig[key])
        for c in calls:
            c["rest"] = c["total"] - sum(c[key] for key in stages)
            check(set(stages) <= set(c) and c["rest"] >= 0.0,
                  f"VectorialHuygensPSF's stages ran inside the call: {c}")
        shares = [c["component sums (image and peak)"] / c["total"]
                  for c in calls]
        split = dict(sorted(calls, key=lambda c: c["total"])[
            len(calls) // 2])
        total = split.pop("total")
        split = {key: 1e3 * v for key, v in split.items()}
        split["component sums' share of each call"] = shares
        seconds["(e)"] = clock() - t0
        print(f"phase j9 ({smi}): (e) the vectorial analyses at their "
              f"defaults, float32 vs float64 on the card: {json.dumps(errs)}; "
              f"Strehl vectorial vs scalar {json.dumps(strehl)}; "
              f"VectorialHuygensPSF(CookeTriplet(), (0, 1)) {1e3 * total:.1f}"
              f" ms (the median of {J9_SPLIT_CALLS} warm calls), split "
              f"inside that call (ms) {json.dumps(split)}; "
              f"{seconds['(e)']:.1f} s")

    # (f) ThinFilmOptimizer in float64, the card against the CPU
    t0 = clock()
    runs = {}
    with precision("float64"):
        for where in (dev, torch.device("cpu")):
            opt = ThinFilmOptimizer(ar_stack(ThinFilmStack), device=where)
            opt.add_all_variables(min_nm=5.0, max_nm=400.0)
            opt.add_operand(property="R",
                            wavelength_nm=np.linspace(450, 650, 9),
                            target_type="equal", value=0.0)
            opt.add_operand(property="R", wavelength_nm=550.0, aoi_deg=30.0,
                            target_type="below", value=0.005,
                            polarization="s", weight=2.0)
            opt.optimize(max_iter=J9_STEPS)
            runs[where.type] = ([lay.thickness_um for lay in opt.stack.layers],
                                list(opt._history))
    th_err = max(abs(a - b) / abs(b) for a, b in zip(runs[dev.type][0],
                                                     runs["cpu"][0]))
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(runs[dev.type][1],
                                                       runs["cpu"][1]))
    seconds["(f)"] = clock() - t0
    print(f"phase j9: (f) ThinFilmOptimizer, {J9_STEPS} L-BFGS-B iterations "
          f"on a 4-layer AR stack, {dev.type} vs CPU (float64): merits "
          f"{runs[dev.type][1][0]!r} -> {runs[dev.type][1][-1]!r}, "
          f"thicknesses {th_err!r}, merit history {hist_err!r} relative "
          f"(tolerance {TOL_THIN_FILM}); {seconds['(f)']:.1f} s")
    check(th_err <= TOL_THIN_FILM and hist_err <= TOL_THIN_FILM
          and runs["cpu"][1][-1] < runs["cpu"][1][0],
          "ThinFilmOptimizer on the card vs the CPU")
    seconds["phase j9"] = time.perf_counter() - t_j9
    return seconds


# Phase j10: the analyses (`analysis/`, `mtf/geometric.py`, colorimetry) on
# the Cooke triplet, float32 on the card against float64 on the card. Every
# analysis that traces the unpolarized triplet reaches K7 as JAX's gates
# send it (the spot diagram at about the flagship's width: 3 fields x 3
# wavelengths x 222,769 hexapolar points, 272 rings, 2,004,921 rays, and
# its chief rays); the Jones pupil's polarized trace is eager (JAX's gate),
# the Y-Ybar diagram paraxial and colorimetry a sum over a spectrum.
J10_RINGS = 272
J10_RAYS = 3 * 3 * (1 + 3 * J10_RINGS * (J10_RINGS + 1))
J10_IMAGE = 512        # the image simulation's RGB source, pixels a side
J10_FREQ = 30.0        # ThroughFocusMTF's frequency, cycles/mm
J10_SEED = 17          # the random pupils' draws, the same in both precisions
# float32 against float64 on the card, each of the largest entry of the
# float64 result (`j10_errs`: NaN patterns must agree), unless named; the
# errors of a CPU rehearsal (float32 against float64 on the CPU, the same
# arithmetic as the card's plain versions) are given beside each:
#  - "position": image positions and what is made of them (spots, fans,
#    radii, heights, angles, the grid distortion, the pupil aberration):
#    float32 spacing at the 18 mm image height is 2e-6 mm, and a spot's
#    radius or a fan's error ~0.01-0.05 mm, so a few roundings a surface
#    are ~1e-4 of it (CPU: 5e-7 to 4e-4);
#  - "fit": the best-fit ray fans, whose origin is the centre of a
#    least-squares sphere through the float32 OPD, which carries TOL_WAVE's
#    noise of 0.014-0.018 waves rms (CPU: 1.1e-3);
#  - "energy": the encircled-energy curves, fractions of the energy: the
#    on-axis spot's core is ~0.003 mm across, where the curve climbs ~300 a
#    mm, so 1e-5 mm of rounding moves it ~3e-3 (CPU: 1.3e-3);
#  - "mtf": the geometric MTFs, absolute: float32 moves a ray across a bin
#    of the line-spread histogram when it lies within rounding of the edge,
#    and the spot is only 257 bins wide; each ray moved shifts the MTF by
#    its weight (1e-4) times the phase of one bin (CPU: 2e-4 to 4e-4);
#  - "histogram": the irradiance and radiant-intensity maps, the share of
#    the power that lands in another bin (sum |a - b| / sum |b|, a ray
#    moved counting twice): the on-axis spot straddles the detector's
#    central bin edges, x = 0 and y = 0, where float32 decides the side of
#    a ray within ~1e-6 mm of the axis, ~4e-6 / 0.003 of the spot's power
#    (CPU: 1.8e-3 irradiance, 4e-5 intensity);
#  - "wave": the wavefront errors and the image simulation, whose OPDs and
#    PSFs carry the float32 trace's OPD noise (CPU: 9e-3, 1.2e-3);
#  - "jones": the Jones pupil, a product of six faces' Fresnel amplitudes,
#    as TOL_POL's (CPU: 3.3e-6);
#  - "paraxial", "color": closed forms in a few dozen roundings (CPU:
#    7e-7, 4e-7).
TOL_J10 = {"position": 2e-3, "fit": 1e-2, "energy": 1e-2, "mtf": 5e-3,
           "histogram": 1e-2, "wave": 5e-2, "jones": 5e-5, "paraxial": 1e-5,
           "color": 1e-5}
# Two analyses depend on rounding rather than on the lens: `Distortion`
# divides by the image height of a chief ray at Hy = 1e-10 (4e-10 mm) and
# `FieldCurvature` intersects parabasal pairs split by 1e-5 in the pupil.
# In float32 they miss float64 by 9e-4 and 20 times their scale (CPU), an
# amplification of float32's 6e-8 by 1.6e4 and 3.3e8. Their float64 results
# on the card are held to float64 on the CPU (the same arithmetic, rounded
# with fused multiply-adds on the card): 3.3e8 times float64's 1.1e-16 is
# 4e-8, held at 1e-6 of their scale; float32's error is printed.
TOL_J10_ROUNDING = 1e-6


@contextlib.contextmanager
def seeded_draws(seed=J10_SEED):
    """`np.random.default_rng(None)` seeded: the random pupils of
    `core/distributions.random` (the default of EncircledEnergy,
    IncoherentIrradiance and RadiantIntensity, unseeded in both packages)
    draw the same points in both precisions."""
    orig = np.random.default_rng

    def rng(s=None):
        return orig(seed if s is None else s)

    np.random.default_rng = rng
    try:
        yield
    finally:
        np.random.default_rng = orig


def _leaves(tree, prefix=""):
    """{label: float64 numpy array} of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{key} ").items()}
    if isinstance(tree, (list, tuple)) and tree and not np.isscalar(tree[0]):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{prefix}{i} ").items()}
    a = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(
        tree)
    return {prefix.strip(): a.astype(np.complex128 if np.iscomplexobj(a)
                                     else np.float64)}


def j10_errs(got, ref, metric="rel"):
    """The largest error over the leaves of two results, and its leaf:
    max |a - b| / max |b| ("rel"), max |a - b| ("abs") or sum |a - b| /
    sum |b| ("moved"); infinite where the shapes or NaN patterns differ."""
    got, ref = _leaves(got), _leaves(ref)
    if got.keys() != ref.keys():
        return math.inf, "leaves"
    worst = (0.0, "")
    for key, b in ref.items():
        a = got[key]
        if a.shape != b.shape or (np.isnan(a) != np.isnan(b)).any():
            return math.inf, key
        a, b = a[~np.isnan(b)], b[~np.isnan(b)]
        if b.size == 0:
            continue
        d = np.abs(a - b)
        if metric == "moved":
            err = float(d.sum() / max(np.abs(b).sum(), 1e-300))
        elif metric == "abs":
            err = float(d.max())
        else:
            err = float(d.max() / max(np.abs(b).max(), 1e-300))
        worst = max(worst, (err, key))
    return worst


def j10_cases(image):
    """(name, make(lens, dev) -> result tree, tolerance key, metric, whether
    it reaches K7) of every analysis of phase j10 but the spot diagram at
    full width and the two rounding-bound ones, at their defaults."""
    from optiland_tpu_torch import analysis as A
    from optiland_tpu_torch import colorimetry
    from optiland_tpu_torch.mtf import GeometricMTF
    from optiland_tpu_torch.thin_film import ThinFilmStack

    def spot(s):
        return {"x": s.x, "y": s.y, "rms": s.rms_spot_radius(),
                "geo": s.geometric_spot_radius()}

    def fan(f):
        return {k: f.data[k] for k in ("ex", "ey", "intensity_x",
                                       "intensity_y")}

    def ee(e):
        radii, curves = e.encircled_energy()
        return {"radii": radii, "curves": curves}

    def pupil(p):
        return {f"{f} {w} {a}": p.data[f][w][a] for f in p.fields
                for w in p.wavelengths for a in ("x", "y")}

    def color(dev):
        stack = ar_stack(ThinFilmStack)
        nm = np.linspace(370.0, 790.0, 421)
        T = stack.transmittance_nm_deg(nm, 12.0, device=dev)
        X, Y, Z = colorimetry.spectrum_to_xyz(nm, T, device=dev)
        return {"T": T, "XYZ": [X, Y, Z],
                "xyY": list(colorimetry.xyz_to_xyY(X, Y, Z)),
                "sRGB": list(colorimetry.xyz_to_srgb(X, Y, Z))}

    return (
        ("SpotDiagram centroid", lambda L, d: spot(A.SpotDiagram(
            L, reference="centroid", device=d)), "position", "rel", True),
        ("GeometricMTF", lambda L, d: GeometricMTF(L, device=d).mtf, "mtf",
         "abs", True),
        ("EncircledEnergy", lambda L, d: ee(A.EncircledEnergy(L, device=d)),
         "energy", "rel", True),
        ("RmsSpotSizeVsField", lambda L, d: A.RmsSpotSizeVsField(
            L, device=d)._spot_size, "position", "rel", True),
        ("RmsWavefrontErrorVsField", lambda L, d: A.RmsWavefrontErrorVsField(
            L, device=d)._wavefront_error, "wave", "rel", True),
        ("RayFan", lambda L, d: fan(A.RayFan(L, device=d)), "position",
         "rel", True),
        ("BestFitRayFan", lambda L, d: fan(A.BestFitRayFan(L, device=d)),
         "fit", "rel", True),
        ("ThroughFocusSpotDiagram", lambda L, d: A.ThroughFocusSpotDiagram(
            L, device=d).data, "position", "rel", True),
        ("ThroughFocusMTF", lambda L, d: A.ThroughFocusMTF(
            L, J10_FREQ, device=d).data, "mtf", "abs", True),
        ("MTFvsField", lambda L, d: A.MTFvsField(L, device=d).data, "mtf",
         "abs", True),
        ("GridDistortion", lambda L, d: A.GridDistortion(L, device=d).data,
         "position", "rel", True),
        ("YYbar", lambda L, d: A.YYbar(L, device=d).data, "paraxial", "rel",
         False),
        ("PupilAberration", lambda L, d: pupil(A.PupilAberration(
            L, device=d)), "position", "rel", True),
        ("AngleVsHeight", lambda L, d: A.AngleVsHeight(L, device=d).data,
         "position", "rel", True),
        ("PupilIncidentAngleVsHeight",
         lambda L, d: A.PupilIncidentAngleVsHeight(L, Hy=1.0,
                                                   device=d).data,
         "position", "rel", True),
        ("FieldIncidentAngleVsHeight",
         lambda L, d: A.FieldIncidentAngleVsHeight(L, Py=0.5,
                                                   device=d).data,
         "position", "rel", True),
        ("IncoherentIrradiance", lambda L, d: A.IncoherentIrradiance(
            L, device=d).data, "histogram", "moved", True),
        ("RadiantIntensity", lambda L, d: [[c[0] for c in row] for row in
                                           A.RadiantIntensity(
                                               L, device=d).data],
         "histogram", "moved", True),
        ("JonesPupil", lambda L, d: [j["J"] for j in A.JonesPupil(
            L, device=d).data], "jones", "rel", False),
        ("ImageSimulationEngine", lambda L, d: A.ImageSimulationEngine(
            L, image, device=d).run(), "wave", "rel", True),
        ("colorimetry", lambda L, d: color(d), "color", "rel", False),
    )


def phase_j10(dev, reset_counts, read_counts, smi, rings=J10_RINGS,
              image_size=J10_IMAGE, cases=None):
    """Phase j10 on `dev` (the card; a CPU rehearsal passes the CPU, fewer
    rings, a smaller image and a subset of the cases' names): (a) the spot
    diagram at full width through K7, its image rows against K7's plain
    version on the same rays and its radii against float64; (b) every
    other analysis at its defaults, float32 against float64; (c) the two
    rounding-bound analyses in float64, the card against the CPU. Returns
    the seconds of each part and the K7 timing row of (a)."""
    from optiland_tpu_torch.analysis import SpotDiagram
    from optiland_tpu_torch.analysis import Distortion, FieldCurvature
    from optiland_tpu_torch.analysis.base import like
    from optiland_tpu_torch.analysis.image_simulation import PSFBasisGenerator
    from optiland_tpu_torch.analysis.spot import field_pupil_batch
    from optiland_tpu_torch.core import distributions as dist
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.trace import fused
    from optiland_tpu_torch.trace.raygen import generate_rays

    on_card = dev.type == "cuda"
    t_j10 = time.perf_counter()
    seconds = {}

    def clock():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    def row(name, t32, t64, got, err, tol):
        print(f"phase j10 ({smi}): {name}: float32 {1e3 * t32:.1f} ms, "
              f"float64 {1e3 * t64:.1f} ms (host clock); launches "
              f"{json.dumps(got)}; error vs float64 {err[0]!r} at "
              f"{err[1]!r} (tolerance {tol!r})")

    # (a) the spot diagram at full width
    lens = CookeTriplet()
    reset_counts()
    t0 = clock()
    spot = SpotDiagram(lens, num_rings=rings, device=dev)
    radii = (spot.rms_spot_radius(), spot.geometric_spot_radius())
    t_spot = clock() - t0
    got = read_counts()
    n = spot.x.numel()
    check(spot.x.shape == (3, 3, n // 9) and spot.x.device.type == dev.type
          and spot.x.dtype == torch.float32
          and all(bool(torch.isfinite(a).all())
                  for a in (spot.x, spot.y, spot.intensity) + radii),
          "spot diagram: shape, device, dtype, finite")
    if on_card:
        check(n == J10_RAYS, f"spot diagram of {J10_RAYS} rays")
        check(got["K7"] == 2 and sum(got.values()) == 2,
              f"the spot diagram launched K7 twice (bundle, chief rays): "
              f"{got}")
    # K7's image rows against its plain version on the same rays
    static, params = lens.build(device=dev)
    Px, Py = (like(a, params) for a in dist.hexapolar(rings))
    rays0 = generate_rays(static, params, *field_pupil_batch(
        spot.fields, spot.wavelengths, Px, Py, params))
    rays9 = tuple(getattr(rays0, k).detach().contiguous()
                  for k in fused._RAY_KEYS)
    del rays0
    p7 = (fused._diff_params(params), fused._nondiff_params(params))
    t0 = clock()
    plain = fused._history_plain(static, *p7, rays9)
    plain_ms = 1e3 * (clock() - t0)
    mine = (spot.x.reshape(-1), spot.y.reshape(-1),
            spot.intensity.reshape(-1))
    keep = (mine[2] > 0) == (plain[6][-1] > 0)
    k7_err = {"intensity_frac": 1.0 - keep.double().mean().item()}
    for key, a, b in (("x", mine[0], plain[0][-1]), ("y", mine[1],
                                                    plain[1][-1]),
                      ("intensity", mine[2], plain[6][-1])):
        k7_err[key] = max_abs(a, b, keep)
    del plain
    print(f"phase j10: the spot diagram's image rows ({n} rays) vs K7's "
          f"plain version: {json.dumps(k7_err)} tolerances "
          f"{json.dumps(TOL)}")
    check(k7_err["intensity_frac"] <= TOL["intensity_frac"]
          and k7_err["x"] <= TOL["position_mm"]
          and k7_err["y"] <= TOL["position_mm"]
          and k7_err["intensity"] <= TOL["intensity"],
          "spot diagram's K7 rows vs plain")
    k7_row = None
    if on_card:
        S = static.num_surfaces
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn, args, _outs, _keep = fused.k7_launch(static, *p7, rays9)

        def launch():
            check(fn(*args, stream) == 0, "K7 launch")

        b_ms, b_by = bound_ms((9 + 8 * S) * 4 * n,
                              history_ops_per_ray(static, fused) * n)
        k7_row = {"launches": got["K7"], "max_abs_err": max(
            v for k, v in k7_err.items() if k != "intensity_frac"),
            "ms": time_ms(launch), "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "rays": n}
        print(f"phase j10 ({smi}): K7 on the spot diagram's {n} rays: "
              f"{json.dumps(k7_row)}")
        del _outs, _keep
    del rays9
    # the radii against the eager float64 path on the same device
    with precision("float64"):
        t0 = clock()
        spot64 = SpotDiagram(CookeTriplet(), num_rings=rings, device=dev)
        radii64 = (spot64.rms_spot_radius(), spot64.geometric_spot_radius())
        t64 = clock() - t0
    check(read_counts() == got, "the float64 spot diagram ran eager")
    err = j10_errs({"rms": radii[0], "geo": radii[1]},
                   {"rms": radii64[0], "geo": radii64[1]})
    row(f"SpotDiagram(num_rings={rings}), {n} rays, radii", t_spot, t64,
        got, err, TOL_J10["position"])
    check(err[0] <= TOL_J10["position"], "spot radii vs float64")
    del spot, spot64
    # the host's share: the hexapolar pupil (a Python loop over the rings)
    # and the PSF basis's 25 `wavefront_data` calls of one wavelength
    t0 = clock()
    dist.hexapolar(rings)
    split = {"hexapolar pupil": 1e3 * (clock() - t0)}
    t0 = clock()
    PSFBasisGenerator(CookeTriplet(), 0.55, device=dev).generate_basis(3)
    split["PSF basis at 0.55 um"] = 1e3 * (clock() - t0)
    print(f"phase j10 ({smi}): host-clock ms of {json.dumps(split)}")
    seconds["(a)"] = time.perf_counter() - t_j10

    # (b) every other analysis at its defaults
    t_b = time.perf_counter()
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (image_size, image_size, 3), np.uint8)
    times = {}
    for name, make, tol_key, metric, k7 in j10_cases(image):
        if cases is not None and name not in cases:
            continue
        with seeded_draws():
            lens = CookeTriplet()
            reset_counts()
            t0 = clock()
            res32 = make(lens, dev)
            t32 = clock() - t0
            got = read_counts()
        with seeded_draws(), precision("float64"):
            t0 = clock()
            res64 = make(CookeTriplet(), dev)
            t64 = clock() - t0
        err = j10_errs(res32, res64, metric)
        times[name] = round(1e3 * t32, 1)
        row(name, t32, t64, got, err, TOL_J10[tol_key])
        check(err[0] <= TOL_J10[tol_key], f"{name} vs float64")
        if on_card:
            check(got["K8"] == 0, f"{name}: no K8 (FFT PSFs)")
            check((got["K7"] > 0) == k7,
                  f"{name}: K7 {'launched' if k7 else 'not launched'}")
    seconds["(b)"] = time.perf_counter() - t_b

    # (c) the rounding-bound analyses: float64, the card against the CPU;
    # float32's error printed
    t_c = time.perf_counter()
    for name, cls in (("Distortion", Distortion),
                      ("FieldCurvature", FieldCurvature)):
        reset_counts()
        t0 = clock()
        res32 = cls(CookeTriplet(), device=dev).data
        t32 = clock() - t0
        got = read_counts()
        with precision("float64"):
            t0 = clock()
            res64 = cls(CookeTriplet(), device=dev).data
            t64 = clock() - t0
            cpu64 = cls(CookeTriplet(), device="cpu").data
        err = j10_errs(res64, cpu64)
        err32 = j10_errs(res32, res64)
        print(f"phase j10 ({smi}): {name}: float32 {1e3 * t32:.1f} ms, "
              f"float64 {1e3 * t64:.1f} ms (host clock); launches "
              f"{json.dumps(got)}; float64 on the {dev.type} vs the CPU "
              f"{err[0]!r} at {err[1]!r} (tolerance {TOL_J10_ROUNDING}); "
              f"float32 vs float64 {err32[0]!r} at {err32[1]!r}, "
              "rounding-bound (a chief ray at Hy = 1e-10; parabasal pairs "
              "1e-5 apart)")
        check(err[0] <= TOL_J10_ROUNDING, f"{name}: float64, card vs CPU")
        if on_card:
            check(got["K7"] > 0 and got["K8"] == 0, f"{name}: K7")
        times[name] = round(1e3 * t32, 1)
    seconds["(c)"] = time.perf_counter() - t_c
    seconds["phase j10"] = time.perf_counter() - t_j10
    print(f"phase j10 ({smi}): float32 host-clock ms per analysis "
          f"{json.dumps(times)}")
    return seconds, k7_row


# Phase j11: ray-batch sharding (parallel/). The flagship batch over two
# spawned ranks on the one card (gloo: NCCL takes one rank per card), each
# on its half; the Cooke tolerancing's draws split over them.
J11_RANKS = 2
RUN_LIMIT_S = 1200   # the seconds a run of this script may take in all
J11_TIMED_STEPS = 3
# (d): the ML wrapper's Adam steps, the SMF source's rays (a power of two)
J11_FIT_STEPS, J11_FIT_LR = 3, 0.005
J11_SOURCE_RAYS = 1 << 20
# The SMF source's rays in float32 against float64: erfinv(2 u - 1) of the
# Sobol points, whose extremes lie ~2^-20 from 0 and 1, where float32
# rounds 2 u - 1 to ~6e-8 and erfinv's slope grows as exp(erfinv^2): the
# float32 rays miss float64's by up to 4.4e-3 of each array's scale (x)
# at 2^20 rays on the CPU, before any trace. The trace itself is held to
# TOL_EAGER against float64 from the same float32 start.
TOL_J11_SOURCE = 1e-2


def j11_rank(dev, n, rays_per_field, timed_steps, draws, rings):
    """One spawned rank of phase j11: the sharded flagship and spot steps
    (`dryrun.sharded_steps`), this rank's partial gradients of both
    (`j11_partials`), then phase j8's Cooke tolerancing over `draws` draws
    (seed 1, its RMS spot over `rings` rings) split over a ("rays",) mesh
    of every rank."""
    from optiland_tpu_torch import tolerancing
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.parallel import dryrun, make_mesh

    out = dryrun.sharded_steps(dev, n, rays_per_field, timed_steps)
    out["partials"], out["spot_partials"] = j11_partials(
        dev, n, rays_per_field, out["wavelength"])
    lens = CookeTriplet()
    lens.build(device=dev)
    mc = tolerancing.MonteCarlo(cooke_tolerancing(tolerancing, lens,
                                                  rings=rings),
                                mesh=make_mesh())
    t0 = time.perf_counter()
    df = mc.run(draws, seed=1)
    out["monte_carlo_s"] = time.perf_counter() - t0
    out["monte_carlo"] = {"columns": list(df.columns),
                          "values": torch.tensor(df.to_numpy())}
    return out


def j11_partials(dev, n, rays_per_field, wavelength):
    """This rank's part of each gradient of the flagship and spot steps
    (`dryrun.sharded_steps`' batch and mesh): its local gradient before
    `average_gradients`, over the mesh size. The parts of the ranks sum to
    the whole gradient; their scale sets the rounding of that sum where
    the parts cancel, and a reduction that lost one rank would be off by
    that rank's part. ({leaf: part} of the flagship step, of the spot
    step), on the CPU."""
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.optimization.merits import centroid_rms_spot
    from optiland_tpu_torch.parallel import dryrun, shard_rays
    from optiland_tpu_torch.trace.tracer import trace_system

    static, params = CookeTriplet().build(device=dev)
    mesh = dryrun.dryrun_mesh()
    batch = shard_rays(mesh, dryrun.dryrun_batch(static, params, n,
                                                 rays_per_field))
    out = []
    for merit in (
            lambda p: dryrun.flagship_merit(trace_system(static, p, *batch),
                                            mesh),
            lambda p: centroid_rms_spot(static, p, *batch[:4], wavelength,
                                        diff_inputs=False, mesh=mesh)):
        leaves, p = dryrun.leaves_of(params)
        merit(p).backward()
        out.append({k: (v.grad / mesh.size()).cpu()
                    for k, v in leaves.items() if v.grad is not None})
    return out


def j11_grad_limits(errs, noise, whole, parts, got):
    """The limit each gradient of a sharded step is held to, and the error
    a reduction that lost one rank's part would make on it. `errs`: each
    gradient's error against the unsharded float32 step (relative to its
    leaf's largest); `noise`: the unsharded float32 step's own error
    against float64 on the same leaf; `whole`: the unsharded gradients;
    `parts`: each rank's parts ({leaf: part}, `j11_partials`); `got`: this
    rank's gradients. A gradient within TOL["param_grad_rel"] is held to
    that. Past it, a leaf that cancels (the ranks' parts outgrow the whole
    by A, and float32 rounds each part at its own scale) is held to
    GRAD_NOISE_FACTOR times its noise times max(A, 1), but only where that
    still sees a lost rank: the limit must lie below the largest error
    that leaving out one rank's part of the average makes. Returns
    ({leaf: limit}, {leaf: A}, {leaf: a lost rank's error})."""
    limits, amp, lost = {}, {}, {}
    for k, err in errs.items():
        scale = whole[k].abs().max().item()
        amp[k] = max(part[k].abs().max().item() for part in parts) / scale
        lost[k] = max(rel_err(got[k] - part[k], whole[k]) for part in parts)
        limits[k] = TOL["param_grad_rel"]
        if err > TOL["param_grad_rel"]:
            limits[k] = max(limits[k], GRAD_NOISE_FACTOR * noise[k]
                            * max(amp[k], 1.0))
    return limits, amp, lost


def bitwise(a, b):
    """The same shape and the same bits (NaN and inf included)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def adam_step_errs(got, ref, grads, params, lr):
    """Per leaf, the largest difference of two Adam first steps over lr, on
    the entries whose reference gradient lies past TOL["param_grad_rel"] of
    its leaf's largest (float32 fixes their sign; an entry within the
    gradient's tolerance of 0 has none, and Adam's first step moves it by
    +-lr either way), and the count of entries left out."""
    errs, left = {}, 0
    for k, g in grads.items():
        sure = g.abs() > TOL["param_grad_rel"] * g.abs().max()
        sure &= torch.isfinite(params[k])
        left += int(((g != 0) & torch.isfinite(params[k]) & ~sure).sum())
        if sure.any():
            errs[k] = ((got[k] - ref[k])[sure].abs().max() / lr).item()
    return errs, left


def phase_j11(dev, reset_counts, read_counts, smi,
              rays_per_field=FLAGSHIP_RAYS_PER_FIELD, ranks=J11_RANKS,
              timed_steps=J11_TIMED_STEPS, draws=TOLERANCING_DRAWS,
              rings=TOLERANCING_RINGS, source_rays=J11_SOURCE_RAYS):
    """Phase j11 on `dev` (the card; a CPU rehearsal passes the CPU, a few
    rays a field, few draws, rings and source rays): (a) the flagship
    training step (K7, Adam) and the spot merit at FLAGSHIP_WAVELENGTH
    (K1, K2) on one-rank meshes, bitwise against the unsharded steps; (b)
    both on `ranks` spawned ranks, each on its shard, within TOL of the
    unsharded steps, each rank's kernels launched; (c) in the same ranks,
    phase j8's Monte-Carlo tolerancing split over them, equal to the
    unsharded run; (d) the Cooke triplet written and read back in the
    three file formats, traced through K7 against the original; the ML
    wrapper's Adam steps against float64; draw, draw3D and info; an SMF
    source through trace_source against float64. Returns the seconds of
    each part and the timing rows."""
    import torch.distributed as dist

    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.parallel import (init_distributed, make_mesh,
                                             make_mesh_2d)
    from optiland_tpu_torch.parallel import dryrun

    on_card = dev.type == "cuda"
    t_j11 = time.perf_counter()
    seconds, rows = {}, {}

    def clock():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    def timed(fn):
        """fn() with the counters at 0 just before: (result, launches,
        host-clock ms)."""
        reset_counts()
        t0 = clock()
        out = fn()
        ms = 1e3 * (clock() - t0)
        return out, read_counts(), ms

    static, params = CookeTriplet().build(device=dev)
    n = rays_per_field * static.num_fields * static.num_wavelengths
    batch = dryrun.dryrun_batch(static, params, n, rays_per_field)
    wl = FLAGSHIP_WAVELENGTH

    def flag(mesh=None):
        return timed(lambda: dryrun.flagship_step(static, params, batch,
                                                  mesh))

    def spot(mesh=None):
        return timed(lambda: dryrun.spot_step(static, params, batch[:4], wl,
                                              mesh))

    # (a) one-rank meshes (NCCL on the card): a one-rank all-reduce is the
    # identity, so the sharded steps are the unsharded ones bit for bit.
    # The flagship step's backward reads the extinction tables through
    # `torch.gather`, whose backward adds each ray into the table by
    # atomics on the card, in no fixed order: the four steps run under
    # PyTorch's deterministic algorithms, and a fifth unsharded step
    # outside them shows how far two runs of it differ
    t_a = time.perf_counter()
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (loss0, g0, p0), k_flag0, ms_flag0 = flag()
        (sl0, sg0), k_spot0, ms_spot0 = spot()
        init_distributed(device=dev)
        backend = dist.get_backend()
        mesh2, mesh1 = make_mesh_2d(1, 1), make_mesh(1)
        (loss1, g1, p1), k_flag1, ms_flag1 = flag(mesh2)
        (sl1, sg1), k_spot1, ms_spot1 = spot(mesh1)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    (_, g_free, _), _, _ = flag()
    free_diff = {k: rel_err(g_free[k], g0[k]) for k in g0
                 if not bitwise(g_free[k], g0[k])}
    same = {"loss": bitwise(loss1, loss0), "spot loss": bitwise(sl1, sl0),
            "gradients": all(bitwise(g1[k], g0[k]) for k in g0),
            "stepped parameters": all(bitwise(p1[k], p0[k]) for k in p0),
            "spot gradients": all(bitwise(sg1[k], sg0[k]) for k in sg0)}
    print(f"phase j11 ({smi}): (a) one-rank {backend} meshes, {n} rays: "
          f"flagship step (K7, Adam over {len(p0)} leaves) unsharded "
          f"{ms_flag0:.1f} ms {json.dumps(k_flag0)}, on ('hosts', 'chips') "
          f"= (1, 1) {ms_flag1:.1f} ms {json.dumps(k_flag1)}; spot merit at "
          f"{wl} um (K1, K2) unsharded {ms_spot0:.1f} ms "
          f"{json.dumps(k_spot0)}, on ('rays',) = (1,) {ms_spot1:.1f} ms "
          f"{json.dumps(k_spot1)} (host clock, first calls; deterministic "
          f"algorithms); bitwise equal {json.dumps(same)}; loss "
          f"{loss0.item()!r}, spot loss {sl0.item()!r}; the unsharded "
          "flagship step run again without deterministic algorithms, the "
          "gradients that differ (relative to their leaf's largest) "
          f"{json.dumps(free_diff)}")
    check(all(same.values()), "phase j11 (a): one rank equals unsharded")
    for k in (k_flag0, k_flag1):
        check(not on_card or (k["K7"] == 1 and sum(k.values()) == 1),
              f"phase j11 (a): the flagship step launched K7 once: {k}")
    for k in (k_spot0, k_spot1):
        check(not on_card or (k["K1"] == 1 and k["K2"] == 1
                              and sum(k.values()) == 2),
              f"phase j11 (a): the spot merit launched K1 and K2: {k}")
    if timed_steps:
        for key, m2, m1 in (("unsharded", None, None),
                            ("1 rank", mesh2, mesh1)):
            rows[key] = dryrun.step_times(
                dev, lambda: dryrun.flagship_step(static, params, batch, m2),
                lambda: dryrun.spot_step(static, params, batch[:4], wl, m1),
                timed_steps)
    dist.destroy_process_group()
    seconds["(a)"] = time.perf_counter() - t_a

    # (b) `ranks` spawned ranks on the one card, each on its half: only the
    # order of the float32 sums differs from the unsharded step
    t_b = time.perf_counter()
    res = dryrun.spawn(ranks, j11_rank, n, rays_per_field, timed_steps,
                       draws, rings, device=dev,
                       precision="float32" if on_card else "float64")
    seconds["(b) spawn"] = time.perf_counter() - t_b
    g0c, sg0c = ({k: v.cpu() for k, v in d.items()} for d in (g0, sg0))
    p0c = {k: v.cpu() for k, v in p0.items()}
    p_start = {k: getattr(params, k).cpu() for k in p0}
    # the unsharded float32 steps' own error against float64 on each leaf
    # (the flagship gradients that cancel: GRAD_NOISE_FACTOR); a CPU
    # rehearsal keeps its float64 after
    from optiland_tpu_torch import config

    was = "float64" if config.get_dtype() == torch.float64 else "float32"
    with precision("float64"):
        st64, pr64 = CookeTriplet().build(device=dev)
        b64 = tuple(a.double() for a in batch)
        f64 = dryrun.flagship_step(st64, pr64, b64)[1]
        s64 = dryrun.spot_step(st64, pr64, b64[:4], wl)[1]
    noise = {k: rel_err(g0c[k], f64[k].cpu()) for k in g0c}
    spot_noise = {k: rel_err(sg0c[k], s64[k].cpu()) for k in sg0c}
    del st64, pr64, b64, f64, s64
    config.set_precision(was)
    print(f"phase j11 ({smi}): (b) the unsharded float32 steps' gradients "
          f"vs float64, flagship {json.dumps(noise)}, spot "
          f"{json.dumps(spot_noise)}")

    for r in res:
        loss_errs = {"loss_rel": abs(r["loss"].item() - loss0.item())
                     / abs(loss0.item()),
                     "spot_loss_rel": abs(r["spot_loss"].item() - sl0.item())
                     / abs(sl0.item())}
        held = {}
        for label, whole, got, parts, leaf_noise in (
                ("flagship", g0c, r["grads"], [q["partials"] for q in res],
                 noise),
                ("spot", sg0c, r["spot_grads"],
                 [q["spot_partials"] for q in res], spot_noise)):
            errs = {k: rel_err(got[k], whole[k]) for k in whole
                    if whole[k].abs().max() > 0}
            limits, amp, lost = j11_grad_limits(errs, leaf_noise, whole,
                                                parts, got)
            held[label] = {k: {"error": errs[k], "limit": limits[k],
                               "parts_over_whole": amp[k],
                               "one_rank_lost": lost[k]} for k in errs}
        step, left = adam_step_errs(r["params"], p0c, g0c, p_start,
                                    dryrun.ADAM_LR)
        print(f"phase j11 ({smi}): (b) rank {r['rank']} of {r['world']} "
              f"({r['device']}, gloo), {r['rays']} rays: launches "
              f"{json.dumps(r['launches'])}, host clock (s, first calls) "
              f"{json.dumps(r['seconds'])}, median ms {json.dumps(r['ms'])}; "
              f"vs unsharded: {json.dumps(loss_errs)} (tolerance "
              f"{TOL['moment_rel']}); Adam step / lr {json.dumps(step)} "
              f"(tolerance {TOL['param_grad_rel']}; {left} entries whose "
              "gradient is within its tolerance of 0 left out); each "
              "gradient's error relative to its leaf's largest, the limit it "
              f"is held to ({TOL['param_grad_rel']}, or past it "
              f"{GRAD_NOISE_FACTOR}x the unsharded float32 step's own error "
              "against float64 on its leaf times max(1, the ranks' parts' "
              "scale over the whole's)), and the error one rank's part left "
              "out of the average would make, which must exceed the limit: "
              f"{json.dumps(held)}")
        check(all(v <= TOL["moment_rel"] for v in loss_errs.values()),
              f"phase j11 (b) rank {r['rank']}: losses")
        for label, rows_held in held.items():
            for k, h in rows_held.items():
                check(h["error"] <= h["limit"],
                      f"phase j11 (b) rank {r['rank']}: the {label} "
                      f"gradient {k}, {h['error']} past its limit "
                      f"{h['limit']}")
                check(h["one_rank_lost"] > h["limit"],
                      f"phase j11 (b) rank {r['rank']}: the {label} "
                      f"gradient {k}'s limit {h['limit']} would pass a "
                      f"reduction that lost a rank ({h['one_rank_lost']})")
        check(all(v <= TOL["param_grad_rel"] for v in step.values()),
              f"phase j11 (b) rank {r['rank']}: the Adam step")
        check(all(bitwise(r["params"][k], res[0]["params"][k])
                  for k in p0c), "phase j11 (b): the ranks' parameters agree")
        if on_card:
            f, s = r["launches"]["flagship"], r["launches"]["spot"]
            check(f["K7"] == 1 and s["K1"] == 1 and s["K2"] == 1,
                  f"phase j11 (b) rank {r['rank']}: K1, K2, K7 launched")
        if timed_steps:
            rows[f"rank {r['rank']} of {r['world']}"] = r["ms"]
    rows["kernels"] = _j11_kernel_rows(static, params, batch, wl, res)
    seconds["(b)"] = time.perf_counter() - t_b

    # (c) the tolerancing's draws split over the ranks (in the spawn of
    # (b)): each draw's pipeline is its own, so the table is the
    # unsharded run's bit for bit
    t_c = time.perf_counter()
    from optiland_tpu_torch import tolerancing

    lens_t = CookeTriplet()
    lens_t.build(device=dev)
    tol_t = cooke_tolerancing(tolerancing, lens_t, rings=rings)
    reset_counts()
    t0 = clock()
    df = tolerancing.MonteCarlo(tol_t).run(draws, seed=1)
    mc_s = clock() - t0
    mc_launches = read_counts()
    mc_ref = torch.tensor(df.to_numpy())
    for r in res:
        mc = r["monte_carlo"]
        same_mc = mc["columns"] == list(df.columns) and bitwise(
            mc["values"], mc_ref)
        print(f"phase j11 ({smi}): (c) MonteCarlo(mesh=) on rank "
              f"{r['rank']} of {r['world']}: {draws} draws, "
              f"{r['monte_carlo_s']:.2f} s (unsharded {mc_s:.2f} s, "
              f"launches {json.dumps(mc_launches)}); the table equal to "
              f"the unsharded run's bit for bit: {same_mc}")
        check(same_mc, f"phase j11 (c) rank {r['rank']}: the Monte-Carlo "
              "table")
    check(not on_card or mc_launches["K7"] >= draws,
          "phase j11 (c): the unsharded draws launched K7")
    seconds["(c)"] = time.perf_counter() - t_c

    # (d) fileio/, ml/, visualization/ and sources/ on the card
    t_d = time.perf_counter()
    seconds.update(_j11_d(dev, reset_counts, read_counts, smi, static,
                          params, batch, rings, source_rays, on_card))
    seconds["(d)"] = time.perf_counter() - t_d
    seconds["phase j11"] = time.perf_counter() - t_j11
    return seconds, rows


def _j11_kernel_rows(static, params, batch, wl, res):
    """The kernels line's rows of K1, K2 and K7 under the mesh: rank 0's
    median launch span and launches from its main path, each kernel
    against its plain version on rank 0's shard (the batch's first
    part) here, the plain version's one cold call (host clock), and the
    bound at the shard's rays."""
    from optiland_tpu_torch.optimization.merits import (
        centroid_rms_from_moments,
    )
    from optiland_tpu_torch.trace import fused
    from optiland_tpu_torch.trace.raygen import generate_rays

    def cold(fn):
        on_card = batch[0].is_cuda
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    nh = batch[0].shape[0] // len(res)
    half = tuple(a[:nh].contiguous() for a in batch)
    S = static.num_surfaces
    pc, data = fused._prepare(static, params, *half[:4], wl)
    m = fused.moments_forward(static, *pc, data)
    m_plain, k1_plain_ms = cold(lambda: fused._moments_plain(static, *pc,
                                                             data))
    mc = m.detach().requires_grad_(True)
    c, = torch.autograd.grad(centroid_rms_from_moments(*mc.unbind()), mc)
    k2 = fused.moments_backward(static, *pc, data, c, False)
    k2_plain, k2_plain_ms = cold(lambda: fused._moments_bwd_plain(
        static, *pc, data, c, False))
    rays0 = generate_rays(static, params, *half)
    rays9 = tuple(getattr(rays0, k).detach().contiguous()
                  for k in fused._RAY_KEYS)
    p7 = (fused._diff_params(params), fused._nondiff_params(params))
    h = fused.history_forward(static, *p7, rays9)
    h_plain, k7_plain_ms = cold(lambda: fused._history_plain(static, *p7,
                                                             rays9))
    # each held as the full batch's rows are: K1's moments relative to
    # their natural scale, K2's cotangent groups relative to their largest,
    # K7's arrays on the rays both versions keep lit at every surface
    scale = torch.stack([m_plain[0], (m_plain[0] * m_plain[3]).sqrt(),
                         (m_plain[0] * m_plain[3]).sqrt(), m_plain[3]])
    k1_rel = ((m - m_plain).abs() / scale).max().item()
    print(f"K1 under the mesh ({nh} rays) vs plain: max rel {k1_rel:.6g} "
          f"(tolerance {TOL['moment_rel']})")
    check(k1_rel <= TOL["moment_rel"], "K1 under the mesh vs plain")
    k2_errs, k2_rays, k2_abs = cotangent_errs(k2, k2_plain, None)
    check_cotangents(f"K2 under the mesh ({nh} rays)", k2_errs, k2_rays)
    keep = ((h[6] > 0) == (h_plain[6] > 0)).all(dim=0)
    k7_err = {"intensity_frac": 1.0 - keep.double().mean().item()}
    for k, key in enumerate(fused._NAMES):
        k7_err[key] = max_abs(h[k][:, keep], h_plain[k][:, keep])
    print(f"K7 under the mesh ({nh} rays) vs plain, all rows: "
          f"{json.dumps(k7_err)} tolerances {json.dumps(TOL)}")
    check(k7_err["intensity_frac"] <= TOL["intensity_frac"],
          "K7 under the mesh: i set")
    for key, tol in (("x", "position_mm"), ("y", "position_mm"),
                     ("z", "position_mm"), ("L", "direction"),
                     ("M", "direction"), ("N", "direction"),
                     ("intensity", "intensity"), ("opd", "opd_mm")):
        check(k7_err[key] <= TOL[tol], f"K7 under the mesh {key} vs plain")
    errs = {"K1": k1_rel, "K2": k2_abs,
            "K7": max(v for k, v in k7_err.items() if k != "intensity_frac")}
    bounds = {
        "K1": bound_ms(4 * 4 * nh,
                       (chain_ops_per_ray(static, fused) + 10) * nh),
        "K2": bound_ms(4 * 4 * nh,
                       (backward_ops_per_ray(static, fused) + 8) * nh),
        "K7": bound_ms((9 + 8 * S) * 4 * nh,
                       history_ops_per_ray(static, fused) * nh)}
    plain = {"K1": k1_plain_ms, "K2": k2_plain_ms, "K7": k7_plain_ms}
    meta = {"K1": ("_moments_forward", "moments_fwd.cu", 1431, "spot"),
            "K2": ("_moments_bwd", "moments_bwd.cu", 1509, "spot"),
            "K7": ("_history_forward", "history_fwd.cu", 1258, "flagship")}
    out = []
    for key, (fn_name, src, line, path) in meta.items():
        out.append(dict(
            name=(f"{key} {fn_name} under the mesh (rank 0 of {len(res)}, "
                  f"{nh} rays; ranks' spans (ms) "
                  f"{[r['ms'].get(key) for r in res]}"
                  + ("; max_abs_err relative to the moments' scale"
                     if key == "K1" else "") + ")"),
            route="cuda", source=f"optiland_tpu_torch/csrc/{src}",
            replaces=f"optiland_tpu/trace/fused.py:{line}",
            launches=res[0]["launches"][path][key], max_abs_err=errs[key],
            ms=res[0]["ms"].get(key), plain_ms=plain[key],
            bound_ms=bounds[key][0], bound_by=bounds[key][1],
            library_ms=None))
    return out


def _j11_d(dev, reset_counts, read_counts, smi, static, params, batch,
           rings, source_rays, on_card):
    """Phase j11 (d); returns the seconds of each of its rows."""
    import io
    import tempfile

    from optiland_tpu_torch import fileio
    from optiland_tpu_torch.ml import OpticalSystemModule
    from optiland_tpu_torch.core.rays import Rays
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.optimization import OptimizationProblem
    from optiland_tpu_torch.sources import SMFSource
    from optiland_tpu_torch.sources.base import trace_source
    from optiland_tpu_torch.system.optic import Optic
    from optiland_tpu_torch.trace import tracer
    from optiland_tpu_torch.visualization import (OpticViewer3D,
                                                  SurfaceSagViewer)

    seconds = {}
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    tols = {"x": TOL["position_mm"], "y": TOL["position_mm"],
            "z": TOL["position_mm"], "L": TOL["direction"],
            "M": TOL["direction"], "N": TOL["direction"],
            "intensity": TOL["intensity"], "opd": TOL["opd_mm"]}

    def hist_errs(got, ref):
        keep = ((got.intensity > 0) == (ref.intensity > 0)).all(dim=0)
        return {k: (getattr(got, k) - getattr(ref, k))[:, keep].abs().max(
        ).item() for k in names}

    # the Cooke triplet written by each writer and read back, traced
    # through K7 on the flagship batch against the original's K7 history
    t0 = time.perf_counter()
    reset_counts()
    ref = tracer.trace_system(static, params, *batch)
    check(not on_card or read_counts()["K7"] == 1, "(d) the original's K7")
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, save, load in (
                ("json", fileio.save_optiland_file, fileio.load_optiland_file),
                ("zmx", fileio.save_zemax_file, fileio.load_zemax_file),
                ("seq", fileio.save_codev_file, fileio.load_codev_file)):
            path = f"{tmp}/cooke.{fmt}"
            save(CookeTriplet(), path)
            st, pr = load(path).build(device=dev)
            check(st.num_surfaces == static.num_surfaces
                  and st.mat_formulas == static.mat_formulas,
                  f"(d) the {fmt} file's system")
            reset_counts()
            errs = hist_errs(tracer.trace_system(st, pr, *batch), ref)
            got = read_counts()
            print(f"phase j11 ({smi}): (d) the Cooke triplet through "
                  f".{fmt}: launches {json.dumps(got)}; history vs the "
                  f"original's {json.dumps(errs)} (tolerances "
                  f"{json.dumps(tols)})")
            check(not on_card or (got["K7"] == 1 and sum(got.values()) == 1),
                  f"(d) the {fmt} lens launched K7")
            check(all(errs[k] <= tols[k] for k in names),
                  f"(d) the {fmt} lens's history")
    del ref
    seconds["(d) file formats"] = time.perf_counter() - t0

    # the ML wrapper: 3 Adam steps of R1 and R2 under f2 and the on-axis
    # RMS spot, float32 on the card against float64
    t0 = time.perf_counter()

    def fit(dtype_name):
        with precision(dtype_name):
            lens = CookeTriplet()
            lens.build(device=dev)
            prob = OptimizationProblem(lens)
            for k in (1, 2):
                prob.add_variable(lens, "radius", surface_number=k)
            prob.add_operand("f2", target=49.0)
            prob.add_operand("rms_spot_size", target=0.0, input_data={
                "surface_number": -1, "Hx": 0.0, "Hy": 0.7,
                "num_rays": rings, "wavelength": 0.55})
            module = OpticalSystemModule(lens, prob, device=dev)
            reset_counts()
            x, losses = module.fit(steps=J11_FIT_STEPS, lr=J11_FIT_LR)
            return x.double().cpu(), losses, read_counts()

    x32, l32, k32 = fit("float32")
    x64, l64, _ = fit("float64")
    fit_err = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(l32, l64)),
               "x / lr": ((x32 - x64).abs().max() / J11_FIT_LR).item()}
    print(f"phase j11 ({smi}): (d) OpticalSystemModule.fit, "
          f"{J11_FIT_STEPS} Adam steps (lr {J11_FIT_LR}): launches "
          f"{json.dumps(k32)}, losses float32 {l32}, float64 {l64}; "
          f"float32 vs float64 {json.dumps(fit_err)} (tolerance "
          f"{TOL_F64['loss_rel']} each: Adam's steps are ratios of its "
          "moments, which carry the gradients' float32 error, up to "
          f"{TOL_F64['grad_rel']}, through {J11_FIT_STEPS} steps)")
    check(not on_card or k32["K7"] >= J11_FIT_STEPS, "(d) fit launched K7")
    check(fit_err["loss_rel"] <= TOL_F64["loss_rel"]
          and fit_err["x / lr"] <= TOL_F64["loss_rel"], "(d) fit vs f64")
    seconds["(d) ml"] = time.perf_counter() - t0

    # the viewers: the 3-D scene (its rays through K7), a sag grid and the
    # prescription table; draw and draw3D under Agg where matplotlib is
    # installed (the card's machine has none)
    t0 = time.perf_counter()
    lens = CookeTriplet()
    reset_counts()
    scene = OpticViewer3D(lens, device=dev).build_scene()
    _, _, sag, _ = SurfaceSagViewer(lens, device=dev).sag_grid(1)
    with contextlib.redirect_stdout(io.StringIO()) as table:
        rows = lens.info()
    got = read_counts()
    print(f"phase j11 ({smi}): (d) OpticViewer3D.build_scene "
          f"({len(scene.surfaces)} surfaces, {len(scene.rays)} rays), "
          f"SurfaceSagViewer.sag_grid {tuple(sag.shape)}, info ({len(rows)} "
          f"rows, {len(table.getvalue().splitlines())} lines printed): "
          f"launches {json.dumps(got)}")
    check(len(rows) == static.num_surfaces and np.isfinite(sag).all()
          and len(scene.surfaces) == static.num_surfaces - 1
          and all(np.isfinite(r[2]).all() for r in scene.rays),
          "(d) the viewers' scene, sag grid and table")
    check(not on_card or got["K7"] == len(lens.fields.get_field_coords()),
          "(d) the scene's rays launched K7 a field")
    try:
        import matplotlib
    except ImportError:
        print(f"phase j11 ({smi}): (d) draw and draw3D not run: matplotlib "
              "is not installed")
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        reset_counts()
        fig, ax = lens.draw(device=dev)
        fig3, _ = lens.draw3D(device=dev)
        got = read_counts()
        n_lines = len(ax.get_lines())
        plt.close(fig)
        plt.close(fig3)
        print(f"phase j11 ({smi}): (d) draw ({n_lines} lines), draw3D under "
              f"Agg: launches {json.dumps(got)}")
        check(n_lines > 0 and (not on_card or got["K7"] > 0),
              "(d) draw and draw3D")
    seconds["(d) visualization"] = time.perf_counter() - t0

    # an SMF source at 5 mm before a 10 mm plate, traced eagerly (JAX's
    # trace_rays), float32 against float64
    t0 = time.perf_counter()

    def plate():
        lens = Optic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        lens.add_surface(index=1, radius=math.inf, thickness=10.0,
                         is_stop=True)
        lens.add_surface(index=2)
        lens.set_aperture("EPD", 4.0)
        lens.add_wavelength(0.55)
        return lens

    src = SMFSource(mfd_um=10.0, wavelength_um=1.55, position=(0.0, 0.0,
                                                               -5.0))
    reset_counts()
    lens_p = plate()
    h32 = trace_source(lens_p, src, source_rays, device=dev)
    got = read_counts()
    with precision("float64"):
        h64 = trace_source(plate(), src, source_rays, device=dev)
        st64, pr64 = lens_p.build(device=dev)
        start = Rays(*(getattr(h32, k)[0].double() for k in names),
                     torch.full_like(h32.x[0], 1.55, dtype=torch.float64))
        h64_same = tracer.trace_rays(st64, pr64, start)
    src_err = {k: scaled_err(getattr(h32, k)[0].double(),
                             getattr(h64, k)[0]) for k in names}
    trace_err = {k: scaled_err(getattr(h32, k).double(),
                               getattr(h64_same, k)) for k in names}
    power = h32.intensity[-1].double().sum().item()
    print(f"phase j11 ({smi}): (d) SMFSource through trace_source, "
          f"{h32.x.shape[1]} rays: launches {json.dumps(got)}, power "
          f"{power!r}; the source's rays float32 vs float64 "
          f"{json.dumps(src_err)} (tolerance {TOL_J11_SOURCE} of each "
          f"array's scale); the trace vs float64 from the same start "
          f"{json.dumps(trace_err)} (tolerance {TOL_EAGER})")
    check(sum(got.values()) == 0, "(d) trace_source ran eagerly")
    check(h32.x.is_cuda == on_card and abs(power - 1.0) <= 1e-4,
          "(d) the source's rays on the device, power kept")
    check(all(v <= TOL_J11_SOURCE for v in src_err.values())
          and all(v <= TOL_EAGER for v in trace_err.values()),
          "(d) SMFSource float32 vs float64")
    seconds["(d) sources"] = time.perf_counter() - t0
    return seconds


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "optiland_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: optiland_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from optiland_tpu_torch import _build, config, environment, tolerancing
    from optiland_tpu_torch.core import distributions as dist
    from optiland_tpu_torch.materials.catalog import resolve_material
    from optiland_tpu_torch.optimization import operands as design_operands
    from optiland_tpu_torch.optimization import (
        AdamOptimizer,
        GlassExpert,
        LeastSquares,
        OptimizationProblem,
        OptimizerGeneric,
    )
    from optiland_tpu_torch import models as zoo_models
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.mtf import HuygensMTF, SampledMTF, ScalarFFTMTF
    from optiland_tpu_torch.mtf.fft import mtf_slices
    from optiland_tpu_torch.optimization.merits import (
        centroid_rms_from_moments,
        centroid_rms_spot,
    )
    from optiland_tpu_torch.psf import MMDFTPSF, ScalarFFTPSF, ScalarHuygensPSF
    from optiland_tpu_torch.psf import huygens
    from optiland_tpu_torch.system.optic import Optic
    from optiland_tpu_torch.tools import kernel_turns, vpu_peak
    from optiland_tpu_torch.trace import aiming, fused, tracer
    from optiland_tpu_torch.trace.raygen import generate_rays
    from optiland_tpu_torch.wavefront import ZernikeOPD, wavefront_data
    from optiland_tpu_torch.wavefront.core import pupil_grid_coords

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"K1": fused.moments_forward, "K2": fused.moments_backward,
                "K3": fused.raygen_trace_forward,
                "K4": fused.raygen_trace_backward,
                "K5": fused.fused_trace_forward,
                "K6": fused.fused_trace_backward,
                "K7": fused.history_forward,
                "K8": huygens.huygens_sum_forward,
                "T1 fma": vpu_peak.fma_chain,
                "T1 rsqrt": vpu_peak.rsqrt_chain,
                "T1 tan": vpu_peak.tan_chain}

    def reset_counts():
        for f in counters.values():
            f.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in counters.items()}

    def leaves_of(params, names=GRAD_LEAVES):
        leaves = {k: getattr(params, k).detach().clone().requires_grad_(True)
                  for k in names}
        return leaves, params.replace(**leaves)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. build the kernels from the sources in the checkout, with the
    # per-system variants of K1, K3, K5 and K7 for the systems this run
    # drives them on (their codes do not depend on the device or the
    # precision; every K7 launch of this run is on the Cooke triplet)
    statics = {label: lens.build(device="cpu")[0]
               for label, lens in (("bench lens", bench_lens(Optic)),
                                   ("Cooke triplet", CookeTriplet()),
                                   ("vignetted bench lens",
                                    bench_lens(Optic, vignetted=True)),
                                   ("tabulated doublet",
                                    tabulated_doublet(Optic)),
                                   ("system A", coated_cooke(CookeTriplet)),
                                   ("system B", spectrograph(Optic)),
                                   ("system B vignetted",
                                    spectrograph(Optic, vignetted=True)),
                                   ("system C", concave_grating(Optic)),
                                   ("system D", hybrid_achromat(Optic)),
                                   ("system E", curved_metalens(Optic)),
                                   ("system F", phase_mirror(Optic)),
                                   ("system F vignetted",
                                    phase_mirror(Optic, vignetted=True)),
                                   ("system G", anamorphic_singlet(Optic)),
                                   ("system H", xy_freeform_singlet(Optic)),
                                   ("system I",
                                    tilted_freeform_singlet(Optic)),
                                   ("system I vignetted",
                                    tilted_freeform_singlet(Optic, True)),
                                   ("system J", q2d_singlet(Optic)),
                                   ("system J vignetted",
                                    q2d_singlet(Optic, True)),
                                   ("system K", wide_freeform_singlet(Optic)),
                                   ("system L", relay_train(Optic)),
                                   ("WideAngle100FOV",
                                    zoo_models.WideAngle100FOV()),
                                   ("ProjectionLens120FOV",
                                    zoo_models.ProjectionLens120FOV()),
                                   ("UV", zoo_models.UVProjectionLens()),
                                   ("real image height", image_height_cooke(
                                       CookeTriplet, "real_image_height")),
                                   ("paraxial image height",
                                    image_height_cooke(
                                        CookeTriplet,
                                        "paraxial_image_height")))}
    uniform, per_ray = fused.system_defines, fused.history_defines
    variants = (("K1", "moments_fwd", "bench lens", uniform),
                ("K1", "moments_fwd", "Cooke triplet", uniform),
                ("K3", "raygen_trace_fwd", "bench lens", uniform),
                ("K3", "raygen_trace_fwd", "Cooke triplet", uniform),
                ("K5", "fused_trace_fwd", "vignetted bench lens", uniform),
                ("K7", "history_fwd", "Cooke triplet", per_ray),
                # the per-ray variants: K1, K3, K5 with K7's definitions,
                # K2, K4, K6 with the media's codes alone
                ("K1 per-ray", "moments_fwd", "Cooke triplet", per_ray),
                ("K3 per-ray", "raygen_trace_fwd", "Cooke triplet", per_ray),
                ("K5 per-ray", "fused_trace_fwd", "Cooke triplet", per_ray),
                ("K2 per-ray", "moments_bwd", "Cooke triplet",
                 fused.media_defines),
                ("K4 per-ray", "raygen_trace_bwd", "Cooke triplet",
                 fused.media_defines),
                ("K6 per-ray", "fused_trace_bwd", "Cooke triplet",
                 fused.media_defines),
                ("K1 per-ray", "moments_fwd", "tabulated doublet", per_ray),
                ("K2 per-ray", "moments_bwd", "tabulated doublet",
                 fused.media_defines))
    # phases (j3), (j4), (j5) and (j6), the coating, thin-lens, grating,
    # phase and freeform branches, the wide rows and the long record: each
    # kernel of systems A, B (its vignetted twin for K5 and K6) and C, of
    # D, E and F (F's vignetted twin for K5 and K6), of G, H and I (I's
    # vignetted twin for K5 and K6), and of J, K and L (J's vignetted twin
    # for K5 and K6), in each configuration the phases drive; the backward
    # kernels take OTK_INTERACTIONS (`fused.backward_defines`: at one
    # wavelength one library for every such system without a phase sheet,
    # one for every system with one, which adds OTK_PHASE), OTK_FREEFORM
    # with the system's families and its Q-2D terms, OTK_WIDE with its wide
    # rows, or OTK_MAX_SURFACES
    bwd_uniform = (lambda st: fused.backward_defines(st, False))
    bwd_per_ray = (lambda st: fused.backward_defines(st, True))
    every = "K1 K2 K3 K4 K1p K2p K3p K4p K7"
    for label, keys_j3 in (("system A", "K1 K2 K3 K1p K2p K3p K4p K7"),
                           ("system B", every),
                           ("system B vignetted", "K5 K6 K5p K6p"),
                           ("system C", "K1 K2 K3 K4 K1p K2p K3p K4p"),
                           ("system D", every), ("system E", every),
                           ("system F", every),
                           ("system F vignetted", "K5 K6 K5p K6p"),
                           ("system G", every), ("system H", every),
                           ("system I", every),
                           ("system I vignetted", "K5 K6 K5p K6p"),
                           ("system J", every),
                           ("system J vignetted", "K5 K6 K5p K6p"),
                           ("system K", every), ("system L", every),
                           # phase j7: K7 after the aims, K5 after the
                           # telecentric and image-height raygen (their
                           # K6 is the one-wavelength source built once:
                           # no branch definitions)
                           ("WideAngle100FOV", "K7"),
                           ("ProjectionLens120FOV", "K7"),
                           ("UV", "K5 K7"),
                           ("real image height", "K5"),
                           ("paraxial image height", "K5")):
        for key in keys_j3.split():
            k, pr = key[:2], key.endswith("p")
            src = {"K1": "moments_fwd", "K2": "moments_bwd",
                   "K3": "raygen_trace_fwd", "K4": "raygen_trace_bwd",
                   "K5": "fused_trace_fwd", "K6": "fused_trace_bwd",
                   "K7": "history_fwd"}[k]
            of = ((bwd_per_ray if pr else bwd_uniform) if k in ("K2", "K4",
                                                                "K6")
                  else (per_ray if pr or k == "K7" else uniform))
            variants += ((k + (" per-ray" if pr else ""), src, label, of),)
    # phase j8: K7 on the bench lens (the design loop) and on the Cooke
    # triplet with each of GlassExpert's candidates after surface 3, so that
    # nothing builds while the glass search runs
    glass_labels = {g: f"Cooke triplet, {g} after surface 3"
                    for g in GLASSES_J8}
    statics.update({label: cooke_with_glass(CookeTriplet, g).build(
        device="cpu")[0] for g, label in glass_labels.items()})
    variants += tuple(("K7", "history_fwd", label, per_ray) for label in
                      ("bench lens", *glass_labels.values()))
    codes = {(key, label): of(statics[label])
             for key, _, label, of in variants}
    t0 = time.perf_counter()
    built = _build.build_all(tuple((src, codes[key, label])
                                   for key, src, label, _ in variants))
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{k} {v[1]:.1f} s" for k, v in built.items()))
    for key, src, label, _ in variants:
        name = _build.variant_name(src, codes[key, label])
        print(f"{key} variant for the {label}: {name}, built in "
              f"{built[name][1]:.1f} s, {dict(codes[key, label])}")
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 2b. (t) T1: each chain against its plain version, at 1 and 2 steps
    # and at T1's own counts, then the tool's own path, counters at 0 just
    # before and read just after
    x_t1 = vpu_peak.peak_input(dev)
    plains_t1 = {"fma": vpu_peak.fma_plain, "rsqrt": vpu_peak.rsqrt_plain,
                 "tan": vpu_peak.tan_plain}
    t1_err, t1_ulps = {}, {}
    for name, (wrapper, _) in vpu_peak.CHAINS.items():
        cases = [(x_t1, 1), (x_t1, 2)] + ([(x_t1 * 1000.0, 1)]
                                          if name == "tan" else [])
        for i, (x, steps) in enumerate(cases):
            got, ref = wrapper(x, steps), plains_t1[name](x, steps)
            check(bool(torch.isfinite(got).all()) and bool((ref != 0).all()),
                  f"T1 {name} at {steps} steps: finite, not settled")
            t1_ulps[f"{name} {steps}{' x1000' if i == 2 else ''}"] = u = (
                ulp_err(got, ref))
            check(u <= TOL_T1_ULPS, f"T1 {name} at {steps} steps vs plain "
                  f"({u} ulps)")
        got, ref = wrapper(x_t1), plains_t1[name](x_t1)
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"T1 {name}: shape, finite")
        err = max_abs(got, ref)
        t1_err[name] = {"max_abs": err}
        if name == "tan":   # underflowed in both: asserted, not compared
            check(not got.any() and not ref.any(), "T1 tan: all zeros")
            continue
        kind, tol = TOL_T1[name]
        t1_err[name][kind] = rel_err(got, ref)
        check(t1_err[name][kind] <= tol, f"T1 {name} vs plain ({kind} {tol})")
        if name == "rsqrt":
            check(rel_err(got, torch.full_like(got, T1_FIXED_POINT)) <= 1e-6,
                  "T1 rsqrt at its fixed point")
    print(f"T1 vs plain at 1 and 2 steps, ulps: {json.dumps(t1_ulps)} "
          f"(tolerance {TOL_T1_ULPS}); at T1's counts: {json.dumps(t1_err)} "
          f"tolerances {json.dumps(TOL_T1)}, tan all zeros, rsqrt at "
          f"{T1_FIXED_POINT}")
    reset_counts()
    t1_runs = {name: vpu_peak.run(name) for name in vpu_peak.CHAINS}
    t1_launches = read_counts()
    print(f"T1 vpu_peak.run launches: {t1_launches}")
    for name in vpu_peak.CHAINS:
        check(t1_launches[f"T1 {name}"] >= 1, f"vpu_peak.run launched {name}")
    t1_rates = {"fma_per_s": t1_runs["fma"][0],
                "fma_tflops_f32": t1_runs["fma"][0] * 2 / 1e12,
                "rsqrt_per_s": t1_runs["rsqrt"][0],
                "tan_per_s": t1_runs["tan"][0]}
    print(f"T1 rates on {smi}: {json.dumps(t1_rates)}")

    # 3. the lens and the rays
    config.set_precision("float32")
    static, params = bench_lens(Optic).build(device="cuda")
    check(static.num_surfaces == 13 and static.fused_newton_ok,
          "bench lens: 13 surfaces, Newton guard passes")
    check(fused.supports_fused(static) and fused.supports_fused_raygen(static),
          "bench lens inside both fused gates")
    Hx, Hy, Px, Py = bench_rays(dev)
    torch.cuda.synchronize()

    # 4. the forward path, counters at 0 just before and read just after
    reset_counts()
    loss = centroid_rms_spot(static, params, Hx, Hy, Px, Py, WAVELENGTH)
    m_main = fused.spot_moments(static, params, Hx, Hy, Px, Py, WAVELENGTH)
    final = tracer.trace_system_final(static, params, Hx, Hy, Px, Py,
                                      WAVELENGTH)
    fwd_launches = read_counts()
    print(f"forward path launches: {fwd_launches}")
    check(fwd_launches["K1"] >= 1 and fwd_launches["K3"] >= 1,
          "forward path launched K1 and K3")

    # 5. what comes out: finite, shaped, and agreeing with the eager
    # float64 path on the card
    check(torch.isfinite(loss).item(), "loss finite")
    for key, v in final.items():
        check(v.shape == (N_RAYS,) and v.dtype == torch.float32,
              f"{key}: shape and dtype")
        check(bool(torch.isfinite(v).all()), f"{key}: finite")
    i_main = final["intensity"]
    check(bool(((i_main == 0) | (i_main == 1)).all()), "intensity in {0, 1}")
    config.set_precision("float64")
    static64, params64 = bench_lens(Optic).build(device="cuda")
    data64 = tuple(a.double() for a in (Hx, Hy, Px, Py))
    ref_final = tracer.trace_system_final(static64, params64, *data64,
                                          WAVELENGTH)
    ref_m = fused.spot_moments(static64, params64, *data64, WAVELENGTH)
    ref_loss = centroid_rms_spot(static64, params64, *data64, WAVELENGTH)
    check(read_counts() == fwd_launches,
          "float64 reference ran eager (no kernel)")
    ref_m = [float(v) for v in ref_m]
    scale = [ref_m[0], math.sqrt(ref_m[0] * ref_m[3]),
             math.sqrt(ref_m[0] * ref_m[3]), ref_m[3]]
    err64 = {}
    for j in range(4):
        err64[f"m{j}_rel"] = abs(float(m_main[j]) - ref_m[j]) / scale[j]
    err64["loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(
        float(ref_loss))
    same = i_main.double() == ref_final["intensity"]
    err64["intensity_frac"] = 1.0 - same.double().mean().item()
    for key, tol in (("x", "position_mm"), ("y", "position_mm"),
                     ("L", "direction"), ("M", "direction"),
                     ("N", "direction")):
        err64[key] = (final[key].double() - ref_final[key])[same].abs().max(
        ).item()
    print("forward path vs eager float64: " + json.dumps(err64)
          + f" tolerances {json.dumps(TOL_F64)}")
    for j in range(4):
        check(err64[f"m{j}_rel"] <= TOL_F64["moment_rel"], f"m{j} vs f64")
    check(err64["loss_rel"] <= TOL_F64["loss_rel"], "loss vs f64")
    check(err64["intensity_frac"] <= TOL["intensity_frac"], "i vs f64")
    for key in ("x", "y"):
        check(err64[key] <= TOL_F64["position_mm"], f"{key} vs f64")
    for key in ("L", "M", "N"):
        check(err64[key] <= TOL_F64["direction"], f"{key} vs f64")
    del ref_final, final
    config.set_precision("float32")
    free()

    # 6. K1 and K3 against their plain versions on the same inputs
    p, data = fused._prepare(static, params, Hx, Hy, Px, Py, WAVELENGTH)
    k1 = fused.moments_forward(static, *p, data)
    k1_plain = fused._moments_plain(static, *p, data)
    k1_scale = torch.stack([k1_plain[0], (k1_plain[0] * k1_plain[3]).sqrt(),
                            (k1_plain[0] * k1_plain[3]).sqrt(), k1_plain[3]])
    k1_rel = ((k1 - k1_plain).abs() / k1_scale).max().item()
    k1_abs = (k1 - k1_plain).abs().max().item()
    print(f"K1 vs plain: max abs {k1_abs:.6g}, max rel {k1_rel:.6g} "
          f"(tolerance rel {TOL['moment_rel']})")
    check(k1_rel <= TOL["moment_rel"], "K1 vs plain")

    keys = tuple(range(8))
    k3 = fused.raygen_trace_forward(static, *p, data, keys)
    k3_plain = fused._raygen_trace_plain(static, *p, data, keys)
    tol_of = {"x": "position_mm", "y": "position_mm", "z": "position_mm",
              "L": "direction", "M": "direction", "N": "direction",
              "intensity": "intensity", "opd": "opd_mm"}

    def final_errs(label, got, ref, keep, float64=None):
        """The largest error of each of the 8 final arrays `got` against
        `ref` on the rays `keep` (and the share of the others), printed
        beside TOL and checked. With `float64` (LONG_TRACK_SYSTEMS), an
        array past TOL passes if `near_float64` holds for it in `float64()`
        (`final_float64_errs`), which runs only then."""
        errs = {"intensity_frac": 1.0 - keep.float().mean().item()}
        for k, key in enumerate(fused._NAMES):
            errs[key] = (got[k] - ref[k])[keep].abs().max().item()
        print(f"{label} vs plain: " + json.dumps(errs)
              + f" tolerances {json.dumps(TOL)}")
        check(errs["intensity_frac"] <= TOL["intensity_frac"], f"{label} i")
        miss = [key for key, tol in tol_of.items() if errs[key] > TOL[tol]]
        if miss and float64 is not None:
            far = float64()
            print(f"{label}, the arrays past TOL against the plain version "
                  f"run in float64: " + json.dumps({
                      key: {"kernel": far[key][0],
                            "float32_noise": far[key][1],
                            "bound": max(TOL[tol_of[key]],
                                         F64_FACTOR * far[key][1])}
                      for key in miss}))
            miss = [key for key in miss
                    if not near_float64(far[key], TOL[tol_of[key]])]
        for key in tol_of:
            check(key not in miss, f"{label} {key} vs plain")
        return errs

    keep = k3[6] == k3_plain[6]   # rays whose i both versions agree on
    k3_err = final_errs("K3", k3, k3_plain, keep)
    del k3, k3_plain
    free()

    # 7. (a) the training step at full width, params only
    leaves, p_train = leaves_of(params)
    reset_counts()
    loss = centroid_rms_spot(static, p_train, Hx, Hy, Px, Py, WAVELENGTH,
                             diff_inputs=False)
    loss.backward()
    train_launches = read_counts()
    print(f"training step launches: {train_launches}")
    check(train_launches["K1"] >= 1 and train_launches["K2"] >= 1,
          "training step launched K1 and K2")
    for k, v in leaves.items():
        check(bool(torch.isfinite(v.grad).all()) and bool(v.grad.any()),
              f"{k} gradient finite and nonzero")
    config.set_precision("float64")
    leaves64, p64 = leaves_of(params64)
    centroid_rms_spot(static64, p64, *data64, WAVELENGTH).backward()
    check(read_counts() == train_launches, "float64 gradient ran eager")
    grad_err = {k: rel_err(leaves[k].grad, leaves64[k].grad)
                for k in GRAD_LEAVES}
    print("training gradients vs eager float64 autograd, relative to each "
          f"leaf's largest entry: {json.dumps(grad_err)} tolerance "
          f"{TOL_F64['grad_rel']} (float32 against float64, capped Newton)")
    for k, v in grad_err.items():
        check(v <= TOL_F64["grad_rel"], f"{k} gradient vs f64")
    del leaves64, p64
    config.set_precision("float32")
    free()

    # 8. (b) the input cotangents through the K1/K2 seam
    leaves_b, p_b = leaves_of(params)
    hy = Hy.clone().requires_grad_(True)
    wrt = list(leaves_b.values()) + [hy]
    g_on = torch.autograd.grad(centroid_rms_spot(
        static, p_b, Hx, hy, Px, Py, WAVELENGTH, diff_inputs=True), wrt)
    g_off = torch.autograd.grad(centroid_rms_spot(
        static, p_b, Hx, hy, Px, Py, WAVELENGTH, diff_inputs=False), wrt)
    check(all(torch.equal(a, b) for a, b in zip(g_on[:-1], g_off[:-1])),
          "diff_inputs=False: parameter gradients bitwise unchanged")
    check(not g_off[-1].any(), "diff_inputs=False: zero Hy cotangents")
    check(bool(torch.isfinite(g_on[-1]).all()) and bool(g_on[-1].any()),
          "diff_inputs=True: finite, nonzero Hy cotangents")
    m_leaf = fused.moments_forward(static, *p, data).requires_grad_(True)
    c_loss, = torch.autograd.grad(centroid_rms_from_moments(*m_leaf.unbind()),
                                  m_leaf)
    k2_plain = fused._moments_bwd_plain(static, *p, data, c_loss, True)
    hy_err = rel_err(g_on[-1], k2_plain[2][1], keep)
    print(f"Hy cotangents (diff_inputs=True) vs plain: {hy_err:.6g} of the "
          f"largest (tolerance {TOL['ray_grad_rel']})")
    check(hy_err <= TOL["ray_grad_rel"], "Hy cotangents vs plain")
    del g_on, g_off, hy
    free()

    # 9. (c) the backward of trace_system_final: K3, K4
    leaves_c, p_c = leaves_of(params)
    reset_counts()
    out = tracer.trace_system_final(static, p_c, Hx, Hy, Px, Py, WAVELENGTH)
    (out["x"] ** 2 + out["y"] ** 2 + out["opd"]).sum().backward()
    final_launches = read_counts()
    print(f"trace_system_final + backward launches: {final_launches}")
    check(final_launches["K3"] >= 1 and final_launches["K4"] >= 1,
          "trace_system_final backward launched K3 and K4")
    for k, v in leaves_c.items():
        check(bool(torch.isfinite(v.grad).all()) and bool(v.grad.any()),
              f"{k} gradient of sum(x^2 + y^2 + opd) finite and nonzero")
    k4_keys = (0, 1, 7)
    k4_seeds = (2.0 * out["x"].detach(), 2.0 * out["y"].detach(),
                torch.ones_like(Hy))
    del out, leaves_c, p_c
    free()

    # 10. (d) the caller-ray path: a vignetted field, K5 and K6
    static_v, params_v = bench_lens(Optic, vignetted=True).build(device="cuda")
    check(static_v.has_vignetting and fused.supports_fused(static_v)
          and not fused.supports_fused_raygen(static_v),
          "vignetted bench lens: caller-ray path")
    leaves_d, p_d = leaves_of(params_v)
    reset_counts()
    out_v = tracer.trace_system_final(static_v, p_d, Hx, Hy, Px, Py,
                                      WAVELENGTH)
    (out_v["x"] ** 2 + out_v["y"] ** 2 + out_v["opd"]).sum().backward()
    caller_launches = read_counts()
    print(f"vignetted trace_system_final + backward launches: "
          f"{caller_launches}")
    check(caller_launches["K5"] >= 1 and caller_launches["K6"] >= 1,
          "vignetted trace_system_final launched K5 and K6")
    for key, v in out_v.items():
        check(v.shape == (N_RAYS,) and bool(torch.isfinite(v).all()),
              f"vignetted {key}: shape, finite")
    for k, v in leaves_d.items():
        check(bool(torch.isfinite(v.grad).all()) and bool(v.grad.any()),
              f"vignetted {k} gradient finite and nonzero")
    config.set_precision("float64")
    static_v64, params_v64 = bench_lens(Optic, vignetted=True).build(
        device="cuda")
    ref_v = tracer.trace_system_final(static_v64, params_v64, *data64,
                                      WAVELENGTH)
    check(read_counts() == caller_launches, "float64 reference ran eager")
    same_v = out_v["intensity"].double() == ref_v["intensity"]
    err_v = {"intensity_frac": 1.0 - same_v.double().mean().item()}
    for key in ("x", "y", "L", "M", "N"):
        err_v[key] = (out_v[key].double() - ref_v[key])[same_v].abs().max(
        ).item()
    print("vignetted path vs eager float64: " + json.dumps(err_v))
    check(err_v["intensity_frac"] <= TOL["intensity_frac"], "vignetted i")
    for key in ("x", "y"):
        check(err_v[key] <= TOL_F64["position_mm"], f"vignetted {key}")
    for key in ("L", "M", "N"):
        check(err_v[key] <= TOL_F64["direction"], f"vignetted {key}")
    del out_v, ref_v, leaves_d, p_d, data64
    config.set_precision("float32")
    free()

    # 11. (e) K2, K4, K5, K6 against their plain versions
    k2 = fused.moments_backward(static, *p, data, c_loss, True)
    k2_errs, k2_rays, k2_abs = cotangent_errs(k2, k2_plain, keep)
    check_cotangents("K2", k2_errs, k2_rays)
    k2_again = fused.moments_backward(static, *p, data, c_loss, True)
    check(torch.equal(k2_again[0], k2[0])
          and all(torch.equal(a, b) for a, b in zip(k2_again[1], k2[1])),
          "K2 parameter cotangents bitwise equal over two launches")
    del k2, k2_again, k2_plain
    free()

    k4 = fused.raygen_trace_backward(static, *p, data, k4_keys, k4_seeds)
    k4_plain = fused._raygen_trace_bwd_plain(static, *p, data, k4_keys,
                                             k4_seeds)
    k4_errs, k4_rays, k4_abs = cotangent_errs(k4, k4_plain, keep)
    check_cotangents("K4", k4_errs, k4_rays)
    del k4, k4_plain
    free()

    rays0 = generate_rays(static_v, params_v, Hx, Hy, Px, Py, WAVELENGTH)
    rays8 = tuple(getattr(rays0, k).detach().contiguous()
                  for k in ("x", "y", "z", "L", "M", "N", "i", "opd"))
    del rays0
    n_tab_v, alpha_v = fused._uniform_tables(static_v, params_v, WAVELENGTH)
    p_v = (fused._diff_params(params_v, n_tab_v),
           fused._nondiff_params(params_v, alpha_v))
    k5 = fused.fused_trace_forward(static_v, *p_v, rays8)
    k5_plain = fused._fused_trace_plain(static_v, *p_v, rays8)
    keep_v = k5[6] == k5_plain[6]
    k5_err = final_errs("K5", k5, k5_plain, keep_v)
    del k5, k5_plain
    rng = np.random.default_rng(1)
    k6_seeds = tuple(torch.from_numpy(rng.standard_normal(N_RAYS).astype(
        np.float32)).to(dev) for _ in range(8))
    k6 = fused.fused_trace_backward(static_v, *p_v, rays8, k6_seeds)
    k6_plain = fused._fused_trace_bwd_plain(static_v, *p_v, rays8, k6_seeds)
    k6_errs, k6_rays, k6_abs = cotangent_errs((None, k6[1], k6[0]),
                                              (None, k6_plain[1],
                                               k6_plain[0]), keep_v)
    check_cotangents("K6", k6_errs, k6_rays)
    k6_again = fused.fused_trace_backward(static_v, *p_v, rays8, k6_seeds)
    check(all(torch.equal(a, b) for a, b in zip(k6_again[1], k6[1])),
          "K6 parameter cotangents bitwise equal over two launches")
    del k6, k6_again, k6_plain
    free()

    # 12. (f) the trainer: Adam steps of the training step
    leaves_f, p_f = leaves_of(params, TRAIN_LEAVES)
    start = {k: v.detach().clone() for k, v in leaves_f.items()}
    opt = torch.optim.Adam(list(leaves_f.values()), lr=ADAM_LR)

    def train_step():
        opt.zero_grad()
        step_loss = centroid_rms_spot(static, p_f, Hx, Hy, Px, Py,
                                      WAVELENGTH, diff_inputs=False)
        step_loss.backward()
        opt.step()
        return step_loss

    losses = []
    for _ in range(ADAM_STEPS):
        reset_counts()
        losses.append(train_step().item())
        step_launches = read_counts()
        check(step_launches["K1"] == 1 and step_launches["K2"] == 1,
              f"Adam step launched K1 and K2 once: {step_launches}")
    moved = {k: (v.detach() - start[k])[torch.isfinite(start[k])].abs().max(
    ).item() for k, v in leaves_f.items()}
    print(f"{ADAM_STEPS} Adam steps (lr {ADAM_LR}): losses {losses}, "
          f"largest parameter change {json.dumps(moved)}")
    check(all(math.isfinite(v) for v in losses), "Adam losses finite")
    check(all(v > 0 for v in moved.values()), "Adam moved every leaf")

    # 13. the flagship: the Cooke triplet on the card in float32 and
    # float64, and `_make_inputs`'s 1,999,998-ray batch
    static_c, params_c = CookeTriplet().build(device="cuda")
    check(static_c.num_surfaces == 8 and any(static_c.has_absorption),
          "Cooke triplet: 8 surfaces, absorbing glasses")
    check(fused.supports_fused(static_c), "Cooke triplet inside the gate")
    fb = flagship_inputs(params_c, dev)
    n_c, S_c = fb[0].shape[0], static_c.num_surfaces
    check(n_c == 1_999_998, "flagship batch of 1,999,998 rays")
    config.set_precision("float64")
    static_c64, params_c64 = CookeTriplet().build(device="cuda")
    config.set_precision("float32")
    fb64 = tuple(a.double() for a in fb)
    hist_tol = {"x": "position_mm", "y": "position_mm", "z": "position_mm",
                "L": "direction", "M": "direction", "N": "direction",
                "intensity": "intensity", "opd": "opd_mm"}

    def history_errs(got, ref):
        """Largest |got - ref| per history array over all S rows, on the
        rays both keep alive at every surface, and the share of the rest."""
        keep_h = ((got[6] > 0) == (ref[6] > 0)).all(dim=0)
        errs = {"intensity_frac": 1.0 - keep_h.double().mean().item()}
        for k, key in enumerate(fused._NAMES):
            errs[key] = (got[k].double() - ref[k].double())[:, keep_h].abs(
            ).max().item()
        return errs

    def as_tuple(h):
        return (h.x, h.y, h.z, h.L, h.M, h.N, h.intensity, h.opd)

    # 14. (h) trace_system at per-ray wavelengths: K7
    reset_counts()
    hist = tracer.trace_system(static_c, params_c, *fb)
    hist_launches = read_counts()
    print(f"flagship trace_system launches: {hist_launches}")
    check(hist_launches["K7"] >= 1, "flagship trace_system launched K7")
    for key, v in zip(fused._NAMES, as_tuple(hist)):
        check(v.shape == (S_c, n_c) and v.dtype == torch.float32,
              f"history {key}: shape and dtype")
        check(bool(torch.isfinite(v).all()), f"history {key}: finite")
    i_img = hist.intensity[-1]
    lit = i_img[i_img > 0]
    print(f"flagship image intensities: {lit.numel()} of {n_c} rays lit, "
          f"min {lit.min().item():.6g} max {lit.max().item():.6g} "
          "(absorbing glass)")
    check(lit.numel() > n_c // 2 and lit.max().item() < 1.0,
          "most rays reach the image, attenuated")
    ref_h = tracer.trace_system(static_c64, params_c64, *fb64)
    check(read_counts() == hist_launches, "float64 history ran eager")
    err_h = history_errs(as_tuple(hist), as_tuple(ref_h))
    print("flagship history vs eager float64, all rows: " + json.dumps(err_h)
          + f" tolerances {json.dumps(TOL_F64)}")
    check(err_h["intensity_frac"] <= TOL["intensity_frac"], "history i set")
    for key, tol in hist_tol.items():
        check(err_h[key] <= TOL_F64[tol], f"history {key} vs f64")
    del ref_h, hist
    free()

    rays0_c = generate_rays(static_c, params_c, *fb)
    rays9 = tuple(getattr(rays0_c, k).detach().contiguous()
                  for k in fused._RAY_KEYS)
    del rays0_c
    p7 = (fused._diff_params(params_c), fused._nondiff_params(params_c))
    k7_err = history_errs(fused.history_forward(static_c, *p7, rays9),
                          fused._history_plain(static_c, *p7, rays9))
    print("K7 vs plain, all rows: " + json.dumps(k7_err)
          + f" tolerances {json.dumps(TOL)}")
    check(k7_err["intensity_frac"] <= TOL["intensity_frac"], "K7 i set")
    for key, tol in hist_tol.items():
        check(k7_err[key] <= TOL[tol], f"K7 {key} vs plain")
    k7_abs = max(v for k, v in k7_err.items() if k != "intensity_frac")
    free()

    # 15. (i) the flagship training step over every parameter leaf
    names_c = [f.name for f in dataclasses.fields(params_c)
               if getattr(params_c, f.name) is not None
               and getattr(params_c, f.name).numel()]
    leaves_h, p_h = leaves_of(params_c, names_c)
    reset_counts()
    loss_h = flagship_merit(tracer.trace_system(static_c, p_h, *fb))
    loss_h.backward()
    flag_launches = read_counts()
    print(f"flagship training step launches: {flag_launches}")
    check(flag_launches["K7"] >= 1, "flagship step launched K7")
    for k, v in leaves_h.items():
        check(v.grad is None or bool(torch.isfinite(v.grad).all()),
              f"flagship {k} gradient finite")
    config.set_precision("float64")
    leaves64_h, p64_h = leaves_of(params_c64, names_c)
    loss64_h = flagship_merit(tracer.trace_system(static_c64, p64_h, *fb64))
    loss64_h.backward()
    check(read_counts() == flag_launches, "float64 flagship step ran eager")
    config.set_precision("float32")
    # the same merit through the eager float32 trace (no kernel): the
    # rounding float32 itself leaves in each leaf's gradient
    leaves_e, p_e = leaves_of(params_c, names_c)
    flagship_merit(tracer.trace_rays(static_c, p_e, generate_rays(
        static_c, p_e, *fb))).backward()
    check(read_counts() == flag_launches, "float32 eager reference ran eager")

    def grad_of(leaves, k):
        g = leaves[k].grad
        return torch.zeros_like(leaves[k]) if g is None else g

    flag_err = {"loss_rel": abs(loss_h.item() - loss64_h.item())
                / abs(loss64_h.item())}
    eager_err = {}
    for k in names_c:
        g32, g64 = grad_of(leaves_h, k), grad_of(leaves64_h, k)
        if g64.abs().max() > 0 or g32.abs().max() > 0:
            flag_err[k] = rel_err(g32, g64)
            eager_err[k] = rel_err(grad_of(leaves_e, k), g64)
    print("flagship merit and gradients vs eager float64 autograd, relative "
          f"to each leaf's largest entry: {json.dumps(flag_err)}; the eager "
          f"float32 path's own: {json.dumps(eager_err)}; tolerances loss_rel "
          f"{TOL_F64['loss_rel']}, per leaf the larger of grad_rel "
          f"{TOL_F64['grad_rel']} and {GRAD_NOISE_FACTOR}x the eager "
          "float32 path's error")
    check(flag_err.pop("loss_rel") <= TOL_F64["loss_rel"], "flagship loss")
    check(flag_err and all(
        v <= max(TOL_F64["grad_rel"], GRAD_NOISE_FACTOR * eager_err[k])
        for k, v in flag_err.items()), "flagship gradients vs f64")
    del leaves64_h, p64_h, loss64_h, leaves_h, p_h, loss_h, leaves_e, p_e
    free()

    leaves_a, p_a = leaves_of(params_c, names_c)
    start_a = {k: v.detach().clone() for k, v in leaves_a.items()}
    opt_h = torch.optim.Adam(list(leaves_a.values()), lr=ADAM_LR)

    def flagship_step():
        opt_h.zero_grad()
        step_loss = flagship_merit(tracer.trace_system(static_c, p_a, *fb))
        step_loss.backward()
        opt_h.step()
        return step_loss

    losses_h = []
    for _ in range(ADAM_STEPS):
        reset_counts()
        losses_h.append(flagship_step().item())
        c_step = read_counts()
        check(c_step["K7"] == 1 and sum(c_step.values()) == 1,
              f"flagship Adam step launched K7 once: {c_step}")
        check(all(v.grad is None or bool(torch.isfinite(v.grad).all())
                  for v in leaves_a.values()), "flagship Adam grads finite")
    moved_h = {k: (v.detach() - start_a[k])[torch.isfinite(start_a[k])].abs(
    ).max().item() for k, v in leaves_a.items()
        if torch.isfinite(start_a[k]).any()}
    print(f"flagship {ADAM_STEPS} Adam steps over {len(leaves_a)} leaves "
          f"(lr {ADAM_LR}): losses {losses_h}, largest change "
          f"{json.dumps(moved_h)}")
    check(all(math.isfinite(v) for v in losses_h), "flagship losses finite")
    check(any(v > 0 for v in moved_h.values()), "Adam moved some leaf")
    free()

    # 16. (j) `dryrun_multichip`'s second phase: centroid_rms_spot at the
    # primary wavelength on the Cooke triplet, K1 and K2 with absorption
    spot_names = ("cv", "conic", "thickness", "mat_coeffs")
    leaves_j, p_j = leaves_of(params_c, spot_names)
    reset_counts()
    loss_j = centroid_rms_spot(static_c, p_j, *fb[:4], FLAGSHIP_WAVELENGTH,
                               diff_inputs=False)
    loss_j.backward()
    spot_launches = read_counts()
    print(f"Cooke centroid_rms_spot + backward launches: {spot_launches}")
    check(spot_launches["K1"] == 1 and spot_launches["K2"] == 1,
          "Cooke centroid_rms_spot launched K1 and K2 once each")
    config.set_precision("float64")
    leaves64_j, p64_j = leaves_of(params_c64, spot_names)
    loss64_j = centroid_rms_spot(static_c64, p64_j, *fb64[:4],
                                 FLAGSHIP_WAVELENGTH)
    loss64_j.backward()
    check(read_counts() == spot_launches, "float64 spot merit ran eager")
    config.set_precision("float32")
    spot_err = {"loss_rel": abs(loss_j.item() - loss64_j.item())
                / abs(loss64_j.item())}
    spot_err.update({k: rel_err(leaves_j[k].grad, leaves64_j[k].grad)
                     for k in spot_names})
    print("Cooke centroid_rms_spot vs eager float64: "
          + json.dumps(spot_err) + " tolerances loss_rel "
          f"{TOL_F64['loss_rel']} grad_rel {TOL_F64['grad_rel']}")
    check(spot_err.pop("loss_rel") <= TOL_F64["loss_rel"], "spot loss")
    for k, v in spot_err.items():
        check(v <= TOL_F64["grad_rel"], f"Cooke spot {k} gradient vs f64")
    del leaves64_j, p64_j, loss64_j
    pc, data_c = fused._prepare(static_c, params_c, *fb[:4],
                                FLAGSHIP_WAVELENGTH)
    k1c = fused.moments_forward(static_c, *pc, data_c)
    k1c_plain = fused._moments_plain(static_c, *pc, data_c)
    k1c_scale = torch.stack([k1c_plain[0], (k1c_plain[0] * k1c_plain[3]).sqrt(),
                             (k1c_plain[0] * k1c_plain[3]).sqrt(),
                             k1c_plain[3]])
    k1c_rel = ((k1c - k1c_plain).abs() / k1c_scale).max().item()
    print(f"K1 (Cooke) vs plain: max rel {k1c_rel:.6g} "
          f"(tolerance {TOL['moment_rel']})")
    check(k1c_rel <= TOL["moment_rel"], "K1 (Cooke) vs plain")
    mc_leaf = k1c.detach().requires_grad_(True)
    c_cooke, = torch.autograd.grad(
        centroid_rms_from_moments(*mc_leaf.unbind()), mc_leaf)
    # K3's Cooke variant: the rays both versions leave lit (absorption
    # only scales i), and every final array on them
    k3c = fused.raygen_trace_forward(static_c, *pc, data_c, keys)
    k3c_plain = fused._raygen_trace_plain(static_c, *pc, data_c, keys)
    keep_cj = (k3c[6] > 0) == (k3c_plain[6] > 0)
    final_errs("K3 (Cooke)", k3c, k3c_plain, keep_cj)
    del k3c, k3c_plain
    k2c = fused.moments_backward(static_c, *pc, data_c, c_cooke, True)
    k2c_plain = fused._moments_bwd_plain(static_c, *pc, data_c, c_cooke, True)
    k2c_errs, k2c_rays, _ = cotangent_errs(k2c, k2c_plain, keep_cj)
    check_cotangents("K2 (Cooke)", k2c_errs, k2c_rays)
    del k2c, k2c_plain, leaves_j, p_j
    free()

    # 16b. (j2) the polychromatic merit: centroid_rms_spot at the flagship
    # batch's own per-ray wavelengths (JAX's uniform_w=False) reaches the
    # per-ray K1 and K2, with the adjoint of dispersion and absorption. The
    # leaves are those the kernels differentiate: all but the vignetting
    # factors and the extinction tables, which the fused path does not
    # read or (as in JAX) differentiate, and which the eager path does
    names_p = [k for k in names_c if k not in ("vx", "vy", "k_wl", "k_val")]
    leaves_p, p_p = leaves_of(params_c, names_p)
    reset_counts()
    loss_p = centroid_rms_spot(static_c, p_p, *fb, diff_inputs=False)
    loss_p.backward()
    poly_launches = read_counts()
    print(f"polychromatic centroid_rms_spot + backward launches: "
          f"{poly_launches}")
    check(poly_launches["K1"] == 1 and poly_launches["K2"] == 1
          and sum(poly_launches.values()) == 2,
          "polychromatic merit launched the per-ray K1 and K2 once each")
    config.set_precision("float64")
    leaves64_p, p64_p = leaves_of(params_c64, names_p)
    loss64_p = centroid_rms_spot(static_c64, p64_p, *fb64)
    loss64_p.backward()
    check(read_counts() == poly_launches, "float64 polychromatic merit eager")
    config.set_precision("float32")
    leaves_pe, p_pe = leaves_of(params_c, names_p)
    h_pe = tracer.trace_rays(static_c, p_pe, generate_rays(static_c, p_pe,
                                                           *fb))
    x_e, y_e, i_e = h_pe.x[-1], h_pe.y[-1], h_pe.intensity[-1]
    centroid_rms_from_moments(i_e.sum(), (x_e * i_e).sum(), (y_e * i_e).sum(),
                              ((x_e * x_e + y_e * y_e) * i_e).sum()).backward()
    check(read_counts() == poly_launches, "float32 eager reference eager")
    del h_pe, x_e, y_e, i_e
    poly_err = {"loss_rel": abs(loss_p.item() - loss64_p.item())
                / abs(loss64_p.item())}
    poly_eager = {}
    for k in names_p:
        g32, g64 = grad_of(leaves_p, k), grad_of(leaves64_p, k)
        if g64.abs().max() > 0 or g32.abs().max() > 0:
            poly_err[k] = rel_err(g32, g64)
            poly_eager[k] = rel_err(grad_of(leaves_pe, k), g64)
    print("polychromatic centroid_rms_spot and gradients vs eager float64 "
          f"autograd, relative to each leaf's largest entry: "
          f"{json.dumps(poly_err)}; the eager float32 path's own: "
          f"{json.dumps(poly_eager)}; tolerances loss_rel "
          f"{TOL_F64['loss_rel']}, per leaf the larger of grad_rel "
          f"{TOL_F64['grad_rel']} and {GRAD_NOISE_FACTOR}x the eager "
          "float32 path's error")
    check(poly_err.pop("loss_rel") <= TOL_F64["loss_rel"], "polychromatic loss")
    check("mat_coeffs" in poly_err and "cv" in poly_err,
          "the glasses' and curvatures' gradients reached")
    check(all(v <= max(TOL_F64["grad_rel"], GRAD_NOISE_FACTOR * poly_eager[k])
              for k, v in poly_err.items()), "polychromatic gradients vs f64")
    del leaves64_p, p64_p, loss64_p, leaves_pe, p_pe, leaves_p, p_p, loss_p
    free()

    leaves_q, p_q = leaves_of(params_c, names_p)
    start_q = {k: v.detach().clone() for k, v in leaves_q.items()}
    opt_q = torch.optim.Adam(list(leaves_q.values()), lr=ADAM_LR)

    def poly_step():
        opt_q.zero_grad()
        step_loss = centroid_rms_spot(static_c, p_q, *fb, diff_inputs=False)
        step_loss.backward()
        opt_q.step()
        return step_loss

    losses_q = []
    for _ in range(ADAM_STEPS):
        reset_counts()
        losses_q.append(poly_step().item())
        c_step = read_counts()
        check(c_step["K1"] == 1 and c_step["K2"] == 1
              and sum(c_step.values()) == 2,
              f"polychromatic Adam step launched K1 and K2 once: {c_step}")
    moved_q = {k: (v.detach() - start_q[k])[torch.isfinite(start_q[k])].abs(
    ).max().item() for k, v in leaves_q.items()
        if torch.isfinite(start_q[k]).any()}
    print(f"polychromatic {ADAM_STEPS} Adam steps over {len(leaves_q)} leaves "
          f"(lr {ADAM_LR}): losses {losses_q}, largest change "
          f"{json.dumps(moved_q)}")
    check(all(math.isfinite(v) for v in losses_q), "polychromatic losses")
    check(any(v > 0 for v in moved_q.values()), "Adam moved some leaf")

    # each per-ray kernel against its plain version on the flagship batch:
    # K1 and K2 on the merit's inputs, K3 and K4 through
    # trace_system_final at the per-ray w and its backward, K5 and K6
    # through trace_final of the rays generate_rays makes at that w
    pw, data_w = fused._prepare(static_c, params_c, *fb)
    check(len(data_w) == 5, "per-ray data: Hx, Hy, Px, Py, w")

    def moment_rel(got, ref):
        scale = torch.stack([ref[0], (ref[0] * ref[3]).sqrt(),
                             (ref[0] * ref[3]).sqrt(), ref[3]])
        return ((got - ref).abs() / scale).max().item()

    k1w = fused.moments_forward(static_c, *pw, data_w)
    k1w_rel = moment_rel(k1w, fused._moments_plain(static_c, *pw, data_w))
    k1w_abs = (k1w - fused._moments_plain(static_c, *pw, data_w)).abs().max(
    ).item()
    mw_leaf = k1w.detach().requires_grad_(True)
    c_poly, = torch.autograd.grad(centroid_rms_from_moments(*mw_leaf.unbind()),
                                  mw_leaf)
    leaves_3, p_3 = leaves_of(params_c)
    reset_counts()
    out_w = tracer.trace_system_final(static_c, p_3, *fb)
    (out_w["x"] ** 2 + out_w["y"] ** 2 + out_w["opd"]).sum().backward()
    final_w_launches = read_counts()
    check(final_w_launches["K3"] == 1 and final_w_launches["K4"] == 1
          and sum(final_w_launches.values()) == 2,
          f"per-ray trace_system_final launched K3 and K4: {final_w_launches}")
    k3w = tuple(out_w[k].detach() for k in fused._NAMES)
    k3w_plain = fused._raygen_trace_plain(static_c, *pw, data_w, keys)
    keep_w = (k3w[6] > 0) == (k3w_plain[6] > 0)
    k3w_err = final_errs("K3 per-ray", k3w, k3w_plain, keep_w)
    k4w_seeds = (2.0 * k3w[0], 2.0 * k3w[1], torch.ones_like(k3w[0]))
    del out_w, leaves_3, p_3, k3w, k3w_plain
    errs_w = {"K1": k1w_rel}
    k2w = fused.moments_backward(static_c, *pw, data_w, c_poly, True)
    k2w_errs, k2w_rays, k2w_abs = cotangent_errs(
        k2w, fused._moments_bwd_plain(static_c, *pw, data_w, c_poly, True),
        keep_w)
    check_cotangents("K2 per-ray", k2w_errs, k2w_rays)
    check("mat_coeffs" in k2w_errs and "ray4" in k2w_rays,
          "K2 per-ray: mat_coeffs' and w's cotangents")
    k2w_again = fused.moments_backward(static_c, *pw, data_w, c_poly, True)
    check(all(torch.equal(a, b) for a, b in zip(k2w_again[1], k2w[1])),
          "K2 per-ray parameter cotangents bitwise over two launches")
    del k2w, k2w_again
    k4w_errs, k4w_rays, k4w_abs = cotangent_errs(
        fused.raygen_trace_backward(static_c, *pw, data_w, k4_keys, k4w_seeds),
        fused._raygen_trace_bwd_plain(static_c, *pw, data_w, k4_keys,
                                      k4w_seeds), keep_w)
    check_cotangents("K4 per-ray", k4w_errs, k4w_rays)
    free()
    rays0_w = generate_rays(static_c, params_c, *fb)
    rays9_w = tuple(getattr(rays0_w, k).detach().contiguous()
                    for k in fused._RAY_KEYS)
    leaves_5, p_5 = leaves_of(params_c)
    reset_counts()
    out5 = fused.trace_final(static_c, p_5, rays0_w)
    (out5["x"] ** 2 + out5["y"] ** 2 + out5["opd"]).sum().backward()
    caller_w_launches = read_counts()
    check(caller_w_launches["K5"] == 1 and caller_w_launches["K6"] == 1
          and sum(caller_w_launches.values()) == 2,
          f"per-ray trace_final launched K5 and K6: {caller_w_launches}")
    p5 = (fused._diff_params(params_c), fused._nondiff_params(params_c))
    k5w = tuple(out5[k].detach() for k in fused._NAMES)
    k5w_plain = fused._fused_trace_plain(static_c, *p5, rays9_w)
    keep5 = (k5w[6] > 0) == (k5w_plain[6] > 0)
    k5w_err = final_errs("K5 per-ray", k5w, k5w_plain, keep5)
    del out5, leaves_5, p_5, k5w, k5w_plain, rays0_w
    rng_w = np.random.default_rng(3)
    k6w_seeds = tuple(torch.from_numpy(rng_w.standard_normal(n_c).astype(
        np.float32)).to(dev) for _ in range(8))
    k6w = fused.fused_trace_backward(static_c, *p5, rays9_w, k6w_seeds)
    k6w_plain = fused._fused_trace_bwd_plain(static_c, *p5, rays9_w, k6w_seeds)
    k6w_errs, k6w_rays, k6w_abs = cotangent_errs(
        (None, k6w[1], k6w[0]), (None, k6w_plain[1], k6w_plain[0]), keep5)
    check_cotangents("K6 per-ray", k6w_errs, k6w_rays)
    check("ray8" in k6w_rays, "K6 per-ray: w's cotangent")
    del k6w, k6w_plain
    free()

    # a tabulated glass on the card: the per-ray K1 and K2 on the doublet of
    # a tabulated (formula 10) and an Abbe glass, at wavelengths below, in
    # and above the tabulated table (its cotangent a per-ray scatter on the
    # segments, summed in a fixed order by the wrapper)
    static_d, params_d = tabulated_doublet(Optic).build(device="cuda")
    rng_d = np.random.default_rng(4)
    r_d = np.sqrt(rng_d.uniform(size=n_c))
    th_d = rng_d.uniform(0, 2 * np.pi, n_c)
    data_d = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        np.zeros(n_c), rng_d.uniform(-1, 1, n_c), r_d * np.cos(th_d),
        r_d * np.sin(th_d), rng_d.choice((0.38, 0.45, 0.48, 0.55, 0.65, 0.75),
                                          n_c)))
    pd, data_dw = fused._prepare(static_d, params_d, *data_d)
    reset_counts()
    k1d = fused.moments_forward(static_d, *pd, data_dw)
    k1d_plain = fused._moments_plain(static_d, *pd, data_dw)
    md_leaf = k1d.detach().requires_grad_(True)
    c_d, = torch.autograd.grad(centroid_rms_from_moments(*md_leaf.unbind()),
                               md_leaf)
    k2d = fused.moments_backward(static_d, *pd, data_dw, c_d, True)
    tab_launches = read_counts()
    check(tab_launches["K1"] == 1 and tab_launches["K2"] == 1,
          f"tabulated doublet: per-ray K1 and K2 launched: {tab_launches}")
    keep_d = fused._raygen_trace_plain(static_d, *pd, data_dw, (6,))[0] > 0
    k2d_errs, k2d_rays, _ = cotangent_errs(
        k2d, fused._moments_bwd_plain(static_d, *pd, data_dw, c_d, True),
        keep_d)
    errs_w["K1 tabulated doublet"] = moment_rel(k1d, k1d_plain)
    print(f"per-ray K1 vs plain (moment_rel): {json.dumps(errs_w)} "
          f"(tolerance {TOL['moment_rel']})")
    for k, v in errs_w.items():
        check(v <= TOL["moment_rel"], f"{k} per-ray vs plain")
    check_cotangents("K2 per-ray (tabulated doublet)", k2d_errs, k2d_rays)
    check("mat_coeffs" in k2d_errs, "tabulated doublet: mat_coeffs cotangent")
    k2d_again = fused.moments_backward(static_d, *pd, data_dw, c_d, True)
    check(torch.equal(k2d_again[1][6], k2d[1][6]),
          "tabulated glass cotangents bitwise over two launches")
    k2d_ms = time_ms(lambda: fused.moments_backward(static_d, *pd, data_dw,
                                                    c_d, False))
    del k1d, k1d_plain, k2d, k2d_again
    free()

    # 16c. (j3) the coating, thin-lens and grating branches at the
    # flagship's 1,999,998 rays (3 fields x 3 wavelengths,
    # `flagship_inputs`), float32: system A, the coated Cooke triplet; B,
    # the thin-lens grating spectrograph (object heights; its vignetted
    # twin leaves in-kernel raygen for K5 and K6); C, the concave
    # reflective grating. Each path is driven through the user's entry
    # points with the counters at 0 just before and read just after; each
    # kernel is held against its plain version on the same inputs at TOL,
    # at one wavelength (0.55 um) and at the batch's per-ray wavelengths;
    # A's and B's polychromatic merits against the eager float64 path at
    # TOL_F64 (each leaf also within GRAD_NOISE_FACTOR of the eager float32
    # path's own error), then Adam steps; C's too.
    # phases j3-j6 share these helpers and records
    # key -> (wrapper call, plain ms, note, bytes, ops, launches, err)
    j3 = {}
    j3_steps = {}
    # each system's branch leaf: its cotangent must reach K2, K4 and K6
    branch_leaf = {"A": "coating_params", "B": "grating", "C": "grating",
                   "D": "phase_params", "E": "phase_params",
                   "F": "phase_params", "G": "coeffs", "H": "coeffs",
                   "I": "coeffs", "J": "coeffs", "K": "coeffs", "L": "coeffs"}

    def j3_build(make):
        """`make()`'s system on the card in float32 and its flagship batch,
        and its float64 twin."""
        st, pr = make().build(device="cuda")
        check(fused.supports_fused(st) and fused.backward_defines(st, False),
              f"{st.num_surfaces}-surface system of phase j3: inside the "
              "gate, with the definitions of its branches or its length")
        config.set_precision("float64")
        twin64 = make().build(device="cuda")
        config.set_precision("float32")
        return st, pr, flagship_inputs(pr, dev), twin64

    def j3_merit(label, st, pr, fbx, twin64):
        """The polychromatic merit's training step (per-ray K1, K2) and the
        monochromatic one at 0.55 um (K1, K2), each launching its two
        kernels once; the polychromatic loss and gradients against the
        eager float64 path of the twin `twin64`. Returns the leaves'
        names."""
        names = [f.name for f in dataclasses.fields(pr)
                 if getattr(pr, f.name) is not None
                 and getattr(pr, f.name).numel()
                 and f.name not in ("vx", "vy", "k_wl", "k_val")]
        for wl in (None, FLAGSHIP_WAVELENGTH):
            leaves, p_m = leaves_of(pr, names)
            reset_counts()
            args = fbx if wl is None else fbx[:4] + (wl,)
            loss = centroid_rms_spot(st, p_m, *args, diff_inputs=False)
            loss.backward()
            got = read_counts()
            check(got["K1"] == 1 and got["K2"] == 1
                  and sum(got.values()) == 2,
                  f"{label} merit at {wl or 'per-ray w'} launched K1, K2: "
                  f"{got}")
            check(all(v.grad is None or bool(torch.isfinite(v.grad).all())
                      for v in leaves.values()), f"{label} gradients finite")
            j3_launch[label, wl] = got
        st64, pr64 = twin64
        leaves64, p64 = leaves_of(pr64, names)
        loss64 = centroid_rms_spot(st64, p64, *(a.double() for a in fbx))
        loss64.backward()
        leaves_e, p_e = leaves_of(pr, names)
        h_e = tracer.trace_rays(st, p_e, generate_rays(st, p_e, *fbx))
        x_e, y_e, i_e = h_e.x[-1], h_e.y[-1], h_e.intensity[-1]
        centroid_rms_from_moments(
            i_e.sum(), (x_e * i_e).sum(), (y_e * i_e).sum(),
            ((x_e * x_e + y_e * y_e) * i_e).sum()).backward()
        leaves, p_m = leaves_of(pr, names)
        loss = centroid_rms_spot(st, p_m, *fbx, diff_inputs=False)
        loss.backward()
        err = {"loss_rel": abs(loss.item() - loss64.item())
               / abs(loss64.item())}
        eager = {}
        # the reference's flat-surface rule (ROADMAP queue 3): the eager
        # path leaves a flat surface's normal at (0, 0, 1) whatever its cv,
        # the kernels' follows cv, so the cv of a flat surface whose
        # normal acts (a refraction, a reflection, a phase sheet) is left
        # out of the comparison
        flat = [k for k in range(st.num_surfaces) if st.geom_codes[k] == 0
                and st.interactions[k] in (0, 1, fused.INT_PHASE)]
        for k in names:
            g32, g64, ge = (grad_of(lv, k) for lv in (leaves, leaves64,
                                                      leaves_e))
            if k == "cv" and flat:
                g32, g64, ge = (g.clone() for g in (g32, g64, ge))
                for g in (g32, g64, ge):
                    g[flat] = 0.0
            if g64.abs().max() > 0 or g32.abs().max() > 0:
                err[k] = rel_err(g32, g64)
                eager[k] = rel_err(ge, g64)
        print(f"system {label} polychromatic centroid_rms_spot and gradients "
              f"vs eager float64: {json.dumps(err)}; the eager float32 "
              f"path's own: {json.dumps(eager)}"
              + (f"; cv of the flat surfaces {flat} left out" if flat
                 else ""))
        check(err.pop("loss_rel") <= TOL_F64["loss_rel"], f"{label} loss")
        check(all(v <= max(TOL_F64["grad_rel"],
                           GRAD_NOISE_FACTOR * eager[k])
                  for k, v in err.items()), f"{label} gradients vs f64")
        return names

    def j3_adam(label, st, pr, fbx, names):
        """ADAM_STEPS Adam steps of the polychromatic merit (per-ray K1 and
        K2 once a step), then the step timed on the host clock. Adam moves
        every coordinate by about lr a step whatever its scale: a phase
        sheet's radial slots multiply r^2 .. r^16 (a step of 1e-4 in the
        last is 1.5e7 rad at r = 5 mm), so, as the bench trainer leaves the
        asphere coefficients, it steps the other leaves; so too for a
        freeform's coefficient slots (C_33 x^3 y^3 of H's front at 1e-8) and
        L's aspheres'."""
        names = [k for k in names if k != "phase_params"
                 and not (k == "coeffs" and label in FREEFORM_SYSTEMS
                          + LONG_SYSTEMS)]
        leaves, p_m = leaves_of(pr, names)
        opt = torch.optim.Adam(list(leaves.values()), lr=ADAM_LR)

        def step():
            opt.zero_grad()
            loss = centroid_rms_spot(st, p_m, *fbx, diff_inputs=False)
            loss.backward()
            opt.step()
            return loss

        losses = []
        for _ in range(ADAM_STEPS):
            reset_counts()
            losses.append(step().item())
            got = read_counts()
            check(got["K1"] == 1 and got["K2"] == 1
                  and sum(got.values()) == 2,
                  f"{label} Adam step launched K1, K2 once: {got}")
        check(all(math.isfinite(v) for v in losses), f"{label} losses")
        j3_steps[label] = (losses, step)

    # a timing row's note on its plain time (`timed`)
    plain_note = "plain: its comparison's call, once, cold, host clock"

    def timed(fn):
        """`fn()` and its host-clock milliseconds between synchronizes: a
        comparison's plain call, timed once where it runs (its first call
        at that shape, so the caching allocator's growth is in it)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def split_s(fn, split, key):
        """`fn()`, its host-clock seconds added to split[key]."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] = split.get(key, 0.0) + time.perf_counter() - t
        return out

    def j3_raygen(label, st, pr, fbx, wl):
        """K1-K4 of system `label` at `wl` (None: per-ray) against their
        plain versions; `trace_system_final` and its backward launch K3
        and K4 once each."""
        cfg = "per-ray" if wl is None else f"{wl} um"
        args = fbx if wl is None else fbx[:4] + (wl,)
        leaves, p_m = leaves_of(pr)
        reset_counts()
        out = tracer.trace_system_final(st, p_m, *args)
        (out["x"] ** 2 + out["y"] ** 2 + out["opd"]).sum().backward()
        got = read_counts()
        check(got["K3"] == 1 and got["K4"] == 1 and sum(got.values()) == 2,
              f"{label} trace_system_final at {cfg} launched K3, K4: {got}")
        del out, leaves, p_m
        pj, dj = fused._prepare(st, pr, *args)
        n_j = dj[0].shape[0]
        k3 = fused.raygen_trace_forward(st, *pj, dj, keys)
        k3_plain, ms3 = timed(lambda: fused._raygen_trace_plain(st, *pj, dj,
                                                                keys))
        keep_j = (k3[6] > 0) == (k3_plain[6] > 0)
        e3 = final_errs(f"K3 ({label}, {cfg})", k3, k3_plain, keep_j)
        # seeds on x, y, i and opd: a coating's cotangent needs i's (the
        # moments' c below is fixed for the same reason: the merit's own
        # is nearly blind to a factor every ray takes)
        seeds4 = (2.0 * k3[0], 2.0 * k3[1], torch.ones_like(k3[0]),
                  torch.ones_like(k3[0]))
        del k3, k3_plain
        k1 = fused.moments_forward(st, *pj, dj)
        k1_plain, ms1 = timed(lambda: fused._moments_plain(st, *pj, dj))
        e1 = moment_rel(k1, k1_plain)
        print(f"K1 ({label}, {cfg}) vs plain: moment_rel {e1:.6g} "
              f"(tolerance {TOL['moment_rel']})")
        check(e1 <= TOL["moment_rel"], f"K1 ({label}, {cfg}) vs plain")
        c_j = torch.tensor([0.3, -0.7, 0.5, 1.1], device=dev)
        plain2 = (lambda *a: fused._moments_bwd_plain(st, *a, True))
        got2 = fused.moments_backward(st, *pj, dj, c_j, True)
        ref2, ms2 = timed(lambda: plain2(*pj, dj, c_j))
        errs2, rays2, abs2 = cotangent_errs(got2, ref2, keep_j)
        check_cotangents(f"K2 ({label}, {cfg})", errs2, rays2, (
            lambda: float64_errs(got2, plain2, (*pj, dj, c_j)))
            if label in PHASE_SYSTEMS else None)
        del got2, ref2
        plain4 = (lambda *a: fused._raygen_trace_bwd_plain(
            st, *a[:-1], keys4, a[-1]))
        got4 = fused.raygen_trace_backward(st, *pj, dj, keys4, seeds4)
        ref4, ms4 = timed(lambda: plain4(*pj, dj, seeds4))
        errs4, rays4, abs4 = cotangent_errs(got4, ref4, keep_j)
        check_cotangents(f"K4 ({label}, {cfg})", errs4, rays4, (
            lambda: float64_errs(got4, plain4, (*pj, dj, seeds4)))
            if label in PHASE_SYSTEMS else None)
        del got4, ref4
        check(branch_leaf[label] in errs2 and branch_leaf[label] in errs4,
              f"{label}: the branch's cotangents reached K2 and K4")

        nd = len(dj)
        ops_f = chain_ops_per_ray(st, fused) + (
            media_ops_per_ray(st) if wl is None else 0)
        ops_b = backward_ops_per_ray(st, fused) + (
            media_ops_per_ray(st) if wl is None else 0)
        j3[f"K1 (system {label}, {cfg})"] = (
            lambda: fused.moments_forward(st, *pj, dj), ms1, plain_note,
            nd * 4 * n_j, (ops_f + 10) * n_j, j3_launch[label, wl]["K1"],
            (k1 - k1_plain).abs().max().item())
        j3[f"K2 (system {label}, {cfg})"] = (
            lambda: fused.moments_backward(st, *pj, dj, c_j, False), ms2,
            plain_note + " (with the data cotangents)", nd * 4 * n_j,
            (ops_b + 8) * n_j, j3_launch[label, wl]["K2"], abs2)
        j3[f"K3 (system {label}, {cfg})"] = (
            lambda: fused.raygen_trace_forward(st, *pj, dj, keys), ms3,
            plain_note,
            (nd + 8) * 4 * n_j, ops_f * n_j, got["K3"],
            max(v for k, v in e3.items() if k != "intensity_frac"))
        j3[f"K4 (system {label}, {cfg})"] = (
            lambda: fused.raygen_trace_backward(st, *pj, dj, keys4, seeds4),
            ms4, plain_note, (2 * nd + 4) * 4 * n_j, ops_b * n_j, got["K4"],
            abs4)
        free()

    def j3_caller(label, st, pr, fbx, wl):
        """K5 and K6 on the eager rays of the vignetted twin at `wl`
        (None: per-ray): `trace_system_final` and its backward launch them
        once each; each against its plain version."""
        cfg = "per-ray" if wl is None else f"{wl} um"
        args = fbx if wl is None else fbx[:4] + (wl,)
        leaves, p_m = leaves_of(pr)
        reset_counts()
        out = tracer.trace_system_final(st, p_m, *args)
        (out["x"] ** 2 + out["y"] ** 2 + out["opd"]).sum().backward()
        got = read_counts()
        check(got["K5"] == 1 and got["K6"] == 1 and sum(got.values()) == 2,
              f"{label} trace_system_final at {cfg} launched K5, K6: {got}")
        del out, leaves, p_m
        r0 = generate_rays(st, pr, *args)
        if wl is None:
            pj = (fused._diff_params(pr), fused._nondiff_params(pr))
            rk = fused._RAY_KEYS
        else:
            pj = fused._uniform_params(st, pr, wl, diff_w=False)
            rk = fused._RAY_KEYS[:8]
        rj = tuple(getattr(r0, k).detach().contiguous() for k in rk)
        n_j = rj[0].shape[0]
        del r0
        k5 = fused.fused_trace_forward(st, *pj, rj)
        k5_plain, ms5 = timed(lambda: fused._fused_trace_plain(st, *pj, rj))
        keep_j = (k5[6] > 0) == (k5_plain[6] > 0)
        e5 = final_errs(f"K5 ({label}, {cfg})", k5, k5_plain, keep_j, (
            lambda: final_float64_errs(
                k5, lambda *a: fused._fused_trace_plain(st, *a), (*pj, rj),
                keep_j)) if label in LONG_TRACK_SYSTEMS else None)
        del k5, k5_plain
        rng_j = np.random.default_rng(8)
        seeds8 = tuple(torch.from_numpy(rng_j.standard_normal(n_j).astype(
            np.float32)).to(dev) for _ in range(8))
        k6 = fused.fused_trace_backward(st, *pj, rj, seeds8)

        def plain6(*a):
            d_rays, d_diff = fused._fused_trace_bwd_plain(st, *a)
            return None, d_diff, d_rays

        k6_plain, ms6 = timed(lambda: plain6(*pj, rj, seeds8))
        errs6, rays6, abs6 = cotangent_errs(
            (None, k6[1], k6[0]), k6_plain, keep_j)
        check_cotangents(f"K6 ({label}, {cfg})", errs6, rays6, (
            lambda: float64_errs((None, k6[1], k6[0]), plain6,
                                 (*pj, rj, seeds8)))
            if label in PHASE_SYSTEMS + LONG_TRACK_SYSTEMS else None)
        check(branch_leaf[label] in errs6,
              f"K6 ({label}): the branch's cotangent")
        del k6, k6_plain
        nr = len(rj)
        media = media_ops_per_ray(st) if wl is None else 0
        j3[f"K5 (system {label}, {cfg})"] = (
            lambda: fused.fused_trace_forward(st, *pj, rj), ms5, plain_note,
            (nr + 8) * 4 * n_j,
            (chain_ops_per_ray(st, fused) - raygen_ops(st) + media) * n_j,
            got["K5"], max(v for k, v in e5.items()
                           if k != "intensity_frac"))
        j3[f"K6 (system {label}, {cfg})"] = (
            lambda: fused.fused_trace_backward(st, *pj, rj, seeds8), ms6,
            plain_note, (2 * nr + 8) * 4 * n_j,
            (backward_ops_per_ray(st, fused, raygen=False) + media) * n_j,
            got["K6"], abs6)
        free()

    def j3_history(label, st, pr, fbx):
        """`trace_system` at per-ray wavelengths launches K7 once, its
        history against the plain version; a merit's backward through the
        eager twin (no kernel: the flagship merit plus the mean image
        intensity, a throughput term that a coating moves) gives finite
        gradients that reach the branch's leaf."""
        leaves, p_m = leaves_of(pr, ("cv", "coating_params", "grating",
                                     "focal_length", "phase_params",
                                     "coeffs"))
        reset_counts()
        h = tracer.trace_system(st, p_m, *fbx)
        (flagship_merit(h) + h.intensity[-1].mean()).backward()
        got = read_counts()
        check(got["K7"] == 1 and sum(got.values()) == 1,
              f"{label} trace_system step launched K7 once: {got}")
        check(all(v.grad is None or bool(torch.isfinite(v.grad).all())
                  for v in leaves.values())
              and leaves[branch_leaf[label]].grad.abs().max() > 0,
              f"{label} trace_system gradients through the eager twin")
        del h, leaves, p_m
        r0 = generate_rays(st, pr, *fbx)
        r9 = tuple(getattr(r0, k).detach().contiguous()
                   for k in fused._RAY_KEYS)
        del r0
        pj = (fused._diff_params(pr), fused._nondiff_params(pr))
        k7 = fused.history_forward(st, *pj, r9)
        k7_plain, ms7 = timed(lambda: fused._history_plain(st, *pj, r9))
        e7 = history_errs(k7, k7_plain)
        del k7, k7_plain
        print(f"K7 ({label}) vs plain, all rows: {json.dumps(e7)}")
        check(e7["intensity_frac"] <= TOL["intensity_frac"], f"K7 {label} i")
        for key, tol in hist_tol.items():
            check(e7[key] <= TOL[tol], f"K7 ({label}) {key} vs plain")
        n_j, S_j = r9[0].shape[0], st.num_surfaces
        j3[f"K7 (system {label}, per-ray)"] = (
            lambda: fused.history_forward(st, *pj, r9), ms7,
            plain_note + " (every row)", (9 + 8 * S_j) * 4 * n_j,
            history_ops_per_ray(st, fused) * n_j,
            got["K7"], max(v for k, v in e7.items()
                           if k != "intensity_frac"))
        free()

    t_j3 = time.perf_counter()
    j3_launch = {}
    keys4 = (0, 1, 6, 7)
    sys_a, sys_b, sys_bv, sys_c = (j3_build(make) for make in (
        lambda: coated_cooke(CookeTriplet), lambda: spectrograph(Optic),
        lambda: spectrograph(Optic, vignetted=True),
        lambda: concave_grating(Optic)))
    check(sys_bv[0].has_vignetting and not fused.supports_fused_raygen(
        sys_bv[0]), "the vignetted spectrograph leaves in-kernel raygen")
    # A, B, C: the merits, K1-K4 in both configurations; B's vignetted
    # twin: K5, K6 in both; K7 on A and B
    for label, sysx in (("A", sys_a), ("B", sys_b), ("C", sys_c)):
        j3_adam(label, *sysx[:3], j3_merit(label, *sysx))
        for wl in (FLAGSHIP_WAVELENGTH, None):
            j3_raygen(label, *sysx[:3], wl)
    for wl in (FLAGSHIP_WAVELENGTH, None):
        j3_caller("B", *sys_bv[:3], wl)
    j3_history("A", *sys_a[:3])
    j3_history("B", *sys_b[:3])
    print(f"phase j3 (systems A, B, C at {n_c} rays): "
          f"{time.perf_counter() - t_j3:.1f} s; Adam losses "
          + json.dumps({k: v[0] for k, v in j3_steps.items()}))

    # 16d. (j4) the phase sheets at the flagship's 1,999,998 rays (3 fields
    # x 3 wavelengths, `flagship_inputs`), float32: system D, the hybrid
    # achromat (a radial and a constant sheet behind N-BK7); E, the coated
    # metalens on a conic carrier; F, the tilted reflective linear-grating
    # sheet, whose 6 degree field passes the cutoff at 0.65 um (its
    # vignetted twin leaves in-kernel raygen for K5 and K6). Through the
    # same paths and checks as phase j3: the polychromatic and the 0.55 um
    # merits with backward (K1, K2), 5 Adam steps, `trace_system_final` and
    # its backward in both configurations (K3, K4; K5, K6 on F's twin),
    # `trace_system` (K7) with a backward through the eager twin on each,
    # every kernel against its plain version at TOL, the polychromatic loss
    # and gradients against the eager float64 path. Then one eager
    # `trace_system` of a cubic grid-phase sheet on the card, which no
    # kernel takes, against its float64 trace on the CPU.
    t_j4 = time.perf_counter()
    sys_d, sys_e, sys_f, sys_fv = (j3_build(make) for make in (
        lambda: hybrid_achromat(Optic), lambda: curved_metalens(Optic),
        lambda: phase_mirror(Optic), lambda: phase_mirror(Optic, True)))
    check(sys_fv[0].has_vignetting and not fused.supports_fused_raygen(
        sys_fv[0]), "F's vignetted twin leaves in-kernel raygen")
    # no ray of the batch may cross a radial sheet on its axis, where the
    # eager path's derivative of the gradient (0) and the kernels' (2 p0)
    # differ by design (ROADMAP queue 3): D's and E's sheets are centred,
    # so that ray would be the pupil's centre on the on-axis field
    fbx = sys_d[2]
    centre = int(((fbx[0] == 0) & (fbx[1] == 0) & (fbx[2] == 0)
                  & (fbx[3] == 0)).sum().item())
    print(f"phase j4: rays of the batch on a radial sheet's axis: {centre}")
    check(centre == 0, "no ray of the batch on a radial sheet's axis")
    # F: how near its surviving rays come to the cutoff, from the float64
    # trace: |k_out| = n2 k0, so R^2 / (n2 k0)^2 is the square of the
    # outgoing direction's component along the mirror's normal (its local
    # N, the rotation of the global (M, N) by -5 degrees about x)
    st64, pr64 = sys_f[3]
    h64 = tracer.trace_system(st64, pr64, *(a.double() for a in sys_f[2]))
    c5, s5 = math.cos(-math.radians(5.0)), math.sin(-math.radians(5.0))
    n_loc = h64.M[1] * s5 + h64.N[1] * c5
    alive = h64.intensity[1] > 0
    margin = (n_loc[alive] ** 2).min().item()
    print(f"system F: {int((~alive).sum().item())} of {alive.numel()} rays "
          f"evanescent at the sheet; the surviving ray nearest the cutoff "
          f"has R^2 / (n2 k0)^2 = {margin:.6g}")
    check((~alive).any().item() and margin > 0.01,
          "F: part of the bundle past the cutoff, the rest away from it")
    del h64, n_loc, alive
    free()
    for label, sysx in (("D", sys_d), ("E", sys_e), ("F", sys_f)):
        j3_adam(label, *sysx[:3], j3_merit(label, *sysx))
        for wl in (FLAGSHIP_WAVELENGTH, None):
            j3_raygen(label, *sysx[:3], wl)
    for wl in (FLAGSHIP_WAVELENGTH, None):
        j3_caller("F", *sys_fv[:3], wl)
    for label, sysx in (("D", sys_d), ("E", sys_e), ("F", sys_f)):
        j3_history(label, *sysx[:3])
    # the eager trace of a cubic grid-phase sheet on the card
    st_g, pr_g = grid_sheet(Optic).build(device="cuda")
    check(not fused.supports_fused(st_g), "the grid sheet takes no kernel")
    config.set_precision("float64")
    st_g64, pr_g64 = grid_sheet(Optic).build(device="cpu")
    config.set_precision("float32")
    rng_g = np.random.default_rng(12)
    n_g = 65_536
    r_g = np.sqrt(rng_g.uniform(size=n_g))
    th_g = rng_g.uniform(0, 2 * np.pi, n_g)
    grid_in = (np.zeros(n_g), rng_g.uniform(-1, 1, n_g), r_g * np.cos(th_g),
               r_g * np.sin(th_g))
    reset_counts()
    h_g = tracer.trace_system(st_g, pr_g, *(torch.tensor(
        a, dtype=torch.float32, device=dev) for a in grid_in), 0.55)
    got_g = read_counts()
    h_g64 = tracer.trace_system(st_g64, pr_g64, *(torch.from_numpy(a)
                                                  for a in grid_in), 0.55)
    g_err = {key: (getattr(h_g, key)[-1].double().cpu()
                   - getattr(h_g64, key)[-1]).abs().max().item()
             for key in ("x", "y", "L", "M", "N", "opd")}
    print(f"grid-phase sheet, eager trace_system on the card (float32, "
          f"{n_g} rays) vs float64 on the CPU: {json.dumps(g_err)}; "
          f"launches {got_g}")
    check(sum(got_g.values()) == 0, "the grid sheet traced eagerly")
    check(all(g_err[k] <= TOL_F64["position_mm"] for k in ("x", "y"))
          and all(g_err[k] <= TOL_F64["direction"] for k in ("L", "M", "N"))
          and g_err["opd"] <= TOL_F64["opd_mm"],
          "grid-phase sheet on the card vs float64")
    del h_g, h_g64
    free()
    print(f"phase j4 (systems D, E, F at {n_c} rays, the grid sheet at "
          f"{n_g}): {time.perf_counter() - t_j4:.1f} s; Adam losses "
          + json.dumps({k: j3_steps[k][0] for k in "DEF"}))

    # 16e. (j5) the freeform geometries at the flagship's 1,999,998 rays (3
    # fields x 3 wavelengths, `flagship_inputs`), float32, N-BK7: system G,
    # a biconic and a toroidal face; H, a poly-XY (16 slots) and a 16-term
    # Fringe Zernike (17 slots); I, a Chebyshev 3 x 5 (17 slots) tilted 3
    # degrees and decentred 0.3 mm and a Forbes Q-bfs (its vignetted twin
    # leaves in-kernel raygen for K5 and K6). The same paths and checks as
    # phase j3 (each kernel against its plain version at TOL, the
    # polychromatic loss and gradients against float64), after a count of
    # the rays the freeforms' capped Newton (min(newton_iters, 6) + 1
    # updates) leaves unconverged: the kernels' plain version in float64
    # against the eager float64 trace (newton_iters updates) at each
    # freeform's hit. Then a Forbes Q-2D system, inside JAX's gate, whose
    # kernel branch is still to port, is refused by name.
    t_j5 = time.perf_counter()
    sys_g, sys_h, sys_i, sys_iv = (j3_build(make) for make in (
        lambda: anamorphic_singlet(Optic), lambda: xy_freeform_singlet(Optic),
        lambda: tilted_freeform_singlet(Optic),
        lambda: tilted_freeform_singlet(Optic, True)))
    check(sys_iv[0].has_vignetting and not fused.supports_fused_raygen(
        sys_iv[0]), "I's vignetted twin leaves in-kernel raygen")
    unconverged = {}
    for label, sysx in (("G", sys_g), ("H", sys_h), ("I", sys_i)):
        st64, pr64 = sysx[3]
        r0 = generate_rays(st64, pr64, *(a.double() for a in sysx[2]))
        with torch.no_grad():
            ref = tracer.trace_rays(st64, pr64, r0)
            capped = fused._tile_trace(
                st64, fused._diff_params(pr64), fused._nondiff_params(pr64),
                *(getattr(r0, k) for k in fused._RAY_KEYS), record=True)
        miss = torch.zeros_like(r0.x, dtype=torch.bool)
        for k in range(1, st64.num_surfaces - 1):
            lit = ref.intensity[k] > 0
            for j, key in enumerate(("x", "y", "z")):
                miss |= lit & ((capped[k][j] - getattr(ref, key)[k]).abs()
                               > 1e-9)
        unconverged[label] = int(miss.sum().item())
        del r0, ref, capped, miss
        free()
    print(f"phase j5: rays the capped freeform Newton leaves more than 1e-9 "
          f"mm from the eager float64 hit: {json.dumps(unconverged)}")
    check(not any(unconverged.values()), "the capped Newton converges")
    split = {}
    for label, sysx in (("G", sys_g), ("H", sys_h), ("I", sys_i)):
        names = split_s(lambda: j3_merit(label, *sysx), split,
                        f"{label} merit vs float64")
        split_s(lambda: j3_adam(label, *sysx[:3], names), split,
                f"{label} Adam")
        for wl in (FLAGSHIP_WAVELENGTH, None):
            split_s(lambda: j3_raygen(label, *sysx[:3], wl), split,
                    f"{label} K1-K4 vs plain")
    for wl in (FLAGSHIP_WAVELENGTH, None):
        split_s(lambda: j3_caller("I", *sys_iv[:3], wl), split,
                "I twin K5, K6 vs plain")
    for label, sysx in (("G", sys_g), ("H", sys_h), ("I", sys_i)):
        split_s(lambda: j3_history(label, *sysx[:3]), split,
                f"{label} K7 vs plain")
    print(f"phase j5: seconds of its parts {json.dumps(split)}")
    # the Q-2D system this phase once refused by name runs through K1
    st_q, pr_q = _freeform_pair(
        Optic, (60.0, "forbes_q2d", dict(
            norm_radius=5.0, freeform_coeffs={("a", 0, 0): 1e-4,
                                              ("b", 1, 1): 2e-5})),
        (-60.0, "standard", {})).build(device="cuda")
    check(fused.supports_fused(st_q), "a Q-2D system is inside JAX's gate")
    reset_counts()
    loss_q = centroid_rms_spot(st_q, pr_q, *sys_g[2][:4], 0.55)
    got_q = read_counts()
    print(f"phase j5: a Forbes Q-2D system's centroid_rms_spot on the card: "
          f"{loss_q.item()!r}, launches {got_q}")
    check(got_q["K1"] == 1 and sum(got_q.values()) == 1
          and math.isfinite(loss_q.item()), "the Q-2D system ran through K1")
    del loss_q
    free()
    print(f"phase j5 (systems G, H, I at {n_c} rays): "
          f"{time.perf_counter() - t_j5:.1f} s; Adam losses "
          + json.dumps({k: j3_steps[k][0] for k in FREEFORM_SYSTEMS}))

    # 16f. (j6) the configurations of K1-K7 the kernels took last, at the
    # flagship's 1,999,998 rays (3 fields x 3 wavelengths,
    # `flagship_inputs`), float32, N-BK7: system J, a tilted, decentred
    # Forbes Q-2D face within a 17-slot row (its vignetted twin leaves
    # in-kernel raygen for K5 and K6); K, a 38-slot Fringe Zernike and a
    # 29-slot Q-2D (the wide rows); L, 70 surfaces of relays (the backward
    # kernels' record of 128 surfaces). The same paths and checks as phase
    # j5, after its count of
    # the rays the capped Newton leaves unconverged; then a NURBS singlet, which JAX's gate and the kernels
    # leave to the eager trace, on the card against float64.
    t_j6 = time.perf_counter()
    sys_j, sys_jv, sys_k, sys_l = (j3_build(make) for make in (
        lambda: q2d_singlet(Optic), lambda: q2d_singlet(Optic, True),
        lambda: wide_freeform_singlet(Optic), lambda: relay_train(Optic)))
    check(sys_jv[0].has_vignetting and not fused.supports_fused_raygen(
        sys_jv[0]), "J's vignetted twin leaves in-kernel raygen")
    check(max(sys_k[0].geom_n_coeffs) == 38 and sys_l[0].num_surfaces == 70,
          "K's rows past 17 slots, L's 70 surfaces")
    shapes = {}
    for label, sysx in (("J", sys_j), ("K", sys_k), ("L", sys_l)):
        st = sysx[0]
        blocks_sm = fused._blocks_per_sm("moments_fwd",
                                         fused.system_defines(st))
        threads = {cfg: fused._backward_launch(st, n_c, dev, st.num_surfaces
                                               + 1, cfg == "per-ray")[1]
                   for cfg in ("0.55 um", "per-ray")}
        shapes[label] = {"K1 blocks an SM": blocks_sm,
                         "K2 threads a block": threads}
        check(min(threads.values()) >= 128, f"{label}'s K2 takes at least "
              "128 threads a block")
    print(f"phase j6: K1's blocks an SM and K2's block: {json.dumps(shapes)}")
    unconverged = {}
    for label, sysx in (("J", sys_j), ("K", sys_k), ("L", sys_l)):
        st64, pr64 = sysx[3]
        r0 = generate_rays(st64, pr64, *(a.double() for a in sysx[2]))
        with torch.no_grad():
            ref = tracer.trace_rays(st64, pr64, r0)
            capped = fused._tile_trace(
                st64, fused._diff_params(pr64), fused._nondiff_params(pr64),
                *(getattr(r0, k) for k in fused._RAY_KEYS), record=True)
        miss = torch.zeros_like(r0.x, dtype=torch.bool)
        for k in range(1, st64.num_surfaces - 1):
            lit = ref.intensity[k] > 0
            for j, key in enumerate(("x", "y", "z")):
                miss |= lit & ((capped[k][j] - getattr(ref, key)[k]).abs()
                               > 1e-9)
        unconverged[label] = int(miss.sum().item())
        lit_share = (ref.intensity[-1] > 0).double().mean().item()
        print(f"phase j6: system {label}, {st64.num_surfaces} surfaces, "
              f"share of the rays that reach the image {lit_share:.6f}")
        check(lit_share >= 0.9, f"{label}: 90% of the rays reach the image")
        del r0, ref, capped, miss
        free()
    print(f"phase j6: rays the capped Newton leaves more than 1e-9 mm from "
          f"the eager float64 hit: {json.dumps(unconverged)}")
    check(not any(unconverged.values()), "the capped Newton converges")
    split = {}
    for label, sysx in (("J", sys_j), ("K", sys_k), ("L", sys_l)):
        names = split_s(lambda: j3_merit(label, *sysx), split,
                        f"{label} merit vs float64")
        split_s(lambda: j3_adam(label, *sysx[:3], names), split,
                f"{label} Adam")
        for wl in (FLAGSHIP_WAVELENGTH, None):
            split_s(lambda: j3_raygen(label, *sysx[:3], wl), split,
                    f"{label} K1-K4 vs plain")
    for wl in (FLAGSHIP_WAVELENGTH, None):
        split_s(lambda: j3_caller("J", *sys_jv[:3], wl), split,
                "J twin K5, K6 vs plain")
    for label, sysx in (("J", sys_j), ("K", sys_k), ("L", sys_l)):
        split_s(lambda: j3_history(label, *sysx[:3]), split,
                f"{label} K7 vs plain")
    print(f"phase j6: seconds of its parts {json.dumps(split)}")
    del sys_j, sys_jv, sys_k, sys_l
    free()
    # a NURBS singlet (the LSQ fit of the R 60, k -0.8 conic over +-8 mm,
    # 10 x 10 control points): trace_system and its merit's gradient on
    # the card's eager path in float32 against float64, no kernel launched
    nurbs_front = (60.0, "nurbs", dict(conic=-0.8, n_points_u=10,
                                       n_points_v=10, nurbs_norm_x=8.0,
                                       nurbs_norm_y=8.0))
    st_n, pr_n = _freeform_pair(Optic, nurbs_front, (-60.0, "standard", {})
                                ).build(device="cuda")
    config.set_precision("float64")
    st_n64, pr_n64 = _freeform_pair(Optic, nurbs_front,
                                    (-60.0, "standard", {})).build(
        device="cuda")
    config.set_precision("float32")
    check(not fused.supports_fused(st_n), "the NURBS singlet takes no kernel")
    rng_n = np.random.default_rng(13)
    n_n = 65_536
    r_n = np.sqrt(rng_n.uniform(size=n_n))
    th_n = rng_n.uniform(0, 2 * np.pi, n_n)
    nurbs_in = (np.zeros(n_n), rng_n.uniform(-1, 1, n_n), r_n * np.cos(th_n),
                r_n * np.sin(th_n))
    leaves_n, p_n = leaves_of(pr_n, ("cv", "coeffs", "thickness"))
    leaves_n64, p_n64 = leaves_of(pr_n64, ("cv", "coeffs", "thickness"))
    reset_counts()
    h_n = tracer.trace_system(st_n, p_n, *(torch.tensor(
        a, dtype=torch.float32, device=dev) for a in nurbs_in), 0.55)
    flagship_merit(h_n).backward()
    got_n = read_counts()
    h_n64 = tracer.trace_system(st_n64, p_n64, *(torch.tensor(
        a, dtype=torch.float64, device=dev) for a in nurbs_in), 0.55)
    flagship_merit(h_n64).backward()
    n_err = {key: (getattr(h_n, key)[-1].double()
                   - getattr(h_n64, key)[-1]).abs().max().item()
             for key in ("x", "y", "L", "M", "N", "opd")}
    n_err["loss_rel"] = abs(flagship_merit(h_n).item()
                            - flagship_merit(h_n64).item()) / abs(
        flagship_merit(h_n64).item())
    for k in leaves_n:
        n_err[f"grad {k}"] = rel_err(grad_of(leaves_n, k),
                                     grad_of(leaves_n64, k))
    print(f"NURBS singlet, eager trace_system and its merit's gradient on the "
          f"card (float32, {n_n} rays) vs float64: {json.dumps(n_err)}; "
          f"launches {got_n}")
    check(sum(got_n.values()) == 0, "the NURBS singlet traced eagerly")
    check(all(n_err[k] <= TOL_F64["position_mm"] for k in ("x", "y"))
          and all(n_err[k] <= TOL_F64["direction"] for k in ("L", "M", "N"))
          and n_err["opd"] <= TOL_F64["opd_mm"]
          and n_err["loss_rel"] <= TOL_F64["loss_rel"]
          and all(n_err[f"grad {k}"] <= TOL_F64["grad_rel"]
                  for k in leaves_n), "NURBS singlet on the card vs float64")
    del h_n, h_n64, leaves_n, leaves_n64, p_n, p_n64
    free()
    print(f"phase j6 (systems J, K, L at {n_c} rays, the NURBS singlet at "
          f"{n_n}): {time.perf_counter() - t_j6:.1f} s; Adam losses "
          + json.dumps({k: j3_steps[k][0] for k in LONG_SYSTEMS}))

    # 16g. (j7) the system core's configurations: aimed, telecentric and
    # image-height systems through the kernels JAX sends them to (K7 after
    # the eager aim; K5/K6 after the eager raygen), each kernel against its
    # plain version at TOL; each aim against its own target; the eager
    # paths (an annular aperture, absolute coordinates, apodization) in
    # float32 against float64 on the card; the zoo on the card against the
    # CPU in float64.
    t_j7 = time.perf_counter()
    j7_times = {}

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def stop_errors(st, pr, hist, Px, Py, w):
        """Each live ray's stop hit over the stop radius against its (Px,
        Py): the aim's own target."""
        r_s = aiming.stop_radius(st, pr, w)
        k = st.stop_index
        live = hist.intensity[-1] > 0
        e = torch.hypot(hist.x[k] / r_s - Px, hist.y[k] / r_s - Py)
        return e[live].max().item(), live.float().mean().item()

    def j7_history(key, st, pr, args, long_track=False):
        """K7 against its plain version on the rays `generate_rays` makes
        of `args` (Hx, Hy, Px, Py, w), every array within TOL or, with
        `long_track` (LONG_TRACK_SYSTEMS), near float64
        (`final_float64_errs`); the launch recorded under `key`."""
        r0 = generate_rays(st, pr, *args, apply_vignetting=False)
        r9 = tuple(getattr(r0, k).detach().contiguous()
                   for k in fused._RAY_KEYS)
        del r0
        pj = (fused._diff_params(pr), fused._nondiff_params(pr))
        got7 = fused.history_forward(st, *pj, r9)
        plain7, ms7 = timed(lambda: fused._history_plain(st, *pj, r9))
        e7 = history_errs(got7, plain7)
        print(f"K7 ({key}) vs plain, all rows: {json.dumps(e7)}")
        check(e7["intensity_frac"] <= TOL["intensity_frac"], f"K7 {key} i")
        miss = [name for name, tol in hist_tol.items()
                if e7[name] > TOL[tol]]
        if miss and long_track:
            keep_h = ((got7[6] > 0) == (plain7[6] > 0)).all(dim=0)
            far = final_float64_errs(
                got7, lambda *a: fused._history_plain(st, *a), (*pj, r9),
                keep_h)
            print(f"K7 ({key}), the arrays past TOL against the plain "
                  f"version run in float64: " + json.dumps(
                      {name: far[name] for name in miss}))
            miss = [name for name in miss
                    if not near_float64(far[name], TOL[hist_tol[name]])]
        for name in hist_tol:
            check(name not in miss, f"K7 ({key}) {name} vs plain")
        del got7, plain7
        n_j, S_j = r9[0].shape[0], st.num_surfaces
        return (lambda: fused.history_forward(st, *pj, r9), ms7,
                plain_note,
                (9 + 8 * S_j) * 4 * n_j, history_ops_per_ray(st, fused) * n_j,
                max(v for k, v in e7.items() if k != "intensity_frac"))

    def logged_aim(aim, log):
        """`aim` wrapped to log each call's rays, rounds (a robust aim's),
        host-clock seconds and result."""
        robust_aim = aim is aiming.aim_rays_robust

        def logged(*a, **kw):
            stats = {}
            t0 = synced()
            out = aim(*a, stats=stats, **kw) if robust_aim else aim(*a, **kw)
            log.append(dict(rays=a[2].numel(), s=synced() - t0, q=out,
                            rounds=stats.get("rounds")))
            return out
        return logged

    # iterative aiming: WideAngle100FOV's trace_generic at its three fields
    # and its primary wavelength, AIM_RAYS rays over them in the unit disk
    # (seed 14), float32: the aim (6 Newton steps, forward-mode probes over
    # the batch twice over, timed through a wrapper), then K7 on the aimed
    # rays
    wa = zoo_models.WideAngle100FOV()
    st_wa, pr_wa = wa.build(device="cuda")
    check(wa.ray_aiming == "iterative" and fused.supports_fused(st_wa),
          "WideAngle100FOV aims iteratively, inside JAX's gate")
    wa_in = field_pupil_inputs(wa, AIM_RAYS, dev)
    w_wa = torch.tensor(wa.primary_wavelength, device=dev)
    iterative, wa_log = aiming.aim_rays_iterative, []
    aiming.aim_rays_iterative = logged_aim(iterative, wa_log)
    try:
        reset_counts()
        t0 = synced()
        h_wa = wa.trace_generic(*wa_in, wavelength=wa.primary_wavelength)
        j7_times["WideAngle100FOV trace_generic s"] = synced() - t0
        got_wa = read_counts()
    finally:
        aiming.aim_rays_iterative = iterative
    j7_times["WideAngle100FOV iterative aim s"] = wa_log[0]["s"]
    q_wa = wa_log[0]["q"]
    check(got_wa["K7"] == 1 and sum(got_wa.values()) == 1,
          f"WideAngle100FOV's aimed trace_generic launched K7: {got_wa}")
    e_wa, live_wa = stop_errors(st_wa, pr_wa, h_wa, *wa_in[2:], w_wa)
    print(f"phase j7: WideAngle100FOV, {wa_in[0].numel()} rays, "
          f"trace_generic {j7_times['WideAngle100FOV trace_generic s']:.3f} "
          f"s, of it the iterative aim "
          f"{j7_times['WideAngle100FOV iterative aim s']:.3f} s; stop "
          f"target error {e_wa!r} (tolerance {TOL_AIM}) on the live rays "
          f"({live_wa:.6f} of them)")
    check(e_wa <= TOL_AIM, "WideAngle100FOV's aim meets its stop target")
    del h_wa
    *k7_wa, err_wa = j7_history("WideAngle100FOV, iterative aim", st_wa,
                                pr_wa, (*wa_in[:2], *q_wa, w_wa))
    j3["K7 (WideAngle100FOV, iterative aim)"] = (*k7_wa, got_wa["K7"],
                                                  err_wa)
    del q_wa, wa_log
    free()

    # robust aiming: ProjectionLens120FOV's wavefront_data at field (0, 1)
    # on the 128 x 128 pupil grid of the Huygens PSF's defaults, the chief
    # ray aimed too; the aim's rounds and time read through a wrapper
    pl = zoo_models.ProjectionLens120FOV()
    st_pl, pr_pl = pl.build(device="cuda")
    check(pl.ray_aiming == "robust" and fused.supports_fused(st_pl),
          "ProjectionLens120FOV aims robustly, inside JAX's gate")
    px_pl, py_pl, in_pl = pupil_grid_coords(128, torch.float32, dev)
    robust, robust_log = aiming.aim_rays_robust, []
    aiming.aim_rays_robust = logged_aim(robust, robust_log)
    try:
        reset_counts()
        t0 = synced()
        wd_pl = wavefront_data(st_pl, pr_pl, 0.0, 1.0, px_pl, py_pl,
                               pl.primary_wavelength, aiming=pl.ray_aiming)
        j7_times["ProjectionLens120FOV wavefront_data s"] = synced() - t0
        got_pl = read_counts()
    finally:
        aiming.aim_rays_robust = robust
    check(got_pl["K7"] == 2 and sum(got_pl.values()) == 2,
          f"the robustly aimed wavefront_data launched K7 twice: {got_pl}")
    check(bool(torch.isfinite(wd_pl.opd[in_pl]).all()),
          "the robustly aimed wavefront: finite OPD in the pupil")
    bundle = next(r for r in robust_log if r["rays"] == px_pl.numel())
    w_pl = torch.tensor(pl.primary_wavelength, device=dev)
    pl_in = (torch.zeros_like(px_pl), torch.ones_like(px_pl))
    h_pl = tracer.trace_system(st_pl, pr_pl, *pl_in, *bundle["q"], w_pl,
                               apply_vignetting=False)
    e_pl, live_pl = stop_errors(st_pl, pr_pl, h_pl, px_pl, py_pl, w_pl)
    print(f"phase j7: ProjectionLens120FOV wavefront_data, robust aim, "
          f"{px_pl.numel()} rays at field (0, 1): "
          f"{j7_times['ProjectionLens120FOV wavefront_data s']:.3f} s; the "
          f"aims (rays, rounds, s): "
          + json.dumps([(r["rays"], r["rounds"], round(r["s"], 4))
                        for r in robust_log])
          + f"; stop target error {e_pl!r} (tolerance {TOL_AIM}) on the live "
          f"rays ({live_pl:.6f} of them)")
    check(e_pl <= TOL_AIM, "ProjectionLens120FOV's aim meets its stop target")
    del h_pl, wd_pl
    *k7_pl, err_pl = j7_history("ProjectionLens120FOV, robust aim", st_pl,
                                pr_pl, (*pl_in, *bundle["q"], w_pl))
    j3["K7 (ProjectionLens120FOV, robust aim)"] = (*k7_pl, got_pl["K7"],
                                                    err_pl)
    del robust_log, bundle
    free()

    # telecentric object space (UVProjectionLens: object heights, objectNA)
    # and the Cooke triplet's image-height fields, at 1,999,998 rays over
    # each system's fields and wavelengths as `flagship_inputs` makes them,
    # traced at its primary wavelength: trace_system_final and its
    # params-only backward (K5, K6 after the eager raygen), each against its
    # plain version; the telecentric trace_system (K7)
    for label, make in (
            ("UV", zoo_models.UVProjectionLens),
            ("real image height", lambda: image_height_cooke(
                CookeTriplet, "real_image_height")),
            ("paraxial image height", lambda: image_height_cooke(
                CookeTriplet, "paraxial_image_height"))):
        lens = make()
        st, pr = lens.build(device="cuda")
        check(fused.supports_fused(st) and not fused.supports_fused_raygen(
            st), f"{label}: K5/K6 after the eager raygen")
        # 1,999,998 rays over the system's fields and wavelengths
        fbx = flagship_inputs(pr, dev, 1_999_998 // (
            pr.x_fields.numel() * pr.wavelengths.numel()))
        branch_leaf[label] = "cv"
        t0 = synced()
        j3_caller(label, st, pr, fbx, lens.primary_wavelength)
        j7_times[f"{label} K5/K6 s"] = synced() - t0
        if label == "UV":
            reset_counts()
            h_uv = tracer.trace_system(st, pr, *fbx[:4],
                                       lens.primary_wavelength)
            got_uv = read_counts()
            check(got_uv["K7"] == 1 and sum(got_uv.values()) == 1,
                  f"UV trace_system launched K7: {got_uv}")
            check(bool(torch.isfinite(h_uv.x[-1]).all()), "UV history")
            del h_uv
            *k7_uv, err_uv = j7_history(
                "UV, telecentric", st, pr, (*fbx[:4], lens.primary_wavelength),
                long_track=True)
            j3["K7 (UV, telecentric)"] = (*k7_uv, got_uv["K7"], err_uv)
        del fbx
        free()

    # the eager paths, no kernel: the annular aperture (HubbleTelescope),
    # absolute coordinates (`fold_mirror`) and apodization
    # (`apodized_singlet`), EAGER_RAYS rays over their fields (seed 15) in
    # float32 against the float64 trace on the card: each system's rays
    # clipped alike at every surface, and its arrays within TOL_EAGER of
    # their scale at every row (the image rows are printed over their own)
    eager_errs = {}
    for label, make in (
            ("HubbleTelescope", zoo_models.HubbleTelescope),
            ("fold mirror", lambda: fold_mirror(Optic)),
            ("apodized singlet", lambda: apodized_singlet(Optic))):
        st, pr = make().build(device="cuda")
        config.set_precision("float64")
        st64, pr64 = make().build(device="cuda")
        config.set_precision("float32")
        check(not fused.supports_fused(st), f"{label}: the eager path")
        e_in = field_pupil_inputs(make(), EAGER_RAYS, dev, seed=15)
        w_e = make().primary_wavelength
        reset_counts()
        h32 = tracer.trace_system(st, pr, *e_in, w_e)
        got_e = read_counts()
        h64 = tracer.trace_system(st64, pr64, *(a.double() for a in e_in),
                                  w_e)
        check(sum(got_e.values()) == 0, f"{label} traced eagerly: {got_e}")
        alike = ((h32.intensity > 0) == (h64.intensity > 0)).all(dim=0)
        errs = {"clipped_alike": alike.float().mean().item(),
                "clipped": (h64.intensity[-1] == 0).float().mean().item()}
        for part, sl in (("", slice(None)), (" image", slice(-1, None))):
            for name in ("x", "y", "z", "L", "M", "N", "intensity", "opd"):
                a = getattr(h32, name)[sl].double()
                b = getattr(h64, name)[sl]
                scale = max(b.abs().max().item(), 1.0)
                errs[name + part] = ((a - b).abs().max() / scale).item()
        eager_errs[label] = errs
        check(errs["clipped_alike"] == 1.0
              and all(errs[k] <= TOL_EAGER for k in
                      ("x", "y", "z", "L", "M", "N", "intensity", "opd")),
              f"{label}: float32 against float64 on the card")
        del h32, h64
        free()
    print(f"phase j7: eager traces, float32 vs float64 on the card, "
          f"{EAGER_RAYS} rays, errors relative to each array's scale "
          f"(tolerance {TOL_EAGER}): {json.dumps(eager_errs)}")

    # the zoo: each lens's trace at each of its fields, hexapolar 7 rays a
    # field, in float64 on the card against the same call on the CPU. The
    # four aimed lenses trace paraxially aimed here: their aims, eager
    # traces of 7 rays, take ~2 s a robust round on the card (8-180 rounds
    # a field), 386 s on the card and 160 s on the CPU for the four at their
    # fields (measured on one H100); the aims are held above at full scale
    # and in tests/test_torch_zoo.py
    config.set_precision("float64")
    zoo_errs = {}
    t_zoo = synced()
    for name in zoo_models.__all__:
        if name in ("CookeTriplet", "DoubleGauss", "ReverseTelephoto"):
            continue
        hist = {}
        for device in ("cuda", "cpu"):
            lens = getattr(zoo_models, name)()
            lens.set_ray_aiming("paraxial")
            hist[device] = [lens.trace(Hx=hx, Hy=hy, num_rays=1,
                                       device=device)
                            for hx, hy in lens.fields.get_field_coords()]
        zoo_errs[name] = max(
            scaled_err(getattr(a, k).cpu(), getattr(b, k))
            for a, b in zip(hist["cuda"], hist["cpu"])
            for k in ("x", "y", "z", "L", "M", "N", "intensity", "opd"))
    config.set_precision("float32")
    j7_times["zoo s"] = synced() - t_zoo
    print(f"phase j7: the zoo's trace in float64, card against CPU, largest "
          f"error relative to scale (tolerance {TOL_ZOO}): "
          f"{json.dumps(zoo_errs)}")
    check(len(zoo_errs) == 26 and max(zoo_errs.values()) <= TOL_ZOO,
          "the zoo on the card agrees with the CPU")
    print(f"phase j7: {time.perf_counter() - t_j7:.1f} s; "
          f"{json.dumps(j7_times)}")

    # 16h. (j8) the design loop: environment/, optimization/ and
    # tolerancing/, every ray operand through trace_system (K7 forward, the
    # eager twin's backward). (a) the bench lens's merit (`design_problem`)
    # at 2,000,017 rays a field: its values, gradient and residual Jacobian
    # on K7 against K7's plain version and the eager float64 path, 5 Adam
    # steps, scipy's minimize and least_squares; (b) the Cooke triplet's
    # tolerancing draws and sweep (`cooke_tolerancing`) against float64;
    # (c) GlassExpert on the Cooke triplet's middle glass, the K7 variants it
    # builds at first use counted; (d) the air and glass models in float64
    # on the card against the CPU. Each part with the counters at 0 just
    # before and read just after.
    t_j8 = time.perf_counter()
    j8_times = {}

    @contextlib.contextmanager
    def swapped(module, name, replacement):
        original = getattr(module, name)
        setattr(module, name, replacement)
        try:
            yield original
        finally:
            setattr(module, name, original)

    def plain_k7():
        """K7's wrapper runs its plain version on the card (the reference of
        the comparisons: no launch)."""
        return swapped(fused, "history_forward", fused._history_plain)

    def eager_trace():
        """trace_system runs the eager float32 trace on the card (no kernel):
        the rounding float32 leaves by itself."""
        return swapped(fused, "trace_history_fused",
                       lambda st, pr, r0: tracer.trace_rays(st, pr, r0))

    @contextlib.contextmanager
    def precision(name):
        config.set_precision(name)
        try:
            yield
        finally:
            config.set_precision("float32")

    backward_passes = [0]   # K7's backward: autograd through the eager twin

    def counted_twin(*args, _twin=fused._hist_eager):
        backward_passes[0] += 1
        return _twin(*args)

    def timed_call(fn, reps=2):
        """Median host-clock ms of `fn` behind synchronize over `reps` calls
        after one (the path has run before), and (K7 launches, backward
        passes) of that one."""
        reset_counts()
        backward_passes[0] = 0
        fn()
        counts = (read_counts()["K7"], backward_passes[0])
        times = []
        for _ in range(reps):
            t0 = synced()
            fn()
            times.append(1e3 * (synced() - t0))
        return float(np.median(times)), counts

    def rel(got, ref):
        """Largest |got - ref| / |ref| entry by entry (float64)."""
        got, ref = torch.as_tensor(got).double().cpu(), torch.as_tensor(
            ref).double().cpu()
        return ((got - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()

    with swapped(fused, "_hist_eager", counted_twin):
        # (a) the bench lens, cv x 1.05, float32 on K7 and float64 eager
        lens_d = bench_lens(Optic)
        st_d, _ = lens_d.build(device="cuda")
        pr_d = detune(lens_d).params
        p_d = design_problem(OptimizationProblem, lens_d)
        c_d = p_d._compile()
        x_d = p_d.x0()
        n_design = 1 + 3 * DESIGN_RINGS * (DESIGN_RINGS + 1)
        check(n_design == 2_000_017, "2,000,017 rays a field")
        reset_counts()
        backward_passes[0] = 0
        merit_d = p_d.sum_squared()
        fa_d = p_d.fun_array()
        v_d, g_d = c_d["value_and_grad"](x_d, pr_d)
        got_d = read_counts()
        print(f"phase j8: design merit (sum_squared, fun_array, "
              f"value_and_grad) launches {got_d}, backward passes "
              f"{backward_passes[0]}")
        check(got_d["K7"] >= 3 * 2 and sum(got_d.values()) == got_d["K7"],
              f"design merit: K7 at least twice an evaluation: {got_d}")
        check(backward_passes[0] >= 2, "value_and_grad through the twin")
        check(all(bool(torch.isfinite(t).all()) for t in (merit_d, fa_d,
                                                           v_d, g_d))
              and g_d.shape == (9,), "design merit and gradient finite")
        with plain_k7():
            merit_p = p_d.sum_squared()
            fa_p = p_d.fun_array()
            v_p, g_p = c_d["value_and_grad"](x_d, pr_d)
        check(read_counts() == got_d, "K7's plain version launched nothing")
        err_plain = {"sum_squared": rel(merit_d, merit_p),
                     "fun_array": rel_err(fa_d, fa_p),
                     "value": rel(v_d, v_p), "grad": rel_err(g_d, g_p)}
        print("phase j8: design merit on K7 vs K7's plain version, "
              f"relative: {json.dumps(err_plain)} tolerances value "
              f"{TOL['moment_rel']} grad {TOL['param_grad_rel']}")
        check(max(err_plain["sum_squared"], err_plain["fun_array"],
                  err_plain["value"]) <= TOL["moment_rel"]
              and err_plain["grad"] <= TOL["param_grad_rel"],
              "design merit vs plain")
        with precision("float64"):
            lens_d64 = bench_lens(Optic)
            lens_d64.build(device="cuda")
            detune(lens_d64)
            p_d64 = design_problem(OptimizationProblem, lens_d64)
            merit_64 = p_d64.sum_squared()
            fa_64 = p_d64.fun_array()
            v_64, g_64 = p_d64._compile()["value_and_grad"](
                p_d64.x0(), lens_d64.params)
        with eager_trace():
            v_e, g_e = c_d["value_and_grad"](x_d, pr_d)
        check(read_counts() == got_d, "float64 and eager float32 ran eager")
        err_64 = {"sum_squared": rel(merit_d, merit_64),
                  "fun_array": rel_err(fa_d, fa_64), "grad": rel_err(g_d, g_64)}
        eager_64 = {"value": rel(v_e, v_64), "grad": rel_err(g_e, g_64)}
        grad_bound = max(TOL_F64["grad_rel"],
                         GRAD_NOISE_FACTOR * eager_64["grad"])
        print("phase j8: design merit on K7 vs the eager float64 path: "
              f"{json.dumps(err_64)}; the eager float32 path's own "
              f"{json.dumps(eager_64)}; tolerances loss_rel "
              f"{TOL_F64['loss_rel']}, grad {grad_bound!r} (the larger of "
              f"grad_rel and {GRAD_NOISE_FACTOR}x the eager float32 error)")
        check(max(err_64["sum_squared"], err_64["fun_array"])
              <= TOL_F64["loss_rel"] and err_64["grad"] <= grad_bound,
              "design merit vs float64")
        del p_d64, lens_d64, merit_64, fa_64, v_64, g_64, v_e, g_e
        free()
        design_ms = {}
        for key, fn in (
                ("merit", lambda: p_d.sum_squared()),
                ("value_and_grad", lambda: c_d["value_and_grad"](x_d, pr_d)),
                ("residual_jac", lambda: c_d["residual_jac"](x_d, pr_d))):
            design_ms[key] = timed_call(fn)
        # the merit's split: each operand on its own, and the hexapolar
        # pupil that each RMS operand makes on the host
        merit_split = {f"{i} {o.operand_type}": timed_call(
            lambda o=o: design_operands.REGISTRY[o.operand_type](
                st_d, pr_d, **o.input_data))[0]
            for i, o in enumerate(p_d.operands)}
        merit_split["hexapolar pupil (host)"] = timed_call(
            lambda: dist.generate("hexapolar", DESIGN_RINGS))[0]
        print(f"phase j8: the design merit's split, host clock (ms): "
              f"{json.dumps(merit_split)}")
        J_d = c_d["residual_jac"](x_d, pr_d)
        check(J_d.shape == (6, 9) and bool(torch.isfinite(J_d).all()),
              "residual Jacobian: 6 x 9, finite")
        px_d, py_d = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in dist.generate("hexapolar", DESIGN_RINGS))
        *k7_d, err_k7d = j7_history(
            "bench lens, design loop", st_d, pr_d,
            (torch.zeros_like(px_d), torch.ones_like(px_d), px_d, py_d,
             torch.tensor(WAVELENGTH, device=dev)))
        j3["K7 (bench lens, design loop)"] = (
            *k7_d, design_ms["value_and_grad"][1][0], err_k7d)
        del px_d, py_d
        free()
        # 5 Adam steps: K7 in every step
        step_counts = []

        def on_step(i, loss):
            step_counts.append((read_counts()["K7"], backward_passes[0]))

        metrics = []
        reset_counts()
        backward_passes[0] = 0
        res_a = AdamOptimizer(p_d, lr=1e-3).optimize(
            n_steps=5, metrics=metrics, callback=on_step)
        per_step = [(a[0] - b[0], a[1] - b[1]) for a, b in
                    zip(step_counts, [(0, 0)] + step_counts[:-1])]
        design_ms["Adam step"] = (
            float(np.median([1e3 * m["step_time_s"] for m in metrics])),
            per_step[-1])
        print(f"phase j8: 5 Adam steps (lr 1e-3): losses "
              f"{res_a.loss_history}, (K7 launches, backward passes) a step "
              f"{per_step}")
        check(all(k >= 1 for k, _ in per_step), "K7 in every Adam step")
        check(all(math.isfinite(v) for v in res_a.loss_history)
              and res_a.loss_history[-1] < res_a.loss_history[0],
              "Adam: finite losses, the last below the first")
        start_g = p_d.sum_squared().item()
        res_g = OptimizerGeneric(p_d).optimize(maxiter=3)
        end_g = p_d.sum_squared().item()
        r_ls = p_d.residual_vector()
        start_ls = 0.5 * float((r_ls.double() ** 2).sum())
        res_ls = LeastSquares(p_d).optimize(maxiter=3)
        print(f"phase j8: OptimizerGeneric(maxiter=3) merit {start_g!r} -> "
              f"{end_g!r} ({res_g.nfev} evaluations); LeastSquares(maxiter=3)"
              f" cost {start_ls!r} -> {float(res_ls.cost)!r} ({res_ls.nfev} "
              "evaluations)")
        check(math.isfinite(end_g) and end_g <= start_g,
              "OptimizerGeneric: finite, no worse than its start")
        check(math.isfinite(res_ls.cost) and res_ls.cost <= start_ls,
              "LeastSquares: finite, no worse than its start")
        del p_d, c_d, lens_d, J_d
        free()

        # (b) the Cooke triplet's tolerancing: 16 draws (seed 1) and a
        # 5-step sweep of R1 through pipeline_batch, float32 on K7 against
        # its plain version and the eager float64 path
        lens_t = CookeTriplet()
        st_t, pr_t = lens_t.build(device="cuda")
        tol32 = cooke_tolerancing(tolerancing, lens_t)
        with precision("float64"):
            lens_t64 = CookeTriplet()
            lens_t64.build(device="cuda")
            tol64 = cooke_tolerancing(tolerancing, lens_t64)
        draws = tol32.draw_table(TOLERANCING_DRAWS, seed=1)
        check(np.array_equal(draws, tol64.draw_table(TOLERANCING_DRAWS,
                                                     seed=1)), "draw table")
        nominal = [float(p.variable.get(pr_t)) for p in tol32.perturbations]
        sweep = np.tile(nominal, (5, 1))
        sweep[:, 0] = tolerancing.RangeSampler(21.9, 22.1, 5).sample(None, 5)
        c_t = tol32._compile()
        reset_counts()
        backward_passes[0] = 0
        t0 = synced()
        v32, x32 = c_t["pipeline_batch"](pr_t, draws)
        j8_times["tolerancing s a draw"] = (synced() - t0) / len(draws)
        got_t = read_counts()
        s32, _ = c_t["pipeline_batch"](pr_t, sweep)
        print(f"phase j8: tolerancing, {len(draws)} draws: launches {got_t},"
              f" backward passes {backward_passes[0]}")
        check(got_t["K7"] >= len(draws) and sum(got_t.values())
              == got_t["K7"], f"tolerancing draws launched K7: {got_t}")
        with plain_k7():
            vp, xp = c_t["pipeline_batch"](pr_t, draws)
            sp, _ = c_t["pipeline_batch"](pr_t, sweep)
        with precision("float64"):
            c64 = tol64._compile()
            v64, x64 = c64["pipeline_batch"](tol64._nominal_params, draws)
            s64, _ = c64["pipeline_batch"](tol64._nominal_params, sweep)

        def gap_mm(x):
            return tol32.compensators[0].scaler.inverse_scale(x.double())

        def tol_errs(v, x, s):
            return {"f2": rel(v[:, 0], v64[:, 0]),
                    "rms_spot_size": rel(v[:, 1], v64[:, 1]),
                    "sweep": rel(s, s64),
                    "compensator_mm": (gap_mm(x) - gap_mm(x64)).abs().max(
                    ).item()}

        err_t, noise_t = tol_errs(v32, x32, s32), tol_errs(vp, xp, sp)
        base = {"f2": TOL_F64["loss_rel"], "rms_spot_size": TOL_F64[
            "loss_rel"], "sweep": TOL_F64["loss_rel"],
            "compensator_mm": TOL_F64["position_mm"]}
        bound_t = {k: max(base[k], GRAD_NOISE_FACTOR * noise_t[k])
                   for k in base}
        print(f"phase j8: tolerancing on K7 vs the eager float64 path "
              f"(operands relative, the compensator in mm): "
              f"{json.dumps(err_t)}; K7's plain version's own "
              f"{json.dumps(noise_t)}; bounds {json.dumps(bound_t)}; "
              f"{j8_times['tolerancing s a draw']:.4f} s a draw")
        check(all(err_t[k] <= bound_t[k] for k in base),
              "tolerancing vs float64")
        px_t, py_t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in dist.generate("hexapolar", TOLERANCING_RINGS))
        *k7_t, err_k7t = j7_history(
            "Cooke triplet, tolerancing", st_t, pr_t,
            (torch.zeros_like(px_t), torch.zeros_like(px_t), px_t, py_t,
             torch.tensor(0.55, device=dev)))
        j3["K7 (Cooke triplet, tolerancing)"] = (*k7_t, got_t["K7"],
                                                  err_k7t)
        del tol32, tol64, lens_t, lens_t64, c_t, c64
        free()

        # (c) GlassExpert on the Cooke triplet's glass after surface 3
        lens_g = CookeTriplet()
        lens_g.build(device="cuda")
        p_g = OptimizationProblem(lens_g)
        p_g.add_operand("rms_spot_size", target=0.0, weight=10.0, input_data=
                        dict(surface_number=-1, Hx=0.0, Hy=0.0, num_rays=16,
                             wavelength=0.55))
        p_g.add_operand("f2", target=50.0)
        p_g.add_variable(lens_g, "radius", surface_number=3)
        p_g.add_variable(lens_g, "radius", surface_number=4)
        built_late = []

        def logged_compile(jobs, _compile=_build._compile):
            out = _compile(jobs)
            built_late.extend((name, round(sec, 2))
                              for name, (_, sec) in out.items() if sec > 0)
            return out

        start_ge = p_g.sum_squared().item()
        reset_counts()
        with swapped(_build, "_compile", logged_compile):
            t0 = synced()
            GlassExpert(p_g, glass_surfaces=[3],
                        glass_selection=list(GLASSES_J8), pool_size=3,
                        num_neighbours=2).optimize(maxiter=10)
            j8_times["GlassExpert s"] = synced() - t0
        got_g = read_counts()
        end_ge = p_g.sum_squared().item()
        print(f"phase j8: GlassExpert over {list(GLASSES_J8)}: merit "
              f"{start_ge!r} -> {end_ge!r}, glass "
              f"{lens_g.surfaces.specs[3].material.name}, launches {got_g}; "
              f"K7 variants built at first use (name, s): {built_late}")
        check(got_g["K7"] >= 1, "GlassExpert launched K7")
        check(math.isfinite(end_ge) and end_ge <= start_ge,
              "GlassExpert: no worse than the start")
        del p_g, lens_g
        free()

    # (d) environment/, no kernel: float64 on the card against the CPU
    w_env = torch.linspace(0.35, 2.5, ENV_WAVELENGTHS, dtype=torch.float64)
    conds = (environment.EnvironmentalConditions(),
             environment.EnvironmentalConditions(
                 pressure=90000.0, temperature=30.0, relative_humidity=0.6,
                 co2_ppm=450.0),
             environment.EnvironmentalConditions(
                 temperature=-10.0, relative_humidity=0.3))
    bk7 = resolve_material("N-BK7")

    def env_values(w):
        out = {}
        for i, c in enumerate(conds):
            p_atm = c.pressure / 101325.0
            for m in ("ciddor", "edlen", "birch_downs", "kohlrausch"):
                out[f"{m} {i}"] = environment.refractive_index_air(w, c, m)
            out[f"nair_zemax {i}"] = environment.nair_zemax(
                w, c.temperature, p_atm)
            out[f"relative_wavelength {i}"] = environment.relative_wavelength(
                w, c.temperature, p_atm)
            out[f"schott {i}"] = environment.schott_thermal_correction(
                1.5 + 0.01 / w**2, w, bk7.therm, bk7.t0, c.temperature, p_atm)
        return out

    reset_counts()
    env_card = env_values(w_env.to(dev))
    env_cpu = env_values(w_env)
    check(sum(read_counts().values()) == 0, "environment/: no kernel")
    check(all(v.is_cuda and v.dtype == torch.float64
              for v in env_card.values()), "environment/ on the card")
    env_err = max(rel(env_card[k], env_cpu[k]) for k in env_cpu)
    print(f"phase j8: environment/ ({len(env_cpu)} evaluations of "
          f"{ENV_WAVELENGTHS} wavelengths) float64, card vs CPU, largest "
          f"relative difference {env_err!r} (tolerance {TOL_ENV})")
    check(env_err <= TOL_ENV, "environment/ card vs CPU")
    j8_times.update({f"{k} ms": v[0] for k, v in design_ms.items()})
    print(f"phase j8 ({smi}): design loop at {n_design} rays a field, host "
          f"clock (ms, (K7 launches, backward passes) of one call): "
          f"{json.dumps(design_ms)}; {json.dumps(j8_times)}; phase j8 "
          f"{time.perf_counter() - t_j8:.1f} s")

    # 16i. (j9) polarization, thin films, BSDFs and the vectorial wave
    # optics: eager on the card, as JAX's gates send them; no kernel
    j9_s = phase_j9(dev, reset_counts, read_counts, smi)
    print(f"phase j9 ({smi}): seconds {json.dumps(j9_s)}")
    free()

    # 16j. (j10) the analyses on the Cooke triplet: the spot diagram at
    # full width through K7, every other analysis at its defaults, float32
    # against float64 on the card
    j10_s, j10_k7 = phase_j10(dev, reset_counts, read_counts, smi)
    print(f"phase j10 ({smi}): seconds {json.dumps(j10_s)}")
    check(j10_k7 is not None, "phase j10 timed K7")
    free()

    # 16k. (j11) ray-batch sharding (parallel/): one-rank NCCL meshes, two
    # spawned gloo ranks on the card, the tolerancing's draws split over
    # them; then fileio/, ml/, visualization/ and sources/
    j11_s, j11_rows = phase_j11(dev, reset_counts, read_counts, smi)
    j11_kernels = j11_rows.pop("kernels")
    print(f"phase j11 ({smi}): seconds {json.dumps(j11_s)}; steps, host "
          f"clock, and kernels, median launch span, median of "
          f"{J11_TIMED_STEPS} (ms) {json.dumps(j11_rows)}")
    free()

    # 17. (k) the user's entry: Optic.trace on the card
    reset_counts()
    h_user = CookeTriplet().trace(Hx=0, Hy=1, num_rays=6)
    user_launches = read_counts()
    print(f"CookeTriplet().trace(Hx=0, Hy=1, num_rays=6) launches: "
          f"{user_launches}, history shape {tuple(h_user.x.shape)}")
    check(user_launches["K7"] == 1, "Optic.trace launched K7")
    check(h_user.x.shape == (8, 127) and h_user.x.is_cuda
          and all(bool(torch.isfinite(v).all()) for v in as_tuple(h_user)),
          "Optic.trace history: shape, device, finite")


    # 18. (w1) K8 against its plain version, on the inputs of the Cooke
    # triplet's ScalarHuygensPSF at its defaults (field (0, 1)) and of
    # HuygensMTF's (on axis, 64 x 64)
    t_wave = time.perf_counter()
    print(f"phases before the wave optics: {t_wave - t_start:.1f} s")
    lens32 = CookeTriplet()

    def as64(args):
        return tuple(tuple(a.double() for a in x) if isinstance(x, tuple)
                     else (x.double() if torch.is_tensor(x) else x)
                     for x in args)

    def normalized(fn, image_args, peak_args):
        return fn(*image_args) / fn(*peak_args)[0, 0] * 100.0

    reset_counts()
    img_args, peak_args, _, _, _ = huygens.huygens_psf_sums(
        lens32, (0.0, 1.0), 0.55, 128, 128, device="cuda")
    n_img, n_pup = img_args[0][0].numel(), img_args[1][0].numel()
    check(n_img == 16384 and n_pup == 16384, "PSF defaults: 128 x 128 x 2")
    psf_k8 = normalized(huygens.huygens_sum_forward, img_args, peak_args)
    psf_k8_again = normalized(huygens.huygens_sum_forward, img_args,
                              peak_args)
    psf_32 = normalized(huygens.huygens_sum_plain, img_args, peak_args)
    psf_64 = normalized(huygens.huygens_sum_plain, as64(img_args),
                        as64(peak_args))
    peak64 = psf_64.abs().max().item()
    c = 64
    k8_err = {
        "psf_of_peak": max_abs(psf_k8, psf_64) / peak64,
        "plain32_psf_of_peak": max_abs(psf_32, psf_64) / peak64,
        "strehl": abs(psf_k8[c, c].item() - psf_64[c, c].item()) / 100.0,
        "plain32_strehl": abs(psf_32[c, c].item()
                              - psf_64[c, c].item()) / 100.0,
        "strehl64": psf_64[c, c].item() / 100.0,
    }
    k8_abs = max_abs(psf_k8, psf_64)   # in the PSF's units (ideal peak 100)
    mtf_args = huygens.huygens_psf_sums(lens32, (0, 0), 0.55, 64, 64,
                                        device="cuda")[:2]
    mtf_k8 = mtf_slices(normalized(huygens.huygens_sum_forward, *mtf_args))
    mtf_64 = mtf_slices(normalized(huygens.huygens_sum_plain,
                                   *(as64(a) for a in mtf_args)))
    k8_err["mtf"] = max(max_abs(a, b) for a, b in zip(mtf_k8, mtf_64))
    w1_launches = read_counts()
    check(w1_launches["K8"] == 6 and w1_launches["K7"] >= 6,
          f"w1 launched K8 (3 x image and peak) and K7: {w1_launches}")
    print("K8 vs the float64 plain version on the same float32 inputs "
          f"(PSF defaults, field (0, 1); MTF defaults, on axis): "
          f"{json.dumps(k8_err)} tolerances {json.dumps(TOL_K8)}")
    check(torch.equal(psf_k8, psf_k8_again), "K8 bitwise over two launches")
    check(k8_err["psf_of_peak"] <= TOL_K8["psf_of_peak"], "K8 psf vs f64")
    check(k8_err["psf_of_peak"] <= TOL_K8["plain_factor"]
          * k8_err["plain32_psf_of_peak"], "K8 within 2x plain f32's error")
    check(k8_err["strehl"] <= TOL_K8["strehl"], "K8 Strehl vs f64")
    check(k8_err["mtf"] <= TOL_K8["mtf"], "K8 MTF vs f64")
    del psf_k8_again, psf_32, psf_64, mtf_args
    free()
    # the PSF's normalizing peak sum alone (1 image point, 16384 samples)
    # and the random inputs of tools/bench_wave_optics.py (OPD to 20 mm),
    # each raw sum relative to its float64 largest value
    k8_more = {}
    for label, args in (("peak_sum", peak_args),
                        ("bench_wave_optics", bench_wave_optics_args(dev))):
        got = huygens.huygens_sum_forward(*args)
        again = huygens.huygens_sum_forward(*args)
        ref = huygens.huygens_sum_plain(*as64(args))
        top = ref.abs().max().item()
        k8_more[label] = {
            "psf_of_peak": max_abs(got, ref) / top,
            "plain32_psf_of_peak": max_abs(
                huygens.huygens_sum_plain(*args), ref) / top,
            "bitwise": bool(torch.equal(got, again))}
        del got, again, ref
        free()
    print("K8 vs the float64 plain version, peak sum and bench_wave_optics "
          f"inputs: {json.dumps(k8_more)} tolerances {json.dumps(TOL_K8)}")
    for label, e in k8_more.items():
        check(e["bitwise"], f"K8 bitwise over two launches ({label})")
        check(e["psf_of_peak"] <= TOL_K8["psf_of_peak"], f"K8 {label} vs f64")
        check(e["psf_of_peak"] <= TOL_K8["plain_factor"]
              * e["plain32_psf_of_peak"], f"K8 {label} within 2x plain f32's")

    # 19. (w2) ScalarHuygensPSF at its defaults, float32 against float64
    config.set_precision("float64")
    lens64 = CookeTriplet()
    config.set_precision("float32")
    wave_err, psf_launches = {}, {}
    for field in ((0.0, 0.0), (0.0, 1.0)):
        reset_counts()
        p32 = ScalarHuygensPSF(lens32, field)
        psf_launches[str(field)] = read_counts()
        check(psf_launches[str(field)]["K8"] == 2
              and psf_launches[str(field)]["K7"] >= 3,
              f"ScalarHuygensPSF {field} launched K7 and K8 (image, peak)")
        config.set_precision("float64")
        p64 = ScalarHuygensPSF(lens64, field)
        check(read_counts() == psf_launches[str(field)],
              "float64 Huygens PSF ran the plain version")
        config.set_precision("float32")
        check(p32.psf.shape == (128, 128) and p32.psf.dtype == torch.float32
              and bool(torch.isfinite(p32.psf).all()),
              "Huygens PSF: shape, dtype, finite")
        wave_err[f"psf {field}"] = {
            "psf_of_peak": max_abs(p32.psf, p64.psf) / p64.psf.max().item(),
            "strehl": abs(p32.strehl_ratio().item()
                          - p64.strehl_ratio().item()),
            "strehl32": p32.strehl_ratio().item(),
            "strehl64": p64.strehl_ratio().item(),
            "cx_mm": abs(p32.cx.item() - p64.cx.item()),
            "cy_mm": abs(p32.cy.item() - p64.cy.item()),
            "pixel_pitch_rel": abs(p32.pixel_pitch.item()
                                   / p64.pixel_pitch.item() - 1.0),
        }
        e = wave_err[f"psf {field}"]
        check(e["psf_of_peak"] <= TOL_WAVE["huygens_psf_of_peak"]
              and e["strehl"] <= TOL_WAVE["huygens_strehl"]
              and e["cx_mm"] <= TOL_WAVE["centroid_mm"]
              and e["cy_mm"] <= TOL_WAVE["centroid_mm"]
              and e["pixel_pitch_rel"] <= TOL_WAVE["pixel_pitch_rel"],
              f"Huygens PSF {field} vs f64: {e}")
    print(f"ScalarHuygensPSF launches {json.dumps(psf_launches)}")
    del p32, p64

    # 20. (w3) HuygensMTF at its defaults
    reset_counts()
    m32 = HuygensMTF(lens32, (0, 0), 0.55)
    mtf_launches = read_counts()
    check(mtf_launches["K8"] == 2, "HuygensMTF launched K8")
    config.set_precision("float64")
    m64 = HuygensMTF(lens64, (0, 0), 0.55)
    config.set_precision("float32")
    check(read_counts() == mtf_launches, "float64 Huygens MTF ran plain")
    check(all(m.shape == (32,) and bool(torch.isfinite(m).all())
              for m in m32.mtf), "Huygens MTF: shape, finite")
    wave_err["huygens_mtf"] = max(max_abs(a, b)
                                  for a, b in zip(m32.mtf, m64.mtf))
    check(wave_err["huygens_mtf"] <= TOL_WAVE["huygens_mtf"],
          "Huygens MTF vs f64")
    print(f"HuygensMTF launches {json.dumps(mtf_launches)}")

    # 21. (w4) the FFT and MMDFT PSFs, the FFT MTF over all fields, the
    # sampled MTF and the Zernike OPD at their defaults; K7 under them
    reset_counts()
    an32 = dict(fft=ScalarFFTPSF(lens32, (0.0, 1.0)),
                mmdft=MMDFTPSF(lens32, (0.0, 1.0)),
                fftmtf=ScalarFFTMTF(lens32),
                smtf=SampledMTF(lens32, (0.0, 1.0)),
                zopd=ZernikeOPD(lens32, (0.0, 1.0)))
    smtf32 = an32["smtf"].calculate_mtf(SAMPLED_FREQS)
    an_launches = read_counts()
    check(an_launches["K7"] >= 9, "the FFT analyses ran K7")
    config.set_precision("float64")
    an64 = dict(fft=ScalarFFTPSF(lens64, (0.0, 1.0)),
                mmdft=MMDFTPSF(lens64, (0.0, 1.0)),
                fftmtf=ScalarFFTMTF(lens64),
                smtf=SampledMTF(lens64, (0.0, 1.0)),
                zopd=ZernikeOPD(lens64, (0.0, 1.0)))
    smtf64 = an64["smtf"].calculate_mtf(SAMPLED_FREQS)
    config.set_precision("float32")
    check(read_counts() == an_launches, "float64 FFT analyses ran eager")
    for key in ("fft", "mmdft"):
        a, b = an32[key], an64[key]
        check(bool(torch.isfinite(a.psf).all()), f"{key}: finite")
        wave_err[key] = {
            "psf_of_peak": max_abs(a.psf, b.psf) / b.psf.max().item(),
            "strehl": abs(a.strehl_ratio().item() - b.strehl_ratio().item()),
            "strehl64": b.strehl_ratio().item()}
        check(wave_err[key]["psf_of_peak"] <= TOL_WAVE["fft_psf_of_peak"]
              and wave_err[key]["strehl"] <= TOL_WAVE["fft_strehl"],
              f"{key} vs f64")
    check(an32["fft"].pupils.dtype == torch.complex64, "complex64 pupils")
    wave_err["fft_mtf"] = max(max_abs(a, b) for k in range(3)
                              for a, b in zip(an32["fftmtf"].mtf[k],
                                              an64["fftmtf"].mtf[k]))
    wave_err["sampled_mtf"] = float(np.max(np.abs(np.subtract(smtf32,
                                                              smtf64))))
    wave_err["zernike_waves"] = max_abs(an32["zopd"].coeffs,
                                        an64["zopd"].coeffs)
    wave_err["rms_rel"] = abs(an32["zopd"].rms().item()
                              / an64["zopd"].rms().item() - 1.0)
    for key in ("fft_mtf", "sampled_mtf", "zernike_waves", "rms_rel"):
        check(wave_err[key] <= TOL_WAVE[key], f"{key} vs f64")
    print(f"FFT analyses launches {json.dumps(an_launches)}")
    print("wave optics, float32 against float64 on the card: "
          f"{json.dumps(wave_err)} tolerances {json.dumps(TOL_WAVE)}")
    del an32, an64, m32, m64
    free()
    print(f"wave-optics phases: {time.perf_counter() - t_wave:.1f} s")

    # 13. (g) times and bounds, at the main paths' shapes. A kernel's time
    # is its bare launch (tables packed once, outside the timed region);
    # these launches bypass the wrappers and their counters.
    n, head, ptrs, keep_alive = fused._launch_args(static, p[2], p[0], p[1],
                                                   data, "K3")
    k1_fn, k1_args, k1_partials, k1_keep = fused.k1_launch(static, *p, data)
    k1c_fn, k1c_args, k1c_partials, k1c_keep = fused.k1_launch(
        static_c, *pc, data_c)
    k3_fn, k3_args, k3_outs, k3_keep = fused.k3_launch(static, *p, data,
                                                       keys)
    k3c_fn, k3c_args, k3c_outs, k3c_keep = fused.k3_launch(
        static_c, *pc, data_c, keys)
    nv, head_v, ptrs_v, keep_alive_v = fused._caller_ray_args(
        static_v, *p_v, rays8, "K6")
    k5_fn, k5_args, k5_outs, k5_keep = fused.k5_launch(static_v, *p_v,
                                                       rays8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    S = static.num_surfaces
    # the backward kernels' persistent grids, from the wrappers' helper
    n_sm = config.sm_count(dev)
    grid = {"K2": fused.backward_grid(n, n_sm),
            "K4": fused.backward_grid(n, n_sm),
            "K6": fused.backward_grid(nv, n_sm)}
    print(f"backward grids (blocks, threads) at these shapes: "
          f"{json.dumps(grid)}, {n_sm} SMs")
    partials_bwd = torch.empty((max(b for b, _ in grid.values()), S + 1,
                                fused._F_STRIDE), device=dev)
    outs = [torch.empty(n, device=dev) for _ in range(8)]
    c32 = c_loss.float().contiguous()
    k4_s8, k4_sp = fused._seed_ptrs([dict(zip(k4_keys, k4_seeds)).get(k)
                                     for k in range(8)], n, dev)
    k6_s8, k6_sp = fused._seed_ptrs(k6_seeds, nv, dev)
    k7_fn, k7_args, k7_outs, k7_keep = fused.k7_launch(static_c, *p7, rays9)

    def k8_launch_args(args):
        """Chunk, k, pointers (Rp, 3 image, 5 pupil arrays) and the partial
        buffer of a bare K8 launch on a Huygens sum's arguments, and the
        tensors to keep alive while it may run."""
        image, pupil, amp, opd, wl_mm, Rp = args
        flat = [a.reshape(-1).contiguous() for a in image] + [
            a.contiguous() for a in (*pupil, amp, opd)]
        rp = Rp.reshape(1).contiguous()
        ni, npu = flat[0].numel(), flat[3].numel()
        chunk = huygens.pupil_chunk(ni, npu, config.sm_count(dev))
        partial = torch.empty((-(-npu // chunk), 2, ni), device=dev)
        return (chunk, huygens.inv_wavelength(wl_mm),
                [rp.data_ptr()] + [a.data_ptr() for a in flat], partial,
                (flat, rp))

    k8_chunk, k8_k, k8_ptrs, k8_partial, k8_keep = k8_launch_args(img_args)

    def launch(name, *args):
        err = fused._kernel(name)(*args, stream)
        check(err == 0, f"{name} launch: cudaError {err}")

    def launch_variant(fn, args):
        """A bare launch of a per-system variant (K1, K3, K5, K7)."""
        err = fn(*args, stream)
        check(err == 0, f"{fn.__name__} launch: cudaError {err}")

    def launch_k8(*args):
        err = huygens._kernel()(*args, stream)
        check(err == 0, f"huygens_sum launch: cudaError {err}")

    launches = {
        "K1": lambda: launch_variant(k1_fn, k1_args),
        "K2": lambda: launch("moments_bwd", *head, *grid["K2"], 0, *ptrs,
                             c32.data_ptr(), partials_bwd.data_ptr(), None,
                             None, None, None),
        "K3": lambda: launch_variant(k3_fn, k3_args),
        "K4": lambda: launch("raygen_trace_bwd", *head, *grid["K4"], *ptrs,
                             *k4_sp, partials_bwd.data_ptr(),
                             *(o.data_ptr() for o in outs[:4])),
        "K5": lambda: launch_variant(k5_fn, k5_args),
        "K6": lambda: launch("fused_trace_bwd", *head_v, *grid["K6"],
                             *ptrs_v, *k6_sp, partials_bwd.data_ptr(),
                             *(o.data_ptr() for o in outs)),
        "K7": lambda: launch_variant(k7_fn, k7_args),
        "K8": lambda: launch_k8(n_img, n_pup, k8_chunk, *k8_k, *k8_ptrs,
                                k8_partial.data_ptr()),
    }
    plains = {
        "K1": lambda: fused._moments_plain(static, *p, data),
        "K2": lambda: fused._moments_bwd_plain(static, *p, data, c_loss,
                                               False),
        "K3": lambda: fused._raygen_trace_plain(static, *p, data, keys),
        "K4": lambda: fused._raygen_trace_bwd_plain(static, *p, data,
                                                    k4_keys, k4_seeds),
        "K5": lambda: fused._fused_trace_plain(static_v, *p_v, rays8),
        "K6": lambda: fused._fused_trace_bwd_plain(static_v, *p_v, rays8,
                                                   k6_seeds),
        "K7": lambda: fused._history_plain(static_c, *p7, rays9),
        "K8": lambda: huygens.huygens_sum_plain(*img_args),
    }
    fwd_ops = chain_ops_per_ray(static, fused)
    bwd_ops = backward_ops_per_ray(static, fused)
    caller_fwd_ops = chain_ops_per_ray(static_v, fused) - 32
    caller_bwd_ops = backward_ops_per_ray(static_v, fused, raygen=False)
    hist_ops = history_ops_per_ray(static_c, fused)
    bounds = {   # (bytes, operations) of each function at these inputs
        "K1": (4 * 4 * n, (fwd_ops + 10) * n),
        "K2": (4 * 4 * n, (bwd_ops + 8) * n),
        "K3": ((4 + 8) * 4 * n, fwd_ops * n),
        "K4": ((4 + len(k4_keys) + 4) * 4 * n, bwd_ops * n),
        "K5": ((8 + 8) * 4 * nv, caller_fwd_ops * nv),
        "K6": ((7 + 8 + 8) * 4 * nv, caller_bwd_ops * nv),
        # 9 arrays in, 8 (S, n) arrays out (row 0 the input bundle)
        "K7": ((9 + 8 * S_c) * 4 * n_c, hist_ops * n_c),
        "K8": huygens_bound(n_img, n_pup),
    }
    fused_py = "optiland_tpu/trace/fused.py"
    meta = {
        "K1": ("_moments_forward", "moments_fwd.cu", f"{fused_py}:1431",
               k1_abs, fwd_launches),
        "K2": ("_moments_bwd", "moments_bwd.cu", f"{fused_py}:1509", k2_abs,
               train_launches),
        "K3": ("_raygen_forward", "raygen_trace_fwd.cu", f"{fused_py}:1011",
               max(v for k, v in k3_err.items() if k != "intensity_frac"),
               fwd_launches),
        "K4": ("_raygen_bwd", "raygen_trace_bwd.cu", f"{fused_py}:1078",
               k4_abs, final_launches),
        "K5": ("_fused_forward", "fused_trace_fwd.cu", f"{fused_py}:848",
               max(v for k, v in k5_err.items() if k != "intensity_frac"),
               caller_launches),
        "K6": ("_fused_bwd", "fused_trace_bwd.cu", f"{fused_py}:900", k6_abs,
               caller_launches),
        "K7": ("_history_forward", "history_fwd.cu", f"{fused_py}:1258",
               k7_abs, hist_launches),
        # launches: the Huygens PSF at field (0, 1) (image and peak);
        # max_abs_err: of that PSF, normalized to an ideal peak of 100
        "K8": ("huygens_sum_pallas", "huygens_sum.cu",
               "optiland_tpu/psf/huygens.py:127", k8_abs,
               psf_launches[str((0.0, 1.0))]),
    }
    rows = []
    for key, (fn_name, src, replaces, err, path_launches) in meta.items():
        b_ms, b_by = bound_ms(*bounds[key])
        rows.append(dict(
            name=f"{key} {fn_name}", route="cuda",
            source=f"optiland_tpu_torch/csrc/{src}",
            replaces=replaces,
            launches=path_launches[key], max_abs_err=err,
            ms=time_ms(launches[key]),
            plain_ms=time_ms(plains[key], calls=PLAIN_CALLS, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        free()
    sfu_rate, max_mhz = sfu_per_s(n_sm)
    print(f"special-function rate {sfu_rate:.6g}/s ({n_sm} SMs x "
          f"{SFU_PER_CLOCK_SM} a clock x {max_mhz:.0f} MHz); T1 "
          f"special-function instructions an element {json.dumps(T1_SFU)}")
    for name in vpu_peak.CHAINS:   # T1: input read once, output written once
        fn_name, replaces = T1_REPLACES[name]
        if name in T1_SFU:
            b_ms, b_by = bound_ms(2 * 4 * x_t1.numel(),
                                  T1_SFU[name] * x_t1.numel(), sfu_rate)
        else:
            b_ms, b_by = bound_ms(2 * 4 * x_t1.numel(),
                                  T1_OPS[name] * x_t1.numel())
        rows.append(dict(
            name=f"T1 {fn_name}", route="cuda",
            source="optiland_tpu_torch/csrc/vpu_peak.cu", replaces=replaces,
            launches=t1_launches[f"T1 {name}"],
            max_abs_err=t1_err[name]["max_abs"], ms=1e3 * t1_runs[name][1],
            plain_ms=time_ms(lambda: plains_t1[name](x_t1)), bound_ms=b_ms,
            bound_by=b_by, library_ms=None))

    # the per-ray variants (the polychromatic merit's K1 and K2, K3 to K6 on
    # the paths above), at the flagship batch's 1,999,998 rays and at its
    # first 16,384: each kernel's time is the CUDA-event span around its C
    # launch inside the wrapper call (kernel_turns.timed_launches), the
    # median of 25
    spans, restore = kernel_turns.timed_launches(fused)
    def cut(arrays, m):
        return tuple(a[:m].contiguous() for a in arrays)

    def per_ray_calls(m):
        """The six per-ray wrapper calls on the first m rays."""
        d, r9 = cut(data_w, m), cut(rays9_w, m)
        s3, s8 = cut(k4w_seeds, m), cut(k6w_seeds, m)
        return {
            "K1": lambda: fused.moments_forward(static_c, *pw, d),
            "K2": lambda: fused.moments_backward(static_c, *pw, d, c_poly,
                                                 False),
            "K3": lambda: fused.raygen_trace_forward(static_c, *pw, d, keys),
            "K4": lambda: fused.raygen_trace_backward(static_c, *pw, d,
                                                      k4_keys, s3),
            "K5": lambda: fused.fused_trace_forward(static_c, *p5, r9),
            "K6": lambda: fused.fused_trace_backward(static_c, *p5, r9, s8)}

    media_ops = media_ops_per_ray(static_c)
    ops_w = {"K1": chain_ops_per_ray(static_c, fused) + 10,
             "K2": backward_ops_per_ray(static_c, fused) + 8,
             "K3": chain_ops_per_ray(static_c, fused),
             "K4": backward_ops_per_ray(static_c, fused),
             "K5": chain_ops_per_ray(static_c, fused) - 32,
             "K6": backward_ops_per_ray(static_c, fused, raygen=False)}
    # floats a ray moves: in (data or rays, seeds) and out (outputs,
    # cotangents; K2 without its data cotangents, as timed)
    floats_w = {"K1": 5, "K2": 5, "K3": 5 + 8, "K4": 5 + 3 + 5,
                "K5": 9 + 8, "K6": 9 + 8 + 9}
    plains_w = {
        "K1": lambda: fused._moments_plain(static_c, *pw, data_w),
        "K2": lambda: fused._moments_bwd_plain(static_c, *pw, data_w, c_poly,
                                               False),
        "K3": lambda: fused._raygen_trace_plain(static_c, *pw, data_w, keys),
        "K4": lambda: fused._raygen_trace_bwd_plain(static_c, *pw, data_w,
                                                    k4_keys, k4w_seeds),
        "K5": lambda: fused._fused_trace_plain(static_c, *p5, rays9_w),
        "K6": lambda: fused._fused_trace_bwd_plain(static_c, *p5, rays9_w,
                                                   k6w_seeds)}
    err_w = {"K1": k1w_abs, "K2": k2w_abs,
             "K3": max(v for k, v in k3w_err.items() if k != "intensity_frac"),
             "K4": k4w_abs,
             "K5": max(v for k, v in k5w_err.items() if k != "intensity_frac"),
             "K6": k6w_abs}
    path_w = {"K1": poly_launches, "K2": poly_launches,
              "K3": final_w_launches, "K4": final_w_launches,
              "K5": caller_w_launches, "K6": caller_w_launches}
    calls_w = {m: per_ray_calls(m) for m in (n_c, 16_384)}
    per_ray_ms = {}
    for key, (fn_name, src, replaces, _, _) in meta.items():
        if key not in ops_w:
            continue
        ms = {m: kernel_turns.launch_ms(calls_w[m][key], spans)
              for m in calls_w}
        per_ray_ms[key] = {"1999998": ms[n_c], "16384": ms[16_384],
                           "bound_16384": bound_ms(
                               floats_w[key] * 4 * 16_384,
                               (ops_w[key] + media_ops) * 16_384)[0]}
        b_ms, b_by = bound_ms(floats_w[key] * 4 * n_c,
                              (ops_w[key] + media_ops) * n_c)
        rows.append(dict(
            name=f"{key} {fn_name} (per-ray wavelengths)", route="cuda",
            source=f"optiland_tpu_torch/csrc/{src}", replaces=replaces,
            launches=path_w[key][key], max_abs_err=err_w[key], ms=ms[n_c],
            plain_ms=time_ms(plains_w[key], calls=PLAIN_CALLS, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        free()
    # phases j3-j6's configurations: the coating, thin-lens, grating,
    # phase and freeform branches, the wide rows and the long record on
    # systems A-L at the flagship batch's rays, each kernel's launch span
    # (median of 25) beside its plain version's time at its comparison's
    # own call (its first call, host clock), which the row's name says
    j3_ms = {}
    for key, (call, plain_ms, note, n_bytes, n_ops, n_launch,
              err) in j3.items():
        fn_name, src, replaces = meta[key[:2]][:3]
        j3_ms[key] = kernel_turns.launch_ms(call, spans)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rows.append(dict(
            name=f"{key[:2]} {fn_name} {key[3:-1]}; {note})", route="cuda",
            source=f"optiland_tpu_torch/csrc/{src}", replaces=replaces,
            launches=n_launch, max_abs_err=err, ms=j3_ms[key],
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        free()
    restore()
    print(f"phases j3-j6 kernels, median of {TIMED_CALLS} launch spans "
          f"(ms): {json.dumps(j3_ms)}")
    print(f"per-ray variants on the Cooke triplet, median of {TIMED_CALLS} "
          f"launch spans (ms), with the 16,384-ray bound: "
          f"{json.dumps(per_ray_ms)}; K2 wrapper on the tabulated doublet at "
          f"{n_c} rays (launch, partial sums, the tabulated glass's segment "
          f"sums) {k2d_ms:.4f} ms; media FP32 ops/ray {media_ops}")

    def host_ms(fn, calls=TIMED_STEPS):
        """Median host-clock time of `fn` between two synchronizes, after
        two warm-up calls."""
        def once():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t)

        for _ in range(2):
            once()
        return float(np.median([once() for _ in range(calls)]))

    step_ms = host_ms(train_step)
    wrap_ms = {
        "K1 wrapper": time_ms(lambda: fused.moments_forward(static, *p,
                                                             data)),
        "K2 wrapper": time_ms(lambda: fused.moments_backward(
            static, *p, data, c_loss, False)),
        "K3 wrapper": time_ms(lambda: fused.raygen_trace_forward(
            static, *p, data, keys)),
        "centroid_rms_spot": time_ms(lambda: centroid_rms_spot(
            static, params, Hx, Hy, Px, Py, WAVELENGTH)),
        "trace_system_final": time_ms(lambda: tracer.trace_system_final(
            static, params, Hx, Hy, Px, Py, WAVELENGTH)),
        "K1 wrapper (Cooke)": time_ms(lambda: fused.moments_forward(
            static_c, *pc, data_c)),
        "K2 wrapper (Cooke)": time_ms(lambda: fused.moments_backward(
            static_c, *pc, data_c, c_cooke, False)),
        "K7 wrapper (Cooke)": time_ms(lambda: fused.history_forward(
            static_c, *p7, rays9)),
    }
    print(f"end to end at 2M rays, float32, median of {TIMED_CALLS} (ms): "
          + json.dumps(wrap_ms) + f"; chain FP32 ops/ray {fwd_ops}, "
          f"backward {bwd_ops}, K7 (Cooke) {hist_ops}")
    print(f"training step (centroid_rms_spot diff_inputs=False, backward, "
          f"Adam) at 2M rays, host clock, median of {TIMED_STEPS}: "
          f"{step_ms:.4f} ms, {N_RAYS / step_ms * 1e3:.6g} rays/s")

    # the flagship forward and training step, and the step's split
    fwd_c_ms = host_ms(lambda: tracer.trace_system(static_c, params_c, *fb))
    # its split: the eager ray generation, then the history (K7's wrapper:
    # tables, output allocation, the launch) on those rays
    r0_c = generate_rays(static_c, params_c, *fb)
    fwd_split = {
        "generate_rays": host_ms(lambda: generate_rays(static_c, params_c,
                                                       *fb)),
        "trace_history_fused (K7)": host_ms(
            lambda: fused.trace_history_fused(static_c, params_c, r0_c))}
    del r0_c
    step_c_ms = host_ms(flagship_step)
    split = {"generate_rays": [], "K7 forward + merit": [],
             "backward (eager twin)": [], "Adam": []}
    for _ in range(TIMED_STEPS):
        opt_h.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r0 = generate_rays(static_c, p_a, *fb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = fused.trace_history_fused(static_c, p_a, r0)
        step_loss = flagship_merit(h)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step_loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        opt_h.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, a, b in zip(split, (t0, t1, t2, t3), (t1, t2, t3, t4)):
            split[key].append(1e3 * (b - a))
        del r0, h, step_loss
    split = {k: float(np.median(v)) for k, v in split.items()}
    torch.cuda.reset_peak_memory_stats()
    flagship_step()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the polychromatic step (per-ray K1, K2) and the monochromatic one of
    # phase (j) at 0.55 um, each with Adam over the same leaves
    poly_ms = host_ms(poly_step)
    leaves_m, p_m = leaves_of(params_c, names_p)
    opt_m = torch.optim.Adam(list(leaves_m.values()), lr=ADAM_LR)

    def mono_step():
        opt_m.zero_grad()
        centroid_rms_spot(static_c, p_m, *fb[:4], FLAGSHIP_WAVELENGTH,
                          diff_inputs=False).backward()
        opt_m.step()

    mono_ms = host_ms(mono_step)
    j3_step_ms = {f"system {k}": host_ms(v[1]) for k, v in j3_steps.items()}
    print(f"phases j3-j6 polychromatic training steps (centroid_rms_spot at "
          f"per-ray w, backward, Adam; per-ray K1 and K2) at {n_c} rays, "
          f"host clock, median of {TIMED_STEPS} (ms): "
          f"{json.dumps(j3_step_ms)}")
    print(f"flagship (Cooke triplet, {n_c} rays, float32) host clock, "
          f"median of {TIMED_STEPS}: polychromatic centroid_rms_spot step "
          f"(per-ray K1, K2, Adam over {len(leaves_q)} leaves) {poly_ms:.4f} "
          f"ms, {n_c / poly_ms * 1e3:.6g} rays/s; the monochromatic step at "
          f"{FLAGSHIP_WAVELENGTH} um (K1, K2) {mono_ms:.4f} ms; the "
          f"trace_system step below")
    print(f"flagship (Cooke triplet, {n_c} rays, float32) host clock, "
          f"median of {TIMED_STEPS}: trace_system {fwd_c_ms:.4f} ms, split "
          f"(ms) {json.dumps(fwd_split)}; "
          f"training step (merit, backward, Adam over {len(leaves_a)} "
          f"leaves) {step_c_ms:.4f} ms, {n_c / step_c_ms * 1e3:.6g} rays/s; "
          f"step split (ms) {json.dumps(split)}; step peak device memory "
          f"{peak_gb:.3f} GB")
    # K8 at four shapes beside its FP32 bound: the PSF's defaults (its row
    # in the kernels line) and their normalizing peak sum, the random inputs
    # of tools/bench_wave_optics.py (16384 image points x 8192 pupil
    # samples, opd up to 20 mm, so phases up to ~2.3e5 rad) and num_rays =
    # image_size = 256 (65536 x 65536); with the phase range each reduces
    big_args = huygens.huygens_psf_sums(lens32, (0.0, 1.0), 0.55, 256, 256,
                                        device="cuda")[0]
    k8_shapes = {}
    for label, args, with_plain in (
            ("psf_128", img_args, True), ("psf_128_peak", peak_args, True),
            ("bench_wave_optics", bench_wave_optics_args(dev), True),
            ("psf_256", big_args, False)):
        chunk, inv_wl, ptrs8, partial, _keep = k8_launch_args(args)
        ni, npu = args[0][0].numel(), args[1][0].numel()
        t_k8 = time_ms(lambda: launch_k8(ni, npu, chunk, *inv_wl, *ptrs8,
                                         partial.data_ptr()))
        b_ms, b_by = bound_ms(*huygens_bound(ni, npu))
        k8_shapes[label] = dict(
            image=ni, pupil=npu, chunks=partial.shape[0], ms=t_k8,
            bound_ms=b_ms, bound_by=b_by,
            contributions_per_s=ni * npu / (t_k8 * 1e-3),
            plain_ms=(time_ms(lambda: huygens.huygens_sum_plain(*args),
                              calls=PLAIN_CALLS, warmup=1)
                      if with_plain else None), **phase_reduction(args))
        del partial, _keep
        free()
    print(f"K8 at four shapes, median of {TIMED_CALLS} bare launches "
          f"({huygens_ops_per_contribution()} FP32 operations a "
          f"contribution): {json.dumps(k8_shapes)}")
    # the per-system variants, bare launches: the bench lens (K1's and K3's
    # rows in the kernels line; K5's vignetted twin has its row) and the
    # Cooke triplet at 0.55 um
    cooke_ops = chain_ops_per_ray(static_c, fused)
    sys_ms = {
        "K1 bench lens": time_ms(lambda: launch_variant(k1_fn, k1_args)),
        "K1 Cooke triplet": time_ms(lambda: launch_variant(k1c_fn,
                                                           k1c_args)),
        "K3 bench lens": time_ms(lambda: launch_variant(k3_fn, k3_args)),
        "K3 Cooke triplet": time_ms(lambda: launch_variant(k3c_fn,
                                                           k3c_args)),
        "K5 vignetted bench lens": time_ms(lambda: launch_variant(k5_fn,
                                                                  k5_args))}
    # K7 on the bundle of `wavefront_data` (field (0, 1), 0.55 um, the 128 x
    # 128 pupil grid of the Huygens PSF's defaults: 16,384 rays)
    px_b, py_b, _ = pupil_grid_coords(128, torch.float32, dev)
    r0_b = generate_rays(static_c, params_c, torch.zeros_like(px_b),
                         torch.ones_like(px_b), px_b, py_b, 0.55,
                         apply_vignetting=False)
    rays9_b = tuple(getattr(r0_b, k).detach().contiguous()
                    for k in fused._RAY_KEYS)
    k7b_fn, k7b_args, _, k7b_keep = fused.k7_launch(static_c, *p7, rays9_b)
    n_b = px_b.numel()
    sys_ms["K7 Cooke triplet, flagship"] = time_ms(
        lambda: launch_variant(k7_fn, k7_args))
    sys_ms["K7 Cooke triplet, 16,384-ray wavefront bundle"] = time_ms(
        lambda: launch_variant(k7b_fn, k7b_args))
    cooke_bounds = {"K1": bound_ms(4 * 4 * n_c, (cooke_ops + 10) * n_c),
                    "K3": bound_ms((4 + 8) * 4 * n_c, cooke_ops * n_c),
                    "K7": bound_ms(*bounds["K7"]),
                    "K7 16,384": bound_ms((9 + 8 * S_c) * 4 * n_b,
                                          hist_ops * n_b)}
    print(f"per-system variants, median of {TIMED_CALLS} bare launches (ms): "
          f"{json.dumps(sys_ms)}; grids (blocks) K1 bench {k1_args[2]}, "
          f"Cooke {k1c_args[2]}, K3 bench {k3_args[2]}, Cooke {k3c_args[2]}, "
          f"K5 {k5_args[2]}, K7 Cooke {k7_args[2]}, bundle {k7b_args[2]}; "
          f"Cooke bounds at {n_c} rays (K7 also at {n_b}) "
          f"{json.dumps(cooke_bounds)}")
    del r0_b, rays9_b, k7b_keep

    # the Huygens PSF call at its defaults on the host clock, and its split
    psf_ms = host_ms(lambda: ScalarHuygensPSF(lens32, (0.0, 1.0)))
    st32, pp32 = lens32.build(device="cuda")
    px_g, py_g, _ = pupil_grid_coords(128, torch.float32, dev)
    psf_split = {
        "wavefront_data (K7), field and ideal": 2 * host_ms(
            lambda: wavefront_data(st32, pp32, 0.0, 1.0, px_g, py_g, 0.55)),
        "spot trace (K7)": host_ms(lambda: lens32.trace(
            Hx=0.0, Hy=1.0, wavelength=0.55, num_rays=6)),
        "K8 (image and peak, wrapper)": host_ms(lambda: (
            huygens.huygens_sum(*img_args), huygens.huygens_sum(*peak_args))),
    }
    psf_split["rest"] = psf_ms - sum(psf_split.values())
    print(f"ScalarHuygensPSF(CookeTriplet(), (0, 1)) at its defaults, float32, "
          f"host clock, median of {TIMED_STEPS}: {psf_ms:.4f} ms; split (ms) "
          f"{json.dumps(psf_split)}")

    rows += j11_kernels
    whole = time.perf_counter() - t_start
    print(f"whole run: {whole:.1f} s (limit {RUN_LIMIT_S} s)")
    check(whole < RUN_LIMIT_S, "the whole run within its limit")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
