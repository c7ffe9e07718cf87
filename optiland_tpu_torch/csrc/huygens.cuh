// The per-image-point body of K8, the Huygens-Fresnel summation.
//
// Port of the arithmetic of `_huygens_kernel` in optiland_tpu/psf/huygens.py
// (and of its XLA twin `_field_contrib`): for an image point i and a pupil
// sample p on the reference sphere of radius Rp,
//   R = |i - p|,  cos(theta) = ((i - p) . p) / (R Rp),
//   field += amp (1 + cos(theta)) / 2 / R * exp(i k ((R - Rp) - opd)).
// The phase is referenced to Rp: k R itself is ~6e5 rad at Rp = 54 mm and
// 0.55 um, while k (R - Rp) keeps the sin/cos argument small, a constant
// phase that cancels in |field|^2.
//
// Plain arithmetic apart from `__device__`: tests/test_torch_chain_host.py
// compiles it with g++ in double and holds a host loop over it against the
// plain PyTorch version. IEEE sqrtf and division, the accurate sincosf (its
// slow range reduction above |phase| ~ 1.05e5 rad is correct, only slower);
// no fast-math.
#pragma once

namespace otk {

// Adds pupil sample p's contribution to the field (re, im) at image point i.
__device__ __forceinline__ void huygens_term(float ix, float iy, float iz, float ux, float uy,
                                             float uz, float amp, float opd, float k, float Rp,
                                             float& re, float& im) {
  const float dx = ix - ux;
  const float dy = iy - uy;
  const float dz = iz - uz;
  const float R = sqrtf(dx * dx + dy * dy + dz * dz);
  const float cos_theta = (dx * ux + dy * uy + dz * uz) / (R * Rp);
  const float scale = amp * (0.5f * (1.0f + cos_theta)) / R;
  const float phase = k * ((R - Rp) - opd);
  float s, c;
  sincosf(phase, &s, &c);
  re += scale * c;
  im += scale * s;
}

// Adds the contributions of the n pupil samples at ux[0..n) ... to (re, im):
// one thread's pass over one staged tile of the pupil.
__device__ __forceinline__ void huygens_accumulate(float ix, float iy, float iz, const float* ux,
                                                   const float* uy, const float* uz,
                                                   const float* amp, const float* opd, int n,
                                                   float k, float Rp, float& re, float& im) {
#pragma unroll 4
  for (int j = 0; j < n; ++j)
    huygens_term(ix, iy, iz, ux[j], uy[j], uz[j], amp[j], opd[j], k, Rp, re, im);
}

}  // namespace otk
