// The per-contribution body of K8, the Huygens-Fresnel summation.
//
// Port of the arithmetic of `_huygens_kernel` in optiland_tpu/psf/huygens.py
// (and of its XLA twin `_field_contrib`): for an image point i and a pupil
// sample p on the reference sphere of radius Rp,
//   R = |i - p|,  cos(theta) = ((i - p) . p) / (R Rp),
//   field += amp (1 + cos(theta)) / 2 / R * exp(i k ((R - Rp) - opd)).
// The phase is referenced to Rp: k R itself is ~6e5 rad at Rp = 54 mm and
// 0.55 um, while k (R - Rp) keeps it small, a constant phase that cancels
// in |field|^2.
//
// Arithmetic, for the H100's FP32 pipe and special-function unit, and more
// accurate than the float32 reference's steps (which round R ~ 54 mm to
// ~2e-6 mm, 0.02 rad of phase at k = 1.1e4 /mm, and an OPD of 20 mm to
// ~1e-6 mm after scaling, ~0.014 rad more):
//   - R - Rp is formed without forming R: e = R^2 - Rp^2 as dx^2 + dy^2 +
//     (dz - Rp)(dz + Rp), with dz - Rp = (iz - Rp) - uz (iz - Rp is one
//     rounding per image point, nearly a constant phase), then
//     R - Rp = e / (R + Rp), where R + Rp needs only float32's relative
//     precision;
//   - one reciprocal square root a contribution, rinv = rsqrtf(Rp^2 + e),
//     gives 1/R for the amplitude and for cos(theta), and R + Rp (~2e-7
//     relative, harmless there); the quotient is the approximate
//     __fdividef (2 ulp of R - Rp);
//   - the phase is taken in cycles and reduced exactly: the OPD's share,
//     frac(opd / lambda), is formed once per pupil sample in double-float
//     (`stage_sample`), so c = (R - Rp) / lambda - frac(opd / lambda)
//     stays within a few hundred cycles, r = c - round(c) lies in
//     [-1/2, 1/2] exactly, and sin and cos of 2 pi r come from the
//     special-function unit (__sincosf, absolute error <= 2^-21.4 on
//     [-pi, pi]): no argument outside [-pi, pi] reaches it, whatever the
//     phase (the accurate sincosf's slow reduction is never needed);
//   - round(c) is (c + 1.5 2^23) - 1.5 2^23 (exact for |c| < 2^22 cycles,
//     phases below 2.6e7 rad), two adds on the FP32 pipe;
//   - per pupil sample the factors that do not depend on the image point
//     are taken once, when the sample is staged: amp / 2, p / Rp and the
//     OPD's phase, packed with p into two float4s.
//
// Plain arithmetic apart from `__device__` and the intrinsics:
// tests/test_torch_chain_host.py compiles it with g++ in double (rsqrtf,
// fmaf, __fdividef and __sincosf mapped to their double versions; ROUND
// follows the type's own precision) and holds a host loop over it against
// the plain PyTorch version. No fast-math.
#pragma once

#include <limits>

namespace otk {

constexpr float TWO_PI = static_cast<float>(6.283185307179586);
// 1.5 2^(p - 1), p the significand's bits: c + ROUND - ROUND rounds c to
// an integer (2^23 in float; 2^52 in the host test's double build)
constexpr float ROUND = static_cast<float>(1.5) *
                        static_cast<float>(1ull << (std::numeric_limits<float>::digits - 1));

// The per-launch constants of the sum: the reference sphere's radius, its
// square and double, and 1 / lambda as a float pair (hi + lo).
struct HuygensConsts {
  float Rp, Rp2, two_Rp, inv_lambda, inv_lambda_lo;
};

__device__ __forceinline__ HuygensConsts huygens_consts(float Rp, float inv_lambda,
                                                        float inv_lambda_lo) {
  return HuygensConsts{Rp, Rp * Rp, 2.0f * Rp, inv_lambda, inv_lambda_lo};
}

// A pupil sample as the sum reads it: a = (ux, uy, uz, amp / 2),
// b = (frac(opd / lambda), ux / Rp, uy / Rp, uz / Rp). opd / lambda is
// formed exactly as a float pair (the product's rounding error by fmaf,
// plus opd times lambda's low part) before its integer part is dropped.
__device__ __forceinline__ void stage_sample(float ux, float uy, float uz, float amp,
                                             float opd, const HuygensConsts& h, float4& a,
                                             float4& b) {
  const float inv_Rp = 1.0f / h.Rp;
  const float hi = opd * h.inv_lambda;
  const float lo = fmaf(opd, h.inv_lambda, -hi) + opd * h.inv_lambda_lo;
  const float frac = (hi - ((hi + ROUND) - ROUND)) + lo;
  a = make_float4(ux, uy, uz, 0.5f * amp);
  b = make_float4(frac, ux * inv_Rp, uy * inv_Rp, uz * inv_Rp);
}

// Adds staged pupil sample (a, b)'s contribution to the field (re, im) at
// image point (ix, iy, iz), given as (ix, iy, izR = iz - Rp).
__device__ __forceinline__ void huygens_term(float ix, float iy, float izR, const float4& a,
                                             const float4& b, const HuygensConsts& h,
                                             float& re, float& im) {
  const float dx = ix - a.x;
  const float dy = iy - a.y;
  const float w = izR - a.z;  // dz - Rp
  const float e = fmaf(w, w + h.two_Rp, dx * dx + dy * dy);  // R^2 - Rp^2
  const float rinv = rsqrtf(e + h.Rp2);
  const float dR = __fdividef(e, fmaf(e + h.Rp2, rinv, h.Rp));  // R - Rp
  // (1 + cos(theta)) / 2 amp / R, with (i - p) . p / Rp from the staged p / Rp:
  // dz uz / Rp = (w + Rp) uz / Rp = w uz / Rp + uz
  const float cos_R = fmaf(dx, b.y, fmaf(dy, b.z, fmaf(w, b.w, a.z)));
  const float scale = (a.w * rinv) * fmaf(cos_R, rinv, 1.0f);
  const float c = fmaf(dR, h.inv_lambda, -b.x);  // the phase in cycles
  const float r = c - ((c + ROUND) - ROUND);
  float s, co;
  __sincosf(TWO_PI * r, &s, &co);
  re = fmaf(scale, co, re);
  im = fmaf(scale, s, im);
}

// Adds the contributions of the n staged pupil samples (a[j], b[j]) to the
// fields (re[q], im[q]) of a thread's NPT image points (x, y, zR = z - Rp):
// each sample's two 16-byte loads serve NPT contributions.
template <int NPT>
__device__ __forceinline__ void huygens_accumulate(const float (&x)[NPT], const float (&y)[NPT],
                                                   const float (&zR)[NPT], const float4* a,
                                                   const float4* b, int n,
                                                   const HuygensConsts& h, float (&re)[NPT],
                                                   float (&im)[NPT]) {
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const float4 pa = a[j], pb = b[j];
#pragma unroll
    for (int q = 0; q < NPT; ++q) huygens_term(x[q], y[q], zR[q], pa, pb, h, re[q], im[q]);
  }
}

}  // namespace otk
