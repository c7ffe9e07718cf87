// The reverse sweep of the fused chain, one ray per thread, for Hopper
// (sm_90a): the adjoint of `tile_raygen` and `trace_chain` (chain.cuh) for
// exactly the branches that file covers.
//
// Hopper has no in-kernel autodiff, so this is the hand-written
// counterpart of the `jax.vjp` / `jax.grad` that the Pallas backward
// kernels of optiland_tpu/trace/fused.py (`_moments_bwd`, `_raygen_bwd`,
// `_fused_bwd`) run on `_tile_trace(..., for_grad=True)`. It is written
// once and seeded three ways: K2 with the four moment cotangents, K4 and
// K6 with per-ray cotangents of the final state.
//
// Design: a backward kernel re-traces its ray with `trace_chain(..., rec)`,
// which keeps each surface's entry state and t (REC floats per surface, a
// per-thread array in local memory, which L1 holds: measured on an H100,
// the same record in shared memory ran slower, PERF.md), then
// `reverse_chain` walks the surfaces from S-1 down to 1. Per surface it
// recomputes that surface's forward from the record and runs its adjoint:
//   - the closed-form adjoints of refraction and reflection
//     (`_refract_cv_bwd`, `_reflect_cv_bwd` in the JAX file);
//   - on every curved surface the implicit-function-theorem derivative of
//     the hit, dt/dp = -F_p / F_t with F = sag(x + tL, y + tM) - (z + tN),
//     not a differentiation of the Newton iterations (the `for_grad`
//     structure of `_tile_trace`); on planes the derivative of the closed
//     form t = -C/B, whose cv cotangent is not zero;
//   - the adjoint of the sag gradient in x, y, cv, k and the polynomial
//     coefficients, with the odd asphere's 1/r term;
//   - the tilt rotations, with cotangents to the three angles;
//   - opd += |t n| with a cotangent to the index table; sign(l.n) is
//     constant almost everywhere and gets none;
//   - uniform absorption, i *= exp(-alpha t 1e3): the cotangent of t takes
//     -alpha 1e3 i' di' (i' the intensity after the factor, di' its
//     cotangent). Intensity only ever scales by per-surface factors, so
//     i' di' is the same product i di at every surface: the caller passes
//     it once, from the final state. alpha (the extinction tables) gets no
//     cotangent: it is not differentiated, as in JAX.
//   - with OTK_INTERACTIONS, the closed-form adjoints of the thin lens (into
//     the ray, its OPD term, the focal length and the two indices) and of
//     the grating equation (into the ray, the order times the wavelength,
//     the period, the groove angle, the carrier's curvature and conic
//     through the sag gradient, and the two indices), and a simple
//     coating's cotangent i_pre di_post: the reverse sweep carries the
//     intensity's cotangent di (g_i) beside i di, and each surface's
//     intensity factors (validity, absorption, aperture, TIR or an
//     evanescent order) are recomputed from the record, so that no factor,
//     the coating's T = 0 or R = 0 included, is ever divided by;
//   - with OTK_PHASE, the closed-form adjoint of the phase sheet's
//     generalized Snell law (into the ray, its OPD term, the profile's
//     slots, 1 / k0, the carrier's curvature and conic through the sag
//     gradient, and the two indices);
//   - with OTK_FREEFORM, a freeform's sag partials and the adjoint of its
//     gradient from its sag over nested forward-mode numbers
//     (freeform.cuh `ff_sag_partials`, `ff_sag_grad_bwd`).
// Masks (valid root, aperture, TIR) carry no cotangent, as in JAX.
//
// Parameter cotangents leave each surface as one row of F_STRIDE slots,
// held in a compact order (`table_slot`) so that the slots a surface uses
// come first. A warp sums its 32 rays' row by a reduce-scatter of the
// used width (`WarpRows`: lane j receives slot j's sum) and adds it to the
// warp's own rows in shared memory, with no barrier. A backward grid is
// persistent, at most one block an SM (the wrapper's `backward_grid`:
// BWD_THREADS threads, fewer when a small n fits one smaller tile to an
// SM): block b walks the tiles of blockDim.x rays b, b + blocks, ... with
// one barrier a tile that keeps its warps in step (warps left to drift
// apart ran slower on an H100, most likely because they then run
// different parts of the kernel's ~8,000 instructions at once),
// and at the end sums its warps' rows in a fixed order into one partial
// per block (`write_partials`), summed by torch.sum in the wrapper: no
// float atomics, bitwise reproducible on a given card.
#pragma once

#include "chain.cuh"

namespace otk {

struct Vec6 {
  float x, y, z, L, M, N;
};

// One surface's parameter cotangents; a thin lens's focal length, a
// grating's (m w, d, angle) and a phase sheet's profile slots and 1 / k0
// take co[0..], as their table slots do.
struct SurfGrad {
  float cv, conic, co[CO_MAX], thick, tilt[3], dec[2], n;
#ifdef OTK_INTERACTIONS
  float coat;
#endif
};

__device__ __forceinline__ void zero(SurfGrad& g) {
  g.cv = g.conic = g.thick = g.n = 0.f;
#ifdef OTK_INTERACTIONS
  g.coat = 0.f;
#endif
#pragma unroll
  for (int ci = 0; ci < CO_MAX; ++ci) g.co[ci] = 0.f;
  g.tilt[0] = g.tilt[1] = g.tilt[2] = 0.f;
  g.dec[0] = g.dec[1] = 0.f;
}

__device__ __forceinline__ void rotate(int axis, float ang, Vec6& v) {
  rotate(axis, ang, v.x, v.y, v.z, v.L, v.M, v.N);
}

// Reverse of one pair (p, q) -> (p c - q s, p s + q c), given its output
// (p1, q1): turns (gp, gq) into the input's cotangent, returns d(angle).
__device__ __forceinline__ float rot_pair_bwd(float c, float s, float p1, float q1,
                                              float& gp, float& gq) {
  const float da = -gp * q1 + gq * p1;
  const float gp0 = c * gp + s * gq;
  const float gq0 = -s * gp + c * gq;
  gp = gp0;
  gq = gq0;
  return da;
}

// Reverse of rotate(axis, ang, .): `out` is the rotation's output, g the
// cotangent of the output on entry and of the input on exit.
__device__ __forceinline__ float rotate_bwd(int axis, float ang, const Vec6& out, Vec6& g) {
  const float c = cosf(ang), s = sinf(ang);
  if (axis == 2)
    return rot_pair_bwd(c, s, out.x, out.y, g.x, g.y) +
           rot_pair_bwd(c, s, out.L, out.M, g.L, g.M);
  if (axis == 1)
    return rot_pair_bwd(c, s, out.z, out.x, g.z, g.x) +
           rot_pair_bwd(c, s, out.N, out.L, g.N, g.L);
  return rot_pair_bwd(c, s, out.y, out.z, g.y, g.z) +
         rot_pair_bwd(c, s, out.M, out.N, g.M, g.N);
}

// Adds w * (d sag / d cv, d sag / d k, d sag / d coeffs) at (x, y).
__device__ __forceinline__ void sag_partials(const Surface& s, float x, float y, float w,
                                             SurfGrad& sg) {
#ifdef OTK_FREEFORM
  if (is_freeform(s)) {
    ff_sag_partials(s, x, y, w, sg);
    return;
  }
#endif
  const float cv = s.cv, kk = s.kk;
  const float r2 = x * x + y * y;
  const float m_raw = 1.f - kk * cv * cv * r2;
  const float m = fmaxf(m_raw, EPS);
  const float inv_root = rsqrtf(m);
  const float den = 1.f + m * inv_root;
  const float s_c = cv * r2 / den;
  float droot_dcv = 0.f, droot_dkk = 0.f;
  if (m_raw > EPS) {
    droot_dcv = -kk * cv * r2 * inv_root;
    droot_dkk = -0.5f * cv * cv * r2 * inv_root;
  }
  sg.cv += w * (r2 / den - s_c / den * droot_dcv);
  sg.conic += w * (-s_c / den * droot_dkk);
  if (!is_asphere(s)) return;
  const float base = (s.code == GEOM_EVEN_ASPHERE) ? r2 : sqrtf(fmaxf(r2, EPS));
  float p = base;
#pragma unroll
  for (int ci = 0; ci < CO_MAX; ++ci) {
    if (ci >= s.nc) break;
    sg.co[ci] += w * p;
    p = p * base;
  }
}

// Reverse of sag_grad's gradient: (dgx, dgy) -> cotangents of x, y and of
// the surface's cv, k and coefficients.
__device__ __forceinline__ void sag_grad_bwd(const Surface& s, float x, float y, float dgx,
                                             float dgy, float& dx, float& dy, SurfGrad& sg) {
#ifdef OTK_FREEFORM
  if (is_freeform(s)) {
    ff_sag_grad_bwd(s, x, y, dgx, dgy, dx, dy, sg);
    return;
  }
#endif
  const float cv = s.cv, kk = s.kk;
  const float r2 = x * x + y * y;
  const float m_raw = 1.f - kk * cv * cv * r2;
  const float m = fmaxf(m_raw, EPS);
  const float inv_root = rsqrtf(m);
  const float gmul = cv * inv_root;
  const bool even = s.code == GEOM_EVEN_ASPHERE && s.nc;
  const bool odd = s.code == GEOM_ODD_ASPHERE && s.nc;
  float g = 0.f, r = 1.f, G = gmul;
  if (even || odd) {
    r = odd ? sqrtf(fmaxf(r2, EPS)) : r2;  // the polynomial's variable
    float p = 1.f;
#pragma unroll
    for (int ci = 0; ci < CO_MAX; ++ci) {
      if (ci >= s.nc) break;
      g = g + (even ? 2.f : 1.f) * (float)(ci + 1) * s.co[ci] * p;
      p = p * r;
    }
    G = even ? gmul + g : gmul + g / r;
  }
  dx += dgx * G;
  dy += dgy * G;
  const float dG = dgx * x + dgy * y;
  float dr2 = 0.f;
  sg.cv += dG * inv_root;
  if (m_raw > EPS) {
    const float dm = -0.5f * dG * cv * inv_root * inv_root * inv_root;
    sg.conic -= dm * cv * cv * r2;
    sg.cv -= dm * 2.f * kk * cv * r2;
    dr2 -= dm * kk * cv * cv;
  }
  if (even || odd) {
    // g = sum_ci f (ci+1) co[ci] r^ci with f = 2 (even, r = r2) or 1 (odd);
    // the odd gradient term is g / r
    const float dg = even ? dG : dG / r;
    float dr = even ? 0.f : -dG * g / (r * r);
    float p = 1.f, pm = 0.f;  // r^ci and r^(ci-1)
#pragma unroll
    for (int ci = 0; ci < CO_MAX; ++ci) {
      if (ci >= s.nc) break;
      const float f = (even ? 2.f : 1.f) * (float)(ci + 1);
      sg.co[ci] += dg * f * p;
      if (ci > 0) dr += dg * f * (float)ci * s.co[ci] * pm;
      pm = p;
      p = p * r;
    }
    if (even)
      dr2 += dr;
    else if (r2 > EPS)
      dr2 += dr * 0.5f / r;
  }
  dx += 2.f * x * dr2;
  dy += 2.f * y * dr2;
}

// Reverse of intersect(): dt -> cotangents of the local ray (g) and of the
// surface parameters. `a` is the local state before the hit, t the hit.
__device__ __forceinline__ void intersect_bwd(const Surface& s, const Vec6& a, float t,
                                              float dt, Vec6& g, SurfGrad& sg) {
  const float cv = s.cv, kk = s.kk;
  const float x = a.x, y = a.y, z = a.z, L = a.L, M = a.M, N = a.N;
  if (s.code != GEOM_PLANE) {
    // implicit function theorem at the root of F(t) = sag - z
    const float xh = x + t * L, yh = y + t * M;
    float sv, gx, gy;
#ifdef OTK_FREEFORM
    if (is_freeform(s))
      ff_sag_grad(s, xh, yh, sv, gx, gy);
    else
#endif
    sag_grad(s.code, s.nc, s.co, cv, kk, xh, yh, false, sv, gx, gy);
    float fp = gx * L + gy * M - N;
    fp = (fabsf(fp) > EPS) ? fp : EPS;
    const float w = -dt / fp;
    g.x += w * gx;
    g.y += w * gy;
    g.z -= w;
    g.L += w * t * gx;
    g.M += w * t * gy;
    g.N -= w * t;
    sag_partials(s, xh, yh, w, sg);
    return;
  }
  // plane: the closed form, t = t_quad if |A| > eps else -C / B_safe
  const float A = cv * (L * L + M * M + kk * N * N);
  const float B = 2.f * (cv * (L * x + M * y + kk * N * z) - N);
  const float C = cv * (x * x + y * y + kk * z * z) - 2.f * z;
  float dA = 0.f, dB = 0.f, dC = 0.f;
  if (fabsf(A) > EPS) {
    const float disc = B * B - 4.f * A * C;
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float inv2A = 1.f / (2.f * A);
    const float t1 = (-B + sq) * inv2A;
    const float t2 = (-B - sq) * inv2A;
    const bool first = fabsf(z + t1 * N) <= fabsf(z + t2 * N);
    const float tq = first ? t1 : t2;
    const float e = dt * inv2A;
    dB = -e;
    dA = -dt * tq / A;
    if (disc > 0.f) {
      const float dd = (first ? e : -e) * 0.5f / sq;
      dB += 2.f * B * dd;
      dA -= 4.f * C * dd;
      dC -= 4.f * A * dd;
    }
  } else if (fabsf(B) > EPS) {
    dC = -dt / B;
    dB = dt * C / (B * B);
  } else {
    dC = -dt / EPS;
  }
  sg.cv += dA * (L * L + M * M + kk * N * N) + dB * 2.f * (L * x + M * y + kk * N * z) +
           dC * (x * x + y * y + kk * z * z);
  sg.conic += dA * cv * N * N + dB * 2.f * cv * N * z + dC * cv * z * z;
  g.L += dA * 2.f * cv * L + dB * 2.f * cv * x;
  g.M += dA * 2.f * cv * M + dB * 2.f * cv * y;
  g.N += dA * 2.f * cv * kk * N + dB * (2.f * cv * kk * z - 2.f);
  g.x += dB * 2.f * cv * L + dC * 2.f * cv * x;
  g.y += dB * 2.f * cv * M + dC * 2.f * cv * y;
  g.z += dB * 2.f * cv * kk * N + dC * (2.f * cv * kk * z - 2.f);
}

// Reverse of interact() at the local hit (x, y) with incident direction
// (L, M, N): g holds the cotangent of (x, y, z, L', M', N') on entry and of
// (x, y, z, L, M, N) on exit. A refraction adds the running index
// cotangent acc_n to the surface's n_table slot and restarts acc_n at the
// cotangent of the index before the surface.
__device__ __forceinline__ void interact_bwd(const Surface& s, float n_pre, float x,
                                             float y, float L, float M, float N, Vec6& g,
                                             float& acc_n, SurfGrad& sg) {
  if (s.inter == INT_NONE) return;
  float sv, gxs, gys;
#ifdef OTK_FREEFORM
  if (is_freeform(s))
    ff_sag_grad(s, x, y, sv, gxs, gys);
  else
#endif
  sag_grad(s.code, s.nc, s.co, s.cv, s.kk, x, y, false, sv, gxs, gys);
  const float inv_mag = rsqrtf(gxs * gxs + gys * gys + 1.f);
  const float nx0 = gxs * inv_mag, ny0 = gys * inv_mag, nz0 = -inv_mag;
  const float sgn = sign_of(L * nx0 + M * ny0 + N * nz0);
  const float nx = nx0 * sgn, ny = ny0 * sgn, nz = nz0 * sgn;
  const float cs = L * nx + M * ny + N * nz;
  const float gL = g.L, gM = g.M, gN = g.N;
  float dnx, dny, dnz;
  if (s.inter == INT_REFLECT) {
    const float gn = gL * nx + gM * ny + gN * nz;
    g.L = gL - 2.f * gn * nx;
    g.M = gM - 2.f * gn * ny;
    g.N = gN - 2.f * gn * nz;
    dnx = -2.f * (gn * L + cs * gL);
    dny = -2.f * (gn * M + cs * gM);
    dnz = -2.f * (gn * N + cs * gN);
  } else {
    const float n_post = s.n;
    const float u = n_pre / n_post;
    const float d2 = 1.f - u * u * (1.f - cs * cs);
    const float okf = (d2 >= 0.f) ? 1.f : 0.f;
    const float rt = sqrtf(fmaxf(d2, 0.f));
    const float q = rt - u * cs;
    const float gpL = okf * gL, gpM = okf * gM, gpN = okf * gN;
    float du = L * gpL + M * gpM + N * gpN;
    const float dq = nx * gpL + ny * gpM + nz * gpN;
    const float dd2 = okf * (0.5f * dq) / fmaxf(rt, EPS);
    du = du - cs * dq - 2.f * u * (1.f - cs * cs) * dd2;
    const float dc = -u * dq + 2.f * (u * u) * cs * dd2;
    const float thru = 1.f - okf;
    g.L = u * gpL + thru * gL + dc * nx;
    g.M = u * gpM + thru * gM + dc * ny;
    g.N = u * gpN + thru * gN + dc * nz;
    dnx = q * gpL + dc * L;
    dny = q * gpM + dc * M;
    dnz = q * gpN + dc * N;
    sg.n += acc_n - du * u / n_post;
    acc_n = du / n_post;
  }
  // n = sgn (gx, gy, -1) / |(gx, gy, -1)|
  const float a = sgn * dnx, b = sgn * dny, c = sgn * dnz;
  const float dI = a * gxs + b * gys - c;
  const float im3 = inv_mag * inv_mag * inv_mag;
  const float dgx = a * inv_mag - dI * gxs * im3;
  const float dgy = b * inv_mag - dI * gys * im3;
  sag_grad_bwd(s, x, y, dgx, dgy, g.x, g.y, sg);
}

#ifdef OTK_INTERACTIONS
// Reverse of thin_lens() at the local hit (x, y) with incident direction
// (L, M, N): g holds the cotangent of (x, y, z, L', M', N') on entry and of
// (x, y, z, L, M, N) on exit; g_opd, the OPD's cotangent, reaches x, y and
// the focal length through -(x^2 + y^2) / 2f. The focal length's cotangent
// goes to co[0], the indices' as interact_bwd's.
__device__ __forceinline__ void thin_lens_bwd(const Surface& s, float n1, float x, float y,
                                              float L, float M, float N, float g_opd,
                                              Vec6& g, float& acc_n, SurfGrad& sg) {
  const float f = s.co[F_FOCAL - F_COEFFS], n2 = s.n;
  const float ux = L / N, uy = M / N;
  const float ux2 = (n1 * ux - x / f) / n2;
  const float uy2 = (n1 * uy - y / f) / n2;
  const float Np = rsqrtf(1.f + ux2 * ux2 + uy2 * uy2);
  // L' = ux2 N', M' = uy2 N', N' = (1 + ux2^2 + uy2^2)^(-1/2)
  const float dNp = g.L * ux2 + g.M * uy2 + g.N;
  const float ds = -0.5f * dNp * Np * Np * Np;
  const float dux2 = g.L * Np + 2.f * ux2 * ds;
  const float duy2 = g.M * Np + 2.f * uy2 * ds;
  const float dax = dux2 / n2, day = duy2 / n2;
  const float dn2 = -(dux2 * ux2 + duy2 * uy2) / n2;
  const float dn1 = dax * ux + day * uy;
  const float dux = dax * n1, duy = day * n1;
  g.x += -dax / f - g_opd * x / f;
  g.y += -day / f - g_opd * y / f;
  sg.co[0] += (dax * x + day * y) / (f * f) + g_opd * (x * x + y * y) / (2.f * f * f);
  g.L = dux / N;
  g.M = duy / N;
  g.N = -(dux * ux + duy * uy) / N;
  sg.n += acc_n + dn2;
  acc_n = dn1;
}

// Reverse of diffract() at the local hit (x, y) with incident direction
// (L, M, N), as interact_bwd: the cotangents of the ray, of the grating's
// (m w, d, angle) into co[0..2], of a curved carrier's cv and conic
// through its sag gradient (sag_grad_bwd, which also adds to x and y), and
// of the two indices. An evanescent order passes its direction's cotangent
// through and gives nothing else.
__device__ __forceinline__ void diffract_bwd(const Surface& s, float n1, float x, float y,
                                             float L, float M, float N, Vec6& g,
                                             float& acc_n, SurfGrad& sg) {
  const GratingFrame q = grating_frame(s, x, y);
  const float d = s.co[F_GRATING + 1 - F_COEFFS], n2 = s.n, mw = s.gm;
  const float h = rsqrtf(q.fx * q.fx + q.fy * q.fy);
  const float pp = d * h;
  const float dot = L * q.n0x + M * q.n0y + N * q.n0z;
  const float sg_ = sign_of(dot);
  const float nx = q.n0x * sg_, ny = q.n0y * sg_, nz = q.n0z * sg_;
  const float c = fabsf(dot);
  const float utx = L - c * nx, uty = M - c * ny, utz = N - c * nz;
  const float fn = q.fx * nx + q.fy * ny + q.fz * nz;
  const float ftx = q.fx - fn * nx, fty = q.fy - fn * ny, ftz = q.fz - fn * nz;
  const float a = n1 * pp;
  const float Tx = a * utx + mw * ftx, Ty = a * uty + mw * fty, Tz = a * utz + mw * ftz;
  const float Q = pp * pp * n2 * n2 - (Tx * Tx + Ty * Ty + Tz * Tz);
  if (!(Q >= 0.f)) {  // evanescent: l' = l, a mask
    sg.n += acc_n;
    acc_n = 0.f;
    return;
  }
  const float root = sqrtf(Q);
  const float zsign = s.reflective ? -1.f : 1.f;
  const float n2c = zsign * n2;
  const float inv_den = 1.f / (pp * n2c);
  const float Lr = (Tx - nx * root) * inv_den;
  const float Mr = (Ty - ny * root) * inv_den;
  const float Nr = (Tz + zsign * nz * root) * inv_den;
  const float im = rsqrtf(Lr * Lr + Mr * Mr + Nr * Nr);
  // l' = r / |r|
  const float ox = Lr * im, oy = Mr * im, oz = Nr * im;
  const float go = g.L * ox + g.M * oy + g.N * oz;
  const float dLr = (g.L - go * ox) * im, dMr = (g.M - go * oy) * im,
              dNr = (g.N - go * oz) * im;
  // r = (T - (nx, ny, -zsign nz) root) / (p n2')
  float dTx = dLr * inv_den, dTy = dMr * inv_den, dTz = dNr * inv_den;
  const float droot = (-nx * dLr - ny * dMr + zsign * nz * dNr) * inv_den;
  float dnx = -dLr * root * inv_den, dny = -dMr * root * inv_den,
        dnz = zsign * dNr * root * inv_den;
  const float dD = -(dLr * Lr + dMr * Mr + dNr * Nr) * inv_den;  // D = p n2'
  float dpp = dD * n2c;
  float dn2 = dD * pp * zsign;
  // root = sqrt(Q), Q = p^2 n2^2 - |T|^2
  const float dQ = 0.5f * droot / fmaxf(root, EPS);
  dpp += dQ * 2.f * pp * n2 * n2;
  dn2 += dQ * 2.f * pp * pp * n2;
  dTx -= 2.f * dQ * Tx;
  dTy -= 2.f * dQ * Ty;
  dTz -= 2.f * dQ * Tz;
  // T = n1 p u_t + m w f_t
  const float dut_x = dTx * a, dut_y = dTy * a, dut_z = dTz * a;
  const float da = dTx * utx + dTy * uty + dTz * utz;
  sg.co[0] += dTx * ftx + dTy * fty + dTz * ftz;
  const float dftx = dTx * mw, dfty = dTy * mw, dftz = dTz * mw;
  const float dn1 = da * pp;
  dpp += da * n1;
  // f_t = f - (f.n) n, u_t = l - c n
  const float dfn = -(dftx * nx + dfty * ny + dftz * nz);
  float dfx = dftx + dfn * nx, dfy = dfty + dfn * ny, dfz = dftz + dfn * nz;
  dnx += -fn * dftx + dfn * q.fx;
  dny += -fn * dfty + dfn * q.fy;
  dnz += -fn * dftz + dfn * q.fz;
  const float dc = -(dut_x * nx + dut_y * ny + dut_z * nz);
  dnx -= c * dut_x;
  dny -= c * dut_y;
  dnz -= c * dut_z;
  // c = |l.n0| and n = sign(l.n0) n0, the sign constant
  const float ddot = dc * sg_;
  g.L = dut_x + ddot * q.n0x;
  g.M = dut_y + ddot * q.n0y;
  g.N = dut_z + ddot * q.n0z;
  float dn0x = sg_ * dnx + ddot * L, dn0y = sg_ * dny + ddot * M, dn0z = sg_ * dnz + ddot * N;
  // p = d / |(fx, fy)|
  sg.co[1] += dpp * h;
  const float dh3 = dpp * d * h * h * h;
  dfx -= dh3 * q.fx;
  dfy -= dh3 * q.fy;
  sg.n += acc_n + dn2;
  acc_n = dn1;
  if (s.code == GEOM_PLANE) {  // f = (-sin a, cos a, 0), n0 constant
    sg.co[2] += -dfx * q.ca - dfy * q.sa;
    return;
  }
  // f = -r / |r|, r = u x t with u = -n0, t = (cos a, sin a, tz)
  const float rhx = q.rx * q.rinv, rhy = q.ry * q.rinv, rhz = q.rz * q.rinv;
  const float gr = -(dfx * rhx + dfy * rhy + dfz * rhz);
  const float drx = (-dfx - gr * rhx) * q.rinv;
  const float dry = (-dfy - gr * rhy) * q.rinv;
  const float drz = (-dfz - gr * rhz) * q.rinv;
  const float ux = -q.n0x, uy = -q.n0y, uz = -q.n0z;
  const float tz = q.gx * q.ca + q.gy * q.sa;
  dn0x -= -dry * tz + drz * q.sa;
  dn0y -= drx * tz - drz * q.ca;
  dn0z -= -drx * q.sa + dry * q.ca;
  const float dtz = drx * uy - dry * ux;
  const float dsa = -drx * uz + drz * ux + dtz * q.gy;
  const float dca = dry * uz - drz * uy + dtz * q.gx;
  sg.co[2] += -dca * q.sa + dsa * q.ca;
  // n0 = (gx, gy, -1) / |(gx, gy, -1)|
  const float dI = dn0x * q.gx + dn0y * q.gy - dn0z;
  const float im3 = q.inv * q.inv * q.inv;
  const float dgx = dtz * q.ca + dn0x * q.inv - dI * q.gx * im3;
  const float dgy = dtz * q.sa + dn0y * q.inv - dI * q.gy * im3;
  sag_grad_bwd(s, x, y, dgx, dgy, g.x, g.y, sg);
}
#endif

#ifdef OTK_PHASE
// Reverse of phase_vg: the cotangents (dph, dgx, dgy) of the phase and its
// gradient -> those of x and y (added to dx, dy) and of the profile's slots
// (added to dp). The radial kind's gradient is 2 (x, y) D with D = d phi /
// d(r^2) = sum (j + 1) p_j r^(2 j), whose own derivative in r^2 is D2 = sum
// (j + 1) j p_j r^(2 (j - 1)).
__device__ __forceinline__ void phase_vg_bwd(int kind, const float* p, float x, float y,
                                             float dph, float dgx, float dgy, float& dx,
                                             float& dy, float* dp) {
  if (kind == PHASE_CONSTANT) {
    dp[0] += dph;
  } else if (kind == PHASE_RADIAL) {
    const float r2 = x * x + y * y;
    float d = 0.f, d2 = 0.f, rp_prev = 1.f, rp_prev2 = 0.f;
#pragma unroll
    for (int ci = 0; ci < PHASE_SLOTS; ++ci) {
      d = d + p[ci] * (float)(ci + 1) * rp_prev;
      if (ci > 0) d2 = d2 + p[ci] * (float)((ci + 1) * ci) * rp_prev2;
      rp_prev2 = rp_prev;
      rp_prev = rp_prev * r2;
    }
    const float dd = 2.f * (x * dgx + y * dgy);
    float rp = r2, rq = 1.f;  // r^(2 (j + 1)) and r^(2 j)
#pragma unroll
    for (int ci = 0; ci < PHASE_SLOTS; ++ci) {
      dp[ci] += dph * rp + dd * (float)(ci + 1) * rq;
      rq = rp;
      rp = rp * r2;
    }
    const float dr2 = dph * d + dd * d2;
    dx += 2.f * d * dgx + 2.f * x * dr2;
    dy += 2.f * d * dgy + 2.f * y * dr2;
  } else {  // PHASE_LINEAR_GRATING
    dp[0] += dph * x + dgx;
    dp[1] += dph * y + dgy;
    dx += dph * p[0];
    dy += dph * p[1];
  }
}

// Reverse of phase_sheet() at the local hit (x, y) with incident direction
// (L, M, N), as interact_bwd: g holds the cotangent of (x, y, z, L', M',
// N') on entry and of (x, y, z, L, M, N) on exit; g_opd, the OPD's
// cotangent, reaches the phase and 1 / k0 through -phi / k0. The profile's
// slots and 1 / k0 take co[0 .. PHASE_SLOTS], a curved carrier's cv and
// conic their cotangents through its sag gradient (sag_grad_bwd, which
// also adds to x and y), and the two indices theirs (on a mirror the
// interaction's n2 is n1). An evanescent ray passes its direction's
// cotangent through.
__device__ __forceinline__ void phase_sheet_bwd(const Surface& s, float n1, float x, float y,
                                                float L, float M, float N, float g_opd,
                                                Vec6& g, float& acc_n, SurfGrad& sg) {
  float sv, gxs, gys;
  sag_grad(s.code, s.nc, s.co, s.cv, s.kk, x, y, false, sv, gxs, gys);
  const float inv = rsqrtf(gxs * gxs + gys * gys + 1.f);
  const float nx = gxs * inv, ny = gys * inv, nz = -inv;
  const float n2 = s.reflective ? n1 : s.n, ik = s.ik;
  const float* p = s.co + (F_PHASE - F_COEFFS);
  float ph, gpx, gpy;
  phase_vg(s.pk, p, x, y, ph, gpx, gpy);
  const float a = ik * gpx, b = ik * gpy;
  const float c = L * nx + M * ny + N * nz;
  const float e = n1 * c + a * nx + b * ny;
  const float kpx = n1 * L + a - e * nx;
  const float kpy = n1 * M + b - e * ny;
  const float kpz = n1 * N - e * nz;
  const float Q = n2 * n2 - (kpx * kpx + kpy * kpy + kpz * kpz);
  // opd' = opd - phi ik
  const float dph = -g_opd * ik;
  float dik = -g_opd * ph;
  float dgpx = 0.f, dgpy = 0.f, dnx = 0.f, dny = 0.f, dnz = 0.f, dn1 = 0.f, dn2 = 0.f;
  if (Q >= 0.f) {
    const float sgn = (s.reflective ? -1.f : 1.f) * sign_of(c);
    const float rt = sqrtf(Q);
    const float al = sgn * rt;
    const float kox = kpx + al * nx, koy = kpy + al * ny, koz = kpz + al * nz;
    const float im = rsqrtf(kox * kox + koy * koy + koz * koz);
    // l' = ko / |ko|
    const float ox = kox * im, oy = koy * im, oz = koz * im;
    const float go = g.L * ox + g.M * oy + g.N * oz;
    const float dkox = (g.L - go * ox) * im, dkoy = (g.M - go * oy) * im,
                dkoz = (g.N - go * oz) * im;
    // ko = kp + al n, al = sgn sqrt(Q), Q = n2^2 - |kp|^2
    const float dal = dkox * nx + dkoy * ny + dkoz * nz;
    dnx = al * dkox;
    dny = al * dkoy;
    dnz = al * dkoz;
    const float dQ = dal * sgn * 0.5f / fmaxf(rt, EPS);
    dn2 = 2.f * n2 * dQ;
    const float dkpx = dkox - 2.f * kpx * dQ, dkpy = dkoy - 2.f * kpy * dQ,
                dkpz = dkoz - 2.f * kpz * dQ;
    // kp = n1 l + (a, b, 0) - e n, e = n1 c + a nx + b ny, c = l.n
    const float de = -(dkpx * nx + dkpy * ny + dkpz * nz);
    const float dc = de * n1;
    dn1 = de * c + dkpx * L + dkpy * M + dkpz * N;
    const float da = dkpx + de * nx, db = dkpy + de * ny;
    dnx += -e * dkpx + de * a + dc * L;
    dny += -e * dkpy + de * b + dc * M;
    dnz += -e * dkpz + dc * N;
    g.L = n1 * dkpx + dc * nx;
    g.M = n1 * dkpy + dc * ny;
    g.N = n1 * dkpz + dc * nz;
    // (a, b) = ik grad(phi)
    dik += da * gpx + db * gpy;
    dgpx = da * ik;
    dgpy = db * ik;
  }
  if (s.reflective) {
    dn1 += dn2;
    dn2 = 0.f;
  }
  sg.n += acc_n + dn2;
  acc_n = dn1;
  sg.co[PHASE_SLOTS] += dik;
  phase_vg_bwd(s.pk, p, x, y, dph, dgpx, dgpy, g.x, g.y, sg.co);
  // n = (gx, gy, -1) / |(gx, gy, -1)|
  const float dI = dnx * gxs + dny * gys - dnz;
  const float im3 = inv * inv * inv;
  const float dgx = dnx * inv - dI * gxs * im3;
  const float dgy = dny * inv - dI * gys * im3;
  sag_grad_bwd(s, x, y, dgx, dgy, g.x, g.y, sg);
}
#endif

// Reverse of one surface of trace_chain. e: the surface's record (entry
// state and t); n_pre, pos: the index before the surface and its vertex z;
// g: cotangent of the state after the surface on entry, of the entry state
// on exit; g_opd: the opd cotangent (opd only accumulates, so it is the
// same at every surface); g_ip: the product i di of the intensity and its
// cotangent (the same at every surface). Adds the surface's parameter
// cotangents to sg and the cotangent of its vertex z to dpos. With
// OTK_INTERACTIONS, g_i is the intensity's cotangent after the surface on
// entry and before it on exit, and a coating's cotangent is g_i times the
// intensity it scaled (the record's entry intensity times the surface's
// other factors, recomputed); without it g_i is not read.
__device__ __forceinline__ void surface_bwd(const Surface& s, const float* e,
                                            float n_pre, float pos, float g_opd,
                                            float g_ip, Vec6& g, float& acc_n,
                                            float& dpos, SurfGrad& sg,
                                            float* g_i = nullptr) {
  const float t = e[6];
  // recompute the surface's forward from its record
  Vec6 a[4];
  a[0] = Vec6{e[0], e[1], e[2], e[3], e[4], e[5]};
  if (s.tilted || s.decentered) {
    a[0].x = a[0].x - s.tx;
    a[0].y = a[0].y - s.ty;
  }
  a[0].z = a[0].z - pos;
  a[1] = a[0];
  a[2] = a[0];
  a[3] = a[0];
  if (s.tilted) {
    rotate(2, -s.rz, a[1]);
    a[2] = a[1];
    rotate(1, -s.ry, a[2]);
    a[3] = a[2];
    rotate(0, -s.rx, a[3]);
  }
  const Vec6& lo = a[3];  // local frame, before the hit
  const float xh = lo.x + t * lo.L, yh = lo.y + t * lo.M, zh = lo.z + t * lo.N;
  Vec6 b[4];
  b[0] = Vec6{xh, yh, zh, lo.L, lo.M, lo.N};
  float i_dummy = 1.f;
#ifdef OTK_INTERACTIONS
  float opd_dummy = 0.f;
  interact(s, n_pre, xh, yh, b[0].L, b[0].M, b[0].N, i_dummy, opd_dummy);
  {
    // the intensity factors before the coating: validity (the conic
    // root's, as intersect() forms it), absorption, aperture and the
    // interaction's (i_dummy: 0 after TIR or an evanescent order)
    const float cv = s.cv, kk = s.kk;
    const float A = cv * (lo.L * lo.L + lo.M * lo.M + kk * lo.N * lo.N);
    const float B = 2.f * (cv * (lo.L * lo.x + lo.M * lo.y + kk * lo.N * lo.z) - lo.N);
    const float C = cv * (lo.x * lo.x + lo.y * lo.y + kk * lo.z * lo.z) - 2.f * lo.z;
    const float disc = B * B - 4.f * A * C;
    float q = (fabsf(A) > EPS && !(disc >= 0.f)) ? 0.f : 1.f;
    if (s.absorbs) q = q * expf(-s.alpha * t * 1e3f);
    if (s.aperture) q = q * ((xh * xh + yh * yh <= s.ap * s.ap) ? 1.f : 0.f);
    q = q * i_dummy;
    if (s.coated) {
      sg.coat += *g_i * (e[REC_I] * q);
      *g_i = *g_i * s.coat;
    }
    *g_i = *g_i * q;
  }
#else
  interact(s, n_pre, xh, yh, b[0].L, b[0].M, b[0].N, i_dummy);
#endif
  b[1] = b[0];
  b[2] = b[0];
  b[3] = b[0];
  if (s.tilted) {
    rotate(0, s.rx, b[1]);
    b[2] = b[1];
    rotate(1, s.ry, b[2]);
    b[3] = b[2];
    rotate(2, s.rz, b[3]);
  }

  // to_global
  if (s.tilted || s.decentered) {
    sg.dec[0] += g.x;
    sg.dec[1] += g.y;
  }
  dpos += g.z;
  if (s.tilted) {
    sg.tilt[2] += rotate_bwd(2, s.rz, b[3], g);
    sg.tilt[1] += rotate_bwd(1, s.ry, b[2], g);
    sg.tilt[0] += rotate_bwd(0, s.rx, b[1], g);
  }
  // interaction
#ifdef OTK_INTERACTIONS
  if (s.inter == INT_THIN_LENS)
    thin_lens_bwd(s, n_pre, xh, yh, lo.L, lo.M, lo.N, g_opd, g, acc_n, sg);
  else if (s.inter == INT_DIFFRACT)
    diffract_bwd(s, n_pre, xh, yh, lo.L, lo.M, lo.N, g, acc_n, sg);
  else
#endif
#ifdef OTK_PHASE
  if (s.inter == INT_PHASE)
    phase_sheet_bwd(s, n_pre, xh, yh, lo.L, lo.M, lo.N, g_opd, g, acc_n, sg);
  else
#endif
    interact_bwd(s, n_pre, xh, yh, lo.L, lo.M, lo.N, g, acc_n, sg);
  // propagation x + t l, opd += |t n_pre| and the absorption factor
  const float so = sign_of(t * n_pre);
  float dt = g.x * lo.L + g.y * lo.M + g.z * lo.N + g_opd * so * n_pre;
  if (s.absorbs) dt -= s.alpha * 1e3f * g_ip;
  acc_n += g_opd * so * t;
  g.L += g.x * t;
  g.M += g.y * t;
  g.N += g.z * t;
  intersect_bwd(s, lo, t, dt, g, sg);
  // to_local
  if (s.tilted) {
    sg.tilt[0] -= rotate_bwd(0, -s.rx, a[3], g);
    sg.tilt[1] -= rotate_bwd(1, -s.ry, a[2], g);
    sg.tilt[2] -= rotate_bwd(2, -s.rz, a[1], g);
  }
  dpos -= g.z;
  if (s.tilted || s.decentered) {
    sg.dec[0] -= g.x;
    sg.dec[1] -= g.y;
  }
}

// Reverse of tile_raygen: the cotangent g of the starting ray -> drg (5)
// and the cotangents dd = (dHx, dHy, dPx, dPy).
__device__ __forceinline__ void tile_raygen_bwd(int field_angle, int object_infinite,
                                                const float* rg, float Hx, float Hy,
                                                float Px, float Py, const Vec6& g,
                                                float* drg, float* dd) {
  const float epl = rg[0], epd = rg[1], fmax = rg[2], a = rg[3], b = rg[4];
  const float half = epd * 0.5f;
  float x0, y0, tx = 0.f, ty = 0.f;
  if (field_angle) {
    tx = tanf((fmax * Hx) * DEG2RAD);
    ty = tanf((fmax * Hy) * DEG2RAD);
    x0 = object_infinite ? Px * half - tx * b : -tx * b;
    y0 = object_infinite ? Py * half - ty * b : -ty * b;
  } else {
    x0 = fmax * Hx;
    y0 = fmax * Hy;
  }
  const float dx = Px * half - x0;
  const float dy = Py * half - y0;
  const float dz = epl - a;
  const float mag2 = dx * dx + dy * dy + dz * dz;
  float ddx = 0.f, ddy = 0.f, ddz = 0.f;
  if (!(mag2 < 1e-18f)) {
    const float inv = rsqrtf(fmaxf(mag2, 1e-18f));
    const float dinv = g.L * dx + g.M * dy + g.N * dz;
    const float dmag2 = -0.5f * dinv * inv * inv * inv;
    ddx = g.L * inv + 2.f * dx * dmag2;
    ddy = g.M * inv + 2.f * dy * dmag2;
    ddz = g.N * inv + 2.f * dz * dmag2;
  }
  float gx0 = g.x - ddx, gy0 = g.y - ddy;
  float dPx = ddx * half, dPy = ddy * half, dhalf = ddx * Px + ddy * Py;
  float dfmax, dHx, dHy, db = 0.f;
  if (field_angle) {
    if (object_infinite) {
      dPx += gx0 * half;
      dPy += gy0 * half;
      dhalf += gx0 * Px + gy0 * Py;
    }
    db = -gx0 * tx - gy0 * ty;
    const float ux = (1.f + tx * tx) * (-gx0 * b) * DEG2RAD;
    const float uy = (1.f + ty * ty) * (-gy0 * b) * DEG2RAD;
    dfmax = ux * Hx + uy * Hy;
    dHx = ux * fmax;
    dHy = uy * fmax;
  } else {
    dfmax = gx0 * Hx + gy0 * Hy;
    dHx = gx0 * fmax;
    dHy = gy0 * fmax;
  }
  drg[0] = ddz;
  drg[1] = 0.5f * dhalf;
  drg[2] = dfmax;
  drg[3] = g.z - ddz;
  drg[4] = db;
  dd[0] = dHx;
  dd[1] = dHy;
  dd[2] = dPx;
  dd[3] = dPy;
}

// The compact order of a cotangent row: cv, conic, thickness and index
// first, then (with OTK_INTERACTIONS) the coating's factor, then the
// polynomial coefficients (a thin lens's focal length, a grating's m w, d
// and angle, a phase sheet's profile slots and 1 / k0), tilt and decenter, so that the slots a surface uses come
// first. `table_slot(c)` is the slot of compact position c in the
// packed-table layout (F_* in chain.cuh), a permutation of the 32 slots.
constexpr int C_CV = 0;
constexpr int C_CONIC = 1;
constexpr int C_THICK = 2;
constexpr int C_NTAB = 3;
#ifdef OTK_INTERACTIONS
constexpr int C_COAT = 4;
constexpr int C_COEFFS = 5;
#else
constexpr int C_COEFFS = 4;
#endif
constexpr int C_TILT = C_COEFFS + MAX_COEFFS;  // 21 (22 with OTK_INTERACTIONS)
constexpr int C_DEC = C_TILT + 3;              // 24 (25), then the unused slots

__device__ __forceinline__ int table_slot(int c) {
  if (c == C_CV) return F_CV;
  if (c == C_CONIC) return F_CONIC;
  if (c == C_THICK) return F_THICK;
  if (c == C_NTAB) return F_NTAB;
#ifdef OTK_INTERACTIONS
  if (c == C_COAT) return F_COAT;
#endif
  if (c < C_TILT) return F_COEFFS + (c - C_COEFFS);
  if (c < C_DEC + 2) return F_TILT + (c - C_TILT);  // tilt and decenter, 20-24
#ifdef OTK_INTERACTIONS
  if (c < C_DEC + 4) return c - 1;  // 27-28: the alpha and aperture slots
#endif
  return c;
}

// The width of row k that the reverse sweep fills: the power of two, at
// least 4, that covers the compact slots the surface uses.
__device__ __forceinline__ int row_width(const Surface& s) {
  if (s.tilted || s.decentered) return F_STRIDE;
#ifdef OTK_FREEFORM
  if (is_freeform(s)) return F_STRIDE;  // up to 17 coefficient slots
#endif
#ifdef OTK_INTERACTIONS
#ifdef OTK_PHASE
  const int used = is_asphere(s) ? s.nc
                   : (s.inter == INT_THIN_LENS ? 1
                      : (s.inter == INT_DIFFRACT ? 3
                         : (s.inter == INT_PHASE ? PHASE_SLOTS + 1 : 0)));
#else
  const int used = is_asphere(s) ? s.nc
                   : (s.inter == INT_THIN_LENS ? 1 : (s.inter == INT_DIFFRACT ? 3 : 0));
#endif
  const int top = (used || s.coated) ? C_COEFFS + used : 4;
#else
  const int top = C_COEFFS + (is_asphere(s) ? s.nc : 0);
#endif
  return top <= 4 ? 4 : (top <= 8 ? 8 : (top <= 16 ? 16 : F_STRIDE));
}

// A surface's cotangents as one row, in the compact order.
__device__ __forceinline__ void grad_row(const SurfGrad& sg, float (&v)[F_STRIDE]) {
#pragma unroll
  for (int j = 0; j < F_STRIDE; ++j) v[j] = 0.f;
  v[C_CV] = sg.cv;
  v[C_CONIC] = sg.conic;
  v[C_THICK] = sg.thick;
  v[C_NTAB] = sg.n;
#ifdef OTK_INTERACTIONS
  v[C_COAT] = sg.coat;
#endif
#pragma unroll
  for (int ci = 0; ci < MAX_COEFFS; ++ci) v[C_COEFFS + ci] = sg.co[ci];
  v[C_TILT] = sg.tilt[0];
  v[C_TILT + 1] = sg.tilt[1];
  v[C_TILT + 2] = sg.tilt[2];
  v[C_DEC] = sg.dec[0];
  v[C_DEC + 1] = sg.dec[1];
}

// Reduce-scatter of M values over the 32 lanes of a warp, from xor offset
// O down: while M > 1, each step keeps half the values (the lower half in
// lanes whose bit O is clear), adds the partner lane's copy of that half
// and sends it the other (M / 2 shuffles); once one value is left, plain
// butterfly steps finish the sum. Lane l ends with the sum over all 32
// lanes of slot l / (32 / M): W - 1 + 5 - log2(W) shuffles for width W
// (31 for 32 slots, 9 for 8, 6 for 4).
template <int M, int O>
struct Scatter {
  static __device__ __forceinline__ float run(float (&v)[F_STRIDE], int lane) {
    if constexpr (O == 0) {
      return v[0];
    } else if constexpr (M > 1) {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = upper ? v[i] : v[i + M / 2];
        const float keep = upper ? v[i + M / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      return Scatter<M / 2, O / 2>::run(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      return Scatter<1, O / 2>::run(v, lane);
    }
  }
};

// Sums rows of per-lane cotangents over a warp into that warp's own rows
// (nrows x F_STRIDE floats in shared memory, compact order): a
// reduce-scatter of the row's width, then the lane that holds slot j's sum
// adds it to slot j. Each slot of a row is always added by the same lane,
// so the warp needs no barrier. Every lane of the warp calls it.
struct WarpRows {
  float* rows;
#ifdef OTK_WIDE
  int xbase;  // the first of the warp's wide rows (`put_wide_rows`)
#endif

  __device__ __forceinline__ void put(int row, float (&v)[F_STRIDE], int width) const {
    const int lane = threadIdx.x & 31;
    float sum;
    if (width == 4)
      sum = Scatter<4, 16>::run(v, lane);
    else if (width == 8)
      sum = Scatter<8, 16>::run(v, lane);
    else if (width == 16)
      sum = Scatter<16, 16>::run(v, lane);
    else
      sum = Scatter<32, 16>::run(v, lane);
    const int per = 32 / width;  // lanes holding each slot's sum
    if ((lane & (per - 1)) == 0) rows[row * F_STRIDE + lane / per] += sum;
  }
};

// The raygen scalars' cotangents as row `row`: their slots 0..4 of the
// table layout are the compact positions C_CV, C_CONIC and C_COEFFS + 0..2.
template <class Rows>
__device__ __forceinline__ void put_raygen_row(const Rows& rows, int row, const float* drg) {
  float v[F_STRIDE];
#pragma unroll
  for (int j = 0; j < F_STRIDE; ++j) v[j] = 0.f;
  v[C_CV] = drg[0];
  v[C_CONIC] = drg[1];
  v[C_COEFFS] = drg[2];
  v[C_COEFFS + 1] = drg[3];
  v[C_COEFFS + 2] = drg[4];
  rows.put(row, v, 8);
}

// Each surface's vertex z (pos) and, at one wavelength, the index of the
// medium before it (npre), the same for every ray: the running values of
// trace_chain, by the same arithmetic. Thread 0 of the block fills them.
__device__ __forceinline__ void surface_frames(int S, const float* ft, const int* it,
                                               float* pos, float* npre) {
  if (threadIdx.x != 0) return;
  float pos_prev = 0.f, n_pre = ft[F_NTAB];
  for (int k = 1; k < S; ++k) {
    pos[k] = pos_prev + (k > 1 ? ft[(k - 1) * F_STRIDE + F_THICK] : 0.f);
    pos_prev = pos[k];
    npre[k] = n_pre;
    const int inter = it[k * I_STRIDE + I_INTER];
    if (inter != INT_NONE && inter != INT_REFLECT) n_pre = ft[k * F_STRIDE + F_NTAB];
  }
}

#ifdef OTK_WIDE
// The cotangents of wide surface s's slots past MAX_COEFFS, 32 a row, into
// its wide rows of `rows` (from rows.xbase + s.xrow): slot MAX_COEFFS + 32 q
// + j goes to table slot j of its row q, put at the compact position that
// `table_slot` maps there, as write_partials lays rows out. Every lane of
// the warp calls it.
template <class Rows>
__device__ __forceinline__ void put_wide_rows(const Surface& s, const SurfGrad& sg,
                                              const Rows& rows) {
  for (int q = 0; MAX_COEFFS + F_STRIDE * q < s.nc; ++q) {
    float v[F_STRIDE];
#pragma unroll
    for (int c = 0; c < F_STRIDE; ++c) {
      const int j = MAX_COEFFS + F_STRIDE * q + table_slot(c);
      v[c] = j < CO_MAX ? sg.co[j] : 0.f;
    }
    rows.put(rows.xbase + s.xrow + q, v, F_STRIDE);
  }
}
#endif

// The reverse sweep from surface S-1 down to 1, for every lane of the
// warp (dead lanes, live = false, contribute zeros). rec: the record
// trace_chain wrote; pos, npre: surface_frames'. g:
// the final state's cotangent on entry, the starting ray's on exit; g_opd
// and g_ip as for surface_bwd. Rows 1..S-1 of `rows` get the surfaces'
// parameter cotangents (the thickness slot of row k is d thickness[k], the
// sum over the vertices after k), row 0 the cotangent of n_table[0]. g_i:
// the final intensity's cotangent times the starting intensity (read with
// OTK_INTERACTIONS only, for the coatings' cotangents).
template <class Rows>
__device__ __forceinline__ void reverse_chain(int S, const float* ft, const int* it,
                                              const float* pos, const float* npre,
                                              const float (*rec)[REC], bool live,
                                              float g_opd, float g_ip, Vec6& g,
                                              const Rows& rows, float g_i = 0.f) {
  float acc_n = 0.f, acc_pos = 0.f;
  for (int k = S - 1; k >= 1; --k) {
    const Surface s = load_surface(ft, it, k);
    SurfGrad sg;
    zero(sg);
    float dpos = 0.f;
    if (live)
      surface_bwd(s, rec[k], npre[k], pos[k], g_opd, g_ip, g, acc_n, dpos, sg, &g_i);
    sg.thick = acc_pos;
    acc_pos += dpos;
    float v[F_STRIDE];
    grad_row(sg, v);
    rows.put(k, v, row_width(s));
#ifdef OTK_WIDE
    put_wide_rows(s, sg, rows);
#endif
  }
  SurfGrad sg;
  zero(sg);
  sg.n = acc_n;
  float v[F_STRIDE];
  grad_row(sg, v);
  rows.put(0, v, 4);
}

// The dynamic shared memory of a backward block with `nrows` cotangent
// rows: the staged tables, surface_frames' pos and npre, the raygen
// scalars and each warp's rows (nrows x F_STRIDE).
struct BwdShared {
  float* ft;
  int* it;
  float* pos;
  float* npre;
  float* rg;
  float* rows;
};

// Threads of a backward block at most: 16 warps (the registers of these
// kernels allow no more), one record each in local memory. The wrapper's
// `backward_grid` takes 128 or 256 when n fits one such tile to an SM.
constexpr int BWD_THREADS = 512;
constexpr int MAX_DYN_SMEM = 232448;  // 227 KB, a Hopper block's most

// Whether a backward block of `threads` threads is one these kernels run:
// whole warps, at most BWD_THREADS.
__host__ __forceinline__ bool bwd_threads_ok(int threads) {
  return threads >= 32 && threads <= BWD_THREADS && threads % 32 == 0;
}

__host__ __device__ __forceinline__ size_t bwd_smem_bytes(int S, int nrows, int threads) {
  return sizeof(float) * ((size_t)S * (F_STRIDE + I_STRIDE + 2) + 8 +
                          (size_t)(threads / 32) * nrows * F_STRIDE
#ifdef OTK_WIDE
                          + WIDE_FLOATS
#endif
                          );
}

// Carve the block's shared memory, stage the tables and the raygen scalars
// (rg may be NULL), fill surface_frames and zero the warps' rows; every
// thread of the block calls it.
__device__ __forceinline__ BwdShared stage_backward(float* smem, int S, int nrows,
                                                    const float* __restrict__ ftab,
                                                    const int* __restrict__ itab,
                                                    const float* __restrict__ rg) {
  BwdShared b;
  b.ft = smem;
  b.it = reinterpret_cast<int*>(smem + OTK_FT_FLOATS(S));
#ifdef OTK_WIDE
  b.pos = smem + S * (F_STRIDE + I_STRIDE) + WIDE_FLOATS;
#else
  b.pos = smem + S * (F_STRIDE + I_STRIDE);
#endif
  b.npre = b.pos + S;
  b.rg = b.npre + S;
  b.rows = b.rg + 8;
  for (int j = threadIdx.x; j < (int)(blockDim.x / 32) * nrows * F_STRIDE; j += blockDim.x)
    b.rows[j] = 0.f;
  stage_tables(S, ftab, itab, rg, b.ft, b.it, b.rg);
  surface_frames(S, b.ft, b.it, b.pos, b.npre);
  __syncthreads();
  return b;
}

// A per-ray block's shared memory (the per-ray variants of K2, K4, K6):
// stage_backward's, then the first MAT_SHARED columns of the material rows.
__host__ __device__ __forceinline__ size_t bwd_w_smem_bytes(int S, int nrows, int threads) {
  return bwd_smem_bytes(S, nrows, threads) + sizeof(float) * S * MAT_SHARED;
}

// Stage the material columns past stage_backward's region and return them;
// every thread of the block calls it, before stage_backward (whose
// barriers it relies on).
__device__ __forceinline__ const float* stage_backward_materials(float* smem, int S, int nrows,
                                                                 int mat_w,
                                                                 const float* __restrict__ mat) {
  float* s_mat = smem + bwd_smem_bytes(S, nrows, blockDim.x) / sizeof(float);
  stage_materials(S, mat_w, mat, s_mat);
  return s_mat;
}

// This warp's rows.
__device__ __forceinline__ WarpRows warp_rows(const BwdShared& b, int nrows) {
#ifdef OTK_WIDE
  return WarpRows{b.rows + (threadIdx.x / 32) * nrows * F_STRIDE, nrows - WIDE_ROWS};
#else
  return WarpRows{b.rows + (threadIdx.x / 32) * nrows * F_STRIDE};
#endif
}

// After the block's last group: the sum of its warps' rows, in warp order,
// as this block's nrows partial rows in the packed-table layout. Every
// thread of the block calls it.
__device__ __forceinline__ void write_partials(const BwdShared& b, int nrows, float* out) {
  __syncthreads();
  const int warps = blockDim.x / 32, n = nrows * F_STRIDE;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float tot = 0.f;
    for (int w = 0; w < warps; ++w) tot += b.rows[w * n + j];
    out[(j / F_STRIDE) * F_STRIDE + table_slot(j % F_STRIDE)] = tot;
  }
}

// ---------------------------------------------------------------------------
// The adjoint at per-ray wavelengths: the derivatives of each medium's index
// (`material_index`) in its coefficients and the ray's w, and of the
// Beer-Lambert alpha = 4 pi k(w) / w in w. JAX differentiates the same
// functions inside its per-ray kernels (`uniform_w=False`); the extinction
// tables get no cotangent there, and none here.
// ---------------------------------------------------------------------------

// The adjoint of `interp(x, xp, fp, K)` (jnp.interp): dn -> the cotangents
// v of (xp[i - 1], xp[i], fp[i - 1], fp[i]) on the segment i that interp
// reads (seg = i; for a one-point table i - 1 = i = 0), and of x (added to
// dx). Outside the table the edge value's cotangent lands on fp[0] or
// fp[K - 1] and x gets none; a zero-width segment passes dn to its left
// value and divides by nothing.
__device__ __forceinline__ void interp_bwd(float x, const float* xp, const float* fp, int K,
                                           float dn, int& seg, float (&v)[4], float& dx) {
  int i0, i;
  interp_segment(x, xp, K, i0, i);
  seg = i;
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (x < xp[0]) {
    v[2] = dn;  // fp[0]: i0 is 0 here
  } else if (x > xp[K - 1]) {
    v[3] = dn;  // fp[K - 1]: i is K - 1 here
  } else {
    const float d = xp[i] - xp[i0];
    if (fabsf(d) <= INTERP_DX0) {
      v[2] = dn;
    } else {
      const float q = (x - xp[i0]) / d;
      const float gd = dn * (fp[i] - fp[i0]) / d;
      v[0] = gd * (q - 1.f);
      v[1] = -gd * q;
      v[2] = dn - dn * q;
      v[3] = dn * q;
      dx += gd;
    }
  }
}

// dn times the derivatives of `material_index<F, NC>` at w in its
// coefficients c (added to dc[0 .. NC)) and in w (added to dw), each
// formula's closed form with its forward recomputed in the forward's
// order. The exponents of formulas 3, 4 and 5 are coefficients: d/dc of
// w^c takes log w (and of c'^c log c', as autograd of pow takes it, 0 at
// c' = 0 for c >= 0). The tabulated formula (10) is `interp_bwd`'s.
template <int F, int NC>
__device__ __forceinline__ void material_index_bwd(const float* c, float w, float dn, float* dc,
                                                   float& dw) {
  if constexpr (F == 0) {  // ideal
    dc[0] += dn;
  } else if constexpr (F == 1 || F == 2) {  // Sellmeier
    const float w2 = w * w;
    float n2 = 1.f + c[0];
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) {
      const float d = F == 1 ? c[k + 1] * c[k + 1] : c[k + 1];
      n2 = n2 + c[k] * w2 / (w2 - d);
    }
    const float dn2 = dn * 0.5f / sqrtf(n2);
    float dw2 = 0.f;
    dc[0] += dn2;
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) {
      const float d = F == 1 ? c[k + 1] * c[k + 1] : c[k + 1];
      const float inv = 1.f / (w2 - d);
      const float dd = dn2 * c[k] * w2 * inv * inv;  // d n2 / d d
      dc[k] += dn2 * w2 * inv;
      dc[k + 1] += F == 1 ? dd * 2.f * c[k + 1] : dd;
      dw2 -= dd * d / w2;
    }
    dw += dw2 * 2.f * w;
  } else if constexpr (F == 3 || F == 5) {  // polynomial in n^2, Cauchy in n
    float p[NC > 1 ? NC : 1];
    float s = c[0];
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) {
      p[k] = powf(w, c[k + 1]);
      s = s + c[k] * p[k];
    }
    const float ds = F == 3 ? dn * 0.5f / sqrtf(s) : dn;
    const float lw = logf(w);
    dc[0] += ds;
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) {
      dc[k] += ds * p[k];
      dc[k + 1] += ds * c[k] * p[k] * lw;
      dw += ds * c[k] * c[k + 1] * p[k] / w;
    }
  } else if constexpr (F == 4) {  // refractiveindex.info formula 4
    const float w2 = w * w;
    float n2 = c[0];
    float pa = 0.f, qa = 0.f, da = 1.f, pb = 0.f, qb = 0.f, db = 1.f;
    if constexpr (NC > 4) {
      pa = powf(w, c[2]);
      qa = powf(c[3], c[4]);
      da = w2 - qa;
      n2 = n2 + c[1] * pa / da;
    }
    if constexpr (NC > 8) {
      pb = powf(w, c[6]);
      qb = powf(c[7], c[8]);
      db = w2 - qb;
      n2 = n2 + c[5] * pb / db;
    }
    float p[NC > 1 ? NC : 1];
#pragma unroll
    for (int k = 9; k < NC - 1; k += 2) {
      p[k] = powf(w, c[k + 1]);
      n2 = n2 + c[k] * p[k];
    }
    const float dn2 = dn * 0.5f / sqrtf(n2);
    const float lw = logf(w);
    float dw2 = 0.f;
    dc[0] += dn2;
    // c[j] w^c[j+1] / (w^2 - c[j+2]^c[j+3]) at j = 1 and 5
    const auto pole = [&](int j, float pw, float q, float den) {
      const float dp = dn2 * c[j] / den;
      const float dden = -dn2 * c[j] * pw / (den * den);
      dc[j] += dn2 * pw / den;
      dc[j + 1] += dp * pw * lw;
      dw += dp * c[j + 1] * pw / w;
      dw2 += dden;
      dc[j + 2] -= c[j + 3] == 0.f ? 0.f : dden * c[j + 3] * powf(c[j + 2], c[j + 3] - 1.f);
      dc[j + 3] -= (c[j + 2] == 0.f && c[j + 3] >= 0.f) ? 0.f : dden * q * logf(c[j + 2]);
    };
    if constexpr (NC > 4) pole(1, pa, qa, da);
    if constexpr (NC > 8) pole(5, pb, qb, db);
#pragma unroll
    for (int k = 9; k < NC - 1; k += 2) {
      dc[k] += dn2 * p[k];
      dc[k + 1] += dn2 * c[k] * p[k] * lw;
      dw += dn2 * c[k] * c[k + 1] * p[k] / w;
    }
    dw += dw2 * 2.f * w;
  } else if constexpr (F == 6) {  // gases
    const float inv_w2 = 1.f / (w * w);
    float dinv = 0.f;
    dc[0] += dn;
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) {
      const float inv = 1.f / (c[k + 1] - inv_w2);
      const float dd = -dn * c[k] * inv * inv;
      dc[k] += dn * inv;
      dc[k + 1] += dd;
      dinv -= dd;
    }
    dw -= dinv * 2.f * inv_w2 / w;
  } else if constexpr (F == 7) {  // Herzberger
    const float w2 = w * w;
    const float g = 1.f / (w2 - static_cast<float>(0.028));
    const float dg = dn * (c[1] + 2.f * c[2] * g);
    float dw2 = -dg * g * g;
    dc[0] += dn;
    dc[1] += dn * g;
    dc[2] += dn * g * g;
    float p = 1.f;
#pragma unroll
    for (int k = 3; k < NC; ++k) {
      p = p * w2;  // w2^(k - 2)
      dc[k] += dn * p;
      dw2 += dn * c[k] * (float)(k - 2) * p / w2;
    }
    dw += dw2 * 2.f * w;
  } else if constexpr (F == 8) {  // retro
    const float w2 = w * w;
    const float den = w2 - c[2];
    const float rhs = c[0] + c[1] * w2 / den + c[3] * w2;
    const float top = 2.f * rhs + 1.f, bot = 1.f - rhs;
    const float dq = dn * 0.5f / sqrtf(top / bot);
    const float drhs = 2.f * dq / bot + dq * top / (bot * bot);
    dc[0] += drhs;
    dc[1] += drhs * w2 / den;
    dc[2] += drhs * c[1] * w2 / (den * den);
    dc[3] += drhs * w2;
    dw += drhs * (c[3] - c[1] * c[2] / (den * den)) * 2.f * w;
  } else if constexpr (F == 9) {  // exotic
    const float w2 = w * w;
    const float d = w - c[4];
    const float d1 = w2 - c[2], e = d * d + c[5];
    const float n2 = c[0] + c[1] / d1 + c[3] * d / e;
    const float dn2 = dn * 0.5f / sqrtf(n2);
    const float dd1 = -dn2 * c[1] / (d1 * d1);
    const float de = -dn2 * c[3] * d / (e * e);
    const float dd = dn2 * c[3] / e + de * 2.f * d;
    dc[0] += dn2;
    dc[1] += dn2 / d1;
    dc[2] -= dd1;
    dc[3] += dn2 * d / e;
    dc[4] -= dd;
    dc[5] += de;
    dw += dd + dd1 * 2.f * w;
  } else if constexpr (F == 11) {  // polyval, highest power first
    float n = c[0], dndw = 0.f;
#pragma unroll
    for (int k = 1; k < NC; ++k) {
      dndw = dndw * w + n;
      n = n * w + c[k];
    }
    dw += dn * dndw;
    float p = dn;  // dn w^(NC - 1 - k)
#pragma unroll
    for (int k = NC - 1; k >= 0; --k) {
      dc[k] += p;
      p = p * w;
    }
  }
}

#ifdef OTK_MATERIALS
// A per-ray backward's record: REC, then the index after the surface (the
// running index past it) and the Beer-Lambert alpha of the medium before it
// at the ray's wavelength; row 0 holds the index of medium 0 at REC_N. Built
// with OTK_MEDIA_RECOMPUTE (a probe: tools/system_probes.py --per-ray), the
// record keeps REC floats and the reverse sweep evaluates the media again.
constexpr int REC_N = REC;
constexpr int REC_ALPHA = REC + 1;
#ifdef OTK_MEDIA_RECOMPUTE
constexpr int REC_W = REC;
#else
constexpr int REC_W = REC + 2;
#endif

// trace_chain at the ray's own wavelength: each surface's alpha and index
// from `media` (run-time k, compile-time formulas), then surface_step on
// them as on the tables; the record also keeps them (REC_N, REC_ALPHA), so
// that the reverse sweep reads each surface's media from it.
__device__ __forceinline__ void trace_chain_w(int S, int n_newton, const float* ft, const int* it,
                                              const RayMedia& media, Ray& r,
                                              float (*rec)[REC_W]) {
  float pos_prev = 0.f;
  float n_pre = media.index_after(0);
#ifndef OTK_MEDIA_RECOMPUTE
  rec[0][REC_N] = n_pre;
#endif
  for (int k = 1; k < S; ++k) {
    const float pos_k = pos_prev + (k > 1 ? ft[(k - 1) * F_STRIDE + F_THICK] : 0.f);
    pos_prev = pos_k;
    Surface s = load_surface(ft, it, k);
    s.alpha = s.absorbs ? media.alpha_after(k - 1) : 0.f;
    if (changes_index(s.inter)) s.n = media.index_after(k);
#ifdef OTK_INTERACTIONS
    if (s.inter == INT_DIFFRACT) s.gm = s.gm * media.w;  // the table's m, times w
#endif
#ifdef OTK_PHASE
    if (s.inter == INT_PHASE) s.ik = s.ik * media.w;  // the table's 1 / k0 per um, times w
#endif
    surface_step(s, k, n_newton, pos_k, r, n_pre, rec[k]);
#ifndef OTK_MEDIA_RECOMPUTE
    rec[k][REC_N] = n_pre;
    rec[k][REC_ALPHA] = s.alpha;
#endif
  }
}

// The per-ray outputs of the tabulated glasses (trace/fused.py
// `_tabulated_outputs`): slot t of ray idx gets its segment and the 4
// cotangents of interp_bwd.
struct TabulatedOut {
  int* seg;
  float* val;
  size_t n;
  int idx;
  __device__ __forceinline__ void put(int t, int segment, const float (&v)[4]) const {
    seg[t * n + idx] = segment;
#pragma unroll
    for (int q = 0; q < 4; ++q) val[(t * 4 + q) * n + idx] = v[q];
  }
};

// The slot of medium M among the tabulated media, in surface order.
template <int M>
__host__ __device__ constexpr int tabulated_slot() {
  int t = 0;
  for (int k = 0; k < M; ++k) t += material_codes(k).formula == FORMULA_TABULATED;
  return t;
}

// The compact position of coefficient j in a material row: the one whose
// table slot (`table_slot`) is j, so that `write_partials` leaves the row in
// coefficient order (j < MAT_SHARED).
__host__ __device__ constexpr int mat_compact(int j) {
  return j == 0 ? C_CV : (j == 1 ? C_CONIC : C_COEFFS + j - 2);
}

// The width of a material row of NC coefficients (a power of two >= 4).
template <int NC>
__host__ __device__ constexpr int mat_width() {
  const int top = mat_compact(NC - 1) + 1;
  return top <= 4 ? 4 : (top <= 8 ? 8 : (top <= 16 ? 16 : F_STRIDE));
}

// The adjoint of medium k's index for this ray: dn -> its coefficients'
// cotangents, summed by the warp into material row `row0 + k` of `rows`,
// or for a tabulated glass its segment's, written per ray to `tab`; and
// d w. Every lane of the warp calls it with the same k (the chain's k, at
// run time: comparisons on it choose the medium's compile-time formula);
// dead lanes (live false) add zeros.
template <int M = 0, class Rows>
__device__ __forceinline__ void medium_bwd(int k, const RayMedia& media, float dn, bool live,
                                           const Rows& rows, int row0, const TabulatedOut& tab,
                                           float& dw) {
  if constexpr (M < MEDIA) {
    if (k != M) {
      medium_bwd<M + 1>(k, media, dn, live, rows, row0, tab, dw);
      return;
    }
    constexpr MaterialCodes m = material_codes(M);
    if constexpr (m.formula == FORMULA_TABULATED) {
      if (live) {
        int seg;
        float v[4];
        interp_bwd(media.w, media.mat + (size_t)M * media.mat_w,
                   media.mat + (size_t)M * media.mat_w + m.nc / 2, m.nc / 2, dn, seg, v, dw);
        tab.put(tabulated_slot<M>(), seg, v);
      }
    } else {
      float dc[m.nc];
#pragma unroll
      for (int j = 0; j < m.nc; ++j) dc[j] = 0.f;
      if (live)
        material_index_bwd<m.formula, m.nc>(media.s_mat + M * MAT_SHARED, media.w, dn, dc, dw);
      float v[F_STRIDE];
#pragma unroll
      for (int j = 0; j < F_STRIDE; ++j) v[j] = 0.f;
#pragma unroll
      for (int j = 0; j < m.nc; ++j) v[mat_compact(j)] = dc[j];
      rows.put(row0 + M, v, mat_width<m.nc>());
    }
  }
}

// reverse_chain at the ray's own wavelength: each surface's index and
// alpha from the record (trace_chain_w); where a refraction completes the
// cotangent of the medium after it (surface_bwd's n slot: the refraction at
// k and at the next refracting surface, and the opd terms between), and
// for medium 0 at the end, `medium_bwd` turns it into that medium's
// coefficient cotangents and d w before any sum over rays, so the n_table
// slots stay 0; each absorbing medium adds -t 1e3 (i di) d alpha / d w,
// with d alpha / d w = 4 pi (kv' / w - kv / w^2); a grating's m w gives
// w its m and m its w, a phase sheet's 1 / k0 = C w (C the table's 1 / k0
// per um) gives w its C. Material rows go to `row0 + k`; dw returns the
// ray's w cotangent; g_i as reverse_chain's.
template <class Rows>
__device__ __forceinline__ void reverse_chain_w(int S, const float* ft, const int* it,
                                                const float* pos, const RayMedia& media,
                                                const float (*rec)[REC_W], bool live,
                                                float g_opd, float g_ip, Vec6& g,
                                                const Rows& rows, int row0,
                                                const TabulatedOut& tab, float& dw,
                                                float g_i = 0.f) {
  float acc_n = 0.f, acc_pos = 0.f;
  dw = 0.f;
  for (int k = S - 1; k >= 1; --k) {
    Surface s = load_surface(ft, it, k);
    SurfGrad sg;
    zero(sg);
    float dpos = 0.f;
    if (live) {
#ifdef OTK_MEDIA_RECOMPUTE
      int before = 0;  // the medium before surface k: its last refraction
      for (int j = 1; j < k; ++j)
        if (changes_index(it[j * I_STRIDE + I_INTER])) before = j;
      if (changes_index(s.inter)) s.n = media.index_after(k);
      s.alpha = s.absorbs ? media.alpha_after(k - 1) : 0.f;
      const float n_pre = media.index_after(before);
#else
      s.n = rec[k][REC_N];
      s.alpha = rec[k][REC_ALPHA];
      const float n_pre = rec[k - 1][REC_N];
#endif
#ifdef OTK_INTERACTIONS
      const float m = s.gm;  // a grating's order
      if (s.inter == INT_DIFFRACT) s.gm = m * media.w;
#endif
#ifdef OTK_PHASE
      const float ik_per_w = s.ik;  // a phase sheet's 1 / k0 per um
      if (s.inter == INT_PHASE) s.ik = ik_per_w * media.w;
#endif
      surface_bwd(s, rec[k], n_pre, pos[k], g_opd, g_ip, g, acc_n, dpos, sg, &g_i);
#ifdef OTK_INTERACTIONS
      if (s.inter == INT_DIFFRACT) {  // sg.co[0] is m w's cotangent
        dw += sg.co[0] * m;
        sg.co[0] = sg.co[0] * media.w;
      }
#endif
#ifdef OTK_PHASE
      if (s.inter == INT_PHASE) {  // 1 / k0's cotangent: w's, C a constant
        dw += sg.co[PHASE_SLOTS] * ik_per_w;
        sg.co[PHASE_SLOTS] = 0.f;
      }
#endif
      if (s.absorbs) {
        const size_t row = (size_t)(k - 1) * media.K;
        float slope;
        const float kv = kv_segment(media.w, media.kwl + row, media.kval + row, media.K, slope);
        const float w = media.w;
        dw -= rec[k][6] * 1e3f * g_ip * (FOUR_PI * slope / w - FOUR_PI * kv / (w * w));
      }
    }
    sg.thick = acc_pos;
    acc_pos += dpos;
    const float dn = sg.n;
    sg.n = 0.f;
    float v[F_STRIDE];
    grad_row(sg, v);
    rows.put(k, v, row_width(s));
#ifdef OTK_WIDE
    put_wide_rows(s, sg, rows);
#endif
    if (changes_index(s.inter)) medium_bwd(k, media, dn, live, rows, row0, tab, dw);
  }
  medium_bwd(0, media, acc_n, live, rows, row0, tab, dw);
}
#endif

}  // namespace otk
