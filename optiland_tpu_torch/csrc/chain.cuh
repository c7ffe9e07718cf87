// The fused surface chain, one ray per thread, for Hopper (sm_90a).
//
// Port of the per-tile body of the Pallas kernels in
// optiland_tpu/trace/fused.py: `tile_raygen` is `_tile_raygen`,
// `trace_chain` is `_tile_trace` (value pass) for the branches of the
// port: plane / conic / even / odd asphere geometries, refract / reflect /
// none interactions, radial apertures, tilt and decenter, Beer-Lambert
// absorption, and, in a build with OTK_INTERACTIONS (trace/fused.py
// `branch_defines`: a system that has them), simple coatings, the ideal
// thin lens and gratings on plane and curved carriers, and with OTK_PHASE
// too, phase sheets of the constant, radial and linear-grating kinds on
// plane and conic carriers; in a build with OTK_FREEFORM, the freeform
// geometries of freeform.cuh (a conic seed, their own Newton count); at one wavelength from the hoisted index,
// absorption, grating and phase tables (`TableMedia`),
// or at each ray's own wavelength (`RayMedia`:
// `material_index` for every formula code of materials/dispersion.py and
// `kv_segment` of the extinction tables; K7 and the per-ray variants of
// K1-K6, built with the media's codes, OTK_MATERIALS). The
// Python wrappers (trace/fused.py, `_check_kernel_branches`) refuse every
// other branch before a launch. chain_bwd.cuh holds the reverse sweep
// built from the same pieces.
//
// The JAX kernel unrolls the chain on static per-surface codes. Here one
// surface's step (`surface_step`) is written once, and two chains call it:
// `trace_chain` loops over the surfaces at run time and switches on the
// codes held in the int table (the re-trace of K2, K4 and K6, both tables
// staged in shared memory once per block), and system_chain.cuh unrolls
// it over codes that are compile-time constants of one system (K1, K3, K5
// and K7), so that its branches fold.
//
// Numerics kept from the JAX kernel: the closed-form conic seed with the
// same 1e-12 safe-divides and root choice, min(newton_iters, 2) + 1 Newton
// updates for aspheres (none for pure conics), opd += |t n|, i *= valid,
// aperture x^2 + y^2 <= r^2, normal orientation by sign(l.n), TIR
// passthrough, i *= exp(-alpha t 1e3) in an absorbing medium. IEEE sqrtf /
// tanf / powf / expf and no fast-math (the per-system builds take
// approximate division and square root, _build.py PER_SYSTEM).
#pragma once

#include <cuda_runtime.h>

namespace otk {

// per-surface float slots (trace/fused.py `_pack_tables` writes them)
constexpr int F_CV = 0;
constexpr int F_CONIC = 1;
constexpr int F_COEFFS = 2;  // 17 slots
constexpr int F_THICK = 19;
constexpr int F_TILT = 20;   // rx, ry, rz
constexpr int F_DEC = 23;    // dx, dy
constexpr int F_NTAB = 25;   // index after the surface at the wavelength
constexpr int F_ALPHA = 26;  // Beer-Lambert alpha of the medium after the surface
constexpr int F_AP = 27;     // radial semi-aperture
constexpr int F_COAT = 28;   // a simple coating's factor: T, or R after a reflection
constexpr int F_STRIDE = 32;
constexpr int MAX_COEFFS = F_THICK - F_COEFFS;
// A build with OTK_WIDE (trace/fused.py `_wide_defines`: a system with a
// surface of more than MAX_COEFFS coefficient slots) reads each such
// surface's whole row, CO_MAX slots at most, from the float table's tail:
// OTK_WIDE_FLOATS floats after the S rows (the row's own slots keep its
// first MAX_COEFFS, the norms among them), at the offset of its codes
// (`xoff`, from the table's start); the backward kernels sum the
// cotangents of its slots past MAX_COEFFS in OTK_WIDE_ROWS rows of their
// own (chain_bwd.cuh `put_wide_rows`), the surface's from row `xrow` of
// them.
// OTK_FT_FLOATS(S): the floats of a system's float table; OTK_ROWS(n): the
// rows of a backward block of n table, raygen and material rows. Macros,
// so that a build without OTK_WIDE compiles the expressions it always had.
#ifdef OTK_WIDE
constexpr int CO_MAX = OTK_WIDE;
constexpr int WIDE_FLOATS = OTK_WIDE_FLOATS;
constexpr int WIDE_ROWS = OTK_WIDE_ROWS;
#define OTK_FT_FLOATS(S) ((S) * otk::F_STRIDE + otk::WIDE_FLOATS)
#define OTK_ROWS(n) ((n) + otk::WIDE_ROWS)
#else
constexpr int CO_MAX = MAX_COEFFS;
#define OTK_FT_FLOATS(S) ((S) * otk::F_STRIDE)
#define OTK_ROWS(n) (n)
#endif
// a thin lens or a grating is a plane or a conic: its first coefficient
// slots hold the focal length, or the grating's order times the wavelength
// (the order alone at per-ray wavelengths), period (um) and groove angle
constexpr int F_FOCAL = F_COEFFS;
constexpr int F_GRATING = F_COEFFS;
// a phase sheet (a plane or a conic) holds its profile's PHASE_SLOTS slots
// there, then 1 / k0 (mm) at one wavelength, 1 / k0 per um of wavelength at
// per-ray wavelengths
constexpr int PHASE_SLOTS = 8;
constexpr int F_PHASE = F_COEFFS;
constexpr int F_PHASE_IK = F_PHASE + PHASE_SLOTS;

// per-surface int slots
constexpr int I_GEOM = 0;
constexpr int I_NCOEF = 1;
constexpr int I_INTER = 2;
constexpr int I_TILT = 3;
constexpr int I_DEC = 4;
constexpr int I_AP = 5;
constexpr int I_ABS = 6;   // 1 where the medium after the surface absorbs
constexpr int I_COAT = 7;  // 1 where the surface applies a simple coating's factor
constexpr int I_REFL = 8;   // 1 for a reflective grating or phase sheet
constexpr int I_PHASE = 9;  // a phase sheet's kind (PHASE_*), else 0
// a freeform surface's aux ints (Chebyshev rows and columns, a Zernike's
// convention) and its Newton updates after the first (OTK_FREEFORM)
constexpr int I_AUX0 = 10;
constexpr int I_AUX1 = 11;
constexpr int I_NEWTON_FF = 12;
// a wide surface's offset in the float table and first wide row (OTK_WIDE)
constexpr int I_XOFF = 13;
constexpr int I_XROW = 14;
constexpr int I_STRIDE = 16;

constexpr int GEOM_PLANE = 0;
constexpr int GEOM_EVEN_ASPHERE = 2;
constexpr int GEOM_ODD_ASPHERE = 3;
constexpr int INT_REFRACT = 0;
constexpr int INT_REFLECT = 1;
constexpr int INT_THIN_LENS = 2;
constexpr int INT_NONE = 3;
constexpr int INT_DIFFRACT = 4;
constexpr int INT_PHASE = 5;
constexpr int PHASE_CONSTANT = 1;
constexpr int PHASE_RADIAL = 2;
constexpr int PHASE_LINEAR_GRATING = 3;
constexpr int FORMULA_TABULATED = 10;
// leading material coefficients staged in shared memory (K7): every formula
// but the tabulated one has at most this many
constexpr int MAT_SHARED = 17;

// the surfaces a backward kernel's per-thread record holds at one
// wavelength: 64, or the bucket of a longer system (trace/fused.py
// `backward_defines`: the power of two that holds it)
#ifdef OTK_MAX_SURFACES
constexpr int MAX_SURFACES = OTK_MAX_SURFACES;
#else
constexpr int MAX_SURFACES = 64;
#endif
constexpr int BLOCK = 256;
constexpr float EPS = 1e-12f;
// the float nearest pi / 180, written as a cast of the double literal so
// that a host build in double (tests/test_torch_chain_host.py) keeps it exact
constexpr float DEG2RAD = static_cast<float>(0.017453292519943295);
constexpr float FOUR_PI = static_cast<float>(12.566370614359172);
// jnp.interp's zero-width-segment threshold in float32: the spacing of eps
constexpr float INTERP_DX0 = static_cast<float>(1.4210854715202004e-14);

// floats the re-trace of a backward kernel keeps per surface: the entry
// state (x, y, z, L, M, N, global frame) and the ray parameter t; with
// OTK_INTERACTIONS also the entry intensity (REC_I, for the coatings'
// cotangents). The surface's vertex z and, at one wavelength, the index
// before it are the same for every ray (chain_bwd.cuh `surface_frames`).
#ifdef OTK_INTERACTIONS
constexpr int REC_I = 7;
constexpr int REC = 8;
#else
constexpr int REC = 7;
#endif

struct Ray {
  float x, y, z, L, M, N, i, opd;
};

// One surface's static codes: the int table's row, or a per-system
// kernel's compile-time constants. `absorbs` is the medium's after it.
struct Codes {
  int geom, nc, inter;
  bool tilted, decentered, aperture, absorbs;
#ifdef OTK_INTERACTIONS
  // a simple coating's factor; a reflective grating or phase sheet
  bool coated, reflective;
#endif
#ifdef OTK_PHASE
  int pk;  // a phase sheet's kind
#endif
#ifdef OTK_FREEFORM
  int a0, a1, nff;  // a freeform's aux ints and Newton updates after the first
#endif
#ifdef OTK_WIDE
  int xoff, xrow;  // a wide surface's row in the table's tail, its wide rows (0: none)
#endif
};

// One surface's codes and values, read from the staged tables. `absorbs`
// and `alpha` are those of the medium before the surface (row k - 1).
// With OTK_INTERACTIONS: `coat` is the coating's factor, `gm` a grating's
// order times the ray's wavelength (surface_step sets it from the media);
// with OTK_PHASE: `pk` a phase sheet's kind, `ik` its 1 / k0 at the ray's
// wavelength (surface_step sets it from the media).
struct Surface {
  int code, nc, inter;
  bool tilted, decentered, aperture, absorbs;
  float cv, kk, tx, ty, rx, ry, rz, ap, n, alpha;
  const float* co;
#ifdef OTK_INTERACTIONS
  bool coated, reflective;
  float coat, gm;
#endif
#ifdef OTK_PHASE
  int pk;
  float ik;
#endif
#ifdef OTK_FREEFORM
  int a0, a1, nff;
  float k;  // the conic constant itself (a freeform's sag takes k, not 1 + k)
#endif
#ifdef OTK_WIDE
  int xrow;
#endif
};

__device__ __forceinline__ float sign_of(float v) {
  return (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
}

__device__ __forceinline__ Codes codes_at(const int* it, int k) {
  const int* c = it + k * I_STRIDE;
  return Codes{c[I_GEOM], c[I_NCOEF], c[I_INTER], c[I_TILT] != 0,
               c[I_DEC] != 0, c[I_AP] != 0, c[I_ABS] != 0
#ifdef OTK_INTERACTIONS
               , c[I_COAT] != 0, c[I_REFL] != 0
#endif
#ifdef OTK_PHASE
               , c[I_PHASE]
#endif
#ifdef OTK_FREEFORM
               , c[I_AUX0], c[I_AUX1], c[I_NEWTON_FF]
#endif
#ifdef OTK_WIDE
               , c[I_XOFF], c[I_XROW]
#endif
  };
}

// Whether the index changes at a surface of interaction `inter` (JAX's
// n_of(k) after it): a refraction, and with OTK_INTERACTIONS a thin lens, a
// grating or a phase sheet (on a mirror too: the medium's row after it).
__device__ __forceinline__ bool changes_index(int inter) {
#ifdef OTK_INTERACTIONS
  return inter != INT_NONE && inter != INT_REFLECT;
#else
  return inter == INT_REFRACT;
#endif
}

// Surface k from its codes, the absorption flag of the medium before it
// and the float table.
__device__ __forceinline__ Surface make_surface(const Codes& c, bool absorbs_before,
                                                const float* ft, int k) {
  const float* f = ft + k * F_STRIDE;
  Surface s;
  s.code = c.geom;
  s.nc = c.nc;
  s.inter = c.inter;
  s.tilted = c.tilted;
  s.decentered = c.decentered;
  s.aperture = c.aperture;
  s.cv = f[F_CV];
  s.kk = 1.f + f[F_CONIC];
  s.tx = f[F_DEC];
  s.ty = f[F_DEC + 1];
  s.rx = f[F_TILT];
  s.ry = f[F_TILT + 1];
  s.rz = f[F_TILT + 2];
  s.ap = f[F_AP];
  s.n = f[F_NTAB];
#ifdef OTK_WIDE
  s.co = c.xoff ? ft + c.xoff : f + F_COEFFS;
  s.xrow = c.xrow;
#else
  s.co = f + F_COEFFS;
#endif
  s.absorbs = k > 0 && absorbs_before;
  s.alpha = k > 0 ? ft[(k - 1) * F_STRIDE + F_ALPHA] : 0.f;
#ifdef OTK_INTERACTIONS
  s.coated = c.coated;
  s.reflective = c.reflective;
  s.coat = c.coated ? f[F_COAT] : 1.f;
  s.gm = c.inter == INT_DIFFRACT ? f[F_GRATING] : 0.f;
#endif
#ifdef OTK_PHASE
  s.pk = c.pk;
  s.ik = c.inter == INT_PHASE ? f[F_PHASE_IK] : 0.f;
#endif
#ifdef OTK_FREEFORM
  s.a0 = c.a0;
  s.a1 = c.a1;
  s.nff = c.nff;
  s.k = f[F_CONIC];
#endif
  return s;
}

__device__ __forceinline__ Surface load_surface(const float* ft, const int* it, int k) {
  return make_surface(codes_at(it, k), k > 0 && it[(k - 1) * I_STRIDE + I_ABS] != 0, ft,
                      k);
}

__device__ __forceinline__ bool is_asphere(const Surface& s) {
  return (s.code == GEOM_EVEN_ASPHERE || s.code == GEOM_ODD_ASPHERE) && s.nc;
}

// Stage the float table (OTK_FT_FLOATS(S) floats), the (S, I_STRIDE) int
// table and the five raygen scalars into shared memory; every thread of the
// block calls it.
__device__ __forceinline__ void stage_tables(int S, const float* __restrict__ ftab,
                                             const int* __restrict__ itab,
                                             const float* __restrict__ rg,
                                             float* s_ft, int* s_it, float* s_rg) {
  for (int j = threadIdx.x; j < OTK_FT_FLOATS(S); j += blockDim.x) s_ft[j] = ftab[j];
  for (int j = threadIdx.x; j < S * I_STRIDE; j += blockDim.x) s_it[j] = itab[j];
  if (rg != nullptr && threadIdx.x < 5) s_rg[threadIdx.x] = rg[threadIdx.x];
  __syncthreads();
}

// Stage the first MAT_SHARED columns of the (S, mat_w) material rows into
// shared memory (K7); every thread of the block calls it, before its
// __syncthreads.
__device__ __forceinline__ void stage_materials(int S, int mat_w,
                                                const float* __restrict__ mat,
                                                float* s_mat) {
  const int cols = mat_w < MAT_SHARED ? mat_w : MAT_SHARED;
  for (int j = threadIdx.x; j < S * MAT_SHARED; j += blockDim.x) {
    const int k = j / MAT_SHARED, c = j % MAT_SHARED;
    s_mat[j] = c < cols ? mat[(size_t)k * mat_w + c] : 0.f;
  }
}

// The segment (i0, i) of a (K,) table xp that jnp.interp reads for x: a
// binary search for the first xp > x, clipped to [1, K - 1], i0 = i - 1
// (both 0 for a one-point table).
__device__ __forceinline__ void interp_segment(float x, const float* xp, int K, int& i0,
                                               int& i) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xp[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  i = K > 1 ? (lo < 1 ? 1 : (lo > K - 1 ? K - 1 : lo)) : 0;
  i0 = K > 1 ? i - 1 : 0;
}

// jnp.interp(x, xp, fp) over a (K,) table in global memory: the segment
// `interp_segment` finds, a zero-width segment taking its left value,
// edge-clamped outside [xp[0], xp[K-1]].
__device__ __forceinline__ float interp(float x, const float* xp, const float* fp, int K) {
  int i0, i;
  interp_segment(x, xp, K, i0, i);
  const float dx = xp[i] - xp[i0];
  float f = (fabsf(dx) <= INTERP_DX0) ? fp[i0] : fp[i0] + ((x - xp[i0]) / dx) * (fp[i] - fp[i0]);
  if (x < xp[0]) f = fp[0];
  if (x > xp[K - 1]) f = fp[K - 1];
  return f;
}

// Refractive index n(w) of dispersion formula `formula` with nc
// coefficients c (`material_index` of materials/dispersion.py, same
// operation order); `row` is the material's whole row in global memory,
// read by the tabulated formula only.
__device__ __forceinline__ float material_index(int formula, int nc, const float* c,
                                                const float* row, float w) {
  const float w2 = w * w;
  switch (formula) {
    case 0:  // ideal
      return c[0];
    case 1:    // Sellmeier, squared poles
    case 2: {  // Sellmeier, poles as given
      float n2 = 1.f + c[0];
      for (int k = 1; k < nc - 1; k += 2) {
        const float d = formula == 1 ? c[k + 1] * c[k + 1] : c[k + 1];
        n2 = n2 + c[k] * w2 / (w2 - d);
      }
      return sqrtf(n2);
    }
    case 3: {  // polynomial
      float n2 = c[0];
      for (int k = 1; k < nc - 1; k += 2) n2 = n2 + c[k] * powf(w, c[k + 1]);
      return sqrtf(n2);
    }
    case 4: {  // refractiveindex.info formula 4
      float n2 = c[0];
      if (nc > 4) n2 = n2 + c[1] * powf(w, c[2]) / (w2 - powf(c[3], c[4]));
      if (nc > 8) n2 = n2 + c[5] * powf(w, c[6]) / (w2 - powf(c[7], c[8]));
      for (int k = 9; k < nc - 1; k += 2) n2 = n2 + c[k] * powf(w, c[k + 1]);
      return sqrtf(n2);
    }
    case 5: {  // Cauchy
      float n = c[0];
      for (int k = 1; k < nc - 1; k += 2) n = n + c[k] * powf(w, c[k + 1]);
      return n;
    }
    case 6: {  // gases
      const float inv_w2 = 1.f / w2;
      float n = 1.f + c[0];
      for (int k = 1; k < nc - 1; k += 2) n = n + c[k] / (c[k + 1] - inv_w2);
      return n;
    }
    case 7: {  // Herzberger: integer powers w^(2 (k - 2))
      const float g = 1.f / (w2 - static_cast<float>(0.028));
      float n = c[0] + c[1] * g + c[2] * g * g;
      float p = 1.f;
      for (int k = 3; k < nc; ++k) {
        p = p * w2;
        n = n + c[k] * p;
      }
      return n;
    }
    case 8: {  // retro
      const float rhs = c[0] + c[1] * w2 / (w2 - c[2]) + c[3] * w2;
      return sqrtf((2.f * rhs + 1.f) / (1.f - rhs));
    }
    case 9: {  // exotic
      const float d = w - c[4];
      return sqrtf(c[0] + c[1] / (w2 - c[2]) + c[3] * d / (d * d + c[5]));
    }
    case FORMULA_TABULATED: {  // (wavelengths..., indices...)
      const int K = nc / 2;
      return interp(w, row, row + K, K);
    }
    default: {  // 11: polyval, highest power first
      float n = c[0];
      for (int k = 1; k < nc; ++k) n = n * w + c[k];
      return n;
    }
  }
}

// `material_index` of formula F with NC coefficients, both compile-time
// constants of a per-system build (K7): the loops unroll and the switch
// folds; the same arithmetic in the same order.
template <int F, int NC>
__device__ __forceinline__ float material_index(const float* c, const float* row, float w) {
  if constexpr (F == 0) {  // ideal
    return c[0];
  } else if constexpr (F == 1 || F == 2) {  // Sellmeier
    const float w2 = w * w;
    float n2 = 1.f + c[0];
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) {
      const float d = F == 1 ? c[k + 1] * c[k + 1] : c[k + 1];
      n2 = n2 + c[k] * w2 / (w2 - d);
    }
    return sqrtf(n2);
  } else if constexpr (F == 3) {  // polynomial
    float n2 = c[0];
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) n2 = n2 + c[k] * powf(w, c[k + 1]);
    return sqrtf(n2);
  } else if constexpr (F == 4) {  // refractiveindex.info formula 4
    const float w2 = w * w;
    float n2 = c[0];
    if constexpr (NC > 4) n2 = n2 + c[1] * powf(w, c[2]) / (w2 - powf(c[3], c[4]));
    if constexpr (NC > 8) n2 = n2 + c[5] * powf(w, c[6]) / (w2 - powf(c[7], c[8]));
#pragma unroll
    for (int k = 9; k < NC - 1; k += 2) n2 = n2 + c[k] * powf(w, c[k + 1]);
    return sqrtf(n2);
  } else if constexpr (F == 5) {  // Cauchy
    float n = c[0];
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) n = n + c[k] * powf(w, c[k + 1]);
    return n;
  } else if constexpr (F == 6) {  // gases
    const float inv_w2 = 1.f / (w * w);
    float n = 1.f + c[0];
#pragma unroll
    for (int k = 1; k < NC - 1; k += 2) n = n + c[k] / (c[k + 1] - inv_w2);
    return n;
  } else if constexpr (F == 7) {  // Herzberger
    const float w2 = w * w;
    const float g = 1.f / (w2 - static_cast<float>(0.028));
    float n = c[0] + c[1] * g + c[2] * g * g;
    float p = 1.f;
#pragma unroll
    for (int k = 3; k < NC; ++k) {
      p = p * w2;
      n = n + c[k] * p;
    }
    return n;
  } else if constexpr (F == 8) {  // retro
    const float w2 = w * w;
    const float rhs = c[0] + c[1] * w2 / (w2 - c[2]) + c[3] * w2;
    return sqrtf((2.f * rhs + 1.f) / (1.f - rhs));
  } else if constexpr (F == 9) {  // exotic
    const float w2 = w * w;
    const float d = w - c[4];
    return sqrtf(c[0] + c[1] / (w2 - c[2]) + c[3] * d / (d * d + c[5]));
  } else if constexpr (F == FORMULA_TABULATED) {  // the whole row, in global memory
    return interp(w, row, row + NC / 2, NC / 2);
  } else {  // 11: polyval, highest power first
    float n = c[0];
#pragma unroll
    for (int k = 1; k < NC; ++k) n = n * w + c[k];
    return n;
  }
}

// Unrolled linear interpolation of a (K,)-point extinction table with
// float masks: the JAX `_kv_interp` as written (edge-clamped, a guarded
// divide on the zero-width segments of a padded table). `kv_segment`
// computes the same float; this form is its oracle (tests).
__device__ __forceinline__ float kv_interp(float w, const float* kwl, const float* kval,
                                           int K) {
  const float lo = (w <= kwl[0]) ? 1.f : 0.f;
  const float hi = (w > kwl[K - 1]) ? 1.f : 0.f;
  float kv = lo * kval[0] + hi * kval[K - 1];
  for (int j = 0; j < K - 1; ++j) {
    const float w0 = kwl[j], w1 = kwl[j + 1];
    const float dw = (fabsf(w1 - w0) > EPS) ? w1 - w0 : 1.f;
    const float frac = (w - w0) / dw;
    const float val = kval[j] + frac * (kval[j + 1] - kval[j]);
    const float inseg = (w > w0 ? 1.f : 0.f) * (w <= w1 ? 1.f : 0.f);
    kv = kv + inseg * val;
  }
  return kv;
}

// `kv_interp` by its one segment: the edge values outside the table (and
// for a NaN w), else the segment w0 < w <= w1, found by a binary search
// for the first point >= w, and its `val` by the same arithmetic. Of
// kv_interp's masked sum every other term is 0 * val or 0 * kval, an exact
// 0 for a finite table, so the two give the same float; no zero-width
// segment of a padded table can hold w0 < w <= w1. Also gives the slope of
// that segment, d kv / d w: 0 outside the table and at its first point,
// where kv is an edge value (the derivative autograd takes of
// `_kv_interp`, whose masks are constants; the backward kernels'
// absorption adjoint).
__device__ __forceinline__ float kv_segment(float w, const float* kwl, const float* kval, int K,
                                            float& slope) {
  slope = 0.f;
  if (!(w > kwl[0])) return kval[0];
  if (w > kwl[K - 1]) return kval[K - 1];
  int lo = 1, hi = K - 1;  // the first j >= 1 with kwl[j] >= w
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kwl[mid] < w)
      lo = mid + 1;
    else
      hi = mid;
  }
  const float w0 = kwl[lo - 1], w1 = kwl[lo];
  const float dw = (fabsf(w1 - w0) > EPS) ? w1 - w0 : 1.f;
  const float dk = kval[lo] - kval[lo - 1];
  slope = dk / dw;
  return kval[lo - 1] + ((w - w0) / dw) * dk;
}

__device__ __forceinline__ float kv_segment(float w, const float* kwl, const float* kval,
                                            int K) {
  float slope;  // unused: the compiler drops its division
  return kv_segment(w, kwl, kval, K, slope);
}

// Ray generation from rg = (epl, epd, fmax, a, b): `_tile_raygen`.
__device__ __forceinline__ Ray tile_raygen(int field_angle, int object_infinite,
                                           const float* rg, float Hx, float Hy,
                                           float Px, float Py) {
  const float epl = rg[0], epd = rg[1], fmax = rg[2], a = rg[3], b = rg[4];
  const float half = epd * 0.5f;
  float x0, y0;
  if (field_angle) {
    const float tx = tanf((fmax * Hx) * DEG2RAD);
    const float ty = tanf((fmax * Hy) * DEG2RAD);
    if (object_infinite) {
      x0 = Px * half - tx * b;
      y0 = Py * half - ty * b;
    } else {
      x0 = -tx * b;
      y0 = -ty * b;
    }
  } else {  // object height, finite object
    x0 = fmax * Hx;
    y0 = fmax * Hy;
  }
  const float z0 = a;
  const float dx = Px * half - x0;
  const float dy = Py * half - y0;
  const float dz = epl - z0;
  const float mag2 = dx * dx + dy * dy + dz * dz;
  const float degen = (mag2 < 1e-18f) ? 1.f : 0.f;
  const float inv = rsqrtf(fmaxf(mag2, 1e-18f));
  Ray r;
  r.x = x0;
  r.y = y0;
  r.z = z0;
  r.L = (1.f - degen) * dx * inv;
  r.M = (1.f - degen) * dy * inv;
  r.N = (1.f - degen) * dz * inv + degen;
  r.i = 1.f;
  r.opd = 0.f;
  return r;
}

// Conic + polynomial sag (when want_sag) and the gradient (gx, gy) at
// (x, y): `_sag_grad_terms` with the odd-asphere 1/r term folded in.
__device__ __forceinline__ void sag_grad(int code, int nc, const float* co, float cv,
                                         float kk, float x, float y, bool want_sag,
                                         float& s, float& gx, float& gy) {
  const float r2 = x * x + y * y;
  const float m = fmaxf(1.f - kk * cv * cv * r2, EPS);
  const float inv_root = rsqrtf(m);
  const float root = m * inv_root;
  if (want_sag) s = cv * r2 / (1.f + root);
  const float gmul = cv * inv_root;
  if (code == GEOM_EVEN_ASPHERE && nc) {
    float rp = r2, rp0 = 1.f, g = 0.f;
    for (int ci = 0; ci < nc; ++ci) {
      if (want_sag) {
        s = s + co[ci] * rp;
        rp = rp * r2;
      }
      g = g + (2.f * (ci + 1)) * co[ci] * rp0;
      rp0 = rp0 * r2;
    }
    gx = x * (gmul + g);
    gy = y * (gmul + g);
  } else if (code == GEOM_ODD_ASPHERE && nc) {
    const float r = sqrtf(fmaxf(r2, EPS));
    float rpow = r, rpow0 = 1.f, g = 0.f;
    for (int ci = 0; ci < nc; ++ci) {
      if (want_sag) {
        s = s + co[ci] * rpow;
        rpow = rpow * r;
      }
      g = g + (float)(ci + 1) * co[ci] * rpow0;
      rpow0 = rpow0 * r;
    }
    const float godd = g / r;
    gx = x * gmul + x * godd;
    gy = y * gmul + y * godd;
  } else {
    gx = x * gmul;
    gy = y * gmul;
  }
}

// Rotate positions and directions about one axis (0 = x, 1 = y, 2 = z).
__device__ __forceinline__ void rotate(int axis, float ang, float& x, float& y, float& z,
                                       float& L, float& M, float& N) {
  const float c = cosf(ang), s = sinf(ang);
  float a, b;
  if (axis == 2) {
    a = x * c - y * s; b = x * s + y * c; x = a; y = b;
    a = L * c - M * s; b = L * s + M * c; L = a; M = b;
  } else if (axis == 1) {
    a = x * c + z * s; b = -x * s + z * c; x = a; z = b;
    a = L * c + N * s; b = -L * s + N * c; L = a; N = b;
  } else {
    a = y * c - z * s; b = y * s + z * c; y = a; z = b;
    a = M * c - N * s; b = M * s + N * c; M = a; N = b;
  }
}

// Global frame -> the frame of surface s at vertex z `pos`.
__device__ __forceinline__ void to_local(const Surface& s, float pos, float& x, float& y,
                                         float& z, float& L, float& M, float& N) {
  if (s.tilted || s.decentered) {
    x = x - s.tx;
    y = y - s.ty;
  }
  z = z - pos;
  if (s.tilted) {
    rotate(2, -s.rz, x, y, z, L, M, N);
    rotate(1, -s.ry, x, y, z, L, M, N);
    rotate(0, -s.rx, x, y, z, L, M, N);
  }
}

// The frame of surface s -> global frame.
__device__ __forceinline__ void to_global(const Surface& s, float pos, float& x, float& y,
                                          float& z, float& L, float& M, float& N) {
  if (s.tilted) {
    rotate(0, s.rx, x, y, z, L, M, N);
    rotate(1, s.ry, x, y, z, L, M, N);
    rotate(2, s.rz, x, y, z, L, M, N);
  }
  z = z + pos;
  if (s.tilted || s.decentered) {
    x = x + s.tx;
    y = y + s.ty;
  }
}

#ifdef OTK_FREEFORM
}  // namespace otk
#include "freeform.cuh"
namespace otk {
#endif

// Ray parameter t of the hit on surface s (local frame): closed-form conic
// root, then n_newton + 1 Newton updates for aspheres (and, with
// OTK_FREEFORM, s.nff + 1 for freeforms: JAX's min(newton_iters, 6)). validf
// is 0 where the conic root does not exist.
__device__ __forceinline__ float intersect(const Surface& s, int n_newton, float x, float y,
                                           float z, float L, float M, float N,
                                           float& validf) {
  const float cv = s.cv, kk = s.kk;
  // closed-form conic intersection (curvature form)
  const float A = cv * (L * L + M * M + kk * N * N);
  const float B = 2.f * (cv * (L * x + M * y + kk * N * z) - N);
  const float C = cv * (x * x + y * y + kk * z * z) - 2.f * z;
  const float disc = B * B - 4.f * A * C;
  validf = (disc >= 0.f) ? 1.f : 0.f;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const bool bigA = fabsf(A) > EPS;
  const float inv2A = 1.f / (2.f * (bigA ? A : 1.f));
  const float t1 = (-B + sq) * inv2A;
  const float t2 = (-B - sq) * inv2A;
  const float t_quad = (fabsf(z + t1 * N) <= fabsf(z + t2 * N)) ? t1 : t2;
  const float B_safe = (fabsf(B) > EPS) ? B : EPS;
  float t = bigA ? t_quad : -C / B_safe;
  if (!bigA) validf = 1.f;

  if (is_asphere(s)) {
    for (int itn = 0; itn <= n_newton; ++itn) {
      const float xt = x + t * L, yt = y + t * M, zt = z + t * N;
      float sv, gx, gy;
      sag_grad(s.code, s.nc, s.co, cv, kk, xt, yt, true, sv, gx, gy);
      const float fv = sv - zt;
      float fp = gx * L + gy * M - N;
      fp = (fabsf(fp) > EPS) ? fp : EPS;
      t = t - fv / fp;
    }
  }
#ifdef OTK_FREEFORM
  else if (is_freeform(s)) {
    for (int itn = 0; itn <= s.nff; ++itn) {
      const float xt = x + t * L, yt = y + t * M, zt = z + t * N;
      float sv, gx, gy;
      ff_sag_grad(s, xt, yt, sv, gx, gy);
      const float fv = sv - zt;
      float fp = gx * L + gy * M - N;
      fp = (fabsf(fp) > EPS) ? fp : EPS;
      t = t - fv / fp;
    }
  }
#endif
  return t;
}

// Unit normal of surface s at the local hit (x, y), oriented along the
// incident direction (L, M, N) by sign(l.n).
__device__ __forceinline__ void oriented_normal(const Surface& s, float x, float y, float L,
                                                float M, float N, float& nx, float& ny,
                                                float& nz) {
  float sv, gx, gy;
#ifdef OTK_FREEFORM
  if (is_freeform(s))
    ff_sag_grad(s, x, y, sv, gx, gy);
  else
#endif
  sag_grad(s.code, s.nc, s.co, s.cv, s.kk, x, y, false, sv, gx, gy);
  const float inv_mag = rsqrtf(gx * gx + gy * gy + 1.f);
  nx = gx * inv_mag;
  ny = gy * inv_mag;
  nz = -inv_mag;
  const float sg = sign_of(L * nx + M * ny + N * nz);
  nx *= sg;
  ny *= sg;
  nz *= sg;
}

// Refract or reflect at the local hit (x, y); TIR passes through with
// i = 0. Returns the index after the surface.
__device__ __forceinline__ float interact(const Surface& s, float n_pre, float x, float y,
                                          float& L, float& M, float& N, float& i) {
  if (s.inter == INT_NONE) return n_pre;
  float nx, ny, nz;
  oriented_normal(s, x, y, L, M, N, nx, ny, nz);
  const float cs = L * nx + M * ny + N * nz;
  if (s.inter == INT_REFLECT) {
    L = L - 2.f * cs * nx;
    M = M - 2.f * cs * ny;
    N = N - 2.f * cs * nz;
    return n_pre;
  }
  const float n_post = s.n;
  const float u = n_pre / n_post;
  const float d2 = 1.f - u * u * (1.f - cs * cs);
  if (d2 >= 0.f) {
    const float q = sqrtf(d2) - u * cs;
    L = u * L + q * nx;
    M = u * M + q * ny;
    N = u * N + q * nz;
  } else {
    i = 0.f * i;
  }
  return n_post;
}

#ifdef OTK_INTERACTIONS
// The ideal thin lens of focal length f between indices n1 and n2 at the
// local hit (x, y) (JAX `_tile_trace`, INT_THIN_LENS): the slopes (L/N,
// M/N) obey the lens equation (n1 u - y / f) / n2, and the OPD takes the
// lens's quadratic phase -(x^2 + y^2) / 2f.
__device__ __forceinline__ void thin_lens(float f, float n1, float n2, float x, float y,
                                          float& L, float& M, float& N, float& opd) {
  const float ux = L / N;
  const float uy = M / N;
  const float ux2 = (n1 * ux - x / f) / n2;
  const float uy2 = (n1 * uy - y / f) / n2;
  N = rsqrtf(1.f + ux2 * ux2 + uy2 * uy2);
  L = ux2 * N;
  M = uy2 * N;
  opd = opd - (x * x + y * y) / (2.f * f);
}

// A grating's carrier frame at the local hit (x, y): its raw normal n0 and
// its unit grating vector f. A plane takes n0 = (0, 0, 1) and f = (-sin a,
// cos a, 0); a curved carrier the sag's normal (nz < 0, with its gradient
// gx, gy and inv = 1 / |(gx, gy, -1)|) and f = -(u x t) / |u x t|, u = -n0
// the upward normal and t = (cos a, sin a, gx cos a + gy sin a) the groove
// tangent lifted onto the sag (JAX `_tile_diffract`).
struct GratingFrame {
  float n0x, n0y, n0z, fx, fy, fz;
  float gx, gy, inv, ca, sa, rx, ry, rz, rinv;  // curved: the sag, t and u x t
};

__device__ __forceinline__ GratingFrame grating_frame(const Surface& s, float x, float y) {
  GratingFrame q;
  const float ang = s.co[F_GRATING + 2 - F_COEFFS];
  q.ca = cosf(ang);
  q.sa = sinf(ang);
  if (s.code == GEOM_PLANE) {
    q.n0x = 0.f;
    q.n0y = 0.f;
    q.n0z = 1.f;
    q.fx = -q.sa;
    q.fy = q.ca;
    q.fz = 0.f;
    return q;
  }
  float sv;
  sag_grad(s.code, s.nc, s.co, s.cv, s.kk, x, y, false, sv, q.gx, q.gy);
  q.inv = rsqrtf(q.gx * q.gx + q.gy * q.gy + 1.f);
  q.n0x = q.gx * q.inv;
  q.n0y = q.gy * q.inv;
  q.n0z = -q.inv;
  const float tz = q.gx * q.ca + q.gy * q.sa;
  const float ux = -q.n0x, uy = -q.n0y, uz = -q.n0z;
  q.rx = uy * tz - uz * q.sa;
  q.ry = uz * q.ca - ux * tz;
  q.rz = ux * q.sa - uy * q.ca;
  q.rinv = rsqrtf(q.rx * q.rx + q.ry * q.ry + q.rz * q.rz);
  q.fx = -q.rx * q.rinv;
  q.fy = -q.ry * q.rinv;
  q.fz = -q.rz * q.rinv;
  return q;
}

// The vector grating equation at the local hit (x, y) between indices n1
// and n2 (JAX `_tile_diffract`): with the normal n oriented along the
// incident l, the tangential parts u_t = l - |l.n| n and f_t = f - (f.n) n,
// the period projected, p = d / |(fx, fy)|, and T = n1 p u_t + m w f_t,
// Q = p^2 n2^2 - |T|^2; the outgoing direction is (T - n sqrt Q) / (p n2')
// renormalized, its z component taking +nz sqrt Q (mirrored, and n2' = -n2,
// on a reflective grating): the JAX package's sign convention. An
// evanescent order (Q < 0) keeps its direction with i = 0.
__device__ __forceinline__ void diffract(const Surface& s, float n1, float n2, float x,
                                         float y, float& L, float& M, float& N, float& i) {
  const GratingFrame q = grating_frame(s, x, y);
  const float d = s.co[F_GRATING + 1 - F_COEFFS];
  const float pp = d * rsqrtf(q.fx * q.fx + q.fy * q.fy);
  const float dot = L * q.n0x + M * q.n0y + N * q.n0z;
  const float sg = sign_of(dot);
  const float nx = q.n0x * sg, ny = q.n0y * sg, nz = q.n0z * sg;
  const float c = fabsf(dot);
  const float utx = L - c * nx, uty = M - c * ny, utz = N - c * nz;
  const float fn = q.fx * nx + q.fy * ny + q.fz * nz;
  const float ftx = q.fx - fn * nx, fty = q.fy - fn * ny, ftz = q.fz - fn * nz;
  const float a = n1 * pp;
  const float Tx = a * utx + s.gm * ftx;
  const float Ty = a * uty + s.gm * fty;
  const float Tz = a * utz + s.gm * ftz;
  const float Q = pp * pp * n2 * n2 - (Tx * Tx + Ty * Ty + Tz * Tz);
  if (Q >= 0.f) {
    const float root = sqrtf(Q);
    const float inv_den = 1.f / (pp * (s.reflective ? -n2 : n2));
    const float zs = s.reflective ? -nz : nz;
    const float Lr = (Tx - nx * root) * inv_den;
    const float Mr = (Ty - ny * root) * inv_den;
    const float Nr = (Tz + zs * root) * inv_den;
    const float inv_mag = rsqrtf(Lr * Lr + Mr * Mr + Nr * Nr);
    L = Lr * inv_mag;
    M = Mr * inv_mag;
    N = Nr * inv_mag;
  } else {
    i = 0.f * i;
  }
}

#ifdef OTK_PHASE
// The phase phi and its gradient (gx, gy) at (x, y) of a profile of kind
// `kind` with slots p (JAX `_phase_vg_inline`): a constant p0; the radial
// sum of p_j r^(2 (j + 1)) over all PHASE_SLOTS slots, its d phi / d(r^2)
// carried from r^0 = 1 (so that the gradient's derivative at r = 0 is the
// true 2 p0); or the linear grating p0 x + p1 y.
__device__ __forceinline__ void phase_vg(int kind, const float* p, float x, float y,
                                         float& ph, float& gx, float& gy) {
  if (kind == PHASE_CONSTANT) {
    ph = p[0];
    gx = 0.f;
    gy = 0.f;
  } else if (kind == PHASE_RADIAL) {
    const float r2 = x * x + y * y;
    float phase = 0.f, d = 0.f, rp = r2, rp_prev = 1.f;
#pragma unroll
    for (int ci = 0; ci < PHASE_SLOTS; ++ci) {
      phase = phase + p[ci] * rp;
      d = d + p[ci] * (float)(ci + 1) * rp_prev;
      rp_prev = rp;
      rp = rp * r2;
    }
    ph = phase;
    gx = 2.f * x * d;
    gy = 2.f * y * d;
  } else {  // PHASE_LINEAR_GRATING
    ph = p[0] * x + p[1] * y;
    gx = p[0];
    gy = p[1];
  }
}

// A phase sheet's generalized Snell law at the local hit (x, y) between
// indices n1 and n2 (JAX `_tile_phase`), in units of k0 (s.ik = 1 / k0):
// with the carrier's raw normal n (nz < 0), the scaled gradient (a, b) =
// grad(phi) / k0, c = l.n and e = n1 c + a nx + b ny, the tangential
// wavevector kp = n1 l + (a, b, 0) - e n, the projections of n1 k0 l and of
// grad(phi) onto the tangent plane, and R^2 = n2^2 - |kp|^2 (n2 = n1 on a
// mirror); the outgoing direction is kp + s sqrt(R^2) n renormalized, s =
// sign(c), negated on a mirror. An evanescent ray (R^2 < 0) keeps its
// direction with i = 0. The OPD takes -phi / k0.
__device__ __forceinline__ void phase_sheet(const Surface& s, float n1, float n2, float x,
                                            float y, float& L, float& M, float& N, float& i,
                                            float& opd) {
  float sv, gxs, gys;
  sag_grad(s.code, s.nc, s.co, s.cv, s.kk, x, y, false, sv, gxs, gys);
  const float inv = rsqrtf(gxs * gxs + gys * gys + 1.f);
  const float nx = gxs * inv, ny = gys * inv, nz = -inv;
  if (s.reflective) n2 = n1;
  float ph, gpx, gpy;
  phase_vg(s.pk, s.co + (F_PHASE - F_COEFFS), x, y, ph, gpx, gpy);
  const float a = s.ik * gpx, b = s.ik * gpy;
  const float c = L * nx + M * ny + N * nz;
  const float e = n1 * c + a * nx + b * ny;
  const float kpx = n1 * L + a - e * nx;
  const float kpy = n1 * M + b - e * ny;
  const float kpz = n1 * N - e * nz;
  const float Q = n2 * n2 - (kpx * kpx + kpy * kpy + kpz * kpz);
  if (Q >= 0.f) {
    const float al = (s.reflective ? -1.f : 1.f) * sign_of(c) * sqrtf(Q);
    const float kox = kpx + al * nx, koy = kpy + al * ny, koz = kpz + al * nz;
    const float im = rsqrtf(kox * kox + koy * koy + koz * koz);
    L = kox * im;
    M = koy * im;
    N = koz * im;
  } else {
    i = 0.f * i;
  }
  opd = opd - ph * s.ik;
}
#endif

// interact() with the thin lens (which writes the OPD), the grating and
// (OTK_PHASE) the phase sheet.
__device__ __forceinline__ float interact(const Surface& s, float n_pre, float x, float y,
                                          float& L, float& M, float& N, float& i,
                                          float& opd) {
  if (s.inter == INT_THIN_LENS) {
    thin_lens(s.co[F_FOCAL - F_COEFFS], n_pre, s.n, x, y, L, M, N, opd);
    return s.n;
  }
  if (s.inter == INT_DIFFRACT) {
    diffract(s, n_pre, s.n, x, y, L, M, N, i);
    return s.n;
  }
#ifdef OTK_PHASE
  if (s.inter == INT_PHASE) {
    phase_sheet(s, n_pre, s.n, x, y, L, M, N, i, opd);
    return s.n;
  }
#endif
  return interact(s, n_pre, x, y, L, M, N, i);
}
#endif

// Receives each surface's state after the chain has passed it (K7 writes
// it to the history); the default receives nothing.
struct NoSink {
  __device__ __forceinline__ void operator()(int, const Ray&) const {}
};

// The indices and absorption of the media at the tables' one wavelength
// (K1-K6): the Beer-Lambert alpha of the medium before a surface and the
// index after it, as make_surface read them. `RayMedia` gives them at each
// ray's own wavelength (system_chain.cuh `RayMediaAt`). `at<k>()` is the
// view of surface k that the per-system chain passes to surface_step.
struct TableMedia {
  __device__ __forceinline__ float alpha_before(const Surface& s) const { return s.alpha; }
  __device__ __forceinline__ float index_after(const Surface& s) const { return s.n; }
#ifdef OTK_INTERACTIONS
  // a grating's order times the wavelength: the table holds it hoisted
  __device__ __forceinline__ float order_w(const Surface& s) const { return s.gm; }
#endif
#ifdef OTK_PHASE
  // a phase sheet's 1 / k0: the table holds it hoisted
  __device__ __forceinline__ float phase_ik(const Surface& s) const { return s.ik; }
#endif
  template <int k>
  __device__ __forceinline__ const TableMedia& at() const {
    return *this;
  }
};

// Surface k >= 1 of the chain on the running state r: into the surface's
// frame at vertex z pos_k, the hit, the step, opd += |t n_pre|, validity,
// Beer-Lambert absorption through the medium before it, the aperture, the
// interaction (n_pre becomes the index after it), a simple coating's
// factor, back to the global frame. With `rec_k`, it gets the surface's
// entry state, t and (OTK_INTERACTIONS) the entry intensity (the re-trace
// of the backward kernels, chain_bwd.cuh). `media` gives the absorption,
// the index, a grating's m w and a phase sheet's 1 / k0 (`TableMedia` or a
// per-ray view);
// `sink(k, ray)` sees the state after the surface.
template <class Media = TableMedia, class Sink = NoSink>
__device__ __forceinline__ void surface_step(Surface s, int k, int n_newton, float pos_k,
                                             Ray& r, float& n_pre, float* rec_k = nullptr,
                                             const Media& media = Media(),
                                             const Sink& sink = Sink()) {
  float x = r.x, y = r.y, z = r.z, L = r.L, M = r.M, N = r.N, i = r.i, opd = r.opd;
  if (rec_k) {
    rec_k[0] = x; rec_k[1] = y; rec_k[2] = z;
    rec_k[3] = L; rec_k[4] = M; rec_k[5] = N;
#ifdef OTK_INTERACTIONS
    rec_k[REC_I] = i;
#endif
  }

  to_local(s, pos_k, x, y, z, L, M, N);
  float validf;
  const float t = intersect(s, n_newton, x, y, z, L, M, N, validf);
  if (rec_k) rec_k[6] = t;

  x = x + t * L;
  y = y + t * M;
  z = z + t * N;
  opd = opd + fabsf(t * n_pre);
  i = i * validf;
  // Beer-Lambert through the medium before this surface
  if (s.absorbs) i = i * expf(-media.alpha_before(s) * t * 1e3f);
  if (s.aperture) i = i * ((x * x + y * y <= s.ap * s.ap) ? 1.f : 0.f);

  if (s.inter != INT_NONE && s.inter != INT_REFLECT) s.n = media.index_after(s);
#ifdef OTK_INTERACTIONS
  if (s.inter == INT_DIFFRACT) s.gm = media.order_w(s);
#ifdef OTK_PHASE
  if (s.inter == INT_PHASE) s.ik = media.phase_ik(s);
#endif
  n_pre = interact(s, n_pre, x, y, L, M, N, i, opd);
  // simple coating: R after a reflection, T after any other interaction
  if (s.coated) i = i * s.coat;
#else
  n_pre = interact(s, n_pre, x, y, L, M, N, i);
#endif
  to_global(s, pos_k, x, y, z, L, M, N);
  sink(k, Ray{x, y, z, L, M, N, i, opd});
  r.x = x; r.y = y; r.z = z; r.L = L; r.M = M; r.N = N; r.i = i; r.opd = opd;
}

// The surface chain from surface 1 to S-1 at the tables' one wavelength:
// `_tile_trace` (for_grad=False), a run-time loop over the int table's
// codes. The vertex z of surface k is the running sum of
// thickness[1..k-1] (thickness[0], infinite for an infinite object, never
// enters). With `rec`, row k holds surface k's record (surface_step).
__device__ __forceinline__ void trace_chain(int S, int n_newton, const float* ft,
                                            const int* it, Ray& r,
                                            float (*rec)[REC] = nullptr) {
  float pos_prev = 0.f;
  float n_pre = ft[F_NTAB];
  for (int k = 1; k < S; ++k) {
    const float pos_k = pos_prev + (k > 1 ? ft[(k - 1) * F_STRIDE + F_THICK] : 0.f);
    pos_prev = pos_k;
    surface_step(load_surface(ft, it, k), k, n_newton, pos_k, r, n_pre,
                 rec ? rec[k] : nullptr);
  }
}

#ifdef OTK_MATERIALS
// The media of a build at per-ray wavelengths (K7, the per-ray variants of
// K1-K6): OTK_MATERIALS holds {formula, coefficient count} of the medium
// after each surface, k = 0 .. S-1 (a tabulated glass's count is its row's
// width, so it needs a word of its own), separated by commas
// (trace/fused.py `media_defines`).
struct MaterialCodes {
  int formula, nc;
};

__host__ __device__ constexpr MaterialCodes material_codes(int k) {
  constexpr MaterialCodes table[] = {OTK_MATERIALS};
  return table[k];
}

// the number of media: the system's S
__host__ __device__ constexpr int media_count() {
  constexpr MaterialCodes table[] = {OTK_MATERIALS};
  return sizeof(table) / sizeof(table[0]);
}
constexpr int MEDIA = media_count();

template <int k>
struct RayMediaAt;  // system_chain.cuh: surface k's view for surface_step

// The system's media at one ray's wavelength w. mat: the (S, mat_w)
// coefficient rows in global memory (a tabulated glass's row is as wide as
// its table, up to tens of thousands of floats); s_mat: their first
// MAT_SHARED columns, staged in shared memory; kwl, kval: the (S, K)
// extinction tables in global memory (a catalog table reaches 21,394
// points), padded with their last point.
struct RayMedia {
  const float* mat;
  const float* s_mat;
  const float* kwl;
  const float* kval;
  int mat_w, K;
  float w;

  // the index of the medium after surface k at w
  template <int k>
  __device__ __forceinline__ float index_after() const {
    constexpr MaterialCodes m = material_codes(k);
    return material_index<m.formula, m.nc>(s_mat + k * MAT_SHARED,
                                           mat + (size_t)k * mat_w, w);
  }

  // index_after<k>() for a k known at run time (the backward kernels' run-
  // time chain): the formula of medium k is still a compile-time constant,
  // chosen by comparisons on k that every lane of a warp takes alike
  template <int M = 0>
  __device__ __forceinline__ float index_after(int k) const {
    if constexpr (M + 1 < MEDIA) {
      if (k != M) return index_after<M + 1>(k);
    }
    return index_after<M>();
  }

  // the Beer-Lambert alpha = 4 pi k(w) / w of the medium after surface k
  __device__ __forceinline__ float alpha_after(int k) const {
    const size_t row = (size_t)k * K;
    return FOUR_PI * kv_segment(w, kwl + row, kval + row, K) / w;
  }

  template <int k>
  __device__ __forceinline__ RayMediaAt<k> at() const {
    return RayMediaAt<k>{*this};
  }
};
#endif

}  // namespace otk
