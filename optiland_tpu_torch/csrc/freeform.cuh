// The freeform geometries of the fused chain, one ray per thread, for
// Hopper (sm_90a): poly-XY, biconic, toroidal, Chebyshev, Zernike, Forbes
// Q-bfs and Forbes Q-2D, the freeform branch of JAX's `_tile_trace`
// (optiland_tpu/trace/fused.py, the `freeform` arm). Included by chain.cuh
// in a build with OTK_FREEFORM, the mask of bits 1 << code of the families
// the system has (trace/fused.py `branch_defines`): only those families
// compile.
//
// Each family's sag is written once, `ff_sag`, as a template over its
// scalar type: float for the value, and forward-mode numbers (`Dual`: a
// value and N first partials, nestable) for every derivative the chain
// takes. This is what JAX's two JVPs do (`geometry/surfaces.sag_and_grad`),
// and it gives the adjoint without a hand derivation per family:
//   - `ff_sag_grad` (the Newton steps and the normal): the sag over
//     Dual<float, 2> seeded in x and y, its value and (d/dx, d/dy);
//   - `ff_sag_partials` (the implicit-function derivative of the hit,
//     chain_bwd.cuh `sag_partials`): the sag over Dual<float, P> seeded in
//     the family's P nonlinear parameters (cv, k, and the coefficient slots
//     that enter nonlinearly: a biconic's cvy, ky, a toroidal's rotation
//     curvature, Chebyshev's two norms, a Zernike's, a Q-bfs's or a Q-2D's
//     norm radius; a toroidal's y-polynomial by the chain rule through a
//     shift of its y-curve, one parameter more), and each linear
//     coefficient's basis value;
//   - `ff_sag_grad_bwd` (the normal's cotangent, chain_bwd.cuh
//     `sag_grad_bwd`): the derivatives of D_v z = dgx dz/dx + dgy dz/dy,
//     v = (dgx, dgy), in x, y and the nonlinear parameters, from the sag
//     over Dual<Dual<float, 1>, 2 + P>, the inner number carrying the
//     direction v, the outer ones x, y and the parameters; each linear
//     coefficient's is D_v of its basis function.
// The sag is linear in the coefficients of poly-XY (all), Chebyshev (all
// but the norms), Zernike, Q-bfs and Q-2D (all but the norm radius): their
// cotangents are the basis values and the basis gradients, weighted, which
// the family passes to a `basis` callback term by term (Q-bfs's and
// Q-2D's by one Clenshaw sum per unit coefficient). The arithmetic is
// JAX's (and geometry/surfaces.py's): the 1e-14 clamps of the conic roots,
// the 1e-12 clamps of the Forbes factor, the Forbes masks past the norm
// radius.
//
// A surface's coefficient row holds CO_MAX slots (chain.cuh: 17, or the
// widest surface's count in a build with OTK_WIDE); the families' tables
// (Q-bfs constants, Zernike terms) cover that many. A Q-2D surface's terms
// come from the build (OTK_Q2D_GROUPS, OTK_Q2D_ROWS, trace/fused.py
// `_q2d_tables`): each of its groups, the radial terms and the cosine and
// sine terms of each azimuthal order m, with the recurrence constants of
// each (n, m), folded on the host in float64 and rounded once to float.
#pragma once

namespace otk {

constexpr int GEOM_POLYNOMIAL_XY = 4;
constexpr int GEOM_BICONIC = 5;
constexpr int GEOM_TOROIDAL = 6;
constexpr int GEOM_CHEBYSHEV = 7;
constexpr int GEOM_ZERNIKE = 8;
constexpr int GEOM_FORBES_QBFS = 9;
constexpr int GEOM_FORBES_Q2D = 10;
// geometry/surfaces.py _EPS (the conic roots) and the Forbes factor's clamp
constexpr float FF_EPS = static_cast<float>(1e-14);
constexpr float PHI_EPS = static_cast<float>(1e-12);
// at most this many Chebyshev polynomials on an axis, and Zernike terms or
// Q-bfs coefficients: the coefficient slots less the norms
constexpr int CHEB_MAX = CO_MAX - 2;
constexpr int FF_TERMS = CO_MAX - 1;
// `ff_sag`'s parameters th: cv, k, the first two coefficient slots (the
// ones that enter a family's sag nonlinearly), and a shift of a toroidal's
// y-curve z_y (0; seeded for its y-polynomial's derivatives)
constexpr int FF_ZSHIFT = 4;
constexpr int FF_PARAMS = 5;

// Whether this build has family `code` (OTK_FREEFORM's bit).
__host__ __device__ constexpr bool has_family(int code) {
  return ((static_cast<unsigned>(OTK_FREEFORM) >> code) & 1u) != 0;
}

#ifndef OTK_Q2D_GROUPS
static_assert(!has_family(GEOM_FORBES_Q2D),
              "a build with Forbes Q-2D needs its tables: OTK_Q2D_GROUPS, OTK_Q2D_ROWS, "
              "OTK_Q2D_NMAX");
#endif

__device__ __forceinline__ bool is_freeform(const Surface& s) {
#ifdef OTK_Q2D_GROUPS
  return s.code >= GEOM_POLYNOMIAL_XY && s.code <= GEOM_FORBES_Q2D && has_family(s.code);
#else
  return s.code >= GEOM_POLYNOMIAL_XY && s.code <= GEOM_FORBES_QBFS && has_family(s.code);
#endif
}

// ---------------------------------------------------------------------------
// forward-mode numbers
// ---------------------------------------------------------------------------

// A value and its N first partials, over the scalar type T (float, or a
// Dual itself).
template <class T, int N>
struct Dual {
  T v;
  T d[N];
};

template <class T>
struct Make {
  __device__ static __forceinline__ T c(float a) { return a; }
};
template <class T, int N>
struct Make<Dual<T, N>> {
  __device__ static __forceinline__ Dual<T, N> c(float a) {
    Dual<T, N> r;
    r.v = Make<T>::c(a);
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = Make<T>::c(0.f);
    return r;
  }
};

// the constant a as a T (all partials 0)
template <class T>
__device__ __forceinline__ T cst(float a) {
  return Make<T>::c(a);
}

// v as an outer Dual seeded in direction i
template <class T, int N>
__device__ __forceinline__ Dual<T, N> seeded(const T& v, int i) {
  Dual<T, N> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < N; ++j) r.d[j] = Make<T>::c(j == i ? 1.f : 0.f);
  return r;
}

__device__ __forceinline__ float val(float a) { return a; }
template <class T, int N>
__device__ __forceinline__ float val(const Dual<T, N>& a) {
  return val(a.v);
}

__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.v * b.d[i] + a.d[i] * b.v;
  return r;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, float b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}
template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator+(float a, const Dual<T, N>& b) {
  return b + a;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, float b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}
template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator-(float a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  return 0.f - a;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, float b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator*(float a, const Dual<T, N>& b) {
  return b * a;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> operator/(float a, const Dual<T, N>& b) {
  return cst<Dual<T, N>>(a) / b;
}

template <class T, int N>
__device__ __forceinline__ Dual<T, N> sqrt_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt_(a.v);
  const T h = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * h;
  return r;
}

// max(a, lo), the derivative 0 where it clamps (jnp.maximum, torch.clamp)
template <class T>
__device__ __forceinline__ T clamp_min(const T& a, float lo) {
  return val(a) > lo ? a : cst<T>(lo);
}

// ---------------------------------------------------------------------------
// tables
// ---------------------------------------------------------------------------

#ifdef OTK_WIDE
// The tables of a build with OTK_WIDE, as many terms as its widest
// surface, written by the host (trace/fused.py `_wide_tables`) in the
// layouts below: the Q-bfs constants, each Zernike convention's m and
// radial coefficients (ZR of them), |m| < ZM.
constexpr int ZR = OTK_WIDE_ZR;
constexpr int ZM = OTK_WIDE_ZM;
__constant__ float QBFS_F[FF_TERMS] = {OTK_WIDE_QBFS_F};
__constant__ float QBFS_G[FF_TERMS] = {OTK_WIDE_QBFS_G};
__constant__ float QBFS_H[FF_TERMS] = {OTK_WIDE_QBFS_H};
__constant__ int ZERNIKE_M[3][FF_TERMS] = {OTK_WIDE_ZERNIKE_M};
__constant__ float ZERNIKE_RADIAL[3][FF_TERMS][ZR] = {OTK_WIDE_ZERNIKE_RADIAL};
#else
// radial coefficients a Zernike term's table holds, and a bound on |m|
constexpr int ZR = 4;
constexpr int ZM = 6;  // |m| <= 5 in the first FF_TERMS terms
// The Q-bfs recurrence constants f_n, g_n, h_n of geometry/forbes.py
// (`_f_qbfs`, `_g_qbfs`, `_h_qbfs`), n < FF_TERMS, in constant memory.
__constant__ float QBFS_F[FF_TERMS] = {
    static_cast<float>(2.0), static_cast<float>(2.179449471770337),
    static_cast<float>(2.9019050004400464), static_cast<float>(3.567211796347394),
    static_cast<float>(4.2799849438803905), static_cast<float>(4.971637704738899),
    static_cast<float>(5.681652322760158), static_cast<float>(6.380705142135172),
    static_cast<float>(7.08957499211796), static_cast<float>(7.791737465734732),
    static_cast<float>(8.50002581528037), static_cast<float>(9.203787740675516),
    static_cast<float>(9.911741039959056), static_cast<float>(10.6164341010725),
    static_cast<float>(11.324176965810368), static_cast<float>(12.0294597451587)};
__constant__ float QBFS_G[FF_TERMS] = {
    static_cast<float>(-0.5), static_cast<float>(-0.5735393346764044),
    static_cast<float>(-0.61665481259351), static_cast<float>(-0.6377529930601431),
    static_cast<float>(-0.6513619300049629), static_cast<float>(-0.6603092839386494),
    static_cast<float>(-0.6669046163343583), static_cast<float>(-0.671806923160116),
    static_cast<float>(-0.6756880560871843), static_cast<float>(-0.6787738021621036),
    static_cast<float>(-0.681327454232958), static_cast<float>(-0.6834459248545625),
    static_cast<float>(-0.6852527890058272), static_cast<float>(-0.6867962357387363),
    static_cast<float>(-0.6881417576448097), 0.f};
__constant__ float QBFS_H[FF_TERMS] = {
    static_cast<float>(-0.5), static_cast<float>(-1.3764944032233704),
    static_cast<float>(-2.0676073128135335), static_cast<float>(-2.803309859605024),
    static_cast<float>(-3.5046852259252232), static_cast<float>(-4.223960241508162),
    static_cast<float>(-4.928143858404477), static_cast<float>(-5.642009652236232),
    static_cast<float>(-6.347348049781552), static_cast<float>(-7.058759389914032),
    static_cast<float>(-7.764682300299933), static_cast<float>(-8.474771713311497),
    static_cast<float>(-9.181030823256448), static_cast<float>(-9.890326544709831),
    0.f, 0.f};

// Zernike term t (< FF_TERMS) of convention `type` (0 fringe, 1 noll, 2
// standard; zernike/__init__.py `indices`): its m, and its radial
// polynomial R_n^m / rho^|m| in rho^2, highest power first, times the
// convention's norm (1; sqrt((2 n + 2) / (m == 0 ? 2 : 1))), padded in
// front with zeros to 4 coefficients.
__constant__ int ZERNIKE_M[3][FF_TERMS] = {
    {0, 1, -1, 0, 2, -2, 1, -1, 0, 3, -3, 2, -2, 1, -1, 0},
    {0, 1, -1, 0, -2, 2, -1, 1, -3, 3, 0, 2, -2, 4, -4, 1},
    {0, -1, 1, -2, 0, 2, -3, -1, 1, 3, -4, -2, 0, 2, 4, -5},
};
__constant__ float ZERNIKE_RADIAL[3][FF_TERMS][ZR] = {
    {
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 2.f, -1.f},
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 3.f, -2.f},
        {0.f, 0.f, 3.f, -2.f},
        {0.f, 6.f, -6.f, 1.f},
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 4.f, -3.f},
        {0.f, 0.f, 4.f, -3.f},
        {0.f, 10.f, -12.f, 3.f},
        {0.f, 10.f, -12.f, 3.f},
        {20.f, -30.f, 12.f, -1.f},
    },
    {
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 0.f, 2.f},
        {0.f, 0.f, 0.f, 2.f},
        {0.f, 0.f, static_cast<float>(3.4641016151377544), static_cast<float>(-1.7320508075688772)},
        {0.f, 0.f, 0.f, static_cast<float>(2.449489742783178)},
        {0.f, 0.f, 0.f, static_cast<float>(2.449489742783178)},
        {0.f, 0.f, static_cast<float>(8.485281374238571), static_cast<float>(-5.656854249492381)},
        {0.f, 0.f, static_cast<float>(8.485281374238571), static_cast<float>(-5.656854249492381)},
        {0.f, 0.f, 0.f, static_cast<float>(2.8284271247461903)},
        {0.f, 0.f, 0.f, static_cast<float>(2.8284271247461903)},
        {0.f, static_cast<float>(13.416407864998739), static_cast<float>(-13.416407864998739), static_cast<float>(2.23606797749979)},
        {0.f, 0.f, static_cast<float>(12.649110640673518), static_cast<float>(-9.486832980505138)},
        {0.f, 0.f, static_cast<float>(12.649110640673518), static_cast<float>(-9.486832980505138)},
        {0.f, 0.f, 0.f, static_cast<float>(3.1622776601683795)},
        {0.f, 0.f, 0.f, static_cast<float>(3.1622776601683795)},
        {0.f, static_cast<float>(34.64101615137754), static_cast<float>(-41.569219381653056), static_cast<float>(10.392304845413264)},
    },
    {
        {0.f, 0.f, 0.f, 1.f},
        {0.f, 0.f, 0.f, 2.f},
        {0.f, 0.f, 0.f, 2.f},
        {0.f, 0.f, 0.f, static_cast<float>(2.449489742783178)},
        {0.f, 0.f, static_cast<float>(3.4641016151377544), static_cast<float>(-1.7320508075688772)},
        {0.f, 0.f, 0.f, static_cast<float>(2.449489742783178)},
        {0.f, 0.f, 0.f, static_cast<float>(2.8284271247461903)},
        {0.f, 0.f, static_cast<float>(8.485281374238571), static_cast<float>(-5.656854249492381)},
        {0.f, 0.f, static_cast<float>(8.485281374238571), static_cast<float>(-5.656854249492381)},
        {0.f, 0.f, 0.f, static_cast<float>(2.8284271247461903)},
        {0.f, 0.f, 0.f, static_cast<float>(3.1622776601683795)},
        {0.f, 0.f, static_cast<float>(12.649110640673518), static_cast<float>(-9.486832980505138)},
        {0.f, static_cast<float>(13.416407864998739), static_cast<float>(-13.416407864998739), static_cast<float>(2.23606797749979)},
        {0.f, 0.f, static_cast<float>(12.649110640673518), static_cast<float>(-9.486832980505138)},
        {0.f, 0.f, 0.f, static_cast<float>(3.1622776601683795)},
        {0.f, 0.f, 0.f, static_cast<float>(3.4641016151377544)},
    },
};

#endif

#ifdef OTK_Q2D_GROUPS
// A Q-2D group: the azimuthal order m of its terms (> 0 the cosine terms,
// < 0 the sine terms, 0 the radial ones), its highest n and its first row;
// a row per n <= ntop: the coefficient slot of the term (n, m), -1 where
// the surface has none, and the constants of its sums: f_n, g_n and h_n
// of the radial recurrence (`_f_qbfs`, `_g_qbfs`, `_h_qbfs` of
// geometry/forbes.py, in f, g, a), or f_n, g_n of the back-substitution
// and a_n, b_n, c_(n+1) of the three-term recurrence (`_f_q2d`, `_g_q2d`,
// `_abc_q2d`). A surface's groups are consecutive, by |m|, the cosine
// group first.
struct Q2DGroup {
  int m, ntop, row;
};
struct Q2DRow {
  int slot;
  float f, g, a, b, c;
};
__constant__ Q2DGroup Q2D_GROUPS[] = {OTK_Q2D_GROUPS};
__constant__ Q2DRow Q2D_ROWS[] = {OTK_Q2D_ROWS};
// one more than the highest n of any group
constexpr int Q2D_NMAX = OTK_Q2D_NMAX;
#endif

// ---------------------------------------------------------------------------
// the families' sags
// ---------------------------------------------------------------------------

// The conic sag cv r^2 / (1 + sqrt(max(1 - (1 + k) cv^2 r^2, 1e-14))) at
// r^2 (`_conic_sag`; with t^2, the 1-D profile `_conic_1d`).
template <class T>
__device__ __forceinline__ T ff_conic(const T& r2, const T& cv, const T& k) {
  const T den = 1.f + sqrt_(clamp_min(1.f - (1.f + k) * cv * cv * r2, FF_EPS));
  return cv * r2 / den;
}

// sum_n a_n Q_n(usq) of the m + 1 coefficients a (geometry/forbes.py
// `qbfs_sum`): the triangular change to the orthonormal basis, then
// Clenshaw's sum.
template <class T>
__device__ __forceinline__ T qbfs_sum(const float* a, int m, const T& usq) {
  float bs[FF_TERMS];
  bs[m] = a[m] / QBFS_F[m];
  if (m > 0) {
    bs[m - 1] = (a[m - 1] - QBFS_G[m - 1] * bs[m]) / QBFS_F[m - 1];
    for (int i = m - 2; i >= 0; --i)
      bs[i] = (a[i] - QBFS_G[i] * bs[i + 1] - QBFS_H[i] * bs[i + 2]) / QBFS_F[i];
  }
  const T prefix = 2.f - 4.f * usq;
  T b_curr = cst<T>(bs[m]);
  T b_next = cst<T>(0.f);
  for (int n = m - 1; n >= 0; --n) {
    const T b_new = bs[n] + prefix * b_curr - b_next;
    b_next = b_curr;
    b_curr = b_new;
  }
  return m > 0 ? 2.f * (b_curr + b_next) : 2.f * b_curr;
}

#ifdef OTK_Q2D_GROUPS
// sum_n c_n Q_n^m(usq) of a Q-2D group (geometry/forbes.py `qbfs_sum` for
// the radial group, m = 0; `q2d_sum` for m >= 1) over its rows, from row0,
// and the ntop + 1 coefficients c: the triangular change to the orthonormal
// basis, then Clenshaw's sum, or the three-term recurrence, with Forbes'
// rule for m = 1 (s -= 0.4 alpha_3 past n = 2).
template <class T>
__device__ __forceinline__ T q2d_sum(int row0, int ntop, int m, const float* c,
                                     const T& usq) {
  const auto r = [row0](int n) -> Q2DRow { return Q2D_ROWS[row0 + n]; };
  float d[Q2D_NMAX];
  if (m == 0) {
    d[ntop] = c[ntop] / r(ntop).f;
    if (ntop > 0) {
      d[ntop - 1] = (c[ntop - 1] - r(ntop - 1).g * d[ntop]) / r(ntop - 1).f;
      for (int i = ntop - 2; i >= 0; --i)
        d[i] = (c[i] - r(i).g * d[i + 1] - r(i).a * d[i + 2]) / r(i).f;
    }
    const T prefix = 2.f - 4.f * usq;
    T b_curr = cst<T>(d[ntop]);
    T b_next = cst<T>(0.f);
    for (int n = ntop - 1; n >= 0; --n) {
      const T b_new = d[n] + prefix * b_curr - b_next;
      b_next = b_curr;
      b_curr = b_new;
    }
    return ntop > 0 ? 2.f * (b_curr + b_next) : 2.f * b_curr;
  }
  d[ntop] = c[ntop] / r(ntop).f;
  for (int n = ntop - 1; n >= 0; --n) d[n] = (c[n] - r(n).g * d[n + 1]) / r(n).f;
  T a1 = cst<T>(d[ntop]);  // alpha_(n + 1)
  T a2 = cst<T>(0.f);      // alpha_(n + 2)
  T a3 = a1;               // alpha_3, where ntop = 3
  for (int n = ntop - 1; n >= 0; --n) {
    T a0 = d[n] + (r(n).a + r(n).b * usq) * a1;
    if (n <= ntop - 2) a0 = a0 - r(n).c * a2;
    a2 = a1;
    a1 = a0;
    if (n == 3) a3 = a0;
  }
  const T s = 0.5f * a1;
  return m == 1 && ntop > 2 ? s - 0.4f * a3 : s;
}
#endif

// The sag of freeform surface s at (x, y), over the scalar type T. th: cv,
// k, the first two coefficient slots (th[2 + i] for slot i: the family
// reads the slots that enter nonlinearly from th, the others from s.co)
// and the toroidal's z-shift (th[FF_ZSHIFT], 0);
// basis(j, b): the basis function b of linear coefficient slot j, when the
// caller asks for it (B::want).
template <class T, class B>
__device__ __forceinline__ T ff_sag(const Surface& s, const T& x, const T& y, const T* th,
                                    const B& basis) {
  const T& cv = th[0];
  const T& k = th[1];
  const int nc = s.nc;
  if (has_family(GEOM_BICONIC) && s.code == GEOM_BICONIC) {
    // the x-profile (cv, k) plus the y-profile (cvy, ky)
    return ff_conic(x * x, cv, k) + ff_conic(y * y, th[2], th[3]);
  }
  if (has_family(GEOM_TOROIDAL) && s.code == GEOM_TOROIDAL) {
    // z = (2 z_y - c z_y^2 + c x^2) / (1 + sqrt(w)), w = (1 - c z_y)^2 -
    // c^2 x^2, z_y the y-curve (cv, k) plus sum_i alpha_i y^(2i)
    T zy = ff_conic(y * y, cv, k) + th[FF_ZSHIFT];
    const T y2 = y * y;
    T yp = y2;
    for (int i = 1; i < nc; ++i) {
      zy = zy + s.co[i] * yp;
      yp = yp * y2;
    }
    const T& c = th[2];
    const T cz = 1.f - c * zy;
    const T w = clamp_min(cz * cz - c * c * x * x, FF_EPS);
    return (2.f * zy - c * zy * zy + c * x * x) / (1.f + sqrt_(w));
  }
  const T r2 = x * x + y * y;
  T z = ff_conic(r2, cv, k);
  if (has_family(GEOM_POLYNOMIAL_XY) && s.code == GEOM_POLYNOMIAL_XY) {
    // sum C_ij x^i y^j over a square (order + 1)^2 grid, order + 1 =
    // round(sqrt(nc))
    int n1 = 0;
    while ((2 * n1 + 1) * (2 * n1 + 1) < 4 * nc) ++n1;
    T xp = cst<T>(1.f);
    for (int i = 0; i < n1; ++i) {
      T yp = cst<T>(1.f);
      for (int j = 0; j < n1; ++j) {
        const T b = xp * yp;
        z = z + s.co[i * n1 + j] * b;
        basis(i * n1 + j, b);
        yp = yp * y;
      }
      xp = xp * x;
    }
    return z;
  }
  if (has_family(GEOM_CHEBYSHEV) && s.code == GEOM_CHEBYSHEV) {
    // sum C_ij T_i(x / norm_x) T_j(y / norm_y), a0 rows by a1 columns
    const int rows = s.a0, cols = s.a1;
    const T xn = x / th[2];
    const T yn = y / th[3];
    T ty[CHEB_MAX];
    ty[0] = cst<T>(1.f);
    if (cols > 1) ty[1] = yn;
    for (int j = 2; j < cols; ++j) ty[j] = 2.f * yn * ty[j - 1] - ty[j - 2];
    T tx_prev = cst<T>(1.f), tx = cst<T>(1.f);
    for (int i = 0; i < rows; ++i) {
      if (i == 1) {
        tx_prev = tx;
        tx = xn;
      } else if (i > 1) {
        const T t_next = 2.f * xn * tx - tx_prev;
        tx_prev = tx;
        tx = t_next;
      }
      for (int j = 0; j < cols; ++j) {
        const T b = tx * ty[j];
        z = z + s.co[2 + i * cols + j] * b;
        basis(2 + i * cols + j, b);
      }
    }
    return z;
  }
  if (has_family(GEOM_ZERNIKE) && s.code == GEOM_ZERNIKE) {
    // sum c_t Z_t(x / R, y / R) in Cartesian form: the radial polynomial in
    // rho^2 times rho^|m| cos(m phi) or sin, (C_m, S_m) by the recurrence
    // C_m + i S_m = (xn + i yn)^m (zernike/__init__.py `evaluate_xy`)
    const T xn = x / th[2];
    const T yn = y / th[2];
    const T rn2 = xn * xn + yn * yn;
    constexpr int MMAX = ZM;
    T C[MMAX], S[MMAX];
    C[0] = cst<T>(1.f);
    S[0] = cst<T>(0.f);
    for (int m = 1; m < MMAX; ++m) {
      C[m] = C[m - 1] * xn - S[m - 1] * yn;
      S[m] = S[m - 1] * xn + C[m - 1] * yn;
    }
    // unrolled within a 17-slot row; a wide build's tens of terms stay a
    // loop (unrolled over nested numbers they cost minutes of ptxas)
#ifdef OTK_WIDE
#pragma unroll 1
#else
#pragma unroll
#endif
    for (int t = 0; t < FF_TERMS; ++t) {
      if (t + 1 >= nc) break;
      const int m = ZERNIKE_M[s.a0][t];
      const int am = m < 0 ? -m : m;
#ifdef OTK_WIDE
      T rad = ZERNIKE_RADIAL[s.a0][t][0] * rn2 + ZERNIKE_RADIAL[s.a0][t][1];
#pragma unroll
      for (int q = 2; q < ZR; ++q) rad = rad * rn2 + ZERNIKE_RADIAL[s.a0][t][q];
#else
      const T rad = ((ZERNIKE_RADIAL[s.a0][t][0] * rn2 + ZERNIKE_RADIAL[s.a0][t][1]) * rn2 +
                     ZERNIKE_RADIAL[s.a0][t][2]) * rn2 + ZERNIKE_RADIAL[s.a0][t][3];
#endif
      // rho^|m| cos(m phi) or sin, chosen by selects (a register array)
      T h = C[0];
#pragma unroll
      for (int q = 1; q < MMAX; ++q)
        if (am == q) h = m < 0 ? S[q] : C[q];
      const T b = rad * h;
      z = z + s.co[1 + t] * b;
      basis(1 + t, b);
    }
    return z;
  }
#ifdef OTK_Q2D_GROUPS
  if (has_family(GEOM_FORBES_Q2D) && s.code == GEOM_FORBES_Q2D) {
    // z_conic + phi [u^2 (1 - u^2) sum_n a_n^0 Q_n^0(u^2) + sum_m (C_m sum_n
    // a_n^m Q_n^m(u^2) + S_m sum_n b_n^m Q_n^m(u^2))], C_m + i S_m = ((x + i
    // y) / R)^m, 0 past the norm radius (geometry/surfaces.py
    // `_forbes_q2d_sag`); the groups s.a0 .. s.a1 - 1 of Q2D_GROUPS
    if (nc <= 1) return z;
    const T xn = x / th[2];
    const T yn = y / th[2];
    const T usq = r2 / (th[2] * th[2]);
    const T c2r2 = cv * cv * r2;
    const T phi =
        sqrt_(clamp_min(1.f - k * c2r2, PHI_EPS) / clamp_min(1.f - (1.f + k) * c2r2, PHI_EPS));
    const bool outside = val(usq) > 1.f;
    T total = cst<T>(0.f);
    T Cm = cst<T>(1.f), Sm = cst<T>(0.f);
    int m_at = 0;
    for (int gi = s.a0; gi < s.a1; ++gi) {
      const Q2DGroup g = Q2D_GROUPS[gi];
      const int am = g.m < 0 ? -g.m : g.m;
      for (; m_at < am; ++m_at) {
        const T c_next = Cm * xn - Sm * yn;
        Sm = Sm * xn + Cm * yn;
        Cm = c_next;
      }
      const T h = am == 0 ? usq * (1.f - usq) : (g.m > 0 ? Cm : Sm);
      float c[Q2D_NMAX];
      for (int n = 0; n <= g.ntop; ++n) {
        const int slot = Q2D_ROWS[g.row + n].slot;
        c[n] = slot >= 0 ? s.co[slot] : 0.f;
      }
      total = total + h * q2d_sum(g.row, g.ntop, am, c, usq);
      if (B::want) {
        for (int n = 0; n <= g.ntop; ++n) c[n] = 0.f;
        for (int n = 0; n <= g.ntop; ++n) {
          const int slot = Q2D_ROWS[g.row + n].slot;
          if (slot < 0) continue;
          c[n] = 1.f;
          basis(slot, outside ? cst<T>(0.f) : phi * (h * q2d_sum(g.row, g.ntop, am, c, usq)));
          c[n] = 0.f;
        }
      }
    }
    return outside ? z : z + phi * total;
  }
#endif
  // GEOM_FORBES_QBFS: z_conic + u^2 (1 - u^2) phi sum_n a_n Q_n(u^2), u =
  // r / R, 0 past the norm radius (u^2 > 1); phi = sqrt((1 - k c^2 r^2) /
  // (1 - (1 + k) c^2 r^2)) (geometry/surfaces.py `_forbes_qbfs_sag`)
  if (nc <= 1) return z;
  const T usq = r2 / (th[2] * th[2]);
  const T c2r2 = cv * cv * r2;
  const T phi = sqrt_(clamp_min(1.f - k * c2r2, PHI_EPS) / clamp_min(1.f - (1.f + k) * c2r2, PHI_EPS));
  const T pre = usq * (1.f - usq) * phi;
  const bool outside = val(usq) > 1.f;
  const int m = nc - 2;
  if (B::want) {
    float unit[FF_TERMS];
    for (int j = 0; j <= m; ++j) unit[j] = 0.f;
    for (int j = 0; j <= m; ++j) {
      unit[j] = 1.f;
      basis(1 + j, outside ? cst<T>(0.f) : pre * qbfs_sum(unit, m, usq));
      unit[j] = 0.f;
    }
  }
  return outside ? z : z + pre * qbfs_sum(s.co + 1, m, usq);
}

// A basis callback that takes nothing (the value and the x, y gradient).
struct NoBasis {
  static constexpr bool want = false;
  template <class T>
  __device__ __forceinline__ void operator()(int, const T&) const {}
};

// w times each linear coefficient's basis value, added to its cotangent
// (ff_sag_partials_of).
template <class G>
struct PartialsBasis {
  static constexpr bool want = true;
  G& sg;
  float w;
  template <class T>
  __device__ __forceinline__ void operator()(int j, const T& b) const {
    sg.co[j] += w * val(b);
  }
};

// D_v of each linear coefficient's basis function, added to its cotangent
// (ff_sag_grad_bwd_of: the inner number of b carries the direction v).
template <class G>
struct GradBwdBasis {
  static constexpr bool want = true;
  G& sg;
  template <class T>
  __device__ __forceinline__ void operator()(int j, const T& b) const {
    sg.co[j] += b.v.d[0];
  }
};

// The number of parameters whose derivatives family `code` takes by
// forward-mode numbers: cv, k, and the coefficient slots that enter its sag
// nonlinearly; for the toroidal, cv, k, its rotation curvature and the
// z-shift of its y-curve (`ff_sag`), through which its y-polynomial's
// derivatives follow by the chain rule.
__host__ __device__ constexpr int ff_nonlinear(int code) {
  // Zernike, Q-bfs and Q-2D: 3, the norm radius
  return code == GEOM_POLYNOMIAL_XY ? 2
         : code == GEOM_BICONIC || code == GEOM_TOROIDAL || code == GEOM_CHEBYSHEV ? 4
                                                                                   : 3;
}

// The direction of the outer Dual that parameter slot i (`ff_sag`'s th) is
// seeded in for family CODE, -1 where it stays a constant.
template <int CODE>
__host__ __device__ constexpr int ff_seed(int i) {
  if (CODE == GEOM_TOROIDAL) return i < 3 ? i : (i == FF_ZSHIFT ? 3 : -1);
  return i < ff_nonlinear(CODE) ? i : -1;
}

// The parameter slot that the outer direction d is seeded in (ff_seed's
// inverse).
template <int CODE>
__host__ __device__ constexpr int ff_slot(int d) {
  return CODE == GEOM_TOROIDAL && d == 3 ? FF_ZSHIFT : d;
}

// The parameters of freeform surface s over T (`ff_sag`'s th): cv, k, the
// first two coefficient slots and the toroidal z-shift (0), each through
// `lift(value, direction)`, the direction ff_seed<CODE>'s (-1: a constant).
template <int CODE, class T, class Lift>
__device__ __forceinline__ void ff_params(const Surface& s, const Lift& lift,
                                          T (&th)[FF_PARAMS]) {
#pragma unroll
  for (int i = 0; i < FF_PARAMS; ++i) {
    const float v = i == 0 ? s.cv : (i == 1 ? s.k : (i == FF_ZSHIFT ? 0.f : s.co[i - 2]));
    th[i] = lift(v, ff_seed<CODE>(i));
  }
}

// (sag, d sag / dx, d sag / dy) of freeform surface s at (x, y).
__device__ __forceinline__ void ff_sag_grad(const Surface& s, float x, float y, float& sv,
                                            float& gx, float& gy) {
  using T = Dual<float, 2>;
  T th[FF_PARAMS];
  ff_params<0>(s, [](float v, int) { return cst<T>(v); }, th);
  const T z = ff_sag(s, seeded<float, 2>(x, 0), seeded<float, 2>(y, 1), th, NoBasis());
  sv = z.v;
  gx = z.d[0];
  gy = z.d[1];
}

// w times (d sag / d cv, d sag / d k, d sag / d coefficients) at (x, y),
// added to sg (chain_bwd.cuh SurfGrad), for family CODE. A toroidal's
// alpha_i y^(2i) terms take d sag / d z_y y^(2i).
template <int CODE, class G>
__device__ __forceinline__ void ff_sag_partials_of(const Surface& s, float x, float y, float w,
                                                   G& sg) {
  constexpr int P = ff_nonlinear(CODE);
  using T = Dual<float, P>;
  T th[FF_PARAMS];
  ff_params<CODE>(s, [](float v, int d) { return d < 0 ? cst<T>(v) : seeded<float, P>(v, d); },
                  th);
  const T z = ff_sag(s, cst<T>(x), cst<T>(y), th, PartialsBasis<G>{sg, w});
#pragma unroll
  for (int d = 0; d < P; ++d) {
    const int slot = ff_slot<CODE>(d);
    if (slot == 0) {
      sg.cv += w * z.d[d];
    } else if (slot == 1) {
      sg.conic += w * z.d[d];
    } else if (slot == FF_ZSHIFT) {
      const float y2 = y * y;
      float yp = y2;
      for (int i = 1; i < s.nc; ++i) {
        sg.co[i] += w * z.d[d] * yp;
        yp = yp * y2;
      }
    } else {
      sg.co[slot - 2] += w * z.d[d];
    }
  }
}

// Reverse of the freeform gradient (dgx, dgy) -> the cotangents of x, y
// (added to dx, dy) and of cv, k and the coefficients (sg), for family
// CODE: the gradient of D_v z, v = (dgx, dgy). A toroidal's alpha_i takes
// D_v of d sag / d z_y y^(2i).
template <int CODE, class G>
__device__ __forceinline__ void ff_sag_grad_bwd_of(const Surface& s, float x, float y, float dgx,
                                                   float dgy, float& dx, float& dy, G& sg) {
  constexpr int P = ff_nonlinear(CODE);
  using I = Dual<float, 1>;
  using T = Dual<I, 2 + P>;
  T th[FF_PARAMS];
  ff_params<CODE>(s,
                  [](float v, int d) {
                    const I vi = {v, {0.f}};
                    return d < 0 ? cst<T>(v) : seeded<I, 2 + P>(vi, 2 + d);
                  },
                  th);
  const T z = ff_sag(s, seeded<I, 2 + P>(I{x, {dgx}}, 0), seeded<I, 2 + P>(I{y, {dgy}}, 1), th,
                     GradBwdBasis<G>{sg});
  dx += z.d[0].d[0];
  dy += z.d[1].d[0];
#pragma unroll
  for (int d = 0; d < P; ++d) {
    const int slot = ff_slot<CODE>(d);
    if (slot == 0) {
      sg.cv += z.d[2 + d].d[0];
    } else if (slot == 1) {
      sg.conic += z.d[2 + d].d[0];
    } else if (slot == FF_ZSHIFT) {
      const I yi = {y, {dgy}};
      const I y2 = yi * yi;
      I yp = y2;
      for (int i = 1; i < s.nc; ++i) {
        sg.co[i] += (z.d[2 + d] * yp).d[0];
        yp = yp * y2;
      }
    } else {
      sg.co[slot - 2] += z.d[2 + d].d[0];
    }
  }
}

// ff_sag_partials_of for surface s's family (the families of this build).
template <class G>
__device__ __forceinline__ void ff_sag_partials(const Surface& s, float x, float y, float w,
                                                G& sg) {
  if constexpr (has_family(GEOM_FORBES_Q2D)) {
    if (s.code == GEOM_FORBES_Q2D) {
      ff_sag_partials_of<GEOM_FORBES_Q2D>(s, x, y, w, sg);
      return;
    }
  }
  switch (s.code) {
    case GEOM_POLYNOMIAL_XY:
      if constexpr (has_family(GEOM_POLYNOMIAL_XY))
        ff_sag_partials_of<GEOM_POLYNOMIAL_XY>(s, x, y, w, sg);
      break;
    case GEOM_BICONIC:
      if constexpr (has_family(GEOM_BICONIC)) ff_sag_partials_of<GEOM_BICONIC>(s, x, y, w, sg);
      break;
    case GEOM_TOROIDAL:
      if constexpr (has_family(GEOM_TOROIDAL)) ff_sag_partials_of<GEOM_TOROIDAL>(s, x, y, w, sg);
      break;
    case GEOM_CHEBYSHEV:
      if constexpr (has_family(GEOM_CHEBYSHEV))
        ff_sag_partials_of<GEOM_CHEBYSHEV>(s, x, y, w, sg);
      break;
    case GEOM_ZERNIKE:
      if constexpr (has_family(GEOM_ZERNIKE)) ff_sag_partials_of<GEOM_ZERNIKE>(s, x, y, w, sg);
      break;
    default:
      if constexpr (has_family(GEOM_FORBES_QBFS))
        ff_sag_partials_of<GEOM_FORBES_QBFS>(s, x, y, w, sg);
      break;
  }
}

// ff_sag_grad_bwd_of for surface s's family (the families of this build).
template <class G>
__device__ __forceinline__ void ff_sag_grad_bwd(const Surface& s, float x, float y, float dgx,
                                                float dgy, float& dx, float& dy, G& sg) {
  if constexpr (has_family(GEOM_FORBES_Q2D)) {
    if (s.code == GEOM_FORBES_Q2D) {
      ff_sag_grad_bwd_of<GEOM_FORBES_Q2D>(s, x, y, dgx, dgy, dx, dy, sg);
      return;
    }
  }
  switch (s.code) {
    case GEOM_POLYNOMIAL_XY:
      if constexpr (has_family(GEOM_POLYNOMIAL_XY))
        ff_sag_grad_bwd_of<GEOM_POLYNOMIAL_XY>(s, x, y, dgx, dgy, dx, dy, sg);
      break;
    case GEOM_BICONIC:
      if constexpr (has_family(GEOM_BICONIC))
        ff_sag_grad_bwd_of<GEOM_BICONIC>(s, x, y, dgx, dgy, dx, dy, sg);
      break;
    case GEOM_TOROIDAL:
      if constexpr (has_family(GEOM_TOROIDAL))
        ff_sag_grad_bwd_of<GEOM_TOROIDAL>(s, x, y, dgx, dgy, dx, dy, sg);
      break;
    case GEOM_CHEBYSHEV:
      if constexpr (has_family(GEOM_CHEBYSHEV))
        ff_sag_grad_bwd_of<GEOM_CHEBYSHEV>(s, x, y, dgx, dgy, dx, dy, sg);
      break;
    case GEOM_ZERNIKE:
      if constexpr (has_family(GEOM_ZERNIKE))
        ff_sag_grad_bwd_of<GEOM_ZERNIKE>(s, x, y, dgx, dgy, dx, dy, sg);
      break;
    default:
      if constexpr (has_family(GEOM_FORBES_QBFS))
        ff_sag_grad_bwd_of<GEOM_FORBES_QBFS>(s, x, y, dgx, dgy, dx, dy, sg);
      break;
  }
}

}  // namespace otk
