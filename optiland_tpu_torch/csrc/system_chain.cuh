// The surface chain of one system whose static codes are compile-time
// constants: K1 (csrc/moments_fwd.cu), K3 (csrc/raygen_trace_fwd.cu), K5
// (csrc/fused_trace_fwd.cu) and K7 (csrc/history_fwd.cu), each built once
// per system.
//
// The wrapper (trace/fused.py `system_defines`) passes the system's codes to
// nvcc as definitions (a header that nvcc includes first, _build.py):
//   OTK_S                 the number of surfaces;
//   OTK_NEWTON            the Newton updates after the first (n_newton);
//   OTK_FIELD_ANGLE       1 for angle fields, 0 for object heights;
//   OTK_OBJECT_INFINITE   1 for an object at infinity;
//   OTK_SURFACES          each surface's codes, k = 0 .. S-1, packed as
//                         `unpack_codes` reads them, separated by commas;
//   OTK_INTERACTIONS      where the system has a simple coating, a thin
//                         lens, a grating or a phase sheet
//                         (`branch_defines`): the chain's branches for them
//                         (chain.cuh);
//   OTK_PHASE             where it has a phase sheet: the phase branch, and
//                         each surface's phase kind in its codes;
//   OTK_FREEFORM          where it has a freeform (poly-XY, biconic,
//                         toroidal, Chebyshev, Zernike, Forbes Q-bfs), the
//                         mask of its families (freeform.cuh), with
//     OTK_NEWTON_FF       the freeforms' Newton updates after the first, and
//     OTK_FF_AUX          each surface's aux ints, aux0 | aux1 << 8,
//                         separated by commas (a Q-2D surface's: its
//                         groups' range, with OTK_Q2D_GROUPS, OTK_Q2D_ROWS
//                         and OTK_Q2D_NMAX, freeform.cuh);
//   OTK_WIDE              where a surface has more than 17 coefficient
//                         slots (chain.cuh), with OTK_WIDE_OFF, each
//                         surface's offset of its whole row in the float
//                         table (0 for the others), and OTK_WIDE_NC, each
//                         surface's count of slots, separated by commas;
// and for the builds at per-ray wavelengths, K7 and the per-ray variants of
// K1, K3 and K5, which evaluate the dispersion formulas per ray
// (trace/fused.py `history_defines`):
//   OTK_MATERIALS         the media's codes (chain.cuh `material_codes`).
// `trace_system` then calls chain.cuh's `surface_step`, the body of the
// run-time `trace_chain`, once per surface with constant codes: the
// surface loop, the Newton loop and the polynomial loops unroll, and the
// branches the system does not take (tilt, decenter, aperture, absorption,
// interaction, geometry) fold away. The values (curvatures, conics,
// coefficients, thicknesses, indices, alpha, apertures) stay in the float
// table that the kernel stages in shared memory. K7's form of it takes the
// ray's own wavelength (`RayMedia`): each medium's `material_index` with
// its formula and coefficient count as template parameters, the
// coefficients staged in shared memory, and the extinction table of each
// absorbing medium interpolated by its one segment (`kv_segment`).
//
// The four kernels share one launch shape: blocks of SYSTEM_THREADS
// threads, each staging the float table (and the raygen scalars) once with
// `stage_system`, then walking tiles of SYSTEM_THREADS rays; the wrapper
// sizes the grid from the occupancy each source exports,
// `<source>_blocks_per_sm` (trace/fused.py `system_grid`: a block a tile,
// or a persistent grid of at most as many blocks as fit the card at once).
#pragma once

#include "chain.cuh"

#if !defined(OTK_S) || !defined(OTK_NEWTON) || !defined(OTK_FIELD_ANGLE) || \
    !defined(OTK_OBJECT_INFINITE) || !defined(OTK_SURFACES)
#error "system_chain.cuh needs the system's codes: OTK_S, OTK_NEWTON, OTK_FIELD_ANGLE, OTK_OBJECT_INFINITE, OTK_SURFACES"
#endif

namespace otk {

// Threads a block of the per-system kernels (trace/fused.py _SYSTEM_THREADS).
constexpr int SYSTEM_THREADS = 256;

// Codes packed in one word: geometry bits 0-7, coefficient count 8-15,
// interaction 16-19, then one bit each for tilt, decenter, aperture and
// the absorption of the medium after the surface (bits 20-23), and for a
// simple coating's factor and a reflective grating or phase sheet (bits
// 24-25, set only in systems built with OTK_INTERACTIONS), then a phase
// sheet's kind (bits 26-28, set only in systems built with OTK_PHASE).
__host__ __device__ constexpr Codes unpack_codes(unsigned v) {
  return Codes{static_cast<int>(v & 0xffu), static_cast<int>((v >> 8) & 0xffu),
               static_cast<int>((v >> 16) & 0xfu), ((v >> 20) & 1u) != 0,
               ((v >> 21) & 1u) != 0, ((v >> 22) & 1u) != 0, ((v >> 23) & 1u) != 0
#ifdef OTK_INTERACTIONS
               , ((v >> 24) & 1u) != 0, ((v >> 25) & 1u) != 0
#endif
#ifdef OTK_PHASE
               , static_cast<int>((v >> 26) & 0x7u)
#endif
#ifdef OTK_FREEFORM
               , 0, 0, 0
#endif
#ifdef OTK_WIDE
               , 0, 0
#endif
  };
}

// Surface k's packed codes.
__host__ __device__ constexpr unsigned system_codes(int k) {
  constexpr unsigned table[] = {OTK_SURFACES};
  return table[k];
}

#ifdef OTK_FREEFORM
#if !defined(OTK_NEWTON_FF) || !defined(OTK_FF_AUX)
#error "a system with a freeform needs OTK_NEWTON_FF and OTK_FF_AUX"
#endif
#endif
#if defined(OTK_WIDE) && !(defined(OTK_WIDE_OFF) && defined(OTK_WIDE_NC))
#error "a system with a wide surface needs OTK_WIDE_OFF and OTK_WIDE_NC"
#endif
// Surface k's codes with its freeform aux ints and the freeforms' Newton
// count, and in a wide build its coefficient count and a wide surface's
// offset in the float table.
__host__ __device__ constexpr Codes surface_codes(int k) {
  Codes c = unpack_codes(system_codes(k));
#ifdef OTK_FREEFORM
  constexpr unsigned aux[] = {OTK_FF_AUX};
  c.a0 = static_cast<int>(aux[k] & 0xffu);
  c.a1 = static_cast<int>((aux[k] >> 8) & 0xffu);
  c.nff = OTK_NEWTON_FF;
#endif
#ifdef OTK_WIDE
  constexpr int off[] = {OTK_WIDE_OFF};
  constexpr int nc[] = {OTK_WIDE_NC};
  c.xoff = off[k];
  c.nc = nc[k];
#endif
  return c;
}

// Surfaces K .. S-1 on the running state; pos: the vertex z of surface
// K - 1; n_pre: the index before surface K; `media.at<K>()` gives surface
// K's absorption and index, `sink` each surface's state.
template <int K, class Media, class Sink>
__device__ __forceinline__ void system_chain_from(const float* ft, const Media& media,
                                                  const Sink& sink, Ray& r, float& pos,
                                                  float& n_pre) {
  if constexpr (K < OTK_S) {
    constexpr Codes c = surface_codes(K);
    constexpr bool absorbs_before = unpack_codes(system_codes(K - 1)).absorbs;
    pos = pos + (K > 1 ? ft[(K - 1) * F_STRIDE + F_THICK] : 0.f);
    surface_step(make_surface(c, absorbs_before, ft, K), K, OTK_NEWTON, pos, r, n_pre,
                 nullptr, media.template at<K>(), sink);
    system_chain_from<K + 1>(ft, media, sink, r, pos, n_pre);
  }
}

// The chain from surface 1 to S-1 on the staged float table: what
// trace_chain(OTK_S, OTK_NEWTON, ft, it, r) computes, by the same
// arithmetic in the same order.
__device__ __forceinline__ void trace_system(const float* ft, Ray& r) {
  float pos = 0.f, n_pre = ft[F_NTAB];
  system_chain_from<1>(ft, TableMedia(), NoSink(), r, pos, n_pre);
}

#ifdef OTK_MATERIALS
// Surface k's view of RayMedia for surface_step: the medium before it
// (row k - 1) absorbs, the one after it refracts.
template <int k>
struct RayMediaAt {
  const RayMedia& m;
  __device__ __forceinline__ float alpha_before(const Surface&) const {
    return m.alpha_after(k - 1);
  }
  __device__ __forceinline__ float index_after(const Surface&) const {
    return m.index_after<k>();
  }
#ifdef OTK_INTERACTIONS
  // a grating's order (the table's) times the ray's wavelength
  __device__ __forceinline__ float order_w(const Surface& s) const { return s.gm * m.w; }
#endif
#ifdef OTK_PHASE
  // a phase sheet's 1 / k0: the table's 1 / k0 per um times the ray's
  // wavelength
  __device__ __forceinline__ float phase_ik(const Surface& s) const { return s.ik * m.w; }
#endif
};

// The chain from surface 1 to S-1 at the ray's own wavelength (K7): what
// the run-time chain computed with per-ray dispersion, by the same
// arithmetic in the same order, the index before surface 1 from medium 0;
// `sink(k, ray)` sees the state after each surface.
template <class Sink>
__device__ __forceinline__ void trace_system(const float* ft, const RayMedia& media, Ray& r,
                                             const Sink& sink) {
  float pos = 0.f, n_pre = media.index_after<0>();
  system_chain_from<1>(ft, media, sink, r, pos, n_pre);
}
#endif

// The system's ray generation (`tile_raygen` with its field codes).
__device__ __forceinline__ Ray system_raygen(const float* rg, float Hx, float Hy, float Px,
                                             float Py) {
  return tile_raygen(OTK_FIELD_ANGLE, OTK_OBJECT_INFINITE, rg, Hx, Hy, Px, Py);
}

// Stage the system's float table (chain.cuh OTK_FT_FLOATS) and, where rg is
// not null, the five raygen scalars into shared memory; every thread of the
// block calls it, once.
__device__ __forceinline__ void stage_system(const float* __restrict__ ftab,
                                             const float* __restrict__ rg, float* s_ft,
                                             float* s_rg) {
  for (int j = threadIdx.x; j < OTK_FT_FLOATS(OTK_S); j += blockDim.x) s_ft[j] = ftab[j];
  if (rg != nullptr)
    for (int j = threadIdx.x; j < 5; j += blockDim.x) s_rg[j] = rg[j];
  __syncthreads();
}

}  // namespace otk
