// K2: the backward of K1, one ray per thread (Hopper, sm_90a): the
// cotangents of c . (sum i, sum x i, sum y i, sum (x^2+y^2) i) with
// respect to the five raygen scalars, the packed per-surface table and,
// with diff_data, the per-ray (Hx, Hy, Px, Py).
//
// Replaces the Pallas kernel `_moments_bwd` of optiland_tpu/trace/fused.py.
// Each thread regenerates its ray, re-traces it keeping each surface's
// entry state (chain.cuh `trace_chain` with a record), seeds the final
// (x, y) with i (c1 + 2 c3 x), i (c2 + 2 c3 y), and the intensity with
// i di = i (c0 + c1 x + c2 y + c3 (x^2 + y^2)) for the absorption adjoint,
// runs the reverse sweep of chain_bwd.cuh, then the raygen adjoint. Rays
// past n contribute nothing. Without diff_data the data cotangents are
// neither computed nor written (their pointers are NULL).
//
// Bound on an H100: FP32 operations of the re-trace plus the adjoint
// (about three times the forward's), not memory. The design, as measured
// on the card (PERF.md):
//   - the re-trace record (REC floats per surface) is a per-thread array
//     in local memory, which L1 holds (a block's 16 warps keep ~170 KB of
//     it on the bench lens); moved to shared memory it ran slower;
//   - each warp sums its rays' parameter cotangents per surface by a
//     reduce-scatter of the row's used width into its own rows in shared
//     memory, with no block barrier per surface;
//   - the grid is persistent, one block of 512 threads an SM (the
//     wrapper's `backward_grid`; 128 or 256 threads when n fits one such
//     tile to an SM), walking tiles of blockDim.x rays with one barrier a
//     tile, and each block writes one partial of S + 1 rows
//     at the end (S table rows and the raygen row), summed by torch.sum in
//     the wrapper: no float atomics, bitwise reproducible on a given card.
//
// Built with the media's codes (OTK_MATERIALS, trace/fused.py
// `media_defines`) it is the per-ray variant, entry point `moments_bwd_w`:
// the adjoint of JAX's `uniform_w=False` kernel. Each ray's re-trace takes
// its own index and absorption from its w (chain_bwd.cuh `trace_chain_w`,
// which records them, two floats a surface more), and the reverse sweep
// (`reverse_chain_w`) turns each medium's index cotangent into its
// coefficients' and w's before any sum over rays: a warp sums the formula
// glasses' coefficients into one more row per medium, rows S + 1 .. 2 S,
// and a tabulated glass's segment and its 4 cotangents go out per ray
// (tab_seg, tab_val), summed in a fixed order by the wrapper. With
// diff_data it writes w's cotangent too (dw). Without the media's codes the
// code is the one-wavelength K2 as it was, token for token.
//
// Built with OTK_INTERACTIONS (a system with a simple coating, a thin lens
// or a grating, trace/fused.py `branch_defines`, in either configuration),
// the re-trace takes those branches and the sweep their adjoints
// (chain_bwd.cuh), seeded with g_i, the final intensity's cotangent, for
// the coatings' cotangents. Without it g_i is not read and the kernel
// compiles as the one-wavelength K2 did before those branches.
#include <cstdint>

#include "chain_bwd.cuh"

namespace {

__global__ void __launch_bounds__(otk::BWD_THREADS)
moments_bwd_kernel(int n, int S, int n_newton, int field_angle, int object_infinite,
                   int diff_data,
#ifdef OTK_MATERIALS
                   int mat_w, int K, const float* __restrict__ mat,
                   const float* __restrict__ kwl, const float* __restrict__ kval,
                   const float* __restrict__ w, float* __restrict__ dw, int* __restrict__ tab_seg,
                   float* __restrict__ tab_val,
#endif
                   const float* __restrict__ rg,
                   const float* __restrict__ ftab, const int* __restrict__ itab,
                   const float* __restrict__ Hx, const float* __restrict__ Hy,
                   const float* __restrict__ Px, const float* __restrict__ Py,
                   const float* __restrict__ c, float* __restrict__ partials,
                   float* __restrict__ dHx, float* __restrict__ dHy,
                   float* __restrict__ dPx, float* __restrict__ dPy) {
  extern __shared__ float smem[];
#ifdef OTK_MATERIALS
  const int nrows = OTK_ROWS(2 * S + 1);
  const float* s_mat = otk::stage_backward_materials(smem, S, nrows, mat_w, mat);
#else
  const int nrows = OTK_ROWS(S + 1);
#endif
  const otk::BwdShared sh = otk::stage_backward(smem, S, nrows, ftab, itab, rg);
  const otk::WarpRows rows = otk::warp_rows(sh, nrows);
#ifdef OTK_MATERIALS
  float rec[otk::MEDIA][otk::REC_W];
#else
  float rec[otk::MAX_SURFACES][otk::REC];
#endif
  const int tiles = (n + blockDim.x - 1) / blockDim.x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the block's warps start each tile in step
    const int idx = tile * blockDim.x + threadIdx.x;
    const bool live = idx < n;
    // g_i: the final intensity's cotangent (the coatings', OTK_INTERACTIONS)
    float hx = 0.f, hy = 0.f, px = 0.f, py = 0.f, g_ip = 0.f, g_i = 0.f;
    otk::Vec6 g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#ifdef OTK_MATERIALS
    // a dead lane's w: 1, finite in every formula (JAX pads with it)
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, live ? w[idx] : 1.f};
#endif
    if (live) {
      hx = Hx[idx];
      hy = Hy[idx];
      px = Px[idx];
      py = Py[idx];
      otk::Ray r = otk::tile_raygen(field_angle, object_infinite, sh.rg, hx, hy, px, py);
#ifdef OTK_MATERIALS
      otk::trace_chain_w(S, n_newton, sh.ft, sh.it, media, r, rec);
#else
      otk::trace_chain(S, n_newton, sh.ft, sh.it, r, rec);
#endif
      g.x = r.i * (c[1] + 2.f * c[3] * r.x);
      g.y = r.i * (c[2] + 2.f * c[3] * r.y);
      g_ip = r.i * (c[0] + c[1] * r.x + c[2] * r.y + c[3] * (r.x * r.x + r.y * r.y));
      g_i = c[0] + c[1] * r.x + c[2] * r.y + c[3] * (r.x * r.x + r.y * r.y);
    }
#ifdef OTK_MATERIALS
    float d_w;
    otk::reverse_chain_w(S, sh.ft, sh.it, sh.pos, media, rec, live, 0.f, g_ip, g, rows, S + 1,
                         otk::TabulatedOut{tab_seg, tab_val, (size_t)n, idx}, d_w, g_i);
#else
    otk::reverse_chain(S, sh.ft, sh.it, sh.pos, sh.npre, rec, live, 0.f, g_ip,
                       g, rows, g_i);
#endif
    float drg[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      float dd[4];
      otk::tile_raygen_bwd(field_angle, object_infinite, sh.rg, hx, hy, px, py, g, drg, dd);
      if (diff_data) {
        dHx[idx] = dd[0];
        dHy[idx] = dd[1];
        dPx[idx] = dd[2];
        dPy[idx] = dd[3];
#ifdef OTK_MATERIALS
        dw[idx] = d_w;
#endif
      }
    }
    otk::put_raygen_row(rows, S, drg);
  }
  otk::write_partials(sh, nrows, partials + (size_t)blockIdx.x * nrows * otk::F_STRIDE);
}

cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      moments_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, otk::MAX_DYN_SMEM);
  return err;
}

}  // namespace

#ifdef OTK_MATERIALS
// Launch the per-ray K2 as `moments_bwd` does, with the material rows mat
// (S, mat_w), the extinction tables kwl and kval (S, K), each ray's w, its
// cotangent dw (written with diff_data) and the tabulated glasses' per-ray
// outputs tab_seg (T, n) and tab_val (T, 4, n); partials holds (blocks,
// 2 S + 1, F_STRIDE) floats. cudaErrorInvalidValue also for an S other
// than this build's.
extern "C" int moments_bwd_w(int n, int S, int n_newton, int field_angle, int object_infinite,
                             int blocks, int threads, int diff_data, int mat_w, int K,
                             const void* rg, const void* ftab, const void* itab,
                             const void* mat, const void* kwl, const void* kval,
                             const void* Hx, const void* Hy, const void* Px, const void* Py,
                             const void* w, const void* c, void* partials, void* dHx,
                             void* dHy, void* dPx, void* dPy, void* dw, void* tab_seg,
                             void* tab_val, void* stream) {
  if (!otk::bwd_threads_ok(threads) || S != otk::MEDIA)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem()) return static_cast<int>(err);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  moments_bwd_kernel<<<blocks, threads,
                       otk::bwd_w_smem_bytes(S, OTK_ROWS(2 * S + 1), threads),
                       static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, diff_data, mat_w, K, in(mat), in(kwl),
      in(kval), in(w), out(dw), static_cast<int*>(tab_seg), out(tab_val), in(rg), in(ftab),
      static_cast<const int*>(itab), in(Hx), in(Hy), in(Px), in(Py), in(c), out(partials),
      out(dHx), out(dHy), out(dPx), out(dPy));
  return static_cast<int>(cudaGetLastError());
}
#else
// Launch K2 on `stream` over n rays in `blocks` blocks of `threads`
// threads (the wrapper's backward_grid); partials holds (blocks, S + 1,
// F_STRIDE) floats. Returns cudaGetLastError(), which also reports a
// dynamic shared memory request the card refuses, or cudaErrorInvalidValue
// for a thread count the kernel does not run.
extern "C" int moments_bwd(int n, int S, int n_newton, int field_angle,
                           int object_infinite, int blocks, int threads, int diff_data,
                           const void* rg,
                           const void* ftab, const void* itab, const void* Hx,
                           const void* Hy, const void* Px, const void* Py, const void* c,
                           void* partials, void* dHx, void* dHy, void* dPx, void* dPy,
                           void* stream) {
  if (!otk::bwd_threads_ok(threads) || S > otk::MAX_SURFACES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem()) return static_cast<int>(err);
  moments_bwd_kernel<<<blocks, threads,
                       otk::bwd_smem_bytes(S, OTK_ROWS(S + 1), threads),
                       static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, diff_data,
      static_cast<const float*>(rg), static_cast<const float*>(ftab),
      static_cast<const int*>(itab), static_cast<const float*>(Hx),
      static_cast<const float*>(Hy), static_cast<const float*>(Px),
      static_cast<const float*>(Py), static_cast<const float*>(c),
      static_cast<float*>(partials), static_cast<float*>(dHx), static_cast<float*>(dHy),
      static_cast<float*>(dPx), static_cast<float*>(dPy));
  return static_cast<int>(cudaGetLastError());
}
#endif
