// K4: the backward of K3, one ray per thread (Hopper, sm_90a): given
// per-ray cotangents of the final (x, y, z, L, M, N, i, opd), the
// cotangents of the five raygen scalars, the packed per-surface table and
// the per-ray (Hx, Hy, Px, Py).
//
// Replaces the Pallas kernel `_raygen_bwd` of optiland_tpu/trace/fused.py.
// A NULL seed pointer is a zero seed (the outputs K3 was not asked for);
// the seed of i reaches the table cotangents through the absorption
// factors only, since the generated i is 1. Each thread regenerates and
// re-traces its ray with a record, runs the reverse sweep of chain_bwd.cuh
// and the raygen adjoint. The launch geometry, the record and the warps'
// rows are K2's (moments_bwd.cu): one partial of S + 1 rows
// per block of a persistent grid, summed by torch.sum in the wrapper (no
// float atomics, bitwise reproducible on a given card).
//
// Bound on an H100: FP32 operations of the re-trace plus the adjoint, not
// the 40 bytes per ray it reads and writes.
//
// Built with the media's codes (OTK_MATERIALS) it is the per-ray variant,
// entry point `raygen_trace_bwd_w`: K2's per-ray sweep (moments_bwd.cu),
// with w's cotangent written per ray (dw). Without them the code is the
// one-wavelength K4 as it was, token for token.
//
// Built with OTK_INTERACTIONS (a system with a simple coating, a thin lens
// or a grating, trace/fused.py `branch_defines`, in either configuration),
// the re-trace takes those branches and the sweep their adjoints
// (chain_bwd.cuh), seeded with g_i, the final intensity's cotangent, for
// the coatings' cotangents. Without it g_i is not read and the kernel
// compiles as the one-wavelength K4 did before those branches.
#include <cstdint>

#include "chain_bwd.cuh"

namespace {

struct Seeds {
  const float* p[8];
};

__global__ void __launch_bounds__(otk::BWD_THREADS)
raygen_trace_bwd_kernel(int n, int S, int n_newton, int field_angle, int object_infinite,
#ifdef OTK_MATERIALS
                        int mat_w, int K, const float* __restrict__ mat,
                        const float* __restrict__ kwl, const float* __restrict__ kval,
                        const float* __restrict__ w, float* __restrict__ dw,
                        int* __restrict__ tab_seg, float* __restrict__ tab_val,
#endif
                        const float* __restrict__ rg, const float* __restrict__ ftab,
                        const int* __restrict__ itab, const float* __restrict__ Hx,
                        const float* __restrict__ Hy, const float* __restrict__ Px,
                        const float* __restrict__ Py, Seeds seeds,
                        float* __restrict__ partials, float* __restrict__ dHx,
                        float* __restrict__ dHy, float* __restrict__ dPx,
                        float* __restrict__ dPy) {
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
    float hx = 0.f, hy = 0.f, px = 0.f, py = 0.f, g_opd = 0.f, g_ip = 0.f, g_i = 0.f;
    otk::Vec6 g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#ifdef OTK_MATERIALS
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
      float sd[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sd[k] = seeds.p[k] ? seeds.p[k][idx] : 0.f;
      g = otk::Vec6{sd[0], sd[1], sd[2], sd[3], sd[4], sd[5]};
      g_opd = sd[7];
      g_ip = sd[6] * r.i;
      g_i = sd[6];
    }
#ifdef OTK_MATERIALS
    float d_w;
    otk::reverse_chain_w(S, sh.ft, sh.it, sh.pos, media, rec, live, g_opd, g_ip, g, rows,
                         S + 1, otk::TabulatedOut{tab_seg, tab_val, (size_t)n, idx}, d_w,
                         g_i);
#else
    otk::reverse_chain(S, sh.ft, sh.it, sh.pos, sh.npre, rec, live, g_opd,
                       g_ip, g, rows, g_i);
#endif
    float drg[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      float dd[4];
      otk::tile_raygen_bwd(field_angle, object_infinite, sh.rg, hx, hy, px, py, g, drg, dd);
      dHx[idx] = dd[0];
      dHy[idx] = dd[1];
      dPx[idx] = dd[2];
      dPy[idx] = dd[3];
#ifdef OTK_MATERIALS
      dw[idx] = d_w;
#endif
    }
    otk::put_raygen_row(rows, S, drg);
  }
  otk::write_partials(sh, nrows, partials + (size_t)blockIdx.x * nrows * otk::F_STRIDE);
}

cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(raygen_trace_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, otk::MAX_DYN_SMEM);
  return err;
}

}  // namespace

#ifdef OTK_MATERIALS
// Launch the per-ray K4 as `raygen_trace_bwd` does, with the material rows
// mat (S, mat_w), the extinction tables kwl and kval (S, K), each ray's w,
// its cotangent dw and the tabulated glasses' per-ray outputs tab_seg (T,
// n) and tab_val (T, 4, n); partials holds (blocks, 2 S + 1, F_STRIDE)
// floats. cudaErrorInvalidValue also for an S other than this build's.
extern "C" int raygen_trace_bwd_w(int n, int S, int n_newton, int field_angle,
                                  int object_infinite, int blocks, int threads, int mat_w,
                                  int K, const void* rg, const void* ftab, const void* itab,
                                  const void* mat, const void* kwl, const void* kval,
                                  const void* Hx, const void* Hy, const void* Px,
                                  const void* Py, const void* w, const void* sx,
                                  const void* sy, const void* sz, const void* sL,
                                  const void* sM, const void* sN, const void* si,
                                  const void* sopd, void* partials, void* dHx, void* dHy,
                                  void* dPx, void* dPy, void* dw, void* tab_seg,
                                  void* tab_val, void* stream) {
  if (!otk::bwd_threads_ok(threads) || S != otk::MEDIA)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem()) return static_cast<int>(err);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const Seeds seeds = {{in(sx), in(sy), in(sz), in(sL), in(sM), in(sN), in(si), in(sopd)}};
  raygen_trace_bwd_kernel<<<blocks, threads,
                            otk::bwd_w_smem_bytes(S, OTK_ROWS(2 * S + 1), threads),
                            static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, mat_w, K, in(mat), in(kwl), in(kval),
      in(w), out(dw), static_cast<int*>(tab_seg), out(tab_val), in(rg), in(ftab),
      static_cast<const int*>(itab), in(Hx), in(Hy), in(Px), in(Py), seeds, out(partials),
      out(dHx), out(dHy), out(dPx), out(dPy));
  return static_cast<int>(cudaGetLastError());
}
#else
// Launch K4 on `stream` over n rays in `blocks` blocks of `threads`
// threads (the wrapper's backward_grid); partials holds (blocks, S + 1,
// F_STRIDE) floats. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a thread count the kernel does not run.
extern "C" int raygen_trace_bwd(int n, int S, int n_newton, int field_angle,
                                int object_infinite, int blocks, int threads,
                                const void* rg,
                                const void* ftab, const void* itab, const void* Hx,
                                const void* Hy, const void* Px, const void* Py,
                                const void* sx,
                                const void* sy, const void* sz, const void* sL,
                                const void* sM, const void* sN, const void* si,
                                const void* sopd, void* partials, void* dHx, void* dHy,
                                void* dPx, void* dPy, void* stream) {
  if (!otk::bwd_threads_ok(threads) || S > otk::MAX_SURFACES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem()) return static_cast<int>(err);
  Seeds seeds = {{static_cast<const float*>(sx), static_cast<const float*>(sy),
                  static_cast<const float*>(sz), static_cast<const float*>(sL),
                  static_cast<const float*>(sM), static_cast<const float*>(sN),
                  static_cast<const float*>(si), static_cast<const float*>(sopd)}};
  raygen_trace_bwd_kernel<<<blocks, threads,
                            otk::bwd_smem_bytes(S, OTK_ROWS(S + 1), threads),
                            static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, static_cast<const float*>(rg),
      static_cast<const float*>(ftab), static_cast<const int*>(itab),
      static_cast<const float*>(Hx), static_cast<const float*>(Hy),
      static_cast<const float*>(Px), static_cast<const float*>(Py), seeds,
      static_cast<float*>(partials), static_cast<float*>(dHx), static_cast<float*>(dHy),
      static_cast<float*>(dPx), static_cast<float*>(dPy));
  return static_cast<int>(cudaGetLastError());
}
#endif
