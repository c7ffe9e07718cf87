// K6: the backward of K5, one ray per thread (Hopper, sm_90a): given
// per-ray cotangents of the final (x, y, z, L, M, N, i, opd), the
// cotangents of the caller's 8 starting arrays and of the packed
// per-surface table.
//
// Replaces the Pallas kernel `_fused_bwd` of optiland_tpu/trace/fused.py.
// A NULL seed pointer is a zero seed. Each thread re-traces its ray with a
// record (starting from i = 1, so the final i is the product of its masks
// and absorption factors), runs the reverse sweep of chain_bwd.cuh (with
// i di = seed_i * i_start * that product) and writes (dx, dy, dz, dL, dM,
// dN) of the start, di = seed_i * product and dopd = seed_opd. The launch
// geometry, the record and the warps' rows are K2's
// (moments_bwd.cu): one partial of S rows per block of a persistent grid,
// summed by torch.sum in the wrapper (no float atomics, bitwise
// reproducible on a given card).
//
// Bound on an H100: FP32 operations of the re-trace plus the adjoint; it
// moves 96 bytes per ray (8 arrays in, 8 seeds, 8 cotangents out).
//
// Built with the media's codes (OTK_MATERIALS) it is the per-ray variant,
// entry point `fused_trace_bwd_w`: the rays bring w, a 9th array, and the
// sweep is K2's per-ray one (moments_bwd.cu), its material rows S .. 2 S -
// 1; it writes w's cotangent as the 9th, the derivative of the kernel's
// function (JAX's `_fused_bwd` returns zeros for it, where its eager trace
// differentiates w). Without the media's codes the code is the
// one-wavelength K6 as it was, token for token.
//
// Built with OTK_INTERACTIONS (a system with a simple coating, a thin lens
// or a grating, trace/fused.py `branch_defines`, in either configuration),
// the re-trace takes those branches and the sweep their adjoints
// (chain_bwd.cuh), seeded with g_i, the final intensity's cotangent, for
// the coatings' cotangents. Without it g_i is not read and the kernel
// compiles as the one-wavelength K6 did before those branches.
#include <cstdint>

#include "chain_bwd.cuh"

namespace {

struct Arrays {
#ifdef OTK_MATERIALS
  float* p[9];  // and w, or its cotangent
#else
  float* p[8];
#endif
};

__global__ void __launch_bounds__(otk::BWD_THREADS)
fused_trace_bwd_kernel(int n, int S, int n_newton,
#ifdef OTK_MATERIALS
                       int mat_w, int K, const float* __restrict__ mat,
                       const float* __restrict__ kwl, const float* __restrict__ kval,
                       int* __restrict__ tab_seg, float* __restrict__ tab_val,
#endif
                       const float* __restrict__ ftab,
                       const int* __restrict__ itab, Arrays rays, Arrays seeds,
                       float* __restrict__ partials, Arrays d_rays) {
  extern __shared__ float smem[];
#ifdef OTK_MATERIALS
  const int nrows = OTK_ROWS(2 * S);
  const float* s_mat = otk::stage_backward_materials(smem, S, nrows, mat_w, mat);
#else
  const int nrows = OTK_ROWS(S);
#endif
  const otk::BwdShared sh = otk::stage_backward(smem, S, nrows, ftab, itab, nullptr);
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
    float sd[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    // g_i: the final intensity's cotangent times the starting intensity
    // (the re-trace starts from i = 1; the coatings', OTK_INTERACTIONS)
    float mask = 0.f, g_ip = 0.f, g_i = 0.f;
    otk::Vec6 g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#ifdef OTK_MATERIALS
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, live ? rays.p[8][idx] : 1.f};
#endif
    if (live) {
      otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                    rays.p[4][idx], rays.p[5][idx], 1.f, rays.p[7][idx]};
#ifdef OTK_MATERIALS
      otk::trace_chain_w(S, n_newton, sh.ft, sh.it, media, r, rec);
#else
      otk::trace_chain(S, n_newton, sh.ft, sh.it, r, rec);
#endif
      mask = r.i;
#pragma unroll
      for (int k = 0; k < 8; ++k) sd[k] = seeds.p[k] ? seeds.p[k][idx] : 0.f;
      g = otk::Vec6{sd[0], sd[1], sd[2], sd[3], sd[4], sd[5]};
      g_ip = sd[6] * rays.p[6][idx] * mask;
      g_i = sd[6] * rays.p[6][idx];
    }
#ifdef OTK_MATERIALS
    float d_w;
    otk::reverse_chain_w(S, sh.ft, sh.it, sh.pos, media, rec, live, sd[7], g_ip, g, rows, S,
                         otk::TabulatedOut{tab_seg, tab_val, (size_t)n, idx}, d_w, g_i);
    if (live) {
      const float v[9] = {g.x, g.y, g.z, g.L, g.M, g.N, sd[6] * mask, sd[7], d_w};
#pragma unroll
      for (int k = 0; k < 9; ++k) d_rays.p[k][idx] = v[k];
    }
#else
    otk::reverse_chain(S, sh.ft, sh.it, sh.pos, sh.npre, rec, live, sd[7],
                       g_ip, g, rows, g_i);
    if (live) {
      const float v[8] = {g.x, g.y, g.z, g.L, g.M, g.N, sd[6] * mask, sd[7]};
#pragma unroll
      for (int k = 0; k < 8; ++k) d_rays.p[k][idx] = v[k];
    }
#endif
  }
  otk::write_partials(sh, nrows, partials + (size_t)blockIdx.x * nrows * otk::F_STRIDE);
}

cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(fused_trace_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, otk::MAX_DYN_SMEM);
  return err;
}

}  // namespace

#ifdef OTK_MATERIALS
// Launch the per-ray K6 as `fused_trace_bwd` does, with the material rows
// mat (S, mat_w), the extinction tables kwl and kval (S, K), the rays' w
// (the 9th ray array), its cotangent dw (the 9th cotangent) and the
// tabulated glasses' per-ray outputs tab_seg (T, n) and tab_val (T, 4, n);
// partials holds (blocks, 2 S, F_STRIDE) floats. cudaErrorInvalidValue
// also for an S other than this build's.
extern "C" int fused_trace_bwd_w(int n, int S, int n_newton, int blocks, int threads,
                                 int mat_w, int K, const void* ftab, const void* itab,
                                 const void* mat, const void* kwl, const void* kval, void* x,
                                 void* y, void* z, void* L, void* M, void* N, void* i,
                                 void* opd, void* w, void* sx, void* sy, void* sz, void* sL,
                                 void* sM, void* sN, void* si, void* sopd, void* partials,
                                 void* dx, void* dy, void* dz, void* dL, void* dM, void* dN,
                                 void* di, void* dopd, void* dw, void* tab_seg,
                                 void* tab_val, void* stream) {
  if (!otk::bwd_threads_ok(threads) || S != otk::MEDIA)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem()) return static_cast<int>(err);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const Arrays rays = {{f(x), f(y), f(z), f(L), f(M), f(N), f(i), f(opd), f(w)}};
  const Arrays seeds = {{f(sx), f(sy), f(sz), f(sL), f(sM), f(sN), f(si), f(sopd), nullptr}};
  const Arrays d_rays = {{f(dx), f(dy), f(dz), f(dL), f(dM), f(dN), f(di), f(dopd), f(dw)}};
  fused_trace_bwd_kernel<<<blocks, threads,
                           otk::bwd_w_smem_bytes(S, OTK_ROWS(2 * S), threads),
                           static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, mat_w, K, in(mat), in(kwl), in(kval), static_cast<int*>(tab_seg),
      f(tab_val), in(ftab), static_cast<const int*>(itab), rays, seeds, f(partials), d_rays);
  return static_cast<int>(cudaGetLastError());
}
#else
// Launch K6 on `stream` over n rays in `blocks` blocks of `threads`
// threads (the wrapper's backward_grid); partials holds (blocks, S,
// F_STRIDE) floats. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a thread count the kernel does not run.
extern "C" int fused_trace_bwd(int n, int S, int n_newton, int blocks, int threads,
                               const void* ftab, const void* itab, void* x, void* y, void* z, void* L,
                               void* M, void* N, void* i, void* opd, void* sx, void* sy,
                               void* sz, void* sL, void* sM, void* sN, void* si,
                               void* sopd, void* partials, void* dx, void* dy, void* dz,
                               void* dL, void* dM, void* dN, void* di, void* dopd,
                               void* stream) {
  if (!otk::bwd_threads_ok(threads) || S > otk::MAX_SURFACES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem()) return static_cast<int>(err);
  Arrays rays = {{static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(z),
                  static_cast<float*>(L), static_cast<float*>(M), static_cast<float*>(N),
                  static_cast<float*>(i), static_cast<float*>(opd)}};
  Arrays seeds = {{static_cast<float*>(sx), static_cast<float*>(sy),
                   static_cast<float*>(sz), static_cast<float*>(sL),
                   static_cast<float*>(sM), static_cast<float*>(sN),
                   static_cast<float*>(si), static_cast<float*>(sopd)}};
  Arrays d_rays = {{static_cast<float*>(dx), static_cast<float*>(dy),
                    static_cast<float*>(dz), static_cast<float*>(dL),
                    static_cast<float*>(dM), static_cast<float*>(dN),
                    static_cast<float*>(di), static_cast<float*>(dopd)}};
  fused_trace_bwd_kernel<<<blocks, threads,
                           otk::bwd_smem_bytes(S, OTK_ROWS(S), threads),
                           static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, static_cast<const float*>(ftab), static_cast<const int*>(itab), rays,
      seeds, static_cast<float*>(partials), d_rays);
  return static_cast<int>(cudaGetLastError());
}
#endif
