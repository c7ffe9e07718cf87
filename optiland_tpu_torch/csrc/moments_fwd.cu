// K1: in-kernel ray generation, the surface chain and the spot-moment
// reduction for one system, one ray per thread (Hopper, sm_90a).
//
// Replaces the Pallas kernel `_moments_forward` of
// optiland_tpu/trace/fused.py, which unrolls the chain on the system's
// static codes. So does this kernel: it is built once per system, with the
// codes as nvcc definitions (system_chain.cuh; trace/fused.py
// `system_defines`, _build.py `variant`), and the per-surface step of
// chain.cuh runs with constant codes, unrolled, its untaken branches gone.
//
// Bound on an H100: the FP32 operations of the chain (~10^3 a ray on the
// bench lens, chip_smoke.py:chain_ops_per_ray), not memory (16 bytes a
// ray). The run-time chain of K2, K4, K6 also pays, per surface, the reloads
// of its codes, their branches, a run-time Newton count and coefficient
// loops, and each block of one ray a thread stages both tables behind a
// barrier. Here:
//   - the codes are constants: no int table, no code branches;
//   - `blocks` blocks of SYSTEM_THREADS threads, each staging the float
//     table and the raygen scalars once and then walking tiles of
//     SYSTEM_THREADS rays; at the 2-3 blocks an SM that K1's registers
//     allow (`moments_fwd_blocks_per_sm`), the wrapper takes a persistent
//     grid of at most as many blocks as fit the card at once
//     (`fused.system_grid`);
//   - each thread sums its rays' masked (i, x i, y i, (x^2 + y^2) i) in
//     registers; at the end the block reduces them by warp shuffles and
//     shared memory to one partial, partials[block][0..3], which the
//     wrapper sums with torch.sum (deterministic, no atomics).
//   - the arithmetic is the run-time chain's, compiled with approximate
//     division and square root (-prec-div=false -prec-sqrt=false,
//     _build.py PER_SYSTEM): with the control gone, the IEEE forms carried
//     a third of the kernel's time on an H100, and the approximate ones
//     hold every K1 check (PERF.md).
// Rays past n contribute nothing.
//
// Built with the media's codes too (OTK_MATERIALS, trace/fused.py
// `history_defines`), it is the per-ray variant, the `uniform_w=False`
// configuration of the JAX kernel: each ray brings its wavelength w, and
// each medium's index and absorption come from its dispersion formula
// (compile-time codes, the coefficients staged in shared memory) and
// extinction table at w (chain.cuh `RayMedia`, as K7's); its entry point is
// `moments_fwd_w`. Without them the code is the one-wavelength K1 as it
// was, token for token.
#include <cstdint>

#include "system_chain.cuh"

namespace {

constexpr int THREADS = otk::SYSTEM_THREADS;

__global__ void __launch_bounds__(THREADS)
moments_fwd_kernel(int n,
#ifdef OTK_MATERIALS
                   int mat_w, int K, const float* __restrict__ mat,
                   const float* __restrict__ kwl, const float* __restrict__ kval,
                   const float* __restrict__ w,
#endif
                   const float* __restrict__ rg, const float* __restrict__ ftab,
                   const float* __restrict__ Hx, const float* __restrict__ Hy,
                   const float* __restrict__ Px, const float* __restrict__ Py,
                   float* __restrict__ partials) {
  __shared__ float s_ft[OTK_FT_FLOATS(OTK_S)];
  __shared__ float s_rg[5];
  __shared__ float s_red[4][THREADS / 32];
#ifdef OTK_MATERIALS
  __shared__ float s_mat[OTK_S * otk::MAT_SHARED];
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
#endif
  otk::stage_system(ftab, rg, s_ft, s_rg);

  float m[4] = {0.f, 0.f, 0.f, 0.f};
  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < n; idx += gridDim.x * THREADS) {
    otk::Ray r = otk::system_raygen(s_rg, Hx[idx], Hy[idx], Px[idx], Py[idx]);
#ifdef OTK_MATERIALS
    otk::trace_system(s_ft, otk::RayMedia{mat, s_mat, kwl, kval, mat_w, K, w[idx]}, r,
                      otk::NoSink());
#else
    otk::trace_system(s_ft, r);
#endif
    m[0] += r.i;
    m[1] += r.x * r.i;
    m[2] += r.y * r.i;
    m[3] += (r.x * r.x + r.y * r.y) * r.i;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int off = 16; off > 0; off >>= 1)
      m[q] += __shfl_down_sync(0xffffffffu, m[q], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int q = 0; q < 4; ++q) s_red[q][warp] = m[q];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = (lane < THREADS / 32) ? s_red[q][lane] : 0.f;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partials[blockIdx.x * 4 + q] = v;
    }
  }
}

}  // namespace

// K1 blocks that fit one SM at once (the occupancy of this build), or a
// negative CUDA error.
extern "C" int moments_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, moments_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

#ifdef OTK_MATERIALS
// Launch the per-ray K1 as `moments_fwd` does, with the material rows mat
// (S, mat_w), the extinction tables kwl and kval (S, K) and each ray's w.
extern "C" int moments_fwd_w(int n, int S, int blocks, int mat_w, int K, const void* rg,
                             const void* ftab, const void* mat, const void* kwl,
                             const void* kval, const void* Hx, const void* Hy,
                             const void* Px, const void* Py, const void* w, void* partials,
                             void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  moments_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, mat_w, K, in(mat), in(kwl), in(kval), in(w), in(rg), in(ftab), in(Hx), in(Hy),
      in(Px), in(Py), static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}
#else
// Launch K1 on `stream` over n rays of a system of S surfaces (this
// build's OTK_S, else cudaErrorInvalidValue) in `blocks` blocks, each
// writing one (4,) partial. Returns cudaGetLastError().
extern "C" int moments_fwd(int n, int S, int blocks, const void* rg, const void* ftab,
                           const void* Hx, const void* Hy, const void* Px, const void* Py,
                           void* partials, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  moments_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(rg), static_cast<const float*>(ftab),
      static_cast<const float*>(Hx), static_cast<const float*>(Hy),
      static_cast<const float*>(Px), static_cast<const float*>(Py),
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}
#endif
