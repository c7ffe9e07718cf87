// K1: in-kernel ray generation, the surface chain and the spot-moment
// reduction, one ray per thread (Hopper, sm_90a).
//
// Replaces the Pallas kernel `_moments_forward` of
// optiland_tpu/trace/fused.py. Each block of 256 threads reduces its
// masked (i, x i, y i, (x^2 + y^2) i) by warp shuffles and then shared
// memory to one partial per block, written to partials[block][0..3]; the
// wrapper sums the partials with torch.sum (deterministic, no atomics).
// Rays past n contribute nothing. Bound on an H100: FP32 operations of the
// chain, not memory (see trace/fused.py).
#include <cstdint>

#include "chain.cuh"

namespace {

__global__ void __launch_bounds__(otk::BLOCK)
moments_fwd_kernel(int n, int S, int n_newton, int field_angle, int object_infinite,
                   const float* __restrict__ rg, const float* __restrict__ ftab,
                   const int* __restrict__ itab, const float* __restrict__ Hx,
                   const float* __restrict__ Hy, const float* __restrict__ Px,
                   const float* __restrict__ Py, float* __restrict__ partials) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  __shared__ float s_rg[5];
  __shared__ float s_red[4][otk::BLOCK / 32];
  otk::stage_tables(S, ftab, itab, rg, s_ft, s_it, s_rg);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  if (idx < n) {
    otk::Ray r = otk::tile_raygen(field_angle, object_infinite, s_rg, Hx[idx],
                                  Hy[idx], Px[idx], Py[idx]);
    otk::trace_chain(S, n_newton, s_ft, s_it, r);
    m[0] = r.i;
    m[1] = r.x * r.i;
    m[2] = r.y * r.i;
    m[3] = (r.x * r.x + r.y * r.y) * r.i;
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
      float v = (lane < otk::BLOCK / 32) ? s_red[q][lane] : 0.f;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partials[blockIdx.x * 4 + q] = v;
    }
  }
}

}  // namespace

// Launch K1 on `stream` over n rays; returns cudaGetLastError().
extern "C" int moments_fwd(int n, int S, int n_newton, int field_angle,
                           int object_infinite, const void* rg, const void* ftab,
                           const void* itab, const void* Hx, const void* Hy,
                           const void* Px, const void* Py, void* partials,
                           void* stream) {
  const int blocks = (n + otk::BLOCK - 1) / otk::BLOCK;
  moments_fwd_kernel<<<blocks, otk::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, static_cast<const float*>(rg),
      static_cast<const float*>(ftab), static_cast<const int*>(itab),
      static_cast<const float*>(Hx), static_cast<const float*>(Hy),
      static_cast<const float*>(Px), static_cast<const float*>(Py),
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}
