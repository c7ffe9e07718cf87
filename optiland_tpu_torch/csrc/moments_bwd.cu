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
// runs the reverse sweep of chain_bwd.cuh, then the raygen adjoint. The block sums each surface's
// parameter cotangents into one partial row (warp shuffles, then shared
// memory in a fixed order); partials[block] holds S table rows and one rg
// row, summed by torch.sum in the wrapper: no float atomics, bitwise
// reproducible. Rays past n contribute nothing. Without diff_data the data
// cotangents are neither computed nor written (their pointers are NULL).
//
// Bound on an H100: FP32 operations of the re-trace plus the adjoint (about
// three times the forward's), not memory; the per-surface record lives in
// local memory (REC floats per surface per thread).
#include <cstdint>

#include "chain_bwd.cuh"

namespace {

__global__ void __launch_bounds__(otk::BLOCK)
moments_bwd_kernel(int n, int S, int n_newton, int field_angle, int object_infinite,
                   int diff_data, const float* __restrict__ rg,
                   const float* __restrict__ ftab, const int* __restrict__ itab,
                   const float* __restrict__ Hx, const float* __restrict__ Hy,
                   const float* __restrict__ Px, const float* __restrict__ Py,
                   const float* __restrict__ c, float* __restrict__ partials,
                   float* __restrict__ dHx, float* __restrict__ dHy,
                   float* __restrict__ dPx, float* __restrict__ dPy) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  __shared__ float s_rg[5];
  __shared__ float s_part[(otk::BLOCK / 32) * otk::F_STRIDE];
  otk::stage_tables(S, ftab, itab, rg, s_ft, s_it, s_rg);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < n;
  float rec[otk::MAX_SURFACES][otk::REC];
  float hx = 0.f, hy = 0.f, px = 0.f, py = 0.f, g_ip = 0.f;
  otk::Vec6 g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    hx = Hx[idx];
    hy = Hy[idx];
    px = Px[idx];
    py = Py[idx];
    otk::Ray r = otk::tile_raygen(field_angle, object_infinite, s_rg, hx, hy, px, py);
    otk::trace_chain(S, n_newton, s_ft, s_it, r, rec);
    g.x = r.i * (c[1] + 2.f * c[3] * r.x);
    g.y = r.i * (c[2] + 2.f * c[3] * r.y);
    g_ip = r.i * (c[0] + c[1] * r.x + c[2] * r.y + c[3] * (r.x * r.x + r.y * r.y));
  }
  const otk::BlockRows rows{partials + (size_t)blockIdx.x * (S + 1) * otk::F_STRIDE,
                            s_part};
  otk::reverse_chain(S, s_ft, s_it, rec, live, 0.f, g_ip, g, rows);

  float v[otk::F_STRIDE];
#pragma unroll
  for (int j = 0; j < otk::F_STRIDE; ++j) v[j] = 0.f;
  if (live) {
    float dd[4];
    otk::tile_raygen_bwd(field_angle, object_infinite, s_rg, hx, hy, px, py, g, v, dd);
    if (diff_data) {
      dHx[idx] = dd[0];
      dHy[idx] = dd[1];
      dPx[idx] = dd[2];
      dPy[idx] = dd[3];
    }
  }
  rows.put(S, v, 0x1fu);
}

}  // namespace

// Launch K2 on `stream` over n rays; partials holds (blocks, S + 1,
// F_STRIDE) floats. Returns cudaGetLastError().
extern "C" int moments_bwd(int n, int S, int n_newton, int field_angle,
                           int object_infinite, int diff_data, const void* rg,
                           const void* ftab, const void* itab, const void* Hx,
                           const void* Hy, const void* Px, const void* Py, const void* c,
                           void* partials, void* dHx, void* dHy, void* dPx, void* dPy,
                           void* stream) {
  const int blocks = (n + otk::BLOCK - 1) / otk::BLOCK;
  moments_bwd_kernel<<<blocks, otk::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, diff_data,
      static_cast<const float*>(rg), static_cast<const float*>(ftab),
      static_cast<const int*>(itab), static_cast<const float*>(Hx),
      static_cast<const float*>(Hy), static_cast<const float*>(Px),
      static_cast<const float*>(Py), static_cast<const float*>(c),
      static_cast<float*>(partials), static_cast<float*>(dHx), static_cast<float*>(dHy),
      static_cast<float*>(dPx), static_cast<float*>(dPy));
  return static_cast<int>(cudaGetLastError());
}
