// K5: the surface chain on rays the caller made, one ray per thread
// (Hopper, sm_90a), writing the 8 final per-ray arrays.
//
// Replaces the Pallas kernel `_fused_forward` of
// optiland_tpu/trace/fused.py: K3 with the in-kernel raygen replaced by
// loads of the caller's (x, y, z, L, M, N, i, opd). The per-ray wavelength
// is not read: the wrapper takes only uniform wavelengths, hoisted into
// the per-surface index table.
//
// Bound on an H100: FP32 operations of the chain; it also moves 64 bytes
// per ray (8 arrays in, 8 out), about 0.04 ms at 2M rays and 3.35 TB/s.
#include <cstdint>

#include "chain.cuh"

namespace {

struct Arrays {
  float* p[8];
};

__global__ void __launch_bounds__(otk::BLOCK)
fused_trace_fwd_kernel(int n, int S, int n_newton, const float* __restrict__ ftab,
                       const int* __restrict__ itab, Arrays rays, Arrays outs) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  otk::stage_tables(S, ftab, itab, nullptr, s_ft, s_it, nullptr);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                rays.p[4][idx], rays.p[5][idx], rays.p[6][idx], rays.p[7][idx]};
  otk::trace_chain(S, n_newton, s_ft, s_it, r);
  const float v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
#pragma unroll
  for (int k = 0; k < 8; ++k) outs.p[k][idx] = v[k];
}

}  // namespace

// Launch K5 on `stream` over n rays; returns cudaGetLastError().
extern "C" int fused_trace_fwd(int n, int S, int n_newton, const void* ftab,
                               const void* itab, void* x, void* y, void* z, void* L,
                               void* M, void* N, void* i, void* opd, void* ox, void* oy,
                               void* oz, void* oL, void* oM, void* oN, void* oi,
                               void* oopd, void* stream) {
  const int blocks = (n + otk::BLOCK - 1) / otk::BLOCK;
  Arrays rays = {{static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(z),
                  static_cast<float*>(L), static_cast<float*>(M), static_cast<float*>(N),
                  static_cast<float*>(i), static_cast<float*>(opd)}};
  Arrays outs = {{static_cast<float*>(ox), static_cast<float*>(oy),
                  static_cast<float*>(oz), static_cast<float*>(oL),
                  static_cast<float*>(oM), static_cast<float*>(oN),
                  static_cast<float*>(oi), static_cast<float*>(oopd)}};
  fused_trace_fwd_kernel<<<blocks, otk::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, static_cast<const float*>(ftab), static_cast<const int*>(itab), rays,
      outs);
  return static_cast<int>(cudaGetLastError());
}
