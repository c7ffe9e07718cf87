// K3: in-kernel ray generation and the surface chain, writing the
// requested final per-ray arrays, one ray per thread (Hopper, sm_90a).
//
// Replaces the Pallas kernel `_raygen_forward` of
// optiland_tpu/trace/fused.py. Bit k of out_mask selects output k of
// (x, y, z, L, M, N, i, opd); an unrequested output pointer is NULL and is
// never written. Bound on an H100: FP32 operations of the chain, not
// memory (see trace/fused.py).
#include <cstdint>

#include "chain.cuh"

namespace {

struct Outs {
  float* p[8];
};

__global__ void __launch_bounds__(otk::BLOCK)
raygen_trace_fwd_kernel(int n, int S, int n_newton, int field_angle,
                        int object_infinite, int out_mask,
                        const float* __restrict__ rg, const float* __restrict__ ftab,
                        const int* __restrict__ itab, const float* __restrict__ Hx,
                        const float* __restrict__ Hy, const float* __restrict__ Px,
                        const float* __restrict__ Py, Outs outs) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  __shared__ float s_rg[5];
  otk::stage_tables(S, ftab, itab, rg, s_ft, s_it, s_rg);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  otk::Ray r = otk::tile_raygen(field_angle, object_infinite, s_rg, Hx[idx], Hy[idx],
                                Px[idx], Py[idx]);
  otk::trace_chain(S, n_newton, s_ft, s_it, r);
  const float v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (out_mask & (1 << k)) outs.p[k][idx] = v[k];
}

}  // namespace

// Launch K3 on `stream` over n rays; returns cudaGetLastError().
extern "C" int raygen_trace_fwd(int n, int S, int n_newton, int field_angle,
                                int object_infinite, int out_mask, const void* rg,
                                const void* ftab, const void* itab, const void* Hx,
                                const void* Hy, const void* Px, const void* Py,
                                void* ox, void* oy, void* oz, void* oL, void* oM,
                                void* oN, void* oi, void* oopd, void* stream) {
  const int blocks = (n + otk::BLOCK - 1) / otk::BLOCK;
  Outs outs = {{static_cast<float*>(ox), static_cast<float*>(oy),
                static_cast<float*>(oz), static_cast<float*>(oL),
                static_cast<float*>(oM), static_cast<float*>(oN),
                static_cast<float*>(oi), static_cast<float*>(oopd)}};
  raygen_trace_fwd_kernel<<<blocks, otk::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, out_mask,
      static_cast<const float*>(rg), static_cast<const float*>(ftab),
      static_cast<const int*>(itab), static_cast<const float*>(Hx),
      static_cast<const float*>(Hy), static_cast<const float*>(Px),
      static_cast<const float*>(Py), outs);
  return static_cast<int>(cudaGetLastError());
}
