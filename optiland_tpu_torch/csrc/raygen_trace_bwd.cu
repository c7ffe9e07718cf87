// K4: the backward of K3, one ray per thread (Hopper, sm_90a): given
// per-ray cotangents of the final (x, y, z, L, M, N, i, opd), the
// cotangents of the five raygen scalars, the packed per-surface table and
// the per-ray (Hx, Hy, Px, Py).
//
// Replaces the Pallas kernel `_raygen_bwd` of optiland_tpu/trace/fused.py.
// A NULL seed pointer is a zero seed (the outputs K3 was not asked for);
// the seed of i reaches the table cotangents through the absorption
// factors only, since the generated i is 1. Each thread
// regenerates and re-traces its ray with a record, runs the reverse sweep
// of chain_bwd.cuh and the raygen adjoint; the block sums the parameter
// cotangents into one partial row per surface plus one rg row, summed by
// torch.sum in the wrapper (no float atomics, bitwise reproducible).
//
// Bound on an H100: FP32 operations of the re-trace plus the adjoint, not
// the 40 bytes per ray it reads and writes.
#include <cstdint>

#include "chain_bwd.cuh"

namespace {

struct Seeds {
  const float* p[8];
};

__global__ void __launch_bounds__(otk::BLOCK)
raygen_trace_bwd_kernel(int n, int S, int n_newton, int field_angle, int object_infinite,
                        const float* __restrict__ rg, const float* __restrict__ ftab,
                        const int* __restrict__ itab, const float* __restrict__ Hx,
                        const float* __restrict__ Hy, const float* __restrict__ Px,
                        const float* __restrict__ Py, Seeds seeds,
                        float* __restrict__ partials, float* __restrict__ dHx,
                        float* __restrict__ dHy, float* __restrict__ dPx,
                        float* __restrict__ dPy) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  __shared__ float s_rg[5];
  __shared__ float s_part[(otk::BLOCK / 32) * otk::F_STRIDE];
  otk::stage_tables(S, ftab, itab, rg, s_ft, s_it, s_rg);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < n;
  float rec[otk::MAX_SURFACES][otk::REC];
  float hx = 0.f, hy = 0.f, px = 0.f, py = 0.f, g_opd = 0.f, g_ip = 0.f;
  otk::Vec6 g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    hx = Hx[idx];
    hy = Hy[idx];
    px = Px[idx];
    py = Py[idx];
    otk::Ray r = otk::tile_raygen(field_angle, object_infinite, s_rg, hx, hy, px, py);
    otk::trace_chain(S, n_newton, s_ft, s_it, r, rec);
    float sd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sd[k] = seeds.p[k] ? seeds.p[k][idx] : 0.f;
    g = otk::Vec6{sd[0], sd[1], sd[2], sd[3], sd[4], sd[5]};
    g_opd = sd[7];
    g_ip = sd[6] * r.i;
  }
  const otk::BlockRows rows{partials + (size_t)blockIdx.x * (S + 1) * otk::F_STRIDE,
                            s_part};
  otk::reverse_chain(S, s_ft, s_it, rec, live, g_opd, g_ip, g, rows);

  float v[otk::F_STRIDE];
#pragma unroll
  for (int j = 0; j < otk::F_STRIDE; ++j) v[j] = 0.f;
  if (live) {
    float dd[4];
    otk::tile_raygen_bwd(field_angle, object_infinite, s_rg, hx, hy, px, py, g, v, dd);
    dHx[idx] = dd[0];
    dHy[idx] = dd[1];
    dPx[idx] = dd[2];
    dPy[idx] = dd[3];
  }
  rows.put(S, v, 0x1fu);
}

}  // namespace

// Launch K4 on `stream` over n rays; partials holds (blocks, S + 1,
// F_STRIDE) floats. Returns cudaGetLastError().
extern "C" int raygen_trace_bwd(int n, int S, int n_newton, int field_angle,
                                int object_infinite, const void* rg, const void* ftab,
                                const void* itab, const void* Hx, const void* Hy,
                                const void* Px, const void* Py, const void* sx,
                                const void* sy, const void* sz, const void* sL,
                                const void* sM, const void* sN, const void* si,
                                const void* sopd, void* partials, void* dHx, void* dHy,
                                void* dPx, void* dPy, void* stream) {
  const int blocks = (n + otk::BLOCK - 1) / otk::BLOCK;
  Seeds seeds = {{static_cast<const float*>(sx), static_cast<const float*>(sy),
                  static_cast<const float*>(sz), static_cast<const float*>(sL),
                  static_cast<const float*>(sM), static_cast<const float*>(sN),
                  static_cast<const float*>(si), static_cast<const float*>(sopd)}};
  raygen_trace_bwd_kernel<<<blocks, otk::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, field_angle, object_infinite, static_cast<const float*>(rg),
      static_cast<const float*>(ftab), static_cast<const int*>(itab),
      static_cast<const float*>(Hx), static_cast<const float*>(Hy),
      static_cast<const float*>(Px), static_cast<const float*>(Py), seeds,
      static_cast<float*>(partials), static_cast<float*>(dHx), static_cast<float*>(dHy),
      static_cast<float*>(dPx), static_cast<float*>(dPy));
  return static_cast<int>(cudaGetLastError());
}
