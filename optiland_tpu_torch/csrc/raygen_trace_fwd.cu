// K3: in-kernel ray generation and the surface chain of one system,
// writing the requested final per-ray arrays (Hopper, sm_90a).
//
// Replaces the Pallas kernel `_raygen_forward` of
// optiland_tpu/trace/fused.py: K1's per-ray body (csrc/moments_fwd.cu,
// `system_raygen` then `trace_system`) ending in stores instead of the
// moment reduction. Like K1 it is built once per system, with the codes as
// nvcc definitions (system_chain.cuh; trace/fused.py `system_defines`,
// _build.py `variant`), with approximate division and square root
// (_build.py PER_SYSTEM), in `blocks` blocks of SYSTEM_THREADS threads,
// each staging the float table and the raygen scalars once and then
// walking tiles of SYSTEM_THREADS rays. The wrapper shapes the grid from
// `raygen_trace_fwd_blocks_per_sm` (`fused.system_grid`): nvcc gives K3
// ~40 registers, so an SM holds 6 of its blocks and it takes a block a
// tile, 6% faster on an H100 than a persistent grid (PERF.md).
//
// Bit k of out_mask selects output k of (x, y, z, L, M, N, i, opd); an
// unrequested output pointer is NULL and is never written. The mask is one
// value for the whole grid, so its branches do not diverge.
//
// Bound on an H100: the FP32 operations of the chain (~10^3 a ray on the
// bench lens, chip_smoke.py:chain_ops_per_ray), not memory (16 bytes in
// and at most 32 out a ray).
//
// Built with the media's codes too (OTK_MATERIALS), it is the per-ray
// variant, entry point `raygen_trace_fwd_w`: each ray's index and
// absorption at its own w, as K1's per-ray variant (csrc/moments_fwd.cu).
#include <cstdint>

#include "system_chain.cuh"

namespace {

constexpr int THREADS = otk::SYSTEM_THREADS;

struct Outs {
  float* p[8];
};

__global__ void __launch_bounds__(THREADS)
raygen_trace_fwd_kernel(int n, int out_mask,
#ifdef OTK_MATERIALS
                        int mat_w, int K, const float* __restrict__ mat,
                        const float* __restrict__ kwl, const float* __restrict__ kval,
                        const float* __restrict__ w,
#endif
                        const float* __restrict__ rg,
                        const float* __restrict__ ftab, const float* __restrict__ Hx,
                        const float* __restrict__ Hy, const float* __restrict__ Px,
                        const float* __restrict__ Py, Outs outs) {
  __shared__ float s_ft[OTK_FT_FLOATS(OTK_S)];
  __shared__ float s_rg[5];
#ifdef OTK_MATERIALS
  __shared__ float s_mat[OTK_S * otk::MAT_SHARED];
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
#endif
  otk::stage_system(ftab, rg, s_ft, s_rg);

  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < n; idx += gridDim.x * THREADS) {
    otk::Ray r = otk::system_raygen(s_rg, Hx[idx], Hy[idx], Px[idx], Py[idx]);
#ifdef OTK_MATERIALS
    otk::trace_system(s_ft, otk::RayMedia{mat, s_mat, kwl, kval, mat_w, K, w[idx]}, r,
                      otk::NoSink());
#else
    otk::trace_system(s_ft, r);
#endif
    const float v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (out_mask & (1 << k)) outs.p[k][idx] = v[k];
  }
}

}  // namespace

// K3 blocks that fit one SM at once (the occupancy of this build), or a
// negative CUDA error.
extern "C" int raygen_trace_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, raygen_trace_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

#ifdef OTK_MATERIALS
// Launch the per-ray K3 as `raygen_trace_fwd` does, with the material rows
// mat (S, mat_w), the extinction tables kwl and kval (S, K) and each ray's
// w.
extern "C" int raygen_trace_fwd_w(int n, int S, int blocks, int out_mask, int mat_w, int K,
                                  const void* rg, const void* ftab, const void* mat,
                                  const void* kwl, const void* kval, const void* Hx,
                                  const void* Hy, const void* Px, const void* Py,
                                  const void* w, void* ox, void* oy, void* oz, void* oL,
                                  void* oM, void* oN, void* oi, void* oopd, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const Outs outs = {{out(ox), out(oy), out(oz), out(oL), out(oM), out(oN), out(oi),
                      out(oopd)}};
  raygen_trace_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, out_mask, mat_w, K, in(mat), in(kwl), in(kval), in(w), in(rg), in(ftab), in(Hx),
      in(Hy), in(Px), in(Py), outs);
  return static_cast<int>(cudaGetLastError());
}
#else
// Launch K3 on `stream` over n rays of a system of S surfaces (this
// build's OTK_S, else cudaErrorInvalidValue) in `blocks` blocks. Returns
// cudaGetLastError().
extern "C" int raygen_trace_fwd(int n, int S, int blocks, int out_mask, const void* rg,
                                const void* ftab, const void* Hx, const void* Hy,
                                const void* Px, const void* Py, void* ox, void* oy,
                                void* oz, void* oL, void* oM, void* oN, void* oi,
                                void* oopd, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Outs outs = {{static_cast<float*>(ox), static_cast<float*>(oy),
                static_cast<float*>(oz), static_cast<float*>(oL),
                static_cast<float*>(oM), static_cast<float*>(oN),
                static_cast<float*>(oi), static_cast<float*>(oopd)}};
  raygen_trace_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, out_mask, static_cast<const float*>(rg), static_cast<const float*>(ftab),
      static_cast<const float*>(Hx), static_cast<const float*>(Hy),
      static_cast<const float*>(Px), static_cast<const float*>(Py), outs);
  return static_cast<int>(cudaGetLastError());
}
#endif
