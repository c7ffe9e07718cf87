// K5: the surface chain of one system on rays the caller made, writing the
// 8 final per-ray arrays (Hopper, sm_90a).
//
// Replaces the Pallas kernel `_fused_forward` of
// optiland_tpu/trace/fused.py: K3 (csrc/raygen_trace_fwd.cu) with the
// in-kernel raygen replaced by loads of the caller's (x, y, z, L, M, N, i,
// opd). Built once per system like K1 and K3 (system_chain.cuh; trace/fused.py
// `system_defines`, _build.py `variant` and PER_SYSTEM's approximate
// division and square root), each block staging the float table once and
// then walking tiles of SYSTEM_THREADS rays, over the grid the wrapper
// shapes from `fused_trace_fwd_blocks_per_sm` (`fused.system_grid`). Built
// with the media's codes too (OTK_MATERIALS), it is the per-ray variant,
// entry point `fused_trace_fwd_w`: it also loads each ray's w, a 9th
// array, and takes each ray's index and absorption at it, as K1's per-ray
// variant (csrc/moments_fwd.cu); without them the wavelength is the
// tables' one, hoisted into the per-surface index table.
//
// Registers: left free, nvcc gave the bench lens's K5 114 registers, two
// blocks an SM; held to three blocks an SM (80 registers, no spills) it
// ran 9% faster on an H100, where four or more spilled (PERF.md).
//
// Bound on an H100: FP32 operations of the chain. It also moves 64 bytes
// a ray (8 arrays in, 8 out), about 0.04 ms at 2M rays and 3.35 TB/s,
// below that bound: each thread loads its ray's 8 floats through
// read-only pointers, neighbouring threads on neighbouring addresses, so
// the warp's loads and stores coalesce without staging.
#include <cstdint>

#include "system_chain.cuh"

namespace {

constexpr int THREADS = otk::SYSTEM_THREADS;
constexpr int MIN_BLOCKS_PER_SM = 3;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
fused_trace_fwd_kernel(int n, const float* __restrict__ ftab, const float* __restrict__ x,
                       const float* __restrict__ y, const float* __restrict__ z,
                       const float* __restrict__ L, const float* __restrict__ M,
                       const float* __restrict__ N, const float* __restrict__ i,
                       const float* __restrict__ opd,
#ifdef OTK_MATERIALS
                       const float* __restrict__ w, int mat_w, int K,
                       const float* __restrict__ mat, const float* __restrict__ kwl,
                       const float* __restrict__ kval,
#endif
                       float* __restrict__ ox,
                       float* __restrict__ oy, float* __restrict__ oz,
                       float* __restrict__ oL, float* __restrict__ oM,
                       float* __restrict__ oN, float* __restrict__ oi,
                       float* __restrict__ oopd) {
  __shared__ float s_ft[OTK_FT_FLOATS(OTK_S)];
#ifdef OTK_MATERIALS
  __shared__ float s_mat[OTK_S * otk::MAT_SHARED];
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
#endif
  otk::stage_system(ftab, nullptr, s_ft, nullptr);

  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < n; idx += gridDim.x * THREADS) {
    otk::Ray r = {x[idx], y[idx], z[idx], L[idx], M[idx], N[idx], i[idx], opd[idx]};
#ifdef OTK_MATERIALS
    otk::trace_system(s_ft, otk::RayMedia{mat, s_mat, kwl, kval, mat_w, K, w[idx]}, r,
                      otk::NoSink());
#else
    otk::trace_system(s_ft, r);
#endif
    ox[idx] = r.x;
    oy[idx] = r.y;
    oz[idx] = r.z;
    oL[idx] = r.L;
    oM[idx] = r.M;
    oN[idx] = r.N;
    oi[idx] = r.i;
    oopd[idx] = r.opd;
  }
}

}  // namespace

// K5 blocks that fit one SM at once (the occupancy of this build), or a
// negative CUDA error.
extern "C" int fused_trace_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_trace_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

#ifdef OTK_MATERIALS
// Launch the per-ray K5 as `fused_trace_fwd` does, with the material rows
// mat (S, mat_w), the extinction tables kwl and kval (S, K) and the rays' w.
extern "C" int fused_trace_fwd_w(int n, int S, int blocks, int mat_w, int K, const void* ftab,
                                 const void* mat, const void* kwl, const void* kval,
                                 const void* x, const void* y, const void* z, const void* L,
                                 const void* M, const void* N, const void* i, const void* opd,
                                 const void* w, void* ox, void* oy, void* oz, void* oL,
                                 void* oM, void* oN, void* oi, void* oopd, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  fused_trace_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, in(ftab), in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), in(w), mat_w, K,
      in(mat), in(kwl), in(kval), out(ox), out(oy), out(oz), out(oL), out(oM), out(oN),
      out(oi), out(oopd));
  return static_cast<int>(cudaGetLastError());
}
#else
// Launch K5 on `stream` over n rays of a system of S surfaces (this
// build's OTK_S, else cudaErrorInvalidValue) in `blocks` blocks. Returns
// cudaGetLastError().
extern "C" int fused_trace_fwd(int n, int S, int blocks, const void* ftab, const void* x,
                               const void* y, const void* z, const void* L, const void* M,
                               const void* N, const void* i, const void* opd, void* ox,
                               void* oy, void* oz, void* oL, void* oM, void* oN, void* oi,
                               void* oopd, void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  fused_trace_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, in(ftab), in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), out(ox),
      out(oy), out(oz), out(oL), out(oM), out(oN), out(oi), out(oopd));
  return static_cast<int>(cudaGetLastError());
}
#endif
