// K7: the surface chain on rays the caller made, at each ray's own
// wavelength, writing every surface's state: the (S, n) history that
// `trace_system` returns (Hopper, sm_90a), one ray per thread.
//
// Replaces the Pallas kernel `_history_forward` of
// optiland_tpu/trace/fused.py (its body is `_tile_trace(static, False, ...,
// record=True, for_grad=False)`): per-ray `material_index` from the
// material rows and Beer-Lambert absorption from the extinction tables
// (chain.cuh `Dispersion`). Row 0 of the history is the starting bundle.
//
// Bound on an H100: bytes. Each ray reads 36 bytes and writes 8 S floats
// (256 bytes on the 8-surface Cooke triplet): 584 MB at 2M rays, 0.174 ms
// at 3.35 TB/s, against well under 0.1 ms of FP32 work. So the design
// stores each surface's 8 values as soon as the chain has computed them, at
// k n + idx: a warp's 32 stores to one array land on 128 contiguous bytes,
// and no thread keeps a record. Offsets are 64-bit (S n passes 2^31 at
// 268M rays on an 8-surface lens). The small per-surface tables are staged
// in shared memory once per block, with the first MAT_SHARED columns of
// the material rows; a tabulated glass's row (up to tens of thousands of
// floats) and the extinction tables are read from global memory, where
// the lanes of a warp mostly read the same address.
#include <cstdint>

#include "chain.cuh"

namespace {

struct Rays9 {
  const float* p[9];
};

struct History {
  float* p[8];
};

// Writes the state after surface k to row k of the 8 history arrays.
struct HistorySink {
  History h;
  size_t n, idx;
  __device__ __forceinline__ void operator()(int k, const otk::Ray& r) const {
    const size_t o = (size_t)k * n + idx;
    h.p[0][o] = r.x;
    h.p[1][o] = r.y;
    h.p[2][o] = r.z;
    h.p[3][o] = r.L;
    h.p[4][o] = r.M;
    h.p[5][o] = r.N;
    h.p[6][o] = r.i;
    h.p[7][o] = r.opd;
  }
};

__global__ void __launch_bounds__(otk::BLOCK)
history_fwd_kernel(int n, int S, int n_newton, int mat_w, int K,
                   const float* __restrict__ ftab, const int* __restrict__ itab,
                   const float* __restrict__ mat, const float* __restrict__ kwl,
                   const float* __restrict__ kval, Rays9 rays, History hist) {
  __shared__ float s_ft[otk::MAX_SURFACES * otk::F_STRIDE];
  __shared__ int s_it[otk::MAX_SURFACES * otk::I_STRIDE];
  __shared__ float s_mat[otk::MAX_SURFACES * otk::MAT_SHARED];
  otk::stage_materials(S, mat_w, mat, s_mat);
  otk::stage_tables(S, ftab, itab, nullptr, s_ft, s_it, nullptr);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                rays.p[4][idx], rays.p[5][idx], rays.p[6][idx], rays.p[7][idx]};
  const otk::Dispersion disp = {mat, s_mat, kwl, kval, mat_w, K, rays.p[8][idx]};
  const HistorySink sink = {hist, (size_t)n, (size_t)idx};
  sink(0, r);
  otk::trace_chain(S, n_newton, s_ft, s_it, r, nullptr, &disp, sink);
}

}  // namespace

// Launch K7 on `stream` over n rays: mat is (S, mat_w), kwl and kval
// (S, K), the 9 ray arrays (n,) and the 8 history arrays (S, n), all
// float32. Returns cudaGetLastError().
extern "C" int history_fwd(int n, int S, int n_newton, int mat_w, int K, const void* ftab,
                           const void* itab, const void* mat, const void* kwl,
                           const void* kval, const void* x, const void* y, const void* z,
                           const void* L, const void* M, const void* N, const void* i,
                           const void* opd, const void* w, void* hx, void* hy, void* hz,
                           void* hL, void* hM, void* hN, void* hi, void* hopd,
                           void* stream) {
  const int blocks = (n + otk::BLOCK - 1) / otk::BLOCK;
  Rays9 rays = {{static_cast<const float*>(x), static_cast<const float*>(y),
                 static_cast<const float*>(z), static_cast<const float*>(L),
                 static_cast<const float*>(M), static_cast<const float*>(N),
                 static_cast<const float*>(i), static_cast<const float*>(opd),
                 static_cast<const float*>(w)}};
  History hist = {{static_cast<float*>(hx), static_cast<float*>(hy), static_cast<float*>(hz),
                   static_cast<float*>(hL), static_cast<float*>(hM), static_cast<float*>(hN),
                   static_cast<float*>(hi), static_cast<float*>(hopd)}};
  history_fwd_kernel<<<blocks, otk::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, S, n_newton, mat_w, K, static_cast<const float*>(ftab),
      static_cast<const int*>(itab), static_cast<const float*>(mat),
      static_cast<const float*>(kwl), static_cast<const float*>(kval), rays, hist);
  return static_cast<int>(cudaGetLastError());
}
