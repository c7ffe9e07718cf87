// K8: the Huygens-Fresnel PSF summation (Hopper, sm_90a).
//
// Replaces the Pallas kernel `huygens_sum_pallas` of
// optiland_tpu/psf/huygens.py (body `_huygens_kernel`): for each of I image
// points the complex field summed over P pupil samples (huygens.cuh). On the
// TPU one program holds a 512 x 512 (image x pupil) tile and the sequential
// grid axis accumulates over the pupil in the output block. Here it is the
// N-body pattern:
//   - each thread owns NPT image points, their (re, im) sums in registers,
//     so that every staged pupil sample serves NPT contributions;
//   - the block stages the pupil through shared memory in tiles of TILE_P
//     samples, each packed as two float4s with its per-sample factors
//     (huygens.cuh `stage_sample`), which every thread then reads at the
//     same address (two 16-byte broadcasts, no bank conflicts);
//   - the pupil axis is also split across blocks (gridDim.y chunks of
//     `chunk` samples), so that the PSF's 16384 image points, and the
//     normalizing peak's single one, fill the card's 132 SMs: each block
//     writes one partial (re, im) row per image point to a (chunks, 2, I)
//     buffer. The wrapper sums the partials in a fixed order (torch.sum
//     over the chunk axis, no atomics: two launches agree bit for bit) and
//     only then squares.
// Dead image points and samples are masked by index; nothing is padded.
//
// Bound on an H100: FP32 operations. Each contribution is 29 operations as
// chip_smoke.py:huygens_ops_per_contribution counts the function (2.68e8
// contributions at the PSF's 128 x 128 defaults: 0.12 ms at 67 TFLOP/s),
// against (3 I + 5 P + 2 I chunks) floats of traffic, ~0.5 MB. The pupil
// (320 KB) lives in L2 and the sum is no matrix product, so TMA and wgmma
// do not help: the levers are the FP32 pipe and the special-function unit.
// This body issues ~24 FP32-pipe instructions and 4 special-function ones
// (rsqrt, reciprocal, sin, cos) a contribution, with no IEEE square root,
// division or accurate sincos, and rounds the phase less than the float32
// reference does (huygens.cuh). Of 128 to 512 threads of 1 to 8 image
// points each, 256 threads of 4 timed fastest on an H100 (PERF.md):
// 64 registers, four blocks an SM.
#include <cuda_runtime.h>

#include "huygens.cuh"

namespace {

constexpr int THREADS = 256;   // threads per block
constexpr int NPT = 4;         // image points per thread
constexpr int BLOCK_I = THREADS * NPT;  // image points per block
constexpr int TILE_P = 128;    // pupil samples staged per tile

__global__ void __launch_bounds__(THREADS)
huygens_sum_kernel(int I, int P, int chunk, float inv_lambda, float inv_lambda_lo,
                   const float* __restrict__ Rp_ptr, const float* __restrict__ ix,
                   const float* __restrict__ iy, const float* __restrict__ iz,
                   const float* __restrict__ ux, const float* __restrict__ uy,
                   const float* __restrict__ uz, const float* __restrict__ amp,
                   const float* __restrict__ opd, float* __restrict__ partial) {
  __shared__ float4 s_a[TILE_P], s_b[TILE_P];
  const otk::HuygensConsts h = otk::huygens_consts(*Rp_ptr, inv_lambda, inv_lambda_lo);
  float x[NPT], y[NPT], zR[NPT], re[NPT], im[NPT];
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int i = blockIdx.x * BLOCK_I + q * THREADS + threadIdx.x;
    const bool live = i < I;
    x[q] = live ? ix[i] : 0.0f;
    y[q] = live ? iy[i] : 0.0f;
    zR[q] = (live ? iz[i] : 0.0f) - h.Rp;
    re[q] = 0.0f;
    im[q] = 0.0f;
  }
  const int p0 = blockIdx.y * chunk;
  const int p1 = min(P, p0 + chunk);
  for (int t = p0; t < p1; t += TILE_P) {
    const int n = min(TILE_P, p1 - t);
    for (int j = threadIdx.x; j < n; j += THREADS)
      otk::stage_sample(ux[t + j], uy[t + j], uz[t + j], amp[t + j], opd[t + j], h, s_a[j],
                        s_b[j]);
    __syncthreads();
    otk::huygens_accumulate(x, y, zR, s_a, s_b, n, h, re, im);
    __syncthreads();
  }
  float* row = partial + (size_t)blockIdx.y * 2 * I;
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int i = blockIdx.x * BLOCK_I + q * THREADS + threadIdx.x;
    if (i < I) {
      row[i] = re[q];
      row[I + i] = im[q];
    }
  }
}

}  // namespace

// Launch K8 on `stream`: I image points (ix, iy, iz), P pupil samples (ux,
// uy, uz, amp, opd), all float32, 1 / wavelength_mm as the float pair
// inv_lambda + inv_lambda_lo, Rp a pointer to one float32 on the device,
// and the (ceil(P / chunk), 2, I) partial buffer. `chunk` is a multiple of
// TILE_P. Returns cudaGetLastError().
extern "C" int huygens_sum(int I, int P, int chunk, float inv_lambda, float inv_lambda_lo,
                           const void* Rp, const void* ix, const void* iy, const void* iz,
                           const void* ux, const void* uy, const void* uz, const void* amp,
                           const void* opd, void* partial, void* stream) {
  if (chunk < 1 || chunk % TILE_P != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((I + BLOCK_I - 1) / BLOCK_I, (P + chunk - 1) / chunk);
  huygens_sum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      I, P, chunk, inv_lambda, inv_lambda_lo, static_cast<const float*>(Rp),
      static_cast<const float*>(ix), static_cast<const float*>(iy),
      static_cast<const float*>(iz),
      static_cast<const float*>(ux), static_cast<const float*>(uy),
      static_cast<const float*>(uz), static_cast<const float*>(amp),
      static_cast<const float*>(opd), static_cast<float*>(partial));
  return static_cast<int>(cudaGetLastError());
}
