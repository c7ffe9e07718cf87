// K8: the Huygens-Fresnel PSF summation (Hopper, sm_90a).
//
// Replaces the Pallas kernel `huygens_sum_pallas` of
// optiland_tpu/psf/huygens.py (body `_huygens_kernel`): for each of I image
// points the complex field summed over P pupil samples (huygens.cuh). On the
// TPU one program holds a 512 x 512 (image x pupil) tile and the sequential
// grid axis accumulates over the pupil in the output block. Here it is the
// N-body pattern instead:
//   - one image point per thread, its (re, im) sums in registers;
//   - the block stages the pupil through shared memory in tiles of TILE_P
//     samples (5 arrays), which every thread then reads at the same address
//     (a broadcast, no bank conflicts);
//   - the pupil axis is also split across blocks (gridDim.y chunks of
//     `chunk` samples), so that the PSF's 16384 image points fill the card's
//     132 SMs: each block writes one partial (re, im) row per image point to
//     a (chunks, 2, I) buffer. The wrapper sums the partials in a fixed order
//     (torch.sum over the chunk axis, no atomics: two launches agree bit for
//     bit) and only then squares.
// Dead lanes are masked by index; nothing is padded.
//
// Bound on an H100: FP32 operations. Each contribution is 29 operations as
// chip_smoke.py:huygens_ops_per_contribution counts them (2.68e8
// contributions at the PSF's 128 x 128 defaults: 0.12 ms at 67 TFLOP/s),
// against (3 I + 5 P + 2 I chunks) floats of traffic, ~0.5 MB. The counted
// sqrt, two divisions and sincos are each several instructions, which is
// where a simple kernel loses against that bound.
#include <cuda_runtime.h>

#include "huygens.cuh"

namespace {

constexpr int BLOCK_I = 128;  // threads per block, one image point each
constexpr int TILE_P = 256;   // pupil samples staged per tile

__global__ void __launch_bounds__(BLOCK_I)
huygens_sum_kernel(int I, int P, int chunk, float k, const float* __restrict__ Rp_ptr,
                   const float* __restrict__ ix, const float* __restrict__ iy,
                   const float* __restrict__ iz, const float* __restrict__ ux,
                   const float* __restrict__ uy, const float* __restrict__ uz,
                   const float* __restrict__ amp, const float* __restrict__ opd,
                   float* __restrict__ partial) {
  __shared__ float s_ux[TILE_P], s_uy[TILE_P], s_uz[TILE_P], s_amp[TILE_P], s_opd[TILE_P];
  const int i = blockIdx.x * BLOCK_I + threadIdx.x;
  const bool live = i < I;
  const float Rp = *Rp_ptr;
  const float x = live ? ix[i] : 0.0f;
  const float y = live ? iy[i] : 0.0f;
  const float z = live ? iz[i] : 0.0f;
  const int p0 = blockIdx.y * chunk;
  const int p1 = min(P, p0 + chunk);
  float re = 0.0f, im = 0.0f;
  for (int t = p0; t < p1; t += TILE_P) {
    const int n = min(TILE_P, p1 - t);
    for (int j = threadIdx.x; j < n; j += BLOCK_I) {
      s_ux[j] = ux[t + j];
      s_uy[j] = uy[t + j];
      s_uz[j] = uz[t + j];
      s_amp[j] = amp[t + j];
      s_opd[j] = opd[t + j];
    }
    __syncthreads();
    if (live) otk::huygens_accumulate(x, y, z, s_ux, s_uy, s_uz, s_amp, s_opd, n, k, Rp, re, im);
    __syncthreads();
  }
  if (live) {
    float* row = partial + (size_t)blockIdx.y * 2 * I;
    row[i] = re;
    row[I + i] = im;
  }
}

}  // namespace

// Launch K8 on `stream`: I image points (ix, iy, iz), P pupil samples (ux,
// uy, uz, amp, opd), all float32, k = 2 pi / wavelength_mm, Rp a pointer to
// one float32 on the device, and the (ceil(P / chunk), 2, I) partial buffer.
// `chunk` is a multiple of TILE_P. Returns cudaGetLastError().
extern "C" int huygens_sum(int I, int P, int chunk, float k, const void* Rp, const void* ix,
                           const void* iy, const void* iz, const void* ux, const void* uy,
                           const void* uz, const void* amp, const void* opd, void* partial,
                           void* stream) {
  const dim3 grid((I + BLOCK_I - 1) / BLOCK_I, (P + chunk - 1) / chunk);
  huygens_sum_kernel<<<grid, BLOCK_I, 0, static_cast<cudaStream_t>(stream)>>>(
      I, P, chunk, k, static_cast<const float*>(Rp), static_cast<const float*>(ix),
      static_cast<const float*>(iy), static_cast<const float*>(iz),
      static_cast<const float*>(ux), static_cast<const float*>(uy),
      static_cast<const float*>(uz), static_cast<const float*>(amp),
      static_cast<const float*>(opd), static_cast<float*>(partial));
  return static_cast<int>(cudaGetLastError());
}
