// T1: the peak-rate chains of tools/vpu_peak.py, one element per thread
// (Hopper, sm_90a).
//
// Replaces the Pallas kernels of `run` in tools/vpu_peak.py (`fma_kernel`,
// `sqrt_kernel`, `tan_kernel`, launched by its pl.pallas_call over a grid
// of (256, 128) tiles). Each thread reads one float32, runs the chain in
// registers for `steps` steps (T1's counts, 512 and 64, when timed; one or
// two when held to the plain versions, before the chains settle) and
// writes one float32:
//   fma:   x = x * 0.51, acc = x, then acc = fmaf(acc, x, 0.003) 512 times
//          (a degree-512 polynomial in x: no strength reduction, every
//          step one dependent FMA);
//   rsqrt: acc = rsqrtf(acc + 1.5) 64 times;
//   tan:   acc = tanf(acc * 0.001) 64 times.
// IEEE mode, as the rest of csrc/ is built (no --use_fast_math): rsqrtf is
// the hardware reciprocal square root and tanf the accurate libdevice tan,
// as the compiler emits them, which is what the chains measure.
//
// Bound on an H100: the FMA chain by FP32 operations, 2 x 512 FLOP per
// element (plus the first multiply) against the data sheet's 67 TFLOP/s at
// 700 W, 32 us for the 2,097,152 elements of T1's input, above the 5 us
// its 16.8 MB of input and output take at 3.35 TB/s; the rsqrt and tan
// chains count 128 operations an element, so bytes bound them (each
// rsqrtf and tanf counts one operation, though the card spends many
// instructions or a special-function unit slot on it). Every dependent
// step waits for the one before it; the card hides that latency with the
// other warps resident on the SM, so one element per thread and a block of
// 256 threads give each SM many independent chains.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fma_chain_kernel(int n, int steps, const float* __restrict__ x,
                 float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float v = x[idx] * 0.51f;
  float acc = v;
#pragma unroll 16
  for (int k = 0; k < steps; ++k) acc = fmaf(acc, v, 0.003f);
  out[idx] = acc;
}

__global__ void __launch_bounds__(THREADS)
rsqrt_chain_kernel(int n, int steps, const float* __restrict__ x,
                   float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = x[idx];
#pragma unroll 16
  for (int k = 0; k < steps; ++k) acc = rsqrtf(acc + 1.5f);
  out[idx] = acc;
}

__global__ void __launch_bounds__(THREADS)
tan_chain_kernel(int n, int steps, const float* __restrict__ x,
                 float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = x[idx];
#pragma unroll 4
  for (int k = 0; k < steps; ++k) acc = tanf(acc * 0.001f);
  out[idx] = acc;
}

template <class Kernel>
int launch(Kernel kernel, int n, int steps, const void* x, void* out, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, steps, static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one chain of `steps` steps on `stream` over the n float32 of x
// into out; each returns cudaGetLastError().
extern "C" int fma_chain(int n, int steps, const void* x, void* out, void* stream) {
  return launch(fma_chain_kernel, n, steps, x, out, stream);
}

extern "C" int rsqrt_chain(int n, int steps, const void* x, void* out, void* stream) {
  return launch(rsqrt_chain_kernel, n, steps, x, out, stream);
}

extern "C" int tan_chain(int n, int steps, const void* x, void* out, void* stream) {
  return launch(tan_chain_kernel, n, steps, x, out, stream);
}
