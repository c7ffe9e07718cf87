// K7: the surface chain of one system on rays the caller made, at each
// ray's own wavelength, writing every surface's state: the (S, n) history
// that `trace_system` returns (Hopper, sm_90a).
//
// Replaces the Pallas kernel `_history_forward` of
// optiland_tpu/trace/fused.py (its body is `_tile_trace(static, False, ...,
// record=True, for_grad=False)`): per-ray `material_index` from the
// material rows and Beer-Lambert absorption from the extinction tables.
// Row 0 of the history is the starting bundle. Built once per system like
// K1, K3 and K5 (system_chain.cuh; trace/fused.py `history_defines`: the
// system's codes and each medium's dispersion formula and coefficient
// count; _build.py `variant`, with IEEE division and square root: the
// stores, not the chain, set its time, PERF.md), each block staging the
// float table and the first MAT_SHARED columns of the material rows once,
// then walking tiles of SYSTEM_THREADS rays over the grid the wrapper
// shapes from `history_fwd_blocks_per_sm` (`fused.system_grid`). A
// tabulated glass's row and the extinction tables are read from global
// memory, where the lanes of a warp mostly read the same address.
//
// Bound on an H100: bytes. Each ray reads 36 bytes and writes 8 S floats
// (256 bytes on the 8-surface Cooke triplet): 584 MB at 2M rays, 0.174 ms
// at 3.35 TB/s. Each surface's 8 values leave as soon as the chain has
// computed them, and no thread keeps a record. Stored one float a thread,
// a warp's 32 stores to one array land on 128 contiguous bytes of one of
// 8 S row streams; on an H100 those stores alone took 0.368 ms at 2M rays
// (PERF.md, p0), more than the chain. Where the rows do not start on
// 32-byte sectors (n not a multiple of 8), each such store leaves a
// part-written sector at both ends, and where the history outgrows the L2
// cache those reach device memory so (`bulk`, the wrapper's choice,
// `fused.history_bulk`). There each full tile's 8 values of a surface go
// into the block's staging rows in shared memory (one row of 256 floats
// an array, two sets, alternating between surfaces) and one thread sends
// each row to global memory with one bulk copy (`cp.async.bulk`, 1 KB):
// only the tile's ends stay part-written. Elsewhere, and in a ragged last
// tile, each thread stores its own. Offsets are 64-bit (S n passes 2^31 at
// 268M rays on an 8-surface lens).
#include <cstdint>

#include "system_chain.cuh"

#ifndef OTK_MATERIALS
#error "history_fwd.cu needs the media's dispersion codes: OTK_MATERIALS"
#endif

namespace {

constexpr int THREADS = otk::SYSTEM_THREADS;
// a staging row: a tile's values of one array, placed at the offset of its
// row's misalignment so that the part copied starts on 16 bytes
constexpr int ROW = THREADS + 4;

struct Rays9 {
  const float* p[9];
};

struct History {
  float* p[8];
};

// Global row `dst` <- shared `src`, `bytes` of them (16-byte aligned both
// sides, a multiple of 16), in this thread's current bulk-copy group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))), "r"(bytes)
               : "memory");
}

// Writes the state after surface k to row k of the 8 history arrays, for
// the tile of rays t0 .. t0 + THREADS - 1. With `bulk` (a full tile of a
// bulk launch; every thread of the block calls it, surface by surface):
// row k of array q starts at word k n + t0, `mis` words past a 16-byte
// boundary; its `head` words up to the boundary and its words past the
// last whole 16 bytes are stored per thread, the rest staged at word
// `tid + mis` of a staging row and sent by thread 0. Before a set of rows
// is written again, thread 0 waits until the copies that read it (two
// surfaces back) have read it; the block barrier after it passes that on.
struct HistorySink {
  History h;
  size_t n, t0;
  float (*rows)[8][ROW];  // the block's two sets of staging rows
  int* step;              // the surfaces this block has staged
  bool bulk;
  __device__ __forceinline__ void operator()(int k, const otk::Ray& r) const {
    const float v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    const int tid = threadIdx.x;
    const size_t start = (size_t)k * n + t0;
    if (!bulk) {
#pragma unroll
      for (int q = 0; q < 8; ++q) h.p[q][start + tid] = v[q];
      return;
    }
    const int mis = static_cast<int>(start & 3);
    const int head = (4 - mis) & 3;
    const int body = (THREADS - head) & ~3;
    const int set = (*step)++ & 1;
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
    if (tid < head || tid >= head + body) {
#pragma unroll
      for (int q = 0; q < 8; ++q) h.p[q][start + tid] = v[q];
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) rows[set][q][tid + mis] = v[q];
    }
    // the staged words, written through the generic proxy, are read by
    // the bulk copy's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bulk_store(h.p[q] + start + head, &rows[set][q][head + mis], body * 4);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
};

__global__ void __launch_bounds__(THREADS)
history_fwd_kernel(int n, int bulk, int mat_w, int K, const float* __restrict__ ftab,
                   const float* __restrict__ mat, const float* __restrict__ kwl,
                   const float* __restrict__ kval, Rays9 rays, History hist) {
  __shared__ float s_ft[OTK_FT_FLOATS(OTK_S)];
  __shared__ float s_mat[OTK_S * otk::MAT_SHARED];
  __shared__ alignas(16) float rows[2][8][ROW];
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
  otk::stage_system(ftab, nullptr, s_ft, nullptr);

  int step = 0;
  for (int t0 = blockIdx.x * THREADS; t0 < n; t0 += gridDim.x * THREADS) {
    const int idx = t0 + threadIdx.x;
    if (idx >= n) break;  // the last tile, ragged: no later tile is full
    otk::Ray r = {rays.p[0][idx], rays.p[1][idx], rays.p[2][idx], rays.p[3][idx],
                  rays.p[4][idx], rays.p[5][idx], rays.p[6][idx], rays.p[7][idx]};
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, rays.p[8][idx]};
    const HistorySink sink = {hist, (size_t)n, (size_t)t0, rows, &step,
                              bulk && t0 + THREADS <= n};
    sink(0, r);
    otk::trace_system(s_ft, media, r, sink);
  }
  if (bulk && threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// K7 blocks that fit one SM at once (the occupancy of this build), or a
// negative CUDA error.
extern "C" int history_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, history_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launch K7 on `stream` over n rays of a system of S surfaces (this
// build's OTK_S, else cudaErrorInvalidValue) in `blocks` blocks, the full
// tiles' history by bulk copies where `bulk` is 1: mat is (S, mat_w), kwl
// and kval (S, K), the 9 ray arrays (x .. opd, w) (n,) and the 8 history
// arrays (S, n), all float32, the history 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int history_fwd(int n, int S, int blocks, int bulk, int mat_w, int K,
                           const void* ftab, const void* mat, const void* kwl,
                           const void* kval, const void* x, const void* y, const void* z,
                           const void* L, const void* M, const void* N, const void* i,
                           const void* opd, const void* w, void* hx, void* hy, void* hz,
                           void* hL, void* hM, void* hN, void* hi, void* hopd,
                           void* stream) {
  if (S != OTK_S || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const Rays9 rays = {{in(x), in(y), in(z), in(L), in(M), in(N), in(i), in(opd), in(w)}};
  const History hist = {{out(hx), out(hy), out(hz), out(hL), out(hM), out(hN), out(hi),
                         out(hopd)}};
  history_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, bulk, mat_w, K, in(ftab), in(mat), in(kwl), in(kval), rays, hist);
  return static_cast<int>(cudaGetLastError());
}
