"""The CUDA device code of the fused chain and of K8, compiled for the host.

`csrc/chain.cuh`, `csrc/chain_bwd.cuh`, `csrc/system_chain.cuh` and
`csrc/huygens.cuh` (and `csrc/freeform.cuh`) are C++ apart from CUDA
qualifiers and intrinsics. Built
by g++ in float64 with those defined away (one thread, one ray at a time),
the per-ray bodies of K2, K4 and K6 run here on the CPU: the run-time
forward chain (`trace_chain`, at one wavelength as the backward kernels
re-trace it), the reverse sweep (`reverse_chain`, with the absorption
adjoint, and the cotangent rows in their compact order and widths) and the
raygen adjoint (`tile_raygen_bwd`); so do the per-ray dispersion
(`material_index` for every formula code, run-time and compile-time, and
its adjoint `material_index_bwd` / `interp_bwd` against autograd) and the
extinction tables' interpolation (`kv_segment` bit for bit against
`kv_interp`), the per-ray variants' bodies (K1, K3 and K5 by the
per-system chain at each ray's w, K2, K4 and K6 by the per-ray sweep,
`trace_chain_w` and `reverse_chain_w`, with `mat_coeffs`' and w's
cotangents), K1's, K3's, K5's and K7's per-system bodies (`system_raygen`,
`trace_system` at one wavelength and at each ray's own with its history
recorded, `stage_system`), built with each of five systems' own codes, and
K8's per-image-point Huygens sum
(`huygens_accumulate`) over pupil chunks, whose partial fields go through
the wrapper's own reduction (`reduce_partials`). Each is held against the plain PyTorch version
that the kernel is held to on the card, in float64, at 1e-10 of each
cotangent group's largest entry: a check of the kernels' arithmetic that
needs no card. The warp's reduce-scatter (`WarpRows`) runs on 32 host
threads, one a lane, whose shuffles meet at a barrier. The shared-memory
staging, the persistent grid and the launch code run only on the card
(tests/test_torch_cuda.py). Skips without g++."""

import ctypes
import shutil
import subprocess
from dataclasses import replace

import numpy as np
import pytest
import torch

from optiland_tpu_torch import config
from optiland_tpu_torch.materials import catalog
from optiland_tpu_torch.materials.dispersion import material_index
from optiland_tpu_torch.models import CookeTriplet
from optiland_tpu_torch.system.optic import Optic
from optiland_tpu_torch.trace import fused
from optiland_tpu_torch.trace.raygen import generate_rays

from torch_port_helpers import (
    K0_055,
    PHASE_PROFILES,
    SMOKE,
    bench_lens,
    coated_cooke,
    coated_singlet,
    curved_grating,
    curved_metalens,
    hybrid_achromat,
    phase_mirror,
    phase_sheet,
    plane_grating,
    singlet_lens,
    tabulated_doublet,
    thin_lens_system,
)

CSRC = fused.__file__.rsplit("/", 2)[0] + "/csrc"
RTOL = 1e-10    # of each group's largest entry; float64 on both sides
N_RAYS = 64

# One thread's body of each kernel, looped over the rays; WarpRows becomes
# a plain sum over rays into the (rows, 32) table, in the table's layout.
_PRELUDE = r"""
#include <cmath>
#include <limits>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#define float double
#define rsqrtf(x) (1.0 / std::sqrt(x))
#define sqrtf std::sqrt
#define fmaxf std::fmax
#define fabsf std::fabs
#define tanf std::tan
#define cosf std::cos
#define sinf std::sin
#define powf std::pow
#define expf std::exp
#define logf std::log
#define sincosf host_sincos
#define __sincosf host_sincos
#define __fdividef(a, b) ((a) / (b))
#define fmaf std::fma
inline void host_sincos(double x, double* s, double* c) {
  *s = std::sin(x);
  *c = std::cos(x);
}
struct float4 { double x, y, z, w; };
inline float4 make_float4(double x, double y, double z, double w) { return {x, y, z, w}; }
struct Dim3 { int x; };
static thread_local Dim3 threadIdx = {0};
static Dim3 blockDim = {1};
inline void __syncthreads() {}
// a warp's shuffle on 32 host threads (threadIdx.x the lane): each lane
// posts its value, all meet, each reads its partner's, all meet again
struct LaneBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const int g = gen;
    if (++count == 32) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
};
static LaneBarrier lane_barrier;
static double lane_post[32];
inline double __shfl_xor_sync(unsigned, double v, int o) {
  const int lane = threadIdx.x & 31;
  lane_post[lane] = v;
  lane_barrier.wait();
  const double r = lane_post[lane ^ o];
  lane_barrier.wait();
  return r;
}
"""

_SHIM = _PRELUDE + r"""
#include "chain_bwd.cuh"
#include "huygens.cuh"

struct Rows {
  double* out;
#ifdef OTK_WIDE
  int xbase;  // the first wide row
#endif
  void put(int row, const double (&v)[otk::F_STRIDE], int width) const {
    for (int c = 0; c < width; ++c) out[row * otk::F_STRIDE + otk::table_slot(c)] += v[c];
  }
};
// the rows of a table whose wide rows (OTK_WIDE) start at row xbase
inline Rows table_rows(double* tab, int xbase) {
#ifdef OTK_WIDE
  return Rows{tab, xbase};
#else
  (void)xbase;
  return Rows{tab};
#endif
}
static double rec[otk::MAX_SURFACES][otk::REC];
static double pos[otk::MAX_SURFACES], npre[otk::MAX_SURFACES];

// the 32 lanes' rows v (32, F_STRIDE) through WarpRows::put at `width`,
// one host thread a lane, into `row` (F_STRIDE, compact order)
extern "C" void warp_rows_lanes(int width, const double* v, double* row) {
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; ++l)
    lanes.emplace_back([=] {
      threadIdx.x = l;
      double x[otk::F_STRIDE];
      for (int j = 0; j < otk::F_STRIDE; ++j) x[j] = v[l * otk::F_STRIDE + j];
      otk::WarpRows{row}.put(0, x, width);
    });
  for (auto& t : lanes) t.join();
}

// mode 0: K1 moments (out4), 1: K2 with c, 2: K4 with seeds (8, n)
extern "C" void raygen_kernels(int mode, int n, int S, int nn, int fa, int oi,
                               const double* rg, const double* ft, const int* it,
                               const double* Hx, const double* Hy, const double* Px,
                               const double* Py, const double* c, const double* seeds,
                               double* out4, double* tab, double* dd) {
  for (int q = 0; q < 4; ++q) out4[q] = 0;
  otk::surface_frames(S, ft, it, pos, npre);
  for (int idx = 0; idx < n; ++idx) {
    otk::Ray r = otk::tile_raygen(fa, oi, rg, Hx[idx], Hy[idx], Px[idx], Py[idx]);
    otk::trace_chain(S, nn, ft, it, r, rec);
    if (mode == 0) {
      out4[0] += r.i;
      out4[1] += r.x * r.i;
      out4[2] += r.y * r.i;
      out4[3] += (r.x * r.x + r.y * r.y) * r.i;
      continue;
    }
    otk::Vec6 g = {0, 0, 0, 0, 0, 0};
    double g_opd = 0, g_ip, g_i;
    if (mode == 1) {
      g.x = r.i * (c[1] + 2 * c[3] * r.x);
      g.y = r.i * (c[2] + 2 * c[3] * r.y);
      g_i = c[0] + c[1] * r.x + c[2] * r.y + c[3] * (r.x * r.x + r.y * r.y);
      g_ip = r.i * g_i;
    } else {
      g = otk::Vec6{seeds[idx], seeds[n + idx], seeds[2 * n + idx],
                    seeds[3 * n + idx], seeds[4 * n + idx], seeds[5 * n + idx]};
      g_opd = seeds[7 * n + idx];
      g_i = seeds[6 * n + idx];
      g_ip = g_i * r.i;
    }
    const Rows rows = table_rows(tab, S + 1);
    otk::reverse_chain(S, ft, it, pos, npre, rec, true, g_opd, g_ip, g, rows, g_i);
    double drg[5];
    double d4[4];
    otk::tile_raygen_bwd(fa, oi, rg, Hx[idx], Hy[idx], Px[idx], Py[idx], g, drg, d4);
    otk::put_raygen_row(rows, S, drg);
    for (int q = 0; q < 4; ++q) dd[q * n + idx] = d4[q];
  }
}

// mode 0: K5 (outs (8, n)), 1: K6 with seeds (8, n) (outs: the cotangents)
extern "C" void caller_kernels(int mode, int n, int S, int nn, const double* ft,
                               const int* it, const double* rays, const double* seeds,
                               double* tab, double* outs) {
  otk::surface_frames(S, ft, it, pos, npre);
  for (int idx = 0; idx < n; ++idx) {
    const double* p = rays + idx;
    otk::Ray r = {p[0], p[n], p[2 * n], p[3 * n], p[4 * n], p[5 * n],
                  mode == 0 ? p[6 * n] : 1.0, p[7 * n]};
    otk::trace_chain(S, nn, ft, it, r, rec);
    double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    if (mode == 1) {
      const double* s = seeds + idx;
      otk::Vec6 g = {s[0], s[n], s[2 * n], s[3 * n], s[4 * n], s[5 * n]};
      otk::reverse_chain(S, ft, it, pos, npre, rec, true, s[7 * n],
                         s[6 * n] * p[6 * n] * r.i, g, table_rows(tab, S), s[6 * n] * p[6 * n]);
      const double dv[8] = {g.x, g.y, g.z, g.L, g.M, g.N, s[6 * n] * r.i, s[7 * n]};
      for (int k = 0; k < 8; ++k) v[k] = dv[k];
    }
    for (int k = 0; k < 8; ++k) outs[k * n + idx] = v[k];
  }
}

// K8: image (3, I), pupil (5, P) -> the (chunks, 2, I) partial fields of
// pupil chunks of `chunk` samples, as the kernel's blocks write them: each
// chunk's samples staged (stage_sample), then summed per image point
extern "C" void huygens_kernel(int I, int P, int chunk, double inv_lambda, double Rp,
                               const double* img, const double* pup, double* partial) {
  const otk::HuygensConsts h = otk::huygens_consts(Rp, inv_lambda, 0.0);
  std::vector<float4> a(P), b(P);
  for (int j = 0; j < P; ++j)
    otk::stage_sample(pup[j], pup[P + j], pup[2 * P + j], pup[3 * P + j], pup[4 * P + j], h,
                      a[j], b[j]);
  for (int c = 0; c * chunk < P; ++c) {
    const int p0 = c * chunk, n = P - p0 < chunk ? P - p0 : chunk;
    for (int i = 0; i < I; ++i) {
      double x[1] = {img[i]}, y[1] = {img[I + i]}, zR[1] = {img[2 * I + i] - Rp};
      double re[1] = {0}, im[1] = {0};
      otk::huygens_accumulate(x, y, zR, a.data() + p0, b.data() + p0, n, h, re, im);
      partial[2 * c * I + i] = re[0];
      partial[(2 * c + 1) * I + i] = im[0];
    }
  }
}

#ifdef OTK_FREEFORM
// (sag, d sag / dx, d sag / dy) of a freeform surface (code, nc coefficient
// slots co, aux ints a0, a1, cv, k) at n points, into out (3, n)
extern "C" void ff_sag_points(int code, int nc, int a0, int a1, double cv, double k,
                              const double* co, int n, const double* x, const double* y,
                              double* out) {
  otk::Surface s{};
  s.code = code;
  s.nc = nc;
  s.a0 = a0;
  s.a1 = a1;
  s.cv = cv;
  s.kk = 1 + k;
  s.k = k;
  s.co = co;
  for (int j = 0; j < n; ++j) otk::ff_sag_grad(s, x[j], y[j], out[j], out[n + j], out[2 * n + j]);
}
#endif

// material_index of one material row at each of n wavelengths
extern "C" void index_kernel(int formula, int nc, const double* row, int n, const double* w,
                             double* out) {
  for (int j = 0; j < n; ++j) out[j] = otk::material_index(formula, nc, row, row, w[j]);
}

// the (K,) extinction table at each of n wavelengths: kv_interp (mode 0)
// or kv_segment (1)
extern "C" void kv_kernel(int mode, int n, const double* w, int K, const double* kwl,
                          const double* kval, double* out) {
  for (int j = 0; j < n; ++j)
    out[j] = mode ? otk::kv_segment(w[j], kwl, kval, K) : otk::kv_interp(w[j], kwl, kval, K);
}
"""

# the compile-time material_index of formula {code} with {nc} coefficients,
# and its adjoint at each of n wavelengths against the cotangents dn: the
# coefficients' summed over the points (dc, the row's width; a tabulated
# row's 4 entries of each point's segment, interp_bwd's), w's per point
_INDEX_CT = r"""
extern "C" void index_ct_{code}(const double* row, int n, const double* w, double* out) {{
  for (int j = 0; j < n; ++j)
    out[j] = otk::material_index<{code}, {nc}>(row, row, w[j]);
}}

extern "C" void index_bwd_ct_{code}(const double* row, int n, const double* w,
                                    const double* dn, double* dc, double* dw) {{
  for (int j = 0; j < n; ++j) {{
    dw[j] = 0;
    if constexpr ({code} == otk::FORMULA_TABULATED) {{
      const int K = {nc} / 2;
      int seg;
      double v[4];
      otk::interp_bwd(w[j], row, row + K, K, dn[j], seg, v, dw[j]);
      const int i0 = seg > 0 ? seg - 1 : 0;
      dc[i0] += v[0];
      dc[seg] += v[1];
      dc[K + i0] += v[2];
      dc[K + seg] += v[3];
    }} else {{
      otk::material_index_bwd<{code}, {nc}>(row, w[j], dn[j], dc, dw[j]);
    }}
  }}
}}
"""

# The per-system bodies over n rays: K1's moments (out4) and each ray's
# final state (rays (8, n)); K3's outputs of out_mask (outs (8, n), the
# others untouched); K5's 8 outputs from the caller's rays (8, n); with
# K7's definitions, its history (8, S, n) of the caller's rays (9, n) at
# their own wavelengths. K3, K5 and K7 read the tables through
# `stage_system`, as on the card.
_SYSTEM_SHIM = r"""
#include "system_chain.cuh"
#include "chain_bwd.cuh"

static double s_ft[OTK_FT_FLOATS(OTK_S)], s_rg[5];

extern "C" void system_moments(int n, const double* rg, const double* ft, const double* Hx,
                               const double* Hy, const double* Px, const double* Py,
                               double* out4, double* rays) {
  for (int q = 0; q < 4; ++q) out4[q] = 0;
  for (int idx = 0; idx < n; ++idx) {
    otk::Ray r = otk::system_raygen(rg, Hx[idx], Hy[idx], Px[idx], Py[idx]);
    otk::trace_system(ft, r);
    out4[0] += r.i;
    out4[1] += r.x * r.i;
    out4[2] += r.y * r.i;
    out4[3] += (r.x * r.x + r.y * r.y) * r.i;
    const double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    for (int k = 0; k < 8; ++k) rays[k * n + idx] = v[k];
  }
}

extern "C" void system_raygen_trace(int n, int out_mask, const double* rg, const double* ft,
                                    const double* Hx, const double* Hy, const double* Px,
                                    const double* Py, double* outs) {
  otk::stage_system(ft, rg, s_ft, s_rg);
  for (int idx = 0; idx < n; ++idx) {
    otk::Ray r = otk::system_raygen(s_rg, Hx[idx], Hy[idx], Px[idx], Py[idx]);
    otk::trace_system(s_ft, r);
    const double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    for (int k = 0; k < 8; ++k)
      if (out_mask & (1 << k)) outs[k * n + idx] = v[k];
  }
}

extern "C" void system_caller_trace(int n, const double* ft, const double* rays,
                                    double* outs) {
  otk::stage_system(ft, nullptr, s_ft, nullptr);
  for (int idx = 0; idx < n; ++idx) {
    const double* p = rays + idx;
    otk::Ray r = {p[0], p[n], p[2 * n], p[3 * n], p[4 * n], p[5 * n], p[6 * n], p[7 * n]};
    otk::trace_system(s_ft, r);
    const double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    for (int k = 0; k < 8; ++k) outs[k * n + idx] = v[k];
  }
}

#ifdef OTK_MATERIALS
struct HostSink {
  double* h;
  int n, idx;
  void operator()(int k, const otk::Ray& r) const {
    const double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
    for (int q = 0; q < 8; ++q) h[((long)q * OTK_S + k) * n + idx] = v[q];
  }
};
static double s_mat[OTK_S * otk::MAT_SHARED];

extern "C" void system_history(int n, int mat_w, int K, const double* ft, const double* mat,
                               const double* kwl, const double* kval, const double* rays,
                               double* hist) {
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
  otk::stage_system(ft, nullptr, s_ft, nullptr);
  for (int idx = 0; idx < n; ++idx) {
    const double* p = rays + idx;
    otk::Ray r = {p[0], p[n], p[2 * n], p[3 * n], p[4 * n], p[5 * n], p[6 * n], p[7 * n]};
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, p[8 * n]};
    const HostSink sink = {hist, n, idx};
    sink(0, r);
    otk::trace_system(s_ft, media, r, sink);
  }
}

// The per-ray variants' bodies: K1 (mode 0: the moments and each ray's
// final state, rays (8, n), by the per-system chain at w) and K2 and K4
// (modes 1 and 2, the run-time chain's per-ray sweep: table, raygen and
// material rows (2 S + 1, 32), the data cotangents dd (5, n), w's the
// 5th, the tabulated glasses' seg (T, n) and val (T, 4, n)); K5 (mode 0:
// the final state of the caller's rays (9, n)) and K6 (mode 1: rows (2 S,
// 32), the 9 ray cotangents in outs).
struct RowsW {
  double* out;
#ifdef OTK_WIDE
  int xbase;
#endif
  void put(int row, const double (&v)[otk::F_STRIDE], int width) const {
    for (int c = 0; c < width; ++c) out[row * otk::F_STRIDE + otk::table_slot(c)] += v[c];
  }
};
static double rec_w[otk::MEDIA][otk::REC_W], pos_w[otk::MEDIA], npre_w[otk::MEDIA];

extern "C" void raygen_kernels_w(int mode, int n, int nn, int mat_w, int K, const double* rg,
                                 const double* ft, const int* it, const double* mat,
                                 const double* kwl, const double* kval, const double* Hx,
                                 const double* Hy, const double* Px, const double* Py,
                                 const double* w, const double* c, const double* seeds,
                                 double* out4, double* rays, double* tab, double* dd,
                                 int* seg, double* val) {
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
  otk::surface_frames(OTK_S, ft, it, pos_w, npre_w);
  for (int q = 0; q < 4; ++q) out4[q] = 0;
  for (int idx = 0; idx < n; ++idx) {
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, w[idx]};
    otk::Ray r = otk::system_raygen(rg, Hx[idx], Hy[idx], Px[idx], Py[idx]);
    if (mode == 0) {
      otk::trace_system(ft, media, r, otk::NoSink());
      out4[0] += r.i;
      out4[1] += r.x * r.i;
      out4[2] += r.y * r.i;
      out4[3] += (r.x * r.x + r.y * r.y) * r.i;
      const double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
      for (int k = 0; k < 8; ++k) rays[k * n + idx] = v[k];
      continue;
    }
    otk::trace_chain_w(OTK_S, nn, ft, it, media, r, rec_w);
    otk::Vec6 g = {0, 0, 0, 0, 0, 0};
    double g_opd = 0, g_ip, g_i;
    if (mode == 1) {
      g.x = r.i * (c[1] + 2 * c[3] * r.x);
      g.y = r.i * (c[2] + 2 * c[3] * r.y);
      g_i = c[0] + c[1] * r.x + c[2] * r.y + c[3] * (r.x * r.x + r.y * r.y);
      g_ip = r.i * g_i;
    } else {
      g = otk::Vec6{seeds[idx], seeds[n + idx], seeds[2 * n + idx],
                    seeds[3 * n + idx], seeds[4 * n + idx], seeds[5 * n + idx]};
      g_opd = seeds[7 * n + idx];
      g_i = seeds[6 * n + idx];
      g_ip = g_i * r.i;
    }
#ifdef OTK_WIDE
    const RowsW rows{tab, 2 * OTK_S + 1};
#else
    const RowsW rows{tab};
#endif
    double d_w;
    otk::reverse_chain_w(OTK_S, ft, it, pos_w, media, rec_w, true, g_opd, g_ip, g, rows,
                         OTK_S + 1, otk::TabulatedOut{seg, val, (size_t)n, idx}, d_w, g_i);
    double drg[5], d4[4];
    otk::tile_raygen_bwd(OTK_FIELD_ANGLE, OTK_OBJECT_INFINITE, rg, Hx[idx], Hy[idx], Px[idx],
                         Py[idx], g, drg, d4);
    otk::put_raygen_row(rows, OTK_S, drg);
    for (int q = 0; q < 4; ++q) dd[q * n + idx] = d4[q];
    dd[4 * n + idx] = d_w;
  }
}

extern "C" void caller_kernels_w(int mode, int n, int nn, int mat_w, int K, const double* ft,
                                 const int* it, const double* mat, const double* kwl,
                                 const double* kval, const double* rays, const double* seeds,
                                 double* tab, double* outs, int* seg, double* val) {
  otk::stage_materials(OTK_S, mat_w, mat, s_mat);
  otk::surface_frames(OTK_S, ft, it, pos_w, npre_w);
  for (int idx = 0; idx < n; ++idx) {
    const double* p = rays + idx;
    const otk::RayMedia media = {mat, s_mat, kwl, kval, mat_w, K, p[8 * n]};
    otk::Ray r = {p[0], p[n], p[2 * n], p[3 * n], p[4 * n], p[5 * n],
                  mode == 0 ? p[6 * n] : 1.0, p[7 * n]};
    if (mode == 0) {
      otk::trace_system(ft, media, r, otk::NoSink());
      const double v[8] = {r.x, r.y, r.z, r.L, r.M, r.N, r.i, r.opd};
      for (int k = 0; k < 8; ++k) outs[k * n + idx] = v[k];
      continue;
    }
    otk::trace_chain_w(OTK_S, nn, ft, it, media, r, rec_w);
    const double* s = seeds + idx;
    otk::Vec6 g = {s[0], s[n], s[2 * n], s[3 * n], s[4 * n], s[5 * n]};
    double d_w;
#ifdef OTK_WIDE
    const RowsW rows{tab, 2 * OTK_S};
#else
    const RowsW rows{tab};
#endif
    otk::reverse_chain_w(OTK_S, ft, it, pos_w, media, rec_w, true, s[7 * n],
                         s[6 * n] * p[6 * n] * r.i, g, rows, OTK_S,
                         otk::TabulatedOut{seg, val, (size_t)n, idx}, d_w,
                         s[6 * n] * p[6 * n]);
    const double dv[9] = {g.x, g.y, g.z, g.L, g.M, g.N, s[6 * n] * r.i, s[7 * n], d_w};
    for (int k = 0; k < 9; ++k) outs[k * n + idx] = dv[k];
  }
}
#endif
"""

_SYSTEMS = {
    "singlet": lambda O: singlet_lens(O),
    "tilt_decenter_aperture": lambda O: singlet_lens(
        O, tilt=True, decenter=True, aperture=4.5),
    "odd_asphere_mirror": lambda O: singlet_lens(O, mirror=True, odd=True),
    "conic_object_height": lambda O: singlet_lens(
        O, asphere=False, field_type="object_height", object_distance=100.0),
    "angle_finite_object": lambda O: singlet_lens(O, object_distance=200.0),
    "bench": bench_lens,
    # absorbing glasses at one wavelength: K1, K2, K4-K6 with the uniform
    # absorption factor and its adjoint
    "cooke": lambda O: CookeTriplet(),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the device code for the host")
    out = tmp_path_factory.mktemp("chain_host")
    (out / "cuda_runtime.h").write_text("#pragma once\n")
    (out / "shim.cpp").write_text(_SHIM + "".join(
        _INDEX_CT.format(code=code, nc=spec.n_coeffs)
        for code, (spec, _) in _index_cases().items()))
    lib = out / "libchainhost.so"
    build = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                            "-pthread",
                            f"-I{out}", f"-I{CSRC}", "-o", str(lib),
                            str(out / "shim.cpp")],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture
def f64():
    prev = config.get_dtype()
    config.set_precision("float64")
    yield
    config.set_precision("float64" if prev == torch.float64 else "float32")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _np(t):
    return np.ascontiguousarray(t.detach().numpy())


def _close(got, ref, label):
    got, ref = np.asarray(got), _np(ref) if torch.is_tensor(ref) else ref
    assert got.shape == ref.shape, label
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=RTOL,
                               err_msg=label)


_GROUP_NAMES = ("cv", "conic", "coeffs", "thickness", "tilt", "decenter",
                "mat_coeffs", "coating_params", "n_table", "grating",
                "phase_params", "focal_length")


def _wide_rows(ts):
    """The wide rows of a system's backward tables (`fused._wide_layout`)."""
    lay = fused._wide_layout(ts)
    return lay[4] if lay else 0


def _close_params(ts, tab, diffp, ref_diff, wide=None):
    got = fused._unpack_table_grads(
        ts, torch.from_numpy(tab), diffp,
        wide=None if wide is None else torch.from_numpy(wide))
    for name, g, r in zip(_GROUP_NAMES, got, ref_diff):
        _close(_np(g), r, name)


@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_device_code_matches_plain(host_lib, f64, name):
    ts, tp = _SYSTEMS[name](Optic).build(device="cpu")
    if name != "bench":
        ts = replace(ts, newton_iters=4)
    _check_run_time_bodies(host_lib, ts, tp,
                           0.5876 if name == "bench" else 0.55)


def _check_run_time_bodies(host_lib, ts, tp, w, axial_ray=False):
    """The run-time chain's bodies at one wavelength w (K1's moments, K2,
    K4, K5 and K6 on the raygen's rays with a caller's intensity and opd)
    against the plain versions; returns K2's and K6's table cotangents.
    With `axial_ray`, the first ray starts on axis at the pupil's centre
    (Hx = Hy = Px = Py = 0)."""
    diffp, nondiffp = fused._uniform_params(ts, tp, w)
    rg = fused._raygen_scalars(ts, tp)
    ftab, itab = fused._pack_tables(ts, diffp, nondiffp, False)
    ftab, itab, rg_np = _np(ftab), _np(itab), _np(rg)
    S, E = ts.num_surfaces, _wide_rows(ts)
    head = [S, min(ts.newton_iters, fused._NEWTON_FUSED_MAX)]
    rng = np.random.default_rng(5)
    n = N_RAYS
    data_np = [np.ascontiguousarray(a) for a in (
        *rng.uniform(-0.5, 0.5, (2, n)), *rng.uniform(-0.9, 0.9, (2, n)))]
    if axial_ray:
        for a in data_np:
            a[0] = 0.0
    data = tuple(torch.from_numpy(a) for a in data_np)
    seeds = np.ascontiguousarray(rng.normal(size=(8, n)))

    def raygen_kernel(mode, c=None, s=None):
        out4, tab, dd = np.zeros(4), np.zeros((S + 1 + E, 32)), np.zeros((4, n))
        c = np.zeros(4) if c is None else c
        s = np.zeros((8, n)) if s is None else s
        host_lib.raygen_kernels(
            mode, n, *head, int(ts.field_type == "angle"),
            int(ts.object_infinite), _ptr(rg_np), _ptr(ftab), _ptr(itab),
            *map(_ptr, data_np), _ptr(c), _ptr(s), _ptr(out4), _ptr(tab),
            _ptr(dd))
        return out4, tab, dd

    # K1
    m, _, _ = raygen_kernel(0)
    np.testing.assert_allclose(m, _np(fused._moments_plain(
        ts, diffp, nondiffp, rg, data)), rtol=1e-12)
    # K2
    c = np.array([0.3, -0.7, 0.5, 1.1])
    _, tab, dd = raygen_kernel(1, c=c)
    d_rg, d_diff, d_data = fused._moments_bwd_plain(
        ts, diffp, nondiffp, rg, data, torch.from_numpy(c), True)
    _close(tab[S, :5], d_rg, "K2 rg")
    _close_params(ts, tab[:S], diffp, d_diff, tab[S + 1:])
    k2_tab = tab.copy()
    for q in range(4):
        _close(dd[q], d_data[q], f"K2 data {q}")
    # K4, all eight seeds (the seed of i reaches nothing)
    _, tab, dd = raygen_kernel(2, s=seeds)
    d_rg, d_diff, d_data = fused._raygen_trace_bwd_plain(
        ts, diffp, nondiffp, rg, data, tuple(range(8)),
        tuple(torch.from_numpy(a) for a in seeds))
    _close(tab[S, :5], d_rg, "K4 rg")
    _close_params(ts, tab[:S], diffp, d_diff, tab[S + 1:])
    for q in range(4):
        _close(dd[q], d_data[q], f"K4 data {q}")

    # K5 and K6 on the raygen's rays with a caller's intensity and opd
    rays8 = [r.detach().expand(n).clone() for r in fused._tile_raygen(
        ts, rg, *data)[:6]]
    rays8 += [torch.from_numpy(rng.uniform(0.5, 1.0, n)),
              torch.from_numpy(rng.uniform(0.0, 1.0, n))]
    rays_np = np.ascontiguousarray(np.stack([_np(r) for r in rays8]))
    outs, tab = np.zeros((8, n)), np.zeros((S + E, 32))
    host_lib.caller_kernels(0, n, *head, _ptr(ftab), _ptr(itab),
                            _ptr(rays_np), _ptr(seeds), _ptr(tab), _ptr(outs))
    ref = fused._fused_trace_plain(ts, diffp, nondiffp, rays8)
    for k in range(8):
        np.testing.assert_allclose(outs[k], _np(ref[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=fused._NAMES[k])
    host_lib.caller_kernels(1, n, *head, _ptr(ftab), _ptr(itab),
                            _ptr(rays_np), _ptr(seeds), _ptr(tab), _ptr(outs))
    d_rays, d_diff = fused._fused_trace_bwd_plain(
        ts, diffp, nondiffp, rays8, tuple(torch.from_numpy(a) for a in seeds))
    for k in range(8):
        _close(outs[k], d_rays[k], f"K6 d{fused._NAMES[k]}")
    _close_params(ts, tab[:S], diffp, d_diff, tab[S:])
    return k2_tab, tab


def _index_cases():
    """One material per formula code 0-11 and wavelengths inside its
    range: catalog rows for the codes 1-9 (the first row of each), a short
    tabulated row for 10 (with wavelengths outside it and on its nodes),
    the Abbe model for 11."""
    rows = catalog._load_catalog()
    cases = {0: (catalog.resolve_material(1.5), np.linspace(0.4, 0.8, 5))}
    for code in range(1, 10):
        row = next(r for r in rows if r.get("formula") == code)
        cases[code] = (catalog._spec_from_row(row, row["n"]),
                       np.linspace(row["wmin"], row["wmax"], 7))
    cases[10] = (catalog.MaterialSpec(10, (0.4, 0.5, 0.6, 0.7, 1.53, 1.52,
                                           1.515, 1.51)),
                 np.array([0.3, 0.4, 0.45, 0.5, 0.65, 0.7, 0.8]))
    cases[11] = (catalog.abbe_material(1.5168, 64.17),
                 np.linspace(0.4, 0.8, 5))
    return cases


def _index_case(code):
    """The case of formula `code`: its material row and wavelengths as the
    host code reads them, and the plain version's indices."""
    spec, w = _index_cases()[code]
    assert spec.formula == code
    row = np.ascontiguousarray(spec.coefficients, dtype=np.float64)
    w = np.ascontiguousarray(w)
    ref = material_index(code, spec.n_coeffs, torch.from_numpy(row),
                         torch.from_numpy(w))
    return spec, row, w, _np(ref)


@pytest.mark.parametrize("code", range(12))
def test_material_index_matches_plain(host_lib, code):
    spec, row, w, ref = _index_case(code)
    got = np.zeros_like(w)
    host_lib.index_kernel(code, spec.n_coeffs, _ptr(row), len(w), _ptr(w),
                          _ptr(got))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("code", range(12))
def test_compile_time_material_index_matches_plain(host_lib, code):
    """K7's `material_index<F, NC>`, the formula and the coefficient count
    as template parameters, against the plain version at each formula."""
    _, row, w, ref = _index_case(code)
    got = np.zeros_like(w)
    getattr(host_lib, f"index_ct_{code}")(_ptr(row), len(w), _ptr(w),
                                          _ptr(got))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("code", range(12))
def test_material_index_bwd_matches_autograd(host_lib, code):
    """`material_index_bwd<F, NC>` (and `interp_bwd` for the tabulated
    formula, its cotangent on each point's segment) against autograd of
    the port's `material_index`: the coefficients' cotangents summed over
    the points and w's per point, under random cotangents dn. The
    tabulated case's points lie below its table, on its knots, inside its
    segments and above it."""
    spec, row, w, _ = _index_case(code)
    dn = np.random.default_rng(code).normal(size=len(w))
    c = torch.from_numpy(row.copy()).requires_grad_(True)
    wt = torch.from_numpy(w.copy()).requires_grad_(True)
    n = material_index(code, spec.n_coeffs, c, wt)
    ref_c, ref_w = torch.autograd.grad(n, (c, wt), torch.from_numpy(dn),
                                       allow_unused=True,
                                       materialize_grads=True)
    dc, dw = np.zeros(len(row)), np.zeros_like(w)
    getattr(host_lib, f"index_bwd_ct_{code}")(_ptr(row), len(w), _ptr(w),
                                              _ptr(dn), _ptr(dc), _ptr(dw))
    assert np.isfinite(dc).all() and np.isfinite(dw).all()
    _close(dc, ref_c, f"formula {code} coefficients")
    _close(dw, ref_w, f"formula {code} w")
    if code:   # the ideal index does not depend on w
        assert np.abs(dw).max() > 0


@pytest.mark.parametrize("K", [1, 5, 22])
def test_kv_segment_is_kv_interp(host_lib, K):
    """K7's extinction interpolation by its one segment (`kv_segment`) is
    bit for bit the masked sum (`kv_interp`, JAX's `_kv_interp`): on a
    (K,) table padded with its last point (zero-width segments), at every
    knot, beside each, inside the segments, below the first point and
    above the last."""
    rng = np.random.default_rng(K)
    n_pts = max(1, K - 2)
    kwl = np.sort(rng.uniform(0.4, 0.8, n_pts))
    kwl = np.ascontiguousarray(np.concatenate([kwl, np.full(K - n_pts,
                                                            kwl[-1])]))
    kval = rng.uniform(0.0, 3e-7, n_pts)
    kval = np.ascontiguousarray(np.concatenate([kval, np.full(K - n_pts,
                                                              kval[-1])]))
    w = np.ascontiguousarray(np.concatenate([
        kwl, rng.uniform(0.35, 0.85, 200), [0.3, 0.9],
        np.nextafter(kwl, 0.0), np.nextafter(kwl, 1.0)]))
    got = {}
    for mode in (0, 1):
        got[mode] = np.zeros_like(w)
        host_lib.kv_kernel(mode, len(w), _ptr(w), K, _ptr(kwl), _ptr(kval),
                           _ptr(got[mode]))
    assert np.array_equal(got[1], got[0])
    ref = fused._kv_interp(torch.from_numpy(w), torch.from_numpy(kwl),
                           torch.from_numpy(kval))
    assert np.array_equal(got[1], _np(ref))


@pytest.mark.parametrize("field", [(0.0, 0.0), (0.0, 1.0)])
def test_huygens_body_matches_plain(host_lib, f64, field):
    """K8's per-image-point body over 5 pupil chunks, the partials reduced
    by `reduce_partials` (summed, then squared), against
    `huygens_sum_plain` on the Cooke triplet's wavefront."""
    from optiland_tpu_torch.psf import huygens
    from optiland_tpu_torch.wavefront.core import (pupil_grid_coords,
                                                   wavefront_data)

    ts, tp = CookeTriplet().build(device="cpu")
    Px, Py, inside = pupil_grid_coords(24, torch.float64, "cpu")
    data = wavefront_data(ts, tp, *field, Px, Py, 0.55)
    amp = torch.sqrt(data.intensity) * inside
    opd_mm = data.opd * 0.55e-3
    c = data.center
    g = torch.linspace(-0.01, 0.01, 10, dtype=torch.float64)
    IX, IY = torch.meshgrid(g + c[0], g + c[1], indexing="xy")
    image = (IX, IY, torch.zeros_like(IX) + c[2])
    pupil = (data.pupil_x, data.pupil_y, data.pupil_z)
    ref = huygens.huygens_sum_plain(image, pupil, amp, opd_mm, 0.55e-3,
                                    data.radius)
    I, P, chunk = IX.numel(), Px.numel(), 128
    img = np.ascontiguousarray(np.stack([_np(a).ravel() for a in image]))
    pup = np.ascontiguousarray(np.stack([_np(a) for a in (*pupil, amp,
                                                          opd_mm)]))
    partial = np.zeros((-(-P // chunk), 2, I))
    assert partial.shape[0] >= 2
    host_lib.huygens_kernel(I, P, chunk, ctypes.c_double(1 / 0.55e-3),
                            ctypes.c_double(float(data.radius)), _ptr(img),
                            _ptr(pup), _ptr(partial))
    got = huygens.reduce_partials(torch.from_numpy(partial)).reshape(IX.shape)
    _close(_np(got), ref, "psf")


@pytest.mark.parametrize("case", ["opd_20mm", "peak"])
def test_huygens_body_random_and_peak(host_lib, case):
    """K8's body on the inputs of tools/bench_wave_optics.py, cut to 64 x 96
    (opd up to 20 mm: phases up to ~2.3e5 rad, the cycles' reduction far
    from the origin), and on the normalizing peak's single image point
    (I = 1, unit amplitude, zero OPD), against `huygens_sum_plain`."""
    from optiland_tpu_torch.psf import huygens

    rng = np.random.default_rng(3)
    I, P, Rp = (64, 96, 60.0) if case == "opd_20mm" else (1, 200, 54.0)
    if case == "opd_20mm":
        pup = np.stack([*rng.uniform(-5, 5, (2, P)), np.zeros(P),
                        rng.uniform(0.5, 1.0, P), rng.uniform(0, 20, P)])
        img = np.stack([*rng.uniform(-0.05, 0.05, (2, I)), np.full(I, Rp)])
    else:
        # samples on the sphere of radius Rp about the image point
        # (0, 0, 60), as wavefront_data places them
        th = rng.uniform(0, 0.2, P)
        ph = rng.uniform(0, 2 * np.pi, P)
        pup = np.stack([Rp * np.sin(th) * np.cos(ph), Rp * np.sin(th)
                        * np.sin(ph), 60.0 - Rp * np.cos(th), np.ones(P),
                        np.zeros(P)])
        img = np.array([[0.0], [0.0], [60.0]])
    img, pup = np.ascontiguousarray(img), np.ascontiguousarray(pup)
    t = [torch.from_numpy(a) for a in (*img, *pup)]
    ref = huygens.huygens_sum_plain(t[:3], t[3:6], t[6], t[7], 0.55e-3,
                                    torch.tensor(Rp, dtype=torch.float64))
    partial = np.zeros((-(-P // 64), 2, I))
    host_lib.huygens_kernel(I, P, 64, ctypes.c_double(1 / 0.55e-3),
                            ctypes.c_double(Rp), _ptr(img), _ptr(pup),
                            _ptr(partial))
    got = huygens.reduce_partials(torch.from_numpy(partial))
    _close(_np(got), ref, case)


def _system_lib(out, gxx, name, defines):
    """Popen of g++ building the per-system bodies (K1, K3, K5, K7) for
    `defines`, written as the header the card's build includes first
    (`_build.defines_header`)."""
    from optiland_tpu_torch import _build

    src = out / f"system_{name}.cpp"
    src.write_text(_build.defines_header(defines) + _PRELUDE + _SYSTEM_SHIM)
    return subprocess.Popen(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread",
         f"-I{out}", f"-I{CSRC}", "-o", str(out / f"libsystem_{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


# the systems the per-system chain is built for here: the bench lens, the
# absorbing Cooke triplet, and singlets with a tilt, a decenter and a clear
# aperture, and with an odd asphere on a mirror
_PER_SYSTEM = ("bench", "cooke", "tilt_decenter_aperture", "odd_asphere_mirror")


@pytest.fixture(scope="module")
def system_libs(tmp_path_factory):
    """The per-system bodies built for each of _PER_SYSTEM and for the
    absorbing tabulated doublet from its `fused.history_defines` (K7's: K1's
    with the media's dispersion codes, which K1, K3 and K5 do not read),
    all g++ processes at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the device code for the host")
    out = tmp_path_factory.mktemp("system_host")
    (out / "cuda_runtime.h").write_text("#pragma once\n")
    procs = {}
    for name in _PER_SYSTEM + ("tabulated_doublet",):
        ts, _ = _HISTORY_SYSTEMS[name]().build(device="cpu")
        procs[name] = _system_lib(out, gxx, name, fused.history_defines(ts))
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(out / f"libsystem_{name}.so"))
    return libs


def _system_inputs(ts, tp, w, seed=9):
    """diffp, nondiffp, rg and the float table of a system at wavelength
    w, and n (Hx, Hy, Px, Py) from `seed` as numpy and torch arrays."""
    diffp, nondiffp = fused._uniform_params(ts, tp, w)
    rg = fused._raygen_scalars(ts, tp)
    ftab = _np(fused._pack_tables(ts, diffp, nondiffp, False)[0])
    rng = np.random.default_rng(seed)
    data_np = [np.ascontiguousarray(a) for a in (
        *rng.uniform(-0.5, 0.5, (2, N_RAYS)),
        *rng.uniform(-0.9, 0.9, (2, N_RAYS)))]
    return (diffp, nondiffp, rg, ftab, data_np,
            tuple(torch.from_numpy(a) for a in data_np))


@pytest.mark.parametrize("name", _PER_SYSTEM)
def test_system_chain_matches_plain(system_libs, f64, name):
    """K1's per-system chain (csrc/system_chain.cuh), compiled with the
    system's own codes, against `_moments_plain`: the moments and each
    ray's final state."""
    ts, tp = _SYSTEMS[name](Optic).build(device="cpu")
    w = 0.5876 if name == "bench" else 0.55
    diffp, nondiffp, rg, ftab, data_np, data = _system_inputs(ts, tp, w)
    n = N_RAYS
    out4, rays = np.zeros(4), np.zeros((8, n))
    system_libs[name].system_moments(n, _ptr(_np(rg)), _ptr(ftab),
                                     *map(_ptr, data_np), _ptr(out4),
                                     _ptr(rays))
    np.testing.assert_allclose(out4, _np(fused._moments_plain(
        ts, diffp, nondiffp, rg, data)), rtol=1e-12)
    ref = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data,
                                    tuple(range(8)))
    for k in range(8):
        np.testing.assert_allclose(rays[k], _np(ref[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=fused._NAMES[k])


@pytest.mark.parametrize("name", _PER_SYSTEM)
def test_system_raygen_trace_matches_plain(system_libs, f64, name):
    """K3's per-system body against `_raygen_trace_plain`: the requested
    outputs (x, y, N, opd: mask 0b10100011) agree, the others are left as
    they were."""
    ts, tp = _SYSTEMS[name](Optic).build(device="cpu")
    w = 0.5876 if name == "bench" else 0.55
    diffp, nondiffp, rg, ftab, data_np, data = _system_inputs(ts, tp, w,
                                                              seed=13)
    keys = (0, 1, 5, 7)
    outs = np.full((8, N_RAYS), -7.0)
    system_libs[name].system_raygen_trace(
        N_RAYS, sum(1 << k for k in keys), _ptr(_np(rg)), _ptr(ftab),
        *map(_ptr, data_np), _ptr(outs))
    ref = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data, keys)
    for k, r in zip(keys, ref):
        np.testing.assert_allclose(outs[k], _np(r), rtol=1e-12, atol=1e-12,
                                   err_msg=fused._NAMES[k])
    assert (outs[[k for k in range(8) if k not in keys]] == -7.0).all()


@pytest.mark.parametrize("name", ("bench_vignetted",) + _PER_SYSTEM[1:])
def test_system_caller_trace_matches_plain(system_libs, f64, name):
    """K5's per-system body on the eager `generate_rays` output (the
    vignetted bench lens's, whose codes are the bench lens's: vignetting
    acts in the raygen alone) against `_fused_trace_plain`."""
    if name == "bench_vignetted":
        ts, tp = bench_lens(Optic, vignetted=True).build(device="cpu")
        assert ts.has_vignetting
        assert fused.system_defines(ts) == fused.system_defines(
            bench_lens(Optic).build(device="cpu")[0])
        lib, w = system_libs["bench"], 0.5876
    else:
        ts, tp = _SYSTEMS[name](Optic).build(device="cpu")
        lib, w = system_libs[name], 0.55
    diffp, nondiffp, _, ftab, _, data = _system_inputs(ts, tp, w, seed=17)
    rays0 = generate_rays(ts, tp, *data, w)
    rays8 = tuple(getattr(rays0, k).expand(N_RAYS).contiguous()
                  for k in fused._RAY_KEYS[:8])
    rays_np = np.ascontiguousarray(np.stack([_np(r) for r in rays8]))
    outs = np.zeros((8, N_RAYS))
    lib.system_caller_trace(N_RAYS, _ptr(ftab), _ptr(rays_np), _ptr(outs))
    ref = fused._fused_trace_plain(ts, diffp, nondiffp, rays8)
    for k in range(8):
        np.testing.assert_allclose(outs[k], _np(ref[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=fused._NAMES[k])


_HISTORY_SYSTEMS = {
    **{name: (lambda name=name: _SYSTEMS[name](Optic)) for name in _PER_SYSTEM},
    "tabulated_doublet": lambda: tabulated_doublet(Optic),
}
# K7's cases: per-ray wavelengths (w) over the absorbing Cooke triplet and a
# doublet of a tabulated glass (formula 10) and an Abbe glass (11), each
# absorbing; "knots" puts the doublet's wavelengths on the knots of its
# extinction tables (0.4 .. 0.8 and 0.45 .. 0.65 um, the second padded with
# zero-width segments), below their first points and above their last
_HISTORY_CASES = {
    "cooke": ("cooke", (0.48, 0.55, 0.65)),
    "tabulated_doublet": ("tabulated_doublet", (0.48, 0.55, 0.65)),
    "knots": ("tabulated_doublet", (0.38, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65,
                                    0.7, 0.8, 0.85)),
}


@pytest.mark.parametrize("case", list(_HISTORY_CASES))
def test_history_body_matches_plain(system_libs, f64, case):
    """K7's per-system body: the history at per-ray wavelengths mixed over
    the rays (per-ray `material_index` with the media's codes at compile
    time, absorption by `kv_segment`) against `_history_plain`, all 8
    arrays and all S rows."""
    name, wavelengths = _HISTORY_CASES[case]
    ts, tp = _HISTORY_SYSTEMS[name]().build(device="cpu")
    assert any(ts.has_absorption)
    diffp, nondiffp = fused._diff_params(tp), fused._nondiff_params(tp)
    ftab = _np(fused._pack_tables(ts, diffp, nondiffp, True)[0])
    rng = np.random.default_rng(7)
    n = N_RAYS
    Hy = rng.uniform(-1, 1, n)
    Px, Py = rng.uniform(-0.7, 0.7, (2, n))
    w = rng.choice(wavelengths, n)
    rays0 = generate_rays(ts, tp, *(torch.from_numpy(a) for a in (
        np.zeros(n), Hy, Px, Py)), torch.from_numpy(w))
    rays9 = tuple(getattr(rays0, k).contiguous() for k in fused._RAY_KEYS)
    rays_np = np.ascontiguousarray(np.stack([_np(r) for r in rays9]))
    mat, kwl, kval = (_np(t) for t in (diffp[6], nondiffp[1], nondiffp[2]))
    hist = np.zeros((8, ts.num_surfaces, n))
    system_libs[name].system_history(
        n, mat.shape[1], kwl.shape[1], _ptr(ftab), _ptr(mat), _ptr(kwl),
        _ptr(kval), _ptr(rays_np), _ptr(hist))
    ref = fused._history_plain(ts, diffp, nondiffp, rays9)
    i_last = _np(ref[6])[-1]
    assert 0.0 < i_last.max() < 1.0  # the glasses absorb
    for k in range(8):
        _close(hist[k], ref[k], fused._NAMES[k])


# the per-ray sweep's cases: per-ray wavelengths mixed over the rays, on
# the Cooke triplet (Sellmeier and polynomial glasses) and on the doublet
# of a tabulated and an Abbe glass, also at its tables' knots and edges
_PER_RAY_CASES = {name: _HISTORY_CASES[name]
                  for name in ("cooke", "tabulated_doublet", "knots")}


@pytest.mark.parametrize("case", list(_PER_RAY_CASES))
def test_per_ray_bodies_match_plain(system_libs, f64, case):
    """The per-ray variants' bodies, built with the system's
    `history_defines`: K1's moments and K3's final arrays by the
    per-system chain at each ray's w; K2 and K4, the run-time chain's
    per-ray sweep (`trace_chain_w`, `reverse_chain_w`): the raygen and
    table cotangents, `mat_coeffs`' from the material rows and the
    tabulated glass's per-ray segments (the wrapper's `_material_grads`),
    the 5 data cotangents, w's included; K5 and K6 on the caller's rays
    with w the 9th array, its cotangent the 9th. Against the plain
    versions at per-ray wavelengths."""
    name, wavelengths = _PER_RAY_CASES[case]
    ts, tp = _HISTORY_SYSTEMS[name]().build(device="cpu")
    got = _check_per_ray_bodies(system_libs[name], ts, tp, wavelengths)
    assert 0.0 < got["K3"][6].max() < 1.0  # the glasses absorb
    for label in ("K2", "K4"):
        assert (np.abs(got[label][4][4]).max() > 0
                and got[label][3][6].abs().max() > 0)


def _check_per_ray_bodies(lib, ts, tp, wavelengths):
    """The per-ray variants' bodies of `lib` on 64 rays at wavelengths
    drawn from `wavelengths`, against the plain versions (see
    test_per_ray_bodies_match_plain); returns K3's final arrays, K2's and
    K4's (d_rg, d_diff, d_data) and K6's (d_rays, d_diff)."""
    S, n = ts.num_surfaces, N_RAYS
    diffp, nondiffp = fused._diff_params(tp), fused._nondiff_params(tp)
    rg = fused._raygen_scalars(ts, tp)
    ftab, itab = (_np(t) for t in fused._pack_tables(ts, diffp, nondiffp,
                                                     True))
    mat, kwl, kval = (_np(t) for t in (diffp[6], nondiffp[1], nondiffp[2]))
    rng = np.random.default_rng(21)
    data_np = [np.ascontiguousarray(a) for a in (
        *rng.uniform(-0.5, 0.5, (2, n)), *rng.uniform(-0.7, 0.7, (2, n)),
        rng.choice(wavelengths, n))]
    data = tuple(torch.from_numpy(a) for a in data_np)
    seeds = np.ascontiguousarray(rng.normal(size=(8, n)))
    T = sum(f == 10 for f in ts.mat_formulas)
    nn = min(ts.newton_iters, fused._NEWTON_FUSED_MAX)
    media = (nn, mat.shape[1], kwl.shape[1])

    E = _wide_rows(ts)

    def sweep(fn, mode, rows, *args, n_out):
        tab = np.zeros((rows + E, 32))
        out = np.zeros((n_out, n))
        seg = np.ones((max(T, 1), n), dtype=np.int32)
        val = np.zeros((max(T, 1), 4, n))
        fn(mode, n, *media, *args, _ptr(tab), _ptr(out), _ptr(seg), _ptr(val))
        d_mat = fused._material_grads(ts, torch.from_numpy(
            tab[rows - S:rows]), (torch.from_numpy(seg),
                                  torch.from_numpy(val)), diffp[6])
        return tab, out, fused._unpack_table_grads(
            ts, torch.from_numpy(tab[:S]), diffp, d_mat,
            torch.from_numpy(tab[rows:]))

    def raygen(mode, c=np.zeros(4), s=np.zeros((8, n))):
        out4, rays = np.zeros(4), np.zeros((8, n))
        tab, dd, d_diff = sweep(
            lambda *a: lib.raygen_kernels_w(
                *a[:5], _ptr(_np(rg)), _ptr(ftab), _ptr(itab), _ptr(mat),
                _ptr(kwl), _ptr(kval), *map(_ptr, data_np), _ptr(c), _ptr(s),
                _ptr(out4), _ptr(rays), *a[5:]), mode, 2 * S + 1, n_out=5)
        return out4, rays, tab[S, :5], d_diff, dd

    # K1 and K3
    m, rays, _, _, _ = raygen(0)
    np.testing.assert_allclose(m, _np(fused._moments_plain(
        ts, diffp, nondiffp, rg, data)), rtol=1e-12)
    ref = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data,
                                    tuple(range(8)))
    for k in range(8):
        _close(rays[k], ref[k], f"K3 {fused._NAMES[k]}")
    res = {"K3": rays}
    # K2 and K4
    c = np.array([0.3, -0.7, 0.5, 1.1])
    for label, got, ref in (
            ("K2", raygen(1, c=c), fused._moments_bwd_plain(
                ts, diffp, nondiffp, rg, data, torch.from_numpy(c), True)),
            ("K4", raygen(2, s=seeds), fused._raygen_trace_bwd_plain(
                ts, diffp, nondiffp, rg, data, tuple(range(8)),
                tuple(torch.from_numpy(a) for a in seeds)))):
        _close(got[2], ref[0], f"{label} rg")
        for key, g, r in zip(_GROUP_NAMES, got[3], ref[1]):
            _close(_np(g), r, f"{label} {key}")
        for q in range(5):
            _close(got[4][q], ref[2][q], f"{label} data {q}")
        res[label] = got

    # K5 and K6 on the raygen's rays with a caller's intensity and opd
    rays9 = [r.detach().expand(n).clone() for r in fused._tile_raygen(
        ts, rg, *data[:4])[:6]]
    rays9 += [torch.from_numpy(rng.uniform(0.5, 1.0, n)),
              torch.from_numpy(rng.uniform(0.0, 1.0, n)), data[4]]
    rays_np = np.ascontiguousarray(np.stack([_np(r) for r in rays9]))

    def caller(mode):
        return sweep(lambda *a: lib.caller_kernels_w(
            *a[:5], _ptr(ftab), _ptr(itab), _ptr(mat), _ptr(kwl), _ptr(kval),
            _ptr(rays_np), _ptr(seeds), *a[5:]), mode, 2 * S, n_out=9)

    _, outs, _ = caller(0)
    ref = fused._fused_trace_plain(ts, diffp, nondiffp, rays9)
    for k in range(8):
        _close(outs[k], ref[k], f"K5 {fused._NAMES[k]}")
    _, outs, d_diff = caller(1)
    d_rays, ref_diff = fused._fused_trace_bwd_plain(
        ts, diffp, nondiffp, rays9, tuple(torch.from_numpy(a) for a in seeds))
    for k in range(9):
        _close(outs[k], d_rays[k], f"K6 d{fused._RAY_KEYS[k]}")
    for key, g, r in zip(_GROUP_NAMES, d_diff, ref_diff):
        _close(_np(g), r, f"K6 {key}")
    # no rays: no segments to sum
    empty = (torch.ones((max(T, 1), 0), dtype=torch.int32),
             torch.zeros((max(T, 1), 4, 0)))
    assert not fused._material_grads(ts, torch.zeros((S, 32)), empty,
                                     diffp[6]).any()
    res["K6"] = (outs, d_diff)
    return res


def test_k1_signature():
    """The per-system variants' key: the same codes give the same key, new
    values keep it, and a changed code (a surface type, a tilt, a decenter,
    an aperture, a mirror, the field type, the Newton count) changes it;
    K1, K3, K5 and K7 of one system are four libraries, each built per
    system and none among the sources built once."""
    from optiland_tpu_torch import _build

    def key(lens):
        return _build.variant_name("moments_fwd", fused.system_defines(
            lens.build(device="cpu")[0]))

    base = key(bench_lens(Optic))
    assert key(bench_lens(Optic)) == base
    ts, tp = bench_lens(Optic).build(device="cpu")
    assert fused.system_defines(replace(ts)) == fused.system_defines(ts)
    per_system = ("moments_fwd", "raygen_trace_fwd", "fused_trace_fwd",
                  "history_fwd")
    assert set(_build.PER_SYSTEM) == set(per_system)
    assert not set(_build.SOURCES) & set(per_system)
    names = {_build.variant_name(src, fused.system_defines(ts))
             for src in per_system}
    assert len(names) == 4 and base in names
    # other values, the same codes: a wider field, another object distance
    assert key(singlet_lens(Optic, max_field=8.0)) == key(singlet_lens(Optic))
    assert key(singlet_lens(Optic, object_distance=150.0)) == key(
        singlet_lens(Optic, object_distance=200.0))
    variants = [
        singlet_lens(Optic), singlet_lens(Optic, tilt=True),
        singlet_lens(Optic, decenter=True), singlet_lens(Optic, aperture=4.5),
        singlet_lens(Optic, mirror=True), singlet_lens(Optic, odd=True),
        singlet_lens(Optic, asphere=False),
        singlet_lens(Optic, field_type="object_height",
                     object_distance=100.0)]
    keys = [key(v) for v in variants]
    assert len(set(keys)) == len(keys)
    assert base not in keys
    assert (fused.system_defines(replace(ts, newton_iters=1))
            != fused.system_defines(ts))


@pytest.mark.parametrize("name, digest, media", [
    ("cooke", "3015ccfeb76f", "{0, 1}, {3, 11}, {0, 1}, {2, 7}, {0, 1}, "
     "{3, 11}, {0, 1}, {0, 1}"),
    ("bench", "c369d8e753d8", ", ".join(["{0, 1}"] * 13))])
def test_history_defines(name, digest, media):
    """K7's definitions are K1's with OTK_MATERIALS, the {formula,
    coefficient count} of the medium after each surface, added; K1's, K3's
    and K5's definitions and variant names at one wavelength are those they
    had before K7 was built per system (the names pinned here), and K7's
    variant is another library, which a glass of another formula changes.
    The per-ray variants: K1, K3 and K5 built with K7's definitions, K2, K4
    and K6 with OTK_MATERIALS alone (`media_defines`), each a library of
    its own, none the one-wavelength one's."""
    from optiland_tpu_torch import _build

    ts, _ = _HISTORY_SYSTEMS[name]().build(device="cpu")
    k7 = fused.history_defines(ts)
    assert k7 == fused.system_defines(ts) + (("OTK_MATERIALS", media),)
    assert fused.media_defines(ts) == (("OTK_MATERIALS", media),)
    for src in ("moments_fwd", "raygen_trace_fwd", "fused_trace_fwd"):
        assert _build.variant_name(src, fused.system_defines(ts)) == (
            f"{src}-{digest}")
    assert _build.variant_name("history_fwd", k7) != f"history_fwd-{digest}"
    per_ray = {_build.variant_name(src, k7) for src in (
        "moments_fwd", "raygen_trace_fwd", "fused_trace_fwd", "history_fwd")}
    per_ray |= {_build.variant_name(src, fused.media_defines(ts)) for src in (
        "moments_bwd", "raygen_trace_bwd", "fused_trace_bwd")}
    assert len(per_ray) == 7
    assert not per_ray & {f"{src}-{digest}" for src in (
        "moments_fwd", "raygen_trace_fwd", "fused_trace_fwd")}
    assert not per_ray & set(_build.SOURCES)
    glass = replace(ts, mat_formulas=ts.mat_formulas[:1] + (11,)
                    + ts.mat_formulas[2:])
    assert fused.history_defines(glass) != k7
    assert fused.media_defines(glass) != fused.media_defines(ts)
    assert fused.system_defines(glass) == fused.system_defines(ts)


@pytest.mark.parametrize("width", [4, 8, 16, 32])
def test_warp_rows_reduce_scatter(host_lib, width):
    """`WarpRows::put` on 32 emulated lanes: the reduce-scatter leaves slot
    j's sum over the lanes in the warp's row for j < width, the plain sum,
    and touches no slot past the width."""
    rng = np.random.default_rng(width)
    v = np.ascontiguousarray(rng.normal(size=(32, 32)))
    row = np.zeros(32)
    host_lib.warp_rows_lanes(width, _ptr(v), _ptr(row))
    np.testing.assert_allclose(row[:width], v.sum(axis=0)[:width], rtol=1e-13,
                               atol=1e-13)
    assert not row[width:].any()


@pytest.mark.parametrize("n, n_sm, grid", [
    (1, 132, (1, 128)), (16_384, 132, (128, 128)), (16_389, 132, (129, 128)),
    (20_000, 132, (79, 256)), (65_536, 132, (128, 512)),
    (2_000_000, 132, (132, 512)), (2_000_000, 8, (8, 512))])
def test_backward_grid(n, n_sm, grid):
    """K2, K4 and K6's launch geometry: the smallest block (128, 256 or 512
    threads) whose tiles fit one to an SM, else one 512-thread block an SM;
    the blocks' tiles cover every ray."""
    blocks, threads = fused.backward_grid(n, n_sm)
    assert (blocks, threads) == grid
    assert blocks <= n_sm and threads % 32 == 0
    assert -(-n // threads) <= blocks or blocks == n_sm


@pytest.mark.parametrize("n, n_sm, per_sm, blocks", [
    (0, 132, 2, 1), (1, 132, 2, 1), (65_536, 132, 2, 256),
    (2_000_000, 132, 2, 264), (2_000_000, 132, 3, 396),
    (2_000_000, 132, 6, 7813), (2_000_000, 8, 4, 7813),
    (257, 132, 6, 2)])
def test_system_grid(n, n_sm, per_sm, blocks):
    """K1, K3 and K5's launch geometry: a block a tile of 256 rays where an
    SM holds 4 or more blocks at once, else a persistent grid of at most
    n_sm * per_sm blocks; the blocks' tiles cover every ray."""
    got = fused.system_grid(n, n_sm, per_sm)
    assert got == blocks
    assert got >= 1 and (got * fused._SYSTEM_THREADS >= n
                         or got == n_sm * per_sm)


@pytest.mark.parametrize("S, n, bulk", [
    (8, 16_384, False), (8, 16_386, False), (8, 204_802, True),
    (8, 1_999_998, True), (8, 1_999_872, False), (13, 126_030, False),
    (13, 126_031, True)])
def test_history_bulk(S, n, bulk):
    """K7 sends its history by bulk copies where the rows start off 32-byte
    sectors (n not a multiple of 8) and the 8 (S, n) float32 arrays
    outgrow an H100's 50 MiB L2 cache, else one float a thread."""
    assert fused.history_bulk(S, n, 50 * 2**20) is bulk


# The chain's coating, thin-lens, grating and phase branches and their
# adjoints, built with OTK_INTERACTIONS and, for the phase sheets, OTK_PHASE
# (`fused.branch_defines`): a coated singlet, the same at T = 0 on its
# first surface, a coated mirror at R = 0 (whose factor is R), the coated
# thin lens, the plane grating, the concave reflective grating coated at
# (T, R) = (0.9, 0) (a reflective grating takes T, as in JAX), the coated,
# absorbing Cooke triplet; the plane phase sheets of the three analytic
# kinds (the radial one with a ray through its axis, where the chain's
# gradient derivative is 2 p0), a linear-grating sheet at Ky = 0.99 k0,
# where a part of the bundle passes the cutoff and rays come to it from
# both sides, the coated metalens on a conic carrier, the tilted
# reflective sheet and the hybrid achromat (absorbing N-BK7, a radial sheet
# and a constant sheet)
def _coated_t0():
    """The coated singlet with T = 0 on its first surface alone."""
    lens = coated_singlet(Optic, T=0.0)
    lens.surfaces[2].coating = ("simple", 0.9, 0.05)
    lens._dirty()
    return lens


_BRANCH_SYSTEMS = {
    "coated_singlet": lambda: coated_singlet(Optic),
    "coated_t0": _coated_t0,
    "coated_mirror_r0": lambda: coated_singlet(Optic, R=0.0, mirror=True),
    "thin_lens": lambda: thin_lens_system(Optic),
    "plane_grating": lambda: plane_grating(Optic),
    "curved_grating": lambda: curved_grating(Optic, ("simple", 0.9, 0.0)),
    "coated_cooke": lambda: coated_cooke(Optic),
    **{f"phase_{kind}": (lambda kind=kind: phase_sheet(
        Optic, PHASE_PROFILES[kind])) for kind in PHASE_PROFILES},
    "phase_cutoff": lambda: phase_sheet(
        Optic, ("linear_grating", 0.0, 0.99 * K0_055)),
    "metalens": lambda: curved_metalens(Optic),
    "phase_mirror": lambda: phase_mirror(Optic),
    "hybrid_achromat": lambda: hybrid_achromat(Optic),
}


@pytest.fixture(scope="module")
def branch_libs(tmp_path_factory):
    """The run-time bodies (the host shim, "run_time") and each of
    _BRANCH_SYSTEMS' per-system bodies, built with its
    `fused.history_defines` (OTK_INTERACTIONS among them), all g++
    processes at once; systems of the same codes share a build."""
    from optiland_tpu_torch import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the device code for the host")
    out = tmp_path_factory.mktemp("branch_host")
    (out / "cuda_runtime.h").write_text("#pragma once\n")
    src = out / "shim.cpp"
    src.write_text(_build.defines_header((("OTK_INTERACTIONS", "1"),
                                          ("OTK_PHASE", "1"))) + _SHIM)
    procs = {"run_time": subprocess.Popen(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread",
         f"-I{out}", f"-I{CSRC}", "-o", str(out / "librun_time.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    by_codes = {}
    for name, make in _BRANCH_SYSTEMS.items():
        defines = fused.history_defines(make().build(device="cpu")[0])
        if defines not in by_codes:
            by_codes[defines] = name
            procs[name] = _system_lib(out, gxx, name, defines)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so" if name ==
                                     "run_time" else
                                     out / f"libsystem_{name}.so"))
    for name, make in _BRANCH_SYSTEMS.items():
        defines = fused.history_defines(make().build(device="cpu")[0])
        libs[name] = libs[by_codes[defines]]
    return libs


def _branch_system(name):
    ts, tp = _BRANCH_SYSTEMS[name]().build(device="cpu")
    phase = fused.INT_PHASE in ts.interactions
    assert fused.branch_defines(ts) == (("OTK_INTERACTIONS", "1"),) + (
        (("OTK_PHASE", "1"),) if phase else ())
    return ts, tp


# the profile slots each phase kind reads (the radial kind all eight)
_PHASE_SLOTS_READ = {fused.PHASE_CONSTANT: (0,),
                     fused.PHASE_RADIAL: tuple(range(8)),
                     fused.PHASE_LINEAR_GRATING: (0, 1)}


def _lit(ts, tp):
    """The surfaces that light reaches: those before and at the first
    surface whose coating's factor is 0 (after it the intensity is 0, and
    so are the cotangents of every branch)."""
    for k in range(1, ts.num_surfaces - 1):
        refl = ts.interactions[k] == fused.INT_REFLECT
        if fused._coated(ts, k) and tp.coating_params[k, int(refl)] == 0:
            return range(1, k + 1)
    return range(1, ts.num_surfaces - 1)


def _branch_slots(ts, tp, tab, opd_seeded=True):
    """Each branch's cotangents in a (S, 32) table on the lit surfaces
    (`_lit`): the coated surfaces' factor slot, the thin lenses' focal
    slot, the gratings' 3 slots and the phase sheets' slots their kind
    reads and 1 / k0 (a constant sheet acts on the OPD alone: without an
    OPD seed, as in K2, it has none)."""
    got = []
    for k in _lit(ts, tp):
        if fused._coated(ts, k):
            got.append(tab[k, fused._F_COAT])
        if ts.interactions[k] == fused.INT_THIN_LENS:
            got.append(tab[k, fused._F_FOCAL])
        if ts.interactions[k] == fused.INT_DIFFRACT:
            got += list(tab[k, fused._F_GRATING:fused._F_GRATING + 3])
        kind = ts.phase_kinds[k]
        if ts.interactions[k] == fused.INT_PHASE and (
                opd_seeded or kind != fused.PHASE_CONSTANT):
            got += [tab[k, fused._F_PHASE + j] for j in _PHASE_SLOTS_READ[kind]]
            got.append(tab[k, fused._F_PHASE_IK])
    return np.asarray(got)


@pytest.mark.parametrize("name", list(_BRANCH_SYSTEMS))
def test_branch_run_time_bodies_match_plain(branch_libs, f64, name):
    """The run-time chain's coating, thin-lens, grating and phase branches
    at one wavelength (K1's moments, K2, K4, K5, K6, the gratings' m w and
    the phase sheets' 1 / k0 hoisted into the table) against the plain
    versions at 1e-10, T = 0, R = 0, a ray on a radial sheet's axis and
    rays past a phase sheet's cutoff included; each branch's parameter
    cotangents are there (not 0) in K2's and K6's tables."""
    ts, tp = _branch_system(name)
    k2, k6 = _check_run_time_bodies(branch_libs["run_time"], ts, tp, 0.55,
                                    axial_ray=name.startswith("phase_"))
    for tab, opd_seeded in ((k2, False), (k6, True)):
        assert np.all(np.abs(_branch_slots(ts, tp, tab, opd_seeded)) > 0)


@pytest.mark.parametrize("name", list(_BRANCH_SYSTEMS))
def test_branch_system_bodies_match_plain(branch_libs, f64, name):
    """The per-system bodies built with the system's codes and
    OTK_INTERACTIONS: K1's moments and each ray's final state, K3's
    requested outputs and K5's on `generate_rays` output at one
    wavelength, and K7's history at per-ray wavelengths, against the plain
    versions."""
    ts, tp = _branch_system(name)
    _check_system_bodies(branch_libs[name], ts, tp)


def _check_system_bodies(lib, ts, tp):
    """The per-system bodies of `lib` (K1, K3, K5 at 0.55 um, K7 at per-ray
    wavelengths) against the plain versions (see
    test_branch_system_bodies_match_plain)."""
    n = N_RAYS
    diffp, nondiffp, rg, ftab, data_np, data = _system_inputs(ts, tp, 0.55)
    out4, rays = np.zeros(4), np.zeros((8, n))
    lib.system_moments(n, _ptr(_np(rg)), _ptr(ftab), *map(_ptr, data_np),
                       _ptr(out4), _ptr(rays))
    _close(out4, fused._moments_plain(ts, diffp, nondiffp, rg, data), "K1")
    ref = fused._raygen_trace_plain(ts, diffp, nondiffp, rg, data,
                                    tuple(range(8)))
    for k in range(8):
        _close(rays[k], ref[k], f"K1 {fused._NAMES[k]}")
    keys = (0, 1, 5, 6, 7)
    outs = np.full((8, n), -7.0)
    lib.system_raygen_trace(n, sum(1 << k for k in keys), _ptr(_np(rg)),
                            _ptr(ftab), *map(_ptr, data_np), _ptr(outs))
    for k in keys:
        _close(outs[k], ref[k], f"K3 {fused._NAMES[k]}")
    assert (outs[[2, 3, 4]] == -7.0).all()
    rays0 = generate_rays(ts, tp, *data, 0.55)
    rays8 = tuple(getattr(rays0, k).expand(n).contiguous()
                  for k in fused._RAY_KEYS[:8])
    rays_np = np.ascontiguousarray(np.stack([_np(r) for r in rays8]))
    lib.system_caller_trace(n, _ptr(ftab), _ptr(rays_np), _ptr(outs))
    ref = fused._fused_trace_plain(ts, diffp, nondiffp, rays8)
    for k in range(8):
        _close(outs[k], ref[k], f"K5 {fused._NAMES[k]}")
    # K7 at per-ray wavelengths
    w = np.random.default_rng(3).choice((0.48, 0.55, 0.65), n)
    rays0 = generate_rays(ts, tp, *data, torch.from_numpy(w))
    rays9 = tuple(getattr(rays0, k).expand(n).contiguous()
                  for k in fused._RAY_KEYS)
    rays_np = np.ascontiguousarray(np.stack([_np(r) for r in rays9]))
    diffp, nondiffp = fused._diff_params(tp), fused._nondiff_params(tp)
    ftab = _np(fused._pack_tables(ts, diffp, nondiffp, True)[0])
    mat, kwl, kval = (_np(t) for t in (diffp[6], nondiffp[1], nondiffp[2]))
    hist = np.zeros((8, ts.num_surfaces, n))
    lib.system_history(n, mat.shape[1], kwl.shape[1], _ptr(ftab), _ptr(mat),
                       _ptr(kwl), _ptr(kval), _ptr(rays_np), _ptr(hist))
    ref = fused._history_plain(ts, diffp, nondiffp, rays9)
    for k in range(8):
        _close(hist[k], ref[k], f"K7 {fused._NAMES[k]}")


@pytest.mark.parametrize("name", list(_BRANCH_SYSTEMS))
def test_branch_per_ray_bodies_match_plain(branch_libs, f64, name):
    """The per-ray variants' bodies with the coating, thin-lens, grating
    and phase branches (K1, K3 by the per-system chain at each ray's w; K2,
    K4, K5, K6 by the per-ray sweep, a grating's m w turned into m's and
    w's cotangents, a phase sheet's 1 / k0 into w's) against the plain
    versions at per-ray wavelengths; each branch's parameter cotangents are
    there, and a grating or a bending phase sheet gives w a cotangent even
    in a dispersionless medium."""
    ts, tp = _branch_system(name)
    got = _check_per_ray_bodies(branch_libs[name], ts, tp, (0.48, 0.55, 0.65))
    d_diff = got["K2"][3]
    for k in _lit(ts, tp):
        if fused._coated(ts, k):
            assert d_diff[7][k].abs().max() > 0
        if ts.interactions[k] == fused.INT_THIN_LENS:
            assert d_diff[11][k] != 0
        if ts.interactions[k] == fused.INT_DIFFRACT:
            assert d_diff[9][k].abs().min() > 0
            assert np.abs(got["K2"][4][4]).max() > 0
        kind = ts.phase_kinds[k]
        if (ts.interactions[k] == fused.INT_PHASE
                and kind != fused.PHASE_CONSTANT):
            assert d_diff[10][k, list(_PHASE_SLOTS_READ[kind])].abs().min() > 0
            assert np.abs(got["K2"][4][4]).max() > 0
    if fused.INT_PHASE in ts.interactions:
        # K6 seeds the OPD: every sheet's slots, the constant one's too
        d6 = got["K6"][1][10]
        assert all(d6[k, list(_PHASE_SLOTS_READ[ts.phase_kinds[k]])].abs(
        ).min() > 0 for k in _lit(ts, tp)
            if ts.interactions[k] == fused.INT_PHASE)


# phase j5's freeform systems (chip_smoke.py): G, the biconic and toroidal
# singlet; H, poly-XY and a 16-term Fringe Zernike; I, a tilted, decentred
# Chebyshev and a Forbes Q-bfs
_FREEFORM_SYSTEMS = {"G": SMOKE.anamorphic_singlet,
                     "H": SMOKE.xy_freeform_singlet,
                     "I": SMOKE.tilted_freeform_singlet}
# every freeform family the chain takes but Forbes Q-2D, whose build takes
# its system's terms (phase j6's systems J and K, `long_libs`): the
# run-time bodies' mask
_ALL_FREEFORMS = sum(1 << g for g in fused._KERNEL_FREEFORMS
                     if g != fused.GEOM_FORBES_Q2D)


@pytest.fixture(scope="module")
def freeform_libs(tmp_path_factory):
    """The run-time bodies built with OTK_FREEFORM for every family
    ("run_time") and G's, H's and I's per-system bodies built with their
    `fused.history_defines`, all g++ processes at once."""
    from optiland_tpu_torch import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the device code for the host")
    out = tmp_path_factory.mktemp("freeform_host")
    (out / "cuda_runtime.h").write_text("#pragma once\n")
    src = out / "shim.cpp"
    src.write_text(_build.defines_header(
        (("OTK_FREEFORM", f"0x{_ALL_FREEFORMS:x}u"),)) + _SHIM)
    procs = {"run_time": subprocess.Popen(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread",
         f"-I{out}", f"-I{CSRC}", "-o", str(out / "librun_time.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    for name, make in _FREEFORM_SYSTEMS.items():
        procs[name] = _system_lib(out, gxx, name, fused.history_defines(
            make(Optic).build(device="cpu")[0]))
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so" if name ==
                                     "run_time" else
                                     out / f"libsystem_{name}.so"))
    return libs


def _freeform_system(name):
    ts, tp = _FREEFORM_SYSTEMS[name](Optic).build(device="cpu")
    assert fused.branch_defines(ts) == (
        ("OTK_FREEFORM", f"0x{fused._freeform_mask(ts):x}u"),)
    return ts, tp


def _freeform_rows(ts, d_coeffs):
    """Each freeform surface's coefficient cotangents over the slots its
    family reads (all of them but a poly-XY's unused C_00), all nonzero."""
    for k in range(1, ts.num_surfaces - 1):
        row = d_coeffs[k, :ts.geom_n_coeffs[k]]
        if ts.geom_codes[k] == fused.GEOM_POLYNOMIAL_XY:
            row = row[1:]
        assert torch.as_tensor(row).abs().min() > 0, k


@pytest.mark.parametrize("name", list(_FREEFORM_SYSTEMS))
def test_freeform_run_time_bodies_match_plain(freeform_libs, f64, name):
    """The run-time chain's freeform branch (K1's moments, K2, K4, K5, K6 at
    one wavelength, each freeform's aux ints and Newton count read from the
    int table) against the plain versions at 1e-10; every coefficient
    slot a freeform reads has its cotangent in K2's and K6's tables."""
    ts, tp = _freeform_system(name)
    k2, k6 = _check_run_time_bodies(freeform_libs["run_time"], ts, tp, 0.55)
    for tab in (k2, k6):
        _freeform_rows(ts, tab[:, fused._F_COEFFS:])


@pytest.mark.parametrize("name", list(_FREEFORM_SYSTEMS))
def test_freeform_system_bodies_match_plain(freeform_libs, f64, name):
    """The per-system bodies built with the system's codes, OTK_FREEFORM,
    OTK_NEWTON_FF and OTK_FF_AUX: K1, K3 and K5 at one wavelength and K7 at
    per-ray wavelengths against the plain versions."""
    ts, tp = _freeform_system(name)
    _check_system_bodies(freeform_libs[name], ts, tp)


@pytest.mark.parametrize("name", list(_FREEFORM_SYSTEMS))
def test_freeform_per_ray_bodies_match_plain(freeform_libs, f64, name):
    """The per-ray variants' bodies with the freeform branch (K1, K3 by the
    per-system chain at each ray's w; K2, K4, K5, K6 by the per-ray sweep,
    N-BK7's coefficients and w differentiated) against the plain versions;
    every freeform coefficient slot has its cotangent."""
    ts, tp = _freeform_system(name)
    got = _check_per_ray_bodies(freeform_libs[name], ts, tp,
                                (0.48, 0.55, 0.65))
    _freeform_rows(ts, got["K2"][3][2])
    _freeform_rows(ts, got["K6"][1][2])


@pytest.mark.parametrize("surface", ["G1", "G2", "H1", "H2", "I1", "I2",
                                     "noll", "standard"])
def test_freeform_sag_matches_plain(freeform_libs, f64, surface):
    """`ff_sag_grad` (csrc/freeform.cuh) of each face of G, H and I, and of
    H's Zernike in the Noll and standard conventions (its constant tables of
    m and the radial coefficients), against `geometry/surfaces.sag_and_grad`
    at 48 points over +-5 mm, at 1e-12 of each output's scale."""
    from optiland_tpu_torch.geometry import surfaces as tsurf

    system = {"G": "G", "H": "H", "I": "I"}.get(surface[0], "H")
    ts, tp = _FREEFORM_SYSTEMS[system](Optic).build(device="cpu")
    k = 2 if surface in ("noll", "standard") else int(surface[1])
    aux = ts.geom_aux[k]
    if surface in ("noll", "standard"):
        aux = (tsurf.ZERNIKE_TYPE_CODES[surface],)
    code, nc = ts.geom_codes[k], ts.geom_n_coeffs[k]
    a0, a1 = ((tuple(aux) if code in (fused.GEOM_CHEBYSHEV,
                                      fused.GEOM_ZERNIKE) else ()) + (0, 0))[:2]
    x, y = np.random.default_rng(k).uniform(-5.0, 5.0, (2, 48))
    co = np.ascontiguousarray(_np(tp.coeffs[k]))
    out = np.zeros((3, 48))
    freeform_libs["run_time"].ff_sag_points(
        code, nc, a0, a1, ctypes.c_double(float(tp.cv[k])),
        ctypes.c_double(float(tp.conic[k])), _ptr(co), 48, _ptr(x), _ptr(y),
        _ptr(out))
    ref = tsurf.sag_and_grad(code, nc, torch.from_numpy(x), torch.from_numpy(y),
                             tp.cv[k], tp.conic[k], tp.coeffs[k], aux)
    for label, g, r in zip(("z", "gx", "gy"), out, ref):
        np.testing.assert_allclose(g, _np(r), rtol=0,
                                   atol=1e-12 * float(r.abs().max()),
                                   err_msg=label)


# phase j6's systems (chip_smoke.py): J, a tilted, decentred Forbes Q-2D face
# in a 17-slot row; K, a 38-slot Fringe Zernike and a 29-slot Q-2D (the wide
# rows, OTK_WIDE); L, 17 relays, 70 surfaces (a record of 128, OTK_MAX_
# SURFACES). Newton's count is cut to 2 here, as the other host systems'.
_LONG_SYSTEMS = {"J": SMOKE.q2d_singlet, "K": SMOKE.wide_freeform_singlet,
                 "L": SMOKE.relay_train}


def _long_system(name):
    ts, tp = _LONG_SYSTEMS[name](Optic).build(device="cpu")
    return replace(ts, newton_iters=2), tp


@pytest.fixture(scope="module")
def long_libs(tmp_path_factory):
    """J's, K's and L's run-time bodies (the host shim built with their
    `fused.backward_defines`) and per-system bodies (with their
    `fused.history_defines`), all g++ processes at once."""
    from optiland_tpu_torch import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the device code for the host")
    out = tmp_path_factory.mktemp("long_host")
    (out / "cuda_runtime.h").write_text("#pragma once\n")
    procs = {}
    for name in _LONG_SYSTEMS:
        ts, _ = _long_system(name)
        src = out / f"run_time_{name}.cpp"
        src.write_text(_build.defines_header(fused.backward_defines(
            ts, False)) + _SHIM)
        procs[name, "run_time"] = (subprocess.Popen(
            [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread",
             f"-I{out}", f"-I{CSRC}", "-o", str(out / f"librun_time_{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out / f"librun_time_{name}.so")
        procs[name, "system"] = (_system_lib(
            out, gxx, name, fused.history_defines(ts)),
            out / f"libsystem_{name}.so")
    libs = {}
    for key, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _long_coeff_rows(ts, tp, tab, S_rows):
    """The coefficient cotangents of a backward table whose table rows are
    the first S and whose wide rows are its last (`fused._wide_layout`):
    every slot of J's and K's freeform faces, past 17 too, nonzero; L's
    aspheres' coefficient nonzero."""
    ts_rows = torch.from_numpy(tab[:ts.num_surfaces])
    E = _wide_rows(ts)
    d = fused._unpack_table_grads(
        ts, ts_rows, fused._diff_params(tp),
        wide=torch.from_numpy(tab[len(tab) - E:]) if E else None)[2]
    for k in range(1, ts.num_surfaces - 1):
        if ts.geom_n_coeffs[k]:
            row = d[k, :ts.geom_n_coeffs[k]]
            assert row.abs().min() > 0, (k, row)


@pytest.mark.parametrize("name", list(_LONG_SYSTEMS))
def test_long_run_time_bodies_match_plain(long_libs, f64, name):
    """The run-time chain of the backward kernels (K1's moments, K2, K4, K5,
    K6 at one wavelength) on J, K and L, built with their
    `backward_defines`: the Q-2D branch with its terms' tables, the wide
    rows read from the table's tail and their cotangents summed in rows of
    their own, and L's 70-surface record; against the plain versions at
    1e-10, every coefficient slot's cotangent nonzero in K2's and K6's
    tables."""
    ts, tp = _long_system(name)
    k2, k6 = _check_run_time_bodies(long_libs[name, "run_time"], ts, tp,
                                    0.55)
    _long_coeff_rows(ts, tp, k2, ts.num_surfaces + 1)
    _long_coeff_rows(ts, tp, k6, ts.num_surfaces)


@pytest.mark.parametrize("name", list(_LONG_SYSTEMS))
def test_long_system_bodies_match_plain(long_libs, f64, name):
    """The per-system bodies of J, K and L (K1, K3, K5 at one wavelength, K7
    at per-ray wavelengths), built with their codes: the Q-2D terms, the
    wide surfaces' rows and counts (OTK_WIDE_OFF, OTK_WIDE_NC), 70
    unrolled surfaces; against the plain versions."""
    ts, tp = _long_system(name)
    _check_system_bodies(long_libs[name, "system"], ts, tp)


@pytest.mark.parametrize("name", list(_LONG_SYSTEMS))
def test_long_per_ray_bodies_match_plain(long_libs, f64, name):
    """The per-ray variants' bodies of J, K and L (K1, K3 by the per-system
    chain at each ray's w; K2, K4, K5, K6 by the per-ray sweep) against the
    plain versions, every coefficient slot's cotangent nonzero."""
    ts, tp = _long_system(name)
    got = _check_per_ray_bodies(long_libs[name, "system"], ts, tp,
                                (0.48, 0.55, 0.65))
    for label in ("K2", "K6"):
        d = got[label][3 if label == "K2" else 1][2]
        for k in range(1, ts.num_surfaces - 1):
            if ts.geom_n_coeffs[k]:
                assert d[k, :ts.geom_n_coeffs[k]].abs().min() > 0, (label, k)


@pytest.mark.parametrize("surface", ["J1", "K1", "K2"])
def test_long_sag_matches_plain(long_libs, f64, surface):
    """`ff_sag_grad` of J's Q-2D face and K's 38-slot Zernike and 29-slot
    Q-2D faces (their groups' range and their whole rows) against
    `geometry/surfaces.sag_and_grad` at 48 points over +-5 mm, past the
    norm radius too, at 1e-12 of each output's scale."""
    from optiland_tpu_torch.geometry import surfaces as tsurf

    ts, tp = _long_system(surface[0])
    k = int(surface[1])
    code, nc = ts.geom_codes[k], ts.geom_n_coeffs[k]
    a0, a1 = fused._freeform_aux(ts, k)
    x, y = np.random.default_rng(k).uniform(-5.5, 5.5, (2, 48))
    co = np.ascontiguousarray(_np(tp.coeffs[k]))
    out = np.zeros((3, 48))
    long_libs[surface[0], "run_time"].ff_sag_points(
        code, nc, a0, a1, ctypes.c_double(float(tp.cv[k])),
        ctypes.c_double(float(tp.conic[k])), _ptr(co), 48, _ptr(x), _ptr(y),
        _ptr(out))
    ref = tsurf.sag_and_grad(code, nc, torch.from_numpy(x),
                             torch.from_numpy(y), tp.cv[k], tp.conic[k],
                             tp.coeffs[k], ts.geom_aux[k])
    for label, g, r in zip(("z", "gx", "gy"), out, ref):
        np.testing.assert_allclose(g, _np(r), rtol=0,
                                   atol=1e-12 * float(r.abs().max()),
                                   err_msg=label)
