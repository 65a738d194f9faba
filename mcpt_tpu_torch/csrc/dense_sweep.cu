// Dense ray x triangle sweep for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel mcpt_tpu/ops/pallas_dense.py::_sweep_kernel
// (pallas_call at :148, wrapper ops/traversal.py::_intersect_dense_pallas).
// Contract, not layout: rays come in as o, d [N,3] and t_min, t_max [N];
// triangles as the packed table [P,12] (p0.xyz, e1.xyz, e2.xyz, opaque,
// pad, pad).  Out: t, prim (int32), v, w, inside, valid per ray — the
// GeomHit of ops/traversal.py.  Closest hit keeps the nearest hit in
// [t_min, t_max); any-hit mode keeps the nearest OPAQUE hit, exactly as the
// reference's dense any-hit does (no early exit, so t/prim match too).
//
// What bounds it on the card: fp32 ALU work.  Each (ray, triangle) pair is
// ~46 fp32 operations plus an IEEE division and a few compares, against
// 48 bytes of triangle data that every ray of the block shares; the whole
// table (<= 16384 triangles = 768 KB) sits in L2, so device memory is
// touched once per ray.  The design therefore spends nothing on data
// movement beyond staging: one thread per ray, its running best in
// registers, and each block stages the table through shared memory in
// tiles of TILE triangles (12 KB), read back as broadcasts (every thread
// of a warp reads the same address).
//
// Tie rule: triangles are scanned in increasing index order and a hit is
// taken only if t < t_best (strict), which reproduces the reference's
// chunked min-reduce exactly: among equal t the lowest index wins, and a
// hit at exactly t_max is not taken.  Lanes with t_max <= t_min (dead
// lanes get t_max = 0) skip the arithmetic; a block whose lanes are all
// dead skips the sweep.
//
// Arithmetic (ray_tests.cuh): built with --fmad=false and without fast
// math, so every multiply and add rounds on its own, in the same order as
// the plain PyTorch version (ops/dense_sweep.py::dense_sweep_plain) — the
// two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int THREADS = 256;  // rays per block
constexpr int TILE = 256;     // triangles staged per shared-memory tile

__global__ void __launch_bounds__(THREADS)
dense_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_min,
                   const float* __restrict__ t_max,
                   const float* __restrict__ tris, int n, int p, int any_hit,
                   float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                   float* __restrict__ v_out, float* __restrict__ w_out,
                   uint8_t* __restrict__ inside_out,
                   uint8_t* __restrict__ valid_out) {
  __shared__ float tile[TILE * ROW];

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool in_range = ray < n;

  mcpt::Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  float tmin = 0.f, t_best = 0.f;
  if (in_range) {
    r = mcpt::Ray{o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                  d[3 * ray], d[3 * ray + 1], d[3 * ray + 2]};
    tmin = t_min[ray];
    t_best = t_max[ray];
  }
  const bool live = in_range && (t_best > tmin);

  int32_t prim_best = 0;
  float v_best = 0.f, w_best = 0.f;
  bool in_best = false, valid = false;

  if (__syncthreads_or(live)) {
    for (int base = 0; base < p; base += TILE) {
      const int count = min(TILE, p - base);
      __syncthreads();  // previous tile fully consumed
      for (int i = threadIdx.x; i < count * ROW; i += THREADS) {
        tile[i] = tris[base * ROW + i];
      }
      __syncthreads();
      if (!live) continue;
      for (int k = 0; k < count; ++k) {
        const float* tri = &tile[k * ROW];
        if (any_hit && !(tri[9] > 0.5f)) continue;
        float t, v, w;
        bool back;
        if (mcpt::moller_trumbore(r, tri, tmin, t_best, t, v, w, back)) {
          t_best = t;
          prim_best = base + k;
          v_best = v;
          w_best = w;
          in_best = back;
          valid = true;
        }
      }
    }
  }

  if (in_range) {
    t_out[ray] = t_best;
    prim_out[ray] = prim_best;
    v_out[ray] = v_best;
    w_out[ray] = w_best;
    inside_out[ray] = in_best ? 1 : 0;
    valid_out[ray] = valid ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, passed as an integer
// handle); allocates nothing, does not synchronise.  Returns the launch's
// cudaGetLastError() as an int (0 = launched).
extern "C" int mcpt_dense_sweep(const void* o, const void* d,
                                const void* t_min, const void* t_max,
                                const void* tris, int n, int p, int any_hit,
                                void* t_out, void* prim_out, void* v_out,
                                void* w_out, void* inside_out,
                                void* valid_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  dense_sweep_kernel<<<blocks, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float*>(tris), n, p, any_hit,
      static_cast<float*>(t_out), static_cast<int32_t*>(prim_out),
      static_cast<float*>(v_out), static_cast<float*>(w_out),
      static_cast<uint8_t*>(inside_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
