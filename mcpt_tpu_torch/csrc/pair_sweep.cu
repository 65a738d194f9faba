// Pair-scheduled traversal for Hopper (sm_90a), plain C ABI: the corridor
// kernel (K3) and the pair sweep (K4).
//
// K3 replaces mcpt_tpu/ops/pallas_pairs.py::_corridor_kernel (pallas_call
// at :310).  One thread per ray: the chunk AABBs pass through shared memory
// in tiles, in index order; the thread writes the ids of the first K chunks
// its ray enters within [t_min, t_max] to slots [N,K] int32 (Lm = none) and
// raises overflow [N] when a (K+1)-th passes, then stops testing.  No
// [N, Lm] array is ever written.  Bound: fp32 slab tests, N x Lm.
//
// K4 replaces mcpt_tpu/ops/pallas_pairs.py::_pair_kernel (pallas_call at
// :347).  Input: (ray, chunk) pairs o, d [M,3], t_min, t_max [M] and chunk
// [M] int32 (Lm = dead), sorted by chunk so that a block's pairs span few
// chunks.  A block walks the distinct chunk ids of its pairs in ascending
// order (a block-wide min of the ids still to do, so that any order is
// right and a sorted one is fast), stages that chunk's ls rows and prim ids
// in shared memory, and only the pairs of that chunk test it.  Dead pairs
// do no work.  Out: t, prim, v, w, inside, valid per pair.  Bound: fp32
// ALU work, ~46 operations per live pair x triangle.
//
// Both repeat their plain versions (ops/pair_sweep.py) op for op
// (ray_tests.cuh): slots are equal, and t is bit-equal.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int CORRIDOR_THREADS = 256;
constexpr int BOX_TILE = 256;  // chunk AABBs staged per tile
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(CORRIDOR_THREADS)
corridor_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_min,
                const float* __restrict__ t_max,
                const float* __restrict__ cmin,
                const float* __restrict__ cmax, int n, int lm, int k,
                int32_t* __restrict__ slots, uint8_t* __restrict__ overflow) {
  __shared__ float box[BOX_TILE * 6];
  const int ray = blockIdx.x * CORRIDOR_THREADS + threadIdx.x;
  const bool in_range = ray < n;
  mcpt::Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  float tmin = 0.f, tmax = 0.f;
  if (in_range) {
    r = mcpt::Ray{o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                  d[3 * ray], d[3 * ray + 1], d[3 * ray + 2]};
    tmin = t_min[ray];
    tmax = t_max[ray];
  }
  const float rx = mcpt::safe_rcp(r.dx), ry = mcpt::safe_rcp(r.dy),
              rz = mcpt::safe_rcp(r.dz);
  int found = 0;
  bool over = false;
  for (int base = 0; base < lm; base += BOX_TILE) {
    const int count = min(BOX_TILE, lm - base);
    __syncthreads();  // previous tile consumed
    for (int i = threadIdx.x; i < count * 3; i += CORRIDOR_THREADS) {
      const int c = i / 3, a = i - 3 * c;
      box[6 * c + a] = cmin[3 * base + i];
      box[6 * c + 3 + a] = cmax[3 * base + i];
    }
    __syncthreads();
    if (in_range && !over) {
      for (int c = 0; c < count; ++c) {
        if (mcpt::chunk_entry(r, rx, ry, rz, tmin, tmax, &box[6 * c],
                              &box[6 * c + 3]) < INFINITY) {
          if (found == k) {
            over = true;
            break;
          }
          slots[static_cast<size_t>(ray) * k + found] = base + c;
          ++found;
        }
      }
    }
    if (__syncthreads_and(!in_range || over)) break;
  }
  if (in_range) {
    for (int j = found; j < k; ++j) slots[static_cast<size_t>(ray) * k + j] = lm;
    overflow[ray] = over ? 1 : 0;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
pair_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_min, const float* __restrict__ t_max,
            const int32_t* __restrict__ chunk,
            const float* __restrict__ tris, const int32_t* __restrict__ prim,
            int m, int lm, int ls, int any_hit,
            float* __restrict__ t_out, int32_t* __restrict__ prim_out,
            float* __restrict__ v_out, float* __restrict__ w_out,
            uint8_t* __restrict__ inside_out,
            uint8_t* __restrict__ valid_out) {
  extern __shared__ float rows[];  // [ls][12] rows, then [ls] prim ids
  int32_t* prim_s = reinterpret_cast<int32_t*>(rows + ls * ROW);
  __shared__ int red[32];
  __shared__ int cur_s;

  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = pair < m;
  mcpt::Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  float tmin = 0.f, t_best = 0.f;
  int own = lm;
  if (in_range) {
    r = mcpt::Ray{o[3 * pair], o[3 * pair + 1], o[3 * pair + 2],
                  d[3 * pair], d[3 * pair + 1], d[3 * pair + 2]};
    tmin = t_min[pair];
    t_best = t_max[pair];
    own = chunk[pair];
  }
  // chunk still to sweep for this pair; lm = none (dead or done)
  int rem = (in_range && own >= 0 && own < lm && t_best > tmin) ? own : lm;

  int32_t prim_best = 0;
  float v_best = 0.f, w_best = 0.f;
  bool in_best = false, valid = false;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  while (true) {
    // block-wide min of the chunk ids still to sweep
    const int wmin = __reduce_min_sync(FULL, rem);
    if (lane == 0) red[warp] = wmin;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < (blockDim.x >> 5) ? red[lane] : INT_MAX;
      const int bmin = __reduce_min_sync(FULL, v);
      if (lane == 0) cur_s = bmin;
    }
    __syncthreads();
    const int cur = cur_s;
    if (cur >= lm) break;
    const float* src = tris + static_cast<size_t>(cur) * ls * ROW;
    for (int i = threadIdx.x; i < ls * ROW; i += blockDim.x) rows[i] = src[i];
    const int32_t* psrc = prim + static_cast<size_t>(cur) * ls;
    for (int i = threadIdx.x; i < ls; i += blockDim.x) prim_s[i] = psrc[i];
    __syncthreads();
    if (rem == cur) {
      for (int k = 0; k < ls; ++k) {
        const float* tri = &rows[k * ROW];
        if (any_hit && !(tri[9] > 0.5f)) continue;
        float t, v, w;
        bool back;
        if (mcpt::moller_trumbore(r, tri, tmin, t_best, t, v, w, back)) {
          t_best = t;
          prim_best = prim_s[k];
          v_best = v;
          w_best = w;
          in_best = back;
          valid = true;
        }
      }
      rem = lm;
    }
    // the next reduction's barrier keeps the rows until every pair is done
  }

  if (in_range) {
    t_out[pair] = t_best;
    prim_out[pair] = prim_best;
    v_out[pair] = v_best;
    w_out[pair] = w_best;
    inside_out[pair] = in_best ? 1 : 0;
    valid_out[pair] = valid ? 1 : 0;
  }
}

}  // namespace

// Both launch on `stream` (PyTorch's current stream), allocate nothing and
// do not synchronise; each returns cudaGetLastError() as an int.

extern "C" int mcpt_corridor(const void* o, const void* d, const void* t_min,
                             const void* t_max, const void* cmin,
                             const void* cmax, int n, int lm, int k,
                             void* slots, void* overflow, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + CORRIDOR_THREADS - 1) / CORRIDOR_THREADS;
  corridor_kernel<<<blocks, CORRIDOR_THREADS, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float*>(cmin), static_cast<const float*>(cmax), n, lm,
      k, static_cast<int32_t*>(slots), static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcpt_pair_sweep(const void* o, const void* d,
                               const void* t_min, const void* t_max,
                               const void* chunk, const void* tris,
                               const void* prim, int m, int lm, int ls,
                               int block, int any_hit, void* t_out,
                               void* prim_out, void* v_out, void* w_out,
                               void* inside_out, void* valid_out,
                               void* stream) {
  if (m <= 0) return 0;
  if (block <= 0 || block > MAX_THREADS || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(ls) * (ROW + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (m + block - 1) / block;
  pair_kernel<<<blocks, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const int32_t*>(chunk), static_cast<const float*>(tris),
      static_cast<const int32_t*>(prim), m, lm, ls, any_hit,
      static_cast<float*>(t_out), static_cast<int32_t*>(prim_out),
      static_cast<float*>(v_out), static_cast<float*>(w_out),
      static_cast<uint8_t*>(inside_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
