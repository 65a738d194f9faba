// Block march over SAH chunks for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel mcpt_tpu/ops/pallas_march.py::_march_kernel
// (pallas_call at :502, wrapper ops/traversal.py::_intersect_march_pallas).
// Contract, not layout: rays come in as o, d [N,3] and t_min, t_max [N],
// sorted by the wrapper so that each block's rays share chunks; chunks as
// AABBs cmin, cmax [Lm,3], triangle rows tris [Lm,ls,12] (p0, e1, e2,
// opaque, ..) and global prim ids prim [Lm,ls] int32.  Out: t, prim, v, w,
// inside, valid per ray — the GeomHit of ops/traversal.py.
//
// One block is blockDim.x rays, one thread each.
//   Phase A: the chunk AABBs pass through shared memory in tiles; each
//     thread slab-tests its ray against every chunk, and the block-min
//     entry of each chunk lands in ent[Lm] (shared): a warp-shuffle min,
//     then atomicMin on the float's int bits — valid because every entry
//     is >= +0 or +inf.  Warps none of whose rays enter a chunk skip the
//     reduction.
//   Phase B: repeatedly take the chunk with the smallest block-min entry
//     (lowest index among equal, as pallas_march.py:331) while that entry
//     is below the block's largest live bound (a lane's best t; 0 for an
//     any-hit lane that has its hit), stage its ls rows and prim ids in
//     shared memory, and let each live lane test them — but only if its own
//     slab entry into that chunk is below its best t, which is exactly the
//     per-lane test of the plain version (ops/march_sweep.py), so each lane
//     sweeps the chunks the plain version sweeps.  Any-hit lanes stop once
//     they have a hit.  The super-chunk cull of the TPU kernel gives the
//     same hits on and off and is left out (PERF.md).
// A block whose lanes all have t_max <= t_min skips both phases.
//
// What bounds it on the card: fp32 ALU work in phase B (~46 operations per
// ray x triangle, against 48 bytes of triangle data that all the block's
// rays read from shared memory as broadcasts) and, for many thin chunks,
// the phase-A slab tests (N x Lm).  The table is read once per visited
// chunk per block and stays in L2.  Ties: rows are scanned in index order
// with a strict t < t_best, so t is bit-equal to the plain version's; a
// prim may differ only where two triangles give the same t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int MAX_THREADS = 1024;
constexpr int BOX_TILE = 256;  // chunk AABBs staged per phase-A tile
constexpr unsigned FULL = 0xffffffffu;

struct Pick {
  float te;     // smallest block-min entry left
  int ci;       // its chunk (lowest index among equal)
  float bound;  // largest lane bound of the block
};

// Block-wide argmin over ent[0..lm) and max over each thread's `cap`.
// Every thread of the block must call it.
__device__ Pick block_pick(const float* ent, int lm, float cap, float* red_v,
                           int* red_i, float* red_c, Pick* out) {
  float m = INFINITY;
  int mi = lm;
  for (int c = threadIdx.x; c < lm; c += blockDim.x) {
    const float e = ent[c];
    if (e < m) {  // c ascends: the first index among equal is kept
      m = e;
      mi = c;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(FULL, m, off);
    const int oi = __shfl_down_sync(FULL, mi, off);
    const float oc = __shfl_down_sync(FULL, cap, off);
    if (om < m || (om == m && oi < mi)) {
      m = om;
      mi = oi;
    }
    cap = fmaxf(cap, oc);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_v[warp] = m;
    red_i[warp] = mi;
    red_c[warp] = cap;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    m = lane < nw ? red_v[lane] : INFINITY;
    mi = lane < nw ? red_i[lane] : lm;
    cap = lane < nw ? red_c[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_down_sync(FULL, m, off);
      const int oi = __shfl_down_sync(FULL, mi, off);
      const float oc = __shfl_down_sync(FULL, cap, off);
      if (om < m || (om == m && oi < mi)) {
        m = om;
        mi = oi;
      }
      cap = fmaxf(cap, oc);
    }
    if (lane == 0) *out = Pick{m, mi, cap};
  }
  __syncthreads();
  return *out;
}

__global__ void __launch_bounds__(MAX_THREADS)
march_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_min, const float* __restrict__ t_max,
             const float* __restrict__ cmin, const float* __restrict__ cmax,
             const float* __restrict__ tris, const int32_t* __restrict__ prim,
             int n, int lm, int ls, int any_hit,
             float* __restrict__ t_out, int32_t* __restrict__ prim_out,
             float* __restrict__ v_out, float* __restrict__ w_out,
             uint8_t* __restrict__ inside_out,
             uint8_t* __restrict__ valid_out) {
  extern __shared__ float smem[];
  float* ent = smem;            // [lm] block-min entry per chunk
  float* stage = smem + lm;     // phase A: [BOX_TILE][6] boxes;
  int32_t* prim_s =             // phase B: [ls][12] rows, then [ls] ids
      reinterpret_cast<int32_t*>(stage + ls * ROW);
  __shared__ float red_v[32], red_c[32];
  __shared__ int red_i[32];
  __shared__ Pick pick;

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
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
  const bool live = in_range && (tmax > tmin);
  float t_best = tmax;

  int32_t prim_best = 0;
  float v_best = 0.f, w_best = 0.f;
  bool in_best = false, valid = false;

  if (__syncthreads_or(live)) {
    // ---- phase A: block-min entry per chunk
    for (int c = threadIdx.x; c < lm; c += blockDim.x) ent[c] = INFINITY;
    const int lane = threadIdx.x & 31;
    for (int base = 0; base < lm; base += BOX_TILE) {
      const int count = min(BOX_TILE, lm - base);
      __syncthreads();  // ent initialised / previous tile consumed
      for (int i = threadIdx.x; i < count * 3; i += blockDim.x) {
        const int c = i / 3, a = i - 3 * c;
        stage[6 * c + a] = cmin[3 * base + i];
        stage[6 * c + 3 + a] = cmax[3 * base + i];
      }
      __syncthreads();
      for (int c = 0; c < count; ++c) {
        float e = live ? mcpt::chunk_entry(r, rx, ry, rz, tmin, tmax,
                                           &stage[6 * c], &stage[6 * c + 3])
                       : INFINITY;
        if (__any_sync(FULL, e < INFINITY)) {
          for (int off = 16; off > 0; off >>= 1)
            e = fminf(e, __shfl_xor_sync(FULL, e, off));
          if (lane == 0)
            atomicMin(reinterpret_cast<int*>(&ent[base + c]),
                      __float_as_int(e));
        }
      }
    }
    __syncthreads();

    // ---- phase B: nearest chunk first
    while (true) {
      const float cap =
          !in_range ? -INFINITY : ((any_hit && valid) ? 0.f : t_best);
      const Pick p = block_pick(ent, lm, cap, red_v, red_i, red_c, &pick);
      if (!(p.te < p.bound)) break;
      if (threadIdx.x == 0) ent[p.ci] = INFINITY;
      const float* src = tris + static_cast<size_t>(p.ci) * ls * ROW;
      for (int i = threadIdx.x; i < ls * ROW; i += blockDim.x) stage[i] = src[i];
      const int32_t* psrc = prim + static_cast<size_t>(p.ci) * ls;
      for (int i = threadIdx.x; i < ls; i += blockDim.x) prim_s[i] = psrc[i];
      __syncthreads();
      if (live && !(any_hit && valid) &&
          mcpt::chunk_entry(r, rx, ry, rz, tmin, tmax, &cmin[3 * p.ci],
                            &cmax[3 * p.ci]) < t_best) {
        for (int k = 0; k < ls; ++k) {
          const float* tri = &stage[k * ROW];
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
      }
      // the next block_pick's barrier keeps the rows until every lane is done
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

// Dynamic shared memory of one block (ops/march_sweep.py::smem_bytes).
static size_t march_smem_bytes(int lm, int ls) {
  const int region = BOX_TILE * 6 > ls * (ROW + 1) ? BOX_TILE * 6 : ls * (ROW + 1);
  return sizeof(float) * (static_cast<size_t>(lm) + region);
}

// Launches on `stream` (PyTorch's current stream); allocates nothing, does
// not synchronise.  `block` rays per block, a multiple of 32 up to 1024.
// Returns cudaGetLastError() as an int (0 = launched).
extern "C" int mcpt_march_sweep(const void* o, const void* d,
                                const void* t_min, const void* t_max,
                                const void* cmin, const void* cmax,
                                const void* tris, const void* prim, int n,
                                int lm, int ls, int block, int any_hit,
                                void* t_out, void* prim_out, void* v_out,
                                void* w_out, void* inside_out,
                                void* valid_out, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0 || block > MAX_THREADS || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = march_smem_bytes(lm, ls);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + block - 1) / block;
  march_kernel<<<blocks, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float*>(cmin), static_cast<const float*>(cmax),
      static_cast<const float*>(tris), static_cast<const int32_t*>(prim), n,
      lm, ls, any_hit, static_cast<float*>(t_out),
      static_cast<int32_t*>(prim_out), static_cast<float*>(v_out),
      static_cast<float*>(w_out), static_cast<uint8_t*>(inside_out),
      static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
