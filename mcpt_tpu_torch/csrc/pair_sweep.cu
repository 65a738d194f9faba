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
// [M] int32 (Lm = dead), sorted by chunk; the chunk pack tris [Lm,ls,12]
// and prim [Lm,ls].  Out: t, prim, v, w, inside, valid per pair: the
// nearest hit among the pair's own chunk's ls triangles.
//
// What bounds K4: the latency of the longest chains of dependent tests.
// The work is small (~46 fp32 operations per live pair x triangle) and the
// bytes smaller still, but the pairs of one block can name dozens of
// distinct chunks (74 in 512 sorted bounce pairs; 12 in 32), and the
// first design had the one or two threads of a chunk test its 128
// triangles in series while the rest of the block waited.  So the work
// of one pair is spread, not the pairs: a warp owns 32 consecutive pairs
// and visits their distinct chunk ids, smallest first, with warp
// reductions only (no block barrier).  At each chunk the warp stages its
// rows (up to PIECE at a time) in its own slice of shared memory with
// coalesced cp.async copies, then takes the chunk's pairs two at a time:
// lane L tests rows L, L + 32, ... (conflict-free 16-byte shared loads,
// each serving both pairs) against each pair's t_max, keeping only
// (t, index), and a warp min over (t, index) picks each pair's winner.
// A pair's chain is ls / 32 tests deep.  At the end each lane tests its
// own pair's winner once more for v, w and its face.  Reading the rows
// straight from L2 instead, with no staging, measured as fast on closest
// hits of bounce pairs but 12% slower on any hits and 27% slower over a
// pairs frame (PERF.md).  Any ls works (chunks above PIECE rows are
// staged piece by piece); dead pairs, and warps of them, do no tests.
// Closest hit and any hit are compiled apart.
//
// Both repeat their plain versions (ops/pair_sweep.py) op for op
// (ray_tests.cuh): slots are equal, and every hit output is bit-equal.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int CORRIDOR_THREADS = 256;
constexpr int BOX_TILE = 256;  // chunk AABBs staged per tile
constexpr int MAX_THREADS = 1024;
constexpr int PIECE = 128;  // K4: rows a warp stages at a time (6 KB)
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

// Lexicographic min over (t, k) across the warp: every lane ends with the
// same (t, k), so the lowest index wins among equal t.  Float compares, so
// -0 and +0 are equal as they are to torch.min.
__device__ __forceinline__ void warp_min_tk(float& t, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL, t, off);
    const int ok = __shfl_xor_sync(FULL, k, off);
    if (ot < t || (ot == t && ok < k)) {
      t = ot;
      k = ok;
    }
  }
}

// Copy `rows` packed rows (3 float4 each) into the warp's staging buffer:
// consecutive lanes copy consecutive 16-byte pieces, so the warp's reads
// are coalesced; the buffer's readers are done before and see every piece
// after.
__device__ __forceinline__ void stage_rows(float4* dst, const float4* src,
                                           int rows, int lane) {
  __syncwarp();
  for (int i = lane; i < 3 * rows; i += 32) mcpt::cp_async16(dst + i, src + i);
  mcpt::cp_async_commit();
  mcpt::cp_async_wait_all();
  __syncwarp();
}

template <bool ANY>
__global__ void __launch_bounds__(MAX_THREADS)
pair_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_min, const float* __restrict__ t_max,
            const int32_t* __restrict__ chunk,
            const float* __restrict__ tris, const int32_t* __restrict__ prim,
            int m, int lm, int ls,
            float* __restrict__ t_out, int32_t* __restrict__ prim_out,
            float* __restrict__ v_out, float* __restrict__ w_out,
            uint8_t* __restrict__ inside_out,
            uint8_t* __restrict__ valid_out) {
  extern __shared__ float4 staged[];  // PIECE rows per warp
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float4* rows = staged + (threadIdx.x >> 5) * 3 * PIECE;
  const bool in_range = pair < m;
  int own = lm;
  float tmin = 0.f, t_res = 0.f;
  if (in_range) {
    own = chunk[pair];
    t_res = t_max[pair];
  }
  // the chunk this pair still has to sweep; lm = none (dead or done)
  int rem = lm;
  mcpt::Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  if (own >= 0 && own < lm) {
    tmin = t_min[pair];
    if (t_res > tmin) {
      rem = own;
      r = mcpt::Ray{o[3 * pair], o[3 * pair + 1], o[3 * pair + 2],
                    d[3 * pair], d[3 * pair + 1], d[3 * pair + 2]};
    }
  }
  int k_res = -1;  // the pair's nearest triangle in its chunk; -1 = none
  const int pieces = (ls + PIECE - 1) / PIECE;

  // The warp's distinct chunk ids, smallest first (any pair order is right,
  // a sorted one gives few); a warp of dead pairs leaves at once.
  for (int cur = __reduce_min_sync(FULL, rem); cur < lm;
       cur = __reduce_min_sync(FULL, rem)) {
    const float4* src = reinterpret_cast<const float4*>(
        tris + static_cast<size_t>(cur) * ls * ROW);
    if (pieces == 1) stage_rows(rows, src, ls, lane);
    unsigned todo = __ballot_sync(FULL, rem == cur);
    while (todo) {
      // the next two pairs of this chunk (j2 = j1 when one is left), tested
      // by the whole warp: lane L takes rows L, L + 32, ... in index order
      // against each pair's t_max; a row read serves both pairs
      const int j1 = __ffs(todo) - 1;
      todo &= todo - 1;
      const int j2 = todo ? __ffs(todo) - 1 : j1;
      todo &= todo - 1;
      const mcpt::Ray r1{__shfl_sync(FULL, r.ox, j1), __shfl_sync(FULL, r.oy, j1),
                         __shfl_sync(FULL, r.oz, j1), __shfl_sync(FULL, r.dx, j1),
                         __shfl_sync(FULL, r.dy, j1), __shfl_sync(FULL, r.dz, j1)};
      const mcpt::Ray r2{__shfl_sync(FULL, r.ox, j2), __shfl_sync(FULL, r.oy, j2),
                         __shfl_sync(FULL, r.oz, j2), __shfl_sync(FULL, r.dx, j2),
                         __shfl_sync(FULL, r.dy, j2), __shfl_sync(FULL, r.dz, j2)};
      const float lo1 = __shfl_sync(FULL, tmin, j1), lo2 = __shfl_sync(FULL, tmin, j2);
      float t1 = __shfl_sync(FULL, t_res, j1), t2 = __shfl_sync(FULL, t_res, j2);
      int k1 = INT_MAX, k2 = INT_MAX;
      for (int base = 0; base < ls; base += PIECE) {
        const int count = min(PIECE, ls - base);
        if (pieces > 1) stage_rows(rows, src + 3 * base, count, lane);
#pragma unroll 2
        for (int k = lane; k < count; k += 32) {
          const float4 a = rows[3 * k], b = rows[3 * k + 1], c = rows[3 * k + 2];
          if (ANY && !(c.y > 0.5f)) continue;  // opaque flag, float 9
          float tri[9];
          mcpt::unpack_row(a, b, c, tri);
          // only (t, index) is kept: v, w and the face of each pair's
          // winner are recomputed once, at the end, by the same arithmetic
          float t, v, w;
          bool back;
          if (mcpt::moller_trumbore(r1, tri, lo1, t1, t, v, w, back)) {
            t1 = t;
            k1 = base + k;
          }
          if (mcpt::moller_trumbore(r2, tri, lo2, t2, t, v, w, back)) {
            t2 = t;
            k2 = base + k;
          }
        }
      }
      warp_min_tk(t1, k1);
      warp_min_tk(t2, k2);
      if (lane == j1 && k1 != INT_MAX) {
        t_res = t1;
        k_res = k1;
      }
      if (lane == j2 && k2 != INT_MAX) {
        t_res = t2;
        k_res = k2;
      }
    }
    if (rem == cur) rem = lm;
  }

  if (!in_range) return;
  int32_t prim_res = 0;
  float v_res = 0.f, w_res = 0.f;
  bool in_res = false;
  if (k_res >= 0) {
    const size_t row = static_cast<size_t>(own) * ls + k_res;
    const float4* q = reinterpret_cast<const float4*>(tris + row * ROW);
    float tri[9], t;
    mcpt::unpack_row(__ldg(q), __ldg(q + 1), __ldg(q + 2), tri);
    mcpt::moller_trumbore(r, tri, tmin, t_res, t, v_res, w_res, in_res);
    prim_res = prim[row];
  }
  t_out[pair] = t_res;
  prim_out[pair] = prim_res;
  v_out[pair] = v_res;
  w_out[pair] = w_res;
  inside_out[pair] = in_res ? 1 : 0;
  valid_out[pair] = k_res >= 0 ? 1 : 0;
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
  if (ls <= 0 || block <= 0 || block > MAX_THREADS || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tris) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);  // rows read as float4
  auto kernel = any_hit ? pair_kernel<true> : pair_kernel<false>;
  const size_t smem = static_cast<size_t>(block / 32) * 3 * PIECE * 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (m + block - 1) / block;
  kernel<<<blocks, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const int32_t*>(chunk), static_cast<const float*>(tris),
      static_cast<const int32_t*>(prim), m, lm, ls,
      static_cast<float*>(t_out), static_cast<int32_t*>(prim_out),
      static_cast<float*>(v_out), static_cast<float*>(w_out),
      static_cast<uint8_t*>(inside_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
