// Pair-scheduled traversal for Hopper (sm_90a), plain C ABI: the corridor
// kernel (K3) and the pair sweep (K4).
//
// K3 replaces mcpt_tpu/ops/pallas_pairs.py::_corridor_kernel (pallas_call
// at :310).  Per ray: the ids of the first K chunks whose AABB it enters
// within [t_min, t_max], in index order, to slots [N,K] int32 (Lm = none),
// and overflow [N] when a (K+1)-th passes.  No [N, Lm] array is written.
//
// What bounds K3: issue.  Each slab test is a chain of six shared loads
// and ~27 fp32 operations that issue one by one under --fmad=false.  The
// first design gave a ray one thread that walked all Lm boxes in series
// (1195 deep on the pairs scene), with ~16 warps an SM and dead rays
// riding along with live ones.  Now a warp owns a ray: the ray is uniform
// across the warp, lane L tests chunk base + L, and __ballot_sync gives
// that step's passing chunks in index order, so a lane's slot is
// found + popc(mask & lanes below it) and a ray's slots are written
// together; when found passes K the ray overflows and the warp, with no
// divergence, takes its next ray.  Rays with t_max < t_min pass no box
// and are not tested (t_max == t_min can pass).
//
// Each block stages the boxes once as six structure-of-arrays rows of a
// constant stride (cp.async, so that 32 lanes read 32 consecutive floats
// with no bank conflict, and one address serves the six loads) and
// builds from them the union box of every 32 consecutive chunks (one
// ballot's worth).  A ray first tests 32 unions a step, then walks the
// passing ones in order and tests their 32 chunks: ceil(Lm / 1024) +
// (passing unions) steps instead of Lm / 32.  The cull changes no output
// bit: a union box contains each of its chunk boxes, IEEE subtraction and
// multiplication round monotonically, and safe_rcp never yields an
// infinity or 0 (no inf * 0 arises), so each of the union's per-axis
// slab intervals contains the chunk's, its t_near is no larger and its
// t_far no smaller (min and max are exact); hence t_enter(union) <=
// t_enter(chunk) <= t_exit(chunk) <= t_exit(union) and t_enter(union) <
// 1e30 whenever the chunk passes chunk_entry.  Measured on the pairs
// scene's bounce rays, the cull makes the kernel ~5x faster (PERF.md).
//
// The grid is persistent (every block stages the boxes once), and a
// block's rays are handed to its warps as they come free: per-ray work is
// skewed (most rays pass no union, a few walk many), and a fixed share
// per warp left the last warps running long after the median one.  Boxes
// beyond TILE chunks are staged tile by tile: a ray's running count
// lives in its overflow byte between tiles, read back after the block's
// barrier by whichever of its warps takes the ray next.

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
// (ray_tests.cuh): slots and overflow are equal, and every hit output is
// bit-equal.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int CORRIDOR_THREADS = 512;
constexpr int CORRIDOR_WARPS = CORRIDOR_THREADS / 32;
constexpr int UNION = 32;          // K3: chunks per union box, one ballot
constexpr int TILE = 2048;         // K3: chunks staged per tile
constexpr int UNITS = TILE / UNION;  // K3: unions per tile
constexpr int MAX_K = 14;          // K3: slots per ray, as the reference
constexpr int MAX_THREADS = 1024;
constexpr int PIECE = 128;  // K4: rows a warp stages at a time (6 KB)
constexpr unsigned FULL = 0xffffffffu;
// a tile holds whole 32-union ballots, so the ballots of every tile start
// at a multiple of 32 unions, as if the boxes were not tiled
static_assert(UNITS % 32 == 0, "TILE must hold whole ballots");
// shared memory of a K3 block: six rows of TILE chunk bounds, then six
// rows of UNITS union bounds (50,688 bytes)
constexpr size_t CORRIDOR_SMEM = sizeof(float) * 6 * (TILE + UNITS);

// Whether the ray enters box i of six structure-of-arrays rows of STRIDE
// within [tmin, tmax]: chunk_entry's verdict.  The stride is a constant,
// so the six shared loads share one address.
template <int STRIDE>
__device__ __forceinline__ bool enters(const mcpt::Ray& r, float rx, float ry,
                                       float rz, float tmin, float tmax,
                                       const float* rows, int i) {
  const float bmin[3] = {rows[i], rows[STRIDE + i], rows[2 * STRIDE + i]};
  const float bmax[3] = {rows[3 * STRIDE + i], rows[4 * STRIDE + i],
                         rows[5 * STRIDE + i]};
  return mcpt::chunk_entry(r, rx, ry, rz, tmin, tmax, bmin, bmax) < INFINITY;
}

__global__ void __launch_bounds__(CORRIDOR_THREADS)
corridor_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_min,
                const float* __restrict__ t_max,
                const float* __restrict__ cmin,
                const float* __restrict__ cmax, int n, int lm, int k,
                int32_t* __restrict__ slots, uint8_t* __restrict__ overflow) {
  __shared__ int taken;           // the block's rays handed out
  extern __shared__ float box[];  // [6][TILE] chunks, then [6][UNITS] unions
  float* ubox = box + 6 * TILE;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int t0 = 0;
  do {
    const int count = min(TILE, lm - t0);
    const int units = (count + UNION - 1) / UNION;
    const bool first = t0 == 0, last = t0 + TILE >= lm;
    __syncthreads();  // the previous tile is consumed, its counts written
    for (int i = threadIdx.x; i < 3 * count; i += CORRIDOR_THREADS) {
      const int c = i / 3, a = i - 3 * c;
      const size_t g = 3 * static_cast<size_t>(t0) + i;
      mcpt::cp_async4(&box[a * TILE + c], cmin + g);
      mcpt::cp_async4(&box[(3 + a) * TILE + c], cmax + g);
    }
    mcpt::cp_async_commit();
    mcpt::cp_async_wait_all();
    __syncthreads();
    // each warp reduces whole unions; min and max are exact
    for (int u = threadIdx.x >> 5; u < units; u += CORRIDOR_WARPS) {
      const int c = UNION * u + lane;
      float v[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        v[a] = c < count ? box[a * TILE + c] : (a < 3 ? INFINITY : -INFINITY);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float w = __shfl_xor_sync(FULL, v[a], off);
          v[a] = a < 3 ? fminf(v[a], w) : fmaxf(v[a], w);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) ubox[a * UNITS + u] = v[a];
      }
    }
    if (threadIdx.x == 0) taken = 0;
    __syncthreads();

    // the block's rays are blockIdx.x + j * gridDim.x, the same in every
    // tile; its warps take the next j as they come free
    for (;;) {
      const int j = lane == 0 ? atomicAdd(&taken, 1) : 0;
      const unsigned next = blockIdx.x + __shfl_sync(FULL, j, 0) * gridDim.x;
      if (next >= static_cast<unsigned>(n)) break;
      const int ray = static_cast<int>(next);
      // the ray's running count; K + 1 = overflowed
      int found = first ? 0 : overflow[ray];
      const float tmin = t_min[ray], tmax = t_max[ray];
      const mcpt::Ray r{o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                        d[3 * ray], d[3 * ray + 1], d[3 * ray + 2]};
      if (found <= k && !(tmax < tmin)) {
        // lanes 0, 1, 2 take one reciprocal each
        const float mine =
            mcpt::safe_rcp(lane == 0 ? r.dx : lane == 1 ? r.dy : r.dz);
        const float rx = __shfl_sync(FULL, mine, 0),
                    ry = __shfl_sync(FULL, mine, 1),
                    rz = __shfl_sync(FULL, mine, 2);
        int32_t* row = slots + static_cast<size_t>(ray) * k;
        // lanes past the last union or chunk test the rows' unwritten
        // tail (in bounds: units <= UNITS) and are masked out
        for (int ub = 0; ub < units && found <= k; ub += 32) {
          const int u = ub + lane;
          unsigned todo = __ballot_sync(
              FULL, (u < units) &
                        enters<UNITS>(r, rx, ry, rz, tmin, tmax, ubox, u));
          while (todo) {
            const int c = UNION * (ub + __ffs(todo) - 1) + lane;
            todo &= todo - 1u;
            const bool pass = (c < count) &
                              enters<TILE>(r, rx, ry, rz, tmin, tmax, box, c);
            const unsigned m = __ballot_sync(FULL, pass);
            const int slot = found + __popc(m & below);
            if (pass && slot < k) row[slot] = t0 + c;
            found += __popc(m);
            if (found > k) break;
          }
        }
      }
      found = min(found, k + 1);
      if (last) {
        if (lane >= found && lane < k)
          slots[static_cast<size_t>(ray) * k + lane] = lm;
        if (lane == 0) overflow[ray] = found > k ? 1 : 0;
      } else if (lane == 0) {
        overflow[ray] = static_cast<uint8_t>(found);
      }
    }
    t0 += TILE;
  } while (t0 < lm);
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

// Chunks a K3 block stages at a time: Lm above it is taken tile by tile.
extern "C" int mcpt_corridor_tile() { return TILE; }

// Both launch on `stream` (PyTorch's current stream), allocate nothing and
// do not synchronise; each returns cudaGetLastError() as an int.

extern "C" int mcpt_corridor(const void* o, const void* d, const void* t_min,
                             const void* t_max, const void* cmin,
                             const void* cmax, int n, int lm, int k,
                             void* slots, void* overflow, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > MAX_K || lm < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // persistent: every block stages the boxes once, so no more blocks than
  // fit the card at once (asked once per device: the queries cost more
  // host time than the launch), nor than rays for their warps
  thread_local int cached_device = -1, cached_blocks = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device != cached_device) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(corridor_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(CORRIDOR_SMEM));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, corridor_kernel, CORRIDOR_THREADS, CORRIDOR_SMEM);
    if (e == cudaSuccess) {
      cached_device = device;
      cached_blocks = std::max(1, per_sm) * sms;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks =
      std::min((n + CORRIDOR_WARPS - 1) / CORRIDOR_WARPS, cached_blocks);
  corridor_kernel<<<blocks, CORRIDOR_THREADS, CORRIDOR_SMEM,
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
