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
// What bounds it on the card: instruction issue.  A (ray, triangle) test
// is 45 fp32 adds and multiplies, an IEEE division (~11 instructions with
// its range check), 7 compares and 2 selects: ~72 SASS instructions a test
// in the sweep loop (tools/sass_count.py), and the build keeps every
// multiply and add apart (--fmad=false, below), so no bit-equal kernel
// gets near the FMA-peak bound; at one warp instruction a cycle on each
// scheduler the floor is ~3.4x that bound.  The table (<= 16384 triangles
// = 768 KB) sits in L2 and device memory is touched about once per ray.
// The first design ran one thread per ray, 256 rays a block: 16 warps an
// SM at 65536 rays, too few to hide one dependent test chain per thread,
// each test reading its row as ten scalar shared loads and carrying six
// best-hit values.  This one:
//   * splits each ray's triangles over S slices (split-K): warp w of the
//     block works on slice w % S of every tile, so S times as many warps
//     are in flight for the same rays;
//   * gives each thread a packet of P rays (lanes L and L + 32 of its ray
//     group), so one row read serves P tests and their chains interleave;
//   * stages the table in tiles of 32 triangles a slice, double-buffered:
//     cp.async copies the next tile while this one is tested (one barrier
//     a tile), and a row is read as 16-byte shared loads (a broadcast:
//     every lane of a warp reads the same row);
//   * keeps only (t, index) of the best hit in the loop, and tests each
//     ray's winner once more at the end for v, w and its face;
//   * is compiled apart for closest hit and any hit, so that the closest-
//     hit loop has no opacity test.
// S and P are template parameters, picked at launch by one int
// (10 * S + P); the wrapper picks them by the table's size
// (ops/dense_sweep.py::shape_for), chip_smoke sweeps them.
//
// Tie rule: a slice scans its triangles in increasing index order and
// takes a hit only if t < t_best (strict), starting from t_max; the slices
// of a ray are then combined through shared memory by the lexicographic
// min over (t, index).  Together that is the reference's chunked
// min-reduce exactly: among equal t the lowest index wins, and a hit at
// exactly t_max is not taken.  Lanes with t_max <= t_min (dead lanes get
// t_max = 0) cannot take a hit; a thread whose rays are all dead skips the
// tests, and a block whose rays are all dead skips the sweep.
//
// Arithmetic (ray_tests.cuh): built with --fmad=false and without fast
// math, so every multiply and add rounds on its own, in the same order as
// the plain PyTorch version (ops/dense_sweep.py::dense_sweep_plain) — the
// two agree bit for bit, and the winner's second test repeats its first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "ray_tests.cuh"

namespace {

constexpr int THREADS = 256;  // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int SLICE_TILE = 32;  // triangles a slice takes from each tile

// Row `k` of the packed table as the nine floats a test reads.
__device__ __forceinline__ void load_row(const float* tris, int k,
                                         float tri[9]) {
  const float4* q = reinterpret_cast<const float4*>(tris) + 3 * static_cast<size_t>(k);
  mcpt::unpack_row(__ldg(q), __ldg(q + 1), __ldg(q + 2), tri);
}

template <int S, int P, bool ANY>
__global__ void __launch_bounds__(THREADS)
dense_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_min,
                   const float* __restrict__ t_max,
                   const float* __restrict__ tris, int n, int p,
                   float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                   float* __restrict__ v_out, float* __restrict__ w_out,
                   uint8_t* __restrict__ inside_out,
                   uint8_t* __restrict__ valid_out) {
  static_assert(WARPS % S == 0, "slices must divide the block's warps");
  constexpr int TILE = SLICE_TILE * S;  // triangles staged per tile
  constexpr int VECS = 3 * TILE;        // float4 per tile (a row is 3)
  constexpr int RAYS = WARPS / S * 32 * P;  // rays per block

  __shared__ float4 tile[2][VECS];
  // each slice's nearest (t, index) per ray of the block; index -1 = none
  __shared__ float comb_t[S][RAYS];
  __shared__ int32_t comb_k[S][RAYS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp % S;
  const int first = warp / S * 32 * P + lane;  // ray i of the thread: + 32 i

  mcpt::Ray r[P];
  float tmin[P], t_best[P];
  int32_t k_best[P];
  bool any_live = false;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int ray = blockIdx.x * RAYS + first + 32 * i;
    r[i] = mcpt::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
    tmin[i] = 0.f;
    t_best[i] = 0.f;
    k_best[i] = -1;
    if (ray < n) {
      tmin[i] = t_min[ray];
      t_best[i] = t_max[ray];
      if (t_best[i] > tmin[i]) {
        r[i] = mcpt::Ray{o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                         d[3 * ray], d[3 * ray + 1], d[3 * ray + 2]};
        any_live = true;
      }
    }
  }

  if (__syncthreads_or(any_live)) {
    const float4* src = reinterpret_cast<const float4*>(tris);
    auto copy = [&](int buf, int base) {  // tile at `base` into `buf`
      const int vecs = 3 * min(TILE, p - base);
      for (int i = threadIdx.x; i < vecs; i += THREADS)
        mcpt::cp_async16(&tile[buf][i], src + 3 * static_cast<size_t>(base) + i);
      mcpt::cp_async_commit();
    };
    const int tiles = (p + TILE - 1) / TILE;
    if (tiles > 0) copy(0, 0);
    for (int it = 0; it < tiles; ++it) {
      const int base = it * TILE;
      mcpt::cp_async_wait_all();
      // tile `it` has landed for every thread, and every thread is done
      // with tile it - 1, whose buffer the next copy overwrites
      __syncthreads();
      if (it + 1 < tiles) copy((it + 1) & 1, base + TILE);
      if (!any_live) continue;
      const int lo = slice * SLICE_TILE;
      const int hi = min(lo + SLICE_TILE, p - base);
      const float4* rows = tile[it & 1];
#pragma unroll 4
      for (int k = lo; k < hi; ++k) {
        const float4 a = rows[3 * k], b = rows[3 * k + 1], c = rows[3 * k + 2];
        if (ANY && !(c.y > 0.5f)) continue;  // opaque flag, float 9
        float tri[9];
        mcpt::unpack_row(a, b, c, tri);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          float t, v, w;
          bool back;
          // only (t, index) is kept: v, w and the face of the winner are
          // recomputed once, below, by the same arithmetic
          if (mcpt::moller_trumbore(r[i], tri, tmin[i], t_best[i], t, v, w,
                                    back)) {
            t_best[i] = t;
            k_best[i] = base + k;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < P; ++i) {
    comb_t[slice][first + 32 * i] = t_best[i];
    comb_k[slice][first + 32 * i] = k_best[i];
  }
  __syncthreads();
  // (t, index) lexicographic min over the slices, then the winner's test
  // again for v, w and its face; with no hit anywhere, slice 0's record
  // (t = t_max, index -1) stands
  for (int q = threadIdx.x; q < RAYS; q += THREADS) {
    const int ray = blockIdx.x * RAYS + q;
    if (ray >= n) continue;
    float t = comb_t[0][q];
    int32_t k = comb_k[0][q];
#pragma unroll
    for (int s = 1; s < S; ++s) {
      const float ts = comb_t[s][q];
      const int32_t ks = comb_k[s][q];
      if (ks >= 0 && (k < 0 || ts < t || (ts == t && ks < k))) {
        t = ts;
        k = ks;
      }
    }
    float v = 0.f, w = 0.f;
    bool back = false;
    if (k >= 0) {
      const mcpt::Ray rr{o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                         d[3 * ray], d[3 * ray + 1], d[3 * ray + 2]};
      float tri[9], t2;
      load_row(tris, k, tri);
      mcpt::moller_trumbore(rr, tri, 0.f, 0.f, t2, v, w, back);
    }
    t_out[ray] = t;
    prim_out[ray] = k >= 0 ? k : 0;
    v_out[ray] = v;
    w_out[ray] = w;
    inside_out[ray] = back ? 1 : 0;
    valid_out[ray] = k >= 0 ? 1 : 0;
  }
}

template <int S, int P>
int launch(const void* o, const void* d, const void* t_min, const void* t_max,
           const void* tris, int n, int p, int any_hit, void* t_out,
           void* prim_out, void* v_out, void* w_out, void* inside_out,
           void* valid_out, void* stream) {
  constexpr int rays = WARPS / S * 32 * P;
  const int blocks = (n + rays - 1) / rays;
  auto kernel = any_hit ? dense_sweep_kernel<S, P, true>
                        : dense_sweep_kernel<S, P, false>;
  kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float*>(tris), n, p, static_cast<float*>(t_out),
      static_cast<int32_t*>(prim_out), static_cast<float*>(v_out),
      static_cast<float*>(w_out), static_cast<uint8_t*>(inside_out),
      static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, passed as an integer
// handle); allocates nothing, does not synchronise.  `shape` = 10 * S + P
// picks the slices per ray (S in 1, 2, 4, 8) and the rays per thread (P in
// 1, 2); `tris` must be 16-byte aligned.  Returns the launch's
// cudaGetLastError() as an int (0 = launched).
extern "C" int mcpt_dense_sweep(const void* o, const void* d,
                                const void* t_min, const void* t_max,
                                const void* tris, int n, int p, int any_hit,
                                int shape, void* t_out, void* prim_out,
                                void* v_out, void* w_out, void* inside_out,
                                void* valid_out, void* stream) {
  if (n <= 0) return 0;
  if (p < 0 || reinterpret_cast<uintptr_t>(tris) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define MCPT_DENSE_CASE(S, P)                                               \
  case 10 * S + P:                                                          \
    return launch<S, P>(o, d, t_min, t_max, tris, n, p, any_hit, t_out,     \
                        prim_out, v_out, w_out, inside_out, valid_out, stream);
  switch (shape) {
    MCPT_DENSE_CASE(1, 1)
    MCPT_DENSE_CASE(1, 2)
    MCPT_DENSE_CASE(2, 1)
    MCPT_DENSE_CASE(2, 2)
    MCPT_DENSE_CASE(4, 1)
    MCPT_DENSE_CASE(4, 2)
    MCPT_DENSE_CASE(8, 1)
    MCPT_DENSE_CASE(8, 2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MCPT_DENSE_CASE
}
