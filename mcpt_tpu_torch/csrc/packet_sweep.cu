// Per-ray BVH walk for Hopper (sm_90a), plain C ABI: kernel K5.
//
// K5 replaces no Pallas kernel.  It serves the reference's packet route,
// mcpt_tpu/ops/traversal.py::_intersect_packet (:454-623), whose 1024-lane
// packets with one shared stack are the TPU's stand-in for per-lane stacks
// (:455-461).  This kernel walks the same implicit BVH one ray a thread, in
// the order of the reference's per-lane walk (traversal.py::_traverse,
// :60-148), as its plain version ops/packet_sweep.py::packet_sweep_plain
// does, and repeats that version bit for bit in all six outputs.
//
// Contract: rays o, d [N,3], t_min, t_max [N] in the caller's (sorted)
// order; boxes [M/2, 12]: internal node i's children's boxes as one 48-byte
// record (min and max of child 2i+1, then of 2i+2; ops/packet_sweep.py::
// child_boxes); the leaves' rows tris [n_leaves, leaf_size, 12] (p0, e1,
// e2, opaque, ..), leaves from node n_leaves - 1.  Out: t, prim (a row of
// the packed table), v, w, inside, valid per ray.
//
// The walk: a ray's stack of node ids in a local array, starting at the
// root; a dead ray (t_min >= t_max) walks nothing.  While-while, as in
// Aila & Laine, "Understanding the Efficiency of Ray Traversal on GPUs" (HPG 2009): the
// ray walks internal nodes until it holds a leaf, then tests the leaf.
//   Internal node: one record read as three 16-byte __ldg loads; both
//     children slab-tested against [t_min, best t] (an inverted box, a
//     padding subtree, is a miss).  Both entered: push the far one and go
//     to the near one (c0 when t0 <= t1); one: go to it; none: pop.  That
//     is _traverse's order, which pushes far, then near, and pops.
//   Leaf: its rows read as 16-byte loads, tested by ray_tests.cuh's
//     Möller–Trumbore in index order, a hit kept only below the best t;
//     any-hit tests opaque rows only and ends the walk after the leaf
//     where it found a hit.
// Every lane keeps its own order, so the warps diverge and re-converge but
// no result depends on a neighbour; built with --fmad=false, the slab test
// and Möller–Trumbore round as the plain version's torch ops do.
//
// What bounds it: not the arithmetic (~27 fp32 operations a slab test, ~46
// a triangle test) nor the bytes (a ray's 32 bytes in, 18 out; the tree's
// boxes and rows are read from L2 and L1 by many rays).  A visit is a chain
// of dependent loads, a box record after the pop that names it, and the
// lanes of a warp take paths of other lengths.  The design hides latency
// with many small blocks (no barrier, no shuffle, no shared state) and
// keeps each step's bytes to one aligned 48-byte record.  A block is 256
// rays and a stack a per-thread local array (160 bytes, cached in L1):
// measured on an H100 against 128 rays a block and stacks in shared
// memory, it was the fastest of the four, by 1-6% of device time
// (PERF.md §6).  Tensor cores, TMA and wgmma have nothing to do here: the
// tests are scalar fp32 on data-dependent paths.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_tests.cuh"

namespace {

constexpr int MAX_LEAF = 32;   // ops/packet_sweep.py::MAX_LEAF
constexpr int MAX_STACK = 40;  // ops/packet_sweep.py::MAX_STACK
constexpr int BLOCK = 256;     // rays (threads) a block

// A child's box [x0 y0 z0, x1 y1 z1] tested as ray_tests.cuh's slab; an
// inverted box (a padding subtree) is a miss.
__device__ __forceinline__ bool child_hit(const mcpt::Ray& r, float rx,
                                          float ry, float rz, float tmin,
                                          float tmax, float x0, float y0,
                                          float z0, float x1, float y1,
                                          float z1, float& t_enter) {
  return !(x0 > x1) &&
         mcpt::slab(r, rx, ry, rz, tmin, tmax, x0, y0, z0, x1, y1, z1, t_enter);
}

__global__ void __launch_bounds__(BLOCK)
packet_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min, const float* __restrict__ t_max,
              const float4* __restrict__ boxes,
              const float4* __restrict__ tris, int n, int first_leaf,
              int leaf_size, int any_hit, float* __restrict__ t_out,
              int* __restrict__ prim_out, float* __restrict__ v_out,
              float* __restrict__ w_out, bool* __restrict__ inside_out,
              bool* __restrict__ valid_out) {
  int stack[MAX_STACK];

  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  const mcpt::Ray r{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                    d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const float tmin = t_min[i];
  float t_best = t_max[i];
  const float rx = mcpt::safe_rcp(r.dx), ry = mcpt::safe_rcp(r.dy),
              rz = mcpt::safe_rcp(r.dz);
  int prim = 0;
  float v = 0.f, w = 0.f;
  bool inside = false, valid = false;

  int sp = 0;
  int node = tmin < t_best ? 0 : -1;  // the root; -1: the walk is over
  while (node >= 0) {
    while (node < first_leaf) {
      const float4* rec = boxes + 3 * node;
      const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
      float t0, t1;
      const bool h0 = child_hit(r, rx, ry, rz, tmin, t_best, a.x, a.y, a.z,
                                a.w, b.x, b.y, t0);
      const bool h1 = child_hit(r, rx, ry, rz, tmin, t_best, b.z, b.w, c.x,
                                c.y, c.z, c.w, t1);
      const int c0 = 2 * node + 1;
      if (h0 && h1) {
        const bool near0 = t0 <= t1;
        stack[sp++] = near0 ? c0 + 1 : c0;
        node = near0 ? c0 : c0 + 1;
      } else if (h0 || h1) {
        node = h0 ? c0 : c0 + 1;
      } else if (sp > 0) {
        node = stack[--sp];
      } else {
        node = -1;
        break;
      }
    }
    if (node < 0) break;

    const int leaf = node - first_leaf;
    const float4* row = tris + 3 * static_cast<long long>(leaf) * leaf_size;
    for (int k = 0; k < leaf_size; ++k, row += 3) {
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
      if (any_hit && !(c.y > 0.5f)) continue;
      float tri[9];
      mcpt::unpack_row(a, b, c, tri);
      float t, tv, tw;
      bool back;
      if (mcpt::moller_trumbore(r, tri, tmin, t_best, t, tv, tw, back)) {
        t_best = t;
        prim = leaf * leaf_size + k;
        v = tv;
        w = tw;
        inside = back;
        valid = true;
      }
    }
    if ((any_hit && valid) || sp == 0) break;
    node = stack[--sp];
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  v_out[i] = v;
  w_out[i] = w;
  inside_out[i] = inside;
  valid_out[i] = valid;
}

}  // namespace

extern "C" int mcpt_packet_sweep(const void* o, const void* d,
                                 const void* t_min, const void* t_max,
                                 const void* boxes, const void* tris, int n,
                                 int n_leaves, int leaf_size, int any_hit,
                                 void* t_out, void* prim_out, void* v_out,
                                 void* w_out, void* inside_out,
                                 void* valid_out, void* stream) {
  if (n <= 0) return 0;
  int depth = 0;
  while ((1 << depth) < n_leaves) ++depth;
  if (n_leaves < 1 || (1 << depth) != n_leaves || leaf_size < 1 ||
      leaf_size > MAX_LEAF || depth + 2 > MAX_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + BLOCK - 1) / BLOCK;
  packet_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float4*>(boxes), static_cast<const float4*>(tris), n,
      n_leaves - 1, leaf_size, any_hit, static_cast<float*>(t_out),
      static_cast<int*>(prim_out), static_cast<float*>(v_out),
      static_cast<float*>(w_out), static_cast<bool*>(inside_out),
      static_cast<bool*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
