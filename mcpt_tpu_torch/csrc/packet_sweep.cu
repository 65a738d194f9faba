// Packet BVH walk for Hopper (sm_90a), plain C ABI: kernel K5.
//
// K5 replaces no Pallas kernel.  It is the reference's XLA traversal
// mcpt_tpu/ops/traversal.py::_intersect_packet (:454-623), written by hand
// because eager PyTorch cannot run that loop at full width: one node visit
// is ~60 launches and a host test of the stack, and a packet visits
// thousands of nodes.  Its plain version is ops/packet_sweep.py::
// packet_sweep_plain, which it repeats bit for bit.
//
// Contract: rays o, d [N,3], t_min, t_max [N] in the caller's (sorted)
// order; the implicit BVH's node boxes node_min, node_max [M,3] (node i's
// children 2i+1, 2i+2; leaves from n_leaves - 1) and the leaves' rows tris
// [n_leaves, leaf_size, 12] (p0, e1, e2, opaque, ..).  Out: t, prim (a row
// of the packed table), v, w, inside, valid per ray.
//
// Design: a packet is a block of PACKET = 1024 threads, one ray each (the
// last block's missing lanes are dead), sharing one stack of node ids in
// shared memory (depth + 2 ints, as the reference's scalar stack).  Each
// turn of the loop pops the top node.
//   Leaf: its leaf_size rows (48 bytes each) are staged in shared memory;
//     every lane runs the Möller–Trumbore test of ray_tests.cuh on each row
//     in index order, keeping a hit only below its best t, so the lowest row
//     wins among equal t and a hit must beat the best t strictly.  Any-hit
//     tests opaque rows only.
//   Internal node: every live lane (t_min < best t; in any-hit mode, also
//     no hit yet) slab-tests both children against [t_min, best t].  Per
//     child, __ballot_sync counts the lanes that enter it and a warp-shuffle
//     halving tree sums their entry distances, then warp 0 does the same
//     over the 32 warps: the plain version's _tree_sum, in its order, so the
//     mean entry distance is bit-equal to it.  Lane 0 pushes as the
//     reference does (:567-612): a child some lane enters is pushed; where
//     both are, the far one first, so the near one (the smaller mean) is
//     visited next.
// Two __syncthreads a visit.
//
// What bounds it: each visit is a chain of dependent steps (two barriers,
// a block reduction, a global read of the boxes or the rows), ~1-2 µs,
// with ~27 operations a lane per slab test and ~46 per triangle test; a
// 1024-thread block fits at most two to an SM, and a packet waits on its
// slowest lane's subtrees.  The bytes (node boxes and leaf rows, read once
// a visit, broadcast to the lanes) are far below the memory rate.  This
// first version is simple and right; making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int PACKET = 1024;
constexpr int WARPS = PACKET / 32;
constexpr int MAX_LEAF = 32;   // ops/packet_sweep.py::MAX_LEAF
constexpr int MAX_STACK = 40;  // ops/packet_sweep.py::MAX_STACK
constexpr unsigned FULL = 0xffffffffu;

// Lane 0 ends with the halving tree's sum over the warp's 32 values: lane
// i adds lane i + 16, then i + 8, ... (ops/packet_sweep.py::_tree_sum).
__device__ __forceinline__ float tree_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ int int_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
  return x;
}

// The slab test of ops/intersect.py::intersect_aabb: (hit, t_enter).
// Inputs hold no NaN, so fminf/fmaxf agree with torch.minimum/maximum.
__device__ __forceinline__ bool slab(const mcpt::Ray& r, float rx, float ry,
                                     float rz, float tmin, float tmax,
                                     const float* __restrict__ bmin,
                                     const float* __restrict__ bmax,
                                     float& t_enter) {
  const float lx = (__ldg(bmin + 0) - r.ox) * rx, hx = (__ldg(bmax + 0) - r.ox) * rx;
  const float ly = (__ldg(bmin + 1) - r.oy) * ry, hy = (__ldg(bmax + 1) - r.oy) * ry;
  const float lz = (__ldg(bmin + 2) - r.oz) * rz, hz = (__ldg(bmax + 2) - r.oz) * rz;
  const float t_near = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float t_far = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  t_enter = fmaxf(t_near, tmin);
  return t_enter <= fminf(t_far, tmax);
}

__global__ void __launch_bounds__(PACKET)
packet_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min, const float* __restrict__ t_max,
              const float* __restrict__ node_min,
              const float* __restrict__ node_max,
              const float* __restrict__ tris, int n, int first_leaf,
              int leaf_size, int stack_size, int any_hit,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              float* __restrict__ v_out, float* __restrict__ w_out,
              bool* __restrict__ inside_out, bool* __restrict__ valid_out) {
  __shared__ int stack[MAX_STACK];
  __shared__ int s_sp;
  __shared__ float s_sum[2][WARPS];
  __shared__ int s_cnt[2][WARPS];
  __shared__ float s_rows[MAX_LEAF * ROW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * PACKET + tid;
  const bool real = i < n;
  // a dead lane: t_min = t_max = 0 and d = 0, as the plain version pads
  mcpt::Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float tmin = 0.f, t_best = 0.f;
  if (real) {
    r = mcpt::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                  d[3 * i + 1], d[3 * i + 2]};
    tmin = t_min[i];
    t_best = t_max[i];
  }
  const float rx = mcpt::safe_rcp(r.dx), ry = mcpt::safe_rcp(r.dy),
              rz = mcpt::safe_rcp(r.dz);
  int prim = 0;
  float v = 0.f, w = 0.f;
  bool inside = false, valid = false;

  if (tid == 0) {
    stack[0] = 0;
    s_sp = 1;
  }
  __syncthreads();
  while (true) {
    const int sp = s_sp;
    if (sp == 0) break;
    const int node = stack[sp - 1];
    if (node >= first_leaf) {
      const int leaf = node - first_leaf;
      const float* src = tris + static_cast<size_t>(leaf) * leaf_size * ROW;
      for (int k = tid; k < leaf_size * ROW; k += PACKET) s_rows[k] = src[k];
      __syncthreads();
      if (real) {
        for (int k = 0; k < leaf_size; ++k) {
          const float* row = s_rows + k * ROW;
          if (any_hit && !(row[9] > 0.5f)) continue;
          float t, tv, tw;
          bool back;
          if (mcpt::moller_trumbore(r, row, tmin, t_best, t, tv, tw, back)) {
            t_best = t;
            prim = leaf * leaf_size + k;
            v = tv;
            w = tw;
            inside = back;
            valid = true;
          }
        }
      }
      if (tid == 0) s_sp = sp - 1;
      __syncthreads();  // s_rows and s_sp are rewritten next turn
    } else {
      const int c0 = 2 * node + 1;
      const bool live = real && tmin < t_best && !(any_hit && valid);
      bool h0 = false, h1 = false;
      float t0 = 0.f, t1 = 0.f;
      if (live) {
        h0 = slab(r, rx, ry, rz, tmin, t_best, node_min + 3 * c0,
                  node_max + 3 * c0, t0);
        h1 = slab(r, rx, ry, rz, tmin, t_best, node_min + 3 * (c0 + 1),
                  node_max + 3 * (c0 + 1), t1);
      }
      const float x0 = tree_sum(h0 ? t0 : 0.f);
      const float x1 = tree_sum(h1 ? t1 : 0.f);
      const unsigned b0 = __ballot_sync(FULL, h0), b1 = __ballot_sync(FULL, h1);
      if (lane == 0) {
        s_sum[0][warp] = x0;
        s_sum[1][warp] = x1;
        s_cnt[0][warp] = __popc(b0);
        s_cnt[1][warp] = __popc(b1);
      }
      __syncthreads();
      if (warp == 0) {
        const float y0 = tree_sum(s_sum[0][lane]);
        const float y1 = tree_sum(s_sum[1][lane]);
        const int n0 = int_sum(s_cnt[0][lane]), n1 = int_sum(s_cnt[1][lane]);
        if (lane == 0) {
          const float m0 = y0 / fmaxf(static_cast<float>(n0), 1.f);
          const float m1 = y1 / fmaxf(static_cast<float>(n1), 1.f);
          const bool any0 = n0 > 0, any1 = n1 > 0;
          const bool near0 = m0 <= m1;
          const int near = near0 ? c0 : c0 + 1, far = near0 ? c0 + 1 : c0;
          const bool any_near = near0 ? any0 : any1;
          const bool any_far = near0 ? any1 : any0;
          int top = sp - 1;
          if (any0 || any1) {
            stack[min(top, stack_size - 1)] =
                (any_near && any_far) ? far : (any_near ? near : far);
            ++top;
          }
          if (any_near && any_far) {
            stack[min(top, stack_size - 1)] = near;
            ++top;
          }
          s_sp = top;
        }
      }
      __syncthreads();
    }
  }
  if (real) {
    t_out[i] = t_best;
    prim_out[i] = prim;
    v_out[i] = v;
    w_out[i] = w;
    inside_out[i] = inside;
    valid_out[i] = valid;
  }
}

}  // namespace

extern "C" int mcpt_packet_sweep(const void* o, const void* d,
                                 const void* t_min, const void* t_max,
                                 const void* node_min, const void* node_max,
                                 const void* tris, int n, int n_leaves,
                                 int leaf_size, int any_hit, void* t_out,
                                 void* prim_out, void* v_out, void* w_out,
                                 void* inside_out, void* valid_out,
                                 void* stream) {
  if (n <= 0) return 0;
  int depth = 0;
  while ((1 << depth) < n_leaves) ++depth;
  if (n_leaves < 1 || (1 << depth) != n_leaves || leaf_size < 1 ||
      leaf_size > MAX_LEAF || depth + 2 > MAX_STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + PACKET - 1) / PACKET;
  packet_kernel<<<blocks, PACKET, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float*>(node_min), static_cast<const float*>(node_max),
      static_cast<const float*>(tris), n, n_leaves - 1, leaf_size, depth + 2,
      any_hit, static_cast<float*>(t_out), static_cast<int*>(prim_out),
      static_cast<float*>(v_out), static_cast<float*>(w_out),
      static_cast<bool*>(inside_out), static_cast<bool*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
