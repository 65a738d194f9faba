// Block march over SAH chunks for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel mcpt_tpu/ops/pallas_march.py::_march_kernel
// (pallas_call at :502, wrapper ops/traversal.py::_intersect_march_pallas).
// Contract, not layout: rays come in as o, d [N,3] and t_min, t_max [N],
// sorted by the wrapper so that each block's rays share chunks; chunks as
// AABBs cmin, cmax [Lm,3], their super-chunk unions smin, smax [S,3] (runs
// of SUPER consecutive chunks, built once per scene), triangle rows tris
// [Lm,ls,12] (p0, e1, e2, opaque, ..) and global prim ids prim [Lm,ls]
// int32.  Out: t, prim, v, w, inside, valid per ray — the GeomHit of
// ops/traversal.py.
//
// A block owns `block` rays (one owner thread each) and runs
// threads_for(block) >= 512 threads: sixteen warps for phase B however few
// its rays.  At the default 32 rays and groups of four 256-triangle chunks
// a block asks for ~90 KB of shared memory; at 256 rays for ~120 KB, one
// block an SM.
//   Phase A: ent[c], the block-min entry of every chunk c, in one of three
//     ways.  Dense: every thread slab-tests its ray against a stripe of the
//     chunks; a warp-shuffle min and an atomicMin on the float's int bits
//     (every entry is >= +0 or +inf) give the block min.  Super cull (the
//     default, MCPT_MARCH_SUPER): first the same test against each union of
//     SUPER chunks; chunks of a union no ray enters keep +inf untested —
//     exact, as a ray that enters a chunk enters its union (the slab
//     arithmetic is monotone in the box corners).  Interval
//     (MCPT_MARCH_IVAL=1): one test per chunk of the block's per-axis
//     origin and direction intervals, a lower bound of the block min
//     (pallas_march.py:163-217, with the per-ray reciprocal's own clamp).
//     Then the chunks with a finite entry are compacted and sorted by
//     (entry, index) in shared memory (bitonic): the visiting order.
//   Phase B: the sorted chunks go in groups of cg (MCPT_MARCH_GROUP), as
//     the reference's _chunk_group: while the first entry of the next group
//     is below the largest live bound of the block (a lane's best t; 0 for
//     an any-hit lane that has its hit), the group's rows are swept.  The
//     rows of group k+1 (the 40 bytes of each that the test reads) are
//     copied into the other half of a double buffer by cp.async while
//     group k is swept.  The lanes whose best t is beyond the group's
//     first entry are compacted into a task list, and the block's warps
//     take one task each in turn: the warp slab-tests the lane's ray
//     against the group's chunks (a lane a chunk) and its 32 threads split
//     the (needed chunk x triangle) items; each keeps its nearest hit
//     against the lane's bound as it stood at the start of the visit, and
//     a warp min over (t, position in visit order) picks the winner.  A
//     lane sweeps a chunk only where its own slab entry is below its best
//     t, as the plain per-lane march (ops/march_sweep.py) does.  Within a group a lane may test a chunk
//     that the plain march, its bound already lowered by an earlier chunk
//     of the group, would skip; a triangle lies inside its chunk's box, so
//     in exact arithmetic such a test never lowers t.  t is bit-equal to
//     the plain version's up to one rounding case: a Moller-Trumbore t
//     that rounds below its chunk's slab entry (a triangle lying in a
//     face plane of the box), which no card test has shown.  prim may
//     differ only where two triangles give the same t.
// A block whose lanes all have t_max <= t_min skips both phases.
//
// What bounds it on the card: fp32 ALU work, ~46 operations per needed
// (lane, triangle) in phase B and 27 per phase-A slab test; the design
// keeps all of a block's warps on the needed pairs instead of one thread
// per lane, and pays three barriers per group of cg chunks instead of a
// block argmin per chunk.  What bounds it in practice is that chain of
// groups in the block with the widest corridor union, which small blocks
// (32 rays by default) keep short.  The table stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_tests.cuh"

namespace {

using mcpt::ROW;

constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 512;  // a block's threads: at least 16 warps
constexpr int SROW = 10;          // floats of a staged row: p0, e1, e2, opaque
constexpr int SUPER = 128;        // chunks per super-chunk union
constexpr unsigned FULL = 0xffffffffu;

// Per-ray state in shared memory (structure of arrays, `block` each).
enum { RS_OX, RS_OY, RS_OZ, RS_DX, RS_DY, RS_DZ, RS_RX, RS_RY, RS_RZ,
       RS_TMIN, RS_TMAX, RS_T, RS_V, RS_W, RS_WORDS };
// Interval summary: origin min/max, direction min/max, t_min min, t_max max.
enum { IV_OL = 0, IV_OH = 3, IV_DL = 6, IV_DH = 9, IV_TMIN = 12, IV_TMAX = 13,
       IV_WORDS = 14 };

__device__ __forceinline__ bool iv_is_max(int k) {
  return (k >= IV_OH && k < IV_DL) || (k >= IV_DH && k < IV_TMIN) ||
         k == IV_TMAX;
}

__host__ __device__ inline int threads_for(int block) {
  return block >= MIN_THREADS ? block
                              : block * ((MIN_THREADS + block - 1) / block);
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared-memory layout of one block, in 4-byte words, every region a whole
// number of 16 bytes.
struct Layout {
  int rows, ent, order, sup, ray, prim, flag, task, table, red, misc, total;
};

__host__ __device__ inline Layout layout(int lm, int ls, int n_sup, int block,
                                         int cg) {
  auto a4 = [](int w) { return (w + 3) & ~3; };
  const int threads = threads_for(block);
  Layout l;
  l.rows = 0;                                    // 2 x cg x ls rows
  l.ent = l.rows + a4(2 * cg * ls * SROW);       // [lm] entries
  l.order = l.ent + a4(lm);                      // [lm] visit order
  l.sup = l.order + a4(lm);                      // [n_sup] union entered
  l.ray = l.sup + a4(n_sup);                     // [RS_WORDS x block]
  l.prim = l.ray + a4(RS_WORDS * block);         // [block] best prim
  l.flag = l.prim + a4(block);                   // [block] bit0 back, bit1 valid
  l.task = l.flag + a4(block);                   // [block] lanes to sweep
  l.table = l.task + a4(block);                  // [warps x 32] chunk slots
  l.red = l.table + a4(threads);                 // [warps x IV_WORDS]
  l.misc = l.red + a4(IV_WORDS * (threads / 32));  // count, summary
  l.total = l.misc + a4(1 + IV_WORDS);
  return l;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Is chunk a before chunk b in the visit order: (entry, index) ascending.
__device__ __forceinline__ bool before(int a, int b, const float* ent) {
  return ent[a] < ent[b] || (ent[a] == ent[b] && a < b);
}

// Start the copies of the first SROW floats of every row of chunks
// order[first .. first + n_in) into `buf`, 8 bytes a copy, spread over the
// block.
__device__ __forceinline__ void issue_group(float* buf,
                                            const float* __restrict__ tris,
                                            const int* order, int first,
                                            int n_in, int ls) {
  constexpr int PIECES = SROW / 2;
  const int per_chunk = ls * PIECES;
  for (int i = threadIdx.x; i < n_in * per_chunk; i += blockDim.x) {
    const int j = i / per_chunk, q = i - j * per_chunk;
    const int k = q / PIECES, p = q - k * PIECES;
    const float* src =
        tris + (static_cast<size_t>(order[first + j]) * ls + k) * ROW + 2 * p;
    cp_async8(buf + (static_cast<size_t>(j) * ls + k) * SROW + 2 * p, src);
  }
}

// Lower bound of the block-min entry into one box from the interval
// summary iv (pallas_march.py:163-217).  Axes whose direction interval
// holds both signs give no bound.  The reciprocal of each direction bound
// is clamped as the per-ray safe_rcp is, so that every ray's reciprocal
// lies between them, and rounding is monotone: the bound holds bit for bit.
__device__ float interval_entry(const float* iv, const float* bmin,
                                const float* bmax) {
  float near_l = -INFINITY, far_u = INFINITY;
  for (int a = 0; a < 3; ++a) {
    const float dl = iv[IV_DL + a], dh = iv[IV_DH + a];
    if (!(dl > 0.f || dh < 0.f)) continue;
    const float il = mcpt::safe_rcp(dh), ih = mcpt::safe_rcp(dl);
    const float ol = iv[IV_OL + a], oh = iv[IV_OH + a];
    const float xs[4] = {bmin[a] - oh, bmin[a] - ol, bmax[a] - oh,
                         bmax[a] - ol};
    float nl = INFINITY, fu = -INFINITY;
    for (int k = 0; k < 4; ++k) {
      const float p = xs[k] * il, q = xs[k] * ih;
      nl = fminf(nl, fminf(p, q));
      fu = fmaxf(fu, fmaxf(p, q));
    }
    near_l = fmaxf(near_l, nl);
    far_u = fminf(far_u, fu);
  }
  const float ent = fmaxf(fmaxf(near_l, iv[IV_TMIN]), 0.f);
  const bool possible =
      ent <= fminf(far_u, iv[IV_TMAX]) && near_l < 1e30f;
  return possible ? ent : INFINITY;
}

__global__ void __launch_bounds__(MAX_THREADS)
march_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_min, const float* __restrict__ t_max,
             const float* __restrict__ cmin, const float* __restrict__ cmax,
             const float* __restrict__ smin, const float* __restrict__ smax,
             const float* __restrict__ tris, const int32_t* __restrict__ prim,
             int n, int lm, int ls, int n_sup, int block, int cg, int any_hit,
             int interval, float* __restrict__ t_out,
             int32_t* __restrict__ prim_out, float* __restrict__ v_out,
             float* __restrict__ w_out, uint8_t* __restrict__ inside_out,
             uint8_t* __restrict__ valid_out) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(lm, ls, n_sup, block, cg);
  float* rows = smem + L.rows;
  float* ent = smem + L.ent;
  int* order = reinterpret_cast<int*>(smem + L.order);
  int* sup = reinterpret_cast<int*>(smem + L.sup);
  float* rs = smem + L.ray;
  int* s_prim = reinterpret_cast<int*>(smem + L.prim);
  int* s_flag = reinterpret_cast<int*>(smem + L.flag);
  int* s_task = reinterpret_cast<int*>(smem + L.task);
  int* table = reinterpret_cast<int*>(smem + L.table);
  float* red = smem + L.red;
  int& s_count = *reinterpret_cast<int*>(smem + L.misc);
  float* s_iv = smem + L.misc + 1;

  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = threads >> 5;
  const bool owner = tid < block;
  const int ray = blockIdx.x * block + tid;
  const bool in_range = owner && ray < n;
  bool live = false;
  if (owner) {
    float r[RS_WORDS] = {0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
    if (in_range) {
      for (int a = 0; a < 3; ++a) {
        r[RS_OX + a] = o[3 * ray + a];
        r[RS_DX + a] = d[3 * ray + a];
      }
      r[RS_TMIN] = t_min[ray];
      r[RS_TMAX] = t_max[ray];
    }
    for (int a = 0; a < 3; ++a) r[RS_RX + a] = mcpt::safe_rcp(r[RS_DX + a]);
    r[RS_T] = r[RS_TMAX];
    r[RS_V] = r[RS_W] = 0.f;
    for (int k = 0; k < RS_WORDS; ++k) rs[k * block + tid] = r[k];
    s_prim[tid] = 0;
    s_flag[tid] = 0;
    live = in_range && r[RS_TMAX] > r[RS_TMIN];
  }

  if (__syncthreads_or(live)) {
    // ---- phase A: ent[c] for every chunk
    for (int c = tid; c < lm; c += threads) ent[c] = INFINITY;
    for (int s = tid; s < n_sup; s += threads) sup[s] = 0;
    // thread tid tests ray tid % block against chunks tid / block + k * stride
    const int me = tid % block, stripe = tid / block, stride = threads / block;
    const mcpt::Ray r{rs[RS_OX * block + me], rs[RS_OY * block + me],
                      rs[RS_OZ * block + me], rs[RS_DX * block + me],
                      rs[RS_DY * block + me], rs[RS_DZ * block + me]};
    const float rx = rs[RS_RX * block + me], ry = rs[RS_RY * block + me],
                rz = rs[RS_RZ * block + me];
    const float tmin = rs[RS_TMIN * block + me], tmax = rs[RS_TMAX * block + me];
    const bool me_live = blockIdx.x * block + me < n && tmax > tmin;
    __syncthreads();
    if (interval) {
      // block summary over the live rays, each counted once (stripe 0)
      const bool mine = me_live && stripe == 0;
      const float oo[3] = {r.ox, r.oy, r.oz}, dd[3] = {r.dx, r.dy, r.dz};
      float v[IV_WORDS];
      for (int a = 0; a < 3; ++a) {
        v[IV_OL + a] = mine ? oo[a] : INFINITY;
        v[IV_OH + a] = mine ? oo[a] : -INFINITY;
        v[IV_DL + a] = mine ? dd[a] : INFINITY;
        v[IV_DH + a] = mine ? dd[a] : -INFINITY;
      }
      v[IV_TMIN] = mine ? tmin : INFINITY;
      v[IV_TMAX] = mine ? tmax : -INFINITY;
      for (int k = 0; k < IV_WORDS; ++k) {
        const bool is_max = iv_is_max(k);
        float x = v[k];
        for (int off = 16; off > 0; off >>= 1) {
          const float y = __shfl_xor_sync(FULL, x, off);
          x = is_max ? fmaxf(x, y) : fminf(x, y);
        }
        if (lane == 0) red[warp * IV_WORDS + k] = x;
      }
      __syncthreads();
      if (tid < IV_WORDS) {
        const int k = tid;
        const bool is_max = iv_is_max(k);
        float x = red[k];
        for (int w = 1; w < n_warps; ++w)
          x = is_max ? fmaxf(x, red[w * IV_WORDS + k])
                     : fminf(x, red[w * IV_WORDS + k]);
        s_iv[k] = x;
      }
      __syncthreads();
      for (int c = tid; c < lm; c += threads)
        ent[c] = interval_entry(s_iv, &cmin[3 * c], &cmax[3 * c]);
    } else {
      if (n_sup > 0) {
        for (int s = stripe; s < n_sup; s += stride) {
          const float e =
              me_live ? mcpt::chunk_entry(r, rx, ry, rz, tmin, tmax,
                                          &smin[3 * s], &smax[3 * s])
                      : INFINITY;
          if (__any_sync(FULL, e < INFINITY) && lane == 0) sup[s] = 1;
        }
        __syncthreads();
      }
      for (int c = stripe; c < lm; c += stride) {
        if (n_sup > 0 && !sup[c / SUPER]) continue;  // uniform in a warp
        float e = me_live ? mcpt::chunk_entry(r, rx, ry, rz, tmin, tmax,
                                              &cmin[3 * c], &cmax[3 * c])
                          : INFINITY;
        if (__any_sync(FULL, e < INFINITY)) {
          for (int off = 16; off > 0; off >>= 1)
            e = fminf(e, __shfl_xor_sync(FULL, e, off));
          if (lane == 0)
            atomicMin(reinterpret_cast<int*>(&ent[c]), __float_as_int(e));
        }
      }
    }
    if (tid == 0) s_count = 0;
    __syncthreads();

    // ---- the visit order: chunks with a finite entry, sorted
    for (int c = tid; c < lm; c += threads)
      if (ent[c] < INFINITY) order[atomicAdd(&s_count, 1)] = c;
    __syncthreads();
    const int n_vis = s_count;
    // bitonic sort in its all-ascending form (a flip, then half-cleaners):
    // positions past n_vis act as +inf, so comparators that reach them are
    // no-ops and order[] needs only lm slots
    const int p2 = pow2_at_least(n_vis);
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < p2; i += threads) {
          const int l = j == (k >> 1) ? i ^ (k - 1) : i ^ j;
          if (l > i && l < n_vis) {
            const int a = order[i], b = order[l];
            if (before(b, a, ent)) {
              order[i] = b;
              order[l] = a;
            }
          }
        }
        __syncthreads();
      }
    }

    // ---- phase B: groups of cg chunks, nearest first, double-buffered
    const int n_groups = (n_vis + cg - 1) / cg;
    const int buf_words = cg * ls * SROW;
    if (n_groups > 0) issue_group(rows, tris, order, 0, min(cg, n_vis), ls);
    cp_async_commit();
    for (int g = 0; g < n_groups; ++g) {
      const int first = g * cg, n_in = min(cg, n_vis - first);
      const float te = ent[order[first]];
      bool keep = false;
      if (in_range) {
        const bool done = any_hit && (s_flag[tid] & 2);
        keep = (done ? 0.f : rs[RS_T * block + tid]) > te;
      }
      if (!__syncthreads_or(keep)) break;
      if (g + 1 < n_groups)
        issue_group(rows + ((g + 1) & 1) * buf_words, tris, order,
                    first + cg, min(cg, n_vis - first - cg), ls);
      cp_async_commit();
      cp_async_wait_1();
      if (tid == 0) s_count = 0;
      __syncthreads();
      // owners: may my ray need a chunk of this group?  Every entry of the
      // group is >= te; the task's warp slab-tests the chunks themselves
      if (owner && live && !(any_hit && (s_flag[tid] & 2)) &&
          rs[RS_T * block + tid] > te)
        s_task[atomicAdd(&s_count, 1)] = tid;
      __syncthreads();
      const int n_task = s_count;
      const float* buf = rows + (g & 1) * buf_words;
      int* tbl = table + warp * 32;
      for (int task = warp; task < n_task; task += n_warps) {
        const int ln = s_task[task];
        const mcpt::Ray q{rs[RS_OX * block + ln], rs[RS_OY * block + ln],
                          rs[RS_OZ * block + ln], rs[RS_DX * block + ln],
                          rs[RS_DY * block + ln], rs[RS_DZ * block + ln]};
        const float qx = rs[RS_RX * block + ln], qy = rs[RS_RY * block + ln],
                    qz = rs[RS_RZ * block + ln];
        const float qmin = rs[RS_TMIN * block + ln];
        const float qmax = rs[RS_TMAX * block + ln];
        const float tb = rs[RS_T * block + ln];  // the bound at visit start
        float bt = INFINITY, bv = 0.f, bw = 0.f;
        int bpos = 0x7fffffff;
        bool bback = false;
        for (int j0 = 0; j0 < n_in; j0 += 32) {
          const int j = j0 + lane;
          bool need = false;
          if (j < n_in) {
            const int c = order[first + j];
            need = mcpt::chunk_entry(q, qx, qy, qz, qmin, qmax, &cmin[3 * c],
                                     &cmax[3 * c]) < tb;
          }
          const unsigned bits = __ballot_sync(FULL, need);
          if (need) tbl[__popc(bits & ((1u << lane) - 1u))] = j;
          __syncwarp();
          // this thread's share of the (needed chunk x triangle) items, in
          // visit order
          auto test = [&](int jj, int k) {
            // a row is five 8-byte loads: rows 40 bytes apart, so the 16
            // threads of each half warp hit disjoint banks
            const float2* row = reinterpret_cast<const float2*>(
                buf + (static_cast<size_t>(jj) * ls + k) * SROW);
            const float2 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3],
                         r4 = row[4];
            const float tri[SROW] = {r0.x, r0.y, r1.x, r1.y, r2.x,
                                     r2.y, r3.x, r3.y, r4.x, r4.y};
            if (any_hit && !(tri[9] > 0.5f)) return;
            float t, v, w;
            bool back;
            if (mcpt::moller_trumbore(q, tri, qmin, tb, t, v, w, back) &&
                t < bt) {  // items ascend in visit order: the first of equal t
              bt = t;
              bv = v;
              bw = w;
              bback = back;
              bpos = jj * ls + k;
            }
          };
          const int n_need = __popc(bits);
          if ((ls & 31) == 0) {
            for (int m = 0; m < n_need; ++m)
              for (int k = lane; k < ls; k += 32) test(tbl[m], k);
          } else {  // chunks narrower than a warp: flatten the items
            for (int it = lane; it < n_need * ls; it += 32)
              test(tbl[it / ls], it % ls);
          }
          __syncwarp();
        }
        // warp min over (t, position in visit order)
        float mt = bt;
        int mp = bpos;
        for (int off = 16; off > 0; off >>= 1) {
          const float ot = __shfl_xor_sync(FULL, mt, off);
          const int op = __shfl_xor_sync(FULL, mp, off);
          if (ot < mt || (ot == mt && op < mp)) {
            mt = ot;
            mp = op;
          }
        }
        if (mt < INFINITY) {  // uniform: every lane holds the same (mt, mp)
          const unsigned win = __ballot_sync(FULL, bt == mt && bpos == mp);
          const int src = __ffs(win) - 1;
          const float wv = __shfl_sync(FULL, bv, src);
          const float ww = __shfl_sync(FULL, bw, src);
          const int wb = __shfl_sync(FULL, static_cast<int>(bback), src);
          if (lane == 0) {
            const int c = order[first + mp / ls];
            rs[RS_T * block + ln] = mt;
            rs[RS_V * block + ln] = wv;
            rs[RS_W * block + ln] = ww;
            s_prim[ln] = prim[static_cast<size_t>(c) * ls + mp % ls];
            s_flag[ln] = 2 | wb;
          }
        }
      }
      __syncthreads();  // the lanes' bounds are final; the buffer is free
    }
    cp_async_wait_all();
    __syncthreads();
  }

  if (in_range) {
    t_out[ray] = rs[RS_T * block + tid];
    prim_out[ray] = s_prim[tid];
    v_out[ray] = rs[RS_V * block + tid];
    w_out[ray] = rs[RS_W * block + tid];
    inside_out[ray] = s_flag[tid] & 1;
    valid_out[ray] = (s_flag[tid] >> 1) & 1;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes: ops/march_sweep.py's
// card_group clamps the group size with it.
extern "C" long long mcpt_march_smem_bytes(int lm, int ls, int n_sup,
                                           int block, int cg) {
  return 4LL * layout(lm, ls, n_sup, block, cg).total;
}

// Launches on `stream` (PyTorch's current stream); allocates nothing, does
// not synchronise.  `block` rays per block, a multiple of 32 up to 1024;
// `cg` chunks per group; n_sup super-chunk unions (0: no super cull);
// flags bit0 any-hit, bit1 interval phase A.  Returns cudaGetLastError()
// as an int (0 = launched).
extern "C" int mcpt_march_sweep(const void* o, const void* d,
                                const void* t_min, const void* t_max,
                                const void* cmin, const void* cmax,
                                const void* smin, const void* smax,
                                const void* tris, const void* prim, int n,
                                int lm, int ls, int n_sup, int block, int cg,
                                int flags, void* t_out, void* prim_out,
                                void* v_out, void* w_out, void* inside_out,
                                void* valid_out, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0 || block > MAX_THREADS || block % 32 != 0 || cg <= 0 ||
      ls <= 0 || lm <= 0 || n_sup < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(layout(lm, ls, n_sup, block, cg).total);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + block - 1) / block;
  march_kernel<<<blocks, threads_for(block), smem,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const float*>(cmin), static_cast<const float*>(cmax),
      static_cast<const float*>(smin), static_cast<const float*>(smax),
      static_cast<const float*>(tris), static_cast<const int32_t*>(prim), n,
      lm, ls, n_sup, block, cg, flags & 1, (flags >> 1) & 1,
      static_cast<float*>(t_out), static_cast<int32_t*>(prim_out),
      static_cast<float*>(v_out), static_cast<float*>(w_out),
      static_cast<uint8_t*>(inside_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
