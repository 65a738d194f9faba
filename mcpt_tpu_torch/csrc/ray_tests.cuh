// Ray tests shared by the port's kernels (csrc/*.cu), plain CUDA C++.
//
// Both repeat their plain PyTorch versions op for op, so that built with
// --fmad=false and without fast math every multiply, add and IEEE division
// rounds on its own in the same order, and the results agree bit for bit:
//   * moller_trumbore: ops/intersect.py::intersect_triangle, dots written
//     ((x + y) + z);
//   * chunk_entry: ops/intersect.py::safe_rcp + intersect_aabb as
//     ops/march_sweep.py::chunk_entry uses them.
#pragma once

#include <math.h>

namespace mcpt {

constexpr int ROW = 12;  // floats per packed triangle: p0, e1, e2, opaque, ..

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Reciprocal direction component with |x| < 1e-12 pushed to +-1e-12.
__device__ __forceinline__ float safe_rcp(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? (x < 0.f ? -1e-12f : 1e-12f) : x);
}

// Möller–Trumbore against one packed row `tri`.  True when the triangle is
// hit at a t in [tmin, t_best) (strict, so that scanning rows in index
// order keeps the lowest index among equal t); writes t, v, w and
// whether the back face was hit.
__device__ __forceinline__ bool moller_trumbore(const Ray& r, const float* tri,
                                                float tmin, float t_best,
                                                float& t_out, float& v_out,
                                                float& w_out, bool& back) {
  const float p0x = tri[0], p0y = tri[1], p0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];

  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float det_abs = fabsf(det);
  const float det_inv = 1.0f / (det_abs < 1e-20f ? 1e-20f : det);
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float v = (tvx * pvx + tvy * pvy + tvz * pvz) * det_inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float w = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * det_inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * det_inv;

  t_out = t;
  v_out = v;
  w_out = w;
  back = det_inv < 0.f;
  return (v >= 0.f) && (v <= 1.f) && (w >= 0.f) && (v + w <= 1.f) &&
         (t >= tmin) && (t < t_best) && (det_abs > 1e-20f);
}

// Entry distance of a ray (origin o, reciprocal direction rcp) into the box
// [bmin, bmax] within [tmin, tmax], clamped at 0; +inf when the slab test
// fails or the entry is beyond 1e30 (empty chunks are parked at 3e37).
// Inputs hold no NaN, so fminf/fmaxf agree with torch.minimum/maximum.
__device__ __forceinline__ float chunk_entry(const Ray& o, float rx, float ry,
                                             float rz, float tmin, float tmax,
                                             const float* bmin,
                                             const float* bmax) {
  const float lx = (bmin[0] - o.ox) * rx, hx = (bmax[0] - o.ox) * rx;
  const float ly = (bmin[1] - o.oy) * ry, hy = (bmax[1] - o.oy) * ry;
  const float lz = (bmin[2] - o.oz) * rz, hz = (bmax[2] - o.oz) * rz;
  const float t_near = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float t_far = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  const float t_enter = fmaxf(t_near, tmin);
  const float t_exit = fminf(t_far, tmax);
  if (!(t_enter <= t_exit) || !(t_enter < 1e30f)) return INFINITY;
  return t_enter > 0.f ? t_enter : 0.f;
}

}  // namespace mcpt
