"""Möller–Trumbore ray/triangle test and the AABB slab test
(counterpart of mcpt_tpu/ops/intersect.py:20-42, 107-123).

Triangles are (p0, e1, e2) with e1 = p1 - p0, e2 = p2 - p0.  `det_inv < 0`
means a back-face hit; (v, w) weight vertices 1 and 2.  Dots are written
out as ((x + y) + z) so the CUDA sweep can repeat them op for op.
"""

from __future__ import annotations

import torch


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def intersect_triangle(o, d, p0, e1, e2, t_min, t_max):
    """All args broadcast ([..., 3] points, [...] bounds); returns
    (hit, t, v, w, det_inv)."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = _dot3(e1x, e1y, e1z, pvx, pvy, pvz)
    small = det.abs() < 1e-20
    det_inv = 1.0 / torch.where(small, torch.full_like(det, 1e-20), det)
    tv = o - p0
    tvx, tvy, tvz = tv[..., 0], tv[..., 1], tv[..., 2]
    v = _dot3(tvx, tvy, tvz, pvx, pvy, pvz) * det_inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    w = _dot3(dx, dy, dz, qvx, qvy, qvz) * det_inv
    t = _dot3(e2x, e2y, e2z, qvx, qvy, qvz) * det_inv
    hit = (
        (v >= 0.0) & (v <= 1.0) & (w >= 0.0) & (v + w <= 1.0)
        & (t >= t_min) & (t <= t_max) & (det.abs() > 1e-20)
    )
    return hit, t, v, w, det_inv


def intersect_aabb(o, d_rcp, box_min, box_max, t_min, t_max):
    """Slab test handling negative directions (csrt aabb.cpp:29-47).
    [..., 3] points and boxes, [...] bounds; returns (hit, t_enter)."""
    lo = (box_min - o) * d_rcp
    hi = (box_max - o) * d_rcp
    t_near = torch.minimum(lo, hi)
    t_far = torch.maximum(lo, hi)
    t_enter = torch.maximum(t_near.amax(dim=-1), t_min)
    t_exit = torch.minimum(t_far.amin(dim=-1), t_max)
    return t_enter <= t_exit, t_enter


def safe_rcp(d):
    """Reciprocal direction with |d| < 1e-12 pushed to +-1e-12, so the slab
    test never multiplies inf by 0."""
    tiny = torch.where(d < 0, torch.full_like(d, -1e-12), torch.full_like(d, 1e-12))
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
