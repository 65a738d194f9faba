"""Closest-hit ray casting against a triangle soup, in plain PyTorch.

A linear BVH: the triangles sorted by the Morton code of their
centroids, leaves of LEAF consecutive triangles, and a complete binary
tree over the leaves in heap order (node i has children 2i+1 and 2i+2;
padding leaves have inverted boxes and are never entered).  Rays walk it
with a stack each, all rays one step at a time, and the finished ones
drop out; the last few test every triangle (TAIL).  The triangle test is Moller-Trumbore; a hit reports t, the
barycentric weights (v, w) of vertices 1 and 2, and whether the ray met
the back of the triangle (d . (e1 x e2) > 0).
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 8
STACK = 64
T_MIN = 1e-4
#: once TAIL_STEPS steps are done and at most TAIL rays (or a 256th of
#: them) are still walking, those rays test every triangle instead: a ray
#: through a vertex that many triangles share (a UV sphere's pole) enters
#: every leaf around it, and would hold the walk for hundreds of steps
TAIL_STEPS, TAIL, CHUNK = 48, 2048, 4096


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0, 1]^3."""
    q = np.clip((c * 1024.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Bvh:
    """The tree and the triangles in tree order on `device`, floats in
    `dtype`.  p0, p1, p2: [T, 3] numpy vertex positions."""

    def __init__(self, p0, p1, p2, device, dtype):
        p0, p1, p2 = (np.asarray(p, np.float64) for p in (p0, p1, p2))
        n = len(p0)
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        cen = (lo + hi) / 2
        span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
        order = np.argsort(_morton((cen - cen.min(0)) / span), kind="stable")
        n_leaf = -(-n // LEAF)
        size = 1 << max(int(np.ceil(np.log2(n_leaf))), 0)
        # per leaf slot: its triangles (-1 padding) and its box
        slots = np.full(size * LEAF, -1, np.int64)
        slots[:n] = order
        slots = slots.reshape(size, LEAF)
        valid = slots >= 0
        lo_s = np.where(valid[..., None], lo[np.maximum(slots, 0)], np.inf)
        hi_s = np.where(valid[..., None], hi[np.maximum(slots, 0)], -np.inf)
        box_lo = [lo_s.min(1)]
        box_hi = [hi_s.max(1)]
        while len(box_lo[-1]) > 1:
            box_lo.append(np.minimum(box_lo[-1][0::2], box_lo[-1][1::2]))
            box_hi.append(np.maximum(box_hi[-1][0::2], box_hi[-1][1::2]))
        # heap order: the root first, the leaves last
        bl = np.concatenate(box_lo[::-1])
        bh = np.concatenate(box_hi[::-1])
        self.first_leaf = size - 1
        self.box_lo = torch.as_tensor(bl.astype(np.float32), device=device).to(dtype)
        self.box_hi = torch.as_tensor(bh.astype(np.float32), device=device).to(dtype)
        self.leaf_tris = torch.as_tensor(slots, device=device)
        self.p0 = torch.as_tensor(p0.astype(np.float32), device=device).to(dtype)
        self.e1 = torch.as_tensor((p1 - p0).astype(np.float32), device=device).to(dtype)
        self.e2 = torch.as_tensor((p2 - p0).astype(np.float32), device=device).to(dtype)
        self.dtype = dtype
        self.device = device

    def _box(self, node, o, inv):
        """(entry t, exit t) of each ray's slab test against `node`."""
        a = (self.box_lo[node] - o) * inv
        b = (self.box_hi[node] - o) * inv
        near = torch.minimum(a, b).amax(dim=-1)
        far = torch.maximum(a, b).amin(dim=-1)
        return near, far

    def _tris(self, tri, o, d, t_min, t_best):
        """Moller-Trumbore of rays [R] against tri [R, LEAF] (-1 none):
        (t [R, LEAF], v, w, det) with t = inf where there is no hit."""
        ok = tri >= 0
        k = tri.clamp(min=0)
        p0, e1, e2 = self.p0[k], self.e1[k], self.e2[k]
        d_ = d[:, None, :].expand_as(e2)
        pv = torch.linalg.cross(d_, e2, dim=-1)
        det = (e1 * pv).sum(-1)
        inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        tv = o[:, None, :] - p0
        v = (tv * pv).sum(-1) * inv
        qv = torch.linalg.cross(tv, e1, dim=-1)
        w = (d_ * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        hit = (ok & (det != 0) & (v >= 0) & (w >= 0) & (v + w <= 1)
               & (t > t_min[:, None]) & (t < t_best[:, None]))
        return torch.where(hit, t, torch.full_like(t, float("inf"))), v, w, det

    def _all(self, rows, o, d, t_min, best_t, prim, bv, bw, back):
        """Every triangle against the rays `rows`, into the best hits."""
        n = self.p0.shape[0]
        for c in range(0, n, CHUNK):
            tri = torch.arange(c, min(c + CHUNK, n), device=o.device)
            tri = tri[None, :].expand(rows.numel(), -1)
            t, v, w, det = self._tris(tri, o[rows], d[rows], t_min[rows],
                                      best_t[rows])
            tb, j = t.min(dim=1)
            got = torch.nonzero(torch.isfinite(tb)).squeeze(1)
            r, j = rows[got], j[got]
            best_t[r] = tb[got]
            prim[r] = tri[got, j]
            bv[r] = v[got, j]
            bw[r] = w[got, j]
            back[r] = det[got, j] < 0

    def closest(self, o, d, t_min, t_max):
        """Closest hit of rays o + t d, t in (t_min, t_max): (t, prim (-1
        none), v, w, back).  The stack holds each entered node with its
        entry t, so that a node farther than the best hit so far is
        dropped when it comes up; an inner node pushes the children its
        ray enters, the nearer on top."""
        r = o.shape[0]
        dev = o.device
        tiny = torch.full_like(d, 1e-20)
        inv = 1.0 / torch.where(d.abs() < 1e-20, torch.copysign(tiny, d), d)
        best_t = t_max.clone()
        prim = torch.full((r,), -1, dtype=torch.int64, device=dev)
        bv = torch.zeros_like(best_t)
        bw = torch.zeros_like(best_t)
        back = torch.zeros(r, dtype=torch.bool, device=dev)
        node_st = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
        near_st = torch.zeros((r, STACK), dtype=best_t.dtype, device=dev)
        root = torch.zeros(r, dtype=torch.int64, device=dev)
        near, far = self._box(root, o, inv)
        enter = (near <= far) & (far >= t_min) & (near <= best_t)
        near_st[:, 0] = near
        sp = enter.long()
        act = torch.nonzero(enter).squeeze(1)
        steps, tail = 0, min(TAIL, max(64, r // 256))
        while act.numel():
            steps += 1
            if steps > TAIL_STEPS and act.numel() <= tail:
                self._all(act, o, d, t_min, best_t, prim, bv, bw, back)
                break
            top = sp[act] - 1
            sp[act] = top
            node = node_st[act, top]
            live = near_st[act, top] <= best_t[act]
            leaf = node >= self.first_leaf
            sel = torch.nonzero(live & leaf).squeeze(1)
            rows = act[sel]
            tri = self.leaf_tris[node[sel] - self.first_leaf]
            t, v, w, det = self._tris(tri, o[rows], d[rows], t_min[rows],
                                      best_t[rows])
            tb, j = t.min(dim=1)
            got = torch.nonzero(torch.isfinite(tb)).squeeze(1)
            rows, j = rows[got], j[got]
            best_t[rows] = tb[got]
            prim[rows] = tri[got, j]
            bv[rows] = v[got, j]
            bw[rows] = w[got, j]
            back[rows] = det[got, j] < 0
            sel = torch.nonzero(live & ~leaf).squeeze(1)
            rows = act[sel]
            c1 = 2 * node[sel] + 1
            c2 = c1 + 1
            o_r, i_r, tm, bt = o[rows], inv[rows], t_min[rows], best_t[rows]
            n1, f1 = self._box(c1, o_r, i_r)
            n2, f2 = self._box(c2, o_r, i_r)
            e1 = (n1 <= f1) & (f1 >= tm) & (n1 <= bt)
            e2 = (n2 <= f2) & (f2 >= tm) & (n2 <= bt)
            first1 = n1 <= n2                 # c1 nearer: push it last
            s = sp[rows]
            a_node = torch.where(first1, c2, c1)
            a_near = torch.where(first1, n2, n1)
            a_in = torch.where(first1, e2, e1)
            b_node = torch.where(first1, c1, c2)
            b_near = torch.where(first1, n1, n2)
            b_in = torch.where(first1, e1, e2)
            node_st[rows, s] = a_node
            near_st[rows, s] = a_near
            s = s + a_in.long()
            node_st[rows, s] = b_node
            near_st[rows, s] = b_near
            sp[rows] = s + b_in.long()
            act = act[sp[act] > 0]
        return best_t, prim, bv, bw, back
