"""Device geometry: flat world-space triangle SoA, its BVH and the march
pack (counterpart of mcpt_tpu/scene/geometry.py::commit_geometry,
:164-313).

All instances merge into one Morton-sorted, padded primitive array with a
per-prim `inst_id` for BSDF binding; padding prims have zero edges and
are never hit.  The implicit BVH over that order (scene/bvh.py) keeps its
node boxes for the BVH walk of the packet route (MCPT_TRAVERSAL=packet).
Scenes above DENSE_MAX_PRIMS traverse the march pack by default: the real prims
grouped by a top-down binned-SAH partition (csrc/sah.c, native.py) into
at most MCPT_MARCH_MAX_CHUNKS chunks of `march_leaf` prims, each with its
AABB.  Both are built for every scene, as the reference builds them.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch import native, trace
from mcpt_tpu_torch.ops.march_sweep import super_boxes
from mcpt_tpu_torch.scene.bvh import build_bvh

#: host nanoseconds spent in commit_geometry's acceleration build, counted
#: always (once a scene)
accel_ns = 0


class Geometry(NamedTuple):
    p0: torch.Tensor   # [P, 3] vertex 0
    e1: torch.Tensor   # [P, 3] v1 - v0
    e2: torch.Tensor   # [P, 3] v2 - v0
    n0: torch.Tensor   # [P, 3] shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    tg0: torch.Tensor  # [P, 3] tangents
    tg1: torch.Tensor
    tg2: torch.Tensor
    bt0: torch.Tensor  # [P, 3] bitangents
    bt1: torch.Tensor
    bt2: torch.Tensor
    uv0: torch.Tensor  # [P, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    inst_id: torch.Tensor  # [P] int32 (padding = 0; masked by hit validity)
    opaque: torch.Tensor   # [P] bool (blocks shadow rays; padding False)
    #: [P, 12] rows (p0.xyz, e1.xyz, e2.xyz, opaque, 0, 0) — the dense
    #: sweep's triangle table; viewed as [n_pad_leaves, leaf_size, 12], the
    #: BVH leaves' rows (the reference keeps it in that layout)
    packed_tris: torch.Tensor
    #: [Lm, ls, 12] march pack: chunk j's rows of packed_tris, channel 10 =
    #: the global sorted prim id as f32 (the reference's row), padding
    #: rows zero
    march_tris: torch.Tensor
    #: [Lm, ls] int32 global sorted prim id of each march row (exact at
    #: any size; channel 10 is exact only below 2^24), padding rows 0
    march_prim: torch.Tensor
    march_min: torch.Tensor  # [Lm, 3] chunk AABBs (empty chunk: 3e37)
    march_max: torch.Tensor
    #: [S, 3] union AABBs of each run of 128 consecutive chunks (the last
    #: run may be partial), for K2's super-chunk cull: static per scene,
    #: so built here once (the reference builds them per launch)
    march_super_min: torch.Tensor
    march_super_max: torch.Tensor
    #: [P] int32 chunk of each sorted prim (padding prims -> 0)
    march_chunk_of_prim: torch.Tensor
    #: [3] scene bounds: the union of the real prims' AABBs (the
    #: reference's BVH root, node_min[0] / node_max[0])
    bounds_min: torch.Tensor
    bounds_max: torch.Tensor
    #: [M, 3] BVH node boxes, M = 2 * n_pad_leaves - 1 (scene/bvh.py):
    #: node i's children are 2i+1, 2i+2; leaves from n_pad_leaves - 1
    node_min: torch.Tensor
    node_max: torch.Tensor

    @property
    def n_pad_leaves(self) -> int:
        return (self.node_min.shape[0] + 1) // 2

    @property
    def leaf_size(self) -> int:
        return self.packed_tris.shape[0] // self.n_pad_leaves

    @property
    def depth(self) -> int:
        """log2(n_pad_leaves): the BVH's depth."""
        return (self.n_pad_leaves - 1).bit_length()

    @property
    def n_march_leaves(self) -> int:
        return self.march_tris.shape[0]

    @property
    def march_leaf(self) -> int:
        return self.march_tris.shape[1]


def _tangent_frames(normals: np.ndarray):
    """Arbitrary tangent frame around each normal when the mesh supplies
    none (the reference's _gram_schmidt_frames)."""
    n = normals
    helper = np.where(
        np.abs(n[:, 0:1]) > 0.9, np.array([[0.0, 1.0, 0.0]]), np.array([[1.0, 0.0, 0.0]])
    ).astype(np.float32)
    t = np.cross(helper, n)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(n, t)
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return t, b


#: the reference's BVH leaf size, which sets the padding of the prim array
LEAF_SIZE = 4


def _sah_chunks_py(cent, tmin, tmax, leaf, nbins=16):
    """Top-down binned-SAH partition of prims into chunks of <= `leaf`
    (mcpt_tpu/scene/geometry.py::_sah_chunks_py, copied verbatim so the
    chunks and their DFS order are the reference's): the plain twin of
    csrc/sah.c (native.sah_chunks), whose list is this one reversed.

    The march traversal's cost per ray is (chunks entered) x (sweep of
    `leaf` tris), so the split objective is the classic surface-area
    heuristic: min SA(L)*|L| + SA(R)*|R| over 16 centroid bins on the
    longest axis.  Returns a list of int64 index arrays into the input
    prim order.
    """
    out = []
    stack = [np.arange(cent.shape[0], dtype=np.int64)]
    while stack:
        ix = stack.pop()
        if ix.size <= leaf:
            out.append(ix)
            continue
        c = cent[ix]
        lo, hi = c.min(axis=0), c.max(axis=0)
        ax = int(np.argmax(hi - lo))
        if hi[ax] - lo[ax] < 1e-12:  # all centroids coincide
            stack += [ix[: ix.size // 2], ix[ix.size // 2 :]]
            continue
        b = np.minimum(
            ((c[:, ax] - lo[ax]) / (hi[ax] - lo[ax]) * nbins).astype(
                np.int32
            ),
            nbins - 1,
        )
        cnt = np.bincount(b, minlength=nbins)
        bmin = np.full((nbins, 3), np.inf, np.float32)
        bmax = np.full((nbins, 3), -np.inf, np.float32)
        for k in range(3):
            np.minimum.at(bmin[:, k], b, tmin[ix, k])
            np.maximum.at(bmax[:, k], b, tmax[ix, k])
        cl = np.cumsum(cnt)[:-1]
        cr = ix.size - cl
        pmin = np.minimum.accumulate(bmin, 0)
        pmax = np.maximum.accumulate(bmax, 0)
        smin = np.minimum.accumulate(bmin[::-1], 0)[::-1]
        smax = np.maximum.accumulate(bmax[::-1], 0)[::-1]

        def sa(mn, mx):
            d = np.clip(mx - mn, 0, None)
            return 2 * (
                d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]
            )

        cost = np.where(
            (cl > 0) & (cr > 0),
            sa(pmin, pmax)[:-1] * cl + sa(smin, smax)[1:] * cr,
            np.inf,
        )
        i = int(np.argmin(cost))
        if not np.isfinite(cost[i]):
            stack += [ix[: ix.size // 2], ix[ix.size // 2 :]]
            continue
        stack += [ix[b <= i], ix[b > i]]
    return out


def march_pack(pos_s: np.ndarray, packed: np.ndarray, p: int):
    """The march pack of the first `p` (real) sorted prims, as the
    reference's commit_geometry builds it (:252-280).  pos_s: [P, 3, 3]
    sorted positions; packed: [P, 12] rows.  Returns (march_tris,
    march_prim, march_min, march_max, chunk_of_prim) as numpy arrays.

    The chunk size starts at 256 up to 65536 real prims, else 64
    (MCPT_MARCH_LEAF overrides), and doubles while the SAH partition
    has more than MCPT_MARCH_MAX_CHUNKS (2048) chunks."""
    sv0, sv1, sv2 = pos_s[:p, 0], pos_s[:p, 1], pos_s[:p, 2]
    s_min = np.minimum(np.minimum(sv0, sv1), sv2)
    s_max = np.maximum(np.maximum(sv0, sv1), sv2)
    s_cent = 0.5 * (s_min + s_max)
    default_leaf = 256 if p <= (1 << 16) else 64
    leaf = int(os.environ.get("MCPT_MARCH_LEAF", default_leaf))
    max_chunks = int(os.environ.get("MCPT_MARCH_MAX_CHUNKS", 2048))
    # the chunks of csrc/sah.c, as the reference's commit_geometry takes
    # them wherever gcc builds: _sah_chunks_py's chunks, listed left child
    # first, the reverse of its list (ROADMAP section 3, R3).  A failed
    # build raises.
    chunks = native.sah_chunks(s_cent, s_min, s_max, leaf)
    while len(chunks) > max_chunks:
        leaf *= 2
        chunks = native.sah_chunks(s_cent, s_min, s_max, leaf)
    n_march = len(chunks)
    march_tris = np.zeros((n_march, leaf, 12), np.float32)
    march_prim = np.zeros((n_march, leaf), np.int32)
    march_min = np.full((n_march, 3), 3.0e37, np.float32)  # empty = far point
    march_max = np.full((n_march, 3), 3.0e37, np.float32)
    chunk_of_prim = np.zeros(packed.shape[0], np.int32)  # padding prims -> 0
    for j, ix in enumerate(chunks):
        rows = packed[ix]
        rows[:, 10] = ix.astype(np.float32)  # global prim id (exact < 2^24)
        march_tris[j, : ix.size] = rows
        march_prim[j, : ix.size] = ix
        march_min[j] = s_min[ix].min(axis=0)
        march_max[j] = s_max[ix].max(axis=0)
        chunk_of_prim[ix] = j
    return march_tris, march_prim, march_min, march_max, chunk_of_prim


def commit_geometry(tri_positions, tri_normals, tri_texcoords, tri_tangents,
                    tri_inst_id, device, tri_opaque=None,
                    leaf_size: int = LEAF_SIZE) -> Geometry:
    """Build the device Geometry from host triangle soup ([P,3,3] world
    positions, optional [P,3,3] normals, [P,3,2] uvs, [P,3,3] tangents);
    `leaf_size` prims a BVH leaf, which sets the padding."""
    pos = np.asarray(tri_positions, np.float32)
    p = pos.shape[0]
    inst = np.asarray(tri_inst_id, np.int32)
    opaque = (
        np.ones(p, np.bool_) if tri_opaque is None
        else np.asarray(tri_opaque, np.bool_)
    )

    if tri_normals is None:
        gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        normals = np.repeat(gn[:, None, :], 3, axis=1)
    else:
        normals = np.asarray(tri_normals, np.float32)
    if tri_texcoords is None:
        texcoords = np.zeros((p, 3, 2), np.float32)
        texcoords[:, 1, 0] = 1.0
        texcoords[:, 2, 1] = 1.0
    else:
        texcoords = np.asarray(tri_texcoords, np.float32)
    if tri_tangents is None:
        t, b = _tangent_frames(normals.reshape(-1, 3))
        tangents = t.reshape(p, 3, 3)
        bitangents = b.reshape(p, 3, 3)
    else:
        tangents = np.asarray(tri_tangents, np.float32)
        bitangents = np.cross(normals, tangents)
        bl = np.linalg.norm(bitangents, axis=-1, keepdims=True)
        bitangents = bitangents / np.maximum(bl, 1e-12)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    # the acceleration build: the BVH's order, the SAH march pack, the
    # super-chunk unions
    global accel_ns
    t0 = time.perf_counter_ns()
    with trace.span("scene.accel"):
        bvh = build_bvh(pos.min(axis=1), pos.max(axis=1), leaf_size)
        order = bvh.order
        real = order >= 0

        def pick(a):
            out = np.zeros((order.shape[0],) + a.shape[1:], a.dtype)
            out[real] = a[order[real]]
            return out

        pos_s = pick(pos)
        nor_s = pick(normals)
        uv_s = pick(texcoords)
        tan_s = pick(tangents)
        bit_s = pick(bitangents)
        opaque_s = pick(opaque)

        packed = np.zeros((pos_s.shape[0], 12), np.float32)
        packed[:, 0:3] = pos_s[:, 0]
        packed[:, 3:6] = pos_s[:, 1] - pos_s[:, 0]
        packed[:, 6:9] = pos_s[:, 2] - pos_s[:, 0]
        packed[:, 9] = opaque_s.astype(np.float32)
        m_tris, m_prim, m_min, m_max, chunk_of_prim = march_pack(
            pos_s, packed, p)
        super_min, super_max = super_boxes(dev(m_min), dev(m_max))
    accel_ns += time.perf_counter_ns() - t0

    return Geometry(
        p0=dev(pos_s[:, 0]),
        e1=dev(pos_s[:, 1] - pos_s[:, 0]),
        e2=dev(pos_s[:, 2] - pos_s[:, 0]),
        n0=dev(nor_s[:, 0]), n1=dev(nor_s[:, 1]), n2=dev(nor_s[:, 2]),
        tg0=dev(tan_s[:, 0]), tg1=dev(tan_s[:, 1]), tg2=dev(tan_s[:, 2]),
        bt0=dev(bit_s[:, 0]), bt1=dev(bit_s[:, 1]), bt2=dev(bit_s[:, 2]),
        uv0=dev(uv_s[:, 0]), uv1=dev(uv_s[:, 1]), uv2=dev(uv_s[:, 2]),
        inst_id=dev(pick(inst)),
        opaque=dev(opaque_s),
        packed_tris=dev(packed),
        march_tris=dev(m_tris),
        march_prim=dev(m_prim),
        march_min=dev(m_min),
        march_max=dev(m_max),
        march_super_min=super_min,
        march_super_max=super_max,
        march_chunk_of_prim=dev(chunk_of_prim),
        bounds_min=dev(pos.min(axis=(0, 1))),
        bounds_max=dev(pos.max(axis=(0, 1))),
        node_min=dev(bvh.node_min),
        node_max=dev(bvh.node_max),
    )
