"""The implicit BVH over Morton-sorted primitives (counterpart of
mcpt_tpu/scene/bvh.py).

Primitives are sorted by the 30-bit Morton code of their AABB centroids
(csrt bvh_builder.cpp:39-48,125) and padded to
`leaf_size * 2^ceil(log2(n_leaves))` slots, under a complete binary tree:
node i's children are 2i+1 and 2i+2, the leaves start at n_pad_leaves - 1
and each covers `leaf_size` consecutive sorted primitives.  Node boxes are
built bottom-up, one vectorised union per level.  The topology is
implicit, so the packet walk (ops/packet_sweep.py, kernel K5) reads only
the node boxes and the leaves' rows of the packed triangle table.

Padding leaves get inverted boxes (min 3e38, max -3e38).  Under the
min/max slab test such a box is a slab of every t on each axis, so every
ray enters it: padding subtrees are visited, and their zero rows never
hit.  That costs work, not results; the port keeps the reference's boxes
so that its walk visits the nodes the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each element 3 apart (Morton helper)."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalized to [0,1)^3."""
    grid = np.clip(points * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits(grid[:, 0]) << np.uint32(2))
        | (_expand_bits(grid[:, 1]) << np.uint32(1))
        | _expand_bits(grid[:, 2])
    )


@dataclasses.dataclass
class BvhArrays:
    """The host build (numpy; geometry.py moves the boxes to the device)."""

    node_min: np.ndarray   # [M, 3] float32
    node_max: np.ndarray   # [M, 3] float32
    order: np.ndarray      # [P_pad] int32 sorted prim indices, -1 = padding
    n_nodes: int           # M = 2 * n_pad_leaves - 1
    n_pad_leaves: int
    leaf_size: int
    depth: int             # log2(n_pad_leaves)


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray,
              leaf_size: int = 4) -> BvhArrays:
    """The implicit BVH over primitive AABBs prim_min, prim_max [P, 3]."""
    prim_min = np.asarray(prim_min, np.float32)
    prim_max = np.asarray(prim_max, np.float32)
    n = prim_min.shape[0]
    if n == 0:
        raise ValueError("empty scene")

    centroid = 0.5 * (prim_min + prim_max)
    lo = centroid.min(axis=0)
    span = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = morton3d((centroid - lo) / span)
    # tie-broken by index: the reference packs (morton << 32) | index
    order = np.lexsort((np.arange(n), codes)).astype(np.int32)

    n_leaves = -(-n // leaf_size)
    n_pad_leaves = 1 << max(0, (n_leaves - 1).bit_length())
    depth = (n_pad_leaves - 1).bit_length()
    p_pad = n_pad_leaves * leaf_size
    order_pad = np.full(p_pad, -1, np.int32)
    order_pad[:n] = order

    # leaf boxes: a reduction over each leaf's prims; padding slots get
    # inverted boxes
    big = np.float32(3.0e38)
    lmin = np.full((p_pad, 3), big, np.float32)
    lmax = np.full((p_pad, 3), -big, np.float32)
    lmin[:n] = prim_min[order]
    lmax[:n] = prim_max[order]

    m = 2 * n_pad_leaves - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    node_min[n_pad_leaves - 1:] = lmin.reshape(n_pad_leaves, leaf_size, 3).min(1)
    node_max[n_pad_leaves - 1:] = lmax.reshape(n_pad_leaves, leaf_size, 3).max(1)
    # bottom-up union, one vectorised step a level
    level_lo, level_hi = n_pad_leaves - 1, m
    while level_lo > 0:
        child_min = node_min[level_lo:level_hi]
        child_max = node_max[level_lo:level_hi]
        parent_lo = (level_lo - 1) // 2
        node_min[parent_lo:level_lo] = np.minimum(child_min[0::2], child_min[1::2])
        node_max[parent_lo:level_lo] = np.maximum(child_max[0::2], child_max[1::2])
        level_lo, level_hi = parent_lo, level_lo

    return BvhArrays(node_min=node_min, node_max=node_max, order=order_pad,
                     n_nodes=m, n_pad_leaves=n_pad_leaves,
                     leaf_size=leaf_size, depth=depth)
