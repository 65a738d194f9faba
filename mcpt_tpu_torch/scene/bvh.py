"""Morton primitive order (counterpart of mcpt_tpu/scene/bvh.py).

The reference sorts primitives by the 30-bit Morton code of their AABB
centroids (csrt bvh_builder.cpp:39-48,125) and pads them to
`leaf_size * 2^ceil(log2(n_leaves))` slots for its implicit BVH.  The
port's traversals walk no tree (the dense sweep, and the march over SAH
chunks, scene/geometry.py), but the port keeps the same order and padding
so that prim k here is prim k in the reference.  Of the node boxes only
the root's is read (the ray sort keys' scene bounds), and geometry.py
keeps it as bounds_min / bounds_max.
"""

from __future__ import annotations

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


def morton_order(prim_min: np.ndarray, prim_max: np.ndarray,
                 leaf_size: int = 4) -> np.ndarray:
    """Sorted prim indices padded with -1 to the reference's slot count
    ([P_pad] int32), as build_bvh's `order`."""
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
    order_pad = np.full(n_pad_leaves * leaf_size, -1, np.int32)
    order_pad[:n] = order
    return order_pad
