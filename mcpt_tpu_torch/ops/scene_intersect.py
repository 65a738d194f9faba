"""Scene-level intersection (counterpart of
mcpt_tpu/ops/scene_intersect.py:34-75), triangle scenes only.  The
reference merges its analytic-quadric sweep into the triangle hit here;
quadrics are ROADMAP item 15, so on this slice both queries are the
triangle traversal's."""

from __future__ import annotations

import torch

from mcpt_tpu_torch.ops.dense_sweep import GeomHit
from mcpt_tpu_torch.ops.traversal import intersect_any, intersect_closest


def scene_closest(scene, o, d, t_min=None, t_max=None,
                  sort_bias=None) -> GeomHit:
    return intersect_closest(scene.geom, o, d, t_min=t_min, t_max=t_max,
                             sort_bias=sort_bias)


def scene_any(scene, o, d, t_min=None, t_max=None) -> torch.Tensor:
    return intersect_any(scene.geom, o, d, t_min=t_min, t_max=t_max)
