"""Scene-level intersection (counterpart of
mcpt_tpu/ops/scene_intersect.py:34-75): the triangle traversal's hit
merged per lane with the analytic-quadric sweep.  For scenes without
quadrics both queries are the triangle traversal's alone."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.ops.math import EPSILON_DISTANCE, MAX_FLOAT
from mcpt_tpu_torch.ops.quadric import intersect_quadrics
from mcpt_tpu_torch.ops.traversal import intersect_any, intersect_closest


class SceneHit(NamedTuple):
    """GeomHit plus the quadric row (-1 = a triangle hit or a miss)."""

    valid: torch.Tensor
    t: torch.Tensor
    prim: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    inside: torch.Tensor
    quad: torch.Tensor


def _bound(x, default):
    return default if x is None else x


def scene_closest(scene, o, d, t_min=None, t_max=None, sort_bias=None,
                  coherence=None) -> SceneHit:
    with trace.span("trace"):
        g = intersect_closest(scene.geom, o, d, t_min=t_min, t_max=t_max,
                              sort_bias=sort_bias, coherence=coherence)
        if not scene.quad_kinds:
            return SceneHit(*g, quad=torch.full_like(g.prim, -1))
        qt, qidx, qin = intersect_quadrics(
            scene.quad, scene.quad_kinds, o, d,
            _bound(t_min, EPSILON_DISTANCE), _bound(t_max, MAX_FLOAT))
        take = (qidx >= 0) & (~g.valid | (qt < g.t))
        zero = torch.zeros_like(g.v)
        return SceneHit(
            valid=g.valid | (qidx >= 0),
            t=torch.where(take, qt, g.t),
            prim=torch.where(take, torch.zeros_like(g.prim), g.prim),
            v=torch.where(take, zero, g.v),
            w=torch.where(take, zero, g.w),
            inside=torch.where(take, qin, g.inside),
            quad=torch.where(take, qidx, torch.full_like(qidx, -1)),
        )


def scene_any(scene, o, d, t_min=None, t_max=None,
              coherence=None) -> torch.Tensor:
    with trace.span("trace"):
        occ = intersect_any(scene.geom, o, d, t_min=t_min, t_max=t_max,
                            coherence=coherence)
        if not scene.quad_kinds:
            return occ
        _, qidx, _ = intersect_quadrics(
            scene.quad, scene.quad_kinds, o, d,
            _bound(t_min, EPSILON_DISTANCE), _bound(t_max, MAX_FLOAT),
            any_hit=True)
        return occ | (qidx >= 0)
