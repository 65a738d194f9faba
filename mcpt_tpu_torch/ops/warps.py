"""Sampling warps (counterpart of mcpt_tpu/ops/warps.py; csrt
src/utils/math.cpp:15-55).  Uniform samples in [0,1)^2 map to a z-up
local frame, batched over leading dims."""

from __future__ import annotations

import torch

from mcpt_tpu_torch.ops.math import INV_PI, TWO_PI, cos, sin, sqr, sqrt


def sample_cone_uniform(cos_cutoff, xi0, xi1):
    """Uniform direction in a cone around +z (math.cpp:15-22)."""
    cos_theta = 1.0 - (1.0 - cos_cutoff) * xi0
    phi = TWO_PI * xi1
    sin_theta = sqrt(torch.clamp(1.0 - sqr(cos_theta), min=0.0))
    return torch.stack(
        [sin_theta * cos(phi), sin_theta * sin(phi), cos_theta],
        dim=-1,
    )


def sample_sphere_uniform(xi0, xi1):
    """Uniform direction on the sphere (math.cpp:24-29); pdf = 1/4pi."""
    return sample_cone_uniform(-1.0, xi0, xi1)


def sample_hemisphere_cosine(xi0, xi1):
    """Cosine-weighted hemisphere sample around +z (math.cpp:31-38).
    Returns (direction, pdf) with pdf = cos_theta / pi."""
    cos_theta = sqrt(xi0)
    phi = TWO_PI * xi1
    sin_theta = sqrt(torch.clamp(1.0 - sqr(cos_theta), min=0.0))
    vec = torch.stack(
        [sin_theta * cos(phi), sin_theta * sin(phi), cos_theta],
        dim=-1,
    )
    return vec, INV_PI * cos_theta


def sample_triangle_uniform(xi0, xi1):
    """sqrt-warp uniform barycentrics (csrt triangle.cpp:150-160).
    Returns (w, u, v), the weights of vertices (0, 1, 2)."""
    temp = sqrt(torch.clamp(1.0 - xi0, min=0.0))
    u = 1.0 - temp
    v = temp * xi1
    w = 1.0 - u - v
    return w, u, v


def searchsorted_cdf(cdf: torch.Tensor, target: torch.Tensor):
    """CDF cell containing `target`: the first index with cdf[i] >= target,
    minus one, clipped to [0, K-2] (csrt BinarySearch, math.cpp:40-55).

    `cdf`: [K] inclusive prefix (cdf[0] == 0, cdf[-1] == 1)."""
    k = cdf.shape[-1]
    idx = torch.searchsorted(cdf, target, right=False)
    return torch.clamp(idx - 1, 0, k - 2)
