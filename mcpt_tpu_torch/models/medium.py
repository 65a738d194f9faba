"""Participating media (counterpart of mcpt_tpu/models/medium.py; csrt
src/renderer/medium/): homogeneous free-flight sampling, the isotropic
and Henyey-Greenstein phase functions.

SoA tables with one row per scene medium; every function is total over
the wavefront with a per-lane medium id `mid` (-1 = vacuum, which gives
an identity weight).  The channel-stratified spectral estimator:

* free flight (homogeneous.cpp:9-51): with probability
  `sampling_weight` draw an exponential distance from one uniformly
  chosen RGB channel's sigma_t; the spectral pdf is the channel mean,
  so the returned weight is transmittance (* sigma_s) / pdf;
* transmittance for NEE (homogeneous.cpp:53-82, the unscattered
  branch): weight = T / (sw * mean(T) + 1 - sw);
* HG phase (henyey_greenstein.cpp:9-62): a per-channel g, a
  channel-stratified inverse-CDF cos(theta), spectral pdf = the channel
  mean of the per-channel phase values.

Channel means are summed in channel order and divided by 3, so that
they round the same on the card and the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.ops.math import (
    EPSILON,
    EPSILON_FLOAT,
    INV_FOUR_PI,
    TWO_PI,
    cos,
    dot,
    exp,
    local_to_world,
    log1p,
    sin,
    sqr,
    sqrt,
)
from mcpt_tpu_torch.ops.warps import sample_sphere_uniform

PHASE_ISOTROPIC = 0
PHASE_HG = 1

#: uniform draws one call consumes, the same for every medium so that the
#: sample streams stay aligned
N_FLIGHT_DRAWS = 2
N_PHASE_DRAWS = 3


class MediumTables(NamedTuple):
    sigma_s: torch.Tensor          # [M, 3]
    sigma_t: torch.Tensor          # [M, 3]
    sampling_weight: torch.Tensor  # [M]
    phase_type: torch.Tensor       # [M] int32
    g: torch.Tensor                # [M, 3] HG asymmetry per channel


def build_medium_tables(infos, device="cpu") -> MediumTables:
    """Host commit (csrt medium.cpp:6-39): sampling_weight = the
    max-channel single-scattering albedo, clamped into [0.5, 1] when
    positive.  No medium gives one vacuum-like row."""
    m = max(len(infos), 1)
    sigma_s = np.zeros((m, 3), np.float32)
    sigma_t = np.ones((m, 3), np.float32)
    sw = np.zeros(m, np.float32)
    ptype = np.zeros(m, np.int32)
    g = np.zeros((m, 3), np.float32)
    for i, info in enumerate(infos):
        ss = np.asarray(info.sigma_s, np.float32)
        st = ss + np.asarray(info.sigma_a, np.float32)
        sigma_s[i] = ss
        sigma_t[i] = st
        albedo = ss / np.maximum(st, 1e-20)
        w = 0.0
        for c in range(3):
            if albedo[c] > w and st[c] > 0:
                w = float(albedo[c])
        if w > 0:
            w = max(w, 0.5)
        sw[i] = w
        ptype[i] = PHASE_HG if info.phase == "hg" else PHASE_ISOTROPIC
        g[i] = np.broadcast_to(np.asarray(info.g, np.float32), (3,))

    def dev(a):
        return torch.as_tensor(a, device=device)

    return MediumTables(sigma_s=dev(sigma_s), sigma_t=dev(sigma_t),
                        sampling_weight=dev(sw), phase_type=dev(ptype),
                        g=dev(g))


def empty_medium_tables(device="cpu") -> MediumTables:
    return build_medium_tables([], device)


def _mean3(x):
    return (x[..., 0] + x[..., 1] + x[..., 2]) / 3.0


def _channel(x3, xi):
    """x3[lane, int(xi * 3)]: one channel per lane, picked by a uniform."""
    c = torch.clamp((xi * 3).to(torch.int32), 0, 2).long()
    return torch.gather(x3, -1, c[..., None])[..., 0]


def _rows(mid):
    return torch.clamp(mid, min=0).long()


def _transmittance(sigma_t, distance):
    # clamped for masked lanes (distance MAX_FLOAT)
    return exp(-sigma_t * torch.clamp(distance, max=1e8)[..., None])


def sample_flight(tables: MediumTables, mid, max_distance, xi0, xi1):
    """Channel-stratified free-flight sampling (homogeneous.cpp:9-51).

    mid: [N] int (-1 = vacuum).  Returns (scattered [N] bool,
    distance [N], weight [N, 3] = attenuation / pdf, valid [N])."""
    has_med = mid >= 0
    row = _rows(mid)
    sw = tables.sampling_weight[row]
    sigma_t = tables.sigma_t[row]
    sigma_s = tables.sigma_s[row]

    try_scatter = (xi0 < sw) & has_med
    xi_r = xi0 / torch.clamp(sw, min=1e-12)
    st_c = _channel(sigma_t, xi1)
    dist_scatter = -log1p(-torch.clamp(xi_r, max=1.0 - 1e-7)) \
        / torch.clamp(st_c, min=1e-20)
    scattered = try_scatter & (dist_scatter < max_distance)
    distance = torch.where(scattered, dist_scatter, max_distance)

    trans = _transmittance(sigma_t, distance)
    pdf_scatter = sw * _mean3(sigma_t * trans)
    pdf_pass = sw * _mean3(trans) + (1.0 - sw)
    pdf = torch.where(scattered, pdf_scatter, pdf_pass)

    atten = torch.where(scattered[..., None], trans * sigma_s, trans)
    valid = (atten > EPSILON_FLOAT).any(dim=-1)
    weight = atten / torch.clamp(pdf, min=1e-20)[..., None]

    weight = torch.where(has_med[..., None], weight, torch.ones_like(weight))
    return scattered & has_med, distance, weight, valid | ~has_med


def eval_transmittance(tables: MediumTables, mid, distance):
    """NEE transmittance weight = T / pdf_pass (homogeneous.cpp:53-82, the
    unscattered branch).  Returns (weight [N, 3], valid [N])."""
    has_med = mid >= 0
    row = _rows(mid)
    sw = tables.sampling_weight[row]
    trans = _transmittance(tables.sigma_t[row], distance)
    pdf = sw * _mean3(trans) + (1.0 - sw)
    weight = trans / torch.clamp(pdf, min=1e-20)[..., None]
    valid = (trans > EPSILON_FLOAT).any(dim=-1)
    weight = torch.where(has_med[..., None], weight, torch.ones_like(weight))
    return weight, valid | ~has_med


def _hg_value(g, cos_theta):
    """Per-channel HG phase value (henyey_greenstein.cpp:28-29)."""
    temp = 1.0 + sqr(g) + 2.0 * cos_theta[..., None] * g
    temp = torch.clamp(temp, min=1e-8)
    return INV_FOUR_PI * (1.0 - sqr(g)) / (temp * sqrt(temp))


def _phase_result(is_hg, atten_hg):
    pdf = torch.where(is_hg, _mean3(atten_hg),
                      torch.full_like(atten_hg[..., 0], INV_FOUR_PI))
    atten = torch.where(is_hg[..., None], atten_hg,
                        torch.full_like(atten_hg, INV_FOUR_PI))
    return pdf, atten, pdf >= EPSILON


def sample_phase(tables: MediumTables, mid, wo, xi0, xi1, xi2):
    """Sample a scattered direction at a medium vertex.

    Returns (wi [N, 3], pdf [N], atten [N, 3], valid [N]); `wi` is the
    direction light travels (the continuation ray is -wi),
    henyey_greenstein.cpp:42 / isotropic.cpp:14."""
    row = _rows(mid)
    is_hg = tables.phase_type[row] == PHASE_HG
    g = tables.g[row]

    g_c = _channel(g, xi0)
    small = torch.abs(g_c) < EPSILON_FLOAT
    g_safe = torch.where(small, torch.ones_like(g_c), g_c)
    sqr_term = (1.0 - sqr(g_safe)) / (1.0 - g_safe + 2.0 * g_safe * xi1)
    cos_hg = (1.0 + sqr(g_safe) - sqr(sqr_term)) / (2.0 * g_safe)
    cos_iso_like = 1.0 - 2.0 * xi1
    cos_theta = torch.clamp(torch.where(is_hg & ~small, cos_hg, cos_iso_like),
                            -1.0, 1.0)

    atten_hg = _hg_value(g, cos_theta)
    sin_theta = sqrt(torch.clamp(1.0 - sqr(cos_theta), min=0.0))
    phi = TWO_PI * xi2
    local = torch.stack([sin_theta * cos(phi),
                         sin_theta * sin(phi), cos_theta], dim=-1)
    wi_hg = -local_to_world(local, wo)
    wi_iso = sample_sphere_uniform(xi1, xi2)

    wi = torch.where(is_hg[..., None], wi_hg, wi_iso)
    pdf, atten, valid = _phase_result(is_hg, atten_hg)
    return wi, pdf, atten, valid


def eval_phase(tables: MediumTables, mid, wi, wo):
    """Phase value and spectral pdf of `wi`, for NEE's MIS
    (henyey_greenstein.cpp:46-62, isotropic.cpp:18-23).  Returns
    (pdf [N], atten [N, 3], valid [N])."""
    row = _rows(mid)
    is_hg = tables.phase_type[row] == PHASE_HG
    atten_hg = _hg_value(tables.g[row], dot(-wi, wo))
    return _phase_result(is_hg, atten_hg)
