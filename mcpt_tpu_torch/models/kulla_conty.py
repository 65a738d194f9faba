"""Kulla-Conty multiple-scattering energy-compensation tables
(counterpart of mcpt_tpu/models/kulla_conty.py; csrt
src/renderer/bsdfs/kulla_conty.cpp:12-143).

A 128x128 directional-albedo table E(mu, alpha) and a 128-entry average
albedo E_avg(alpha), by the reference's 1024-node GGX quadrature (xi0 =
i/S stratified, xi1 = VdC_2(i)), computed once per device with torch.
The lookups are plain bilinear and linear reads of the corner texels,
clamped as the reference clamps; the reference's soft-one-hot matmul is
the same function, shaped for the TPU's matrix unit.
"""

from __future__ import annotations

import torch

from mcpt_tpu_torch.ops import rng
from mcpt_tpu_torch.ops.math import sqr
from mcpt_tpu_torch.ops.microfacet import sample_ggx, smith_g1

LUT_RESOLUTION = 128  # csrt kulla_conty.hpp:9
_N_SAMPLES = 1024
#: roughness rows computed at a time ([rows, 128, 1024, 3] intermediates)
_ROWS = 16

_tables: dict = {}


def _compute_tables(device):
    res = LUT_RESOLUTION
    step = 1.0 / res
    f32 = dict(dtype=torch.float32, device=device)
    roughness = (torch.arange(res, **f32) + 0.5) * step  # [R]
    n_dot_v = (torch.arange(res, **f32) + 0.5) * step    # [C]
    i = torch.arange(_N_SAMPLES, device=device)
    xi0 = i.to(torch.float32) / _N_SAMPLES               # [S]
    xi1 = rng.van_der_corput_base2(i)                    # [S]

    # view vector into the surface: V = (-sin, 0, -mu)   [C, 3]
    sin_v = torch.sqrt(torch.clamp(1.0 - sqr(n_dot_v), min=0.0))
    v = torch.stack([-sin_v, torch.zeros_like(n_dot_v), -n_dot_v], dim=-1)
    v_b = v[None, :, None, :]                            # [1, C, 1, 3]

    brdf_rows, albedo_rows = [], []
    for r0 in range(0, res, _ROWS):
        a = roughness[r0:r0 + _ROWS, None]
        h, _ = sample_ggx(xi0[None, :], xi1[None, :], a, a)  # [r, S, 3]
        h_b = h[:, None, :, :]                           # [r, 1, S, 3]
        # L = reflect(V, H): [r, C, S, 3]
        l = v_b - 2.0 * (v_b * h_b).sum(dim=-1, keepdim=True) * h_b
        l = l / torch.linalg.norm(l, dim=-1, keepdim=True)
        alpha = a[:, :, None]
        g = smith_g1(alpha, alpha, -v_b, h_b) * smith_g1(alpha, alpha, l, h_b)
        n_dot_l = l[..., 2]
        n_dot_h = h_b[..., 2]
        h_dot_v = (h_b * -v_b).sum(dim=-1)
        ok = (n_dot_l > 0.0) & (n_dot_h > 0.0) & (h_dot_v > 0.0)
        contrib = torch.where(
            ok, (h_dot_v * g) / torch.clamp(
                n_dot_v[None, :, None] * n_dot_h, min=1e-8),
            torch.zeros_like(g))
        brdf = torch.clamp(contrib.mean(dim=-1), max=1.0)  # [r, C]
        cell = torch.where(ok, brdf[..., None] * n_dot_l,
                           torch.zeros_like(n_dot_l)).mean(dim=-1) * 2.0
        brdf_rows.append(brdf)
        albedo_rows.append(cell.mean(dim=-1))
    return torch.cat(brdf_rows), torch.cat(albedo_rows)


def get_tables(device="cuda"):
    """(brdf_avg [128, 128] indexed [roughness, cos], albedo_avg [128]) on
    `device`, computed on its first request and kept for the process."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _tables:
        _tables[device] = _compute_tables(device)
    return _tables[device]


def _coord(x, res):
    """Texel pair and weight of a lookup at `x` in [0, res): (i0, i1, t)
    with weight 1 - t at i0 and t at i1 = min(i0 + 1, res - 1)."""
    x = torch.clamp(x * res, 0.0, res - 1.0)
    i0 = torch.floor(x)
    t = x - i0
    i0 = i0.long().clamp(0, res - 1)
    return i0, torch.clamp(i0 + 1, max=res - 1), t


def lookup_brdf_avg(brdf_avg, cos_theta, roughness):
    """Bilinear lookup of E(mu, alpha), clamped at the top row and column
    (csrt kulla_conty.cpp:82-131)."""
    res = LUT_RESOLUTION
    r0, r1, tr = _coord(roughness, res)
    c0, c1, tc = _coord(cos_theta, res)
    row0 = (1.0 - tc) * brdf_avg[r0, c0] + tc * brdf_avg[r0, c1]
    row1 = (1.0 - tc) * brdf_avg[r1, c0] + tc * brdf_avg[r1, c1]
    return (1.0 - tr) * row0 + tr * row1


def lookup_albedo_avg(albedo_avg, roughness):
    """Linear lookup of E_avg(alpha) (csrt kulla_conty.cpp:133-143)."""
    i0, i1, t = _coord(roughness, LUT_RESOLUTION)
    return (1.0 - t) * albedo_avg[i0] + t * albedo_avg[i1]
