"""Emitters (counterpart of mcpt_tpu/models/emitter.py): analytic lights
and the importance-sampled environment map.

Each analytic emitter is a row of an SoA table; the integrator unrolls
the scene's (static) emitter list, so every function here runs over the
whole wavefront for one row.  Conventions (csrt emitter.hpp:49-55):

* `wi` is the direction light travels (light -> surface);
* the shadow ray runs from the surface along -wi, `distance` long;
* point, spot, directional and sun lights are delta lights: no MIS, and
  the radiance carries the whole geometric coupling (1/d^2).

The reference's deviations hold here too: a point light emits
intensity / d^2 (csrt's returns zero), and the envmap's sample, eval and
pdf share one lat-long mapping, sampled texel by texel from a
Walker/Vose alias table over luminance * sin(theta).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.models import texture as textures
from mcpt_tpu_torch.ops.math import (
    INV_FOUR_PI,
    INV_PI,
    INV_TWO_PI,
    MAX_FLOAT,
    PI,
    TWO_PI,
    arccos,
    cartesian_to_spherical,
    length,
    local_to_world,
    mat_vec,
    normalize,
    sin,
    spherical_to_cartesian,
)
from mcpt_tpu_torch.ops.warps import sample_cone_uniform, sample_sphere_uniform
from mcpt_tpu_torch.scene.ir import EmitterType

#: maps of at most this many texels take the reference's Python alias
#: build; larger ones its native build's arithmetic (alias_build)
ALIAS_PY_MAX = 4096


class EmitterTables(NamedTuple):
    """One row per analytic emitter (point/spot/directional/sun/constant)."""

    etype: torch.Tensor            # [E] int32
    position: torch.Tensor         # [E, 3]
    intensity: torch.Tensor        # [E, 3]
    direction: torch.Tensor        # [E, 3] direction light travels
    radiance: torch.Tensor         # [E, 3]
    cos_cutoff: torch.Tensor       # [E] spot cutoff / sun aperture
    cos_beam: torch.Tensor         # [E] spot beam width
    cutoff_angle: torch.Tensor     # [E] radians
    trans_width_rcp: torch.Tensor  # [E] 1 / (cutoff - beam)
    uv_factor: torch.Tensor        # [E] tan(cutoff), projection texture
    to_local: torch.Tensor         # [E, 4, 4] spot world -> local
    tid: torch.Tensor              # [E] int32 projection / sun texture (-1)


class EnvMapData(NamedTuple):
    """Lat-long environment map with its alias table: one [n, 2] row
    gather picks a texel, one [n, 4] row gather gives its radiance and
    pdf * sin(theta) — the reference's CDF inversion (csrt
    envmap.cpp:20-98) replaced by the same texel distribution."""

    tid: torch.Tensor        # radiance texture id (bitmap), int32 scalar
    to_world: torch.Tensor   # [4, 4]
    to_local: torch.Tensor   # [4, 4]
    alias_tab: torch.Tensor  # [n, 2] int32: (f32 bits of accept prob, alias)
    texel_tab: torch.Tensor  # [n, 4] f32: (r, g, b, pdf(omega) sin(theta))
    width: int
    height: int


def build_emitter_tables(infos, device) -> EmitterTables:
    """Host commit of the analytic emitters (csrt emitter.cpp:122-164)."""
    e = max(len(infos), 1)
    etype = np.full(e, -1, np.int32)
    pos = np.zeros((e, 3), np.float32)
    inten = np.zeros((e, 3), np.float32)
    direc = np.zeros((e, 3), np.float32)
    direc[:, 1] = -1.0
    rad = np.zeros((e, 3), np.float32)
    cos_cut = np.ones(e, np.float32)
    cos_beam = np.ones(e, np.float32)
    cut_ang = np.zeros(e, np.float32)
    twr = np.ones(e, np.float32)
    uvf = np.ones(e, np.float32)
    to_local = np.tile(np.eye(4, dtype=np.float32), (e, 1, 1))
    tid = np.full(e, -1, np.int32)
    for i, info in enumerate(infos):
        etype[i] = int(info.etype)
        inten[i] = info.intensity
        rad[i] = info.radiance
        tid[i] = info.id_texture
        if info.etype == EmitterType.POINT:
            pos[i] = info.position
        elif info.etype == EmitterType.SPOT:
            m = np.asarray(info.to_world, np.float32)
            pos[i] = m[:3, 3]
            to_local[i] = np.linalg.inv(m)
            cut = np.radians(info.cutoff_angle)
            beam = np.radians(info.beam_width)
            cos_cut[i] = np.cos(cut)
            cos_beam[i] = np.cos(beam)
            cut_ang[i] = cut
            twr[i] = 1.0 / max(cut - beam, 1e-6)
            uvf[i] = np.tan(cut)
        elif info.etype in (EmitterType.DIRECTIONAL, EmitterType.SUN):
            d = np.asarray(info.direction, np.float32)
            direc[i] = d / max(np.linalg.norm(d), 1e-12)
            cos_cut[i] = np.cos(np.radians(info.cutoff_angle))

    def dev(a):
        return torch.as_tensor(a, device=device)

    return EmitterTables(
        etype=dev(etype), position=dev(pos), intensity=dev(inten),
        direction=dev(direc), radiance=dev(rad), cos_cutoff=dev(cos_cut),
        cos_beam=dev(cos_beam), cutoff_angle=dev(cut_ang),
        trans_width_rcp=dev(twr), uv_factor=dev(uvf), to_local=dev(to_local),
        tid=dev(tid),
    )


# ---------------------------------------------------------------------------
# Analytic emitters.  `e` is a Python int (the integrator unrolls the
# emitter rows).  Returns (wi [N,3], distance [N], radiance [N,3],
# valid [N]); the radiance includes a delta light's geometric coupling.


def _rotate(m, v):
    """The 3x3 part of `m` applied to directions [N, 3]."""
    return mat_vec(m, v)


def sample_point(tables, e, origin):
    """csrt point_light.cpp:8-19, with the intensity / d^2 the reference
    restores (module docstring)."""
    vec = origin - tables.position[e]
    dist = length(vec)
    wi = vec / dist[..., None]
    radiance = (tables.intensity[e]
                / torch.clamp(dist * dist, min=1e-12)[..., None])
    return wi, dist, radiance, torch.ones_like(dist, dtype=torch.bool)


def sample_spot(tables, tex, e, origin):
    """csrt spot_light.cpp:8-45: the cone cutoff, the falloff across the
    beam's edge and the optional projection texture."""
    vec = origin - tables.position[e]
    dist = length(vec)
    wi = vec / dist[..., None]
    dl = normalize(_rotate(tables.to_local[e], wi))
    valid = dl[..., 2] >= tables.cos_cutoff[e]

    tid = tables.tid[e]
    z = torch.clamp(dl[..., 2], min=1e-6)
    uv = torch.stack([
        0.5 + 0.5 * dl[..., 0] / (z * tables.uv_factor[e]),
        0.5 + 0.5 * dl[..., 1] / (z * tables.uv_factor[e]),
    ], dim=-1)
    tex_fall = textures.eval_color(
        tex, torch.clamp(tid, min=0).expand(dist.shape), uv)
    fall = torch.where(tid >= 0, tex_fall, torch.ones_like(origin))
    in_transition = dl[..., 2] < tables.cos_beam[e]
    trans = (tables.cutoff_angle[e]
             - arccos(torch.clamp(dl[..., 2], -1.0, 1.0))
             ) * tables.trans_width_rcp[e]
    fall = fall * torch.where(in_transition, trans,
                              torch.ones_like(trans))[..., None]
    radiance = (tables.intensity[e] * fall
                / torch.clamp(dist * dist, min=1e-12)[..., None])
    return wi, dist, radiance, valid


def _far(origin):
    return torch.full(origin.shape[:-1], MAX_FLOAT * 0.5, dtype=origin.dtype,
                      device=origin.device)


def sample_directional(tables, e, origin):
    """csrt directional_light.cpp:8-24."""
    dist = _far(origin)
    return (tables.direction[e].expand(origin.shape), dist,
            tables.radiance[e].expand(origin.shape),
            torch.ones_like(dist, dtype=torch.bool))


def sample_sun(tables, e, origin, xi0, xi1):
    """A cone of directions around the sun's (csrt sun.cpp:8-24)."""
    dl = sample_cone_uniform(tables.cos_cutoff[e], xi0, xi1)
    wi = local_to_world(dl, tables.direction[e].expand(origin.shape))
    dist = _far(origin)
    return (wi, dist, tables.radiance[e].expand(origin.shape),
            torch.ones_like(dist, dtype=torch.bool))


def eval_sun_escape(tables, tex, e, look_dir):
    """An escaping camera ray's lookup into the sun bitmap (csrt
    sun.cpp:26-32)."""
    theta, phi = cartesian_to_spherical(look_dir)
    uv = torch.stack([phi * INV_TWO_PI, theta * INV_PI], dim=-1)
    tid = torch.clamp(tables.tid[e], min=0).expand(theta.shape)
    return textures.eval_color(tex, tid, uv)


def sample_constant(tables, e, origin, xi0, xi1):
    """A uniform direction on the sphere, pdf 1/4pi (csrt
    constant_light.cpp:8-37).  Returns (wi, dist, radiance, pdf, valid):
    not a delta light, so it takes part in MIS."""
    wi = sample_sphere_uniform(xi0, xi1)
    dist = _far(origin)
    return (wi, dist, tables.radiance[e].expand(origin.shape),
            torch.full_like(dist, INV_FOUR_PI),
            torch.ones_like(dist, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Environment map


def _alias_build_py(weights: np.ndarray, sequential_total: bool = False):
    """Walker/Vose alias table (Vose 1991) in the reference's pairing
    order, which its native alias.c follows too.  The two differ only in
    the weights' total: numpy's pairwise sum in the reference's Python
    build (maps of at most ALIAS_PY_MAX texels), a running sum in alias.c
    (larger maps) — `sequential_total` picks the latter, so that either
    table comes out bit for bit.  Plain Python lists: the pairing loop is
    sequential, and any vectorised form pairs differently."""
    weights = np.asarray(weights, np.float64).reshape(-1)
    n = weights.shape[0]
    total = (float(np.add.accumulate(weights)[-1]) if sequential_total
             else float(weights.sum()))
    if not total > 0.0:
        raise ValueError("alias build: weights sum to zero")
    scaled_arr = weights * (n / total)
    scaled = scaled_arr.tolist()
    prob = [1.0] * n
    al = list(range(n))
    below = scaled_arr < 1.0
    small = np.flatnonzero(below).tolist()
    large = np.flatnonzero(~below).tolist()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        al[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
        al[i] = i
    # one f64 -> f32 rounding per entry, as np.float32(x) and (float)x
    return (np.asarray(prob, np.float64).astype(np.float32),
            np.asarray(al, np.int32))


def alias_build(weights: np.ndarray):
    """The reference's native alias_build (mcpt_tpu/native/alias.c) in
    Python: the same tables bit for bit."""
    return _alias_build_py(weights, sequential_total=True)


def build_envmap(pixels: np.ndarray, to_world: np.ndarray, tid: int,
                 device) -> EnvMapData:
    """Host-side alias table over luminance * sin(theta) (the reference's
    build_envmap).  pixels: [H, W, 3] f32 linear radiance.  Maps above
    2^24 texels are box-downscaled 2x until they fit, so that a 24-bit
    uniform indexes rows and columns exactly; an all-black map falls back
    to importance by sin(theta) alone."""
    pixels = np.asarray(pixels, np.float32)
    while pixels.shape[0] * pixels.shape[1] > (1 << 24):
        h2, w2 = pixels.shape[0] // 2 * 2, pixels.shape[1] // 2 * 2
        p = pixels[:h2, :w2]
        pixels = 0.25 * (
            p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]
        )
    h, w = pixels.shape[:2]
    lum = (0.2126 * pixels[..., 0] + 0.7152 * pixels[..., 1]
           + 0.0722 * pixels[..., 2])
    sin_row = np.sin((np.arange(h) + 0.5) * np.pi / h).astype(np.float32)
    f = np.maximum(lum * sin_row[:, None], 0.0)
    if not float(f.sum()) > 0.0:
        f = np.broadcast_to(sin_row[:, None], lum.shape).astype(np.float32)
    total = max(float(f.sum()), 1e-20)
    prob, al = (_alias_build_py(f) if f.size <= ALIAS_PY_MAX
                else alias_build(f))

    # pdf(omega) = p_texel * W * H / (2 pi^2 sin(theta)); the table keeps
    # pdf * sin(theta), so eval needs only the direction's own sin(theta)
    pdf_sin = (f.reshape(-1) / total) * (w * h) / (2.0 * np.pi**2)
    texel_tab = np.concatenate(
        [pixels.reshape(-1, 3), pdf_sin[:, None].astype(np.float32)], axis=1)
    alias_tab = np.stack([prob.view(np.int32), al], axis=1)
    m = np.asarray(to_world, np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return EnvMapData(
        tid=dev(np.int32(tid)), to_world=dev(m),
        to_local=dev(np.linalg.inv(m)), alias_tab=dev(alias_tab),
        texel_tab=dev(texel_tab), width=w, height=h,
    )


def sample_envmap(env: EnvMapData, tex, origin, xi0, xi1, xi2,
                  differentiable: bool = False):
    """An alias-table texel draw with a uniform jitter inside the texel.
    Returns (wi, dist, radiance, pdf, valid); wi = minus the direction
    toward the texel.  xi0 -> row and v jitter, xi1 -> column and u
    jitter, xi2 -> the alias coin.  The radiance is the texel table's
    (nearest), or with `differentiable` the envmap bitmap's bilinear read
    through the texture atlas, whose gradient reaches the atlas; each mode
    agrees with the matching eval_envmap (mcpt_tpu/models/emitter.py:
    337-390)."""
    h, w = env.height, env.width
    rx = xi0 * h
    cx = xi1 * w
    row = torch.clamp(rx.to(torch.int32), 0, h - 1)
    col = torch.clamp(cx.to(torch.int32), 0, w - 1)
    jv = torch.clamp(rx - row.to(torch.float32), 0.0, 1.0)
    ju = torch.clamp(cx - col.to(torch.float32), 0.0, 1.0)
    j = row * w + col

    ar = env.alias_tab[j.long()]                 # [N, 2] row gather
    prob = ar[..., 0].contiguous().view(torch.float32)
    jj = torch.where(xi2 < prob, j, ar[..., 1])
    row = torch.div(jj, w, rounding_mode="floor")
    col = jj - row * w

    v = (row.to(torch.float32) + jv) / h
    u = (col.to(torch.float32) + ju) / w
    theta = v * PI
    phi = u * TWO_PI
    wi = -normalize(_rotate(env.to_world, spherical_to_cartesian(theta, phi)))
    tx = env.texel_tab[jj.long()]                # [N, 4] row gather
    radiance = (textures.eval_color(tex, env.tid, torch.stack([u, v], -1))
                if differentiable else tx[..., :3])
    sin_t = torch.clamp(torch.abs(sin(theta)), min=1e-4)
    pdf = tx[..., 3] / sin_t
    return wi, _far(origin), radiance, pdf, pdf > 0.0


def _dir_to_texel(env: EnvMapData, look_dir):
    """World direction -> (uv, theta, texel index) of the lat-long map
    (csrt envmap.cpp:100-107)."""
    dl = normalize(_rotate(env.to_local, look_dir))
    theta, phi = cartesian_to_spherical(dl)
    u = phi * INV_TWO_PI
    v = theta * INV_PI
    row = torch.clamp((v * env.height).to(torch.int32), 0, env.height - 1)
    col = torch.clamp((u * env.width).to(torch.int32), 0, env.width - 1)
    return torch.stack([u, v], -1), theta, (row * env.width + col).long()


def eval_envmap(env: EnvMapData, tex, look_dir, differentiable: bool = False):
    """An escaping ray's radiance: the texel table's (nearest) value, or
    with `differentiable` the bilinear atlas read of sample_envmap."""
    uv, _, j = _dir_to_texel(env, look_dir)
    if differentiable:
        return textures.eval_color(tex, env.tid, uv)
    return env.texel_tab[j][..., :3]


def pdf_envmap(env: EnvMapData, tex, look_dir):
    """sample_envmap's pdf of an escaping direction, for MIS (cf. csrt
    envmap.cpp:109-133)."""
    _, theta, j = _dir_to_texel(env, look_dir)
    sin_t = torch.clamp(torch.abs(sin(theta)), min=1e-4)
    return env.texel_tab[j][..., 3] / sin_t


def empty_envmap(device) -> EnvMapData:
    """The placeholder of a scene without an envmap."""
    eye = torch.eye(4, device=device)
    return EnvMapData(
        tid=torch.zeros((), dtype=torch.int32, device=device),
        to_world=eye, to_local=eye.clone(),
        alias_tab=torch.zeros((1, 2), dtype=torch.int32, device=device),
        texel_tab=torch.zeros((1, 4), device=device), width=1, height=1,
    )
