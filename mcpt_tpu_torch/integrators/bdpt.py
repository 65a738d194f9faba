"""Wavefront bidirectional path tracing (counterpart of
mcpt_tpu/integrators/bdpt.py; archive/src/integrators/bdpt.cpp, which the
reference keeps in its v1 archive only).

Structure, as the reference's:

1. `_light_subpath` builds a K_LIGHT-vertex light subpath a lane
   (CreateEmitterPath, bdpt.cpp:70-157): a light point from the area-light
   CDF, a cosine-weighted emission, then BSDF-sampled extensions; each
   surface vertex carries its incident throughput beta_in (the Veach alpha
   recurrence).
2. `shade` walks the camera path (ShadeIterately, bdpt.cpp:159-313): each
   bounce takes NEE, connects to every light-subpath vertex (a visibility
   ray, the BSDF at both ends, the area-measure conversion, a pairwise
   power-heuristic combination across the connections, bdpt.cpp:168-245),
   then continues by BSDF sampling with the archive's down-weight of the
   continuation against the connections (bdpt.cpp:269-283).

Deviations of the reference, kept here:

* the archive's RR guard `if (i > pdf_rr_)` compares the loop index to the
  RR probability, so it always divides (bdpt.cpp:149-152); depth_rr is
  used as intended;
* the weights are the archive's pairwise power heuristics, not
  Veach-complete MIS (the reference measured an energy deficit of
  -8% +- 2.4% on the specular caustic, GOLDEN.md); MIS pdfs are the true
  sampling pdfs;
* a connection needs both endpoints connectible (bsdf.is_connectible:
  diffuse-dominated, or a microfacet lobe of alpha >= 0.05); where one is
  not, the continuation keeps its full weight, so the pair partitions.

Every lane draws the same uniforms in every bounce: the light subpath's
light_subpath_draws, then a bounce's RR coin, nee_draw_count, the alpha
walk's SHADOW_ALPHA_K a connection where the scene has opacity maps, and
N_SAMPLE_DRAWS.  The bounce loop always runs min(depth_max, 8) - 1
bounces, as the reference's unrolled loop does: the seed it returns goes
on to the pixel's next sample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcpt_tpu_torch.integrators.path import (
    SHADOW_ALPHA_K,
    _bsdf_eval,
    _bsdf_sample,
    _chunked_primary,
    _direct_lighting,
    _emitter_hit,
    _escape,
    _no_lights,
    _roulette,
    _sample_area_light,
    _stex,
    _where3,
    apply_opacity,
    interpolate_hit,
    nee_draw_count,
    shadow_occluded,
)
from mcpt_tpu_torch.models import bsdf as bsdfs
from mcpt_tpu_torch.ops import rng
from mcpt_tpu_torch.ops.math import (
    EPSILON,
    EPSILON_FLOAT,
    MAX_FLOAT,
    build_onb,
    dot,
    mis_weight,
    sqrt,
    take_rows,
    to_world,
)
from mcpt_tpu_torch.ops.scene_intersect import scene_closest
from mcpt_tpu_torch.ops.warps import sample_hemisphere_cosine
from mcpt_tpu_torch.scene.compile import SceneData

#: surface vertices of the light subpath beyond the light point
K_LIGHT = 3

#: the camera path's bounce cap (the reference unrolls its loop)
DEPTH_CAP = 8


class LightVertex(NamedTuple):
    """A light-subpath vertex: the hit fields _bsdf_eval reads, and the
    light that arrives there."""

    valid: torch.Tensor      # [N] bool
    position: torch.Tensor   # [N, 3]
    normal: torch.Tensor     # [N, 3] oriented shading normal
    tangent: torch.Tensor    # [N, 3]
    bitangent: torch.Tensor  # [N, 3]
    uv: torch.Tensor         # [N, 2]
    inside: torch.Tensor     # [N] bool
    bsdf_id: torch.Tensor    # [N] int32
    inst_id: torch.Tensor    # [N] int32
    wi_in: torch.Tensor      # [N, 3] the direction light travels into it
    #: [N, 3] emitted radiance carried along the subpath, divided by every
    #: sampling pdf up to this vertex
    beta_in: torch.Tensor
    cos_in: torch.Tensor     # [N] |n . wi_in|


def light_subpath_draws(scene: SceneData) -> int:
    """Uniforms `_light_subpath` consumes: 5 for the light point and its
    emission, one opacity draw a vertex where the scene has opacity maps,
    N_SAMPLE_DRAWS an extension (bdpt.py:88-91)."""
    opacity = 1 if scene.has_opacity else 0
    return 5 + K_LIGHT * opacity + (K_LIGHT - 1) * bsdfs.N_SAMPLE_DRAWS


def _light_subpath(scene: SceneData, integ, seed, n):
    """The light subpath with its Veach throughputs (bdpt.py:94-205):

        beta_1   = Le cos(light) / (pdf_area pdf_dir)
        beta_k+1 = beta_k f(wi_in -> dir_next) cos_out / (cos_in pdf_sample)

    (f includes the incident cosine, hence cos_out / cos_in), so that a
    connection's unweighted contribution beta f_v cos_conn / (cos_in d^2)
    f_cam is unbiased for its strategy.  Returns (vertices, seed)."""
    seed, xi = rng.random_floats(seed, 5)
    pos0, n0, rad0, pdf_area0 = _sample_area_light(scene, xi[0], xi[1], xi[2])
    d_local, pdf_dir0 = sample_hemisphere_cosine(xi[3], xi[4])
    t0, b0 = build_onb(n0)
    dir0 = to_world(d_local, t0, b0, n0)

    vertices = []
    prev_pos, prev_dir = pos0, dir0
    prev_valid = torch.full((n,), scene.n_emissive > 0, dtype=torch.bool,
                            device=seed.device)
    cos0 = torch.abs(dot(dir0, n0))
    beta = (rad0 * cos0[..., None]
            / torch.clamp(pdf_area0 * pdf_dir0, min=1e-12)[..., None])
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=seed.device)

    for k in range(K_LIGHT):
        ghit = scene_closest(scene, prev_pos, prev_dir, t_max=torch.where(
            prev_valid, torch.full_like(cos0, MAX_FLOAT),
            torch.zeros_like(cos0)))
        hit = interpolate_hit(scene, ghit, prev_pos, prev_dir)
        hit, seed = apply_opacity(scene, hit, seed)
        has_b = hit.bsdf_id >= 0
        is_em = bsdfs.is_emitter(scene.bsdf, hit.bsdf_id) & has_b
        backface = (hit.inside & ~bsdfs.is_twosided(scene.bsdf, hit.bsdf_id)
                    & has_b)
        valid = prev_valid & hit.valid & ~is_em & ~backface & has_b

        wi_in = prev_dir
        cos_in = torch.clamp(torch.abs(dot(wi_in, hit.normal)), min=1e-6)
        if k >= integ.depth_rr:
            beta = beta / integ.pdf_rr
        vertices.append(LightVertex(
            valid=valid, position=hit.position, normal=hit.normal,
            tangent=hit.tangent, bitangent=hit.bitangent, uv=hit.uv,
            inside=hit.inside, bsdf_id=hit.bsdf_id, inst_id=hit.inst_id,
            wi_in=wi_in, beta_in=_where3(valid, beta, zeros3), cos_in=cos_in))
        if k == K_LIGHT - 1:
            break

        # extend: sample with the roles of bsdf_sample's wo and wi swapped
        # (reciprocity), then evaluate the transport in light-flow order
        seed, xi_b = rng.random_floats(seed, bsdfs.N_SAMPLE_DRAWS)
        wi_ps, pdf_ps, _, v_ps = _bsdf_sample(scene, hit, -wi_in, xi_b)
        dir_next = -wi_ps
        _, f_t, v_t = _bsdf_eval(scene, hit, wi_in, dir_next)
        valid = valid & v_ps & v_t
        cos_out = torch.clamp(torch.abs(dot(dir_next, hit.normal)), min=1e-6)
        beta = beta * f_t * (
            cos_out / (cos_in * torch.clamp(pdf_ps, min=1e-12)))[..., None]
        beta = _where3(valid, beta, zeros3)
        prev_pos, prev_dir, prev_valid = hit.position, dir_next, valid
    return vertices, seed


def _connectible(scene: SceneData, bsdf_id, uv):
    return bsdfs.is_connectible(scene.bsdf, _stex(scene), bsdf_id, uv)


def _connect(scene: SceneData, hit, wo, alive, vert: LightVertex,
             xi_shadow=None):
    """One camera-vertex <-> light-vertex connection (bdpt.py:208-271):
    visibility, the BSDF at both ends, the area-measure conversion.  The
    visibility segment runs camera vertex -> light vertex with the alpha
    walk.  Returns (L [N, 3] weighted against the camera's BSDF
    continuation, pdf_direct [N], ok [N])."""
    d_vec = hit.position - vert.position
    dist = sqrt(torch.clamp(dot(d_vec, d_vec), min=1e-20))
    dir_lc = d_vec / dist[..., None]  # light vertex -> camera vertex

    cos_prime = torch.abs(dot(dir_lc, vert.normal))
    geo_ok = vert.valid & alive & (cos_prime >= EPSILON_FLOAT)
    occluded = shadow_occluded(scene, hit.position, -dir_lc, geo_ok, dist,
                               xi_shadow)
    ok = geo_ok & ~occluded

    # the light side: light came in along wi_in and leaves toward the
    # camera vertex (f includes cos_in, which the G algebra divides out)
    _, f_v, v_v = _bsdf_eval(scene, vert, vert.wi_in, dir_lc)
    pdf_c, f_c, v_c = _bsdf_eval(scene, hit, dir_lc, wo)
    ok = (ok & v_c & v_v & _connectible(scene, vert.bsdf_id, vert.uv)
          & _connectible(scene, hit.bsdf_id, hit.uv))

    # beta_in (f_v / cos_in) G (f_c / cos_x), G = cos_prime cos_x / d^2
    contrib = (vert.beta_in * f_v * f_c
               * (cos_prime / (vert.cos_in * dist * dist))[..., None])

    # MIS against the camera's BSDF continuation with the instance-area
    # density of shade's w_cont, so that the pair sums to 1
    area_pdf_l = take_rows(scene.map_inst_area_pdf,
                           torch.clamp(vert.inst_id, min=0))
    pdf_direct = area_pdf_l * dist * dist / torch.clamp(cos_prime, min=1e-12)
    L = mis_weight(pdf_direct, pdf_c)[..., None] * contrib
    return _where3(ok, L, torch.zeros_like(L)), pdf_direct, ok


def shade(scene: SceneData, integ, o, d, seed, differentiable: bool = False):
    """One BDPT sample of a ray batch, the chunked engine's body
    (mcpt_tpu/integrators/bdpt.py:274-419): the path integrator's primary
    terms, then min(depth_max, 8) - 1 bounces of RR, NEE, the light-subpath
    connections and the continuation.  `differentiable` changes nothing,
    as in the reference: the loop's trip count is fixed either way.
    Returns (L [N, 3], seed)."""
    del differentiable
    n = o.shape[0]
    hit = interpolate_hit(scene, scene_closest(scene, o, d), o, d)
    hit, seed = apply_opacity(scene, hit, seed)
    L, ends = _chunked_primary(scene, integ, hit, d,
                               torch.ones_like(hit.valid))
    alive = hit.valid & ~ends
    if _no_lights(scene) or integ.depth_max <= 1:
        return L, seed

    light_path, seed = _light_subpath(scene, integ, seed, n)

    n_nee = nee_draw_count(scene)
    beta = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    pdf_mis = torch.full((n,), 1e12, dtype=torch.float32, device=o.device)
    no = torch.zeros_like(alive)
    wo = -d
    for dep in range(1, min(integ.depth_max, DEPTH_CAP)):
        seed, alive, beta = _roulette(integ, seed, torch.tensor(dep), alive,
                                      beta)
        # NEE: the one-light-vertex strategies
        seed, xi_nee = rng.random_floats(seed, n_nee)
        L = L + beta * _direct_lighting(scene, hit, wo, alive, xi_nee, beta)

        # the light-subpath connections, power-heuristic combined across
        # the K strategies (bdpt.cpp:240-245)
        conn_L, pdf_sq = [], []
        for vert in light_path:
            xi_sh = None
            if scene.has_opacity:
                seed, xi_sh = rng.random_floats(seed, SHADOW_ALPHA_K)
            Lc, pdfc, okc = _connect(scene, hit, wo, alive, vert, xi_sh)
            conn_L.append(Lc)
            p = torch.where(okc, pdfc, torch.zeros_like(pdfc))
            pdf_sq.append(p * p)
        denom = torch.clamp(sum(pdf_sq), min=1e-20)
        for Lc, p2 in zip(conn_L, pdf_sq):
            L = L + beta * (p2 / denom)[..., None] * Lc

        # the continuation
        seed, xi_b = rng.random_floats(seed, bsdfs.N_SAMPLE_DRAWS)
        wi, pdf_b, f, valid_b = _bsdf_sample(scene, hit, wo, xi_b)
        beta_new = beta * f / torch.clamp(pdf_b, min=1e-12)[..., None]
        alive = alive & valid_b & (beta_new.amax(dim=-1) >= EPSILON)
        beta = _where3(alive, beta_new, beta)
        pdf_mis = torch.where(hit.bsdf_id < 0, pdf_mis, pdf_b)

        d2 = -wi
        ghit2 = scene_closest(scene, hit.position, d2, t_max=torch.where(
            alive, torch.full_like(pdf_b, MAX_FLOAT), torch.zeros_like(pdf_b)))
        hit2 = interpolate_hit(scene, ghit2, hit.position, d2)
        hit2, seed = apply_opacity(scene, hit2, seed)
        L = _escape(scene, L, d2, beta, pdf_mis, alive, hit2, no)
        alive = alive & hit2.valid
        L_add, ends = _emitter_hit(scene, integ, hit2, d2, beta, pdf_mis,
                                   alive, no)
        L = L + L_add
        alive = alive & ~ends

        # down-weight the continuation against the connections that build
        # the same edge, where both ends are connectible (bdpt.cpp:269-283)
        t_safe = torch.where(hit2.valid, torch.clamp(hit2.t, max=1e8),
                             torch.ones_like(hit2.t))
        cos_cont = torch.clamp(torch.abs(dot(wi, hit2.normal)), min=1e-4)
        pdf_direct_cont = take_rows(
            scene.map_inst_area_pdf, torch.clamp(hit2.inst_id, min=0)) * (
                t_safe * t_safe) / cos_cont
        both = (_connectible(scene, hit.bsdf_id, hit.uv)
                & _connectible(scene, hit2.bsdf_id, hit2.uv))
        w_cont = torch.where(both, mis_weight(pdf_b, pdf_direct_cont),
                             torch.ones_like(pdf_b))
        beta = _where3(alive, beta * w_cont[..., None], beta)
        wo = wi
        hit = hit2
    return L, seed
