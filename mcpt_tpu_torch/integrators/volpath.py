"""Wavefront volumetric path integrator (counterpart of
mcpt_tpu/integrators/volpath.py; csrt src/renderer/integrators/volpath.cpp).

The path integrator's skeleton with a medium interleave: after every
traced segment the active medium (the destination hit's interior or
exterior medium, by side, volpath.cpp:44-62,162-183) samples a free-flight
distance; lanes whose flight ends early become medium vertices, which
scatter by the phase function instead of a BSDF and carry no shading
frame.  A per-lane `scattering` flag picks between the two vertex kinds;
NEE from either kind multiplies the transmittance along the shadow ray
(volpath.cpp:247-485).  Shadow rays cross null-boundary shells: the
any-hit traversal skips non-opaque rows.

Two engines, as in the reference: `shade_regen` (the regen wavefront,
Renderer's default) and `shade` (one camera sample a call, the chunked
engine).  They differ where the reference's do (R4): `shade` adds the
escape radiance of a camera ray before its free flight, so a camera
inside a medium whose primary segment scatters and then escapes counts
the escape twice; `shade_regen` does not.

The reference's deviation from csrt holds: a lane whose free-flight
transmittance underflows in every channel is killed (csrt shades it
unattenuated, volpath.cpp:117-137).
"""

from __future__ import annotations

import torch

from mcpt_tpu_torch.integrators.path import (
    SHADOW_ALPHA_K,
    _bsdf_eval,
    _bsdf_sample,
    _camera_samples,
    _chunked_primary,
    _emitter_hit,
    _escape,
    _fold,
    _nee_query_count,
    _no_lights,
    _Regen,
    _roulette,
    _sample_area_light,
    _where3,
    apply_opacity,
    interpolate_hit,
    nee_draw_count,
    nee_rr_tau,
    shadow_occluded,
)
from mcpt_tpu_torch.models import bsdf as bsdfs
from mcpt_tpu_torch.models import emitter as emitters
from mcpt_tpu_torch.models import medium as media
from mcpt_tpu_torch.ops import rng
from mcpt_tpu_torch.ops.math import (
    EPSILON,
    EPSILON_FLOAT,
    MAX_FLOAT,
    dot,
    mis_weight,
    sqrt,
    take_rows,
)
from mcpt_tpu_torch.ops.scene_intersect import scene_closest
from mcpt_tpu_torch.scene.compile import SceneData
from mcpt_tpu_torch.scene.ir import EmitterType


def segment_medium(scene: SceneData, hit, dir_along):
    """The medium on the `dir_along` side of the hit (volpath.cpp:44-46):
    inside = dot(dir, n) > 0 ? hit.inside : !hit.inside; -1 on misses."""
    inside = torch.where(dot(dir_along, hit.normal) > 0.0, hit.inside,
                         ~hit.inside)
    inst = torch.clamp(hit.inst_id, min=0)
    mid = torch.where(inside, take_rows(scene.map_inst_medium_int, inst),
                      take_rows(scene.map_inst_medium_ext, inst))
    return torch.where(hit.valid, mid, torch.full_like(mid, -1))


def _eval_vertex(scene, hit, scattering, cur_mid, wi, wo):
    """f and pdf of `wi` over a wavefront of surface and medium vertices:
    the BSDF on surface lanes, the phase function on medium lanes."""
    pdf_b, f_b, v_b = _bsdf_eval(scene, hit, wi, wo)
    pdf_p, f_p, v_p = media.eval_phase(scene.media, cur_mid, wi, wo)
    return (torch.where(scattering, pdf_p, pdf_b), _where3(scattering, f_p, f_b),
            torch.where(scattering, v_p, v_b))


def _direct_lighting_vol(scene, hit, pos_m, scattering, cur_mid, wo, alive,
                         xi):
    """NEE over every emitter, each shadow ray weighted by its medium's
    transmittance (EvaluateDirectLightVolPath, volpath.cpp:247-485).
    Shadow rays start at the medium vertex or the surface and cross the
    lane's own medium (medium lanes) or the surface's wo-side one
    (volpath.cpp:253-257).  No shadow-ray RR, but the draw layout is
    path's: the alpha walk's draws sit before the RR coins."""
    origin = _where3(scattering, pos_m, hit.position)
    mid = torch.where(scattering, cur_mid, segment_medium(scene, hit, wo))
    q_n = _nee_query_count(scene)
    s_base = (nee_draw_count(scene) - (q_n if nee_rr_tau() > 0.0 else 0)
              - (SHADOW_ALPHA_K * q_n if scene.has_opacity else 0))

    def cos_ok(wi):
        # surfaces take light from above their shading plane; medium
        # vertices from any direction
        return scattering | (dot(-wi, hit.normal) >= EPSILON_FLOAT)

    def query(j, wi, dist, geo_ok, rad, pdf_light=None):
        """One shadow query's contribution; a delta light has no pdf."""
        xi_shadow = (xi[s_base + j * SHADOW_ALPHA_K:
                        s_base + (j + 1) * SHADOW_ALPHA_K]
                     if scene.has_opacity else None)
        occluded = shadow_occluded(scene, origin, -wi, geo_ok, dist, xi_shadow)
        w_med, ok_med = media.eval_transmittance(scene.media, mid, dist)
        pdf_eval, f, f_valid = _eval_vertex(scene, hit, scattering, cur_mid,
                                            wi, wo)
        if pdf_light is None:
            contrib = rad * w_med * f
        else:
            w_mis = mis_weight(pdf_light, pdf_eval)
            contrib = (w_mis[..., None] * rad * w_med * f
                       / torch.clamp(pdf_light, min=1e-12)[..., None])
        ok = geo_ok & ~occluded & ok_med & f_valid
        return _where3(ok, contrib, torch.zeros_like(contrib))

    L = torch.zeros_like(wo)
    j, cursor = 0, 0
    if scene.n_emissive:
        pos_l, n_l, radiance, pdf_area = _sample_area_light(
            scene, xi[0], xi[1], xi[2])
        cursor = 3
        d_vec = origin - pos_l
        dist = sqrt(torch.clamp(dot(d_vec, d_vec), min=1e-20))
        wi = d_vec / dist[..., None]
        cos_prime = dot(wi, n_l)
        geo_ok = (cos_prime >= EPSILON_FLOAT) & cos_ok(wi) & alive
        pdf_direct = pdf_area * (dist * dist) / torch.clamp(cos_prime,
                                                            min=1e-12)
        L = L + query(j, wi, dist, geo_ok, radiance, pdf_direct)
        j += 1

    for row, etype in scene.emitter_rows:
        xi0, xi1 = xi[cursor], xi[cursor + 1]
        cursor += 2
        if etype == EmitterType.POINT:
            wi, dist, rad, valid = emitters.sample_point(
                scene.emitters, row, origin)
        elif etype == EmitterType.SPOT:
            wi, dist, rad, valid = emitters.sample_spot(
                scene.emitters, scene.tex, row, origin)
        elif etype == EmitterType.DIRECTIONAL:
            wi, dist, rad, valid = emitters.sample_directional(
                scene.emitters, row, origin)
        else:  # SUN
            wi, dist, rad, valid = emitters.sample_sun(
                scene.emitters, row, origin, xi0, xi1)
        L = L + query(j, wi, dist, valid & alive & cos_ok(wi), rad)
        j += 1

    if scene.env_kind != "none":
        if scene.env_kind == "envmap":
            wi, dist, rad, pdf, valid = emitters.sample_envmap(
                scene.env, scene.tex, origin,
                xi[cursor], xi[cursor + 1], xi[cursor + 2])
        else:  # constant
            wi, dist, rad, pdf, valid = emitters.sample_constant(
                scene.emitters, scene.env_row, origin,
                xi[cursor], xi[cursor + 1])
        L = L + query(j, wi, dist, valid & alive & cos_ok(wi), rad, pdf)
    return L


def _scatter(scene, hit, pos_m, scattering, cur_mid, wo, seed, alive, beta,
             pdf_mis):
    """The continuation: a BSDF sample at surface vertices, a phase sample
    at medium vertices, the latter from the first N_PHASE_DRAWS of the
    same N_SAMPLE_DRAWS uniforms (volpath.py:604-606).  Returns (seed,
    alive, beta, pdf_mis, wi, o, d)."""
    seed, xi_b = rng.random_floats(seed, bsdfs.N_SAMPLE_DRAWS)
    wi_s, pdf_s, f_s, v_s = _bsdf_sample(scene, hit, wo, xi_b)
    wi_p, pdf_p, f_p, v_p = media.sample_phase(scene.media, cur_mid, wo,
                                               xi_b[0], xi_b[1], xi_b[2])
    wi = _where3(scattering, wi_p, wi_s)
    pdf_b = torch.where(scattering, pdf_p, pdf_s)
    f = _where3(scattering, f_p, f_s)
    valid_b = torch.where(scattering, v_p, v_s)

    beta_new = beta * f / torch.clamp(pdf_b, min=1e-12)[..., None]
    alive = alive & valid_b & (beta_new.amax(dim=-1) >= EPSILON)
    beta = _where3(alive, beta_new, beta)
    # null boundaries are delta pass-throughs: the last real pdf carries
    null_vertex = ~scattering & (hit.bsdf_id < 0)
    pdf_mis = torch.where(null_vertex, pdf_mis, pdf_b)
    o = _where3(scattering, pos_m, hit.position)
    return seed, alive, beta, pdf_mis, wi, o, -wi


def _flight(scene, seed, hit, o, d, scattering, cur_mid, alive, beta):
    """Free flight along the segment o -> hit (volpath.cpp:44-62,117-183):
    a surface vertex's segment crosses the destination's by-side medium,
    a medium vertex's stays in its own.  Returns (seed, scattered, pos_m,
    cur_mid, alive, beta)."""
    seed, xi_m = rng.random_floats(seed, media.N_FLIGHT_DRAWS)
    mid_seg = torch.where(scattering, cur_mid, segment_medium(scene, hit, -d))
    t_seg = torch.where(hit.valid, hit.t, torch.full_like(hit.t, MAX_FLOAT))
    scattered, t, w_med, ok_m = media.sample_flight(
        scene.media, mid_seg, t_seg, xi_m[0], xi_m[1])
    beta = _where3(alive, beta * w_med, beta)
    pos_m = o + torch.clamp(t, max=1e8)[..., None] * d
    cur_mid = torch.where(scattered, mid_seg, cur_mid)
    return seed, scattered, pos_m, cur_mid, alive & ok_m, beta


def shade(scene: SceneData, integ, o, d, seed, differentiable: bool = False):
    """One sample of a ray batch through media, the chunked engine's body
    (mcpt_tpu/integrators/volpath.py:221-409).  Returns (L [N, 3], seed).

    differentiable=True runs exactly depth_max - 1 bounces, as the
    reference's lax.scan does, where the default stops once no lane is
    alive; nothing else changes (the reference's volpath reads the
    envmap's texel table either way).  A scatter point's position then
    carries sigma_t's gradient into the next hit (K1's backward)."""
    n = o.shape[0]
    hit = interpolate_hit(scene, scene_closest(scene, o, d), o, d)
    hit, seed = apply_opacity(scene, hit, seed)
    no = torch.zeros(n, dtype=torch.bool, device=o.device)

    # the primary free flight (volpath.cpp:44-62); the escape radiance is
    # added before it (R4)
    wo = -d
    seed, scattering, pos_m, cur_mid, alive, beta = _flight(
        scene, seed, hit, o, d, no, torch.full_like(hit.bsdf_id, -1), ~no,
        torch.ones((n, 3), dtype=torch.float32, device=o.device))
    L, ends = _chunked_primary(scene, integ, hit, d, ~scattering)
    alive = (hit.valid | scattering) & ~ends & alive
    if _no_lights(scene) or integ.depth_max <= 1:
        return L, seed

    n_nee = nee_draw_count(scene)
    pdf_mis = torch.full((n,), 1e12, dtype=torch.float32, device=o.device)
    dep = 1
    while dep < integ.depth_max and (differentiable or bool(alive.any())):
        seed, alive, beta = _roulette(integ, seed, torch.tensor(dep), alive,
                                      beta)
        seed, xi_nee = rng.random_floats(seed, n_nee)
        L = L + beta * _direct_lighting_vol(scene, hit, pos_m, scattering,
                                            cur_mid, wo, alive, xi_nee)
        seed, alive, beta, pdf_mis, wi, o2, d2 = _scatter(
            scene, hit, pos_m, scattering, cur_mid, wo, seed, alive, beta,
            pdf_mis)

        ghit = scene_closest(
            scene, o2, d2,
            t_max=torch.where(alive, torch.full_like(pdf_mis, MAX_FLOAT),
                              torch.zeros_like(pdf_mis)))
        hit = interpolate_hit(scene, ghit, o2, d2)
        hit, seed = apply_opacity(scene, hit, seed)
        seed, scattering, pos_m, cur_mid, alive, beta = _flight(
            scene, seed, hit, o2, d2, scattering, cur_mid, alive, beta)

        # escape with MIS (volpath.cpp:189-203), then the emitter hit
        # (volpath.cpp:205-238); medium vertices go on
        L = _escape(scene, L, d2, beta, pdf_mis, alive & ~scattering, hit, no)
        alive = alive & (scattering | hit.valid)
        L_add, ends = _emitter_hit(scene, integ, hit, d2, beta, pdf_mis,
                                   alive & ~scattering, no)
        L = L + L_add
        alive = alive & (scattering | ~ends)
        wo = wi
        dep += 1
    return L, seed


def shade_regen(scene: SceneData, integ, camera, pixel_idx, spp: int,
                frame_base=0, spp_total: int | None = None, sample_offset=0):
    """Fused spp x depth volumetric wavefront with ray regeneration
    (mcpt_tpu/integrators/volpath.py:411-626), path.shade_regen's
    scheduling: each iteration refills dead lanes with their next camera
    sample, traces, samples the free flight through the segment's
    medium, then shades the surface or the medium vertex.  The draws a
    vertex consumes: apply_opacity's, N_FLIGHT_DRAWS, the RR coin,
    nee_draw_count, N_SAMPLE_DRAWS.  Returns (film [N, 3] = mean over
    spp, final seed)."""
    reg = _Regen(pixel_idx, (int(frame_base) + int(sample_offset)) & 0xFFFFFFFF,
                 spp, spp if spp_total is None else spp_total, sample_offset)
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    n_nee = nee_draw_count(scene)
    depth_cut = (1 if (_no_lights(scene) or integ.depth_max <= 1)
                 else integ.depth_max)

    f32 = dict(dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((n, 3), **f32)
    work_k = torch.zeros(n, dtype=torch.int32, device=dev)
    L = zeros3.clone()
    L_samp = zeros3.clone()
    beta = torch.ones((n, 3), **f32)
    o = zeros3.clone()
    d = zeros3.clone()
    d[:, 2] = 1.0
    pdf_mis = torch.full((n,), 1e12, **f32)
    seed = rng.pixel_seed(pixel_idx, reg.base)
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    vert = torch.zeros(n, dtype=torch.int32, device=dev)
    scattering = torch.zeros(n, dtype=torch.bool, device=dev)
    cur_mid = torch.full((n,), -1, dtype=torch.int32, device=dev)

    while bool((alive | (work_k < spp)).any()):
        # --- regenerate: dead lanes with samples left start the next one
        fresh = ~alive & (work_k < spp)
        L = _fold(integ, L, L_samp, fresh)
        L_samp = _where3(fresh, zeros3, L_samp)
        o_new, d_new, seed_new = _camera_samples(camera, reg, fresh, work_k)
        o = _where3(fresh, o_new, o)
        d = _where3(fresh, d_new, d)
        seed = torch.where(fresh, seed_new, seed)
        beta = _where3(fresh, torch.ones_like(beta), beta)
        pdf_mis = torch.where(fresh, torch.full_like(pdf_mis, 1e12), pdf_mis)
        vert = torch.where(fresh, torch.zeros_like(vert), vert)
        scattering = scattering & ~fresh
        cur_mid = torch.where(fresh, torch.full_like(cur_mid, -1), cur_mid)
        alive = alive | fresh
        work_k = work_k + fresh.to(torch.int32)

        # --- trace, then the free flight along the segment
        ghit = scene_closest(
            scene, o, d,
            t_max=torch.where(alive, torch.full_like(pdf_mis, MAX_FLOAT),
                              torch.zeros_like(pdf_mis)),
            sort_bias=(~fresh).int(),
        )
        hit = interpolate_hit(scene, ghit, o, d)
        hit, seed = apply_opacity(scene, hit, seed)
        vert = vert + 1
        primary = vert == 1
        seed, scattering, pos_m, cur_mid, alive, beta = _flight(
            scene, seed, hit, o, d, scattering, cur_mid, alive, beta)

        # --- escape (camera segments also see the sun) and emitter hits,
        # at surface vertices only
        L_samp = _escape(scene, L_samp, d, beta, pdf_mis, alive & ~scattering,
                         hit, primary)
        alive = alive & (scattering | hit.valid)
        L_add, ends = _emitter_hit(scene, integ, hit, d, beta, pdf_mis,
                                   alive & ~scattering, primary)
        L_samp = L_samp + L_add
        alive = alive & (scattering | ~ends) & (vert < depth_cut)
        seed, alive, beta = _roulette(integ, seed, vert, alive, beta)

        # --- NEE at the surface or medium vertex, then the continuation
        seed, xi_nee = rng.random_floats(seed, n_nee)
        L_samp = L_samp + beta * _direct_lighting_vol(
            scene, hit, pos_m, scattering, cur_mid, -d, alive, xi_nee)
        seed, alive, beta, pdf_mis, _, o, d = _scatter(
            scene, hit, pos_m, scattering, cur_mid, -d, seed, alive, beta,
            pdf_mis)

    L = _fold(integ, L, L_samp, torch.ones_like(alive))
    return L / spp, seed
