"""Wavefront path integrator with NEE + MIS + RR, regeneration engine
(counterpart of mcpt_tpu/integrators/path.py; csrt
src/renderer/integrators/path.cpp).

Every lane owns all `spp` samples of one pixel: when its path dies it
re-seeds and traces its next camera sample in the same iteration.  Each
iteration mirrors the reference's body — trace, stochastic opacity,
escape into the envmap or constant sky with MIS, emitter hit with MIS,
Russian roulette with immediate compensation, NEE toward every delta
light, one CDF-sampled area light and the escape emitter (shadow-ray RR,
and the stochastic-alpha walk where the scene has opacity maps), BSDF
sampling — and draws the same number of uniforms in every lane, so the
sample streams, and with them the image, match the reference's.

Two bodies, as in the reference: the unbatched one traces the
continuation and then each NEE shadow ray on its own; the batched one
(_shade_regen_batched, for large all-opaque march-routed scenes, the
_use_batched_trace gate) traces the continuation and the previous
vertex's shadow rays in ONE closest-hit call per iteration.  On the card
the unbatched iteration (_regen_step) is captured once as a CUDA graph
and replayed, so that the host issues one launch an iteration instead of
its ~700 small ops (_regen_graphed, where graph_engages).

`shade` is the chunked engine's body: one camera sample of a ray batch
per call, its seed carried from call to call (render/renderer.py::
render_pixels), the same estimator and vertex draws.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.models import bsdf as bsdfs
from mcpt_tpu_torch.models import emitter as emitters
from mcpt_tpu_torch.models import texture as textures
from mcpt_tpu_torch.ops import dense_sweep, march_sweep, packet_sweep, rng
from mcpt_tpu_torch.ops.math import (
    EPSILON,
    EPSILON_DISTANCE,
    EPSILON_FLOAT,
    INV_FOUR_PI,
    MAX_FLOAT,
    cross,
    dot,
    mis_weight,
    normalize,
    sqrt,
    take_rows,
)
from mcpt_tpu_torch.ops.quadric import quadric_attrs, sample_quadric_row
from mcpt_tpu_torch.ops.scene_intersect import scene_any, scene_closest
from mcpt_tpu_torch.ops.traversal import (DENSE_MAX_PRIMS, resolved_strategy,
                                          route)
from mcpt_tpu_torch.ops.warps import sample_triangle_uniform, searchsorted_cdf
from mcpt_tpu_torch.render.camera import generate_rays
from mcpt_tpu_torch.scene.compile import SceneData
from mcpt_tpu_torch.scene.ir import EmitterType

#: masked or null crossings one shadow ray resolves (path.py:236); past
#: them it passes unoccluded, the reference's bounded-depth deviation.
#: Read once, as the reference reads it; tests set the attribute
SHADOW_ALPHA_K = max(1, int(os.environ.get("MCPT_SHADOW_ALPHA_K", "4")))

#: while tracing is on (mcpt_tpu_torch/trace.py): the wavefront loops'
#: bodies run (here and in volpath.py), those of them that ran as a
#: replay of a captured iteration (_regen_graphed), the lanes they
#: carried, and the lanes with work at each loop test
iterations = 0
graph_iterations = 0
lanes = 0
live_lanes = 0


def more_work(mask, site: str, replay: bool = False) -> bool:
    """A wavefront loop's test: whether any lane of `mask` has work left
    (one reduction and one copy to the host).  While tracing, it reads
    the count of those lanes in its place, inside a `sync` span, and
    counts the iteration the test lets run, as a replay where `replay`
    says it runs as one."""
    if not trace.on:
        return bool(mask.any())
    global iterations, graph_iterations, lanes, live_lanes
    with trace.span("sync", site=site):
        live = int(mask.sum())
    live_lanes += live
    if live:
        iterations += 1
        graph_iterations += replay
        lanes += mask.shape[0]
    return live > 0


def nee_rr_tau() -> float:
    """Shadow-ray Russian-roulette threshold (the reference's _nee_rr_tau,
    path.py:286-299): an NEE query whose potential contribution is below
    tau is traced with probability contribution/tau and reweighted.
    MCPT_NEE_RR_TAU overrides the default 0.05; 0 disables it."""
    return float(os.environ.get("MCPT_NEE_RR_TAU", "0.05"))


class HitAttrs(NamedTuple):
    """Interpolated shading attributes (csrt Hit, hit.hpp:9-30)."""

    valid: torch.Tensor      # [N] bool
    t: torch.Tensor          # [N]
    position: torch.Tensor   # [N, 3]
    normal: torch.Tensor     # [N, 3] shading normal
    tangent: torch.Tensor    # [N, 3]
    bitangent: torch.Tensor  # [N, 3]
    uv: torch.Tensor         # [N, 2]
    inside: torch.Tensor     # [N] bool
    bsdf_id: torch.Tensor    # [N] int32 (-1 none)
    inst_id: torch.Tensor    # [N] int32


def _where3(m, a, b):
    return torch.where(m[..., None], a, b)


def _stex(scene: SceneData):
    """The texture view of surface shading: the kinds the BSDF tables can
    reach, so that an envmap's or a sun's bitmap does not put the bitmap
    branch into every BSDF parameter read (path.py:68)."""
    return scene.tex._replace(kinds=scene.surface_kinds)


def interpolate_hit(scene: SceneData, ghit, o, d) -> HitAttrs:
    """Barycentric attribute interpolation (csrt triangle.cpp:116-147);
    quadric hits take their exact frames, bump maps perturb the frame,
    and back faces flip it last."""
    g = scene.geom
    p = ghit.prim.long()
    uf = (1.0 - ghit.v - ghit.w)[..., None]
    vf = ghit.v[..., None]
    wf = ghit.w[..., None]

    def lerp3(a0, a1, a2):
        return uf * a0[p] + vf * a1[p] + wf * a2[p]

    normal = normalize(lerp3(g.n0, g.n1, g.n2))
    tangent = normalize(lerp3(g.tg0, g.tg1, g.tg2))
    bitangent = normalize(lerp3(g.bt0, g.bt1, g.bt2))
    uv = lerp3(g.uv0, g.uv1, g.uv2)
    inst = g.inst_id[p]
    # missed lanes (t = MAX_FLOAT) keep a finite position
    position = o + torch.clamp(ghit.t, max=1e8)[..., None] * d

    # quadric lanes: the exact frame and uv (csrt sphere.cpp:47-85,
    # disk.cpp, cylinder.cpp)
    if scene.quad_kinds:
        qn, qt, qb, quv, qinst = quadric_attrs(
            scene.quad, scene.quad_kinds, ghit.quad, position)
        is_q = ghit.quad >= 0
        normal = _where3(is_q, qn, normal)
        tangent = _where3(is_q, qt, tangent)
        bitangent = _where3(is_q, qb, bitangent)
        uv = _where3(is_q, quv, uv)
        inst = torch.where(is_q, qinst, inst)
    bsdf_id = take_rows(scene.map_inst_bsdf, torch.clamp(inst, min=0))

    # bump maps perturb the frame before the inside flip (csrt
    # triangle.cpp:129-134, bsdf.cpp:238-253)
    if scene.has_bump:
        bump_tid = take_rows(scene.bsdf.bump_tid, torch.clamp(bsdf_id, min=0))
        has_bump = (bump_tid >= 0) & (bsdf_id >= 0)
        grad = textures.eval_gradient(
            bsdfs._ktex(scene.tex, scene.bsdf, "bump"),
            torch.clamp(bump_tid, min=0), uv)
        n_b = normalize(-grad[..., 0:1] * tangent - grad[..., 1:2] * bitangent
                        + normal)
        b_b = normalize(cross(n_b, tangent))
        t_b = normalize(cross(b_b, n_b))
        normal = _where3(has_bump, n_b, normal)
        bitangent = _where3(has_bump, b_b, bitangent)
        tangent = _where3(has_bump, t_b, tangent)

    # back-face hits flip the stored normal/bitangent (triangle.cpp:136-141)
    normal = _where3(ghit.inside, -normal, normal)
    bitangent = _where3(ghit.inside, -bitangent, bitangent)
    return HitAttrs(
        valid=ghit.valid,
        t=ghit.t,
        position=position,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        uv=uv,
        inside=ghit.inside,
        bsdf_id=torch.where(ghit.valid, bsdf_id, torch.full_like(bsdf_id, -1)),
        inst_id=inst,
    )


def apply_opacity(scene: SceneData, hit: HitAttrs, seed):
    """Stochastic alpha (path.py:156): a hit on an opacity-masked surface
    becomes a null pass-through vertex with probability 1 - alpha (csrt
    tests IsTransparent in traversal, triangle.cpp:117, bsdf.cpp:272-276;
    the wavefront tests it at the shading vertex).  One uniform draw, in
    scenes with opacity maps only."""
    if not scene.has_opacity:
        return hit, seed
    seed, u = rng.random_float(seed)
    tid = take_rows(scene.bsdf.opacity_tid, torch.clamp(hit.bsdf_id, min=0))
    has = (tid >= 0) & (hit.bsdf_id >= 0) & hit.valid
    alpha = textures.eval_opacity(
        bsdfs._ktex(scene.tex, scene.bsdf, "opacity"),
        torch.clamp(tid, min=0), hit.uv)
    transparent = has & (u >= alpha)
    return hit._replace(bsdf_id=torch.where(
        transparent, torch.full_like(hit.bsdf_id, -1), hit.bsdf_id)), seed


def _sample_area_light(scene: SceneData, xi_sel, xi_a, xi_b):
    """Pick an emissive cell from the global CDF and a point on it (csrt
    path.cpp:186-196 + blas.cpp:79-98): a triangle's, or an emissive
    quadric's uniform surface sample where the cell is a quadric's."""
    em = scene.em
    cell = searchsorted_cdf(em.cdf, xi_sel)
    w, u, v = sample_triangle_uniform(xi_a, xi_b)
    uf, vf, wf = u[..., None], v[..., None], w[..., None]
    pos = em.p0[cell] + uf * em.e1[cell] + vf * em.e2[cell]
    nrm = normalize(wf * em.n0[cell] + uf * em.n1[cell] + vf * em.n2[cell])
    uv = wf * em.uv0[cell] + uf * em.uv1[cell] + vf * em.uv2[cell]
    radiance_tid = scene.bsdf.radiance_tid[em.bsdf_id.long()][cell]
    for cell_idx, quad_row, kind in scene.em_quad_cells:
        qpos, qnrm, quv = sample_quadric_row(scene.quad, quad_row, kind,
                                             xi_a, xi_b)
        m = cell == cell_idx
        pos = _where3(m, qpos, pos)
        nrm = _where3(m, qnrm, nrm)
        uv = _where3(m, quv, uv)
    radiance = textures.eval_color(
        bsdfs._ktex(scene.tex, scene.bsdf, "radiance"),
        torch.clamp(radiance_tid, min=0), uv)
    return pos, nrm, radiance, em.pdf_area[cell]


def _bsdf_eval(scene, hit, wi, wo):
    return bsdfs.bsdf_evaluate(
        scene.bsdf, _stex(scene), scene.present_types, hit.bsdf_id, wi, wo,
        hit.normal, hit.tangent, hit.bitangent, hit.inside, hit.uv,
        kc=(scene.brdf_avg, scene.albedo_avg),
    )


def _bsdf_sample(scene, hit, wo, xi):
    return bsdfs.bsdf_sample(
        scene.bsdf, _stex(scene), scene.present_types, hit.bsdf_id, wo,
        hit.normal, hit.tangent, hit.bitangent, hit.inside, hit.uv, xi,
        kc=(scene.brdf_avg, scene.albedo_avg),
    )


def _nee_query_count(scene: SceneData) -> int:
    """Shadow queries one _direct_lighting call makes (path.py:278-283):
    the area lights' one, one a delta light, the escape emitter's one."""
    q = (1 if scene.n_emissive else 0) + len(scene.emitter_rows)
    return q + (scene.env_kind != "none")


def nee_draw_count(scene: SceneData) -> int:
    """Uniform draws one _direct_lighting call consumes (path.py:302-318),
    so that the RNG streams stay aligned: three for the area light, two a
    delta light, three for an envmap (row, column, alias coin) or two for
    a constant sky; then SHADOW_ALPHA_K a query for the alpha walk where
    the scene has opacity maps, and one RR coin a query where shadow-ray
    RR is on (tau > 0).  At least one."""
    q_n = _nee_query_count(scene)
    k = 3 if scene.n_emissive else 0
    k += 2 * len(scene.emitter_rows)
    k += {"envmap": 3, "constant": 2}.get(scene.env_kind, 0)
    if scene.has_opacity:
        k += SHADOW_ALPHA_K * q_n
    if nee_rr_tau() > 0.0:
        k += q_n
    return max(k, 1)


def _nee_rr(pend, live, xi, tau, beta=None):
    """Shadow-ray RR on one query's pending contribution (path.py:321).

    The decision sees the full pending radiance (beta * pend, or pend
    where beta is already folded in); survivors below tau are reweighted
    by tau / m, so E[pend'] = pend.

    Deviation from the reference (ROADMAP R1): the weight tau / m and the
    decision are detached from autograd.  The reference lets both into
    the gradient, which biases it and gives NaN for a conductor's
    edge tint; detached, E[d pend'] = d pend.  Forward values are the
    reference's."""
    m = (pend if beta is None else pend * beta).amax(dim=-1).detach()
    p = torch.clamp(m / tau, 0.0, 1.0)
    fire = m < tau
    keep = ~fire | (xi < p)
    scale = torch.where(fire, tau / torch.clamp(m, min=1e-20),
                        torch.ones_like(m))
    pend = _where3(fire & keep, pend * scale[..., None], pend)
    return pend, live & keep


def _use_origin_chunk(scene: SceneData) -> bool:
    """Whether continuation and shadow rays carry origin-chunk coherence
    keys (path.py:241-260): MCPT_COH=1, off by default, on scenes past
    DENSE_MAX_PRIMS.  The keys reach the march route's ray order only:
    they change no hit, only which rays share a block."""
    return (os.environ.get("MCPT_COH", "0") == "1"
            and scene.geom.p0.shape[0] > DENSE_MAX_PRIMS)


def _origin_chunk(scene: SceneData, shit):
    """SAH chunk id of the hit prim, -1 on a miss or a quadric hit
    (path.py:263-276): the coherence key of the rays that start at this
    hit point, continuation and shadow segments alike."""
    coh = take_rows(scene.geom.march_chunk_of_prim, shit.prim.long())
    ok = shit.valid
    if scene.quad_kinds:
        ok = ok & (shit.quad < 0)
    return torch.where(ok, coh, torch.full_like(coh, -1))


def shadow_occluded(scene: SceneData, o, d, geo_ok, dist, xi=None,
                    coherence=None):
    """Occlusion of the segment o -> o + dist*d (path.py:343-419).

    Without opacity maps: the plain any-hit.  With them, the segment's
    successive closest hits, up to SHADOW_ALPHA_K of them: an opaque hit
    occludes, a null-boundary hit passes, a masked triangle occludes with
    probability alpha (the draw convention of apply_opacity; quadrics
    have no alpha); crossings past SHADOW_ALPHA_K pass.  xi:
    [SHADOW_ALPHA_K, N] uniforms, read only with opacity maps.
    `coherence`: the origins' chunk ids (MCPT_COH), or None."""
    t_hi = torch.where(geo_ok, dist - EPSILON_DISTANCE, torch.zeros_like(dist))
    if not scene.has_opacity:
        return scene_any(scene, o, d, t_min=EPSILON_DISTANCE, t_max=t_hi,
                         coherence=coherence)

    g = scene.geom
    occ = torch.zeros_like(geo_ok)
    active = geo_ok
    t_lo = torch.full_like(dist, EPSILON_DISTANCE)
    opacity_tex = bsdfs._ktex(scene.tex, scene.bsdf, "opacity")
    for k in range(SHADOW_ALPHA_K):
        h = scene_closest(scene, o, d, t_min=t_lo,
                          t_max=torch.where(active, t_hi,
                                            torch.zeros_like(t_hi)),
                          coherence=coherence)
        valid = h.valid & active
        p = h.prim.long()
        inst = g.inst_id[p]
        is_q = h.quad >= 0
        if scene.quad_kinds:
            qinst = take_rows(scene.quad.inst_id, torch.clamp(h.quad, min=0))
            inst = torch.where(is_q, qinst, inst)
        bsdf_id = take_rows(scene.map_inst_bsdf, torch.clamp(inst, min=0))
        is_null = bsdf_id < 0
        tid = take_rows(scene.bsdf.opacity_tid, torch.clamp(bsdf_id, min=0))
        has_mask = (tid >= 0) & ~is_null & ~is_q
        u_b = (1.0 - h.v - h.w)[..., None]
        uv = (u_b * g.uv0[p] + h.v[..., None] * g.uv1[p]
              + h.w[..., None] * g.uv2[p])
        alpha = textures.eval_opacity(opacity_tex, torch.clamp(tid, min=0), uv)
        blocked = valid & ~is_null & (~has_mask | (xi[k] < alpha))
        occ = occ | blocked
        active = valid & ~blocked  # crossed a null shell or passed a mask
        t_lo = torch.where(active, h.t + EPSILON_DISTANCE, t_lo)
    return occ


def _nee_area_query(scene: SceneData, hit: HitAttrs, wo, alive, xi0, xi1, xi2):
    """Sampled-area-light NEE without the occlusion test: returns
    (wi, dist, geo_ok, contrib-if-unoccluded) (csrt path.cpp:185-236)."""
    pos_l, n_l, radiance, pdf_area = _sample_area_light(scene, xi0, xi1, xi2)
    d_vec = hit.position - pos_l
    dist = sqrt(torch.clamp(dot(d_vec, d_vec), min=1e-20))
    wi = d_vec / dist[..., None]  # light travel direction: light -> surface

    cos_prime = dot(wi, n_l)
    cos_surf = dot(-wi, hit.normal)
    geo_ok = (cos_prime >= EPSILON_FLOAT) & (cos_surf >= EPSILON_FLOAT) & alive

    pdf_eval, f, f_valid = _bsdf_eval(scene, hit, wi, wo)
    pdf_direct = pdf_area * (dist * dist) / torch.clamp(cos_prime, min=1e-12)
    w_mis = mis_weight(pdf_direct, pdf_eval)
    contrib = (
        w_mis[..., None] * radiance * f
        / torch.clamp(pdf_direct, min=1e-12)[..., None]
    )
    return wi, dist, geo_ok, _where3(geo_ok & f_valid, contrib,
                                     torch.zeros_like(contrib))


def _nee_queries(scene: SceneData, hit: HitAttrs, wo, alive, xi,
                 differentiable: bool = False):
    """Every emitter's NEE query without its occlusion test
    (path.py:462-528): a list of (wi, dist, geo_ok, contrib-if-unoccluded)
    in _nee_query_count's order — the area light, the delta lights by
    row, the escape emitter — from the leading sample draws of xi.
    `differentiable` reads the envmap through the texture atlas."""
    queries = []
    cursor = 0
    if scene.n_emissive:
        queries.append(_nee_area_query(scene, hit, wo, alive,
                                       xi[0], xi[1], xi[2]))
        cursor = 3

    for row, etype in scene.emitter_rows:
        xi0, xi1 = xi[cursor], xi[cursor + 1]
        cursor += 2
        if etype == EmitterType.POINT:
            wi, dist, rad, valid = emitters.sample_point(
                scene.emitters, row, hit.position)
        elif etype == EmitterType.SPOT:
            wi, dist, rad, valid = emitters.sample_spot(
                scene.emitters, scene.tex, row, hit.position)
        elif etype == EmitterType.DIRECTIONAL:
            wi, dist, rad, valid = emitters.sample_directional(
                scene.emitters, row, hit.position)
        else:  # SUN
            wi, dist, rad, valid = emitters.sample_sun(
                scene.emitters, row, hit.position, xi0, xi1)
        geo_ok = valid & alive & (dot(-wi, hit.normal) >= EPSILON_FLOAT)
        _, f, f_valid = _bsdf_eval(scene, hit, wi, wo)
        # a delta light: no MIS, no pdf (path.cpp:170-173)
        queries.append((wi, dist, geo_ok, _where3(geo_ok & f_valid, rad * f,
                                                  torch.zeros_like(f))))

    if scene.env_kind != "none":
        if scene.env_kind == "envmap":
            wi, dist, rad, pdf, valid = emitters.sample_envmap(
                scene.env, scene.tex, hit.position,
                xi[cursor], xi[cursor + 1], xi[cursor + 2],
                differentiable=differentiable)
        else:  # constant
            wi, dist, rad, pdf, valid = emitters.sample_constant(
                scene.emitters, scene.env_row, hit.position,
                xi[cursor], xi[cursor + 1])
        geo_ok = valid & alive & (dot(-wi, hit.normal) >= EPSILON_FLOAT)
        pdf_eval, f, f_valid = _bsdf_eval(scene, hit, wi, wo)
        w_mis = mis_weight(pdf, pdf_eval)
        contrib = (w_mis[..., None] * rad * f
                   / torch.clamp(pdf, min=1e-12)[..., None])
        queries.append((wi, dist, geo_ok, _where3(
            geo_ok & f_valid, contrib, torch.zeros_like(contrib))))
    return queries


def _direct_lighting(scene: SceneData, hit: HitAttrs, wo, alive, xi, beta,
                     differentiable: bool = False, coherence=None):
    """NEE over every emitter, each query against its own shadow ray,
    with shadow-ray RR where tau > 0 (csrt EvaluateDirectLightPath,
    path.cpp:138-236).  Shadow segments run surface -> light; occlusion
    of the segment is symmetric.  xi: [nee_draw_count, N] uniforms, laid
    out as the sample draws, then the alpha walk's SHADOW_ALPHA_K a query
    (opacity maps only), then one RR coin a query (tau > 0 only).
    `coherence`: the hit points' chunk ids (MCPT_COH), or None."""
    q_n = _nee_query_count(scene)
    tau = nee_rr_tau()
    rr_base = nee_draw_count(scene) - (q_n if tau > 0.0 else 0)
    s_base = rr_base - (SHADOW_ALPHA_K * q_n if scene.has_opacity else 0)
    L = torch.zeros_like(wo)
    for j, (wi, dist, geo_ok, contrib) in enumerate(
            _nee_queries(scene, hit, wo, alive, xi, differentiable)):
        if tau > 0.0:
            contrib, geo_ok = _nee_rr(contrib, geo_ok, xi[rr_base + j], tau,
                                      beta)
        xi_shadow = (xi[s_base + j * SHADOW_ALPHA_K:
                        s_base + (j + 1) * SHADOW_ALPHA_K]
                     if scene.has_opacity else None)
        occluded = shadow_occluded(scene, hit.position, -wi, geo_ok, dist,
                                   xi_shadow, coherence)
        L = L + _where3(occluded | ~geo_ok, torch.zeros_like(contrib), contrib)
    return L


def _escape_radiance(scene: SceneData, look_dir, differentiable: bool = False):
    """An escaping ray's radiance from the envmap or the constant sky
    (path.py:569-580); `differentiable` reads the envmap through the
    texture atlas."""
    if scene.env_kind == "envmap":
        return emitters.eval_envmap(scene.env, scene.tex, look_dir,
                                    differentiable=differentiable)
    if scene.env_kind == "constant":
        return scene.emitters.radiance[scene.env_row].expand(look_dir.shape)
    return torch.zeros_like(look_dir)


def _escape_pdf(scene: SceneData, look_dir):
    """The NEE pdf of an escaping direction, for MIS (path.py:583-590)."""
    if scene.env_kind == "envmap":
        return emitters.pdf_envmap(scene.env, scene.tex, look_dir)
    return torch.full(look_dir.shape[:-1],
                      INV_FOUR_PI if scene.env_kind == "constant" else 0.0,
                      dtype=look_dir.dtype, device=look_dir.device)


def _chunked_primary(scene, integ, hit, d, through,
                     differentiable: bool = False):
    """The chunked engine's camera-ray terms (path.py:619-643,
    volpath.py:229-268): where the ray missed, the escape radiance (the
    envmap or constant sky, then the sun's bitmap), unweighted; where it
    hit an emitter's front face and `through` holds, the emitter's
    radiance, unless hide_emitters.  Returns (L, ends): ends marks the
    lanes whose path stops on an emitter or a one-sided back face."""
    zeros = torch.zeros_like(d)
    miss = ~hit.valid
    L = zeros
    if scene.env_kind != "none":
        L = L + _where3(miss, _escape_radiance(scene, d, differentiable),
                        zeros)
    if scene.sun_row >= 0:
        L = L + _where3(miss, emitters.eval_sun_escape(
            scene.emitters, scene.tex, scene.sun_row, d), zeros)
    seen = (hit.bsdf_id >= 0) & hit.valid & through
    emitter = bsdfs.is_emitter(scene.bsdf, hit.bsdf_id) & seen
    backface = hit.inside & ~bsdfs.is_twosided(scene.bsdf, hit.bsdf_id) & seen
    if not integ.hide_emitters:
        L = L + _where3(emitter & ~backface, bsdfs.get_radiance(
            scene.bsdf, _stex(scene), hit.bsdf_id, hit.uv), zeros)
    return L, emitter | backface


def _kept(mask, x):
    """x on the lanes of `mask`, 0 elsewhere ([N] or [N, 3]), for the
    inputs of a term that a where() then drops on the other lanes.  A
    dropped lane may hold inf or an extreme value (the last bounce's
    throughput overflowing; a negative sampling pdf on a path that
    ended, whose MIS weight overflows to inf / inf), and the backward
    would multiply its 0 cotangent by it: NaN in the gradient of every
    parameter the term reads.  The same forward on the kept lanes."""
    m = mask if x.dim() == mask.dim() else mask[..., None]
    return torch.where(m, x, torch.zeros_like(x))


def _escape(scene, L_samp, d, beta, pdf_mis, alive, hit, primary,
            differentiable: bool = False):
    """Add escaping rays' radiance to L_samp: the escape emitter's with
    MIS against its NEE pdf (a camera ray's pdf_mis of 1e12 makes the
    weight 1), then the sun bitmap on camera segments
    (path.py:1178-1195)."""
    esc = alive & ~hit.valid
    if scene.env_kind != "none":
        w_esc = mis_weight(_kept(esc, pdf_mis),
                           _kept(esc, _escape_pdf(scene, d)))
        L_samp = L_samp + _where3(
            esc, w_esc[..., None] * _kept(esc, beta)
            * _escape_radiance(scene, d, differentiable),
            torch.zeros_like(beta))
    if scene.sun_row >= 0:
        L_samp = L_samp + _where3(
            esc & primary,
            emitters.eval_sun_escape(scene.emitters, scene.tex, scene.sun_row,
                                     d),
            torch.zeros_like(beta))
    return L_samp


def _use_batched_trace(scene: SceneData) -> bool:
    """Whether shade_regen takes the batched body (path.py:763-801).

    Gated to scenes where "a closest hit exists" equals "the shadow
    segment is occluded" (every prim opaque, no opacity maps), so that the
    continuation and the Q shadow segments share one closest-hit call of
    (1 + Q) * n lanes; scenes of at most DENSE_MAX_PRIMS prims keep the
    dense sweep, whose cost is per lane.  MCPT_BATCH_TRACE=0 opts out and
    =1 opts in past the 2^18-prim cap and the pair route, which the
    default leaves unbatched.  The prim count is the padded one, the
    reference's geom.p0.shape[0]."""
    flag = os.environ.get("MCPT_BATCH_TRACE")
    prims = scene.geom.p0.shape[0]
    if flag is not None:
        if flag != "1":
            return False
    elif prims > (1 << 18) or resolved_strategy(scene.geom) == "pairs":
        return False
    return (scene.all_opaque and not scene.has_opacity
            and prims > DENSE_MAX_PRIMS and _nee_query_count(scene) >= 1)


class _Regen(NamedTuple):
    """A tile-chunk's sample parameters, shared by both bodies."""

    pixel_idx: torch.Tensor
    base: int
    spp: int
    spp_total: int
    sample_offset: int


def _camera_samples(camera, reg: _Regen, fresh, work_k):
    """Camera rays and seeds of each lane's next sample k = work_k:
    jitter u = (sample_offset + k) / spp_total, v = VdC2(base + k + 1),
    seed Tea(pixel, base + k).  Returns (o, d, seed) for every lane;
    callers keep them where `fresh`."""
    k = torch.where(fresh, work_k, torch.zeros_like(work_k))
    u = (float(reg.sample_offset) + k.to(torch.float32)) / reg.spp_total
    v = rng.van_der_corput_base2(reg.base + k.long() + 1)
    o, d = generate_rays(camera, reg.pixel_idx, u, v)
    return o, d, rng.pixel_seed(reg.pixel_idx, reg.base + k.long())


def _emitter_hit(scene, integ, hit, d, beta, pdf_mis, alive, primary):
    """Radiance of an emitter hit with MIS (primary hits: w = 1, no
    cosine cut; hide_emitters honoured), and the lanes whose path ends
    on an emitter or on a one-sided back face.  Returns (L_add, ends)."""
    has_b = hit.bsdf_id >= 0
    emitter = bsdfs.is_emitter(scene.bsdf, hit.bsdf_id) & has_b
    wi_in = -d  # light-travel convention of the emitter formulas
    cos_prime = dot(wi_in, hit.normal)
    pdf_area_hit = take_rows(scene.map_inst_light_pdf,
                             torch.clamp(hit.inst_id, min=0))
    t_safe = torch.where(hit.valid, torch.clamp(hit.t, max=1e8),
                         torch.ones_like(hit.t))
    pdf_direct = pdf_area_hit * (t_safe * t_safe) / torch.clamp(
        cos_prime, min=1e-12)
    rad = bsdfs.get_radiance(scene.bsdf, _stex(scene), hit.bsdf_id, hit.uv)
    backface = hit.inside & ~bsdfs.is_twosided(scene.bsdf, hit.bsdf_id) & has_b
    take_em = (alive & hit.valid & emitter & ~backface
               & ((cos_prime >= EPSILON_FLOAT) | primary))
    if integ.hide_emitters:
        take_em = take_em & ~primary
    w_bsdf = mis_weight(_kept(take_em, pdf_mis), _kept(take_em, pdf_direct))
    L_add = _where3(take_em, w_bsdf[..., None] * _kept(take_em, beta) * rad,
                    torch.zeros_like(beta))
    return L_add, emitter | backface


def _roulette(integ, seed, vert, alive, beta):
    """Russian roulette with immediate compensation (one draw a lane)."""
    seed, rr_u = rng.random_float(seed)
    need_rr = vert >= integ.depth_rr
    alive = alive & (~need_rr | (rr_u < integ.pdf_rr))
    beta = _where3(alive & need_rr, beta * (1.0 / integ.pdf_rr), beta)
    return seed, alive, beta


def _scatter(scene, hit, wi_in, seed, alive, beta, pdf_mis):
    """BSDF sample -> the next segment.  Returns (seed, alive, beta,
    pdf_mis, o, d)."""
    seed, xi_b = rng.random_floats(seed, bsdfs.N_SAMPLE_DRAWS)
    wi, pdf_b, f, valid_b = _bsdf_sample(scene, hit, wi_in, xi_b)
    beta_new = beta * f / torch.clamp(pdf_b, min=1e-12)[..., None]
    alive = alive & valid_b & (beta_new.amax(dim=-1) >= EPSILON)
    beta = _where3(alive, beta_new, beta)
    pdf_mis = torch.where(hit.bsdf_id < 0, pdf_mis, pdf_b)
    return seed, alive, beta, pdf_mis, hit.position, -wi


def _fold(integ, L, L_samp, mask):
    """Fold finished per-sample radiance into the film sum, with the
    optional per-sample clamp (renderer.cpp:77-79)."""
    if integ.sample_clamp > 0:
        L_samp = torch.clamp(L_samp, max=integ.sample_clamp)
    return L + _where3(mask, L_samp, torch.zeros_like(L_samp))


def _no_lights(scene: SceneData) -> bool:
    """No emitter at all: only the primary vertex can see radiance."""
    return (scene.n_emissive == 0 and not scene.emitter_rows
            and scene.env_kind == "none")


def shade(scene: SceneData, integ, o, d, seed, differentiable: bool = False):
    """One sample of a ray batch, the chunked engine's body
    (mcpt_tpu/integrators/path.py:593-760): the primary hit and its
    escape and emitter terms, then up to depth_max - 1 bounces, each RR,
    NEE, a BSDF sample and the continuation's escape and emitter hit.
    pdf_mis starts at 1e12, so that an emitter seen through leading null
    shells takes full weight.  Returns (L [N, 3], seed).

    differentiable=True runs exactly depth_max - 1 bounces, as the
    reference's lax.scan does, where the default stops once no lane is
    alive (its while_loop): the seed returned, which the next sample
    starts from, then differs.  It also reads the envmap through the
    texture atlas (_escape_radiance, _nee_queries)."""
    n = o.shape[0]
    ghit = scene_closest(scene, o, d)
    hit = interpolate_hit(scene, ghit, o, d)
    hit, seed = apply_opacity(scene, hit, seed)
    L, ends = _chunked_primary(scene, integ, hit, d,
                               torch.ones_like(hit.valid), differentiable)
    alive = hit.valid & ~ends
    if _no_lights(scene) or integ.depth_max <= 1:
        return L, seed

    n_nee = nee_draw_count(scene)
    beta = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    pdf_mis = torch.full((n,), 1e12, dtype=torch.float32, device=o.device)
    no = torch.zeros_like(alive)
    wo = -d
    # origin-chunk keys of the rays that start at the current hit (MCPT_COH)
    coh = _origin_chunk(scene, ghit) if _use_origin_chunk(scene) else None
    dep = 1
    while dep < integ.depth_max and (differentiable
                                      or more_work(alive, "path.shade")):
        seed, alive, beta = _roulette(integ, seed, torch.tensor(dep), alive,
                                      beta)
        seed, xi_nee = rng.random_floats(seed, n_nee)
        L = L + beta * _direct_lighting(scene, hit, wo, alive, xi_nee, beta,
                                        differentiable, coherence=coh)
        seed, alive, beta, pdf_mis, o2, d2 = _scatter(
            scene, hit, wo, seed, alive, beta, pdf_mis)

        ghit = scene_closest(
            scene, o2, d2,
            t_max=torch.where(alive, torch.full_like(pdf_mis, MAX_FLOAT),
                              torch.zeros_like(pdf_mis)),
            coherence=coh)
        if coh is not None:
            coh = _origin_chunk(scene, ghit)
        hit = interpolate_hit(scene, ghit, o2, d2)
        hit, seed = apply_opacity(scene, hit, seed)
        L = _escape(scene, L, d2, beta, pdf_mis, alive, hit, no,
                    differentiable)
        alive = alive & hit.valid
        L_add, ends = _emitter_hit(scene, integ, hit, d2, beta, pdf_mis,
                                   alive, no)
        L = L + L_add
        alive = alive & ~ends
        wo = -d2
        dep += 1
    return L, seed


class _RegenState(NamedTuple):
    """The unbatched regen body's lanes, carried from one iteration to
    the next: the film sum and the open sample's radiance, throughput,
    ray, MIS pdf, seed, liveness, vertex, samples started and (MCPT_COH)
    origin-chunk key."""

    L: torch.Tensor
    L_samp: torch.Tensor
    beta: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    pdf_mis: torch.Tensor
    seed: torch.Tensor
    alive: torch.Tensor
    vert: torch.Tensor
    work_k: torch.Tensor
    coh: torch.Tensor


def _regen_start(reg: _Regen) -> _RegenState:
    """Every lane dead with all of its samples ahead: the first
    iteration regenerates them all."""
    n = reg.pixel_idx.shape[0]
    dev = reg.pixel_idx.device
    f32 = dict(dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((n, 3), **f32)
    d = zeros3.clone()
    d[:, 2] = 1.0
    return _RegenState(
        L=zeros3.clone(), L_samp=zeros3.clone(),
        beta=torch.ones((n, 3), **f32), o=zeros3.clone(), d=d,
        pdf_mis=torch.full((n,), 1e12, **f32),
        seed=rng.pixel_seed(reg.pixel_idx, reg.base),
        alive=torch.zeros(n, dtype=torch.bool, device=dev),
        vert=torch.zeros(n, dtype=torch.int32, device=dev),
        work_k=torch.zeros(n, dtype=torch.int32, device=dev),
        # -1 for a fresh camera ray, else the chunk of the hit the lane's
        # rays start at
        coh=torch.full((n,), -1, dtype=torch.int32, device=dev))


def _regen_step(scene: SceneData, integ, camera, reg: _Regen,
                st: _RegenState, n_nee: int, depth_cut: int,
                use_coh: bool) -> _RegenState:
    """One iteration of the unbatched regen body: regenerate, trace,
    shade, NEE with its shadow rays traced at once, BSDF sample."""
    L, L_samp, beta, o, d, pdf_mis, seed, alive, vert, work_k, coh = st
    spp = reg.spp
    # --- regenerate: dead lanes with samples left start the next one
    fresh = ~alive & (work_k < spp)
    L = _fold(integ, L, L_samp, fresh)
    L_samp = _where3(fresh, torch.zeros_like(L_samp), L_samp)
    o_new, d_new, seed_new = _camera_samples(camera, reg, fresh, work_k)
    o = _where3(fresh, o_new, o)
    d = _where3(fresh, d_new, d)
    seed = torch.where(fresh, seed_new, seed)
    beta = _where3(fresh, torch.ones_like(beta), beta)
    pdf_mis = torch.where(fresh, torch.full_like(pdf_mis, 1e12), pdf_mis)
    vert = torch.where(fresh, torch.zeros_like(vert), vert)
    alive = alive | fresh
    work_k = work_k + fresh.to(torch.int32)

    # --- trace (dead lanes get t_max = 0: the traversal skips them;
    # on the march route fresh camera rays and bounce continuations
    # sort into separate blocks by their class bit)
    coh = torch.where(fresh, torch.full_like(coh, -1), coh)
    ghit = scene_closest(
        scene, o, d,
        t_max=torch.where(alive, torch.full_like(pdf_mis, MAX_FLOAT),
                          torch.zeros_like(pdf_mis)),
        sort_bias=(~fresh).int(),
        coherence=coh if use_coh else None,
    )
    if use_coh:
        coh = _origin_chunk(scene, ghit)
    hit = interpolate_hit(scene, ghit, o, d)
    hit, seed = apply_opacity(scene, hit, seed)
    vert = vert + 1
    L_samp = _escape(scene, L_samp, d, beta, pdf_mis, alive, hit, vert == 1)
    L_add, ends = _emitter_hit(scene, integ, hit, d, beta, pdf_mis,
                               alive, vert == 1)
    L_samp = L_samp + L_add
    alive = alive & hit.valid & ~ends & (vert < depth_cut)
    seed, alive, beta = _roulette(integ, seed, vert, alive, beta)

    # --- NEE, its shadow rays traced now
    seed, xi_nee = rng.random_floats(seed, n_nee)
    L_samp = L_samp + beta * _direct_lighting(
        scene, hit, -d, alive, xi_nee, beta,
        coherence=coh if use_coh else None)

    seed, alive, beta, pdf_mis, o, d = _scatter(
        scene, hit, -d, seed, alive, beta, pdf_mis)
    return _RegenState(L, L_samp, beta, o, d, pdf_mis, seed, alive, vert,
                       work_k, coh)


def graph_engages(device_type: str, batched: bool, route: str) -> bool:
    """Whether shade_regen replays its iteration as a CUDA graph: lanes on
    CUDA, the unbatched body (the batched one sorts rays and runs K2
    inside its iteration, still eager) and any route but the pair route,
    whose overflow count syncs inside the iteration
    (ops/traversal.py::_march_overflow).  `route`: ops/traversal.py::
    route of the scene's geometry."""
    return device_type == "cuda" and not batched and route != "pairs"


#: the launch counters of the routes graph_engages admits: a replay
#: credits each with what the captured iteration launched
_LAUNCH_COUNTERS = (
    (dense_sweep, "launches"), (dense_sweep, "any_hit_launches"),
    (march_sweep, "launches"), (march_sweep, "any_hit_launches"),
    (packet_sweep, "launches"), (packet_sweep, "any_hit_launches"),
)


class _RegenGraph:
    """One iteration of the unbatched regen body captured as a CUDA graph
    (torch.cuda.CUDAGraph, in its own memory pool), and the tensors it
    reads and writes in place: the per-call inputs (pixel indices, frame
    base) and the lanes' state.  Everything else it reads is baked in:
    _graph_key."""

    def __init__(self, pixel_idx, camera):
        self.pixel_idx = pixel_idx.clone()
        self.base = torch.zeros((), dtype=torch.int64,
                                device=pixel_idx.device)
        self.camera = camera  # held: its id is part of the key
        self.state = None
        self.graph = None
        self.credit = ()

    def capture(self, advance):
        """Record advance(), which writes one iteration over the state.
        The capture runs nothing, so the launch counters it moved are put
        back and each replay credits them."""
        before = [getattr(m, a) for m, a in _LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            advance()
        self.credit = [getattr(m, a) - b
                       for (m, a), b in zip(_LAUNCH_COUNTERS, before)]
        for (m, a), b in zip(_LAUNCH_COUNTERS, before):
            setattr(m, a, b)
        self.graph = graph

    def replay(self):
        self.graph.replay()
        for (m, a), c in zip(_LAUNCH_COUNTERS, self.credit):
            setattr(m, a, getattr(m, a) + c)


def _graph_key(integ, camera, reg: _Regen) -> tuple:
    """What a captured iteration bakes in besides the scene, which holds
    the graphs: the lanes, the sample parameters but the frame base, the
    integrator, the camera, SHADOW_ALPHA_K and every MCPT_* setting (the
    NEE draws, the depth cut and MCPT_COH follow from them and the
    scene)."""
    pix = reg.pixel_idx
    return (pix.shape[0], pix.dtype, pix.device, reg.spp, reg.spp_total,
            reg.sample_offset, dataclasses.astuple(integ), id(camera),
            SHADOW_ALPHA_K,
            tuple(sorted((k, v) for k, v in os.environ.items()
                         if k.startswith("MCPT_"))))


def _regen_graphed(scene: SceneData, integ, camera, reg: _Regen,
                   n_nee: int, depth_cut: int, use_coh: bool) -> _RegenState:
    """The unbatched regen loop with its iteration replayed as a CUDA
    graph, the loop test on the host as in the eager loop.  The first
    call of a key runs one iteration eagerly (kernel library, allocator
    and lazily built tables settle), then captures; later calls of the
    key replay from their first iteration.  The result is bit-equal to
    the eager loop's."""
    key = _graph_key(integ, camera, reg)
    g = scene.graphs.get(key)
    if g is None:
        g = scene.graphs[key] = _RegenGraph(reg.pixel_idx, camera)
    g.pixel_idx.copy_(reg.pixel_idx)
    g.base.fill_(reg.base)
    reg = reg._replace(pixel_idx=g.pixel_idx, base=g.base)
    start = _regen_start(reg)
    if g.state is None:
        g.state = start
    else:
        for dst, src in zip(g.state, start):
            dst.copy_(src)
    st = g.state

    def advance():
        for dst, src in zip(st, _regen_step(scene, integ, camera, reg, st,
                                            n_nee, depth_cut, use_coh)):
            dst.copy_(src)

    eager = g.graph is None
    with torch.cuda.device(reg.pixel_idx.device):
        while more_work(st.alive | (st.work_k < reg.spp), "path.regen",
                        replay=not eager):
            if eager:
                advance()
                eager = False
                continue
            if g.graph is None:
                g.capture(advance)
            g.replay()
    return st._replace(seed=st.seed.clone())


def shade_regen(scene: SceneData, integ, camera, pixel_idx, spp: int,
                frame_base=0, spp_total: int | None = None, sample_offset=0):
    """Fused spp x depth wavefront with ray regeneration
    (mcpt_tpu/integrators/path.py:1058-1267).

    pixel_idx: [N] int tensor of linear pixel indices.  Sample k of a
    pixel uses jitter u = (sample_offset + k) / spp_total,
    v = VdC2(frame_base + sample_offset + k + 1) and seed
    Tea(pixel, frame_base + sample_offset + k).  Returns
    (film [N, 3] = mean over the spp samples, final seed).  Scenes the
    _use_batched_trace gate admits take _shade_regen_batched: the same
    estimator and sample streams, one traversal per iteration.  Where
    graph_engages, the unbatched iteration replays as a CUDA graph
    (_regen_graphed), cached in the scene."""
    reg = _Regen(pixel_idx, (int(frame_base) + int(sample_offset)) & 0xFFFFFFFF,
                 spp, spp if spp_total is None else spp_total, sample_offset)
    batched = _use_batched_trace(scene)
    if batched:
        return _shade_regen_batched(scene, integ, camera, reg)
    n_nee = nee_draw_count(scene)
    # with no lights (or depth_max 1) only the primary vertex matters
    depth_cut = (1 if (_no_lights(scene) or integ.depth_max <= 1)
                 else integ.depth_max)
    use_coh = _use_origin_chunk(scene)
    if graph_engages(pixel_idx.device.type, batched, route(scene.geom)):
        st = _regen_graphed(scene, integ, camera, reg, n_nee, depth_cut,
                            use_coh)
    else:
        st = _regen_start(reg)
        while more_work(st.alive | (st.work_k < spp), "path.regen"):
            st = _regen_step(scene, integ, camera, reg, st, n_nee, depth_cut,
                             use_coh)
    # fold the last sample of every lane (never followed by a regen)
    L = _fold(integ, st.L, st.L_samp, torch.ones_like(st.alive))
    return L / spp, st.seed


def _shade_regen_batched(scene: SceneData, integ, camera, reg: _Regen):
    """shade_regen with ONE traversal per iteration
    (mcpt_tpu/integrators/path.py:804-1055).

    The estimator and the per-sample draws are shade_regen's: only the
    occlusion of vertex v's NEE resolves one iteration later, inside the
    batch that traces vertex v+1's continuation.  Shadow segments run
    with closest-hit semantics (t_max = max(dist - EPSILON_DISTANCE, 0)
    at the default t_min; occluded = a hit exists), which the gate makes
    equal to any-hit.  Because a lane may regenerate in between, an ended
    sample's radiance parks in L_prev until its pending shadow rays
    resolve; the fold, with the per-sample clamp, comes strictly after
    that, so the clamp sees the whole sample."""
    pixel_idx, spp = reg.pixel_idx, reg.spp
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    q_n = _nee_query_count(scene)
    n_nee = nee_draw_count(scene)
    tau = nee_rr_tau()
    rr_base = n_nee - (q_n if tau > 0.0 else 0)
    depth_cut = integ.depth_max
    f32 = dict(dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((n, 3), **f32)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    def regen(work_k, L_samp, L_prev, fold_pend, beta, o, d, pdf_mis, seed,
              alive, vert, alive_entry):
        """Sample boundary: lanes whose sample just ended park L_samp in
        L_prev (folded after their pending shadows resolve) and, with
        samples left, start the next camera ray."""
        ended = alive_entry & ~alive
        L_prev = _where3(ended, L_samp, L_prev)
        fold_pend = fold_pend | ended
        L_samp = _where3(ended, zeros3, L_samp)
        fresh = ended & (work_k < spp)
        o_new, d_new, seed_new = _camera_samples(camera, reg, fresh, work_k)
        o = _where3(fresh, o_new, o)
        d = _where3(fresh, d_new, d)
        seed = torch.where(fresh, seed_new, seed)
        beta = _where3(fresh, torch.ones_like(beta), beta)
        pdf_mis = torch.where(fresh, torch.full_like(pdf_mis, 1e12), pdf_mis)
        vert = torch.where(fresh, torch.zeros_like(vert), vert)
        return (work_k + fresh.to(torch.int32), L_samp, L_prev, fold_pend,
                beta, o, d, pdf_mis, seed, alive | fresh, vert, fresh)

    # bootstrap: every lane "ended" an empty sample and regenerates;
    # nothing is truly pending yet
    d0 = zeros3.clone()
    d0[:, 2] = 1.0
    (work_k, L_samp, L_prev, _, beta, o, d, pdf_mis, seed, alive, vert,
     fresh) = regen(
        torch.zeros(n, dtype=torch.int32, device=dev), zeros3, zeros3, no,
        torch.ones((n, 3), **f32), zeros3, d0,
        torch.full((n,), 1e12, **f32), rng.pixel_seed(pixel_idx, reg.base),
        no, torch.zeros(n, dtype=torch.int32, device=dev), ~no)
    fold_pend = no
    L = zeros3
    sh_o = zeros3
    sh_d = torch.zeros((q_n, n, 3), **f32)     # toward the light
    sh_dist = torch.zeros((q_n, n), **f32)     # 0 = no query
    sh_pend = torch.zeros((q_n, n, 3), **f32)  # beta * contrib

    while more_work(alive | fold_pend, "path.batched"):
        # --- 1. ONE closest-hit trace of [continuation | shadow_1..Q];
        # coherence classes camera 0 / bounce 1 / shadow 2 + q, clipped to
        # the class field's 2 bits
        bhit = scene_closest(
            scene,
            torch.cat([o] + [sh_o] * q_n),
            torch.cat([d] + [sh_d[q] for q in range(q_n)]),
            t_max=torch.cat(
                [torch.where(alive, torch.full_like(pdf_mis, MAX_FLOAT),
                             torch.zeros_like(pdf_mis))]
                + [torch.clamp(sh_dist[q] - EPSILON_DISTANCE, min=0.0)
                   for q in range(q_n)]),
            sort_bias=torch.cat(
                [(~fresh).int()]
                + [torch.full((n,), min(2 + q, 3), dtype=torch.int32,
                              device=dev) for q in range(q_n)]),
        )
        ghit = type(bhit)(*(x[:n] for x in bhit))

        # --- 2. vertex v-1's NEE, now that its occlusion is known
        for q in range(q_n):
            occ = bhit.valid[n * (1 + q):n * (2 + q)]
            add = _where3(~occ & (sh_dist[q] > 0.0), sh_pend[q], zeros3)
            L_samp = L_samp + _where3(fold_pend, zeros3, add)
            L_prev = L_prev + _where3(fold_pend, add, zeros3)

        # --- 3. late fold: the parked sample is complete now
        L = _fold(integ, L, L_prev, fold_pend)
        L_prev = _where3(fold_pend, zeros3, L_prev)
        fold_pend = no

        # --- 4. shade the continuation hit (as shade_regen; the gate
        # admits no opacity maps, so apply_opacity draws nothing here)
        hit = interpolate_hit(scene, ghit, o, d)
        hit, seed = apply_opacity(scene, hit, seed)
        vert = vert + 1
        alive_entry = alive
        L_samp = _escape(scene, L_samp, d, beta, pdf_mis, alive, hit,
                         vert == 1)
        L_add, ends = _emitter_hit(scene, integ, hit, d, beta, pdf_mis,
                                   alive, vert == 1)
        L_samp = L_samp + L_add
        alive = alive & hit.valid & ~ends & (vert < depth_cut)
        seed, alive, beta = _roulette(integ, seed, vert, alive, beta)

        # --- 5. NEE: the whole contribution now, its occlusion next batch
        seed, xi_nee = rng.random_floats(seed, n_nee)
        queries = _nee_queries(scene, hit, -d, alive, xi_nee)
        sh_o = hit.position
        new_d, new_dist, new_pend = [], [], []
        for j, (wi, dist, geo_ok, contrib) in enumerate(queries):
            pend = beta * contrib
            if tau > 0.0:
                pend, geo_ok = _nee_rr(pend, geo_ok, xi_nee[rr_base + j], tau)
            live_q = geo_ok & alive & (pend.amax(dim=-1) > 0.0)
            new_d.append(_where3(live_q, -wi, zeros3))
            new_dist.append(torch.where(live_q, dist, torch.zeros_like(dist)))
            new_pend.append(_where3(live_q, pend, zeros3))
        if q_n:
            sh_d = torch.stack(new_d)
            sh_dist = torch.stack(new_dist)
            sh_pend = torch.stack(new_pend)

        # --- 6. BSDF sample -> the next continuation
        seed, alive, beta, pdf_mis, o, d = _scatter(
            scene, hit, -d, seed, alive, beta, pdf_mis)

        # --- 7. sample boundary: park ended samples, start new ones
        (work_k, L_samp, L_prev, fold_pend, beta, o, d, pdf_mis, seed,
         alive, vert, fresh) = regen(
            work_k, L_samp, L_prev, fold_pend, beta, o, d, pdf_mis, seed,
            alive, vert, alive_entry)

    return L / spp, seed
