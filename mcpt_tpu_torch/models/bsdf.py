"""BSDFs (counterpart of mcpt_tpu/models/bsdf.py): SoA parameter tables
and wavefront sample/evaluate for every family of the reference —
diffuse, rough diffuse (Oren-Nayar), rough conductor, rough dielectric,
thin dielectric, plastic and the clear-coated conductor — with GGX or
Beckmann microfacets and Kulla-Conty compensation.

One SoA row per scene BSDF; each family present in the scene
(`present_types`) is evaluated over the whole wavefront and merged by
its lanes' mask.  Conventions are the reference's:

* `wi` is the direction light travels (into the surface), `wo` points
  toward the viewer;
* Sample() flips the shading normal, and toggles `inside`, when
  dot(wo, n) < 0; Evaluate() when dot(-wi, n) < 0 (csrt path.cpp:252-256,
  281-285); tangent and bitangent never flip;
* the returned attenuation is f * |cos theta_i|;
* microfacet "D" is the half-vector sampling pdf D(h) cos(theta_h), csrt's
  SampleGgx output, so F*D*G/(4 N.O) carries the reference's convention;
* for diffuse-like lobes Evaluate's MIS pdf is cos(theta_i)/pi (the
  reference's documented deviation from csrt's dot(wo, n)).

Every parameter read goes through `_ktex`, which narrows the texture
kinds to those the parameter's column can reach (`col_kinds`), so a
scene whose only bitmaps are albedos does no bitmap gathers for its
roughness.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.models import texture as textures
from mcpt_tpu_torch.models.kulla_conty import (
    LUT_RESOLUTION,
    lookup_albedo_avg,
    lookup_brdf_avg,
)
from mcpt_tpu_torch.ops.math import (
    EPSILON,
    EPSILON_FLOAT,
    INV_PI,
    PI,
    arccos,
    atan2,
    channel_sum,
    cos,
    dot,
    normalize,
    reflect,
    refract,
    sin,
    sqr,
    sqrt,
    take_rows,
    to_local,
    to_world,
)
from mcpt_tpu_torch.ops.microfacet import (
    _ipow,
    average_fresnel_rgb,
    average_fresnel_scalar,
    fresnel_dielectric,
    fresnel_schlick,
    pdf_beckmann,
    pdf_ggx,
    sample_beckmann,
    sample_ggx,
    smith_g1,
    smith_g1_beckmann,
)
from mcpt_tpu_torch.ops.warps import sample_hemisphere_cosine
from mcpt_tpu_torch.scene.ir import BsdfInfo, BsdfType

#: uniform draws one bsdf_sample call consumes across all families, so
#: per-lane RNG streams stay aligned (diffuse and conductor use 2 of them)
N_SAMPLE_DRAWS = 3

_MIN_ALPHA = 1e-4  # smooth lobes get roughness 0.001 (csrt parser.cpp:896)


class BsdfTables(NamedTuple):
    btype: torch.Tensor              # [B] int32
    twosided: torch.Tensor           # [B] bool
    opacity_tid: torch.Tensor        # [B] int32 (-1 none)
    bump_tid: torch.Tensor           # [B] int32 (-1 none)
    radiance_tid: torch.Tensor       # [B] int32 (area light)
    diffuse_tid: torch.Tensor        # [B] int32
    roughness_tid: torch.Tensor      # [B] int32 (rough diffuse sigma / plastic)
    roughness_u_tid: torch.Tensor    # [B] int32
    roughness_v_tid: torch.Tensor    # [B] int32
    specular_tid: torch.Tensor       # [B] int32 (-1 => white)
    transmit_tid: torch.Tensor       # [B] int32 (-1 => white)
    # conductor Gulbrandsen parametrization, values (csrt bsdf.cpp:148-151)
    reflectivity_rgb: torch.Tensor   # [B, 3]
    edgetint_rgb: torch.Tensor       # [B, 3]
    f_avg_rgb: torch.Tensor          # [B, 3] conductor average Fresnel
    # dielectric / thin dielectric / plastic scalars
    eta: torch.Tensor                # [B]
    eta_inv: torch.Tensor            # [B]
    reflectivity: torch.Tensor       # [B] ((eta-1)/(eta+1))^2
    f_avg: torch.Tensor              # [B] average Fresnel(eta)
    f_avg_inv: torch.Tensor          # [B] average Fresnel(1/eta)
    use_fast_approx: torch.Tensor    # [B] bool (rough diffuse)
    use_beckmann: torch.Tensor       # [B] bool (Beckmann NDF, else GGX)
    clear_coat: torch.Tensor         # [B] f32 clear-coat weight (0 = none)
    coat_roughness_tid: torch.Tensor  # [B] int32 coat alpha texture
    #: the texture kinds each parameter column can reach (static):
    #: (("diffuse", (1, 3)), ...); empty = the caller's kinds
    col_kinds: tuple = ()


def _ktex(tex, tables: BsdfTables, col: str):
    """Texture view narrowed to column `col`'s kinds (the caller's kinds
    where the table records none)."""
    for name, kinds in tables.col_kinds:
        if name == col:
            return tex._replace(kinds=kinds)
    return tex


_COL_ATTR = {
    "opacity": "id_opacity",
    "bump": "id_bump_map",
    "radiance": "id_radiance",
    "diffuse": "id_diffuse_reflectance",
    "roughness": "id_roughness",
    "roughness_u": "id_roughness_u",
    "roughness_v": "id_roughness_v",
    "specular": "id_specular_reflectance",
    "transmit": "id_specular_transmittance",
    "coat_roughness": "id_coat_roughness",
}


def _column_kinds(infos, tex_infos) -> tuple:
    """The texture kinds each parameter column can reach."""
    if tex_infos is None:
        return ()
    out = []
    for col, attr in _COL_ATTR.items():
        tids = (getattr(i, attr) for i in infos)
        kinds = {tex_infos[t]["type"] for t in tids if 0 <= t < len(tex_infos)}
        out.append((col, tuple(sorted(kinds))))
    return tuple(out)


def build_bsdf_tables(infos: list[BsdfInfo], device,
                      tex_infos=None) -> BsdfTables:
    """Host-side commit (csrt renderer.cpp:433-501 CommitBsdfs + Bsdf ctor
    bsdf.cpp:115-188), the reference's build_bsdf_tables; `tex_infos`
    (the TextureBuilder's infos) gives the per-column texture kinds."""
    b = max(len(infos), 1)

    def arr(fn, dtype):
        out = np.zeros(b, dtype)
        for i, info in enumerate(infos):
            out[i] = fn(info)
        return out

    eta = arr(lambda i: i.eta, np.float32)
    eta = np.where(eta == 0.0, 1.0, eta)
    f_avg = np.zeros(b, np.float32)
    f_avg_inv = np.zeros(b, np.float32)
    refl_rgb = np.ones((b, 3), np.float32)
    edge_rgb = np.ones((b, 3), np.float32)
    f_avg_rgb = np.zeros((b, 3), np.float32)
    twosided = np.zeros(b, np.bool_)
    for i, info in enumerate(infos):
        twosided[i] = info.twosided
        if info.btype in (BsdfType.DIELECTRIC, BsdfType.THIN_DIELECTRIC,
                          BsdfType.PLASTIC):
            f_avg[i] = average_fresnel_scalar(info.eta)
            f_avg_inv[i] = average_fresnel_scalar(1.0 / info.eta)
        if info.btype in (BsdfType.DIELECTRIC, BsdfType.THIN_DIELECTRIC):
            twosided[i] = True  # dielectrics are forced two-sided (bsdf.cpp:161)
        if info.btype in (BsdfType.CONDUCTOR, BsdfType.CLEARCOAT_CONDUCTOR):
            refl_rgb[i] = np.broadcast_to(
                np.asarray(info.reflectivity, np.float32), (3,))
            edge_rgb[i] = np.broadcast_to(
                np.asarray(info.edgetint, np.float32), (3,))
            f_avg_rgb[i] = average_fresnel_rgb(refl_rgb[i], edge_rgb[i])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def ids(attr):
        return dev(arr(lambda i: getattr(i, attr), np.int32))

    return BsdfTables(
        btype=dev(arr(lambda i: int(i.btype), np.int32)),
        twosided=dev(twosided),
        opacity_tid=ids("id_opacity"),
        bump_tid=ids("id_bump_map"),
        radiance_tid=ids("id_radiance"),
        diffuse_tid=ids("id_diffuse_reflectance"),
        roughness_tid=ids("id_roughness"),
        roughness_u_tid=ids("id_roughness_u"),
        roughness_v_tid=ids("id_roughness_v"),
        specular_tid=ids("id_specular_reflectance"),
        transmit_tid=ids("id_specular_transmittance"),
        reflectivity_rgb=dev(refl_rgb),
        edgetint_rgb=dev(edge_rgb),
        f_avg_rgb=dev(f_avg_rgb),
        eta=dev(eta),
        eta_inv=dev((1.0 / eta).astype(np.float32)),
        reflectivity=dev(((eta - 1.0) ** 2 / (eta + 1.0) ** 2).astype(np.float32)),
        f_avg=dev(f_avg),
        f_avg_inv=dev(f_avg_inv),
        use_fast_approx=dev(arr(lambda i: i.use_fast_approx, np.bool_)),
        use_beckmann=dev(arr(lambda i: i.ndf == "beckmann", np.bool_)),
        clear_coat=dev(arr(lambda i: i.clear_coat, np.float32)),
        coat_roughness_tid=ids("id_coat_roughness"),
        col_kinds=_column_kinds(infos, tex_infos),
    )


# ---------------------------------------------------------------------------
# Shading frame and parameter helpers


def orient_frame(normal, tangent, bitangent, inside, ref_dir):
    """Flip the shading normal to the side of `ref_dir` and toggle
    `inside` where it flips (csrt path.cpp:252-256).  Returns (normal,
    inside); tangent and bitangent never flip."""
    flip = dot(ref_dir, normal) < 0.0
    return torch.where(flip[..., None], -normal, normal), inside ^ flip


def _where3(m, a, b):
    return torch.where(m[..., None], a, b)


def _tex_or_white(tex, tid, uv):
    """Texture color, or 1 where the id is unset."""
    c = textures.eval_color(tex, torch.clamp(tid, min=0), uv)
    return _where3(tid >= 0, c, torch.ones_like(c))


def _scalar_tex(tex, tid, uv, default=0.1):
    s = textures.eval_scalar(tex, torch.clamp(tid, min=0), uv)
    return torch.where(tid >= 0, s, torch.full_like(s, default))


def _safe(x, eps=1e-12):
    """x pushed away from 0 to +-eps (its sign, + at 0)."""
    small = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(torch.abs(x) < eps, small, x)


def _alpha(tables, tex, col: str, bid, uv, scale=None):
    """Roughness `col` of each lane's row, times `scale`, at least
    _MIN_ALPHA."""
    a = _scalar_tex(_ktex(tex, tables, col.removesuffix("_tid")),
                    take_rows(getattr(tables, col), bid), uv)
    if scale is not None:
        a = a * scale
    return torch.clamp(a, min=_MIN_ALPHA)


def _alphas(tables, tex, bid, uv, scale=None):
    return (_alpha(tables, tex, "roughness_u_tid", bid, uv, scale),
            _alpha(tables, tex, "roughness_v_tid", bid, uv, scale))


# Per-lane NDF selection (GGX default, Beckmann for archive-parity BSDFs)


def _sample_ndf(xi0, xi1, au, av, beck):
    hg, pg = sample_ggx(xi0, xi1, au, av)
    hb, pb = sample_beckmann(xi0, xi1, au, av)
    return _where3(beck, hb, hg), torch.where(beck, pb, pg)


def _pdf_ndf(au, av, h_local, beck):
    return torch.where(beck, pdf_beckmann(au, av, h_local),
                       pdf_ggx(au, av, h_local))


def _g1_ndf(au, av, v_local, h_local, beck):
    return torch.where(beck, smith_g1_beckmann(au, av, v_local, h_local),
                       smith_g1(au, av, v_local, h_local))


# ---------------------------------------------------------------------------
# Kulla-Conty multiple-scatter terms


def _kc_conductor(kc, f_avg_rgb, n_dot_i, n_dot_o, alpha):
    """csrt conductor.cpp:14-27 (EvaluateMultipleScatter)."""
    brdf_avg, albedo_avg = kc
    e_i = lookup_brdf_avg(brdf_avg, n_dot_i, alpha)
    e_o = lookup_brdf_avg(brdf_avg, n_dot_o, alpha)
    e_avg = lookup_albedo_avg(albedo_avg, alpha)
    f_ms = (1.0 - e_i) * (1.0 - e_o) / (PI * _safe(1.0 - e_avg))
    f_add = (sqr(f_avg_rgb) * e_avg[..., None]
             / _safe(1.0 - f_avg_rgb * (1.0 - e_avg[..., None])))
    return f_ms[..., None] * f_add * n_dot_i[..., None]


def _kc_dielectric(kc, f_avg, f_avg_inv, eta_d, eta_inv_d, n_dot_i, n_dot_o,
                   alpha, inside, is_reflect):
    """csrt dielectric.cpp:14-36; `inside`, `is_reflect`: [N] bool,
    `eta_d`, `eta_inv_d`: the table's values."""
    brdf_avg, albedo_avg = kc
    e_i = lookup_brdf_avg(brdf_avg, n_dot_i, alpha)
    e_o = lookup_brdf_avg(brdf_avg, n_dot_o, alpha)
    e_avg = lookup_albedo_avg(albedo_avg, alpha)
    f_ms = (1.0 - e_i) * (1.0 - e_o) / (PI * _safe(1.0 - e_avg))
    f_avg_side = torch.where(inside, f_avg_inv, f_avg)
    eta_side = torch.where(inside, eta_inv_d, eta_d)
    f_add = sqr(f_avg_side) * e_avg / _safe(1.0 - f_avg_side * (1.0 - e_avg))
    ratio_trans = (
        (1.0 - f_avg) * (1.0 - f_avg_inv) * sqr(eta_side)
        / _safe((1.0 - f_avg) + (1.0 - f_avg_inv) * sqr(eta_side)))
    ret = f_ms * f_add * n_dot_i
    return torch.where(is_reflect, (1.0 - ratio_trans) * ret, ratio_trans * ret)


def _kc_iso(comp, au, av):
    """Compensation only where the roughness is isotropic."""
    return torch.where(torch.abs(au - av) < 1e-6, comp, torch.zeros_like(comp))


# ---------------------------------------------------------------------------
# Per-family lobes: (wi, pdf, attenuation, valid) for sample, (pdf,
# attenuation, valid) for evaluate; total functions over the wavefront.


def _sample_diffuse(tex, albedo_tid, uv, n, t, b, xi):
    """Lambert cosine sampling (csrt diffuse.cpp:22-34)."""
    wi_local, pdf = sample_hemisphere_cosine(xi[0], xi[1])
    wi = -to_world(wi_local, t, b, n)
    albedo = textures.eval_color(tex, albedo_tid, uv)
    atten = albedo * (INV_PI * wi_local[..., 2])[..., None]
    return wi, pdf, atten, pdf >= EPSILON


def _eval_diffuse(tex, albedo_tid, uv, n, wi, wo):
    cos_i = dot(-wi, n)
    cos_o = dot(wo, n)
    pdf = INV_PI * torch.clamp(cos_i, min=0.0)
    albedo = textures.eval_color(tex, albedo_tid, uv)
    atten = albedo * (INV_PI * torch.clamp(cos_i, min=0.0))[..., None]
    return pdf, atten, (cos_i >= EPSILON) & (cos_o >= EPSILON)


def _oren_nayar(albedo, sigma, wi_local, wo_local, fast):
    """Oren-Nayar attenuation, full and fast variants (csrt
    rough_diffuse.cpp:10-100); `fast` is a per-lane bool."""
    conv = 0.70710678118  # Beckmann RMS -> slope-area variance
    sigma_2 = sqr(sigma * conv)
    n_dot_i = torch.clamp(wi_local[..., 2], 1e-6, 1.0)
    n_dot_o = torch.clamp(wo_local[..., 2], 1e-6, 1.0)
    sin_i = sqrt(torch.clamp(1.0 - sqr(n_dot_i), min=0.0))
    sin_o = sqrt(torch.clamp(1.0 - sqr(n_dot_o), min=0.0))
    theta_i = arccos(n_dot_i)
    theta_o = arccos(n_dot_o)
    phi_i = atan2(wi_local[..., 1], wi_local[..., 0])
    phi_o = atan2(wo_local[..., 1], wo_local[..., 0])
    cos_phi_diff = (cos(phi_i) * cos(phi_o)
                    + sin(phi_i) * sin(phi_o))

    i_gt_o = n_dot_i > n_dot_o
    sin_alpha = torch.where(i_gt_o, sin_o, sin_i)
    sin_beta = torch.where(i_gt_o, sin_i, sin_o)
    tan_beta = torch.where(i_gt_o, sin_i / n_dot_i, sin_o / n_dot_o)

    # fast approximation
    a_f = 1.0 - 0.5 * sigma_2 / (sigma_2 + 0.33)
    b_f = 0.45 * sigma_2 / (sigma_2 + 0.09)
    fast_atten = albedo * (
        INV_PI * n_dot_i
        * (a_f + b_f * torch.clamp(cos_phi_diff, min=0.0) * sin_alpha
           * tan_beta))[..., None]

    # full model
    alpha_ang = torch.maximum(theta_i, theta_o)
    beta_ang = torch.minimum(theta_i, theta_o)
    tmp = sigma_2 / (sigma_2 + 0.09)
    tmp2 = 4.0 * INV_PI * INV_PI * alpha_ang * beta_ang
    tmp3 = 2.0 * beta_ang * INV_PI
    c1 = 1.0 - 0.5 * sigma_2 / (sigma_2 + 0.33)
    c2 = 0.45 * tmp
    c2 = torch.where(cos_phi_diff > 0.0, c2 * sin_alpha,
                     c2 * (sin_alpha - _ipow(tmp3, 3)))
    c3 = 0.125 * tmp * sqr(tmp2)
    c4 = 0.17 * sigma_2 / (sigma_2 + 0.13)
    tan_half = (sin_alpha + sin_beta) / (
        sqrt(torch.clamp(1.0 - sqr(sin_alpha), min=0.0))
        + sqrt(torch.clamp(1.0 - sqr(sin_beta), min=0.0))
        + 1e-12)
    sngl = albedo * (
        c1 + cos_phi_diff * c2 * tan_beta
        + (1.0 - torch.abs(cos_phi_diff)) * c3 * tan_half)[..., None]
    dbl = sqr(albedo) * (c4 * (1.0 - cos_phi_diff * sqr(tmp3)))[..., None]
    full_atten = (sngl + dbl) * (INV_PI * n_dot_i)[..., None]
    return _where3(fast, fast_atten, full_atten)


def _eval_rough_diffuse_atten(tables, tex, bid, uv, n, t, b, wi, wo):
    albedo = textures.eval_color(_ktex(tex, tables, "diffuse"),
                                 take_rows(tables.diffuse_tid, bid), uv)
    sigma = _scalar_tex(_ktex(tex, tables, "roughness"),
                        take_rows(tables.roughness_tid, bid), uv)
    # the reference puts an optimization barrier (MCPT_ON_BARRIER) here, a
    # fusion break for the TPU compiler; eager torch has nothing to fuse,
    # so it has no counterpart
    wi_local = to_local(-wi, t, b, n)
    wo_local = to_local(wo, t, b, n)
    fast = take_rows(tables.use_fast_approx, bid)
    return _oren_nayar(albedo, sigma, wi_local, wo_local, fast)


def _sample_conductor(tables, tex, kc, bid, uv, wo, n, t, b, xi):
    """GGX reflection with Schlick Fresnel and Kulla-Conty compensation
    (csrt conductor.cpp:36-79)."""
    au, av = _alphas(tables, tex, bid, uv)
    beck = take_rows(tables.use_beckmann, bid)
    h_local, d_pdf = _sample_ndf(xi[0], xi[1], au, av, beck)
    h = to_world(h_local, t, b, n)
    h_dot_o = dot(wo, h)
    pdf = d_pdf / (4.0 * _safe(h_dot_o))
    wi = -reflect(-wo, h)
    n_dot_i = dot(-wi, n)

    wi_local = to_local(-wi, t, b, n)
    wo_local = to_local(wo, t, b, n)
    g = (_g1_ndf(au, av, wi_local, h_local, beck)
         * _g1_ndf(au, av, wo_local, h_local, beck))
    h_dot_i = dot(-wi, h)
    n_dot_o = wo_local[..., 2]
    f = fresnel_schlick(h_dot_i, take_rows(tables.reflectivity_rgb, bid))
    atten = f * (d_pdf * g / (4.0 * _safe(n_dot_o)))[..., None]

    comp = _kc_conductor(kc, take_rows(tables.f_avg_rgb, bid), n_dot_i,
                         n_dot_o, au)
    atten = atten + _kc_iso(comp, au[..., None], av[..., None])
    atten = atten * _tex_or_white(_ktex(tex, tables, "specular"),
                                  take_rows(tables.specular_tid, bid), uv)
    valid = (pdf >= EPSILON) & (n_dot_i >= EPSILON_FLOAT)
    return wi, pdf, atten, valid


def _eval_conductor(tables, tex, kc, bid, uv, wi, wo, n, t, b):
    """csrt conductor.cpp:81-124."""
    n_dot_o = dot(wo, n)
    h = normalize(-wi + wo)
    h_local = to_local(h, t, b, n)
    au, av = _alphas(tables, tex, bid, uv)
    beck = take_rows(tables.use_beckmann, bid)
    d = _pdf_ndf(au, av, h_local, beck)
    h_dot_o = dot(wo, h)
    pdf = d / (4.0 * _safe(h_dot_o))

    wi_local = to_local(-wi, t, b, n)
    wo_local = to_local(wo, t, b, n)
    g = (_g1_ndf(au, av, wi_local, h_local, beck)
         * _g1_ndf(au, av, wo_local, h_local, beck))
    h_dot_i = dot(-wi, h)
    f = fresnel_schlick(h_dot_i, take_rows(tables.reflectivity_rgb, bid))
    atten = f * (d * g / (4.0 * _safe(n_dot_o)))[..., None]

    n_dot_i = dot(-wi, n)
    comp = _kc_conductor(kc, take_rows(tables.f_avg_rgb, bid), n_dot_i,
                         n_dot_o, au)
    atten = atten + _kc_iso(comp, au[..., None], av[..., None])
    atten = atten * _tex_or_white(_ktex(tex, tables, "specular"),
                                  take_rows(tables.specular_tid, bid), uv)
    valid = (n_dot_o >= EPSILON_FLOAT) & (pdf >= EPSILON)
    return pdf, atten, valid


def _sample_dielectric(tables, tex, kc, bid, uv, wo, n, t, b, inside, xi):
    """Rough dielectric reflect/refract (csrt dielectric.cpp:44-146)."""
    scale = 1.2 - 0.2 * sqrt(torch.abs(dot(-wo, n)))
    au, av = _alphas(tables, tex, bid, uv, scale)
    beck = take_rows(tables.use_beckmann, bid)
    h_local, d_pdf = _sample_ndf(xi[0], xi[1], au, av, beck)
    h = to_world(h_local, t, b, n)
    h_dot_o = dot(wo, h)

    # relative IOR bookkeeping exactly as the reference (dielectric.cpp:61-69)
    eta_tab = take_rows(tables.eta, bid)
    eta_inv_tab = take_rows(tables.eta_inv, bid)
    eta = torch.where(inside, eta_tab, eta_inv_tab)
    eta_inv = torch.where(inside, eta_inv_tab, eta_tab)

    refract_ok, wt = refract(-wo, h, eta)
    refl = take_rows(tables.reflectivity, bid)
    f_sel = fresnel_schlick(h_dot_o, refl)
    choose_reflect = ~refract_ok | (xi[2] < f_sel)

    wo_local = to_local(wo, t, b, n)
    n_dot_o = wo_local[..., 2]
    f_avg = take_rows(tables.f_avg, bid)
    f_avg_inv = take_rows(tables.f_avg_inv, bid)
    spec = _tex_or_white(_ktex(tex, tables, "specular"),
                         take_rows(tables.specular_tid, bid), uv)
    tran = _tex_or_white(_ktex(tex, tables, "transmit"),
                         take_rows(tables.transmit_tid, bid), uv)

    # reflection branch
    wi_r = -reflect(-wo, h)
    n_dot_i_r = dot(-wi_r, n)
    pdf_r = f_sel * d_pdf / (4.0 * _safe(h_dot_o))
    wi_local_r = to_local(-wi_r, t, b, n)
    g_r = (_g1_ndf(au, av, wi_local_r, h_local, beck)
           * _g1_ndf(au, av, wo_local, h_local, beck))
    atten_r = (f_sel * d_pdf * g_r / (4.0 * _safe(n_dot_o)))[..., None].expand(
        wo.shape)
    comp_r = _kc_dielectric(kc, f_avg, f_avg_inv, eta_tab, eta_inv_tab,
                            n_dot_i_r, n_dot_o, au, inside,
                            torch.ones_like(inside))
    atten_r = (atten_r + _kc_iso(comp_r, au, av)[..., None]) * spec
    valid_r = (n_dot_i_r >= EPSILON_FLOAT) & (pdf_r >= EPSILON)

    # refraction branch (wi = -wt; local z flipped, dielectric.cpp:102-146)
    wi_t = -wt
    wi_local_t = to_local(-wi_t, t, b, n)
    wi_local_t = torch.cat([wi_local_t[..., :2], -wi_local_t[..., 2:]], dim=-1)
    n_dot_i_t = wi_local_t[..., 2]
    h_dot_i_t = -dot(wt, h)
    h_dot_o_t = -h_dot_o
    f_t = fresnel_schlick(h_dot_i_t, refl)
    denom = sqr(eta_inv * h_dot_i_t + h_dot_o_t)
    pdf_t = (1.0 - f_t) * d_pdf * torch.abs(h_dot_o_t / _safe(denom))
    g_t = (_g1_ndf(au, av, wi_local_t, h_local, beck)
           * _g1_ndf(au, av, wo_local, h_local, beck))
    atten_t_s = (torch.abs(h_dot_i_t) * torch.abs(h_dot_o_t) * (1.0 - f_t)
                 * g_t * d_pdf) / torch.abs(_safe(n_dot_o * denom))
    comp_t = _kc_dielectric(kc, f_avg, f_avg_inv, eta_tab, eta_inv_tab,
                            n_dot_i_t, n_dot_o, au, ~inside,
                            torch.zeros_like(inside))
    atten_t = atten_t_s[..., None].expand(wo.shape)
    atten_t = atten_t + _kc_iso(comp_t, au, av)[..., None]
    atten_t = atten_t * sqr(eta)[..., None] * tran
    valid_t = ((n_dot_i_t >= EPSILON_FLOAT) & (h_dot_i_t >= EPSILON_FLOAT)
               & (pdf_t >= EPSILON))

    wi = _where3(choose_reflect, wi_r, wi_t)
    pdf = torch.where(choose_reflect, pdf_r, pdf_t)
    atten = _where3(choose_reflect, atten_r, atten_t)
    valid = torch.where(choose_reflect, valid_r, valid_t)
    return wi, pdf, atten, valid & (h_dot_o >= EPSILON_FLOAT)


def _eval_dielectric(tables, tex, kc, bid, uv, wi, wo, n, t, b, inside):
    """csrt dielectric.cpp:148-232 (raw alpha, no sampling scale)."""
    eta_tab = take_rows(tables.eta, bid)
    eta_inv_tab = take_rows(tables.eta_inv, bid)
    # Evaluate swaps on `inside` (the frame was oriented by -wi)
    eta = torch.where(inside, eta_inv_tab, eta_tab)
    eta_inv = torch.where(inside, eta_tab, eta_inv_tab)

    n_dot_o = dot(wo, n)
    is_reflect = n_dot_o > 0.0
    h_refl = normalize(-wi + wo)
    h_tran = -normalize(eta_inv[..., None] * (-wi) + wo)
    h = _where3(is_reflect, h_refl, h_tran)
    h_local = to_local(h, t, b, n)

    au, av = _alphas(tables, tex, bid, uv)
    beck = take_rows(tables.use_beckmann, bid)
    d = _pdf_ndf(au, av, h_local, beck)
    h_dot_i = dot(-wi, h)
    h_dot_o = dot(wo, h)
    f = fresnel_schlick(h_dot_i, take_rows(tables.reflectivity, bid))
    denom = sqr(eta_inv * h_dot_i + h_dot_o)
    pdf = torch.where(is_reflect, f * d / (4.0 * _safe(h_dot_o)),
                      (1.0 - f) * d * torch.abs(h_dot_o / _safe(denom)))

    wi_local = to_local(-wi, t, b, n)
    wo_local = _where3(is_reflect, to_local(wo, t, b, n),
                       to_local(-wo, t, b, n))
    g = (_g1_ndf(au, av, wi_local, h_local, beck)
         * _g1_ndf(au, av, wo_local, h_local, beck))
    atten_r = f * d * g / (4.0 * _safe(n_dot_o))
    atten_t = (torch.abs(h_dot_i) * torch.abs(h_dot_o) * (1.0 - f) * g * d
               ) / torch.abs(_safe(n_dot_o * denom))

    n_dot_i = dot(-wi, n)
    comp = _kc_dielectric(kc, take_rows(tables.f_avg, bid),
                          take_rows(tables.f_avg_inv, bid), eta_tab,
                          eta_inv_tab, n_dot_i, n_dot_o, au, inside,
                          is_reflect)
    atten_s = torch.where(is_reflect, atten_r, atten_t * sqr(eta))
    comp_s = _kc_iso(comp, au, av)
    comp_s = torch.where(is_reflect, comp_s, comp_s * sqr(eta))
    spec = _tex_or_white(_ktex(tex, tables, "specular"),
                         take_rows(tables.specular_tid, bid), uv)
    tran = _tex_or_white(_ktex(tex, tables, "transmit"),
                         take_rows(tables.transmit_tid, bid), uv)
    atten = (atten_s + comp_s)[..., None] * _where3(is_reflect, spec, tran)
    return pdf, atten, pdf >= EPSILON


def _sample_thin_dielectric(tables, tex, bid, uv, wo, n, t, b, xi):
    """csrt thin_dielectric.cpp:11-71: double-interface Fresnel; reflect,
    or pass straight through (wi = wo)."""
    au, av = _alphas(tables, tex, bid, uv)
    beck = take_rows(tables.use_beckmann, bid)
    h_local, d_pdf = _sample_ndf(xi[0], xi[1], au, av, beck)
    h = to_world(h_local, t, b, n)
    h_dot_o = dot(wo, h)
    pdf0 = d_pdf / (4.0 * _safe(h_dot_o))

    wi_r = -reflect(-wo, h)
    n_dot_i = dot(-wi_r, n)
    wi_local = to_local(-wi_r, t, b, n)
    wo_local = to_local(wo, t, b, n)
    g = (_g1_ndf(au, av, wi_local, h_local, beck)
         * _g1_ndf(au, av, wo_local, h_local, beck))
    h_dot_i = dot(-wi_r, h)
    n_dot_o = wo_local[..., 2]
    f1 = fresnel_schlick(h_dot_i, take_rows(tables.reflectivity, bid))
    f = torch.where(f1 < 1.0, f1 * 2.0 / (1.0 + f1), f1)

    choose_reflect = xi[2] < f
    pdf = torch.where(choose_reflect, pdf0 * f, pdf0 * (1.0 - f))
    base = (torch.where(choose_reflect, f, 1.0 - f) * d_pdf * g
            / (4.0 * _safe(n_dot_o)))
    spec = _tex_or_white(_ktex(tex, tables, "specular"),
                         take_rows(tables.specular_tid, bid), uv)
    tran = _tex_or_white(_ktex(tex, tables, "transmit"),
                         take_rows(tables.transmit_tid, bid), uv)
    atten = base[..., None] * _where3(choose_reflect, spec, tran)
    wi = _where3(choose_reflect, wi_r, wo)
    valid = (pdf >= EPSILON) & (n_dot_i >= EPSILON_FLOAT)
    return wi, pdf, atten, valid


def _eval_thin_dielectric(tables, tex, bid, uv, wi, wo, n, t, b):
    """csrt thin_dielectric.cpp:73-135."""
    n_dot_o_raw = dot(wo, n)
    is_reflect = n_dot_o_raw >= 0.0
    n_dot_o = torch.abs(n_dot_o_raw)
    wo_local = to_local(wo, t, b, n)
    wo_local = torch.cat([wo_local[..., :2], torch.abs(wo_local[..., 2:])],
                         dim=-1)
    wo_eff = to_world(wo_local, t, b, n)

    h = normalize(-wi + wo_eff)
    h_local = to_local(h, t, b, n)
    au, av = _alphas(tables, tex, bid, uv)
    beck = take_rows(tables.use_beckmann, bid)
    d = _pdf_ndf(au, av, h_local, beck)
    h_dot_i = dot(-wi, h)
    h_dot_o = dot(wo, h)
    f1 = fresnel_schlick(h_dot_i, take_rows(tables.reflectivity, bid))
    f = torch.where(f1 < 1.0, f1 * 2.0 / (1.0 + f1), f1)

    lobe = torch.where(is_reflect, f, 1.0 - f)
    pdf = lobe * d / (4.0 * _safe(h_dot_o))
    wi_local = to_local(-wi, t, b, n)
    g = (_g1_ndf(au, av, wi_local, h_local, beck)
         * _g1_ndf(au, av, wo_local, h_local, beck))
    base = lobe * d * g / (4.0 * _safe(n_dot_o))
    spec = _tex_or_white(_ktex(tex, tables, "specular"),
                         take_rows(tables.specular_tid, bid), uv)
    tran = _tex_or_white(_ktex(tex, tables, "transmit"),
                         take_rows(tables.transmit_tid, bid), uv)
    atten = base[..., None] * _where3(is_reflect, spec, tran)
    valid = (pdf >= EPSILON) & (torch.abs(n_dot_o_raw) >= EPSILON_FLOAT)
    return pdf, atten, valid


def _plastic_lobe_weights(tables, tex, bid, uv):
    kd = textures.eval_color(_ktex(tex, tables, "diffuse"),
                             take_rows(tables.diffuse_tid, bid), uv)
    ks = _tex_or_white(_ktex(tex, tables, "specular"),
                       take_rows(tables.specular_tid, bid), uv)
    w_spec = channel_sum(ks) / _safe(channel_sum(kd) + channel_sum(ks))
    return kd, ks, w_spec


def _plastic_atten(kd, ks, f, d, g, n_dot_i, n_dot_o, kr_i, kr_o, f_avg,
                   pdf_spec, pdf_diff):
    """Specular and Fresnel-weighted Lambert terms of the plastic lobe,
    each kept where its pdf exceeds EPSILON (plastic.cpp)."""
    spec_term = (f * d * g / (4.0 * _safe(n_dot_o)))[..., None] * ks
    diff_term = kd * (INV_PI * n_dot_i)[..., None]
    diff_term = diff_term * (
        (1.0 - kr_i) * (1.0 - kr_o) / _safe(1.0 - f_avg))[..., None]
    zero = torch.zeros_like(spec_term)
    return (_where3(pdf_spec > EPSILON, spec_term, zero)
            + _where3(pdf_diff > EPSILON, diff_term, zero))


def _sample_plastic(tables, tex, bid, uv, wo, n, t, b, xi):
    """Clear-coat GGX over a Fresnel-weighted Lambert base (csrt
    plastic.cpp:12-98)."""
    kd, ks, w_spec = _plastic_lobe_weights(tables, tex, bid, uv)
    refl = take_rows(tables.reflectivity, bid)
    f_avg = take_rows(tables.f_avg, bid)
    alpha = _alpha(tables, tex, "roughness_tid", bid, uv)

    n_dot_o = dot(wo, n)
    kr_o = fresnel_schlick(n_dot_o, refl)
    p_spec0 = kr_o * w_spec
    p_diff0 = (1.0 - kr_o) * (1.0 - w_spec)
    p_spec0 = p_spec0 / _safe(p_spec0 + p_diff0)
    choose_spec = xi[0] < p_spec0

    # specular branch: a GGX half-vector; diffuse branch: cosine hemisphere
    h_local_s, d_s = sample_ggx(xi[1], xi[2], alpha, alpha)
    h_s = to_world(h_local_s, t, b, n)
    wi_s = -reflect(-wo, h_s)
    wi_local_d, pdf_d_local = sample_hemisphere_cosine(xi[1], xi[2])
    wi_d = -to_world(wi_local_d, t, b, n)

    wi = _where3(choose_spec, wi_s, wi_d)
    n_dot_i = dot(-wi, n)

    # lobe probabilities again from the actual wi; both branches use
    # (1-kr_i)*weight_spec for the diffuse share (plastic.cpp:44-64)
    kr_i = fresnel_schlick(n_dot_i, refl)
    p_spec = kr_i * w_spec
    p_diff = (1.0 - kr_i) * w_spec
    p_spec = p_spec / _safe(p_spec + p_diff)
    p_diff = 1.0 - p_spec

    h_w = _where3(choose_spec, h_s, normalize(-wi + wo))
    h_local = to_local(h_w, t, b, n)
    d = torch.where(choose_spec, d_s, pdf_ggx(alpha, alpha, h_local))
    h_dot_o = dot(wo, h_w)
    pdf_spec = p_spec * d / (4.0 * _safe(h_dot_o))
    pdf_diff = p_diff * torch.where(choose_spec, torch.clamp(n_dot_i, min=0.0),
                                    pdf_d_local)
    pdf = pdf_spec + pdf_diff

    wi_local = to_local(-wi, t, b, n)
    wo_local = to_local(wo, t, b, n)
    h_dot_i = dot(-wi, h_w)
    f = fresnel_schlick(h_dot_i, refl)
    g = (smith_g1(alpha, alpha, wi_local, h_local)
         * smith_g1(alpha, alpha, wo_local, h_local))
    atten = _plastic_atten(kd, ks, f, d, g, n_dot_i, n_dot_o, kr_i, kr_o,
                           f_avg, pdf_spec, pdf_diff)
    valid = (pdf >= EPSILON) & (n_dot_i >= EPSILON_FLOAT)
    return wi, pdf, atten, valid


def _eval_plastic(tables, tex, bid, uv, wi, wo, n, t, b):
    """csrt plastic.cpp:100-168."""
    kd, ks, w_spec = _plastic_lobe_weights(tables, tex, bid, uv)
    refl = take_rows(tables.reflectivity, bid)
    f_avg = take_rows(tables.f_avg, bid)
    alpha = _alpha(tables, tex, "roughness_tid", bid, uv)

    n_dot_o = dot(wo, n)
    n_dot_i = dot(-wi, n)
    kr_i = fresnel_schlick(n_dot_i, refl)
    p_spec = kr_i * w_spec
    p_diff = (1.0 - kr_i) * (1.0 - w_spec)
    p_spec = p_spec / _safe(p_spec + p_diff)
    p_diff = 1.0 - p_spec

    h = normalize(-wi + wo)
    h_local = to_local(h, t, b, n)
    d = pdf_ggx(alpha, alpha, h_local)
    h_dot_o = dot(wo, h)
    pdf_spec = p_spec * d / (4.0 * _safe(h_dot_o))
    wo_local = to_local(wo, t, b, n)
    pdf_diff = p_diff * wo_local[..., 2]
    pdf = pdf_spec + pdf_diff

    wi_local = to_local(-wi, t, b, n)
    h_dot_i = dot(-wi, h)
    f = fresnel_schlick(h_dot_i, refl)
    g = (smith_g1(alpha, alpha, wo_local, h_local)
         * smith_g1(alpha, alpha, wi_local, h_local))
    kr_o = fresnel_schlick(n_dot_o, refl)
    atten = _plastic_atten(kd, ks, f, d, g, n_dot_i, n_dot_o, kr_i, kr_o,
                           f_avg, pdf_spec, pdf_diff)
    valid = (n_dot_o >= EPSILON_FLOAT) & (pdf >= EPSILON)
    return pdf, atten, valid


def _coat_alpha(tables, tex, bid, uv):
    return _alpha(tables, tex, "coat_roughness_tid", bid, uv)


def _eval_clearcoat(tables, tex, kc, bid, uv, wi, wo, n, t, b):
    """Clear-coated conductor: the nested conductor and a dielectric-coat
    GGX lobe, mixed by weight = clear_coat * F_coat (archive
    clear_coated_conductor.cpp:115-160, Eval)."""
    pdf_n, atten_n, _ = _eval_conductor(tables, tex, kc, bid, uv, wi, wo,
                                        n, t, b)
    h = normalize(-wi + wo)
    h_local = to_local(h, t, b, n)
    cos_o = dot(wo, n)
    cos_i = dot(-wi, n)
    clear = take_rows(tables.clear_coat, bid)
    f_coat = fresnel_dielectric(torch.abs(dot(-wi, h)), 1.0 / 1.5)
    w_coat = clear * f_coat
    a_coat = _coat_alpha(tables, tex, bid, uv)
    d_coat = pdf_ggx(a_coat, a_coat, h_local)
    pdf_coat = d_coat / (4.0 * _safe(torch.abs(dot(wo, h))))
    wi_local = to_local(-wi, t, b, n)
    wo_local = to_local(wo, t, b, n)
    g_coat = (smith_g1(a_coat, a_coat, wi_local, h_local)
              * smith_g1(a_coat, a_coat, wo_local, h_local))
    atten_coat = (f_coat * d_coat * g_coat
                  / (4.0 * _safe(torch.abs(cos_i * cos_o))) * cos_i)
    pdf = pdf_n * (1.0 - w_coat) + w_coat * pdf_coat
    atten = (atten_n * (1.0 - w_coat)[..., None]
             + (clear * atten_coat)[..., None])
    valid = (cos_o >= EPSILON_FLOAT) & (pdf >= EPSILON)
    return pdf, atten, valid


def _sample_clearcoat(tables, tex, kc, bid, uv, wo, n, t, b, xi):
    """Sample the coat's reflection with probability clear_coat *
    F(cos_o), else the nested conductor; pdf and attenuation of the
    combined Eval (clear_coated_conductor.cpp:29-112)."""
    cos_o = dot(wo, n)
    clear = take_rows(tables.clear_coat, bid)
    w_sel = clear * fresnel_dielectric(torch.abs(cos_o), 1.0 / 1.5)
    choose_coat = xi[2] < w_sel

    a_coat = _coat_alpha(tables, tex, bid, uv)
    h_local_c, _ = sample_ggx(xi[0], xi[1], a_coat, a_coat)
    h_c = to_world(h_local_c, t, b, n)
    wi_c = -reflect(-wo, h_c)
    wi_n = _sample_conductor(tables, tex, kc, bid, uv, wo, n, t, b, xi)[0]

    wi = _where3(choose_coat, wi_c, wi_n)
    pdf, atten, valid = _eval_clearcoat(tables, tex, kc, bid, uv, wi, wo,
                                        n, t, b)
    return wi, pdf, atten, valid & (dot(-wi, n) >= EPSILON_FLOAT)


# ---------------------------------------------------------------------------
# Wavefront dispatch


def _no_kc(device):
    res = LUT_RESOLUTION
    return (torch.zeros((res, res), device=device),
            torch.zeros((res,), device=device))


def bsdf_sample(tables: BsdfTables, tex, present_types, bid, wo, normal,
                tangent, bitangent, inside, uv, xi, kc=None):
    """Sample a continuation direction for every lane.

    bid: [N] BSDF row per lane; bid < 0 (null boundary) passes straight
    through: wi = wo, pdf = 1, attenuation = 1.  wo: [N, 3] toward the
    viewer; xi: [N_SAMPLE_DRAWS, N] uniforms; kc: (brdf_avg [128, 128],
    albedo_avg [128]), the Kulla-Conty tables (zeros if None).
    Returns (wi [N,3], pdf [N], attenuation [N,3], valid [N])."""
    null = bid < 0
    bid = torch.clamp(bid, min=0)
    n, inside = orient_frame(normal, tangent, bitangent, inside, wo)
    t, b = tangent, bitangent
    btype = take_rows(tables.btype, bid)
    if kc is None:
        kc = _no_kc(wo.device)

    out = [-wo, torch.ones_like(wo[..., 0]), torch.ones_like(wo),
           torch.zeros_like(null)]

    def merge(family, res):
        m = btype == family
        wi_, pdf_, atten_, valid_ = res
        out[0] = _where3(m, wi_, out[0])
        out[1] = torch.where(m, pdf_, out[1])
        out[2] = _where3(m, atten_, out[2])
        out[3] = torch.where(m, valid_, out[3])

    if BsdfType.DIFFUSE in present_types:
        merge(BsdfType.DIFFUSE, _sample_diffuse(
            _ktex(tex, tables, "diffuse"), take_rows(tables.diffuse_tid, bid),
            uv, n, t, b, xi))
    if BsdfType.ROUGH_DIFFUSE in present_types:
        wi_local, p_ = sample_hemisphere_cosine(xi[0], xi[1])
        w_ = -to_world(wi_local, t, b, n)
        a_ = _eval_rough_diffuse_atten(tables, tex, bid, uv, n, t, b, w_, wo)
        merge(BsdfType.ROUGH_DIFFUSE, (w_, p_, a_, p_ >= EPSILON))
    if BsdfType.CONDUCTOR in present_types:
        merge(BsdfType.CONDUCTOR, _sample_conductor(
            tables, tex, kc, bid, uv, wo, n, t, b, xi))
    if BsdfType.DIELECTRIC in present_types:
        merge(BsdfType.DIELECTRIC, _sample_dielectric(
            tables, tex, kc, bid, uv, wo, n, t, b, inside, xi))
    if BsdfType.THIN_DIELECTRIC in present_types:
        merge(BsdfType.THIN_DIELECTRIC, _sample_thin_dielectric(
            tables, tex, bid, uv, wo, n, t, b, xi))
    if BsdfType.PLASTIC in present_types:
        merge(BsdfType.PLASTIC, _sample_plastic(
            tables, tex, bid, uv, wo, n, t, b, xi))
    if BsdfType.CLEARCOAT_CONDUCTOR in present_types:
        merge(BsdfType.CLEARCOAT_CONDUCTOR, _sample_clearcoat(
            tables, tex, kc, bid, uv, wo, n, t, b, xi))

    wi, pdf, atten, valid = out
    wi = _where3(null, wo, wi)
    pdf = torch.where(null, torch.ones_like(pdf), pdf)
    atten = _where3(null, torch.ones_like(atten), atten)
    return wi, pdf, atten, valid | null


def bsdf_evaluate(tables: BsdfTables, tex, present_types, bid, wi, wo,
                  normal, tangent, bitangent, inside, uv, kc=None):
    """f * cos and the sampling pdf of `wi` for every lane (NEE MIS, csrt
    EvaluateRayPath path.cpp:238-266).  Null-boundary lanes evaluate
    invalid, as in the reference.  Returns (pdf [N], attenuation [N,3],
    valid [N])."""
    null = bid < 0
    bid = torch.clamp(bid, min=0)
    n, inside = orient_frame(normal, tangent, bitangent, inside, -wi)
    t, b = tangent, bitangent
    btype = take_rows(tables.btype, bid)
    if kc is None:
        kc = _no_kc(wo.device)

    out = [torch.ones_like(wo[..., 0]), torch.ones_like(wo),
           torch.zeros_like(null)]

    def merge(family, res):
        m = btype == family
        pdf_, atten_, valid_ = res
        out[0] = torch.where(m, pdf_, out[0])
        out[1] = _where3(m, atten_, out[1])
        out[2] = torch.where(m, valid_, out[2])

    if BsdfType.DIFFUSE in present_types:
        merge(BsdfType.DIFFUSE, _eval_diffuse(
            _ktex(tex, tables, "diffuse"), take_rows(tables.diffuse_tid, bid),
            uv, n, wi, wo))
    if BsdfType.ROUGH_DIFFUSE in present_types:
        cos_i = dot(-wi, n)
        cos_o = dot(wo, n)
        p_ = INV_PI * torch.clamp(cos_i, min=0.0)
        a_ = _eval_rough_diffuse_atten(tables, tex, bid, uv, n, t, b, wi, wo)
        merge(BsdfType.ROUGH_DIFFUSE,
              (p_, a_, (cos_i >= EPSILON) & (cos_o >= EPSILON)))
    if BsdfType.CONDUCTOR in present_types:
        merge(BsdfType.CONDUCTOR, _eval_conductor(
            tables, tex, kc, bid, uv, wi, wo, n, t, b))
    if BsdfType.DIELECTRIC in present_types:
        merge(BsdfType.DIELECTRIC, _eval_dielectric(
            tables, tex, kc, bid, uv, wi, wo, n, t, b, inside))
    if BsdfType.THIN_DIELECTRIC in present_types:
        merge(BsdfType.THIN_DIELECTRIC, _eval_thin_dielectric(
            tables, tex, bid, uv, wi, wo, n, t, b))
    if BsdfType.PLASTIC in present_types:
        merge(BsdfType.PLASTIC, _eval_plastic(
            tables, tex, bid, uv, wi, wo, n, t, b))
    if BsdfType.CLEARCOAT_CONDUCTOR in present_types:
        merge(BsdfType.CLEARCOAT_CONDUCTOR, _eval_clearcoat(
            tables, tex, kc, bid, uv, wi, wo, n, t, b))

    pdf, atten, valid = out
    return pdf, atten, valid & ~null


def get_radiance(tables: BsdfTables, tex, bid, uv):
    """Area-light emitted radiance (csrt bsdf.cpp:255-265)."""
    bid = torch.clamp(bid, min=0)
    is_light = take_rows(tables.btype, bid) == BsdfType.AREA_LIGHT
    rad = textures.eval_color(
        _ktex(tex, tables, "radiance"),
        torch.clamp(take_rows(tables.radiance_tid, bid), min=0), uv)
    return _where3(is_light, rad, torch.zeros_like(rad))


def is_emitter(tables: BsdfTables, bid):
    return take_rows(tables.btype, torch.clamp(bid, min=0)) == BsdfType.AREA_LIGHT


def is_twosided(tables: BsdfTables, bid):
    return take_rows(tables.twosided, torch.clamp(bid, min=0))


def is_connectible(tables: BsdfTables, tex, bid, uv, min_alpha: float = 0.05):
    """Whether an area-measure BDPT connection at this vertex is a usable
    estimator (the reference's is_connectible): diffuse-dominated lobes
    always, microfacet lobes only when their larger alpha is at least
    `min_alpha` — a connection through a near-smooth lobe fires with
    probability ~alpha^2 at ~1/alpha^2 magnitude."""
    bid = torch.clamp(bid, min=0)
    t = take_rows(tables.btype, bid)
    diffuseish = ((t == BsdfType.DIFFUSE) | (t == BsdfType.ROUGH_DIFFUSE)
                  | (t == BsdfType.PLASTIC))
    au = _scalar_tex(_ktex(tex, tables, "roughness_u"),
                     take_rows(tables.roughness_u_tid, bid), uv, 0.0)
    av = _scalar_tex(_ktex(tex, tables, "roughness_v"),
                     take_rows(tables.roughness_v_tid, bid), uv, 0.0)
    return diffuseish | (torch.maximum(au, av) >= min_alpha)
