"""Scene commit: lower the RendererConfig IR to device tables
(counterpart of mcpt_tpu/scene/compile.py::compile_scene, :182): the
triangle geometry and the analytic quadrics (sphere, disk, cylinder),
every BSDF family with every texture kind, the Kulla-Conty tables where
a conductor or a dielectric needs them, the emissive-triangle table for
NEE, the analytic emitters and the escape emitter (an envmap with its
alias table, or a constant sky), the participating media and each
instance's interior and exterior medium; null-boundary (medium shell)
instances become rows that never block shadow rays.

NEE samples one global CDF over emissive triangles with
P(tri) = (w_L / sum_w) * (area_tri / area_L), so pdf_area = P(light) /
area_light — the reference's identity (csrt path.cpp:225-228); an
emissive quadric owns one cell of that CDF.

BDPT's connections weigh against a uniform density over the surfaces of
the non-emitting instances (map_inst_area_pdf).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.models import kulla_conty
from mcpt_tpu_torch.models.bsdf import BsdfTables, build_bsdf_tables
from mcpt_tpu_torch.models.emitter import (
    EmitterTables,
    EnvMapData,
    build_emitter_tables,
    build_envmap,
    empty_envmap,
)
from mcpt_tpu_torch.models.medium import MediumTables, build_medium_tables
from mcpt_tpu_torch.models.texture import TEX_NONE, TextureTables
from mcpt_tpu_torch.ops.march_sweep import super_boxes
from mcpt_tpu_torch.ops.quadric import (
    KIND_CYLINDER,
    KIND_DISK,
    KIND_SPHERE,
    QuadricTables,
    build_quadric_tables,
)
from mcpt_tpu_torch.scene.geometry import Geometry, commit_geometry
from mcpt_tpu_torch.scene.ir import BsdfType, EmitterType, RendererConfig
from mcpt_tpu_torch.scene.shapes import instance_triangles, triangle_areas

#: analytic primitives get their own table; everything else tessellates
QUADRIC_SHAPES = ("sphere", "disk", "cylinder")


class EmissiveTris(NamedTuple):
    """Flat emissive-triangle table for NEE (one row per light triangle;
    an emissive quadric's cell keeps zero geometry)."""

    p0: torch.Tensor        # [E, 3]
    e1: torch.Tensor        # [E, 3]
    e2: torch.Tensor        # [E, 3]
    n0: torch.Tensor        # [E, 3] shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor       # [E, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    cdf: torch.Tensor       # [E + 1] global selection CDF
    pdf_area: torch.Tensor  # [E] P(light) / area_light of this tri's light
    bsdf_id: torch.Tensor   # [E] int32 area-light BSDF row


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Everything the integrator reads on the device (csrt
    IntegratorData, integrator.hpp:29-69), for the port's slices."""

    geom: Geometry
    tex: TextureTables
    bsdf: BsdfTables
    map_inst_bsdf: torch.Tensor       # [I] int32 (-1 = none)
    map_inst_light_pdf: torch.Tensor  # [I] f32 P(light)/area, 0 if no light
    #: [I] f32 1 / (area x non-emitter instances) of every non-light
    #: instance, 0 for lights: BDPT's connection density
    map_inst_area_pdf: torch.Tensor
    em: EmissiveTris
    emitters: EmitterTables           # analytic lights, one row each
    env: EnvMapData                   # the envmap (a placeholder if none)
    media: MediumTables               # participating media, one row each
    map_inst_medium_int: torch.Tensor  # [I] int32 (-1 = vacuum)
    map_inst_medium_ext: torch.Tensor  # [I] int32
    quad: QuadricTables               # sphere / disk / cylinder rows
    #: Kulla-Conty E(mu, alpha) [128, 128] and E_avg(alpha) [128]: the
    #: tables where a conductor or a dielectric is present, else zeros
    brdf_avg: torch.Tensor
    albedo_avg: torch.Tensor
    n_emissive: int                   # emissive CDF cells
    present_types: tuple              # BsdfType codes in the scene
    #: ((row, etype), ...) of the delta lights, in emitter order
    emitter_rows: tuple = ()
    #: the escape emitter: "none", "envmap" or "constant", and its row
    env_kind: str = "none"
    env_row: int = -1
    sun_row: int = -1                 # the sun whose bitmap escapes see
    has_bump: bool = False            # some BSDF has a bump map
    has_opacity: bool = False         # some BSDF has an opacity map
    #: ((kind, opaque), ...) per quadric row; () = no quadrics
    quad_kinds: tuple = ()
    #: ((cdf cell, quadric row, kind), ...) of the emissive quadrics
    em_quad_cells: tuple = ()
    all_opaque: bool = True           # every real prim blocks shadow rays
    #: texture kinds the BSDF tables reach (the envmap's, the sun's and a
    #: spot's bitmaps stay out of surface shading)
    surface_kinds: tuple = (1, 2, 3)


def _quadric_row(info):
    """An analytic instance as a quadric row (local frames per
    ops/quadric.py).  Returns (row, kind, world area); the area is exact
    for rotation and uniform scale, and under non-uniform scale as
    approximate as the local-uniform sampler (the reference's choice)."""
    m = np.asarray(info.to_world, np.float64)
    if info.shape == "sphere":
        f = np.eye(4)
        f[:3, 3] = np.asarray(info.center, np.float64)
        kind = KIND_SPHERE
        params = (float(info.radius), 0.0)
        tw = m @ f
        s = np.abs(np.linalg.det(tw[:3, :3])) ** (1.0 / 3.0)
        area = 4.0 * np.pi * (info.radius * s) ** 2
    elif info.shape == "disk":
        kind = KIND_DISK
        params = (0.5, 0.0)
        tw = m
        # a disk's affine image is an ellipse: the in-plane columns' cross
        j = np.linalg.norm(np.cross(tw[:3, 0], tw[:3, 1]))
        area = np.pi * 0.25 * j
    else:  # cylinder: p0/p1 framed into local z in [0, length]
        p0 = np.asarray(info.p0, np.float64)
        p1 = np.asarray(info.p1, np.float64)
        axis = p1 - p0
        length = float(np.linalg.norm(axis))
        axis = axis / max(length, 1e-12)
        helper = (np.array([0.0, 1.0, 0.0]) if abs(axis[0]) > 0.9
                  else np.array([1.0, 0.0, 0.0]))
        t = np.cross(helper, axis)
        t /= np.linalg.norm(t)
        b = np.cross(axis, t)
        f = np.eye(4)
        f[:3, 0], f[:3, 1], f[:3, 2], f[:3, 3] = t, b, axis, p0
        kind = KIND_CYLINDER
        params = (float(info.radius), length)
        tw = m @ f
        s_axis = np.linalg.norm(tw[:3, 2])
        s_perp = np.sqrt(np.linalg.norm(tw[:3, 0]) * np.linalg.norm(tw[:3, 1]))
        area = 2.0 * np.pi * info.radius * length * s_axis * s_perp
    row = dict(kind=kind, to_world=tw.astype(np.float32), params=params,
               inst_id=-1, flip=info.flip_normals)
    return row, kind, max(float(area), 1e-20)


def _escape_emitters(config: RendererConfig, device):
    """The emitter commit (csrt CommitEmitters, renderer.cpp:522-620):
    (emitter_rows, env_kind, env_row, sun_row, env)."""
    emitter_rows = []
    env_kind, env_row, sun_row = "none", -1, -1
    env = None
    for row, info in enumerate(config.emitters):
        if info.etype == EmitterType.ENVMAP:
            pixels = config.textures.bitmap_pixels(info.id_texture)
            if pixels.shape[-1] == 1:
                pixels = np.repeat(pixels, 3, axis=-1)
            env = build_envmap(pixels, info.to_world, info.id_texture, device)
            env_kind, env_row = "envmap", row
        elif info.etype == EmitterType.CONSTANT:
            env_kind, env_row = "constant", row
        else:
            emitter_rows.append((row, int(info.etype)))
            if info.etype == EmitterType.SUN:
                sun_row = row
    return (tuple(emitter_rows), env_kind, env_row, sun_row,
            env if env is not None else empty_envmap(device))


def compile_scene(config: RendererConfig, device="cuda") -> SceneData:
    device = torch.device(device)
    tex_infos = config.textures.infos
    bsdf = build_bsdf_tables(config.bsdfs, device, tex_infos)

    # --- geometry: mesh-like instances -> world-space triangle soup;
    # sphere / disk / cylinder -> quadric rows
    all_pos, all_nrm, all_uv, all_tan, all_inst = [], [], [], [], []
    inst_tri_ranges = []
    quad_rows, quad_kinds = [], []
    inst_quad_row = {}  # inst_id -> quadric row
    quad_area = {}      # inst_id -> world-space area
    cursor = 0
    for inst_id, info in enumerate(config.instances):
        if info.shape in QUADRIC_SHAPES:
            row, kind, area = _quadric_row(info)
            row["inst_id"] = inst_id
            inst_quad_row[inst_id] = len(quad_rows)
            quad_area[inst_id] = area
            quad_rows.append(row)
            quad_kinds.append((kind, info.id_bsdf >= 0))
            inst_tri_ranges.append((cursor, cursor))
            continue
        pos, nrm, uv, tan = instance_triangles(info)
        f = pos.shape[0]
        all_pos.append(pos)
        all_nrm.append(nrm if nrm is not None else _geometric_normals(pos))
        if uv is None:
            uv = np.zeros((f, 3, 2), np.float32)
            uv[:, 1, 0] = 1.0
            uv[:, 2, 1] = 1.0
        all_uv.append(uv)
        all_tan.append(tan)
        all_inst.append(np.full(f, inst_id, np.int32))
        inst_tri_ranges.append((cursor, cursor + f))
        cursor += f
    if cursor == 0:
        # an all-quadric scene: the triangle structures want a row, a
        # degenerate sliver at the origin that nothing hits
        all_pos.append(np.zeros((1, 3, 3), np.float32))
        all_nrm.append(np.broadcast_to(np.array([0, 0, 1], np.float32),
                                       (1, 3, 3)).copy())
        all_uv.append(np.zeros((1, 3, 2), np.float32))
        all_tan.append(None)
        all_inst.append(np.full(1, -1, np.int32))

    tri_pos = np.concatenate(all_pos, axis=0)
    tri_nrm = np.concatenate(all_nrm, axis=0)
    tri_uv = np.concatenate(all_uv, axis=0)
    tri_tan = (
        np.concatenate([t if t is not None else np.zeros_like(p)
                        for t, p in zip(all_tan, all_pos)], axis=0)
        if any(t is not None for t in all_tan) else None
    )
    tri_inst = np.concatenate(all_inst, axis=0)
    inst_bsdf_arr = np.array(
        [i.id_bsdf for i in config.instances] or [0], np.int32)
    tri_opaque = ((inst_bsdf_arr[np.maximum(tri_inst, 0)] >= 0)
                  & (tri_inst >= 0))

    geom = commit_geometry(tri_pos, tri_nrm, tri_uv, tri_tan, tri_inst,
                           device, tri_opaque=tri_opaque)

    # --- instance -> bsdf map (csrt instance.hpp:40-51 binding)
    n_inst = len(config.instances)
    map_inst_bsdf = np.array([i.id_bsdf for i in config.instances], np.int32)
    map_med_int = np.array(
        [i.id_medium_int for i in config.instances] or [-1], np.int32)
    map_med_ext = np.array(
        [i.id_medium_ext for i in config.instances] or [-1], np.int32)

    # --- area lights: weight CDF over lights x area CDF within a light
    # (csrt renderer.cpp:272-304)
    lights = []  # (inst_id, weight, bsdf_id)
    for inst_id, info in enumerate(config.instances):
        if 0 <= info.id_bsdf < len(config.bsdfs):
            bi = config.bsdfs[info.id_bsdf]
            if bi.btype == BsdfType.AREA_LIGHT:
                lights.append((inst_id, bi.weight, info.id_bsdf))

    def inst_area(inst_id):
        if inst_id in quad_area:
            return quad_area[inst_id]
        lo, hi = inst_tri_ranges[inst_id]
        return max(float(triangle_areas(tri_pos[lo:hi]).sum()), 1e-20)

    sum_w = sum(w for _, w, _ in lights) or 1.0
    map_inst_light_pdf = np.zeros(max(n_inst, 1), np.float32)
    # BDPT's uniform-surface density (mcpt_tpu/scene/compile.py:280-292)
    light_ids = {i for i, _, _ in lights}
    n_non_emitter = max(n_inst - len(lights), 1)
    map_inst_area_pdf = np.zeros(max(n_inst, 1), np.float32)
    for inst_id in range(n_inst):
        if inst_id not in light_ids:
            map_inst_area_pdf[inst_id] = 1.0 / (inst_area(inst_id)
                                                * n_non_emitter)
    em_rows = []  # (tri or None, P(cell), pdf_area, bsdf_id)
    em_quad_cells = []
    for inst_id, weight, bsdf_id in lights:
        area_l = inst_area(inst_id)
        p_light = weight / sum_w
        map_inst_light_pdf[inst_id] = p_light / area_l
        if inst_id in quad_area:
            # one CDF cell for the whole shape; _sample_area_light routes
            # it to sample_quadric_row
            row = inst_quad_row[inst_id]
            em_quad_cells.append((len(em_rows), row, quad_rows[row]["kind"]))
            em_rows.append((None, p_light, p_light / area_l, bsdf_id))
            continue
        lo, hi = inst_tri_ranges[inst_id]
        areas = triangle_areas(tri_pos[lo:hi])
        for k in range(lo, hi):
            em_rows.append(
                (k, p_light * areas[k - lo] / area_l, p_light / area_l, bsdf_id)
            )

    e = max(len(em_rows), 1)
    em_p = np.zeros((e, 3, 3), np.float32)
    em_n = np.zeros((e, 3, 3), np.float32)
    em_uv = np.zeros((e, 3, 2), np.float32)
    em_prob = np.zeros(e, np.float32)
    em_pdfa = np.zeros(e, np.float32)
    em_bsdf = np.zeros(e, np.int32)
    for row, (k, prob, pdfa, bsdf_id) in enumerate(em_rows):
        if k is not None:
            em_p[row] = tri_pos[k]
            em_n[row] = tri_nrm[k]
            em_uv[row] = tri_uv[k]
        em_prob[row] = prob
        em_pdfa[row] = pdfa
        em_bsdf[row] = bsdf_id
    cdf = np.zeros(e + 1, np.float32)
    np.cumsum(em_prob, out=cdf[1:])
    if em_rows:
        cdf /= max(cdf[-1], 1e-20)  # weights already normalized; guard fp

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    em = EmissiveTris(
        p0=dev(em_p[:, 0]),
        e1=dev(em_p[:, 1] - em_p[:, 0]),
        e2=dev(em_p[:, 2] - em_p[:, 0]),
        n0=dev(em_n[:, 0]), n1=dev(em_n[:, 1]), n2=dev(em_n[:, 2]),
        uv0=dev(em_uv[:, 0]), uv1=dev(em_uv[:, 1]), uv2=dev(em_uv[:, 2]),
        cdf=dev(cdf),
        pdf_area=dev(em_pdfa),
        bsdf_id=dev(em_bsdf),
    )
    emitter_rows, env_kind, env_row, sun_row, env = _escape_emitters(
        config, device)
    # --- Kulla-Conty tables (mcpt_tpu/scene/compile.py:396-403)
    if any(b.btype in (BsdfType.CONDUCTOR, BsdfType.DIELECTRIC)
           for b in config.bsdfs):
        brdf_avg, albedo_avg = kulla_conty.get_tables(device)
    else:
        res = kulla_conty.LUT_RESOLUTION
        brdf_avg = torch.zeros((res, res), device=device)
        albedo_avg = torch.zeros((res,), device=device)
    return SceneData(
        geom=geom,
        tex=config.textures.build(device),
        bsdf=bsdf,
        map_inst_bsdf=dev(map_inst_bsdf if n_inst else np.zeros(1, np.int32)),
        map_inst_light_pdf=dev(map_inst_light_pdf),
        map_inst_area_pdf=dev(map_inst_area_pdf),
        em=em,
        emitters=build_emitter_tables(config.emitters, device),
        env=env,
        media=build_medium_tables(config.media, device),
        map_inst_medium_int=dev(map_med_int),
        map_inst_medium_ext=dev(map_med_ext),
        quad=build_quadric_tables(quad_rows, device),
        brdf_avg=brdf_avg,
        albedo_avg=albedo_avg,
        n_emissive=len(em_rows),
        present_types=tuple(sorted({int(b.btype) for b in config.bsdfs})),
        emitter_rows=emitter_rows,
        env_kind=env_kind,
        env_row=env_row,
        sun_row=sun_row,
        has_bump=any(b.id_bump_map >= 0 for b in config.bsdfs),
        has_opacity=any(b.id_opacity >= 0 for b in config.bsdfs),
        quad_kinds=tuple(quad_kinds),
        em_quad_cells=tuple(em_quad_cells),
        all_opaque=(bool(np.all(tri_opaque))
                    and all(op for _, op in quad_kinds)),
        surface_kinds=_surface_kinds(bsdf.col_kinds),
    )


def _surface_kinds(col_kinds) -> tuple:
    """Texture kinds reachable from surface shading: those of every
    parameter column of the BSDF tables."""
    return tuple(sorted({k for _, kinds in col_kinds for k in kinds}))


def _geometric_normals(pos: np.ndarray) -> np.ndarray:
    gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    return np.repeat(gn[:, None, :], 3, axis=1)


def scene_from_arrays(arrays: dict, device="cuda", quad_kinds=(),
                      em_quad_cells=()) -> SceneData:
    """SceneData from another SceneData's leaves, handed over as numpy
    arrays under their dotted field names ("geom.p0", "em.cdf",
    "map_inst_bsdf", "media.sigma_t", ...) — how the tests carry the
    reference's compiled scene across.  Keys the port does not use are
    ignored; `geom.packed_tris` may come in the reference's
    [leaves, leaf, 12] layout, and the geometry fields the reference does not have follow
    from those it has: march_prim from march_tris' prim-id channel, the
    scene bounds from the BVH root (geom.node_min[0], geom.node_max[0]),
    the super-chunk unions from the chunk boxes.
    The static facts follow from the tables: emissive cells have a
    positive pdf_area, the present BSDF types are those of the table's
    rows, opacity and bump maps are the rows' opacity_tid and bump_tid,
    the texture kinds are those of the textures the tables name, the
    emitter rows come by their etype, the envmap's size from its bitmap
    halved as build_envmap halves it, and the real prims — the first
    ones of the sorted order, the march pack's — are opaque or not by
    geom.opaque.  The quadric rows' kinds are not in the tables: they
    come as `quad_kinds` and `em_quad_cells`."""
    device = torch.device(device)
    arrays = dict(arrays)
    if "geom.march_prim" not in arrays:
        arrays["geom.march_prim"] = np.asarray(
            arrays["geom.march_tris"])[..., 10].astype(np.int32)
    for f, node in (("bounds_min", "node_min"), ("bounds_max", "node_max")):
        if f"geom.{f}" not in arrays:
            arrays[f"geom.{f}"] = np.asarray(arrays[f"geom.{node}"])[0]

    def np_(name):
        return np.asarray(arrays[name])

    def get(name):
        return torch.as_tensor(np.array(arrays[name]), device=device)

    def group(cls, prefix, **given):
        return cls(**{f: given[f] if f in given else get(f"{prefix}.{f}")
                      for f in cls._fields if f in given
                      or f"{prefix}.{f}" in arrays})

    supers = super_boxes(get("geom.march_min"), get("geom.march_max"))
    geom = group(Geometry, "geom", march_super_min=supers[0],
                 march_super_max=supers[1])
    n_real = int(np_("geom.march_prim").max()) + 1

    ttype = np_("tex.ttype")
    col_kinds = tuple(
        (col, tuple(sorted({int(ttype[t]) for t in np_(f"bsdf.{col}_tid")
                            if 0 <= t < ttype.shape[0]} - {TEX_NONE})))
        for col in ("opacity", "bump", "radiance", "diffuse", "roughness",
                    "roughness_u", "roughness_v", "specular", "transmit",
                    "coat_roughness"))
    etype = np_("emitters.etype").tolist()
    emitter_rows = tuple((r, t) for r, t in enumerate(etype)
                         if t in (EmitterType.POINT, EmitterType.SPOT,
                                  EmitterType.DIRECTIONAL, EmitterType.SUN))
    env_kind, env_row, sun_row, env_shape = "none", -1, -1, (1, 1)
    for row, t in enumerate(etype):
        if t == EmitterType.ENVMAP:
            env_kind, env_row = "envmap", row
            tid = int(np_("env.tid"))
            env_shape = (int(np_("tex.bmp_width")[tid]),
                         int(np_("tex.bmp_height")[tid]))
            while env_shape[0] * env_shape[1] > np_("env.texel_tab").shape[0]:
                env_shape = (env_shape[0] // 2, env_shape[1] // 2)
        elif t == EmitterType.CONSTANT:
            env_kind, env_row = "constant", row
        elif t == EmitterType.SUN:
            sun_row = row
    return SceneData(
        geom=geom._replace(packed_tris=geom.packed_tris.reshape(-1, 12)),
        tex=group(TextureTables, "tex",
                  kinds=tuple(sorted(set(ttype.tolist()) - {TEX_NONE}))),
        bsdf=group(BsdfTables, "bsdf", col_kinds=col_kinds),
        map_inst_bsdf=get("map_inst_bsdf"),
        map_inst_light_pdf=get("map_inst_light_pdf"),
        map_inst_area_pdf=get("map_inst_area_pdf"),
        em=group(EmissiveTris, "em"),
        emitters=group(EmitterTables, "emitters"),
        env=group(EnvMapData, "env", width=env_shape[0],
                  height=env_shape[1]),
        media=group(MediumTables, "media"),
        map_inst_medium_int=get("map_inst_medium_int"),
        map_inst_medium_ext=get("map_inst_medium_ext"),
        quad=group(QuadricTables, "quad"),
        brdf_avg=get("brdf_avg"),
        albedo_avg=get("albedo_avg"),
        n_emissive=int((np_("em.pdf_area") > 0).sum()),
        present_types=tuple(sorted(set(np_("bsdf.btype").tolist()))),
        emitter_rows=emitter_rows,
        env_kind=env_kind,
        env_row=env_row,
        sun_row=sun_row,
        has_bump=bool((np_("bsdf.bump_tid") >= 0).any()),
        has_opacity=bool((np_("bsdf.opacity_tid") >= 0).any()),
        quad_kinds=tuple(quad_kinds),
        em_quad_cells=tuple(em_quad_cells),
        all_opaque=(bool(np_("geom.opaque")[:n_real].all())
                    and all(op for _, op in quad_kinds)),
        surface_kinds=_surface_kinds(col_kinds),
    )
