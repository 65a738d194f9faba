"""Scene commit: lower the RendererConfig IR to device tables
(counterpart of mcpt_tpu/scene/compile.py::compile_scene, :182) for
triangle scenes lit by area lights: the geometry, every BSDF family with
constant textures, the Kulla-Conty tables where a conductor or a
dielectric needs them, and the emissive-triangle table for NEE.

NEE samples one global CDF over emissive triangles with
P(tri) = (w_L / sum_w) * (area_tri / area_L), so pdf_area = P(light) /
area_light — the reference's identity (csrt path.cpp:225-228).

Everything outside the port's slices raises NotImplementedError naming
its ROADMAP item, rather than rendering something else.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.models import kulla_conty
from mcpt_tpu_torch.models.bsdf import BsdfTables, build_bsdf_tables
from mcpt_tpu_torch.models.texture import TextureTables
from mcpt_tpu_torch.ops.march_sweep import super_boxes
from mcpt_tpu_torch.scene.geometry import Geometry, commit_geometry
from mcpt_tpu_torch.scene.ir import BsdfType, RendererConfig
from mcpt_tpu_torch.scene.shapes import instance_triangles, triangle_areas


class EmissiveTris(NamedTuple):
    """Flat emissive-triangle table for NEE (one row per light triangle)."""

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
    em: EmissiveTris
    #: Kulla-Conty E(mu, alpha) [128, 128] and E_avg(alpha) [128]: the
    #: tables where a conductor or a dielectric is present, else zeros
    brdf_avg: torch.Tensor
    albedo_avg: torch.Tensor
    n_emissive: int                   # emissive triangles
    present_types: tuple              # BsdfType codes in the scene
    has_opacity: bool = False         # some BSDF has an opacity map
    all_opaque: bool = True           # every real prim blocks shadow rays


def _check_slice(config: RendererConfig):
    """Refuse what the port does not render yet."""
    if config.emitters:
        raise NotImplementedError(
            "analytic emitters and envmaps: ROADMAP item 14"
        )
    if config.media or any(
        i.id_medium_int >= 0 or i.id_medium_ext >= 0 for i in config.instances
    ):
        raise NotImplementedError("participating media: ROADMAP item 16")
    if config.integrator.itype != "path":
        raise NotImplementedError(
            f"integrator '{config.integrator.itype}': ROADMAP items 16-17"
        )
    for info in config.instances:
        if info.id_bsdf < 0:
            raise NotImplementedError(
                "null-boundary (medium shell) instances: ROADMAP item 16"
            )


def compile_scene(config: RendererConfig, device="cuda") -> SceneData:
    _check_slice(config)
    device = torch.device(device)
    bsdf = build_bsdf_tables(config.bsdfs, device)

    # --- geometry: every instance -> world-space triangle soup
    all_pos, all_nrm, all_uv, all_tan, all_inst = [], [], [], [], []
    inst_tri_ranges = []
    cursor = 0
    for inst_id, info in enumerate(config.instances):
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
        raise ValueError("scene has no triangles")

    tri_pos = np.concatenate(all_pos, axis=0)
    tri_nrm = np.concatenate(all_nrm, axis=0)
    tri_uv = np.concatenate(all_uv, axis=0)
    tri_tan = (
        np.concatenate([t if t is not None else np.zeros_like(p)
                        for t, p in zip(all_tan, all_pos)], axis=0)
        if any(t is not None for t in all_tan) else None
    )
    tri_inst = np.concatenate(all_inst, axis=0)
    tri_opaque = np.ones(tri_inst.shape[0], np.bool_)  # no null shells here

    geom = commit_geometry(tri_pos, tri_nrm, tri_uv, tri_tan, tri_inst,
                           device, tri_opaque=tri_opaque)

    # --- instance -> bsdf map (csrt instance.hpp:40-51 binding)
    n_inst = len(config.instances)
    map_inst_bsdf = np.array([i.id_bsdf for i in config.instances], np.int32)

    # --- area lights: weight CDF over lights x area CDF within a light
    # (csrt renderer.cpp:272-304)
    lights = []  # (inst_id, weight, bsdf_id)
    for inst_id, info in enumerate(config.instances):
        if 0 <= info.id_bsdf < len(config.bsdfs):
            bi = config.bsdfs[info.id_bsdf]
            if bi.btype == BsdfType.AREA_LIGHT:
                lights.append((inst_id, bi.weight, info.id_bsdf))

    sum_w = sum(w for _, w, _ in lights) or 1.0
    map_inst_light_pdf = np.zeros(n_inst, np.float32)
    em_rows = []  # (tri, P(tri), pdf_area, bsdf_id)
    for inst_id, weight, bsdf_id in lights:
        lo, hi = inst_tri_ranges[inst_id]
        areas = triangle_areas(tri_pos[lo:hi])
        area_l = max(float(areas.sum()), 1e-20)
        p_light = weight / sum_w
        map_inst_light_pdf[inst_id] = p_light / area_l
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
        map_inst_bsdf=dev(map_inst_bsdf),
        map_inst_light_pdf=dev(map_inst_light_pdf),
        em=em,
        brdf_avg=brdf_avg,
        albedo_avg=albedo_avg,
        n_emissive=len(em_rows),
        present_types=tuple(sorted({int(b.btype) for b in config.bsdfs})),
        has_opacity=any(b.id_opacity >= 0 for b in config.bsdfs),
        all_opaque=bool(tri_opaque.all()),
    )


def _geometric_normals(pos: np.ndarray) -> np.ndarray:
    gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    return np.repeat(gn[:, None, :], 3, axis=1)


def scene_from_arrays(arrays: dict, device="cuda") -> SceneData:
    """SceneData from another SceneData's leaves, handed over as numpy
    arrays under their dotted field names ("geom.p0", "em.cdf",
    "map_inst_bsdf", ...) — how the tests carry the reference's compiled
    scene across.  Keys the port does not use are ignored;
    `geom.packed_tris` may come in the reference's [leaves, leaf, 12]
    layout, and the geometry fields the reference does not have follow
    from those it has: march_prim from march_tris' prim-id channel, the
    scene bounds from the BVH root (geom.node_min[0], geom.node_max[0]),
    the super-chunk unions from the chunk boxes.
    The static facts follow from the tables: emissive rows have a
    positive pdf_area, the present BSDF types are those of the table's
    rows, opacity maps are the rows' opacity_tid, and the real prims —
    the first ones of the sorted order, the march pack's — are opaque or
    not by geom.opaque."""
    device = torch.device(device)
    arrays = dict(arrays)
    if "geom.march_prim" not in arrays:
        arrays["geom.march_prim"] = np.asarray(
            arrays["geom.march_tris"])[..., 10].astype(np.int32)
    for f, node in (("bounds_min", "node_min"), ("bounds_max", "node_max")):
        if f"geom.{f}" not in arrays:
            arrays[f"geom.{f}"] = np.asarray(arrays[f"geom.{node}"])[0]

    def get(name):
        return torch.as_tensor(np.array(arrays[name]), device=device)

    def group(cls, prefix, **given):
        return cls(**{f: given[f] if f in given else get(f"{prefix}.{f}")
                      for f in cls._fields})

    supers = super_boxes(get("geom.march_min"), get("geom.march_max"))
    geom = group(Geometry, "geom", march_super_min=supers[0],
                 march_super_max=supers[1])
    n_real = int(np.asarray(arrays["geom.march_prim"]).max()) + 1
    return SceneData(
        geom=geom._replace(packed_tris=geom.packed_tris.reshape(-1, 12)),
        tex=group(TextureTables, "tex"),
        bsdf=group(BsdfTables, "bsdf"),
        map_inst_bsdf=get("map_inst_bsdf"),
        map_inst_light_pdf=get("map_inst_light_pdf"),
        em=group(EmissiveTris, "em"),
        brdf_avg=get("brdf_avg"),
        albedo_avg=get("albedo_avg"),
        n_emissive=int((np.asarray(arrays["em.pdf_area"]) > 0).sum()),
        present_types=tuple(sorted(set(np.asarray(arrays["bsdf.btype"]).tolist()))),
        has_opacity=bool((np.asarray(arrays["bsdf.opacity_tid"]) >= 0).any()),
        all_opaque=bool(np.asarray(arrays["geom.opaque"])[:n_real].all()),
    )
