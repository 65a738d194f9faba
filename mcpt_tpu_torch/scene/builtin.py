"""Built-in scenes in the port's IR, made in code from plain numbers.

`cornell_box` is the main path's workload: the cornell-class scene that
bench.py times (512x512, 16 spp, depth 8), here with a red and a green
wall, two boxes and a rectangular area light.  `uv_sphere_mesh` is the
dense mesh that fills the dense sweep to its design size.  The two mesh
scenes go past DENSE_MAX_PRIMS, one down each large-scene route
(ops/traversal.py::resolved_strategy):

* `cornell_mesh_march` — the box and a 51,200-triangle sphere, a
  dragon-class scene: 256-triangle SAH chunks, the block march;
* `cornell_mesh_pairs` — the box and eight 13,122-triangle spheres
  (104,976 triangles), a classroom-class scene: the chunk size doubles
  to 128 to stay under 2048 chunks, and thin chunks take the pair route.

`cornell_mesh_materials` is `cornell_mesh_march` dressed in every BSDF
family, a material-preview scene: all-opaque, one area light, so it
takes the batched regen body.
"""

from __future__ import annotations

import numpy as np

from mcpt_tpu_torch.models.texture import TextureBuilder
from mcpt_tpu_torch.scene.ir import (
    BsdfInfo,
    BsdfType,
    CameraInfo,
    InstanceInfo,
    IntegratorInfo,
    MeshData,
    RendererConfig,
)


def _xform(scale=(1.0, 1.0, 1.0), rot_x=0.0, rot_y=0.0, t=(0.0, 0.0, 0.0)):
    """translate(t) @ rot_y @ rot_x @ scale, as float32 [4, 4]."""
    ax, ay = np.radians(rot_x), np.radians(rot_y)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    m = np.eye(4)
    m[:3, :3] = ry @ rx @ np.diag(scale)
    m[:3, 3] = t
    return m.astype(np.float32)


def uv_sphere_mesh(nu=90, nv=90):
    """UV sphere of 2 * nu * nv triangles with vertex normals, built like
    __graft_entry__._rich_scene's mesh sphere."""
    th = np.linspace(0, np.pi, nu + 1, dtype=np.float32)
    ph = np.linspace(0, 2 * np.pi, nv + 1, dtype=np.float32)
    T, P = np.meshgrid(th, ph, indexing="ij")
    V = np.stack(
        [np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], -1
    ).reshape(-1, 3).astype(np.float32)
    ii = np.arange(nu)[:, None] * (nv + 1) + np.arange(nv)[None, :]
    quad = np.stack([ii, ii + 1, ii + nv + 1, ii + nv + 2], -1).reshape(-1, 4)
    F = np.concatenate([quad[:, [0, 1, 2]], quad[:, [1, 3, 2]]], 0)
    return MeshData(positions=V, indices=F.astype(np.int32), normals=V.copy())


def cornell_box(res=512, spp=16, depth_max=8, depth_rr=5, sphere=False,
                meshes=()):
    """Cornell box in the port's IR: white floor, ceiling and back wall,
    red left and green right walls, a short and a tall box, and a 0.5 x 0.5
    area light under the ceiling — 36 triangles.  `sphere` adds a diffuse
    16200-triangle UV-sphere mesh on the short box; `meshes` adds white
    diffuse meshes, as (MeshData, to_world) pairs."""
    tex = TextureBuilder()
    colors = {
        "white": [0.725, 0.71, 0.68],
        "red": [0.63, 0.065, 0.05],
        "green": [0.14, 0.45, 0.091],
    }
    bsdfs, row = [], {}
    for name, c in colors.items():
        row[name] = len(bsdfs)
        bsdfs.append(BsdfInfo(btype=BsdfType.DIFFUSE,
                              id_diffuse_reflectance=tex.add_constant(c)))
    row["light"] = len(bsdfs)
    bsdfs.append(BsdfInfo(btype=BsdfType.AREA_LIGHT,
                          id_radiance=tex.add_constant([17.0, 12.0, 4.0])))

    def rect(bsdf, **kw):
        return InstanceInfo(shape="rectangle", id_bsdf=row[bsdf],
                            to_world=_xform(**kw))

    def cube(bsdf, **kw):
        return InstanceInfo(shape="cube", id_bsdf=row[bsdf],
                            to_world=_xform(**kw))

    instances = [
        rect("white", rot_x=-90, t=(0, 0, 0)),            # floor, +y
        rect("white", rot_x=90, t=(0, 2, 0)),             # ceiling, -y
        rect("white", t=(0, 1, -1)),                      # back wall, +z
        rect("red", rot_y=90, t=(-1, 1, 0)),              # left wall, +x
        rect("green", rot_y=-90, t=(1, 1, 0)),            # right wall, -x
        cube("white", scale=(0.3, 0.3, 0.3), rot_y=-17, t=(0.35, 0.3, 0.3)),
        cube("white", scale=(0.3, 0.6, 0.3), rot_y=17, t=(-0.35, 0.6, -0.3)),
        rect("light", scale=(0.25, 0.25, 1), rot_x=90, t=(0, 1.98, 0)),
    ]
    if sphere:
        instances.append(InstanceInfo(
            shape="mesh", mesh=uv_sphere_mesh(), id_bsdf=row["white"],
            to_world=_xform(scale=(0.3, 0.3, 0.3), t=(0.35, 0.9, 0.3)),
        ))
    for mesh, to_world in meshes:
        instances.append(InstanceInfo(shape="mesh", mesh=mesh,
                                      id_bsdf=row["white"], to_world=to_world))
    cam = CameraInfo(width=res, height=res, spp=spp, fov_x=39.0,
                     eye=np.array([0, 1, 4.5], np.float32),
                     look_at=np.array([0, 1, 0], np.float32))
    return RendererConfig(
        camera=cam,
        integrator=IntegratorInfo(depth_max=depth_max, depth_rr=depth_rr),
        textures=tex, bsdfs=bsdfs, instances=instances,
    )


def cornell_mesh_march(res=512, spp=16, depth_max=8, depth_rr=5):
    """The Cornell box with a 51,200-triangle UV sphere (160 x 160) on the
    short box: 51,236 triangles, 256-triangle SAH chunks, route march."""
    sphere = (uv_sphere_mesh(160, 160),
              _xform(scale=(0.3, 0.3, 0.3), t=(0.35, 0.9, 0.3)))
    return cornell_box(res, spp, depth_max, depth_rr, meshes=[sphere])


def cornell_mesh_pairs(res=512, spp=16, depth_max=8, depth_rr=5):
    """The Cornell box with eight 13,122-triangle UV spheres (81 x 81) in
    a ring above the boxes: 105,012 triangles, 128-triangle SAH chunks,
    route pairs."""
    mesh = uv_sphere_mesh(81, 81)
    ring = []
    for i in range(8):
        a = 2.0 * np.pi * i / 8
        ring.append((mesh, _xform(scale=(0.17, 0.17, 0.17),
                                  t=(0.6 * np.cos(a), 1.45, 0.6 * np.sin(a)))))
    return cornell_box(res, spp, depth_max, depth_rr, meshes=ring)


def cornell_mesh_materials(res=512, spp=16, depth_max=8, depth_rr=5):
    """`cornell_mesh_march` (51,236 triangles, route march) with every BSDF
    family in view and a 2-triangle thin-dielectric pane in front of the
    short box (51,238 triangles):

    * sphere: rough GGX conductor, isotropic alpha 0.2, gold-like
      reflectivity and edge tint (Kulla-Conty on);
    * tall box: rough dielectric, eta 1.5, alpha 0.1;
    * short box: clear-coated conductor (copper-like, alpha 0.3, a coat of
      weight 1 and alpha 0.05);
    * floor: rough plastic, alpha 0.15, eta 1.5;
    * back wall: Oren-Nayar, sigma 0.5;
    * side walls and ceiling: diffuse, as in the Cornell box;
    * pane: thin dielectric, eta 1.5, alpha 0.05.

    The glass box and the pane stand 0.01 above the floor: a transparent
    solid whose bottom face lay in the floor's plane would give the rays
    inside it two hits at one t, one face seen from each side, and which
    one wins would be decided by rounding (z-fighting)."""
    cfg = cornell_mesh_march(res, spp, depth_max, depth_rr)
    tex, bsdfs = cfg.textures, cfg.bsdfs
    white = bsdfs[0].id_diffuse_reflectance

    def add(**kw):
        bsdfs.append(BsdfInfo(**kw))
        return len(bsdfs) - 1

    def rough(a):
        return tex.add_constant([a] * 3)

    gold = add(btype=BsdfType.CONDUCTOR, id_roughness_u=rough(0.2),
               id_roughness_v=rough(0.2),
               reflectivity=np.array([0.944, 0.776, 0.373], np.float32),
               edgetint=np.array([0.998, 0.981, 0.751], np.float32))
    glass = add(btype=BsdfType.DIELECTRIC, eta=1.5,
                id_roughness_u=rough(0.1), id_roughness_v=rough(0.1))
    coated = add(btype=BsdfType.CLEARCOAT_CONDUCTOR,
                 id_roughness_u=rough(0.3), id_roughness_v=rough(0.3),
                 reflectivity=np.array([0.955, 0.638, 0.538], np.float32),
                 edgetint=np.array([0.997, 0.88, 0.72], np.float32),
                 clear_coat=1.0, id_coat_roughness=rough(0.05))
    plastic = add(btype=BsdfType.PLASTIC, eta=1.5,
                  id_diffuse_reflectance=white, id_roughness=rough(0.15))
    oren = add(btype=BsdfType.ROUGH_DIFFUSE, id_diffuse_reflectance=white,
               id_roughness=rough(0.5))
    pane = add(btype=BsdfType.THIN_DIELECTRIC, eta=1.5,
               id_roughness_u=rough(0.05), id_roughness_v=rough(0.05))
    # instances of cornell_box: floor 0, back wall 2, short box 5, tall
    # box 6, the sphere 8
    for inst, row in ((0, plastic), (2, oren), (5, coated), (6, glass),
                      (8, gold)):
        cfg.instances[inst].id_bsdf = row
    cfg.instances[6].to_world = _xform(scale=(0.3, 0.6, 0.3), rot_y=17,
                                       t=(-0.35, 0.61, -0.3))
    cfg.instances.append(InstanceInfo(
        shape="rectangle", id_bsdf=pane,
        to_world=_xform(scale=(0.35, 0.3, 1.0), t=(0.35, 0.31, 0.85))))
    return cfg
