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

Two scenes without the box drive the emitters, textures and quadrics:

* `envmap_matpreview` — a matpreview-class scene lit only by an
  importance-sampled HDR envmap: the 51,200-triangle sphere in rough
  gold, a bump-mapped cube, a bitmap-textured floor; the block march and
  the batched regen body;
* `lights_showcase` — a test scene of every other emitter and texture
  feature: emissive and diffuse analytic spheres of radii 0.02 to 2,
  a disk and a cylinder, glossy plates over a checkerboard floor, two
  alpha-masked quads, a point, a spot with a projection bitmap, a
  directional light, a sun with its bitmap, a constant sky; 14
  triangles, the dense sweep and the unbatched body's alpha walk.

`bump_and_bead` holds the two features that turn rounding into pixels at
the scale where card and CPU renders first parted: an emissive sphere of
radius 0.02 and a bump map of ripple height.

`volumetric_caustic` is a volumetric-caustic-class scene for the volpath
integrator: a glass sphere in a box of fog (a null-boundary cube holding
a homogeneous medium), lit by a small area light above it, over a
diffuse floor; isotropic or Henyey-Greenstein scattering.

Every texture and the envmap are made in code from fixed formulas and
seeds, so nothing is read from disk.
"""

from __future__ import annotations

import numpy as np

from mcpt_tpu_torch.models.texture import TextureBuilder
from mcpt_tpu_torch.scene.ir import (
    BsdfInfo,
    BsdfType,
    CameraInfo,
    EmitterInfo,
    EmitterType,
    InstanceInfo,
    IntegratorInfo,
    MediumInfo,
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


def sky_envmap(width=2048, height=1024):
    """A lat-long HDR sky (row 0 at +y): a zenith-to-horizon gradient, a
    dim ground, and a 16 x 8 texel sun patch 2e4 times the sky's
    brightness at theta 0.3 pi, phi 0.35 * 2pi — so importance sampling
    matters.  [H, W, 3] f32."""
    theta = (np.arange(height, dtype=np.float32) + 0.5) / height * np.pi
    up = np.clip(np.cos(theta), 0.0, 1.0)[:, None]
    zenith = np.array([0.25, 0.45, 1.0], np.float32)
    horizon = np.array([1.0, 0.9, 0.75], np.float32)
    ground = np.array([0.12, 0.1, 0.08], np.float32)
    row = np.where((theta < np.pi / 2)[:, None],
                   horizon + (zenith - horizon) * up, ground)
    sky = np.broadcast_to(row[:, None, :], (height, width, 3)).copy()
    r0, c0 = int(0.3 * height), int(0.35 * width)
    sky[r0:r0 + height // 128, c0:c0 + width // 128] = 2e4
    return sky.astype(np.float32)


def _tile_bitmap(size=1024, seed=7):
    """An RGB floor of 16 x 16 tiles, each its own earthy tone, with dark
    grout and per-texel grain.  [size, size, 3] f32."""
    r = np.random.default_rng(seed)
    n = 16
    tones = 0.25 + 0.5 * r.random((n, n, 3)).astype(np.float32)
    tones *= np.array([1.0, 0.85, 0.7], np.float32)
    cell = size // n
    img = np.repeat(np.repeat(tones, cell, 0), cell, 1)
    img *= 0.9 + 0.1 * r.random((size, size, 1)).astype(np.float32)
    grout = (np.arange(size) % cell) < max(cell // 16, 1)
    img[grout] = 0.05
    img[:, grout] = 0.05
    return img.astype(np.float32)


def _ripple_bump(size=128, waves=6, amplitude=0.02):
    """A mono bump map: amplitude * (1.05 + sin(waves 2pi u) sin(waves 2pi
    v)).  Positive, since a bump reads the color's length, and near 0:
    the forward difference at 1e-4 scales the length's rounding by 1e4,
    and values near 0 round finely."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 * np.pi * waves
    return (amplitude * (1.05 + np.sin(t)[:, None] * np.sin(t)[None, :])
            ).astype(np.float32)


def envmap_matpreview(res=512, spp=16, depth_max=8, depth_rr=5):
    """A matpreview-class scene lit by the 2048 x 1024 `sky_envmap` alone
    (2,097,152 texels: its alias table is built by the native-order
    build): the 51,200-triangle UV sphere (160 x 160) in rough GGX gold
    (alpha 0.2, Kulla-Conty on), a diffuse cube with a 128 x 128 ripple
    bump map, and a 12 x 12 floor whose albedo is a 1024 x 1024 RGB tile
    bitmap repeated 3 x 3 by its uv transform.  51,214 triangles, all
    opaque, no area light: the block march and the batched regen body
    with one shadow query (the envmap's).  The cube stands 0.01 above the
    floor: a bottom face in the floor's plane would tie with the floor at
    one t, its winner decided by rounding (z-fighting)."""
    tex = TextureBuilder()
    bsdfs = [
        BsdfInfo(btype=BsdfType.CONDUCTOR,
                 id_roughness_u=tex.add_constant([0.2] * 3),
                 id_roughness_v=tex.add_constant([0.2] * 3),
                 reflectivity=np.array([0.944, 0.776, 0.373], np.float32),
                 edgetint=np.array([0.998, 0.981, 0.751], np.float32)),
        BsdfInfo(btype=BsdfType.DIFFUSE,
                 id_diffuse_reflectance=tex.add_constant([0.6, 0.62, 0.65]),
                 id_bump_map=tex.add_bitmap(_ripple_bump())),
        BsdfInfo(btype=BsdfType.DIFFUSE,
                 id_diffuse_reflectance=tex.add_bitmap(
                     _tile_bitmap(), uv_transform=[3, 0, 0, 0, 3, 0])),
    ]
    sky = tex.add_bitmap(sky_envmap())
    instances = [
        InstanceInfo(shape="mesh", mesh=uv_sphere_mesh(160, 160), id_bsdf=0,
                     to_world=_xform(t=(0.0, 1.0, 0.0))),
        InstanceInfo(shape="cube", id_bsdf=1,
                     to_world=_xform(scale=(0.45,) * 3, rot_y=30,
                                     t=(1.7, 0.46, 0.6))),
        InstanceInfo(shape="rectangle", id_bsdf=2,
                     to_world=_xform(scale=(6.0, 6.0, 1.0), rot_x=-90)),
    ]
    cam = CameraInfo(width=res, height=res, spp=spp, fov_x=40.0,
                     eye=np.array([0.6, 1.9, 5.2], np.float32),
                     look_at=np.array([0.5, 0.75, 0.0], np.float32))
    return RendererConfig(
        camera=cam,
        integrator=IntegratorInfo(depth_max=depth_max, depth_rr=depth_rr),
        textures=tex, bsdfs=bsdfs, instances=instances,
        emitters=[EmitterInfo(etype=EmitterType.ENVMAP, id_texture=sky)],
    )


def _mask_bitmap(size=64):
    """An RGBA leaf-and-hole mask: opaque green bars with round holes
    (alpha 0) on a grid.  [size, size, 4] f32."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    holes = ((x * 4) % 1 - 0.5) ** 2 + ((y * 4) % 1 - 0.5) ** 2 < 0.09
    rgba = np.empty((size, size, 4), np.float32)
    rgba[..., 0] = 0.2 + 0.3 * x
    rgba[..., 1] = 0.6
    rgba[..., 2] = 0.2 + 0.3 * y
    rgba[..., 3] = np.where(holes, 0.0, 1.0)
    return rgba


def _stripes_bitmap(size=64):
    """A spot light's projection: RGB stripes.  [size, size, 3] f32."""
    x = (np.arange(size, dtype=np.float32) + 0.5) / size
    band = (np.floor(x * 6) % 3).astype(np.int64)
    colors = np.array([[1.0, 0.3, 0.3], [0.3, 1.0, 0.3], [0.3, 0.3, 1.0]],
                      np.float32)
    return np.broadcast_to(colors[band][None], (size, size, 3)).copy()


def _sun_bitmap(direction, width=256, height=128, cutoff_deg=1.5,
                radiance=2000.0):
    """The lat-long image escaping camera rays see of the sun: zero but a
    disk of `cutoff_deg` around -direction.  [H, W, 3] f32."""
    to_sun = -np.asarray(direction, np.float64)
    to_sun /= np.linalg.norm(to_sun)
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2.0 * np.pi
    dirs = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None],
                     np.broadcast_to(np.cos(theta)[:, None], (height, width)),
                     np.sin(theta)[:, None] * np.sin(phi)[None]], -1)
    disk = dirs @ to_sun >= np.cos(np.radians(cutoff_deg))
    img = np.zeros((height, width, 3), np.float32)
    img[disk] = radiance
    return img


def lights_showcase(res=512, spp=16, depth_max=8, depth_rr=5):
    """A veach-MIS-class test scene of the emitter, texture and quadric
    features (not a user's scene):

    * four glossy plates (GGX conductors, alpha 0.01 to 0.2, Kulla-Conty
      on) over a diffuse floor with a checkerboard of 8 x 8 per uv unit,
      its edges shifted off the image's center line;
    * analytic spheres of radii 0.02 to 2: an emissive one of radius
      0.25 (one emissive CDF cell), a mirror-like one of radius 0.08, a
      diffuse bead of radius 0.02 and a diffuse ball of radius 2 behind;
      a diffuse disk on an open cylinder.  The light is not a small
      sphere: a shadow ray toward a point near a sphere's silhouette
      meets the sphere itself at a root whose rounding error grows as
      1/r, and within EPSILON_DISTANCE of the point that decides the
      occlusion by the last ulp (the card's sin and cos, and XLA's
      contractions, round otherwise than the CPU's torch);
    * two quads masked by an RGBA bitmap (alpha 0 in round holes), one
      above the plates, one standing on the floor, both across light
      paths, so that shadow rays take the alpha walk;
    * a point light, a spot with a striped projection bitmap, a
      directional light, a sun (cone 1.5 deg) with its bitmap, and a
      constant sky.

    14 triangles and 6 quadric rows: the dense sweep, the unbatched regen
    body (opacity maps), six shadow queries a vertex."""
    tex = TextureBuilder()
    bsdfs = []

    def add(**kw):
        bsdfs.append(BsdfInfo(**kw))
        return len(bsdfs) - 1

    white = tex.add_constant([0.7, 0.7, 0.7])
    # the checker's edges are shifted off u, v = 0.5: the camera looks down
    # x = 0, and an edge there would be crossed by rounding alone
    checker = tex.add_checkerboard([0.75, 0.75, 0.72], [0.2, 0.22, 0.25],
                                   uv_transform=[8, 0, 0.13, 0, 8, 0.29])
    floor = add(btype=BsdfType.DIFFUSE, id_diffuse_reflectance=checker)
    diffuse = add(btype=BsdfType.DIFFUSE, id_diffuse_reflectance=white)
    plates = []
    for alpha in (0.01, 0.04, 0.1, 0.2):
        a = tex.add_constant([alpha] * 3)
        plates.append(add(
            btype=BsdfType.CONDUCTOR, id_roughness_u=a, id_roughness_v=a,
            reflectivity=np.array([0.9, 0.9, 0.92], np.float32),
            edgetint=np.array([0.95, 0.95, 0.95], np.float32)))
    light = add(btype=BsdfType.AREA_LIGHT,
                id_radiance=tex.add_constant([6.0, 6.5, 9.0]))
    mask = add(btype=BsdfType.DIFFUSE, id_diffuse_reflectance=white,
               id_opacity=tex.add_bitmap(_mask_bitmap()))

    instances = [InstanceInfo(shape="rectangle", id_bsdf=floor,
                              to_world=_xform(scale=(5, 5, 1), rot_x=-90))]
    for i, row in enumerate(plates):
        instances.append(InstanceInfo(
            shape="rectangle", id_bsdf=row,
            to_world=_xform(scale=(1.2, 0.18, 1), rot_x=-90 + 20 + 12 * i,
                            t=(0.0, 0.25 + 0.3 * i, 1.0 - 0.45 * i))))
    instances += [
        InstanceInfo(shape="sphere", id_bsdf=light, radius=0.25,
                     center=np.array([0.8, 2.0, -0.2], np.float32)),
        InstanceInfo(shape="sphere", id_bsdf=plates[0], radius=0.08,
                     center=np.array([-0.8, 1.9, 0.2], np.float32)),
        InstanceInfo(shape="sphere", id_bsdf=diffuse, radius=2.0,
                     center=np.array([0.0, 2.0, -5.0], np.float32)),
        InstanceInfo(shape="sphere", id_bsdf=diffuse, radius=0.02,
                     center=np.array([0.3, 0.5, 1.5], np.float32)),
        InstanceInfo(shape="cylinder", id_bsdf=diffuse, radius=0.12,
                     p0=np.array([-1.8, 0.0, 0.6], np.float32),
                     p1=np.array([-1.8, 0.59, 0.6], np.float32)),
        InstanceInfo(shape="disk", id_bsdf=diffuse,
                     to_world=_xform(scale=(0.7, 0.7, 0.7), rot_x=-90,
                                     t=(-1.8, 0.6, 0.6))),
        InstanceInfo(shape="rectangle", id_bsdf=mask,
                     to_world=_xform(scale=(0.6, 0.6, 1), rot_x=90,
                                     t=(1.2, 1.5, 0.5))),
        InstanceInfo(shape="rectangle", id_bsdf=mask,
                     to_world=_xform(scale=(0.5, 0.5, 1), rot_y=-35,
                                     t=(1.6, 0.5, 1.2))),
    ]
    sun_dir = np.array([-0.4, -0.75, -0.5], np.float32)
    emitters = [
        EmitterInfo(etype=EmitterType.POINT,
                    position=np.array([1.3, 2.2, 0.8], np.float32),
                    intensity=np.array([6.0, 6.0, 5.0], np.float32)),
        EmitterInfo(etype=EmitterType.SPOT, cutoff_angle=25.0, beam_width=18.0,
                    intensity=np.array([12.0, 12.0, 12.0], np.float32),
                    id_texture=tex.add_bitmap(_stripes_bitmap()),
                    to_world=_xform(rot_x=90, t=(-1.0, 2.6, 1.2))),
        EmitterInfo(etype=EmitterType.DIRECTIONAL,
                    direction=np.array([0.3, -1.0, 0.2], np.float32),
                    radiance=np.array([0.3, 0.3, 0.35], np.float32)),
        EmitterInfo(etype=EmitterType.SUN, direction=sun_dir, cutoff_angle=1.5,
                    radiance=np.array([1.2, 1.1, 0.9], np.float32),
                    id_texture=tex.add_bitmap(_sun_bitmap(sun_dir))),
        EmitterInfo(etype=EmitterType.CONSTANT,
                    radiance=np.array([0.08, 0.1, 0.14], np.float32)),
    ]
    cam = CameraInfo(width=res, height=res, spp=spp, fov_x=45.0,
                     eye=np.array([0.0, 2.2, 5.5], np.float32),
                     look_at=np.array([0.0, 0.7, 0.0], np.float32))
    return RendererConfig(
        camera=cam,
        integrator=IntegratorInfo(depth_max=depth_max, depth_rr=depth_rr),
        textures=tex, bsdfs=bsdfs, instances=instances, emitters=emitters,
    )


#: the bump height of `bump_and_bead`: bitmap values 0.025 to 1.025, a
#: bitmap's full range, 25 times the envmap scene's (whose values stay
#: near 0 so that the forward difference at 1e-4, which scales a
#: length's rounding by 1e4, rounds finely)
RIPPLE_HEIGHT = 0.5


def bump_and_bead(res=512, spp=16, depth_max=8, depth_rr=5,
                  amplitude=RIPPLE_HEIGHT):
    """A test scene of the two features that amplify rounding (not a
    user's scene): a diffuse cube with a 128 x 128 ripple bump map of
    `amplitude` (0.01 above the floor), and an emissive sphere of radius
    0.02 (one emissive CDF cell, radiance 2000) beside it, whose shadow
    rays toward points near its silhouette meet the sphere itself at a
    root whose rounding grows as 1/r; a diffuse floor and a dim constant
    sky.  14 triangles and one quadric row: the dense sweep and the
    unbatched regen body."""
    tex = TextureBuilder()
    bsdfs = [
        BsdfInfo(btype=BsdfType.DIFFUSE,
                 id_diffuse_reflectance=tex.add_constant([0.6, 0.62, 0.65]),
                 id_bump_map=tex.add_bitmap(_ripple_bump(amplitude=amplitude))),
        BsdfInfo(btype=BsdfType.DIFFUSE,
                 id_diffuse_reflectance=tex.add_constant([0.7, 0.68, 0.64])),
        BsdfInfo(btype=BsdfType.AREA_LIGHT,
                 id_radiance=tex.add_constant([2000.0, 1800.0, 1500.0])),
    ]
    instances = [
        InstanceInfo(shape="cube", id_bsdf=0,
                     to_world=_xform(scale=(0.45,) * 3, rot_y=30,
                                     t=(0.0, 0.46, 0.0))),
        InstanceInfo(shape="rectangle", id_bsdf=1,
                     to_world=_xform(scale=(4.0, 4.0, 1.0), rot_x=-90)),
        InstanceInfo(shape="sphere", id_bsdf=2, radius=0.02,
                     center=np.array([0.75, 1.05, 0.55], np.float32)),
    ]
    cam = CameraInfo(width=res, height=res, spp=spp, fov_x=40.0,
                     eye=np.array([0.4, 1.6, 3.2], np.float32),
                     look_at=np.array([0.1, 0.45, 0.0], np.float32))
    return RendererConfig(
        camera=cam,
        integrator=IntegratorInfo(depth_max=depth_max, depth_rr=depth_rr),
        textures=tex, bsdfs=bsdfs, instances=instances,
        emitters=[EmitterInfo(etype=EmitterType.CONSTANT,
                              radiance=np.array([0.1, 0.12, 0.15],
                                                np.float32))],
    )


#: the fog of `volumetric_caustic`: sigma_t 0.4 a unit, so an optical
#: depth of 1.2 across the 3-unit box (both branches of the free flight
#: carry weight), albedo 0.875
FOG_SIGMA_S = 0.35
FOG_SIGMA_A = 0.05


def volumetric_caustic(res=512, spp=16, depth_max=16, depth_rr=5,
                       phase="isotropic", g=0.0):
    """A volumetric-caustic-class scene, the layout of the reference
    suite's volumetric-caustic/scene_v0.6.xml built in code: a smooth
    dielectric sphere (eta 1.5, an analytic quadric of radius 0.5, the fog
    outside it) in a 3 x 2 x 3 box of fog (a null-boundary cube, 12
    triangles, holding a homogeneous medium of `phase` scattering, HG
    asymmetry `g`), lit by a 0.6 x 0.6 area light 1 unit above the box,
    facing the sphere, so that its shadow rays cross the box's null faces;
    a diffuse floor 0.05 below the box's bottom face (no coplanar faces).
    The camera stands outside the fog.  16 triangles and one quadric row:
    the dense sweep (K1) and the volpath regen body; the volpath
    integrator at depth 16, as the reference suite times this scene."""
    tex = TextureBuilder()
    bsdfs = [
        BsdfInfo(btype=BsdfType.DIFFUSE,
                 id_diffuse_reflectance=tex.add_constant([0.7, 0.7, 0.68])),
        BsdfInfo(btype=BsdfType.DIELECTRIC, eta=1.5),
        BsdfInfo(btype=BsdfType.AREA_LIGHT,
                 id_radiance=tex.add_constant([30.0, 27.0, 22.0])),
    ]
    fog = MediumInfo(sigma_a=np.full(3, FOG_SIGMA_A, np.float32),
                     sigma_s=np.full(3, FOG_SIGMA_S, np.float32),
                     phase=phase, g=np.full(3, g, np.float32))
    instances = [
        InstanceInfo(shape="rectangle", id_bsdf=0,
                     to_world=_xform(scale=(3.0, 3.0, 1.0), rot_x=-90)),
        InstanceInfo(shape="cube", id_bsdf=-1, id_medium_int=0,
                     to_world=_xform(scale=(1.5, 1.0, 1.5),
                                     t=(0.0, 1.05, 0.0))),
        InstanceInfo(shape="sphere", id_bsdf=1, radius=0.5,
                     center=np.array([0.0, 1.0, 0.0], np.float32),
                     id_medium_ext=0),
        InstanceInfo(shape="rectangle", id_bsdf=2,
                     to_world=_xform(scale=(0.3, 0.3, 1.0), rot_x=90,
                                     t=(0.0, 3.05, 0.0))),
    ]
    cam = CameraInfo(width=res, height=res, spp=spp, fov_x=45.0,
                     eye=np.array([0.0, 1.6, 5.0], np.float32),
                     look_at=np.array([0.0, 0.9, 0.0], np.float32))
    return RendererConfig(
        camera=cam,
        integrator=IntegratorInfo(itype="volpath", depth_max=depth_max,
                                  depth_rr=depth_rr),
        textures=tex, bsdfs=bsdfs, media=[fog], instances=instances,
    )


def bdpt_caustic(res=512, spp=8, depth_max=8, depth_rr=5):
    """The volumetric-caustic layout without its fog, rendered by BDPT:
    the layout of the reference suite's volumetric-caustic/no_medium.xml
    built in code, which its harness times at 512x512, 8 spp with
    itype="bdpt" (scripts/bench_suite.py:49-50).  volumetric_caustic's
    glass sphere (a quadric), area light, floor and camera; no fog box and
    no media.  Depth 8, the cap BDPT's bounce loop reaches anyway.  Four
    triangles (the floor and the light) and one quadric row: K1 and the
    quadric sweep."""
    cfg = volumetric_caustic(res=res, spp=spp, depth_max=depth_max,
                             depth_rr=depth_rr)
    cfg.media = []
    cfg.instances = [i for i in cfg.instances if i.shape != "cube"]
    for inst in cfg.instances:
        inst.id_medium_int = inst.id_medium_ext = -1
    cfg.integrator.itype = "bdpt"
    return cfg
