"""mcpt_tpu_torch scene IR, compile_scene and camera against mcpt_tpu.

One scene description is built with either package's IR (the converters
below copy a RendererConfig field for field), compiled by both packages,
and every leaf of the port's SceneData must EQUAL the reference's: the
host-side commit is the same numpy arithmetic.  The Kulla-Conty tables,
which the port computes with torch, are held at the atol of
tests/test_torch_bsdf.py (KC_ATOL).  Camera rays are held at rtol 1e-6,
atol 1e-6 (one normalize in f32).

The helpers here (config converters, leaf flattening) are shared by the
other tests/test_torch_*.py files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import mcpt_tpu.scene.ir as jir
import mcpt_tpu_torch.scene.ir as tir
from mcpt_tpu.models.texture import TextureBuilder as JaxTextureBuilder
from mcpt_tpu.scene.ir import BsdfInfo as JaxBsdfInfo
from mcpt_tpu.scene.ir import BsdfType as JaxBsdfType
from mcpt_tpu.scene.ir import InstanceInfo as JaxInstanceInfo
from mcpt_tpu.render.camera import generate_rays as jax_generate_rays
from mcpt_tpu.render.camera import make_camera as jax_make_camera
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.models.texture import TextureBuilder as TorchTextureBuilder
from mcpt_tpu_torch.render.camera import generate_rays, make_camera
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import (_xform, cornell_box, uv_sphere_mesh,
                                          volumetric_caustic)
from mcpt_tpu_torch.scene.compile import compile_scene, scene_from_arrays
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_integrator import make_box_scene


def _convert(obj, ir, builder_cls):
    if isinstance(obj, enum_types()):
        return getattr(ir, type(obj).__name__)(int(obj))
    if dataclasses.is_dataclass(obj):
        cls = getattr(ir, type(obj).__name__)
        return cls(**{f.name: _convert(getattr(obj, f.name), ir, builder_cls)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [_convert(x, ir, builder_cls) for x in obj]
    if isinstance(obj, (JaxTextureBuilder, TorchTextureBuilder)):
        out = builder_cls()
        for tid, info in enumerate(obj.infos):
            if info["type"] == 1:
                out.add_constant(info["color0"])
            elif info["type"] == 2:
                out.add_checkerboard(info["color0"], info["color1"],
                                     info.get("uv_transform"))
            else:
                out.add_bitmap(obj.bitmap_pixels(tid), info.get("uv_transform"))
        return out
    return obj


def enum_types():
    return (jir.BsdfType, tir.BsdfType, jir.EmitterType, tir.EmitterType)


def to_torch_config(cfg):
    return _convert(cfg, tir, TorchTextureBuilder)


def to_jax_config(cfg):
    return _convert(cfg, jir, JaxTextureBuilder)


def jax_scene_arrays(scene) -> dict:
    """The reference SceneData's leaves as {dotted field name: ndarray}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {
        ".".join(k.name for k in path): np.asarray(leaf)
        for path, leaf in flat
    }


def reference_leaf(ref: dict, key: str) -> np.ndarray:
    """The reference SceneData's value for one of the port's leaves: the
    same field, or for the geometry fields the reference does not keep,
    what it holds them in (march_prim in march_tris' channel 10, the scene
    bounds as the BVH root)."""
    def super_runs(field, reduce):
        # the reference's smin/smax expression (ops/pallas_march.py:475-482)
        # over runs of 128 chunks, the last run partial
        x = ref[field]
        return np.stack([reduce(x[s:s + 128], axis=0)
                         for s in range(0, x.shape[0], 128)])

    derived = {
        "geom.packed_tris": lambda: ref[key].reshape(-1, 12),
        "geom.march_super_min": lambda: super_runs("geom.march_min", np.min),
        "geom.march_super_max": lambda: super_runs("geom.march_max", np.max),
        "geom.march_prim": lambda: ref["geom.march_tris"][..., 10].astype(np.int32),
        "geom.bounds_min": lambda: ref["geom.node_min"][0],
        "geom.bounds_max": lambda: ref["geom.node_max"][0],
    }
    return derived[key]() if key in derived else ref[key]


def torch_scene_arrays(scene) -> dict:
    """The port SceneData's tensors as {dotted field name: ndarray}; the
    static fields of its tables (texture kinds, column kinds, the envmap's
    size) are not leaves, as in the reference."""
    out = {}
    for group in ("geom", "tex", "bsdf", "em", "emitters", "env", "media",
                  "quad"):
        tables = getattr(scene, group)
        for f in tables._fields:
            value = getattr(tables, f)
            if isinstance(value, torch.Tensor):
                out[f"{group}.{f}"] = value.cpu().numpy()
    for f in ("map_inst_bsdf", "map_inst_light_pdf", "map_inst_area_pdf",
              "map_inst_medium_int", "map_inst_medium_ext", "brdf_avg",
              "albedo_avg"):
        out[f] = getattr(scene, f).cpu().numpy()
    return out


#: the static facts of SceneData, equal in both packages
STATIC_FACTS = ("present_types", "emitter_rows", "env_kind", "env_row",
                "sun_row", "has_bump", "has_opacity", "quad_kinds",
                "em_quad_cells", "all_opaque", "surface_kinds")

#: the Kulla-Conty tables' tolerance (tests/test_torch_bsdf.py)
KC_ATOL = {"brdf_avg": 5e-4, "albedo_avg": 1e-5}


def materials_box_scene(spp=8, res=12, depth_max=8):
    """tests/test_batched_regen.py's box (a 21,632-triangle floor, past
    DENSE_MAX_PRIMS) with every BSDF family in view, in the reference's
    IR: a plastic floor, a rough conductor, a rough dielectric and a
    Beckmann clear-coated conductor cube, an Oren-Nayar back wall and a
    thin-dielectric pane; the diffuse row stays in the table.  The glass
    cube stands 0.01 above the floor, so that no face of it lies in the
    floor's plane (cornell_mesh_materials says why)."""
    cfg = make_mesh_box_scene(spp=spp, res=res, depth_max=depth_max)
    tex, bsdfs = cfg.textures, cfg.bsdfs
    white = bsdfs[0].id_diffuse_reflectance

    def add(**kw):
        bsdfs.append(JaxBsdfInfo(**kw))
        return len(bsdfs) - 1

    def rough(a):
        return tex.add_constant([a] * 3)

    def rgb(*c):
        return np.array(c, np.float32)

    cfg.instances[0].id_bsdf = add(
        btype=JaxBsdfType.PLASTIC, id_diffuse_reflectance=white,
        id_roughness=rough(0.2))
    metal = add(btype=JaxBsdfType.CONDUCTOR, id_roughness_u=rough(0.25),
                id_roughness_v=rough(0.25), reflectivity=rgb(0.9, 0.7, 0.4),
                edgetint=rgb(1.0, 0.9, 0.7))
    glass = add(btype=JaxBsdfType.DIELECTRIC, eta=1.5,
                id_roughness_u=rough(0.15), id_roughness_v=rough(0.15))
    coat = add(btype=JaxBsdfType.CLEARCOAT_CONDUCTOR, ndf="beckmann",
               id_roughness_u=rough(0.3), id_roughness_v=rough(0.3),
               reflectivity=rgb(0.95, 0.64, 0.54), edgetint=rgb(1, 0.9, 0.7),
               clear_coat=1.0, id_coat_roughness=rough(0.05))
    wall = add(btype=JaxBsdfType.ROUGH_DIFFUSE, id_diffuse_reflectance=white,
               id_roughness=rough(0.5))
    pane = add(btype=JaxBsdfType.THIN_DIELECTRIC, eta=1.5,
               id_roughness_u=rough(0.05), id_roughness_v=rough(0.05))
    for bsdf, shape, kw in (
        (metal, "cube", dict(scale=(0.25,) * 3, t=(-0.7, 0.25, 0.0))),
        (glass, "cube", dict(scale=(0.25,) * 3, rot_y=30, t=(0.0, 0.26, -0.4))),
        (coat, "cube", dict(scale=(0.25,) * 3, t=(0.7, 0.25, 0.0))),
        (wall, "rectangle", dict(scale=(2.0, 2.0, 1.0), t=(0.0, 1.0, -1.5))),
        (pane, "rectangle", dict(scale=(0.3, 0.3, 1.0), t=(0.3, 0.35, 0.7))),
    ):
        cfg.instances.append(JaxInstanceInfo(shape=shape, id_bsdf=bsdf,
                                             to_world=_xform(**kw)))
    return cfg


def cornell_torch_config(res=16, spp=4, depth_max=8, sphere=False):
    return cornell_box(res=res, spp=spp, depth_max=depth_max, sphere=sphere)


SCENES = {
    "make_box_scene": lambda: to_torch_config(make_box_scene(spp=4, res=16)),
    "fallback_scene": lambda: to_torch_config(bench.fallback_scene()),
    "cornell_box": cornell_torch_config,
    "materials_box_scene": lambda: to_torch_config(materials_box_scene()),
    "volumetric_caustic_hg": lambda: volumetric_caustic(res=16, spp=4,
                                                        phase="hg", g=-0.5),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_leaves_equal(name):
    tcfg = SCENES[name]()
    jscene = jax_compile_scene(to_jax_config(tcfg))
    ref = jax_scene_arrays(jscene)
    scene = compile_scene(tcfg, device="cpu")
    got = torch_scene_arrays(scene)
    assert len(got) == 106
    for key, value in got.items():
        want = reference_leaf(ref, key)
        assert value.dtype == want.dtype, key
        if key in KC_ATOL and want.any():
            np.testing.assert_allclose(value, want, rtol=0, atol=KC_ATOL[key],
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(value, want, err_msg=key)
    assert scene.n_emissive == jscene.n_emissive > 0
    for fact in STATIC_FACTS:
        assert getattr(scene, fact) == getattr(jscene, fact), fact
    if name == "materials_box_scene":
        assert len(scene.present_types) == 8 and scene.brdf_avg.any()
    if name == "volumetric_caustic_hg":
        assert not scene.all_opaque and scene.quad_kinds == ((0, True),)
        assert scene.map_inst_medium_int.tolist() == [-1, 0, -1, -1]
        assert scene.map_inst_medium_ext.tolist() == [-1, -1, 0, -1]
        assert scene.media.phase_type.tolist() == [1]


def test_scene_from_arrays_rebuilds_the_reference_scene():
    tcfg = cornell_torch_config()
    arrays = jax_scene_arrays(jax_compile_scene(to_jax_config(tcfg)))
    rebuilt = scene_from_arrays(arrays, device="cpu")
    direct = compile_scene(tcfg, device="cpu")
    for key, value in torch_scene_arrays(rebuilt).items():
        np.testing.assert_array_equal(value, torch_scene_arrays(direct)[key],
                                      err_msg=key)
    assert rebuilt.n_emissive == direct.n_emissive
    assert rebuilt.present_types == direct.present_types


def test_scene_from_arrays_carries_every_family_and_renders_the_same():
    """The reference's compiled materials scene, carried across: every
    leaf and static fact equals the port's own commit (the Kulla-Conty
    tables are the reference's), and the port renders it as it renders
    its own commit given those tables — bit for bit."""
    jcfg = materials_box_scene(spp=2, res=8, depth_max=4)
    rebuilt = scene_from_arrays(jax_scene_arrays(jax_compile_scene(jcfg)),
                                device="cpu")
    r = Renderer(to_torch_config(jcfg), device="cpu")
    direct = dataclasses.replace(r.scene, brdf_avg=rebuilt.brdf_avg,
                                 albedo_avg=rebuilt.albedo_avg)
    want = torch_scene_arrays(direct)
    for key, value in torch_scene_arrays(rebuilt).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    for fact in ("n_emissive", "present_types", "has_opacity", "all_opaque"):
        assert getattr(rebuilt, fact) == getattr(direct, fact), fact
    images = []
    for scene in (direct, rebuilt):
        r.scene = scene
        images.append(r.render(spp=2))
    assert images[0].mean() > 0.05
    np.testing.assert_array_equal(images[0], images[1])


@pytest.mark.parametrize("res", [(16, 16), (24, 10)])
def test_camera_rays_match(res):
    tcfg = cornell_torch_config()
    tcfg.camera.width, tcfg.camera.height = res
    tcfg.camera.up = np.array([0.1, 1.0, 0.2], np.float32)
    n = res[0] * res[1]
    r = np.random.default_rng(5)
    u = r.uniform(size=n).astype(np.float32)
    v = r.uniform(size=n).astype(np.float32)
    pix = np.arange(n)
    o, d = generate_rays(make_camera(tcfg.camera, device="cpu"),
                         torch.as_tensor(pix), torch.as_tensor(u),
                         torch.as_tensor(v))
    jo, jd = jax_generate_rays(jax_make_camera(to_jax_config(tcfg).camera),
                               jnp.asarray(pix, jnp.int32), jnp.asarray(u),
                               jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case,item", [
    ("mesh_packet_traversal", "item 22"),
])
def test_out_of_slice_scenes_are_refused(monkeypatch, case, item):
    # a mesh past DENSE_MAX_PRIMS renders through the march or the pair
    # traversal; the reference's packet traversal is not ported
    cfg = cornell_torch_config()
    big = uv_sphere_mesh(92, 92)  # 16928 triangles
    cfg.instances.append(tir.InstanceInfo(shape="mesh", mesh=big, id_bsdf=0))
    monkeypatch.setenv("MCPT_TRAVERSAL", "packet")
    with pytest.raises(NotImplementedError, match=item):
        Renderer(cfg, device="cpu").render(spp=1)


def test_cornell_with_sphere_fills_the_dense_sweep():
    scene = compile_scene(cornell_torch_config(sphere=True), device="cpu")
    assert scene.geom.packed_tris.shape == (16384, 12)
    assert int(scene.geom.opaque.sum()) == 36 + 2 * 90 * 90
