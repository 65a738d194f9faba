"""mcpt_tpu_torch scene IR, compile_scene and camera against mcpt_tpu.

One scene description is built with either package's IR (the converters
below copy a RendererConfig field for field), compiled by both packages,
and every leaf of the port's SceneData must EQUAL the reference's: the
host-side commit is the same numpy arithmetic.  Camera rays are held at
rtol 1e-6, atol 1e-6 (one normalize in f32).

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
from mcpt_tpu.render.camera import generate_rays as jax_generate_rays
from mcpt_tpu.render.camera import make_camera as jax_make_camera
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.models.texture import TextureBuilder as TorchTextureBuilder
from mcpt_tpu_torch.render.camera import generate_rays, make_camera
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import cornell_box, uv_sphere_mesh
from mcpt_tpu_torch.scene.compile import compile_scene, scene_from_arrays
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
        for info in obj.infos:
            assert info["type"] == 1, "only constant textures convert"
            out.add_constant(info["color0"])
        return out
    return obj


def enum_types():
    return (jir.BsdfType, tir.BsdfType)


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
    out = {}
    for group in ("geom", "tex", "bsdf", "em"):
        tables = getattr(scene, group)
        for f in tables._fields:
            out[f"{group}.{f}"] = getattr(tables, f).cpu().numpy()
    for f in ("map_inst_bsdf", "map_inst_light_pdf"):
        out[f] = getattr(scene, f).cpu().numpy()
    return out


def cornell_torch_config(res=16, spp=4, depth_max=8, sphere=False):
    return cornell_box(res=res, spp=spp, depth_max=depth_max, sphere=sphere)


SCENES = {
    "make_box_scene": lambda: to_torch_config(make_box_scene(spp=4, res=16)),
    "fallback_scene": lambda: to_torch_config(bench.fallback_scene()),
    "cornell_box": cornell_torch_config,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_leaves_equal(name):
    tcfg = SCENES[name]()
    jscene = jax_compile_scene(to_jax_config(tcfg))
    ref = jax_scene_arrays(jscene)
    scene = compile_scene(tcfg, device="cpu")
    got = torch_scene_arrays(scene)
    assert len(got) == 47
    for key, value in got.items():
        want = reference_leaf(ref, key)
        assert value.dtype == want.dtype, key
        np.testing.assert_array_equal(value, want, err_msg=key)
    assert scene.n_emissive == jscene.n_emissive > 0
    assert scene.present_types == jscene.present_types


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
    ("conductor", "item 13"),
    ("emitter", "item 14"),
    ("sphere", "item 15"),
    ("volpath", "items 16-17"),
    ("mesh_packet_traversal", "item 22"),
])
def test_out_of_slice_scenes_are_refused(monkeypatch, case, item):
    cfg = cornell_torch_config()
    if case == "conductor":
        cfg.bsdfs[0] = tir.BsdfInfo(btype=tir.BsdfType.CONDUCTOR)
    elif case == "emitter":
        cfg.emitters.append(object())
    elif case == "sphere":
        cfg.instances.append(tir.InstanceInfo(shape="sphere", id_bsdf=0))
    elif case == "volpath":
        cfg.integrator.itype = "volpath"
    else:
        # a mesh past DENSE_MAX_PRIMS renders through the march or the
        # pair traversal; the reference's packet traversal is not ported
        big = uv_sphere_mesh(92, 92)  # 16928 triangles
        cfg.instances.append(tir.InstanceInfo(shape="mesh", mesh=big, id_bsdf=0))
        monkeypatch.setenv("MCPT_TRAVERSAL", "packet")
        with pytest.raises(NotImplementedError, match=item):
            Renderer(cfg, device="cpu").render(spp=1)
        return
    with pytest.raises(NotImplementedError, match=item):
        compile_scene(cfg, device="cpu")


def test_cornell_with_sphere_fills_the_dense_sweep():
    scene = compile_scene(cornell_torch_config(sphere=True), device="cpu")
    assert scene.geom.packed_tris.shape == (16384, 12)
    assert int(scene.geom.opaque.sum()) == 36 + 2 * 90 * 90
