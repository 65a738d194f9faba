"""The port's batched regen body (_shade_regen_batched) and its gate
(_use_batched_trace) against mcpt_tpu, on the CPU.

* The gate decides as the reference's on tests/test_batched_regen.py's
  box (21,634 triangles), on that scene with an opacity map (the port
  cannot compile one yet, ROADMAP item 14, so its SceneData gets
  has_opacity set, which is all the gate reads), on the pair route, on
  dense scenes, at the padded prim counts around DENSE_MAX_PRIMS and
  2^18, and under MCPT_BATCH_TRACE=0/1.
* Direct light (depth 2): the port's batched body against the
  reference's batched body, per pixel, rtol 1e-4, atol 1e-5: the same
  sample streams, only f32 rounding differs — on the diffuse box and on
  its materials version (every BSDF family, test_torch_scene.py's
  materials_box_scene).
* The port's batched body against its own unbatched body, rtol 2e-4,
  atol 2e-5, at sample clamps 0 and 1.5 (the clamp sees a sample only
  after its parked shadow rays resolve): the same draws and terms, summed
  in another order.
* Full depth, a materials version of the box (every BSDF family): channel
  means within 3 sigma of the Monte Carlo error of the mean, and 99% of
  pixels within rtol 1e-3, atol 1e-4, as tests/test_torch_render_mesh.py
  holds the unbatched body.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.integrators.path import _use_batched_trace as jax_gate
from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.integrators.path import _use_batched_trace
from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.compile import compile_scene
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_integrator import make_box_scene
from tests.test_torch_scene import materials_box_scene, to_torch_config


def _with_prims(jscene, tscene, p):
    """Both scenes with p0 replaced by p rows: the gate reads only its
    length."""
    jgeom = jscene.geom.replace(p0=jnp.zeros((p, 3), jnp.float32))
    tgeom = tscene.geom._replace(p0=torch.zeros((p, 3)))
    return (jscene.replace(geom=jgeom),
            dataclasses.replace(tscene, geom=tgeom))


def _gate_scenes(case):
    """(reference SceneData, port SceneData) of one gate case."""
    if case == "dense":
        cfg = make_box_scene(spp=4, res=8)
    elif case == "opacity":
        cfg = make_mesh_box_scene()
        cfg.bsdfs[0].id_opacity = cfg.textures.add_constant([0.5] * 3)
        jscene = jax_compile_scene(cfg)
        cfg.bsdfs[0].id_opacity = -1
        tscene = compile_scene(to_torch_config(cfg), device="cpu")
        return jscene, dataclasses.replace(tscene, has_opacity=True)
    else:
        cfg = make_mesh_box_scene(grid={"grid-dense": 90, "grid-march": 91}
                                  .get(case, 104))
    jscene = jax_compile_scene(cfg)
    tscene = compile_scene(to_torch_config(cfg), device="cpu")
    if case.startswith("prims"):
        jscene, tscene = _with_prims(jscene, tscene, int(case.split("-")[1]))
    return jscene, tscene


GATE_CASES = {
    # case: (MCPT_TRAVERSAL, MCPT_BATCH_TRACE, the decision)
    "mesh-box": (None, None, True),
    "mesh-box-flag0": (None, "0", False),
    "mesh-box-flag1": (None, "1", True),
    "opacity": (None, None, False),
    "opacity-flag1": (None, "1", False),
    "pairs": ("pairs", None, False),
    "pairs-flag1": ("pairs", "1", True),
    "dense": (None, None, False),
    "dense-flag1": (None, "1", False),
    "grid-dense": (None, None, False),        # 16,202 prims, 16384 padded
    "grid-march": (None, None, True),         # 16,564 prims, 32768 padded
    f"prims-{DENSE_MAX_PRIMS}": (None, None, False),
    f"prims-{DENSE_MAX_PRIMS + 1}": (None, None, True),
    f"prims-{1 << 18}": (None, None, True),
    f"prims-{(1 << 18) + 1}": (None, None, False),
    f"prims-{(1 << 18) + 1}-flag1": (None, "1", True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_decides_as_the_reference(monkeypatch, case):
    route, flag, want = GATE_CASES[case]
    for var, value in (("MCPT_TRAVERSAL", route), ("MCPT_BATCH_TRACE", flag)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    jscene, tscene = _gate_scenes(case.removesuffix("-flag0")
                                  .removesuffix("-flag1"))
    assert tscene.geom.p0.shape[0] == jscene.geom.p0.shape[0]
    assert tscene.all_opaque == jscene.all_opaque
    assert _use_batched_trace(tscene) == jax_gate(jscene) == want


def _render(monkeypatch, cfg, batch, port=True, **kw):
    if batch is None:
        monkeypatch.delenv("MCPT_BATCH_TRACE", raising=False)
    else:
        monkeypatch.setenv("MCPT_BATCH_TRACE", batch)
    if not port:
        return np.asarray(JaxRenderer(cfg).render(**kw))
    r = Renderer(to_torch_config(cfg), device="cpu")
    assert _use_batched_trace(r.scene) == (batch != "0")
    return r.render(**kw)


def test_direct_light_matches_reference_batched_per_pixel(monkeypatch):
    cfg = make_mesh_box_scene(spp=4, res=12, depth_max=2)
    ref = _render(monkeypatch, cfg, None, port=False, tile=144)
    got = _render(monkeypatch, cfg, None, tile=144)
    assert got.shape == ref.shape == (12, 12, 3)
    assert ref.mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_materials_direct_light_matches_reference_per_pixel(monkeypatch):
    cfg = materials_box_scene(spp=8, res=12, depth_max=2)
    ref = _render(monkeypatch, cfg, None, port=False, tile=144, spp_chunk=4)
    got = _render(monkeypatch, cfg, None, tile=144, spp_chunk=4)
    assert ref.mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("clamp", [0.0, 1.5])
def test_batched_matches_unbatched(monkeypatch, clamp):
    cfg = make_mesh_box_scene(spp=4, res=10, depth_max=4, sample_clamp=clamp)
    ref = _render(monkeypatch, cfg, "0", spp=4, tile=50)
    got = _render(monkeypatch, cfg, "1", spp=4, tile=50)
    if clamp:
        assert got.max() <= clamp
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_materials_full_depth_matches_reference_statistically(monkeypatch):
    cfg = materials_box_scene(spp=8, res=12, depth_max=8)
    ref = _render(monkeypatch, cfg, None, port=False, tile=144, spp_chunk=4)
    got = _render(monkeypatch, cfg, None, tile=144, spp_chunk=4)
    assert np.isfinite(got).all() and (got >= 0).all()
    n_pix = got.shape[0] * got.shape[1]
    sigma = ref.reshape(n_pix, 3).std(axis=0) / np.sqrt(n_pix)
    diff = np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
    assert (diff <= 3 * sigma).all(), (diff, sigma)
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99
