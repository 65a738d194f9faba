"""The port's BDPT (integrators/bdpt.py) against mcpt_tpu on the CPU.

* Per pixel at depth 3, the same seeds, through Renderer.render (BDPT's
  default engine is the chunked one in both packages), on
  tests/test_integrator.py's box and on the box with a glass sphere
  between the light and the floor: at least 99% of pixels within rtol
  1e-4, atol 1e-5 (seams split by XLA's contracted multiply-adds, ROADMAP
  §3) and channel means within 2e-3 relative.
* At the bounce cap (depth 8: seven bounces) on the indirect-transport
  box, where every camera path needs the ceiling bounce: channel means
  within 3 sigma of the Monte Carlo error of the reference's mean
  (sigma = the pixels' standard deviation / sqrt(pixels)), and per pixel
  as at depth 3 (diffuse surfaces split no paths; a glass sphere does
  past depth 4 under XLA's fusions, and the reference's BDPT compiles for
  over a minute there).
* tests/test_bdpt.py's three ratio checks run by the port, each BDPT
  against the port's own path integrator in the reference's bands: the
  diffuse box (0.95-1.05), indirect transport (0.9-1.1) and the specular
  chain (0.85-1.15).  The film is 64x64 at 3-4 spp, as many samples as
  the reference's 8x8 at 192-256 spp: the image mean estimates the same
  integral at any resolution.
* light_subpath_draws equals the reference's, and the seed a BDPT sample
  returns equals the reference's at depths 2 and 3 on a box with an
  opacity map (every term of the draw layout), so a bounce consumes the
  reference's draws: the RR coin, nee_draw_count, SHADOW_ALPHA_K a
  connection, N_SAMPLE_DRAWS and the continuation's opacity draw.
* MCPT_ENGINE=regen on a BDPT config renders path's regen image, as the
  reference does; BDPT's default engine is the chunked one.
* map_inst_area_pdf equals the reference's, quadric areas included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.integrators import bdpt as JB
from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.render.renderer import _freeze
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu.scene.ir import BsdfInfo, BsdfType, InstanceInfo
from mcpt_tpu_torch.integrators import bdpt as TB
from mcpt_tpu_torch.integrators import path as TP
from mcpt_tpu_torch.models import bsdf as tbsdf
from mcpt_tpu_torch.ops import rng
from mcpt_tpu_torch.render.camera import generate_rays
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import bdpt_caustic
from mcpt_tpu_torch.scene.compile import compile_scene
from tests.test_integrator import make_box_scene, rot_x
from tests.test_torch_scene import to_jax_config, to_torch_config


def _box(spp, res, depth_max, itype="bdpt"):
    cfg = make_box_scene(spp=spp, res=res, depth_max=depth_max)
    cfg.integrator.itype = itype
    return cfg


def _glass_box(spp, res, depth_max, itype="bdpt"):
    """The box with a glass sphere between the light and the floor
    (tests/test_bdpt.py's specular chain)."""
    cfg = _box(spp, res, depth_max, itype)
    cfg.bsdfs.append(BsdfInfo(btype=BsdfType.DIELECTRIC, eta=1.5))
    sphere = InstanceInfo(shape="sphere", radius=0.45, id_bsdf=2)
    sphere.to_world = np.eye(4, dtype=np.float32)
    sphere.to_world[:3, 3] = [0.0, 1.0, 0.0]
    cfg.instances.append(sphere)
    return cfg


def _indirect(spp, res, itype, depth_max=3):
    """An up-facing light under a ceiling panel: every camera path needs
    the ceiling bounce (tests/test_bdpt.py::_indirect_cfg)."""
    cfg = _box(spp, res, depth_max, itype)
    cfg.instances[1].to_world = rot_x(-90.0, scale=0.25, ty=1.0)
    cfg.instances.append(InstanceInfo(
        shape="rectangle", id_bsdf=0, to_world=rot_x(90.0, scale=2.0, ty=2.0)))
    return cfg


def _both(jcfg, **kw):
    """(port, reference) renders of a reference-IR config on the CPU."""
    ref = np.asarray(JaxRenderer(jcfg).render(**kw))
    got = Renderer(to_torch_config(jcfg), device="cpu").render(**kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return got, ref


@pytest.mark.parametrize("make", [_box, _glass_box], ids=["box", "glass_box"])
def test_bdpt_matches_reference_per_pixel(make):
    got, ref = _both(make(spp=4, res=16, depth_max=3), tile=256)
    assert ref.mean() > 0.01
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean() >= 0.99
    assert np.abs(got.mean((0, 1)) / ref.mean((0, 1)) - 1).max() <= 2e-3


def test_bdpt_at_the_bounce_cap():
    got, ref = _both(_indirect(16, 16, "bdpt", depth_max=8), tile=256)
    sigma = ref.reshape(-1, 3).std(axis=0) / np.sqrt(ref.shape[0]
                                                     * ref.shape[1])
    assert ref.mean() > 0.01
    assert (np.abs(got.mean((0, 1)) - ref.mean((0, 1))) <= 3 * sigma).all()
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean() >= 0.99


def _ratio(make_cfg):
    """Mean of the port's BDPT image over the mean of its path image."""
    means = [Renderer(to_torch_config(make_cfg(itype)), device="cpu")
             .render(tile=4096).mean() for itype in ("bdpt", "path")]
    assert np.isfinite(means).all()
    return means[0] / means[1]


def test_bdpt_matches_path_on_diffuse_box():
    assert 0.95 < _ratio(lambda it: _box(3, 64, 4, it)) < 1.05


def test_bdpt_matches_path_on_indirect_transport():
    assert 0.9 < _ratio(lambda it: _indirect(4, 64, it)) < 1.1


def test_bdpt_matches_path_through_specular_chain():
    assert 0.85 < _ratio(lambda it: _glass_box(4, 64, 6, it)) < 1.15


def _opacity_box(depth_max):
    cfg = _box(1, 4, depth_max)
    cfg.bsdfs[0].id_opacity = cfg.textures.add_constant([0.7] * 3)
    return cfg


def _lcg_steps(a, b, most=256):
    """Draws that lead from seeds a to seeds b (equal for every lane)."""
    for k in range(most + 1):
        if torch.equal(a, b):
            return k
        a, _ = rng.random_float(a)
    raise AssertionError("the seeds are not on one LCG stream")


def test_draw_layout_matches_reference():
    seeds = {}
    for depth in (2, 3):
        jcfg = _opacity_box(depth)
        scene = compile_scene(to_torch_config(jcfg), device="cpu")
        jscene = jax_compile_scene(jcfg)
        assert scene.has_opacity and jscene.has_opacity
        assert TB.light_subpath_draws(scene) == JB.light_subpath_draws(jscene)
        r = Renderer(to_torch_config(jcfg), device="cpu")
        pix = torch.arange(16)
        o, d = generate_rays(r.camera, pix, torch.full((16,), 0.5),
                             torch.full((16,), 0.5))
        seed0 = rng.pixel_seed(pix, 3)
        _, seed = TB.shade(r.scene, r.integrator, o, d, seed0)
        integ = _freeze(jcfg.integrator)
        _, jseed = jax.jit(lambda s, o, d, z: JB.shade(s, integ, o, d, z))(
            jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(seed0.numpy().astype(np.uint32)))
        np.testing.assert_array_equal(
            seed.numpy().astype(np.uint32), np.asarray(jseed))
        seeds[depth] = seed
    bounce = (1 + TP.nee_draw_count(scene)
              + TB.K_LIGHT * TP.SHADOW_ALPHA_K + tbsdf.N_SAMPLE_DRAWS + 1)
    assert _lcg_steps(seeds[2], seeds[3]) == bounce


def test_regen_engine_renders_path_and_chunked_is_the_default(monkeypatch):
    monkeypatch.delenv("MCPT_ENGINE", raising=False)
    r_b = Renderer(to_torch_config(_box(2, 8, 3)), device="cpu")
    r_p = Renderer(to_torch_config(_box(2, 8, 3, "path")), device="cpu")
    chunked = r_b.render(tile=64)
    np.testing.assert_array_equal(chunked, r_b.render(tile=64,
                                                      engine="chunked"))
    monkeypatch.setenv("MCPT_ENGINE", "regen")
    regen = r_b.render(tile=64)
    np.testing.assert_array_equal(regen, r_p.render(tile=64))
    assert not np.array_equal(regen, chunked)


@pytest.mark.parametrize("name,make", [
    ("glass_box", lambda: to_torch_config(_glass_box(1, 4, 3))),
    ("bdpt_caustic", lambda: bdpt_caustic(res=4, spp=1)),
])
def test_map_inst_area_pdf_matches_reference(name, make):
    cfg = make()
    got = compile_scene(cfg, device="cpu").map_inst_area_pdf.numpy()
    want = np.asarray(jax_compile_scene(to_jax_config(cfg)).map_inst_area_pdf)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() == len(cfg.instances) - 1  # one light
