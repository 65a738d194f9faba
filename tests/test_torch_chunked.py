"""The chunked per-sample engine (render/renderer.py::render_pixels,
integrators/path.py::shade, integrators/volpath.py::shade) against
mcpt_tpu on the CPU.

* Per pixel at depth 2, the same seeds, through Renderer.render(engine=
  "chunked") in both packages: at least 99% of pixels within rtol 1e-4,
  atol 1e-5 (Cornell wall seams, as tests/test_torch_render.py) and
  channel means within 2e-3 relative (one seam pixel of the Cornell
  box's 256 moves its means by 1e-3), on the Cornell box and
  tests/test_integrator.py's box (path.shade), `volumetric_caustic`
  (isotropic and HG, volpath.shade), tests/test_regen.py's
  `_medium_box`, and `volumetric_caustic` seen from inside its fog under
  a constant sky, where the chunked body adds a camera ray's escape
  radiance before its free flight (R4).
* render_pixels itself on a pixel subset with a sample offset, against
  the reference's render_pixels: u = (offset + s) / spp_total,
  v = VdC2(base + s + 1), one Tea seed per pixel carried across samples.
* The two engines agree statistically where no camera sits in a medium
  (they seed samples otherwise): frame means within 4% at 256 spp, the
  reference's own bound (tests/test_regen.py).
"""

import numpy as np
import pytest
import torch

from mcpt_tpu.render.camera import make_camera as jax_make_camera
from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.render.renderer import _freeze
from mcpt_tpu.render.renderer import render_pixels as jax_render_pixels
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.render.renderer import Renderer, render_pixels
from mcpt_tpu_torch.scene.builtin import volumetric_caustic
from mcpt_tpu_torch.scene.ir import EmitterInfo, EmitterType
from tests.test_integrator import make_box_scene
from tests.test_torch_scene import (cornell_torch_config, to_jax_config,
                                    to_torch_config)
from tests.test_torch_volpath import medium_box


def _camera_in_fog(**kw):
    cfg = volumetric_caustic(**kw)
    cfg.camera.eye = np.array([0.3, 1.5, 1.3], np.float32)
    cfg.camera.look_at = np.array([0.0, 0.9, -1.0], np.float32)
    cfg.emitters.append(EmitterInfo(
        etype=EmitterType.CONSTANT,
        radiance=np.array([0.3, 0.35, 0.45], np.float32)))
    return cfg


SCENES = {
    "cornell": lambda: cornell_torch_config(res=16, spp=4, depth_max=2),
    "box": lambda: to_torch_config(make_box_scene(spp=4, res=16)),
    "volcaustic_isotropic": lambda: volumetric_caustic(res=16, spp=4,
                                                       depth_max=2),
    "volcaustic_hg": lambda: volumetric_caustic(res=16, spp=4, depth_max=2,
                                                phase="hg", g=-0.5),
    "medium_box": lambda: medium_box(spp=4, depth_max=2),
    "camera_in_fog": lambda: _camera_in_fog(res=16, spp=4, depth_max=2),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_chunked_engine_matches_reference_per_pixel(name):
    cfg = SCENES[name]()
    ref = np.asarray(JaxRenderer(to_jax_config(cfg)).render(
        tile=256, engine="chunked"))
    got = Renderer(cfg, device="cpu").render(tile=256, engine="chunked")
    assert np.isfinite(got).all() and ref.mean() > 0.01
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
    assert np.abs(got.mean(axis=(0, 1)) / ref.mean(axis=(0, 1)) - 1).max() \
        <= 2e-3


@pytest.mark.parametrize("name", ["cornell", "volcaustic_isotropic"])
def test_render_pixels_with_offset_matches_reference(name):
    cfg = SCENES[name]()
    jcfg = to_jax_config(cfg)
    idx = np.arange(3, 256, 5)
    kw = dict(spp=3, frame_base=7, spp_total=8, sample_offset=2)
    ref = np.asarray(jax_render_pixels(
        jax_compile_scene(jcfg), jax_make_camera(jcfg.camera),
        _freeze(jcfg.integrator), idx.astype(np.int32), **kw))
    r = Renderer(cfg, device="cpu")
    got = render_pixels(r.scene, r.camera, r.integrator, torch.as_tensor(idx),
                        **kw).numpy()
    assert ref.mean() > 0.01
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1).mean() \
        >= 0.98


@pytest.mark.parametrize("name,make", [
    ("box", lambda: to_torch_config(make_box_scene(spp=256, res=8,
                                                   depth_max=6))),
    ("medium_box", lambda: medium_box(spp=256, depth_max=6)),
])
def test_regen_and_chunked_agree_statistically(name, make):
    r = Renderer(make(), device="cpu")
    a = r.render(tile=64, spp_chunk=256, engine="chunked")
    b = r.render(tile=64, spp_chunk=256, engine="regen")
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.04)


def test_default_engine_and_mcpt_engine(monkeypatch):
    cfg = volumetric_caustic(res=8, spp=2, depth_max=3)
    r = Renderer(cfg, device="cpu")
    monkeypatch.delenv("MCPT_ENGINE", raising=False)
    regen = r.render(tile=64)
    np.testing.assert_array_equal(regen, r.render(tile=64, engine="regen"))
    monkeypatch.setenv("MCPT_ENGINE", "chunked")
    np.testing.assert_array_equal(r.render(tile=64),
                                  r.render(tile=64, engine="chunked"))
    assert not np.array_equal(regen, r.render(tile=64))
