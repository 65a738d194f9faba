"""The port's volpath integrator (integrators/volpath.py::shade_regen, the
regen engine) and media in scenes, against mcpt_tpu on the CPU.

* Per pixel at low depth, the same seeds: at least 99% of pixels within
  rtol 1e-4, atol 1e-5 and channel means within 1e-4 relative (every
  pixel agrees on this tree) on
  - tests/test_medium.py's `_slab_cfg`: an emissive wall seen through a
    null-boundary slab of absorbing and scattering medium, at depth 4
    (the wall is the third vertex behind the slab's two null faces, so
    at depth 2 the image is black);
  - tests/test_regen.py's `_medium_box`: a fog ball behind a null sphere
    (a quadric) over a lit floor, at depth 2;
  - `volumetric_caustic`, isotropic and HG (g = -0.5), at depth 2.
  A draw-layout fault moves every later draw and so nearly every pixel.
* Full depth, statistically: channel means within 3 sigma of the Monte
  Carlo error of the reference's mean (sigma = the pixels' standard
  deviation / sqrt(pixels)), and pixels within rtol 1e-4, atol 1e-5 on
  at least 75% (volumetric_caustic, depth 16; 84% on this tree) and 95%
  (`_medium_box`, depth 6) of pixels: beyond depth 4 a glass sphere's
  chain of smooth refractions splits paths apart by rounding.  The
  split is XLA's: its fusions contract multiply-adds into FMAs, and the
  same glass scene by the path integrator at depth 6 agrees with the
  reference on every pixel when the reference runs op by op under
  jax.disable_jit (tested here).
* The path integrator through a null shell, per pixel (every pixel
  within rtol 1e-4, atol 1e-5): the shell passes camera and shadow rays.
* Closed forms from the reference's tests: Beer-Lambert through the
  slab, and volpath without a medium bound equal to the path integrator.
* The reference's compiled medium scene carried across
  (scene_from_arrays) renders as the port's own commit, bit for bit.
"""

import numpy as np
import pytest

from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.integrators.path import _use_batched_trace
from mcpt_tpu_torch.ops.quadric import KIND_SPHERE
from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import volumetric_caustic
from mcpt_tpu_torch.scene.compile import scene_from_arrays
from tests import test_medium, test_regen
from tests.test_torch_scene import (jax_scene_arrays, to_jax_config,
                                    to_torch_config, torch_scene_arrays)


def slab(sigma_a=0.3, sigma_s=0.5, spp=4, depth_max=4):
    cfg = test_medium.TestVolpathRender()._slab_cfg(
        sigma_a=sigma_a, sigma_s=sigma_s, spp=spp)
    cfg.integrator.depth_max = depth_max
    return to_torch_config(cfg)


def medium_box(spp=4, depth_max=2):
    return to_torch_config(
        test_regen.TestVolpathRegen()._medium_box(spp, depth_max))


def _both(cfg, **kw):
    """(port, reference) renders of a port-IR config on the CPU."""
    ref = np.asarray(JaxRenderer(to_jax_config(cfg)).render(**kw))
    got = Renderer(cfg, device="cpu").render(**kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return got, ref


def _close_share(got, ref):
    return np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1).mean()


def _mean_rel(got, ref):
    return np.abs(got.mean(axis=(0, 1)) / ref.mean(axis=(0, 1)) - 1.0).max()


LOW_DEPTH = {
    "slab": lambda: slab(),
    "medium_box": lambda: medium_box(),
    "volcaustic_isotropic": lambda: volumetric_caustic(res=16, spp=4,
                                                       depth_max=2),
    "volcaustic_hg": lambda: volumetric_caustic(res=16, spp=4, depth_max=2,
                                                phase="hg", g=-0.5),
}


@pytest.mark.parametrize("name", sorted(LOW_DEPTH))
def test_volpath_regen_matches_reference_per_pixel(name):
    got, ref = _both(LOW_DEPTH[name](), tile=256)
    assert ref.mean() > 0.01
    assert _close_share(got, ref) >= 0.99
    assert _mean_rel(got, ref) <= 1e-4


@pytest.mark.parametrize("name,make,min_share", [
    ("volcaustic", lambda: volumetric_caustic(res=16, spp=16), 0.75),
    ("medium_box", lambda: medium_box(spp=16, depth_max=6), 0.95),
])
def test_volpath_full_depth_statistically(name, make, min_share):
    got, ref = _both(make(), tile=256)
    sigma = ref.reshape(-1, 3).std(axis=0) / np.sqrt(ref.shape[0] * ref.shape[1])
    assert (np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
            <= 3 * sigma).all()
    assert _close_share(got, ref) >= min_share


def test_path_integrator_through_a_null_shell_per_pixel():
    cfg = slab(sigma_a=0.8, sigma_s=0.0)
    cfg.integrator.itype = "path"  # the shell's medium is ignored
    got, ref = _both(cfg, tile=64)
    assert ref[4, 4].mean() > 1.0  # the wall, unattenuated
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_glass_paths_split_only_by_xla_fusion():
    """The volumetric-caustic scene's glass sphere by the path integrator
    (no media, 16x16, 1 spp, depth 6): every pixel of the port's render
    equals the reference's when the reference runs op by op under
    jax.disable_jit, so that XLA fuses nothing."""
    import jax

    cfg = volumetric_caustic(res=16, spp=1, depth_max=6)
    cfg.integrator.itype = "path"
    cfg.media = []
    cfg.instances[1].id_medium_int = -1
    cfg.instances[2].id_medium_ext = -1
    got = Renderer(cfg, device="cpu").render(tile=256)
    with jax.disable_jit():
        ref = np.asarray(JaxRenderer(to_jax_config(cfg)).render(tile=256))
    assert ref.mean() > 0.01
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_beer_lambert_through_null_slab():
    img = Renderer(slab(sigma_a=0.8, sigma_s=0.0, spp=16, depth_max=6),
                   device="cpu").render(tile=64)
    np.testing.assert_allclose(img[4, 4], 2.0 * np.exp(-0.8), rtol=2e-2)


def test_no_medium_matches_path():
    imgs = []
    for itype in ("volpath", "path"):
        cfg = slab(sigma_a=0.0, sigma_s=0.0, spp=16, depth_max=6)
        cfg.instances[1].id_medium_int = -1
        cfg.integrator.itype = itype
        imgs.append(Renderer(cfg, device="cpu").render(tile=64))
    for img in imgs:
        np.testing.assert_allclose(img[4, 4], 2.0, rtol=1e-3)


def test_reference_medium_scene_carried_across_renders_the_same():
    cfg = medium_box(spp=2, depth_max=4)
    rebuilt = scene_from_arrays(
        jax_scene_arrays(jax_compile_scene(to_jax_config(cfg))), device="cpu",
        quad_kinds=((KIND_SPHERE, False),))
    r = Renderer(cfg, device="cpu")
    want = torch_scene_arrays(r.scene)
    for key, value in torch_scene_arrays(rebuilt).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    assert rebuilt.all_opaque == r.scene.all_opaque is False
    direct = r.render(tile=64)
    r.scene = rebuilt
    assert direct.mean() > 0.05
    np.testing.assert_array_equal(r.render(tile=64), direct)


def test_volumetric_caustic_takes_the_dense_route_unbatched():
    """16 triangles (12 of them the fog's null shell) and the glass
    sphere's quadric row: the dense sweep, the unbatched regen body; the
    shell's bottom face stands above the floor; the camera is outside
    the fog."""
    r = Renderer(volumetric_caustic(res=8, spp=1), device="cpu")
    s = r.scene
    g = s.geom
    assert s.geom.packed_tris.shape[0] <= DENSE_MAX_PRIMS
    assert not _use_batched_trace(s) and not s.all_opaque
    assert int(g.opaque.sum()) == 4 and s.quad_kinds == ((KIND_SPHERE, True),)
    shell = r.config.instances[1].to_world
    assert shell[1, 3] - shell[1, 1] > 0.0  # bottom face above the floor
    eye = r.config.camera.eye
    assert (np.abs(eye - shell[:3, 3]) > np.diag(shell)[:3]).any()


def test_volpath_regen_is_tile_and_chunk_independent():
    """Per-sample seeds are pure f(pixel, k): a tile split renders the
    identical image, an spp-chunk split the same samples summed in
    another order (tests/test_regen.py's tolerance, atol 1e-6)."""
    r = Renderer(volumetric_caustic(res=8, spp=4, depth_max=6), device="cpu")
    a = r.render(tile=64, spp_chunk=4)
    np.testing.assert_array_equal(r.render(tile=24, spp_chunk=4), a)
    np.testing.assert_allclose(r.render(tile=64, spp_chunk=3), a, atol=1e-6)
    assert a.mean() > 0.01
