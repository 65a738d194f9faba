"""Renders of the port's emitter, texture, opacity and quadric features
against mcpt_tpu, on the CPU.

* Direct light (depth 2), per pixel, against the reference's render of
  the same scene:
  - `lights_showcase` at 16x16, 4 spp (the dense route, the unbatched
    body, six shadow queries a vertex with the alpha walk, 43 draws):
    at least 99% of pixels within rtol 1e-4, atol 1e-5, channel means
    within 1e-3 relative (all 256 pixels agree on this tree).  A
    draw-layout fault moves every later draw and so nearly every pixel
    (a mutation that swapped the alpha tail and the RR coins left 41%).
    The share allowed is for NEE samples near an emissive sphere's
    silhouette: the shadow ray meets the sphere itself at a root whose
    rounding error grows as 1/r, and XLA's contracted multiply-adds and
    torch's separate roundings can decide that self-occlusion apart
    (with a light of radius 0.02 in the scene, 3 of 256 pixels did);
  - `envmap_matpreview` at 16x16, 4 spp (the block march, the batched
    body, the envmap's alias table) without its bump map: 99% of pixels
    within rtol 1e-4, atol 1e-5 (bilinear texel edges of the floor's
    bitmap); with it, every pixel within rtol 1e-2, atol 5e-3 and channel
    means within 1e-4 relative: the bump's forward difference at 1e-4
    multiplies ulps by 1e4.
* Full depth (8), `envmap_matpreview` at 16x16, 8 spp: channel means
  within 3 sigma of the Monte Carlo error of the mean; 90% of pixels
  within rtol 1e-3, atol 1e-4 (paths that a bump-map ulp turned go on
  apart).
* The reference's feature checks (tests/test_features.py,
  tests/test_emitter.py) made in the port: opacity transmission through
  a black mask, a fully opaque mask, NEE through an alpha-masked
  occluder (per pixel against the reference, and 1 - alpha within 25%
  at 32 spp), the SHADOW_ALPHA_K boundary (four transparent masks pass,
  an occluder behind them leaks, and is seen at SHADOW_ALPHA_K = 6), and
  the point light's closed form at MCPT_NEE_RR_TAU = 0.
* The no_lights repair: a floor lit by a point light alone renders the
  reference's image at depth 3 (with the old test, only the area lights
  counted, every path stopped at depth 1 and the image was black).
"""

import numpy as np
import pytest

from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.scene.ir import EmitterInfo, EmitterType
from mcpt_tpu_torch.integrators import path as TP
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import envmap_matpreview, lights_showcase
from tests.test_emitter import floor_scene, pixel_hit_points
from tests.test_features import (_ceiling_light_floor_scene,
                                 wall_through_mask_scene)
from tests.test_torch_scene import to_jax_config, to_torch_config


def _both(cfg, **kw):
    """(port, reference) renders of a port-IR config on the CPU."""
    ref = np.asarray(JaxRenderer(to_jax_config(cfg)).render(**kw))
    got = Renderer(cfg, device="cpu").render(**kw)
    assert got.shape == ref.shape
    return got, ref


def _close_share(got, ref, rtol=1e-4, atol=1e-5):
    return np.isclose(got, ref, rtol=rtol, atol=atol).all(axis=-1).mean()


def _mean_rel(got, ref):
    return np.abs(got.mean(axis=(0, 1)) / ref.mean(axis=(0, 1)) - 1.0).max()


def test_lights_scene_direct_light_matches_reference_per_pixel():
    cfg = lights_showcase(res=16, spp=4, depth_max=2)
    got, ref = _both(cfg, tile=256)
    assert ref.mean() > 0.05
    assert _close_share(got, ref) >= 0.99
    assert _mean_rel(got, ref) <= 1e-3


@pytest.mark.parametrize("bump", [False, True])
def test_envmap_scene_direct_light_matches_reference_per_pixel(bump):
    cfg = envmap_matpreview(res=16, spp=4, depth_max=2)
    if not bump:
        cfg.bsdfs[1].id_bump_map = -1
    got, ref = _both(cfg, tile=256)
    assert ref.mean() > 0.1
    if bump:
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=5e-3)
        assert _mean_rel(got, ref) <= 1e-4
    else:
        assert _close_share(got, ref) >= 0.99


def test_envmap_scene_full_depth_statistically():
    cfg = envmap_matpreview(res=16, spp=8, depth_max=8)
    got, ref = _both(cfg, tile=256)
    sigma = ref.reshape(-1, 3).std(axis=0) / np.sqrt(ref.shape[0] * ref.shape[1])
    assert (np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
            <= 3 * sigma).all()
    assert _close_share(got, ref, rtol=1e-3, atol=1e-4) >= 0.9


def _port(cfg_jax, **kw):
    return Renderer(to_torch_config(cfg_jax), device="cpu").render(tile=64, **kw)


@pytest.mark.parametrize("alpha", [0.25, 0.75])
def test_opacity_transmission(alpha):
    """E[L] = (1 - alpha) * the wall's radiance through a black mask."""
    img = _port(wall_through_mask_scene(alpha))
    np.testing.assert_allclose(img[4, 4], (1.0 - alpha) * 2.0, rtol=0.1)


def test_fully_opaque_mask_blocks():
    assert _port(wall_through_mask_scene(1.0, spp=8))[4, 4].max() < 1e-5


def test_nee_through_alpha_masked_occluder_matches_reference():
    """Only NEE shadow rays cross the mask (alpha 0.7): the port's image
    equals the reference's pixel for pixel, and is 1 - alpha of the
    unmasked floor's within 25% at 32 spp (the reference's own test
    holds 15% at 512 spp)."""
    got, ref = _both(to_torch_config(_ceiling_light_floor_scene(0.7, spp=32)),
                     tile=64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    base = _port(_ceiling_light_floor_scene(None, spp=32))
    np.testing.assert_allclose(got[4, 4].mean() / base[4, 4].mean(), 0.3,
                               rtol=0.25)


def test_shadow_alpha_k_boundary(monkeypatch):
    base = _port(_ceiling_light_floor_scene(None, spp=64))
    four = _port(_ceiling_light_floor_scene(0.0, spp=64, n_screens=4))
    np.testing.assert_allclose(four[4, 4].mean() / base[4, 4].mean(), 1.0,
                               rtol=0.1)
    capped = _ceiling_light_floor_scene(0.0, spp=64, n_screens=4,
                                        opaque_cap_y=1.5)
    assert TP.SHADOW_ALPHA_K == 4
    assert _port(capped)[4, 4].mean() > 0.5 * base[4, 4].mean()  # leaks
    monkeypatch.setattr(TP, "SHADOW_ALPHA_K", 6)
    assert _port(capped)[4, 4].max() < 1e-5


def _point_floor(spp=16, depth_max=2):
    return floor_scene(EmitterInfo(
        etype=EmitterType.POINT, position=np.array([1.0, 2.0, 0.5], np.float32),
        intensity=np.array([10.0, 10.0, 10.0], np.float32)),
        spp=spp, depth_max=depth_max)


def test_point_light_closed_form(monkeypatch):
    """Lo = albedo / pi * I cos(theta) / d^2 per pixel, at tau 0."""
    monkeypatch.setenv("MCPT_NEE_RR_TAU", "0")
    cfg = _point_floor()
    img = _port(cfg)
    v = np.array([1.0, 2.0, 0.5])[None, None] - pixel_hit_points(cfg)
    d2 = (v ** 2).sum(-1)
    expected = 0.75 / np.pi * 10.0 * (v[..., 1] / np.sqrt(d2)) / d2
    np.testing.assert_allclose(img[..., 0], expected, rtol=5e-2, atol=2e-3)


def test_point_light_alone_lights_past_depth_one():
    """The no_lights repair: lit by a point light alone, the port renders
    the reference's image at depth 3, pixel for pixel."""
    cfg = to_torch_config(_point_floor(spp=4, depth_max=3))
    got, ref = _both(cfg, tile=64)
    assert ref.mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
