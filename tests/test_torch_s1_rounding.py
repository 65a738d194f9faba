"""Finding S1 (ROADMAP section 3): the two features that turn rounding into
pixels, at the scale where card and CPU renders first parted, held to
mcpt_tpu statistically on the CPU.

`bump_and_bead` has a diffuse cube with a ripple bump map and, beside it,
an emissive sphere of radius 0.02, its only area light (and a dim sky).
The bump's forward difference at 1e-4 scales a texture length's rounding
by 1e4; a shadow ray toward a point near the small sphere's silhouette
meets the sphere itself at a root whose rounding grows as 1/r.  Rounding
may therefore split single paths apart, but not move the estimate:

* full depth (8), 16x16, 16 spp: channel means within 3 sigma of the
  Monte Carlo error of the reference's mean (sigma = the pixels'
  standard deviation / sqrt(pixels)); pixels within rtol 1e-3, atol 1e-4
  on at least 90% (96-97% on this tree);
* direct light (depth 2), 16x16, 4 spp: pixels within rtol 1e-4, atol
  1e-5 on at least 99% (254 of 256 on this tree, the rest near the
  sphere's silhouette) and channel means within 1e-4 relative.

Both at the bump height of the envmap scene (amplitude 0.02, values near
0) and at RIPPLE_HEIGHT (0.5, values 0.025 to 1.025, a bitmap's full
range).  chip_smoke's s1-means phase holds the card to the CPU on the
same scene by the channel means.
"""

import numpy as np
import pytest

from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.builtin import RIPPLE_HEIGHT, bump_and_bead
from tests.test_torch_scene import to_jax_config

AMPLITUDES = [0.02, RIPPLE_HEIGHT]


def _both(cfg):
    ref = np.asarray(JaxRenderer(to_jax_config(cfg)).render(tile=256))
    got = Renderer(cfg, device="cpu").render(tile=256)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return got, ref


def _share(got, ref, rtol, atol):
    return np.isclose(got, ref, rtol=rtol, atol=atol).all(axis=-1).mean()


@pytest.mark.parametrize("amplitude", AMPLITUDES)
def test_full_depth_means_within_3_sigma(amplitude):
    got, ref = _both(bump_and_bead(res=16, spp=16, amplitude=amplitude))
    sigma = ref.reshape(-1, 3).std(axis=0) / np.sqrt(ref.shape[0] * ref.shape[1])
    assert ref.mean() > 0.1
    assert (np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
            <= 3 * sigma).all()
    assert _share(got, ref, 1e-3, 1e-4) >= 0.9


@pytest.mark.parametrize("amplitude", AMPLITUDES)
def test_direct_light_per_pixel(amplitude):
    got, ref = _both(bump_and_bead(res=16, spp=4, depth_max=2,
                                   amplitude=amplitude))
    assert _share(got, ref, 1e-4, 1e-5) >= 0.99
    assert np.abs(got.mean(axis=(0, 1)) / ref.mean(axis=(0, 1)) - 1).max() \
        <= 1e-4


def test_scene_holds_both_features_at_scale():
    r = Renderer(bump_and_bead(res=8, spp=1), device="cpu")
    s = r.scene
    light = [i for i in r.config.instances if i.shape == "sphere"]
    assert len(light) == 1 and light[0].radius == 0.02
    assert s.n_emissive == 1 and s.em_quad_cells and s.has_bump
    bump = r.config.textures.bitmap_pixels(r.config.bsdfs[0].id_bump_map)
    # texel centers: within the ripple's range [0.05, 2.05] x the height,
    # and spanning 97% of it
    assert 0.05 * RIPPLE_HEIGHT <= bump.min() < 0.06 * RIPPLE_HEIGHT
    assert 2.04 * RIPPLE_HEIGHT < bump.max() <= 2.05 * RIPPLE_HEIGHT
