"""Slice 2 as a whole: Renderer.render of a scene above DENSE_MAX_PRIMS —
tests/test_batched_regen.py's box with a 21632-triangle floor — through
the port's march and pair routes on the CPU, against
mcpt_tpu.render.renderer.Renderer from the same seeds.

Both packages run with MCPT_BATCH_TRACE=0 here, so both take the
unbatched regen body; the batched body, which both take on this scene by
default, is held to the reference's and to the unbatched one in
tests/test_torch_batched.py.

* Direct light (depth_max=2): per pixel, rtol 1e-4, atol 1e-5, on every
  pixel: the sample streams are the same, only f32 rounding differs.
* Full depth: channel means within 3 sigma of the Monte Carlo error of
  the mean, and 99% of pixels within rtol 1e-3, atol 1e-4 (a rounding
  difference can, rarely, flip one sampling decision deep in a path).
"""

import numpy as np
import pytest

from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu_torch.ops import traversal as TT
from mcpt_tpu_torch.render.renderer import Renderer
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_torch_scene import to_torch_config


def _both(monkeypatch, route, cfg, **kw):
    monkeypatch.setenv("MCPT_BATCH_TRACE", "0")
    monkeypatch.setenv("MCPT_TRAVERSAL", route)
    ref = np.asarray(JaxRenderer(cfg).render(**kw))
    r = Renderer(to_torch_config(cfg), device="cpu")
    assert r.scene.geom.packed_tris.shape[0] > TT.DENSE_MAX_PRIMS
    assert TT.resolved_strategy(r.scene.geom) == route
    return r.render(**kw), ref


@pytest.mark.parametrize("route", ["march", "pairs"])
def test_direct_light_matches_reference_per_pixel(monkeypatch, route):
    got, ref = _both(monkeypatch, route,
                     make_mesh_box_scene(spp=4, res=12, depth_max=2), tile=144)
    assert got.shape == ref.shape == (12, 12, 3)
    assert ref.mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("route", ["march", "pairs"])
def test_full_depth_matches_reference_statistically(monkeypatch, route):
    got, ref = _both(monkeypatch, route,
                     make_mesh_box_scene(spp=8, res=12, depth_max=8),
                     tile=144, spp_chunk=4)
    assert np.isfinite(got).all() and (got >= 0).all()
    n_pix = got.shape[0] * got.shape[1]
    sigma = ref.reshape(n_pix, 3).std(axis=0) / np.sqrt(n_pix)
    diff = np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
    assert (diff <= 3 * sigma).all(), (diff, sigma)
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99
