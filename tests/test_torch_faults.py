"""Faults F1 and F2 of the port (ROADMAP section 3), repaired, against the
reference on the CPU.

* F1: RendererConfig.perf knobs become MCPT_* environment defaults before
  the scene commit, as in the reference's Renderer: the same route, the
  same chunk pack (leaf for leaf, exact) and the same K2 group count;
  explicit environment variables still win.
* F2: MCPT_NEE_RR_TAU is read as the reference reads it.  At tau 0 the
  shadow-ray coin is not drawn, so the draw count drops by one, and the
  direct-light Cornell render still agrees with the reference's per pixel
  at tau 0 and 0.05 (the tolerance of tests/test_torch_render.py: rtol
  1e-4, atol 1e-5 on 99% of pixels, the rest being wall seams).
  MCPT_ENGINE=chunked, which the port refused until it had the chunked
  engine, now renders the reference's chunked image, pixel for pixel at
  the same tolerance.

The reference's Renderer writes its knobs into os.environ for good, so
every test here restores the environment it found.
"""

import os

import jax
import numpy as np
import pytest

import mcpt_tpu.ops.traversal as JT
from mcpt_tpu.integrators.path import nee_draw_count as jax_nee_draw_count
from mcpt_tpu.ops.pallas_march import _chunk_group as jax_chunk_group
from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu_torch.integrators.path import nee_draw_count
from mcpt_tpu_torch.ops import march_sweep as msw
from mcpt_tpu_torch.ops import traversal as TT
from mcpt_tpu_torch.render.renderer import Renderer
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_torch_march import _assert_pack_equal
from tests.test_torch_scene import (
    cornell_torch_config,
    to_jax_config,
    to_torch_config,
)

KNOBS = ("MCPT_TRAVERSAL", "MCPT_MARCH_LEAF", "MCPT_MARCH_GROUP",
         "MCPT_NEE_RR_TAU", "MCPT_ENGINE")


@pytest.fixture
def clean_env():
    """The knobs unset for the test; os.environ as it was afterwards."""
    saved = dict(os.environ)
    for k in KNOBS:
        os.environ.pop(k, None)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _knobs():
    return {k: os.environ.get(k) for k in KNOBS}


@pytest.mark.parametrize("perf", [{"traversal": "pairs", "march_leaf": 64},
                                  {"march_group": 512}],
                         ids=["traversal-leaf", "group"])
def test_perf_knobs_route_and_pack_as_the_reference(clean_env, perf):
    cfg = make_mesh_box_scene()
    cfg.perf = dict(perf)
    port = Renderer(to_torch_config(cfg), device="cpu")
    env_port = _knobs()
    for k in KNOBS:
        os.environ.pop(k, None)
    ref = JaxRenderer(cfg)
    assert _knobs() == env_port  # the same knobs, the same mangling
    assert all(env_port[f"MCPT_{k.upper()}"] == str(v) for k, v in perf.items())
    tg, jg = port.scene.geom, ref.scene.geom
    assert TT.resolved_strategy(tg) == JT.resolved_strategy(jg)
    _assert_pack_equal(tg, jg)
    ls = tg.march_leaf
    assert msw.chunk_group(ls) == jax_chunk_group(ls, 256)
    if "traversal" in perf:
        assert TT.resolved_strategy(tg) == "pairs" and ls == 64
    else:
        assert msw.chunk_group(ls) == 512 // ls


def test_explicit_env_beats_perf(clean_env):
    os.environ["MCPT_MARCH_LEAF"] = "128"
    cfg = make_mesh_box_scene()
    cfg.perf = {"march_leaf": 64}
    assert Renderer(to_torch_config(cfg), device="cpu").scene.geom.march_leaf == 128


@pytest.mark.parametrize("tau", ["0", "0.05"])
def test_direct_light_streams_match_reference_at_tau(clean_env, tau):
    os.environ["MCPT_NEE_RR_TAU"] = tau
    jax.clear_caches()  # the reference reads tau while it traces
    tcfg = cornell_torch_config(res=16, spp=4, depth_max=2)
    jr = JaxRenderer(to_jax_config(tcfg))
    port = Renderer(tcfg, device="cpu")
    assert (nee_draw_count(port.scene) == jax_nee_draw_count(jr.scene)
            == (3 if tau == "0" else 4))
    ref = np.asarray(jr.render(tile=256))
    got = port.render(tile=256)
    assert ref.mean() > 0.05
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99


def test_chunked_engine_renders_as_the_reference(clean_env):
    os.environ["MCPT_ENGINE"] = "chunked"
    tcfg = cornell_torch_config(res=16, spp=4, depth_max=2)
    ref = np.asarray(JaxRenderer(to_jax_config(tcfg)).render(tile=256))
    got = Renderer(tcfg, device="cpu").render(tile=256)
    regen = Renderer(tcfg, device="cpu").render(tile=256, engine="regen")
    assert ref.mean() > 0.05
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
    assert not np.array_equal(got, regen)  # the engines seed otherwise
