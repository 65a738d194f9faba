"""The unbatched regen body replayed as a CUDA graph (integrators/path.py::
_regen_graphed) against the same body run eagerly, on the card: films
and seeds bit for bit, the traversal's launch counters equal, one
capture a key and its replays reused, and the bodies and routes it
leaves eager.  Every test here is marked `cuda` and skips without a
CUDA device; the file imports neither JAX nor mcpt_tpu:

    python -m pytest -m cuda tests/test_torch_graph_cuda.py
"""

import numpy as np
import pytest
import torch

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.integrators import path
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene import builtin


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def traced():
    """Tracing on (the wavefront's counters count), off afterwards."""
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def _launches():
    return [getattr(m, a) for m, a in path._LAUNCH_COUNTERS]


def _calls(monkeypatch, renderer, pix, spp, bases, graphed, **kw):
    """shade_regen over `bases` (frame bases), graphed or eager: the
    (film, seed) of each call, the launch counters' and the wavefront
    counters' moves, and the captures made."""
    captures = []
    capture = path._RegenGraph.capture

    def counted(self, advance):
        captures.append(self)
        return capture(self, advance)

    c0, i0 = _launches(), (path.iterations, path.graph_iterations)
    with monkeypatch.context() as m:
        m.setattr(path._RegenGraph, "capture", counted)
        if not graphed:
            m.setattr(path, "graph_engages", lambda *a: False)
        out = [path.shade_regen(renderer.scene, renderer.integrator,
                                renderer.camera, pix, spp, frame_base=b, **kw)
               for b in bases]
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(c0, _launches())]
    iters = (path.iterations - i0[0], path.graph_iterations - i0[1])
    return out, moved, iters, captures


def _assert_bit_equal(monkeypatch, renderer, pix, spp, bases, **kw):
    """Graphed and eager calls over `bases`: equal films, seeds and
    launch counts; the graphed calls capture once and replay every
    iteration but the first call's first.  Returns the graphed calls'
    wavefront iterations."""
    got, moved_g, (it_g, rep_g), caps = _calls(
        monkeypatch, renderer, pix, spp, bases, True, **kw)
    want, moved_e, (it_e, rep_e), _ = _calls(
        monkeypatch, renderer, pix, spp, bases, False, **kw)
    for (fg, sg), (fe, se) in zip(got, want):
        assert torch.equal(fg, fe)
        assert torch.equal(sg, se)
    assert moved_g == moved_e
    assert sum(moved_g) > 0
    assert len(caps) == 1
    assert it_g == it_e > len(bases)
    assert rep_g == it_g - 1 and rep_e == 0
    return it_g


@pytest.mark.cuda
def test_whole_film_replays_one_capture_bit_equal_to_eager(monkeypatch,
                                                           traced):
    """The preview's shape: the whole 1024x1024 film as one batch of 2^20
    lanes at 1 spp, three passes of other frame bases (the last past
    2^31): one capture, reused."""
    dev = _cuda()
    r = Renderer(builtin.cornell_box(res=1024, spp=1, depth_max=65),
                 device=dev)
    pix = torch.arange(1 << 20, device=dev)
    _assert_bit_equal(monkeypatch, r, pix, 1, [0, 7, (1 << 31) + 5])
    assert len(r.scene.graphs) == 1


@pytest.mark.cuda
def test_tile_at_8_spp_bit_equal_to_eager(monkeypatch, traced):
    """The command line's default 64k tile at 8 spp, as the second spp
    chunk of 16, over two tiles: the pixel indices are a per-call
    input."""
    dev = _cuda()
    r = Renderer(builtin.cornell_box(res=512, spp=16), device=dev)
    n = 1 << 16
    for tile in range(2):
        pix = torch.arange(tile * n, (tile + 1) * n, device=dev)
        got, _, _, _ = _calls(monkeypatch, r, pix, 8, [3], True,
                              spp_total=16, sample_offset=8)
        want, _, _, _ = _calls(monkeypatch, r, pix, 8, [3], False,
                               spp_total=16, sample_offset=8)
        assert torch.equal(got[0][0], want[0][0])
        assert torch.equal(got[0][1], want[0][1])
    assert len(r.scene.graphs) == 1


@pytest.mark.cuda
def test_renderer_film_bit_equal_to_eager(monkeypatch):
    """Through the facade: Renderer.render's film, graphed and eager."""
    dev = _cuda()
    r = Renderer(builtin.cornell_box(res=256, spp=4), device=dev)
    got = r.render(spp=4, tile=1 << 16, frame_base=11)
    with monkeypatch.context() as m:
        m.setattr(path, "graph_engages", lambda *a: False)
        want = r.render(spp=4, tile=1 << 16, frame_base=11)
    assert np.array_equal(got, want)
    assert len(r.scene.graphs) == 1


@pytest.mark.cuda
def test_march_route_unbatched_bit_equal_to_eager(monkeypatch, traced):
    """The march route (K2 behind its ray sort) in the unbatched body."""
    monkeypatch.setenv("MCPT_BATCH_TRACE", "0")
    dev = _cuda()
    r = Renderer(builtin.cornell_mesh_march(res=256, spp=2), device=dev)
    assert path.route(r.scene.geom) == "march"
    _assert_bit_equal(monkeypatch, r, torch.arange(1 << 16, device=dev), 2,
                      [5, 6])


@pytest.mark.cuda
def test_opacity_maps_bit_equal_to_eager(monkeypatch, traced):
    """Alpha masks (the shadow rays' alpha walk), analytic lights and
    quadrics: the lights showcase."""
    dev = _cuda()
    r = Renderer(builtin.lights_showcase(res=256, spp=2), device=dev)
    assert r.scene.has_opacity and r.scene.quad_kinds
    _assert_bit_equal(monkeypatch, r, torch.arange(1 << 16, device=dev), 2,
                      [1, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("make", [
    builtin.cornell_mesh_pairs,   # the pair route
    builtin.cornell_mesh_march,   # the batched body
])
def test_pair_route_and_batched_body_stay_eager(monkeypatch, traced, make):
    dev = _cuda()
    r = Renderer(make(res=128, spp=2), device=dev)
    _, moved, (iters, replays), caps = _calls(
        monkeypatch, r, torch.arange(1 << 14, device=dev), 2, [0], True)
    assert iters > 0 and replays == 0
    assert caps == [] and r.scene.graphs == {}
    assert sum(moved) > 0
