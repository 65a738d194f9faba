"""The unbatched regen body's CUDA graph (integrators/path.py::
_regen_graphed), what can be held on the CPU: the rule that decides
where it engages, the route it reads, the counter of replayed
iterations, and that one iteration of the body dispatches nothing a
graph's capture refuses (a host read of a device value, a copy of host
data to the device, a size known only on the device).  The capture, the
replays and their films are checked on the card
(tests/test_torch_graph_cuda.py)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.integrators import path
from mcpt_tpu_torch.ops import dense_sweep, march_sweep, packet_sweep
from mcpt_tpu_torch.ops.traversal import route
from mcpt_tpu_torch.render import renderer as renderer_mod
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene import builtin

ROUTES = ("dense", "march", "packet", "pairs")


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_graph_engages_on_cuda_for_the_unbatched_body_off_the_pair_route(
        device_type, batched, route_name):
    want = device_type == "cuda" and not batched and route_name != "pairs"
    assert path.graph_engages(device_type, batched, route_name) is want


@pytest.mark.parametrize("make, traversal, want", [
    (builtin.cornell_box, None, "dense"),
    (builtin.cornell_box, "pairs", "dense"),  # the dense sweep wins
    (builtin.cornell_mesh_march, None, "march"),
    (builtin.cornell_mesh_march, "packet", "packet"),
    (builtin.cornell_mesh_pairs, None, "pairs"),
])
def test_route_names_the_traversal_the_rays_take(monkeypatch, make, traversal,
                                                 want):
    if traversal is not None:
        monkeypatch.setenv("MCPT_TRAVERSAL", traversal)
    r = Renderer(make(res=8, spp=1), device="cpu")
    assert route(r.scene.geom) == want


@pytest.fixture
def fresh():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def test_more_work_counts_replayed_iterations(fresh):
    live = torch.tensor([True, False, True])
    dead = torch.zeros(3, dtype=torch.bool)
    assert path.more_work(live, "t", replay=True) is True
    trace.enable()
    assert path.more_work(live, "t") is True
    assert path.more_work(live, "t", replay=True) is True
    assert path.more_work(dead, "t", replay=True) is False
    c = trace.snapshot()["counters"]
    assert c["path.iterations"] == 2
    assert c["path.graph_iterations"] == 1


def test_eager_regen_replays_nothing(fresh):
    r = Renderer(builtin.cornell_box(res=8, spp=2, depth_max=4),
                 device="cpu")
    trace.enable()
    r.render(spp=2, tile=64)
    c = trace.snapshot()["counters"]
    assert c["path.iterations"] > 0
    assert c["path.graph_iterations"] == 0
    assert r.scene.graphs == {}


def test_tile_retry_drops_the_scenes_graphs(monkeypatch):
    """A tile lost to a device fault is rendered again with the scene's
    graphs dropped: the fault may have struck inside a replay."""
    r = Renderer(builtin.cornell_box(res=8, spp=1, depth_max=4),
                 device="cpu")
    want = r.render(spp=1, tile=64)
    r.scene.graphs["stale"] = object()
    tile_fn = renderer_mod.render_tile_regen
    lost = []

    def flaky(*a, **kw):
        if not lost:
            lost.append(1)
            raise RuntimeError("device fault")
        return tile_fn(*a, **kw)

    monkeypatch.setattr(renderer_mod, "render_tile_regen", flaky)
    with pytest.warns(UserWarning, match="re-rendering"):
        got = r.render(spp=1, tile=64)
    assert r.scene.graphs == {}
    assert np.array_equal(got, want)


class _Refused(TorchDispatchMode):
    """Records the ops that a CUDA graph's capture refuses on the card:
    a read of a device value on the host, a tensor made from host data
    (a copy to the device there), and the ops whose output size is known
    only on the device.  `paused` lets the traversal's plain versions,
    which run on the CPU alone, through."""

    SYNCS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten.lift_fresh", "aten._unique2", "aten.unique_consecutive",
             "aten.unique_dim", "aten.repeat_interleave"}

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not self.paused:
            masked = name in ("aten.index", "aten.index_put", "aten.index_put_") \
                and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in (args[1] if len(args) > 1 else ()) or ())
            if name in self.SYNCS or masked:
                self.found.append(name)
        return func(*args, **(kwargs or {}))


def _paused(mode, fn):
    def run(*a, **kw):
        mode.paused = True
        try:
            return fn(*a, **kw)
        finally:
            mode.paused = False
    return run


@pytest.mark.parametrize("make, env", [
    (builtin.cornell_box, {}),
    (builtin.lights_showcase, {}),    # analytic lights, quadrics, alpha walk
    (builtin.bump_and_bead, {}),      # bump maps, an emissive sphere
    (builtin.envmap_matpreview, {"MCPT_BATCH_TRACE": "0"}),  # envmap, march
    (builtin.cornell_mesh_march, {"MCPT_BATCH_TRACE": "0", "MCPT_COH": "1"}),
    (builtin.cornell_mesh_march, {"MCPT_BATCH_TRACE": "0",
                                  "MCPT_TRAVERSAL": "packet"}),
])
def test_regen_iteration_dispatches_nothing_a_capture_refuses(
        monkeypatch, make, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r = Renderer(make(res=8, spp=2), device="cpu")
    scene = r.scene
    assert not path._use_batched_trace(scene)
    assert path.graph_engages("cuda", False, route(scene.geom))
    mode = _Refused()
    monkeypatch.setattr(dense_sweep, "dense_sweep_plain",
                        _paused(mode, dense_sweep.dense_sweep_plain))
    monkeypatch.setattr(march_sweep, "march_sweep_plain",
                        _paused(mode, march_sweep.march_sweep_plain))
    monkeypatch.setattr(packet_sweep, "packet_sweep_plain",
                        _paused(mode, packet_sweep.packet_sweep_plain))
    reg = path._Regen(torch.arange(64), 12345, 2, 2, 0)
    n_nee = path.nee_draw_count(scene)
    use_coh = path._use_origin_chunk(scene)
    assert use_coh == ("MCPT_COH" in env)

    def step(st):
        return path._regen_step(scene, r.integrator, r.camera, reg, st,
                                n_nee, r.integrator.depth_max, use_coh)

    # the first iteration runs eagerly on the card too: lazily made
    # tables (quadric row indices) settle there
    st = step(path._regen_start(reg))
    with mode:
        st = step(st)
    assert st.alive.any()
    assert mode.found == []
