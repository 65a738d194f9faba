"""The configurations parse, through the program's own front end, to
their stated triangle counts, routes and regen bodies."""

import tempfile

import pytest

from portbench.harness import Cell
from portbench.scene import write_mitsuba


@pytest.mark.parametrize("cell", ["cornell-box.preview",
                                  "gold-sphere.film"])
def test_config_parses_to_its_route(cell):
    from mcpt_tpu_torch.integrators import path
    from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS, resolved_strategy
    from mcpt_tpu_torch.scene.compile import compile_scene
    from mcpt_tpu_torch.scene.parser import load_config

    c = Cell(cell)
    scene = c.scene()
    with tempfile.TemporaryDirectory() as tmp:
        config = load_config(write_mitsuba(scene, tmp))
    assert (config.camera.width, config.camera.height) == tuple(c.cfg["film"])
    assert config.camera.spp == c.cfg["spp"]
    assert config.integrator.depth_max == c.cfg["max_depth"]
    assert config.integrator.depth_rr == c.cfg["rr_depth"]
    assert sum(len(i.mesh.indices) for i in config.instances) == c.cfg["triangles"]
    committed = compile_scene(config, "cpu")
    route = ("dense" if committed.geom.packed_tris.shape[0] <= DENSE_MAX_PRIMS
             else resolved_strategy(committed.geom))
    assert route == c.cfg["route"]
    assert path._use_batched_trace(committed) == c.cfg["batched_body"]


def test_stated_counts():
    assert Cell("cornell-box.preview").scene().n_triangles == 36
    mat = Cell("gold-sphere.film").scene()
    assert [len(m.faces) for m in mat.meshes] == [61440, 12, 2]
