"""The film sharded over a mesh of devices and the train step over it
(mcpt_tpu_torch/parallel/shard.py) on the CPU, against one device and
against mcpt_tpu's parallel/shard.py on its 8-device CPU mesh.

* render_film_sharded over [cpu] * k (k = 1, 2, 3; 256 pixels, so k = 3
  pads) is bit-equal to one render_pixels call over every pixel: each
  pixel's stream is a function of (pixel, frame) alone.
* A mesh of two distinct devices runs their shards at once (a thread
  each): the film bit-equal, the step as one device's.
* Against the reference's render_film_sharded: per pixel within rtol
  1e-4, atol 1e-5 on at least 99% of pixels, the share the port's
  box-scene tests use (XLA contracts multiply-adds into FMAs, torch
  rounds each op).
* make_train_step over [cpu] * 2 against [cpu]: loss within rtol 1e-5,
  gradients within rtol 1e-4, atol 1e-7 (the two sum in other orders).
* Against the reference's make_train_step at MCPT_NEE_RR_TAU=0 (ROADMAP
  R1): the loss within rtol 1e-3 and every gradient leaf by
  tests/test_torch_grad.py::_hold_grads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.parallel.shard import make_mesh as jax_make_mesh
from mcpt_tpu.parallel.shard import make_train_step as jax_make_train_step
from mcpt_tpu.parallel.shard import render_film_sharded as jax_render_film
from mcpt_tpu.render.camera import make_camera as jax_make_camera
from mcpt_tpu.render.renderer import _freeze
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.parallel.shard import (film_shards, make_mesh,
                                           make_train_step,
                                           render_film_sharded)
from mcpt_tpu_torch.render.renderer import Renderer, render_pixels
from mcpt_tpu_torch.scene.compile import replicate_scene
from tests.test_integrator import make_box_scene
from tests.test_torch_grad import _hold_grads
from tests.test_torch_scene import to_torch_config

SPP = 4
FAMILIES = ("textures", "bsdf")


@pytest.fixture(scope="module")
def box():
    cfg = make_box_scene(spp=SPP, res=16, depth_max=3)
    return cfg, Renderer(to_torch_config(cfg), device="cpu")


def _target(n):
    r = np.random.default_rng(3)
    return r.uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_film_bit_equal_to_one_call(box, k):
    _, r = box
    one = render_pixels(r.scene, r.camera, r.integrator, torch.arange(256),
                        SPP, frame_base=5)
    film = render_film_sharded(r.scene, r.camera, r.integrator,
                               make_mesh(["cpu"] * k), SPP, frame_base=5)
    assert film.shape == (256, 3) and one.mean() > 0.01
    assert torch.equal(film, one)


def test_distinct_devices_render_at_once_and_equal_one_call(box):
    """A mesh naming two devices runs a thread each ("cpu" and "cpu:0"
    are two keys of the same memory here), the shards of each in mesh
    order: film and step equal one device's."""
    _, r = box
    mesh = make_mesh(["cpu", "cpu:0", "cpu", "cpu:0"])
    one = render_pixels(r.scene, r.camera, r.integrator, torch.arange(256),
                        SPP)
    film = render_film_sharded(r.scene, r.camera, r.integrator, mesh, SPP)
    assert torch.equal(film, one)
    l1, g1 = _step(r, make_mesh(["cpu"]))
    l4, g4 = _step(r, mesh)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_film_shards_pad_to_the_mesh():
    assert [s.tolist() for s in film_shards(10, 3)] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]]
    assert [s.tolist() for s in film_shards(4, 1)] == [[0, 1, 2, 3]]


def test_sharded_film_matches_reference_mesh(box):
    cfg, r = box
    assert len(jax.devices()) == 8
    ref = np.asarray(jax_render_film(
        jax_compile_scene(cfg), jax_make_camera(cfg.camera),
        _freeze(cfg.integrator), jax_make_mesh(), spp=SPP))
    got = render_film_sharded(r.scene, r.camera, r.integrator,
                              make_mesh(["cpu"] * 3), SPP).numpy()
    assert ref.mean() > 0.01
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1).mean() \
        >= 0.99


def test_make_mesh_names_devices_and_needs_cuda_by_default(monkeypatch):
    assert make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_replicate_scene_moves_tensors_and_keeps_static_fields(box):
    _, r = box
    rep = replicate_scene(r.scene, "cpu")
    assert rep.geom.p0 is r.scene.geom.p0  # already there: not copied
    for f in dataclasses.fields(r.scene):
        a, b = getattr(rep, f.name), getattr(r.scene, f.name)
        if isinstance(b, torch.Tensor):
            assert a is b, f.name
        elif not hasattr(b, "_fields"):
            assert a == b, f.name
    assert rep.tex.kinds == r.scene.tex.kinds
    cam = replicate_scene(r.camera, "cpu")
    assert cam.width == r.camera.width and cam.eye is r.camera.eye


def _step(r, mesh, n=256):
    return make_train_step(r.integrator, 2, mesh, FAMILIES)(
        r.scene, r.camera, torch.arange(n), torch.as_tensor(_target(n)))


def test_mesh_train_step_matches_one_device(box):
    _, r = box
    l1, g1 = _step(r, make_mesh(["cpu"]))
    l2, g2 = _step(r, make_mesh(["cpu"] * 2))
    assert float(l1) > 0
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    assert set(g1) == set(g2)
    assert float(g1["tex.color0"].abs().max()) > 0
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_mesh_train_step_uneven_pixels_are_refused(box):
    _, r = box
    with pytest.raises(ValueError, match="divide"):
        _step(r, make_mesh(["cpu"] * 3))


def test_mesh_train_step_matches_reference_at_tau_zero(monkeypatch, box):
    monkeypatch.setenv("MCPT_NEE_RR_TAU", "0")
    cfg, r = box
    n = 256
    step = jax_make_train_step(_freeze(cfg.integrator), 2, jax_make_mesh(),
                               families=FAMILIES)
    l_ref, g_ref = step(jax_compile_scene(cfg), jax_make_camera(cfg.camera),
                        jnp.arange(n, dtype=jnp.int32),
                        jnp.asarray(_target(n)))
    loss, grads = _step(r, make_mesh(["cpu"] * 2), n)
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-3)
    _hold_grads({k: v.numpy() for k, v in grads.items()},
                {k: np.asarray(v) for k, v in g_ref.items()})
    assert float(grads["tex.color0"].abs().max()) > 0
