"""The port's differentiable estimator (render_pixels(differentiable=True),
the integrators' `shade` under autograd, K1's backward, parallel/shard.py)
against mcpt_tpu on the CPU.

* Gradients of the mean image against jax.grad of the reference at
  MCPT_NEE_RR_TAU=0 (ROADMAP R1: the reference's shadow-ray RR weight
  leaks into its gradient at tau > 0), on tests/test_grad_params.py's
  scenes and two that reach K1's backward, for every family of
  PARAM_FAMILIES: the rough conductor box with a plastic wall whose
  albedo is a bitmap (reflectivity, edge tint, eta through the coat's
  Fresnel and the derived tables, the atlas); a checkerboard box with a
  glass cube, whose refracted rays' hits carry eta's geometric term
  through K1's backward, at depth 4, so that NEE sees the floor behind
  the glass; a floor under a point and a directional
  light; tests/test_grad_params.py's null-boundary slab made scattering,
  whose scatter points carry sigma_t's term through K1's backward.  Every leaf within rtol 2e-3,
  atol GRAD_ATOL of the largest |gradient| of its leaf, where the
  reference's is finite; the port's is finite everywhere.  The reference
  gives NaN on channel 0 of every texture of these boxes (a 0/0 in a
  backward on lanes whose forward value is masked); the port does not.
* At the default tau, where the reference's edge-tint gradient is NaN:
  the port's is finite and matches central differences of the port
  within 5%, the reference tests' band, on the conductor box at 24x24,
  16 spp.  With the RR weight detached the gradient is unbiased; the
  differences also see the RR decisions flip, which averages out only
  over many samples (at 12x12, 4 spp reflectivity's were 7% apart).
* The trip count: with differentiable=True `shade` runs depth_max - 1
  bounces, as the reference's lax.scan, and otherwise stops when no lane
  is alive, as its while_loop; the seeds each mode returns equal the
  reference's (path and volpath), and render_pixels at 2 spp equals the
  reference's in both modes per pixel.
* make_train_step with grad_chunks=4 equals grad_chunks=1 (rtol 1e-5).
* K1's autograd backward (DenseClosestHit) against finite differences
  (torch.autograd.gradcheck) on a small soup, hits and misses.
* A scene past DENSE_MAX_PRIMS takes the march route, whose hits are
  detached on both sides: the gradients match the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.integrators import path as JP
from mcpt_tpu.integrators import volpath as JV
from mcpt_tpu.models.texture import TextureBuilder
from mcpt_tpu.parallel.shard import apply_params as jax_apply_params
from mcpt_tpu.parallel.shard import select_params as jax_select_params
from mcpt_tpu.render.camera import make_camera as jax_make_camera
from mcpt_tpu.render.renderer import _freeze
from mcpt_tpu.render.renderer import render_pixels as jax_render_pixels
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu.scene.ir import (BsdfInfo, BsdfType, EmitterInfo, EmitterType,
                               InstanceInfo)
from mcpt_tpu_torch.integrators import path as TP
from mcpt_tpu_torch.integrators import volpath as TV
from mcpt_tpu_torch.ops import rng
from mcpt_tpu_torch.ops.dense_sweep import DenseClosestHit
from mcpt_tpu_torch.ops.microfacet import average_fresnel_rgb
from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS
from mcpt_tpu_torch.parallel.shard import (PARAM_FAMILIES, apply_params,
                                           make_mesh, make_train_step,
                                           select_params)
from mcpt_tpu_torch.render.camera import generate_rays
from mcpt_tpu_torch.render.renderer import Renderer, render_pixels
from mcpt_tpu_torch.scene.builtin import _xform
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_emitter import floor_scene
from tests.test_grad_params import _conductor_box
from tests.test_integrator import make_box_scene, rot_x
from tests import test_medium
from tests.test_torch_scene import to_torch_config

#: a gradient entry's absolute tolerance, relative to its leaf's largest
GRAD_ATOL = 1e-4


def _plastic_conductor_box():
    """tests/test_grad_params.py's rough conductor box with a plastic back
    wall whose albedo is a bitmap, under a checkerboard light."""
    cfg = _conductor_box()
    tb: TextureBuilder = cfg.textures
    cfg.bsdfs[1].id_radiance = tb.add_checkerboard(
        [20.0] * 3, [12.0, 14.0, 16.0], uv_transform=[3, 0, 0, 0, 3, 0])
    bitmap = np.random.default_rng(3).random((8, 8, 3)).astype(np.float32)
    cfg.bsdfs.append(BsdfInfo(btype=BsdfType.PLASTIC,
                              id_diffuse_reflectance=tb.add_bitmap(bitmap),
                              id_roughness=tb.add_constant([0.3] * 3),
                              eta=1.5))
    wall = InstanceInfo(shape="rectangle", id_bsdf=2,
                        to_world=rot_x(0.0, scale=2.0, ty=1.0))
    wall.to_world[2, 3] = -1.5
    cfg.instances.append(wall)
    return cfg


def _glass_box():
    """make_box_scene with a glass cube above the floor (12 triangles,
    K1's): refracted rays' hits depend on eta."""
    cfg = make_box_scene(spp=4, res=16, depth_max=4)
    cfg.bsdfs.append(BsdfInfo(btype=BsdfType.DIELECTRIC, eta=1.4))
    cfg.instances.append(InstanceInfo(
        shape="cube", id_bsdf=2,
        to_world=_xform(scale=(0.35,) * 3, rot_y=30, rot_x=20,
                        t=(0.1, 0.6, 0.2))))
    return cfg


def _two_lights_floor():
    cfg = floor_scene(EmitterInfo(
        etype=EmitterType.POINT,
        position=np.array([0.0, 2.0, 0.0], np.float32),
        intensity=np.array([3.0, 2.5, 2.0], np.float32)),
        spp=2, res=8, depth_max=2)
    cfg.emitters.append(EmitterInfo(
        etype=EmitterType.DIRECTIONAL,
        direction=np.array([0.2, -1.0, 0.1], np.float32),
        radiance=np.array([2.0, 1.5, 1.0], np.float32)))
    return cfg


def _slab(sigma_a, sigma_s):
    cfg = test_medium.TestVolpathRender()._slab_cfg(sigma_a=sigma_a, sigma_s=sigma_s,
                                        spp=2)
    cfg.integrator.depth_max = 5
    return cfg


GRAD_SCENES = {
    "plastic_conductor_box": (_plastic_conductor_box, ("textures", "bsdf")),
    "two_lights_floor": (_two_lights_floor, ("emitters",)),
    "scattering_slab": (lambda: _slab(0.3, 1.2), ("media",)),
}


def _jax_grad(cfg, families, spp):
    scene = jax_compile_scene(cfg)
    camera = jax_make_camera(cfg.camera)
    integ = _freeze(cfg.integrator)
    idx = jnp.arange(cfg.camera.width * cfg.camera.height, dtype=jnp.int32)

    def loss(p):
        return jnp.mean(jax_render_pixels(jax_apply_params(scene, p), camera,
                                          integ, idx, spp,
                                          differentiable=True))

    return {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss))(
        jax_select_params(scene, families)).items()}


def _loss_fn(cfg, spp):
    r = Renderer(to_torch_config(cfg), device="cpu")
    idx = torch.arange(cfg.camera.width * cfg.camera.height)

    def loss(p):
        return render_pixels(apply_params(r.scene, p), r.camera,
                             r.integrator, idx, spp,
                             differentiable=True).mean()

    return r, loss


def _torch_grad(cfg, families, spp):
    r, loss = _loss_fn(cfg, spp)
    p = {k: v.detach().clone().requires_grad_()
         for k, v in select_params(r.scene, families).items()}
    loss(p).backward()
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v)).numpy()
            for k, v in p.items()}


def _hold_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        ok = np.isfinite(w)
        scale = max(np.abs(w[ok]).max(initial=0.0), 1e-12)
        np.testing.assert_allclose(g[ok], w[ok], rtol=2e-3,
                                   atol=GRAD_ATOL * scale, err_msg=k)


@pytest.mark.parametrize("name", sorted(GRAD_SCENES))
def test_gradients_match_jax_grad_at_tau_zero(monkeypatch, name):
    monkeypatch.setenv("MCPT_NEE_RR_TAU", "0")
    make, families = GRAD_SCENES[name]
    cfg = make()
    want = _jax_grad(cfg, families, spp=2)
    got = _torch_grad(cfg, families, spp=2)
    _hold_grads(got, want)
    nonzero = {k for k, w in want.items() if np.abs(np.nan_to_num(w)).max()}
    expect = {
        "plastic_conductor_box": {"bsdf.reflectivity_rgb", "bsdf.edgetint_rgb",
                                  "bsdf.eta", "tex.color0", "tex.color1",
                                  "tex.atlas"},
        "two_lights_floor": {"em.intensity", "em.radiance"},
        "scattering_slab": {"med.sigma_s", "med.sigma_t"},
    }[name]
    assert expect <= nonzero, nonzero


def test_dielectric_eta_through_k1_backward_matches_reference_differences(
        monkeypatch):
    """eta moves a refracted ray, and with it the hit that K1's backward
    differentiates.  The reference's jax.grad of this leaf is NaN (a 0/0
    on masked lanes), so the port's gradient is held against central
    differences of the reference's forward image (jitted; eps 1e-3,
    within 1%), and of its own."""
    monkeypatch.setenv("MCPT_NEE_RR_TAU", "0")
    cfg = _glass_box()
    r, loss = _loss_fn(cfg, spp=4)
    p0 = {k: v.detach().clone().requires_grad_()
          for k, v in select_params(r.scene, ("bsdf",)).items()}
    loss(p0).backward()
    glass = 2
    g = float(p0["bsdf.eta"].grad[glass])

    scene = jax_compile_scene(cfg)
    camera = jax_make_camera(cfg.camera)
    integ = _freeze(cfg.integrator)
    idx = jnp.arange(cfg.camera.width * cfg.camera.height, dtype=jnp.int32)
    jax_loss = jax.jit(lambda p: jnp.mean(jax_render_pixels(
        jax_apply_params(scene, p), camera, integ, idx, 4,
        differentiable=True)))
    jp = jax_select_params(scene, ("bsdf",))
    eps = 1e-3

    def ref_at(delta):
        p = dict(jp)
        p["bsdf.eta"] = jp["bsdf.eta"].at[glass].add(delta)
        return float(jax_loss(p))

    def port_at(delta):
        p = {k: v.detach().clone() for k, v in p0.items()}
        p["bsdf.eta"][glass] += delta
        with torch.no_grad():
            return float(loss(p))

    ref_fd = (ref_at(eps) - ref_at(-eps)) / (2 * eps)
    port_fd = (port_at(eps) - port_at(-eps)) / (2 * eps)
    assert abs(g) > 1e-4
    assert g == pytest.approx(ref_fd, rel=1e-2)
    assert g == pytest.approx(port_fd, rel=1e-2)


def test_families_cover_param_families():
    covered = {f for _, fams in GRAD_SCENES.values() for f in fams}
    assert covered == set(PARAM_FAMILIES)


@pytest.mark.parametrize("key,index", [("bsdf.edgetint_rgb", (0, 1)),
                                       ("bsdf.reflectivity_rgb", (0, 0))])
def test_gradient_matches_finite_differences_at_default_tau(monkeypatch, key,
                                                            index):
    monkeypatch.delenv("MCPT_NEE_RR_TAU", raising=False)
    cfg = _conductor_box()
    cfg.camera.width = cfg.camera.height = 24
    r, loss = _loss_fn(cfg, spp=16)
    p0 = {k: v.detach().clone().requires_grad_()
          for k, v in select_params(r.scene, ("bsdf",)).items()}
    loss(p0).backward()
    g = float(p0[key].grad[index])
    eps = 1e-2

    def at(delta):
        p = {k: v.detach().clone() for k, v in p0.items()}
        p[key][index] += delta
        with torch.no_grad():
            return float(loss(p))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert np.isfinite(g) and abs(g) > 1e-7
    assert g == pytest.approx(fd, rel=5e-2, abs=1e-6)
    if key == "bsdf.edgetint_rgb":
        # the reference's gradient of this leaf is NaN at the default tau
        assert not np.isfinite(_jax_grad(cfg, ("bsdf",), 1)[key]).all()


def _seeds_and_images(jcfg, shade_t, shade_j):
    """The seeds one sample returns in both modes, port and reference."""
    r = Renderer(to_torch_config(jcfg), device="cpu")
    n = jcfg.camera.width * jcfg.camera.height
    pix = torch.arange(n)
    o, d = generate_rays(r.camera, pix, torch.full((n,), 0.5),
                         torch.full((n,), 0.5))
    seed0 = rng.pixel_seed(pix, 1)
    scene = jax_compile_scene(jcfg)
    integ = _freeze(jcfg.integrator)
    out = {}
    for diff in (False, True):
        _, seed = shade_t(r.scene, r.integrator, o, d, seed0,
                          differentiable=diff)
        _, jseed = jax.jit(lambda s, a, b, z: shade_j(
            s, integ, a, b, z, differentiable=diff))(
            scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(seed0.numpy().astype(np.uint32)))
        np.testing.assert_array_equal(seed.numpy().astype(np.uint32),
                                      np.asarray(jseed))
        out[diff] = seed
    return out


@pytest.mark.parametrize("name", ["path", "volpath"])
def test_trip_count_and_seeds_match_reference(name):
    if name == "path":
        jcfg = make_box_scene(spp=2, res=6, depth_max=8)
        seeds = _seeds_and_images(jcfg, TP.shade, JP.shade)
    else:
        jcfg = _slab(0.8, 0.0)
        seeds = _seeds_and_images(jcfg, TV.shade, JV.shade)
    # every path ended before depth_max: the scan's extra bounces drew more
    assert not torch.equal(seeds[False], seeds[True])


@pytest.mark.parametrize("diff", [False, True])
def test_render_pixels_two_samples_match_reference(diff):
    jcfg = make_box_scene(spp=2, res=8, depth_max=8)
    idx = np.arange(64)
    ref = np.asarray(jax_render_pixels(
        jax_compile_scene(jcfg), jax_make_camera(jcfg.camera),
        _freeze(jcfg.integrator), jnp.asarray(idx, jnp.int32), 2,
        differentiable=diff))
    r = Renderer(to_torch_config(jcfg), device="cpu")
    got = render_pixels(r.scene, r.camera, r.integrator, torch.as_tensor(idx),
                        2, differentiable=diff).detach().numpy()
    assert ref.mean() > 0.01
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean() >= 0.99


def test_train_step_chunks_equal_one_chunk():
    cfg = _conductor_box()
    r = Renderer(to_torch_config(cfg), device="cpu")
    idx = torch.arange(144)
    target = torch.full((144, 3), 0.1)
    mesh = make_mesh(["cpu"])
    out = [make_train_step(r.integrator, 2, mesh, PARAM_FAMILIES,
                           grad_chunks=c)(r.scene, r.camera, idx, target)
           for c in (1, 4)]
    (l1, g1), (l4, g4) = out
    assert float(l1) > 0
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    assert set(g1) == set(g4) == set(select_params(r.scene, PARAM_FAMILIES))
    for k in g1:
        assert torch.isfinite(g1[k]).all(), k
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert g1["bsdf.reflectivity_rgb"].abs().max() > 0


def test_dense_closest_hit_backward_by_finite_differences():
    g = np.random.default_rng(7)
    p = 48
    p0 = g.uniform(-2, 2, (p, 3))
    tris = np.zeros((p, 12))
    tris[:, 0:3] = p0
    tris[:, 3:6] = g.normal(0, 0.6, (p, 3))
    tris[:, 6:9] = g.normal(0, 0.6, (p, 3))
    tris[:, 9] = 1.0
    n = 64
    o = g.uniform(-3, 3, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # aim the first half at triangle centroids: sure hits
    c = p0[:n // 2] + (tris[:n // 2, 3:6] + tris[:n // 2, 6:9]) / 3
    d[:n // 2] = (c - o[:n // 2]) / np.linalg.norm(c - o[:n // 2], axis=-1,
                                                    keepdims=True)
    t64 = dict(dtype=torch.float64)
    args = [torch.tensor(o, **t64, requires_grad=True),
            torch.tensor(d, **t64, requires_grad=True),
            torch.full((n,), 1e-4, **t64),
            torch.full((n,), 50.0, **t64, requires_grad=True),
            torch.tensor(tris, **t64)]
    hit = DenseClosestHit.apply(*args)
    assert 0 < int(hit[0].sum()) < n  # hits and misses

    def ftw(o, d, t_max):
        _, t, _, v, w, _ = DenseClosestHit.apply(o, d, args[2], t_max,
                                                 args[4])
        return t, v, w

    assert torch.autograd.gradcheck(ftw, (args[0], args[1], args[3]),
                                    eps=1e-7, atol=1e-6)


def test_march_route_gradients_are_detached_and_match(monkeypatch):
    monkeypatch.setenv("MCPT_NEE_RR_TAU", "0")
    monkeypatch.setenv("MCPT_TRAVERSAL", "march")
    cfg = make_mesh_box_scene(spp=1, res=6, depth_max=3)
    r = Renderer(to_torch_config(cfg), device="cpu")
    assert r.scene.geom.packed_tris.shape[0] > DENSE_MAX_PRIMS
    _hold_grads(_torch_grad(cfg, ("textures",), 1),
                _jax_grad(cfg, ("textures",), 1))


def test_apply_params_recomputes_the_derived_tables():
    """Written back unchanged, the leaves give the committed tables again:
    the torch average-Fresnel fits against the host's (on the rows that
    read them), 1 / eta and the Fresnel reflectance."""
    scene0 = Renderer(to_torch_config(_glass_box()), device="cpu").scene
    scene0 = dataclasses.replace(scene0, bsdf=scene0.bsdf._replace(
        reflectivity_rgb=torch.tensor([[0.9, 0.6, 0.3]] * 3),
        edgetint_rgb=torch.tensor([[0.95, 0.9, 0.85]] * 3)))
    p = {k: v.clone().requires_grad_()
         for k, v in select_params(scene0, PARAM_FAMILIES).items()}
    b0, b = scene0.bsdf, apply_params(scene0, p).bsdf
    fresnel = torch.isin(b0.btype, torch.tensor([4, 5, 6]))
    assert int(fresnel.sum()) == 1
    for f in ("eta_inv", "reflectivity", "f_avg", "f_avg_inv"):
        assert getattr(b, f).requires_grad, f
        np.testing.assert_allclose(getattr(b, f)[fresnel].detach().numpy(),
                                   getattr(b0, f)[fresnel].numpy(),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(
        b.f_avg_rgb.detach().numpy(),
        np.stack([average_fresnel_rgb([0.9, 0.6, 0.3], [0.95, 0.9, 0.85])]
                 * 3), rtol=1e-6)


def test_sqrt_derivative_is_zero_where_the_root_is():
    """ops/math.py::sqrt under autograd: the root's own derivative where
    it is positive, 0 where it is 0 (the clamped lanes that a where()
    drops), so that no 0 x inf reaches a parameter; the same forward."""
    from mcpt_tpu_torch.ops.math import sqrt

    x = torch.tensor([0.0, 0.25, 4.0], requires_grad=True)
    y = sqrt(torch.clamp(x - 0.0, min=0.0))
    torch.testing.assert_close(y, torch.sqrt(x.detach()))
    torch.where(x > 0.0, y, torch.zeros_like(y)).sum().backward()
    torch.testing.assert_close(x.grad, torch.tensor([0.0, 1.0, 0.25]))


@pytest.mark.parametrize("name", ["envmap_matpreview", "caustic_by_path",
                                  "envmap_512_dropped_lanes"])
def test_gradients_are_finite_on_the_chip_scenes(name):
    """The scenes of chip_smoke's grad phase at 16x16, 1 spp: every
    gradient leaf finite (the reference's are NaN on the envmap scene's
    roughness and wherever a ray misses the quadric sphere), the bitmaps'
    nonzero.  And two pixels of the 512x512, 4 spp envmap step whose
    gradients were NaN on the card (found by bisection): a path that
    ended after a sample with a negative pdf, whose dropped emitter term's
    MIS weight was inf / inf."""
    from chip_smoke import caustic_glass_by_path
    from mcpt_tpu_torch.scene.builtin import envmap_matpreview

    res, spp, idx = 16, 1, torch.arange(256)
    if name == "envmap_512_dropped_lanes":
        res, spp, idx = 512, 4, torch.tensor([143585, 147830])
    cfg = {"envmap_matpreview": envmap_matpreview,
           "envmap_512_dropped_lanes": envmap_matpreview,
           "caustic_by_path": caustic_glass_by_path}[name](res=res, spp=spp)
    r = Renderer(cfg, device="cpu")
    p = {k: v.detach().clone().requires_grad_()
         for k, v in select_params(r.scene, ("textures", "bsdf")).items()}
    render_pixels(apply_params(r.scene, p), r.camera, r.integrator,
                  idx, spp, differentiable=True).mean().backward()
    for k, v in p.items():
        assert v.grad is None or torch.isfinite(v.grad).all(), k
    if name.startswith("envmap"):
        assert p["tex.atlas"].grad.abs().max() > 0
    else:
        assert p["bsdf.eta"].grad.abs().max() > 0


def test_an_overflowed_throughput_on_a_dropped_lane_gives_no_nan():
    """The last bounce's beta may overflow to inf on a lane whose emitter
    and escape terms are dropped (the 512x512 envmap step on the card met
    one); the gradients of the radiance those terms read stay finite."""
    cfg = make_box_scene(spp=1, res=4)
    sky = cfg.textures.add_bitmap(
        np.random.default_rng(1).random((8, 16, 3)).astype(np.float32))
    cfg.emitters.append(EmitterInfo(etype=EmitterType.ENVMAP,
                                    id_texture=sky))
    r = Renderer(to_torch_config(cfg), device="cpu")
    p = {k: v.detach().clone().requires_grad_()
         for k, v in select_params(r.scene, ("textures",)).items()}
    scene = apply_params(r.scene, p)
    # lanes 0-7 hit the light from below, lanes 8-15 escape upward
    o = torch.tensor([[0.0, 1.0, 0.0]] * 8 + [[0.0, 2.5, 0.0]] * 8)
    d = torch.tensor([[0.0, 1.0, 0.0]] * 16)
    hit = TP.interpolate_hit(scene, TP.scene_closest(scene, o, d), o, d)
    assert hit.valid[:8].all() and not hit.valid[8:].any()
    beta = torch.ones((16, 3))
    beta[::2] = float("inf")
    none = torch.zeros(16, dtype=torch.bool)
    pdf = torch.full((16,), 2.0)
    L_em, _ = TP._emitter_hit(scene, r.integrator, hit, d, beta, pdf,
                              none | (beta[:, 0] < 2), none)
    L_esc = TP._escape(scene, torch.zeros((16, 3)), d, beta, pdf,
                       none | (beta[:, 0] < 2), hit, none, True)
    assert L_em[1].sum() > 0 and L_esc[9].sum() > 0
    (L_em.sum() + L_esc.sum()).backward()
    for k in ("tex.color0", "tex.atlas"):
        assert torch.isfinite(p[k].grad).all(), k


def test_an_envmap_read_along_its_pole_has_a_finite_gradient():
    """An escape exactly along the envmap's pole (theta 0: arccos at 1,
    atan2 at (0, 0), both of infinite or undefined derivative) read
    through the atlas: the gradients into the direction and the atlas
    are finite, and equal torch's own elsewhere."""
    from mcpt_tpu_torch.models import emitter as TE
    from mcpt_tpu_torch.models.texture import TextureBuilder as TTB
    from mcpt_tpu_torch.ops import math as tmath

    px = np.random.default_rng(2).random((8, 16, 3)).astype(np.float32)
    env = TE.build_envmap(px, np.eye(4, dtype=np.float32), 0, "cpu")
    tb = TTB()
    tb.add_bitmap(px)
    tex = tb.build("cpu")
    tex = tex._replace(atlas=tex.atlas.clone().requires_grad_())
    look = torch.tensor([[0.0, 1.0, 0.0], [0.3, 0.5, -0.2]],
                        requires_grad=True)
    TE.eval_envmap(env, tex, look, differentiable=True).sum().backward()
    assert torch.isfinite(look.grad).all() and torch.isfinite(
        tex.atlas.grad).all()
    x = torch.tensor([0.3, -0.7], requires_grad=True)
    y = torch.tensor([0.2, 0.4], requires_grad=True)
    (tmath.arccos(x) + tmath.atan2(y, x)).sum().backward()
    xr, yr = (v.detach().double().requires_grad_() for v in (x, y))
    (torch.arccos(xr) + torch.atan2(yr, xr)).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad.float())
    torch.testing.assert_close(y.grad, yr.grad.float())
