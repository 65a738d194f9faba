"""The packet route of mcpt_tpu_torch on the CPU (the BVH, K5's plain
version, MCPT_TRAVERSAL=packet), MCPT_COH's origin-chunk keys and the
native SAH partition, against mcpt_tpu.

* build_bvh and the Geometry's BVH fields equal the reference's
  commit_geometry field for field (numpy on both sides): exact.
* packet_sweep_plain, the per-ray walk, against the reference's per-lane
  walk _traverse (its order), its packet walk _intersect_packet and its
  brute-force oracle on tests/test_bvh.py's random soups (with exact
  duplicates, so ties; a ragged tail of rays and dead rays) at leaf
  sizes 1, 2, 4 and 8: valid and inside equal; t within rtol 1e-5, atol
  1e-5 (XLA contracts multiply-adds into FMAs, torch rounds each op);
  prim equal but on exact-t ties, where the port's prim must reproduce
  the reference's t; v and w within atol 1e-4, the FMA ulps of their
  numerators being scaled by 1/|det| (1.2e-5 seen on a triangle of
  |det| = 0.0043).  Against _traverse the same holds in any-hit mode
  (the same per-lane order finds the same first hits); against the
  packet walk, whose visit order is another, any-hit compares valid.
  Against the port's own dense sweep, which does the same arithmetic:
  valid and t bit-equal, v, w and inside bit-equal where prim is.
* The walk visits no padding node (inverted boxes), though _traverse,
  which visits them, finds the same hits.
* A MCPT_TRAVERSAL=packet render of tests/test_batched_regen.py::
  make_mesh_box_scene (its floor turned to face the light, so that NEE
  lights it) matches the reference's packet render per pixel.
* MCPT_COH=1: the origin chunk ids and march keys are the reference's;
  a render with it equals the same render without it bit for bit (it
  changes only which rays share a march block), by both regen bodies'
  unbatched one and the chunked engine, and the keys reach the march.
* csrc/sah.c's chunk list is the Python version's reversed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.ops.traversal as JT
from mcpt_tpu.integrators import path as JP
from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.scene.bvh import build_bvh as jax_build_bvh
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu.scene.geometry import commit_geometry as jax_commit_geometry
from mcpt_tpu_torch import native
from mcpt_tpu_torch.integrators import path as TP
from mcpt_tpu_torch.ops import dense_sweep as ds
from mcpt_tpu_torch.ops import packet_sweep as pkt
from mcpt_tpu_torch.ops import traversal as TT
from mcpt_tpu_torch.ops.intersect import intersect_triangle
from mcpt_tpu_torch.ops.scene_intersect import scene_closest
from mcpt_tpu_torch.render.camera import generate_rays
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.bvh import build_bvh
from mcpt_tpu_torch.scene.compile import compile_scene
from mcpt_tpu_torch.scene.geometry import _sah_chunks_py, commit_geometry
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_bvh import random_rays, random_soup
from tests.test_torch_scene import to_torch_config

FMAX = 3.4e38
LEAF_SIZES = (1, 2, 4, 8)


def _soup(n_tris, seed, leaf_size, opaque_frac=1.0):
    """A random soup with exact duplicates (exact-t ties) and random
    opaque flags: the reference's and the port's geometry over it."""
    verts = random_soup(n_tris, seed=seed)
    r = np.random.default_rng(seed + 100)
    dup = r.choice(n_tris, size=(n_tris // 20, 2), replace=False)
    verts[dup[:, 1]] = verts[dup[:, 0]]
    opaque = r.uniform(size=n_tris) < opaque_frac
    inst = np.zeros(n_tris)
    return (jax_commit_geometry(verts, None, None, None, inst,
                                tri_opaque=opaque, leaf_size=leaf_size),
            commit_geometry(verts, None, None, None, inst, "cpu",
                            tri_opaque=opaque, leaf_size=leaf_size))


def _rays(n, seed):
    """Random rays, a t_max window on every third, every seventh dead."""
    o, d = random_rays(n, seed=seed)
    t_max = np.full(n, FMAX, np.float32)
    t_max[1::3] = np.random.default_rng(seed).uniform(1.0, 8.0, n)[1::3]
    t_max[::7] = 0.0
    return np.array(o), np.array(d), t_max


def _hold_against_reference(got, ref, o, d, tg):
    valid = np.array(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.inside.numpy()[valid],
                                  np.asarray(ref.inside)[valid])
    same = valid & (got.prim.numpy() == np.asarray(ref.prim))
    for name in ("v", "w"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(ref, name))[same],
                                   atol=1e-4, err_msg=name)
    m = torch.as_tensor(valid)
    pid = got.prim[m].long()
    hit, t, _, _, _ = intersect_triangle(
        torch.as_tensor(o)[m], torch.as_tensor(d)[m], tg.p0[pid], tg.e1[pid],
        tg.e2[pid], 1e-4, FMAX)
    assert bool(hit.all())
    np.testing.assert_allclose(t.numpy(), np.asarray(ref.t)[valid],
                               rtol=1e-5, atol=1e-5)


def _packet(tg, o, d, t_max, any_hit):
    n = t_max.shape[0]
    return TT._intersect_packet(tg, torch.as_tensor(o), torch.as_tensor(d),
                                torch.full((n,), 1e-4), torch.as_tensor(t_max),
                                any_hit)


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_bvh_equals_reference(leaf_size):
    verts = random_soup(1000, seed=21)
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    got, ref = build_bvh(lo, hi, leaf_size), jax_build_bvh(lo, hi, leaf_size)
    for f in ("node_min", "node_max", "order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    for f in ("n_nodes", "n_pad_leaves", "leaf_size", "depth"):
        assert getattr(got, f) == getattr(ref, f), f
    jg, tg = _soup(1000, seed=21, leaf_size=leaf_size)
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    for f in ("n_pad_leaves", "leaf_size", "depth"):
        assert getattr(tg, f) == getattr(jg, f), f
    np.testing.assert_array_equal(
        tg.packed_tris.view(tg.n_pad_leaves, tg.leaf_size, 12).numpy(),
        np.asarray(jg.packed_tris))
    np.testing.assert_array_equal(tg.bounds_min.numpy(), tg.node_min[0].numpy())
    np.testing.assert_array_equal(tg.bounds_max.numpy(), tg.node_max[0].numpy())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_packet_plain_matches_reference(leaf_size, any_hit):
    """1500 rays: two of the reference's packets, the second ragged."""
    jg, tg = _soup(300, seed=22, leaf_size=leaf_size, opaque_frac=0.7)
    o, d, t_max = _rays(1500, seed=23)
    ref = JT._intersect_packet(jg, jnp.asarray(o), jnp.asarray(d), 1e-4,
                               jnp.asarray(t_max), any_hit)
    got = _packet(tg, o, d, t_max, any_hit)
    assert not bool(got.valid[::7].any())
    if any_hit:
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        assert bool(got.valid.any())
        return
    _hold_against_reference(got, ref, o, d, tg)
    brute = JT.intersect_closest_brute(jg, jnp.asarray(o), jnp.asarray(d),
                                       1e-4, jnp.asarray(t_max))
    _hold_against_reference(got, brute, o, d, tg)
    dense = ds.dense_sweep_plain(
        torch.as_tensor(o), torch.as_tensor(d), torch.full((1500,), 1e-4),
        torch.as_tensor(t_max), tg.packed_tris)
    assert torch.equal(got.valid, dense.valid)
    assert torch.equal(got.t, dense.t)
    same = got.prim == dense.prim
    assert bool(same[got.valid].float().mean() > 0.9)
    for name in ("v", "w", "inside"):
        assert torch.equal(getattr(got, name)[same], getattr(dense, name)[same])


def test_packet_plain_any_hit_is_occlusion():
    """Any-hit valid is the closest opaque hit's existence, and its t is a
    real opaque hit of the ray within the window."""
    jg, tg = _soup(800, seed=24, leaf_size=4, opaque_frac=0.5)
    o, d, t_max = _rays(700, seed=25)
    got = _packet(tg, o, d, t_max, True)
    dense = ds.dense_sweep_plain(
        torch.as_tensor(o), torch.as_tensor(d), torch.full((700,), 1e-4),
        torch.as_tensor(t_max), tg.packed_tris, any_hit=True)
    assert torch.equal(got.valid, dense.valid) and bool(got.valid.any())
    m = got.valid
    assert bool((got.t[m] >= dense.t[m]).all())
    assert bool((tg.opaque[got.prim[m].long()]).all())


def _traverse(jg, o, d, t_max, any_hit):
    """The reference's per-lane walk, t_min 1e-4, as tests/test_bvh.py
    runs it."""
    return jax.jit(lambda g, o, d, hi: JT._traverse(g, o, d, 1e-4, hi,
                                                    any_hit=any_hit))(
        jg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_packet_plain_matches_traverse(leaf_size, any_hit):
    """The per-ray walk is _traverse's, padding culled: 1500 rays (a
    ragged tail past any block of 128 or 256, every seventh dead), closest
    hit and any-hit, under _hold_against_reference's rule."""
    jg, tg = _soup(300, seed=22, leaf_size=leaf_size, opaque_frac=0.7)
    o, d, t_max = _rays(1500, seed=23)
    ref = _traverse(jg, o, d, t_max, any_hit)
    got = _packet(tg, o, d, t_max, any_hit)
    assert not bool(got.valid[::7].any())
    _hold_against_reference(got, ref, o, d, tg)
    if any_hit:
        assert bool((tg.opaque[got.prim[got.valid].long()]).all())


def test_packet_visits_and_tree_sum():
    """Named for the packet walk's fixed-order sum (_tree_sum), which the
    per-ray walk no longer needs.  The walk reports its visits a ray, a
    BVH with padding leaves (300 prims in leaves of 4: 75 real of 128)
    has no padding node visited, and its hits still equal those of
    _traverse, which walks the padding subtrees."""
    jg, tg = _soup(300, seed=26, leaf_size=4)
    o, d, t_max = _rays(2100, seed=27)
    visits = {}
    got = pkt.packet_sweep_plain(
        torch.as_tensor(o), torch.as_tensor(d), torch.full((2100,), 1e-4),
        torch.as_tensor(t_max), tg.node_min, tg.node_max,
        tg.packed_tris.view(tg.n_pad_leaves, tg.leaf_size, 12), visits=visits)
    inverted = tg.node_min[:, 0] > tg.node_max[:, 0]
    assert tg.n_pad_leaves == 128 and int(inverted.sum()) > 53
    assert not bool((visits["nodes"] & inverted).any())
    assert int(visits["nodes"].sum()) > 100
    assert visits["internal"].shape == visits["leaf"].shape == (2100,)
    dead = torch.as_tensor(t_max) <= 1e-4
    assert not bool(visits["internal"][dead].any() | visits["leaf"][dead].any())
    walked = visits["leaf"] > 0
    assert bool(walked[~dead].float().mean() > 0.25)
    # a leaf is reached through the depth internal nodes above it
    assert bool((visits["internal"][walked] >= tg.depth).all())
    assert visits["slab_tests"] == 2 * int(visits["internal"].sum())
    assert visits["tri_tests"] == tg.leaf_size * int(visits["leaf"].sum())
    ref = _traverse(jg, o, d, t_max, False)
    _hold_against_reference(got, ref, o, d, tg)


def test_packet_child_boxes_record():
    """K5 reads internal node i's children's boxes as one contiguous
    48-byte record: min and max of child 2i+1, then of 2i+2."""
    _, tg = _soup(300, seed=28, leaf_size=4)
    boxes = pkt.child_boxes(tg.node_min, tg.node_max)
    m = tg.node_min.shape[0]
    assert boxes.shape == (m // 2, 12) and boxes.is_contiguous()
    i = torch.arange(m // 2)
    assert torch.equal(boxes[:, 0:3], tg.node_min[2 * i + 1])
    assert torch.equal(boxes[:, 3:6], tg.node_max[2 * i + 1])
    assert torch.equal(boxes[:, 6:9], tg.node_min[2 * i + 2])
    assert torch.equal(boxes[:, 9:12], tg.node_max[2 * i + 2])


def _lit_mesh_box(**kw):
    """make_mesh_box_scene with its floor's faces turned toward the light
    (the scene's own winding faces them away, so only the light shows)."""
    cfg = make_mesh_box_scene(**kw)
    mesh = cfg.instances[0].mesh
    mesh.indices = np.ascontiguousarray(mesh.indices[:, [0, 2, 1]])
    return cfg


def test_packet_route_render_matches_reference(monkeypatch):
    monkeypatch.setenv("MCPT_TRAVERSAL", "packet")
    cfg = _lit_mesh_box(spp=1, res=8, depth_max=2)
    r = Renderer(to_torch_config(cfg), device="cpu")
    assert r.scene.geom.packed_tris.shape[0] > TT.DENSE_MAX_PRIMS
    assert TT.resolved_strategy(r.scene.geom) == "packet"
    assert TP._use_batched_trace(r.scene)
    ref = np.asarray(JaxRenderer(cfg).render())
    got = r.render()
    lit = (got > 0).all(axis=-1).mean()
    assert lit > 0.4 and ref.mean() > 0.01
    assert np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1).mean() \
        >= 0.99


def test_origin_chunk_keys_match_reference(monkeypatch):
    monkeypatch.setenv("MCPT_COH", "1")
    cfg = _lit_mesh_box(spp=1, res=16, depth_max=2)
    tscene = compile_scene(to_torch_config(cfg), device="cpu")
    jscene = jax_compile_scene(cfg)
    assert TP._use_origin_chunk(tscene) and JP._use_origin_chunk(jscene)
    r = Renderer(to_torch_config(cfg), device="cpu")
    pix = torch.arange(256)
    o, d = generate_rays(r.camera, pix, torch.full((256,), 0.5),
                         torch.full((256,), 0.5))
    th = scene_closest(tscene, o, d)
    jh = JT.intersect_closest(jscene.geom, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()))
    coh = TP._origin_chunk(tscene, th)
    jcoh = JP._origin_chunk(jscene, jh._replace(prim=jnp.asarray(th.prim)))
    np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_array_equal(coh.numpy(), np.asarray(jcoh))
    assert int((coh >= 0).sum()) > 100 and int((coh < 0).sum()) > 0
    keys = TT._ray_sort_keys(tscene.geom, o, d, coherence=coh)
    jkeys = JT._ray_sort_keys(jscene.geom, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()),
                              coherence=jnp.asarray(coh.numpy()))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    monkeypatch.setenv("MCPT_COH", "0")
    assert not TP._use_origin_chunk(tscene)


@pytest.mark.parametrize("engine", ["regen", "chunked"])
def test_origin_chunk_keys_change_no_pixel(monkeypatch, engine):
    monkeypatch.setenv("MCPT_BATCH_TRACE", "0")  # the unbatched regen body
    cfg = to_torch_config(_lit_mesh_box(spp=2, res=8, depth_max=3))
    seen = []
    march_order = TT.march_order

    def spy(*args, **kwargs):
        seen.append(kwargs.get("coherence", args[6] if len(args) > 6 else None))
        return march_order(*args, **kwargs)

    monkeypatch.setattr(TT, "march_order", spy)
    images = []
    for flag in ("0", "1"):
        monkeypatch.setenv("MCPT_COH", flag)
        seen.clear()
        images.append(Renderer(cfg, device="cpu").render(engine=engine))
        with_keys = [c is not None for c in seen]
        assert any(with_keys) == (flag == "1"), engine
    assert images[0].mean() > 0.01
    np.testing.assert_array_equal(images[1], images[0])


def test_native_sah_is_the_python_list_reversed():
    verts = random_soup(3000, seed=28)
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    cent = 0.5 * (lo + hi)
    for leaf in (16, 64):
        py = _sah_chunks_py(cent, lo, hi, leaf)
        got = native.sah_chunks(cent, lo, hi, leaf)
        assert len(got) == len(py) > 10
        for a, b in zip(got, py[::-1]):
            np.testing.assert_array_equal(a, b)
    assert native.library_path("sah").parent.parent.name == "_build"
