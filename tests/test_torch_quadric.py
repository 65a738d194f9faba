"""The port's analytic quadrics (ops/quadric.py) and the scene-level merge
(ops/scene_intersect.py) against mcpt_tpu, on the CPU.

The same seeded inputs go through both packages:

* the tables equal bit for bit (the same numpy commit);
* intersect_quadrics, closest and any hit, on 4096 rays a case aimed at
  rows of every kind under rotation, uniform and non-uniform scale and a
  flipped row: t at rtol 1e-5, atol 1e-6 and the row and `inside` equal
  on every lane but at most QUAD_SHARE (0.25%): the port tests the rows
  of one kind together, the reference one by one, and a 3-term matmul
  may round its last ulp another way, which moves a grazing ray's
  ill-conditioned root across a row's silhouette or t_min;
* quadric_attrs at hit points and sample_quadric_row at seeded uniforms:
  frames and uv at rtol 1e-4, atol 1e-5 on the same share (atan2 and
  acos of two libraries differ in their last ulps, and phi wraps at 0);
* scene_closest and scene_any on a Cornell box with a sphere, a disk and
  a cylinder in it, per lane: valid, quad and inside equal, t at rtol
  1e-5, prim equal where a triangle wins (no exact-t ties here);
* an all-quadric scene compiles to the reference's tables and facts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.ops import quadric as JQ
from mcpt_tpu.ops import scene_intersect as JS
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.ops import quadric as TQ
from mcpt_tpu_torch.ops import scene_intersect as TS
from mcpt_tpu_torch.scene import ir as tir
from mcpt_tpu_torch.scene.builtin import _xform, cornell_box
from mcpt_tpu_torch.scene.compile import compile_scene
from tests.test_torch_scene import (STATIC_FACTS, jax_scene_arrays,
                                    reference_leaf, to_jax_config,
                                    torch_scene_arrays)

N = 4096
QUAD_SHARE = 0.0025


def _rows():
    """One row of every kind, and a second sphere and cylinder, under
    rotation, uniform and non-uniform scale; the disk flipped."""
    return [
        dict(kind=TQ.KIND_SPHERE, params=(0.7, 0.0), inst_id=3, flip=False,
             to_world=_xform(scale=(1.5,) * 3, rot_y=20, t=(0.2, 0.1, -0.3))),
        dict(kind=TQ.KIND_DISK, params=(0.5, 0.0), inst_id=5, flip=True,
             to_world=_xform(scale=(2.0, 1.2, 1.0), rot_x=-70,
                             t=(-0.4, -1.0, 0.2))),
        dict(kind=TQ.KIND_CYLINDER, params=(0.3, 1.6), inst_id=7, flip=False,
             to_world=_xform(scale=(1.0, 1.0, 1.3), rot_x=30, rot_y=45,
                             t=(1.2, -0.5, 0.4))),
        dict(kind=TQ.KIND_SPHERE, params=(0.25, 0.0), inst_id=8, flip=False,
             to_world=_xform(scale=(1.0, 2.0, 1.0), t=(-1.1, 0.8, 0.5))),
        dict(kind=TQ.KIND_CYLINDER, params=(0.5, 0.5), inst_id=9, flip=True,
             to_world=_xform(rot_x=90, t=(0.0, 1.5, -1.0))),
    ]


KINDS = tuple((r["kind"], True) for r in _rows())


def _tables():
    rows = _rows()
    return TQ.build_quadric_tables(rows, "cpu"), JQ.build_quadric_tables(rows)


def _rays(seed=0, n=N):
    """Origins in a box around the rows (some inside them), directions
    aimed near a random row's center; t bounds with a spread."""
    r = np.random.default_rng(seed)
    f = np.float32
    o = r.uniform(-3, 3, (n, 3)).astype(f)
    o[: n // 8] = r.uniform(-0.5, 0.5, (n // 8, 3))  # inside the big sphere
    centers = np.stack([row["to_world"][:3, 3] for row in _rows()])
    aim = centers[r.integers(0, len(centers), n)] + r.normal(0, 0.6, (n, 3))
    d = (aim - o).astype(f)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.where(r.random(n) < 0.2, r.uniform(0, 2, n), 1e-4).astype(f)
    t_max = np.where(r.random(n) < 0.2, r.uniform(1, 5, n), 3e38).astype(f)
    return o, d, t_min, t_max


def test_quadric_tables_equal():
    t, j = _tables()
    for f in TQ.QuadricTables._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    et = TQ.empty_quadrics("cpu")
    ej = JQ.empty_quadrics()
    for f in TQ.QuadricTables._fields:
        np.testing.assert_array_equal(getattr(et, f).numpy(),
                                      np.asarray(getattr(ej, f)), err_msg=f)


@pytest.mark.parametrize("any_hit", [False, True])
def test_intersect_quadrics_matches_reference(any_hit):
    tq, jq = _tables()
    o, d, lo, hi = _rays()
    kinds = KINDS if not any_hit else tuple(
        (k, i != 2) for i, (k, _) in enumerate(KINDS))  # row 2 not opaque
    gt, gi, gin = TQ.intersect_quadrics(tq, kinds, torch.as_tensor(o),
                                        torch.as_tensor(d), torch.as_tensor(lo),
                                        torch.as_tensor(hi), any_hit=any_hit)
    jt, ji, jin = JQ.intersect_quadrics(jq, kinds, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(lo),
                                        jnp.asarray(hi), any_hit=any_hit)
    jt, ji, jin = map(np.asarray, (jt, ji, jin))
    gi = gi.numpy()
    bad = ((gi != ji) | (gin.numpy() != jin)
           | ~np.isclose(gt.numpy(), jt, rtol=1e-5, atol=1e-6))
    assert bad.mean() <= QUAD_SHARE, bad.mean()
    assert gi.dtype == np.int32
    for row in range(len(kinds)):  # every row is hit, but row 2 in any-hit
        assert ((ji == row).sum() > 20) == (not any_hit or row != 2), row
    assert (ji == -1).sum() > 100 and jin[ji >= 0].any()


def test_quadric_attrs_and_samples_match_reference():
    tq, jq = _tables()
    o, d, lo, hi = _rays(seed=1)
    jt, ji, _ = map(np.asarray, JQ.intersect_quadrics(
        jq, KINDS, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
        jnp.asarray(hi)))
    hit = ji >= 0
    pos = (o + np.minimum(jt, 1e8)[:, None] * d)[hit]
    idx = ji[hit]
    got = TQ.quadric_attrs(tq, KINDS, torch.as_tensor(idx), torch.as_tensor(pos))
    want = JQ.quadric_attrs(jq, KINDS, jnp.asarray(idx), jnp.asarray(pos))
    bad = np.zeros(len(idx), bool)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
            continue
        if g.ndim == 1:
            g, w = g[:, None], w[:, None]
        bad |= ~np.isclose(g, w, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert bad.mean() <= QUAD_SHARE, bad.mean()

    r = np.random.default_rng(2)
    xi0, xi1 = r.random(N, dtype=np.float32), r.random(N, dtype=np.float32)
    for i, (kind, _) in enumerate(KINDS):
        got = TQ.sample_quadric_row(tq, i, kind, torch.as_tensor(xi0),
                                    torch.as_tensor(xi1))
        want = JQ.sample_quadric_row(jq, i, kind, jnp.asarray(xi0),
                                     jnp.asarray(xi1))
        bad = np.zeros(N, bool)
        for g, w in zip(got, want):
            bad |= ~np.isclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-5).all(axis=-1)
        assert bad.mean() <= QUAD_SHARE, (kind, bad.mean())


def _quadric_box():
    """The Cornell box with a sphere on the short box, a disk on the back
    wall and a cylinder standing on the floor."""
    cfg = cornell_box(res=16, spp=2, depth_max=3)
    cfg.instances += [
        tir.InstanceInfo(shape="sphere", id_bsdf=0, radius=0.25,
                         center=np.array([0.35, 0.85, 0.3], np.float32)),
        tir.InstanceInfo(shape="disk", id_bsdf=1,
                         to_world=_xform(scale=(0.6, 0.6, 1.0),
                                         t=(0.0, 1.3, -0.999))),
        tir.InstanceInfo(shape="cylinder", id_bsdf=2, radius=0.1,
                         p0=np.array([-0.6, 0.0, 0.4], np.float32),
                         p1=np.array([-0.6, 0.9, 0.4], np.float32),
                         flip_normals=True),
    ]
    return cfg


def test_scene_hits_merge_triangles_and_quadrics():
    cfg = _quadric_box()
    ts = compile_scene(cfg, device="cpu")
    js = jax_compile_scene(to_jax_config(cfg))
    assert ts.quad_kinds == js.quad_kinds == ((0, True), (1, True), (2, True))
    r = np.random.default_rng(3)
    o = np.tile(np.array([0.0, 1.0, 3.5], np.float32), (N, 1))
    o[N // 2:] = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N // 2, 3))
    aim = r.uniform([-1, 0, -1], [1, 2, 1], (N, 3))
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hi = np.where(r.random(N) < 0.3, r.uniform(0.2, 3, N), 3e38).astype(np.float32)
    args_t = [torch.as_tensor(x) for x in (o, d)]
    args_j = [jnp.asarray(x) for x in (o, d)]
    got = TS.scene_closest(ts, *args_t, t_max=torch.as_tensor(hi))
    want = JS.scene_closest(js, *args_j, t_max=jnp.asarray(hi))
    for f in ("valid", "quad", "inside"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    tri = got.valid.numpy() & (got.quad.numpy() < 0)
    np.testing.assert_array_equal(got.prim.numpy()[tri],
                                  np.asarray(want.prim)[tri])
    assert (got.quad.numpy() >= 0).sum() > 200 and tri.sum() > 200
    occ_t = TS.scene_any(ts, *args_t, t_max=torch.as_tensor(hi))
    occ_j = JS.scene_any(js, *args_j, t_max=jnp.asarray(hi))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    assert occ_t.any() and not occ_t.all()


def test_all_quadric_scene_compiles_as_the_reference():
    """A scene of analytic shapes only (the reference's mercury class):
    one degenerate sliver triangle, not opaque, so all_opaque is False;
    an emissive sphere owns one CDF cell."""
    cfg = _quadric_box()
    cfg.instances = cfg.instances[-3:] + [tir.InstanceInfo(
        shape="sphere", id_bsdf=3, radius=0.2,
        center=np.array([0.0, 1.8, 0.0], np.float32))]
    ts = compile_scene(cfg, device="cpu")
    js = jax_compile_scene(to_jax_config(cfg))
    ref = jax_scene_arrays(js)
    for key, value in torch_scene_arrays(ts).items():
        np.testing.assert_array_equal(value, reference_leaf(ref, key),
                                      err_msg=key)
    for fact in STATIC_FACTS + ("n_emissive",):
        assert getattr(ts, fact) == getattr(js, fact), fact
    assert ts.em_quad_cells == ((0, 3, TQ.KIND_SPHERE),)
    assert not ts.all_opaque
