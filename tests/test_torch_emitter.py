"""The port's emitters (models/emitter.py) and its NEE draw layout
against mcpt_tpu, on the CPU.

* The analytic emitters' tables equal; sample_point, sample_spot (with
  and without a projection bitmap, inside and outside the beam's edge),
  sample_directional, sample_sun, sample_constant and eval_sun_escape
  per lane on 4096 seeded origins and uniforms: rtol 1e-5, atol 1e-6,
  `valid` equal; at most EMIT_SHARE (0.25%) of lanes beyond it, for the
  acos/atan2 ulps that move a spot's falloff or a sun-bitmap lookup by a
  texel.
* The alias table bit for bit: the Python build against the reference's
  `_alias_build_py` at <= 4096 texels, and the running-sum build against
  the reference's native `alias_build` at 8192 texels (where the two
  reference builds differ, so the sum order matters); build_envmap's
  tables at 64 x 32, at 128 x 64 (past 4096 texels) and for an all-black
  map equal; sample_envmap, eval_envmap and pdf_envmap per lane at rtol
  1e-5, atol 1e-6 and EMIT_SHARE, pdf > 0 exact.
* _nee_query_count and nee_draw_count equal the reference's over every
  set of emitters (each subset of point, spot, directional, sun, with no
  escape emitter, an envmap or a constant sky, with and without an area
  light) x opacity maps x MCPT_NEE_RR_TAU in {0, 0.05}.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu import native
from mcpt_tpu.integrators import path as JP
from mcpt_tpu.models import emitter as JE
from mcpt_tpu.models.texture import TextureBuilder as JaxTextureBuilder
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu_torch.integrators import path as TP
from mcpt_tpu_torch.models import emitter as TE
from mcpt_tpu_torch.models.texture import TextureBuilder
from mcpt_tpu_torch.scene import ir as tir
from mcpt_tpu_torch.scene.builtin import _xform, cornell_box
from mcpt_tpu_torch.scene.compile import compile_scene
from tests.test_torch_scene import to_jax_config

N = 4096
EMIT_SHARE = 0.0025
#: the differentiable envmap reads' relative tolerance
DIFF_RTOL = 3e-4


def _emitters():
    """One emitter of every analytic kind, and a spot without texture; a
    builder with the spot's projection and the sun's bitmap."""
    r = np.random.default_rng(0)
    tb = TextureBuilder()
    proj = tb.add_bitmap(r.random((16, 16, 3), dtype=np.float32))
    sun_tex = tb.add_bitmap(r.random((32, 64, 3), dtype=np.float32) * 10)
    E = tir.EmitterType
    infos = [
        tir.EmitterInfo(etype=E.POINT,
                        position=np.array([0.5, 2.0, -0.3], np.float32),
                        intensity=np.array([5.0, 4.0, 3.0], np.float32)),
        tir.EmitterInfo(etype=E.SPOT, cutoff_angle=30.0, beam_width=20.0,
                        intensity=np.array([8.0, 8.0, 8.0], np.float32),
                        id_texture=proj,
                        to_world=_xform(rot_x=90, rot_y=10, t=(0, 3, 0))),
        tir.EmitterInfo(etype=E.SPOT, cutoff_angle=40.0, beam_width=10.0,
                        to_world=_xform(rot_x=120, t=(1.0, 2.5, 0.5))),
        tir.EmitterInfo(etype=E.DIRECTIONAL,
                        direction=np.array([0.3, -1.0, 0.2], np.float32),
                        radiance=np.array([0.5, 0.6, 0.7], np.float32)),
        tir.EmitterInfo(etype=E.SUN, cutoff_angle=3.0, id_texture=sun_tex,
                        direction=np.array([-0.4, -0.8, -0.45], np.float32),
                        radiance=np.array([2.0, 1.8, 1.5], np.float32)),
        tir.EmitterInfo(etype=E.CONSTANT,
                        radiance=np.array([0.2, 0.3, 0.4], np.float32)),
    ]
    return tb, infos


def _pair():
    tb, infos = _emitters()
    jtb, jinfos = to_jax_config([tb, infos])
    return ((TE.build_emitter_tables(infos, "cpu"), tb.build("cpu")),
            (JE.build_emitter_tables(jinfos), jtb.build()))


def _lanes(seed=1):
    r = np.random.default_rng(seed)
    f = np.float32
    origin = r.uniform([-2, 0, -2], [2, 1, 2], (N, 3)).astype(f)
    return (origin, r.random(N, dtype=f), r.random(N, dtype=f),
            r.random(N, dtype=f))


def _hold(got, want, rtol=1e-5):
    bad = np.zeros(N, bool)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w)
            continue
        assert np.isfinite(g).all() and g.shape == w.shape
        g, w = g.reshape(N, -1), w.reshape(N, -1)
        bad |= ~np.isclose(g, w, rtol=rtol, atol=1e-6).all(axis=-1)
    assert bad.mean() <= EMIT_SHARE, bad.mean()


def test_emitter_tables_equal():
    (t, _), (j, _) = _pair()
    for f in TE.EmitterTables._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("row", [0, 1, 2, 3, 4, 5],
                         ids=["point", "spot-tex", "spot", "directional",
                              "sun", "constant"])
def test_sample_emitter_matches_reference(row):
    (t, ttex), (j, jtex) = _pair()
    origin, xi0, xi1, _ = _lanes()
    o_t, o_j = torch.as_tensor(origin), jnp.asarray(origin)
    x_t = (torch.as_tensor(xi0), torch.as_tensor(xi1))
    x_j = (jnp.asarray(xi0), jnp.asarray(xi1))
    if row == 0:
        got, want = TE.sample_point(t, 0, o_t), JE.sample_point(j, 0, o_j)
    elif row in (1, 2):
        got = TE.sample_spot(t, ttex, row, o_t)
        want = JE.sample_spot(j, jtex, row, o_j)
        # the falloff's edge and the cutoff are both in play
        valid = np.asarray(want[3])
        assert valid.any() and not valid.all()
    elif row == 3:
        got = TE.sample_directional(t, 3, o_t)
        want = JE.sample_directional(j, 3, o_j)
    elif row == 4:
        got = TE.sample_sun(t, 4, o_t, *x_t)
        want = JE.sample_sun(j, 4, o_j, *x_j)
        _hold([TE.eval_sun_escape(t, ttex, 4, -got[0])],
              [JE.eval_sun_escape(j, jtex, 4, -want[0])])
    else:
        got = TE.sample_constant(t, 5, o_t, *x_t)
        want = JE.sample_constant(j, 5, o_j, *x_j)
    _hold(got, want)


@pytest.mark.parametrize("n", [1, 7, 100, 4096])
def test_alias_table_python_build_bit_equal(n):
    w = (np.random.default_rng(n).random(n) ** 3).astype(np.float32)
    w[1::5] = 0.0
    prob, al = TE._alias_build_py(w)
    jprob, jal = JE._alias_build_py(w)
    np.testing.assert_array_equal(prob.view(np.int32), jprob.view(np.int32))
    np.testing.assert_array_equal(al, jal)


def test_alias_table_native_order_bit_equal():
    w = (np.random.default_rng(0).random(8192) ** 3).astype(np.float32)
    prob, al = TE.alias_build(w)
    nprob, nal = native.alias_build(w)
    np.testing.assert_array_equal(prob.view(np.int32), nprob.view(np.int32))
    np.testing.assert_array_equal(al, nal)
    # the reference's two builds differ on these weights: the order of
    # the sum matters
    assert not np.array_equal(JE._alias_build_py(w)[0], nprob)
    assert not np.array_equal(TE._alias_build_py(w)[0], nprob)
    with pytest.raises(ValueError):
        TE.alias_build(np.zeros(8192, np.float32))


def _sky(h, w, black=False):
    r = np.random.default_rng(h)
    px = r.random((h, w, 3), dtype=np.float32)
    px[h // 4, w // 3] = 500.0
    return np.zeros_like(px) if black else px


@pytest.mark.parametrize("h,w,black", [(32, 64, False), (64, 128, False),
                                       (8, 16, True)],
                         ids=["2048-texels", "8192-texels", "black"])
def test_envmap_tables_and_queries_match_reference(h, w, black):
    px = _sky(h, w, black)
    m = _xform(rot_y=35, rot_x=10)
    t = TE.build_envmap(px, m, 0, "cpu")
    j = JE.build_envmap(px, m, 0)
    assert (t.width, t.height) == (j.width, j.height) == (w, h)
    for f in TE.EnvMapData._fields[:5]:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    origin, xi0, xi1, xi2 = _lanes(seed=h)
    got = TE.sample_envmap(t, None, torch.as_tensor(origin),
                           *map(torch.as_tensor, (xi0, xi1, xi2)))
    want = JE.sample_envmap(j, None, jnp.asarray(origin),
                            *map(jnp.asarray, (xi0, xi1, xi2)))
    _hold(got, want)
    assert np.asarray(want[4]).all()  # pdf > 0 on every lane
    look = np.random.default_rng(9).normal(size=(N, 3)).astype(np.float32)
    _hold([TE.eval_envmap(t, None, torch.as_tensor(look)),
           TE.pdf_envmap(t, None, torch.as_tensor(look))],
          [JE.eval_envmap(j, None, jnp.asarray(look)),
           JE.pdf_envmap(j, None, jnp.asarray(look))])
    # the differentiable reads: the bitmap through the texture atlas,
    # bilinear, so the ulps acos/atan2 leave in an escape's uv move the
    # weights (up to 1.6e-4 relative measured): rtol DIFF_RTOL
    ttex, jtex = TextureBuilder(), JaxTextureBuilder()
    assert ttex.add_bitmap(px) == jtex.add_bitmap(px) == 0
    ttex, jtex = ttex.build("cpu"), jtex.build()
    _hold([TE.sample_envmap(t, ttex, torch.as_tensor(origin),
                            *map(torch.as_tensor, (xi0, xi1, xi2)),
                            differentiable=True)[2],
           TE.eval_envmap(t, ttex, torch.as_tensor(look), differentiable=True)],
          [JE.sample_envmap(j, jtex, jnp.asarray(origin),
                            *map(jnp.asarray, (xi0, xi1, xi2)),
                            differentiable=True)[2],
           JE.eval_envmap(j, jtex, jnp.asarray(look), differentiable=True)],
          rtol=DIFF_RTOL)


def _nee_scene(kinds, env, area):
    """The Cornell box with the analytic emitters `kinds`, the escape
    emitter `env` ("none", "envmap", "constant") and its area light or
    not, in the port's IR."""
    cfg = cornell_box(res=8, spp=1)
    E = tir.EmitterType
    for k in kinds:
        cfg.emitters.append(tir.EmitterInfo(etype=k))
    if env == "envmap":
        tid = cfg.textures.add_bitmap(np.ones((4, 8, 3), np.float32))
        cfg.emitters.append(tir.EmitterInfo(etype=E.ENVMAP, id_texture=tid))
    elif env == "constant":
        cfg.emitters.append(tir.EmitterInfo(etype=E.CONSTANT))
    if not area:
        cfg.instances = cfg.instances[:-1]
    return cfg


_E = tir.EmitterType
EMITTER_SETS = [c for r in range(5) for c in itertools.combinations(
    (_E.POINT, _E.SPOT, _E.DIRECTIONAL, _E.SUN), r)]


@pytest.mark.parametrize("tau", ["0", "0.05"])
@pytest.mark.parametrize("opacity", [False, True])
def test_nee_draw_layout_matches_reference(monkeypatch, opacity, tau):
    """Every emitter set x escape emitter x area light, compiled by both
    packages: the same shadow queries and draws a vertex."""
    monkeypatch.setenv("MCPT_NEE_RR_TAU", tau)
    seen = set()
    for kinds, env, area in itertools.product(
            EMITTER_SETS, ("none", "envmap", "constant"), (False, True)):
        cfg = _nee_scene(kinds, env, area)
        if opacity:
            cfg.bsdfs[0].id_opacity = cfg.textures.add_constant([0.5] * 3)
        ts = compile_scene(cfg, device="cpu")
        js = jax_compile_scene(to_jax_config(cfg))
        q, k = TP._nee_query_count(ts), TP.nee_draw_count(ts)
        assert (q, k) == (JP._nee_query_count(js),
                          JP.nee_draw_count(js)), (kinds, env, area)
        assert (ts.emitter_rows, ts.env_kind, ts.has_opacity) == (
            js.emitter_rows, js.env_kind, js.has_opacity)
        assert ts.emitter_rows == tuple((i, int(e)) for i, e in enumerate(kinds))
        seen.add(k)
    assert len(seen) > 10
