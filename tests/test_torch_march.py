"""Slice 2, the march route of mcpt_tpu_torch on the CPU, against mcpt_tpu:
the SAH chunk pack, the ray sort keys, routing, and K2's plain version
with the wrapper flow around it.

* The march pack equals the reference's commit_geometry leaf for leaf
  (numpy arithmetic on both sides): exact.
* Sort keys: bit-equal in every MCPT_MARCH_SORT mode, with and without
  origin-chunk coherence keys.
* Hits, by tests/test_pallas_pairs.py::_assert_same_hits: valid equal;
  t, v, w within rtol 1e-5, atol 1e-5 (XLA on the CPU contracts
  multiply-adds into FMAs, torch rounds each op); inside equal; prim
  equal but on exact-t ties, where the port's prim must reproduce the
  reference's t.  Any-hit: valid equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.ops.traversal as JT
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu.scene.geometry import _sah_chunks_py as jax_sah_chunks_py
from mcpt_tpu.scene.geometry import commit_geometry as jax_commit_geometry
from mcpt_tpu_torch.ops import march_sweep as msw
from mcpt_tpu_torch.ops import traversal as TT
from mcpt_tpu_torch.scene.builtin import cornell_mesh_march, cornell_mesh_pairs
from mcpt_tpu_torch.scene.compile import compile_scene
from mcpt_tpu_torch.scene.geometry import _sah_chunks_py, commit_geometry
from tests.test_batched_regen import make_mesh_box_scene
from tests.test_bvh import random_rays, random_soup
from tests.test_torch_dense_sweep import _assert_same_hits
from tests.test_torch_scene import to_jax_config, to_torch_config

FMAX = 3.4e38
PACK = ("march_tris", "march_min", "march_max", "march_chunk_of_prim")


def _soup(n_tris, seed, opaque_frac=1.0):
    verts = random_soup(n_tris, seed=seed)
    r = np.random.default_rng(seed + 100)
    dup = r.choice(n_tris, size=(n_tris // 20, 2), replace=False)
    verts[dup[:, 1]] = verts[dup[:, 0]]  # exact-t ties
    opaque = r.uniform(size=n_tris) < opaque_frac
    inst = np.zeros(n_tris)
    return (jax_commit_geometry(verts, None, None, None, inst, tri_opaque=opaque),
            commit_geometry(verts, None, None, None, inst, "cpu",
                            tri_opaque=opaque))


def _reference_sah_is_native() -> bool:
    """Whether the reference's commit_geometry takes its chunks from
    mcpt_tpu/native/sah.c, as it does wherever that builds, rather than
    from the Python oracle it falls back to (the same call and the same
    catch as mcpt_tpu.scene.geometry._sah_chunks)."""
    try:
        from mcpt_tpu import native

        native.sah()
        return True
    except Exception:
        return False


def _reference_pack(jg, native):
    """The reference's pack in the port's chunk order.  The port lists the
    chunks as native/sah.c does; where that does not build, the reference
    lists them in the Python oracle's order, which is the reverse
    (ROADMAP section 3, R3): the same chunks, leaf for leaf, reversed."""
    pack = {f: np.asarray(getattr(jg, f)) for f in PACK}
    if native:
        return pack
    lm = jg.n_march_leaves
    for f in ("march_tris", "march_min", "march_max"):
        pack[f] = pack[f][::-1]
    cop = pack["march_chunk_of_prim"].copy()
    cop[: jg.n_real_prims] = lm - 1 - cop[: jg.n_real_prims]
    pack["march_chunk_of_prim"] = cop
    return pack


def _assert_pack_equal(tg, jg, native=None):
    assert (tg.n_march_leaves, tg.march_leaf) == (jg.n_march_leaves,
                                                  jg.march_leaf)
    if native is None:
        native = _reference_sah_is_native()
    ref = _reference_pack(jg, native)
    for f in PACK:
        np.testing.assert_array_equal(getattr(tg, f).numpy(), ref[f],
                                      err_msg=f)
    np.testing.assert_array_equal(
        tg.march_prim.numpy(), ref["march_tris"][..., 10].astype(np.int32))
    np.testing.assert_array_equal(tg.bounds_min.numpy(), np.asarray(jg.node_min[0]))
    np.testing.assert_array_equal(tg.bounds_max.numpy(), np.asarray(jg.node_max[0]))


def test_sah_chunks_copy_is_verbatim():
    """Same chunks in the same (stack-pop) order as the reference's oracle."""
    verts = random_soup(3000, seed=2)
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    cent = 0.5 * (lo + hi)
    for leaf in (16, 64):
        got = _sah_chunks_py(cent, lo, hi, leaf)
        ref = jax_sah_chunks_py(cent, lo, hi, leaf)
        assert len(got) == len(ref) > 10
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_march_pack_equals_reference_on_random_soup():
    jg, tg = _soup(900, seed=3)
    _assert_pack_equal(tg, jg)


def test_march_pack_equals_reference_python_oracle_reversed(monkeypatch):
    """Where native/sah.c does not build, the reference lists the same
    chunks in the reverse order; the port's pack is that one reversed."""
    from mcpt_tpu import native

    def unbuilt(*args, **kwargs):
        raise OSError("native/sah.c not built")

    monkeypatch.setattr(native, "sah_chunks", unbuilt)
    jg, tg = _soup(900, seed=3)
    assert tg.n_march_leaves > 2
    _assert_pack_equal(tg, jg, native=False)


def test_march_pack_equals_reference_on_mesh_box_scene():
    """The 21632-triangle floor of tests/test_batched_regen.py, compiled by
    both packages."""
    cfg = make_mesh_box_scene()
    tg = compile_scene(to_torch_config(cfg), device="cpu").geom
    jg = jax_compile_scene(cfg).geom
    assert tg.packed_tris.shape[0] > TT.DENSE_MAX_PRIMS
    _assert_pack_equal(tg, jg)


def test_march_pack_knobs(monkeypatch):
    """MCPT_MARCH_LEAF and MCPT_MARCH_MAX_CHUNKS as the reference reads
    them: 8-prim chunks, doubled until at most 40 chunks remain."""
    monkeypatch.setenv("MCPT_MARCH_LEAF", "8")
    monkeypatch.setenv("MCPT_MARCH_MAX_CHUNKS", "40")
    jg, tg = _soup(1000, seed=4)
    assert tg.march_leaf >= 32 and tg.n_march_leaves <= 40
    _assert_pack_equal(tg, jg)


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("mode", ["octori", "dirori", "octdir"])
def test_ray_sort_keys_bit_equal(monkeypatch, mode, coherent):
    jg, tg = _soup(700, seed=5)
    o, d = random_rays(4096, seed=6)
    o = np.array(o)
    o[:64] = np.array(jg.node_min[0]) - 1.0  # outside the bounds: clamped
    d = np.array(d)
    d[64:96, 1] = 0.0  # octant edge: d == 0 counts as positive
    coh = np.random.default_rng(7).integers(-1, 3000, size=4096).astype(np.int32)
    monkeypatch.setenv("MCPT_MARCH_SORT", mode)
    got = TT._ray_sort_keys(tg, torch.as_tensor(o), torch.as_tensor(d),
                            coherence=torch.as_tensor(coh) if coherent else None)
    ref = JT._ray_sort_keys(jg, jnp.asarray(o), jnp.asarray(d),
                            coherence=jnp.asarray(coh) if coherent else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.max()) < (1 << 28) and len(np.unique(got.numpy())) > 100


def _rays(n, seed, dead_every=0, cut=False):
    o, d = random_rays(n, seed=seed)
    t_max = np.full(n, FMAX, np.float32)
    if cut:
        t_max[1::3] = np.random.default_rng(seed).uniform(1.0, 8.0, n)[1::3]
    if dead_every:
        t_max[::dead_every] = 0.0
    return o, d, t_max


def _plain(tg, o, d, t_max, any_hit):
    n = t_max.shape[0]
    return msw.march_sweep_plain(
        torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)),
        torch.full((n,), 1e-4), torch.as_tensor(t_max), tg.march_min,
        tg.march_max, tg.march_tris, tg.march_prim, any_hit=any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("cut,dead", [(False, 0), (True, 7)])
def test_plain_march_matches_xla_march(cut, dead, any_hit):
    """The per-lane march against the reference's XLA march, with a t_max
    window on every third ray and dead lanes."""
    jg, tg = _soup(1200, seed=8, opaque_frac=0.6)
    o, d, t_max = _rays(900, seed=9, dead_every=dead, cut=cut)
    ref = JT._intersect_march(jg, o, d, 1e-4, jnp.asarray(t_max), any_hit)
    got = _plain(tg, o, d, t_max, any_hit)
    if any_hit:
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        assert bool(got.valid.any())
    else:
        _assert_same_hits(got, ref, o, d, tg)
    if dead:
        assert not bool(got.valid[::dead].any())


#: K2's knobs as the reference reads them while it traces its march:
#: the super-chunk cull, the interval phase A, the group's lane target
MARCH_KNOBS = {
    "default": {},
    "super-off": {"MCPT_MARCH_SUPER": "0"},
    "interval": {"MCPT_MARCH_IVAL": "1"},
    "interval-super-off": {"MCPT_MARCH_IVAL": "1", "MCPT_MARCH_SUPER": "0"},
    "group-256": {"MCPT_MARCH_GROUP": "256"},
}


@pytest.mark.parametrize("knobs,any_hit", [
    ("default", False), ("default", True), ("super-off", False),
    ("interval", False), ("interval-super-off", True), ("group-256", False),
])
def test_plain_march_matches_pallas_interpret(monkeypatch, knobs, any_hit):
    """The reference's Pallas block march in interpret mode, as
    tests/test_pallas_march.py runs it, at each knob setting: the plain
    per-lane march is the oracle of every one (only the visiting order
    moves).  The reference reads the knobs while tracing, so its caches
    are cleared."""
    import jax

    for k in ("MCPT_MARCH_SUPER", "MCPT_MARCH_IVAL", "MCPT_MARCH_GROUP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in MARCH_KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    jax.clear_caches()
    jg, tg = _soup(900, seed=10, opaque_frac=0.6)
    o, d, t_max = _rays(500, seed=11, dead_every=5, cut=True)
    ref = JT._intersect_march_pallas(jg, o, d, 1e-4, jnp.asarray(t_max),
                                     any_hit, interpret=True)
    jax.clear_caches()
    got = _plain(tg, o, d, t_max, any_hit)
    if any_hit:
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    else:
        _assert_same_hits(got, ref, o, d, tg)


@pytest.mark.parametrize("ls", [16, 64, 128, 256])
@pytest.mark.parametrize("target", [None, "1", "100", "300", "512", "1024",
                                    "1536"])
def test_chunk_group_matches_reference(monkeypatch, ls, target):
    """The port's group count is the reference's _chunk_group(ls, r) at
    the default 256-ray block, wherever the reference's scoped-VMEM clamp
    (a lane target above 384k / r = 1536) does not bind."""
    from mcpt_tpu.ops.pallas_march import _chunk_group

    if target is None:
        monkeypatch.delenv("MCPT_MARCH_GROUP", raising=False)
    else:
        monkeypatch.setenv("MCPT_MARCH_GROUP", target)
    assert msw.chunk_group(ls) == _chunk_group(ls, 256)


def test_march_knobs_parse_as_the_reference(monkeypatch):
    """MCPT_MARCH_GROUP, MCPT_MARCH_SUPER and MCPT_MARCH_IVAL: the values
    the reference's march wrapper hands its kernel (caught at the kernel's
    call) are those the port reads, for each distinct case of the two
    flags (unset, "1", "0", another word); the group target is held by
    test_chunk_group_matches_reference, and its clamp to the card's shared
    memory by the card tests."""
    import mcpt_tpu.ops.pallas_march as PM
    from mcpt_tpu.ops.pallas_march import _chunk_group

    jg, _ = _soup(300, seed=15)
    o, d, t_max = _rays(64, seed=16)
    seen = {}

    def fake_march(rays, cmin, cmax, tris, **kw):
        seen.update(kw)
        g, _, r = rays.shape
        return tuple(jnp.zeros((g, r, 1), t)
                     for t in (jnp.float32, jnp.int32, jnp.float32,
                               jnp.float32, jnp.float32))

    monkeypatch.setattr(PM, "march_sweep", fake_march)
    for sup, ival in ((None, "1"), ("1", None), ("0", "0"), ("yes", "true")):
        for k, v in (("MCPT_MARCH_SUPER", sup), ("MCPT_MARCH_IVAL", ival)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        JT._intersect_march_pallas(jg, o, d, 1e-4, jnp.asarray(t_max), False)
        assert msw.use_super_cull() == seen["super_cull"]
        assert msw.use_interval() == seen["interval"]
    monkeypatch.setenv("MCPT_MARCH_GROUP", "many")
    with pytest.raises(ValueError):
        _chunk_group(256, 256)
    with pytest.raises(ValueError):
        msw.chunk_group(256)


@pytest.mark.parametrize("lm", [128, 256, 640])
def test_super_boxes_match_reference(monkeypatch, lm):
    """The port's super-chunk unions equal the smin/smax the reference's
    march_sweep builds (pallas_march.py:467-486), caught where it calls
    its kernel, for an Lm that is a multiple of 128."""
    import jax
    from jax.experimental import pallas as pl

    import mcpt_tpu.ops.pallas_march as PM

    r = np.random.default_rng(lm)
    lo = r.uniform(-5, 5, size=(lm, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 2, size=(lm, 3)).astype(np.float32)
    seen = []

    def fake_pallas_call(kernel, **kw):
        def run(*args):
            seen.extend(args)
            return [jnp.zeros(s.shape, s.dtype) for s in kw["out_shape"]]
        return run

    monkeypatch.setattr(pl, "pallas_call", fake_pallas_call)
    cmin = jnp.asarray(np.concatenate([lo.T, np.zeros((1, lm), np.float32)]))
    cmax = jnp.asarray(np.concatenate([hi.T, np.zeros((1, lm), np.float32)]))
    with jax.disable_jit():
        PM.march_sweep(jnp.zeros((1, 8, 128)), cmin, cmax,
                       jnp.zeros((lm, 16, 128)), super_cull=True)
    smin, smax = (np.asarray(x) for x in seen[3:5])
    got_min, got_max = msw.super_boxes(torch.as_tensor(lo), torch.as_tensor(hi))
    n_sup = lm // 128
    assert got_min.shape == (n_sup, 3)
    np.testing.assert_array_equal(got_min.numpy(), smin[:3, :n_sup].T)
    np.testing.assert_array_equal(got_max.numpy(), smax[:3, :n_sup].T)


def test_super_boxes_partial_last_run():
    """An Lm that is not a multiple of 128: the last union covers the
    remaining chunks only."""
    r = np.random.default_rng(3)
    lo = torch.as_tensor(r.uniform(-5, 5, size=(300, 3)).astype(np.float32))
    hi = lo + 1.0
    smin, smax = msw.super_boxes(lo, hi)
    assert smin.shape == smax.shape == (3, 3)
    for s, e in ((0, 128), (128, 256), (256, 300)):
        assert torch.equal(smin[s // 128], lo[s:e].amin(dim=0))
        assert torch.equal(smax[s // 128], hi[s:e].amax(dim=0))


def test_march_wrapper_on_the_cpu():
    """_intersect_march_cuda's flow (sort, march, inverse permutation) on
    CPU tensors: the plain version runs, no kernel launches, and the class
    bit only re-permutes the rays."""
    jg, tg = _soup(800, seed=12)
    o, d, t_max = _rays(600, seed=13, dead_every=4)
    to, td = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    lo, hi = torch.full((600,), 1e-4), torch.as_tensor(t_max)
    before = msw.launches
    got = TT._intersect_march_cuda(tg, to, td, lo, hi, False)
    biased = TT._intersect_march_cuda(tg, to, td, lo, hi, False,
                                      sort_bias=torch.arange(600) % 2)
    assert msw.launches == before
    for a, b in zip(got, biased):
        assert torch.equal(a, b)
    ref = JT._intersect_march(jg, o, d, 1e-4, jnp.asarray(t_max), False)
    _assert_same_hits(got, ref, o, d, tg)
    order = TT.march_order(tg, to, td, lo, hi)
    assert not bool((hi[order][:450] <= lo[order][:450]).any())  # dead last


def test_resolved_strategy_on_the_builtin_scenes(monkeypatch):
    """Each mesh scene resolves to its route, as in the reference, and
    MCPT_TRAVERSAL overrides it on both sides."""
    monkeypatch.delenv("MCPT_TRAVERSAL", raising=False)
    for make, route in ((cornell_mesh_march, "march"),
                        (cornell_mesh_pairs, "pairs")):
        cfg = make(res=8, spp=1)
        tg = compile_scene(cfg, device="cpu").geom
        jg = jax_compile_scene(to_jax_config(cfg)).geom
        assert tg.packed_tris.shape[0] > TT.DENSE_MAX_PRIMS
        assert TT.resolved_strategy(tg) == JT.resolved_strategy(jg) == route
        assert (tg.march_leaf, tg.n_march_leaves) == (jg.march_leaf,
                                                      jg.n_march_leaves)
        for forced in ("march", "pairs"):
            monkeypatch.setenv("MCPT_TRAVERSAL", forced)
            assert TT.resolved_strategy(tg) == JT.resolved_strategy(jg) == forced
        monkeypatch.delenv("MCPT_TRAVERSAL")


def test_traversal_knobs(monkeypatch):
    monkeypatch.setenv("MCPT_TRAVERSAL", "bvh")
    with pytest.raises(ValueError, match="MCPT_TRAVERSAL"):
        TT._large_strategy()
    monkeypatch.setenv("MCPT_MARCH_BLOCK", "not-a-number")
    with pytest.raises(ValueError):
        msw.ray_block()
    monkeypatch.setenv("MCPT_MARCH_BLOCK", "2048")
    with pytest.raises(ValueError):
        msw.ray_block()
    monkeypatch.setenv("MCPT_MARCH_BLOCK", "200")
    with pytest.warns(UserWarning):
        assert msw.ray_block() == 224
    monkeypatch.delenv("MCPT_MARCH_BLOCK")
    assert msw.ray_block() == msw.DEFAULT_BLOCK == 32


def test_packet_strategy_is_refused(monkeypatch):
    """Named for the refusal it held until the packet route was ported
    (ROADMAP item 22): MCPT_TRAVERSAL=packet now sends a geometry past
    DENSE_MAX_PRIMS (lowered here, so that a small soup is past it) down
    the packet walk, whose closest hits equal the march route's (t
    bit-equal: the same arithmetic) and whose any-hit occlusion equals
    it."""
    from mcpt_tpu_torch.ops import packet_sweep as pkt

    _, tg = _soup(300, seed=14)
    monkeypatch.setattr(TT, "DENSE_MAX_PRIMS", 64)
    o, d, t_max = _rays(300, seed=14, dead_every=5)
    o, d = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    t_max = torch.as_tensor(t_max)
    march = [TT.intersect_closest(tg, o, d, t_max=t_max),
             TT.intersect_any(tg, o, d, t_max=t_max)]
    monkeypatch.setenv("MCPT_TRAVERSAL", "packet")
    calls = []
    sweep = pkt.packet_sweep
    monkeypatch.setattr(pkt, "packet_sweep",
                        lambda *a, **k: calls.append(1) or sweep(*a, **k))
    hit = TT.intersect_closest(tg, o, d, t_max=t_max)
    occ = TT.intersect_any(tg, o, d, t_max=t_max)
    assert calls == [1, 1]
    assert bool(hit.valid.any()) and not bool(hit.valid[::5].any())
    assert torch.equal(hit.valid, march[0].valid)
    assert torch.equal(hit.t, march[0].t)
    assert torch.equal(occ, march[1])
