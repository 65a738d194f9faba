"""Slice 2, the pair route of mcpt_tpu_torch on the CPU, against mcpt_tpu:
the plain versions of K3 (corridor) and K4 (pair sweep) and the whole
pair traversal around them.

* Corridor slots and overflow flags equal the reference's Pallas
  corridor_sweep (interpret mode) exactly: the slab test has no
  multiply-add for XLA to contract, so both sides compute the same bits.
* Hits, by tests/test_pallas_pairs.py::_assert_same_hits (t, v, w within
  rtol 1e-5, atol 1e-5; prim equal but on exact-t ties).  Any-hit: valid
  equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.ops.traversal as JT
from mcpt_tpu.ops.pallas_pairs import CORRIDOR_TILE, corridor_sweep, pair_sweep
from mcpt_tpu_torch.ops import march_sweep as msw
from mcpt_tpu_torch.ops import pair_sweep as psw
from mcpt_tpu_torch.ops import traversal as TT
from tests.test_torch_dense_sweep import ATOL, RTOL, _assert_same_hits
from tests.test_torch_kernels_cuda import pair_case
from tests.test_torch_march import _rays, _soup


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _reference_corridor(jg, o, d, t_max, k):
    """corridor_sweep in the layout _intersect_pairs gives it; ids at or
    above the real chunk count mean none, as the wrapper reads them."""
    n, lm = o.shape[0], jg.n_march_leaves
    g = -(-n // 512)
    pad = g * 512 - n

    def p(a, fill=0.0):
        return np.concatenate([np.asarray(a), np.full(pad, fill, np.float32)])

    rays = np.stack([p(o[:, 0]), p(o[:, 1]), p(o[:, 2]), p(d[:, 0]),
                     p(d[:, 1]), p(d[:, 2], 1.0), p(np.full(n, 1e-4)),
                     p(t_max)]).reshape(8, g, 512).swapaxes(0, 1)
    lm_pad = -(-lm // CORRIDOR_TILE) * CORRIDOR_TILE

    def pc(a):
        return np.concatenate([np.asarray(a), np.full((lm_pad - lm, 3), 3e37,
                                                      np.float32)])

    out = np.asarray(corridor_sweep(jnp.asarray(rays), jnp.asarray(pc(jg.march_min)),
                                    jnp.asarray(pc(jg.march_max)), k=k,
                                    interpret=True))
    slots = np.moveaxis(out[:, :k, :], 1, 2).reshape(-1, k)[:n]
    return np.minimum(slots, lm).astype(np.int32), out[:, k, :].reshape(-1)[:n] > 0


@pytest.mark.parametrize("k", [2, 8])
def test_corridor_plain_equals_pallas_interpret(monkeypatch, k):
    monkeypatch.setenv("MCPT_MARCH_LEAF", "16")
    jg, tg = _soup(1500, seed=20)
    o, d, t_max = _rays(700, seed=21, dead_every=6, cut=True)
    # the reference's own boxes on both sides: the slot ids are chunk ids,
    # and the reference's chunk order depends on its SAH build (R3)
    slots, over = psw.corridor(*_t(o, d),
                               torch.full((700,), 1e-4),
                               torch.as_tensor(t_max),
                               *_t(jg.march_min, jg.march_max), k)
    ref_slots, ref_over = _reference_corridor(jg, o, d, t_max, k)
    assert slots.dtype == torch.int32
    np.testing.assert_array_equal(slots.numpy(), ref_slots)
    np.testing.assert_array_equal(over.numpy(), ref_over)
    assert bool(over.any()) and not bool(over.all())
    lm = tg.n_march_leaves
    assert not bool((slots[::6] < lm).any())  # dead rays have no corridor


def _reference_pair_sweep(args, any_hit, block=128):
    """The reference's Pallas pair_sweep (interpret mode) on K4's inputs,
    in the [G, 16, R] layout its wrapper builds (traversal.py:1002-1019;
    padding pairs dead), the pack's columns as its rows."""
    o, d, lo, hi, chunk, tris, _ = (x.numpy() for x in args)
    m = len(o)
    lm, ls = tris.shape[:2]
    g = -(-m // block)
    rows = np.zeros((16, g * block), np.float32)
    rows[5] = 1.0
    rows[8] = lm
    rows[0:3, :m], rows[3:6, :m] = o.T, d.T
    rows[6, :m], rows[7, :m], rows[8, :m] = lo, hi, chunk
    rays = rows.reshape(16, g, block).swapaxes(0, 1)
    pack = np.zeros((lm, 16, ls), np.float32)
    pack[:, :12] = tris.transpose(0, 2, 1)
    out = pair_sweep(jnp.asarray(rays), jnp.asarray(pack), any_hit=any_hit,
                     interpret=True)
    t, prim, v, w, flags = (np.asarray(x).reshape(-1)[:m] for x in out)
    return t, prim, v, w, (flags.astype(np.int32) & 1) > 0, flags >= 2


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "dup"])
def test_pair_sweep_plain_equals_pallas_interpret(kind, any_hit):
    """The oracle of K4's card tests (pair_sweep_plain) against the
    reference's Pallas pair kernel in interpret mode, on two of those
    tests' inputs at a small size: a sparse tail (every live pair its own
    chunk) and exact duplicate triangles in every chunk.  valid, inside
    and prim equal (the ties go to the lower index on both sides); t, v,
    w within rtol 1e-5, atol 1e-5 (XLA may contract multiply-adds)."""
    args = pair_case(kind, 32, torch.device("cpu"), m=384, lm=160)
    got = psw.pair_sweep_plain(*args, any_hit=any_hit)
    t, prim, v, w, inside, valid = _reference_pair_sweep(args, any_hit)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 50
    np.testing.assert_array_equal(got.prim.numpy()[valid], prim[valid])
    np.testing.assert_array_equal(got.inside.numpy()[valid], inside[valid])
    for name, ref in (("t", t), ("v", v), ("w", w)):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid],
                                   ref[valid], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got.t.numpy()[~valid],
                                  args[3].numpy()[~valid])


def test_pair_sweep_plain_is_order_free():
    """The plain pair sweep gives each pair the same answer in any order."""
    _, tg = _soup(900, seed=22)
    o, d, t_max = _rays(400, seed=23)
    to, td = _t(o, d)
    lo, hi = torch.full((400,), 1e-4), torch.as_tensor(t_max)
    _, _, *pairs = TT.pair_inputs(tg, to, td, lo, hi, 4)
    perm = torch.randperm(len(pairs[0]), generator=torch.Generator().manual_seed(0))
    a = psw.pair_sweep(*pairs, tg.march_tris, tg.march_prim)
    b = psw.pair_sweep(*[x[perm] for x in pairs], tg.march_tris, tg.march_prim)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm))
    for x, y in zip(a, b):
        assert torch.equal(x, y[inv])
    assert bool(a.valid.any())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k", ["2", "8"])
def test_pairs_route_matches_pallas_interpret(monkeypatch, k, any_hit):
    """The whole pair traversal against the reference's _intersect_pairs
    in interpret mode; MCPT_PAIR_K=2 forces overflow, so the block-march
    fallback carries part of the rays."""
    monkeypatch.setenv("MCPT_PAIR_K", k)
    jg, tg = _soup(900, seed=24, opaque_frac=0.6)
    o, d, t_max = _rays(500, seed=25, dead_every=7, cut=True)
    to, td = _t(o, d)
    lo, hi = torch.full((500,), 1e-4), torch.as_tensor(t_max)
    overflow = TT.pair_inputs(tg, to, td, lo, hi, int(k))[0]
    if k == "2":
        assert int(overflow.sum()) > 20
    ref = JT._intersect_pairs(jg, o, d, 1e-4, jnp.asarray(t_max), any_hit,
                              interpret=True)
    got = TT._intersect_pairs(tg, to, td, lo, hi, any_hit)
    if any_hit:
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    else:
        _assert_same_hits(got, ref, o, d, tg)
    assert not bool(got.valid[::7].any())


def test_pairs_route_matches_the_plain_march(monkeypatch):
    """Both large-scene routes agree with the per-lane march (the oracle
    of both) through the public entry points."""
    _, tg = _soup(1200, seed=26, opaque_frac=0.6)
    o, d, t_max = _rays(600, seed=27, dead_every=5, cut=True)
    to, td = _t(o, d)
    lo, hi = torch.full((600,), 1e-4), torch.as_tensor(t_max)
    plain = (to, td, lo, hi, tg.march_min, tg.march_max, tg.march_tris,
             tg.march_prim)
    ref = msw.march_sweep_plain(*plain)
    occ = msw.march_sweep_plain(*plain, any_hit=True).valid
    big = tg._replace(packed_tris=torch.zeros((TT.DENSE_MAX_PRIMS + 4, 12)))
    for route in ("march", "pairs"):
        monkeypatch.setenv("MCPT_TRAVERSAL", route)
        got = TT.intersect_closest(big, to, td, lo, hi)
        assert torch.equal(got.valid, ref.valid) and torch.equal(got.t, ref.t)
        assert torch.equal(TT.intersect_any(big, to, td, lo, hi), occ)


def test_pair_knobs(monkeypatch):
    monkeypatch.delenv("MCPT_PAIR_K", raising=False)
    monkeypatch.delenv("MCPT_PAIR_BLOCK", raising=False)
    assert psw.pair_k() == 8 and psw.pair_block() == 512
    monkeypatch.setenv("MCPT_PAIR_K", "40")
    with pytest.raises(ValueError):
        psw.pair_k()
    monkeypatch.setenv("MCPT_PAIR_BLOCK", "300")
    assert psw.pair_block() == 384
