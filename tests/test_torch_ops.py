"""mcpt_tpu_torch.ops.{math,warps,intersect} against mcpt_tpu.ops on
random numpy inputs.  Tolerance: rtol 1e-5, atol 1e-6 (f32 arithmetic in
the same order; only library sqrt/sin/cos and sum orders may differ by an
ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.ops import intersect as jint
from mcpt_tpu.ops import math as jm
from mcpt_tpu.ops import warps as jw
from mcpt_tpu_torch.ops import intersect as tint
from mcpt_tpu_torch.ops import math as tm
from mcpt_tpu_torch.ops import warps as tw

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def T(a):
    return torch.as_tensor(a)


def test_vector_helpers():
    a, b = _rand((N, 3), 0), _rand((N, 3), 1)
    _close(tm.dot(T(a), T(b)), jm.dot(a, b))
    _close(tm.cross(T(a), T(b)), jm.cross(a, b))
    _close(tm.length(T(a)), jm.length(a))
    _close(tm.normalize(T(a)), jm.normalize(a))


def test_mis_weight_including_extreme_pdfs():
    r = np.random.default_rng(2)
    p1 = np.exp(r.uniform(-40, 60, N)).astype(np.float32)
    p2 = np.exp(r.uniform(-40, 60, N)).astype(np.float32)
    p1[:8] = 0.0
    got = tm.mis_weight(T(p1), T(p2))
    _close(got, jm.mis_weight(jnp.asarray(p1), jnp.asarray(p2)))
    assert torch.isfinite(got).all()


def test_onb_and_frame_changes():
    n = _unit(N, 3)
    n[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [1, 0, 0]]
    t, b = tm.build_onb(T(n))
    jt, jb = jm.build_onb(jnp.asarray(n))
    _close(t, jt)
    _close(b, jb)
    v = _unit(N, 4)
    loc = tm.to_local(T(v), t, b, T(n))
    _close(loc, jm.to_local(v, jt, jb, n))
    _close(tm.to_world(loc, t, b, T(n)), jm.to_world(np.asarray(loc), jt, jb, n))


@pytest.mark.parametrize("shape", [(7,), (7, 3)])
def test_take_rows_is_a_gather_with_zero_outside(shape):
    table = _rand(shape, 5)
    idx = np.array([0, 6, 3, -1, 7, 2], np.int32)
    got = tm.take_rows(T(table), T(idx))
    _close(got, jm.take_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert float(got[3].abs().sum()) == 0.0 and float(got[4].abs().sum()) == 0.0


def test_sample_hemisphere_cosine():
    xi0, xi1 = _rand(N, 6, 0, 1), _rand(N, 7, 0, 1)
    v, pdf = tw.sample_hemisphere_cosine(T(xi0), T(xi1))
    jv, jpdf = jw.sample_hemisphere_cosine(jnp.asarray(xi0), jnp.asarray(xi1))
    _close(v, jv)
    _close(pdf, jpdf)


def test_sample_triangle_uniform():
    xi0, xi1 = _rand(N, 8, 0, 1), _rand(N, 9, 0, 1)
    for got, ref in zip(tw.sample_triangle_uniform(T(xi0), T(xi1)),
                        jw.sample_triangle_uniform(jnp.asarray(xi0), jnp.asarray(xi1))):
        _close(got, ref)


@pytest.mark.parametrize("k", [2, 5, 40, 300])
def test_searchsorted_cdf_cells_equal(k):
    """Exact cells, with targets on the CDF knots (both linear-scan and
    binary-search branches of the reference)."""
    r = np.random.default_rng(k)
    w = r.uniform(0, 1, k - 1).astype(np.float32)
    w[r.uniform(size=k - 1) < 0.2] = 0.0  # empty cells
    cdf = np.zeros(k, np.float32)
    np.cumsum(w, out=cdf[1:])
    cdf /= max(cdf[-1], 1e-20)
    target = np.concatenate([_rand(N, k, 0, 1), cdf]).astype(np.float32)
    got = tw.searchsorted_cdf(T(cdf), T(target))
    ref = jw.searchsorted_cdf(jnp.asarray(cdf), jnp.asarray(target))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_intersect_triangle_matches():
    o = _rand((N, 3), 10, -2, 2)
    p0 = _rand((N, 3), 12)
    e1 = _rand((N, 3), 13)
    e2 = _rand((N, 3), 14)
    # aim at barycentric points in and around each triangle, both faces
    ab = _rand((N, 2), 11, -0.2, 0.8)
    d = p0 + ab[:, :1] * e1 + ab[:, 1:] * e2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e2[:16] = e1[:16] * 2.0  # degenerate: det == 0 guard
    got = tint.intersect_triangle(T(o), T(d), T(p0), T(e1), T(e2), 1e-4, 3.4e38)
    ref = jint.intersect_triangle(o, d, p0, e1, e2, 1e-4, 3.4e38)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert int(got[0].sum()) > N // 4
    assert not bool(got[0][:16].any())
    # XLA may contract into FMAs where torch rounds each op; the ulp
    # differences grow as 1/|det|, so well-conditioned hits are held at
    # 1e-5 (as _assert_same_hits) and near-grazing ones (|det| < 0.05) at 1e-3
    m = np.asarray(ref[0])
    good = m & (np.abs(1.0 / np.asarray(ref[4])) >= 0.05)
    for g, r_ in zip(got[1:], ref[1:]):
        g, r_ = g.numpy(), np.asarray(r_)
        np.testing.assert_allclose(g[good], r_[good], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g[m], r_[m], rtol=1e-3, atol=1e-3)


def test_safe_rcp_and_intersect_aabb_match():
    """The slab test bit for bit: a subtraction and a multiplication per
    slab, min/max and compares — no multiply-add for XLA to contract."""
    d = _unit(N, 20)
    d[:64, 0] = 0.0
    d[64:128, 1] = -1e-13  # below the 1e-12 guard, negative
    got_r = tint.safe_rcp(T(d))
    ref_r = jint.safe_rcp(d)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    o = _rand((N, 3), 21, -3, 3)
    lo = _rand((N, 3), 22, -2, 0)
    hi = lo + _rand((N, 3), 23, 0, 2)
    lo[:32] = 3e37  # an empty chunk parked far away
    hi[:32] = 3e37
    aim = 0.5 * (lo + hi)[N // 2:] - o[N // 2:]  # half the rays at their box
    d[N // 2:] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    got_r = tint.safe_rcp(T(d))
    ref_r = jint.safe_rcp(d)
    t_min = np.full(N, 1e-4, np.float32)
    t_max = _rand((N,), 24, 0.5, 9)
    hit, t_enter = tint.intersect_aabb(T(o), got_r, T(lo), T(hi), T(t_min),
                                       T(t_max))
    ref_hit, ref_t = jint.intersect_aabb(o, ref_r, lo, hi, t_min, t_max)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
    np.testing.assert_array_equal(t_enter.numpy(), np.asarray(ref_t))
    assert N // 4 < int(hit.sum()) < N


# --- device-stable math (fault F6, ROADMAP section 3): the helpers the
# integrators use in place of torch's float32 transcendental functions and
# sums, so that the card and the CPU give the same bits

STABLE = ("sqrt", "exp", "log1p", "sin", "cos", "tan", "atan", "arccos")


@pytest.mark.parametrize("name", STABLE + ("atan2",))
def test_stable_functions_are_float64_rounded_to_float32(name):
    x = T(_rand(N, 11, 0.0 if name in ("sqrt", "arccos") else -3.0,
                1.0 if name == "arccos" else 3.0))
    if name == "log1p":
        x = -x.abs() / 3.0
    args = (x, T(_rand(N, 12))) if name == "atan2" else (x,)
    got = getattr(tm, name)(*args)
    want = getattr(torch, name)(*(a.double() for a in args)).float()
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    # and within an ulp of the reference's float32 function
    ref = getattr(jnp, name)(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2.4e-7,
                               atol=1e-7)


def test_stable_sqrt_is_ieee():
    x = _rand(N, 13, 0.0, 100.0)
    assert np.array_equal(tm.sqrt(T(x)).numpy(), np.sqrt(x))


@pytest.mark.parametrize("width", [2, 3])
def test_dot_sums_in_channel_order(width):
    a, b = T(_rand((N, width), 14)), T(_rand((N, width), 15))
    p = a * b
    want = p[:, 0] + p[:, 1]
    if width == 3:
        want = want + p[:, 2]
    assert torch.equal(tm.dot(a, b), want)
    assert torch.equal(tm.dot(a, b, keepdim=True)[:, 0], want)
    assert torch.equal(tm.channel_sum(p), want)


def test_per_ray_modules_use_the_stable_math():
    """No module on the render path calls torch's float32 transcendental
    functions or sums over a channel axis directly (the Kulla-Conty table
    build, once per device, is not on it)."""
    import pathlib
    import re

    root = pathlib.Path(tm.__file__).resolve().parents[1]
    pattern = re.compile(r"torch\.(" + "|".join(STABLE + ("atan2", "pow"))
                         + r")\(|\.sum\(dim=-1|\.mean\(dim=-1")
    files = [f for sub in ("integrators", "models", "ops", "render")
             for f in sorted((root / sub).glob("*.py"))
             if f.name not in ("kulla_conty.py", "math.py")]
    assert len(files) >= 15
    hits = [f"{f.name}:{m.group(0)}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits
