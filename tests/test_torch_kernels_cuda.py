"""The port's CUDA kernels (K1 dense sweep, K2 block march, K3 corridor,
K4 pair sweep) against their plain PyTorch versions, on the card, and the
large-scene routes against the plain per-lane march.  Every test here is
marked `cuda` and skips without a CUDA device;
the file imports neither JAX nor mcpt_tpu, so it runs on a machine that
has only PyTorch:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_rays, random_tris
from mcpt_tpu_torch.ops import dense_sweep as ds


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris", [1, 300, 5000])
def test_dense_sweep_kernel_bit_equal_to_plain(n_tris, any_hit):
    """K1 repeats the plain version's arithmetic op for op (--fmad=false),
    so every output must be bit-equal, ties and dead lanes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    dev = torch.device("cuda")
    n = 20000
    tris = random_tris(n_tris, seed=31)
    tris[n_tris // 2:n_tris // 2 + n_tris // 10] = tris[:n_tris // 10]  # ties
    o, d = random_rays(n, seed=32)
    t_max = np.full(n, 3.4e38, np.float32)
    t_max[1::3] = np.random.default_rng(33).uniform(1.0, 8.0, n)[1::3]
    t_max[::9] = 0.0  # dead lanes
    args = (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), 1e-4, device=dev),
            torch.as_tensor(t_max, device=dev),
            torch.as_tensor(tris, device=dev))
    before = ds.launches
    got = ds.dense_sweep(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    assert ds.launches == before + 1
    ref = ds.dense_sweep_plain(*args, any_hit=any_hit)
    assert bool(ref.valid.any()) or n_tris == 1
    assert not bool(got.valid[::9].any())
    for name in ("valid", "inside", "prim", "t", "v", "w"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("shape", ds.SHAPES)
@pytest.mark.parametrize("case", ["p16384", "ragged", "dead"])
def test_dense_sweep_kernel_shapes_bit_equal(case, shape, any_hit):
    """Every kernel shape (slices per ray x rays per thread) against the
    plain version, every output bit-equal: at p = 16384; at p = 1001 and
    n = 5003, multiples of no slice tile and of no block; with all lanes
    dead.  Exact duplicates of rows 0-29 sit 32 and 257 rows after them,
    so that ties fall in other slices of one tile and in other tiles."""
    dev = _cuda()
    p, n = {"p16384": (16384, 4096), "ragged": (1001, 5003),
            "dead": (1001, 777)}[case]
    tris = random_tris(p, seed=35, spread=1.5)
    for gap in (32, 257):
        tris[gap:gap + 30] = tris[:30]
    o, d = random_rays(n, seed=36, spread=3.0)
    t_max = np.full(n, 3.4e38, np.float32)
    t_max[1::3] = np.random.default_rng(37).uniform(1.0, 8.0, n)[1::3]
    t_max[::9] = 0.0
    if case == "dead":
        t_max[:] = 0.0
    args = (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), 1e-4, device=dev),
            torch.as_tensor(t_max, device=dev),
            torch.as_tensor(tris, device=dev))
    before = ds.launches
    got = ds.dense_sweep(*args, any_hit=any_hit, shape=shape)
    torch.cuda.synchronize()
    assert ds.launches == before + 1
    ref = ds.dense_sweep_plain(*args, any_hit=any_hit)
    assert bool(ref.valid.any()) == (case != "dead")
    for name in ("valid", "inside", "prim", "t", "v", "w"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    if case != "dead":  # ties go to the original, the lower index
        prim = ref.prim[ref.valid]
        assert bool((prim < 30).any())
        assert not bool((((prim >= 32) & (prim < 62))
                         | ((prim >= 257) & (prim < 287))).any())


@pytest.mark.cuda
def test_dense_sweep_wrapper_checks_its_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    o = torch.zeros((8, 3), device=dev)
    lo = torch.zeros(8, device=dev)
    tris = torch.zeros((4, 12), device=dev)
    with pytest.raises(TypeError):
        ds.dense_sweep(o.double(), o, lo, lo, tris)
    with pytest.raises(ValueError):
        ds.dense_sweep(o, o.t().contiguous().t(), lo, lo, tris)
    with pytest.raises(ValueError):
        ds.dense_sweep(o, o, lo, lo, tris[:, :9].contiguous())
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        ds.dense_sweep(o, o, lo, lo, torch.zeros(5 * 12 + 1, device=dev)[1:].view(5, 12))
    with pytest.raises(ValueError):
        ds.dense_sweep(o, o, lo, lo, tris, shape=(3, 1))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _soup_geometry(n_tris, dev, seed=41):
    """A random soup with exact duplicates (ties) and 70% opaque prims."""
    from mcpt_tpu_torch.scene.geometry import commit_geometry

    tris = random_tris(n_tris, seed=seed)
    tris[n_tris // 2:n_tris // 2 + n_tris // 10] = tris[:n_tris // 10]
    verts = np.stack([tris[:, 0:3], tris[:, 0:3] + tris[:, 3:6],
                      tris[:, 0:3] + tris[:, 6:9]], axis=1)
    return commit_geometry(verts, None, None, None, np.zeros(n_tris), dev,
                           tri_opaque=tris[:, 9] > 0.5)


def _rays(n, dev, seed=42):
    o, d = random_rays(n, seed=seed)
    t_max = np.full(n, 3.4e38, np.float32)
    t_max[1::3] = np.random.default_rng(seed).uniform(1.0, 8.0, n)[1::3]
    t_max[::9] = 0.0  # dead lanes
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), 1e-4, device=dev), torch.as_tensor(t_max, device=dev))


#: K2's knob settings: the group target (one chunk per pick, the default,
#: a value clamped by shared memory), the super-chunk cull off, the interval
#: phase A on (with the cull on and off)
K2_SETTINGS = {
    "default": {},
    "one-chunk": {"MCPT_MARCH_GROUP": "1"},
    "group-clamped": {"MCPT_MARCH_GROUP": "100000000"},
    "super-off": {"MCPT_MARCH_SUPER": "0"},
    "interval": {"MCPT_MARCH_IVAL": "1"},
    "interval-super-off": {"MCPT_MARCH_IVAL": "1", "MCPT_MARCH_SUPER": "0"},
}


def _check_march(args, g, any_hit, supers):
    """K2 against the per-lane plain march on rays in block order: valid
    equal; closest hit: t bit-equal, inside equal, prim equal but on
    exact-t ties (chip_smoke.same_hits).  Returns the block's shared
    memory in bytes."""
    import warnings

    from chip_smoke import same_hits
    from mcpt_tpu_torch.build import library
    from mcpt_tpu_torch.ops import march_sweep as msw

    lm, ls = g.march_prim.shape
    block = msw.ray_block()
    n_sup = 0 if msw.use_interval() or not msw.use_super_cull() else -(-lm // 128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, smem = msw.card_group(library(), ls, lm, block, n_sup)
    before = msw.launches
    got = msw.march_sweep(*args, supers, any_hit=any_hit)
    torch.cuda.synchronize()
    assert msw.launches == before + 1
    ref = msw.march_sweep_plain(*args, any_hit=any_hit)
    _, n_hit, _ = same_hits(got, ref, args[0], args[1], g.packed_tris,
                            args[2], "K2", any_hit)
    assert n_hit > 0
    assert not bool(got.valid[args[3] <= args[2]].any())
    return smem


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(K2_SETTINGS))
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,leaf,block", [
    (3000, "256", "256"),   # a few fat chunks
    (5000, "16", "96"),     # ~400 thin chunks, 96-ray blocks of 288 threads
    (20000, "64", "32"),    # a block of 32 rays
    (60000, "4", "256"),    # >12k chunks
])
def test_march_sweep_kernel_matches_plain(monkeypatch, n_tris, leaf, block,
                                          any_hit, setting):
    """K2 at every knob setting against the plain march (_check_march).
    Every case but one chunk per pick asks for more than 48 KB of shared
    memory, and the >12k-chunk case does at every setting."""
    from mcpt_tpu_torch.ops.traversal import march_order

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", leaf)
    monkeypatch.setenv("MCPT_MARCH_MAX_CHUNKS", "100000")
    monkeypatch.setenv("MCPT_MARCH_BLOCK", block)
    for k, v in K2_SETTINGS[setting].items():
        monkeypatch.setenv(k, v)
    g = _soup_geometry(n_tris, dev)
    o, d, lo, hi = _rays(20000, dev)
    order = march_order(g, o, d, lo, hi)
    args = (o[order], d[order], lo[order], hi[order], g.march_min,
            g.march_max, g.march_tris, g.march_prim)
    smem = _check_march(args, g, any_hit,
                        (g.march_super_min, g.march_super_max))
    assert smem > 48 * 1024 or setting == "one-chunk"
    if n_tris == 60000:
        assert smem > 48 * 1024


@pytest.mark.cuda
def test_march_group_clamped_to_shared_memory(monkeypatch):
    """A group target past the block's shared memory is clamped, with a
    warning, to the largest group whose layout (the kernel's own,
    mcpt_march_smem_bytes) fits MAX_SMEM."""
    from mcpt_tpu_torch.build import library
    from mcpt_tpu_torch.ops import march_sweep as msw

    _cuda()
    lib = library()
    monkeypatch.setenv("MCPT_MARCH_GROUP", str(1 << 24))
    with pytest.warns(UserWarning, match="clamping"):
        cg, smem = msw.card_group(lib, 256, 299, 256, 3)
    assert 1 <= cg < msw.chunk_group(256)
    assert smem == lib.mcpt_march_smem_bytes(299, 256, 3, 256, cg) <= msw.MAX_SMEM
    assert lib.mcpt_march_smem_bytes(299, 256, 3, 256, cg + 1) > msw.MAX_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["default", "interval", "one-chunk"])
def test_march_sweep_kernel_partial_super(monkeypatch, setting):
    """300 chunks, not a multiple of the 128-chunk super run: the last
    union is partial."""
    from mcpt_tpu_torch.ops.march_sweep import super_boxes
    from mcpt_tpu_torch.ops.traversal import march_order

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", "16")
    for k, v in K2_SETTINGS[setting].items():
        monkeypatch.setenv(k, v)
    g = _soup_geometry(8000, dev)
    assert g.n_march_leaves > 300
    g = g._replace(march_tris=g.march_tris[:300], march_prim=g.march_prim[:300],
                   march_min=g.march_min[:300], march_max=g.march_max[:300])
    o, d, lo, hi = _rays(20000, dev)
    order = march_order(g, o, d, lo, hi)
    args = (o[order], d[order], lo[order], hi[order], g.march_min,
            g.march_max, g.march_tris, g.march_prim)
    supers = super_boxes(g.march_min, g.march_max)
    assert supers[0].shape == (3, 3)
    for any_hit in (False, True):
        _check_march(args, g, any_hit, supers)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(K2_SETTINGS))
def test_march_sweep_kernel_on_the_overflow_fallback(monkeypatch, setting):
    """The pair route's fallback input: only the rays whose corridor
    overflows K=2 chunks, compacted, in blocks of the default size."""
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops.traversal import march_order, pair_inputs

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", "64")
    monkeypatch.delenv("MCPT_MARCH_BLOCK", raising=False)
    for k, v in K2_SETTINGS[setting].items():
        monkeypatch.setenv(k, v)
    g = _soup_geometry(20000, dev)
    o, d, lo, hi = _rays(30000, dev)
    overflow = pair_inputs(g, o, d, lo, hi, 2)[0]
    idx = overflow.nonzero()[:, 0]
    assert 0 < idx.numel() < 30000
    o, d, lo, hi = o[idx], d[idx], lo[idx], hi[idx]
    order = march_order(g, o, d, lo, hi)
    args = (o[order], d[order], lo[order], hi[order], g.march_min,
            g.march_max, g.march_tris, g.march_prim)
    assert msw.ray_block() == msw.DEFAULT_BLOCK
    supers = (g.march_super_min, g.march_super_max)
    for any_hit in (False, True):
        _check_march(args, g, any_hit, supers)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 8])
def test_corridor_kernel_equals_plain(monkeypatch, k):
    from mcpt_tpu_torch.ops import pair_sweep as psw

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", "16")
    g = _soup_geometry(6000, dev)
    o, d, lo, hi = _rays(20000, dev)
    args = (o, d, lo, hi, g.march_min, g.march_max, k)
    before = psw.corridor_launches
    slots, over = psw.corridor(*args)
    assert psw.corridor_launches == before + 1
    slots_p, over_p = psw.corridor_plain(*args)
    assert torch.equal(slots, slots_p)
    assert torch.equal(over, over_p)
    assert bool(over.any()) and bool((slots < g.n_march_leaves).any())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_pair_sweep_kernel_bit_equal_to_plain(monkeypatch, shuffle, any_hit):
    """K4 repeats its plain version op for op: every output bit-equal, in
    any-hit mode too; unsorted pairs give the same answer, only slower."""
    from mcpt_tpu_torch.ops import pair_sweep as psw
    from mcpt_tpu_torch.ops.traversal import pair_inputs

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", "32")
    g = _soup_geometry(6000, dev)
    o, d, lo, hi = _rays(20000, dev)
    _, _, *pairs = pair_inputs(g, o, d, lo, hi, 8)
    if shuffle:
        perm = torch.randperm(len(pairs[0]), device=dev,
                              generator=torch.Generator(dev).manual_seed(0))
        pairs = [x[perm].contiguous() for x in pairs]
    before = psw.pair_launches
    got = psw.pair_sweep(*pairs, g.march_tris, g.march_prim, any_hit)
    assert psw.pair_launches == before + 1
    ref = psw.pair_sweep_plain(*pairs, g.march_tris, g.march_prim, any_hit)
    assert bool(ref.valid.any())
    for name in ("valid", "inside", "prim", "t", "v", "w"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def pair_case(kind, ls, dev, m=2000, lm=300, seed=51):
    """K4's inputs (o, d, t_min, t_max, chunk, tris, prim) built directly:
    lm chunks of ls triangles clustered around each chunk's centre, and
    m pairs sorted by chunk, each live pair's ray aimed at a triangle of
    its chunk from 2.5 units away, from either side and near its normal,
    so that it crosses a few more; every
    third t_max cut short, every ninth live pair dead by t_max = 0, and a
    dead tail (chunk = lm).  Kinds:
      sparse  every live pair names its own chunk
      run     one chunk's run longer than two blocks of 512 pairs
      dup     rows 0..ls/4 of every chunk copied ls/2 + 1 rows on (exact
              ties, tested by other lanes), rays aimed at the originals
      shuffle the run's pairs in random order
      dead    every pair dead (chunk = lm)"""
    r = np.random.default_rng(seed)
    centre = r.uniform(-4.0, 4.0, size=(lm, 1, 3))
    tris = random_tris(lm * ls, seed=seed, spread=0.4, size=0.5).reshape(lm, ls, 12)
    tris[..., 0:3] += centre
    if kind == "dup":
        q = max(1, ls // 4)
        tris[:, ls // 2 + 1:ls // 2 + 1 + q] = tris[:, :q]
    prim = r.permutation(lm * ls).astype(np.int32).reshape(lm, ls)
    tris[..., 10] = prim
    n_live = {"sparse": min(lm, m // 2), "run": m * 3 // 4, "dup": m * 3 // 4,
              "shuffle": m * 3 // 4, "dead": 0}[kind]
    if kind == "sparse":
        chunk = np.sort(r.choice(lm, size=n_live, replace=False))
    else:
        chunk = np.sort(r.integers(0, lm, size=n_live))
        if kind in ("run", "shuffle"):
            chunk[100:100 + 1300] = chunk[100]
            chunk = np.sort(chunk)
    chunk = np.concatenate([chunk, np.full(m - n_live, lm)]).astype(np.int32)
    live = chunk < lm
    aim = r.integers(0, max(1, ls // 4) if kind == "dup" else ls, size=m)
    rows = tris[np.minimum(chunk, lm - 1), aim]
    target = rows[:, 0:3] + (rows[:, 3:6] + rows[:, 6:9]) / 3.0
    # from either side, within ~27 degrees of the target's normal
    nrm = np.cross(rows[:, 3:6], rows[:, 6:9])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = (nrm * r.choice([-1.0, 1.0], size=(m, 1))
         + 0.3 * r.uniform(-1.0, 1.0, size=(m, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (target - 2.5 * d).astype(np.float32)
    t_max = np.full(m, 3.4e38, np.float32)
    t_max[1::3] = r.uniform(1.5, 3.5, m)[1::3]
    t_max[np.flatnonzero(live)[::9]] = 0.0
    t_max[~live] = 0.0
    if kind == "shuffle":
        perm = r.permutation(m)
        o, d, t_max, chunk = o[perm], d[perm], t_max[perm], chunk[perm]
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    return (t(o), t(d.astype(np.float32)), t(np.full(m, 1e-4, np.float32)),
            t(t_max), t(chunk), t(tris), t(prim))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ls", [32, 64, 128, 40, 200])
@pytest.mark.parametrize("kind", ["sparse", "run", "dup", "shuffle", "dead"])
def test_pair_sweep_kernel_cases_bit_equal(kind, ls, any_hit):
    """K4 against its plain version, every output bit-equal, on the pair
    inputs K4's warps find hard (pair_case): a sparse tail, a chunk run
    longer than two blocks, ties across lanes, unsorted pairs, all dead;
    at chunk sizes of 32, 64 and 128 and two that are not multiples of 32."""
    from mcpt_tpu_torch.ops import pair_sweep as psw

    dev = _cuda()
    args = pair_case(kind, ls, dev)
    before = psw.pair_launches
    got = psw.pair_sweep(*args, any_hit)
    torch.cuda.synchronize()
    assert psw.pair_launches == before + 1
    ref = psw.pair_sweep_plain(*args, any_hit)
    assert bool(ref.valid.any()) == (kind != "dead")
    for name in ("valid", "inside", "prim", "t", "v", "w"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    if kind == "dup":  # the ties went to the originals
        prim = args[6]
        q = max(1, ls // 4)
        copies = prim[:, ls // 2 + 1:ls // 2 + 1 + q]
        assert not bool(torch.isin(ref.prim[ref.valid], copies).any())
        assert bool(torch.isin(ref.prim[ref.valid], prim[:, :q]).any())


@pytest.mark.cuda
def test_pair_sweep_wrapper_checks_its_inputs():
    from mcpt_tpu_torch.ops import pair_sweep as psw

    dev = _cuda()
    o, d, lo, hi, chunk, tris, prim = pair_case("sparse", 32, dev, m=64, lm=4)
    with pytest.raises(TypeError):
        psw.pair_sweep(o, d, lo, hi, chunk.long(), tris, prim)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        flat = torch.zeros(tris.numel() + 1, device=dev)[1:]
        psw.pair_sweep(o, d, lo, hi, chunk, flat.view(tris.shape), prim)
    with pytest.raises(ValueError):
        psw.pair_sweep(o, d, lo, hi, chunk, tris[:, :0].contiguous(),
                       prim[:, :0].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["march", "pairs"])
@pytest.mark.parametrize("k", ["2", "8"])
def test_large_scene_routes_match_plain_march(monkeypatch, route, k):
    """The whole march and pair routes on the card against the per-lane
    plain march (the oracle of both), with overflow forced at K=2."""
    from chip_smoke import same_hits
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops.traversal import intersect_any, intersect_closest

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", "64")
    monkeypatch.setenv("MCPT_TRAVERSAL", route)
    monkeypatch.setenv("MCPT_PAIR_K", k)
    g = _soup_geometry(20000, dev)
    o, d, lo, hi = _rays(30000, dev)
    plain = (o, d, lo, hi, g.march_min, g.march_max, g.march_tris, g.march_prim)
    got = intersect_closest(g, o, d, lo, hi)
    same_hits(got, msw.march_sweep_plain(*plain), o, d, g.packed_tris, lo,
              f"{route} closest")
    occ = intersect_any(g, o, d, lo, hi)
    assert torch.equal(occ, msw.march_sweep_plain(*plain, any_hit=True).valid)
