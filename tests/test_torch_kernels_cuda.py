"""The port's CUDA kernels (K1 dense sweep, K2 block march, K3 corridor,
K4 pair sweep, K5 packet walk) against their plain PyTorch versions, on
the card, and the large-scene routes against the plain per-lane march.  Every test here is
marked `cuda` and skips without a CUDA device;
the file imports neither JAX nor mcpt_tpu, so it runs on a machine that
has only PyTorch:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (CORRIDOR_CASES, random_rays, random_tris,
                        soup_geometry, soup_rays)
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
    g = soup_geometry(n_tris, dev)
    o, d, lo, hi = soup_rays(20000, dev)
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
    g = soup_geometry(8000, dev)
    assert g.n_march_leaves > 300
    g = g._replace(march_tris=g.march_tris[:300], march_prim=g.march_prim[:300],
                   march_min=g.march_min[:300], march_max=g.march_max[:300])
    o, d, lo, hi = soup_rays(20000, dev)
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
    g = soup_geometry(20000, dev)
    o, d, lo, hi = soup_rays(30000, dev)
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
@pytest.mark.parametrize("setting", sorted(K2_SETTINGS))
def test_march_sweep_kernel_on_the_batched_input(monkeypatch, setting):
    """The batched regen body's input on the materials scene
    (chip_smoke.batched_input): 65536 continuations and 65536 shadow
    segments with finite t_max, classes 0-3, in block order; closest hit
    (t bit-equal, prim differing only on exact-t ties) and any hit."""
    from chip_smoke import batched_input

    dev = _cuda()
    for k, v in K2_SETTINGS[setting].items():
        monkeypatch.setenv(k, v)
    _, g, args = batched_input(dev)
    assert len(args[0]) == 131072
    shadow = (args[3] > 0) & (args[3] < 1e30)
    assert int(shadow.sum()) > 0
    for any_hit in (False, True):
        _check_march(args, g, any_hit, (g.march_super_min, g.march_super_max))


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(K2_SETTINGS))
def test_march_sweep_kernel_on_the_envmap_batched_input(monkeypatch, setting):
    """The batched body's input on the envmap scene
    (chip_smoke.batched_input(envmap=True)): 65536 continuations and 65536
    shadow segments toward envmap samples, t_max = MAX_FLOAT/2 - 1e-4
    (finite), classes 0-3, in block order; closest and any hit."""
    from chip_smoke import batched_input

    dev = _cuda()
    for k, v in K2_SETTINGS[setting].items():
        monkeypatch.setenv(k, v)
    label, g, args = batched_input(dev, envmap=True)
    assert label == "envmap batched" and len(args[0]) == 131072
    assert bool(torch.isfinite(args[3]).all())
    assert int((args[3] > 1e37).sum()) > 0  # the envmap's shadow segments
    for any_hit in (False, True):
        _check_march(args, g, any_hit, (g.march_super_min, g.march_super_max))


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["lights camera", "lights bounce",
                                   "lights walk"])
def test_dense_sweep_kernel_on_the_lights_scene(label):
    """K1 on the lights scene's 14 triangles (chip_smoke.lights_inputs):
    camera rays, first-bounce rays and the alpha walk's second steps
    (t_min past the segment's first hit), every output bit-equal to the
    plain version, closest and any hit."""
    from chip_smoke import lights_inputs, same_hits

    dev = _cuda()
    tris, inputs = lights_inputs(dev)
    o, d, lo, hi = dict((x[0], x[1:]) for x in inputs)[label]
    for any_hit in (False, True):
        before = ds.launches
        got = ds.dense_sweep(o, d, lo, hi, tris, any_hit=any_hit)
        torch.cuda.synchronize()
        assert ds.launches == before + 1
        ref = ds.dense_sweep_plain(o, d, lo, hi, tris, any_hit=any_hit)
        _, n_hit, _ = same_hits(got, ref, o, d, tris, lo,
                                f"K1 {label} any_hit={any_hit}", any_hit)
        assert n_hit > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 8, 14])
@pytest.mark.parametrize("kind", ["soup", *CORRIDOR_CASES])
def test_corridor_kernel_equals_plain(monkeypatch, kind, k):
    """K3's slots and overflow equal to corridor_plain's: on a SAH soup's
    chunks, and on chip_smoke.CORRIDOR_CASES — chunk counts not a
    multiple of 32 and past the chunks a block stages at a time, rays
    dead (t_max below t_min) or with t_max == t_min (tested, and may fill
    slots), axis-parallel rays on face planes, an all-dead input, and
    ray counts that fill no whole block."""
    from chip_smoke import corridor_case
    from mcpt_tpu_torch.ops import pair_sweep as psw

    dev = _cuda()
    if kind == "soup":
        monkeypatch.setenv("MCPT_MARCH_LEAF", "16")
        g = soup_geometry(6000, dev)
        args = (*soup_rays(20000, dev), g.march_min, g.march_max)
    else:
        args = corridor_case(kind, dev)
    o, d, lo, hi, cmin, cmax = args
    lm = cmin.shape[0]
    before = psw.corridor_launches
    slots, over = psw.corridor(*args, k)
    torch.cuda.synchronize()
    assert psw.corridor_launches == before + 1
    slots_p, over_p = psw.corridor_plain(*args, k)
    assert torch.equal(slots, slots_p)
    assert torch.equal(over, over_p)
    filled = slots < lm
    if kind == "all-dead":
        assert not bool(filled.any()) and not bool(over.any())
        return
    assert bool(filled.any()) and not bool(filled[hi < lo].any())
    if kind != "few":
        assert bool(over.any())
    if kind in ("ragged", "grid", "tiled"):
        assert bool(filled[hi == lo].any())
        assert bool(filled[::5].any())  # axis-parallel rays
    if kind == "tiled":
        tile = psw.corridor_tile()
        assert lm > 2 * tile
        # corridors carried across tiles without overflow
        assert bool(((slots >= tile) & filled).any(dim=1)[~over].any())


@pytest.mark.cuda
def test_corridor_wrapper_checks_its_inputs():
    from chip_smoke import corridor_inputs
    from mcpt_tpu_torch.ops import pair_sweep as psw

    dev = _cuda()
    o, d, lo, hi, cmin, cmax = corridor_inputs(64, 40, dev)
    for k in (0, psw.MAX_K + 1):
        with pytest.raises(ValueError):
            psw.corridor(o, d, lo, hi, cmin, cmax, k)
    with pytest.raises(TypeError):
        psw.corridor(o.double(), d, lo, hi, cmin, cmax, 8)


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
    g = soup_geometry(6000, dev)
    o, d, lo, hi = soup_rays(20000, dev)
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
@pytest.mark.parametrize("route", ["march", "pairs", "packet"])
@pytest.mark.parametrize("k", ["2", "8"])
def test_large_scene_routes_match_plain_march(monkeypatch, route, k):
    """The whole march, pair and packet routes on the card against the
    per-lane plain march (the oracle of each), with the pair route's
    overflow forced at K=2."""
    from chip_smoke import same_hits
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops.traversal import intersect_any, intersect_closest

    dev = _cuda()
    monkeypatch.setenv("MCPT_MARCH_LEAF", "64")
    monkeypatch.setenv("MCPT_TRAVERSAL", route)
    monkeypatch.setenv("MCPT_PAIR_K", k)
    g = soup_geometry(20000, dev)
    o, d, lo, hi = soup_rays(30000, dev)
    plain = (o, d, lo, hi, g.march_min, g.march_max, g.march_tris, g.march_prim)
    got = intersect_closest(g, o, d, lo, hi)
    same_hits(got, msw.march_sweep_plain(*plain), o, d, g.packed_tris, lo,
              f"{route} closest")
    occ = intersect_any(g, o, d, lo, hi)
    assert torch.equal(occ, msw.march_sweep_plain(*plain, any_hit=True).valid)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("leaf_size", [1, 4, 8, 32])
@pytest.mark.parametrize("n", [700, 5003])
def test_packet_sweep_kernel_bit_equal_to_plain(n, leaf_size, any_hit):
    """K5 visits the nodes its plain version visits, in its order (the
    mean entry distance is summed in the same tree), so every output is
    bit-equal, ties, any-hit t and dead lanes included: one ragged packet
    and five, the last ragged."""
    from mcpt_tpu_torch.ops import packet_sweep as pkt

    dev = _cuda()
    g = soup_geometry(3000, dev, seed=43, leaf_size=leaf_size)
    o, d, lo, hi = soup_rays(n, dev, seed=44)
    args = (o, d, lo, hi, g.node_min, g.node_max,
            g.packed_tris.view(g.n_pad_leaves, g.leaf_size, 12))
    before = pkt.launches
    got = pkt.packet_sweep(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    assert pkt.launches == before + 1
    ref = pkt.packet_sweep_plain(*args, any_hit=any_hit)
    assert bool(ref.valid.any()) and not bool(got.valid[::9].any())
    for name in ("valid", "t", "prim", "v", "w", "inside"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.cuda
def test_packet_sweep_wrapper_checks_its_inputs():
    from mcpt_tpu_torch.ops import packet_sweep as pkt

    dev = _cuda()
    g = soup_geometry(300, dev, seed=45)
    o, d, lo, hi = soup_rays(100, dev, seed=46)
    tris = g.packed_tris.view(g.n_pad_leaves, g.leaf_size, 12)
    with pytest.raises(ValueError, match="power of 2"):
        pkt.packet_sweep(o, d, lo, hi, g.node_min[:-2], g.node_max[:-2],
                         tris[:-1])
    with pytest.raises(ValueError, match="leaves of"):
        big = g.packed_tris.view(1, -1, 12)[:, :40].contiguous()
        pkt.packet_sweep(o, d, lo, hi, g.node_min[:1], g.node_max[:1], big)
    with pytest.raises(TypeError):
        pkt.packet_sweep(o, d, lo, hi.double(), g.node_min, g.node_max, tris)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["volcaustic shadow",
                                   "volcaustic past the light"])
def test_dense_sweep_kernel_across_null_shells(label):
    """K1 on the volumetric-caustic scene's shadow rays
    (chip_smoke.volcaustic_inputs): segments to its area light, whose
    closest hits are the fog box's null faces and whose any-hits skip
    them (none occludes), and the same rays past the light, where the
    null rows lie in front of the opaque light's; every output bit-equal
    to the plain version, closest and any hit."""
    from chip_smoke import same_hits, volcaustic_inputs

    dev = _cuda()
    tris, inputs = volcaustic_inputs(dev)
    o, d, lo, hi = dict((x[0], x[1:]) for x in inputs)[label]
    hits = {}
    for any_hit in (False, True):
        got = ds.dense_sweep(o, d, lo, hi, tris, any_hit=any_hit)
        torch.cuda.synchronize()
        ref = ds.dense_sweep_plain(o, d, lo, hi, tris, any_hit=any_hit)
        _, hits[any_hit], _ = same_hits(got, ref, o, d, tris, lo,
                                        f"K1 {label} any_hit={any_hit}")
    assert hits[False] > 0
    if label == "volcaustic shadow":
        assert hits[True] == 0  # null shells never occlude
    else:
        assert hits[True] == o.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("phase,engine", [("isotropic", "regen"),
                                          ("hg", "regen"),
                                          ("isotropic", "chunked")])
def test_volpath_render_card_vs_cpu(phase, engine):
    """A 64x64, 4 spp volpath render of the volumetric-caustic scene
    (depth 16) on the card against the same render on the CPU, by
    chip_smoke.card_vs_cpu: >= 99% of pixels within rtol 1e-3, atol 1e-4,
    channel means within 1e-3 relative."""
    import functools

    from chip_smoke import card_vs_cpu
    from mcpt_tpu_torch.scene.builtin import volumetric_caustic

    dev = _cuda()
    make = functools.partial(volumetric_caustic, phase=phase,
                             g=-0.5 if phase == "hg" else 0.0)
    card_vs_cpu(make, dev, f"volcaustic {phase} {engine}", engine=engine)


@pytest.mark.cuda
def test_dense_closest_hit_backward_card_vs_cpu():
    """K1's autograd backward (DenseClosestHit: the kernel's forward, the
    winning row's Moller-Trumbore again in plain torch) on the card
    against the same on the CPU (plain forward), by chip_smoke.k1_backward:
    the gradients of t, v and w into o and d within 1e-5 of the largest."""
    from chip_smoke import k1_backward

    dev = _cuda()
    o, d = (torch.as_tensor(x, device=dev) for x in random_rays(8192))
    tris = torch.as_tensor(random_tris(2048), device=dev)
    t_max = torch.full((8192,), 3.4e38, device=dev)
    t_max[::16] = 0.0
    rec = k1_backward(o, d, torch.full((8192,), 1e-4, device=dev), t_max,
                      tris)
    assert rec["max_rel_err"] <= 1e-5


@pytest.mark.cuda
def test_bdpt_render_card_vs_cpu():
    """A 64x64, 4 spp BDPT render of bdpt_caustic (depth 8, the chunked
    engine) on the card against the CPU's, by chip_smoke.card_vs_cpu."""
    from chip_smoke import card_vs_cpu
    from mcpt_tpu_torch.scene.builtin import bdpt_caustic

    card_vs_cpu(bdpt_caustic, _cuda(), "bdpt_caustic")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["volcaustic media", "caustic glass eta"])
def test_train_step_card_vs_cpu(case):
    """make_train_step's loss and gradients on the card against the CPU's,
    64x64, 2 spp, by chip_smoke.grad_card_vs_cpu (rtol 1e-4 of each
    leaf's largest): the fog's sigma_s and sigma_t, whose scatter points
    move the next hits, and the glass sphere's eta through the path
    integrator, whose refractions do (K1's backward on the card)."""
    from chip_smoke import caustic_glass_by_path, grad_card_vs_cpu
    from mcpt_tpu_torch.scene.builtin import volumetric_caustic

    make, families = {
        "volcaustic media": (volumetric_caustic, ("media",)),
        "caustic glass eta": (caustic_glass_by_path, ("bsdf",)),
    }[case]
    grad_card_vs_cpu(make, families, _cuda(), case)
