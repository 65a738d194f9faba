"""Kernel K2: the block march over SAH chunks, and its plain version.

The counterpart of the Pallas kernel mcpt_tpu/ops/pallas_march.py
(`_march_kernel`, `march_sweep`) and of its XLA oracle
mcpt_tpu/ops/traversal.py::_intersect_march.  The kernel is CUDA C++
(csrc/march_sweep.cu); `march_sweep` launches it for CUDA tensors and
runs `march_sweep_plain` for CPU tensors.  It never falls back from one
to the other.

Contract: rays o, d [N,3] f32, t_min, t_max [N] f32 — for the kernel,
sorted so that each block of ray_block() rays shares chunks; the chunk
AABBs cmin, cmax [Lm,3] f32 (and, for the kernel's super-chunk cull,
their unions over runs of SUPER chunks, super_boxes); the chunk
triangles tris [Lm,ls,12] f32 (p0.xyz, e1.xyz, e2.xyz, opaque, ...) and
their global prim ids prim [Lm,ls] int32.  Returns a GeomHit: the nearest hit in [t_min, t_max) —
in any-hit mode an opaque hit — found by visiting chunks nearest entry
first and stopping once no remaining chunk can hold a nearer hit.

Knobs, read as the reference reads them: MCPT_MARCH_BLOCK (rays per
block), MCPT_MARCH_GROUP (triangles per phase-B group, default 1024),
MCPT_MARCH_SUPER (super-chunk cull, default 1), MCPT_MARCH_IVAL (interval
phase A, default 0).  None changes a hit: the plain version, which is
order-free, is the oracle for every setting.
"""

from __future__ import annotations

import os
import warnings

import torch

from mcpt_tpu_torch.ops.dense_sweep import GeomHit, _check
from mcpt_tpu_torch.ops.intersect import intersect_aabb, intersect_triangle, safe_rcp

#: kernel launches made by `march_sweep` (CUDA tensors only), and how many
#: of them were in any-hit mode
launches = 0
any_hit_launches = 0

#: (ray, chunk) slab tests per step of `chunk_entry`
ENTRY_BATCH = 1 << 22

#: the most rays a CUDA block may hold
MAX_BLOCK = 1024

#: rays per block unless MCPT_MARCH_BLOCK says otherwise
DEFAULT_BLOCK = 32

#: the largest dynamic shared memory a block may ask for on Hopper (bytes)
MAX_SMEM = 232448

#: chunks per super-chunk union (the reference's SUPER)
SUPER = 128

#: default MCPT_MARCH_GROUP lane target (triangles per phase-B group)
GROUP_TARGET = 1024


def ray_block() -> int:
    """Rays per march block (one owner thread each).  Smaller blocks
    shrink the union of their rays' chunk corridors, which a block visits
    group by group, and spread few long rays over more SMs; larger ones
    share phase A over more rays.  Default 32: on the card the smallest
    block was the fastest on the march scene's bounce rays (chip_smoke's
    kernel-K2 block sweep, PERF.md); the reference's 256 is its TPU lane
    tiling.  MCPT_MARCH_BLOCK overrides, rounded up to a multiple of 32
    (a warp)."""
    raw = os.environ.get("MCPT_MARCH_BLOCK", str(DEFAULT_BLOCK))
    try:
        r = int(raw)
    except ValueError as e:
        raise ValueError(
            f"MCPT_MARCH_BLOCK must be an integer, got {raw!r}") from e
    if not 0 < r <= MAX_BLOCK:
        raise ValueError(f"MCPT_MARCH_BLOCK must be in 1..{MAX_BLOCK}, got {r}")
    r_pad = -(-r // 32) * 32
    if r_pad != r:
        warnings.warn(f"MCPT_MARCH_BLOCK={r} is not a multiple of 32; "
                      f"rounding up to {r_pad}", stacklevel=2)
    return r_pad


def chunk_entry(o, d, t_min, t_max, cmin, cmax):
    """[N, Lm] entry distance of every ray into every chunk AABB, clamped
    at 0; +inf where the slab test fails or the entry is beyond 1e30
    (empty chunks are parked at 3e37)."""
    n, lm = o.shape[0], cmin.shape[0]
    d_rcp = safe_rcp(d)
    out = torch.empty((n, lm), dtype=torch.float32, device=o.device)
    step = max(1, ENTRY_BATCH // max(lm, 1))
    for s in range(0, n, step):
        e = slice(s, s + step)
        hit, t_enter = intersect_aabb(
            o[e, None, :], d_rcp[e, None, :], cmin[None], cmax[None],
            t_min[e, None], t_max[e, None])
        out[e] = torch.where(hit & (t_enter < 1e30),
                             torch.clamp(t_enter, min=0.0),
                             torch.full_like(t_enter, float("inf")))
    return out


def march_sweep_plain(o, d, t_min, t_max, cmin, cmax, tris, prim,
                      any_hit: bool = False) -> GeomHit:
    """Per-lane nearest-chunk-first march (the torch twin of
    traversal._intersect_march): every step, each lane whose nearest
    unvisited chunk enters before its best t sweeps that chunk's
    triangles (lowest index first among equal t) and masks it.  Any-hit
    lanes stop at their first chunk with an opaque hit.  Order-free: the
    result of a lane does not depend on the other lanes."""
    n = o.shape[0]
    dev = o.device
    ent = chunk_entry(o, d, t_min, t_max, cmin, cmax)
    t_best = t_max.clone()
    prim_best = torch.zeros(n, dtype=torch.int32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    w_best = torch.zeros_like(v_best)
    in_best = torch.zeros(n, dtype=torch.bool, device=dev)
    valid = torch.zeros_like(in_best)
    while True:
        te, li = ent.min(dim=1)  # first index among equal minima
        active = te < t_best
        if any_hit:
            active = active & ~valid
        rows = active.nonzero()[:, 0]
        if rows.numel() == 0:
            break
        ci = li[rows]
        c = tris[ci]  # [A, ls, 12]
        hit, t, v, w, det_inv = intersect_triangle(
            o[rows, None, :], d[rows, None, :], c[..., 0:3], c[..., 3:6],
            c[..., 6:9], t_min[rows, None], t_best[rows, None])
        if any_hit:
            hit = hit & (c[..., 9] > 0.5)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        tk, k = t.min(dim=1)
        take = torch.isfinite(tk) & (tk < t_best[rows])
        r, kk = rows[take], k[take]
        a = torch.arange(rows.numel(), device=dev)[take]
        t_best[r] = tk[take]
        prim_best[r] = prim[ci[take], kk]
        v_best[r] = v[a, kk]
        w_best[r] = w[a, kk]
        in_best[r] = det_inv[a, kk] < 0.0
        valid[r] = True
        ent[rows, ci] = float("inf")
    return GeomHit(valid=valid, t=t_best, prim=prim_best, v=v_best,
                   w=w_best, inside=in_best)


def use_super_cull() -> bool:
    """The two-level super-chunk phase A, default on (MCPT_MARCH_SUPER=0
    turns it off), read as the reference's _use_super_cull."""
    return os.environ.get("MCPT_MARCH_SUPER", "1") == "1"


def use_interval() -> bool:
    """The interval phase A, opt-in (MCPT_MARCH_IVAL=1), read as the
    reference's march wrapper reads it (ops/traversal.py:897)."""
    return os.environ.get("MCPT_MARCH_IVAL", "0") == "1"


def chunk_group(ls: int) -> int:
    """Chunks per phase-B group, as the reference's _chunk_group: a lane
    target of MCPT_MARCH_GROUP triangles (default 1024) over chunks of ls,
    at least one.  The kernel's launch clamps it to shared memory
    (card_group)."""
    raw = os.environ.get("MCPT_MARCH_GROUP")
    target = GROUP_TARGET if raw is None else int(raw)
    return max(1, target // ls)


def card_group(lib, ls: int, lm: int, block: int, n_sup: int):
    """(cg, bytes): chunk_group clamped so that the block's shared memory,
    as the kernel lays it out (lib.mcpt_march_smem_bytes), fits MAX_SMEM,
    with a warning where MCPT_MARCH_GROUP asked for more (the reference
    clamps by the TPU's scoped VMEM instead); and that memory in bytes."""
    def smem(cg):
        return lib.mcpt_march_smem_bytes(lm, ls, n_sup, block, cg)

    cg = chunk_group(ls)
    if smem(1) > MAX_SMEM:
        raise ValueError(
            f"march_sweep: {lm} chunks of {ls} triangles at {block} rays per "
            f"block need more than the {MAX_SMEM} bytes of shared memory a "
            "block can have")
    if smem(cg) > MAX_SMEM:
        per_chunk = smem(2) - smem(1)  # the group's rows grow linearly
        cg_max = 1 + (MAX_SMEM - smem(1)) // per_chunk
        if "MCPT_MARCH_GROUP" in os.environ:
            warnings.warn(
                f"MCPT_MARCH_GROUP={os.environ['MCPT_MARCH_GROUP']} needs {cg} "
                f"chunks of {ls} triangles per group, more than fit a block's "
                f"shared memory at MCPT_MARCH_BLOCK={block}; clamping to "
                f"{cg_max}", stacklevel=3)
        cg = cg_max
    return cg, smem(cg)


def super_boxes(cmin, cmax, size: int = SUPER):
    """Union AABBs of each run of `size` consecutive chunks (the last run
    may be partial): [S, 3] min and max, S = ceil(Lm / size).  The SAH
    order keeps consecutive chunks spatially tight.  K3 builds the same
    unions of 32 chunks in the kernel."""
    lm = cmin.shape[0]
    n_sup = -(-lm // size)
    pad = n_sup * size - lm

    def runs(x, fill, reduce):
        x = torch.cat([x, x.new_full((pad, 3), fill)]) if pad else x
        return reduce(x.view(n_sup, size, 3), dim=1)

    return (runs(cmin, float("inf"), torch.amin),
            runs(cmax, float("-inf"), torch.amax))


def march_sweep(o, d, t_min, t_max, cmin, cmax, tris, prim, supers,
                any_hit: bool = False) -> GeomHit:
    """K2 on CUDA tensors (rays in block order), its plain version on CPU
    tensors.  supers: the (smin, smax) unions of super_boxes, as the
    geometry keeps them (march_super_min, march_super_max)."""
    if o.device.type == "cpu":
        return march_sweep_plain(o, d, t_min, t_max, cmin, cmax, tris, prim,
                                 any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"march_sweep: unsupported device {o.device}")
    n = o.shape[0]
    lm, ls = prim.shape
    dev = o.device
    for name, x, shape in (
        ("o", o, (n, 3)), ("d", d, (n, 3)), ("t_min", t_min, (n,)),
        ("t_max", t_max, (n,)), ("cmin", cmin, (lm, 3)),
        ("cmax", cmax, (lm, 3)), ("tris", tris, (lm, ls, 12)),
    ):
        _check(name, x, shape, torch.float32, dev)
    _check("prim", prim, (lm, ls), torch.int32, dev)
    if tris.data_ptr() % 8:
        raise ValueError("march_sweep: tris must be 8-byte aligned "
                         "(its rows are copied 8 bytes at a time)")
    if lm * ls >= 2**31 // 12:
        raise ValueError("march_sweep: the chunk pack overflows int32 indexing")
    block = ray_block()
    interval = use_interval()
    if use_super_cull() and not interval:  # as the reference: exact mode only
        smin, smax = supers
        n_sup = smin.shape[0]
        for name, x in (("smin", smin), ("smax", smax)):
            _check(name, x, (-(-lm // SUPER), 3), torch.float32, dev)
    else:
        smin, smax, n_sup = cmin, cmax, 0  # not read

    from mcpt_tpu_torch.build import library

    lib = library()
    cg, _ = card_group(lib, ls, lm, block, n_sup)  # raises past MAX_SMEM
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    w = torch.empty(n, dtype=torch.float32, device=dev)
    inside = torch.empty(n, dtype=torch.bool, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcpt_march_sweep(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), smin.data_ptr(),
            smax.data_ptr(), tris.data_ptr(), prim.data_ptr(), n, lm, ls,
            n_sup, block, cg, int(any_hit) | (int(interval) << 1),
            t.data_ptr(), prim_out.data_ptr(), v.data_ptr(), w.data_ptr(),
            inside.data_ptr(), valid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"march_sweep kernel launch failed: cudaError {err}")
    global launches, any_hit_launches
    launches += 1
    any_hit_launches += int(any_hit)
    return GeomHit(valid=valid, t=t, prim=prim_out, v=v, w=w, inside=inside)
