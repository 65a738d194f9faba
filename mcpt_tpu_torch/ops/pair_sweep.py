"""Kernels K3 (corridor) and K4 (pair sweep), and their plain versions.

The counterparts of the Pallas kernels mcpt_tpu/ops/pallas_pairs.py
(`_corridor_kernel` / `corridor_sweep`, `_pair_kernel` / `pair_sweep`).
Both kernels are CUDA C++ (csrc/pair_sweep.cu); `corridor` and
`pair_sweep` launch them for CUDA tensors and run `corridor_plain` and
`pair_sweep_plain` for CPU tensors.  Neither falls back.

* K3, corridor: per ray, the first K chunk ids (in index order) whose
  AABB the ray enters within [t_min, t_max], Lm meaning none, and an
  overflow flag when a (K+1)-th chunk passes.
* K4, pair sweep: per (ray, chunk) pair, the nearest hit in
  [t_min, t_max) among that chunk's triangles only (in any-hit mode the
  nearest opaque one), lowest index first among equal t.  Pairs come
  sorted by chunk id so that a warp's 32 pairs share few chunks; dead
  pairs carry chunk = Lm and do no work.  Any chunk size works.
"""

from __future__ import annotations

import os

import torch

from mcpt_tpu_torch.ops.dense_sweep import GeomHit, _check
from mcpt_tpu_torch.ops.intersect import intersect_triangle
from mcpt_tpu_torch.ops.march_sweep import chunk_entry

#: kernel launches (CUDA tensors only)
corridor_launches = 0
pair_launches = 0

#: most corridor slots per ray
MAX_K = 32

#: (pair, triangle) tests per step of `pair_sweep_plain`
PAIR_BATCH = 1 << 22


def pair_k() -> int:
    """Corridor pair slots per ray (MCPT_PAIR_K, default 8): rays whose
    corridor is longer fall back to the block march."""
    k = max(1, int(os.environ.get("MCPT_PAIR_K", "8")))
    if k > MAX_K:
        raise ValueError(f"MCPT_PAIR_K={k} exceeds {MAX_K}")
    return k


def pair_block() -> int:
    """Pairs (threads) per K4 block (MCPT_PAIR_BLOCK, default 512, rounded
    up to a multiple of 128 as the reference rounds it, at most 1024)."""
    raw = os.environ.get("MCPT_PAIR_BLOCK")
    r = int(raw) if raw is not None else 512
    return min(1024, max(128, -(-r // 128) * 128))


def corridor_plain(o, d, t_min, t_max, cmin, cmax, k: int):
    """Plain corridor: the [N, Lm] slab pass, then the first k passing
    ids per ray.  Returns (slots [N, k] int32, Lm = none; overflow [N]
    bool)."""
    n, lm = o.shape[0], cmin.shape[0]
    ok = torch.isfinite(chunk_entry(o, d, t_min, t_max, cmin, cmax))
    rank = ok.to(torch.int32).cumsum(dim=1)
    sel = ok & (rank <= k)
    slots = torch.full((n, k), lm, dtype=torch.int32, device=o.device)
    rows, cols = sel.nonzero(as_tuple=True)
    slots[rows, (rank[rows, cols] - 1).long()] = cols.to(torch.int32)
    return slots, rank[:, -1] > k


def corridor(o, d, t_min, t_max, cmin, cmax, k: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if o.device.type == "cpu":
        return corridor_plain(o, d, t_min, t_max, cmin, cmax, k)
    if o.device.type != "cuda":
        raise ValueError(f"corridor: unsupported device {o.device}")
    n, lm = o.shape[0], cmin.shape[0]
    dev = o.device
    for name, x, shape in (
        ("o", o, (n, 3)), ("d", d, (n, 3)), ("t_min", t_min, (n,)),
        ("t_max", t_max, (n,)), ("cmin", cmin, (lm, 3)),
        ("cmax", cmax, (lm, 3)),
    ):
        _check(name, x, shape, torch.float32, dev)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"corridor: k={k} outside 1..{MAX_K}")
    if n * k >= 2**31:
        raise ValueError("corridor: slots overflow int32 indexing")

    from mcpt_tpu_torch.build import library

    lib = library()
    slots = torch.empty((n, k), dtype=torch.int32, device=dev)
    overflow = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcpt_corridor(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), n, lm, k,
            slots.data_ptr(), overflow.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"corridor kernel launch failed: cudaError {err}")
    global corridor_launches
    corridor_launches += 1
    return slots, overflow


def pair_sweep_plain(o, d, t_min, t_max, chunk, tris, prim,
                     any_hit: bool = False) -> GeomHit:
    """Plain pair sweep: each live pair (chunk < Lm) against its chunk's
    ls triangles, [pairs, ls] at a time; the pair order does not matter."""
    m = o.shape[0]
    lm, ls = prim.shape
    dev = o.device
    t_best = t_max.clone()
    prim_best = torch.zeros(m, dtype=torch.int32, device=dev)
    v_best = torch.zeros(m, dtype=torch.float32, device=dev)
    w_best = torch.zeros_like(v_best)
    in_best = torch.zeros(m, dtype=torch.bool, device=dev)
    valid = torch.zeros_like(in_best)
    live = (chunk < lm).nonzero()[:, 0]
    step = max(1, PAIR_BATCH // max(ls, 1))
    for s in range(0, live.numel(), step):
        rows = live[s:s + step]
        ci = chunk[rows].long()
        c = tris[ci]  # [B, ls, 12]
        hit, t, v, w, det_inv = intersect_triangle(
            o[rows, None, :], d[rows, None, :], c[..., 0:3], c[..., 3:6],
            c[..., 6:9], t_min[rows, None], t_max[rows, None])
        if any_hit:
            hit = hit & (c[..., 9] > 0.5)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        tk, k = t.min(dim=1)  # first index among equal minima
        take = torch.isfinite(tk) & (tk < t_max[rows])
        r, kk = rows[take], k[take]
        a = torch.arange(rows.numel(), device=dev)[take]
        t_best[r] = tk[take]
        prim_best[r] = prim[ci[take], kk]
        v_best[r] = v[a, kk]
        w_best[r] = w[a, kk]
        in_best[r] = det_inv[a, kk] < 0.0
        valid[r] = True
    return GeomHit(valid=valid, t=t_best, prim=prim_best, v=v_best,
                   w=w_best, inside=in_best)


def pair_sweep(o, d, t_min, t_max, chunk, tris, prim,
               any_hit: bool = False) -> GeomHit:
    """K4 on CUDA tensors (pairs sorted by chunk), its plain version on
    CPU tensors."""
    if o.device.type == "cpu":
        return pair_sweep_plain(o, d, t_min, t_max, chunk, tris, prim, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"pair_sweep: unsupported device {o.device}")
    m = o.shape[0]
    lm, ls = prim.shape
    dev = o.device
    for name, x, shape in (
        ("o", o, (m, 3)), ("d", d, (m, 3)), ("t_min", t_min, (m,)),
        ("t_max", t_max, (m,)), ("tris", tris, (lm, ls, 12)),
    ):
        _check(name, x, shape, torch.float32, dev)
    _check("chunk", chunk, (m,), torch.int32, dev)
    _check("prim", prim, (lm, ls), torch.int32, dev)
    if ls < 1:
        raise ValueError("pair_sweep: chunks must hold at least one triangle")
    if tris.data_ptr() % 16:
        raise ValueError("pair_sweep: tris must be 16-byte aligned (rows are "
                         "read as float4)")
    if lm * ls >= 2**31 // 12:
        raise ValueError("pair_sweep: the chunk pack overflows int32 indexing")

    from mcpt_tpu_torch.build import library

    lib = library()
    t = torch.empty(m, dtype=torch.float32, device=dev)
    prim_out = torch.empty(m, dtype=torch.int32, device=dev)
    v = torch.empty(m, dtype=torch.float32, device=dev)
    w = torch.empty(m, dtype=torch.float32, device=dev)
    inside = torch.empty(m, dtype=torch.bool, device=dev)
    valid = torch.empty(m, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcpt_pair_sweep(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            chunk.data_ptr(), tris.data_ptr(), prim.data_ptr(), m, lm, ls,
            pair_block(), int(any_hit),
            t.data_ptr(), prim_out.data_ptr(), v.data_ptr(), w.data_ptr(),
            inside.data_ptr(), valid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_sweep kernel launch failed: cudaError {err}")
    global pair_launches
    pair_launches += 1
    return GeomHit(valid=valid, t=t, prim=prim_out, v=v, w=w, inside=inside)
