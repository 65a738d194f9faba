"""Closest-hit and any-hit queries (counterpart of
mcpt_tpu/ops/traversal.py: ray sort keys :359-451, the packet walk
:454-623, routing :660-683, the march wrapper :781-905, the pair
traversal :928-1069 and the dispatch :1096-1150).

Scenes of at most DENSE_MAX_PRIMS padded prims go to the dense sweep
(kernel K1).  Larger scenes take the route `resolved_strategy` picks:

* ``march`` — rays sorted by coherence keys, then the block march
  (kernel K2) over the SAH chunk pack, then the inverse permutation;
* ``pairs`` — each ray's first K corridor chunks (kernel K3), the
  (ray, chunk) pairs sorted by chunk and swept (kernel K4), a K-way
  per-ray min, and the block march over the rays whose corridor
  overflows, compacted first;
* ``packet`` (MCPT_TRAVERSAL=packet only) — rays sorted by coherence
  keys, then the BVH walk (kernel K5: one ray a thread, in the order of
  the reference's per-lane walk _traverse), then the inverse
  permutation.

Every kernel runs for CUDA tensors and its plain version for CPU
tensors; nothing falls back from one to the other.

Gradients follow the reference (traversal.py:636-660): the dense closest
hit carries one into the rays (dense_sweep.DenseClosestHit); the march,
pair and packet routes return detached records, and any-hit results are
bools.
"""

from __future__ import annotations

import os

import torch

from mcpt_tpu_torch.ops import march_sweep as msw
from mcpt_tpu_torch.ops import packet_sweep as pkt
from mcpt_tpu_torch.ops import pair_sweep as psw
from mcpt_tpu_torch.ops.dense_sweep import (DenseClosestHit, GeomHit,
                                            dense_sweep)
from mcpt_tpu_torch.ops.math import EPSILON_DISTANCE, MAX_FLOAT

__all__ = [
    "DENSE_MAX_PRIMS", "GeomHit", "intersect_closest", "intersect_any",
    "resolved_strategy",
]

#: scenes up to this many padded primitives use the dense sweep
DENSE_MAX_PRIMS = 16384

#: MCPT_TRAVERSAL values; "packet" is the BVH walk (kernel K5), which
#: only MCPT_TRAVERSAL chooses
STRATEGIES = ("auto", "march", "pairs", "packet")


def _bounds(o, t_min, t_max):
    n = o.shape[0]

    def full(x, default):
        x = default if x is None else x
        x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
        return x.expand(n).contiguous()

    return full(t_min, EPSILON_DISTANCE), full(t_max, MAX_FLOAT)


# ---------------------------------------------------------------- ray order


def _morton10(x):
    """Interleave the low 10 bits of int64 lanes 3 apart (the reference's
    uint32 arithmetic: every intermediate is masked below 2^32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0xFF0000FF
    x = (x | (x << 8)) & 0x0F00F00F
    x = (x | (x << 4)) & 0xC30C30C3
    x = (x | (x << 2)) & 0x49249249
    return x


def _octant(d):
    return ((d[..., 0] >= 0).long() * 4 + (d[..., 1] >= 0).long() * 2
            + (d[..., 2] >= 0).long())


def _ray_sort_keys(geom, o, d, mode: str | None = None, coherence=None):
    """Coherence keys so a march block's rays share chunks; bit-equal to
    the reference's.  Modes (MCPT_MARCH_SORT): ``octori`` (default:
    direction octant, then 25 bits of the origin's Morton code inside
    the scene bounds), ``dirori`` (12-bit direction Morton, then origin
    Morton) and ``octdir`` (2 bits per direction axis, then origin
    Morton).  ``coherence``: optional [N] int32 origin chunk id (-1 =
    unknown); lanes with one get a chunk-major key.  Every key fits in
    28 bits; the caller ORs the class at bits 28-29 and the dead bit at
    30.  Returns [N] int32."""
    if mode is None:
        mode = os.environ.get("MCPT_MARCH_SORT", "octori")
    lo, hi = geom.bounds_min, geom.bounds_max
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((o - lo) / span, 0.0, 1.0)
    qi = (q * 1023.0).long()
    morton = ((_morton10(qi[..., 0]) << 2) | (_morton10(qi[..., 1]) << 1)
              | _morton10(qi[..., 2]))
    geo_mask = (1 << 28) - 1
    if mode == "dirori":
        dq = torch.clamp((d + 1.0) * 0.5, 0.0, 1.0)
        di = (dq * 15.0).long()  # 4 bits per axis
        dmorton = ((_morton10(di[..., 0]) << 2) | (_morton10(di[..., 1]) << 1)
                   | _morton10(di[..., 2]))
        keys = ((dmorton << 14) | (morton >> 16)) & geo_mask
    elif mode == "octdir":
        dq = torch.clamp((d + 1.0) * 0.5, 0.0, 1.0)
        di = (dq * 3.999).long()  # 2 bits per axis
        dir6 = (di[..., 0] << 4) | (di[..., 1] << 2) | di[..., 2]
        keys = ((dir6 << 22) | (morton >> 8)) & geo_mask
    else:
        keys = ((_octant(d) << 25) | (morton >> 5)) & geo_mask
    if coherence is not None:
        coh = torch.as_tensor(coherence, device=o.device).long()
        ck = ((torch.clamp(coh, 0, 2047) << 17) | (_octant(d) << 14)
              | (morton >> 16)) & geo_mask
        keys = torch.where(coh >= 0, ck, keys)
    return keys.to(torch.int32)


def _unsort(order, hit: GeomHit) -> GeomHit:
    """Scatter a hit record computed in `order` back to ray order."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return GeomHit(*(x[inv] for x in hit))


# ---------------------------------------------------------------- routing


def _large_strategy() -> str:
    """Large-scene (> DENSE_MAX_PRIMS) traversal: MCPT_TRAVERSAL, one of
    STRATEGIES, default 'auto'."""
    s = os.environ.get("MCPT_TRAVERSAL", "auto")
    if s not in STRATEGIES:
        raise ValueError(f"MCPT_TRAVERSAL={s!r}: expected one of {STRATEGIES}")
    return s


def resolved_strategy(geom) -> str:
    """The traversal a geometry uses ('auto' resolved).  A chunk size
    below 256 is the commit-time mark of many thin chunks, whose block
    corridor unions are wide: auto = pairs iff march_leaf < 256."""
    s = _large_strategy()
    if s != "auto":
        return s
    return "pairs" if geom.march_leaf < 256 else "march"


# ---------------------------------------------------------------- march


def march_order(geom, o, d, t_min, t_max, sort_bias=None, coherence=None):
    """The march's ray order: one sort of the coherence keys, with dead
    lanes (t_max <= t_min) at bit 30 so that they sort last, into blocks
    that skip the march, and the optional class `sort_bias` (camera 0,
    bounce 1) at bits 28-29, so that fresh camera rays and bounce rays
    never share a block.  `coherence`: optional [N] origin chunk id (-1 =
    unknown), _ray_sort_keys' chunk-major keys (MCPT_COH).  Returns the
    [N] permutation."""
    keys = _ray_sort_keys(geom, o, d, coherence=coherence) | torch.where(
        t_max <= t_min, 1 << 30, 0).to(torch.int32)
    if sort_bias is not None:
        keys = keys | (sort_bias.to(torch.int32) << 28)
    return torch.sort(keys, stable=True)[1]


def _intersect_march_cuda(geom, o, d, t_min, t_max, any_hit,
                          sort_bias=None, coherence=None) -> GeomHit:
    """The block march (kernel K2) over rays in march_order, so that each
    block of ray_block() rays shares chunks; the hits go back to ray
    order.  o, d: [N, 3]; t_min, t_max: [N]."""
    order = march_order(geom, o, d, t_min, t_max, sort_bias, coherence)
    hit = msw.march_sweep(o[order], d[order], t_min[order], t_max[order],
                          geom.march_min, geom.march_max, geom.march_tris,
                          geom.march_prim, any_hit=any_hit,
                          supers=(geom.march_super_min,
                                  geom.march_super_max))
    return _unsort(order, hit)


def _march_overflow(geom, o, d, t_min, t_max, overflow, any_hit) -> GeomHit:
    """The block march over the rays whose corridor overflows, and only
    those: they are compacted first (one host sync, for their count), so
    that the ~1% of long rays fill their blocks instead of being sorted
    among N and launched with N / ray_block() blocks.  Returns [N] hits,
    invalid where `overflow` is False."""
    n = o.shape[0]
    idx = overflow.nonzero()[:, 0]
    full = GeomHit(
        valid=torch.zeros(n, dtype=torch.bool, device=o.device),
        t=t_max.clone(),
        prim=torch.zeros(n, dtype=torch.int32, device=o.device),
        v=torch.zeros(n, dtype=torch.float32, device=o.device),
        w=torch.zeros(n, dtype=torch.float32, device=o.device),
        inside=torch.zeros(n, dtype=torch.bool, device=o.device),
    )
    if idx.numel() == 0:
        return full
    hit = _intersect_march_cuda(geom, o[idx], d[idx], t_min[idx], t_max[idx],
                                any_hit)
    for dst, src in zip(full, hit):
        dst[idx] = src
    return full


# ---------------------------------------------------------------- pairs


def pair_inputs(geom, o, d, t_min, t_max, k: int):
    """The pair route's inputs to K4: each ray's first k corridor chunks
    (kernel K3) as (ray, chunk) pairs, sorted by chunk id in one sort.
    Pairs of rays whose corridor has more than k chunks are killed
    (chunk = Lm, t_max = 0), as are empty slots; they sort last.  Returns
    (overflow [N] bool, order [N*k] — the pair slot ray*k + j at each
    sorted position — and the sorted pairs' o, d, t_min, t_max, chunk)."""
    n = o.shape[0]
    lm = geom.n_march_leaves
    slots, overflow = psw.corridor(o, d, t_min, t_max, geom.march_min,
                                   geom.march_max, k)
    overflow = overflow & (t_max > t_min)
    pc = torch.where(overflow[:, None] | (slots >= lm),
                     torch.full_like(slots, lm), slots).reshape(n * k)
    order = torch.sort(pc, stable=True)[1]
    ray = order // k
    pc_s = pc[order]
    tmax_s = torch.where(pc_s >= lm, torch.zeros_like(t_max[ray]), t_max[ray])
    return overflow, order, o[ray], d[ray], t_min[ray], tmax_s, pc_s


def _intersect_pairs(geom, o, d, t_min, t_max, any_hit) -> GeomHit:
    """Pair-scheduled traversal: the (ray, chunk) pairs of pair_inputs are
    swept against their own chunk only (kernel K4); the per-ray winner is
    a K-way min with the lowest slot winning among equal t.  Rays whose
    corridor overflows go through the block march instead
    (_march_overflow)."""
    n = o.shape[0]
    k = psw.pair_k()
    overflow, order, *pairs = pair_inputs(geom, o, d, t_min, t_max, k)
    hit_p = psw.pair_sweep(*pairs, geom.march_tris, geom.march_prim,
                           any_hit=any_hit)
    hit_p = GeomHit(*(x.reshape(n, k) for x in _unsort(order, hit_p)))

    # K-way reduce per ray: each pair tested exactly one chunk
    inf = torch.full_like(hit_p.t, float("inf"))
    tm = torch.where(hit_p.valid, hit_p.t, inf).amin(dim=1)
    slot = torch.arange(k, device=o.device).expand(n, k)
    kw = torch.where(hit_p.valid & (hit_p.t == tm[:, None]), slot,
                     torch.full_like(slot, k)).amin(dim=1)
    valid_r = torch.isfinite(tm)

    def pick(a):
        x = a.gather(1, kw.clamp(max=k - 1)[:, None])[:, 0]
        return torch.where(valid_r, x, torch.zeros_like(x))

    t_r = torch.where(valid_r, tm, t_max)
    # overflow fallback: the block march over the overflow lanes alone
    fb = _march_overflow(geom, o, d, t_min, t_max, overflow, any_hit)
    take = fb.valid
    return GeomHit(
        valid=valid_r | take,
        t=torch.where(take, fb.t, t_r),
        prim=torch.where(take, fb.prim, pick(hit_p.prim)),
        v=torch.where(take, fb.v, pick(hit_p.v)),
        w=torch.where(take, fb.w, pick(hit_p.w)),
        inside=torch.where(take, fb.inside, pick(hit_p.inside)),
    )


# ---------------------------------------------------------------- packet


def _intersect_packet(geom, o, d, t_min, t_max, any_hit) -> GeomHit:
    """The packet route: the BVH walk (kernel K5) over rays in the order
    of a stable sort of their coherence keys (MCPT_MARCH_SORT; no
    dead-lane bit and no class, as the reference's jnp.argsort), so that
    the rays of a warp walk alike; the hits go back to ray order."""
    order = torch.sort(_ray_sort_keys(geom, o, d), stable=True)[1]
    tris = geom.packed_tris.view(geom.n_pad_leaves, geom.leaf_size, 12)
    hit = pkt.packet_sweep(o[order], d[order], t_min[order], t_max[order],
                           geom.node_min, geom.node_max, tris,
                           any_hit=any_hit)
    return _unsort(order, hit)


# ---------------------------------------------------------------- dispatch


def _trace(geom, o, d, t_min, t_max, any_hit, sort_bias=None,
           coherence=None) -> GeomHit:
    o, d = o.contiguous(), d.contiguous()
    lo, hi = _bounds(o, t_min, t_max)
    if geom.packed_tris.shape[0] <= DENSE_MAX_PRIMS:
        if not any_hit:
            return GeomHit(*DenseClosestHit.apply(o, d, lo, hi,
                                                  geom.packed_tris))
        with torch.no_grad():
            return dense_sweep(o, d, lo, hi, geom.packed_tris, any_hit=True)
    # the march, pair and packet records are detached (the reference's
    # _detached)
    o, d, lo, hi = o.detach(), d.detach(), lo.detach(), hi.detach()
    strategy = resolved_strategy(geom)
    if strategy == "packet":
        return _intersect_packet(geom, o, d, lo, hi, any_hit)
    if strategy == "pairs":
        return _intersect_pairs(geom, o, d, lo, hi, any_hit)
    return _intersect_march_cuda(geom, o, d, lo, hi, any_hit,
                                 sort_bias=sort_bias, coherence=coherence)


def intersect_closest(geom, o, d, t_min=None, t_max=None, sort_bias=None,
                      coherence=None) -> GeomHit:
    """Closest hit of every ray in [t_min, t_max); o, d: [N, 3].
    `sort_bias`: optional [N] int coherence class; `coherence`: optional
    [N] origin chunk id, -1 unknown (both: march route only)."""
    return _trace(geom, o, d, t_min, t_max, False, sort_bias=sort_bias,
                  coherence=coherence)


def intersect_any(geom, o, d, t_min=None, t_max=None,
                  coherence=None) -> torch.Tensor:
    """Occlusion by an opaque triangle; returns [N] bool.  `coherence`:
    as intersect_closest's (march route only)."""
    return _trace(geom, o, d, t_min, t_max, True, coherence=coherence).valid
