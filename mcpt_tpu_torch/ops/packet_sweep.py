"""Kernel K5: the BVH walk of the packet route, and its plain version.

K5 replaces no Pallas kernel.  It serves the reference's packet route,
mcpt_tpu/ops/traversal.py::_intersect_packet (:454-623), which walks the
implicit BVH in packets of 1024 rays with one shared stack: the TPU's
stand-in for per-lane stacks (its docstring, :455-461), and so no part of
K5's contract.  K5 walks the same tree one ray a thread, in the order of
the reference's per-lane walk, mcpt_tpu/ops/traversal.py::_traverse
(:60-148, its leaf loop _leaf_intersect :36-57).  It is written by hand
because eager torch cannot run that loop at full width: a node visit is
tens of launches and a host test of the stacks, and a ray visits up to
hundreds of nodes.  The kernel is CUDA C++ (csrc/packet_sweep.cu);
`packet_sweep` launches it for CUDA tensors and runs `packet_sweep_plain`
for CPU tensors.  It never falls back from one to the other.

Contract: rays o, d [N,3] f32, t_min, t_max [N] f32, in the caller's
order (the packet route sorts them by coherence keys first, so that the
rays of a warp walk alike); the BVH's node boxes node_min, node_max [M,3]
f32 (scene/bvh.py: node i's children are 2i+1 and 2i+2, the leaves start
at n_pad_leaves - 1); the leaves' rows tris [n_pad_leaves, leaf_size, 12]
f32 (p0.xyz, e1.xyz, e2.xyz, opaque, ..), the packed triangle table viewed
by leaf.  Returns a GeomHit whose prim indexes the packed table.

The walk (`_traverse`'s, per ray): a stack of node ids, depth + 2 deep,
holding the root.  Pop a node.  At a leaf, test its rows in index order
against [t_min, best t], keeping a hit only below the best t, so the
lowest row wins among equal t (any-hit: opaque rows only, and the ray's
walk ends after the leaf where it found a hit).  At an internal node,
slab-test both children against [t_min, best t]; where both are entered,
push the far child and then the near one (the near one is c0 when
t0 <= t1), otherwise the one that is entered.  Two culls that change no
output: a child whose box is inverted (min.x > max.x: the padding
subtrees, whose rows are zero and never hit) counts as a miss, and a
dead ray (t_min >= t_max) walks nothing.  So every output is the one
`_traverse` gives on the same tree, but where XLA's contracted
multiply-adds move a t by an ulp (tests/test_torch_packet.py), and the
kernel, which repeats this walk's arithmetic op for op and follows the
same per-ray order, is bit-equal to it in all six outputs.
"""

from __future__ import annotations

import torch

from mcpt_tpu_torch.ops.dense_sweep import GeomHit, _check
from mcpt_tpu_torch.ops.intersect import intersect_aabb, intersect_triangle, safe_rcp

#: the most rows a leaf may hold and the deepest stack the kernel keeps
#: (depth + 2)
MAX_LEAF = 32
MAX_STACK = 40

#: kernel launches made by `packet_sweep` (CUDA tensors only), and how
#: many of them were in any-hit mode
launches = 0
any_hit_launches = 0


def child_boxes(node_min, node_max):
    """[M // 2, 12] f32: internal node i's children's boxes as one 48-byte
    record, min and max of child 2i+1, then of 2i+2, so that the kernel
    reads them as three 16-byte loads."""
    return torch.cat([node_min[1::2], node_max[1::2], node_min[2::2],
                      node_max[2::2]], dim=1).contiguous()


def packet_sweep_plain(o, d, t_min, t_max, node_min, node_max, tris,
                       any_hit: bool = False, visits: dict | None = None
                       ) -> GeomHit:
    """The per-ray walk in plain PyTorch: an [N, S] stack and an [N]
    pointer; each step pops one node of every ray whose stack is not
    empty (those rays taken by index), until every stack is empty.
    `visits`, if given, receives what the walk needed, for the bound: the
    node visits of each ray ("internal", "leaf": [N] int64), the slab and
    triangle tests ("slab_tests": two an internal visit; "tri_tests": a
    leaf's rows a leaf visit, its opaque rows in any-hit mode: ints) and
    the nodes some ray visited ("nodes": [M] bool)."""
    n, dev = o.shape[0], o.device
    n_leaves, leaf_size = tris.shape[0], tris.shape[1]
    first_leaf = n_leaves - 1
    rcp = safe_rcp(d)
    inverted = node_min[:, 0] > node_max[:, 0]
    t_best = t_max.clone()
    prim = torch.zeros(n, dtype=torch.int32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    w = torch.zeros_like(v)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)
    valid = torch.zeros_like(inside)
    # the root (node 0) in slot 0 of every live ray's stack
    stack = torch.zeros((n, (n_leaves - 1).bit_length() + 2),
                        dtype=torch.int64, device=dev)
    sp = (t_min < t_max).long()
    count = visits is not None
    if count:
        n_int = torch.zeros(n, dtype=torch.int64, device=dev)
        n_leaf = torch.zeros_like(n_int)
        seen = torch.zeros(node_min.shape[0], dtype=torch.bool, device=dev)
        n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        idx = (sp > 0).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        top = sp[idx] - 1
        node = stack[idx, top]
        sp[idx] = top
        at_leaf = node >= first_leaf
        if count:
            n_int[idx] += (~at_leaf).long()
            n_leaf[idx] += at_leaf.long()
            seen[node] = True

        # leaves: each ray tests its leaf's rows against its best t
        lanes, leaf = idx[at_leaf], node[at_leaf] - first_leaf
        if lanes.numel():
            rows = tris[leaf]  # [L, ls, 12]
            hit, t, tv, tw, det_inv = intersect_triangle(
                o[lanes, None], d[lanes, None], rows[..., 0:3],
                rows[..., 3:6], rows[..., 6:9], t_min[lanes, None],
                t_best[lanes, None])
            if any_hit:
                opaque = rows[..., 9] > 0.5
                hit = hit & opaque
                if count:
                    n_tri += opaque.sum()
            elif count:
                n_tri += lanes.numel() * leaf_size
            t = torch.where(hit, t, torch.full_like(t, float("inf")))
            tk, k = t.min(dim=1)  # the first row among equal minima
            take = torch.isfinite(tk) & (tk < t_best[lanes])
            won, k = lanes[take], k[take, None]
            t_best[won] = tk[take]
            prim[won] = (leaf[take] * leaf_size + k[:, 0]).to(torch.int32)
            v[won] = tv[take].gather(1, k)[:, 0]
            w[won] = tw[take].gather(1, k)[:, 0]
            inside[won] = det_inv[take].gather(1, k)[:, 0] < 0.0
            valid[won] = True
            if any_hit:
                sp[won] = 0  # the first hit ends the ray's walk

        # internal nodes: slab-test both children, push far then near
        lanes, node = idx[~at_leaf], node[~at_leaf]
        if lanes.numel():
            c0, c1 = 2 * node + 1, 2 * node + 2
            lo, hi = t_min[lanes], t_best[lanes]
            h0, t0 = intersect_aabb(o[lanes], rcp[lanes], node_min[c0],
                                    node_max[c0], lo, hi)
            h1, t1 = intersect_aabb(o[lanes], rcp[lanes], node_min[c1],
                                    node_max[c1], lo, hi)
            h0 = h0 & ~inverted[c0]
            h1 = h1 & ~inverted[c1]
            both = h0 & h1
            near_is_0 = t0 <= t1
            near = torch.where(near_is_0, c0, c1)
            far = torch.where(near_is_0, c1, c0)
            first = torch.where(both, far, torch.where(h0, c0, c1))
            top = sp[lanes]
            for push, value in ((h0 | h1, first), (both, near)):
                stack[lanes[push], top[push]] = value[push]
                top = top + push.long()
            sp[lanes] = top
    if count:
        visits.update(internal=n_int, leaf=n_leaf,
                      slab_tests=2 * int(n_int.sum()), tri_tests=int(n_tri),
                      nodes=seen)
    return GeomHit(valid=valid, t=t_best, prim=prim, v=v, w=w, inside=inside)


def packet_sweep(o, d, t_min, t_max, node_min, node_max, tris,
                 any_hit: bool = False) -> GeomHit:
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if o.device.type == "cpu":
        return packet_sweep_plain(o, d, t_min, t_max, node_min, node_max,
                                  tris, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"packet_sweep: unsupported device {o.device}")
    n = o.shape[0]
    n_leaves, leaf_size = tris.shape[0], tris.shape[1]
    m = 2 * n_leaves - 1
    dev = o.device
    for name, x, shape in (
        ("o", o, (n, 3)), ("d", d, (n, 3)), ("t_min", t_min, (n,)),
        ("t_max", t_max, (n,)), ("node_min", node_min, (m, 3)),
        ("node_max", node_max, (m, 3)),
        ("tris", tris, (n_leaves, leaf_size, 12)),
    ):
        _check(name, x, shape, torch.float32, dev)
    depth = (n_leaves - 1).bit_length()
    if n_leaves & (n_leaves - 1):
        raise ValueError(f"packet_sweep: {n_leaves} leaves, not a power of 2")
    if not 0 < leaf_size <= MAX_LEAF:
        raise ValueError(f"packet_sweep: leaves of {leaf_size} rows; the "
                         f"kernel takes 1 to {MAX_LEAF}")
    if depth + 2 > MAX_STACK:
        raise ValueError(f"packet_sweep: a BVH of depth {depth} needs a stack "
                         f"deeper than the kernel's {MAX_STACK}")
    if n_leaves * leaf_size >= 2**31 // 12:
        raise ValueError("packet_sweep: the leaves overflow int32 indexing")
    if tris.data_ptr() % 16:
        raise ValueError("packet_sweep: tris must be 16-byte aligned (rows "
                         "are read as float4)")
    boxes = child_boxes(node_min, node_max)

    from mcpt_tpu_torch.build import library

    lib = library()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    w = torch.empty(n, dtype=torch.float32, device=dev)
    inside = torch.empty(n, dtype=torch.bool, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcpt_packet_sweep(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            boxes.data_ptr(), tris.data_ptr(), n, n_leaves, leaf_size,
            int(any_hit), t.data_ptr(), prim.data_ptr(), v.data_ptr(),
            w.data_ptr(), inside.data_ptr(), valid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"packet_sweep kernel launch failed: cudaError {err}")
    global launches, any_hit_launches
    launches += 1
    any_hit_launches += int(any_hit)
    return GeomHit(valid=valid, t=t, prim=prim, v=v, w=w, inside=inside)
