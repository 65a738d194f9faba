"""Kernel K5: the packet BVH walk, and its plain version.

K5 replaces no Pallas kernel.  It is the reference's XLA traversal
mcpt_tpu/ops/traversal.py::_intersect_packet (:454-623, PACKET_BLOCK at
:356), written by hand because eager torch cannot run that loop at full
width: one node visit is ~60 launches and a host test of the stack, a
packet visits thousands of nodes, and a frame traces hundreds of times.
The kernel is CUDA C++ (csrc/packet_sweep.cu); `packet_sweep` launches it
for CUDA tensors and runs `packet_sweep_plain` for CPU tensors.  It never
falls back from one to the other.

Contract: rays o, d [N,3] f32, t_min, t_max [N] f32, in the caller's
order (the traversal sorts them by coherence keys first); the BVH's node
boxes node_min, node_max [M,3] f32 (scene/bvh.py: node i's children are
2i+1 and 2i+2, the leaves start at n_pad_leaves - 1); the leaves' rows
tris [n_pad_leaves, leaf_size, 12] f32 (p0.xyz, e1.xyz, e2.xyz, opaque,
..), the packed triangle table viewed by leaf.  Returns a GeomHit whose
prim indexes the packed table.

The walk (the reference's): the rays go in packets of PACKET_BLOCK, each
with one stack of node ids shared by its lanes, starting at the root.  At
a leaf every lane of the packet tests the leaf's rows against its best t
(the lowest row wins among equal t; a hit must beat the best t strictly;
any-hit keeps opaque rows only).  At an internal node every live lane
(t_min < best t, and in any-hit mode no hit yet) slab-tests both
children against [t_min, best t]; a child that some lane enters is
pushed, and where both are, the far one first, so that the near one —
the smaller mean entry distance over the lanes that enter it — is
visited next.  The mean's sum over the packet's lanes is taken in one
fixed order, a halving tree within each warp of 32 lanes and then across
the 32 warps (`_tree_sum`), which the kernel repeats with warp shuffles:
so the kernel visits the nodes the plain version visits, in its order,
and every output is bit-equal.  Against the reference, whose XLA sum has
another order, a near/far swap changes only the visit order: closest-hit
t is the same, prim may differ on exact-t ties, and any-hit t (the first
hits found, refined by later leaves) may differ where valid does not.
"""

from __future__ import annotations

import torch

from mcpt_tpu_torch.ops.dense_sweep import GeomHit, _check
from mcpt_tpu_torch.ops.intersect import intersect_aabb, intersect_triangle, safe_rcp

#: rays a packet (a CUDA block of as many threads), as the reference's
#: PACKET_BLOCK
PACKET_BLOCK = 1024

#: the most rows a leaf may hold (the kernel stages a leaf's rows in
#: shared memory) and the deepest stack the kernel keeps (depth + 2)
MAX_LEAF = 32
MAX_STACK = 40

#: kernel launches made by `packet_sweep` (CUDA tensors only), and how
#: many of them were in any-hit mode
launches = 0
any_hit_launches = 0


#: walk steps a CUDA graph of the plain version holds (packet_sweep_plain)
GRAPH_STEPS = 32


def _tree_sum(x):
    """Sum over the last dimension of PACKET_BLOCK values in the kernel's
    order: [..., 1024] -> [...], a halving tree over each warp's 32 lanes
    (lane i adds lane i + 16, then i + 8, ...), then the same tree over the
    32 warp sums."""
    x = x.reshape(*x.shape[:-1], 32, 32)
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    x = x[..., 0]
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


class _Walk:
    """The state of every packet's walk, [G, ...] tensors updated in place
    by `step`, which advances every packet whose stack is not empty by one
    node visit and leaves the others as they are: a step has no host sync
    and fixed shapes, so that a run of steps can be replayed as a CUDA
    graph."""

    def __init__(self, o, d, t_min, t_max, node_min, node_max, tris,
                 any_hit, count):
        n = o.shape[0]
        dev = o.device
        b = PACKET_BLOCK
        self.g = g = max(1, -(-n // b))
        pad = g * b - n

        def padded(x, cols=None):
            shape = (pad,) if cols is None else (pad, cols)
            x = torch.cat([x, x.new_zeros(shape)]) if pad else x
            return x.reshape((g, b) if cols is None else (g, b, cols))

        # padding lanes are dead: t_min = t_max = 0 and d = 0 (never a hit)
        self.o, self.d = padded(o, 3), padded(d, 3)
        self.tmin, self.t_best = padded(t_min), padded(t_max).clone()
        self.rcp = safe_rcp(self.d)
        self.node_min, self.node_max, self.tris = node_min, node_max, tris
        self.any_hit, self.count = any_hit, count
        self.n_leaves, self.leaf_size = tris.shape[0], tris.shape[1]
        self.s = (self.n_leaves - 1).bit_length() + 2
        self.prim = torch.zeros((g, b), dtype=torch.int32, device=dev)
        self.v = torch.zeros((g, b), dtype=torch.float32, device=dev)
        self.w = torch.zeros_like(self.v)
        self.inside = torch.zeros((g, b), dtype=torch.bool, device=dev)
        self.valid = torch.zeros_like(self.inside)
        self.stack = torch.zeros((g, self.s), dtype=torch.int64, device=dev)
        self.sp = torch.ones(g, dtype=torch.int64, device=dev)
        zeros = dict(dtype=torch.int64, device=dev)
        self.n_int = torch.zeros(g, **zeros)
        self.n_leaf = torch.zeros(g, **zeros)
        self.seen = torch.zeros(node_min.shape[0], **zeros)
        self.n_slab = torch.zeros((), **zeros)
        self.n_tri = torch.zeros((), **zeros)
        self.n = n

    def step(self):
        first_leaf = self.n_leaves - 1
        act = self.sp > 0
        node = self.stack.gather(1, (self.sp - 1).clamp(min=0)[:, None])[:, 0]
        sp = self.sp - act.long()
        is_leaf = act & (node >= first_leaf)
        is_int = act & (node < first_leaf)
        if self.count:
            self.n_int.add_(is_int.long())
            self.n_leaf.add_(is_leaf.long())
            self.seen.index_add_(0, node, act.long())
        # on the CPU a host test skips the half of the step no packet
        # needs; on the card the step stays free of syncs, for the graph
        cpu = self.o.device.type == "cpu"
        if not cpu or bool(is_leaf.any()):
            self._leaf(node, is_leaf)
        if not cpu or bool(is_int.any()):
            sp = self._internal(node, is_int, sp)
        self.sp.copy_(sp)

    def _leaf(self, node, is_leaf):
        """Every lane of a packet at a leaf tests its rows against its
        best t."""
        first_leaf = self.n_leaves - 1
        leaf = (node - first_leaf).clamp(0, self.n_leaves - 1)
        rows = self.tris[leaf][:, None]  # [G, 1, ls, 12]
        hit, t, v, w, det_inv = intersect_triangle(
            self.o[:, :, None], self.d[:, :, None], rows[..., 0:3],
            rows[..., 3:6], rows[..., 6:9], self.tmin[:, :, None],
            self.t_best[:, :, None])
        opaque = rows[..., 9] > 0.5
        if self.any_hit:
            hit = hit & opaque
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        tk, k = t.min(dim=2)  # first index among equal minima
        take = torch.isfinite(tk) & (tk < self.t_best) & is_leaf[:, None]
        if self.count:
            live = (self.tmin < self.t_best) & is_leaf[:, None]
            n_rows = torch.full_like(leaf, self.leaf_size)
            if self.any_hit:
                live = live & ~self.valid
                n_rows = opaque[:, 0].sum(dim=1)
            self.n_tri.add_((live.sum(dim=1) * n_rows).sum())

        def at_k(x):
            return x.gather(2, k[..., None])[..., 0]

        self.t_best.copy_(torch.where(take, tk, self.t_best))
        self.prim.copy_(torch.where(
            take, (leaf[:, None] * self.leaf_size + k).to(torch.int32),
            self.prim))
        self.v.copy_(torch.where(take, at_k(v), self.v))
        self.w.copy_(torch.where(take, at_k(w), self.w))
        self.inside.copy_(torch.where(take, at_k(det_inv) < 0.0, self.inside))
        self.valid.copy_(self.valid | take)

    def _internal(self, node, is_int, sp):
        """A packet at an internal node slab-tests both children and
        pushes them as the reference does; returns the stack pointers."""
        m = self.node_min.shape[0]
        c0 = (2 * node + 1).clamp(max=m - 1)
        c1 = (2 * node + 2).clamp(max=m - 1)
        live = (self.tmin < self.t_best) & is_int[:, None]
        if self.any_hit:
            live = live & ~self.valid
        kids = torch.stack([c0, c1], dim=1)  # [G, 2]
        h, te = intersect_aabb(
            self.o[:, None], self.rcp[:, None], self.node_min[kids][:, :, None],
            self.node_max[kids][:, :, None], self.tmin[:, None],
            self.t_best[:, None])  # [G, 2, 1024]
        h = h & live[:, None]
        cnt = h.sum(dim=2)
        mean = (_tree_sum(torch.where(h, te, torch.zeros_like(te)))
                / torch.clamp(cnt.to(torch.float32), min=1.0))
        any0, any1 = cnt[:, 0] > 0, cnt[:, 1] > 0
        near_is_0 = mean[:, 0] <= mean[:, 1]
        near = torch.where(near_is_0, c0, c1)
        far = torch.where(near_is_0, c1, c0)
        any_near = torch.where(near_is_0, any0, any1)
        any_far = torch.where(near_is_0, any1, any0)
        push1 = is_int & (any0 | any1)
        push2 = is_int & any_near & any_far
        first = torch.where(push2, far, torch.where(any_near, near, far))
        for push, value in ((push1, first), (push2, near)):
            i = sp.clamp(max=self.s - 1)[:, None]
            self.stack.scatter_(1, i, torch.where(
                push, value, self.stack.gather(1, i)[:, 0])[:, None])
            sp = sp + push.long()
        if self.count:
            self.n_slab.add_(2 * live.sum())
        return sp

    def run(self):
        """Step until every stack is empty: on the card, GRAPH_STEPS steps
        at a time as one CUDA graph (a step that finds an empty stack
        changes nothing), since a step is ~100 small launches."""
        if self.o.device.type != "cuda":
            while bool((self.sp > 0).any()):
                self.step()
            return
        with torch.cuda.device(self.o.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):  # warm-up before the capture: real steps
                    self.step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(GRAPH_STEPS):
                    self.step()
            while bool((self.sp > 0).any()):
                graph.replay()

    def hit(self) -> GeomHit:
        def out(x):
            return x.reshape(-1)[:self.n]

        return GeomHit(valid=out(self.valid), t=out(self.t_best),
                       prim=out(self.prim), v=out(self.v), w=out(self.w),
                       inside=out(self.inside))


def packet_sweep_plain(o, d, t_min, t_max, node_min, node_max, tris,
                       any_hit: bool = False, visits: dict | None = None
                       ) -> GeomHit:
    """The packet walk in plain PyTorch: every packet takes one step of
    its own walk per step of the loop (a [G, S] stack, one [G] pointer),
    which equals running the packets one after another, since they share
    nothing.  `visits`, if given, receives what the walk needed, for the
    bound: the node visits of each packet ("internal", "leaf": [G] int64),
    the slab tests and triangle tests of live lanes ("slab_tests",
    "tri_tests": ints; any-hit tests opaque rows only) and the nodes some
    packet visited ("nodes": [M] bool)."""
    walk = _Walk(o, d, t_min, t_max, node_min, node_max, tris, any_hit,
                 visits is not None)
    walk.run()
    if visits is not None:
        visits.update(internal=walk.n_int, leaf=walk.n_leaf,
                      slab_tests=int(walk.n_slab), tri_tests=int(walk.n_tri),
                      nodes=walk.seen > 0)
    return walk.hit()


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
            node_min.data_ptr(), node_max.data_ptr(), tris.data_ptr(), n,
            n_leaves, leaf_size, int(any_hit), t.data_ptr(), prim.data_ptr(),
            v.data_ptr(), w.data_ptr(), inside.data_ptr(), valid.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"packet_sweep kernel launch failed: cudaError {err}")
    global launches, any_hit_launches
    launches += 1
    any_hit_launches += int(any_hit)
    return GeomHit(valid=valid, t=t, prim=prim, v=v, w=w, inside=inside)
