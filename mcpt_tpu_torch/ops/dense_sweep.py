"""Kernel K1: the dense ray x triangle sweep, and its plain version.

The counterpart of the Pallas kernel mcpt_tpu/ops/pallas_dense.py
(`_sweep_kernel`, `dense_sweep`) and of its XLA oracle
mcpt_tpu/ops/traversal.py::_intersect_dense.  The kernel is CUDA C++
(csrc/dense_sweep.cu); `dense_sweep` launches it for CUDA tensors and
runs `dense_sweep_plain` for CPU tensors.  It never falls back from one
to the other.

Contract: rays o, d [N,3] f32, t_min, t_max [N] f32; the packed triangle
table [P,12] f32 (p0.xyz, e1.xyz, e2.xyz, opaque, pad, pad).  Returns a
GeomHit: the nearest hit in [t_min, t_max) — in any-hit mode the nearest
opaque one — with the lowest index winning among equal t.

`DenseClosestHit` gives the closest hit a gradient, as the reference's
dense route has one (its XLA scan is differentiated, traversal.py:157):
t, v and w are the Möller–Trumbore values of each ray's winning
triangle, so their gradient reaches the ray's o and d through that
triangle alone; a miss's t is t_max, and its gradient goes to t_max.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcpt_tpu_torch.ops.intersect import intersect_triangle

#: triangles per step of the plain version (as traversal._DENSE_CHUNK)
PLAIN_CHUNK = 512

#: the kernel's shapes on the card: (slices per ray, rays per thread).  The
#: C ABI takes one as an int, 10 * slices + rays; chip_smoke.py checks and
#: times each on 65536 rays at 64 to 16384 triangles (PERF.md)
SHAPES = tuple((s, p) for s in (1, 2, 4, 8) for p in (1, 2))


def shape_for(p: int) -> tuple[int, int]:
    """The kernel shape for a table of p triangles, as chip_smoke's sweep
    measured it on the card (H100): 8 slices x 2 rays a thread from 256
    triangles up (fastest at 1024-16384, within 2% of the fastest at 256),
    2 slices x 1 ray below (within 1% of the fastest at 64 and 128)."""
    return (8, 2) if p >= 256 else (2, 1)


#: kernel launches made by `dense_sweep` (CUDA tensors only), and how
#: many of them were in any-hit mode
launches = 0
any_hit_launches = 0


class GeomHit(NamedTuple):
    """Raw geometric hit record (mcpt_tpu/ops/traversal.py:25)."""

    valid: torch.Tensor   # [N] bool
    t: torch.Tensor       # [N] f32
    prim: torch.Tensor    # [N] int32 index into the sorted/padded prims
    v: torch.Tensor       # [N] barycentric weight of vertex 1
    w: torch.Tensor       # [N] barycentric weight of vertex 2
    inside: torch.Tensor  # [N] bool — back-face hit (det < 0)


def dense_sweep_plain(o, d, t_min, t_max, tris, any_hit: bool = False) -> GeomHit:
    """Plain PyTorch sweep: [N, PLAIN_CHUNK] Möller–Trumbore per triangle chunk,
    min-reduced per ray (the arithmetic of intersect_triangle, which the
    CUDA kernel repeats op for op)."""
    n = o.shape[0]
    p = tris.shape[0]
    t_best = t_max.clone()
    prim_best = torch.zeros(n, dtype=torch.int32, device=o.device)
    v_best = torch.zeros(n, dtype=torch.float32, device=o.device)
    w_best = torch.zeros_like(v_best)
    in_best = torch.zeros(n, dtype=torch.bool, device=o.device)
    valid = torch.zeros_like(in_best)
    o_, d_, lo = o[:, None, :], d[:, None, :], t_min[:, None]
    rows = torch.arange(n, device=o.device)
    for start in range(0, p, PLAIN_CHUNK):
        c = tris[start:start + PLAIN_CHUNK]
        hit, t, v, w, det_inv = intersect_triangle(
            o_, d_, c[None, :, 0:3], c[None, :, 3:6], c[None, :, 6:9],
            lo, t_best[:, None],
        )
        if any_hit:
            hit = hit & (c[None, :, 9] > 0.5)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        tk, k = t.min(dim=1)  # first index among equal minima
        take = torch.isfinite(tk) & (tk < t_best)
        t_best = torch.where(take, tk, t_best)
        prim_best = torch.where(take, (start + k).to(torch.int32), prim_best)
        v_best = torch.where(take, v[rows, k], v_best)
        w_best = torch.where(take, w[rows, k], w_best)
        in_best = torch.where(take, det_inv[rows, k] < 0.0, in_best)
        valid = valid | take
    return GeomHit(valid=valid, t=t_best, prim=prim_best, v=v_best,
                   w=w_best, inside=in_best)


class DenseClosestHit(torch.autograd.Function):
    """The dense closest hit with a backward.  Forward: K1 on CUDA
    tensors, dense_sweep_plain on CPU tensors, with no graph.  Backward:
    intersect_triangle again at each ray's winning row, N rays against
    one triangle each in plain torch, and its gradient into o and d;
    a miss's grad_t goes to t_max.  apply(o, d, t_min, t_max, tris)
    returns the GeomHit fields in order; valid, prim and inside carry no
    gradient."""

    @staticmethod
    def forward(ctx, o, d, t_min, t_max, tris):
        hit = dense_sweep(o, d, t_min, t_max, tris)
        ctx.save_for_backward(o, d, t_min, tris, hit.prim, hit.valid)
        ctx.mark_non_differentiable(hit.valid, hit.prim, hit.inside)
        return tuple(hit)

    @staticmethod
    def backward(ctx, _valid, g_t, _prim, g_v, g_w, _inside):
        o, d, t_min, tris, prim, valid = ctx.saved_tensors
        g_o = g_d = g_tmax = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            rows = tris[prim.long()]
            with torch.enable_grad():
                o_ = o.detach().requires_grad_()
                d_ = d.detach().requires_grad_()
                _, t, v, w, _ = intersect_triangle(
                    o_, d_, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], t_min,
                    torch.full_like(t_min, float("inf")))
                g_o, g_d = torch.autograd.grad((t, v, w), (o_, d_),
                                               (g_t, g_v, g_w))
            # a miss's row is arbitrary: its lanes take no gradient
            g_o = torch.where(valid[:, None], g_o, torch.zeros_like(g_o))
            g_d = torch.where(valid[:, None], g_d, torch.zeros_like(g_d))
        if ctx.needs_input_grad[3]:
            g_tmax = torch.where(valid, torch.zeros_like(g_t), g_t)
        return g_o, g_d, None, g_tmax, None


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def dense_sweep(o, d, t_min, t_max, tris, any_hit: bool = False,
                shape: tuple[int, int] | None = None) -> GeomHit:
    """K1 on CUDA tensors, its plain version on CPU tensors.  `shape`
    (slices, rays per thread; one of SHAPES, by default shape_for(P))
    changes no output."""
    if o.device.type == "cpu":
        return dense_sweep_plain(o, d, t_min, t_max, tris, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"dense_sweep: unsupported device {o.device}")
    n, p = o.shape[0], tris.shape[0]
    dev = o.device
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("t_min", t_min, (n,), torch.float32, dev)
    _check("t_max", t_max, (n,), torch.float32, dev)
    _check("tris", tris, (p, 12), torch.float32, dev)
    if p >= 2**31 // 12:
        raise ValueError(f"dense_sweep: {p} triangles overflow int32 indexing")
    if tris.data_ptr() % 16:
        raise ValueError("dense_sweep: tris must be 16-byte aligned (rows are "
                         "read as float4)")
    shape = shape or shape_for(p)
    if shape not in SHAPES:
        raise ValueError(f"dense_sweep: shape {shape} not in {SHAPES}")

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
        err = lib.mcpt_dense_sweep(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            tris.data_ptr(), n, p, int(any_hit), 10 * shape[0] + shape[1],
            t.data_ptr(), prim.data_ptr(), v.data_ptr(), w.data_ptr(),
            inside.data_ptr(), valid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_sweep kernel launch failed: cudaError {err}")
    global launches, any_hit_launches
    launches += 1
    any_hit_launches += int(any_hit)
    return GeomHit(valid=valid, t=t, prim=prim, v=v, w=w, inside=inside)
