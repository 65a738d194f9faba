"""Analytic quadrics: sphere, disk, finite open cylinder (counterpart of
mcpt_tpu/ops/quadric.py; csrt src/rtcore/primitives/{sphere,disk,
cylinder}.cpp).

A scene holds a handful of quadrics, so every ray is tested against
every row in a loop unrolled over the scene's static `quad_kinds`: each
row's kind is known on the host, and a row costs only its own kind's
arithmetic.  Plain torch: the reference computes this outside any
Pallas kernel.

Conventions (the reference's):
- sphere: radius r at the local origin (the center folded into
  to_world); uv = (phi/2pi, theta/pi), theta = acos(y), phi = atan2(z, x)
  in [0, 2pi);
- disk: radius 0.5 in the local z = 0 plane; uv = (r/0.5, phi/2pi), the
  polar uv of csrt's sampler for hits too (csrt's intersection uv
  degenerates in the plane; the reference's deviation);
- cylinder: radius r, axis z in [0, length]; uv = (phi/2pi, z/length);
- t is measured again in world units, |hit - origin|, since to_world
  may scale;
- `inside`: sphere and cylinder by the sign of the implicit function at
  the origin (c < 0), the disk by the approach side (d_local.z > 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.ops.math import (
    EPSILON_DISTANCE,
    TWO_PI,
    arccos,
    as_lanes,
    atan2,
    cos,
    cross,
    dot,
    mat_vec,
    normalize,
    sin,
    sqrt,
)

KIND_SPHERE = 0
KIND_DISK = 1
KIND_CYLINDER = 2


class QuadricTables(NamedTuple):
    """SoA quadric rows."""

    to_world: torch.Tensor  # [Q, 4, 4]
    to_local: torch.Tensor  # [Q, 4, 4]
    nmat: torch.Tensor      # [Q, 3, 3] inverse transpose of the linear part
    params: torch.Tensor    # [Q, 2] (radius, length), by kind
    inst_id: torch.Tensor   # [Q] int32
    sign: torch.Tensor      # [Q] +1 / -1 (flip_normals)


def empty_quadrics(device) -> QuadricTables:
    return build_quadric_tables([], device)


def build_quadric_tables(rows, device) -> QuadricTables:
    """Host-side table build; `rows`: dicts with kind, to_world (4x4),
    params (2,), inst_id, flip.  No rows: one placeholder row."""
    if rows:
        tw = np.stack([r["to_world"] for r in rows]).astype(np.float32)
        tl = np.stack([np.linalg.inv(r["to_world"])
                       for r in rows]).astype(np.float32)
        nm = np.stack([np.linalg.inv(r["to_world"][:3, :3]).T
                       for r in rows]).astype(np.float32)
        pa = np.stack([np.asarray(r["params"], np.float32) for r in rows])
        ii = np.array([r["inst_id"] for r in rows], np.int32)
        sg = np.array([-1.0 if r.get("flip") else 1.0 for r in rows],
                      np.float32)
    else:
        tw = tl = np.eye(4, dtype=np.float32)[None]
        nm = np.eye(3, dtype=np.float32)[None]
        pa = np.ones((1, 2), np.float32)
        ii = np.zeros(1, np.int32)
        sg = np.ones(1, np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return QuadricTables(to_world=dev(tw), to_local=dev(tl), nmat=dev(nm),
                         params=dev(pa), inst_id=dev(ii), sign=dev(sg))


def _xform_point(m, p):
    """Points p [..., 3] through m [4, 4]; k rows m [k, 4, 4] give
    [k, ..., 3]."""
    t = m[:, None, :3, 3] if m.dim() == 3 else m[:3, 3]
    return mat_vec(m, p) + t


def _xform_dir(m, v):
    """Directions v [..., 3] through m's 3x3 part (rows as _xform_point)."""
    return mat_vec(m, v)


def _solve_quadratic(a, b, c):
    """Stable roots of a t^2 + b t + c (the q form); returns (has_roots,
    t_near, t_far), finite on every lane."""
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (torch.abs(a) > 1e-20)
    sq = sqrt(torch.clamp(disc, min=0.0))
    s = torch.where(b >= 0.0, torch.ones_like(b), -torch.ones_like(b))
    q = -0.5 * (b + s * sq)
    q = torch.where(torch.abs(q) > 1e-30, q, torch.full_like(q, 1e-30))
    t0 = q / torch.where(torch.abs(a) > 1e-30, a, torch.full_like(a, 1e-30))
    t1 = c / q
    return ok, torch.minimum(t0, t1), torch.maximum(t0, t1)


def _row_candidate(kind, to_local, to_world, params, o, d):
    """A ray batch o, d [N, 3] against k quadric rows of one kind, each in
    its local frame (to_local, to_world [k, 4, 4], params [k, 2]).
    Returns (hit, t_world, inside), all [k, N] and finite."""
    ol = _xform_point(to_local, o)
    dl = _xform_dir(to_local, d)
    r = params[:, 0, None]

    if kind == KIND_SPHERE:
        a = dot(dl, dl)
        b = 2.0 * dot(dl, ol)
        c = dot(ol, ol) - r * r
        ok, t_near, t_far = _solve_quadratic(a, b, c)
        ok = ok & (t_far >= EPSILON_DISTANCE)
        t_l = torch.where(t_near < EPSILON_DISTANCE, t_far, t_near)
        inside = c < 0.0
    elif kind == KIND_DISK:
        dz = dl[..., 2]
        dz = torch.where(torch.abs(dz) > 1e-20, dz, torch.full_like(dz, 1e-20))
        t_l = -ol[..., 2] / dz
        pl = ol + t_l[..., None] * dl
        ok = (t_l > EPSILON_DISTANCE) & (dot(pl[..., :2], pl[..., :2]) <= 0.25)
        inside = dl[..., 2] > 0.0
    else:  # KIND_CYLINDER
        length = params[:, 1, None]
        a = dl[..., 0] * dl[..., 0] + dl[..., 1] * dl[..., 1]
        b = 2.0 * (dl[..., 0] * ol[..., 0] + dl[..., 1] * ol[..., 1])
        c = ol[..., 0] * ol[..., 0] + ol[..., 1] * ol[..., 1] - r * r
        ok, t_near, t_far = _solve_quadratic(a, b, c)
        ok = ok & (t_far >= EPSILON_DISTANCE)
        z_near = ol[..., 2] + dl[..., 2] * t_near
        z_far = ol[..., 2] + dl[..., 2] * t_far
        near_ok = ((t_near > EPSILON_DISTANCE) & (z_near >= 0.0)
                   & (z_near <= length))
        far_ok = (z_far >= 0.0) & (z_far <= length)
        t_l = torch.where(near_ok, t_near, t_far)
        ok = ok & (near_ok | far_ok)
        inside = c < 0.0

    t_l = torch.where(ok, t_l, torch.ones_like(t_l))
    pw = _xform_point(to_world, ol + t_l[..., None] * dl)
    t_w = sqrt(torch.clamp(dot(pw - o, pw - o), min=1e-30))
    return ok, t_w, inside


#: (device, rows) -> the rows as an index tensor, made once
_ROW_INDEX: dict = {}


def _row_index(rows, device):
    key = (str(device), tuple(rows))
    if key not in _ROW_INDEX:
        _ROW_INDEX[key] = torch.tensor(rows, dtype=torch.int32,
                                       device=device)
    return _ROW_INDEX[key]


def intersect_quadrics(q: QuadricTables, kinds, o, d, t_min, t_max,
                       any_hit: bool = False):
    """Every ray against every quadric row (`kinds`: (kind, opaque) per
    row).  Any-hit skips rows that are not opaque (null-boundary shells
    never occlude).  The rows of one kind are tested together; the
    nearest hit in [t_min, t_max) wins, the lowest row among equal t —
    the reference's row-by-row sweep.  Returns (t [N] (t_max on a miss),
    idx [N] int32, -1 = miss, inside [N] bool)."""
    n = o.shape[0]
    t_max = as_lanes(t_max, n, o.device)
    t_min = as_lanes(t_min, n, o.device)
    rows = [i for i, (_, opaque) in enumerate(kinds) if opaque or not any_hit]
    if not rows:
        miss = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        return t_max, miss, miss >= 0
    order, parts = [], []
    for kind in sorted({kinds[i][0] for i in rows}):
        sel = [i for i in rows if kinds[i][0] == kind]
        ix = _row_index(sel, o.device)
        parts.append(_row_candidate(kind, q.to_local[ix], q.to_world[ix],
                                    q.params[ix], o, d))
        order += sel
    hit, t_w, inside = (torch.cat(x) for x in zip(*parts))
    take = hit & (t_w >= t_min) & (t_w < t_max)
    cand = torch.where(take, t_w, torch.full_like(t_w, float("inf")))
    best = cand.amin(dim=0)
    found = take.any(dim=0)
    # the lowest row id among the rows at the best t (ids are unique, so
    # the position of the minimum is that row's)
    row_ids = _row_index(order, o.device)[:, None]
    key = torch.where(take & (cand == best), row_ids,
                      torch.full_like(row_ids, len(kinds)))
    first, pos = key.min(dim=0)
    return (torch.where(found, best, t_max),
            torch.where(found, first, torch.full_like(first, -1)),
            found & inside.gather(0, pos[None])[0])


def _wrap_phi(y, x):
    phi = atan2(y, x)
    return torch.where(phi < 0.0, phi + TWO_PI, phi)


def quadric_attrs(q: QuadricTables, kinds, idx, pos_w):
    """Shading attributes of the lanes whose hit is a quadric: each row's
    (static loop), selected by `idx`; the local hit point is to_local of
    the world position.  Returns the outward (normal, tangent, bitangent,
    uv, inst); the caller applies bump and the inside flip."""
    n_l = pos_w.shape[0]
    f32 = dict(dtype=torch.float32, device=pos_w.device)
    normal = torch.zeros((n_l, 3), **f32)
    normal[:, 2].fill_(1.0)
    tangent = torch.zeros((n_l, 3), **f32)
    tangent[:, 0].fill_(1.0)
    bitang = torch.zeros((n_l, 3), **f32)
    bitang[:, 1].fill_(1.0)
    uv = torch.zeros((n_l, 2), **f32)
    inst = torch.zeros(n_l, dtype=torch.int32, device=pos_w.device)

    for i, (kind, _opaque) in enumerate(kinds):
        sel = idx == i
        pl = _xform_point(q.to_local[i], pos_w)
        r = q.params[i, 0]
        if kind == KIND_SPHERE:
            nl = normalize(pl)
            theta = arccos(torch.clamp(nl[..., 1], -1.0, 1.0))
            phi = _wrap_phi(nl[..., 2], nl[..., 0])
            uv_i = torch.stack([phi / TWO_PI, theta / np.pi], -1)
            # dP/dtheta of P = r (sin t cos p, cos t, sin t sin p)
            sin_t, cos_t = sin(theta), cos(theta)
            cos_p, sin_p = cos(phi), sin(phi)
            bit_l = torch.stack([cos_t * cos_p, -sin_t, cos_t * sin_p], -1)
            n_w = normalize(mat_vec(q.nmat[i], nl))
            b_w = normalize(_xform_dir(q.to_world[i], bit_l))
        elif kind == KIND_DISK:
            rad = sqrt(torch.clamp(dot(pl[..., :2], pl[..., :2]),
                                         min=1e-30))
            phi = _wrap_phi(pl[..., 1], pl[..., 0])
            uv_i = torch.stack([rad / 0.5, phi / TWO_PI], -1)
            # u = r: the tangent is radial, the bitangent azimuthal
            tan_l = torch.stack(
                [pl[..., 0], pl[..., 1], torch.zeros_like(rad)], -1
            ) / rad[..., None]
            n_w = normalize(q.nmat[i][:, 2]).expand(pl.shape)
            b_w = normalize(cross(n_w, _xform_dir(q.to_world[i], tan_l)))
        else:  # KIND_CYLINDER
            length = q.params[i, 1]
            phi = _wrap_phi(pl[..., 1], pl[..., 0])
            uv_i = torch.stack([phi / TWO_PI, pl[..., 2] / length], -1)
            nl = torch.stack([pl[..., 0], pl[..., 1], torch.zeros_like(phi)],
                             -1) / torch.clamp(r, min=1e-12)
            n_w = normalize(mat_vec(q.nmat[i], nl))
            # the tangent runs along the axis (cylinder.cpp:67-69)
            axis_w = normalize(q.nmat[i][:, 2]).expand(pl.shape)
            b_w = normalize(cross(n_w, axis_w))

        n_w = n_w * q.sign[i]
        t_w = normalize(cross(b_w, n_w))
        b_w = normalize(cross(n_w, t_w))

        m = sel[..., None]
        normal = torch.where(m, n_w, normal)
        tangent = torch.where(m, t_w, tangent)
        bitang = torch.where(m, b_w, bitang)
        uv = torch.where(m, uv_i, uv)
        inst = torch.where(sel, q.inst_id[i], inst)
    return normal, tangent, bitang, uv, inst


def sample_quadric_row(q: QuadricTables, i: int, kind: int, xi0, xi1):
    """A uniform (local-frame) surface sample of emissive quadric row i
    (SampleSphere sphere.cpp:90-106, SampleDisk disk.cpp:112-142,
    SampleCylinder cylinder.cpp:92-105; the disk by the reference's polar
    sqrt warp).  Returns (position [N,3], normal [N,3], uv [N,2])."""
    r = q.params[i, 0]
    if kind == KIND_SPHERE:
        cos_t = 1.0 - 2.0 * xi0
        sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = TWO_PI * xi1
        nl = torch.stack([sin_t * cos(phi), cos_t,
                          sin_t * sin(phi)], -1)
        pl = r * nl
        uv = torch.stack(
            [xi1, arccos(torch.clamp(cos_t, -1, 1)) / np.pi], -1)
    elif kind == KIND_DISK:
        rr = sqrt(torch.clamp(xi0, min=0.0))
        phi = TWO_PI * xi1
        pl = torch.stack([0.5 * rr * cos(phi), 0.5 * rr * sin(phi),
                          torch.zeros_like(rr)], -1)
        uv = torch.stack([rr, xi1], -1)
        # the disk's normal is constant: its frame transform once
        pos = _xform_point(q.to_world[i], pl)
        nrm = (normalize(q.nmat[i][:, 2]) * q.sign[i]).expand(pl.shape)
        return pos, nrm, uv
    else:  # KIND_CYLINDER
        length = q.params[i, 1]
        phi = TWO_PI * xi0
        z = xi1 * length
        nl = torch.stack(
            [cos(phi), sin(phi), torch.zeros_like(phi)], -1)
        pl = torch.stack([r * nl[..., 0], r * nl[..., 1], z], -1)
        uv = torch.stack([xi0, xi1], -1)

    pos = _xform_point(q.to_world[i], pl)
    nrm = normalize(mat_vec(q.nmat[i], nl)) * q.sign[i]
    return pos, nrm, uv
