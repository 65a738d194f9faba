"""A plain path tracer of the benchmark's scenes, for the correctness check.

It renders a `portbench.scene.Scene` with the estimator the scene file
states, as the upstream renderer defines it, with random numbers of its
own (a torch.Generator), so that its pixels are independent estimates
of what the program's pixels estimate:

* camera: the pinhole map x = 2(i + u)/W - 1, y = 1 - 2(j + v)/H on
  tan(fov_x / 2) and tan(fov_x H / W / 2), at the sample positions the
  renderer states for a call of k samples a pixel at frame_base b:
  sample s at u = s / k, v = VdC2(b + s + 1).  The caller gives the
  frame bases, one group of k samples each;
* vertices 1 .. max_depth: an escaping ray takes the sky's radiance, an
  emitter's front face its radiance, each MIS-weighted (power heuristic)
  against the light's sampling pdf after the first segment; a back face
  or an emitter ends the path; from vertex rr_depth on, Russian roulette
  keeps a path with probability 0.95; NEE samples one point on the area
  lights (by area), the sun and a uniform direction of the sky, each
  against its own shadow ray; the BSDF is sampled for the next segment,
  and a path whose throughput falls under 0.01 (largest channel) ends;
* BSDFs, all one-sided: Lambert (albedo or checkerboard), cosine
  sampled; the rough conductor: GGX with the upstream's D cos(theta_h),
  height-uncorrelated Smith G, Schlick's Fresnel from eta and k, and the
  Kulla-Conty term from its own directional-albedo table, sampled by
  D cos(theta_h).  Samples and evaluations under the upstream's cutoffs
  (pdf >= 0.01, cosines >= 0.01 for Lambert's evaluation).

Every float tensor is of `dtype`; the benchmark's control runs it in
bfloat16.  It imports nothing of the renderer it checks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.bvh import T_MIN, Bvh

EPS = 0.01                   # pdf and throughput cutoff
EPS_F = 1.1920929e-7         # FLT_EPSILON
RR_PDF = 0.95
FAR = 1e30
KC_RES = 128
KC_SAMPLES = 1024
DIFFUSE, CONDUCTOR, EMITTER = 0, 1, 2


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    return v / torch.sqrt(torch.clamp(_dot(v, v), min=1e-30))[..., None]


def _safe(x, eps=1e-12):
    small = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(x.abs() < eps, small, x)


def _mis(a, b):
    m = torch.clamp(torch.maximum(a, b), min=1e-15)
    a, b = (a / m) ** 2, (b / m) ** 2
    return a / torch.clamp(a + b, min=1e-30)


def _frame(n):
    """An orthonormal (t, b) around unit normals n (Duff et al. 2017)."""
    sign = torch.where(n[:, 2] >= 0, torch.ones_like(n[:, 2]),
                       -torch.ones_like(n[:, 2]))
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], -1)
    bt = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return t, bt


def _to_world(v, n):
    t, b = _frame(n)
    return v[:, 0:1] * t + v[:, 1:2] * b + v[:, 2:3] * n


def _vdc2(i: np.ndarray) -> np.ndarray:
    """Van der Corput radical inverse in base 2 of uint32 `i`."""
    i = i.astype(np.uint64)
    r = np.zeros_like(i)
    for bit in range(32):
        r |= ((i >> np.uint64(bit)) & np.uint64(1)) << np.uint64(31 - bit)
    return r.astype(np.float64) / 2.0 ** 32


def kulla_conty_tables():
    """(E [alpha, mu], E_avg [alpha]) of GGX on the upstream's 128 x 128
    grid (texel centres), by its quadrature of 1024 nodes (xi0 = i/S,
    xi1 = VdC2(i)) and its definitions: E = mean of (h.v) G / (mu n.h)
    clamped at 1, E_avg = mean over mu of 2 E mean(n.l).  float64."""
    r = (np.arange(KC_RES) + 0.5) / KC_RES
    mu = (np.arange(KC_RES) + 0.5) / KC_RES
    i = np.arange(KC_SAMPLES)
    x0 = np.minimum(i / KC_SAMPLES, 1 - 1e-6)
    x1 = _vdc2(i)
    a2 = r[:, None] ** 2                                  # [R, 1]
    tan2 = a2 * x0 / (1 - x0)                             # [R, S]
    ct = 1 / np.sqrt(1 + tan2)
    st = np.sqrt(np.maximum(1 - ct ** 2, 0))
    ph = 2 * np.pi * x1
    h = np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1)[:, None]  # [R,1,S,3]
    sv = np.sqrt(1 - mu ** 2)
    v = np.stack([sv, np.zeros_like(mu), mu], -1)[None, :, None]     # [1,C,1,3]
    hv = (h * v).sum(-1)
    l = 2 * hv[..., None] * h - v
    l = l / np.linalg.norm(l, axis=-1, keepdims=True)

    def g1(w):
        t2 = a2[:, :, None] * (1 - w[..., 2] ** 2) / np.maximum(w[..., 2] ** 2, 1e-20)
        g = 2 / (1 + np.sqrt(1 + t2))
        return np.where(w[..., 2] * h[..., 2] > 0, g, 0.0)
    g = g1(np.broadcast_to(v, l.shape)) * g1(l)
    ok = (l[..., 2] > 0) & (h[..., 2] > 0) & (hv > 0)
    c = np.where(ok, hv * g / np.maximum(mu[None, :, None] * h[..., 2], 1e-8), 0)
    e = np.minimum(c.mean(-1), 1.0)                       # [R, C]
    e_avg = (np.where(ok, e[..., None] * l[..., 2], 0).mean(-1) * 2).mean(-1)
    return e, e_avg


def _lookup(x, res):
    x = torch.clamp(x * res, 0.0, res - 1.0)
    i0 = torch.floor(x)
    t = x - i0
    i0 = i0.long().clamp(0, res - 1)
    return i0, torch.clamp(i0 + 1, max=res - 1), t


class Reference:
    """A scene on `device`, its floats in `dtype`."""

    def __init__(self, scene, device="cpu", dtype=torch.float32):
        self.scene = scene
        self.device = torch.device(device)
        self.dtype = dtype
        names = list(scene.materials)
        pos, nrm, uv, mat = [], [], [], []
        for m in scene.meshes:
            pos.append(m.positions[m.faces])
            nrm.append(m.normals[m.faces])
            uv.append(m.uvs[m.faces])
            mat.append(np.full(len(m.faces), names.index(m.material)))
        pos, nrm, uv = (np.concatenate(a) for a in (pos, nrm, uv))
        mat = np.concatenate(mat)
        self.bvh = Bvh(pos[:, 0], pos[:, 1], pos[:, 2], self.device, dtype)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(dtype)
        self.nrm = t(nrm)
        self.uv = t(uv)
        self.mat = torch.as_tensor(mat, device=self.device)
        # material table
        kind, alb, chk, c0, c1, sc, alpha, f0, favg, rad = ([] for _ in range(10))
        for name in names:
            m = scene.materials[name]
            kind.append({"diffuse": DIFFUSE, "roughconductor": CONDUCTOR,
                         "emitter": EMITTER}[m.kind])
            alb.append(m.albedo)
            chk.append(m.checker is not None)
            c0.append(m.checker[0] if m.checker else m.albedo)
            c1.append(m.checker[1] if m.checker else m.albedo)
            sc.append(m.checker[2] if m.checker else 1.0)
            alpha.append(m.alpha)
            eta = np.asarray(m.eta, np.float64)
            k = np.asarray(m.k, np.float64)
            r = ((eta - 1) ** 2 + k ** 2) / ((eta + 1) ** 2 + k ** 2)
            t1, t2 = 1 + np.sqrt(r), 1 - np.sqrt(r)
            g = (t1 - eta * t2) / (t1 - (1 - r) / (1 + r) * t2)
            r, g = r.astype(np.float32), g.astype(np.float32)
            favg.append(0.087237 + 0.0230685 * g - 0.0864902 * g ** 2
                        + 0.0774594 * g ** 3 + 0.782654 * r - 0.136432 * r ** 2
                        + 0.278708 * r ** 3 + 0.19744 * g * r
                        + 0.0360605 * g ** 2 * r - 0.2586 * g * r ** 2)
            f0.append(r)
            rad.append(m.radiance)
        self.m_kind = torch.as_tensor(kind, device=self.device)
        self.m_checker = torch.as_tensor(chk, device=self.device)
        self.m_c0, self.m_c1 = t(c0), t(c1)
        self.m_scale, self.m_alpha = t(sc), t(alpha)
        self.m_f0, self.m_favg, self.m_rad = t(f0), t(favg), t(rad)
        e, e_avg = kulla_conty_tables()
        self.kc_e, self.kc_eavg = t(e), t(e_avg)
        # area lights: the emitters' triangles, chosen by area
        em = np.nonzero(np.asarray(kind)[mat] == EMITTER)[0]
        p = pos[em].astype(np.float64)
        area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1)
        self.n_lights = len(em)
        if len(em):
            self.l_tri = torch.as_tensor(em, device=self.device)
            self.l_cdf = torch.as_tensor(np.cumsum(area) / area.sum(), device=self.device)
            self.l_pdf_area = float(1.0 / area.sum())
        self.sky = None if scene.sky is None else t(scene.sky)
        if scene.sun is not None:
            self.sun_wi = -t(scene.sun[0])            # toward the sun
            self.sun_rad = t(np.asarray(scene.sun[1], np.float32) / np.float32(np.pi))
        else:
            self.sun_wi = None
        # camera
        o = np.asarray(scene.origin, np.float64)
        front = np.asarray(scene.target, np.float64) - o
        front /= np.linalg.norm(front)
        right = np.cross(front, np.asarray(scene.up, np.float64))
        right /= np.linalg.norm(right)
        up = np.cross(right, front)
        fov_y = scene.fov_x * scene.height / scene.width
        self.eye = t(o)
        self.front = t(front)
        self.dx = t(right * math.tan(math.radians(0.5 * scene.fov_x)))
        self.dy = t(up * math.tan(math.radians(0.5 * fov_y)))

    # -- pieces -----------------------------------------------------------

    def _rand(self, gen, n, k=1):
        r = torch.rand((n, k), generator=gen, device=self.device,
                       dtype=torch.float32)
        return r.to(self.dtype).clamp(max=1 - 2 ** -8 if self.dtype == torch.bfloat16 else 1.0)

    def _albedo(self, mid, uv):
        s = self.m_scale[mid][:, None]
        u = uv * s
        fr = u - torch.floor(u)
        cx = (fr[:, 0] >= 0.5)
        cy = (fr[:, 1] >= 0.5)
        col = torch.where((cx == cy)[:, None], self.m_c0[mid], self.m_c1[mid])
        return torch.where(self.m_checker[mid][:, None], col, self.m_c0[mid])

    def _kc(self, mid, cos_i, cos_o, alpha):
        def e_of(c):
            r0, r1, tr = _lookup(alpha, KC_RES)
            c0, c1, tc = _lookup(c, KC_RES)
            row0 = (1 - tc) * self.kc_e[r0, c0] + tc * self.kc_e[r0, c1]
            row1 = (1 - tc) * self.kc_e[r1, c0] + tc * self.kc_e[r1, c1]
            return (1 - tr) * row0 + tr * row1
        i0, i1, ta = _lookup(alpha, KC_RES)
        e_avg = (1 - ta) * self.kc_eavg[i0] + ta * self.kc_eavg[i1]
        f_ms = (1 - e_of(cos_i)) * (1 - e_of(cos_o)) / (math.pi * _safe(1 - e_avg))
        fa = self.m_favg[mid]
        f_add = fa ** 2 * e_avg[:, None] / _safe(1 - fa * (1 - e_avg[:, None]))
        return f_ms[:, None] * f_add * cos_i[:, None]

    @staticmethod
    def _g1(alpha, cos_v, cos_h):
        t2 = alpha ** 2 * torch.clamp(1 - cos_v ** 2, min=0) / torch.clamp(cos_v ** 2, min=1e-20)
        g = 2 / (1 + torch.sqrt(1 + t2))
        return torch.where(cos_v * cos_h > 0, g, torch.zeros_like(g))

    def _conductor(self, mid, n, wo, wi, h, dc):
        """(f, cos_i, cos_o) of the rough conductor for unit wi, wo, h and
        the NDF value dc = D(h) cos(theta_h)."""
        a = self.m_alpha[mid]
        cos_i, cos_o, cos_h = _dot(wi, n), _dot(wo, n), _dot(h, n)
        g = self._g1(a, cos_i, cos_h) * self._g1(a, cos_o, cos_h)
        f0 = self.m_f0[mid]
        fr = (1 - f0) * ((1 - torch.clamp(_dot(wi, h), 0, 1)) ** 5)[:, None] + f0
        f = fr * (dc * g / (4 * _safe(cos_o)))[:, None]
        return f + self._kc(mid, cos_i, cos_o, a), cos_i, cos_o

    def _eval(self, mid, n, uv, wo, wi):
        """(pdf, f = bsdf * cos_i, valid) for unit directions wo (to the
        viewer) and wi (to the light)."""
        kind = self.m_kind[mid]
        cos_i, cos_o = _dot(wi, n), _dot(wo, n)
        # Lambert
        pdf_d = torch.clamp(cos_i, min=0) / math.pi
        f_d = self._albedo(mid, uv) * pdf_d[:, None]
        ok_d = (cos_i >= EPS) & (cos_o >= EPS)
        # conductor
        a = self.m_alpha[mid]
        h = _normalize(wi + wo)
        ch = _dot(h, n)
        den = math.pi * a * a * ((1 - ch ** 2) / (a * a) + ch ** 2) ** 2
        dc = torch.where(ch > 0, ch / torch.clamp(den, min=1e-20), torch.zeros_like(ch))
        pdf_c = dc / (4 * _safe(_dot(wo, h)))
        f_c, _, _ = self._conductor(mid, n, wo, wi, h, dc)
        ok_c = (cos_o >= EPS_F) & (pdf_c >= EPS)
        cond = kind == CONDUCTOR
        return (torch.where(cond, pdf_c, pdf_d), torch.where(cond[:, None], f_c, f_d),
                torch.where(cond, ok_c, ok_d) & (kind != EMITTER))

    def _sample(self, mid, n, uv, wo, xi):
        """(wi, pdf, f, valid) of one BSDF sample."""
        kind = self.m_kind[mid]
        # Lambert: cosine-weighted
        ct = torch.sqrt(xi[:, 0])
        st = torch.sqrt(torch.clamp(1 - ct ** 2, min=0))
        ph = 2 * math.pi * xi[:, 1]
        wl = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], -1)
        wi_d = _to_world(wl, n)
        pdf_d = ct / math.pi
        f_d = self._albedo(mid, uv) * pdf_d[:, None]
        ok_d = pdf_d >= EPS
        # conductor: h ~ D cos(theta_h)
        a = self.m_alpha[mid]
        x0 = torch.clamp(xi[:, 0], max=1 - 1e-6)
        tan2 = a * a * x0 / (1 - x0)
        ch = 1 / torch.sqrt(1 + tan2)
        sh = torch.sqrt(torch.clamp(1 - ch ** 2, min=0))
        hl = torch.stack([sh * torch.cos(ph), sh * torch.sin(ph), ch], -1)
        h = _to_world(hl, n)
        dc = 1 / torch.clamp(math.pi * a * a * ch ** 3 * (1 + tan2 / (a * a)) ** 2, min=1e-20)
        ho = _dot(wo, h)
        pdf_c = dc / (4 * _safe(ho))
        wi_c = 2 * ho[:, None] * h - wo
        f_c, cos_i, _ = self._conductor(mid, n, wo, wi_c, h, dc)
        ok_c = (pdf_c >= EPS) & (cos_i >= EPS_F)
        cond = (kind == CONDUCTOR)
        return (torch.where(cond[:, None], wi_c, wi_d), torch.where(cond, pdf_c, pdf_d),
                torch.where(cond[:, None], f_c, f_d), torch.where(cond, ok_c, ok_d))

    def _occluded(self, o, d, t_max):
        prim = self.bvh.closest(o, d, torch.full_like(t_max, T_MIN), t_max)[1]
        return prim >= 0

    def _nee(self, x, n, uv, mid, wo, gen):
        """Unoccluded-times-visible direct light of each vertex."""
        m = x.shape[0]
        queries = []                      # (wi, dist, ok, contrib)
        if self.n_lights:
            r = self._rand(gen, m, 3)
            cell = torch.searchsorted(self.l_cdf, r[:, 0].double().contiguous(),
                                      right=True).clamp(max=self.n_lights - 1)
            tri = self.l_tri[cell]
            s = torch.sqrt(torch.clamp(1 - r[:, 1], min=0))
            bu, bv = 1 - s, s * r[:, 2]
            pa, e1, e2 = self.bvh.p0, self.bvh.e1, self.bvh.e2
            pos_l = pa[tri] + bu[:, None] * e1[tri] + bv[:, None] * e2[tri]
            nl = _normalize((1 - bu - bv)[:, None] * self.nrm[tri, 0]
                            + bu[:, None] * self.nrm[tri, 1] + bv[:, None] * self.nrm[tri, 2])
            vec = pos_l - x
            dist = torch.sqrt(torch.clamp(_dot(vec, vec), min=1e-20))
            wi = vec / dist[:, None]
            cos_l = -_dot(wi, nl)
            ok = (cos_l >= EPS_F) & (_dot(wi, n) >= EPS_F)
            pdf_e, f, f_ok = self._eval(mid, n, uv, wo, wi)
            pdf_l = self.l_pdf_area * dist * dist / torch.clamp(cos_l, min=1e-12)
            rad = self.m_rad[self.mat[tri]]
            c = _mis(pdf_l, pdf_e)[:, None] * rad * f / torch.clamp(pdf_l, min=1e-12)[:, None]
            queries.append((wi, dist - T_MIN, ok & f_ok, c))
        if self.sun_wi is not None:
            wi = self.sun_wi.expand(m, 3)
            ok = _dot(wi, n) >= EPS_F
            _, f, f_ok = self._eval(mid, n, uv, wo, wi)
            queries.append((wi, torch.full_like(ok, FAR, dtype=x.dtype), ok & f_ok,
                            self.sun_rad * f))
        if self.sky is not None:
            r = self._rand(gen, m, 2)
            z = 1 - 2 * r[:, 0]
            sz = torch.sqrt(torch.clamp(1 - z * z, min=0))
            ph = 2 * math.pi * r[:, 1]
            wi = torch.stack([sz * torch.cos(ph), sz * torch.sin(ph), z], -1)
            ok = _dot(wi, n) >= EPS_F
            pdf_e, f, f_ok = self._eval(mid, n, uv, wo, wi)
            pdf_l = torch.full_like(z, 1 / (4 * math.pi))
            c = _mis(pdf_l, pdf_e)[:, None] * self.sky * f * (4 * math.pi)
            queries.append((wi, torch.full_like(z, FAR), ok & f_ok, c))
        if not queries:
            return torch.zeros_like(x)
        wi = torch.cat([q[0] for q in queries])
        t_max = torch.cat([q[1] for q in queries])
        ok = torch.cat([q[2] for q in queries])
        c = torch.cat([q[3] for q in queries])
        xs = x.repeat(len(queries), 1)
        occ = torch.ones_like(ok)
        idx = torch.nonzero(ok).squeeze(1)
        if idx.numel():
            occ[idx] = self._occluded(xs[idx], wi[idx], t_max[idx])
        c = torch.where((ok & ~occ)[:, None], c, torch.zeros_like(c))
        return c.reshape(len(queries), m, 3).sum(0)

    # -- paths -------------------------------------------------------------

    def radiance(self, pixel, u, v, gen):
        """One sample of each pixel in `pixel` ([N] int64) at the offsets
        u, v ([N]) in it: [N, 3]."""
        sc = self.scene
        n_l = pixel.shape[0]
        f = dict(device=self.device, dtype=self.dtype)
        i = (pixel % sc.width).to(self.dtype)
        j = torch.div(pixel, sc.width, rounding_mode="floor").to(self.dtype)
        x = 2 * (i + u.to(self.dtype)) / sc.width - 1
        y = 1 - 2 * (j + v.to(self.dtype)) / sc.height
        d = _normalize(self.front + x[:, None] * self.dx + y[:, None] * self.dy)
        o = self.eye.expand_as(d).clone()
        L = torch.zeros((n_l, 3), **f)
        beta = torch.ones((n_l, 3), **f)
        pdf_mis = torch.full((n_l,), 1e12, **f)
        lane = torch.arange(n_l, device=self.device)
        inv4pi = 1 / (4 * math.pi)
        for vert in range(1, sc.max_depth + 1):
            if not lane.numel():
                break
            m = lane.numel()
            t, prim, bv, bw, back = self.bvh.closest(
                o, d, torch.full((m,), T_MIN, **f), torch.full((m,), FAR, **f))
            hit = prim >= 0
            if self.sky is not None:
                w = _mis(pdf_mis, torch.full_like(pdf_mis, inv4pi))
                add = torch.where((~hit)[:, None], w[:, None] * beta * self.sky,
                                  torch.zeros_like(beta))
                L.index_add_(0, lane, add)
            keep = torch.nonzero(hit).squeeze(1)
            lane, o, d, beta, pdf_mis = lane[keep], o[keep], d[keep], beta[keep], pdf_mis[keep]
            t, prim, bv, bw, back = t[keep], prim[keep], bv[keep], bw[keep], back[keep]
            if not lane.numel():
                break
            bu = 1 - bv - bw
            n = _normalize(bu[:, None] * self.nrm[prim, 0] + bv[:, None] * self.nrm[prim, 1]
                           + bw[:, None] * self.nrm[prim, 2])
            n = torch.where(back[:, None], -n, n)
            uv = (bu[:, None] * self.uv[prim, 0] + bv[:, None] * self.uv[prim, 1]
                  + bw[:, None] * self.uv[prim, 2])
            xpt = o + t[:, None] * d
            wo = -d
            mid = self.mat[prim]
            kind = self.m_kind[mid]
            # an emitter's front face
            emit = (kind == EMITTER) & ~back
            cos_l = _dot(wo, n)
            if vert > 1:
                emit = emit & (cos_l >= EPS_F)
                if self.n_lights:
                    pdf_l = self.l_pdf_area * t * t / torch.clamp(cos_l, min=1e-12)
                    w = _mis(pdf_mis, pdf_l)
                else:
                    w = torch.ones_like(t)
            else:
                w = torch.ones_like(t)
            L.index_add_(0, lane, torch.where(emit[:, None], w[:, None] * beta
                                              * self.m_rad[mid], torch.zeros_like(beta)))
            alive = ~((kind == EMITTER) | back)
            if vert >= sc.max_depth:
                break
            if vert >= sc.rr_depth:
                alive = alive & (self._rand(gen, lane.numel())[:, 0] < RR_PDF)
                beta = beta / RR_PDF
            keep = torch.nonzero(alive).squeeze(1)
            lane, xpt, n, uv, wo, mid, beta = (a[keep] for a in (lane, xpt, n, uv, wo, mid, beta))
            if not lane.numel():
                break
            L.index_add_(0, lane, beta * self._nee(xpt, n, uv, mid, wo, gen))
            wi, pdf, fs, ok = self._sample(mid, n, uv, wo, self._rand(gen, lane.numel(), 2))
            beta = beta * fs / torch.clamp(pdf, min=1e-12)[:, None]
            ok = ok & (beta.amax(-1) >= EPS)
            keep = torch.nonzero(ok).squeeze(1)
            lane, o, d, beta, pdf_mis = lane[keep], xpt[keep], wi[keep], beta[keep], pdf[keep]
        return L

    def samples(self, pixel, k, bases, seed, block=1 << 20):
        """[P, len(bases) k, 3] float32: for each pixel in `pixel` ([P]
        int64), a group of k samples at each frame base, the paths' random
        numbers from `seed`."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (1 << 63))
        p, n = pixel.shape[0], len(bases) * k
        s = np.arange(n) % k
        b = np.repeat(np.asarray(bases, np.int64), k)
        u = torch.as_tensor(s / k, dtype=torch.float32).repeat(p)
        v = torch.as_tensor(_vdc2((b + s + 1) & 0xFFFFFFFF),
                            dtype=torch.float32).repeat(p)
        pix = pixel.to(self.device).repeat_interleave(n)
        u, v = u.to(self.device), v.to(self.device)
        out = []
        for s0 in range(0, pix.numel(), block):
            sl = slice(s0, s0 + block)
            out.append(self.radiance(pix[sl], u[sl], v[sl], gen).float())
        return torch.cat(out).reshape(p, n, 3).cpu()
