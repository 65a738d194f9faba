"""Microfacet library (counterpart of mcpt_tpu/ops/microfacet.py; csrt
src/renderer/bsdfs/microfacet.cpp and the archive's ndfs/beckmann.cpp).

Anisotropic GGX and Beckmann NDF sampling and pdfs with their Smith G1
masking terms, the exact dielectric and Schlick Fresnel terms, and the
host-side average-Fresnel fits the BSDF tables store.  Everything is
batched over leading dims; the isotropic case is alpha_u == alpha_v.

Integer powers multiply as the reference's `x**k` lowers (square and
multiply, `_ipow`), so the two packages round alike.
"""

from __future__ import annotations

import numpy as np
import torch

from mcpt_tpu_torch.ops.math import (
    PI,
    TWO_PI,
    atan,
    cos,
    exp,
    log1p,
    sin,
    sqr,
    sqrt,
    tan,
)


def _ipow(x, k: int):
    """x**k for a positive int k by squaring, in the order XLA's
    integer_pow multiplies (x**5 = x * (x*x)*(x*x))."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _anisotropic_phi(xi1, alpha_u, alpha_v):
    """phi warped by the anisotropy (Mitsuba convention) and the alpha^2
    along it."""
    phi = atan(alpha_v / alpha_u * tan(PI + TWO_PI * xi1)) + (
        PI * torch.floor(2.0 * xi1 + 0.5))
    cos_phi, sin_phi = cos(phi), sin(phi)
    alpha_2 = 1.0 / torch.clamp(
        sqr(cos_phi / alpha_u) + sqr(sin_phi / alpha_v), min=1e-20)
    return cos_phi, sin_phi, alpha_2


def sample_ggx(xi0, xi1, alpha_u, alpha_v):
    """Sample a microfacet normal from the anisotropic GGX NDF
    (microfacet.cpp:20-37).  Returns (h_local, D*cos pdf)."""
    cos_phi, sin_phi, alpha_2 = _anisotropic_phi(xi1, alpha_u, alpha_v)
    xi0 = torch.clamp(xi0, max=1.0 - 1e-6)
    tan_theta_2 = alpha_2 * xi0 / (1.0 - xi0)
    cos_theta = 1.0 / sqrt(1.0 + tan_theta_2)
    sin_theta = sqrt(torch.clamp(1.0 - sqr(cos_theta), min=0.0))
    h = torch.stack([sin_theta * cos_phi, sin_theta * sin_phi, cos_theta],
                    dim=-1)
    pdf = 1.0 / torch.clamp(
        PI * alpha_u * alpha_v * _ipow(cos_theta, 3)
        * sqr(1.0 + tan_theta_2 / alpha_2), min=1e-20)
    return h, pdf


def pdf_ggx(alpha_u, alpha_v, h_local):
    """NDF-sampling pdf of `h_local` (microfacet.cpp:52-62); zero below
    the horizon."""
    cos_theta = h_local[..., 2]
    denom = PI * alpha_u * alpha_v * sqr(
        sqr(h_local[..., 0] / alpha_u) + sqr(h_local[..., 1] / alpha_v)
        + sqr(cos_theta))
    pdf = cos_theta / torch.clamp(denom, min=1e-20)
    return torch.where(cos_theta > 0.0, pdf, torch.zeros_like(pdf))


def smith_g1(alpha_u, alpha_v, v_local, h_local):
    """Smith G1 masking-shadowing for GGX (microfacet.cpp:76-86)."""
    n_dot_v = v_local[..., 2]
    xy_alpha_2 = sqr(alpha_u * v_local[..., 0]) + sqr(alpha_v * v_local[..., 1])
    tan_theta_2 = xy_alpha_2 / torch.clamp(sqr(n_dot_v), min=1e-20)
    g = 2.0 / (1.0 + sqrt(1.0 + tan_theta_2))
    return torch.where(n_dot_v * h_local[..., 2] > 0.0, g, torch.zeros_like(g))


def sample_beckmann(xi0, xi1, alpha_u, alpha_v):
    """Sample a microfacet normal from the anisotropic Beckmann NDF
    (archive ndfs/beckmann.cpp:8-30).  Returns (h_local, D*cos pdf)."""
    cos_phi, sin_phi, alpha_2 = _anisotropic_phi(xi1, alpha_u, alpha_v)
    xi0 = torch.clamp(xi0, max=1.0 - 1e-6)
    cos_theta = 1.0 / sqrt(
        torch.clamp(1.0 - alpha_2 * log1p(-xi0), min=1e-12))
    sin_theta = sqrt(torch.clamp(1.0 - sqr(cos_theta), min=0.0))
    h = torch.stack([sin_theta * cos_phi, sin_theta * sin_phi, cos_theta],
                    dim=-1)
    pdf = (1.0 - xi0) / torch.clamp(
        PI * alpha_u * alpha_v * _ipow(cos_theta, 3), min=1e-20)
    return h, pdf


def pdf_beckmann(alpha_u, alpha_v, h_local):
    """Beckmann NDF-sampling pdf of `h_local` (archive
    beckmann.cpp:33-52)."""
    cos_theta = h_local[..., 2]
    cos_theta_2 = torch.clamp(sqr(cos_theta), min=1e-12)
    cos_theta_3 = cos_theta_2 * torch.clamp(cos_theta, min=1e-12)
    expo = (sqr(h_local[..., 0] / alpha_u)
            + sqr(h_local[..., 1] / alpha_v)) / cos_theta_2
    pdf = exp(-expo) / torch.clamp(
        PI * alpha_u * alpha_v * cos_theta_3, min=1e-20)
    return torch.where(cos_theta > 0.0, pdf, torch.zeros_like(pdf))


def smith_g1_beckmann(alpha_u, alpha_v, v_local, h_local):
    """Beckmann Smith G1 with the rational fit (archive
    beckmann.cpp:55-96)."""
    n_dot_v = v_local[..., 2]
    xy_alpha_2 = sqr(alpha_u * v_local[..., 0]) + sqr(alpha_v * v_local[..., 1])
    tan_theta_2 = xy_alpha_2 / torch.clamp(sqr(n_dot_v), min=1e-20)
    a = 1.0 / sqrt(torch.clamp(tan_theta_2, min=1e-20))
    a2 = sqr(a)
    g = torch.where(a < 1.6,
                    (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2),
                    torch.ones_like(a))
    return torch.where(n_dot_v * h_local[..., 2] > 0.0, g, torch.zeros_like(g))


def fresnel_dielectric(cos_i, eta_inv):
    """Exact dielectric Fresnel for the clear-coat layer (archive
    math/sample.cpp FresnelDielectric): `cos_i` >= 0 against the
    interface normal, `eta_inv` = n_i / n_t."""
    sin_t_2 = sqr(eta_inv) * (1.0 - sqr(cos_i))
    cos_t = sqrt(torch.clamp(1.0 - sin_t_2, min=0.0))
    r_s = (eta_inv * cos_i - cos_t) / torch.clamp(eta_inv * cos_i + cos_t,
                                                  min=1e-12)
    r_p = (cos_i - eta_inv * cos_t) / torch.clamp(cos_i + eta_inv * cos_t,
                                                  min=1e-12)
    f = 0.5 * (sqr(r_s) + sqr(r_p))
    return torch.where(sin_t_2 >= 1.0, torch.ones_like(f), f)


def fresnel_schlick(cos_theta, reflectivity):
    """Schlick's approximation (microfacet.hpp:25-29).  `reflectivity`
    is scalar [...] or RGB [..., 3]; `cos_theta` [...]."""
    pow5 = _ipow(1.0 - torch.clamp(cos_theta, 0.0, 1.0), 5)
    if reflectivity.dim() > pow5.dim():
        pow5 = pow5[..., None]
    return (1.0 - reflectivity) * pow5 + reflectivity


def average_fresnel_scalar(eta):
    """Scalar average-Fresnel fit (csrt bsdf.cpp:10-38), host numpy:
    Egan-Hilgeman for eta < 1, d'Eon-Irving otherwise."""
    eta = np.asarray(eta, np.float32)
    lo = -1.4399 * eta**2 + 0.7099 * eta + 0.6681 + 0.0636 / eta
    ie = 1.0 / eta
    hi = (0.919317 - 3.4793 * ie + 6.75335 * ie**2 - 7.80989 * ie**3
          + 4.98554 * ie**4 - 1.36881 * ie**5)
    return np.where(eta < 1.0, lo, hi).astype(np.float32)


def average_fresnel_rgb(reflectivity, edgetint):
    """Conductor average-Fresnel fit in the Gulbrandsen parametrization
    (csrt bsdf.cpp:40-51), host numpy."""
    r = np.asarray(reflectivity, np.float32)
    g = np.asarray(edgetint, np.float32)
    return (0.087237 + 0.0230685 * g - 0.0864902 * g**2 + 0.0774594 * g**3
            + 0.782654 * r - 0.136432 * r**2 + 0.278708 * r**3
            + 0.19744 * g * r + 0.0360605 * g**2 * r
            - 0.2586 * g * r**2).astype(np.float32)
