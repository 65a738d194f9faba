"""Parameter gradients of a render (counterpart of
mcpt_tpu/parallel/shard.py:62-202): the parameter families, their
selection and write-back, and the single-process train step.

Each family maps to scene table leaves; the tables derived from them on
the host at commit (a BSDF's inverse eta, Fresnel reflectance and average
Fresnel values) are recomputed under autograd by `apply_params`, so that
their sensitivities reach the gradient.  The film sharded over devices and
the gradients' all-reduce are not here (ROADMAP item 19).
"""

from __future__ import annotations

import dataclasses

import torch

from mcpt_tpu_torch.ops.microfacet import (
    average_fresnel_rgb_torch,
    average_fresnel_scalar_torch,
)
from mcpt_tpu_torch.render.renderer import render_pixels

#: gradient parameter families: "material, texture, and emitter
#: parameters", and the media's coefficients
PARAM_FAMILIES = ("textures", "bsdf", "emitters", "media")


def select_params(scene, families=("textures",)) -> dict:
    """The scene's leaves of the requested families, by dotted name."""
    p = {}
    if "textures" in families:
        p["tex.color0"] = scene.tex.color0
        p["tex.color1"] = scene.tex.color1
        p["tex.atlas"] = scene.tex.atlas
    if "bsdf" in families:
        p["bsdf.eta"] = scene.bsdf.eta
        p["bsdf.reflectivity_rgb"] = scene.bsdf.reflectivity_rgb
        p["bsdf.edgetint_rgb"] = scene.bsdf.edgetint_rgb
    if "emitters" in families:
        p["em.intensity"] = scene.emitters.intensity
        p["em.radiance"] = scene.emitters.radiance
    if "media" in families:
        p["med.sigma_s"] = scene.media.sigma_s
        p["med.sigma_t"] = scene.media.sigma_t
    return p


def apply_params(scene, p: dict):
    """The scene with the leaves of `p` written back and the BSDF tables
    derived from them recomputed in torch (csrt bsdf.cpp:115-188), so that
    autograd sees the whole dependency.  The media's sampling_weight stays
    fixed: it is a sampling choice, whose derivative would need
    score-function terms the estimator does not carry."""
    if "tex.color0" in p:
        scene = dataclasses.replace(scene, tex=scene.tex._replace(
            color0=p["tex.color0"], color1=p["tex.color1"],
            atlas=p["tex.atlas"]))
    if "bsdf.eta" in p:
        eta = p["bsdf.eta"]
        refl_rgb = p["bsdf.reflectivity_rgb"]
        edge_rgb = p["bsdf.edgetint_rgb"]
        r = (eta - 1.0) / (eta + 1.0)
        scene = dataclasses.replace(scene, bsdf=scene.bsdf._replace(
            eta=eta,
            eta_inv=1.0 / eta,
            reflectivity=r * r,
            f_avg=average_fresnel_scalar_torch(eta),
            f_avg_inv=average_fresnel_scalar_torch(1.0 / eta),
            reflectivity_rgb=refl_rgb,
            edgetint_rgb=edge_rgb,
            f_avg_rgb=average_fresnel_rgb_torch(refl_rgb, edge_rgb)))
    if "em.intensity" in p:
        scene = dataclasses.replace(scene, emitters=scene.emitters._replace(
            intensity=p["em.intensity"], radiance=p["em.radiance"]))
    if "med.sigma_s" in p:
        scene = dataclasses.replace(scene, media=scene.media._replace(
            sigma_s=p["med.sigma_s"], sigma_t=p["med.sigma_t"]))
    return scene


def make_train_step(integ, spp: int, families: tuple = ("textures",),
                    grad_chunks: int = 1):
    """The differentiable render step on one device: returns
    `step(scene, camera, pixel_idx, target) -> (loss, grads)`, the loss
    sum((img - target)^2) over the pixels and channels, divided by their
    count, and its gradient for each leaf of the requested `families`
    (PARAM_FAMILIES), by name.

    grad_chunks > 1 (dividing the pixel count) renders the pixels in that
    many pieces and runs each piece's backward before the next piece is
    rendered, so that one piece's graph is held at a time; the gradients
    accumulate in the leaves.  The result equals grad_chunks = 1 up to
    float reassociation (the reference's chunked lax.scan)."""

    def step(scene, camera, pixel_idx, target):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in select_params(scene, families).items()}
        n = pixel_idx.shape[0]
        chunks = grad_chunks if grad_chunks > 1 and n % grad_chunks == 0 else 1
        loss = torch.zeros((), dtype=torch.float32, device=pixel_idx.device)
        for idx_c, tgt_c in zip(pixel_idx.chunk(chunks), target.chunk(chunks)):
            img = render_pixels(apply_params(scene, params), camera, integ,
                                idx_c, spp, differentiable=True)
            diff = img - tgt_c
            loss_c = (diff * diff).sum() / (n * 3)
            loss_c.backward()
            loss = loss + loss_c.detach()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        return loss, grads

    return step
