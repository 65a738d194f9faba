"""Devices: the film sharded by pixel over a mesh of devices, and the
train step over it (counterpart of mcpt_tpu/parallel/shard.py).

The mesh is a tuple of torch devices (make_mesh); the scene and camera
are replicated on each (scene/compile.py::replicate_scene) and each
device renders its contiguous shard of the pixels.  Every pixel's Tea/LCG
stream is a function of (pixel, frame) alone, so the film does not depend
on the mesh: it is bit-equal to one render_pixels call over every pixel.
Shards on one device run one after another; distinct devices run at once,
a host thread each.  The train step's loss and gradients are summed over
the mesh onto its first device, then all-reduced over the process group
where one is up (parallel/distributed.py): the reference's psum.

The parameter families map to scene table leaves; the tables derived
from them on the host at commit (a BSDF's inverse eta, Fresnel
reflectance and average Fresnel values) are recomputed under autograd by
`apply_params`, so that their sensitivities reach the gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from mcpt_tpu_torch.ops.microfacet import (
    average_fresnel_rgb_torch,
    average_fresnel_scalar_torch,
)
from mcpt_tpu_torch.render.renderer import render_pixels
from mcpt_tpu_torch.scene.compile import replicate_scene


def make_mesh(devices=None) -> tuple:
    """The 1-D mesh: a tuple of torch devices, by default every CUDA
    device this process sees (CUDA_VISIBLE_DEVICES narrows them); raises
    when there is none.  A caller may name devices, and may repeat one
    (the CPU tests take [cpu] * k): its shards then run one after
    another."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "to render on another")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(dv) for dv in devices)
    if not mesh:
        raise ValueError("make_mesh: an empty mesh")
    return mesh


def _on_devices(mesh, fn) -> list:
    """[fn(k) for each shard k of the mesh], the shards of one device one
    after another in mesh order, distinct devices at once (a thread
    each)."""
    groups = {}
    for k, dv in enumerate(mesh):
        groups.setdefault(dv, []).append(k)

    def run(ks):
        dv = mesh[ks[0]]
        with (torch.cuda.device(dv) if dv.type == "cuda"
              else contextlib.nullcontext()):
            return [(k, fn(k)) for k in ks]

    if len(groups) == 1:
        done = run(next(iter(groups.values())))
    else:
        with ThreadPoolExecutor(len(groups)) as pool:
            done = [x for part in pool.map(run, groups.values()) for x in part]
    return [out for _, out in sorted(done, key=lambda x: x[0])]


def render_shards(scene, camera, integ, mesh, shards, spp: int,
                  frame_base: int = 0) -> list:
    """render_pixels of each pixel shard on its device of `mesh` (one
    shard a device), on replicas of the scene and the camera there."""
    def shard(k):
        dv = mesh[k]
        return render_pixels(replicate_scene(scene, dv),
                             replicate_scene(camera, dv), integ,
                             shards[k].to(dv), spp, frame_base)

    return _on_devices(mesh, shard)


def film_shards(n_pix: int, n_dev: int) -> list:
    """The pixel indices of each of n_dev contiguous shards: the pixel
    count padded to a multiple of n_dev, as arange(n_pad) % n_pix."""
    n_pad = -(-n_pix // n_dev) * n_dev
    return list((torch.arange(n_pad) % n_pix).chunk(n_dev))


def render_film_sharded(scene, camera, integ, mesh, spp: int,
                        frame_base: int = 0) -> torch.Tensor:
    """The whole film, [H*W, 3] f32 on mesh[0], its pixels sharded over
    `mesh` (mcpt_tpu/parallel/shard.py:37-60): bit-equal to render_pixels over every pixel
    in one call, whatever the mesh."""
    n_pix = camera.width * camera.height
    films = render_shards(scene, camera, integ, mesh,
                          film_shards(n_pix, len(mesh)), spp, frame_base)
    return torch.cat([f.to(mesh[0]) for f in films])[:n_pix]

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


def make_train_step(integ, spp: int, mesh, families: tuple = ("textures",),
                    grad_chunks: int = 1):
    """The differentiable render step over `mesh`
    (mcpt_tpu/parallel/shard.py:134-202):
    returns `step(scene, camera, pixel_idx, target) -> (loss, grads)`, the
    loss sum((img - target)^2) over the pixels and channels, divided by
    their count, and its gradient for each leaf of the requested
    `families` (PARAM_FAMILIES), by name, both on mesh[0].

    pixel_idx [N] and target [N, 3] cover the whole film (or batch): N
    must divide among the mesh's devices — with a process group up
    (parallel/distributed.py), among every process's devices, the global
    mesh being the processes' meshes in rank order.  Each device renders
    and differentiates its contiguous shard on a replica of the scene,
    normalised by the global element count n_local x n_dev x 3; the
    losses and the gradients are summed over the mesh onto mesh[0] and
    then all-reduced over the process group, if one is up (the
    reference's psum).

    grad_chunks > 1 (dividing a device's pixel count) renders a device's
    pixels in that many pieces and runs each piece's backward before the
    next piece is rendered, so that one piece's graph is held at a time;
    the gradients accumulate in the leaves.  The result equals
    grad_chunks = 1, and a mesh of one device, up to float reassociation
    (the reference's chunked lax.scan)."""
    from mcpt_tpu_torch.parallel import distributed

    def device_step(scene, camera, idx, tgt, n_global):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in select_params(scene, families).items()}
        n = idx.shape[0]
        chunks = grad_chunks if grad_chunks > 1 and n % grad_chunks == 0 else 1
        loss = torch.zeros((), dtype=torch.float32, device=idx.device)
        for idx_c, tgt_c in zip(idx.chunk(chunks), tgt.chunk(chunks)):
            img = render_pixels(apply_params(scene, params), camera, integ,
                                idx_c, spp, differentiable=True)
            diff = img - tgt_c
            loss_c = (diff * diff).sum() / n_global
            loss_c.backward()
            loss = loss + loss_c.detach()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        return loss, grads

    def step(scene, camera, pixel_idx, target):
        first, n_dev = distributed.mesh_slot(mesh)
        n = pixel_idx.shape[0]
        if n % n_dev:
            raise ValueError(f"make_train_step: {n} pixels do not divide "
                             f"among {n_dev} devices")
        n_local = n // n_dev
        n_global = n_local * n_dev * 3

        def shard(k):
            dv = mesh[k]
            sl = slice((first + k) * n_local, (first + k + 1) * n_local)
            return device_step(replicate_scene(scene, dv),
                               replicate_scene(camera, dv),
                               pixel_idx[sl].to(dv), target[sl].to(dv),
                               n_global)

        parts = _on_devices(mesh, shard)
        loss = sum((lo.to(mesh[0]) for lo, _ in parts[1:]),
                   parts[0][0].to(mesh[0]))
        grads = {k: sum((g[k].to(mesh[0]) for _, g in parts[1:]),
                        parts[0][1][k].to(mesh[0]))
                 for k in parts[0][1]}
        return distributed.all_reduce_sum(loss, grads)

    return step
