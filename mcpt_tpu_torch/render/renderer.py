"""Renderer orchestration (counterpart of mcpt_tpu/render/renderer.py;
csrt src/renderer/renderer.cpp Draw path).

The film renders in pixel tiles, each tile once per spp chunk, and the
chunks' films accumulate on the device.  Two engines, as in the
reference:

* `regen` (the default for the path and volpath integrators):
  `render_tile_regen`, the integrator's fused spp x depth wavefront
  (shade_regen), every lane owning all of its pixel's samples;
* `chunked` (the default for BDPT): `render_tile` -> `render_pixels`,
  one camera sample of every pixel at a time through the integrator's
  `shade`, the seed carried from sample to sample.  BDPT has no regen
  body: `regen` renders a BDPT config by path's, as the reference does.

Every pixel's samples are a pure function of (pixel, frame), so the image
does not depend on the tile or chunk sizes; the two engines seed their
samples differently, so their images agree statistically.

A tile lost to a device fault is rendered again (`MCPT_TILE_RETRIES`).
The reference's `_tile_fallback` and `_is_compiler_crash` are not ported:
they retry a tile with other XLA compile options after the TPU's compiler
crashed, and the port compiles no tile program: its kernels are built
once, by nvcc, at their first call.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.integrators import bdpt as bdpt_integrator
from mcpt_tpu_torch.integrators import path as path_integrator
from mcpt_tpu_torch.integrators import volpath as volpath_integrator
from mcpt_tpu_torch.ops import rng
from mcpt_tpu_torch.render.camera import generate_rays, make_camera
from mcpt_tpu_torch.scene.compile import compile_scene
from mcpt_tpu_torch.scene.ir import RendererConfig


def _integrator(integ):
    """The regen engine's integrator: volpath's or path's."""
    return volpath_integrator if integ.itype == "volpath" else path_integrator


def _shade(integ):
    """The chunked engine's body (mcpt_tpu/render/renderer.py:54-57)."""
    return {"volpath": volpath_integrator.shade,
            "bdpt": bdpt_integrator.shade}.get(integ.itype,
                                               path_integrator.shade)


def render_pixels(scene, camera, integ, pixel_idx, spp: int, frame_base=0,
                  differentiable: bool = False, spp_total: int | None = None,
                  sample_offset=0):
    """The chunked engine (mcpt_tpu/render/renderer.py:34-83): the mean of
    `spp` samples for a batch of linear pixel indices.  Sample s uses
    jitter u = (sample_offset + s) / spp_total, v = VdC2(base + s + 1)
    with base = frame_base + sample_offset, and one seed per pixel,
    Tea(pixel, base), carried from sample to sample; each sample is
    clamped (renderer.cpp:77-79) before it is summed.

    differentiable=True renders under autograd: each `shade` runs its
    fixed trip count (the reference's lax.scan) and reads the envmap
    through the texture atlas; the sample loop is the same."""
    spp_total = spp if spp_total is None else spp_total
    base = (int(frame_base) + int(sample_offset)) & 0xFFFFFFFF
    seed = rng.pixel_seed(pixel_idx, base)
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32,
                      device=pixel_idx.device)
    shade = _shade(integ)
    for s in range(spp):
        # the jitter in f32, as the reference computes it
        u = float(np.float32(sample_offset + s) / np.float32(spp_total))
        v = float(rng.van_der_corput_base2(base + s + 1))
        o, d = generate_rays(camera, pixel_idx, u, v)
        radiance, seed = shade(scene, integ, o, d, seed,
                               differentiable=differentiable)
        if integ.sample_clamp > 0:
            radiance = torch.clamp(radiance, max=integ.sample_clamp)
        acc = acc + radiance
    return acc / spp


def render_tile(scene, camera, integ, pixel_idx, spp: int, frame_base=0,
                spp_total=None, sample_offset=0):
    """One tile-chunk by the chunked engine."""
    return render_pixels(scene, camera, integ, pixel_idx, spp, frame_base,
                         spp_total=spp_total, sample_offset=sample_offset)


def render_tile_regen(scene, camera, integ, pixel_idx, spp: int, frame_base=0,
                      spp_total=None, sample_offset=0):
    """One tile-chunk by the regen engine: volpath's shade_regen for the
    volpath integrator, path's otherwise
    (mcpt_tpu/render/renderer.py:95-108)."""
    film, _ = _integrator(integ).shade_regen(
        scene, integ, camera, pixel_idx, spp, frame_base=frame_base,
        spp_total=spp_total, sample_offset=sample_offset)
    return film


class Renderer:
    """Facade: config -> committed scene -> film (csrt RayTracer)."""

    def __init__(self, config: RendererConfig, device="cuda"):
        # config-tier perf knobs (RendererConfig.perf) become MCPT_* env
        # defaults before the scene commit reads them, as the reference's
        # Renderer does (mcpt_tpu/render/renderer.py:176-183): explicit env
        # vars still win
        for key, value in getattr(config, "perf", {}).items():
            os.environ.setdefault(
                "MCPT_" + key.upper().replace(".", "_"), str(value))
        self.device = torch.device(device)
        self.config = config
        with trace.span("scene.compile"):
            self.scene = compile_scene(config, self.device)
        self.camera = make_camera(config.camera, self.device)
        self.integrator = config.integrator

    def render(self, spp: int | None = None, tile: int = 1 << 16,
               frame_base: int = 0, progress: bool = False,
               spp_chunk: int = 8, engine: str | None = None) -> np.ndarray:
        """Render the full frame; returns linear-light [H, W, 3] float32.

        Work goes in (tile, spp_chunk) pieces: chunk s of a tile renders
        samples [offset, offset + s) of `spp` (u = (offset + k) / spp,
        the reference's stratified jitter).  engine: 'regen' (the default
        for path and volpath) or 'chunked' (the default for BDPT);
        MCPT_ENGINE overrides the default, and any other name takes the
        chunked engine, as in the reference.  progress=True prints the
        reference's percent and ETA line as the chunks finish.

        A tile whose render raises a device fault (RuntimeError, which
        covers torch.cuda.OutOfMemoryError and torch.AcceleratorError) is
        rendered again on the same device through the same kernels, up to
        MCPT_TILE_RETRIES times (default 2), each retry with a warning and
        with the scene's CUDA graphs dropped, to be captured again;
        after the last the error is raised.  Every pixel's samples are a
        pure function of (pixel, frame), so a retried tile equals the lost
        one.  torch reports a fault when a launch or the tile's copy to
        the host runs; a sticky CUDA error poisons the context, so its
        retries fail again and the error is raised."""
        if engine is None:
            engine = os.environ.get(
                "MCPT_ENGINE",
                "regen" if self.integrator.itype != "bdpt" else "chunked")
        tile_fn = render_tile_regen if engine == "regen" else render_tile
        cam = self.camera
        n_pix = cam.width * cam.height
        spp = spp or cam.spp
        spp_chunk = min(spp_chunk, spp)
        chunks = [spp_chunk] * (spp // spp_chunk)
        if spp % spp_chunk:
            chunks.append(spp % spp_chunk)
        retries = int(os.environ.get("MCPT_TILE_RETRIES", "2"))
        with trace.render_call():
            frame = np.zeros((n_pix, 3), np.float32)
            t0 = time.time()
            done, total_work = 0, n_pix * spp

            def render_one(idx):
                nonlocal done
                acc = None
                s_done = 0
                for s in chunks:
                    with trace.span("tile_chunk"):
                        film = tile_fn(self.scene, cam, self.integrator, idx,
                                       s, frame_base=frame_base,
                                       spp_total=spp, sample_offset=s_done)
                    contrib = film * float(s)
                    acc = contrib if acc is None else acc + contrib
                    s_done += s
                    done += idx.shape[0] * s
                    if progress:
                        pct = 100.0 * done / total_work
                        eta = (time.time() - t0) / done * (total_work - done)
                        print(f"\r[info] render {pct:5.1f}%  eta {eta:6.1f}s",
                              end="", flush=True)
                film = acc / spp
                with trace.span("sync", site="film"):
                    return film.cpu().numpy()

            for start in range(0, n_pix, tile):
                end = min(start + tile, n_pix)
                idx = torch.arange(start, end, dtype=torch.int64,
                                   device=self.device)
                done_before = done
                for attempt in range(retries + 1):
                    try:
                        frame[start:end] = render_one(idx)
                        break
                    except RuntimeError as err:
                        if (isinstance(err, NotImplementedError)
                                or attempt >= retries):
                            raise
                        # the fault may have struck inside a replay
                        self.scene.graphs.clear()
                        warnings.warn(
                            f"tile [{start}:{end}] lost "
                            f"({type(err).__name__}); re-rendering "
                            f"(attempt {attempt + 1})")
                        done = done_before
            if progress:
                print(f"\r[info] render done in {time.time() - t0:.2f}s"
                      "      ")
        return frame.reshape(cam.height, cam.width, 3)
