"""Renderer orchestration (counterpart of mcpt_tpu/render/renderer.py,
the regeneration engine; csrt src/renderer/renderer.cpp Draw path).

The film renders in pixel tiles; each tile runs the path integrator's
regen wavefront (integrators/path.py::shade_regen) once per spp chunk,
and the chunks' films accumulate on the device.  Every pixel's samples
are a pure function of (pixel, frame), so the image does not depend on
the tile or chunk sizes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mcpt_tpu_torch.integrators import path as path_integrator
from mcpt_tpu_torch.render.camera import make_camera
from mcpt_tpu_torch.scene.compile import compile_scene
from mcpt_tpu_torch.scene.ir import RendererConfig


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
        self.scene = compile_scene(config, self.device)
        self.camera = make_camera(config.camera, self.device)
        self.integrator = config.integrator

    def render(self, spp: int | None = None, tile: int = 1 << 16,
               frame_base: int = 0, spp_chunk: int = 8) -> np.ndarray:
        """Render the full frame; returns linear-light [H, W, 3] float32.

        Work goes in (tile, spp_chunk) pieces: chunk s of a tile renders
        samples [offset, offset + s) of `spp` (u = (offset + k) / spp,
        the reference's stratified jitter).  Only the regen engine is
        ported: MCPT_ENGINE=chunked (the reference's per-sample wavefront)
        raises."""
        engine = os.environ.get("MCPT_ENGINE", "regen")
        if engine != "regen":
            raise NotImplementedError(
                f"MCPT_ENGINE={engine}: the chunked per-sample engine "
                "(render_tile + shade) is ROADMAP item 17")
        cam = self.camera
        n_pix = cam.width * cam.height
        spp = spp or cam.spp
        spp_chunk = min(spp_chunk, spp)
        chunks = [spp_chunk] * (spp // spp_chunk)
        if spp % spp_chunk:
            chunks.append(spp % spp_chunk)

        frame = np.zeros((n_pix, 3), np.float32)
        for start in range(0, n_pix, tile):
            end = min(start + tile, n_pix)
            idx = torch.arange(start, end, dtype=torch.int64, device=self.device)
            acc = None
            s_done = 0
            for s in chunks:
                film, _ = path_integrator.shade_regen(
                    self.scene, self.integrator, cam, idx, s,
                    frame_base=frame_base, spp_total=spp, sample_offset=s_done,
                )
                contrib = film * float(s)
                acc = contrib if acc is None else acc + contrib
                s_done += s
            frame[start:end] = (acc / spp).cpu().numpy()
        return frame.reshape(cam.height, cam.width, 3)
