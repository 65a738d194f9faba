"""Textures (counterpart of mcpt_tpu/models/texture.py), constant kind.

The reference makes every scalar BSDF parameter a texture id and keeps
SoA tables (csrt renderer.cpp:371-431).  The main path's scenes use
constant textures only, so the port keeps the reference's `ttype` and
`color0` columns; checkerboard and bitmap textures (uv transforms, the
atlas) are ROADMAP item 14.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.ops.math import take_rows

TEX_CONSTANT = 1


class TextureTables(NamedTuple):
    ttype: torch.Tensor   # [T] int32
    color0: torch.Tensor  # [T, 3] constant color


class TextureBuilder:
    """Host-side accumulator mirroring csrt's CommitTextures."""

    def __init__(self):
        self.infos = []  # dicts, as the reference's builder keeps them

    def add_constant(self, color) -> int:
        color = np.broadcast_to(np.asarray(color, np.float32), (3,))
        self.infos.append(dict(type=TEX_CONSTANT, color0=color))
        return len(self.infos) - 1

    def add_checkerboard(self, *args, **kwargs) -> int:
        raise NotImplementedError("checkerboard textures: ROADMAP item 14")

    def add_bitmap(self, *args, **kwargs) -> int:
        raise NotImplementedError("bitmap textures: ROADMAP item 14")

    def build(self, device) -> TextureTables:
        t = max(len(self.infos), 1)
        color0 = np.zeros((t, 3), np.float32)
        ttype = np.zeros(t, np.int32)
        for i, info in enumerate(self.infos):
            ttype[i] = info["type"]
            color0[i] = info["color0"]
        return TextureTables(ttype=torch.as_tensor(ttype, device=device),
                             color0=torch.as_tensor(color0, device=device))


def eval_color(tex: TextureTables, tid, uv):
    """Texture `tid` ([...] int) at `uv` ([..., 2]) -> [..., 3]; constant
    textures ignore `uv`."""
    tid = torch.clamp(tid, 0, tex.ttype.shape[0] - 1)
    return take_rows(tex.color0, tid)


def eval_scalar(tex: TextureTables, tid, uv):
    """First channel of :func:`eval_color` (roughness and other scalar
    parameters)."""
    return eval_color(tex, tid, uv)[..., 0]
