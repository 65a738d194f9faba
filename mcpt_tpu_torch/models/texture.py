"""Textures (counterpart of mcpt_tpu/models/texture.py): SoA tables and
one packed atlas.

The reference makes every scalar BSDF parameter a texture id and
concatenates every bitmap's texels into one flat buffer with offsets
(csrt renderer.cpp:371-431 CommitTextures).  Three kinds are evaluated by
masked selection (constant, checkerboard, bitmap; csrt
texture.hpp:13-43).  `kinds` is the static set of kinds a lookup may
meet: an all-constant scene does no uv math and no atlas gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.ops.math import lerp, rows, sqrt

TEX_NONE = 0
TEX_CONSTANT = 1
TEX_CHECKERBOARD = 2
TEX_BITMAP = 3


class TextureTables(NamedTuple):
    ttype: torch.Tensor         # [T] int32
    color0: torch.Tensor        # [T, 3] constant color / checker color0
    color1: torch.Tensor        # [T, 3] checker color1
    uv_transform: torch.Tensor  # [T, 6] u' = a*u + b*v + c, v' = d*u + e*v + f
    bmp_offset: torch.Tensor    # [T] int32 texel-row offset into the atlas
    bmp_width: torch.Tensor     # [T] int32
    bmp_height: torch.Tensor    # [T] int32
    bmp_channels: torch.Tensor  # [T] int32 source channels (1, 3, 4)
    #: [P, 4] f32, one RGBA row per texel (mono copied to RGB, alpha 1
    #: where the source has none)
    atlas: torch.Tensor
    #: the texture kinds a lookup may meet (static)
    kinds: tuple = (TEX_CONSTANT, TEX_CHECKERBOARD, TEX_BITMAP)


class TextureBuilder:
    """Host-side accumulator mirroring csrt's CommitTextures."""

    def __init__(self):
        self.infos = []  # dicts, as the reference's builder keeps them
        self.atlas_parts = []
        self.atlas_size = 0

    def add_constant(self, color) -> int:
        color = np.broadcast_to(np.asarray(color, np.float32), (3,))
        self.infos.append(dict(type=TEX_CONSTANT, color0=color))
        return len(self.infos) - 1

    def add_checkerboard(self, color0, color1, uv_transform=None) -> int:
        self.infos.append(dict(
            type=TEX_CHECKERBOARD,
            color0=np.broadcast_to(np.asarray(color0, np.float32), (3,)),
            color1=np.broadcast_to(np.asarray(color1, np.float32), (3,)),
            uv_transform=uv_transform,
        ))
        return len(self.infos) - 1

    def add_bitmap(self, pixels: np.ndarray, uv_transform=None) -> int:
        """`pixels`: [H, W] or [H, W, C] f32 linear light, packed as one
        RGBA row per texel (mono copied to RGB, alpha 1)."""
        pixels = np.asarray(pixels, np.float32)
        if pixels.ndim == 2:
            pixels = pixels[..., None]
        h, w, c = pixels.shape
        rows = np.ones((h * w, 4), np.float32)
        flat = pixels.reshape(h * w, c)
        if c == 1:
            rows[:, 0:3] = flat
        else:
            rows[:, 0:c] = flat
        self.infos.append(dict(
            type=TEX_BITMAP, offset=self.atlas_size, width=w, height=h,
            channels=c, uv_transform=uv_transform, part=len(self.atlas_parts),
        ))
        self.atlas_parts.append(rows)
        self.atlas_size += h * w
        return len(self.infos) - 1

    def bitmap_pixels(self, tid: int) -> np.ndarray:
        """Host-side [H, W, C] pixels of a registered bitmap (the envmap's
        alias build reads them)."""
        info = self.infos[tid]
        if info["type"] != TEX_BITMAP:
            raise ValueError(f"texture {tid} is not a bitmap")
        c = info["channels"]
        full = self.atlas_parts[info["part"]].reshape(
            info["height"], info["width"], 4)
        return full[..., :1] if c == 1 else full[..., :c]

    def build(self, device) -> TextureTables:
        t = max(len(self.infos), 1)
        ttype = np.zeros(t, np.int32)
        color0 = np.zeros((t, 3), np.float32)
        color1 = np.zeros((t, 3), np.float32)
        uv_tf = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (t, 1))
        offset = np.zeros(t, np.int32)
        width = np.ones(t, np.int32)
        height = np.ones(t, np.int32)
        channels = np.ones(t, np.int32)
        for i, info in enumerate(self.infos):
            ttype[i] = info["type"]
            if "color0" in info:
                color0[i] = info["color0"]
            if "color1" in info:
                color1[i] = info["color1"]
            if info.get("uv_transform") is not None:
                uv_tf[i] = np.asarray(info["uv_transform"],
                                      np.float32).reshape(6)
            if info["type"] == TEX_BITMAP:
                offset[i] = info["offset"]
                width[i] = info["width"]
                height[i] = info["height"]
                channels[i] = info["channels"]
        atlas = (np.concatenate(self.atlas_parts) if self.atlas_parts
                 else np.zeros((1, 4), np.float32))

        def dev(a):
            return torch.as_tensor(a, device=device)

        return TextureTables(
            ttype=dev(ttype), color0=dev(color0), color1=dev(color1),
            uv_transform=dev(uv_tf), bmp_offset=dev(offset),
            bmp_width=dev(width), bmp_height=dev(height),
            bmp_channels=dev(channels), atlas=dev(atlas),
            kinds=tuple(sorted({info["type"] for info in self.infos})),
        )


def _apply_uv(tf, uv):
    u = tf[..., 0] * uv[..., 0] + tf[..., 1] * uv[..., 1] + tf[..., 2]
    v = tf[..., 3] * uv[..., 0] + tf[..., 4] * uv[..., 1] + tf[..., 5]
    return u, v


def _bitmap_bilinear4(tex: TextureTables, tid, u, v):
    """Wrap-around bilinear RGBA fetch from the atlas (csrt
    src/renderer/textures/bitmap.cpp:6-56): four row gathers, one a
    corner texel.  `tid` is in range (the callers clamp it), and so is
    every texel index, so the gathers index directly."""
    w = tex.bmp_width[tid]
    h = tex.bmp_height[tid]
    off = tex.bmp_offset[tid]
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)

    x = u * wf
    y = v * hf
    x = x - torch.floor(x / wf) * wf
    y = y - torch.floor(y / hf) * hf
    x0 = torch.clamp(x.to(torch.int32), min=0)
    x0 = torch.minimum(x0, w - 1)
    y0 = torch.minimum(torch.clamp(y.to(torch.int32), min=0), h - 1)
    tx = (x - x0.to(torch.float32))[..., None]
    ty = (y - y0.to(torch.float32))[..., None]
    x1 = torch.where(x0 + 1 >= w, torch.zeros_like(x0), x0 + 1)
    y1 = torch.where(y0 + 1 >= h, torch.zeros_like(y0), y0 + 1)

    def texel(xi, yi):
        return rows(tex.atlas, off + xi + w * yi)  # [N, 4]

    c00 = texel(x0, y0)
    c01 = texel(x0, y1)
    c10 = texel(x1, y0)
    c11 = texel(x1, y1)
    return lerp(lerp(c00, c01, ty), lerp(c10, c11, ty), tx)


def eval_color(tex: TextureTables, tid, uv):
    """Texture `tid` ([...] int) at `uv` ([..., 2]) -> [..., 3], masked
    over the kinds in `tex.kinds`: with constants alone, one row gather
    and no uv math.  `tid` is clamped into the table, so the row gathers
    index directly (the reference's take_rows zeroes rows out of range,
    which a clamped id never is)."""
    tid = torch.clamp(tid, 0, tex.ttype.shape[0] - 1)
    const_c = rows(tex.color0, tid)
    if TEX_CHECKERBOARD not in tex.kinds and TEX_BITMAP not in tex.kinds:
        return const_c

    u, v = _apply_uv(tex.uv_transform[tid], uv)
    ttype = tex.ttype[tid]
    out = torch.where((ttype == TEX_CONSTANT)[..., None], const_c,
                      torch.zeros_like(const_c))
    if TEX_CHECKERBOARD in tex.kinds:
        # csrt checkboard.cpp:6-22
        uw = u - torch.floor(u)
        vw = v - torch.floor(v)
        cx = 2 * torch.remainder((uw * 2).to(torch.int32), 2) - 1
        cy = 2 * torch.remainder((vw * 2).to(torch.int32), 2) - 1
        checker = torch.where(((cx * cy) == 1)[..., None], const_c,
                              rows(tex.color1, tid))
        out = torch.where((ttype == TEX_CHECKERBOARD)[..., None], checker, out)
    if TEX_BITMAP in tex.kinds:
        bitmap = _bitmap_bilinear4(tex, tid, u, v)[..., :3]
        out = torch.where((ttype == TEX_BITMAP)[..., None], bitmap, out)
    return out


def eval_scalar(tex: TextureTables, tid, uv):
    """First channel of :func:`eval_color` (roughness and other scalar
    parameters)."""
    return eval_color(tex, tid, uv)[..., 0]


def eval_gradient(tex: TextureTables, tid, uv):
    """Forward-difference gradient of the color's length, for bump maps
    (csrt bitmap.cpp:58-68), at a step of 1e-4.  The difference scales
    the lengths' rounding by 1e4, so each length is summed term by term
    in one fixed order, the same bits on the card and the CPU."""
    delta = 1e-4
    norm = 1.0 / delta
    step = torch.eye(2, dtype=uv.dtype, device=uv.device) * delta

    def size(c):
        return sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                          + c[..., 2] * c[..., 2])

    base = size(eval_color(tex, tid, uv))
    du = size(eval_color(tex, tid, uv + step[0]))
    dv = size(eval_color(tex, tid, uv + step[1]))
    return torch.stack([(du - base) * norm, (dv - base) * norm], dim=-1)


def eval_opacity(tex: TextureTables, tid, uv):
    """Opacity in [0, 1]: a constant's first channel, a bitmap's alpha,
    1 otherwise (csrt constant_texture.cpp:20-24, bitmap.cpp:73-101)."""
    tid = torch.clamp(tid, 0, tex.ttype.shape[0] - 1)
    ttype = tex.ttype[tid]
    alpha = torch.where(ttype == TEX_CONSTANT,
                        rows(tex.color0, tid)[..., 0],
                        torch.ones(tid.shape, dtype=torch.float32,
                                   device=tid.device))
    if TEX_BITMAP in tex.kinds:
        u, v = _apply_uv(tex.uv_transform[tid], uv)
        alpha = torch.where(ttype == TEX_BITMAP,
                            _bitmap_bilinear4(tex, tid, u, v)[..., 3], alpha)
    return alpha
