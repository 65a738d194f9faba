"""Pinhole camera (counterpart of mcpt_tpu/render/camera.py; csrt
src/renderer/camera.cpp).

The (front, right, up) basis and the view_dx/view_dy spans are computed
on the host; ray generation maps pixel indices to rays with the
reference's screen mapping x = 2(i+u)/w - 1, y = 1 - 2(j+v)/h
(renderer.cpp:70-75).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch.ops.math import sqrt, to_radians
from mcpt_tpu_torch.scene.ir import CameraInfo


class Camera(NamedTuple):
    eye: torch.Tensor      # [3]
    front: torch.Tensor    # [3]
    view_dx: torch.Tensor  # [3] right * tan(fov_x / 2)
    view_dy: torch.Tensor  # [3] up * tan(fov_y / 2)
    width: int
    height: int
    spp: int


def make_camera(info: CameraInfo, device="cuda") -> Camera:
    eye = np.asarray(info.eye, np.float32)
    look_at = np.asarray(info.look_at, np.float32)
    up = np.asarray(info.up, np.float32)

    fov_y = info.fov_x * info.height / info.width
    front = look_at - eye
    front /= max(np.linalg.norm(front), 1e-12)
    right = np.cross(front, up)
    right /= max(np.linalg.norm(right), 1e-12)
    up = np.cross(right, front)
    up /= max(np.linalg.norm(up), 1e-12)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(
        eye=dev(eye),
        front=dev(front),
        view_dx=dev(right * math.tan(to_radians(0.5 * info.fov_x))),
        view_dy=dev(up * math.tan(to_radians(0.5 * fov_y))),
        width=int(info.width),
        height=int(info.height),
        spp=int(info.spp),
    )


def generate_rays(camera: Camera, pixel_idx, u, v):
    """Rays for linear pixel indices ([N] int, row-major j * width + i)
    with jitter u, v ([N] or scalar, in [0, 1)).
    Returns (origins [N, 3], directions [N, 3])."""
    i = (pixel_idx % camera.width).to(torch.float32)
    j = torch.div(pixel_idx, camera.width, rounding_mode="floor").to(torch.float32)
    x = 2.0 * (i + u) / camera.width - 1.0
    y = 1.0 - 2.0 * (j + v) / camera.height
    d = (
        camera.front[None, :]
        + x[:, None] * camera.view_dx[None, :]
        + y[:, None] * camera.view_dy[None, :]
    )
    # the length term by term in one order: the same bits on the card
    # and the CPU, which a library norm does not promise
    d = d / sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                       + d[:, 2] * d[:, 2])[:, None]
    o = camera.eye.expand_as(d)
    return o, d
