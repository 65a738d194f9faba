"""Hosek-Wilkie RGB sky model, vectorized numpy (counterpart of
mcpt_tpu/scene/hosek.py).

Re-implements the evaluation pipeline of the vendored ArHosekSkyModel C
code the reference uses (csrt extern/ArHosekSkyModel/ArHosekSkyModel.c:
CookConfiguration:147-202, CookRadianceConfiguration:204-262,
GetRadianceInternal:264-276) against the published RGB coefficient
dataset (hosek_data.npz, extracted from ArHosekSkyModelData_RGB.h —
datasetRGB{1,2,3} [2 albedos x 10 turbidities x 6 Bezier knots x 9
coeffs] + datasetRGBRad{1,2,3} [2 x 10 x 6]).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "hosek_data.npz")


@functools.lru_cache(maxsize=1)
def _load():
    data = np.load(_DATA_PATH)
    cfg = np.stack(
        [data[f"datasetRGB{i}"].reshape(2, 10, 6, 9) for i in (1, 2, 3)]
    )  # [3, albedo, turbidity, knot, coeff]
    rad = np.stack(
        [data[f"datasetRGBRad{i}"].reshape(2, 10, 6) for i in (1, 2, 3)]
    )  # [3, albedo, turbidity, knot]
    return cfg, rad


def _bezier5(knots_last, t):
    """Quintic Bezier; the 6-knot elevation axis must be LAST."""
    s = 1.0 - t
    w = np.array(
        [s**5, 5 * s**4 * t, 10 * s**3 * t**2, 10 * s**2 * t**3,
         5 * s * t**4, t**5]
    )
    return np.tensordot(knots_last, w, axes=([-1], [0]))


def cook_state(turbidity: float, albedo, solar_elevation: float):
    """Per-channel 9-coefficient configuration [3, 9] + radiance [3]
    (arhosek_rgb_skymodelstate_alloc_init equivalent)."""
    cfg_data, rad_data = _load()  # [3,2,10,6,9], [3,2,10,6]
    albedo = np.broadcast_to(np.asarray(albedo, np.float64), (3,))
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    it = min(int(turbidity), 10)
    rem = turbidity - it
    t_el = (max(solar_elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)

    def blend(data):
        # data: [3, 2(albedo), 10(turbidity), 6(knots), ...]
        def at(t_idx):
            knots = np.moveaxis(data[:, :, t_idx], 2, -1)  # knots last
            return _bezier5(knots, t_el)  # [3, 2] or [3, 2, 9]

        def mix_albedo(v):  # v: [3, 2, ...]
            a = albedo.reshape((3,) + (1,) * (v.ndim - 2))
            return (1.0 - a) * v[:, 0] + a * v[:, 1]

        out = (1.0 - rem) * mix_albedo(at(it - 1))
        if it < 10:
            out = out + rem * mix_albedo(at(it))
        return out

    config = blend(cfg_data)   # [3, 9]
    radiance = blend(rad_data)  # [3]
    return config, radiance


def radiance(config, rad, theta, gamma):
    """Sky radiance per channel (GetRadianceInternal), vectorized over
    theta/gamma arrays.  Returns [..., 3]."""
    theta = np.asarray(theta)[..., None]
    gamma = np.asarray(gamma)[..., None]
    a, b, c, d, e, f, g, h, i = [config[:, k] for k in range(9)]
    cos_g = np.cos(gamma)
    cos_t = np.maximum(np.cos(theta), 0.0)
    exp_m = np.exp(e * gamma)
    ray_m = cos_g * cos_g
    mie_m = (1.0 + ray_m) / np.power(1.0 + i * i - 2.0 * i * cos_g, 1.5)
    zenith = np.sqrt(cos_t)
    val = (1.0 + a * np.exp(b / (cos_t + 0.01))) * (
        c + d * exp_m + f * ray_m + g * mie_m + h * zenith
    )
    return val * rad


def sky_bitmap(light_direction, turbidity: float, albedo=0.15,
               width: int = 512, height: int = 256, stretch: float = 1.0,
               extend: bool = True, radiance_scale: float = 1.0) -> np.ndarray:
    """Lat-long sky bitmap (csrt CreateSkyTexture, sun_sky.cpp:305-374).

    `light_direction` is the direction light travels (sun -> scene);
    the model wants the to-sun direction.
    """
    to_sun = -np.asarray(light_direction, np.float64)
    to_sun = to_sun / max(np.linalg.norm(to_sun), 1e-12)
    zenith_sun = np.arccos(np.clip(to_sun[1], -1.0, 1.0))
    azimuth_sun = np.arctan2(to_sun[0], -to_sun[2])
    if azimuth_sun < 0:
        azimuth_sun += 2 * np.pi

    config, rad = cook_state(turbidity, albedo, 0.5 * np.pi - zenith_sun)

    theta_raw = (np.arange(height) + 0.5) * np.pi / height
    theta = theta_raw / stretch
    below = np.cos(theta) <= 0.0
    factor2 = np.ones(height)
    if extend:
        temp = np.clip(2.0 - 2.0 * theta_raw / np.pi, 0.0, 1.0)
        factor2 = np.where(below, temp * temp * (3.0 - 2.0 * temp), 1.0)
        theta = np.where(below, 0.5 * np.pi - 1e-6, theta)
    else:
        factor2 = np.where(below, 0.0, 1.0)
        theta = np.where(below, 0.5 * np.pi - 1e-6, theta)

    phi = (np.arange(width) + 0.5) * 2 * np.pi / width
    cos_gamma = (
        np.cos(theta)[:, None] * np.cos(zenith_sun)
        + np.sin(theta)[:, None]
        * np.sin(zenith_sun)
        * np.cos(phi[None, :] - azimuth_sun)
    )
    gamma = np.arccos(np.clip(cos_gamma, -1.0, 1.0))
    theta_2d = np.broadcast_to(theta[:, None], (height, width))

    color = radiance(config, rad, theta_2d, gamma) / 106.856980
    color = np.maximum(color, 0.0) * radiance_scale * factor2[:, None, None]
    return color.astype(np.float32)
