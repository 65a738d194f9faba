"""Spectrum -> RGB conversion (counterpart of mcpt_tpu/scene/spectrum.py;
csrt src/parser/spectrum.cpp).

CIE 1931 XYZ color-matching functions at 1nm (360-830, public data,
cie_data.npz) resampled into 60 bands over [400, 700] nm, piecewise-
linear spectrum averaging, XYZ -> linear sRGB — numerically matching
SpectrumToRgb (spectrum.cpp:562-595).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "cie_data.npz")

XYZ_SAMPLES = 60
XYZ_WL_START = 400.0
XYZ_WL_END = 700.0
CIE_Y_INTEGRAL = 106.856895


def average_spectrum(wavelengths, amplitudes, l0, l1, n=32):
    """Mean of the piecewise-linear spectrum over [l0, l1]
    (spectrum.cpp AverageSpectrumSamples, via dense sampling)."""
    ls = np.linspace(l0, l1, n)
    return float(np.interp(ls, wavelengths, amplitudes).mean())


@functools.lru_cache(maxsize=1)
def _cie_bands():
    data = np.load(_DATA)
    w = data["wavelengths"]
    bands = np.linspace(XYZ_WL_START, XYZ_WL_END, XYZ_SAMPLES + 1)
    out = []
    for table in (data["x"], data["y"], data["z"]):
        vals = [
            average_spectrum(w, table, bands[i], bands[i + 1])
            for i in range(XYZ_SAMPLES)
        ]
        out.append(np.asarray(vals))
    return out


def spectrum_to_rgb(wavelengths, amplitudes) -> np.ndarray:
    """Linear sRGB of a piecewise-linear spectrum (spectrum.cpp:562-595)."""
    X, Y, Z = _cie_bands()
    bands = np.linspace(XYZ_WL_START, XYZ_WL_END, XYZ_SAMPLES + 1)
    amp = np.array(
        [
            average_spectrum(wavelengths, amplitudes, bands[i], bands[i + 1])
            for i in range(XYZ_SAMPLES)
        ]
    )
    xyz = np.array([(X * amp).sum(), (Y * amp).sum(), (Z * amp).sum()])
    xyz *= (XYZ_WL_END - XYZ_WL_START) / (CIE_Y_INTEGRAL * XYZ_SAMPLES)
    m = np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ]
    )
    return np.maximum(m @ xyz, 0.0).astype(np.float32)


# --- Preetham atmospheric tables (sun_sky.cpp:24-67; data from
# "A Practical Analytic Model for Daylight", Preetham et al.)

K_O_WL = np.array([
    300, 305, 310, 315, 320, 325, 330, 335, 340, 345, 350, 355, 445,
    450, 455, 460, 465, 470, 475, 480, 485, 490, 495, 500, 505, 510,
    515, 520, 525, 530, 535, 540, 545, 550, 555, 560, 565, 570, 575,
    580, 585, 590, 595, 600, 605, 610, 620, 630, 640, 650, 660, 670,
    680, 690, 700, 710, 720, 730, 740, 750, 760, 770, 780, 790], float)
K_O_AMP = np.array([
    10.0, 4.8, 2.7, 1.35, .8, .380, .160, .075, .04, .019, .007,
    .0, .003, .003, .004, .006, .008, .009, .012, .014, .017, .021,
    .025, .03, .035, .04, .045, .048, .057, .063, .07, .075, .08,
    .085, .095, .103, .110, .12, .122, .12, .118, .115, .12, .125,
    .130, .12, .105, .09, .079, .067, .057, .048, .036, .028, .023,
    .018, .014, .011, .010, .009, .007, .004, .0, .0], float)
K_G_WL = np.array([759, 760, 770, 771], float)
K_G_AMP = np.array([0, 3.0, 0.210, 0], float)
K_WA_WL = np.array([689, 690, 700, 710, 720, 730, 740,
                    750, 760, 770, 780, 790, 800], float)
K_WA_AMP = np.array([0, 0.160e-1, 0.240e-1, 0.125e-1, 0.100e+1, 0.870,
                     0.610e-1, 0.100e-2, 0.100e-4, 0.100e-4, 0.600e-3,
                     0.175e-1, 0.360e-1], float)
SOLAR_WL = np.arange(380, 751, 10, dtype=float)
SOLAR_AMP = np.array([
    16559.0, 16233.7, 21127.5, 25888.2, 25829.1, 24232.3, 26760.5, 29658.3,
    30545.4, 30057.5, 30663.7, 28830.4, 28712.1, 27825.0, 27100.6, 27233.6,
    26361.3, 25503.8, 25060.2, 25311.6, 25355.9, 25134.2, 24631.5, 24173.2,
    23685.3, 23212.1, 22827.7, 22339.8, 21970.2, 21526.7, 21097.9, 20728.3,
    20240.4, 19870.8, 19427.2, 19072.4, 18628.9, 18259.2], float)


def sun_radiance_rgb(zenith: float, turbidity: float) -> np.ndarray:
    """Solar-disk radiance in RGB after atmospheric attenuation — exact
    port of GetSunRadiance (sun_sky.cpp:67-152): solar spectrum x
    Rayleigh, aerosol, ozone, mixed-gas, water-vapor transmittances at
    5nm steps over [350, 800], converted through spectrum_to_rgb."""
    beta = 0.04608365822050 * turbidity - 0.04586025928522
    m = 1.0 / (
        np.cos(zenith)
        + 0.15 * np.power(93.885 - np.degrees(zenith), -1.253)
    )
    lam = np.arange(350.0, 805.0, 5.0)  # 91 samples
    lam_um = lam / 1000.0
    tau_r = np.exp(-m * 0.008735 * np.power(lam_um, -4.08))
    tau_a = np.exp(-m * beta * np.power(lam_um, -1.3))
    k_o = np.interp(lam, K_O_WL, K_O_AMP)
    tau_o = np.exp(-m * k_o * 0.35)
    k_g = np.interp(lam, K_G_WL, K_G_AMP)
    tau_g = np.exp(
        -1.41 * k_g * m / np.power(1 + 118.93 * k_g * m, 0.45)
    )
    k_wa = np.interp(lam, K_WA_WL, K_WA_AMP)
    w = 2.0
    tau_va = np.exp(
        -0.2385 * k_wa * w * m / np.power(1 + 20.07 * k_wa * w * m, 0.45)
    )
    solar = np.interp(lam, SOLAR_WL, SOLAR_AMP)
    data = solar * tau_r * tau_a * tau_o * tau_g * tau_va
    return spectrum_to_rgb(lam, data)
