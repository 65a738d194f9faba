"""The comparison that decides `correct`.

The program's calls in the window each return a film of k samples a
pixel.  On a set of pixels drawn from the seed (the same number in each
cell of a grid of regions over the film), the plain reference
(`reference/`) draws m samples of its own, with the same per-sample
horizontal offsets as the renderer's strata.  Both sides then estimate
the same pixel values, and under a correct program their difference is
noise of known size:

* `region_z`: the largest |z| over regions and channels of the summed
  difference (the program's mean over its distinct calls minus the
  reference's), each over its standard error from the reference's
  per-sample variance, var (1/n + 1/m), n the program's samples, plus
  float32's rounding (`ROUNDING`) summed over the region's pixels;
  (the reference's per-sample variance: k times that of its means over
  groups of k, which the strata make smaller than that of single
  samples, as they do the program's);
* `global_z`: the same over all the drawn pixels, a channel at a time
  (the largest |z| of the three);
* `noise_log_ratio`: |ln| of the program's per-sample variance, read
  from the spread of its first G calls, over the reference's, read from
  the spread of its G groups at the same frame bases (so that both hold
  the same share from where the samples sit in the pixel), pooled over
  the drawn pixels and channels.  A call that returns fewer samples than
  it was asked for, or the same film again, moves it; the two z do not
  see either.

`correct` holds when each number is at most its limit.  The limits are
set from the readings of sound runs and of the control (PERF.md).
"""

from __future__ import annotations

import math

import numpy as np

LIMITS = {"region_z": 8.0, "global_z": 8.0, "noise_log_ratio": 0.3}
#: float32 rounding allowed a pixel, as a share of its value (~84 ulps of
#: 2^-23), summed over the pixels of a sum, not in quadrature: a pixel
#: with no noise (the sky, the light seen directly) rounds alike in every
#: pixel of a region, and only such pixels make this term matter
ROUNDING = 1e-5


def draw_pixels(width, height, regions, per_region, seed):
    """(linear pixel indices [P] int64, region of each [P]): `per_region`
    distinct pixels drawn uniformly in each of regions = (rx, ry) equal
    cells of the film."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                 (int(seed) >> 32) & 0xFFFFFFFF, 17])
    rx, ry = regions
    xs = np.linspace(0, width, rx + 1).astype(int)
    ys = np.linspace(0, height, ry + 1).astype(int)
    pix, reg = [], []
    for b in range(ry):
        for a in range(rx):
            w, h = xs[a + 1] - xs[a], ys[b + 1] - ys[b]
            k = rng.choice(w * h, size=min(per_region, w * h), replace=False)
            pix.append((ys[b] + k // w) * width + xs[a] + k % w)
            reg.append(np.full(len(k), b * rx + a))
    return np.concatenate(pix).astype(np.int64), np.concatenate(reg)


def compare(calls, ref, region):
    """The numbers compared.  calls: [(k, X [P, 3])] the distinct calls'
    films at the drawn pixels in the window's order, k samples a pixel
    each; ref: [P, G k, 3] the reference's samples there, in G groups of
    k at the frame bases of the first G calls (reference.samples);
    region: [P] region ids."""
    ks = np.array([k for k, _ in calls], np.float64)
    xs = np.stack([np.asarray(x, np.float64) for _, x in calls])     # [C, P, 3]
    k = int(ks[0])
    n = ks.sum()
    y = (ks[:, None, None] * xs).sum(0) / n
    ref = np.asarray(ref, np.float64)
    m = ref.shape[1]
    groups = ref.reshape(ref.shape[0], m // k, k, 3).mean(2)
    g = groups.shape[1]
    r_mean = groups.mean(1)
    r_var = k * groups.var(1, ddof=1)       # per sample, from the groups
    diff = y - r_mean
    var = r_var * (1.0 / n + 1.0 / m)
    rounding = ROUNDING * np.abs(r_mean)

    def z(sel):
        err = np.sqrt(var[sel].sum(0)) + rounding[sel].sum(0)
        return diff[sel].sum(0) / np.maximum(err, 1e-30)
    region_z = float(np.abs(np.stack([z(region == r)
                                      for r in np.unique(region)])).max())
    global_z = float(np.abs(z(slice(None))).max())
    # the program's spread over the calls at the reference's bases
    first = xs[:g]
    s2 = k * first.var(0, ddof=1)
    ratio = float(s2.sum() / max(r_var.sum(), 1e-30))
    return {"region_z": region_z, "global_z": global_z,
            "noise_log_ratio": abs(math.log(max(ratio, 1e-30))),
            "noise_ratio": ratio, "program_spp": n, "reference_spp": m,
            "calls": len(calls), "pixels": int(len(region))}


def verdict(numbers):
    """(correct, [(name, number, limit)]) of the numbers compared."""
    rows = [(k, numbers[k], lim) for k, lim in LIMITS.items()]
    return all(v <= lim for _, v, lim in rows), rows
