"""The end-to-end arithmetic, the trace's reductions and the comparison,
on synthetic data."""

import numpy as np
import pytest

from portbench import check, trace
from portbench.harness import end_to_end, load_module
from conftest import ROOT


def test_samples_per_s_counts_a_stall_in_the_window():
    calls = [(1_000_000, 1.0), (1_000_000, 1.0)]
    # a 1-s stall between the two calls: 2 Msamples over 3 s
    v = end_to_end(calls, window_s=3.0, setup_s=5.0, peak_bytes=1 << 30)
    assert v["samples_per_s"] == pytest.approx(2 / 3)
    assert v["peak_mem_gib"] == 1.0
    assert v["setup_s"] == 5.0


def test_pass_p90_is_over_every_pass():
    times = [0.1] * 89 + [0.2] * 10 + [5.0]
    v = end_to_end([(1, t) for t in times], window_s=sum(times),
                   setup_s=0, peak_bytes=0)
    # the 90th percentile of all 100 passes (numpy's linear rule), not of
    # a sample of them, and not their maximum
    assert v["pass_ms_p90"] == pytest.approx(np.percentile(times, 90) * 1e3)
    assert 100 < v["pass_ms_p90"] < 300


def test_idle_comes_from_the_union_of_overlapping_intervals():
    ev = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35)]
    assert trace.union_seconds(ev) == pytest.approx(30e-9)
    gaps = trace.idle_gaps(ev, (0, 50))
    assert gaps == [(20, 30), (40, 50)]
    read = load_module(ROOT / "portbench" / "metrics" / "device_idle_pct.py",
                       "idle").read
    ctx = {"device": ev, "busy_s": trace.union_seconds(ev), "window_s": 50e-9}
    assert read(ctx) == pytest.approx(40.0)
    assert read({"device": [], "busy_s": 0.0, "window_s": 1.0}) is None


def test_breakdown_names():
    host = [("cudaLaunchKernel", 0, 4), ("cudaMemcpyAsync", 10, 30)]
    assert trace.host_at(host, [2, 5, 20]) == [
        "cudaLaunchKernel", "host, outside any op", "cudaMemcpyAsync"]
    assert trace.top_by_name([("x", 1.0), ("y", 3.0), ("x", 2.5)]) == [
        ["x", 3.5], ["y", 3.0]]


def test_kernel_readers_find_their_kernels():
    dev = [("void dense_sweep_kernel<2, 1, false>(...)", 0, 2_000_000),
           ("march_kernel(...)", 0, 1_000_000), ("elementwise", 0, 5)]
    ctx = {"device": dev, "samples": 2_000_000}
    k1 = load_module(ROOT / "portbench/metrics/k1_ms_per_msample.py", "k1").read
    k2 = load_module(ROOT / "portbench/metrics/k2_ms_per_msample.py", "k2").read
    assert k1(ctx) == pytest.approx(1.0)
    assert k2(ctx) == pytest.approx(0.5)
    assert k2({"device": dev[:1], "samples": 1}) is None


def test_comparison_sees_bias_and_noise():
    rng = np.random.default_rng(0)
    p, m, k = 4096, 64, 16
    truth = rng.uniform(0.1, 1.0, (p, 1, 3))
    ref = truth + rng.normal(0, 0.5, (p, m, 3))
    region = np.repeat(np.arange(16), p // 16)

    def calls(n, scale=1.0, spp=k):
        return [(k, (truth[:, 0] + rng.normal(0, 0.5, (p, spp, 3)).mean(1))
                 * scale) for _ in range(n)]
    sound = check.compare(calls(4), ref, region)
    assert check.verdict(sound)[0], sound
    assert abs(sound["noise_ratio"] - 1) < 0.1
    biased = check.compare(calls(4, scale=1.1), ref, region)
    assert not check.verdict(biased)[0]
    half = check.compare(calls(4, spp=k // 2), ref, region)
    assert half["noise_log_ratio"] > 0.5 and not check.verdict(half)[0]
    same = calls(1) * 4
    assert not check.verdict(check.compare(same, ref, region))[0]


def test_pixels_drawn_from_the_seed():
    a = check.draw_pixels(100, 60, (4, 3), 20, 2 ** 33 + 5)
    b = check.draw_pixels(100, 60, (4, 3), 20, 2 ** 33 + 5)
    c = check.draw_pixels(100, 60, (4, 3), 20, 7)
    assert (a[0] == b[0]).all() and not (a[0] == c[0]).all()
    assert len(a[0]) == 240 and len(np.unique(a[0])) == 240
    assert a[0].max() < 6000


@pytest.mark.parametrize("ulps, correct", [(0, True), (8, True), (64, True),
                                           (2 ** 14, False)])
def test_noise_free_pixels_allow_rounding_alone(ulps, correct):
    # half the pixels see a sky (no noise), half are noisy; the program's
    # sky is off by `ulps` float32 ulps in every pixel alike (2^14 ulps:
    # bfloat16's rounding)
    rng = np.random.default_rng(1)
    p, m, k = 4096, 64, 16
    region = np.repeat(np.arange(16), p // 16)
    sky = np.float32([0.55, 0.65, 0.85])
    sky_px = region % 2 == 0
    truth = rng.uniform(0.1, 1.0, (p, 1, 3))
    ref = truth + rng.normal(0, 0.5, (p, m, 3))
    ref[sky_px] = sky
    off = (sky * np.float32(1 + ulps * 2.0 ** -23)).astype(np.float32)
    calls = []
    for _ in range(4):
        x = truth[:, 0] + rng.normal(0, 0.5, (p, k, 3)).mean(1)
        x[sky_px] = off
        calls.append((k, x))
    numbers = check.compare(calls, ref, region)
    assert (numbers["region_z"] <= check.LIMITS["region_z"]) == correct, numbers
