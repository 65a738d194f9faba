#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mcpt_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one short line each:
  env            torch/CUDA versions, the card's name and power limit
  build          nvcc build of every kernel in mcpt_tpu_torch/csrc
  kernel-K1      the dense sweep against its plain PyTorch version, closest
                 hit and any-hit, on (a) 16384 random triangles x 65536
                 random rays and (b) the Cornell box's triangles against a
                 512x512 frame's first tile of camera rays and first-bounce
                 rays; K1's times and roofline bound at (a), beside its time
                 before the redesign; then every kernel shape (slices per
                 ray x rays per thread) checked on 65536 random rays at 64
                 to 16384 random triangles and on (b)'s bounce rays
  render-cornell the main path: Renderer.render of the built-in Cornell box at
                 512x512, 16 spp, depth 8 (64k-ray tiles, spp chunks of 8),
                 timed after one warm-up frame; then a 64x64 card render
                 held against the same render on the CPU (plain versions)
  render-mesh    the box plus a 16200-triangle UV sphere (K1 at its design
                 size), 512x512, 4 spp, depth 8
  kernel-K2      the block march against its plain version, closest hit and
                 any-hit, on four inputs — 65536 camera rays and first-bounce
                 rays of the march scene, random rays in a random soup, and
                 the pair route's overflow-only fallback input on the pairs
                 scene — each at four settings (defaults, one chunk per
                 pick, super-chunk cull off, interval phase A on); each
                 time beside its bound and the time before the redesign;
                 camera and bounce rays
                 also at 32, 64, 128 and 256 rays per block
  kernel-K3K4    the corridor kernel against its plain version (slots and
                 overflow equal) and the pair sweep against its plain version
                 on the pairs scene's camera and bounce rays, then the whole
                 pair route against the plain per-lane march; times and bounds,
                 K4's time before the redesign, and the most distinct chunks
                 the pairs of one warp (and of one 512-pair block) name
  render-march   Renderer.render of the 51,236-triangle march scene at
                 512x512, 16 spp, depth 8 after a warm-up frame, through K2;
                 then a 64x64 card render held against the CPU render
  render-pairs   the same for the 105,012-triangle pairs scene, through K3
                 and K4 (and K2 for corridors longer than K)
  pairs-by-march the pairs scene's frame again with MCPT_TRAVERSAL=march,
                 beside render-pairs' wall: which route is faster on the card
  device-times   each kernel's device time per launch at its timed input,
                 and K1's shape sweep: every shape's device time at each
                 table size of kernel-K1 (the evidence for shape_for)
Kernel times ("ms") are the median time between CUDA events around one
wrapper call (cuda_ms), which also counts the wrapper's host time; each
kernel's device time per launch from torch.profiler (kernel_ms) is taken
last, after every frame, and printed beside it ("device_ms").
The last two lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero;
without a CUDA device the script exits 1 before printing any result.
A watchdog ends the run after WATCHDOG_S seconds, naming the phase.
"""

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

WATCHDOG_S = 900
RES, SPP, DEPTH, DEPTH_RR = 512, 16, 8, 5
TILE, SPP_CHUNK = 1 << 16, 8
#: bench.py's ray-count convention: per camera sample, the primary ray
#: plus a shadow ray and a continuation per bounce, ~5.5 bounces
AVG_BOUNCES = 5.5
#: fp32 operations per (ray, triangle) pair in csrc/dense_sweep.cu's inner
#: loop: p = d x e2 (9), det (5), t0 = o - p0 (3), v (6), q = t0 x e1 (9),
#: w (6), t (6), v + w (1), the division (1)
K1_OPS_PER_PAIR = 46
#: fp32 operations per (ray, chunk AABB) slab test in csrc/ray_tests.cuh's
#: chunk_entry: 6 subtractions, 6 multiplications, 6 min/max per axis, 4 to
#: combine the axes, 2 against [t_min, t_max], 2 compares, 1 clamp
SLAB_OPS = 27

_phase = ["start"]


def say(msg):
    print(msg, flush=True)


def _watchdog(signum, frame):
    say(f"watchdog: phase '{_phase[0]}' still running after {WATCHDOG_S} s")
    os._exit(1)


# ---------------------------------------------------------------- inputs


def random_tris(n, seed=0, spread=4.0, size=0.5):
    """Packed [n, 12] triangles as tests/test_bvh.py::random_soup, with
    random opaque flags so any-hit mode has work to skip."""
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, size=(n, 1, 3))
    v = (base + r.uniform(-size, size, size=(n, 3, 3))).astype(np.float32)
    packed = np.zeros((n, 12), np.float32)
    packed[:, 0:3] = v[:, 0]
    packed[:, 3:6] = v[:, 1] - v[:, 0]
    packed[:, 6:9] = v[:, 2] - v[:, 0]
    packed[:, 9] = r.uniform(size=n) < 0.7
    return packed


def random_rays(n, seed=1, spread=6.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


# ---------------------------------------------------------------- helpers


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of `fn()` over `reps` launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_ms(fn, kernel, reps=20, warmup=2):
    """Median device milliseconds of one launch of the CUDA kernel whose
    name holds `kernel`, over `reps` calls of `fn`, as torch.profiler
    (CUPTI) records them: the kernel's own time.  An event pair around one
    call (cuda_ms) also counts the wrapper's host time before the launch,
    tens of microseconds of checks and allocations, which is longer than
    some kernels here.  The profiler may drop some launches of a session;
    a session that keeps fewer than half is repeated, twice at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) > reps:
            raise AssertionError(f"kernel_ms: {len(us)} launches of {kernel} "
                                 f"recorded in {reps} calls")
        if 2 * len(us) >= reps:
            return float(np.median(us)) / 1e3
    raise AssertionError(f"kernel_ms: the profiler kept {len(us)} of {reps} "
                         f"launches of {kernel}")


#: device-time measurements queued by the kernel phases, taken by
#: phase_device_times after every frame is timed: the frames that this
#: script timed after torch.profiler sessions were up to 1.8x slower than
#: the same frames timed without them (PERF.md)
_device_jobs = []


def time_on_device(record, field, fn, kernel, reps=20):
    """Queue kernel_ms(fn, kernel, reps) into record[field]."""
    _device_jobs.append((record, field, fn, kernel, reps))


#: bytes of one hit record written: t, prim, v, w (4 each), inside, valid
HIT_BYTES = 4 + 4 + 4 + 4 + 1 + 1
#: bytes of a triangle row that a closest-hit test needs: p0, e1, e2 (an
#: any-hit test also reads the opaque flag; a prim id is read only for
#: each ray's winner)
ROW_BYTES = 9 * 4
#: the card's memory rate (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def peak_fp32():
    """(fp32 FLOP/s outside the tensor cores, how it was reckoned): SMs x
    128 lanes x 2 (a fused multiply-add) x the maximum SM clock."""
    import torch

    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return (props.multi_processor_count * 128 * 2 * clock_mhz * 1e6,
            f"{props.multi_processor_count} SMs x {clock_mhz:.0f} MHz")


def bound(ops, nbytes):
    """The least time the card could take: the larger of ops over the fp32
    peak and bytes over the memory rate.  Returns (ms, what bounds it)."""
    ops_ms = ops / peak_fp32()[0] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def same_hits(got, ref, o, d, tris, t_min, label, any_hit=False):
    """A kernel against its plain version, which rounds every multiply and
    add on its own in the same order (tests/test_pallas_pairs.py::
    _assert_same_hits, at tolerance 0): valid equal; in closest-hit mode
    t bit-equal and inside equal; prim may differ only where the kernel's
    triangle gives the same t bit for bit, and v, w are bit-equal where
    prim is equal.  In any-hit mode only valid is compared: K2's lanes
    stop at their first chunk with a hit, in another order than the
    plain version's.  tris: [P, 12] packed rows by global prim id.
    Returns (max |err| of t, v, w where compared, hits, prim ties)."""
    import torch

    from mcpt_tpu_torch.ops.intersect import intersect_triangle

    if not torch.equal(got.valid, ref.valid):
        raise AssertionError(f"{label}: valid differs on "
                             f"{int((got.valid != ref.valid).sum())} rays")
    m = ref.valid
    if any_hit:
        return 0.0, int(m.sum()), 0
    same = m & (got.prim == ref.prim)
    err = 0.0
    for name, sel in (("t", m), ("v", same), ("w", same)):
        x = (getattr(got, name) - getattr(ref, name))[sel].abs()
        err = max(err, float(x.max()) if x.numel() else 0.0)
    if err != 0.0 or not torch.equal(got.t, ref.t):
        raise AssertionError(f"{label}: t, v or w differs (max |err| {err})")
    if not torch.equal(got.inside[m], ref.inside[m]):
        raise AssertionError(f"{label}: inside differs")
    diff = m & ~same
    if bool(diff.any()):
        pid = got.prim[diff].long()
        hit, t, _, _, _ = intersect_triangle(
            o[diff], d[diff], tris[pid, 0:3], tris[pid, 3:6], tris[pid, 6:9],
            t_min[diff], torch.full_like(t_min[diff], 3.4e38))
        if not (bool(hit.all()) and torch.equal(t, ref.t[diff])):
            raise AssertionError(f"{label}: prim differs beyond exact ties")
    return err, int(m.sum()), int(diff.sum())


# ---------------------------------------------------------------- phases


def phase_env():
    import torch

    say(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("env: no CUDA device (torch.cuda.is_available() "
                         "is False) — chip_smoke needs the card")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    say(f"env: device {name} x{torch.cuda.device_count()}")
    say(f"env: nvidia-smi {smi}")
    return name, smi


def phase_build():
    from mcpt_tpu_torch import build

    info = build.build()
    say(f"build: {'built' if info['built'] else 'cached'} "
        f"{os.path.relpath(info['path'], HERE)} in {info['seconds']:.2f} s")
    for line in info["ptxas"]:
        say(f"build: {line}")
    build.library()


#: K1's and K4's times on the card before their redesign, between CUDA
#: events around one call (commit 4eb0709; NVIDIA H100 80GB HBM3, 700 W):
#: K1 at 65536 random rays x 16384 triangles, K4 on the pairs scene's
#: bounce pairs.  Printed beside this run's times, not in the kernels line
K1_BEFORE_MS = 3.757
K4_BEFORE_MS = 1.674
#: table sizes of K1's shape sweep besides (a)'s 16384: the first rows of
#: (a)'s table, against (a)'s rays
K1_SWEEP_SIZES = (64, 128, 256, 1024, 4096)


def _k1_pair(o, d, t_min, t_max, tris, label, refs=None, shape=None):
    """Closest and any-hit through K1 (at `shape`, else the wrapper's)
    and the plain version (or `refs`, its two results); checks both and
    returns the two same_hits results."""
    from mcpt_tpu_torch.ops import dense_sweep as ds

    errs = []
    for any_hit in (False, True):
        got = ds.dense_sweep(o, d, t_min, t_max, tris, any_hit=any_hit,
                             shape=shape)
        ref = (refs[any_hit] if refs is not None else
               ds.dense_sweep_plain(o, d, t_min, t_max, tris, any_hit=any_hit))
        # K1's any-hit mode keeps the nearest opaque hit: every output
        # is compared in both modes
        errs.append(same_hits(got, ref, o, d, tris, t_min,
                              f"{label} any_hit={any_hit}"))
    return errs


def phase_kernel(dev):
    import torch

    from mcpt_tpu_torch.ops import dense_sweep as ds
    from mcpt_tpu_torch.ops.math import MAX_FLOAT
    from mcpt_tpu_torch.render.camera import generate_rays, make_camera
    from mcpt_tpu_torch.scene.builtin import cornell_box
    from mcpt_tpu_torch.scene.compile import compile_scene

    # (a) design size: 16384 random triangles x 65536 random rays, every
    # 16th lane dead (t_max = 0) as in the regen wavefront
    n, p = 65536, 16384
    o_np, d_np = random_rays(n)
    o = torch.as_tensor(o_np, device=dev)
    d = torch.as_tensor(d_np, device=dev)
    tris = torch.as_tensor(random_tris(p), device=dev)
    t_min = torch.full((n,), 1e-4, device=dev)
    t_max = torch.full((n,), MAX_FLOAT, device=dev)
    t_max[::16] = 0.0
    max_err = 0.0
    for err, n_hit, n_tie in _k1_pair(o, d, t_min, t_max, tris, "K1(a)"):
        max_err = max(max_err, err)
    say(f"kernel-K1(a): {n}x{p} closest+any-hit match plain "
        f"(hits {n_hit}, prim ties {n_tie}, max|err| {max_err:.3g})")

    ms = cuda_ms(lambda: ds.dense_sweep(o, d, t_min, t_max, tris), reps=20)
    plain_ms = cuda_ms(
        lambda: ds.dense_sweep_plain(o, d, t_min, t_max, tris), reps=5, warmup=1)
    live = int((t_max > t_min).sum())
    nbytes = n * (3 + 3 + 1 + 1) * 4 + p * ROW_BYTES + n * HIT_BYTES
    bound_ms, bound_by = bound(K1_OPS_PER_PAIR * live * p, nbytes)
    say(f"kernel-K1(a): {ms:.3f} ms between events around one call at "
        f"shape {ds.shape_for(p)}; plain {plain_ms:.3f} ms; bound "
        f"{bound_ms:.3f} ms by {bound_by} at "
        f"{peak_fp32()[0] / 1e12:.1f} TFLOP/s fp32 peak ({peak_fp32()[1]}); "
        f"before the redesign {K1_BEFORE_MS} ms between events")

    # (b) the main path's shapes: the Cornell box's triangles against the
    # first 64k-ray tile of a 512x512 frame and its first-bounce rays
    cfg = cornell_box()
    scene = compile_scene(cfg, dev)
    cam = make_camera(cfg.camera, dev)
    tris_b = scene.geom.packed_tris
    pix = torch.arange(TILE, device=dev)
    r = np.random.default_rng(3)
    u = torch.as_tensor(r.uniform(size=TILE).astype(np.float32), device=dev)
    v = torch.as_tensor(r.uniform(size=TILE).astype(np.float32), device=dev)
    o_c, d_c = generate_rays(cam, pix, u, v)
    o_c, d_c = o_c.contiguous(), d_c.contiguous()
    lo = torch.full((TILE,), 1e-4, device=dev)
    hi = torch.full((TILE,), MAX_FLOAT, device=dev)
    first = ds.dense_sweep_plain(o_c, d_c, lo, hi, tris_b)
    o_b = (o_c + torch.clamp(first.t, max=1e8)[:, None] * d_c).contiguous()
    d_b = torch.as_tensor(r.normal(size=(TILE, 3)).astype(np.float32), device=dev)
    d_b = (d_b / d_b.norm(dim=-1, keepdim=True)).contiguous()
    hi_b = torch.where(first.valid, hi, torch.zeros_like(hi))
    for label, args in (("camera", (o_c, d_c, lo, hi)),
                        ("bounce", (o_b, d_b, lo, hi_b))):
        for err, _, _ in _k1_pair(*args, tris_b, f"K1(b) {label}"):
            max_err = max(max_err, err)
    ms_b = cuda_ms(lambda: ds.dense_sweep(o_b, d_b, lo, hi_b, tris_b), reps=20)
    plain_b = cuda_ms(
        lambda: ds.dense_sweep_plain(o_b, d_b, lo, hi_b, tris_b), reps=5)
    say(f"kernel-K1(b): cornell {TILE}x{tris_b.shape[0]} camera+bounce match "
        f"plain; bounce sweep {ms_b:.4f} ms between events (plain "
        f"{plain_b:.3f} ms)")

    rec = {
        "name": "dense_sweep", "route": "cuda",
        "source": "mcpt_tpu_torch/csrc/dense_sweep.cu",
        "replaces": "mcpt_tpu/ops/pallas_dense.py:31",
        "launches": None, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": f"{n} rays x {p} tris",
        "cornell_ms": ms_b, "cornell_plain_ms": plain_b,
        "sweep_device_ms": {},
    }
    time_on_device(rec, "device_ms",
                   lambda: ds.dense_sweep(o, d, t_min, t_max, tris),
                   "dense_sweep_kernel")
    time_on_device(rec, "cornell_device_ms",
                   lambda: ds.dense_sweep(o_b, d_b, lo, hi_b, tris_b),
                   "dense_sweep_kernel")

    # every kernel shape on (a)'s rays at each sweep size and on (b)'s
    # bounce rays, each held against the same plain results; their device
    # times are the evidence for shape_for
    sets = {f"{q} random": (o, d, t_min, t_max, tris[:q])
            for q in (*K1_SWEEP_SIZES, p)}
    sets[f"{tris_b.shape[0]} cornell bounce"] = (o_b, d_b, lo, hi_b, tris_b)
    for key, args in sets.items():
        refs = {a: ds.dense_sweep_plain(*args, any_hit=a) for a in (False, True)}
        row = rec["sweep_device_ms"][key] = {}
        for shape in ds.SHAPES:
            _k1_pair(*args, f"K1 {key} shape {shape}", refs, shape)
            time_on_device(row, f"{shape[0]}x{shape[1]}",
                           lambda args=args, shape=shape: ds.dense_sweep(
                               *args, shape=shape),
                           "dense_sweep_kernel", reps=10)
    say(f"kernel-K1: every shape {ds.SHAPES} matches plain, closest and any "
        f"hit, on {n} rays x " + ", ".join(sets) + " triangles")
    return rec


def _counters():
    from mcpt_tpu_torch.ops import dense_sweep as ds
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops import pair_sweep as psw

    return ((ds, "launches"), (ds, "any_hit_launches"),
            (msw, "launches"), (msw, "any_hit_launches"),
            (psw, "corridor_launches"), (psw, "pair_launches"))


def reset_counts():
    for mod, attr in _counters():
        setattr(mod, attr, 0)


def read_counts():
    """Kernel launches since reset_counts(): K1, K2 (and how many of each
    were any-hit), K3, K4."""
    c = {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
         for mod, attr in _counters()}
    return {
        "K1": c["dense_sweep.launches"],
        "K1_any": c["dense_sweep.any_hit_launches"],
        "K2": c["march_sweep.launches"],
        "K2_any": c["march_sweep.any_hit_launches"],
        "K3": c["pair_sweep.corridor_launches"],
        "K4": c["pair_sweep.pair_launches"],
    }


def _render_timed(renderer, spp, frame_base):
    """One timed frame; the kernel counts are set to 0 just before it and
    read just after."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = renderer.render(spp=spp, tile=TILE, spp_chunk=SPP_CHUNK,
                          frame_base=frame_base)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return img, wall, read_counts()


def _check_image(img, label):
    if not (np.isfinite(img).all() and (img >= 0).all()):
        raise AssertionError(f"{label}: image not finite and non-negative")


def phase_render_cornell(dev, smi):
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import cornell_box

    r = Renderer(cornell_box(), device=dev)
    r.render(spp=SPP, tile=TILE, spp_chunk=SPP_CHUNK)  # warm-up frame
    img, wall, counts = _render_timed(r, SPP, frame_base=1)
    n_any = counts["K1_any"]
    n_closest = counts["K1"] - n_any
    _check_image(img, "render-cornell")
    if n_closest <= 0 or n_any <= 0:
        raise AssertionError("render-cornell: K1 not launched in both modes "
                             f"(closest {n_closest}, any-hit {n_any})")
    rays = RES * RES * SPP * (1 + 2 * AVG_BOUNCES)
    say(f"render-cornell: {RES}x{RES} {SPP}spp d{DEPTH} wall {wall:.3f} s, "
        f"{rays / wall / 1e6:.2f} Mrays/s on {smi}; K1 launches "
        f"{n_closest} closest + {n_any} any-hit; mean "
        f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")

    card_vs_cpu(cornell_box, dev, "render-cornell")
    return n_closest + n_any


def card_vs_cpu(make_config, dev, label):
    """The same 64x64, 4 spp render on the card and on the CPU (plain
    versions), same seeds: >= 99% of pixels within rtol 1e-3, atol 1e-4,
    channel means within 1e-3 relative."""
    from mcpt_tpu_torch.render.renderer import Renderer

    small = make_config(res=64, spp=4)
    a = Renderer(small, device=dev).render(spp=4, tile=TILE, spp_chunk=4)
    b = Renderer(small, device="cpu").render(spp=4, tile=TILE, spp_chunk=4)
    _check_image(a, f"{label} 64x64")
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1)
    rel = np.abs(a.mean(axis=(0, 1)) / b.mean(axis=(0, 1)) - 1.0)
    say(f"{label}: 64x64 4spp card vs cpu: {close.mean() * 100:.2f}% "
        f"pixels within rtol 1e-3 atol 1e-4, channel means rel diff "
        f"{rel.max():.2e}")
    if close.mean() < 0.99 or rel.max() > 1e-3:
        raise AssertionError(f"{label}: card and CPU renders disagree")


def phase_render_mesh(dev, smi):
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import cornell_box

    spp = 4
    r = Renderer(cornell_box(spp=spp, sphere=True), device=dev)
    p = r.scene.geom.packed_tris.shape[0]
    img, wall, counts = _render_timed(r, spp, frame_base=0)
    _check_image(img, "render-mesh")
    rays = RES * RES * spp * (1 + 2 * AVG_BOUNCES)
    say(f"render-mesh: {p} prims {RES}x{RES} {spp}spp d{DEPTH} wall "
        f"{wall:.3f} s, {rays / wall / 1e6:.2f} Mrays/s on {smi}; K1 "
        f"launches {counts['K1'] - counts['K1_any']} closest + "
        f"{counts['K1_any']} any-hit")
    if counts["K1"] <= 0:
        raise AssertionError("render-mesh: K1 not launched")
    return counts["K1"]


def camera_and_bounce(scene, cam, dev, seed=3):
    """The main path's first two traces at their real shapes: 64k camera
    rays of a 512x512 frame (every 4th pixel, so that they cover the
    frame), and first-bounce rays from their hits in random directions
    (dead, t_max = 0, where the camera ray missed).  Returns
    [(label, o, d, t_min, t_max)]."""
    import torch

    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops.math import MAX_FLOAT
    from mcpt_tpu_torch.render.camera import generate_rays

    g = scene.geom
    pix = torch.arange(0, cam.width * cam.height, 4, device=dev)[:TILE]
    n = pix.shape[0]
    r = np.random.default_rng(seed)
    u = torch.as_tensor(r.uniform(size=n).astype(np.float32), device=dev)
    v = torch.as_tensor(r.uniform(size=n).astype(np.float32), device=dev)
    o_c, d_c = generate_rays(cam, pix, u, v)
    o_c, d_c = o_c.contiguous(), d_c.contiguous()
    lo = torch.full((n,), 1e-4, device=dev)
    hi = torch.full((n,), MAX_FLOAT, device=dev)
    first = msw.march_sweep_plain(o_c, d_c, lo, hi, g.march_min, g.march_max,
                                  g.march_tris, g.march_prim)
    o_b = (o_c + torch.clamp(first.t, max=1e8)[:, None] * d_c).contiguous()
    d_b = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32), device=dev)
    d_b = (d_b / d_b.norm(dim=-1, keepdim=True)).contiguous()
    hi_b = torch.where(first.valid, hi, torch.zeros_like(hi))
    return [("camera", o_c, d_c, lo, hi), ("bounce", o_b, d_b, lo, hi_b)]


def _scene(make_config, dev):
    from mcpt_tpu_torch.render.camera import make_camera
    from mcpt_tpu_torch.scene.compile import compile_scene

    cfg = make_config()
    return compile_scene(cfg, dev), make_camera(cfg.camera, dev)


def _march_args(g, o, d, lo, hi):
    """K2's inputs: the rays in the march wrapper's block order."""
    from mcpt_tpu_torch.ops.traversal import march_order

    order = march_order(g, o, d, lo, hi)
    return (o[order].contiguous(), d[order].contiguous(), lo[order], hi[order],
            g.march_min, g.march_max, g.march_tris, g.march_prim)


#: K2's settings, each timed and checked on every input: the defaults, one
#: chunk per pick, the super-chunk cull off, the interval phase A on
K2_SETTINGS = {
    "default": {},
    "one-chunk": {"MCPT_MARCH_GROUP": "1"},
    "super-off": {"MCPT_MARCH_SUPER": "0"},
    "interval": {"MCPT_MARCH_IVAL": "1"},
}
#: rays per K2 block timed by kernel-K2's block sweep
BLOCK_SWEEP = (32, 64, 128, 256)
#: K2's times on the card before its redesign (commit 0edd6bf; NVIDIA H100
#: 80GB HBM3, 700 W): the bounce set in chip_smoke, and the pair route's
#: fallback launch per profile_frame (over all N rays, ~1% live); the
#: camera and soup sets were not timed
K2_BEFORE_MS = {"camera": None, "bounce": 8.701, "soup": None, "fallback": 6.4}


@contextlib.contextmanager
def knobs(env):
    """Set environment knobs for the duration of a block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def k2_bound(args, block):
    """K2's bound on one input: what the function needs from this run's
    data.  Operations: 27 per slab test of a live ray against every chunk,
    46 per triangle of every chunk a lane must sweep (its entry below its
    final t).  Bytes, of the closest-hit call that is timed: t_min and
    t_max of every ray, o and d of the live ones, the chunk boxes, the
    rows of the chunks some lane sweeps (ROW_BYTES each), the prim id of
    each hit ray, every output once.  Also returns the lane-chunk sweeps and the chunk visits
    the blocks' unions hold."""
    import torch

    from mcpt_tpu_torch.ops import march_sweep as msw

    o, d, lo, hi, cmin, cmax, tris, prim = args
    lm, ls = prim.shape
    plain = msw.march_sweep_plain(*args)
    t_final = plain.t
    ent = msw.chunk_entry(o, d, lo, hi, cmin, cmax)
    need = ent < t_final[:, None]
    lane_visits = int(need.sum())
    pad = -len(o) % block
    ent_b = torch.cat([ent, ent.new_full((pad, lm), float("inf"))]
                      ).view(-1, block, lm).amin(dim=1)
    cap = torch.cat([torch.where(hi > lo, t_final, torch.zeros_like(t_final)),
                     t_final.new_zeros(pad)]).view(-1, block).amax(dim=1)
    block_visits = int((ent_b < cap[:, None]).sum())
    live = int((hi > lo).sum())
    swept = int(need.any(dim=0).sum())
    ops = K1_OPS_PER_PAIR * lane_visits * ls + SLAB_OPS * live * lm
    nbytes = (len(o) * 2 * 4 + live * 6 * 4 + lm * 6 * 4
              + swept * ls * ROW_BYTES + int(plain.valid.sum()) * 4
              + len(o) * HIT_BYTES)
    return (*bound(ops, nbytes), lane_visits, block_visits)


def fallback_input(dev):
    """The pair route's K2 input on the pairs scene's first-bounce rays:
    the rays whose corridor overflows K chunks, compacted and in block
    order, as the route gives them to K2.  Returns (label, geometry,
    args)."""
    from mcpt_tpu_torch.ops import pair_sweep as psw
    from mcpt_tpu_torch.ops.traversal import pair_inputs
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_pairs

    scene, cam = _scene(cornell_mesh_pairs, dev)
    g = scene.geom
    _, o, d, lo, hi = camera_and_bounce(scene, cam, dev)[1]
    overflow = pair_inputs(g, o, d, lo, hi, psw.pair_k())[0]
    idx = overflow.nonzero()[:, 0]
    return ("fallback", g, _march_args(g, o[idx], d[idx], lo[idx], hi[idx]))


def phase_kernel_k2(dev):
    import torch

    from mcpt_tpu_torch import build
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops.math import MAX_FLOAT
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_march
    from mcpt_tpu_torch.scene.geometry import commit_geometry

    scene, cam = _scene(cornell_mesh_march, dev)
    g = scene.geom
    block = msw.ray_block()
    sets = [(label, g, _march_args(g, *rays))
            for label, *rays in camera_and_bounce(scene, cam, dev)]
    # a random soup of 20000 triangles and random rays, every 16th dead
    soup = random_tris(20000, seed=5)
    verts = np.stack([soup[:, 0:3], soup[:, 0:3] + soup[:, 3:6],
                      soup[:, 0:3] + soup[:, 6:9]], axis=1)
    g_s = commit_geometry(verts, None, None, None, np.zeros(20000), dev,
                          tri_opaque=soup[:, 9] > 0.5)
    o_np, d_np = random_rays(TILE, seed=6)
    hi_s = torch.full((TILE,), MAX_FLOAT, device=dev)
    hi_s[::16] = 0.0
    sets.append(("soup", g_s, _march_args(
        g_s, torch.as_tensor(o_np, device=dev),
        torch.as_tensor(d_np, device=dev),
        torch.full((TILE,), 1e-4, device=dev), hi_s)))
    sets.append(fallback_input(dev))

    lib = build.library()
    max_err = 0.0
    times = {}
    for label, geom, args in sets:
        lm, ls = geom.march_prim.shape
        supers = (geom.march_super_min, geom.march_super_max)
        refs = [msw.march_sweep_plain(*args, any_hit=a) for a in (False, True)]
        bound_ms, bound_by, lane_visits, block_visits = k2_bound(args, block)
        before = K2_BEFORE_MS[label]
        for setting, env in K2_SETTINGS.items():
            with knobs(env):
                n_sup = (0 if msw.use_interval() or not msw.use_super_cull()
                         else supers[0].shape[0])
                cg, smem = msw.card_group(lib, ls, lm, block, n_sup)
                line = []
                for any_hit, ref in zip((False, True), refs):
                    got = msw.march_sweep(*args, any_hit=any_hit,
                                          supers=supers)
                    err, n_hit, n_tie = same_hits(
                        got, ref, args[0], args[1], geom.packed_tris, args[2],
                        f"K2 {label} {setting} any_hit={any_hit}", any_hit)
                    max_err = max(max_err, err)
                    line.append(f"{'any' if any_hit else 'closest'} hits "
                                f"{n_hit}"
                                + ("" if any_hit else f" ties {n_tie}"))
                ms = cuda_ms(lambda: msw.march_sweep(*args, supers=supers),
                             reps=20)
            times[(label, setting)] = ms
            say(f"kernel-K2 {label} {setting}: {len(args[0])} rays "
                f"({int((args[3] > args[2]).sum())} live) x {lm} chunks of "
                f"{ls}, block {block}, group {cg}, {smem} B smem: match plain "
                f"({', '.join(line)}); {ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"by {bound_by}, before the redesign "
                + (f"{before} ms" if before is not None else "not measured"))
        say(f"kernel-K2 {label}: {lane_visits} lane-chunk sweeps of {ls}, "
            f"block unions {block_visits} chunk visits")
        if label == "bounce":
            bounce = (args, bound_ms, bound_by, lm, ls)
            bounce_sup = supers
        if label in ("camera", "bounce"):
            # the evidence for the default block size: the same input at
            # each size, default knobs otherwise
            line = []
            for blk in BLOCK_SWEEP:
                with knobs({"MCPT_MARCH_BLOCK": str(blk)}):
                    ms_b = cuda_ms(lambda: msw.march_sweep(
                        *args, supers=supers), reps=10)
                line.append(f"{blk}: {ms_b:.4f}")
            say(f"kernel-K2 {label} block sweep (rays per block: ms): "
                + ", ".join(line))

    # the plain version's time, and the kernels line, on the bounce rays
    args, bound_ms, bound_by, lm, ls = bounce
    plain_ms = cuda_ms(lambda: msw.march_sweep_plain(*args), reps=3, warmup=1)
    ms = times[("bounce", "default")]
    say(f"kernel-K2 bounce: {ms:.4f} ms at the defaults (plain "
        f"{plain_ms:.3f} ms), bound {bound_ms:.4f} ms by {bound_by}; before "
        f"the redesign {K2_BEFORE_MS['bounce']} ms")
    rec = {
        "name": "march_sweep", "route": "cuda",
        "source": "mcpt_tpu_torch/csrc/march_sweep.cu",
        "replaces": "mcpt_tpu/ops/pallas_march.py:128",
        "launches": None, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": f"{len(args[0])} bounce rays x {lm} chunks of {ls}",
        "ms_by_input_and_setting": {f"{k[0]}/{k[1]}": v
                                    for k, v in times.items()},
    }
    time_on_device(rec, "device_ms",
                   lambda: msw.march_sweep(*args, supers=bounce_sup),
                   "march_kernel")
    return rec


def widest_run(chunk, lm, size):
    """The most distinct live chunk ids among `size` consecutive pairs
    (a run that starts at a multiple of `size`), as K4 sees them."""
    import torch

    pad = -len(chunk) % size
    c = torch.cat([chunk, chunk.new_full((pad,), lm)]).view(-1, size)
    c = torch.sort(c, dim=1)[0]
    new = torch.ones_like(c, dtype=torch.bool)
    new[:, 1:] = c[:, 1:] != c[:, :-1]
    return int((new & (c < lm)).sum(dim=1).max())


def phase_kernel_k3k4(dev):
    import torch

    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops import pair_sweep as psw
    from mcpt_tpu_torch.ops.traversal import _intersect_pairs, pair_inputs
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_pairs

    scene, cam = _scene(cornell_mesh_pairs, dev)
    g = scene.geom
    lm, ls = g.march_prim.shape
    k = psw.pair_k()
    sets = camera_and_bounce(scene, cam, dev)
    k3_err = k4_err = 0.0
    for label, o, d, lo, hi in sets:
        cargs = (o, d, lo, hi, g.march_min, g.march_max, k)
        slots, over = psw.corridor(*cargs)
        slots_p, over_p = psw.corridor_plain(*cargs)
        k3_err = max(k3_err, float((slots - slots_p).abs().max()),
                     float((over != over_p).sum()))
        if k3_err != 0.0:
            raise AssertionError(f"K3 {label}: slots or overflow differ")
        filled = int((slots < lm).sum())
        _, _, *pairs = pair_inputs(g, o, d, lo, hi, k)
        line = []
        for any_hit in (False, True):
            got = psw.pair_sweep(*pairs, g.march_tris, g.march_prim, any_hit)
            ref = psw.pair_sweep_plain(*pairs, g.march_tris, g.march_prim, any_hit)
            # K4 keeps each pair's nearest (opaque) hit in both modes
            err, n_hit, _ = same_hits(got, ref, pairs[0], pairs[1],
                                      g.packed_tris, pairs[2],
                                      f"K4 {label} any_hit={any_hit}")
            k4_err = max(k4_err, err)
            # the whole pair route against the plain per-lane march
            got_r = _intersect_pairs(g, o, d, lo, hi, any_hit)
            ref_r = msw.march_sweep_plain(o, d, lo, hi, g.march_min,
                                          g.march_max, g.march_tris,
                                          g.march_prim, any_hit)
            _, n_r, n_tie = same_hits(got_r, ref_r, o, d, g.packed_tris, lo,
                                      f"pairs route {label} any_hit={any_hit}",
                                      any_hit)
            line.append(f"{'any' if any_hit else 'closest'}: K4 pair hits "
                        f"{n_hit}, route hits {n_r}"
                        + ("" if any_hit else f" ties {n_tie}"))
        say(f"kernel-K3K4 {label}: {len(o)} rays x {lm} chunks, K={k}: K3 "
            f"slots equal ({filled} filled, {int(over.sum())} overflow); "
            + "; ".join(line))

    # time and bound on the main path's bounce rays
    o, d, lo, hi = sets[1][1:]
    cargs = (o, d, lo, hi, g.march_min, g.march_max, k)
    k3_ms = cuda_ms(lambda: psw.corridor(*cargs), reps=20)
    k3_plain = cuda_ms(lambda: psw.corridor_plain(*cargs), reps=3, warmup=1)
    n = len(o)
    live = int((hi > lo).sum())  # a dead ray's corridor is empty untested
    k3_bound, k3_by = bound(SLAB_OPS * live * lm,
                            n * 2 * 4 + live * 6 * 4 + lm * 6 * 4
                            + n * k * 4 + n)
    _, _, *pairs = pair_inputs(g, o, d, lo, hi, k)
    pargs = (*pairs, g.march_tris, g.march_prim)
    k4_ms = cuda_ms(lambda: psw.pair_sweep(*pargs), reps=20)
    k4_plain = cuda_ms(lambda: psw.pair_sweep_plain(*pargs), reps=3, warmup=1)
    m = len(pairs[0])
    live_c = pairs[4][pairs[4] < lm]
    live_pairs = len(live_c)
    # a dead pair needs only its chunk id and t_max (its output t); a live
    # one its ray and t_min too, and the rows of the chunks live pairs name
    # (ROW_BYTES each, closest hit); a hit pair the prim id of its winner
    k4_hits = int(psw.pair_sweep_plain(*pargs).valid.sum())
    k4_bytes = (m * 2 * 4 + live_pairs * 7 * 4
                + int(torch.unique(live_c).numel()) * ls * ROW_BYTES
                + k4_hits * 4 + m * HIT_BYTES)
    k4_bound, k4_by = bound(K1_OPS_PER_PAIR * live_pairs * ls, k4_bytes)
    say(f"kernel-K3 bounce: {k3_ms:.4f} ms between events around one call "
        f"(plain {k3_plain:.3f} ms), bound "
        f"{k3_bound:.4f} ms by {k3_by} ({live} live of {n} rays x {lm} "
        f"slab tests)")
    say(f"kernel-K4 bounce: {k4_ms:.4f} ms between events around one call "
        f"(plain {k4_plain:.3f} ms), bound "
        f"{k4_bound:.4f} ms by {k4_by} ({live_pairs} live of {m} pairs x "
        f"{ls} triangles); before the redesign {K4_BEFORE_MS} ms between "
        f"events")
    widest = {size: widest_run(pairs[4], lm, size) for size in (32, 512)}
    say(f"kernel-K4 bounce: the widest warp's 32 pairs name {widest[32]} "
        f"distinct chunks, the widest 512-pair block's {widest[512]}")
    common = {"route": "cuda", "source": "mcpt_tpu_torch/csrc/pair_sweep.cu",
              "launches": None, "library_ms": None}
    k3 = dict(common, name="corridor", replaces="mcpt_tpu/ops/pallas_pairs.py:227",
             max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
             bound_ms=k3_bound, bound_by=k3_by,
             shape=f"{n} bounce rays x {lm} chunks, K={k}")
    k4 = dict(common, name="pair_sweep", replaces="mcpt_tpu/ops/pallas_pairs.py:84",
             max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
             bound_ms=k4_bound, bound_by=k4_by,
             shape=f"{live_pairs} live of {m} pairs x {ls} triangles",
             widest_warp_chunks=widest[32])
    time_on_device(k3, "device_ms", lambda: psw.corridor(*cargs),
                   "corridor_kernel")
    time_on_device(k4, "device_ms", lambda: psw.pair_sweep(*pargs),
                   "pair_kernel")
    return k3, k4


def phase_render_route(dev, smi, label, make_config, route, kernels,
                       against_cpu=True):
    """Renderer.render of a mesh scene above DENSE_MAX_PRIMS at full width
    after a warm-up frame; the route's kernels must have launched.
    Returns the kernel counts and the frame's wall."""
    from mcpt_tpu_torch.ops.traversal import resolved_strategy
    from mcpt_tpu_torch.render.renderer import Renderer

    r = Renderer(make_config(), device=dev)
    g = r.scene.geom
    if resolved_strategy(g) != route:
        raise AssertionError(f"{label}: route {resolved_strategy(g)}, "
                             f"expected {route}")
    r.render(spp=SPP, tile=TILE, spp_chunk=SPP_CHUNK)  # warm-up frame
    img, wall, counts = _render_timed(r, SPP, frame_base=1)
    _check_image(img, label)
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched ({counts})")
    rays = RES * RES * SPP * (1 + 2 * AVG_BOUNCES)
    say(f"{label}: {int(g.opaque.sum())} triangles, {g.n_march_leaves} "
        f"chunks of {g.march_leaf}, route {route}; {RES}x{RES} {SPP}spp "
        f"d{DEPTH} wall {wall:.3f} s, {rays / wall / 1e6:.2f} Mrays/s on "
        f"{smi}; launches K2 {counts['K2']} ({counts['K2_any']} any-hit), "
        f"K3 {counts['K3']}, K4 {counts['K4']}, K1 {counts['K1']}; mean "
        f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")
    if against_cpu:
        card_vs_cpu(make_config, dev, label)
    return counts, wall


def phase_pairs_by_march(dev, smi, pairs_wall):
    """The pairs scene forced down the block march (MCPT_TRAVERSAL=march),
    timed as render-pairs was: the evidence on this card for the auto
    rule, which sends scenes of chunks under 256 prims to the pair route."""
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_pairs

    with knobs({"MCPT_TRAVERSAL": "march"}):
        counts, wall = phase_render_route(
            dev, smi, "pairs-by-march", cornell_mesh_pairs, "march", ("K2",),
            against_cpu=False)
    if counts["K3"] or counts["K4"]:
        raise AssertionError(f"pairs-by-march: K3/K4 launched ({counts})")
    faster = "pairs" if pairs_wall < wall else "march"
    say(f"pairs-by-march: the pairs scene's frame takes {pairs_wall:.3f} s "
        f"by the pair route and {wall:.3f} s by the block march on {smi}: "
        f"the {faster} route is faster here")


def phase_device_times(k1, k2, k3, k4):
    """The queued device times (time_on_device), after every frame."""
    for record, field, fn, kernel, reps in _device_jobs:
        record[field] = kernel_ms(fn, kernel, reps=reps)
    for rec, label in ((k1, "K1(a)"), (k2, "K2 bounce"), (k3, "K3 bounce"),
                       (k4, "K4 bounce")):
        say(f"device-times: {label} {rec['device_ms']:.4f} ms of device time "
            f"a launch (between events {rec['ms']:.4f} ms)")
    say(f"device-times: K1(b) cornell bounce {k1['cornell_device_ms']:.4f} ms "
        f"of device time a launch (between events {k1['cornell_ms']:.4f} ms)")
    from mcpt_tpu_torch.ops import dense_sweep as ds

    for key, row in k1["sweep_device_ms"].items():
        say(f"device-times: K1 shape sweep, {key} triangles (slices x rays "
            f"per thread: ms of device time a launch; the wrapper takes "
            f"{ds.shape_for(int(key.split()[0]))}): "
            + ", ".join(f"{k}: {v:.4f}" for k, v in row.items()))


def main():
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    t_start = time.perf_counter()

    _phase[0] = "env"
    name, smi = phase_env()
    import torch

    dev = torch.device("cuda", 0)
    _phase[0] = "build"
    phase_build()
    _phase[0] = "kernel-K1"
    k1 = phase_kernel(dev)
    _phase[0] = "render-cornell"
    n_cornell = phase_render_cornell(dev, smi)
    _phase[0] = "render-mesh"
    n_mesh = phase_render_mesh(dev, smi)
    # K1's time is taken at render-mesh's triangle count (16384), and
    # cornell_ms at render-cornell's: each beside its own path's launches
    k1["launches"] = n_mesh
    k1["cornell_launches"] = n_cornell
    _phase[0] = "kernel-K2"
    k2 = phase_kernel_k2(dev)
    _phase[0] = "kernel-K3K4"
    k3, k4 = phase_kernel_k3k4(dev)

    from mcpt_tpu_torch.scene.builtin import cornell_mesh_march, cornell_mesh_pairs

    _phase[0] = "render-march"
    c_m, _ = phase_render_route(dev, smi, "render-march", cornell_mesh_march,
                                "march", ("K2",))
    _phase[0] = "render-pairs"
    c_p, pairs_wall = phase_render_route(dev, smi, "render-pairs",
                                         cornell_mesh_pairs, "pairs",
                                         ("K3", "K4"))
    _phase[0] = "pairs-by-march"
    phase_pairs_by_march(dev, smi, pairs_wall)
    _phase[0] = "device-times"
    phase_device_times(k1, k2, k3, k4)
    k2["launches"] = c_m["K2"] + c_p["K2"]
    k2["launches_by_path"] = {"render-march": c_m["K2"],
                              "render-pairs": c_p["K2"]}
    k3["launches"] = c_p["K3"]
    k4["launches"] = c_p["K4"]

    signal.alarm(0)
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [k1, k2, k3, k4]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
