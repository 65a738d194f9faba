#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mcpt_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one short line each:
  env            torch/CUDA versions, the card's name and power limit
  build          nvcc build of every kernel in mcpt_tpu_torch/csrc, and gcc's
                 of the host's EXR PIZ decoder (csrc/piz.c)
  kernel-K1      the dense sweep against its plain PyTorch version, closest
                 hit and any-hit, on (a) 16384 random triangles x 65536
                 random rays and (b) the Cornell box's triangles against a
                 512x512 frame's first tile of camera rays and first-bounce
                 rays, (c) the lights scene's camera, bounce and alpha-walk
                 rays and (d) the volumetric-caustic scene's shadow rays
                 across its null faces; K1's times and roofline bound at
                 (a), beside its time before the redesign; K1's autograd
                 backward (DenseClosestHit, plain torch) timed at (a) and
                 its gradients held against the CPU's; then every
                 kernel shape (slices per ray x rays per thread) checked on
                 65536 random rays at 64 to 16384 random triangles and on
                 (b)'s bounce rays
  render-cornell the main path: Renderer.render of the built-in Cornell box at
                 512x512, 16 spp, depth 8 (64k-ray tiles, spp chunks of 8),
                 timed after one warm-up frame; then a 64x64 card render
                 held against the same render on the CPU (plain versions)
  render-mesh    the box plus a 16200-triangle UV sphere (K1 at its design
                 size), 512x512, 4 spp, depth 8
  kernel-K2      the block march against its plain version, closest hit and
                 any-hit, on five inputs — 65536 camera rays and first-bounce
                 rays of the march scene, random rays in a random soup, the
                 pair route's overflow-only fallback input on the pairs
                 scene, and the batched body's input on the materials scene
                 (65536 continuations and 65536 shadow segments with finite
                 t_max, coherence classes 0-3: 131072 lanes) and on the
                 envmap scene (its shadow segments toward envmap samples,
                 t_max = MAX_FLOAT/2 - 1e-4) — each at four
                 settings (defaults, one chunk per pick, super-chunk cull
                 off, interval phase A on); each time beside its bound and
                 the time before the redesign; camera and bounce rays
                 also at 32, 64, 128 and 256 rays per block
  kernel-K3K4    the corridor kernel against its plain version (slots and
                 overflow equal) and the pair sweep against its plain version
                 on the pairs scene's camera and bounce rays, then the whole
                 pair route against the plain per-lane march; the corridor
                 kernel also on the card tests' edge cases (CORRIDOR_CASES)
                 at K = 1, 2, 8, 14; times and bounds (K3: for the slab tests
                 it performs and for the full sweep), K3's and K4's times
                 before the redesign, and the most distinct chunks the pairs
                 of one warp (and of one 512-pair block) name
  kernel-K5      the per-ray BVH walk of the packet route against its plain
                 version, closest hit and any-hit (all six outputs
                 bit-equal, 0 ties), on the march scene's 65536 camera and
                 first-bounce rays, the batched body's 131072-lane input of
                 the materials scene and 65536 random rays in a
                 16384-triangle soup, each in the packet route's order;
                 times, the kernel's registers and spills (ptxas), node
                 visits a ray, and on the batched input the plain
                 version's time, the bound from the walk's own tests and
                 the packet walk's time and bound before the redesign
  render-march   Renderer.render of the 51,236-triangle march scene at
                 512x512, 16 spp, depth 8 after a warm-up frame, through K2
                 and the batched regen body (closest hit only); then a 64x64
                 card render held against the CPU render
  march-unbatched the same frame with MCPT_BATCH_TRACE=0 (the unbatched
                 body: continuation and any-hit shadow rays traced apart),
                 alternating with the batched body, MARCH_FRAMES frames a
                 side: both walls with their spread
  render-materials the march scene in every BSDF family plus a thin pane
                 (cornell_mesh_materials, 51,238 triangles) at 512x512,
                 MATERIALS_SPP (4) spp, depth 8 after a 1-spp warm-up
                 frame, through the batched body and K2; then a 64x64 card
                 render held against the CPU render
  render-pairs   the same for the 105,012-triangle pairs scene, through K3
                 and K4 (and K2 for corridors longer than K)
  pairs-by-march the pairs scene's frame again with MCPT_TRAVERSAL=march,
                 beside render-pairs' wall: which route is faster on the card
  render-packet  the march scene with MCPT_TRAVERSAL=packet at 512x512, 16
                 spp, depth 8 after a 1-spp warm-up frame, through the
                 batched body and K5 alone (no K1-K4 launch); then a 64x64,
                 1 spp, depth 3 card render held against the CPU's render
                 of every pixel (PACKET_CHECK)
  coh            the march scene at 64x64, 4 spp with MCPT_COH=1 through
                 the unbatched body, card vs CPU; the origin-chunk keys
                 must reach the march's ray order; the card image without
                 the option must be equal bit for bit
  render-envmap  the matpreview-class scene lit by a 2048x1024 HDR envmap
                 alone (envmap_matpreview: the 51,200-triangle sphere in
                 rough gold, a bump-mapped cube, a bitmap floor) at 512x512,
                 16 spp, depth 8 after a warm-up frame, through the batched
                 body and K2; the envmap's alias build timed; then a 64x64
                 card render held against the CPU render
  render-lights  the emitter and texture test scene (lights_showcase:
                 analytic spheres, a disk and a cylinder, glossy plates, a
                 checkerboard, alpha-masked quads, point, spot, directional,
                 sun and constant-sky lights) the same way but at
                 LIGHTS_SPP (1) spp after a 1-spp warm-up frame, through K1 and
                 the unbatched body: every shadow query walks its alpha
                 crossings by closest hits, so K1 makes 1 + 6 x 4 closest-hit
                 launches a wavefront iteration and no any-hit one
  render-volcaustic the volumetric-caustic scene (volumetric_caustic: a
                 glass sphere in a box of isotropic fog behind null faces,
                 a small area light above) through the volpath integrator's
                 regen body at 512x512, 16 spp, depth 16 after a 1-spp
                 warm-up frame: K1 closest-hit and any-hit launches (the
                 shadow rays cross the fog's null faces), none of K2-K4;
                 then 64x64 card renders held against the CPU's for the
                 isotropic and the Henyey-Greenstein (g = -0.5) fog
  engine-chunked the chunked per-sample engine (render_pixels and the
                 integrators' shade): 64x64 card renders held against the
                 CPU's on the Cornell box (path.shade) and the isotropic
                 volumetric-caustic scene (volpath.shade)
  s1-means       the rounding-amplifying test scene (bump_and_bead: a
                 ripple bump map and an emissive sphere of radius 0.02),
                 64x64 4 spp card vs CPU: the share of pixels close is
                 printed, the channel means must agree within 1e-3
  sharded        multi-device rendering (parallel/): (c) a process in an
                 NCCL job of world size 1 and (d) two processes sharing
                 the card over gloo, started together (this script with
                 --sharded-worker), render the 128x128, 16 spp Cornell
                 film by render_film_multihost (bit-equal to one
                 render_pixels call) and take one all-reduced 64x64, 2 spp
                 train step (within 1e-4 of one process's); each must say
                 it rendered on cuda; (b) make_train_step over [card] * 2
                 against [card]; (a) render_film_sharded of the Cornell box
                 at 512x512, 16 spp over [card] * 3, bit-equal to one
                 render_pixels call, both walls
  device-times   each kernel's device time per launch at its timed input
                 (K5's on the batched input),
                 and K1's shape sweep: every shape's device time at each
                 table size of kernel-K1 (the evidence for shape_for); then
                 one tile-chunk of render-packet's, render-envmap's,
                 render-lights' (at LIGHTS_PROFILE_SPP, 1 spp) and
                 render-volcaustic's frames
                 under torch.profiler: device busy time, idle share against
                 the same tile-chunk unprofiled, device activities, K1
                 launches
  render-bdpt    the glass-sphere caustic without fog (bdpt_caustic) by
                 BDPT through the chunked engine, 512x512, BDPT_SPP (1) spp, depth 8
                 after a 1-spp warm-up frame: K1 alone, exactly 11 closest
                 and 28 any-hit launches a sample-tile; then the 64x64
                 card render against the CPU's
  grad           (a) make_train_step on the envmap scene (the march route,
                 detached) at 512x512, 4 spp, families textures and bsdf,
                 in 65536-pixel pieces, against a target rendered at other
                 parameters: wall, peak device memory, each gradient's norm
                 (finite; the atlas's, reflectivity's and edge tint's
                 nonzero); (b) the train step's loss
                 and gradients on the card against the CPU's at 64x64, 2
                 spp: the volumetric caustic's media and the caustic's
                 glass eta by the path integrator (K1's backward); after
                 cli, one sample-tile of render-bdpt and one 1-spp piece of
                 grad (a)'s step profiled as in device-times.  These
                 phases run after device-times: its kernel_ms sessions kept
                 too few launches when they ran before it
  cli            two scene files written here, rendered each by
                 mcpt_tpu_torch.cli.main (-i scene.xml -o out.exr) at
                 512x512, 16 spp, depth 8: cornell.xml (builtin.cornell_box's
                 layout, walls and light as rectangles, the boxes from an OBJ
                 file; K1 alone) and matpreview.xml (a 61,440-triangle sphere
                 from a binary PLY in a named rough conductor, a rough
                 plastic with an EXR bitmap, a checkerboard floor, lit by a
                 sunsky emitter alone; K2 alone, the batched body); each EXR
                 read back by read_exr; then each parsed config's 64x64 card
                 render against its CPU render on every pixel; one warm
                 tile-chunk of matpreview's frame profiled; cornell.xml by
                 `python -m mcpt_tpu_torch.cli` in a process of its own.
                 os.environ is restored after it (the scenes' mcpt.*
                 defaults)
Kernel times ("ms") are the median time between CUDA events around one
wrapper call (cuda_ms), which also counts the wrapper's host time; each
kernel's device time per launch from torch.profiler (kernel_ms) is taken
in device-times, after the frames of the phases before it, and printed
beside it ("device_ms").
The last two lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero;
without a CUDA device the script exits 1 before printing any result.
A watchdog ends the run after WATCHDOG_S seconds, naming the phase; each
phase prints its seconds as it ends.
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
#: cuts that keep the run inside its budget (PERF.md §4): render-lights'
#: timed frame and its profiled tile-chunk take 1 spp; render-materials'
#: timed frame 4 spp; render-bdpt's frame 1 spp (BDPT_SPP)
LIGHTS_SPP, LIGHTS_PROFILE_SPP = 1, 1
MATERIALS_SPP = 4
#: bench.py's ray-count convention: per camera sample, the primary ray
#: plus a shadow ray and a continuation per bounce, ~5.5 bounces
AVG_BOUNCES = 5.5
#: the reference suite's ray-count convention for the volumetric-caustic
#: scene (scripts/bench_suite.py): 4.0 bounces per sample
VOL_AVG_BOUNCES = 4.0
#: fp32 operations per (ray, triangle) pair in csrc/dense_sweep.cu's inner
#: loop: p = d x e2 (9), det (5), t0 = o - p0 (3), v (6), q = t0 x e1 (9),
#: w (6), t (6), v + w (1), the division (1)
K1_OPS_PER_PAIR = 46
#: fp32 operations per (ray, chunk AABB) slab test in csrc/ray_tests.cuh's
#: chunk_entry: 6 subtractions, 6 multiplications, 6 min/max per axis, 4 to
#: combine the axes, 2 against [t_min, t_max], 2 compares, 1 clamp
SLAB_OPS = 27

_phase = ["start"]
_phase_t0 = []


def begin(name):
    """Enter phase `name`, printing how long the one before it took."""
    now = time.perf_counter()
    if _phase_t0:
        say(f"phase {_phase[0]}: {now - _phase_t0[0]:.1f} s")
    _phase[0] = name
    _phase_t0[:] = [now]


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


def soup_geometry(n_tris, dev, seed=41, leaf_size=4):
    """A random soup (random_tris) with exact duplicates (ties) and 70%
    opaque prims, committed as the renderer commits a mesh (BVH leaves of
    `leaf_size` prims)."""
    from mcpt_tpu_torch.scene.geometry import commit_geometry

    tris = random_tris(n_tris, seed=seed)
    tris[n_tris // 2:n_tris // 2 + n_tris // 10] = tris[:n_tris // 10]
    verts = np.stack([tris[:, 0:3], tris[:, 0:3] + tris[:, 3:6],
                      tris[:, 0:3] + tris[:, 6:9]], axis=1)
    return commit_geometry(verts, None, None, None, np.zeros(n_tris), dev,
                           tri_opaque=tris[:, 9] > 0.5, leaf_size=leaf_size)


def soup_rays(n, dev, seed=42):
    """random_rays with t_min 1e-4 and t_max the float max, in [1, 8) on
    every third ray and 0 (dead) on every ninth: (o, d, t_min, t_max)."""
    import torch

    o, d = random_rays(n, seed=seed)
    t_max = np.full(n, 3.4e38, np.float32)
    t_max[1::3] = np.random.default_rng(seed).uniform(1.0, 8.0, n)[1::3]
    t_max[::9] = 0.0  # dead lanes
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), 1e-4, device=dev), torch.as_tensor(t_max, device=dev))


def corridor_inputs(n, lm, dev, seed=7, dead=False, grid=False):
    """K3's inputs with its edge cases: lm random chunk boxes (one in ten
    flat along an axis, every 97th parked at 3e37 as empty chunks are)
    and n rays from random origins: every 5th axis-parallel (the other
    two components +-0, so safe_rcp gives +-1e12) with its origin on a
    face plane of a random box; t_min 1e-4; t_max the float max, on
    every 3rd ray in [1, 8), below t_min (dead) on every 9th, and equal
    to t_min on every 11th, whose point at t_min is a box's centre.
    dead: every ray dead.  grid: box bounds and origins on a grid of
    0.5, so that faces and origins coincide.  Returns (o, d, t_min,
    t_max, cmin, cmax) as float32 tensors on dev."""
    import torch

    r = np.random.default_rng(seed)
    centre = r.uniform(-4, 4, size=(lm, 3))
    half = r.uniform(0, 0.5, size=(lm, 3))
    flat = np.arange(lm) % 10 == 3
    half[flat, r.integers(0, 3, size=int(flat.sum()))] = 0.0
    lo, hi = centre - half, centre + half
    if grid:
        lo, hi = np.floor(lo * 2) / 2, np.ceil(hi * 2) / 2
    lo[::97] = hi[::97] = 3e37
    o = r.uniform(-6, 6, size=(n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if grid:
        o = np.round(o * 2) / 2
    t_min = np.full(n, 1e-4)
    t_max = np.full(n, np.finfo(np.float32).max)
    t_max[1::3] = r.uniform(1.0, 8.0, n)[1::3]
    box = r.integers(0, lm, size=n)
    box[box % 97 == 0] = 1  # never a parked box
    rows = np.arange(n)
    for i in rows[::5]:
        a = r.integers(0, 3)
        d[i] = np.copysign(0.0, r.uniform(-1, 1, size=3))
        d[i, a] = r.choice([-1.0, 1.0])
        b = (a + 1) % 3
        o[i, b] = (lo if r.uniform() < 0.5 else hi)[box[i], b]
    eq = rows[5::11]
    t_min[eq] = t_max[eq] = 2.0
    o[eq] = (lo[box[eq]] + hi[box[eq]]) / 2 - 2.0 * d[eq]
    t_max[::9] = 0.0
    if dead:
        t_max[:] = 0.0
    return tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                 device=dev)
                 for x in (o, d, t_min, t_max, lo, hi))


#: K3's edge-case inputs (corridor_case): name -> (rays, chunks, dead);
#: chunks None = twice the chunks a block stages at a time, plus 37
CORRIDOR_CASES = {
    "ragged": (20001, 1001, False),
    "grid": (20001, 1001, False),
    "tiled": (20001, None, False),
    "few": (7, 40, False),
    "all-dead": (5000, 1001, True),
}


def corridor_case(kind, dev):
    """The inputs of CORRIDOR_CASES[kind] on dev (corridor_inputs)."""
    n, lm, dead = CORRIDOR_CASES[kind]
    if lm is None:
        from mcpt_tpu_torch.ops.pair_sweep import corridor_tile

        lm = 2 * corridor_tile() + 37
    return corridor_inputs(n, lm, dev, dead=dead, grid=kind == "grid")


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


#: ptxas's register, shared-memory and spill lines of the build that made
#: the library, one a kernel (build._ptxas_report), kept for the kernel
#: phases
PTXAS = []


def phase_build():
    from mcpt_tpu_torch import build

    info = build.build()
    say(f"build: {'built' if info['built'] else 'cached'} "
        f"{os.path.relpath(info['path'], HERE)} in {info['seconds']:.2f} s")
    PTXAS[:] = info["ptxas"]
    for line in info["ptxas"]:
        say(f"build: {line}")
    build.library()
    from mcpt_tpu_torch import native

    t0 = time.perf_counter()
    native.piz()
    say(f"build: {os.path.relpath(native.library_path(), HERE)} (gcc, the "
        f"host's EXR PIZ decoder) loaded in {time.perf_counter() - t0:.2f} s")


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


def lights_inputs(dev):
    """K1's inputs on the lights scene at the main path's shape: 65536
    camera rays of a 512x512 frame (every 4th pixel), first-bounce rays
    from their triangle hits in random directions (dead where the camera
    ray missed), and second steps of the alpha walk: segments from those
    hits toward the point light whose t_min lies just past the segment's
    first triangle hit (dead where it has none).  Returns (triangles,
    [(label, o, d, t_min, t_max)])."""
    import torch

    from mcpt_tpu_torch.ops import dense_sweep as ds
    from mcpt_tpu_torch.ops.math import EPSILON_DISTANCE, MAX_FLOAT
    from mcpt_tpu_torch.render.camera import generate_rays
    from mcpt_tpu_torch.scene.builtin import lights_showcase

    scene, cam = _scene(lights_showcase, dev)
    tris = scene.geom.packed_tris
    pix = torch.arange(0, cam.width * cam.height, 4, device=dev)[:TILE]
    n = pix.shape[0]
    r = np.random.default_rng(5)
    u = torch.as_tensor(r.uniform(size=n).astype(np.float32), device=dev)
    v = torch.as_tensor(r.uniform(size=n).astype(np.float32), device=dev)
    o_c, d_c = generate_rays(cam, pix, u, v)
    o_c, d_c = o_c.contiguous(), d_c.contiguous()
    lo = torch.full((n,), EPSILON_DISTANCE, device=dev)
    hi = torch.full((n,), MAX_FLOAT, device=dev)
    first = ds.dense_sweep_plain(o_c, d_c, lo, hi, tris)
    o_b = (o_c + torch.clamp(first.t, max=1e8)[:, None] * d_c).contiguous()
    d_b = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32), device=dev)
    d_b = (d_b / d_b.norm(dim=-1, keepdim=True)).contiguous()
    hi_b = torch.where(first.valid, hi, torch.zeros_like(hi))
    to_l = scene.emitters.position[0] - o_b
    dist = to_l.norm(dim=-1)
    d_s = (to_l / dist[:, None]).contiguous()
    t_hi = torch.where(first.valid, dist - EPSILON_DISTANCE,
                       torch.zeros_like(dist))
    step1 = ds.dense_sweep_plain(o_b, d_s, lo, t_hi, tris)
    if not bool(step1.valid.any()):
        raise AssertionError("lights inputs: no walk segment crosses a "
                             "triangle")
    t_lo = torch.where(step1.valid, step1.t + EPSILON_DISTANCE, lo)
    t_hi2 = torch.where(step1.valid, t_hi, torch.zeros_like(t_hi))
    return tris, [("lights camera", o_c, d_c, lo, hi),
                  ("lights bounce", o_b, d_b, lo, hi_b),
                  ("lights walk", o_b, d_s, t_lo, t_hi2)]


def volcaustic_inputs(dev):
    """K1's shadow-ray inputs on the volumetric-caustic scene at the main
    path's shape: 65536 segments toward uniform points of its area light,
    from uniform points in the fog box (medium vertices) and on the floor
    under it, as NEE traces them (t_max = distance - EPSILON_DISTANCE:
    the box's null faces lie across them) and again past the light
    (t_max = MAX_FLOAT: null-shell rows in front of the opaque light's).
    Returns (triangles, [(label, o, d, t_min, t_max)])."""
    import torch

    from mcpt_tpu_torch.ops.math import EPSILON_DISTANCE, MAX_FLOAT
    from mcpt_tpu_torch.scene.builtin import volumetric_caustic

    scene, _ = _scene(volumetric_caustic, dev)
    r = np.random.default_rng(11)
    n = TILE
    o = r.uniform([-1.5, 0.05, -1.5], [1.5, 2.05, 1.5], size=(n, 3))
    o[n // 2:, 1] = 0.0  # the floor under the box
    light = np.stack([r.uniform(-0.3, 0.3, n), np.full(n, 3.05),
                      r.uniform(-0.3, 0.3, n)], -1)
    o = torch.as_tensor(o.astype(np.float32), device=dev)
    to_l = torch.as_tensor(light.astype(np.float32), device=dev) - o
    dist = to_l.norm(dim=-1)
    d = (to_l / dist[:, None]).contiguous()
    lo = torch.full((n,), EPSILON_DISTANCE, device=dev)
    return scene.geom.packed_tris, [
        ("volcaustic shadow", o, d, lo, dist - EPSILON_DISTANCE),
        ("volcaustic past the light", o, d, lo,
         torch.full((n,), MAX_FLOAT, device=dev))]


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

    # (c) the lights scene: camera, bounce and alpha-walk rays
    tris_c, lights = lights_inputs(dev)
    for label, *rays in lights:
        for err, _, _ in _k1_pair(*rays, tris_c, f"K1(c) {label}"):
            max_err = max(max_err, err)
    walk = lights[-1][1:]
    ms_c = cuda_ms(lambda: ds.dense_sweep(*walk, tris_c), reps=20)
    say(f"kernel-K1(c): lights scene {TILE}x{tris_c.shape[0]} camera, bounce "
        f"and walk rays ({int((walk[3] > walk[2]).sum())} live) match plain; "
        f"walk sweep {ms_c:.4f} ms between events")

    # (d) the volumetric-caustic scene's shadow rays, across null shells
    tris_d, vol = volcaustic_inputs(dev)
    for label, *rays in vol:
        for err, n_hit, _ in _k1_pair(*rays, tris_d, f"K1(d) {label}"):
            max_err = max(max_err, err)
    say(f"kernel-K1(d): volcaustic scene {TILE}x{tris_d.shape[0]} shadow "
        f"rays to the light and past it match plain, closest and any hit "
        f"(null-shell rows skipped by any-hit)")

    backward = k1_backward(o, d, t_min, t_max, tris)

    rec = {
        "name": "dense_sweep", "route": "cuda",
        "source": "mcpt_tpu_torch/csrc/dense_sweep.cu",
        "replaces": "mcpt_tpu/ops/pallas_dense.py:31",
        "launches": None, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": f"{n} rays x {p} tris",
        "cornell_ms": ms_b, "cornell_plain_ms": plain_b,
        "lights_walk_ms": ms_c,
        "backward": backward,
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


#: rays of (a) whose K1 gradient is also taken on the CPU
K1_BACKWARD_CPU_RAYS = 4096


def k1_backward(o, d, t_min, t_max, tris):
    """K1's backward (dense_sweep.DenseClosestHit: plain torch, the
    winning row's Moller-Trumbore again) at (a)'s shape: its time between
    events, with the forward's graph kept, and the gradients of t, v and w
    into o and d held against the same on the CPU (plain forward) for the
    first K1_BACKWARD_CPU_RAYS rays, within 1e-5 relative to the largest."""
    import torch

    from mcpt_tpu_torch.ops import dense_sweep as ds

    def grads(o, d, t_min, t_max, tris):
        o = o.clone().requires_grad_()
        d = d.clone().requires_grad_()
        valid, t, _, v, w, _ = ds.DenseClosestHit.apply(o, d, t_min, t_max,
                                                       tris)
        outs = (torch.where(valid, t, torch.zeros_like(t)), v, w)
        ones = tuple(torch.ones_like(x) for x in outs)
        return outs, ones, o, d

    outs, ones, o_g, d_g = grads(o, d, t_min, t_max, tris)
    ms = cuda_ms(lambda: torch.autograd.grad(outs, (o_g, d_g), ones,
                                             retain_graph=True), reps=10)
    g_card = torch.autograd.grad(outs, (o_g, d_g), ones)
    m = K1_BACKWARD_CPU_RAYS
    outs, ones, o_c, d_c = grads(*(x[:m].cpu() for x in (o, d, t_min, t_max)),
                                 tris.cpu())
    g_cpu = torch.autograd.grad(outs, (o_c, d_c), ones)
    err = max(float((a[:m].cpu() - b).abs().max() / b.abs().max())
              for a, b in zip(g_card, g_cpu))
    if not err <= 1e-5:
        raise AssertionError(f"K1 backward: card and CPU gradients differ by "
                             f"{err:.3g} of the largest")
    say(f"kernel-K1 backward: {o.shape[0]} rays x {tris.shape[0]} triangles, "
        f"grad of t, v, w into o, d {ms:.3f} ms between events (plain torch, "
        f"the winner's row); card vs cpu on {m} rays: {err:.3g} of the "
        f"largest")
    return {"ms": ms, "cpu_rays": m, "max_rel_err": err}


def _counters():
    from mcpt_tpu_torch.ops import dense_sweep as ds
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops import packet_sweep as pkt
    from mcpt_tpu_torch.ops import pair_sweep as psw

    return ((ds, "launches"), (ds, "any_hit_launches"),
            (msw, "launches"), (msw, "any_hit_launches"),
            (psw, "corridor_launches"), (psw, "pair_launches"),
            (pkt, "launches"), (pkt, "any_hit_launches"))


def reset_counts():
    for mod, attr in _counters():
        setattr(mod, attr, 0)


def read_counts():
    """Kernel launches since reset_counts(): K1, K2 and K5 (and how many
    of each were any-hit), K3, K4."""
    c = {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
         for mod, attr in _counters()}
    return {
        "K1": c["dense_sweep.launches"],
        "K1_any": c["dense_sweep.any_hit_launches"],
        "K2": c["march_sweep.launches"],
        "K2_any": c["march_sweep.any_hit_launches"],
        "K3": c["pair_sweep.corridor_launches"],
        "K4": c["pair_sweep.pair_launches"],
        "K5": c["packet_sweep.launches"],
        "K5_any": c["packet_sweep.any_hit_launches"],
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


def card_vs_cpu(make_config, dev, label, engine=None, gate_pixels=True,
                min_share=0.99):
    """The same 64x64, 4 spp render on the card and on the CPU (plain
    versions), same seeds, by `engine` (None: the renderer's default):
    >= `min_share` of pixels within rtol 1e-3, atol 1e-4 (printed only
    where gate_pixels is False), channel means within 1e-3 relative.
    Returns the card's image."""
    from mcpt_tpu_torch.render.renderer import Renderer

    small = make_config(res=64, spp=4)
    kw = dict(spp=4, tile=TILE, spp_chunk=4, engine=engine)
    a = Renderer(small, device=dev).render(**kw)
    b = Renderer(small, device="cpu").render(**kw)
    _check_image(a, f"{label} 64x64")
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1)
    rel = np.abs(a.mean(axis=(0, 1)) / b.mean(axis=(0, 1)) - 1.0)
    say(f"{label}: 64x64 4spp card vs cpu: {close.mean() * 100:.2f}% "
        f"pixels within rtol 1e-3 atol 1e-4, channel means rel diff "
        f"{rel.max():.2e} (means card "
        f"{np.round(a.mean(axis=(0, 1)), 5).tolist()}, cpu "
        f"{np.round(b.mean(axis=(0, 1)), 5).tolist()})")
    if (gate_pixels and close.mean() < min_share) or rel.max() > 1e-3:
        raise AssertionError(f"{label}: card and CPU renders disagree")
    return a


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
K2_BEFORE_MS = {"camera": None, "bounce": 8.701, "soup": None,
                "fallback": 6.4, "batched": None, "envmap batched": None}


@contextlib.contextmanager
def environ_restored():
    """Restore os.environ as it was when the block ends: a scene's mcpt.*
    defaults and the CLI's --set become MCPT_* variables of the process,
    which would route later phases otherwise."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@contextlib.contextmanager
def knobs(env):
    """Set environment knobs for the duration of a block."""
    with environ_restored():
        os.environ.update(env)
        yield


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


def batched_input(dev, envmap=False):
    """K2's input in the batched regen body on the materials scene (or
    with `envmap`, on the envmap scene), at its shape: 65536 continuations
    — the first half fresh camera rays (class 0), the second half
    first-bounce rays (class 1) — and 65536 shadow segments from the
    camera rays' hits toward points sampled on the area light (toward
    envmap samples, dist = MAX_FLOAT/2), t_max = max(dist -
    EPSILON_DISTANCE, 0) where the camera ray hit (else 0), half in class
    2 and half in class 3, the class of a scene's second and later
    queries, so that the sort sees the whole 2-bit class field; t_min the
    default.  In the body's block order.  Returns (label, geometry, args)."""
    import torch

    from mcpt_tpu_torch.integrators.path import _sample_area_light
    from mcpt_tpu_torch.models.emitter import sample_envmap
    from mcpt_tpu_torch.ops import march_sweep as msw
    from mcpt_tpu_torch.ops.math import EPSILON_DISTANCE
    from mcpt_tpu_torch.ops.traversal import march_order
    from mcpt_tpu_torch.scene.builtin import (cornell_mesh_materials,
                                              envmap_matpreview)

    scene, cam = _scene(envmap_matpreview if envmap
                        else cornell_mesh_materials, dev)
    g = scene.geom
    (_, o_c, d_c, lo, hi), (_, o_b, d_b, _, hi_b) = camera_and_bounce(
        scene, cam, dev, seed=4)
    n = len(o_c)
    half = n // 2
    hit = hi_b > 0  # the camera ray hit: o_b is its hit point
    r = np.random.default_rng(8)
    xi = torch.as_tensor(r.random((3, n), dtype=np.float32), device=dev)
    if envmap:
        wi, dist, _, _, _ = sample_envmap(scene.env, scene.tex, o_b, *xi)
        d_s = -wi
    else:
        p_l = _sample_area_light(scene, xi[0], xi[1], xi[2])[0]
        to_l = p_l - o_b
        dist = to_l.norm(dim=-1)
        d_s = to_l / torch.clamp(dist, min=1e-20)[:, None]
    t_s = torch.where(hit, torch.clamp(dist - EPSILON_DISTANCE, min=0.0),
                      torch.zeros_like(dist))
    o = torch.cat([o_c[:half], o_b[half:], o_b]).contiguous()
    d = torch.cat([d_c[:half], d_b[half:], d_s]).contiguous()
    t_max = torch.cat([hi[:half], hi_b[half:], t_s])
    t_min = torch.full_like(t_max, EPSILON_DISTANCE)
    bias = torch.cat([torch.full((size,), c, dtype=torch.int32, device=dev)
                      for size, c in ((half, 0), (n - half, 1), (half, 2),
                                      (n - half, 3))])
    order = march_order(g, o, d, t_min, t_max, bias)
    if not bool(torch.isfinite(t_max).all()):
        raise AssertionError("batched input: a t_max is not finite")
    if not bool((msw.march_sweep_plain(
            o[n:], d[n:], t_min[n:], t_max[n:], g.march_min, g.march_max,
            g.march_tris, g.march_prim).valid).any()):
        raise AssertionError("batched input: no shadow segment is occluded")
    label = "envmap batched" if envmap else "batched"
    return (label, g, (o[order].contiguous(), d[order].contiguous(),
                           t_min[order], t_max[order], g.march_min,
                           g.march_max, g.march_tris, g.march_prim))


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
    sets.append(batched_input(dev))
    sets.append(batched_input(dev, envmap=True))

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
        if label == "envmap batched":
            envmap_batched = {
                "shape": f"{len(args[0])} lanes (65536 continuations + "
                         f"65536 envmap shadow segments) x {lm} chunks of "
                         f"{ls}",
                "ms": times[(label, "default")], "bound_ms": bound_ms,
                "bound_by": bound_by}
            envmap_args, envmap_sup = args, supers
        if label == "batched":
            batched = {"shape": f"{len(args[0])} lanes (65536 continuations "
                                f"+ 65536 shadow segments, classes 0-3) x "
                                f"{lm} chunks of {ls}",
                       "ms": times[(label, "default")], "bound_ms": bound_ms,
                       "bound_by": bound_by}
            batched_args, batched_sup = args, supers
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
        "batched": batched,
        "envmap_batched": envmap_batched,
    }
    time_on_device(rec, "device_ms",
                   lambda: msw.march_sweep(*args, supers=bounce_sup),
                   "march_kernel")
    time_on_device(envmap_batched, "device_ms",
                   lambda: msw.march_sweep(*envmap_args, supers=envmap_sup),
                   "march_kernel")
    time_on_device(batched, "device_ms",
                   lambda: msw.march_sweep(*batched_args, supers=batched_sup),
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


#: K3's time on the card before its redesign, on the pairs scene's
#: bounce rays (commit faca9ff; NVIDIA H100 80GB HBM3, 700 W): between
#: CUDA events around one call, and device time a launch.  Printed beside
#: this run's times, not in the kernels line
K3_BEFORE_MS = 0.2058
K3_BEFORE_DEVICE_MS = 0.1644


def k3_tests(o, d, lo, hi, cmin, cmax, k):
    """The slab tests K3 performs on this input, (union tests, chunk
    tests): each ray with t_max >= t_min tests the unions of every
    32-union ballot it reaches and the chunks (32, fewer in a partial last
    union) of every passing union it walks, in index order, until its
    count of passing chunks passes k."""
    import torch

    from mcpt_tpu_torch.ops.march_sweep import chunk_entry, super_boxes
    from mcpt_tpu_torch.ops.pair_sweep import UNION

    lm = cmin.shape[0]
    live = hi >= lo
    o, d, lo, hi = o[live], d[live], lo[live], hi[live]
    umin, umax = super_boxes(cmin, cmax, UNION)
    nu = umin.shape[0]
    ok = torch.isfinite(chunk_entry(o, d, lo, hi, cmin, cmax))
    per = torch.cat([ok, ok.new_zeros((len(o), nu * UNION - lm))], dim=1
                    ).view(-1, nu, UNION).sum(dim=2)
    over = per.cumsum(dim=1) > k
    stop = torch.where(over.any(dim=1), over.int().argmax(dim=1),
                       torch.full_like(over[:, 0], nu, dtype=torch.long))
    upass = torch.isfinite(chunk_entry(o, d, lo, hi, umin, umax))
    walked = upass & (torch.arange(nu, device=o.device)[None] <= stop[:, None])
    size = torch.full((nu,), UNION, device=o.device)
    size[-1] = lm - (nu - 1) * UNION
    union_tests = int(torch.clamp((stop // 32 + 1) * 32, max=nu).sum())
    return union_tests, int((walked * size).sum())


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

    # K3 on the card tests' inputs at every k they take: a SAH soup's
    # chunks, and the edge cases
    with knobs({"MCPT_MARCH_LEAF": "16"}):
        g_s = soup_geometry(6000, dev)
    cases = {"soup": (*soup_rays(20000, dev), g_s.march_min, g_s.march_max)}
    cases.update((kind, corridor_case(kind, dev)) for kind in CORRIDOR_CASES)
    for kind, cargs in cases.items():
        for kk in (1, 2, 8, psw.MAX_K):
            slots, over = psw.corridor(*cargs, kk)
            slots_p, over_p = psw.corridor_plain(*cargs, kk)
            if not (torch.equal(slots, slots_p) and torch.equal(over, over_p)):
                raise AssertionError(f"K3 {kind} k={kk}: slots or overflow "
                                     f"differ")
    say(f"kernel-K3 card-test inputs: slots and overflow equal at K = 1, 2, "
        f"8, {psw.MAX_K} on " + ", ".join(
            f"{kind} ({len(a[0])} rays x {len(a[4])} chunks)"
            for kind, a in cases.items()))

    # time and bounds on the main path's bounce rays
    o, d, lo, hi = sets[1][1:]
    cargs = (o, d, lo, hi, g.march_min, g.march_max, k)
    k3_ms = cuda_ms(lambda: psw.corridor(*cargs), reps=20)
    k3_plain = cuda_ms(lambda: psw.corridor_plain(*cargs), reps=3, warmup=1)
    n = len(o)
    live = int((hi > lo).sum())
    k3_bytes = n * 2 * 4 + live * 6 * 4 + lm * 6 * 4 + n * k * 4 + n
    # the full sweep: every live ray against every chunk; what K3 does:
    # its union and chunk tests on this input (k3_tests)
    full_bound, _ = bound(SLAB_OPS * live * lm, k3_bytes)
    u_tests, c_tests = k3_tests(*cargs)
    k3_bound, k3_by = bound(SLAB_OPS * (u_tests + c_tests), k3_bytes)
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
        f"(plain {k3_plain:.3f} ms); {u_tests} union + {c_tests} chunk slab "
        f"tests, bound {k3_bound:.4f} ms by {k3_by}; full-sweep bound "
        f"{full_bound:.4f} ms ({live} live of {n} rays x {lm} chunks); "
        f"before the redesign {K3_BEFORE_MS} ms between events")
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
             full_sweep_bound_ms=full_bound,
             slab_tests={"union": u_tests, "chunk": c_tests,
                         "full_sweep": live * lm},
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


def packet_args(g, o, d, lo, hi):
    """K5's inputs: the rays in the packet route's order (a stable sort of
    their coherence keys), the BVH's node boxes and its leaves' rows."""
    import torch

    from mcpt_tpu_torch.ops.traversal import _ray_sort_keys

    order = torch.sort(_ray_sort_keys(g, o, d), stable=True)[1]
    return (o[order].contiguous(), d[order].contiguous(),
            lo[order].contiguous(), hi[order].contiguous(), g.node_min,
            g.node_max, g.packed_tris.view(g.n_pad_leaves, g.leaf_size, 12))


def packet_same(got, ref, label):
    """K5 against its plain version: the same per-ray walk and arithmetic,
    so all six outputs bit-equal, closest hit and any-hit.  Returns
    (hits, ties): ties, rays whose prim differs, must be 0."""
    import torch

    m = ref.valid
    ties = int((m & (got.prim != ref.prim)).sum())
    for name in ("valid", "t", "prim", "v", "w", "inside"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"version ({ties} prim ties)")
    return int(m.sum()), ties


#: bytes of one BVH node's box (min and max, 3 floats each)
NODE_BYTES = 6 * 4
#: K5 before its redesign as a per-ray walk (commit b845e5c; NVIDIA H100
#: 80GB HBM3, 700 W): the 1024-lane packet walk on the batched input,
#: between events and its device time, and its bound from the packet
#: walk's tests (530.1M slab and 916.0M triangle tests of live lanes).
#: Printed beside this run's numbers, not in the kernels line
K5_BEFORE_MS = 23.94
K5_BEFORE_DEVICE_MS = 23.71
K5_PACKET_BOUND_MS = 0.8437


def k5_bound(args, visits):
    """K5's bound on one input, from what the per-ray walk needs
    (packet_sweep_plain's visits): 27 operations per slab test (two an
    internal node a ray visits) and 46 per triangle test (a visited
    leaf's rows; any-hit: its opaque rows); bytes: each ray read once,
    each output written once, and once each box that some ray tested
    (both children of every internal node some ray visited) and each row
    of every leaf some ray visited."""
    n = len(args[0])
    nodes = visits["nodes"]
    n_leaves = args[6].shape[0]
    leaf_size = args[6].shape[1]
    internal = int(nodes[:n_leaves - 1].sum())
    leaves = int(nodes[n_leaves - 1:].sum())
    ops = SLAB_OPS * visits["slab_tests"] + K1_OPS_PER_PAIR * visits["tri_tests"]
    nbytes = (n * 8 * 4 + n * HIT_BYTES + 2 * internal * NODE_BYTES
              + leaves * leaf_size * ROW_BYTES)
    return bound(ops, nbytes)


def phase_kernel_k5(dev):
    """K5 against its plain version, closest hit and any-hit, on the march
    scene's 65536 camera and first-bounce rays, on the batched body's
    131072-lane input of the materials scene (batched_input), and on
    65536 random rays in a random soup of 16384 triangles; each in the
    packet route's order.  Times by events; on the batched input the
    plain version's time, the bound and node visits a ray."""
    import torch

    from mcpt_tpu_torch.ops import packet_sweep as pkt
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_march

    regs = [line for line in PTXAS if line.startswith("packet_kernel")]
    say("kernel-K5: ptxas " + ("; ".join(regs) if regs else "no report "
                               "beside the library (build.PTXAS_NAME)"))
    scene, cam = _scene(cornell_mesh_march, dev)
    g = scene.geom
    sets = [(label, g, packet_args(g, *rays))
            for label, *rays in camera_and_bounce(scene, cam, dev)]
    label, g_b, args_b = batched_input(dev)
    sets.append((label, g_b, packet_args(g_b, *args_b[:4])))
    g_s = soup_geometry(16384, dev, seed=47)
    sets.append(("soup", g_s, packet_args(g_s, *soup_rays(TILE, dev,
                                                            seed=48))))
    times = {}
    for label, geom, args in sets:
        line = []
        for any_hit in (False, True):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            ref = pkt.packet_sweep_plain(*args, any_hit=any_hit)
            b.record()
            b.synchronize()
            if label == "batched" and not any_hit:
                plain_ms = a.elapsed_time(b)
            got = pkt.packet_sweep(*args, any_hit=any_hit)
            n_hit, n_tie = packet_same(got, ref,
                                       f"K5 {label} any_hit={any_hit}")
            line.append(f"{'any' if any_hit else 'closest'} hits {n_hit} "
                        f"ties {n_tie}")
        times[label] = cuda_ms(lambda: pkt.packet_sweep(*args), reps=10)
        say(f"kernel-K5 {label}: {len(args[0])} rays "
            f"({int((args[3] > args[2]).sum())} live) x {geom.n_pad_leaves} "
            f"leaves of {geom.leaf_size} (depth {geom.depth}): all six "
            f"outputs bit-equal to plain ({', '.join(line)}); "
            f"{times[label]:.4f} ms")
        if label == "batched":
            batched = (args, geom)

    args, geom = batched
    visits = {}
    pkt.packet_sweep_plain(*args, visits=visits)
    bound_ms, bound_by = k5_bound(args, visits)
    walked = visits["internal"] + visits["leaf"]
    walked = walked[args[3] > args[2]].double()
    ms = times["batched"]
    say(f"kernel-K5 batched: {ms:.4f} ms (plain {plain_ms:.1f} ms), bound "
        f"{bound_ms:.4f} ms by {bound_by}: {visits['slab_tests']} slab tests, "
        f"{visits['tri_tests']} triangle tests, {int(visits['nodes'].sum())} "
        f"of {geom.node_min.shape[0]} nodes visited; node visits a live ray "
        f"min {int(walked.min())}, median {float(walked.median()):.0f}, max "
        f"{int(walked.max())} (internal {int(visits['internal'].sum())}, "
        f"leaf {int(visits['leaf'].sum())} in all); before the redesign "
        f"{K5_BEFORE_MS} ms between events (device {K5_BEFORE_DEVICE_MS} "
        f"ms), bound {K5_PACKET_BOUND_MS} ms by the packet walk's tests")
    rec = {
        "name": "packet_sweep", "route": "cuda",
        "source": "mcpt_tpu_torch/csrc/packet_sweep.cu",
        # no Pallas kernel: the reference's XLA packet walk
        "replaces": "mcpt_tpu/ops/traversal.py:454",
        "launches": None, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": f"{len(args[0])} lanes (65536 continuations + 65536 shadow "
                 f"segments) x {geom.n_pad_leaves} leaves of {geom.leaf_size}",
        "ms_by_input": times,
        "visits": {"slab_tests": visits["slab_tests"],
                   "tri_tests": visits["tri_tests"],
                   "nodes": int(visits["nodes"].sum()),
                   "per_live_ray": [int(walked.min()),
                                    float(walked.median()),
                                    int(walked.max())]},
    }
    time_on_device(rec, "device_ms", lambda: pkt.packet_sweep(*args),
                   "packet_kernel", reps=5)
    return rec


def body_taken(scene, counts, label):
    """The regen body a frame took, by the gate, checked against its
    launches: the batched body traces closest hit only (its shadow
    segments too), so it launches no any-hit kernel."""
    from mcpt_tpu_torch.integrators.path import _use_batched_trace

    body = "batched" if _use_batched_trace(scene) else "unbatched"
    n_any = counts["K1_any"] + counts["K2_any"] + counts["K5_any"]
    if body == "batched" and n_any:
        raise AssertionError(f"{label}: the batched body's frame launched "
                             f"{n_any} any-hit kernels")
    return body


def phase_render_route(dev, smi, label, make_config, route, kernels,
                       against_cpu=True, body=None, warmup_spp=SPP, spp=SPP):
    """Renderer.render of a mesh scene above DENSE_MAX_PRIMS at full width,
    `spp` samples, after a warm-up frame (of `warmup_spp`); the route's kernels
    must have launched, and the regen body must be `body` where given.
    Returns the kernel counts, the frame's wall and the renderer."""
    from mcpt_tpu_torch.ops.traversal import resolved_strategy
    from mcpt_tpu_torch.render.renderer import Renderer

    r = Renderer(make_config(), device=dev)
    g = r.scene.geom
    if resolved_strategy(g) != route:
        raise AssertionError(f"{label}: route {resolved_strategy(g)}, "
                             f"expected {route}")
    r.render(spp=warmup_spp, tile=TILE, spp_chunk=SPP_CHUNK)  # warm-up frame
    img, wall, counts = _render_timed(r, spp, frame_base=1)
    _check_image(img, label)
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched ({counts})")
    taken = body_taken(r.scene, counts, label)
    if body is not None and taken != body:
        raise AssertionError(f"{label}: took the {taken} body, not {body}")
    rays = RES * RES * spp * (1 + 2 * AVG_BOUNCES)
    say(f"{label}: {int(g.opaque.sum())} triangles, {g.n_march_leaves} "
        f"chunks of {g.march_leaf}, route {route}, {taken} body; {RES}x{RES} "
        f"{spp}spp d{DEPTH} wall {wall:.3f} s, {rays / wall / 1e6:.2f} "
        f"Mrays/s on {smi}; launches K2 {counts['K2']} ({counts['K2_any']} "
        f"any-hit), K3 {counts['K3']}, K4 {counts['K4']}, K1 {counts['K1']}, "
        f"K5 {counts['K5']} ({counts['K5_any']} any-hit); "
        f"mean {np.round(img.mean(axis=(0, 1)), 4).tolist()}")
    if against_cpu:
        card_vs_cpu(make_config, dev, label)
    return counts, wall, r


def phase_render_envmap(dev, smi):
    """render-envmap: the alias build of the 2048x1024 sky timed on the
    host, then the envmap scene through the batched body and K2."""
    from mcpt_tpu_torch.models.emitter import build_envmap
    from mcpt_tpu_torch.scene.builtin import envmap_matpreview, sky_envmap

    sky = sky_envmap()
    t0 = time.perf_counter()
    env = build_envmap(sky, np.eye(4, dtype=np.float32), 0, "cpu")
    say(f"render-envmap: alias table of the {env.width}x{env.height} envmap "
        f"({env.width * env.height} texels) built in "
        f"{time.perf_counter() - t0:.3f} s on the host")
    counts, wall, r = phase_render_route(
        dev, smi, "render-envmap", envmap_matpreview, "march", ("K2",),
        body="batched")
    if r.scene.env_kind != "envmap" or r.scene.n_emissive:
        raise AssertionError("render-envmap: not lit by the envmap alone")
    return counts, wall, r


def phase_render_lights(dev, smi):
    """render-lights: the lights scene through K1 and the unbatched body,
    whose shadow queries walk their alpha crossings by closest hits."""
    from mcpt_tpu_torch.integrators.path import (SHADOW_ALPHA_K,
                                                 _nee_query_count,
                                                 _use_batched_trace)
    from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import lights_showcase

    r = Renderer(lights_showcase(), device=dev)
    scene = r.scene
    p = scene.geom.packed_tris.shape[0]
    if (p > DENSE_MAX_PRIMS or _use_batched_trace(scene)
            or not scene.has_opacity or not scene.em_quad_cells):
        raise AssertionError("render-lights: not the dense route, the "
                             "unbatched body and the alpha walk")
    # a 1-spp warm-up frame: the same code and shapes as the timed frame,
    # which takes LIGHTS_SPP samples
    r.render(spp=1, tile=TILE, spp_chunk=SPP_CHUNK)
    img, wall, counts = _render_timed(r, LIGHTS_SPP, frame_base=1)
    _check_image(img, "render-lights")
    per_iter = 1 + _nee_query_count(scene) * SHADOW_ALPHA_K
    if (counts["K1"] <= 0 or counts["K1_any"] or counts["K1"] % per_iter
            or counts["K2"] or counts["K3"] or counts["K4"]):
        raise AssertionError(f"render-lights: not {per_iter} closest-hit K1 "
                             f"launches a wavefront iteration ({counts})")
    rays = RES * RES * LIGHTS_SPP * (1 + 2 * AVG_BOUNCES)
    say(f"render-lights: {p} padded triangles + {len(scene.quad_kinds)} "
        f"quadric rows, {_nee_query_count(scene)} shadow queries a vertex, "
        f"unbatched body; {RES}x{RES} {LIGHTS_SPP}spp d{DEPTH} wall "
        f"{wall:.3f} s, "
        f"{rays / wall / 1e6:.2f} Mrays/s on {smi}; K1 launches "
        f"{counts['K1']} closest-hit ({counts['K1'] // per_iter} iterations "
        f"x {per_iter}), 0 any-hit; mean "
        f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")
    card_vs_cpu(lights_showcase, dev, "render-lights")
    return counts, wall, r


def tile_chunk_profile(r, label, smi, spp=SPP_CHUNK):
    """One tile-chunk of a renderer's frame (the first 64k pixels, one spp
    chunk of `spp`, 8 by default: 1/8 of a 512x512 16-spp frame) by the
    regen engine timed, then again under torch.profiler: the device's busy
    time, its idle share of the unprofiled wall, the device activities
    (kernels, copies, sets) and the unprofiled run's K1 launches."""
    import torch

    from mcpt_tpu_torch.render.renderer import render_tile_regen

    idx = torch.arange(TILE, device=r.device)
    return profile_run(
        lambda: render_tile_regen(r.scene, r.camera, r.integrator, idx, spp,
                                  frame_base=2, spp_total=SPP),
        f"device-times: {label} tile-chunk ({TILE} px x {spp} spp)", smi)


def profile_run(fn, label, smi):
    """`fn()` timed to a synchronize, then again under torch.profiler
    (device activities only: the host's ops would multiply the events to
    read back): its wall, the device's busy time and idle share of that
    wall, the device activities (kernels, copies, sets) and the timed
    run's K1 launches.  Runs after the frames it could slow: frames timed
    after a profiler session were slower (PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        fn()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError(f"{label}: the profiler recorded no device "
                             f"activity")
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    say(f"{label} wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}, {len(events)} device activities, K1 "
        f"launches {counts['K1'] - counts['K1_any']} closest + "
        f"{counts['K1_any']} any-hit, K2 {counts['K2']}, K5 {counts['K5']}, "
        f"on {smi}")
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "device_activities": len(events),
            "counts": counts}


def phase_render_volcaustic(dev, smi):
    """render-volcaustic: the isotropic volumetric-caustic scene through
    the volpath regen body and K1, whose any-hit shadow rays cross the
    fog's null faces; then the isotropic and HG scenes card vs CPU."""
    from mcpt_tpu_torch.integrators.path import _use_batched_trace
    from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import volumetric_caustic

    depth = 16
    r = Renderer(volumetric_caustic(depth_max=depth), device=dev)
    scene = r.scene
    p = scene.geom.packed_tris.shape[0]
    if (p > DENSE_MAX_PRIMS or _use_batched_trace(scene) or scene.all_opaque
            or r.integrator.itype != "volpath"):
        raise AssertionError("render-volcaustic: not the dense route, the "
                             "volpath regen body and null shells")
    r.render(spp=1, tile=TILE, spp_chunk=SPP_CHUNK)  # 1-spp warm-up frame
    img, wall, counts = _render_timed(r, SPP, frame_base=1)
    _check_image(img, "render-volcaustic")
    n_any = counts["K1_any"]
    n_closest = counts["K1"] - n_any
    if n_closest <= 0 or n_any <= 0 or counts["K2"] or counts["K3"] \
            or counts["K4"]:
        raise AssertionError("render-volcaustic: not K1 alone in both modes "
                             f"({counts})")
    rays = RES * RES * SPP * (1 + 2 * VOL_AVG_BOUNCES)
    say(f"render-volcaustic: {int(scene.geom.opaque.sum())} opaque of "
        f"{p} padded triangles + {len(scene.quad_kinds)} quadric row, "
        f"volpath, unbatched body; {RES}x{RES} {SPP}spp d{depth} wall "
        f"{wall:.3f} s, {rays / wall / 1e6:.2f} Mrays/s (1 + 2 x "
        f"{VOL_AVG_BOUNCES} rays a sample) on {smi}; K1 launches "
        f"{n_closest} closest + {n_any} any-hit, K2 0, K3 0, K4 0; mean "
        f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")
    card_vs_cpu(volumetric_caustic, dev, "render-volcaustic isotropic")
    card_vs_cpu(functools.partial(volumetric_caustic, phase="hg", g=-0.5),
                dev, "render-volcaustic hg")
    return counts, wall, r


def phase_engine_chunked(dev):
    """engine-chunked: the chunked per-sample engine card vs CPU, through
    path.shade (Cornell box) and volpath.shade (volumetric caustic)."""
    from mcpt_tpu_torch.scene.builtin import cornell_box, volumetric_caustic

    card_vs_cpu(cornell_box, dev, "engine-chunked cornell", engine="chunked")
    card_vs_cpu(volumetric_caustic, dev, "engine-chunked volcaustic",
                engine="chunked")


def phase_s1_means(dev):
    """s1-means: the ripple bump map and the emissive sphere of radius
    0.02 card vs CPU, gated on the channel means only."""
    from mcpt_tpu_torch.scene.builtin import bump_and_bead

    card_vs_cpu(bump_and_bead, dev, "s1-means", gate_pixels=False)


#: BDPT's frame, as the reference harness times the caustic scene by
#: BDPT (scripts/bench_suite.py:49-50): 8 spp, 3.5 bounces a sample; the
#: timed frame takes 1 spp to keep the run inside its budget (PERF.md §4)
BDPT_SPP, BDPT_AVG_BOUNCES = 1, 3.5


def phase_render_bdpt(dev, smi):
    """render-bdpt: the glass-sphere caustic without its fog (bdpt_caustic)
    by BDPT through the chunked engine and K1, timed after a 1-spp warm-up
    frame: each sample-tile makes 1 + K_LIGHT + (bounces) closest hits and
    (NEE queries + K_LIGHT) x (bounces) any-hits, none of K2-K4; then the
    64x64 card render against the CPU's.  Returns the frame's counts and
    one sample-tile's render, which device-times profiles."""
    from mcpt_tpu_torch.integrators.bdpt import DEPTH_CAP, K_LIGHT
    from mcpt_tpu_torch.integrators.path import _nee_query_count
    import torch

    from mcpt_tpu_torch.ops.traversal import DENSE_MAX_PRIMS
    from mcpt_tpu_torch.render.renderer import Renderer, render_pixels
    from mcpt_tpu_torch.scene.builtin import bdpt_caustic

    r = Renderer(bdpt_caustic(), device=dev)
    scene = r.scene
    p = scene.geom.packed_tris.shape[0]
    if (p > DENSE_MAX_PRIMS or r.integrator.itype != "bdpt"
            or not scene.quad_kinds or scene.has_opacity):
        raise AssertionError("render-bdpt: not BDPT on the dense route with "
                             "a quadric")
    r.render(spp=1, tile=TILE, spp_chunk=SPP_CHUNK)  # 1-spp warm-up frame
    img, wall, counts = _render_timed(r, BDPT_SPP, frame_base=1)
    _check_image(img, "render-bdpt")
    bounces = min(r.integrator.depth_max, DEPTH_CAP) - 1
    sample_tiles = -(-RES * RES // TILE) * BDPT_SPP
    want = (sample_tiles * (1 + K_LIGHT + bounces),
            sample_tiles * bounces * (_nee_query_count(scene) + K_LIGHT))
    n_any = counts["K1_any"]
    n_closest = counts["K1"] - n_any
    if ((n_closest, n_any) != want or counts["K2"] or counts["K3"]
            or counts["K4"]):
        raise AssertionError(f"render-bdpt: not {want[0]} closest + {want[1]} "
                             f"any-hit K1 launches alone ({counts})")
    rays = RES * RES * BDPT_SPP * (1 + 2 * BDPT_AVG_BOUNCES)
    say(f"render-bdpt: {p} padded triangles + {len(scene.quad_kinds)} quadric "
        f"row, BDPT by the chunked engine; {RES}x{RES} {BDPT_SPP}spp "
        f"d{r.integrator.depth_max} ({bounces} bounces, {K_LIGHT} light "
        f"vertices) wall {wall:.3f} s, {rays / wall / 1e6:.2f} Mrays/s (1 + 2 "
        f"x {BDPT_AVG_BOUNCES} rays a sample) on {smi}; K1 launches "
        f"{n_closest} closest + {n_any} any-hit, K2 0, K3 0, K4 0; mean "
        f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")
    card_vs_cpu(bdpt_caustic, dev, "render-bdpt")
    idx = torch.arange(TILE, device=dev)
    return counts, (lambda: render_pixels(scene, r.camera, r.integrator, idx,
                                          1, frame_base=2))


#: the train step at full width: pixels, samples and the pixels a piece
GRAD_RES, GRAD_SPP, GRAD_CHUNK = 512, 4, 1 << 16
GRAD_FAMILIES = ("textures", "bsdf")


def caustic_glass_by_path(**kw):
    """bdpt_caustic's glass sphere, light and floor by the path integrator."""
    from mcpt_tpu_torch.scene.builtin import bdpt_caustic

    cfg = bdpt_caustic(**kw)
    cfg.integrator.itype = "path"
    return cfg


def grad_card_vs_cpu(make_config, families, dev, label, res=64, spp=2,
                     rtol=1e-4):
    """make_train_step's loss (against a black target) and gradients of
    the same res x res, spp-sample step on the card and on the CPU (plain
    versions), same seeds: the loss within 1e-5 and every gradient leaf
    within rtol of its largest |value| on the CPU, whose leaves of
    `families` must not all be zero.  Returns the CPU's gradients."""
    import torch

    from mcpt_tpu_torch.parallel.shard import make_mesh, make_train_step
    from mcpt_tpu_torch.render.renderer import Renderer

    out = {}
    for device in (dev, torch.device("cpu")):
        r = Renderer(make_config(res=res, spp=spp), device=device)
        idx = torch.arange(res * res, device=device)
        step = make_train_step(r.integrator, spp, make_mesh([device]),
                               families)
        loss, g = step(r.scene, r.camera, idx,
                       torch.zeros((res * res, 3), device=device))
        out[device.type] = float(loss), {k: v.cpu() for k, v in g.items()}
    (l_a, g_a), (l_b, g_b) = out["cuda"], out["cpu"]
    errs = {}
    for k, b in g_b.items():
        a = g_a[k]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: {k} gradient not finite")
        scale = float(b.abs().max())
        errs[k] = float((a - b).abs().max()) / scale if scale else 0.0
    worst = max(errs, key=errs.get)
    say(f"{label}: {res}x{res} {spp}spp train step card vs cpu: loss "
        f"{l_a:.6g} vs {l_b:.6g}; largest gradient difference {errs[worst]:.3g}"
        f" of its leaf's largest ({worst}); |grad| "
        + ", ".join(f"{k} {float(v.norm()):.4g}" for k, v in g_b.items()))
    if (abs(l_a / l_b - 1) > 1e-5 or errs[worst] > rtol
            or not any(float(v.abs().max()) for v in g_b.values())):
        raise AssertionError(f"{label}: card and CPU gradients disagree")
    return g_b


def phase_grad(dev, smi):
    """grad: (a) make_train_step at full width on the envmap scene (the
    march route, K2, whose hits are detached), families textures and bsdf,
    512x512, 4 spp, in 65536-pixel pieces, against a target rendered at
    other parameters: the step's wall, peak device memory, each gradient's
    norm; (b) K1's backward in the estimator: the volumetric-caustic
    scene's media (scatter points move with sigma_t) and the caustic's
    glass sphere through the path integrator (refractions move with eta),
    64x64, 2 spp, card against CPU.  Returns (a)'s counts and one piece's
    step at 1 spp, which device-times profiles."""
    import torch

    from mcpt_tpu_torch.parallel.shard import (apply_params, make_mesh,
                                               make_train_step, select_params)
    from mcpt_tpu_torch.render.renderer import Renderer, render_pixels
    from mcpt_tpu_torch.scene.builtin import (envmap_matpreview,
                                              volumetric_caustic)

    r = Renderer(envmap_matpreview(res=GRAD_RES, spp=GRAD_SPP), device=dev)
    n = GRAD_RES * GRAD_RES
    idx = torch.arange(n, device=dev)
    p = select_params(r.scene, GRAD_FAMILIES)
    other = dict(p)
    other["tex.atlas"] = p["tex.atlas"] * 0.8
    other["bsdf.reflectivity_rgb"] = p["bsdf.reflectivity_rgb"] * torch.tensor(
        [1.0, 0.9, 0.8], device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        target = torch.cat([
            render_pixels(apply_params(r.scene, other), r.camera,
                          r.integrator, c, GRAD_SPP)
            for c in idx.split(GRAD_CHUNK)])
    torch.cuda.synchronize()
    target_s = time.perf_counter() - t0

    mesh = make_mesh([dev])
    step = make_train_step(r.integrator, GRAD_SPP, mesh, GRAD_FAMILIES,
                           grad_chunks=n // GRAD_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = step(r.scene, r.camera, idx, target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    norms = {k: float(v.norm()) for k, v in grads.items()}
    say(f"grad (a): envmap scene {GRAD_RES}x{GRAD_RES} {GRAD_SPP}spp "
        f"d{r.integrator.depth_max} train step, families {GRAD_FAMILIES}, "
        f"{n // GRAD_CHUNK} pieces of {GRAD_CHUNK} pixels: wall {wall:.3f} s "
        f"(target frame {target_s:.3f} s), peak device memory "
        f"{peak / 2**30:.2f} GiB, loss {float(loss):.6g}, K2 launches "
        f"{counts['K2']} ({counts['K2_any']} any-hit), K1 {counts['K1']}, on "
        f"{smi}; |grad| " + ", ".join(f"{k} {v:.4g}" for k, v in norms.items()))
    for k, v in grads.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"grad (a): {k} not finite")
    for k in ("tex.atlas", "bsdf.reflectivity_rgb", "bsdf.edgetint_rgb"):
        if not norms[k] > 0:
            raise AssertionError(f"grad (a): {k} gradient is zero")
    if counts["K2"] <= 0 or counts["K1"] or counts["K3"] or counts["K4"]:
        raise AssertionError(f"grad (a): not the march route alone ({counts})")

    grad_card_vs_cpu(volumetric_caustic, ("media",), dev,
                     "grad (b) volcaustic media")
    g = grad_card_vs_cpu(caustic_glass_by_path, ("bsdf",), dev,
                         "grad (b) caustic glass eta")
    if not float(g["bsdf.eta"].abs().max()) > 0:
        raise AssertionError("grad (b): the glass's eta gradient is zero")
    piece = make_train_step(r.integrator, 1, mesh, GRAD_FAMILIES)
    return counts, (lambda: piece(r.scene, r.camera, idx[:GRAD_CHUNK],
                                  target[:GRAD_CHUNK]))


#: frames a side of march-unbatched, alternating with the batched body
#: (2, not 3, to keep the run inside its budget: PERF.md §4)
MARCH_FRAMES = 2


def phase_march_unbatched(smi, r, batched_wall):
    """The march scene's frame by the unbatched body (MCPT_BATCH_TRACE=0)
    and by the batched one, alternating, MARCH_FRAMES frames a side, on
    render-march's renderer: both walls with their spread.  Returns the
    unbatched frames' kernel counts."""
    walls = {"batched": [batched_wall], "unbatched": []}
    for i in range(MARCH_FRAMES):
        for body, flag in (("unbatched", "0"), ("batched", "1")):
            if body == "batched" and i == MARCH_FRAMES - 1:
                break  # render-march's frame is the batched side's first
            with knobs({"MCPT_BATCH_TRACE": flag}):
                img, wall, counts = _render_timed(r, SPP, frame_base=2 + i)
                _check_image(img, f"march-unbatched {body}")
                if (body_taken(r.scene, counts, "march-unbatched") != body
                        or (body == "unbatched") != (counts["K2_any"] > 0)):
                    raise AssertionError(f"march-unbatched: not the {body} "
                                         f"body ({counts})")
            walls[body].append(wall)
            if body == "unbatched":
                unbatched_counts = counts
    med = {k: float(np.median(v)) for k, v in walls.items()}
    say("march-unbatched: frame walls on " + smi + "; " + "; ".join(
        f"{k} {', '.join(f'{w:.3f}' for w in v)} s (median {med[k]:.3f}, "
        f"spread {min(v):.3f}-{max(v):.3f})" for k, v in walls.items())
        + f"; K2 launches a frame: batched closest only, unbatched "
        f"{unbatched_counts['K2']} ({unbatched_counts['K2_any']} any-hit)")
    return unbatched_counts


def phase_pairs_by_march(dev, smi, pairs_wall):
    """The pairs scene forced down the block march (MCPT_TRAVERSAL=march),
    timed as render-pairs was: the evidence on this card for the auto
    rule, which sends scenes of chunks under 256 prims to the pair route."""
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_pairs

    with knobs({"MCPT_TRAVERSAL": "march"}):
        counts, wall, _ = phase_render_route(
            dev, smi, "pairs-by-march", cornell_mesh_pairs, "march", ("K2",),
            against_cpu=False)
    if counts["K3"] or counts["K4"]:
        raise AssertionError(f"pairs-by-march: K3/K4 launched ({counts})")
    faster = "pairs" if pairs_wall < wall else "march"
    say(f"pairs-by-march: the pairs scene's frame takes {pairs_wall:.3f} s "
        f"by the pair route and {wall:.3f} s by the block march on {smi}: "
        f"the {faster} route is faster here")


#: render-packet's card-vs-CPU check: every pixel of a 64x64 frame, at 1
#: spp and depth 3 (PERF.md §4)
PACKET_CHECK = dict(res=64, spp=1, depth=3, stride=1)


def phase_render_packet(dev, smi):
    """render-packet: the march scene with MCPT_TRAVERSAL=packet through
    the batched body and K5, 512x512, 16 spp, depth 8 after a 1-spp
    warm-up frame, no launch of K1-K4; then a 64x64 card render against
    the CPU's render of the pixels PACKET_CHECK names: a pixel's value
    does not depend on the other pixels of its tile.  Returns the
    counts, the wall and the renderer."""
    import torch

    from mcpt_tpu_torch.render.renderer import Renderer, render_tile_regen
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_march

    with knobs({"MCPT_TRAVERSAL": "packet"}):
        counts, wall, r_pkt = phase_render_route(
            dev, smi, "render-packet", cornell_mesh_march, "packet", ("K5",),
            against_cpu=False, body="batched", warmup_spp=1)
        if counts["K2"] or counts["K3"] or counts["K4"] or counts["K1"]:
            raise AssertionError(f"render-packet: not K5 alone ({counts})")
        c = PACKET_CHECK
        cfg = cornell_mesh_march(res=c["res"], spp=c["spp"],
                                 depth_max=c["depth"])
        a = Renderer(cfg, device=dev).render(spp=c["spp"], tile=TILE,
                                             spp_chunk=c["spp"])
        a = a.reshape(-1, 3)
        idx = torch.arange(0, c["res"] ** 2, c["stride"])
        r = Renderer(cfg, device="cpu")
        t0 = time.perf_counter()
        b = render_tile_regen(r.scene, r.camera, r.integrator, idx,
                              c["spp"]).numpy()
        cpu_s = time.perf_counter() - t0
    a = a[idx.numpy()]
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1)
    say(f"render-packet: {c['res']}x{c['res']} {c['spp']}spp d{c['depth']} "
        f"card vs cpu on {len(idx)} pixels (one in {c['stride']}; the "
        f"CPU's render took {cpu_s:.1f} s): {close.mean() * 100:.2f}% within "
        f"rtol 1e-3 "
        f"atol 1e-4, {int((a == b).all(axis=-1).sum())} bit-equal; means "
        f"card {np.round(a.mean(axis=0), 5).tolist()}, cpu "
        f"{np.round(b.mean(axis=0), 5).tolist()}")
    if close.mean() < 0.99 or not a.mean() > 0:
        raise AssertionError("render-packet: card and CPU renders disagree")
    return counts, wall, r_pkt


def phase_coh(dev):
    """coh: the march scene at 64x64, 4 spp with MCPT_COH=1 through the
    unbatched body (MCPT_BATCH_TRACE=0; the batched body carries no
    origin-chunk keys, as the reference's), card against CPU; the keys
    must reach the march's ray order; then the same card render with the
    option off: equal bit for bit, since only the order of rays changed."""
    from mcpt_tpu_torch.ops import traversal as TT
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_march

    keyed = []
    march_order = TT.march_order

    def spy(*args, **kwargs):
        coh = kwargs.get("coherence", args[6] if len(args) > 6 else None)
        keyed.append(coh is not None)
        return march_order(*args, **kwargs)

    TT.march_order = spy
    try:
        with knobs({"MCPT_COH": "1", "MCPT_BATCH_TRACE": "0"}):
            on = card_vs_cpu(cornell_mesh_march, dev, "coh MCPT_COH=1")
        n_keyed, n_calls = sum(keyed), len(keyed)
        with knobs({"MCPT_BATCH_TRACE": "0"}):
            off = Renderer(cornell_mesh_march(res=64, spp=4), device=dev
                           ).render(spp=4, tile=TILE, spp_chunk=4)
    finally:
        TT.march_order = march_order
    say(f"coh: {n_keyed} of {n_calls} march orders (card and CPU) took "
        f"origin-chunk keys; the card image with MCPT_COH=1 and without it "
        f"{'equal' if np.array_equal(on, off) else 'DIFFER'} bit for bit")
    if not n_keyed or not np.array_equal(on, off):
        raise AssertionError("coh: keys not used, or the image changed")


#: the sharded film (a) at the main path's size, and the process phases
#: (c), (d) and their train step at a smaller one (each subprocess spends
#: most of its seconds importing torch and loading the kernels)
SHARD_DEVICES = 3
PROC_RES, PROC_SPP, STEP_RES, STEP_SPP = 128, 16, 64, 2
STEP_FAMILIES = ("textures", "bsdf")


def _step_target(n):
    r = np.random.default_rng(9)
    return r.uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)


def sharded_worker(mode, port, rank, world, out):
    """One process of sharded (c) or (d): join the job (NCCL for "nccl",
    gloo for "gloo"), render the PROC_RES film by render_film_multihost on
    this process's mesh (every CUDA device it sees) and take one train
    step at STEP_RES over it; write both to `out` (.npz)."""
    import torch
    import torch.distributed as dist

    from mcpt_tpu_torch.ops import dense_sweep as ds
    from mcpt_tpu_torch.parallel.distributed import (init_distributed,
                                                     render_film_multihost)
    from mcpt_tpu_torch.parallel.shard import make_mesh, make_train_step
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import cornell_box

    if not torch.cuda.is_available():
        raise SystemExit("sharded worker: no CUDA device")
    init_distributed(f"localhost:{port}", world, rank,
                     backend=None if mode == "nccl" else "gloo")
    mesh = make_mesh()
    t0 = time.perf_counter()
    r = Renderer(cornell_box(res=PROC_RES, spp=PROC_SPP), device=mesh[0])
    film = render_film_multihost(r.scene, r.camera, r.integrator, PROC_SPP,
                                 mesh=mesh)
    n = STEP_RES * STEP_RES
    rs = Renderer(cornell_box(res=STEP_RES, spp=STEP_SPP), device=mesh[0])
    loss, grads = make_train_step(rs.integrator, STEP_SPP, mesh,
                                  STEP_FAMILIES)(
        rs.scene, rs.camera, torch.arange(n, device=mesh[0]),
        torch.as_tensor(_step_target(n), device=mesh[0]))
    torch.cuda.synchronize()
    say(f"sharded worker {mode} rank {rank}/{world}: backend "
        f"{dist.get_backend()}, rendered on {mesh[0].type} ({mesh}), K1 "
        f"launches {ds.launches}, film and step in "
        f"{time.perf_counter() - t0:.1f} s")
    if mesh[0].type != "cuda" or not ds.launches:
        raise AssertionError("sharded worker: did not render on the card")
    np.savez(out, film=film, loss=float(loss),
             **{k: v.cpu().numpy() for k, v in grads.items()})
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _compare_step(loss, grads, got, label):
    """A process's all-reduced step against the one-process step: loss
    within rtol 1e-5, every leaf within 1e-4 of its largest |value|."""
    worst, err = None, 0.0
    for k, v in grads.items():
        ref = v.cpu().numpy()
        scale = float(np.abs(ref).max())
        e = float(np.abs(got[k] - ref).max()) / scale if scale else 0.0
        if e >= err:
            worst, err = k, e
    say(f"{label}: loss {float(got['loss']):.6g} vs {float(loss):.6g}; "
        f"largest gradient difference {err:.3g} of its leaf's largest "
        f"({worst})")
    if abs(float(got["loss"]) / float(loss) - 1) > 1e-5 or err > 1e-4:
        raise AssertionError(f"{label}: the step differs from one process's")


def phase_sharded(dev, smi):
    """sharded: (c) and (d)'s processes start first and run beside (b):
    (c) one process joins an NCCL job of world size 1 and renders the
    PROC_RES film by render_film_multihost and one all-reduced train step;
    (d) two processes share the card over gloo (NCCL refuses two ranks on
    one GPU): the gathered film must equal one render_pixels call over
    every pixel bit for bit, and the step one process's within
    reassociation.  (b) make_train_step over [card] * 2 against [card] at
    STEP_RES, STEP_SPP.  Then (a), alone on the card: render_film_sharded
    of the Cornell box at 512x512, 16 spp, depth 8 over [card] *
    SHARD_DEVICES (262144 pixels do not divide by 3: padded), bit-equal
    to render_pixels over every pixel in one call; both walls."""
    import tempfile

    import torch

    from mcpt_tpu_torch.parallel.shard import (make_mesh, make_train_step,
                                               render_film_sharded)
    from mcpt_tpu_torch.render.renderer import Renderer, render_pixels
    from mcpt_tpu_torch.scene.builtin import cornell_box

    tmp = tempfile.TemporaryDirectory(dir=HERE, prefix="_sharded-")
    env = dict(os.environ, PYTHONPATH=HERE)
    jobs = [("nccl", 1, 0, _free_port())]
    port = _free_port()
    jobs += [("gloo", 2, rank, port) for rank in range(2)]
    procs = []
    try:
        for mode, world, rank, p in jobs:
            out = os.path.join(tmp.name, f"{mode}{rank}.npz")
            procs.append((mode, rank, out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--sharded-worker", mode, str(p), str(rank), str(world),
                 out], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))

        # the one-process references of (c) and (d), and (b)
        r = Renderer(cornell_box(res=PROC_RES, spp=PROC_SPP), device=dev)
        one = render_pixels(r.scene, r.camera, r.integrator,
                            torch.arange(PROC_RES * PROC_RES, device=dev),
                            PROC_SPP).cpu().numpy()
        n = STEP_RES * STEP_RES
        rs = Renderer(cornell_box(res=STEP_RES, spp=STEP_SPP), device=dev)
        idx = torch.arange(n, device=dev)
        target = torch.as_tensor(_step_target(n), device=dev)
        steps = {k: make_train_step(rs.integrator, STEP_SPP,
                                    make_mesh([dev] * k), STEP_FAMILIES)(
            rs.scene, rs.camera, idx, target) for k in (1, 2)}
        loss, grads = steps[1]
        if not float(grads["tex.color0"].abs().max()) > 0:
            raise AssertionError("sharded (b): the step has no gradient")
        two = {k: v.cpu().numpy() for k, v in steps[2][1].items()}
        two["loss"] = float(steps[2][0])
        _compare_step(loss, grads, two, f"sharded (b) train step over "
                      f"[{dev}] * 2 vs [{dev}], {STEP_RES}x{STEP_RES} "
                      f"{STEP_SPP}spp")

        for mode, rank, out, proc in procs:
            log, _ = proc.communicate(timeout=300)
            for line in log.splitlines():
                if line.startswith("sharded worker"):
                    say(line)
            if proc.returncode != 0:
                say(log[-3000:])
                raise AssertionError(f"sharded: worker {mode} rank {rank} "
                                     f"exited {proc.returncode}")
            got = np.load(out)
            same = np.array_equal(got["film"], one)
            say(f"sharded ({'c' if mode == 'nccl' else 'd'}) {mode} rank "
                f"{rank}: the {PROC_RES}x{PROC_RES} {PROC_SPP}spp film "
                f"{'equals' if same else 'DIFFERS from'} one render_pixels "
                f"call bit for bit")
            if not same:
                raise AssertionError("sharded: the film differs")
            _compare_step(loss, grads, got, f"sharded {mode} rank {rank} "
                          f"all-reduced train step")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        tmp.cleanup()

    # (a) alone on the card
    r = Renderer(cornell_box(), device=dev)
    mesh = make_mesh([dev] * SHARD_DEVICES)
    walls = {}
    for label, fn in (
            ("sharded", lambda: render_film_sharded(
                r.scene, r.camera, r.integrator, mesh, SPP)),
            ("one call", lambda: render_pixels(
                r.scene, r.camera, r.integrator,
                torch.arange(RES * RES, device=dev), SPP))):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        img = fn()
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t0, read_counts()["K1"],
                        img.cpu().numpy())
    same = np.array_equal(walls["sharded"][2], walls["one call"][2])
    _check_image(walls["sharded"][2], "sharded (a)")
    say(f"sharded (a): cornell {RES}x{RES} {SPP}spp d{DEPTH} by "
        f"render_film_sharded over [{dev}] * {SHARD_DEVICES} wall "
        f"{walls['sharded'][0]:.3f} s (K1 {walls['sharded'][1]}), by "
        f"render_pixels in one call {walls['one call'][0]:.3f} s (K1 "
        f"{walls['one call'][1]}), on {smi}: "
        f"{'equal' if same else 'DIFFERENT'} bit for bit")
    if not same or not walls["sharded"][1]:
        raise AssertionError("sharded (a): the films differ, or K1 was not "
                             "launched")


def phase_device_times(k1, k2, k3, k4, k5):
    """The queued device times (time_on_device), after every frame."""
    for record, field, fn, kernel, reps in _device_jobs:
        record[field] = kernel_ms(fn, kernel, reps=reps)
    for rec, label in ((k1, "K1(a)"), (k2, "K2 bounce"),
                       (k2["batched"], "K2 batched"),
                       (k2["envmap_batched"], "K2 envmap batched"),
                       (k3, "K3 bounce"), (k4, "K4 bounce"),
                       (k5, "K5 batched")):
        say(f"device-times: {label} {rec['device_ms']:.4f} ms of device time "
            f"a launch (between events {rec['ms']:.4f} ms)")
    say(f"device-times: K3 bounce against its bounds: {k3['bound_ms']:.4f} "
        f"ms for the slab tests it performs, {k3['full_sweep_bound_ms']:.4f} "
        f"ms for the full sweep; before the redesign "
        f"{K3_BEFORE_DEVICE_MS} ms of device time a launch")
    say(f"device-times: K1(b) cornell bounce {k1['cornell_device_ms']:.4f} ms "
        f"of device time a launch (between events {k1['cornell_ms']:.4f} ms)")
    from mcpt_tpu_torch.ops import dense_sweep as ds

    for key, row in k1["sweep_device_ms"].items():
        say(f"device-times: K1 shape sweep, {key} triangles (slices x rays "
            f"per thread: ms of device time a launch; the wrapper takes "
            f"{ds.shape_for(int(key.split()[0]))}): "
            + ", ".join(f"{k}: {v:.4f}" for k, v in row.items()))


# ------------------------------------------------------------- scene files

#: builtin.cornell_box's diffuse colours and light
CORNELL_COLORS = {"white": (0.725, 0.71, 0.68), "red": (0.63, 0.065, 0.05),
                  "green": (0.14, 0.45, 0.091)}
CORNELL_RADIANCE = (17.0, 12.0, 4.0)
#: the matpreview scene's sphere: 2 x 120 x 256 = 61,440 triangles, past
#: DENSE_MAX_PRIMS, so that the auto route takes the block march (at most
#: 2^16 padded prims keep 256-prim chunks; more would halve them to 64,
#: and the auto route would take the pair route)
MATPREVIEW_SPHERE = (120, 256)


def _xml_transform(scale=None, rot_x=0.0, rot_y=0.0, t=(0.0, 0.0, 0.0)):
    """builtin._xform's translate @ rot_y @ rot_x @ scale as a Mitsuba
    transform: each child left-multiplies, in document order."""
    parts = []
    if scale is not None:
        parts.append('<scale x="{}" y="{}" z="{}"/>'.format(*scale))
    if rot_x:
        parts.append(f'<rotate x="1" angle="{rot_x}"/>')
    if rot_y:
        parts.append(f'<rotate y="1" angle="{rot_y}"/>')
    parts.append('<translate x="{}" y="{}" z="{}"/>'.format(*t))
    return '<transform name="toWorld">' + "".join(parts) + "</transform>"


def _xml_sensor(res, spp, fov, origin, target, spp_value=None):
    return (
        f'<sensor type="perspective"><float name="fov" value="{fov}"/>'
        '<string name="fovAxis" value="x"/><transform name="toWorld">'
        '<lookat origin="{}, {}, {}" target="{}, {}, {}" up="0, 1, 0"/>'
        '</transform>'.format(*origin, *target)
        + '<sampler type="independent"><integer name="sampleCount" '
        f'value="{spp_value or spp}"/></sampler><film type="hdrfilm">'
        f'<integer name="width" value="{res}"/><integer name="height" '
        f'value="{res}"/></film></sensor>')


def write_cornell_scene(directory, res=RES, spp=SPP):
    """cornell.xml: the layout of builtin.cornell_box as a Mitsuba scene
    (walls and the light as rectangles, the two boxes as one OBJ file of
    24 triangles in world space), the path integrator at depth 8, RR from
    depth 5, and one perf default (mcpt.tile_retries, the renderer's own
    default).  Returns the XML's path."""
    from mcpt_tpu_torch.scene.builtin import _xform
    from mcpt_tpu_torch.scene.shapes import cube_mesh

    os.makedirs(directory, exist_ok=True)
    cube = cube_mesh()
    lines, base = [], 1
    for kw in (dict(scale=(0.3, 0.3, 0.3), rot_y=-17, t=(0.35, 0.3, 0.3)),
               dict(scale=(0.3, 0.6, 0.3), rot_y=17, t=(-0.35, 0.6, -0.3))):
        m = _xform(**kw)
        pos = cube.positions @ m[:3, :3].T + m[:3, 3]
        lines += ["v {:.9g} {:.9g} {:.9g}".format(*p) for p in pos]
        lines += ["f {} {} {}".format(*(f + base)) for f in cube.indices]
        base += len(pos)
    with open(os.path.join(directory, "boxes.obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    bsdfs = "".join(
        f'<bsdf type="diffuse" id="{name}"><rgb name="reflectance" '
        'value="{}, {}, {}"/></bsdf>'.format(*c)
        for name, c in CORNELL_COLORS.items())
    walls = [("white", dict(rot_x=-90)), ("white", dict(rot_x=90, t=(0, 2, 0))),
             ("white", dict(t=(0, 1, -1))), ("red", dict(rot_y=90, t=(-1, 1, 0))),
             ("green", dict(rot_y=-90, t=(1, 1, 0)))]
    shapes = "".join(f'<shape type="rectangle">{_xml_transform(**kw)}'
                     f'<ref id="{bsdf}"/></shape>' for bsdf, kw in walls)
    shapes += ('<shape type="obj"><string name="filename" value="boxes.obj"/>'
               '<ref id="white"/></shape>')
    shapes += (f'<shape type="rectangle">{_xml_transform((0.25, 0.25, 1), 90, 0, (0, 1.98, 0))}'
               '<emitter type="area"><rgb name="radiance" value="{}, {}, {}"/>'
               '</emitter></shape>'.format(*CORNELL_RADIANCE))
    xml = ('<scene version="0.6.0"><default name="mcpt.tile_retries" '
           'value="2"/>'
           + _xml_sensor(res, spp, 39.0, (0, 1, 4.5), (0, 1, 0))
           + f'<integrator type="path"><integer name="maxDepth" value="{DEPTH}"/>'
           f'<integer name="rrDepth" value="{DEPTH_RR}"/></integrator>'
           + bsdfs + shapes + "</scene>")
    path = os.path.join(directory, "cornell.xml")
    with open(path, "w") as fh:
        fh.write(xml)
    return path


def write_ply(path, mesh):
    """A binary little-endian PLY of `mesh`'s positions, normals and
    triangles, written with numpy."""
    v = np.zeros(len(mesh.positions), [("p", "<f4", 3), ("n", "<f4", 3)])
    v["p"], v["n"] = mesh.positions, mesh.normals
    f = np.zeros(len(mesh.indices), [("k", "u1"), ("i", "<i4", 3)])
    f["k"], f["i"] = 3, mesh.indices
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\nproperty float x\nproperty float y\n"
            "property float z\nproperty float nx\nproperty float ny\n"
            f"property float nz\nelement face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as fh:
        fh.write(head.encode() + v.tobytes() + f.tobytes())


def write_matpreview_scene(directory, res=RES, spp=SPP):
    """matpreview.xml: a matpreview-class scene lit by a `sunsky` emitter
    alone (the sun's position from a date, a time and a place): a
    61,440-triangle sphere from a binary PLY in a rough conductor of a
    named material (Au, from ior_lut), a cube in a rough plastic whose
    diffuse albedo is an EXR bitmap (written by the port's write_exr) and
    whose IOR is named, and a floor with a checkerboard albedo under a uv
    transform; path integrator at depth 8, the sample count through a
    <default>.  All opaque: the block march and the batched regen body.
    Returns the XML's path."""
    from mcpt_tpu_torch.scene.builtin import _tile_bitmap, uv_sphere_mesh
    from mcpt_tpu_torch.utils.image import write_exr

    os.makedirs(directory, exist_ok=True)
    write_ply(os.path.join(directory, "sphere.ply"),
              uv_sphere_mesh(*MATPREVIEW_SPHERE))
    write_exr(os.path.join(directory, "tile.exr"), _tile_bitmap(size=64))
    xml = (
        f'<scene version="0.6.0"><default name="spp" value="{spp}"/>'
        + _xml_sensor(res, spp, 40.0, (0.6, 1.9, 5.2), (0.5, 0.75, 0.0),
                      spp_value="$spp")
        + f'<integrator type="path"><integer name="maxDepth" value="{DEPTH}"/>'
        '</integrator>'
        '<texture type="checkerboard" id="checks"><rgb name="color0" '
        'value="0.8, 0.78, 0.75"/><rgb name="color1" value="0.2"/>'
        '<transform name="to_uv"><scale x="8" y="8"/></transform></texture>'
        '<bsdf type="roughconductor" id="gold"><string name="material" '
        'value="Au"/><float name="alpha" value="0.2"/><string '
        'name="distribution" value="ggx"/></bsdf>'
        '<bsdf type="roughplastic" id="plastic"><float name="alpha" '
        'value="0.1"/><string name="intIOR" value="polypropylene"/>'
        '<texture type="bitmap" name="diffuseReflectance"><string '
        'name="filename" value="tile.exr"/></texture></bsdf>'
        '<bsdf type="diffuse" id="floor"><ref name="reflectance" '
        'id="checks"/></bsdf>'
        '<shape type="ply"><string name="filename" value="sphere.ply"/>'
        + _xml_transform(t=(0.0, 1.0, 0.0)) + '<ref id="gold"/></shape>'
        '<shape type="cube">'
        + _xml_transform((0.45, 0.45, 0.45), 0, 30, (1.7, 0.46, 0.6))
        + '<ref id="plastic"/></shape><shape type="rectangle">'
        + _xml_transform((6.0, 6.0, 1.0), -90)
        + '<ref id="floor"/></shape>'
        '<emitter type="sunsky"><float name="turbidity" value="3"/>'
        '<integer name="year" value="2010"/><integer name="month" value="7"/>'
        '<integer name="day" value="10"/><float name="hour" value="15"/>'
        '<float name="latitude" value="35.6894"/><float name="longitude" '
        'value="139.6917"/><float name="timezone" value="9"/>'
        '<integer name="resolution" value="512"/></emitter></scene>')
    path = os.path.join(directory, "matpreview.xml")
    with open(path, "w") as fh:
        fh.write(xml)
    return path


def phase_cli(dev, smi):
    """cli: each scene file rendered by `python -m mcpt_tpu_torch.cli`'s
    main on the card at 512x512, 16 spp, depth 8, its EXR read back by the
    port's read_exr (finite, mean above 0); K1 must launch on cornell.xml
    and K2 on matpreview.xml, each alone; then each parsed config's 64x64
    card render against its CPU render, on every pixel; one warm
    tile-chunk of matpreview's frame profiled as in device-times; then
    cornell.xml by `python -m mcpt_tpu_torch.cli` in a process of its own.
    Returns each scene's counts and wall."""
    import tempfile

    import torch

    from mcpt_tpu_torch import cli
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.parser import load_config
    from mcpt_tpu_torch.utils.image import read_exr

    def small(xml):
        def make(res, spp):
            cfg = load_config(xml)
            cfg.camera.width = cfg.camera.height = res
            cfg.camera.spp = spp
            return cfg
        return make

    out = {}
    with tempfile.TemporaryDirectory() as tmp, environ_restored():
        for name, write, kernel in (("cornell", write_cornell_scene, "K1"),
                                    ("matpreview", write_matpreview_scene,
                                     "K2")):
            xml = write(os.path.join(tmp, name))
            exr = os.path.join(tmp, f"{name}.exr")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["-i", xml, "-o", exr])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            img = read_exr(exr)
            others = [k for k in ("K1", "K2", "K3", "K4")
                      if k != kernel and counts[k]]
            if rc != 0 or counts[kernel] <= 0 or others:
                raise AssertionError(f"cli {name}: rc {rc}, not {kernel} "
                                     f"alone ({counts})")
            if (img.shape != (RES, RES, 3) or not np.isfinite(img).all()
                    or not img.mean() > 0):
                raise AssertionError(f"cli {name}: the EXR read back is not "
                                     f"a finite {RES}x{RES} image above 0")
            say(f"cli {name}: cli.main -i {name}.xml -o {name}.exr, "
                f"{RES}x{RES} {SPP}spp d{DEPTH}, wall {wall:.3f} s (parse, "
                f"commit, render, write) on {smi}; {kernel} launches "
                f"{counts[kernel]} ({counts[kernel + '_any']} any-hit), "
                f"others 0; EXR mean "
                f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")
            card_vs_cpu(small(xml), dev, f"cli {name}", min_share=1.0)
            out[name] = (counts, wall)
        # where matpreview's frame goes: one warm tile-chunk profiled
        tile_chunk_profile(Renderer(load_config(xml), device=dev),
                           "cli matpreview", smi)
        # the command line itself, in a process of its own, on the card
        xml = os.path.join(tmp, "cornell", "cornell.xml")
        exr = os.path.join(tmp, "cornell-cmd.exr")
        cmd = [sys.executable, "-m", "mcpt_tpu_torch.cli", "-i", xml, "-o", exr]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=300)
        wall = time.perf_counter() - t0
        log = proc.stdout.replace("\r", "\n").splitlines()
        if (proc.returncode != 0 or not os.path.exists(exr)
                or not any("committed on cuda" in line for line in log)):
            raise AssertionError(f"cli command: rc {proc.returncode}, not "
                                 f"rendered on the card: {proc.stderr[-2000:]}")
        img = read_exr(exr)
        _check_image(img, "cli command")
        rendered = [line for line in log if line.startswith("[info] rendered")]
        say(f"cli command: python -m mcpt_tpu_torch.cli -i cornell.xml -o "
            f"cornell-cmd.exr: wall {wall:.3f} s from the process's start "
            f"(on {smi}); {rendered[-1] if rendered else ''}; EXR mean "
            f"{np.round(img.mean(axis=(0, 1)), 4).tolist()}")
    return out


def main():
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    t_start = time.perf_counter()

    begin("env")
    name, smi = phase_env()
    import torch

    dev = torch.device("cuda", 0)
    begin("build")
    phase_build()
    begin("kernel-K1")
    k1 = phase_kernel(dev)
    begin("render-cornell")
    n_cornell = phase_render_cornell(dev, smi)
    begin("render-mesh")
    n_mesh = phase_render_mesh(dev, smi)
    # K1's time is taken at render-mesh's triangle count (16384), and
    # cornell_ms at render-cornell's: each beside its own path's launches
    k1["launches"] = n_mesh
    k1["cornell_launches"] = n_cornell
    begin("kernel-K2")
    k2 = phase_kernel_k2(dev)
    begin("kernel-K3K4")
    k3, k4 = phase_kernel_k3k4(dev)
    begin("kernel-K5")
    k5 = phase_kernel_k5(dev)

    from mcpt_tpu_torch.scene.builtin import (
        cornell_mesh_march, cornell_mesh_materials, cornell_mesh_pairs)

    begin("render-march")
    c_m, march_wall, r_m = phase_render_route(
        dev, smi, "render-march", cornell_mesh_march, "march", ("K2",),
        body="batched")
    begin("march-unbatched")
    phase_march_unbatched(smi, r_m, march_wall)
    del r_m
    begin("render-materials")
    c_mat, _, _ = phase_render_route(
        dev, smi, "render-materials", cornell_mesh_materials, "march",
        ("K2",), body="batched", warmup_spp=1, spp=MATERIALS_SPP)
    begin("render-pairs")
    c_p, pairs_wall, _ = phase_render_route(
        dev, smi, "render-pairs", cornell_mesh_pairs, "pairs", ("K3", "K4"),
        body="unbatched")
    begin("pairs-by-march")
    phase_pairs_by_march(dev, smi, pairs_wall)
    begin("render-packet")
    c_pkt, _, r_pkt = phase_render_packet(dev, smi)
    k5["launches"] = c_pkt["K5"]
    begin("coh")
    phase_coh(dev)
    begin("render-envmap")
    c_env, _, r_env = phase_render_envmap(dev, smi)
    begin("render-lights")
    c_lights, _, r_lights = phase_render_lights(dev, smi)
    k1["lights_launches"] = c_lights["K1"]
    begin("render-volcaustic")
    c_vol, _, r_vol = phase_render_volcaustic(dev, smi)
    k1["volcaustic_launches"] = {"closest": c_vol["K1"] - c_vol["K1_any"],
                                 "any_hit": c_vol["K1_any"]}
    begin("engine-chunked")
    phase_engine_chunked(dev)
    begin("s1-means")
    phase_s1_means(dev)
    begin("sharded")
    phase_sharded(dev, smi)
    begin("device-times")
    phase_device_times(k1, k2, k3, k4, k5)
    with knobs({"MCPT_TRAVERSAL": "packet"}):
        tile_chunk_profile(r_pkt, "render-packet", smi)
    del r_pkt
    for r, label, spp in ((r_env, "render-envmap", SPP_CHUNK),
                          (r_lights, "render-lights", LIGHTS_PROFILE_SPP),
                          (r_vol, "render-volcaustic", SPP_CHUNK)):
        tile_chunk_profile(r, label, smi, spp)
    del r_env, r_lights, r_vol
    # the BDPT and gradient cells come last, after device-times' kernel_ms
    # sessions, which kept too few launches when these phases ran first
    begin("render-bdpt")
    c_bdpt, bdpt_sample = phase_render_bdpt(dev, smi)
    k1["bdpt_launches"] = {"closest": c_bdpt["K1"] - c_bdpt["K1_any"],
                           "any_hit": c_bdpt["K1_any"]}
    begin("grad")
    c_grad, grad_piece = phase_grad(dev, smi)
    # before the profiles below: frames timed after torch.profiler
    # sessions were slower (see _device_jobs)
    begin("cli")
    c_cli = phase_cli(dev, smi)
    begin("device-times (bdpt, grad)")
    profile_run(bdpt_sample, f"device-times: render-bdpt one sample-tile "
                f"({TILE} px x 1 spp)", smi)
    profile_run(grad_piece, f"device-times: grad (a) one piece ({GRAD_CHUNK} "
                f"px x 1 spp, forward and backward)", smi)
    del bdpt_sample, grad_piece
    k1["cli_cornell_launches"] = {
        "closest": c_cli["cornell"][0]["K1"] - c_cli["cornell"][0]["K1_any"],
        "any_hit": c_cli["cornell"][0]["K1_any"]}
    c_cli_mat = c_cli["matpreview"][0]["K2"]
    k2["launches"] = (c_m["K2"] + c_mat["K2"] + c_p["K2"] + c_env["K2"]
                      + c_grad["K2"] + c_cli_mat)
    k2["launches_by_path"] = {"render-march": c_m["K2"],
                              "render-materials": c_mat["K2"],
                              "render-pairs": c_p["K2"],
                              "render-envmap": c_env["K2"],
                              "grad": c_grad["K2"],
                              "cli matpreview": c_cli_mat}
    k3["launches"] = c_p["K3"]
    k4["launches"] = c_p["K4"]

    signal.alarm(0)
    begin("end")
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        mode, port, rank, world, out = sys.argv[2:7]
        sharded_worker(mode, int(port), int(rank), int(world), out)
        sys.exit(0)
    sys.exit(main())
