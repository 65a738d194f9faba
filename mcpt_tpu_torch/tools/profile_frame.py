"""Where one frame of the main path spends its time on the card.

    python -m mcpt_tpu_torch.tools.profile_frame [--res 512] [--spp 16]
        [--scene cornell|sphere|march|pairs|materials|envmap|lights|
                 volcaustic]
        [--frames 1]

Renders a built-in scene (scene/builtin.py: the Cornell box, the box with
the 16200-triangle sphere, one of the two mesh scenes past
DENSE_MAX_PRIMS, one per large-scene route, the march scene in every
BSDF family, the envmap scene, the lights scene or the volumetric-caustic
scene, at its own depth: 16 for volcaustic, else 8) once to warm up and
times
`--frames` frames with the host clock (their median is the frame wall).
Then it records one tile-chunk of that frame (the first 64k-pixel tile,
the first spp chunk: one shade_regen call of the scene's integrator,
1/8 of a 512x512 16-spp frame) under torch.profiler
(CPU + CUDA activity) and prints the device's busy time, its idle share
of the same tile-chunk's unprofiled wall time, the number of device
activities (kernels, copies, sets) and the kernels with the most device
time, and the device time of each of the port's kernels (K1 dense sweep,
K2 march, K3 corridor, K4 pair sweep).  It names the regen body the
frame takes (batched or unbatched; MCPT_BATCH_TRACE=0 forces the
unbatched one).  The last line is the same as one JSON object.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

TOP = 8  # kernels listed
#: the port's kernels by the name of their __global__ function
KERNELS = {"K1": "dense_sweep_kernel", "K2": "march_kernel",
           "K3": "corridor_kernel", "K4": "pair_kernel"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--scene", default="cornell",
                    choices=("cornell", "sphere", "march", "pairs",
                             "materials", "envmap", "lights",
                             "volcaustic"))
    ap.add_argument("--frames", type=int, default=1,
                    help="frames timed after the warm-up (median reported)")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene import builtin

    make = {"cornell": builtin.cornell_box,
            "sphere": lambda **kw: builtin.cornell_box(sphere=True, **kw),
            "march": builtin.cornell_mesh_march,
            "pairs": builtin.cornell_mesh_pairs,
            "materials": builtin.cornell_mesh_materials,
            "envmap": builtin.envmap_matpreview,
            "lights": builtin.lights_showcase,
            "volcaustic": builtin.volumetric_caustic}[args.scene]
    cfg = make(res=args.res, spp=args.spp)
    r = Renderer(cfg, device="cuda")

    def frame(base):
        r.render(spp=args.spp, tile=1 << 16, spp_chunk=8, frame_base=base)
        torch.cuda.synchronize()

    frame(0)
    walls = []
    for base in range(1, args.frames + 1):
        t0 = time.perf_counter()
        frame(base)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    print(f"frame wall {wall:.3f} s" + (
        f" (median of {len(walls)}: "
        + ", ".join(f"{w:.3f}" for w in walls) + ")" if len(walls) > 1 else ""),
        flush=True)

    from mcpt_tpu_torch.integrators.path import _use_batched_trace
    from mcpt_tpu_torch.render.renderer import render_tile_regen

    n_pix = args.res * args.res
    tile = min(1 << 16, n_pix)
    chunk = min(8, args.spp)
    idx = torch.arange(tile, device="cuda")

    def tile_chunk():
        render_tile_regen(r.scene, r.camera, r.integrator, idx, chunk,
                          frame_base=2, spp_total=args.spp)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    tile_chunk()
    chunk_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tile_chunk()
        prof_wall = time.perf_counter() - t0

    # device activities only (kernels, copies, sets): the CPU-side aten
    # rows carry the same device time again
    per_name: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us, count = per_name.get(evt.name, (0.0, 0))
        per_name[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
    rows = sorted(((k, us / 1e6, c) for k, (us, c) in per_name.items()),
                  key=lambda x: -x[1])
    busy = sum(s for _, s, _ in rows)
    launches = sum(c for _, _, c in rows)
    kern = {k: sum(s for key, s, _ in rows if fn in key)
            for k, fn in KERNELS.items()}
    name = torch.cuda.get_device_name(0)
    body = "batched" if _use_batched_trace(r.scene) else "unbatched"
    print(f"device {name}; scene {args.scene}, {body} body, frame "
          f"{args.res}x{args.res} {args.spp}spp d{cfg.integrator.depth_max}, "
          f"{cfg.integrator.itype}; profiled one tile-chunk "
          f"of {tile} pixels x {chunk} spp")
    print(f"tile-chunk wall {chunk_wall:.3f} s ({prof_wall:.3f} s profiled); "
          f"device busy {busy:.3f} s, idle share {1 - busy / chunk_wall:.3f}; "
          f"{launches} device activities; "
          + ", ".join(f"{k} {v:.4f} s" for k, v in kern.items()))
    for key, s, count in rows[:TOP]:
        print(f"  {s * 1e3:9.2f} ms {count:7d}x  {key[:90]}")
    print(json.dumps({
        "device": name, "res": args.res, "spp": args.spp,
        "scene": args.scene, "body": body, "wall_s": wall, "walls_s": walls,
        "profiled_tile": tile, "profiled_spp": chunk,
        "tile_chunk_wall_s": chunk_wall, "profiled_wall_s": prof_wall,
        "device_busy_s": busy, "idle_share": 1 - busy / chunk_wall,
        "device_activities": launches,
        "kernel_device_s": kern,
        "top": [[k[:90], s, c] for k, s, c in rows[:TOP]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
