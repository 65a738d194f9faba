"""Eager operations per wavefront iteration of a built-in scene, on the CPU.

    python -m mcpt_tpu_torch.tools.op_count [--scene cornell|lights|
        volcaustic|...] [--lanes 65536] [--res 512]

Runs one tile-chunk of a 512x512 16-spp frame by the regen engine (the
lanes spread evenly over the frame, one spp chunk of 8) on the CPU and
counts the PyTorch operations it dispatches and its wavefront iterations
(one interpolate_hit a regen iteration).  The frames are host-bound on
the card (PERF.md section 5): a tile-chunk's wall there follows the ops
an iteration times the iterations, so this count predicts a new scene's
wall from a measured one's before it runs on the card.  Prints one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell",
                    choices=("cornell", "march", "materials", "envmap",
                             "lights", "volcaustic"))
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--res", type=int, default=512)
    args = ap.parse_args(argv)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from mcpt_tpu_torch.integrators import path, volpath
    from mcpt_tpu_torch.render.renderer import Renderer, render_tile_regen
    from mcpt_tpu_torch.scene import builtin

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    iters = [0]
    interpolate = path.interpolate_hit

    def counted(*a, **kw):
        iters[0] += 1
        return interpolate(*a, **kw)

    path.interpolate_hit = volpath.interpolate_hit = counted
    make = {"cornell": builtin.cornell_box,
            "march": builtin.cornell_mesh_march,
            "materials": builtin.cornell_mesh_materials,
            "envmap": builtin.envmap_matpreview,
            "lights": builtin.lights_showcase,
            "volcaustic": builtin.volumetric_caustic}[args.scene]
    r = Renderer(make(res=args.res), device="cpu")
    n_pix = args.res * args.res
    idx = torch.arange(0, n_pix, max(n_pix // args.lanes, 1))[:args.lanes]
    t0 = time.perf_counter()
    with Count() as count:
        render_tile_regen(r.scene, r.camera, r.integrator, idx, 8,
                          frame_base=2, spp_total=16)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "scene": args.scene, "lanes": int(idx.shape[0]), "ops": count.n,
        "iterations": iters[0], "ops_per_iteration": count.n / iters[0],
        "cpu_wall_s": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
