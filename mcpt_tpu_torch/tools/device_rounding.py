"""Where the card rounds otherwise than the CPU, and what it does to renders.

    python -m mcpt_tpu_torch.tools.device_rounding

1. Each elementwise function the integrators call, in torch's float32
   version and in ops/math.py's device-stable one (float64, rounded to
   float32; sqrt correctly rounded; a 3-wide sum added in index order),
   on 65536 seeded inputs on the card and on the CPU: how many lanes
   differ.
2. 64x64, 4 spp renders card against CPU (chip_smoke.card_vs_cpu's
   measure: the share of pixels within rtol 1e-3, atol 1e-4, and the
   channel means' largest relative difference) of the volumetric-caustic
   scene (isotropic and HG fog, regen and chunked engines) and of the S1
   scene (bump_and_bead, both bump heights), first with the port's math
   switched back to torch's float32 functions and sums (the math before
   fault F6's repair), then with the device-stable math.
3. What the stable math costs: the Cornell box's 512x512, 16 spp frame
   wall (after a warm-up frame) by the float32 and the stable math in
   turns, `--frames` frames each.

Prints one line a measurement and, last, one JSON object.  Needs a CUDA
device.
"""

from __future__ import annotations

import functools
import json
import sys


def main(argv=None) -> int:
    import argparse
    import time

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3,
                    help="Cornell frames timed by each math")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("device_rounding: no CUDA device", file=sys.stderr)
        return 1
    import mcpt_tpu_torch.ops.math as M
    import mcpt_tpu_torch.render.renderer  # noqa: F401  (every module)
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.builtin import (RIPPLE_HEIGHT, bump_and_bead,
                                              cornell_box,
                                              volumetric_caustic)

    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "ops": {}, "renders": {}}
    g = torch.Generator().manual_seed(0)
    n = 65536
    a = torch.randn(n, 3, generator=g) * torch.rand(n, 1, generator=g) * 10
    b = torch.randn(n, 3, generator=g)
    x = torch.rand(n, generator=g)
    native = {"sum3": lambda p: p.sum(dim=-1), "sqrt": torch.sqrt,
              "exp": torch.exp, "log1p": torch.log1p, "sin": torch.sin,
              "cos": torch.cos, "tan": torch.tan, "atan": torch.atan,
              "atan2": torch.atan2, "arccos": torch.arccos}
    stable = {"sum3": M.channel_sum, **{k: getattr(M, k) for k in native
                                       if k != "sum3"}}
    inputs = {"sum3": (a * b,), "sqrt": (x * 50,), "exp": (-x * 50,),
              "log1p": (-x,), "sin": (x * 20 - 10,), "cos": (x * 20 - 10,),
              "tan": (x * 6 - 3,), "atan": (x * 20 - 10,),
              "atan2": (x - 0.5, b[:, 0]), "arccos": (x * 2 - 1,)}
    for name, xs in inputs.items():
        row = out["ops"][name] = {}
        for kind, fns in (("float32", native), ("stable", stable)):
            cpu = fns[name](*xs)
            card = fns[name](*(t.to(dev) for t in xs)).cpu()
            row[kind] = int((cpu != card).sum())
        print(f"{name}: lanes of {n} that differ card vs CPU: torch float32 "
              f"{row['float32']}, stable {row['stable']}", flush=True)

    def card_vs_cpu(make, engine):
        small = make(res=64, spp=4)
        kw = dict(spp=4, tile=1 << 16, spp_chunk=4, engine=engine)
        c = Renderer(small, device=dev).render(**kw)
        p = Renderer(small, device="cpu").render(**kw)
        close = float(np.isclose(c, p, rtol=1e-3, atol=1e-4).all(-1).mean())
        rel = float(np.abs(c.mean((0, 1)) / p.mean((0, 1)) - 1).max())
        return close, rel

    renders = {
        "volcaustic isotropic regen": (volumetric_caustic, "regen"),
        "volcaustic hg regen": (functools.partial(
            volumetric_caustic, phase="hg", g=-0.5), "regen"),
        "volcaustic isotropic chunked": (volumetric_caustic, "chunked"),
        "s1 amplitude 0.02": (functools.partial(bump_and_bead,
                                                amplitude=0.02), "regen"),
        f"s1 amplitude {RIPPLE_HEIGHT}": (bump_and_bead, "regen"),
    }
    # the float32 math: every module's stable helpers swapped for torch's
    swap = {getattr(M, k): native[k] for k in native if k != "sum3"}
    swap[M.channel_sum] = native["sum3"]
    swap[M.dot] = lambda u, v, keepdim=False: (u * v).sum(dim=-1,
                                                         keepdim=keepdim)
    patched = [(mod, k, f) for name, mod in list(sys.modules.items())
               if name.startswith("mcpt_tpu_torch")
               for k, f in vars(mod).items() if callable(f) and f in swap]
    print(f"the float32 math swaps {len(patched)} names in the port's "
          f"modules", flush=True)
    def use(math_kind):
        for mod, k, f in patched:
            setattr(mod, k, swap[f] if math_kind == "float32" else f)

    for math_kind in ("float32", "stable"):
        use(math_kind)
        for label, (make, engine) in renders.items():
            close, rel = card_vs_cpu(make, engine)
            out["renders"][f"{math_kind} {label}"] = {
                "pixels_close": close, "means_rel_diff": rel}
            print(f"{math_kind} math, {label}: {close * 100:.2f}% pixels "
                  f"close, channel means rel diff {rel:.3g}", flush=True)

    cornell = Renderer(cornell_box(), device=dev)
    walls = out["cornell_frame_s"] = {"float32": [], "stable": []}
    for i in range(args.frames + 1):
        for math_kind in (("float32", "stable") if i % 2 else
                          ("stable", "float32")):
            use(math_kind)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cornell.render(spp=16, tile=1 << 16, spp_chunk=8, frame_base=i)
            torch.cuda.synchronize()
            if i:  # frame 0 of each math warms up
                walls[math_kind].append(time.perf_counter() - t0)
    for math_kind, w in walls.items():
        print(f"cornell 512x512 16spp frame by the {math_kind} math: "
              + ", ".join(f"{x:.3f}" for x in w)
              + f" s (median {float(np.median(w)):.3f})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
