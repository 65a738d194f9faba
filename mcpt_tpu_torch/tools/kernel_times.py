"""K1's, K3's, K4's and K5's times on the card by two measures, for any
checkout.

    python3 mcpt_tpu_torch/tools/kernel_times.py [--root DIR] [--reps 20]

Times the dense sweep (K1) on chip_smoke.py's input (a) (65536 random rays,
every 16th dead, x 16384 random triangles), the corridor (K3) on the pairs
scene's first-bounce rays (chip_smoke.camera_and_bounce) and the pair
sweep (K4) on their pairs (ops/traversal.py::pair_inputs) and the BVH
walk (K5) on the batched body's 131072-lane input of the materials scene
in the packet route's order (chip_smoke.batched_input, packet_args), each
through its wrapper (K1 and K4 in closest-hit and in any-hit mode), by
two measures: the median time between CUDA events
around one call (chip_smoke.cuda_ms, which also counts the wrapper's host
time) and the median device time of one launch (chip_smoke.kernel_ms).
`--root` imports mcpt_tpu_torch from another checkout (a `git archive` of
another commit), so that two versions of a kernel are timed by one script
on one card; run the tool by its path, not with -m, so that no other copy
of the package is imported first.  Prints one line per kernel and mode
and, last, one JSON object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose mcpt_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, root)  # ahead of the path chip_smoke put first
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import mcpt_tpu_torch
    from mcpt_tpu_torch import build
    from mcpt_tpu_torch.ops import dense_sweep as ds
    from mcpt_tpu_torch.ops import packet_sweep as pkt
    from mcpt_tpu_torch.ops import pair_sweep as psw
    from mcpt_tpu_torch.ops.math import MAX_FLOAT
    from mcpt_tpu_torch.ops.traversal import pair_inputs
    from mcpt_tpu_torch.scene.builtin import cornell_mesh_pairs

    if os.path.dirname(os.path.dirname(mcpt_tpu_torch.__file__)) != root:
        raise SystemExit(f"kernel_times: imported {mcpt_tpu_torch.__file__}, "
                         f"not the package under {root}")
    build.library()
    dev = torch.device("cuda", 0)
    n, p = 65536, 16384
    o_np, d_np = cs.random_rays(n)
    o = torch.as_tensor(o_np, device=dev)
    d = torch.as_tensor(d_np, device=dev)
    tris = torch.as_tensor(cs.random_tris(p), device=dev)
    lo = torch.full((n,), 1e-4, device=dev)
    hi = torch.full((n,), MAX_FLOAT, device=dev)
    hi[::16] = 0.0
    scene, cam = cs._scene(cornell_mesh_pairs, dev)
    g = scene.geom
    _, ob, db, lob, hib = cs.camera_and_bounce(scene, cam, dev)[1]
    k = psw.pair_k()
    _, _, *pairs = pair_inputs(g, ob, db, lob, hib, k)
    pargs = (*pairs, g.march_tris, g.march_prim)
    calls = {"K3": (
        lambda: psw.corridor(ob, db, lob, hib, g.march_min, g.march_max, k),
        "corridor_kernel", f"{len(ob)} bounce rays x {g.n_march_leaves} "
        f"chunks, K={k}")}
    _, g_b, args_b = cs.batched_input(dev)
    kargs = cs.packet_args(g_b, *args_b[:4])
    calls["K5"] = (lambda: pkt.packet_sweep(*kargs), "packet_kernel",
                   f"{len(kargs[0])} batched lanes x {g_b.n_pad_leaves} "
                   f"leaves of {g_b.leaf_size}")
    for any_hit in (False, True):
        mode = " any-hit" if any_hit else ""
        calls["K1" + mode] = (
            lambda a=any_hit: ds.dense_sweep(o, d, lo, hi, tris, a),
            "dense_sweep_kernel", f"{n} random rays x {p} random triangles")
        calls["K4" + mode] = (
            lambda a=any_hit: psw.pair_sweep(*pargs, a), "pair_kernel",
            f"{len(pairs[0])} bounce pairs x {g.march_prim.shape[1]} "
            f"triangles")
    out = {"card": cs.nvidia_smi("name,power.limit"), "root": root}
    for name, (fn, kernel, shape) in calls.items():
        event = cs.cuda_ms(fn, reps=args.reps)
        device = cs.kernel_ms(fn, kernel, reps=args.reps)
        print(f"{name} {shape}: {event:.4f} ms between events around one "
              f"call, {device:.4f} ms of device time a launch", flush=True)
        out[name] = {"event_ms": event, "device_ms": device, "shape": shape}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
