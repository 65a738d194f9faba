"""Offline render CLI (counterpart of mcpt_tpu/cli.py; csrt apps/main.cpp).

    python -m mcpt_tpu_torch.cli -i scene.xml -o out.exr [-s spp] [-w W] [-h H]

The reference's flags with the same meanings and file naming (`-i -o -w
-h -s`, apps/main.cpp:98-199, plus `--tile --depth-max --progressive
--checkpoint --serve --set`), and two more: `--device`, default `cuda`,
and `--trace-out`.  The port's entry points run on the card unless the
caller asks for the CPU (`--device cpu`); without CUDA a run on the
default device raises.
`--trace-out FILE.json` writes where the run's time went (spans and
counters, mcpt_tpu_torch/trace.py) as Chrome trace-event JSON.
`--progressive N` writes a snapshot every N spp, named
`{stem}_{done:05d}spp{ext}`; `--checkpoint FILE.npz` keeps the film and
the samples done (keys `film`, `spp_done`), and a rerun resumes from it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mcpt_tpu_torch",
        description="Monte Carlo path tracer (PyTorch/CUDA)",
        add_help=False,
    )
    ap.add_argument("--help", action="help")
    ap.add_argument("-i", "--input", required=True, help="Mitsuba XML scene")
    ap.add_argument("-o", "--output", default=None, help="output image (.png/.exr)")
    ap.add_argument("-s", "--spp", type=int, default=None, help="samples per pixel")
    ap.add_argument("-w", "--width", type=int, default=None)
    ap.add_argument("-h", "--height", type=int, default=None)
    ap.add_argument("--tile", type=int, default=1 << 16, help="pixels per device batch")
    ap.add_argument(
        "--progressive", type=int, default=0, metavar="N",
        help="write a snapshot every N spp (0 = off)",
    )
    ap.add_argument("--depth-max", type=int, default=None)
    ap.add_argument(
        "--checkpoint", default=None, metavar="FILE.npz",
        help="accumulate film+spp into FILE; rerunning resumes from it "
             "(film/sample-count/RNG offset are the whole render state)",
    )
    ap.add_argument(
        "--serve", type=int, default=None, metavar="PORT",
        help="live progressive preview over HTTP on PORT",
    )
    ap.add_argument(
        "--set", action="append", default=[], metavar="KNOB=VALUE",
        dest="perf_sets",
        help="performance knob override (e.g. --set march_block=64 "
             "--set traversal=pairs); becomes the MCPT_* env default — "
             "same tier as XML <default name=\"mcpt.*\"> entries",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to render on (default cuda; cpu runs the "
             "kernels' plain versions)",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="FILE.json",
        help="write the run's spans and counters (scene set-up, calls, "
             "tile-chunks, traversals, host waits) as Chrome trace-event "
             "JSON, for Perfetto or chrome://tracing",
    )
    args = ap.parse_args(argv)

    import torch

    from mcpt_tpu_torch import trace
    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.parser import load_config
    from mcpt_tpu_torch.utils.image import write_exr, write_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: CUDA is not available; pass "
            "--device cpu to render on the CPU")

    if args.trace_out:
        trace.reset()
        trace.enable()
    t0 = time.time()
    config = load_config(args.input)
    if args.width:
        config.camera.width = args.width
    if args.height:
        config.camera.height = args.height
    if args.spp:
        config.camera.spp = args.spp
    if args.depth_max:
        config.integrator.depth_max = args.depth_max
    for kv in args.perf_sets:
        if "=" not in kv:
            ap.error(f"--set expects KNOB=VALUE, got {kv!r}")
        key, _, value = kv.partition("=")
        config.perf[key.strip()] = value.strip()

    output = args.output
    if output is None:
        output = os.path.splitext(os.path.basename(args.input))[0] + ".png"
    print(f"[info] loaded '{args.input}' in {time.time() - t0:.2f}s; "
          f"{config.camera.width}x{config.camera.height} @ {config.camera.spp} spp")

    t0 = time.time()
    renderer = Renderer(config, device=device)
    print(f"[info] scene committed on {device} in {time.time() - t0:.2f}s")

    def save(img, path):
        if path.lower().endswith(".exr"):
            write_exr(path, img)
        else:
            write_png(path, img)

    server = None
    if args.serve is not None:
        from mcpt_tpu_torch.render.preview import PreviewServer

        server = PreviewServer(args.serve)
        print(f"[info] live preview at http://0.0.0.0:{server.port}/")

    t0 = time.time()
    try:
        if args.progressive > 0 or args.checkpoint or server is not None:
            import numpy as np

            total = config.camera.spp
            acc = None
            done = 0
            if args.checkpoint and os.path.exists(args.checkpoint):
                ckpt = np.load(args.checkpoint)
                acc = ckpt["film"]
                done = int(ckpt["spp_done"])
                print(f"[info] resumed checkpoint at {done} spp")
            step_size = args.progressive or max(total // 8, 1)
            stem, ext = os.path.splitext(output)
            while done < total:
                step = min(step_size, total - done)
                img = renderer.render(spp=step, tile=args.tile, frame_base=done)
                acc = img if acc is None else (acc * done + img * step) / (done + step)
                done += step
                if args.checkpoint:
                    np.savez_compressed(args.checkpoint, film=acc, spp_done=done)
                if args.progressive:
                    save(acc, f"{stem}_{done:05d}spp{ext}")
                if server is not None:
                    server.update(acc)
                print(f"[info] {done}/{total} spp  ({time.time() - t0:.1f}s)")
            img = acc
        else:
            img = renderer.render(spp=config.camera.spp, tile=args.tile,
                                  progress=True)
    finally:
        if server is not None:
            server.close()
    dt = time.time() - t0
    n_pix = config.camera.width * config.camera.height
    print(f"[info] rendered in {dt:.2f}s "
          f"({n_pix * config.camera.spp / dt / 1e6:.2f} Msamples/s)")
    save(img, output)
    print(f"[info] wrote '{output}'")
    if args.trace_out:
        trace.disable()
        with open(args.trace_out, "w") as fh:
            json.dump(trace.chrome_trace(trace.snapshot()), fh)
        print(f"[info] wrote the trace '{args.trace_out}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
