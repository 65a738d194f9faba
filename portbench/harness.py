"""The benchmark's core: find a cell's files, set the program up, run the
window, reduce it to metrics, check the outputs and print the result.

A cell `<config>.<traffic>` of BENCHMARK.json is made of
  configs/<config>.json   the configuration's numbers (BENCHMARK.json's
                          `file`), with `source`, `reduced`;
  configs/<config>.py     `make_scene(cfg)`: the scene those numbers give;
  traffic/<traffic>.json  the mix: samples a call, the warm-up, the
                          reference's samples a pixel;
  metrics/<metric>.py     `read(ctx)` of each per-layer metric.
Adding a cell, a mix or a metric adds files and BENCHMARK.json entries;
nothing here names one.

The window drives `Renderer.render` as `cli.py --progressive k --tile
<pixels>` does: one call at a time (a closed loop), every call the whole
film as one device batch (`tile` = the film's pixels) at the program's
default `spp_chunk`, `frame_base` = a base from the seed plus the
samples already done, and the film folded on the host into the running
average.  A job of the configuration's spp starts again from 0 once it
is done.  The end-to-end arithmetic is `end_to_end` below.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mcpt_tpu")
GIB = float(1 << 30)
#: a traced run profiles whole calls for at most this many seconds of its
#: window: the profiler's stop takes ~35 s a million events, and a
#: window of 51 s holds ~3 million on the card
TRACE_SECONDS = 15.0


# -- cells ------------------------------------------------------------------

def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, root: Path = ROOT):
        root = Path(root)
        here = root / "portbench"
        self.here = here
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name = name
        self.chips = int(w["chips"])
        self.config_name = w["config"]
        self.traffic_name = w["traffic"]
        self.cfg = json.loads((root / conf["file"]).read_text())
        self.scene_module = load_module(
            here / "configs" / f"{w['config']}.py",
            "portbench_config_" + w["config"].replace("-", "_"))
        self.traffic = json.loads(
            (here / "traffic" / f"{w['traffic']}.json").read_text())

        def mine(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def scene(self):
        return self.scene_module.make_scene(self.cfg)

    def reader(self, metric: str):
        return load_module(self.here / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}").read


# -- arithmetic -------------------------------------------------------------

def percentile(values, q):
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(calls, window_s, setup_s, peak_bytes):
    """Every end-to-end metric's value.  calls: [(samples, seconds)] of
    each call in the window, in order; window_s: from the first call's
    start to the last call's return, the calls and everything between."""
    samples = sum(s for s, _ in calls)
    return {
        "samples_per_s": samples / window_s / 1e6,
        "pass_ms_p90": percentile([t for _, t in calls], 90) * 1e3,
        "peak_mem_gib": peak_bytes / GIB,
        "setup_s": setup_s,
    }


def process_age() -> float | None:
    """Seconds since this process started, from /proc (Linux), or None."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as fh:
            return float(fh.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return None


def host_clocks():
    """(this process's CPU seconds, the machine's steal seconds from
    /proc/stat or None): read around the window, to tell a slow host from
    a busy one."""
    steal = None
    try:
        with open("/proc/stat") as fh:
            steal = int(fh.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.process_time(), steal


class GcClock:
    """Seconds and count of the collector's runs while installed."""

    def __init__(self):
        self.seconds, self.runs, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.runs += 1


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# -- a run ------------------------------------------------------------------

def counters():
    """The program's traversal launch counters, summed by name."""
    from mcpt_tpu_torch.ops import dense_sweep, march_sweep, packet_sweep, pair_sweep
    return {
        "launches": dense_sweep.launches + march_sweep.launches
        + packet_sweep.launches,
        "corridor_launches": pair_sweep.corridor_launches,
        "pair_launches": pair_sweep.pair_launches,
    }


def checked_scene(cell: Cell, seed: int, shrink=None):
    """(scene, drawn pixels, their regions, the first call's frame base)
    of a run of `cell` from `seed`."""
    from portbench import check
    scene = cell.scene()
    check_cfg = dict(cell.cfg["check"])
    if shrink is not None:
        shrink(scene, check_cfg)
    pix, region = check.draw_pixels(scene.width, scene.height,
                                    tuple(check_cfg["regions"]),
                                    int(check_cfg["pixels_per_region"]), seed)
    return scene, pix, region, (seed * 2654435761) & 0xFFFFFFFF


def reference_bases(base0, k, traffic, calls):
    """The reference's frame bases: those of the window's first calls
    (base0, base0 + k, ...), as many as there were distinct calls, at
    most reference_spp / k."""
    g = min(calls, int(traffic["reference_spp"]) // k)
    return [base0 + i * k for i in range(g)]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", shrink=None, wrap=None, log=print,
             t_start: float | None = None, min_calls: int = 2):
    """One run of `cell`; returns the result's dict.  `shrink(scene,
    check)` may resize the scene and the check, and `min_calls` lengthen
    the window (tests on the CPU); `wrap` may wrap the renderer (tests
    that break the timed path)."""
    import torch

    from mcpt_tpu_torch.render.renderer import Renderer
    from mcpt_tpu_torch.scene.parser import load_config
    from portbench import check
    from portbench.scene import write_mitsuba

    t0 = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    dev = torch.device(device)
    if cuda:
        torch.empty(1, device=dev)
    scene, pix, region, base0 = checked_scene(cell, seed, shrink)
    tr = cell.traffic
    k = int(tr["spp_per_call"])
    job = int(scene.spp)
    n_pix = scene.n_pixels

    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        xml = write_mitsuba(scene, tmp)
        t = time.perf_counter()
        renderer = Renderer(load_config(xml), device=dev)
        if cuda:
            torch.cuda.synchronize()
        commit_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if wrap is not None:
        renderer = wrap(renderer)

    def call(spp, frame_base):
        return renderer.render(spp=spp, tile=n_pix, frame_base=frame_base)

    t = time.perf_counter()
    call(int(tr["warm_spp"]), base0 + job)
    if cuda:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    log(f"[portbench] {cell.name}: {scene.width}x{scene.height}, "
        f"{scene.n_triangles} triangles, calls of {k} spp, tile {n_pix} "
        f"(the film), spp_chunk the program's default, frame_base "
        f"{base0} + samples done; commit {commit_s:.3f} s, warm-up "
        f"({tr['warm_spp']} spp) {warm_s:.3f} s")

    rec = None
    if trace:
        from portbench.trace import Recorder
        rec = Recorder(cuda)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    age = process_age()
    setup_s = age if age is not None else time.perf_counter() - t0
    c0 = counters()
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    h0 = host_clocks()
    if rec is not None:
        rec.start()
    done, acc, times, films = 0, None, [], {}
    w0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        fb = base0 + done
        img = call(k, fb)
        acc = img if acc is None else (acc * done + img * k) / (done + k)
        t2 = time.perf_counter()
        times.append(t2 - t1)
        films.setdefault(fb, img.reshape(-1, 3)[pix].copy())
        done += k
        if done >= job:
            done, acc = 0, None
        if t2 - w0 >= (min(seconds, TRACE_SECONDS) if trace else seconds) \
                and len(times) >= min_calls:
            break
    window_s = t2 - w0
    h1 = host_clocks()
    gc.callbacks.remove(gc_clock)
    steal = "not read" if h0[1] is None else f"{h1[1] - h0[1]:.2f} s"
    log(f"[portbench] host in the window: {h1[0] - h0[0]:.3f} s of CPU, "
        f"{gc_clock.runs} collections in {gc_clock.seconds:.3f} s, "
        f"the machine's steal {steal}; call seconds "
        + " ".join(f"{x:.3f}" for x in times))
    events = None
    if rec is not None:
        t = time.perf_counter()
        events = rec.stop()
        log(f"[portbench] trace: {len(events[0])} device and {len(events[1])} "
            f"host events read in {time.perf_counter() - t:.3f} s")
    c1 = counters()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    samples = [(n_pix * k, t) for t in times]

    # the check: the reference at the drawn pixels, the program's state freed
    del renderer, img, acc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from portbench.reference.pathtracer import Reference
    t = time.perf_counter()
    ref = Reference(scene, device=dev).samples(
        torch.as_tensor(pix), k, reference_bases(base0, k, tr, len(films)),
        seed ^ 0x5EED5EED)
    numbers = check.compare([(k, x) for x in films.values()], ref.numpy(), region)
    correct, rows = check.verdict(numbers)
    q = np.percentile(times, [0, 50, 100]) * 1e3
    log(f"[portbench] window {window_s:.3f} s, {len(times)} calls "
        f"({len(films)} distinct; min, median, max {q[0]:.1f}, {q[1]:.1f}, "
        f"{q[2]:.1f} ms), reference {time.perf_counter() - t:.3f} s "
        f"({numbers['reference_spp']} spp at {numbers['pixels']} pixels), "
        f"noise ratio {numbers['noise_ratio']:.4f}")

    result = {"correct": bool(correct), "attempted": len(times), "failed": 0}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(peak)}
    if trace:
        t = time.perf_counter()
        ctx = trace_context(events, samples, window_s, c1, c0, commit_s,
                            warm_s)
        log(f"[portbench] trace reduced in {time.perf_counter() - t:.3f} s")
        device_info["busy_s"] = ctx["busy_s"]
        device_info["window_s"] = ctx["window_s"]
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = ctx["breakdown"]
    else:
        values = end_to_end(samples, window_s, setup_s, peak)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    if cuda:
        device_info["power"] = power_limit() or "not measured"
    result["device"] = device_info
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


def control(cell: Cell, seed: int, n_calls: int, device="cuda",
            shrink=None):
    """The numbers compared when the reference in bfloat16 stands in for
    the program: n_calls calls of the cell's samples a call at the drawn
    pixels, against the float32 reference as a run compares them."""
    import torch

    from portbench import check
    from portbench.reference.pathtracer import Reference
    scene, pix, region, base0 = checked_scene(cell, seed, shrink)
    k = int(cell.traffic["spp_per_call"])
    pix = torch.as_tensor(pix)
    low = Reference(scene, device, torch.bfloat16).samples(
        pix, k, [base0 + c * k for c in range(n_calls)],
        seed ^ 0xC0117401).numpy()
    ref = Reference(scene, device).samples(
        pix, k, reference_bases(base0, k, cell.traffic, n_calls),
        seed ^ 0x5EED5EED).numpy()
    calls = [(k, low[:, i * k:(i + 1) * k].mean(1)) for i in range(n_calls)]
    return check.compare(calls, ref, region)


def trace_context(events, samples, window_s, c1, c0, commit_s, warm_s):
    """What the per-layer readers read: the traced window's device events,
    busy and window seconds, samples, counters, set-up spans, and the
    breakdown.  On the card the trace holds the device's activities and
    the CUDA runtime calls that the host made (torch.profiler's CUDA
    activity alone: host ops would triple the traced wall); idle gaps are
    named by the runtime call around them, or 'host, outside any op'
    (Python and the ops' dispatch between launches)."""
    from portbench import trace
    dev, host = events
    stamps = [e[1] for e in dev + host] + [e[2] for e in dev + host]
    gaps = trace.idle_gaps(dev, (min(stamps), max(stamps))) if stamps else []
    by_host = trace.host_at(host, [(a + b) // 2 for a, b in gaps])
    return {
        "device": dev,
        "busy_s": trace.union_seconds(dev),
        "window_s": window_s,
        "samples": sum(s for s, _ in samples),
        "counters": {k: c1[k] - c0[k] for k in c1},
        "commit_s": commit_s,
        "warm_s": warm_s,
        "breakdown": {
            "device_ops": trace.top_by_name(
                [(n, (e - s) / 1e9) for n, s, e in dev]),
            "idle_gaps": trace.top_by_name(
                [(n, (b - a) / 1e9) for n, (a, b) in zip(by_host, gaps)]),
        },
    }


def main(argv, t_start=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      log=log, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the process holds {', '.join(bad)}: refused",
              file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
