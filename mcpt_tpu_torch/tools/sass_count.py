"""Instructions per ray-triangle test in the built kernels, read from SASS.

    python -m mcpt_tpu_torch.tools.sass_count [--lib PATH]

Builds the kernel library (mcpt_tpu_torch/build.py), disassembles it with
`cuobjdump -sass`, and for each ray-triangle kernel (K1 at every shape,
K4) finds the loop that runs the tests: of the loops (a backward branch
and its target) that hold a MUFU.RCP, the one densest in fp32 adds and
multiplies.  Every test of ray_tests.cuh::moller_trumbore
divides once and its division's fast path has one MUFU.RCP (the slow path
is a subroutine outside the loop), so the loop's instructions over its
MUFU.RCP count are the instructions issued per test, loop overhead and
row loads included.  Prints one line per kernel and, last, one JSON
object.  `--lib` reads another build of the library instead (another
checkout's `_build/<hash>/libmcpt_kernels.so`).  Needs the CUDA toolkit
(nvcc, cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

#: kernels reported, by a pattern of their mangled names
KERNELS = {
    "K1": re.compile(r"dense_sweep_kernel(?:ILi(\d+)ELi(\d+)ELb(\d)E)?"),
    "K4": re.compile(r"pair_kernel(?:ILb(\d)E)?"),
}
#: fp32 operations that issue on the FMA pipe
FP32 = ("FADD", "FMUL", "FFMA")

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_TARGET = re.compile(r"(0x[0-9a-f]+)|`\(([^)]+)\)")
_LABEL = re.compile(r"^\s*([.\w$]+):")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found")


def functions(sass: str) -> dict[str, list[str]]:
    """Mangled function name -> its SASS lines."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur is not None:
            out[cur].append(line)
    return out


def parse(lines: list[str]):
    """[(address, opcode, text)] and {label: address}."""
    insns, labels, pending = [], {}, []
    for line in lines:
        lab = _LABEL.match(line)
        if lab and "/*" not in line:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        text = m.group(2).strip()
        for p in pending:
            labels[p] = addr
        pending = []
        body = re.sub(r"^@!?U?P\w+\s+", "", text)
        insns.append((addr, body.split()[0] if body else "", text))
    return insns, labels


def test_loop(lines: list[str]):
    """Opcode counts of the loop that runs the tests, or None: among the
    loops (a backward branch and its target) that hold a MUFU.RCP, the
    one with the largest share of fp32 adds and multiplies (outer loops
    add staging and barriers, an epilogue loop global loads and stores)."""
    insns, labels = parse(lines)
    best, best_share = None, -1.0
    for i, (addr, op, text) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(text.split(None, 1)[-1] if " " in text else "")
        if not m:
            continue
        target = int(m.group(1), 16) if m.group(1) else labels.get(m.group(2))
        if target is None or target >= addr:
            continue
        body = [o for a, o, _ in insns[:i + 1] if target <= a <= addr]
        if not any(o.startswith("MUFU.RCP") for o in body):
            continue
        share = sum(o.split(".")[0] in FP32 for o in body) / len(body)
        if share > best_share:
            best, best_share = body, share
    if best is None:
        return None
    return collections.Counter(best)


def report(counts) -> dict:
    tests = sum(n for o, n in counts.items() if o.startswith("MUFU.RCP"))
    total = sum(counts.values())
    fp32 = sum(n for o, n in counts.items() if o.split(".")[0] in FP32)
    ffma = sum(n for o, n in counts.items() if o.split(".")[0] == "FFMA")
    return {"loop_insns": total, "tests_per_iter": tests,
            "insns_per_test": total / tests, "fp32_per_test": fp32 / tests,
            "ffma_per_test": ffma / tests, "top": dict(counts.most_common(8))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", help="a built libmcpt_kernels.so to read")
    args = ap.parse_args(argv)
    if args.lib:
        lib = args.lib
    else:
        from mcpt_tpu_torch import build

        lib = build.build()["path"]
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    result = {}
    for name, lines in sorted(functions(sass).items()):
        for key, pat in KERNELS.items():
            m = pat.search(name)
            if not m:
                continue
            g = m.groups()
            label = key
            if key == "K1" and g[0]:
                label += f" shape {g[0]}x{g[1]}"
            if g[-1] is not None:
                label += " any-hit" if g[-1] == "1" else " closest"
            counts = test_loop(lines)
            if counts is None:
                print(f"{label}: no loop with a division found")
                continue
            rep = report(counts)
            result[label] = rep
            print(f"{label}: {rep['insns_per_test']:.1f} instructions per "
                  f"test ({rep['loop_insns']} in the loop, "
                  f"{rep['tests_per_iter']} tests), fp32 add/mul/fma "
                  f"{rep['fp32_per_test']:.1f} (FFMA {rep['ffma_per_test']:.1f}); "
                  f"most: {rep['top']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
