"""Build and load the port's CUDA kernels.

Every source in `csrc/` is compiled by its own `nvcc` for sm_90a, all at
once, and the objects are linked into one shared library with a plain C
interface, which `ctypes` loads.  (PyTorch's
`cpp_extension.load` would include PyTorch's headers and needs ninja; a
plain `nvcc` build of a C-ABI file takes seconds instead of minutes.)

The library lands in `_build/<hash>/libmcpt_kernels.so`, where <hash>
covers the sources and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Beside it, `ptxas.txt` keeps the assembler's
register and spill report of that build.  Nothing else is written there.
A failed build raises with nvcc's stderr; nothing falls back to the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libmcpt_kernels.so"
PTXAS_NAME = "ptxas.txt"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no contraction into FMAs and no fast math: the kernels repeat their
    # plain PyTorch versions' arithmetic op for op
    "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: name -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    "mcpt_dense_sweep": [_P] * 5 + [_I] * 4 + [_P] * 7,
    "mcpt_march_sweep": [_P] * 10 + [_I] * 7 + [_P] * 7,
    "mcpt_march_smem_bytes": [_I] * 5,
    "mcpt_corridor": [_P] * 6 + [_I] * 3 + [_P] * 3,
    "mcpt_corridor_tile": [],
    "mcpt_pair_sweep": [_P] * 7 + [_I] * 5 + [_P] * 7,
    "mcpt_packet_sweep": [_P] * 6 + [_I] * 4 + [_P] * 7,
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _ptxas_report(err: str) -> list[str]:
    """ptxas -v's registers, shared memory and spills, one line a kernel,
    named as `kernel<template args>`."""
    out, name = [], "?"
    for ln in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_kernel)(I((?:L[ib]\d+E)+)E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(3):
                name += "<" + ",".join(re.findall(r"L[ib](\d+)E", k.group(3))) + ">"
        elif "ptxas info" in ln and "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}")
        elif "spill" in ln and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln):
            out.append(f"{name}: {ln.strip()}")
    return out


def build() -> dict:
    """Compile the kernels unless an up-to-date library exists.

    Returns {"path", "seconds", "built", "ptxas"} — `ptxas` holds the
    assembler's register, shared-memory and spill report of the build
    that made the library (kept beside it), one line a kernel
    (_ptxas_report)."""
    out = library_path()
    report = out.with_name(PTXAS_NAME)
    if out.exists():
        kept = report.read_text().splitlines() if report.exists() else []
        return {"path": str(out), "seconds": 0.0, "built": False,
                "ptxas": kept}
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ptxas, failed = [], None
    for cmd, obj, proc in jobs:
        _, err = proc.communicate()
        ptxas += _ptxas_report(err)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    objs = [obj for _, obj, _ in jobs]
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    tmp_report = out.with_name(f"{PTXAS_NAME}.{tag}")
    try:
        if failed is None:
            cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed = (cmd, proc.returncode, proc.stderr)
        if failed is not None:
            cmd, code, err = failed
            print(err, flush=True)
            raise RuntimeError(f"nvcc failed (exit {code}): {' '.join(cmd)}")
        tmp_report.write_text("".join(f"{ln}\n" for ln in ptxas))
        os.replace(tmp_report, report)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        tmp_report.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "built": True, "ptxas": ptxas}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every C
    function's argtypes and restype declared."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_longlong if name.endswith("_bytes")
                      else ctypes.c_int)
    return lib
