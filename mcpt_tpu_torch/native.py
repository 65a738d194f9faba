"""The port's host C code, built with gcc at first use and bound by ctypes
(counterpart of mcpt_tpu/native/__init__.py's PIZ and SAH bindings,
:29-80 and :126-148).

* `csrc/piz.c` is a copy of the reference's OpenEXR PIZ decoder (Huffman +
  wavelet), which `utils/image.py::read_exr` calls for PIZ chunks.
* `csrc/sah.c` is a copy of the reference's binned-SAH chunk partition,
  which `scene/geometry.py::march_pack` calls at scene commit.

Both run on the host, as in the reference: they are not device kernels.
A library lands in `_build/<name>-<hash of the source>/lib<name>.so`,
never beside its source, so an edited source is rebuilt and an unchanged
one reused.  A failed build raises (subprocess.CalledProcessError): no
caller switches to a Python version on its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from mcpt_tpu_torch.build import BUILD_DIR, CSRC

PIZ_SOURCE = CSRC / "piz.c"
SAH_SOURCE = CSRC / "sah.c"
GCC_FLAGS = ("-O2", "-fPIC", "-shared")


def library_path(name: str = "piz"):
    """Where csrc/<name>.c's library is built."""
    h = hashlib.sha256((CSRC / f"{name}.c").read_bytes())
    h.update(" ".join(GCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def _build(name: str):
    lib = library_path(name)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        # build under a private name and rename: concurrent first uses
        # (test workers) never load a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["gcc", *GCC_FLAGS, str(CSRC / f"{name}.c"), "-o",
                        str(tmp)], check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def piz():
    """The PIZ decoder library with its argtypes set."""
    lib = ctypes.CDLL(str(_build("piz")))
    lib.piz_uncompress.restype = ctypes.c_int
    lib.piz_uncompress.argtypes = [
        ctypes.c_char_p,                  # in
        ctypes.c_long,                    # in_len
        ctypes.c_int,                     # n_channels
        ctypes.POINTER(ctypes.c_int),     # nx per channel
        ctypes.POINTER(ctypes.c_int),     # ny per channel
        ctypes.POINTER(ctypes.c_uint16),  # out
        ctypes.c_long,                    # out_count
    ]
    return lib


def piz_decode(payload: bytes, nx_list, ny_list):
    """Decode one PIZ chunk: (the decoder's return code, its planar uint16
    output, channel-major).  The output is meaningful only for code 0."""
    n = len(nx_list)
    total = sum(int(a) * int(b) for a, b in zip(nx_list, ny_list))
    out = np.zeros(total, np.uint16)
    nx = (ctypes.c_int * n)(*[int(v) for v in nx_list])
    ny = (ctypes.c_int * n)(*[int(v) for v in ny_list])
    rc = piz().piz_uncompress(
        payload, len(payload), n, nx, ny,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), total)
    return rc, out


def piz_uncompress(payload: bytes, nx_list, ny_list):
    """Decode one PIZ chunk to a list of per-channel uint16 planes [ny, nx];
    raises ValueError with the decoder's code on a corrupt payload."""
    rc, out = piz_decode(payload, nx_list, ny_list)
    if rc != 0:
        raise ValueError(f"PIZ decode failed (code {rc})")
    planes = []
    off = 0
    for a, b in zip(nx_list, ny_list):
        planes.append(out[off: off + a * b].reshape(b, a))
        off += a * b
    return planes


@functools.lru_cache(maxsize=1)
def sah():
    """The SAH partition library with its argtypes set."""
    lib = ctypes.CDLL(str(_build("sah")))
    lib.sah_chunks.restype = ctypes.c_long
    lib.sah_chunks.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # cent [n, 3]
        ctypes.POINTER(ctypes.c_float),   # tmin [n, 3]
        ctypes.POINTER(ctypes.c_float),   # tmax [n, 3]
        ctypes.c_long,                    # n
        ctypes.c_long,                    # leaf
        ctypes.c_int,                     # nbins
        ctypes.POINTER(ctypes.c_long),    # order out [n]
        ctypes.POINTER(ctypes.c_long),    # chunk_off out [max_chunks + 1]
        ctypes.c_long,                    # max_chunks
    ]
    return lib


def sah_chunks(cent, tmin, tmax, leaf: int, nbins: int = 16):
    """The binned-SAH partition of prims into chunks of at most `leaf`: a
    list of int64 index arrays, the chunks of geometry._sah_chunks_py in
    the reverse of its order (left child first)."""
    n = int(cent.shape[0])
    cent = np.ascontiguousarray(cent, np.float32)
    tmin = np.ascontiguousarray(tmin, np.float32)
    tmax = np.ascontiguousarray(tmax, np.float32)
    order = np.empty(max(n, 1), np.int64)
    max_chunks = n + 1
    off = np.empty(max_chunks + 1, np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    lp = ctypes.POINTER(ctypes.c_long)
    count = sah().sah_chunks(
        cent.ctypes.data_as(fp), tmin.ctypes.data_as(fp),
        tmax.ctypes.data_as(fp), n, int(leaf), int(nbins),
        order.ctypes.data_as(lp), off.ctypes.data_as(lp), max_chunks)
    if count < 0:
        raise RuntimeError("sah_chunks failed")
    return [order[off[j]:off[j + 1]] for j in range(count)]
