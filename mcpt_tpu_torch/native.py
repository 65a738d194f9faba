"""The port's host C code, built with gcc at first use and bound by ctypes
(counterpart of mcpt_tpu/native/__init__.py's PIZ binding, :29-60).

`csrc/piz.c` is a copy of the reference's OpenEXR PIZ decoder (Huffman +
wavelet), which `utils/image.py::read_exr` calls for PIZ chunks.  It runs
on the host, as in the reference: it is not a device kernel.  The library
lands in `_build/piz-<hash of the source>/libpiz.so`, never beside its
source, so an edited source is rebuilt and an unchanged one reused.
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
GCC_FLAGS = ("-O2", "-fPIC", "-shared")


def library_path():
    h = hashlib.sha256(PIZ_SOURCE.read_bytes())
    h.update(" ".join(GCC_FLAGS).encode())
    return BUILD_DIR / f"piz-{h.hexdigest()[:16]}" / "libpiz.so"


def _build():
    lib = library_path()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        # build under a private name and rename: concurrent first uses
        # (test workers) never load a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["gcc", *GCC_FLAGS, str(PIZ_SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def piz():
    """The PIZ decoder library with its argtypes set."""
    lib = ctypes.CDLL(str(_build()))
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
