"""mcpt_tpu_torch/scene/loaders.py against mcpt_tpu/scene/loaders.py.

Every mesh file is written here (tests/test_loaders.py's quad writers,
and writers of OBJ and Mitsuba `.serialized` files), read by both
packages' `load_mesh`, and the port's MeshData must EQUAL the
reference's, array for array: both loaders are the same numpy code on
the host, so no tolerance.
"""

import json
import struct
import zlib

import numpy as np
import pytest

from mcpt_tpu.scene import loaders as jl
from mcpt_tpu_torch.scene import ir as tir
from mcpt_tpu_torch.scene import loaders as tl
from tests.test_loaders import IDX, NRM, POS, UV, _gltf_dict

FIELDS = ("positions", "indices", "normals", "texcoords", "tangents")


def assert_same_mesh(got, want):
    assert isinstance(got, tir.MeshData)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _both(path, **kw):
    got, want = tl.load_mesh(str(path), **kw), jl.load_mesh(str(path), **kw)
    assert_same_mesh(got, want)
    return got


def write_obj(path):
    """A quad and a pentagon (fan-triangulated), with negative (relative)
    indices, corners without a texcoord, and shared corners."""
    lines = ["# two faces", "o quad"]
    lines += ["v {} {} {}".format(*p) for p in POS]
    lines += ["vt {} {}".format(*t) for t in UV]
    lines += ["vn {} {} {}".format(*n) for n in NRM]
    lines += ["f 1/1/1 2/2/1 3/3/1 4/4/1",
              "v 2 0 0", "v 3 0 0", "v 3 1 0.5", "v 2.5 2 0", "v 2 1 0.5",
              "f -5//1 -4//1 -3//1 -2//1 -1//1", "f 1/1/1 3/3/1 4/4/1"]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("flip,face_normals", [(True, False), (False, True)])
def test_obj(tmp_path, flip, face_normals):
    path = tmp_path / "mesh.obj"
    write_obj(path)
    mesh = _both(path, flip_texcoords=flip, face_normals=face_normals)
    assert mesh.indices.shape == (2 + 3 + 1, 3)
    assert (mesh.normals is None) == face_normals


def _ply_ascii(path):
    lines = ["ply", "format ascii 1.0", "comment quad", "element vertex 4",
             "property float x", "property float y", "property float z",
             "property float nx", "property float ny", "property float nz",
             "property float u", "property float v",
             "element face 1", "property list uchar int vertex_indices",
             "end_header"]
    for p, n, t in zip(POS, NRM, UV):
        lines.append(" ".join(str(v) for v in [*p, *n, *t]))
    lines.append("4 0 1 2 3")
    path.write_bytes(("\n".join(lines) + "\n").encode())


def _ply_binary(path, order="<"):
    endian = "little" if order == "<" else "big"
    head = (f"ply\nformat binary_{endian}_endian 1.0\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property double s\nproperty double t\n"
            "element face 2\nproperty list uchar uint vertex_indices\n"
            "end_header\n").encode()
    v = np.zeros(4, [("p", order + "f4", 3), ("uv", order + "f8", 2)])
    v["p"], v["uv"] = POS, UV
    body = v.tobytes()
    for f in IDX:
        body += struct.pack(order + "B", 3) + f.astype(order + "u4").tobytes()
    path.write_bytes(head + body)


@pytest.mark.parametrize("kind", ["ascii", "binary_le", "binary_be"])
def test_ply(tmp_path, kind):
    path = tmp_path / f"{kind}.ply"
    if kind == "ascii":
        _ply_ascii(path)
    else:
        _ply_binary(path, "<" if kind == "binary_le" else ">")
    mesh = _both(path)
    np.testing.assert_array_equal(mesh.indices, IDX)
    assert mesh.texcoords is not None


def write_serialized(path, shapes, version=4):
    """A Mitsuba `.serialized` file of several shapes: each a 4-byte
    header (magic 0x041C, version) and a zlib stream, then the table of
    shape offsets and the shape count at the end (uint64 offsets in
    version 4, uint32 in version 3)."""
    blob, offsets = b"", []
    for k, (pos, idx, nrm, uv, double) in enumerate(shapes):
        flags = (0x1 if nrm is not None else 0) | (0x2 if uv is not None else 0)
        flags |= 0x2000 if double else 0
        dt = "<f8" if double else "<f4"
        s = struct.pack("<I", flags)
        if version == 4:
            s += f"shape{k}".encode() + b"\0"
        s += struct.pack("<QQ", len(pos), len(idx))
        s += np.asarray(pos, dt).tobytes()
        for extra in (nrm, uv):
            if extra is not None:
                s += np.asarray(extra, dt).tobytes()
        s += np.asarray(idx, "<u4").tobytes()
        offsets.append(len(blob))
        blob += struct.pack("<HH", 0x041C, version) + zlib.compress(s)
    table = np.asarray(offsets, "<u8" if version == 4 else "<u4").tobytes()
    path.write_bytes(blob + table + struct.pack("<I", len(shapes)))


@pytest.mark.parametrize("version", [3, 4])
def test_serialized_two_shapes(tmp_path, version):
    rng = np.random.default_rng(3)
    tri = rng.normal(size=(5, 3))
    tri_idx = np.array([[0, 1, 2], [2, 3, 4]])
    shapes = [(POS, IDX, NRM, None, False),
              (tri, tri_idx, None, rng.uniform(size=(5, 2)), True)]
    path = tmp_path / "two.serialized"
    write_serialized(path, shapes, version)
    first = _both(path, flip_texcoords=False, shape_index=0)
    np.testing.assert_array_equal(first.indices, IDX)
    second = _both(path, flip_texcoords=False, shape_index=1)
    assert second.positions.shape == (5, 3) and second.normals is None
    np.testing.assert_array_equal(second.positions, tri.astype(np.float32))
    for loader in (tl.load_mesh, jl.load_mesh):
        with pytest.raises(ValueError, match="out of range"):
            loader(str(path), shape_index=2)


@pytest.mark.parametrize("kind", ["gltf", "glb"])
def test_gltf(tmp_path, kind):
    if kind == "gltf":
        g, _ = _gltf_dict("data:application/octet-stream;base64,{b64}")
        path = tmp_path / "quad.gltf"
        path.write_text(json.dumps(g))
    else:
        g, blob = _gltf_dict(None)
        g["buffers"] = [{"byteLength": len(blob)}]
        js = json.dumps(g).encode()
        js += b" " * (-len(js) % 4)
        blob += b"\x00" * (-len(blob) % 4)
        path = tmp_path / "quad.glb"
        path.write_bytes(
            struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    mesh = _both(path)
    np.testing.assert_array_equal(mesh.indices, IDX)
    np.testing.assert_array_equal(mesh.texcoords, UV)


def test_unknown_extension_raises(tmp_path):
    path = tmp_path / "mesh.stl"
    path.write_bytes(b"solid")
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tl.load_mesh(str(path))
