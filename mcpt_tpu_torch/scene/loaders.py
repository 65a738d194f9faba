"""Mesh loaders: OBJ, PLY, Mitsuba `.serialized`, glTF (counterpart of
mcpt_tpu/scene/loaders.py).

The reference delegates OBJ/PLY/glTF to assimp and implements a custom
zlib reader for Mitsuba's `.serialized` (csrt
src/parser/model_loader.cpp:426-504).  No assimp exists here, so all
four are implemented directly in numpy; semantics match the reference:

  * OBJ: polygon-fan triangulation, per-corner v/vt/vn resolution,
    texcoords flipped vertically by default (flip_texcoords, Mitsuba
    convention, parser.cpp:1175-1179);
  * `.serialized`: 0x041C magic, v3/v4, per-shape zlib streams located
    via the uint32/uint64 offset table at EOF, flags bit0=normals,
    bit1=uvs, bit3=colors, bit13=double precision;
  * face_normals=True discards stored normals (flat shading).
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from mcpt_tpu_torch.scene.ir import MeshData


def load_mesh(filename: str, flip_texcoords: bool = True,
              face_normals: bool = False, shape_index: int = 0) -> MeshData:
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".obj":
        mesh = load_obj(filename, flip_texcoords)
    elif ext == ".ply":
        mesh = load_ply(filename)
    elif ext == ".serialized":
        mesh = load_serialized(filename, shape_index)
    elif ext in (".gltf", ".glb"):
        mesh = load_gltf(filename)
    else:
        raise ValueError(f"unsupported mesh format '{ext}'")
    if face_normals:
        mesh.normals = None
    return mesh


# ---------------------------------------------------------------------------
# OBJ


def load_obj(filename: str, flip_texcoords: bool = True) -> MeshData:
    positions, texcoords, normals = [], [], []
    corner_map = {}
    out_pos, out_uv, out_nrm = [], [], []
    faces = []
    has_uv = has_nrm = False

    def resolve(corner: str) -> int:
        idx = corner_map.get(corner)
        if idx is not None:
            return idx
        parts = corner.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(texcoords) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(normals) + ni
        idx = len(out_pos)
        out_pos.append(positions[vi])
        out_uv.append(texcoords[ti] if ti is not None else (0.0, 0.0))
        out_nrm.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
        corner_map[corner] = idx
        return idx

    with open(filename, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                positions.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                texcoords.append((float(p[1]), float(p[2])))
                has_uv = True
            elif line.startswith("vn "):
                p = line.split()
                normals.append((float(p[1]), float(p[2]), float(p[3])))
                has_nrm = True
            elif line.startswith("f "):
                corners = [resolve(c) for c in line.split()[1:]]
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))

    pos = np.asarray(out_pos, np.float32)
    uv = np.asarray(out_uv, np.float32) if has_uv else None
    if uv is not None and flip_texcoords:
        uv = uv.copy()
        uv[:, 1] = 1.0 - uv[:, 1]
    nrm = np.asarray(out_nrm, np.float32) if has_nrm else None
    return MeshData(
        positions=pos,
        indices=np.asarray(faces, np.int32).reshape(-1, 3),
        normals=nrm,
        texcoords=uv,
    )


# ---------------------------------------------------------------------------
# PLY

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(filename: str) -> MeshData:
    with open(filename, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"'{filename}' is not a PLY file")
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_dtype, prop_name) | ("list", ...)])
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", _PLY_DTYPES[t[2]],
                                        _PLY_DTYPES[t[3]], t[4]))
            else:
                elements[-1][2].append((_PLY_DTYPES[t[1]], t[2]))

    verts = {}
    faces = []
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split("\n")
        row = 0
        for name, count, props in elements:
            if name == "vertex":
                vals = np.array(
                    [tokens[row + i].split() for i in range(count)], np.float64
                )
                for ci, p in enumerate(props):
                    verts[p[1]] = vals[:, ci].astype(np.float32)
                row += count
            elif name == "face":
                for i in range(count):
                    t = tokens[row + i].split()
                    k = int(t[0])
                    idx = [int(x) for x in t[1 : 1 + k]]
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
                row += count
            else:
                row += count
    else:
        byteorder = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[1], byteorder + p[0]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                for p in props:
                    verts[p[1]] = arr[p[1]].astype(np.float32)
            elif name == "face":
                for _ in range(count):
                    cnt_dt = np.dtype(byteorder + props[0][1])
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx_dt = np.dtype(byteorder + props[0][2])
                    idx = np.frombuffer(body, idx_dt, k, off)
                    off += idx_dt.itemsize * k
                    for j in range(1, k - 1):
                        faces.append((int(idx[0]), int(idx[j]), int(idx[j + 1])))
            else:
                raise ValueError(f"unsupported PLY element '{name}'")

    pos = np.stack([verts["x"], verts["y"], verts["z"]], axis=-1)
    nrm = (
        np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=-1)
        if "nx" in verts
        else None
    )
    uv = (
        np.stack([verts["u"], verts["v"]], axis=-1)
        if "u" in verts
        else (
            np.stack([verts["s"], verts["t"]], axis=-1) if "s" in verts else None
        )
    )
    return MeshData(
        positions=pos,
        indices=np.asarray(faces, np.int32).reshape(-1, 3),
        normals=nrm,
        texcoords=uv,
    )


# ---------------------------------------------------------------------------
# Mitsuba .serialized


def load_serialized(filename: str, shape_index: int = 0) -> MeshData:
    with open(filename, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != 0x041C:
        raise ValueError(f"'{filename}': bad .serialized magic {magic:#x}")
    if version not in (3, 4):
        raise ValueError(f"'{filename}': unsupported version {version}")

    # locate the requested sub-shape via the EOF offset table
    # (model_loader.cpp:296-333)
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    if shape_index < 0 or shape_index >= max(count, 1):
        raise ValueError(f"shape index {shape_index} out of range ({count})")
    if shape_index == 0:
        offset = 4
    else:
        if version == 4:
            pos = len(data) - 8 * (count - shape_index) - 4
            (offset,) = struct.unpack_from("<Q", data, pos)
        else:
            pos = len(data) - 4 * (count - shape_index + 1)
            (offset,) = struct.unpack_from("<I", data, pos)
        offset += 4  # skip the per-shape format/version header

    stream = zlib.decompressobj().decompress(data[offset:])
    pos = 0

    def read(fmt):
        nonlocal pos
        vals = struct.unpack_from("<" + fmt, stream, pos)
        pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    flags = read("I")
    if version == 4:
        end = stream.index(b"\0", pos)
        pos = end + 1
    vertex_count = read("Q")
    triangle_count = read("Q")
    double_precision = bool(flags & 0x2000)
    scalar = np.float64 if double_precision else np.float32
    ssize = 8 if double_precision else 4

    def read_array(n, comps, dtype, isize):
        nonlocal pos
        out = np.frombuffer(stream, dtype, n * comps, pos).reshape(n, comps)
        pos += n * comps * isize
        return out

    positions = read_array(vertex_count, 3, scalar, ssize).astype(np.float32)
    normals = None
    if flags & 0x0001:
        normals = read_array(vertex_count, 3, scalar, ssize).astype(np.float32)
    texcoords = None
    if flags & 0x0002:
        texcoords = read_array(vertex_count, 2, scalar, ssize).astype(np.float32)
    if flags & 0x0008:
        read_array(vertex_count, 3, scalar, ssize)  # vertex colors, unused
    indices = read_array(triangle_count, 3, np.uint32, 4).astype(np.int32)

    return MeshData(
        positions=positions,
        indices=indices,
        normals=normals,
        texcoords=texcoords,
    )


# ---------------------------------------------------------------------------
# glTF (minimal: POSITION/NORMAL/TEXCOORD_0 + indices, embedded or .bin)

_GLTF_CTYPE = {5120: "i1", 5121: "u1", 5122: "i2", 5123: "u2",
               5125: "u4", 5126: "f4"}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def load_gltf(filename: str) -> MeshData:
    if filename.lower().endswith(".glb"):
        with open(filename, "rb") as f:
            data = f.read()
        magic, _version, _length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67, "bad glb magic"
        clen, ctype = struct.unpack_from("<II", data, 12)
        gltf = json.loads(data[20 : 20 + clen])
        bin_start = 20 + clen
        blen, btype = struct.unpack_from("<II", data, bin_start)
        buffers = [data[bin_start + 8 : bin_start + 8 + blen]]
    else:
        with open(filename) as f:
            gltf = json.load(f)
        buffers = []
        base = os.path.dirname(filename)
        for buf in gltf.get("buffers", []):
            uri = buf["uri"]
            if uri.startswith("data:"):
                import base64

                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base, uri), "rb") as f:
                    buffers.append(f.read())

    def accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[view.get("buffer", 0)]
        off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        n = acc["count"]
        comps = _GLTF_NCOMP[acc["type"]]
        dt = np.dtype("<" + _GLTF_CTYPE[acc["componentType"]])
        stride = view.get("byteStride") or dt.itemsize * comps
        if stride == dt.itemsize * comps:
            arr = np.frombuffer(buf, dt, n * comps, off).reshape(n, comps)
        else:
            rows = [
                np.frombuffer(buf, dt, comps, off + i * stride)
                for i in range(n)
            ]
            arr = np.stack(rows)
        return arr

    all_pos, all_nrm, all_uv, all_idx = [], [], [], []
    cursor = 0
    has_nrm = has_uv = True
    for mesh in gltf.get("meshes", []):
        for prim in mesh["primitives"]:
            attrs = prim["attributes"]
            p = accessor(attrs["POSITION"]).astype(np.float32)
            all_pos.append(p)
            if "NORMAL" in attrs:
                all_nrm.append(accessor(attrs["NORMAL"]).astype(np.float32))
            else:
                has_nrm = False
            if "TEXCOORD_0" in attrs:
                all_uv.append(accessor(attrs["TEXCOORD_0"]).astype(np.float32))
            else:
                has_uv = False
            idx = accessor(prim["indices"]).astype(np.int32).reshape(-1, 3)
            all_idx.append(idx + cursor)
            cursor += len(p)

    return MeshData(
        positions=np.concatenate(all_pos),
        indices=np.concatenate(all_idx),
        normals=np.concatenate(all_nrm) if has_nrm and all_nrm else None,
        texcoords=np.concatenate(all_uv) if has_uv and all_uv else None,
    )
